"""gnuradio_tpu — an accelerator-native software-radio framework.

A from-scratch re-design of GNU Radio's capabilities (reference: GNU Radio
3.9 snapshot) for accelerators through JAX/XLA: flowgraphs are compiler inputs traced into
single jitted XLA programs, DSP blocks are matmul and elementwise kernels, streams shard
across device meshes with halo exchange replacing scheduler history buffers.

    from gnuradio_tpu import gr, blocks, filter, analog, fft
    tb = gr.TopBlock()
    tb.connect(src, flt, demod, sink)
    tb.run()
"""
from . import core
from .core.block import (Block, SyncBlock, DecimBlock, InterpBlock,
                         SourceBlock, SinkBlock)
from .core.graph import Flowgraph
from .core.hier import HierBlock
from .core.runtime import TopBlock
from .core.stream import PortSpec, port

__version__ = "0.1.0"
