"""gateway — author blocks in plain Python/NumPy (gr gateway analog).

Reference parity: gnuradio-runtime/python/gnuradio/gr/gateway.py:132-347 —
`gr.sync_block` / `gr.decim_block` / `gr.interp_block` / `gr.basic_block`
let users implement work() in Python while the C++ runtime drives it
through the block_gateway trampoline
(gnuradio-runtime/include/gnuradio/block_gateway.h:47-68).

Design: the trampoline here is `jax.pure_callback` — the user's NumPy
work() executes on the HOST inside the traced step function, with static
shapes supplied by the graph compiler (so the rest of the chain stays one
fused XLA program around the callback). Like the reference's Python blocks,
gateway blocks trade throughput for convenience: the callback serializes
host<->device transfers at each step. Blocks keep Python-side attributes as
mutable state (the callbacks run once per step in stream order on the
driving host loop).

API (GR work signature):

    class my_block(gateway.sync_block):
        def __init__(self):
            super().__init__(name="my_block",
                             in_sig=[np.complex64], out_sig=[np.complex64])
        def work(self, input_items, output_items):
            output_items[0][:] = input_items[0] * 2
            return len(output_items[0])
"""
from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from .core.block import Block
from .core.stream import PortSpec, C, F, I as I32, B, S


_DTYPE_MAP = {
    np.dtype(np.complex64): C,
    np.dtype(np.float32): F,
    np.dtype(np.int32): I32,
    np.dtype(np.int16): S,
    np.dtype(np.int8): B,
    np.dtype(np.uint8): B,
}


def _port(sig) -> PortSpec:
    if isinstance(sig, tuple):          # (dtype, vlen)
        dt, vlen = sig
        return PortSpec(_DTYPE_MAP[np.dtype(dt)], int(vlen))
    return PortSpec(_DTYPE_MAP[np.dtype(sig)])


class _GatewayBlock(Block):
    """Shared trampoline: apply() routes through jax.pure_callback to the
    user's work()."""

    def __init__(self, name=None, in_sig=(), out_sig=(),
                 decim: int = 1, interp: int = 1):
        super().__init__(name)
        self.in_ports = tuple(_port(s) for s in (in_sig or ()))
        self.out_ports = tuple(_port(s) for s in (out_sig or ()))
        self._decim = int(decim)
        self._interp = int(interp)

    @property
    def in_rates(self):
        return tuple(Fraction(self._decim) for _ in self.in_ports)

    @property
    def out_rates(self):
        return tuple(Fraction(self._interp) for _ in self.out_ports)

    def work(self, input_items, output_items):
        raise NotImplementedError

    def _host_work(self, *arrays):
        n_out = self._n_out_items
        outs = [np.zeros((n_out * p.vlen,) if p.vlen > 1 else (n_out,),
                         np.dtype(p.dtype)) for p in self.out_ports]
        outs_shaped = [o.reshape(n_out, p.vlen) if p.vlen > 1 else o
                       for o, p in zip(outs, self.out_ports)]
        ins = [np.asarray(a) for a in arrays]
        produced = self.work(ins, outs_shaped)
        if produced not in (None, n_out):
            raise RuntimeError(
                f"{self}: gateway work() must produce exactly {n_out} "
                f"items per step (static rates), returned {produced}")
        return tuple(np.ascontiguousarray(o) for o in outs_shaped)

    def apply(self, state, inputs, n_in):
        n_out = (n_in[0] // self._decim) * self._interp if self.nin \
            else self._n_out
        self._n_out_items = int(n_out)
        result_shapes = tuple(
            jax.ShapeDtypeStruct(
                (n_out, p.vlen) if p.vlen > 1 else (n_out,),
                np.dtype(p.dtype))
            for p in self.out_ports)
        outs = jax.pure_callback(self._host_work, result_shapes, *inputs)
        return state, tuple(outs)


class sync_block(_GatewayBlock):
    """1:1 Python block (gateway.py:272)."""

    def __init__(self, name=None, in_sig=(), out_sig=()):
        super().__init__(name, in_sig, out_sig)


class decim_block(_GatewayBlock):
    """N:1 Python block (gateway.py:300)."""

    def __init__(self, name=None, in_sig=(), out_sig=(), decim: int = 1):
        super().__init__(name, in_sig, out_sig, decim=decim)


class interp_block(_GatewayBlock):
    """1:N Python block (gateway.py:318)."""

    def __init__(self, name=None, in_sig=(), out_sig=(), interp: int = 1):
        super().__init__(name, in_sig, out_sig, interp=interp)


class basic_block(_GatewayBlock):
    """General Python block with an explicit static relative rate
    (the reference's general_work supports dynamic rates; under static
    shapes declare interp/decim up front)."""

    def __init__(self, name=None, in_sig=(), out_sig=(), decim: int = 1,
                 interp: int = 1):
        super().__init__(name, in_sig, out_sig, decim=decim, interp=interp)
