"""Graph compiler: flowgraph -> ONE jitted step function.

This is the compiled replacement for the reference's flat_flowgraph +
scheduler_tpb + block_executor stack (gnuradio-runtime/lib/flat_flowgraph.cc:44,
scheduler_tpb.cc:56-90, block_executor.cc:234-575). Instead of allocating ring
buffers and spawning one thread per block, we:

  1. solve the graph's rational rates once (graph.solve_rates — the static
     forecast()),
  2. fix per-block item counts for a chosen step size,
  3. trace every block's pure `apply` in topological order into a single
     `step(state, fed) -> (state, taps)` function, and
  4. hand that to jax.jit — XLA fuses the whole chain, so "buffers" between
     blocks become register/on-chip values and pipelining happens inside the
     compiled program instead of across OS threads.

State is a dict {block_name: pytree}; donated on each call so device memory
is reused across steps (the moral equivalent of the reference's recycled
ring buffers).
"""
from __future__ import annotations

from fractions import Fraction

import jax

from .block import Block, SinkBlock, SourceBlock
from .graph import Flowgraph
from .stream import dev_decode, dev_encode


class CompiledGraph:
    def __init__(self, fg: Flowgraph, chunk_mult: int | None = None,
                 jit: bool = True, donate_state: bool = True,
                 target_items: int = 16384):
        fg = fg.flatten()  # expand hier blocks before tracing (zero-cost)
        fg.validate()
        self.fg = fg
        full_order = fg.topological_sort()
        # message-only blocks live on the host plane, outside the jitted step
        self.msg_only = [b for b in full_order if not (b.nin or b.nout)]
        self.order = [b for b in full_order if b.nin or b.nout]
        self.rates = fg.solve_rates()
        base = fg.natural_step()
        if chunk_mult is None:
            # auto-size: scale the natural step so the busiest port moves
            # ~target_items items per step (the analog of the reference's
            # 32 KiB x 2 buffer sizing, flat_flowgraph.cc:115-121, but chosen
            # to amortize per-step dispatch instead of thread decoupling)
            max_items = 1
            for b in self.order:
                tb = self.rates[b] * base
                for r in tuple(b.in_rates) + tuple(b.out_rates):
                    max_items = max(max_items, int(tb * r) or 1)
            chunk_mult = max(1, -(-int(target_items) // max_items))
        self.step_ticks = base * int(chunk_mult)

        # Per-block static item counts for this step size.
        self.n_in: dict[Block, tuple] = {}
        self.n_out: dict[Block, tuple] = {}
        for b in self.order:
            tb = self.rates[b] * self.step_ticks
            nin = tuple(int(tb * r) for r in b.in_rates)
            nout = tuple(int(tb * r) for r in b.out_rates)
            for r, n in zip(b.in_rates, nin):
                assert Fraction(n) == tb * r, f"non-integer item count at {b}"
            self.n_in[b] = nin
            self.n_out[b] = nout
            b._n_out = nout[0] if nout else 0  # used by SourceBlock.generate

        self.fed_sources = [b for b in self.order
                            if isinstance(b, SourceBlock) and b.is_fed]
        # param-fed blocks: mid-graph blocks receiving a host-computed array
        # each step (e.g. tag-driven gains — multiply_by_tag_value_cc). The
        # host derives the param from the tag sideband BEFORE the device
        # step, keeping tag-at-offset semantics exact within a chunk.
        self.param_fed = [b for b in self.order
                          if getattr(b, "param_fed", False)]
        self.sinks = [b for b in self.order if isinstance(b, SinkBlock)]

        def step(state: dict, fed: dict):
            # Host boundary convention: `fed` and `taps` cross host<->device
            # as real float planes (complex as trailing (...,2) re/im —
            # stream.host_encode/dev_decode); complex exists only on device.
            values = {}  # (block, out_port) -> array
            taps = {}
            new_state = {}
            for b in self.order:
                ins = tuple(values[(e.src.block, e.src.port)]
                            for e in self.fg.in_edges(b))
                st = state.get(b.name)
                if isinstance(b, SourceBlock) and b.is_fed:
                    x = dev_decode(fed[b.name], b.out_ports[0])
                    st2, outs = b.apply(st, (x,), self.n_in[b])
                elif getattr(b, "param_fed", False):
                    p = dev_decode(fed[b.name], b.param_port)
                    st2, outs = b.apply(st, ins + (p,), self.n_in[b])
                else:
                    st2, outs = b.apply(st, ins, self.n_in[b])
                if isinstance(b, SinkBlock):
                    v = outs[0]
                    # promote 0-d taps to (1,) so every tap crosses to the
                    # host as an array — runtime strips it back
                    if getattr(v, "ndim", 1) == 0:
                        v = v[None]
                        b._tap_scalar = True
                    taps[b.name] = dev_encode(v)
                else:
                    for p, y in enumerate(outs):
                        values[(b, p)] = y
                new_state[b.name] = st2
            return new_state, taps

        self._raw_step = step
        self.step = (jax.jit(step, donate_argnums=(0,) if donate_state else ())
                     if jit else step)

    def init_state(self) -> dict:
        # one jitted init program instead of per-block eager dispatches
        def make():
            return {b.name: b.init_state() for b in self.order}
        return jax.jit(make)()

    def all_blocks(self):
        return self.order + self.msg_only

    def fed_chunk_sizes(self) -> dict:
        """Items per step each host-fed source must supply."""
        return {b.name: self.n_out[b][0] for b in self.fed_sources}

    def items_per_step(self, b: Block, port: int = 0, output: bool = True) -> int:
        return (self.n_out if output else self.n_in)[b][port]
