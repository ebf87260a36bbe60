"""Block model — declarative, functional ops compiled into one XLA graph.

Compiled inversion of the reference runtime (SURVEY.md §7): in GNU Radio a
block is an *object with a work() method* driven by a per-block OS thread
(gnuradio-runtime/lib/block_executor.cc:234-575, tpb_thread_body.cc:83-164).
Here a block is a *declarative spec* — static rate algebra + a pure
`apply(state, inputs, n_in) -> (state, outputs)` function — and the whole
flowgraph is traced into ONE jitted step function. The scheduler's dynamic
machinery maps onto static compile-time concepts:

  reference mechanism                      -> compiled concept
  ---------------------------------------------------------------------------
  forecast()/noutput_items negotiation        rational rate algebra, solved
   (block_executor.cc:423-449)                once at graph-compile time
  history() re-presented overlap              per-block carried tail state
   (block.h:82-91)                            (zeros-initialized, == GR's
                                              zero-filled buffer start)
  relative_rate (double + mpq, block.h:276)   exact `fractions.Fraction`
  set_output_multiple (block.h:206)           output_multiple constraint fed
                                              to the chunk-size solver
  consume/produce (block.h:244-265)           static shapes; nothing to count
  WORK_DONE / done propagation                source exhaustion handled by the
   (block.cc:595-638)                         host runner loop
  per-block thread + ring buffer              XLA values between fused ops

State (filter tails, PLL phase, AGC gain, NCO phase accumulators) is an
explicit JAX pytree carried through the step function — the analog of the
mutable `d_*` members of the reference's block impl classes.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Any, Sequence

import jax.numpy as jnp

from .stream import PortSpec

ONE = Fraction(1)


class Block:
    """Base class for all stream blocks.

    Subclasses define:
      in_ports / out_ports : tuple[PortSpec]
      in_rates / out_rates : tuple[Fraction] — items consumed/produced per
          abstract block "tick". A 1:1 sync block is in=(1,), out=(1,); a
          decimator in=(D,), out=(1,); interleave(2) in=(1,1), out=(2,).
          This generalizes gr's relative_rate to multi-port exactness.
      output_multiple : int — minimum granularity of produced items per step
          (analog of gr::block::set_output_multiple, block.h:206).
      init_state() -> pytree (None if stateless)
      apply(state, inputs, n_in) -> (state, outputs)
          inputs/outputs are tuples of arrays with static shapes; n_in is the
          per-port item count tuple (static Python ints at trace time).
    """

    # --- static interface (overridable as class attrs or properties) ---
    in_ports: tuple = ()
    out_ports: tuple = ()
    output_multiple: int = 1
    # tag propagation (host-side sideband): 'all_to_all' | 'one_to_one' | 'none'
    tag_policy: str = "all_to_all"

    _name_counter = {}

    def __init__(self, name: str | None = None):
        cls = type(self).__name__
        if name is None:
            n = Block._name_counter.get(cls, 0)
            Block._name_counter[cls] = n + 1
            name = f"{cls}{n}"
        self.name = name
        # message-passing plane (basic_block.h:179-182, 377) — host-side
        self._msg_in: dict = {}      # port name -> handler or None
        self._msg_out: set = set()
        self._msg_outbox: list = []  # [(port, msg)] pending publication

    # ---- message ports (async host-side control plane) ----
    def message_port_register_in(self, name: str, handler=None):
        self._msg_in[name] = handler

    def message_port_register_out(self, name: str):
        self._msg_out.add(name)

    def set_msg_handler(self, port: str, handler):
        if port not in self._msg_in:
            raise ValueError(f"{self}: no input message port {port!r}")
        self._msg_in[port] = handler

    def post(self, port: str, msg):
        """message_port_pub analog: queue msg for delivery after this step."""
        if port not in self._msg_out:
            raise ValueError(f"{self}: no output message port {port!r}")
        self._msg_outbox.append((port, msg))

    def deliver(self, port: str, msg):
        h = self._msg_in.get(port)
        if h is not None:
            h(msg)

    def drain_outbox(self):
        out, self._msg_outbox = self._msg_outbox, []
        return out

    def msg_work(self, step_index: int):
        """Per-step host hook for message-only blocks (strobe-style)."""

    # ---- stream tag hooks (see core.tags) ----
    # Blocks creating/consuming tags data-dependently override one of these;
    # pure DSP blocks inherit policy-based propagation (tag_policy class attr).
    # transform_tags(tags_in, in_win, out_win) — single-in/single-out hook.
    # transform_tags_multi(tags_by_port, in_wins, out_wins) -> [tags per out
    # port] — multi-port hook with per-port windows (block_executor.cc
    # per-port semantics).
    transform_tags = None
    transform_tags_multi = None

    def reset_host_state(self):
        """Reset host-plane counters keyed to absolute stream offsets.
        Called by the runtime when a new tag engine is constructed (offsets
        restart at 0 each TopBlock.run), so offset-synchronized host state
        (tag windows, param-chunk cursors) cannot desync across runs.
        Device state (self.state pytree) is NOT touched."""

    # Default rates: sync across all ports.
    @property
    def in_rates(self) -> tuple:
        return tuple(ONE for _ in self.in_ports)

    @property
    def out_rates(self) -> tuple:
        return tuple(ONE for _ in self.out_ports)

    def init_state(self) -> Any:
        return None

    def apply(self, state, inputs: tuple, n_in: tuple):
        raise NotImplementedError

    # --- convenience ---
    @property
    def nin(self) -> int:
        return len(self.in_ports)

    @property
    def nout(self) -> int:
        return len(self.out_ports)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"


class SyncBlock(Block):
    """1:1 block over a single in/out port pair (gr::sync_block analog,
    gnuradio-runtime/include/gnuradio/sync_block.h:40). Subclasses implement
    `work(state, x) -> (state, y)` with len(y) == len(x)."""

    def __init__(self, in_port: PortSpec, out_port: PortSpec, name=None):
        super().__init__(name)
        self.in_ports = (in_port,)
        self.out_ports = (out_port,)

    def work(self, state, x):
        raise NotImplementedError

    def apply(self, state, inputs, n_in):
        state, y = self.work(state, inputs[0])
        return state, (y,)


class DecimBlock(Block):
    """N:1 block (gr::sync_decimator analog, lib/sync_decimator.cc)."""

    def __init__(self, decim: int, in_port: PortSpec, out_port: PortSpec, name=None):
        super().__init__(name)
        if decim < 1:
            raise ValueError(f"decim must be >= 1, got {decim}")
        self.decim = int(decim)
        self.in_ports = (in_port,)
        self.out_ports = (out_port,)

    @property
    def in_rates(self):
        return (Fraction(self.decim),)

    @property
    def out_rates(self):
        return (ONE,)

    def work(self, state, x):
        raise NotImplementedError

    def apply(self, state, inputs, n_in):
        state, y = self.work(state, inputs[0])
        return state, (y,)


class InterpBlock(Block):
    """1:N block (gr::sync_interpolator analog, lib/sync_interpolator.cc)."""

    def __init__(self, interp: int, in_port: PortSpec, out_port: PortSpec, name=None):
        super().__init__(name)
        if interp < 1:
            raise ValueError(f"interp must be >= 1, got {interp}")
        self.interp = int(interp)
        self.in_ports = (in_port,)
        self.out_ports = (out_port,)

    @property
    def in_rates(self):
        return (ONE,)

    @property
    def out_rates(self):
        return (Fraction(self.interp),)

    def work(self, state, x):
        raise NotImplementedError

    def apply(self, state, inputs, n_in):
        state, y = self.work(state, inputs[0])
        return state, (y,)


class RationalBlock(Block):
    """General L/M rate block over one in/out port pair."""

    def __init__(self, interp: int, decim: int, in_port: PortSpec,
                 out_port: PortSpec, name=None):
        super().__init__(name)
        self.interp = int(interp)
        self.decim = int(decim)
        self.in_ports = (in_port,)
        self.out_ports = (out_port,)

    @property
    def in_rates(self):
        return (Fraction(self.decim),)

    @property
    def out_rates(self):
        return (Fraction(self.interp),)

    def work(self, state, x):
        raise NotImplementedError

    def apply(self, state, inputs, n_in):
        state, y = self.work(state, inputs[0])
        return state, (y,)


class SourceBlock(Block):
    """Block with no stream inputs: signal generators and host-fed sources.

    Two flavors:
      * generated sources (sig_source, noise_source): `generate(state, n)`
        runs on device inside the jitted step.
      * fed sources (stream_input / file_source): the host runner supplies a
        chunk per step; `apply` passes it through (and may transform).
    """

    is_fed = False  # True if the host supplies data each step

    def __init__(self, out_port: PortSpec, name=None):
        super().__init__(name)
        self.in_ports = ()
        self.out_ports = (out_port,)

    def generate(self, state, n: int):
        raise NotImplementedError

    def apply(self, state, inputs, n_in):
        # non-fed sources ignore inputs
        state, y = self.generate(state, self._n_out)
        return state, (y,)


class SinkBlock(Block):
    """Block with no stream outputs. Inside the jitted step a sink is pure:
    it reduces/forwards its input to a 'tap' value returned to the host; the
    host runner accumulates (vector_sink) or writes (file_sink) it."""

    def __init__(self, in_port: PortSpec, name=None):
        super().__init__(name)
        self.in_ports = (in_port,)
        self.out_ports = ()

    # Port spec describing the tap value sent to the host (defaults to the
    # input port; sinks whose tap is a reduction of a different dtype
    # override this).
    @property
    def tap_port(self):
        return self.in_ports[0]

    def tap(self, state, x):
        """Return (state, host_value). Default: forward the chunk."""
        return state, x

    def apply(self, state, inputs, n_in):
        state, v = self.tap(state, inputs[0])
        return state, (v,)  # compiler routes this to host, not to an edge

    # Host-side accumulation hook; runner calls once per step with the
    # materialized tap value.
    def collect(self, value):
        pass

    # Tag sideband: runner delivers input-window tags each step.
    def collect_tags(self, tags):
        pass

    # Runner calls with the exact expected item count (head semantics);
    # sinks that buffer items override this.
    def trim(self, n_items: int):
        pass


class CarryTail:
    """Mixin helper managing a carried input tail of `hist` items — the
    Compiled replacement for gr history() (block.h:82-91). The carry starts
    as zeros, matching the reference's zero-initialized buffers, so outputs
    align one-to-one with the reference from the very first sample.
    """

    def _tail_init(self, port: PortSpec, hist: int):
        self._hist = int(hist)
        self._tail_port = port

    def tail_state(self):
        if self._hist == 0:
            return None
        return self._tail_port.zeros(self._hist)

    def with_tail(self, tail, x):
        """Prepend carry, return (padded_x, new_tail)."""
        if self._hist == 0:
            return x, None
        xp = jnp.concatenate([tail, x], axis=0)
        return xp, xp[xp.shape[0] - self._hist:]
