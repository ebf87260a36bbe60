"""gr-blocks analog: sources, sinks, arithmetic, type converts, stream shape.

Reference parity: gr-blocks/include/gnuradio/blocks/*.h (SURVEY.md §2.2,
App. B catalog). Elementwise math that the reference dispatches to VOLK
kernels per block-thread becomes plain jnp ops that XLA fuses into
neighboring kernels — an add_const between two FIRs costs zero extra memory
round trips after fusion.

Naming follows the GR type-suffix convention (add_ff, multiply_const_cc, ...)
via thin factory functions over generic classes.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.block import Block, SinkBlock, SourceBlock, SyncBlock, DecimBlock, InterpBlock
from ..core.stream import PortSpec, port, B, S, I, F, C, host_encode
from fractions import Fraction


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------
class StreamSource(SourceBlock):
    """Host-fed source base: slices a host array (or iterator) into
    device-sized chunks; final partial chunk is zero-padded and the true item
    count recorded for sink trimming (file_source/vector_source analog,
    gr-blocks/lib/file_source_impl.cc, vector_source)."""

    is_fed = True

    def __init__(self, data, out_port: PortSpec, repeat: bool = False,
                 name=None, tags=None):
        super().__init__(out_port, name)
        self.data = np.asarray(data, dtype=np.dtype(out_port.dtype))
        if out_port.vlen > 1 and self.data.ndim == 1:
            self.data = self.data.reshape(-1, out_port.vlen)
        self.repeat = repeat
        self.items_supplied = 0
        self.stream_tags = list(tags or [])  # [core.tags.Tag] at abs offsets

    def chunks(self, n: int):
        pos = 0
        total = len(self.data)
        self.items_supplied = 0
        while True:
            if pos >= total:
                if not self.repeat:
                    return
                pos = 0
            end = pos + n
            if end <= total:
                chunk = self.data[pos:end]
                self.items_supplied += n
            elif self.repeat:
                reps = [self.data[pos:]]
                need = n - (total - pos)
                while need >= total:
                    reps.append(self.data)
                    need -= total
                if need:
                    reps.append(self.data[:need])
                chunk = np.concatenate(reps, axis=0)
                self.items_supplied += n
                pos = (pos + n) % total
                yield host_encode(chunk)
                continue
            else:
                pad = self.out_ports[0].np_zeros(n)
                pad[: total - pos] = self.data[pos:]
                chunk = pad
                self.items_supplied += total - pos
            pos = end
            yield host_encode(chunk)

    def apply(self, state, inputs, n_in):
        return state, (inputs[0],)


class DeviceCycleSource(SourceBlock):
    """Device-resident repeating source: the buffer is uploaded ONCE (into
    the carried state) and cycled on device each step — no per-step
    host->device traffic, unlike vector_source(repeat=True) whose chunks
    are copied to the device every step.

    This is the device-resident analog of the reference's null/synthetic bench
    sources (gnuradio-runtime/examples/mp-sched/run_synthetic.py feeds
    null_source): the source costs ~one memory write, the chain does all the
    work, and nothing constant-folds because the buffer is a runtime state
    input. Used by benchmarks/bench_topblock.py for the composed-path
    number.

    If len(data) < items-per-step n, requires n % len(data) == 0 and emits
    jnp.tile(roll(buf, -pos)); if len(data) >= n, slices a doubled buffer
    at the carried offset.
    """

    is_fed = False

    def __init__(self, data, out_port: PortSpec | None = None, name=None):
        data = np.asarray(data)
        if out_port is None:
            kind = data.dtype.kind
            out_port = PortSpec(C if kind == "c" else F if kind == "f" else I)
        super().__init__(out_port, name)
        self.data = np.asarray(data, dtype=np.dtype(out_port.dtype))

    def init_state(self):
        return {"buf": jnp.asarray(self.data),
                "pos": jnp.zeros((), jnp.int32)}

    def generate(self, state, n):
        import jax
        from jax import lax
        buf, pos = state["buf"], state["pos"]
        L = buf.shape[0]
        if L == n:
            return state, buf                  # pos stays 0: n % L == 0
        if L < n and n % L == 0:
            y = jnp.tile(buf, n // L)          # pos stays 0: n % L == 0
            return state, y
        # general case: tile to >= n+L, dynamic-slice at the carried offset
        reps = -(-(n + L) // L)
        y = lax.dynamic_slice_in_dim(jnp.tile(buf, reps), pos, n)
        new_pos = (pos + n) % L
        return {"buf": buf, "pos": new_pos}, y


def device_cycle_source(data, vlen=1, dtype=None, name=None):
    data = np.asarray(data)
    if dtype is None:
        kind = data.dtype.kind
        dtype = C if kind == "c" else (F if kind == "f" else I)
    return DeviceCycleSource(data, PortSpec(dtype, vlen), name)


def vector_source(data, repeat=False, vlen=1, dtype=None, name=None,
                  tags=None):
    data = np.asarray(data)
    if dtype is None:
        kind = data.dtype.kind
        dtype = C if kind == "c" else (F if kind == "f" else I)
    return StreamSource(data, PortSpec(dtype, vlen), repeat, name, tags)


def vector_source_c(data, repeat=False, vlen=1):
    return StreamSource(np.asarray(data, np.complex64), PortSpec(C, vlen), repeat)


def vector_source_f(data, repeat=False, vlen=1):
    return StreamSource(np.asarray(data, np.float32), PortSpec(F, vlen), repeat)


def vector_source_i(data, repeat=False, vlen=1):
    return StreamSource(np.asarray(data, np.int32), PortSpec(I, vlen), repeat)


def vector_source_b(data, repeat=False, vlen=1):
    return StreamSource(np.asarray(data, np.int8), PortSpec(B, vlen), repeat)


def vector_source_s(data, repeat=False, vlen=1):
    return StreamSource(np.asarray(data, np.int16), PortSpec(S, vlen), repeat)


def random_source(minimum, maximum, num_samps, repeat=False, dtype=I,
                  seed=0):
    """analog_random_source_x (gr-blocks/lib random sources): num_samps
    uniform ints in [minimum, maximum), emitted once (or repeated) —
    behaviorally a vector_source over a precomputed random buffer, which
    is exactly the reference implementation's strategy."""
    rng = np.random.default_rng(seed)
    data = rng.integers(int(minimum), int(maximum),
                        int(num_samps)).astype(np.dtype(dtype))
    return StreamSource(data, PortSpec(dtype), repeat)


def random_source_b(minimum=0, maximum=2, num_samps=1024, repeat=False):
    return random_source(minimum, maximum, num_samps, repeat, B)


def random_source_s(minimum=0, maximum=2, num_samps=1024, repeat=False):
    return random_source(minimum, maximum, num_samps, repeat, S)


def random_source_i(minimum=0, maximum=2, num_samps=1024, repeat=False):
    return random_source(minimum, maximum, num_samps, repeat, I)


class NullSource(SourceBlock):
    """Zeros generator (gr::blocks::null_source)."""

    def __init__(self, out_port: PortSpec = PortSpec(C), name=None):
        super().__init__(out_port, name)

    def generate(self, state, n):
        return state, self.out_ports[0].zeros(n)


def null_source(dtype=C, vlen=1):
    return NullSource(PortSpec(dtype, vlen))


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------
class VectorSink(SinkBlock):
    """Accumulates all items on host (gr::blocks::vector_sink)."""

    def __init__(self, in_port: PortSpec = PortSpec(C), name=None):
        super().__init__(in_port, name)
        self._chunks: list[np.ndarray] = []
        self._tags: list = []
        self._trim = None

    def collect(self, value):
        self._chunks.append(np.asarray(value))

    def collect_tags(self, tags):
        self._tags.extend(tags)

    def tags(self):
        ts = sorted(self._tags)
        if self._trim is not None:
            ts = [t for t in ts if t.offset < self._trim]
        return ts

    def trim(self, n_items: int):
        self._trim = n_items

    def data(self) -> np.ndarray:
        if not self._chunks:
            return self.in_ports[0].np_zeros(0)
        out = np.concatenate(self._chunks, axis=0)
        if self._trim is not None:
            out = out[: self._trim]
        return out

    def reset(self):
        self._chunks = []
        self._tags = []
        self._trim = None


def vector_sink(dtype=C, vlen=1):
    return VectorSink(PortSpec(dtype, vlen))


def vector_sink_c(vlen=1):
    return VectorSink(PortSpec(C, vlen))


def vector_sink_f(vlen=1):
    return VectorSink(PortSpec(F, vlen))


def vector_sink_i(vlen=1):
    return VectorSink(PortSpec(I, vlen))


def vector_sink_b(vlen=1):
    return VectorSink(PortSpec(B, vlen))


def vector_sink_s(vlen=1):
    return VectorSink(PortSpec(S, vlen))


class NullSink(SinkBlock):
    accept_any_msg = True       # headless GUI stand-in: absorb control msgs
    accept_any_stream = True    # ...and adopt whatever dtype feeds it

    def __init__(self, in_port: PortSpec = PortSpec(C), name=None):
        super().__init__(in_port, name)

    def tap(self, state, x):
        # reduce to a tiny 1-D value: almost nothing crosses back to host,
        # and the compiled step keeps the data dependence on x
        return state, jnp.zeros((1,), jnp.float32) * jnp.sum(jnp.abs(x))

    @property
    def tap_port(self):
        return PortSpec(F)  # the tap is a tiny real vector

    def collect(self, value):
        pass

    def trim(self, n):
        pass


def null_sink(dtype=C, vlen=1):
    return NullSink(PortSpec(dtype, vlen))


class ProbeSignal(SinkBlock):
    """Keeps the last item (gr::blocks::probe_signal)."""

    def __init__(self, in_port: PortSpec = PortSpec(F), name=None):
        super().__init__(in_port, name)
        self.level = None

    def tap(self, state, x):
        return state, x[-1]

    def collect(self, value):
        self.level = np.asarray(value)

    def trim(self, n):
        pass


# ---------------------------------------------------------------------------
# Flow control
# ---------------------------------------------------------------------------
class Head(SyncBlock):
    """Pass-through that bounds total stream items (gr::blocks::head,
    gr-blocks/lib/head_impl.cc). The host runner reads `limit` to decide how
    many steps to run and sinks are trimmed with exact rational rate math."""

    def __init__(self, n: int, in_port: PortSpec = PortSpec(C), name=None):
        super().__init__(in_port, in_port, name)
        self.limit = int(n)

    def work(self, state, x):
        return state, x


def head(n, dtype=C, vlen=1):
    return Head(n, PortSpec(dtype, vlen))


class SkipHead(SyncBlock):
    """Drop the first n items. Static-shape version: passes items through but
    the runner shifts sink trim; implemented by delaying with a carried buffer
    of n items (exact gr semantics for n < one chunk; general n handled by
    carrying n items of state)."""

    def __init__(self, n: int, in_port: PortSpec = PortSpec(C), name=None):
        super().__init__(in_port, in_port, name)
        self.skip = int(n)

    def init_state(self):
        # carry: (buffer of `skip` items, items_seen counter not needed —
        # steady state after first chunk)
        return self.in_ports[0].zeros(self.skip) if self.skip else None

    def work(self, state, x):
        if self.skip == 0:
            return state, x
        xp = jnp.concatenate([state, x], axis=0)
        # output lags input by `skip`: acts as a delay; combined with trim
        # this realizes skiphead for finite streams
        return xp[xp.shape[0] - self.skip:], xp[: x.shape[0]]


class Copy(SyncBlock):
    def __init__(self, in_port: PortSpec = PortSpec(C), name=None):
        super().__init__(in_port, in_port, name)

    def work(self, state, x):
        return state, x


def copy(dtype=C, vlen=1):
    return Copy(PortSpec(dtype, vlen))


class Throttle(SyncBlock):
    """No-op on device: the reference throttles to wall-clock sample rate for
    CPU-bound GUI graphs (gr-blocks/lib/throttle_impl.cc:62-96); a compiled
    device pipeline is paced by the host feed loop instead."""

    def __init__(self, in_port: PortSpec = PortSpec(C), rate: float = 0.0, name=None):
        super().__init__(in_port, in_port, name)
        self.rate = rate

    def work(self, state, x):
        return state, x


def throttle(dtype=C, rate=0.0, vlen=1):
    return Throttle(PortSpec(dtype, vlen), rate)


class Delay(SyncBlock):
    """Delay stream by d items, zero-filled start (gr::blocks::delay)."""

    def __init__(self, d: int, in_port: PortSpec = PortSpec(C), name=None):
        super().__init__(in_port, in_port, name)
        self.d = int(d)

    def init_state(self):
        return self.in_ports[0].zeros(self.d) if self.d else None

    def work(self, state, x):
        if self.d == 0:
            return state, x
        xp = jnp.concatenate([state, x], axis=0)
        return xp[xp.shape[0] - self.d:], xp[: x.shape[0]]


def delay(d, dtype=C, vlen=1):
    return Delay(d, PortSpec(dtype, vlen))


# ---------------------------------------------------------------------------
# Elementwise math (VOLK-kernel analogs; XLA fuses these away)
# ---------------------------------------------------------------------------
class Elementwise(SyncBlock):
    """N-ary elementwise op, same dtype in/out unless out_port given."""

    def __init__(self, fn, nin: int, in_port: PortSpec, out_port=None, name=None):
        Block.__init__(self, name)
        self.fn = fn
        self.in_ports = tuple(in_port for _ in range(nin))
        self.out_ports = (out_port or in_port,)

    def apply(self, state, inputs, n_in):
        return state, (self.fn(*inputs).astype(self.out_ports[0].dtype),)


def _ew(fn, nin, dtype, vlen=1, out_dtype=None, out_vlen=None):
    return Elementwise(fn, nin, PortSpec(dtype, vlen),
                       PortSpec(out_dtype or dtype, out_vlen or vlen))


def add(dtype=C, nin=2, vlen=1):
    return _ew(lambda *xs: sum(xs), nin, dtype, vlen)


def sub(dtype=C, nin=2, vlen=1):
    def f(*xs):
        r = xs[0]
        for x in xs[1:]:
            r = r - x
        return r
    return _ew(f, nin, dtype, vlen)


def multiply(dtype=C, nin=2, vlen=1):
    def f(*xs):
        r = xs[0]
        for x in xs[1:]:
            r = r * x
        return r
    return _ew(f, nin, dtype, vlen)


def divide(dtype=C, nin=2, vlen=1):
    def f(*xs):
        r = xs[0]
        for x in xs[1:]:
            r = r / x
        return r
    return _ew(f, nin, dtype, vlen)


def add_const(k, dtype=C, vlen=1):
    return _ew(lambda x: x + jnp.asarray(k, dtype), 1, dtype, vlen)


def multiply_const(k, dtype=C, vlen=1):
    return _ew(lambda x: x * jnp.asarray(k, dtype), 1, dtype, vlen)


def multiply_conjugate_cc(vlen=1):
    return _ew(lambda a, b: a * jnp.conj(b), 2, C, vlen)


def conjugate_cc(vlen=1):
    return _ew(jnp.conj, 1, C, vlen)


def abs_blk(dtype=F, vlen=1):
    return _ew(jnp.abs, 1, dtype, vlen)


def exponentiate_const_cci(k, vlen=1):
    return _ew(lambda x: x ** k, 1, C, vlen)


def integrate(decim, dtype=F):
    """Sum groups of decim items (gr::blocks::integrate)."""
    class Integrate(DecimBlock):
        def work(self, state, x):
            return state, jnp.sum(x.reshape(-1, decim), axis=1).astype(dtype)
    return Integrate(decim, PortSpec(dtype), PortSpec(dtype))


def nlog10_ff(n=10.0, k=0.0):
    return _ew(lambda x: n * jnp.log10(jnp.maximum(x, 1e-18)) + k, 1, F)


def rms(dtype=C, alpha=0.0001):
    """rms_cf/rms_ff: single-pole IIR of |x|^2, sqrt output."""
    from .iir_core import first_order_iir
    class RMS(SyncBlock):
        def __init__(self):
            super().__init__(PortSpec(dtype), PortSpec(F))

        def init_state(self):
            return jnp.zeros((), jnp.float32)

        def work(self, state, x):
            p = jnp.abs(x).astype(jnp.float32) ** 2
            y, carry = first_order_iir(p, jnp.float32(alpha), jnp.float32(1 - alpha), state)
            return carry, jnp.sqrt(y)
    return RMS()


# ---------------------------------------------------------------------------
# Type conversions (gr-blocks *_to_* catalog)
# ---------------------------------------------------------------------------
def complex_to_mag(vlen=1):
    return _ew(jnp.abs, 1, C, vlen, out_dtype=F)


def complex_to_mag_squared(vlen=1):
    return _ew(lambda x: (x.real * x.real + x.imag * x.imag), 1, C, vlen, out_dtype=F)


def complex_to_arg(vlen=1):
    return _ew(lambda x: jnp.arctan2(x.imag, x.real), 1, C, vlen, out_dtype=F)


def complex_to_real(vlen=1):
    return _ew(lambda x: x.real, 1, C, vlen, out_dtype=F)


def complex_to_imag(vlen=1):
    return _ew(lambda x: x.imag, 1, C, vlen, out_dtype=F)


def float_to_complex(vlen=1):
    class F2C(Block):
        in_ports = (PortSpec(F, vlen), PortSpec(F, vlen))
        out_ports = (PortSpec(C, vlen),)
        optional_inputs = (1,)   # imag port optional (io_signature 1,2)

        def apply(self, state, inputs, n_in):
            return state, ((inputs[0] + 1j * inputs[1]).astype(C),)
    return F2C()


def real_to_complex(vlen=1):
    return _ew(lambda x: x.astype(C), 1, F, vlen, out_dtype=C)


def float_to_int(scale=1.0):
    return _ew(lambda x: jnp.round(x * scale).astype(I), 1, F, out_dtype=I)


def float_to_short(scale=1.0):
    return _ew(lambda x: jnp.clip(jnp.round(x * scale), -32768, 32767).astype(S),
               1, F, out_dtype=S)


def float_to_char(scale=1.0):
    return _ew(lambda x: jnp.clip(jnp.round(x * scale), -128, 127).astype(B),
               1, F, out_dtype=B)


def short_to_float(scale=1.0):
    return _ew(lambda x: x.astype(F) * (1.0 / scale), 1, S, out_dtype=F)


def char_to_float(scale=1.0):
    return _ew(lambda x: x.astype(F) * (1.0 / scale), 1, B, out_dtype=F)


def int_to_float(scale=1.0):
    return _ew(lambda x: x.astype(F) * (1.0 / scale), 1, I, out_dtype=F)


def interleaved_short_to_complex(scale=1.0):
    class IS2C(DecimBlock):
        def work(self, state, x):
            xf = x.astype(jnp.float32).reshape(-1, 2) * (1.0 / scale)
            return state, (xf[:, 0] + 1j * xf[:, 1]).astype(C)
    return IS2C(2, PortSpec(S), PortSpec(C))


def complex_to_interleaved_short(scale=1.0):
    class C2IS(InterpBlock):
        def work(self, state, x):
            y = jnp.stack([x.real, x.imag], axis=1).reshape(-1) * scale
            return state, jnp.clip(jnp.round(y), -32768, 32767).astype(S)
    return C2IS(2, PortSpec(C), PortSpec(S))


# ---------------------------------------------------------------------------
# Stream shape
# ---------------------------------------------------------------------------
def stream_to_vector(nitems, dtype=C):
    class S2V(DecimBlock):
        def work(self, state, x):
            return state, x.reshape(-1, nitems)
    return S2V(nitems, PortSpec(dtype), PortSpec(dtype, nitems))


def vector_to_stream(nitems, dtype=C):
    class V2S(InterpBlock):
        def work(self, state, x):
            return state, x.reshape(-1)
    return V2S(nitems, PortSpec(dtype, nitems), PortSpec(dtype))


def stream_to_streams(nstreams, dtype=C):
    """Round-robin commutator (gr::blocks::stream_to_streams)."""
    class S2Ss(Block):
        def __init__(self):
            Block.__init__(self)
            self.in_ports = (PortSpec(dtype),)
            self.out_ports = tuple(PortSpec(dtype) for _ in range(nstreams))

        @property
        def in_rates(self):
            return (Fraction(nstreams),)

        @property
        def out_rates(self):
            return tuple(Fraction(1) for _ in range(nstreams))

        def apply(self, state, inputs, n_in):
            xs = inputs[0].reshape(-1, nstreams)
            return state, tuple(xs[:, i] for i in range(nstreams))
    return S2Ss()


def streams_to_stream(nstreams, dtype=C):
    class Ss2S(Block):
        def __init__(self):
            Block.__init__(self)
            self.in_ports = tuple(PortSpec(dtype) for _ in range(nstreams))
            self.out_ports = (PortSpec(dtype),)

        @property
        def in_rates(self):
            return tuple(Fraction(1) for _ in range(nstreams))

        @property
        def out_rates(self):
            return (Fraction(nstreams),)

        def apply(self, state, inputs, n_in):
            return state, (jnp.stack(inputs, axis=1).reshape(-1),)
    return Ss2S()


def streams_to_vector(nstreams, dtype=C):
    class Ss2V(Block):
        def __init__(self):
            Block.__init__(self)
            self.in_ports = tuple(PortSpec(dtype) for _ in range(nstreams))
            self.out_ports = (PortSpec(dtype, nstreams),)

        def apply(self, state, inputs, n_in):
            return state, (jnp.stack(inputs, axis=1),)
    return Ss2V()


def vector_to_streams(nstreams, dtype=C):
    class V2Ss(Block):
        def __init__(self):
            Block.__init__(self)
            self.in_ports = (PortSpec(dtype, nstreams),)
            self.out_ports = tuple(PortSpec(dtype) for _ in range(nstreams))

        def apply(self, state, inputs, n_in):
            return state, tuple(inputs[0][:, i] for i in range(nstreams))
    return V2Ss()


def interleave(nstreams, dtype=C, blocksize=1):
    class Interleave(Block):
        def __init__(self):
            Block.__init__(self)
            self.in_ports = tuple(PortSpec(dtype) for _ in range(nstreams))
            self.out_ports = (PortSpec(dtype),)

        @property
        def in_rates(self):
            return tuple(Fraction(blocksize) for _ in range(nstreams))

        @property
        def out_rates(self):
            return (Fraction(nstreams * blocksize),)

        def apply(self, state, inputs, n_in):
            xs = [x.reshape(-1, blocksize) for x in inputs]
            return state, (jnp.stack(xs, axis=1).reshape(-1),)
    return Interleave()


def deinterleave(nstreams, dtype=C, blocksize=1):
    class Deinterleave(Block):
        def __init__(self):
            Block.__init__(self)
            self.in_ports = (PortSpec(dtype),)
            self.out_ports = tuple(PortSpec(dtype) for _ in range(nstreams))

        @property
        def in_rates(self):
            return (Fraction(nstreams * blocksize),)

        @property
        def out_rates(self):
            return tuple(Fraction(blocksize) for _ in range(nstreams))

        def apply(self, state, inputs, n_in):
            xs = inputs[0].reshape(-1, nstreams, blocksize)
            return state, tuple(xs[:, i, :].reshape(-1) for i in range(nstreams))
    return Deinterleave()


def keep_one_in_n(n, dtype=C):
    class Keep1inN(DecimBlock):
        def work(self, state, x):
            # gr keeps the LAST of each group (keep_one_in_n_impl.cc)
            return state, x.reshape(-1, n)[:, n - 1]
    return Keep1inN(n, PortSpec(dtype), PortSpec(dtype))


def keep_m_in_n(m, n, offset=0, dtype=C):
    class KeepMinN(Block):
        def __init__(self):
            Block.__init__(self)
            self.in_ports = (PortSpec(dtype),)
            self.out_ports = (PortSpec(dtype),)

        @property
        def in_rates(self):
            return (Fraction(n),)

        @property
        def out_rates(self):
            return (Fraction(m),)

        def apply(self, state, inputs, n_in):
            xs = inputs[0].reshape(-1, n)
            return state, (xs[:, offset:offset + m].reshape(-1),)
    return KeepMinN()


def repeat(interp, dtype=C):
    class Repeat(InterpBlock):
        def work(self, state, x):
            return state, jnp.repeat(x, interp)
    return Repeat(interp, PortSpec(dtype), PortSpec(dtype))


class MovingAverage(SyncBlock):
    """moving_average_ff/cc: length-L sliding sum * scale, history L-1."""

    def __init__(self, length: int, scale=1.0, dtype=F, name=None):
        super().__init__(PortSpec(dtype), PortSpec(dtype), name)
        self.length = int(length)
        self.scale = scale

    def init_state(self):
        return self.in_ports[0].zeros(self.length - 1)

    def work(self, state, x):
        xp = jnp.concatenate([state, x], axis=0)
        c = jnp.cumsum(xp, axis=0)
        tot = c[self.length - 1:] - jnp.concatenate(
            [jnp.zeros((1,) + c.shape[1:], c.dtype), c[:-self.length]], axis=0)
        y = (tot * self.scale).astype(self.out_ports[0].dtype)
        return xp[xp.shape[0] - (self.length - 1):], y


def moving_average(length, scale=1.0, dtype=F):
    return MovingAverage(length, scale, dtype)


# ---------------------------------------------------------------------------
# Tag tools + message blocks (gr-blocks tag_gate/tag_debug,
# stream_to_tagged_stream, message_strobe/message_debug)
# ---------------------------------------------------------------------------
from ..core.tags import Tag, TPP_DONT  # noqa: E402


class TagGate(SyncBlock):
    """Pass samples, drop tags (gr::blocks::tag_gate)."""

    tag_policy = TPP_DONT

    def __init__(self, dtype=C, vlen=1, name=None):
        super().__init__(PortSpec(dtype, vlen), PortSpec(dtype, vlen), name)

    def work(self, state, x):
        return state, x


def tag_gate(dtype=C, vlen=1):
    return TagGate(dtype, vlen)


class TagShare(Block):
    """tag_share: output stream = input 0's data, carrying the union of
    tags from input 0 AND input 1 (gr-blocks/lib/tag_share_impl.cc — an
    io_signature(2,2) sync block whose work copies port 0; the scheduler's
    ALL_TO_ALL propagation does the sharing). Here the per-port ALL_TO_ALL
    engine gives exactly that: both ports' tags land on the output at
    unscaled offsets (all rates 1)."""

    def __init__(self, dtype_io=C, dtype_share=C, vlen=1, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(dtype_io, vlen), PortSpec(dtype_share, vlen))
        self.out_ports = (PortSpec(dtype_io, vlen),)

    def apply(self, state, inputs, n_in):
        return state, (inputs[0],)


def tag_share(dtype_io=C, dtype_share=C, vlen=1):
    return TagShare(dtype_io, dtype_share, vlen)


class TagDebug(SinkBlock):
    """Collect (and optionally print) tags (gr::blocks::tag_debug)."""

    def __init__(self, dtype=C, name="tag_debug", vlen=1, print_tags=False):
        super().__init__(PortSpec(dtype, vlen), name)
        self.print_tags = print_tags
        self.current_tags: list = []

    def collect_tags(self, tags):
        self.current_tags.extend(tags)
        if self.print_tags:
            for t in tags:
                print(f"[{self.name}] offset={t.offset} key={t.key!r} "
                      f"value={t.value!r}")

    def num_tags(self):
        return len(self.current_tags)


def tag_debug(dtype=C, name="tag_debug", vlen=1):
    return TagDebug(dtype, name, vlen)


class StreamToTaggedStream(SyncBlock):
    """Insert a length tag every packet_len items
    (gr::blocks::stream_to_tagged_stream)."""

    def __init__(self, packet_len: int, len_tag_key: str = "packet_len",
                 dtype=C, vlen=1, name=None):
        super().__init__(PortSpec(dtype, vlen), PortSpec(dtype, vlen), name)
        self.packet_len = int(packet_len)
        self.len_tag_key = len_tag_key

    def work(self, state, x):
        return state, x

    def transform_tags(self, tags_in, in_win, out_win):
        w0, w1 = out_win
        first = -(-w0 // self.packet_len) * self.packet_len
        new = [Tag(off, self.len_tag_key, self.packet_len, self.name)
               for off in range(first, w1, self.packet_len)]
        return list(tags_in) + new


def stream_to_tagged_stream(packet_len, len_tag_key="packet_len", dtype=C,
                            vlen=1):
    return StreamToTaggedStream(packet_len, len_tag_key, dtype, vlen)


class BurstTagger(Block):
    """Tag bursts using a trigger stream: emits sob/eob tags where the
    trigger stream transitions (gr::blocks::burst_tagger, host-side via the
    tag sideband on trigger values captured per step)."""

    def __init__(self, dtype=C, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(dtype), PortSpec(S))
        self.out_ports = (PortSpec(dtype),)
        self._last_trigger = 0

    def apply(self, state, inputs, n_in):
        return state, (inputs[0],)


class MessageStrobe(Block):
    """Post a fixed message on every step (gr::blocks::message_strobe; the
    reference strobes on a wall-clock period — here the step index is the
    clock, matching the compiled-graph execution model)."""

    def __init__(self, msg, period_steps: int = 1, name=None):
        super().__init__(name)
        self.msg = msg
        self.period = max(1, int(period_steps))
        self.message_port_register_out("strobe")

    def msg_work(self, step_index):
        if step_index % self.period == 0:
            self.post("strobe", self.msg)


def message_strobe(msg, period_steps=1):
    return MessageStrobe(msg, period_steps)


class MessageDebug(Block):
    """Collect received messages (gr::blocks::message_debug)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.messages: list = []
        self.message_port_register_in("store", self.messages.append)
        self.message_port_register_in("print",
                                      lambda m: print(f"[{self.name}] {m}"))
        self.message_port_register_in("print_pdu",
                                      lambda m: print(f"[{self.name}] {m}"))

    def num_messages(self):
        return len(self.messages)

    def get_message(self, i):
        return self.messages[i]


def message_debug():
    return MessageDebug()


# ---------------------------------------------------------------------------
# GR type-suffix aliases (the reference's public block names: suffix encodes
# port dtype — b=int8, s=int16, i=int32, f=float32, c=complex64)
# ---------------------------------------------------------------------------

def _typed(factory, dtype):
    def make(*args, **kw):
        return factory(*args, dtype=dtype, **kw)
    return make


def add_ff(nin=2, vlen=1):
    return add(F, nin, vlen)


def add_cc(nin=2, vlen=1):
    return add(C, nin, vlen)


def add_ii(nin=2, vlen=1):
    return add(I, nin, vlen)


def add_ss(nin=2, vlen=1):
    return add(S, nin, vlen)


def sub_ff(nin=2):
    return sub(F, nin)


def sub_cc(nin=2):
    return sub(C, nin)


def multiply_ff(nin=2, vlen=1):
    return multiply(F, nin, vlen)


def multiply_cc(nin=2, vlen=1):
    return multiply(C, nin, vlen)


def divide_ff(nin=2):
    return divide(F, nin)


def divide_cc(nin=2):
    return divide(C, nin)


def add_const_ff(k):
    return add_const(k, F)


def add_const_cc(k):
    return add_const(k, C)


def add_const_ii(k):
    return add_const(k, I)


def add_const_ss(k):
    return add_const(k, S)


def multiply_const_ff(k, vlen=1):
    return multiply_const(k, F, vlen)


def multiply_const_cc(k, vlen=1):
    return multiply_const(k, C, vlen)


def multiply_const_vff(k):
    import numpy as _np
    k = _np.asarray(k, _np.float32)
    return multiply_const(k, F, vlen=len(k))


def multiply_const_vcc(k):
    import numpy as _np
    k = _np.asarray(k, _np.complex64)
    return multiply_const(k, C, vlen=len(k))


def skiphead(n, dtype=C, vlen=1):
    return SkipHead(n, PortSpec(dtype, vlen))


def rms_ff(alpha=0.0001):
    return rms(F, alpha)


def rms_cf(alpha=0.0001):
    return rms(C, alpha)
