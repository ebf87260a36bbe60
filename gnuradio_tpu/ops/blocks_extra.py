"""gr-blocks catalog, part 2: logic, detectors, stream shaping, bit packing.

Reference parity (headers in gr-blocks/include/gnuradio/blocks/): and/or/
xor/not (+_const), count_bits, endian_swap, max/min, argmax,
sample_and_hold, threshold_ff, stretch_ff, peak_detector, peak_detector2,
plateau_detector_fb, mute, selector, stream_mux, patterned_interleaver,
packed_to_unpacked, unpacked_to_packed, repack_bits_bb, rotator_cc, vco_f/c,
transcendental, multiply_matrix, complex_to_magphase, magphase_to_complex,
phase_shift, correctiq, stretch.

Design notes: the reference implements hold/hysteresis/peak logic as
per-sample state machines. Where the recurrence is a *carry-forward of the
last event* (sample_and_hold, threshold hysteresis) we use the
last-nonzero-index trick — a single `associative_scan(max)` over event
indices — which runs elementwise in parallel instead of a sequential scan.
True peak searches keep a lax.scan (they are data-dependent chases), but
they sit at low rates in real graphs.
"""
from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, SinkBlock, SyncBlock, SourceBlock
from ..core.stream import PortSpec, B, S, I, F, C
from .iir_core import first_order_iir


# ---------------------------------------------------------------------------
# logic / integer ops
# ---------------------------------------------------------------------------

class _Logic(Block):
    def __init__(self, fn, nin, dtype, name=None):
        super().__init__(name)
        self.fn = fn
        self.in_ports = tuple(PortSpec(dtype) for _ in range(nin))
        self.out_ports = (PortSpec(dtype),)

    def apply(self, state, inputs, n_in):
        acc = inputs[0]
        for x in inputs[1:]:
            acc = self.fn(acc, x)
        return state, (acc,)


def and_bb(nin=2):
    return _Logic(jnp.bitwise_and, nin, B)


def or_bb(nin=2):
    return _Logic(jnp.bitwise_or, nin, B)


def xor_bb(nin=2):
    return _Logic(jnp.bitwise_xor, nin, B)


def and_const_bb(k):
    return _Logic(lambda a, _=None: a & int(k), 1, B)


class NotBlock(SyncBlock):
    def __init__(self, dtype=B, name=None):
        super().__init__(PortSpec(dtype), PortSpec(dtype), name)

    def work(self, state, x):
        return state, ~x


def not_bb():
    return NotBlock(B)


class CountBits(SyncBlock):
    """Popcount per item (gr::blocks::count_bits)."""

    def __init__(self, name=None):
        super().__init__(PortSpec(I), PortSpec(I), name)

    def work(self, state, x):
        v = x.astype(jnp.uint32)
        cnt = jnp.zeros_like(v)
        for s in range(32):
            cnt = cnt + ((v >> s) & 1)
        return state, cnt.astype(jnp.int32)


def count_bits():
    return CountBits()


class EndianSwap(SyncBlock):
    """Byte-swap each item (gr::blocks::endian_swap)."""

    def __init__(self, item_dtype=I, name=None):
        super().__init__(PortSpec(item_dtype), PortSpec(item_dtype), name)

    def work(self, state, x):
        nbytes = np.dtype(x.dtype).itemsize
        u = x.view(jnp.uint32 if nbytes == 4 else jnp.uint16)
        if nbytes == 4:
            y = (((u & 0xFF) << 24) | ((u & 0xFF00) << 8) |
                 ((u >> 8) & 0xFF00) | (u >> 24))
        else:
            y = ((u & 0xFF) << 8) | (u >> 8)
        return state, y.view(x.dtype)


def endian_swap(dtype=I):
    return EndianSwap(dtype)


# ---------------------------------------------------------------------------
# elementwise extrema / transcendental / matrix
# ---------------------------------------------------------------------------

class MaxBlk(Block):
    """Per-item max over nin input streams (gr::blocks::max_XX)."""

    def __init__(self, nin=2, dtype=F, fn=jnp.maximum, name=None):
        super().__init__(name)
        self.fn = fn
        self.in_ports = tuple(PortSpec(dtype) for _ in range(nin))
        self.out_ports = (PortSpec(dtype),)

    def apply(self, state, inputs, n_in):
        acc = inputs[0]
        for x in inputs[1:]:
            acc = self.fn(acc, x)
        return state, (acc,)


def max_ff(nin=2):
    return MaxBlk(nin, F, jnp.maximum)


def min_ff(nin=2):
    return MaxBlk(nin, F, jnp.minimum)


class ArgMax(Block):
    """Per-vector argmax (gr::blocks::argmax_XX, single-input form):
    vlen floats in -> int16 index out."""

    def __init__(self, vlen: int, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(F, vlen),)
        self.out_ports = (PortSpec(S),)

    def apply(self, state, inputs, n_in):
        return state, (jnp.argmax(inputs[0], axis=-1).astype(jnp.int16),)


def argmax_fs(vlen):
    return ArgMax(vlen)


class Transcendental(SyncBlock):
    """Apply a named math function (gr::blocks::transcendental)."""

    def __init__(self, fname: str, dtype=F, name=None):
        super().__init__(PortSpec(dtype), PortSpec(dtype), name)
        self.fn = getattr(jnp, fname)

    def work(self, state, x):
        return state, self.fn(x).astype(x.dtype)


def transcendental(fname, dtype=F):
    return Transcendental(fname, dtype)


class MultiplyMatrix(Block):
    """N input streams -> M outputs via an MxN matrix
    (gr::blocks::multiply_matrix) — a literal matmul."""

    def __init__(self, A, dtype=F, name=None):
        super().__init__(name)
        self.A = np.asarray(A)
        M, N = self.A.shape
        self.in_ports = tuple(PortSpec(dtype) for _ in range(N))
        self.out_ports = tuple(PortSpec(dtype) for _ in range(M))
        # 'set_A' message port (multiply_matrix_impl.cc msg_handler):
        # replaces the matrix; shape must match. Applies at the next
        # lock()/unlock() recompile like other live-param updates.
        self.message_port_register_in("set_A", self._on_set_a)

    def _on_set_a(self, msg):
        A = np.asarray(msg)
        if A.shape == self.A.shape:
            self.A = A

    def apply(self, state, inputs, n_in):
        X = jnp.stack(inputs, axis=0)               # [N, n]
        Y = jnp.asarray(self.A, X.dtype) @ X        # [M, n]
        return state, tuple(Y[m] for m in range(Y.shape[0]))


def multiply_matrix_ff(A):
    return MultiplyMatrix(A, F)


class ComplexToMagphase(Block):
    def __init__(self, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(F), PortSpec(F))

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        return state, (jnp.abs(x), jnp.angle(x))


def complex_to_magphase():
    return ComplexToMagphase()


class MagphaseToComplex(Block):
    def __init__(self, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(F), PortSpec(F))
        self.out_ports = (PortSpec(C),)

    def apply(self, state, inputs, n_in):
        mag, ph = inputs
        return state, ((mag * jnp.exp(1j * ph)).astype(jnp.complex64),)


def magphase_to_complex():
    return MagphaseToComplex()


class PhaseShift(SyncBlock):
    """Constant phase rotation (gr::blocks::phase_shift)."""

    def __init__(self, shift_rad: float, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.shift = float(shift_rad)

    def work(self, state, x):
        return state, x * np.complex64(np.exp(1j * self.shift))


def phase_shift(shift_rad):
    return PhaseShift(shift_rad)


class CorrectIQ(SyncBlock):
    """DC-offset removal via a slow single-pole tracker
    (gr::blocks::correctiq): dc[i] = (1-r) dc[i-1] + r x[i]; y = x - dc.
    The recurrence is a first-order linear IIR -> parallel log-depth scan."""

    def __init__(self, rate: float = 1e-4, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.rate = float(rate)

    def init_state(self):
        return {"dc": jnp.zeros((), jnp.complex64)}

    def work(self, state, x):
        dc_trace, dc_last = first_order_iir(x, self.rate, 1.0 - self.rate,
                                            state["dc"])
        return {"dc": dc_last}, x - dc_trace


def correctiq(rate=1e-4):
    return CorrectIQ(rate)


# ---------------------------------------------------------------------------
# hold / hysteresis / peaks (carry-forward formulations)
# ---------------------------------------------------------------------------

def _carry_forward(values, events, init):
    """out[i] = values[j] at the last index j <= i with events[j] != 0, else
    carried `init`. One associative max-scan over indices — parallel."""
    n = values.shape[0]
    idx = jnp.where(events, jnp.arange(n), -1)
    last = jax.lax.associative_scan(jnp.maximum, idx)
    picked = values[jnp.maximum(last, 0)]
    return jnp.where(last >= 0, picked, init), last


class SampleAndHold(Block):
    """out follows in while ctrl != 0, holds otherwise
    (gr::blocks::sample_and_hold)."""

    def __init__(self, dtype=F, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(dtype), PortSpec(B))
        self.out_ports = (PortSpec(dtype),)

    def init_state(self):
        return {"held": jnp.zeros((), self.in_ports[0].dtype)}

    def apply(self, state, inputs, n_in):
        x, ctrl = inputs
        out, _ = _carry_forward(x, ctrl != 0, state["held"])
        return {"held": out[-1]}, (out,)


def sample_and_hold_ff():
    return SampleAndHold(F)


class ThresholdFF(SyncBlock):
    """Hysteresis comparator (gr::blocks::threshold_ff): output switches to
    hi_out when in > hi, to lo_out when in < lo, holds in between."""

    def __init__(self, lo: float, hi: float, initial: float = 0.0, name=None):
        super().__init__(PortSpec(F), PortSpec(F), name)
        self.lo, self.hi, self.initial = float(lo), float(hi), float(initial)

    def init_state(self):
        return {"out": jnp.float32(self.initial)}

    def work(self, state, x):
        ev_hi = x > self.hi
        ev_lo = x < self.lo
        vals = jnp.where(ev_hi, 1.0, 0.0).astype(jnp.float32)
        out, _ = _carry_forward(vals, ev_hi | ev_lo, state["out"])
        return {"out": out[-1]}, out


def threshold_ff(lo, hi, initial=0.0):
    return ThresholdFF(lo, hi, initial)


class StretchFF(SyncBlock):
    """Clamp samples below `lo` up to lo (gr::blocks::stretch_ff)."""

    def __init__(self, lo: float, name=None):
        super().__init__(PortSpec(F), PortSpec(F), name)
        self.lo = float(lo)

    def work(self, state, x):
        return state, jnp.maximum(x, self.lo)


def stretch_ff(lo):
    return StretchFF(lo)


class PlateauDetector(SyncBlock):
    """Emit 1 at the center of runs of >=max_len samples above threshold
    (gr::blocks::plateau_detector_fb)."""

    def __init__(self, max_len: int, threshold: float = 0.9, name=None):
        super().__init__(PortSpec(F), PortSpec(B), name)
        self.max_len = int(max_len)
        self.threshold = float(threshold)

    def init_state(self):
        return {"run": jnp.int32(0)}

    def work(self, state, x):
        above = x > self.threshold

        def step(run, a):
            run = jnp.where(a, run + 1, 0)
            fire = run == self.max_len
            return run, fire

        run, fires = jax.lax.scan(step, state["run"], above)
        return {"run": run}, fires.astype(jnp.int8)


def plateau_detector_fb(max_len, threshold=0.9):
    return PlateauDetector(max_len, threshold)


class PeakDetector(SyncBlock):
    """Flag the maximum within each region where the (alpha-averaged) signal
    exceeds threshold_factor_rise (simplified gr::blocks::peak_detector_fb:
    per-chunk regions instead of unbounded look-ahead)."""

    def __init__(self, threshold_factor_rise: float = 0.25, name=None):
        super().__init__(PortSpec(F), PortSpec(B), name)
        self.thr = float(threshold_factor_rise)

    def work(self, state, x):
        thr = self.thr * jnp.max(jnp.abs(x))
        above = x > thr
        peak_idx = jnp.argmax(jnp.where(above, x, -jnp.inf))
        out = jnp.zeros(x.shape, jnp.int8).at[peak_idx].set(1)
        out = jnp.where(jnp.any(above), out, jnp.zeros_like(out))
        return state, out


def peak_detector_fb(threshold_factor_rise=0.25):
    return PeakDetector(threshold_factor_rise)


# ---------------------------------------------------------------------------
# gating / selection / muxing
# ---------------------------------------------------------------------------

class Mute(SyncBlock):
    """Zero the stream when muted (gr::blocks::mute_XX); the flag lives in
    state so set_mute() works without recompiling."""

    def __init__(self, mute: bool = False, dtype=C, name=None):
        super().__init__(PortSpec(dtype), PortSpec(dtype), name)
        self._mute0 = bool(mute)

    def init_state(self):
        return {"mute": jnp.asarray(1.0 if self._mute0 else 0.0, jnp.float32)}

    def set_mute(self, tb, m: bool):
        """Flip the flag in a running TopBlock's state (no recompile)."""
        tb.state[self.name] = {"mute": jnp.asarray(1.0 if m else 0.0,
                                                   jnp.float32)}

    def work(self, state, x):
        return state, jnp.where(state["mute"] > 0, jnp.zeros_like(x), x)


def mute_cc(mute=False):
    return Mute(mute, C)


def mute_ff(mute=False):
    return Mute(mute, F)


class Selector(Block):
    """Forward one of nin inputs (gr::blocks::selector); index in state."""

    def __init__(self, nin: int, input_index: int = 0, dtype=C, name=None):
        super().__init__(name)
        self.in_ports = tuple(PortSpec(dtype) for _ in range(nin))
        self.out_ports = (PortSpec(dtype),)
        self._idx0 = input_index

    def init_state(self):
        return {"idx": jnp.int32(self._idx0)}

    def apply(self, state, inputs, n_in):
        stacked = jnp.stack(inputs, axis=0)
        return state, (stacked[state["idx"]],)


def selector(nin, input_index=0, dtype=C):
    return Selector(nin, input_index, dtype)


class StreamMux(Block):
    """Interleave N inputs in blocks of lengths[i] (gr::blocks::stream_mux).
    Static gather: one output period = sum(lengths) items."""

    def __init__(self, lengths, dtype=C, name=None):
        super().__init__(name)
        self.lengths = [int(l) for l in lengths]
        self.period = sum(self.lengths)
        self.in_ports = tuple(PortSpec(dtype) for _ in self.lengths)
        self.out_ports = (PortSpec(dtype),)

    @property
    def in_rates(self):
        return tuple(Fraction(l) for l in self.lengths)

    @property
    def out_rates(self):
        return (Fraction(self.period),)

    def apply(self, state, inputs, n_in):
        nper = inputs[0].shape[0] // self.lengths[0] if self.lengths[0] else 0
        chunks = []
        for x, l in zip(inputs, self.lengths):
            chunks.append(x.reshape(nper, l))
        out = jnp.concatenate(chunks, axis=1)
        return state, (out.reshape(-1),)


def stream_mux(lengths, dtype=C):
    return StreamMux(lengths, dtype)


class PatternedInterleaver(Block):
    """Output items follow `pattern` of input indices
    (gr::blocks::patterned_interleaver)."""

    def __init__(self, pattern, dtype=C, name=None):
        super().__init__(name)
        self.pattern = [int(p) for p in pattern]
        nin = max(self.pattern) + 1
        self.counts = [self.pattern.count(i) for i in range(nin)]
        self.in_ports = tuple(PortSpec(dtype) for _ in range(nin))
        self.out_ports = (PortSpec(dtype),)

    @property
    def in_rates(self):
        return tuple(Fraction(c) for c in self.counts)

    @property
    def out_rates(self):
        return (Fraction(len(self.pattern)),)

    def apply(self, state, inputs, n_in):
        P = len(self.pattern)
        nper = inputs[0].shape[0] // self.counts[0]
        mats = [x.reshape(nper, c) for x, c in zip(inputs, self.counts)]
        cols = []
        used = [0] * len(inputs)
        for p in self.pattern:
            cols.append(mats[p][:, used[p]])
            used[p] += 1
        out = jnp.stack(cols, axis=1)
        return state, (out.reshape(-1),)


def patterned_interleaver(pattern, dtype=C):
    return PatternedInterleaver(pattern, dtype)


# ---------------------------------------------------------------------------
# bit packing (packed_to_unpacked / unpacked_to_packed / repack_bits)
# ---------------------------------------------------------------------------

class PackedToUnpacked(Block):
    """Split the byte stream into bits_per_chunk-bit chunks, MSB first
    (gr::blocks::packed_to_unpacked_bb with GR_MSB_FIRST). Non-divisor
    chunk sizes (e.g. 6 bits for 64QAM) tick at lcm(8, bpc) bits so the
    bit stream crosses byte boundaries exactly like the reference."""

    def __init__(self, bits_per_chunk: int = 1, name=None):
        super().__init__(name)
        import math
        self.bpc = int(bits_per_chunk)
        lcm = math.lcm(8, self.bpc)
        self._in_bytes = lcm // 8
        self._out_chunks = lcm // self.bpc
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)

    @property
    def in_rates(self):
        return (Fraction(self._in_bytes),)

    @property
    def out_rates(self):
        return (Fraction(self._out_chunks),)

    def apply(self, state, inputs, n_in):
        x = inputs[0].astype(jnp.int32) & 0xFF
        bits = ((x[:, None] >> jnp.arange(7, -1, -1)) & 1).reshape(-1)
        g = bits.reshape(-1, self.bpc)
        w = jnp.asarray(1 << np.arange(self.bpc - 1, -1, -1), jnp.int32)
        out = (g * w).sum(axis=1)
        return state, (out.astype(jnp.int8),)


def packed_to_unpacked_bb(bits_per_chunk=1):
    return PackedToUnpacked(bits_per_chunk)


class UnpackedToPacked(Block):
    def __init__(self, bits_per_chunk: int = 1, name=None):
        super().__init__(name)
        import math
        self.bpc = int(bits_per_chunk)
        lcm = math.lcm(8, self.bpc)
        self._in_chunks = lcm // self.bpc
        self._out_bytes = lcm // 8
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)

    @property
    def in_rates(self):
        return (Fraction(self._in_chunks),)

    @property
    def out_rates(self):
        return (Fraction(self._out_bytes),)

    def apply(self, state, inputs, n_in):
        x = inputs[0].astype(jnp.int32)
        mask = (1 << self.bpc) - 1
        bits = (((x & mask)[:, None]
                 >> jnp.arange(self.bpc - 1, -1, -1)) & 1).reshape(-1)
        g = bits.reshape(-1, 8)
        w = jnp.asarray(1 << np.arange(7, -1, -1), jnp.int32)
        out = (g * w).sum(axis=1)
        return state, (out.astype(jnp.int8),)


def unpacked_to_packed_bb(bits_per_chunk=1):
    return UnpackedToPacked(bits_per_chunk)


class RepackBits(Block):
    """Repack k-bit items into l-bit items (gr::blocks::repack_bits_bb,
    MSB-first align mode)."""

    def __init__(self, k: int, l: int, name=None):
        super().__init__(name)
        self.k, self.l = int(k), int(l)
        g = math.gcd(self.k, self.l)
        self.in_per = self.l // g
        self.out_per = self.k // g
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)

    @property
    def in_rates(self):
        return (Fraction(self.in_per),)

    @property
    def out_rates(self):
        return (Fraction(self.out_per),)

    def apply(self, state, inputs, n_in):
        x = inputs[0].astype(jnp.int32)
        kshifts = jnp.arange(self.k - 1, -1, -1)
        bits = ((x[:, None] >> kshifts) & 1).reshape(-1, self.out_per * self.l)
        # regroup into l-bit outputs
        bits = bits.reshape(-1, self.l)
        lw = jnp.asarray(2 ** np.arange(self.l - 1, -1, -1), jnp.int32)
        out = jnp.sum(bits * lw, axis=1)
        return state, (out.astype(jnp.int8),)


def repack_bits_bb(k, l):
    return RepackBits(k, l)


# ---------------------------------------------------------------------------
# rotator / VCO
# ---------------------------------------------------------------------------

class RotatorCC(SyncBlock):
    """Multiply by exp(j*phase_inc*n) (gr::blocks::rotator_cc). The
    reference renormalizes |phase| every 512 samples
    (blocks/rotator.h:30-43); here the phase wraps mod 2pi
    every chunk, which keeps f32 phase exact at any stream length — documented substitution
    (SURVEY.md App. C)."""

    def __init__(self, phase_inc: float, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.phase_inc = float(phase_inc)

    def init_state(self):
        return {"phase": jnp.zeros((), jnp.float32)}

    def work(self, state, x):
        n = x.shape[0]
        ph = (state["phase"] +
              self.phase_inc * jnp.arange(n, dtype=jnp.float32))
        rot = jnp.exp(1j * ph.astype(jnp.float32)).astype(jnp.complex64)
        new_phase = jnp.mod(state["phase"] + self.phase_inc * n,
                            2.0 * np.pi)
        return {"phase": new_phase}, x * rot


def rotator_cc(phase_inc):
    return RotatorCC(phase_inc)


class Vco(SyncBlock):
    """Voltage-controlled oscillator (gr::blocks::vco_f / vco_c):
    phase += sensitivity * in; out = amplitude * cos(phase) (or exp(j.))."""

    def __init__(self, sensitivity: float, amplitude: float = 1.0,
                 complex_out: bool = False, name=None):
        out = PortSpec(C) if complex_out else PortSpec(F)
        super().__init__(PortSpec(F), out, name)
        self.sens = float(sensitivity)
        self.amp = float(amplitude)
        self.complex_out = complex_out

    def init_state(self):
        return {"phase": jnp.zeros((), jnp.float32)}

    def work(self, state, x):
        ph = state["phase"] + jnp.cumsum(
            x.astype(jnp.float32)) * self.sens
        new_phase = jnp.mod(ph[-1], 2.0 * np.pi)
        phf = ph.astype(jnp.float32)
        if self.complex_out:
            y = (self.amp * jnp.exp(1j * phf)).astype(jnp.complex64)
        else:
            y = (self.amp * jnp.cos(phf)).astype(jnp.float32)
        return {"phase": new_phase}, y


def vco_f(sensitivity, amplitude=1.0):
    return Vco(sensitivity, amplitude, complex_out=False)


def vco_c(sensitivity, amplitude=1.0):
    return Vco(sensitivity, amplitude, complex_out=True)
