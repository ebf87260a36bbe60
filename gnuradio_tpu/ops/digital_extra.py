"""gr-digital catalog, part 2: LFSR scramblers, GLFSR sources, access-code
correlation, SNR estimation, EVM.

Reference parity:
  digital::lfsr (gr-digital/include/gnuradio/digital/lfsr.h:103-130):
      next_bit_scramble: out = reg&1; newbit = parity(reg&mask)^in;
                         reg = (reg>>1) | (newbit<<len)
      next_bit_descramble: out = parity(reg&mask)^in; reg = (reg>>1)|(in<<len)
  scrambler_bb / descrambler_bb (gr-digital/lib/*_impl.cc): one lfsr cycle
      per bit.
  glfsr_source_b/f (lib/glfsr_source_*_impl.cc): free-running Galois LFSR of
      given degree, bits or bipolar floats.
  correlate_access_code_bb (lib/correlate_access_code_bb_impl.cc): slide a
      64-bit access code over the bit stream; where the Hamming distance <=
      threshold, set flag bit 1 on the output byte (bit 0 carries data).
  mpsk_snr_est_cc (lib/mpsk_snr_est.cc): M2M4 and simple (mean/variance)
      moment estimators.
  meas_evm_cc: RMS error-vector magnitude vs nearest constellation point.

Design: the DEscrambler's register contains only past *inputs*, so it is
a windowed XOR — fully parallel (same parity-matmul trick as the conv
encoder). The scrambler's register feeds back, so it stays a lax.scan (bit
rate). GLFSR sequences come from a scan over the register. Access-code
correlation is a windowed popcount compare — parallel.
"""
from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, SinkBlock, SourceBlock, SyncBlock
from ..core.stream import PortSpec, B, C, F


# ---------------------------------------------------------------------------
# multiplicative scrambler / descrambler
# ---------------------------------------------------------------------------

def _parity32(v):
    v = v ^ (v >> 16)
    v = v ^ (v >> 8)
    v = v ^ (v >> 4)
    v = v ^ (v >> 2)
    v = v ^ (v >> 1)
    return v & 1


class Scrambler(SyncBlock):
    """scrambler_bb: multiplicative (self-synchronizing) scrambler."""

    def __init__(self, mask: int, seed: int, length: int, name=None):
        super().__init__(PortSpec(B), PortSpec(B), name)
        self.mask, self.seed, self.length = mask, seed, length

    def init_state(self):
        return {"reg": jnp.uint32(self.seed)}

    def work(self, state, x):
        mask = jnp.uint32(self.mask)
        ln = self.length

        def step(reg, inb):
            out = reg & 1
            newbit = _parity32(reg & mask) ^ (inb.astype(jnp.uint32) & 1)
            reg = (reg >> 1) | (newbit << ln)
            return reg, out

        reg, outs = jax.lax.scan(step, state["reg"], x)
        return {"reg": reg}, outs.astype(jnp.int8)


def scrambler_bb(mask=0x8A, seed=0x7F, length=7):
    return Scrambler(mask, seed, length)


class Descrambler(SyncBlock):
    """descrambler_bb. Register bits are past inputs only, so the whole
    stream is out[i] = in[i] ^ parity(mask-selected window of past inputs):
    one parallel windowed XOR (no scan)."""

    def __init__(self, mask: int, seed: int, length: int, name=None):
        super().__init__(PortSpec(B), PortSpec(B), name)
        self.mask, self.seed, self.length = int(mask), int(seed), int(length)
        # register bit b (0..length) at time i holds in[i - (length+1-b)];
        # tap delays for mask bits:
        self.delays = [self.length + 1 - b for b in range(self.length + 1)
                       if (self.mask >> b) & 1]
        self.hist = self.length + 1

    def init_state(self):
        # seed provides the pre-stream history bits: reg bit b = seed bit b
        # corresponds to virtual in[-(length+1-b)]
        hist = np.zeros(self.hist, np.int8)
        for b in range(self.length + 1):
            d = self.length + 1 - b
            if d <= self.hist:
                hist[self.hist - d] = (self.seed >> b) & 1
        return {"tail": jnp.asarray(hist)}

    def work(self, state, x):
        xb = x.astype(jnp.int32) & 1
        ext = jnp.concatenate([state["tail"].astype(jnp.int32), xb])
        n = xb.shape[0]
        acc = xb
        for d in self.delays:
            acc = acc ^ jax.lax.dynamic_slice(ext, (self.hist - d,), (n,))
        new_tail = ext[ext.shape[0] - self.hist:].astype(jnp.int8)
        return {"tail": new_tail}, acc.astype(jnp.int8)


def descrambler_bb(mask=0x8A, seed=0x7F, length=7):
    return Descrambler(mask, seed, length)


# ---------------------------------------------------------------------------
# GLFSR source
# ---------------------------------------------------------------------------

# primitive polynomial masks per degree (glfsr.h POLYNOMIAL table values,
# standard maximal-length LFSR taps)
GLFSR_POLY = {
    1: 0x1, 2: 0x3, 3: 0x5, 4: 0x9, 5: 0x12, 6: 0x21, 7: 0x41, 8: 0x8E,
    9: 0x108, 10: 0x204, 11: 0x402, 12: 0x829, 13: 0x100D, 14: 0x2015,
    15: 0x4001, 16: 0x8016, 17: 0x10004, 18: 0x20013, 19: 0x40013,
    20: 0x80004, 21: 0x100002, 22: 0x200001, 23: 0x400010, 24: 0x80000D,
    25: 0x1000004, 26: 0x2000023, 27: 0x4000013, 28: 0x8000004,
    29: 0x10000002, 30: 0x20000029, 31: 0x40000004, 32: 0x80000057,
}


class GlfsrSource(SourceBlock):
    """glfsr_source_b/f: Galois LFSR PN sequence (bits or bipolar floats).
    Galois step: out = reg & 1; reg >>= 1; if out: reg ^= poly_mask."""

    def __init__(self, degree: int, repeat: bool = True, mask: int = 0,
                 seed: int = 1, bipolar: bool = False, name=None):
        super().__init__(PortSpec(F) if bipolar else PortSpec(B), name)
        self.mask = mask if mask else GLFSR_POLY[degree]
        self.seed = seed if seed else 1
        self.bipolar = bipolar

    def init_state(self):
        return {"reg": jnp.uint32(self.seed)}

    def generate(self, state, n):
        mask = jnp.uint32(self.mask)

        def step(reg, _):
            out = reg & 1
            reg = reg >> 1
            reg = jnp.where(out == 1, reg ^ mask, reg)
            return reg, out

        reg, outs = jax.lax.scan(step, state["reg"], None, length=n)
        if self.bipolar:
            y = (outs.astype(jnp.float32) * 2.0 - 1.0)
        else:
            y = outs.astype(jnp.int8)
        return {"reg": reg}, y


def glfsr_source_b(degree, repeat=True, mask=0, seed=1):
    return GlfsrSource(degree, repeat, mask, seed, bipolar=False)


def glfsr_source_f(degree, repeat=True, mask=0, seed=1):
    return GlfsrSource(degree, repeat, mask, seed, bipolar=True)


# ---------------------------------------------------------------------------
# access code correlation
# ---------------------------------------------------------------------------

class CorrelateAccessCode(SyncBlock):
    """correlate_access_code_bb: set flag bit 1 on the byte where the
    trailing `len(code)` bits match within `threshold` errors. Bit 0 carries
    the data bit through. Windowed Hamming distance -> fully parallel."""

    def __init__(self, access_code: str, threshold: int = 0, name=None):
        super().__init__(PortSpec(B), PortSpec(B), name)
        self.code = np.array([1 if c == "1" else 0 for c in access_code],
                             np.int32)
        self.threshold = int(threshold)

    def init_state(self):
        return {"tail": jnp.zeros(len(self.code) - 1, jnp.int8)}

    def work(self, state, x):
        nbits = len(self.code)
        xb = x.astype(jnp.int32) & 1
        ext = jnp.concatenate([state["tail"].astype(jnp.int32), xb])
        n = xb.shape[0]
        # window ending at sample i: ext[i .. i+nbits-1] vs code
        dist = jnp.zeros(n, jnp.int32)
        for k in range(nbits):
            dist = dist + (jax.lax.dynamic_slice(ext, (k,), (n,))
                           ^ int(self.code[k]))
        flag = (dist <= self.threshold).astype(jnp.int32)
        out = (xb | (flag << 1)).astype(jnp.int8)
        return {"tail": ext[ext.shape[0] - (nbits - 1):].astype(jnp.int8)}, out


def correlate_access_code_bb(access_code, threshold=0):
    return CorrelateAccessCode(access_code, threshold)


# ---------------------------------------------------------------------------
# SNR estimation / EVM
# ---------------------------------------------------------------------------

def snr_est_m2m4(x):
    """M2M4 moment SNR estimator (mpsk_snr_est_m2m4::snr). Returns linear
    SNR estimate for constant-modulus signals."""
    y1 = jnp.mean(jnp.abs(x) ** 2)
    y2 = jnp.mean(jnp.abs(x) ** 4)
    arg = jnp.maximum(2 * y1 * y1 - y2, 0.0)
    s = jnp.sqrt(arg)
    n = y1 - s
    return s / jnp.maximum(n, 1e-20)


def snr_est_simple(x):
    """'Simple' estimator: signal = |mean of hard-decided BPSK|, noise =
    variance (mpsk_snr_est_simple)."""
    m = jnp.abs(jnp.mean(jnp.abs(x.real)))
    v = jnp.var(jnp.abs(x.real))
    return (m * m) / jnp.maximum(v, 1e-20)


class MpskSnrEst(SinkBlock):
    """mpsk_snr_est_cc probe form: running SNR estimate in dB."""

    def __init__(self, est_type: str = "m2m4", name=None):
        super().__init__(PortSpec(C), name)
        self.est_type = est_type
        self._snr = 0.0

    @property
    def tap_port(self):
        return PortSpec(F)

    def apply(self, state, inputs, n_in):
        est = (snr_est_m2m4 if self.est_type == "m2m4" else snr_est_simple)
        lin = est(inputs[0])
        return state, (10.0 * jnp.log10(jnp.maximum(lin, 1e-20)),)

    def collect(self, value):
        self._snr = float(np.asarray(value))

    def snr(self) -> float:
        return self._snr


def mpsk_snr_est_cc(est_type="m2m4"):
    return MpskSnrEst(est_type)


class MeasEvm(SyncBlock):
    """meas_evm_cc (gr-digital/lib/meas_evm_cc_impl.cc): per-sample EVM (%)
    vs the nearest constellation point, streamed out."""

    def __init__(self, points, name=None):
        super().__init__(PortSpec(C), PortSpec(F), name)
        self.points = np.asarray(points, np.complex64)

    def work(self, state, x):
        d = jnp.abs(x[:, None] - jnp.asarray(self.points)[None, :])
        nearest = jnp.min(d, axis=1)
        ref = jnp.sqrt(jnp.mean(jnp.abs(jnp.asarray(self.points)) ** 2))
        return state, (100.0 * nearest / ref).astype(jnp.float32)

    def collect(self, value):
        self._evm = float(np.asarray(value))

    def evm(self) -> float:
        return self._evm


def meas_evm_cc(points, meas_type=0):
    # GRC passes a constellation OBJECT (cons param); unwrap its points
    pts = getattr(points, "points", points)
    return MeasEvm(np.asarray(pts))


# ---------------------------------------------------------------------------
# corr_est_cc: known-sequence correlator with amplitude/phase/time estimates
# ---------------------------------------------------------------------------

class CorrEst(Block):
    """corr_est_cc (gr-digital/lib/corr_est_cc_impl.cc): correlate the
    stream against a known modulated sync word (FFT fast-convolution with
    the time-reversed conjugate, like the reference's fft_filter_ccc) and
    output both the delayed stream and the correlation. Peak extraction +
    tagging (phase_est/time_est/corr_est) is data-dependent, so it runs on
    the host over the correlation output via corr_est_peaks()."""

    def __init__(self, symbols, sps: float = 1.0, threshold: float = 0.9,
                 name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(C), PortSpec(C))
        self.symbols = np.asarray(symbols, np.complex64)
        # windowed dot products below compute correlation directly, so the
        # taps are just the conjugate (the reference time-reverses because
        # its fft_filter computes convolution)
        self.taps = np.conj(self.symbols)
        self.sps = float(sps)
        self.threshold = float(threshold)

    def init_state(self):
        return {"tail": jnp.zeros(len(self.taps) - 1, C)}

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        ext = jnp.concatenate([state["tail"], x])
        n = x.shape[0]
        taps = jnp.asarray(self.taps)
        L = taps.shape[0]
        # windowed dot products: corr[i] = sum_k ext[i+k] * taps[k]
        idx = jnp.arange(n)[:, None] + jnp.arange(L)[None, :]
        corr = (ext[idx] * taps[None, :]).sum(-1)
        return ({"tail": ext[ext.shape[0] - (L - 1):]}, (x, corr))


def corr_est_cc(symbols, sps=1.0, threshold=0.9):
    return CorrEst(symbols, sps, threshold)


def corr_est_peaks(corr, symbols, threshold=0.9):
    """Host-side peak extraction over a correlation array: returns a list
    of dicts {offset, corr_est, phase_est, amp_est} for local maxima whose
    |corr|^2 exceeds threshold * (sync-word autocorrelation energy)^2 —
    the reference's THRESHOLD_ABSOLUTE method. `offset` indexes the LAST
    sample of the detected sync word (the block's carried (L-1)-tail means
    corr[i] covers input window [i-L+1, i]); subtract len(symbols)-1 for
    the start."""
    corr = np.asarray(corr)
    e = float(np.sum(np.abs(np.asarray(symbols)) ** 2))
    mag2 = np.abs(corr) ** 2
    thresh = threshold * e * e
    peaks = []
    for i in range(1, len(corr) - 1):
        if mag2[i] >= thresh and mag2[i] >= mag2[i - 1] \
                and mag2[i] > mag2[i + 1]:
            peaks.append({"offset": i,
                          "corr_est": float(np.sqrt(mag2[i])),
                          "phase_est": float(-np.angle(corr[i])),
                          "amp_est": float(np.sqrt(mag2[i]) / e)})
    return peaks
