"""gr-digital tracking loops: Costas, FLL band-edge, Mueller & Müller clock
recovery, PFB clock sync — the inherently sequential per-sample feedback
recurrences (SURVEY.md §7 'hard parts' (a)).

Design stance: these loops carry data-dependent state (phase, frequency,
fractional delay) sample to sample, so they run as `lax.scan` over the
chunk. That keeps them off the matmul units, but they sit at SYMBOL rate (after the
decimating matched filter), 1-2 orders of magnitude below the front-end
sample rate where the matmul kernels do the heavy lifting — matching the
reference, whose equivalent loops are scalar C++ too (control_loop.cc,
clock_recovery_mm_cc_impl.cc). Batched/multi-channel use vmaps the scan.

Reference parity:
  control_loop (gr-blocks/lib/control_loop.cc): 2nd-order PI loop,
      critically damped gains from loop bw: denom = 1 + 2 d bw + bw^2,
      alpha = 4 d bw / denom, beta = 4 bw^2 / denom.
  costas_loop_cc (gr-digital/lib/costas_loop_cc_impl.cc): order 2/4/8 phase
      detectors, out = in * exp(-j phase).
  fll_band_edge_cc (lib/fll_band_edge_cc_impl.cc): band-edge filter pair,
      error = Re{out_upper * conj(out_upper)} - ... (power difference).
  clock_recovery_mm_cc (lib/clock_recovery_mm_cc_impl.cc): M&M TED +
      mu/omega update + 8-tap interpolating FIR
      (lib/mmse_fir_interpolator_cc.cc — our taps are windowed-sinc at 128
      fractional steps; documented substitution for the MMSE table).
"""
from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, SyncBlock
from ..core.stream import PortSpec, B, C, F


def loop_gains(loop_bw: float, damping: float = math.sqrt(2) / 2):
    """alpha, beta from loop bandwidth (control_loop.cc:update_gains)."""
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = (4 * damping * loop_bw) / denom
    beta = (4 * loop_bw * loop_bw) / denom
    return alpha, beta


def _wrap_phase(p):
    """phase_wrap to [-2pi, 2pi) as in control_loop.h (coarse wrap)."""
    two_pi = 2 * math.pi
    return p - jnp.floor((p + two_pi) / (2 * two_pi)) * (2 * two_pi)


class CostasLoop(SyncBlock):
    """costas_loop_cc: carrier phase tracking for M-PSK (order 2, 4, 8).

    Per sample (costas_loop_cc_impl.cc work):
        nco = exp(-j phase); out = in * nco
        e   = phase_detector(out)       (order-specific)
        freq += beta * e; phase += freq + alpha * e
        clip freq to [-1, 1]; wrap phase
    """

    def __init__(self, loop_bw: float, order: int, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        if order not in (2, 4, 8):
            raise ValueError("order must be 2, 4, or 8")
        self.order = order
        self.alpha, self.beta = loop_gains(loop_bw)

    def init_state(self):
        return {"phase": jnp.zeros((), F), "freq": jnp.zeros((), F)}

    def _detector(self, z):
        if self.order == 2:
            return z.real * z.imag
        if self.order == 4:
            return (jnp.where(z.real > 0, 1.0, -1.0) * z.imag
                    - jnp.where(z.imag > 0, 1.0, -1.0) * z.real)
        # order 8 (costas_loop_cc_impl.cc phase_detector_8)
        K = math.sqrt(2.0) - 1.0
        cond = jnp.abs(z.real) >= jnp.abs(z.imag)
        return jnp.where(
            cond,
            jnp.where(z.real > 0, 1.0, -1.0) * z.imag
            - jnp.where(z.imag > 0, 1.0, -1.0) * z.real * K,
            jnp.where(z.real > 0, 1.0, -1.0) * z.imag * K
            - jnp.where(z.imag > 0, 1.0, -1.0) * z.real)

    def work(self, state, x):
        alpha, beta = jnp.float32(self.alpha), jnp.float32(self.beta)

        def step(carry, xn):
            phase, freq = carry
            nco = jnp.exp(-1j * phase).astype(C)
            out = xn * nco
            e = jnp.clip(self._detector(out), -1.0, 1.0)
            freq = jnp.clip(freq + beta * e, -1.0, 1.0)
            phase = _wrap_phase(phase + freq + alpha * e)
            return (phase, freq), out

        (phase, freq), y = jax.lax.scan(step, (state["phase"], state["freq"]), x)
        return {"phase": phase, "freq": freq}, y.astype(C)


def costas_loop_cc(loop_bw, order):
    return CostasLoop(loop_bw, order)


# ---------------------------------------------------------------------------
# Interpolating resampler taps (clock recovery)
# ---------------------------------------------------------------------------
_NSTEPS = 128
_NTAPS = 8


def _interp_taps_table():
    """(NSTEPS+1, 8) fractional-delay filters: windowed-sinc at mu = i/128,
    standing in for the reference's MMSE-optimized table
    (gr-filter/lib/interpolator_taps.h). Group delay 3 + mu samples."""
    table = np.zeros((_NSTEPS + 1, _NTAPS), np.float32)
    n = np.arange(_NTAPS)
    w = np.kaiser(2 * _NTAPS + 1, 8.0)
    for i in range(_NSTEPS + 1):
        mu = i / _NSTEPS
        t = n - 3 - mu
        h = np.sinc(t) * np.interp(t, np.arange(-_NTAPS, _NTAPS + 1), w)
        table[i] = h / np.sum(h)
    return table


_TAPS_TABLE = _interp_taps_table()


def mmse_interp(xp, base_idx, mu):
    """Interpolate at fractional position base_idx + mu using the 8-tap
    table (mmse_fir_interpolator_cc.cc semantics: needs samples
    xp[base_idx .. base_idx+7], result delayed 3+mu)."""
    imu = jnp.clip(jnp.round(mu * _NSTEPS).astype(jnp.int32), 0, _NSTEPS)
    taps = jnp.asarray(_TAPS_TABLE)[imu]  # (8,)
    window = jax.lax.dynamic_slice(xp, (base_idx,), (_NTAPS,))
    return jnp.sum(window * taps)


class ClockRecoveryMM(Block):
    """clock_recovery_mm_cc: Mueller & Müller symbol timing recovery
    (gr-digital/lib/clock_recovery_mm_cc_impl.cc).

    Chunk contract: consumes n inputs, produces n/round(omega_nominal)
    outputs with a validity count (data-dependent rate is masked, not
    dynamic — SURVEY.md §7 (b)). State carries (mu, omega, last interpolants,
    input tail + read offset) so the sequence is exact across chunks.
    """

    SLACK = 16  # input tail carried across chunks

    def __init__(self, omega: float, gain_omega: float, mu: float,
                 gain_mu: float, omega_relative_limit: float = 0.001,
                 name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(C),)
        self.omega0 = float(omega)
        self.gain_omega = float(gain_omega)
        self.mu0 = float(mu)
        self.gain_mu = float(gain_mu)
        self.omega_rel = float(omega_relative_limit)
        self.sps = int(round(omega))

    @property
    def in_rates(self):
        return (Fraction(self.sps),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def init_state(self):
        return {
            "tail": jnp.zeros((self.SLACK,), C),
            "pos": jnp.float32(0.0),   # fractional read pos within tail
            "omega": jnp.float32(self.omega0),
            "mu": jnp.float32(self.mu0),
            "p1": jnp.zeros((), C), "p2": jnp.zeros((), C),
            "c1": jnp.zeros((), C), "c2": jnp.zeros((), C),
        }

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        n = x.shape[0]
        n_out = n // self.sps
        xp = jnp.concatenate([state["tail"], x], axis=0)
        omega_mid = jnp.float32(self.omega0)
        omega_lim = jnp.float32(self.omega0 * self.omega_rel)
        g_o, g_m = jnp.float32(self.gain_omega), jnp.float32(self.gain_mu)

        def slicer(z):
            return (jnp.where(z.real > 0, 1.0, 0.0)
                    + 1j * jnp.where(z.imag > 0, 1.0, 0.0)).astype(C) * 2 - (1 + 1j)

        def step(carry, _):
            pos, omega, mu, p1, p2, c1, c2 = carry
            ii = jnp.floor(pos).astype(jnp.int32)
            frac = pos - jnp.floor(pos)
            p0 = mmse_interp(xp, ii, frac)
            c0 = slicer(p0)
            xerr = (c0 - c2) * jnp.conj(p1)
            yerr = (p0 - p2) * jnp.conj(c1)
            e = jnp.clip((yerr - xerr).real, -1.0, 1.0)
            omega = omega + g_o * e
            omega = omega_mid + jnp.clip(omega - omega_mid, -omega_lim, omega_lim)
            pos = pos + omega + g_m * e
            return (pos, omega, mu, p0, p1, c0, c1), p0

        carry0 = (state["pos"], state["omega"], state["mu"],
                  state["p1"], state["p2"], state["c1"], state["c2"])
        carry, y = jax.lax.scan(step, carry0, None, length=n_out)
        pos, omega, mu, p1, p2, c1, c2 = carry
        # keep the last SLACK input samples; new pos is relative to new tail
        new_tail = xp[xp.shape[0] - self.SLACK:]
        new_pos = pos - jnp.float32(n)  # position relative to next chunk tail
        state2 = {"tail": new_tail, "pos": new_pos, "omega": omega,
                  "mu": mu, "p1": p1, "p2": p2, "c1": c1, "c2": c2}
        return state2, (y.astype(C),)


def clock_recovery_mm_cc(omega, gain_omega, mu, gain_mu,
                         omega_relative_limit=0.001):
    return ClockRecoveryMM(omega, gain_omega, mu, gain_mu,
                           omega_relative_limit)


class FllBandEdge(SyncBlock):
    """fll_band_edge_cc: frequency-locked loop using band-edge filter power
    difference (gr-digital/lib/fll_band_edge_cc_impl.cc). Exact closed-loop
    form: like the reference, the band-edge filters run over the CORRECTED
    output history (impl work() keeps d_output_hist), so the scan carries a
    rolling M-sample window of corrected samples — per-sample cost 2 M-tap
    dots, acceptable for an acquisition block. For bulk chunk-mode frequency
    acquisition prefer cfo_estimate_x4 (block-based, one FFT)."""

    def __init__(self, sps: float, rolloff: float, filter_size: int,
                 loop_bw: float, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.sps = float(sps)
        self.alpha, self.beta = loop_gains(loop_bw)
        self.fmax = 2 * math.pi / self.sps  # freq limit (impl.cc)
        M = int(filter_size)
        # band-edge filter design (fll_band_edge_cc_impl.cc:design_filter):
        # power-of-cos rolloff edge filters; we use the sinc-prototype pair
        # modulated to +-(1+rolloff)/(2 sps) of the symbol rate.
        k = np.arange(M) - (M - 1) / 2.0
        bb = np.sinc(2 * k / self.sps / 2)
        bb = bb / np.sum(np.abs(bb))
        edge = np.pi * (1 + rolloff) / self.sps
        self.taps_upper = (bb * np.exp(+1j * edge * k)).astype(np.complex64)
        self.taps_lower = (bb * np.exp(-1j * edge * k)).astype(np.complex64)
        self.M = M

    def init_state(self):
        return {"phase": jnp.zeros((), F), "freq": jnp.zeros((), F),
                "hist": jnp.zeros((self.M,), C)}

    def work(self, state, x):
        alpha, beta = jnp.float32(self.alpha), jnp.float32(self.beta)
        fmax = jnp.float32(self.fmax)
        tu = jnp.asarray(self.taps_upper)
        tl = jnp.asarray(self.taps_lower)

        def step(carry, xn):
            phase, freq, hist = carry
            out = xn * jnp.exp(-1j * phase).astype(C)
            hist = jnp.concatenate([hist[1:], out[None]])
            ou = jnp.sum(hist * tu)
            ol = jnp.sum(hist * tl)
            e = (ol.real ** 2 + ol.imag ** 2) - (ou.real ** 2 + ou.imag ** 2)
            freq = jnp.clip(freq + beta * e, -fmax, fmax)
            phase = _wrap_phase(phase + freq + alpha * e)
            return (phase, freq, hist), out

        (phase, freq, hist), y = jax.lax.scan(
            step, (state["phase"], state["freq"], state["hist"]), x)
        return {"phase": phase, "freq": freq, "hist": hist}, y.astype(C)


def cfo_estimate_x4(x, order: int = 4):
    """Chunk-level M-PSK carrier-frequency estimator: the M-th power of an
    M-PSK signal has a spectral line at M*f_cfo; locate it with one FFT and
    return the estimated CFO in rad/sample. data-parallel replacement for
    streaming band-edge acquisition (one FFT per chunk instead of a
    per-sample loop); pull-in range +-pi/order rad/sample."""
    n = x.shape[0]
    sM = x ** order
    S = jnp.fft.fft(sM * jnp.hanning(n).astype(jnp.float32))
    k = jnp.argmax(jnp.abs(S))
    k = jnp.where(k > n // 2, k - n, k)  # signed bin
    return (2 * jnp.pi * k / n / order).astype(F)


class CfoCorrector(SyncBlock):
    """Chunk-based CFO acquisition + correction: estimate via
    cfo_estimate_x4 with exponential smoothing across chunks, correct with a
    phase-continuous NCO. Functional stand-in for fll_band_edge in chunked
    receive chains."""

    def __init__(self, smooth: float = 0.5, order: int = 4, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.smooth = float(smooth)
        self.order = int(order)

    def init_state(self):
        return {"freq": jnp.zeros((), F), "phase": jnp.zeros((), F),
                "init": jnp.zeros((), jnp.bool_)}

    def work(self, state, x):
        est = cfo_estimate_x4(x, self.order)
        freq = jnp.where(state["init"],
                         state["freq"] + self.smooth * (est - state["freq"]),
                         est)
        n = x.shape[0]
        ph = state["phase"] + freq * jnp.arange(n, dtype=F)
        y = x * jnp.exp(-1j * ph).astype(C)
        new_phase = jnp.mod(state["phase"] + freq * n, 2 * jnp.pi)
        return {"freq": freq, "phase": new_phase,
                "init": jnp.ones((), jnp.bool_)}, y


def fll_band_edge_cc(sps, rolloff, filter_size, loop_bw):
    return FllBandEdge(sps, rolloff, filter_size, loop_bw)


class PfbClockSync(Block):
    """pfb_clock_sync_ccf: joint matched filtering + symbol timing recovery
    via a polyphase filterbank (gr-digital/lib/pfb_clock_sync_ccf_impl.cc).

    The TED is the derivative-matched-filter detector
        e = Re{ conj(h_k * x) * (dh_k * x) }
    (impl.cc error_r/error_i average) — decision-free and ROTATION
    INVARIANT, unlike M&M, so it locks with uncorrected carrier phase; this
    is why the reference's generic_demod uses it before the Costas loop.

    Timing state is a continuous fractional position advancing ~sps per
    output symbol; the fractional part selects one of nfilts arms (the
    reference's d_k/d_filtnum bookkeeping). Sequential scan over symbols;
    each step is two L-tap dots + dynamic window slice.
    """

    SLACK = 32

    def __init__(self, sps: float, loop_bw: float, taps, nfilts: int = 32,
                 init_phase: float | None = None,
                 max_rate_deviation: float = 1.5, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(C),)
        self.sps = float(sps)
        self.isps = int(round(sps))
        self.nfilts = int(nfilts)
        self.alpha, self.beta = loop_gains(loop_bw)
        self.max_dev = float(max_rate_deviation)
        taps = np.asarray(taps, np.float64)
        dtaps = np.zeros_like(taps)
        dtaps[:-1] = taps[1:] - taps[:-1]
        dtaps[-1] = taps[0] - taps[-1]
        # normalize diff taps like the reference (power matching)
        pwr = np.sum(np.abs(dtaps)) / len(dtaps) * self.nfilts
        if pwr > 0:
            dtaps = dtaps / pwr * np.sum(np.abs(taps)) / len(taps) * self.nfilts
        from .pfb import _pad_arms
        self.arms = _pad_arms(taps.astype(np.float32), self.nfilts)
        self.darms = _pad_arms(dtaps.astype(np.float32), self.nfilts)
        self.L = self.arms.shape[1]
        self.init_frac = (0.5 if init_phase is None
                          else float(init_phase) / self.nfilts)

    @property
    def in_rates(self):
        return (Fraction(self.isps),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def init_state(self):
        return {
            "tail": jnp.zeros((self.SLACK,), C),
            "pos": jnp.float32(self.init_frac),  # fractional sample position
            "rate": jnp.float32(0.0),            # timing rate adjustment
        }

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        n = x.shape[0]
        n_out = n // self.isps
        xp = jnp.concatenate([state["tail"], x], axis=0)
        alpha, beta = jnp.float32(self.alpha), jnp.float32(self.beta)
        sps = jnp.float32(self.sps)
        max_dev = jnp.float32(self.max_dev / self.nfilts)
        arms = jnp.asarray(self.arms)
        darms = jnp.asarray(self.darms)
        nf = self.nfilts
        L = self.L

        def step(carry, _):
            pos, rate = carry
            ii = jnp.floor(pos).astype(jnp.int32)
            frac = pos - jnp.floor(pos)
            arm = jnp.clip(jnp.round(frac * nf).astype(jnp.int32), 0, nf - 1)
            w = jax.lax.dynamic_slice(xp, (ii,), (L,))
            h = arms[arm]
            dh = darms[arm]
            out = jnp.sum(w * h)
            dout = jnp.sum(w * dh)
            e = jnp.clip((out.real * dout.real + out.imag * dout.imag), -1.0, 1.0)
            rate = jnp.clip(rate + beta * e, -max_dev, max_dev)
            pos = pos + sps + rate + alpha * e
            return (pos, rate), out

        (pos, rate), y = jax.lax.scan(
            step, (state["pos"], state["rate"]), None, length=n_out)
        new_tail = xp[xp.shape[0] - self.SLACK:]
        new_pos = pos - jnp.float32(n)
        return ({"tail": new_tail, "pos": new_pos, "rate": rate},
                (y.astype(C),))


def pfb_clock_sync_ccf(sps, loop_bw, taps, filter_size=32, init_phase=16,
                       max_rate_deviation=1.5, osps=1):
    return PfbClockSync(sps, loop_bw, taps, filter_size, init_phase,
                        max_rate_deviation)


# ---------------------------------------------------------------------------
# MMSE fractional resampler (gr-filter mmse_resampler_cc/ff)
# ---------------------------------------------------------------------------

class MmseResampler(Block):
    """mmse_resampler_xx: arbitrary-ratio resampler — mu advances by
    `resamp_ratio` per output, 8-tap MMSE interpolation at each fractional
    position (gr-filter/lib/mmse_resampler_cc_impl.cc). Static-rate
    contract: emits floor(n/ratio) items per chunk with the fractional
    residue carried."""

    SLACK = 16

    def __init__(self, phase_shift: float, resamp_ratio: float,
                 dtype=C, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)
        self.ratio = float(resamp_ratio)
        self.mu0 = float(phase_shift)
        frac = Fraction(self.ratio).limit_denominator(1 << 12)
        self._in_r = Fraction(frac.numerator)
        self._out_r = Fraction(frac.denominator)

    @property
    def in_rates(self):
        return (self._in_r,)

    @property
    def out_rates(self):
        return (self._out_r,)

    def init_state(self):
        return {"tail": jnp.zeros(self.SLACK, self.in_ports[0].dtype),
                "pos": jnp.float32(self.mu0)}

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        n = x.shape[0]
        n_out = int(round(n / self.ratio))
        xp = jnp.concatenate([state["tail"], x])

        def step(pos, _):
            ii = jnp.floor(pos).astype(jnp.int32)
            y = mmse_interp(xp, ii, pos - jnp.floor(pos))
            return pos + self.ratio, y

        pos, y = jax.lax.scan(step, state["pos"], None, length=n_out)
        return ({"tail": xp[xp.shape[0] - self.SLACK:],
                 "pos": pos - jnp.float32(n)}, (y,))


def mmse_resampler_cc(phase_shift, resamp_ratio):
    return MmseResampler(phase_shift, resamp_ratio, C)


def mmse_resampler_ff(phase_shift, resamp_ratio):
    return MmseResampler(phase_shift, resamp_ratio, F)


# ---------------------------------------------------------------------------
# MSK timing recovery (gr-digital msk_timing_recovery_cc)
# ---------------------------------------------------------------------------

class MskTimingRecovery(Block):
    """msk_timing_recovery_cc: square-law clock recovery for (G)MSK —
    nonlinearity e(n) = in(n)^2 * conj(in(n-sps))^2, differentiated by the
    sps/2-delayed copy, driving a 2nd-order loop on the interpolation
    offset (msk_timing_recovery_cc_impl.cc general_work). One output
    symbol per sps inputs."""

    SLACK = 32

    def __init__(self, sps: float, gain: float = 0.05, limit: float = 0.1,
                 name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(C),)
        self.sps = float(sps)
        self.isps = int(round(sps))
        self.gain = float(gain)
        self.gain_omega = self.gain * self.gain * 0.25
        # NOTE: not named `limit` — the runtime reserves that attribute for
        # head-style item limiting (core/runtime.py)
        self.dev_limit = float(limit)

    @property
    def in_rates(self):
        return (Fraction(self.isps),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def init_state(self):
        return {"tail": jnp.zeros(self.SLACK, C),
                "pos": jnp.float32(0.0),
                "omega": jnp.float32(self.sps),
                "dly1": jnp.zeros((), C), "dly2": jnp.zeros((), C),
                "diff1": jnp.zeros((), C)}

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        n = x.shape[0]
        n_out = n // self.isps
        xp = jnp.concatenate([state["tail"], x])
        sps = self.sps

        def interp(pos):
            ii = jnp.floor(pos).astype(jnp.int32)
            return mmse_interp(xp, ii, pos - jnp.floor(pos))

        def step(carry, _):
            pos, omega, dly1, dly2, diff1 = carry
            cur = interp(pos)
            half = interp(jnp.maximum(pos - sps / 2, 0.0))
            sq = cur * cur
            nlin = sq * jnp.conj(dly2 * dly2)
            err = jnp.clip(jnp.real(nlin - diff1), -1.0, 1.0)
            omega = jnp.clip(omega + self.gain_omega * err,
                             sps - self.dev_limit, sps + self.dev_limit)
            pos = pos + omega + self.gain * err
            return (pos, omega, half, dly1, nlin), cur

        carry0 = (state["pos"], state["omega"], state["dly1"],
                  state["dly2"], state["diff1"])
        (pos, om, d1, d2, df), y = jax.lax.scan(step, carry0, None,
                                                length=n_out)
        return ({"tail": xp[xp.shape[0] - self.SLACK:],
                 "pos": pos - jnp.float32(n), "omega": om,
                 "dly1": d1, "dly2": d2, "diff1": df}, (y.astype(C),))


def msk_timing_recovery_cc(sps, gain=0.05, limit=0.1):
    return MskTimingRecovery(sps, gain, limit)


class ConstellationReceiver(SyncBlock):
    """constellation_receiver_cb: joint carrier tracking + decision
    (gr-digital/lib/constellation_receiver_cb_impl.cc — a costas-style loop
    whose phase error comes from the decided constellation point, then the
    decision index is emitted). Composed here from the CostasLoop recursion
    with generic nearest-point decisions inside the same scan."""

    def __init__(self, constellation, loop_bw: float, name=None):
        from ..core.stream import PortSpec as _PS, B as _B, C as _C
        super().__init__(_PS(_C), _PS(_B), name)
        self.const = constellation
        denom = 1.0 + 2.0 * 1.0 * loop_bw + loop_bw * loop_bw
        self.alpha = 4.0 * 1.0 * loop_bw / denom
        self.beta = 4.0 * loop_bw * loop_bw / denom

    def init_state(self):
        return {"phase": jnp.zeros((), jnp.float32),
                "freq": jnp.zeros((), jnp.float32)}

    def work(self, state, x):
        pts = jnp.asarray(self.const.points)

        def step(carry, xn):
            ph, fr = carry
            y = xn * jnp.exp(-1j * ph).astype(xn.dtype)
            d = jnp.argmin(jnp.abs(y - pts) ** 2)
            ref = pts[d]
            e = jnp.angle(y * jnp.conj(ref)).astype(jnp.float32)
            fr = jnp.clip(fr + self.beta * e, -1.0, 1.0)
            ph = ph + fr + self.alpha * e
            ph = jnp.mod(ph + jnp.pi, 2 * jnp.pi) - jnp.pi
            return (ph, fr), d.astype(jnp.int8)

        (ph, fr), idx = jax.lax.scan(step, (state["phase"], state["freq"]), x)
        return {"phase": ph, "freq": fr}, idx


def constellation_receiver_cb(constellation, loop_bw=2 * math.pi / 100):
    return ConstellationReceiver(constellation, loop_bw)
