"""gr-analog catalog, part 2: PLLs, squelch family, probes, CPFSK, AGC3.

Reference parity:
  pll_freqdet_cf / pll_refout_cc / pll_carriertracking_cc
      (gr-analog/lib/pll_*.cc): 2nd-order PI carrier loop on the instantaneous
      phase error mod2pi(arg(in) - phase); the three blocks differ only in
      what they emit (freq, reference carrier, derotated input).
  simple_squelch_cc (lib/simple_squelch_cc_impl.cc): single-pole IIR of
      |x|^2 vs threshold, hard gate.
  pwr_squelch_cc/ff (lib/pwr_squelch_*): same detector wrapped in the
      squelch_base attack/decay ramp state machine — here the ramp is a
      raised-cosine applied per chunk boundary (documented simplification:
      gate decisions at chunk rate, ramp inside the gate transition).
  ctcss_squelch_ff: Goertzel tone detector gate.
  probe_avg_mag_sqrd_{c,f,cf}: IIR power probe with threshold flag.
  fmdet_cf: FM discriminator (implemented as conj-product discriminator
      with the block's gain convention — documented substitution for the
      reference's slope-detector approximation).
  cpfsk_bc: continuous-phase FSK modulator.
  agc3_cc: block-average fast-attack AGC.
  random_uniform_source, fastnoise_source.

Design: PLLs are true per-sample feedback -> lax.scan (symbol/audio
rates). Squelch power estimation is a first-order linear recurrence ->
parallel associative scan; gates are elementwise selects.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, SinkBlock, SourceBlock, SyncBlock
from ..core.stream import PortSpec, B, C, F
from .digital_loops import loop_gains
from .iir_core import first_order_iir


def _mod_2pi(x):
    """Wrap to (-pi, pi] (gr::blocks::control_loop phase detector wrap)."""
    two_pi = 2 * math.pi
    return x - two_pi * jnp.floor((x + math.pi) / two_pi)


class _PllBase(SyncBlock):
    """Shared 2nd-order PLL scan (control_loop gains from loop bw)."""

    def __init__(self, loop_bw: float, max_freq: float, min_freq: float,
                 out_port: PortSpec, name=None):
        super().__init__(PortSpec(C), out_port, name)
        self.alpha, self.beta = loop_gains(loop_bw)
        self.max_freq, self.min_freq = float(max_freq), float(min_freq)

    def init_state(self):
        return {"phase": jnp.zeros((), jnp.float32),
                "freq": jnp.zeros((), jnp.float32)}

    def _scan(self, state, x):
        ph_in = jnp.angle(x)

        def step(carry, pin):
            phase, freq = carry
            e = _mod_2pi(pin - phase)
            freq = jnp.clip(freq + self.beta * e, self.min_freq,
                            self.max_freq)
            phase = _mod_2pi(phase + freq + self.alpha * e)
            return (phase, freq), (phase, freq)

        (ph, fr), (phases, freqs) = jax.lax.scan(
            step, (state["phase"], state["freq"]), ph_in)
        return {"phase": ph, "freq": fr}, phases, freqs


class PllFreqdet(_PllBase):
    """pll_freqdet_cf: emits the loop's instantaneous frequency estimate."""

    def __init__(self, loop_bw, max_freq, min_freq, name=None):
        super().__init__(loop_bw, max_freq, min_freq, PortSpec(F), name)

    def work(self, state, x):
        state, phases, freqs = self._scan(state, x)
        return state, freqs


def pll_freqdet_cf(loop_bw, max_freq, min_freq):
    return PllFreqdet(loop_bw, max_freq, min_freq)


class PllRefout(_PllBase):
    """pll_refout_cc: emits the locked reference carrier exp(j phase)."""

    def __init__(self, loop_bw, max_freq, min_freq, name=None):
        super().__init__(loop_bw, max_freq, min_freq, PortSpec(C), name)

    def work(self, state, x):
        state, phases, _ = self._scan(state, x)
        return state, jnp.exp(1j * phases).astype(jnp.complex64)


def pll_refout_cc(loop_bw, max_freq, min_freq):
    return PllRefout(loop_bw, max_freq, min_freq)


class PllCarrierTracking(_PllBase):
    """pll_carriertracking_cc: derotates the input by the tracked carrier."""

    def __init__(self, loop_bw, max_freq, min_freq, name=None):
        super().__init__(loop_bw, max_freq, min_freq, PortSpec(C), name)

    def work(self, state, x):
        state, phases, _ = self._scan(state, x)
        return state, (x * jnp.exp(-1j * phases)).astype(jnp.complex64)


def pll_carriertracking_cc(loop_bw, max_freq, min_freq):
    return PllCarrierTracking(loop_bw, max_freq, min_freq)


# ---------------------------------------------------------------------------
# squelch
# ---------------------------------------------------------------------------

class SimpleSquelch(SyncBlock):
    """simple_squelch_cc: y = x if iir(|x|^2) >= threshold else 0."""

    def __init__(self, threshold_db: float, alpha: float = 0.0001, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.threshold = 10.0 ** (threshold_db / 10.0)
        self.alpha = float(alpha)

    def init_state(self):
        return {"avg": jnp.zeros((), jnp.float32)}

    def work(self, state, x):
        p = (x * jnp.conj(x)).real.astype(jnp.float32)
        trace, last = first_order_iir(p, self.alpha, 1.0 - self.alpha,
                                      state["avg"])
        gate = trace >= self.threshold
        return {"avg": last}, jnp.where(gate, x, 0.0).astype(jnp.complex64)


def simple_squelch_cc(threshold_db, alpha=0.0001):
    return SimpleSquelch(threshold_db, alpha)


class PwrSquelch(SyncBlock):
    """pwr_squelch_cc/ff with a linear ramp of `ramp` samples applied at
    gate transitions (squelch_base_cc attack/decay analog)."""

    def __init__(self, threshold_db: float, alpha: float = 0.0001,
                 ramp: int = 0, dtype=C, name=None):
        super().__init__(PortSpec(dtype), PortSpec(dtype), name)
        self.threshold = 10.0 ** (threshold_db / 10.0)
        self.alpha = float(alpha)
        self.ramp = int(ramp)

    def init_state(self):
        return {"avg": jnp.zeros((), jnp.float32),
                "env": jnp.zeros((), jnp.float32)}

    def work(self, state, x):
        p = (jnp.abs(x) ** 2).astype(jnp.float32)
        trace, last = first_order_iir(p, self.alpha, 1.0 - self.alpha,
                                      state["avg"])
        gate = (trace >= self.threshold).astype(jnp.float32)
        if self.ramp > 0:
            # envelope follows the gate with slope 1/ramp: a first-order
            # clipped follower, evaluated as scan (cheap: audio rates)
            def step(env, g):
                env = jnp.clip(env + (g - env) * (1.0 / self.ramp), 0.0, 1.0)
                return env, env
            envl, envs = jax.lax.scan(step, state["env"], gate)
            out = (x * envs).astype(x.dtype)
            return {"avg": last, "env": envl}, out
        return ({"avg": last, "env": state["env"]},
                (x * gate).astype(x.dtype))


def pwr_squelch_cc(threshold_db, alpha=0.0001, ramp=0):
    return PwrSquelch(threshold_db, alpha, ramp, C)


def pwr_squelch_ff(threshold_db, alpha=0.0001, ramp=0):
    return PwrSquelch(threshold_db, alpha, ramp, F)


class CtcssSquelch(SyncBlock):
    """ctcss_squelch_ff: gate audio on presence of a CTCSS tone. Tone power
    measured per chunk with a Goertzel single-bin DFT vs total power."""

    def __init__(self, rate: float, freq: float, level: float = 0.01,
                 name=None):
        super().__init__(PortSpec(F), PortSpec(F), name)
        self.rate, self.freq, self.level = float(rate), float(freq), level

    def init_state(self):
        return {"open": jnp.zeros((), jnp.float32)}

    def work(self, state, x):
        n = x.shape[0]
        w = 2 * math.pi * self.freq / self.rate
        ref = jnp.exp(-1j * w * jnp.arange(n))
        tone_p = jnp.abs(jnp.sum(x * ref)) ** 2 / n
        tot_p = jnp.sum(x * x) + 1e-20
        open_ = (tone_p / tot_p >= self.level).astype(jnp.float32)
        return {"open": open_}, x * open_


def ctcss_squelch_ff(rate, freq, level=0.01):
    return CtcssSquelch(rate, freq, level)


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

class ProbeAvgMagSqrd(SinkBlock):
    """probe_avg_mag_sqrd_c/f: IIR-averaged |x|^2 with threshold flag.

    NOTE: the averaging runs on-device over whole chunks; a final partial
    chunk is zero-padded by the host feeder and decays the average. Size
    chunks to divide the stream (TopBlock target_items) for exact parity on
    finite runs; continuous streams are unaffected."""

    def __init__(self, threshold_db: float = 0.0, alpha: float = 0.0001,
                 dtype=C, name=None):
        super().__init__(PortSpec(dtype), name)
        self.threshold = 10.0 ** (threshold_db / 10.0)
        self.alpha = alpha
        self._level = 0.0

    @property
    def tap_port(self):
        return PortSpec(F)

    def init_state(self):
        return {"avg": jnp.zeros((), jnp.float32)}

    def apply(self, state, inputs, n_in):
        p = (jnp.abs(inputs[0]) ** 2).astype(jnp.float32)
        trace, last = first_order_iir(p, self.alpha, 1.0 - self.alpha,
                                      state["avg"])
        return {"avg": last}, (last,)

    def collect(self, value):
        self._level = float(np.asarray(value))

    def level(self) -> float:
        return self._level

    def unmuted(self) -> bool:
        return self._level >= self.threshold


def probe_avg_mag_sqrd_c(threshold_db=0.0, alpha=0.0001):
    return ProbeAvgMagSqrd(threshold_db, alpha, C)


def probe_avg_mag_sqrd_f(threshold_db=0.0, alpha=0.0001):
    return ProbeAvgMagSqrd(threshold_db, alpha, F)


# ---------------------------------------------------------------------------
# modulators / misc
# ---------------------------------------------------------------------------

class FmdetCF(SyncBlock):
    """fmdet_cf: FM discriminator scaled to [-1, 1] over [fl, fh]
    (implemented as the conj-product discriminator with the reference's
    scale = 4 * fm_gain convention — documented substitution for its
    IIR slope detector)."""

    def __init__(self, samplerate: float, freq_low: float, freq_high: float,
                 scl: float = 1.0, name=None):
        super().__init__(PortSpec(C), PortSpec(F), name)
        fm_range = (freq_high - freq_low) / samplerate * math.pi
        self.gain = scl / fm_range if fm_range else scl

    def init_state(self):
        return {"prev": jnp.zeros((), jnp.complex64)}

    def work(self, state, x):
        xm1 = jnp.concatenate([state["prev"][None], x[:-1]])
        d = x * jnp.conj(xm1)
        out = self.gain * jnp.arctan2(d.imag, d.real)
        return {"prev": x[-1]}, out.astype(jnp.float32)


def fmdet_cf(samplerate, freq_low, freq_high, scl=1.0):
    return FmdetCF(samplerate, freq_low, freq_high, scl)


class CpfskBC(Block):
    """cpfsk_bc: continuous-phase FSK (gr-analog/lib/cpfsk_bc_impl.cc):
    per input bit, emit k samples advancing phase by +-k_mod/2 per sample;
    out = amplitude * exp(j phase)."""

    def __init__(self, k: float, ampl: float, samples_per_sym: int,
                 name=None):
        super().__init__(name)
        self.k, self.ampl, self.sps = float(k), float(ampl), int(samples_per_sym)
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(C),)

    @property
    def out_rates(self):
        from fractions import Fraction
        return (Fraction(self.sps),)

    def init_state(self):
        return {"phase": jnp.zeros((), jnp.float32)}

    def apply(self, state, inputs, n_in):
        bits = inputs[0].astype(jnp.float32)
        inc = (2.0 * bits - 1.0) * (math.pi * self.k / (2 * self.sps))
        per_sample = jnp.repeat(inc, self.sps)
        phase = state["phase"] + jnp.cumsum(per_sample)
        out = self.ampl * jnp.exp(1j * phase)
        new_phase = jnp.mod(phase[-1], 2 * math.pi)
        return {"phase": new_phase}, (out.astype(jnp.complex64),)


def cpfsk_bc(k, ampl, samples_per_sym):
    return CpfskBC(k, ampl, samples_per_sym)


class Agc3(SyncBlock):
    """agc3_cc: fast-attack block AGC — gain from the mean magnitude of the
    chunk (the reference's block-average mode), slow IIR tracking after."""

    def __init__(self, attack_rate: float = 0.1, decay_rate: float = 0.01,
                 reference: float = 1.0, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.attack, self.decay, self.reference = attack_rate, decay_rate, reference

    def init_state(self):
        return {"gain": jnp.ones((), jnp.float32)}

    def work(self, state, x):
        mag = jnp.mean(jnp.abs(x))
        target = self.reference / jnp.maximum(mag, 1e-12)
        rate = jnp.where(target < state["gain"], self.attack, self.decay)
        gain = state["gain"] + rate * (target - state["gain"])
        return {"gain": gain}, (x * gain).astype(jnp.complex64)


def agc3_cc(attack_rate=0.1, decay_rate=0.01, reference=1.0):
    return Agc3(attack_rate, decay_rate, reference)


class FeedforwardAgc(SyncBlock):
    """feedforward_agc_cc: gain = reference / max|x| over a look-ahead
    window of nsamples (gr-analog/lib/feedforward_agc_cc_impl.cc)."""

    def __init__(self, nsamples: int, reference: float = 1.0, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.nsamples, self.reference = int(nsamples), float(reference)

    def init_state(self):
        return {"tail": jnp.zeros(self.nsamples - 1, jnp.complex64)}

    def work(self, state, x):
        ext = jnp.concatenate([x, state["tail"]])  # look-AHEAD window
        mags = jnp.abs(ext)
        n = x.shape[0]
        win = jnp.stack([mags[i: i + n] for i in range(self.nsamples)], 0)
        peak = jnp.max(win, axis=0)
        gain = self.reference / jnp.maximum(peak, 1e-12)
        return {"tail": x[-(self.nsamples - 1):]}, (
            x * gain).astype(jnp.complex64)


def feedforward_agc_cc(nsamples, reference=1.0):
    return FeedforwardAgc(nsamples, reference)


class RandomUniformSource(SourceBlock):
    """random_uniform_source_b/s/i: integers in [minimum, maximum)."""

    def __init__(self, minimum: int, maximum: int, seed: int = 0, dtype=B,
                 name=None):
        super().__init__(PortSpec(dtype), name)
        self.minimum, self.maximum, self.seed = minimum, maximum, seed

    def init_state(self):
        return {"key": jax.random.PRNGKey(self.seed)}

    def generate(self, state, n):
        key, sub = jax.random.split(state["key"])
        vals = jax.random.randint(sub, (n,), self.minimum, self.maximum)
        return {"key": key}, vals.astype(self.out_ports[0].dtype)


def random_uniform_source_b(minimum, maximum, seed=0):
    return RandomUniformSource(minimum, maximum, seed, B)


class FastnoiseSource(SourceBlock):
    """fastnoise_source_c/f: samples drawn from a pre-generated random pool
    (gr-analog/lib/fastnoise_source_impl.cc uses a 2^15 pool)."""

    def __init__(self, ampl: float = 1.0, seed: int = 0, dtype=C,
                 pool_size: int = 1 << 15, name=None):
        super().__init__(PortSpec(dtype), name)
        rng = np.random.default_rng(seed)
        if np.dtype(dtype) == np.complex64:
            pool = (rng.standard_normal(pool_size) +
                    1j * rng.standard_normal(pool_size)) * (ampl / np.sqrt(2))
            self.pool = pool.astype(np.complex64)
        else:
            self.pool = (ampl * rng.standard_normal(pool_size)).astype(np.float32)
        self.seed = seed

    def init_state(self):
        return {"key": jax.random.PRNGKey(self.seed + 1)}

    def generate(self, state, n):
        key, sub = jax.random.split(state["key"])
        idx = jax.random.randint(sub, (n,), 0, len(self.pool))
        return {"key": key}, jnp.asarray(self.pool)[idx]


def fastnoise_source_c(ampl=1.0, seed=0):
    return FastnoiseSource(ampl, seed, C)


def fastnoise_source_f(ampl=1.0, seed=0):
    return FastnoiseSource(ampl, seed, F)


class DPLL(SyncBlock):
    """dpll_bb: all-digital PLL bit synchronizer (gr-analog/lib/
    dpll_bb_impl.cc). Input pulses (bytes 0/1) retime onto a steady grid:
    a phase accumulator advances by 1/period per sample, input pulses pull
    the phase by `gain`, output pulse fires when the phase crosses the
    decision threshold (with the reference's 3-pulse restart hold-off).
    Strictly sequential -> lax.scan."""

    def __init__(self, period: float, gain: float, name=None):
        super().__init__(PortSpec(B), PortSpec(B), name)
        self.freq = 1.0 / float(period)
        self.gain = float(gain)
        self.thresh = 1.0 - 0.5 * self.freq

    def init_state(self):
        return {"phase": jnp.float32(0.0), "restart": jnp.int32(0)}

    def work(self, state, x):
        freq, gain, thresh = self.freq, self.gain, self.thresh

        def step(carry, inp):
            phase, restart = carry
            hit = inp == 1
            phase = jnp.where(
                hit,
                jnp.where(restart == 0, jnp.float32(1.0),
                          jnp.where(phase > 0.5,
                                    phase + gain * (1.0 - phase),
                                    phase - gain * phase)),
                phase)
            restart = jnp.where(hit, jnp.int32(3), restart)
            fire = phase > thresh
            out = jnp.where(fire & (restart > 0), jnp.int8(1), jnp.int8(0))
            restart = jnp.where(fire & (restart > 0), restart - 1, restart)
            phase = jnp.where(fire, phase - 1.0, phase) + freq
            return (phase, restart), out

        (ph, rs), y = jax.lax.scan(
            step, (state["phase"], state["restart"]), x.astype(jnp.int32))
        return {"phase": ph, "restart": rs}, y


def dpll_bb(period, gain):
    return DPLL(period, gain)
