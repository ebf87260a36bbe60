"""Continuous-phase modulation: phase responses + cpmmod/gmskmod hiers.

Reference behavior (reimplemented, NOT copied):
  gr-analog/lib/cpm.cc — phase_response(type, sps, L, beta) tap generators:
      LREC (rect 1/(L*sps)), LRC (raised cosine), LSRC (spectral raised
      cosine main lobe, de-l'Hopital handling at |k| = Ls/(4 beta)), TFM
      (Anderson/Aulin/Sundberg ch. 2.7.2 g0 sum), GAUSSIAN (erf-difference,
      alpha = sqrt(2/ln2) pi BT).
  gr-digital/lib/cpmmod_bc_impl.cc — hier: char->float ->
      interp_fir(sps, phase taps) -> frequency_modulator(pi*h).
  gr-digital/python/digital/gmsk.py — GMSK = GAUSSIAN CPM with h=0.5.

Tap design is float64 host NumPy (SURVEY.md App. C); only the streaming
interp-FIR + phase integrator run on device.
"""
from __future__ import annotations

import math

import numpy as np
from scipy.special import erf

LRC = "lrc"
LSRC = "lsrc"
LREC = "lrec"
TFM = "tfm"
GAUSSIAN = "gaussian"


def _sinc(x):
    return np.sinc(x)  # normalized sinc


def generate_cpm_lrec_taps(sps: int, L: int) -> np.ndarray:
    return np.full(sps * L, 1.0 / (L * sps))


def generate_cpm_lrc_taps(sps: int, L: int) -> np.ndarray:
    i = np.arange(sps * L)
    return (1.0 / (L * sps)) * (1 - np.cos(2 * np.pi * i / (L * sps)))


def generate_cpm_lsrc_taps(sps: int, L: int, beta: float) -> np.ndarray:
    Ls = float(L * sps)
    k = np.arange(sps * L) - Ls / 2
    taps = _sinc(2.0 * k / Ls) / Ls
    tmp = 4.0 * beta * k / Ls
    with np.errstate(divide="ignore", invalid="ignore"):
        roll = np.cos(beta * 2.0 * np.pi * k / Ls) / (1 - tmp * tmp)
    # rolloff term converges to pi/4 where the denominator vanishes
    sing = np.isclose(np.abs(np.abs(k) - Ls / (4 * beta)), 0.0, atol=1e-12)
    roll = np.where(sing | ~np.isfinite(roll), np.pi / 4, roll)
    taps = taps * roll
    return taps / taps.sum()


def _tfm_g0(k: np.ndarray, sps: float) -> np.ndarray:
    f = np.pi * k / sps
    pi2_24 = np.pi ** 2 / 24
    with np.errstate(divide="ignore", invalid="ignore"):
        g = _sinc(k / sps) - pi2_24 * (
            2 * np.sin(f) - 2 * f * np.cos(f) - f * f * np.sin(f)) / f ** 3
    return np.where(np.abs(k) < 1e-12, 1.0 + np.pi ** 2 / 48 / np.sqrt(2), g)


def generate_cpm_tfm_taps(sps: int, L: int) -> np.ndarray:
    k = np.arange(sps * L) - (sps * L // 2)
    taps = (_tfm_g0(k - sps, sps) + 2 * _tfm_g0(k, sps)
            + _tfm_g0(k + sps, sps))
    return taps / taps.sum()


def generate_cpm_gaussian_taps(sps: int, L: int, bt: float) -> np.ndarray:
    Ls = float(L * sps)
    k = np.arange(sps * L) - Ls / 2
    alpha = math.sqrt(2.0 / math.log(2.0)) * math.pi * bt
    return (erf(alpha * (k / sps + 0.5)) -
            erf(alpha * (k / sps - 0.5))) * 0.5 / sps


def phase_response(cpm_type: str, samples_per_sym: int, L: int,
                   beta: float = 0.3) -> np.ndarray:
    """gr::analog::cpm::phase_response analog (float64)."""
    if cpm_type == LRC:
        return generate_cpm_lrc_taps(samples_per_sym, L)
    if cpm_type == LSRC:
        return generate_cpm_lsrc_taps(samples_per_sym, L, beta)
    if cpm_type == LREC:
        return generate_cpm_lrec_taps(samples_per_sym, L)
    if cpm_type == TFM:
        return generate_cpm_tfm_taps(samples_per_sym, L)
    if cpm_type == GAUSSIAN:
        return generate_cpm_gaussian_taps(samples_per_sym, L, beta)
    raise ValueError(f"unknown CPM type {cpm_type}")


def cpmmod_bc(cpm_type: str, h: float, samples_per_sym: int, L: int,
              beta: float = 0.3):
    """cpmmod hier analog: returns the (pulse_shaper, fm) block pair the
    caller wires up: interp_fir(sps, phase taps) -> freq_mod(pi*h).
    (cpmmod_bc_impl.cc:47-50)."""
    from .filter import interp_fir_filter_fff
    from .analog import frequency_modulator_fc
    taps = phase_response(cpm_type, samples_per_sym, L, beta)
    shaper = interp_fir_filter_fff(samples_per_sym,
                                   taps.astype(np.float32))
    fm = frequency_modulator_fc(np.pi * float(h))
    return shaper, fm


def gmskmod_bc(samples_per_sym: int = 2, L: int = 4, beta: float = 0.3):
    """GMSK = Gaussian CPM, h = 0.5 (gmsk.py / cpmmod)."""
    return cpmmod_bc(GAUSSIAN, 0.5, samples_per_sym, L, beta)


def cpm_modulate(symbols: np.ndarray, cpm_type: str, h: float,
                 samples_per_sym: int, L: int, beta: float = 0.3):
    """One-shot functional modulator for QA: bipolar symbols -> complex
    baseband. Zero-padded interpolating FIR + exact phase integration."""
    taps = phase_response(cpm_type, samples_per_sym, L, beta)
    up = np.zeros(len(symbols) * samples_per_sym)
    up[::samples_per_sym] = np.asarray(symbols, np.float64)
    freq = np.convolve(up, taps)[:len(up)]
    phase = np.pi * h * np.cumsum(freq)
    return np.exp(1j * phase).astype(np.complex64)
