"""firdes — windowed-sinc FIR design + window functions (host-side, float64).

Reference parity: gr-filter/lib/firdes.cc and gr-fft/lib/window.cc. Tap design
runs once on the host in numpy float64 (SURVEY.md App. C: "Tap generation can
be done in float64 NumPy/SciPy on host — only the streaming path runs on
the device"); the streaming kernels consume the resulting float32/complex64 taps.

Implemented from the textbook windowed-sinc method the reference uses:
ntaps sized from the window's stopband attenuation A via
ntaps = A / (22 * normalized_transition_width), forced odd
(firdes.cc:37-49 'compute_ntaps'), then w[n] * sinc shifted to band.
"""
from __future__ import annotations

import math

import numpy as np

# Window kinds (gr::fft::window::win_type, include/gnuradio/filter/firdes.h:33-47)
WIN_HAMMING = "hamming"
WIN_HANN = "hann"
WIN_BLACKMAN = "blackman"
WIN_RECTANGULAR = "rectangular"
WIN_KAISER = "kaiser"
WIN_BLACKMAN_HARRIS = "blackman_harris"
WIN_BARTLETT = "bartlett"
WIN_FLATTOP = "flattop"

# Approximate stopband attenuation (dB) per window, used for tap sizing
# (window.cc max_attenuation analog).
_ATTEN = {
    WIN_HAMMING: 53.0,
    WIN_HANN: 44.0,
    WIN_BLACKMAN: 74.0,
    WIN_RECTANGULAR: 21.0,
    WIN_BLACKMAN_HARRIS: 92.0,
    WIN_BARTLETT: 27.0,
    WIN_FLATTOP: 93.0,
}


def window(kind: str, ntaps: int, beta: float = 6.76) -> np.ndarray:
    """Symmetric window of length ntaps (gr-fft/lib/window.cc analog)."""
    n = np.arange(ntaps, dtype=np.float64)
    if ntaps == 1:
        return np.ones(1)
    m = ntaps - 1
    if kind == WIN_RECTANGULAR:
        return np.ones(ntaps)
    if kind == WIN_HAMMING:
        return 0.54 - 0.46 * np.cos(2 * np.pi * n / m)
    if kind == WIN_HANN:
        return 0.5 - 0.5 * np.cos(2 * np.pi * n / m)
    if kind == WIN_BLACKMAN:
        return (0.42 - 0.5 * np.cos(2 * np.pi * n / m)
                + 0.08 * np.cos(4 * np.pi * n / m))
    if kind == WIN_BLACKMAN_HARRIS:
        return (0.35875 - 0.48829 * np.cos(2 * np.pi * n / m)
                + 0.14128 * np.cos(4 * np.pi * n / m)
                - 0.01168 * np.cos(6 * np.pi * n / m))
    if kind == WIN_BARTLETT:
        return 1.0 - np.abs(2 * n / m - 1.0)
    if kind == WIN_FLATTOP:
        # gr uses the 5-term flattop (window.cc)
        a = [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
        w = np.zeros(ntaps)
        for k, ak in enumerate(a):
            w += ((-1) ** k) * ak * np.cos(2 * np.pi * k * n / m)
        return w
    if kind == WIN_KAISER:
        return np.kaiser(ntaps, beta)
    raise ValueError(f"unknown window {kind!r}")


def compute_ntaps(sampling_freq: float, transition_width: float,
                  win: str = WIN_HAMMING, beta: float = 6.76) -> int:
    """firdes.cc compute_ntaps: A/(22*dF), forced odd."""
    if win == WIN_KAISER:
        atten = 22.0  # caller should use *_2 variants for kaiser sizing
    else:
        atten = _ATTEN[win]
    dF = transition_width / sampling_freq
    ntaps = int(atten / (22.0 * dF))
    if (ntaps & 1) == 0:
        ntaps += 1
    return max(ntaps, 3)


def _ntaps_from_atten(sampling_freq, transition_width, attenuation_db):
    dF = transition_width / sampling_freq
    ntaps = int(attenuation_db / (22.0 * dF))
    if (ntaps & 1) == 0:
        ntaps += 1
    return max(ntaps, 3)


def _sinc_lp(gain, fs, fc, ntaps, w):
    """Windowed-sinc low-pass core, normalized to `gain` at DC."""
    m = (ntaps - 1) // 2
    n = np.arange(ntaps) - m
    fwT0 = 2 * np.pi * fc / fs
    den = np.where(n == 0, 1.0, np.pi * n)
    taps = np.where(n == 0, fwT0 / np.pi, np.sin(fwT0 * n) / den) * w
    taps *= gain / np.sum(taps)
    return taps.astype(np.float32)


def low_pass(gain, sampling_freq, cutoff_freq, transition_width,
             win: str = WIN_HAMMING, beta: float = 6.76) -> np.ndarray:
    """firdes::low_pass (firdes.cc low_pass)."""
    ntaps = compute_ntaps(sampling_freq, transition_width, win, beta)
    return _sinc_lp(gain, sampling_freq, cutoff_freq, ntaps, window(win, ntaps, beta))


def low_pass_2(gain, sampling_freq, cutoff_freq, transition_width,
               attenuation_db, win: str = WIN_HAMMING, beta: float = 6.76):
    """firdes::low_pass_2 — ntaps from requested attenuation."""
    ntaps = _ntaps_from_atten(sampling_freq, transition_width, attenuation_db)
    return _sinc_lp(gain, sampling_freq, cutoff_freq, ntaps, window(win, ntaps, beta))


def high_pass(gain, sampling_freq, cutoff_freq, transition_width,
              win: str = WIN_HAMMING, beta: float = 6.76):
    ntaps = compute_ntaps(sampling_freq, transition_width, win, beta)
    m = (ntaps - 1) // 2
    n = np.arange(ntaps) - m
    fwT0 = 2 * np.pi * cutoff_freq / sampling_freq
    w = window(win, ntaps, beta)
    den = np.where(n == 0, 1.0, np.pi * n)
    taps = np.where(n == 0, 1.0 - fwT0 / np.pi, -np.sin(fwT0 * n) / den) * w
    # normalize at Nyquist: gain at fs/2 is sum taps*(-1)^n
    fmax = np.sum(taps * np.cos(np.pi * n))
    taps *= gain / fmax
    return taps.astype(np.float32)


def band_pass(gain, sampling_freq, low_cutoff, high_cutoff, transition_width,
              win: str = WIN_HAMMING, beta: float = 6.76):
    ntaps = compute_ntaps(sampling_freq, transition_width, win, beta)
    m = (ntaps - 1) // 2
    n = np.arange(ntaps) - m
    fwT0 = 2 * np.pi * low_cutoff / sampling_freq
    fwT1 = 2 * np.pi * high_cutoff / sampling_freq
    w = window(win, ntaps, beta)
    den = np.where(n == 0, 1.0, np.pi * n)
    taps = np.where(n == 0, (fwT1 - fwT0) / np.pi,
                    (np.sin(fwT1 * n) - np.sin(fwT0 * n)) / den) * w
    fc = 0.5 * (fwT0 + fwT1)
    fmax = np.sum(taps * np.cos(fc * n))
    taps *= gain / fmax
    return taps.astype(np.float32)


def band_reject(gain, sampling_freq, low_cutoff, high_cutoff,
                transition_width, win=WIN_HAMMING, beta=6.76):
    """Spectral-inversion band reject: delta - band_pass (firdes.cc
    band_reject, same windowed-sinc machinery)."""
    bp = band_pass(1.0, sampling_freq, low_cutoff, high_cutoff,
                   transition_width, win, beta)
    taps = -np.asarray(bp)
    taps[len(taps) // 2] += 1.0
    return (gain * taps).astype(np.float32)


def complex_band_pass(gain, sampling_freq, low_cutoff, high_cutoff,
                      transition_width, win: str = WIN_HAMMING, beta=6.76):
    """Low-pass prototype rotated to the band center (firdes.cc
    complex_band_pass)."""
    ntaps = compute_ntaps(sampling_freq, transition_width, win, beta)
    lp = _sinc_lp(gain, sampling_freq, (high_cutoff - low_cutoff) / 2, ntaps,
                  window(win, ntaps, beta))
    center = 0.5 * (low_cutoff + high_cutoff)
    n = np.arange(ntaps) - (ntaps - 1) // 2
    rot = np.exp(1j * 2 * np.pi * center / sampling_freq * n)
    return (lp * rot).astype(np.complex64)


def root_raised_cosine(gain, sampling_freq, symbol_rate, alpha, ntaps):
    """firdes::root_raised_cosine (firdes.cc) — textbook RRC impulse
    response, sampled at sampling_freq, unity... scaled so sum = gain/sqrt(sps)
    convention-matched to the reference (normalized to gain at DC)."""
    ntaps = int(ntaps) | 1  # force odd
    sps = sampling_freq / symbol_rate
    t = (np.arange(ntaps) - (ntaps - 1) // 2) / sps  # in symbols
    taps = np.zeros(ntaps, dtype=np.float64)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            taps[i] = 1.0 - alpha + 4 * alpha / np.pi
        elif alpha > 0 and abs(abs(4 * alpha * ti) - 1.0) < 1e-9:
            taps[i] = (alpha / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha)))
        else:
            num = (np.sin(np.pi * ti * (1 - alpha))
                   + 4 * alpha * ti * np.cos(np.pi * ti * (1 + alpha)))
            den = np.pi * ti * (1 - (4 * alpha * ti) ** 2)
            taps[i] = num / den
    taps *= gain / np.sum(taps)
    return taps.astype(np.float32)


def gaussian(gain, spb, bt, ntaps):
    """firdes::gaussian — Gaussian pulse for GMSK (firdes.cc gaussian)."""
    ntaps = int(ntaps) | 1
    t = (np.arange(ntaps) - (ntaps - 1) // 2) / spb
    a = np.sqrt(np.log(2.0) / 2.0) / bt
    taps = np.exp(-0.5 * (np.pi * t / a) ** 2)
    taps *= gain / np.sum(taps)
    return taps.astype(np.float32)


def hilbert(ntaps: int, win: str = WIN_RECTANGULAR, beta: float = 6.76):
    """firdes::hilbert — odd-length type-III Hilbert transformer."""
    ntaps = int(ntaps) | 1
    m = (ntaps - 1) // 2
    n = np.arange(ntaps) - m
    w = window(win, ntaps, beta)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(n % 2 != 0, 2.0 / (np.pi * n), 0.0)
    h[m] = 0.0
    h *= w
    # normalize to unity gain at fs/4
    gain_q = np.abs(np.sum(h * np.sin(np.pi / 2 * n)))
    return (h / gain_q).astype(np.float32)
