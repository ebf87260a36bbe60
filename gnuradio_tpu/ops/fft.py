"""gr-fft analog: vector FFT blocks, windows, Goertzel, fft_shift.

Reference parity map (SURVEY.md §2.2 gr-fft row):
  fft_vcc / fft_vfc    -> FftVcc (batched jnp.fft over vlen items — XLA's
                          fused XLA FFT replaces FFTW plans + wisdom cache,
                          gr-fft/lib/fft.cc:78-175; no plan state needed)
  window functions     -> window() (gr-fft/lib/window.cc, window.h)
  goertzel / goertzel_fc -> Goertzel (single-bin DFT evaluated directly —
                          the sequential resonator recurrence
                          (lib/goertzel.cc) is mathematically a dot product
                          with a complex exponential; we compute that dot)
  fft_shift            -> fft_shift block (lib/fft_shift.h)
"""
from __future__ import annotations

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from ..core.block import Block, SyncBlock
from ..core.stream import PortSpec, C, F

# window kinds (gr::fft::window::win_type, gr-fft/include/gnuradio/fft/window.h)
WIN_HAMMING = "hamming"
WIN_HANN = "hann"
WIN_BLACKMAN = "blackman"
WIN_RECTANGULAR = "rectangular"
WIN_KAISER = "kaiser"
WIN_BLACKMAN_HARRIS = "blackman-harris"
WIN_BARTLETT = "bartlett"
WIN_FLATTOP = "flattop"


def window(kind: str, ntaps: int, beta: float = 6.76) -> np.ndarray:
    """Window coefficients (gr-fft/lib/window.cc formulas)."""
    n = np.arange(ntaps)
    M = ntaps - 1
    if kind == WIN_RECTANGULAR:
        w = np.ones(ntaps)
    elif kind == WIN_HAMMING:
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / M)
    elif kind == WIN_HANN:
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / M)
    elif kind == WIN_BLACKMAN:
        w = (0.42 - 0.5 * np.cos(2 * np.pi * n / M)
             + 0.08 * np.cos(4 * np.pi * n / M))
    elif kind == WIN_BLACKMAN_HARRIS:
        w = (0.35875 - 0.48829 * np.cos(2 * np.pi * n / M)
             + 0.14128 * np.cos(4 * np.pi * n / M)
             - 0.01168 * np.cos(6 * np.pi * n / M))
    elif kind == WIN_KAISER:
        w = np.kaiser(ntaps, beta)
    elif kind == WIN_BARTLETT:
        w = np.bartlett(ntaps)
    elif kind == WIN_FLATTOP:
        a = [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
        w = (a[0] - a[1] * np.cos(2 * np.pi * n / M)
             + a[2] * np.cos(4 * np.pi * n / M)
             - a[3] * np.cos(6 * np.pi * n / M)
             + a[4] * np.cos(8 * np.pi * n / M))
    else:
        raise ValueError(f"unknown window {kind!r}")
    return w.astype(np.float64)


class FftVcc(SyncBlock):
    """Vector FFT: vlen-length complex vectors in/out with optional window
    and fftshift (gr-fft/lib/fft_vcc_fftw.cc). Batched over items — one
    XLA FFT call per step."""

    def __init__(self, fft_size: int, forward: bool = True, win=None,
                 shift: bool = False, name=None):
        super().__init__(PortSpec(C, fft_size), PortSpec(C, fft_size), name)
        self.fft_size = int(fft_size)
        self.forward = forward
        self.shift = shift
        self.win = (None if win is None or not len(np.atleast_1d(win))
                    else np.asarray(win, np.float32))  # () = no window
        if self.win is not None and len(self.win) != fft_size:
            raise ValueError("window length != fft_size")

    def work(self, state, x):
        # x: (n, fft_size)
        if self.win is not None:
            x = x * jnp.asarray(self.win)[None, :]
        if self.forward:
            if self.shift:
                # reference applies shift on OUTPUT for forward
                y = jnp.fft.fftshift(jnp.fft.fft(x, axis=1), axes=1)
            else:
                y = jnp.fft.fft(x, axis=1)
        else:
            if self.shift:
                # reference applies shift on INPUT for reverse
                x = jnp.fft.ifftshift(x, axes=1)
            # reference reverse FFT is unnormalized (FFTW): scale by N
            y = jnp.fft.ifft(x, axis=1) * self.fft_size
        return state, y.astype(C)


def fft_vcc(fft_size, forward=True, window=None, shift=False, nthreads=1):
    return FftVcc(fft_size, forward, window, shift)


class FftVfc(Block):
    """Real-vector in, complex-vector out forward FFT (fft_vfc)."""

    def __init__(self, fft_size: int, forward: bool = True, win=None, name=None):
        super().__init__(name)
        if not forward:
            raise ValueError("fft_vfc is forward-only in the reference")
        self.in_ports = (PortSpec(F, fft_size),)
        self.out_ports = (PortSpec(C, fft_size),)
        self.fft_size = int(fft_size)
        self.win = None if win is None else np.asarray(win, np.float32)

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        if self.win is not None:
            x = x * jnp.asarray(self.win)[None, :]
        return state, (jnp.fft.fft(x.astype(C), axis=1).astype(C),)


def fft_vfc(fft_size, forward=True, window=None, nthreads=1):
    return FftVfc(fft_size, forward, window)


class FftShift(SyncBlock):
    """fft_shift over vector items (gr-fft fft_shift.h)."""

    def __init__(self, fft_size: int, name=None):
        super().__init__(PortSpec(C, fft_size), PortSpec(C, fft_size), name)

    def work(self, state, x):
        return state, jnp.fft.fftshift(x, axes=1)


class Goertzel(Block):
    """goertzel_fc: single-bin DFT over length-N batches
    (gr-fft/lib/goertzel.cc). The reference's order-2 resonator recurrence is
    algebraically the dot product y = sum_n x[n] e^{-j 2 pi k n / N} (up to
    the reference's final-state phase convention); we evaluate the dot
    directly — one (T, N) x (N,) matvec per step."""

    def __init__(self, rate: int, freq: float, batch_len: int | None = None,
                 in_complex=False, name=None):
        super().__init__(name)
        self.N = int(batch_len if batch_len is not None else rate)
        self.rate = int(rate)
        self.freq = float(freq)
        self.in_ports = (PortSpec(C if in_complex else F),)
        self.out_ports = (PortSpec(C),)
        k = round(self.N * freq / rate)
        n = np.arange(self.N)
        self.coef = np.exp(-2j * np.pi * k * n / self.N).astype(np.complex64)

    @property
    def in_rates(self):
        return (Fraction(self.N),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        T = x.shape[0] // self.N
        xb = x[: T * self.N].reshape(T, self.N)
        y = xb.astype(C) @ jnp.asarray(self.coef)
        return state, (y.astype(C),)


def goertzel_fc(rate, freq, batch_len=None):
    return Goertzel(rate, freq, batch_len, in_complex=False)
