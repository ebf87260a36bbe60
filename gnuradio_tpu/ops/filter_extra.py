"""gr-filter catalog fills: filter_delay_fc, ival_decimator,
freq_xlating_fft_filter, filterbank_vcvcf.

Reference parity:
  filter_delay_fc        gr-filter/lib/filter_delay_fc_impl.cc — float in,
                         complex out; re = input delayed (ntaps-1)/2, im =
                         FIR(taps) of input (classic Hilbert pairing).
  ival_decimator         gr-filter/include/gnuradio/filter/ival_decimator.h —
                         keep every Dth item of interleaved short data.
  freq_xlating_fft_filter gr-filter/python/filter/freq_xlating_fft_filter.py —
                         rotate prototype taps up to the band, fast-convolve,
                         then derotate output at the decimated rate.
  filterbank_vcvcf       gr-filter/lib/filterbank_vcvcf_impl.cc +
                         lib/filterbank.cc — one FIR per vector element,
                         applied across the vector stream.

Design notes: the filterbank is a batched banded-Toeplitz matmul — the
per-arm FIRs stack into a (nfilts, ntaps) tap matrix and all arms run as one
matmul contraction; freq_xlating_fft_filter reuses the batched overlap-save
machinery of FftFilter with rotated taps and an int32 fixed-point NCO
derotator (drift-free, replacing the reference rotator's 512-sample
renormalization).
"""
from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block
from ..core.stream import PortSpec, S, F, C
from . import fxpt
from .filter import FftFilter
from ..kernels.fir_xla import fir_apply


class FilterDelay(Block):
    """filter_delay_fc: 1 float in -> complex out (re = delayed input, im =
    FIR of input). With two inputs: re = delayed in0, im = FIR(in1)."""

    def __init__(self, taps, two_inputs: bool = False, name=None):
        super().__init__(name)
        self.taps = np.asarray(taps, dtype=np.float32)
        self.ntaps = len(self.taps)
        self.delay = (self.ntaps - 1) // 2
        self.two = bool(two_inputs)
        self.in_ports = tuple(PortSpec(F) for _ in range(2 if two_inputs else 1))
        self.out_ports = (PortSpec(C),)

    def init_state(self):
        return {
            "tail0": jnp.zeros(self.ntaps - 1, jnp.float32),
            "tail1": jnp.zeros(self.ntaps - 1, jnp.float32),
        }

    def apply(self, state, inputs, n_in):
        x0 = inputs[0]
        x1 = inputs[1] if self.two else x0
        p0 = jnp.concatenate([state["tail0"], x0])
        p1 = jnp.concatenate([state["tail1"], x1])
        n = x0.shape[0]
        # delayed real path: group delay of the (odd-length) FIR
        a = self.ntaps - 1 - self.delay
        re = p0[a:a + n]
        im = fir_apply(p1, jnp.asarray(self.taps), 1)
        st = {"tail0": p0[n:], "tail1": p1[n:]}
        return st, (jax.lax.complex(re, im),)


def filter_delay_fc(taps):
    return FilterDelay(taps, two_inputs=False)


class IvalDecimator(Block):
    """ival_decimator: keep every Dth pair of an interleaved I/Q byte or
    short stream (flat stream of pairs, as the reference block's plain
    char/short ports; decimation without filtering)."""

    def __init__(self, decimation: int, dtype=S, name=None):
        super().__init__(name)
        self.decim = int(decimation)
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)

    @property
    def in_rates(self):
        return (Fraction(2 * self.decim),)

    @property
    def out_rates(self):
        return (Fraction(2),)

    def apply(self, state, inputs, n_in):
        pairs = inputs[0].reshape(-1, 2 * self.decim)
        return state, (pairs[:, :2].reshape(-1),)


def ival_decimator(decimation, dtype=S):
    return IvalDecimator(decimation, dtype)


class FreqXlatingFftFilter(Block):
    """freq_xlating_fft_filter_ccc: overlap-save fast convolution with taps
    rotated to `center_freq`, output derotated at the decimated rate."""

    def __init__(self, decim: int, taps, center_freq: float,
                 samp_rate: float, name=None):
        super().__init__(name)
        base = np.asarray(taps)
        n = np.arange(len(base))
        w = 2 * np.pi * center_freq / samp_rate
        rtaps = (base * np.exp(1j * w * n)).astype(np.complex64)
        self._ff = FftFilter(decim, rtaps, in_complex=True)
        self.decim = int(decim)
        self._delta = fxpt.float_to_fxpt(-w * self.decim)
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(C),)
        self.ntaps = len(base)

    @property
    def in_rates(self):
        return (Fraction(self.decim),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def init_state(self):
        return {"ff": self._ff.init_state(),
                "phase": jnp.zeros((), jnp.int32)}

    def apply(self, state, inputs, n_in):
        ff_st, (y,) = self._ff.apply(state["ff"], inputs, n_in)
        rot, nxt = fxpt.nco_sincos(state["phase"], jnp.int32(self._delta),
                                   y.shape[0])
        return ({"ff": ff_st, "phase": nxt},
                ((y * rot).astype(jnp.complex64),))


def freq_xlating_fft_filter_ccc(decim, taps, center_freq, samp_rate):
    return FreqXlatingFftFilter(decim, taps, center_freq, samp_rate)


class FilterbankVcvcf(Block):
    """filterbank_vcvcf: vector-in/vector-out bank of independent FIRs, one
    per vector element. All arms evaluate as ONE batched windowed matmul on
    one matmul: (nfilts, ntaps) taps against per-arm sliding windows."""

    def __init__(self, taps_list, name=None):
        super().__init__(name)
        self.nfilts = len(taps_list)
        self.ntaps = max(len(t) for t in taps_list)
        T = np.zeros((self.nfilts, self.ntaps), dtype=np.float32)
        for i, t in enumerate(taps_list):
            T[i, : len(t)] = np.asarray(t, dtype=np.float32)
        self.T = T
        self.in_ports = (PortSpec(C, self.nfilts),)
        self.out_ports = (PortSpec(C, self.nfilts),)

    def init_state(self):
        return jnp.zeros((self.ntaps - 1, self.nfilts), jnp.complex64)

    def apply(self, state, inputs, n_in):
        x = inputs[0]  # (n, nfilts) — each column is an arm's stream
        n = x.shape[0]
        xp = jnp.concatenate([state, x], axis=0)  # (n+ntaps-1, nfilts)
        tail = xp[xp.shape[0] - (self.ntaps - 1):] if self.ntaps > 1 else state
        # windows[k, j, a] = xp[k + j, a]; y[k, a] = sum_j T[a, j'] xp[k + ntaps-1-j', a]
        idx = jnp.arange(n)[:, None] + jnp.arange(self.ntaps)[None, :]
        win = xp[idx]  # (n, ntaps, nfilts)
        Trev = jnp.asarray(self.T[:, ::-1].T)  # (ntaps, nfilts)
        y = jnp.einsum("nta,ta->na", win, Trev.astype(jnp.complex64))
        return tail, (y.astype(jnp.complex64),)


def filterbank_vcvcf(taps_list):
    return FilterbankVcvcf(taps_list)
