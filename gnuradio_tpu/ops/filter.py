"""gr-filter analog: FIR, freq-xlating FIR, overlap-save FFT filter, IIR,
interpolating/rational resampling, DC blocker, Hilbert.

Reference parity map (SURVEY.md §2.2 gr-filter row):
  fir_filter_blk (all dtype combos)   -> FirFilter (one banded matmul)
  freq_xlating_fir_filter             -> FreqXlatingFirFilter (composite taps
                                         + fxpt rotator; lib/freq_xlating_*)
  fft_filter_ccc/fff (overlap-save,   -> FftFilter (batched FFT frames,
    lib/fft_filter.cc:72-150)            fftsize = 2*2^ceil(log2 ntaps))
  iir_filter / single_pole_iir        -> IirFilter (associative-scan order 1,
                                         lax.scan fallback for higher order)
  interp_fir_filter / rational_resampler -> polyphase arm decomposition as a
                                         single batched conv
  dc_blocker_cc/ff                    -> DCBlocker
  hilbert_fc                          -> via firdes.hilbert + FirFilter

History semantics: every filter carries its own (ntaps-1)-item tail,
zero-initialized — identical to the reference scheduler's history() contract
(gnuradio-runtime/include/gnuradio/block.h:82-91), so outputs are chunk-size
invariant and match the reference from sample 0.
"""
from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, DecimBlock, InterpBlock, SyncBlock
from ..core.stream import PortSpec, C, F
from ..kernels.fir_xla import fir_apply, fir_apply_batched
from . import fxpt
from .iir_core import biquad_like_first_order, first_order_iir, iir_df1_scan


def _port_for(x_complex: bool, vlen=1):
    return PortSpec(C if x_complex else F, vlen)


class FirFilter(Block):
    """FIR filter with optional decimation (fir_filter_blk analog,
    gr-filter/lib/fir_filter_blk_impl.cc + fir_filter.cc:129-182)."""

    def __init__(self, decimation: int, taps, in_complex=True, out_complex=None,
                 name=None):
        super().__init__(name)
        self.decim = int(decimation)
        self.taps = np.asarray(taps)
        t_complex = np.iscomplexobj(self.taps)
        self.taps = self.taps.astype(np.complex64 if t_complex else np.float32)
        if out_complex is None:
            out_complex = in_complex or t_complex
        self.in_ports = (_port_for(in_complex),)
        self.out_ports = (_port_for(out_complex),)
        self.ntaps = len(self.taps)

    @property
    def in_rates(self):
        return (Fraction(self.decim),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def init_state(self):
        return self.in_ports[0].zeros(self.ntaps - 1)

    def set_taps(self, taps):
        self.taps = np.asarray(taps, dtype=self.taps.dtype)
        self.ntaps = len(self.taps)

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        xp = jnp.concatenate([state, x], axis=0)
        tail = xp[xp.shape[0] - (self.ntaps - 1):] if self.ntaps > 1 else state
        y = fir_apply(xp, jnp.asarray(self.taps), self.decim)
        return tail, (y.astype(self.out_ports[0].dtype),)


def fir_filter_ccf(decimation, taps):
    return FirFilter(decimation, np.real(taps), in_complex=True)


def fir_filter_ccc(decimation, taps):
    return FirFilter(decimation, np.asarray(taps, np.complex64), in_complex=True)


def fir_filter_fff(decimation, taps):
    return FirFilter(decimation, np.real(taps), in_complex=False)


def fir_filter_fcc(decimation, taps):
    return FirFilter(decimation, np.asarray(taps, np.complex64), in_complex=False)


class FreqXlatingFirFilter(Block):
    """Band-select + mix to baseband + decimate in one op
    (gr-filter freq_xlating_fir_filter: composite taps rotated to the band,
    then an output-rate phasor rotator; lib/freq_xlating_fir_filter_impl.cc).

    y[k] = e^{-j w (n0 + kD)} * sum_j taps[j] e^{+j w j} x[n0+kD-j],
    w = 2*pi*center_freq/samp_rate. The rotator phase uses the int32
    fixed-point accumulator (fxpt.py) so it never drifts — replacing the
    reference rotator's every-512-samples renormalization
    (gr-blocks/include/gnuradio/blocks/rotator.h:30-43).
    """

    def __init__(self, decimation: int, taps, center_freq: float,
                 sampling_freq: float, in_complex=True, name=None):
        super().__init__(name)
        self.decim = int(decimation)
        base = np.asarray(taps)
        n = np.arange(len(base))
        w = 2 * np.pi * center_freq / sampling_freq
        self.ctaps = (base * np.exp(1j * w * n)).astype(np.complex64)
        self.center_freq = float(center_freq)
        self.sampling_freq = float(sampling_freq)
        # per-output-sample phase decrement (decim input samples per output)
        self._delta = fxpt.float_to_fxpt(-w * self.decim)
        self.in_ports = (_port_for(in_complex),)
        self.out_ports = (PortSpec(C),)
        self.ntaps = len(base)

    @property
    def in_rates(self):
        return (Fraction(self.decim),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def init_state(self):
        return {
            "tail": self.in_ports[0].zeros(self.ntaps - 1),
            "phase": jnp.zeros((), jnp.int32),
        }

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        xp = jnp.concatenate([state["tail"], x], axis=0)
        tail = xp[xp.shape[0] - (self.ntaps - 1):] if self.ntaps > 1 else state["tail"]
        y = fir_apply(xp, jnp.asarray(self.ctaps), self.decim)
        rot, nxt = fxpt.nco_sincos(state["phase"], jnp.int32(self._delta), y.shape[0])
        return {"tail": tail, "phase": nxt}, ((y * rot).astype(jnp.complex64),)


def freq_xlating_fir_filter_ccf(decim, taps, center_freq, sampling_freq):
    return FreqXlatingFirFilter(decim, np.real(taps), center_freq, sampling_freq, True)


def freq_xlating_fir_filter_ccc(decim, taps, center_freq, sampling_freq):
    return FreqXlatingFirFilter(decim, np.asarray(taps, np.complex64),
                                center_freq, sampling_freq, True)


def freq_xlating_fir_filter_fcc(decim, taps, center_freq, sampling_freq):
    return FreqXlatingFirFilter(decim, np.real(taps), center_freq, sampling_freq, False)


class FftFilter(Block):
    """Overlap-save fast-convolution filter (gr::filter::kernel::fft_filter,
    gr-filter/lib/fft_filter.cc:72-150): fftsize = 2*2^ceil(log2(ntaps)),
    nsamples = fftsize - ntaps + 1 per frame; frames batched into one FFT so
    the whole filter is two batched FFTs + one elementwise multiply."""

    def __init__(self, decimation: int, taps, in_complex=True, nthreads=1,
                 name=None):
        super().__init__(name)
        self.decim = int(decimation)
        taps = np.asarray(taps)
        self.t_complex = np.iscomplexobj(taps)
        self.taps = taps.astype(np.complex64 if self.t_complex else np.float32)
        self.ntaps = len(taps)
        self.fftsize = int(2 * 2 ** math.ceil(math.log2(max(self.ntaps, 2))))
        self.nsamples = self.fftsize - self.ntaps + 1
        H = np.fft.fft(self.taps.astype(np.complex128), self.fftsize)
        self.H = H.astype(np.complex64)
        self.in_complex = in_complex
        out_complex = in_complex or self.t_complex
        self.in_ports = (_port_for(in_complex),)
        self.out_ports = (_port_for(out_complex),)

    @property
    def in_rates(self):
        return (Fraction(self.decim),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def init_state(self):
        return self.in_ports[0].zeros(self.ntaps - 1)

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        n = x.shape[0]
        xp = jnp.concatenate([state, x], axis=0)
        tail = xp[xp.shape[0] - (self.ntaps - 1):] if self.ntaps > 1 else state
        ns, fs = self.nsamples, self.fftsize
        nframes = -(-n // ns)
        pad = nframes * ns + (self.ntaps - 1) - xp.shape[0]
        if pad > 0:
            xp = jnp.concatenate([xp, jnp.zeros((pad,), xp.dtype)], axis=0)
        idx = (jnp.arange(nframes)[:, None] * ns + jnp.arange(fs)[None, :])
        frames = xp[idx]  # (nframes, fftsize)
        Y = jnp.fft.fft(frames.astype(jnp.complex64), axis=1) * jnp.asarray(self.H)
        y = jnp.fft.ifft(Y, axis=1)[:, self.ntaps - 1:]  # valid part
        y = y.reshape(-1)[:n]
        if not (self.in_complex or self.t_complex):
            y = y.real
        if self.decim > 1:
            y = y[:: self.decim]
        return tail, (y.astype(self.out_ports[0].dtype),)


def fft_filter_ccc(decimation, taps, nthreads=1):
    return FftFilter(decimation, np.asarray(taps, np.complex64), True)


def fft_filter_ccf(decimation, taps, nthreads=1):
    return FftFilter(decimation, np.real(taps), True)


def fft_filter_fff(decimation, taps, nthreads=1):
    return FftFilter(decimation, np.real(taps), False)


class IirFilter(SyncBlock):
    """Direct-form-I IIR (gr::filter::kernel::iir_filter,
    gr-filter/include/gnuradio/filter/iir_filter.h:75-160).

    Conventions (exactly the reference's): with oldstyle=False the taps are
    scipy/Matlab style, y[n] + sum_{k>=1} a_k y[n-k] = sum_k b_k x[n-k], and
    the implementation negates a[1:] into internal add-form feedback taps
    (iir_filter.h:148-160). With oldstyle=True (GR default) the user taps
    are ALREADY add-form: y[n] = sum ff x[n-k] + sum_{k>=1} fb[k] y[n-k].
    fbtaps[0] is ignored either way.

    Order-1 denominators evaluate via the parallel associative scan
    (iir_core.py); higher orders fall back to lax.scan.
    """

    def __init__(self, fftaps, fbtaps, oldstyle=True, in_complex=False, name=None):
        super().__init__(_port_for(in_complex), _port_for(in_complex), name)
        self.ff = np.asarray(fftaps, np.float64)
        self.fb = np.asarray(fbtaps, np.float64)
        # internal ADD-convention feedback taps (y += fb_int[k] * y[n-k])
        self.fb_int = self.fb.copy()
        if not oldstyle:
            self.fb_int[1:] = -self.fb_int[1:]
        self.in_complex = in_complex
        # First-order stable recurrences with a short truncated impulse
        # response run as ONE FIR matmul instead of the log-depth
        # associative scan (exact to <1e-9 —
        # iir_core.first_order_fir_taps).
        # State then carries T-1 input samples instead of y[-1].
        self._fir_taps = None
        if (len(self.ff) - 1 <= 1 and len(self.fb_int) - 1 == 1
                and np.isrealobj(self.ff) and np.isrealobj(self.fb_int)
                and abs(self.fb_int[1]) < 1.0
                and self.in_ports[0].vlen == 1):
            from ..ops.iir_core import first_order_fir_taps
            t = first_order_fir_taps(
                self.ff[0], self.ff[1] if len(self.ff) > 1 else 0.0,
                self.fb_int[1])
            if len(t) <= 2048:
                self._fir_taps = t

    def init_state(self):
        M = len(self.ff) - 1
        N = len(self.fb_int) - 1
        z = self.in_ports[0]
        if self._fir_taps is not None:
            return {"x": z.zeros(len(self._fir_taps) - 1)}
        return {"x": z.zeros(M), "y": z.zeros(N)}

    def work(self, state, x):
        M = len(self.ff) - 1
        N = len(self.fb_int) - 1
        dt = x.dtype
        if self._fir_taps is not None:
            # vlen==1 is a precondition of the fast path (checked at
            # construction), so x is 1-D here; assert rather than fall
            # through to the recurrence branches, whose state pytree
            # ({'x','y'}) is different from this branch's ({'x'}).
            assert x.ndim == 1, "first-order IIR FIR path expects 1-D input"
            from ..kernels.fir_xla import fir_apply
            T = len(self._fir_taps)
            xp = jnp.concatenate([state["x"], x])
            y = fir_apply(xp, jnp.asarray(self._fir_taps), 1)
            return {"x": xp[xp.shape[0] - (T - 1):]}, y.astype(dt)
        if M <= 1 and N == 1:
            b0 = jnp.asarray(self.ff[0], jnp.float32)
            b1 = jnp.asarray(self.ff[1] if M else 0.0, jnp.float32)
            r = jnp.asarray(self.fb_int[1], jnp.float32)  # add-form feedback
            y0 = state["y"][0] if N else jnp.zeros((), dt)
            xm1 = state["x"][0] if M else jnp.zeros((), dt)
            y, ylast, xlast = biquad_like_first_order(x, b0, b1, r, y0, xm1)
            st = {"x": jnp.reshape(xlast, (1,)) if M else state["x"],
                  "y": jnp.reshape(ylast, (1,))}
            return st, y.astype(dt)
        y, zx, zy = iir_df1_scan(x, self.ff.astype(np.float32),
                                 self.fb_int.astype(np.float32),
                                 state["x"][::-1] if M else state["x"],
                                 state["y"][::-1] if N else state["y"])
        return {"x": zx[::-1] if M else state["x"],
                "y": zy[::-1] if N else state["y"]}, y.astype(dt)


def iir_filter_ffd(fftaps, fbtaps, oldstyle=True):
    return IirFilter(fftaps, fbtaps, oldstyle, in_complex=False)


def iir_filter_ccf(fftaps, fbtaps, oldstyle=True):
    return IirFilter(fftaps, fbtaps, oldstyle, in_complex=True)


class SinglePoleIir(SyncBlock):
    """single_pole_iir_filter_ff/cc: y[n] = alpha*x[n] + (1-alpha)*y[n-1]."""

    def __init__(self, alpha: float, in_complex=False, name=None):
        super().__init__(_port_for(in_complex), _port_for(in_complex), name)
        self.alpha = float(alpha)

    def init_state(self):
        return jnp.zeros((), self.in_ports[0].dtype)

    def work(self, state, x):
        y, last = first_order_iir(x, jnp.asarray(self.alpha, jnp.float32),
                                  jnp.asarray(1 - self.alpha, jnp.float32), state)
        return last, y.astype(x.dtype)


def single_pole_iir_filter_ff(alpha):
    return SinglePoleIir(alpha, in_complex=False)


def single_pole_iir_filter_cc(alpha):
    return SinglePoleIir(alpha, in_complex=True)


class DCBlocker(SyncBlock):
    """dc_blocker_cc/ff (gr-filter/lib/dc_blocker_*_impl.cc): cascade of two
    length-D moving averages with a delayed feedforward path (long form) —
    implemented here exactly in its transfer-function form: y = delay(x, D-1)
    - ma2(x), where ma2 is the twice-applied length-D moving average."""

    def __init__(self, D: int = 32, long_form: bool = True, in_complex=True,
                 name=None):
        super().__init__(_port_for(in_complex), _port_for(in_complex), name)
        self.D = int(D)
        self.long_form = long_form

    def init_state(self):
        # carry enough input history for the composite FIR response
        L = 2 * self.D - 1 if self.long_form else self.D
        return self.in_ports[0].zeros(L)

    def work(self, state, x):
        D = self.D
        xp = jnp.concatenate([state, x], axis=0)
        tail = xp[xp.shape[0] - state.shape[0]:]
        if self.long_form:
            # h = delta(D-1) - (ma_D * ma_D)/D^2 ; build taps once
            ma = np.ones(D) / D
            h = -np.convolve(ma, ma)
            h[D - 1] += 1.0
        else:
            h = -np.ones(D) / D
            h[D - 1] += 1.0
        y = fir_apply(xp, jnp.asarray(h[::-1].copy(), jnp.float32), 1)
        return tail, y.astype(x.dtype)


def dc_blocker_cc(D=32, long_form=True):
    return DCBlocker(D, long_form, True)


def dc_blocker_ff(D=32, long_form=True):
    return DCBlocker(D, long_form, False)


class InterpFirFilter(InterpBlock):
    """interp_fir_filter: polyphase 1:L interpolation
    (gr-filter/lib/interp_fir_filter_impl.cc). Taps designed at L*fs are
    split into L arms; each arm is a sync FIR over the input; outputs are
    interleaved. All arms run as ONE batched conv."""

    def __init__(self, interp: int, taps, in_complex=True, name=None):
        taps = np.asarray(taps)
        t_complex = np.iscomplexobj(taps)
        ip = _port_for(in_complex)
        op = _port_for(in_complex or t_complex)
        super().__init__(interp, ip, op, name)
        L = self.interp
        alen = -(-len(taps) // L)
        padded = np.zeros(alen * L, dtype=taps.dtype)
        padded[: len(taps)] = taps
        # arm p holds taps[p], taps[p+L], ... ; y[nL+p] = sum_m arm_p[m] x[n-m]
        self.arms = padded.reshape(alen, L).T.astype(
            np.complex64 if t_complex else np.float32)  # (L, alen)
        self.alen = alen

    def init_state(self):
        return self.in_ports[0].zeros(self.alen - 1)

    def work(self, state, x):
        xp = jnp.concatenate([state, x], axis=0)
        tail = xp[xp.shape[0] - (self.alen - 1):] if self.alen > 1 else state
        xb = jnp.broadcast_to(xp, (self.interp,) + xp.shape)
        ys = fir_apply_batched(xb, jnp.asarray(self.arms), 1)  # (L, n)
        y = ys.T.reshape(-1)
        return tail, y.astype(self.out_ports[0].dtype)


def interp_fir_filter_ccf(interp, taps):
    return InterpFirFilter(interp, np.real(taps), True)


def interp_fir_filter_fff(interp, taps):
    return InterpFirFilter(interp, np.real(taps), False)


def interp_fir_filter_ccc(interp, taps):
    return InterpFirFilter(interp, np.asarray(taps, np.complex64), True)


class RationalResampler(Block):
    """rational_resampler_base: polyphase L/M resampling
    (gr-filter/lib/rational_resampler.cc). Output i sits at upsampled index
    i*M: arm p = (i*M) mod L, input index n = (i*M) div L. We compute all L
    arms at input rate (one batched conv) then gather the needed (arm, n)
    pairs — exact, static-shape."""

    def __init__(self, interp: int, decim: int, taps=None, in_complex=True,
                 name=None):
        super().__init__(name)
        g = math.gcd(int(interp), int(decim))
        self.L = int(interp) // g
        self.M = int(decim) // g
        if taps is None or (isinstance(taps, (list, tuple))
                            and len(taps) == 0):
            # default design like the reference's rational_resampler.py
            # wrapper (design_filter): anti-alias LPF at min(1/L, 1/M)
            from .firdes import low_pass, WIN_KAISER
            fc = 0.4 / max(self.L, self.M)
            tw = 0.2 / max(self.L, self.M)
            taps = low_pass(self.L, 1.0, fc, tw, WIN_KAISER)
        taps = np.asarray(taps)
        t_complex = np.iscomplexobj(taps)
        self.in_ports = (_port_for(in_complex),)
        self.out_ports = (_port_for(in_complex or t_complex),)
        alen = -(-len(taps) // self.L)
        padded = np.zeros(alen * self.L, dtype=taps.dtype)
        padded[: len(taps)] = taps
        self.arms = padded.reshape(alen, self.L).T.astype(
            np.complex64 if t_complex else np.float32)
        self.alen = alen

    @property
    def in_rates(self):
        return (Fraction(self.M),)

    @property
    def out_rates(self):
        return (Fraction(self.L),)

    def init_state(self):
        return self.in_ports[0].zeros(self.alen - 1)

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        n = x.shape[0]
        n_out = n * self.L // self.M
        xp = jnp.concatenate([state, x], axis=0)
        tail = xp[xp.shape[0] - (self.alen - 1):] if self.alen > 1 else state
        xb = jnp.broadcast_to(xp, (self.L,) + xp.shape)
        ys = fir_apply_batched(xb, jnp.asarray(self.arms), 1)  # (L, n)
        i = jnp.arange(n_out)
        up = i * self.M
        arm = up % self.L
        idx = up // self.L
        y = ys[arm, idx]
        return tail, (y.astype(self.out_ports[0].dtype),)


def rational_resampler_ccf(interp, decim, taps=None, fractional_bw=0.4):
    if taps is None:
        taps = design_rational_resampler_taps(interp, decim, fractional_bw)
    return RationalResampler(interp, decim, np.real(taps), True)


def rational_resampler_fff(interp, decim, taps=None, fractional_bw=0.4):
    if taps is None:
        taps = design_rational_resampler_taps(interp, decim, fractional_bw)
    return RationalResampler(interp, decim, np.real(taps), False)


def design_rational_resampler_taps(interp, decim, fractional_bw=0.4):
    """python/filter/rational_resampler.py design_filter analog: low-pass at
    min(1/L, 1/M)*fbw of the upsampled rate, gain L."""
    from . import firdes as fd
    g = math.gcd(int(interp), int(decim))
    L, M = interp // g, decim // g
    rate = max(L, M)
    bw = fractional_bw / rate
    trans = 0.5 * bw
    return fd.low_pass(L, 1.0, bw, trans, fd.WIN_KAISER, beta=7.0)


def hilbert_fc(ntaps=65, win="blackman"):
    """hilbert_fc: float in -> analytic complex out. Real path delayed by
    (ntaps-1)/2, imag path = Hilbert FIR."""
    from . import firdes as fd
    h = fd.hilbert(ntaps, win if isinstance(win, str) else "blackman")
    m = (len(h) - 1) // 2
    taps = (np.eye(1, len(h), m)[0] + 1j * h).astype(np.complex64)
    return FirFilter(1, taps, in_complex=False, out_complex=True)
