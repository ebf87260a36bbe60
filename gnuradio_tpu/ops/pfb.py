"""Polyphase filterbank suite — channelizer, arbitrary resampler,
decimator, interpolator, synthesizer.

Reference parity map (SURVEY.md §2.2 gr-filter row):
  pfb_channelizer_ccf  (gr-filter/lib/pfb_channelizer_ccf_impl.cc:63-95,
                        kernel lib/polyphase_filterbank.cc)
  pfb_arb_resampler    (gr-filter/lib/pfb_arb_resampler.cc:117-211 — arm
                        accumulator + derivative-taps linear interpolation)
  pfb_decimator_ccf    (lib/pfb_decimator_ccf_impl.cc)
  pfb_interpolator_ccf (lib/pfb_interpolator_ccf_impl.cc)
  pfb_synthesizer_ccf  (lib/pfb_synthesizer_ccf_impl.cc)

Design:
  * The channelizer's input commutator (stream_to_streams + index LUT in the
    reference) is a reshape; the M arm FIRs are ONE batched banded matmul;
    the output commutator is one batched DFT. No per-arm loops.
  * The arb resampler's sequential accumulator (d_acc += d_flt_rate; arm
    jump d_dec_rate + floor(d_acc), pfb_arb_resampler.cc:157-211) telescopes
    into a CLOSED FORM: the combined arm+input index of output k is
      m_k = m_0 + floor(k * nfilts / rate + acc_0)
    so every output's (input index, arm, interp fraction) is computed in
    parallel with exact integer arithmetic (rate held as a rational P/Q),
    then evaluated as a gather + two batched dots. No scan, no data
    dependence, bit-stable across chunk boundaries.
"""
from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block
from ..core.stream import PortSpec, C, F
from ..kernels.fir_xla import fir_apply_batched


def _arm_rows(xp, M: int, rows_len: int):
    """Polyphase commutator relayout: rows U[m, j] = xp[j*M + M-1-m],
    shape (M, rows_len), as reshape+transpose+flip (no strided gathers)."""
    need = rows_len * M
    if xp.shape[0] < need:
        xp = jnp.pad(xp, (0, need - xp.shape[0]))
    return jnp.flip(xp[:need].reshape(rows_len, M).T, axis=0)


def _pad_arms(taps, M):
    """Split prototype taps into M arms: arm m holds taps[m::M], zero-padded
    to equal length L. Returns (M, L) array."""
    taps = np.asarray(taps)
    L = -(-len(taps) // M)
    padded = np.zeros(L * M, dtype=taps.dtype)
    padded[: len(taps)] = taps
    return padded.reshape(L, M).T.copy()  # (M, L), arm m = taps[m::M]


class PfbChannelizer(Block):
    """DFT analysis filterbank: one complex stream in, M channel streams
    out, channel c centered at +c*fs/M (wrapping; c > M/2 are negative
    frequencies) — matching pfb_channelizer_ccf with the pfb.py
    stream_to_streams commutator (gr-filter/python/filter/pfb.py).

    Maximally decimated (oversample_rate = 1):
      y_c[t] = sum_n h[n] x[tM - n] e^{+j 2 pi c n / M}
             = M * IFFT_m( sum_l h[m+lM] x[tM - m - lM] )
    computed as: deinterleave -> (M, L-1+T) arm inputs -> batched conv ->
    (M, T) -> IFFT along arms -> per-channel streams.

    Oversampled (oversample_rate = M/R for integer hop R, the reference's
    "N/i for i in [1, N]" constraint, pfb_channelizer_ccf_impl.cc:44-56):
    the commutator advances R < M inputs per output vector:
      y_c[t] = sum_n h[n] x[tR - n] e^{+j 2 pi c n / M}.
    Decompose t = s*O + p with O = lcm(M, R)/R outputs per period and
    K = O*R/M input M-blocks per period. With arm signals
    u_m[k] = x[kM - m] and q' = (m - p*R) mod M, adv = (q' - (m - p*R))/M:
      v_m[sO + p] = (arms[m] conv u_{q'})[sK + adv]
    i.e. the SAME per-arm decimated sequences, filtered under a per-phase
    arm permutation with a whole-block advance — the reference's rotating
    d_idxlut realized as a static gather. O*M (tap-arm, signal-row) pairs
    become one batched matmul; phases interleave back as t = s*O + p.
    """

    def __init__(self, nchans: int, taps, oversample_rate: float = 1.0,
                 name=None):
        super().__init__(name)
        self.M = int(nchans)
        R = self.M / float(oversample_rate)
        if abs(R - round(R)) > 1e-5:
            raise ValueError(
                "pfb_channelizer: oversample rate must be N/i for i in "
                "[1, N] (pfb_channelizer_ccf_impl.cc:44-56)")
        self.R = int(round(R))
        self.osr = float(oversample_rate)
        # outputs per repeating phase period: smallest O with O*R % M == 0
        g = math.gcd(self.M, self.R)
        self.O = self.M // g
        self.K = self.O * self.R // self.M  # input M-blocks per period
        self.arms = _pad_arms(np.real(taps).astype(np.float32), self.M)
        self.L = self.arms.shape[1]
        self.in_ports = (PortSpec(C),)
        self.out_ports = tuple(PortSpec(C) for _ in range(self.M))
        self.ntaps = len(np.asarray(taps))
        self.output_multiple = self.O
        if self.R != self.M:
            # precompute the (O*M,) row permutation / advance / select maps
            p = np.repeat(np.arange(self.O), self.M)
            m = np.tile(np.arange(self.M), self.O)
            q = m - p * self.R
            self._rows = np.mod(q, self.M)            # signal row per pair
            self._adv = (self._rows - q) // self.M    # whole-block advance
            self._arm_ix = m

    @property
    def in_rates(self):
        return (Fraction(self.R),)

    @property
    def out_rates(self):
        return tuple(Fraction(1) for _ in range(self.M))

    def init_state(self):
        # history: L*M - 1 input samples (covers arm depth across all arms)
        return jnp.zeros((self.L * self.M - 1,), C)

    def _arm_signals(self, xp, nout_per_row: int):
        """(M, L-1+nout_per_row) arm rows: u_m[j] = xp[jM + M-1-m].

        Built as ONE reshape + transpose + flip instead of M strided slices
        (xp[M-1-m::M]), which compile to stride-M gathers."""
        return _arm_rows(xp, self.M, self.L - 1 + nout_per_row)

    def _ifft_rows(self, V):
        """y = M * IFFT along axis 0. For M <= 256 this is ONE plane matmul
        E @ V with E[c, m] = e^{+2j pi c m / M} at HIGHEST precision, in
        place of a small-N FFT (same choice as ops/ofdm.dft_apply)."""
        M = self.M
        if M > 256:
            return (jnp.fft.ifft(V, axis=0) * M).astype(C)
        if not hasattr(self, "_E"):
            k = np.arange(M)
            E = np.exp(2j * np.pi * np.outer(k, k) / M)
            self._E = (E.real.astype(np.float32), E.imag.astype(np.float32))
        Er, Ei = (jnp.asarray(self._E[0]), jnp.asarray(self._E[1]))
        Vr, Vi = jnp.real(V), jnp.imag(V)
        mm = lambda a, b: jnp.matmul(a, b,  # noqa: E731
                                     precision=jax.lax.Precision.HIGHEST)
        return jax.lax.complex(mm(Er, Vr) - mm(Ei, Vi),
                               mm(Er, Vi) + mm(Ei, Vr)).astype(C)

    def apply_batched(self, state, x):
        """Fast-path step: (state, x[(n,)]) -> (state, Y[(M, n/M)]) with no
        per-channel tuple round-trip (the graph-block apply() slices into M
        streams for port fan-out; model/bench steps keep the batch form)."""
        M, L = self.M, self.L
        assert self.R == M, "apply_batched: maximally-decimated form only"
        xp = jnp.concatenate([state, x], axis=0)
        tail = xp[xp.shape[0] - (L * M - 1):]
        T = x.shape[0] // M
        U = self._arm_signals(xp, T)
        V = fir_apply_batched(U, jnp.asarray(self.arms), 1)  # (M, T)
        return tail, self._ifft_rows(V)

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        M, L = self.M, self.L
        xp = jnp.concatenate([state, x], axis=0)  # len = LM-1 + n
        tail = xp[xp.shape[0] - (L * M - 1):]
        if self.R == self.M:
            T = x.shape[0] // M
            U = self._arm_signals(xp, T)
            V = fir_apply_batched(U, jnp.asarray(self.arms), 1)  # (M, T)
            Y = self._ifft_rows(V)
            return tail, tuple(Y[c] for c in range(M))
        # oversampled path
        Tb = x.shape[0] // M               # input M-blocks this step
        Ts = Tb // self.K                  # phase periods this step
        Tout = Ts * self.O                 # outputs per channel
        # rows long enough for Tb+1 conv outputs; the one extra sample for
        # row 0 doesn't exist (future) — pad a zero; it is provably never
        # selected (adv = K requires row >= R >= 1, see class docstring)
        xpz = jnp.concatenate([xp, jnp.zeros(1, xp.dtype)])
        U = self._arm_signals(xpz, Tb + 1)                # (M, L+Tb)
        S = U[jnp.asarray(self._rows)]                    # (O*M, L+Tb)
        Tp = jnp.asarray(self.arms)[jnp.asarray(self._arm_ix)]
        V = fir_apply_batched(S, Tp, 1)                   # (O*M, Tb+1)
        V = V.reshape(self.O, M, Tb + 1)
        # select conv index s*K + adv for each (p, m), s = 0..Ts-1
        sel = (np.arange(Ts)[None, None, :] * self.K +
               self._adv.reshape(self.O, M)[:, :, None])  # (O, M, Ts)
        Vt = jnp.take_along_axis(V, jnp.asarray(sel), axis=2)  # (O, M, Ts)
        if M <= 256:
            # DFT as plane matmul over the middle axis (see _ifft_rows)
            if not hasattr(self, "_E"):
                k = np.arange(M)
                E = np.exp(2j * np.pi * np.outer(k, k) / M)
                self._E = (E.real.astype(np.float32),
                           E.imag.astype(np.float32))
            Er, Ei = (jnp.asarray(self._E[0]), jnp.asarray(self._E[1]))
            Vr = jnp.real(Vt).astype(jnp.float32)
            Vi = jnp.imag(Vt).astype(jnp.float32)
            em = lambda W, X: jnp.einsum(  # noqa: E731
                "cm,pmt->pct", W, X,
                precision=jax.lax.Precision.HIGHEST)
            Y = jax.lax.complex(em(Er, Vr) - em(Ei, Vi),
                                em(Er, Vi) + em(Ei, Vr)).astype(C)
        else:
            Y = (jnp.fft.ifft(Vt, axis=1) * M).astype(C)  # (O, M, Ts)
        # down-mix residue: y_c[t] = e^{-j2pi c tR/M} * (analysis output);
        # for R = M this is 1, for R < M it is the per-phase rotation
        # e^{-j2pi c pR/M} (the reference's idxlut "FFT shift on every
        # other turn", pfb_channelizer_ccf_impl.cc:69-77, in closed form)
        p_ix = np.arange(self.O)[:, None]
        c_ix = np.arange(M)[None, :]
        rot = np.exp(-2j * np.pi * c_ix * p_ix * self.R / M
                     ).astype(np.complex64)               # (O, M)
        Y = Y * jnp.asarray(rot)[:, :, None]
        # interleave phases: channel c stream index t = s*O + p
        Yc = jnp.transpose(Y, (1, 2, 0)).reshape(M, Tout)
        return tail, tuple(Yc[c] for c in range(M))


def pfb_channelizer_ccf(nchans, taps, oversample_rate=1.0):
    return PfbChannelizer(nchans, taps, oversample_rate)


class PfbSynthesizer(Block):
    """Inverse of the channelizer: M channel streams in, one stream out at
    M x the channel rate (pfb_synthesizer_ccf_impl.cc, sps=1): IFFT across
    channels then polyphase interpolation commutator."""

    def __init__(self, nchans: int, taps, name=None):
        super().__init__(name)
        self.M = int(nchans)
        self.arms = _pad_arms(np.real(taps).astype(np.float32), self.M)
        self.L = self.arms.shape[1]
        self.in_ports = tuple(PortSpec(C) for _ in range(self.M))
        self.out_ports = (PortSpec(C),)

    @property
    def in_rates(self):
        return tuple(Fraction(1) for _ in range(self.M))

    @property
    def out_rates(self):
        return (Fraction(self.M),)

    def init_state(self):
        return jnp.zeros((self.M, self.L - 1), C)

    def apply(self, state, inputs, n_in):
        M, L = self.M, self.L
        X = jnp.stack(inputs, axis=0)            # (M, T)
        W = jnp.fft.ifft(X, axis=0) * M          # (M, T) arm drive:
        # W[m,s] = sum_c X_c[s] e^{+j2pi c m/M} — modulation to +c*fs/M
        # evaluated at output phase m (y[sM+m] = (arm_m * W[m])[s])
        Wp = jnp.concatenate([state, W], axis=1)  # (M, L-1+T)
        tail = Wp[:, Wp.shape[1] - (L - 1):]
        Ya = fir_apply_batched(Wp, jnp.asarray(self.arms), 1)  # (M, T)
        # output commutator: y[tM + m] = Ya[m, t]; gain M compensates the
        # 1/M per-arm energy of the upsampling prototype (interp filters
        # need gain L — same rule as interp_fir_filter taps)
        y = Ya.T.reshape(-1) * M
        return tail, (y.astype(C),)


def pfb_synthesizer_ccf(nchans, taps):
    return PfbSynthesizer(nchans, taps)


class PfbDecimator(Block):
    """pfb_decimator_ccf: M-band channelizer keeping only channel `channel`
    — band-select + decimate by M in one pass."""

    def __init__(self, decim: int, taps, channel: int = 0, name=None):
        super().__init__(name)
        self.M = int(decim)
        self.channel = int(channel)
        self.arms = _pad_arms(np.real(taps).astype(np.float32), self.M)
        self.L = self.arms.shape[1]
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(C),)

    @property
    def in_rates(self):
        return (Fraction(self.M),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def init_state(self):
        return jnp.zeros((self.L * self.M - 1,), C)

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        M, L, c = self.M, self.L, self.channel
        T = x.shape[0] // M
        xp = jnp.concatenate([state, x], axis=0)
        tail = xp[xp.shape[0] - (L * M - 1):]
        U = _arm_rows(xp, M, L - 1 + T)
        V = fir_apply_batched(U, jnp.asarray(self.arms), 1)  # (M, T)
        # single-channel DFT bin instead of full FFT
        ph = jnp.exp(2j * jnp.pi * c * jnp.arange(M) / M).astype(C)
        y = jnp.tensordot(ph, V, axes=(0, 0))
        return tail, (y.astype(C),)


def pfb_decimator_ccf(decim, taps, channel=0):
    return PfbDecimator(decim, taps, channel)


class PfbInterpolator(Block):
    """pfb_interpolator_ccf: 1:L interpolation via polyphase arms — same
    math as InterpFirFilter but keeping the pfb naming/taps convention."""

    def __init__(self, interp: int, taps, name=None):
        super().__init__(name)
        self.Lup = int(interp)
        self.arms = _pad_arms(np.real(taps).astype(np.float32), self.Lup)
        self.alen = self.arms.shape[1]
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(C),)

    @property
    def in_rates(self):
        return (Fraction(1),)

    @property
    def out_rates(self):
        return (Fraction(self.Lup),)

    def init_state(self):
        return jnp.zeros((self.alen - 1,), C)

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        xp = jnp.concatenate([state, x], axis=0)
        tail = xp[xp.shape[0] - (self.alen - 1):] if self.alen > 1 else state
        xb = jnp.broadcast_to(xp, (self.Lup,) + xp.shape)
        ys = fir_apply_batched(xb, jnp.asarray(self.arms), 1)  # (L, n)
        return tail, (ys.T.reshape(-1).astype(C),)


def pfb_interpolator_ccf(interp, taps):
    return PfbInterpolator(interp, taps)


def _create_diff_taps(taps):
    """Derivative filter taps ([-1, 1] stencil) exactly as the reference
    (pfb_arb_resampler.cc create_diff_taps): difftaps[i] =
    (taps[i+1] - taps[i]) convolved-ish stencil, end handled, scaled so both
    banks have matched gain."""
    taps = np.asarray(taps, np.float64)
    stencil = np.array([-1.0, 1.0])
    diff = np.zeros_like(taps)
    for i in range(len(taps) - 1):
        diff[i] = stencil[0] * taps[i] + stencil[1] * taps[i + 1]
    diff[-1] = stencil[0] * taps[-1] + stencil[1] * taps[0]
    return diff


class PfbArbResampler(Block):
    """Arbitrary (fractional) rate resampler via polyphase arm interpolation
    (gr::filter::kernel::pfb_arb_resampler, lib/pfb_arb_resampler.cc).

    For output k (global), with nfilts arms and rate r = out/in held as the
    rational P/Q (r floats are rationalized to denominator <= 2^20 — error
    < 1e-12, below the reference's double-float accumulator drift):

      stride    s   = nfilts * Q / P   (arm-steps per output, rational)
      m_k           = floor(k * nfilts * Q / P)       (combined index)
      input idx n_k = m_k // nfilts
      arm       j_k = m_k %  nfilts
      frac      a_k = frac(k * nfilts * Q / P)        (interp weight)
      y[k] = fir_{j_k}(x, n_k) + a_k * dfir_{j_k}(x, n_k)

    computed for a whole chunk in parallel: window gather (n_out, L) +
    per-output tap gather (n_out, L) + two batched dots. The chunk contract
    is exact: n_out outputs per n_in = n_out*Q/P inputs (graph layer sizes
    chunks so both are integers); no state beyond the input tail.
    """

    def __init__(self, rate: float, taps, nfilts: int = 32, name=None):
        super().__init__(name)
        self.nfilts = int(nfilts)
        r = Fraction(rate).limit_denominator(1 << 20)
        self.P, self.Q = r.numerator, r.denominator
        taps = np.asarray(taps, np.float64)
        dtaps = _create_diff_taps(taps)
        # reference scales taps by nfilts (gain of the polyphase split)
        self.arms = _pad_arms(taps.astype(np.float32), self.nfilts)
        self.darms = _pad_arms(dtaps.astype(np.float32), self.nfilts)
        self.L = self.arms.shape[1]
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(C),)
        self.rate = float(rate)
        self._build_tap_matrix()

    def _build_tap_matrix(self):
        """Rational-rate banded tap matrix: the (arm, fraction) schedule
        repeats every P outputs / Q inputs, and the linear interpolation
        o0 + a*o1 FOLDS into per-output combined taps arms[j] + a*darms[j].
        One (G, t*Q+L-1) frame matrix @ (t*Q+L-1, t*P) tap matrix then
        yields t*P outputs per frame — no per-output gather at all. t
        tiles groups up toward 128 outputs per frame."""
        P, Q, nf, L = self.P, self.Q, self.nfilts, self.L
        if P * Q > (1 << 22):  # pathological rationals: keep gather path
            self.TM = None
            return
        t = max(1, -(-128 // min(P, 128)))
        self.tile_groups = t
        Wd = t * Q + L - 1
        TM = np.zeros((Wd, t * P), np.float32)
        for r in range(P):
            num = r * nf * Q
            m = num // P
            j = m % nf
            a = (num % P) / P
            n_r = m // nf
            ct = self.arms[j] + np.float32(a) * self.darms[j]  # (L,)
            for s in range(t):
                rows = s * Q + n_r + (L - 1) - np.arange(L)
                TM[rows, s * P + r] += ct
        self.TM = TM
        self.Wd = Wd

    def _resample_gather(self, xp, n_out):
        """Per-output gather fallback for rationals too large to tabulate
        (arbitrary float rates): window gather + two batched dots."""
        nf, L = self.nfilts, self.L
        k = np.arange(n_out, dtype=np.int64)
        num = k * (nf * self.Q)
        m = num // self.P
        n_idx = (m // nf).astype(np.int32)
        j = (m % nf).astype(np.int32)
        a = ((num % self.P) / self.P).astype(np.float32)
        win_idx = n_idx[:, None] + (L - 1) - np.arange(L)[None, :]
        W = xp[:, jnp.asarray(win_idx)]                # (B, n_out, L)
        Tp = jnp.asarray(self.arms)[jnp.asarray(j)]
        Dp = jnp.asarray(self.darms)[jnp.asarray(j)]
        o0 = jnp.sum(W * Tp[None], axis=2)
        o1 = jnp.sum(W * Dp[None], axis=2)
        return o0 + jnp.asarray(a)[None] * o1

    def resample_batched(self, xp):
        """xp: (B, L + n) complex with L-history prepended; returns
        (B, n*P/Q) complex. Pure framing (shifted reshapes) + ONE matmul."""
        from ..kernels.fir_xla import _frame
        import jax
        from jax import lax
        B, total = xp.shape
        n = total - self.L
        n_out = n * self.P // self.Q
        if self.TM is None:
            return self._resample_gather(xp, n_out)
        t, P, Q = self.tile_groups, self.P, self.Q
        G = -(-n_out // (t * P))
        hop = t * Q
        # window of output r in group g starts at xp[g*Q + n_r]; with the
        # L-history convention the frame for group g is xp[g*hop : g*hop+Wd]
        F = jax.vmap(lambda v: _frame(v, G, hop, self.Wd))(xp)  # (B, G, Wd)
        TMj = jnp.asarray(self.TM)

        def mm(Fr):
            return lax.dot_general(
                Fr, TMj, dimension_numbers=(((2,), (0,)), ((), ())),
                precision=lax.Precision.HIGHEST)

        if jnp.iscomplexobj(xp):
            Yr = mm(F.real.astype(jnp.float32))
            Yi = mm(F.imag.astype(jnp.float32))
            Y = lax.complex(Yr, Yi)
        else:
            Y = mm(F.astype(jnp.float32))
        return Y.reshape(B, G * t * P)[:, :n_out]

    @property
    def in_rates(self):
        return (Fraction(self.Q),)

    @property
    def out_rates(self):
        return (Fraction(self.P),)

    def init_state(self):
        # carry L input samples (arm depth) + the global output index phase
        # residue. m advances by exactly n_in*nfilts per chunk, so only the
        # sub-input-sample residue r0 = m_0 mod nfilts needs carrying; it is
        # constant 0 when chunks hold integer in/out counts — so the only
        # state is the input tail.
        return jnp.zeros((self.L,), C)

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        xp = jnp.concatenate([state, x], axis=0)   # (L + n,)
        tail = xp[xp.shape[0] - self.L:]
        y = self.resample_batched(xp[None])[0]
        return tail, (y.astype(x.dtype),)


def pfb_arb_resampler_ccf(rate, taps, nfilts=32):
    return PfbArbResampler(rate, taps, nfilts)


def pfb_arb_resampler_fff(rate, taps, nfilts=32):
    b = PfbArbResampler(rate, taps, nfilts)
    b.in_ports = (PortSpec(F),)
    b.out_ports = (PortSpec(F),)

    def init_state():
        return jnp.zeros((b.L,), F)
    b.init_state = init_state
    return b


def pfb_arb_resampler_ccc(rate, taps, nfilts=32):
    return PfbArbResampler(rate, np.real(taps), nfilts)
