"""Multi-channel closed-loop symbol synchronization — tracking loops as a
data-parallel program (round-3 item #1).

The reference's symbol_sync/pfb_clock_sync hot loop
(gr-digital/lib/symbol_sync_cc_impl.cc:389-470) is a per-symbol scalar
recurrence: interpolate at the current fractional clock, run a timing-error
detector, update a PI loop, advance the clock. A literal per-sample
`lax.scan` translation pays one sequential step per sample
(ops/digital_loops.py keeps that form for single-stream parity). This module
is the data-parallel redesign:

  * N independent channels ride the LANE axis. One scan step processes one
    SYMBOL for all N channels simultaneously — the per-step while-loop
    overhead is amortized N ways, and every operation inside the step is a
    (N,)-vector op.
  * The per-channel integer sample offset is bounded (|dev| <= W samples
    from the nominal k*sps grid). Each step dynamic-slices one small
    (win, N) window at the *shared* nominal position and resolves each
    channel's private offset with one-hot row weights — a (win, N)
    multiply-accumulate, NOT a gather.
  * Fractional interpolation is a cubic Farrow (4-point Lagrange) evaluated
    as polynomials in mu — no tap-table lookups. The reference's MMSE
    8-tap interpolator (gr-filter/lib/mmse_fir_interpolator_cc.cc) is a
    higher-order version of the same fractional-delay operator; QA bounds
    the substitution error.
  * Timing: Gardner TED (needs no carrier lock) + the reference's
    PI clock-tracking loop (gr-digital/lib/clock_tracking_loop.cc gains).
  * Carrier: decision-directed Costas (order 4) per symbol after timing,
    same detector as costas_loop_cc_impl.cc.

Bound: accumulated per-chunk timing drift must stay within +-W samples of
the nominal grid (W=8 at 4 sps tolerates ~500 ppm SRO over 4k symbols per
chunk; the deviation re-centers into the carried state at chunk edges, so
long streams track indefinitely as long as the per-chunk drift bound
holds). For larger offsets, acquire first (models/qpsk.py feedforward O&M).

Single-stream use: `block_parallel_tracker` chops ONE stream into B
overlapping segments, seeds each segment's loop state with feedforward
estimates (O&M timing, Viterbi&Viterbi phase), runs the multi-channel
tracker over segments-as-channels, resolves the per-segment pi/2 phase
ambiguity pairwise in the overlap, and stitches — converting the
inherently sequential single-stream recurrence into lane-parallel work
with an SNR-equivalence QA contract (tests/test_multichannel_sync.py).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .digital_loops import loop_gains


def _farrow_weights(mu):
    """4-point cubic Lagrange weights for fractional delay mu in [0,1):
    interpolates x(t) at t = t1 + mu from samples (x0, x1, x2, x3) at
    t0..t3. Returns (w0, w1, w2, w3) each shaped like mu."""
    m = mu
    w0 = -m * (m - 1.0) * (m - 2.0) / 6.0
    w1 = (m + 1.0) * (m - 1.0) * (m - 2.0) / 2.0
    w2 = -(m + 1.0) * m * (m - 2.0) / 2.0
    w3 = (m + 1.0) * m * (m - 1.0) / 6.0
    return w0, w1, w2, w3


def _row_weights(win, d, mu):
    """(win, C) f32 interpolation weight matrix: channel c's column is the
    cubic Farrow kernel placed at row offset d[c] (integer part), i.e.
    weight[r, c] = farrow_j(mu[c]) for r == d[c] + j - 1, j in 0..3.

    Built from lane-parallel compares (one-hot), never a gather."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (win, d.shape[0]), 0)
    w0, w1, w2, w3 = _farrow_weights(mu)
    base = d[None, :] - 1
    w = jnp.where(rows == base, w0[None, :], 0.0)
    w = jnp.where(rows == base + 1, w1[None, :], w)
    w = jnp.where(rows == base + 2, w2[None, :], w)
    w = jnp.where(rows == base + 3, w3[None, :], w)
    return w


def _interp(win_r, win_i, d, mu):
    """Interpolate each channel at (row d[c] + mu[c]) from the (win, C)
    real/imag window planes. Returns complex (C,)."""
    w = _row_weights(win_r.shape[0], d, mu)
    yr = jnp.sum(win_r * w, axis=0)
    yi = jnp.sum(win_i * w, axis=0)
    return yr, yi


class MultiChannelTracker:
    """Vectorized Gardner + Costas tracking over C channels (see module
    docstring). Functional core; `make_step` returns the jittable pieces.

    Parameters mirror the reference loops: timing_bw/costas_bw are loop
    bandwidths in rad/sample (gr-blocks/lib/control_loop.cc gains), sps the
    nominal (integer) samples per symbol, W the +-bound on per-chunk timing
    deviation in samples.
    """

    def __init__(self, nchan: int, sps: int, timing_bw: float = 2 * math.pi / 100,
                 costas_bw: float = 2 * math.pi / 100, W: int = 8,
                 costas_order: int = 4):
        if sps < 2:
            raise ValueError("sps must be >= 2")
        self.nchan = int(nchan)
        self.sps = int(sps)
        self.W = int(W)
        self.alpha_t, self.beta_t = loop_gains(timing_bw)
        self.alpha_c, self.beta_c = loop_gains(costas_bw)
        self.costas_order = costas_order
        # window geometry: symbol k (chunk-local) samples at row
        # k*sps + BASE + dev, dev in [-W, W); the Gardner midpoint sits
        # sps//2 earlier; the Farrow kernel spans [d-1, d+2]. The window
        # slice covers offsets [-(W+1+half), W+2] around k*sps + BASE.
        half = self.sps // 2
        self.BASE = self.W + half + 2
        self.win = 2 * self.W + half + 4
        # carried tail rows so chunk boundaries keep symbol 0 at BASE
        self.TL = self.BASE + self.W + 4

    # ---- state ----
    def init_state(self, dev0=None, phase0=None, period0=None):
        C = self.nchan
        dev = (jnp.zeros(C, jnp.float32) if dev0 is None
               else jnp.asarray(dev0, jnp.float32))
        phase = (jnp.zeros(C, jnp.float32) if phase0 is None
                 else jnp.asarray(phase0, jnp.float32))
        period = (jnp.full((C,), float(self.sps), jnp.float32)
                  if period0 is None else jnp.asarray(period0, jnp.float32))
        return {
            "tail_r": jnp.zeros((self.TL, C), jnp.float32),
            "tail_i": jnp.zeros((self.TL, C), jnp.float32),
            "dev": dev,                      # timing deviation (samples)
            "period": period,                # instantaneous samples/symbol
            "phase": phase,                  # Costas phase (rad)
            "freq": jnp.zeros(C, jnp.float32),   # Costas freq (rad/symbol)
            "prev_r": jnp.zeros(C, jnp.float32),  # y_{k-1} (pre-Costas)
            "prev_i": jnp.zeros(C, jnp.float32),
        }

    def step(self, state, x, S: int = 16):
        """x: (n, C) complex64 (time-major, channels on lanes), n a multiple
        of sps. Returns (state, y[(K, C) complex64]) with K = n // sps —
        the Costas-corrected symbol decisions-input (soft symbols).

        S = symbols per scan step (round-4 item #6): one dynamic window
        slice covers S consecutive symbols and the per-symbol recurrence
        unrolls over STATIC slices of it — amortizing the ~us-scale
        per-scan-iteration overhead S-fold with IDENTICAL loop dynamics
        (the inner updates stay strictly sequential)."""
        n, C = x.shape
        sps, W, BASE = self.sps, self.W, self.BASE
        K = n // sps
        if K % S:
            S = 1
        xr = jnp.concatenate([state["tail_r"], jnp.real(x)], axis=0)
        xi = jnp.concatenate([state["tail_i"], jnp.imag(x)], axis=0)
        a_t = jnp.float32(self.alpha_t)
        b_t = jnp.float32(self.beta_t)
        a_c = jnp.float32(self.alpha_c)
        b_c = jnp.float32(self.beta_c)
        half = sps // 2
        win = self.win

        def sym_update(carry, wr, wi):
            dev, period, phase, freq, pr, pi_ = carry
            d = jnp.floor(dev).astype(jnp.int32)
            mu = dev - d.astype(jnp.float32)
            # current symbol sample (offset restores BASE-relative row)
            yr, yi = _interp(wr, wi, d + (W + 1 + half), mu)
            # Gardner midpoint, sps/2 before the current symbol
            mr, mi = _interp(wr, wi, d + (W + 1), mu)
            # Gardner TED: e = Re[(y_{k-1} - y_k) * conj(mid)]
            e_t = (pr - yr) * mr + (pi_ - yi) * mi
            e_t = jnp.clip(e_t, -1.0, 1.0)
            period = period + b_t * e_t
            period = jnp.clip(period, sps - 0.5, sps + 0.5)
            dev = dev + (period - sps) + a_t * e_t
            dev = jnp.clip(dev, -float(W), float(W) - 1.0)
            # Costas (order 4 decision-directed, costas_loop_cc_impl.cc)
            c = jnp.cos(-phase)
            s = jnp.sin(-phase)
            zr = yr * c - yi * s
            zi = yr * s + yi * c
            e_c = (jnp.where(zr > 0, 1.0, -1.0) * zi
                   - jnp.where(zi > 0, 1.0, -1.0) * zr)
            e_c = jnp.clip(e_c, -1.0, 1.0)
            freq = jnp.clip(freq + b_c * e_c, -1.0, 1.0)
            phase = phase + freq + a_c * e_c
            phase = phase - jnp.floor((phase + 2 * jnp.pi)
                                      / (4 * jnp.pi)) * (4 * jnp.pi)
            return (dev, period, phase, freq, yr, yi), (zr, zi)

        def group_step(carry, j):
            start = j * (S * sps) + BASE - (W + 1 + half)
            gw = S * sps + win
            gr = jax.lax.dynamic_slice(xr, (start, 0), (gw, C))
            gi = jax.lax.dynamic_slice(xi, (start, 0), (gw, C))
            outs = []
            for s in range(S):
                wr = jax.lax.slice_in_dim(gr, s * sps, s * sps + win)
                wi = jax.lax.slice_in_dim(gi, s * sps, s * sps + win)
                carry, z = sym_update(carry, wr, wi)
                outs.append(z)
            zr = jnp.stack([o[0] for o in outs])        # (S, C)
            zi = jnp.stack([o[1] for o in outs])
            return carry, (zr, zi)

        carry0 = (state["dev"], state["period"], state["phase"],
                  state["freq"], state["prev_r"], state["prev_i"])
        carry, (outr, outi) = jax.lax.scan(
            group_step, carry0, jnp.arange(K // S, dtype=jnp.int32))
        outr = outr.reshape(K, C)
        outi = outi.reshape(K, C)
        dev, period, phase, freq, pr, pi_ = carry
        rows = xr.shape[0]
        new_state = {
            "tail_r": jax.lax.dynamic_slice(xr, (rows - self.TL, 0),
                                            (self.TL, C)),
            "tail_i": jax.lax.dynamic_slice(xi, (rows - self.TL, 0),
                                            (self.TL, C)),
            "dev": dev, "period": period, "phase": phase, "freq": freq,
            "prev_r": pr, "prev_i": pi_,
        }
        return new_state, jax.lax.complex(outr, outi)


def make_multichannel_tracking_step(nchan: int, sps: int,
                                    timing_bw: float = 2 * math.pi / 100,
                                    costas_bw: float = 2 * math.pi / 100,
                                    W: int = 8):
    """Functional form: (init_state, step) with
    step(state, x[(n, C) c64]) -> (state, symbols[(K, C) c64])."""
    trk = MultiChannelTracker(nchan, sps, timing_bw, costas_bw, W)
    return trk.init_state, trk.step


# ---------------------------------------------------------------------------
# Single-stream block-parallel tracking
# ---------------------------------------------------------------------------

def _om_timing_block(yb, sps):
    """Oerder&Meyr square-law timing estimate per block row: yb (B, L)
    complex -> tau (B,) in [-sps/2, sps/2)."""
    L = yb.shape[1]
    ph = jnp.exp(-2j * jnp.pi * (jnp.arange(L) % sps) / sps
                 ).astype(jnp.complex64)
    S = jnp.sum((jnp.abs(yb) ** 2).astype(jnp.complex64) * ph[None, :],
                axis=1)
    return -sps / (2 * jnp.pi) * jnp.angle(S)


def _vv_phase_block(sb):
    """Viterbi&Viterbi 4th-power carrier phase per block row: sb (B, K)
    symbols -> theta (B,) in [-pi/4, pi/4)."""
    return jnp.angle(jnp.sum(sb ** 4, axis=1)) / 4.0


def block_parallel_tracker(sps: int, nblocks: int, overlap_syms: int = 128,
                           timing_bw: float = 2 * math.pi / 100,
                           costas_bw: float = 2 * math.pi / 100, W: int = 8):
    """Single-stream tracking loops at lane-parallel speed.

    Splits one matched-filtered stream into `nblocks` segments that overlap
    by `overlap_syms` symbols, seeds every segment's loop state with
    feedforward estimates (O&M timing + V&V phase over the segment head),
    runs MultiChannelTracker with segments as channels, cancels each
    segment's residual pi/2 phase ambiguity against its left neighbor using
    the overlap region, and returns the stitched symbol stream.

    Returns run(x[(n,) c64]) -> symbols[(n//sps,) c64]; n must satisfy
    n % (nblocks * sps) == 0. The first `overlap_syms` symbols of each
    segment are used for convergence and dropped from the stitch (the
    stream head keeps its converged tail only after the loop settles, like
    the reference loops' pull-in transient).
    """
    OV = int(overlap_syms)
    trk = MultiChannelTracker(nblocks, sps, timing_bw, costas_bw, W)

    def run(x):
        n = x.shape[0]
        B = nblocks
        keep = n // (B * sps)           # symbols kept per segment
        seg_syms = keep + OV
        seg_len = seg_syms * sps
        # segment b covers samples [b*keep*sps - OV*sps, ...); left-pad the
        # stream so segment 0's warmup region exists
        xp = jnp.concatenate([jnp.zeros(OV * sps, x.dtype), x,
                              jnp.zeros(sps * 4, x.dtype)])
        starts = jnp.arange(B, dtype=jnp.int32) * (keep * sps)
        segs = jax.vmap(
            lambda s: jax.lax.dynamic_slice(xp, (s,), (seg_len,)))(starts)
        # feedforward seeds over the warmup head. The tracker samples x at
        # k*sps + dev - (W+4) (fixed group latency, see MultiChannelTracker
        # geometry), so the O&M estimate tau == t0 (mod sps) seeds
        # dev0 == tau + (W+4) (mod sps), wrapped to [-sps/2, sps/2).
        head = segs[:, : OV * sps]
        tau0 = _om_timing_block(head, sps)          # (B,) samples
        shift = float((trk.W + 4) % sps)
        dev0 = jnp.mod(tau0 + shift + sps / 2.0, float(sps)) - sps / 2.0
        # V&V 4th-power phase estimates theta + pi/4 (mod pi/2); the
        # Costas-4 equilibrium is the diagonal constellation, i.e.
        # phase0 == theta (mod pi/2)
        hs = head[:, :: sps]
        th0 = _vv_phase_block(hs) - jnp.pi / 4
        st = trk.init_state(dev0=dev0, phase0=th0)
        st, sym = trk.step(st, jnp.transpose(segs))  # (seg_syms, B)
        sym = jnp.transpose(sym)                     # (B, seg_syms)
        # resolve residual pi/2 ambiguity pairwise: segment b's tail overlap
        # re-covers segment b+1's head; compare decided symbols there
        tail = sym[:-1, keep:]                       # (B-1, OV) = b's view
        headv = sym[1:, :OV]                         # (B-1, OV) = b+1's view
        rot = jnp.angle(jnp.sum(tail * jnp.conj(headv), axis=1))
        rstep = jnp.round(rot / (jnp.pi / 2)) * (jnp.pi / 2)
        # cumulative rotation to bring every segment into segment 0's frame
        crot = jnp.concatenate([jnp.zeros(1), jnp.cumsum(rstep)])
        sym = sym * jnp.exp(1j * crot)[:, None].astype(jnp.complex64)
        return sym[:, OV: OV + keep].reshape(-1)

    return run
