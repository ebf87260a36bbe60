"""QPSK transceiver — BASELINE.json config #3.

Reference chain (gr-digital/python/digital/generic_mod_demod.py:123-155 mod,
:269-314 demod):
  TX: bits -> pack to symbol chunks -> diff encode -> chunks_to_symbols
      -> RRC pulse-shaping interpolator (pfb_arb_resampler in the reference;
      interp FIR here)
  RX: agc2_cc -> fll_band_edge_cc -> RRC matched filter ->
      clock recovery (M&M) -> costas_loop_cc -> constellation decode ->
      diff decode -> bits

Built as bare jittable step functions (models convention) — the graph-block
forms of every stage exist in ops/ and are QA'd individually; this module
wires the flagship receive path for loopback QA and bench.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import firdes
from ..ops.analog import Agc2
from ..ops.digital import DiffDecoder
from ..ops.digital_loops import CfoCorrector, CostasLoop, PfbClockSync


def rrc_taps(sps: int, excess_bw: float = 0.35, ntaps: int | None = None,
             gain: float | None = None):
    if ntaps is None:
        ntaps = 11 * sps
    if gain is None:
        gain = sps  # interp filter gain (generic_mod_demod.py:140)
    return firdes.root_raised_cosine(gain, sps, 1.0, excess_bw, ntaps)


# Differential coding runs in the ANGLE domain: symbol u maps to the point
# e^{j(pi/4 + u*pi/2)}, so a pi/2 carrier-phase ambiguity (Costas lock
# point) adds a CONSTANT to u and cancels in the differential decode — the
# same invariance GR achieves with pre_diff_code index remapping
# (gr-digital constellation.h pre_diff_code + diff_encoder_bb).
_ANGLE_PTS = np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4))).astype(np.complex64)


def qpsk_tx(bits: np.ndarray, sps: int = 4, excess_bw: float = 0.35):
    """Host-side reference TX (numpy): bits (2k,) of {0,1} -> baseband IQ at
    sps samples/symbol. Returns (iq, data_symbols)."""
    b = np.asarray(bits).reshape(-1, 2)
    sym = (b[:, 0] << 1) | b[:, 1]          # 2 bits -> symbol index, MSB first
    d = np.cumsum(sym) % 4                  # differential encode mod 4
    pts = _ANGLE_PTS[d]
    up = np.zeros(len(pts) * sps, np.complex64)
    up[::sps] = pts
    taps = rrc_taps(sps, excess_bw)
    iq = np.convolve(up, taps)[: len(up)].astype(np.complex64)
    return iq, sym


def make_qpsk_rx(sps: int = 4, excess_bw: float = 0.35,
                 timing_bw: float = 2 * math.pi / 100,
                 costas_bw: float = 2 * math.pi / 100, nfilts: int = 32):
    """Returns (init_state, step) for the QPSK receive chain:
    agc2 -> chunk CFO acquisition (x^4, replacing fll_band_edge's role) ->
    pfb_clock_sync (RRC matched filter + rotation-invariant timing) ->
    costas -> quadrant decision -> differential decode.

    step(state, iq[(n,) complex64]) -> (state, sym_idx[(n/sps,) int8]) —
    decided differential-decoded symbol indices.
    """
    agc = Agc2(attack_rate=1e-1, decay_rate=1e-2, reference=1.0, gain=1.0,
               complex_in=True)
    cfo = CfoCorrector()
    mf_taps = rrc_taps(sps, excess_bw, ntaps=11 * sps * nfilts,
                       gain=nfilts) / sps
    pcs = PfbClockSync(float(sps), timing_bw, mf_taps, nfilts)
    costas = CostasLoop(costas_bw, 4)
    dd = DiffDecoder(4)

    blocks = [agc, cfo, pcs, costas, dd]

    def init_state():
        return [b.init_state() for b in blocks]

    def step(state, iq):
        s = list(state)
        s[0], y = agc.work(s[0], iq)
        s[1], y = cfo.work(s[1], y)
        s[2], (y,) = pcs.apply(s[2], (y,), (y.shape[0],))
        s[3], y = costas.work(s[3], y)
        # angle-quadrant decision: u = floor(angle / (pi/2)) with the pi/4
        # offset — rotation ambiguity is +const, removed by diff decode
        ang = jnp.angle(y)  # (-pi, pi]
        u = jnp.floor(ang / (jnp.pi / 2)).astype(jnp.int32) % 4
        s[4], sym = dd.work(s[4], u.astype(jnp.int8))
        return s, sym

    return init_state, step


def make_qpsk_rx_feedforward(sps: int = 4, excess_bw: float = 0.35,
                             block: int = 1024):
    """Data-parallel QPSK receiver: FEEDFORWARD synchronization — no
    per-sample recurrences, so the whole chunk is one parallel program (the
    tracking-loop form in make_qpsk_rx mirrors the reference
    pfb_clock_sync/costas with one lax.scan step per symbol; this design is
    the parallel alternative, with the same differential-decode BER
    contract).

      1. RRC matched filter (banded matmul).
      2. Oerder&Meyr square-timing estimation per `block` samples:
         tau_b = -sps/(2*pi) * angle( sum_n |y[n]|^2 e^{-j 2 pi n / sps} ) —
         fully parallel; phase-unwrapped across blocks, linearly
         interpolated within a block so slow SRO is tracked.
      3. Symbol sampling at k*sps + tau(k) via parallel linear interp.
      4. Viterbi&Viterbi carrier estimation per block:
         theta_b = (1/4) angle( sum y^4 ) (unwrapped) — handles CFO small
         enough that the phase moves < pi/4 per block (like a Costas pull-in
         range); differential decode removes the pi/2 ambiguity.

    Returns (init_state, step): step(state, iq[(n,) c64]) -> (state,
    sym_idx[(n/sps,) int8])."""
    mf = rrc_taps(sps, excess_bw) / sps
    T = len(mf)
    dd = DiffDecoder(4)
    from ..kernels.fir_xla import fir_apply

    def init_state():
        return {"tail": jnp.zeros(T - 1, jnp.complex64),
                "tau_prev": jnp.zeros((), jnp.float32),
                "th_prev": jnp.zeros((), jnp.float32),
                "dd": dd.init_state()}

    def step(state, x):
        n = x.shape[0]
        nb = n // block
        xp = jnp.concatenate([state["tail"], x])
        tail = xp[xp.shape[0] - (T - 1):]
        y = fir_apply(xp, jnp.asarray(mf), 1)            # (n,) matched
        yb = y[: nb * block].reshape(nb, block)
        # -- O&M square timing per block --
        ph = jnp.exp(-2j * jnp.pi * (jnp.arange(block) % sps) / sps
                     ).astype(jnp.complex64)
        S = jnp.sum((jnp.abs(yb) ** 2).astype(jnp.complex64) * ph[None, :],
                    axis=1)
        tau = -sps / (2 * jnp.pi) * jnp.angle(S)          # (nb,) in [-2, 2)
        # unwrap mod sps against the previous block's estimate
        tau_seq = jnp.concatenate([state["tau_prev"][None], tau])
        dtau = tau_seq[1:] - tau_seq[:-1]
        dtau = dtau - sps * jnp.round(dtau / sps)
        tau_u = state["tau_prev"] + jnp.cumsum(dtau)      # continuous
        # -- symbol sampling at k*sps + tau(block), PHASE-DECOMPOSED:
        # sample index b*block + o_b + m*sps lives in polyphase column
        # (o_b mod sps) at row shift o_b//sps. Instead of a flat y[i0]
        # gather or a per-block dynamic_slice scan (8192 sequential light
        # iterations), this form is all static
        # strided views: per-block COLUMN choice is a sps-way one-hot
        # broadcast-sum, per-block ROW shift a small one-hot accumulate
        # over shifted flat views — no gathers, no scan.
        #
        # Re-centering is per GROUP of G blocks (r4): a single chunk-wide
        # midpoint bounded the residual window to ±RMAX*sps for the WHOLE
        # chunk, which silently mis-timed outer blocks once SRO drift
        # exceeded ~RMAX*sps (advisor r3 finding). Per-group vmapped
        # dynamic_slice re-centers every G blocks, so the one-hot window
        # only has to cover intra-group drift (G*block samples * SRO;
        # 100 ppm over G=32 blocks of 1024 is ~3.3 samples << RMAX*sps)
        # plus estimator noise.
        spb = block // sps
        o_b = jnp.floor(tau_u).astype(jnp.int32)
        frac_b = (tau_u - o_b.astype(jnp.float32)).astype(jnp.complex64)
        RMAX = 4                      # residual row shifts in [-RMAX, RMAX]
        G = min(32, nb)               # blocks per re-center group
        ng = -(-nb // G)              # ceil
        nbp = ng * G
        # pad per-block offsets to a whole number of groups (edge repeat);
        # symbols from padded blocks are truncated after sampling
        o_p = jnp.concatenate([o_b, jnp.broadcast_to(o_b[-1], (nbp - nb,))])
        o_g = o_p.reshape(ng, G)[:, G // 2]             # group midpoints
        # PAD bounds the absolute group offset (|tau| stays ~ sps/2 +
        # intra-chunk drift thanks to the mod-sps re-anchor below; 2*block
        # of zero padding covers > 200 ppm SRO on a 2^23 chunk)
        PAD = 2 * block
        yp2 = jnp.concatenate([jnp.zeros(PAD, y.dtype), y,
                               jnp.zeros(PAD + (nbp - nb + 1) * block,
                                         y.dtype)])
        o_gc = jnp.clip(o_g, -(PAD - RMAX * sps), PAD - RMAX * sps)
        # one block of slack on the right: the halo slab trick below
        # slices a full second slab before truncating columns
        starts = (jnp.arange(ng) * (G * block) + o_gc + PAD - RMAX * sps)
        base = jax.vmap(
            lambda s: jax.lax.dynamic_slice(yp2, (s,),
                                            (G * block + block,)))(starts)
        # clip keeps every residual inside the one-hot window (outside it
        # no weight would fire and the block would silently zero)
        res = jnp.clip(o_p - jnp.repeat(o_gc, G),
                       -RMAX * sps, RMAX * sps - 2)

        # halo-extended block windows: ext4[b, m, c] = base-sample at
        # b*block + m*sps + c for m in [0, spb + 2*RMAX) — the halo keeps
        # row shifts inside the block (no cross-block reads of the wrong
        # column)
        HR = RMAX
        ext = jnp.concatenate(
            [base[:, : G * block].reshape(nbp, block),
             base[:, block: block + G * block].reshape(nbp, block)
             [:, : 2 * HR * sps]], axis=1)
        ext4 = ext.reshape(nbp, spb + 2 * HR, sps)
        frac_b = jnp.concatenate(
            [frac_b, jnp.broadcast_to(frac_b[-1], (nbp - nb,))])

        def polyphase_pick(shift_extra):
            """Symbol stream at per-block offset res (+shift_extra):
            1 fused column-select pass + (2R+1)-term within-block row
            shift, instead of a flat 36-way one-hot over block-wide
            views whose per-term full-base reads do not dedupe."""
            off = res + shift_extra + RMAX * sps        # in [0, 2*RMAX*sps]
            col = jnp.mod(off, sps)                     # (nb,) column
            row = off // sps                            # (nb,) row shift
            colw = (jnp.arange(sps)[None, :] == col[:, None]
                    ).astype(jnp.float32)               # (nbp, sps)
            zc = jnp.einsum("bmc,bc->bm", ext4, colw)   # (nbp, spb+2R)
            acc = jnp.zeros((nbp, spb), y.dtype)
            for r in range(2 * RMAX + 1):
                w = (row == r).astype(jnp.float32)[:, None]
                acc = acc + w * zc[:, r: r + spb]
            return acc

        s0 = polyphase_pick(0)
        s1 = polyphase_pick(1)
        sym = (s0 * (1 - frac_b[:, None])
               + s1 * frac_b[:, None]).reshape(-1)[: nb * spb]  # (n/sps,)
        # -- V&V carrier per block of symbols --
        spb = block // sps
        nsb = sym.shape[0] // spb
        s4 = (sym[: nsb * spb].reshape(nsb, spb)) ** 4
        th = jnp.angle(jnp.sum(s4, axis=1)) / 4.0         # (nsb,)
        th_seq = jnp.concatenate([state["th_prev"][None], th])
        dth = th_seq[1:] - th_seq[:-1]
        dth = dth - (jnp.pi / 2) * jnp.round(dth / (jnp.pi / 2))
        th_u = state["th_prev"] + jnp.cumsum(dth)
        # per-BLOCK phasor broadcast (nsb sincos, not one per symbol via
        # jnp.repeat + per-symbol exp)
        rot = jnp.exp(-1j * th_u)[:, None]                # (nsb, 1)
        corr = sym[: nsb * spb].reshape(nsb, spb) * rot
        # -- decide + differential decode (angle-domain, see _ANGLE_PTS).
        # After V&V correction the points sit at u*pi/2 + const, i.e. mid-
        # bin for a ROUND quantizer; the constant cancels in diff decode.
        # Quadrant decision by sign/magnitude compares — no atan2 --
        cr, ci = jnp.real(corr).reshape(-1), jnp.imag(corr).reshape(-1)
        re_major = jnp.abs(cr) >= jnp.abs(ci)
        u = jnp.where(re_major,
                      jnp.where(cr >= 0, 0, 2),
                      jnp.where(ci >= 0, 1, 3)).astype(jnp.int32)
        dd_s, out = dd.work(state["dd"], u.astype(jnp.int8))
        # Re-anchor the carried absolute offsets at the chunk boundary so
        # they never grow without bound under SRO/CFO (advisor r3): the
        # next chunk's unwrap only uses these modulo sps (resp. pi/2) —
        # dtau is folded into (-sps/2, sps/2] regardless — and the decision
        # path is invariant to whole-symbol / whole-quadrant shifts (diff
        # decode absorbs the constant). Without this, tau_prev/th_prev
        # accumulate until f32 precision (and the PAD clip) break.
        tau_a = tau_u[-1] - sps * jnp.round(tau_u[-1] / sps)
        th_a = th_u[-1] - (jnp.pi / 2) * jnp.round(th_u[-1] / (jnp.pi / 2))
        return ({"tail": tail, "tau_prev": tau_a, "th_prev": th_a,
                 "dd": dd_s}, out)

    return init_state, step


def make_qpsk_rx_tracking_multichannel(nchan: int, sps: int = 4,
                                       excess_bw: float = 0.35,
                                       timing_bw: float = 2 * math.pi / 100,
                                       costas_bw: float = 2 * math.pi / 100):
    """Closed-loop tracking receiver over N parallel channels — the data-parallel
    answer to the reference's per-symbol symbol_sync/costas hot loop
    (gr-digital/lib/symbol_sync_cc_impl.cc:389-470): channels ride the lane
    axis, one scan step per SYMBOL serves all channels
    (ops/multichannel_sync.py). The natural producer of the channel axis is
    the PFB channelizer (models/channelize.py).

    Returns (init_state, step): step(state, x[(n, C) c64]) -> (state,
    sym_idx[(K, C) int8]) — decided, differentially decoded."""
    from ..kernels.fir_xla import fir_apply_batched
    from ..ops.multichannel_sync import MultiChannelTracker

    mf = (rrc_taps(sps, excess_bw) / sps).astype(np.float32)
    T = len(mf)
    trk = MultiChannelTracker(nchan, sps, timing_bw, costas_bw)

    def init_state():
        return {"tail": jnp.zeros((T - 1, nchan), jnp.complex64),
                "trk": trk.init_state(),
                "prev_u": jnp.zeros((nchan,), jnp.int8)}

    def step(state, x):
        xp = jnp.concatenate([state["tail"], x], axis=0)
        tail = xp[xp.shape[0] - (T - 1):]
        y = fir_apply_batched(jnp.transpose(xp), jnp.asarray(mf), 1)
        y = jnp.transpose(y)                       # (n, C) matched-filtered
        trk_s, z = trk.step(state["trk"], y)       # (K, C) soft symbols
        ang = jnp.angle(z)
        u = jnp.floor(ang / (jnp.pi / 2)).astype(jnp.int8) % 4
        up = jnp.concatenate([state["prev_u"][None], u], axis=0)
        d = (up[1:] - up[:-1]) % 4                 # differential decode
        return {"tail": tail, "trk": trk_s, "prev_u": u[-1]}, d.astype(jnp.int8)

    return init_state, step


def make_qpsk_rx_tracking_blockparallel(sps: int = 4, nblocks: int = 256,
                                        overlap_syms: int = 192,
                                        excess_bw: float = 0.35):
    """Single-stream tracking-loop receiver at lane-parallel speed: matched
    filter, then block-parallel Gardner+Costas tracking
    (ops/multichannel_sync.block_parallel_tracker — feedforward-seeded
    segments, pi/2 ambiguity stitched in the overlap), then differential
    decode. Per-call form (stateless across calls: each chunk is
    self-seeding, like a burst receiver): run(x[(n,) c64]) ->
    sym_idx[(n//sps,) int8]."""
    from ..kernels.fir_xla import fir_apply
    from ..ops.multichannel_sync import block_parallel_tracker

    mf = (rrc_taps(sps, excess_bw) / sps).astype(np.float32)
    T = len(mf)
    track = block_parallel_tracker(sps, nblocks, overlap_syms)

    def run(x):
        xp = jnp.concatenate([jnp.zeros(T - 1, x.dtype), x])
        y = fir_apply(xp, jnp.asarray(mf), 1)
        z = track(y)
        ang = jnp.angle(z)
        u = jnp.floor(ang / (jnp.pi / 2)).astype(jnp.int32) % 4
        d = (u[1:] - u[:-1]) % 4
        return d.astype(jnp.int8)

    return run


def ber_after_alignment(rx_sym: np.ndarray, tx_sym: np.ndarray,
                        skip: int = 100, max_lag: int = 64):
    """Search symbol lag + QPSK phase rotation ambiguity; return best BER.
    (Costas locks modulo pi/2; differential decoding makes the data
    rotation-invariant except for a constant index offset per rotation.)"""
    rx = np.asarray(rx_sym).astype(np.int64)[skip:]
    best = 1.0
    for lag in range(max_lag):
        t = tx_sym[skip - 0:][: len(rx) - lag] if lag else tx_sym[skip:][: len(rx)]
        r = rx[lag: lag + len(t)]
        if len(t) < 100:
            continue
        m = min(len(t), len(r))
        errs = np.count_nonzero(r[:m] != t[:m])
        best = min(best, errs / m)
    return best
