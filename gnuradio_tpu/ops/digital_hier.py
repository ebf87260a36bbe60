"""gr-digital Python mod/demod hier blocks (round-4 catalog fills):
constellation_modulator, psk_mod/demod, qam_mod/demod, gfsk_mod/demod,
gmsk_mod/demod.

Reference behavior (reimplemented from the hier wiring, not copied):
  gr-digital/python/digital/generic_mod_demod.py:123-155 (mod) —
      packed bytes -> unpack(bits/sym) -> map_bb(pre_diff) -> diff encode
      -> chunks_to_symbols -> RRC pulse shaping at sps
  generic_mod_demod.py:269-314 (demod) — agc2(0.6e-1) -> fll_band_edge ->
      pfb_clock_sync(RRC matched filter) -> costas -> constellation decode
      -> diff decode -> inverse map -> unpack->bits
  gr-digital/python/digital/psk.py / qam.py — gray-coded point sets
  gr-digital/python/digital/gfsk.py / gmsk.py — NRZ bits -> gaussian
      shaping -> FM (mod); quad demod -> M&M clock recovery -> slicer.
"""
from __future__ import annotations

import math

import numpy as np

import jax.numpy as jnp

from ..core.block import SyncBlock
from ..core.hier import HierBlock
from ..core.stream import PortSpec, B, C, F
from . import firdes
from .digital import (ChunksToSymbols, Constellation, DiffDecoder,
                      DiffEncoder, MapBB, constellation_qpsk, map_bb,
                      pack_k_bits_bb, unpack_k_bits_bb)


def _gray(n: int) -> int:
    return n ^ (n >> 1)


def psk_constellation(m: int) -> Constellation:
    """Gray-coded m-PSK (psk.py psk_constellation). Points are stored in
    ANGULAR order (point k at angle 2 pi k/m) and pre_diff_code maps the
    gray bit-label to its angular index — so differential encoding runs on
    angular indices, where a carrier-lock rotation is a CONSTANT offset
    that the differential decode cancels (the same role pre_diff_code
    plays in the reference's constellation.h)."""
    inv_gray = np.argsort([_gray(k) for k in range(m)])
    # points sit at the costas_loop order-m STABLE phases (zero detector
    # error): pi/m offset for m=4 (diagonals — the reference's
    # +-0.707+-0.707j QPSK) and m=8 (the order-8 detector's K=sqrt(2)-1
    # zeros are at pi/8 + k pi/4), real axis for BPSK — otherwise the lock
    # point lands every symbol on a decision boundary
    off = np.pi / m if m in (4, 8) else 0.0
    pts = [np.exp(1j * (2 * np.pi * k / m + off)) for k in range(m)]
    return Constellation(pts, pre_diff_code=list(inv_gray),
                         rotational_symmetry=m)


def qam_constellation(m: int) -> Constellation:
    """Gray-per-axis square QAM (qam.py)."""
    side = int(round(math.sqrt(m)))
    assert side * side == m, "square QAM only"
    bps_axis = int(round(math.log2(side)))
    levels = np.arange(side) * 2 - (side - 1)
    norm = math.sqrt((levels ** 2).mean() * 2)
    pts = [0j] * m
    for i in range(side):
        for q in range(side):
            sym = (_gray(i) << bps_axis) | _gray(q)
            pts[sym] = complex(levels[i], levels[q]) / norm
    return Constellation(pts, rotational_symmetry=4)


def _rrc(sps, excess_bw, ntaps=None, gain=None, nfilts=1):
    if ntaps is None:
        ntaps = 11 * sps * nfilts
    if gain is None:
        gain = sps
    return firdes.root_raised_cosine(gain, sps * nfilts, 1.0, excess_bw,
                                     ntaps)


class GenericMod(HierBlock):
    """generic_mod (generic_mod_demod.py:123-155): packed bytes in ->
    pulse-shaped complex baseband out."""

    def __init__(self, constellation: Constellation, differential=True,
                 samples_per_symbol=2, excess_bw=0.35, name=None):
        super().__init__(name or "generic_mod",
                         in_ports=(PortSpec(B),), out_ports=(PortSpec(C),))
        from .filter import interp_fir_filter_ccf
        sps = int(samples_per_symbol)
        bps = int(constellation.bits_per_symbol)
        # packed_to_unpacked(bps) analog: bytes -> bits -> bps-bit symbols
        blocks = [unpack_k_bits_bb(8), pack_k_bits_bb(bps)]
        if constellation.pre_diff_code is not None:
            blocks.append(map_bb(list(constellation.pre_diff_code)))
        if differential:
            blocks.append(DiffEncoder(constellation.arity))
        blocks.append(ChunksToSymbols(np.asarray(constellation.points)))
        taps = _rrc(sps, excess_bw) / sps
        blocks.append(interp_fir_filter_ccf(sps, taps.astype(np.float32)))
        prev = (self, 0)
        for b in blocks:
            self.connect(prev, b)
            prev = b
        self.connect(prev, (self, 0))


class _ChunkNormalize(SyncBlock):
    """Chunk-feedforward magnitude normalizer: y = x * ref / mean|x|,
    smoothed across chunks — scale conditioning for the decision grid
    without a per-sample AGC recurrence."""

    def __init__(self, reference: float, smooth: float = 0.5, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.ref = float(reference)
        self.smooth = float(smooth)

    def init_state(self):
        return {"g": jnp.ones((), jnp.float32),
                "init": jnp.zeros((), jnp.bool_)}

    def work(self, state, x):
        m = jnp.maximum(jnp.mean(jnp.abs(x)), 1e-12)
        g_now = self.ref / m
        g = jnp.where(state["init"],
                      state["g"] + self.smooth * (g_now - state["g"]),
                      g_now).astype(jnp.float32)
        return ({"g": g, "init": jnp.ones((), jnp.bool_)},
                (x * g).astype(x.dtype))


class GenericDemod(HierBlock):
    """generic_demod (generic_mod_demod.py:269-314): complex baseband in
    -> unpacked bits out (one bit per byte)."""

    def __init__(self, constellation: Constellation, differential=True,
                 samples_per_symbol=2, excess_bw=0.35,
                 freq_bw=2 * math.pi / 100, timing_bw=2 * math.pi / 100,
                 phase_bw=2 * math.pi / 100, name=None):
        super().__init__(name or "generic_demod",
                         in_ports=(PortSpec(C),), out_ports=(PortSpec(B),))
        from .analog import agc2_cc
        from .digital import ConstellationDecoder
        from .digital_loops import CfoCorrector, CostasLoop, PfbClockSync
        sps = int(samples_per_symbol)
        bps = int(constellation.bits_per_symbol)
        nfilts = 32
        agc = agc2_cc(0.6e-1, 1e-3, 1, 1)
        # chunk x^M CFO acquisition takes fll_band_edge's role, exactly as
        # the QA'd flagship receiver does (models/qpsk.make_qpsk_rx) — the
        # feedback FLL is a per-sample scan that adds phase noise on clean
        # signals and costs one sequential scan step per sample
        fll = CfoCorrector(order=int(constellation.rotational_symmetry))
        # matched-filter bank taps exactly as the QA'd flagship receiver
        # builds them (models/qpsk.make_qpsk_rx: rrc at sampling_freq=sps,
        # gain=nfilts, 11*sps*nfilts taps)
        mf_taps = firdes.root_raised_cosine(
            nfilts, sps, 1.0, excess_bw, 11 * sps * nfilts) / sps
        pcs = PfbClockSync(float(sps), timing_bw,
                           mf_taps.astype(np.float32), nfilts)
        costas = CostasLoop(phase_bw, int(constellation.rotational_symmetry))
        dec = ConstellationDecoder(constellation)
        # re-normalize after the matched-filter bank to the constellation's
        # mean magnitude (chunk-feedforward: one reduction per step, no
        # per-sample recurrence): the costas detector error scales with
        # |z|^2 and the QAM decision grid is scale-sensitive
        ref_mag = float(np.mean(np.abs(np.asarray(constellation.points))))
        agc2 = _ChunkNormalize(ref_mag)
        blocks = [agc, fll, pcs, agc2, costas, dec]
        if differential:
            blocks.append(DiffDecoder(constellation.arity))
        if constellation.pre_diff_code is not None:
            inv = np.argsort(np.asarray(constellation.pre_diff_code))
            blocks.append(map_bb(list(inv)))
        blocks.append(unpack_k_bits_bb(bps))
        prev = (self, 0)
        for b in blocks:
            self.connect(prev, b)
            prev = b
        self.connect(prev, (self, 0))


def constellation_modulator(constellation, differential=True,
                            samples_per_symbol=2, excess_bw=0.35, **_):
    if isinstance(constellation, dict):
        constellation = constellation.get("obj") or constellation_qpsk()
    if not isinstance(constellation, Constellation):
        constellation = constellation_qpsk()
    return GenericMod(constellation, differential, samples_per_symbol,
                      excess_bw)


def constellation_demodulator(constellation, differential=True,
                              samples_per_symbol=2, excess_bw=0.35, **_):
    if not isinstance(constellation, Constellation):
        constellation = constellation_qpsk()
    return GenericDemod(constellation, differential, samples_per_symbol,
                        excess_bw)


def psk_mod(constellation_points=4, mod_code="gray", differential=True,
            samples_per_symbol=2, excess_bw=0.35, **_):
    return GenericMod(psk_constellation(int(constellation_points)),
                      differential, samples_per_symbol, excess_bw)


def psk_demod(constellation_points=4, mod_code="gray", differential=True,
              samples_per_symbol=2, excess_bw=0.35, **_):
    return GenericDemod(psk_constellation(int(constellation_points)),
                        differential, samples_per_symbol, excess_bw)


class QamDemodFeedforward(SyncBlock):
    """Feedforward QAM receiver: matched filter -> Oerder&Meyr square-law
    timing (modulation-independent, unlike the PSK-assuming decision TEDs)
    -> x^4 carrier estimate -> scale-conditioned nearest-point decision.
    Output is the symbol LABEL stream (one byte per symbol); carrier lock
    is modulo pi/2 (quadrant resolution belongs to the packet layer — same
    contract the reference's qam demod leaves to its differential quadrant
    bits). Chunk-feedforward like models/qpsk.make_qpsk_rx_feedforward."""

    def __init__(self, constellation: Constellation, samples_per_symbol=2,
                 excess_bw=0.35, name=None):
        super().__init__(PortSpec(C), PortSpec(B), name)
        self.c = constellation
        self.sps = int(samples_per_symbol)
        mf = _rrc(self.sps, excess_bw) / self.sps
        self.mf = np.asarray(mf, np.float32)
        self.output_multiple = 1

    @property
    def in_rates(self):
        from fractions import Fraction
        return (Fraction(self.sps),)

    @property
    def out_rates(self):
        from fractions import Fraction
        return (Fraction(1),)

    def init_state(self):
        return {"tail": jnp.zeros((len(self.mf) - 1,), C),
                "tau_prev": jnp.zeros((), jnp.float32),
                "th_prev": jnp.zeros((), jnp.float32),
                "init": jnp.zeros((), jnp.bool_)}

    def work(self, state, x):
        from ..kernels.fir_xla import fir_apply
        sps = self.sps
        n = x.shape[0]
        xp = jnp.concatenate([state["tail"], x])
        tail = xp[xp.shape[0] - (len(self.mf) - 1):]
        y = fir_apply(xp, jnp.asarray(self.mf), 1)
        # O&M square timing over the whole chunk, unwrapped mod sps
        # against the previous chunk so the symbol grid is continuous
        ph = jnp.exp(-2j * jnp.pi * (jnp.arange(n) % sps) / sps
                     ).astype(C)
        tau = (-sps / (2 * jnp.pi)
               * jnp.angle(jnp.sum(jnp.abs(y) ** 2 * ph)))
        dtau = tau - state["tau_prev"]
        dtau = dtau - sps * jnp.round(dtau / sps)
        tau_u = jnp.where(state["init"], state["tau_prev"] + dtau, tau)
        o = jnp.round(tau_u).astype(jnp.int32) % sps
        k = jnp.arange(n // sps)
        z = y[jnp.clip(k * sps + o, 0, n - 1)]
        # x^4 carrier + magnitude conditioning; the QAM fourth moment
        # E[a^4] has its own argument (pi for square grids), subtracted
        # before dividing by 4; the pi/2 ambiguity is unwrapped against
        # the previous chunk (only the FIRST chunk's quadrant is free)
        m4 = complex(np.sum(np.asarray(self.c.points) ** 4))
        th = (jnp.angle(jnp.sum(z ** 4)) - np.angle(m4)) / 4.0
        dth = th - state["th_prev"]
        dth = dth - (jnp.pi / 2) * jnp.round(dth / (jnp.pi / 2))
        th_u = jnp.where(state["init"], state["th_prev"] + dth, th)
        z = z * jnp.exp(-1j * th_u)
        pts = jnp.asarray(self.c.points)
        scale = jnp.mean(jnp.abs(pts)) / jnp.maximum(
            jnp.mean(jnp.abs(z)), 1e-12)
        z = z * scale
        d = jnp.abs(z[:, None] - pts[None, :]) ** 2
        new_state = {"tail": tail, "tau_prev": tau_u.astype(jnp.float32),
                     "th_prev": th_u.astype(jnp.float32),
                     "init": jnp.ones((), jnp.bool_)}
        return new_state, jnp.argmin(d, axis=1).astype(B)


def qam_mod(constellation_points=16, mod_code="gray", differential=False,
            samples_per_symbol=2, excess_bw=0.35, **_):
    """Square QAM runs NON-differential (gray per axis); the reference's
    differential-QAM quadrant coding is not reproduced — lock-ambiguity
    resolution belongs to the packet layer here (documented)."""
    return GenericMod(qam_constellation(int(constellation_points)),
                      False, samples_per_symbol, excess_bw)


class QamDemod(HierBlock):
    """qam demod hier: feedforward symbol recovery + bit unpack."""

    def __init__(self, constellation_points=16, samples_per_symbol=2,
                 excess_bw=0.35, name=None):
        super().__init__(name or "qam_demod",
                         in_ports=(PortSpec(C),), out_ports=(PortSpec(B),))
        c = qam_constellation(int(constellation_points))
        ff = QamDemodFeedforward(c, samples_per_symbol, excess_bw)
        up = unpack_k_bits_bb(int(c.bits_per_symbol))
        self.connect((self, 0), ff, up, (self, 0))


def qam_demod(constellation_points=16, mod_code="gray", differential=False,
              samples_per_symbol=2, excess_bw=0.35, **_):
    return QamDemod(constellation_points, samples_per_symbol, excess_bw)


class GfskMod(HierBlock):
    """gfsk_mod (gfsk.py): packed bytes -> NRZ -> gaussian shaping -> FM."""

    def __init__(self, samples_per_symbol=2, bt=0.35, sensitivity=None,
                 name=None, gaussian=True, L=4):
        super().__init__(name or "gfsk_mod",
                         in_ports=(PortSpec(B),), out_ports=(PortSpec(C),))
        from .blocks import complex_to_real
        from .misc_fills import gfsk_mod_blocks
        unpack = unpack_k_bits_bb(8)
        nrz = ChunksToSymbols(np.array([-1.0 + 0j, 1.0 + 0j], np.complex64))
        c2r = complex_to_real()
        shaper, fm = gfsk_mod_blocks(int(samples_per_symbol), bt,
                                     sensitivity)
        self.connect((self, 0), unpack, nrz, c2r, shaper, fm, (self, 0))


class GfskDemod(HierBlock):
    """gfsk_demod (gfsk.py): quad demod -> M&M clock recovery -> slicer."""

    def __init__(self, samples_per_symbol=2, sensitivity=None, name=None):
        super().__init__(name or "gfsk_demod",
                         in_ports=(PortSpec(C),), out_ports=(PortSpec(B),))
        from .misc_fills import gfsk_demod_blocks
        chain = gfsk_demod_blocks(int(samples_per_symbol), sensitivity)
        prev = (self, 0)
        for b in chain:
            self.connect(prev, b)
            prev = b
        self.connect(prev, (self, 0))


def gfsk_mod(samples_per_symbol=2, bt=0.35, sensitivity=None, **_):
    return GfskMod(samples_per_symbol, bt, sensitivity)


def gfsk_demod(samples_per_symbol=2, sensitivity=None, **_):
    return GfskDemod(samples_per_symbol, sensitivity)


class GmskMod(HierBlock):
    """gmsk_mod (gmsk.py): packed bytes -> gmskmod_bc CPM modulator."""

    def __init__(self, samples_per_symbol=2, bt=0.3, L=4, name=None):
        super().__init__(name or "gmsk_mod",
                         in_ports=(PortSpec(B),), out_ports=(PortSpec(C),))
        from .blocks import complex_to_real
        from .cpm import gmskmod_bc
        unpack = unpack_k_bits_bb(8)
        nrz = ChunksToSymbols(np.array([-1.0 + 0j, 1.0 + 0j], np.complex64))
        c2r = complex_to_real()
        shaper, fm = gmskmod_bc(int(samples_per_symbol), int(L), float(bt))
        self.connect((self, 0), unpack, nrz, c2r, shaper, fm, (self, 0))


def gmsk_mod(samples_per_symbol=2, bt=0.3, L=4, **_):
    return GmskMod(samples_per_symbol, bt, L)


def gmsk_demod(samples_per_symbol=2, **_):
    """gmsk_demod (gmsk.py): same structure as gfsk_demod (quad demod +
    M&M + slicer) with the GMSK sensitivity."""
    return GfskDemod(samples_per_symbol, None)
