"""Catalog strays — the last four Appendix-B names without a home
(VERDICT r02 missing #3 / next #9):

  * Regenerate            (gr-blocks/include/gnuradio/blocks/regenerate_bb.h:30,
                           lib/regenerate_bb_impl.cc work loop)
  * soft_dec_table_generator / soft_dec_table / calc_soft_dec[_from_table]
                          (gr-digital/python/digital/soft_dec_lut_gen.py:14)
  * TrellisSiso / TrellisSisoCombined
                          (gr-trellis siso_f / siso_combined_f,
                           include/gnuradio/trellis/siso_combined_f.h)
  * FirFilterWithBuffer   (gr-filter/include/gnuradio/filter/
                           fir_filter_with_buffer.h — kernel class with its
                           OWN sample history, used by blocks that can't
                           rely on scheduler history)
"""
from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, SyncBlock
from ..core.stream import PortSpec, B, C, F
from ..kernels.fir_xla import fir_apply
from .trellis import (FSM, TRELLIS_EUCLIDEAN, calc_metric, siso)


class Regenerate(SyncBlock):
    """regenerate_bb: after each input '1' trigger, emit `max_regen`
    regenerated pulses spaced `period` samples apart; a new trigger resets
    the cycle (lib/regenerate_bb_impl.cc work loop).

    Data-parallel form: the scalar countdown/regen_count recurrence depends
    only on the distance to the MOST RECENT trigger, so it vectorizes as a
    cummax over trigger positions — out[i] = 1 iff dist_i == 0 or
    (dist_i % period == 0 and dist_i/period <= max_regen). The carried
    state is one integer (distance since last trigger, saturated)."""

    def __init__(self, period: int = 10, max_regen: int = 500, name=None):
        super().__init__(PortSpec(B), PortSpec(B), name)
        self.period = int(period)
        self.max_regen = int(max_regen)

    def _sat(self):
        # any distance beyond this behaves identically (no more pulses)
        return self.period * (self.max_regen + 1)

    def init_state(self):
        return jnp.asarray(self._sat(), jnp.int32)

    def work(self, state, x):
        n = x.shape[0]
        idx = jnp.arange(n, dtype=jnp.int32)
        trig = x.astype(jnp.int32) == 1
        NEG = jnp.int32(-(1 << 30))
        last = jax.lax.cummax(jnp.where(trig, idx, NEG))
        dist = jnp.where(last >= 0, idx - last,
                         jnp.minimum(state + idx + 1, self._sat()))
        pulse = (jnp.mod(dist, self.period) == 0) & (
            dist // self.period <= self.max_regen)
        out = (pulse | (dist == 0)).astype(jnp.int8)
        new_dist = jnp.minimum(dist[-1], self._sat()) if n else state
        return new_dist, out


def regenerate_bb(period=10, max_regen=500):
    return Regenerate(period, max_regen)


class PeakDetector2(Block):
    """peak_detector2_fb (gr-blocks/lib/peak_detector2_fb_impl.cc): track a
    one-pole average; when in > avg*(1+threshold_factor_rise), search the
    next `look_ahead` samples for the max and emit a single 1 there.

    Runs as a per-sample lax.scan (control-rate block, like dpll_bb); the
    peak mark is scattered after the scan from the recorded window-end
    events. Deviation from the reference: a search window that straddles a
    chunk boundary marks its peak clamped into the chunk where the window
    ENDS (the reference stalls the stream instead); interior events are
    exact."""

    def __init__(self, threshold_factor_rise: float = 7.0,
                 look_ahead: int = 1000, alpha: float = 0.001, name=None):
        super().__init__(name)
        self.thr = float(threshold_factor_rise)
        self.look = int(look_ahead)
        self.alpha = float(alpha)
        self.in_ports = (PortSpec(F),)
        self.out_ports = (PortSpec(B), PortSpec(F))

    def init_state(self):
        return {"avg": jnp.zeros((), jnp.float32),
                "found": jnp.zeros((), jnp.bool_),
                "count": jnp.zeros((), jnp.int32),
                "peak_val": jnp.full((), -3.4e38, jnp.float32),
                "peak_off": jnp.zeros((), jnp.int32)}

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        n = x.shape[0]
        a = jnp.float32(self.alpha)
        look = self.look

        def step(c, ix):
            # faithful per-sample transcription of the C++ work-loop state
            # machine: the crossing sample is re-presented to the found
            # branch (the reference consumes only up to it), so its avg
            # updates TWICE and it opens the look_ahead window
            i, v = ix
            avg_nf = a * v + (1 - a) * c["avg"]
            crossed = (~c["found"]) & (v > avg_nf * (1.0 + self.thr))
            avg = jnp.where(c["found"], avg_nf,
                            jnp.where(crossed, a * v + (1 - a) * avg_nf,
                                      avg_nf))
            peak_val = jnp.where(crossed, v, c["peak_val"])
            peak_off = jnp.where(crossed, i, c["peak_off"])
            better = c["found"] & (v > c["peak_val"])
            peak_val = jnp.where(better, v, peak_val)
            peak_off = jnp.where(better, i, peak_off)
            count = jnp.where(crossed, 1,
                              jnp.where(c["found"], c["count"] + 1, 0))
            in_window = c["found"] | crossed
            done = in_window & (count >= look)
            mark = jnp.where(done, peak_off, -1)
            found = in_window & ~done
            return ({"avg": avg, "found": found, "count": count,
                     "peak_val": peak_val, "peak_off": peak_off},
                    (mark, avg))

        carry, (marks, avgs) = jax.lax.scan(
            step, state, (jnp.arange(n, dtype=jnp.int32), x))
        out = jnp.zeros(n, jnp.int8)
        pos = jnp.clip(marks, 0, n - 1)
        out = out.at[pos].add(jnp.where(marks >= 0, 1, 0).astype(jnp.int8))
        # window straddling the boundary: carry peak_off relative to the
        # next chunk start (clamped to 0)
        carry["peak_off"] = jnp.maximum(carry["peak_off"] - n, 0)
        return carry, (jnp.clip(out, 0, 1), avgs)


def peak_detector2_fb(threshold_factor_rise=7.0, look_ahead=1000,
                      alpha=0.001):
    return PeakDetector2(threshold_factor_rise, look_ahead, alpha)


# ---------------------------------------------------------------------------
# soft_dec_lut_gen (host-side utility, numpy — mirrors the reference's
# Python module; vectorized instead of per-point loops)
# ---------------------------------------------------------------------------

def calc_soft_dec(sample, constel, symbols, npwr=1):
    """LLR soft decisions for one complex sample against an arbitrary
    constellation (soft_dec_lut_gen.py:calc_soft_dec — including its
    exp(-dist/npwr) metric, which uses the distance, not distance^2).
    Returns k soft values, MSB first; >0 leans '1'."""
    constel = np.asarray(constel)
    symbols = np.asarray(symbols, np.int64)
    M = len(constel)
    k = int(math.log2(M))
    dist = np.abs(sample - constel)
    d = np.exp(-dist / npwr)
    s = np.zeros(k)
    for j in range(k):
        bit = (symbols >> j) & 1
        p1 = np.sum(d[bit == 1])
        p0 = np.sum(d[bit == 0])
        s[k - 1 - j] = np.log(p1) - np.log(p0)
    return list(s)


def soft_dec_table_generator(soft_dec_gen, prec, Es=1):
    """LUT of soft decisions over a 2^prec x 2^prec grid spanning
    [-Es*sqrt(2)/2, Es*sqrt(2)/2] on both axes, row-major from the bottom
    left (soft_dec_lut_gen.py:soft_dec_table_generator)."""
    npts = int(2.0 ** prec)
    maxd = Es * math.sqrt(2.0) / 2.0
    rng = np.linspace(-maxd, maxd, npts)
    return [soft_dec_gen(complex(x, y), Es) for y in rng for x in rng]


def soft_dec_table(constel, symbols, prec, npwr=1):
    """LUT built from calc_soft_dec with axis bounds from the constellation
    min/max (soft_dec_lut_gen.py:soft_dec_table)."""
    constel = np.asarray(constel)
    npts = int(2.0 ** prec)
    yrng = np.linspace(constel.imag.min(), constel.imag.max(), npts)
    xrng = np.linspace(constel.real.min(), constel.real.max(), npts)
    return [calc_soft_dec(complex(x, y), constel, symbols, npwr)
            for y in yrng for x in xrng]


def calc_soft_dec_from_table(sample, table, prec, Es=1.0):
    """Index the LUT at a sample's grid cell, clipping to alpha=0.99 of the
    span (soft_dec_lut_gen.py:calc_soft_dec_from_table)."""
    lut_scale = int(2.0 ** prec)
    maxd = Es * math.sqrt(2.0) / 2.0
    scale = lut_scale / (2.0 * maxd)
    alpha = 0.99
    xre = (maxd + min(alpha * maxd, max(-alpha * maxd, sample.real))) * scale
    xim = (maxd + min(alpha * maxd, max(-alpha * maxd, sample.imag))) * scale
    index = int(xre) + lut_scale * int(xim)
    max_index = lut_scale ** 2
    while index >= max_index:
        index -= lut_scale
    while index < 0:
        index += lut_scale
    return table[index]


def soft_llr_lut(constel, symbols, prec, npwr=1):
    """Device-side form: the soft_dec_table as a (2^prec, 2^prec, k) f32
    array + a jittable lookup(samples[(n,) c64]) -> (n, k) f32 — the LUT
    analog the reference bakes into constellation.cc soft decisions."""
    npts = int(2.0 ** prec)
    tab = np.asarray(soft_dec_table(constel, symbols, prec, npwr),
                     np.float32).reshape(npts, npts, -1)
    constel = np.asarray(constel)
    re_min, re_max = constel.real.min(), constel.real.max()
    im_min, im_max = constel.imag.min(), constel.imag.max()
    tj = jnp.asarray(tab)

    def lookup(x):
        xi = jnp.clip(((x.real - re_min) / (re_max - re_min) * (npts - 1)),
                      0, npts - 1).astype(jnp.int32)
        yi = jnp.clip(((x.imag - im_min) / (im_max - im_min) * (npts - 1)),
                      0, npts - 1).astype(jnp.int32)
        return tj[yi, xi]

    return tab, lookup


# ---------------------------------------------------------------------------
# trellis SISO blocks
# ---------------------------------------------------------------------------

class TrellisSiso(Block):
    """trellis.siso_f: two input streams (input-symbol priors [I/step],
    observation metrics [O/step]) -> posterior metrics, POSTI (I/step)
    and/or POSTO (O/step), per independent K-step block
    (gr-trellis/lib/siso_f_impl.cc; core_algorithms.cc siso_algorithm)."""

    def __init__(self, fsm: FSM, K: int, S0: int = 0, SK: int = -1,
                 posti: bool = True, posto: bool = False,
                 siso_type: str = "min_sum", name=None):
        super().__init__(name)
        if not (posti or posto):
            raise ValueError("Not both POSTI and POSTO can be false.")
        self.fsm, self.K, self.S0, self.SK = fsm, int(K), int(S0), int(SK)
        self.posti, self.posto = bool(posti), bool(posto)
        self.min_star = (siso_type == "sum_product")
        self.in_ports = (PortSpec(F), PortSpec(F))
        self.out_ports = (PortSpec(F),)
        mult = (fsm.I if posti else 0) + (fsm.O if posto else 0)
        self.mult = mult
        self.output_multiple = self.K * mult

    @property
    def in_rates(self):
        return (Fraction(self.fsm.I), Fraction(self.fsm.O))

    @property
    def out_rates(self):
        return (Fraction(self.mult),)

    def _run_blocks(self, pri, prio):
        nblk = pri.shape[0] // (self.K * self.fsm.I)
        pri = pri.reshape(nblk, self.K, self.fsm.I)
        prio = prio.reshape(nblk, self.K, self.fsm.O)

        def one(pi_, po_):
            return siso(self.fsm, pi_, po_, self.S0, self.SK,
                        self.posti, self.posto, self.min_star)

        res = jax.vmap(one)(pri, prio)
        if self.posti and self.posto:
            pi_post, po_post = res
            out = jnp.concatenate(
                [pi_post.reshape(nblk, -1), po_post.reshape(nblk, -1)],
                axis=1)
        else:
            out = res.reshape(nblk, -1)
        return out.reshape(-1)

    def apply(self, state, inputs, n_in):
        return state, (self._run_blocks(inputs[0], inputs[1]),)


class TrellisSisoCombined(TrellisSiso):
    """trellis.siso_combined_f: observations in (D floats/step) instead of
    precomputed metrics; fuses calc_metric(TABLE, TYPE) + SISO
    (include/gnuradio/trellis/siso_combined_f.h, impl general_work)."""

    def __init__(self, fsm: FSM, K: int, S0: int, SK: int, posti: bool,
                 posto: bool, siso_type: str, D: int, table,
                 metric_type=TRELLIS_EUCLIDEAN, in_dtype=F, name=None):
        super().__init__(fsm, K, S0, SK, posti, posto, siso_type, name)
        self.D = int(D)
        self.table = np.asarray(table).reshape(fsm.O, self.D)
        self.metric_type = metric_type
        self.in_ports = (PortSpec(F), PortSpec(in_dtype))

    @property
    def in_rates(self):
        return (Fraction(self.fsm.I), Fraction(self.D))

    def apply(self, state, inputs, n_in):
        prio = calc_metric(inputs[1], self.table, self.fsm.O, self.D,
                           self.metric_type).reshape(-1)
        return state, (self._run_blocks(inputs[0], prio),)


def siso_f(fsm, K, S0=0, SK=-1, posti=True, posto=False,
           siso_type="min_sum"):
    return TrellisSiso(fsm, K, S0, SK, posti, posto, siso_type)


def siso_combined_f(fsm, K, S0, SK, posti, posto, siso_type, D, table,
                    metric_type=TRELLIS_EUCLIDEAN):
    return TrellisSisoCombined(fsm, K, S0, SK, posti, posto, siso_type, D,
                               table, metric_type)


# ---------------------------------------------------------------------------
# fir_filter_with_buffer
# ---------------------------------------------------------------------------

class FirFilterWithBuffer:
    """Kernel-class analog of gr::filter::kernel::fir_filter_with_buffer
    (gr-filter/include/gnuradio/filter/fir_filter_with_buffer.h): an FIR
    that owns its OWN sample history instead of relying on scheduler
    history. In this framework every filter already carries its tail
    (core/block.py state contract), so this class is the explicit
    stand-alone form: construct once, call filter()/filterNdec() on
    successive chunks, state carries across calls.

    Functional: the carried buffer is returned/consumed explicitly
    (filter(state, x) -> (state, y)) so it composes under jit."""

    def __init__(self, taps, decimation: int = 1, complex_data: bool = True):
        self.taps = np.asarray(taps)
        self.decim = int(decimation)
        self.ntaps = len(self.taps)
        self.complex_data = bool(complex_data)

    def init_state(self):
        dt = jnp.complex64 if self.complex_data else jnp.float32
        return jnp.zeros(self.ntaps - 1, dt)

    def filter(self, state, x):
        """Chunk in -> (new_state, filtered chunk), decimated by `decim`."""
        xp = jnp.concatenate([state, x])
        tail = xp[xp.shape[0] - (self.ntaps - 1):] if self.ntaps > 1 else state
        y = fir_apply(xp, jnp.asarray(self.taps), self.decim)
        return tail, y

    def filterNdec(self, state, x, decim: int):
        xp = jnp.concatenate([state, x])
        tail = xp[xp.shape[0] - (self.ntaps - 1):] if self.ntaps > 1 else state
        return tail, fir_apply(xp, jnp.asarray(self.taps), decim)
