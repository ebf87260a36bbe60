"""gr-digital equalizers: linear + decision-feedback with adaptive
algorithms (CMA / LMS / NLMS).

Reference parity:
  include/gnuradio/digital/adaptive_algorithm{,_cma,_lms,_nlms}.h —
      error_dd/error_tr + update_taps conventions:
      LMS:  taps += mu * conj(in) * err
      NLMS: taps += mu * conj(in) * err / ||in||^2
      CMA:  err = y * (modulus - |y|^2); taps += mu * conj(in) * err
  lib/linear_equalizer_impl.cc — sps-spaced FIR whose taps adapt every
      symbol (training sequence or decision-directed)
  lib/decision_feedback_equalizer_impl.cc — feedforward + feedback taps
  legacy: cma_equalizer_cc, lms_dd_equalizer_cc.

Design: tap adaptation is a true per-symbol recurrence -> lax.scan with
the tap vector as carry. Each scan step does an 8-to-64-tap dot product on
vector lanes; symbol rates make this cheap relative to the front-end kernels.
Decision device = nearest constellation point (vectorized gather).
"""
from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block
from ..core.stream import PortSpec, C


class _AdaptiveFilter:
    """Shared scan core: window dot + error fn + tap update."""

    def __init__(self, num_taps, mu, algorithm, modulus=1.0, points=None):
        self.num_taps = int(num_taps)
        self.mu = float(mu)
        self.alg = algorithm
        self.modulus = float(modulus)
        self.points = (np.asarray(points, np.complex64) if points is not None
                       else np.array([1 + 0j, -1 + 0j], np.complex64))

    def init_taps(self):
        t = np.zeros(self.num_taps, np.complex64)
        t[self.num_taps // 2] = 1.0  # center spike init
        return jnp.asarray(t)

    def _decide(self, y):
        pts = jnp.asarray(self.points)
        return pts[jnp.argmin(jnp.abs(y - pts))]

    def _error(self, y, desired):
        if self.alg == "cma":
            return y * (self.modulus - jnp.abs(y) ** 2)
        return desired - y

    def step(self, taps, window, training=None):
        """One symbol: returns (new_taps, y, e)."""
        y = jnp.sum(taps * window)
        desired = self._decide(y) if training is None else training
        e = self._error(y, desired)
        if self.alg == "nlms":
            norm = jnp.maximum(jnp.sum(jnp.abs(window) ** 2), 1e-12)
            upd = self.mu * jnp.conj(window) * e / norm
        else:
            upd = self.mu * jnp.conj(window) * e
        return taps + upd, y, e


class LinearEqualizer(Block):
    """linear_equalizer: adaptive sps-spaced FIR. Consumes sps inputs per
    output symbol; taps adapt decision-directed (or vs a repeating training
    sequence when given)."""

    def __init__(self, num_taps: int, sps: int, algorithm: str = "lms",
                 mu: float = 0.01, modulus: float = 1.0, points=None,
                 training_sequence=None, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(C),)
        # output 1: current tap vector per symbol (the reference's
        # optional taps output, linear_equalizer.h make(..., num_taps))
        self.out_ports = (PortSpec(C), PortSpec(C, int(num_taps)))
        self.sps = int(sps)
        self.af = _AdaptiveFilter(num_taps, mu, algorithm, modulus, points)
        self.training = (np.asarray(training_sequence, np.complex64)
                         if training_sequence is not None else None)
        if self.training is not None and self.training.size == 0:
            self.training = None       # empty sequence = decision-directed

    @property
    def in_rates(self):
        return (Fraction(self.sps),)

    @property
    def out_rates(self):
        return (Fraction(1), Fraction(1))

    def init_state(self):
        st = {"taps": self.af.init_taps(),
              "tail": jnp.zeros(self.af.num_taps - 1, C)}
        if self.training is not None:
            st["tidx"] = jnp.int32(0)
        return st

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        n_out = x.shape[0] // self.sps
        xp = jnp.concatenate([state["tail"], x])
        nt = self.af.num_taps

        if self.training is not None:
            # train over the first len(training) symbols, then switch to
            # decision-directed (the reference trains between training-start
            # tags; one leading burst is the untagged equivalent)
            tr = jnp.asarray(self.training)
            ntr = tr.shape[0]

            def step(carry, k):
                taps, tidx = carry
                win = jax.lax.dynamic_slice(xp, (k * self.sps,), (nt,))
                y0 = jnp.sum(taps * win)
                desired = jnp.where(tidx < ntr, tr[jnp.minimum(tidx, ntr - 1)],
                                    self.af._decide(y0))
                taps, y, e = self.af.step(taps, win, desired)
                return (taps, tidx + 1), (y, taps)

            (taps, tidx), (y, tap_hist) = jax.lax.scan(
                step, (state["taps"], state["tidx"]), jnp.arange(n_out))
            new = {"taps": taps, "tidx": tidx}
        else:
            def step(taps, k):
                win = jax.lax.dynamic_slice(xp, (k * self.sps,), (nt,))
                taps, y, e = self.af.step(taps, win)
                return taps, (y, taps)

            taps, (y, tap_hist) = jax.lax.scan(
                step, state["taps"], jnp.arange(n_out))
            new = {"taps": taps}
        new["tail"] = xp[xp.shape[0] - (nt - 1):]
        return new, (y.astype(C), tap_hist.astype(C))


def linear_equalizer(num_taps, sps, algorithm="lms", mu=0.01, modulus=1.0,
                     points=None, training_sequence=None):
    return LinearEqualizer(num_taps, sps, algorithm, mu, modulus, points,
                           training_sequence)


def cma_equalizer_cc(num_taps, modulus, mu, sps=1):
    """Legacy cma_equalizer_cc facade."""
    return LinearEqualizer(num_taps, sps, "cma", mu, modulus)


def lms_dd_equalizer_cc(num_taps, mu, sps=1, points=None):
    """Legacy lms_dd_equalizer_cc facade."""
    return LinearEqualizer(num_taps, sps, "lms", mu, points=points)


class DecisionFeedbackEqualizer(Block):
    """decision_feedback_equalizer: feedforward FIR over received samples +
    feedback FIR over past decisions; both adapt."""

    def __init__(self, num_taps_fwd: int, num_taps_fb: int, sps: int,
                 algorithm: str = "lms", mu: float = 0.01,
                 modulus: float = 1.0, points=None,
                 training_sequence=None, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(C),)
        # output 1: concatenated [fwd taps | fb taps] per symbol (the
        # reference's optional taps output)
        self.out_ports = (PortSpec(C),
                          PortSpec(C, int(num_taps_fwd) + int(num_taps_fb)))
        self.sps = int(sps)
        self.nf, self.nb = int(num_taps_fwd), int(num_taps_fb)
        self.af = _AdaptiveFilter(self.nf, mu, algorithm, modulus, points)
        self.mu = float(mu)
        self.training = (np.asarray(training_sequence, np.complex64)
                         if training_sequence is not None else None)

    @property
    def in_rates(self):
        return (Fraction(self.sps),)

    @property
    def out_rates(self):
        return (Fraction(1), Fraction(1))

    def init_state(self):
        st = {"ftaps": self.af.init_taps(),
              "btaps": jnp.zeros(self.nb, C),
              "dec_hist": jnp.zeros(self.nb, C),
              "tail": jnp.zeros(self.nf - 1, C)}
        if self.training is not None:
            st["tidx"] = jnp.int32(0)
        return st

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        n_out = x.shape[0] // self.sps
        xp = jnp.concatenate([state["tail"], x])
        nf, nb = self.nf, self.nb
        tr = jnp.asarray(self.training) if self.training is not None else None

        def step(carry, k):
            ftaps, btaps, dh, tidx = carry
            win = jax.lax.dynamic_slice(xp, (k * self.sps,), (nf,))
            y = jnp.sum(ftaps * win) - jnp.sum(btaps * dh)
            if tr is not None:
                ntr = tr.shape[0]
                d = jnp.where(tidx < ntr, tr[jnp.minimum(tidx, ntr - 1)],
                              self.af._decide(y))
                tidx = tidx + 1
            else:
                d = self.af._decide(y)
            e = self.af._error(y, d)
            if self.af.alg == "nlms":
                norm = jnp.maximum(jnp.sum(jnp.abs(win) ** 2) +
                                   jnp.sum(jnp.abs(dh) ** 2), 1e-12)
                ftaps = ftaps + self.mu * jnp.conj(win) * e / norm
                btaps = btaps - self.mu * jnp.conj(dh) * e / norm
            else:
                ftaps = ftaps + self.mu * jnp.conj(win) * e
                btaps = btaps - self.mu * jnp.conj(dh) * e
            dh = jnp.concatenate([d[None], dh[:-1]])
            return (ftaps, btaps, dh, tidx), (y, jnp.concatenate(
                [ftaps, btaps]))

        tidx0 = state.get("tidx", jnp.int32(0))
        (ftaps, btaps, dh, tidx), (y, tap_hist) = jax.lax.scan(
            step, (state["ftaps"], state["btaps"], state["dec_hist"], tidx0),
            jnp.arange(n_out))
        new = {"ftaps": ftaps, "btaps": btaps, "dec_hist": dh,
               "tail": xp[xp.shape[0] - (nf - 1):]}
        if self.training is not None:
            new["tidx"] = tidx
        return new, (y.astype(C), tap_hist.astype(C))


def decision_feedback_equalizer(num_taps_fwd, num_taps_fb, sps,
                                algorithm="lms", mu=0.01, modulus=1.0,
                                points=None, training_sequence=None):
    return DecisionFeedbackEqualizer(num_taps_fwd, num_taps_fb, sps,
                                     algorithm, mu, modulus, points,
                                     training_sequence)
