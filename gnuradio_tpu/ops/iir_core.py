"""Linear recurrences without sequential loops.

Reference parity: gr::filter::single_pole_iir (include/gnuradio/filter/
single_pole_iir.h) and iir_filter (gr-filter/lib/iir_filter.cc) run per-sample
feedback loops on the CPU. A first-order linear recurrence
    y[n] = a * y[n-1] + d[n]
is associative under (A,B) composition, so on device we evaluate it with
jax.lax.associative_scan in O(log n) depth — fully parallel —
instead of an O(n) sequential scan. Bit-for-bit it differs from sequential
evaluation only by float reassociation, well inside the QA SNR bounds
(SURVEY.md §4 tolerances).

Higher-order IIRs are factored by the caller into cascaded first-order
sections (complex poles) or fall back to lax.scan.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def linear_recurrence(a, d, y0):
    """y[n] = a[n] * y[n-1] + d[n], y[-1] = y0. a may be scalar or (n,).

    Returns y (same shape as d). Complex or real.
    """
    n = d.shape[0]
    a = jnp.broadcast_to(jnp.asarray(a, d.dtype), (n,) + d.shape[1:])

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, ar * bl + br

    A, Bc = jax.lax.associative_scan(combine, (a, d), axis=0)
    return A * y0 + Bc


def first_order_iir(x, b0, a, y0):
    """y[n] = b0*x[n] + a*y[n-1]; returns (y, y_last)."""
    d = b0 * x
    y = linear_recurrence(a, d, y0)
    return y, y[-1]


def biquad_like_first_order(x, b0, b1, r, y0, x_prev):
    """y[n] = b0 x[n] + b1 x[n-1] + r y[n-1]  (add-convention feedback, the
    reference's internal form — gr-filter iir_filter.h:148-160 stores
    feedback taps so that y += fb[k]*y[n-k]).

    Returns (y, y_last, x_last)."""
    xm1 = jnp.concatenate([jnp.reshape(x_prev, (1,) + x.shape[1:]), x[:-1]], axis=0)
    d = b0 * x + b1 * xm1
    y = linear_recurrence(r, d, y0)
    return y, y[-1], x[-1]


def iir_df1_scan(x, fftaps, fbtaps, zi_x, zi_y):
    """General direct-form-I IIR via lax.scan (fallback for order >= 2).

    GR convention (gr-filter/lib/iir_filter.cc): y[n] = sum_k ff[k] x[n-k]
    + sum_{k>=1} fb[k] y[n-k], with fb[0] ignored (assumed 1 after
    normalization, and GR internally NEGATES user fbtaps[1:]... we take taps
    already in 'add' convention: y += fb[k]*y[n-k]).

    zi_x: (len(ff)-1,) previous inputs (newest first); zi_y: (len(fb)-1,)
    previous outputs (newest first). Returns (y, zi_x', zi_y').
    """
    ff = jnp.asarray(fftaps)
    fb = jnp.asarray(fbtaps)
    M = ff.shape[0] - 1
    N = fb.shape[0] - 1

    def step(carry, xn):
        px, py = carry  # newest-first
        xs = jnp.concatenate([xn[None], px]) if M else xn[None]
        acc = jnp.dot(ff, xs[: M + 1])
        if N:
            acc = acc + jnp.dot(fb[1:], py[:N])
        px2 = xs[:M] if M else px
        py2 = jnp.concatenate([acc[None], py])[:N] if N else py
        return (px2, py2), acc

    (zx, zy), y = jax.lax.scan(step, (zi_x, zi_y), x)
    return y.astype(x.dtype) if not jnp.iscomplexobj(ff) else y, zx, zy


def first_order_fir_taps(b0, b1, r, eps: float = 1e-9):
    """Truncated impulse response of y[n] = b0 x[n] + b1 x[n-1] + r y[n-1]:
    h[0] = b0, h[k>=1] = (b0 r + b1) r^(k-1), cut where |r|^K < eps. For
    stable poles this is EXACT to float32 well below QA tolerances and
    turns the recurrence into one FIR matmul — the associative_scan costs
    log-depth passes over device memory."""
    import numpy as np
    r = float(r)
    K = int(np.ceil(np.log(eps) / np.log(max(abs(r), 1e-12)))) + 2
    taps = np.zeros(max(K, 2), np.float64)
    taps[0] = b0
    taps[1:] = (b0 * r + b1) * (r ** np.arange(len(taps) - 1))
    return taps.astype(np.float32)
