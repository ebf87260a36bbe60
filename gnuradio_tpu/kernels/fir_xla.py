"""FIR kernels — banded-Toeplitz matmul formulation.

Reference parity: gr::filter::kernel::fir_filter<IN,OUT,TAP>
(gr-filter/lib/fir_filter.cc:22-182). The reference dispatches VOLK SIMD dot
products per output item with per-alignment tap copies (:62-80,129-182).

Mapping: a 1-channel lax.conv has no contraction dimension for a matrix
unit, so the filter is expressed as ONE matmul:

    y[m*B + b] = sum_i  F[m, i] * W[i, b]

where F is the signal cut into M overlapping frames of length
L = (B-1)*decim + T (hop = B*decim) and W is the (L, B) banded tap matrix
W[i, b] = w[i - b*decim] (w = reversed taps, zero outside [0, T)).  B is
128 outputs per frame, scaled up for long taps so the L/(B*decim) FLOP
overcompute stays <= ~2x.  Frames are built from pure reshapes/slices of
shifted copies (no gather).  Complex arithmetic is decomposed into real
matmuls (re/im as a leading batch axis).

Convention: `taps` are in the user's conventional convolution order, i.e.
y[k] = sum_j taps[j] * x[k*decim - j] with the history (ntaps-1 items)
already prepended to `xp` by the caller (CarryTail), matching the reference's
internally-reversed tap storage + history discipline (fir_filter.cc:50-60,
block.h:82-91).

Precision: HIGHEST forces true-f32 products and accumulation. The reference
accumulates in f32 SIMD (VOLK); reduced-precision matmul (bf16 or TF32
operands) is a separate numerical question against the QA SNR bounds, so
every dot here asks for HIGHEST.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_B = 128   # outputs per frame (before scaling for long taps)


def _frame(xp, M: int, hop: int, L: int):
    """Cut 1-D xp into M overlapping frames: F[m, :] = xp[m*hop : m*hop+L].

    Built from ceil(L/hop) shifted reshapes — no gather. xp is zero-padded
    so every slab slice is in range.
    """
    nslabs = -(-L // hop)
    need = (nslabs - 1) * hop + M * hop
    xp = jnp.pad(xp, (0, max(0, need - xp.shape[0])))
    slabs = [
        lax.dynamic_slice_in_dim(xp, s * hop, M * hop).reshape(M, hop)
        for s in range(nslabs)
    ]
    return jnp.concatenate(slabs, axis=1)[:, :L] if nslabs > 1 else slabs[0][:, :L]


def _band_matrix(w, T: int, L: int, B: int, decim: int):
    """W[i, b] = w[i - b*decim] if 0 <= i - b*decim < T else 0,  shape (L, B)."""
    if isinstance(w, np.ndarray) or not isinstance(w, jax.core.Tracer):
        # concrete taps: build on host, becomes an XLA constant
        wn = np.asarray(w)
        Wm = np.zeros((L, B), wn.dtype)
        for b in range(B):
            Wm[b * decim:b * decim + T, b] = wn
        return jnp.asarray(Wm)
    i = jnp.arange(L)[:, None] - jnp.arange(B)[None, :] * decim
    valid = (i >= 0) & (i < T)
    return jnp.where(valid, w[jnp.clip(i, 0, T - 1)], 0)


def _fir_real(xp_parts, w, decim: int, n_out: int):
    """Core real matmul FIR.

    xp_parts: (P, n_in + T - 1) float32 — P signal components sharing taps
    w       : (T,) float32 reversed taps
    returns : (P, n_out) float32
    """
    T = w.shape[0]
    # scale the output tile so FLOP overcompute L/(B*decim) stays bounded
    B = _B * max(1, -(-T // (_B * decim)))
    M = -(-n_out // B)
    hop = B * decim
    L = (B - 1) * decim + T
    P = xp_parts.shape[0]
    F = jax.vmap(lambda x: _frame(x, M, hop, L))(xp_parts)  # (P, M, L)
    W = _band_matrix(w, T, L, B, decim).astype(jnp.float32)
    Y = lax.dot_general(
        F.astype(jnp.float32), W,
        dimension_numbers=(((2,), (0,)), ((), ())),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # (P, M, B)
    return Y.reshape(P, M * B)[:, :n_out]


def fir_apply(xp, taps, decim: int = 1):
    """Apply an FIR to a padded 1-D signal.

    xp   : (n_in + ntaps - 1,) float32 or complex64, history prepended
    taps : (ntaps,) float32 or complex64
    out  : (n_in // decim,) — y[k] = sum_j taps[j] * xp[(T-1) + k*decim - j]
    """
    taps = jnp.asarray(taps)
    T = taps.shape[0]
    n_out = (xp.shape[0] - (T - 1)) // decim
    w = taps[::-1]  # correlation kernel = reversed conv taps
    x_c = jnp.iscomplexobj(xp)
    t_c = jnp.iscomplexobj(taps)

    if not x_c and not t_c:
        y = _fir_real(xp.astype(jnp.float32)[None], w.astype(jnp.float32),
                      decim, n_out)
        return y[0]

    if x_c and not t_c:
        xs = jnp.stack([xp.real, xp.imag], axis=0)
        y = _fir_real(xs.astype(jnp.float32), w.astype(jnp.float32),
                      decim, n_out)
        return lax.complex(y[0], y[1])

    if x_c and t_c:
        xs = jnp.stack([xp.real, xp.imag], axis=0).astype(jnp.float32)
        yr_ = _fir_real(xs, w.real.astype(jnp.float32), decim, n_out)
        yi_ = _fir_real(xs, w.imag.astype(jnp.float32), decim, n_out)
        # (xr + j xi)(wr + j wi): re = xr*wr - xi*wi, im = xr*wi + xi*wr
        return lax.complex(yr_[0] - yi_[1], yi_[0] + yr_[1])

    # real x, complex taps
    xs = xp.astype(jnp.float32)[None]
    yr_ = _fir_real(xs, w.real.astype(jnp.float32), decim, n_out)
    yi_ = _fir_real(xs, w.imag.astype(jnp.float32), decim, n_out)
    return lax.complex(yr_[0], yi_[0])


def fir_apply_batched(xp, taps, decim: int = 1):
    """Batched FIR over leading axis: xp (B, n+T-1), taps (T,) or (B, T).

    Used by the PFB channelizer (per-arm filters) — the whole bank becomes
    one batched matmul.
    """
    if taps.ndim == 1:
        return jax.vmap(lambda x: fir_apply(x, taps, decim))(xp)
    return jax.vmap(lambda x, t: fir_apply(x, t, decim))(xp, taps)
