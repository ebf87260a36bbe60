"""Halo exchange over a time-sharded stream — history() across shards.

This is the north-star seam of the whole framework (SURVEY.md §2.4 row
"Sequence/temporal overlap" and §7 step 4): the reference scheduler keeps
filters causal across chunk boundaries by re-presenting the last N-1 input
items (`history()`, gnuradio-runtime/include/gnuradio/block.h:82-91). When a
stream chunk is sharded across chips along time, those N-1 items live on the
*left neighbor chip*, so the history contract becomes a `ppermute`
collective, and the chunk-to-chunk carry (shard 0's history) stays a small
replicated array.

All functions here are designed to run inside `shard_map` over a named mesh
axis. They are pure and differentiable-friendly (no host callbacks).

Alignment invariant: each shard's local length must be a multiple of every
downstream decimation factor so decimator phase (j0 = decim*k,
gr-filter/lib/fir_filter.cc filterNdec indexing) is identical on every shard
— the condition SURVEY.md App. C calls out for cross-shard phase alignment.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _axis_size(axis_name: str) -> int:
    return lax.axis_size(axis_name) if hasattr(lax, "axis_size") else lax.psum(1, axis_name)


def replicate_from_last(val, axis_name: str):
    """Replicate `val` (shape S) from the LAST shard to all shards.

    Implemented as a masked psum — O(|val|) between devices, used for tiny carries
    (filter tails, phase scalars), never for bulk data.
    """
    D = _axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    mask = (idx == D - 1)
    if jnp.iscomplexobj(val):
        m = mask.astype(jnp.float32)
        return lax.complex(lax.psum(val.real * m, axis_name),
                           lax.psum(val.imag * m, axis_name))
    if jnp.issubdtype(val.dtype, jnp.integer):
        return lax.psum(jnp.where(mask, val, jnp.zeros_like(val)), axis_name)
    return lax.psum(val * mask.astype(val.dtype), axis_name)


def left_halo(x_local, carry, axis_name: str):
    """Prepend each shard's left halo: the last `h = carry.shape[0]` items of
    the left-neighbor shard (shard 0 gets `carry`, the global stream tail
    from the previous step).

    Returns (padded_local [h + n_local], new_carry) where new_carry is the
    LAST shard's tail replicated everywhere — feed it back as `carry` on the
    next step so the chunk-to-chunk seam has the same semantics as the
    shard-to-shard seam.
    """
    h = carry.shape[0]
    if h == 0:
        return x_local, carry
    if x_local.shape[0] < h:
        raise ValueError(
            f"shard-local chunk ({x_local.shape[0]} items) is shorter than "
            f"the history halo ({h} items); increase the per-step chunk size "
            f"or reduce the number of time shards")
    D = _axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    tail = x_local[x_local.shape[0] - h:]
    if D > 1:
        # shift right: shard i's tail -> shard i+1; shard 0 receives zeros
        from_left = lax.ppermute(tail, axis_name,
                                 [(i, i + 1) for i in range(D - 1)])
    else:
        from_left = jnp.zeros_like(tail)
    halo = jnp.where(idx == 0, carry, from_left)
    new_carry = replicate_from_last(tail, axis_name)
    return jnp.concatenate([halo, x_local], axis=0), new_carry


def shard_offset(axis_name: str, n_local: int):
    """Global item offset of this shard's first item within the step's chunk
    (int32) — the sharded analog of nitems_read (block.h:352-357) within one
    step. Caller adds the step-level 64-bit base offset on the host."""
    return lax.axis_index(axis_name).astype(jnp.int32) * jnp.int32(n_local)


def first_order_boundary(y_zero, r, carry_y, axis_name: str):
    """Fix up a first-order IIR evaluated shard-locally with zero incoming
    state, turning D independent local scans into the exact global scan.

    y_zero : (n,) local outputs of y[k] = r*y[k-1] + d[k] computed with
             y[-1] = 0 on every shard.
    r      : scalar feedback coefficient.
    carry_y: scalar — global y[-1] entering this step (previous chunk tail).

    The incoming boundary value for shard d is itself a first-order
    recurrence over shards: B_d = L_d + R * B_{d-1} with L_d = y_zero[-1] of
    shard d and R = r^n. We all_gather the D scalars (tiny) and close the
    recurrence locally, then correct: y[k] = y_zero[k] + r^(k+1) * B_in.

    Returns (y_exact, new_carry_y). Exact up to float reassociation.
    """
    n = y_zero.shape[0]
    D = _axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    r = jnp.asarray(r, y_zero.dtype)
    L = lax.all_gather(y_zero[-1], axis_name)            # (D,)
    R = r ** n
    # B_in(d) = sum_{j<d} L_j R^{d-1-j} + R^d * carry_y
    j = jnp.arange(D)
    w = jnp.where(j < idx, R ** (idx - 1 - j), jnp.zeros_like(L))
    B_in = jnp.sum(w * L) + (R ** idx) * carry_y
    k = jnp.arange(1, n + 1, dtype=y_zero.dtype) if not jnp.iscomplexobj(y_zero) \
        else jnp.arange(1, n + 1).astype(y_zero.dtype)
    y = y_zero + (r ** k) * B_in
    new_carry = replicate_from_last(y[-1], axis_name)
    return y, new_carry
