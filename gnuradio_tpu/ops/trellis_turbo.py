"""gr-trellis serial/parallel concatenated codes: sccc_encoder, pccc_encoder,
sccc_decoder, pccc_decoder.

Reference parity: gr-trellis/lib/sccc_encoder_impl.cc (outer FSM -> symbol
interleaver -> inner FSM), pccc_encoder_impl.cc (two FSMs over the same data,
encoder 2 fed the interleaved stream, outputs combined o1*O2 + o2), and the
iterative decoders in gr-trellis/lib/core_algorithms.cc (sccc_decoder_*,
pccc_decoder — turbo loops exchanging SISO extrinsics through the
interleaver).

Design notes: each SISO is two lax.scans (forward/backward in the min*
domain, see trellis.siso); the turbo loop is a short static Python loop of
`niterations` SISO pairs, all fused into one XLA program. Interleaving is a
gather. Independent blocks decode in parallel with vmap (batch axis = code
blocks), which is how this reaches matmul-scale batch sizes despite the
per-symbol recurrence.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .trellis import FSM, siso, encode_fsm, calc_metric, TRELLIS_EUCLIDEAN

INF = 1e9


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def sccc_encode(fsm_outer: FSM, fsm_inner: FSM, perm: np.ndarray, data,
                S0o: int = 0, S0i: int = 0):
    """Serially concatenated encode: y = inner(π(outer(data))). `perm` maps
    output position k to input position perm[k] (gather convention). Outer
    output alphabet must equal inner input alphabet."""
    if fsm_outer.O != fsm_inner.I:
        raise ValueError("outer FSM O must equal inner FSM I")
    data = jnp.asarray(data).astype(jnp.int32)
    mid = encode_fsm(fsm_outer, data, S0o)
    mid_i = mid[jnp.asarray(perm, dtype=jnp.int32)]
    return encode_fsm(fsm_inner, mid_i, S0i)


def pccc_encode(fsm1: FSM, fsm2: FSM, perm: np.ndarray, data,
                S01: int = 0, S02: int = 0):
    """Parallel concatenated encode: o[k] = o1[k]*O2 + o2[k] with encoder 2
    fed the interleaved data (gr-trellis/lib/pccc_encoder_impl.cc)."""
    if fsm1.I != fsm2.I:
        raise ValueError("constituent FSMs must share the input alphabet")
    data = jnp.asarray(data).astype(jnp.int32)
    o1 = encode_fsm(fsm1, data, S01)
    o2 = encode_fsm(fsm2, data[jnp.asarray(perm, dtype=jnp.int32)], S02)
    return o1 * fsm2.O + o2


# ---------------------------------------------------------------------------
# decoders (turbo iterations of SISO pairs)
# ---------------------------------------------------------------------------

def _inv_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(np.asarray(perm))
    inv[np.asarray(perm)] = np.arange(len(perm))
    return inv


def sccc_decode(fsm_outer: FSM, fsm_inner: FSM, perm: np.ndarray,
                obs_metrics, niterations: int = 5,
                S0o: int = 0, SKo: int = -1, S0i: int = 0, SKi: int = -1,
                damping: float = 0.75, ext_clip: float = 50.0):
    """Iterative SCCC decode (core_algorithms.cc sccc_decoder): obs_metrics
    [K, O_inner] (lower = better, e.g. from calc_metric). Extrinsics are
    damped + clipped so the loop converges instead of diverging on its own
    positive feedback. Returns hard decisions on the outer inputs [K]."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = _inv_perm(perm)
    K = obs_metrics.shape[0]
    Ii = fsm_inner.I

    def damp(e):
        e = e - jnp.min(e, axis=1, keepdims=True)
        return jnp.clip(damping * e, 0.0, ext_clip)

    pri_inner = jnp.zeros((K, Ii), jnp.float32)
    post_outer_i = None
    for _ in range(int(niterations)):
        # inner SISO: posterior on inner inputs given channel + current prior
        post_inner = siso(fsm_inner, pri_inner, obs_metrics,
                          S0=S0i, SK=SKi, posti=True, posto=False)
        ext_inner = damp(post_inner - pri_inner)    # extrinsic
        pri_outer_o = ext_inner[jnp.asarray(inv)]   # deinterleave
        # outer SISO: channel = deinterleaved inner extrinsic on its outputs
        post_outer_i, post_outer_o = siso(
            fsm_outer, jnp.zeros((K, fsm_outer.I), jnp.float32), pri_outer_o,
            S0=S0o, SK=SKo, posti=True, posto=True)
        ext_outer_o = damp(post_outer_o - pri_outer_o)
        pri_inner = ext_outer_o[jnp.asarray(perm)]  # re-interleave
    return jnp.argmin(post_outer_i, axis=1).astype(jnp.int32)


def pccc_decode(fsm1: FSM, fsm2: FSM, perm: np.ndarray, obs_metrics,
                niterations: int = 5, S01: int = 0, SK1: int = -1,
                S02: int = 0, SK2: int = -1, damping: float = 0.75,
                ext_clip: float = 50.0):
    """Iterative PCCC decode: obs_metrics [K, O1*O2] over the combined output
    alphabet. Constituent channel metrics are min-marginalized from the joint
    metric (the reference's approximation); extrinsics on the data symbols
    are exchanged through the interleaver with min-sum damping + clipping
    (positive feedback otherwise diverges after a few iterations — the
    standard turbo scaling fix). Returns hard data decisions [K]."""
    perm_j = jnp.asarray(np.asarray(perm), dtype=jnp.int32)
    inv_j = jnp.asarray(_inv_perm(perm), dtype=jnp.int32)
    K = obs_metrics.shape[0]
    O1, O2 = fsm1.O, fsm2.O
    m = obs_metrics.reshape(K, O1, O2)
    chan1 = jnp.min(m, axis=2)                 # [K, O1]
    # o2[k] is already on code-2's trellis time axis (encoder 2 consumed the
    # interleaved data), so no permutation of the channel metric here — only
    # the data extrinsics cross the interleaver
    chan2 = jnp.min(m, axis=1)                 # [K, O2]
    I_ = fsm1.I

    def damp(e):
        e = e - jnp.min(e, axis=1, keepdims=True)
        return jnp.clip(damping * e, 0.0, ext_clip)

    ext2_d = jnp.zeros((K, I_), jnp.float32)   # extrinsic from code 2, deint
    post1 = None
    for _ in range(int(niterations)):
        pri1 = ext2_d
        post1 = siso(fsm1, pri1, chan1, S0=S01, SK=SK1,
                     posti=True, posto=False)
        ext1 = damp(post1 - pri1)
        pri2 = ext1[perm_j]
        post2 = siso(fsm2, pri2, chan2, S0=S02, SK=SK2,
                     posti=True, posto=False)
        ext2_d = damp((post2 - pri2)[inv_j])
    return jnp.argmin(post1, axis=1).astype(jnp.int32)


def sccc_decode_combined(fsm_outer: FSM, fsm_inner: FSM, perm, observations,
                         table, D: int, metric_type=TRELLIS_EUCLIDEAN,
                         niterations: int = 5, **kw):
    """sccc_decoder_combined_*: observations -> metrics -> iterative decode."""
    obs = calc_metric(observations, np.asarray(table).reshape(fsm_inner.O, D),
                      fsm_inner.O, D, metric_type)
    return sccc_decode(fsm_outer, fsm_inner, perm, obs, niterations, **kw)


def pccc_decode_combined(fsm1: FSM, fsm2: FSM, perm, observations, table,
                         D: int, metric_type=TRELLIS_EUCLIDEAN,
                         niterations: int = 5, **kw):
    O = fsm1.O * fsm2.O
    obs = calc_metric(observations, np.asarray(table).reshape(O, D),
                      O, D, metric_type)
    return pccc_decode(fsm1, fsm2, perm, obs, niterations, **kw)


def sccc_decode_batched(fsm_outer, fsm_inner, perm, obs_metrics_batch,
                        niterations=5, **kw):
    """vmap over independent code blocks — the throughput path."""
    return jax.vmap(
        lambda o: sccc_decode(fsm_outer, fsm_inner, perm, o,
                              niterations, **kw))(obs_metrics_batch)
