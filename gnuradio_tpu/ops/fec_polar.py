"""Polar codes: encoder butterflies + successive-cancellation decoding.

Reference parity:
  gr-fec polar_encoder / polar_encoder_systematic (lib/polar_encoder*.cc):
      x = u F^{(x) log2 n} with F = [[1,0],[1,1]] — the butterfly network;
      frozen bit positions carry frozen values (0s)
  polar_decoder_sc (lib/polar_decoder_sc.cc): successive cancellation with
      the min-sum f/g LLR recursions
  channel construction: Bhattacharyya-parameter ordering for the BEC
      (lib/polar/channel_construction.cc 'default constructor')

Design: encoding is log2(n) fully-parallel XOR butterfly stages.
SC decoding is the standard recursive f/g formulation written over STATIC
shapes — Python recursion over halves traces to a fixed XLA graph (n is a
compile-time constant); the sequential dependency is inherent to SC
(SURVEY.md §7 hard part (a)) but each level's f/g ops vectorize, and the
batch axis decodes codewords in parallel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def polar_encode_full(u):
    """u [..., n] -> x = u F^{(x)m} (all positions, frozen already placed)."""
    u = u.astype(jnp.int32) & 1
    n = u.shape[-1]
    x = u
    s = 1
    while s < n:
        xr = x.reshape(x.shape[:-1] + (n // (2 * s), 2, s))
        upper = xr[..., 0, :] ^ xr[..., 1, :]
        x = jnp.concatenate([upper[..., None, :], xr[..., 1:2, :]],
                            axis=-2).reshape(x.shape)
        s *= 2
    return x


def bhattacharyya_order(n: int, design_eps: float = 0.5) -> np.ndarray:
    """Channel reliability order via BEC Bhattacharyya parameters
    (channel_construction 'default' method): z_{2i} = 2z - z^2,
    z_{2i+1} = z^2. Returns indices sorted most->least reliable."""
    z = np.array([design_eps], np.float64)
    while len(z) < n:
        z = np.concatenate([2 * z - z * z, z * z])
    # bit-reversal mapping: the recursion above yields natural order already
    return np.argsort(z, kind="stable")


class PolarCode:
    """(n, k) polar code with frozen-set from Bhattacharyya ordering."""

    def __init__(self, n: int, k: int, design_eps: float = 0.5,
                 frozen_positions=None):
        assert n & (n - 1) == 0, "n must be a power of 2"
        self.n, self.k = n, k
        if frozen_positions is None:
            order = bhattacharyya_order(n, design_eps)
            self.info_pos = np.sort(order[:k])
        else:
            frozen = np.asarray(frozen_positions)
            self.info_pos = np.setdiff1d(np.arange(n), frozen)
            assert len(self.info_pos) == k
        self.frozen_mask = np.ones(n, np.int8)
        self.frozen_mask[self.info_pos] = 0

    def encode(self, info):
        """info [..., k] -> codeword [..., n]."""
        info = info.astype(jnp.int32) & 1
        u = jnp.zeros(info.shape[:-1] + (self.n,), jnp.int32)
        u = u.at[..., jnp.asarray(self.info_pos)].set(info)
        return polar_encode_full(u).astype(jnp.int8)

    # ---- SC decode ----
    def decode(self, llr):
        """llr [..., n] (positive = bit 0) -> info bits [..., k].

        Recursive SC with min-sum f and g:
            f(a, b) = sign(a)sign(b) min(|a|, |b|)
            g(a, b, u) = b + (1-2u) a
        """
        frozen = jnp.asarray(self.frozen_mask)

        def sc(llrs, mask):
            n = llrs.shape[-1]
            if n == 1:
                bit = jnp.where(mask[0] > 0, 0, (llrs[..., 0] < 0)
                                .astype(jnp.int32))
                return bit[..., None], bit[..., None]
            half = n // 2
            a, b = llrs[..., :half], llrs[..., half:]
            f = jnp.sign(a) * jnp.sign(b) * jnp.minimum(jnp.abs(a),
                                                        jnp.abs(b))
            u1, x1 = sc(f, mask[:half])
            g = b + (1 - 2 * x1) * a
            u2, x2 = sc(g, mask[half:])
            u = jnp.concatenate([u1, u2], axis=-1)
            x = jnp.concatenate([x1 ^ x2, x2], axis=-1)
            return u, x

        u, _ = sc(llr.astype(jnp.float32), frozen)
        return u[..., jnp.asarray(self.info_pos)].astype(jnp.int8)


# ---------------------------------------------------------------------------
# SC-list decoding (polar_decoder_sc_list.cc)
# ---------------------------------------------------------------------------

def _encode_np(u):
    """u [..., nn] -> x (host NumPy butterfly), for partial re-encoding."""
    u = np.asarray(u, np.int64) & 1
    nn = u.shape[-1]
    x = u.copy()
    s = 1
    while s < nn:
        xr = x.reshape(x.shape[:-1] + (nn // (2 * s), 2, s))
        xr[..., 0, :] ^= xr[..., 1, :]
        x = xr.reshape(x.shape)
        s *= 2
    return x


def _leaf_llr(llrs: np.ndarray, u_known: np.ndarray, i: int) -> np.ndarray:
    """LLR of u_i for every path. llrs [L, nn] channel-side LLRs of this
    subtree; u_known [L, i] already-decided u bits inside the subtree."""
    nn = llrs.shape[1]
    if nn == 1:
        return llrs[:, 0]
    half = nn // 2
    a, b = llrs[:, :half], llrs[:, half:]
    if i < half:
        f = np.sign(a) * np.sign(b) * np.minimum(np.abs(a), np.abs(b))
        return _leaf_llr(f, u_known, i)
    x1 = _encode_np(u_known[:, :half])
    g = b + (1 - 2 * x1) * a
    return _leaf_llr(g, u_known[:, half:], i - half)


class PolarCodeList(PolarCode):
    """(n, k) polar code with successive-cancellation LIST decoding
    (gr-fec polar_decoder_sc_list analog; Tal & Vardy 2015, LLR-based path
    metrics). Host-side NumPy, vectorized over the path axis — list
    decoding's data-dependent path pruning is control flow the host owns;
    the heavy per-codeword SC stays available on device via decode()."""

    def __init__(self, n: int, k: int, list_size: int = 4,
                 design_eps: float = 0.5, frozen_positions=None):
        super().__init__(n, k, design_eps, frozen_positions)
        self.list_size = int(list_size)

    def decode_list(self, llr):
        """llr [n] (positive = bit 0) -> info bits [k] from the best path."""
        llr = np.asarray(llr, np.float64)
        Lmax = self.list_size
        paths_u = np.zeros((1, self.n), np.int64)
        metrics = np.zeros(1, np.float64)
        ch = np.broadcast_to(llr, (1, self.n)).copy()
        for i in range(self.n):
            lam = _leaf_llr(ch, paths_u[:, :i], i)      # [P]
            if self.frozen_mask[i]:
                # frozen: u_i = 0; penalize paths whose llr says 1
                metrics = metrics + np.where(lam < 0, -lam, 0.0)
                paths_u[:, i] = 0
            else:
                P = len(metrics)
                # fork: u_i = 0 (penalty if lam<0) and u_i = 1 (if lam>0)
                m0 = metrics + np.where(lam < 0, -lam, 0.0)
                m1 = metrics + np.where(lam > 0, lam, 0.0)
                allm = np.concatenate([m0, m1])
                keep = np.argsort(allm, kind="stable")[:Lmax]
                new_u = np.concatenate([paths_u, paths_u], axis=0)[keep]
                new_u[:, i] = (keep >= P).astype(np.int64)
                paths_u = new_u
                metrics = allm[keep]
                ch = np.broadcast_to(llr, (len(metrics), self.n)).copy()
        best = int(np.argmin(metrics))
        return paths_u[best][self.info_pos].astype(np.int8)


def polar_decoder_sc_list(n, k, list_size=8, design_eps=0.5,
                          frozen_positions=None):
    return PolarCodeList(n, k, list_size, design_eps, frozen_positions)
