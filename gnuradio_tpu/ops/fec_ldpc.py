"""LDPC codes: alist I/O, G-from-H derivation, min-sum belief propagation.

Reference parity:
  gr-fec alist format (lib/alist.cc, include/gnuradio/fec/alist.h) — sparse
      parity matrix text format
  ldpc_H_matrix / ldpc_G_matrix (lib/fec_mtrx_impl.cc, gf2mat.cc) — GF(2)
      Gaussian elimination to systematic form, encode via generator matrix
  ldpc_bit_flip_decoder / ldpc_decoder (awgn_bp.h) — iterative decoding

Design: H is kept DENSE as an int8 mask [m, n] (the in-tree example
codes are hundreds to a few thousand bits — dense masked elementwise ops beat
gather/scatter sparsity there). Encoding is a bit-matrix product (matmul)
(mod 2). Decoding is flooding min-sum BP with the min1/min2 exclusion trick:
every iteration is two dense masked reductions, no per-edge loops. Batch
axis = codewords.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def read_alist(path: str) -> np.ndarray:
    """Parse an alist file -> dense H [m, n] (alist.cc format: n m, max
    degrees, per-column then per-row connection lists, 1-indexed)."""
    toks = open(path).read().split()
    it = iter(toks)
    n = int(next(it))
    m = int(next(it))
    next(it)  # max col degree
    next(it)  # max row degree
    col_deg = [int(next(it)) for _ in range(n)]
    [int(next(it)) for _ in range(m)]  # row degrees
    H = np.zeros((m, n), np.int8)
    for j in range(n):
        for _ in range(col_deg[j]):
            i = int(next(it))
            if i > 0:
                H[i - 1, j] = 1
    return H


def write_alist(path: str, H: np.ndarray):
    H = np.asarray(H, np.int8)
    m, n = H.shape
    col_lists = [list(np.nonzero(H[:, j])[0] + 1) for j in range(n)]
    row_lists = [list(np.nonzero(H[i, :])[0] + 1) for i in range(m)]
    maxc = max(len(c) for c in col_lists)
    maxr = max(len(r) for r in row_lists)
    with open(path, "w") as f:
        f.write(f"{n} {m}\n{maxc} {maxr}\n")
        f.write(" ".join(str(len(c)) for c in col_lists) + "\n")
        f.write(" ".join(str(len(r)) for r in row_lists) + "\n")
        for c in col_lists:
            f.write(" ".join(map(str, c + [0] * (maxc - len(c)))) + "\n")
        for r in row_lists:
            f.write(" ".join(map(str, r + [0] * (maxr - len(r)))) + "\n")


class LdpcCode:
    """Systematic LDPC code from a parity matrix H [m, n].

    Column-permutes H (if needed) so the right m x m block inverts over
    GF(2), giving codeword = [info | parity] with parity = info x P
    (the ldpc_G_matrix derivation, fec_mtrx_impl.cc)."""

    def __init__(self, H: np.ndarray):
        H = np.asarray(H, np.int8) & 1
        m, n = H.shape
        self.m, self.n = m, n
        # H is often rank-deficient (regular Gallager constructions always
        # are); encode against a row-reduced full-rank basis E of the same
        # row space. k = n - rank (fec_mtrx_impl.cc does the same reduction)
        E = self._gf2_echelon(H)
        r = E.shape[0]
        self.k = n - r
        Hw, perm = self._systematize(E)
        self.perm = perm           # codeword[perm] = [info | parity] order
        self.inv_perm = np.argsort(perm)
        A = Hw[:, : self.k]        # r x k
        # parity = (B^-1 A) info  with B = Hw[:, k:] invertible
        Binv = self._gf2_inv(Hw[:, self.k:])
        self.P = (Binv @ A) % 2    # r x k
        self.H = H
        self._Hj = jnp.asarray(H.astype(np.float32))
        self._Pj = jnp.asarray(self.P.astype(np.int32))

    @staticmethod
    def _gf2_echelon(H: np.ndarray) -> np.ndarray:
        """Row-reduce over GF(2); return the nonzero (independent) rows."""
        work = (np.asarray(H, np.int8) & 1).copy()
        m, n = work.shape
        r = 0
        for c in range(n):
            piv = None
            for i in range(r, m):
                if work[i, c]:
                    piv = i
                    break
            if piv is None:
                continue
            work[[r, piv]] = work[[piv, r]]
            for i in range(m):
                if i != r and work[i, c]:
                    work[i] ^= work[r]
            r += 1
            if r == m:
                break
        return work[:r]

    @staticmethod
    def _gf2_inv(B: np.ndarray) -> np.ndarray:
        m = B.shape[0]
        aug = np.concatenate([B.astype(np.int8) % 2, np.eye(m, dtype=np.int8)],
                             axis=1)
        r = 0
        for c in range(m):
            piv = None
            for i in range(r, m):
                if aug[i, c]:
                    piv = i
                    break
            if piv is None:
                raise ValueError("matrix not invertible over GF(2)")
            aug[[r, piv]] = aug[[piv, r]]
            for i in range(m):
                if i != r and aug[i, c]:
                    aug[i] ^= aug[r]
            r += 1
        return aug[:, m:]

    @staticmethod
    def _systematize(H: np.ndarray):
        """Find a column permutation putting an invertible block at the
        right; returns (H_permuted, perm)."""
        m, n = H.shape
        k = n - m
        # greedy: use Gaussian elimination to find m independent columns
        work = H.copy()
        pivots = []
        r = 0
        for c in range(n):
            piv = None
            for i in range(r, m):
                if work[i, c]:
                    piv = i
                    break
            if piv is None:
                continue
            work[[r, piv]] = work[[piv, r]]
            for i in range(m):
                if i != r and work[i, c]:
                    work[i] ^= work[r]
            pivots.append(c)
            r += 1
            if r == m:
                break
        if r < m:
            raise ValueError("H is rank deficient")
        rest = [c for c in range(n) if c not in set(pivots)]
        perm = np.array(rest + pivots)
        return H[:, perm], perm

    # ---- encode ----
    def encode(self, info):
        """info [..., k] bits -> codeword [..., n] (original column order,
        satisfying H c^T = 0)."""
        info = info.astype(jnp.int32) & 1
        parity = (info @ self._Pj.T) % 2            # [..., m]
        cw_sys = jnp.concatenate([info, parity], axis=-1)
        return cw_sys[..., jnp.asarray(self.inv_perm)]

    def check(self, cw) -> bool:
        s = (np.asarray(cw) @ self.H.T) % 2
        return not s.any()

    def extract_info(self, cw):
        return cw[..., jnp.asarray(self.perm[: self.k])]

    # ---- decode: flooding min-sum BP ----
    def decode(self, llr, iterations: int = 20, damping: float = 0.75):
        """llr [..., n] (positive = bit 0) -> hard bits [..., n].

        Dense min-sum: check messages via the min1/min2 exclusion trick,
        variable update via masked column sums. Early termination is not
        data-dependent (fixed iterations) to keep shapes static."""
        Hm = self._Hj  # [m, n] float mask
        big = jnp.float32(1e9)

        def iteration(carry, _):
            v2c, _ = carry  # variable->check messages [., m, n]
            masked = jnp.where(Hm > 0, v2c, big)
            mags = jnp.abs(masked)
            # two smallest magnitudes per row
            min1 = jnp.min(mags, axis=-1, keepdims=True)
            idx1 = jnp.argmin(mags, axis=-1)
            mags2 = jnp.where(
                jax.nn.one_hot(idx1, mags.shape[-1], dtype=bool), big, mags)
            min2 = jnp.min(mags2, axis=-1, keepdims=True)
            use_min = jnp.where(
                jax.nn.one_hot(idx1, mags.shape[-1], dtype=bool), min2, min1)
            signs = jnp.where(Hm > 0, jnp.sign(masked), 1.0)
            sprod = jnp.prod(signs, axis=-1, keepdims=True)
            c2v = jnp.where(Hm > 0,
                            damping * sprod * signs * use_min, 0.0)
            # variable update: total = llr + sum of c2v; v2c = total - own
            colsum = jnp.sum(c2v, axis=-2, keepdims=True)
            new_v2c = jnp.where(Hm > 0,
                                llr[..., None, :] + colsum - c2v, 0.0)
            post = llr + jnp.sum(c2v, axis=-2)
            return (new_v2c, post), None

        v2c0 = jnp.where(Hm > 0, llr[..., None, :], 0.0)
        (v2c, post), _ = jax.lax.scan(iteration, (v2c0, llr), None,
                                      length=iterations)
        return (post < 0).astype(jnp.int8)


def make_gallager_code(n: int, wc: int, wr: int, seed: int = 0) -> np.ndarray:
    """Random regular Gallager H (column weight wc, row weight wr) for
    tests/benchmarks (the reference ships example alist files; this
    generates equivalent regular codes)."""
    assert n * wc % wr == 0
    m = n * wc // wr
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.int8)
    # permutation construction: wc stacked permuted block rows (disjoint
    # row ranges per block, so no collisions; LdpcCode handles the
    # inherent rank deficiency of this construction)
    base = np.tile(np.arange(m // wc), wr)[:n]
    for b in range(wc):
        pm = rng.permutation(n)
        rows = base[pm] + b * (m // wc)
        H[rows, np.arange(n)] = 1
    return H
