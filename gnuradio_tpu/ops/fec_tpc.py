"""Turbo product codes (gr-fec tpc_encoder/tpc_decoder).

Reference behavior (reimplemented, NOT copied):
  gr-fec/lib/tpc_encoder.cc — product code over a krow x kcol payload
      block (padded with bval+qval leading zeros): every row is encoded by
      a recursive systematic convolutional (RSC) code given by an octal
      polynomial list (polys[0] = feedback), terminated to the zero state
      (tpc_common::rsc_tail); every column of the row-coded array is then
      encoded by the column RSC. Output size
      ((krow+rm)*rn) * ((kcol+cm)*cn) - bval  (tpc_encoder.cc:69-71).
  gr-fec/lib/tpc_decoder.cc — iterative max-log-MAP SISO decoding, rows
      and columns alternating with extrinsic exchange.

Design: row/column RSC encoding is a vmapped lax.scan (all rows on the
batch axis); the SISO halves reuse trellis.siso (vectorized min*
forward/backward) vmapped over rows/columns; iterations are a fixed host
loop. Serialization here is row-major over the full product array with
each RSC step emitting its n output bits consecutively (systematic first).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import trellis as _trellis


def _rsc_tables(polys, K: int):
    """RSC tables. polys[0] = feedback (taps incl. the input position as
    MSB), others feedforward. Returns NS[S,2], OUT[S,2,n] (systematic
    output first)."""
    n = len(polys)
    m = K - 1
    S = 1 << m
    NS = np.zeros((S, 2), np.int64)
    OUT = np.zeros((S, 2, n), np.int64)
    fb = polys[0]
    for s in range(S):
        for b in (0, 1):
            d = b
            for i in range(m):
                if (fb >> i) & 1:
                    d ^= (s >> i) & 1
            ns = (s >> 1) | (d << (m - 1))
            OUT[s, b, 0] = b
            for j in range(1, n):
                g = polys[j]
                o = d if (g >> m) & 1 else 0
                for i in range(m):
                    if (g >> i) & 1:
                        o ^= (s >> i) & 1
                OUT[s, b, j] = o
            NS[s, b] = ns
    return NS, OUT


def _encode_rows(rows, NS, OUT, m):
    """rows [R, k] -> [R, (k+m)*n] full-output serialization, register
    driven to zero by the m tail steps."""
    NSj, OUTj = jnp.asarray(NS), jnp.asarray(OUT)

    def enc(row):
        def step(s, b):
            return NSj[s, b], OUTj[s, b]
        s, outs = jax.lax.scan(step, jnp.int32(0), row)

        def tstep(s, _):
            # tail input makes the register shift in a zero
            b = jnp.where(NSj[s, 0] == (s >> 1), 0, 1).astype(jnp.int32)
            return NSj[s, b], OUTj[s, b]

        s, touts = jax.lax.scan(tstep, s, None, length=m)
        return jnp.concatenate([outs, touts], axis=0).reshape(-1)

    return jax.vmap(enc)(rows.astype(jnp.int32))


class TPC:
    """Turbo product code. encode: [k] bits -> [n] bits;
    decode: [n] LLRs (positive = bit 0) -> [k] bits."""

    def __init__(self, row_polys=(0o3, 0o5), col_polys=(0o3, 0o5),
                 krow: int = 24, kcol: int = 8, bval: int = 0,
                 qval: int = 0):
        self.row_polys = [int(p) for p in row_polys]
        self.col_polys = [int(p) for p in col_polys]
        self.krow, self.kcol = int(krow), int(kcol)
        self.bval, self.qval = int(bval), int(qval)
        self.rK = max(1, int(np.ceil(np.log2(self.row_polys[0] + 1))))
        self.cK = max(1, int(np.ceil(np.log2(self.col_polys[0] + 1))))
        self.rm, self.cm = self.rK - 1, self.cK - 1
        self.rn, self.cn = len(self.row_polys), len(self.col_polys)
        self.k = self.krow * self.kcol - self.bval - self.qval
        self.row_len = (self.krow + self.rm) * self.rn
        self.col_len = (self.kcol + self.cm) * self.cn
        self.n = self.row_len * self.col_len - self.bval
        self.rNS, self.rOUT = _rsc_tables(self.row_polys, self.rK)
        self.cNS, self.cOUT = _rsc_tables(self.col_polys, self.cK)
        wr = 1 << np.arange(self.rn - 1, -1, -1)
        wc = 1 << np.arange(self.cn - 1, -1, -1)
        self.rFSM = _trellis.FSM(2, 1 << self.rm, 1 << self.rn,
                                 self.rNS, (self.rOUT * wr).sum(-1))
        self.cFSM = _trellis.FSM(2, 1 << self.cm, 1 << self.cn,
                                 self.cNS, (self.cOUT * wc).sum(-1))

    def encode(self, bits):
        x = jnp.concatenate([jnp.zeros(self.bval + self.qval, jnp.int32),
                             bits.astype(jnp.int32)])
        block = x.reshape(self.kcol, self.krow)
        rowcw = _encode_rows(block, self.rNS, self.rOUT, self.rm)
        # [kcol, row_len] -> column encode each of the row_len columns
        colcw = _encode_rows(rowcw.T, self.cNS, self.cOUT, self.cm)
        # colcw: [row_len, col_len]; serialize column-major like the rows
        full = colcw.T.reshape(-1)          # [col_len * row_len]
        return full[self.bval:]

    # -- decoding ---------------------------------------------------------
    def _siso_pass(self, llr_mat, fsm, nsteps, m, nout):
        """llr_mat: [R, (nsteps+m)*nout] bit LLRs -> posterior bit LLRs
        (same shape) + input-bit posteriors [R, nsteps]."""
        R = llr_mat.shape[0]
        bits_llr = llr_mat.reshape(R, nsteps + m, nout)
        # observation metric for output symbol o: sum over bits of the
        # LLR of the bits that are 1 in o (min-domain: cost of hypothesis)
        O = 1 << nout
        pat = ((np.arange(O)[:, None] >> np.arange(nout - 1, -1, -1)) & 1)
        patj = jnp.asarray(pat, jnp.float32)          # [O, nout]
        # cost(o) = sum_b [ bit_b(o)=1 ] * llr_b   (llr>0 favors 0)
        prioro = jnp.einsum("rkn,on->rko", bits_llr, patj)
        priori = jnp.zeros((R, nsteps + m, 2), jnp.float32)

        def one(po, pi):
            return _trellis.siso(fsm, pi, po, S0=0, SK=0, posti=True,
                                 posto=True)

        posti, posto = jax.vmap(one)(prioro, priori)
        # posterior bit LLRs from output-symbol posteriors: min over
        # symbols with bit=0 minus min over symbols with bit=1
        big = 1e9
        # for each bit position b: min over o with bit 0 / bit 1
        post_bits = []
        for b in range(nout):
            sel = pat[:, b]
            c0 = jnp.min(jnp.where(jnp.asarray(sel == 0), posto, big), -1)
            c1 = jnp.min(jnp.where(jnp.asarray(sel == 1), posto, big), -1)
            post_bits.append(c1 - c0)
        post = jnp.stack(post_bits, axis=-1)          # [R, k+m, nout]
        in_post = posti[..., 1] - posti[..., 0]       # [R, k+m] (>0 -> bit0)
        return post.reshape(R, -1), in_post[:, :nsteps]

    def decode(self, llr, iterations: int = 4):
        """llr: [n] with positive = bit 0 (the reference's convention)."""
        full = jnp.concatenate([jnp.zeros(self.bval, jnp.float32),
                                llr.astype(jnp.float32)])
        mat = full.reshape(self.col_len, self.row_len)   # column-major blocks
        ch = mat
        ext_rows = jnp.zeros_like(ch)
        ext_cols = jnp.zeros_like(ch)
        for _ in range(iterations):
            # columns: every column of the product array is a col codeword
            lin = (ch + ext_rows).T                      # [row_len, col_len]
            post, _ = self._siso_pass(lin, self.cFSM, self.kcol, self.cm,
                                      self.cn)
            # trellis.siso's posto EXCLUDES the step's own output prior
            # (extrinsic form) — use it directly, damped
            ext_cols = post.T * 0.75
            # rows: only the systematic region rows hold row codewords.
            # Row r of the row-coded array lives at the systematic bit
            # positions of column steps — i.e. rows of `mat` where the
            # column-step bit index is the systematic (first) bit.
            row_region = (ch + ext_cols)[self._row_rows()]
            post_r, _ = self._siso_pass(row_region, self.rFSM, self.krow,
                                        self.rm, self.rn)
            ext_rows = jnp.zeros_like(ch).at[self._row_rows()].set(
                post_r * 0.75)
        final = ch + ext_rows + ext_cols
        sysrows = final[self._row_rows()][:self.kcol]
        bits_llr = sysrows.reshape(self.kcol, self.krow + self.rm, self.rn)
        info = (bits_llr[:, :self.krow, 0] < 0).astype(jnp.int32)
        flat = info.reshape(-1)
        return flat[self.bval + self.qval:]

    def _row_rows(self):
        """Indices of `mat` rows (column-major serialization) that carry
        the row-coded array: column step t, systematic bit -> row index
        t*cn for t < kcol + ... ; the row-coded array rows are the first
        kcol+cm column steps' systematic bits? No — the row-coded array is
        exactly the systematic *inputs* of the column codes: step t < kcol,
        bit 0. mat row index = t * cn."""
        return np.arange(self.kcol) * self.cn


def tpc_encoder(row_polys, col_polys, krow, kcol, bval=0, qval=0):
    return TPC(row_polys, col_polys, krow, kcol, bval, qval)
