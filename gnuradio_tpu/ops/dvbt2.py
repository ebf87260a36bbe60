"""gr-dtv DVB-T2 transmit blocks (ETSI EN 302 755).

Reference behavior (reimplemented, NOT copied):
  gr-dtv/lib/dvbt2/dvbt2_interleaver_bb_impl.cc — bit interleaver: parity
      interleave u[nbch+360t+s] = c[nbch+qs+t], column write with per-column
      cyclic twist, row-wise read, and the rate-dependent demux (mux tables,
      EN 302 755 sec 6.1.3). Composed into ONE gather permutation per
      (framesize, constellation, rate).
  gr-dtv/lib/dvbt2/dvbt2_cellinterleaver_cc_impl.cc — pseudo-random cell
      permutation from the maximum-length LFSR per (framesize,
      constellation); per-FEC-block cyclic shift from a bit-reversed
      counter; optional column/row time interleaver (sec 6.4/6.5).
  gr-dtv/lib/dvbt2/dvbt2_modulator_bc_impl.cc — QPSK/16/64/256-QAM cell
      mapper with optional constellation rotation (29/16.8/8.6/atan(1/16)
      degrees) + cyclic Q delay (sec 6.3).
  gr-dtv/lib/dvbt2/dvbt2_freqinterleaver_cc_impl.cc — odd/even H(q)
      permutations from the bit-permuted LFSR per FFT size (sec 6.6).
  gr-dtv/lib/dvbt2/dvbt2_p1insertion_cc_impl.cc — P1 preamble: S1/S2
      patterns DBPSK-modulated onto the 384-carrier CDS, randomized by the
      PRBS (seed 0x4e46), 1K IFFT, C-A-B guard structure with +1-carrier
      frequency-shifted copies (sec 9.8).
  LDPC/BCH reuse ops.dvbs2 (the T2 variants of the 2/3N and 3/5S tables are
      selected here).

Design: the whole TX chain is permutation-composition — every
interleaver is a host-precomputed index vector applied as one gather, so
XLA fuses bit-interleave -> map -> cell-interleave -> freq-interleave into
a couple of kernels around the final batched IFFT.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from . import dvbs2
from .dvbs2 import DVBS2Config, BCH_PARAMS, FRAME_NORMAL, FRAME_SHORT
from .dvb_ldpc_tables import TABLES
from .dvbt2_tables import (P1_ACTIVE_CARRIERS, S1_PATTERNS, S2_PATTERNS,
                           CELL_COUNTS)

MOD_BITS = {"qpsk": 2, "16qam": 4, "64qam": 6, "256qam": 8}

# demux tables (EN 302 755 table 12a/b/c + short-frame variants)
_MUX = {
    ("16qam", None): [7, 1, 4, 2, 5, 3, 6, 0],
    ("16qam", "3/5N"): [0, 5, 1, 2, 4, 7, 3, 6],
    ("16qam", "1/3S"): [6, 0, 3, 4, 5, 2, 1, 7],
    ("16qam", "2/5S"): [7, 5, 4, 0, 3, 1, 2, 6],
    ("64qam", None): [11, 7, 3, 10, 6, 2, 9, 5, 1, 8, 4, 0],
    ("64qam", "3/5N"): [2, 7, 6, 9, 0, 3, 1, 8, 4, 11, 5, 10],
    ("64qam", "1/3S"): [4, 2, 0, 5, 6, 1, 3, 7, 8, 9, 10, 11],
    ("64qam", "2/5S"): [4, 0, 1, 6, 2, 3, 5, 8, 7, 10, 9, 11],
    ("256qam", None): [15, 1, 13, 3, 8, 11, 9, 5, 10, 6, 4, 7, 12, 2, 14, 0],
    ("256qam", "3/5N"): [2, 11, 3, 4, 0, 9, 1, 8, 10, 13, 7, 14, 6, 15, 5, 12],
    ("256qam", "2/3N"): [7, 2, 9, 0, 4, 6, 13, 3, 14, 10, 15, 5, 8, 12, 11, 1],
    ("256qamS", None): [7, 3, 1, 5, 2, 6, 4, 0],
    ("256qamS", "1/3S"): [4, 0, 1, 2, 5, 3, 6, 7],
    ("256qamS", "2/5S"): [4, 0, 5, 1, 2, 3, 6, 7],
}

_TWIST = {
    ("16qam", "normal"): [0, 0, 2, 4, 4, 5, 7, 7],
    ("64qam", "normal"): [0, 0, 2, 2, 3, 4, 4, 5, 5, 7, 8, 9],
    ("256qam", "normal"): [0, 2, 2, 2, 2, 3, 7, 15,
                           16, 20, 22, 22, 27, 27, 28, 32],
    ("16qam", "short"): [0, 0, 0, 1, 7, 20, 20, 21],
    ("64qam", "short"): [0, 0, 0, 2, 2, 2, 3, 3, 3, 6, 7, 7],
    ("256qam", "short"): [0, 0, 0, 1, 7, 20, 20, 21],
}

_LDPC_TAB_T2 = {
    ("normal", "1/2"): "1_2N", ("normal", "3/5"): "3_5N",
    ("normal", "2/3"): "2_3N_DVBT2", ("normal", "3/4"): "3_4N",
    ("normal", "4/5"): "4_5N", ("normal", "5/6"): "5_6N",
    ("short", "1/4"): "1_4S", ("short", "1/3"): "1_3S",
    ("short", "2/5"): "2_5S", ("short", "1/2"): "1_2S",
    ("short", "3/5"): "3_5S_DVBT2", ("short", "2/3"): "2_3S",
    ("short", "3/4"): "3_4S", ("short", "4/5"): "4_5S",
    ("short", "5/6"): "5_6S",
}


class DVBT2Config(DVBS2Config):
    """FEC params follow DVB-S2 table 5a/5b; LDPC tables use the T2
    variants where they differ (2/3 normal, 3/5 short)."""

    def __init__(self, framesize="normal", rate="1/2", constellation="qpsk",
                 rotation=False):
        if (framesize, rate) not in _LDPC_TAB_T2:
            raise ValueError(f"unsupported T2 ({framesize}, {rate})")
        super().__init__(framesize, rate, "qpsk")   # fec plumbing
        self.constellation = constellation
        self.rotation = bool(rotation)
        self.ldpc_table = TABLES[_LDPC_TAB_T2[(framesize, rate)]]
        self.m = MOD_BITS[constellation]
        self.cell_size = self.frame // self.m


def ldpc_encode(coded, cfg: DVBT2Config):
    """Reuses the IRA encoder with the T2 table selection."""
    # dvbs2.ldpc_encode reads cfg.framesize/rate through _ldpc_pairs which
    # uses the S2 tables; inline the pair computation with cfg.ldpc_table.
    pbits = cfg.frame - cfg.nbch
    bit_idx, addr = _t2_ldpc_pairs(cfg)
    info = coded.astype(jnp.int32)
    acc = jnp.zeros(coded.shape[:-1] + (pbits,), jnp.int32)
    acc = acc.at[..., jnp.asarray(addr)].add(info[..., jnp.asarray(bit_idx)])
    parity = jnp.cumsum(acc & 1, axis=-1) & 1
    return jnp.concatenate([info, parity], axis=-1)


@lru_cache(maxsize=16)
def _t2_pairs_key(framesize, rate):
    frame = FRAME_NORMAL if framesize == "normal" else FRAME_SHORT
    nbch = BCH_PARAMS[(framesize, rate)][1]
    q = (frame - nbch) // 360
    table = TABLES[_LDPC_TAB_T2[(framesize, rate)]]
    bit_idx, addr = [], []
    base = np.arange(360)
    for r, row in enumerate(table):
        for x in row:
            bit_idx.append(r * 360 + base)
            addr.append((x + base * q) % (frame - nbch))
    return (np.concatenate(bit_idx).astype(np.int32),
            np.concatenate(addr).astype(np.int32))


def _t2_ldpc_pairs(cfg):
    return _t2_pairs_key(cfg.framesize, cfg.rate)


# ---------------------------------------------------------------------------
# bit interleaver
# ---------------------------------------------------------------------------

def _rate_key(cfg) -> str:
    return f"{cfg.rate.replace('/', '_')}"


@lru_cache(maxsize=32)
def _bit_perm(framesize: str, rate: str, constellation: str) -> np.ndarray:
    """perm[i] = codeword bit index feeding interleaved position i
    (positions grouped 2m per 2-cell demux group, MSB-first within cells)."""
    frame = FRAME_NORMAL if framesize == "normal" else FRAME_SHORT
    nbch = BCH_PARAMS[(framesize, rate)][1]
    q = (frame - nbch) // 360
    m = MOD_BITS[constellation]
    idx = np.arange(frame, dtype=np.int64)

    # parity interleave
    u = idx.copy()
    t, s = np.meshgrid(np.arange(q), np.arange(360), indexing="ij")
    u[nbch + 360 * t + s] = nbch + q * s + t

    if constellation == "qpsk":
        if rate in ("1/3", "2/5"):
            return u
        return idx

    # column twist: v[rows*col + (twist[col]+row) % rows] = u[col*rows+row]
    ncols = 2 * m
    if constellation == "256qam" and framesize == "short":
        ncols = m  # 8 columns for 256QAM short
    rows = frame // ncols
    key = (constellation, framesize)
    twist = np.array(_TWIST[key][:ncols], np.int64)
    v = np.zeros(frame, np.int64)
    col, row = np.meshgrid(np.arange(ncols), np.arange(rows), indexing="ij")
    v[rows * col + (twist[:, None] + row) % rows] = \
        u[(col * rows + row).ravel()].reshape(ncols, rows)

    # row-wise read: w[j*ncols + col] = v[rows*col + j]
    j, c = np.meshgrid(np.arange(rows), np.arange(ncols), indexing="ij")
    w = v[rows * c + j].reshape(-1)

    # demux: group of ncols bits -> bit positions (ncols-1-mux[e])
    rk = rate.replace("/", "_")
    mux_key = constellation if not (constellation == "256qam" and
                                    framesize == "short") else "256qamS"
    variant = None
    suffix = "N" if framesize == "normal" else "S"
    cand = f"{rate}{suffix}"
    if (mux_key, cand) in _MUX:
        variant = cand
    mux = np.array(_MUX[(mux_key, variant)], np.int64)
    ngroups = frame // ncols
    out = np.zeros(frame, np.int64)
    for e in range(ncols):
        # stream bit e of each group has pack significance (ncols-1-mux[e]),
        # i.e. MSB-first output position mux[e]
        out[np.arange(ngroups) * ncols + mux[e]] = \
            w[np.arange(ngroups) * ncols + e]
    return out


def bit_interleave(codeword, cfg: DVBT2Config):
    """[nf, frame] bits -> [nf, frame/m] cell symbol indices."""
    perm = _bit_perm(cfg.framesize, cfg.rate, cfg.constellation)
    b = codeword[..., jnp.asarray(perm)].astype(jnp.int32)
    m = cfg.m
    g = b.reshape(b.shape[:-1] + (-1, m))
    weights = jnp.asarray(1 << np.arange(m - 1, -1, -1), jnp.int32)
    return (g * weights).sum(-1)


def bit_deinterleave(symbols, cfg: DVBT2Config):
    perm = _bit_perm(cfg.framesize, cfg.rate, cfg.constellation)
    m = cfg.m
    bits = ((symbols[..., None] >> jnp.arange(m - 1, -1, -1)) & 1)
    flat = bits.reshape(symbols.shape[:-1] + (-1,))
    inv = np.argsort(perm)
    return flat[..., jnp.asarray(inv)]


# ---------------------------------------------------------------------------
# cell + time interleaver
# ---------------------------------------------------------------------------

_CI_PARAMS = {
    # (framesize, constellation) -> (cell_size, pn_degree, mask, max_states,
    #                                 taps, xor_size)
    ("normal", "qpsk"): (32400, 15, 0x3FFF, 32768, (0, 1, 2, 12)),
    ("normal", "16qam"): (16200, 14, 0x1FFF, 16384, (0, 1, 4, 5, 9, 11)),
    ("normal", "64qam"): (10800, 14, 0x1FFF, 16384, (0, 1, 4, 5, 9, 11)),
    ("normal", "256qam"): (8100, 13, 0xFFF, 8192, (0, 1, 4, 6)),
    ("short", "qpsk"): (8100, 13, 0xFFF, 8192, (0, 1, 4, 6)),
    ("short", "16qam"): (4050, 12, 0x7FF, 4096, (0, 2)),
    ("short", "64qam"): (2700, 12, 0x7FF, 4096, (0, 2)),
    ("short", "256qam"): (2025, 11, 0x3FF, 2048, (0, 3)),
}


@lru_cache(maxsize=16)
def _cell_perm(framesize: str, constellation: str) -> np.ndarray:
    cell_size, deg, mask, max_states, taps = _CI_PARAMS[
        (framesize, constellation)]
    perm = np.zeros(cell_size, np.int64)
    q = 0
    lfsr = 0
    for i in range(max_states):
        if i in (0, 1):
            lfsr = 0
        elif i == 2:
            lfsr = 1
        else:
            r = 0
            for k in taps:
                r ^= (lfsr >> k) & 1
            lfsr &= mask
            lfsr >>= 1
            lfsr |= r << (deg - 2)
        lfsr |= (i % 2) << (deg - 1)
        if lfsr < cell_size:
            perm[q] = lfsr
            q += 1
    assert q == cell_size
    return perm


def _fec_block_shifts(framesize, constellation, nblocks):
    """Bit-reversed counter shifts, skipping values >= cell_size."""
    cell_size, deg, *_ = _CI_PARAMS[(framesize, constellation)]
    shifts = []
    n = 0
    for _ in range(nblocks):
        shift = cell_size
        while shift >= cell_size:
            t, shift = n, 0
            for _p in range(deg):
                shift |= t & 1
                shift <<= 1
                t >>= 1
            n += 1
        shifts.append(shift)
    return np.array(shifts, np.int64)


def cell_interleave(cells, cfg: DVBT2Config):
    """[nblocks, cell_size] -> interleaved (sec 6.4, ti_blocks=0 path):
    out[(perm[w] + shift_r) % cell_size] = in[w] per FEC block r."""
    perm = _cell_perm(cfg.framesize, cfg.constellation)
    n = cells.shape[0]
    shifts = _fec_block_shifts(cfg.framesize, cfg.constellation, n)
    cs = cells.shape[-1]
    dest = (perm[None, :] + shifts[:, None]) % cs
    out = jnp.zeros_like(cells)
    return out.at[jnp.arange(n)[:, None], jnp.asarray(dest)].set(cells)


def cell_deinterleave(cells, cfg: DVBT2Config):
    perm = _cell_perm(cfg.framesize, cfg.constellation)
    n = cells.shape[0]
    shifts = _fec_block_shifts(cfg.framesize, cfg.constellation, n)
    cs = cells.shape[-1]
    src = (perm[None, :] + shifts[:, None]) % cs
    return cells[jnp.arange(n)[:, None], jnp.asarray(src)]


def time_interleave(cells, cfg: DVBT2Config, fec_per_ti: int = 3):
    """Column/row TI (sec 6.5): write column-major over 5*fec_per_ti
    columns, read row-major. cells: [nblocks, cell_size] with nblocks a
    multiple of fec_per_ti."""
    cs = cells.shape[-1]
    rows = cs // 5
    ncols = 5 * fec_per_ti
    ti = cells.reshape(-1, fec_per_ti * cs)          # [nti, rows*ncols]
    m = ti.reshape(ti.shape[0], ncols, rows)         # column-major banks
    out = m.transpose(0, 2, 1).reshape(ti.shape)     # read row-wise
    return out.reshape(cells.shape)


def time_deinterleave(cells, cfg: DVBT2Config, fec_per_ti: int = 3):
    cs = cells.shape[-1]
    rows = cs // 5
    ncols = 5 * fec_per_ti
    ti = cells.reshape(-1, fec_per_ti * cs)
    m = ti.reshape(ti.shape[0], rows, ncols)
    out = m.transpose(0, 2, 1).reshape(ti.shape)
    return out.reshape(cells.shape)


# ---------------------------------------------------------------------------
# cell mapper (rotated constellations)
# ---------------------------------------------------------------------------

_ROTATION_DEG = {"qpsk": 29.0, "16qam": 16.8, "64qam": 8.6,
                 "256qam": 3.576334375}
_QAM_LOOKUP = {
    "16qam": np.array([3.0, 1.0, -3.0, -1.0]),
    "64qam": np.array([7.0, 5.0, 1.0, 3.0, -7.0, -5.0, -1.0, -3.0]),
    "256qam": np.array([15.0, 13.0, 9.0, 11.0, 1.0, 3.0, 7.0, 5.0,
                        -15.0, -13.0, -9.0, -11.0, -1.0, -3.0, -7.0, -5.0]),
}


@lru_cache(maxsize=16)
def t2_constellation(kind: str, rotation: bool) -> np.ndarray:
    if kind == "qpsk":
        norm = np.sqrt(2.0)
        pts = np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / norm
    else:
        lut = _QAM_LOOKUP[kind]
        m = MOD_BITS[kind]
        half = m // 2
        norm = {"16qam": np.sqrt(10.0), "64qam": np.sqrt(42.0),
                "256qam": np.sqrt(170.0)}[kind]
        pts = np.zeros(1 << m, np.complex128)
        for i in range(1 << m):
            # interleaved bit order: even bits -> real, odd bits -> imag
            ri = ii = 0
            for b in range(half):
                ri = (ri << 1) | ((i >> (m - 1 - 2 * b)) & 1)
                ii = (ii << 1) | ((i >> (m - 2 - 2 * b)) & 1)
            pts[i] = complex(lut[ri], lut[ii]) / norm
    if rotation:
        pts = pts * np.exp(1j * np.deg2rad(_ROTATION_DEG[kind]))
    return pts.astype(np.complex64)


def map_cells(symbols, cfg: DVBT2Config):
    """[nf, cell_size] symbol indices -> complex cells; with rotation on,
    the Q component is cyclically delayed by one cell within the FEC block
    (EN 302 755 6.3.3)."""
    lut = jnp.asarray(t2_constellation(cfg.constellation, cfg.rotation))
    pts = lut[symbols]
    if not cfg.rotation:
        return pts
    q = jnp.roll(jnp.imag(pts), 1, axis=-1)
    return jax.lax.complex(jnp.real(pts), q)


def demap_cells(cells, cfg: DVBT2Config):
    lut = jnp.asarray(t2_constellation(cfg.constellation, cfg.rotation))
    if cfg.rotation:
        q = jnp.roll(jnp.imag(cells), -1, axis=-1)
        cells = cells.real + 1j * q
    d = jnp.abs(cells[..., None] - lut) ** 2
    return jnp.argmin(d, axis=-1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# frequency interleaver
# ---------------------------------------------------------------------------

_FREQ_PARAMS = {
    # fft -> (pn_degree, mask, max_states, taps, bitperm_even, bitperm_odd)
    "1K": (9, 0xFF, 1024, (0, 4),
           [8, 7, 6, 5, 0, 1, 2, 3, 4], [6, 8, 7, 4, 1, 0, 5, 2, 3]),
    "2K": (10, 0x3FF, 2048, (0, 3),
           [4, 3, 9, 6, 2, 8, 1, 5, 7, 0], [6, 9, 4, 8, 5, 1, 0, 7, 2, 3]),
    "4K": (11, 0x7FF, 4096, (0, 2),
           [6, 3, 0, 9, 4, 2, 1, 8, 5, 10, 7],
           [5, 9, 1, 4, 3, 0, 8, 10, 7, 2, 6]),
    "8K": (12, 0xFFF, 8192, (0, 1, 4, 6),
           [7, 1, 4, 2, 9, 6, 8, 10, 0, 3, 11, 5],
           [11, 4, 9, 3, 1, 2, 5, 0, 6, 7, 10, 8]),
    "16K": (13, 0x1FFF, 16384, (0, 1, 4, 5, 9, 11),
            [9, 7, 6, 10, 12, 5, 1, 11, 0, 2, 3, 4, 8],
            [6, 8, 10, 12, 2, 0, 4, 1, 11, 3, 5, 9, 7]),
    "32K": (14, 0x3FFF, 32768, (0, 1, 2, 12),
            [7, 13, 3, 4, 9, 2, 12, 11, 1, 8, 10, 0, 5, 6],
            [7, 13, 3, 4, 9, 2, 12, 11, 1, 8, 10, 0, 5, 6]),
}


@lru_cache(maxsize=32)
def _freq_perms(fft: str, c_data: int):
    deg, mask, max_states, taps, bpe, bpo = _FREQ_PARAMS[fft]
    heven = np.zeros(c_data, np.int64)
    hodd = np.zeros(c_data, np.int64)
    qe = qo = 0
    lfsr = 0
    for i in range(max_states):
        if i in (0, 1):
            lfsr = 0
        elif i == 2:
            lfsr = 1
        else:
            r = 0
            for k in taps:
                r ^= (lfsr >> k) & 1
            lfsr &= mask
            lfsr >>= 1
            lfsr |= r << (deg - 1)
        even = odd = 0
        for n in range(deg):
            bit = (lfsr >> n) & 1
            even |= bit << bpe[n]
            odd |= bit << bpo[n]
        even += (i % 2) * (max_states // 2)
        odd += (i % 2) * (max_states // 2)
        if even < c_data and qe < c_data:
            heven[qe] = even
            qe += 1
        if odd < c_data and qo < c_data:
            hodd[qo] = odd
            qo += 1
    return heven, hodd


def freq_interleave(data_cells, fft: str = "8K", pilot_pattern: str = "PP7"):
    """[nsyms, C_DATA] -> interleaved; symbol index parity alternates the
    H permutation (out[j] = in[H[j]])."""
    c_data = data_cells.shape[-1]
    he, ho = _freq_perms(fft, c_data)
    even = data_cells[..., ::2, :][..., jnp.asarray(he)]
    odd = data_cells[..., 1::2, :][..., jnp.asarray(ho)]
    out = jnp.zeros_like(data_cells)
    out = out.at[..., ::2, :].set(even)
    out = out.at[..., 1::2, :].set(odd)
    return out


def freq_deinterleave(data_cells, fft: str = "8K",
                      pilot_pattern: str = "PP7"):
    c_data = data_cells.shape[-1]
    he, ho = _freq_perms(fft, c_data)
    ihe, iho = np.argsort(he), np.argsort(ho)
    even = data_cells[..., ::2, :][..., jnp.asarray(ihe)]
    odd = data_cells[..., 1::2, :][..., jnp.asarray(iho)]
    out = jnp.zeros_like(data_cells)
    out = out.at[..., ::2, :].set(even)
    out = out.at[..., 1::2, :].set(odd)
    return out


def cells_per_symbol(fft: str, pilot_pattern: str):
    """(C_DATA, N_FC, C_FC) for normal carriers, SISO, no PAPR."""
    return CELL_COUNTS[f"{fft}_{pilot_pattern.replace('PP', 'PP')}"]


# ---------------------------------------------------------------------------
# P1 preamble
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _p1_randomizer() -> np.ndarray:
    sr = 0x4E46
    out = np.zeros(384, np.int64)
    for i in range(384):
        b = (sr ^ (sr >> 1)) & 1
        out[i] = 1 if b == 0 else -1
        sr >>= 1
        if b:
            sr |= 0x4000
    return out


@lru_cache(maxsize=16)
def p1_symbol(s1: int = 0, s2_fft: int = 3) -> np.ndarray:
    """Time-domain P1 preamble, 2048 samples: C (542, freq-shifted head),
    A (1024), B (482, freq-shifted tail). s1 = preamble format (0 = T2
    SISO), s2_fft = FFT-size code (field S2 = s2_fft << 1)."""
    s2 = (s2_fft & 0x7) << 1
    seq = []
    for byte in S1_PATTERNS[s1]:
        seq += [(byte >> j) & 1 for j in range(7, -1, -1)]
    for byte in S2_PATTERNS[s2]:
        seq += [(byte >> j) & 1 for j in range(7, -1, -1)]
    for byte in S1_PATTERNS[s1]:
        seq += [(byte >> j) & 1 for j in range(7, -1, -1)]
    # DBPSK
    d = np.ones(385, np.int64)
    for i in range(1, 385):
        d[i] = -d[i - 1] if seq[i - 1] == 1 else d[i - 1]
    d = d[1:] * _p1_randomizer()
    freq = np.zeros(1024, np.complex128)
    freq[np.array(P1_ACTIVE_CARRIERS) + 86] = d
    a = np.fft.ifft(np.fft.ifftshift(freq)) * 1024 / np.sqrt(384.0)
    fs = np.roll(freq, 1)  # +1 carrier frequency shift
    b = np.fft.ifft(np.fft.ifftshift(fs)) * 1024 / np.sqrt(384.0)
    return np.concatenate([b[:542], a, b[542:]]).astype(np.complex64)


def p1_insert(frame_samples, s1: int = 0, s2_fft: int = 3):
    """Prepend the 2048-sample P1 preamble to each T2 frame."""
    p1 = jnp.asarray(p1_symbol(s1, s2_fft))
    reps = frame_samples.shape[0]
    return jnp.concatenate(
        [jnp.tile(p1[None], (reps, 1)), frame_samples], axis=1)


# ---------------------------------------------------------------------------
# chain
# ---------------------------------------------------------------------------

def dvbt2_fec_to_cells(bbframes, cfg: DVBT2Config):
    """Scrambled BBFRAME bits [nf, kbch] -> mapped, cell+time-interleaved
    cells [nf, cell_size] (BCH -> LDPC(T2) -> bit il -> map -> cell il)."""
    bch = dvbs2.bch_encode(bbframes, cfg)
    cw = ldpc_encode(bch, cfg)
    syms = bit_interleave(cw, cfg)
    cells = map_cells(syms, cfg)
    return cell_interleave(cells, cfg)
