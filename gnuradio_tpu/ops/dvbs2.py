"""gr-dtv DVB-S2: BBFRAME framing, BCH, LDPC, bit interleaver, APSK
modulator, physical-layer framer (ETSI EN 302 307-1).

Reference behavior (reimplemented, NOT copied):
  gr-dtv/lib/dvb/dvb_bbheader_bb_impl.cc   — 80-bit BBHEADER (matype, upl,
      dfl, sync, syncd) + CRC-8 (poly 0xAB, LSB-first shift); TS packets'
      0x47 sync replaced by CRC-8 of the previous packet's 187 bytes.
  gr-dtv/lib/dvb/dvb_bbscrambler_bb_impl.cc — PRBS x^15+x^14+1, seed 0x4A80
      (bit-reversed 100101010000000), XOR over the whole BBFRAME.
  gr-dtv/lib/dvb/dvb_bch_bb_impl.cc        — BCH(nbch, kbch) t=12/10/8 over
      GF(2^16) (normal) / GF(2^14) (short). The generator polynomial is the
      product of the minimal polynomials of alpha^1..alpha^(2t-1) (odd) —
      computed here from the field primitive polynomial instead of copying
      the reference's hardcoded factor tables. Encode = one GF(2) matmul
      (bits x remainder-matrix) as a matmul.
  gr-dtv/lib/dvb/dvb_ldpc_bb_impl.cc       — IRA LDPC: info bit (r*360+n)
      accumulates parity addresses (tab[r][c] + n*q) mod pbits; final
      staircase p[j] ^= p[j-1]. Encode = one scatter-add mod 2 + prefix-XOR
      (cumsum mod 2). Tables: ops/dvb_ldpc_tables.py (ETSI annex data).
  gr-dtv/lib/dvbs2/dvbs2_interleaver_bb_impl.cc — serial->m-bit symbols
      with the standard's column-twist read order per (modulation, rate).
  gr-dtv/lib/dvbs2/dvbs2_modulator_bc_impl.cc   — QPSK/8PSK gray ring,
      16APSK 4+12 / 32APSK 4+12+16 with rate-dependent radius ratios,
      unit-energy normalized.
  gr-dtv/lib/dvbs2/dvbs2_physical_cc_impl.cc    — PLFRAME: 26-symbol SOF +
      64-bit PLS (Reed-Muller (64,7) + complement bit, scrambled by the
      fixed 64-bit sequence), pi/2-BPSK header, 90-symbol slots, optional
      36-symbol pilots every 16 slots, and the 18-bit x/y Gold-sequence
      symbol scrambler (goldcode selects the x offset).

Design: everything except the per-frame LFSRs is static gather/scatter
or one matmul; all index tables and scramble sequences are precomputed
host-side per config and closed over by the jitted chain. The PL scrambler
is a complex multiply by a precomputed rotation vector.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from .dvb_ldpc_tables import TABLES

FRAME_NORMAL = 64800
FRAME_SHORT = 16200

# (framesize, rate) -> (kbch, nbch, bch_t)   EN 302 307-1 tables 5a/5b
BCH_PARAMS = {
    ("normal", "1/4"): (16008, 16200, 12),
    ("normal", "1/3"): (21408, 21600, 12),
    ("normal", "2/5"): (25728, 25920, 12),
    ("normal", "1/2"): (32208, 32400, 12),
    ("normal", "3/5"): (38688, 38880, 12),
    ("normal", "2/3"): (43040, 43200, 10),
    ("normal", "3/4"): (48408, 48600, 12),
    ("normal", "4/5"): (51648, 51840, 12),
    ("normal", "5/6"): (53840, 54000, 10),
    ("normal", "8/9"): (57472, 57600, 8),
    ("normal", "9/10"): (58192, 58320, 8),
    ("short", "1/4"): (3072, 3240, 12),
    ("short", "1/3"): (5232, 5400, 12),
    ("short", "2/5"): (6312, 6480, 12),
    ("short", "1/2"): (7032, 7200, 12),
    ("short", "3/5"): (9552, 9720, 12),
    ("short", "2/3"): (10632, 10800, 12),
    ("short", "3/4"): (11712, 11880, 12),
    ("short", "4/5"): (12432, 12600, 12),
    ("short", "5/6"): (13152, 13320, 12),
    ("short", "8/9"): (14232, 14400, 12),
}

_LDPC_TAB = {
    ("normal", "1/4"): "1_4N", ("normal", "1/3"): "1_3N",
    ("normal", "2/5"): "2_5N", ("normal", "1/2"): "1_2N",
    ("normal", "3/5"): "3_5N", ("normal", "2/3"): "2_3N_DVBS2",
    ("normal", "3/4"): "3_4N", ("normal", "4/5"): "4_5N",
    ("normal", "5/6"): "5_6N", ("normal", "8/9"): "8_9N",
    ("normal", "9/10"): "9_10N",
    ("short", "1/4"): "1_4S", ("short", "1/3"): "1_3S",
    ("short", "2/5"): "2_5S", ("short", "1/2"): "1_2S",
    ("short", "3/5"): "3_5S_DVBS2", ("short", "2/3"): "2_3S",
    ("short", "3/4"): "3_4S", ("short", "4/5"): "4_5S",
    ("short", "5/6"): "5_6S", ("short", "8/9"): "8_9S",
}

MODCOD = {  # EN 302 307-1 table 12
    ("qpsk", "1/4"): 1, ("qpsk", "1/3"): 2, ("qpsk", "2/5"): 3,
    ("qpsk", "1/2"): 4, ("qpsk", "3/5"): 5, ("qpsk", "2/3"): 6,
    ("qpsk", "3/4"): 7, ("qpsk", "4/5"): 8, ("qpsk", "5/6"): 9,
    ("qpsk", "8/9"): 10, ("qpsk", "9/10"): 11,
    ("8psk", "3/5"): 12, ("8psk", "2/3"): 13, ("8psk", "3/4"): 14,
    ("8psk", "5/6"): 15, ("8psk", "8/9"): 16, ("8psk", "9/10"): 17,
    ("16apsk", "2/3"): 18, ("16apsk", "3/4"): 19, ("16apsk", "4/5"): 20,
    ("16apsk", "5/6"): 21, ("16apsk", "8/9"): 22, ("16apsk", "9/10"): 23,
    ("32apsk", "3/4"): 24, ("32apsk", "4/5"): 25, ("32apsk", "5/6"): 26,
    ("32apsk", "8/9"): 27, ("32apsk", "9/10"): 28,
}

MOD_BITS = {"qpsk": 2, "8psk": 3, "16apsk": 4, "32apsk": 5}

# 16APSK gamma = r2/r1 (table 9), 32APSK gamma1 = r2/r1, gamma2 = r3/r1
# (table 10) — stored as the reference does: r1 = r_outer / divisor.
_APSK16_DIV = {"2/3": 3.15, "3/4": 2.85, "4/5": 2.75, "5/6": 2.70,
               "8/9": 2.60, "9/10": 2.57}
_APSK32_DIV = {"3/4": (5.27, 2.84), "4/5": (4.87, 2.72),
               "5/6": (4.64, 2.64), "8/9": (4.33, 2.54),
               "9/10": (4.30, 2.53)}


class DVBS2Config:
    def __init__(self, framesize="normal", rate="1/2", constellation="qpsk",
                 pilots=False, goldcode=0, rolloff=0.35):
        if (framesize, rate) not in BCH_PARAMS:
            raise ValueError(f"unsupported ({framesize}, {rate})")
        if constellation not in MOD_BITS:
            raise ValueError(f"unsupported constellation {constellation}")
        self.framesize, self.rate = framesize, rate
        self.constellation = constellation
        self.pilots = bool(pilots)
        self.goldcode = int(goldcode)
        self.rolloff = rolloff
        self.frame = FRAME_NORMAL if framesize == "normal" else FRAME_SHORT
        self.kbch, self.nbch, self.bch_t = BCH_PARAMS[(framesize, rate)]
        self.q = (self.frame - self.nbch) // 360
        self.ldpc_table = TABLES[_LDPC_TAB[(framesize, rate)]]
        self.m = MOD_BITS[constellation]
        self.modcod = MODCOD.get((constellation, rate))
        self.slots = self.frame // self.m // 90


# ---------------------------------------------------------------------------
# BB header / scrambler
# ---------------------------------------------------------------------------

_CRC8_POLY = 0xAB  # LSB-first shift register (dvb_bbheader add_crc8_bits)


def _crc8_bits(bits: np.ndarray) -> np.ndarray:
    crc = 0
    for bit in bits:
        b = int(bit) ^ (crc & 1)
        crc >>= 1
        if b:
            crc ^= _CRC8_POLY
    return np.array([(crc >> n) & 1 for n in range(8)], np.int64)


def _crc8_bytes_msb(data: np.ndarray) -> int:
    """CRC-8 over bytes MSB-first with poly 0xD5<<1|1 table form
    (bbheader check_crc8_bits equivalent for TS sync replacement)."""
    crc = 0
    for byte in data:
        for k in range(7, -1, -1):
            b = ((int(byte) >> k) & 1) ^ (crc & 1)
            crc >>= 1
            if b:
                crc ^= _CRC8_POLY
    return crc


def bbheader_frame(ts_bytes: np.ndarray, cfg: DVBS2Config) -> np.ndarray:
    """Pack MPEG TS packets into BBFRAMEs of kbch bits (host-side bit
    plumbing; CCM, single stream, TS input, no null deletion/ISSY).

    ts_bytes: [npkts*188]; returns [nframes, kbch] bits. Each packet's
    0x47 sync byte is replaced by the CRC-8 of the previous packet's 187
    payload bytes (first packet: 0)."""
    pkts = np.asarray(ts_bytes, np.int64).reshape(-1, 188)
    kbch = cfg.kbch
    dfl = kbch - 80
    pkt_bits = 188 * 8
    npkt_per_frame = dfl // pkt_bits
    nframes = pkts.shape[0] // npkt_per_frame
    pkts = pkts[:nframes * npkt_per_frame]
    # replace syncs with running CRC-8
    crc = 0
    data = pkts.copy()
    for i in range(data.shape[0]):
        data[i, 0] = crc
        crc = _crc8_bytes_msb(pkts[i, 1:])
    frames = np.zeros((nframes, kbch), np.int64)
    # header: matype-1 = TS|single|CCM|no-issyi|no-npd|ro
    ro_bits = {0.35: (0, 0), 0.25: (0, 1), 0.20: (1, 0)}[cfg.rolloff]
    hdr = [1, 1,           # ts_gs = TS (11)
           1,              # sis_mis = single
           1,              # ccm
           0, 0,           # issyi, npd
           ro_bits[0], ro_bits[1]]
    hdr += [0] * 8                                   # matype-2
    upl = 188 * 8
    hdr += [(upl >> n) & 1 for n in range(15, -1, -1)]
    hdr += [(dfl >> n) & 1 for n in range(15, -1, -1)]
    hdr += [(0x47 >> n) & 1 for n in range(7, -1, -1)]
    syncd = 0
    hdr += [(syncd >> n) & 1 for n in range(15, -1, -1)]
    hdr = np.array(hdr, np.int64)
    for f in range(nframes):
        h = np.concatenate([hdr, _crc8_bits(hdr)])
        bits = np.unpackbits(
            data[f * npkt_per_frame:(f + 1) * npkt_per_frame]
            .astype(np.uint8)).astype(np.int64)
        frames[f, :80] = h
        frames[f, 80:80 + bits.size] = bits
    return frames


@lru_cache(maxsize=1)
def _bb_scramble_seq() -> np.ndarray:
    """PRBS x^15+x^14+1, seed 0x4A80 (dvb_bbscrambler init)."""
    sr = 0x4A80
    out = np.zeros(FRAME_NORMAL, np.int64)
    for i in range(FRAME_NORMAL):
        b = (sr ^ (sr >> 1)) & 1
        out[i] = b
        sr >>= 1
        if b:
            sr |= 0x4000
    return out


def bbscramble(frames):
    """[..., kbch] bits -> scrambled (self-inverse)."""
    k = frames.shape[-1]
    return frames ^ jnp.asarray(_bb_scramble_seq()[:k])


# ---------------------------------------------------------------------------
# BCH (encode = GF(2) matmul)
# ---------------------------------------------------------------------------

# field primitive polynomials (EN 302 307-1 table 6a first factor)
_BCH_PRIM = {"normal": (16, 0x1002D),   # 1+x^2+x^3+x^5+x^16
             "short": (14, 0x402B)}     # 1+x+x^3+x^5+x^14


def _minimal_polys(m: int, prim: int, t: int) -> list:
    """Minimal polynomials of alpha^(2i-1), i=1..t, over GF(2^m)."""
    size = 1 << m
    # log/exp tables
    exp = np.zeros(2 * size, np.int64)
    x = 1
    for i in range(size - 1):
        exp[i] = x
        x <<= 1
        if x & size:
            x ^= prim
    polys = []
    for i in range(1, 2 * t, 2):
        # conjugacy class of alpha^i
        cyc, e = [], i
        while e not in cyc:
            cyc.append(e)
            e = (e * 2) % (size - 1)
        # poly = prod (x - alpha^e) over the class, GF(2^m) coefficients
        poly = [1]
        for e in cyc:
            root = exp[e]
            new = [0] * (len(poly) + 1)
            for d, c in enumerate(poly):
                new[d] ^= _gf_mul(c, root, m, prim)
                new[d + 1] ^= c
            poly = new
        assert all(c in (0, 1) for c in poly)
        polys.append(poly)
    return polys


def _gf_mul(a: int, b: int, m: int, prim: int) -> int:
    r = 0
    size = 1 << m
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & size:
            a ^= prim
        b >>= 1
    return r


@lru_cache(maxsize=8)
def bch_generator(framesize: str, t: int) -> np.ndarray:
    """Generator polynomial coefficients (LSB=x^0 first), degree = parity
    count (160/192 short/normal variants per t)."""
    m, prim = _BCH_PRIM[framesize]
    g = np.array([1], np.int64)
    for p in _minimal_polys(m, prim, t):
        pa = np.array(p, np.int64)
        res = np.zeros(g.size + pa.size - 1, np.int64)
        for d, c in enumerate(pa):
            if c:
                res[d:d + g.size] ^= g
        g = res & 1
    return g


@lru_cache(maxsize=8)
def _bch_remainder_matrix(framesize: str, rate: str) -> np.ndarray:
    """P[kbch, nparity]: row i = x^(nparity + kbch-1-i) mod g(x), so that
    parity = bits @ P mod 2 (bits in transmission order, MSB-first)."""
    kbch, nbch, t = BCH_PARAMS[(framesize, rate)]
    g = bch_generator(framesize, t)
    npar = g.size - 1
    P = np.zeros((kbch, npar), np.int8)
    # r = x^npar mod g initially (for the LAST message bit i = kbch-1)
    r = np.zeros(npar, np.int64)
    if npar:
        # x^npar mod g = g - x^npar  (g monic) -> coeffs g[0..npar-1]
        r = g[:npar].copy()
    P[kbch - 1] = r
    for i in range(kbch - 2, -1, -1):
        # multiply by x mod g
        carry = r[npar - 1]
        r = np.roll(r, 1)
        r[0] = 0
        if carry:
            r ^= g[:npar]
            r &= 1
        P[i] = r
    # transmission order: parity x^(npar-1) first
    return P[:, ::-1].copy()


def bch_encode(frames, cfg: DVBS2Config):
    """[nf, kbch] bits -> [nf, nbch]: data || parity. One f32 matmul."""
    P = jnp.asarray(_bch_remainder_matrix(cfg.framesize, cfg.rate),
                    jnp.float32)
    b = frames.astype(jnp.float32)
    parity = (b @ P).astype(jnp.int32) & 1
    return jnp.concatenate([frames.astype(jnp.int32), parity], axis=-1)


# ---------------------------------------------------------------------------
# LDPC (scatter-add mod 2 + prefix XOR)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def _ldpc_pairs(framesize: str, rate: str):
    """(bit_idx, parity_addr) arrays for all accumulations."""
    cfg_k = BCH_PARAMS[(framesize, rate)]
    nbch = cfg_k[1]
    frame = FRAME_NORMAL if framesize == "normal" else FRAME_SHORT
    q = (frame - nbch) // 360
    table = TABLES[_LDPC_TAB[(framesize, rate)]]
    bit_idx, addr = [], []
    for r, row in enumerate(table):
        base = np.arange(360)
        for x in row:
            bit_idx.append(r * 360 + base)
            addr.append((x + base * q) % (frame - nbch))
    return (np.concatenate(bit_idx).astype(np.int32),
            np.concatenate(addr).astype(np.int32))


def ldpc_encode(coded, cfg: DVBS2Config):
    """[nf, nbch] bits -> [nf, frame]: systematic || staircase parity."""
    bit_idx, addr = _ldpc_pairs(cfg.framesize, cfg.rate)
    pbits = cfg.frame - cfg.nbch
    info = coded.astype(jnp.int32)
    acc = jnp.zeros(coded.shape[:-1] + (pbits,), jnp.int32)
    acc = acc.at[..., jnp.asarray(addr)].add(info[..., jnp.asarray(bit_idx)])
    parity = jnp.cumsum(acc & 1, axis=-1) & 1   # prefix XOR = staircase
    return jnp.concatenate([info, parity], axis=-1)


def ldpc_syndrome(codeword, cfg: DVBS2Config):
    """Check-node parity sums (must be all zero for a valid codeword):
    check j (j = 0..pbits-1) covers accumulated info bits + p[j] + p[j-1]."""
    bit_idx, addr = _ldpc_pairs(cfg.framesize, cfg.rate)
    pbits = cfg.frame - cfg.nbch
    c = codeword.astype(jnp.int32)
    info, parity = c[..., :cfg.nbch], c[..., cfg.nbch:]
    acc = jnp.zeros(c.shape[:-1] + (pbits,), jnp.int32)
    acc = acc.at[..., jnp.asarray(addr)].add(info[..., jnp.asarray(bit_idx)])
    prev = jnp.concatenate(
        [jnp.zeros(parity.shape[:-1] + (1,), jnp.int32),
         parity[..., :-1]], axis=-1)
    return (acc + parity + prev) & 1


# ---------------------------------------------------------------------------
# bit interleaver (column twist) + constellations
# ---------------------------------------------------------------------------

def _column_order(cfg: DVBS2Config):
    """Column read order (dvbs2_interleaver rowaddr*)."""
    if cfg.constellation == "8psk":
        if cfg.rate == "3/5":
            return (2, 1, 0)
        return (0, 1, 2)
    if cfg.constellation == "16apsk":
        if cfg.rate == "3/5":
            return (3, 2, 1, 0)
        return (0, 1, 2, 3)
    if cfg.constellation == "32apsk":
        return (0, 1, 2, 3, 4)
    return None


def interleave_bits(codeword, cfg: DVBS2Config):
    """[nf, frame] bits -> [nf, frame/m] symbol indices."""
    m = cfg.m
    rows = cfg.frame // m
    if cfg.constellation == "qpsk":
        b = codeword.reshape(codeword.shape[:-1] + (rows, 2))
        return (b[..., 0] << 1) | b[..., 1]
    order = _column_order(cfg)
    cols = codeword.reshape(codeword.shape[:-1] + (m, rows))
    sym = jnp.zeros(codeword.shape[:-1] + (rows,), jnp.int32)
    for outbit, col in enumerate(order):
        sym = sym | (cols[..., col, :].astype(jnp.int32)
                     << (m - 1 - outbit))
    return sym


@lru_cache(maxsize=32)
def constellation(kind: str, rate: str = "") -> np.ndarray:
    """Unit-energy constellation LUT indexed by symbol value."""
    if kind == "qpsk":
        ang = np.array([1, 7, 3, 5]) * np.pi / 4
        return np.exp(1j * ang).astype(np.complex64)
    if kind == "8psk":
        ang = np.array([1, 0, 4, 5, 2, 7, 3, 6]) * np.pi / 4
        return np.exp(1j * ang).astype(np.complex64)
    if kind == "16apsk":
        r2 = 1.0
        r1 = r2 / _APSK16_DIV[rate]
        r0 = np.sqrt(4.0 / (r1 * r1 + 3.0 * r2 * r2))
        r1, r2 = r1 * r0, r2 * r0
        outer = np.array([1, -1, 3, -3]) * np.pi / 4
        outer12 = np.array([1, -1, 11, -11, 5, -5, 7, -7]) * np.pi / 12
        pts = np.concatenate([
            r2 * np.exp(1j * outer),
            r2 * np.exp(1j * outer12),
            r1 * np.exp(1j * outer)])
        return pts.astype(np.complex64)
    if kind == "32apsk":
        r3 = 1.0
        d1, d2 = _APSK32_DIV[rate]
        r1 = r3 / d1
        r2 = r1 * d2
        r0 = np.sqrt(8.0 / (r1 * r1 + 3.0 * r2 * r2 + 4.0 * r3 * r3))
        r1, r2, r3 = r1 * r0, r2 * r0, r3 * r0
        a = np.pi
        pts = np.zeros(32, np.complex128)
        mid = lambda k: r2 * np.exp(1j * k * a)
        out = lambda k: r3 * np.exp(1j * k * a)
        inn = lambda k: r1 * np.exp(1j * k * a)
        pts[0] = mid(1 / 4); pts[1] = mid(5 / 12); pts[2] = mid(-1 / 4)
        pts[3] = mid(-5 / 12); pts[4] = mid(3 / 4); pts[5] = mid(7 / 12)
        pts[6] = mid(-3 / 4); pts[7] = mid(-7 / 12)
        pts[8] = out(1 / 8); pts[9] = out(3 / 8); pts[10] = out(-1 / 4)
        pts[11] = out(-1 / 2); pts[12] = out(3 / 4); pts[13] = out(1 / 2)
        pts[14] = out(-7 / 8); pts[15] = out(-5 / 8)
        pts[16] = mid(1 / 12); pts[17] = inn(1 / 4); pts[18] = mid(-1 / 12)
        pts[19] = inn(-1 / 4); pts[20] = mid(11 / 12); pts[21] = inn(3 / 4)
        pts[22] = mid(-11 / 12); pts[23] = inn(-3 / 4)
        pts[24] = out(0); pts[25] = out(1 / 4); pts[26] = out(-1 / 8)
        pts[27] = out(-3 / 8); pts[28] = out(7 / 8); pts[29] = out(5 / 8)
        pts[30] = out(1); pts[31] = out(-3 / 4)
        return pts.astype(np.complex64)
    if kind in ("64qam", "256qam"):
        # J.83B square-QAM grids served by the reference dvbs2_modulator
        # for the CATV TX examples (dvbs2_modulator_bc_impl.cc:2328+,
        # unnormalized integer grid as in the reference)
        from .dvbs2_qam_tables import QAM64, QAM256
        tab = QAM64 if kind == "64qam" else QAM256
        return np.array([complex(r, i) for r, i in tab], np.complex64)
    raise ValueError(kind)


def modulate(symbols, cfg: DVBS2Config):
    lut = jnp.asarray(constellation(cfg.constellation, cfg.rate))
    return lut[symbols]


def demodulate(points, cfg: DVBS2Config):
    """Nearest-point hard demap -> symbol indices (QA loopback)."""
    lut = jnp.asarray(constellation(cfg.constellation, cfg.rate))
    d = jnp.abs(points[..., None] - lut) ** 2
    return jnp.argmin(d, axis=-1).astype(jnp.int32)


def deinterleave_bits(symbols, cfg: DVBS2Config):
    """Inverse of interleave_bits: [nf, frame/m] -> [nf, frame] bits."""
    m = cfg.m
    rows = cfg.frame // m
    bits = ((symbols[..., None] >> jnp.arange(m - 1, -1, -1)) & 1)
    if cfg.constellation == "qpsk":
        return bits.reshape(symbols.shape[:-1] + (rows * 2,))
    order = _column_order(cfg)
    cols = jnp.zeros(symbols.shape[:-1] + (m, rows), jnp.int32)
    for outbit, col in enumerate(order):
        cols = cols.at[..., col, :].set(bits[..., outbit])
    return cols.reshape(symbols.shape[:-1] + (m * rows,))


# ---------------------------------------------------------------------------
# physical layer framing
# ---------------------------------------------------------------------------

# PLS (64,7) generator (EN 302 307-1 5.5.2.4) + fixed scramble sequence
_PLS_G = (0x90AC2DDD, 0x55555555, 0x33333333, 0x0F0F0F0F,
          0x00FF00FF, 0x0000FFFF, 0xFFFFFFFF)
_PLS_SCRAMBLE = np.array(
    [0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 1, 1, 0, 0, 0, 0, 0,
     1, 1, 1, 1, 0, 0, 1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 1, 1, 0, 1, 0, 0,
     0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 0, 1, 0],
    np.int64)
_SOF = np.array([0, 1, 1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 1, 0,
                 1, 0, 0, 0, 0, 0, 1, 0], np.int64)


def pl_header_bits(modcod: int, short_frame: bool, pilots: bool):
    """90 bits: SOF + scrambled (64,7)+complement PLS code."""
    typ = (2 if short_frame else 0) | (1 if pilots else 0)
    code = (modcod << 2) | typ
    temp = 0
    for k in range(7):
        if code & (0x80 >> k):
            temp ^= _PLS_G[k]
    bits = np.zeros(64, np.int64)
    for m_ in range(32):
        b = (temp >> (31 - m_)) & 1
        bits[2 * m_] = b
        bits[2 * m_ + 1] = b ^ (code & 1)
    bits ^= _PLS_SCRAMBLE
    return np.concatenate([_SOF, bits])


def _pi2_bpsk(bits: np.ndarray) -> np.ndarray:
    """pi/2-BPSK: even index: bit0 -> e^{j pi/4}, bit1 -> e^{j5pi/4};
    odd index: bit0 -> e^{j3pi/4}, bit1 -> e^{-j pi/4}."""
    n = np.arange(bits.size)
    s = 1.0 - 2.0 * bits
    even = (1 + 1j) / np.sqrt(2)
    odd = (-1 + 1j) / np.sqrt(2)
    return np.where(n % 2 == 0, s * even, s * odd).astype(np.complex64)


def _parity32(x: int, mask: int) -> int:
    return bin(x & mask).count("1") & 1


@lru_cache(maxsize=8)
def pl_scramble_codes(goldcode: int = 0, n: int = FRAME_NORMAL):
    """Per-symbol rotation codes Rn in {0,1,2,3} from the 18-bit x/y Gold
    sequences (dvbs2_physical build_symbol_scrambler_table)."""
    x, y = 0x00001, 0x3FFFF
    for _ in range(goldcode):
        xb = _parity32(x, 0x0081)
        x = (x >> 1) | (0x20000 if xb else 0)
    out = np.zeros(n, np.int64)
    for i in range(n):
        xa = _parity32(x, 0x8050)
        xb = _parity32(x, 0x0081)
        xc = x & 1
        x = (x >> 1) | (0x20000 if xb else 0)
        ya = _parity32(y, 0x04A1)
        yb = _parity32(y, 0xFF60)
        yc = y & 1
        y = (y >> 1) | (0x20000 if ya else 0)
        out[i] = ((xa ^ yb) << 1) + (xc ^ yc)
    return out


def physical_frame(points, cfg: DVBS2Config):
    """XFECFRAME symbols [nf, slots*90] -> PLFRAMEs [nf, plen]:
    90-symbol PL header + scrambled payload (+ pilots every 16 slots)."""
    nf = points.shape[0]
    slots = cfg.slots
    hdr = _pi2_bpsk(pl_header_bits(cfg.modcod, cfg.framesize == "short",
                                   cfg.pilots))
    if cfg.pilots:
        ngroups = (slots - 1) // 16
    else:
        ngroups = 0
    pilot = np.full(36, (1 + 1j) / np.sqrt(2), np.complex64)
    # payload assembly with scramble index continuing across pilots
    codes = pl_scramble_codes(cfg.goldcode)
    rot = np.exp(1j * np.pi / 2 * codes).astype(np.complex64)
    out = []
    for f in range(nf):
        seq = [jnp.asarray(hdr)]
        n = 0
        consumed = 0
        pts = points[f]
        for j in range(slots):
            blk = pts[consumed:consumed + 90] * jnp.asarray(
                rot[n:n + 90])
            seq.append(blk)
            consumed += 90
            n += 90
            if cfg.pilots and (j + 1) % 16 == 0 and j < slots - 1:
                seq.append(jnp.asarray(pilot * rot[n:n + 36]))
                n += 36
        out.append(jnp.concatenate(seq))
    return jnp.stack(out)


def physical_deframe(plframes, cfg: DVBS2Config):
    """Strip header/pilots, undo scrambling -> [nf, slots*90] symbols."""
    slots = cfg.slots
    codes = pl_scramble_codes(cfg.goldcode)
    rot = np.exp(-1j * np.pi / 2 * codes).astype(np.complex64)
    out = []
    for f in range(plframes.shape[0]):
        pts = plframes[f][90:]
        seq = []
        n = 0
        pos = 0
        for j in range(slots):
            seq.append(pts[pos:pos + 90] * jnp.asarray(rot[n:n + 90]))
            pos += 90
            n += 90
            if cfg.pilots and (j + 1) % 16 == 0 and j < slots - 1:
                pos += 36
                n += 36
        out.append(jnp.concatenate(seq))
    return jnp.stack(out)


# ---------------------------------------------------------------------------
# full chains
# ---------------------------------------------------------------------------

def dvbs2_tx(ts_bytes, cfg: DVBS2Config):
    """MPEG TS bytes -> PLFRAME symbols [nframes, plen] complex64."""
    bb = jnp.asarray(bbheader_frame(np.asarray(ts_bytes), cfg))
    sc = bbscramble(bb)
    bch = bch_encode(sc, cfg)
    cw = ldpc_encode(bch, cfg)
    syms = interleave_bits(cw, cfg)
    pts = modulate(syms, cfg)
    return physical_frame(pts, cfg)


def dvbs2_rx_loopback(plframes, cfg: DVBS2Config):
    """Hard-decision loopback: PLFRAMEs -> BBFRAME bits [nf, kbch]
    (descrambled; header parsing left to the caller)."""
    pts = physical_deframe(plframes, cfg)
    syms = demodulate(pts, cfg)
    cw = deinterleave_bits(syms, cfg)
    bb = bbscramble(cw[..., :cfg.kbch])
    return bb


def dvbs2_modulator_bc(constellation="qpsk", rate="", **_):
    """dvbs2_modulator_bc (dvbs2_modulator_bc_impl.cc): symbol codes ->
    constellation points. Also serves the MOD_8VSB mode the ATSC TX .grc
    uses (real bipolar levels 2s-7 + 1.25 pilot as complex)."""
    import jax.numpy as _jnp
    from ..core.block import SyncBlock
    from ..core.stream import PortSpec, B as _B, C as _C

    kind = str(constellation).lower()
    if "8vsb" in kind or "vsb" in kind:
        from . import atsc as _atsc
        table = (_atsc.vsb_map(np.arange(8), pilot=True)
                 .astype(np.complex64))
        table = np.asarray(table, np.complex64)
    else:
        k = {"mod_qpsk": "qpsk", "mod_8psk": "8psk",
             "mod_16apsk": "16apsk", "mod_32apsk": "32apsk"}.get(kind, kind)
        table = constellation_lut(k, str(rate))

    class _Mod(SyncBlock):
        def __init__(self, name=None):
            super().__init__(PortSpec(_B), PortSpec(_C), name)

        def work(self, state, x):
            idx = (x.astype(_jnp.int32) & 0xFF) % table.shape[0]
            return state, _jnp.asarray(table)[idx]

    return _Mod()


# keep the functional name reachable for the factory above without
# shadowing by the class stub
constellation_lut = constellation
