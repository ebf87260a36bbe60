"""gr-dtv CATV (ITU-T J.83 Annex B / ANSI-SCTE 07) 64QAM transmit chain.

Reference behavior (reimplemented, NOT copied):
  gr-dtv/lib/catv/catv_transport_framing_enc_bb_impl.cc — per 188-byte TS
      packet: drop the 0x47 sync, append the parity checksum byte computed
      by the three-register LFSR construction (taps G=0xB1, B=0x45, result
      seed 0x67).
  gr-dtv/lib/catv/catv_reed_solomon_enc_bb_impl.cc — RS(128,122) over
      GF(2^7) (x^7+x^3+1), generator roots alpha^{52,116,119,61,15} plus a
      final parity symbol = codeword evaluated at alpha^6 (SCTE 07 p.7).
  gr-dtv/lib/catv/catv_randomizer_bb_impl.cc — 7-bit symbol randomizer:
      three GF(128) registers, rseq[n] = c2, update (c2,c1,c0) <-
      (c1, c0^c2, alpha^3*c2); period 60*128 symbols (64QAM frame).
  gr-dtv/lib/catv/catv_frame_sync_enc_bb_impl.cc — 64QAM frame: 60 RS
      blocks of 128 7-bit symbols as bits + the 42-bit sync word
      0x75 0x2C 0x0D 0x6C + control word.
  gr-dtv/lib/catv/catv_trellis_enc_bb_impl.cc — 14/15 punctured trellis:
      per 28-bit group, 20 uncoded bits pass through to fixed QAM bit
      positions and 2x4 bits go through the differential precoder and the
      rate-4/5 binary convolution (G1/G2 taps), yielding 5 six-bit QAM
      symbols. Implemented as a lax.scan over groups with the precoder /
      coder states as int32 carries and all tables precomputed host-side.

The interleaver between RS and randomizer is the standard Forney
convolutional interleaver (ops.dtv.conv_interleave, I=128 J=1 for 64QAM
level 2 interleaving) operating on 7-bit symbols.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# transport framing (checksum byte)
# ---------------------------------------------------------------------------

_TAPS_G = 0xB1
_TAPS_B = 0x45


@lru_cache(maxsize=1)
def _crc_table() -> np.ndarray:
    """8-clock LFSR jump table: state' = table[state ^ bitrev(byte)]."""
    tab = np.zeros(256, np.int64)
    for d in range(256):
        st = d
        for _ in range(8):
            out = st & 1
            st >>= 1
            if out:
                st ^= _TAPS_G
        tab[d] = st
    return tab


def _bitrev8(b: int) -> int:
    r = 0
    for i in range(8):
        r |= ((b >> i) & 1) << (7 - i)
    return r


def transport_checksum(payload: np.ndarray) -> int:
    """Checksum over a 187-byte packet (compute_sum semantics)."""
    tab = _crc_table()
    r1 = 0
    first7 = [0] * 8
    for i in range(8):
        bit = (int(payload[0]) >> (7 - i)) & 1
        out = (r1 & 1) ^ bit
        if i < 7:
            first7[i + 1] = out
        r1 >>= 1
        if out:
            r1 ^= _TAPS_G
    for i in range(1, 187):
        r1 = int(tab[(r1 ^ _bitrev8(int(payload[i]))) & 0xFF])
    r2 = r3 = 0
    result = 0x67
    for i in range(8):
        o1 = r1 & 1
        r1 >>= 1
        if o1:
            r1 ^= _TAPS_G
        o2 = (r2 & 1) ^ first7[i]
        r2 >>= 1
        if first7[i]:
            r2 ^= _TAPS_B
        o3 = (r3 & 1) ^ o1 ^ o2
        r3 >>= 1
        if o1 ^ o2:
            r3 ^= _TAPS_G
        result ^= o3 << (7 - i)
    return result


def transport_framing(ts_bytes: np.ndarray) -> np.ndarray:
    """[n*188] MPEG TS -> [n*188]: sync dropped, checksum appended."""
    pkts = np.asarray(ts_bytes, np.int64).reshape(-1, 188)
    out = np.zeros_like(pkts)
    out[:, :187] = pkts[:, 1:]
    for i in range(pkts.shape[0]):
        out[i, 187] = transport_checksum(pkts[i, 1:])
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# GF(128) Reed-Solomon (128,122)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _gf128():
    exp = np.zeros(256, np.int64)
    log = np.zeros(128, np.int64)
    exp[0] = 1
    x = 1
    for i in range(1, 127):
        x <<= 1
        if x & 0x80:
            x = (x & 0x7F) ^ 0x09
        exp[i] = x
        log[x] = i
    exp[127:254] = exp[:127]
    return exp, log


def _gf128_mul(a, b):
    exp, log = _gf128()
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    r = exp[(log[a] + log[b]) % 127]
    return np.where((a == 0) | (b == 0), 0, r)


def rs128_encode(symbols: np.ndarray) -> np.ndarray:
    """[n*122] 7-bit symbols -> [n*128] RS codewords."""
    exp, _ = _gf128()
    g = np.array([1, exp[52], exp[116], exp[119], exp[61], exp[15]],
                 np.int64)
    msgs = np.asarray(symbols, np.int64).reshape(-1, 122)
    out = np.zeros((msgs.shape[0], 128), np.int64)
    out[:, :122] = msgs
    for b in range(msgs.shape[0]):
        w = out[b].copy()
        for i in range(122):
            if w[i]:
                w[i + 1:i + 6] ^= _gf128_mul(w[i], g[1:])
            w[i] = msgs[b, i]
        # parity symbol: evaluate at alpha^6
        y = w[0]
        for i in range(1, 127):
            y = int(_gf128_mul(y, exp[6])) ^ int(w[i])
        w[127] = y
        out[b] = w
    return out.reshape(-1)


def rs128_check(codewords: np.ndarray) -> np.ndarray:
    """Syndrome check: g(x) has roots alpha^1..alpha^5, so the first 127
    symbols must evaluate to 0 there (the 128th is the extended parity)."""
    exp, _ = _gf128()
    cw = np.asarray(codewords, np.int64).reshape(-1, 128)
    ok = np.ones(cw.shape[0], bool)
    for root in (1, 2, 3, 4, 5):
        for b in range(cw.shape[0]):
            y = cw[b, 0]
            for i in range(1, 127):
                y = int(_gf128_mul(y, exp[root])) ^ int(cw[b, i])
            ok[b] &= (y == 0)
    return ok


# ---------------------------------------------------------------------------
# randomizer (7-bit symbols)
# ---------------------------------------------------------------------------

FRAME_SYMS_64QAM = 60 * 128


@lru_cache(maxsize=4)
def randomizer_seq(n: int = FRAME_SYMS_64QAM) -> np.ndarray:
    c2 = c1 = c0 = 0x7F
    out = np.zeros(n, np.int64)
    for i in range(n):
        out[i] = c2
        c0n = c2
        for _ in range(3):
            c0n <<= 1
            if c0n & 0x80:
                c0n = (c0n & 0x7F) ^ 0x09
        c2, c1, c0 = c1, c0 ^ c2, c0n
    return out


def randomize(symbols, frame_syms: int = FRAME_SYMS_64QAM):
    """XOR 7-bit symbols with the frame-periodic sequence (self-inverse)."""
    x = symbols.astype(jnp.int32)
    n = x.shape[-1]
    reps = -(-n // frame_syms)
    seq = jnp.asarray(np.tile(randomizer_seq(frame_syms), reps)[:n])
    return x ^ seq


# ---------------------------------------------------------------------------
# frame sync (64QAM)
# ---------------------------------------------------------------------------

_SYNC_64QAM = (0x75, 0x2C, 0x0D, 0x6C)


def frame_sync_insert(symbols, control_word: int = 0):
    """[n*60*128] randomized 7-bit symbols -> bit stream with the 42-bit
    frame sync (0x75 0x2C 0x0D 0x6C + control<<3 + 7 zero bits) appended
    per frame: [n * (60*128*7 + 42)] bits."""
    x = np.asarray(symbols, np.int64).reshape(-1, FRAME_SYMS_64QAM)
    sync = list(_SYNC_64QAM) + [(control_word << 3) & 0x7F, 0]
    sb = ((np.array(sync, np.int64)[:, None] >>
           np.arange(6, -1, -1)) & 1).reshape(-1)          # 42 bits
    out = []
    for f in range(x.shape[0]):
        bits = ((x[f][:, None] >> np.arange(6, -1, -1)) & 1).reshape(-1)
        out.append(np.concatenate([bits, sb]))
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# trellis coder (64QAM, 14/15 punctured)
# ---------------------------------------------------------------------------

def _precode_step(xp, yp, w, z):
    common = z & (xp ^ yp)
    nx = w ^ xp ^ common
    ny = z ^ w ^ yp ^ common
    return nx, ny


@lru_cache(maxsize=1)
def _precoder_table():
    """[4,16,16,3]: new XYp, X nibble, Y nibble."""
    tab = np.zeros((4, 16, 16, 3), np.int64)
    for xyp in range(4):
        for w in range(16):
            for z in range(16):
                xp, yp = (xyp >> 1) & 1, xyp & 1
                X = Y = 0
                for i in range(4):
                    xp, yp = _precode_step(xp, yp, (w >> i) & 1, (z >> i) & 1)
                    X |= xp << i
                    Y |= yp << i
                tab[xyp, w, z] = ((xp << 1) + yp, X, Y)
    return tab


@lru_cache(maxsize=1)
def _trellis_tables():
    """trellis_table[state, nibble] -> (next_state, 5 output bits)."""
    g1 = np.zeros(32, np.int64)
    g2 = np.zeros(32, np.int64)
    for i in range(32):
        g1[i] = ((i >> 4) ^ (i >> 2) ^ i) & 1
        g2[i] = ((i >> 4) ^ (i >> 3) ^ (i >> 2) ^ (i >> 1) ^ i) & 1
    ns = np.zeros((16, 16), np.int64)
    outs = np.zeros((16, 16, 5), np.int64)
    for state in range(16):
        for xy in range(16):
            xq = state
            i = 0
            for n in range(4):
                xq = ((xq << 1) + ((xy >> n) & 1))
                if n == 3:
                    outs[state, xy, i] = g1[xq]
                    i += 1
                outs[state, xy, i] = g2[xq]
                i += 1
                xq &= 0x0F
            ns[state, xy] = xq
    return ns, outs


# uncoded bit placement: (rs bit index, qs word, shift)
_UNCODED_64QAM = [
    (6, 0, 4), (5, 0, 5), (20, 0, 1), (19, 0, 2),
    (4, 1, 4), (3, 1, 5), (18, 1, 1), (17, 1, 2),
    (2, 2, 4), (1, 2, 5), (16, 2, 1), (15, 2, 2),
    (0, 3, 4), (13, 3, 5), (14, 3, 1), (27, 3, 2),
    (12, 4, 4), (11, 4, 5), (26, 4, 1), (25, 4, 2),
]


def trellis_encode_64qam(bits, state=None):
    """[n*28] bits -> [n*5] six-bit QAM symbols + carried coder state.

    state: (XYp, Xq, Yq) int32s. One lax.scan over 28-bit groups: the
    differential precoder and the two 16-state 4/5 coders are table
    lookups on int32 carries; the 20 uncoded bits scatter statically.
    """
    if state is None:
        state = (jnp.int32(0), jnp.int32(0), jnp.int32(0))
    ptab = jnp.asarray(_precoder_table())
    ns, outs = _trellis_tables()
    ns, outs = jnp.asarray(ns), jnp.asarray(outs)
    g = bits.reshape(-1, 28).astype(jnp.int32)

    src = jnp.asarray(np.array([u[0] for u in _UNCODED_64QAM]))
    word = np.array([u[1] for u in _UNCODED_64QAM])
    shift = np.array([u[2] for u in _UNCODED_64QAM])
    contrib_idx = jnp.asarray(word)
    contrib_shift = jnp.asarray(shift)

    def step(carry, rs):
        xyp, xq, yq = carry
        qs = jnp.zeros(5, jnp.int32)
        qs = qs.at[contrib_idx].add(rs[src] << contrib_shift)
        A = (rs[7] << 3) | (rs[8] << 2) | (rs[9] << 1) | rs[10]
        B = (rs[21] << 3) | (rs[22] << 2) | (rs[23] << 1) | rs[24]
        entry = ptab[xyp, A, B]
        X, Y = entry[1], entry[2]
        xyp = entry[0]
        qs = qs + (outs[xq, X] << 3) + outs[yq, Y]
        xq, yq = ns[xq, X], ns[yq, Y]
        return (xyp, xq, yq), qs

    state, q = jax.lax.scan(step, state, g)
    return q.reshape(-1), state


FRAME_SYMS_256QAM = 88 * 128
_SYNC_256QAM = (0x71, 0xE8, 0x4D, 0xD4)


def trellis_encode_256qam(bits, state=None):
    """[n*228] bits -> [n*30] eight-bit QAM symbols + carried state.

    Per catv_trellis_enc_bb_impl.cc trellis_code_256qam: 6 sub-groups of
    38 bits; uncoded bits land at QAM bit positions {5,6,7} (X) and
    {1,2,3} (Y), the coded pair at bits {4,1<<1? -> positions 4 and 0}:
    trellis_x<<1 | trellis_y, i.e. bits 4 and 0. A 2076-period group
    counter swaps in the packed layout for groups 2071-2075 (the frame
    straddling the 40-bit sync word). state = (XYp, Xq, Yq, group).
    """
    if state is None:
        state = (jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0))
    ptab = jnp.asarray(_precoder_table())
    ns, outs = _trellis_tables()
    ns, outs = jnp.asarray(ns), jnp.asarray(outs)
    g = bits.reshape(-1, 228).astype(jnp.int32)

    def subgroup_normal(rs, i):
        base = i * 38
        qs = jnp.zeros(5, jnp.int32)
        for j in range(5):
            o = base + 2 + 8 * j if j < 4 else base + 32
            # rows: qs[j] bits A<<5,6,7 / B<<1,2,3
            qs = qs.at[j].add((rs[o] << 5) + (rs[o + 1] << 6)
                              + (rs[o + 2] << 7) + (rs[o + 3] << 1)
                              + (rs[o + 4] << 2) + (rs[o + 5] << 3))
        A = (rs[base + 24] << 3) | (rs[base + 16] << 2) \
            | (rs[base + 8] << 1) | rs[base + 0]
        B = (rs[base + 25] << 3) | (rs[base + 17] << 2) \
            | (rs[base + 9] << 1) | rs[base + 1]
        return qs, A, B

    def subgroup_special(rs, m):
        base = 38 + 30 * (m - 1)
        qs = jnp.zeros(5, jnp.int32)
        for j in range(5):
            o = base + 6 * j
            qs = qs.at[j].add((rs[o] << 5) + (rs[o + 1] << 6)
                              + (rs[o + 2] << 7) + (rs[o + 3] << 1)
                              + (rs[o + 4] << 2) + (rs[o + 5] << 3))
        b = 188 + 8 * (m - 1)
        A = (rs[b + 6] << 3) | (rs[b + 4] << 2) | (rs[b + 2] << 1) | rs[b]
        B = (rs[b + 7] << 3) | (rs[b + 5] << 2) | (rs[b + 3] << 1) \
            | rs[b + 1]
        return qs, A, B

    def run6(rs, carry, special):
        xyp, xq, yq = carry
        out = []
        for i in range(6):
            if special and i > 0:
                qs, A, B = subgroup_special(rs, i)
            else:
                qs, A, B = subgroup_normal(rs, i)
            entry = ptab[xyp, A, B]
            X, Y = entry[1], entry[2]
            xyp = entry[0]
            # reference: trellis_table_x (coded bit already <<3) shifted
            # <<1 more for 256QAM -> X parity at bit 4, Y parity at bit 0
            qs = qs + (outs[xq, X] << 4) + outs[yq, Y]
            xq, yq = ns[xq, X], ns[yq, Y]
            out.append(qs)
        return jnp.concatenate(out), (xyp, xq, yq)

    def step(carry, rs):
        xyp, xq, yq, grp = carry
        qn, cn = run6(rs, (xyp, xq, yq), False)
        qsp, csp = run6(rs, (xyp, xq, yq), True)
        is_special = grp == 2070
        q = jnp.where(is_special, qsp, qn)
        xyp = jnp.where(is_special, csp[0], cn[0])
        xq = jnp.where(is_special, csp[1], cn[1])
        yq = jnp.where(is_special, csp[2], cn[2])
        grp = (grp + 6) % 2076
        return (xyp, xq, yq, grp), q

    state, q = jax.lax.scan(step, state, g)
    return q.reshape(-1), state


def qam64_map(symbols):
    """Six-bit symbols -> 64QAM points (dvbs2_modulator MOD_64QAM grid is
    used by the reference TX example; x = bits[5:3], y = bits[2:0])."""
    lut1d = np.array([7.0, 5.0, 1.0, 3.0, -7.0, -5.0, -1.0, -3.0])
    norm = np.sqrt(42.0)
    xi = (symbols >> 3) & 7
    yi = symbols & 7
    lut = jnp.asarray(lut1d / norm, jnp.float32)
    return jax.lax.complex(lut[xi], lut[yi])


def catv_tx_64qam(ts_bytes, control_word: int = 0):
    """Full 64QAM chain: framing -> RS(128,122) -> randomize ->
    frame sync -> trellis -> QAM points. Input must fill whole frames:
    60 RS blocks = 60*122 symbols = 7320 7-bit symbols = 6405 bytes...
    practical sizing: n_pkts such that n_pkts*188*8 % (122*7) == 0 per
    frame group; this helper truncates to whole frames."""
    framed = transport_framing(np.asarray(ts_bytes))
    bits = np.unpackbits(framed.astype(np.uint8))
    n7 = bits.size // 7
    syms = np.packbits(
        bits[:n7 * 7].reshape(-1, 7), axis=-1, bitorder="big").reshape(-1)
    syms = syms >> 1  # packbits pads to 8 bits; shift back to 7
    nrs = syms.size // 122
    cw = rs128_encode(syms[:nrs * 122])
    nframes = cw.size // FRAME_SYMS_64QAM
    cw = cw[:nframes * FRAME_SYMS_64QAM]
    rnd = np.asarray(randomize(jnp.asarray(cw)))
    stream = frame_sync_insert(rnd, control_word)
    ngroups = stream.size // 28
    q, _ = trellis_encode_64qam(jnp.asarray(stream[:ngroups * 28]))
    return qam64_map(q)
