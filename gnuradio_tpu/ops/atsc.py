"""gr-dtv ATSC 8-VSB: full A/53 transmit chain + symbol-domain receive.

Reference behavior (reimplemented, NOT copied):
  gr-dtv/lib/atsc/atsc_randomizer_impl.cc, atsc_randomize.h — 16-bit LFSR
      (feedback mask 0xa638, preload 0x018f), one clock per byte, output
      byte assembled from 8 fixed state bits; reset at the first regular
      segment of every 312-segment field; the 0x47 sync byte is dropped.
  gr-dtv/lib/atsc/atsc_rs_encoder_impl.cc:19-26 — RS(207,187) t=10 over
      GF(256) poly 0x11d, fcr=0 (shortened from (255,235)).
  gr-dtv/lib/atsc/atsc_interleaver_impl.cc — Forney convolutional
      interleaver I=52 branches, J=4 bytes: branch b delays b*4 bytes
      (stream delay b*4*52); commutator phase-locked to the field start.
  gr-dtv/lib/atsc/atsc_trellis_encoder_impl.cc, atsc_basic_trellis_encoder.cc
      — 12 interleaved rate-2/3 encoders; dibit mux / output mux pattern
      repeats every 12-segment group (encoder bump of 4 per segment); the
      per-encoder machine is the A/53 precoder + 4-state feedback-free coder:
        z2 = x2 ^ a;  a' = z2        (precoder, 1-tap feedback)
        z1 = x1
        z0 = c;  c' = x1 ^ b;  b' = c  (trellis)
      (equations derived from the A/53 D5.5 figure; the reference stores
      them as 32-entry next_state/out_symbol tables).
  gr-dtv/lib/atsc/atsc_field_sync_mux_impl.cc — 313-segment fields: a field
      sync segment (PN511 + 3xPN63, middle PN63 inverted on field 2, 24 mode
      bits = 0000 1010 0101 1111 0101 1010, 92 reserved bits from PN63, last
      12 symbols copied from the previous field's final segment) followed by
      312 data segments; every segment leads with the +5,-5,-5,+5 sync.
  gr-dtv/lib/atsc/atsc_pnXXX_impl.h — PN511/PN63 sequences; regenerated here
      from their A/53 LFSR recurrences (x^9+x^7+x^6+x^4+x^3+x+1 seed
      000000010, x^6+x+1 seed 111001) instead of copying tables.
  gr-dtv/lib/dvbs2/dvbs2_modulator_bc_impl.cc:2652-2661 (MOD_8VSB) — symbol
      s -> level (2s-7) + 1.25 pilot.
  gr-dtv/lib/atsc/atsc_viterbi_decoder_impl.cc — 12 Viterbi decoders over
      the de-muxed symbol streams. The reference uses a truncated-traceback
      sliding decoder with a 12-segment pipeline delay; here each group
      stream gets a full-block MLSE (trellis.viterbi_path vmapped over the
      12 coders) with zero block delay.
  gr-dtv/lib/atsc/atsc_deinterleaver_impl.cc, atsc_derandomizer_impl.cc,
      atsc_depad_impl.cc — inverses of the TX stages.

Design: every mux/interleave in the chain is a fixed permutation with
period one field (or one 12-segment group), precomputed once in host NumPy
and applied as a gather/scatter. The only sequential parts are the 12
trellis encoder state machines — ONE lax.scan of 828 steps per group with a
12-lane vector state (bitwise updates, no table lookups) — and the Viterbi
ACS scan (8 states on vector lanes, 12 coders batched via vmap).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import fec
from . import trellis as _trellis
from .dtv import conv_interleave

# ---------------------------------------------------------------------------
# constants (gr-dtv/include/gnuradio/dtv/atsc_consts.h)
# ---------------------------------------------------------------------------

MPEG_DATA_LENGTH = 187
MPEG_PKT_LENGTH = 188
RS_ENCODED_LENGTH = 207
MPEG_SYNC_BYTE = 0x47
DATA_SEGMENT_LENGTH = 832
DSEGS_PER_FIELD = 312
SEGS_PER_FIELD = 313          # field sync + 312 data
NCODERS = 12
GROUPS_PER_FIELD = DSEGS_PER_FIELD // NCODERS   # 26
DIBITS_PER_SEG = 828          # (832 - 4 sync symbols)
SYMBOL_RATE = 4.5e6 / 286 * 684   # ~10.762 MHz

# ---------------------------------------------------------------------------
# PN sequences (A/53 field sync): generated from their LFSR recurrences
# ---------------------------------------------------------------------------


def _lfsr_seq(poly_taps, seed, n):
    """Fibonacci LFSR: s[i] = XOR of s[i - t] for t in poly_taps."""
    L = len(seed)
    s = list(seed)
    for i in range(L, n):
        v = 0
        for t in poly_taps:
            v ^= s[i - t]
        s.append(v)
    return np.array(s[:n], np.int64)


# x^9 + x^7 + x^6 + x^4 + x^3 + x + 1, seed 000000010 (A/53 sec 5.5.2)
PN511 = _lfsr_seq((2, 3, 5, 6, 8, 9), (0, 0, 0, 0, 0, 0, 0, 1, 0), 511)
# x^6 + x + 1, seed 111001
PN63 = _lfsr_seq((5, 6), (1, 1, 1, 0, 0, 1), 63)


# ---------------------------------------------------------------------------
# data randomizer (atsc_randomize.h)
# ---------------------------------------------------------------------------

_RAND_PRELOAD = 0x018F
_RAND_MASK = 0xA638
# state bit -> output bit (atsc_randomize.cc slow_output_map)
_RAND_OUT_BITS = (15, 13, 12, 9, 5, 4, 3, 2)  # -> output bits 0..7


def _randomizer_field_mask() -> np.ndarray:
    """One field's XOR byte stream: 312 segments x 187 bytes, one LFSR clock
    per byte, reset at field start."""
    st = _RAND_PRELOAD
    out = np.zeros(DSEGS_PER_FIELD * MPEG_DATA_LENGTH, np.int64)
    for i in range(out.size):
        b = 0
        for k, sb in enumerate(_RAND_OUT_BITS):
            b |= ((st >> sb) & 1) << k
        out[i] = b
        if st & 1:
            st = ((st ^ _RAND_MASK) >> 1) | 0x8000
        else:
            st >>= 1
    return out


_RAND_FIELD_MASK = _randomizer_field_mask()


def randomize(ts_bytes):
    """[..., nfields*312*188] MPEG-TS packets (0x47-aligned) ->
    [..., nfields*312*187] randomized payload bytes (sync dropped)."""
    x = ts_bytes.astype(jnp.int32) & 0xFF
    p = x.reshape(x.shape[:-1] + (-1, DSEGS_PER_FIELD, MPEG_PKT_LENGTH))
    payload = p[..., 1:].reshape(p.shape[:-2] + (-1,))
    out = payload ^ jnp.asarray(_RAND_FIELD_MASK, jnp.int32)
    return out.reshape(x.shape[:-1] + (-1,))


def derandomize(payload_bytes):
    """[..., nfields*312*187] -> [..., nfields*312*188] with 0x47 syncs."""
    x = payload_bytes.astype(jnp.int32) & 0xFF
    f = x.reshape(x.shape[:-1] + (-1, DSEGS_PER_FIELD * MPEG_DATA_LENGTH))
    d = (f ^ jnp.asarray(_RAND_FIELD_MASK, jnp.int32)).reshape(
        f.shape[:-1] + (DSEGS_PER_FIELD, MPEG_DATA_LENGTH))
    sync = jnp.full(d.shape[:-1] + (1,), MPEG_SYNC_BYTE, jnp.int32)
    pkts = jnp.concatenate([sync, d], axis=-1)
    return pkts.reshape(x.shape[:-1] + (-1,))


# ---------------------------------------------------------------------------
# Reed-Solomon (207,187)
# ---------------------------------------------------------------------------

_RS_ATSC = None


def rs_atsc() -> fec.ReedSolomon:
    global _RS_ATSC
    if _RS_ATSC is None:
        _RS_ATSC = fec.ReedSolomon(t=10, prim_poly=0x11D, fcr=0, shorten=48)
    return _RS_ATSC


def rs_encode(payload):
    """[..., n*187] -> [..., n*207]."""
    x = payload.reshape(payload.shape[:-1] + (-1, MPEG_DATA_LENGTH))
    cw = rs_atsc().encode(x)
    return cw.reshape(payload.shape[:-1] + (-1,))


def rs_decode(coded):
    x = coded.reshape(coded.shape[:-1] + (-1, RS_ENCODED_LENGTH))
    data, nerr = rs_atsc().decode(x)
    return data.reshape(coded.shape[:-1] + (-1,)), nerr


# ---------------------------------------------------------------------------
# convolutional interleaver (I=52, J=4)
# ---------------------------------------------------------------------------

INTERLEAVER_I = 52
INTERLEAVER_J = 4
INTERLEAVER_TAIL = INTERLEAVER_I * INTERLEAVER_J * (INTERLEAVER_I - 1)
# atsc_deinterleaver_impl.cc:32 alignment_fifo(156): pads the end-to-end
# interleave+deinterleave delay from 10608 bytes to 10764 = 52 segments,
# keeping RS codeword boundaries segment-aligned through the pipe.
ALIGNMENT_DELAY = 156
DEINTERLEAVER_TAIL = INTERLEAVER_TAIL + ALIGNMENT_DELAY
LOOPBACK_DELAY_SEGS = DEINTERLEAVER_TAIL // RS_ENCODED_LENGTH  # 52


def interleaver_init():
    return jnp.zeros(INTERLEAVER_TAIL, jnp.int32)


def deinterleaver_init():
    return jnp.zeros(DEINTERLEAVER_TAIL, jnp.int32)


def interleave(x, tail):
    """x: [N] bytes, N % 52 == 0 (one field = 312*207 = 64584 = 52*1242)."""
    return conv_interleave(x, tail, I=INTERLEAVER_I, M=INTERLEAVER_J)


def deinterleave(x, tail):
    """Inverse Forney branch delays + the 156-byte alignment delay; the
    interleave->deinterleave composition is a pure 52-segment delay."""
    I, M = INTERLEAVER_I, INTERLEAVER_J
    t = np.arange(x.shape[0])
    idx = DEINTERLEAVER_TAIL + t - I * M * ((I - 1) - (t % I)) - ALIGNMENT_DELAY
    ext = jnp.concatenate([tail, x])
    return ext[jnp.asarray(idx)], ext[ext.shape[0] - DEINTERLEAVER_TAIL:]


# ---------------------------------------------------------------------------
# trellis encoder: 12-coder mux (pattern period = 12 segments)
# ---------------------------------------------------------------------------

_ENCODER_SEG_BUMP = 4


def _mux_tables():
    """Simulate the 12-segment-group mux state machine once (host side).

    Returns (src_byte, src_shift, out_pos, sync_pos):
      src_byte [12, 828]  byte index in the 12*207 group per coder step
      src_shift[12, 828]  dibit shift (6,4,2,0) per coder step
      out_pos  [12, 828]  output symbol index in the 12*832 group
      sync_pos [48]       output indices of segment sync symbols
    Step k of every coder happens in the same (chunk, shift) mux iteration,
    so a single 828-step scan with a 12-lane state is exact.
    """
    NC, SEG = NCODERS, RS_ENCODED_LENGTH
    src_byte = np.zeros((NC, DIBITS_PER_SEG), np.int64)
    src_shift = np.zeros((NC, DIBITS_PER_SEG), np.int64)
    out_pos = np.zeros((NC, DIBITS_PER_SEG), np.int64)
    cnt = np.zeros(NC, np.int64)
    buf = np.zeros(NC, np.int64)
    sync_pos = []

    enc = NC - _ENCODER_SEG_BUMP
    skip_bump = False
    t = 0            # output symbol index
    next_seg = 0     # next segment boundary (in output symbols)
    for chunk in range(0, NC * SEG, NC):
        if t >= next_seg:
            enc = (enc + _ENCODER_SEG_BUMP) % NC
            skip_bump = True
        for i in range(NC):
            buf[enc] = chunk + i
            enc = (enc + 1) % NC
        for shift in (6, 4, 2, 0):
            if t >= next_seg:
                sync_pos.extend((t, t + 1, t + 2, t + 3))
                t += 4
                next_seg = t + DIBITS_PER_SEG
                if not skip_bump:
                    enc = (enc + _ENCODER_SEG_BUMP) % NC
                skip_bump = False
            for i in range(NC):
                k = cnt[enc]
                src_byte[enc, k] = buf[enc]
                src_shift[enc, k] = shift
                out_pos[enc, k] = t
                cnt[enc] += 1
                t += 1
                enc = (enc + 1) % NC
    assert (cnt == DIBITS_PER_SEG).all()
    assert t == NC * DATA_SEGMENT_LENGTH
    assert enc == NC - _ENCODER_SEG_BUMP  # mux pattern closes on itself
    return src_byte, src_shift, out_pos, np.array(sync_pos, np.int64)


_SRC_BYTE, _SRC_SHIFT, _OUT_POS, _SYNC_POS = _mux_tables()
# segment sync: +5,-5,-5,+5 as symbol codes 6,1,1,6
_SYNC_SYMS = np.tile(np.array([6, 1, 1, 6], np.int64), NCODERS)


def trellis_encoder_init():
    """12 coder states, 3 bits each: (precoder a)<<2 | b<<1 | c."""
    return jnp.zeros(NCODERS, jnp.int32)


def _enc_step(state, dibits):
    """Vectorized A/53 coder update over the 12-lane state. dibits [12]."""
    x2 = (dibits >> 1) & 1
    x1 = dibits & 1
    a = (state >> 2) & 1
    b = (state >> 1) & 1
    c = state & 1
    z2 = x2 ^ a
    sym = (z2 << 2) | (x1 << 1) | c
    nstate = (z2 << 2) | (c << 1) | (x1 ^ b)
    return nstate, sym


def trellis_encode(seg_bytes, states):
    """[G*12, 207] RS-coded segment bytes -> ([G*12, 832] symbols 0..7,
    new coder states). G = number of 12-segment groups."""
    G = seg_bytes.shape[0] // NCODERS
    grp = seg_bytes.reshape(G, NCODERS * RS_ENCODED_LENGTH).astype(jnp.int32)
    # per-coder dibit streams for all groups: [G, 12, 828]
    byts = grp[:, jnp.asarray(_SRC_BYTE)]
    dib = (byts >> jnp.asarray(_SRC_SHIFT)) & 3
    # scan over G*828 steps with the 12-lane coder state
    seq = dib.transpose(0, 2, 1).reshape(G * DIBITS_PER_SEG, NCODERS)
    states, syms = jax.lax.scan(_enc_step, states, seq)
    syms = syms.reshape(G, DIBITS_PER_SEG, NCODERS).transpose(0, 2, 1)
    # scatter symbols + segment syncs into the output groups
    out = jnp.zeros((G, NCODERS * DATA_SEGMENT_LENGTH), jnp.int32)
    out = out.at[:, jnp.asarray(_OUT_POS.ravel())].set(
        syms.reshape(G, -1))
    out = out.at[:, jnp.asarray(_SYNC_POS)].set(jnp.asarray(_SYNC_SYMS,
                                                            jnp.int32))
    return out.reshape(G * NCODERS, DATA_SEGMENT_LENGTH), states


# ---------------------------------------------------------------------------
# Viterbi decoder (12 coders, full-block MLSE)
# ---------------------------------------------------------------------------

def _atsc_fsm() -> _trellis.FSM:
    NS = np.zeros((8, 4), np.int32)
    OS = np.zeros((8, 4), np.int32)
    for s in range(8):
        a, b, c = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for i in range(4):
            x2, x1 = (i >> 1) & 1, i & 1
            z2 = x2 ^ a
            OS[s, i] = (z2 << 2) | (x1 << 1) | c
            NS[s, i] = (z2 << 2) | (c << 1) | (x1 ^ b)
    return _trellis.FSM(4, 8, 8, NS, OS)


_FSM = None
_LEVELS = np.arange(8, dtype=np.float32) * 2.0 - 7.0


def atsc_fsm() -> _trellis.FSM:
    global _FSM
    if _FSM is None:
        _FSM = _atsc_fsm()
    return _FSM


def trellis_decode(soft_segments, start_states=None):
    """[G*12, 832] soft symbol levels (pilot removed, nominal 2s-7) ->
    [G*12, 207] decoded bytes. Full-block MLSE per coder — unlike the
    reference's truncated-traceback decoder there is no 12-segment delay."""
    fsm = atsc_fsm()
    G = soft_segments.shape[0] // NCODERS
    grp = soft_segments.reshape(G, NCODERS * DATA_SEGMENT_LENGTH)
    syms = grp[:, jnp.asarray(_OUT_POS)]          # [G, 12, 828]
    seq = syms.transpose(1, 0, 2).reshape(NCODERS, G * DIBITS_PER_SEG)
    met = (seq[..., None] - jnp.asarray(_LEVELS)) ** 2   # [12, T, 8]

    def dec(m):
        return _trellis.viterbi_path(fsm, m, S0=0, SK=-1)

    dibits = jax.vmap(dec)(met)                   # [12, T]
    dib = dibits.reshape(NCODERS, G, DIBITS_PER_SEG).transpose(1, 0, 2)
    # scatter dibits back into bytes: 4 dibits per byte at _SRC_SHIFT
    out = jnp.zeros((G, NCODERS * RS_ENCODED_LENGTH), jnp.int32)
    contrib = dib << jnp.asarray(_SRC_SHIFT)
    out = out.at[:, jnp.asarray(_SRC_BYTE.ravel())].add(
        contrib.reshape(G, -1))
    return out.reshape(G * NCODERS, RS_ENCODED_LENGTH)


# ---------------------------------------------------------------------------
# field sync mux
# ---------------------------------------------------------------------------

# 24 mode bits: 0000 1010 0101 1111 0101 1010 (8-VSB)
_MODE_BITS = np.array([0, 0, 0, 0, 1, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1,
                       0, 1, 0, 1, 1, 0, 1, 0], np.int64)


def _field_sync_bits(field2: bool) -> np.ndarray:
    """Bits 4..819 of the field sync segment (before the 12 saved symbols).
    atsc_field_sync_mux_impl.cc init_field_sync_common."""
    mask = 1 if field2 else 0
    parts = [np.array([1, 0, 0, 1], np.int64),   # segment sync
             PN511, PN63, PN63 ^ mask, PN63,
             _MODE_BITS,
             np.tile(PN63, 2)[:92]]              # 92 reserved bits
    return np.concatenate(parts)


# bit -> symbol code: 0 -> 1 (-5), 1 -> 6 (+5)
_FS_SYMS = {False: _field_sync_bits(False) * 5 + 1,
            True: _field_sync_bits(True) * 5 + 1}
N_SAVED_SYMBOLS = 12


def field_sync_segment(field2, saved12):
    """[832] symbol codes for a field sync segment; saved12 = last 12
    symbols of the previous field's final data segment."""
    base = jnp.asarray(_FS_SYMS[bool(field2)], jnp.int32)
    return jnp.concatenate([base, saved12.astype(jnp.int32)])


def field_sync_mux(data_segments, saved12, first_field2=False):
    """[nfields*312, 832] -> [nfields*313, 832] with field sync segments.
    Returns (segments, new_saved12)."""
    nfields = data_segments.shape[0] // DSEGS_PER_FIELD
    f = data_segments.reshape(nfields, DSEGS_PER_FIELD, DATA_SEGMENT_LENGTH)
    outs = []
    for i in range(nfields):
        f2 = bool(first_field2) ^ (i % 2 == 1)
        fs = field_sync_segment(f2, saved12)
        outs.append(jnp.concatenate([fs[None], f[i]], axis=0))
        saved12 = f[i, -1, -N_SAVED_SYMBOLS:]
    return jnp.concatenate(outs, axis=0), saved12


def field_sync_strip(segments):
    """[nfields*313, 832] -> data segments only [nfields*312, 832]."""
    f = segments.reshape(-1, SEGS_PER_FIELD, DATA_SEGMENT_LENGTH)
    return f[:, 1:].reshape(-1, DATA_SEGMENT_LENGTH)


# ---------------------------------------------------------------------------
# 8-VSB symbol mapping
# ---------------------------------------------------------------------------

PILOT = 1.25


def vsb_map(symbols, pilot: bool = True):
    """symbol codes 0..7 -> bipolar levels 2s-7 (+1.25 pilot), float32
    (dvbs2_modulator_bc_impl.cc MOD_8VSB)."""
    lv = symbols.astype(jnp.float32) * 2.0 - 7.0
    return lv + PILOT if pilot else lv


# ---------------------------------------------------------------------------
# full chains
# ---------------------------------------------------------------------------

def atsc_tx_symbols(ts_bytes, state=None):
    """MPEG TS [nfields*312*188] -> 8-VSB symbol codes [nfields*313, 832].

    state: (interleaver_tail, coder_states, saved12, first_field2) or None
    for from-reset (matches the reference chain started cold).
    """
    if state is None:
        state = (interleaver_init(), trellis_encoder_init(),
                 jnp.zeros(N_SAVED_SYMBOLS, jnp.int32), False)
    il_tail, enc_states, saved12, field2 = state
    r = randomize(ts_bytes)
    cw = rs_encode(r)
    il, il_tail = interleave(cw.reshape(-1), il_tail)
    segs = il.reshape(-1, RS_ENCODED_LENGTH)
    syms, enc_states = trellis_encode(segs, enc_states)
    out, saved12 = field_sync_mux(syms, saved12, first_field2=field2)
    nfields = ts_bytes.shape[-1] // (DSEGS_PER_FIELD * MPEG_PKT_LENGTH)
    return out, (il_tail, enc_states, saved12, bool(field2) ^ (nfields % 2 == 1))


def atsc_tx(ts_bytes, state=None, pilot: bool = True):
    """MPEG TS bytes -> baseband 8-VSB levels [nfields*313*832] float32."""
    syms, state = atsc_tx_symbols(ts_bytes, state)
    return vsb_map(syms.reshape(-1), pilot=pilot), state


def atsc_rx_segments(soft_levels, deint_tail=None):
    """Soft levels [nfields*313*832] (pilot removed) -> decoded RS-domain
    segment bytes [nfields*312, 207] delayed by LOOPBACK_DELAY_SEGS (=52)
    segments, plus the new deinterleaver tail.

    Symbol-domain receive half (viterbi -> deinterleave); the first 52
    output segments of a cold start are pipeline fill, exactly like the
    reference (plinfo::delay(out, in, 52), atsc_deinterleaver_impl.cc:71).
    """
    data = field_sync_strip(soft_levels.reshape(-1, DATA_SEGMENT_LENGTH))
    rs_segs = trellis_decode(data)
    if deint_tail is None:
        deint_tail = deinterleaver_init()
    de, deint_tail = deinterleave(rs_segs.reshape(-1), deint_tail)
    return de.reshape(-1, RS_ENCODED_LENGTH), deint_tail


def atsc_rx_fields(rs_segments):
    """Delay-compensated RS-domain segments for whole fields
    [nfields*312, 207] -> MPEG TS bytes [nfields*312*188].
    Input must be field-aligned (segment k = TX RS segment k, i.e. the
    caller dropped the 52 fill segments of a cold-start stream)."""
    payload, _ = rs_decode(rs_segments.reshape(-1))
    return derandomize(payload)


# ---------------------------------------------------------------------------
# RX front end: FPLL, timing sync, field-sync checker, LMS equalizer
# ---------------------------------------------------------------------------

def fpll(iq, rate, alpha: float = 0.01, init=None):
    """Carrier tracking FPLL (atsc_fpll_impl.cc): NCO mix -> real output;
    frequency/phase loop driven by fast_atan2 of a single-pole-IIR-smoothed
    mixed signal. One lax.scan over samples (inherently sequential loop).

    iq: [N] complex64 at `rate` samples/s. Returns ([N] float32, state).
    """
    beta = alpha * alpha / 4.0
    afc_tap = 1.0 - np.exp(-1.0 / rate / 5e-6)
    freq0 = (-3e6 + 0.309e6) / rate * 2 * np.pi

    def step(carry, z):
        phase, freq, avg = carry
        phase = phase + freq
        phase = jnp.where(phase > np.pi, phase - 2 * np.pi, phase)
        phase = jnp.where(phase < -np.pi, phase + 2 * np.pi, phase)
        # note the reference mixes with complex(sin, cos)
        nco = jax.lax.complex(jnp.sin(phase), jnp.cos(phase))
        mixed = z * nco
        avg = avg + afc_tap * (mixed - avg)
        x = jnp.arctan2(jnp.imag(avg), jnp.real(avg))
        x = jnp.clip(x, -np.pi / 2, np.pi / 2)
        phase = phase + alpha * x
        freq = freq + beta * x
        return (phase, freq, avg), jnp.real(mixed)

    if init is None:
        init = (jnp.float32(0.0), jnp.float32(freq0),
                jax.lax.complex(jnp.float32(0.0), jnp.float32(0.0)))
    state, out = jax.lax.scan(step, init, iq)
    return out, state


_ADJUSTMENT_GAIN = 1.0e-5 / (10 * DATA_SEGMENT_LENGTH)
_SYMBOL_INDEX_OFFSET = 3
_MIN_SEG_LOCK_CORR = 5
_SSI_MIN, _SSI_MAX = -16, 15


def timing_sync(x, rate):
    """Segment-sync-driven timing recovery (atsc_sync_impl.cc).

    Baseband real samples [N] at `rate` -> (soft segments [M, 832] float32,
    aux dict). Per-output-symbol lax.scan: 8-tap fractional interpolation at
    (si, mu), +5,-5,-5,+5 sign correlator integrated per symbol-position
    (the SSI), timing adjust from the correlation peak's sample gradient.
    Segment assembly from the (symbol_index, locked) streams is a vectorized
    host-side pass instead of the reference's data_mem copy loop.
    """
    from .digital_loops import mmse_interp, _NTAPS

    n = x.shape[0]
    w = float(rate) / SYMBOL_RATE
    nsym = int((n - _NTAPS - 4) / w)
    SEG = DATA_SEGMENT_LENGTH

    def step(carry, _):
        si, mu, adjust, counter, sym_idx, locked, sr, smem, integ = carry
        sample = mmse_interp(x, si, mu)
        mu = mu + _ADJUSTMENT_GAIN * 1e3 * adjust
        s = mu + w
        incr = jnp.floor(s)
        mu = s - incr
        si = si + incr.astype(jnp.int32)
        smem = smem.at[counter].set(sample)
        bit = (sample >= 0).astype(jnp.int32)
        sr = ((bit & 1) << 3) | (sr >> 1)
        upd = jnp.where(sr == 0x9, 2, -1)
        integ = integ.at[counter].add(upd)
        integ = jnp.clip(integ, _SSI_MIN, _SSI_MAX)
        sym_idx = jnp.where(sym_idx + 1 >= SEG, 0, sym_idx + 1)
        counter = counter + 1

        def on_wrap(args):
            adjust, sym_idx, locked = args
            best = jnp.argmax(integ).astype(jnp.int32)
            locked = integ[best] >= _MIN_SEG_LOCK_CORR
            # coefficients +1,+1,-1,-1 over smem[best-3 .. best]
            idx = (best - jnp.arange(4)) % SEG
            g = smem[idx]
            adjust = -g[0] - g[1] + g[2] + g[3]
            sym_idx = (_SYMBOL_INDEX_OFFSET - 1 - best) % SEG
            return adjust, sym_idx, locked

        wrapped = counter >= SEG
        adjust, sym_idx, locked = jax.lax.cond(
            wrapped, on_wrap, lambda a: a, (adjust, sym_idx, locked))
        counter = jnp.where(wrapped, 0, counter)
        out = (sample, sym_idx, locked)
        return (si, mu, adjust, counter, sym_idx, locked, sr, smem,
                integ), out

    init = (jnp.int32(0), jnp.float32(0.5), jnp.float32(0.0), jnp.int32(0),
            jnp.int32(0), jnp.bool_(False), jnp.int32(0),
            jnp.zeros(SEG, jnp.float32),
            jnp.full(SEG, _SSI_MIN, jnp.int32))
    _, (samples, sym_idx, locked) = jax.lax.scan(step, init, None,
                                                 length=nsym)
    samples = np.asarray(samples)
    sym_idx = np.asarray(sym_idx)
    locked = np.asarray(locked)
    # vectorized segment assembly: a segment ends where sym_idx == 831 and
    # the preceding 831 positions are contiguous (sym_idx counted up) and
    # locked throughout
    ends = np.where(sym_idx == SEG - 1)[0]
    ends = ends[ends >= SEG - 1]
    good = (sym_idx[ends - (SEG - 1)] == 0) & locked[ends] & \
        locked[ends - (SEG - 1)]
    ends = ends[good]
    segs = np.stack([samples[e - SEG + 1:e + 1] for e in ends]) \
        if len(ends) else np.zeros((0, SEG), np.float32)
    return segs, {"ends": ends, "locked_frac": float(locked.mean())}


_PN511_ERROR_LIMIT = 20
_PN63_ERROR_LIMIT = 5
_OFFSET_2ND_63 = 4 + 511 + 63


def fs_check(segments):
    """Field-sync detector + segment counter (atsc_fs_checker_impl.cc).

    segments: [N, 832] soft symbols. Returns (data_segments [M, 832],
    field2 [M] bool, segno [M] int, fs_rows list) where consecutive runs of
    312 data segments follow each detected field sync; the fs segment
    itself is not emitted (its training role is handled by equalize()).
    """
    segments = np.asarray(segments)
    sign = segments >= 0
    pn511_err = (sign[:, 4:4 + 511] ^ (PN511 > 0)).sum(1)
    pn63_err = (sign[:, _OFFSET_2ND_63:_OFFSET_2ND_63 + 63] ^
                (PN63 > 0)).sum(1)
    out_rows, out_f2, out_segno, fs_rows = [], [], [], []
    field = 0
    segno = 0
    for i in range(segments.shape[0]):
        if pn511_err[i] < _PN511_ERROR_LIMIT:
            if pn63_err[i] <= _PN63_ERROR_LIMIT:
                field, segno = 1, 0
            elif pn63_err[i] >= 63 - _PN63_ERROR_LIMIT:
                field, segno = 2, 0
            fs_rows.append(i)
            continue
        if field:
            out_rows.append(i)
            out_f2.append(field == 2)
            out_segno.append(segno)
            segno += 1
            if segno >= DSEGS_PER_FIELD:
                field, segno = 0, 0
    return (segments[out_rows], np.array(out_f2, bool),
            np.array(out_segno, np.int64), fs_rows)


_EQ_NTAPS = 64
_EQ_NPRETAPS = int(_EQ_NTAPS * 0.8)
_EQ_BETA = 5e-5
KNOWN_FIELD_SYNC_LENGTH = 4 + 511 + 3 * 63


def _training_levels(field2: bool) -> np.ndarray:
    bits = _field_sync_bits(bool(field2))[:KNOWN_FIELD_SYNC_LENGTH]
    return (bits * 10.0 - 5.0).astype(np.float32)


def equalize(segments, is_fs, fs_field2, taps=None):
    """LMS equalizer trained on field sync segments
    (atsc_equalizer_impl.cc): 64 taps (51 pre, 13 post), sample-by-sample
    LMS on the 704 known training symbols of each field sync segment;
    data segments filtered with the frozen taps. Field sync rows are
    consumed, not emitted.

    segments: [N, 832] in stream order; is_fs: [N] bool; fs_field2: [N]
    bool (valid where is_fs). Returns ([M, 832] filtered data segments,
    final taps).
    """
    segments = jnp.asarray(segments, jnp.float32)
    N, SEG = segments.shape
    if taps is None:
        taps = jnp.zeros(_EQ_NTAPS, jnp.float32)
    tr1 = jnp.asarray(_training_levels(False))
    tr2 = jnp.asarray(_training_levels(True))
    # ext[i] = [prev 51 | seg | next 13]
    prev_tail = jnp.concatenate(
        [jnp.zeros((1, _EQ_NPRETAPS), jnp.float32),
         segments[:-1, SEG - _EQ_NPRETAPS:]], axis=0)
    next_head = jnp.concatenate(
        [segments[1:, :_EQ_NTAPS - _EQ_NPRETAPS],
         jnp.zeros((1, _EQ_NTAPS - _EQ_NPRETAPS), jnp.float32)], axis=0)
    ext = jnp.concatenate([prev_tail, segments, next_head], axis=1)

    def lms(taps, args):
        buf, train = args

        def one(tp, k):
            win = jax.lax.dynamic_slice(buf, (k,), (_EQ_NTAPS,))
            e = jnp.dot(win, tp) - train[k]
            return tp - _EQ_BETA * e * win, None

        taps, _ = jax.lax.scan(one, taps, jnp.arange(
            KNOWN_FIELD_SYNC_LENGTH))
        return taps

    def seg_step(taps, args):
        buf, fs, f2 = args
        taps = jax.lax.cond(
            fs,
            lambda t: lms(t, (buf, jnp.where(f2, tr2, tr1))),
            lambda t: t, taps)
        # filter: out[j] = dot(buf[j:j+64], taps)
        win = jnp.stack([buf[j:j + SEG] for j in range(_EQ_NTAPS)], axis=1)
        y = win @ taps
        return taps, y

    taps, filtered = jax.lax.scan(
        seg_step, taps,
        (ext, jnp.asarray(np.asarray(is_fs)), jnp.asarray(
            np.asarray(fs_field2))))
    keep = ~np.asarray(is_fs)
    # static boolean mask -> static-index gather; stays traceable (the
    # round-4 streaming block jits this path)
    return filtered[np.nonzero(keep)[0]], taps
