"""gr-digital analog: constellations, symbol mapping, differential coding,
scramblers, slicers, CRC — the memoryless/symbol-domain half of gr-digital.
(Sequential tracking loops — Costas, FLL, clock recovery — live in
digital_loops.py.)

Reference parity map (SURVEY.md §2.2 gr-digital row):
  constellation (lib/constellation.cc, 913 LoC)  -> Constellation (points +
      vectorized nearest-point decision (elementwise); soft decisions via LLR)
  chunks_to_symbols_bc/sc (lib/chunks_to_symbols_impl.cc) -> ChunksToSymbols
  constellation_decoder_cb (lib/constellation_decoder_cb_impl.cc)
  diff_encoder_bb / diff_decoder_bb (lib/diff_{en,de}coder_bb_impl.cc)
  diff_phasor_cc (lib/diff_phasor_cc_impl.cc)
  map_bb (lib/map_bb_impl.cc)
  binary_slicer_fb (lib/binary_slicer_fb_impl.cc)
  additive_scrambler_bb / scrambler_bb / descrambler_bb (LFSR,
      lib/additive_scrambler_bb_impl.cc, include/gnuradio/digital/lfsr.h)
  pack_k_bits_bb / unpack_k_bits_bb (gr-blocks/lib/{,un}pack_k_bits_bb*)
  crc32 (lib/crc32*.cc)
"""
from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, SyncBlock
from ..core.stream import PortSpec, B, C, F, I


# ---------------------------------------------------------------------------
# Constellations
# ---------------------------------------------------------------------------
class _CallableInt(int):
    """int that also answers the reference's method-call syntax
    (const.arity() in GRC param expressions)."""

    def __call__(self):
        return int(self)


class _CallableArray(np.ndarray):
    """ndarray that also answers the reference's method-call syntax
    (const.points() / const.pre_diff_code() in GRC param expressions)."""

    def __call__(self):
        return np.asarray(self)


class Constellation:
    """Constellation object: points + bit mapping + decision regions
    (gr::digital::constellation, lib/constellation.cc).

    decision_maker is generic nearest-point (constellation.cc
    decision_maker); subclasses with sector-based decisions in the reference
    (psk/qam) are numerically identical for their point sets.
    """

    def __init__(self, points, pre_diff_code=None, rotational_symmetry=4,
                 dimensionality=1):
        self.points = np.asarray(points, np.complex64).view(_CallableArray)
        # _CallableInt/_CallableArray: the reference exposes these as
        # METHODS (constellation.h arity()/bits_per_symbol()/points()) and
        # GRC expressions call them; they also work as plain attributes
        self.arity = _CallableInt(len(self.points))
        self.bits_per_symbol = _CallableInt(round(math.log2(self.arity)))
        self.pre_diff_code = (np.asarray(pre_diff_code, np.int32)
                              .view(_CallableArray)
                              if pre_diff_code is not None else None)
        self.rotational_symmetry = rotational_symmetry
        self.dimensionality = dimensionality

    def base(self):
        """constellation.base() in GRC expressions returns the underlying
        constellation object (sptr unwrap in the reference) — identity."""
        return self

    def map_to_points(self, idx):
        """Symbol indices -> complex points (device)."""
        return jnp.asarray(self.points)[idx]

    def decision(self, x):
        """Hard decision: nearest constellation point index (device).
        x: (n,) complex -> (n,) int32."""
        d = jnp.abs(x[:, None] - jnp.asarray(self.points)[None, :]) ** 2
        return jnp.argmin(d, axis=1).astype(jnp.int32)

    def soft_llr(self, x, noise_var=1.0):
        """Per-bit LLRs (max-log approximation) — analog of the reference's
        soft-decision LUT (constellation.cc soft_decision_maker) computed
        exactly instead of via table lookup. Returns (n, bits_per_symbol),
        positive = bit 1 more likely, bit 0 = LSB-first like the reference's
        calc_soft_dec."""
        pts = jnp.asarray(self.points)
        d = -jnp.abs(x[:, None] - pts[None, :]) ** 2 / noise_var  # (n, P)
        llrs = []
        idx = np.arange(self.arity)
        for b in range(self.bits_per_symbol):
            mask1 = jnp.asarray((idx >> b) & 1, jnp.bool_)
            m1 = jnp.max(jnp.where(mask1[None, :], d, -jnp.inf), axis=1)
            m0 = jnp.max(jnp.where(~mask1[None, :], d, -jnp.inf), axis=1)
            llrs.append(m1 - m0)
        return jnp.stack(llrs, axis=1)


def constellation_bpsk():
    """lib/constellation.cc constellation_bpsk: 0 -> -1, 1 -> +1."""
    return Constellation([-1 + 0j, 1 + 0j], rotational_symmetry=2)


def constellation_qpsk():
    """constellation_qpsk (constellation.cc): gray-coded, points at
    (+-0.707 +- 0.707j); index = 2 bits, from the reference's table:
    0->(-0.707,-0.707), 1->(0.707,-0.707), 2->(-0.707,0.707), 3->(0.707,0.707)."""
    s = math.sqrt(2) / 2
    return Constellation([complex(-s, -s), complex(s, -s),
                          complex(-s, s), complex(s, s)],
                         pre_diff_code=[0, 1, 2, 3], rotational_symmetry=4)


def constellation_8psk():
    """constellation_8psk (constellation.cc): gray-coded 8PSK; reference map
    [0,1,3,2,7,6,4,5] -> angles k*pi/4."""
    mapping = [0, 1, 3, 2, 7, 6, 4, 5]
    pts = [0j] * 8
    for sym, pos in enumerate(mapping):
        pts[sym] = np.exp(1j * (np.pi / 4) * pos)
    return Constellation(pts, rotational_symmetry=8)


def constellation_16qam():
    """constellation_16qam (constellation.cc): gray 4x4 grid, reference
    layout (real from bits 0,1; imag from bits 2,3)."""
    # gray map per axis: 00->-3, 01->-1, 11->+1, 10->+3 (scaled by 1/sqrt(10))
    gray = {0: -3, 1: -1, 3: 1, 2: 3}
    pts = []
    for i in range(16):
        re = gray[i & 3]
        im = gray[(i >> 2) & 3]
        pts.append((re + 1j * im) / math.sqrt(10))
    return Constellation(pts, rotational_symmetry=4)


def constellation_calcdist(points, pre_diff_code=None, rot_sym=4, dim=1):
    return Constellation(points, pre_diff_code, rot_sym, dim)


# ---------------------------------------------------------------------------
# Symbol-domain blocks
# ---------------------------------------------------------------------------
class ChunksToSymbols(Block):
    """chunks_to_symbols_bc/sc/ic: symbol index stream -> constellation
    points (gr-digital/lib/chunks_to_symbols_impl.cc). D-dimensional symbol
    tables supported via vlen-D output."""

    def __init__(self, symbol_table, D: int = 1, in_dtype=B, out_dtype=C,
                 name=None):
        super().__init__(name)
        self.table = np.asarray(
            symbol_table,
            np.complex64 if out_dtype == C else np.float32)
        self.D = int(D)
        self.in_ports = (PortSpec(in_dtype),)
        self.out_ports = (PortSpec(out_dtype),)

    @property
    def in_rates(self):
        return (Fraction(1),)

    @property
    def out_rates(self):
        return (Fraction(self.D),)

    def apply(self, state, inputs, n_in):
        idx = inputs[0].astype(jnp.int32)
        t = jnp.asarray(self.table)
        if self.D == 1:
            return state, (t[idx],)
        t2 = t.reshape(-1, self.D)
        return state, (t2[idx].reshape(-1),)


def chunks_to_symbols_bc(symbol_table, D=1):
    return ChunksToSymbols(symbol_table, D, B)


def chunks_to_symbols_sc(symbol_table, D=1):
    return ChunksToSymbols(symbol_table, D, jnp.int16)


class ConstellationDecoder(SyncBlock):
    """constellation_decoder_cb: hard decision to symbol indices."""

    def __init__(self, constellation: Constellation, name=None):
        super().__init__(PortSpec(C), PortSpec(B), name)
        self.constellation = constellation

    def work(self, state, x):
        return state, self.constellation.decision(x).astype(B)


def constellation_decoder_cb(constellation):
    return ConstellationDecoder(constellation)


class ConstellationSoftDecoder(Block):
    """constellation_soft_decoder_cf: complex -> per-bit soft values."""

    def __init__(self, constellation: Constellation, npwr: float = 1.0, name=None):
        super().__init__(name)
        self.constellation = constellation
        self.npwr = float(npwr)
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(F),)

    @property
    def in_rates(self):
        return (Fraction(1),)

    @property
    def out_rates(self):
        return (Fraction(self.constellation.bits_per_symbol),)

    def apply(self, state, inputs, n_in):
        llr = self.constellation.soft_llr(inputs[0], self.npwr)
        return state, (llr.reshape(-1).astype(F),)


class DiffEncoder(SyncBlock):
    """diff_encoder_bb: out[n] = (in[n] + out[n-1]) % M
    (gr-digital/lib/diff_encoder_bb_impl.cc). The modular prefix sum is an
    associative scan — parallel, not sequential."""

    def __init__(self, modulus: int, name=None):
        super().__init__(PortSpec(B), PortSpec(B), name)
        self.M = int(modulus)

    def init_state(self):
        return jnp.zeros((), jnp.int32)

    def work(self, state, x):
        c = jnp.cumsum(x.astype(jnp.int32)) + state
        y = c % self.M
        return y[-1], y.astype(B)


def diff_encoder_bb(modulus):
    return DiffEncoder(modulus)


class DiffDecoder(SyncBlock):
    """diff_decoder_bb: out[n] = (in[n] - in[n-1]) % M."""

    def __init__(self, modulus: int, name=None):
        super().__init__(PortSpec(B), PortSpec(B), name)
        self.M = int(modulus)

    def init_state(self):
        return jnp.zeros((), jnp.int32)

    def work(self, state, x):
        xi = x.astype(jnp.int32)
        prev = jnp.concatenate([state[None], xi[:-1]])
        y = (xi - prev) % self.M
        return xi[-1], y.astype(B)


def diff_decoder_bb(modulus):
    return DiffDecoder(modulus)


class DiffPhasor(SyncBlock):
    """diff_phasor_cc: out[n] = in[n] * conj(in[n-1])."""

    def __init__(self, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)

    def init_state(self):
        return jnp.ones((), C)

    def work(self, state, x):
        prev = jnp.concatenate([state[None], x[:-1]])
        return x[-1], (x * jnp.conj(prev)).astype(C)


def diff_phasor_cc():
    return DiffPhasor()


class MapBB(SyncBlock):
    """map_bb: out = table[in] (gr-digital/lib/map_bb_impl.cc)."""

    def __init__(self, table, name=None):
        super().__init__(PortSpec(B), PortSpec(B), name)
        self.table = np.asarray(table, np.int32)

    def work(self, state, x):
        return state, jnp.asarray(self.table)[x.astype(jnp.int32)].astype(B)


def map_bb(table):
    return MapBB(table)


class BinarySlicer(SyncBlock):
    """binary_slicer_fb: out = 1 if in >= 0 else 0."""

    def __init__(self, name=None):
        super().__init__(PortSpec(F), PortSpec(B), name)

    def work(self, state, x):
        return state, (x >= 0).astype(B)


def binary_slicer_fb():
    return BinarySlicer()


# ---------------------------------------------------------------------------
# Bit packing (gr-blocks pack_k_bits_bb / unpack_k_bits_bb)
# ---------------------------------------------------------------------------
class UnpackKBits(Block):
    """unpack_k_bits_bb: each byte -> k bits, MSB first
    (gr-blocks/lib/unpack_k_bits.cc)."""

    def __init__(self, k: int, name=None):
        super().__init__(name)
        self.k = int(k)
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)

    @property
    def in_rates(self):
        return (Fraction(1),)

    @property
    def out_rates(self):
        return (Fraction(self.k),)

    def apply(self, state, inputs, n_in):
        x = inputs[0].astype(jnp.int32)
        shifts = jnp.arange(self.k - 1, -1, -1)
        bits = (x[:, None] >> shifts[None, :]) & 1
        return state, (bits.reshape(-1).astype(B),)


def unpack_k_bits_bb(k):
    return UnpackKBits(k)


class PackKBits(Block):
    """pack_k_bits_bb: k bits -> one byte, MSB first."""

    def __init__(self, k: int, name=None):
        super().__init__(name)
        self.k = int(k)
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)

    @property
    def in_rates(self):
        return (Fraction(self.k),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def apply(self, state, inputs, n_in):
        x = inputs[0].astype(jnp.int32).reshape(-1, self.k)
        shifts = jnp.arange(self.k - 1, -1, -1)
        y = jnp.sum(x << shifts[None, :], axis=1)
        return state, (y.astype(B),)


def pack_k_bits_bb(k):
    return PackKBits(k)


# ---------------------------------------------------------------------------
# LFSR scramblers
# ---------------------------------------------------------------------------
class AdditiveScrambler(SyncBlock):
    """additive_scrambler_bb (gr-digital/lib/additive_scrambler_bb_impl.cc):
    XOR the input bit stream with a fixed LFSR sequence, resetting the LFSR
    every `count` bits (count=0: never). Because the sequence is
    data-independent, we precompute one period on the host and XOR on
    device — no scan."""

    def __init__(self, mask=0x8A, seed=0x7F, reg_len=7, count=0, name=None):
        super().__init__(PortSpec(B), PortSpec(B), name)
        self.mask, self.seed, self.reg_len = mask, seed, reg_len
        self.count = int(count)
        # sequence period: 2^reg_len - 1 (or `count` if resetting)
        period = self.count if self.count > 0 else (1 << reg_len) - 1
        self._seq = self._gen_seq(period)
        self._pos = 0  # phase within the sequence (host-side bookkeeping)

    def _gen_seq(self, n):
        # faithful bit-serial model of gr::digital::lfsr (lfsr.h:60-86):
        # output = LSB; shift right; XOR mask into reg when output is 1.
        reg = self.seed
        out = np.empty(n, np.uint8)
        for i in range(n):
            o = reg & 1
            out[i] = o
            reg >>= 1
            if o:
                reg ^= self.mask
        return out

    def init_state(self):
        return jnp.zeros((), jnp.int32)  # sequence phase

    def work(self, state, x):
        n = x.shape[0]
        period = len(self._seq)
        reps = -(-n // period) + 1
        seq = jnp.asarray(np.tile(self._seq, reps).astype(np.int8))
        idx = (state + jnp.arange(n)) % period if self.count > 0 else \
              (state + jnp.arange(n)) % period
        y = jnp.bitwise_xor(x.astype(jnp.int8), seq[idx])
        return (state + n) % period, y.astype(B)


def additive_scrambler_bb(mask=0x8A, seed=0x7F, len_=7, count=0):
    return AdditiveScrambler(mask, seed, len_, count)


# ---------------------------------------------------------------------------
# CRC32 (gr-digital crc32.cc — the "bzip2" variant used by crc32_bb)
# ---------------------------------------------------------------------------
def crc32(data: bytes) -> int:
    """gr::digital::crc32 (lib/crc32.cc): CRC-32/BZIP2 — MSB-first,
    poly 0x04C11DB7, init 0xFFFFFFFF, xorout 0xFFFFFFFF, no reflection.
    Host-side utility (packet framing runs on host)."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte << 24
        for _ in range(8):
            if crc & 0x80000000:
                crc = ((crc << 1) ^ 0x04C11DB7) & 0xFFFFFFFF
            else:
                crc = (crc << 1) & 0xFFFFFFFF
    return crc ^ 0xFFFFFFFF
