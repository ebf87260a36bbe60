"""gr-dtv CATV (ITU-T J.83B) 64QAM TX stages as streaming graph Blocks
(GRC interop for gr-dtv/examples/catv_tx_64qam.grc).

Reference stream contracts:
  dtv_catv_transport_framing_enc_bb  lib/catv/catv_transport_framing_enc_bb_impl.cc
      188 bytes -> 188 bytes (sync dropped, checksum appended)
  dtv_catv_reed_solomon_enc_bb       .../catv_reed_solomon_enc_bb_impl.cc
      122 -> 128 seven-bit symbols
  dtv_catv_randomizer_bb             .../catv_randomizer_bb_impl.cc
      1:1 frame-periodic (60*128 symbols)
  dtv_catv_frame_sync_enc_bb         .../catv_frame_sync_enc_bb_impl.cc
      60*128 symbols -> 60*128*7 + 42 bits (sync word + control)
  dtv_catv_trellis_enc_bb            .../catv_trellis_enc_bb_impl.cc
      28 bits -> 5 six-bit QAM symbols (carried precoder/coder state)

Design: the checksum and RS encoders are GF(2)-AFFINE maps of the
input bits (verified numerically in QA), so both run as ONE bit-matmul
built by probing the scalar host reference (ops/catv.py) with unit
impulses; the trellis coders are lax.scan kernels. 256QAM uses the
88*128-symbol frame, the 40-bit sync word and the 6x38-bit trellis
super-group with the 2076-cycle packed layout."""
from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..core.block import Block, SyncBlock
from ..core.stream import PortSpec, B
from . import catv


def _is_256(constellation) -> bool:
    return "256" in str(constellation)


@lru_cache(maxsize=1)
def _checksum_matrix():
    """[187*8, 8] GF(2) matrix + 8-bit constant: checksum_bits(MSB first)
    = bits @ M ^ const (transport_checksum is affine in the payload)."""
    z = np.zeros(187, np.int64)
    const = catv.transport_checksum(z)
    M = np.zeros((187 * 8, 8), np.int8)
    for i in range(187 * 8):
        p = z.copy()
        p[i // 8] = 1 << (7 - (i % 8))
        c = catv.transport_checksum(p) ^ const
        M[i] = [(c >> (7 - n)) & 1 for n in range(8)]
    cbits = np.array([(const >> (7 - n)) & 1 for n in range(8)], np.int8)
    return M, cbits


@lru_cache(maxsize=1)
def _rs_matrix():
    """[122*7, 6*7] GF(2) matrix for the RS(128,122)+parity tail: the 6
    appended symbols are linear in the 122 info symbols' bits."""
    z = np.zeros(122, np.int64)
    M = np.zeros((122 * 7, 6 * 7), np.int8)
    for i in range(122 * 7):
        p = z.copy()
        p[i // 7] = 1 << (6 - (i % 7))
        cw = catv.rs128_encode(p)
        tail = cw[122:]
        M[i] = [(int(tail[k // 7]) >> (6 - (k % 7))) & 1
                for k in range(6 * 7)]
    return M


class CatvTransportFraming(SyncBlock):
    def __init__(self, name=None):
        super().__init__(PortSpec(B), PortSpec(B), name)
        self.output_multiple = 188

    def work(self, state, x):
        pkts = x.reshape(-1, 188).astype(jnp.int32) & 0xFF
        payload = pkts[:, 1:]
        bits = ((payload[:, :, None] >> jnp.arange(7, -1, -1)) & 1)
        bits = bits.reshape(pkts.shape[0], 187 * 8)
        M, cbits = _checksum_matrix()
        cs_bits = ((bits.astype(jnp.float32)
                    @ jnp.asarray(M, jnp.float32)).astype(jnp.int32) & 1) \
            ^ jnp.asarray(cbits, jnp.int32)
        w = jnp.asarray(1 << np.arange(7, -1, -1), jnp.int32)
        checksum = (cs_bits * w).sum(axis=1, keepdims=True)
        out = jnp.concatenate([payload, checksum], axis=1)
        return state, out.reshape(-1).astype(jnp.int8)


class CatvReedSolomonEnc(Block):
    def __init__(self, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)

    @property
    def in_rates(self):
        return (Fraction(122),)

    @property
    def out_rates(self):
        return (Fraction(128),)

    def apply(self, state, inputs, n_in):
        info = inputs[0].reshape(-1, 122).astype(jnp.int32) & 0x7F
        bits = ((info[:, :, None] >> jnp.arange(6, -1, -1)) & 1)
        bits = bits.reshape(info.shape[0], 122 * 7)
        M = _rs_matrix()
        tb = (bits.astype(jnp.float32)
              @ jnp.asarray(M, jnp.float32)).astype(jnp.int32) & 1
        tb = tb.reshape(-1, 6, 7)
        w = jnp.asarray(1 << np.arange(6, -1, -1), jnp.int32)
        tail = (tb * w).sum(axis=2)
        out = jnp.concatenate([info, tail], axis=1)
        return state, (out.reshape(-1).astype(jnp.int8),)


class CatvRandomizer(SyncBlock):
    def __init__(self, constellation="CATV_MOD_64QAM", name=None):
        super().__init__(PortSpec(B), PortSpec(B), name)
        self.frame_syms = (catv.FRAME_SYMS_256QAM if _is_256(constellation)
                           else catv.FRAME_SYMS_64QAM)
        self.output_multiple = self.frame_syms

    def work(self, state, x):
        y = catv.randomize(x.astype(jnp.int32) & 0x7F, self.frame_syms)
        return state, y.astype(jnp.int8)


class CatvFrameSyncEnc(Block):
    """60*128 seven-bit symbols -> bit stream + 42-bit frame sync."""

    def __init__(self, constellation="CATV_MOD_64QAM", ctrlword=0,
                 name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)
        self.ctrl = int(ctrlword)
        if _is_256(constellation):
            self.frame_syms = catv.FRAME_SYMS_256QAM
            sync = list(catv._SYNC_256QAM) + [(self.ctrl << 4) & 0xFF]
            self._sync_bits = ((np.array(sync, np.int64)[:, None]
                                >> np.arange(7, -1, -1)) & 1).reshape(-1)
            self.nsync = 40
        else:
            self.frame_syms = catv.FRAME_SYMS_64QAM
            sync = list(catv._SYNC_64QAM) + [(self.ctrl << 3) & 0x7F, 0]
            self._sync_bits = ((np.array(sync, np.int64)[:, None]
                                >> np.arange(6, -1, -1)) & 1).reshape(-1)[:42]
            self.nsync = 42

    @property
    def in_rates(self):
        return (Fraction(self.frame_syms),)

    @property
    def out_rates(self):
        return (Fraction(self.frame_syms * 7 + self.nsync),)

    def apply(self, state, inputs, n_in):
        fs = self.frame_syms
        x = inputs[0].reshape(-1, fs).astype(jnp.int32) & 0x7F
        bits = ((x[:, :, None] >> jnp.arange(6, -1, -1)) & 1)
        bits = bits.reshape(x.shape[0], fs * 7)
        sync = jnp.tile(jnp.asarray(self._sync_bits, jnp.int32)[None],
                        (x.shape[0], 1))
        out = jnp.concatenate([bits, sync], axis=1)
        return state, (out.reshape(-1).astype(jnp.int8),)


class CatvTrellisEnc(Block):
    """28 bits -> 5 six-bit QAM symbols, precoder/coder state carried."""

    def __init__(self, constellation="CATV_MOD_64QAM", name=None):
        super().__init__(name)
        self.is256 = _is_256(constellation)
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)

    @property
    def in_rates(self):
        return (Fraction(38 * 6 if self.is256 else 28),)

    @property
    def out_rates(self):
        return (Fraction(5 * 6 if self.is256 else 5),)

    def init_state(self):
        if self.is256:
            return (jnp.int32(0), jnp.int32(0), jnp.int32(0),
                    jnp.int32(0))
        return (jnp.int32(0), jnp.int32(0), jnp.int32(0))

    def apply(self, state, inputs, n_in):
        enc = (catv.trellis_encode_256qam if self.is256
               else catv.trellis_encode_64qam)
        q, state = enc(inputs[0].astype(jnp.int32) & 1, state)
        return state, (q.astype(jnp.int8),)
