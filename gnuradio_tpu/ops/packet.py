"""Packet layer: CRCs, default header format, HDLC framing, burst shaping.

Reference parity:
  digital::crc32 (gr-digital/lib/crc32.cc) — standard reflected CRC-32;
      crc32_bb appends/checks 4 little-endian bytes per tagged packet
  packet_header_default (gr-digital/lib/packet_header_default.cc:50-95):
      header = 12-bit packet_len (LSB first) | 12-bit header_number |
      8-bit CRC8(poly 0x07, init 0xFF) over (len16, num16); parser inverts
  hdlc_framer_pb / hdlc_deframer_bp (gr-digital/lib/hdlc_*):
      0x7E flags, LSB-first bytes, CRC16-CCITT (reflected, init 0xFFFF),
      bit-stuffing after five consecutive ones
  burst_shaper_cc (gr-digital/lib/burst_shaper_impl.cc): window ramps on
      the first/last taps of each burst + zero padding

Split: packet formatting is control-plane work at packet rate — host
NumPy here (PDU in, PDU out), exactly where the reference does scalar C++.
The payload modulation around it stays on device.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import pmt
from ..core.stream import PortSpec, B, F, C


# ---------------------------------------------------------------------------
# CRCs
# ---------------------------------------------------------------------------

def crc32(data) -> int:
    """Reflected CRC-32 (poly 0x04C11DB7), init/xor 0xFFFFFFFF — the
    digital::crc32 definition (zlib-compatible)."""
    data = np.frombuffer(bytes(bytearray(np.asarray(data, np.uint8))),
                         np.uint8)
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= int(b)
        for _ in range(8):
            crc = (crc >> 1) ^ (0xEDB88320 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


def crc8(data, poly: int = 0x07, init: int = 0xFF) -> int:
    """Unreflected CRC-8 (packet_header_default's boost::crc_optimal<8,
    0x07, 0xFF, 0x00, false, false>)."""
    crc = init
    for b in np.asarray(data, np.uint8):
        crc ^= int(b)
        for _ in range(8):
            crc = ((crc << 1) ^ poly if crc & 0x80 else crc << 1) & 0xFF
    return crc


def crc16_ccitt(data, init: int = 0xFFFF) -> int:
    """Reflected CRC-16/X.25 as used by HDLC (hdlc_framer crc_ccitt)."""
    crc = init
    for b in np.asarray(data, np.uint8):
        crc ^= int(b)
        for _ in range(8):
            crc = (crc >> 1) ^ (0x8408 if crc & 1 else 0)
    return crc ^ 0xFFFF


def crc32_append(payload: np.ndarray) -> np.ndarray:
    """crc32_bb(check=False): append CRC-32 as 4 LE bytes."""
    c = crc32(payload)
    tail = np.array([c & 0xFF, (c >> 8) & 0xFF, (c >> 16) & 0xFF,
                     (c >> 24) & 0xFF], np.uint8)
    return np.concatenate([np.asarray(payload, np.uint8), tail])


def crc32_check(frame: np.ndarray):
    """crc32_bb(check=True): -> (payload, ok)."""
    frame = np.asarray(frame, np.uint8)
    payload, tail = frame[:-4], frame[-4:]
    c = crc32(payload)
    want = np.array([c & 0xFF, (c >> 8) & 0xFF, (c >> 16) & 0xFF,
                     (c >> 24) & 0xFF], np.uint8)
    return payload, bool((tail == want).all())


# ---------------------------------------------------------------------------
# default header format
# ---------------------------------------------------------------------------

HEADER_LEN_BITS = 32


class PacketHeaderDefault:
    """packet_header_default with 1 bit per item (the GRC default)."""

    def __init__(self):
        self.header_number = 0

    def format(self, packet_len: int) -> np.ndarray:
        """-> 32 header bits (packet_headergenerator_bb output)."""
        packet_len &= 0x0FFF
        num = self.header_number & 0x0FFF
        crc_in = np.array([packet_len & 0xFF, (packet_len >> 8) & 0xFF,
                           num & 0xFF, (num >> 8) & 0xFF], np.uint8)
        crc = crc8(crc_in)
        bits = np.zeros(HEADER_LEN_BITS, np.int8)
        k = 0
        for i in range(12):
            bits[k] = (packet_len >> i) & 1
            k += 1
        for i in range(12):
            bits[k] = (num >> i) & 1
            k += 1
        for i in range(8):
            bits[k] = (crc >> i) & 1
            k += 1
        self.header_number = (self.header_number + 1) & 0x0FFF
        return bits

    @staticmethod
    def parse(bits: np.ndarray):
        """packet_headerparser_b inverse -> (packet_len, header_number, ok)
        or (None, None, False) on CRC failure."""
        bits = np.asarray(bits).astype(np.int64) & 1
        plen = int((bits[:12] << np.arange(12)).sum())
        num = int((bits[12:24] << np.arange(12)).sum())
        crc = int((bits[24:32] << np.arange(8)).sum())
        crc_in = np.array([plen & 0xFF, (plen >> 8) & 0xFF,
                           num & 0xFF, (num >> 8) & 0xFF], np.uint8)
        ok = crc8(crc_in) == crc
        return (plen, num, True) if ok else (None, None, False)


def header_payload_split(bits: np.ndarray):
    """header_payload_demux core for the default format: read the 32-bit
    header, return (payload_bits, packet_len, header_number)."""
    plen, num, ok = PacketHeaderDefault.parse(bits[:HEADER_LEN_BITS])
    if not ok:
        return None, None, None
    return bits[HEADER_LEN_BITS:HEADER_LEN_BITS + plen], plen, num


# ---------------------------------------------------------------------------
# HDLC
# ---------------------------------------------------------------------------

HDLC_FLAG = 0x7E


def hdlc_frame(payload: np.ndarray, nflags: int = 2) -> np.ndarray:
    """hdlc_framer_pb: payload bytes -> stuffed bit stream with flags.
    Bytes go LSB-first; CRC16-CCITT appended LE before stuffing."""
    payload = np.asarray(payload, np.uint8)
    crc = crc16_ccitt(payload)
    frame_bytes = np.concatenate(
        [payload, np.array([crc & 0xFF, (crc >> 8) & 0xFF], np.uint8)])
    bits = ((frame_bytes[:, None] >> np.arange(8)) & 1).reshape(-1)
    stuffed = []
    ones = 0
    for b in bits:
        stuffed.append(int(b))
        if b:
            ones += 1
            if ones == 5:
                stuffed.append(0)
                ones = 0
        else:
            ones = 0
    flag_bits = [(HDLC_FLAG >> i) & 1 for i in range(8)]
    out = flag_bits * nflags + stuffed + flag_bits
    return np.array(out, np.int8)


def hdlc_deframe(bits: np.ndarray):
    """hdlc_deframer_bp: find flag-delimited frames, unstuff, CRC-check.
    -> list of payload byte arrays."""
    bits = list(np.asarray(bits).astype(int) & 1)
    # locate flags
    frames = []
    flag = [0, 1, 1, 1, 1, 1, 1, 0]
    idxs = [i for i in range(len(bits) - 7) if bits[i:i + 8] == flag]
    for a, b in zip(idxs, idxs[1:]):
        seg = bits[a + 8: b]
        if len(seg) < 24:
            continue
        # unstuff: drop 0 after five consecutive 1s
        out = []
        ones = 0
        i = 0
        while i < len(seg):
            out.append(seg[i])
            if seg[i]:
                ones += 1
                if ones == 5:
                    i += 1  # skip stuffed zero
                    ones = 0
            else:
                ones = 0
            i += 1
        if len(out) % 8:
            out = out[: len(out) - (len(out) % 8)]
        by = np.array(out, np.int64).reshape(-1, 8)
        by = (by << np.arange(8)).sum(axis=1).astype(np.uint8)
        if len(by) < 3:
            continue
        payload, crc_b = by[:-2], by[-2:]
        crc = crc16_ccitt(payload)
        if crc_b[0] == (crc & 0xFF) and crc_b[1] == (crc >> 8) & 0xFF:
            frames.append(payload)
    return frames


# ---------------------------------------------------------------------------
# burst shaping
# ---------------------------------------------------------------------------

def burst_shape(symbols: np.ndarray, up_taps: np.ndarray,
                down_taps: np.ndarray, pre_pad: int = 0,
                post_pad: int = 0) -> np.ndarray:
    """burst_shaper_cc on one burst: ramp the first len(up) and last
    len(down) symbols, add zero padding."""
    x = np.asarray(symbols).copy()
    nu, nd = len(up_taps), len(down_taps)
    x[:nu] = x[:nu] * up_taps
    x[len(x) - nd:] = x[len(x) - nd:] * down_taps
    return np.concatenate([np.zeros(pre_pad, x.dtype), x,
                           np.zeros(post_pad, x.dtype)])


# ---------------------------------------------------------------------------
# PDU message blocks (crc32_async_bb analog)
# ---------------------------------------------------------------------------

from ..core.block import Block  # noqa: E402


class CrcAppendPdu(Block):
    """crc32_async_bb(check=False): PDU in -> PDU with CRC appended."""

    def __init__(self, name=None):
        super().__init__(name)
        self.message_port_register_in("in", self._on)
        self.message_port_register_out("out")

    def _on(self, msg):
        meta, data = msg
        self.post("out", pmt.make_pdu(meta, crc32_append(data)))


class CrcCheckPdu(Block):
    """crc32_async_bb(check=True): drop bad frames, strip CRC."""

    def __init__(self, name=None):
        super().__init__(name)
        self.message_port_register_in("in", self._on)
        self.message_port_register_out("out")
        self.n_fail = 0

    def _on(self, msg):
        meta, data = msg
        payload, ok = crc32_check(data)
        if ok:
            self.post("out", pmt.make_pdu(meta, payload))
        else:
            self.n_fail += 1


class BurstShaperCC(Block):
    """burst_shaper_cc as a fixed-frame stream block: per burst of
    `payload_len` items, prepend `pre_pad` zeros, ramp the first len(up)
    payload items with `up_taps`, the last len(down) with `down_taps`,
    append `post_pad` zeros (gr-digital/lib/burst_shaper_impl.cc with the
    length-tag frame size fixed at compile time — the tagged-stream form
    lives in the slot discipline, ops/ofdm_streaming)."""

    def __init__(self, up_taps, down_taps, payload_len: int,
                 pre_pad: int = 0, post_pad: int = 0, dtype=C, name=None):
        super().__init__(name)
        from fractions import Fraction as _Fr
        self.up = np.asarray(up_taps, np.complex64)
        self.down = np.asarray(down_taps, np.complex64)
        self.P = int(payload_len)
        self.pre, self.post = int(pre_pad), int(post_pad)
        if len(self.up) + len(self.down) > self.P:
            raise ValueError("ramps longer than the payload")
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)
        self._in_r = (_Fr(self.P),)
        self._out_r = (_Fr(self.P + self.pre + self.post),)
        self.output_multiple = self.P + self.pre + self.post

    @property
    def in_rates(self):
        return self._in_r

    @property
    def out_rates(self):
        return self._out_r

    def apply(self, state, inputs, n_in):
        x = inputs[0].reshape(-1, self.P)
        k = x.shape[0]
        ramp = np.ones(self.P, np.complex64)
        ramp[: len(self.up)] = self.up
        if len(self.down):
            ramp[self.P - len(self.down):] = self.down
        if not jnp.issubdtype(x.dtype, jnp.complexfloating):
            ramp = ramp.real.astype(np.float32)
        y = x * jnp.asarray(ramp)[None, :]
        zpre = jnp.zeros((k, self.pre), y.dtype)
        zpost = jnp.zeros((k, self.post), y.dtype)
        out = jnp.concatenate([zpre, y, zpost], axis=1)
        return state, (out.reshape(-1),)


def burst_shaper_cc(up_taps, down_taps, payload_len, pre_pad=0, post_pad=0):
    return BurstShaperCC(up_taps, down_taps, payload_len, pre_pad, post_pad)
