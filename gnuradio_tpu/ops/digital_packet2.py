"""gr-digital packet/framing fills: pn_correlator, simple framer/correlator,
framer_sink_1, packet_sink, header_format family, header_buffer,
protocol_formatter, kurtotic equalizer, probe_density, modulate_vector.

Reference parity:
  pn_correlator_cc        gr-digital/lib/pn_correlator_cc_impl.cc — decimate
                          by the PN period, output one correlation per period
                          against a GLFSR ±1 reference sequence.
  simple_framer           gr-digital/lib/simple_framer_impl.cc — frame =
                          8-byte GRSF_SYNC + seqno byte + payload.
  simple_correlator       gr-digital/lib/simple_correlator_impl.cc.
  framer_sink_1           gr-digital/lib/framer_sink_1_impl.cc — input bits
                          flagged by correlate_access_code_bb; 32-bit header
                          = (len<<16)|len; payload posted as messages.
  packet_sink             gr-digital/lib/packet_sink_impl.cc.
  header_format_*         gr-digital/lib/header_format_{base,default,counter,
                          crc}.cc — bitwise header builders/parsers.
  header_buffer           gr-digital/lib/header_buffer.cc — MSB-first field
                          packer used by the header formatters.
  protocol_formatter      gr-digital/lib/protocol_formatter_{bb,async}_impl.cc
  kurtotic_equalizer_cc   gr-digital/lib/kurtotic_equalizer_cc_impl.cc.
  probe_density_b         gr-digital/lib/probe_density_b_impl.cc.
  modulate_vector         gr-digital/python/digital/modulation_utils +
                          lib/modulate_vector.cc helper.

Design notes: PN correlation is a reshaped dot product (one matmul row
per period) — matmul-shaped; framing/deframing is host-plane byte work (the
reference runs it at packet rate, ~10^-3 of sample rate); the kurtotic
equalizer is a per-sample recurrence -> lax.scan like the LMS/CMA family in
equalizers.py.
"""
from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core import pmt
from ..core.block import Block, DecimBlock, SinkBlock
from ..core.stream import PortSpec, B, F, C
from .packet import crc8
from .digital_extra import GLFSR_POLY


def glfsr_bits(degree: int, mask: int = 0, seed: int = 1, n: int | None = None
               ) -> np.ndarray:
    """Host-side Galois LFSR bit sequence (same recurrence as GlfsrSource)."""
    if n is None:
        n = (1 << degree) - 1
    mask = mask if mask else GLFSR_POLY[degree]
    reg = seed if seed else 1
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        b = reg & 1
        reg >>= 1
        if b:
            reg ^= mask
        out[i] = b
    return out


# ---------------------------------------------------------------------------
# pn_correlator_cc
# ---------------------------------------------------------------------------

class PnCorrelator(DecimBlock):
    """pn_correlator_cc(degree): correlate against one period (2^d - 1) of
    the maximal-length GLFSR sequence mapped to ±1 (bit b -> 2b-1, so bit 1
    maps to +1 as in the reference). One complex output per period:
    y = (1/L) Σ x[n] · pn[n].

    The reference retards the generator one chip per output period (it holds
    the previous bit at j==0 and only advances for j>0, after initializing
    through one full period so the held value starts at the LAST bit of the
    first period — pn_correlator_cc_impl.cc work loop). So output period k
    correlates against pn cyclically shifted by (1+k): we precompute the
    (L, L) matrix of all cyclic shifts and gather rows by a carried output
    counter, turning the sliding correlation into a gathered batched dot."""

    def __init__(self, degree: int, mask: int = 0, seed: int = 1, name=None):
        L = (1 << degree) - 1
        super().__init__(L, PortSpec(C), PortSpec(C), name)
        bits = glfsr_bits(degree, mask, seed, L)
        pn = (2.0 * bits.astype(np.float32) - 1.0)  # 0->-1, 1->+1
        # row k = reference sequence used for the k-th output period
        self.pn_shifts = np.stack(
            [np.roll(pn, (1 + k) % L) for k in range(L)])
        self.L = L

    def init_state(self):
        return jnp.zeros((), jnp.int32)  # output periods produced (mod L)

    def work(self, state, x):
        xm = x.reshape(-1, self.L)
        k = xm.shape[0]
        rows = (state + jnp.arange(k, dtype=jnp.int32)) % self.L
        pn = jnp.asarray(self.pn_shifts)[rows]          # (k, L) float32
        y = jnp.sum(xm * pn.astype(jnp.complex64), axis=1) / self.L
        return (state + k) % self.L, y


def pn_correlator_cc(degree, mask=0, seed=1):
    return PnCorrelator(degree, mask, seed)


# ---------------------------------------------------------------------------
# simple framer / correlator (GRSF sync discipline)
# ---------------------------------------------------------------------------

GRSF_SYNC = 0xACDDA4E2F28C20FC  # gr-digital/include/gnuradio/digital/simple_framer_sync.h
_SYNC_BYTES = np.frombuffer(GRSF_SYNC.to_bytes(8, "big"), dtype=np.uint8)


class SimpleFramer(Block):
    """simple_framer(payload_bytesize): emit 8 sync bytes + 1 seq byte +
    payload + 1 tail-pad byte (0x55) per frame — GRSF_OVERHEAD = 10
    (simple_framer_sync.h GRSF_SYNC/PAYLOAD/TAIL_PAD constants; the impl
    memsets the output to 0x55 before writing sync+seq+payload). Static
    rates: in = P, out = P + 10 per frame."""

    OVERHEAD = 10  # 8 sync + 1 seqno + 1 tail pad

    def __init__(self, payload_bytesize: int, name=None):
        super().__init__(name)
        self.P = int(payload_bytesize)
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)
        # whole frames per step (reference: set_output_multiple(P+OVERHEAD))
        self.output_multiple = self.P + self.OVERHEAD

    @property
    def in_rates(self):
        return (Fraction(self.P),)

    @property
    def out_rates(self):
        return (Fraction(self.P + self.OVERHEAD),)

    def init_state(self):
        return jnp.zeros((), jnp.int32)  # running frame counter

    def apply(self, state, inputs, n_in):
        x = inputs[0].reshape(-1, self.P)
        k = x.shape[0]
        sync = jnp.broadcast_to(
            jnp.asarray(_SYNC_BYTES.view(np.int8)), (k, 8))
        seq = ((state + jnp.arange(k, dtype=jnp.int32)) & 0xFF).astype(
            jnp.int8)[:, None]
        pad = jnp.full((k, 1), 0x55, jnp.int8)
        y = jnp.concatenate([sync, seq, x, pad], axis=1)
        return state + k, (y.reshape(-1),)


def simple_framer(payload_bytesize):
    return SimpleFramer(payload_bytesize)


def simple_correlate(data: np.ndarray, payload_bytesize: int):
    """simple_correlator host-plane core: scan a byte stream for GRSF_SYNC,
    return (payloads, seqnos). Handles arbitrary alignment and garbage
    between frames, like the reference's bit-serial hunt."""
    data = np.asarray(data, dtype=np.uint8)
    P = int(payload_bytesize)
    payloads, seqs = [], []
    i = 0
    n = len(data)
    while i + 9 + P <= n:
        if np.array_equal(data[i:i + 8], _SYNC_BYTES):
            seqs.append(int(data[i + 8]))
            payloads.append(data[i + 9:i + 9 + P].copy())
            i += SimpleFramer.OVERHEAD + P  # incl. the 0x55 tail-pad byte
        else:
            i += 1
    return payloads, seqs


class SimpleCorrelator(SinkBlock):
    """simple_correlator as a sink: collects bytes, deframes on demand."""

    def __init__(self, payload_bytesize: int, name=None):
        super().__init__(PortSpec(B), name)
        self.P = int(payload_bytesize)
        self._chunks: list = []
        self._trim = None

    def collect(self, value):
        self._chunks.append(np.asarray(value, dtype=np.uint8))

    def trim(self, n):
        self._trim = int(n)

    def frames(self):
        data = (np.concatenate(self._chunks) if self._chunks
                else np.zeros(0, np.uint8))
        if self._trim is not None:
            data = data[: self._trim]
        return simple_correlate(data, self.P)


def simple_correlator(payload_bytesize):
    return SimpleCorrelator(payload_bytesize)


# ---------------------------------------------------------------------------
# framer_sink_1 / packet_sink
# ---------------------------------------------------------------------------

def _bits_to_bytes_msb(bits: np.ndarray) -> np.ndarray:
    bits = np.asarray(bits, dtype=np.uint8) & 1
    nb = len(bits) // 8
    return np.packbits(bits[: nb * 8])


class FramerSink1(SinkBlock):
    """framer_sink_1: input = one bit per byte with the access-code flag in
    bit 1 (correlate_access_code_bb convention). On flag: read the 32-bit
    header (two identical 16-bit copies; each = 4-bit whitener offset in the
    top bits + 12-bit payload length — framer_sink_1_impl.h header_ok/
    header_payload), then collect len payload bytes and post them as a PDU.
    Zero-length packets are posted as empty PDUs like the reference."""

    def __init__(self, name=None):
        super().__init__(PortSpec(B), name)
        self._bits: list = []
        self.message_port_register_out("pdus")
        self.packets: list[np.ndarray] = []

    def collect(self, value):
        self._bits.append(np.asarray(value, dtype=np.uint8))

    def trim(self, n):
        pass

    def decode(self):
        """Scan collected flagged bits; return list of payload byte arrays."""
        if not self._bits:
            return self.packets
        stream = np.concatenate(self._bits)
        flags = (stream >> 1) & 1
        bits = stream & 1
        self.packets = []
        for start in np.nonzero(flags)[0]:
            h0 = start
            if h0 + 32 > len(bits):
                continue
            hdr = int((bits[h0:h0 + 32].astype(np.int64) <<
                       np.arange(31, -1, -1)).sum())
            if (hdr >> 16) != (hdr & 0xFFFF):
                continue  # two header copies disagree
            length = (hdr >> 16) & 0x0FFF
            whitener = (hdr >> 28) & 0xF
            p0 = h0 + 32
            if p0 + 8 * length > len(bits):
                continue
            self.packets.append(_bits_to_bytes_msb(bits[p0:p0 + 8 * length]))
            self.post("pdus", pmt.make_pdu(
                {"whitener_offset": whitener}, self.packets[-1]))
        return self.packets


def framer_sink_1():
    return FramerSink1()


class PacketSink(SinkBlock):
    """packet_sink: hunt a raw bit stream for an access code (within a
    threshold of bit errors), parse the (len<<16|len) header, extract the
    payload, post as PDU (gr-digital/lib/packet_sink_impl.cc)."""

    def __init__(self, access_code=None, threshold: int = 0, name=None):
        super().__init__(PortSpec(B), name)
        if access_code is None:
            # default 64-bit access code (digital/python/packet_utils.py
            # default_access_code = 0xACDDA4E2F28C20FC)
            access_code = np.unpackbits(np.frombuffer(
                (0xACDDA4E2F28C20FC).to_bytes(8, "big"), np.uint8))
        self.code = np.asarray(access_code, dtype=np.uint8) & 1
        self.threshold = int(threshold)
        self._bits: list = []
        self.packets: list[np.ndarray] = []
        self.message_port_register_out("pdus")

    def collect(self, value):
        self._bits.append(np.asarray(value, dtype=np.uint8) & 1)

    def trim(self, n):
        pass

    def decode(self):
        if not self._bits:
            return self.packets
        bits = np.concatenate(self._bits)
        L = len(self.code)
        if len(bits) < L + 32:
            return self.packets
        # sliding Hamming distance via correlation (vectorized hunt)
        win = np.lib.stride_tricks.sliding_window_view(bits, L)
        dist = (win != self.code).sum(axis=1)
        hits = np.nonzero(dist <= self.threshold)[0]
        self.packets = []
        last_end = -1
        for h in hits:
            if h < last_end:
                continue
            p = h + L
            if p + 32 > len(bits):
                break
            hdr = int((bits[p:p + 32] << np.arange(31, -1, -1)).sum())
            length = hdr & 0xFFFF
            if (hdr >> 16) != length or length == 0:
                continue
            q = p + 32
            if q + 8 * length > len(bits):
                break
            self.packets.append(_bits_to_bytes_msb(bits[q:q + 8 * length]))
            self.post("pdus", pmt.make_pdu({}, self.packets[-1]))
            last_end = q + 8 * length
        return self.packets


def packet_sink(access_code=None, threshold=0):
    return PacketSink(access_code, threshold)


# ---------------------------------------------------------------------------
# header_buffer + header_format family
# ---------------------------------------------------------------------------

class HeaderBuffer:
    """header_buffer: MSB-first bit packer/parser for header fields
    (gr-digital/lib/header_buffer.cc)."""

    def __init__(self, bits=None):
        self.bits: list[int] = list(bits) if bits is not None else []
        self._pos = 0

    def add_field(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.bits.append((int(value) >> i) & 1)

    def extract_field(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | (int(self.bits[self._pos]) & 1)
            self._pos += 1
        return v

    def header(self) -> np.ndarray:
        return np.asarray(self.bits, dtype=np.int8)


class HeaderFormatDefault:
    """header_format_default: access code bits + 16-bit length repeated twice
    (gr-digital/lib/header_format_default.cc)."""

    def base(self):
        """GRC expressions call .base() on the sptr wrapper."""
        return self

    def formatter(self):
        return self

    def __init__(self, access_code: int | str = 0xACDDA4E2F28C20FC,
                 code_bits: int = 64, threshold: int = 0):
        if isinstance(access_code, str):
            # GRC passes the access code as a '01' string
            # (packet_utils.default_access_code style)
            bits = [c for c in access_code if c in "01"]
            self.code_bits = len(bits)
            self.access = [int(c) for c in bits]
        else:
            self.code_bits = code_bits
            self.access = [(access_code >> i) & 1
                           for i in range(code_bits - 1, -1, -1)]
        self.threshold = threshold

    def header_nbits(self) -> int:
        return self.code_bits + 32

    def format(self, payload_bytes: int) -> np.ndarray:
        hb = HeaderBuffer(self.access)
        hb.add_field(payload_bytes & 0xFFFF, 16)
        hb.add_field(payload_bytes & 0xFFFF, 16)
        return hb.header()

    def parse(self, bits: np.ndarray):
        bits = np.asarray(bits, dtype=np.int64) & 1
        code = np.asarray(self.access, dtype=np.int64)
        if (bits[: self.code_bits] != code).sum() > self.threshold:
            return None, False
        hb = HeaderBuffer(bits[self.code_bits:])
        a = hb.extract_field(16)
        b = hb.extract_field(16)
        return (a, True) if a == b else (None, False)


class HeaderFormatCounter(HeaderFormatDefault):
    """header_format_counter: default + 16-bit bps + 16-bit counter
    (gr-digital/lib/header_format_counter.cc; ctor signature
    header_format_counter.h:53 (access_code, threshold, bps))."""

    def __init__(self, access_code=0xACDDA4E2F28C20FC, threshold: int = 0,
                 bps: int = 1, **kw):
        super().__init__(access_code=access_code, threshold=threshold, **kw)
        self.bps = int(bps)
        self.counter = 0

    def header_nbits(self) -> int:
        return self.code_bits + 64

    def format(self, payload_bytes: int) -> np.ndarray:
        hb = HeaderBuffer(self.access)
        hb.add_field(payload_bytes & 0xFFFF, 16)
        hb.add_field(payload_bytes & 0xFFFF, 16)
        hb.add_field(self.bps & 0xFFFF, 16)
        hb.add_field(self.counter & 0xFFFF, 16)
        self.counter = (self.counter + 1) & 0xFFFF
        return hb.header()

    def parse(self, bits: np.ndarray):
        bits = np.asarray(bits, dtype=np.int64) & 1
        code = np.asarray(self.access, dtype=np.int64)
        if (bits[: self.code_bits] != code).sum() > self.threshold:
            return None, False
        hb = HeaderBuffer(bits[self.code_bits:])
        a, b = hb.extract_field(16), hb.extract_field(16)
        bps = hb.extract_field(16)
        counter = hb.extract_field(16)
        if a != b:
            return None, False
        return {"payload_bytes": a, "bps": bps, "counter": counter}, True


class HeaderFormatCrc:
    """header_format_crc: 12-bit length + 12-bit number + CRC8 over both
    (gr-digital/lib/header_format_crc.cc). Key names are carried for the
    parser's metadata dict."""

    def base(self):
        """GRC expressions call .base() on the sptr wrapper."""
        return self

    def formatter(self):
        return self

    def __init__(self, len_key_name: str = "packet_len",
                 num_key_name: str = "packet_num"):
        self.number = 0
        self.len_key, self.num_key = str(len_key_name), str(num_key_name)

    def header_nbits(self) -> int:
        return 32

    def format(self, payload_bytes: int) -> np.ndarray:
        plen = payload_bytes & 0x0FFF
        num = self.number & 0x0FFF
        crc_in = np.array([plen & 0xFF, (plen >> 8) & 0xFF,
                           num & 0xFF, (num >> 8) & 0xFF], np.uint8)
        c = crc8(crc_in)
        hb = HeaderBuffer()
        hb.add_field(plen, 12)
        hb.add_field(num, 12)
        hb.add_field(c, 8)
        self.number = (self.number + 1) & 0x0FFF
        return hb.header()

    @staticmethod
    def parse(bits: np.ndarray):
        hb = HeaderBuffer(np.asarray(bits, dtype=np.int64) & 1)
        plen = hb.extract_field(12)
        num = hb.extract_field(12)
        c = hb.extract_field(8)
        crc_in = np.array([plen & 0xFF, (plen >> 8) & 0xFF,
                           num & 0xFF, (num >> 8) & 0xFF], np.uint8)
        if crc8(crc_in) != c:
            return None, False
        return {"payload_bytes": plen, "number": num}, True


class HeaderFormatOfdm(HeaderFormatCrc):
    """header_format_ofdm (gr-digital/lib/header_format_ofdm.cc behavior):
    the CRC header (12-bit len + 12-bit number + CRC8) zero-padded so the
    header fills exactly `n_syms` whole OFDM symbols of the first carrier
    allocation at `bits_per_header_sym` bits each."""

    def __init__(self, occupied_carriers, n_syms: int = 1,
                 len_key_name: str = "packet_len",
                 frame_key_name: str = "frame_len",
                 num_key_name: str = "packet_num",
                 bits_per_header_sym: int = 1,
                 bits_per_payload_sym: int = 1, scramble_header: bool = False):
        super().__init__()
        occ = occupied_carriers
        if len(occ) and isinstance(occ[0], (list, tuple, np.ndarray)):
            ncar = len(occ[0])
        else:
            ncar = len(occ)
        self._nbits = int(ncar) * int(n_syms) * int(bits_per_header_sym)
        if self._nbits < 32:
            raise ValueError("OFDM header shorter than its 32 content bits")

    def header_nbits(self) -> int:
        return self._nbits

    def format(self, payload_bytes: int) -> np.ndarray:
        core = super().format(payload_bytes)
        return np.concatenate(
            [core, np.zeros(self._nbits - len(core), np.int8)])

    def parse(self, bits: np.ndarray):
        return super().parse(np.asarray(bits)[:32])


def header_format_ofdm(occupied_carriers, n_syms=1,
                       len_key_name="packet_len", frame_key_name="frame_len",
                       num_key_name="packet_num", bits_per_header_sym=1,
                       bits_per_payload_sym=1, scramble_header=False):
    return HeaderFormatOfdm(occupied_carriers, n_syms, len_key_name,
                            frame_key_name, num_key_name, bits_per_header_sym,
                            bits_per_payload_sym, scramble_header)


class ProtocolFormatterAsync(Block):
    """protocol_formatter_async: PDU in -> (header PDU, payload PDU) out
    using a header_format object."""

    def __init__(self, fmt, name=None):
        super().__init__(name)
        self.fmt = fmt
        self.message_port_register_in("in", self._on)
        self.message_port_register_out("header")
        self.message_port_register_out("payload")

    def _on(self, msg):
        meta, data = msg
        data = np.asarray(data, dtype=np.uint8)
        hdr_bits = self.fmt.format(len(data))
        self.post("header", pmt.make_pdu(meta, _bits_to_bytes_msb(hdr_bits)))
        self.post("payload", pmt.make_pdu(meta, data))


def protocol_formatter_async(fmt):
    return ProtocolFormatterAsync(fmt)


class ProtocolFormatterBb(Block):
    """protocol_formatter_bb: tagged-stream header generator — per input
    packet of `payload_bytes`, emit the format's header as bytes.

    The header content (counters advance per packet) is host-deterministic
    but step-varying, so it is delivered param-fed: the host formats this
    window's headers before each device step (apply is traced once)."""

    param_fed = True
    param_port = PortSpec(B)

    def __init__(self, fmt, payload_bytes: int, name=None):
        super().__init__(name)
        self.fmt = fmt
        self.P = int(payload_bytes)
        nh = fmt.header_nbits()
        if nh % 8:
            raise ValueError("header_nbits must be byte-aligned for bb mode")
        self.H = nh // 8
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)

    @property
    def in_rates(self):
        return (Fraction(self.P),)

    @property
    def out_rates(self):
        return (Fraction(self.H),)

    def param_chunk(self, tags_in, n: int) -> np.ndarray:
        k = n // self.P
        return np.concatenate([
            _bits_to_bytes_msb(self.fmt.format(self.P)).view(np.int8)
            for _ in range(k)])

    def apply(self, state, inputs, n_in):
        _x, hdrs = inputs
        return state, (hdrs,)


def protocol_formatter_bb(fmt, payload_bytes):
    return ProtocolFormatterBb(fmt, payload_bytes)


class ProtocolParserB(SinkBlock):
    """protocol_parser_b (gr-digital/lib/protocol_parser_b_impl.cc): a sink
    consuming unpacked header bits; every header_nbits-bit window is parsed
    through the header format object and successful parses post their
    metadata dict on the 'info' message port."""

    def __init__(self, fmt, name=None):
        super().__init__(PortSpec(B), name)
        self.fmt = fmt
        self.message_port_register_out("info")
        # the OFDM form of the parser publishes on 'header_data'
        # (packet_headerparser_b.block.yml) — same payload, alias port
        self.message_port_register_out("header_data")
        self._bits: list[np.ndarray] = []
        self.parsed: list = []

    def reset_host_state(self):
        self._bits = []
        self.parsed = []

    @property
    def tap_port(self):
        return PortSpec(B)

    def apply(self, state, inputs, n_in):
        return state, inputs[0]

    def collect(self, v):
        self._bits.append(np.atleast_1d(np.asarray(v, np.int64)) & 1)
        buf = np.concatenate(self._bits)
        nh = self.fmt.header_nbits()
        nhdr = len(buf) // nh
        for i in range(nhdr):
            info, ok = self.fmt.parse(buf[i * nh:(i + 1) * nh])
            if ok:
                self.parsed.append(info)
                self.post("info", info)
                self.post("header_data", info)
        self._bits = [buf[nhdr * nh:]]


def protocol_parser_b(fmt):
    return ProtocolParserB(fmt)


class Crc32Bb(Block):
    """digital_crc32_bb fixed-packet streaming form (gr-digital
    crc32_bb_impl.cc): append (or check+strip) a little-endian CRC32 per
    packet. The reference reads the packet length from stream tags; the
    static-shape graph fixes it at construction (the importer infers it
    from the upstream tagged-stream chain — grc_import tagged-stream
    resolution pass). CRC bytes are host-computed per window via
    pure_callback — per-packet zlib crc32 is byte-serial control flow the
    host owns; packets per step stay batched on device."""

    def __init__(self, packet_len: int, check: bool = False, name=None):
        super().__init__(name)
        self.P = int(packet_len)          # payload bytes per packet (input)
        self.check = bool(check)
        if self.check and self.P <= 4:
            raise ValueError("crc32_bb check mode needs packets > 4 bytes")
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)

    @property
    def in_rates(self):
        return (Fraction(self.P),)

    @property
    def out_rates(self):
        return (Fraction(self.P - 4 if self.check else self.P + 4),)

    def apply(self, state, inputs, n_in):
        P, Q = self.P, (self.P - 4 if self.check else self.P + 4)
        x = inputs[0].reshape(-1, P)

        def host(pk):
            import zlib
            pk = np.asarray(pk).astype(np.uint8)
            if self.check:
                return pk[:, :Q].view(np.int8)   # strip trailing CRC
            crcs = np.array([zlib.crc32(row.tobytes()) & 0xFFFFFFFF
                             for row in pk], np.uint32)
            tail = crcs[:, None] >> np.arange(0, 32, 8)[None, :]
            return np.concatenate(
                [pk, (tail & 0xFF).astype(np.uint8)], axis=1).view(np.int8)

        shape = jax.ShapeDtypeStruct((x.shape[0], Q), jnp.int8)
        y = jax.pure_callback(host, shape, x)
        return state, (y.reshape(-1),)


def crc32_bb(packet_len, check=False):
    return Crc32Bb(packet_len, check)


# ---------------------------------------------------------------------------
# kurtotic_equalizer_cc
# ---------------------------------------------------------------------------

class KurtoticEqualizer(Block):
    """kurtotic_equalizer_cc: blind adaptive equalizer driven by a kurtosis
    cost (gr-digital/lib/kurtotic_equalizer_cc_impl.cc): tracks p = E|y|^2,
    m = E|y|^4 and q = E[y^2] with one-pole averages (alpha = gain) and
    updates taps with e = y·(|y|^2 − p) style error. Per-sample recurrence ->
    lax.scan; the tap dot products inside the scan are short reductions."""

    def __init__(self, num_taps: int = 11, mu: float = 0.01, name=None):
        super().__init__(name)
        self.N = int(num_taps)
        self.mu = float(mu)
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(C),)

    def init_state(self):
        w = jnp.zeros(self.N, jnp.complex64).at[self.N // 2].set(1.0 + 0j)
        return {
            "w": w,
            "win": jnp.zeros(self.N, jnp.complex64),
            "p": jnp.zeros((), jnp.float32),
            "m": jnp.zeros((), jnp.float32),
            "q": jnp.zeros((), jnp.complex64),
        }

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        mu = self.mu
        alpha = jnp.float32(0.01)

        def step(carry, xn):
            w, win, p, m, q = carry
            win = jnp.roll(win, 1).at[0].set(xn)
            y = jnp.vdot(w, win)  # conj(w)·win, reference uses w^H x
            ay2 = jnp.real(y * jnp.conj(y))
            p = (1 - alpha) * p + alpha * ay2
            m = (1 - alpha) * m + alpha * ay2 * ay2
            q = (1 - alpha) * q + alpha * y * y
            # kurtosis-gradient error (Shalvi-Weinstein): push |y|^2 toward
            # its running mean p (removes ISI-induced modulus spread) with a
            # correction for the tracked conjugate moment q
            e = y * (p - ay2) + jnp.conj(q) * jnp.conj(y) * alpha
            w = w + mu * jnp.conj(e) * win
            return (w, win, p, m, q), y

        carry = (state["w"], state["win"], state["p"], state["m"], state["q"])
        carry, y = jax.lax.scan(step, carry, x)
        w, win, p, m, q = carry
        return ({"w": w, "win": win, "p": p, "m": m, "q": q},
                (y.astype(jnp.complex64),))


def kurtotic_equalizer_cc(num_taps=11, mu=0.01):
    return KurtoticEqualizer(num_taps, mu)


# ---------------------------------------------------------------------------
# probe_density_b, modulate_vector
# ---------------------------------------------------------------------------

class ProbeDensity(SinkBlock):
    """probe_density_b: one-pole average of bit density
    (gr-digital/lib/probe_density_b_impl.cc: d = a·d + (1-a)·bit)."""

    def __init__(self, alpha: float, name=None):
        super().__init__(PortSpec(B), name)
        self.alpha = float(alpha)
        self._density = 1.0

    def collect(self, value):
        bits = np.asarray(value, dtype=np.float64) % 2
        a = self.alpha
        d = self._density
        for b in bits:  # low-rate probe; exact reference recurrence
            d = a * d + (1 - a) * b
        self._density = d

    def trim(self, n):
        pass

    def density(self) -> float:
        return self._density


def probe_density_b(alpha):
    return ProbeDensity(alpha)


def modulate_vector_bc(modulator_block, data: np.ndarray, taps=None):
    """modulate_vector: run a byte vector through a modulator block (and an
    optional shaping FIR), returning the complex baseband vector — the
    reference's offline helper for building correlation targets
    (corr_est_cc usage)."""
    from ..core.runtime import TopBlock
    from .blocks import StreamSource, VectorSink

    src = StreamSource(np.asarray(data, np.int8), PortSpec(B))
    snk = VectorSink(PortSpec(C))
    tb = TopBlock()
    if taps is not None and len(taps):
        from .filter import FirFilter
        fir = FirFilter(1, np.asarray(taps, np.float32), in_complex=True)
        tb.connect(src, modulator_block, fir, snk)
    else:
        tb.connect(src, modulator_block, snk)
    tb.run()
    return snk.data()
