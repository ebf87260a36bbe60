"""gr-blocks catalog, part 3: tag/QA utilities, LFSR BER sources, vector
reshaping, tag-driven gain, PDU sockets.

Reference parity (headers in gr-blocks/include/gnuradio/blocks/):
annotator_1to1 / annotator_alltoall / annotator_raw (tag-propagation QA
blocks, lib/annotator_*.cc), lfsr_32k_source_s + check_lfsr_32k_s
(lib/lfsr_32k_source_s_impl.cc — BER test pattern from the x^15+x+1 LFSR of
include/gnuradio/blocks/lfsr_15_1_0.h), multiply_by_tag_value_cc
(lib/multiply_by_tag_value_cc_impl.cc — gain updated at tag offsets),
random_pdu, socket_pdu (lib/socket_pdu_impl.cc — TCP PDU transport),
tagged_stream_align / tagged_stream_mux / tagged_stream_multiply_length
(lib/tagged_stream_*.cc), tags_strobe, tsb_vector_sink, uchar_to_float,
vector_insert, vector_map, bin_statistics_f.

Design notes: tag-driven behavior splits across the two planes of this
framework. Metadata-only blocks (align/mux/multiply_length, annotators) run
entirely on the host tag sideband; *data* effects of tags (the gain of
multiply_by_tag_value) are delivered to the jitted device step as a
"param-fed" array computed on host from the window's tags BEFORE the step
runs — tag-at-offset semantics stay exact because the sideband is
host-deterministic (see core/runtime._TagEngine).
"""
from __future__ import annotations

import os
import socket as _socket
import threading
from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from ..core import pmt
from ..core.block import Block, SinkBlock, SyncBlock
from ..core.stream import PortSpec, B, S, I, F, C
from ..core.tags import Tag
from .blocks import StreamSource, VectorSink


# ---------------------------------------------------------------------------
# type converts / vector reshaping
# ---------------------------------------------------------------------------

class UcharToFloat(SyncBlock):
    """uchar_to_float: bytes reinterpreted unsigned [0,255] -> float32."""

    def __init__(self, name=None):
        super().__init__(PortSpec(B), PortSpec(F), name)

    def work(self, state, x):
        return state, (x.astype(jnp.int32) & 0xFF).astype(jnp.float32)


def uchar_to_float():
    return UcharToFloat()


class VectorMap(Block):
    """vector_map: gather-remap vector items (gr::blocks::vector_map with a
    single in/out stream). `mapping` indexes the flattened input vector; on
    device this is one fused gather."""

    def __init__(self, dtype, vlen_in: int, mapping, name=None):
        super().__init__(name)
        mapping = np.asarray(mapping, dtype=np.int32).ravel()
        if mapping.size and (mapping.min() < 0 or mapping.max() >= vlen_in):
            raise ValueError("mapping index out of range")
        self.mapping = mapping
        self.in_ports = (PortSpec(dtype, vlen_in),)
        self.out_ports = (PortSpec(dtype, int(mapping.size)),)

    def apply(self, state, inputs, n_in):
        return state, (inputs[0][:, self.mapping],)


def vector_map(dtype, vlen_in, mapping):
    return VectorMap(dtype, vlen_in, mapping)


class VectorInsert(Block):
    """vector_insert_X(data, periodicity, offset): every `periodicity` output
    items, the `len(data)` items starting at `offset` are the constant vector;
    the rest is the input stream (gr-blocks/lib/vector_insert_impl.cc).
    Static-rate form: consumes P-L, produces P per frame."""

    def __init__(self, data, periodicity: int, offset: int = 0, dtype=C,
                 name=None):
        super().__init__(name)
        data = np.asarray(data, dtype=np.dtype(dtype))
        P, L, off = int(periodicity), len(data), int(offset)
        if not (0 <= off <= P - L):
            raise ValueError("offset must satisfy 0 <= offset <= P - len(data)")
        self.P, self.L, self.off = P, L, off
        self.data = data
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)

    @property
    def in_rates(self):
        return (Fraction(self.P - self.L),)

    @property
    def out_rates(self):
        return (Fraction(self.P),)

    def apply(self, state, inputs, n_in):
        x = inputs[0].reshape(-1, self.P - self.L)
        k = x.shape[0]
        ins = jnp.broadcast_to(jnp.asarray(self.data), (k, self.L))
        y = jnp.concatenate(
            [x[:, : self.off], ins, x[:, self.off:]], axis=1)
        return state, (y.reshape(-1),)


def vector_insert_c(data, periodicity, offset=0):
    return VectorInsert(data, periodicity, offset, C)


def vector_insert_f(data, periodicity, offset=0):
    return VectorInsert(data, periodicity, offset, F)


def vector_insert_b(data, periodicity, offset=0):
    return VectorInsert(data, periodicity, offset, B)


# ---------------------------------------------------------------------------
# annotators (tag-propagation QA blocks)
# ---------------------------------------------------------------------------

class Annotator(Block):
    """annotator_1to1 / annotator_alltoall: passthrough that emits a tag
    every `when` items (key = block name, value = running count) and records
    every tag it receives — the reference's tag-propagation test instruments
    (gr-blocks/lib/annotator_1to1_impl.cc, annotator_alltoall_impl.cc)."""

    def __init__(self, when: int, dtype=F, policy: str = "one_to_one",
                 name=None):
        super().__init__(name)
        self.when = int(when)
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)
        self.tag_policy = policy
        self.received: list[Tag] = []
        self._count = 0

    def reset_host_state(self):
        self._count = 0
        self.received = []

    def apply(self, state, inputs, n_in):
        return state, (inputs[0],)

    def transform_tags(self, tags_in, in_win, out_win):
        self.received.extend(tags_in)
        w0, w1 = out_win
        out = list(tags_in)
        first = -(-w0 // self.when) * self.when
        for off in range(first, w1, self.when):
            out.append(Tag(off, self.name, self._count, self.name))
            self._count += 1
        return out


def annotator_1to1(when, dtype=F):
    return Annotator(when, dtype, "one_to_one")


def annotator_alltoall(when, dtype=F):
    return Annotator(when, dtype, "all_to_all")


class AnnotatorRaw(Block):
    """annotator_raw: passthrough; user queues tags at absolute offsets via
    add_tag() before/while running (gr-blocks/lib/annotator_raw_impl.cc)."""

    def __init__(self, dtype=F, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)
        self.pending: list[Tag] = []

    def add_tag(self, offset: int, key, value):
        self.pending.append(Tag(int(offset), key, value, self.name))

    def apply(self, state, inputs, n_in):
        return state, (inputs[0],)

    def transform_tags(self, tags_in, in_win, out_win):
        w0, w1 = out_win
        out = list(tags_in) + [t for t in self.pending if w0 <= t.offset < w1]
        return out


def annotator_raw(dtype=F):
    return AnnotatorRaw(dtype)


# ---------------------------------------------------------------------------
# LFSR 32k BER pattern (lfsr_15_1_0 -> lfsr_32k_source_s / check_lfsr_32k_s)
# ---------------------------------------------------------------------------

def lfsr_15_1_0_bits(n: int, seed: int = 0x7FFF) -> np.ndarray:
    """x^15 + x + 1 maximal LFSR bit sequence (period 32767), matching
    gr-blocks/include/gnuradio/blocks/lfsr_15_1_0.h (sr = (((sr << 1) |
    (((sr >> 14) ^ (sr >> 13)) & 1)) & 0x7FFF))."""
    sr = seed & 0x7FFF
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        bit = ((sr >> 14) ^ (sr >> 13)) & 1
        sr = ((sr << 1) | bit) & 0x7FFF
        out[i] = sr & 1
    return out


def lfsr_32k_words(seed: int = 0x7FFF) -> np.ndarray:
    """One full period of the 32k BER sequence packed LSB-first into int16
    words (gr::blocks::lfsr_32k semantics: 16 successive LFSR bits per
    short). Period = 32767 bits -> 32767 words when re-walked per word."""
    bits = lfsr_15_1_0_bits(32767 * 16, seed)
    w = bits.reshape(-1, 16)
    vals = (w * (1 << np.arange(16, dtype=np.uint32))).sum(axis=1)
    return vals.astype(np.uint16).view(np.int16)


def lfsr_32k_source_s(repeat: bool = True):
    """lfsr_32k_source_s: short stream of the standard BER test pattern."""
    return StreamSource(lfsr_32k_words(), PortSpec(S), repeat=repeat)


class CheckLfsr32kS(VectorSink):
    """check_lfsr_32k_s: sync to the 32k pattern and count right/total words
    (gr-blocks/lib/check_lfsr_32k_s_impl.cc). Data collects on host; stats
    computed by correlating against the reference period at best lag."""

    def __init__(self, name=None):
        super().__init__(PortSpec(S), name)
        self._ref = lfsr_32k_words()

    def stats(self):
        got = self.data()
        ref = self._ref
        n = len(got)
        if n == 0:
            return {"ntotal": 0, "nright": 0}
        # find the alignment that maximizes matches (reference hunts for sync
        # the same way, one word at a time)
        best = 0
        period = len(ref)
        tiled = np.tile(ref, -(-n // period) + 1)
        for lag in range(period):
            m = int((got == tiled[lag:lag + n]).sum())
            if m > best:
                best = m
                if m == n:
                    break
        return {"ntotal": n, "nright": best}


def check_lfsr_32k_s():
    return CheckLfsr32kS()


# ---------------------------------------------------------------------------
# multiply_by_tag_value_cc — tag-driven device gain (param-fed)
# ---------------------------------------------------------------------------

class MultiplyByTagValue(Block):
    """multiply_by_tag_value_cc: multiply the stream by a scalar that updates
    whenever a tag with `tag_key` arrives, starting at the tag's offset
    (gr-blocks/lib/multiply_by_tag_value_cc_impl.cc).

    Mapping: the host derives a piecewise-constant gain vector for each
    step window from the (host-deterministic) tag sideband and feeds it to
    the jitted step; the device does one fused complex multiply."""

    param_fed = True
    param_port = PortSpec(C)

    def __init__(self, tag_key: str = "gain", initial: complex = 1.0,
                 dtype=C, name=None):
        super().__init__(name)
        self.tag_key = tag_key
        self._initial = complex(initial)
        self._cur = complex(initial)
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)
        self._win_start = 0

    def reset_host_state(self):
        self._win_start = 0
        self._cur = self._initial

    def param_chunk(self, tags_in, n: int) -> np.ndarray:
        g = np.full(n, self._cur, dtype=np.complex64)
        w0 = self._win_start
        for t in tags_in:
            if t.key != self.tag_key:
                continue
            rel = int(t.offset) - w0
            val = complex(t.value)
            if rel <= 0:
                g[:] = val
            elif rel < n:
                g[rel:] = val
            self._cur = val
        self._win_start = w0 + n
        return g

    def apply(self, state, inputs, n_in):
        x, gain = inputs
        return state, (x * gain,)


def multiply_by_tag_value_cc(tag_key="gain", initial=1.0):
    return MultiplyByTagValue(tag_key, initial, C)


# ---------------------------------------------------------------------------
# tagged-stream metadata blocks (host tag plane)
# ---------------------------------------------------------------------------

class TaggedStreamMultiplyLength(Block):
    """tagged_stream_multiply_length: scale length-tag values by a constant
    (gr-blocks/lib/tagged_stream_multiply_length_impl.cc) — used after rate
    changes so downstream tagged-stream blocks see correct packet lengths.
    Pure metadata: data passes through untouched."""

    def __init__(self, scalar: float, len_tag_key: str = "packet_len",
                 dtype=C, name=None):
        super().__init__(name)
        self.scalar = scalar
        self.key = len_tag_key
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)

    def apply(self, state, inputs, n_in):
        return state, (inputs[0],)

    def transform_tags(self, tags_in, in_win, out_win):
        out = []
        for t in tags_in:
            if t.key == self.key:
                out.append(Tag(t.offset, t.key,
                               int(round(t.value * self.scalar)), t.srcid))
            else:
                out.append(t)
        return out


def tagged_stream_multiply_length(scalar, len_tag_key="packet_len", dtype=C):
    return TaggedStreamMultiplyLength(scalar, len_tag_key, dtype)


def tagged_stream_packets(data: np.ndarray, tags: list, len_tag_key="packet_len"):
    """Split a tagged stream into packets at its length tags — the host-plane
    core of tagged_stream_align/tsb semantics. Items before the first length
    tag are dropped (tagged_stream_align behavior,
    gr-blocks/lib/tagged_stream_align_impl.cc)."""
    pkts = []
    lens = sorted((t for t in tags if t.key == len_tag_key))
    for t in lens:
        a, b = int(t.offset), int(t.offset) + int(t.value)
        if b <= len(data):
            pkts.append(np.asarray(data[a:b]))
    return pkts


def tagged_stream_align(data, tags, len_tag_key="packet_len"):
    """Host-plane tagged_stream_align: re-emit the stream starting at the
    first length tag, tag offsets rebased to 0."""
    lens = sorted((t for t in tags if t.key == len_tag_key))
    if not lens:
        return np.asarray(data)[:0], []
    start = int(lens[0].offset)
    out_tags = [Tag(t.offset - start, t.key, t.value, t.srcid)
                for t in tags if t.offset >= start]
    return np.asarray(data)[start:], out_tags


def tagged_stream_mux(streams_and_tags, len_tag_key="packet_len"):
    """Host-plane tagged_stream_mux: interleave packets from N tagged streams
    packet-by-packet (gr-blocks/lib/tagged_stream_mux_impl.cc). Returns
    (data, tags) of the muxed stream."""
    pkt_lists = [tagged_stream_packets(d, t, len_tag_key)
                 for (d, t) in streams_and_tags]
    nround = min(len(p) for p in pkt_lists) if pkt_lists else 0
    chunks, tags, off = [], [], 0
    for i in range(nround):
        for pl in pkt_lists:
            p = pl[i]
            tags.append(Tag(off, len_tag_key, len(p), "tagged_stream_mux"))
            chunks.append(p)
            off += len(p)
    data = (np.concatenate(chunks) if chunks
            else np.zeros(0, dtype=np.complex64))
    return data, tags


class TaggedStreamMuxBlock(Block):
    """Streaming tagged_stream_mux (gr-blocks/lib/tagged_stream_mux_impl.cc):
    one packet of lens[i] items from each input per period, concatenated in
    port order. The reference reads per-packet lengths from stream tags at
    runtime; in the static-shape graph the per-input packet length is fixed
    at construction — the importer infers each input's length by walking the
    upstream tagged-stream chain's rate ratios (grc_import._infer_ts_lens).
    Emits a length tag per muxed packet like the reference does."""

    mints_tags = True

    def __init__(self, lens, len_tag_key="packet_len", dtype=C, name=None):
        super().__init__(name)
        self.lens = [int(l) for l in lens]
        if any(l <= 0 for l in self.lens):
            raise ValueError(f"tagged_stream_mux lens must be positive: "
                             f"{self.lens}")
        self.key = len_tag_key
        self.period = sum(self.lens)
        self.in_ports = tuple(PortSpec(dtype) for _ in self.lens)
        self.out_ports = (PortSpec(dtype),)

    @property
    def in_rates(self):
        return tuple(Fraction(l) for l in self.lens)

    @property
    def out_rates(self):
        return (Fraction(self.period),)

    def apply(self, state, inputs, n_in):
        nper = inputs[0].shape[0] // self.lens[0]
        out = jnp.concatenate(
            [x.reshape(nper, l) for x, l in zip(inputs, self.lens)], axis=1)
        return state, (out.reshape(-1),)

    def transform_tags_multi(self, tags_by_port, in_wins, out_wins):
        w0, w1 = out_wins[0]
        out = []
        for p in range((w1 - w0) // self.period):
            off = w0 + p * self.period
            pos = 0
            for l in self.lens:
                out.append(Tag(off + pos, self.key, l, self.name))
                pos += l
        return [out]


def tagged_stream_mux_block(lens, len_tag_key="packet_len", dtype=C):
    return TaggedStreamMuxBlock(lens, len_tag_key, dtype)


class TsbVectorSink(VectorSink):
    """tsb_vector_sink: collect a tagged stream and expose it packet-wise
    (gr-blocks/lib/tsb_vector_sink_impl.cc)."""

    def __init__(self, dtype=C, len_tag_key="packet_len", name=None):
        super().__init__(PortSpec(dtype), name)
        self.len_tag_key = len_tag_key

    def packets(self):
        return tagged_stream_packets(self.data(), self.tags(),
                                     self.len_tag_key)


def tsb_vector_sink(dtype=C, len_tag_key="packet_len"):
    return TsbVectorSink(dtype, len_tag_key)


class TagsStrobe(StreamSource):
    """tags_strobe: emit zeros carrying a user tag every `nsamps` items
    (gr-blocks/lib/tags_strobe_impl.cc). Horizon-bounded: tags are laid out
    for `horizon` items (streams in this framework are chunked host loops, so
    a horizon is the natural analog of 'forever')."""

    def __init__(self, nsamps: int, key="strobe", value=1, dtype=C,
                 horizon: int = 1 << 20, name=None):
        tags = [Tag(off, key, value, "tags_strobe")
                for off in range(0, int(horizon), int(nsamps))]
        super().__init__(np.zeros(int(horizon), dtype=np.dtype(dtype)),
                         PortSpec(dtype), repeat=False, name=name, tags=tags)


def tags_strobe(nsamps, key="strobe", value=1, dtype=C):
    return TagsStrobe(nsamps, key, value, dtype)


# ---------------------------------------------------------------------------
# PDU blocks: random_pdu, socket_pdu
# ---------------------------------------------------------------------------

class RandomPdu(Block):
    """random_pdu: on any input message, emit a uniform-random byte PDU with
    length uniform in [min, max] (gr-blocks/lib/random_pdu_impl.cc)."""

    def __init__(self, min_items: int, max_items: int, byte_mask: int = 0xFF,
                 length_modulo: int = 1, seed: int = 0, name=None):
        super().__init__(name)
        self.lo, self.hi = int(min_items), int(max_items)
        self.mask, self.mod = byte_mask, max(1, length_modulo)
        self.rng = np.random.default_rng(seed)
        self.message_port_register_in("generate", self._on)
        self.message_port_register_out("pdus")

    def _on(self, _msg):
        n = int(self.rng.integers(self.lo, self.hi + 1))
        n = max(self.mod, (n // self.mod) * self.mod)
        data = (self.rng.integers(0, 256, n) & self.mask).astype(np.uint8)
        self.post("pdus", pmt.make_pdu({}, data))


def random_pdu(min_items, max_items, byte_mask=0xFF, length_modulo=1, seed=0):
    return RandomPdu(min_items, max_items, byte_mask, length_modulo, seed)


class SocketPdu(Block):
    """socket_pdu: PDUs over a TCP socket (gr-blocks/lib/socket_pdu_impl.cc,
    TCP_SERVER / TCP_CLIENT modes). Messages posted to 'pdus' (in) are sent
    as length-prefixed frames; received frames are posted on 'pdus' (out).
    The network seam lives on the host plane — device code never blocks on
    sockets (same boundary discipline as parallel/transport.py)."""

    def __init__(self, mode: str, host: str = "127.0.0.1", port: int = 0,
                 name=None):
        super().__init__(name)
        self.message_port_register_in("pdus", self._send)
        self.message_port_register_out("pdus")
        self._rx: list = []
        self._lock = threading.Lock()
        self._conn = None
        if mode == "TCP_SERVER":
            self._srv = _socket.socket()
            self._srv.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
            self._srv.bind((host, port))
            self._srv.listen(1)
            self.port = self._srv.getsockname()[1]
            threading.Thread(target=self._accept, daemon=True).start()
        elif mode == "TCP_CLIENT":
            self._conn = _socket.socket()
            self._conn.connect((host, port))
            self.port = port
            threading.Thread(target=self._recv_loop, args=(self._conn,),
                             daemon=True).start()
        else:
            raise ValueError(f"unsupported socket_pdu mode {mode!r}")

    def _accept(self):
        conn, _ = self._srv.accept()
        self._conn = conn
        self._recv_loop(conn)

    def _recv_loop(self, conn):
        try:
            while True:
                hdr = self._read_exact(conn, 4)
                if hdr is None:
                    return
                n = int.from_bytes(hdr, "big")
                body = self._read_exact(conn, n)
                if body is None:
                    return
                with self._lock:
                    self._rx.append(np.frombuffer(body, dtype=np.uint8))
        except OSError:
            pass

    @staticmethod
    def _read_exact(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _send(self, msg):
        _meta, data = msg
        raw = np.asarray(data, dtype=np.uint8).tobytes()
        for _ in range(200):  # server may not have accepted yet
            if self._conn is not None:
                break
            threading.Event().wait(0.01)
        self._conn.sendall(len(raw).to_bytes(4, "big") + raw)

    def msg_work(self, step_index):
        with self._lock:
            rx, self._rx = self._rx, []
        for data in rx:
            self.post("pdus", pmt.make_pdu({}, data))

    def close(self):
        try:
            if self._conn:
                self._conn.close()
            if hasattr(self, "_srv"):
                self._srv.close()
        except OSError:
            pass


def socket_pdu(mode, host="127.0.0.1", port=0):
    return SocketPdu(mode, host, port)


# ---------------------------------------------------------------------------
# bin_statistics_f — simplified spectrum-stats sink
# ---------------------------------------------------------------------------

class BinStatistics(SinkBlock):
    """bin_statistics_f: accumulate per-bin max over vector items and report
    (gr-blocks/include/gnuradio/blocks/bin_statistics_f.h; the reference
    drives a message-based tune protocol — here the stats accumulate on the
    host plane and `max_bins()` reports the running maximum)."""

    def __init__(self, vlen: int, name=None):
        super().__init__(PortSpec(F, vlen), name)
        self.vlen = vlen
        self._max = np.full(vlen, -np.inf, dtype=np.float32)
        self.message_port_register_out("stats")

    def tap(self, state, x):
        return state, jnp.max(x, axis=0)  # per-step per-bin max

    @property
    def tap_port(self):
        return PortSpec(F, self.vlen)

    def collect(self, value):
        self._max = np.maximum(self._max, np.asarray(value).reshape(-1))

    def max_bins(self):
        return self._max.copy()


def bin_statistics_f(vlen):
    return BinStatistics(vlen)


# ---------------------------------------------------------------------------
# message-port feedback idiom (closed loops ACROSS blocks)
# ---------------------------------------------------------------------------
# The reference forbids stream cycles exactly like this framework does
# (flowgraph.cc topology checks), and builds cross-block feedback with
# MESSAGE ports instead (e.g. edit_box/probe -> msg -> setter callbacks).
# Here the same idiom: a probe sink posts a measurement message each step;
# a param-fed block consumes it on its message port and applies the update
# on the NEXT device step — a one-step-delayed closed loop, which is also
# exactly the latency the reference's async message plane has.

class PowerProbeMsg(SinkBlock):
    """Posts {"power": mean |x|^2 of the step window} on port 'power' each
    step (probe_avg_mag_sqrd + message_strobe collapsed)."""

    def __init__(self, dtype=C, name=None):
        super().__init__(PortSpec(dtype), name)
        self.message_port_register_out("power")
        self.level = None

    @property
    def tap_port(self):
        return PortSpec(F)

    def tap(self, state, x):
        v = jnp.abs(x) if jnp.iscomplexobj(x) else x
        return state, jnp.mean((v * v).astype(jnp.float32))

    def collect(self, value):
        self.level = float(np.asarray(value))
        self.post("power", {"power": self.level})


def power_probe_msg(dtype=C):
    return PowerProbeMsg(dtype)


class MsgGain(Block):
    """Gain block whose scalar gain is driven by messages on 'set' —
    {"power": p} messages steer gain toward reference/sqrt(p) with a
    first-order loop (rate), {"gain": g} sets it directly. Param-fed: the
    host feeds the current gain into the jitted step each call, so updates
    apply on the next step (message-plane latency, see module comment)."""

    param_fed = True
    param_port = PortSpec(F)

    def __init__(self, gain: float = 1.0, reference: float = 1.0,
                 rate: float = 0.5, dtype=C, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)
        self._initial = float(gain)
        self.gain = float(gain)
        self.reference = float(reference)
        self.rate = float(rate)
        self.message_port_register_in("set", self._on_msg)

    def reset_host_state(self):
        self.gain = self._initial

    def _on_msg(self, msg):
        if isinstance(msg, dict) and "gain" in msg:
            self.gain = float(msg["gain"])
        elif isinstance(msg, dict) and "power" in msg:
            # the probe sits AFTER the gain: multiplicative correction so
            # the fixed point is output_power == reference
            p = max(float(msg["power"]), 1e-20)
            target = self.gain * (self.reference / p) ** 0.5
            self.gain += self.rate * (target - self.gain)

    def param_chunk(self, tags_in, n: int) -> np.ndarray:
        return np.full(1, self.gain, np.float32)

    def apply(self, state, inputs, n_in):
        x, g = inputs
        return state, (x * g[0].astype(x.dtype),)


def msg_gain(gain=1.0, reference=1.0, rate=0.5, dtype=C):
    return MsgGain(gain, reference, rate, dtype)


class TestTagVariableRate(Block):
    """blocks_test_tag_variable_rate_ff
    (gr-blocks/lib/test_tag_variable_rate_ff_impl.cc): the tag-rate
    stress QA helper. Static-shape analog: the reference walks its
    resampling rate stochastically around the nominal relative rate 1:2
    (its set_relative_rate(1, 2)); here the nominal rate is fixed so the
    graph stays compilable, and the same 'rrate' tags are minted every
    update_period outputs — downstream tag-offset scaling across the
    rate change is exercised deterministically."""

    mints_tags = True

    def __init__(self, update_once=False, update_step=0.001,
                 update_period=256, name=None):
        super().__init__(name)
        self.update_step = float(update_step)
        self.update_period = int(update_period)
        self.in_ports = (PortSpec(F),)
        self.out_ports = (PortSpec(F),)

    @property
    def in_rates(self):
        return (Fraction(2),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def apply(self, state, inputs, n_in):
        return state, (inputs[0][::2],)

    def transform_tags(self, tags_in, in_win, out_win):
        from ..core.tags import Tag
        w0, w1 = out_win
        first = -(-w0 // self.update_period) * self.update_period
        new = [Tag(off, "rrate", 0.5, self.name)
               for off in range(first, w1, self.update_period)]
        # input tags ride through at the halved offsets (TPP_DONT in the
        # reference; here scaled like the executor's rational policy)
        scaled = [Tag(t.offset // 2, t.key, t.value, t.srcid)
                  for t in tags_in]
        return scaled + new


def test_tag_variable_rate_ff(update_once=False, update_step=0.001):
    return TestTagVariableRate(update_once, update_step)


class PadMsgSource(RandomPdu):
    """Direct-run stand-in for a MESSAGE-typed pad_source in a
    hier-defining .grc executed standalone: self-drives one fixed-size
    random PDU per step on 'out' (subclassing RandomPdu keeps the
    tagged-stream length walk's size pinning applicable)."""

    def __init__(self, nbytes: int = 128, name=None):
        super().__init__(nbytes, nbytes, name=name)
        self.message_port_register_out("out")

    def msg_work(self, step_index):
        data = self.rng.integers(0, 256, self.hi).astype(np.uint8)
        self.post("out", pmt.make_pdu({}, data))
