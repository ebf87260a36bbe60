"""Distributed stream/message transport — the gr-zeromq analog (DCN plane).

Reference parity:
  gr-zeromq/lib/base_impl.cc:38-80   — socket setup, HWM backpressure
  gr-zeromq/lib/tag_headers.cc:16-50 — in-band tag header: magic, version,
      absolute offset, ntags, PMT-serialized tags, then raw samples
  gr-zeromq QA (qa_zeromq_pubsub.py etc.) — both ends in one process over
      localhost, asserting sample+tag fidelity across the hop

Design split (SURVEY.md §2.4/§5): *intra-host* streams move between devices
via jax collectives inside shard_map (parallel.halo); this module is the
*inter-host / DCN* seam — plain TCP with length-prefixed frames (PUSH/PULL
semantics: connection-oriented, kernel backpressure = the HWM analog).
Frames carry the same metadata the reference serializes: absolute item
offset + stream tags, so offset bookkeeping survives the hop exactly.

Wire frame:
    u32 frame_len (bytes after this field)
    u16 magic 0x5FF1 | u8 version 1 | u8 kind (0=stream, 1=message)
    u64 offset | u32 nitems | u32 itemsize | u32 ntags
    ntags x pmt-serialized (offset, key, value, srcid)
    payload: nitems*itemsize raw bytes (native endian)
"""
from __future__ import annotations

import socket
import struct
import threading

import numpy as np

from ..core import pmt
from ..core.block import SinkBlock, SourceBlock
from ..core.stream import PortSpec, C, host_encode
from ..core.tags import Tag

MAGIC = 0x5FF1
KIND_STREAM, KIND_MSG = 0, 1


def _pack_frame(kind: int, offset: int, payload: bytes, itemsize: int,
                nitems: int, tags) -> bytes:
    tag_blobs = b"".join(
        pmt.serialize((t.offset, t.key, t.value, t.srcid)) for t in tags)
    body = struct.pack("<HBBQIII", MAGIC, 1, kind, offset, nitems, itemsize,
                       len(tags)) + tag_blobs + payload
    return struct.pack("<I", len(body)) + body


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _unpack_frame(body: bytes):
    magic, ver, kind, offset, nitems, itemsize, ntags = struct.unpack_from(
        "<HBBQIII", body, 0)
    if magic != MAGIC or ver != 1:
        raise ValueError("bad frame header")
    pos = struct.calcsize("<HBBQIII")
    tags = []
    for _ in range(ntags):
        val, pos = pmt._deser(body, pos)
        toff, key, value, srcid = val
        tags.append(Tag(toff, key, value, srcid))
    payload = body[pos:]
    return kind, offset, nitems, itemsize, tags, payload


def _family_of(addr: str) -> int:
    return socket.AF_INET6 if ":" in str(addr) else socket.AF_INET


class StreamServer:
    """PUSH-side listener: accepts one peer, sends frames (kernel TCP
    backpressure plays the HWM role). IPv6 addresses select AF_INET6."""

    def __init__(self, bind_addr: str = "127.0.0.1", port: int = 0):
        if bind_addr in ("::", ""):
            bind_addr = "::" if ":" in bind_addr else "0.0.0.0"
        self._lsock = socket.socket(_family_of(bind_addr))
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((bind_addr, port))
        self._lsock.listen(1)
        self.port = self._lsock.getsockname()[1]
        self._conn = None
        self._lock = threading.Lock()

    def _ensure(self):
        if self._conn is None:
            self._conn, _ = self._lsock.accept()
            self._conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def send_items(self, arr: np.ndarray, offset: int, tags=()):
        self._ensure()
        a = np.ascontiguousarray(arr)
        frame = _pack_frame(KIND_STREAM, offset, a.tobytes(), a.dtype.itemsize
                            * (a.shape[1] if a.ndim > 1 else 1),
                            a.shape[0], tags)
        with self._lock:
            self._conn.sendall(frame)

    def send_message(self, msg):
        self._ensure()
        blob = pmt.serialize(msg)
        frame = _pack_frame(KIND_MSG, 0, blob, 1, len(blob), ())
        with self._lock:
            self._conn.sendall(frame)

    def send_gr_message_frame(self, arr: np.ndarray, offset: int, tags=()):
        """codec='gr': the frame body is EXACTLY what a reference
        gr-zeromq stream block puts in one ZMQ message —
        tag_headers.cc header followed by raw samples (core/pmt_wire).
        The carrier here is this module's length-prefixed TCP instead of
        ZMTP; the payload bytes are bit-identical."""
        from ..core import pmt_wire
        self._ensure()
        a = np.ascontiguousarray(arr)
        body = pmt_wire.gen_tag_header(offset, list(tags)) + a.tobytes()
        with self._lock:
            self._conn.sendall(struct.pack("<I", len(body)) + body)

    def close(self):
        for s in (self._conn, self._lsock):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._conn = None


class StreamClient:
    """PULL-side: connects and reads frames. Connection is LAZY with
    retries so graph construction order (client blocks may be built before
    the server binds, as in one-process loopback .grc files) doesn't
    matter — same contract as ZMQ connect."""

    def __init__(self, addr: str, port: int, timeout: float = 10.0,
                 lazy: bool = False):
        self._addr, self._port, self._timeout = addr, int(port), timeout
        self._sock = None
        self._rxbuf = bytearray()   # partial-frame reassembly (poll path)
        if not lazy:
            self._connect()

    def _connect(self):
        import time as _time
        deadline = _time.time() + self._timeout
        last = None
        while True:
            # always make at least one attempt, even with timeout <= 0;
            # cap the per-attempt timeout at the remaining deadline so the
            # worst-case wait is ~the configured timeout, not 2x.
            attempt_to = max(0.05, min(self._timeout,
                                       deadline - _time.time()))
            try:
                self._sock = socket.create_connection(
                    (self._addr, self._port), timeout=attempt_to)
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
                return
            except OSError as e:
                last = e
                if _time.time() >= deadline:
                    break
                _time.sleep(0.05)
        raise last if last is not None else TimeoutError(
            f"connect to {self._addr}:{self._port} timed out")

    def _ensure(self):
        if self._sock is None:
            self._connect()

    def recv_frame(self, timeout: float | None = None):
        """-> (kind, offset, nitems, itemsize, tags, payload), None on
        EOF, or the string 'timeout' when `timeout` elapses mid-wait
        (partial bytes stay buffered)."""
        self._ensure()
        self._sock.settimeout(timeout)
        # drain a buffered frame first (the poll path may have read ahead)
        fr = self._pop_buffered_frame()
        if fr is not None:
            return fr
        while True:
            try:
                chunk = self._sock.recv(65536)
            except socket.timeout:
                return "timeout"
            if not chunk:
                return None
            self._rxbuf += chunk
            fr = self._pop_buffered_frame()
            if fr is not None:
                return fr

    def _pop_buffered_frame(self):
        """Parse ONE complete frame from the reassembly buffer, or None.
        Partial bytes stay buffered — a timeout mid-frame never
        desynchronizes the length-prefixed stream."""
        if len(self._rxbuf) < 4:
            return None
        (n,) = struct.unpack("<I", bytes(self._rxbuf[:4]))
        if len(self._rxbuf) < 4 + n:
            return None
        body = bytes(self._rxbuf[4:4 + n])
        del self._rxbuf[:4 + n]
        return _unpack_frame(body)

    def send_items(self, arr: np.ndarray, offset: int, tags=()):
        """Client-side SEND (network_tcp_sink client mode): same frame
        format as StreamServer.send_items over the connected socket."""
        self._ensure()
        a = np.ascontiguousarray(arr)
        frame = _pack_frame(KIND_STREAM, offset, a.tobytes(),
                            a.dtype.itemsize
                            * (a.shape[1] if a.ndim > 1 else 1),
                            a.shape[0], tags)
        self._sock.sendall(frame)

    def poll_frames(self, timeout: float = 0.05):
        """Non-blocking-ish poll: read whatever bytes are available within
        `timeout`, buffer partial frames across calls, and yield only
        complete frames."""
        self._ensure()
        self._sock.settimeout(timeout)
        frames = []
        try:
            while True:
                fr = self._pop_buffered_frame()
                if fr is not None:
                    frames.append(fr)
                    continue
                chunk = self._sock.recv(65536)
                if not chunk:
                    break       # EOF; return what we have
                self._rxbuf += chunk
        except (socket.timeout, OSError):
            pass
        return frames

    def recv_items(self, dtype, timeout: float | None = None):
        fr = self.recv_frame(timeout)
        if fr is None:
            return None
        if fr == "timeout":
            return "timeout"
        kind, offset, nitems, itemsize, tags, payload = fr
        arr = np.frombuffer(payload, dtype=dtype)
        return arr, offset, tags

    def recv_message(self):
        fr = self.recv_frame()
        if fr is None:
            return None
        return pmt.deserialize(fr[5])

    def recv_gr_message_frame(self, dtype):
        """codec='gr' counterpart of send_gr_message_frame: one
        length-prefixed body = tag header + raw samples. Returns
        (samples, stream_offset, [Tag...]) or None on EOF."""
        from ..core import pmt_wire
        self._ensure()
        while True:
            fr = self._pop_gr_body()
            if fr is not None:
                body = fr
                break
            chunk = self._sock.recv(65536)
            if not chunk:
                return None
            self._rxbuf += chunk
        offset, tags, pos = pmt_wire.parse_tag_header(body)
        arr = np.frombuffer(body[pos:], dtype=np.dtype(dtype))
        return arr, offset, tags

    def _pop_gr_body(self):
        if len(self._rxbuf) < 4:
            return None
        (n,) = struct.unpack("<I", bytes(self._rxbuf[:4]))
        if len(self._rxbuf) < 4 + n:
            return None
        body = bytes(self._rxbuf[4:4 + n])
        del self._rxbuf[:4 + n]
        return body

    def close(self):
        if self._sock is not None:
            self._sock.close()


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class TcpStreamSink(SinkBlock):
    """Stream sink publishing chunks + window tags over TCP
    (zeromq::push_sink analog)."""

    def __init__(self, server: StreamServer, in_port: PortSpec = PortSpec(C),
                 name=None):
        super().__init__(in_port, name)
        self.server = server
        self._offset = 0
        self._tag_windows = []   # queue: one tag list per collected window
                                 # (collect_tags may run ahead of collect
                                 # under the runtime's deferred-fetch path)

    def collect_tags(self, tags):
        self._tag_windows.append(list(tags))

    def collect(self, value):
        arr = np.asarray(value)
        tags = self._tag_windows.pop(0) if self._tag_windows else []
        self.server.send_items(arr, self._offset, tags)
        self._offset += arr.shape[0]


class TcpStreamSource(SourceBlock):
    """Host-fed source pulling chunks from TCP (zeromq::pull_source analog).
    Received tags re-enter the tag sideband at their transported absolute
    offsets."""

    is_fed = True
    mints_tags = True   # stream_tags arrive from the wire during chunks()

    def __init__(self, client: StreamClient, out_port: PortSpec = PortSpec(C),
                 name=None, fill_timeout: float | None = None):
        super().__init__(out_port, name)
        self.client = client
        self.items_supplied = 0
        self.stream_tags: list = []
        # fill_timeout: one-process loopback graphs (both ZMQ ends in one
        # flowgraph, like the reference gr-zeromq examples) would deadlock
        # — the source pulls before the same step's sink sends. With a
        # timeout, un-arrived items fill as zeros (the stream runs one
        # step of latency behind, exactly the reference's pipeline lag).
        self.fill_timeout = fill_timeout

    def chunks(self, n: int):
        np_dtype = np.dtype(self.out_ports[0].dtype)
        buf = np.zeros(0, np_dtype)
        self.items_supplied = 0
        eof = False
        while not eof:
            while len(buf) < n:
                got = self.client.recv_items(np_dtype, self.fill_timeout)
                if got is None:
                    eof = True
                    break
                if isinstance(got, str):        # timeout: zero-fill
                    break
                arr, offset, tags = got
                self.stream_tags.extend(tags)
                buf = np.concatenate([buf, arr])
            if len(buf) == 0 and eof:
                return
            chunk, buf = buf[:n], buf[n:]
            # EOF shortfall: count only the real items (the sink truncates
            # the padded tail); timeout fill: count the whole chunk (the
            # stream is live, just lagging)
            self.items_supplied += len(chunk) if eof else n
            if len(chunk) < n:
                chunk = np.concatenate([chunk, np.zeros(n - len(chunk),
                                                        np_dtype)])
            yield host_encode(chunk)

    def apply(self, state, inputs, n_in):
        return state, (inputs[0],)


# ---------------------------------------------------------------------------
# gr-zeromq pattern parity: PUB/SUB (fan-out), REQ/REP (pull backpressure),
# and the message variants. Same wire frames; the pattern names map to the
# reference's twelve block types (gr-zeromq/include/gnuradio/zeromq/).
# ---------------------------------------------------------------------------

class PubServer(StreamServer):
    """PUB-side: accepts MANY subscribers, every frame fans out to all
    (zeromq::pub_sink / pub_msg_sink analog). Late joiners miss earlier
    frames, like ZMQ PUB/SUB."""

    def __init__(self, bind_addr: str = "127.0.0.1", port: int = 0):
        super().__init__(bind_addr, port)
        self._lsock.listen(16)
        self._conns: list = []
        self._lsock.settimeout(0.0)  # non-blocking accepts

    def _accept_new(self):
        while True:
            try:
                c, _ = self._lsock.accept()
            except (BlockingIOError, socket.timeout):
                return
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(c)

    def _broadcast(self, frame: bytes):
        self._accept_new()
        dead = []
        with self._lock:
            for c in self._conns:
                try:
                    c.sendall(frame)
                except OSError:
                    dead.append(c)
            for c in dead:
                self._conns.remove(c)

    def send_items(self, arr, offset, tags=()):
        a = np.ascontiguousarray(arr)
        self._broadcast(_pack_frame(
            KIND_STREAM, offset, a.tobytes(),
            a.dtype.itemsize * (a.shape[1] if a.ndim > 1 else 1),
            a.shape[0], tags))

    def send_message(self, msg):
        blob = pmt.serialize(msg)
        self._broadcast(_pack_frame(KIND_MSG, 0, blob, 1, len(blob), ()))

    def wait_for_subscribers(self, n: int, timeout: float = 10.0):
        import time
        t0 = time.time()
        while len(self._conns) < n:
            self._accept_new()
            if time.time() - t0 > timeout:
                raise TimeoutError("subscribers did not connect")
            time.sleep(0.01)

    def close(self):
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self._conns = []
        super().close()


SubClient = StreamClient  # SUB side reads frames exactly like PULL


class RepServer:
    """REP-side: serves one item-batch per request — the pull-based
    backpressure pattern (zeromq::rep_sink analog). Request payload is a
    u32 item count."""

    def __init__(self, bind_addr: str = "127.0.0.1", port: int = 0):
        self._srv = StreamServer(bind_addr, port)
        self.port = self._srv.port
        self._buf = None
        self._offset = 0
        self._tags: list = []

    def feed(self, arr: np.ndarray, tags=()):
        arr = np.ascontiguousarray(arr)
        self._buf = arr if self._buf is None else np.concatenate(
            [self._buf, arr])
        self._tags.extend(tags)

    def serve_once(self) -> bool:
        """Block for one request, answer with up to `count` items.
        Returns False when the peer disconnected."""
        self._srv._ensure()
        hdr = _read_exact(self._srv._conn, 4)
        if hdr is None:
            return False
        (count,) = struct.unpack("<I", hdr)
        n = 0 if self._buf is None else min(count, len(self._buf))
        chunk = self._buf[:n] if n else np.zeros(0, np.complex64)
        self._buf = None if self._buf is None else self._buf[n:]
        tags = [t for t in self._tags if t.offset < self._offset + n]
        self._tags = [t for t in self._tags
                      if t.offset >= self._offset + n]
        self._srv.send_items(chunk.reshape(n, -1) if chunk.ndim > 1
                             else chunk, self._offset, tags)
        self._offset += n
        return True

    def close(self):
        self._srv.close()


class StreamAcceptor(StreamClient):
    """Server-mode RECEIVER (network_tcp_source server=True): binds and
    accepts one peer lazily, then reads frames with the same reassembly
    machinery as StreamClient."""

    def __init__(self, bind_addr: str = "0.0.0.0", port: int = 0,
                 timeout: float = 10.0):
        self._timeout = timeout
        self._rxbuf = bytearray()
        self._sock = None
        if bind_addr in ("::", ""):
            bind_addr = "::" if ":" in str(bind_addr) else "0.0.0.0"
        self._lsock = socket.socket(_family_of(bind_addr))
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((bind_addr, int(port)))
        self._lsock.listen(1)
        self.port = self._lsock.getsockname()[1]

    def _connect(self):
        self._lsock.settimeout(self._timeout)
        self._sock, _ = self._lsock.accept()
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def close(self):
        for s in (self._sock, self._lsock):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass


class ReqClient:
    """REQ-side: requests batches of items (zeromq::req_source analog)."""

    def __init__(self, addr: str, port: int, timeout: float = 10.0,
                 lazy: bool = False):
        self._cli = StreamClient(addr, port, timeout, lazy=lazy)

    def request_items(self, count: int, dtype):
        self._cli._ensure()
        self._cli._sock.sendall(struct.pack("<I", count))
        return self._cli.recv_items(np.dtype(dtype))

    def close(self):
        self._cli.close()


class MsgPubSink:
    """pub_msg_sink analog: call post(msg) to fan a PMT out to subscribers."""

    def __init__(self, server: PubServer):
        self.server = server

    def post(self, msg):
        self.server.send_message(msg)


class MsgSubSource:
    """sub_msg_source analog: iterate received PMTs."""

    def __init__(self, client: StreamClient):
        self.client = client

    def recv(self):
        return self.client.recv_message()


# ---------------------------------------------------------------------------
# GRC-facing block factories in reference naming
# (gr-zeromq/include/gnuradio/zeromq/ twelve block types). Address syntax is
# the reference's "tcp://host:port" ("*" binds all interfaces); the wire is
# this module's framed TCP (tags in-band), the pattern semantics map
# PUSH/PULL -> StreamServer/StreamClient, PUB/SUB -> PubServer fan-out,
# REQ/REP -> RepServer pull-backpressure.
# ---------------------------------------------------------------------------

def _parse_address(address: str):
    a = str(address)
    if "://" in a:
        a = a.split("://", 1)[1]
    host, _, port = a.rpartition(":")
    host = host or "127.0.0.1"
    if host in ("*", "0.0.0.0"):
        host = "0.0.0.0"
    return host, int(port)


def _spec(dtype=C, vlen=1):
    from ..core.stream import dtype_of, F, I, S, B
    if isinstance(dtype, type):
        # GRC 'type' params evaluate to python classes in the importer's
        # namespace (complex/float/int) — map to the stream item dtypes
        dtype = {complex: C, float: F, int: I}.get(dtype, dtype)
    if isinstance(dtype, str):
        dtype = dtype_of({"complex": "c", "float": "f", "int": "i",
                          "short": "s", "byte": "b"}.get(dtype, dtype))
    return PortSpec(dtype, int(vlen or 1))


def push_sink(address="tcp://127.0.0.1:0", type=C, vlen=1, **_):
    host, port = _parse_address(address)
    return TcpStreamSink(StreamServer(host, port), _spec(type, vlen))


def pull_source(address="tcp://127.0.0.1:0", type=C, vlen=1, timeout=10.0,
                **_):
    host, port = _parse_address(address)
    return TcpStreamSource(StreamClient(host, port, float(timeout), lazy=True),
                           _spec(type, vlen), fill_timeout=1.0)


def pub_sink(address="tcp://127.0.0.1:0", type=C, vlen=1, **_):
    host, port = _parse_address(address)
    return TcpStreamSink(PubServer(host, port), _spec(type, vlen))


def sub_source(address="tcp://127.0.0.1:0", type=C, vlen=1, timeout=10.0,
               **_):
    # SUB wire-side == PULL (SubClient = StreamClient)
    host, port = _parse_address(address)
    return TcpStreamSource(SubClient(host, port, float(timeout), lazy=True),
                           _spec(type, vlen), fill_timeout=1.0)


class RepStreamSink(SinkBlock):
    """zeromq::rep_sink analog: collected chunks are served on request by
    a background thread (pull-based backpressure rides the request side)."""

    def __init__(self, server: RepServer, in_port: PortSpec = PortSpec(C),
                 name=None):
        super().__init__(in_port, name)
        self.server = server
        # serve from construction: a one-process loopback's REQ side asks
        # BEFORE the first step feeds anything — empty replies until then
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def collect(self, value):
        self.server.feed(np.asarray(value))

    def _serve(self):
        try:
            while self.server.serve_once():
                pass
        except OSError:
            pass


def rep_sink(address="tcp://127.0.0.1:0", type=C, vlen=1, **_):
    host, port = _parse_address(address)
    return RepStreamSink(RepServer(host, port), _spec(type, vlen))


class ReqStreamSource(SourceBlock):
    """zeromq::req_source analog: requests item batches on demand."""

    is_fed = True

    def __init__(self, client: ReqClient, out_port: PortSpec = PortSpec(C),
                 name=None):
        super().__init__(out_port, name)
        self.client = client
        self.items_supplied = 0

    def chunks(self, n: int):
        # A short (non-empty) REP reply is NOT end-of-stream — RepServer
        # legitimately returns min(count, buffered) while the feeder is
        # still filling. Accumulate real items until n are available (like
        # TcpStreamSource.chunks) and only zero-pad at true EOF, so no
        # fabricated zeros are interleaved mid-stream.
        import time as _time
        np_dtype = np.dtype(self.out_ports[0].dtype)
        buf = np.zeros(0, np_dtype)
        self.items_supplied = 0
        eof = False
        empty_polls = 0
        while not eof:
            while len(buf) < n:
                got = self.client.request_items(n - len(buf), np_dtype)
                if got is None:
                    eof = True
                    break
                if got[0].shape[0] == 0:
                    # empty reply: feeder may still be filling — retry
                    # briefly; persistent empties zero-fill the chunk
                    # (one-process loopback lag, same policy as
                    # TcpStreamSource.fill_timeout). True EOF is a closed
                    # connection (got is None).
                    empty_polls += 1
                    if empty_polls > 20:
                        empty_polls = 0
                        break
                    _time.sleep(0.01)
                    continue
                empty_polls = 0
                buf = np.concatenate([buf, got[0]])
            if len(buf) == 0:
                return
            chunk, buf = buf[:n], buf[n:]
            self.items_supplied += len(chunk)
            if len(chunk) < n:
                chunk = np.concatenate([chunk, np.zeros(n - len(chunk),
                                                        np_dtype)])
            yield host_encode(chunk)

    def apply(self, state, inputs, n_in):
        return state, (inputs[0],)


def req_source(address="tcp://127.0.0.1:0", type=C, vlen=1, timeout=10.0,
               **_):
    host, port = _parse_address(address)
    return ReqStreamSource(ReqClient(host, port, float(timeout), lazy=True),
                           _spec(type, vlen))


class ZmqMsgSink(SinkBlock):
    """Message-variant sinks (pub_msg_sink / push_msg_sink / rep_msg_sink):
    PMTs posted to the 'in' message port go out over the wire."""

    accept_any_msg = True       # msg-only: the stream port is vestigial
    optional_inputs = (0,)

    def __init__(self, server, name=None):
        super().__init__(PortSpec(C), name)
        self.server = server
        self.message_port_register_in("in", self._on_msg)

    def _on_msg(self, msg):
        self.server.send_message(msg)

    def collect(self, value):   # stream port unused; msg-only block
        pass


class ZmqMsgSource(SourceBlock):
    """Message-variant sources: polls the wire and publishes PMTs on the
    'out' message port each step."""

    is_fed = False

    def __init__(self, client, name=None):
        super().__init__(PortSpec(C), name)
        self.client = client
        self.message_port_register_out("out")

    def generate(self, state, n):
        # msg-only block: the vestigial stream port emits zeros
        import jax.numpy as jnp
        return state, jnp.zeros(n, C)

    def msg_work(self, step_index):
        try:
            for fr in self.client.poll_frames(0.05):
                self.post("out", pmt.deserialize(fr[5]))
        except (socket.timeout, OSError):
            pass


def pub_msg_sink(address="tcp://127.0.0.1:0", **_):
    host, port = _parse_address(address)
    return ZmqMsgSink(PubServer(host, port))


def push_msg_sink(address="tcp://127.0.0.1:0", **_):
    host, port = _parse_address(address)
    return ZmqMsgSink(StreamServer(host, port))


def rep_msg_sink(address="tcp://127.0.0.1:0", **_):
    host, port = _parse_address(address)
    return ZmqMsgSink(StreamServer(host, port))


def sub_msg_source(address="tcp://127.0.0.1:0", timeout=10.0, **_):
    host, port = _parse_address(address)
    return ZmqMsgSource(StreamClient(host, port, float(timeout), lazy=True))


def pull_msg_source(address="tcp://127.0.0.1:0", timeout=10.0, **_):
    host, port = _parse_address(address)
    return ZmqMsgSource(StreamClient(host, port, float(timeout), lazy=True))


def req_msg_source(address="tcp://127.0.0.1:0", timeout=10.0, **_):
    host, port = _parse_address(address)
    return ZmqMsgSource(StreamClient(host, port, float(timeout), lazy=True))
