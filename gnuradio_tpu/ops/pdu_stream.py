"""PDU <-> tagged-stream bridges + PDU metadata tools.

Reference parity (gr-blocks/include/gnuradio/blocks/):
  pdu_to_tagged_stream  lib/pdu_to_tagged_stream_impl.cc — PDUs in on a
                        message port, bytes out as a tagged stream with a
                        packet_len tag per burst
  tagged_stream_to_pdu  lib/tagged_stream_to_pdu_impl.cc — inverse
  pdu_filter / pdu_set / pdu_remove — metadata dict tools (message-only)

Design: PDU payloads enter the device plane through the host-fed
source path (a queue of delivered PDUs becomes the step's chunk, padded to
the static chunk size with a validity count recorded in the length tags);
the sink direction reassembles packets from the length-tag sideband."""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import pmt
from ..core.block import Block, SinkBlock, SourceBlock
from ..core.stream import PortSpec, B
from ..core.tags import Tag


class PduToTaggedStream(SourceBlock):
    """PDUs delivered on 'pdus' (before or between runs) stream out as
    bytes with a `packet_len` tag at each burst start. The host-fed chunk
    generator drains the queue; the final partial chunk is zero-padded and
    sinks are trimmed by head semantics like every fed source."""

    is_fed = True
    mints_tags = True   # stream_tags populated lazily in chunks()

    def __init__(self, len_tag_key: str = "packet_len", name=None):
        super().__init__(PortSpec(B), name)
        self.len_tag_key = len_tag_key
        self.message_port_register_in("pdus", self._on_pdu)
        self._queue: list[np.ndarray] = []
        self.items_supplied = 0
        self.stream_tags: list[Tag] = []

    def _on_pdu(self, msg):
        meta, data = msg
        self._queue.append(np.asarray(data, np.uint8))

    def chunks(self, n: int):
        data_all = (np.concatenate(self._queue) if self._queue
                    else np.zeros(0, np.uint8))
        off = 0
        self.stream_tags = []
        for p in self._queue:
            self.stream_tags.append(Tag(off, self.len_tag_key, len(p),
                                        self.name))
            off += len(p)
        self.items_supplied = 0
        pos = 0
        from ..core.stream import host_encode
        while pos < len(data_all):
            chunk = data_all[pos: pos + n]
            self.items_supplied += len(chunk)
            if len(chunk) < n:
                chunk = np.concatenate(
                    [chunk, np.zeros(n - len(chunk), np.uint8)])
            yield host_encode(chunk.view(np.int8))
            pos += n

    def apply(self, state, inputs, n_in):
        return state, (inputs[0],)


def pdu_to_tagged_stream(len_tag_key="packet_len"):
    return PduToTaggedStream(len_tag_key)


class TaggedStreamToPdu(SinkBlock):
    """Reassemble `packet_len`-tagged bytes into PDUs posted on 'pdus'."""

    def __init__(self, len_tag_key: str = "packet_len", dtype=B, name=None):
        super().__init__(PortSpec(dtype), name)
        self.len_tag_key = len_tag_key
        self.message_port_register_out("pdus")
        self._data: list[np.ndarray] = []
        self._tags: list[Tag] = []
        self._emitted = 0
        self.pdus: list = []

    def reset_host_state(self):
        self._data = []
        self._tags = []
        self._emitted = 0

    def collect(self, value):
        self._data.append(np.asarray(value).astype(np.uint8))
        self._flush()

    def collect_tags(self, tags):
        self._tags.extend(t for t in tags if t.key == self.len_tag_key)

    def _flush(self):
        data = np.concatenate(self._data) if self._data else np.zeros(0)
        while self._emitted < len(self._tags):
            t = self._tags[self._emitted]
            a, b = int(t.offset), int(t.offset) + int(t.value)
            if b > len(data):
                return
            pdu = pmt.make_pdu({}, data[a:b].copy())
            self.pdus.append(pdu)
            self.post("pdus", pdu)
            self._emitted += 1


def tagged_stream_to_pdu(len_tag_key="packet_len", dtype=B):
    return TaggedStreamToPdu(len_tag_key, dtype)


class _PduMetaTool(Block):
    """Message-only base: PDU in on 'pdus', transformed PDU out on 'pdus'."""

    def __init__(self, name=None):
        super().__init__(name)
        self.message_port_register_in("pdus", self._on)
        self.message_port_register_out("pdus")

    def _on(self, msg):
        out = self.transform(msg)
        if out is not None:
            self.post("pdus", out)

    def transform(self, msg):
        raise NotImplementedError


class PduFilter(_PduMetaTool):
    """pdu_filter: pass PDUs whose meta[key] == value (invert to drop)."""

    def __init__(self, key, value, invert=False, name=None):
        super().__init__(name)
        self.key, self.value, self.invert = key, value, bool(invert)

    def transform(self, msg):
        meta, data = msg
        match = isinstance(meta, dict) and meta.get(self.key) == self.value
        return msg if match != self.invert else None


class PduSet(_PduMetaTool):
    """pdu_set: set meta[key] = value on every PDU."""

    def __init__(self, key, value, name=None):
        super().__init__(name)
        self.key, self.value = key, value

    def transform(self, msg):
        meta, data = msg
        m = dict(meta) if isinstance(meta, dict) else {}
        m[self.key] = self.value
        return (m, data)


class PduRemove(_PduMetaTool):
    """pdu_remove: delete meta[key]."""

    def __init__(self, key, name=None):
        super().__init__(name)
        self.key = key

    def transform(self, msg):
        meta, data = msg
        m = dict(meta) if isinstance(meta, dict) else {}
        m.pop(self.key, None)
        return (m, data)


def pdu_filter(key, value, invert=False):
    return PduFilter(key, value, invert)


def pdu_set(key, value):
    return PduSet(key, value)


def pdu_remove(key):
    return PduRemove(key)
