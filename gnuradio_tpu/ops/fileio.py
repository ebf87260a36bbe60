"""File & WAV I/O blocks — gr-blocks file_source/file_sink/wavfile analog.

Reference parity:
  gr-blocks/lib/file_source_impl.cc / file_sink — raw item streams
  gr-blocks/lib/wavfile.cc, wavfile_source/sink — RIFF WAV codec
  gr-blocks file_meta_sink/source — streams with inline metadata headers
      (here: a JSON sidecar + PMT-serialized header, the checkpoint/resume
      surface of SURVEY.md §5)

Design: the host boundary moves float32 planes (complex split re/im), so
the file path is: native threaded reader (utils.native.IQFileReader — C++,
double-mapped ring buffer, format conversion off the Python thread) ->
device_put -> jitted chain. Falls back to NumPy memmap slicing when the
native library is unavailable.
"""
from __future__ import annotations

import json
import os
import wave

import numpy as np

from ..core.block import SinkBlock, SourceBlock
from ..core.stream import PortSpec, C, F, S, host_encode
from ..core import pmt as pmt_codec
from ..utils import native
from .blocks import StreamSource, VectorSink

_FMT_DTYPE = {native.IQ_CI8: np.int8, native.IQ_CI16: np.int16,
              native.IQ_CF32: np.complex64}


class FileSource(SourceBlock):
    """Stream complex64 samples from an IQ capture file.

    fmt: native.IQ_CI8 | IQ_CI16 | IQ_CF32 (interleaved). Uses the native
    prefetching reader when available; NumPy otherwise."""

    is_fed = True

    def __init__(self, path: str, fmt: int = native.IQ_CF32,
                 scale: float | None = None, repeat: bool = False, name=None):
        super().__init__(PortSpec(C), name)
        self.path, self.fmt, self.repeat = path, fmt, repeat
        if scale is None:
            scale = {native.IQ_CI8: 1 / 128.0, native.IQ_CI16: 1 / 32768.0,
                     native.IQ_CF32: 1.0}[fmt]
        self.scale = scale
        self.items_supplied = 0
        self.stream_tags = []

    def _total_items(self) -> int:
        sz = os.path.getsize(self.path)
        per = {native.IQ_CI8: 2, native.IQ_CI16: 4, native.IQ_CF32: 8}[self.fmt]
        return sz // per

    def chunks(self, n: int):
        self.items_supplied = 0
        if native.native_available() and not self.repeat:
            rdr = native.IQFileReader(self.path, self.fmt, chunk_items=n,
                                      scale=self.scale)
            total = self._total_items()
            try:
                for planes in rdr:
                    self.items_supplied = min(self.items_supplied + n, total)
                    yield planes.T  # [n, 2] re/im -> host-encode layout
            finally:
                rdr.close()
            return
        # NumPy fallback (and repeat mode)
        if self.fmt == native.IQ_CF32:
            raw = np.fromfile(self.path, np.complex64)
            data = raw * self.scale if self.scale != 1.0 else raw
        else:
            raw = np.fromfile(self.path, _FMT_DTYPE[self.fmt]).astype(np.float32)
            data = (raw[0::2] + 1j * raw[1::2]).astype(np.complex64) * self.scale
        src = StreamSource(data.astype(np.complex64), PortSpec(C), self.repeat)
        yield from src.chunks(n)
        self.items_supplied = src.items_supplied

    def apply(self, state, inputs, n_in):
        return state, (inputs[0],)


def file_source(path, fmt=native.IQ_CF32, scale=None, repeat=False):
    return FileSource(path, fmt, scale, repeat)


class FileSink(VectorSink):
    """Collects then writes on close/flush (raw native-endian items)."""

    def __init__(self, path: str, in_port: PortSpec = PortSpec(C), name=None):
        super().__init__(in_port, name)
        self.path = path

    def flush(self):
        self.data().tofile(self.path)


def file_sink(path, dtype=C):
    return FileSink(path, PortSpec(dtype))


# ---------------------------------------------------------------------------
# WAV (gr-blocks/lib/wavfile.cc analog via the stdlib codec)
# ---------------------------------------------------------------------------

class WavfileSource(StreamSource):
    """Read a WAV file as float32 in [-1, 1); N channels -> N items vlen or
    channel 0 (the reference emits one stream per channel; mono here,
    multi-channel via the `channel` arg)."""

    def __init__(self, path: str, repeat: bool = False, channel: int = 0,
                 name=None):
        with wave.open(path, "rb") as w:
            nch = w.getnchannels()
            width = w.getsampwidth()
            self.sample_rate = w.getframerate()
            raw = w.readframes(w.getnframes())
        if width == 2:
            x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif width == 1:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 128.0
        else:
            raise ValueError(f"unsupported WAV sample width {width}")
        x = x.reshape(-1, nch)[:, channel].copy()
        super().__init__(x, PortSpec(F), repeat, name)


def wavfile_source(path, repeat=False, channel=0):
    return WavfileSource(path, repeat, channel)


class WavfileSink(VectorSink):
    """Collects float samples, writes 16-bit WAV on flush."""

    def __init__(self, path: str, sample_rate: int, name=None):
        super().__init__(PortSpec(F), name)
        self.path = path
        self.sample_rate = int(sample_rate)

    def flush(self):
        x = np.clip(self.data(), -1.0, 1.0 - 1.0 / 32768)
        pcm = (x * 32768.0).astype(np.int16)
        with wave.open(self.path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(self.sample_rate)
            w.writeframes(pcm.tobytes())


def wavfile_sink(path, sample_rate):
    return WavfileSink(path, sample_rate)


# ---------------------------------------------------------------------------
# metadata files (file_meta_sink/source analog: PMT header sidecar)
# ---------------------------------------------------------------------------

def write_meta_file(path: str, samples: np.ndarray, meta: dict):
    """Raw samples + `<path>.hdr` with PMT-serialized metadata."""
    np.asarray(samples).tofile(path)
    hdr = dict(meta)
    hdr["dtype"] = str(np.asarray(samples).dtype)
    hdr["nitems"] = int(np.asarray(samples).size)
    with open(path + ".hdr", "wb") as f:
        f.write(pmt_codec.serialize(hdr))


def read_meta_file(path: str):
    with open(path + ".hdr", "rb") as f:
        meta = pmt_codec.deserialize(f.read())
    data = np.fromfile(path, np.dtype(meta["dtype"]))
    return data, meta


class FileMetaSink(VectorSink):
    """gr-blocks file_meta_sink: stream + inline PMT metadata persisted on
    flush (header sidecar form; the reference interleaves header segments,
    gr-blocks/include/gnuradio/blocks/file_meta_sink.h)."""

    def __init__(self, path: str, in_port: PortSpec = PortSpec(C),
                 samp_rate: float = 1.0, extra_meta: dict | None = None,
                 name=None):
        super().__init__(in_port, name)
        self.path = path
        self.samp_rate = float(samp_rate)
        self.extra_meta = dict(extra_meta or {})

    def flush(self):
        meta = {"rx_rate": self.samp_rate, **self.extra_meta}
        write_meta_file(self.path, self.data(), meta)


def file_meta_sink(file, type="complex", samp_rate=1.0, **_):
    from ..core.stream import dtype_of
    code = {"complex": "c", "float": "f", "int": "i", "short": "s",
            "byte": "b"}.get(str(type), "c")
    return FileMetaSink(str(file), PortSpec(dtype_of(code)), samp_rate)


class FileMetaSource(StreamSource):
    """gr-blocks file_meta_source: replays a metadata-tagged capture; the
    header's rx_rate/extra keys are exposed as .meta."""

    def __init__(self, path: str, name=None):
        data, meta = read_meta_file(str(path))
        self.meta = meta
        super().__init__(data, out_port=PortSpec(data.dtype.type), name=name)


def file_meta_source(file, **_):
    return FileMetaSource(str(file))
