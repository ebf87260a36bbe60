"""Instrumentation sinks — the gr-qtgui analog, headless.

Reference parity: gr-qtgui's time/freq/waterfall/constellation/histogram/
eye sinks (SURVEY.md §2.2). On a headless accelerator node the GUI is out of scope
(explicitly allowed by SURVEY.md App. B closing note); what matters is the
MEASUREMENT pipeline those sinks embed: windowed PSD frames, waterfall
history, constellation snapshots, histograms, eye traces. Each sink here
computes its display product ON DEVICE (batched FFTs/histograms inside the
fused step) and accumulates frames on the host — ready for any front-end
(matplotlib, web UI, or test assertions).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.block import SinkBlock
from ..core.stream import PortSpec, C, F
from .fft import window as fft_window


class FreqSink(SinkBlock):
    accept_any_msg = True   # headless GUI analog: absorb control msgs
    """freq_sink_c: per-chunk averaged windowed PSD in dB (fft_size bins,
    fftshifted, like the QT GUI frequency display)."""

    def __init__(self, fft_size: int = 1024, wintype: str = "blackman-harris",
                 name=None):
        super().__init__(PortSpec(C), name)
        self.fft_size = int(fft_size)
        self.win = np.asarray(fft_window(wintype, self.fft_size), np.float32)
        self.frames: list[np.ndarray] = []

    @property
    def tap_port(self):
        return PortSpec(F, self.fft_size)

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        nfr = x.shape[0] // self.fft_size
        fr = x[: nfr * self.fft_size].reshape(nfr, self.fft_size)
        fr = fr * jnp.asarray(self.win)
        spec = jnp.fft.fftshift(jnp.fft.fft(fr, axis=-1), axes=-1)
        psd = jnp.mean(jnp.abs(spec) ** 2, axis=0) / (self.fft_size ** 2)
        db = 10.0 * jnp.log10(jnp.maximum(psd, 1e-20))
        return state, (db[None, :],)

    def collect(self, value):
        self.frames.append(np.asarray(value)[0])

    def data(self) -> np.ndarray:
        return np.stack(self.frames) if self.frames else np.zeros((0,))

    def freq_axis(self, samp_rate: float, center: float = 0.0) -> np.ndarray:
        return center + np.fft.fftshift(
            np.fft.fftfreq(self.fft_size, 1.0 / samp_rate))


class WaterfallSink(FreqSink):
    """waterfall_sink_c: every PSD row kept (time x freq matrix)."""

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        nfr = x.shape[0] // self.fft_size
        fr = x[: nfr * self.fft_size].reshape(nfr, self.fft_size)
        fr = fr * jnp.asarray(self.win)
        spec = jnp.fft.fftshift(jnp.fft.fft(fr, axis=-1), axes=-1)
        db = 10.0 * jnp.log10(jnp.maximum(
            jnp.abs(spec) ** 2 / (self.fft_size ** 2), 1e-20))
        return state, (db,)

    def collect(self, value):
        self.frames.extend(np.asarray(value))


class ConstellationSink(SinkBlock):
    accept_any_msg = True   # headless GUI analog: absorb control msgs
    """constellation_sink: keeps the last `size` symbols per chunk."""

    def __init__(self, size: int = 1024, name=None):
        super().__init__(PortSpec(C), name)
        self.size = int(size)
        self.points = np.zeros(0, np.complex64)

    def tap(self, state, x):
        return state, x[-self.size:]

    def collect(self, value):
        self.points = np.asarray(value)


class HistogramSink(SinkBlock):
    accept_any_msg = True   # headless GUI analog: absorb control msgs
    """histogram_sink_f: running histogram over fixed bin edges (device-side
    bincount per chunk, accumulated on host)."""

    def __init__(self, bins: int = 100, lo: float = -1.0, hi: float = 1.0,
                 name=None):
        super().__init__(PortSpec(F), name)
        self.bins, self.lo, self.hi = int(bins), float(lo), float(hi)
        self.counts = np.zeros(self.bins, np.int64)

    @property
    def tap_port(self):
        return PortSpec(jnp.int32, self.bins)

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        idx = jnp.clip(((x - self.lo) / (self.hi - self.lo) * self.bins)
                       .astype(jnp.int32), 0, self.bins - 1)
        h = jnp.zeros(self.bins, jnp.int32).at[idx].add(1)
        return state, (h[None, :],)

    def collect(self, value):
        self.counts += np.asarray(value)[0].astype(np.int64)

    def edges(self) -> np.ndarray:
        return np.linspace(self.lo, self.hi, self.bins + 1)


class TimeRasterSink(SinkBlock):
    accept_any_msg = True   # headless GUI analog: absorb control msgs
    """time_raster_sink: rows of `row_len` samples (matrix display)."""

    def __init__(self, row_len: int, dtype=F, name=None):
        super().__init__(PortSpec(dtype), name)
        self.row_len = int(row_len)
        self.rows: list[np.ndarray] = []

    def collect(self, value):
        v = np.asarray(value)
        n = len(v) // self.row_len * self.row_len
        self.rows.extend(v[:n].reshape(-1, self.row_len))

    def data(self) -> np.ndarray:
        return np.stack(self.rows) if self.rows else np.zeros((0, self.row_len))


class EyeSink(TimeRasterSink):
    """eye_sink_f: overlapping traces of 2 symbol periods for eye diagrams."""

    def __init__(self, sps: int, name=None):
        super().__init__(2 * int(sps), F, name)
        self.sps = int(sps)

    def eye(self) -> np.ndarray:
        """[ntraces, 2*sps] matrix of eye traces."""
        return self.data()


class TimeSink(SinkBlock):
    accept_any_msg = True   # headless GUI analog: absorb control msgs
    """time_sink_c/f: triggered time-domain capture (qtgui_time_sink — the
    display pipeline without the GUI). Per chunk, captures the first
    `npoints` samples after the trigger condition (level crossing on the
    chosen edge), or free-runs when trigger is disabled. Frames accumulate
    on the host like the QT display's trace history."""

    def __init__(self, npoints: int = 1024, dtype=C, trigger_level=None,
                 rising: bool = True, name=None):
        super().__init__(PortSpec(dtype), name)
        self.npoints = int(npoints)
        self.trigger_level = trigger_level
        self.rising = bool(rising)
        self.frames: list[np.ndarray] = []

    @property
    def tap_port(self):
        return PortSpec(self.in_ports[0].dtype, self.npoints)

    def tap(self, state, x):
        n = x.shape[0]
        v = x.real if jnp.iscomplexobj(x) else x
        if self.trigger_level is None:
            start = jnp.zeros((), jnp.int32)
        else:
            lvl = jnp.float32(self.trigger_level)
            above = v >= lvl
            prev = jnp.concatenate([above[:1], above[:-1]])
            edge = (above & ~prev) if self.rising else (~above & prev)
            any_edge = jnp.any(edge)
            start = jnp.where(any_edge, jnp.argmax(edge), 0).astype(jnp.int32)
        start = jnp.minimum(start, jnp.int32(max(0, n - self.npoints)))
        import jax
        frame = jax.lax.dynamic_slice(x, (start,), (min(self.npoints, n),))
        if self.npoints > n:
            frame = jnp.pad(frame, (0, self.npoints - n))
        return state, frame[None]

    def collect(self, value):
        self.frames.append(np.asarray(value)[0])


def time_sink_c(npoints=1024, trigger_level=None, rising=True):
    return TimeSink(npoints, C, trigger_level, rising)


def time_sink_f(npoints=1024, trigger_level=None, rising=True):
    return TimeSink(npoints, F, trigger_level, rising)


class NumberSink(SinkBlock):
    accept_any_msg = True   # headless GUI analog: absorb control msgs
    """number_sink: running average of the most recent chunk (the QT number
    display's averaged scalar)."""

    def __init__(self, avg_alpha: float = 1.0, dtype=F, name=None):
        super().__init__(PortSpec(dtype), name)
        self.alpha = float(avg_alpha)
        self.value = 0.0

    @property
    def tap_port(self):
        return PortSpec(F)

    def tap(self, state, x):
        v = jnp.abs(x) if jnp.iscomplexobj(x) else x
        return state, jnp.mean(v.astype(jnp.float32))

    def collect(self, value):
        m = float(np.asarray(value))
        a = self.alpha
        self.value = m if self.value == 0.0 else (1 - a) * self.value + a * m


def number_sink(avg_alpha=1.0, dtype=F):
    return NumberSink(avg_alpha, dtype)


class BerSink(SinkBlock):
    accept_any_msg = True   # headless GUI analog: absorb control msgs
    """qtgui ber_sink_b analog: two byte streams (ref, rx) -> running BER.
    Device computes per-chunk (errors, bits); host accumulates totals."""

    def __init__(self, name=None):
        from ..core.block import Block
        Block.__init__(self, name)
        from ..core.stream import B as _B, I as _I
        self.in_ports = (PortSpec(_B), PortSpec(_B))
        self.out_ports = ()
        self.errors = 0
        self.bits = 0

    @property
    def tap_port(self):
        from ..core.stream import I as _I
        return PortSpec(_I, 2)

    def apply(self, state, inputs, n_in):
        a, b = inputs
        diff = (a.astype(jnp.int32) ^ b.astype(jnp.int32)) & 0xFF
        bitcount = jnp.sum(sum(((diff >> k) & 1) for k in range(8)))
        total = jnp.int32(a.shape[0] * 8)
        return state, (jnp.stack([bitcount.astype(jnp.int32), total])[None],)

    def collect(self, value):
        v = np.asarray(value).reshape(-1)
        self.errors += int(v[0])
        self.bits += int(v[1])

    def ber(self) -> float:
        return self.errors / self.bits if self.bits else 0.0


def ber_sink_b():
    return BerSink()
