"""Round-4 catalog fills: remaining gr-blocks/gr-channels/gr-digital small
blocks that had no implementation under any name.

Reference behavior (reimplemented, not copied):
  gr-blocks/lib/char_to_short_impl.cc        — out = in * 256 (volk 8i->16i)
  gr-blocks/lib/short_to_char_impl.cc        — out = in / 256
  gr-blocks/lib/float_to_uchar_impl.cc       — clip [0,255], round
  gr-blocks/lib/complex_to_float_impl.cc     — 1 or 2 float outs (re, im)
  gr-blocks/lib/complex_to_interleaved_char_impl.cc — scale, clip int8 pairs
  gr-blocks/lib/interleaved_char_to_complex_impl.cc — pairs -> complex/scale
  gr-blocks/lib/correctiq_auto_impl.cc:160-190 — learn DC for a settling
      period, then freeze the offset (tags the freeze point)
  gr-blocks/lib/correctiq_man_impl.cc        — fixed (real, imag) offset
  gr-blocks/lib/correctiq_swapiq_impl.cc     — swap I/Q
  gr-blocks/grc/blocks_freqshift_cc.block.yml — hier: multiply by
      e^{j 2 pi f t} (sig_source + multiply); one rotator here
  gr-blocks/lib/probe_rate_impl.cc           — items/s estimate with
      single-pole smoothing, posted as a 'rate' message
  gr-blocks/python/blocks/stream_to_vector_decimator.py — stream ->
      vlen vectors, keep one vector in n
  gr-blocks/lib/tagged_file_sink_impl.cc     — burst segments delimited by
      a trigger tag written to numbered files
  gr-blocks/lib/msg_meta_to_pair_impl.cc / msgpair_to_var / var_to_msg —
      message-plane adapters between dict/pair messages and variables
  gr-channels/lib/quantizer_impl.cc          — round to 2^bits levels
  gr-channels/lib/selective_fading_model2_impl.cc — selective fader whose
      tap delays random-walk (std, max deviation); delays here update per
      chunk (the walk is orders slower than a chunk)
  gr-channels/lib/conj_fs_iqcorr_impl.cc     — image rejection via a
      conjugate-path FIR: y = x + conj(x) * f
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, SinkBlock, SyncBlock
from ..core.stream import PortSpec, B, C, F, S
from ..kernels.fir_xla import fir_apply
from .blocks import Elementwise, _ew
from .channels import SelectiveFadingModel
from .iir_core import first_order_iir


# -- type converts ----------------------------------------------------------

def char_to_short(**_):
    return _ew(lambda x: (x.astype(jnp.int32) * 256).astype(S), 1, B,
               out_dtype=S)


def short_to_char(**_):
    return _ew(lambda x: (x.astype(jnp.int32) // 256).astype(B), 1, S,
               out_dtype=B)


def float_to_uchar(**_):
    # uchar rides the int8 lane (two's complement bit pattern)
    return _ew(lambda x: jnp.clip(jnp.round(x), 0, 255)
               .astype(jnp.uint8).astype(B), 1, F, out_dtype=B)


class ComplexToFloat(Block):
    """complex_to_float: out0 = re, out1 = im."""

    def __init__(self, vlen=1, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(C, vlen),)
        self.out_ports = (PortSpec(F, vlen), PortSpec(F, vlen))

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        return state, (jnp.real(x).astype(F), jnp.imag(x).astype(F))


def complex_to_float(vlen=1, **_):
    return ComplexToFloat(vlen)


class ComplexToInterleavedChar(Block):
    """complex_to_interleaved_char (scale, clip int8, 2 chars/sample)."""

    def __init__(self, scale_factor: float = 1.0, name=None):
        super().__init__(name)
        self.scale = float(scale_factor)
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(B),)

    @property
    def in_rates(self):
        from fractions import Fraction
        return (Fraction(1),)

    @property
    def out_rates(self):
        from fractions import Fraction
        return (Fraction(2),)

    def apply(self, state, inputs, n_in):
        x = inputs[0] * self.scale
        y = jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1).reshape(-1)
        return state, (jnp.clip(jnp.round(y), -128, 127).astype(B),)


def complex_to_interleaved_char(scale_factor=1.0, **_):
    return ComplexToInterleavedChar(scale_factor)


class InterleavedCharToComplex(Block):
    """interleaved_char_to_complex (pairs -> complex, 1/scale)."""

    def __init__(self, scale_factor: float = 1.0, name=None):
        super().__init__(name)
        self.scale = float(scale_factor)
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(C),)

    @property
    def in_rates(self):
        from fractions import Fraction
        return (Fraction(2),)

    @property
    def out_rates(self):
        from fractions import Fraction
        return (Fraction(1),)

    def apply(self, state, inputs, n_in):
        x = inputs[0].astype(F).reshape(-1, 2) * (1.0 / self.scale)
        return state, (jax.lax.complex(x[:, 0], x[:, 1]),)


def interleaved_char_to_complex(scale_factor=1.0, **_):
    return InterleavedCharToComplex(scale_factor)


# -- correctiq family -------------------------------------------------------

def swapiq(**_):
    """correctiq_swapiq: exchange I and Q."""
    return _ew(lambda x: jax.lax.complex(jnp.imag(x), jnp.real(x)), 1, C)


class CorrectIQMan(SyncBlock):
    """correctiq_man: subtract a fixed complex offset."""

    def __init__(self, real: float = 0.0, imag: float = 0.0, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.off = complex(real, imag)

    def work(self, state, x):
        return state, (x - jnp.complex64(self.off)).astype(C)


def correctiq_man(real=0.0, imag=0.0, **_):
    return CorrectIQMan(real, imag)


class CorrectIQAuto(SyncBlock):
    """correctiq_auto (correctiq_auto_impl.cc:160-190): track the DC
    offset with a single-pole IIR for `settling` samples, then FREEZE the
    learned offset and subtract it from then on."""

    def __init__(self, samp_rate: float = 1e6, freq: float = 0.0,
                 gain: float = 0.0, sync_window: float = 2.0, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.rate = 1e-4
        self.settling = int(max(1.0, float(sync_window)) * samp_rate / 1e3)

    def init_state(self):
        return {"dc": jnp.zeros((), jnp.complex64),
                "n": jnp.zeros((), jnp.int32)}

    def work(self, state, x):
        dc_trace, dc_last = first_order_iir(x, self.rate, 1.0 - self.rate,
                                            state["dc"])
        # before the freeze point: subtract the running tracker; after:
        # subtract the frozen value (per-sample select, traced)
        idx = state["n"] + jnp.arange(x.shape[0])
        live = idx < self.settling
        frozen = jnp.where(state["n"] >= self.settling, state["dc"],
                           dc_trace[-1] if x.shape[0] else state["dc"])
        y = x - jnp.where(live, dc_trace, frozen)
        new_dc = jnp.where(state["n"] >= self.settling, state["dc"], dc_last)
        return ({"dc": new_dc, "n": state["n"] + x.shape[0]}, y.astype(C))


def correctiq_auto(samp_rate=1e6, freq=0.0, gain=0.0, sync_window=2.0, **_):
    return CorrectIQAuto(samp_rate, freq, gain, sync_window)


def freqshift_cc(samp_rate=1e6, freq_shift=0.0, sample_rate=None,
                 shift=None, **_):
    """blocks_freqshift_cc hier (sig_source * input) as one rotator."""
    from .blocks_extra import rotator_cc
    fs = float(sample_rate if sample_rate is not None else samp_rate)
    f = float(shift if shift is not None else freq_shift)
    return rotator_cc(2 * math.pi * f / fs)


# -- probes / stream shape --------------------------------------------------

class ProbeRate(SinkBlock):
    """probe_rate: items/s estimate, single-pole smoothed, posted on the
    'rate' message port each step (the compiled-graph step is the clock,
    like MessageStrobe)."""

    def __init__(self, itemsize=None, mintime: float = 500.0,
                 alpha: float = 0.0001, name=None):
        super().__init__(PortSpec(C), name)
        self.alpha = float(alpha)
        self.avg = 0.0
        self.last_count = 0
        self.message_port_register_out("rate")

    def collect(self, value):
        n = np.asarray(value).shape[0]
        self.last_count = n
        self.avg = (1 - self.alpha) * self.avg + self.alpha * n
        self.post("rate", {"rate_now": float(n), "rate_avg": self.avg})


def probe_rate(mintime=500.0, alpha=0.0001, **_):
    return ProbeRate(None, mintime, alpha)


class StreamToVectorDecimator(Block):
    """stream_to_vector_decimator.py: stream -> vlen vectors, keep one
    vector in n."""

    def __init__(self, vlen: int, factor: int, dtype=C, name=None):
        super().__init__(name)
        self.vlen = int(vlen)
        self.factor = max(1, int(factor))
        self.in_ports = (PortSpec(dtype, 1),)
        self.out_ports = (PortSpec(dtype, self.vlen),)

    @property
    def in_rates(self):
        from fractions import Fraction
        return (Fraction(self.vlen * self.factor),)

    @property
    def out_rates(self):
        from fractions import Fraction
        return (Fraction(1),)

    def apply(self, state, inputs, n_in):
        v = inputs[0].reshape(-1, self.factor, self.vlen)
        return state, (v[:, -1, :],)


def stream_to_vector_decimator(num_items=1024, vlen=None, vec_rate=None,
                               samp_rate=None, factor=1, dtype=C, **_):
    n = int(vlen or num_items)
    f = int(factor)
    if vec_rate and samp_rate:
        f = max(1, int(round(float(samp_rate) / (float(vec_rate) * n))))
    return StreamToVectorDecimator(n, f, dtype)


class TaggedFileSink(SinkBlock):
    """tagged_file_sink: write burst segments (samples where the trigger
    tag's value is true .. false) to numbered files."""

    def __init__(self, path_prefix: str = "burst", tag_key: str = "burst",
                 in_port: PortSpec = PortSpec(C), name=None):
        super().__init__(in_port, name)
        self.prefix = str(path_prefix)
        self.key = str(tag_key)
        self._open = None
        self._count = 0
        self._chunks: list = []
        self._offset = 0
        self._tags: list = []

    def collect_tags(self, tags):
        self._tags.extend(tags)

    def collect(self, value):
        arr = np.asarray(value)
        start, end = self._offset, self._offset + arr.shape[0]
        events = sorted((t.offset, bool(t.value))
                        for t in self._tags
                        if t.key == self.key and start <= t.offset < end)
        pos = start
        for off, val in events:
            if self._open is not None:
                self._chunks.append(arr[pos - start: off - start])
            if val and self._open is None:
                self._open = off
                pos = off
            elif not val and self._open is not None:
                data = np.concatenate([c for c in self._chunks if len(c)]
                                      or [arr[:0]])
                data.tofile(f"{self.prefix}_{self._count}.dat")
                self._count += 1
                self._open = None
                self._chunks = []
        if self._open is not None:
            self._chunks.append(arr[max(pos, self._open) - start:])
        self._tags = [t for t in self._tags if t.offset >= end]
        self._offset = end


def tagged_file_sink(file=None, tag="burst", type=C, **_):
    return TaggedFileSink(str(file or "burst"), tag)


# -- message-plane adapters -------------------------------------------------

class MsgMetaToPair(Block):
    """msg_meta_to_pair: extract `key` from a dict message, emit (key, val)
    pairs."""

    def __init__(self, key: str = "freq", name=None):
        super().__init__(name)
        self.key = str(key)
        self.message_port_register_in("inmeta", self._on)
        self.message_port_register_out("msgout")

    def _on(self, msg):
        if isinstance(msg, dict) and self.key in msg:
            self.post("msgout", (self.key, msg[self.key]))


def msg_meta_to_pair(key="freq", **_):
    return MsgMetaToPair(key)


class MsgPairToVar(Block):
    """msgpair_to_var: store the value half of (key, value) messages;
    read via .value (the GRC callback seam)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = None
        self.message_port_register_in("inpair", self._on)

    def _on(self, msg):
        if isinstance(msg, (tuple, list)) and len(msg) == 2:
            self.value = msg[1]


def msgpair_to_var(**_):
    return MsgPairToVar()


class VarToMsg(Block):
    """var_to_msg: post (name, value) when poked via variable_changed()."""

    def __init__(self, target: str = "value", name=None):
        super().__init__(name)
        self.target = str(target)
        self.message_port_register_out("msgout")

    def variable_changed(self, value):
        self.post("msgout", (self.target, value))


def var_to_msg(target="value", **_):
    return VarToMsg(target)


# -- gr-channels fills ------------------------------------------------------

def quantizer(bits: int = 16, **_):
    """channels_quantizer: round to 2^(bits-1) levels."""
    lv = float(1 << (int(bits) - 1))
    return _ew(lambda x: jnp.round(x * lv) / lv, 1, F)


class ConjFsIQCorr(SyncBlock):
    """conj_fs_iqcorr: image rejection via the conjugate-path FIR
    y = x + conj(x) * f (taps supplied, as in the reference's manual
    configuration path)."""

    def __init__(self, delay: int = 0, taps=(0.0,), name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.delay = int(delay)
        self.taps = np.asarray(taps, np.complex64)

    def init_state(self):
        return {"tail": jnp.zeros((len(self.taps) - 1 + self.delay,), C)}

    def work(self, state, x):
        h = len(self.taps) - 1 + self.delay
        xp = jnp.concatenate([state["tail"], x])
        tail = xp[xp.shape[0] - h:] if h else state["tail"]
        cx = jnp.conj(xp)
        # complex taps as two real-tap passes (fir_apply taps are per-plane)
        corr = (fir_apply(cx, jnp.asarray(self.taps.real.copy()), 1)
                + 1j * fir_apply(cx, jnp.asarray(self.taps.imag.copy()), 1))
        # conj path delayed by `delay` samples relative to the direct path
        n = x.shape[0]
        end = corr.shape[0] - self.delay
        y = x + corr[end - n: end]
        return {"tail": tail}, y.astype(C)


def conj_fs_iqcorr(delay=0, taps=(0.0,), **_):
    return ConjFsIQCorr(delay, taps)


class SelectiveFadingModel2(SelectiveFadingModel):
    """selective_fading_model2: tap delays random-walk with std
    `delay_std` per sample, clipped to +-`delay_maxdev` around the
    nominal delays. The walk is re-sampled once per CHUNK (it is orders of
    magnitude slower than a chunk — the same granularity argument the
    reference uses for its spline-interpolated taps)."""

    def __init__(self, N=8, fDTs=0.01, LOS=False, K=4.0, seed=0,
                 delays=(0.0, 1.0, 2.0), delay_std=1e-4, delay_maxdev=0.5,
                 mags=(1.0, 0.5, 0.25), ntaps=8, name=None):
        super().__init__(N, fDTs, LOS, K, seed, delays, mags,
                         int(max(ntaps, int(np.ceil(max(delays)
                                                    + delay_maxdev)) + 2)),
                         name)
        self.delay_std = float(delay_std)
        self.delay_maxdev = float(delay_maxdev)
        self._rng = np.random.default_rng(seed + 99)
        self._walk = np.zeros(len(delays))

    def work(self, state, x):
        n = x.shape[0]
        # advance each tap's random walk by this chunk's duration
        step_std = self.delay_std * math.sqrt(max(n, 1))
        self._walk = np.clip(
            self._walk + self._rng.normal(0.0, step_std, len(self._walk)),
            -self.delay_maxdev, self.delay_maxdev)
        xp = jnp.concatenate([state["tail"], x], axis=0)
        tail = xp[xp.shape[0] - (self.ntaps - 1):]
        y = jnp.zeros(n, C)
        for k, fader in enumerate(self.faders):
            h = fader.gains(state["t"], n) * self.mags[k]
            d = float(self.delays[k] + self._walk[k])
            taps = np.sinc(np.arange(self.ntaps) - d).astype(np.float32)
            path = fir_apply(xp, jnp.asarray(taps[::-1].copy()), 1)
            y = y + path * h
        return {"t": state["t"] + n, "tail": tail}, y.astype(C)


def selective_fading_model2(N=8, fDTs=0.01, LOS=False, K=4.0, seed=0,
                            delays=(0.0, 1.0, 2.0), delay_std=1e-4,
                            delay_maxdev=0.5, mags=(1.0, 0.5, 0.25),
                            ntaps=8, **_):
    return SelectiveFadingModel2(N, fDTs, LOS, K, seed, delays, delay_std,
                                 delay_maxdev, mags, ntaps)


# -- fec_ber_bf -------------------------------------------------------------

class BerBf(Block):
    """fec_ber_bf (gr-fec/lib/ber_bf_impl.cc): two byte streams in, running
    log10(BER) out — one float per `berminerrors`-ish window; here one
    float per chunk (test_mode=False running form), counting bit errors
    between the packed byte streams."""

    def __init__(self, test_mode=False, berminerrors=100, ber_limit=-7.0,
                 name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(B), PortSpec(B))
        self.out_ports = (PortSpec(F),)
        self.ber_limit = float(ber_limit)

    @property
    def in_rates(self):
        from fractions import Fraction
        return (Fraction(1), Fraction(1))

    @property
    def out_rates(self):
        from fractions import Fraction
        return (Fraction(1),)

    def init_state(self):
        return {"errs": jnp.zeros((), jnp.float32),
                "bits": jnp.zeros((), jnp.float32)}

    def apply(self, state, inputs, n_in):
        a = inputs[0].astype(jnp.int32) & 0xFF
        b = inputs[1].astype(jnp.int32) & 0xFF
        x = a ^ b
        # popcount via 8 shifts (elementwise)
        cnt = sum(((x >> k) & 1) for k in range(8)).astype(jnp.float32)
        errs = state["errs"] + jnp.sum(cnt)
        bits = state["bits"] + jnp.float32(8.0) * a.shape[0]
        ber = jnp.log10(jnp.maximum(errs, 10.0 ** self.ber_limit) / bits)
        out = jnp.broadcast_to(ber, (a.shape[0],)).astype(jnp.float32)
        return {"errs": errs, "bits": bits}, (out,)


def ber_bf(test_mode=False, berminerrors=100, ber_limit=-7.0, **_):
    return BerBf(test_mode, berminerrors, ber_limit)


# -- digital_crc32_async_bb -------------------------------------------------

class Crc32AsyncBb(Block):
    """crc32_async_bb (gr-digital/lib/crc32_async_bb_impl.cc): PDU in ->
    PDU out with CRC32 appended (check=False) or verified+stripped
    (check=True; failing PDUs are dropped)."""

    def __init__(self, check: bool = False, name=None):
        super().__init__(name)
        self.check = bool(check)
        self.message_port_register_in("in", self._on)
        self.message_port_register_out("out")

    def _on(self, msg):
        import zlib
        meta, data = msg if isinstance(msg, tuple) else ({}, msg)
        by = np.asarray(data).astype(np.uint8)
        if not self.check:
            crc = zlib.crc32(by.tobytes()) & 0xFFFFFFFF
            out = np.concatenate([by, np.frombuffer(
                crc.to_bytes(4, "little"), np.uint8)])
            self.post("out", (meta, out))
        else:
            if len(by) < 4:
                return
            want = int.from_bytes(by[-4:].tobytes(), "little")
            if (zlib.crc32(by[:-4].tobytes()) & 0xFFFFFFFF) == want:
                self.post("out", (meta, by[:-4]))


def crc32_async_bb(check=False, **_):
    return Crc32AsyncBb(check)


# -- qtgui_edit_box_msg (headless control stub) -----------------------------

class EditBoxMsg(Block):
    """qtgui_edit_box_msg headless analog: a GUI text control that emits
    (key, value) messages on user edit. Headless there are no edits; the
    'val' input port still accepts and re-publishes values so msg wiring
    through it stays intact (set_value() is the programmatic poke)."""

    def __init__(self, value=None, key: str = "value", name=None):
        super().__init__(name)
        self.key = str(key)
        self.value = value
        self.message_port_register_in("val", self._on)
        self.message_port_register_out("msg")

    def _on(self, msg):
        self.value = msg[1] if isinstance(msg, (tuple, list)) else msg
        self.post("msg", (self.key, self.value))

    def set_value(self, v):
        self._on((self.key, v))


def edit_box_msg(value=None, key="value", **_):
    return EditBoxMsg(value, key)


class ControlMsgStub(Block):
    """Headless analog of the qtgui value-control widgets
    (digitalnumcontrol / dialcontrol / levelgauge...): 'valuein' messages
    update the held value and re-emit on 'valueout'; the initial value is
    posted once at start (msg_work tick 0) like the widgets' initial
    notification."""

    def __init__(self, value=0, name=None):
        super().__init__(name)
        self.value = value
        self.message_port_register_in("valuein", self._on)
        self.message_port_register_out("valueout")
        self._posted = False

    def _on(self, msg):
        self.value = msg[1] if isinstance(msg, (tuple, list)) else msg
        self.post("valueout", self.value)

    def msg_work(self, step):
        if not self._posted:
            self._posted = True
            self.post("valueout", self.value)


def qtgui_digitalnumbercontrol(value=0, **_):
    return ControlMsgStub(value)


def qtgui_dialcontrol(value=0, **_):
    return ControlMsgStub(value)
