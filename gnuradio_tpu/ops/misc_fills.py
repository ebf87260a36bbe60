"""Catalog completion sweep: nop, file-descriptor I/O, taps loaders, TCP
server sink, tuntap PDU seam, channel_model2/dynamic_channel_model, CCSDS-27
codec, FECAPI dummy code, LDPC G-matrix encoder, conv_bit_corr, maxstar,
MMSE interpolator/differentiator tap designers, GFSK mod/demod, number sink,
edit_box_msg, ctrlport probes, perf monitor.

Reference parity pointers:
  nop                      gr-blocks/lib/nop_impl.cc
  file_descriptor_source/sink  gr-blocks/lib/file_descriptor_{source,sink}_impl.cc
  file_taps_loader         gr-filter/python/filter/file_taps_loader.py
  tcp_server_sink          gr-blocks/lib/tcp_server_sink_impl.cc
  tuntap_pdu               gr-blocks/lib/tuntap_pdu_impl.cc (Linux TAP)
  channel_model2           gr-channels/lib/channel_model2_impl.cc (time-
                           varying freq offset/timing as streams)
  dynamic_channel_model    gr-channels/lib/dynamic_channel_model_impl.cc
  encode/decode_ccsds_27   gr-fec/lib/{encode,decode}_ccsds_27_{bb,fb}_impl.cc
                           (k=7 rate-1/2, polys 0o171/0o133)
  dummy encoder/decoder    gr-fec/lib/dummy_{encoder,decoder}_impl.cc
  ldpc_gen_mtrx_encoder    gr-fec/lib/ldpc_gen_mtrx_encoder_impl.cc
  conv_bit_corr_bb         gr-fec/lib/conv_bit_corr_bb_impl.cc
  maxstar                  gr-fec/lib/maxstar.h
  interpolator_taps        gr-filter/lib/interpolator_taps.h (8-tap MMSE),
                           interp_differentiator_taps.h — regenerated here by
                           least-squares instead of shipping the table
  gfsk                     gr-digital/python/digital/gfsk.py
  number_sink              gr-qtgui/lib/number_sink_impl.cc
  edit_box_msg             gr-qtgui/lib/edit_box_msg_impl.cc
  ctrlport_probe2_*        gr-blocks/lib/ctrlport_probe2_*_impl.cc
  perf monitor             gr-perf-monitorx (ctrlport client)
"""
from __future__ import annotations

import os
import socket as _socket
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..core import pmt
from ..core.block import Block, SinkBlock, SourceBlock, SyncBlock
from ..core.stream import PortSpec, B, S, I, F, C, host_encode
from .blocks import StreamSource, VectorSink


# ---------------------------------------------------------------------------
# trivial / IO blocks
# ---------------------------------------------------------------------------

class Nop(SyncBlock):
    """gr::blocks::nop — does nothing, counts nothing, costs nothing (XLA
    folds it away entirely)."""

    def __init__(self, dtype=C, name=None):
        super().__init__(PortSpec(dtype), PortSpec(dtype), name)

    def work(self, state, x):
        return state, x


def nop(dtype=C):
    return Nop(dtype)


def file_descriptor_source(fd: int, dtype=C, repeat=False):
    """file_descriptor_source: read everything from an open fd and stream it
    (the reference streams incrementally; host-fed chunking gives the same
    boundary semantics)."""
    chunks = []
    while True:
        buf = os.read(fd, 1 << 20)
        if not buf:
            break
        chunks.append(buf)
    raw = b"".join(chunks)
    data = np.frombuffer(raw, dtype=np.dtype(dtype))
    return StreamSource(data, PortSpec(dtype), repeat=repeat)


class FileDescriptorSink(VectorSink):
    """file_descriptor_sink: write items to an open fd as they arrive."""

    def __init__(self, fd: int, dtype=C, name=None):
        super().__init__(PortSpec(dtype), name)
        self.fd = fd

    def collect(self, value):
        os.write(self.fd, np.ascontiguousarray(value).tobytes())


def file_descriptor_sink(fd, dtype=C):
    return FileDescriptorSink(fd, dtype)


def file_taps_loader(path: str) -> np.ndarray:
    """file_taps_loader: read taps from a text/CSV file (one float per line
    or comma-separated), complex pairs as 'a+bj' or 'a,b' per line if the
    header says complex."""
    txt = open(path).read().strip()
    toks = [t for t in txt.replace("\n", ",").split(",") if t.strip()]
    try:
        return np.array([float(t) for t in toks], dtype=np.float32)
    except ValueError:
        return np.array([complex(t.replace(" ", "")) for t in toks],
                        dtype=np.complex64)


class TcpServerSink(SinkBlock):
    """tcp_server_sink: listen; stream raw items to every connected client
    (gr-blocks/lib/tcp_server_sink_impl.cc). Host plane only."""

    def __init__(self, host="127.0.0.1", port=0, dtype=C, name=None):
        super().__init__(PortSpec(dtype), name)
        self._srv = _socket.socket()
        self._srv.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self.port = self._srv.getsockname()[1]
        self._clients: list = []
        self._lock = threading.Lock()
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()

    def _accept_loop(self):
        self._srv.settimeout(0.2)
        while True:
            try:
                conn, _ = self._srv.accept()
            except _socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                self._clients.append(conn)

    def collect(self, value):
        raw = np.ascontiguousarray(value).tobytes()
        with self._lock:
            alive = []
            for c in self._clients:
                try:
                    c.sendall(raw)
                    alive.append(c)
                except OSError:
                    c.close()
            self._clients = alive

    def trim(self, n):
        pass

    def close(self):
        self._srv.close()
        with self._lock:
            for c in self._clients:
                c.close()


def tcp_server_sink(host="127.0.0.1", port=0, dtype=C):
    return TcpServerSink(host, port, dtype)


class TuntapPdu(Block):
    """tuntap_pdu: PDUs <-> a Linux TAP device. Requires /dev/net/tun and
    CAP_NET_ADMIN; raises at construction when unavailable (same as the
    reference, which is compiled out on non-Linux)."""

    TUNSETIFF = 0x400454CA
    IFF_TAP, IFF_NO_PI = 0x0002, 0x1000

    def __init__(self, ifname: str = "tap0", mtu: int = 1500, name=None):
        super().__init__(name)
        import fcntl
        import struct
        if not os.path.exists("/dev/net/tun"):
            raise RuntimeError("tuntap_pdu: /dev/net/tun not available")
        self.fd = os.open("/dev/net/tun", os.O_RDWR)
        ifr = struct.pack("16sH22s", ifname.encode(),
                          self.IFF_TAP | self.IFF_NO_PI, b"")
        fcntl.ioctl(self.fd, self.TUNSETIFF, ifr)
        self.mtu = mtu
        self.message_port_register_in("pdus", self._send)
        self.message_port_register_out("pdus")

    def _send(self, msg):
        _meta, data = msg
        os.write(self.fd, np.asarray(data, np.uint8).tobytes())

    def msg_work(self, step_index):
        import select
        while select.select([self.fd], [], [], 0)[0]:
            frame = os.read(self.fd, self.mtu + 18)
            self.post("pdus", pmt.make_pdu(
                {}, np.frombuffer(frame, np.uint8)))


def tuntap_pdu(ifname="tap0", mtu=1500):
    return TuntapPdu(ifname, mtu)


# ---------------------------------------------------------------------------
# channels: channel_model2 / dynamic_channel_model
# ---------------------------------------------------------------------------

_DELAY_HIST = 32  # fractional-delay window (samples); bounds total SRO drift


def _frac_delay(hist, x, delay_path):
    """Time-varying fractional delay with carried history: y[n] =
    interp(x, n - delay_path[n]), delay in [0, _DELAY_HIST-2]. The static-
    shape stand-in for the reference's mmse_resampler timing path: within
    the bounded window it is a true per-sample resampler (linear interp);
    accumulated drift beyond the window saturates (documented limitation —
    a variable-rate output count is impossible under static shapes).
    Returns (y, new_hist)."""
    H = _DELAY_HIST
    n = x.shape[0]
    xp = jnp.concatenate([hist, x])
    d = jnp.clip(delay_path, 0.0, float(H - 2))
    pos = jnp.arange(n, dtype=jnp.float32) + H - d
    i0 = jnp.floor(pos).astype(jnp.int32)
    mu = (pos - i0.astype(jnp.float32)).astype(xp.dtype)
    y = xp[i0] * (1 - mu) + xp[jnp.minimum(i0 + 1, xp.shape[0] - 1)] * mu
    return y, xp[xp.shape[0] - H:]


class ChannelModel2(Block):
    """channel_model2: like channel_model but frequency offset and timing
    epsilon arrive as STREAMS (ports 1/2), so impairments vary per sample
    (gr-channels/lib/channel_model2_impl.cc: port 2 feeds an
    mmse_resampler_cc ratio input; port 1 integrates into a mixer phase).
    Here the timing stream drives a bounded fractional-delay resampler
    (delay walk D[n] += eps[n]-1, see _frac_delay) and phase integrates the
    per-sample frequency-offset stream. The timing path has a fixed group
    delay of `timing_delay` samples (the center of the delay window), the
    analog of the reference resampler's interpolator latency."""

    timing_delay = _DELAY_HIST // 2

    def __init__(self, noise_voltage=0.0, taps=(1.0,), seed=0, name=None):
        super().__init__(name)
        self.nv = float(noise_voltage)
        self.taps = np.asarray(taps, np.complex64)
        self.seed = int(seed)
        self.in_ports = (PortSpec(C), PortSpec(F), PortSpec(F))
        self.out_ports = (PortSpec(C),)

    def init_state(self):
        return {"phase": jnp.zeros((), jnp.float32),
                "tail": jnp.zeros(len(self.taps) - 1, jnp.complex64),
                "dhist": jnp.zeros(_DELAY_HIST, jnp.complex64),
                "delay": jnp.full((), _DELAY_HIST / 2.0, jnp.float32),
                "key": jax.random.PRNGKey(self.seed)}

    def apply(self, state, inputs, n_in):
        x, foff, eps = inputs
        n = x.shape[0]
        # timing: eps is the per-sample resample ratio (nominally 1.0);
        # deviation integrates into a wandering fractional delay
        dpath = state["delay"] + jnp.cumsum(eps - 1.0)
        x, dhist = _frac_delay(state["dhist"], x, dpath)
        new_delay = jnp.clip(dpath[-1], 0.0, float(_DELAY_HIST - 2))
        # multipath FIR
        if len(self.taps) > 1:
            xp = jnp.concatenate([state["tail"], x])
            tail = xp[n:]
            idx = jnp.arange(n)[:, None] + jnp.arange(len(self.taps))[None, :]
            y = xp[idx] @ jnp.asarray(self.taps[::-1])
        else:
            y = x * self.taps[0]
            tail = state["tail"]
        # per-sample frequency offset: integrate normalized freq (cycles/sample)
        phase = state["phase"] + 2 * jnp.pi * jnp.cumsum(foff)
        y = y * jnp.exp(1j * phase)
        new_phase = jnp.mod(phase[-1], 2 * jnp.pi)
        key, sub = jax.random.split(state["key"])
        if self.nv > 0:
            nr = jax.random.normal(sub, (n, 2), jnp.float32) * self.nv
            y = y + jax.lax.complex(nr[:, 0], nr[:, 1])
        return ({"phase": new_phase, "tail": tail, "dhist": dhist,
                 "delay": new_delay, "key": key}, (y,))


def channel_model2(noise_voltage=0.0, taps=(1.0,), seed=0):
    return ChannelModel2(noise_voltage, taps, seed)


class DynamicChannelModel(SyncBlock):
    """dynamic_channel_model: slowly-wandering CFO + SRO + AWGN + flat
    fading, each impairment a bounded random walk
    (gr-channels/lib/dynamic_channel_model_impl.cc composes sro_model,
    cfo_model, fading, noise — here fused into one jitted recurrence)."""

    def __init__(self, samp_rate: float, sro_std_dev=0.0, sro_max_dev=0.0,
                 cfo_std_dev=0.0, cfo_max_dev=0.0, noise_amp=0.0,
                 seed=0, name=None):
        super().__init__(PortSpec(C), PortSpec(C), name)
        self.fs = float(samp_rate)
        self.sro_std = float(sro_std_dev) / self.fs   # rate dev walk, per sample
        self.sro_max = float(sro_max_dev) / self.fs
        self.cfo_std = float(cfo_std_dev) / self.fs
        self.cfo_max = float(cfo_max_dev) / self.fs
        self.noise_amp = float(noise_amp)
        self.seed = int(seed)

    def init_state(self):
        return {"phase": jnp.zeros((), jnp.float32),
                "cfo": jnp.zeros((), jnp.float32),
                "sro": jnp.zeros((), jnp.float32),
                "dhist": jnp.zeros(_DELAY_HIST, jnp.complex64),
                "delay": jnp.full((), _DELAY_HIST / 2.0, jnp.float32),
                "key": jax.random.PRNGKey(self.seed)}

    def work(self, state, x):
        n = x.shape[0]
        key, k1, k2, k3 = jax.random.split(state["key"], 4)
        # SRO random walk (normalized rate deviation, samples/sample),
        # integrated into a bounded fractional delay (sro_model analog)
        sro = state["sro"]
        delay = state["delay"]
        dhist = state["dhist"]
        if self.sro_std > 0 or self.sro_max > 0:
            ssteps = jax.random.normal(k3, (n,), jnp.float32) * self.sro_std
            sro_path = state["sro"] + jnp.cumsum(ssteps)
            if self.sro_max > 0:
                sro_path = jnp.clip(sro_path, -self.sro_max, self.sro_max)
            dpath = state["delay"] + jnp.cumsum(sro_path)
            x, dhist = _frac_delay(state["dhist"], x, dpath)
            sro = sro_path[-1]
            delay = jnp.clip(dpath[-1], 0.0, float(_DELAY_HIST - 2))
        # CFO random walk, clipped to max deviation (normalized cycles/sample)
        steps = jax.random.normal(k1, (n,), jnp.float32) * self.cfo_std
        cfo_path = jnp.clip(state["cfo"] + jnp.cumsum(steps),
                            -self.cfo_max, self.cfo_max) \
            if self.cfo_max > 0 else state["cfo"] + jnp.cumsum(steps)
        phase = state["phase"] + 2 * jnp.pi * jnp.cumsum(cfo_path)
        y = x * jnp.exp(1j * phase)
        if self.noise_amp > 0:
            nr = jax.random.normal(k2, (n, 2), jnp.float32) * self.noise_amp
            y = y + jax.lax.complex(nr[:, 0], nr[:, 1])
        return ({"phase": jnp.mod(phase[-1], 2 * jnp.pi),
                 "cfo": cfo_path[-1], "sro": sro, "delay": delay,
                 "dhist": dhist, "key": key}, y)


def dynamic_channel_model(samp_rate, sro_std_dev=0.0, sro_max_dev=0.0,
                          cfo_std_dev=0.0, cfo_max_dev=0.0, noise_amp=0.0,
                          seed=0):
    return DynamicChannelModel(samp_rate, sro_std_dev, sro_max_dev,
                               cfo_std_dev, cfo_max_dev, noise_amp, seed)


# ---------------------------------------------------------------------------
# FEC fills: CCSDS 27, dummy code, LDPC G-matrix encoder, maxstar
# ---------------------------------------------------------------------------

CCSDS_POLYS = (0o171, 0o133)  # k=7 NASA-DSN / CCSDS standard


def encode_ccsds_27(bits):
    """encode_ccsds_27_bb: k=7 rate-1/2 convolutional encode (unpacked bits
    in, 2 bits out per input bit)."""
    from .fec import cc_encode
    return cc_encode(np.asarray(bits), 7, 2, CCSDS_POLYS)


def decode_ccsds_27(soft, frame_size: int):
    """decode_ccsds_27_fb: soft floats (+1 = 0-bit, -1 = 1-bit) -> decoded
    bits via Viterbi; streaming (unterminated) trellis, matching
    encode_ccsds_27's framing."""
    from .fec import cc_decode, CC_STREAMING
    return cc_decode(np.asarray(soft, np.float32), frame_size, 7, 2,
                     CCSDS_POLYS, mode=CC_STREAMING)


class DummyEncoder:
    """fec dummy code: identity FECAPI kernel (gr-fec dummy_encoder)."""

    def __init__(self, frame_size: int):
        self.frame_size = int(frame_size)

    def rate(self):
        return 1.0

    def encode(self, bits):
        return np.asarray(bits).copy()


class DummyDecoder:
    def __init__(self, frame_size: int):
        self.frame_size = int(frame_size)

    def rate(self):
        return 1.0

    def decode(self, soft):
        return (np.asarray(soft) < 0).astype(np.uint8)


def ldpc_gen_mtrx_encode(G: np.ndarray, info_bits):
    """ldpc_gen_mtrx_encoder: codeword = info @ G mod 2. On device this is ONE
    int matmul (the reference does bit-serial GF(2) row ops —
    gr-fec/lib/ldpc_G_matrix_impl.cc); batches of frames vmap for free."""
    G = jnp.asarray(np.asarray(G, np.int32))
    s = jnp.asarray(np.asarray(info_bits, np.int32))
    return (s @ G) % 2


def maxstar(a, b):
    """max*(a,b) = max(a,b) + log(1 + e^-|a-b|) (gr-fec/lib/maxstar.h),
    the exact log-domain combine used by TPC/turbo decoders."""
    return jnp.maximum(a, b) + jnp.log1p(jnp.exp(-jnp.abs(a - b)))


class ConvBitCorr(SinkBlock):
    """conv_bit_corr_bb: correlate a bit stream against candidate tap
    sequences to find encoder alignment (gr-fec/lib/conv_bit_corr_bb_impl.cc
    — used by the CCSDS chain for symbol-phase ambiguity). Host-plane:
    collects bits, `best_alignment()` scores each lag."""

    def __init__(self, taplist, corr_len: int, name=None):
        super().__init__(PortSpec(B), name)
        self.taps = [np.asarray(t, np.uint8) & 1 for t in taplist]
        self.corr_len = int(corr_len)
        self._bits: list = []

    def collect(self, value):
        self._bits.append(np.asarray(value, np.uint8) & 1)

    def trim(self, n):
        pass

    def best_alignment(self):
        bits = np.concatenate(self._bits) if self._bits else np.zeros(0)
        best = (0, -1)
        for lag, t in enumerate(self.taps):
            L = min(self.corr_len, len(bits), len(t))
            if L == 0:
                continue
            score = int((bits[:L] == t[:L]).sum())
            if score > best[1]:
                best = (lag, score)
        return best[0]


# ---------------------------------------------------------------------------
# MMSE interpolator / differentiator tap design
# ---------------------------------------------------------------------------

def design_mmse_interp_taps(ntaps: int = 8, nsteps: int = 128,
                            bw: float = 0.25) -> np.ndarray:
    """Regenerate the reference's 8-tap MMSE fractional-delay table
    (gr-filter/lib/interpolator_taps.h) by least-squares fit of a
    band-limited sinc: taps[step] interpolates at mu = step/nsteps between
    samples ntaps/2-1 and ntaps/2. Returns (nsteps+1, ntaps) float32."""
    half = ntaps // 2
    n = np.arange(ntaps)
    # minimize integral over |f|<bw of |sum_k h_k e^{-j2pi f (k-(half-1+mu))}|^2
    # -> solve windowed-sinc least squares on a fine frequency grid
    f = np.linspace(-bw, bw, 501)
    E = np.exp(-2j * np.pi * np.outer(f, n))       # (F, ntaps)
    out = np.zeros((nsteps + 1, ntaps))
    A = np.vstack([E.real, E.imag])
    for s in range(nsteps + 1):
        mu = s / nsteps
        d = np.exp(-2j * np.pi * f * (half - 1 + mu))
        b = np.concatenate([d.real, d.imag])
        out[s], *_ = np.linalg.lstsq(A, b, rcond=None)
    return out.astype(np.float32)


def design_mmse_interp_differentiator_taps(ntaps: int = 8, nsteps: int = 128,
                                           bw: float = 0.25) -> np.ndarray:
    """Differentiating MMSE interpolator table
    (gr-filter/lib/interp_differentiator_taps.h): fits d/dt of the delayed
    band-limited impulse, i.e. target j2πf·e^{-j2πf(half-1+mu)}."""
    half = ntaps // 2
    n = np.arange(ntaps)
    f = np.linspace(-bw, bw, 501)
    E = np.exp(-2j * np.pi * np.outer(f, n))
    A = np.vstack([E.real, E.imag])
    out = np.zeros((nsteps + 1, ntaps))
    for s in range(nsteps + 1):
        mu = s / nsteps
        # basis is e^{-j2pi f k}; matching x'(p) for x(k)=e^{+j2pi f k}
        # requires the conjugate-flipped (negative) derivative target
        d = -2j * np.pi * f * np.exp(-2j * np.pi * f * (half - 1 + mu))
        b = np.concatenate([d.real, d.imag])
        out[s], *_ = np.linalg.lstsq(A, b, rcond=None)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# GFSK
# ---------------------------------------------------------------------------

def gfsk_mod_blocks(samples_per_symbol: int = 2, bt: float = 0.35,
                    sensitivity: float | None = None):
    """gfsk_mod (gr-digital/python/digital/gfsk.py): NRZ bits -> gaussian
    pulse shaping -> FM. Returns (shaper, fm) blocks; feed bipolar floats."""
    from . import firdes
    from .filter import interp_fir_filter_fff
    from .analog import frequency_modulator_fc
    sps = int(samples_per_symbol)
    if sensitivity is None:
        sensitivity = (np.pi / 2.0) / sps  # h = 0.5 default
    g = firdes.gaussian(1.0, sps, bt, 4 * sps)
    taps = np.convolve(g, np.ones(sps))  # gaussian ⊛ rect (reference gfsk.py)
    shaper = interp_fir_filter_fff(sps, taps.astype(np.float32))
    fm = frequency_modulator_fc(float(sensitivity))
    return shaper, fm


def gfsk_demod_blocks(samples_per_symbol: int = 2,
                      sensitivity: float | None = None):
    """gfsk_demod: quadrature demod (gain = 1/sensitivity) + M&M clock
    recovery + binary slicer. Returns the block list to wire in order.
    The M&M loop runs in its complex form over re+0j (identical real
    dynamics — imaginary slicer terms cancel in the real error)."""
    from .analog import quadrature_demod_cf
    from .digital_loops import clock_recovery_mm_cc
    from .digital import binary_slicer_fb
    from .blocks import real_to_complex, complex_to_real
    sps = int(samples_per_symbol)
    if sensitivity is None:
        sensitivity = (np.pi / 2.0) / sps
    qd = quadrature_demod_cf(1.0 / float(sensitivity))
    f2c = real_to_complex()
    cr = clock_recovery_mm_cc(omega=float(sps), gain_omega=0.25 * 0.175 ** 2,
                              mu=0.5, gain_mu=0.175,
                              omega_relative_limit=0.005)
    c2r = complex_to_real()
    sl = binary_slicer_fb()
    return qd, f2c, cr, c2r, sl


# ---------------------------------------------------------------------------
# instrumentation: number sink, edit_box_msg, ctrlport probes, perf monitor
# ---------------------------------------------------------------------------

class NumberSink(VectorSink):
    """qtgui number_sink analog: single-pole-averaged value readout over the
    (exactly trimmed) stream — padding never contaminates the average."""

    def __init__(self, average: float = 1.0, dtype=F, name=None):
        super().__init__(PortSpec(dtype), name)
        self.alpha = float(average)

    @property
    def value(self) -> float:
        d = self.data()
        if len(d) == 0:
            return 0.0
        mag = np.abs(d) if np.iscomplexobj(d) else np.asarray(d, np.float64)
        v = 0.0
        a = self.alpha
        if a >= 1.0:
            return float(mag.mean())
        for chunk_mean in mag.reshape(-1, 1).mean(axis=1):
            v = a * chunk_mean + (1 - a) * v
        return float(v)


def number_sink(average=1.0, dtype=F):
    return NumberSink(average, dtype)


class EditBoxMsg(Block):
    """edit_box_msg analog: a host-settable value that publishes a message
    whenever set (the GUI widget's message contract, minus the GUI)."""

    def __init__(self, key: str = "value", initial=0.0, name=None):
        super().__init__(name)
        self.key = key
        self._value = initial
        self.message_port_register_in("val", self._on_msg)
        self.message_port_register_out("msg")

    def set_value(self, v):
        self._value = v
        self.post("msg", (self.key, v))

    def _on_msg(self, m):
        self._value = m[1] if isinstance(m, tuple) else m

    @property
    def value(self):
        return self._value


def edit_box_msg(key="value", initial=0.0):
    return EditBoxMsg(key, initial)


class CtrlportProbe(SinkBlock):
    """ctrlport_probe2_x analog: retain the last `length` items for RPC
    readout; exported automatically by ControlPortServer (the retained
    buffer is a public attr)."""

    def __init__(self, length: int = 1024, dtype=C, name=None):
        super().__init__(PortSpec(dtype), name)
        self.length = int(length)
        self.buffer = np.zeros(0, np.dtype(dtype))

    def collect(self, value):
        v = np.asarray(value).reshape(-1)
        self.buffer = np.concatenate([self.buffer, v])[-self.length:]

    def trim(self, n):
        pass

    def get(self):
        return self.buffer.copy()


def ctrlport_probe2_c(length=1024):
    return CtrlportProbe(length, C)


def ctrlport_probe2_f(length=1024):
    return CtrlportProbe(length, F)


def ctrlport_probe_psd(fft_len: int = 1024):
    """ctrlport_probe_psd: retained PSD snapshot probe."""

    class _Psd(CtrlportProbe):
        def get(self):
            buf = self.buffer
            if len(buf) < fft_len:
                return np.zeros(fft_len, np.float32)
            X = np.fft.fftshift(np.fft.fft(buf[-fft_len:]))
            return (20 * np.log10(np.abs(X) + 1e-20)).astype(np.float32)

    return _Psd(fft_len, C)


def perf_monitor(ctrlport_client, keys_prefix: str = "perf."):
    """gr-perf-monitorx analog (textual): fetch + format the per-block perf
    counters a ControlPortServer exports."""
    props = ctrlport_client.properties()
    rows = {k: v for k, v in props.items() if k.startswith(keys_prefix)}
    lines = [f"{k:40s} {v}" for k, v in sorted(rows.items())]
    return "\n".join(lines)
