"""WBFM receiver — the flagship end-to-end chain (BASELINE.json config #1).

Reference parity: gr-analog/python/analog/wfm_rcv.py:22-65 —
    quadrature_demod_cf(gain = quad_rate / (2*pi*max_dev))
    -> fir_filter_fff(audio_decim, firdes.low_pass(1, quad_rate,
                      audio_rate/2 - width/2, width, WIN_HAMMING))
    -> fm_deemph(audio_rate, tau=75e-6)
with an optional leading freq_xlating_fir_filter_ccf channel selector
(gr-filter freq_xlating_fir_filter.h) as in the mp-sched / uhd examples.

Two forms are provided:
  * `wfm_rcv_graph(...)` — the block-graph form, run under TopBlock.
  * `wfm_receive_fn(...)` — the same chain as a bare jittable
    `step(state, iq_chunk) -> (state, audio_chunk)` function, used by
    bench.py and __graft_entry__.py (no graph overhead at all).
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..core.graph import Flowgraph
from ..core.hier import HierBlock
from ..core.runtime import TopBlock
from ..core.stream import PortSpec, C, F
from ..ops import firdes
from ..ops.analog import QuadratureDemod, fm_deemph, quadrature_demod_cf
from ..ops.blocks import VectorSink, StreamSource, vector_sink_f
from ..ops.filter import (FirFilter, FreqXlatingFirFilter, fir_filter_fff,
                          freq_xlating_fir_filter_ccf)


def wfm_taps(quad_rate: float, audio_rate: float, width: float = None):
    """Audio LPF taps per wfm_rcv.py (width defaults to the reference's
    audio_rate/32 transition ~ matching its low_pass(1.0, quad_rate,
    audio_rate/2-width, width))."""
    if width is None:
        width = audio_rate / 32.0
    return firdes.low_pass(1.0, quad_rate, audio_rate / 2 - width, width,
                           firdes.WIN_HAMMING)


def channel_taps(samp_rate: float, quad_rate: float):
    """Channel-select LPF for the front-end freq-xlating stage."""
    return firdes.low_pass(1.0, samp_rate, quad_rate * 0.4, quad_rate * 0.1,
                           firdes.WIN_HAMMING)


class WfmRcv(HierBlock):
    """wfm_rcv hier block (gr-analog/python/analog/wfm_rcv.py:22-65):
    quadrature_demod -> decimating audio FIR -> fm_deemph, packaged as a
    composite block so it composes with the rest of the catalog inside any
    Flowgraph (flattened to the same fused XLA program at compile)."""

    def __init__(self, quad_rate: float, audio_decimation: int,
                 max_dev: float = 75_000.0, tau: float = 75e-6, name=None):
        super().__init__(name or "wfm_rcv",
                         in_ports=(PortSpec(C),), out_ports=(PortSpec(F),))
        audio_rate = quad_rate / audio_decimation
        demod = quadrature_demod_cf(quad_rate / (2 * math.pi * max_dev))
        audio = fir_filter_fff(audio_decimation, wfm_taps(quad_rate, audio_rate))
        deemph = fm_deemph(audio_rate, tau)
        self.connect((self, 0), demod, audio, deemph, (self, 0))


class WfmRcvFull(HierBlock):
    """Full front-end variant: freq_xlating channel selector + WfmRcv nested
    (exercises recursive hier flattening)."""

    def __init__(self, samp_rate: float, quad_rate: float, audio_rate: float,
                 center_freq: float = 0.0, max_dev: float = 75_000.0,
                 tau: float = 75e-6, name=None):
        super().__init__(name or "wfm_rcv_full",
                         in_ports=(PortSpec(C),), out_ports=(PortSpec(F),))
        chan_decim = int(round(samp_rate / quad_rate))
        audio_decim = int(round(quad_rate / audio_rate))
        chan = freq_xlating_fir_filter_ccf(
            chan_decim, channel_taps(samp_rate, quad_rate), center_freq,
            samp_rate)
        rcv = WfmRcv(quad_rate, audio_decim, max_dev, tau)
        self.connect((self, 0), chan, rcv, (self, 0))


class WfmTx(HierBlock):
    """wfm_tx hier block (gr-analog/python/analog/wfm_tx.py): audio floats
    in [-1,1] -> interpolating FIR (audio->quad rate) -> fm_preemph ->
    frequency_modulator_fc(2*pi*max_dev/quad_rate) -> complex baseband."""

    def __init__(self, audio_rate: float, quad_rate: float, tau: float = 75e-6,
                 max_dev: float = 75e3, fh: float = -1.0, name=None):
        super().__init__(name or "wfm_tx",
                         in_ports=(PortSpec(F),), out_ports=(PortSpec(C),))
        audio_rate, quad_rate = int(audio_rate), int(quad_rate)
        if quad_rate % audio_rate:
            raise ValueError("quad_rate must be an integer multiple of "
                             "audio_rate (wfm_tx.py)")
        from ..ops.analog import fm_preemph, frequency_modulator_fc
        from ..ops.filter import interp_fir_filter_fff
        interp = quad_rate // audio_rate
        pre = fm_preemph(quad_rate, tau=tau, fh=fh)
        mod = frequency_modulator_fc(2 * math.pi * max_dev / quad_rate)
        if interp > 1:
            taps = firdes.low_pass(interp, quad_rate,
                                   min(16000.0, 0.4 * audio_rate),
                                   0.1 * audio_rate, firdes.WIN_HAMMING)
            it = interp_fir_filter_fff(interp, taps)
            self.connect((self, 0), it, pre, mod, (self, 0))
        else:
            self.connect((self, 0), pre, mod, (self, 0))


def wfm_rcv_graph(iq_data, samp_rate=1_000_000.0, quad_rate=250_000.0,
                  audio_rate=50_000.0, center_freq=0.0, max_dev=75_000.0,
                  tau=75e-6, chunk_mult=1):
    """Build the full receiver flowgraph over a recorded IQ array.
    Returns (TopBlock, audio_sink)."""
    chan_decim = int(round(samp_rate / quad_rate))
    audio_decim = int(round(quad_rate / audio_rate))
    fg = Flowgraph()
    src = StreamSource(np.asarray(iq_data, np.complex64), out_port=PortSpec())
    chan = freq_xlating_fir_filter_ccf(
        chan_decim, channel_taps(samp_rate, quad_rate), center_freq, samp_rate)
    demod = quadrature_demod_cf(quad_rate / (2 * math.pi * max_dev))
    audio = fir_filter_fff(audio_decim, wfm_taps(quad_rate, audio_rate))
    deemph = fm_deemph(audio_rate, tau)
    snk = vector_sink_f()
    fg.connect(src, chan, demod, audio, deemph, snk)
    tb = TopBlock(fg, chunk_mult=chunk_mult)
    return tb, snk


def make_wfm_step(samp_rate=1_000_000.0, quad_rate=250_000.0,
                  audio_rate=50_000.0, center_freq=0.0, max_dev=75_000.0,
                  tau=75e-6):
    """Bare functional form: returns (init_state_fn, step_fn, in_multiple).

    step(state, iq_chunk[complex64, n]) -> (state, audio[float32, n/decim])
    where decim = samp_rate/audio_rate; n must be a multiple of in_multiple.
    """
    chan_decim = int(round(samp_rate / quad_rate))
    audio_decim = int(round(quad_rate / audio_rate))
    chan = FreqXlatingFirFilter(chan_decim, channel_taps(samp_rate, quad_rate),
                                center_freq, samp_rate)
    demod = QuadratureDemod(quad_rate / (2 * math.pi * max_dev))
    audio = FirFilter(audio_decim, wfm_taps(quad_rate, audio_rate),
                      in_complex=False)
    # deemphasis one-pole as its truncated impulse response (exact < 1e-9;
    # ops/iir_core.first_order_fir_taps) — the associative_scan IIR costs
    # log-depth passes over memory, the FIR is one matmul. The block-graph
    # path (wfm_rcv_graph) keeps the exact IIR form.
    from .wfm_sharded import _deemph_coeffs
    from ..ops.iir_core import first_order_fir_taps
    b0, b1, r = _deemph_coeffs(audio_rate, tau)
    deemph = FirFilter(1, first_order_fir_taps(b0, b1, r), in_complex=False)
    blocks = [chan, demod, audio, deemph]

    def init_state():
        return [b.init_state() for b in blocks]

    def step(state, iq):
        s0, (y,) = chan.apply(state[0], (iq,), (iq.shape[0],))
        s1, (y,) = demod.apply(state[1], (y,), (y.shape[0],))
        s2, (y,) = audio.apply(state[2], (y,), (y.shape[0],))
        s3, (y,) = deemph.apply(state[3], (y,), (y.shape[0],))
        return [s0, s1, s2, s3], y

    return init_state, step, chan_decim * audio_decim


def make_wfm_step_fused(samp_rate=1_000_000.0, quad_rate=250_000.0,
                        audio_rate=50_000.0, center_freq=0.0,
                        max_dev=75_000.0, tau=75e-6, front="triton",
                        interpret=False, layout="interleaved",
                        stage2="split"):
    """Production WBFM receiver: the channel-select FIR + rotator + FM
    discriminator run as one front stage (kernels/wfm_front.py — the
    rotator collapses algebraically into a constant phasor), followed by
    the audio FIR and deemphasis-as-truncated-FIR stages.

    front: "triton" (the Pallas kernel, which beats the plain form end to
    end on an H100 — PERF.md; it needs a GPU, or `interpret=True` to run in
    the Pallas interpreter for tests) or "xla" (plain jax, any backend).

    Input is PLANES, not complex: step(state, iq[(n, 2) f32]) -> (state,
    audio[(n/decim,) f32]) with layout="interleaved", or iq[(2, n) f32] with
    layout="planes". Numerically equivalent to make_wfm_step (QA:
    tests/test_wfm_fused.py).
    """
    from ..kernels.wfm_front import WfmFront
    from ..kernels.fir_xla import fir_apply
    from .wfm_sharded import _deemph_coeffs
    from ..ops.iir_core import first_order_fir_taps

    chan_decim = int(round(samp_rate / quad_rate))
    audio_decim = int(round(quad_rate / audio_rate))
    front_stage = WfmFront(channel_taps(samp_rate, quad_rate), center_freq,
                           samp_rate, chan_decim,
                           quad_rate / (2 * math.pi * max_dev))
    a_taps = np.asarray(wfm_taps(quad_rate, audio_rate), np.float64)
    b0, b1, r = _deemph_coeffs(audio_rate, tau)
    d_taps = np.asarray(first_order_fir_taps(b0, b1, r), np.float64)
    # stage2="folded": fold the audio-rate deemphasis FIR into the
    # quad-rate audio LPF: deemph(decim5(a*d)) == decim5((a conv
    # up5(deemph)) * d) — exact by linear-convolution associativity, one
    # pass instead of two. stage2="split": keep the 215-tap audio LPF at
    # quad rate and apply the deemphasis truncated-FIR at AUDIO rate —
    # ~2.4x less contraction than the folded 775-tap quad-rate FIR.
    up = np.zeros(audio_decim * len(d_taps) - (audio_decim - 1))
    up[::audio_decim] = d_taps
    comb_taps = np.convolve(a_taps, up).astype(np.float32)
    T2 = len(comb_taps)
    a32 = a_taps.astype(np.float32)
    d32 = d_taps.astype(np.float32)
    Ta, Td = len(a32), len(d32)
    H = front_stage.history

    def init_state():
        if stage2 == "split":
            return {"front": jnp.zeros((2, H), jnp.float32),
                    "audio": jnp.zeros(Ta - 1, jnp.float32),
                    "deemph": jnp.zeros(Td - 1, jnp.float32)}
        return {"front": jnp.zeros((2, H), jnp.float32),
                "audio": jnp.zeros(T2 - 1, jnp.float32)}

    def step(state, iq_planes):
        if layout == "planes":
            xr_in, xi_in = iq_planes[0], iq_planes[1]
        else:
            xr_in, xi_in = iq_planes[:, 0], iq_planes[:, 1]
        xr = jnp.concatenate([state["front"][0], xr_in])
        xi = jnp.concatenate([state["front"][1], xi_in])
        t0 = jnp.stack([xr[xr.shape[0] - H:], xi[xi.shape[0] - H:]])
        y = front_stage(xr, xi, impl=front, interpret=interpret)
        if stage2 == "split":
            yp = jnp.concatenate([state["audio"], y])
            t1 = yp[yp.shape[0] - (Ta - 1):]
            au = fir_apply(yp, jnp.asarray(a32), audio_decim)
            ap = jnp.concatenate([state["deemph"], au])
            t2 = ap[ap.shape[0] - (Td - 1):]
            out = fir_apply(ap, jnp.asarray(d32), 1)
            return {"front": t0, "audio": t1, "deemph": t2}, out
        yp = jnp.concatenate([state["audio"], y])
        t1 = yp[yp.shape[0] - (T2 - 1):]
        out = fir_apply(yp, jnp.asarray(comb_taps), audio_decim)
        return {"front": t0, "audio": t1}, out

    return init_state, step, chan_decim * audio_decim
