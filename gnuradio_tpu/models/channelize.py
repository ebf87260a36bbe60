"""64-channel PFB channelizer + per-channel arbitrary resampler —
BASELINE.json config #2.

Reference app pattern: gr-filter/examples/channelize.py:58-100 (M sig
sources -> add -> pfb.channelizer_ccf -> per-channel sinks) plus a
pfb_arb_resampler_ccf on each channel (gr-filter/lib/pfb_arb_resampler.cc).

Two forms:
  * channelize_graph(...)  — block-graph form under TopBlock.
  * make_channelizer_step(...) — bare jittable step for bench/dryrun:
      step(state, iq[N complex]) -> (state, chans[(M, N/M) complex])
    with the per-channel resampler running as ONE batched op across all
    channels (channel axis = batch axis; on a multi-chip mesh the channel
    axis shards across chips — "chan" mesh axis, parallel/mesh.py).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.graph import Flowgraph
from ..core.runtime import TopBlock
from ..core.stream import PortSpec
from ..ops import firdes
from ..ops.blocks import StreamSource, vector_sink_c
from ..ops.pfb import PfbChannelizer, PfbArbResampler, pfb_channelizer_ccf


def channelizer_taps(fs: float, nchans: int, atten: float = 80.0):
    """Prototype low-pass for the channelizer (channelize.py:64-74 uses
    firdes.low_pass_2 with Blackman-Harris)."""
    ch_bw = fs / (2.0 * nchans)
    return firdes.low_pass_2(1.0, fs, ch_bw * 0.8, ch_bw * 0.2, atten,
                             firdes.WIN_BLACKMAN_HARRIS)


def resampler_taps(ch_rate: float, rate: float, nfilts: int = 32,
                   atten: float = 80.0):
    bw = ch_rate * min(1.0, rate) * 0.4
    tb = ch_rate * min(1.0, rate) * 0.2
    return firdes.low_pass_2(nfilts, nfilts * ch_rate, bw, tb, atten,
                             firdes.WIN_BLACKMAN_HARRIS)


def channelize_graph(iq_data, fs: float, nchans: int = 64,
                     resample_rate: float | None = None, chunk_mult=None):
    """Graph form: source -> channelizer -> [arb resampler ->] M sinks.
    Returns (TopBlock, [sinks])."""
    fg = Flowgraph()
    src = StreamSource(np.asarray(iq_data, np.complex64), out_port=PortSpec())
    chan = pfb_channelizer_ccf(nchans, channelizer_taps(fs, nchans))
    fg.connect(src, chan)
    sinks = []
    ch_rate = fs / nchans
    for c in range(nchans):
        snk = vector_sink_c()
        if resample_rate is not None:
            rs = PfbArbResampler(resample_rate,
                                 resampler_taps(ch_rate, resample_rate))
            fg.connect((chan, c), rs, snk)
        else:
            fg.connect((chan, c), snk)
        sinks.append(snk)
    return TopBlock(fg, chunk_mult=chunk_mult), sinks


def make_channelizer_step(fs: float = 6_400_000.0, nchans: int = 64,
                          resample_rate: float | None = 0.9375,
                          nfilts: int = 32):
    """Bare functional form: returns (init_state, step, meta).

    step(state, iq[(n,) complex64]) -> (state, out[(nchans, T_out) complex64])
    n must be a multiple of meta['in_multiple']. The per-channel arb
    resampler is evaluated for ALL channels as one batched gather+dot
    (channels = leading batch axis), so the whole config is two convolutions,
    one FFT, and one batched dot per step.
    """
    chan = PfbChannelizer(nchans, channelizer_taps(fs, nchans))
    ch_rate = fs / nchans
    rs = None
    if resample_rate is not None:
        rs = PfbArbResampler(resample_rate,
                             resampler_taps(ch_rate, resample_rate, nfilts),
                             nfilts)
    in_mult = nchans * (rs.Q if rs is not None else 1)

    def init_state():
        st = {"chan": chan.init_state()}
        if rs is not None:
            st["rs"] = jnp.zeros((nchans, rs.L), jnp.complex64)
        return st

    def step(state, iq):
        # batched fast path: no per-channel tuple slicing + restack
        st_c, Y = chan.apply_batched(state["chan"], iq)   # (M, T)
        out_state = {"chan": st_c}
        if rs is None:
            return out_state, Y
        xp = jnp.concatenate([state["rs"], Y], axis=1)  # (M, L+T)
        out_state["rs"] = xp[:, xp.shape[1] - rs.L:]
        out = rs.resample_batched(xp)                    # (M, T*P/Q)
        return out_state, out.astype(jnp.complex64)

    meta = {"in_multiple": in_mult, "nchans": nchans, "ch_rate": ch_rate,
            "out_rate": ch_rate * (resample_rate or 1.0)}
    return init_state, step, meta

