"""PFB suite QA — mirrors gr-filter/python/filter/qa_pfb_channelizer.py:
synthesize a multi-tone signal, channelize, and check each channel contains
its tone at the translated frequency (tone-fit SNR bound); plus arb
resampler and synthesizer round-trip checks."""
import numpy as np
import pytest

from gnuradio_tpu import Flowgraph, TopBlock
from gnuradio_tpu.ops import firdes
from gnuradio_tpu.ops.blocks import StreamSource, vector_sink_c
from gnuradio_tpu.ops.pfb import (PfbArbResampler, pfb_channelizer_ccf,
                                  pfb_decimator_ccf, pfb_synthesizer_ccf)
from gnuradio_tpu.core.stream import PortSpec


def tone_fit(x, f, fs):
    """Least-squares fit of a complex exponential at f; returns (amp, snr_db)."""
    n = np.arange(len(x))
    ref = np.exp(2j * np.pi * f / fs * n)
    c = np.vdot(ref, x) / len(x)
    resid = x - c * ref
    snr = 10 * np.log10((np.abs(c) ** 2 * len(x)) /
                        max(np.sum(np.abs(resid) ** 2), 1e-30))
    return np.abs(c), snr


def proto_taps(fs, M):
    return firdes.low_pass_2(1.0, fs, fs / (2.0 * M) * 0.8, fs / (2.0 * M) * 0.2,
                             80.0, firdes.WIN_BLACKMAN_HARRIS)


def test_channelizer_tones():
    M = 8
    fs = 80_000.0
    ch_rate = fs / M
    # tone in channels 1, 3, 6 (6 == -2 wrapped) at small offsets
    offsets = {1: 300.0, 3: -450.0, 6: 700.0}
    n = 1 << 16
    t = np.arange(n) / fs
    x = np.zeros(n, np.complex64)
    for c, off in offsets.items():
        f = c * ch_rate + off  # wrapped channels > M/2 alias to negative
        if c > M // 2:
            f = (c - M) * ch_rate + off
        x += np.exp(2j * np.pi * f * t).astype(np.complex64)

    fg = Flowgraph()
    src = StreamSource(x, out_port=PortSpec())
    chan = pfb_channelizer_ccf(M, proto_taps(fs, M))
    sinks = [vector_sink_c() for _ in range(M)]
    fg.connect(src, chan)
    for c in range(M):
        fg.connect((chan, c), sinks[c])
    TopBlock(fg).run()

    settle = 1000
    for c in range(M):
        data = sinks[c].data()[settle:]
        if c in offsets:
            amp, snr = tone_fit(data, offsets[c], ch_rate)
            assert amp == pytest.approx(1.0, abs=0.05), (c, amp)
            assert snr > 40.0, (c, snr)
        else:
            assert np.sqrt(np.mean(np.abs(data) ** 2)) < 0.02, c


def test_channelizer_chunk_invariance():
    M = 4
    fs = 32_000.0
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    outs = []
    for cm in (2, 9):
        fg = Flowgraph()
        src = StreamSource(x, out_port=PortSpec())
        chan = pfb_channelizer_ccf(M, proto_taps(fs, M))
        sinks = [vector_sink_c() for _ in range(M)]
        fg.connect(src, chan)
        for c in range(M):
            fg.connect((chan, c), sinks[c])
        TopBlock(fg, chunk_mult=cm).run()
        outs.append(np.stack([s.data() for s in sinks]))
    m = min(outs[0].shape[1], outs[1].shape[1])
    np.testing.assert_allclose(outs[0][:, :m], outs[1][:, :m], atol=2e-5)


def test_decimator_matches_channelizer_channel():
    M = 4
    fs = 32_000.0
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)).astype(np.complex64)
    taps = proto_taps(fs, M)

    fg = Flowgraph()
    src = StreamSource(x, out_port=PortSpec())
    chan = pfb_channelizer_ccf(M, taps)
    sinks = [vector_sink_c() for _ in range(M)]
    fg.connect(src, chan)
    for c in range(M):
        fg.connect((chan, c), sinks[c])
    TopBlock(fg).run()

    fg2 = Flowgraph()
    src2 = StreamSource(x, out_port=PortSpec())
    dec = pfb_decimator_ccf(M, taps, channel=2)
    snk = vector_sink_c()
    fg2.connect(src2, dec, snk)
    TopBlock(fg2).run()

    a, b = sinks[2].data(), snk.data()
    m = min(len(a), len(b))
    np.testing.assert_allclose(a[:m], b[:m], atol=1e-4)


@pytest.mark.parametrize("rate", [0.5, 2.0, 0.7113, 1.4142])
def test_arb_resampler_tone(rate):
    fs = 10_000.0
    f0 = 817.0
    n = 1 << 15
    t = np.arange(n) / fs
    x = np.exp(2j * np.pi * f0 * t).astype(np.complex64)
    nfilts = 32
    taps = firdes.low_pass_2(nfilts, nfilts * fs, fs * min(1.0, rate) * 0.4,
                             fs * min(1.0, rate) * 0.2, 80.0,
                             firdes.WIN_BLACKMAN_HARRIS)

    fg = Flowgraph()
    src = StreamSource(x, out_port=PortSpec())
    rs = PfbArbResampler(rate, taps, nfilts)
    snk = vector_sink_c()
    fg.connect(src, rs, snk)
    TopBlock(fg).run()
    y = snk.data()
    assert len(y) >= int(n * rate * 0.9)
    amp, snr = tone_fit(y[2000:], f0, fs * rate)
    assert amp == pytest.approx(1.0, abs=0.05), amp
    assert snr > 40.0, snr


def test_arb_resampler_chunk_invariance():
    rate = 0.75
    fs = 8_000.0
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)).astype(np.complex64)
    nfilts = 16
    taps = firdes.low_pass_2(nfilts, nfilts * fs, fs * 0.3, fs * 0.15, 60.0,
                             firdes.WIN_BLACKMAN_HARRIS)
    outs = []
    for cm in (1, 5):
        fg = Flowgraph()
        src = StreamSource(x, out_port=PortSpec())
        rs = PfbArbResampler(rate, taps, nfilts)
        snk = vector_sink_c()
        fg.connect(src, rs, snk)
        TopBlock(fg, chunk_mult=cm).run()
        outs.append(snk.data())
    m = min(len(outs[0]), len(outs[1]))
    np.testing.assert_allclose(outs[0][:m], outs[1][:m], atol=2e-5)


def test_synthesizer_roundtrip():
    """channelize M bands then synthesize back: output ~= delayed input."""
    M = 4
    fs = 32_000.0
    n = 1 << 14
    t = np.arange(n) / fs
    x = (0.5 * np.exp(2j * np.pi * 1000 * t)
         + 0.3 * np.exp(2j * np.pi * 9000 * t)).astype(np.complex64)
    taps = proto_taps(fs, M)

    fg = Flowgraph()
    src = StreamSource(x, out_port=PortSpec())
    chan = pfb_channelizer_ccf(M, taps)
    synth = pfb_synthesizer_ccf(M, taps)
    snk = vector_sink_c()
    fg.connect(src, chan)
    for c in range(M):
        fg.connect((chan, c), (synth, c))
    fg.connect(synth, snk)
    TopBlock(fg).run()
    y = snk.data()
    # tones should survive the analysis/synthesis cascade at unit gain
    for f, a_want in ((1000.0, 0.5), (9000.0, 0.3)):
        amp, snr = tone_fit(y[4000:], f, fs)
        assert amp == pytest.approx(a_want, rel=0.15), (f, amp)


# ---------------------------------------------------------------------------
# oversampled channelizer (oversample_rate > 1)
# ---------------------------------------------------------------------------

def _run_channelizer(x, M, taps, osr):
    fg = Flowgraph()
    src = StreamSource(x, out_port=PortSpec())
    chan = pfb_channelizer_ccf(M, taps, oversample_rate=osr)
    sinks = [vector_sink_c() for _ in range(M)]
    fg.connect(src, chan)
    for c in range(M):
        fg.connect((chan, c), sinks[c])
    TopBlock(fg).run()
    return [s.data() for s in sinks]


def test_channelizer_osr2_phase0_equals_maximally_decimated(rng):
    """Every other osr=2 output sample (phase p=0, t=2s -> tR=sM) must be
    EXACTLY the osr=1 output — the strongest internal-consistency check for
    the oversampled commutator math."""
    M = 8
    fs = 80_000.0
    taps = proto_taps(fs, M)
    n = 1 << 13
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    y1 = _run_channelizer(x, M, taps, 1.0)
    y2 = _run_channelizer(x, M, taps, 2.0)
    for c in range(M):
        k = min(len(y1[c]), len(y2[c]) // 2)
        np.testing.assert_allclose(y2[c][0:2 * k:2], y1[c][:k],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("osr", [2.0, 4.0])
def test_channelizer_oversampled_tones(osr):
    """qa_pfb_channelizer.py pattern at osr>1: tones at per-channel offsets
    come out clean at the oversampled channel rate fs*osr/M."""
    M = 8
    fs = 80_000.0
    ch_rate = fs / M * osr
    offsets = {1: 300.0, 5: -450.0}
    n = 1 << 15
    t = np.arange(n) / fs
    x = np.zeros(n, np.complex64)
    for c, off in offsets.items():
        f = (c - M if c > M // 2 else c) * (fs / M) + off
        x += np.exp(2j * np.pi * f * t).astype(np.complex64)
    ys = _run_channelizer(x, M, proto_taps(fs, M), osr)
    settle = 1000
    for c, off in offsets.items():
        amp, snr = tone_fit(ys[c][settle:], off, ch_rate)
        assert amp == pytest.approx(1.0, abs=0.05), (c, amp)
        assert snr > 40.0, (c, snr)


def test_channelizer_osr_fractional_hop(rng):
    """N/i oversample rates with non-integer osr (reference allows any
    integer hop R = M/osr): M=8, R=3 -> osr=8/3."""
    M = 8
    fs = 80_000.0
    n = 3 * (1 << 12)
    t = np.arange(n) / fs
    x = np.exp(2j * np.pi * (fs / M + 200.0) * t).astype(np.complex64)
    ys = _run_channelizer(x, M, proto_taps(fs, M), M / 3.0)
    ch_rate = fs / 3.0
    amp, snr = tone_fit(ys[1][2000:], 200.0, ch_rate)
    assert amp == pytest.approx(1.0, abs=0.06)
    assert snr > 35.0


def test_channelizer_osr2_chunk_invariance(rng):
    M = 4
    fs = 16_000.0
    taps = proto_taps(fs, M)
    n = 1 << 12
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    outs = []
    for tgt in (256, 4096):
        fg = Flowgraph()
        src = StreamSource(x, out_port=PortSpec())
        chan = pfb_channelizer_ccf(M, taps, oversample_rate=2.0)
        sinks = [vector_sink_c() for _ in range(M)]
        fg.connect(src, chan)
        for c in range(M):
            fg.connect((chan, c), sinks[c])
        TopBlock(fg, target_items=tgt).run()
        outs.append([s.data() for s in sinks])
    for c in range(M):
        k = min(len(outs[0][c]), len(outs[1][c]))
        np.testing.assert_allclose(outs[0][c][:k], outs[1][c][:k],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rate", [None, 0.75])
def test_channelizer_step_matches_graph(rng, rate):
    """models/channelize.make_channelizer_step (the bench/bare-step form,
    one batched op across channels) over 3 carried steps against
    channelize_graph (per-channel blocks through TopBlock) on the same
    input, with and without the per-channel arb resampler."""
    import jax
    import jax.numpy as jnp
    from gnuradio_tpu.models.channelize import (channelize_graph,
                                                make_channelizer_step)
    fs, M, steps = 1_024_000.0, 16, 3
    init, step, meta = make_channelizer_step(fs, M, rate)
    n = meta["in_multiple"] * 24
    x = (rng.standard_normal(steps * n)
         + 1j * rng.standard_normal(steps * n)).astype(np.complex64)
    st, outs = init(), []
    step_j = jax.jit(step)
    for k in range(steps):
        st, y = step_j(st, jnp.asarray(x[k * n:(k + 1) * n]))
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=1)
    tb, sinks = channelize_graph(x, fs, M, rate)
    tb.run()
    ref = np.stack([np.asarray(s.data()) for s in sinks])
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12)
    assert err < 1e-4, err
