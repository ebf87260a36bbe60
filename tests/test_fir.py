"""FIR kernel + block golden tests vs numpy/scipy.
Mirrors gr-filter/python/filter/qa_fir_filter.py's pattern:
vector_source -> DUT -> vector_sink vs a hand-computed reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig

from gnuradio_tpu.core.graph import Flowgraph
from gnuradio_tpu.core.runtime import TopBlock
from gnuradio_tpu.kernels.fir_xla import fir_apply
from gnuradio_tpu.ops import blocks, filter as flt

from gr_testing import assert_snr


def ref_fir(x, taps, decim=1):
    """GR semantics: y[k] = sum_j taps[j] x[k*decim - j], x[<0]=0."""
    full = np.convolve(x, taps)[: len(x)]
    return full[::decim]


def run_graph(src_data, blk, out_dtype=np.complex64, chunk_mult=None):
    fg = Flowgraph()
    src = blocks.vector_source(src_data)
    snk = blocks.vector_sink(
        dtype=blk.out_ports[0].dtype, vlen=blk.out_ports[0].vlen)
    fg.connect(src, blk, snk)
    TopBlock(fg, chunk_mult=chunk_mult).run()
    return snk.data()


def test_fir_fff_sync(rng):
    x = rng.standard_normal(256).astype(np.float32)
    taps = rng.standard_normal(17).astype(np.float32)
    y = run_graph(x, flt.fir_filter_fff(1, taps))
    assert_snr(y, ref_fir(x, taps), 100)


def test_fir_ccf_decim(rng):
    x = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(np.complex64)
    taps = rng.standard_normal(31).astype(np.float32)
    y = run_graph(x, flt.fir_filter_ccf(4, taps))
    assert_snr(y, ref_fir(x, taps, 4), 100)


def test_fir_ccc(rng):
    x = (rng.standard_normal(300) + 1j * rng.standard_normal(300)).astype(np.complex64)
    taps = (rng.standard_normal(21) + 1j * rng.standard_normal(21)).astype(np.complex64)
    y = run_graph(x, flt.fir_filter_ccc(2, taps))
    assert_snr(y, ref_fir(x, taps, 2), 90)


def test_fir_chunk_invariance(rng):
    """Results must not depend on chunking (SURVEY.md App. C
    history/alignment invariance)."""
    x = rng.standard_normal(1024).astype(np.float32)
    taps = rng.standard_normal(33).astype(np.float32)
    y1 = run_graph(x, flt.fir_filter_fff(2, taps), chunk_mult=128)
    y2 = run_graph(x, flt.fir_filter_fff(2, taps), chunk_mult=300)
    n = min(len(y1), len(y2))
    assert n >= 512 // 2
    assert_snr(y1[:n], y2[:n], 120)


def test_fft_filter_matches_fir(rng):
    """fft_filter vs fir_filter equivalence (qa_fft_filter.py analog)."""
    x = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)).astype(np.complex64)
    taps = rng.standard_normal(57).astype(np.float32)
    y_fir = run_graph(x, flt.fir_filter_ccf(1, taps))
    y_fft = run_graph(x, flt.fft_filter_ccf(1, taps))
    assert_snr(y_fft, y_fir, 90)
    assert_snr(y_fft, ref_fir(x, taps), 90)


def test_fft_filter_fff_decim(rng):
    x = rng.standard_normal(1200).astype(np.float32)
    taps = rng.standard_normal(40).astype(np.float32)
    y = run_graph(x, flt.fft_filter_fff(3, taps))
    assert_snr(y, ref_fir(x, taps, 3), 90)


def test_interp_fir(rng):
    x = rng.standard_normal(128).astype(np.float32)
    L = 4
    taps = rng.standard_normal(24).astype(np.float32)
    y = run_graph(x, flt.interp_fir_filter_fff(L, taps))
    # reference: zero-stuff then filter
    up = np.zeros(len(x) * L, np.float32)
    up[::L] = x
    assert_snr(y, np.convolve(up, taps)[: len(up)], 90)


def test_rational_resampler(rng):
    x = rng.standard_normal(240).astype(np.float32)
    L, M = 3, 2
    taps = rng.standard_normal(30).astype(np.float32)
    y = run_graph(x, flt.RationalResampler(L, M, taps, in_complex=False))
    up = np.zeros(len(x) * L, np.float32)
    up[::L] = x
    full = np.convolve(up, taps)[: len(up)]
    assert_snr(y, full[::M], 90)


def test_single_pole_iir(rng):
    x = rng.standard_normal(500).astype(np.float32)
    alpha = 0.125
    blk = flt.single_pole_iir_filter_ff(alpha)
    y = run_graph(x, blk)
    ref = sig.lfilter([alpha], [1, -(1 - alpha)], x)
    assert_snr(y, ref, 80)


def test_iir_first_order(rng):
    x = rng.standard_normal(400).astype(np.float32)
    # y[n] = 0.3 x[n] + 0.1 x[n-1] + 0.8 y[n-1]
    blk = flt.iir_filter_ffd([0.3, 0.1], [1.0, -0.8], oldstyle=False)
    y = run_graph(x, blk)
    ref = sig.lfilter([0.3, 0.1], [1.0, -0.8], x)
    assert_snr(y, ref, 80)


def test_iir_second_order_scan(rng):
    x = rng.standard_normal(200).astype(np.float32)
    b = [0.2, 0.3, 0.1]
    a = [1.0, -0.5, 0.2]
    blk = flt.iir_filter_ffd(b, a, oldstyle=False)
    y = run_graph(x, blk)
    ref = sig.lfilter(b, a, x)
    assert_snr(y, ref, 80)


def test_dc_blocker(rng):
    x = (rng.standard_normal(600) + 3.0).astype(np.float32)
    y = run_graph(x, flt.dc_blocker_ff(16, True))
    # steady-state mean should be ~0
    assert abs(np.mean(y[100:])) < 0.05


def test_moving_average(rng):
    x = rng.standard_normal(300).astype(np.float32)
    L = 8
    y = run_graph(x, blocks.moving_average(L, 1.0 / L, np.float32))
    ref = np.convolve(x, np.ones(L) / L)[: len(x)]
    assert_snr(y, ref, 90)


@pytest.mark.parametrize("T,d,cx,ct", [
    (107, 4, True, True),    # WBFM stage 1 (complex taps)
    (215, 5, False, False),  # WBFM audio FIR
    (63, 1, True, False),    # sync complex filter
    (33, 2, False, True),    # real in, complex taps (hilbert-ish)
])
def test_fir_apply_matches_float64(rng, T, d, cx, ct):
    """kernels/fir_xla.fir_apply (history-prepended convention) against a
    float64 np.convolve reference, for every input/tap type combination."""
    n = 4096 * d
    x = rng.standard_normal(n + T - 1)
    if cx:
        x = x + 1j * rng.standard_normal(n + T - 1)
    taps = rng.standard_normal(T)
    if ct:
        taps = taps + 1j * rng.standard_normal(T)
    x32 = x.astype(np.complex64 if cx else np.float32)
    t32 = taps.astype(np.complex64 if ct else np.float32)
    got = np.asarray(fir_apply(jnp.asarray(x32), jnp.asarray(t32), d))
    # y[k] = sum_j taps[j] * xp[(T-1) + k*d - j]
    ref = np.convolve(x32.astype(np.complex128 if cx else np.float64),
                      t32.astype(np.complex128 if ct else np.float64),
                      "valid")[::d]
    assert got.shape == ref.shape == (n // d,)
    assert np.iscomplexobj(got) == (cx or ct)
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-6)
