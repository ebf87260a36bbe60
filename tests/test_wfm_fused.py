"""QA: the production WBFM step (models/wfm.make_wfm_step_fused) and its
front stage (kernels/wfm_front.py) vs the reference-parity chain
(models/wfm.make_wfm_step) and a float64 numpy reference. Every case runs
both fronts: the plain XLA form and the Triton kernel in the Pallas
interpreter (the compiled kernel runs in the gpu-marked test and in
chip_smoke.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gnuradio_tpu.kernels.wfm_front import WfmFront
from gnuradio_tpu.models.wfm import (channel_taps, make_wfm_step,
                                     make_wfm_step_fused)

FRONTS = [pytest.param(dict(front="xla"), id="xla"),
          pytest.param(dict(front="triton", interpret=True),
                       id="triton-interpret")]


def _fm_like_iq(rng, n, fs=1e6, fdev=75e3):
    """FM-modulated noise (band-limited message), complex64."""
    msg = np.convolve(rng.standard_normal(n + 64), np.ones(64) / 64,
                      "valid")[:n]
    msg = msg / (np.abs(msg).max() + 1e-9)
    phase = np.cumsum(2 * np.pi * fdev * msg / fs)
    iq = np.exp(1j * phase) + 0.01 * (rng.standard_normal(n)
                                      + 1j * rng.standard_normal(n))
    return iq.astype(np.complex64)


def _front_ref(front, xq):
    """float64 numpy: demod of the decimating complex FIR's outputs."""
    D, T = front.D, front.T
    w = np.asarray(front.ctaps, np.complex128)[::-1]
    n_out = (len(xq) - front.history) // D
    y = np.array([np.dot(w, xq[k * D:k * D + T]) for k in range(n_out + 1)])
    z = y[1:] * np.conj(y[:-1]) * front.c0
    return front.gain * np.angle(z)


@pytest.mark.parametrize("kw", FRONTS)
@pytest.mark.parametrize("D,fc,n_out", [
    (4, 0.0, 3000),            # WBFM widths, several programs + tail
    (4, 120e3, 1007),          # freq-xlating, ragged tail
    (3, 50e3, 999),            # decimation not a power of two
    (5, 0.0, 200),             # one program larger than the output
])
def test_front_matches_float64(rng, kw, D, fc, n_out):
    front = WfmFront(channel_taps(1e6, 1e6 / D), fc, 1e6, D, 0.53)
    iq = _fm_like_iq(rng, front.history + n_out * D)
    x = np.stack([iq.real, iq.imag]).astype(np.float32)
    impl = kw["front"]
    got = np.asarray(front(jnp.asarray(x[0]), jnp.asarray(x[1]), impl=impl,
                           interpret=kw.get("interpret", False)))
    ref = _front_ref(front, x[0].astype(np.float64) + 1j * x[1])
    assert got.shape == ref.shape == (n_out,)
    # constant-envelope input keeps |y| near 1, so f32 rounding stays far
    # below this bound on the demodulated angle (the output's range is
    # gain * pi)
    assert np.max(np.abs(got - ref)) < 1e-5 * np.pi


def test_front_unknown_impl_raises():
    front = WfmFront(channel_taps(1e6, 250e3), 0.0, 1e6, 4, 0.53)
    x = jnp.zeros(front.history + 400, jnp.float32)
    with pytest.raises(ValueError):
        front(x, x, impl="mosaic")


@pytest.mark.parametrize("kw", FRONTS)
def test_fused_matches_unfused(rng, kw):
    n = 120_000
    iq = _fm_like_iq(rng, n)
    planes = np.stack([iq.real, iq.imag], -1).astype(np.float32)

    init_u, step_u, mult = make_wfm_step(1e6, 250e3, 50e3)
    su = init_u()
    su, ref = jax.jit(step_u)(su, jnp.asarray(iq))

    init_f, step_f, _ = make_wfm_step_fused(1e6, 250e3, 50e3, **kw)
    sf = init_f()
    sf, got = jax.jit(step_f)(sf, jnp.asarray(planes))

    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape
    # stream-start transient: sample 0 of the demod is arg(y0 * conj(0)),
    # arbitrary in both chains; its value smears across the audio FIR's
    # warmup, so compare past the transient.
    skip = 64
    ref, got = ref[skip:], got[skip:]
    err = np.max(np.abs(got - ref))
    scale = np.max(np.abs(ref)) + 1e-9
    assert err / scale < 2e-4, f"fused/unfused mismatch: {err} (scale {scale})"


@pytest.mark.parametrize("kw", FRONTS)
def test_fused_freq_xlating_matches(rng, kw):
    """Nonzero center frequency: the collapsed-rotator algebra must match
    the fxpt-NCO rotator chain within the fxpt quantization bound."""
    n = 80_000
    fs, fc = 1e6, 120e3
    base = _fm_like_iq(rng, n, fs=fs)
    iq = (base * np.exp(2j * np.pi * fc / fs * np.arange(n))
          ).astype(np.complex64)
    planes = np.stack([iq.real, iq.imag], -1).astype(np.float32)

    init_u, step_u, _ = make_wfm_step(1e6, 250e3, 50e3, center_freq=fc)
    su = init_u()
    su, ref = jax.jit(step_u)(su, jnp.asarray(iq))
    init_f, step_f, _ = make_wfm_step_fused(1e6, 250e3, 50e3, center_freq=fc,
                                            **kw)
    sf = init_f()
    sf, got = jax.jit(step_f)(sf, jnp.asarray(planes))
    skip = 64  # dead-sample transient, see test_fused_matches_unfused
    err = np.max(np.abs(np.asarray(got)[skip:] - np.asarray(ref)[skip:]))
    scale = np.max(np.abs(np.asarray(ref))) + 1e-9
    assert err / scale < 1e-3, f"freq-xlating mismatch: {err}"


@pytest.mark.parametrize("kw", FRONTS)
def test_fused_chunk_invariance(rng, kw):
    n = 160_000
    iq = _fm_like_iq(rng, n)
    planes = jnp.asarray(np.stack([iq.real, iq.imag], -1).astype(np.float32))
    init_f, step_f, mult = make_wfm_step_fused(1e6, 250e3, 50e3, **kw)
    s = init_f()
    s, yA = jax.jit(step_f)(s, planes)
    half = (n // (2 * mult)) * mult
    s = init_f()
    s, y1 = jax.jit(step_f)(s, planes[:half])
    s, y2 = jax.jit(step_f)(s, planes[half:])
    yB = jnp.concatenate([y1, y2])
    np.testing.assert_allclose(np.asarray(yA), np.asarray(yB),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kw", FRONTS)
def test_fused_split_stage2_matches(rng, kw):
    """stage2="split" (215-tap quad-rate LPF + audio-rate deemph FIR) is
    numerically equivalent to the folded 775-tap form across chunked calls
    (carry discipline intact for both tails)."""
    n = 200_000
    iq = _fm_like_iq(rng, n)
    planes = np.stack([iq.real, iq.imag], -1).astype(np.float32)

    outs = {}
    for mode in ("folded", "split"):
        init, step, mult = make_wfm_step_fused(1e6, 250e3, 50e3,
                                               stage2=mode, **kw)
        s = init()
        step_j = jax.jit(step)
        parts = []
        for c in range(2):                      # chunk-invariance included
            s, y = step_j(s, jnp.asarray(planes[c * 100_000:(c + 1) * 100_000]))
            parts.append(np.asarray(y))
        outs[mode] = np.concatenate(parts)
    skip = 64
    a, b = outs["folded"][skip:], outs["split"][skip:]
    err = np.max(np.abs(a - b))
    scale = np.max(np.abs(a)) + 1e-9
    assert err / scale < 2e-4, f"split/folded mismatch {err} vs {scale}"


@pytest.mark.gpu
def test_triton_front_compiled_matches_xla(gpu, rng):
    """The compiled Triton front (no interpreter) against the XLA front at
    the WBFM widths."""
    front = WfmFront(channel_taps(1e6, 250e3), 0.0, 1e6, 4, 0.53)
    iq = _fm_like_iq(rng, 1 << 20)
    xq = np.concatenate([np.zeros(front.history, np.complex64), iq])
    xr, xi = jnp.asarray(xq.real), jnp.asarray(xq.imag)
    a = np.asarray(jax.jit(lambda r, i: front(r, i, impl="xla"))(xr, xi))
    b = np.asarray(jax.jit(lambda r, i: front(r, i, impl="triton"))(xr, xi))
    assert a.shape == b.shape
    assert np.max(np.abs(a[1:] - b[1:])) / np.max(np.abs(a)) < 2e-4
