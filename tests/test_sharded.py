"""Time-sharding QA: halo exchange + cross-shard IIR must be chunk/shard
invariant (SURVEY.md App. C 'history/alignment invariance') — the sharded
step's output must equal the single-device step's output.

Runs on the virtual 8-device CPU mesh (conftest.py), the single-process
stand-in for multi-chip (SURVEY.md §4 'multi-node without a cluster')."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import lax

from gnuradio_tpu.parallel.mesh import make_mesh
from gnuradio_tpu.parallel.halo import left_halo, first_order_boundary
from gnuradio_tpu.models.wfm import make_wfm_step
from gnuradio_tpu.models.wfm_sharded import make_wfm_sharded
from jax import shard_map
from jax.sharding import PartitionSpec as P


def test_left_halo_matches_concat(rng):
    mesh = make_mesh(n_time=8)
    n, h = 64, 5
    x = rng.standard_normal(8 * n).astype(np.float32)
    carry = rng.standard_normal(h).astype(np.float32)

    def local(xl, c):
        xp, new_c = left_halo(xl, c, "time")
        return xp, new_c

    f = shard_map(local, mesh=mesh, in_specs=(P("time"), P()),
                  out_specs=(P("time"), P()), check_vma=False)
    xp, new_c = f(x, carry)
    xp = np.asarray(xp).reshape(8, n + h)
    full = np.concatenate([carry, x])
    for d in range(8):
        np.testing.assert_array_equal(xp[d], full[d * n: d * n + n + h])
    np.testing.assert_array_equal(np.asarray(new_c), x[-h:])


def test_first_order_boundary_exact(rng):
    mesh = make_mesh(n_time=8)
    n = 32
    d = rng.standard_normal(8 * n).astype(np.float32)
    r = 0.93
    y0 = 0.37

    def local(dl):
        y_zero = jax.lax.associative_scan(
            lambda a, b: (a[0] * b[0], a[1] * b[0] + b[1]),
            (jnp.full_like(dl, r), dl))[1]
        y, carry = first_order_boundary(y_zero, jnp.float32(r),
                                        jnp.float32(y0), "time")
        return y, carry

    f = shard_map(local, mesh=mesh, in_specs=(P("time"),),
                  out_specs=(P("time"), P()), check_vma=False)
    y, carry = f(d)
    # reference sequential recurrence
    ref = np.zeros(8 * n, np.float64)
    acc = y0
    for i in range(8 * n):
        acc = r * acc + d[i]
        ref[i] = acc
    np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=2e-4)
    np.testing.assert_allclose(float(carry), ref[-1], atol=2e-4)


def test_wfm_sharded_matches_unsharded():
    rng = np.random.default_rng(7)
    mesh = make_mesh(n_time=8)
    init_s, step_s, specs = make_wfm_sharded(mesh, center_freq=25_000.0)
    n = specs["min_items_per_shard"] * 8
    iq = (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)

    st = init_s()
    outs = []
    for _ in range(3):
        st, a = step_s(st, jax.device_put(iq, specs["in_sharding"]))
        outs.append(np.asarray(a))
    sharded = np.concatenate(outs)

    init_u, step_u, _ = make_wfm_step(center_freq=25_000.0)
    su = init_u()
    outs = []
    x = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    for _ in range(3):
        su, a = step_u(su, x)
        outs.append(np.asarray(a))
    unsharded = np.concatenate(outs)

    err = sharded - unsharded
    rel = np.sqrt(np.mean(err ** 2)) / np.sqrt(np.mean(unsharded ** 2))
    assert rel < 1e-5, rel


@pytest.mark.parametrize("front", [
    pytest.param(dict(front="xla"), id="xla"),
    pytest.param(dict(front="triton", interpret=True), id="triton-interpret")])
@pytest.mark.parametrize("D", [2, 8])
def test_wfm_sharded_fused_matches_unsharded_fused(D, front):
    """The sharded path runs the SAME front stage as the single-device
    production step (models/wfm.make_wfm_step_fused). Exactness vs the
    unsharded chain across shard counts."""
    from gnuradio_tpu.models.wfm_sharded import make_wfm_sharded_fused
    from gnuradio_tpu.models.wfm import make_wfm_step_fused

    rng = np.random.default_rng(11)
    mesh = make_mesh(n_time=D)
    init_s, step_s, specs = make_wfm_sharded_fused(mesh, center_freq=25_000.0,
                                                   **front)
    n = max(specs["min_items_per_shard"] * D, 20 * specs["decim"] * D)
    iq = (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)

    st = init_s()
    outs = []
    for _ in range(3):
        st, a = step_s(st, jax.device_put(iq, specs["in_sharding"]))
        outs.append(np.asarray(a))
    sharded = np.concatenate(outs)

    # unsharded production step (stage2="split" matches the separate
    # audio-FIR + exact-IIR staging closest; deemph differs by the
    # truncated-FIR-vs-IIR form at <1e-9 — tolerance covers it)
    init_u, step_u, _ = make_wfm_step_fused(center_freq=25_000.0,
                                            stage2="split", **front)
    su = init_u()
    outs = []
    for _ in range(3):
        su, a = step_u(su, jnp.asarray(iq))
        outs.append(np.asarray(a))
    unsharded = np.concatenate(outs)

    err = sharded - unsharded
    rel = np.sqrt(np.mean(err ** 2)) / np.sqrt(np.mean(unsharded ** 2))
    assert rel < 1e-5, rel


def test_dryrun_multichip_entrypoint():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


# ---------------------------------------------------------------------------
# channel-axis sharding: channelizer + per-channel resampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [2, 4, 8])
def test_chan_sharded_channelizer_matches_unsharded(rng, D):
    from gnuradio_tpu.models.channelize import make_channelizer_step
    from gnuradio_tpu.models.channelize_sharded import make_channelizer_sharded

    fs, M = 1_024_000.0, 16
    mesh = make_mesh(n_time=1, n_chan=D)
    init_s, step_s, specs = make_channelizer_sharded(
        mesh, fs, M, resample_rate=0.75, nfilts=8)
    init_u, step_u, meta = make_channelizer_step(
        fs, M, resample_rate=0.75, nfilts=8)

    n = specs["in_multiple"] * 32
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    iq = np.stack([x.real, x.imag], axis=-1).astype(np.float32)

    st_s = jax.jit(init_s)()
    st_u = jax.jit(init_u)()
    outs_s, outs_u = [], []
    for k in range(3):  # multi-step: state carry must match too
        st_s, ys = step_s(st_s, jnp.asarray(iq))
        st_u, yu = step_u(st_u, jnp.asarray(x))
        ys = np.asarray(ys)
        outs_s.append(ys[..., 0] + 1j * ys[..., 1])
        outs_u.append(np.asarray(yu))
    got = np.concatenate(outs_s, axis=1)
    ref = np.concatenate(outs_u, axis=1)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_chan_sharded_channelizer_no_resampler(rng):
    from gnuradio_tpu.models.channelize import make_channelizer_step
    from gnuradio_tpu.models.channelize_sharded import make_channelizer_sharded

    fs, M, D = 512_000.0, 8, 4
    mesh = make_mesh(n_time=1, n_chan=D)
    init_s, step_s, specs = make_channelizer_sharded(
        mesh, fs, M, resample_rate=None)
    init_u, step_u, meta = make_channelizer_step(fs, M, resample_rate=None)
    n = specs["in_multiple"] * 64
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    iq = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    st_s = jax.jit(init_s)()
    st_u = jax.jit(init_u)()
    st_s, ys = step_s(st_s, jnp.asarray(iq))
    st_u, yu = step_u(st_u, jnp.asarray(x))
    ys = np.asarray(ys)
    got = ys[..., 0] + 1j * ys[..., 1]
    np.testing.assert_allclose(got, np.asarray(yu), rtol=2e-4, atol=2e-5)
