#!/usr/bin/env python3
"""Smoke test of the system's main paths on NVIDIA GPUs, in one process.

    python chip_smoke.py             # one card: all single-card phases
    python chip_smoke.py --chips 4   # the sharded paths on four cards only

Single-card phases:
  device      backend must be "gpu"; prints device_kind and the card's
              `name, power.limit` from nvidia-smi.
  wbfm_graph  WBFM receiver (models/wfm.wfm_rcv_graph) through TopBlock on a
              2^23-sample synthetic FM capture (1 kHz tone, 75 kHz
              deviation) in several steps; audio length n // 20 and tone
              SNR >= 80 dB.
  wbfm_step   the production WBFM step (models/wfm.make_wfm_step_fused,
              split stage 2, I/Q planes) at 2^25 samples per step (rounded
              down to whole output samples), 3 carried
              steps, for each front ("xla", and the compiled Triton kernel),
              against the plain reference chain make_wfm_step at HIGHEST
              matmul precision; max error <= 2e-4 of full scale past the
              64-sample start transient. The two fronts are also compared
              with each other alone at the same widths.
  channelizer make_channelizer_step (64 channels, 6.4 Msps, 0.9375 arb
              resampler) at 2^22 samples per step, 3 carried steps, against
              channelize_graph through TopBlock on the same input; max
              relative error <= 1e-4.

--chips 4 runs only the time-sharded WBFM (models/wfm_sharded.py) and the
channel-sharded channelizer (models/channelize_sharded.py) on a 4-card mesh
for 3 carried steps each, compared with their 1-device results.

Each phase prints its wall time and the cold and warm compile time of its
jitted step. Any failed check or exception exits non-zero, and the result
line is printed only after every phase passed. The last line of standard
output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks.bench_util import (card_info, require_gpu,  # noqa: E402
                                   time_fn, time_fn_carry)

FS, QUAD, AUDIO = 1_000_000.0, 250_000.0, 50_000.0
TONE, DEV, AMP = 1000.0, 75_000.0, 0.7
WBFM_GRAPH_N = 1 << 23
WBFM_STEP_N = 1 << 25
CHAN_FS, CHAN_M, CHAN_RATE = 6_400_000.0, 64, 0.9375
CHAN_STEP_N = 1 << 22
STEPS = 3
SKIP = 64            # WBFM start transient excluded from comparisons
WBFM_TOL = 2e-4      # max |err| / full scale (tests/test_wfm_fused.py)
CHAN_TOL = 1e-4      # max |err| / max |ref|
SNR_MIN_DB = 80.0


class CheckFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    log(f"  check {'PASS' if ok else 'FAIL'}: {what}")
    if not ok:
        raise CheckFailed(what)


def compile_step(fn, *args):
    """(compiled, cold_s, warm_s): compile twice with the in-memory caches
    cleared in between, so the second compile is served by the persistent
    cache when the first was written to it. "cold" is itself a cache hit
    when an earlier process in this checkout wrote the entry."""
    import jax
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    cold = time.perf_counter() - t0
    jax.clear_caches()
    t0 = time.perf_counter()
    fn.lower(*args).compile()
    warm = time.perf_counter() - t0
    return compiled, cold, warm


def run_steps(compiled, state, xs):
    """Carried steps; returns (state, [outputs as numpy])."""
    import jax
    outs = []
    for x in xs:
        state, y = compiled(state, x)
        outs.append(np.asarray(jax.device_get(y)))
    return state, outs


def fm_tone_iq(n: int) -> np.ndarray:
    """Synthetic FM capture: 1 kHz tone at AMP * 75 kHz peak deviation."""
    t = np.arange(n) / FS
    phase = AMP * DEV / TONE * (1.0 - np.cos(2 * np.pi * TONE * t))
    return np.exp(1j * phase).astype(np.complex64)


def fm_tone_planes_device(n: int, seed: int):
    """(2, n) f32 I/Q planes of the same FM tone plus -40 dB noise, made on
    the device (the tone period is an integer 1000 samples, so the phase is
    exact in f32)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def make():
        k = jnp.arange(n, dtype=jnp.int32) % int(FS / TONE)
        s = (2 * np.pi / (FS / TONE)) * k.astype(jnp.float32)
        phase = (AMP * DEV / TONE) * (1.0 - jnp.cos(s))
        noise = 0.01 * jax.random.normal(jax.random.PRNGKey(seed), (2, n),
                                         jnp.float32)
        return jnp.stack([jnp.cos(phase), jnp.sin(phase)]) + noise
    return make()


def tone_snr_db(audio: np.ndarray, start: int = 2000) -> float:
    y = np.asarray(audio[start:], np.float64)
    t = np.arange(start, start + len(y)) / AUDIO
    A = np.stack([np.sin(2 * np.pi * TONE * t), np.cos(2 * np.pi * TONE * t),
                  np.ones_like(t)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    fit = A @ coef
    resid = y - fit
    return 10 * np.log10(np.sum((fit - coef[2]) ** 2) / np.sum(resid ** 2))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(n_cards: int) -> dict:
    """Exits (non-zero) unless n_cards GPUs are visible; sets up the compile
    cache; prints device kind and each card's `name, power.limit`."""
    devs = require_gpu(n_cards)
    d = devs[0]
    log(f"device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    for line in card_info().splitlines():
        log(f"card: {line}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def phase_wbfm_graph(n: int = WBFM_GRAPH_N, chunk_mult: int = 1 << 16):
    from gnuradio_tpu.models.wfm import wfm_rcv_graph
    iq = fm_tone_iq(n)
    tb, snk = wfm_rcv_graph(iq, FS, QUAD, AUDIO, chunk_mult=chunk_mult)
    cg = tb.compile()
    steps = math.ceil(n / cg.n_out[cg.order[0]][0])
    t0 = time.perf_counter()
    tb.run()
    wall = time.perf_counter() - t0
    out = snk.data()
    log(f"  wbfm_graph: n={n} steps={steps} wall_s={wall:.3f} "
        "(compile included)")
    check(len(out) == n // 20, f"audio length {len(out)} == {n // 20}")
    check(bool(np.all(np.isfinite(out))), "audio finite")
    snr = tone_snr_db(out)
    check(snr >= SNR_MIN_DB, f"tone SNR {snr:.2f} dB >= {SNR_MIN_DB} dB")


def _max_rel(got, ref) -> float:
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12))


def phase_wbfm_step(n: int = WBFM_STEP_N, fronts=("xla", "triton"),
                    interpret: bool = False):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from gnuradio_tpu.models.wfm import make_wfm_step, make_wfm_step_fused

    init_r, step_r, mult = make_wfm_step(FS, QUAD, AUDIO)
    n = (n // mult) * mult               # whole output samples per step
    xs = [fm_tone_planes_device(n, seed) for seed in range(STEPS)]
    with jax.default_matmul_precision("highest"):
        ref_fn = jax.jit(lambda s, p: step_r(s, lax.complex(p[0], p[1])))
        comp_r, cold, warm = compile_step(ref_fn, init_r(), xs[0])
    t0 = time.perf_counter()
    _, ref = run_steps(comp_r, init_r(), xs)
    ref = np.concatenate(ref)
    log(f"  wbfm_reference: n={n} steps={STEPS} compile_cold_s={cold:.3f} "
        f"compile_warm_s={warm:.3f} wall_s={time.perf_counter() - t0:.3f}")
    check(ref.shape == (STEPS * (n // mult),)
          and bool(np.all(np.isfinite(ref))),
          f"reference audio shape {ref.shape}, finite")

    for front in fronts:
        init_f, step_f, _ = make_wfm_step_fused(
            FS, QUAD, AUDIO, front=front, interpret=interpret,
            layout="planes", stage2="split")
        comp, cold, warm = compile_step(jax.jit(step_f), init_f(), xs[0])
        t0 = time.perf_counter()
        _, got = run_steps(comp, init_f(), xs)
        wall = time.perf_counter() - t0
        got = np.concatenate(got)
        per_step = time_fn_carry(comp, init_f(), xs[0], iters=10)
        log(f"  wbfm_step[{front}]: n={n} steps={STEPS} "
            f"compile_cold_s={cold:.3f} compile_warm_s={warm:.3f} "
            f"wall_s={wall:.3f} step_ms={per_step * 1e3:.4f}")
        check(got.shape == ref.shape and bool(np.all(np.isfinite(got))),
              f"[{front}] audio shape {got.shape}, finite")
        err = _max_rel(got[SKIP:], ref[SKIP:])
        check(err <= WBFM_TOL,
              f"[{front}] vs reference max err {err:.3e} of full scale "
              f"<= {WBFM_TOL} (reference at HIGHEST precision)")

    if len(fronts) > 1:
        from gnuradio_tpu.kernels.wfm_front import WfmFront
        from gnuradio_tpu.models.wfm import channel_taps
        fr = WfmFront(channel_taps(FS, QUAD), 0.0, FS, int(FS // QUAD),
                      QUAD / (2 * math.pi * DEV))
        xq = jnp.concatenate([jnp.zeros((2, fr.history), jnp.float32),
                              xs[0]], axis=1)
        outs = {}
        for front in fronts:
            fn = jax.jit(lambda a, b, f=front: fr(a, b, impl=f,
                                                  interpret=interpret))
            comp, _, _ = compile_step(fn, xq[0], xq[1])
            outs[front] = np.asarray(comp(xq[0], xq[1]))
            t = time_fn(comp, xq[0], xq[1], iters=10)
            log(f"  wbfm_front[{front}]: n={n} front_ms={t * 1e3:.4f}")
        base = outs[fronts[0]]
        for front in fronts[1:]:
            err = _max_rel(outs[front][1:], base[1:])
            check(err <= WBFM_TOL,
                  f"front {front} vs {fronts[0]} max err {err:.3e} of full "
                  f"scale <= {WBFM_TOL}")


def phase_channelizer(n: int = CHAN_STEP_N, fs: float = CHAN_FS,
                      nchans: int = CHAN_M, rate: float = CHAN_RATE,
                      graph_chunk_mult: int = 1024):
    import jax
    import jax.numpy as jnp
    from gnuradio_tpu.models.channelize import (channelize_graph,
                                                make_channelizer_step)

    init, step, meta = make_channelizer_step(fs, nchans, rate)
    n = (n // meta["in_multiple"]) * meta["in_multiple"]
    rng = np.random.default_rng(1)
    x = (0.5 * (rng.standard_normal(STEPS * n)
                + 1j * rng.standard_normal(STEPS * n))).astype(np.complex64)
    xs = [jnp.asarray(x[k * n:(k + 1) * n]) for k in range(STEPS)]
    with jax.default_matmul_precision("highest"):
        comp, cold, warm = compile_step(jax.jit(step), init(), xs[0])
    t0 = time.perf_counter()
    _, got = run_steps(comp, init(), xs)
    wall = time.perf_counter() - t0
    got = np.concatenate(got, axis=1)
    per_step = time_fn_carry(comp, init(), xs[0], iters=10)
    log(f"  channelizer_step: n={n} nchans={nchans} rate={rate} "
        f"steps={STEPS} compile_cold_s={cold:.3f} compile_warm_s={warm:.3f} "
        f"wall_s={wall:.3f} step_ms={per_step * 1e3:.4f}")

    with jax.default_matmul_precision("highest"):
        tb, sinks = channelize_graph(x, fs, nchans, rate,
                                     chunk_mult=graph_chunk_mult)
        t0 = time.perf_counter()
        tb.run()
        wall = time.perf_counter() - t0
    ref = [np.asarray(s.data()) for s in sinks]
    log(f"  channelizer_graph: n={STEPS * n} wall_s={wall:.3f} "
        "(compile included)")
    check(all(len(r) == got.shape[1] for r in ref),
          f"graph lengths {sorted({len(r) for r in ref})} == "
          f"step length {got.shape[1]}")
    ref = np.stack(ref)
    check(bool(np.all(np.isfinite(got))), "step output finite")
    err = _max_rel(got, ref)
    check(err <= CHAN_TOL, f"step vs graph max rel err {err:.3e} <= "
          f"{CHAN_TOL} (HIGHEST precision)")


def phase_sharded(n_cards: int, wbfm_n: int = WBFM_STEP_N,
                  chan_n: int = CHAN_STEP_N, interpret: bool = False):
    import jax
    import jax.numpy as jnp
    from gnuradio_tpu.models.channelize import make_channelizer_step
    from gnuradio_tpu.models.channelize_sharded import make_channelizer_sharded
    from gnuradio_tpu.models.wfm import make_wfm_step_fused
    from gnuradio_tpu.models.wfm_sharded import make_wfm_sharded_fused
    from gnuradio_tpu.parallel.mesh import make_mesh

    dev0 = jax.devices()[0]

    # -- time-sharded WBFM vs the 1-device production step -------------------
    mesh = make_mesh(n_time=n_cards)
    init_s, step_s, specs = make_wfm_sharded_fused(mesh, FS, QUAD, AUDIO,
                                                   interpret=interpret)
    n = (wbfm_n // specs["in_multiple"]) * specs["in_multiple"]
    planes = [fm_tone_planes_device(n, seed) for seed in range(STEPS)]
    xs = [jax.device_put(p.T, specs["in_sharding"]) for p in planes]
    with jax.default_matmul_precision("highest"):
        comp, cold, warm = compile_step(step_s, init_s(), xs[0])
    t0 = time.perf_counter()
    _, got = run_steps(comp, init_s(), xs)
    log(f"  wbfm_sharded: cards={n_cards} n={n} steps={STEPS} "
        f"compile_cold_s={cold:.3f} compile_warm_s={warm:.3f} "
        f"wall_s={time.perf_counter() - t0:.3f}")
    init_u, step_u, _ = make_wfm_step_fused(FS, QUAD, AUDIO, layout="planes",
                                            stage2="split",
                                            interpret=interpret)
    with jax.default_matmul_precision("highest"):
        comp_u, _, _ = compile_step(jax.jit(step_u), init_u(),
                                    jax.device_put(planes[0], dev0))
    _, ref = run_steps(comp_u, init_u(),
                       [jax.device_put(p, dev0) for p in planes])
    got, ref = np.concatenate(got), np.concatenate(ref)
    check(got.shape == ref.shape, f"sharded WBFM shape {got.shape}")
    rel = float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))
    check(rel < 1e-5, f"sharded vs 1-device WBFM rel rms {rel:.3e} < 1e-5")

    # -- channel-sharded channelizer vs the 1-device step --------------------
    mesh_c = make_mesh(n_time=1, n_chan=n_cards)
    init_c, step_c, specs_c = make_channelizer_sharded(mesh_c, CHAN_FS,
                                                       CHAN_M, CHAN_RATE)
    n = (chan_n // specs_c["in_multiple"]) * specs_c["in_multiple"]
    rng = np.random.default_rng(2)
    x = (0.5 * (rng.standard_normal(STEPS * n)
                + 1j * rng.standard_normal(STEPS * n))).astype(np.complex64)
    iq = np.stack([x.real, x.imag], -1)
    xs = [jax.device_put(iq[k * n:(k + 1) * n], specs_c["in_sharding"])
          for k in range(STEPS)]
    with jax.default_matmul_precision("highest"):
        comp, cold, warm = compile_step(step_c, jax.jit(init_c)(), xs[0])
    t0 = time.perf_counter()
    _, got = run_steps(comp, jax.jit(init_c)(), xs)
    log(f"  channelizer_sharded: cards={n_cards} n={n} steps={STEPS} "
        f"compile_cold_s={cold:.3f} compile_warm_s={warm:.3f} "
        f"wall_s={time.perf_counter() - t0:.3f}")
    got = np.concatenate([g[..., 0] + 1j * g[..., 1] for g in got], axis=1)
    init_u, step_u, _ = make_channelizer_step(CHAN_FS, CHAN_M, CHAN_RATE)
    with jax.default_matmul_precision("highest"):
        xs_u = [jax.device_put(x[k * n:(k + 1) * n], dev0)
                for k in range(STEPS)]
        comp_u, _, _ = compile_step(jax.jit(step_u), init_u(), xs_u[0])
    _, ref = run_steps(comp_u, init_u(), xs_u)
    ref = np.concatenate(ref, axis=1)
    check(got.shape == ref.shape, f"sharded channelizer shape {got.shape}")
    err = _max_rel(got, ref)
    check(err <= CHAN_TOL,
          f"sharded vs 1-device channelizer max rel err {err:.3e} "
          f"<= {CHAN_TOL}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded paths on four cards")
    args = ap.parse_args(argv)

    device = phase_device(args.chips)
    import jax
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    if args.chips == 4:
        phases = [("sharded", lambda: phase_sharded(4))]
    else:
        phases = [("wbfm_graph", phase_wbfm_graph),
                  ("wbfm_step", phase_wbfm_step),
                  ("channelizer", phase_channelizer)]
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except CheckFailed as e:
            log(f"phase {name} FAILED: {e}")
            return 1
        except Exception:
            import traceback
            traceback.print_exc()
            log(f"phase {name} FAILED with an exception")
            return 1
        log(f"phase {name} done in {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
