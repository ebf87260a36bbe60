"""Composed-runtime benchmark: the WBFM chain THROUGH TopBlock.run()
(host loop + compiled graph + sink collection) vs the bare step function
(VERDICT r02 weak #4 — the reference benches through its real scheduler,
gnuradio-runtime/examples/mp-sched/run_synthetic.py:24-43).

Two graph forms:
  * device-resident: noise_source -> wfm_rcv_full -> null_sink — the
    mp-sched analog (its sources are null/synthetic too); measures pure
    runtime overhead over the bare step.
  * host-fed: StreamSource(recorded IQ planes) -> chain -> vector_sink —
    the README quick-start shape; includes real host->device feeding.

Run: python benchmarks/bench_topblock.py   (needs a GPU)
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from benchmarks.bench_util import card_info, require_gpu, time_fn_carry


def bench_bare(n):
    import jax
    from jax import lax
    from gnuradio_tpu.models.wfm import make_wfm_step
    init, step, mult = make_wfm_step(1e6, 250e3, 50e3)

    @jax.jit
    def run(state, iqp):
        return step(state, lax.complex(iqp[:, 0], iqp[:, 1]))

    iq = jax.jit(lambda: 0.5 * jax.random.normal(
        jax.random.PRNGKey(0), (n, 2), dtype="float32"))()
    st = jax.jit(init)()
    dt = time_fn_carry(run, st, iq, iters=10)
    return {"probe": f"wfm_bare_n{n}", "dt_ms": round(dt * 1e3, 3),
            "msps": round(n / dt / 1e6, 1)}


def bench_topblock_device(n_per_step, steps=10, source="cycle"):
    """device_cycle_source (or noise) -> WfmRcvFull -> null_sink through
    TopBlock.run(). The cycle source reuses ONE device buffer per step —
    the exact analog of the bare-step bench (and of the reference mp-sched
    feeding from null_source), so (bare - this) is pure runtime overhead.
    source="noise" keeps the in-graph threefry generator for comparison."""
    import jax
    import numpy as np
    from gnuradio_tpu.core.runtime import TopBlock
    from gnuradio_tpu.models.wfm import WfmRcvFull
    from gnuradio_tpu.ops.analog import noise_source_c
    from gnuradio_tpu.ops.blocks import device_cycle_source, null_sink
    from gnuradio_tpu.core.stream import PortSpec, F

    if source == "noise":
        src = noise_source_c("gaussian", 0.5, seed=1)
    else:
        # learn the graph's exact per-step item count first so the cycle
        # buffer hits the L == n zero-copy path
        probe_tb = TopBlock(chunk_mult=None, target_items=n_per_step)
        probe_src = noise_source_c("gaussian", 0.5, seed=1)
        probe_tb.connect(probe_src, WfmRcvFull(1e6, 250e3, 50e3),
                         null_sink(F))
        n_exact = probe_tb.compile().n_out[probe_src][0]
        rng = np.random.default_rng(0)
        buf = (0.5 * (rng.standard_normal(n_exact)
                      + 1j * rng.standard_normal(n_exact))
               ).astype(np.complex64)
        src = device_cycle_source(buf)
    rcv = WfmRcvFull(1e6, 250e3, 50e3)
    snk = null_sink(F)
    tb = TopBlock(chunk_mult=None, target_items=n_per_step)
    tb.connect(src, rcv, snk)
    cg = tb.compile()
    n_in = cg.n_out[src][0]
    # warmup (compile + first dispatch)
    tb.run(n_steps=2)
    jax.block_until_ready(tb.state)
    t0 = time.perf_counter()
    tb.run(n_steps=steps)
    jax.block_until_ready(tb.state)
    dt = (time.perf_counter() - t0) / steps
    return {"probe": f"wfm_topblock_device_{source}_n{n_in}",
            "dt_ms": round(dt * 1e3, 3),
            "msps": round(n_in / dt / 1e6, 1)}


def bench_topblock_fed(n_per_step, steps=10):
    """StreamSource(host IQ) -> chain -> vector_sink via TopBlock (README
    quick-start shape; host feed + audio collection included)."""
    import jax
    from gnuradio_tpu.models.wfm import wfm_rcv_graph
    rng = np.random.default_rng(0)
    n_total = n_per_step * (steps + 2)
    iq = (0.5 * (rng.standard_normal(n_total)
                 + 1j * rng.standard_normal(n_total))).astype(np.complex64)
    tb, snk = wfm_rcv_graph(iq, chunk_mult=None)
    tb.target_items = n_per_step
    cg = tb.compile()
    src = cg.fed_sources[0]
    n_in = cg.n_out[src][0]
    tb.run(n_steps=2)
    jax.block_until_ready(tb.state)
    t0 = time.perf_counter()
    tb.run(n_steps=steps)
    jax.block_until_ready(tb.state)
    dt = (time.perf_counter() - t0) / steps
    return {"probe": f"wfm_topblock_fed_n{n_in}", "dt_ms": round(dt * 1e3, 3),
            "msps": round(n_in / dt / 1e6, 1)}


def main():
    require_gpu()
    print(card_info(), flush=True)
    for fn, kw in [
        (bench_bare, dict(n=1 << 24)),
        (bench_topblock_device, dict(n_per_step=1 << 24, steps=40)),
        (bench_topblock_device, dict(n_per_step=1 << 24, steps=40,
                                     source="noise")),
        (bench_topblock_fed, dict(n_per_step=1 << 22)),
    ]:
        t0 = time.time()
        try:
            r = fn(**kw)
        except Exception as e:
            import traceback
            r = {"probe": repr(kw), "error": traceback.format_exc()[-500:]}
        r["wall_s"] = round(time.time() - t0, 1)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
