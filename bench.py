"""Headline benchmark: WBFM receive chain throughput on one GPU.

Measures input Msamples/s through the production step
(models/wfm.make_wfm_step_fused: channel-select complex FIR (107 taps,
decim 4) + quadrature demod as one front stage -> 215-tap audio FIR (decim
5) -> deemphasis as a truncated FIR at audio rate), steady state, on
device-resident input (like the reference's mp-sched synthetic, which
sources from null_source). 2^25 input samples per step, rounded down to
whole output samples.

    python bench.py [--front xla|triton]

Accounting:
  * vs_baseline — achieved useful GFLOPS / 14.4 GFLOPS, the reference's best
    saturated mp-sched figure (BASELINE.md; the only published reference
    throughput).
  * fp32_pct / hbm_pct — against the card's published fp32 and HBM peaks
    (benchmarks/bench_util.PEAKS, keyed by device_kind); hbm_pct uses XLA's
    cost-model bytes for the compiled step.

Prints the card's `name, power.limit`, then ONE JSON line.
"""
import argparse
import json
import time

from benchmarks.bench_util import (card_info, require_gpu, roofline_report,
                                   xla_bytes_accessed)

# chain FLOP model (per input sample, complex MAC = 8 real FLOPs):
# stage1 complex-tap FIR: 107 taps * 8 / decim4 = 214; rotator ~4;
# quad demod (conj-mult 6 + atan2 ~20) / 4 = 6.5; audio FIR 215*2/10 = 21.5;
# deemph ~0.2  => ~246 useful FLOPs / input sample
FLOPS_PER_SAMPLE = 246.0
BYTES_PER_SAMPLE = 8.2          # f32 IQ planes in + audio out (min traffic)
REF_GFLOPS = 14.4               # reference mp-sched best saturated (BASELINE.md)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--front", default="triton", choices=("xla", "triton"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    devices = require_gpu()
    import jax
    import jax.numpy as jnp
    from gnuradio_tpu.models.wfm import make_wfm_step_fused

    print(card_info(), flush=True)
    init_state, step, mult = make_wfm_step_fused(
        1_000_000.0, 250_000.0, 50_000.0, front=args.front, layout="planes",
        stage2="split")
    n = ((1 << 25) // mult) * mult

    run = jax.jit(step)   # input is (2, n) f32 IQ planes, channel-major

    @jax.jit
    def make_input():
        return 0.5 * jax.random.normal(jax.random.PRNGKey(0), (2, n),
                                       jnp.float32)

    iq = make_input()
    state = init_state()
    t0 = time.perf_counter()
    state, audio = run(state, iq)
    jax.block_until_ready((state, audio))
    first_call_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.iters):
        state, audio = run(state, iq)
    jax.block_until_ready((state, audio))
    dt = (time.perf_counter() - t0) / args.iters

    msps = n / dt / 1e6
    rep = roofline_report("wbfm_chain", msps, FLOPS_PER_SAMPLE,
                          BYTES_PER_SAMPLE,
                          xla_bytes_accessed(run, state, iq), n)
    out = {
        "metric": "wbfm_chain_throughput",
        "value": msps,
        "unit": "Msamples/s/device",
        "vs_baseline": rep["useful_gflops"] / REF_GFLOPS,
        "step_ms": dt * 1e3,
        "first_call_s": first_call_s,
        "front": args.front,
        "samples_per_step": n,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        **{k: rep[k] for k in ("fp32_pct", "hbm_pct", "hbm_traffic_source")},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
