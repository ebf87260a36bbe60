"""Shared benchmark utilities: device peak table, timing, roofline report.

Every number these helpers produce is a device measurement, so scripts
start with `require_gpu`, which refuses to run without GPUs and applies the
compile-cache rule (`gnuradio_tpu.utils.compile_cache`). Roofline shares are
computed against the peaks of the card JAX reports (`peaks`), never a
default.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from gnuradio_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

# Published peaks, keyed by jax.devices()[0].device_kind. Source: NVIDIA H100
# Tensor Core GPU datasheet, SXM5 part, dense rates without sparsity, at the
# full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "source": "NVIDIA H100 datasheet (SXM5), dense, 700 W",
        "fp32_tflops": 67.0,
        "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
        "hbm_gbps": 3350.0,
        "nvlink_gbps": 900.0,
    },
}


def peaks(device_kind: str) -> dict:
    """Peak table entry for a device kind; unknown kinds raise KeyError."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       "add the card to benchmarks/bench_util.PEAKS with "
                       "its source") from None


def require_gpu(count: int = 1):
    """The jax devices, after checking that at least `count` GPUs are
    visible; also sets up the persistent compile cache."""
    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: jax backend is {jax.default_backend()!r}")
    devices = jax.devices()
    if len(devices) < count:
        raise SystemExit(f"need {count} GPUs, found {len(devices)}")
    setup_compile_cache()
    return devices


def card_info() -> str:
    """`name, power.limit` of each card, one line per card, as nvidia-smi
    reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"
    return out or "nvidia-smi printed nothing"


def time_fn(fn, *args, iters: int = 20, warmup: int = 2):
    """Mean wall time per call of a jitted fn, in seconds."""
    import jax
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def time_fn_carry(fn, state, x, iters: int = 20, warmup: int = 2):
    """Time a step fn with carried state: fn(state, x) -> (state, y)."""
    import jax
    y = None
    for _ in range(warmup):
        state, y = fn(state, x)
    jax.block_until_ready((state, y))
    t0 = time.perf_counter()
    for _ in range(iters):
        state, y = fn(state, x)
    jax.block_until_ready((state, y))
    return (time.perf_counter() - t0) / iters


def xla_bytes_accessed(jitted, *args):
    """Per-execution device-memory traffic of a jitted fn from XLA's
    compiled cost model ('bytes accessed' over the optimized HLO — includes
    every intermediate materialization). None if the backend has none."""
    try:
        ca = jitted.lower(*args).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        return float(ca["bytes accessed"])
    except Exception:
        return None


def roofline_report(name, msps, flops_per_sample, bytes_per_sample,
                    bytes_accessed=None, n_per_step=None):
    """Achieved FLOP/s and bytes/s as shares of the card's published fp32
    and HBM peaks. bytes_per_sample is the MINIMUM stream traffic; pass
    bytes_accessed (xla_bytes_accessed) + n_per_step to also report the
    cost model's per-step traffic, which hbm_pct then uses."""
    import jax
    kind = jax.devices()[0].device_kind
    pk = peaks(kind)
    gflops = msps * 1e6 * flops_per_sample / 1e9
    stream_gbps = msps * 1e6 * bytes_per_sample / 1e9
    rep = {
        "name": name,
        "device_kind": kind,
        "msps": msps,
        "useful_gflops": gflops,
        "stream_gbps_min": stream_gbps,
        "fp32_pct": 100 * gflops / (pk["fp32_tflops"] * 1e3),
    }
    gbps, src = stream_gbps, "min_stream_bytes"
    if bytes_accessed is not None and n_per_step:
        gbps = bytes_accessed * (msps * 1e6 / n_per_step) / 1e9
        rep["hbm_gbps_xla"] = gbps
        rep["hbm_bytes_per_step_xla"] = int(bytes_accessed)
        src = "xla_cost_analysis"
    rep["hbm_pct"] = 100 * gbps / pk["hbm_gbps"]
    rep["hbm_traffic_source"] = src
    return rep
