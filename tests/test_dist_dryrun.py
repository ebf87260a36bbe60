"""Two-process jax.distributed dryrun QA: one shard_map program whose
ppermute/psum collectives span an OS process boundary — the replacement for
the reference's gr-zeromq multi-host seam (gr-zeromq/lib/base_impl.cc:38-80)."""
import json
import os
import subprocess
import sys

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "dist_dryrun.py")


def test_dist_two_process_wfm(tmp_path):
    out = tmp_path / "dist.json"
    r = subprocess.run([sys.executable, SCRIPT, str(out)],
                       capture_output=True, timeout=580)
    assert r.returncode == 0, r.stdout[-2000:]
    res = json.load(open(out))
    assert res["ok"], res
    assert res["process0"]["process_count"] == 2
    assert res["cross_process_sums_agree"]
    assert res["process0"]["max_rel_err_sum"] < 1e-4
