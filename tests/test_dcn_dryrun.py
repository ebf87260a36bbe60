"""QA: the two-process DCN dryrun (benchmarks/dcn_dryrun.py) — transport
seam inside a sharded pipeline, run as real OS processes."""
import json
import os
import subprocess
import sys

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "dcn_dryrun.py")


def test_dcn_two_process_dryrun(tmp_path):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = tmp_path / "dcn.json"
    r = subprocess.run(
        [sys.executable, SCRIPT, "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    with open(out) as f:
        art = json.load(f)
    assert art["ok"] and art["tags_survived"]
    assert art["max_abs_err_vs_single_process"] < 1e-4
