"""QA: modtool scaffolding round-trip (the gr-utils/modtool/tests pattern:
scaffold, then the generated module must actually work)."""
import os
import subprocess
import sys

import numpy as np
import pytest

from gnuradio_tpu import modtool


def test_newmod_add_and_run(tmp_path):
    root = modtool.newmod("howto", str(tmp_path))
    assert root.endswith("gr_howto")
    qa = modtool.add("square_ff", root, kind="sync")
    # generated module imports and the generated block works
    sys.path.insert(0, str(tmp_path))
    try:
        import gr_howto  # noqa: F401
        from gr_howto.blocks import square_ff
        import jax
        from gnuradio_tpu import Flowgraph, TopBlock
        from gnuradio_tpu.ops import blocks as blk
        x = np.arange(32, dtype=np.float32)
        src = blk.vector_source(x)
        snk = blk.vector_sink_f()
        fg = Flowgraph()
        fg.connect(src, square_ff(), snk)
        TopBlock(fg).run()
        np.testing.assert_allclose(snk.data(), x * x)
    finally:
        sys.path.remove(str(tmp_path))
    info = modtool.info(root)
    assert "SquareFf" in info["classes"]
    assert "square_ff" in info["factories"]


def test_blocktool_describe_and_makeyaml():
    d = modtool.describe_block("gnuradio_tpu.ops.filter:fir_filter_fff")
    assert d["name"] == "fir_filter_fff"
    names = [p["name"] for p in d["parameters"]]
    assert "decim" in names or "decimation" in names or len(names) >= 1
    y = modtool.makeyaml("gnuradio_tpu.ops.analog:quadrature_demod_cf")
    assert "id: quadrature_demod_cf" in y
    assert "parameters:" in y


def test_modtool_cli(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "gnuradio_tpu.modtool", "newmod", "cli",
         "--dir", str(tmp_path)],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "gr_cli" / "blocks.py").exists()


def test_modtool_rm_rename_disable_update(tmp_path):
    """modtool rm / rename / disable / update
    (gr-utils/modtool/core/{rm,rename,disable,update}.py analogs)."""
    from gnuradio_tpu import modtool as M
    root = M.newmod("lifecycle", str(tmp_path))
    M.add("alpha_blk", root)
    M.add("beta_blk", root)
    meta = M.info(root)
    assert "alpha_blk" in meta["factories"]
    # rename alpha -> gamma
    changed = M.rename("alpha_blk", "gamma_blk", root)
    assert changed
    meta = M.info(root)
    assert "gamma_blk" in meta["factories"]
    assert "alpha_blk" not in meta["factories"]
    import os
    assert os.path.exists(os.path.join(root, "tests", "qa_gamma_blk.py"))
    # rm beta
    removed = M.rm("beta_blk", root)
    assert removed
    meta = M.info(root)
    assert "beta_blk" not in meta["factories"]
    # disable gamma: module still parses, factory commented out
    M.disable("gamma_blk", root)
    meta = M.info(root)
    assert "gamma_blk" not in meta["factories"]
    # update regenerates the descriptor file from what's left
    res = M.update(root)
    assert os.path.exists(res["path"])
