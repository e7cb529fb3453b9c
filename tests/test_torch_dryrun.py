"""The port's dry-run (`repro_torch.launch.dryrun`), mirroring
`tests/test_dryrun.py`: one real cell through the 256- and 512-rank fake
groups, and the step inputs as storage-free stand-ins.

The CLI runs in a subprocess: it starts a fake process group, which must
not meet the test session's."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def test_dryrun_one_cell_both_meshes(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", "starcoder2-3b", "--shape", "decode_32k",
           "--both-meshes", "--artifact", "full", "--out", str(tmp_path)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    for mesh in ("16x16", "2x16x16"):
        f = tmp_path / f"starcoder2-3b__decode_32k__{mesh}__full.json"
        res = json.loads(f.read_text())
        assert res["devices"] == (512 if mesh == "2x16x16" else 256)
        assert res["cost_analysis"]["flops"] > 0
        assert "temp_size_in_bytes" in res["memory_analysis"]
        assert res["fits"] and res["hbm_bytes"] == 80 * 2 ** 30
        # decode under tp: the partial sums of the sharded d_ff and vocab
        assert res["collectives"]["all-reduce"]["count"] > 0


def test_input_specs_are_abstract():
    """`abstract` allocates nothing: every leaf is a meta tensor (no
    storage), at the global shape."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.models import input_defs
    from repro_torch.models.layers import abstract, tree_leaves_with_path
    cfg = get_config("llama3-405b")
    specs = abstract(input_defs(cfg, get_shape("train_4k")),
                     cfg.compute_dtype)
    for _, leaf in tree_leaves_with_path(specs):
        assert leaf.device.type == "meta"
    assert specs["tokens"].shape == (256, 4096)
    assert specs["tokens"].dtype == torch.int32
