"""The port's collective census against the JAX package's: one synthetic
list of collectives, rendered as the reference's post-SPMD HLO lines and
as the port's recorder log, gives equal `collective_stats`; and on a fake
256-rank group a ``Shard`` x ``Replicate`` product logs the one
all-gather its redistribute issues."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed.collectives import (Collective,  # noqa: E402
                                                 collective_stats,
                                                 summarize,
                                                 total_collective_bytes)

ROOT = Path(__file__).resolve().parents[1]
_BYTES = {"f32": 4, "bf16": 2, "s32": 4}
# (kind, dtype, result shape, group size or None for no replica_groups,
#  group form: "list" {{0,1,..}} or "iota" [n,g]<=[N])
SYNTHETIC = [
    ("all-reduce", "f32", (1024, 512), 16, "iota"),
    ("all-reduce", "bf16", (8, 4096), 4, "list"),
    ("all-gather", "bf16", (4096, 768), 16, "iota"),
    ("reduce-scatter", "f32", (256, 4096), 16, "iota"),
    ("all-to-all", "bf16", (32, 128, 64), 8, "list"),
    ("collective-permute", "f32", (128, 128), None, None),
    ("all-gather", "s32", (512,), 2, "list"),
]


def _hlo_line(i, kind, dt, shape, group, form):
    ty = f"{dt}[{','.join(map(str, shape))}]{{{','.join(map(str, range(len(shape) - 1, -1, -1)))}}}"
    if form == "list":
        groups = ", replica_groups={{" + ",".join(map(str, range(group))) + "}}"
    elif form == "iota":
        groups = f", replica_groups=[{256 // group},{group}]<=[256]"
    else:
        groups = ", source_target_pairs={{0,1},{1,0}}"
    return (f"  %{kind}.{i} = {ty} {kind}({ty} %p{i}), channel_id={i}"
            f"{groups}")


def test_stats_match_reference_on_synthetic_collectives():
    pytest.importorskip("jax")
    from repro.distributed import collectives as JC
    hlo = "\n".join(["HloModule m", "ENTRY %main {"] + [
        _hlo_line(i, *c) for i, c in enumerate(SYNTHETIC)] + ["}"])
    log = [Collective(kind, int(np.prod(shape)) * _BYTES[dt], group or 2)
           for kind, dt, shape, group, _ in SYNTHETIC]
    want = JC.collective_stats(hlo)
    got = collective_stats(log)
    assert got == want
    assert total_collective_bytes(log) == JC.total_collective_bytes(hlo)
    assert summarize(got) == JC.summarize(want)


_FAKE_GROUP = r"""
import json, torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.distributed.collectives import CollectiveRecorder
from repro_torch.launch.mesh import make_production_mesh
mesh = make_production_mesh()
def dt(shape, pl):
    local = list(shape)
    for p in pl:
        if isinstance(p, Shard):
            local[p.dim] //= 16
    return DTensor.from_local(torch.empty(local, device="meta"), mesh, pl,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())
x = dt((256, 4096), [Shard(0), Replicate()])
w = dt((4096, 12288), [Replicate(), Shard(1)])
with CollectiveRecorder() as rec:
    y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
print(json.dumps([list(c) for c in rec.log] + [list(y.to_local().shape)]))
"""


def test_recorder_logs_the_all_gather_of_a_redistribute():
    """[256, 4096] rows on ``data`` x [4096, 12288] columns on ``model``:
    the product is column-sharded, and gathering its columns is one
    all-gather over the 16 ranks of ``model`` whose result is the local
    [16, 12288] float32 rows."""
    out = subprocess.run([sys.executable, "-c", _FAKE_GROUP], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    *log, local = json.loads(out.stdout.strip().splitlines()[-1])
    assert local == [16, 12288]
    assert log == [["all-gather", 16 * 12288 * 4, 16]]
