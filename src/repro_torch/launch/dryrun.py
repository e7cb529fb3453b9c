"""Dry-run of every (arch x shape x mesh) cell on the production meshes;
port of `repro.launch.dryrun`.

The reference lowers and compiles each cell's step for 512 placeholder
TPU devices. Here each cell's step runs once, eagerly, as rank 0 of a
16x16 or 2x16x16 ``DeviceMesh`` over a fake process group of 256 or 512
ranks (`launch.mesh.make_production_mesh`; its collectives move
nothing), on meta tensors (shapes, dtypes, no storage) placed as
DTensors. Nothing is allocated on any device. Meta tensors, not
``FakeTensorMode``: a fake tensor's dispatch costs several times a meta
tensor's here, and neither holds data. The mesh is on the card's device
type when one is present (``cuda``), else the CPU's. While the step
runs, three dispatch modes watch rank 0's local shards:

* flops: the matrix-product flops of every local op
  (``torch.utils.flop_counter``'s formulas), so **per rank**, as the
  reference's post-SPMD numbers are per chip; elementwise work is not
  counted;
* memory: ``MemTracker``'s peak above the arguments (``temp``), beside
  the local arguments (params, optimizer state, batch) and outputs;
* collectives: `distributed.collectives.CollectiveRecorder`, every
  collective DTensor issues, each layer's.

Per cell we produce two artifacts, as the reference:

* ``full`` — the real step (blocked attention, remat, microbatching):
  the fits-in-memory check against one 80 GiB H100 (``fits``) and the
  collective schedule. Every layer runs; of the microbatches the first
  `TRACED_MICRO` run and the others are counted as repeats of the last
  (the same program on the same shapes: the reference's scan, whose
  body XLA counts once).
* ``cost`` — unrolled 1-unit and 2-unit steps (no remat, no
  microbatching): the per-unit difference scaled by depth. The port
  traces eagerly, so it also runs the same unrolled step at full depth
  (``full_depth``), the direct count the scaled total must agree with.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \
      --shape train_4k [--multi-pod] [--artifact both] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
Run it in a process of its own: it starts a fake process group.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import (applicable_shapes, get_config, get_shape,
                                 list_archs)
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed.collectives import (CollectiveRecorder,
                                                 _has_dtensor,
                                                 collective_stats, summarize)
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_step
from repro_torch.models.types import ApplyOptions

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"
# one H100's device memory, the fits check's budget
HBM_BYTES = 80 * 2 ** 30


def train_config_for(cfg: ModelConfig, shape: ShapeConfig) -> TrainConfig:
    """Memory-fitting knobs per arch size, the reference's: microbatching
    bounds the saved activations, bf16 moments and accumulators keep the
    40B+ archs small."""
    params_b = cfg.param_count() / 1e9
    if params_b > 100:  # llama3-405b
        # microbatch must stay >= the batch-sharding factor (32 on the
        # multi-pod mesh) or the microbatch loses its batch sharding
        return TrainConfig(microbatch=32, moment_dtype="bfloat16",
                           accum_dtype="bfloat16")
    if params_b > 20:  # phi3.5-moe-42b, jamba-52b
        return TrainConfig(microbatch=32, moment_dtype="bfloat16")
    return TrainConfig(microbatch=32)


def _opts_for(artifact: str, cfg: ModelConfig) -> ApplyOptions:
    """The reference lowers the plain blocked attention and the chunked
    scan, so the port does too."""
    if artifact == "cost":
        return ApplyOptions(attn_impl="blocked", block_q=2048, unroll=True,
                            scan_layers=False, scan_impl="chunked")
    return ApplyOptions(attn_impl="blocked", block_q=512, unroll=False,
                        scan_layers=True, scan_impl="chunked")


def _cost_cfg(cfg: ModelConfig, repeats: int) -> ModelConfig:
    """Unrolled shallow config for the cost artifact."""
    kw = dict(num_layers=repeats * len(cfg.pattern), remat="none")
    if cfg.mamba:
        kw["mamba"] = dataclasses.replace(cfg.mamba, chunk=2048)
    if cfg.xlstm:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, chunk=2048)
    return dataclasses.replace(cfg, **kw)


def input_specs(arch: str, shape_name: str):
    """Storage-free stand-ins for every model input of this cell."""
    from repro_torch.models import input_defs
    from repro_torch.models.layers import abstract
    cfg = get_config(arch)
    return abstract(input_defs(cfg, get_shape(shape_name)),
                    cfg.compute_dtype)


# ---------------------------------------------------------------------------
# What rank 0 does: flops, memory
# ---------------------------------------------------------------------------


class LocalFlops(TorchDispatchMode):
    """Matrix-product flops of the local ops: DTensor desugars each op
    first, and the ops of its global-shape propagation (run under a
    ``FakeTensorMode``, which the step itself never enters) are
    skipped, as ``MemTracker`` skips them."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            # let DTensor desugar into local ops first; they come back here
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self.registry.get(func._overloadpacket)
        if count is not None and active_fake_mode() is None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        return out


def _mem_tracker():
    """``MemTracker`` over the step's own tensors: the meta ones, outside
    DTensor's propagation (whose fake tensors are at the global shapes;
    torch 2.13's tracker skips them itself, 2.11's does not)."""
    # imported here: it loads torch's testing process group
    from torch.distributed._tools.mem_tracker import MemTracker

    class _Local(MemTracker):
        def _track(self, reftype, t):
            if t.device.type == "meta" and active_fake_mode() is None:
                super()._track(reftype, t)

    return _Local()


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _tensors(tree):
    return [_local(t) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _bytes(ts) -> int:
    """Bytes of the distinct storages under ``ts``."""
    seen, total = set(), 0
    for t in ts:
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


# microbatches the full artifact runs; the others repeat the last of them
TRACED_MICRO = 2


class _Micro:
    """The train step's microbatch hook: runs the first `TRACED_MICRO`
    microbatches and notes the flop count and collective log as each
    starts, so the step's totals can count the rest as repeats of the
    last one (they run the same program on the same shapes, the
    reference's scan)."""

    def __init__(self, flops: "LocalFlops", rec: CollectiveRecorder):
        self.flops, self.rec = flops, rec
        self.marks, self.n = [], 1

    def __call__(self, i: int, n: int) -> bool:
        self.n = n
        self.marks.append((self.flops.flops, len(self.rec.log)))
        return i < TRACED_MICRO

    def totals(self):
        """(flops, collective log) with the untraced microbatches added."""
        flops, log = self.flops.flops, list(self.rec.log)
        if len(self.marks) > TRACED_MICRO:
            (f0, c0), (f1, c1) = self.marks[-2:]
            rest = self.n - TRACED_MICRO
            flops += rest * (f1 - f0)
            log += rest * self.rec.log[c0:c1]
        return flops, log


def _run_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
              artifact: str) -> dict:
    """Build the cell's step on meta tensors, run it once under the
    watching modes -> {seconds, flops, memory, collectives}."""
    opts = _opts_for(artifact, cfg)
    tcfg = train_config_for(cfg, shape)
    if artifact == "cost":
        # the whole step's compute without the accumulation loop, as the
        # reference's cost artifact
        tcfg = dataclasses.replace(tcfg, microbatch=0)
    flops, rec, mt = LocalFlops(), CollectiveRecorder(), _mem_tracker()
    micro = _Micro(flops, rec)
    t0 = time.time()
    fn, args, _, _, _ = make_step(cfg, opts, mesh, shape, tcfg,
                                  micro_hook=micro)
    arg_ts = _tensors(args)
    arg_bytes = _bytes(arg_ts)
    mt.track_external(*arg_ts)
    with mt, rec, flops:
        out = fn(*args)
    seconds = time.time() - t0
    out_ts = _tensors(out)
    arg_keys = {t.untyped_storage()._cdata for t in arg_ts}
    alias = _bytes([t for t in out_ts
                    if t.untyped_storage()._cdata in arg_keys])
    peak = sum(v.get("Total", 0) for v in
               mt.get_tracker_snapshot("peak").values())
    memory = {"argument_size_in_bytes": arg_bytes,
              "output_size_in_bytes": _bytes(out_ts),
              "alias_size_in_bytes": alias,
              "temp_size_in_bytes": max(0, peak - arg_bytes)}
    total_flops, log = micro.totals()
    return {"seconds": seconds, "flops": total_flops, "memory": memory,
            "collectives": collective_stats(log),
            "microbatches": {"run": min(micro.n, TRACED_MICRO),
                             "total": micro.n}}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             artifact: str, device: str = "cpu") -> dict:
    """One cell; ``device`` is the mesh's device type."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    n_dev = mesh.size()

    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": n_dev,
        "artifact": artifact,
        "mode": shape.mode,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "pattern_len": len(cfg.pattern),
        "num_layers": cfg.num_layers,
        "tokens": shape.tokens if shape.mode != "decode" else
        shape.global_batch,
        "mesh_device": device,
    }

    if artifact == "full":
        r = _run_step(cfg, shape, mesh, "full")
        mem = r["memory"]
        need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        result.update({
            "lower_s": round(r["seconds"], 2),
            "microbatches": r["microbatches"],
            "cost_analysis": {"flops": float(r["flops"])},
            "memory_analysis": mem,
            "hbm_bytes": HBM_BYTES,
            "fits": need <= HBM_BYTES,
            "collectives": r["collectives"],
            "collectives_summary": summarize(r["collectives"]),
        })
        print(f"[full] {arch} x {shape_name} x {result['mesh']}: "
              f"trace={r['seconds']:.1f}s flops={r['flops']:.3e} "
              f"args={mem['argument_size_in_bytes'] / 2 ** 30:.2f}GiB "
              f"temp={mem['temp_size_in_bytes'] / 2 ** 30:.2f}GiB "
              f"of {HBM_BYTES / 2 ** 30:.0f}GiB fits={result['fits']} "
              f"colls={result['collectives_summary']}", flush=True)
        return result

    # cost artifact: unrolled 1-unit and 2-unit steps
    per = {}
    for repeats in (1, 2):
        r = _run_step(_cost_cfg(cfg, repeats), shape, mesh, "cost")
        per[repeats] = {
            "lower_s": round(r["seconds"], 2),
            "flops": float(r["flops"]),
            "bytes_accessed": 0.0,  # not measured: no cost model here
            "collective_link_bytes": sum(s["link_bytes"] for s in
                                         r["collectives"].values()),
            "collectives": r["collectives"],
        }
        print(f"[cost R={repeats}] {arch} x {shape_name} x "
              f"{result['mesh']}: trace={r['seconds']:.1f}s "
              f"flops={per[repeats]['flops']:.3e} "
              f"coll={per[repeats]['collective_link_bytes']:.3e}B",
              flush=True)
    # the direct count: the same unrolled step at full depth (eager
    # tracing can afford what the reference's compile could not)
    r = _run_step(_cost_cfg(cfg, cfg.num_repeats), shape, mesh, "cost")
    direct = {"lower_s": round(r["seconds"], 2), "flops": float(r["flops"]),
              "collective_link_bytes": sum(s["link_bytes"] for s in
                                           r["collectives"].values())}
    print(f"[cost R={cfg.num_repeats}] {arch} x {shape_name} x "
          f"{result['mesh']}: trace={r['seconds']:.1f}s "
          f"flops={direct['flops']:.3e}", flush=True)
    unit = {k: per[2][k] - per[1][k]
            for k in ("flops", "bytes_accessed", "collective_link_bytes")}
    result.update({
        "cost_r1": per[1],
        "cost_r2": per[2],
        "per_unit": unit,
        "num_repeats": cfg.num_repeats,
        "full_depth": direct,
        # total = base (R1 minus one unit) + num_repeats * unit
        "total_flops": per[1]["flops"] - unit["flops"]
        + cfg.num_repeats * unit["flops"],
        "total_bytes": per[1]["bytes_accessed"] - unit["bytes_accessed"]
        + cfg.num_repeats * unit["bytes_accessed"],
        "total_collective_link_bytes":
            per[1]["collective_link_bytes"] - unit["collective_link_bytes"]
            + cfg.num_repeats * unit["collective_link_bytes"],
    })
    return result


def cells(arch: str | None = None, shape: str | None = None):
    archs = [arch] if arch else list(list_archs())
    for a in archs:
        cfg = get_config(a)
        shapes = ([get_shape(shape)] if shape
                  else list(applicable_shapes(cfg)))
        for s in shapes:
            yield a, s.name


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--artifact", default="full",
                   choices=("full", "cost", "both"))
    p.add_argument("--all", action="store_true",
                   help="all archs x applicable shapes")
    p.add_argument("--out", default=str(DEFAULT_OUT))
    args = p.parse_args(argv)
    # the mesh's device type: the card's when there is one (the tensors
    # are meta tensors either way, so no number depends on it)
    device = "cuda" if torch.cuda.is_available() else "cpu"

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    artifacts = ["full", "cost"] if args.artifact == "both" else \
        [args.artifact]

    todo = list(cells(None if args.all else args.arch,
                      None if args.all else args.shape))
    failures = []
    for arch, shape_name in todo:
        for mp in meshes:
            for art in artifacts:
                tag = (f"{arch}__{shape_name}__"
                       f"{'2x16x16' if mp else '16x16'}__{art}")
                path = out_dir / f"{tag}.json"
                try:
                    res = run_cell(arch, shape_name, multi_pod=mp,
                                   artifact=art, device=device)
                    path.write_text(json.dumps(res, indent=1))
                except Exception as e:
                    failures.append((tag, repr(e)))
                    path.with_suffix(".err").write_text(
                        traceback.format_exc())
                    print(f"[FAIL] {tag}: {e!r}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        raise SystemExit(1)
    print(f"\nall {len(todo) * len(meshes) * len(artifacts)} cells OK")


if __name__ == "__main__":
    main()
