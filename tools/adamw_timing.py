#!/usr/bin/env python3
"""AdamW's kernels at a training configuration's size, timed on one card
in turns with the plain route and with PyTorch's fused AdamW as the
library yardstick.

    python3 tools/adamw_timing.py [--arch starcoder2-3b] [--reps 5]

The quads are the configuration's leaves as `launch.steps.make_train_step`
hands them to `apply_adamw` (each stacked leaf a layer slice at a time):
bf16 params and grads (random), float32 moments. Each line is device ms
a step, from CUDA events around ``reps`` steps: the kernels
(`optim.adamw.apply_adamw`: the norm, its finalize and the update, also
timed apart), the plain route (`optim.adamw.plain_apply`: `global_norm`
and `_update` piece by piece, which the port runs on the CPU only) and
`torch.optim.AdamW(fused=True)` over the same bf16 params and grads (its
moments bf16, so 14 bytes a parameter: not the same work, and never
called by the port), timed kernels, plain, library, library, plain,
kernels. Then the byte bound (22 bytes a parameter for the update, 2 for
the norm's read of the grads, at 3.35 TB/s), the kernels' share of it,
their launches a step, ptxas's report of each kernel, and the card's name
and power limit. Needs one NVIDIA H100 (sm_90a) and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM's data sheet


def ptxas_report(source: Path) -> None:
    """ptxas's registers, stack and spills of each kernel in ``source``,
    built with `_build.flags` and `-Xptxas -v` into a scratch library."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        out = subprocess.run([_build.nvcc_path(), *_build.flags(source),
                              "-Xptxas", "-v", "-o", f"{tmp}/report.so",
                              str(source)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{out.stderr}")
    kernel = None
    for line in out.stderr.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            kernel = m.group(1)
        elif kernel and ("spill" in line or "registers" in line):
            print(f"[adamw] ptxas {kernel}: "
                  f"{line.split('ptxas info    :')[-1].strip()}")


def quads_of(arch: str, dev):
    """The configuration's (p, g, m, v) as the train step hands them to
    AdamW, and its whole leaves (p, g) for the library's optimizer."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.layers import (is_def, tree_leaves_with_path,
                                           tree_map)
    cfg = get_config(arch)
    defs = M.model_defs(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)

    def fill(d, scale, dtype):
        return (torch.randn(d.shape, generator=gen, device=dev)
                * scale).to(dtype)

    p = tree_map(lambda d: fill(d, 0.02, torch.bfloat16), defs,
                 is_leaf=is_def)
    g = tree_map(lambda d: fill(d, 1e-3, torch.bfloat16), defs,
                 is_leaf=is_def)
    zero = lambda d: torch.zeros(d.shape, dtype=torch.float32, device=dev)
    m = tree_map(zero, defs, is_leaf=is_def)
    v = tree_map(zero, defs, is_leaf=is_def)
    leaves = lambda t: [x for _, x in tree_leaves_with_path(
        M.unstack_blocks(cfg, t))]
    whole = lambda t: [x for _, x in tree_leaves_with_path(t)]
    return list(zip(*(leaves(t) for t in (p, g, m, v)))), whole(p), whole(g)


def events_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.adamw import kernel as K
    from repro_torch.optim import adamw
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("adamw_timing: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    ptxas_report(K.SOURCE)
    quads, p_whole, g_whole = quads_of(args.arch, dev)
    n = sum(q[0].numel() for q in quads)
    cfg = TrainConfig(learning_rate=3e-4, weight_decay=0.1, grad_clip=1.0)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    lr = torch.tensor(3e-4, dtype=torch.float32, device=dev)

    def kernels():
        adamw.apply_adamw(cfg, quads, step.add_(1), lr)

    def plain():
        s = step.add_(1).to(torch.float32)
        adamw.plain_apply(cfg, quads, step, lr, 1.0 - cfg.beta1 ** s,
                          1.0 - cfg.beta2 ** s)

    grads = [q[1] for q in quads]
    scal = [torch.ones((), device=dev)] * 4
    norm_ms = events_ms(lambda: K.norm_and_clip(grads, 1.0), args.reps)
    update_ms = events_ms(lambda: K.update(
        quads, *scal[:3], lr, cfg.beta1, cfg.beta2, cfg.eps,
        cfg.weight_decay), args.reps)
    n0 = K.LAUNCHES
    kernels()
    launches = K.LAUNCHES - n0
    for p, g in zip(p_whole, g_whole):
        p.grad = g
    lib = torch.optim.AdamW(p_whole, lr=3e-4, betas=(cfg.beta1, cfg.beta2),
                            eps=cfg.eps, weight_decay=cfg.weight_decay,
                            fused=True)
    times = {"kernels": [], "plain": [], "library": []}
    for name in ("kernels", "plain", "library", "library", "plain",
                 "kernels"):
        fn = {"kernels": kernels, "plain": plain, "library": lib.step}[name]
        times[name].append(events_ms(fn, max(1, args.reps // 2)
                                     if name == "plain" else args.reps))
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    bound_update = 22 * n / HBM_BYTES_PER_S * 1e3
    bound_norm = 2 * n / HBM_BYTES_PER_S * 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "arch": args.arch, "parameters": n, "quads": len(quads),
        "kernels_ms": mean["kernels"], "plain_ms": mean["plain"],
        "library_ms": mean["library"], "turns": times,
        "norm_ms": norm_ms, "update_ms": update_ms,
        "bound_ms": {"update": bound_update, "norm": bound_norm},
        "share_of_bound": {
            "step": (bound_update + bound_norm) / mean["kernels"],
            "update": bound_update / update_ms, "norm": bound_norm / norm_ms},
        "launches_a_step": launches, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
