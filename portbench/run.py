"""Runs one cell of the port's benchmark on the card it is started on.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (process start to the window: imports, the card, weights from the
seed, warm-up of every shape, the steps the check follows) is `setup_s`;
then the window measures for ``--seconds``; then the program's state is
freed and the plain reference checks what the window's path produced.
Progress goes to standard error; the last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number
compared beside its limit (also the last lines of standard error).
With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a traced stretch of the
window. The run fails, and prints no result, without enough CUDA cards,
or when the process holds jax, jaxlib, flax or repro after the window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import spec  # noqa: E402

ROOT = spec.ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the build and kernel caches, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
          "TRITON_CACHE_DIR": "build/portbench/triton",
          "CUDA_CACHE_PATH": "build/portbench/cuda_cache"}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except Exception as e:  # a label beside the numbers, not a check
        return f"nvidia-smi not read ({type(e).__name__})"


def per_layer(cell, summary, window, ctx) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    from portbench import roofline
    from portbench.roofline import model as rmodel
    rctx = {"trace": summary, "host": window.host, "spec": ctx.spec,
            "traffic": ctx.traffic, "roofline": roofline,
            "model": rmodel, "window_s": window.seconds}
    out = {}
    for m in cell.per_layer:
        v = spec.reader(m["name"])(rctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)
    sys.path.insert(0, str(ROOT / "src"))

    import torch
    from portbench import trace
    from portbench.drivers import Ctx

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
            f"found {n}")
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"[portbench] {cell.name} seed {args.seed} on {nvidia_smi()}; "
        f"peaks bf16 989e12 flop/s, HBM 3.35e12 B/s (data sheet, 700 W)")
    ctx = Ctx(cell=cell, seed=args.seed, seconds=args.seconds, device=dev,
              tracer=trace.Tracer() if args.trace else trace.NoTrace(),
              cfg=spec.port_config(cell.config), log=log)
    result = execute(ctx)
    bad = forbidden_modules()
    if bad:
        log(f"portbench: the process holds {bad} after the window")
        return 3
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']:.6g} limit {c['limit']:.6g}")
    print(json.dumps(result), flush=True)
    return 0


def execute(ctx) -> dict:
    """Set-up, window, check of one cell on ``ctx.device`` -> the result
    (the memory peak is the card's; 0 on the CPU)."""
    import torch
    from portbench.trace import Tracer, breakdown
    cell, cuda = ctx.cell, ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    driver = spec.driver(cell.traffic)
    log(f"[portbench] imports and the card {time.perf_counter() - T_START:.3f} s")
    state = driver.setup(ctx)
    sync()
    setup_s = time.perf_counter() - T_START
    log(f"[portbench] set-up {setup_s:.3f} s")

    win = driver.window(state, ctx)
    sync()
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    log(f"[portbench] window {win.seconds:.3f} s: "
        + ", ".join(f"{k} {v:.6g}" for k, v in win.metrics.items())
        + f"; peak {peak / 2**30:.2f} GiB")
    summary = None
    if isinstance(ctx.tracer, Tracer):
        ctx.tracer.stop()
        if len(ctx.tracer.stretches) < 2:
            raise RuntimeError("the window ended before its traced stretches")
        summary = ctx.tracer.summary()

    driver.release(state)
    got = driver.readings(state, ctx, driver.outputs(state, ctx, "fp32"))
    checks = {k: {"value": got[k], "limit": lim}
              for k, lim in cell.limits.items()}
    correct = win.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(ctx.device) if cuda
              else "cpu", "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed}
    if summary is not None:
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["metrics"] = per_layer(cell, summary, win, ctx)
        result["device"] = device
        result["breakdown"] = breakdown(summary)
    else:
        metrics = dict(win.metrics, setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": metrics[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
