"""The readings that a cell's limits are set from, many seeds in one
process: for each seed the program's numbers (set-up, a short window at
the cell's own load, the reference's check) and, on the control seeds,
the control's (the reference in float8 put in the program's place).

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--faults <name>,<name>] [--seconds 2] \\
        [--config <config> --traffic <traffic>]

Prints one JSON line a seed: {"seed", "program": {...}, "control":
{...}, "faults": {<name>: {...}}}. On the control seeds, ``--faults``
also runs the program with each fault planted (see `portbench.faults`),
read against the same reference."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def readings(workload: str, seed: int, seconds: float, control: bool,
             device=None, ctx=None, faults=(), cell=None) -> dict:
    """One seed's readings: the program's, the control's (``control``),
    and the program's with each of ``faults`` planted, all against one
    run of the reference (``ctx``: a prepared context, for tests;
    ``cell``: a cell that BENCHMARK.json does not hold)."""
    import torch
    from portbench import faults as F
    from portbench import spec, trace
    from portbench.drivers import Ctx, free
    if ctx is None:
        cell = cell or spec.cell(workload)
        ctx = Ctx(cell=cell, seed=seed, seconds=seconds,
                  device=device or torch.device("cuda", 0),
                  tracer=trace.NoTrace(), cfg=spec.port_config(cell.config),
                  log=lambda *a: print(*a, file=sys.stderr))
    driver = spec.driver(ctx.traffic)

    def run():
        st = driver.setup(ctx)
        driver.window(st, ctx)
        driver.release(st)
        return st

    t0 = time.perf_counter()
    st = run()
    ref = driver.outputs(st, ctx, "fp32")
    out = {"seed": seed, "program": driver.readings(st, ctx, ref)}
    if control:
        out["control"] = driver.readings(st, ctx, ref,
                                         driver.outputs(st, ctx, "fp8"))
    del st
    free()
    for name in faults:
        with F.planted(name, ctx):
            st = run()
        out.setdefault("faults", {})[name] = driver.readings(st, ctx, ref)
        del st
        free()
    out["seconds"] = time.perf_counter() - t0
    del ref
    free()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--faults", default="",
                   help="faults planted on the control seeds, by name")
    p.add_argument("--config", default=None,
                   help="with --traffic: a cell BENCHMARK.json does not hold")
    p.add_argument("--traffic", default=None)
    args = p.parse_args(argv)
    from portbench import run, spec
    for k, v in run.CACHES.items():
        os.environ[k] = str(spec.ROOT / v)
    sys.path.insert(0, str(spec.ROOT / "src"))
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    fs = [f for f in args.faults.split(",") if f]
    seeds = [int(s) for s in args.seeds.split(",")]
    cell = (spec.make_cell(args.workload, args.config, args.traffic)
            if args.config else None)
    for s in seeds + sorted(ctl - set(seeds)):
        print(json.dumps(readings(args.workload, s, args.seconds, s in ctl,
                                  faults=fs if s in ctl else (),
                                  cell=cell)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
