#!/usr/bin/env python3
"""The starcoder2-3b training step (`chip_smoke.py`'s phase 16 (b):
full width and depth, batch 4 x 2,048, 6 steps, the first step against
the plain path, a profile of step 6 by part) of an earlier checkout and
of this tree, in turns on one card: parent, tree, tree, parent, each in
a fresh process and with nothing else running beside it.

    git archive <commit> | tar -x -C build/parent
    python3 tools/train_step_turns.py [--parent build/parent]

Prints each run's first-step comparison, its profile of step 6 and its
step walls, then the card's name and power limit. The step is within a
few per cent of the host's enqueue time, so the smoke's own reading
moves with whatever else the host runs; this one compares two trees on
one card and one host. Needs one NVIDIA H100 and a checkout under
--parent that holds its own `chip_smoke.py`.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CODE = ("import sys, torch\n"
        "sys.path.insert(0, 'src')\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke as C\n"
        "C.train_full_width(torch.device('cuda'), C.nvidia_smi_line())\n")
KEEP = ("step 1 before its update", "profile of step", "steps at batch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=ROOT / "build" / "parent")
    args = ap.parse_args(argv)
    if not (args.parent / "chip_smoke.py").exists():
        print(f"train_step_turns: no chip_smoke.py under {args.parent}",
              file=sys.stderr)
        return 1
    roots = {"parent": args.parent.resolve(), "tree": ROOT}
    for name in ("parent", "tree", "tree", "parent"):
        out = subprocess.run([sys.executable, "-c", CODE], cwd=roots[name],
                             capture_output=True, text=True, timeout=600)
        print(f"[turns] {name} ({roots[name]}): exit {out.returncode}",
              flush=True)
        for line in out.stdout.splitlines():
            if any(k in line for k in KEEP):
                print(f"[turns] {name} {line}", flush=True)
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[turns] {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
