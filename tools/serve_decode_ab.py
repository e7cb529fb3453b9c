#!/usr/bin/env python3
"""Decode time of `chip_smoke.py`'s phase-7 serve (qwen3-8b at full
width, batch 8, 1,024-token prompts, 32 greedy tokens, random weights
from seed 0) on an earlier checkout and on this one, in turns.

    python3 tools/serve_decode_ab.py --parent build/parent [--turns 3]

Unpack the earlier commit first (``git archive <commit> | tar -x -C
build/parent``). Each turn runs the parent, this tree, this tree, the
parent, each in a fresh process that serves once to build and warm the
kernels and then ``--serves`` times, reading `serve`'s own decode-loop
wall (host clock around the 32 steps, each ending in tokens on the
host). Prints one line per process (walls, tok/s), the medians and
quartiles of each side, that the greedy tokens agree between the trees,
and the card's name and power limit. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--arch", "qwen3-8b", "--batch", "8", "--prompt-len", "1024",
        "--gen", "32", "--seed", "0", "--quiet"]
CHILD = r'''
import json, sys
sys.path.insert(0, "src")
from repro_torch.launch import serve
argv, n = json.loads(sys.argv[1]), int(sys.argv[2])
serve.main(argv)
walls = []
for _ in range(n):
    r = serve.main(argv)
    walls.append(r["wall_s"])
print(json.dumps({"walls": walls, "tokens": r["generated"].tolist()}))
'''


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--parent", required=True)
    p.add_argument("--turns", type=int, default=3)
    p.add_argument("--serves", type=int, default=3)
    args = p.parse_args()
    trees = {"parent": Path(args.parent).resolve(), "change": ROOT}
    walls = {"parent": [], "change": []}
    tokens = {}
    for turn in range(args.turns):
        for side in ("parent", "change", "change", "parent"):
            out = subprocess.run(
                [sys.executable, "-c", CHILD, json.dumps(ARGV),
                 str(args.serves)], cwd=trees[side], capture_output=True,
                text=True, timeout=900)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return 1
            r = json.loads(out.stdout.strip().splitlines()[-1])
            walls[side] += r["walls"]
            tokens.setdefault(side, r["tokens"])
            print(f"turn {turn} {side}: decode loop "
                  + ", ".join(f"{w:.3f}" for w in r["walls"]) + " s ("
                  + ", ".join(f"{256 / w:.1f}" for w in r["walls"])
                  + " tok/s)", flush=True)
    for side, w in walls.items():
        q1, med, q3 = np.percentile(w, [25, 50, 75])
        print(f"{side}: {len(w)} decode loops, median {med:.3f} s "
              f"({256 / med:.1f} tok/s), quartiles {q1:.3f}-{q3:.3f} s")
    same = tokens["parent"] == tokens["change"]
    print(f"greedy tokens equal across the trees: {same}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
