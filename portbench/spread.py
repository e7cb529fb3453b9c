"""The spread of a cell's runs, as the bounds are set from it: for each
metric of each set, the distance between the first and third quartiles
(`statistics.quantiles(values, n=4)`) as a share of the median, and five
times the wider of the sets' spreads as the bound it suggests.

    python3 -m portbench.spread <runs.jsonl> [--sets 2]

The file holds one result line a run, the sets one after the other."""
from __future__ import annotations

import argparse
import json
import statistics


def spread(values) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("runs")
    p.add_argument("--sets", type=int, default=2)
    args = p.parse_args(argv)
    lines = [json.loads(line) for line in open(args.runs) if line.strip()]
    n = len(lines) // args.sets
    sets = [lines[i * n:(i + 1) * n] for i in range(args.sets)]
    for name in lines[0]["metrics"]:
        vals = [[r["metrics"][name]["value"] for r in s] for s in sets]
        sp = [spread(v) for v in vals]
        meds = [statistics.median(v) for v in vals]
        print(f"{name}: medians {meds}, spreads {sp}, suggested bound "
              f"{max(0.01, 5 * max(sp)):.4f}; runs {vals}")
    print("correct:", [r["correct"] for r in lines])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
