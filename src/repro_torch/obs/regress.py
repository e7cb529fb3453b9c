"""Self-hosted perf-regression gate: the repo's own change-point
detector run over its own benchmark history; port of `repro.obs.regress`
on the port's detector (`repro_torch.core.workloads.detect.detect_step`).

``BENCH_sim.json`` holds one rev-keyed headline row per benchmark pass
(``warm_s.*`` wall times, ``runs_per_sec.*`` throughputs,
``chaos_guard_gain``, ...). This module treats each headline as a time
series over revisions and runs the engine's two-sided Page-Hinkley
detector over it. It reads the history and never writes it.

The reduction is exact, not an analogy: `detect_step` with
``kl=0, tau=1, pcap_l=0, dt=1e9, level_slack=0`` degenerates to pure PH
on ``z = (value - level) / sigma`` — the model-replay, Poisson-variance
and mismatch-slack terms all vanish — with the residual level tracking a
slow EWMA baseline so a gradual drift is absorbed while a step alarms.
``sigma`` comes from the series itself (MAD of first differences, with a
relative floor), so noisy headlines get proportionally wide gates. Every
analysed series runs in one batch, one `detect_step` per revision on
``device`` (CUDA unless ``device="cpu"``), with one transfer back at the
end.

CLI:

  PYTHONPATH=src python -m repro_torch.obs.regress BENCH_sim.json \\
      [--device cpu]

Exit codes: 0 clean (or ``--soft``), 1 regression detected, 2 history
unreadable. A *change* in the good direction (runs/sec up, warm_s down)
is reported as an improvement, never gates. A series shorter than
``min_gap + 2`` revisions is skipped ("too short"): the detector never
arms on it.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.workloads import detect as wdet

# The reference's defaults: clean on the repo's BENCH_sim.json history,
# alarming on a synthetic 2x step.
DRIFT = 0.5
THRESHOLD = 6.0
MIN_GAP = 3
LEVEL_ETA = 0.3
REL_FLOOR = 0.05
_BIG_DT = 1e9  # kills detect_step's Poisson-variance term (~1e-9)

# Markers deciding whether a bigger number is better. Rates win first
# ("runs_per_sec" contains the timing "_s" marker); then any dotted
# component that is a timing ("warm_s.fig7_sweep", "warm_s.sweep_
# throughput" — the sub-name never overrides the family); then
# explicitly-good scalars; unknown keys default to higher-better.
_RATE_MARKERS = ("per_sec", "per_second", "hz")
_TIME_SUFFIX = ("_s", "_seconds", "_us", "_ms")
_HIGHER_BETTER = ("gain", "improvement", "ticks", "throughput")
_SKIP_KEYS = ("rev", "date", "quick", "runtime_s")


def sense_of(key: str) -> int:
    """+1 if larger values are better for this headline, -1 if smaller."""
    k = key.lower()
    if any(m in k for m in _RATE_MARKERS):
        return 1
    for part in k.split("."):
        if part.endswith(_TIME_SUFFIX) or "seconds" in part:
            return -1
    if any(m in k for m in _HIGHER_BETTER):
        return 1
    return 1


def history_series(data: Any, quick: Optional[bool] = None
                   ) -> Dict[str, List[Tuple[str, float]]]:
    """Flatten BENCH history rows to {headline: [(rev, value), ...]}.

    Nested dicts (``warm_s``, ``runs_per_sec``) become dotted keys;
    bookkeeping fields (rev/date/quick/runtime_s) are skipped. ``quick``
    filters rows by their quick flag (mixing quick and full passes in
    one series would alarm on the mode switch, not the code)."""
    rows = data.get("history", []) if isinstance(data, dict) else list(data)
    series: Dict[str, List[Tuple[str, float]]] = {}

    def add(key: str, rev: str, v: Any) -> None:
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return
        if not math.isfinite(float(v)):
            return
        series.setdefault(key, []).append((rev, float(v)))

    for row in rows:
        if quick is not None and bool(row.get("quick")) != quick:
            continue
        rev = str(row.get("rev", "?"))
        for k, v in row.items():
            if k in _SKIP_KEYS:
                continue
            if isinstance(v, dict):
                for sub, sv in v.items():
                    add(f"{k}.{sub}", rev, sv)
            else:
                add(k, rev, v)
    return series


def _robust_sigma(values: Sequence[float], rel_floor: float) -> float:
    """Noise scale from the series itself: 1.4826*MAD of first
    differences / sqrt(2) (a step contaminates one diff, which the
    median ignores), floored at ``rel_floor`` of the median magnitude."""
    v = np.asarray(values, dtype=np.float64)
    floor = rel_floor * float(np.median(np.abs(v)))
    if len(v) >= 3:
        d = np.diff(v)
        mad = float(np.median(np.abs(d - np.median(d))))
        sigma = 1.4826 * mad / math.sqrt(2.0)
    else:
        sigma = 0.0
    return max(sigma, floor, 1e-12)


def _detect_batch(series: Sequence[Sequence[float]], *, drift: float,
                  threshold: float, min_gap: int, level_eta: float,
                  rel_floor: float, device) -> List[List[dict]]:
    """`detect_series` for several series at once: one (K, 8) detector
    batch on ``device``, stepped once per revision up to the longest
    series (a shorter series' state is held past its end)."""
    dev = resolve_device(device)
    vs = [[float(x) for x in v] for v in series]
    keep = [i for i, v in enumerate(vs) if len(v) >= 2]
    out: List[List[dict]] = [[] for _ in vs]
    if not keep:
        return out
    sig = [_robust_sigma(vs[i], rel_floor) for i in keep]
    k, n = len(keep), max(len(vs[i]) for i in keep)
    x = np.zeros((k, n), np.float32)
    lens = np.asarray([len(vs[i]) for i in keep])
    for j, i in enumerate(keep):
        x[j, :len(vs[i])] = vs[i]
    vals = torch.tensor([[0.0, 1.0, s, drift, threshold, float(min_gap),
                          level_eta, 0.0] for s in sig],
                        dtype=torch.float32, device=dev)
    state = torch.zeros((k, wdet.DET_STATE_DIM), dtype=torch.float32,
                        device=dev)
    xt = torch.from_numpy(x).to(dev)
    state[:, wdet.DET_LEVEL] = xt[:, 0]
    state[:, wdet.DET_COOLDOWN] = float(min_gap)
    live = torch.from_numpy(np.arange(n)[None, :] < lens[:, None]).to(dev)
    zero = torch.zeros(k, dtype=torch.float32, device=dev)
    base, hits = [], []
    for t in range(n):
        base.append(state[:, wdet.DET_LEVEL])
        new, det = wdet.detect_step(vals, state, xt[:, t], zero, _BIG_DT)
        state = torch.where(live[:, t, None], new, state)
        hits.append(det & live[:, t])
    base = torch.stack(base, 1).cpu().numpy()
    hits = torch.stack(hits, 1).cpu().numpy()
    for j, i in enumerate(keep):
        for t in np.nonzero(hits[j])[0]:
            xv, baseline = vs[i][t], float(base[j, t])
            delta = xv - baseline
            out[i].append({
                "index": int(t),
                "value": xv,
                "baseline": baseline,
                "direction": 1 if delta > 0 else -1,
                "magnitude_pct": (100.0 * delta / abs(baseline)
                                  if baseline else float("inf")),
                "sigma": sig[j],
            })
    return out


def detect_series(values: Sequence[float], *, drift: float = DRIFT,
                  threshold: float = THRESHOLD, min_gap: int = MIN_GAP,
                  level_eta: float = LEVEL_ETA,
                  rel_floor: float = REL_FLOOR,
                  device: Union[None, str, torch.device] = None
                  ) -> List[dict]:
    """Run the engine's Page-Hinkley detector over one headline series,
    on ``device`` (CUDA unless ``device="cpu"``).

    Returns one dict per change point: ``index`` (row where the alarm
    fired), ``value``, ``baseline`` (tracked level just before the
    alarm), signed ``direction`` (+1 value jumped up), ``magnitude_pct``
    relative to the baseline, and the ``sigma`` used."""
    return _detect_batch([values], drift=drift, threshold=threshold,
                         min_gap=min_gap, level_eta=level_eta,
                         rel_floor=rel_floor, device=device)[0]


def assess(data: Any, quick: Optional[bool] = None, *,
           drift: float = DRIFT, threshold: float = THRESHOLD,
           min_gap: int = MIN_GAP, level_eta: float = LEVEL_ETA,
           rel_floor: float = REL_FLOOR,
           device: Union[None, str, torch.device] = None) -> dict:
    """Gate verdict over every headline series in a BENCH history, the
    detector on ``device`` (CUDA unless ``device="cpu"``).

    A change point in the *bad* direction for that headline's sense
    (runs/sec down, warm_s up) is a regression; the good direction is an
    improvement. Series shorter than ``min_gap + 2`` rows are skipped —
    the detector never arms on them."""
    series = history_series(data, quick=quick)
    report: dict = {"series": {}, "regressions": [], "improvements": [],
                    "skipped": []}
    keys = []
    for key in sorted(series):
        if len(series[key]) < min_gap + 2:
            report["skipped"].append({"key": key, "n": len(series[key]),
                                      "reason": "too short"})
        else:
            keys.append(key)
    found = _detect_batch([[x for _, x in series[k]] for k in keys],
                          drift=drift, threshold=threshold,
                          min_gap=min_gap, level_eta=level_eta,
                          rel_floor=rel_floor, device=device)
    for key, changes in zip(keys, found):
        revs = [r for r, _ in series[key]]
        sense = sense_of(key)
        entry = {"n": len(revs), "sense": sense, "changes": changes}
        report["series"][key] = entry
        for ch in changes:
            rec = {"key": key, "rev": revs[ch["index"]], **ch}
            if ch["direction"] * sense < 0:
                report["regressions"].append(rec)
            else:
                report["improvements"].append(rec)
    report["n_series"] = len(report["series"])
    report["n_changes"] = sum(len(e["changes"])
                              for e in report["series"].values())
    return report


def _format_change(rec: dict, label: str) -> str:
    return (f"  {label} {rec['key']} @ {rec['rev']} (row {rec['index']}):"
            f" {rec['baseline']:.6g} -> {rec['value']:.6g}"
            f" ({rec['magnitude_pct']:+.1f}%, sigma={rec['sigma']:.3g})")


def main(argv=None) -> int:
    """The CLI; ``--device`` picks where the detector runs, CUDA unless
    told otherwise."""
    p = argparse.ArgumentParser(
        description="Page-Hinkley regression gate over BENCH_*.json "
                    "headline history (the repo's own detector, "
                    "self-hosted).")
    p.add_argument("bench", nargs="?", default="BENCH_sim.json",
                   help="benchmark telemetry file (default BENCH_sim.json)")
    p.add_argument("--soft", action="store_true",
                   help="annotate only: exit 0 even on regressions")
    p.add_argument("--quick", choices=("true", "false"), default=None,
                   help="restrict to quick=true/false history rows")
    p.add_argument("--drift", type=float, default=DRIFT)
    p.add_argument("--threshold", type=float, default=THRESHOLD)
    p.add_argument("--min-gap", type=int, default=MIN_GAP)
    p.add_argument("--level-eta", type=float, default=LEVEL_ETA)
    p.add_argument("--rel-floor", type=float, default=REL_FLOOR)
    p.add_argument("--json", action="store_true",
                   help="emit the full report as JSON on stdout")
    p.add_argument("--device", default=None,
                   help="where the detector runs (default: the card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    try:
        with open(args.bench) as fh:
            data = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        print(f"ERROR: cannot read {args.bench}: {e}", file=sys.stderr)
        return 2

    quick = None if args.quick is None else args.quick == "true"
    report = assess(data, quick=quick, drift=args.drift,
                    threshold=args.threshold, min_gap=args.min_gap,
                    level_eta=args.level_eta, rel_floor=args.rel_floor,
                    device=dev)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(f"regress: {args.bench}: {report['n_series']} series "
              f"analyzed, {len(report['skipped'])} skipped (short), "
              f"{report['n_changes']} change point(s)")
        for rec in report["regressions"]:
            print(_format_change(rec, "REGRESSION"))
        for rec in report["improvements"]:
            print(_format_change(rec, "improvement"))
        if not report["n_changes"]:
            print("  no change points — performance trajectory stable")
    if report["regressions"] and not args.soft:
        return 1
    if report["regressions"]:
        # stderr when --json: stdout must stay one parseable document
        print("(soft mode: regressions annotated, not gating)",
              file=sys.stderr if args.json else sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
