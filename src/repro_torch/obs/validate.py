"""Schema validation CLI for observability exports (CI gate); port of
`repro.obs.validate`, over the port's metrics and trace validators.

  PYTHONPATH=src python -m repro_torch.obs.validate \
      --metrics BENCH_metrics.json --trace BENCH_trace.json \
      --prom scraped_metrics.txt

Exits non-zero (failing the CI job) when an export is missing or
malformed, so a quick-benchmark run can never silently upload a broken
snapshot/trace artifact. ``--prom`` checks Prometheus exposition text
(e.g. a live scrape of ``/metrics``) for format conformance: counter
``_total`` suffixes, the ``le="+Inf"`` bucket, cumulative histogram
buckets and label escaping.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


def _load(path: str):
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError:
        raise ValueError(f"{path}: file not found")
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}: invalid JSON ({e})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--metrics", default=None,
                   help="metrics snapshot JSON to validate")
    p.add_argument("--trace", default=None,
                   help="chrome trace-event JSON to validate "
                        "(must contain >= 1 span)")
    p.add_argument("--prom", default=None,
                   help="Prometheus exposition text file to validate "
                        "(a scraped /metrics payload)")
    args = p.parse_args(argv)
    if not args.metrics and not args.trace and not args.prom:
        p.error("nothing to validate: pass --metrics, --trace "
                "and/or --prom")
    try:
        if args.metrics:
            _metrics.validate_snapshot(_load(args.metrics))
            n = len(_load(args.metrics)["metrics"])
            print(f"OK {args.metrics}: valid snapshot ({n} metrics)")
        if args.trace:
            doc = _load(args.trace)
            _trace.validate_chrome_trace(doc, require_spans=True)
            print(f"OK {args.trace}: valid chrome trace "
                  f"({len(doc['traceEvents'])} events)")
        if args.prom:
            try:
                with open(args.prom) as fh:
                    text = fh.read()
            except FileNotFoundError:
                raise ValueError(f"{args.prom}: file not found")
            n = _metrics.validate_prometheus_text(text)
            print(f"OK {args.prom}: valid Prometheus exposition "
                  f"({n} samples)")
    except ValueError as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
