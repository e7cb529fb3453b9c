"""Checks of the program's spans (`repro_torch.obs.trace`) on the card,
in one cell of the benchmark (`portbench`), after the cell's own set-up.
Sections (``--sections``):

- ``flag``: a profiler session tracing the card alone turns recording on,
  and its end off;
- ``syncs``: the synchronising calls of a few steps (or batches) with
  recording off and on, each as the Python line that made it, under
  `torch.cuda.set_sync_debug_mode("warn")`;
- ``cost``: the host cost of a span off and on, the spans a step records,
  and the card-only stretch's seconds a step, idle share and garbage
  collection with recording on and forced off (`span` and `recording`
  replaced by their null forms), in turns;
- ``window``: one traced window as the benchmark runs it: the cell's
  per-layer metrics, the idle time by innermost span, the forward's idle
  time by its offset, and the shared clock (each kernel launched inside
  ``adamw.apply`` or ``moe.apply`` against the span's start, the span's
  start against the ``pb.*`` range around it, and every device event's
  start against the host op that launched it);
- ``gc``: the full collections over a run of steps, recording off then
  on.

    python tools/span_checks.py --workload sc2-3b.train-power --seed 7

Prints one JSON line; progress goes to standard error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import timeit
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def unit_fn(kind, st, ctx):
    """One step (training: data, step, loss on the host, NRM) or one batch
    (prefill: prompts, step, first tokens on the host) of the cell's
    driver, as its window runs it."""
    import torch
    from portbench.trace import NoTrace
    if kind == "train":
        from portbench.drivers import train
        return lambda j: train._step(ctx, st, NoTrace())
    from portbench.drivers import prefill_pool

    def one(j):  # the j-th length of the first cycle
        L = st.sched[j % len(ctx.traffic["lengths"])]
        tokens = prefill_pool.prompts(ctx, 10_000 + j, L)
        logits, cache = st.pre_fn(st.params, {"tokens": tokens})
        torch.argmax(logits, -1).cpu()
    return one


def sync_calls(one, n: int) -> list:
    """The synchronising calls of ``n`` units, each as the file and line
    of the Python frame that made it."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for j in range(n):
                one(j)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f"{Path(w.filename).name}:{w.lineno}" for w in got
            if "synchroniz" in str(w.message)]


def forced_off(obs_trace):
    """Replaces the module's `span` and `recording` by their null forms ->
    a function that restores them."""
    saved = obs_trace.span, obs_trace.recording
    obs_trace.span = lambda name: obs_trace._NULL
    obs_trace.recording = lambda: False

    def restore():
        obs_trace.span, obs_trace.recording = saved
    return restore


def card_stretch(one, n: int) -> tuple:
    """(seconds a unit, % of the stretch with no device event, seconds of
    garbage collection) over ``n`` units under the benchmark's card-only
    profiler stretch (`portbench.trace`)."""
    import gc
    from portbench import trace
    gc_s, t_gc = [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - t_gc[0]
    st = trace._Stretch(host=False)
    gc.callbacks.append(on_gc)
    try:
        for j in range(n):
            one(j)
    finally:
        gc.callbacks.remove(on_gc)
    st.stop()
    dev = trace._events(st)[0]
    busy = trace.union_ns([(a, a + d) for _, a, d, _ in dev]) / 1e9
    return st.window_s / n, 100 * (1 - busy / st.window_s), gc_s[0]


def span_cost_ns(obs_trace, on: bool, n: int = 1000,
                 rounds: int = 50) -> float:
    """Host ns a span, ``n`` spans a round (the tracer cleared between)."""
    obs_trace.enable(on)
    took = 0
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with obs_trace.span("x"):
                pass
        took += time.perf_counter_ns() - t0
        obs_trace.get_tracer().clear()
    obs_trace.enable(False)
    return took / (n * rounds)


def clock_check(summary, name: str, pb: str) -> dict:
    """Kernels launched inside the host stretch's spans ``name``: the
    least (kernel start - span start) and (host op start - span start),
    in us; and each span's start less the start of the ``pb`` range
    around it."""
    import bisect
    from portbench import spans as S
    sp = sorted((s for s in S.host_spans(summary) if s[0] == name),
                key=lambda s: s[1])
    starts = [s[1] for s in sp]
    dk, dh = [], []
    for ev in S.launched_in(summary, sp):
        i = bisect.bisect_right(starts, ev[3]) - 1
        dk.append((ev[1] - sp[i][1]) / 1e3)
        dh.append((ev[3] - sp[i][1]) / 1e3)
    rng = [r for r in summary["ranges"] if r[0] == pb]
    lead = [(s[1] - r[1]) / 1e3 for s in sp for r in rng
            if r[1] <= s[1] <= r[2]]
    return {"kernels": len(dk), "spans": len(sp),
            "min_kernel_minus_span_us": min(dk) if dk else None,
            "kernels_before_span": sum(d < 0 for d in dk),
            "min_hostop_minus_span_us": min(dh) if dh else None,
            "span_minus_range_us": [min(lead), max(lead)] if lead else None}


def gc_pauses(one, n: int) -> list:
    """(unit, seconds) of each full (generation 2) collection over ``n``
    units."""
    import gc
    got, t0, j = [], [0.0], [0]

    def on_gc(phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            got.append((j[0], time.perf_counter() - t0[0]))
    gc.callbacks.append(on_gc)
    try:
        for j[0] in range(n):
            one(j[0])
    finally:
        gc.callbacks.remove(on_gc)
    return got


def launch_lags(stretch, spans_=(), worst: int = 8) -> dict:
    """Over the host stretch's raw events: each device event's start less
    the start of the host op it is linked to (a kernel cannot start before
    it is launched), and the most negative, with the op's name and the
    program span open over the op."""
    import bisect
    from torch.autograd import DeviceType
    from portbench.trace import _runtime_call
    ops = {}
    dev = []
    for ev in stretch.prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU:
            if not _runtime_call(ev.name()):
                ops[ev.correlation_id()] = (ev.name(), ev.start_ns())
        elif ev.device_type() == DeviceType.CUDA and \
                not ev.is_user_annotation():
            dev.append((ev.name(), ev.start_ns(),
                        ev.linked_correlation_id()))
    sp = sorted(spans_, key=lambda s: s[1])
    starts = [s[1] for s in sp]

    def under(t):
        i = bisect.bisect_right(starts, t) - 1
        return sp[i][0] if i >= 0 and t <= sp[i][2] else None
    lags = sorted(((s - ops[c][1]) / 1e3, n[:60], ops[c][0], under(ops[c][1]))
                  for n, s, c in dev if c in ops)
    return {"linked": len(lags), "unlinked": len(dev) - len(lags),
            "negative": sum(x[0] < 0 for x in lags),
            "worst": lags[:worst],
            "quantiles_us": [lags[int(q * (len(lags) - 1))][0]
                             for q in (0, 0.001, 0.01, 0.5)] if lags else None}


def forward_gaps(summary, span: str = "steps.forward") -> dict:
    """The card's idle time under each ``span`` of the card's stretch, by
    its offset from the span's start (ms buckets: 0-5, 5-20, 20-50,
    50-100, 100+), summed over the spans."""
    from portbench import spans as S
    edges = (5, 20, 50, 100, float("inf"))
    out = {str(e): 0.0 for e in edges}
    sp = [s for s in S.card_spans(summary) if s[0] == span]
    for a, b in S.idle_gaps(summary["events"]):
        for _, s0, s1 in sp:
            lo, hi = max(a, s0), min(b, s1)
            if hi > lo:
                off = (lo - s0) / 1e6
                key = next(e for e in edges if off < e)
                out[str(key)] += (hi - lo) / 1e6
    return {"ms_by_offset_ms": out, "spans": len(sp)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=12.0,
                   help="the traced window's seconds")
    p.add_argument("--units", type=int, default=3,
                   help="steps or batches a turn of the cost and sync "
                        "counts")
    p.add_argument("--turns", type=int, default=2,
                   help="rounds of (on, off, off, on) card-only stretches")
    p.add_argument("--gc-units", type=int, default=24,
                   help="units watched for full collections, off then on")
    p.add_argument("--sections", default="flag,syncs,cost,window,gc")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import run, spans, spec, trace
    for k, v in run.CACHES.items():
        os.environ[k] = str(ROOT / v)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench.drivers import Ctx
    from repro_torch.obs import trace as obs_trace

    cell = spec.cell(args.workload)
    kind = cell.traffic["driver"]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = Ctx(cell=cell, seed=args.seed, seconds=args.seconds, device=dev,
              tracer=trace.NoTrace(), cfg=spec.port_config(cell.config),
              log=run.log)
    driver = spec.driver(cell.traffic)
    st = driver.setup(ctx)
    out = {"workload": cell.name, "card": run.nvidia_smi(),
           "torch": torch.__version__, "cuda": torch.version.cuda}

    one, n = unit_fn(kind, st, ctx), args.units
    one(0)  # the NRM calibrates, or the first prompts' shapes settle

    def flag():
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        during = obs_trace.recording()
        prof.stop()
        return {"during": during, "after": obs_trace.recording()}

    def syncs():
        res = {"off": [], "on": []}
        for rec in (False, True, True, False):
            obs_trace.enable(rec)
            try:
                res["on" if rec else "off"].append(sync_calls(one, n))
            finally:
                obs_trace.enable(False)
        return res

    def cost():
        tr = obs_trace.get_tracer()
        tr.clear()
        obs_trace.enable(True)
        one(0)
        obs_trace.enable(False)
        res = {"spans_a_unit": len(tr.spans()),
               "span_ns_off": span_cost_ns(obs_trace, False),
               "span_ns_on": span_cost_ns(obs_trace, True),
               "clock_read_ns": {f.__name__: timeit.timeit(f, number=100_000)
                                 * 1e4 for f in (time.time_ns,
                                                 time.perf_counter_ns)}}
        turns = []
        for rec in (True, False, False, True) * args.turns:
            restore = (lambda: None) if rec else forced_off(obs_trace)
            try:
                turns.append((rec, card_stretch(one, n)))
            finally:
                restore()
        for key, rec in (("on", True), ("off", False)):
            got = [t for r, t in turns if r == rec]
            res[f"unit_s_{key}"] = [t[0] for t in got]
            res[f"idle_pct_{key}"] = [t[1] for t in got]
            res[f"gc_s_{key}"] = [t[2] for t in got]
        tr.clear()
        return res

    def window():
        ctx.tracer = trace.Tracer()
        win = driver.window(st, ctx)
        ctx.tracer.stop()
        summary = ctx.tracer.summary()
        res = {"metrics": {k: v["value"] for k, v in run.per_layer(
            cell, summary, win, ctx).items()}}
        by = spans.idle_by_span(summary) or {}
        w = summary["window_s"]
        res["idle_by_span_pct"] = {str(k): 100 * v / w
                                   for k, v in by.items()}
        evs = summary["events"]
        first, last = evs[0][1], max(s + d for _, s, d, _ in evs)
        res["idle_pct_outside_first_last"] = 100 * (
            w - (last - first) / 1e9) / w
        res["window_s"] = w
        res["breakdown"] = trace.breakdown(summary)
        name, pb = (("adamw.apply", "pb.adamw") if kind == "train"
                    else ("moe.apply", "pb.moe"))
        res["clock"] = clock_check(summary, name, pb)
        res["launch_lags"] = launch_lags(ctx.tracer.stretches[1],
                                         spans.host_spans(summary))
        res["forward_gaps"] = forward_gaps(summary)
        return res

    def gc_full():
        res = {}
        for rec in (False, True):
            obs_trace.enable(rec)
            try:
                res["on" if rec else "off"] = gc_pauses(one, args.gc_units)
            finally:
                obs_trace.enable(False)
                obs_trace.get_tracer().clear()
        return res

    sections = {"flag": flag, "syncs": syncs, "cost": cost,
                "window": window, "gc": gc_full}
    for key in args.sections.split(","):
        fn = sections[key]
        try:
            out[key] = fn()
        except Exception:  # report every section; one failing stops none
            out[key] = {"error": traceback.format_exc()}
        run.log(f"[span_checks] {key}: {json.dumps(out[key])[:2000]}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
