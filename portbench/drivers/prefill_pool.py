"""A prefill instance of a disaggregated deployment: batches of ``batch``
prompts of one length (as a length-bucketing router groups them), sent
one at a time in a closed loop, each when the previous batch's first
tokens reached the host. The lengths cycle through the traffic's list in
an order drawn from the seed each cycle, and the window ends with the
first whole cycle past ``--seconds``, so every window holds the same mix;
token ids are uniform over the vocabulary. A step returns the first
token of each prompt and hands on the cache."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import spec as S
from portbench import weights
from portbench.drivers import Window, before_experts, free, layer_cache
from portbench.reference import compare
from portbench.reference import model as ref_model
from portbench.reference.ops import float32_exact
from portbench.seeds import generator, sub

MAX_BATCHES = 4096


def prompts(ctx, i: int, length: int) -> torch.Tensor:
    return torch.randint(0, ctx.spec["vocab_size"],
                         (ctx.traffic["batch"], length),
                         generator=generator(ctx.device, ctx.seed, "prompt",
                                             i), device=ctx.device)


class State:
    pass


def cached(ctx, sched) -> list:
    """The batches whose caches the check follows, drawn from the seed
    among the first cycle: its longest, and ``cache_batches - 1``
    others."""
    n = len(ctx.traffic["lengths"])
    first = sched[:n]
    longest = int(np.argmax(first))
    rest = [i for i in range(n) if i != longest]
    rng = np.random.default_rng(sub(ctx.seed, "checked"))
    pick = rng.choice(rest, ctx.traffic["cache_batches"] - 1, replace=False)
    return sorted([longest] + [int(i) for i in pick])


def setup(ctx) -> State:
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.types import ApplyOptions
    st = State()
    st.mesh_cm = host_mesh(ctx.device)
    mesh = st.mesh_cm.__enter__()
    st.pre_fn = make_prefill_step(
        ctx.cfg, ApplyOptions(attn_impl="cuda", scan_impl="cuda"),
        make_rules(ctx.cfg.sharding_recipe, mesh))
    t0 = time.perf_counter()
    st.params = weights.make(ctx.cfg, ctx.seed, ctx.device)
    t1 = time.perf_counter()
    st.sched = S.lengths_schedule(ctx.traffic["lengths"], ctx.seed,
                                  MAX_BATCHES)
    st.cached = cached(ctx, st.sched)
    # every length the traffic sends, the longest first
    for L in sorted(set(ctx.traffic["lengths"]), reverse=True):
        logits, cache = st.pre_fn(st.params, {"tokens": prompts(ctx, -1, L)})
        torch.argmax(logits, -1).cpu()
        del logits, cache
    st.answers, st.caches = {}, {}
    ctx.log(f"[setup] weights {t1 - t0:.3f} s, warm-up "
            f"{time.perf_counter() - t1:.3f} s")
    return st


def window(st, ctx) -> Window:
    t, tr = ctx.traffic, ctx.tracer
    recs, traced = [], []
    t_start = time.perf_counter()
    i = 0
    while True:
        tr.tick(i, t["trace_skip"], t["trace_batches"])
        on = tr.active
        L = st.sched[i]
        tokens = prompts(ctx, i, L)
        t0 = time.perf_counter()
        with tr.span("pb.prefill"):
            logits, cache = st.pre_fn(st.params, {"tokens": tokens})
        with tr.span("pb.sync"):
            first = torch.argmax(logits, -1).cpu()
        t1 = time.perf_counter()
        recs.append((L, t1 - t0))
        tr.note("lengths", L)
        traced.append(on)
        if i < len(t["lengths"]):  # the first cycle: every request checked
            st.answers[i] = (first, logits)
        if i in st.cached:
            st.caches[i] = cache
        del logits, cache
        i += 1
        # whole cycles of the lengths, so that every seed's window holds
        # the same mix (and the batches the check follows: the first)
        if t1 - t_start >= ctx.seconds and i % len(t["lengths"]) == 0:
            break
    secs = time.perf_counter() - t_start
    B = t["batch"]
    ttft = np.repeat([w for _, w in recs], B) * 1e3
    return Window(
        metrics={"prefill_tokens_per_s": B * sum(L for L, _ in recs) / secs,
                 "ttft_p95_ms": float(np.percentile(ttft, 95))},
        attempted=B * len(recs), failed=0, seconds=secs,
        host={"batch_s": [w for _, w in recs],
              "lengths": [L for L, _ in recs], "traced": traced})


def release(st) -> None:
    del st.pre_fn
    st.mesh_cm.__exit__(None, None, None)
    free()


def outputs(st, ctx, prec: str) -> dict:
    """For each batch of the first cycle: the reference's last-token
    logits, and for the batches in `cached` its caches (``prec`` "fp8":
    the control's)."""
    out = {}
    with float32_exact():
        for i in sorted(st.answers):
            keep = i in st.cached
            logits, caches = ref_model.prefill(
                st.params, ctx.spec, prompts(ctx, i, st.sched[i]), prec,
                keep_cache=keep)
            out[i] = (logits, caches if keep else None)
            free()
    return out


def program(st, ctx) -> dict:
    P = len(ctx.spec["pattern"])
    return {i: (first, logits,
                [layer_cache(st.caches[i], P, l)
                 for l in range(ctx.spec["num_layers"])]
                if i in st.caches else None)
            for i, (first, logits) in st.answers.items()}


# the level of the quantile of a batch's requests' logit errors that
# `logit_err` takes: a sound request's error reads far off where its last
# token's experts differ from the reference's (in 7.5% of requests, one
# by one as a binomial), so a batch reads far off at this level only
# where 6 of its 8 requests do (PERF.md gives the readings)
LOGIT_LEVEL = 0.25


def readings(st, ctx, ref: dict, got: dict = None) -> dict:
    """Over every request of the first cycle (every slot of every length):
    ``logit_err``, the worst batch's `LOGIT_LEVEL` quantile of its
    requests' relative errors of the last-token logits, which sees a
    length whose batch is wrong; ``gap_share``, the share of served first
    tokens more than `compare.TAU` deviations below the reference's best,
    which sees wrong answers spread over many batches or slots. Over the
    batches in `cached`: ``kv_err``, the largest over the attention
    layers of the median relative error of a token's K or V;
    ``state_err``, the same over the Mamba layers that no expert layer
    precedes (`drivers.before_experts`) of a sequence and channel's SSM
    state and convolution window (`compare.cache_err`). Low quantiles and
    shares, not the largest: a request whose last token's experts differ
    from the reference's by a near tie, or by the capacity of a dispatch
    group (which such ties decide), takes another path in any precision
    below float32, and a sequence's last tokens, which its states hold,
    do too. Read for the record: ``logit_err_max`` and ``gap_max``, the
    widest request's, ``state_err_all``, the states' number over every
    Mamba layer, ``cache_err_whole``, the cache tensors' whole relative
    error, and ``requests``, each batch's requests' logit errors and
    gaps."""
    if got is None:
        got = program(st, ctx)
    else:  # the control: the token its own logits put first
        got = {i: (torch.argmax(lg, -1), lg, c) for i, (lg, c) in got.items()}
    dev = next(iter(ref.values()))[0].device
    gaps = {i: compare.token_gap(ref[i][0], got[i][0].to(dev)) for i in ref}
    errs = {i: compare.row_errs(got[i][1].to(dev), ref[i][0]) for i in ref}
    layers = [(g, r) for i in ref if ref[i][1] is not None
              for g, r in zip(got[i][2], ref[i][1])]
    first = before_experts(ctx.spec)
    early = [(g, r) for i in ref if ref[i][1] is not None
             for l, (g, r) in enumerate(zip(got[i][2], ref[i][1]))
             if l in first]
    every_gap = torch.cat(list(gaps.values()))
    every_err = torch.cat(list(errs.values()))
    return {"logit_err": max(float(torch.quantile(e, LOGIT_LEVEL))
                             for e in errs.values()),
            "gap_share": compare.gap_share(every_gap),
            "kv_err": max(compare.cache_err(g, r, ("k", "v"))
                          for g, r in layers),
            "state_err": max(compare.cache_err(g, r, ("conv", "ssm"))
                             for g, r in early),
            "logit_err_max": float(every_err.max()),
            "gap_max": float(every_gap.max()),
            "state_err_all": max(compare.cache_err(g, r, ("conv", "ssm"))
                                 for g, r in layers),
            "cache_err_whole": max(compare.rel_err(g[k], r[k])
                                   for g, r in layers for k in r),
            "requests": {str(i): {"length": st.sched[i],
                                  "logit_err": errs[i].tolist(),
                                  "gap": gaps[i].tolist()} for i in ref}}
