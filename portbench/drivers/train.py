"""Training steps with the NRM in the loop, as `train --power` runs them.

Each step is ``batch`` rows of ``seq_len`` tokens, ids uniform over the
vocabulary (the port trains without document masks, so where documents
would end changes nothing the step computes). Set-up
builds the step, its weights and moments once, and drives the first
``checked_steps`` steps through the window's own call and feed; the
check follows those steps in the reference, and the same object then
runs the window."""
from __future__ import annotations

import math
import time

import torch

from portbench import weights
from portbench.drivers import Window, free
from portbench.drivers.nrm import Coupling
from portbench.reference import compare
from portbench.reference import train as ref_train
from portbench.reference.ops import float32_exact
from portbench.seeds import generator


def batch(ctx, i: int):
    """Step ``i``'s (tokens, labels), [batch, seq_len] int64 on the device:
    ids uniform over the vocabulary, each row its own."""
    t = ctx.traffic
    toks = torch.randint(0, ctx.spec["vocab_size"],
                         (t["batch"], t["seq_len"] + 1),
                         generator=generator(ctx.device, ctx.seed, "tokens",
                                             i), device=ctx.device)
    return toks[:, :-1], toks[:, 1:]


def _leaves(tree: dict, spec: dict):
    """(name, tensor) of every leaf, a stacked leaf layer by layer, named
    as `reference.train.leaves` names them."""
    out = [(k, tree[k]) for k in ref_train.TOP]
    for i in range(spec["num_layers"]):
        out += [(f"L{i}.{k}", t) for k, t in sorted(
            weights.layer(tree, len(spec["pattern"]), i).items())]
    return out


def leaf_norms(tree: dict, spec: dict, scale: float = 1.0) -> dict:
    names, ts = zip(*_leaves(tree, spec))
    vals = torch.stack([t.float().norm() for t in ts]) * scale
    return dict(zip(names, vals.tolist()))


def change_norms(now: dict, was: dict, spec: dict) -> dict:
    """Norm of each leaf's change from ``was`` to ``now``, a leaf at a
    time."""
    pairs = zip(_leaves(now, spec), _leaves(was, spec))
    vals = {n: (a.float() - b.float()).norm() for (n, a), (_, b) in pairs}
    return dict(zip(vals, torch.stack(list(vals.values())).tolist()))


class State:
    pass


def setup(ctx) -> State:
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.launch.steps import make_train_step, opt_rules_for
    from repro_torch.models import model as M
    from repro_torch.models.layers import materialize
    from repro_torch.models.types import ApplyOptions
    from repro_torch.optim.adamw import adamw_init_defs
    t, st = ctx.traffic, State()
    cfg = ctx.cfg
    st.opt = t["optimizer"]
    tcfg = TrainConfig(seed=0, **st.opt)
    tm = time.perf_counter()
    st.mesh_cm = host_mesh(ctx.device)
    mesh = st.mesh_cm.__enter__()
    st.step_fn = make_train_step(
        cfg, tcfg, ApplyOptions(attn_impl="cuda", scan_impl="chunked"),
        make_rules(cfg.sharding_recipe, mesh))
    t0 = time.perf_counter()
    st.params = weights.make(cfg, ctx.seed, ctx.device)
    st.opt_state = materialize(adamw_init_defs(M.model_defs(cfg),
                                               tcfg.moment_dtype),
                               0, torch.float32, ctx.device,
                               rules=opt_rules_for(cfg, tcfg, mesh))
    st.tokens = t["batch"] * t["seq_len"]
    st.nrm = Coupling(t["nrm"], st.tokens, ctx.device)
    st.losses, st.i = [], 0
    t1 = time.perf_counter()
    for i in range(t["checked_steps"]):
        _step(ctx, st, ctx.tracer)
        if i == 0:
            st.grad = leaf_norms(st.opt_state["m"], ctx.spec,
                                 1.0 / (1.0 - st.opt["beta1"]))
    st.change = change_norms(st.params, weights.make(cfg, ctx.seed,
                                                     ctx.device), ctx.spec)
    free()
    t2 = time.perf_counter()
    ctx.log(f"[setup] mesh and step {t0 - tm:.3f} s, weights and moments "
            f"{t1 - t0:.3f} s, first steps and "
            f"their norms {t2 - t1:.3f} s; losses {st.losses}")
    return st


def _step(ctx, st, tr):
    """One step as `train.train` runs it -> (wall s, NRM s, loss)."""
    with tr.span("pb.data"):
        tokens, labels = batch(ctx, st.i)
    t0 = time.perf_counter()
    with tr.span("pb.step"):
        _, _, m = st.step_fn(st.params, st.opt_state,
                             {"tokens": tokens, "labels": labels})
    with tr.span("pb.sync"):
        loss = float(m["loss"])
    wall = time.perf_counter() - t0
    with tr.span("pb.nrm"):
        nrm_s = st.nrm.step(wall)
    st.i += 1
    if st.i <= ctx.traffic["checked_steps"]:
        st.losses.append(loss)
    return wall, nrm_s, loss


def window(st, ctx) -> Window:
    t, tr = ctx.traffic, ctx.tracer
    walls, nrm_ms, traced, failed = [], [], [], 0
    t_start = time.perf_counter()
    while True:
        tr.tick(len(walls), t["trace_skip"], t["trace_steps"])
        on = tr.active
        wall, nrm_s, loss = _step(ctx, st, tr)
        tr.note("steps", 1)
        walls.append(wall)
        nrm_ms.append(nrm_s * 1e3)
        traced.append(on)
        failed += not math.isfinite(loss)
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    secs = time.perf_counter() - t_start
    return Window(
        metrics={"train_tokens_per_s": len(walls) * st.tokens / secs},
        attempted=len(walls), failed=failed, seconds=secs,
        host={"step_s": walls, "nrm_ms": nrm_ms, "traced": traced,
              "tokens_per_step": [st.tokens]})


def release(st) -> None:
    del st.params, st.opt_state, st.step_fn
    st.mesh_cm.__exit__(None, None, None)
    free()


def outputs(st, ctx, prec: str) -> dict:
    """The reference's steps (``prec`` "fp8": the control's) from the
    initial weights on the same batches."""
    init = weights.make(ctx.cfg, ctx.seed, ctx.device)
    batches = [batch(ctx, i) for i in range(ctx.traffic["checked_steps"])]
    with float32_exact():
        out = ref_train.run(init, ctx.spec, st.opt, batches, prec)
    del init
    free()
    return out


def readings(st, ctx, ref: dict, got: dict = None) -> dict:
    got = got or {"loss": st.losses, "grad": st.grad, "change": st.change}
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["loss"], ref["loss"])),
        "grad_gap": compare.norm_gap(got["grad"], ref["grad"], ref["grad"]),
        "change_gap": compare.norm_gap(got["change"], ref["change"],
                                       ref["grad"]),
    }
