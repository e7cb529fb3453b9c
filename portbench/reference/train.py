"""The first optimizer steps of training, plainly: the loss and its
gradients by autograd on float32 leaves, global-norm clipping and AdamW
in float32 with the decay inside the update, the new parameters stored in
the configuration's parameter type (bfloat16 weights hold bfloat16
values), the learning rate by warm-up and cosine decay."""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from portbench.reference.model import loss
from portbench.weights import layer

TOP = ("embed", "final_ln", "lm_head")


def lr_at(opt: dict, step: int) -> float:
    """The learning rate at optimizer step ``step`` (0 first)."""
    warm = 1.0 if opt["warmup_steps"] <= 0 else min(
        1.0, (step + 1.0) / opt["warmup_steps"])
    t = min(max((step - opt["warmup_steps"])
                / max(1, opt["total_steps"] - opt["warmup_steps"]), 0.0), 1.0)
    return opt["learning_rate"] * warm * (0.1 + 0.9 * 0.5
                                          * (1.0 + math.cos(math.pi * t)))


def leaves(params: dict, spec: dict) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, a stacked leaf layer by layer:
    ``embed``, ``final_ln``, ``lm_head``, ``L<i>.<part>.<name>``."""
    out = [(k, params[k]) for k in TOP]
    for i in range(spec["num_layers"]):
        out += [(f"L{i}.{k}", t) for k, t in sorted(
            layer(params, len(spec["pattern"]), i).items())]
    return out


def run(params: dict, spec: dict, opt: dict, batches, prec: str = "fp32"
        ) -> dict:
    """``len(batches)`` steps from ``params`` (left as they are) ->
    {"loss": [each step's], "grad": {leaf: norm of the first step's
    clipped gradient}, "change": {leaf: norm of the change over the
    steps}}."""
    pdt = getattr(torch, spec["param_dtype"])
    named = leaves(params, spec)
    f32 = {n: t.detach().float().clone().requires_grad_() for n, t in named}
    top = {k: f32[k] for k in TOP}
    layers = [{k[len(f"L{i}."):]: t for k, t in f32.items()
               if k.startswith(f"L{i}.")} for i in range(spec["num_layers"])]
    m = {n: torch.zeros_like(t) for n, t in f32.items()}
    v = {n: torch.zeros_like(t) for n, t in f32.items()}
    out = {"loss": [], "grad": {}, "change": {}}
    b1, b2 = opt["beta1"], opt["beta2"]
    for step, (tokens, labels) in enumerate(batches):
        value = loss(top, layers, spec, tokens, labels, prec)
        value.backward()
        out["loss"].append(float(value.detach()))
        with torch.no_grad():
            gnorm = math.sqrt(sum(float(t.grad.double().square().sum())
                                  for t in f32.values()))
            clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9))
            lr = lr_at(opt, step)
            c1, c2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
            for n, p in f32.items():
                g = p.grad * clip
                if step == 0:
                    out["grad"][n] = float(g.norm())
                m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                v[n].mul_(b2).add_(g.square(), alpha=1.0 - b2)
                delta = (m[n] / c1) / (torch.sqrt(v[n] / c2) + opt["eps"]) \
                    + opt["weight_decay"] * p
                p.copy_((p - lr * delta).to(pdt).float())
                p.grad = None
    with torch.no_grad():
        for n, t in named:
            out["change"][n] = float((f32[n] - t.float()).norm())
    return out
