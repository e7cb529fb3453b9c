"""The whole model: embedding, the layers of the pattern, final norm and
head; prefill (last-token logits and every layer's cache) and the
training loss."""
from __future__ import annotations

import importlib
from typing import List

import torch

from portbench.reference.ops import mm, rms
from portbench.weights import layer


def _part(kind: str):
    return importlib.import_module(f"portbench.reference.{kind}")


def _kinds(spec, index):
    return spec["pattern"][index % len(spec["pattern"])]


ROW_TOKENS = 16384  # tokens a block of rows, where rows are independent


def block(p, x, spec, prec, index):
    """x + mixer(x), then + feed-forward -> (x, the mixer's cache). The
    mixer and a dense feed-forward run a block of rows at a time; experts
    see the whole batch (their dispatch groups cross rows)."""
    mix, ff = _kinds(spec, index)
    n = max(1, ROW_TOKENS // x.shape[1])
    rows = [_part(mix).seq(p, x[i:i + n], spec, prec)
            for i in range(0, x.shape[0], n)]
    x = x + torch.cat([y for y, _ in rows])
    cache = {k: torch.cat([c[k] for _, c in rows]) for k in rows[0][1]}
    if ff == "moe":
        x = x + _part(ff).ff(p, x, spec, prec)
    elif ff != "none":
        x = x + torch.cat([_part(ff).ff(p, x[i:i + n], spec, prec)
                           for i in range(0, x.shape[0], n)])
    return x, cache


def head(params, x, spec, prec):
    return mm(rms(x, params["final_ln"], spec["norm_eps"]),
              params["lm_head"], prec)


@torch.no_grad()
def prefill(params, spec, tokens, prec="fp32", keep_cache=True):
    """tokens [B, S] -> (last-token logits [B, V] float32, per-layer
    caches or None)."""
    x = params["embed"][tokens].float()
    caches: List[dict] = []
    for i in range(spec["num_layers"]):
        x, c = block(layer(params, len(spec["pattern"]), i), x, spec, prec,
                     i)
        caches.append(c if keep_cache else None)
    return head(params, x[:, -1], spec, prec), caches


def loss(top: dict, layers: List[dict], spec, tokens, labels, prec="fp32"):
    """Mean next-token cross entropy, each layer recomputed in the
    backward (its inputs kept), on float32 leaves ``top`` (embed,
    final_ln, lm_head) and ``layers`` (one dict a layer)."""
    from torch.utils.checkpoint import checkpoint
    x = top["embed"][tokens]
    for i, p in enumerate(layers):
        names = sorted(p)

        def run(x_, *ts, i=i, names=names):
            return block(dict(zip(names, ts)), x_, spec, prec, i)[0]

        x = checkpoint(run, x, *(p[n] for n in names), use_reentrant=False)
    logits = head(top, x, spec, prec)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - picked).mean()
