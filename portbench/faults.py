"""Faults planted under the timed path, for the test that sees ``correct``
come out false: each wraps a function of the program for the span of a
``with planted(name, ctx):`` block.

- ``state_unchanged`` (training): the optimizer returns without writing
  the parameters or moments;
- ``half_batch`` (training): the loss is the mean over the first half of
  the rows, the rest left out;
- ``answer_altered``: the loss a training step reports is 5% high; a
  prefill step's logits are shifted by one place along the vocabulary in
  every row, so each served token is the next id after the right one;
- ``slots_swapped`` (prefill): the second half of every batch's slots get
  the first half's answers;
- ``bucket_swapped`` (prefill): in the batches of the longest prompts
  alone, each slot gets the next slot's answer."""
from __future__ import annotations

import contextlib
import importlib

import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered",
          "slots_swapped", "bucket_swapped")


@contextlib.contextmanager
def _patched(module: str, attr: str, make):
    m = importlib.import_module(module)
    fn = getattr(m, attr)
    setattr(m, attr, make(fn))
    try:
        yield
    finally:
        setattr(m, attr, fn)


def _unchanged(fn):
    def apply_adamw(cfg, quads, step, lr):
        from repro_torch.optim.adamw import global_norm
        return global_norm(g for _, g, _, _ in quads)
    return apply_adamw


def _half(fn):
    def loss_fn(cfg, opts, params, batch):
        half = next(iter(batch.values())).shape[0] // 2
        return fn(cfg, opts, params, {k: v[:half] for k, v in batch.items()})
    return loss_fn


def _loss_high(fn):
    def loss_fn(*a, **k):
        loss, metrics = fn(*a, **k)
        return loss * 1.05, metrics
    return loss_fn


def _answers(alter):
    """A prefill whose last-token logits pass through ``alter(logits,
    prompt length)``."""
    def make(fn):
        def prefill(cfg, opts, params, batch):
            logits, cache = fn(cfg, opts, params, batch)
            return alter(logits, batch["tokens"].shape[1]), cache
        return prefill
    return make


def _slots(logits, _):
    h = logits.shape[0] // 2
    return torch.cat([logits[:h], logits[:logits.shape[0] - h]])


def _bucket(longest):
    def alter(logits, length):
        return torch.roll(logits, 1, dims=0) if length == longest else logits
    return alter


def planted(name: str, ctx):
    """The fault ``name`` planted for the cell of ``ctx``."""
    driver = ctx.traffic["driver"]
    if name == "state_unchanged" and driver == "train":
        return _patched("repro_torch.launch.steps", "apply_adamw", _unchanged)
    if name == "half_batch" and driver == "train":
        return _patched("repro_torch.models.model", "loss_fn", _half)
    if name == "answer_altered" and driver == "train":
        return _patched("repro_torch.models.model", "loss_fn", _loss_high)
    alter = {"answer_altered": lambda lg, _: torch.roll(lg, 1, dims=-1),
             "slots_swapped": _slots,
             "bucket_swapped": _bucket(max(ctx.traffic.get("lengths", [0])))}
    if name in alter and driver == "prefill_pool":
        return _patched("repro_torch.models.model", "prefill",
                        _answers(alter[name]))
    raise ValueError(f"fault {name!r} does not apply to a {driver} cell")
