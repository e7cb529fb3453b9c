"""Batched serving driver: prefill a batch of prompts, then decode
greedily token by token; port of `repro.launch.serve`.

The reference's CLI runs the plain attention path
(``attn_impl="reference"``) and the chunked Mamba scan; the port serves
through its CUDA kernels (``attn_impl="cuda"``: flash attention in
prefill, split-KV decode in decode; ``scan_impl="cuda"``: the selective
scan of Mamba blocks in both), which fall to their plain versions on the
CPU. Weights are random, made from ``--seed``. `serve` runs the same
driver on a given ``ModelConfig`` (for instance a depth-cut one).

CPU quickstart:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --reduced --batch 4 --prompt-len 64 --gen 32
(runs on the card by default; from Python, ``main([...], device="cpu")``
runs on the CPU.)

``--power`` and ``--plane`` (the paper's controller on the decode token
rate) wait for the NRM and ControlPlane port, ``--obs-port`` for the
observability services; they raise NotImplementedError.
"""
from __future__ import annotations

import argparse
import time
from typing import Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import init_params
from repro_torch.models import model as M
from repro_torch.models.layers import is_def, tree_map
from repro_torch.models.types import ApplyOptions


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                 device) -> dict:
    """The prompt batch `main` serves: random token ids (or, for
    ``input_mode="embeds"``, frame embeddings) drawn on the CPU from
    ``seed``, so every device gets the same prompts."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.input_mode == "tokens":
        toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                             generator=gen, dtype=torch.int64)
        return {"tokens": toks.to(device)}
    emb = 0.05 * torch.randn((batch, prompt_len, cfg.d_model),
                             generator=gen)
    return {"embeds": emb.to(device, getattr(torch, cfg.compute_dtype))}


def rehome_cache(cfg: ModelConfig, cache: dict, batch: int, total_len: int
                 ) -> dict:
    """Re-home a prefill cache into the decode-length cache, as the
    reference's ``place``: each leaf is zero-padded up to its def's shape
    (KV tensors along the sequence up to ``total_len``; a sliding window's
    ring and the Mamba states keep their size) and cast to its def's dtype
    (the compute dtype, but float32 for the Mamba ``ssm`` state)."""
    defs = M.cache_defs(cfg, batch, total_len)["blocks"]

    def place(d, src):
        dtype = getattr(torch, d.dtype or cfg.compute_dtype)
        if tuple(src.shape) == d.shape:
            return src.to(dtype)
        out = src.new_zeros(d.shape, dtype=dtype)
        out[tuple(slice(0, n) for n in src.shape)] = src
        return out

    return {"blocks": tree_map(place, defs, cache["blocks"], is_leaf=is_def),
            "pos": int(cache["pos"])}


def serve(cfg: ModelConfig, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device: Union[None, str, torch.device] = None,
          quiet: bool = True) -> dict:
    """Serve ``cfg`` with random weights from ``seed``: prefill a batch of
    ``batch`` random prompts of ``prompt_len`` tokens, then decode ``gen``
    tokens greedily, through the CUDA kernels (``attn_impl="cuda"``,
    ``scan_impl="cuda"``; their plain versions on the CPU). Runs on CUDA
    unless ``device="cpu"``. Returns `main`'s result dict."""
    dev = resolve_device(device)
    total_len = prompt_len + gen
    opts = ApplyOptions(attn_impl="cuda", scan_impl="cuda")

    params = init_params(cfg, seed, dev)
    pre_fn = make_prefill_step(cfg, opts)
    dec_fn = make_decode_step(cfg, opts)
    prompts = make_prompts(cfg, batch, prompt_len, seed, dev)

    logits, cache = pre_fn(params, prompts)
    dec_cache = rehome_cache(cfg, cache, batch, total_len)
    del cache

    tokens_out = []
    sim_time = 0.0
    next_tok = torch.argmax(logits, dim=-1)[:, None]
    t0 = time.time()
    for _ in range(gen):
        if cfg.input_mode == "tokens":
            dec_batch = {"tokens": next_tok}
        else:
            dec_batch = {"embeds": 0.05 * torch.ones(
                (batch, 1, cfg.d_model), device=dev,
                dtype=getattr(torch, cfg.compute_dtype))}
        t1 = time.time()
        logits, dec_cache = dec_fn(params, dec_cache, dec_batch)
        next_tok = torch.argmax(logits, dim=-1)[:, None]
        tokens_out.append(next_tok.cpu().numpy())  # waits for the step
        sim_time += max(time.time() - t1, 1e-5)

    toks = gen * batch
    result = {
        "tokens": toks,
        "wall_s": round(time.time() - t0, 3),
        "sim_time_s": round(sim_time, 3),
        "tok_per_s_sim": round(toks / max(sim_time, 1e-9), 2),
        "energy_j": 0.0,
        "final_pcap": None,
        # the greedy tokens, [batch, gen]: one key beyond the reference's
        "generated": np.concatenate(tokens_out, axis=1),
    }
    if not quiet:
        print({k: v for k, v in result.items() if k != "generated"})
    return result


def main(argv=None, device: Union[None, str, torch.device] = None
         ) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="qwen3-8b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--power", action="store_true")
    p.add_argument("--plane", action="store_true",
                   help="route --power through the multi-tenant "
                        "ControlPlane (not ported yet)")
    p.add_argument("--epsilon", type=float, default=0.15)
    p.add_argument("--plant", default="v5e-chip")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--obs-port", type=int, default=None,
                   help="live scrape endpoint (not ported yet)")
    args = p.parse_args(argv)

    if args.power or args.plane:
        raise NotImplementedError(
            "--power / --plane need the NRM and ControlPlane port: ROADMAP "
            "Queue 1 item 7")
    if args.obs_port is not None:
        raise NotImplementedError(
            "--obs-port needs the observability services' port: ROADMAP "
            "Queue 1 item 8")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    return serve(cfg, args.batch, args.prompt_len, args.gen, args.seed,
                 device, args.quiet)


if __name__ == "__main__":
    main()
