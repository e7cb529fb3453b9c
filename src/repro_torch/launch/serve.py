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

``--power`` runs the paper's controller on the decode token rate: after
the first (warm-up) decode step the loop beats into an `NRM`
(`repro_torch.core.nrm`, on the serving device), calibrates it at step 1,
runs `control_step` once per ``sampling_period`` (0.05 s) of simulated
time and reports the simulated energy and time; the generated tokens are
those of the same call without it (power control changes only the
accounting). ``--power --plane`` runs the same control law as tenant
"serve" of a `ControlPlane` (`repro_torch.core.plane`, ticking on the
serving device) driving a `SimulatedPowerActuator` at ``dt=0.05``, as a
multi-model serving host would wire it (``--plane`` alone serves
plainly). ``--obs-port PORT`` exposes a live scrape endpoint
(`repro_torch.obs.serve`; 0 binds a free port) for the decode loop:
``/metrics``, ``/metrics.json``, ``/events`` (the NRM's or the plane's
decision stream) and ``/healthz``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig, PowerControlConfig
from repro_torch.core.nrm import NRM, SimulatedPowerActuator
from repro_torch.core.plane import ControlPlane
from repro_torch.core.plant import PROFILES
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


def _calibrated(plant: str, tok_rate: float):
    """``plant`` with its K_L scaled so that full power gives
    ``tok_rate`` (the NRM's `calibrate`)."""
    base = PROFILES[plant]
    frac_max = base.progress_max / base.K_L
    return dataclasses.replace(base, K_L=tok_rate / max(frac_max, 1e-9))


def serve(cfg: ModelConfig, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device: Union[None, str, torch.device] = None,
          quiet: bool = True, power: bool = False, epsilon: float = 0.15,
          plant: str = "v5e-chip", plane: bool = False,
          obs_port: Optional[int] = None,
          on_obs: Optional[Callable] = None) -> dict:
    """Serve ``cfg`` with random weights from ``seed``: prefill a batch of
    ``batch`` random prompts of ``prompt_len`` tokens, then decode ``gen``
    tokens greedily, through the CUDA kernels (``attn_impl="cuda"``,
    ``scan_impl="cuda"``; their plain versions on the CPU). ``power``
    puts the decode loop under an `NRM` on ``plant`` at ``epsilon``, or
    with ``plane`` under a one-tenant `ControlPlane` (see the module
    docstring). ``obs_port`` starts a scrape endpoint for the call
    (``on_obs(server)`` is called once it listens, before the prefill)
    and stops it at the end. Runs on CUDA unless ``device="cpu"``.
    Returns `main`'s result dict."""
    dev = resolve_device(device)
    obs_srv = None
    if obs_port is not None:
        from repro_torch.obs import serve as obs_serve
        obs_srv = obs_serve.start_server(port=obs_port)
        if not quiet:
            print(f"obs: serving {obs_srv.url}/metrics")
        if on_obs is not None:
            on_obs(obs_srv)
    try:
        return _serve(cfg, batch, prompt_len, gen, seed, dev, quiet, power,
                      epsilon, plant, plane, obs_srv)
    finally:
        if obs_srv is not None:
            obs_srv.stop()


def _serve(cfg, batch, prompt_len, gen, seed, dev, quiet, power, epsilon,
           plant, plane, obs_srv) -> dict:
    total_len = prompt_len + gen
    opts = ApplyOptions(attn_impl="cuda", scan_impl="cuda")

    params = init_params(cfg, seed, dev)
    pre_fn = make_prefill_step(cfg, opts)
    dec_fn = make_decode_step(cfg, opts)
    prompts = make_prompts(cfg, batch, prompt_len, seed, dev)

    logits, cache = pre_fn(params, prompts)
    dec_cache = rehome_cache(cfg, cache, batch, total_len)
    del cache

    nrm = (NRM(PowerControlConfig(epsilon=epsilon, plant_profile=plant,
                                  sampling_period=0.05), device=dev)
           if power and not plane else None)
    if nrm is not None and obs_srv is not None:
        obs_srv.add_event_source("nrm", nrm.events)
    cp = actuator = profile = None
    tokens_out = []
    sim_time, energy, last_ctrl, ctrl_s = 0.0, 0.0, 0.0, 0.0
    next_tok = torch.argmax(logits, dim=-1)[:, None]
    t0 = time.time()
    for i in range(gen):
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
        dt_real = max(time.time() - t1, 1e-5)
        if not power:
            sim_time += dt_real
            continue
        if i == 0:  # the warm-up step (kernel builds, allocator): skipped
            continue
        t2 = time.time()
        if nrm is not None:
            if i == 1:
                nrm.calibrate(float(batch) / dt_real)
            profile, pcap = nrm.profile, nrm.actuator._pcap
        else:
            # the decode loop is tenant "serve" of a ControlPlane: the
            # wiring a multi-model serving host would use, sharing the
            # NRM's control law through plane_step
            if i == 1:
                profile = _calibrated(plant, float(batch) / dt_real)
                actuator = SimulatedPowerActuator(profile, device=dev)
                cp = ControlPlane(profile=profile, epsilon=epsilon,
                                  dt=0.05, device=dev)
                cp.add_tenant("serve")
                if obs_srv is not None:
                    obs_srv.add_event_source("plane", cp.events)
            pcap = actuator._pcap
        # the step slows by the capped progress fraction: its simulated
        # time and the energy the cap lets it draw
        frac = float(profile.static_progress(pcap)) / profile.progress_max
        dt_eff = dt_real / max(frac, 1e-3)
        sim_time += dt_eff
        energy += float(profile.power_of_pcap(pcap)) * dt_eff
        if nrm is not None:
            nrm.heartbeat(work=float(batch), t=sim_time)
            if sim_time - last_ctrl >= nrm.cfg.sampling_period:
                nrm.actuator.advance(sim_time - last_ctrl)
                nrm.control_step(now=sim_time)
                last_ctrl = sim_time
        else:
            cp.ingest(["serve"], [sim_time], [float(batch)])
            if sim_time - last_ctrl >= cp.dt:
                actuator.advance(sim_time - last_ctrl)
                dec = cp.tick(now=sim_time)
                actuator.set_pcap(float(dec["applied"][cp.slot("serve")]))
                last_ctrl = sim_time
        ctrl_s += time.time() - t2

    toks = gen * batch
    act = nrm.actuator if nrm is not None else actuator
    result = {
        "tokens": toks,
        "wall_s": round(time.time() - t0, 3),
        "sim_time_s": round(sim_time, 3),
        "tok_per_s_sim": round(toks / max(sim_time, 1e-9), 2),
        "energy_j": round(energy, 1),
        "final_pcap": round(act._pcap, 1) if act is not None else None,
        # host time the controller (the NRM, or the plane's ticks) took
        # inside the decode loop (--power only)
        "nrm_wall_s": round(ctrl_s, 4) if nrm is not None else None,
        "plane_wall_s": round(ctrl_s, 4) if cp is not None else None,
        # the greedy tokens, [batch, gen]: one key beyond the reference's
        "generated": np.concatenate(tokens_out, axis=1),
    }
    if obs_srv is not None:
        result["obs_url"] = obs_srv.url
    if not quiet:
        print({k: v for k, v in result.items() if k != "generated"})
    return result


def main(argv=None, device: Union[None, str, torch.device] = None,
         on_obs: Optional[Callable] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="qwen3-8b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--power", action="store_true",
                   help="run the decode loop under the NRM's power "
                        "control")
    p.add_argument("--plane", action="store_true",
                   help="route --power through the multi-tenant "
                        "ControlPlane (as its single tenant) instead of "
                        "the in-process NRM: the service wiring, same "
                        "control law")
    p.add_argument("--epsilon", type=float, default=0.15)
    p.add_argument("--plant", default="v5e-chip")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--obs-port", type=int, default=None,
                   help="expose a live scrape endpoint "
                        "(repro_torch.obs.serve) on this port for the "
                        "call: /metrics, /metrics.json, /events, "
                        "/healthz")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    return serve(cfg, args.batch, args.prompt_len, args.gen, args.seed,
                 device, args.quiet, args.power, args.epsilon, args.plant,
                 args.plane, args.obs_port, on_obs)


if __name__ == "__main__":
    main()
