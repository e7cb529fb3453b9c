"""Runs one sharded scenario of the port on gloo CPU ranks and saves
what rank 0 sees, for `tests/test_torch_mesh_steps.py`.

  PYTHONPATH=src python tests/_torch_mesh_ranks.py SCENARIO OUT.npz

Each rank is a spawned process on a ``FileStore`` beside OUT (no
network). Scenarios (`SCENARIOS`): a reduced qwen3-8b under ``tp`` on
(1, 2) (prefill and greedy decode through the kernels' plain versions
under ``local_map``; then `serve.main` and `train.main` with
checkpoints and a resume, as under ``torchrun``), a reduced starcoder2-3b train step from
`steps.make_step` under ``fsdp_tp`` with ZeRO-1 on (2, 2), and a reduced
jamba (Mamba + MoE) prefill under ``tp`` on (1, 2).
"""
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch.serve import rehome_cache
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_step, opt_rules_for)
from repro_torch.models import init_params
from repro_torch.models import model as M
from repro_torch.models.layers import materialize, place, tree_leaves_with_path
from repro_torch.models.types import ApplyOptions
from repro_torch.optim.adamw import adamw_init_defs

# the plain versions of the flash and scan kernels, under local_map
OPTS = ApplyOptions(attn_impl="cuda", scan_impl="cuda", block_q=8)
SERVE_B, PROMPT, GEN = 2, 16, 4
TRAIN_B, TRAIN_S = 4, 32
TRAIN_KW = dict(learning_rate=1e-3, total_steps=10, warmup_steps=1,
                microbatch=2)

# the entry points as a user runs them under torchrun, on the qwen3_tp
# spawn's (1, 2) group: serve, then train with a checkpoint every step
# and a second call that resumes for one more step
ENTRY_SERVE = ["--arch", "qwen3-8b", "--reduced", "--batch", "2",
               "--prompt-len", "16", "--gen", "4", "--quiet"]
ENTRY_STEPS, ENTRY_LR = 3, 1e-3
ENTRY_TRAIN = ["--arch", "starcoder2-3b", "--reduced", "--batch", "4",
               "--seq", "32", "--lr", str(ENTRY_LR), "--checkpoint-every",
               "1", "--quiet"]

SCENARIOS = {
    # name: (arch, recipe, mesh shape)
    "qwen3_tp": ("qwen3-8b", "tp", (1, 2)),
    "starcoder2_train": ("starcoder2-3b", "fsdp_tp", (2, 2)),
    "jamba_tp": ("jamba-v0.1-52b", "tp", (1, 2)),
}


def scenario_cfg(name):
    arch, recipe, _ = SCENARIOS[name]
    return dataclasses.replace(reduced(get_config(arch)),
                               sharding_recipe=recipe)


def prompts(cfg, batch=SERVE_B, seq=PROMPT, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))


def train_batch(cfg, seed=4):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (TRAIN_B, TRAIN_S)))
            for k in ("tokens", "labels")}


def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def serve_greedy(cfg, params, rules, gen=GEN):
    """Prefill the prompts, then decode ``gen`` tokens greedily ->
    {"prefill": logits, "decode": [gen, B, V] logits, "tokens": [B, gen]}."""
    toks = prompts(cfg)
    tok_def = M.input_defs(cfg, ShapeConfig("s", "prefill", PROMPT,
                                            SERVE_B))
    pre = make_prefill_step(cfg, OPTS, rules)
    dec = make_decode_step(cfg, OPTS, rules)
    logits, cache = pre(params, place({"tokens": toks}, tok_def, rules))
    out = {"prefill": whole(logits).numpy()}
    if not gen:
        return out
    cache = rehome_cache(cfg, cache, SERVE_B, PROMPT + gen, rules)
    dec_def = M.input_defs(cfg, ShapeConfig("d", "decode", PROMPT + gen,
                                            SERVE_B))
    nxt = torch.argmax(whole(logits), dim=-1)[:, None]
    steps, got = [], []
    for _ in range(gen):
        logits, cache = dec(params, cache, place({"tokens": nxt}, dec_def,
                                                 rules))
        lw = whole(logits)
        steps.append(lw.numpy())
        nxt = torch.argmax(lw, dim=-1)[:, None]
        got.append(nxt.numpy())
    out.update(decode=np.stack(steps), tokens=np.concatenate(got, axis=1))
    return out


def entry_points(ckpt_dir):
    """`serve.main` and `train.main` on this process's group (the host
    mesh spans its ranks) -> the greedy tokens, the losses (first and
    last of the first call, last of the resumed one), the DTensor
    leaves of each."""
    from repro_torch.launch import serve, train
    s = serve.main(ENTRY_SERVE, device="cpu")
    argv = ENTRY_TRAIN + ["--checkpoint-dir", str(ckpt_dir)]
    t = train.main(argv + ["--steps", str(ENTRY_STEPS)], device="cpu")
    r = train.main(argv + ["--steps", str(ENTRY_STEPS + 1), "--resume"],
                   device="cpu")
    out = {"entry/tokens": s["generated"],
           "entry/losses": np.array([t["first_loss"], t["final_loss"],
                                     r["final_loss"]]),
           "entry/dtensor_leaves": np.array([s["dtensor_leaves"],
                                             t["dtensor_leaves"],
                                             r["dtensor_leaves"]]),
           "entry/mesh": np.array(s["mesh"])}
    return out


def checkpoint_arrays(ckpt_dir):
    """The last checkpoint `entry_points` wrote (rank 0 writes), under
    ``ckpt/``."""
    with np.load(f"{ckpt_dir}/step_{ENTRY_STEPS:09d}/arrays.npz") as z:
        return {"ckpt/" + k: z[k] for k in z.files}


def _is_placements(x):
    from torch.distributed.tensor import Placement
    return isinstance(x, tuple) and bool(x) and all(
        isinstance(e, Placement) for e in x)


def train_once(cfg, mesh, rules):
    """One `make_step` train step (its placements checked against the
    real state's) -> metrics and every new leaf, whole."""
    shape = ShapeConfig("t", "train", TRAIN_S, TRAIN_B)
    tcfg = TrainConfig(**TRAIN_KW)
    fn, args, in_pl, out_pl, donate = make_step(cfg, OPTS, mesh, shape, tcfg)
    opt_rules = opt_rules_for(cfg, tcfg, mesh)
    params = init_params(cfg, 1, "cpu", rules=rules)
    opt = materialize(adamw_init_defs(M.model_defs(cfg)), 1, torch.float32,
                      "cpu", rules=opt_rules)
    batch = place(train_batch(cfg), M.input_defs(cfg, shape), rules)
    for tree, pl_tree in zip((params, opt, batch), in_pl):
        for (path, t), (_, pl) in zip(tree_leaves_with_path(tree),
                                      tree_leaves_with_path(
                                          pl_tree, _is_placements)):
            assert tuple(getattr(t, "placements", pl)) == tuple(pl), path
    new_p, new_o, metrics = fn(params, opt, batch)
    out = {f"metric/{k}": whole(v).numpy() for k, v in metrics.items()}
    for pre, tree in (("p", new_p), ("m", new_o["m"]), ("v", new_o["v"])):
        for path, t in tree_leaves_with_path(tree):
            out[pre + path] = whole(t).float().numpy()
    out["step"] = whole(new_o["step"]).numpy()
    return out


def _rank(rank, world, name, out_path, store_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        _, recipe, shape = SCENARIOS[name]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))
        cfg = scenario_cfg(name)
        rules = make_rules(recipe, mesh)
        if name == "starcoder2_train":
            out = train_once(cfg, mesh, rules)
        else:
            params = init_params(cfg, 0, "cpu", rules=rules)
            out = serve_greedy(cfg, params, rules,
                               gen=GEN if name == "qwen3_tp" else 0)
        if name == "qwen3_tp":
            out.update(entry_points(out_path + ".ckpt"))
            # the entry points leave the caller's group up
            out["entry/group_kept"] = np.array(dist.is_initialized())
        if rank == 0:
            if name == "qwen3_tp":
                out.update(checkpoint_arrays(out_path + ".ckpt"))
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


def run(name, out_path):
    world = int(np.prod(SCENARIOS[name][2]))
    store = out_path + ".store"
    if os.path.exists(store):
        os.remove(store)
    mp.spawn(_rank, args=(world, name, out_path, store), nprocs=world,
             join=True)


if __name__ == "__main__":
    run(sys.argv[1], sys.argv[2])
