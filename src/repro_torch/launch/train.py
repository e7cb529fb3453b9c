"""End-to-end training driver with the paper's power controller in the
loop; port of `repro.launch.train`.

The loop couples three systems:

* the train step (`steps.make_train_step`, under the rules of the host
  mesh, `launch.mesh.host_mesh`: on one card nothing is placed),
* the data pipeline (checkpointable, deterministic),
* the NRM power-control loop (`repro_torch.core.nrm`, on the training
  device): every optimizer step emits a heartbeat whose work is the
  step's tokens; each control period the PI controller picks a power
  cap. A simulated plant (the identified physics of ``--plant``)
  modulates the *effective* step time and energy, so the whole control
  loop is exercised end to end: cap down -> progress down (if
  compute-bound) -> controller finds the knee. The first step (kernel
  builds, allocator warm-up) is skipped for calibration; the second
  calibrates the plant to the measured token rate.

Checkpointing covers params, optimizer, data iterator AND controller
state (restart-safe power control). ``--resume`` restores the latest
checkpoint; ``--kill-at`` demonstrates fault tolerance by exiting 17
mid-run.

The reference's CLI runs the plain attention paths (``"reference"`` up
to 1,024 tokens, ``"blocked"`` above); the port trains through its flash
kernel (``attn_impl="cuda"``: the CUDA forward on the card, its plain
version on the CPU; the backward recomputes through the plain version,
as the reference's does) and the chunked Mamba scan. `train` runs the
same loop on a given ``ModelConfig`` (for instance a depth-cut one).

CPU quickstart:
  PYTHONPATH=src python -c "from repro_torch.launch import train; \\
      print(train.main(['--reduced', '--steps', '8', '--batch', '2', \\
      '--seq', '32', '--power', '--quiet'], device='cpu'))"
(runs on the card by default: ``python -m repro_torch.launch.train
--reduced ...``.)
"""
from __future__ import annotations

import argparse
import time
from typing import Union

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (ModelConfig, PowerControlConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core.nrm import NRM
from repro_torch.data.pipeline import TokenIterator, for_config
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch.mesh import describe, dtensor_leaves, host_mesh
from repro_torch.launch.steps import opt_rules_for, make_train_step
from repro_torch.models import init_params
from repro_torch.models import model as M
from repro_torch.models.layers import materialize
from repro_torch.models.types import ApplyOptions
from repro_torch.optim.adamw import adamw_init_defs
from repro_torch.optim.compression import ef_init_defs


def train(cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig, *,
          power: bool = False, epsilon: float = 0.10,
          plant: str = "v5e-chip", adaptive: bool = False,
          control_period: float = 1.0, checkpoint_dir: str = "",
          checkpoint_every: int = 20, resume: bool = False,
          kill_at: int = 0, quiet: bool = True,
          device: Union[None, str, torch.device] = None) -> dict:
    """Train ``cfg`` from random weights (seeded by ``tcfg.seed``) on the
    synthetic LM stream for ``tcfg.total_steps`` steps of ``shape``, under
    the NRM with ``power`` (see the module docstring), through the flash
    kernel (``attn_impl="cuda"``). Runs on CUDA unless ``device="cpu"``.
    Returns `main`'s result dict: the reference's keys, and
    ``step_wall_s`` (each step's wall), ``pcaps`` (the cap after each
    control period), ``nrm_wall_s`` (host time in the NRM; None
    without ``power``), ``restored_step`` (the checkpoint a resume
    restored; None otherwise), ``start_step`` (the first step run),
    ``mesh`` (the host mesh, `launch.mesh.describe`)
    and ``dtensor_leaves`` (params placed as DTensors; 0 on one rank)."""
    dev = resolve_device(device)
    opts = ApplyOptions(attn_impl="cuda", scan_impl="chunked")
    with host_mesh(dev) as mesh:
        rules = make_rules(cfg.sharding_recipe, mesh)
        step_fn = make_train_step(cfg, tcfg, opts, rules)

        # --- state init or resume ---------------------------------------
        param_defs = M.model_defs(cfg)
        params = init_params(cfg, tcfg.seed, dev, rules=rules)
        opt_state = materialize(adamw_init_defs(param_defs, tcfg.moment_dtype),
                                tcfg.seed, torch.float32, dev,
                                rules=opt_rules_for(cfg, tcfg, mesh))
        use_ef = tcfg.grad_compression == "int8_ef"
        ef_state = (materialize(ef_init_defs(param_defs), tcfg.seed,
                                torch.float32, dev, rules=rules)
                    if use_ef else None)
        it = TokenIterator(for_config(cfg, shape, seed=tcfg.seed), device=dev)
        pc_cfg = PowerControlConfig(enabled=power, epsilon=epsilon,
                                    plant_profile=plant, adaptive=adaptive,
                                    sampling_period=control_period)
        nrm = NRM(pc_cfg, device=dev) if power else None

        mgr = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        start_step, restored = 0, None
        if mgr and resume and mgr.latest_step() is not None:
            restored = mgr.latest_step()
            tree, extra = mgr.restore(restored, template={"params": params,
                                                          "opt": opt_state})
            params, opt_state = tree["params"], tree["opt"]
            it.load_state_dict(extra["data"])
            if nrm:
                nrm.load_state_dict(extra["nrm"])
            start_step = extra["step"]
            print(f"[resume] restored step {start_step}")

        # --- plant coupling -----------------------------------------------
        profile = nrm.profile if nrm else None
        calibrated = False
        sim_time, energy, last_ctrl, nrm_s = 0.0, 0.0, 0.0, 0.0
        losses, walls, pcaps = [], [], []

        t_wall0 = time.time()
        for step in range(start_step, tcfg.total_steps):
            if kill_at and step == kill_at:
                print(f"[fault] simulated node failure at step {step}")
                raise SystemExit(17)
            batch = next(it)
            t0 = time.time()
            out = step_fn(params, opt_state, batch, ef_state)
            if use_ef:
                params, opt_state, metrics, ef_state = out
            else:
                params, opt_state, metrics = out
            loss = float(metrics["loss"])  # waits for the step
            losses.append(loss)
            dt_real = max(time.time() - t0, 1e-4)
            walls.append(dt_real)

            if nrm:
                if step == start_step:
                    # the first step builds the kernels and warms the
                    # allocator: skipped (a wrong rate here mis-identifies K_L
                    # and destabilizes the PI gains)
                    continue
                t1 = time.time()
                tokens_per_step = float(shape.tokens)
                if not calibrated:
                    # the plant's gain from this workload's full-power token
                    # rate (progress units = tokens/s)
                    nrm.calibrate(tokens_per_step / dt_real)
                    profile = nrm.profile
                    calibrated, last_ctrl = True, 0.0
                # plant modulation: progress fraction at the current cap
                frac = float(profile.static_progress(
                    nrm.actuator._pcap)) / profile.progress_max
                dt_eff = dt_real / max(frac, 1e-3)
                sim_time += dt_eff
                energy += float(profile.power_of_pcap(nrm.actuator._pcap)) \
                    * dt_eff
                nrm.heartbeat(work=tokens_per_step, t=sim_time)
                if sim_time - last_ctrl >= pc_cfg.sampling_period:
                    nrm.actuator.advance(sim_time - last_ctrl)
                    nrm.control_step(now=sim_time)
                    pcaps.append(float(nrm.actuator._pcap))
                    last_ctrl = sim_time
                nrm_s += time.time() - t1
            else:
                sim_time += dt_real

            if mgr and step > 0 and step % checkpoint_every == 0:
                extra = {"step": step + 1, "data": it.state_dict(),
                         "nrm": nrm.state_dict() if nrm else {}}
                mgr.save(step, {"params": params, "opt": opt_state}, extra)
            if not quiet and (step % 10 == 0 or step == tcfg.total_steps - 1):
                pcap = f" pcap={nrm.actuator._pcap:6.1f}W" if nrm else ""
                print(f"step {step:5d} loss={loss:.4f}"
                      f" lr={float(metrics['lr']):.2e}{pcap}")
        if mgr:
            mgr.wait()

        result = {
            "final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "steps": tcfg.total_steps - start_step,
            "restored_step": restored,
            "start_step": start_step,
            "wall_s": time.time() - t_wall0,
            "sim_time_s": sim_time,
            "energy_j": energy,
            "step_wall_s": walls,
            "pcaps": pcaps,
            "nrm_wall_s": nrm_s if nrm else None,
            # the host mesh the step ran under, and how many weights it placed
            # as DTensors (none on one rank)
            "mesh": describe(mesh),
            "dtensor_leaves": dtensor_leaves(params),
        }
        if not quiet:
            print({k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in result.items()
                   if k not in ("step_wall_s", "pcaps")})
        return result


def main(argv=None, device: Union[None, str, torch.device] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="qwen3-8b")
    p.add_argument("--reduced", action="store_true",
                   help="reduced same-family config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--microbatch", type=int, default=0)
    p.add_argument("--grad-compression", default="none",
                   choices=("none", "int8_ef"))
    p.add_argument("--power", action="store_true",
                   help="enable the paper's PI power controller")
    p.add_argument("--epsilon", type=float, default=0.10)
    p.add_argument("--plant", default="v5e-chip")
    p.add_argument("--adaptive", action="store_true")
    p.add_argument("--control-period", type=float, default=1.0,
                   help="controller sampling period in simulated "
                   "seconds (smoke tests shrink it so a handful of "
                   "optimizer steps spans several control periods)")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=20)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--kill-at", type=int, default=0,
                   help="simulate a node failure at this step (exit 17)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeConfig("train_custom", "train", args.seq, args.batch)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10),
                       microbatch=args.microbatch,
                       grad_compression=args.grad_compression,
                       seed=args.seed)
    return train(cfg, shape, tcfg, power=args.power, epsilon=args.epsilon,
                 plant=args.plant, adaptive=args.adaptive,
                 control_period=args.control_period,
                 checkpoint_dir=args.checkpoint_dir,
                 checkpoint_every=args.checkpoint_every,
                 resume=args.resume, kill_at=args.kill_at,
                 quiet=args.quiet, device=device)


if __name__ == "__main__":
    main()
