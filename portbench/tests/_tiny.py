"""Tiny cells for the CPU tests: the benchmark's configurations and
traffic at a size a test run holds (`repro_torch.configs.reduced`, float32),
run through the same drivers and reference on the CPU."""
from __future__ import annotations

import copy
import dataclasses

import torch

from portbench import spec
from portbench.drivers import Ctx
from portbench.trace import NoTrace

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]

TRAFFIC = {
    "train-power": {"batch": 2, "seq_len": 32, "trace_skip": 0,
                    "trace_steps": 1},
    "prefill-pool": {"batch": 2, "lengths": [24, 32, 48, 16],
                     "cache_batches": 2, "trace_skip": 0,
                     "trace_batches": 1},
}


def tiny_cfg(arch: str):
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(arch))
    if cfg.moe is not None:  # every expert used, some tokens dropped
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    return cfg


def cell(workload: str):
    return spec.cell(workload)


def traffic_name(workload: str) -> str:
    return next(w["traffic"] for w in spec.benchmark()["workloads"]
                if w["name"] == workload)


def ctx(workload: str, seed: int = 7, seconds: float = 0.0) -> Ctx:
    """A CPU context for ``workload`` at the tiny size."""
    cell_ = copy.deepcopy(cell(workload))
    cfg = tiny_cfg(cell_.config["port"]["arch"])
    cell_.config["as_run"] = spec.as_run(cfg)
    cell_.traffic.update(TRAFFIC[traffic_name(workload)])
    return Ctx(cell=cell_, seed=seed, seconds=seconds,
               device=torch.device("cpu"), tracer=NoTrace(), cfg=cfg,
               log=lambda *a: None)
