"""The drivers of the window, one a kind of traffic, each named by the
``driver`` key of a traffic file. A driver has five calls:

- ``setup(ctx)``: weights from the seed, the program's objects, warm-up
  of every shape the traffic uses, and the first steps that the check
  follows -> state;
- ``window(state, ctx)``: the measured window -> `Window`;
- ``release(state)``: frees the program's state, keeping what the check
  reads;
- ``outputs(state, ctx, prec)``: the reference's outputs (``prec``
  "fp32"), or the control's ("fp8");
- ``readings(state, ref, got=None)``: the numbers compared, the program's
  outputs (or ``got``, the control's) against ``ref``."""
from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List

import torch


@dataclasses.dataclass
class Ctx:
    cell: object        # spec.Cell
    seed: int
    seconds: float
    device: torch.device
    tracer: object      # trace.NoTrace or trace.Tracer
    cfg: object         # the port's ModelConfig
    log: object = print

    @property
    def spec(self) -> dict:
        return self.cell.config["as_run"]

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclasses.dataclass
class Window:
    metrics: Dict[str, float]   # end-to-end, by name
    attempted: int
    failed: int
    seconds: float
    host: Dict[str, List[float]]  # host-clock series the readers use


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def before_experts(spec: dict) -> list:
    """The layers whose mixers no expert layer precedes: their caches
    follow from the prompt by continuous arithmetic alone (an expert
    layer's capacity decides by a hair which late tokens of a dispatch
    group it drops, and a token so sent another way differs in any
    precision below float32)."""
    P, out = spec["pattern"], []
    for i in range(spec["num_layers"]):
        out.append(i)
        if P[i % len(P)][1] == "moe":
            break
    return out


def layer_cache(cache: dict, pattern_len: int, index: int) -> dict:
    """Layer ``index``'s slice of a port cache (views)."""
    return {k: t[index // pattern_len]
            for k, t in cache["blocks"][index % pattern_len].items()}
