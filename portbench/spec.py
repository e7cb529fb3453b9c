"""Finds what a cell is made of by the names in BENCHMARK.json: the
configuration file, the traffic file, the driver that the traffic names,
the limits of its comparison and the readers of its per-layer metrics.
Adding a cell or a metric adds files and entries; nothing here changes."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, List

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # portbench/configs/<config>.json
    traffic: dict           # portbench/traffic/<traffic>.json
    limits: dict            # portbench/limits/<cell>.json
    end_to_end: List[dict]  # the cell's end-to-end metrics, in file order
    per_layer: List[dict]   # the cell's per-layer metrics, in file order


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json."""
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return make_cell(name, w["config"], w["traffic"],
                             int(w["chips"]), bench)
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def make_cell(name: str, config: str, traffic: str, chips: int = 1,
              bench: dict = None) -> Cell:
    """A cell from its files by name, with the metrics BENCHMARK.json
    gives it (none for a cell it does not hold)."""
    bench = bench or benchmark()
    cfg = next((c for c in bench["configs"] if c["name"] == config),
               {"file": f"portbench/configs/{config}.json"})
    in_bench = any(w["name"] == name for w in bench["workloads"])
    return Cell(
        name=name, chips=chips, config=load_json(ROOT / cfg["file"]),
        traffic=load_json(HERE / "traffic" / f"{traffic}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if in_bench and _applies(m, name)],
        per_layer=[m for m in bench["per_layer"]
                   if in_bench and _applies(m, name)])


def driver(traffic: dict):
    """The driver module a traffic file names (``portbench/drivers/``)."""
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def reader(metric: str) -> Callable:
    """``read(ctx)`` of ``portbench/layer_metrics/<metric>.py``."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.layer_metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_config(config: dict):
    """The port's `ModelConfig` as the configuration file says it is run:
    the port's arch with the file's replacements, checked against the
    file's ``as_run`` widths."""
    from repro_torch.configs import get_config
    cfg = get_config(config["port"]["arch"])
    cfg = dataclasses.replace(cfg, **config["port"].get("replace", {}))
    got = as_run(cfg)
    bad = {k: (got.get(k), v) for k, v in config["as_run"].items()
           if got.get(k) != v}
    if bad:
        raise ValueError(f"{config['name']}: the port's config differs from "
                         f"the file's as_run: {bad}")
    return cfg


def as_run(cfg) -> dict:
    """A port `ModelConfig` in the terms of a configuration file's
    ``as_run`` (what the references read)."""
    got = {"d_model": cfg.d_model, "num_heads": cfg.attn.num_heads,
           "num_kv_heads": cfg.attn.num_kv_heads,
           "head_dim": cfg.attn.head_dim, "rope_theta": cfg.attn.rope_theta,
           "sliding_window": cfg.attn.sliding_window,
           "norm_eps": cfg.norm_eps, "vocab_size": cfg.vocab_size,
           "num_layers": cfg.num_layers, "d_ff": cfg.d_ff,
           "pattern": [[b.kind, b.ff] for b in cfg.pattern],
           "mlp": ("swiglu" if cfg.mlp_gated else "gelu_tanh"),
           "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype}
    if cfg.moe is not None:
        m = cfg.moe
        got["moe"] = {"num_experts": m.num_experts, "top_k": m.top_k,
                      "d_ff": m.d_ff, "gated": m.gated,
                      "capacity_factor": m.capacity_factor,
                      "group_size": m.group_size,
                      "router_aux_weight": m.router_aux_weight}
    if cfg.mamba is not None:
        import math
        m = cfg.mamba
        got["mamba"] = {"d_state": m.d_state, "d_conv": m.d_conv,
                        "expand": m.expand,
                        "dt_rank": m.dt_rank or math.ceil(cfg.d_model / 16)}
    return got


def lengths_schedule(lengths: List[int], seed: int, n_batches: int,
                     ) -> List[int]:
    """The prompt length of each of ``n_batches`` batches: ``lengths`` in
    an order drawn from ``seed`` anew each cycle, so every cycle holds the
    same lengths and the seed moves only their order."""
    import numpy as np
    from portbench.seeds import sub
    out: List[int] = []
    cycle = 0
    while len(out) < n_batches:
        rng = np.random.default_rng(sub(seed, "lengths", cycle))
        out.extend(int(lengths[i]) for i in rng.permutation(len(lengths)))
        cycle += 1
    return out[:n_batches]
