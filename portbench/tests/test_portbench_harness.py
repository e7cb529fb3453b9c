"""The harness finds each cell's files by name, BENCHMARK.json keeps the
contract's shape, a cell's last line has exactly the contract's keys,
the prefill schedule repeats its lengths every cycle, and nothing the
harness imports is JAX or the JAX package."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from portbench import spec
from portbench.tests import _tiny

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
ALL = _tiny.CELLS
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", ALL)
def test_a_cell_finds_its_files_by_name(name):
    cell = _tiny.cell(name)
    spec.port_config(cell.config)  # the port runs the file's widths
    driver = spec.driver(cell.traffic)
    for call in ("setup", "window", "release", "outputs", "readings"):
        assert callable(getattr(driver, call))
    for m in [m["name"] for m in cell.per_layer]:
        assert callable(spec.reader(m))
    assert set(cell.limits) <= set(READINGS[cell.traffic["driver"]])


# what each driver's `readings` returns (the limits name those compared)
READINGS = {"train": ("loss_gap", "grad_gap", "change_gap"),
            "prefill_pool": ("logit_err", "gap_share", "kv_err",
                             "state_err", "logit_err_max", "gap_max",
                             "state_err_all", "cache_err_whole",
                             "requests")}


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert all(map(NAME.match, c["reduced"]))
        assert json.loads((spec.ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    for name in CELLS:
        cell = spec.cell(name)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_cells_last_line_has_the_contracts_keys(capsys):
    from portbench import run
    result = run.execute(_tiny.ctx("jamba-52b.prefill-pool"))
    line = json.loads(json.dumps(result))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"prefill_tokens_per_s", "ttft_p95_ms",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 + 11, 2 ** 33 + 7])
def test_the_prefill_lengths_repeat_every_cycle(seed):
    traffic = spec.cell("jamba-52b.prefill-pool").traffic
    L = traffic["lengths"]
    r = traffic["lengths_rule"]
    rule = [r["multiple"] * round(r["lo"] * (r["hi"] / r["lo"]) ** (
        (i + 0.5) / r["n"]) / r["multiple"]) for i in range(r["n"])]
    assert L == rule
    sched = spec.lengths_schedule(L, seed, 5 * len(L))
    for c in range(5):
        assert sorted(sched[c * len(L):(c + 1) * len(L)]) == sorted(L)
    assert sched != spec.lengths_schedule(L, seed + 1, 5 * len(L))


def test_nothing_the_harness_imports_is_jax_or_the_jax_package():
    code = (
        "import importlib, pkgutil, sys, portbench\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "from portbench import spec\n"
        "for c in spec.benchmark()['workloads']:\n"
        "    cell = spec.cell(c['name'])\n"
        "    spec.port_config(cell.config)\n"
        "    [spec.reader(m['name']) for m in cell.per_layer]\n"
        "import repro_torch.launch.train, repro_torch.launch.serve\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, check=True).stdout
    top = set(json.loads(out.strip().replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in top


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.reference.model, "
            "portbench.reference.train, portbench.reference.compare\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, check=True).stdout
    top = set(json.loads(out.strip().replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
