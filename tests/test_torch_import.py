"""The port stands alone: importing it loads neither jax nor the JAX
package, and its entry points refuse to run quietly on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_import_loads_no_jax_and_no_reference():
    """Importing the port, its models, its serving driver and its kernel
    packages loads no jax and no `repro`, and loads (so builds) no
    kernel library."""
    code = ("import sys, repro_torch, repro_torch.core.sim, "
            "repro_torch.kernels.closed_loop.ops, repro_torch.convert, "
            "repro_torch.models, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.kernels.selective_scan, "
            "repro_torch.kernels.selective_scan.cases, "
            "repro_torch.models.mamba, repro_torch.models.moe, "
            "repro_torch.obs, repro_torch.obs.metrics, "
            "repro_torch.obs.trace, repro_torch.obs.retry, "
            "repro_torch.core.identify, repro_torch.core.signals, "
            "repro_torch.core.poisson, repro_torch.core.adaptive, "
            "repro_torch.core.policies, repro_torch.core.plane, "
            "repro_torch.core.fma, repro_torch.core.phases, "
            "repro_torch.core.workloads, repro_torch.core.faults, "
            "repro_torch.core.workloads.schedule, "
            "repro_torch.core.workloads.detect, repro_torch.obs.events, "
            "repro_torch.core.executor, repro_torch.core.supervisor, "
            "repro_torch.core.nrm, repro_torch.obs.sink, "
            "repro_torch.core.hierarchy, repro_torch.obs.serve, "
            "repro_torch.obs.validate, repro_torch.obs.regress\n"
            "from repro_torch.kernels import _build\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.') or m == 'triton')\n"
            "bad += ['built'] * len(_build._LOADED)\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_entry_points_refuse_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from repro_torch import resolve_device
    from repro_torch.core import sim
    from repro_torch.kernels.closed_loop import ops
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.draw_noise([1, 2], 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.sweep("gros", [0.1], [0], total_work=10.0, max_time=64.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.simulate_closed_loop("gros", 0.1, total_work=10.0,
                                 max_time=64.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.sweep("gros", [0.1], [0], total_work=10.0, max_time=64.0,
                  backend="scan")
    from repro_torch.core.adaptive import RLSConfig
    from repro_torch.core.policies import (DutyCyclePolicy, PIPolicy,
                                           fit_offline_rl)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.sweep("gros", [0.1], [0], total_work=10.0, max_time=64.0,
                  policies=[PIPolicy(), DutyCyclePolicy()])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.sweep("gros", [0.1], [0], total_work=10.0, max_time=64.0,
                  adaptive=[RLSConfig()])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.simulate_closed_loop("gros", 0.1, total_work=10.0,
                                 max_time=64.0, adaptive=RLSConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.simulate_closed_loop("gros", 0.1, total_work=10.0,
                                 max_time=64.0, policy=DutyCyclePolicy())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_offline_rl({k: [0.5, 0.6] for k in ("s", "a", "r", "s2")})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.open_loop_runs("gros", 40, range(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.replay_model("gros", [60.0, 80.0])
    from repro_torch.core import identify, signals
    with pytest.raises(RuntimeError, match="no CUDA device"):
        identify.fit_static([40, 80, 120], [40, 75, 107], [10, 20, 24])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        identify.pearson([1.0, 2.0], [2.0, 1.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        identify.static_campaign("gros")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        signals.progress_from_times([0.0, 0.5, 1.0])
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(reduced(get_config("qwen3-8b")), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--quiet"])
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_scenario_makers_refuse_to_run_without_cuda():
    """The scenario slice's tensor-making functions and entry points run
    on CUDA by default, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from repro_torch.core import faults as flt
    from repro_torch.core import sim
    from repro_torch.core.plant import PROFILES
    from repro_torch.core.workloads import (DetectorConfig, Phase,
                                            PhaseSchedule, detector_values)
    from repro_torch.obs import events as evt
    sched = PhaseSchedule((Phase(10.0),))
    makers = [lambda: sched.resolve("gros"),
              lambda: flt.FaultSchedule().resolve(),
              lambda: detector_values(DetectorConfig(), PROFILES["gros"]),
              lambda: flt.guard_values(), lambda: flt.guard_init(),
              lambda: flt.fault_state_init(PROFILES["gros"]),
              lambda: evt.ring_init(8),
              lambda: sim.sweep("gros", [0.1], [0], total_work=10.0,
                                max_time=64.0, workloads=sched),
              lambda: sim.sweep("gros", [0.1], [0], total_work=10.0,
                                max_time=64.0, faults=flt.FaultSchedule(),
                                guard=True, record_events=True),
              lambda: sim.simulate_closed_loop(
                  "gros", 0.1, total_work=10.0, max_time=64.0,
                  detector=DetectorConfig())]
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert sched.resolve("gros", device="cpu").ends.device.type == "cpu"


def test_runtime_entry_points_refuse_to_run_without_cuda(tmp_path):
    """The execution layer and the runtime run on CUDA by default, and
    raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    import numpy as np
    from repro_torch.configs.base import PowerControlConfig
    from repro_torch.core import executor, sim, supervisor
    from repro_torch.core.nrm import NRM, SimulatedPowerActuator
    from repro_torch.core.plant import PROFILES
    from repro_torch.core.policies.offline_rl import harvest_dataset
    grid = ({"x": np.arange(4, dtype=np.float32)}, (), 4)
    makers = [
        lambda: executor.run_grid(lambda b: b, *grid, chunk_size=2),
        lambda: executor.run_grid(lambda b: b, *grid, devices="all"),
        lambda: supervisor.run_durable(lambda b: b, *grid,
                                       dir=tmp_path / "c"),
        lambda: NRM(PowerControlConfig()),
        lambda: SimulatedPowerActuator(PROFILES["gros"]),
        lambda: sim.sweep("gros", [0.1], range(4), total_work=10.0,
                          max_time=64.0, chunk_size=2),
        lambda: sim.sweep_resumable("gros", [0.1], range(4),
                                    total_work=10.0, max_time=64.0,
                                    chunk_size=2, stop_after=1),
        lambda: harvest_dataset("gros", [0.1], range(2), total_work=10.0,
                                max_time=64.0)]
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_fleet_plane_and_services_refuse_to_run_without_cuda():
    """The fleet, the control plane and the regression gate run on CUDA by
    default, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from repro_torch.core.hierarchy import (FleetConfig, fleet_sweep,
                                            simulate_fleet)
    from repro_torch.core.plane import ControlPlane
    from repro_torch.core.plant import PROFILES
    from repro_torch.obs import regress
    fc = FleetConfig(n_nodes=4)
    makers = [lambda: simulate_fleet(PROFILES["gros"], fc, 4),
              lambda: fleet_sweep(PROFILES["gros"], fc, 4, [0, 1]),
              lambda: ControlPlane(),
              lambda: regress.main([str(ROOT / "BENCH_sim.json")]),
              lambda: regress.assess({"history": [
                  {"rev": str(i), "x": 1.0} for i in range(6)]})]
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
