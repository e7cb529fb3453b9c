"""`tests/test_train_power.py` on the port: the NRM's runtime chain
(heartbeats -> control_step -> actuator) and the train driver's --power
path with a checkpoint kill and resume, on the CPU.

The kill is caught in-process: `main(..., device="cpu")` raises
SystemExit(17) at ``--kill-at``, as the reference's process exits 17,
and the resume is a second `main` call in the same process (the
reference runs both as subprocesses to dodge a jax compilation-cache
abort that PyTorch does not have; a subprocess would run
``python -m repro_torch.launch.train``, which defaults to the card)."""
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import PowerControlConfig  # noqa: E402
from repro_torch.core.nrm import NRM  # noqa: E402
from repro_torch.core.plant import PROFILES  # noqa: E402
from repro_torch.core.workloads import DetectorConfig  # noqa: E402
from repro_torch.launch import train  # noqa: E402

_ARGS = ["--arch", "qwen3-8b", "--reduced", "--batch", "2", "--seq", "32",
         "--power", "--epsilon", "0.1", "--control-period", "0.02",
         "--quiet"]


def test_runtime_loop_heartbeats_to_actuator():
    """The runtime chain in isolation: workload heartbeats feed Eq. 1,
    control_step runs the policy and the actuator applies the cap —
    the loop settles near the setpoint."""
    nrm = NRM(PowerControlConfig(epsilon=0.15, plant_profile="gros"),
              detector=DetectorConfig(), device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(120):
        meas = nrm.actuator.advance(1.0)
        t0 = nrm._t
        n = int(rng.poisson(max(meas["progress"], 0.0)))
        if n:
            nrm.hb.beat_many(t0 + (np.arange(n) + 0.5) / n)
        rec = nrm.control_step(dt=1.0)
    sp = rec.setpoint
    tail = [r.progress for r in nrm.records[60:]]
    assert abs(np.mean(tail) - sp) < 0.15 * sp
    # the actuator really applied the command
    assert nrm.actuator._pcap == pytest.approx(
        np.clip(rec.pcap, nrm.profile.pcap_min, nrm.profile.pcap_max))
    # quiet plant: the live detector must not cry wolf
    assert not any(r.phase_change for r in nrm.records)


def test_train_power_smoke_with_checkpoint_resume(capsys):
    """Drive the real train loop (--power) for a few optimizer steps,
    kill it mid-run, and resume from the checkpoint: the controller
    state must round-trip and training must complete."""
    ckpt = tempfile.mkdtemp(prefix="repro_torch_pwr_ckpt_")
    try:
        common = _ARGS + ["--checkpoint-dir", ckpt,
                          "--checkpoint-every", "4"]
        with pytest.raises(SystemExit) as exc:
            train.main(common + ["--steps", "14", "--kill-at", "10"],
                       device="cpu")
        assert exc.value.code == 17
        # the checkpoint carries NRM controller state
        sidecars = sorted(Path(ckpt).glob("*/meta.json"))
        assert sidecars, "no checkpoint written before the kill"
        extra = json.loads(sidecars[-1].read_text())["extra"]
        nrm_state = extra["nrm"]
        assert {"prev_error", "prev_pcap_l", "t",
                "heartbeats"} <= set(nrm_state)
        # restoring into a fresh NRM reproduces the controller state
        nrm = NRM(PowerControlConfig(epsilon=0.1, plant_profile="v5e-chip"),
                  device="cpu")
        nrm.load_state_dict(nrm_state)
        assert float(nrm.controller.state.prev_error) == pytest.approx(
            nrm_state["prev_error"])
        assert nrm._t == pytest.approx(nrm_state["t"])
        # the heartbeat ring buffer round-trips too
        assert nrm.hb.state_dict() == nrm_state["heartbeats"]
        assert len(nrm.hb) == len(nrm_state["heartbeats"]["t"])
        assert nrm.state_dict() == nrm_state  # the whole state
        # resume to completion: power control stays in the loop and
        # training finishes
        capsys.readouterr()
        res = train.main(common + ["--steps", "14", "--resume",
                                   "--kill-at", "0"], device="cpu")
        assert "[resume] restored step" in capsys.readouterr().out
        assert res["steps"] == 14 - extra["step"]
        assert np.isfinite(res["final_loss"]) and res["energy_j"] > 0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def test_train_power_loop_controls_and_learns():
    """The --power loop on the port: the NRM runs control periods (a cap
    trajectory inside the plant's range), the simulated energy and time
    accrue, and the loss falls over the run."""
    res = train.main(_ARGS + ["--steps", "12"], device="cpu")
    assert res["steps"] == 12 and len(res["step_wall_s"]) == 12
    assert res["pcaps"], "no control period ran"
    prof = PROFILES["v5e-chip"]
    assert all(prof.pcap_min <= c <= prof.pcap_max for c in res["pcaps"])
    assert res["energy_j"] > 0 and res["sim_time_s"] > 0
    assert res["nrm_wall_s"] is not None
    assert res["final_loss"] < res["first_loss"]
