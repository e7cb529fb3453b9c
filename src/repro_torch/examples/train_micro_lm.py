"""End-to-end run: train a ~100M-param LM for a few hundred steps with
the power controller active, checkpointing, and a simulated failure +
restart halfway through (fault tolerance demo); port of
`examples/train_micro_lm.py`.

Both runs go through `launch.train.main` in this process: the killed
run's one-rank process group is destroyed as its `SystemExit` leaves
`launch.mesh.host_mesh`, and the resumed run starts its own. The caps
are those of the simulated ``v5e-chip`` plant, not the card's.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_micro_lm [--device cpu]
"""
from __future__ import annotations

import shutil
import tempfile

from repro_torch import resolve_device
from repro_torch.examples._cli import device_arg
from repro_torch.launch import train

STEPS = 200
KILL_AT = 100
CHECKPOINT_EVERY = 40
KILLED_EXIT = 17     # `launch.train`'s exit code for a simulated failure


def main(device=None) -> dict:
    """Trains to ``KILL_AT``, dies there, resumes from the latest
    checkpoint to ``STEPS``. Returns the resumed run's `train.main`
    result (with ``restored_step``, the checkpoint it restored, and
    ``start_step``, its first step) and ``exit_code``, the killed
    run's."""
    dev = resolve_device(device)
    ckpt = tempfile.mkdtemp(prefix="repro_ckpt_")
    common = [
        "--arch", "qwen3-8b", "--reduced",
        "--batch", "8", "--seq", "128",
        "--power", "--epsilon", "0.1",
        "--checkpoint-dir", ckpt, "--checkpoint-every",
        str(CHECKPOINT_EVERY), "--steps", str(STEPS),
    ]
    try:
        # phase 1: run until a simulated node failure at step KILL_AT
        try:
            train.main(common + ["--kill-at", str(KILL_AT)], device=dev)
        except SystemExit as e:
            code = e.code
        else:
            code = 0
        assert code == KILLED_EXIT, "expected the simulated failure"
        print("[demo] node died; restarting from the latest checkpoint...")
        # phase 2: resume to completion (data iterator + controller
        # restored)
        result = train.main(common + ["--resume"], device=dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    assert result["final_loss"] < result["first_loss"]
    result["exit_code"] = code
    print("[demo] restart-after-failure training complete:",
          {k: v for k, v in result.items()
           if k not in ("step_wall_s", "pcaps")})
    return result


if __name__ == "__main__":
    main(device_arg(__doc__))
