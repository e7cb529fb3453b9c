"""The NRM coupled to a step loop in the order `launch/train.train` and
`launch/serve._serve` run it: the first step (the warm-up) is skipped,
the second calibrates the plant to the measured rate, and every later
step slows the simulated clock by the capped progress fraction, beats
its work into the NRM and, once a sampling period of simulated time has
passed, advances the plant and runs a control step."""
from __future__ import annotations

import time


class Coupling:
    def __init__(self, nrm_cfg: dict, work: float, device):
        from repro_torch.configs.base import PowerControlConfig
        from repro_torch.core.nrm import NRM
        self.cfg = PowerControlConfig(
            enabled=True, epsilon=nrm_cfg["epsilon"],
            plant_profile=nrm_cfg["plant"],
            sampling_period=nrm_cfg["sampling_period"])
        self.nrm = NRM(self.cfg, device=device)
        self.work = float(work)
        self.steps = 0
        self.sim_time = self.energy = self.last_ctrl = 0.0
        self.pcaps = []

    def step(self, dt_real: float) -> float:
        """After a step of ``dt_real`` host seconds -> the host seconds the
        NRM took."""
        self.steps += 1
        if self.steps == 1:
            return 0.0
        t1 = time.perf_counter()
        nrm = self.nrm
        if self.steps == 2:
            nrm.calibrate(self.work / dt_real)
            self.last_ctrl = 0.0
        prof = nrm.profile
        frac = float(prof.static_progress(nrm.actuator._pcap)) \
            / prof.progress_max
        dt_eff = dt_real / max(frac, 1e-3)
        self.sim_time += dt_eff
        self.energy += float(prof.power_of_pcap(nrm.actuator._pcap)) * dt_eff
        nrm.heartbeat(work=self.work, t=self.sim_time)
        if self.sim_time - self.last_ctrl >= self.cfg.sampling_period:
            nrm.actuator.advance(self.sim_time - self.last_ctrl)
            nrm.control_step(now=self.sim_time)
            self.pcaps.append(float(nrm.actuator._pcap))
            self.last_ctrl = self.sim_time
        return time.perf_counter() - t1
