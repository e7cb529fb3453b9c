"""Paper core, ported: plant, PI controller, identification, the NRM
runtime, the control plane and the closed-loop simulation front end
(`sim.simulate_closed_loop`, `sim.sweep`).

The package exports the names of `repro.core`, each from the port's own
module, so ``from repro_torch.core import sweep, PIGains, NRM`` reads as
the reference's idiom does. They are resolved on first use (PEP 562):
the kernels import `core.plant` and `core.plane`, and `core.sim` imports
the kernels, so a package that imported `sim` eagerly would put a cycle
under any first import of a kernel module."""
from __future__ import annotations

import importlib

_EXPORTS = {
    "controller": ("PIController", "PIGains", "PIState", "pi_init",
                   "pi_step"),
    "identify": ("StaticFit", "fit_dynamics", "fit_rapl", "fit_static",
                 "pearson"),
    "nrm": ("NRM", "PowerActuator", "SimulatedPowerActuator"),
    "plane": ("ControlPlane", "PlaneSnapshot", "plane_step"),
    "plant": ("PROFILES", "PlantProfile", "PlantState", "pcap_linearize",
              "plant_init", "plant_step", "simulate"),
    "signals": ("HeartbeatAggregator", "TenantHeartbeatStore",
                "progress_from_times"),
    "sim": ("SimResult", "SweepResult", "replay_model",
            "simulate_closed_loop", "sweep"),
    "workloads": ("DetectorConfig", "Phase", "PhaseSchedule",
                  "markov_schedule", "roofline_schedule",
                  "stream_dgemm_schedule"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name: str):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
