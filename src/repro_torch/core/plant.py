"""Simulated power-to-progress plants (paper §4.3–4.4 physics); port of
`repro.core.plant`.

The plant is the paper's identified model of a cluster node running a
memory-bound workload under a RAPL powercap:

* actuator error  : power = a * pcap + b                     (§4.3)
* static char.    : progress* = K_L * (1 - exp(-alpha*(power - beta)))
* dynamics        : first-order with time constant tau       (Eq. 3)
* noise           : heteroscedastic with socket count        (§4.3, Fig. 3)
* disturbances    : sporadic exogenous drops to ~10 Hz       (§5.2, yeti)

Randomness is explicit: `plant_step` takes its four draws as a noise
tensor instead of a PRNG key — two unit normals (progress, power) and
two uniforms (drop enter, drop exit), in the order of the closed-loop
kernel's noise channels. The reference's ``bernoulli(k, p)`` is
``uniform(k) < p``, so a caller holding the reference's keys can rebuild
the same draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

# Canonical packing order for plant parameters (packed profile rows).
PROFILE_FIELDS = ("a", "b", "alpha", "beta", "K_L", "tau", "pcap_min",
                  "pcap_max", "n_sockets", "noise_scale", "power_noise",
                  "drop_prob", "drop_exit_prob", "drop_level")


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class PlantProfile:
    name: str
    a: float          # RAPL slope
    b: float          # RAPL offset [W]
    alpha: float      # power-to-progress curvature [1/W]
    beta: float       # power offset [W]
    K_L: float        # linear gain [Hz]
    tau: float = 1.0 / 3.0  # time constant [s]
    pcap_min: float = 40.0
    pcap_max: float = 120.0
    n_sockets: int = 1
    noise_scale: float = 0.6   # progress noise stddev per sqrt(socket) [Hz]
    power_noise: float = 1.0   # measured power noise [W]
    drop_prob: float = 0.0     # per-step probability of an exogenous drop
    drop_exit_prob: float = 0.3
    drop_level: float = 10.0   # Hz during a drop event (paper: ~10 Hz)

    # ---- static characteristic -------------------------------------------
    def power_of_pcap(self, pcap):
        return self.a * pcap + self.b

    def static_progress(self, pcap):
        power = self.power_of_pcap(pcap)
        return self.K_L * (1.0 - torch.exp(
            _f32(-self.alpha * (power - self.beta))))

    @property
    def progress_max(self) -> float:
        return float(self.static_progress(self.pcap_max))


# Table 2 of the paper, verbatim, plus the reference's TPU-flavoured rows
# (chip-level power ranges, tokens/s-scaled K_L) carried as data.
PROFILES = {
    "gros": PlantProfile("gros", a=0.83, b=7.07, alpha=0.047, beta=28.5,
                         K_L=25.6, n_sockets=1, noise_scale=0.45),
    "dahu": PlantProfile("dahu", a=0.94, b=0.17, alpha=0.032, beta=34.8,
                         K_L=42.4, n_sockets=2, noise_scale=1.4),
    "yeti": PlantProfile("yeti", a=0.89, b=2.91, alpha=0.023, beta=33.7,
                         K_L=78.5, n_sockets=4, noise_scale=3.2,
                         drop_prob=0.02),
    "v5e-chip": PlantProfile("v5e-chip", a=0.97, b=2.0, alpha=0.035,
                             beta=55.0, K_L=1200.0, tau=0.5, pcap_min=90.0,
                             pcap_max=250.0, n_sockets=1, noise_scale=18.0),
    "v5e-host": PlantProfile("v5e-host", a=0.95, b=12.0, alpha=0.018,
                             beta=180.0, K_L=4500.0, tau=0.8, pcap_min=350.0,
                             pcap_max=1000.0, n_sockets=4, noise_scale=120.0,
                             drop_prob=0.01, drop_level=500.0),
}


class PlantState(NamedTuple):
    progress_l: torch.Tensor  # linearized progress state (Eq. 2/3)
    dropped: torch.Tensor     # bool: inside an exogenous drop event
    energy: torch.Tensor      # accumulated energy [J]
    work: torch.Tensor        # accumulated work units (integral of progress)


def plant_init(profile: PlantProfile, pcap0: Optional[float] = None
               ) -> PlantState:
    pcap0 = profile.pcap_max if pcap0 is None else pcap0
    p0 = profile.static_progress(pcap0)
    # the state lies where (and has the shape that) the cap and profile give
    zero = torch.zeros_like(p0)
    return PlantState(progress_l=_f32(p0 - profile.K_L),
                      dropped=torch.zeros_like(p0, dtype=torch.bool),
                      energy=zero,
                      work=zero)


def pcap_linearize(profile: PlantProfile, pcap):
    """Eq. 2: pcap_L = -exp(-alpha (a pcap + b - beta)) (negative, in (-1,0])."""
    return -torch.exp(_f32(-profile.alpha
                           * (profile.a * pcap + profile.b - profile.beta)))


def plant_step(profile: PlantProfile, state: PlantState, pcap, dt,
               noise) -> Tuple[PlantState, dict]:
    """One control period: apply pcap for dt seconds, observe (progress, power).

    ``noise`` is a (4, ...) tensor: progress-noise z, power-noise z,
    drop-enter u, drop-exit u. Returns (new_state, measurements).
    """
    z_prog, z_pow, u_enter, u_exit = noise[0], noise[1], noise[2], noise[3]
    pcap = torch.clamp(_f32(pcap), profile.pcap_min, profile.pcap_max)
    pl = pcap_linearize(profile, pcap)
    # Eq. 3 first-order dynamics in the linearized coordinates
    w = dt / (dt + profile.tau)
    new_pl = profile.K_L * w * pl + (1.0 - w) * state.progress_l

    # exogenous drop events (two-state Markov chain; §5.2)
    enter = u_enter < profile.drop_prob
    exit_ = u_exit < profile.drop_exit_prob
    dropped = torch.where(state.dropped, ~exit_, enter)

    clean = new_pl + profile.K_L
    noise_p = (profile.noise_scale * torch.sqrt(_f32(profile.n_sockets))
               * z_prog)
    # a float level stays a Python scalar, so it meets CUDA tensors too
    level = profile.drop_level
    if not isinstance(level, torch.Tensor):
        level = float(level)
    progress = torch.clamp(torch.where(dropped, level, clean) + noise_p,
                           min=0.0)

    power_true = profile.power_of_pcap(pcap)
    power_meas = power_true + profile.power_noise * z_pow
    new_state = PlantState(
        progress_l=new_pl,
        dropped=dropped,
        energy=state.energy + power_true * dt,
        work=state.work + progress * dt,
    )
    meas = {"progress": progress, "power": power_meas, "pcap": pcap,
            "progress_clean": clean}
    return new_state, meas


def simulate(profile: PlantProfile, pcaps: torch.Tensor, dt: float,
             noise: torch.Tensor) -> dict:
    """Open-loop simulation over a pcap schedule [T] -> traces dict.

    ``noise`` is (T, 4): one `plant_step` noise column per period."""
    state = plant_init(profile, pcaps[0])
    rows = []
    for i in range(len(pcaps)):
        state, meas = plant_step(profile, state, pcaps[i], dt, noise[i])
        rows.append(meas)
    traces = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    traces["energy"] = state.energy
    traces["work"] = state.work
    return traces
