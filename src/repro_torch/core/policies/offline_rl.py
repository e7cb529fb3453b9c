"""Offline-RL power control (cf. Raj et al., "Offline Reinforcement-
Learning-Based Power Control"): a fitted-Q, linear-in-features policy
trained on transition datasets harvested from closed-loop sweeps; port of
`repro.core.policies.offline_rl`.

Pipeline:

1. ``build_dataset(traces, profile, epsilon)`` — turn `sweep(...,
   collect_traces=True)` traces into (s, a, r, s') transitions (numpy).
   The state is setpoint-relative progress s = progress/setpoint; the
   action is the normalized cap u = (pcap-min)/(max-min); the reward
   trades normalized power against performance debt:
   r = -power_norm - rho*max(0, 1 - s').
2. ``fit_offline_rl(dataset)`` — fitted Q-iteration on the quadratic
   feature map phi(s,u) = [1, s, s^2, u, u^2, s*u], on the device: each
   sweep solves the ridge-regularized least squares to the Bellman
   targets, the max over next actions taken on the discrete candidate
   grid.
3. ``OfflineRLPolicy(weights=...)`` — at deployment the greedy policy
   evaluates Q on ``N_ACTIONS`` candidate caps spanning the actuator
   range and applies the argmax (the first maximum, as `jnp.argmax`).

State: [0] = previous normalized action (kept for analysis; the greedy
policy itself is memoryless).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.controller import PIGains
from repro_torch.core.fma import fma
from repro_torch.core.plant import PlantProfile
from repro_torch.core.policies.base import (POLICY_STATE_DIM, Policy,
                                            pack_values, register_branch)

N_FEATURES = 6
N_ACTIONS = 9  # candidate caps spanning [pcap_min, pcap_max]


def features(s, u):
    """phi(s, u) = [1, s, s^2, u, u^2, s*u], broadcasting over s/u."""
    s, u = torch.broadcast_tensors(torch.as_tensor(s, dtype=torch.float32),
                                   torch.as_tensor(u, dtype=torch.float32))
    return torch.stack([torch.ones_like(s), s, s * s, u, u * u, s * u], -1)


def _candidates(like: torch.Tensor) -> torch.Tensor:
    return torch.linspace(0.0, 1.0, N_ACTIONS, dtype=torch.float32,
                          device=like.device)


def _rl_step(vals, state, obs):
    g = obs.gains
    s = obs.progress / torch.clamp(
        torch.as_tensor(g.setpoint, dtype=torch.float32), min=1e-9)
    us = _candidates(s)
    # Q(s, u) = phi(s, u) . w for every candidate, (..., N_ACTIONS): the
    # six terms accumulated in feature order by fused multiply-adds, as
    # XLA evaluates the dot, so near-ties order as in the reference
    w = [vals[..., 1 + i, None] for i in range(N_FEATURES)]
    s1 = s[..., None]
    q = w[0]
    for f, wi in zip((s1, s1 * s1, us, us * us, s1 * us), w[1:]):
        q = fma(f, wi, q)
    u = us[torch.argmax(q, dim=-1)]
    pcap = g.pcap_min + u * (g.pcap_max - g.pcap_min)
    return torch.cat([u[..., None], state[..., 1:]], -1), pcap


def _rl_init(vals, gains):
    # start at full power like every other policy
    one = torch.ones_like(vals[..., :1])
    return torch.cat([one, one.new_zeros(
        one.shape[:-1] + (POLICY_STATE_DIM - 1,))], -1)


def _rl_extras(state):
    return {"action": state[..., 0]}


register_branch("offline_rl", _rl_step, _rl_init, _rl_extras)


@dataclasses.dataclass(frozen=True)
class OfflineRLPolicy(Policy):
    """Greedy fitted-Q policy; ``weights`` is the phi-coefficient tuple."""
    weights: Tuple[float, ...] = (0.0,) * N_FEATURES

    @property
    def branch(self) -> str:
        return "offline_rl"

    def values(self, profile: PlantProfile, gains: PIGains) -> torch.Tensor:
        if len(self.weights) != N_FEATURES:
            raise ValueError(f"OfflineRLPolicy needs {N_FEATURES} feature "
                             f"weights, got {len(self.weights)}")
        return pack_values(*self.weights)


# ---- dataset harvesting (host-side, numpy) --------------------------------

def transitions_from_traces(prog, pcap, power, valid, setpoint, p_lo,
                            p_hi, cap_lo, cap_rng, rho: float = 3.0
                            ) -> Dict[str, np.ndarray]:
    """(s, a, r, s') rows from trace arrays shaped (..., T), with the
    normalizers (setpoint, power range, cap range) scalars OR per-run
    arrays broadcasting over the leading axes. Consecutive live steps
    become transitions; ``valid`` gates both endpoints."""
    prog = np.asarray(prog, np.float32)
    pcap = np.asarray(pcap, np.float32)
    power = np.asarray(power, np.float32)
    valid = np.asarray(valid, bool)
    per_run = lambda x: np.asarray(x, np.float32)[..., None]

    s = prog / np.maximum(per_run(setpoint), 1e-9)
    a = (pcap - per_run(cap_lo)) / np.maximum(per_run(cap_rng), 1e-9)
    pw = ((power - per_run(p_lo))
          / np.maximum(per_run(p_hi) - per_run(p_lo), 1e-9))

    # a[t] is the command computed at t and applied over period t+1, so
    # the transition is (s[t], a[t]) -> s[t+1] with the reward measured
    # on the NEXT period's outcome
    m = (valid[..., :-1] & valid[..., 1:]).reshape(-1)
    s_t = s[..., :-1].reshape(-1)[m]
    a_t = a[..., :-1].reshape(-1)[m]
    s_n = s[..., 1:].reshape(-1)[m]
    pw_n = pw[..., 1:].reshape(-1)[m]
    r = -pw_n - rho * np.maximum(0.0, 1.0 - s_n)
    return {"s": s_t, "a": a_t, "r": r.astype(np.float32), "s2": s_n}


def build_dataset(traces: Dict[str, np.ndarray], profile: PlantProfile,
                  epsilon: float, rho: float = 3.0) -> Dict[str, np.ndarray]:
    """Transitions from closed-loop traces of ONE profile.

    ``traces`` holds arrays shaped (..., T) — a `sweep(...,
    collect_traces=True)` result's traces (or one `simulate_closed_loop`
    run's, with T only). Returns flat arrays {s, a, r, s2} of equal
    length N."""
    prog = np.asarray(traces["progress"], np.float32)
    valid = traces.get("valid", np.ones_like(prog, bool))
    return transitions_from_traces(
        prog, traces["pcap"], traces["power"], valid,
        (1.0 - epsilon) * profile.progress_max,
        float(profile.power_of_pcap(profile.pcap_min)),
        float(profile.power_of_pcap(profile.pcap_max)),
        profile.pcap_min, profile.pcap_max - profile.pcap_min, rho)


def harvest_dataset(*args, **kwargs):
    """The reference's bounded-memory harvest streams a full-trace sweep
    through the chunked executor, which the port does not have yet."""
    raise NotImplementedError(
        "harvest_dataset is not ported yet: ROADMAP Queue 1 item 7 "
        "(execution and runtime: the chunked executor); build_dataset on "
        "a sweep's traces harvests the same transitions")


# ---- fitted Q-iteration (on the device) ------------------------------------

def _fqi(s, a, r, s2, gamma: float, ridge: float, n_iters: int
         ) -> torch.Tensor:
    """Fitted Q-iteration: ``n_iters`` ridge solves of the 6x6 normal
    equations against the Bellman targets; no host sync inside."""
    phi = features(s, a)                                   # (N, F)
    us = _candidates(s)
    phi2 = features(s2[:, None], us[None, :])              # (N, L, F)
    A = phi.T @ phi + ridge * torch.eye(N_FEATURES, dtype=torch.float32,
                                        device=s.device)
    w = torch.zeros((N_FEATURES,), dtype=torch.float32, device=s.device)
    for _ in range(n_iters):
        q2 = (phi2 @ w).amax(-1)                           # (N,)
        y = r + gamma * q2
        # solve_ex: the same LU solve as linalg.solve, without the
        # singularity check that would read its status back to the host
        w = torch.linalg.solve_ex(A, phi.T @ y)[0]
    return w


def fit_offline_rl(dataset: Dict[str, np.ndarray], gamma: float = 0.9,
                   ridge: float = 1e-3, n_iters: int = 50,
                   device: Union[None, str, torch.device] = None
                   ) -> OfflineRLPolicy:
    """Fitted Q-iteration over a harvested transition set -> policy, on
    ``device`` (CUDA unless told otherwise)."""
    if len(dataset["s"]) == 0:
        raise ValueError("empty transition dataset")
    dev = resolve_device(device)
    t = lambda k: torch.as_tensor(np.asarray(dataset[k], np.float32),
                                  device=dev)
    w = _fqi(t("s"), t("a"), t("r"), t("s2"), float(gamma), float(ridge),
             int(n_iters))
    return OfflineRLPolicy(weights=tuple(float(x) for x in w.cpu()))
