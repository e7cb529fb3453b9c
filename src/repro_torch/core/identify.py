"""System identification (paper §4.4): static NLS fit + dynamic tau fit;
port of `repro.core.identify`.

Static characteristic. Given per-run (pcap, mean power, mean progress):
1. (a, b) by ordinary least squares on power = a*pcap + b (RAPL accuracy).
2. (K_L, alpha, beta) by Gauss–Newton on
       progress = K_L * (1 - exp(-alpha * (power - beta)))
   run in (log K_L, log alpha, beta) coordinates with a line search —
   matches the paper's "nonlinear least squares" (Table 2, R^2 0.83–0.95).

Dynamics. Given a random-cap trace, Eq. 3 is linear in (c1, c2):
    progress_L[i+1] = c1 * pcap_L[i] + c2 * progress_L[i]
solved in closed form; tau = dt * c2 / (1 - c2), and the static gain is
cross-checked as K_L = c1 (dt + tau) / dt.

`static_campaign` runs the constant-cap campaign the static fit takes
(the campaign of the reference's ``benchmarks/common.py``) on the port's
`sim.open_loop_runs`.

The two least-squares fits stay float64 numpy, as in the reference;
`pearson` and the Gauss–Newton fit compute in float32 on ``device``.
The Gauss–Newton loop runs on the device without a host sync: the
Jacobian comes from `torch.func.jacrev`, the five line-search steps are
one broadcast (5, N) residual, and the best step is picked on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch
from torch.func import jacrev

from repro_torch import resolve_device
from repro_torch.core import sim

# line-search step lengths tried every Gauss–Newton iteration
_LAMS = (1.0, 0.5, 0.25, 0.1, 0.03)


@dataclasses.dataclass(frozen=True)
class StaticFit:
    a: float
    b: float
    K_L: float
    alpha: float
    beta: float
    r2: float


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float64)


def _f32(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def pearson(x, y, device: Union[None, str, torch.device] = None) -> float:
    """Pearson correlation of x and y in float32 on ``device`` (CUDA
    unless told otherwise)."""
    dev = resolve_device(device)
    x, y = _f32(x, dev), _f32(y, dev)
    xc = x - x.mean()
    yc = y - y.mean()
    denom = torch.sqrt(torch.sum(xc * xc) * torch.sum(yc * yc))
    return float(torch.sum(xc * yc) / torch.clamp(denom, min=1e-12))


def fit_rapl(pcap, power) -> Tuple[float, float]:
    """OLS power = a*pcap + b."""
    pcap = _np64(pcap)
    power = _np64(power)
    A = np.stack([pcap, np.ones_like(pcap)], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, power, rcond=None)
    return float(a), float(b)


def _static_model(params, power):
    """The knee at ``params`` (..., 3) = (log K_L, log alpha, beta) over
    ``power`` (N,) -> (..., N)."""
    log_kl, log_alpha, beta = (v[..., None] for v in params.unbind(-1))
    return torch.exp(log_kl) * (1.0 - torch.exp(-torch.exp(log_alpha)
                                                * (power - beta)))


def _residual(params, power, progress):
    return _static_model(params, power) - progress


def _gauss_newton(params, power, progress, lams, iters: int):
    """``iters`` Gauss–Newton steps with a line search over the step
    lengths ``lams`` (5, 1), all on the device: no host sync."""
    jac_fn = jacrev(_residual)
    eye = 1e-6 * torch.eye(3, dtype=torch.float32, device=params.device)
    for _ in range(iters):
        r = _residual(params, power, progress)
        J = jac_fn(params, power, progress)
        JtJ = J.T @ J + eye
        # solve_ex: no error check, so no host sync
        delta = torch.linalg.solve_ex(JtJ, (J.T @ r)[:, None]).result[:, 0]
        cands = params - lams * delta                          # (5, 3)
        losses = torch.sum(_residual(cands, power, progress) ** 2, -1)
        params = torch.index_select(cands, 0,
                                    torch.argmin(losses).view(1))[0]
    return params


def fit_static(pcap, power, progress, iters: int = 200,
               device: Union[None, str, torch.device] = None) -> StaticFit:
    """Full §4.4 static fit: RAPL line + Gauss–Newton NLS on the knee, the
    NLS in float32 on ``device`` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    a, b = fit_rapl(pcap, power)
    power = _f32(power, dev)
    progress = _f32(progress, dev)

    # init: K_L ~ max progress, beta ~ just below min power, alpha from the
    # half-rise point
    kl0 = float(progress.max()) * 1.05 + 1e-3
    beta0 = float(power.min()) - 1.0
    half = kl0 / 2.0
    idx = int(torch.argmin(torch.abs(progress - half)))
    dp = max(float(power[idx]) - beta0, 1.0)
    alpha0 = float(np.log(2.0) / dp)
    params = torch.tensor([np.log(kl0), np.log(alpha0), beta0],
                          dtype=torch.float32, device=dev)
    lams = torch.tensor(_LAMS, dtype=torch.float32, device=dev)[:, None]
    params = _gauss_newton(params, power, progress, lams, iters)
    pred = _static_model(params, power)
    ss_res = float(torch.sum((progress - pred) ** 2))
    ss_tot = float(torch.sum((progress - progress.mean()) ** 2))
    r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    log_kl, log_alpha, beta = (float(v) for v in params.cpu())
    return StaticFit(a=a, b=b, K_L=float(np.exp(log_kl)),
                     alpha=float(np.exp(log_alpha)), beta=beta, r2=r2)


def fit_dynamics(pcap_l, progress_l, dt: float) -> Tuple[float, float]:
    """Closed-form Eq. 3 fit. Returns (tau, K_L_dynamic).

    Convention: ``progress_l[i]`` is the state measured AFTER ``pcap_l[i]``
    was applied for one period (what a synchronous monitoring loop records),
    so the transition is  progress_l[i] = c1*pcap_l[i] + c2*progress_l[i-1].
    """
    pl = _np64(pcap_l)[1:]
    y_now = _np64(progress_l)[:-1]
    y_next = _np64(progress_l)[1:]
    A = np.stack([pl, y_now], axis=1)
    (c1, c2), *_ = np.linalg.lstsq(A, y_next, rcond=None)
    c2 = min(max(float(c2), 1e-6), 1.0 - 1e-6)
    tau = dt * c2 / (1.0 - c2)
    k_l = float(c1) * (dt + tau) / dt
    return float(tau), k_l


def static_campaign(profile, levels: int = 9, reps: int = 3, steps: int = 40,
                    seed: int = 1,
                    device: Union[None, str, torch.device] = None):
    """Constant-cap campaign -> (caps, mean power, mean progress) numpy
    arrays of ``levels * reps`` runs: ``reps`` open-loop runs of ``steps``
    periods at each of ``levels`` caps across the profile's range, means
    taken after the first 5 periods. The runs' noise is `draw_noise` of
    seeds ``seed * levels * reps + i`` (run i in level-major order), on
    ``device`` (CUDA unless told otherwise)."""
    profile = sim._resolve(profile)
    base = seed * levels * reps
    caps, powers, progs = [], [], []
    for i, pcap in enumerate(np.linspace(profile.pcap_min, profile.pcap_max,
                                         levels)):
        tr = sim.open_loop_runs(profile, steps,
                                range(base + i * reps,
                                      base + (i + 1) * reps),
                                pcap=float(pcap), device=device)
        caps += [float(pcap)] * reps
        powers.append(tr["power"][:, 5:].mean(1))
        progs.append(tr["progress"][:, 5:].mean(1))
    return (np.asarray(caps), torch.cat(powers).cpu().numpy(),
            torch.cat(progs).cpu().numpy())
