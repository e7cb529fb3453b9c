"""Hierarchical fleet power control (beyond the paper; scales to 1000+
nodes); port of `repro.core.hierarchy`.

Two levels:

* **node level** — the paper's full control period, one per node: the
  scan engine's fused plant/heartbeat/policy step (`repro_torch.core.sim.
  engine_step`, packed path) over the fleet's node rows with PER-NODE
  plant, gain and policy rows, so a fleet may mix plant-profile classes
  and control policies while every node runs the single-node engine's
  dynamics.
* **cluster level** — a slow outer loop that splits a global power budget
  across nodes every `reallocate_every` periods: water-filling on the
  previous period's SETPOINT-RELATIVE progress. Nodes lagging the fleet
  median get more budget, and because the fill respects per-node actuator
  bounds, budget SHIFTS across profile classes. The allocation enters
  each node's period as ``cap_limit``: the applied command is min(policy
  command, allocation).

The per-node controller remains exactly its policy's law (Eq. 4 for PI);
the cluster level only moves each node's cap budget.

On the card each step is one `engine_step` launch sequence over all S x n
node rows of a batch of S seeds, then the cluster step. The reference's
``jax.random`` period keys become per-node counter streams keyed only by
(fleet seed, node index) (`node_seeds`): the plant noise of
`kernels.closed_loop.ops.draw_noise` and the Poisson heartbeats of
`repro_torch.core.poisson`, so a `fleet_sweep` row depends neither on its
chunk nor on the other seeds. The fleet core takes its per-step draws as
an input (`_fleet_core`'s ``draws``), which defaults to those streams; a
parity test feeds it the reference's own draws. Node-axis sums are
pairwise halvings (elementwise adds in a fixed order) and medians come
from an exact sort, so a seed's rows are the same in any batch; per-class
sums are masked sums over the node axis (no atomics).

`_simulate_fleet_reference` keeps the hand-rolled per-node step as the
equivalence oracle for tests (per-node parameters included).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import executor
from repro_torch.core import policies as pol
from repro_torch.core import sim
from repro_torch.core.controller import PIGains, pi_init, pi_step
from repro_torch.core.plane import GAIN_FIELDS, gains_values, unpack_gains
from repro_torch.core.plant import (PROFILE_FIELDS, PlantProfile,
                                    PlantState, plant_init, plant_step)
from repro_torch.core.poisson import PoissonStream
from repro_torch.core.policies.pi import PIPolicy
from repro_torch.core.signals import median
from repro_torch.core.workloads.schedule import (Phase, PhaseSchedule,
                                                 ScheduleValues, chain_rows)
from repro_torch.kernels.closed_loop import ops


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    n_nodes: int
    epsilon: float = 0.10
    tau_obj: float = 10.0
    dt: float = 1.0
    power_budget: float = 0.0   # total W across nodes; 0 = uncapped
    reallocate_every: int = 10
    # water-filling weight gain on relative lag: weights = 1 + boost*lag;
    # 1.0 reproduces the original (unparameterized) behaviour
    straggler_boost: float = 1.0


def _node_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by pairwise halving (zero-padded to a power
    of two): elementwise adds in one fixed order, so a row's sum does not
    depend on how many rows the batch holds."""
    n = x.shape[-1]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (p - n,))], -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _water_fill_bounds(lo, hi, budget, weights: torch.Tensor
                       ) -> torch.Tensor:
    """Split ``budget`` watts over nodes (the last axis) proportionally to
    ``weights``, clipped to PER-NODE actuator bounds ``lo`` / ``hi``
    (tensors broadcasting against ``weights``, or scalars).

    Starts from the clipped proportional target, then refines the CARRIED
    allocation for 8 rounds: each round measures the remaining deficit (or
    surplus) and redistributes it over the nodes with room in that
    direction, so the total converges to the budget whenever it is
    feasible (sum(lo) <= budget <= sum(hi)) and saturates at the nearest
    bound otherwise. With heterogeneous bounds this is what shifts budget
    across profile classes."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=weights.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=weights.device)
    budget = torch.as_tensor(budget, dtype=torch.float32,
                             device=weights.device)
    if budget.dim():
        budget = budget[..., None]
    w = weights / torch.clamp(_node_sum(weights)[..., None], min=1e-9)
    alloc = torch.clamp(budget * w, lo, hi)
    for _ in range(8):
        leftover = budget - _node_sum(alloc)[..., None]
        room = torch.where(leftover >= 0, hi - alloc, alloc - lo)
        share = room / torch.clamp(_node_sum(room)[..., None], min=1e-9)
        alloc = torch.clamp(alloc + leftover * share, lo, hi)
    return alloc


def _water_fill(profile: PlantProfile, budget: float, n: int,
                weights: torch.Tensor) -> torch.Tensor:
    """Homogeneous-bounds convenience wrapper around `_water_fill_bounds`."""
    return _water_fill_bounds(float(profile.pcap_min),
                              float(profile.pcap_max), budget, weights)


# packed-field indices, from the canonical packing orders
_F_PCAP_MIN = PROFILE_FIELDS.index("pcap_min")
_F_PCAP_MAX = PROFILE_FIELDS.index("pcap_max")
_G_SETPOINT = GAIN_FIELDS.index("setpoint")


def node_seeds(seeds, n: int) -> torch.Tensor:
    """The counter-stream seeds of every node of S fleet seeds: (S * n,)
    int64, row s * n + i = (seeds[s] << 32) + i, so a node's streams
    depend only on (its fleet's seed, its index)."""
    s = torch.as_tensor(seeds, dtype=torch.int64)
    if bool(((s < 0) | (s >= 2 ** 31)).any()):
        raise ValueError("fleet seeds must lie in [0, 2**31)")
    i = torch.arange(n, dtype=torch.int64, device=s.device)
    return ((s[:, None] << 32) + i[None, :]).reshape(-1)


class NodeStreams:
    """The default per-step draws of a batch of fleet nodes: ``streams(t)``
    -> (plant noise (4, S * n) of step t, the step's Poisson sampler),
    drawn `ops.CHUNK_T` steps at a time from each node's seed
    (`node_seeds`); `check` raises if a Poisson draw was left
    unresolved (one host sync, after the run)."""

    def __init__(self, seeds: torch.Tensor):
        self.seeds = seeds
        self.poisson = PoissonStream(seeds)
        self._noise, self._t0 = None, None

    def __call__(self, t: int):
        t0 = t - t % ops.CHUNK_T
        if self._t0 != t0:
            self._noise, self._t0 = ops.draw_noise(self.seeds, ops.CHUNK_T,
                                                   t0=t0), t0
        return self._noise[t - t0, :4], lambda lam: self.poisson(lam, t)

    def check(self) -> None:
        self.poisson.check()


def _fleet_core(pv, gv, av, cls, sv, seeds, *, branches, n_classes: int,
                budget: float, reallocate_every: int, boost: float,
                steps: int, dt: float,
                draws: Optional[Callable[[int], tuple]] = None) -> dict:
    """The two-level fleet run for a batch of S fleet seeds, on ``pv``'s
    device: ``pv`` (n, 14) profile rows, ``gv`` (n, 9) gain rows, ``av``
    (n, POLICY_PARAM_DIM) policy rows, ``cls`` (n,) class ids, ``sv`` a
    per-node `ScheduleValues` ((n, ...) leaves) or None, ``seeds`` (S,).
    ``draws(t)`` gives step t's (plant noise (4, S * n), Poisson sampler)
    over the node rows (row s * n + i); default `NodeStreams`.

    Returns per-step rows (S, steps[, n_classes]) and the per-run
    reductions (S[, n_classes]) as tensors. The run goes on past
    ``steps`` only while some node is still live (a non-integer ``dt``
    whose float32 clock reaches the horizon a step late), as the
    reference's frozen bucket does, recording no rows there."""
    dev = pv.device
    n, S = pv.shape[0], seeds.shape[0]
    rep = lambda x: x.repeat((S,) + (1,) * (x.dim() - 1))
    prof = sim._unpack_profile(rep(pv))
    gains = unpack_gains(rep(gv))
    avr = rep(av)
    sched = None if sv is None else ScheduleValues(*(rep(x) for x in sv))
    budgeted = budget > 0
    f32 = lambda x: torch.full((), float(x), dtype=torch.float32,
                               device=dev)
    # the reference's horizon: float32(steps) * float32(dt)
    tw, dtt, mt = f32(float("inf")), f32(dt), f32(steps) * f32(dt)
    bud, boost_t = f32(budget), f32(boost)
    lo, hi = pv[:, _F_PCAP_MIN], pv[:, _F_PCAP_MAX]
    setpoints = gv[:, _G_SETPOINT]
    classes = torch.arange(n_classes, device=dev)
    # row 0: the whole fleet; rows 1..C: the classes
    masks = torch.cat([torch.ones((1, n), dtype=torch.bool, device=dev),
                       cls[None, :] == classes[:, None]])
    counts = torch.clamp(masks[1:].sum(-1).to(torch.float32), min=1.0)
    c = sim._default_init(prof, gains, branches, avr, typed_pi=False,
                          schedule=sched)
    alloc = hi.expand(S, n)
    prev = torch.zeros((S, n), dtype=torch.float32, device=dev)
    if draws is None:
        draws = NodeStreams(node_seeds(seeds, n).to(dev))
    sums, meds = [], []
    limit = sim._bucket_steps(steps)
    for t in range(limit):
        if t >= steps and bool(c.done.all()):
            break
        if budgeted and t % reallocate_every == 0:
            # cluster level: water-filling on the previous period's
            # setpoint-relative progress; stragglers (below the fleet
            # median) weigh more and receive a larger share
            rel = prev / torch.clamp(setpoints, min=1e-9)
            med = median(rel)[:, None]
            lag = torch.clamp((med - rel) / torch.clamp(med, min=1e-9),
                              min=0.0)
            alloc = _water_fill_bounds(lo, hi, bud, 1.0 + boost_t * lag)
        noise, sampler = draws(t)
        c, out = sim.engine_step(
            prof, gains, c, tw, mt, dtt, noise, sampler, policy=branches,
            policy_vals=avr, typed_pi=False, schedule=sched,
            cap_limit=alloc.reshape(-1) if budgeted else None)
        prev = out["progress"].view(S, n)
        if t >= steps:
            continue
        q = [prev, out["power"], out["pcap"]]
        if budgeted:
            q.append(alloc.reshape(-1))
        if sched is not None:
            # mean active phase per class: phase-staggered fleets make the
            # cross-class movement observable
            q.append(out["phase"].to(torch.float32))
        x = torch.stack([v.view(S, n) for v in q], 1)      # (S, K, n)
        sums.append(_node_sum(torch.where(masks, x[:, :, None, :], 0.0)))
        meds.append(median(prev))
    if hasattr(draws, "check"):
        draws.check()
    sm = torch.stack(sums, 1)                              # (S, T, K, 1+C)
    cls_mean = lambda k: sm[:, :, k, 1:] / counts
    tr = {"progress_mean": sm[:, :, 0, 0] / n,
          "progress_med": torch.stack(meds, 1),
          "power": sm[:, :, 1, 0],
          "pcap_mean": sm[:, :, 2, 0] / n,
          "power_class": sm[:, :, 1, 1:],
          "progress_class": cls_mean(0),
          "pcap_class": cls_mean(2)}
    k = 3
    if budgeted:
        tr["alloc_class"], k = cls_mean(k), k + 1
    if sched is not None:
        tr["phase_class"] = cls_mean(k)
    e = torch.where(masks, c.plant.energy.view(S, 1, n), 0.0)
    tr["energy_total"] = _node_sum(e[:, 0])
    tr["work_total"] = _node_sum(c.plant.work.view(S, n))
    tr["energy_class"] = _node_sum(e[:, 1:])
    return tr


def _fleet_layout(profile, fc: FleetConfig, node_class):
    """Normalize (profile(s), node_class) -> (profiles, per-node class)."""
    profs = ([profile] if isinstance(profile, PlantProfile)
             else list(profile))
    n = fc.n_nodes
    if node_class is None:
        cls = np.arange(n) % len(profs)
    else:
        cls = np.asarray(node_class, np.int32)
        if cls.shape != (n,):
            raise ValueError(f"node_class must have shape ({n},)")
        if cls.min() < 0 or cls.max() >= len(profs):
            raise ValueError("node_class indexes outside the profile list")
    return profs, cls


def _fleet_policies(policies, n_profiles: int, n: int, cls):
    """Normalize policies= to one Policy per node: a single Policy (all
    nodes), one per node, or one per profile class. When n_nodes equals
    the class count the list is ambiguous; the PER-NODE reading wins
    (``policies[i]`` is node i's policy, regardless of node_class)."""
    if policies is None:
        policies = PIPolicy()
    if isinstance(policies, pol.Policy):
        return [policies] * n
    pls = list(policies)
    if len(pls) == n:
        return pls
    if len(pls) == n_profiles:
        return [pls[c] for c in cls]
    raise ValueError(f"policies= must be one Policy, {n_profiles} "
                     f"(per class) or {n} (per node); got {len(pls)}")


def _fleet_schedules(schedules, profs, n: int, cls
                     ) -> Optional[ScheduleValues]:
    """Normalize schedules= to a per-node `ScheduleValues` with leading
    (n,) leaves on the host, or None. Accepts a single PhaseSchedule
    (every node, resolved against its class profile), one per class, or
    one per node — same precedence rules as policies= (per-node reading
    wins when n_nodes == n_classes). None entries mean 'static plant' and
    become a one-phase hold of the node's class profile."""
    if schedules is None:
        return None
    if isinstance(schedules, PhaseSchedule):
        per_node = [schedules] * n
    else:
        scheds = list(schedules)
        if len(scheds) == n:
            per_node = scheds
        elif len(scheds) == len(profs):
            per_node = [scheds[c] for c in cls]
        else:
            raise ValueError(f"schedules= must be one PhaseSchedule, "
                             f"{len(profs)} (per class) or {n} (per "
                             f"node); got {len(scheds)}")
    static_hold = PhaseSchedule((Phase(1.0),))  # holds base forever
    per_node = [s or static_hold for s in per_node]
    rows = max(chain_rows(len(s.phases)) for s in per_node)
    cache = {}
    resolved = []
    for i, s in enumerate(per_node):
        key = (id(s), int(cls[i]))
        if key not in cache:
            cache[key] = s.resolve(profs[cls[i]], rows, device="cpu")
        resolved.append(cache[key])
    return ScheduleValues(*(torch.stack(xs) for xs in zip(*resolved)))


def _fleet_args(profile, fc: FleetConfig, node_class, policies, schedules):
    """Shared per-node argument packing for `simulate_fleet` /
    `fleet_sweep`: (profs, cls, branches, (pv, gv, av, cls, sv)) with the
    rows as host tensors."""
    profs, cls = _fleet_layout(profile, fc, node_class)
    n = fc.n_nodes
    gains = [PIGains.from_model(p, fc.epsilon, fc.tau_obj) for p in profs]
    node_pols = _fleet_policies(policies, len(profs), n, cls)
    branches, kinds = pol.resolve_kinds(node_pols)
    idx = torch.as_tensor(cls, dtype=torch.int64)
    pv = torch.stack([sim.profile_values(p) for p in profs])[idx]
    gv = torch.stack([gains_values(g) for g in gains])[idx]
    cache = {}
    rows = []
    for i, (p_, k_) in enumerate(zip(node_pols, kinds)):
        ck = (int(cls[i]), p_, k_)
        if ck not in cache:
            cache[ck] = pol.policy_values(p_, profs[cls[i]], gains[cls[i]],
                                          kind=k_).to(torch.float32)
        rows.append(cache[ck])
    av = torch.stack(rows)
    sv = _fleet_schedules(schedules, profs, n, cls)
    return profs, cls, branches, (pv, gv, av, idx, sv)


def _core_kwargs(fc: FleetConfig, steps: int, branches, n_classes: int
                 ) -> dict:
    return dict(branches=branches, n_classes=n_classes,
                budget=float(fc.power_budget),
                reallocate_every=int(fc.reallocate_every),
                boost=float(fc.straggler_boost), steps=int(steps),
                dt=float(fc.dt))


def _on(args, dev):
    pv, gv, av, cls, sv = args
    return (pv.to(dev), gv.to(dev), av.to(dev), cls.to(dev),
            None if sv is None else ScheduleValues(*(x.to(dev)
                                                     for x in sv)))


def simulate_fleet(profile, fc: FleetConfig, steps: int, seed: int = 0, *,
                   node_class: Optional[Sequence[int]] = None,
                   policies: Union[None, pol.Policy,
                                   Sequence[pol.Policy]] = None,
                   schedules: Union[None, PhaseSchedule,
                                    Sequence[Optional[PhaseSchedule]]]
                   = None,
                   device: Union[None, str, torch.device] = None) -> dict:
    """Run the two-level controller over a (possibly heterogeneous) fleet.

    ``profile`` is a single PlantProfile or a sequence of profile CLASSES
    with ``node_class`` mapping each node to its class (default:
    round-robin). ``policies`` assigns the per-node control policy — a
    single Policy, one per class, or one per node. ``schedules`` scripts
    per-node TIME-VARYING plants (`repro_torch.core.workloads`): a single
    PhaseSchedule, one per class, or one per node (None entries = static),
    each resolved against the node's class profile. Returns numpy traces
    aggregated per step: fleet progress mean/median, power, caps, plus
    per-class power/progress/cap (and allocation, when budgeted; mean
    active phase, when scheduled); ``class_counts`` gives the node count
    per class. Runs on CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    profs, cls, branches, args = _fleet_args(profile, fc, node_class,
                                             policies, schedules)
    seeds = torch.tensor([int(seed)], dtype=torch.int64)
    tr = _fleet_core(*_on(args, dev), seeds.to(dev),
                     **_core_kwargs(fc, steps, branches, len(profs)))
    out = {k: v[0].cpu().numpy() for k, v in tr.items()}
    out["class_counts"] = np.bincount(cls, minlength=len(profs))
    return out


def _seed_core(kw: dict):
    """Executor-facing fleet engine: rows {"seed": (S,)} -> the traces
    dict with a leading seed axis."""

    def flat(b, pv, gv, av, cls, sv=None):
        dev = b["seed"].device
        return _fleet_core(*_on((pv, gv, av, cls, sv), dev), b["seed"], **kw)

    return flat


def fleet_sweep(profile, fc: FleetConfig, steps: int,
                seeds: Sequence[int], *,
                node_class: Optional[Sequence[int]] = None,
                policies: Union[None, pol.Policy,
                                Sequence[pol.Policy]] = None,
                schedules: Union[None, PhaseSchedule,
                                 Sequence[Optional[PhaseSchedule]]]
                = None,
                chunk_size: Optional[int] = None,
                devices=None, durable=None, campaign=None,
                device: Union[None, str, torch.device] = None) -> dict:
    """Multi-seed fleet campaign on the chunked executor: the
    `simulate_fleet` engine over independent seed realizations, cut into
    ``chunk_size`` seeds a chunk and spread over ``devices`` like any
    `sweep` grid (`repro_torch.core.executor`). Returns `simulate_fleet`'s
    traces dict with a leading seed axis on every per-step series and
    per-run reduction.

    ``durable=dir`` journals the campaign through
    `repro_torch.core.supervisor`; `supervisor.resume_campaign(dir)`
    reopens it after a crash and returns the identical traces dict.
    ``campaign=`` tunes the `supervisor.CampaignConfig` ladder. Runs on
    CUDA unless ``device="cpu"``."""
    from repro_torch.core import supervisor

    resolve_device(device)
    if durable is not None:
        supervisor.save_campaign_spec(durable, "fleet_sweep", dict(
            profile=profile, fc=fc, steps=steps, seeds=list(seeds),
            node_class=(None if node_class is None else list(node_class)),
            policies=policies, schedules=schedules,
            chunk_size=chunk_size, devices=devices, campaign=campaign,
            device=device))
    profs, cls, branches, args = _fleet_args(profile, fc, node_class,
                                             policies, schedules)
    fn = _seed_core(_core_kwargs(fc, steps, branches, len(profs)))
    pv, gv, av, idx, sv = args
    shared = (pv, gv, av, idx) + (() if sv is None else (sv,))
    batched = {"seed": np.asarray([int(s) for s in seeds], np.int64)}
    if durable is not None:
        merged, _report = supervisor.run_durable(
            fn, batched, shared, len(seeds), dir=durable,
            chunk_size=chunk_size, devices=devices, device=device,
            config=campaign)
    else:
        merged, _ = executor.run_grid(fn, batched, shared, len(seeds),
                                      chunk_size=chunk_size,
                                      devices=devices, device=device)
    out = dict(merged)
    out["class_counts"] = np.bincount(cls, minlength=len(profs))
    return out


def _simulate_fleet_reference(profile, fc: FleetConfig, steps: int,
                              seed: int = 0,
                              node_class: Optional[Sequence[int]] = None,
                              device: Union[None, str, torch.device] = None
                              ) -> dict:
    """Hand-rolled per-node fleet step (plant_step + pi_step on raw
    measured progress, no heartbeat aggregation), generalized to per-node
    profile classes, on the nodes' plant-noise streams. Kept ONLY as the
    statistical-equivalence oracle for the engine-backed
    `simulate_fleet`. Returns numpy traces."""
    dev = resolve_device(device)
    profs, cls = _fleet_layout(profile, fc, node_class)
    n = fc.n_nodes
    gains = [PIGains.from_model(p, fc.epsilon, fc.tau_obj) for p in profs]
    idx = torch.as_tensor(cls, dtype=torch.int64)
    pv = torch.stack([sim.profile_values(p) for p in profs])[idx].to(dev)
    gv = torch.stack([gains_values(g) for g in gains])[idx].to(dev)
    prof, g = sim._unpack_profile(pv), unpack_gains(gv)
    lo, hi = pv[:, _F_PCAP_MIN], pv[:, _F_PCAP_MAX]
    setpoints = gv[:, _G_SETPOINT]
    masks = idx.to(dev)[None, :] == torch.arange(len(profs), device=dev)[
        :, None]
    counts = torch.clamp(masks.sum(-1).to(torch.float32), min=1.0)
    seg = lambda x: _node_sum(torch.where(masks, x[None, :], 0.0))
    budgeted = fc.power_budget > 0
    plant_s = plant_init(prof)
    pi_s = pi_init(g)
    caps = hi
    streams = NodeStreams(node_seeds([int(seed)], n).to(dev))
    rows = []
    for t in range(steps):
        noise, _ = streams(t)
        plant_s, meas = plant_step(prof, plant_s, caps, fc.dt, noise)
        progress = meas["progress"]
        if budgeted and t % fc.reallocate_every == 0:
            rel = progress / torch.clamp(setpoints, min=1e-9)
            med = median(rel)
            lag = torch.clamp((med - rel) / torch.clamp(med, min=1e-9),
                              min=0.0)
            caps = _water_fill_bounds(lo, hi, fc.power_budget,
                                      1.0 + fc.straggler_boost * lag)
        pi_s, pi_caps = pi_step(g, pi_s, progress, fc.dt)
        caps = torch.minimum(pi_caps, caps) if budgeted else pi_caps
        rows.append({
            "progress_mean": _node_sum(progress) / n,
            "progress_med": median(progress),
            "power": _node_sum(meas["power"]),
            "pcap_mean": _node_sum(caps) / n,
            "power_class": seg(meas["power"]),
            "progress_class": seg(progress) / counts})
    out = {k: torch.stack([r[k] for r in rows]).cpu().numpy()
           for k in rows[0]}
    final = PlantState(*plant_s)
    out["energy_total"] = float(_node_sum(final.energy))
    out["work_total"] = float(_node_sum(final.work))
    out["energy_class"] = seg(final.energy).cpu().numpy()
    return out
