"""Pluggable power-policy subsystem: the uniform contract of the scan
engine's controllers; port of `repro.core.policies.base`.

The paper's PI controller (Eq. 4) is one point in a space of power-capping
policies (offline-RL power control, duty-cycle modulation, ...). This
package turns "which controller runs inside the closed loop" into data the
scan engine (`repro_torch.core.sim`) dispatches through, instead of a fork
of `engine_step` per policy.

Contract (plain PyTorch on batches of runs; every vector below is a
(..., width) float32 tensor whose leading axes are the runs):

* ``policy_values(policy, profile, gains) -> (POLICY_PARAM_DIM,)`` — the
  policy's hyperparameters packed into a fixed-width vector (slot 0 is
  the dispatch kind, assigned by the caller for heterogeneous grids).
* ``policy_init(policy, vals, gains) -> (..., POLICY_STATE_DIM)`` — the
  policy's initial state packed into a fixed-width vector. A uniform
  state width is what lets heterogeneous policies share one batch.
* ``policy_step(policy, vals, state, obs) -> (state, pcap)`` — one
  control period: observe (aggregated progress, measured power, dt, the
  actuator/setpoint context in ``obs.gains``) and emit the next power
  cap in watts.

Policies are *branches*: a branch is the compute of one policy kind
(step/init/extras/on_change functions over the packed vectors),
registered by name in ``BRANCHES``; a ``Policy`` dataclass instance is
the host-side config that names its branch and packs its values. Where
the reference switches between the branches of a heterogeneous set per
run (``lax.switch``), the port computes every active branch on all the
rows and selects each row's result by its kind with ``torch.where``: a
fixed sequence of launches per step, with no data-dependent indexing
and no host sync.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, \
    Union

import torch

from repro_torch.core.controller import PIGains
from repro_torch.core.plant import PlantProfile

# Fixed widths of the packed policy vectors. STATE must hold the largest
# policy state (PI + the 14-slot RLS estimator block = 16) plus the
# branch tag; PARAM must hold kind + the largest hyperparameter/weight
# set (offline-RL: 6 feature weights).
POLICY_STATE_DIM = 17
POLICY_PARAM_DIM = 10
# Slot stamped with the producing branch's id (`branch_tag`) at init and
# preserved by every step, so a packed state resumed under a DIFFERENT
# branch is detectable instead of silently misread. 0 means untagged.
BRANCH_TAG_SLOT = 16


class PolicyObs(NamedTuple):
    """Per-period observation handed to `policy_step`.

    ``gains`` carries the shared actuator/setpoint context (Eq. 2
    transform, pcap range, setpoint) with (...) tensor fields — all
    policies cap against the same plant model the PI was designed on.
    """
    progress: torch.Tensor  # Eq. 1 aggregated heart-rate [Hz]
    power: torch.Tensor     # measured power this period [W]
    dt: torch.Tensor        # control period [s]
    gains: PIGains
    # 1.0 on periods where a change-point detector fired; 0.0 otherwise
    phase_change: Union[torch.Tensor, float] = 0.0


class Branch(NamedTuple):
    """The compute of one policy kind."""
    step: Callable       # (vals, state, obs) -> (state, pcap)
    init: Callable       # (vals, gains) -> state
    extras: Callable     # (state) -> dict of per-step trace extras
    on_change: Callable  # (vals, state) -> state, on a detected phase change


BRANCHES: Dict[str, Branch] = {}


def register_branch(name: str, step: Callable, init: Callable,
                    extras: Optional[Callable] = None,
                    on_change: Optional[Callable] = None) -> None:
    """Register a policy branch (the extension point for custom policies).

    ``on_change`` is applied to the packed state on a detected phase
    change (default: identity) — e.g. adaptive PI resets its RLS
    covariance there so gains re-converge fast."""
    for other in BRANCHES:
        if other != name and branch_tag(other) == branch_tag(name):
            raise ValueError(f"branch tag collision: '{name}' and "
                             f"'{other}' hash alike; pick another name")
    BRANCHES[name] = Branch(step=step, init=init,
                            extras=extras or (lambda state: {}),
                            on_change=on_change
                            or (lambda vals, state: state))


@dataclasses.dataclass(frozen=True)
class Policy:
    """Host-side policy config: names a branch, packs its values."""

    @property
    def branch(self) -> str:
        raise NotImplementedError

    def values(self, profile: PlantProfile, gains: PIGains) -> torch.Tensor:
        """Policy hyperparameters at slots [1:]; slot 0 (kind) is left 0."""
        return torch.zeros((POLICY_PARAM_DIM,), dtype=torch.float32)


def pack_values(*params) -> torch.Tensor:
    """Pack params into slots [1:1+len] of a zeroed PARAM vector."""
    v = torch.zeros((POLICY_PARAM_DIM,), dtype=torch.float32)
    if params:
        v[1:1 + len(params)] = torch.tensor([float(p) for p in params],
                                            dtype=torch.float32)
    return v


# ---- module-level contract functions --------------------------------------

BranchSpec = Union[str, Tuple[str, ...], Policy]


def as_branches(policy: BranchSpec) -> Tuple[str, ...]:
    if isinstance(policy, Policy):
        return (policy.branch,)
    if isinstance(policy, str):
        return (policy,)
    return tuple(policy)


def policy_values(policy: Policy, profile: PlantProfile, gains: PIGains,
                  kind: int = 0) -> torch.Tensor:
    """The contract's `policy_values`: the param vector with the dispatch
    kind (index into the active branch tuple) at slot 0."""
    v = policy.values(profile, gains).clone()
    v[0] = float(kind)
    return v


def branch_tag(name: str) -> int:
    """Stable numeric id of a branch, derived from its NAME (not the
    registry order) so tags in saved state vectors survive across
    sessions and import orders. 0 is reserved for 'untagged'; values fit
    exactly in a float32 slot. `register_branch` rejects collisions."""
    return zlib.crc32(name.encode()) % 65521 + 1


def tag_branch(tag: int) -> Optional[str]:
    """Inverse of `branch_tag` over the registered branches; None for
    0/unknown tags."""
    for name in BRANCHES:
        if branch_tag(name) == tag:
            return name
    return None


def _kind(vals, n: int) -> torch.Tensor:
    """Each row's branch index: vals[..., 0] truncated and clipped to
    [0, n)."""
    return torch.clamp(vals[..., 0].to(torch.int32), 0, n - 1)


def _select(kind, outs):
    """Row-wise pick among per-branch results (tensors or tuples of
    tensors, each computed on every row): output i where kind == i."""
    def pick(i, xs):
        if len(xs) == 1:
            return xs[0]
        rest = pick(i + 1, xs[1:])
        k = kind == i
        return torch.where(k.reshape(k.shape + (1,) * (xs[0].dim()
                                                       - k.dim())),
                           xs[0], rest)

    if isinstance(outs[0], tuple):
        return tuple(pick(0, list(xs)) for xs in zip(*outs))
    return pick(0, list(outs))


def _with_tag(new: torch.Tensor, tag: torch.Tensor) -> torch.Tensor:
    """``new`` with its branch tag slot replaced by ``tag`` (...)."""
    return torch.cat([new[..., :BRANCH_TAG_SLOT], tag[..., None],
                      new[..., BRANCH_TAG_SLOT + 1:]], -1)


def branch_step(policy: BranchSpec) -> Callable:
    """(vals, state, obs) -> (state, pcap). With more than one branch
    active, every branch steps on all rows and each row keeps the result
    of its kind (vals[..., 0]). The branch tag slot is carried through
    unchanged."""
    bs = [BRANCHES[b] for b in as_branches(policy)]
    if len(bs) == 1:
        inner = bs[0].step
    else:
        def inner(vals, state, obs):
            return _select(_kind(vals, len(bs)),
                           [b.step(vals, state, obs) for b in bs])

    def step(vals, state, obs):
        new, pcap = inner(vals, state, obs)
        return _with_tag(new, state[..., BRANCH_TAG_SLOT]), pcap

    return step


def branch_init(policy: BranchSpec) -> Callable:
    names = as_branches(policy)
    bs = [BRANCHES[b] for b in names]
    tags = [float(branch_tag(b)) for b in names]
    if len(bs) == 1:
        def init(vals, gains):
            state = bs[0].init(vals, gains)
            return _with_tag(state, torch.full_like(
                state[..., BRANCH_TAG_SLOT], tags[0]))
    else:
        def init(vals, gains):
            kind = _kind(vals, len(bs))
            state = _select(kind, [b.init(vals, gains) for b in bs])
            tag = _select(kind, [torch.full_like(
                state[..., BRANCH_TAG_SLOT], t) for t in tags])
            return _with_tag(state, tag)

    return init


def branch_on_change(policy: BranchSpec) -> Callable:
    """(vals, state) -> state, the phase-change reaction, selected per row
    by kind for heterogeneous sets. The branch tag is preserved."""
    bs = [BRANCHES[b] for b in as_branches(policy)]
    if len(bs) == 1:
        inner = bs[0].on_change
    else:
        def inner(vals, state):
            return _select(_kind(vals, len(bs)),
                           [b.on_change(vals, state) for b in bs])

    def on_change(vals, state):
        return _with_tag(inner(vals, state), state[..., BRANCH_TAG_SLOT])

    return on_change


def branch_extras(policy: BranchSpec) -> Callable:
    """Per-step trace extras. Heterogeneous branch sets emit none (the
    trace keys must be the same for every run of a batch)."""
    names = as_branches(policy)
    if len(set(names)) == 1:
        return BRANCHES[names[0]].extras
    return lambda state: {}


def policy_step(policy: BranchSpec, vals, state, obs: PolicyObs):
    """The contract's `policy_step(vals, state, obs) -> (state, pcap)`."""
    return branch_step(policy)(vals, state, obs)


def policy_init(policy: BranchSpec, vals, gains: PIGains):
    """The contract's `policy_init(vals) -> PolicyState` (needs the gains
    context: e.g. PI seeds its carried command at the actuator max)."""
    return branch_init(policy)(vals, gains)


def resolve_kinds(policies: Sequence[Policy]
                  ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Dedup the branch set (order of first appearance) and map each
    policy to its kind index within it."""
    branches = tuple(dict.fromkeys(p.branch for p in policies))
    kinds = tuple(branches.index(p.branch) for p in policies)
    return branches, kinds
