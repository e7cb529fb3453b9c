"""Mesh construction; port of `repro.launch.mesh`.

One rank per process, as PyTorch runs a mesh: a ``DeviceMesh`` over the
ranks of the default process group, with the reference's axis names.

* `make_host_mesh` — a ``(1, world_size)`` ``("data", "model")`` mesh over
  the ranks that exist (one process per card, as under ``torchrun``);
  with no group up it starts a one-rank group (NCCL on the card, gloo on
  the CPU). `host_mesh` holds it for one run: the serve and train entry
  points run under its rules, and a group it started is destroyed when
  the run ends.
* `make_production_mesh` — the reference's 16x16 and 2x16x16 TPU meshes
  as ``DeviceMesh``es over a fake process group of 256 or 512 ranks
  (``torch.testing._internal.distributed.fake_pg``: collectives are
  no-ops, this process is rank 0), for the dry-run's fake tensors. It is
  the counterpart of the reference's
  ``--xla_force_host_platform_device_count=512``.

Both are functions, so importing this module starts no group.
"""
from __future__ import annotations

import contextlib
from typing import Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig


def _dist():
    import torch.distributed as dist
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    return dist


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """A (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data",
    "model") ``DeviceMesh`` over a fake process group of 256 or 512
    ranks. Starts that group when none is up, replaces a fake group of
    another size, and raises if a real group of another size is up."""
    from torch.distributed.device_mesh import init_device_mesh
    dist = _dist()
    cfg = mesh_config(multi_pod=multi_pod)
    n = cfg.num_devices
    if dist.is_initialized() and dist.get_world_size() != n:
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is up; the production mesh "
                f"needs a fake group of {n}")
        dist.destroy_process_group()
    if not dist.is_initialized():
        # imported here: a testing module, needed by the dry-run only
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return init_device_mesh(device_type, cfg.shape,
                            mesh_dim_names=cfg.axes)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_host_mesh(device: Union[None, str, torch.device] = None):
    """A (1, world_size) ("data", "model") mesh over the ranks of the
    default group on ``device``'s type (CUDA unless ``device="cpu"``).
    With no group up it starts a one-rank group on a local ``HashStore``:
    NCCL for CUDA, gloo for the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    dist = _dist()
    dev = resolve_device(device)
    key = (dev.type, dist.is_initialized() and dist.get_world_size())
    if dist.is_initialized() and key in _HOST_MESHES:
        return _HOST_MESHES[key]
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_backend() == "fake":
        raise RuntimeError("a fake process group is up (the dry-run's); "
                           "the host mesh needs real ranks")
    mesh = init_device_mesh(dev.type, (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))
    _HOST_MESHES[(dev.type, dist.get_world_size())] = mesh
    return mesh


@contextlib.contextmanager
def host_mesh(device: Union[None, str, torch.device] = None):
    """`make_host_mesh` for the span of one run. A one-rank group that it
    had to start is destroyed on the way out, so the process is left as
    it was found (a group the caller started, as under ``torchrun``,
    stays up)."""
    dist = _dist()
    started = not dist.is_initialized()
    mesh = make_host_mesh(device)
    try:
        yield mesh
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
            _HOST_MESHES.clear()


def describe(mesh) -> str:
    """``data=1 x model=1 on cuda``: a mesh's axes, sizes and device
    type, for logs and results."""
    return " x ".join(f"{n}={k}" for n, k in zip(mesh.mesh_dim_names,
                                                  mesh.shape)) + \
        f" on {mesh.device_type}"


def dtensor_leaves(tree) -> int:
    """How many leaves of a tensor tree are DTensors (none on one rank)."""
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.models.layers import tree_leaves_with_path
    return sum(is_dtensor(t) for _, t in tree_leaves_with_path(tree))


# host meshes already built, by (device type, world size): serve and
# train build theirs on every call, and a mesh makes groups of its own
_HOST_MESHES: dict = {}
