"""Checkpoint manager: atomic, async-capable, restore onto a device; port
of `repro.checkpoint.manager`, in the reference's file format.

Format: one ``arrays.npz`` of flattened keypath -> array per step (keys
as the reference's ``jax.tree_util.keystr``: ``['params']['blocks'][0]
['mix']['wq']``), plus a JSON sidecar (step, metadata, controller and
data state). bfloat16 leaves are stored as 2-byte raw values (``V2``),
which is what ``np.savez`` writes for the reference's bfloat16 arrays;
they are read back as bfloat16. So a checkpoint of either package
restores in the port. Writes go to a temp dir and are renamed into place
(atomic on POSIX), so a crash mid-save never corrupts the latest
checkpoint; ``keep`` old steps are retained for rollback.

The reference's elastic restore reshards onto the current TPU mesh; here
a leaf whose template is a DTensor (a mesh of several ranks) is restored
as this rank's shard in the template's placements, and any other leaf
onto the template's device (or the one given). A DTensor leaf is saved
whole: every rank gathers it (a collective, so every rank calls `save`),
and rank 0 writes the step.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.layers import (is_def, local_part,
                                       tree_leaves_with_path, tree_map)

_RAW16 = np.dtype("V2")


def _to_host(t) -> np.ndarray:
    """A tensor (or number) -> a numpy copy that later in-place updates of
    the tensor do not reach; bfloat16 as raw 2-byte values."""
    if not isinstance(t, torch.Tensor):
        return np.array(t)
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_RAW16)
    return t.numpy()


def _from_host(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _unflatten_like(template, arrays: Dict[str, np.ndarray], device):
    paths = iter(p for p, _ in tree_leaves_with_path(template))

    def one(tmpl):
        key = next(paths)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != expected "
                f"{tuple(tmpl.shape)}")
        if device is not None:
            dev = device
        elif isinstance(tmpl, torch.Tensor):
            dev = tmpl.device
        else:
            dev = resolve_device(None)
        if is_dtensor(tmpl):
            return local_part(_from_host(arr).to(dev), tmpl.device_mesh,
                               tmpl.placements)
        return _from_host(arr).to(dev)

    return tree_map(one, template, is_leaf=is_def)


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group
    that is up, or a process with none."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


class CheckpointManager:
    def __init__(self, directory: Union[str, Path], keep: int = 3,
                 async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # ---- save ---------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[dict] = None) -> Path:
        """Write ``tree`` (dicts and tuples of tensors) as step ``step``.
        The tensors are copied to the host before this returns, so an
        async save may run while they are updated in place."""
        self.wait()  # one in-flight async save at a time
        flat = {k: _to_host(v) for k, v in tree_leaves_with_path(tree)}
        if not _writes():
            return self.dir / f"step_{step:09d}"

        def _write():
            tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
            try:
                np.savez(tmp / "arrays.npz", **flat)
                (tmp / "meta.json").write_text(json.dumps(
                    {"step": step, "extra": extra or {}}))
                final = self.dir / f"step_{step:09d}"
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)
            finally:
                if tmp.exists():
                    shutil.rmtree(tmp, ignore_errors=True)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
        return self.dir / f"step_{step:09d}"

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ---- restore ------------------------------------------------------
    def all_steps(self):
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if (p / "meta.json").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, template,
                device: Union[None, str, torch.device] = None):
        """Load a checkpoint (the latest without ``step``).

        ``template``: a tree of tensors or of `ParamDef`s defining the
        expected structure and shapes. Each leaf lands on ``device``;
        without one, on its template tensor's device, and for a
        `ParamDef` on CUDA (raising without a card; pass
        ``device="cpu"``). Returns (tree, extra_metadata)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:09d}"
        meta = json.loads((path / "meta.json").read_text())
        with np.load(path / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        dev = None if device is None else resolve_device(device)
        return _unflatten_like(template, arrays, dev), meta["extra"]
