"""Chunked, sharded sweep execution (the scale layer); port of
`repro.core.executor`.

A grid's engine runs one batch of runs on one device: O(grid) device
memory in summary mode, O(grid * T) in trace mode. This module sits
between a grid and the hardware:

* **Chunking**: a flat run list of any length is cut into fixed-size
  chunks (the last one padded with copies of its first row, the pad
  discarded), so a million-run grid needs O(chunk) device memory.
* **Sharding**: with more than one device a chunk's rows are split over
  the devices in order (the reference's ``pmap`` layout); per-run results
  are identical either way because every run's parameters and random
  streams ride in its own row.
* **Streaming merge**: each chunk's outputs come to the host with one
  synchronisation per device (every leaf copied asynchronously into
  pinned memory) and land in preallocated host buffers, or go to a ``consume(lo, hi, out)`` callback as arrays that
  own their storage, and are dropped.
* **Resume**: `ExecState` records which chunks are done plus the
  partly filled buffers; ``run_grid(..., state=...)`` picks up at the
  first unfinished chunk, and ``stop_after=`` bounds one call's work so a
  campaign can be split across processes.

PyTorch has no buffer donation: ``donate=True`` drops a chunk's input and
output tensors before the next chunk is prepared, so at most one chunk's
tensors are alive at a time (peak device memory says what that buys).

`sim.sweep(chunk_size=, devices=, consume=)`, `sim.sweep_resumable`,
`supervisor.run_durable` and `policies.offline_rl.harvest_dataset` ride
this one loop.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

Devices = Union[None, int, str, Sequence]


def resolve_devices(devices: Devices = None,
                    device: Union[None, str, torch.device] = None
                    ) -> Tuple[torch.device, ...]:
    """Normalize a ``devices=`` argument to a tuple of torch devices.

    ``None`` / 1 -> the one device ``device`` names (CUDA unless told
    otherwise); ``"all"`` -> every CUDA device; an int n -> the first n
    CUDA devices (ValueError when fewer exist); a sequence is taken as
    is, each entry through `torch.device` (``("cpu", "cpu")`` splits
    chunks over two CPU shards)."""
    if devices is None or (isinstance(devices, int) and devices == 1):
        return (resolve_device(device),)
    if devices == "all":
        resolve_device(None)  # raises without a card
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    if isinstance(devices, int):
        avail = torch.cuda.device_count()
        if devices < 1 or devices > avail:
            raise ValueError(f"asked for {devices} devices, {avail} "
                             "available")
        return tuple(torch.device("cuda", i) for i in range(devices))
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("devices= names no device")
    return devs


@dataclasses.dataclass
class ExecState:
    """Resumable progress of one chunked grid: which chunks are done and
    the partly filled host output buffers. Everything is plain numpy, so
    the state round-trips through pickle across processes;
    `fingerprint` guards against resuming with a different grid or
    chunking."""
    n_runs: int
    chunk: int
    done: np.ndarray                      # (n_chunks,) bool
    buffers: Any = None                   # output tree of np arrays
    fingerprint: str = ""

    @property
    def n_chunks(self) -> int:
        return len(self.done)

    @property
    def complete(self) -> bool:
        return bool(self.done.all())


# ---- trees: dicts (sorted keys), NamedTuples, tuples, lists, None --------

_LEAF = "*"


def _walk(x, leaves: list):
    if x is None:
        return None
    if isinstance(x, dict):
        keys = sorted(x)
        return (dict, tuple(keys), tuple(_walk(x[k], leaves) for k in keys))
    if isinstance(x, (tuple, list)):
        return (type(x), None, tuple(_walk(v, leaves) for v in x))
    leaves.append(x)
    return _LEAF


def _flatten(tree) -> Tuple[list, Any]:
    """(leaves, spec) of a tree of dicts (keys sorted), NamedTuples,
    tuples and lists; None holds no leaf; anything else is a leaf.

    The walkers are module functions, not closures: a recursive closure
    is a reference cycle that would keep its leaves (a chunk's tensors)
    alive until the cyclic collector runs."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _build(s, it):
    if s is None:
        return None
    if s == _LEAF:
        return next(it)
    kind, keys, kids = s
    vals = [_build(k, it) for k in kids]
    if kind is dict:
        return dict(zip(keys, vals))
    if hasattr(kind, "_fields"):
        return kind(*vals)
    return kind(vals)


def _unflatten(spec, leaves: Sequence) -> Any:
    return _build(spec, iter(leaves))


def _spec_str(spec) -> str:
    if spec is None or spec == _LEAF:
        return str(spec)
    kind, keys, kids = spec
    return (f"{kind.__name__}{list(keys) if keys else ''}("
            + ",".join(_spec_str(k) for k in kids) + ")")


def _host(x) -> np.ndarray:
    """A leaf as numpy (a CPU tensor without a copy)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def digest(batched: Any, shared: Tuple = ()) -> str:
    """Content hash of a (batched, shared) grid: tree structure and every
    leaf's shape, dtype and bytes. The resume guard of `run_grid` and the
    campaign supervisor."""
    h = hashlib.blake2b(digest_size=8)
    for tree in (batched, tuple(shared)):
        leaves, spec = _flatten(tree)
        h.update(_spec_str(spec).encode())
        for leaf in leaves:
            a = _host(leaf)
            h.update(f"{a.shape}{a.dtype}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _pad_rows(x: np.ndarray, lo: int, hi: int, pad: int) -> np.ndarray:
    """Rows [lo, hi) of a leaf padded to the full chunk with copies of its
    first row, always a fresh array: a chunk's input never shares memory
    with the caller's grid."""
    x = x[lo:hi]
    if pad:
        return np.concatenate(
            [x, np.broadcast_to(x[:1], (pad,) + x.shape[1:])])
    return np.array(x)


def _to_host(leaves: List[Any]) -> List[np.ndarray]:
    """Output leaves of one device -> numpy. CUDA tensors are copied
    asynchronously into pinned memory and read after ONE synchronisation
    (a copy per leaf into pageable memory would synchronise per leaf);
    CPU tensors are viewed as they are."""
    cuda = [isinstance(x, torch.Tensor) and x.device.type == "cuda"
            for x in leaves]
    if not any(cuda):
        return [_host(x) for x in leaves]
    # contiguous on the device first: a strided copy into a CPU
    # destination would stage through pageable memory and sync
    out = [x.detach().contiguous().to("cpu", non_blocking=True) if c
           else x for x, c in zip(leaves, cuda)]
    dev = next(x.device for x, c in zip(leaves, cuda) if c)
    torch.cuda.current_stream(dev).synchronize()
    return [_host(x) for x in out]


def _sync(devs: Sequence[torch.device]) -> None:
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_grid(fn: Callable, batched: Any, shared: Tuple, n_runs: int, *,
             chunk_size: Optional[int] = None, devices: Devices = None,
             device: Union[None, str, torch.device] = None,
             donate: bool = True, consume: Optional[Callable] = None,
             state: Optional[ExecState] = None,
             stop_after: Optional[int] = None,
             grid_digest: Optional[str] = None
             ) -> Tuple[Any, ExecState]:
    """Drive ``fn(batched_chunk, *shared)`` over a flat run list.

    ``batched`` is a tree (dicts, NamedTuples, tuples) whose leaves (numpy
    arrays or CPU tensors) all have leading axis ``n_runs``; each chunk's
    rows reach ``fn`` as tensors on one device, and ``fn`` returns a tree
    of tensors (or numpy arrays) whose leaves all have the chunk's
    leading axis. Results are merged into host numpy buffers in run
    order, or handed to ``consume(lo, hi, chunk_out)`` per chunk and
    dropped. Returns ``(merged | None, ExecState)``; ``merged`` is None
    when a consume hook ran or the state is still incomplete
    (``stop_after=`` cut the call short: pass the state back in to
    continue across the chunk boundary).

    ``devices=`` (see `resolve_devices`; default the one device
    ``device`` names) splits each chunk's rows over the devices in order;
    the chunk is rounded up to a multiple of their count (pad rows fill
    the rest). Tensor ``shared`` arguments are copied to each device once.

    Observability: chunk/run/resume counters, live progress gauges
    (``executor_grid_chunks_done`` / ``_planned``) and a runs-per-second
    gauge publish into the process metrics registry after every chunk,
    and when the span tracer is enabled (`repro_torch.obs.trace.enable()`)
    every chunk emits prepare / compute / transfer / merge spans with its
    devices; the first chunk of a call is marked ``cold`` (its compute
    span includes a kernel's build and load at its first launch)."""
    chunk = int(chunk_size) if chunk_size else n_runs
    chunk = max(1, min(chunk, n_runs))
    devs = resolve_devices(devices, device)
    nd = len(devs)
    if chunk % nd:
        chunk += nd - chunk % nd  # pad rows fill the rest
    n_chunks = -(-n_runs // chunk)
    fingerprint = f"{n_runs}x{chunk}"
    if state is not None or stop_after is not None:
        # resumable flows guard CONTENT, not just shape: a same-shape grid
        # with other parameters must not merge into a half-finished
        # state's buffers. grid_digest= lets a caller that already hashed
        # the grid (the campaign supervisor calls this once per chunk)
        # skip hashing it again.
        fingerprint += ":" + (grid_digest or digest(batched, shared))

    reg = obs_metrics.get_registry()
    tracer = obs_trace.get_tracer()
    if state is None:
        state = ExecState(n_runs=n_runs, chunk=chunk,
                          done=np.zeros((n_chunks,), bool),
                          fingerprint=fingerprint)
    elif state.fingerprint != fingerprint:
        raise ValueError(f"resume state was built for grid "
                         f"{state.fingerprint}, this call is "
                         f"{fingerprint}")
    elif state.done.any():
        reg.counter("executor_resumes_total",
                    "run_grid calls resumed from partial ExecState").inc()

    dev_ids = [str(d) for d in devs]
    leaves, spec = _flatten(batched)
    leaves = [_host(x) for x in leaves]
    shared_on = [tuple(s.to(d) if isinstance(s, torch.Tensor) else s
                       for s in shared) for d in devs]
    per = chunk // nd
    c_chunks = reg.counter("executor_chunks_total", "grid chunks executed")
    c_runs = reg.counter("executor_runs_total", "grid runs executed")
    g_rate = reg.gauge("executor_last_runs_per_sec",
                       "throughput of the most recent run_grid call")
    g_plan = reg.gauge("executor_grid_chunks_planned",
                       "chunk count of the current run_grid call")
    g_done = reg.gauge("executor_grid_chunks_done",
                       "chunks completed (incl. resumed) of the current "
                       "run_grid call")
    g_plan.set(n_chunks)
    g_done.set(int(state.done.sum()))
    ran = 0
    runs_done = 0
    t0 = time.perf_counter()
    for ci in range(n_chunks):
        if state.done[ci]:
            continue
        if stop_after is not None and ran >= stop_after:
            return None, state
        lo, hi = ci * chunk, min((ci + 1) * chunk, n_runs)
        pad = chunk - (hi - lo)
        with tracer.span("executor/prepare", chunk=ci, lo=lo, hi=hi,
                         pad=pad, devices=dev_ids):
            rows = [_pad_rows(x, lo, hi, pad) for x in leaves]
            chunk_in = [_unflatten(spec, [
                torch.from_numpy(r[k * per:(k + 1) * per]).to(d)
                for r in rows]) for k, d in enumerate(devs)]
            del rows
        with tracer.span("executor/compute", chunk=ci, lo=lo, hi=hi,
                         devices=dev_ids, cold=ran == 0):
            outs = [fn(chunk_in[k], *shared_on[k]) for k in range(nd)]
            if tracer.enabled:
                # asynchronous launches would book the compute time under
                # the transfer span
                _sync(devs)
        with tracer.span("executor/transfer", chunk=ci, devices=dev_ids):
            out_spec = _flatten(outs[0])[1]
            shards = [_to_host(_flatten(o)[0]) for o in outs]
            host = (shards[0] if nd == 1 else
                    [np.concatenate(parts) for parts in zip(*shards)])
            host = [x[:hi - lo] for x in host]
        with tracer.span("executor/merge", chunk=ci, lo=lo, hi=hi,
                         consume=consume is not None):
            if consume is not None:
                # everything handed outward owns its storage: the
                # transfer's arrays are views of pinned buffers (and of
                # the pad rows)
                consume(lo, hi, _unflatten(out_spec,
                                           [np.array(x) for x in host]))
            elif state.buffers is None and lo == 0 and hi == n_runs:
                # one chunk covers the grid: its arrays are the result
                state.buffers = _unflatten(out_spec, host)
            else:
                if state.buffers is None:
                    state.buffers = _unflatten(out_spec, [
                        np.empty((n_runs,) + x.shape[1:], x.dtype)
                        for x in host])
                for buf, x in zip(_flatten(state.buffers)[0], host):
                    buf[lo:hi] = x
        if donate:
            # no buffer donation in PyTorch: drop this chunk's tensors
            # before the next chunk's are made
            del chunk_in, outs, shards, host
        state.done[ci] = True
        ran += 1
        runs_done += hi - lo
        c_chunks.inc()
        c_runs.inc(hi - lo)
        g_done.set(int(state.done.sum()))
        elapsed = time.perf_counter() - t0
        if elapsed > 0:
            g_rate.set(runs_done / elapsed)
    merged = (state.buffers if (consume is None and state.complete)
              else None)
    return merged, state
