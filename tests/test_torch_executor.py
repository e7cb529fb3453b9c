"""The port's execution layer (`repro_torch.core.executor`, `sim.sweep`'s
``chunk_size=`` / ``devices=`` / ``consume=``, `sim.sweep_resumable`,
`offline_rl.harvest_dataset`) on the CPU: twins of the reference's
`tests/test_executor.py` (its fleet test is mirrored in
`tests/test_torch_hierarchy.py`).

The property everywhere: every run's parameters and random streams ride
in its own row of the flattened grid, so ANY execution layout (one shot,
chunked, split over devices, stopped and resumed) produces identical
per-run results. Tolerance: none; every comparison is bit for bit,
within the port (the reference's Poisson heartbeats come from
`jax.random`, which the port does not re-implement).
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import executor  # noqa: E402
from repro_torch.core.plant import PROFILES  # noqa: E402
from repro_torch.core.policies.offline_rl import (build_dataset,  # noqa: E402
                                                  harvest_dataset)
from repro_torch.core.sim import sweep, sweep_resumable  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

KW = dict(total_work=500.0, max_time=200.0, device="cpu")


def _equal(a, b, keys=None):
    for k in keys or a.traces:
        np.testing.assert_array_equal(a.traces[k], b.traces[k], err_msg=k)


@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_chunked_equals_one_shot_trace_mode(backend):
    one = sweep(["gros", "dahu"], [0.1, 0.3], range(3), backend=backend,
                **KW)
    ch = sweep(["gros", "dahu"], [0.1, 0.3], range(3), chunk_size=5,
               backend=backend, **KW)
    _equal(one, ch)
    np.testing.assert_array_equal(one.exec_time, ch.exec_time)
    np.testing.assert_array_equal(one.n_steps, ch.n_steps)


@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_chunked_equals_one_shot_summary_mode(backend):
    kw = dict(collect_traces=False, backend=backend, **KW)
    one = sweep("gros", [0.1, 0.3], range(4), **kw)
    ch = sweep("gros", [0.1, 0.3], range(4), chunk_size=3, **kw)
    for k in ("progress_mean", "power_mean", "progress_hist",
              "pcap_hist"):
        np.testing.assert_array_equal(one.summary[k], ch.summary[k],
                                      err_msg=k)
    np.testing.assert_array_equal(one.energy, ch.energy)


def test_chunked_adaptive_and_workload_axes():
    """Chunking slices the FLATTENED grid, so multi-axis grids (eps x
    RLS configs x seeds, workload axes) reassemble exactly."""
    from repro_torch.core.adaptive import RLSConfig
    from repro_torch.core.workloads import Phase, PhaseSchedule
    cfgs = [RLSConfig(lam=0.99), RLSConfig(lam=0.999)]
    kw = dict(collect_traces=False, **KW)
    one = sweep("gros", [0.1, 0.2], range(2), adaptive=cfgs, **kw)
    ch = sweep("gros", [0.1, 0.2], range(2), adaptive=cfgs, chunk_size=3,
               **kw)
    np.testing.assert_array_equal(one.exec_time, ch.exec_time)
    np.testing.assert_array_equal(one.summary["pcap_hist"],
                                  ch.summary["pcap_hist"])
    wls = [PhaseSchedule((Phase(50.0, scale=(("K_L", 2.0),)),
                          Phase(50.0)), cyclic=True),
           PhaseSchedule((Phase(100.0),))]
    onw = sweep("gros", [0.1], range(2), workloads=wls, **kw)
    chw = sweep("gros", [0.1], range(2), workloads=wls, chunk_size=2, **kw)
    np.testing.assert_array_equal(onw.exec_time, chw.exec_time)
    np.testing.assert_array_equal(onw.energy, chw.energy)


@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_resume_across_chunk_boundary_round_trips(backend):
    """Stop after one chunk, pickle the state, resume from a fresh
    unpickle: the completed grid equals one-shot; a state built for
    another chunking, or another grid of the same shape, is rejected."""
    kw = dict(collect_traces=False, backend=backend, **KW)
    one = sweep("gros", [0.1, 0.3], range(4), **kw)
    res, st = sweep_resumable("gros", [0.1, 0.3], range(4), chunk_size=3,
                              stop_after=1, **kw)
    assert res is None and not st.complete
    assert st.done.sum() == 1 and st.n_chunks == 3
    st = pickle.loads(pickle.dumps(st))
    res, st = sweep_resumable("gros", [0.1, 0.3], range(4), chunk_size=3,
                              state=st, **kw)
    assert st.complete
    np.testing.assert_array_equal(one.exec_time, res.exec_time)
    np.testing.assert_array_equal(one.summary["pcap_hist"],
                                  res.summary["pcap_hist"])
    with pytest.raises(ValueError, match="resume state"):
        sweep_resumable("gros", [0.1, 0.3], range(4), chunk_size=5,
                        state=st, **kw)
    _, st2 = sweep_resumable("gros", [0.1, 0.3], range(4), chunk_size=3,
                             stop_after=1, **kw)
    with pytest.raises(ValueError, match="resume state"):
        sweep_resumable("gros", [0.5, 0.9], range(4), chunk_size=3,
                        state=st2, **kw)


@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_sharded_equals_single_device(backend):
    """A chunk's rows split over two devices (two CPU shards here) in
    order, as the reference's pmap lays them out: per-run results equal
    the one-device grid; an odd chunk rounds up to a multiple of the
    device count, its pad rows dropped."""
    kw = dict(collect_traces=False, backend=backend, total_work=300.0,
              max_time=256.0, device="cpu")
    one = sweep("gros", [0.1, 0.3], range(4), **kw)
    for chunk in (4, 3):
        sh = sweep("gros", [0.1, 0.3], range(4), chunk_size=chunk,
                   devices=("cpu", "cpu"), **kw)
        np.testing.assert_array_equal(one.exec_time, sh.exec_time)
        np.testing.assert_array_equal(one.summary["progress_hist"],
                                      sh.summary["progress_hist"])
    _, st = sweep_resumable("gros", [0.1, 0.3], range(4), chunk_size=3,
                            devices=("cpu", "cpu"), stop_after=1, **kw)
    assert st.chunk == 4


def test_resolve_devices():
    cpu = torch.device("cpu")
    assert executor.resolve_devices(None, "cpu") == (cpu,)
    assert executor.resolve_devices(1, "cpu") == (cpu,)
    assert executor.resolve_devices(["cpu", cpu]) == (cpu, cpu)
    n = torch.cuda.device_count() + 2
    with pytest.raises(ValueError, match=f"asked for {n} devices"):
        executor.resolve_devices(n, "cpu")
    with pytest.raises(ValueError, match="names no device"):
        executor.resolve_devices([])


def _toy(b, c):
    return {"y": b["x"] * c}


def test_run_grid_consume_and_stop_semantics():
    """consume streams chunks in order and nothing is retained;
    stop_after leaves a resumable state whose buffers fill
    incrementally."""
    x = np.arange(10, dtype=np.float32)
    seen = []
    merged, st = executor.run_grid(
        _toy, {"x": x}, (2.0,), 10, chunk_size=4, device="cpu",
        consume=lambda lo, hi, out: seen.append((lo, hi, out["y"])))
    assert merged is None and st.complete and st.buffers is None
    assert [(lo, hi) for lo, hi, _ in seen] == [(0, 4), (4, 8), (8, 10)]
    np.testing.assert_array_equal(np.concatenate([y for *_, y in seen]),
                                  2.0 * x)
    merged, st = executor.run_grid(_toy, {"x": x}, (3.0,), 10,
                                   chunk_size=4, stop_after=2, device="cpu")
    assert merged is None and st.done.tolist() == [True, True, False]
    merged, st = executor.run_grid(_toy, {"x": x}, (3.0,), 10,
                                   chunk_size=4, state=st, device="cpu")
    np.testing.assert_array_equal(merged["y"], 3.0 * x)


def test_run_grid_keeps_trees_dtypes_and_owned_storage():
    """Nested outputs (dicts, NamedTuples, None leaves; bool, int32 and
    float32) come back in run order with their dtypes, padded rows
    dropped; arrays handed to consume own their storage."""
    from repro_torch.core.plant import PlantState

    def fn(b, c):
        x = b["x"]
        return {"s": PlantState(x * c, x > 4, x.to(torch.int32), None),
                "n": None}

    x = np.arange(11, dtype=np.float32)
    merged, _ = executor.run_grid(fn, {"x": x}, (0.5,), 11, chunk_size=4,
                                  device="cpu")
    s = merged["s"]
    assert merged["n"] is None and s.work is None
    np.testing.assert_array_equal(s.progress_l, 0.5 * x)
    assert s.dropped.dtype == np.bool_ and s.energy.dtype == np.int32
    np.testing.assert_array_equal(s.dropped, x > 4)
    got = []
    executor.run_grid(fn, {"x": x}, (0.5,), 11, chunk_size=4, device="cpu",
                      consume=lambda lo, hi, out: got.append(out["s"]))
    assert all(o.progress_l.flags.owndata for o in got)


@pytest.mark.parametrize("consume", [False, True])
def test_run_grid_frees_each_chunk_before_the_next(consume):
    """With donate=True a chunk's input and output tensors are gone,
    without the cyclic collector, by the time the next chunk computes:
    device memory stays at one chunk's, whatever the chunk count."""
    import gc
    import weakref

    seen = []

    def fn(b, c):
        out = {"y": b["x"] * c, "z": (b["x"] + 1.0, b["n"])}
        for r in seen:
            assert r() is None, "an earlier chunk's tensor is still alive"
        seen.clear()
        seen.extend(weakref.ref(t) for t in (b["x"], b["n"], out["y"],
                                             out["z"][0]))
        return out

    x = np.arange(40, dtype=np.float32)
    n = np.arange(40, dtype=np.int64)
    got = []
    enabled = gc.isenabled()
    gc.disable()
    try:
        merged, st = executor.run_grid(
            fn, {"x": x, "n": n}, (2.0,), 40, chunk_size=8, device="cpu",
            consume=((lambda lo, hi, out: got.append(out["y"])) if consume
                     else None))
    finally:
        if enabled:
            gc.enable()
    assert st.complete
    y = np.concatenate(got) if consume else merged["y"]
    np.testing.assert_array_equal(y, 2.0 * x)


def test_run_grid_publishes_counters_and_spans():
    """Twin of the reference's `test_obs.py` executor wiring test."""
    reg = obs_metrics.get_registry()
    chunks = reg.counter("executor_chunks_total", "grid chunks executed")
    before = chunks.value()
    tracer = obs_trace.get_tracer()
    tracer.clear()
    obs_trace.enable(True)
    try:
        out, _ = executor.run_grid(
            lambda b: {"y": b["x"] * 2.0},
            {"x": np.arange(10.0, dtype=np.float32)}, (), 10, chunk_size=4,
            device="cpu")
    finally:
        obs_trace.enable(False)
    np.testing.assert_array_equal(out["y"], np.arange(10.0) * 2.0)
    assert chunks.value() - before == 3
    names = {e["name"] for e in tracer.events()}
    assert {"executor/prepare", "executor/compute", "executor/transfer",
            "executor/merge"} <= names
    compute = [e for e in tracer.events()
               if e["name"] == "executor/compute"]
    assert compute[0]["args"]["cold"] is True
    assert compute[1]["args"]["cold"] is False
    assert compute[0]["args"]["devices"] == ["cpu"]
    tracer.clear()


def test_harvest_dataset_streams_chunks_exactly():
    eps = [0.1, 0.2]
    kw = dict(total_work=300.0, max_time=256.0, device="cpu")
    hd = harvest_dataset(["gros", "dahu"], eps, range(2), chunk_size=3,
                         backend="scan", **kw)
    parts = []
    for p in ("gros", "dahu"):
        for e in eps:
            r = sweep(p, [e], range(2), backend="scan", **kw)
            parts.append(build_dataset(r.traces, PROFILES[p], e))
    for k in ("s", "a", "r", "s2"):
        np.testing.assert_array_equal(
            hd[k], np.concatenate([d[k] for d in parts]), err_msg=k)
    assert len(hd["s"]) > 50


def test_chunked_100k_run_summary_grid_bounded_memory():
    """The reference's acceptance-scale grid: 100,000 summary-mode runs
    complete through bounded chunks (no batch beyond the chunk exists,
    by the chunk accounting) with the paper's trade-off."""
    n_seeds, eps = 20000, [0.0, 0.05, 0.1, 0.15, 0.3]
    chunk = 8192
    res, st = sweep_resumable(
        "gros", eps, range(n_seeds), total_work=1200.0, max_time=200.0,
        collect_traces=False, summary_warmup=20, chunk_size=chunk,
        device="cpu")
    assert st.complete
    assert st.n_chunks == -(-len(eps) * n_seeds // chunk)
    assert st.chunk == chunk
    assert res.exec_time.shape == (len(eps), n_seeds)
    assert bool(res.completed.all())
    e = res.energy.mean(-1)
    t = res.exec_time.mean(-1)
    assert e[-1] < e[0] and t[-1] > t[0]


def test_consume_raise_leaves_state_resumable_bit_identical():
    """A consume callback that raises mid-grid leaves the ExecState
    exactly as a clean stop at the same boundary; resuming with a working
    consume replays the failed chunk and the rest."""
    x = np.arange(10, dtype=np.float32)
    shared = (2.0,)
    _, st_clean = executor.run_grid(_toy, {"x": x}, shared, 10,
                                    chunk_size=4, device="cpu",
                                    consume=lambda *a: None, stop_after=1)

    def bomb(lo, hi, out):
        if lo >= 4:
            raise RuntimeError("downstream sink went away")

    st = executor.run_grid(_toy, {"x": x}, shared, 10, chunk_size=4,
                           stop_after=0, device="cpu")[1]
    with pytest.raises(RuntimeError, match="sink went away"):
        executor.run_grid(_toy, {"x": x}, shared, 10, chunk_size=4,
                          consume=bomb, state=st, device="cpu")
    assert st.done.tolist() == st_clean.done.tolist() == [True, False,
                                                          False]
    assert (st.n_runs, st.chunk, st.fingerprint) == (
        st_clean.n_runs, st_clean.chunk, st_clean.fingerprint)
    assert st.buffers is None and st_clean.buffers is None
    seen = []
    merged, st2 = executor.run_grid(
        _toy, {"x": x}, shared, 10, chunk_size=4, device="cpu",
        consume=lambda lo, hi, out: seen.append((lo, hi, out["y"])),
        state=st)
    assert merged is None and st2.complete
    assert [(lo, hi) for lo, hi, _ in seen] == [(4, 8), (8, 10)]
    np.testing.assert_array_equal(np.concatenate([y for *_, y in seen]),
                                  2.0 * x[4:])


def test_digest_guards_content():
    a = {"x": np.arange(4, dtype=np.float32)}
    assert executor.digest(a, (1.0,)) == executor.digest(
        {"x": torch.arange(4, dtype=torch.float32)}, (1.0,))
    assert executor.digest(a, (1.0,)) != executor.digest(a, (2.0,))
    assert executor.digest(a) != executor.digest(
        {"x": np.arange(4, dtype=np.float64)})
