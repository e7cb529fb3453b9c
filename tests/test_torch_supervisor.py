"""The port's durable campaign supervisor (`repro_torch.core.supervisor`)
and the retry ladder it rides on, on the CPU: twins of the reference's
`tests/test_supervisor.py` (its three HTTP push-sink tests are mirrored
in `tests/test_torch_obs_serve.py`, its fleet campaign in
`tests/test_torch_hierarchy.py`).

The property, inherited from the executor: every run's parameters and
random streams ride in its own row, so a campaign that was retried,
timed out, quarantined, halted, killed -9 and resumed produces results
bit for bit identical to one uninterrupted `run_grid` call. The kill
tests start a fresh interpreter (never a fork of a process holding a
CUDA context).
"""
import json
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import executor, supervisor  # noqa: E402
from repro_torch.obs import events as evt  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs.retry import RetryPolicy, call_with_retries  # noqa: E402

N = 20
CHUNK = 4
CPU = dict(device="cpu")
FAST = RetryPolicy(max_retries=3, base_s=0.001, max_s=0.01)


def _toy(b, c):
    return {"y": b["x"] * c, "z": b["x"] + 1.0}


def _grid(n=N):
    return {"x": np.arange(n, dtype=np.float32)}, (2.0,)


def _reference(n=N, chunk=CHUNK):
    batched, shared = _grid(n)
    merged, _ = executor.run_grid(_toy, batched, shared, n,
                                  chunk_size=chunk, **CPU)
    return merged


def _assert_identical(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _durable(fn, tmp_path, **kw):
    batched, shared = _grid()
    return supervisor.run_durable(fn, batched, shared, N, dir=tmp_path,
                                  chunk_size=CHUNK, **CPU, **kw)


# ---------------------------------------------------------------- retry
def test_retry_policy_backoff_ladder():
    p = RetryPolicy(max_retries=5, base_s=0.1, factor=2.0, max_s=0.5,
                    jitter=0.25)
    assert [p.backoff_s(a) for a in range(4)] == [0.1, 0.2, 0.4, 0.5]
    import random
    rng = random.Random(0)
    for a in range(4):
        d = p.backoff_s(a, rng)
        base = min(0.1 * 2.0 ** a, 0.5)
        assert 0.75 * base <= d <= 1.25 * base


def test_call_with_retries_budget_and_hook():
    calls, seen = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    out = call_with_retries(flaky, RetryPolicy(max_retries=3, base_s=0.0),
                            on_retry=lambda a, d, e: seen.append(a),
                            sleep=lambda s: None)
    assert out == "ok" and len(calls) == 3 and seen == [0, 1]
    with pytest.raises(ValueError):
        call_with_retries(lambda: (_ for _ in ()).throw(ValueError("x")),
                          RetryPolicy(max_retries=2, base_s=0.0),
                          sleep=lambda s: None)


def test_classify_failure_rungs():
    """The reference's rungs, and the CUDA runtime's own errors: an
    allocation failure is transient; a sticky error (it poisons the
    process's CUDA context) is a device failure."""
    cf = supervisor.classify_failure
    assert cf(supervisor.DeviceLost(1)) == "device"
    assert cf(supervisor.ChunkTimeout("t")) == "timeout"
    assert cf(supervisor.TransientFault("f")) == "transient"
    assert cf(MemoryError()) == "transient"
    assert cf(RuntimeError("RESOURCE_EXHAUSTED: out of memory")) \
        == "transient"
    assert cf(RuntimeError("device lost mid-collective")) == "device"
    assert cf(ValueError("shapes do not match")) == "permanent"
    assert cf(torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                     "allocate 2.00 GiB")) == "transient"
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: unspecified launch failure",
                "CUDA error: device-side assert triggered"):
        assert cf(RuntimeError(msg)) == "device", msg


# -------------------------------------------------------------- journal
def test_journal_roundtrip_and_torn_tail(tmp_path):
    p = tmp_path / "j.jsonl"
    j = supervisor.Journal(p)
    recs = [{"k": "plan", "fp": "a"}, {"k": "commit", "ci": 0},
            {"k": "commit", "ci": 1}]
    for r in recs:
        j.append(r)
    j.close()
    got, torn = supervisor.read_journal(p)
    assert got == recs and torn == 0
    raw = p.read_bytes()
    p.write_bytes(raw[:-9])
    got, torn = supervisor.read_journal(p)
    assert got == recs[:2] and torn == 1
    lines = raw.decode().splitlines()
    lines[1] = lines[1][:-4] + 'xx"}'
    p.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="corrupt"):
        supervisor.read_journal(p)


def test_durable_matches_bare_run_grid(tmp_path):
    merged, report = _durable(_toy, tmp_path)
    _assert_identical(merged, _reference())
    assert report.n_chunks == 5 and report.committed == 5
    assert not report.dead and not report.resumed and report.retries == 0
    recs, torn = supervisor.read_journal(tmp_path / supervisor.JOURNAL_NAME)
    kinds = [r["k"] for r in recs]
    assert kinds[0] == "plan" and kinds[-1] == "done" and torn == 0
    assert kinds.count("commit") == 5 and kinds.count("start") == 5
    assert recs[0]["devices"] == ["cpu"]
    assert (tmp_path / supervisor.CHECKPOINT_NAME).exists()


def test_transient_faults_retry_to_identical_completion(tmp_path):
    flaky = supervisor.FlakyGridFn(
        _toy, failures={0: supervisor.TransientFault("injected"),
                        3: torch.OutOfMemoryError("CUDA out of memory")})
    merged, report = _durable(flaky, tmp_path,
                              config=supervisor.CampaignConfig(retry=FAST))
    _assert_identical(merged, _reference())
    assert report.retries == 2 and not report.dead
    recs, _ = supervisor.read_journal(tmp_path / supervisor.JOURNAL_NAME)
    assert {r["reason"] for r in recs if r["k"] == "retry"} == {"transient"}


def test_permanent_failure_dead_letters_and_campaign_continues(tmp_path):
    flaky = supervisor.FlakyGridFn(_toy, failures={1: ValueError("bad")})
    merged, report = _durable(flaky, tmp_path)
    assert [ci for ci, _ in report.dead] == [1]
    assert "bad" in report.dead[0][1]
    ref = _reference()
    for k in ref:
        np.testing.assert_array_equal(merged[k][:CHUNK], ref[k][:CHUNK])
        np.testing.assert_array_equal(merged[k][2 * CHUNK:],
                                      ref[k][2 * CHUNK:])


def test_retry_budget_exhaustion_dead_letters(tmp_path):
    fails = {i: supervisor.TransientFault(f"attempt {i}") for i in range(3)}
    cfg = supervisor.CampaignConfig(
        retry=RetryPolicy(max_retries=2, base_s=0.001, max_s=0.01))
    _, report = _durable(supervisor.FlakyGridFn(_toy, failures=fails),
                         tmp_path, config=cfg)
    assert [ci for ci, _ in report.dead] == [0]
    assert report.retries == 2


def test_watchdog_timeout_retries_bit_identical(tmp_path):
    """A timed-out attempt's zombie thread finishes on its own and writes
    the same rows the retry writes."""
    flaky = supervisor.FlakyGridFn(_toy, delays={0: 2.0})
    cfg = supervisor.CampaignConfig(chunk_timeout_s=0.25, retry=FAST)
    merged, report = _durable(flaky, tmp_path, config=cfg)
    _assert_identical(merged, _reference())
    assert report.retries >= 1 and not report.dead
    recs, _ = supervisor.read_journal(tmp_path / supervisor.JOURNAL_NAME)
    assert any(r["k"] == "retry" and r["reason"] == "timeout"
               for r in recs)


def test_fingerprint_mismatch_rejected(tmp_path):
    _durable(_toy, tmp_path)
    other = {"x": np.arange(N, dtype=np.float32) + 1.0}
    with pytest.raises(ValueError, match="planned for grid"):
        supervisor.run_durable(_toy, other, (2.0,), N, dir=tmp_path,
                               chunk_size=CHUNK, **CPU)


def test_resume_finished_campaign_returns_checkpoint(tmp_path):
    _durable(_toy, tmp_path)
    flaky = supervisor.FlakyGridFn(_toy)  # counts calls
    merged, report = _durable(flaky, tmp_path)
    _assert_identical(merged, _reference())
    assert report.resumed and report.committed == 0
    assert flaky.calls == 0  # nothing recomputed: checkpoint was final


def test_torn_tail_replays_chunk_bit_identical(tmp_path):
    _durable(_toy, tmp_path)
    jpath = tmp_path / supervisor.JOURNAL_NAME
    jpath.write_bytes(jpath.read_bytes()[:-10])  # tear the last record
    (tmp_path / supervisor.CHECKPOINT_NAME).unlink()
    merged, report = _durable(_toy, tmp_path)
    _assert_identical(merged, _reference())
    assert report.resumed and report.torn_records == 1
    assert report.replayed >= 1


def test_consume_mode_journal_is_authoritative(tmp_path):
    first, second = [], []
    _durable(_toy, tmp_path,
             consume=lambda lo, hi, out: first.append((lo, hi)))
    assert first == [(0, 4), (4, 8), (8, 12), (12, 16), (16, 20)]
    merged, report = _durable(
        _toy, tmp_path, consume=lambda lo, hi, out: second.append((lo, hi)))
    assert merged is None and report.resumed and second == []


def test_campaign_events_stream_to_disk(tmp_path):
    flaky = supervisor.FlakyGridFn(
        _toy, failures={0: supervisor.TransientFault("x")})
    _durable(flaky, tmp_path, config=supervisor.CampaignConfig(retry=FAST))
    rows = [json.loads(ln) for ln in
            (tmp_path / supervisor.EVENTS_NAME).read_text().splitlines()]
    assert any(int(r["code"]) == evt.EV_CHUNK_RETRY for r in rows)
    assert all(int(r["source"]) == evt.SRC_SUPERVISOR for r in rows)


def test_supervisor_metrics_published(tmp_path):
    flaky = supervisor.FlakyGridFn(
        _toy, failures={0: supervisor.TransientFault("x"),
                        2: ValueError("perm")})
    reg = obs_metrics.get_registry()
    retries = reg.counter("supervisor_retries_total",
                          labelnames=("reason",))
    before = retries.value(reason="transient")
    _durable(flaky, tmp_path, config=supervisor.CampaignConfig(retry=FAST))
    assert retries.value(reason="transient") == before + 1
    snap = reg.snapshot()["metrics"]
    assert "supervisor_dead_letter_total" in snap
    assert "supervisor_backoff_seconds" in snap
    assert "supervisor_faults_injected_total" in snap


def test_sticky_device_error_halts_then_fresh_resume_finishes(tmp_path):
    """A sticky CUDA error with no other device to fall back to stops the
    campaign (retrying in the poisoned context would fail every chunk):
    journal and checkpoint stay intact, and a later call (a fresh
    process, in practice) finishes it bit for bit, replaying nothing
    that was committed."""
    flaky = supervisor.FlakyGridFn(_toy, failures={2: RuntimeError(
        "CUDA error: an illegal memory access was encountered")})
    with pytest.raises(supervisor.CampaignHalted, match="fresh process"):
        _durable(flaky, tmp_path, config=supervisor.CampaignConfig(
            retry=FAST, checkpoint_every=1))
    recs, torn = supervisor.read_journal(tmp_path / supervisor.JOURNAL_NAME)
    kinds = [r["k"] for r in recs]
    assert kinds.count("commit") == 2 and kinds[-1] == "halt" and not torn
    assert "retry" not in kinds and "dead" not in kinds
    counted = supervisor.FlakyGridFn(_toy)
    merged, report = _durable(counted, tmp_path)
    _assert_identical(merged, _reference())
    assert report.resumed and report.replayed == 0 and not report.dead
    assert counted.calls == 3


# --------------------------------------------------------- crash safety
def _sub_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src")
    return env


_CHILD_TOY = """
import numpy as np
from repro_torch.core import supervisor
x = np.arange(24, dtype=np.float32)
def toy(b, c):
    return {{"y": b["x"] * c, "z": b["x"] + 1.0}}
cfg = supervisor.CampaignConfig(checkpoint_every=2, kill_after_commits=3,
                                kill_signal={sig})
supervisor.run_durable(toy, {{"x": x}}, (2.0,), 24, dir={dir!r},
                       chunk_size=4, config=cfg, device="cpu")
print("SURVIVED_KILL")
"""


@pytest.mark.parametrize("sig", [signal.SIGKILL, signal.SIGTERM],
                         ids=["kill9", "sigterm"])
def test_kill_mid_campaign_then_resume_bit_identical(tmp_path, sig):
    """kill -9 (and SIGTERM) right after an fsync'd commit; the reopened
    campaign replays exactly the uncommitted chunks and the merge equals
    the uninterrupted run bit for bit."""
    code = _CHILD_TOY.format(sig=int(sig), dir=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=_sub_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == -int(sig), out.stdout + out.stderr
    assert "SURVIVED_KILL" not in out.stdout
    x = np.arange(24, dtype=np.float32)
    ref, _ = executor.run_grid(_toy, {"x": x}, (2.0,), 24, chunk_size=4,
                               **CPU)
    merged, report = supervisor.run_durable(_toy, {"x": x}, (2.0,), 24,
                                            dir=tmp_path, chunk_size=4,
                                            **CPU)
    _assert_identical(merged, ref)
    assert report.resumed and not report.dead
    # killed after commit 3 with checkpoint cadence 2: one commit was
    # journaled but not snapshotted, so it is recomputed
    assert report.replayed == 1


def test_quarantine_and_reinstate_two_devices(tmp_path):
    """DeviceLost quarantines the named shard, the campaign degrades to
    the surviving device, probes the lost one back in after clean
    commits, and still merges bit-identically (two CPU shards)."""
    x = np.arange(24, dtype=np.float32)
    batched, shared = {"x": x}, (2.0,)
    ref, _ = executor.run_grid(_toy, batched, shared, 24, chunk_size=4,
                               **CPU)
    flaky = supervisor.FlakyGridFn(
        _toy, failures={2: supervisor.DeviceLost(device_id=1)})
    cfg = supervisor.CampaignConfig(probe_after=2, retry=FAST)
    merged, report = supervisor.run_durable(
        flaky, batched, shared, 24, dir=tmp_path, chunk_size=4,
        devices=("cpu", "cpu"), config=cfg)
    _assert_identical(merged, ref)
    assert report.reinstated == [1] and report.quarantined == []
    assert not report.dead and report.retries == 1
    recs, _ = supervisor.read_journal(tmp_path / supervisor.JOURNAL_NAME)
    kinds = [r["k"] for r in recs]
    assert "quarantine" in kinds and "reinstate" in kinds


# ------------------------------------------------------- sweep / harvest
SWEEP_KW = dict(total_work=300.0, max_time=256.0, collect_traces=False)


@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_sweep_durable_matches_plain_and_resumes(tmp_path, backend):
    from repro_torch.core.sim import sweep
    one = sweep("gros", [0.1, 0.3], range(4), backend=backend, **SWEEP_KW,
                **CPU)
    dur = sweep("gros", [0.1, 0.3], range(4), chunk_size=3,
                durable=tmp_path, backend=backend, **SWEEP_KW, **CPU)
    for k in ("exec_time", "energy"):
        np.testing.assert_array_equal(getattr(one, k), getattr(dur, k))
    np.testing.assert_array_equal(one.summary["progress_hist"],
                                  dur.summary["progress_hist"])
    res = supervisor.resume_campaign(tmp_path)
    np.testing.assert_array_equal(one.exec_time, res.exec_time)


def test_sweep_kill9_then_resume_campaign_bit_identical(tmp_path):
    """A durable sweep killed -9 mid-campaign, then `resume_campaign(dir)`
    alone (the spec carries everything, the device as a string)
    reproduces the uninterrupted SweepResult bit for bit."""
    code = f"""
from repro_torch.core.sim import sweep
from repro_torch.core.supervisor import CampaignConfig
sweep("gros", [0.1, 0.3], range(6), total_work=300.0, max_time=256.0,
      collect_traces=False, chunk_size=3, durable={str(tmp_path)!r},
      campaign=CampaignConfig(checkpoint_every=1, kill_after_commits=2),
      device="cpu")
print("SURVIVED_KILL")
"""
    out = subprocess.run([sys.executable, "-c", code], env=_sub_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == -int(signal.SIGKILL), out.stdout + out.stderr
    res = supervisor.resume_campaign(tmp_path)
    from repro_torch.core.sim import sweep
    one = sweep("gros", [0.1, 0.3], range(6), **SWEEP_KW, **CPU)
    np.testing.assert_array_equal(one.exec_time, res.exec_time)
    np.testing.assert_array_equal(one.energy, res.energy)
    for k in ("progress_mean", "power_mean", "progress_hist"):
        np.testing.assert_array_equal(one.summary[k], res.summary[k],
                                      err_msg=k)
    with open(Path(tmp_path) / supervisor.SPEC_NAME, "rb") as fh:
        spec = pickle.load(fh)
    assert spec["kwargs"]["campaign"].kill_after_commits is None
    assert spec["kwargs"]["device"] == "cpu"


def test_campaign_spec_holds_devices_as_strings(tmp_path):
    supervisor.save_campaign_spec(tmp_path, "sweep", dict(
        device=torch.device("cpu"), devices=(torch.device("cpu"), "cpu")))
    with open(Path(tmp_path) / supervisor.SPEC_NAME, "rb") as fh:
        kw = pickle.load(fh)["kwargs"]
    assert kw["device"] == "cpu" and kw["devices"] == ["cpu", "cpu"]


def test_harvest_dataset_durable_spools_parts(tmp_path):
    from repro_torch.core.policies.offline_rl import harvest_dataset
    kw = dict(total_work=300.0, max_time=256.0, chunk_size=1, **CPU)
    plain = harvest_dataset("gros", [0.1], range(2), **kw)
    dur = harvest_dataset("gros", [0.1], range(2), durable=tmp_path, **kw)
    for k in ("s", "a", "r", "s2"):
        np.testing.assert_array_equal(plain[k], dur[k], err_msg=k)
    assert len(sorted((Path(tmp_path) / "parts").glob("part_*.npz"))) == 2
    again = supervisor.resume_campaign(tmp_path)
    for k in ("s", "a", "r", "s2"):
        np.testing.assert_array_equal(plain[k], again[k], err_msg=k)


def test_resume_campaign_requires_spec(tmp_path):
    with pytest.raises(FileNotFoundError, match="campaign spec"):
        supervisor.resume_campaign(tmp_path)
