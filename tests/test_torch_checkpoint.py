"""The port's checkpoint manager and data pipeline: `tests/test_checkpoint.py`
on the port, a checkpoint written by the reference's `CheckpointManager`
(bf16 leaves included) restored key for key and bit for bit, and the
synthetic LM batches equal to the reference's. Everything is compared
exactly: files and numpy generators hold the same bits."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data.pipeline import SyntheticLMDataset as JData  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import (SyntheticLMDataset,  # noqa: E402
                                       TokenIterator)
from repro_torch.models.layers import tree_leaves_with_path  # noqa: E402


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g),
                   "b": torch.zeros((16,)),
                   "h": torch.randn((4, 3), generator=g).to(torch.bfloat16)},
        "opt": {"m": torch.ones((8, 16)),
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _equal(a, b):
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py on the port
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree(0)
    mgr.save(10, tree, extra={"data": {"step": 10, "seed": 0}})
    restored, extra = mgr.restore(template=tree)
    _equal(restored, tree)
    assert extra["data"]["step"] == 10


def test_keep_gc_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _tree(1)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save_then_restore(tmp_path):
    """The async save copies the tensors before it returns: an in-place
    update right after (as the train step makes) does not reach the
    file."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    tree = _tree(2)
    want = tree["params"]["w"].clone()
    mgr.save(5, tree)
    tree["params"]["w"].add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore(template=tree)
    assert torch.equal(restored["params"]["w"], want)


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree(3)
    mgr.save(1, tree)
    bad = {"params": {"w": torch.zeros((4, 4)), "b": torch.zeros((16,)),
                      "h": tree["params"]["h"]},
           "opt": tree["opt"]}
    with pytest.raises(ValueError):
        mgr.restore(template=bad)


def test_restore_onto_another_device(tmp_path):
    """The reference's elastic reshard on load, on one card: leaves land
    on the device asked for, else on their template's (on the CPU here;
    the card's own test is in tests/test_torch_cuda.py)."""
    mgr = CheckpointManager(tmp_path)
    tree = _tree(4)
    mgr.save(2, tree)
    restored, _ = mgr.restore(template=tree, device="cpu")
    assert restored["params"]["w"].device.type == "cpu"
    _equal(restored, tree)


def test_data_iterator_resume_exact():
    ds = SyntheticLMDataset(vocab_size=97, seq_len=16, global_batch=4,
                            seed=3)
    it = TokenIterator(ds, device="cpu")
    for _ in range(5):
        next(it)
    state = it.state_dict()
    after = [next(it)["tokens"] for _ in range(3)]
    it2 = TokenIterator(ds, device="cpu")
    it2.load_state_dict(state)
    again = [next(it2)["tokens"] for _ in range(3)]
    for a, b in zip(after, again):
        assert a.dtype == torch.int64 and torch.equal(a, b)


def test_atomic_no_partial_checkpoint(tmp_path):
    """A crash mid-save must never leave a readable-but-corrupt step dir."""
    mgr = CheckpointManager(tmp_path)
    tree = _tree(5)
    mgr.save(1, tree)
    # simulate a crashed writer: stray tmp dir must be ignored by restore
    (tmp_path / ".tmp_crashed").mkdir()
    (tmp_path / ".tmp_crashed" / "arrays.npz").write_bytes(b"garbage")
    assert mgr.all_steps() == [1]
    restored, _ = mgr.restore(template=tree)
    assert torch.equal(restored["opt"]["m"], tree["opt"]["m"])


# ---------------------------------------------------------------------------
# the reference's files and batches
# ---------------------------------------------------------------------------


def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    """A train-state checkpoint written by the reference (bf16 params at
    full dtype, fp32 moments, an int32 step, its JSON extra) restores in
    the port: every key, dtype and bit."""
    cfg = jreduced(jget("qwen3-8b"))
    import dataclasses
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    params = jinit(cfg, jax.random.PRNGKey(0))
    opt = {"m": jax.tree_util.tree_map(
        lambda a: jnp.full(a.shape, 0.5, jnp.float32), params),
        "step": jnp.int32(12)}
    tree = {"params": params, "opt": opt}
    extra = {"step": 13, "data": {"step": 13, "seed": 0}, "nrm": {}}
    JManager(tmp_path).save(12, tree, extra)
    keys = set(np.load(tmp_path / "step_000000012" / "arrays.npz").files)
    template = jax.tree_util.tree_map(
        lambda a: torch.zeros(a.shape, dtype=getattr(torch, str(a.dtype))),
        tree)
    got, got_extra = CheckpointManager(tmp_path).restore(template=template)
    assert got_extra == extra
    flat = tree_leaves_with_path(got)
    assert {p for p, _ in flat} == keys
    want = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    for path, t in flat:
        w = want[path]
        assert str(t.dtype).split(".")[-1] == str(w.dtype), path
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  w.view(np.int16)), path
        else:
            assert np.array_equal(t.numpy(), w), path
    # and the port's own file of the same tree keeps the reference's keys
    # and stores bf16 as the same raw 2-byte values
    CheckpointManager(tmp_path / "port").save(12, got, extra)
    with np.load(tmp_path / "port" / "step_000000012" / "arrays.npz") as z:
        assert set(z.files) == keys
        for path, w in want.items():
            if str(w.dtype) == "bfloat16":
                assert z[path].dtype.kind == "V"
                assert np.array_equal(z[path].view(np.int16),
                                      w.view(np.int16)), path
    meta = json.loads((tmp_path / "port" / "step_000000012" /
                       "meta.json").read_text())
    assert meta == {"step": 12, "extra": extra}


@pytest.mark.parametrize("embed_dim", [0, 24])
def test_synthetic_batches_equal_reference(embed_dim):
    kw = dict(vocab_size=257, seq_len=40, global_batch=6, seed=11,
              embed_dim=embed_dim)
    mine, ref = SyntheticLMDataset(**kw), JData(**kw)
    it = TokenIterator(mine, start_step=3, device="cpu")
    for step in (0, 1, 7, 1000):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    t = next(it)
    want = ref.batch_at(3)
    for k, v in t.items():
        assert np.array_equal(v.numpy(), want[k]), k
