"""The port's steps on a mesh of gloo CPU ranks against the one-rank
port and the JAX package: the sharding layer computes what the
unsharded model computes.

Each case spawns its ranks once (`tests/_torch_mesh_ranks.py`; about 5 s
a spawn) and compares rank 0's whole tensors here.

Tolerances, and why:
- Sharded against one-rank logits: 1e-5 of the logits' scale (max |x|),
  absolute. The partial-sum all-reduces of tensor parallelism add a few
  float32 sums in another order; greedy tokens exactly equal.
- Against the reference's forward on the same weights: 1e-5 absolute,
  the bar of `tests/test_torch_models.py`.
- The sharded train step against the one-rank step: the bars of
  `tests/test_torch_train.py` (loss and grad norm 1e-5 relative, lr and
  step exact, moments m 1e-5 / v 1e-4 relative, params 2e-6 absolute
  where |g| >= 1e-6 and within 2.2 lr elsewhere). The microbatches hold
  other rows when the batch is split over ranks; their mean is the same
  up to the order of float32 sums.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if not torch.distributed.is_available() or \
        not torch.distributed.is_gloo_available():
    pytest.skip("no gloo backend in this torch build",
                allow_module_level=True)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_mesh_ranks as R  # noqa: E402

from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import (materialize,  # noqa: E402
                                       tree_leaves_with_path)
from repro_torch.optim.adamw import adamw_init_defs  # noqa: E402


_SPAWNED = {}


def _spawn(name, tmp_path):
    """Rank 0's results of scenario ``name``; a scenario spawns once per
    test session (qwen3_tp serves two tests)."""
    if name in _SPAWNED:
        return _SPAWNED[name]
    out = tmp_path / f"{name}.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "_torch_mesh_ranks.py"),
                           name, str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    _SPAWNED[name] = dict(np.load(out))
    return _SPAWNED[name]


def _scale_close(a, b):
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-5 * float(np.abs(b).max()))


def _reference_prefill(cfg, params, toks):
    """The reference's prefill logits on the port's weights."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jcfg
    from repro.models import ApplyOptions as JOpts
    from repro.models import prefill as jprefill
    arch = R.SCENARIOS[[k for k, v in R.SCENARIOS.items()
                        if v[0] + "-smoke" == cfg.name][0]][0]
    jc = dataclasses.replace(jcfg.reduced(jcfg.get_config(arch)),
                             sharding_recipe=cfg.sharding_recipe)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    logits, _ = jprefill(jc, JOpts(attn_impl="reference"), jp,
                         {"tokens": jnp.asarray(toks.numpy(), jnp.int32)})
    return np.asarray(logits)


@pytest.mark.parametrize("name", ["qwen3_tp", "jamba_tp"])
def test_sharded_serving_matches_one_rank_and_reference(name, tmp_path):
    """Prefill (and for qwen3-8b four greedy decode steps) under ``tp`` on
    (1, 2) gloo ranks, the kernels' plain versions under local_map,
    against the one-rank port and the reference's prefill."""
    got = _spawn(name, tmp_path)
    cfg = R.scenario_cfg(name)
    params = init_params(cfg, 0, "cpu")
    want = R.serve_greedy(cfg, params, None,
                          gen=R.GEN if name == "qwen3_tp" else 0)
    _scale_close(got["prefill"], want["prefill"])
    if name == "qwen3_tp":
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        _scale_close(got["decode"], want["decode"])
    ref = _reference_prefill(cfg, params, R.prompts(cfg))
    np.testing.assert_allclose(got["prefill"], ref, atol=1e-5, rtol=1e-5)


def _held(path, a, b, atol, rtol):
    bad = ~np.isclose(a, b, atol=atol, rtol=rtol)
    assert not bad.any(), (f"{path}: {bad.sum()} of {bad.size} off, worst "
                           f"{np.abs(a - b).max():.3e}")


def test_sharded_train_step_matches_one_rank(tmp_path):
    """One `make_step` train step of a reduced starcoder2-3b under
    ``fsdp_tp`` with ZeRO-1 and two microbatches on (2, 2) gloo ranks
    against the one-rank `make_train_step` from the same state."""
    got = _spawn("starcoder2_train", tmp_path)
    cfg = R.scenario_cfg("starcoder2_train")
    tcfg = TrainConfig(**R.TRAIN_KW)
    params = init_params(cfg, 1, "cpu")
    opt = materialize(adamw_init_defs(M.model_defs(cfg)), 1, torch.float32,
                      "cpu")
    step = make_train_step(cfg, tcfg, R.OPTS)
    _, _, metrics = step(params, opt, R.train_batch(cfg))
    for k in ("loss", "grad_norm", "ce"):
        np.testing.assert_allclose(got[f"metric/{k}"], float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(got["metric/lr"]) == float(metrics["lr"])
    assert int(got["step"]) == int(opt["step"]) == 1
    for pre, tree, tol in (("m", opt["m"], dict(atol=1e-9, rtol=1e-5)),
                           ("v", opt["v"], dict(atol=1e-12, rtol=1e-4))):
        for path, t in tree_leaves_with_path(tree):
            _held(pre + path, got[pre + path], t.numpy(), **tol)
    lr = tcfg.learning_rate
    for (path, t), (_, m) in zip(tree_leaves_with_path(params),
                                 tree_leaves_with_path(opt["m"])):
        a, b = got["p" + path], t.numpy()
        tight = np.abs(m.numpy()) / 0.1 >= 1e-6
        _held("p" + path, a[tight], b[tight], atol=2e-6, rtol=0)
        assert np.abs(a - b).max() <= 2.2 * lr, path


def test_entry_points_on_two_ranks_match_one_rank(tmp_path):
    """`serve.main` and `train.main` as under ``torchrun``: on the (1, 2)
    gloo group the host mesh spans both ranks and the weights are
    DTensors; train checkpoints them (gathered whole, rank 0 writes) and
    a second call resumes from the checkpoint. Tokens, losses and the
    last checkpoint against the same calls on one rank, at the train
    step's bars above (params within 2.2 lr an update where |m| is
    tiny); the entry points leave the caller's group up, and destroy the
    one-rank group they start themselves."""
    got = _spawn("qwen3_tp", tmp_path)
    want = R.entry_points(tmp_path / "one_rank")
    assert not torch.distributed.is_initialized()
    want.update(R.checkpoint_arrays(tmp_path / "one_rank"))
    assert str(got["entry/mesh"]) == "data=1 x model=2 on cpu"
    assert str(want["entry/mesh"]) == "data=1 x model=1 on cpu"
    assert bool(got["entry/group_kept"])
    assert (got["entry/dtensor_leaves"] > 0).all()
    assert (want["entry/dtensor_leaves"] == 0).all()
    np.testing.assert_array_equal(got["entry/tokens"], want["entry/tokens"])
    np.testing.assert_allclose(got["entry/losses"], want["entry/losses"],
                               rtol=1e-5)
    ckpt = sorted(k for k in want if k.startswith("ckpt/"))
    assert sorted(k for k in got if k.startswith("ckpt/")) == ckpt
    updates = int(want["ckpt/['opt']['step']"])
    assert updates == R.ENTRY_STEPS + 1
    for k in ckpt:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif k.startswith("ckpt/['opt']['m']"):
            _held(k, a, b, atol=1e-9, rtol=1e-5)
        elif k.startswith("ckpt/['opt']['v']"):
            _held(k, a, b, atol=1e-12, rtol=1e-4)
        else:
            m = want[k.replace("['params']", "['opt']['m']")]
            tight = np.abs(m) / 0.1 >= 1e-6
            _held(k, a[tight], b[tight], atol=2e-6, rtol=0)
            assert np.abs(a - b).max() <= 2.2 * R.ENTRY_LR * updates, k
