"""The port's optimizer, lr schedule and int8 gradient compression:
`tests/test_optim.py` on the port, then parity with the reference on
the same inputs (numpy, seeded).

Tolerances: the schedule and the update are float32 formulas written as
the reference's, so lr within 1e-6 relative (XLA and PyTorch may round
cos in another ulp) and updated params and moments within 1e-6 (bf16
moments: one bf16 ulp, rtol 8e-3, as both round the same fp32 value);
the global norm 1e-6 relative (a float32 sum in another order). The
int8 compression is exact (the same round-half-even of the same fp32
quotient).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.optim.adamw import adamw_update as jadamw  # noqa: E402
from repro.optim.compression import compress_grads as jcompress  # noqa: E402
from repro.optim.schedule import lr_schedule as jlr  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.models.layers import ParamDef, materialize  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import (adamw_init_defs, adamw_update,  # noqa: E402
                                     global_norm)
from repro_torch.optim.compression import compress_grads, ef_init_defs  # noqa: E402
from repro_torch.optim.schedule import lr_schedule  # noqa: E402


def _opt(defs, moment_dtype="float32"):
    return materialize(adamw_init_defs(defs, moment_dtype), 0,
                       torch.float32, "cpu")


# ---------------------------------------------------------------------------
# tests/test_optim.py on the port
# ---------------------------------------------------------------------------


def test_adamw_minimizes_quadratic():
    tcfg = TrainConfig(learning_rate=0.1, weight_decay=0.0, grad_clip=0.0,
                       warmup_steps=1, total_steps=200)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = _opt({"w": ParamDef((3,), (None,))})
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        lr = lr_schedule(tcfg, opt["step"])
        params, opt, _ = adamw_update(tcfg, params, g, opt, lr)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.1)


def test_grad_clip_caps_update_norm():
    tcfg = TrainConfig(learning_rate=1.0, grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    opt = _opt({"w": ParamDef((4,), (None,))})
    g = {"w": torch.full((4,), 100.0)}  # norm 200 >> clip 1
    _, _, gnorm = adamw_update(tcfg, params, g, opt, torch.tensor(1.0))
    assert float(gnorm) == pytest.approx(200.0)


def test_moment_dtype_bf16():
    opt = _opt({"w": ParamDef((4, 4), (None, None))}, "bfloat16")
    assert opt["m"]["w"].dtype == torch.bfloat16


def test_schedule_warmup_and_decay():
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(tcfg, s)) for s in range(100)]
    assert lrs[0] == pytest.approx(1e-4, rel=1e-5)  # (0+1)/10 warmup
    assert max(lrs) == pytest.approx(1e-3, rel=1e-6)
    assert lrs[10] >= lrs[5]
    assert lrs[-1] < lrs[50] < lrs[10] + 1e-9
    # warmup 0 -> full lr immediately
    t0 = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=100)
    assert float(lr_schedule(t0, 0)) == pytest.approx(1e-3, rel=1e-6)


def test_int8_error_feedback_preserves_signal():
    """Compressed-gradient SGD with EF: accumulated quantization error
    stays bounded and the mean decompressed gradient matches the true
    gradient."""
    g_true = {"w": torch.from_numpy(np.random.default_rng(1).standard_normal(
        64).astype(np.float32))}
    ef = {"w": torch.zeros(64)}
    acc = torch.zeros(64)
    for _ in range(50):
        deq, ef = compress_grads(g_true, ef)
        acc = acc + deq["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g_true["w"].numpy(),
                               atol=0.02)
    assert float(ef["w"].abs().max()) < 0.1  # EF bounded


def test_ef_defs_match_param_tree():
    defs = {"a": ParamDef((2, 2), (None, None)),
            "b": {"c": ParamDef((3,), (None,))}}
    ef = ef_init_defs(defs)
    assert ef["b"]["c"].shape == (3,)
    assert ef["b"]["c"].dtype == "float32"


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 100), (5, 5)])
def test_lr_schedule_matches_reference(warmup, total):
    kw = dict(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    for s in (0, 1, 4, 5, 9, 10, 50, 99, 150):
        np.testing.assert_allclose(float(lr_schedule(TrainConfig(**kw), s)),
                                   float(jlr(JTrain(**kw), s)), rtol=1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_reference(moment_dtype, clip, monkeypatch):
    """Three AdamW steps on a tree with a stacked leaf, against the
    reference's `adamw_update`; the port's leaf pieces are made small so
    that the stacked leaf is updated slice by slice."""
    monkeypatch.setattr(adamw, "PIECE", 40)
    rng = np.random.default_rng(3)
    shapes = {"stack": (3, 4, 5), "vec": (7,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    kw = dict(learning_rate=1e-2, grad_clip=clip, weight_decay=0.1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jdt = jnp.dtype(moment_dtype)
    jo = {"m": {k: jnp.zeros(s, jdt) for k, s in shapes.items()},
          "v": {k: jnp.zeros(s, jdt) for k, s in shapes.items()},
          "step": jnp.int32(0)}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    to = _opt({k: ParamDef(s, (None,) * len(s)) for k, s in shapes.items()},
              moment_dtype)
    for i in range(3):
        g = {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
        lr = jlr(JTrain(**kw, warmup_steps=2, total_steps=10), jo["step"])
        jp, jo, jn = jadamw(JTrain(**kw), jp, {k: jnp.asarray(v)
                                              for k, v in g.items()}, jo, lr)
        tp, to, tn = adamw_update(TrainConfig(**kw), tp,
                                  {k: torch.from_numpy(v)
                                   for k, v in g.items()}, to,
                                  lr_schedule(TrainConfig(
                                      **kw, warmup_steps=2, total_steps=10),
                                      to["step"]))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        mt = dict(atol=1e-6, rtol=1e-6) if moment_dtype == "float32" else \
            dict(atol=1e-6, rtol=8e-3)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6)
            for mom in ("m", "v"):
                np.testing.assert_allclose(
                    to[mom][k].float().numpy(),
                    np.asarray(jo[mom][k], np.float32), err_msg=mom, **mt)


def test_global_norm_sums_pieces(monkeypatch):
    monkeypatch.setattr(adamw, "PIECE", 90)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (5, 6, 7)).astype(np.float32))
    assert len(adamw.pieces(x)) == 3  # rows of 42 elements, 2 rows at once
    np.testing.assert_allclose(float(global_norm([x, x[0]])),
                               float(np.sqrt((x.double() ** 2).sum()
                                             + (x[0].double() ** 2).sum())),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_grads_matches_reference(dtype):
    """Four rounds of int8 EF on a tree against the reference: the
    decompressed grads (in the grads' dtype) and the error buffers."""
    rng = np.random.default_rng(5)
    ef_j = {"a": jnp.zeros((6, 8)), "b": {"c": jnp.zeros(9)}}
    ef_t = {"a": torch.zeros(6, 8), "b": {"c": torch.zeros(9)}}
    for _ in range(4):
        g = {"a": rng.standard_normal((6, 8)).astype(np.float32),
             "b": {"c": (3 * rng.standard_normal(9)).astype(np.float32)}}
        gj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), g)
        gt = {"a": torch.from_numpy(g["a"]).to(getattr(torch, dtype)),
              "b": {"c": torch.from_numpy(g["b"]["c"]).to(
                  getattr(torch, dtype))}}
        dj, ef_j = jcompress(gj, ef_j)
        dt, ef_t = compress_grads(gt, ef_t)
        for a, b in ((dt["a"], dj["a"]), (dt["b"]["c"], dj["b"]["c"]),
                     (ef_t["a"], ef_j["a"]),
                     (ef_t["b"]["c"], ef_j["b"]["c"])):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
