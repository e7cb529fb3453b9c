"""The port's xLSTM blocks (chunkwise mLSTM, sequential sLSTM) against the
JAX package, their caches (prefill + decode against forward), and the
forward and one train step of every arch (`tests/test_archs_smoke.py`
on the port). Reduced configs, float32, weights seeded by the port and
carried across to the reference.

Tolerances: a block or a whole xLSTM model against the reference 1e-5
(float32, the same ops up to summation order); prefill + decode against
the full-sequence forward 5e-3, the reference's own bar for xLSTM in
`tests/test_models.py::test_decode_matches_forward` (the chunkwise
mLSTM and the step recurrence associate the decays differently).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import ApplyOptions as JOpts  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.launch.serve import rehome_cache  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import (ApplyOptions, decode_step, forward,  # noqa: E402
                                init_params, prefill)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.models.layers import materialize  # noqa: E402
from repro_torch.optim.adamw import adamw_init_defs  # noqa: E402

ARCH = "xlstm-350m"
OPTS = ApplyOptions(attn_impl="cuda", scan_impl="chunked", block_q=16)
JOPTS = JOpts(attn_impl="reference", scan_layers=True)
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs():
    return jcfg.reduced(jcfg.get_config(ARCH)), \
        tcfg.reduced(tcfg.get_config(ARCH))


def _to_jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def _np(x):
    return np.asarray(x, np.float32)


def test_param_and_cache_trees_match_reference():
    """Same parameter and cache trees, shapes and count as the reference's
    defs at full size (no weights are made)."""
    jc, tc = jcfg.get_config(ARCH), tcfg.get_config(ARCH)
    for jdefs, tdefs in ((JM.model_defs(jc), M.model_defs(tc)),
                         (JM.cache_defs(jc, 2, 64), M.cache_defs(tc, 2, 64))):
        jflat = jax.tree_util.tree_flatten_with_path(jdefs,
                                                     is_leaf=JL.is_def)[0]
        assert {jax.tree_util.keystr(p): (d.shape, d.dtype)
                for p, d in jflat} == \
            {p: (d.shape, d.dtype)
             for p, d in L.tree_leaves_with_path(tdefs, L.is_def)}
    assert L.count_params(M.model_defs(tc)) == \
        JL.count_params(JM.model_defs(jc))


@pytest.mark.parametrize("kind,j", [("mlstm", 0), ("slstm", 7)])
def test_block_prefill_matches_jax(kind, j):
    """One mLSTM / sLSTM block's sequence output and final state against
    the reference's `*_prefill` (the mLSTM's 32 tokens span 4 chunks of 8,
    so the carried matrix state is exercised)."""
    jc, tc = _cfgs()
    params = init_params(tc, 0, "cpu")
    p = L.tree_map(lambda t: t[0], params["blocks"][j]["mix"])
    x = np.random.default_rng(0).standard_normal((2, 32, tc.d_model)
                                                 ).astype(np.float32)
    fn = {"mlstm": (X.mlstm_prefill, JX.mlstm_prefill),
          "slstm": (X.slstm_prefill, JX.slstm_prefill)}[kind]
    y, state = fn[0](tc, OPTS, p, torch.from_numpy(x))
    jy, jstate = fn[1](jc, JOPTS, _to_jax(p), jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)
    assert set(state) == set(jstate)
    for k in state:
        np.testing.assert_allclose(state[k].numpy(), _np(jstate[k]),
                                   err_msg=k, **TOL)


def test_model_forward_prefill_decode_match_jax():
    """The whole reduced xLSTM model (7 mLSTM + 1 sLSTM): forward logits,
    prefill logits and states, and decode steps against the reference."""
    jc, tc = _cfgs()
    params = init_params(tc, 1, "cpu")
    jp = _to_jax(params)
    B, P, GEN = 2, 24, 3
    tokens = np.random.default_rng(1).integers(0, tc.vocab_size,
                                               (B, P + GEN), np.int32)
    tt = torch.from_numpy(tokens.astype(np.int64))
    logits, _ = forward(tc, OPTS, params, {"tokens": tt})
    jl, _ = jforward(jc, JOPTS, jp, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(logits.numpy(), _np(jl), **TOL)
    lo, cache = prefill(tc, OPTS, params, {"tokens": tt[:, :P]})
    jlo, jcache = jprefill(jc, JOPTS, jp, {"tokens": jnp.asarray(
        tokens[:, :P])})
    np.testing.assert_allclose(lo.numpy(), _np(jlo), **TOL)
    want = {jax.tree_util.keystr(path): b for path, b in
            jax.tree_util.tree_flatten_with_path(jcache["blocks"])[0]}
    got = dict(L.tree_leaves_with_path(cache["blocks"]))
    assert set(got) == set(want)
    for path, a in got.items():
        np.testing.assert_allclose(a.numpy(), _np(want[path]),
                                   err_msg=path, **TOL)
    cache = rehome_cache(tc, cache, B, P + GEN)
    for j in range(GEN):
        step = tokens[:, P + j:P + j + 1]
        lo, cache = decode_step(tc, OPTS, params, cache,
                                {"tokens": torch.from_numpy(
                                    step.astype(np.int64))})
        jlo, jcache = jdecode(jc, JOPTS, jp, jcache,
                              {"tokens": jnp.asarray(step)})
        np.testing.assert_allclose(lo.numpy(), _np(jlo), **TOL)


def test_decode_matches_forward():
    """tests/test_models.py's property for xLSTM: prefill(P) + decode
    reproduces the full-sequence logits at each decoded position."""
    _, cfg = _cfgs()
    params = init_params(cfg, 0, "cpu")
    B, P, GEN = 2, 32, 4
    tokens = torch.randint(0, cfg.vocab_size, (B, P + GEN),
                           generator=torch.Generator().manual_seed(0))
    full, _ = forward(cfg, OPTS, params, {"tokens": tokens})
    logits, cache = prefill(cfg, OPTS, params, {"tokens": tokens[:, :P]})
    cache = rehome_cache(cfg, cache, B, P + GEN)
    torch.testing.assert_close(logits, full[:, P - 1], atol=5e-3, rtol=5e-3)
    for j in range(GEN - 1):
        logits, cache = decode_step(cfg, OPTS, params, cache,
                                    {"tokens": tokens[:, P + j:P + j + 1]})
        torch.testing.assert_close(logits, full[:, P + j], atol=5e-3,
                                   rtol=5e-3)


# ---------------------------------------------------------------------------
# tests/test_archs_smoke.py on the port: every arch forwards and trains
# ---------------------------------------------------------------------------

ARCHS = list(tcfg.list_archs())


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    out = {"labels": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.input_mode == "tokens":
        out["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S)))
    else:
        out["embeds"] = torch.from_numpy(
            0.1 * rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_no_nans(arch):
    cfg = tcfg.reduced(tcfg.get_config(arch))
    params = init_params(cfg, 0, "cpu")
    B, S = 2, 32
    logits, aux = forward(cfg, OPTS, params, _batch(cfg, B, S, 0))
    assert logits.shape == (B, S, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(arch):
    """A whole train step (grads + AdamW): finite loss and grad norm, the
    step counted, the params moved."""
    cfg = tcfg.reduced(tcfg.get_config(arch))
    tcfg_ = TrainConfig(learning_rate=1e-3, total_steps=10, warmup_steps=1)
    step = make_train_step(cfg, tcfg_, OPTS)
    params = init_params(cfg, 1, "cpu")
    opt = materialize(adamw_init_defs(M.model_defs(cfg)), 1, torch.float32,
                      "cpu")
    before = L.tree_map(lambda t: t.clone(), params)
    shape = ShapeConfig("smoke", "train", 32, 2)
    _, new_opt, metrics = step(params, opt, _batch(cfg, shape.global_batch,
                                                   shape.seq_len, 1))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(new_opt["step"]) == 1
    delta = sum(float((a - b).abs().sum()) for (_, a), (_, b) in zip(
        L.tree_leaves_with_path(params), L.tree_leaves_with_path(before)))
    assert delta > 0
