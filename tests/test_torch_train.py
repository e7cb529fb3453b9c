"""The port's training path against the JAX package on the CPU: the
RMSNorm VJP, the flash op's recompute backward, `loss_fn` and its
gradients with remat, and one whole train step, from identical state
(weights and optimizer state carried across by `repro_torch.convert`).

Tolerances, and why:
- RMSNorm float32 1e-6 (the same fp32 formula); bfloat16 two bf16 ulps
  (rtol 8e-3: both round an fp32 result to bf16, and the fp32 results
  differ in the last bits by summation order).
- The flash op's grads 1e-4, the reference's own bar for its kernel's
  grads (`tests/test_kernels.py::test_flash_attention_grads_match_ref`).
- Loss 1e-5 relative, grad leaves atol 1e-5: a few float32 layers
  summed in other orders (the reference's remat test holds its grads to
  1e-5).
- One train step: lr and the step count exact; loss, grad norm and the
  moments within 1e-5 relative (float32 sums in other orders); params
  within atol 2e-6 where |g| >= 1e-6: an Adam step's first update is
  lr * g / (|g| + eps), which an fp32 difference in g (~1e-10 here) moves
  by lr * eps * dg / g^2, far below 2e-6 there; where |g| is smaller the
  update is ill-conditioned (a gradient summed to ~1e-9 may even change
  sign), so there it is only held within 2.2 lr, one update each way. The int8
  error-feedback residuals within 1e-3 of their leaf's quantization step
  (the step is at least twice the largest residual, hence 2e-3 of it):
  a residual inherits its gradient's absolute fp32 difference. With int8
  EF, an element whose gradient sits on a rounding boundary may take the
  next level in one package (the two fp32 gradients differ in the last
  bits): there every check allows 0.1% of a leaf's elements off.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jflash  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.steps import make_train_step as jmake_step  # noqa: E402
from repro.models import ApplyOptions as JOpts  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adamw import adamw_init_defs as jadam_defs  # noqa: E402
from repro.optim.compression import ef_init_defs as jef_defs  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import (params_from_reference,  # noqa: E402
                                 train_state_from_reference)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import ApplyOptions, init_params, loss_fn  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

# block 16 with 32-token sequences: S > block_q and S % block_q == 0, so
# the port's attention takes the flash op (its plain version on the CPU)
OPTS = ApplyOptions(attn_impl="cuda", scan_impl="chunked", block_q=16)
JOPTS = JOpts(attn_impl="reference", scan_layers=True)
B, S = 2, 32
ARCHS = ["qwen3-8b", "jamba-v0.1-52b", "xlstm-350m"]


def _cfgs(arch, **kw):
    return (dataclasses.replace(jcfg.reduced(jcfg.get_config(arch)), **kw),
            dataclasses.replace(tcfg.reduced(tcfg.get_config(arch)), **kw))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S), np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def _ref_params(tc, seed):
    """The port's seeded weights (hash-independent, unlike the reference's
    per-leaf keys) as the reference's tree of jax arrays."""
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                  init_params(tc, seed, "cpu"))


def _leaves(tree):
    return [x for _, x in L.tree_leaves_with_path(tree)]


def _jleaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_grads_match_jax(dtype):
    """`rms_norm`'s autograd against `jax.vjp` of the reference's
    custom_vjp: values and the dtypes of both cotangents."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    g = rng.standard_normal((3, 5, 48)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda a, s: JL.rms_norm(a, s, 1e-5),
                     jnp.asarray(x, jdt), jnp.asarray(scale, jdt))
    want = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st = torch.from_numpy(scale).to(tdt).requires_grad_()
    y = L.rms_norm(xt, st, 1e-5)
    got = torch.autograd.grad(y, (xt, st), torch.from_numpy(g).to(tdt))
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else \
        dict(atol=1e-2, rtol=8e-3)
    for a, b in zip(got, want):
        assert a.dtype == tdt and str(b.dtype) == dtype
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("K,window", [(2, None), (1, None), (2, 24)])
def test_flash_attention_grads_match_reference(K, window):
    """tests/test_kernels.py::test_flash_attention_grads_match_ref on the
    port: grads of sum(o^2) through the flash op against the reference's
    flash op (its Pallas kernel in interpret mode, its recompute VJP)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 64, 2, 32)).astype(np.float32)
    k = rng.standard_normal((1, 64, K, 32)).astype(np.float32)
    v = rng.standard_normal((1, 64, K, 32)).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(jflash(
        a, b, c, causal=True, window=window, block=32,
        interpret=True) ** 2), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention(*ts, causal=True, window=window, block=32)
    got = torch.autograd.grad((o ** 2).sum(), ts)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """`loss_fn` and the gradient of every parameter leaf against
    `jax.value_and_grad` of the reference's `loss_fn`."""
    jc, tc = _cfgs(arch)
    jp = _ref_params(tc, 0)
    batch = _batch(jc)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jc, JOPTS, p, batch), has_aux=True)(jp)
    tp = params_from_reference(jp, device="cpu")
    leaves = [x.requires_grad_() for x in _leaves(tp)]
    loss, metrics = loss_fn(tc, OPTS, tp, _t(batch))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()),
                               float(jm["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"].detach()),
                               float(jm["aux"]),
                               rtol=1e-5, atol=1e-6)
    paths = [p for p, _ in L.tree_leaves_with_path(tp)]
    for path, g, (jpath, want) in zip(paths, grads, _jleaves(jg)):
        assert path == jpath
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5, rtol=1e-4,
                                   err_msg=path)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_does_not_change_values(remat):
    """tests/test_models.py::test_remat_does_not_change_values on the
    port, for both saving policies against remat="none"."""
    _, cfg = _cfgs("qwen3-8b", remat=remat, num_layers=2)
    cfg_none = dataclasses.replace(cfg, remat="none")
    params = init_params(cfg, 3, "cpu")
    batch = _t(_batch(cfg, seed=3))
    leaves = [x.requires_grad_() for x in _leaves(params)]
    l1, _ = loss_fn(cfg, OPTS, params, batch)
    g1 = torch.autograd.grad(l1, leaves)
    l2, _ = loss_fn(cfg_none, OPTS, params, batch)
    g2 = torch.autograd.grad(l2, leaves)
    assert float(l1) == pytest.approx(float(l2), rel=1e-6)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def _jax_step(jc, tc, tc_kw, use_ef, batch):
    shape = JShape("t", "train", S, B)
    tcfg = JTrain(**tc_kw)
    mesh = make_host_mesh()
    fn, *_ = jmake_step(jc, tcfg, JOPTS, mesh, shape)
    key = jax.random.PRNGKey(1)
    params = _ref_params(tc, 1)
    opt = JL.materialize(jadam_defs(JM.model_defs(jc)), key, jnp.float32)
    ef = (JL.materialize(jef_defs(JM.model_defs(jc)), key, jnp.float32)
          if use_ef else None)
    snap = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                            t)
    state = snap((params, opt, ef))
    with mesh:
        out = jax.jit(fn)(params, opt, batch, ef) if use_ef else \
            jax.jit(fn)(params, opt, batch)
    return state, out


@pytest.mark.parametrize("arch,variant", [
    ("qwen3-8b", "plain"), ("jamba-v0.1-52b", "plain"),
    ("xlstm-350m", "plain"), ("qwen3-8b", "microbatch"),
    ("qwen3-8b", "int8_ef")])
def test_train_step_matches_jax(arch, variant):
    """One `make_train_step` step against the reference's jitted step from
    identical state: new params, moments, step, and the metrics."""
    jc, tc = _cfgs(arch)
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_steps=1)
    if variant == "microbatch":
        kw["microbatch"] = 1
    if variant == "int8_ef":
        kw["grad_compression"] = "int8_ef"
    use_ef = variant == "int8_ef"
    batch = _batch(jc, seed=2)
    (jp0, jo0, je0), out = _jax_step(jc, tc, kw, use_ef, batch)
    params, opt, ef = train_state_from_reference(jp0, jo0, je0, device="cpu")
    step = make_train_step(tc, TrainConfig(**kw), OPTS)
    got = step(params, opt, _t(batch), ef) if use_ef else \
        step(params, opt, _t(batch))
    assert got[0] is params and got[1] is opt  # updated in place
    for k in ("loss", "grad_norm", "ce"):
        np.testing.assert_allclose(float(got[2][k]), float(out[2][k]),
                                   rtol=1e-5, err_msg=k)
    assert float(got[2]["lr"]) == float(out[2]["lr"])
    assert int(opt["step"]) == int(out[1]["step"]) == 1
    # int8 EF: an element whose fp32 gradient sits on a rounding boundary
    # may take the next int8 level in one package; at most 0.1% may
    few = 1e-3 if use_ef else 0.0
    for tree, jtree, tol in ((opt["m"], out[1]["m"], dict(atol=1e-9,
                                                          rtol=1e-5)),
                             (opt["v"], out[1]["v"], dict(atol=1e-12,
                                                          rtol=1e-4))):
        for (p, a), (_, b) in zip(L.tree_leaves_with_path(tree),
                                  _jleaves(jtree)):
            _held(p, a.numpy(), b, few, **tol)
    lr = kw["learning_rate"]
    for (p, a), (_, b), (_, m) in zip(L.tree_leaves_with_path(params),
                                      _jleaves(out[0]),
                                      _jleaves(out[1]["m"])):
        # |g| from the reference's first moment, m = (1 - beta1) g
        tight = np.abs(m) / 0.1 >= 1e-6
        _held(p, a.numpy()[tight], b[tight], few, atol=2e-6, rtol=0)
        assert np.abs(a.numpy() - b).max() <= 2.2 * lr, p
    if use_ef:
        for (p, a), (_, b) in zip(L.tree_leaves_with_path(got[3]),
                                  _jleaves(out[3])):
            _held(p, a.numpy(), b, few, rtol=0,
                  atol=2e-3 * np.abs(b).max())


def _held(path, a, b, few, atol, rtol):
    """All but a fraction ``few`` of the elements within the tolerance."""
    bad = ~np.isclose(a, b, atol=atol, rtol=rtol)
    assert bad.sum() <= few * bad.size, (
        f"{path}: {bad.sum()} of {bad.size} elements off, worst "
        f"{np.abs(a - b).max():.3e}")
