"""The port's LM layers and model (prefill, decode, forward) against the
JAX package, on reduced configs with weights carried across by
`repro_torch.convert.params_from_reference`.

Tolerances: the layers 1e-6 (float32, the same ops in the same order
up to the matmul's summation order); whole models 1e-5 absolute on
float32 logits of size ~1 (a few layers of float32 matmuls summed in
different orders; measured differences are ~1e-7).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import (ApplyOptions as JOpts, decode_step as jdecode,  # noqa: E402
                          forward as jforward, init_params as jinit,
                          prefill as jprefill)
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import (cache_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.launch.serve import rehome_cache  # noqa: E402
from repro_torch.models import (ApplyOptions, decode_step, forward,  # noqa: E402
                                init_params, prefill)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# block_q 16 with prompts of 48: S > block_q and S % block_q == 0, so the
# full-sequence core takes the flash op (and the blocked loop)
BLOCK_Q = 16


def _cfgs(arch):
    return jcfg.reduced(jcfg.get_config(arch)), \
        tcfg.reduced(tcfg.get_config(arch))


def _jax_pad_cache(cfg, cache, batch, total_len):
    """tests/test_models.py's `_pad_cache` (serve.py's re-homing)."""
    target = JL.materialize(JM.cache_defs(cfg, batch, total_len),
                            jax.random.PRNGKey(0),
                            jnp.dtype(cfg.compute_dtype))

    def place(dst, src):
        if dst.shape == src.shape:
            return src.astype(dst.dtype)
        pads = [(0, d - s) for d, s in zip(dst.shape, src.shape)]
        return jnp.pad(src, pads).astype(dst.dtype)

    return jax.tree_util.tree_map(place, target, {"blocks": cache["blocks"],
                                                  "pos": cache["pos"]})


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), np.float32)
    s = rng.standard_normal((64,), np.float32)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5)
    got = L.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("hd", [16, 120])
def test_apply_rope_matches_jax(hd):
    """Each head split into halves, not interleaved."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, hd), np.float32)
    pos = np.broadcast_to(np.arange(9) + 1000, (2, 9))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                       10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_apply_rope_odd_head_dim_keeps_last_channel():
    """The reference's odd-head_dim branch (layers.py:169) cannot run:
    its rope_freqs has head_dim // 2 + 1 entries and the product fails
    to broadcast (ROADMAP Queue 3). The port rotates the first 2 * (hd // 2)
    channels with frequencies theta^(-2i/hd), i < hd // 2, and keeps the
    last one; checked against that formula in numpy."""
    hd, theta = 7, 10_000.0
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, hd), np.float32)
    pos = np.arange(9, dtype=np.float64)
    got = L.apply_rope(torch.from_numpy(x), torch.arange(9), theta).numpy()
    freqs = theta ** (-np.arange(0, hd - 1, 2) / hd)
    ang = pos[:, None] * freqs                        # [S, 3]
    cos, sin = np.cos(ang)[:, None], np.sin(ang)[:, None]
    x1, x2 = x[..., :3], x[..., 3:6]
    want = np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                           x[..., 6:]], axis=-1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[..., -1], x[..., -1])


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_apply_matches_jax(gated):
    """SwiGLU, or GELU with jax's default tanh approximation."""
    rng = np.random.default_rng(2)
    defs = JL.mlp_defs(32, 48, gated)
    p = {k: rng.standard_normal(d.shape, np.float32) * 0.2
         for k, d in defs.items()}
    x = rng.standard_normal((3, 4, 32), np.float32)
    want = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), gated)
    got = L.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), gated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-8b", "starcoder2-3b",
                                  "h2o-danube-3-4b", "llama3-405b",
                                  "musicgen-medium", "phi-3-vision-4.2b",
                                  "jamba-v0.1-52b", "phi3.5-moe-42b-a6.6b",
                                  "granite-moe-3b-a800m"])
def test_param_tree_matches_reference(arch):
    """Same tree, shapes and count as the reference's defs, at full size
    (no weights are made)."""
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    jdefs, tdefs = JM.model_defs(jc), M.model_defs(tc)
    jflat = jax.tree_util.tree_flatten_with_path(jdefs, is_leaf=JL.is_def)[0]
    assert {jax.tree_util.keystr(p): d.shape for p, d in jflat} == \
        {p: d.shape for p, d in L.tree_leaves_with_path(tdefs, L.is_def)}
    assert L.count_params(tdefs) == JL.count_params(jdefs) \
        == tc.param_count()


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "musicgen-medium"])
def test_input_defs_match_reference(arch, mode):
    shape_j = jcfg.ShapeConfig("s", mode, 64, 2)
    shape_t = tcfg.ShapeConfig("s", mode, 64, 2)
    want = JM.input_defs(jcfg.get_config(arch), shape_j)
    got = M.input_defs(tcfg.get_config(arch), shape_t)
    assert {k: (d.shape, d.dtype) for k, d in want.items()} == \
        {k: (d.shape, d.dtype) for k, d in got.items()}


def test_materialize_is_seeded_per_leaf():
    cfg = tcfg.reduced(tcfg.get_config("qwen3-8b"))
    a = init_params(cfg, 3, "cpu")
    b = init_params(cfg, 3, "cpu")
    c = init_params(cfg, 4, "cpu")
    la = L.tree_leaves_with_path(a)
    for (pa, x), (_, y), (_, z) in zip(la, L.tree_leaves_with_path(b),
                                       L.tree_leaves_with_path(c)):
        assert torch.equal(x, y), pa
        if "ln" not in pa and "norm" not in pa:
            assert not torch.equal(x, z), pa
            # truncated normal at +-2 std
            std = 1.0 if pa == "['embed']" else 0.02
            assert x.abs().max() <= 2 * std + 1e-6
    assert not torch.equal(a["lm_head"], a["embed"].T)


def test_params_from_reference_keeps_structure_and_bf16():
    cfg = dataclasses.replace(jcfg.reduced(jcfg.get_config("qwen3-8b")),
                              param_dtype="bfloat16")
    params = jinit(cfg, jax.random.PRNGKey(0))
    tp = params_from_reference(params, "cpu")
    jflat = {jax.tree_util.keystr(p): a
             for p, a in jax.tree_util.tree_flatten_with_path(params)[0]}
    tflat = dict(L.tree_leaves_with_path(tp))
    assert jflat.keys() == tflat.keys()
    for path, t in tflat.items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(jflat[path], np.float32))


# ---------------------------------------------------------------------------
# whole models against the JAX package
# ---------------------------------------------------------------------------

MODEL_CASES = [
    ("qwen3-8b", 48),         # qk-norm, GQA
    ("starcoder2-3b", 48),    # kv=2, GELU MLP
    ("h2o-danube-3-4b", 48),  # sliding window 32 < prompt: the ring rolls
]


@pytest.mark.parametrize("port_impl", ["cuda", "reference"])
@pytest.mark.parametrize("jax_impl", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("arch,P", MODEL_CASES)
def test_prefill_and_decode_match_jax(arch, P, jax_impl, port_impl):
    jc, tc = _cfgs(arch)
    params = jinit(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(params, "cpu")
    B, GEN = 2, 4
    tokens = np.random.default_rng(5).integers(
        0, jc.vocab_size, (B, P + GEN)).astype(np.int32)
    jo = JOpts(attn_impl=jax_impl, block_q=BLOCK_Q)
    to = ApplyOptions(attn_impl=port_impl, block_q=BLOCK_Q)

    lj, cj = jprefill(jc, jo, params, {"tokens": jnp.asarray(tokens[:, :P])})
    lt, ct = prefill(tc, to, tp, {"tokens": torch.from_numpy(tokens[:, :P])})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    # the caches agree too (ring-rolled for the sliding window)
    jc_leaves = {jax.tree_util.keystr(p): a for p, a in
                 jax.tree_util.tree_flatten_with_path(cj["blocks"])[0]}
    tc_leaves = dict(L.tree_leaves_with_path(ct["blocks"]))
    assert jc_leaves.keys() == tc_leaves.keys()
    for path, t in tc_leaves.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jc_leaves[path]),
                                   **TOL)
    assert ct["pos"] == int(cj["pos"]) == P

    cj = _jax_pad_cache(jc, cj, B, P + GEN)
    ct = rehome_cache(tc, ct, B, P + GEN)
    for j in range(GEN):
        step = tokens[:, P + j:P + j + 1]
        lj, cj = jdecode(jc, jo, params, cj, {"tokens": jnp.asarray(step)})
        lt, ct = decode_step(tc, to, tp, ct, {"tokens": torch.from_numpy(step)})
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert ct["pos"] == P + GEN


def test_cache_from_reference_decodes_like_jax():
    jc, tc = _cfgs("qwen3-8b")
    params = jinit(jc, jax.random.PRNGKey(1))
    tokens = np.random.default_rng(6).integers(
        0, jc.vocab_size, (2, 33)).astype(np.int32)
    jo = JOpts(attn_impl="reference")
    _, cj = jprefill(jc, jo, params, {"tokens": jnp.asarray(tokens[:, :32])})
    cj = _jax_pad_cache(jc, cj, 2, 33)
    ct = cache_from_reference(cj, "cpu")
    step = tokens[:, 32:]
    lj, _ = jdecode(jc, jo, params, cj, {"tokens": jnp.asarray(step)})
    lt, _ = decode_step(tc, ApplyOptions(attn_impl="cuda"),
                        params_from_reference(params, "cpu"), ct,
                        {"tokens": torch.from_numpy(step)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("impl", ["reference", "blocked", "cuda"])
def test_forward_matches_jax(impl):
    jc, tc = _cfgs("h2o-danube-3-4b")
    params = jinit(jc, jax.random.PRNGKey(2))
    tokens = np.random.default_rng(7).integers(
        0, jc.vocab_size, (2, 64)).astype(np.int32)
    want, _ = jforward(jc, JOpts(attn_impl="blocked", block_q=BLOCK_Q),
                       params, {"tokens": jnp.asarray(tokens)})
    got, aux = forward(tc, ApplyOptions(attn_impl=impl, block_q=BLOCK_Q),
                       params_from_reference(params, "cpu"),
                       {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0


def test_embeds_input_mode_matches_jax():
    """musicgen-medium takes frame embeddings, not tokens."""
    jc, tc = _cfgs("musicgen-medium")
    params = jinit(jc, jax.random.PRNGKey(3))
    rng = np.random.default_rng(8)
    emb = 0.05 * rng.standard_normal((2, 33, jc.d_model), np.float32)
    jo = JOpts(attn_impl="reference", block_q=BLOCK_Q)
    to = ApplyOptions(attn_impl="cuda", block_q=BLOCK_Q)
    tp = params_from_reference(params, "cpu")
    lj, cj = jprefill(jc, jo, params, {"embeds": jnp.asarray(emb[:, :32])})
    lt, ct = prefill(tc, to, tp, {"embeds": torch.from_numpy(emb[:, :32])})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    cj = _jax_pad_cache(jc, cj, 2, 33)
    ct = rehome_cache(tc, ct, 2, 33)
    lj, _ = jdecode(jc, jo, params, cj, {"embeds": jnp.asarray(emb[:, 32:])})
    lt, _ = decode_step(tc, to, tp, ct, {"embeds": torch.from_numpy(
        emb[:, 32:])})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


# Mamba + attention + MoE (jamba at two pattern repeats) and the MoE archs,
# on both scan routes; the JAX side runs its chunked scan and, for the
# attention core, its reference path or its Pallas kernels in interpret
# mode
HYBRID_CASES = [("jamba-v0.1-52b", 16), ("phi3.5-moe-42b-a6.6b", None),
                ("granite-moe-3b-a800m", None)]


def _hybrid_cfgs(arch, layers):
    jc, tc = _cfgs(arch)
    if layers:
        jc = dataclasses.replace(jc, num_layers=layers)
        tc = dataclasses.replace(tc, num_layers=layers)
    return jc, tc


def _leaves(tree):
    return {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("scan_impl", ["chunked", "cuda"])
@pytest.mark.parametrize("jax_impl", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("arch,layers", HYBRID_CASES)
def test_hybrid_and_moe_models_match_jax(arch, layers, jax_impl, scan_impl):
    """forward (logits and the router aux loss), prefill (logits and every
    cache leaf, Mamba conv and ssm states included) and three decode
    steps, on the same parameters."""
    jc, tc = _hybrid_cfgs(arch, layers)
    params = jinit(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(params, "cpu")
    B, P, GEN = 2, 32, 3
    tokens = np.random.default_rng(11).integers(
        0, jc.vocab_size, (B, P + GEN)).astype(np.int32)
    jo = JOpts(attn_impl=jax_impl, block_q=BLOCK_Q)
    to = ApplyOptions(attn_impl="cuda", scan_impl=scan_impl, block_q=BLOCK_Q)

    want, waux = jforward(jc, jo, params, {"tokens": jnp.asarray(tokens)})
    got, gaux = forward(tc, to, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)
    assert float(gaux) > 0.0

    lj, cj = jprefill(jc, jo, params, {"tokens": jnp.asarray(tokens[:, :P])})
    lt, ct = prefill(tc, to, tp, {"tokens": torch.from_numpy(tokens[:, :P])})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    jl = _leaves(cj["blocks"])
    tl = dict(L.tree_leaves_with_path(ct["blocks"]))
    assert jl.keys() == tl.keys()
    for path, t in tl.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jl[path]), **TOL)

    cj = _jax_pad_cache(jc, cj, B, P + GEN)
    ct = rehome_cache(tc, ct, B, P + GEN)
    for j in range(GEN):
        step = tokens[:, P + j:P + j + 1]
        lj, cj = jdecode(jc, jo, params, cj, {"tokens": jnp.asarray(step)})
        lt, ct = decode_step(tc, to, tp, ct, {"tokens": torch.from_numpy(step)})
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    # the caches updated in place are the reference's returned caches
    jl = _leaves(cj["blocks"])
    for path, t in L.tree_leaves_with_path(ct["blocks"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(jl[path]), **TOL)


def test_rehome_cache_keeps_each_leaf_dtype():
    """With a bf16 compute dtype, re-homing casts each leaf to its def's
    dtype: KV and conv states bf16, the Mamba ssm state float32 (as the
    reference's ``place``), so prefill's fp32 state is not rounded."""
    cfg = dataclasses.replace(tcfg.reduced(tcfg.get_config("jamba-v0.1-52b")),
                              compute_dtype="bfloat16",
                              param_dtype="bfloat16")
    params = init_params(cfg, 0, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(3))
    opts = ApplyOptions(attn_impl="cuda", scan_impl="cuda")
    _, cache = prefill(cfg, opts, params, {"tokens": tokens})
    ssm = {p: t for p, t in L.tree_leaves_with_path(cache["blocks"])
           if p.endswith("['ssm']")}
    assert ssm and all(t.dtype == torch.float32 for t in ssm.values())
    home = rehome_cache(cfg, cache, 2, 30)
    defs = dict(L.tree_leaves_with_path(M.cache_defs(cfg, 2, 30)["blocks"],
                                        L.is_def))
    leaves = dict(L.tree_leaves_with_path(home["blocks"]))
    assert leaves.keys() == defs.keys()
    for path, t in leaves.items():
        assert t.dtype == getattr(torch, defs[path].dtype), path
        assert tuple(t.shape) == defs[path].shape, path
    for path, t in ssm.items():
        assert torch.equal(leaves[path], t), path  # not rounded
    # the KV tensors are zero-padded from 24 to 30 positions
    k = next(t for p, t in leaves.items() if p.endswith("['k']"))
    assert k.shape[2] == 30 and not k[:, :, 24:].any()
    lt, _ = decode_step(cfg, opts, params, home,
                        {"tokens": tokens[:, -1:]})
    assert bool(torch.isfinite(lt.float()).all())


def test_cache_from_reference_carries_mamba_states():
    """jamba's reference cache (bf16 compute: conv bf16, ssm float32)
    carries across with each leaf's dtype, and decodes like the
    reference."""
    jc, tc = _cfgs("jamba-v0.1-52b")
    jc = dataclasses.replace(jc, compute_dtype="bfloat16",
                             param_dtype="bfloat16")
    tc = dataclasses.replace(tc, compute_dtype="bfloat16",
                             param_dtype="bfloat16")
    params = jinit(jc, jax.random.PRNGKey(5))
    tokens = np.random.default_rng(12).integers(
        0, jc.vocab_size, (2, 21)).astype(np.int32)
    jo = JOpts(attn_impl="reference")
    _, cj = jprefill(jc, jo, params, {"tokens": jnp.asarray(tokens[:, :20])})
    cj = _jax_pad_cache(jc, cj, 2, 21)
    ct = cache_from_reference(cj, "cpu")
    jl = _leaves(cj["blocks"])
    for path, t in L.tree_leaves_with_path(ct["blocks"]):
        want = "float32" if path.endswith("['ssm']") else "bfloat16"
        assert str(jl[path].dtype) == want and t.dtype == getattr(torch,
                                                                 want)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(jl[path], np.float32))
    step = tokens[:, 20:]
    lj, _ = jdecode(jc, jo, params, cj, {"tokens": jnp.asarray(step)})
    lt, _ = decode_step(tc, ApplyOptions(attn_impl="cuda", scan_impl="cuda"),
                        params_from_reference(params, "cpu"), ct,
                        {"tokens": torch.from_numpy(step)})
    # bf16 activations: both sides round to bf16 at other places
    np.testing.assert_allclose(lt.float().numpy(),
                               np.asarray(lj, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_params_from_reference_carries_mamba_and_moe_leaves():
    """jamba's parameter tree (mamba conv_w, a_log, ..., MoE router and
    experts), bf16 leaves bf16 and float32 leaves float32."""
    jc, _ = _cfgs("jamba-v0.1-52b")
    params = jinit(dataclasses.replace(jc, param_dtype="bfloat16"),
                   jax.random.PRNGKey(0))
    params["final_ln"] = params["final_ln"].astype(jnp.float32)
    tp = params_from_reference(params, "cpu")
    tflat = dict(L.tree_leaves_with_path(tp))
    jflat = _leaves(params)
    assert jflat.keys() == tflat.keys()
    names = {p.split("'")[-2] for p in tflat}
    assert {"conv_w", "a_log", "d_skip", "router", "w_up", "w_gate",
            "w_down", "in_proj", "x_proj", "dt_w"} <= names
    for path, t in tflat.items():
        want = torch.float32 if path == "['final_ln']" else torch.bfloat16
        assert t.dtype == want, path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(jflat[path], np.float32))


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


# MoE archs: capacity drops depend on the dispatch group, which holds all
# B * S tokens in forward, the prompt in prefill and the B new tokens in
# decode, so a dropped token can differ; tests/test_models.py holds jamba
# to 5e-3 for this reason, and so does this test
@pytest.mark.parametrize("arch,P", [("qwen3-8b", 32), ("starcoder2-3b", 32),
                                    ("h2o-danube-3-4b", 32),
                                    ("h2o-danube-3-4b", 48),
                                    ("jamba-v0.1-52b", 32),
                                    ("phi3.5-moe-42b-a6.6b", 32)])
def test_decode_matches_forward(arch, P):
    """tests/test_models.py's property: prefill(P) + decode reproduces the
    full-sequence logits at each decoded position (for the window arch
    also with the ring wrapped)."""
    cfg = tcfg.reduced(tcfg.get_config(arch))
    tol = 5e-3 if cfg.moe else 2e-5
    params = init_params(cfg, 0, "cpu")
    B, GEN = 2, 4
    tokens = torch.randint(0, cfg.vocab_size, (B, P + GEN),
                           generator=torch.Generator().manual_seed(1))
    opts = ApplyOptions(attn_impl="cuda", scan_impl="cuda", block_q=BLOCK_Q)
    full, _ = forward(cfg, opts, params, {"tokens": tokens})
    logits, cache = prefill(cfg, opts, params, {"tokens": tokens[:, :P]})
    cache = rehome_cache(cfg, cache, B, P + GEN)
    torch.testing.assert_close(logits, full[:, P - 1], atol=tol, rtol=tol)
    for j in range(GEN - 1):
        logits, cache = decode_step(cfg, opts, params, cache,
                                    {"tokens": tokens[:, P + j:P + j + 1]})
        torch.testing.assert_close(logits, full[:, P + j], atol=tol,
                                   rtol=tol)


def test_unknown_scan_impl_raises():
    cfg = tcfg.reduced(tcfg.get_config("jamba-v0.1-52b"))
    params = init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="scan_impl"):
        forward(cfg, ApplyOptions(scan_impl="pallas"), params,
                {"tokens": torch.zeros((1, 4), dtype=torch.int64)})


def test_unknown_attn_impl_raises():
    cfg = tcfg.reduced(tcfg.get_config("qwen3-8b"))
    params = init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        forward(cfg, ApplyOptions(attn_impl="pallas"), params,
                {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
