"""The port's MoE layer against the JAX package, on the CPU: the output,
the router's aux loss, and which tokens capacity drops, with the
reference's parameters carried across by `params_from_reference` and
inputs drawn with numpy from a seed.

Tolerance: float32 2e-5 absolute and relative (the same ops; the
router and expert matmuls sum in other orders). Routing is discrete, so
the routed experts and dropped tokens must be the same, not close.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402

F32 = dict(atol=2e-5, rtol=2e-5)


def _moe_block(arch, seed, **moe_kw):
    jc = jcfg.reduced(jcfg.get_config(arch))
    tc = tcfg.reduced(tcfg.get_config(arch))
    if moe_kw:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                             **moe_kw))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                             **moe_kw))
    params = jinit(jc, jax.random.PRNGKey(seed))
    blk = next(i for i, b in enumerate(jc.pattern) if b.ff == "moe")
    p = jax.tree_util.tree_map(lambda t: t[0], params["blocks"][blk])["ff"]
    return jc, tc, p


def _skewed(p, x, shift):
    """Inputs sharing a common direction, and the router's expert 0
    aligned with it: expert 0's logit rises by about ``shift`` for every
    token, so more tokens want it than it has slots and capacity drops
    some. (A moderate shift: gates far below float32's normal range would
    round differently where XLA flushes denormals to zero.)"""
    p = dict(p)
    r = np.array(p["router"], np.float32)
    D = r.shape[0]
    r[:, 0] += shift * np.sqrt(2.0) / D
    p["router"] = jnp.asarray(r)
    return p, x + 1.0


@pytest.mark.parametrize("arch,gated", [("phi3.5-moe-42b-a6.6b", True),
                                        ("granite-moe-3b-a800m", True),
                                        ("phi3.5-moe-42b-a6.6b", False)])
def test_moe_apply_matches_jax(arch, gated):
    jc, tc, p = _moe_block(arch, 1, gated=gated)
    if not gated:  # the reduced configs are gated; drop w_gate
        p = {k: v for k, v in p.items() if k != "w_gate"}
    x = np.random.default_rng(2).standard_normal(
        (2, 32, jc.d_model)).astype(np.float32)
    want, wa = JMOE.moe_apply(jc, p, jnp.asarray(x))
    got, ga = MOE.moe_apply(tc, params_from_reference(p, "cpu"),
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(ga), float(wa), **F32)
    assert ga.dtype == torch.float32


@pytest.mark.parametrize("group_size", [16, 32])
def test_capacity_drops_the_same_tokens(group_size):
    """A router skewed towards expert 0 overflows its capacity in every
    group: the same tokens lose their slot there (slot-by-slot, in group
    order), and the outputs and aux loss agree."""
    jc, tc, p = _moe_block("phi3.5-moe-42b-a6.6b", 3, group_size=group_size)
    x = np.random.default_rng(4).standard_normal(
        (2, 48, jc.d_model)).astype(np.float32)
    p, x = _skewed(p, x, 3.5)
    tp = params_from_reference(p, "cpu")
    want, wa = JMOE.moe_apply(jc, p, jnp.asarray(x))
    got, ga = MOE.moe_apply(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(ga), float(wa), **F32)

    # the port's routing: tokens that lost their slot at expert 0
    G, gsz = MOE._group_tokens(96, group_size)
    C = MOE._capacity(gsz, 2, 4, jc.moe.capacity_factor)
    h = rms_norm(torch.from_numpy(x).reshape(G, gsz, -1), tp["ln"],
                 tc.norm_eps)
    gates = torch.softmax(h @ tp["router"], dim=-1)
    dispatch, _ = MOE._route(gates, 2, C)
    routed = dispatch.sum(-1)                      # [G, s, E]
    assert (routed.sum(1) <= C).all()
    assert ((dispatch.sum(1) <= 1).all())          # one token per slot
    want0 = torch.zeros_like(gates[..., 0], dtype=torch.bool)
    for k in range(2):  # the experts each token wants, best first
        want0 |= torch.topk(gates, 2, dim=-1).indices[..., k] == 0
    dropped = want0 & (routed[..., 0] == 0)
    assert int(dropped.sum()) > 0
    # capacity drops the latest tokens of each group's first slot
    first = torch.argmax(gates, dim=-1) == 0
    for g in range(G):
        kept = routed[g, :, 0].bool() & first[g]
        idx = torch.nonzero(first[g]).flatten()
        assert torch.equal(kept[idx], torch.arange(len(idx)) < C)
    # a token dropped at both of its experts gets exactly zero, in both
    gone = np.all(got.reshape(G, gsz, -1).numpy() == 0, axis=-1)
    np.testing.assert_array_equal(
        gone, np.all(np.asarray(want).reshape(G, gsz, -1) == 0, axis=-1))


@pytest.mark.parametrize("tokens,group_size,top_k,E", [
    (96, 16, 2, 4), (8192, 1024, 2, 16), (8, 1024, 2, 16), (100, 48, 8, 40),
    (7, 3, 1, 4)])
def test_groups_and_capacity_match_reference(tokens, group_size, top_k, E):
    """Including jamba's serving shapes: prefill 8 groups of 1,024 tokens
    with C = 164, decode one group of 8 with C = 4."""
    G, gsz = MOE._group_tokens(tokens, group_size)
    assert (G, gsz) == JMOE._group_tokens(tokens, group_size)
    assert MOE._capacity(gsz, top_k, E, 1.25) == \
        JMOE._capacity(gsz, top_k, E, 1.25)
    if (tokens, E) == (8192, 16):
        assert (G, gsz, MOE._capacity(gsz, 2, 16, 1.25)) == (8, 1024, 164)
    if (tokens, E) == (8, 16):
        assert (G, gsz, MOE._capacity(gsz, 2, 16, 1.25)) == (1, 8, 4)


def test_moe_aux_loss_balanced_router_is_one():
    """tests/test_models.py's property on the port: near-uniform router
    probabilities give an aux loss near 1."""
    _, tc, p = _moe_block("phi3.5-moe-42b-a6.6b", 4)
    x = 0.1 * torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 32, tc.d_model)).astype(np.float32))
    y, aux = MOE.moe_apply(tc, params_from_reference(p, "cpu"), x)
    assert y.shape == x.shape
    assert 0.5 < float(aux) < 2.5


@pytest.mark.parametrize("gated", [True, False])
def test_moe_defs_match_reference(gated):
    jc = jcfg.get_config("jamba-v0.1-52b")
    tc = tcfg.get_config("jamba-v0.1-52b")
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, gated=gated))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, gated=gated))
    want = {k: (d.shape, d.init) for k, d in JMOE.moe_defs(jc).items()}
    got = {k: (d.shape, d.init) for k, d in MOE.moe_defs(tc).items()}
    assert got == want
