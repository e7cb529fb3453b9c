"""The flash backward's plain versions against the JAX package on the CPU:
`ref.attention_lse_ref` (the rows' log-sum-exp the forward kernels write)
against a float64 numpy log-sum-exp of the masked scores, and
`ref.attention_bwd_ref` (the FlashAttention-2 backward the CUDA kernels
are held to on the card) against `jax.vjp` of the reference's flash op
(its Pallas forward in interpret mode, its recompute VJP) on the same
(q, k, v, g); plus the CPU-side parts of the backward's wrapper and op.

The cases are `attention_cases.FLASH_CASES` cut to CPU size (`_cut`):
G = 1, 2, 3 and 4, causal and not, a window under a tile, a two-sided
(non-causal) window, ragged S, hd 48 and 120; and one case with G = 8.

Tolerances, and why:
- lse: 1e-5 absolute and relative (float32 scores against float64).
- float32 grads: 1e-4 absolute and relative, the bar of the existing
  grad test (`tests/test_torch_train.py::
  test_flash_attention_grads_match_reference`): summation order only.
- bfloat16 grads: relative L2 within 1e-2 of the reference's. Both round
  the inputs' products to float32 and the grads once to bf16 (about 2e-3
  of each element); the reference's VJP also rounds its cotangents to
  bf16 at the casts of its forward (p.astype(v.dtype), o.astype), which
  the plain backward does not: the two read at most 5e-3 apart here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jflash  # noqa: E402
from repro_torch.kernels import attention_cases as AC  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402

BF16_REL_L2 = 1e-2


def _cut(case):
    """A FLASH_CASES entry at CPU size: batch at most 2, S at most 96
    (ragged lengths stay ragged against the kernels' 64-row tiles), at
    most 2 KV heads with the case's G query heads each, hd and the mask
    as they are."""
    B, S, H, K, hd, causal, window, dtype = case
    G = H // K
    K2 = min(K, 2)
    S2 = S if S <= 96 else (75 if S % 64 else 96)
    return (min(B, 2), S2, G * K2, K2, hd, causal, window, dtype)


CASES = sorted({_cut(c) for c in AC.FLASH_CASES}, key=str) + [
    (1, 64, 8, 1, 32, True, None, "float32"),    # G = 8
    (1, 64, 8, 1, 32, True, None, "bfloat16"),
]


def _inputs(case, seed=0):
    B, S, H, K, hd, _, _, dtype = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd),
                      (B, S, H, hd))]
    tdt = getattr(torch, dtype)
    # the bf16 values both packages see: numpy float32 rounded by torch
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    js = [jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
          for t in ts]
    return ts, js


def _masked_scores64(q, k, causal, window):
    q, k = q.double().numpy(), k.double().numpy()
    B, S, H, hd = q.shape
    T, G = k.shape[1], H // k.shape[2]
    k = np.repeat(k, G, axis=2)
    s = np.einsum("bqhd,bthd->bhqt", q, k) * hd ** -0.5
    qpos, kpos = np.arange(S)[:, None], np.arange(T)[None, :]
    mask = np.ones((S, T), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return np.where(mask, s, -np.inf)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_lse_ref_matches_float64_logsumexp(case):
    (q, k, v, _), _ = _inputs(case)
    causal, window = case[5:7]
    o, lse = FR.attention_lse_ref(q, k, v, causal=causal, window=window)
    s = _masked_scores64(q, k, causal, window)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(o, FR.attention_ref(q, k, v, causal=causal,
                                           window=window))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_ref_matches_reference_vjp(case):
    """`attention_bwd_ref`, fed the plain forward's o and lse, against the
    reference op's VJP (the cotangent g the same)."""
    (q, k, v, g), (jq, jk, jv, jg) = _inputs(case)
    causal, window, dtype = case[5:]
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, causal=causal,
                                            window=window, interpret=True),
                     jq, jk, jv)
    want = vjp(jg)
    o, lse = FR.attention_lse_ref(q, k, v, causal=causal, window=window)
    got = FR.attention_bwd_ref(q, k, v, o, lse, g, causal=causal,
                               window=window)
    for name, a, b, x in zip("qkv", got, want, (q, k, v)):
        assert a.dtype == x.dtype and a.shape == x.shape
        a32, b32 = a.float().numpy(), np.asarray(b, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(a32, b32, atol=1e-4, rtol=1e-4,
                                       err_msg=f"d{name}")
        else:
            assert _rel_l2(a32, b32) <= BF16_REL_L2, f"d{name}"


@pytest.mark.parametrize("case", [c for c in CASES if c[-1] == "float32"],
                         ids=str)
def test_bwd_ref_matches_the_cpu_op(case):
    """The op's CPU backward (the reference's recompute, unchanged)
    against `attention_bwd_ref`: the same function in another summation
    order; the op never enters the CUDA backward on a CPU tensor. The
    bar, 1e-5 absolute and relative, is 2.9 times the largest reading
    over these cases at seeds 1 and 10-29, torch threads 1-8 and inputs
    stored at shifted offsets (0.35 of the bar, dq at seed 19; each
    reading the same at every thread count)."""
    (q, k, v, g), _ = _inputs(case, seed=1)
    causal, window = case[5:7]
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    before = FK.BWD_LAUNCHES
    o = FO.flash_attention(*qkv, causal=causal, window=window)
    got = torch.autograd.grad(o, qkv, g)
    assert FK.BWD_LAUNCHES == before
    o2, lse = FR.attention_lse_ref(q, k, v, causal=causal, window=window)
    want = FR.attention_bwd_ref(q, k, v, o2, lse, g, causal=causal,
                                window=window)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_bwd_ref_sums_the_query_heads_of_each_kv_head():
    """dk and dv of a GQA call are those of the same call with K/V
    repeated to every head, summed over each KV head's G heads."""
    case = (1, 48, 6, 2, 16, True, 20, "float32")
    (q, k, v, g), _ = _inputs(case, seed=2)
    o, lse = FR.attention_lse_ref(q, k, v, causal=True, window=20)
    dq, dk, dv = FR.attention_bwd_ref(q, k, v, o, lse, g, window=20)
    kr, vr = (x.repeat_interleave(3, dim=2) for x in (k, v))
    dq1, dk1, dv1 = FR.attention_bwd_ref(q, kr, vr, o, lse, g, window=20)
    torch.testing.assert_close(dq, dq1, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dk, dk1.reshape(1, 48, 2, 3, 16).sum(3),
                               atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dv, dv1.reshape(1, 48, 2, 3, 16).sum(3),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 120, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, 36, "simt"), (torch.float32, 128, "tf32x3"),
    (torch.float32, 48, "tf32x3"), (torch.float32, 20, "simt")])
def test_bwd_route_follows_the_forward_route(dtype, hd, want):
    assert FK.bwd_route(dtype, hd) == want
    assert FK.route(dtype, hd) == want


@pytest.mark.parametrize("B,K,T,G,want", [
    (4, 2, 2048, 12, 2),     # starcoder2-3b's training shape: 128 blocks
    (4, 24, 2048, 1, 1),     # its head-TP layout (K/V repeated): G = 1
    (2, 2, 128, 2, 2),       # a small case: every group its own block
    (8, 8, 1024, 4, 1),      # 512 blocks fill the card
    (1, 2, 2048, 12, 6),     # starcoder2-3b at batch 1: 32 blocks
    (1, 1, 64, 7, 7)])       # nothing divides: one head a group
def test_head_split_fills_the_card(B, K, T, G, want):
    """`g_split` on a 132-SM card: the least divisor of G that gives at
    least one wave of its 128-key blocks, one a multiprocessor."""
    got = FK.g_split(B, K, T, G, 132)
    assert got == want and G % got == 0


@pytest.mark.parametrize("B,K,T,G,want", [
    (4, 2, 2048, 12, 1),     # starcoder2-3b's training shape: 256 blocks
    (1, 2, 2048, 12, 3),     # at batch 1: 64 blocks
    (2, 2, 128, 2, 2)])      # a small case: every group its own block
def test_head_split_counts_the_split_tf32_tile(B, K, T, G, want):
    """On the split-TF32 route a dK / dV block owns 64 keys
    (`BWD_TF32_TILE`), so `g_split` counts twice the bf16 route's blocks."""
    got = FK.g_split(B, K, T, G, 132, FK.BWD_TF32_TILE)
    assert got == want and G % got == 0


def test_bwd_wrapper_refuses_cpu_tensors():
    (q, k, v, g), _ = _inputs((1, 64, 4, 2, 32, True, None, "float32"))
    lse = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        FK.flash_attention_bwd_cuda(q, k, v, q, lse, g)
