"""The port's attention ops (their plain versions, the CPU path) against
the JAX package's Pallas kernels run in interpret mode, on the same
inputs drawn with numpy, at the shapes of
`repro_torch.kernels.attention_cases` (the card tests' shapes).

Tolerances are those of `tests/test_kernels.py`: 2e-5 in float32 (the
two sum in different orders) and 2e-2 in bfloat16 (the output and the
probabilities are rounded to bf16's 8 bits; the TPU kernel keeps its
probabilities in float32, the plain version rounds them as the
reference's oracle does).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_blocks)
from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as jax_decode)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash)
from repro_torch.kernels import attention_cases as AC  # noqa: E402
from repro_torch.kernels.decode_attention import ops as D  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, decode_partials_ref)
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref)


def _both(x, dtype):
    """numpy float32 -> (jax array, torch tensor), both in ``dtype``
    (bf16 rounds to nearest even in both)."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t, np.float32))


def _jax_block(S):
    """The JAX kernel's tile for a sequence of S: a quarter of it, so that
    its online softmax crosses several KV tiles (the kernel shrinks the
    tile to a divisor of S)."""
    return max(32, S // 4)


@pytest.mark.parametrize("B,S,H,K,hd,causal,window,dtype", AC.FLASH_CASES)
def test_flash_op_matches_jax_kernel(B, S, H, K, hd, causal, window, dtype):
    rng = np.random.default_rng(0)
    qj, qt = _both(rng.standard_normal((B, S, H, hd), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((B, S, K, hd), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((B, S, K, hd), np.float32), dtype)
    want = jax_flash(qj, kj, vj, causal=causal, window=window,
                     block=_jax_block(S), interpret=True)
    got = FA.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **AC.tolerance(dtype))


def test_flash_op_is_the_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 64, 4, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 64, 2, 32), np.float32))
    got = FA.flash_attention(q, k, k, causal=True, window=16)
    assert torch.equal(got, attention_ref(q, k, k, causal=True, window=16))


def test_row_bar_holds_bf16_rounding_and_catches_a_dropped_kv_tile():
    """`attention_cases.ROW_REL_BAR`, which holds the flash kernel at the
    serving shape on the card: the float32 result rounded to bf16 is
    within it, and a result that lost one KV tile of 32 keys for the last
    64 query rows is not."""
    case = (1, 256, 4, 2, 128, True, None, "bfloat16")
    q, k, v = AC.flash_inputs(case, "cpu", seed=5)
    want = attention_ref(q.float(), k.float(), v.float())
    assert AC.row_rel_err(want.bfloat16(), want) <= AC.ROW_REL_BAR
    whole = AC.drop_kv_tile(q, k, v, slice(0, 0), slice(0, 0))
    assert AC.row_rel_err(whole, want) <= AC.ROW_REL_BAR
    for keys in (slice(224, 256), slice(128, 160)):
        bad = AC.drop_kv_tile(q, k, v, slice(192, 256), keys)
        assert AC.row_rel_err(bad, want) > 10 * AC.ROW_REL_BAR


def _decode_inputs(B, T, H, K, hd, pos, ring, seed=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd), np.float32)
    k = rng.standard_normal((B, T, K, hd), np.float32)
    v = rng.standard_normal((B, T, K, hd), np.float32)
    return q, k, v, AC.k_positions(T, pos, ring, "cpu").numpy()


@pytest.mark.parametrize("B,T,H,K,hd,pos,ring,chunk,dtype", AC.DECODE_CASES)
def test_decode_op_matches_jax_kernel(B, T, H, K, hd, pos, ring, chunk,
                                      dtype):
    q, k, v, k_pos = _decode_inputs(B, T, H, K, hd, pos, ring)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    # the JAX kernel shrinks its tile to a divisor of T
    want = jax_decode(qj, kj, vj, jnp.asarray(k_pos), pos,
                      block_k=chunk or 512, interpret=True)
    kp = torch.from_numpy(k_pos)
    got = D.decode_attention(qt, kt, vt, kp, pos, block_k=chunk)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **AC.tolerance(dtype))
    oracle = decode_attention_ref(qt, kt, vt, kp, pos)
    np.testing.assert_allclose(_np(got), _np(oracle), **AC.tolerance(dtype))


@pytest.mark.parametrize(
    "B,T,H,K,hd,pos,ring,chunk,dtype",
    [c for c in AC.DECODE_CASES if c[7] and c[1] % c[7] == 0])
def test_decode_partials_match_jax_kernel_blocks(B, T, H, K, hd, pos, ring,
                                                 chunk, dtype):
    """The kernel's contract, block for block: the plain partials equal
    the TPU kernel's (m, l, acc) where the split divides the cache."""
    q, k, v, k_pos = _decode_inputs(B, T, H, K, hd, pos, ring)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    jm, jl, jacc = decode_attention_blocks(
        qj[:, :, None], kj.transpose(0, 2, 1, 3), vj.transpose(0, 2, 1, 3),
        jnp.asarray(k_pos), pos, block_k=chunk, interpret=True)
    m, l, acc = decode_partials_ref(qt, kt, vt, torch.from_numpy(k_pos),
                                    pos, chunk)
    # float32 partials whatever the input type: summation order only
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), atol=1e-4,
                               rtol=2e-5)


def test_decode_split_invariance():
    """The result must not depend on the KV split (tests/test_kernels.py's
    property), including a ragged last split and the default split."""
    q, k, v, k_pos = _decode_inputs(1, 256, 4, 2, 32, 255, False, seed=3)
    t = [torch.from_numpy(a) for a in (q, k, v, k_pos)]
    outs = [D.decode_attention(*t, 255, block_k=b).numpy()
            for b in (256, 32, 64, 128, 96, None)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=1e-5, rtol=1e-5)


def test_decode_default_split_fills_the_card():
    from repro_torch.kernels.decode_attention.kernel import default_chunk
    # qwen3-8b serving: B 8 x 8 KV heads, 1,056 slots -> 4 splits of 288,
    # 256 blocks: about 2 on each of the 132 SMs
    assert default_chunk(8, 8, 1056) == 288
    assert default_chunk(1, 1, 100) == 32
    assert default_chunk(64, 8, 4096) == 4096
