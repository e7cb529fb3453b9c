"""The float32 route's arithmetic on the CPU: split TF32 ("tf32x3", the
tensor-core kernels ``flash_attention_tf32.cu`` and
``flash_attention_bwd_tf32.cu``) modelled by `ref.tf32_split`,
`ref.mm_tf32x3`, `ref.attention_tf32x3_ref` and
`ref.attention_tf32x3_bwd_ref`, held to the JAX package's
`repro.kernels.flash_attention.ref.attention_ref` and its `jax.vjp` on the
same inputs, drawn with numpy.

The cases: every float32 `attention_cases.FLASH_CASES` entry that the
route takes (head_dim a multiple of 8), and `FLASH_TRAIN_F32`'s heads and
head_dim (24 over 2 KV heads, 128, causal) at a CPU-sized length of 256.

Tolerances, and why: the forward at `attention_cases.tolerance("float32")`
(2e-5 absolute and relative, the card's bar for the kernels); the
backward at `attention_cases.BWD_F32_BAR` (1e-4) of each grad's largest
element, the card's bar. The split keeps about 22 bits a product; one TF32
product (hi hi only) keeps 11, and reads over the forward bar: the bar
would catch a kernel that dropped the correction terms.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as jax_attention_ref)
from repro_torch.kernels import attention_cases as AC  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402

LOW_BITS = (1 << FR.TF32_DROPPED_BITS) - 1

CASES = [c for c in AC.FLASH_CASES if c[-1] == "float32"
         and FK.route(torch.float32, c[4]) == "tf32x3"] + [
    (1, 256) + AC.FLASH_TRAIN_F32[2:]]


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy().astype(np.int64) \
        & 0xFFFFFFFF


def _values(kind: str) -> torch.Tensor:
    """float32 values of one kind: normals over the exponent range,
    subnormals, signed zeros, and ties (exactly half a TF32 unit past a
    TF32 value)."""
    rng = np.random.default_rng(7)
    if kind == "normal":
        m = rng.uniform(1, 2, 20000) * rng.choice([-1, 1], 20000)
        x = np.ldexp(m, rng.integers(-125, 127, 20000))
    elif kind == "subnormal":
        x = rng.integers(1, 1 << 23, 20000) * 2.0 ** -149
        x *= rng.choice([-1, 1], 20000)
    elif kind == "zero":
        x = np.array([0.0, -0.0])
    else:  # ties: 11 significant bits and a 1 in the 12th
        m = (rng.integers(1 << 10, 1 << 11, 20000) * 2 + 1) * 2.0 ** -11
        x = np.ldexp(m * rng.choice([-1, 1], 20000),
                     rng.integers(-100, 100, 20000))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "subnormal", "zero", "tie"])
def test_tf32_split_keeps_22_bits(kind):
    """hi and lo hold TF32 values (their low 13 mantissa bits are zero);
    hi is x rounded to nearest, ties away from zero; x - hi is exact in
    float32, so hi + (x - hi) == x bit for bit; lo, x - hi rounded to TF32,
    is at most 2^-11 |x|, and hi + lo is within 2^-22 |x| of x (in the
    subnormals, within half a TF32 unit there, 2^-137). hi + lo itself is
    not x bit for bit: x - hi may need 13 significant bits, lo keeps 11."""
    x = _values(kind)
    hi, lo = FR.tf32_split(x)
    assert hi.dtype == lo.dtype == torch.float32
    assert not (_bits(hi) & LOW_BITS).any()
    assert not (_bits(lo) & LOW_BITS).any()
    x64 = x.double()
    # hi against a rounding done in float64 with frexp
    m, e = np.frexp(np.abs(x64.numpy()))
    want = np.sign(x64.numpy()) * np.ldexp(np.floor(m * 2 ** 11 + 0.5),
                                           e - 11)
    if kind != "subnormal":
        np.testing.assert_array_equal(hi.double().numpy(), want)
    assert torch.equal(hi + (x - hi), x)
    assert torch.equal(torch.signbit(hi[x == 0]), torch.signbit(x[x == 0]))
    assert bool((lo.double().abs() <= 2.0 ** -11 * x64.abs()).all())
    err = (x64 - hi.double() - lo.double()).abs()
    assert bool((err <= torch.clamp(2.0 ** -22 * x64.abs(),
                                    min=2.0 ** -137)).all())


def test_tf32_split_rounds_ties_away_from_zero():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                      1 + 2 ** -11 - 2 ** -23])
    hi, _ = FR.tf32_split(x)
    assert hi.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0]


def test_mm_tf32x3_holds_float32_where_one_tf32_product_does_not():
    """On 256 x 128 by 128 x 256 products of normal values, the split is
    within 2^-19 of sum |a b| of the float64 product; one TF32 product is
    not within 2^-13."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32))
    want = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    three = (FR.mm_tf32x3(a, b).double() - want).abs() / scale
    one = (FR.mm_tf32x3(a, b, terms=1).double() - want).abs() / scale
    assert float(three.max()) < 2 ** -19
    assert float(one.max()) > 2 ** -13


def _inputs(case, seed=0):
    B, S, H, K, hd = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd),
                      (B, S, H, hd))]


def _reference(case, arrs):
    """The JAX reference's o and its VJP's (dq, dk, dv) at cotangent g."""
    causal, window = case[5:7]
    q, k, v, g = (jnp.asarray(a) for a in arrs)
    o, vjp = jax.vjp(lambda q, k, v: jax_attention_ref(
        q, k, v, causal=causal, window=window), q, k, v)
    return np.asarray(o), [np.asarray(x) for x in vjp(g)]


def _model(case, arrs, terms=3):
    causal, window = case[5:7]
    q, k, v, g = (torch.from_numpy(a) for a in arrs)
    o, lse = FR.attention_tf32x3_ref(q, k, v, causal=causal, window=window,
                                     terms=terms)
    grads = FR.attention_tf32x3_bwd_ref(q, k, v, o, lse, g, causal=causal,
                                        window=window, terms=terms)
    return o.numpy(), [x.numpy() for x in grads]


def _grad_errs(got, want):
    return [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(got, want)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_model_holds_the_float32_bars(case):
    """The split model's forward within 2e-5 of the JAX reference, its
    backward (on its own o and lse) within 1e-4 of each grad's largest
    element of the reference's VJP."""
    arrs = _inputs(case)
    o_ref, g_ref = _reference(case, arrs)
    o, grads = _model(case, arrs)
    assert o.shape == o_ref.shape and o.dtype == np.float32
    np.testing.assert_allclose(o, o_ref, **AC.tolerance("float32"))
    for got, want in zip(grads, g_ref):
        assert got.shape == want.shape
    errs = _grad_errs(grads, g_ref)
    assert max(errs) <= AC.BWD_F32_BAR, errs


def test_one_tf32_product_reads_over_the_bars():
    """hi hi alone (one TF32 product, 11 bits) misses the forward's 2e-5
    bar and the backward's 1e-4 on at least one case, by a margin; the
    split does not (`test_split_model_holds_the_float32_bars`)."""
    fwd, bwd = [], []
    for case in CASES:
        arrs = _inputs(case)
        o_ref, g_ref = _reference(case, arrs)
        o1, g1 = _model(case, arrs, terms=1)
        tol = AC.tolerance("float32")
        excess = np.abs(o1 - o_ref) / (tol["atol"] + tol["rtol"]
                                       * np.abs(o_ref))
        fwd.append(float(excess.max()))
        bwd.append(max(_grad_errs(g1, g_ref)) / AC.BWD_F32_BAR)
    assert max(fwd) > 2.0 and max(bwd) > 2.0, (fwd, bwd)
