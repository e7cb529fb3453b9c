"""The port's selective scan and Mamba block against the JAX package, on
the CPU (the kernel's plain version; the CUDA kernel itself is held to it
on the card in tests/test_torch_cuda.py).

Inputs come from a seed (`repro_torch.kernels.selective_scan.cases`, or
numpy) and go to both packages as numpy arrays; Mamba parameters are the
reference's, carried across by `params_from_reference`.

Tolerances, and why: float32 2e-5 absolute and relative, the reference
kernel tests' own bar (both sides compute in float32; sums over the
state and the matmuls run in other orders); bfloat16 outputs 2e-2, the
reference tests' bar for a result rounded to bf16's 8 bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.kernels.selective_scan.ops import selective_scan as jscan  # noqa: E402
from repro.kernels.selective_scan.ref import selective_scan_ref as jscan_ref  # noqa: E402
from repro.models import ApplyOptions as JOpts  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels.selective_scan import cases as SC  # noqa: E402
from repro_torch.kernels.selective_scan import ops  # noqa: E402
from repro_torch.kernels.selective_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.models import ApplyOptions  # noqa: E402
from repro_torch.models import mamba as MB  # noqa: E402

F32 = dict(atol=2e-5, rtol=2e-5)
IMPLS = ["chunked", "cuda"]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else F32


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(t):
    a = jnp.asarray(_np(t))
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SC.SCAN_CASES + SC.SCAN_RAGGED
                         + SC.SCAN_STEPS + [SC.SCAN_LONG], ids=str)
def test_selective_scan_ref_matches_jax(case):
    """y of the plain version against the reference's oracle at every
    shape the CUDA kernel is held to (the decode steps from a zero state:
    the reference takes none), and against its Pallas kernel in interpret
    mode on tests/test_kernels.py's shapes, which carry its ``block_d``
    and ``chunk``."""
    dtype = case[4]
    x, dt, A, Bc, Cc, D, _ = SC.scan_inputs(case, "cpu", seed=4)
    y, h = selective_scan_ref(x, dt, A, Bc, Cc, D)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert h.dtype == torch.float32 and h.shape == (x.shape[0], x.shape[2],
                                                    A.shape[1])
    args = [_jnp(t) for t in (x, dt, A, Bc, Cc, D)]
    refs = [jscan_ref(*args)]
    if len(case) > 5:
        block_d, chunk = case[5:]
        refs.append(jscan(*args, block_d=block_d, chunk=chunk,
                          interpret=True))
    for ref in refs:
        np.testing.assert_allclose(_np(y), np.asarray(ref, np.float32),
                                   **_tol(dtype))
    # the op takes the plain version on CPU tensors
    y2, h2 = ops.selective_scan(x, dt, A, Bc, Cc, D)
    assert torch.equal(y2, y) and torch.equal(h2, h)


def test_selective_scan_state_decay_property():
    """tests/test_kernels.py's property: with dt large and A << 0 the
    history is forgotten, y_s = N dt x_s; the reference's kernel agrees."""
    B, S, d, N = 1, 32, 16, 4
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, S, d), np.float32))
    dt = torch.full((B, S, d), 20.0)
    A = -torch.ones((d, N)) * 5.0
    Bc = torch.ones((B, S, N))
    Cc = torch.ones((B, S, N))
    D = torch.zeros((d,))
    y, _ = selective_scan_ref(x, dt, A, Bc, Cc, D)
    np.testing.assert_allclose(y.numpy(), N * 20.0 * x.numpy(), rtol=1e-3)
    kern = jscan(*(_jnp(t) for t in (x, dt, A, Bc, Cc, D)), block_d=8,
                 chunk=8, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(kern), **F32)


def test_selective_scan_splits_at_any_step():
    """Scanning S steps equals scanning the first s steps and then the
    rest from their final state: what prefill + decode rely on."""
    x, dt, A, Bc, Cc, D, h0 = SC.scan_inputs((2, 40, 24, 5, "float32"),
                                             "cpu", seed=6, with_h0=True)
    y, h = selective_scan_ref(x, dt, A, Bc, Cc, D, h0)
    y1, h1 = selective_scan_ref(x[:, :17], dt[:, :17], A, Bc[:, :17],
                                Cc[:, :17], D, h0)
    y2, h2 = selective_scan_ref(x[:, 17:], dt[:, 17:], A, Bc[:, 17:],
                                Cc[:, 17:], D, h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, **F32)
    torch.testing.assert_close(h2, h, **F32)


def test_selective_scan_refuses_other_devices():
    x, dt, A, Bc, Cc, D, _ = SC.scan_inputs((1, 4, 8, 4, "float32"), "meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.selective_scan(x, dt, A, Bc, Cc, D)


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """Reduced jamba's first Mamba block (reference parameters, random
    a_log, d_skip and dt_bias so that every parameter matters), its
    configs and an input."""
    jc = jcfg.reduced(jcfg.get_config("jamba-v0.1-52b"))
    tc = tcfg.reduced(tcfg.get_config("jamba-v0.1-52b"))
    params = jinit(jc, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(lambda t: t[0], params["blocks"][0])["mix"]
    rng = np.random.default_rng(9)
    p = dict(p)
    d_in, N = p["a_log"].shape
    p["a_log"] = jnp.asarray(np.log(np.arange(1, N + 1, dtype=np.float32)
                                    * rng.uniform(0.5, 2.0, (d_in, N))
                                    ).astype(np.float32))
    p["d_skip"] = jnp.asarray(rng.standard_normal(d_in).astype(np.float32))
    p["dt_bias"] = jnp.asarray(0.5 * rng.standard_normal(d_in)
                               .astype(np.float32))
    x = rng.standard_normal((2, 24, jc.d_model)).astype(np.float32)
    return jc, tc, p, params_from_reference(p, "cpu"), x


@pytest.mark.parametrize("impl", IMPLS)
def test_mamba_apply_matches_jax(block, impl):
    jc, tc, jp, tp, x = block
    want = JMB.mamba_apply(jc, JOpts(), jp, jnp.asarray(x))
    got = MB.mamba_apply(tc, ApplyOptions(scan_impl=impl), tp,
                         torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("impl", IMPLS)
def test_mamba_prefill_matches_jax(block, impl):
    """The output, the conv state and the final ssm state of a prompt: on
    the "cuda" route (the plain scan on the CPU) that state is the scan's
    h_last."""
    jc, tc, jp, tp, x = block
    want, wc = JMB.mamba_prefill(jc, JOpts(), jp, jnp.asarray(x))
    got, gc = MB.mamba_prefill(tc, ApplyOptions(scan_impl=impl), tp,
                               torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert gc["ssm"].dtype == torch.float32
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]), **F32)


@pytest.mark.parametrize("impl", IMPLS)
def test_mamba_decode_matches_jax(block, impl):
    """Three decode steps from a prompt's states: the output and both new
    states, which the port writes into the cache tensors in place. On the
    "cuda" route each step is the plain scan at S = 1 from h0 = the
    cached state."""
    jc, tc, jp, tp, x = block
    P = 20
    _, wc = JMB.mamba_prefill(jc, JOpts(), jp, jnp.asarray(x[:, :P]))
    opts = ApplyOptions(scan_impl=impl)
    _, gc = MB.mamba_prefill(tc, opts, tp, torch.from_numpy(x[:, :P]))
    conv, ssm = gc["conv"], gc["ssm"]
    for j in range(P, P + 3):
        step = x[:, j:j + 1]
        want, wc = JMB.mamba_decode(jc, JOpts(), jp, jnp.asarray(step), wc,
                                    jnp.int32(j))
        got, gc = MB.mamba_decode(tc, opts, tp, torch.from_numpy(step), gc,
                                  j)
        assert gc["conv"] is conv and gc["ssm"] is ssm  # in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                       **F32)


def test_chunked_scan_survives_decay_underflow():
    """With A = -(1..16) (the init) and dt ~ 1, the product of a 256-step
    chunk's decays underflows to 0; the log-depth scan divides by nothing,
    so it stays finite and equal to the sequential plain version."""
    cfg = tcfg.get_config("jamba-v0.1-52b")  # chunk 256
    B, S, d, N = 1, 512, 8, 16
    x, dt, _, Bc, Cc, D, _ = SC.scan_inputs((B, S, d, N, "float32"), "cpu",
                                            seed=3)
    dt = dt + 1.0
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(d, N)
    assert float(torch.exp(dt[:, :256, :, None] * A).prod(1).min()) == 0.0
    y, h = MB._chunked_scan(cfg, x, dt, A, Bc, Cc)
    want_y, want_h = selective_scan_ref(x, dt, A, Bc, Cc, torch.zeros(d))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, want_y, **F32)
    torch.testing.assert_close(h, want_h, **F32)
