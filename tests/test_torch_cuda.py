"""The closed-loop CUDA kernel against its plain PyTorch version, on the
card. Every test here needs a CUDA device and skips without one; the
file imports no jax, so it runs where only torch is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance, and why: `repro_torch.kernels.closed_loop.parity` —
ulp-level differences between the kernel's and PyTorch's float paths
can flip a heartbeat count by one, so counts and masks must be equal,
at least 99.9% of progress entries equal (rtol 1e-5), caps within
1e-2 W, integrals within rtol 1e-5, and histogram totals equal with at
most 2 counts moved per run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import sim  # noqa: E402
from repro_torch.kernels.closed_loop import kernel as K  # noqa: E402
from repro_torch.kernels.closed_loop import ops  # noqa: E402
from repro_torch.kernels.closed_loop import ref as R  # noqa: E402
from repro_torch.kernels.closed_loop import parity as P  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("collect", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("profiles,reps,max_time,total_work",
                         P.CARD_CASES)
def test_kernel_matches_plain_version(dev, profiles, reps, max_time,
                                      total_work, collect, dtype):
    prof, gains, _ = sim.grid_rows(list(profiles) * reps, [0.1], [0])
    prof = prof.to(dev, getattr(torch, dtype))
    gains = gains.to(dev, getattr(torch, dtype))
    B = prof.shape[0]
    noise = ops.draw_noise(torch.arange(B, device=dev), ops.horizon(
        max_time, 1.0))
    sc = (total_work, max_time, 1.0, P.CARD_SUMMARY_FROM)
    before = K.LAUNCHES
    tk, blocks = K.closed_loop_cuda(prof, gains, noise, sc, collect)
    assert K.LAUNCHES == before + 1
    torch.cuda.synchronize()
    tp, fp = R.closed_loop_ref(prof, gains, noise, *sc, collect=collect)
    P.check_parity(tk, K.unpack_final(*blocks), tp, fp)


def test_summary_mode_equals_trace_mode(dev):
    prof, gains, seeds = sim.grid_rows(["gros", "yeti"], [0.0, 0.2],
                                       range(40))
    prof, gains = prof.to(dev), gains.to(dev)
    noise = ops.draw_noise(seeds.to(dev), 256)
    sc = (4000.0, 256.0, 1.0, 30.0)
    _, a = K.closed_loop_cuda(prof, gains, noise, sc, collect=True)
    _, b = K.closed_loop_cuda(prof, gains, noise, sc, collect=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sweep_on_the_card_matches_the_cpu(dev):
    """The same grid through both devices: the noise streams' integer
    bits agree, their floats to an ulp, so the runs agree at the parity
    bar."""
    kw = dict(total_work=2000.0, max_time=256.0, summary_warmup=10)
    seeds = range(12)
    noise_c = ops.draw_noise(torch.arange(12), 256)
    noise_g = ops.draw_noise(torch.arange(12, device=dev), 256)
    torch.testing.assert_close(noise_g.cpu(), noise_c, rtol=1e-5,
                               atol=1e-5)
    before = K.LAUNCHES
    g = sim.sweep(["gros", "dahu"], [0.0, 0.1], seeds, **kw, device=dev)
    assert K.LAUNCHES == before + 1
    c = sim.sweep(["gros", "dahu"], [0.0, 0.1], seeds, **kw, device="cpu")
    np.testing.assert_array_equal(g.n_steps, c.n_steps)
    np.testing.assert_array_equal(g.exec_time, c.exec_time)
    np.testing.assert_array_equal(g.traces["valid"], c.traces["valid"])
    for k in ("energy", "work"):
        np.testing.assert_allclose(getattr(g, k), getattr(c, k), rtol=1e-5)
    for k in ("progress_mean", "power_mean"):
        np.testing.assert_allclose(g.summary[k], c.summary[k], rtol=1e-5)
    for k in ("progress_hist", "pcap_hist"):
        np.testing.assert_array_equal(g.summary[k].sum(-1),
                                      c.summary[k].sum(-1))
    same = np.isclose(g.traces["progress"], c.traces["progress"],
                      rtol=1e-5, atol=0.0)
    assert same.mean() >= 0.999
    assert np.abs(g.traces["pcap"] - c.traces["pcap"]).max() <= 1e-2


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    prof, gains, seeds = sim.grid_rows(["gros"], [0.1], range(4))
    prof, gains = prof.to(dev), gains.to(dev)
    noise = ops.draw_noise(seeds.to(dev), 64)
    sc = (1e9, 64.0, 1.0, 0.0)
    with pytest.raises(TypeError):
        K.closed_loop_cuda(prof.double(), gains.double(), noise, sc)
    with pytest.raises(TypeError):
        K.closed_loop_cuda(prof, gains.bfloat16(), noise, sc)
    with pytest.raises(ValueError, match="contiguous"):
        K.closed_loop_cuda(prof, gains, noise.transpose(0, 1).contiguous()
                           .transpose(0, 1), sc)
    with pytest.raises(ValueError, match="shape"):
        K.closed_loop_cuda(prof, gains, noise[:, :4], sc)
    with pytest.raises(ValueError):
        K.closed_loop_cuda(prof, gains.cpu(), noise, sc)
