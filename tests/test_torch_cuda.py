"""The CUDA kernels against their plain PyTorch versions, on the card:
the closed-loop kernel, flash attention (both routes) and split-KV decode
attention (the attention bar is `repro_torch.kernels.attention_cases`), the
selective scan (its bar is `repro_torch.kernels.selective_scan.cases`),
and the serving paths through them; then the paper's identification and
evaluation path on the card (the scan engine, the Poisson sampler, the
static fit). Every test here needs a CUDA device and
skips without one; the file imports no jax, so it runs where only torch
is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Closed-loop tolerance, and why: `repro_torch.kernels.closed_loop.parity` —
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
from repro_torch.kernels import attention_cases as AC  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as DK  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DO  # noqa: E402
from repro_torch.kernels.decode_attention import ref as DR  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402
from repro_torch.kernels.selective_scan import cases as SC  # noqa: E402
from repro_torch.kernels.selective_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.selective_scan import ops as SO  # noqa: E402
from repro_torch.kernels.selective_scan import ref as SR  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launch(route, prof, gains, seeds, T, sc, collect):
    """One launch of the kernel on ``route``: "seeds" generates the noise
    of ``seeds`` inside the kernel, "noise" reads `draw_noise` of them."""
    if route == "seeds":
        return K.closed_loop_seeds_cuda(prof, gains, seeds, T, sc, collect)
    return K.closed_loop_cuda(prof, gains, ops.draw_noise(seeds, T), sc,
                              collect)


@pytest.mark.parametrize("route", ["seeds", "noise"])
@pytest.mark.parametrize("collect", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("profiles,reps,max_time,total_work",
                         P.CARD_CASES)
def test_kernel_matches_plain_version(dev, profiles, reps, max_time,
                                      total_work, collect, dtype, route):
    """Both noise routes against `draw_noise` + the plain version, each
    launch counted once in `LAUNCHES` and once in its route's count."""
    prof, gains, _ = sim.grid_rows(list(profiles) * reps, [0.1], [0])
    prof = prof.to(dev, getattr(torch, dtype))
    gains = gains.to(dev, getattr(torch, dtype))
    B = prof.shape[0]
    T = ops.horizon(max_time, 1.0)
    seeds = torch.arange(B, device=dev)
    sc = (total_work, max_time, 1.0, P.CARD_SUMMARY_FROM)
    before, routes = K.LAUNCHES, dict(K.ROUTE_LAUNCHES)
    tk, blocks = _launch(route, prof, gains, seeds, T, sc, collect)
    assert K.LAUNCHES == before + 1
    assert K.ROUTE_LAUNCHES[route] == routes[route] + 1
    assert sum(K.ROUTE_LAUNCHES.values()) == sum(routes.values()) + 1
    torch.cuda.synchronize()
    tp, fp = R.closed_loop_ref(prof, gains, ops.draw_noise(seeds, T), *sc,
                               collect=collect)
    P.check_parity(tk, K.unpack_final(*blocks), tp, fp)


@pytest.mark.parametrize("route", ["seeds", "noise"])
def test_summary_mode_equals_trace_mode(dev, route):
    prof, gains, seeds = sim.grid_rows(["gros", "yeti"], [0.0, 0.2],
                                       range(40))
    prof, gains, seeds = prof.to(dev), gains.to(dev), seeds.to(dev)
    sc = (4000.0, 256.0, 1.0, 30.0)
    _, a = _launch(route, prof, gains, seeds, 256, sc, True)
    _, b = _launch(route, prof, gains, seeds, 256, sc, False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_seeds_route_sub_grid_equals_one_shot(dev):
    """Each run's stream depends on its seed alone: a sub-grid of the
    runs, in another order, reproduces their one-shot rows bit for bit."""
    prof, gains, seeds = sim.grid_rows(["gros", "dahu", "yeti"],
                                       [0.0, 0.1, 0.3], range(50))
    prof, gains, seeds = prof.to(dev), gains.to(dev), seeds.to(dev)
    sc = (3000.0, 320.0, 1.0, 10.0)
    tr, blk = K.closed_loop_seeds_cuda(prof, gains, seeds, 320, sc, True)
    pick = torch.arange(prof.shape[0] - 1, 0, -7, device=dev)
    tr_s, blk_s = K.closed_loop_seeds_cuda(prof[pick], gains[pick],
                                           seeds[pick], 320, sc, True)
    for a, b in zip(blk, blk_s):
        assert torch.equal(a[:, pick], b)
    for k in tr:
        assert torch.equal(tr[k][:, pick], tr_s[k])


def test_seeds_route_wide_bins_equal_narrow_bins(dev):
    """A horizon of 65,536 steps takes 32-bit histogram counters: runs
    that finish early give the same outputs as under a short horizon
    (16-bit counters), bit for bit."""
    prof, gains, seeds = sim.grid_rows(["gros", "yeti"], [0.1], range(70))
    prof, gains, seeds = prof.to(dev), gains.to(dev), seeds.to(dev)
    assert (K.bin_bits(128), K.bin_bits(65536)) == (16, 32)
    _, short = K.closed_loop_seeds_cuda(prof, gains, seeds, 128,
                                        (150.0, 128.0, 1.0, 2.0), False)
    _, wide = K.closed_loop_seeds_cuda(prof, gains, seeds, 65536,
                                       (150.0, 65536.0, 1.0, 2.0), False)
    fs, fw = K.unpack_final(*short), K.unpack_final(*wide)
    assert bool((fs["done"] == 1).all())  # every run finished by work
    for k in fs:
        assert torch.equal(fs[k], fw[k]), k


def test_written_out_cosine_equals_cosf(dev):
    """The kernel's Box-Muller cosine equals libdevice's cosf at all 2^24
    arguments the generator gives it."""
    assert K.cos_mismatches(dev) == 0


def test_fused_instance_holds_the_main_grid_in_one_wave(dev):
    res = K.resources(torch.float32, True, False, K.bin_bits(2048), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert res["local_bytes"] == 0
    assert res["blocks_per_sm"] * res["block_threads"] * sms >= 3 * 11 * 3072


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
    before, routes = K.LAUNCHES, dict(K.ROUTE_LAUNCHES)
    g = sim.sweep(["gros", "dahu"], [0.0, 0.1], seeds, **kw, device=dev)
    assert K.LAUNCHES == before + 1
    assert K.ROUTE_LAUNCHES == {"seeds": routes["seeds"] + 1,
                                "noise": routes["noise"]}
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


def test_seeds_wrapper_rejects_what_the_kernel_does_not_take(dev):
    prof, gains, seeds = sim.grid_rows(["gros"], [0.1], range(4))
    prof, gains, seeds = prof.to(dev), gains.to(dev), seeds.to(dev)
    sc = (1e9, 64.0, 1.0, 0.0)
    before = K.LAUNCHES
    with pytest.raises(TypeError):
        K.closed_loop_seeds_cuda(prof, gains, seeds.int(), 64, sc)
    with pytest.raises(TypeError):
        K.closed_loop_seeds_cuda(prof, gains, seeds.double(), 64, sc)
    with pytest.raises(ValueError, match="is on cpu"):
        K.closed_loop_seeds_cuda(prof, gains, seeds.cpu(), 64, sc)
    with pytest.raises(ValueError, match="contiguous"):
        K.closed_loop_seeds_cuda(prof, gains,
                                 torch.stack([seeds, seeds], 1)[:, 0], 64,
                                 sc)
    with pytest.raises(ValueError, match="shape"):
        K.closed_loop_seeds_cuda(prof, gains, seeds[:3], 64, sc)
    assert K.LAUNCHES == before


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", AC.FLASH_CASES + [AC.FLASH_SERVE,
                                                   AC.FLASH_SERVE_F32],
                         ids=str)
def test_flash_kernel_matches_plain_version(dev, case):
    """Every case through the kernel `route` names (bf16: the tensor-core
    kernel, float32: the SIMT one), counted once in `LAUNCHES` and once in
    that route's count."""
    causal, window, dtype = case[5], case[6], case[7]
    q, k, v = AC.flash_inputs(case, dev)
    path = FK.route(q.dtype, q.shape[-1])
    assert path == ("wgmma" if dtype == "bfloat16" else "simt")
    before, routes = FK.LAUNCHES, dict(FK.ROUTE_LAUNCHES)
    got = FK.flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert FK.LAUNCHES == before + 1
    assert FK.ROUTE_LAUNCHES[path] == routes[path] + 1
    assert sum(FK.ROUTE_LAUNCHES.values()) == sum(routes.values()) + 1
    torch.cuda.synchronize()
    want = FR.attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **AC.tolerance(dtype))


def test_flash_kernel_rows_at_the_serving_shape(dev):
    """bf16 at the serving shape through the tensor-core kernel, row by row
    against the float32 plain version on the same inputs
    (`attention_cases.ROW_REL_BAR`)."""
    causal, window = AC.FLASH_SERVE[5:7]
    q, k, v = AC.flash_inputs(AC.FLASH_SERVE, dev)
    before = FK.ROUTE_LAUNCHES["wgmma"]
    got = FK.flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert FK.ROUTE_LAUNCHES["wgmma"] == before + 1
    want = FR.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                            window=window)
    assert AC.row_rel_err(got, want) <= AC.ROW_REL_BAR


@pytest.mark.parametrize("case", AC.DECODE_CASES + [AC.DECODE_SERVE],
                         ids=str)
def test_decode_kernel_matches_plain_version(dev, case):
    """The partials against `ref.decode_partials_ref` and the combined
    output against `ops.combine` of them, from one counted call."""
    q, k, v, k_pos, pos, chunk = AC.decode_inputs(case, dev)
    chunk = chunk or DK.default_chunk(q.shape[0], k.shape[2], k.shape[1])
    before = DK.LAUNCHES
    o, (m, l, acc) = DK.decode_attention_cuda(q, k, v, k_pos, pos, chunk)
    assert DK.LAUNCHES == before + 1
    torch.cuda.synchronize()
    mr, lr, ar = DR.decode_partials_ref(q, k, v, k_pos, pos, chunk)
    # float32 partials whatever the input type: summation order only (the
    # bf16 kernel keeps P as two bf16 parts, 2^-18 of each p)
    torch.testing.assert_close(m, mr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, lr, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(acc, ar, atol=1e-4, rtol=1e-5)
    tol = AC.tolerance(case[-1])
    assert o.dtype == q.dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), DO.combine(mr, lr, ar, q.dtype)
                               .float(), **tol)
    got = DO.decode_attention(q, k, v, k_pos, pos, block_k=chunk)
    want = DR.decode_attention_ref(q, k, v, k_pos, pos)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_split_invariance(dev, dtype):
    q, k, v, k_pos, pos, _ = AC.decode_inputs(
        (1, 256, 4, 2, 32, 255, False, None, dtype), dev, seed=3)
    outs = [DO.decode_attention(q, k, v, k_pos, pos, block_k=b)
            for b in (256, 32, 64, 128, 96, None)]
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" \
        else AC.tolerance(dtype)
    for o in outs[1:]:
        torch.testing.assert_close(o.float(), outs[0].float(), **tol)


def test_attention_wrappers_reject_what_the_kernels_do_not_take(dev):
    q, k, v = AC.flash_inputs((1, 64, 4, 2, 32, True, None, "float32"), dev)
    with pytest.raises(TypeError):
        FK.flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        FK.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        FK.flash_attention_cuda(q, k.transpose(1, 2).contiguous()
                                .transpose(1, 2), v)
    with pytest.raises(ValueError):
        FK.flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError, match="hd"):
        FK.flash_attention_cuda(*(torch.zeros(1, 8, 2, 160, device=dev),) * 3)
    # the tensor-core kernel's tensor maps need 16-byte aligned tensors
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    off = torch.zeros(qb.numel() + 1, dtype=torch.bfloat16, device=dev)
    qs = off[1:].view(qb.shape)
    qs.copy_(qb)
    with pytest.raises(ValueError, match="aligned"):
        FK.flash_attention_cuda(qs, kb, vb)
    qd, kd, vd, k_pos, pos, _ = AC.decode_inputs(AC.DECODE_CASES[0], dev)
    with pytest.raises(TypeError):
        DK.decode_attention_cuda(qd, kd, vd, k_pos.long(), pos, 64)
    with pytest.raises(ValueError, match="shape"):
        DK.decode_attention_cuda(qd, kd, vd, k_pos[:10], pos, 64)
    # more than 16 query heads per KV head, and a bf16 row that is not a
    # whole number of 16-byte chunks
    with pytest.raises(ValueError, match="H / K"):
        DK.decode_attention_cuda(torch.zeros(1, 32, 64, device=dev),
                                 *(torch.zeros(1, 8, 1, 64, device=dev),) * 2,
                                 k_pos[:8], 7, 8)
    with pytest.raises(ValueError, match="multiple"):
        DK.decode_attention_cuda(
            torch.zeros(1, 2, 36, device=dev, dtype=torch.bfloat16),
            *(torch.zeros(1, 8, 1, 36, device=dev, dtype=torch.bfloat16),) * 2,
            k_pos[:8], 7, 8)
    with pytest.raises(ValueError):
        FO.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_built_kernels_take_the_hopper_paths(dev):
    """The SASS of the built libraries: the bf16 flash kernel issues TMA
    loads (UTMALDG) and warpgroup products (HGMMA); the decode kernels copy
    the cache with 16-byte asynchronous loads only (LDGSTS ... .128), and
    the bf16 one multiplies on the tensor cores (HMMA)."""
    from repro_torch.kernels import _build, sass
    flash, decode = _build.build_all([FK.WGMMA_SOURCE, DK.SOURCE])
    for hdp in (64, 128):
        ops = sass.opcodes(sass.kernel_instructions(
            flash, f"flash_fwd_wgmma_kernelILi{hdp}E"))
        assert any(op.startswith("HGMMA.64x128x16.F32.BF16") for op in ops)
        assert any(op.startswith("HGMMA.64x64x16.F32.BF16") for op in ops)
        assert any(op.startswith("UTMALDG.4D") for op in ops)
    for part in ("decode_attention_mma_kernelILi128E",
                 "decode_attention_kernelIfLi128ELi4E"):
        ops = sass.opcodes(sass.kernel_instructions(decode, part))
        copies = [op for op in ops if op.startswith("LDGSTS")]
        assert copies and all(op.endswith(".128") for op in copies)
    ops = sass.opcodes(sass.kernel_instructions(
        decode, "decode_attention_mma_kernelILi128E"))
    assert any(op.startswith("HMMA.16816.F32.BF16") for op in ops)


def test_serving_path_runs_through_the_kernels(dev):
    """Reduced qwen3-8b served on the card: one flash launch for the
    1,024-token prefill (the reduced model has one layer), one decode
    launch per generated token, and the CPU run's greedy tokens."""
    from repro_torch.launch import serve
    argv = ["--reduced", "--batch", "2", "--prompt-len", "1024", "--gen",
            "4", "--quiet"]
    f0, d0, w0 = FK.LAUNCHES, DK.LAUNCHES, FK.ROUTE_LAUNCHES["simt"]
    got = serve.main(argv, device=dev)["generated"]
    assert (FK.LAUNCHES - f0, DK.LAUNCHES - d0) == (1, 4)
    # the reduced model computes in float32: the SIMT route
    assert FK.ROUTE_LAUNCHES["simt"] - w0 == 1
    want = serve.main(argv, device="cpu")["generated"]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SC.SCAN_CASES + SC.SCAN_RAGGED
                         + [SC.SCAN_LONG, SC.SCAN_SERVE], ids=str)
def test_scan_kernel_matches_plain_version(dev, case):
    x, dt, A, Bc, Cc, D, _ = SC.scan_inputs(case, dev)
    before, routes = SK.LAUNCHES, dict(SK.ROUTE_LAUNCHES)
    generic = SK.GENERIC_LAUNCHES
    y, h = SK.selective_scan_cuda(x, dt, A, Bc, Cc, D)
    assert SK.LAUNCHES == before + 1
    assert SK.ROUTE_LAUNCHES == {"seq": routes["seq"] + 1,
                                 "step": routes["step"]}
    assert SK.GENERIC_LAUNCHES == generic + (not SC.exact_instance(case))
    torch.cuda.synchronize()
    yr, hr = SR.selective_scan_ref(x, dt, A, Bc, Cc, D)
    assert y.dtype == x.dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr.float(),
                               **SC.tolerance(case[4]))
    torch.testing.assert_close(h, hr, **SC.F32_TOL)


@pytest.mark.parametrize("case", SC.SCAN_STEPS + [
    (2, 45, 160, 16, "float32"), (1, 1, 64, 4, "bfloat16")], ids=str)
def test_scan_kernel_continues_from_a_state(dev, case):
    """h0 read at the start: decode steps (the step instance) at the
    serving widths, in bf16, at one batch row and a ragged state size,
    and a longer run, from a non-zero state."""
    x, dt, A, Bc, Cc, D, h0 = SC.scan_inputs(case, dev, seed=2,
                                             with_h0=True)
    generic = SK.GENERIC_LAUNCHES
    y, h = SK.selective_scan_cuda(x, dt, A, Bc, Cc, D, h0)
    assert SK.GENERIC_LAUNCHES == generic + (not SC.exact_instance(case))
    torch.cuda.synchronize()
    yr, hr = SR.selective_scan_ref(x, dt, A, Bc, Cc, D, h0)
    torch.testing.assert_close(y.float(), yr.float(),
                               **SC.tolerance(case[4]))
    torch.testing.assert_close(h, hr, **SC.F32_TOL)


def test_scan_launches_are_counted_by_instance(dev):
    """One launch a call: S == 1 on the step instance, S > 1 on the
    sequence instance, as `route` names them; the generic template at a
    ragged state size, and for S > 1 at rows of x that are not whole
    16-byte words, counted as the C entry reports it."""
    for case, instance, generic in (
            ((2, 1, 64, 16, "float32"), "step", 0),
            ((2, 2, 64, 16, "float32"), "seq", 0),
            ((1, 1, 40, 5, "bfloat16"), "step", 1),
            ((1, 9, 40, 5, "bfloat16"), "seq", 1),
            ((1, 9, 36, 8, "bfloat16"), "seq", 1),
            ((1, 1, 36, 8, "bfloat16"), "step", 0)):
        assert SK.route(case[1]) == instance
        assert SC.exact_instance(case) == (not generic)
        x, dt, A, Bc, Cc, D, h0 = SC.scan_inputs(case, dev, with_h0=True)
        before, routes = SK.LAUNCHES, dict(SK.ROUTE_LAUNCHES)
        g0 = SK.GENERIC_LAUNCHES
        SK.selective_scan_cuda(x, dt, A, Bc, Cc, D, h0)
        routes[instance] += 1
        assert SK.LAUNCHES == before + 1 and SK.ROUTE_LAUNCHES == routes
        assert SK.GENERIC_LAUNCHES == g0 + generic


@pytest.mark.parametrize("S", [1, 40])
def test_scan_unaligned_tensors_take_the_generic_template(dev, S):
    """A contiguous x that does not start on a 16-byte boundary (a view
    one element into its storage) cannot take the exact instances'
    16-byte copies: the launch takes the generic template, says so, and
    still matches the plain version."""
    case = (2, S, 64, 16, "float32")
    x, dt, A, Bc, Cc, D, h0 = SC.scan_inputs(case, dev, with_h0=True)
    xu = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    xu.copy_(x)
    g0 = SK.GENERIC_LAUNCHES
    y, h = SK.selective_scan_cuda(xu, dt, A, Bc, Cc, D, h0)
    assert SK.GENERIC_LAUNCHES == g0 + 1
    torch.cuda.synchronize()
    yr, hr = SR.selective_scan_ref(x, dt, A, Bc, Cc, D, h0)
    torch.testing.assert_close(y, yr, **SC.F32_TOL)
    torch.testing.assert_close(h, hr, **SC.F32_TOL)


def test_scan_instances_take_the_hopper_paths(dev):
    """The SASS and resources of the built scan instances (float32, d_state
    16, the serving path's): the sequence instance stages its tiles with
    asynchronous copies (LDGSTS) and holds jamba's prefill grid resident
    in one wave; the step instance loads the state with 128-bit loads;
    neither touches local memory."""
    from repro_torch.kernels import _build, sass
    lib = _build.build(SK.SOURCE)
    seq = sass.opcodes(sass.kernel_instructions(
        lib, "selective_scan_seq_kernelIfLi16ELb0E"))
    step = sass.opcodes(sass.kernel_instructions(
        lib, "selective_scan_step_kernelIfLi16ELb0E"))
    assert any(op.startswith("LDGSTS") for op in seq)
    assert any(op.startswith("LDG") and ".128" in op for op in step)
    assert not sass.local_memory(seq) and not sass.local_memory(step)
    res = SK.resources("seq", dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, _, d = SC.SCAN_SERVE[:3]
    assert res["local_bytes"] == 0
    assert res["blocks_per_sm"] * sms * res["channels_per_block"] >= B * d


def test_scan_op_on_the_card_matches_the_cpu(dev):
    """The public op: the kernel on CUDA tensors, the plain version on the
    same inputs on the CPU (bf16 D and a non-contiguous x are taken)."""
    case = (2, 70, 96, 16, "float32")
    x, dt, A, Bc, Cc, D, h0 = SC.scan_inputs(case, dev, with_h0=True)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    before = SK.LAUNCHES
    y, h = SO.selective_scan(xt, dt, A, Bc, Cc, D.bfloat16(), h0)
    assert SK.LAUNCHES == before + 1
    yc, hc = SO.selective_scan(*(t.cpu() for t in (x, dt, A, Bc, Cc)),
                               D.bfloat16().cpu(), h0.cpu())
    torch.testing.assert_close(y.cpu(), yc, **SC.F32_TOL)
    torch.testing.assert_close(h.cpu(), hc, **SC.F32_TOL)


def test_scan_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x, dt, A, Bc, Cc, D, h0 = SC.scan_inputs((1, 8, 32, 4, "float32"), dev,
                                             with_h0=True)
    with pytest.raises(TypeError):
        SK.selective_scan_cuda(x.double(), dt.double(), A, Bc, Cc, D)
    with pytest.raises(TypeError):
        SK.selective_scan_cuda(x, dt.bfloat16(), A, Bc, Cc, D)
    with pytest.raises(TypeError):
        SK.selective_scan_cuda(x, dt, A.bfloat16(), Bc, Cc, D)
    with pytest.raises(ValueError, match="contiguous"):
        SK.selective_scan_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                               dt, A, Bc, Cc, D)
    with pytest.raises(ValueError, match="shape"):
        SK.selective_scan_cuda(x, dt, A, Bc, Cc, D, h0[:, :16])
    with pytest.raises(ValueError, match="N <= 16"):
        SK.selective_scan_cuda(x, dt, torch.zeros(32, 17, device=dev),
                               torch.zeros(1, 8, 17, device=dev),
                               torch.zeros(1, 8, 17, device=dev), D)
    with pytest.raises(ValueError):
        SK.selective_scan_cuda(x, dt, A.cpu(), Bc, Cc, D)


def test_refused_scan_launch_raises(dev):
    """A grid the card refuses (70,000 batch rows > 65,535 blocks on the
    grid's y axis) is reported by the launch, and the wrapper raises."""
    x, dt, A, Bc, Cc, D, _ = SC.scan_inputs((70_000, 1, 1, 4, "float32"),
                                            dev)
    before = SK.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        SK.selective_scan_cuda(x, dt, A, Bc, Cc, D)
    assert SK.LAUNCHES == before


def test_jamba_serving_path_runs_through_the_kernels(dev):
    """Reduced jamba (7 Mamba layers and 1 attention layer) served on the
    card: 7 scan launches in prefill and 7 per generated token, one flash
    launch for the 1,024-token prefill and one decode launch per token,
    and the CPU run's greedy tokens."""
    from repro_torch.launch import serve
    argv = ["--arch", "jamba-v0.1-52b", "--reduced", "--batch", "2",
            "--prompt-len", "1024", "--gen", "4", "--quiet"]
    s0, f0, d0 = SK.LAUNCHES, FK.LAUNCHES, DK.LAUNCHES
    w0 = FK.ROUTE_LAUNCHES["simt"]
    got = serve.main(argv, device=dev)["generated"]
    assert (SK.LAUNCHES - s0, FK.LAUNCHES - f0, DK.LAUNCHES - d0) == \
        (7 + 7 * 4, 1, 4)
    # the reduced model computes in float32: the SIMT route
    assert FK.ROUTE_LAUNCHES["simt"] - w0 == 1
    want = serve.main(argv, device="cpu")["generated"]
    np.testing.assert_array_equal(got, want)


# ---- the identification and evaluation path (no kernel of its own) ----

def test_scan_engine_sub_grid_equals_one_shot_on_the_card(dev):
    """Every run's plant noise and Poisson counts ride with its seed, and
    every op is elementwise per run: a sub-grid reproduces the one-shot
    rows bit for bit on the card, and no closed-loop kernel launches."""
    kw = dict(total_work=1e9, max_time=300.0, summary_warmup=30,
              backend="scan")
    before = K.LAUNCHES
    full = sim.sweep(["gros", "dahu", "yeti"], [0.1, 0.3], range(64), **kw)
    sub = sim.sweep(["dahu", "yeti"], [0.3], [63, 5, 17], **kw)
    assert K.LAUNCHES == before
    for k in ("progress", "power", "energy", "pcap", "valid"):
        np.testing.assert_array_equal(sub.traces[k][:, 0],
                                      full.traces[k][1:, 1, [63, 5, 17]],
                                      err_msg=k)
    for k in ("progress_hist", "pcap_hist", "progress_mean"):
        np.testing.assert_array_equal(sub.summary[k][:, 0],
                                      full.summary[k][1:, 1, [63, 5, 17]])


def test_scan_engine_on_the_card_matches_the_cpu(dev):
    """The same runs on the card and on the CPU: the same integer streams,
    float paths that differ by ulps (a Poisson count can move by one, and
    the runs then part), so seed means at rtol 0.01."""
    kw = dict(total_work=1e9, max_time=256.0, summary_warmup=30,
              collect_traces=False, backend="scan")
    a = sim.sweep(["gros", "yeti"], [0.1, 0.3], range(32), device=dev, **kw)
    b = sim.sweep(["gros", "yeti"], [0.1, 0.3], range(32), device="cpu",
                  **kw)
    for k in ("progress_mean", "power_mean"):
        np.testing.assert_allclose(a.summary[k].mean(-1),
                                   b.summary[k].mean(-1), rtol=0.01)
    np.testing.assert_allclose(a.energy.mean(-1), b.energy.mean(-1),
                               rtol=0.01)


def test_scan_step_loop_makes_no_host_sync(dev):
    """The step loop never waits on the host: over a whole run the only
    synchronizing call is the one check that every Poisson draw
    resolved."""
    import warnings
    prof, gains, seeds = sim.grid_rows(["gros", "yeti"], [0.1], range(128))
    prof, gains, seeds = prof.to(dev), gains.to(dev), seeds.to(dev)
    run = sim._scan_core(256, collect=False)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(prof, gains, seeds, 1e9, 256.0, 1.0, 30.0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]


@pytest.mark.parametrize("lam", [0.0, 0.3, 3.0, 9.9, 10.0, 40.0, 1800.0,
                                 7000.0])
def test_poisson_sampler_on_the_card(dev, lam):
    """2e5 draws: mean and variance within 5 standard errors of lam, the
    same integer counts as on the CPU (the same uniforms; the float paths
    differ by ulps) for at least 99.9% of draws, 99% at lam >= 1,000,
    where PTRS's log-ratio t = -lam + k log lam - lgamma(k + 1) cancels
    terms of ~6e4 in float32 (an ulp of lgamma is ~4e-3 of it; 0.27% of
    the draws at lam = 7,000 moved on an H100), none left unresolved."""
    from repro_torch.core.poisson import PoissonStream
    seeds = torch.arange(20000)
    x = PoissonStream(seeds.to(dev))
    y = PoissonStream(seeds)
    rate = torch.full((20000,), lam)
    a = torch.cat([x(rate.to(dev), s) for s in range(10)]).cpu().numpy()
    b = torch.cat([y(rate, s) for s in range(10)]).numpy()
    x.check()
    n = a.size
    if lam == 0:
        assert (a == 0).all()
        return
    assert abs(a.mean() - lam) < 5 * np.sqrt(lam / n)
    assert abs(a.var() - lam) < 5 * np.sqrt((lam + 2 * lam * lam) / n)
    assert (a == b).mean() >= (0.99 if lam >= 1000 else 0.999)


def test_fit_static_on_the_card_matches_the_cpu(dev):
    """The float32 Gauss-Newton fit on the card against the CPU port on the
    same campaign: rtol 1e-4 on the fitted parameters, 1e-6 on R^2 (the
    CPU port holds the reference to the same bars); its loop makes no
    host sync."""
    import warnings
    from repro_torch.core import identify
    from repro_torch.core.plant import PROFILES
    for name in ("gros", "dahu"):
        caps, powers, progs = identify.static_campaign(PROFILES[name],
                                                       device="cpu")
        a = identify.fit_static(caps, powers, progs, device=dev)
        b = identify.fit_static(caps, powers, progs, device="cpu")
        assert (a.a, a.b) == (b.a, b.b)
        for f in ("K_L", "alpha", "beta"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-4)
        assert a.r2 == pytest.approx(b.r2, rel=1e-6)
    p = torch.tensor([3.2, -3.0, 28.0], device=dev)
    lams = torch.tensor([[1.0], [0.5], [0.25], [0.1], [0.03]], device=dev)
    pw = torch.as_tensor(powers, dtype=torch.float32).to(dev)
    pg = torch.as_tensor(progs, dtype=torch.float32).to(dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            identify._gauss_newton(p, pw, pg, lams, 20)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in seen if "synchroniz" in str(w.message)
                and "prototype" not in str(w.message)]


def test_open_loop_and_replay_on_the_card_match_the_cpu(dev):
    """open_loop_runs and replay_model on the card against the CPU: the
    same noise words, float paths that differ by ulps (rtol 1e-5)."""
    a = sim.open_loop_runs("yeti", 200, range(16), pcap=90.0, device=dev)
    b = sim.open_loop_runs("yeti", 200, range(16), pcap=90.0, device="cpu")
    for k in a:
        np.testing.assert_allclose(a[k].cpu().numpy(), b[k].numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    sched = np.repeat(np.random.default_rng(0).uniform(40, 120, 60), 4)
    np.testing.assert_allclose(
        sim.replay_model("gros", sched, device=dev).cpu().numpy(),
        sim.replay_model("gros", sched, device="cpu").numpy(), rtol=1e-5,
        atol=1e-4)


# ---- policies and adaptation (no kernel: PyTorch on the card) ---------

ALL4 = ("pi", "pi_rls", "dutycycle", "offline_rl")


def test_fma_on_the_card_is_one_rounding(dev):
    """`fma` on CUDA (`torch.addcmul`, contracted to an FMA instruction)
    against the CPU's float64 emulation: the same single rounding."""
    from repro_torch.core.fma import fma
    g = torch.Generator().manual_seed(0)
    x, y, z = (torch.randn(1 << 20, generator=g) for _ in range(3))
    a = fma(x.to(dev), y.to(dev), z.to(dev)).cpu()
    b = fma(x, y, z)
    assert (a == b).float().mean().item() >= 0.99999
    assert not torch.equal(b, x * y + z)   # two roundings differ somewhere


def _policy_rows(n):
    """n runs over gros / dahu / yeti, kinds cycling over the four
    branches, with non-default hyperparameters."""
    from repro_torch.core import policies as pol
    from repro_torch.core.adaptive import RLSConfig
    from repro_torch.core.controller import PIGains
    from repro_torch.core.plant import PROFILES
    pls = [pol.PIPolicy(), pol.PIPolicy(adaptive=RLSConfig(lam=0.97,
                                                           dwell=3)),
           pol.DutyCyclePolicy(n_levels=12, deadband=0.05),
           pol.OfflineRLPolicy(weights=(0.1, 0.8, -0.5, 1.4, -1.0, 0.2))]
    names = ["gros", "dahu", "yeti"]
    prof, gains, vals = [], [], []
    for i in range(n):
        p = PROFILES[names[i % 3]]
        g = PIGains.from_model(p, 0.05 * (i % 5))
        prof.append(sim.profile_values(p))
        gains.append(sim.gains_values(g))
        vals.append(pol.policy_values(pls[i % 4], p, g, kind=i % 4))
    return torch.stack(prof), torch.stack(gains), torch.stack(vals)


def test_policy_branches_on_the_card_match_the_cpu(dev):
    """Every branch (and the four at once) and the RLS step, 60 periods on
    the same inputs on the card and on the CPU. The card's exp and log
    (the PI's Eq. 2 transform) differ from the CPU's by ulps, and the RLS
    covariance update cancels ~99.6 of ~100 on its first periods, so the
    packed states are held at rtol 1e-4, atol 1e-4."""
    from repro_torch.core import adaptive as A
    from repro_torch.core import plane
    from repro_torch.core import policies as pol
    _, gv, av = _policy_rows(64)
    for branches in [(b,) for b in ALL4] + [ALL4]:
        vals = av.clone()
        vals[:, 0] = torch.arange(64) % len(branches)
        states = []
        for d in (dev, torch.device("cpu")):
            gains = plane.unpack_gains(gv.to(d))
            st = pol.policy_init(branches, vals.to(d), gains)
            rs = np.random.default_rng(1)
            for i in range(60):
                prog = torch.from_numpy((gv[:, 2].numpy() * rs.uniform(
                    0.7, 1.3, 64)).astype(np.float32)).to(d)
                st, pcap = pol.policy_step(branches, vals.to(d), st,
                                           pol.PolicyObs(prog, None,
                                                         torch.tensor(
                                                             1.0,
                                                             device=d),
                                                         gains))
            states.append((st.cpu(), pcap.cpu()))
        for a, b in zip(*states):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=str(branches))
    # the estimator alone
    gros = sim.PROFILES["gros"]
    vals = A.rls_values(A.RLSConfig(lam=0.9, dwell=2), gros,
                        sim.PIGains.from_model(gros, 0.1))
    vals = vals.expand(256, 6).contiguous()
    out = []
    for d in (dev, torch.device("cpu")):
        s = A.rls_init(vals.to(d), torch.full((256,), 0.001, device=d),
                       torch.full((256,), 0.004, device=d))
        rs = np.random.default_rng(2)
        for i in range(200):
            p = torch.from_numpy(rs.uniform(10, 30, 256).astype(
                np.float32)).to(d)
            u = torch.from_numpy(rs.uniform(-0.6, -0.02, 256).astype(
                np.float32)).to(d)
            s = A.rls_step(vals.to(d), s, p, u, 1.0)
        out.append(s)
    for f in A.RLSState._fields:
        np.testing.assert_allclose(getattr(out[0], f).cpu().numpy(),
                                   getattr(out[1], f).numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=f)


def test_packed_scan_step_loop_makes_no_host_sync(dev):
    """The packed engine with all four branches: over a whole run the only
    synchronizing call is the one check that every Poisson draw
    resolved."""
    import warnings
    prof, gains, vals = _policy_rows(256)
    run = sim._scan_core(256, collect=False, branches=ALL4, typed_pi=False)
    prof, gains, seeds, vals = (x.to(dev) for x in (prof, gains,
                                                    torch.arange(256), vals))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(prof, gains, seeds, 1e9, 256.0, 1.0, 30.0, vals)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]


def test_policy_sweep_on_the_card_matches_the_cpu(dev):
    """A heterogeneous race and an adaptive grid on the card and on the
    CPU: the same streams, float paths that differ by ulps, seed means at
    rtol 0.01 (as the typed scan engine is held)."""
    from repro_torch.core.adaptive import RLSConfig
    from repro_torch.core import policies as pol
    kw = dict(total_work=1e9, max_time=256.0, summary_warmup=30,
              collect_traces=False)
    for extra in (dict(policies=[pol.PIPolicy(), pol.DutyCyclePolicy(),
                                 pol.OfflineRLPolicy(
                                     weights=(0, 0, 0, 1.4, -1.0, 0))]),
                  dict(adaptive=[RLSConfig(lam=0.97),
                                 RLSConfig(lam=0.999)])):
        a = sim.sweep(["gros", "yeti"], [0.1], range(32), device=dev,
                      **kw, **extra)
        b = sim.sweep(["gros", "yeti"], [0.1], range(32), device="cpu",
                      **kw, **extra)
        for k in ("progress_mean", "power_mean"):
            np.testing.assert_allclose(a.summary[k].mean(-1),
                                       b.summary[k].mean(-1), rtol=0.01)
        np.testing.assert_allclose(a.energy.mean(-1), b.energy.mean(-1),
                                   rtol=0.01)


def test_fit_offline_rl_on_the_card_recovers_the_optimal_action(dev):
    """gamma=0 with reward -(a - 0.7)^2: the greedy policy fitted on the
    card picks the candidate nearest u = 0.7 at every state; its 50
    iterations make no host sync."""
    import warnings
    from repro_torch.core import policies as pol
    from repro_torch.core.policies import offline_rl as RL
    rng = np.random.default_rng(0)
    n = 4000
    s = rng.uniform(0.4, 1.4, n).astype(np.float32)
    a = rng.uniform(0.0, 1.0, n).astype(np.float32)
    r = -((a - 0.7) ** 2).astype(np.float32)
    ds = {"s": s, "a": a, "r": r, "s2": s}
    policy = pol.fit_offline_rl(ds, gamma=0.0, n_iters=3, device=dev)
    us = np.linspace(0.0, 1.0, pol.N_ACTIONS)
    for x in np.linspace(0.4, 1.4, 11):
        q = [float(np.dot([1, x, x * x, u, u * u, x * u], policy.weights))
             for u in us]
        assert abs(us[int(np.argmax(q))] - 0.7) <= us[1] - us[0]
    t = [torch.from_numpy(ds[k]).to(dev) for k in ("s", "a", "r", "s2")]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            RL._fqi(*t, 0.9, 1e-3, 50)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in seen if "synchroniz" in str(w.message)
                and "prototype" not in str(w.message)]


# ---- the scenario axes on the card (phased workloads, detector, faults,
# guard, flight recorder) ----------------------------------------------------

def _scenario_batch(n_seeds=64):
    """A batch of runs with every scenario axis on: two schedules, the
    detector, two fault scripts, the guard and a 16-slot ring, through
    the sweep's own row makers. Returns (prof, gains, seeds, pvals,
    scenario) on the CPU."""
    from repro_torch.core import faults as flt
    from repro_torch.core.policies import PIPolicy
    from repro_torch.core.plant import PROFILES
    from repro_torch.core.workloads import (DetectorConfig,
                                            stream_dgemm_schedule)
    W = flt.FaultWindow
    scripts = [flt.FaultSchedule((W("hb_dropout", 30.0, 40.0, p1=1.0),
                                  W("meter_freeze", 30.0, 40.0),
                                  W("meter_spike", 90.0, 20.0, p1=0.5)),
                                 period=150.0),
               flt.FaultSchedule((W("act_quant", 20.0, 50.0, p1=7.0),
                                  W("crash", 100.0, 10.0)))]
    scheds = [stream_dgemm_schedule("gros", dwell=40.0, cyclic=True),
              stream_dgemm_schedule("gros", dwell=60.0, n_cycles=2)]
    profs = [PROFILES["gros"], PROFILES["yeti"]]
    extra, build, _ = sim._scenario_axes(profs, scheds, DetectorConfig(),
                                         scripts)
    prof, gains, seeds, pvals, idx = sim._grid(
        profs, [0.1], range(n_seeds), 10.0, [PIPolicy()], (0,), extra)
    scen = sim._scenario_rows(build, idx, flt.guard_values(device="cpu"),
                              16)
    return prof, gains, seeds, pvals, scen


def test_scenario_step_loop_makes_no_host_sync(dev):
    """Every scenario axis at once on the packed engine: over a whole run
    the only synchronizing call is the one check that every Poisson draw
    resolved, and the rings stay on the card."""
    import warnings
    prof, gains, seeds, pvals, scen = _scenario_batch()
    run = sim._scan_core(256, collect=False, typed_pi=False, n_events=16)
    args = [x.to(dev) for x in (prof, gains, seeds)]
    kw = scen.inputs(dev)
    pvals = pvals.to(dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, c = run(*args, 1e9, 256.0, 1.0, 30.0, pvals, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    for f in ("det", "fstate", "guard", "events"):
        assert getattr(c, f).is_cuda, f
    assert float(c.events[:, 0].max()) > 0


def test_scenario_ring_on_the_card_matches_the_cpu(dev):
    """The same rows on the card and on the CPU: decoded timelines with
    the same events in the same order (codes and sources exactly, times
    and payloads at rtol 1e-5), guard counters and alarm counts equal."""
    from repro_torch.obs import events as evt
    prof, gains, seeds, pvals, scen = _scenario_batch(16)
    out = {}
    for d in (dev, torch.device("cpu")):
        run = sim._scan_core(256, collect=False, typed_pi=False,
                             n_events=16)
        _, c = run(prof.to(d), gains.to(d), seeds.to(d), 1e9, 256.0, 1.0,
                   30.0, pvals.to(d), **scen.inputs(d))
        out[d.type] = {f: getattr(c, f).cpu() for f in
                       ("det", "guard", "events")}
    a, b = out["cuda"], out["cpu"]
    same = 0
    for ra, rb in zip(evt.decode_grid(a["events"]),
                      evt.decode_grid(b["events"])):
        ka = [(e.code, e.source) for e in ra]
        same += ka == [(e.code, e.source) for e in rb]
        if ka == [(e.code, e.source) for e in rb]:
            np.testing.assert_allclose([e.t for e in ra], [e.t for e in rb],
                                       rtol=1e-5)
    assert same >= 0.9 * len(a["events"])
    assert float(a["events"][:, 0].sum()) > 0


def test_schedule_gather_on_the_card_equals_the_cpu(dev):
    """`active_profile` over per-run packed rows: the same rows and phase
    indices on the card as on the CPU, bit for bit, on boundaries and
    cyclic wraps."""
    from repro_torch.core.workloads import active_profile
    _, _, _, _, scen = _scenario_batch(8)
    sv = scen.sched
    ends = sv.ends[:, :4].numpy()
    t = np.concatenate([ends[np.isfinite(ends)], [0.0, 1e4, 79.999, 80.0,
                                                  240.0, 1e-3]])
    t = torch.from_numpy(np.resize(t.astype(np.float32), sv.ends.shape[0]))
    row_c, idx_c = active_profile(sv, t)
    sv_d = type(sv)(*(x.to(dev) for x in sv))
    row_d, idx_d = active_profile(sv_d, t.to(dev))
    assert torch.equal(idx_d.cpu(), idx_c)
    assert torch.equal(row_d.cpu(), row_c)


def test_scenario_sweep_on_the_card_matches_the_cpu(dev):
    """A phased, detected, faulted, guarded sweep on the card and on the
    CPU: seed means at rtol 0.01 (the same streams, float paths that
    differ by ulps), as the scan engine is held."""
    from repro_torch.core import faults as flt
    from repro_torch.core.workloads import DetectorConfig, Phase, \
        PhaseSchedule
    kw = dict(total_work=1e9, max_time=256.0, summary_warmup=30,
              collect_traces=False,
              workloads=PhaseSchedule((Phase(100.0),
                                       Phase(200.0, scale={"K_L": 2.0}))),
              detector=DetectorConfig(), guard=True,
              faults=[flt.FaultSchedule(), flt.FaultSchedule((
                  flt.FaultWindow("hb_dropout", 50.0, 30.0, p1=1.0),))])
    a = sim.sweep(["gros", "yeti"], [0.1], range(32), device=dev, **kw)
    b = sim.sweep(["gros", "yeti"], [0.1], range(32), device="cpu", **kw)
    for k in ("progress_mean", "power_mean"):
        np.testing.assert_allclose(a.summary[k].mean(-1),
                                   b.summary[k].mean(-1), rtol=0.01)
    np.testing.assert_allclose(a.energy.mean(-1), b.energy.mean(-1),
                               rtol=0.01)
    np.testing.assert_allclose(a.detections.mean(-1), b.detections.mean(-1),
                               rtol=0.1, atol=0.1)


# ---- the execution layer and the runtime on the card ---------------------

@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_chunked_sweep_on_the_card_equals_one_shot(dev, backend):
    """Chunked equals one-shot bit for bit on the card; the kernel route
    launches the seeds-route kernel once per chunk and no plain
    version."""
    kw = dict(total_work=1e9, max_time=256.0, collect_traces=False,
              summary_warmup=30, backend=backend, device=dev)
    grid = (["gros", "dahu"], [0.1, 0.3], range(300))
    one = sim.sweep(*grid, **kw)
    before = dict(K.ROUTE_LAUNCHES)
    ch = sim.sweep(*grid, chunk_size=512, **kw)
    launched = K.ROUTE_LAUNCHES["seeds"] - before["seeds"]
    assert launched == (3 if backend == "kernel" else 0)
    for k in ("progress_mean", "power_mean", "progress_hist", "pcap_hist"):
        np.testing.assert_array_equal(one.summary[k], ch.summary[k],
                                      err_msg=k)
    np.testing.assert_array_equal(one.energy, ch.energy)
    np.testing.assert_array_equal(one.n_steps, ch.n_steps)


def test_more_devices_than_cards_raise(dev):
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"asked for {n + 1} devices"):
        sim.sweep("gros", [0.1], range(4), total_work=10.0, max_time=64.0,
                  chunk_size=2, devices=n + 1)
    if n == 1:
        with pytest.raises(ValueError, match="asked for 2 devices"):
            sim.sweep("gros", [0.1], range(4), total_work=10.0,
                      max_time=64.0, devices=2)


def test_transfer_packs_every_leaf_dtype(dev):
    """The merge's one-sync transfer keeps float32, int32, int64 and bool
    leaves (and transposed views) exactly as the CPU's views do."""
    from repro_torch.core import executor
    x = np.arange(40, dtype=np.float32).reshape(10, 4)

    def fn(b):
        t = b["x"]
        return {"f": t * 0.5, "i": t.to(torch.int32), "l": t.to(torch.int64),
                "b": t > 7, "tr": t.T.contiguous().T}

    a, _ = executor.run_grid(fn, {"x": x}, (), 10, chunk_size=4, device=dev)
    c, _ = executor.run_grid(fn, {"x": x}, (), 10, chunk_size=4,
                             device="cpu")
    for k in c:
        assert a[k].dtype == c[k].dtype
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)


@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_chunked_trace_sweep_peak_stays_at_one_chunk(dev, backend):
    """Trace mode, where a chunk's outputs are O(chunk x T): a grid in 4
    chunks peaks at most 1.3x the device memory of a one-shot grid of
    one chunk's runs (every chunk's tensors are freed before the next
    chunk's are made)."""
    kw = dict(total_work=1e9, max_time=128.0, backend=backend, device=dev)
    profs, eps = ["gros", "dahu"], [0.1, 0.3]

    def peak(seeds, **extra):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = sim.sweep(profs, eps, seeds, **kw, **extra)
        torch.cuda.synchronize()
        return res, torch.cuda.max_memory_allocated() - base

    peak(range(256))  # builds the kernel and warms the allocator
    one, p_one = peak(range(256))
    ch, p_ch = peak(range(1024), chunk_size=1024)
    assert ch.traces["pcap"].shape[:3] == (2, 2, 1024)
    np.testing.assert_array_equal(ch.traces["pcap"][:, :, :256],
                                  one.traces["pcap"])
    assert p_ch <= 1.3 * p_one, (p_ch, p_one)


def test_durable_campaign_on_the_card_survives_transients(dev, tmp_path):
    """A durable kernel-route campaign under FlakyGridFn transients (an
    out-of-memory error among them) and a watchdog timeout: the merge is
    bit for bit the plain executor's, on the card's stream (the timed-out
    attempt's zombie enqueues the same launches as its retry)."""
    from repro_torch.core import executor, supervisor
    from repro_torch.obs.retry import RetryPolicy
    prof, gains, seeds = sim.grid_rows(["gros", "dahu"], [0.1, 0.3],
                                       range(256))
    batched = {"prof": prof, "gains": gains, "seeds": seeds}
    shared = (1e9, 256.0, 1.0, 30.0)
    fn = sim._kernel_core(False)
    ref, _ = executor.run_grid(fn, batched, shared, 1024, chunk_size=256,
                               device=dev)
    flaky = supervisor.FlakyGridFn(fn, failures={
        0: supervisor.TransientFault("injected"),
        2: torch.OutOfMemoryError("CUDA out of memory")},
        delays={4: 3.0})
    cfg = supervisor.CampaignConfig(
        chunk_timeout_s=1.0, retry=RetryPolicy(max_retries=3, base_s=0.001,
                                               max_s=0.01))
    merged, report = supervisor.run_durable(
        flaky, batched, shared, 1024, dir=tmp_path, chunk_size=256,
        device=dev, config=cfg)
    assert report.retries == 3 and not report.dead
    for a, b in zip(executor._flatten(merged)[0],
                    executor._flatten(ref)[0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["pi", "pi_rls", "detector_guard",
                                  "dutycycle"])
def test_control_step_on_the_card(dev, case):
    """`NRM.control_step` on the card (NRM(device=None) is CUDA): with a
    simulated plant advancing and heartbeats at its measured rate, every
    cap is finite and inside the actuator's range, and the PI caps
    follow the CPU NRM's on the same beats (float paths that differ by
    ulps: rtol 1e-3; duty-cycle's discrete ladder is held to its bounds
    only)."""
    from repro_torch.configs.base import PowerControlConfig
    from repro_torch.core import faults as flt
    from repro_torch.core.nrm import NRM
    from repro_torch.core.policies import DutyCyclePolicy
    from repro_torch.core.workloads import DetectorConfig
    kw = {}
    if case == "detector_guard":
        kw = dict(detector=DetectorConfig(), guard=True)
    if case == "dutycycle":
        kw = dict(policy=DutyCyclePolicy())
    cfg = PowerControlConfig(epsilon=0.1, adaptive=case == "pi_rls")
    card = NRM(cfg, **kw)
    host = NRM(cfg, device="cpu", **kw)
    assert card.device.type == "cuda"
    assert card.controller.state.prev_pcap_l.is_cuda
    caps = []
    for k in range(40):
        meas = card.actuator.advance(1.0)
        host.actuator.advance(1.0)
        n = 0 if 20 <= k < 26 else max(1, int(meas["progress"]))
        for i in range(n):
            card.heartbeat(t=k + (i + 0.5) / n)
            host.heartbeat(t=k + (i + 0.5) / n)
        a, b = card.control_step(), host.control_step()
        assert np.isfinite(a.pcap)
        assert card.profile.pcap_min <= card.actuator._pcap \
            <= card.profile.pcap_max
        caps.append((a.pcap, b.pcap))
    if case != "dutycycle":
        np.testing.assert_allclose(*zip(*caps), rtol=1e-3)


def test_nrm_runs_on_the_card(dev):
    """run_simulated on the card: the default device is CUDA, the state
    stays there, three resumed segments keep the work rising, and a
    checkpoint round-trips."""
    from repro_torch.configs.base import PowerControlConfig
    from repro_torch.core.nrm import NRM
    nrm = NRM(PowerControlConfig(epsilon=0.1, plant_profile="gros"))
    works = []
    for seed in range(3):
        tr = nrm.run_simulated(total_work=1e9, max_time=64.0, seed=seed)
        assert np.isfinite(tr["power"]).all()
        works.append(tr["work"])
    assert works[0][-1] < works[1][0] < works[2][0]
    assert nrm.actuator.state.work.is_cuda
    other = NRM(PowerControlConfig(epsilon=0.1, plant_profile="gros"))
    other.load_state_dict(nrm.state_dict())
    assert other.state_dict() == nrm.state_dict()


def test_serve_power_on_the_card_keeps_the_tokens(dev):
    from repro_torch.launch import serve
    argv = ["--reduced", "--batch", "2", "--prompt-len", "16", "--gen", "8",
            "--quiet"]
    a = serve.main(argv)
    b = serve.main(argv + ["--power"])
    np.testing.assert_array_equal(a["generated"], b["generated"])
    assert b["final_pcap"] is not None and b["energy_j"] > 0


def test_fleet_on_the_card_is_chunk_invariant(dev):
    """A budgeted three-class fleet campaign on the card: every chunking
    of the seeds gives the one-shot rows (rtol 1e-6; the node axis sums
    by pairwise halving and the median by an exact sort, so they are
    expected bit-equal), and a row equals `simulate_fleet` of its seed."""
    from repro_torch.core.hierarchy import (FleetConfig, fleet_sweep,
                                            simulate_fleet)
    from repro_torch.core.plant import PROFILES
    from repro_torch.core.policies import DutyCyclePolicy, PIPolicy
    profs = [PROFILES[p] for p in ("gros", "dahu", "yeti")]
    peak = sum(float(p.power_of_pcap(p.pcap_max)) for p in profs) * 32
    fc = FleetConfig(n_nodes=96, power_budget=0.6 * peak)
    kw = dict(policies=[PIPolicy(), DutyCyclePolicy(), PIPolicy()])
    one = fleet_sweep(profs, fc, 30, range(6), **kw)
    for chunk in (1, 4):
        ch = fleet_sweep(profs, fc, 30, range(6), chunk_size=chunk, **kw)
        for k in one:
            np.testing.assert_allclose(ch[k], one[k], rtol=1e-6,
                                       err_msg=f"chunk {chunk} {k}")
    solo = simulate_fleet(profs, fc, 30, seed=4, **kw)
    for k in ("power", "progress_med", "energy_total", "alloc_class"):
        np.testing.assert_allclose(one[k][4], solo[k], rtol=1e-6,
                                   err_msg=k)
    assert np.isfinite(one["power"]).all()


def test_plane_tick_on_the_card_equals_the_cpu(dev):
    """The same mixed plane on the card and on the CPU for 12 ticks, each
    tick from the same state rows (the card plane takes the CPU plane's
    after each tick): the same progress (host numpy), alarms and guard
    modes; PI rows within 2 ulps (Eq. 2's float32 exp and log: CUDA's
    `expf` / `logf` and the CPU's vectorized ones are each within an ulp
    or two of the exact value, not always on the same side), the other
    branches within rtol 1e-5 (their multiply-adds contract into FMAs on
    the card)."""
    from repro_torch.core.adaptive import RLSConfig
    from repro_torch.core.plane import ControlPlane
    from repro_torch.core.policies import DutyCyclePolicy, PIPolicy
    from repro_torch.core.workloads import DetectorConfig
    planes = [ControlPlane(profile="gros", dt=1.0, device=d)
              for d in ("cuda", "cpu")]
    for p in planes:
        p.add_tenants(8, ids=[f"pi{i}" for i in range(8)])
        p.add_tenants(3, ids=["r0", "r1", "r2"],
                      policy=PIPolicy(adaptive=RLSConfig()))
        p.add_tenants(3, ids=["d0", "d1", "d2"], policy=DutyCyclePolicy())
        p.add_tenants(2, ids=["x0", "x1"], detector=DetectorConfig(),
                      guard=True)
    rng = np.random.default_rng(0)
    for k in range(12):
        t = planes[0]._t + 1.0
        ids, times = [], []
        for i, tid in enumerate(planes[0]._slots):
            n = int(rng.poisson(15.0 + i))
            ids += [tid] * n
            times += [t - 1.0 + (j + 0.5) / max(n, 1) for j in range(n)]
        for p in planes:
            p.ingest(ids, times)
        a, b = (p.tick() for p in planes)
        for key in ("progress", "phase_change", "guard_mode"):
            np.testing.assert_array_equal(a[key], b[key])
        for tid, s in planes[0]._slots.items():
            if tid.startswith("pi"):
                x, y = a["applied"][s], b["applied"][s]
                assert abs(x - y) <= 2 * np.spacing(max(x, y)), (k, tid)
            else:
                np.testing.assert_allclose(a["applied"][s],
                                           b["applied"][s], rtol=1e-5)
        for f in ("_pstate", "_dstate", "_gstate", "_pcap"):
            getattr(planes[0], f)[:] = getattr(planes[1], f)
