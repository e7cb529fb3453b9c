"""The AdamW kernels (`repro_torch.kernels.adamw`) against their plain
version (`repro_torch.optim.adamw`: `_update`, `global_norm`), on the
card. Every test needs a CUDA device and skips without one; the file
imports no jax, so it runs where only torch is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_adamw_cuda.py

The update must equal `_update` bit for bit for the same clip, c1, c2
and lr: the same float32 operations in the same order, each rounded
once (the source is built with -fmad=false, IEEE division and square
root), then rounded to each tensor's type to nearest even.

The norm is held to a float64 sum of the same values at `NORM_RTOL`: a
square is rounded once to float32, eight of them are summed in float32
as a tree of depth 3, and those sums in double. So every term carries at
most 4 roundings, and the sum of these positive terms is within 4u of
the exact one (u = 2**-24, double's own error far below); the square
root halves that to 2u, and its rounding to float32 adds u: 3u.
"""
import math
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.kernels.adamw import kernel as K  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

pytestmark = pytest.mark.cuda

NORM_RTOL = 3 * 2.0 ** -24
CFG = TrainConfig(weight_decay=0.1, beta1=0.9, beta2=0.95, eps=1e-8)
TYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _leaf(n, dtype, dev, gen, offset=0, positive=False):
    """``n`` values of ``dtype`` starting ``offset`` elements into a fresh
    allocation (which the caching allocator aligns to 512 bytes)."""
    x = torch.randn(offset + n, generator=gen, device=dev)
    x = (x.abs() * 1e-3 if positive else x).to(dtype)
    return x[offset:]


def _scalars(dev, step=3, clip=0.73, lr=3e-4):
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    s = f(float(step))
    c1 = 1.0 - CFG.beta1 ** s
    c2 = 1.0 - CFG.beta2 ** s
    return f(clip), c1, c2, f(lr)


def _quads(dev, sizes, tp, tg, tm, offsets=None, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    offsets = offsets or [(0, 0, 0, 0)] * len(sizes)
    return [(_leaf(n, tp, dev, gen, o[0]), _leaf(n, tg, dev, gen, o[1]),
             _leaf(n, tm, dev, gen, o[2]),
             _leaf(n, tm, dev, gen, o[3], positive=True))
            for n, o in zip(sizes, offsets)]


def _plain(quads, clip, c1, c2, lr):
    """`_update` on copies of ``quads`` -> the copies."""
    out = [tuple(t.clone() for t in q) for q in quads]
    for q in out:
        adamw._update(CFG, *q, clip, c1, c2, lr)
    return out


def _kernel(quads, clip, c1, c2, lr):
    K.update(quads, clip, c1, c2, lr, CFG.beta1, CFG.beta2, CFG.eps,
             CFG.weight_decay)
    torch.cuda.synchronize()


def _assert_equal(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        for name, x, y in zip("pgmv", a, b):
            assert torch.equal(x, y), (i, name, (x.float() - y.float()).abs()
                                       .max().item())


# 1 element; lengths off the vector width; several chunks with a ragged end
SIZES = [1, 7, 13, 4099, 2 * 65536 + 17]


@pytest.mark.parametrize("tm", ["f32", "bf16"])
@pytest.mark.parametrize("tg", ["bf16", "f32"])
@pytest.mark.parametrize("tp", ["bf16", "f32"])
def test_update_equals_plain_bit_for_bit(dev, tp, tg, tm):
    quads = _quads(dev, SIZES, TYPES[tp], TYPES[tg], TYPES[tm])
    scal = _scalars(dev)
    want = _plain(quads, *scal)
    _kernel(quads, *scal)
    _assert_equal(quads, want)


@pytest.mark.parametrize("tp, tm", [("bf16", "f32"), ("f32", "bf16")])
def test_update_of_stacked_slices_off_the_16_byte_boundary(dev, tp, tm):
    """Layer slices of stacked leaves of 3 x 7 x 3 = 63 elements a layer
    (126 bytes in bf16, 252 in float32): slices 1 and 2 start off a 16-byte
    boundary, at an element from which all four tensors are aligned."""
    gen = torch.Generator(device=dev).manual_seed(1)
    shape = (4, 3, 7, 3)
    stack = lambda dt, pos=False: _leaf(math.prod(shape), dt, dev, gen,
                                        positive=pos).view(shape)
    p, g = stack(TYPES[tp]), stack(TYPES[tp])
    m, v = stack(TYPES[tm]), stack(TYPES[tm], True)
    quads = [(p[i], g[i], m[i], v[i]) for i in range(shape[0])]
    assert any(q[0].data_ptr() % 16 for q in quads)
    scal = _scalars(dev, step=1)
    want = _plain(quads, *scal)
    _kernel(quads, *scal)
    _assert_equal(quads, want)


def test_update_without_a_common_aligned_element(dev):
    """p one bf16 element past an aligned start, m, v and g aligned: no
    element has all four 16-byte aligned, so every element goes one at a
    time."""
    quads = _quads(dev, [5, 3001, 70001], torch.bfloat16, torch.bfloat16,
                   torch.float32, offsets=[(1, 0, 0, 0)] * 3)
    scal = _scalars(dev, step=7, clip=1.0)
    want = _plain(quads, *scal)
    _kernel(quads, *scal)
    _assert_equal(quads, want)


def _grads(dev, seed=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return ([_leaf(n, torch.bfloat16, dev, gen, o) for n, o in
             [(1, 0), (9, 3), (65536 + 5, 1), (3 * 65536, 0)]]
            + [_leaf(n, torch.float32, dev, gen, o) for n, o in
               [(2, 1), (4097, 0)]])


def test_norm_against_a_float64_sum_and_the_clip_as_pytorch_computes_it(
        dev):
    grads = _grads(dev)
    exact = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    for grad_clip in (1.0, 0.25 * exact, 0.0):
        gnorm, clip = K.norm_and_clip(grads, grad_clip)
        assert gnorm.dtype == clip.dtype == torch.float32
        assert float(gnorm) == pytest.approx(exact, rel=NORM_RTOL)
        want = (torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0) if grad_clip > 0 else
                torch.ones_like(gnorm))
        assert torch.equal(clip, want), (clip.item(), want.item())


def test_norm_gives_the_same_bits_twice(dev):
    grads = _grads(dev, seed=3)
    a = K.norm_and_clip(grads, 1.0)[0].clone()
    b = K.norm_and_clip(grads, 1.0)[0]
    assert torch.equal(a, b)


def test_launches_count_groups_of_tensors(dev):
    """200 tensors: ceil(200 / 184) norm launches and one finalize; ceil(200
    / 88) update launches, per combination of types."""
    quads = _quads(dev, [3] * 200, torch.bfloat16, torch.bfloat16,
                   torch.float32)
    scal = _scalars(dev)
    n0 = K.LAUNCHES
    K.norm_and_clip([q[1] for q in quads], 1.0)
    assert K.LAUNCHES - n0 == 2 + 1
    n0 = K.LAUNCHES
    _kernel(quads, *scal)
    assert K.LAUNCHES - n0 == 3
    mixed = quads[:5] + _quads(dev, [3] * 4, torch.float32, torch.float32,
                               torch.float32)
    n0 = K.LAUNCHES
    _kernel(mixed, *scal)
    assert K.LAUNCHES - n0 == 2


def test_an_unsupported_cuda_dtype_raises(dev):
    (p, g, m, v), = _quads(dev, [16], torch.bfloat16, torch.bfloat16,
                           torch.float32)
    scal = _scalars(dev)
    for quad in [(p.half(), g, m, v), (p, g.double(), m, v),
                 (p, g, m, v.bfloat16())]:
        with pytest.raises(TypeError):
            _kernel([quad], *scal)
        step = torch.ones((), dtype=torch.int32, device=dev)
        with pytest.raises(TypeError):
            adamw.apply_adamw(CFG, [quad], step, scal[3])
    with pytest.raises(TypeError):
        K.norm_and_clip([g.half()], 1.0)


def test_apply_adamw_on_the_card_is_the_kernels_and_equals_the_plain_update(
        dev):
    """`apply_adamw` on CUDA quads goes to the kernels (launches and the
    elements tally counted; no plain op on the data) and equals `_update`
    given the kernels' norm, with the clip, c1 and c2 as the plain route
    computes them."""
    quads = _quads(dev, SIZES, torch.bfloat16, torch.bfloat16, torch.float32)
    before = [tuple(t.clone() for t in q) for q in quads]
    step = torch.tensor(4, dtype=torch.int32, device=dev)
    lr = torch.tensor(2e-4, dtype=torch.float32, device=dev)
    cfg = TrainConfig(grad_clip=0.5)
    n0 = K.LAUNCHES
    gnorm = adamw.apply_adamw(cfg, quads, step, lr)
    torch.cuda.synchronize()
    assert K.LAUNCHES - n0 == 3
    clip = torch.clamp(0.5 / torch.clamp(gnorm, min=1e-9), max=1.0)
    c1, c2 = (1.0 - b ** step.to(torch.float32)
              for b in (cfg.beta1, cfg.beta2))
    want = [tuple(t.clone() for t in q) for q in before]
    for q in want:
        adamw._update(cfg, *q, clip, c1, c2, lr)
    _assert_equal(quads, want)


def test_apply_adamw_makes_no_host_sync(dev):
    quads = _quads(dev, SIZES, torch.bfloat16, torch.bfloat16, torch.float32)
    step = torch.tensor(1, dtype=torch.int32, device=dev)
    lr = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    adamw.apply_adamw(CFG, quads, step, lr)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        adamw.apply_adamw(CFG, quads, step.add_(1), lr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_a_trace_links_the_kernels_to_their_host_ops(dev):
    """Under `torch.profiler` every AdamW kernel links to the host op
    around its launch (``adamw.norm`` or ``adamw.update``), so the
    readers of kernels launched inside a host range or span see them."""
    from torch.autograd import DeviceType
    quads = _quads(dev, SIZES, torch.bfloat16, torch.bfloat16, torch.float32)
    step = torch.tensor(1, dtype=torch.int32, device=dev)
    lr = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    adamw.apply_adamw(CFG, quads, step, lr)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        adamw.apply_adamw(CFG, quads, step.add_(1), lr)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = {}
    for ev in events:
        if ev.device_type() == DeviceType.CPU:
            host.setdefault(ev.correlation_id(), set()).add(ev.name())
    linked = {re.search(r"adamw_\w+?_kernel", ev.name()).group(0):
              host.get(ev.linked_correlation_id(), set()) for ev in events
              if ev.device_type() == DeviceType.CUDA and "adamw_" in ev.name()}
    want = {"adamw_sumsq_kernel": "adamw.norm",
            "adamw_finalize_kernel": "adamw.norm",
            "adamw_update_kernel": "adamw.update"}
    assert set(linked) == set(want), linked
    for kernel, op in want.items():
        assert op in linked[kernel], (kernel, linked[kernel])


def test_the_tally_counts_what_the_update_kernel_took(dev, monkeypatch):
    """While spans record, `apply_adamw` on CUDA quads tallies every
    element as the kernel's; with the update kernel's launches gone (its
    wrapper a no-op) the same call tallies none as the kernel's."""
    from repro_torch.obs import trace as obs_trace
    monkeypatch.setitem(adamw.FUSED, "kernel", 0)
    monkeypatch.setitem(adamw.FUSED, "all", 0)
    quads = _quads(dev, SIZES, torch.bfloat16, torch.bfloat16, torch.float32)
    n = sum(q[0].numel() for q in quads)
    step = torch.tensor(1, dtype=torch.int32, device=dev)
    lr = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    obs_trace.enable(True)
    try:
        adamw.apply_adamw(CFG, quads, step, lr)
        assert adamw.fused_tally() == (n, n)
        monkeypatch.setattr(K, "update", lambda *a, **kw: None)
        adamw.apply_adamw(CFG, quads, step.add_(1), lr)
    finally:
        obs_trace.enable(False)
    assert adamw.fused_tally() == (n, 2 * n)


def test_dtensor_shards_on_a_one_rank_mesh_take_the_update_kernel(dev):
    """ZeRO-1's route on the card: DTensor leaves on a one-rank NCCL mesh
    (`launch.mesh.host_mesh`), the moments sharded along "model", one
    parameter replicated (sliced into the moments' layout, updated, and
    gathered back) and one already in their layout. The route's norm is
    `global_norm` (PyTorch ops on the DTensors); each local shard goes to
    the update kernel, one launch a quad, and equals `_update` on plain
    copies given that norm's clip."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import host_mesh
    plain = _quads(dev, [4099, 2 * 65536 + 17], torch.bfloat16,
                   torch.bfloat16, torch.float32, seed=5)
    cfg = TrainConfig(grad_clip=0.5)
    step = torch.tensor(3, dtype=torch.int32, device=dev)
    lr = torch.tensor(2e-4, dtype=torch.float32, device=dev)
    with host_mesh(dev) as mesh:
        rep, shard = [Replicate(), Replicate()], [Replicate(), Shard(0)]
        quads = [tuple(distribute_tensor(t.clone(), mesh, pl) for t, pl in
                       zip(q, (rep if i == 0 else shard, rep, shard, shard)))
                 for i, q in enumerate(plain)]
        assert all(q[2].to_local().is_contiguous() for q in quads)
        n0 = K.LAUNCHES
        gnorm = adamw._whole(adamw.apply_adamw(cfg, quads, step, lr))
        torch.cuda.synchronize()
        assert K.LAUNCHES - n0 == len(quads)
        got = [tuple(t.to_local() for t in q) for q in quads]
    norm = adamw.global_norm(q[1] for q in plain)
    assert float(gnorm) == pytest.approx(float(norm), rel=NORM_RTOL)
    clip = torch.clamp(0.5 / torch.clamp(gnorm, min=1e-9), max=1.0)
    c1, c2 = (1.0 - b ** step.to(torch.float32)
              for b in (cfg.beta1, cfg.beta2))
    want = [tuple(t.clone() for t in q) for q in plain]
    for q in want:
        adamw._update(cfg, *q, clip, c1, c2, lr)
    # the gradients are read, not written: compare p, m and v
    _assert_equal([(p, g0, m, v) for (p, _, m, v), (_, g0, _, _)
                   in zip(got, want)], want)
