"""AdamW's dispatch on the CPU (`repro_torch.optim.adamw`): CPU leaves
take the plain version and never the kernels' library, the elements
tally counts only while spans record, the kernels' module imports
without nvcc, the wrappers refuse what they do not take before any
build, and the quads every training path hands to AdamW are ones the
kernels take. The kernels themselves run in
`tests/test_torch_adamw_cuda.py`, on the card."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import _build
from repro_torch.kernels.adamw import kernel as K
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw


def _quads(shapes, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    r = lambda s: torch.randn(s, generator=gen).to(dtype)
    return [(r(s), r(s), r(s), r(s).abs()) for s in shapes]


@pytest.fixture
def no_library(monkeypatch):
    """Any attempt to build or load a kernel library fails the test."""
    def refuse(*_):
        raise AssertionError("the CPU route loaded a kernel library")
    monkeypatch.setattr(_build, "load", refuse)


def test_cpu_leaves_take_the_plain_route(no_library):
    """`apply_adamw` on CPU tensors equals `global_norm` and `_update`
    piece by piece, without loading the kernels."""
    cfg = TrainConfig(grad_clip=0.5)
    quads = _quads([(3, 5), (7,)])
    want = [tuple(t.clone() for t in q) for q in quads]
    step, lr = torch.tensor(2, dtype=torch.int32), torch.tensor(1e-2)
    gnorm = adamw.apply_adamw(cfg, quads, step, lr)
    norm = adamw.global_norm(q[1] for q in want)
    clip = torch.clamp(0.5 / torch.clamp(norm, min=1e-9), max=1.0)
    c1, c2 = (1.0 - b ** step.float() for b in (cfg.beta1, cfg.beta2))
    for q in want:
        adamw._update(cfg, *q, clip, c1, c2, lr)
    assert torch.equal(gnorm, norm)
    for got, exp in zip(quads, want):
        for a, b in zip(got, exp):
            assert torch.equal(a, b)


def test_fused_tally_counts_only_while_spans_record(monkeypatch):
    monkeypatch.setitem(adamw.FUSED, "kernel", 0)
    monkeypatch.setitem(adamw.FUSED, "all", 0)
    cfg, step, lr = TrainConfig(), torch.tensor(1), torch.tensor(1e-3)
    adamw.apply_adamw(cfg, _quads([(4, 3), (5,)]), step, lr)
    assert adamw.fused_tally() == (0, 0)
    obs_trace.enable(True)
    try:
        adamw.apply_adamw(cfg, _quads([(4, 3), (5,)]), step, lr)
        adamw.apply_adamw(cfg, _quads([(2,)]), step, lr)
    finally:
        obs_trace.enable(False)
    assert adamw.fused_tally() == (0, 19)  # on the CPU, none by a kernel
    adamw.apply_adamw(cfg, _quads([(6,)]), step, lr)
    assert adamw.fused_tally() == (0, 19)


def test_fused_tally_takes_the_kernels_count_of_what_they_updated(
        monkeypatch):
    """The tally's first column is what the update kernel's launches
    counted (`ELEMENTS`) during the call, not where the tensors lie: a
    call whose launches took 7 elements of 19 reads (7, 19)."""
    monkeypatch.setitem(adamw.FUSED, "kernel", 0)
    monkeypatch.setitem(adamw.FUSED, "all", 0)
    plain = adamw.plain_apply

    def launching_seven(*a):
        monkeypatch.setattr(K, "ELEMENTS", K.ELEMENTS + 7)
        return plain(*a)

    monkeypatch.setattr(adamw, "plain_apply", launching_seven)
    cfg, step, lr = TrainConfig(), torch.tensor(1), torch.tensor(1e-3)
    obs_trace.enable(True)
    try:
        adamw.apply_adamw(cfg, _quads([(4, 3), (7,)]), step, lr)
    finally:
        obs_trace.enable(False)
    assert adamw.fused_tally() == (7, 19)


def test_a_mix_of_gradient_kinds_raises():
    quads = _quads([(3,), (2,)])
    quads[1] = (quads[1][0], torch.zeros(2, device="meta"), *quads[1][2:])
    with pytest.raises(ValueError, match="one kind"):
        adamw.apply_adamw(TrainConfig(), quads, torch.tensor(1),
                          torch.tensor(1e-3))


def test_the_kernels_module_imports_without_nvcc(tmp_path):
    """Importing the optimizer and the kernels' wrapper builds and loads
    nothing, with no nvcc anywhere: the build runs in the first launch."""
    code = ("import repro_torch.optim.adamw, repro_torch.launch.steps\n"
            "from repro_torch.kernels import _build\n"
            "from repro_torch.kernels.adamw import kernel\n"
            "assert not _build._LOADED, _build._LOADED\n"
            "assert kernel.LAUNCHES == 0\n"
            "import shutil; assert shutil.which('nvcc') is None\n"
            "print('ok')\n")
    env = {**os.environ, "PATH": str(tmp_path),
           "CUDA_HOME": str(tmp_path / "none"),
           "PYTHONPATH": os.pathsep.join(p for p in sys.path if p)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_wrappers_refuse_cpu_tensors(no_library):
    (p, g, m, v), = _quads([(9,)])
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        K.update([(p, g, m, v)], one, one, one, one, 0.9, 0.95, 1e-8, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        K.norm_and_clip([g], 1.0)


@pytest.mark.parametrize("bad, err", [
    ({"p": torch.float16}, TypeError),
    ({"g": torch.float64}, TypeError),
    ({"m": torch.bfloat16}, TypeError),  # m bf16 with v float32
    ({"v": "strided"}, ValueError),
    ({"g": "short"}, ValueError),
])
def test_group_refuses_what_the_kernels_do_not_take(bad, err):
    (p, g, m, v), = _quads([(4, 6)])
    quad = {"p": p, "g": g, "m": m, "v": v}
    for name, how in bad.items():
        t = quad[name]
        quad[name] = (t.t() if how == "strided" else t[:3] if how == "short"
                      else t.to(how))
    with pytest.raises(err):
        K.group([tuple(quad.values())])


def test_group_keys_the_quads_by_type_and_drops_empty_ones():
    bf = _quads([(5,)], torch.bfloat16)[0]
    f32 = _quads([(5,)])[0]
    mixed = (bf[0], f32[1], f32[2], f32[3])
    empty = tuple(torch.empty(0) for _ in range(4))
    groups = K.group([bf, f32, mixed, empty, f32])
    assert {k: len(v) for k, v in groups.items()} == {
        (torch.bfloat16,) * 3: 1, (torch.float32,) * 3: 2,
        (torch.bfloat16, torch.float32, torch.float32): 1}


_PATHS = {"plain": {}, "microbatch": {"microbatch": 1},
          "int8_ef": {"grad_compression": "int8_ef"},
          "bf16 moments": {"moment_dtype": "bfloat16"}}


@pytest.mark.parametrize("path", list(_PATHS))
@pytest.mark.parametrize("arch", ["starcoder2-3b", "jamba-v0.1-52b"])
def test_training_paths_give_quads_the_kernels_take(arch, path,
                                                    monkeypatch):
    """The quads `make_train_step` hands to AdamW, with bf16 params as the
    benchmark's cells run them, pass the kernels' checks (`group`) once
    their gradients are made contiguous, as `apply_adamw` makes them."""
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.models.layers import materialize
    from repro_torch.models.types import ApplyOptions
    from repro_torch.optim.compression import ef_init_defs
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    tcfg = TrainConfig(**_PATHS[path])
    seen = []

    def spy(tc, quads, step, lr):
        seen.append(list(quads))
        return adamw.apply_adamw(tc, quads, step, lr)

    monkeypatch.setattr(S, "apply_adamw", spy)
    fn = S.make_train_step(cfg, tcfg, ApplyOptions())
    defs = M.model_defs(cfg)
    params = materialize(defs, 0, cfg.param_dtype, "cpu")
    opt = materialize(adamw.adamw_init_defs(defs, tcfg.moment_dtype), 0,
                      torch.float32, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    args = [params, opt, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}]
    if tcfg.grad_compression == "int8_ef":
        args.append(materialize(ef_init_defs(defs), 0, torch.float32, "cpu"))
    fn(*args)
    quads = [(p, g.contiguous(), m, v) for p, g, m, v in seen[0]]
    groups = K.group(quads)
    assert sum(map(len, groups.values())) == sum(
        q[0].numel() > 0 for q in quads)
    assert all(k[0] in K.TYPES and k[2] == getattr(torch, tcfg.moment_dtype)
               for k in groups)
