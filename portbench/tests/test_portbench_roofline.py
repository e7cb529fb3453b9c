"""The frozen counts reproduce the bounds of PERF.md's kernel table at
its shapes, and the step counts behind each `*_mfu`."""
from __future__ import annotations

import pytest

from portbench import roofline as r
from portbench import spec
from portbench.roofline import model as m


def test_flash_forward_at_the_qwen3_8b_prefill():
    f, b = r.flash_fwd(8, 1024, 32, 8, 128)
    assert f == pytest.approx(6.879e10, rel=1e-3)
    assert r.bound_s(f, b) * 1e3 == pytest.approx(0.0696, rel=2e-3)


def test_flash_backward_at_the_starcoder2_3b_step():
    f, b = r.flash_bwd(4, 2048, 24, 2, 128)
    assert f == pytest.approx(2.578e11, rel=1e-3)
    assert b / 1e6 == pytest.approx(218.9, rel=1e-3)
    assert r.bound_s(f, b) * 1e3 == pytest.approx(0.2607, rel=2e-3)


def test_decode_attention_at_the_qwen3_8b_decode_step():
    f, b = r.decode_attn(8, 1056, 32, 8, 128, live=1056)
    assert b / 1e6 == pytest.approx(35.27, rel=1e-3)
    assert r.bound_s(f, b) * 1e3 == pytest.approx(0.0105, rel=5e-3)


def test_the_scan_at_the_jamba_prefill():
    f, b = r.scan(8, 1024, 8192, 16)
    assert b / 1e9 == pytest.approx(0.811, rel=1e-3)
    assert f == pytest.approx(6.644e9, rel=1e-3)
    assert r.bound_s(f, b, rate=r.FP32_PER_S) * 1e3 == pytest.approx(
        0.2421, rel=2e-3)


def test_the_step_counts():
    sc2 = spec.cell("sc2-3b.train-power").config["as_run"]
    jam = spec.cell("jamba-52b.prefill-pool").config["as_run"]
    # starcoder2-3b: 3.03e9 products' parameters (no embedding), 1.58e14
    # model flop a step of 4 x 2,048 tokens
    assert m.matmul_params(sc2) + m.head_params(sc2) == pytest.approx(
        3.03e9, rel=2e-3)
    assert m.train_step_flops(sc2, 4, 2048) == pytest.approx(1.584e14,
                                                             rel=2e-3)
    # one jamba period: 13.3e9 parameters held, 2.9e9 active a token
    # (top-2 of 16 experts)
    assert m.weight_bytes(jam) / 2 + jam["vocab_size"] * jam["d_model"] \
        == pytest.approx(13.3e9, rel=1e-2)
    assert m.matmul_params(jam) == pytest.approx(2.90e9, rel=1e-2)
