"""The port's spans (`repro_torch.obs.trace`): nothing records while off;
a profiler session turns recording on and its end off; a span lies on
the profiler's clock; parents nest per thread; a train step, a control
period and an MoE call emit their spans, the MoE call its exact slot
tally; and recording changes no output of a step."""
import dataclasses
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.configs.base import PowerControlConfig, TrainConfig  # noqa: E402
from repro_torch.core.nrm import NRM  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import ApplyOptions, init_params  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.layers import materialize, rms_norm  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.optim.adamw import adamw_init_defs  # noqa: E402


@pytest.fixture
def recorded():
    """The process-wide tracer, on and empty; off and empty after."""
    tr = obs_trace.get_tracer()
    tr.clear()
    obs_trace.enable(True)
    try:
        yield tr
    finally:
        obs_trace.enable(False)
        tr.clear()


def test_the_off_path_records_nothing():
    tr = obs_trace.get_tracer()
    tr.clear()
    before = MOE.SLOTS["computed"]
    assert not obs_trace.recording()
    assert obs_trace.span("a") is obs_trace.span("b") is tr.span("c", x=1)
    with obs_trace.span("a"), tr.span("c", x=1):
        tr.instant("i")
    cfg = tcfg.reduced(tcfg.get_config("jamba-v0.1-52b"))
    p = _moe_params(cfg)
    MOE.moe_apply(cfg, p, torch.randn(1, 16, cfg.d_model))
    assert tr.spans() == [] and tr.events() == []
    assert MOE.SLOTS["computed"] == before


def test_a_profiler_session_turns_recording_on_and_its_end_off():
    tr = obs_trace.get_tracer()
    tr.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs_trace.recording()
        with obs_trace.span("inside"):
            pass
    assert not obs_trace.recording()
    with obs_trace.span("after"):
        pass
    assert [s.name for s in tr.spans()] == ["inside"]
    tr.clear()


def test_a_span_and_a_profiler_range_agree_within_1ms():
    """The range's start lies between a clock read before it and the
    span's start, its end between the span's end and a read after it,
    within 1 ms: one clock (a preempted thread only widens the
    brackets)."""
    tr = obs_trace.get_tracer()
    tr.clear()
    ms = 1_000_000
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("first"):  # the first range pays set-up
            pass
        before = time.time_ns()
        with record_function("block"), obs_trace.span("block"):
            time.sleep(0.005)
        after = time.time_ns()
    (s,) = tr.spans()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "block"]
    assert before - ms <= ev.start_ns() <= s.start_ns + ms
    assert s.end_ns - ms <= ev.end_ns() <= after + ms
    tr.clear()


def test_parents_nest_per_thread(recorded):
    inner = threading.Event()

    def other():
        with obs_trace.span("c"):
            with obs_trace.span("d"):
                inner.set()

    with obs_trace.span("a"):
        with obs_trace.span("b"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and inner.is_set()
    s = {x.name: x for x in recorded.spans()}
    assert s["a"].parent is None and s["b"].parent == s["a"].id
    assert s["c"].parent is None and s["d"].parent == s["c"].id
    assert s["c"].thread != s["a"].thread == s["b"].thread
    assert s["a"].start_ns <= s["b"].start_ns <= s["b"].end_ns \
        <= s["a"].end_ns


def _state(cfg, tc):
    params = init_params(cfg, 0, "cpu")
    opt = materialize(adamw_init_defs(M.model_defs(cfg), tc.moment_dtype),
                      0, torch.float32, "cpu")
    return params, opt


def _flat(tree):
    from repro_torch.models.layers import tree_leaves_with_path
    return [x for _, x in tree_leaves_with_path(tree)]


@pytest.fixture(scope="module")
def two_steps():
    """One tiny starcoder2 train step from the same state with recording
    off and on -> (outputs off, outputs on, spans of the recorded step)."""
    cfg = tcfg.reduced(tcfg.get_config("starcoder2-3b"))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, tc, ApplyOptions(attn_impl="cuda",
                                                 block_q=16))
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tr = obs_trace.get_tracer()
    outs = []
    for on in (False, True):
        tr.clear()
        obs_trace.enable(on)
        try:
            params, opt = _state(cfg, tc)
            _, _, metrics = step(params, opt, batch)
        finally:
            obs_trace.enable(False)
        outs.append(_flat(params) + _flat(opt) + list(metrics.values()))
    spans = tr.spans()
    tr.clear()
    return outs[0], outs[1], spans


def test_a_train_step_emits_its_spans_once_each_in_order(two_steps):
    spans = two_steps[2]
    (step,) = [s for s in spans if s.name == "steps.train_step"]
    kids = sorted((s for s in spans if s.parent == step.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["steps.forward", "steps.backward",
                                      "adamw.apply"]
    assert len(spans) == 4
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    assert step.start_ns <= kids[0].start_ns and \
        kids[-1].end_ns <= step.end_ns


def test_step_outputs_are_bit_identical_with_recording_on_and_off(
        two_steps):
    off, on, _ = two_steps
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_a_control_period_emits_its_nrm_spans(recorded):
    nrm = NRM(PowerControlConfig(epsilon=0.1, plant_profile="gros",
                                 sampling_period=0.5), device="cpu")
    nrm.heartbeat(work=1.0, t=0.25)
    nrm.actuator.advance(0.5)
    nrm.control_step(now=0.5)
    names = [s.name for s in sorted(recorded.spans(),
                                    key=lambda s: s.start_ns)]
    assert names == ["nrm.heartbeat", "nrm.advance", "nrm.control_step"]
    assert all(s.parent is None for s in recorded.spans())


def _moe_params(cfg):
    return materialize(MOE.moe_defs(cfg), 5, torch.float32, "cpu")


def test_the_moe_slot_tally_counts_the_dispatch_exactly(recorded):
    cfg = tcfg.reduced(tcfg.get_config("jamba-v0.1-52b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))  # some tokens dropped
    p = _moe_params(cfg)
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)) + 1.0
    filled0, computed0 = MOE.slot_fill()
    MOE.moe_apply(cfg, p, x)
    filled, computed = MOE.slot_fill()
    mo = cfg.moe
    G, gsz = MOE._group_tokens(80, mo.group_size)
    C = MOE._capacity(gsz, mo.top_k, mo.num_experts, mo.capacity_factor)
    h = rms_norm(x.reshape(G, gsz, -1), p["ln"], cfg.norm_eps)
    gates = torch.softmax(torch.einsum("gsd,de->gse", h.float(),
                                       p["router"].float()), dim=-1)
    dispatch, _ = MOE._route(gates, mo.top_k, C)
    assert computed - computed0 == G * mo.num_experts * C
    assert filled - filled0 == int(torch.count_nonzero(dispatch))
    assert filled - filled0 < G * gsz * mo.top_k  # capacity dropped some
    assert [s.name for s in recorded.spans()] == ["moe.apply"]
