#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA
GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases, each of which fails the run if a check fails:

1. set-up: the card, the torch/CUDA versions and the kernel build from
   the sources in this checkout (timed);
2. the closed-loop kernel on both noise routes (seeds: the noise
   generated inside the kernel; tensor: `draw_noise`'s tensor read) against
   the plain version on `draw_noise` of the same seeds, and against each
   other, at the parity bar, in trace and summary mode (summary equal to
   trace bit for bit), at the shapes of `parity.CARD_CASES` in float32 and
   bf16 rows and on one 4,096-run x 2,048-step grid, with the share of runs
   bit-equal between the routes;
3. the main path at real size: `sweep` over gros/dahu/yeti x 11
   epsilons x 3,072 seeds (101,376 runs, 2,048 steps) in summary mode,
   with the launches by route, the `draw_noise` calls and the plain
   version's calls read around it (1 seeds-route launch, no other), the
   peak device memory, physical checks and a profile of its device time;
4. the paper's headline (eps = 0.1 on gros) through a trace-mode `sweep`
   and `simulate_closed_loop`;
5. on the main path's own inputs (101,376 runs, summary mode): the seeds
   route against phase 3's sweep (equal), the tensor route and the plain
   version (at the bar), with the bit-equal share; timings with CUDA
   events (warm-up, median of 3 to 7), in turns: the fused kernel and the
   tensor route beside their bounds, `draw_noise`, the plain version, the
   sweep's wall on each route, and both routes in trace mode;
6. the flash-attention kernels (bf16 on the tensor cores, float32 on the
   SIMT route, as `flash_attention.kernel.route` sends them) and the
   split-KV decode kernels with their combine against their plain versions
   on the card (`attention_cases`: the reference tests' shapes, head_dim
   120, ragged lengths, narrow windows, the serving shapes);
7. the LM serving path at full width: `repro_torch.launch.serve.main`
   on qwen3-8b (36 layers, d_model 4096, vocab 151,936, bf16, random
   weights from seed 0), batch 8, 1,024-token prompts, 32 tokens,
   with the attention kernels' launch counts (and the flash kernel's by
   route: all on the tensor cores) read around it; then the
   same weights' prefill and teacher-forced decode logits through the
   kernels against the plain attention path, and prefill + decode
   against `forward` at full width with 2 layers;
8. timings with CUDA events: prefill and one decode step at full width,
   and each attention kernel at its serving shape (and the float32 flash
   route) beside its bound, its plain version and
   `scaled_dot_product_attention` (the library yardstick; the port never
   calls it), as device time per call and as time per call with the
   host's enqueue; then qwen3-8b's weights are freed;
9. the selective-scan kernel against its plain version on the card at
   every case of `selective_scan.cases` (the reference tests' shapes and
   bf16 bucket, ragged state sizes, channels and sequences, a 4,096-step
   sequence, the jamba serving shape; decode steps from a non-zero state
   in float32 and bf16), ``y`` and the final state each at its bar, each
   call launched on the instance `kernel.route` names (sequence for
   S > 1, step for S == 1) and on the template `cases.exact_instance`
   names (exact or masked generic), as the C entry reports it; then its
   built SASS: the sequence instance
   stages its tiles with asynchronous copies (LDGSTS), the step instance
   loads the state with 128-bit loads, neither touches local memory;
10. jamba-v0.1-52b at full width and one pattern unit (8 of 32 layers:
   7 Mamba, 1 attention, MoE on 4; bf16, random weights from seed 0)
   through `repro_torch.launch.serve.serve`, batch 8, 1,024-token
   prompts, 32 tokens, with the three kernels' launch counts read around
   it (the scan's by instance: 7 sequence, 224 step, none on the generic
   template); its logits against the plain paths on the same weights;
   one Mamba block at full width in float32, kernel route against
   chunked route; timings of prefill, a decode step and the scan kernel
   beside its bound (the larger of its bytes at the HBM rate and its
   float32 operations at 67 TFLOP/s) and plain version (no library call
   computes the scan), at the serving shape by CUDA events around one
   call and as device time per call, and, as device time per call with
   the inputs cold and warm in L2, at the decode shape;
11. the paper's identification and evaluation path on the card, which
   has no kernel of its own: Fig. 3's staircase (`plant.simulate`; the
   saturation bar on gros and dahu), Fig. 4's static campaign through
   `sim.open_loop_runs` and `identify.fit_static` (Table 2 recovered to
   the reference tests' bars), Fig. 5's `sim.replay_model` and
   `identify.fit_dynamics` (tau and the dynamic K_L at rel 0.05), the
   Poisson-heartbeat scan engine (`sweep(backend="scan")`) on phase 3's
   main grid (seed means within rtol 0.05 of phase 3's kernel route, no
   closed-loop kernel launch, every Poisson draw resolved, a 97-seed
   sub-grid bit-equal to the full grid's rows), its wall, runs/s, peak
   memory, launches per step and device idle share (`torch.profiler`,
   device activity only, over the main grid cut to 256 steps), and
   Fig. 7 at the reference's
   full size on both engines with its open-loop baseline (all runs
   complete, the trade-off direction holds);
12. policies and adaptation on the card, which bring no kernel of their
   own: phase 3's main grid through the policy front end
   (`sweep(policies=PIPolicy())`: one seeds-route launch, every run equal
   to phase 3's); `benchmarks/beyond_adaptive.py`'s gain shift (gros
   gains on a plant with twice gros's K_L, work 6,000; RLS-adaptive PI
   within 1.05x the fixed gains' time) and its `--full` RLS lambda grid
   (gros, dahu x 5 eps x 10 lambdas x 1,000 seeds = 100,000 runs on the
   scan engine: all finite, a 97-seed sub-grid bit-equal; wall, runs/s,
   peak memory, the best lambda, launches per step and idle share from a
   256-step profile); `benchmarks/policy_faceoff.py`'s `--full` face-off
   (PI traces harvested on gros, dahu, yeti x 8 seeds, offline RL fitted
   on the card with 100 iterations, PI, offline RL and duty-cycle raced
   x 30 seeds in one heterogeneous sweep: PI and duty-cycle complete,
   duty-cycle below 0.9 x pcap_max at eps 0.3, the PI lane of a mixed
   sweep bit-equal to a pure packed-PI sweep; per (profile, policy) time,
   energy and median progress over the setpoint; the race's launches
   per step);
13. the scenario axes on the card (phased workloads, change detection,
   faults, the guard and the flight recorder), which bring no kernel of
   their own (every run on the scan engine, no closed-loop launch):
   `benchmarks/fig8_phases.py` at `--full` (offline RL fitted on a PI
   harvest of gros, dahu x 2 seeds; PI, RLS-adaptive PI, offline RL and
   duty-cycle x gros, dahu x 20 seeds on the STREAM -> DGEMM -> STREAM
   schedule, without and with the detector) and `fig9_chaos.py` at
   `--full` (PI, RLS-adaptive PI and duty-cycle x 6 blackout rates x 16
   seeds x 4,000 s, unguarded and guarded), each held to the reference's
   own `--full` numbers (`tools/scenario_reference.py`) within
   `SCEN_SIGMAS` combined standard errors, the guard cutting RLS-adaptive
   PI's error at rates >= 0.10 and fig. 9's rate-0 lane bit-equal
   between the arms; the main grid under every axis at once (fig. 8's
   schedule, the detector, `chaos_schedule(0.10)`, the guard, 64-slot
   rings): all finite, a 97-seed sub-grid bit-equal, decoded rings
   against the guard's and the detector's counters and the scripts'
   windows, its wall, runs/s, peak memory, launches per step and idle
   share (a 256-step profile), and the step loop's launches per step by
   axis set; and bitwise neutrality at the main grid's size (512 steps):
   a no-op fault script, an untriggered guard and the recorder leave
   every run with no invalid signal equal to the plain sweep's;
14. the execution layer and the NRM runtime on the card (`[runtime]`
   lines), which bring no kernel of their own: (a) phase 3's main grid
   in chunks of 16,384 (exactly 7 seeds-route launches, every output
   bit-equal to phase 3's one-shot sweep; wall, peak memory); (b) a
   1,013,760-run summary grid in chunks of 131,072 (wall, runs/s, peak
   device memory under half of what the grid would hold one-shot, beside
   a one-shot grid of about one chunk, a 97-seed sub-grid bit-equal to
   its own one-shot sweep); (c)
   the scan engine on 4,096 runs at 2,048 steps in 2 chunks, bit-equal
   to one-shot, with both walls; (d) `sweep(durable=dir)` of the main
   grid under `FlakyGridFn` transients (one injected fault, one CUDA
   out-of-memory error), then the same campaign in a spawned child that
   SIGKILLs itself after 3 commits and `resume_campaign(dir)` finishing
   it, both bit-equal to phase 3; (e) `NRM.run_simulated` on gros at
   eps 0.0 and 0.1 over 8 seeds (256-step bucket) held to the reference
   tests' headline bars, a 3-segment resumed run whose work keeps
   rising, and 500 `control_step` periods on a `SimulatedPowerActuator`
   on the card and on the CPU (ms per period); (f) `serve.main` with
   ``--power`` on qwen3-8b at full width, its tokens equal to phase 7's,
   its decode tok/s against phase 7's and the simulated energy and time;
15. the fleet, the multi-tenant control plane and the observability
   services on the card (`[fleet]`, `[plane]`, `[serve]`, `[obs]`
   lines), which bring no kernel of their own: (a) the reference's
   `beyond/fleet_64` and `fleet_1024` (steady power under the budget by
   `test_fleet_respects_power_budget`'s bar, finite rows) and a
   1,024-node gros / dahu / yeti fleet under PI / RLS-PI / duty-cycle
   with phase-staggered schedules (the allocation shifts to the class
   that flips compute-bound); (b) `fleet_sweep` of 30 seeds x 1,024
   nodes x 60 steps in chunks of 8 (two rows against `simulate_fleet`
   at rtol 1e-6), then durable in a child SIGKILLed after 2 commits and
   resumed by `resume_campaign`, bit-equal; (c) `benchmarks/
   plane_load.py`'s tenant mix at 1k, 10k and 100k tenants x 20 ticks
   (ticks/s, tenant-ticks/s), a chunked tick equal to the unchunked one,
   one blacked-out guarded tenant quarantined with the others
   bit-identical, a snapshot restored in a fresh process making the same
   decisions; (d) `serve --power --plane --obs-port 0` on qwen3-8b, its
   tokens equal to phase 7's, `/metrics`, `/metrics.json`,
   `/events?log=plane` and `/healthz` scraped from a thread during the
   call and passed through `obs.validate`; (e) `regress` over
   BENCH_sim.json on the card, the CPU's report and exit code. Each step
   prints its wall, its launches a step or a tick, the device's idle
   share and its peak memory.

The set-up also reads the built SASS: the fused closed-loop summary loop
must touch no memory but its shared histograms (no LDG), the bf16 flash
kernel must hold warpgroup products (HGMMA) and TMA loads (UTMALDG), the
decode kernels must copy the cache with 16-byte loads only (LDGSTS ...
.128), and the bf16 one must multiply on the tensor cores (HMMA); and it
checks that the fused closed-loop instance keeps the main grid resident
in one wave.

Prints a `kernels` JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or without the port's sources beside it.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the float32 rate
# outside the tensor cores (67 TFLOP/s counts an FMA as two flops). The
# kernel is built with -fmad=false and its exp, log, sqrt and divisions
# are instruction sequences, so its operations are counted as the SASS
# instructions of its time loop (`repro_torch.kernels.sass`), against
# the issue rate: 4 x 32 thread-instructions per SM per clock, the fp32
# rate with an FMA counted once.
HBM_BYTES_PER_S = 3.35e12
ISSUE_PER_S = 67e12 / 2
# closed-loop kernel bytes per live run-step on the tensor route: 5
# float32 noise reads (the seeds route reads none); 7 float32 trace
# writes in trace mode
NOISE_BYTES_PER_STEP = 5 * 4
TRACE_BYTES_PER_STEP = 7 * 4
# the float32 instances of the closed-loop kernel with 16-bit histogram
# counters (the main path's rows and horizon), by noise route and mode:
# closed_loop_kernel<float, seeds, collect, 16>
CL_KERNELS = {("seeds", "summary"): "closed_loop_kernelIfLb1ELb0ELi16E",
              ("seeds", "trace"): "closed_loop_kernelIfLb1ELb1ELi16E",
              ("noise", "summary"): "closed_loop_kernelIfLb0ELb0ELi16E",
              ("noise", "trace"): "closed_loop_kernelIfLb0ELb1ELi16E"}
# the main grid: 3 profiles x 11 epsilons x 3,072 seeds
MAIN_RUNS = 3 * 11 * 3072

EPS_GRID = [round(0.05 * i, 2) for i in range(11)]

# H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet); the attention
# kernels' inputs are bf16 on the serving path, where both run on the
# tensor cores, so their operation bound is taken at this rate.
# FP32_PER_S is the float32 rate outside the tensor cores, the floor of
# the flash kernel's float32 (SIMT) route.
BF16_PER_S = 989e12
FP32_PER_S = 67e12
# the serving run of phase 7: qwen3-8b at full width and depth, nothing cut
SERVE_ARGV = ["--arch", "qwen3-8b", "--batch", "8", "--prompt-len", "1024",
              "--gen", "32", "--seed", "0", "--quiet"]
# bf16 logits of the kernel path against the plain path: relative L2
# error. bf16 keeps 8 bits (unit roundoff 3.9e-3); 36 layers of
# independent roundings in the residual stream add up to ~6x that, and
# the two paths round at different places (the flash kernel rounds its
# unnormalised probabilities to bf16, the plain path its normalised ones;
# the decode kernel keeps 16 bits of them, the plain path 8).
LOGITS_REL_TOL = 0.05
# jamba (phase 10) in bf16. Its MoE router makes the error per step
# bimodal: most steps read the bf16 floor (the two plain paths 8.5e-3
# apart at the median), and a step where one path's top-2 router gates
# fall in another order reads 0.07-0.14 in any pair of paths, the two
# plain paths included (measured on an H100: PERF.md). So the median over
# prefill and the 32 steps is held to 2.3x that floor, and the worst
# step to twice the worst floor reading.
JAMBA_BF16_MEDIAN_TOL = 0.02
JAMBA_BF16_WORST_TOL = 0.25
# the same model in float32 at batch 2 for GEN_F32 steps: the paths
# differ only in summation order (4.4e-6 at prefill and ~1.2e-6 per step
# on an H100, PERF.md), so a lost tile or state would show far above this
JAMBA_F32_REL_TOL = 1e-4
GEN_F32 = 8
# one Mamba block in float32, kernel against chunked route: the log-depth
# scan associates the decays in another order (a few ulps per level of
# its 8 levels)
MAMBA_F32_REL_TOL = 1e-5
# the float32 instances of the selective-scan kernel at d_state 16 (the
# serving path's): the sequence instance, whose tile loop (the loop that
# holds the exps) runs SCAN_TILE steps a pass, and the step instance
SCAN_KERNEL = "selective_scan_seq_kernelIfLi16ELb0E"
SCAN_STEP_KERNEL = "selective_scan_step_kernelIfLi16ELb0E"
SCAN_TILE = 4
# the scan's float32 operations per state element (dt A, dA h, dt x B,
# their sum, h C and its sum) and per channel-step (dt x, x D, y's sum)
SCAN_FLOPS_PER_STATE = 6
SCAN_FLOPS_PER_CHANNEL = 3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=7, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rel_err(a, b) -> float:
    """Relative L2 error of ``a`` against ``b``, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def hopper_paths(wgmma_lib, decode_lib) -> None:
    """The built SASS of the attention kernels: the bf16 flash kernel (both
    head-dim instances) issues warpgroup products (HGMMA) and TMA loads
    (UTMALDG); the decode kernels (bf16 and float32 at hd 128) copy the
    cache with 16-byte loads only (LDGSTS ... .128), and the bf16 one
    multiplies on the tensor cores (HMMA)."""
    from repro_torch.kernels import sass
    for hdp in (64, 128):
        ops = sass.opcodes(sass.kernel_instructions(
            wgmma_lib, f"flash_fwd_wgmma_kernelILi{hdp}E"))
        hgmma = sum(n for op, n in ops.items() if op.startswith("HGMMA."))
        tma = sum(n for op, n in ops.items() if op.startswith("UTMALDG."))
        check(hgmma > 0 and tma > 0, f"flash wgmma kernel (hd <= {hdp}): "
              f"{hgmma} HGMMA, {tma} UTMALDG")
        print(f"[setup] flash_fwd_wgmma_kernel<{hdp}> SASS: {hgmma} HGMMA ("
              + ", ".join(sorted(op for op in ops if op.startswith("HGMMA.")))
              + f"), {tma} UTMALDG")
    for part in ("decode_attention_mma_kernelILi128E",
                 "decode_attention_kernelIfLi128ELi4E"):
        ops = sass.opcodes(sass.kernel_instructions(decode_lib, part))
        copies = {op: n for op, n in ops.items() if op.startswith("LDGSTS")}
        check(copies and all(op.endswith(".128") for op in copies),
              f"{part}: cache copies {copies}")
        hmma = sum(n for op, n in ops.items() if op.startswith("HMMA."))
        if "mma" in part:
            check(hmma > 0, f"{part}: no HMMA")
        print(f"[setup] {part} SASS: cache copies {copies}; {hmma} HMMA")


def closed_loop_sass(lib, dev) -> dict:
    """Set-up reading of the closed-loop kernel: the instructions on the
    shortest pass of each float32 instance's time loop (its operation
    bound); the fused summary loop touching no memory but its shared
    histograms (no LDG: nothing is read per step); the fused instance's
    resources (the main grid resident in one wave); and the written-out
    cosine against libdevice's cosf at every generator argument. Returns
    {(route, mode): instructions}."""
    import torch
    from repro_torch.kernels import sass
    from repro_torch.kernels.closed_loop import kernel as K

    counts = {}
    for key, part in CL_KERNELS.items():
        instrs = sass.kernel_instructions(lib, part)
        counts[key] = sass.loop_instructions(instrs)
        if key == ("seeds", "summary"):
            ops = sass.opcodes(sass.loop_body(instrs))
            mem = {op: n for op, n in ops.items() if op.startswith(("LD", "ST"))}
            check(mem and {op.split(".")[0] for op in mem} <= {"LDS", "STS"},
                  f"fused summary loop's memory instructions {mem}")
            print(f"[setup] fused summary loop SASS: memory instructions "
                  f"{mem} (no LDG: no per-step read of device memory); "
                  f"{ops.get('MUFU.RSQ', 0)} MUFU.RSQ, "
                  f"{ops.get('MUFU.EX2', 0)} MUFU.EX2, "
                  f"{ops.get('MUFU.LG2', 0)} MUFU.LG2, "
                  f"{ops.get('F2I.NTZ', 0)} F2I.NTZ")
    print("[setup] closed-loop SASS instructions per live step on the "
          "shortest pass of the time loop: " + ", ".join(
              f"{route} route {mode} {n}" for (route, mode), n in
              counts.items()))
    res = K.resources(torch.float32, True, False, K.bin_bits(2048), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = res["blocks_per_sm"] * res["block_threads"] * sms
    print(f"[setup] fused summary instance: {res['registers']} registers, "
          f"{res['local_bytes']} local bytes a thread, {res['blocks_per_sm']}"
          f" blocks of {res['block_threads']} resident per SM, "
          f"{res['shared_bytes']} shared bytes a block: {resident} runs "
          f"resident on {sms} SMs")
    check(resident >= MAIN_RUNS, f"the {MAIN_RUNS}-run main grid does not "
          f"fit one wave ({resident} runs resident)")
    print(f"[setup] written-out cosine against libdevice cosf at the 2^24 "
          f"generator arguments: {K.cos_mismatches(dev)} differ")
    return counts


def both_routes(p, g, seeds, noise, sc, plain, tag):
    """Both routes of the closed-loop kernel on the same runs (``seeds``,
    and ``noise`` = `draw_noise` of them), each in trace and summary mode:
    each route's summary mode bit-equal to its trace mode, each at the
    parity bar against ``plain`` (the plain version's trace-mode result on
    ``noise``) and the two routes at the bar against each other. Returns
    the three largest differences and the (traces, final) of the seeds
    route and of the tensor route."""
    import torch
    from repro_torch.kernels.closed_loop import kernel as K
    from repro_torch.kernels.closed_loop.parity import check_parity

    T = noise.shape[0]
    out = {}
    for route, call in (
            ("seeds", lambda c: K.closed_loop_seeds_cuda(p, g, seeds, T, sc,
                                                         collect=c)),
            ("tensor", lambda c: K.closed_loop_cuda(p, g, noise, sc,
                                                    collect=c))):
        tr, blk = call(True)
        _, blk_s = call(False)
        fin, fin_s = K.unpack_final(*blk), K.unpack_final(*blk_s)
        torch.cuda.synchronize()
        for k in fin:
            check(torch.equal(fin[k], fin_s[k]),
                  f"{tag} {route} route: summary {k} != trace mode's")
        out[route] = (tr, fin)
    errs = (check_parity(*out["seeds"], *plain, tag=f"{tag} seeds route"),
            check_parity(*out["tensor"], *plain, tag=f"{tag} tensor route"),
            check_parity(*out["seeds"], *out["tensor"],
                         tag=f"{tag} seeds route against tensor route"))
    return errs, (out["seeds"], out["tensor"])


def runs_equal(fa, fb, ta=None, tb=None) -> int:
    """How many runs of one batch hold bit-equal outputs in two results:
    final dicts ``fa``, ``fb`` and, if given, trace dicts ``ta``, ``tb``."""
    import torch
    B = fa["t"].shape[0]
    same = torch.ones(B, dtype=torch.bool, device=fa["t"].device)
    for k in fa:
        same &= (fa[k] == fb[k]).reshape(B, -1).all(1)
    for k in (ta or {}):
        same &= (ta[k] == tb[k]).all(0)
    return int(same.sum())


def bound(n_bytes, steps, instr):
    """The least time of a closed-loop launch that moves ``n_bytes`` and
    runs ``steps`` live run-steps of ``instr`` instructions: (ms, "bytes"
    or "operations", how it was counted)."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = steps * instr / ISSUE_PER_S * 1e3
    how = (f"bytes {n_bytes / 1e9:.4f} GB -> {bytes_ms:.4f} ms; {instr} "
           f"instructions x {steps} run-steps -> {ops_ms:.4f} ms")
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", how)


@contextlib.contextmanager
def tensor_route(ops):
    """Send `closed_loop_sim`'s seeds through `draw_noise` and the kernel's
    tensor route, as the main path ran before the noise moved into the
    kernel: for phase 5's timing in turns only."""
    run = ops.closed_loop_sim

    def via_tensor(prof, gains, seeds, **kw):
        T = ops.horizon(kw["max_time"], kw["dt"])
        return run(prof, gains, ops.draw_noise(seeds, T, prof.device), **kw)

    ops.closed_loop_sim = via_tensor
    try:
        yield
    finally:
        ops.closed_loop_sim = run


def attention_parity(dev) -> dict:
    """Phase 6: both attention kernels against their plain versions on
    the card, at `attention_cases`' shapes; returns the largest
    |kernel - plain| of each."""
    import torch
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.kernels.decode_attention import ref as DR
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    t0 = time.perf_counter()
    for case in AC.FLASH_CASES + [AC.FLASH_SERVE, AC.FLASH_SERVE_F32]:
        causal, window, dtype = case[5:]
        q, k, v = AC.flash_inputs(case, dev)
        path = FK.route(q.dtype, q.shape[-1])
        check(path == ("wgmma" if dtype == "bfloat16" else "simt"),
              f"flash {case} routed to {path}")
        before = FK.ROUTE_LAUNCHES[path]
        got = FK.flash_attention_cuda(q, k, v, causal=causal, window=window)
        check(FK.ROUTE_LAUNCHES[path] == before + 1, f"flash {case}: the "
              f"{path} count did not move")
        torch.cuda.synchronize()
        want = FR.attention_ref(q, k, v, causal=causal, window=window)
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(),
                             **AC.tolerance(dtype)),
              f"flash {case}: max |kernel - plain| = {err}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        print(f"[parity] flash_attention {case} ({path}): max |kernel - "
              f"plain| = {err:.3e}")
    # the bf16 serving shape once more, row by row against the float32
    # plain version on the same inputs, beside the plain version's own bf16
    # reading; a kernel that lost 32 keys for the last 64 query rows (a
    # quarter of one of the tensor-core kernel's 128-key tiles, for half of
    # one warpgroup's rows) reads what `AC.drop_kv_tile` gives
    causal, window = AC.FLASH_SERVE[5:7]
    q, k, v = AC.flash_inputs(AC.FLASH_SERVE, dev)
    got = FK.flash_attention_cuda(q, k, v, causal=causal, window=window)
    ref32 = FR.attention_ref(q.float(), k.float(), v.float(),
                             causal=causal, window=window)
    row = AC.row_rel_err(got, ref32)
    plain_row = AC.row_rel_err(FR.attention_ref(q, k, v, causal=causal,
                                                window=window), ref32)
    S = q.shape[1]
    last = slice(S - 64, S)
    faults = {"its last KV tile": slice(S - 32, S),
              "a middle KV tile": slice(S // 2, S // 2 + 32)}
    reads = {name: AC.row_rel_err(AC.drop_kv_tile(
        q, k, v, last, keys, causal=causal, window=window), ref32)
        for name, keys in faults.items()}
    del ref32
    print(f"[parity] flash_attention {AC.FLASH_SERVE}: largest row "
          f"relative L2 against float32 on the same inputs {row:.4e} "
          f"(bar {AC.ROW_REL_BAR:.1e}; the plain version in bf16 reads "
          f"{plain_row:.4e}); a kernel that drops, for the last "
          f"64 query rows, " + "; ".join(
              f"{n} reads {r:.4e}" for n, r in reads.items()))
    check(row <= AC.ROW_REL_BAR,
          f"flash {AC.FLASH_SERVE}: row relative L2 {row} > "
          f"{AC.ROW_REL_BAR}")
    check(min(reads.values()) > AC.ROW_REL_BAR,
          f"the row bar {AC.ROW_REL_BAR} does not separate a dropped KV "
          f"tile: {reads}")
    errs["flash_row_rel"] = row
    errs["flash_plain_row_rel"] = plain_row
    errs["flash_fault_row_rel"] = min(reads.values())
    for case in AC.DECODE_CASES + [AC.DECODE_SERVE]:
        q, k, v, k_pos, pos, chunk = AC.decode_inputs(case, dev)
        chunk = chunk or DK.default_chunk(q.shape[0], k.shape[2],
                                          k.shape[1])
        got, part = DK.decode_attention_cuda(q, k, v, k_pos, pos, chunk)
        torch.cuda.synchronize()
        plain = DR.decode_partials_ref(q, k, v, k_pos, pos, chunk)
        # float32 partials whatever the input type: summation order only
        # (the bf16 kernel keeps P as two bf16 parts, 2^-18 of each p)
        for name, a, b, atol in zip(("m", "l", "acc"), part, plain,
                                    (1e-5, 1e-4, 1e-4)):
            check(torch.allclose(a, b, atol=atol, rtol=1e-5),
                  f"decode {case}: partial {name}")
        want = DO.combine(*plain, q.dtype)
        oracle = DR.decode_attention_ref(q, k, v, k_pos, pos)
        tol = AC.tolerance(case[-1])
        check(torch.allclose(got.float(), want.float(), **tol)
              and torch.allclose(got.float(), oracle.float(), **tol),
              f"decode {case}: output")
        err = float((got.float() - want.float()).abs().max())
        errs["decode_attention"] = max(errs["decode_attention"], err)
        print(f"[parity] decode_attention {case} chunk {chunk}: max "
              f"|kernel - plain| = {err:.3e} (output, the kernels' combine "
              f"against `combine` of the plain partials), partials within "
              f"1e-4")
    print(f"[parity] attention kernels agree with their plain versions "
          f"at {len(AC.FLASH_CASES) + len(AC.DECODE_CASES) + 3} shapes "
          f"({time.perf_counter() - t0:.1f} s)")
    return errs


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel ops (flash and decode attention, the
    selective scan) to their plain versions, also on CUDA tensors: for the
    comparison runs of phases 7 and 10 only (the port's ops never fall
    back)."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.kernels.decode_attention import ref as DR
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.models import attention as A
    from repro_torch.models import mamba as MB

    def flash(q, k, v, q_pos=None, k_pos=None, *, causal, window, block):
        return attention_ref(q, k, v, causal=causal, window=window)

    def decode(q, k, v, k_pos, pos, *, block_k=None):
        chunk = block_k or DK.default_chunk(q.shape[0], k.shape[2],
                                            k.shape[1])
        return DO.combine(*DR.decode_partials_ref(q, k, v, k_pos, pos,
                                                  chunk), q.dtype)

    saved = A.flash_attention, A.decode_attention, MB.selective_scan
    A.flash_attention, A.decode_attention = flash, decode
    MB.selective_scan = selective_scan_ref
    try:
        yield
    finally:
        A.flash_attention, A.decode_attention, MB.selective_scan = saved


@contextlib.contextmanager
def counting_plain_calls():
    """Count every call of a plain path the model could take instead of a
    kernel (the kernels' plain versions, the plain attention cores, the
    chunked scan); yields a one-element list holding the count."""
    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.selective_scan import ops as SO
    from repro_torch.models import attention as A
    from repro_torch.models import mamba as MB

    plain = [0]
    patched = [(FO, "attention_ref"), (DO, "decode_partials_ref"),
               (A, "_score_block"), (A, "_score_block_grouped"),
               (SO, "selective_scan_ref"), (MB, "_chunked_scan")]
    saved = [getattr(m, n) for m, n in patched]

    def counted(fn):
        def wrapped(*a, **kw):
            plain[0] += 1
            return fn(*a, **kw)
        return wrapped

    for (m, n), fn in zip(patched, saved):
        setattr(m, n, counted(fn))
    try:
        yield plain
    finally:
        for (m, n), fn in zip(patched, saved):
            setattr(m, n, fn)


def compare_paths(cfg, params, batch, gen, served, kern, ref):
    """The kernel path (``kern``) against the kernels' plain versions (the
    same options under `plain_kernels`) and the model's plain path
    (``ref``) on the same weights: prefill, then ``gen`` decode steps fed
    the served tokens (teacher forcing). Returns the relative L2 errors of
    the logits at prefill and each step, [kernel vs plain versions,
    kernel vs plain path, plain versions vs plain path (the floor)], and
    the served tokens the rerun reproduces. The caller holds them to its
    bars."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, prefill

    B, P = batch["tokens"].shape
    dev = batch["tokens"].device

    def run(opts, plain_ops, fn, *args):
        if plain_ops:
            with plain_kernels():
                return fn(cfg, opts, params, *args)
        return fn(cfg, opts, params, *args)

    def errs(lk, lv, lp):
        check(bool(torch.isfinite(lk).all()), "kernel-path logits not finite")
        return [rel_err(lk, lv), rel_err(lk, lp), rel_err(lv, lp)]

    paths = ((kern, False), (kern, True), (ref, False))
    with torch.no_grad():
        outs = [run(o, po, prefill, batch) for o, po in paths]
        series = [errs(*(lo for lo, _ in outs))]
        caches = [serve.rehome_cache(cfg, c, B, P + gen) for _, c in outs]
        fed = torch.cat([outs[0][0].argmax(-1)[:, None],
                         torch.from_numpy(served[:, :gen - 1]).to(dev)],
                        dim=1)
        del outs
        same = 0
        for j in range(gen):
            step = {"tokens": fed[:, j:j + 1]}
            logits = []
            for i, (o, po) in enumerate(paths):
                lo, caches[i] = run(o, po, decode_step, caches[i], step)
                logits.append(lo)
            same += int((logits[0].argmax(-1).cpu().numpy()
                         == served[:, j]).sum())
            series.append(errs(*logits))
    return series, same


def print_comparison(tag, series, same, n_tokens, bar, plain_path):
    """One line on `compare_paths`' readings (the worst and the median
    over prefill and the decode steps), and the per-step series."""
    def stats(i):
        col = sorted(e[i] for e in series)
        return f"worst {col[-1]:.3e}, median {col[len(col) // 2]:.3e}"

    print(f"[{tag}] kernel path vs the kernels' plain versions, same weights "
          f"and tokens, logits rel L2 err over prefill and "
          f"{len(series) - 1} teacher-forced decode steps: {stats(0)}; vs "
          f"the model's plain path ({plain_path}): {stats(1)} (bar {bar}); "
          f"the two plain paths against each other (the floor): {stats(2)}"
          + (f"; the rerun reproduces {same} of {n_tokens} served tokens"
             if same is not None else ""))
    print(f"[{tag}] per step, kernel vs plain versions / vs plain path / "
          f"floor: " + " ".join(f"{a:.2e}/{b:.2e}/{c:.2e}"
                                for a, b, c in series))


def worst_kernel_err(series) -> float:
    return max(max(e[:2]) for e in series)


def median_kernel_err(series) -> float:
    return max(sorted(e[i] for e in series)[len(series) // 2]
               for i in range(2))


def serving_path(dev):
    """Phase 7: qwen3-8b served at full width through the kernels; then
    the kernel path's logits against the plain attention path on the
    same weights, and prefill + decode against `forward` (2 layers).
    Returns the launch counts of the serving run and the weights and
    prompts for phase 8."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch import serve
    from repro_torch.models import (ApplyOptions, decode_step, forward,
                                    init_params, prefill)

    cfg = get_config("qwen3-8b")
    B, P, GEN = 8, 1024, 32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # count every call of a plain path: the serving run makes none
    with counting_plain_calls() as plain:
        FK.LAUNCHES, DK.LAUNCHES = 0, 0
        FK.ROUTE_LAUNCHES.update(wgmma=0, simt=0)
        t0 = time.perf_counter()
        res = serve.main(SERVE_ARGV)
        wall = time.perf_counter() - t0
        launches = {"flash_attention": FK.LAUNCHES,
                    "decode_attention": DK.LAUNCHES}
        routes = dict(FK.ROUTE_LAUNCHES)
    L = cfg.num_layers
    check(launches == {"flash_attention": L, "decode_attention": L * GEN},
          f"serving launches {launches}, expected {L} and {L * GEN}")
    check(routes == {"wgmma": L, "simt": 0}, f"flash launches by route "
          f"{routes}: every prefill layer must take the tensor-core kernel")
    check(plain[0] == 0, f"serving path called a plain version "
          f"{plain[0]} times")
    gen = res["generated"]
    check(gen.shape == (B, GEN) and gen.min() >= 0
          and gen.max() < cfg.vocab_size, "generated tokens")
    print(f"[serve] qwen3-8b full width ({L} layers, "
          f"{cfg.param_count() / 1e9:.3f} B parameters, bf16), batch {B}, "
          f"prompt {P}, {GEN} tokens: main() {wall:.2f} s wall (weights, "
          f"prefill, decode); decode loop {res['wall_s']} s, "
          f"{res['tok_per_s_sim']} tok/s; launches flash {L} (by route: "
          f"wgmma {routes['wgmma']}, simt {routes['simt']}), decode "
          f"{L * GEN} (one partials and one combine kernel each); "
          f"plain-version calls 0; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the same weights and prompts through three paths: the kernels, the
    # kernels' plain versions, and the model's plain attention path
    t0 = time.perf_counter()
    kern = ApplyOptions(attn_impl="cuda")
    params = init_params(cfg, 0, dev)
    batch = serve.make_prompts(cfg, B, P, 0, dev)
    series, same = compare_paths(cfg, params, batch, GEN, gen, kern,
                                 ApplyOptions(attn_impl="reference"))
    print_comparison("serve", series, same, B * GEN, LOGITS_REL_TOL,
                     "attn_impl 'reference'")
    check(worst_kernel_err(series) <= LOGITS_REL_TOL,
          f"qwen3-8b kernel-path logits rel L2 err "
          f"{worst_kernel_err(series)} > {LOGITS_REL_TOL}")
    print(f"[serve] three paths compared in "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p2 = init_params(cfg2, 1, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, P + 4),
                         generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        full, _ = forward(cfg2, kern, p2, {"tokens": toks})
        lk, c2 = prefill(cfg2, kern, p2, {"tokens": toks[:, :P]})
        errs = [rel_err(lk, full[:, P - 1])]
        c2 = serve.rehome_cache(cfg2, c2, 2, P + 4)
        for j in range(3):
            lk, c2 = decode_step(cfg2, kern, p2, c2,
                                 {"tokens": toks[:, P + j:P + j + 1]})
            errs.append(rel_err(lk, full[:, P + j]))
    check(max(errs) <= LOGITS_REL_TOL, f"decode vs forward {errs}")
    del p2, full, c2
    torch.cuda.empty_cache()
    print(f"[serve] prefill + decode vs forward, qwen3-8b widths x 2 "
          f"layers, prompt {P}: rel L2 err "
          + " ".join(f"{e:.3e}" for e in errs)
          + f" ({time.perf_counter() - t0:.1f} s)")
    return launches, params, batch, res


def device_breakdown(fn, label: str, host_ops: bool = True,
                     quiet: bool = False):
    """Print the device time of one call of ``fn`` by kernel family and
    its share of the call's wall time, from `torch.profiler`, and return
    ``{"wall_us", "busy_us", "launches"}`` (None when not measured). A
    reading, not a check: if the profiler gives no device events it says
    so. ``host_ops=False`` records the device's activity only: over tens
    of thousands of launches, recording every host op slows the host and
    so inflates the idle share it reads. ``quiet`` prints nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU] * host_ops
                     + [ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        groups = {}
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            name = ev.name.lower()
            fam = ("closed_loop kernel" if "closed_loop" in name else
                   "copies" if "memcpy" in name or "memset" in name else
                   "flash_attention kernel" if "flash_fwd" in name else
                   "decode_attention kernels" if "decode_attention" in name
                   or "decode_combine" in name
                   else "selective_scan kernel" if "selective_scan" in name
                   else "matmul" if any(w in name for w in (
                       "gemm", "cutlass", "xmma", "nvjet", "sm90"))
                   else "other")
            n, us = groups.get(fam, (0, 0.0))
            groups[fam] = (n + 1, us + ev.time_range.elapsed_us())
        busy = sum(us for _, us in groups.values())
        if not groups:
            print(f"[profile] {label}: no device events; not measured")
            return None
        if not quiet:
            print(f"[profile] {label}: wall {wall_us / 1e3:.3f} ms, device"
                  f" busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%,"
                  f" idle {100 - 100 * busy / wall_us:.1f}%); "
                  + "; ".join(f"{fam} {us / 1e3:.3f} ms in {n} launches"
                              for fam, (n, us) in sorted(
                                  groups.items(), key=lambda x: -x[1][1])))
        return {"wall_us": wall_us, "busy_us": busy,
                "launches": sum(n for n, _ in groups.values())}
    except Exception as e:  # a reading only: the smoke's checks stand
        print(f"[profile] {label}: not measured ({type(e).__name__}: {e})")
        return None


def attention_timings(dev, serving, errs) -> list:
    """Phase 8: prefill and decode-step time at full width, and each
    attention kernel at its serving shape beside its bound, its plain
    version and the library call. Returns the kernels' JSON rows."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.kernels.decode_attention import ref as DR
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.timing import device_ms, in_turns
    from repro_torch.launch import serve
    from repro_torch.models import ApplyOptions, decode_step, prefill

    launches, params, batch, _ = serving
    cfg = get_config("qwen3-8b")
    kern = ApplyOptions(attn_impl="cuda")
    with torch.no_grad():
        pre_ms = cuda_ms(lambda: prefill(cfg, kern, params, batch), reps=3,
                         warmup=1)
        _, cache = prefill(cfg, kern, params, batch)
        cache = serve.rehome_cache(cfg, cache, 8, 1056)
        step = {"tokens": batch["tokens"][:, :1]}
        # the last step of the serve: every one of the 1,056 slots live
        def dec():
            decode_step(cfg, kern, params,
                        {"blocks": cache["blocks"], "pos": 1055}, step)

        dec_ms = cuda_ms(dec, reps=10, warmup=2)
        device_breakdown(lambda: prefill(cfg, kern, params, batch),
                         "prefill, batch 8 x 1,024 tokens")
        device_breakdown(dec, "one decode step, batch 8, 1,056 positions")
    del params, batch, cache
    torch.cuda.empty_cache()
    print(f"[time] qwen3-8b full width, batch 8: prefill of 1,024 tokens "
          f"{pre_ms:.3f} ms ({8 * 1024 / pre_ms * 1e3:.0f} tok/s); one "
          f"decode step at 1,056 cached positions {dec_ms:.3f} ms "
          f"({8 / dec_ms * 1e3:.1f} tok/s)")

    rows = []
    # flash attention, one prefill layer: the tensor-core kernel (bf16, the
    # serving path's) and SDPA in turns, then the float32 SIMT route
    B, S, H, K, hd = AC.FLASH_SERVE[:5]
    q, k, v = AC.flash_inputs(AC.FLASH_SERVE, dev)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def flash_call():
        FK.flash_attention_cuda(q, k, v)

    def flash_lib():
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)

    f_ms, f_lib = in_turns(flash_call, flash_lib)
    f_call = cuda_ms(flash_call, reps=20, warmup=3)
    f_lib_call = cuda_ms(flash_lib, reps=20, warmup=3)
    f_plain = cuda_ms(lambda: FR.attention_ref(q, k, v), reps=5, warmup=1)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    f32_ms = device_ms(lambda: FK.flash_attention_cuda(q32, k32, v32),
                       reps=5, warmup=1)
    del q32, k32, v32
    f_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    # causal: each row attends to its own prefix, S (S + 1) / 2 pairs, and
    # each pair costs 2 hd flops in Q K^T and 2 hd in P V
    f_flops = 4 * B * H * hd * S * (S + 1) / 2
    f_bytes_ms = f_bytes / HBM_BYTES_PER_S * 1e3
    f_ops_ms = f_flops / BF16_PER_S * 1e3
    f_bound = max(f_bytes_ms, f_ops_ms)
    f32_bound = max(2 * f_bytes_ms, f_flops / FP32_PER_S * 1e3)
    print(f"[time] flash_attention tensor-core kernel {AC.FLASH_SERVE}: "
          f"{f_ms:.4f} ms on the card ({f_call:.4f} ms per call with the "
          f"host's enqueue); bound {f_bound:.4f} ms by "
          f"{'operations' if f_ops_ms >= f_bytes_ms else 'bytes'} "
          f"({f_flops:.4g} flop at the bf16 tensor rate {f_ops_ms:.4f} ms; "
          f"{f_bytes / 1e6:.1f} MB {f_bytes_ms:.4f} ms); "
          f"{100 * f_bound / f_ms:.1f}% of the bound, "
          f"{f_flops / f_ms / 1e9:.1f} TFLOP/s; plain version "
          f"{f_plain:.3f} ms; scaled_dot_product_attention {f_lib:.4f} ms "
          f"({f_lib_call:.4f} ms per call); kernel / SDPA "
          f"{f_ms / f_lib:.3f}")
    print(f"[time] flash_attention SIMT route, float32 at the same shape: "
          f"{f32_ms:.4f} ms on the card; its floor {f32_bound:.4f} ms (the "
          f"flops at the float32 rate outside the tensor cores)")
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
        "launches": launches["flash_attention"],
        "max_abs_err": errs["flash_attention"], "ms": f_ms,
        "plain_ms": f_plain, "bound_ms": f_bound,
        "bound_by": "operations" if f_ops_ms >= f_bytes_ms else "bytes",
        "library_ms": f_lib})
    del q, k, v, qt, kt, vt

    # split-KV decode, one decode layer (partials and combine, one call);
    # four caches in turn so that each call finds its 34.6 MB cold in the
    # 50 MB L2, as a layer does
    B, T, H, K, hd, pos = AC.DECODE_SERVE[:6]
    sets = [AC.decode_inputs(AC.DECODE_SERVE, dev, seed=i) for i in range(4)]
    q, _, _, k_pos, _, _ = sets[0]
    chunk = DK.default_chunk(B, K, T)
    ring = itertools.cycle(sets)

    def decode_call():
        qq, kk, vv, kp, _, _ = next(ring)
        DK.decode_attention_cuda(qq, kk, vv, kp, pos, chunk)

    lib_sets = [(qq[:, :, None], kk.transpose(1, 2).contiguous(),
                 vv.transpose(1, 2).contiguous())
                for qq, kk, vv, _, _, _ in sets]
    lib_ring = itertools.cycle(lib_sets)

    def decode_lib():
        qq, kk, vv = next(lib_ring)
        F.scaled_dot_product_attention(qq, kk, vv, enable_gqa=True)

    d_ms, d_lib = in_turns(decode_call, decode_lib, reps=40, warmup=4)
    d_call = cuda_ms(decode_call, reps=40, warmup=4)
    d_lib_call = cuda_ms(decode_lib, reps=40, warmup=4)
    d_plain = cuda_ms(lambda: DO.combine(*DR.decode_partials_ref(
        *sets[0][:4], pos, chunk), q.dtype), reps=10)
    k0 = sets[0][1]
    n_split = -(-T // chunk)
    live = int((k_pos >= 0).sum())  # every slot is live at pos 1055
    # q, the live K and V rows and k_pos read once; the partials and o
    # written once
    d_bytes = (2 * q.numel() * q.element_size() + 2 * B * live * K * hd
               * k0.element_size() + k_pos.numel() * 4
               + B * H * n_split * (hd + 2) * 4)
    d_flops = 4 * B * H * live * hd
    d_bytes_ms = d_bytes / HBM_BYTES_PER_S * 1e3
    d_ops_ms = d_flops / BF16_PER_S * 1e3
    d_bound = max(d_bytes_ms, d_ops_ms)
    print(f"[time] decode_attention kernels {AC.DECODE_SERVE}, {n_split} "
          f"splits of {chunk}, partials and combine: {d_ms:.4f} ms on the "
          f"card ({d_call:.4f} ms per call with the host's enqueue); bound "
          f"{d_bound:.4f} ms by "
          f"{'bytes' if d_bytes_ms >= d_ops_ms else 'operations'} "
          f"({d_bytes / 1e6:.2f} MB, {d_bytes / d_ms / 1e6:.1f} GB/s "
          f"achieved); {100 * d_bound / d_ms:.1f}% of the bound; plain "
          f"version {d_plain:.3f} ms; scaled_dot_product_attention "
          f"{d_lib:.4f} ms ({d_lib_call:.4f} ms per call); kernels / SDPA "
          f"{d_ms / d_lib:.3f}")
    rows.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:28",
        "launches": launches["decode_attention"],
        "max_abs_err": errs["decode_attention"], "ms": d_ms,
        "plain_ms": d_plain, "bound_ms": d_bound,
        "bound_by": "bytes" if d_bytes_ms >= d_ops_ms else "operations",
        "library_ms": d_lib})
    return rows


def scan_parity(dev, scan_lib) -> float:
    """Phase 9: the selective-scan kernel against its plain version on the
    card at every case of `selective_scan.cases` (the reference tests'
    shapes with their bf16 bucket, the ragged ones, the 4,096-step one,
    the jamba serving shape in float32; the decode steps from a non-zero
    state), ``y`` and ``h_last`` each at its bar, each launch on the
    instance `kernel.route` names; then the built SASS and resources of
    the serving path's instances (float32, d_state 16). Returns the
    largest |kernel - plain|."""
    import torch
    from repro_torch.kernels import sass
    from repro_torch.kernels.selective_scan import cases as SC
    from repro_torch.kernels.selective_scan import kernel as SK
    from repro_torch.kernels.selective_scan import ref as SR

    worst, worst_share = 0.0, 0.0
    t0 = time.perf_counter()
    runs = [(c, False) for c in SC.SCAN_CASES + SC.SCAN_RAGGED
            + [SC.SCAN_LONG, SC.SCAN_SERVE]] + [(c, True)
                                                 for c in SC.SCAN_STEPS]
    for case, with_h0 in runs:
        x, dt, A, Bc, Cc, D, h0 = SC.scan_inputs(case, dev, with_h0=with_h0)
        routes, generic = dict(SK.ROUTE_LAUNCHES), SK.GENERIC_LAUNCHES
        y, h = SK.selective_scan_cuda(x, dt, A, Bc, Cc, D, h0)
        torch.cuda.synchronize()
        routes[SK.route(case[1])] += 1
        exact = SC.exact_instance(case)
        check(SK.ROUTE_LAUNCHES == routes, f"selective_scan {case[:5]}: "
              f"launches by instance {SK.ROUTE_LAUNCHES}, expected {routes}")
        check(SK.GENERIC_LAUNCHES == generic + (not exact),
              f"selective_scan {case[:5]}: the launch took the "
              f"{'exact' if SK.GENERIC_LAUNCHES == generic else 'generic'} "
              f"template, expected the {'exact' if exact else 'generic'} one")
        yr, hr = SR.selective_scan_ref(x, dt, A, Bc, Cc, D, h0)
        ey = float((y.float() - yr.float()).abs().max())
        eh = float((h - hr).abs().max())
        tol = SC.tolerance(case[4])
        share = max(float(((y.float() - yr.float()).abs() / (
            tol["atol"] + tol["rtol"] * yr.float().abs())).max()),
            float(((h - hr).abs() / (SC.F32_TOL["atol"] + SC.F32_TOL["rtol"]
                                     * hr.abs())).max()))
        check(torch.allclose(y.float(), yr.float(), **tol),
              f"selective_scan {case[:5]}: y, max |kernel - plain| {ey}")
        check(torch.allclose(h, hr, **SC.F32_TOL),
              f"selective_scan {case[:5]}: h_last, max |kernel - plain| {eh}")
        worst, worst_share = max(worst, ey, eh), max(worst_share, share)
        print(f"[parity] selective_scan {case[:5]}"
              f"{' from h0' if with_h0 else ''} ({SK.route(case[1])}, "
              f"{'exact' if exact else 'generic'}): max "
              f"|kernel - plain| y {ey:.3e} (|y| <= "
              f"{float(yr.float().abs().max()):.3g}), h_last {eh:.3e}; "
              f"{share:.3f} of the bar")
    print(f"[parity] selective_scan agrees with its plain version at "
          f"{len(runs)} shapes, at most {worst_share:.3f} of the bar; "
          f"launches by instance {SK.ROUTE_LAUNCHES}, of the generic "
          f"template {SK.GENERIC_LAUNCHES} ({time.perf_counter() - t0:.1f} s)")

    seq = sass.kernel_instructions(scan_lib, SCAN_KERNEL)
    step = sass.opcodes(sass.kernel_instructions(scan_lib, SCAN_STEP_KERNEL))
    seq_ops = sass.opcodes(seq)
    copies = {op: n for op, n in seq_ops.items()
              if op.startswith(("LDGSTS", "UTMALDG"))}
    wide = {op: n for op, n in step.items()
            if op.startswith("LDG") and ".128" in op}
    check(copies, f"sequence instance: no asynchronous copy (LDGSTS or "
          f"UTMALDG) in {dict(seq_ops)}")
    check(wide, f"step instance: no 128-bit load in {dict(step)}")
    for name, ops in (("sequence", seq_ops), ("step", step)):
        check(not sass.local_memory(ops), f"{name} instance touches local "
              f"memory: {sass.local_memory(ops)}")
    body = sass.opcodes(sass.loop_body(seq, "MUFU.EX2"))
    res = {k: SK.resources(k, dev)
           for k in ("seq", "step")}
    print(f"[parity] selective_scan SASS: sequence instance copies {copies}, "
          f"its tile loop {sass.loop_instructions(seq, 'MUFU.EX2')} "
          f"instructions a pass on the shortest path ({SCAN_TILE} steps, "
          f"{body.get('MUFU.EX2', 0)} MUFU.EX2, "
          f"{body.get('SHFL.BFLY', 0)} SHFL.BFLY); step instance loads "
          f"{wide}; no local memory in either; resources {res}")
    return worst


def jamba_serving(dev, scan_err) -> dict:
    """Phase 10: jamba-v0.1-52b at full width and one pattern unit (8
    layers: 7 Mamba, 1 attention, MoE on odd positions) served through the
    serving driver with the launch counts read around it; the kernel
    path's logits against the plain paths; one Mamba block in float32,
    kernel against chunked route; timings. Returns the scan kernel's
    JSON row."""
    import dataclasses
    import itertools

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.selective_scan import cases as SC
    from repro_torch.kernels.selective_scan import kernel as SK
    from repro_torch.kernels.selective_scan import ref as SR
    from repro_torch.kernels.timing import device_ms
    from repro_torch.launch import serve
    from repro_torch.models import (ApplyOptions, decode_step, init_params,
                                    prefill)
    from repro_torch.models import mamba as MB

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=8)
    B, P, GEN = 8, 1024, 32
    n_mamba = sum(b.kind == "mamba" for b in cfg.pattern) * cfg.num_repeats
    n_attn = cfg.num_layers - n_mamba
    want = {"selective_scan": n_mamba * (1 + GEN),
            "flash_attention": n_attn, "decode_attention": n_attn * GEN}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counting_plain_calls() as plain:
        SK.LAUNCHES, FK.LAUNCHES, DK.LAUNCHES = 0, 0, 0
        FK.ROUTE_LAUNCHES.update(wgmma=0, simt=0)
        SK.ROUTE_LAUNCHES.update(seq=0, step=0)
        SK.GENERIC_LAUNCHES = 0
        t0 = time.perf_counter()
        res = serve.serve(cfg, B, P, GEN, seed=0, device=dev)
        wall = time.perf_counter() - t0
        launches = {"selective_scan": SK.LAUNCHES,
                    "flash_attention": FK.LAUNCHES,
                    "decode_attention": DK.LAUNCHES}
        routes = dict(FK.ROUTE_LAUNCHES)
        scan_routes = dict(SK.ROUTE_LAUNCHES)
        scan_generic = SK.GENERIC_LAUNCHES
    check(launches == want, f"jamba serving launches {launches}, expected "
          f"{want}")
    check(scan_routes == {"seq": n_mamba, "step": n_mamba * GEN},
          f"jamba scan launches by instance {scan_routes}: the prefill must "
          f"take the sequence instance, every decode step the step one")
    check(scan_generic == 0, f"jamba scan: {scan_generic} launches took the "
          f"masked generic template; every launch must take an exact one")
    check(routes == {"wgmma": n_attn, "simt": 0}, f"jamba flash launches "
          f"by route {routes}: the prefill must take the tensor-core kernel")
    check(plain[0] == 0, f"jamba serving path called a plain version "
          f"{plain[0]} times")
    gen = res["generated"]
    check(gen.shape == (B, GEN) and gen.min() >= 0
          and gen.max() < cfg.vocab_size, "jamba generated tokens")
    print(f"[jamba] jamba-v0.1-52b full width, 8 of 32 layers ("
          f"{n_mamba} Mamba, {n_attn} attention, 4 MoE; "
          f"{cfg.param_count() / 1e9:.3f} B parameters, bf16), batch {B}, "
          f"prompt {P}, {GEN} tokens: serve() {wall:.2f} s wall (weights, "
          f"prefill, decode); decode loop {res['wall_s']} s, "
          f"{res['tok_per_s_sim']} tok/s; launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items())
          + f" (flash by route: wgmma {routes['wgmma']}, simt "
          f"{routes['simt']}; scan by instance: seq {scan_routes['seq']}, "
          f"step {scan_routes['step']}, generic template {scan_generic})"
          + f"; plain-version calls 0; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    t0 = time.perf_counter()
    kern = ApplyOptions(attn_impl="cuda", scan_impl="cuda")
    plain_opts = ApplyOptions(attn_impl="reference", scan_impl="chunked")
    params = init_params(cfg, 0, dev)
    batch = serve.make_prompts(cfg, B, P, 0, dev)
    series, same = compare_paths(cfg, params, batch, GEN, gen, kern,
                                 plain_opts)
    print_comparison("jamba", series, same, B * GEN,
                     f"median {JAMBA_BF16_MEDIAN_TOL}, worst "
                     f"{JAMBA_BF16_WORST_TOL}",
                     "attn_impl 'reference', scan_impl 'chunked'")
    check(median_kernel_err(series) <= JAMBA_BF16_MEDIAN_TOL
          and worst_kernel_err(series) <= JAMBA_BF16_WORST_TOL,
          f"jamba bf16 kernel-path logits rel L2 err: median "
          f"{median_kernel_err(series)}, worst {worst_kernel_err(series)}")
    print(f"[jamba] three paths compared in {time.perf_counter() - t0:.1f} s")

    # timings: prefill and the last decode step at full width
    with torch.no_grad():
        pre_ms = cuda_ms(lambda: prefill(cfg, kern, params, batch), reps=3,
                         warmup=1)
        _, cache = prefill(cfg, kern, params, batch)
        cache = serve.rehome_cache(cfg, cache, B, P + GEN)
        step = {"tokens": batch["tokens"][:, :1]}

        def dec():
            decode_step(cfg, kern, params,
                        {"blocks": cache["blocks"], "pos": P + GEN - 1},
                        step)

        dec_ms = cuda_ms(dec, reps=10, warmup=2)
        device_breakdown(lambda: prefill(cfg, kern, params, batch),
                         "jamba prefill, batch 8 x 1,024 tokens")
        device_breakdown(dec, "jamba decode step, batch 8, 1,056 positions")
    del params, batch, cache
    torch.cuda.empty_cache()
    print(f"[time] jamba-v0.1-52b full width x 8 layers, batch 8: prefill of "
          f"1,024 tokens {pre_ms:.3f} ms ({8 * 1024 / pre_ms * 1e3:.0f} "
          f"tok/s); one decode step at 1,056 cached positions {dec_ms:.3f} "
          f"ms ({8 / dec_ms * 1e3:.1f} tok/s)")

    # the same model in float32 at batch 2, where the paths differ only in
    # summation order: the kernel path against the plain paths end to end,
    # then its first Mamba block, kernel route against chunked route
    # (which forms the [B, S, 8192, 16] tensors)
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = init_params(cfg32, 0, dev)
    batch32 = serve.make_prompts(cfg32, 2, P, 0, dev)
    series32, _ = compare_paths(cfg32, p32, batch32, GEN_F32, gen[:2], kern,
                                plain_opts)
    print_comparison("jamba f32", series32, None, 0, JAMBA_F32_REL_TOL,
                     "attn_impl 'reference', scan_impl 'chunked'")
    check(worst_kernel_err(series32) <= JAMBA_F32_REL_TOL,
          f"jamba float32 kernel-path logits rel L2 err "
          f"{worst_kernel_err(series32)} > {JAMBA_F32_REL_TOL}")
    mix = {k: v[0] for k, v in p32["blocks"][0]["mix"].items()}
    x32 = torch.randn((2, P, cfg.d_model),
                      generator=torch.Generator().manual_seed(4)).to(dev)
    with torch.no_grad():
        outs = [MB.mamba_prefill(cfg32, ApplyOptions(scan_impl=impl), mix,
                                 x32) for impl in ("cuda", "chunked")]
    blk_err = rel_err(outs[0][0], outs[1][0])
    ssm_err = rel_err(outs[0][1]["ssm"], outs[1][1]["ssm"])
    check(blk_err <= MAMBA_F32_REL_TOL and ssm_err <= MAMBA_F32_REL_TOL,
          f"Mamba block f32: kernel vs chunked {blk_err}, {ssm_err}")
    del outs, p32, batch32, mix, x32
    torch.cuda.empty_cache()
    print(f"[jamba] one Mamba block, full width, float32, batch 2 x {P}: "
          f"kernel route vs chunked route rel L2 err output {blk_err:.3e}, "
          f"final ssm state {ssm_err:.3e} (bar {MAMBA_F32_REL_TOL}) "
          f"({time.perf_counter() - t0:.1f} s for the float32 checks)")

    # the kernel at the serving shape, beside its bound and plain version
    def scan_bound(inputs, outputs, n_states):
        """(ms, "bytes" or "operations", how): each input read once, each
        output written once, at the HBM rate; the float32 operations at
        the rate outside the tensor cores."""
        n_bytes = sum(t.numel() * t.element_size()
                      for t in inputs + outputs if t is not None)
        flops = (SCAN_FLOPS_PER_STATE * n_states
                 + SCAN_FLOPS_PER_CHANNEL * inputs[0].numel())
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_PER_S * 1e3
        return (max(bytes_ms, ops_ms),
                "bytes" if bytes_ms >= ops_ms else "operations",
                f"{n_bytes / 1e6:.3f} MB -> {bytes_ms:.4f} ms; {flops:.4g} "
                f"flop -> {ops_ms:.4f} ms")

    Bs, S, d, N = SC.SCAN_SERVE[:4]
    x, dt, A, Bc, Cc, D, _ = SC.scan_inputs(SC.SCAN_SERVE, dev)
    # two readings: CUDA events around one call (the `ms` of the kernels
    # line, as for every earlier kernel), which count the call's host work
    # (checks, allocations) too, and device time per call behind a spin
    # kernel, which does not
    k_ms = cuda_ms(lambda: SK.selective_scan_cuda(x, dt, A, Bc, Cc, D),
                   reps=20, warmup=3)
    k_dev_ms = device_ms(lambda: SK.selective_scan_cuda(x, dt, A, Bc, Cc, D),
                         reps=10, warmup=3)
    p_ms = cuda_ms(lambda: SR.selective_scan_ref(x, dt, A, Bc, Cc, D),
                   reps=3, warmup=1)
    y, h = SK.selective_scan_cuda(x, dt, A, Bc, Cc, D)
    bound, by, how = scan_bound([x, dt, A, Bc, Cc, D], [y, h], Bs * S * d * N)
    del x, dt, A, Bc, Cc, D, y, h
    print(f"[time] selective_scan kernel {SC.SCAN_SERVE}: {k_ms:.4f} ms by "
          f"CUDA events around one call, {k_dev_ms:.4f} ms device time per "
          f"call; bound {bound:.4f} ms by {by} ({how}); "
          f"{100 * bound / k_ms:.1f}% of the bound by events, "
          f"{100 * bound / k_dev_ms:.1f}% by device time; plain version "
          f"{p_ms:.3f} ms")
    # the decode shape: one step from the cached state, 7 launches per
    # decode step of a serve; shorter than its host enqueue, so device
    # time; eight input sets in turn (78 MB) so that each call finds its
    # state cold in the 50 MB L2, as a decode layer does, and one set
    # (warm) beside it
    sets = [SC.scan_inputs(SC.SCAN_STEP, dev, seed=i, with_h0=True)
            for i in range(8)]
    ring = itertools.cycle(sets)
    dec_cold = device_ms(lambda: SK.selective_scan_cuda(*next(ring)),
                         reps=40, warmup=4)
    dec_warm = device_ms(lambda: SK.selective_scan_cuda(*sets[0]),
                         reps=40, warmup=4)
    yd, hd = SK.selective_scan_cuda(*sets[0])
    d_bound, d_by, d_how = scan_bound(list(sets[0]), [yd, hd],
                                      sets[0][-1].numel())
    del sets, ring, yd, hd
    print(f"[time] selective_scan kernel at the decode shape {SC.SCAN_STEP} "
          f"from a state: {dec_cold:.4f} ms device time per call with its "
          f"inputs cold in L2, {dec_warm:.4f} ms warm; bound {d_bound:.4f} "
          f"ms by {d_by} ({d_how}); {100 * d_bound / dec_cold:.1f}% of the "
          f"bound cold, {100 * d_bound / dec_warm:.1f}% warm; "
          f"{launches['selective_scan'] - n_mamba} such launches per serve")
    print("[time] library yardstick for the selective scan: none (no "
          "single PyTorch call computes it)")
    return {"name": "selective_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/selective_scan/csrc/"
                      "selective_scan.cu",
            "replaces": "src/repro/kernels/selective_scan/kernel.py:25",
            "launches": launches["selective_scan"], "max_abs_err": scan_err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


# Fig. 7 of the reference (`benchmarks/fig7_pareto.py`) at its full size:
# its eps grid, 30 reps, 6,000 work units and a 2,000 s horizon
FIG7_EPS = (0.0, 0.01, 0.02, 0.05, 0.08, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5)
FIG7_REPS = 30
FIG7_WORK = 6000.0
FIG7_TIME = 2000.0
# phase 11's sub-grid: 97 of the main grid's 3,072 seeds (every 32nd and
# the last), against the same rows of the full grid
SUB_SEEDS = list(range(0, 3072, 32)) + [3071]
# phase 11 profiles the scan engine over the main grid cut to this
# horizon (its minimum bucket), device activity only: launches per step
# and the idle share are per-step readings, and a 2,048-step trace holds
# ~10^6 profiler events
PROFILE_STEPS = 256
# the scan engine against the kernel route: the same model, other random
# streams (Poisson heartbeats against rounded Gaussians), as the port's
# CPU test compares the two engines
ENGINE_RTOL = 0.05
# phase 12: `benchmarks/beyond_adaptive.py`'s RLS lambda grid at its
# `--full` size and its gain-shift scenario, `benchmarks/
# policy_faceoff.py` at its `--full` size
LAMS = (0.9, 0.95, 0.97, 0.98, 0.99, 0.992, 0.995, 0.997, 0.999, 0.9995)
LAM_GRID = (("gros", "dahu"), (0.02, 0.05, 0.1, 0.15, 0.2), range(1000))
LAM_KW = dict(total_work=1200.0, max_time=1024.0, collect_traces=False)
# 97 of the lambda grid's 1,000 seeds (every 10th below 960, and the last)
LAM_SUB = list(range(0, 960, 10)) + [999]
SHIFT_KW = dict(total_work=6000.0, max_time=1024.0, seed=6)
RACE_PROFS, RACE_EPS = ("gros", "dahu", "yeti"), 0.1
RACE_KW = dict(total_work=2000.0, max_time=1024.0)


# ---- phase 13: the scenario axes (phased workloads, detector, faults,
# guard, flight recorder) on the card --------------------------------------

# `benchmarks/fig8_phases.py` and `fig9_chaos.py` at their `--full` sizes
F8_PROFS, F8_EPS, F8_DWELL, F8_TIME, F8_SEEDS = ("gros", "dahu"), 0.1, \
    250.0, 750.0, 20
F8_NAMES = ("pi", "pi_rls", "offline_rl", "dutycycle")
F9_PERIOD, F9_START, F9_TIME, F9_SEEDS = 400.0, 80.0, 4000.0, 16
F9_RATES = (0.0, 0.02, 0.05, 0.10, 0.15, 0.25)
F9_NAMES = ("pi", "pi_rls", "dutycycle")
STREAM = {"alpha": 3.0, "beta": 0.6}
DGEMM = {"alpha": 0.3, "beta": 1.14, "K_L": 2.0}
# The reference's own `--full` numbers: `tools/scenario_reference.py`, the
# JAX package on the CPU. Fig. 8 per (arm, policy, profile): mean energy
# [J], its standard error over the 20 seeds, J/work, median progress over
# the setpoint, alarms per run. Fig. 9 per (arm, policy, rate): tracking
# error, its standard error over the 16 seeds, error over the clean error,
# J/work, time in fail-safe.
F8_REF = {
    ("no_detector", "pi", "gros"): (40168.13, 90.42, 2.24389, 1.08215, 0.000),
    ("no_detector", "pi", "dahu"): (45575.12, 87.32, 1.70460, 1.00702, 0.000),
    ("no_detector", "pi_rls", "gros"): (40595.36, 72.81, 2.26024, 1.08215, 0.000),
    ("no_detector", "pi_rls", "dahu"): (45084.50, 54.60, 1.68789, 1.00702, 0.000),
    ("no_detector", "offline_rl", "gros"): (55135.46, 0.00, 2.99465, 1.08215, 0.000),
    ("no_detector", "offline_rl", "dahu"): (56565.27, 0.00, 2.07730, 1.06376, 0.000),
    ("no_detector", "dutycycle", "gros"): (66634.24, 385.27, 3.38997, 1.16231, 0.000),
    ("no_detector", "dutycycle", "dahu"): (60476.45, 334.15, 2.00863, 1.14886, 0.000),
    ("detector", "pi", "gros"): (40168.13, 90.42, 2.24389, 1.08215, 3.400),
    ("detector", "pi", "dahu"): (45575.12, 87.32, 1.70460, 1.00702, 3.550),
    ("detector", "pi_rls", "gros"): (40720.63, 94.54, 2.26120, 1.08215, 3.550),
    ("detector", "pi_rls", "dahu"): (45600.05, 75.09, 1.69667, 1.00702, 3.550),
    ("detector", "offline_rl", "gros"): (55135.46, 0.00, 2.99465, 1.08215, 0.150),
    ("detector", "offline_rl", "dahu"): (56565.27, 0.00, 2.07730, 1.06376, 2.550),
    ("detector", "dutycycle", "gros"): (66634.24, 385.27, 3.38997, 1.16231, 4.050),
    ("detector", "dutycycle", "dahu"): (60476.45, 334.15, 2.00863, 1.14886, 9.000),
}
F9_REF = {
    ("unguarded", "pi", 0.0): (0.002581, 0.000450, 1.0000, 3.32114, 0.0),
    ("unguarded", "pi", 0.02): (0.002612, 0.000492, 1.0119, 3.34935, 0.0),
    ("unguarded", "pi", 0.05): (0.005562, 0.000635, 2.1551, 3.38109, 0.0),
    ("unguarded", "pi", 0.1): (0.011677, 0.000629, 4.5245, 3.43513, 0.0),
    ("unguarded", "pi", 0.15): (0.017345, 0.000681, 6.7205, 3.48659, 0.0),
    ("unguarded", "pi", 0.25): (0.028362, 0.000611, 10.9894, 3.58694, 0.0),
    ("unguarded", "pi_rls", 0.0): (0.002534, 0.000507, 1.0000, 3.32170, 0.0),
    ("unguarded", "pi_rls", 0.02): (0.003459, 0.000654, 1.3651, 3.34980, 0.0),
    ("unguarded", "pi_rls", 0.05): (0.002310, 0.000429, 0.9114, 3.38002, 0.0),
    ("unguarded", "pi_rls", 0.1): (0.075118, 0.001070, 29.6442, 3.71221, 0.0),
    ("unguarded", "pi_rls", 0.15): (0.112481, 0.001295, 44.3889, 3.91329, 0.0),
    ("unguarded", "pi_rls", 0.25): (0.113396, 0.000457, 44.7499, 4.08765, 0.0),
    ("unguarded", "dutycycle", 0.0): (0.091964, 0.000259, 1.0000, 4.00151, 0.0),
    ("unguarded", "dutycycle", 0.02): (0.092478, 0.000251, 1.0056, 4.00791, 0.0),
    ("unguarded", "dutycycle", 0.05): (0.093033, 0.000231, 1.0116, 4.01631, 0.0),
    ("unguarded", "dutycycle", 0.1): (0.094065, 0.000220, 1.0228, 4.03072, 0.0),
    ("unguarded", "dutycycle", 0.15): (0.095087, 0.000191, 1.0340, 4.04522, 0.0),
    ("unguarded", "dutycycle", 0.25): (0.097058, 0.000177, 1.0554, 4.07312, 0.0),
    ("guarded", "pi", 0.0): (0.002581, 0.000450, 1.0000, 3.32114, 0.00000),
    ("guarded", "pi", 0.02): (0.003010, 0.000591, 1.1664, 3.32362, 0.00000),
    ("guarded", "pi", 0.05): (0.003407, 0.000596, 1.3203, 3.32757, 0.00000),
    ("guarded", "pi", 0.1): (0.004198, 0.000759, 1.6266, 3.33598, 0.00000),
    ("guarded", "pi", 0.15): (0.005600, 0.001024, 2.1699, 3.34175, 0.00000),
    ("guarded", "pi", 0.25): (0.008181, 0.001421, 3.1699, 3.44330, 0.10000),
    ("guarded", "pi_rls", 0.0): (0.002534, 0.000507, 1.0000, 3.32170, 0.00000),
    ("guarded", "pi_rls", 0.02): (0.002694, 0.000514, 1.0631, 3.32282, 0.00000),
    ("guarded", "pi_rls", 0.05): (0.002763, 0.000555, 1.0903, 3.32800, 0.00000),
    ("guarded", "pi_rls", 0.1): (0.003592, 0.000719, 1.4176, 3.33495, 0.00000),
    ("guarded", "pi_rls", 0.15): (0.004729, 0.000810, 1.8662, 3.34213, 0.00000),
    ("guarded", "pi_rls", 0.25): (0.012612, 0.001586, 4.9772, 3.44924, 0.10000),
    ("guarded", "dutycycle", 0.0): (0.091964, 0.000259, 1.0000, 4.00151, 0.00000),
    ("guarded", "dutycycle", 0.02): (0.091191, 0.000246, 0.9916, 3.99540, 0.00000),
    ("guarded", "dutycycle", 0.05): (0.090407, 0.000266, 0.9831, 3.98923, 0.00000),
    ("guarded", "dutycycle", 0.1): (0.088961, 0.000447, 0.9673, 3.97807, 0.00000),
    ("guarded", "dutycycle", 0.15): (0.087461, 0.000674, 0.9510, 3.96665, 0.00000),
    ("guarded", "dutycycle", 0.25): (0.089335, 0.000698, 0.9714, 3.99426, 0.10000),
}
# The card's figures against the reference's: the two packages draw
# independent random streams, so a cell's difference has the standard
# error sqrt(se_ref^2 + se_card^2) of two seed means; a cell is held to
# SCEN_SIGMAS of them (fig. 8's energy of PI, RLS-adaptive PI and
# duty-cycle, fig. 9's tracking error of every cell). The port on the CPU
# (same streams as the card) sits within 3.3 of them
# (`tools/scenario_reference.py`), and 66 cells at 5 leave a chance
# deviation under 1e-4. Offline RL is fitted on each package's own
# harvest and follows that harvest's streams, so it is reported, not
# held. Alarms per run of PI and RLS-adaptive PI within SCEN_ALARMS of
# the reference's.
SCEN_SIGMAS = 5.0
SCEN_ALARMS = 1.0
# the step loop's launches per step by axis set are read over this many
# steps (a profile records every launch; a longer loop only costs time;
# 2 x AXIS_STEPS stays inside one noise chunk, ops.CHUNK_T)
AXIS_STEPS = 16


def chaos_schedule(flt, rate: float):
    """`benchmarks/fig9_chaos.py`'s cyclic script: a full heartbeat
    blackout and a frozen meter for a ``rate`` share of every 400 s cycle
    (rate 0: the no-op script, the clean arm)."""
    windows = []
    if rate > 0:
        d = rate * F9_PERIOD
        windows = [flt.FaultWindow("hb_dropout", F9_START, d, p1=1.0),
                   flt.FaultWindow("meter_freeze", F9_START, d)]
    return flt.FaultSchedule(windows, period=F9_PERIOD,
                             name=f"chaos-{rate:g}")


def _held(card, se_card, ref, se_ref) -> float:
    """The card's mean against the reference's, in combined standard
    errors of two independent seed means."""
    return abs(card - ref) / max(np.hypot(se_card, se_ref), 1e-12)


def loop_launches(sim, flt, dev, steps, workloads=None, detector=None,
                  faults=None, guard=None, record_events=None):
    """Device launches per step of the scan engine's step loop (packed
    PI, gros and dahu x 512 seeds, the given scenario axes): a profile of
    2 x ``steps`` steps less one of ``steps`` steps, over ``steps``, so
    neither the set-up nor the noise draw (one per `ops.CHUNK_T` steps)
    counts (None when the profiler gives no device events)."""
    from repro_torch.core.policies import PIPolicy
    profs = [sim._resolve(p) for p in ("gros", "dahu")]
    extra, build, _ = sim._scenario_axes(profs, workloads, detector, faults)
    n_events = sim._resolve_n_events(record_events)
    prof, gains, seeds, pvals, idx = sim._grid(profs, [0.1], range(512),
                                               10.0, [PIPolicy()], (0,),
                                               extra)
    scen = sim._scenario_rows(build, idx, sim._guard_vector(guard), n_events)
    args = [x.to(dev) for x in (prof, gains, seeds)]
    kw = scen.inputs(dev)
    pvals = pvals.to(dev)

    def run(n):
        sim._scan_core(n, collect=False, typed_pi=False, n_events=n_events)(
            *args, 1e9, float(max(n, 1)), 1.0, 30.0, pvals, **kw)

    base = device_breakdown(lambda: run(steps), "loop", host_ops=False,
                            quiet=True)
    loop = device_breakdown(lambda: run(2 * steps), "loop", host_ops=False,
                            quiet=True)
    if base is None or loop is None:
        return None
    return (loop["launches"] - base["launches"]) / steps


def scenarios_phase(dev, main_grid, main_kw, smi) -> None:
    """Phase 13: the scenario axes on the card (no kernel of their own;
    every run on the scan engine): Fig. 8 and Fig. 9 at the reference's
    `--full` sizes against the reference's numbers, the main grid under
    every axis at once, and bitwise neutrality at the main grid's size."""
    import torch
    from repro_torch.core import faults as flt
    from repro_torch.core import sim
    from repro_torch.core.adaptive import RLSConfig
    from repro_torch.core.plant import PROFILES
    from repro_torch.core.policies import (DutyCyclePolicy, PIPolicy,
                                           build_dataset, fit_offline_rl)
    from repro_torch.core.workloads import (DetectorConfig, Phase,
                                            PhaseSchedule)
    from repro_torch.kernels.closed_loop import kernel as K
    from repro_torch.obs import events as evt
    started = time.perf_counter()
    walls = {}
    sched = PhaseSchedule((Phase(F8_DWELL, scale=STREAM),
                           Phase(F8_DWELL, scale=DGEMM),
                           Phase(F8_DWELL, scale=STREAM)),
                          name="stream-dgemm-x3")
    guard = flt.GuardConfig(hold_k=3, failsafe_k=60)

    # ---- a. Fig. 8 at --full: every policy on the phased schedule -------
    t0 = time.perf_counter()
    har = sim.sweep(F8_PROFS, [F8_EPS], range(2), total_work=2000.0,
                    max_time=1024.0, backend="scan")
    parts = [build_dataset({k: v[i] for k, v in har.traces.items()},
                           PROFILES[p], F8_EPS)
             for i, p in enumerate(F8_PROFS)]
    data = {k: np.concatenate([d[k] for d in parts]) for k in parts[0]}
    rl = fit_offline_rl(data, n_iters=100)
    walls["fig8 harvest + fit"] = time.perf_counter() - t0
    check(np.isfinite(rl.weights).all(), f"fig8 offline RL {rl.weights}")
    print(f"[scenario] fig8: {len(data['s'])} transitions harvested from "
          f"{har.exec_time.size} PI runs (scan engine), offline RL fitted "
          f"on the card (100 iterations): w = "
          + ", ".join(f"{w:.4f}" for w in rl.weights))
    del har
    policies = [PIPolicy(), PIPolicy(adaptive=RLSConfig()), rl,
                DutyCyclePolicy()]
    worst8 = 0.0
    for arm, det in (("no_detector", None), ("detector", DetectorConfig())):
        K.LAUNCHES = 0
        t0 = time.perf_counter()
        res = sim.sweep(F8_PROFS, [F8_EPS], range(F8_SEEDS),
                        total_work=1e12, max_time=F8_TIME,
                        policies=policies, workloads=sched,
                        collect_traces=False, summary_warmup=30,
                        detector=det)
        walls[f"fig8 {arm}"] = time.perf_counter() - t0
        check(K.LAUNCHES == 0, f"fig8 {arm}: {K.LAUNCHES} kernel launches")
        check(res.exec_time.shape == (2, 1, 4, F8_SEEDS), "fig8 shape")
        check((det is None) == (res.detections is None), "fig8 detections")
        for p, prof in enumerate(F8_PROFS):
            sp = (1.0 - F8_EPS) * PROFILES[prof].progress_max
            cells = []
            for a, name in enumerate(F8_NAMES):
                e, w = res.energy[p, 0, a], res.work[p, 0, a]
                check(np.isfinite(e).all() and np.isfinite(w).all(),
                      f"fig8 {arm} {name} {prof} not finite")
                se = float(e.std(ddof=1) / np.sqrt(len(e)))
                med = sim.hist_quantile(res.summary["progress_hist"][p, 0, a],
                                        res.summary["progress_edges"][p],
                                        0.5)
                alarms = (0.0 if res.detections is None
                          else float(res.detections[p, 0, a].mean()))
                r_e, r_se, r_jpw, r_ps, r_al = F8_REF[(arm, name, prof)]
                if name != "offline_rl":
                    z = _held(float(e.mean()), se, r_e, r_se)
                    worst8 = max(worst8, z)
                    check(z <= SCEN_SIGMAS, f"fig8 {arm} {name} {prof}: "
                          f"energy {e.mean():.2f} vs the reference's "
                          f"{r_e} ({z:.2f} standard errors)")
                if det is not None and name in ("pi", "pi_rls"):
                    check(abs(alarms - r_al) <= SCEN_ALARMS,
                          f"fig8 {name} {prof}: {alarms} alarms a run vs "
                          f"the reference's {r_al}")
                cells.append(
                    f"{name} E {e.mean():.2f} J (ref {r_e}), J/work "
                    f"{e.mean() / w.mean():.5f} (ref {r_jpw}), progress/"
                    f"setpoint {np.median(med) / sp:.5f} (ref {r_ps}), "
                    f"alarms {alarms:.3f} (ref {r_al})")
            print(f"[scenario] fig8 {arm} {prof} (eps {F8_EPS}, "
                  f"{F8_SEEDS} seeds, {F8_TIME:.0f} s): " + "; ".join(cells))
        del res
    print(f"[scenario] fig8 energy of pi, pi_rls, dutycycle: worst "
          f"{worst8:.2f} combined standard errors off the reference "
          f"(bar {SCEN_SIGMAS})")

    # ---- b. Fig. 9 at --full: the chaos grid, unguarded and guarded -----
    setpoint = (1.0 - F8_EPS) * PROFILES["gros"].progress_max
    scheds = [chaos_schedule(flt, r) for r in F9_RATES]
    runs9, worst9 = {}, 0.0
    for arm, g in (("unguarded", None), ("guarded", guard)):
        t0 = time.perf_counter()
        res = sim.sweep("gros", [F8_EPS], range(F9_SEEDS), total_work=1e12,
                        max_time=F9_TIME,
                        policies=[PIPolicy(), PIPolicy(adaptive=RLSConfig()),
                                  DutyCyclePolicy()],
                        faults=scheds, guard=g, collect_traces=False,
                        summary_warmup=60)
        walls[f"fig9 {arm}"] = time.perf_counter() - t0
        check(res.exec_time.shape == (1, 3, len(F9_RATES), F9_SEEDS),
              f"fig9 shape {res.exec_time.shape}")
        runs9[arm] = res
        err = np.abs(res.work[0] / np.maximum(res.exec_time[0], 1e-9)
                     - setpoint) / setpoint
        for a, name in enumerate(F9_NAMES):
            clean = float(err[a, 0].mean())
            cells = []
            for f, r in enumerate(F9_RATES):
                e = err[a, f]
                check(np.isfinite(e).all(), f"fig9 {arm} {name} {r}")
                se = float(e.std(ddof=1) / np.sqrt(len(e)))
                r_e, r_se, r_ratio, r_jpw, r_fs = F9_REF[(arm, name, r)]
                z = _held(float(e.mean()), se, r_e, r_se)
                worst9 = max(worst9, z)
                check(z <= SCEN_SIGMAS, f"fig9 {arm} {name} rate {r}: "
                      f"error {e.mean():.6f} vs the reference's {r_e} "
                      f"({z:.2f} standard errors)")
                jpw = float((res.energy[0, a, f]
                             / np.maximum(res.work[0, a, f], 1e-9)).mean())
                cell = (f"{r:g}: err {e.mean():.6f} (ref {r_e}), x clean "
                        f"{e.mean() / max(clean, 1e-12):.3f} (ref {r_ratio}"
                        f"), J/work {jpw:.5f} (ref {r_jpw})")
                if res.guard_state is not None:
                    fs = float((res.guard_state[0, a, f, :, flt.G_N_FAILSAFE]
                                / np.maximum(res.n_steps[0, a, f], 1)).mean())
                    cell += f", fail-safe {fs:.5f} (ref {r_fs})"
                cells.append(cell)
            print(f"[scenario] fig9 {arm} {name} (gros, {F9_SEEDS} seeds, "
                  f"{F9_TIME:.0f} s) by rate: " + "; ".join(cells))
    ung, grd = runs9["unguarded"], runs9["guarded"]
    gains = []
    for f, r in enumerate(F9_RATES):
        e_u = np.abs(ung.work[0, 1, f] / ung.exec_time[0, 1, f] - setpoint)
        e_g = np.abs(grd.work[0, 1, f] / grd.exec_time[0, 1, f] - setpoint)
        if r >= 0.10:
            check(e_g.mean() < 0.5 * e_u.mean(), f"fig9 rate {r}: the guard "
                  f"does not cut pi_rls's error ({e_g.mean()} vs "
                  f"{e_u.mean()})")
            gains.append(f"{r:g}: {e_u.mean() / e_g.mean():.2f}x")
    # the rate-0 lane: a guard that counted no invalid signal changed
    # nothing, bit for bit
    clean_ok = grd.guard_state[0, :, 0, :, flt.G_N_INVALID] == 0
    same = np.ones_like(clean_ok)
    for k in ("energy", "work", "exec_time", "n_steps"):
        same &= getattr(grd, k)[0, :, 0] == getattr(ung, k)[0, :, 0]
    for k in ("progress_mean", "power_mean", "progress_hist", "pcap_hist"):
        a_, b_ = grd.summary[k][0, :, 0], ung.summary[k][0, :, 0]
        same &= (a_ == b_).reshape(a_.shape[:2] + (-1,)).all(-1)
    check(bool(same[clean_ok].all()) and clean_ok.sum() > 0,
          f"fig9: guarded rate-0 runs with no invalid signal differ from "
          f"the unguarded ones ({int(same[clean_ok].sum())} of "
          f"{int(clean_ok.sum())} equal)")
    print(f"[scenario] fig9: the guard cuts pi_rls's tracking error at "
          f"rates >= 0.10 by " + ", ".join(gains) + " (unguarded over "
          f"guarded); rate-0 lane: {int(clean_ok.sum())} of {clean_ok.size} "
          f"guarded runs counted no invalid signal, all bit-equal to the "
          f"unguarded runs; worst cell {worst9:.2f} combined standard "
          f"errors off the reference (bar {SCEN_SIGMAS})")
    del runs9, ung, grd

    # ---- c. the main grid under every axis at once ----------------------
    chaos = chaos_schedule(flt, 0.10)
    kw = dict(main_kw, workloads=sched, detector=DetectorConfig(),
              faults=chaos, guard=guard, record_events=True,
              policies=PIPolicy())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = 0
    t0 = time.perf_counter()
    res = sim.sweep(*main_grid, **kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_runs = int(res.energy.size)
    check(K.LAUNCHES == 0, f"all axes: {K.LAUNCHES} kernel launches")
    check(res.energy.shape == (len(main_grid[0]), len(main_grid[1]),
                               len(main_grid[2])), "all-axes grid shape")
    for k, v in (("energy", res.energy), ("work", res.work),
                 ("exec_time", res.exec_time),
                 ("progress_mean", res.summary["progress_mean"]),
                 ("power_mean", res.summary["power_mean"]),
                 ("guard_state", res.guard_state), ("events", res.events)):
        check(np.isfinite(v).all(), f"all axes: {k} not finite")
    check(res.events.shape == res.energy.shape + (evt.ring_dim(64),),
          "ring shape")
    ring_mb = res.events.nbytes / 1e6
    t1 = time.perf_counter()
    sub = sim.sweep(main_grid[0], main_grid[1], SUB_SEEDS, **kw)
    sub_wall = time.perf_counter() - t1
    for k in ("energy", "work", "exec_time", "n_steps", "detections",
              "guard_state", "events"):
        check(np.array_equal(getattr(sub, k),
                             getattr(res, k)[:, :, SUB_SEEDS]),
              f"all axes: sub-grid {k} != the full grid's rows")
    for k in ("progress_mean", "progress_std", "power_mean",
              "progress_hist", "pcap_hist"):
        check(np.array_equal(sub.summary[k], res.summary[k][:, :, SUB_SEEDS]),
              f"all axes: sub-grid summary {k} != the full grid's rows")
    # decoded rings against the guard's counters and the scripts
    P, E, S = res.energy.shape
    whole, picked = 0, [(p, e, s) for p in range(P)
                        for e in sorted({min(1, E - 1), E // 2, E - 1})
                        for s in sorted({0, S // 2, S - 1})]
    for idx in picked:
        ring = res.events[idx]
        ev = evt.decode_ring(ring)
        check(ev == sorted(ev, key=lambda x: x.t), f"ring {idx} unordered")
        if evt.ring_total(ring) > evt.ring_capacity(ring):
            continue
        whole += 1
        by = lambda c: evt.filter_events(ev, code=c)
        check(len(by(evt.EV_RECOVERY_RESET))
              == int(res.guard_state[idx][flt.G_N_RESETS]),
              f"ring {idx}: resets vs the guard's counter")
        check(len(by(evt.EV_DETECTOR_ALARM)) == int(res.detections[idx]),
              f"ring {idx}: alarms vs the detector's counter")
        check([(e.t, e.payload[:2]) for e in by(evt.EV_PHASE_FLIP)]
              == [(float(b), (float(i), i + 1.0)) for i, b in
                  enumerate(sched.boundaries()) if b < kw["max_time"]],
              f"ring {idx}: phase flips {by(evt.EV_PHASE_FLIP)}")
        for e in by(evt.EV_FAULT_ENTER):
            check(bool(chaos.active(e.t)), f"ring {idx}: enter at {e.t}")
        for e in by(evt.EV_FAULT_EXIT):
            check(not chaos.active(e.t), f"ring {idx}: exit at {e.t}")
    check(whole > 0, "no picked ring held its whole timeline")
    print(f"[scenario] main grid under every axis ({n_runs} runs x 2048 "
          f"steps, summary, packed PI; fig8's schedule, DetectorConfig(), "
          f"chaos_schedule(0.10), GuardConfig(hold_k=3, failsafe_k=60), "
          f"64-slot rings): {wall:.3f} s wall ({n_runs / wall:.0f} runs/s), "
          f"peak device memory {peak:.3f} GiB (rings {ring_mb:.1f} MB); all "
          f"finite, every Poisson draw resolved; mean alarms a run "
          f"{res.detections.mean():.3f}, fail-safe periods a run "
          f"{res.guard_state[..., flt.G_N_FAILSAFE].mean():.3f}, events a "
          f"run {res.events[..., evt.H_TOTAL].mean():.2f}; sub-grid of "
          f"{len(SUB_SEEDS)} seeds ({sub.energy.size} runs) bit-equal to "
          f"its rows ({sub_wall:.3f} s); {whole} of {len(picked)} decoded "
          f"rings held their whole timeline and agree with the guard's and "
          f"the detector's counters and the scripts' windows")
    del res, sub
    t0 = time.perf_counter()
    prof = device_breakdown(
        lambda: sim.sweep(*main_grid, **dict(kw, max_time=float(
            PROFILE_STEPS))),
        f"all axes, {n_runs} runs x {PROFILE_STEPS} steps", host_ops=False)
    if prof is not None:
        print(f"[scenario] all axes: {prof['launches'] / PROFILE_STEPS:.1f} "
              f"device launches per step ({prof['launches']} in "
              f"{PROFILE_STEPS} steps, set-up included), device idle "
              f"{100 - 100 * prof['busy_us'] / prof['wall_us']:.1f}% of the "
              f"profiled wall ({time.perf_counter() - t0:.1f} s with the "
              f"profiler's own work)")
    walls["all axes"], walls["its sub-grid"] = wall, sub_wall
    # launches per step by axis set: the step loop of a 1,024-run batch,
    # packed PI
    t0 = time.perf_counter()
    axis_sets = {"none": {}, "schedule": dict(workloads=sched),
                 "detector": dict(detector=DetectorConfig()),
                 "faults": dict(faults=chaos), "guard": dict(guard=guard),
                 "recorder": dict(record_events=True),
                 "all": dict(workloads=sched, detector=DetectorConfig(),
                             faults=chaos, guard=guard, record_events=True)}
    per_set = {}
    for label, axes in axis_sets.items():
        n = loop_launches(sim, flt, dev, AXIS_STEPS, **axes)
        if n is not None:
            per_set[label] = n
    if per_set:
        print(f"[scenario] device launches per step of the step loop by "
              f"axis set (packed PI, 1,024 runs; {2 * AXIS_STEPS} steps less "
              f"{AXIS_STEPS}): "
              + ", ".join(f"{k} {v:.1f}" for k, v in per_set.items())
              + f" ({time.perf_counter() - t0:.1f} s)")

    # ---- d. bitwise neutrality at the main grid's size ------------------
    kw512 = dict(main_kw, max_time=512.0, backend="scan",
                 policies=PIPolicy())
    t0 = time.perf_counter()
    plain = sim.sweep(*main_grid, **kw512)
    armed = sim.sweep(*main_grid, **kw512, faults=flt.FaultSchedule(()),
                      guard=flt.GuardConfig(), record_events=True)
    walls["neutrality (2 sweeps)"] = time.perf_counter() - t0
    ok = armed.guard_state[..., flt.G_N_INVALID] == 0
    same = np.ones_like(ok)
    for k in ("energy", "work", "exec_time", "n_steps"):
        same &= getattr(plain, k) == getattr(armed, k)
    for k in ("progress_mean", "progress_std", "power_mean",
              "progress_hist", "pcap_hist"):
        a_, b_ = plain.summary[k], armed.summary[k]
        same &= (a_ == b_).reshape(a_.shape[:3] + (-1,)).all(-1)
    quiet = armed.events[..., evt.H_TOTAL] == 0
    check(bool(same[ok].all()) and bool(quiet[ok].all()),
          f"neutrality: {int((~same & ok).sum())} runs with no invalid "
          f"signal differ, {int((~quiet & ok).sum())} recorded events")
    print(f"[scenario] neutrality (phase 3's grid cut to 512 steps, scan "
          f"engine, packed PI): with FaultSchedule([]), GuardConfig() and "
          f"64-slot rings, {int(ok.sum())} of {ok.size} runs counted no "
          f"invalid signal, and every one of them equals the plain sweep's "
          f"run bit for bit with an empty ring ({int(same.sum())} equal in "
          f"all)")
    del plain, armed
    print(f"[scenario] walls: " + ", ".join(f"{k} {v:.3f} s"
                                             for k, v in walls.items())
          + f"; phase 13 in {time.perf_counter() - started:.1f} s; on {smi}")


def paper_workflow(dev, main_grid, main_kw, kernel_means, smi) -> None:
    """Phase 11: the paper's identification and evaluation path on the
    card, through the port's entry points: Fig. 3's staircase, Fig. 4's
    static campaign and fit, Fig. 5's replay and dynamic fit, the scan
    engine on the main grid against phase 3's kernel route, and Fig. 7 at
    full size on both engines."""
    import torch
    from repro_torch.core import identify, sim
    from repro_torch.core.energy import RunSummary, tradeoff_table
    from repro_torch.core.plant import PROFILES, pcap_linearize, simulate
    from repro_torch.kernels.closed_loop import kernel as K
    from repro_torch.kernels.closed_loop import ops
    started = time.perf_counter()
    walls = {}

    # ---- Fig. 3: the staircase, open loop --------------------------------
    t0 = time.perf_counter()
    hold, levels = 20, np.arange(40.0, 121.0, 20.0)
    stairs = torch.tensor(np.repeat(levels, hold), dtype=torch.float32,
                          device=dev)
    noise = ops.draw_noise([3], len(stairs), device=dev)[:, :4, 0]
    for name in ("gros", "dahu", "yeti"):
        tr = simulate(PROFILES[name], stairs, 1.0, noise)
        prog = tr["progress"].cpu().numpy()
        power = tr["power"].cpu().numpy()
        seg = lambda i: float(np.median(prog[i * hold + 5:(i + 1) * hold]))
        sat = ((seg(len(levels) - 1) - seg(len(levels) - 2))
               / max(seg(1) - seg(0), 1e-9))
        if name in ("gros", "dahu"):  # yeti: drops dominate (paper §5.2)
            check(sat < 0.5, f"fig3 {name}: saturation ratio {sat}")
        print(f"[paper] fig3 {name}: saturation ratio {sat:.4f}, actuator "
              f"error at 120 W {120.0 - power[-hold:].mean():.3f} W, noise "
              f"sd {float(np.std(prog[-hold:])):.3f} Hz, min progress "
              f"{prog.min():.3f} Hz")
    walls["fig3"] = time.perf_counter() - t0

    # ---- Fig. 4: static campaign through open_loop_runs, NLS fit ---------
    t0 = time.perf_counter()
    for name, reps, tol in (("gros", 3, 0.05), ("dahu", 3, 0.08),
                            ("yeti", 4, None)):
        p = PROFILES[name]
        caps, powers, progs = identify.static_campaign(p, reps=reps,
                                                       device=dev)
        fit = identify.fit_static(caps, powers, progs, device=dev)
        r = identify.pearson(progs, -1.0 / (progs + 1e-9), device=dev)
        if tol is None:   # tests/test_identify.py's noisy-multisocket bar
            check(abs(fit.K_L - p.K_L) <= 0.25 * p.K_L
                  and 0.7 < fit.r2 <= 1.0, f"fig4 {name}: {fit}")
        else:             # tests/test_identify.py's Table 2 bars
            check(abs(fit.a - p.a) <= tol * p.a
                  and abs(fit.b - p.b) <= 2.0
                  and abs(fit.K_L - p.K_L) <= tol * p.K_L
                  and abs(fit.alpha - p.alpha) <= 0.25 * p.alpha
                  and abs(fit.beta - p.beta) <= 3.0 and fit.r2 > 0.95,
                  f"fig4 {name}: {fit} against Table 2")
        print(f"[paper] fig4 {name} ({9 * reps} runs x 40 steps): a "
              f"{fit.a:.4f} ({p.a}), b {fit.b:.3f} ({p.b}), K_L "
              f"{fit.K_L:.3f} ({p.K_L}), alpha {fit.alpha:.5f} ({p.alpha}),"
              f" beta {fit.beta:.3f} ({p.beta}), R2 {fit.r2:.5f}; pearson "
              f"(progress, -time) {r:.4f}")
    walls["fig4"] = time.perf_counter() - t0

    # ---- Fig. 5: Eq. 3 replay and the dynamic fit -------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    sched = torch.tensor(np.repeat(rng.uniform(40, 120, 120), 4),
                         dtype=torch.float32, device=dev)
    noise = ops.draw_noise([2], len(sched), device=dev)[:, :4, 0]
    for name in ("gros", "dahu", "yeti"):
        p = PROFILES[name]
        tr = simulate(p, sched, 1.0, noise)
        pred = sim.replay_model(p, sched, 1.0, device=dev)
        pl = pcap_linearize(p, sched)
        tau, kl = identify.fit_dynamics(pl, tr["progress_clean"] - p.K_L,
                                        1.0)
        tau_r, kl_r = identify.fit_dynamics(pl, pred - p.K_L, 1.0)
        gap = float((pred - tr["progress_clean"]).abs().max())
        err = (tr["progress"] - pred).cpu().numpy()
        check(abs(tau - p.tau) <= 0.05 * p.tau
              and abs(kl - p.K_L) <= 0.05 * p.K_L,
              f"fig5 {name}: tau {tau}, K_L {kl}")
        check(gap <= 1e-3 * p.K_L, f"fig5 {name}: replay {gap} Hz off the "
              f"clean plant")
        print(f"[paper] fig5 {name}: tau {tau:.5f} s ({p.tau:.5f}), dynamic "
              f"K_L {kl:.4f} ({p.K_L}); on the replay tau {tau_r:.5f}, K_L "
              f"{kl_r:.4f}; replay vs clean plant max {gap:.3e} Hz; "
              f"measured - replay mean {err.mean():.3f} Hz, sd "
              f"{err.std():.3f} Hz")
    walls["fig5"] = time.perf_counter() - t0

    # ---- the scan engine on the main grid ---------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = 0
    t0 = time.perf_counter()
    res = sim.sweep(*main_grid, **main_kw, backend="scan")
    scan_wall = time.perf_counter() - t0
    scan_peak = torch.cuda.max_memory_allocated() / 2**30
    check(K.LAUNCHES == 0, f"the scan sweep launched the closed-loop "
          f"kernel {K.LAUNCHES} times")
    n_runs = int(np.prod(res.energy.shape))
    check(res.energy.shape == (3, 11, 3072), "scan grid shape")
    check((res.n_steps == 2048).all(), "every scan run lives 2048 steps")
    check(np.all(res.summary["progress_hist"].sum(-1) == 2048 - 30),
          "scan histogram mass is the post-warm-up step count")
    worst = {}
    for k in ("progress_mean", "power_mean", "energy"):
        mine = (res.energy if k == "energy" else res.summary[k]).mean(-1)
        check(np.isfinite(mine).all(), f"scan {k} not finite")
        rel = np.abs(mine / kernel_means[k] - 1.0)
        worst[k] = float(rel.max())
        check(worst[k] <= ENGINE_RTOL, f"scan {k} off the kernel route by "
              f"{worst[k]:.4f} > {ENGINE_RTOL}")
    print(f"[paper] scan sweep {res.energy.shape} = {n_runs} runs x 2048 "
          f"steps (summary, warm-up 30) in {scan_wall:.3f} s wall "
          f"({n_runs / scan_wall:.0f} runs/s); closed-loop kernel launches "
          f"{K.LAUNCHES}; peak device memory {scan_peak:.3f} GiB; every "
          f"Poisson draw resolved; seed means against phase 3's kernel "
          f"route, worst relative gap: "
          + ", ".join(f"{k} {v:.4f}" for k, v in worst.items())
          + f" (bar {ENGINE_RTOL})")
    t0 = time.perf_counter()
    sub = sim.sweep(main_grid[0], main_grid[1], SUB_SEEDS, **main_kw,
                    backend="scan")
    sub_wall = time.perf_counter() - t0
    rows = (Ellipsis, SUB_SEEDS)
    for k in ("energy", "work", "exec_time", "n_steps"):
        check(np.array_equal(getattr(sub, k), getattr(res, k)[rows]),
              f"scan sub-grid {k} != the full grid's rows")
    for k in ("progress_mean", "progress_std", "power_mean",
              "progress_hist", "pcap_hist"):
        full = res.summary[k]
        check(np.array_equal(sub.summary[k],
                             full[:, :, SUB_SEEDS] if full.ndim == 4
                             else full[rows]),
              f"scan sub-grid summary {k} != the full grid's rows")
    print(f"[paper] scan sub-grid of {len(SUB_SEEDS)} seeds x 33 (profile,"
          f" eps) = {len(SUB_SEEDS) * 33} runs: bit-equal to the full "
          f"grid's rows ({sub_wall:.3f} s wall)")
    del res, sub
    t0 = time.perf_counter()
    short = dict(main_kw, max_time=float(PROFILE_STEPS))
    prof = device_breakdown(
        lambda: sim.sweep(*main_grid, **short, backend="scan"),
        f"scan sweep, {n_runs} runs x {PROFILE_STEPS} steps",
        host_ops=False)
    if prof is not None:
        print(f"[paper] scan engine: {prof['launches'] / PROFILE_STEPS:.1f} "
              f"device launches per step ({prof['launches']} in "
              f"{PROFILE_STEPS} steps, set-up included), device idle "
              f"{100 - 100 * prof['busy_us'] / prof['wall_us']:.1f}% of the "
              f"profiled wall ({time.perf_counter() - t0:.1f} s with the "
              f"profiler's own work)")

    # ---- Fig. 7 at full size, on both engines -----------------------------
    t0 = time.perf_counter()
    names = ("gros", "dahu")
    base = {}
    for name in names:
        p = PROFILES[name]
        trs = sim.open_loop_runs(p, 2000, range(FIG7_REPS), device=dev)
        work = np.cumsum(trs["progress"].cpu().numpy(), axis=1)
        t_max = float(np.mean([np.searchsorted(w, FIG7_WORK)
                               for w in work]))
        base[name] = (t_max, float(p.power_of_pcap(p.pcap_max)) * t_max)
    walls["fig7 baseline"] = time.perf_counter() - t0
    for backend in ("kernel", "scan"):
        t0 = time.perf_counter()
        K.LAUNCHES = 0
        r = sim.sweep(names, FIG7_EPS, range(FIG7_REPS),
                      total_work=FIG7_WORK, max_time=FIG7_TIME,
                      collect_traces=False, backend=backend)
        walls[f"fig7 {backend}"] = time.perf_counter() - t0
        check(K.LAUNCHES == (1 if backend == "kernel" else 0),
              f"fig7 {backend}: {K.LAUNCHES} closed-loop kernel launches")
        check(bool(r.completed.all()), f"fig7 {backend}: runs incomplete")
        for pi, name in enumerate(names):
            runs = [RunSummary(
                epsilon=eps, exec_time=float(r.exec_time[pi, ei, si]),
                energy=float(r.energy[pi, ei, si]),
                mean_progress=float(r.summary["progress_mean"][pi, ei, si]),
                mean_power=float(r.summary["power_mean"][pi, ei, si]),
                joules_per_work=float(r.energy[pi, ei, si]
                                      / r.work[pi, ei, si]))
                for ei, eps in enumerate(FIG7_EPS)
                for si in range(FIG7_REPS)]
            table = tradeoff_table(runs)
            keys = sorted(table)
            check(table[keys[-1]]["energy_saving"]
                  >= table[keys[1]]["energy_saving"] - 0.05,
                  f"fig7 {backend} {name}: trade-off direction")
            t_max, e_max = base[name]
            t10 = table[0.1]
            print(f"[paper] fig7 {backend} {name} ({len(FIG7_EPS)} eps x "
                  f"{FIG7_REPS} reps, work {FIG7_WORK:.0f}): eps 0.1 vs max "
                  f"power: energy saving {1 - t10['energy_j'] / e_max:.4f},"
                  f" time increase {t10['time_s'] / t_max - 1:.4f}; vs eps 0"
                  f" control: energy saving {t10['energy_saving']:.4f}, time "
                  f"increase {t10['time_increase']:.4f}")
    print(f"[paper] walls: " + ", ".join(f"{k} {v:.3f} s"
                                          for k, v in walls.items())
          + f", scan sweep {scan_wall:.3f} s, its sub-grid {sub_wall:.3f} "
          f"s; phase 11 in {time.perf_counter() - started:.1f} s; on {smi}")


def policies_phase(dev, main_grid, main_kw, main_out, main_summary,
                   smi) -> None:
    """Phase 12: policies and adaptation on the card (no kernel of their
    own; the pure-PI grid keeps the closed-loop kernel): the policy front
    end on the main grid, the gain shift, the RLS lambda grid and the
    policy face-off, through the port's entry points."""
    import dataclasses

    import torch
    from repro_torch.core import sim
    from repro_torch.core.adaptive import RLSConfig
    from repro_torch.core.controller import PIGains
    from repro_torch.core.plant import PROFILES
    from repro_torch.core.policies import (DutyCyclePolicy, PIPolicy,
                                           build_dataset, fit_offline_rl)
    from repro_torch.kernels.closed_loop import kernel as K
    started = time.perf_counter()
    walls = {}

    # ---- a. the kernel through the policy front end ----------------------
    K.ROUTE_LAUNCHES.update(seeds=0, noise=0)
    t0 = time.perf_counter()
    res = sim.sweep(*main_grid, **main_kw, policies=PIPolicy())
    walls["main grid, policies=PIPolicy()"] = time.perf_counter() - t0
    check(dict(K.ROUTE_LAUNCHES) == {"seeds": 1, "noise": 0},
          f"policies=PIPolicy() launches by route {K.ROUTE_LAUNCHES}")
    got = {"energy": res.energy, "work": res.work, "t": res.exec_time,
           "steps": res.n_steps}
    for k, v in main_out.items():
        check(np.array_equal(got[k], v), f"policies=PIPolicy() {k} != "
              f"phase 3's")
    for k, v in main_summary.items():
        check(np.array_equal(res.summary[k], v), f"policies=PIPolicy() "
              f"summary {k} != phase 3's")
    print(f"[policy] main grid through sweep(policies=PIPolicy()): "
          f"{res.energy.size} runs, kernel launches by route "
          f"{dict(K.ROUTE_LAUNCHES)}, every run equal to phase 3's")
    del res

    # ---- b. the gain shift (beyond_adaptive.py) --------------------------
    t0 = time.perf_counter()
    design = PROFILES["gros"]
    shifted = dataclasses.replace(design, K_L=design.K_L * 2)
    gains = PIGains.from_model(design, 0.1)
    fixed = sim.simulate_closed_loop(shifted, gains=gains,
                                     policy=PIPolicy(), **SHIFT_KW)
    adapt = sim.simulate_closed_loop(shifted, gains=gains,
                                     adaptive=RLSConfig(), design=design,
                                     **SHIFT_KW)
    walls["gain shift"] = time.perf_counter() - t0
    check(fixed.completed and adapt.completed, "gain shift: incomplete")
    check(adapt.exec_time <= 1.05 * fixed.exec_time,
          f"gain shift: adaptive {adapt.exec_time} s > 1.05 x fixed "
          f"{fixed.exec_time} s")
    print(f"[policy] gain shift (gros gains, K_L x 2, work "
          f"{SHIFT_KW['total_work']:.0f}, seed 6, scan engine): fixed gains {fixed.exec_time:.0f} s, RLS-adaptive "
          f"{adapt.exec_time:.0f} s ({adapt.exec_time / fixed.exec_time:.4f}"
          f" x, bar 1.05); final kl_hat {float(adapt.rls_state.kl_hat):.4f}"
          f" Hz (plant {shifted.K_L}, design {design.K_L}), tau_hat "
          f"{float(adapt.rls_state.tau_hat):.4f} s")

    # ---- c. the RLS lambda grid at --full size ---------------------------
    cfgs = [RLSConfig(lam=lam) for lam in LAMS]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sim.sweep(*LAM_GRID, adaptive=cfgs, **LAM_KW)
    lam_wall = time.perf_counter() - t0
    lam_peak = torch.cuda.max_memory_allocated() / 2**30
    n_runs = int(res.exec_time.size)
    check(res.exec_time.shape == (2, 5, len(LAMS), len(LAM_GRID[2])),
          "lambda grid "
          f"shape {res.exec_time.shape}")
    for k, v in (("exec_time", res.exec_time), ("energy", res.energy),
                 ("progress_mean", res.summary["progress_mean"]),
                 ("power_mean", res.summary["power_mean"])):
        check(np.isfinite(v).all(), f"lambda grid {k} not finite")
    per_lam = res.exec_time.mean(axis=(0, 1, 3))
    best = int(per_lam.argmin())
    print(f"[policy] RLS lambda grid {res.exec_time.shape} = {n_runs} runs"
          f" (work {LAM_KW['total_work']:.0f}, horizon "
          f"{LAM_KW['max_time']:.0f} s, summary) in {lam_wall:.3f} s wall "
          f"({n_runs / lam_wall:.0f} runs/s), peak device memory "
          f"{lam_peak:.3f} GiB; completed {res.completed.mean():.4f}; mean "
          f"time by lambda: " + ", ".join(
              f"{lam} {t:.2f} s" for lam, t in zip(LAMS, per_lam))
          + f"; best lambda {LAMS[best]} ({per_lam[best]:.2f} s)")
    t0 = time.perf_counter()
    sub = sim.sweep(LAM_GRID[0], LAM_GRID[1], LAM_SUB, adaptive=cfgs,
                    **LAM_KW)
    sub_wall = time.perf_counter() - t0
    for k in ("energy", "work", "exec_time", "n_steps"):
        check(np.array_equal(getattr(sub, k), getattr(res, k)[..., LAM_SUB]),
              f"lambda sub-grid {k} != the full grid's rows")
    for k in ("progress_mean", "progress_std", "power_mean",
              "progress_hist", "pcap_hist"):
        full = res.summary[k]
        check(np.array_equal(sub.summary[k],
                             full[:, :, :, LAM_SUB] if full.ndim == 5
                             else full[..., LAM_SUB]),
              f"lambda sub-grid summary {k} != the full grid's rows")
    print(f"[policy] lambda sub-grid of {len(LAM_SUB)} seeds x 100 = "
          f"{sub.exec_time.size} runs: bit-equal to the full grid's rows "
          f"({sub_wall:.3f} s wall)")
    del res, sub
    t0 = time.perf_counter()
    steps = PROFILE_STEPS
    prof = device_breakdown(
        lambda: sim.sweep(*LAM_GRID, adaptive=cfgs,
                          **dict(LAM_KW, max_time=float(steps))),
        f"lambda grid, {n_runs} runs x {steps} steps", host_ops=False)
    if prof is not None:
        print(f"[policy] lambda grid (pi_rls): {prof['launches'] / steps:.1f}"
              f" device launches per step ({prof['launches']} in {steps} "
              f"steps, set-up included), device idle "
              f"{100 - 100 * prof['busy_us'] / prof['wall_us']:.1f}% of the "
              f"profiled wall ({time.perf_counter() - t0:.1f} s with the "
              f"profiler's own work)")

    # ---- d. the policy face-off (policy_faceoff.py, --full) --------------
    t0 = time.perf_counter()
    har = sim.sweep(RACE_PROFS, [RACE_EPS], range(8), **RACE_KW,
                    backend="scan")
    parts = [build_dataset({k: v[i] for k, v in har.traces.items()},
                           PROFILES[p], RACE_EPS)
             for i, p in enumerate(RACE_PROFS)]
    dataset = {k: np.concatenate([d[k] for d in parts]) for k in parts[0]}
    t1 = time.perf_counter()
    rl = fit_offline_rl(dataset, n_iters=100)
    walls["harvest"], walls["fit_offline_rl"] = t1 - t0, (
        time.perf_counter() - t1)
    check(np.isfinite(rl.weights).all(), f"offline RL weights {rl.weights}")
    print(f"[policy] harvested {len(dataset['s'])} transitions from "
          f"{har.exec_time.size} PI runs; fitted Q on the card (100 "
          f"iterations) in {walls['fit_offline_rl']:.3f} s: w = "
          + ", ".join(f"{w:.4f}" for w in rl.weights))
    del har
    policies = [PIPolicy(), rl, DutyCyclePolicy()]
    names = ("pi", "offline_rl", "dutycycle")
    t0 = time.perf_counter()
    res = sim.sweep(RACE_PROFS, [RACE_EPS], range(30), **RACE_KW,
                    policies=policies, collect_traces=False,
                    summary_warmup=30)
    walls["race"] = time.perf_counter() - t0
    check(res.exec_time.shape == (3, 1, 3, 30), "race shape")
    for a in (0, 2):
        check(bool(res.completed[:, :, a].all()), f"race: {names[a]} runs "
              f"incomplete")
    for pi_, pname in enumerate(RACE_PROFS):
        setpoint = (1.0 - RACE_EPS) * PROFILES[pname].progress_max
        cells = []
        for a, name in enumerate(names):
            med = sim.hist_quantile(res.summary["progress_hist"][pi_, 0, a],
                                    res.summary["progress_edges"][pi_], 0.5)
            cells.append(
                f"{name} t {res.exec_time[pi_, 0, a].mean():.1f} s, E "
                f"{res.energy[pi_, 0, a].mean():.0f} J, median progress / "
                f"setpoint {np.median(med) / setpoint:.4f}, completed "
                f"{res.completed[pi_, 0, a].mean():.2f}")
        print(f"[policy] race {pname} (eps {RACE_EPS}, 30 seeds): "
              + "; ".join(cells))
    del res
    # the PI lane of a mixed trace sweep against a pure packed-PI sweep,
    # and duty-cycle's caps at eps 0.3
    t0 = time.perf_counter()
    kw = dict(RACE_KW, collect_traces=True)
    mixed = sim.sweep(RACE_PROFS, [RACE_EPS, 0.3], range(8), **kw,
                      policies=[PIPolicy(), DutyCyclePolicy()])
    pure = sim.sweep(RACE_PROFS, [RACE_EPS, 0.3], range(8), **kw,
                     policies=PIPolicy(), backend="scan")
    walls["lane check"] = time.perf_counter() - t0
    for k in pure.traces:
        check(np.array_equal(mixed.traces[k][:, :, 0], pure.traces[k]),
              f"mixed sweep's PI lane {k} != the pure packed-PI sweep")
    gros = PROFILES["gros"]
    dc = {k: v[0, 1, 1] for k, v in mixed.traces.items()}
    tails = []
    for s_ in range(8):
        n = int(mixed.n_steps[0, 1, 1, s_])
        check(bool(mixed.completed[0, 1, 1, s_]), "duty-cycle incomplete")
        tails.append(float(dc["pcap"][s_, n // 2:n].mean()))
    check(max(tails) < 0.9 * gros.pcap_max, f"duty-cycle at eps 0.3 keeps "
          f"mean caps {tails} >= 0.9 x {gros.pcap_max}")
    lanes = mixed.traces["pcap"].shape[:-1]
    print(f"[policy] PI lane of [PIPolicy(), DutyCyclePolicy()] ({lanes}, "
          f"traces) bit-equal to a pure "
          f"packed-PI sweep; duty-cycle on gros at eps 0.3: mean cap over "
          f"the second half {min(tails):.2f}-{max(tails):.2f} W (bar "
          f"{0.9 * gros.pcap_max:.1f})")
    del mixed, pure
    t0 = time.perf_counter()
    prof = device_breakdown(
        lambda: sim.sweep(RACE_PROFS, [RACE_EPS], range(30),
                          **dict(RACE_KW, max_time=float(PROFILE_STEPS)),
                          policies=policies, collect_traces=False,
                          summary_warmup=30),
        f"race, 270 runs x {PROFILE_STEPS} steps", host_ops=False)
    if prof is not None:
        print(f"[policy] race (pi + offline_rl + dutycycle): "
              f"{prof['launches'] / PROFILE_STEPS:.1f} device launches per"
              f" step, device idle "
              f"{100 - 100 * prof['busy_us'] / prof['wall_us']:.1f}% of the "
              f"profiled wall ({time.perf_counter() - t0:.1f} s)")
    print(f"[policy] walls: " + ", ".join(f"{k} {v:.3f} s"
                                           for k, v in walls.items())
          + f", lambda grid {lam_wall:.3f} s, its sub-grid {sub_wall:.3f} "
          f"s; phase 12 in {time.perf_counter() - started:.1f} s; on {smi}")


# ---- phase 14: the execution layer and the NRM runtime on the card --------

# (a) the main grid in chunks: ceil(101,376 / 16,384) = 7 seeds-route
# launches; (d) the same chunks under the campaign supervisor
RT_CHUNK = 16384
RT_LAUNCHES = 7
# (b) a 1,013,760-run summary grid: gros, dahu, yeti x 11 eps x 30,720
# seeds in 131,072-run chunks (8 launches); a 97-seed sub-grid (every
# 320th seed and the last) against its own one-shot sweep; peak device
# memory (above what was allocated before the call) held to at most
# BIG_PEAK_X times that of a one-shot grid of about one chunk (3 x 11 x
# 3,972 = 131,076 runs): each chunk's tensors are freed before the next
# chunk's are made, so the grid's size does not enter the bound
BIG_SEEDS, BIG_CHUNK = 30720, 131072
BIG_SUB = list(range(0, BIG_SEEDS, 320)) + [BIG_SEEDS - 1]
BIG_PEAK_X = 1.3
CHUNK_SEEDS = 3972
# (c) the scan engine chunked: 4,096 runs at the paper's horizon (2,048
# steps) in 2 chunks
SCAN_RT = (("gros", "dahu"), (0.1, 0.2), range(1024))
SCAN_CHUNK = 2048
# (d) the spawned campaign kills itself after this many commits
KILL_AFTER = 3
# (e) run_simulated at eps 0.0 and 0.1 over 8 seeds, the reference
# tests' headline bars (tests/test_system.py); max_time 256 s is the
# engine's smallest bucket (256 steps), room for 1,500 units of work at
# ~22 Hz
NRM_SEEDS, NRM_MT, NRM_WORK = range(8), 256.0, 1500.0
CTRL_PERIODS = 500


def _same_runs(res, main_out, main_summary, what):
    """Every output of a main-grid sweep equals phase 3's one-shot
    sweep's, bit for bit."""
    got = {"energy": res.energy, "work": res.work, "t": res.exec_time,
           "steps": res.n_steps}
    for k, v in main_out.items():
        check(np.array_equal(got[k], v), f"{what}: {k} != phase 3's")
    for k, v in main_summary.items():
        check(np.array_equal(res.summary[k], v),
              f"{what}: summary {k} != phase 3's")


def runtime_phase(dev, main_grid, main_kw, main_out, main_summary, serve7,
                  smi) -> dict:
    """Phase 14: the execution layer (chunked, sharded, durable sweeps,
    resume) and the NRM runtime (`NRM.run_simulated`, `control_step`,
    `serve --power`) on the card. They bring no kernel of their own: the
    chunked and durable sweeps launch the closed-loop kernel once per
    chunk, `serve --power` the attention kernels. Returns the `serve
    --power` result."""
    import shutil

    import torch
    from repro_torch.configs.base import PowerControlConfig
    from repro_torch.core import sim, supervisor
    from repro_torch.core.energy import summarize_run, tradeoff_table
    from repro_torch.core.nrm import NRM
    from repro_torch.kernels.closed_loop import kernel as K
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch import serve
    from repro_torch.obs.retry import RetryPolicy
    started = time.perf_counter()
    n_main = int(np.prod(main_out["energy"].shape))

    def timed_sweep(*grid, **kw):
        """(result, wall s, peak device memory above what was allocated
        before the call in GiB, launches by route)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        K.ROUTE_LAUNCHES.update(seeds=0, noise=0)
        t0 = time.perf_counter()
        res = sim.sweep(*grid, **kw)
        wall = time.perf_counter() - t0
        return (res, wall, (torch.cuda.max_memory_allocated() - base)
                / 2**30, dict(K.ROUTE_LAUNCHES))

    # ---- a. the main grid in chunks on the kernel route -----------------
    res, wall_a, peak, routes = timed_sweep(*main_grid, chunk_size=RT_CHUNK,
                                            **main_kw)
    check(routes == {"seeds": RT_LAUNCHES, "noise": 0},
          f"chunked main grid launches {routes}: {RT_LAUNCHES} expected")
    _same_runs(res, main_out, main_summary, "chunked main grid")
    print(f"[runtime] a. main grid ({n_main} runs x 2048, summary) in "
          f"chunks of {RT_CHUNK}: {wall_a:.3f} s wall ({n_main / wall_a:.0f}"
          f" runs/s), seeds-route launches {routes['seeds']}, peak device "
          f"memory {peak:.3f} GiB (here and below: above what the call "
          f"found allocated); every output bit-equal to phase 3's one-shot "
          f"sweep")
    del res

    # ---- b. a 1,013,760-run grid in 131,072-run chunks ------------------
    big = (main_grid[0], main_grid[1], range(BIG_SEEDS))
    _, w_chunk, chunk_peak, _ = timed_sweep(big[0], big[1],
                                            range(CHUNK_SEEDS), **main_kw)
    res, wall_b, peak_b, routes = timed_sweep(*big, chunk_size=BIG_CHUNK,
                                              **main_kw)
    n_big = int(np.prod(res.energy.shape))
    n_chunks = -(-n_big // BIG_CHUNK)
    check(routes == {"seeds": n_chunks, "noise": 0},
          f"1M grid launches {routes}: {n_chunks} expected")
    grid_peak = chunk_peak * n_big / (33 * CHUNK_SEEDS)
    check(peak_b <= BIG_PEAK_X * chunk_peak, f"1M grid peak {peak_b:.3f} "
          f"GiB > {BIG_PEAK_X} x a one-chunk grid's {chunk_peak:.3f} GiB")
    for k in ("progress_mean", "power_mean"):
        check(np.isfinite(res.summary[k]).all(), f"1M grid {k} not finite")
    sub = sim.sweep(big[0], big[1], BIG_SUB, **main_kw)
    for name, a, b in (("energy", res.energy, sub.energy),
                       ("t", res.exec_time, sub.exec_time),
                       ("steps", res.n_steps, sub.n_steps)) + tuple(
            (k, res.summary[k], sub.summary[k]) for k in (
                "progress_mean", "power_mean", "progress_hist",
                "pcap_hist")):
        check(np.array_equal(a[:, :, BIG_SUB], b),
              f"1M grid: {len(BIG_SUB)}-seed sub-grid {name} differs")
    print(f"[runtime] b. {n_big} runs x 2048 (summary) in {n_chunks} chunks "
          f"of {BIG_CHUNK}: {wall_b:.3f} s wall ({n_big / wall_b:.0f} "
          f"runs/s), seeds-route launches {routes['seeds']}, peak device "
          f"memory {peak_b:.3f} GiB, {peak_b / chunk_peak:.2f}x a one-shot "
          f"grid of {33 * CHUNK_SEEDS} runs ({chunk_peak:.3f} GiB, "
          f"{w_chunk:.3f} s; the whole grid one-shot would hold "
          f"~{grid_peak:.2f} GiB); a "
          f"{len(BIG_SUB)}-seed sub-grid bit-equal to its own one-shot "
          f"sweep")
    del res, sub

    # ---- c. the scan engine chunked --------------------------------------
    one, w_one, p_one, _ = timed_sweep(*SCAN_RT, backend="scan", **main_kw)
    ch, w_ch, p_ch, routes = timed_sweep(*SCAN_RT, backend="scan",
                                         chunk_size=SCAN_CHUNK, **main_kw)
    check(routes == {"seeds": 0, "noise": 0}, "scan engine launched the "
          "closed-loop kernel")
    for k in ("progress_mean", "power_mean", "progress_hist", "pcap_hist"):
        check(np.array_equal(one.summary[k], ch.summary[k]),
              f"scan engine chunked {k} != one-shot")
    check(np.array_equal(one.energy, ch.energy), "scan chunked energy")
    n_scan = int(np.prod(one.energy.shape))
    print(f"[runtime] c. scan engine, {n_scan} runs x 2048: one-shot "
          f"{w_one:.2f} s (peak {p_one:.3f} GiB), {n_scan // SCAN_CHUNK} "
          f"chunks of {SCAN_CHUNK} {w_ch:.2f} s (peak {p_ch:.3f} GiB; every "
          f"chunk runs every step, so the wall is ~{n_scan // SCAN_CHUNK}x "
          f"one pass); bit-equal")
    del one, ch

    # ---- d. durable campaigns: transients, then a killed child ----------
    flaky_dir = ROOT / "build" / "campaign_flaky"
    kill_dir = ROOT / "build" / "campaign_kill"
    for d in (flaky_dir, kill_dir):
        shutil.rmtree(d, ignore_errors=True)
    orig_core, made = sim._kernel_core, []

    def flaky_core(collect):
        made.append(supervisor.FlakyGridFn(orig_core(collect), failures={
            1: supervisor.TransientFault("injected"),
            4: torch.OutOfMemoryError("CUDA out of memory (injected)")}))
        return made[-1]

    sim._kernel_core = flaky_core
    try:
        res, wall_d, peak_d, routes = timed_sweep(
            *main_grid, chunk_size=RT_CHUNK, durable=flaky_dir,
            campaign=supervisor.CampaignConfig(retry=RetryPolicy(
                max_retries=3, base_s=0.001, max_s=0.01)), **main_kw)
    finally:
        sim._kernel_core = orig_core
    recs, _ = supervisor.read_journal(flaky_dir / supervisor.JOURNAL_NAME)
    kinds = [r["k"] for r in recs]
    check(kinds.count("retry") == 2 and kinds.count("commit") == RT_LAUNCHES
          and "dead" not in kinds, f"durable campaign journal {kinds}")
    check(made[0].calls == RT_LAUNCHES + 2 and routes["seeds"]
          == RT_LAUNCHES, f"durable campaign calls {made[0].calls}, "
          f"launches {routes}")
    _same_runs(res, main_out, main_summary, "durable campaign")
    del res
    code = (f"import sys\nsys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "from repro_torch.core import sim\n"
            "from repro_torch.core.supervisor import CampaignConfig\n"
            f"sim.sweep({tuple(main_grid[0])!r}, {list(main_grid[1])!r}, "
            f"range({len(main_grid[2])}), chunk_size={RT_CHUNK}, "
            f"durable={str(kill_dir)!r}, campaign=CampaignConfig("
            f"checkpoint_every=2, kill_after_commits={KILL_AFTER}), "
            f"**{main_kw!r})\nprint('SURVIVED_KILL')\n")
    t0 = time.perf_counter()
    # a fresh interpreter (fork + exec), never a fork of this process,
    # which holds a CUDA context
    child = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=600)
    w_child = time.perf_counter() - t0
    check(child.returncode == -9, f"campaign child exit {child.returncode}:"
          f" {child.stdout[-500:]} {child.stderr[-2000:]}")
    recs, torn = supervisor.read_journal(kill_dir / supervisor.JOURNAL_NAME)
    commits = sum(r["k"] == "commit" for r in recs)
    check(commits == KILL_AFTER, f"killed child committed {commits}")
    K.ROUTE_LAUNCHES.update(seeds=0, noise=0)
    t0 = time.perf_counter()
    res = supervisor.resume_campaign(kill_dir)
    w_resume = time.perf_counter() - t0
    resumed = K.ROUTE_LAUNCHES["seeds"]
    # the checkpoint holds the commits up to the last even one
    # (checkpoint_every=2): the rest run again
    check(resumed == RT_LAUNCHES - KILL_AFTER // 2 * 2,
          f"resume launched {resumed} chunks")
    _same_runs(res, main_out, main_summary, "resumed campaign")
    del res
    print(f"[runtime] d. durable main grid in chunks of {RT_CHUNK} under "
          f"FlakyGridFn transients (one injected fault, one CUDA "
          f"out-of-memory): {wall_d:.3f} s wall against {wall_a:.3f} s for "
          f"plain run_grid on the same chunks (a), 2 retries, "
          f"{RT_LAUNCHES} commits, peak {peak_d:.3f} GiB; a spawned child "
          f"SIGKILLed after {KILL_AFTER} commits ({w_child:.1f} s, start-up "
          f"included), resume_campaign finished it in {w_resume:.3f} s "
          f"({resumed} launches: the {RT_LAUNCHES - KILL_AFTER} uncommitted "
          f"chunks and the commit newer than the last checkpoint); both "
          f"bit-equal to phase 3")

    # ---- e. the NRM: run_simulated, resumed segments, control_step ------
    runs, walls = [], []
    for eps in (0.0, 0.1):
        for seed in NRM_SEEDS:
            nrm = NRM(PowerControlConfig(epsilon=eps, plant_profile="gros"))
            t0 = time.perf_counter()
            tr = nrm.run_simulated(total_work=NRM_WORK, max_time=NRM_MT,
                                   seed=seed)
            walls.append(time.perf_counter() - t0)
            check(tr["work"][-1] >= NRM_WORK and np.isfinite(
                tr["power"]).all(), f"run_simulated eps {eps} seed {seed}")
            runs.append(summarize_run(eps, 1.0, tr["progress"],
                                      tr["power"]))
    table = tradeoff_table(runs)
    saving, slower = (table[0.1]["energy_saving"],
                      table[0.1]["time_increase"])
    check(0.05 < saving < 0.45, f"NRM energy saving {saving}")
    check(slower < 0.30, f"NRM time increase {slower}")
    nrm = NRM(PowerControlConfig(epsilon=0.1, plant_profile="gros"))
    seg = []
    for _ in range(3):
        tr = nrm.run_simulated(total_work=1e9, max_time=NRM_MT, seed=0)
        seg.append((float(tr["work"][0]), float(tr["work"][-1])))
    check(seg[0][1] < seg[1][0] < seg[1][1] < seg[2][0] < seg[2][1],
          f"resumed segments' work {seg}")
    ctrl = {}
    for where in ("cuda", "cpu"):
        nrm = NRM(PowerControlConfig(epsilon=0.1, plant_profile="gros"),
                  device=dev if where == "cuda" else "cpu")
        step_s, period_s = [], []
        for k in range(CTRL_PERIODS):
            t0 = time.perf_counter()
            meas = nrm.actuator.advance(1.0)
            n = max(1, int(meas["progress"]))
            nrm.hb.beat_many(k + (np.arange(n) + 0.5) / n)
            t1 = time.perf_counter()
            rec = nrm.control_step()
            t2 = time.perf_counter()
            check(np.isfinite(rec.pcap) and nrm.profile.pcap_min
                  <= nrm.actuator._pcap <= nrm.profile.pcap_max,
                  f"control_step on {where} period {k}: {rec}")
            step_s.append(t2 - t1)
            period_s.append(t2 - t0)
        ctrl[where] = (1e3 * np.median(step_s), 1e3 * np.median(period_s),
                       rec.progress / float(nrm.gains.setpoint))
    print(f"[runtime] e. NRM.run_simulated on gros, {len(NRM_SEEDS)} seeds "
          f"at eps 0.0 and 0.1 (max_time {NRM_MT:.0f} s: a 256-step bucket):"
          f" energy saving {saving:.4f}, time increase {slower:.4f}; wall "
          f"per call median {np.median(walls):.3f} s (first {walls[0]:.3f} "
          f"s); 3 resumed segments, work "
          + " -> ".join(f"{a:.0f}..{b:.0f}" for a, b in seg)
          + f"; {CTRL_PERIODS} control periods on SimulatedPowerActuator: "
          f"control_step median {ctrl['cuda'][0]:.3f} ms on the card, "
          f"{ctrl['cpu'][0]:.3f} ms on the CPU (whole period with the "
          f"plant's advance and the beats: {ctrl['cuda'][1]:.3f} / "
          f"{ctrl['cpu'][1]:.3f} ms); last progress / setpoint "
          f"{ctrl['cuda'][2]:.3f} (card), {ctrl['cpu'][2]:.3f} (CPU)")

    # ---- f. serve --power on qwen3-8b at full width ----------------------
    FK.LAUNCHES, DK.LAUNCHES = 0, 0
    t0 = time.perf_counter()
    res = serve.main(SERVE_ARGV + ["--power"])
    wall_f = time.perf_counter() - t0
    L, GEN, B = 36, 32, 8
    check(FK.LAUNCHES == L and DK.LAUNCHES == L * GEN,
          f"serve --power launches flash {FK.LAUNCHES}, decode "
          f"{DK.LAUNCHES}")
    # the same call without --power, right after: the decode wall moves
    # between calls (43-244 ms a step across runs)
    again = serve.main(SERVE_ARGV)
    check(np.array_equal(res["generated"], serve7["generated"]),
          "serve --power tokens differ from phase 7's")
    check(np.array_equal(again["generated"], serve7["generated"]),
          "serve tokens moved between calls")
    check(res["final_pcap"] is not None and res["energy_j"] > 0,
          f"serve --power accounting {res}")
    tps = lambda r: GEN * B / r["wall_s"]
    print(f"[runtime] f. serve --power, qwen3-8b full width, batch {B}, "
          f"prompt 1024, {GEN} tokens: main() {wall_f:.1f} s; tokens equal "
          f"phase 7's; decode loop {res['wall_s']} s ({tps(res):.1f} tok/s)"
          f", without --power right after {again['wall_s']} s "
          f"({tps(again):.1f} tok/s), phase 7 {serve7['wall_s']} s "
          f"({tps(serve7):.1f} tok/s); the NRM's own host time "
          f"{res['nrm_wall_s']} s, {1e3 * res['nrm_wall_s'] / (GEN - 1):.2f}"
          f" ms a step; simulated time {res['sim_time_s']} s, energy "
          f"{res['energy_j']} J, final cap {res['final_pcap']} W; launches "
          f"flash {L}, decode {L * GEN}")
    for d in (flaky_dir, kill_dir):
        shutil.rmtree(d, ignore_errors=True)
    print(f"[runtime] phase 14 in {time.perf_counter() - started:.1f} s; "
          f"on {smi}")
    return res

# ---- phase 15: the fleet, the control plane and the services --------------

# (a) `benchmarks/beyond_adaptive.py`'s fleets: dahu at 0.7 x peak, 60
# steps; the steady window (steps 20+) is the benchmark's. The bar is
# `tests/test_system.py::test_fleet_respects_power_budget`'s: steady
# power under the budget plus a tenth of peak (0.7 x peak for its 0.6)
FLEETS = (64, 1024)
FLEET_STEPS, FLEET_BUDGET, FLEET_STEADY = 60, 0.7, 20
FLEET_BAR = 0.1
# (a, heterogeneous) gros / dahu / yeti x 1,024 nodes under PI / RLS-PI /
# duty-cycle, class 0 flipping STREAM -> DGEMM at 60 s: the bar of
# `tests/test_workloads.py::test_fleet_per_node_schedules_shift_budget`
HET_STEPS, HET_SHIFT = 160, 0.02
# (b) a 30-seed campaign over fleet_1024 in chunks of 8; the durable
# child kills itself after 2 commits
CAMP_SEEDS, CAMP_CHUNK, CAMP_KILL = 30, 8, 2
CAMP_ROWS = (3, 17)
# (c) `benchmarks/plane_load.py`'s tenant mix and its non-quick run
PLANE_COUNTS, PLANE_TICKS, PLANE_CHUNK = (1_000, 10_000, 100_000), 20, 16384


def make_plane(n: int, device):
    """`benchmarks/plane_load.py`'s plane: ``n`` tenants, ~55% fixed-gain
    PI, 15% RLS-adaptive PI, 15% duty-cycle, 15% detector-enabled PI, in
    one batch add per group."""
    from repro_torch.core.adaptive import RLSConfig
    from repro_torch.core.plane import ControlPlane
    from repro_torch.core.policies import DutyCyclePolicy, PIPolicy
    plane = ControlPlane(profile="gros", epsilon=0.1, dt=1.0, capacity=n,
                         max_beats=8, device=device)
    q = max(n * 15 // 100, 1)
    plane.add_tenants(n - 3 * q)
    plane.add_tenants(q, policy=PIPolicy(adaptive=RLSConfig()))
    plane.add_tenants(q, policy=DutyCyclePolicy())
    plane.add_tenants(q, detector=True)
    return plane


def drive_plane(plane, ticks: int, beats_per_tick: int = 3,
                skip=(), **tick_kw):
    """`benchmarks/plane_load.py`'s service loop: evenly spread beats for
    every tenant (but the slots in ``skip``), one tick; returns the
    decisions of each tick."""
    n = plane.n_tenants
    slots = np.asarray([s for s in range(n) if s not in set(skip)])
    ids = np.repeat(slots, beats_per_tick)
    offs = (np.arange(beats_per_tick) + 1.0) / (beats_per_tick + 1.0)
    out = []
    for _ in range(ticks):
        t0, dt = plane._t, plane.dt
        plane.ingest(ids, np.broadcast_to(t0 + offs * dt,
                                          (len(slots), beats_per_tick)
                                          ).ravel())
        out.append(plane.tick(now=t0 + dt, **tick_kw))
    return out


def _measured(dev, fn):
    """(result, wall s, peak device memory above the baseline GiB)."""
    import torch
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return out, wall, (torch.cuda.max_memory_allocated(dev) - base) / 2**30


def _idle(prof, label: str) -> str:
    if prof is None:
        return "idle share not measured"
    return f"{label} {100 - 100 * prof['busy_us'] / prof['wall_us']:.1f}%"


def _profile_line(prof, per: int, what: str) -> str:
    if prof is None:
        return f"launches a {what} and idle share not measured"
    return (f"{prof['launches'] / per:.0f} launches a {what}, device idle "
            f"{100 - 100 * prof['busy_us'] / prof['wall_us']:.1f}% "
            f"(torch.profiler, device activity only, {per} {what}s)")


def fleet_plane_phase(dev, serve7, serve14, smi) -> None:
    """Phase 15: the fleet (`repro_torch.core.hierarchy`), the
    multi-tenant control plane (`repro_torch.core.plane.ControlPlane`) and
    the observability services (`repro_torch.obs`: the scrape endpoint,
    `validate`, `regress`) on the card. They bring no kernel of their
    own: `serve --power --plane` launches the attention kernels."""
    import pickle
    import shutil
    import threading
    import urllib.request

    from repro_torch.core import supervisor
    from repro_torch.core.adaptive import RLSConfig
    from repro_torch.core.faults import GuardConfig
    from repro_torch.core.hierarchy import (FleetConfig, fleet_sweep,
                                            simulate_fleet)
    from repro_torch.core.plane import ControlPlane
    from repro_torch.core.plant import PROFILES
    from repro_torch.core.policies import DutyCyclePolicy, PIPolicy
    from repro_torch.core.workloads import Phase, PhaseSchedule
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch import serve
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import regress, validate
    started = time.perf_counter()
    dahu = PROFILES["dahu"]
    peak1 = float(dahu.power_of_pcap(dahu.pcap_max))

    # ---- a. the reference's beyond/fleet_64 and fleet_1024 -------------
    for n in FLEETS:
        fc = FleetConfig(n_nodes=n, epsilon=0.1,
                         power_budget=FLEET_BUDGET * peak1 * n)
        run = lambda: simulate_fleet(dahu, fc, FLEET_STEPS, seed=0)
        run()  # first call: allocator warm-up
        tr, wall, peak = _measured(dev, run)
        prof = device_breakdown(run, f"fleet_{n}", host_ops=False,
                                quiet=True)
        for k, v in tr.items():
            check(np.isfinite(v).all(), f"fleet_{n}: {k} not finite")
        steady = float(tr["power"][FLEET_STEADY:].mean())
        budget = fc.power_budget
        check(steady < budget + FLEET_BAR * peak1 * n,
              f"fleet_{n}: steady power {steady:.1f} W over the bar "
              f"{budget + FLEET_BAR * peak1 * n:.1f} W")
        print(f"[fleet] a. beyond/fleet_{n} (dahu, budget "
              f"{FLEET_BUDGET} x peak = {budget:.1f} W, {FLEET_STEPS} "
              f"steps): steady power {steady:.1f} W ({steady / budget:.4f}"
              f" x budget), median progress "
              f"{float(tr['progress_med'][FLEET_STEADY:].mean()):.3f} Hz; "
              f"wall {wall:.3f} s ({1e3 * wall / FLEET_STEPS:.3f} ms a "
              f"step), {_profile_line(prof, FLEET_STEPS, 'step')}, peak "
              f"device memory {peak:.4f} GiB")

    # ---- a. heterogeneous: budget shifting across classes ---------------
    stream = {"alpha": 3.0, "beta": 0.6}
    dgemm = {"alpha": 0.3, "beta": 1.14, "K_L": 2.0}
    profs = [PROFILES[p] for p in ("gros", "dahu", "yeti")]
    n = 1024
    hpeak = sum(float(p.power_of_pcap(p.pcap_max)) for p in profs) * n / 3
    hfc = FleetConfig(n_nodes=n, epsilon=0.05, power_budget=0.55 * hpeak,
                      reallocate_every=5)
    flip = PhaseSchedule((Phase(60.0, scale=stream),
                          Phase(200.0, scale=dgemm)))
    hold = PhaseSchedule((Phase(60.0, scale=stream),))
    hkw = dict(policies=[PIPolicy(), PIPolicy(adaptive=RLSConfig()),
                         DutyCyclePolicy()], schedules=[flip, hold, hold])
    run = lambda: simulate_fleet(profs, hfc, HET_STEPS, seed=0, **hkw)
    tr, wall, peak = _measured(dev, run)
    prof = device_breakdown(run, "heterogeneous fleet", host_ops=False,
                            quiet=True)
    alloc = tr["alloc_class"]
    before = float(alloc[30, 0] / alloc[30].sum())
    after = float(alloc[140:, 0].mean() / alloc[140:].mean(0).sum())
    check(tr["phase_class"][30].tolist() == [0.0, 0.0, 0.0]
          and tr["phase_class"][100].tolist() == [1.0, 0.0, 0.0],
          f"heterogeneous fleet phases {tr['phase_class'][[30, 100]]}")
    check(after > before + HET_SHIFT, f"heterogeneous fleet: class 0's "
          f"share {before:.4f} -> {after:.4f}, not above +{HET_SHIFT}")
    check(all(np.isfinite(v).all() for v in tr.values()),
          "heterogeneous fleet rows not finite")
    print(f"[fleet] a. heterogeneous fleet, 1,024 nodes over gros / "
          f"dahu / yeti (PI / RLS-PI / duty-cycle; class 0 STREAM -> "
          f"DGEMM at 60 s), budget 0.55 x peak, {HET_STEPS} steps: class "
          f"0's share of the allocation {before:.4f} -> {after:.4f} (bar "
          f"+{HET_SHIFT}),"
          f" per-class mean allocation at step 30 "
          f"{np.round(alloc[30], 3).tolist()} W, steps 140+ "
          f"{np.round(alloc[140:].mean(0), 3).tolist()} W; steady power "
          f"{float(tr['power'][40:].mean()):.1f} W of "
          f"{hfc.power_budget:.1f} W; wall {wall:.3f} s ("
          f"{1e3 * wall / HET_STEPS:.3f} ms a step), "
          f"{_profile_line(prof, HET_STEPS, 'step')}, peak {peak:.4f} GiB")

    # ---- b. a multi-seed campaign, plain and durable --------------------
    cfc = FleetConfig(n_nodes=1024, epsilon=0.1,
                      power_budget=FLEET_BUDGET * peak1 * 1024)
    run = lambda: fleet_sweep(dahu, cfc, FLEET_STEPS, range(CAMP_SEEDS),
                              chunk_size=CAMP_CHUNK)
    camp, wall_b, peak_b = _measured(dev, run)
    prof = device_breakdown(run, "campaign", host_ops=False, quiet=True)
    n_chunks = -(-CAMP_SEEDS // CAMP_CHUNK)
    bit = []
    for s in CAMP_ROWS:
        one = simulate_fleet(dahu, cfc, FLEET_STEPS, seed=s)
        for k, v in one.items():
            if k == "class_counts":
                continue
            check(np.allclose(camp[k][s], v, rtol=1e-6, atol=0.0),
                  f"campaign row {s} {k} != simulate_fleet(seed={s})")
            bit.append(np.array_equal(camp[k][s], v))
    camp_dir = ROOT / "build" / "fleet_campaign"
    shutil.rmtree(camp_dir, ignore_errors=True)
    code = (f"import sys\nsys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "from repro_torch.core.hierarchy import FleetConfig, "
            "fleet_sweep\n"
            "from repro_torch.core.plant import PROFILES\n"
            "from repro_torch.core.supervisor import CampaignConfig\n"
            f"fleet_sweep(PROFILES['dahu'], FleetConfig(n_nodes=1024, "
            f"epsilon=0.1, power_budget={cfc.power_budget!r}), "
            f"{FLEET_STEPS}, range({CAMP_SEEDS}), "
            f"chunk_size={CAMP_CHUNK}, "
            f"durable={str(camp_dir)!r}, campaign=CampaignConfig("
            f"checkpoint_every=1, kill_after_commits={CAMP_KILL}))\n"
            "print('SURVIVED_KILL')\n")
    t0 = time.perf_counter()
    # a fresh interpreter, never a fork of this CUDA process
    child = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, text=True, timeout=600)
    w_child = time.perf_counter() - t0
    check(child.returncode == -9, f"fleet campaign child exit "
          f"{child.returncode}: {child.stdout[-500:]} "
          f"{child.stderr[-2000:]}")
    recs, _ = supervisor.read_journal(camp_dir / supervisor.JOURNAL_NAME)
    commits = sum(r["k"] == "commit" for r in recs)
    check(commits == CAMP_KILL, f"killed fleet child committed {commits}")
    res, w_resume, _ = _measured(
        dev, lambda: supervisor.resume_campaign(camp_dir))
    for k, v in camp.items():
        check(np.array_equal(res[k], v), f"resumed fleet campaign {k} "
              f"differs from the plain campaign")
    shutil.rmtree(camp_dir, ignore_errors=True)
    print(f"[fleet] b. fleet_sweep, {CAMP_SEEDS} seeds x 1,024 nodes x "
          f"{FLEET_STEPS} steps in {n_chunks} chunks of {CAMP_CHUNK}: "
          f"wall {wall_b:.3f} s "
          f"({CAMP_SEEDS * 1024 * FLEET_STEPS / wall_b:.0f} node-steps/s)"
          f", {_profile_line(prof, n_chunks * FLEET_STEPS, 'chunk step')}"
          f", peak {peak_b:.4f} GiB; rows {list(CAMP_ROWS)} against "
          f"simulate_fleet within rtol 1e-6, bit-equal: {all(bit)}; "
          f"durable child SIGKILLed after {CAMP_KILL} commits "
          f"({w_child:.1f} s, start-up included), resume_campaign in "
          f"{w_resume:.3f} s, every trace bit-equal to the plain campaign")
    del camp, res

    # ---- c. the control plane under load --------------------------------
    rates = {}
    for n in PLANE_COUNTS:
        plane = make_plane(n, dev)
        drive_plane(plane, 1)  # warm
        _, wall, peak = _measured(dev, lambda: drive_plane(plane,
                                                           PLANE_TICKS))
        prof = device_breakdown(lambda: drive_plane(plane, 1),
                                f"plane {n}", host_ops=False, quiet=True)
        rates[n] = PLANE_TICKS / wall
        print(f"[plane] c. {n} tenants (plane_load mix), {PLANE_TICKS} "
              f"ticks: {rates[n]:.2f} ticks/s, {rates[n] * n:.0f} "
              f"tenant-ticks/s ({1e3 * wall / PLANE_TICKS:.3f} ms a tick, "
              f"host store, row copies and merge included), "
              f"{_profile_line(prof, 1, 'tick')}, peak {peak:.4f} GiB")
    # chunked == unchunked on the 100k plane's state
    twin = ControlPlane.restore(plane.snapshot(), device=dev)
    a = drive_plane(plane, 2, chunk_size=PLANE_CHUNK)
    b = drive_plane(twin, 2)
    for da, db in zip(a, b):
        for k in da:
            check(np.array_equal(da[k], db[k]),
                  f"chunked plane tick {k} != unchunked")
    # one blacked-out guarded tenant among 10k
    planes = []
    for _ in range(2):
        p = make_plane(10_000, dev)
        p.add_tenant("sick", guard=GuardConfig(hold_k=2, failsafe_k=5))
        planes.append(p)
    healthy, chaos = planes
    sick = chaos.slot("sick")
    others = np.arange(chaos.capacity) != sick
    for k in range(12):
        dh = drive_plane(healthy, 1)[0]
        dc = drive_plane(chaos, 1, skip=(sick,) if k >= 3 else ())[0]
        for key in ("pcap", "applied", "progress", "phase_change"):
            check(np.array_equal(dh[key][others], dc[key][others]),
                  f"quarantine tick {k}: other tenants' {key} moved")
    check(chaos.quarantined() == ["sick"] and healthy.quarantined() == [],
          f"quarantine lists {chaos.quarantined()} "
          f"{healthy.quarantined()}")
    # a snapshot restored in a fresh process makes the same decisions
    snap_dir = ROOT / "build" / "plane_snapshot"
    snap_dir.mkdir(parents=True, exist_ok=True)
    with open(snap_dir / "plane.pkl", "wb") as fh:
        pickle.dump(healthy.snapshot(), fh)
    code = (f"import sys, pickle\nimport numpy as np\n"
            f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import chip_smoke\n"
            "from repro_torch.core.plane import ControlPlane\n"
            f"plane = ControlPlane.restore(pickle.load(open("
            f"{str(snap_dir / 'plane.pkl')!r}, 'rb')))\n"
            "out = chip_smoke.drive_plane(plane, 3)\n"
            "np.save(sys.argv[1], "
            "np.stack([d['applied'] for d in out]))\n")
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", code,
                            str(snap_dir / "resumed.npy")],
                           capture_output=True, text=True, timeout=600)
    w_snap = time.perf_counter() - t0
    check(child.returncode == 0, f"snapshot child: {child.stderr[-2000:]}")
    expect = np.stack([d["applied"] for d in drive_plane(healthy, 3)])
    check(np.array_equal(np.load(snap_dir / "resumed.npy"), expect),
          "restored plane's decisions differ")
    shutil.rmtree(snap_dir, ignore_errors=True)
    print(f"[plane] c. gates: a 100k-tenant tick in chunks of "
          f"{PLANE_CHUNK} bit-equal to one chunk (2 ticks); one "
          f"blacked-out "
          f"guarded tenant among 10,001 quarantined, the other tenants "
          f"bit-identical to the healthy plane over 12 ticks; a snapshot "
          f"restored in a fresh process ({w_snap:.1f} s) made the same 3 "
          f"ticks of decisions")
    del plane, twin, planes, healthy, chaos

    # ---- d. serve --power --plane --obs-port 0 --------------------------
    scrapes, errors, up = {}, [], threading.Event()
    stop = threading.Event()
    url = []

    def scraper():
        up.wait(600)
        get = lambda path: urllib.request.urlopen(
            url[0] + path, timeout=30).read().decode()
        while not stop.is_set():
            try:
                for path in ("/healthz", "/metrics", "/metrics.json",
                             "/events?log=plane"):
                    body = get(path)
                    if path != "/events?log=plane" or body:
                        scrapes.setdefault(path, []).append(body)
            except Exception as e:  # recorded, then checked below
                errors.append(repr(e))
                return
            time.sleep(0.05)

    th = threading.Thread(target=scraper, daemon=True)
    th.start()
    FK.LAUNCHES, DK.LAUNCHES = 0, 0

    def on_obs(srv):
        url.append(srv.url)
        up.set()
        stop_server = srv.stop

        def stop_after_scraper():
            # the scraper ends before the server does: a scrape cut by
            # the shutdown is not an error of the endpoint
            stop.set()
            th.join(timeout=60)
            stop_server()

        srv.stop = stop_after_scraper

    holder = {}

    def served():
        holder["res"] = serve.main(SERVE_ARGV + ["--power", "--plane",
                                                 "--obs-port", "0"],
                                   on_obs=on_obs)

    def profiled():
        holder["prof"] = device_breakdown(served, "serve --power --plane",
                                          host_ops=False, quiet=True)

    _, wall_d, peak_d = _measured(dev, profiled)
    res = holder["res"]
    L, GEN, B = 36, 32, 8
    check(FK.LAUNCHES == L and DK.LAUNCHES == L * GEN,
          f"serve --plane launches flash {FK.LAUNCHES}, decode "
          f"{DK.LAUNCHES}")
    check(np.array_equal(res["generated"], serve7["generated"]),
          "serve --power --plane tokens differ from phase 7's")
    check(res["plane_wall_s"] is not None and res["energy_j"] > 0,
          f"serve --plane accounting {res}")
    check(not errors, f"scrape errors {errors}")
    check(all(scrapes.get(p) for p in ("/healthz", "/metrics",
                                       "/metrics.json",
                                       "/events?log=plane")),
          f"scrapes {sorted((k, len(v)) for k, v in scrapes.items())}")
    scr = ROOT / "build" / "scrapes"
    scr.mkdir(parents=True, exist_ok=True)
    for i, (m, j) in enumerate(zip(scrapes["/metrics"],
                                   scrapes["/metrics.json"])):
        (scr / f"m{i}.txt").write_text(m)
        (scr / f"m{i}.json").write_text(j)
        with contextlib.redirect_stdout(None):
            rc = validate.main(["--prom", str(scr / f"m{i}.txt"),
                                "--metrics", str(scr / f"m{i}.json")])
        check(rc == 0, f"scrape {i} fails obs.validate")
    rows = [json.loads(ln) for body in scrapes["/events?log=plane"]
            for ln in body.splitlines()]
    check(rows and all(r["log"] == "plane" for r in rows)
          and any(r["name"] == "tenant_added" for r in rows),
          f"plane events {rows[:3]}")
    health = json.loads(scrapes["/healthz"][-1])
    check(health["status"] == "ok", f"healthz {health}")
    shutil.rmtree(scr, ignore_errors=True)
    reg = obs_metrics.get_registry()
    ticks = reg.counter("plane_ticks_total", "").value()
    prof = holder.get("prof")
    tps = lambda r: GEN * B / r["wall_s"]
    print(f"[serve] d. serve --power --plane --obs-port 0, qwen3-8b full "
          f"width, batch {B}, prompt 1024, {GEN} tokens: main() "
          f"{wall_d:.1f} s under the device-activity profiler; tokens "
          f"equal"
          f" phase 7's; decode loop {res['wall_s']} s ({tps(res):.1f} "
          f"tok/s) beside phase 14 (f)'s --power {serve14['wall_s']} s "
          f"({tps(serve14):.1f} tok/s) and phase 7's plain decode "
          f"{serve7['wall_s']} s ({tps(serve7):.1f} tok/s); the plane's "
          f"host time {res['plane_wall_s']} s, "
          f"{1e3 * res['plane_wall_s'] / (GEN - 1):.2f} ms a decode step "
          f"(the NRM's in phase 14 (f): {serve14['nrm_wall_s']} s); "
          f"{len(scrapes['/metrics'])} scrape rounds of /healthz, "
          f"/metrics, /metrics.json and /events?log=plane from a thread "
          f"during the call, every payload valid (obs.validate), "
          f"{len(rows)} plane event rows; final cap {res['final_pcap']} W,"
          f" energy {res['energy_j']} J; launches flash {L}, decode "
          f"{L * GEN}; " + _idle(prof, "whole call's device idle")
          + f"; peak {peak_d:.3f} GiB; plane_ticks_total {ticks:.0f}")

    # ---- e. the regression gate on the card -----------------------------
    bench = ROOT / "BENCH_sim.json"
    data = json.loads(bench.read_text())
    (card, w_card, peak_e) = _measured(dev, lambda: regress.assess(data))
    host = regress.assess(data, device="cpu")
    check(json.dumps(card, sort_keys=True) == json.dumps(host,
                                                         sort_keys=True),
          "regress report on the card differs from the CPU's")
    with contextlib.redirect_stdout(None):
        rc_card = regress.main([str(bench)])
        rc_host = regress.main([str(bench), "--device", "cpu"])
    check(rc_card == rc_host, f"regress exit {rc_card} on the card, "
          f"{rc_host} on the CPU")
    prof = device_breakdown(lambda: regress.assess(data), "regress",
                            host_ops=False, quiet=True)
    print(f"[obs] e. regress over BENCH_sim.json on the card: "
          f"{card['n_series']} series analysed, {len(card['skipped'])} "
          f"skipped (short), {card['n_changes']} change point(s), exit "
          f"{rc_card}; the same report and exit code as on the CPU; wall "
          f"{1e3 * w_card:.2f} ms, "
          + (f"{prof['launches']} launches, " if prof else "")
          + _idle(prof, "device idle") + f", peak {peak_e:.5f} GiB")
    print(f"[fleet] phase 15 in {time.perf_counter() - started:.1f} s; "
          f"on {smi}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import sim
    from repro_torch.core.energy import summarize_run, tradeoff_table
    from repro_torch.core.plant import PROFILES
    from repro_torch.kernels import _build, sass
    from repro_torch.kernels.closed_loop import kernel as K
    from repro_torch.kernels.closed_loop import ops
    from repro_torch.kernels.closed_loop import ref as R
    from repro_torch.kernels.closed_loop.parity import (
        CARD_CASES, CARD_SUMMARY_FROM, check_parity)

    started = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)

    # ---- 1. set-up ---------------------------------------------------
    print(f"[setup] nvidia-smi: {smi}")
    print(f"[setup] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
          f"count {torch.cuda.device_count()}")
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.selective_scan import kernel as SK
    t0 = time.perf_counter()
    lib, *other_libs = _build.build_all([K.SOURCE, FK.SOURCE,
                                         FK.WGMMA_SOURCE, DK.SOURCE,
                                         SK.SOURCE])
    _, wgmma_lib, decode_lib, scan_lib = other_libs
    print(f"[setup] built {lib.relative_to(ROOT)}, "
          + ", ".join(str(x.relative_to(ROOT)) for x in other_libs)
          + f" in {time.perf_counter() - t0:.2f} s (one nvcc each, in "
          f"parallel)")
    hopper_paths(wgmma_lib, decode_lib)
    loop_instr = closed_loop_sass(lib, dev)

    # count the plain version's and the noise draw's calls too: the main
    # path must make none
    plain_calls, draw_calls = [0], [0]
    plain_fn, draw_fn = R.closed_loop_ref, ops.draw_noise

    def counted_plain(*a, **kw):
        plain_calls[0] += 1
        return plain_fn(*a, **kw)

    def counted_draw(*a, **kw):
        draw_calls[0] += 1
        return draw_fn(*a, **kw)

    R.closed_loop_ref, ops.draw_noise = counted_plain, counted_draw

    # ---- 2. both routes against the plain version on the card -------
    def rows(names, reps, eps=0.1):
        return sim.grid_rows(list(names) * reps, [eps], [0])[:2]

    max_err, same_runs, all_runs = 0.0, 0, 0
    t0 = time.perf_counter()
    for i, (names, reps, mt, tw) in enumerate(CARD_CASES):
        prof, gains = rows(names, reps)
        for dtype in (torch.float32, torch.bfloat16):
            p = prof.to(dev, dtype)
            g = gains.to(dev, dtype)
            B = p.shape[0]
            T = ops.horizon(mt, 1.0)
            seeds = torch.arange(B, device=dev) + 1000 * i
            noise = ops.draw_noise(seeds, T)
            sc = (tw, mt, 1.0, CARD_SUMMARY_FROM)
            plain = R.closed_loop_ref(p, g, noise, *sc, collect=True)
            tag = f"case {i} {dtype}"
            errs, (a, b) = both_routes(p, g, seeds, noise, sc, plain, tag)
            same = runs_equal(a[1], b[1], a[0], b[0])
            same_runs, all_runs = same_runs + same, all_runs + B
            print(f"[parity] case {i} {'+'.join(names)} x{reps} B={B} "
                  f"T={T} {str(dtype)[6:]}: max |kernel - plain| seeds "
                  f"route {errs[0]:.3e}, tensor route {errs[1]:.3e}; "
                  f"seeds route against tensor route {errs[2]:.3e}, "
                  f"{same}/{B} runs bit-equal")
            max_err = max(max_err, *errs)
    # one 4,096-run x 2,048-step grid over the four profiles and eps grid
    names = ("gros", "dahu", "yeti", "v5e-chip")
    prof, gains, seeds = sim.grid_rows(names, EPS_GRID[:8], range(128))
    prof, gains, seeds = prof.to(dev), gains.to(dev), seeds.to(dev)
    big_noise = ops.draw_noise(seeds, 2048)
    big_sc = (1e9, 2048.0, 1.0, 30.0)
    plain = R.closed_loop_ref(prof, gains, big_noise, *big_sc, collect=True)
    errs, (a, b) = both_routes(prof, gains, seeds, big_noise, big_sc, plain,
                               "grid 4096x2048")
    same = runs_equal(a[1], b[1], a[0], b[0])
    same_runs, all_runs = same_runs + same, all_runs + prof.shape[0]
    print(f"[parity] grid B={prof.shape[0]} T=2048, trace and summary: max "
          f"|kernel - plain| seeds route {errs[0]:.3e}, tensor route "
          f"{errs[1]:.3e}; seeds route against tensor route {errs[2]:.3e},"
          f" {same}/{prof.shape[0]} runs bit-equal")
    max_err = max(max_err, *errs)
    big_seeds = seeds
    del plain, a, b
    print(f"[parity] all shapes agree on both routes; max |kernel - plain| "
          f"= {max_err:.3e}; runs bit-equal between the routes "
          f"{same_runs}/{all_runs} ({100 * same_runs / all_runs:.2f}%) "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- 3. the main path at real size -------------------------------
    main_kw = dict(total_work=1e9, max_time=2048.0, dt=1.0,
                   collect_traces=False, summary_warmup=30)
    main_grid = (("gros", "dahu", "yeti"), EPS_GRID, range(3072))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES, plain_calls[0], draw_calls[0] = 0, 0, 0
    K.ROUTE_LAUNCHES.update(seeds=0, noise=0)
    t0 = time.perf_counter()
    res = sim.sweep(*main_grid, **main_kw)
    wall = time.perf_counter() - t0
    main_peak = torch.cuda.max_memory_allocated() / 2**30
    routes, main_plain, main_draws = (dict(K.ROUTE_LAUNCHES), plain_calls[0],
                                      draw_calls[0])
    launches = routes["seeds"]
    check(routes == {"seeds": 1, "noise": 0}, f"main path launches by "
          f"route {routes}: one fused (seeds) launch expected")
    check(main_plain == 0, "main path called the plain version")
    check(main_draws == 0, "main path called draw_noise")
    n_runs = int(np.prod(res.energy.shape))
    live_steps = int(res.n_steps.astype(np.int64).sum())
    print(f"[main] sweep {res.energy.shape} = {n_runs} runs x 2048 steps "
          f"in {wall * 1e3:.1f} ms wall ({n_runs / wall:.0f} runs/s, "
          f"{live_steps / wall:.4g} run-steps/s); kernel launches by route "
          f"{routes}, draw_noise calls {main_draws}, plain-version calls "
          f"{main_plain}; peak device memory {main_peak:.3f} GiB")
    check(res.energy.shape == (3, 11, 3072), "main grid shape")
    for k in ("progress_mean", "power_mean", "progress_std"):
        check(np.isfinite(res.summary[k]).all(), f"{k} not finite")
    check(np.isfinite(res.energy).all(), "energy not finite")
    check((res.n_steps == 2048).all(), "every run lives 2048 steps")
    check(np.all(res.summary["progress_hist"].sum(-1) == 2048 - 30),
          "histogram mass is the post-warm-up step count")
    for pi, pname in enumerate(main_grid[0]):
        pmax = PROFILES[pname].progress_max
        pm = res.summary["progress_mean"][pi].mean(-1)
        em = res.energy[pi].mean(-1).astype(np.float64)
        for ei, eps in enumerate(EPS_GRID):
            if eps >= 0.1 - 1e-9:
                sp = (1.0 - eps) * pmax
                check(abs(pm[ei] - sp) < 0.12 * sp,
                      f"{pname} eps={eps}: progress {pm[ei]} vs {sp}")
        check(np.all(np.diff(em) < 0), f"{pname}: energy not falling in "
              f"eps: {em}")
        print(f"[main] {pname}: seed-mean progress / setpoint at eps "
              f"0.1..0.5 = "
              + " ".join(f"{pm[ei] / ((1 - e) * pmax):.4f}"
                         for ei, e in enumerate(EPS_GRID) if e >= 0.1)
              + f"; energy eps=0 {em[0]:.6g} J -> eps=0.5 {em[-1]:.6g} J")
    main_out = {"energy": res.energy, "work": res.work,
                "t": res.exec_time, "steps": res.n_steps}
    main_summary = {k: res.summary[k] for k in (
        "progress_mean", "progress_std", "power_mean", "progress_hist",
        "pcap_hist")}
    # seed means per (profile, eps), for phase 11's scan engine
    kernel_means = {"progress_mean": res.summary["progress_mean"].mean(-1),
                    "power_mean": res.summary["power_mean"].mean(-1),
                    "energy": res.energy.mean(-1)}
    del res
    device_breakdown(lambda: sim.sweep(*main_grid, **main_kw),
                     "sweep, 101,376 runs x 2,048 steps, seeds route")

    # ---- 4. the paper's headline through sweep and simulate ----------
    K.LAUNCHES, plain_calls[0], draw_calls[0] = 0, 0, 0
    K.ROUTE_LAUNCHES.update(seeds=0, noise=0)
    hl = sim.sweep("gros", [0.0, 0.1], range(30), total_work=6000.0)
    runs = []
    for ei, eps in enumerate((0.0, 0.1)):
        for s in range(30):
            live = hl.traces["valid"][ei, s]
            runs.append(summarize_run(eps, 1.0,
                                      hl.traces["progress"][ei, s][live],
                                      hl.traces["power"][ei, s][live]))
    table = tradeoff_table(runs)
    check(bool(hl.completed.all()), "headline runs did not complete")
    check(0.05 < table[0.1]["energy_saving"] < 0.45,
          f"energy saving {table[0.1]['energy_saving']}")
    check(table[0.1]["time_increase"] < 0.30,
          f"time increase {table[0.1]['time_increase']}")
    for s in (0, 17):
        one = sim.simulate_closed_loop("gros", 0.1, total_work=6000.0,
                                       seed=s)
        check(one.energy == float(hl.energy[1, s])
              and one.n_steps == int(hl.n_steps[1, s]),
              f"simulate_closed_loop seed {s} != sweep cell")
    check(K.ROUTE_LAUNCHES == {"seeds": 3, "noise": 0}
          and plain_calls[0] == 0 and draw_calls[0] == 0, "headline path")
    print(f"[headline] gros eps=0.1 vs 0: energy saving "
          f"{table[0.1]['energy_saving']:.4f}, time increase "
          f"{table[0.1]['time_increase']:.4f} (30 seeds, total_work 6000); "
          f"kernel launches by route {K.ROUTE_LAUNCHES}")

    # ---- 5. the main path's own inputs: parity, then timings --------
    prof, gains, seeds = sim.grid_rows(*main_grid)
    prof, gains, seeds = prof.to(dev), gains.to(dev), seeds.to(dev)
    draw_ms = cuda_ms(lambda: ops.draw_noise(seeds, 2048), reps=5)
    noise = ops.draw_noise(seeds, 2048)
    main_sc = (1e9, 2048.0, 1.0, 30.0)
    t0 = time.perf_counter()
    _, blk = K.closed_loop_seeds_cuda(prof, gains, seeds, 2048, main_sc,
                                      collect=False)
    fk = K.unpack_final(*blk)
    for k, v in main_out.items():  # the sweep ran this very launch
        check(np.array_equal(fk[k].cpu().numpy().astype(v.dtype),
                             v.reshape(-1)), f"main path {k} != sweep's")
    _, blk = K.closed_loop_cuda(prof, gains, noise, main_sc, collect=False)
    fn = K.unpack_final(*blk)
    err_routes = check_parity(None, fk, None, fn,
                              tag=f"main path B={n_runs}: seeds route "
                                  f"against tensor route")
    same = runs_equal(fk, fn)
    plain = R.closed_loop_ref(prof, gains, noise, *main_sc, collect=False)
    err = check_parity(None, fk, None, plain[1],
                       tag=f"main path B={n_runs} T=2048 summary")
    err_t = check_parity(None, fn, None, plain[1],
                         tag=f"main path B={n_runs}, tensor route")
    max_err = max(max_err, err, err_t, err_routes)
    print(f"[parity] main path B={n_runs} T=2048 summary: max |kernel - "
          f"plain| seeds route {err:.3e}, tensor route {err_t:.3e}; seeds "
          f"route against tensor route {err_routes:.3e}, {same}/{n_runs} "
          f"runs bit-equal; phase 3's sweep equals this seeds-route launch "
          f"({time.perf_counter() - t0:.1f} s)")
    del plain, fk, fn, blk

    def fused():
        K.closed_loop_seeds_cuda(prof, gains, seeds, 2048, main_sc,
                                 collect=False)

    def tensor():
        K.closed_loop_cuda(prof, gains, noise, main_sc, collect=False)

    f1, t1, t2, f2 = (cuda_ms(f) for f in (fused, tensor, tensor, fused))
    kern_ms, tensor_ms = (f1 + f2) / 2, (t1 + t2) / 2
    # the plain version of the seeds route: draw_noise, then the plain
    # closed loop on the card (the parity run above was its warm-up)
    plain_ms = cuda_ms(lambda: R.closed_loop_ref(
        prof, gains, ops.draw_noise(seeds, 2048), *main_sc, collect=False),
        reps=3, warmup=0)
    rows_bytes = (prof.numel() + gains.numel()) * 4
    out_bytes = (K.N_STATE + R.PROG_BINS + R.CAP_BINS) * n_runs * 4
    bound_ms, bound_by, how = bound(
        rows_bytes + seeds.numel() * 8 + out_bytes, live_steps,
        loop_instr["seeds", "summary"])
    t_bound, t_by, t_how = bound(
        rows_bytes + live_steps * NOISE_BYTES_PER_STEP + out_bytes,
        live_steps, loop_instr["noise", "summary"])
    print(f"[time] closed_loop kernel, seeds route (noise generated in the "
          f"kernel), main path ({n_runs} runs x 2048, summary): "
          f"{kern_ms:.4f} ms ({f1:.4f}, {f2:.4f}); bound {bound_ms:.4f} ms "
          f"by {bound_by} ({how}); {100 * bound_ms / kern_ms:.1f}% of the "
          f"bound")
    print(f"[time] closed_loop kernel, tensor route, same runs: "
          f"{tensor_ms:.4f} ms ({t1:.4f}, {t2:.4f}); bound {t_bound:.4f} ms "
          f"by {t_by} ({t_how}); {100 * t_bound / tensor_ms:.1f}% of the "
          f"bound; with draw_noise {draw_ms + tensor_ms:.3f} ms")
    print(f"[time] draw_noise (T=2048, B={n_runs}): {draw_ms:.3f} ms; plain "
          f"version of the seeds route (draw_noise + plain closed loop): "
          f"{plain_ms:.2f} ms ({plain_ms / kern_ms:.1f}x the fused kernel)")
    del noise
    torch.cuda.empty_cache()

    # the sweep's wall by route, in turns: seeds, tensor, tensor, seeds
    walls, peaks = {"seeds": [], "noise": []}, {}
    for route in ("seeds", "noise", "noise", "seeds"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with (tensor_route(ops) if route == "noise"
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            sim.sweep(*main_grid, **main_kw)
            walls[route].append(time.perf_counter() - t0)
        peaks[route] = torch.cuda.max_memory_allocated() / 2**30
    for route, label in (("seeds", "seeds route"),
                         ("noise", "tensor route (draw_noise + kernel)")):
        w = np.mean(walls[route])
        kern = kern_ms if route == "seeds" else tensor_ms + draw_ms
        print(f"[main] sweep wall, {label}: "
              + ", ".join(f"{x * 1e3:.1f}" for x in walls[route])
              + f" ms ({n_runs / w:.0f} runs/s); device work "
              f"{kern:.1f} ms, host front end {w * 1e3 - kern:.1f} ms; peak "
              f"device memory {peaks[route]:.3f} GiB")

    big_prof, big_gains = sim.grid_rows(names, EPS_GRID[:8], range(128))[:2]
    big_prof, big_gains = big_prof.to(dev), big_gains.to(dev)
    tr_steps = big_prof.shape[0] * 2048
    for route, call in (
            ("seeds", lambda: K.closed_loop_seeds_cuda(
                big_prof, big_gains, big_seeds, 2048, big_sc, collect=True)),
            ("noise", lambda: K.closed_loop_cuda(
                big_prof, big_gains, big_noise, big_sc, collect=True))):
        tr_ms = cuda_ms(call)
        noise_bytes = tr_steps * NOISE_BYTES_PER_STEP if route == "noise" \
            else 0
        tb, tby, thow = bound(tr_steps * TRACE_BYTES_PER_STEP + noise_bytes,
                              tr_steps, loop_instr[route, "trace"])
        print(f"[time] closed_loop kernel, {route} route, trace mode "
              f"({big_prof.shape[0]} runs x 2048): {tr_ms:.4f} ms; bound "
              f"{tb:.4f} ms by {tby} ({thow})")
    print("[time] library yardstick: none (no single PyTorch call "
          "computes this closed loop)")
    R.closed_loop_ref, ops.draw_noise = plain_fn, draw_fn

    del big_noise, prof, gains, seeds, big_prof, big_gains, big_seeds
    torch.cuda.empty_cache()

    attn_err = attention_parity(dev)                      # phase 6
    serving = serving_path(dev)                           # phase 7
    attn_rows = attention_timings(dev, serving, attn_err)  # phase 8
    serve7 = serving[3]
    del serving  # qwen3-8b's weights: free them before jamba's
    torch.cuda.empty_cache()
    scan_err = scan_parity(dev, scan_lib)                 # phase 9
    scan_row = jamba_serving(dev, scan_err)               # phase 10
    torch.cuda.empty_cache()
    paper_workflow(dev, main_grid, main_kw, kernel_means, smi)  # phase 11
    policies_phase(dev, main_grid, main_kw, main_out, main_summary,
                   smi)                                   # phase 12
    scenarios_phase(dev, main_grid, main_kw, smi)         # phase 13
    serve14 = runtime_phase(dev, main_grid, main_kw, main_out,
                            main_summary, serve7, smi)    # phase 14
    fleet_plane_phase(dev, serve7, serve14, smi)          # phase 15

    print(f"[done] every phase passed in {time.perf_counter() - started:.1f}"
          f" s, the kernels' build included")
    print(json.dumps({"kernels": [{
        "name": "closed_loop", "route": "cuda",
        "source": "src/repro_torch/kernels/closed_loop/csrc/closed_loop.cu",
        "replaces": "src/repro/kernels/closed_loop/kernel.py:59",
        "launches": launches, "max_abs_err": max_err, "ms": kern_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}] + attn_rows + [scan_row]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
