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
   complete, the trade-off direction holds).

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
    return launches, params, batch


def device_breakdown(fn, label: str, host_ops: bool = True):
    """Print the device time of one call of ``fn`` by kernel family and
    its share of the call's wall time, from `torch.profiler`, and return
    ``{"wall_us", "busy_us", "launches"}`` (None when not measured). A
    reading, not a check: if the profiler gives no device events it says
    so. ``host_ops=False`` records the device's activity only: over tens
    of thousands of launches, recording every host op slows the host and
    so inflates the idle share it reads."""
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
        print(f"[profile] {label}: wall {wall_us / 1e3:.3f} ms, device "
              f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%, idle "
              f"{100 - 100 * busy / wall_us:.1f}%); "
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

    launches, params, batch = serving
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
    del serving  # qwen3-8b's weights: free them before jamba's
    torch.cuda.empty_cache()
    scan_err = scan_parity(dev, scan_lib)                 # phase 9
    scan_row = jamba_serving(dev, scan_err)               # phase 10
    torch.cuda.empty_cache()
    paper_workflow(dev, main_grid, main_kw, kernel_means, smi)  # phase 11

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
