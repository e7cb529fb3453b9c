#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA
GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases, each of which fails the run if a check fails:

1. set-up: the card, the torch/CUDA versions and the kernel build from
   the sources in this checkout (timed);
2. every kernel against its plain PyTorch version on the card, on the
   same inputs, in trace and summary mode, at the shapes of
   `parity.CARD_CASES` and one 4,096-run x 2,048-step grid;
3. the main path at real size: `sweep` over gros/dahu/yeti x 11
   epsilons x 3,072 seeds (101,376 runs, 2,048 steps) in summary mode,
   with the kernel's launch count read around it and physical checks;
4. the paper's headline (eps = 0.1 on gros) through a trace-mode `sweep`
   and `simulate_closed_loop`;
5. the kernel against its plain version on the main path's own inputs
   (101,376 runs, summary mode), the kernel's output against phase 3's
   sweep, and timings with CUDA events (warm-up, median of 5 or 7): the
   kernel beside its bound, the plain version, the noise draw.

Prints a `kernels` JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or without the port's sources beside it.
"""
from __future__ import annotations

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
# closed-loop kernel bytes per live run-step: 5 float32 noise reads,
# and 7 float32 trace writes in trace mode
NOISE_BYTES_PER_STEP = 5 * 4
TRACE_BYTES_PER_STEP = 7 * 4
# the float32 instantiations of the kernel (the main path's rows), in
# summary and trace mode
SUMMARY_KERNEL = "closed_loop_kernelIfLb0E"
TRACE_KERNEL = "closed_loop_kernelIfLb1E"

EPS_GRID = [round(0.05 * i, 2) for i in range(11)]


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

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)

    # ---- 1. set-up ---------------------------------------------------
    print(f"[setup] nvidia-smi: {smi}")
    print(f"[setup] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.build(K.SOURCE)
    print(f"[setup] built {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    loop_instr = {mode: sass.kernel_loop_instructions(lib, part)
                  for mode, part in (("summary", SUMMARY_KERNEL),
                                     ("trace", TRACE_KERNEL))}
    print(f"[setup] SASS instructions per live step on the shortest pass "
          f"of the time loop: summary {loop_instr['summary']}, trace "
          f"{loop_instr['trace']}")

    # count the plain version's calls too: the main path must make none
    plain_calls = [0]
    plain_fn = R.closed_loop_ref

    def counted_plain(*a, **kw):
        plain_calls[0] += 1
        return plain_fn(*a, **kw)

    R.closed_loop_ref = counted_plain

    # ---- 2. kernel against plain version on the card ----------------
    def rows(names, reps, eps=0.1):
        return sim.grid_rows(list(names) * reps, [eps], [0])[:2]

    max_err = 0.0
    t0 = time.perf_counter()
    for i, (names, reps, mt, tw) in enumerate(CARD_CASES):
        prof, gains = rows(names, reps)
        for dtype in (torch.float32, torch.bfloat16):
            p = prof.to(dev, dtype)
            g = gains.to(dev, dtype)
            B = p.shape[0]
            T = ops.horizon(mt, 1.0)
            noise = ops.draw_noise(torch.arange(B, device=dev) + 1000 * i,
                                   T)
            sc = (tw, mt, 1.0, CARD_SUMMARY_FROM)
            plain = R.closed_loop_ref(p, g, noise, *sc, collect=True)
            tk, blk = K.closed_loop_cuda(p, g, noise, sc, collect=True)
            _, blk_s = K.closed_loop_cuda(p, g, noise, sc, collect=False)
            fk, fs = K.unpack_final(*blk), K.unpack_final(*blk_s)
            torch.cuda.synchronize()
            for k in fk:  # summary mode == trace mode, bit for bit
                check(torch.equal(fk[k], fs[k]), f"case {i}: summary {k}")
            err = check_parity(tk, fk, *plain, tag=f"case {i} {dtype}")
            print(f"[parity] case {i} {'+'.join(names)} x{reps} B={B} "
                  f"T={T} {str(dtype)[6:]}: max |kernel - plain| = {err:.3e}")
            max_err = max(max_err, err)
    # one 4,096-run x 2,048-step grid over the four profiles and eps grid
    names = ("gros", "dahu", "yeti", "v5e-chip")
    prof, gains, seeds = sim.grid_rows(names, EPS_GRID[:8], range(128))
    prof, gains, seeds = prof.to(dev), gains.to(dev), seeds.to(dev)
    big_noise = ops.draw_noise(seeds, 2048)
    big_sc = (1e9, 2048.0, 1.0, 30.0)
    plain = R.closed_loop_ref(prof, gains, big_noise, *big_sc, collect=True)
    for collect in (True, False):
        tk, blk = K.closed_loop_cuda(prof, gains, big_noise, big_sc,
                                     collect=collect)
        err = check_parity(tk, K.unpack_final(*blk),
                           *(plain if collect else (None, plain[1])),
                           tag=f"grid 4096x2048 collect={collect}")
        print(f"[parity] grid B={prof.shape[0]} T=2048 collect={collect}: "
              f"max |kernel - plain| = {err:.3e}")
        max_err = max(max_err, err)
    del plain, tk, blk
    print(f"[parity] all shapes agree; max |kernel - plain| = {max_err:.3e}"
          f" ({time.perf_counter() - t0:.1f} s)")

    # ---- 3. the main path at real size -------------------------------
    main_kw = dict(total_work=1e9, max_time=2048.0, dt=1.0,
                   collect_traces=False, summary_warmup=30)
    main_grid = (("gros", "dahu", "yeti"), EPS_GRID, range(3072))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES, plain_calls[0] = 0, 0
    t0 = time.perf_counter()
    res = sim.sweep(*main_grid, **main_kw)
    wall = time.perf_counter() - t0
    launches, main_plain = K.LAUNCHES, plain_calls[0]
    check(launches > 0, "main path launched no kernel")
    check(main_plain == 0, "main path called the plain version")
    n_runs = int(np.prod(res.energy.shape))
    live_steps = int(res.n_steps.astype(np.int64).sum())
    print(f"[main] sweep {res.energy.shape} = {n_runs} runs x 2048 steps "
          f"in {wall:.3f} s wall ({n_runs / wall:.0f} runs/s, "
          f"{live_steps / wall:.4g} run-steps/s); kernel launches "
          f"{launches}, plain-version calls {main_plain}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    del res

    # ---- 4. the paper's headline through sweep and simulate ----------
    K.LAUNCHES, plain_calls[0] = 0, 0
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
    check(K.LAUNCHES == 3 and plain_calls[0] == 0, "headline path")
    print(f"[headline] gros eps=0.1 vs 0: energy saving "
          f"{table[0.1]['energy_saving']:.4f}, time increase "
          f"{table[0.1]['time_increase']:.4f} (30 seeds, total_work 6000); "
          f"kernel launches {K.LAUNCHES}")

    # ---- 5. the main path's own inputs: parity, then timings --------
    prof, gains, seeds = sim.grid_rows(*main_grid)
    prof, gains, seeds = prof.to(dev), gains.to(dev), seeds.to(dev)
    draw_ms = cuda_ms(lambda: ops.draw_noise(seeds, 2048), reps=5)
    noise = ops.draw_noise(seeds, 2048)
    main_sc = (1e9, 2048.0, 1.0, 30.0)
    _, blk = K.closed_loop_cuda(prof, gains, noise, main_sc, collect=False)
    fk = K.unpack_final(*blk)
    for k, v in main_out.items():  # the sweep ran this very launch
        check(np.array_equal(fk[k].cpu().numpy().astype(v.dtype),
                             v.reshape(-1)), f"main path {k} != sweep's")
    t0 = time.perf_counter()
    plain = R.closed_loop_ref(prof, gains, noise, *main_sc, collect=False)
    err = check_parity(None, fk, None, plain[1],
                       tag=f"main path B={n_runs} T=2048 summary")
    max_err = max(max_err, err)
    print(f"[parity] main path B={n_runs} T=2048 summary: max |kernel - "
          f"plain| = {err:.3e}; phase 3's sweep equals this launch "
          f"({time.perf_counter() - t0:.1f} s)")
    del plain, fk, blk
    kern_ms = cuda_ms(lambda: K.closed_loop_cuda(prof, gains, noise,
                                                 main_sc, collect=False))
    # the parity run above was the plain version's warm-up
    plain_ms = cuda_ms(lambda: R.closed_loop_ref(prof, gains, noise,
                                                 *main_sc, collect=False),
                       reps=5, warmup=0)
    in_bytes = (prof.numel() + gains.numel()) * 4
    out_bytes = (K.N_STATE + R.PROG_BINS + R.CAP_BINS) * n_runs * 4
    bytes_main = live_steps * NOISE_BYTES_PER_STEP + in_bytes + out_bytes
    bytes_ms = bytes_main / HBM_BYTES_PER_S * 1e3
    ops_ms = live_steps * loop_instr["summary"] / ISSUE_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"[time] closed_loop kernel, main path ({n_runs} runs x 2048, "
          f"summary): {kern_ms:.4f} ms; bound {bound_ms:.4f} ms by "
          f"{bound_by} (bytes {bytes_main / 1e9:.4f} GB -> {bytes_ms:.4f} "
          f"ms; {loop_instr['summary']} instructions x {live_steps} "
          f"run-steps -> {ops_ms:.4f} ms); {bytes_main / kern_ms / 1e6:.1f}"
          f" GB/s; {100 * bound_ms / kern_ms:.1f}% of the bound")
    print(f"[time] plain version, same inputs: {plain_ms:.2f} ms "
          f"({plain_ms / kern_ms:.1f}x the kernel)")
    print(f"[time] draw_noise (T=2048, B={n_runs}): {draw_ms:.3f} ms; "
          f"sweep wall in phase 3 was {wall * 1e3:.1f} ms")
    del noise
    big_prof, big_gains = sim.grid_rows(names, EPS_GRID[:8], range(128))[:2]
    big_prof, big_gains = big_prof.to(dev), big_gains.to(dev)
    tr_ms = cuda_ms(lambda: K.closed_loop_cuda(big_prof, big_gains,
                                               big_noise, big_sc,
                                               collect=True))
    tr_steps = big_prof.shape[0] * 2048
    tr_bytes_ms = tr_steps * (NOISE_BYTES_PER_STEP + TRACE_BYTES_PER_STEP) \
        / HBM_BYTES_PER_S * 1e3
    tr_ops_ms = tr_steps * loop_instr["trace"] / ISSUE_PER_S * 1e3
    print(f"[time] closed_loop kernel, trace mode ({big_prof.shape[0]} "
          f"runs x 2048): {tr_ms:.4f} ms; bound "
          f"{max(tr_bytes_ms, tr_ops_ms):.4f} ms (bytes {tr_bytes_ms:.4f} "
          f"ms, instructions {tr_ops_ms:.4f} ms)")
    print("[time] library yardstick: none (no single PyTorch call "
          "computes this closed loop)")

    print(json.dumps({"kernels": [{
        "name": "closed_loop", "route": "cuda",
        "source": "src/repro_torch/kernels/closed_loop/csrc/closed_loop.cu",
        "replaces": "src/repro/kernels/closed_loop/kernel.py:59",
        "launches": launches, "max_abs_err": max_err, "ms": kern_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
