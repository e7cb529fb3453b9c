#!/usr/bin/env python3
"""The flash backward's head split, timed on one card over the shapes the
tensor-core route takes: starcoder2-3b's training shape
(`attention_cases.FLASH_TRAIN`: 4 x 2,048 tokens, 24 query heads over 2
KV heads, hd 128, causal) and at batch 1, qwen3-8b's widths at 8 x 1,024
tokens (`FLASH_SERVE`, 32 heads over 8), and the bf16 `FLASH_CASES`
entries whose KV heads have more than one query head.

    python3 tools/flash_bwd_variants.py

The dK / dV kernel gives a block one (128-key tile, KV head, batch, group
of query heads); `kernel.g_split` picks how many groups each KV head's G
heads are split into. For each shape every divisor of G is forced in
turn (replacing `g_split` for the call) and timed as device ms per call
of the three launches, the divisors timed in order and then in reverse
(`repro_torch.kernels.timing.device_ms`, the mean of the two), with each
launch's device time from CUDA events around it (the wrapper's
``events``), and its grads held to the plain route in float32 at
`attention_cases.bwd_readings`' bar. Then each rule "the smallest divisor
whose blocks reach n x the multiprocessors, else G" (n = 1, 2, 4) is read
against the fastest split: its pick and its time over the best. At the
training shape also: the head-TP layout (K / V repeated to every head,
G = 1) and SDPA's backward. First, ptxas's report (`-Xptxas -v`: registers,
stack and spills) of each kernel of the tensor-core route's source, built
with its own flags. Prints the card's name and power limit. Needs one
NVIDIA H100 (sm_90a) and the CUDA toolkit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

RULES = (1, 2, 4)  # blocks at least n x the multiprocessors


def per_launch(fn, reps=5) -> list:
    """Device ms of D, dK / dV and dQ in one call of ``fn(events)`` (the
    mean of ``reps`` calls)."""
    import torch
    fn(None)
    out = [0.0, 0.0, 0.0]
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        fn(ev)
        torch.cuda.synchronize()
        for i in range(3):
            out[i] += ev[i].elapsed_time(ev[i + 1]) / reps
    return out


def ptxas_report(source: Path) -> None:
    """ptxas's registers, stack and spills of each kernel in ``source``,
    built with `_build.flags` and `-Xptxas -v` into a scratch library."""
    import re
    import tempfile
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        out = subprocess.run([_build.nvcc_path(), *_build.flags(source),
                              "-Xptxas", "-v", "-o", f"{tmp}/report.so",
                              str(source)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{out.stderr}")
    kernel = None
    for line in out.stderr.splitlines():
        m = re.search(r"Function properties for \S*?(flash_bwd_\w+?_kernel)"
                      r"(ILi(\d+)E)?", line)
        if m:
            kernel = m.group(1) + (f"<{m.group(3)}>" if m.group(3) else "")
        elif kernel and ("spill" in line or "registers" in line):
            print(f"[bwd] ptxas {kernel}: "
                  f"{line.split('ptxas info    :')[-1].strip()}")


def rule_pick(blocks: int, G: int, n: int, n_sm: int) -> int:
    for d in range(1, G + 1):
        if G % d == 0 and blocks * d >= n * n_sm:
            return d
    return G


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.timing import device_ms, in_turns

    ptxas_report(FK.BWD_WGMMA_SOURCE)
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    real_split = FK.g_split
    shapes = [AC.FLASH_TRAIN, (1,) + AC.FLASH_TRAIN[1:], AC.FLASH_SERVE] + [
        c for c in AC.FLASH_CASES
        if c[-1] == "bfloat16" and c[2] > c[3]
        and FK.bwd_route(torch.bfloat16, c[4]) == "wgmma"]
    over = {n: [] for n in RULES + ("shipped",)}
    for case in shapes:
        B, S, H, K, hd, causal, window = case[:7]
        G = H // K
        q, k, v = AC.flash_inputs(case, dev)
        g = AC.grad_output(q)
        lse = torch.empty((B, H, S), device=dev)
        o = FK.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    lse=lse)
        blocks = B * K * -(-S // FK.BWD_TILE)

        def split(d, kk=k, vv=v):
            def run(events=None):
                FK.g_split = lambda *a: d
                try:
                    return FK.flash_attention_bwd_cuda(
                        q, kk, vv, o, lse, g, causal=causal, window=window,
                        events=events)
                finally:
                    FK.g_split = real_split
            return run

        divs = [d for d in range(1, G + 1) if G % d == 0]
        ms = {d: 0.0 for d in divs}
        for order in (divs, divs[::-1]):
            for d in order:
                ms[d] += device_ms(split(d)) / 2
        best = min(divs, key=ms.get)
        shipped = real_split(B, K, S, G, n_sm)
        print(f"[bwd] {case}: G {G}, {blocks} dK / dV blocks unsplit, "
              f"fastest split {best} ({ms[best]:.4f} ms), shipped "
              f"g_split {shipped} ({ms[shipped]:.4f} ms)")
        for d in divs:
            errs, _, bars = AC.bwd_readings(q, k, v, g, split(d)(),
                                            causal=causal, window=window)
            launches = per_launch(split(d))
            print(f"[bwd]   head split {d:2d} ({blocks * d} blocks): "
                  f"{ms[d]:.4f} ms a call (D {launches[0]:.4f}, dK / dV "
                  f"{launches[1]:.4f}, dQ {launches[2]:.4f} ms); rel L2 "
                  + ", ".join(f"d{n} {e:.3e}" for n, e in zip("qkv", errs))
                  + f" (bars {', '.join(f'{b:.3e}' for b in bars)})")
        for n in RULES:
            d = rule_pick(blocks, G, n, n_sm)
            over[n].append(ms[d] / ms[best])
            print(f"[bwd]   rule blocks >= {n} x {n_sm}: split {d}, "
                  f"{ms[d] / ms[best]:.3f} x the fastest")
        over["shipped"].append(ms[shipped] / ms[best])
        if case == AC.FLASH_TRAIN:
            kr, vr = (x.repeat_interleave(G, dim=2).contiguous()
                      for x in (k, v))
            qt = [x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v)]
            ot = F.scaled_dot_product_attention(*qt, is_causal=True,
                                                enable_gqa=True)
            gt = g.transpose(1, 2).contiguous()
            g1, lib = in_turns(split(1, kr, vr), lambda: torch.autograd.grad(
                ot, qt, gt, retain_graph=True))
            launches = per_launch(split(1, kr, vr))
            print(f"[bwd]   K / V repeated to every head (G = 1, "
                  f"{B * H * (S // FK.BWD_TILE)} blocks, no split): "
                  f"{g1:.4f} ms (D {launches[0]:.4f}, dK / dV "
                  f"{launches[1]:.4f}, dQ {launches[2]:.4f} ms); SDPA's "
                  f"backward {lib:.4f} ms in the same turns")
            del kr, vr, qt, ot, gt
        del q, k, v, g, lse, o
        torch.cuda.empty_cache()
    for n, r in over.items():
        name = "shipped g_split" if n == "shipped" else \
            f"rule blocks >= {n} x {n_sm}"
        print(f"[bwd] {name}: worst {max(r):.3f} x the fastest split, "
              f"mean {sum(r) / len(r):.3f} x over {len(r)} shapes")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[bwd] {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
