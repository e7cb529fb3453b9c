#!/usr/bin/env python3
"""Design variants of the float32 flash backward (split TF32,
``csrc/flash_attention_bwd_tf32.cu``), built from the committed source
by text substitution and timed in turns on one card at starcoder2-3b's
training shape (`attention_cases.FLASH_TRAIN_F32`: 4 x 2,048 tokens, 24
query heads over 2 KV heads, hd 128, causal) and at qwen3-8b's widths
(`FLASH_SERVE_F32`: 8 x 1,024, 32 over 8).

    python3 tools/flash_tf32_variants.py

Variants:
  committed    the source as it is: each tile's dV, dK or dQ product
               summed on the tensor cores from zero and added to the
               float32 grads in registers, 64 columns at a time (ptxas
               spills a few bytes in dK / dV at hd 128: its report is
               printed);
  chunk32      the same with 32 columns at a time for dK / dV at hd 128,
               which spills nothing;
  unpromoted   the grads carried in the wgmma accumulators themselves
               across every tile, as the bf16 route does.
Then the forward (``csrc/flash_attention_tf32.cu``, whose O stays in the
wgmma accumulator across every key tile) at growing lengths, 1 x S
tokens, 8 query heads over 2 KV heads, hd 128, causal, S = 1,024 to
16,384: its largest error against the plain version and the 2e-5 bar's
use (max |kernel - plain| / (2e-5 + 2e-5 |plain|)).
Each variant is built with the committed source's flags (`_build.flags`)
under ``build/tf32_variants/``, timed as device ms per call of the three
launches (`repro_torch.kernels.timing.device_ms`, in the order committed,
chunk32, unpromoted, then reversed, the mean of the two), with each
launch's device time from the wrapper's CUDA events, and its grads read
against the plain route in float32 as `attention_cases.bwd_readings`
reads them (max |kernel - plain| / max |plain|, bar 1e-4). Prints the
card's name and power limit. Needs one NVIDIA H100 (sm_90a) and the CUDA
toolkit.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "tf32_variants"
CHUNK = "constexpr int CH = HDP < 64 ? HDP : 64;"
UNPROMOTED = '''template <int HDP, int CH>
__device__ __forceinline__ void add_product(float (&acc)[HDP / 2],
                                            const uint32_t (&fh)[kTile / 8][4],
                                            const uint32_t (&fl)[kTile / 8][4],
                                            uint32_t w_hi, uint32_t w_lo) {
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    wgmma_rs(acc, fh[kk], sw128_desc(w_lo + kk * 32), 1);
    wgmma_rs(acc, fl[kk], sw128_desc(w_hi + kk * 32), 1);
  }
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk)
    wgmma_rs(acc, fh[kk], sw128_desc(w_hi + kk * 32), 1);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
}
'''


def variants(source: str) -> dict:
    """{name: source text}."""
    check = source.count(CHUNK) == 1
    start = source.index("template <int HDP, int CH>\n__device__ "
                         "__forceinline__ void add_product(")
    end = source.index("\n}\n", start) + 3
    if not check:
        raise RuntimeError("the chunk rule is not in the source as expected")
    return {
        "committed": source,
        "chunk32": source.replace(CHUNK, "constexpr int CH = HDP < 64 ? HDP "
                                         ": (DKDV && HDP == 128 ? 32 : 64);"),
        "unpromoted": source[:start] + UNPROMOTED + source[end:],
    }


def ptxas_spills(path: Path, name: str) -> None:
    """ptxas's registers and spills of the dK / dV and dQ instances at hd
    128 of the variant at ``path``."""
    from repro_torch.kernels import _build
    out = subprocess.run([_build.nvcc_path(), *_build.flags(path), "-Xptxas",
                          "-v", "-o", str(path.with_suffix(".report.so")),
                          str(path)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{out.stderr}")
    kernel = None
    for line in out.stderr.splitlines():
        m = re.search(r"Function properties for \S*?flash_bwd_tf32_kernel"
                      r"ILi128ELb(\d)E", line)
        if m:
            kernel = "dK / dV" if m.group(1) == "1" else "dQ"
        elif "Function properties" in line:
            kernel = None
        elif kernel and ("spill" in line or "registers" in line):
            print(f"[tf32] {name} ptxas {kernel} hd 128: "
                  f"{line.split('ptxas info    :')[-1].strip()}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_tf32_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.timing import device_ms

    committed = FK.BWD_TF32_SOURCE
    paths = {}
    for name, text in variants(committed.read_text()).items():
        path = OUT / name / committed.name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        paths[name] = path
        ptxas_spills(path, name)
    dev = torch.device("cuda")
    order = list(paths)
    try:
        for case in (AC.FLASH_TRAIN_F32, AC.FLASH_SERVE_F32):
            B, S, H, K, hd, causal, window, _ = case
            q, k, v = AC.flash_inputs(case, dev)
            g = AC.grad_output(q, seed=5)
            lse = torch.empty((B, H, S), device=dev)
            o = FK.flash_attention_cuda(q, k, v, lse=lse)

            def call(events=None):
                return FK.flash_attention_bwd_cuda(q, k, v, o, lse, g,
                                                   events=events)

            times = {n: [] for n in order}
            for name in order + order[::-1]:
                FK.BWD_TF32_SOURCE = paths[name]
                times[name].append(device_ms(call, reps=5, warmup=1))
            for name in order:
                FK.BWD_TF32_SOURCE = paths[name]
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                got = call(ev)
                torch.cuda.synchronize()
                parts = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
                errs, _, bars = AC.bwd_readings(q, k, v, g, got)
                ms = sum(times[name]) / 2
                print(f"[tf32] {case} {name}: {ms:.4f} ms a call (turns "
                      + " / ".join(f"{t:.4f}" for t in times[name])
                      + "; D {:.4f}, dK / dV {:.4f}, dQ {:.4f} by events); "
                      .format(*parts)
                      + "max |kernel - plain| / max |plain|: "
                      + ", ".join(f"d{n} {e:.3e}" for n, e in zip("qkv",
                                                                  errs))
                      + f" (bar {bars[0]:.0e}, "
                      + ("held" if max(errs) <= bars[0] else "OVER") + ")")
            del q, k, v, g, lse, o
            torch.cuda.empty_cache()
    finally:
        FK.BWD_TF32_SOURCE = committed
    from repro_torch.kernels.flash_attention import ref as FR
    for S in (1024, 4096, 16384):
        case = (1, S, 8, 2, 128, True, None, "float32")
        q, k, v = AC.flash_inputs(case, dev)
        got = FK.flash_attention_cuda(q, k, v)
        want = FR.attention_ref(q, k, v)
        err = (got - want).abs()
        use = float((err / (2e-5 + 2e-5 * want.abs())).max())
        print(f"[tf32] forward {case}: max |kernel - plain| "
              f"{float(err.max()):.3e}, {use:.3f} of the 2e-5 bar")
        del q, k, v, got, want, err
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[tf32] card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
