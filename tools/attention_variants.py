#!/usr/bin/env python3
"""Design variants of the two attention kernels, timed on one card beside
`scaled_dot_product_attention` at the qwen3-8b serving shapes.

    python3 tools/attention_variants.py

Each variant is the shipped CUDA source with one design choice undone by
a text edit (fewer ring stages, no pingpong between the flash kernel's
consumer warpgroups, the decode kernel's launch bounds or combine launch,
...), built with the source's own flags into `build/variants/`, and
swapped in for the shipped library. Every variant is timed as device time
per call (`repro_torch.kernels.timing.in_turns`: variant, SDPA, SDPA,
variant) and, where it still computes the function, held to the plain
version. The decode kernels are also timed at other splits of the cache.
Prints one line per variant and the card's name and power limit. Needs
one NVIDIA H100 (sm_90a) and the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"

# (name, [(text in the shipped source, replacement)], still exact?)
FLASH = [
    ("shipped: 3 stages, pingpong", [], True),
    ("2 K/V stages", [(
        "constexpr int kStages = 3;              // K / V ring depth",
        "constexpr int kStages = 2;              // K / V ring depth")], True),
    ("no pingpong turns", [
        ("    auto take_turn = [&]() { named_sync(1 + wg); };",
         "    auto take_turn = [&]() {};"),
        ("""    auto pass_turn = [&]() {
      if (wg == 0 || ++turn < n_turns) named_arrive(2 - wg);
    };
    if (wg == 1 && n_turns > 0) named_arrive(1);""",
         "    auto pass_turn = [&]() { (void)turn; };")], True),
    ("no softmax (products and loads only)", [(
        """      online_softmax(s, m_i, l_i, corr, edge, r0, t0, cq, causal, window,
                     Tk, sl2, neg_raw);""",
        "      corr[0] = corr[1] = l_i[0] = l_i[1] = 1.f;\n"
        "      (void)edge;")], False),
]
DECODE = [
    ("shipped: 3 stages, bounds for 3 blocks/SM, combine by PDL", [], True),
    ("2 stages", [("constexpr int kStages = 3;    // ring depth",
                   "constexpr int kStages = 2;    // ring depth")], True),
    ("4 stages", [("constexpr int kStages = 3;    // ring depth",
                   "constexpr int kStages = 4;    // ring depth")], True),
    ("bounds for 4 blocks/SM (spills)", [(
        "template <int HDP>\n__global__ void __launch_bounds__(kThreads, 3)",
        "template <int HDP>\n__global__ void __launch_bounds__(kThreads, 4)")],
     True),
    ("combine as a plain launch", [("  cfg.numAttrs = 1;\n",
                                    "  cfg.numAttrs = 0;\n")], True),
    ("no combine (partials only)", [("""  if (err == cudaSuccess)
    err = bf16 ? launch_combine<__nv_bfloat16>(m, l, acc, o, B, H, hd,
                                               n_split, st)
               : launch_combine<float>(m, l, acc, o, B, H, hd, n_split, st);
""", "")], False),
]
CHUNKS = (128, 192, 288, 352)


def build_variant(source: Path, tag: str, edits) -> Path:
    from repro_torch.kernels import _build
    text = source.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{source.name}: variant {tag!r} does not "
                               f"apply (the source changed)")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{source.stem}-{tag}.cu"
    src.write_text(text)
    lib = OUT / f"{source.stem}-{tag}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.flags(source), "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.kernels.decode_attention import ref as DR
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.timing import in_turns

    dev = torch.device("cuda")
    jobs = [(FK.WGMMA_SOURCE, f"f{i}", v) for i, v in enumerate(FLASH)] + \
        [(DK.SOURCE, f"d{i}", v) for i, v in enumerate(DECODE)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: build_variant(j[0], j[1], j[2][1]),
                             jobs))

    q, k, v = AC.flash_inputs(AC.FLASH_SERVE, dev)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    want = FR.attention_ref(q, k, v)

    def sdpa():
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)

    B, T, H, K, hd, pos = AC.DECODE_SERVE[:6]
    sets = [AC.decode_inputs(AC.DECODE_SERVE, dev, seed=i) for i in range(4)]
    lib_sets = itertools.cycle([
        (qq[:, :, None], kk.transpose(1, 2).contiguous(),
         vv.transpose(1, 2).contiguous()) for qq, kk, vv, _, _, _ in sets])

    def decode_sdpa():
        qq, kk, vv = next(lib_sets)
        F.scaled_dot_product_attention(qq, kk, vv, enable_gqa=True)

    def decode_at(chunk):
        ring = itertools.cycle(sets)

        def call():
            qq, kk, vv, kp, _, _ = next(ring)
            DK.decode_attention_cuda(qq, kk, vv, kp, pos, chunk)
        return call

    q0, k0, v0, kp0 = sets[0][:4]
    default = DK.default_chunk(B, K, T)
    for (source, tag, (name, _, exact)), lib in zip(jobs, libs):
        _build._LOADED[source] = ctypes.CDLL(str(lib))
        note = "" if exact else " (not the function)"
        if source == FK.WGMMA_SOURCE:
            got = FK.flash_attention_cuda(q, k, v)
            err = float((got.float() - want.float()).abs().max())
            ms, lib_ms = in_turns(lambda: FK.flash_attention_cuda(q, k, v),
                                  sdpa)
            print(f"[flash {AC.FLASH_SERVE[:5]}] {name}: {ms:.4f} ms, SDPA "
                  f"{lib_ms:.4f} ms, ratio {ms / lib_ms:.3f}; max |kernel - "
                  f"plain| {err:.3e}{note}")
            continue
        # the shipped decode kernels at other splits too
        chunks = [default] + ([c for c in CHUNKS if c != default]
                              if tag == "d0" else [])
        for chunk in chunks:
            got = DK.decode_attention_cuda(q0, k0, v0, kp0, pos, chunk)[0]
            want_d = DO.combine(*DR.decode_partials_ref(q0, k0, v0, kp0, pos,
                                                        chunk), q0.dtype)
            err = float((got.float() - want_d.float()).abs().max())
            ms, lib_ms = in_turns(decode_at(chunk), decode_sdpa, reps=40,
                                  warmup=4)
            print(f"[decode {AC.DECODE_SERVE[:5]}] {name}, {-(-T // chunk)} "
                  f"splits of {chunk}: {ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
                  f"ratio {ms / lib_ms:.3f}; max |kernels - plain| "
                  f"{err:.3e}{note}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi: not available")
    return 0


if __name__ == "__main__":
    sys.exit(main())
