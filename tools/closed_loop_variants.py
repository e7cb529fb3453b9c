#!/usr/bin/env python3
"""Design variants of the closed-loop kernel, timed on one card on the main
path's grid (gros/dahu/yeti x 11 epsilons x 3,072 seeds: 101,376 runs x
2,048 steps, summary mode).

    python3 tools/closed_loop_variants.py [--parent PATH/closed_loop.cu]

Each variant is the shipped CUDA source with one design choice undone by a
text edit (libdevice's cosf in place of the written-out cosine; 32-bit
histogram counters, which leave 4 blocks of 128 resident per SM and so put
the grid in 1.5 waves), built with the source's own flags into
`build/variants/` and swapped in for the shipped library. For each, the
seeds route's summary loop is read in the SASS (instructions on the
shortest pass, its memory instructions), the instance's resources are
queried, its outputs are compared with the shipped kernel's (runs
bit-equal), and both noise routes are timed with CUDA events in turns with
the shipped kernel (shipped, variant, variant, shipped). ``--parent``
names the closed-loop source of an earlier checkout whose C entry point
takes the noise tensor only (64-run blocks, float32 bins: the layout
before the seeds route), timed the same way on the tensor route. Prints
one line per reading and the card's name and power limit. Needs one
NVIDIA H100 (sm_90a) and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"

# (name, [(text in the shipped source, replacement)], counter bits)
VARIANTS = [
    ("libdevice cosf in the Box-Muller", [(
        "return sqrtf(-2.0f * logf(1.0f - u)) * cos_small(kTwoPi * u2);",
        "return sqrtf(-2.0f * logf(1.0f - u)) * cosf(kTwoPi * u2);")], 16),
    ("32-bit counters (4 blocks per SM, 1.5 waves)", [(
        "  const void* fn = pick(bf16, seeds != nullptr, collect, bin_bits);"
        "\n  const int smem = hist_bytes(bin_bits);",
        "  bin_bits = 32;\n"
        "  const void* fn = pick(bf16, seeds != nullptr, collect, bin_bits);"
        "\n  const int smem = hist_bytes(bin_bits);")], 32),
]
# the float32 seeds-route summary instance with ``bits``-bit counters
SEEDS_SUMMARY = "closed_loop_kernelIfLb1ELb0ELi{bits}E"


def build(source: Path, tag: str, edits) -> Path:
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


def turns(shipped, variant):
    """(shipped ms, variant ms), each the mean of two readings taken
    shipped, variant, variant, shipped."""
    s1, v1, v2, s2 = (cuda_ms(f) for f in (shipped, variant, variant,
                                          shipped))
    return (s1 + s2) / 2, (v1 + v2) / 2


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("closed_loop_variants: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="closed_loop.cu of an earlier checkout (noise "
                         "tensor only)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import sim
    from repro_torch.kernels import _build, sass
    from repro_torch.kernels.closed_loop import kernel as K
    from repro_torch.kernels.closed_loop import ops

    dev = torch.device("cuda")
    grid = (("gros", "dahu", "yeti"), [round(0.05 * i, 2) for i in range(11)],
            range(3072))
    prof, gains, seeds = (x.to(dev) for x in sim.grid_rows(*grid))
    B, T, sc = prof.shape[0], 2048, (1e9, 2048.0, 1.0, 30.0)
    noise = ops.draw_noise(seeds, T)

    def seeds_route():
        return K.closed_loop_seeds_cuda(prof, gains, seeds, T, sc, False)[1]

    def tensor_route():
        return K.closed_loop_cuda(prof, gains, noise, sc, False)[1]

    shipped_lib = _build.build(K.SOURCE)
    shipped = ctypes.CDLL(str(shipped_lib))
    want = seeds_route()

    def use(lib):
        _build._LOADED[K.SOURCE] = lib

    def equal_runs(a, b):
        same = torch.ones(B, dtype=torch.bool, device=dev)
        for x, y in zip(a, b):
            same &= (x == y).all(0)
        return int(same.sum())

    def describe(name, lib_path, bits):
        instrs = sass.kernel_instructions(lib_path,
                                          SEEDS_SUMMARY.format(bits=bits))
        body = sass.opcodes(sass.loop_body(instrs))
        mem = {op: n for op, n in body.items() if op.startswith(("LD", "ST"))}
        res = K.resources(torch.float32, True, False, bits, dev)
        print(f"[{name}] seeds summary loop: "
              f"{sass.loop_instructions(instrs)} instructions on the "
              f"shortest pass, memory instructions {mem}; {res}")

    describe("shipped", shipped_lib, K.bin_bits(T))
    print(f"[shipped] written-out cosine against cosf at the 2^24 generator "
          f"arguments: {K.cos_mismatches(dev)} differ")
    for i, (name, edits, bits) in enumerate(VARIANTS):
        lib_path = build(K.SOURCE, f"v{i}", edits)
        variant = ctypes.CDLL(str(lib_path))
        use(variant)
        describe(name, lib_path, bits)
        same = equal_runs(seeds_route(), want)
        for route, call in (("seeds", seeds_route), ("tensor", tensor_route)):
            def as_(lib, fn=call):
                def run():
                    use(lib)
                    fn()
                return run
            ms_s, ms_v = turns(as_(shipped), as_(variant))
            print(f"[{name}] {route} route: {ms_v:.4f} ms against the "
                  f"shipped {ms_s:.4f} ms (in turns)")
        print(f"[{name}] seeds route runs bit-equal to the shipped kernel: "
              f"{same}/{B}")
        use(shipped)

    if args.parent is not None:
        parent = ctypes.CDLL(str(_build.build(args.parent.resolve())))
        fn = parent.closed_loop_launch
        p_, f_, i_ = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        fn.argtypes = [p_, p_, i_, p_, f_, f_, f_, f_, i_, i_, i_, p_, p_,
                       p_, p_, i_, p_]
        fn.restype = i_
        out = (torch.empty((K.N_STATE, B), device=dev),
               torch.empty((64, B), device=dev),
               torch.empty((32, B), device=dev))

        def parent_route():
            err = fn(prof.data_ptr(), gains.data_ptr(), 0, noise.data_ptr(),
                     *sc, T, B, 0, *(x.data_ptr() for x in out), None,
                     dev.index or 0, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"parent kernel: CUDA error {err}")

        parent_route()
        torch.cuda.synchronize()
        same = equal_runs(out, tensor_route())
        ms_s, ms_p = turns(tensor_route, parent_route)
        print(f"[parent {args.parent}] tensor route: {ms_p:.4f} ms against "
              f"the shipped {ms_s:.4f} ms (in turns); runs bit-equal to the "
              f"shipped tensor route {same}/{B}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi: not available")
    return 0


if __name__ == "__main__":
    sys.exit(main())
