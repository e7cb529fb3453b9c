#!/usr/bin/env python3
"""The selective-scan kernel against design variants of itself and against
an earlier checkout's kernel, timed in turns on one card at jamba's
serving shapes: prefill (`cases.SCAN_SERVE`, 8 x 1,024 x 8,192 x 16,
float32) and one decode step from a state (`cases.SCAN_STEP`).

    python3 tools/scan_variants.py [--parent PATH/selective_scan.cu]

Each variant is the shipped CUDA source with one design choice undone by a
text edit, built with the source's own flags into `build/variants/`:
libdevice's accurate expf of dt * A in place of ex2.approx of dt * (A
log2e); separate multiplies and adds in place of the two fmaf a
state-step; and, in place of the sequence instance's one thread a
channel (2 blocks of up to 128 registers an SM, 16 warps), a channel's 16
states split over 2 lanes of 8 (4 blocks of 64 registers, 32 warps) or 4
lanes of 4 (6 blocks of 40 registers, 48 warps), with y summed over the
lanes by shuffles each step: `LANE_SPLIT_SEQ`, which this script carries
and puts in place of the shipped sequence instance.
``--parent`` names the selective-scan source of an earlier checkout with
the same C entry point (unpack one with ``git archive`` into
`build/parent`). For each kernel the script prints the resources of its
float32 d_state-16 instances (where the library can report them), the
SASS of their step loops (instructions on the shortest pass, MUFU.EX2,
local memory), the largest error against the plain version at the two
shapes and at `cases.SCAN_LONG` as a share of the bar, and its time in
turns with the shipped kernel (shipped, other, other, shipped), as
device time per call (`kernels.timing.device_ms`): the prefill, the
decode step with
eight input sets in turn (78 MB, so each call finds its state cold in
the 50 MB L2, as a decode layer does) and with one set (warm); and the
step at a width that moves nothing, the fixed cost of a launch. Prints
the card's name and power limit. Needs one NVIDIA H100 (sm_90a) and the CUDA
toolkit.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import subprocess
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"
HBM_BYTES_PER_S = 3.35e12

# (name, [(text in the shipped source, replacement)])
VARIANTS = [
    ("libdevice expf", [
        ("constexpr float kLog2e = 1.4426950408889634f;",
         "constexpr float kLog2e = 1.0f;"),
        ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(u));',
         "r = expf(u);")]),
    ("no fmaf", [
        ("h[k] = fmaf(ex2(dv * a2[k]), h[k], dx * bq[k]);\n"
         "    acc = fmaf(h[k], cq[k], acc);",
         "h[k] = ex2(dv * a2[k]) * h[k] + dx * bq[k];\n"
         "    acc = acc + h[k] * cq[k];")]),
    ("2 lanes x 8 states (4 blocks per SM, 64 registers)", ("lanes", 2, 4)),
    ("4 lanes x 4 states (6 blocks per SM, 40 registers)", ("lanes", 4, 6)),
]

# The sequence instance with a channel's states split over LANES lanes (at
# N = 16; N / 4 lanes below), each lane K states, a block kThreads / kLanes
# channels, a tile kSteps * kLanes steps (the shipped tile's channel-steps),
# y summed over a channel's lanes each step and stored by its first lane.
LANE_SPLIT_SEQ = r"""template <typename T, int NP, bool GENERIC>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
    selective_scan_seq_kernel(const T* __restrict__ x,
                              const T* __restrict__ dt,
                              const float* __restrict__ A,
                              const float* __restrict__ Bc,
                              const float* __restrict__ Cc,
                              const float* __restrict__ D,
                              const float* __restrict__ h0,
                              T* __restrict__ y, float* __restrict__ h_last,
                              int S, int d, int N) {
  constexpr int kLanes = NP / 4 < LANES ? NP / 4 : LANES;
  constexpr int K = NP / kLanes, kChannels = kThreads / kLanes;
  constexpr int kTileSteps = kSteps * kLanes;
  __shared__ __align__(16) T xs[kStages][kTileSteps][kChannels];
  __shared__ __align__(16) T dts[kStages][kTileSteps][kChannels];
  __shared__ __align__(16) float bs[kStages][kTileSteps * NP];
  __shared__ __align__(16) float cs[kStages][kTileSteps * NP];

  const int tid = threadIdx.x, lane = tid % kLanes, ch = tid / kLanes;
  const int c0 = blockIdx.x * kChannels, c = c0 + ch;
  const bool live = c < d;
  const int n0 = lane * K;
  const size_t row0 = (size_t)blockIdx.y * S;
  const int tiles = (S + kTileSteps - 1) / kTileSteps;

  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kRow = kChannels / kPer;
  constexpr int kXD = kTileSteps * kRow;
  constexpr int kBC = kTileSteps * NP / 4;
  static_assert(GENERIC || ((2 * kXD) % kThreads == 0 &&
                            kThreads % kXD == 0 && 2 * kBC <= kThreads),
                "a tile's copies do not divide among the threads");
  const int crow = (tid % kXD) / kRow, ccol = (tid % kXD) % kRow * kPer;
  const bool c_in = c0 + ccol < d;
  const int cb = (tid % kBC) * 4;

  auto stage = [&](int t) {
    const int slot = t % kStages;
    const int s0 = t * kTileSteps, n = min(kTileSteps, S - s0);
    if (!GENERIC) {
      const size_t off = (row0 + s0 + crow) * d + c0 + ccol;
#pragma unroll
      for (int k = 0; k < 2 * kXD / kThreads; ++k) {
        const bool is_dt = tid + k * kThreads >= kXD;
        T* dst = is_dt ? &dts[slot][crow][ccol] : &xs[slot][crow][ccol];
        if (crow >= n)
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        else if (c_in)
          cp_async16(dst, (is_dt ? dt : x) + off);
      }
      if (tid < 2 * kBC) {
        const bool is_c = tid >= kBC;
        float* dst = (is_c ? cs[slot] : bs[slot]) + cb;
        if (cb >= n * NP)
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        else
          cp_async16(dst, (is_c ? Cc : Bc) + (row0 + s0) * NP + cb);
      }
    } else {
      for (int i = tid; i < kTileSteps * kChannels; i += kThreads) {
        const int r = i / kChannels, q = i % kChannels;
        const size_t off = (row0 + s0 + r) * d + c0 + q;
        const bool in = r < n && c0 + q < d;
        xs[slot][r][q] = in ? x[off] : T(0.f);
        dts[slot][r][q] = in ? dt[off] : T(0.f);
      }
      for (int i = tid; i < kTileSteps * N; i += kThreads) {
        const bool in = i < n * N;
        bs[slot][i] = in ? Bc[(row0 + s0) * N + i] : 0.f;
        cs[slot][i] = in ? Cc[(row0 + s0) * N + i] : 0.f;
      }
    }
  };

  float a2[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool on = live && (!GENERIC || n0 + k < N);
    a2[k] = on ? A[(size_t)c * N + n0 + k] * kLog2e : 0.f;
    h[k] = (on && h0 != nullptr)
               ? h0[((size_t)blockIdx.y * d + c) * N + n0 + k] : 0.f;
  }
  const float dskip = live ? D[c] : 0.f;

  T* yq = y + row0 * d + c;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < tiles) stage(t + kStages - 1);
    cp_async_commit();
    const int slot = t % kStages;
    const int n = min(kTileSteps, S - t * kTileSteps);
#pragma unroll 4
    for (int r = 0; r < kTileSteps; ++r) {
      const float xv = to_f(xs[slot][r][ch]), dv = to_f(dts[slot][r][ch]);
      float bq[K], cq[K];
      if (!GENERIC) {
        load_vec(bq, &bs[slot][r * NP + n0]);
        load_vec(cq, &cs[slot][r * NP + n0]);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          bq[k] = n0 + k < N ? bs[slot][r * N + n0 + k] : 0.f;
          cq[k] = n0 + k < N ? cs[slot][r * N + n0 + k] : 0.f;
        }
      }
      const float acc =
          group_sum<kLanes>(step_states(h, a2, dv, dv * xv, bq, cq));
      if (live && lane == 0 && r < n)
        store(yq + (size_t)r * d, acc + xv * dskip);
    }
    yq += (size_t)kTileSteps * d;
  }
  cp_async_wait<0>();

  if (live) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (!GENERIC || n0 + k < N)
        h_last[((size_t)blockIdx.y * d + c) * N + n0 + k] = h[k];
  }
}

"""
SEQ_START = ("template <typename T, int NP, bool GENERIC>\n"
             "__global__ void __launch_bounds__(kThreads, kSeqBlocks)")
SEQ_END = "// One step from h0"


def lane_split(text: str, lanes: int, min_blocks: int):
    """The edits that put `LANE_SPLIT_SEQ` at ``lanes`` lanes a channel in
    place of the sequence instance of the source ``text``, and size its
    grid and its reported channels a block to match."""
    if SEQ_START not in text or SEQ_END not in text:
        return [(SEQ_START, "")]   # reported by `build` as not applying
    start = text.index(SEQ_START)
    lanes_of = f"(16 / 4 < {lanes} ? 16 / 4 : {lanes})"
    return [
        (text[start:text.index(SEQ_END)],
         LANE_SPLIT_SEQ.replace("MIN_BLOCKS", str(min_blocks))
         .replace("LANES", str(lanes))),
        ("    const dim3 grid((d + kThreads - 1) / kThreads, B);\n"
         "    selective_scan_seq_kernel",
         f"    constexpr int kC = kThreads / (NP / 4 < {lanes} ? NP / 4 : "
         f"{lanes});\n"
         "    const dim3 grid((d + kC - 1) / kC, B);\n"
         "    selective_scan_seq_kernel"),
        ("  out[4] = seq ? kThreads :",
         f"  out[4] = seq ? kThreads / {lanes_of} :"),
    ]
# the float32 instances at d_state 16 (the serving path's)
SEQ = "selective_scan_seq_kernelIfLi16ELb0E"
STEP = "selective_scan_step_kernelIfLi16ELb0E"
PARENT = "selective_scan_kernelIfLi16ELb0E"


def build(source: Path, tag: str, edits) -> Path:
    from repro_torch.kernels import _build
    text = source.read_text()
    if isinstance(edits, tuple):   # ("lanes", lanes, blocks an SM)
        edits = lane_split(text, *edits[1:])
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


class Kernel:
    """One built selective-scan library, called through its C entry."""

    def __init__(self, name: str, path: Path):
        self.name, self.path = name, path
        self.lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = self.lib.selective_scan_launch
        # the last argument, where the template taken is reported, is null
        # here (an earlier source without it ignores it)
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p, p, i, p, p]
        fn.restype = i
        self.fn = fn

    def __call__(self, x, dt, A, Bc, Cc, D, h0, y, h_last):
        import torch
        B, S, d = x.shape
        err = self.fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                      Bc.data_ptr(), Cc.data_ptr(), D.data_ptr(),
                      None if h0 is None else h0.data_ptr(),
                      int(x.dtype == torch.bfloat16), B, S, d, A.shape[1],
                      y.data_ptr(), h_last.data_ptr(), x.device.index or 0,
                      torch.cuda.current_stream().cuda_stream, None)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err}")

    def resources(self, seq: bool):
        if not hasattr(self.lib, "selective_scan_resources"):
            return None
        out = (ctypes.c_int * 5)()
        if self.lib.selective_scan_resources(int(seq), 0, out):
            return None
        return dict(zip(("registers", "local_bytes", "shared_bytes",
                         "blocks_per_sm", "channels_per_block"), out))


def turns(timer, shipped, other):
    """(shipped ms, other ms), each the mean of two readings taken
    shipped, other, other, shipped."""
    s1, o1, o2, s2 = (timer(f) for f in (shipped, other, other, shipped))
    return (s1 + s2) / 2, (o1 + o2) / 2


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="selective_scan.cu of an earlier checkout")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, sass
    from repro_torch.kernels.selective_scan import cases as SC
    from repro_torch.kernels.selective_scan import kernel as SK
    from repro_torch.kernels.selective_scan import ref as SR
    from repro_torch.kernels.timing import device_ms

    dev = torch.device("cuda")
    shipped = Kernel("shipped", _build.build(SK.SOURCE))
    others = [Kernel(name, build(SK.SOURCE, f"v{i}", edits))
              for i, (name, edits) in enumerate(VARIANTS)]
    if args.parent is not None:
        others.append(Kernel(f"parent {args.parent}",
                             _build.build(args.parent.resolve())))

    def inputs(case, seed=0, with_h0=False):
        x, dt, A, Bc, Cc, D, h0 = SC.scan_inputs(case, dev, seed, with_h0)
        B, S, d, N = case[:4]
        outs = (torch.empty_like(x), torch.empty((B, d, N), device=dev))
        return (x, dt, A, Bc, Cc, D, h0) + outs

    serve = inputs(SC.SCAN_SERVE)
    steps = [inputs(SC.SCAN_STEP, seed=i, with_h0=True) for i in range(8)]
    step_bytes = sum(t.numel() * t.element_size() for t in steps[0]
                     if t is not None)
    serve_bytes = sum(t.numel() * t.element_size() for t in serve
                      if t is not None)
    refs = {}
    for case, args_ in ((SC.SCAN_SERVE, serve), (SC.SCAN_STEP, steps[0]),
                        (SC.SCAN_LONG, inputs(SC.SCAN_LONG))):
        refs[case] = (args_, SR.selective_scan_ref(*args_[:7]))

    def describe(k: Kernel):
        line = []
        for part, seq in ((SEQ, True), (STEP, False)):
            try:
                instrs = sass.kernel_instructions(k.path, part)
            except ValueError:
                continue
            ops = sass.opcodes(instrs)
            if seq:  # the innermost loop holding the exps
                body = sass.opcodes(sass.loop_body(instrs, "MUFU.EX2"))
                count = (f"{sass.loop_instructions(instrs, 'MUFU.EX2')} "
                         f"instructions a pass of the innermost loop of "
                         f"exps (shortest), {body.get('MUFU.EX2', 0)} "
                         f"MUFU.EX2")
            else:
                count = (f"{len(instrs)} instructions, "
                         f"{ops.get('MUFU.EX2', 0)} MUFU.EX2")
            line.append(f"{part}: {count}, local memory "
                        f"{sass.local_memory(ops)}, resources "
                        f"{k.resources(seq)}")
        if not line:
            instrs = sass.kernel_instructions(k.path, PARENT)
            ops = sass.opcodes(sass.loop_body(instrs, "MUFU.EX2"))
            line.append(f"{PARENT}: "
                        f"{sass.loop_instructions(instrs, 'MUFU.EX2')} "
                        f"instructions a step, {ops.get('MUFU.EX2', 0)} "
                        f"MUFU.EX2")
        print(f"[{k.name}] " + "; ".join(line))
        worst = []
        for case, (a, (yr, hr)) in refs.items():
            k(*a)
            torch.cuda.synchronize()
            y, h = a[7], a[8]
            share = max(float(((y.float() - yr.float()).abs()
                               / (2e-5 + 2e-5 * yr.float().abs())).max()),
                        float(((h - hr).abs()
                               / (2e-5 + 2e-5 * hr.abs())).max()))
            worst.append(f"{case[:4]} max |y - plain| "
                         f"{float((y.float() - yr.float()).abs().max()):.3e}"
                         f", |h_last - plain| "
                         f"{float((h - hr).abs().max()):.3e}, "
                         f"{share:.3f} of the bar")
        print(f"[{k.name}] " + "; ".join(worst))

    describe(shipped)
    ring = itertools.cycle(steps)
    for k in others:
        describe(k)

        def pre(kern):
            return lambda: kern(*serve)

        def step_cold(kern):
            return lambda: kern(*next(ring))

        def step_warm(kern):
            return lambda: kern(*steps[0])

        s, o = turns(lambda f: device_ms(f, reps=10, warmup=2),
                     pre(shipped), pre(k))
        print(f"[{k.name}] prefill {SC.SCAN_SERVE[:4]}: {o:.4f} ms against "
              f"the shipped {s:.4f} ms (in turns); byte bound "
              f"{serve_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        for label, mk in (("cold L2", step_cold), ("warm L2", step_warm)):
            s, o = turns(lambda f: device_ms(f, reps=40, warmup=4),
                         mk(shipped), mk(k))
            print(f"[{k.name}] decode step {SC.SCAN_STEP[:4]} from a state,"
                  f" {label}: {o:.4f} ms device time against the shipped "
                  f"{s:.4f} ms (in turns); byte bound "
                  f"{step_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    tiny = inputs((1, 1, 128, 16, "float32"), with_h0=True)
    floor = device_ms(lambda: shipped(*tiny), reps=40, warmup=4)
    print(f"[shipped] decode step at (1, 1, 128, 16), one block: {floor:.4f}"
          f" ms device time, the cost of a launch that moves nothing")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi: not available")
    return 0


if __name__ == "__main__":
    sys.exit(main())
