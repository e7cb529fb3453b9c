// Selective-scan (Mamba S6) kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/selective_scan/kernel.py::
// _scan_kernel (launched by selective_scan_pallas). It computes the port's
// plain version, src/repro_torch/kernels/selective_scan/ref.py::
// selective_scan_ref: for each batch row b and channel d, over s = 0..S-1,
//   dA  = exp(dt_s * A[d, n])
//   h_n = dA * h_n + (dt_s * x_s) * B_s[n]
//   y_s = sum_n h_n * C_s[n] + x_s * D[d]
// with h = h0 (zeros when none is given) before the first step, the state
// in float32, y in x's type, and the last state written to h_last.
//
// Bound. At jamba's serving shape (B 8, S 1,024, d_inner 8,192, N 16,
// x and dt float32) the bytes are 0.81 GB (x, dt 537 MB; y 268 MB; B, C,
// A, D, h 5 MB): 0.2421 ms at 3.35 TB/s. The operations, about 6 flops
// per state element (1.07e9 elements), take 0.10 ms at 67 TFLOP/s, so the
// bytes bound it. One decode step from a state (8, 1, 8,192, 16) moves
// 9.73 MB (h0 and h_last 8.4 MB of it): 0.0029 ms. What the card spends
// beyond that is instruction throughput: per channel-step, the loads of
// x, dt, B and C, the sum over n and the store of y, on top of 5
// instructions a state; and the SFU, 16 exps a clock per SM, ~0.26 ms
// for the serving shape's.
//
// Two instances behind the one C entry point, picked by S; one launch a
// call either way.
//
// Sequence instance (S > 1, prefill). One thread a channel, its N states
// in registers. A block of 256 threads takes 256 channels of one batch row
// through the whole sequence in tiles of 4 steps: a tile's x and dt (4 rows
// of 256 channels) and its B and C (4 x N contiguous floats each) are
// staged in shared memory through a ring of 2 tiles by 16-byte cp.async
// (LDGSTS), so tile t + 1 is in flight while tile t's steps run. Every
// thread copies the same row and column of each tile, with offsets fixed
// once: no divide, no loop. At up to 128 registers 2 blocks are resident
// on an SM (16 warps): the 256 blocks of the serving shape run in one wave
// on 132 SMs. (Timed in turns, PERF.md: splitting a channel's states over
// 2 or 4 lanes, for up to 48 warps an SM, is slower: every lane repeats
// the per-step loads of x, dt, B and C, and y's sum over the lanes and its
// store cost shuffles a step.)
//
// Step instance (S == 1, decode). No shared memory and no barrier: each
// thread owns 4 consecutive states of one channel, loads h0 and A as
// 16-byte vectors, B and C (N floats per batch row, read by every
// channel) through the read-only path, x, dt and D once per channel,
// and writes h_last as a 16-byte vector; y is summed over the channel's
// lanes by shuffles.
//
// State sizes 4, 8 and 16 with 16-byte aligned tensors (and rows of x
// whose bytes are a multiple of 16 for the sequence instance) take the
// exact instances; any other N <= 16 or alignment takes the generic one,
// which masks states n >= N and copies element by element. Ragged d is
// masked in every instance; the last tile's rows past S are zeroed, a
// step that leaves h as it is.
//
// Numerics. exp(dt A) is ex2.approx(dt * (A log2e)), A prescaled once per
// thread: one MUFU.EX2 per state-step, where libdevice's accurate expf
// costs about 6 more instructions (63% slower at prefill, timed in turns:
// PERF.md). The state update and y's sum over n are explicit fmaf (the
// flag -fmad=false, with which the source is built, leaves them alone and
// keeps every other multiply and add apart). So dA differs from the plain version's by a few ulps, the
// update and the sum round once where it rounds twice, and the sum over n
// runs in another order: every case of cases.py meets its bar (worst
// errors measured: PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // threads per block, both instances
constexpr int kSeqBlocks = 2;    // blocks an SM, sequence instance
constexpr int kStepBlocks = 4;   // blocks an SM, step instance
constexpr int kStages = 2;       // tiles in the ring
constexpr int kSteps = 4;        // steps a tile
constexpr int kStepStates = 4;   // states a lane, step instance (a float4)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// K floats (a multiple of 4) from 16-byte aligned memory, 16 bytes a load
template <int K>
__device__ __forceinline__ void load_vec(float (&v)[K], const float* p) {
#pragma unroll
  for (int q = 0; q < K; q += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + q);
    v[q] = f.x, v[q + 1] = f.y, v[q + 2] = f.z, v[q + 3] = f.w;
  }
}

__device__ __forceinline__ float ex2(float u) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(u));
  return r;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// the sum over a group of kLanes lanes, left in every lane of it
template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int m = 1; m < kLanes; m <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// One step of a lane's K states: the update, and their share of y.
template <int K>
__device__ __forceinline__ float step_states(float (&h)[K],
                                             const float (&a2)[K], float dv,
                                             float dx, const float (&bq)[K],
                                             const float (&cq)[K]) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    h[k] = fmaf(ex2(dv * a2[k]), h[k], dx * bq[k]);
    acc = fmaf(h[k], cq[k], acc);
  }
  return acc;
}

// NP: the state size the instance is laid out for. GENERIC: N may be
// smaller than NP (states n >= N are masked) and nothing is assumed
// aligned; otherwise N == NP and every tensor is 16-byte aligned with
// rows of x of a multiple of 16 bytes.
template <typename T, int NP, bool GENERIC>
__global__ void __launch_bounds__(kThreads, kSeqBlocks)
    selective_scan_seq_kernel(const T* __restrict__ x,
                              const T* __restrict__ dt,
                              const float* __restrict__ A,
                              const float* __restrict__ Bc,
                              const float* __restrict__ Cc,
                              const float* __restrict__ D,
                              const float* __restrict__ h0,
                              T* __restrict__ y, float* __restrict__ h_last,
                              int S, int d, int N) {
  __shared__ __align__(16) T xs[kStages][kSteps][kThreads];
  __shared__ __align__(16) T dts[kStages][kSteps][kThreads];
  __shared__ __align__(16) float bs[kStages][kSteps * NP];
  __shared__ __align__(16) float cs[kStages][kSteps * NP];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kThreads, c = c0 + tid;  // tid's channel
  const bool live = c < d;
  const size_t row0 = (size_t)blockIdx.y * S;  // first (b, s) row
  const int tiles = (S + kSteps - 1) / kSteps;

  // The copies of a tile in the exact instances: 16 bytes each, kXD of x
  // and kXD of dt (a row of kThreads elements is kRow copies), kBC of B
  // and kBC of C (the tile's kSteps x NP floats are one contiguous block).
  // Every thread copies the same row and column of x and of dt in every
  // tile (kThreads is a multiple of kXD), and threads below 2 kBC a piece
  // of B or of C: the offsets are fixed here, once.
  constexpr int kPer = 16 / (int)sizeof(T);   // elements a copy
  constexpr int kRow = kThreads / kPer;
  constexpr int kXD = kSteps * kRow;
  constexpr int kBC = kSteps * NP / 4;
  static_assert(GENERIC || ((2 * kXD) % kThreads == 0 &&
                            kThreads % kXD == 0 && 2 * kBC <= kThreads),
                "a tile's copies do not divide among the threads");
  const int crow = (tid % kXD) / kRow, ccol = (tid % kXD) % kRow * kPer;
  const bool c_in = c0 + ccol < d;
  const int cb = (tid % kBC) * 4;

  // the copies of tile t into its slot of the ring. The last tile's rows
  // past the sequence are zeroed: a step with dt = x = B = C = 0 leaves h
  // as it is (dA = 2^0 = 1), so every tile runs all its steps.
  auto stage = [&](int t) {
    const int slot = t % kStages;
    const int s0 = t * kSteps, n = min(kSteps, S - s0);
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
#pragma unroll
      for (int r = 0; r < kSteps; ++r) {
        const size_t off = (row0 + s0 + r) * d + c;
        const bool in = r < n && live;
        xs[slot][r][tid] = in ? x[off] : T(0.f);
        dts[slot][r][tid] = in ? dt[off] : T(0.f);
      }
      // row stride N in shared memory: the tile is one contiguous block
      for (int i = tid; i < kSteps * N; i += kThreads) {
        const bool in = i < n * N;
        bs[slot][i] = in ? Bc[(row0 + s0) * N + i] : 0.f;
        cs[slot][i] = in ? Cc[(row0 + s0) * N + i] : 0.f;
      }
    }
  };

  float a2[NP], h[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const bool on = live && (!GENERIC || k < N);
    a2[k] = on ? A[(size_t)c * N + k] * kLog2e : 0.f;
    h[k] = (on && h0 != nullptr) ? h0[((size_t)blockIdx.y * d + c) * N + k]
                                 : 0.f;
  }
  const float dskip = live ? D[c] : 0.f;

  T* yq = y + row0 * d + c;   // y of the tile's first step
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    // tile t has landed for every thread, and every thread is done with
    // tile t - 1, whose slot the next copies fill
    __syncthreads();
    if (t + kStages - 1 < tiles) stage(t + kStages - 1);
    cp_async_commit();

    const int slot = t % kStages;
    const int n = min(kSteps, S - t * kSteps);
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      const float xv = to_f(xs[slot][r][tid]), dv = to_f(dts[slot][r][tid]);
      float bq[NP], cq[NP];
      if (!GENERIC) {
        load_vec(bq, &bs[slot][r * NP]);
        load_vec(cq, &cs[slot][r * NP]);
      } else {
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          bq[k] = k < N ? bs[slot][r * N + k] : 0.f;
          cq[k] = k < N ? cs[slot][r * N + k] : 0.f;
        }
      }
      const float acc = step_states(h, a2, dv, dv * xv, bq, cq);
      if (live && r < n) store(yq + (size_t)r * d, acc + xv * dskip);
    }
    yq += (size_t)kSteps * d;
  }
  cp_async_wait<0>();

  if (live) {
#pragma unroll
    for (int k = 0; k < NP; ++k)
      if (!GENERIC || k < N)
        h_last[((size_t)blockIdx.y * d + c) * N + k] = h[k];
  }
}

// One step from h0 (S == 1). NP and GENERIC as above.
template <typename T, int NP, bool GENERIC>
__global__ void __launch_bounds__(kThreads, kStepBlocks)
    selective_scan_step_kernel(const T* __restrict__ x,
                               const T* __restrict__ dt,
                               const float* __restrict__ A,
                               const float* __restrict__ Bc,
                               const float* __restrict__ Cc,
                               const float* __restrict__ D,
                               const float* __restrict__ h0,
                               T* __restrict__ y,
                               float* __restrict__ h_last, int d, int N) {
  constexpr int kLanes = NP / kStepStates;       // lanes a channel
  constexpr int kChannels = kThreads / kLanes;  // channels a block
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int b = blockIdx.y;
  const int c = blockIdx.x * kChannels + tid / kLanes;
  const bool live = c < d;
  const int n0 = lane * 4;
  const size_t hrow = ((size_t)b * d + c) * N + n0;

  float a2[4] = {}, h[4] = {}, bq[4] = {}, cq[4] = {};
  float xv = 0.f, dv = 0.f, dskip = 0.f;
  if (live) {
    xv = to_f(x[(size_t)b * d + c]);
    dv = to_f(dt[(size_t)b * d + c]);
    dskip = D[c];
    if (!GENERIC) {
      const float4 a4 = __ldg(reinterpret_cast<const float4*>(
          A + (size_t)c * NP + n0));
      const float4 b4 =
          __ldg(reinterpret_cast<const float4*>(Bc + (size_t)b * NP + n0));
      const float4 c4 =
          __ldg(reinterpret_cast<const float4*>(Cc + (size_t)b * NP + n0));
      a2[0] = a4.x * kLog2e, a2[1] = a4.y * kLog2e;
      a2[2] = a4.z * kLog2e, a2[3] = a4.w * kLog2e;
      bq[0] = b4.x, bq[1] = b4.y, bq[2] = b4.z, bq[3] = b4.w;
      cq[0] = c4.x, cq[1] = c4.y, cq[2] = c4.z, cq[3] = c4.w;
      if (h0 != nullptr) {
        const float4 h4 = *reinterpret_cast<const float4*>(h0 + hrow);
        h[0] = h4.x, h[1] = h4.y, h[2] = h4.z, h[3] = h4.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (n0 + k < N) {
          a2[k] = A[(size_t)c * N + n0 + k] * kLog2e;
          bq[k] = __ldg(Bc + (size_t)b * N + n0 + k);
          cq[k] = __ldg(Cc + (size_t)b * N + n0 + k);
          h[k] = h0 != nullptr ? h0[hrow + k] : 0.f;
        }
      }
    }
  }
  const float acc =
      group_sum<kLanes>(step_states(h, a2, dv, dv * xv, bq, cq));
  if (live) {
    if (lane == 0) store(y + (size_t)b * d + c, acc + xv * dskip);
    if (!GENERIC) {
      *reinterpret_cast<float4*>(h_last + hrow) =
          make_float4(h[0], h[1], h[2], h[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (n0 + k < N) h_last[hrow + k] = h[k];
    }
  }
}

template <typename T, int NP, bool GENERIC>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const float* Bc, const float* Cc, const float* D,
                   const float* h0, void* y, float* h_last, int B, int S,
                   int d, int N, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  T* yt = static_cast<T*>(y);
  if (S == 1) {
    constexpr int kChannels = kThreads / (NP / kStepStates);
    const dim3 grid((d + kChannels - 1) / kChannels, B);
    selective_scan_step_kernel<T, NP, GENERIC>
        <<<grid, kThreads, 0, stream>>>(xt, dtt, A, Bc, Cc, D, h0, yt,
                                         h_last, d, N);
  } else {
    const dim3 grid((d + kThreads - 1) / kThreads, B);
    selective_scan_seq_kernel<T, NP, GENERIC>
        <<<grid, kThreads, 0, stream>>>(xt, dtt, A, Bc, Cc, D, h0, yt,
                                         h_last, S, d, N);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch_n(const void* x, const void* dt, const float* A,
                     const float* Bc, const float* Cc, const float* D,
                     const float* h0, void* y, float* h_last, int B, int S,
                     int d, int N, cudaStream_t st, int* generic) {
  const bool exact =
      (N == 4 || N == 8 || N == 16) && aligned16(x) && aligned16(dt) &&
      aligned16(A) && aligned16(Bc) && aligned16(Cc) && aligned16(y) &&
      aligned16(h_last) && (h0 == nullptr || aligned16(h0)) &&
      (S == 1 || (size_t)d * sizeof(T) % 16 == 0);
  if (generic != nullptr) *generic = !exact;
  if (!exact)
    return launch<T, 16, true>(x, dt, A, Bc, Cc, D, h0, y, h_last, B, S, d,
                               N, st);
  switch (N) {
    case 4:
      return launch<T, 4, false>(x, dt, A, Bc, Cc, D, h0, y, h_last, B, S,
                                 d, N, st);
    case 8:
      return launch<T, 8, false>(x, dt, A, Bc, Cc, D, h0, y, h_last, B, S,
                                 d, N, st);
    default:
      return launch<T, 16, false>(x, dt, A, Bc, Cc, D, h0, y, h_last, B, S,
                                  d, N, st);
  }
}

}  // namespace

// x, dt [B, S, d] and y [B, S, d]: float32 (bf16 == 0) or bfloat16
// (bf16 == 1); A [d, N], Bc, Cc [B, S, N], D [d], h0 [B, d, N] (or null:
// zeros) and h_last [B, d, N] float32; all contiguous on CUDA device
// `device`; 1 <= N <= 16, B, S, d >= 1. Runs the step instance when
// S == 1, else the sequence instance; launches on `stream`, writes to
// *generic (unless null) 1 when it took the masked generic template and 0
// when an exact one, and returns the CUDA error of the launch (0 when
// accepted).
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const float* A, const float* Bc,
                                     const float* Cc, const float* D,
                                     const float* h0, int bf16, int B, int S,
                                     int d, int N, void* y, float* h_last,
                                     int device, void* stream,
                                     int* generic) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (N < 1 || N > 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_n<__nv_bfloat16>(x, dt, A, Bc, Cc, D, h0, y, h_last, B,
                                     S, d, N, st, generic)
           : launch_n<float>(x, dt, A, Bc, Cc, D, h0, y, h_last, B, S, d, N,
                             st, generic);
  return static_cast<int>(err);
}

// Resources of the float32 instances at d_state 16 (the serving path's;
// seq != 0: the sequence instance, else the step one): registers and
// local bytes a thread, static shared bytes a block, blocks resident per
// SM and channels a block, written to out[0..4].
extern "C" int selective_scan_resources(int seq, int device, int* out) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const void* fn =
      seq ? reinterpret_cast<const void*>(
                selective_scan_seq_kernel<float, 16, false>)
          : reinterpret_cast<const void*>(
                selective_scan_step_kernel<float, 16, false>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = blocks;
  out[4] = seq ? kThreads : kThreads / (16 / kStepStates);
  return 0;
}
