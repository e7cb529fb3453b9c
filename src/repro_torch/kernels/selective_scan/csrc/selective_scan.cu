// Selective-scan (Mamba S6) kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/selective_scan/kernel.py::
// _scan_kernel (launched by selective_scan_pallas). It computes the port's
// plain version, src/repro_torch/kernels/selective_scan/ref.py::
// selective_scan_ref: for each batch row b and channel d, over s = 0..S-1,
//   dA  = exp(dt_s * A[d, n])
//   h_n = dA * h_n + (dt_s * x_s) * B_s[n]
//   y_s = sum_n h_n * C_s[n] + x_s * D[d]
// with h = h0 (zeros when none is given) before the first step, the state
// in float32, y in x's type, and the last state written to h_last. The
// operations are the plain version's, in its order; the build has no fast
// math and no FMA contraction (-fmad=false), so only the order of the sum
// over n differs from PyTorch's.
//
// Design. The TPU kernel tiles channels onto lanes and walks the sequence
// chunk by chunk on a sequential grid axis with h [block_d, N] in VMEM.
// On Hopper the blocks run in parallel and in no order, so the sequence is
// a loop inside the thread: one thread per (batch, channel) carries its
// h[N] in registers (N is a template parameter, the loops over it are
// unrolled, so h never reaches local memory) through all S steps. A block
// of 128 consecutive channels of one batch row stages, for each tile of
// 32 steps, the tile's x and dt (128 channels x 32 steps, coalesced rows)
// and its B and C (N floats per step, which every channel reads) in shared
// memory, then runs the tile's steps and writes y rows coalesced. Like the
// TPU kernel it never forms the [B, S, d, N] discretised tensors: device
// memory sees x, dt and y once each, B, C once per block of channels.
//
// Bound. At jamba's serving shape (B 8, S 1,024, d_inner 8,192, N 16,
// x and dt float32) the bytes are 0.81 GB (x, dt 537 MB; y 268 MB; B, C,
// A, D, h 5 MB), 0.24 ms at 3.35 TB/s. The operations are 1.07e9 accurate
// expf plus about four multiply/add instructions per state element; their
// instruction count per step, read from this library's SASS
// (src/repro_torch/kernels/sass.py), over the card's issue rate is the
// larger floor.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;  // channels per block, one thread each
constexpr int kSteps = 32;     // time steps per staged tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// NP: the state size the loops are unrolled to. MASKED: N may be smaller
// than NP, and state elements n >= N are skipped (the generic instance);
// otherwise N == NP.
template <typename T, int NP, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bc,
                          const float* __restrict__ Cc,
                          const float* __restrict__ D,
                          const float* __restrict__ h0, T* __restrict__ y,
                          float* __restrict__ h_last, int S, int d, int N) {
  __shared__ float Xs[kSteps][kThreads];
  __shared__ float DTs[kSteps][kThreads];
  __shared__ float Bs[kSteps][NP];
  __shared__ float Cs[kSteps][NP];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + tid;
  const bool live = c < d;
  const size_t row0 = (size_t)b * S;  // first (b, s) row
  const size_t hrow = ((size_t)b * d + c) * N;

  float a[NP], h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    const bool on = live && (!MASKED || n < N);
    a[n] = on ? A[(size_t)c * N + n] : 0.f;
    h[n] = (on && h0 != nullptr) ? h0[hrow + n] : 0.f;
  }
  const float dskip = live ? D[c] : 0.f;

  for (int s0 = 0; s0 < S; s0 += kSteps) {
    const int steps = min(kSteps, S - s0);
    __syncthreads();  // the last tile's steps are done with the buffers
    for (int r = 0; r < steps; ++r) {
      const size_t off = (row0 + s0 + r) * d + c;
      Xs[r][tid] = live ? to_f(x[off]) : 0.f;
      DTs[r][tid] = live ? to_f(dt[off]) : 0.f;
    }
    for (int i = tid; i < steps * N; i += kThreads) {
      const int r = i / N, n = i % N;
      Bs[r][n] = Bc[(row0 + s0) * N + i];
      Cs[r][n] = Cc[(row0 + s0) * N + i];
    }
    __syncthreads();

#pragma unroll 1
    for (int r = 0; r < steps; ++r) {
      const float xv = Xs[r][tid], dv = DTs[r][tid];
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        if (!MASKED || n < N) {
          const float dA = expf(dv * a[n]);
          h[n] = dA * h[n] + dx * Bs[r][n];
          acc = acc + h[n] * Cs[r][n];
        }
      }
      if (live) store(&y[(row0 + s0 + r) * d + c], acc + xv * dskip);
    }
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < NP; ++n)
      if (!MASKED || n < N) h_last[hrow + n] = h[n];
  }
}

template <typename T, int NP, bool MASKED>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const float* Bc, const float* Cc, const float* D,
                   const float* h0, void* y, float* h_last, int B, int S,
                   int d, int N, cudaStream_t stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, B), block(kThreads);
  selective_scan_kernel<T, NP, MASKED><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, Bc, Cc, D, h0,
      static_cast<T*>(y), h_last, S, d, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* x, const void* dt, const float* A,
                     const float* Bc, const float* Cc, const float* D,
                     const float* h0, void* y, float* h_last, int B, int S,
                     int d, int N, cudaStream_t st) {
  switch (N) {
    case 4:
      return launch<T, 4, false>(x, dt, A, Bc, Cc, D, h0, y, h_last, B, S,
                                 d, N, st);
    case 8:
      return launch<T, 8, false>(x, dt, A, Bc, Cc, D, h0, y, h_last, B, S,
                                 d, N, st);
    case 16:
      return launch<T, 16, false>(x, dt, A, Bc, Cc, D, h0, y, h_last, B, S,
                                  d, N, st);
    default:
      return launch<T, 16, true>(x, dt, A, Bc, Cc, D, h0, y, h_last, B, S,
                                 d, N, st);
  }
}

}  // namespace

// x, dt [B, S, d] and y [B, S, d]: float32 (bf16 == 0) or bfloat16
// (bf16 == 1); A [d, N], Bc, Cc [B, S, N], D [d], h0 [B, d, N] (or null:
// zeros) and h_last [B, d, N] float32; all contiguous on CUDA device
// `device`; 1 <= N <= 16, B, S, d >= 1. Launches on `stream` and returns
// the CUDA error of the launch (0 when accepted).
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const float* A, const float* Bc,
                                     const float* Cc, const float* D,
                                     const float* h0, int bf16, int B, int S,
                                     int d, int N, void* y, float* h_last,
                                     int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (N < 1 || N > 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_n<__nv_bfloat16>(x, dt, A, Bc, Cc, D, h0, y, h_last, B,
                                     S, d, N, st)
           : launch_n<float>(x, dt, A, Bc, Cc, D, h0, y, h_last, B, S, d, N,
                             st);
  return static_cast<int>(err);
}
