// Flash-attention forward kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _fwd_kernel (launched by flash_attention_fwd; public op ops.py::
// flash_attention). It computes the port's plain version,
// src/repro_torch/kernels/flash_attention/ref.py::attention_ref: causal
// and/or sliding-window GQA attention, query head h reading KV head
// h / (H / K), query positions 0..S-1 and key positions 0..T-1, scores
// scaled by hd^-0.5, masked to -1e30, softmax, weighted sum of V.
//
// Design. The TPU grid walks the KV axis in order and carries the fp32
// online-softmax state (m, l, acc) in VMEM scratch. Hopper's blocks run in
// no order, so one thread block takes one (batch, head, 64-row query tile)
// and loops over 32-row KV tiles itself. The query tile and each KV tile
// are staged in shared memory as float32 (bf16 is widened on the way in;
// dims past hd and rows past the end are zero). 128 threads: thread
// (tr, tc) = (tid / 8, tid % 8) owns query rows tr + 16 i (i < 4); for the
// scores it takes KV columns tc + 8 j (j < 4), for the output dims
// 4 tc + 32 jj .. + 3. The row max and sum across a row's 8 threads are
// warp shuffles; P goes through shared memory to the P V product. m, l and
// acc stay in registers in float32, as the TPU kernel keeps them in f32.
// The model's [B, S, H, hd] layout is read directly (no transposes).
//
// Masking follows the TPU kernel: masked scores are -1e30, not -inf, so a
// row whose first visited KV tile is fully masked (possible with a sliding
// window) accumulates exp(0) = 1 terms that a later real score wipes with
// corr = exp(-1e30 - m) = 0. KV tiles wholly outside the causal / window
// band contribute exactly 0 after that wipe and are skipped. Columns past
// T (a ragged last tile) are -inf and contribute exactly 0.
//
// Given an lse pointer (the training forward; serving passes none), the
// kernel also stores each row's natural log-sum-exp m + log(l), [B, H, S]
// float32, for the backward (flash_attention_bwd.cu).
//
// Bound. 2 B H S^2 hd multiply-adds' worth of flops for causal attention
// (the QK^T and PV products, each over half the square), against the
// card's fp32 rate outside the tensor cores in this first version: about
// 1 ms for the 8 x 1024-token qwen3-8b prefill per layer, where the bytes
// (q, k, v read once, o written once) take about 50 us. So operations
// bound it; tensor cores (wgmma on bf16 tiles) are the later speed-up.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // KV rows per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kLDP = kBK + 1;  // padded row of the P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int HDP>
constexpr size_t smem_bytes() {
  // Q tile, K tile, V tile (rows padded to HDP + 4 floats), P tile
  return sizeof(float) *
         (size_t)(kBQ * (HDP + 4) + 2 * kBK * (HDP + 4) + kBQ * kLDP);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S,
                     int Tk, int H, int K, int hd, int causal, int window,
                     float scale) {
  constexpr int LD = HDP + 4;  // float4-aligned, staggers the banks
  constexpr int NJ = HDP / 32;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const size_t q_row = (size_t)H * hd, kv_row = (size_t)K * hd;

  for (int i = tid; i < kBQ * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    float x = 0.f;
    if (q0 + r < S && d < hd)
      x = to_f(q[((size_t)b * S + q0 + r) * q_row + (size_t)h * hd + d]);
    Qs[r * LD + d] = x;
  }

  float m_i[4], l_i[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][jj][c] = 0.f;
  }

  // KV tiles that can hold an unmasked key for some row of this tile
  const int q_last = min(q0 + kBQ, S) - 1;
  const int t_end = causal ? min(Tk, q_last + 1) : Tk;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;

  for (int t0 = t_begin; t0 < t_end; t0 += kBK) {
    __syncthreads();  // Q staged / the last tile's P V done with Ks, Vs, Ps
    for (int i = tid; i < kBK * HDP; i += kThreads) {
      const int r = i / HDP, d = i % HDP;
      float kx = 0.f, vx = 0.f;
      if (t0 + r < Tk && d < hd) {
        const size_t off = ((size_t)b * Tk + t0 + r) * kv_row +
                           (size_t)kh * hd + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      Ks[r * LD + d] = kx;
      Vs[r * LD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = ld4(&Qs[(tr + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ld4(&Ks[(tc + 8 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = t0 + tc + 8 * j;
        bool valid = true;
        if (causal) valid = valid && kj <= qi;
        if (window > 0) valid = valid && (qi - kj) < window;
        float x = valid ? s[i][j] * scale : kNegInf;
        if (kj >= Tk) x = -INFINITY;  // past the end: exactly 0 below
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[i], mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(tr + 16 * i) * kLDP + tc + 8 * j] = p;
        ps += p;
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      ps += __shfl_xor_sync(0xffffffffu, ps, 4);
      corr[i] = expf(m_i[i] - m_new);
      l_i[i] = corr[i] * l_i[i] + ps;
      m_i[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][jj][c] *= corr[i];
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(tr + 16 * i) * kLDP + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 vv = ld4(&Vs[kk * LD + 4 * tc + 32 * jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj][0] = fmaf(p[i], vv.x, acc[i][jj][0]);
          acc[i][jj][1] = fmaf(p[i], vv.y, acc[i][jj][1]);
          acc[i][jj][2] = fmaf(p[i], vv.z, acc[i][jj][2]);
          acc[i][jj][3] = fmaf(p[i], vv.w, acc[i][jj][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= S) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    if (lse != nullptr && tc == 0)
      lse[((size_t)b * H + h) * S + qi] = m_i[i] + logf(l_i[i]);
    T* orow = o + ((size_t)b * S + qi) * q_row + (size_t)h * hd;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * tc + 32 * jj + c;
        if (d < hd) store(orow + d, acc[i][jj][c] / denom);
      }
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int Tk, int H, int K, int hd,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP>();
  auto kern = flash_fwd_kernel<T, HDP>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Tk, H, K, hd,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int S, int Tk, int H, int K, int hd,
                      int causal, int window, float scale,
                      cudaStream_t st) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, lse, B, S, Tk, H, K, hd, causal, window,
                         scale, st);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, S, Tk, H, K, hd, causal, window,
                         scale, st);
  return launch<T, 128>(q, k, v, o, lse, B, S, Tk, H, K, hd, causal, window,
                        scale, st);
}

}  // namespace

// q, o [B, S, H, hd]; k, v [B, T, K, hd]; all contiguous, float32
// (bf16 == 0) or bfloat16 (bf16 == 1), on CUDA device `device`; H % K == 0,
// 1 <= hd <= 128. lse, if not null, is [B, H, S] float32 and receives each
// row's log-sum-exp. window <= 0 means no window. Launches on `stream` and
// returns the CUDA error of the launch (0 when it was accepted).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int bf16,
                                      int B, int S, int T, int H, int K,
                                      int hd, int causal, int window,
                                      float scale, int device,
                                      void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_hd<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), B,
                                      S, T, H, K, hd, causal, window, scale,
                                      st)
           : launch_hd<float>(q, k, v, o, static_cast<float*>(lse), B, S, T,
                              H, K, hd, causal, window, scale, st);
  return static_cast<int>(err);
}
