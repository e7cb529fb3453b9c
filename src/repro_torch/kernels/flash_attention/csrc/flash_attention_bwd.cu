// Flash-attention backward for Hopper (sm_90a) on the CUDA cores: dq, dk
// and dv of causal and/or sliding-window GQA attention in float32 FMAs, for
// float32 inputs and for bf16 at a head_dim the tensor-core route does not
// take (not a multiple of 8), three launches a call.
//
// Replaces the recompute of src/repro_torch/kernels/flash_attention/
// ops.py::_Flash.backward (which differentiated the plain version,
// ref.py::attention_ref, with eager autograd), the port of the TPU
// reference's src/repro/kernels/flash_attention/ops.py::_flash_bwd (XLA's
// VJP of its jnp oracle; it reaches no Pallas kernel). It computes the
// port's plain version ref.py::attention_bwd_ref, the FlashAttention-2
// backward: from q, k, v, the forward's o and its row log-sum-exp lse
// ([B, H, S] float32, written by the forward kernels when asked) and dO,
//   P  = exp(scale q.k - lse) on unmasked (query, key) pairs, 0 elsewhere
//   D  = rowsum(dO * O)                     (float32, [B, H, S])
//   dS = P * (dO.v - D)
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
// dK and dV summed over the G = H / K query heads of each KV head. Query
// head h reads KV head h / G; positions are 0..S-1 (queries) and 0..T-1
// (keys); scores are masked as the forward masks them. bf16 with head_dim
// a multiple of 8 up to 128 takes the tensor cores instead
// (flash_attention_bwd_wgmma.cu, the "wgmma" route).
//
// Bound. Five products per visible (query, key) pair (S, dP, dV, dK, dQ),
// here in float32 outside the tensor cores (no TF32, as the forward's SIMT
// route: TF32 would not hold the 1e-4 bar), so operations bound it. This
// route recomputes S and dP for dQ in a pass of its own: seven products.
//
// Design (the "simt" route). (a) flash_bwd_delta_kernel: D, 16 lanes a
// row. (b) flash_bwd_dkdv_simt_kernel: one block takes one (32-key tile,
// KV head, batch), loops over the G heads and the 32-query tiles that see
// it, and keeps dK and dV in registers, so GQA needs no atomics. (c)
// flash_bwd_dq_simt_kernel: one block takes one (64-row query tile, head,
// batch). P and dS pass through shared memory; no head split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool visible(int qi, int kj, int S, int Tk,
                                        int causal, int window) {
  return qi < S && kj < Tk && (!causal || kj <= qi) &&
         (window <= 0 || qi - kj < window);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// (a) D = rowsum(dO * O), float32, [B, H, S]: 16 lanes a row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ d_o,
                           float* __restrict__ delta, int rows, int S, int H,
                           int hd) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 16;
  const int sub = threadIdx.x % 16;
  float acc = 0.f;
  if (row < rows) {
    const size_t base = (size_t)row * hd;
    for (int d = sub; d < hd; d += 16)
      acc = fmaf(to_f(o[base + d]), to_f(d_o[base + d]), acc);
  }
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && sub == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// (b), (c) dK / dV and dQ in float32 FMAs
// ---------------------------------------------------------------------------

constexpr int kSR = 64;         // queries a dQ block owns
constexpr int kSK = 32;         // keys a dK / dV block owns
constexpr int kSC = 32;         // columns of a tile (keys or queries)
constexpr int kLDP = kSC + 1;   // padded row of a P or dS tile

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows r0 .. r0 + n - 1 of head `head` of [B, N, heads, hd] into a float32
// tile with rows of LD floats (zeros past N and hd)
template <typename T, int HDP>
__device__ __forceinline__ void stage(float* dst, const T* x, int b, int r0,
                                      int n, int N, int heads, int head,
                                      int hd) {
  constexpr int LD = HDP + 4;
  for (int i = threadIdx.x; i < n * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    float val = 0.f;
    if (r0 + r < N && d < hd)
      val = to_f(x[(((size_t)b * N + r0 + r) * heads + head) * hd + d]);
    dst[r * LD + d] = val;
  }
}

template <int HDP>
constexpr size_t simt_dq_smem() {
  // Q, dO (kSR rows), K, V (kSC rows), dS
  return sizeof(float) * ((size_t)2 * (kSR + kSC) * (HDP + 4) + kSR * kLDP);
}

// One block takes one (64-row query tile, head, batch), the long causal
// tiles first; thread (tr, tc) owns rows tr + 16 i (i < 4), key columns
// tc + 8 j (j < 4) of a 32-key tile, and output dims 4 tc + 32 jj .. + 3,
// as the forward SIMT kernel.
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ d_o,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dq, int S, int Tk, int H, int K,
                             int hd, int causal, int window, float scale) {
  constexpr int LD = HDP + 4, NJ = HDP / 32;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kSR * LD;
  float* Ks = dOs + kSR * LD;
  float* Vs = Ks + kSC * LD;
  float* Ps = Vs + kSC * LD;

  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kSR;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / (H / K);
  stage<T, HDP>(Qs, q, b, q0, kSR, S, H, h, hd);
  stage<T, HDP>(dOs, d_o, b, q0, kSR, S, H, h, hd);
  float ls[4], dd[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    const size_t r = ((size_t)b * H + h) * S + qi;
    ls[i] = qi < S ? lse[r] : 0.f;
    dd[i] = qi < S ? delta[r] : 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][jj][c] = 0.f;
  }
  const int t_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_hi = causal ? min(Tk, q0 + kSR) : Tk;

  for (int t0 = t_lo / kSC * kSC; t0 < t_hi; t0 += kSC) {
    __syncthreads();  // Q, dO staged / the last tile's dS K done
    stage<T, HDP>(Ks, k, b, t0, kSC, Tk, K, kh, hd);
    stage<T, HDP>(Vs, v, b, t0, kSC, Tk, K, kh, hd);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HDP; d += 4) {
      float4 qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = ld4(&Qs[(tr + 16 * i) * LD + d]);
        ov[i] = ld4(&dOs[(tr + 16 * i) * LD + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ld4(&Ks[(tc + 8 * j) * LD + d]);
        vv[j] = ld4(&Vs[(tc + 8 * j) * LD + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          dp[i][j] = fmaf(ov[i].x, vv[j].x, dp[i][j]);
          dp[i][j] = fmaf(ov[i].y, vv[j].y, dp[i][j]);
          dp[i][j] = fmaf(ov[i].z, vv[j].z, dp[i][j]);
          dp[i][j] = fmaf(ov[i].w, vv[j].w, dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + tr + 16 * i, kj = t0 + tc + 8 * j;
        const float p = visible(qi, kj, S, Tk, causal, window)
                            ? expf(s[i][j] * scale - ls[i])
                            : 0.f;
        Ps[(tr + 16 * i) * kLDP + tc + 8 * j] = p * (dp[i][j] - dd[i]);
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kSC; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ps[(tr + 16 * i) * kLDP + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 kv = ld4(&Ks[kk * LD + 4 * tc + 32 * jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj][0] = fmaf(ds[i], kv.x, acc[i][jj][0]);
          acc[i][jj][1] = fmaf(ds[i], kv.y, acc[i][jj][1]);
          acc[i][jj][2] = fmaf(ds[i], kv.z, acc[i][jj][2]);
          acc[i][jj][3] = fmaf(ds[i], kv.w, acc[i][jj][3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= S) continue;
    T* row = dq + (((size_t)b * S + qi) * H + h) * hd;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * tc + 32 * jj + c;
        if (d < hd) store(row + d, acc[i][jj][c] * scale);
      }
  }
}

template <int HDP>
constexpr size_t simt_dkdv_smem() {
  // K, V (kSK rows), Q, dO (kSC rows), P^T, dS^T, lse and D of kSC rows
  return sizeof(float) * ((size_t)2 * (kSK + kSC) * (HDP + 4) +
                          2 * kSK * kLDP + 2 * kSC);
}

// One block takes one (32-key tile, KV head, batch), the long causal
// tiles first, and loops over the G heads and the 32-query tiles that see
// it; thread (tr, tc) owns keys tr + 16 i (i < 2), query columns
// tc + 8 j (j < 4), and output dims 4 tc + 32 jj .. + 3 of dK and dV.
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_simt_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ d_o,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, int S,
                               int Tk, int H, int K, int hd, int causal,
                               int window, float scale) {
  constexpr int LD = HDP + 4, NJ = HDP / 32, RI = kSK / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kSK * LD;
  float* Qs = Vs + kSK * LD;
  float* dOs = Qs + kSC * LD;
  float* PT = dOs + kSC * LD;
  float* dST = PT + kSK * kLDP;
  float* Ls = dST + kSK * kLDP;
  float* Ds = Ls + kSC;

  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int t0 = blockIdx.z * kSK, kh = blockIdx.x, b = blockIdx.y;
  const int G = H / K;
  stage<T, HDP>(Ks, k, b, t0, kSK, Tk, K, kh, hd);
  stage<T, HDP>(Vs, v, b, t0, kSK, Tk, K, kh, hd);
  float dka[RI][NJ][4], dva[RI][NJ][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) dka[i][jj][c] = dva[i][jj][c] = 0.f;
  const int q_lo = causal ? t0 : 0;
  const int q_hi = window > 0 ? min(S, t0 + kSK - 1 + window) : S;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int q0 = q_lo / kSC * kSC; q0 < q_hi; q0 += kSC) {
      __syncthreads();  // K, V staged / the last tile's products done
      stage<T, HDP>(Qs, q, b, q0, kSC, S, H, h, hd);
      stage<T, HDP>(dOs, d_o, b, q0, kSC, S, H, h, hd);
      if (tid < kSC) {
        const int qi = q0 + tid;
        const size_t r = ((size_t)b * H + h) * S + qi;
        Ls[tid] = qi < S ? lse[r] : 0.f;
        Ds[tid] = qi < S ? delta[r] : 0.f;
      }
      __syncthreads();
      float st[RI][4], dpt[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HDP; d += 4) {
        float4 kv[RI], vv[RI], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          kv[i] = ld4(&Ks[(tr + 16 * i) * LD + d]);
          vv[i] = ld4(&Vs[(tr + 16 * i) * LD + d]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = ld4(&Qs[(tc + 8 * j) * LD + d]);
          ov[j] = ld4(&dOs[(tc + 8 * j) * LD + d]);
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i].x, qv[j].x, st[i][j]);
            st[i][j] = fmaf(kv[i].y, qv[j].y, st[i][j]);
            st[i][j] = fmaf(kv[i].z, qv[j].z, st[i][j]);
            st[i][j] = fmaf(kv[i].w, qv[j].w, st[i][j]);
            dpt[i][j] = fmaf(vv[i].x, ov[j].x, dpt[i][j]);
            dpt[i][j] = fmaf(vv[i].y, ov[j].y, dpt[i][j]);
            dpt[i][j] = fmaf(vv[i].z, ov[j].z, dpt[i][j]);
            dpt[i][j] = fmaf(vv[i].w, ov[j].w, dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = t0 + tr + 16 * i, col = tc + 8 * j, qi = q0 + col;
          const float p = visible(qi, kj, S, Tk, causal, window)
                              ? expf(st[i][j] * scale - Ls[col])
                              : 0.f;
          PT[(tr + 16 * i) * kLDP + col] = p;
          dST[(tr + 16 * i) * kLDP + col] = p * (dpt[i][j] - Ds[col]);
        }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kSC; ++qq) {
        float p[RI], ds[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          p[i] = PT[(tr + 16 * i) * kLDP + qq];
          ds[i] = dST[(tr + 16 * i) * kLDP + qq];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 ov = ld4(&dOs[qq * LD + 4 * tc + 32 * jj]);
          const float4 qv = ld4(&Qs[qq * LD + 4 * tc + 32 * jj]);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            dva[i][jj][0] = fmaf(p[i], ov.x, dva[i][jj][0]);
            dva[i][jj][1] = fmaf(p[i], ov.y, dva[i][jj][1]);
            dva[i][jj][2] = fmaf(p[i], ov.z, dva[i][jj][2]);
            dva[i][jj][3] = fmaf(p[i], ov.w, dva[i][jj][3]);
            dka[i][jj][0] = fmaf(ds[i], qv.x, dka[i][jj][0]);
            dka[i][jj][1] = fmaf(ds[i], qv.y, dka[i][jj][1]);
            dka[i][jj][2] = fmaf(ds[i], qv.z, dka[i][jj][2]);
            dka[i][jj][3] = fmaf(ds[i], qv.w, dka[i][jj][3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kj = t0 + tr + 16 * i;
    if (kj >= Tk) continue;
    const size_t row = (((size_t)b * Tk + kj) * K + kh) * hd;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * tc + 32 * jj + c;
        if (d < hd) {
          store(dk + row + d, dka[i][jj][c] * scale);
          store(dv + row + d, dva[i][jj][c]);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *lse, *d_o;
  void *dq, *dk, *dv;
  float* delta;
  int B, S, T, H, K, hd, causal, window;
  float scale;
  cudaStream_t stream;
  cudaEvent_t* events;  // null, or four events to record around the launches
};

// records events[i] on the stream, where the caller asked for them
cudaError_t mark(const Args& a, int i) {
  return a.events ? cudaEventRecord(a.events[i], a.stream) : cudaSuccess;
}

template <typename T>
cudaError_t launch_delta(const Args& a) {
  const int rows = a.B * a.S * a.H;
  const dim3 grid((rows + kThreads / 16 - 1) / (kThreads / 16));
  flash_bwd_delta_kernel<T><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.d_o), a.delta,
      rows, a.S, a.H, a.hd);
  return cudaGetLastError();
}

template <typename T, int HDP>
cudaError_t launch_simt(const Args& a) {
  constexpr size_t dq_smem = simt_dq_smem<HDP>();
  constexpr size_t kv_smem = simt_dkdv_smem<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_simt_kernel<T, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_simt_kernel<T, HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k);
  const T *v = static_cast<const T*>(a.v), *g = static_cast<const T*>(a.d_o);
  const float* lse = static_cast<const float*>(a.lse);
  const dim3 kv_grid(a.K, a.B, (a.T + kSK - 1) / kSK);
  flash_bwd_dkdv_simt_kernel<T, HDP><<<kv_grid, kThreads, kv_smem,
                                       a.stream>>>(
      q, k, v, g, lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.S, a.T, a.H, a.K, a.hd, a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(a, 2);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(a.H, a.B, (a.S + kSR - 1) / kSR);
  flash_bwd_dq_simt_kernel<T, HDP><<<dq_grid, kThreads, dq_smem,
                                     a.stream>>>(
      q, k, v, g, lse, a.delta, static_cast<T*>(a.dq), a.S, a.T, a.H, a.K,
      a.hd, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_route(const Args& a) {
  cudaError_t err = launch_delta<T>(a);
  if (err == cudaSuccess) err = mark(a, 1);
  if (err != cudaSuccess) return err;
  if (a.hd <= 32) return launch_simt<T, 32>(a);
  if (a.hd <= 64) return launch_simt<T, 64>(a);
  return launch_simt<T, 128>(a);
}

}  // namespace

// q, o, dO, dq [B, S, H, hd]; k, v, dk, dv [B, T, K, hd]; all contiguous,
// float32 (bf16 == 0) or bfloat16 (bf16 == 1), on CUDA device `device`;
// lse and delta [B, H, S] float32 (delta is written: D); H % K == 0,
// 1 <= hd <= 128. window <= 0 means no window. Launches three kernels on
// `stream` and returns the first CUDA error (0 when all three were
// accepted). `events`, where not null, holds four created events, recorded
// before D, after D, after dK / dV and after dQ, so a caller can time each
// launch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* d_o, void* dq, void* dk, void* dv,
    void* delta, int bf16, int B, int S, int T, int H, int K, int hd,
    int causal, int window, float scale, int device, void* stream,
    void* events) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (K < 1 || H % K != 0 || hd < 1 || hd > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, lse, d_o, dq, dk, dv, static_cast<float*>(delta), B, S,
         T, H, K, hd, causal, window, scale,
         static_cast<cudaStream_t>(stream), static_cast<cudaEvent_t*>(events)};
  cudaError_t err = mark(a, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bf16 ? launch_route<__nv_bfloat16>(a) : launch_route<float>(a);
  if (err == cudaSuccess) err = mark(a, 3);
  return static_cast<int>(err);
}
