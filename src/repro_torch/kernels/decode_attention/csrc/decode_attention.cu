// Split-KV decode-attention kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// _decode_kernel (launched by decode_attention_blocks; combine in
// ops.py::decode_attention). It computes the port's plain version,
// src/repro_torch/kernels/decode_attention/ref.py::decode_partials_ref:
// for one query token per (batch, head) and each split of the KV cache,
// the partial max m, sum of exponentials l and exp-weighted sum of V, acc,
// over the split's slots whose absolute position k_pos satisfies
// 0 <= k_pos <= pos (ring-buffer slots never written are negative). Scores
// are q . k * hd^-0.5 in float32, -1e30 where masked, as in the TPU kernel.
// The log-sum-exp combine of the splits stays in PyTorch (ops.py), as the
// reference keeps it outside pallas_call.
//
// Design. The TPU grid (b, h, kv-block) reads each KV head's block once
// for each of its G = H / K query heads. Here one thread block takes one
// (batch, KV head, split) and serves all G query heads from one staging of
// each 64-slot K and V tile in shared memory (float32; bf16 is widened on
// the way in), so the cache is read from device memory once. Within the
// split it runs an online softmax over the tiles (m, l per head in shared
// memory, acc [G, hd] in shared memory), which equals the TPU kernel's
// one-shot partial over the same slots. Slots past the end of the cache
// (a ragged last split) are -inf and contribute exactly 0. `pos` is a
// plain int argument (no scalar prefetch is needed). The model's
// [B, T, K, hd] cache layout is read directly.
//
// Bound. Bytes: the whole K and V cache is read once per call, e.g.
// 34.6 MB per layer for the 8 x 1,056-slot qwen3-8b decode, about 10 us at
// 3.35 TB/s; the arithmetic (2 G hd flops per slot per product) is far
// below the fp32 rate. The number of splits is chosen by the wrapper so
// that about two blocks per SM are in flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;      // KV slots per staged tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int HDP>
size_t smem_bytes(int G) {
  // Q [G][LD], K and V tiles [kTile][LD], P [G][kTile], acc [G][HDP],
  // m, l, corr [G]
  const size_t LD = HDP + 4;
  return sizeof(float) * (G * LD + 2 * kTile * LD + (size_t)G * kTile +
                          (size_t)G * HDP + 3 * (size_t)G);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
    decode_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ k_pos, int pos, int Tk,
                           int H, int K, int hd, int chunk, int n_split,
                           float scale, float* __restrict__ m_out,
                           float* __restrict__ l_out,
                           float* __restrict__ acc_out) {
  constexpr int LD = HDP + 4;  // float4-aligned, staggers the banks
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + G * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;
  float* Acc = Ps + G * kTile;
  float* Ms = Acc + G * HDP;
  float* Ls = Ms + G;
  float* Cs = Ls + G;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t kv_row = (size_t)K * hd;
  const int t_begin = split * chunk, t_end = min(Tk, t_begin + chunk);

  for (int i = tid; i < G * HDP; i += kThreads) {
    const int g = i / HDP, d = i % HDP;
    Qs[g * LD + d] =
        d < hd ? to_f(q[((size_t)b * H + (size_t)kh * G + g) * hd + d]) : 0.f;
    Acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    __syncthreads();  // Q staged / the last tile's P V done with Ks, Vs
    for (int i = tid; i < kTile * HDP; i += kThreads) {
      const int r = i / HDP, d = i % HDP;
      float kx = 0.f, vx = 0.f;
      if (t0 + r < t_end && d < hd) {
        const size_t off =
            ((size_t)b * Tk + t0 + r) * kv_row + (size_t)kh * hd + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      Ks[r * LD + d] = kx;
      Vs[r * LD + d] = vx;
    }
    __syncthreads();

    // scores, one (head, slot) per thread at a time
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, r = i % kTile, t = t0 + r;
      float s = 0.f;
#pragma unroll 4
      for (int d = 0; d < HDP; d += 4) {
        const float4 qq = ld4(&Qs[g * LD + d]), kk = ld4(&Ks[r * LD + d]);
        s = fmaf(qq.x, kk.x, s);
        s = fmaf(qq.y, kk.y, s);
        s = fmaf(qq.z, kk.z, s);
        s = fmaf(qq.w, kk.w, s);
      }
      float x = -INFINITY;  // past the end: exactly 0 below
      if (t < t_end) {
        const int kp = k_pos[t];
        x = (kp >= 0 && kp <= pos) ? s * scale : kNegInf;
      }
      Ps[g * kTile + r] = x;
    }
    __syncthreads();

    // online softmax over the tiles, one warp per head at a time
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int r = lane; r < kTile; r += 32) mx = fmaxf(mx, Ps[g * kTile + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g], m_new = fmaxf(m_old, mx);
      float ps = 0.f;
      for (int r = lane; r < kTile; r += 32) {
        const float p = expf(Ps[g * kTile + r] - m_new);
        Ps[g * kTile + r] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Ls[g] = corr * Ls[g] + ps;
        Ms[g] = m_new;
        Cs[g] = corr;
      }
    }
    __syncthreads();

    // acc = corr * acc + P V, one (head, dim) per thread at a time
    for (int i = tid; i < G * HDP; i += kThreads) {
      const int g = i / HDP, d = i % HDP;
      float a = Acc[i] * Cs[g];
#pragma unroll 8
      for (int r = 0; r < kTile; ++r)
        a = fmaf(Ps[g * kTile + r], Vs[r * LD + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * HDP; i += kThreads) {
    const int g = i / HDP, d = i % HDP;
    const size_t bh = (size_t)b * H + (size_t)kh * G + g;
    if (d < hd) acc_out[(bh * n_split + split) * hd + d] = Acc[i];
    if (d == 0) {
      m_out[bh * n_split + split] = Ms[g];
      l_out[bh * n_split + split] = Ls[g];
    }
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* k_pos, int pos, int B, int Tk, int H, int K,
                   int hd, int chunk, int n_split, float scale, float* m,
                   float* l, float* acc, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>(H / K);
  auto kern = decode_partials_kernel<T, HDP>;
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid(n_split, K, B), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), k_pos, pos, Tk, H, K, hd, chunk, n_split,
      scale, m, l, acc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const int* k_pos, int pos, int B, int Tk, int H, int K,
                      int hd, int chunk, int n_split, float scale, float* m,
                      float* l, float* acc, cudaStream_t st) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, k_pos, pos, B, Tk, H, K, hd, chunk,
                         n_split, scale, m, l, acc, st);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, k_pos, pos, B, Tk, H, K, hd, chunk,
                         n_split, scale, m, l, acc, st);
  return launch<T, 128>(q, k, v, k_pos, pos, B, Tk, H, K, hd, chunk,
                        n_split, scale, m, l, acc, st);
}

}  // namespace

// q [B, H, hd]; k, v [B, T, K, hd], float32 (bf16 == 0) or bfloat16
// (bf16 == 1); k_pos [T] int32; m, l [B, H, n_split] and acc
// [B, H, n_split, hd] float32; all contiguous on CUDA device `device`;
// H % K == 0, 1 <= hd <= 128, n_split = ceil(T / chunk). Launches on
// `stream` and returns the CUDA error of the launch (0 when accepted).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* k_pos,
                                       int pos, int bf16, int B, int T,
                                       int H, int K, int hd, int chunk,
                                       int n_split, float scale, float* m,
                                       float* l, float* acc, int device,
                                       void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_hd<__nv_bfloat16>(q, k, v, k_pos, pos, B, T, H, K, hd,
                                      chunk, n_split, scale, m, l, acc, st)
           : launch_hd<float>(q, k, v, k_pos, pos, B, T, H, K, hd, chunk,
                              n_split, scale, m, l, acc, st);
  return static_cast<int>(err);
}
