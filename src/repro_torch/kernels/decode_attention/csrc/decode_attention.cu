// Split-KV decode-attention kernels for Hopper (sm_90a): the per-split
// partials, and the log-sum-exp combine of the splits as a second kernel,
// both launched by one call.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// _decode_kernel (launched by decode_attention_blocks) and the combine of
// ops.py::decode_attention, which the TPU path leaves to XLA. It computes
// the port's plain versions,
// src/repro_torch/kernels/decode_attention/ref.py::decode_partials_ref and
// ops.py::combine: for one query token per (batch, head) and each split of
// the KV cache, the partial max m, sum of exponentials l and exp-weighted
// sum of V, acc, over the split's slots whose absolute position k_pos
// satisfies 0 <= k_pos <= pos (ring-buffer slots never written are
// negative); then o = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s,
// 1e-30) with M = max_s m_s, in q's dtype. Scores are q . k * hd^-0.5 in
// float32, -1e30 where masked, as in the TPU kernel.
//
// Bound. Bytes: the whole K and V cache is read once per call, 34.6 MB per
// layer for the 8 x 1,056-slot qwen3-8b decode, 10.3 us at 3.35 TB/s; the
// arithmetic (4 G hd flops per slot) is far below any compute rate. So the
// design is about streaming the cache at the card's byte rate.
//
// Design. One block of 128 threads takes one (split, KV head, batch) and
// serves all G query heads of the KV head from one read of each slot, as the
// TPU grid's (b, h, kv-block) cannot. The cache stays in its own type: each
// thread moves 16-byte chunks of the rows with cp.async into a 3-stage ring
// of 32-slot tiles in shared memory (48 KB at bf16, hd 128), two tiles in
// flight ahead of the one in use; the wrapper's default split gives the
// card one wave of about 2 blocks per SM. Warp w copies and reads slots
// 8 w .. 8 w + 7 of every tile, so the ring needs no block barrier:
// cp.async.wait_group and __syncwarp are the only waits. Every warp runs
// its own online softmax over its slots (m, l and its slice of acc in
// float32 registers), updated once per tile; at the end the warps merge
// through shared memory and the block writes its split's partials. The
// combine kernel (one block per (batch, head)) is a programmatic dependent
// launch: it is set up while the partials kernel runs and waits in
// griddepcontrol.wait for its results.
//  - bf16 (the serving path): the products on the tensor cores (see
//    decode_attention_mma_kernel).
//  - float32 (jamba's float32 check): CUDA-core FMAs, a row of hd values
//    spread over hd / 4 lanes, the scores lane-group shuffle sums (see
//    decode_attention_kernel).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;     // KV slots per ring stage
constexpr int kStages = 3;    // ring depth
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotsPerWarp = kTile / kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes -> 4 floats
__device__ __forceinline__ void to_float(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// e^(m - m_new), 0 for a state that has seen no slot
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == -INFINITY ? 0.f : exp2f((m - m_new) * kLog2e);
}

// The end of a block, once the 4 warps' states are in shared memory
// (w_acc [kWarps][GM][HDP], w_m and w_l [kWarps][GM]): merge them into the
// split's partials and write those.
template <int HDP, int GM>
__device__ __forceinline__ void write_partials(
    const float* w_acc, const float* w_m, const float* w_l, int b, int kh,
    int split, int H, int K, int hd, int n_split, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out) {
  const int G = H / K;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    float mn = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mn = fmaxf(mn, w_m[w * GM + g]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = rescale(w_m[w * GM + g], mn);
      ls += w_l[w * GM + g] * c;
      as += w_acc[(w * GM + g) * HDP + d] * c;
    }
    const size_t bh = (size_t)b * H + (size_t)kh * G + g;
    acc_out[(bh * n_split + split) * hd + d] = as;
    if (d == 0) {
      m_out[bh * n_split + split] = mn;
      l_out[bh * n_split + split] = ls;
    }
  }
}

// The log-sum-exp combine of the splits (ops.py::combine): one block per
// (batch, head), one thread per dim.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ acc, T* __restrict__ o,
                          int n_split, int hd) {
  // launched dependent on the partials kernel: wait for its results
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  if (d >= hd) return;
  const float* mb = m + bh * n_split;
  const float* lb = l + bh * n_split;
  const float* ab = acc + bh * n_split * hd + d;
  float mn = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) mn = fmaxf(mn, mb[s]);
  float ls = 0.f, as = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const float c = exp2f((mb[s] - mn) * kLog2e);
    ls += lb[s] * c;
    as += ab[(size_t)s * hd] * c;
  }
  store(o + bh * hd + d, as / fmaxf(ls, 1e-30f));
}

// The float32 kernel (instantiated for T = float): CUDA-core FMAs. A row of
// hd values is spread over hd / 4 lanes (16-byte chunks of 4 values); each
// lane keeps q for its dims and all G heads in registers, the scores are
// lane-group shuffle sums, and every lane group runs its own online softmax
// over the slots it reads; the groups of a warp merge by shuffles at the
// end, then the warps through shared memory.
template <typename T, int HDP, int GM>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ k_pos, int pos, int Tk,
                            int H, int K, int hd, int chunk, int n_split,
                            float scale, float* __restrict__ m_out,
                            float* __restrict__ l_out,
                            float* __restrict__ acc_out) {
  constexpr int VEC = 16 / (int)sizeof(T);  // values per 16-byte chunk
  constexpr int LPR = HDP / VEC;            // lanes per cache row
  constexpr int RPW = 32 / LPR;             // rows a warp reads at once
  constexpr int PASSES = kSlotsPerWarp / RPW;
  static_assert(LPR <= 32 && kSlotsPerWarp % RPW == 0, "tile shape");
  extern __shared__ uint4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);  // [kStages][2][kTile][HDP]

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  const bool dim_ok = sub * VEC < hd;  // hd % VEC == 0
  const size_t kv_row = (size_t)K * hd;
  const int t_begin = split * chunk, t_end = min(Tk, t_begin + chunk);
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;

  // this thread's chunks of tile i: K and V of slot w*8 + p*RPW + grp
  auto issue = [&](int i) {
    const int t0 = t_begin + i * kTile;
    T* st = ring + (size_t)(i % kStages) * 2 * kTile * HDP;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int slot = warp * kSlotsPerWarp + p * RPW + grp, t = t0 + slot;
      if (t < t_end && dim_ok) {
        const size_t off = ((size_t)b * Tk + t) * kv_row +
                           (size_t)kh * hd + sub * VEC;
        cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(
                       st + slot * HDP + sub * VEC)),
                   k + off);
        cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(
                       st + (kTile + slot) * HDP + sub * VEC)),
                   v + off);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }
  // while the first tiles are in flight: q for this lane's dims and every
  // head, in float32, and the positions of tile 0
  float qf[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    uint4 u = make_uint4(0, 0, 0, 0);
    if (g < G && dim_ok)
      u = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * H + (size_t)kh * G + g) * hd + sub * VEC);
    to_float(u, qf[g]);
  }
  float m[GM], l[GM], acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // k_pos of this thread's slots in tile i (-1 past t_end), loaded a tile
  // ahead of its use
  auto positions = [&](int i, int (&kp)[PASSES]) {
    const int t0 = t_begin + i * kTile;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int t = t0 + warp * kSlotsPerWarp + p * RPW + grp;
      kp[p] = t < t_end ? __ldg(k_pos + t) : -1;
    }
  };
  int kp_cur[PASSES], kp_next[PASSES] = {};
  positions(0, kp_cur);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = 0; i < n_tiles; ++i) {
    if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
    cp_async_commit();
    if (i + 1 < n_tiles) positions(i + 1, kp_next);
    cp_async_wait<kStages - 1>();  // this thread's copies of tile i landed
    const int t0 = t_begin + i * kTile;
    const T* st = ring + (size_t)(i % kStages) * 2 * kTile * HDP;
    // the group's PASSES slots of this tile: scores for every head (a
    // dead slot past t_end reads -inf)
    float x[PASSES][GM];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int slot = warp * kSlotsPerWarp + p * RPW + grp;
      float kf[VEC];
      to_float(dim_ok ? *reinterpret_cast<const uint4*>(
                            st + slot * HDP + sub * VEC)
                      : zero,
               kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qf[g][e], kf[e], d);
        x[p][g] = d;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off /= 2)
#pragma unroll
      for (int p = 0; p < PASSES; ++p)
#pragma unroll
        for (int g = 0; g < GM; ++g)
          x[p][g] += __shfl_xor_sync(0xffffffffu, x[p][g], off);
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int t = t0 + warp * kSlotsPerWarp + p * RPW + grp;
      const bool ok = kp_cur[p] >= 0 && kp_cur[p] <= pos;
#pragma unroll
      for (int g = 0; g < GM; ++g)
        x[p][g] = t >= t_end ? -INFINITY : ok ? x[p][g] * scale : kNegInf;
    }
    // online softmax, once per tile: e^(x - m) as exp2 of a scaled
    // difference
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) mx = fmaxf(mx, x[p][g]);
      if (mx == -INFINITY) continue;  // no live slot for this group
      const float m_new = fmaxf(m[g], mx);
      const float c = rescale(m[g], m_new);
      float ps = 0.f;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        x[p][g] = exp2f((x[p][g] - m_new) * kLog2e);
        ps += x[p][g];
      }
      l[g] = fmaf(l[g], c, ps);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= c;
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int slot = warp * kSlotsPerWarp + p * RPW + grp;
      if (t0 + slot >= t_end) continue;  // uniform over a lane group
      float vf[VEC];
      to_float(dim_ok ? *reinterpret_cast<const uint4*>(
                            st + (kTile + slot) * HDP + sub * VEC)
                      : zero,
               vf);
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] = fmaf(x[p][g], vf[e], acc[g][e]);
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) kp_cur[p] = kp_next[p];
  }
  cp_async_wait<0>();

  // merge the lane groups of a warp (same dims, other slots)
#pragma unroll
  for (int off = LPR; off < 32; off *= 2)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float c1 = rescale(m[g], mn), c2 = rescale(mo, mn);
      l[g] = l[g] * c1 + lo * c2;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * c1 + ao * c2;
      }
      m[g] = mn;
    }

  // merge the warps through shared memory (the ring is free now)
  __syncthreads();
  float* w_acc = reinterpret_cast<float*>(smem4);  // [kWarps][GM][HDP]
  float* w_m = w_acc + kWarps * GM * HDP;           // [kWarps][GM]
  float* w_l = w_m + kWarps * GM;
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        w_acc[(warp * GM + g) * HDP + sub * VEC + e] = acc[g][e];
      if (sub == 0) {
        w_m[warp * GM + g] = m[g];
        w_l[warp * GM + g] = l[g];
      }
    }
  }
  __syncthreads();
  write_partials<HDP, GM>(w_acc, w_m, w_l, b, kh, split, H, K, hd, n_split,
                          m_out, l_out, acc_out);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes where !full (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst,
                                                 const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b: a [16 x 16] bf16 (row), b [16 x 8] bf16 (col), c float32
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: a [16 x 8] bf16 (row), b [8 x 8] bf16 (col), c float32
__device__ __forceinline__ void mma_m16n8k8(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x - (x rounded to bf16), for both halves of a packed pair
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi,
                                                   uint32_t rounded) {
  const float2 r =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rounded));
  return pack_bf16(lo - r.x, hi - r.y);
}

// The bf16 kernel: the same blocks, ring and tail as the float32 one, with
// the products on the tensor cores (mma.sync; the G query heads of a KV
// head padded to the 16 rows of the A operand). Warp w copies and reads
// slots 8 w .. 8 w + 7 of every tile; a row's 16-byte chunks are XOR-
// swizzled by slot % 8 in shared memory, so ldmatrix reads them without
// bank conflicts (chunks past hd and slots past the split are zero-filled).
// Per tile a warp computes S [16 x 8] = Q K^T (hd / 16 m16n8k16), masks
// it, runs one online-softmax step per row (quad shuffles), and adds P V
// to O [16 x hd] (hd / 8 pairs of m16n8k8): P is split into a bf16 part and
// a bf16 remainder, so that P keeps 16 bits and the partials stay within
// float32 rounding of the plain version's.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 3)
    decode_attention_mma_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, const int* __restrict__ k_pos,
        int pos, int Tk, int H, int K, int hd, int chunk, int n_split,
        float scale, float* __restrict__ m_out, float* __restrict__ l_out,
        float* __restrict__ acc_out) {
  constexpr int CH = HDP / 8;   // 16-byte chunks per cache row
  constexpr int KS = HDP / 16;  // k-steps of Q K^T
  constexpr int NT = HDP / 8;   // 8-column tiles of O
  constexpr int PER_LANE = kSlotsPerWarp * CH / 32;
  constexpr int GM = 16;        // rows of the A operand
  extern __shared__ uint4 smem4[];
  const uint32_t ring = smem_u32(smem4);  // [kStages][2][kTile][CH] chunks

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g0 = lane / 4, c2 = 2 * (lane % 4);  // fragment row, column
  const size_t kv_row = (size_t)K * hd;
  const int t_begin = split * chunk, t_end = min(Tk, t_begin + chunk);
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;

  // shared address of logical chunk c of row `slot`, K (kv 0) or V (kv 1)
  auto chunk_at = [&](int st, int kv, int slot, int c) -> uint32_t {
    return ring + (uint32_t)((((st * 2 + kv) * kTile + slot) * CH +
                              (c ^ (slot & 7))) * 16);
  };
  auto issue = [&](int i) {
    const int t0 = t_begin + i * kTile, st = i % kStages;
#pragma unroll
    for (int r = 0; r < PER_LANE; ++r) {
      const int j = lane + 32 * r;
      const int slot = warp * kSlotsPerWarp + j / CH, c = j % CH;
      const int t = t0 + slot;
      const bool full = t < t_end && c * 8 < hd;
      const size_t off =
          full ? ((size_t)b * Tk + t) * kv_row + (size_t)kh * hd + c * 8 : 0;
      cp_async16_zfill(chunk_at(st, 0, slot, c), k + off, full);
      cp_async16_zfill(chunk_at(st, 1, slot, c), v + off, full);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }
  // while the first tiles are in flight: q as the A operand (rows g0 and
  // g0 + 8, zero past G and hd), and the positions of tile 0
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int g = g0 + 8 * (r & 1), d = 16 * kk + c2 + 8 * (r >> 1);
      qa[kk][r] =
          g < G && d < hd
              ? *reinterpret_cast<const uint32_t*>(
                    q + ((size_t)b * H + (size_t)kh * G + g) * hd + d)
              : 0u;
    }
  // k_pos of this lane's two score columns in tile i (-1 past t_end)
  auto positions = [&](int i, int (&kp)[2]) {
    const int t = t_begin + i * kTile + warp * kSlotsPerWarp + c2;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      kp[e] = t + e < t_end ? __ldg(k_pos + t + e) : -1;
  };
  int kp_cur[2], kp_next[2] = {-1, -1};
  positions(0, kp_cur);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, oacc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) oacc[nt][r] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
    cp_async_commit();
    if (i + 1 < n_tiles) positions(i + 1, kp_next);
    cp_async_wait<kStages - 1>();
    __syncwarp();  // the warp's copies of tile i are in, all lanes'
    const int st = i % kStages, t0 = t_begin + i * kTile;
    const int row = warp * kSlotsPerWarp + (lane & 7);  // ldmatrix row

    // S [16 x 8]: sc[0], sc[1] row g0, sc[2], sc[3] row g0 + 8; columns
    // (slots) c2, c2 + 1 of the warp's 8
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
      uint32_t bk[4];
      ldsm_x4(chunk_at(st, 0, row, 2 * kk + (lane >> 3)), bk);
      mma_m16n8k16(sc, qa[kk], bk[0], bk[1]);
      mma_m16n8k16(sc, qa[kk + 1], bk[2], bk[3]);
    }
    const int t = t0 + warp * kSlotsPerWarp + c2;
    float pr[4], corr[2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kp_cur[e] >= 0 && kp_cur[e] <= pos;
        x[e] = t + e >= t_end ? -INFINITY
                              : ok ? sc[2 * ii + e] * scale : kNegInf;
      }
      float mx = fmaxf(x[0], x[1]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[ii], mx);
      corr[ii] = rescale(m[ii], m_new);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        pr[2 * ii + e] = m_new == -INFINITY
                             ? 0.f
                             : exp2f((x[e] - m_new) * kLog2e);
      float ps = pr[2 * ii] + pr[2 * ii + 1];
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[ii] = fmaf(l[ii], corr[ii], ps);
      m[ii] = m_new;
    }
    // O = corr O + P V, P as a bf16 part and a bf16 remainder
    const uint32_t ph0 = pack_bf16(pr[0], pr[1]);
    const uint32_t ph1 = pack_bf16(pr[2], pr[3]);
    const uint32_t pl0 = pack_bf16_rest(pr[0], pr[1], ph0);
    const uint32_t pl1 = pack_bf16_rest(pr[2], pr[3], ph1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      oacc[nt][0] *= corr[0];
      oacc[nt][1] *= corr[0];
      oacc[nt][2] *= corr[1];
      oacc[nt][3] *= corr[1];
    }
#pragma unroll
    for (int n4 = 0; n4 < NT; n4 += 4) {
      uint32_t bv[4];
      ldsm_x4_trans(chunk_at(st, 1, row, n4 + (lane >> 3)), bv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_m16n8k8(oacc[n4 + j], ph0, ph1, bv[j]);
        mma_m16n8k8(oacc[n4 + j], pl0, pl1, bv[j]);
      }
    }
    kp_cur[0] = kp_next[0];
    kp_cur[1] = kp_next[1];
  }
  cp_async_wait<0>();

  // merge the warps through shared memory (the ring is free now)
  __syncthreads();
  float* w_acc = reinterpret_cast<float*>(smem4);  // [kWarps][GM][HDP]
  float* w_m = w_acc + kWarps * GM * HDP;           // [kWarps][GM]
  float* w_l = w_m + kWarps * GM;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w_acc[(warp * GM + g0 + 8 * (r >> 1)) * HDP + 8 * nt + c2 + (r & 1)] =
          oacc[nt][r];
  if (lane % 4 == 0) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      w_m[warp * GM + g0 + 8 * ii] = m[ii];
      w_l[warp * GM + g0 + 8 * ii] = l[ii];
    }
  }
  __syncthreads();
  write_partials<HDP, GM>(w_acc, w_m, w_l, b, kh, split, H, K, hd, n_split,
                          m_out, l_out, acc_out);
}

template <typename T, int HDP, int GM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* k_pos, int pos, int B, int Tk, int H, int K,
                   int hd, int chunk, int n_split, float scale, float* m,
                   float* l, float* acc, cudaStream_t stream) {
  constexpr int kRing = kStages * 2 * kTile * HDP * (int)sizeof(T);
  constexpr int kMerge = kWarps * GM * (HDP + 2) * (int)sizeof(float);
  constexpr size_t smem = kRing > kMerge ? kRing : kMerge;
  auto kern = decode_attention_kernel<T, HDP, GM>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_split, K, B), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), k_pos, pos, Tk, H, K, hd, chunk, n_split,
      scale, m, l, acc);
  return cudaGetLastError();
}

// bf16: the tensor-core kernel
template <int HDP>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* k_pos, int pos, int B, int Tk, int H, int K,
                       int hd, int chunk, int n_split, float scale, float* m,
                       float* l, float* acc, cudaStream_t stream) {
  constexpr int kRing = kStages * 2 * kTile * HDP * 2;
  constexpr int kMerge = kWarps * 16 * (HDP + 2) * (int)sizeof(float);
  constexpr size_t smem = kRing > kMerge ? kRing : kMerge;
  auto kern = decode_attention_mma_kernel<HDP>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_split, K, B), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), k_pos, pos, Tk, H, K, hd, chunk,
      n_split, scale, m, l, acc);
  return cudaGetLastError();
}

// float32: the CUDA-core kernel, by head_dim and query heads per KV head
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const int* k_pos, int pos, int B, int Tk, int H,
                        int K, int hd, int chunk, int n_split, float scale,
                        float* m, float* l, float* acc, cudaStream_t st) {
  const int G = H / K;
#define DECODE_LAUNCH(HDP, GM)                                               \
  return launch<float, HDP, GM>(q, k, v, k_pos, pos, B, Tk, H, K, hd, chunk, \
                                n_split, scale, m, l, acc, st)
#define DECODE_LAUNCH_G(HDP)          \
  if (G <= 1) DECODE_LAUNCH(HDP, 1);  \
  if (G <= 2) DECODE_LAUNCH(HDP, 2);  \
  if (G <= 4) DECODE_LAUNCH(HDP, 4);  \
  if (G <= 8) DECODE_LAUNCH(HDP, 8);  \
  DECODE_LAUNCH(HDP, 16)
  if (hd <= 64) {
    DECODE_LAUNCH_G(64);
  }
  DECODE_LAUNCH_G(128);
#undef DECODE_LAUNCH_G
#undef DECODE_LAUNCH
}

// decode_combine_kernel as a programmatic dependent launch: its grid is set
// up while the partials kernel runs and waits in griddepcontrol.wait for
// its results
template <typename T>
cudaError_t launch_combine(const float* m, const float* l, const float* acc,
                           void* o, int B, int H, int hd, int n_split,
                           cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3((hd + 31) / 32 * 32);
  cfg.stream = st;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>, m, l, acc,
                            static_cast<T*>(o), n_split, hd);
}

}  // namespace

// q, o [B, H, hd]; k, v [B, T, K, hd], float32 (bf16 == 0) or bfloat16
// (bf16 == 1), 16-byte aligned; k_pos [T] int32; m, l [B, H, n_split] and
// acc [B, H, n_split, hd] float32; all contiguous on CUDA device `device`.
// H % K == 0, H / K <= 16, hd <= 128 a multiple of 16 bytes' worth of
// values, n_split = ceil(T / chunk). Launches the partials kernel and the
// combine kernel on `stream` and returns the CUDA error of the launches (0
// when both were accepted; cudaErrorInvalidValue for a shape they do not
// take).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* k_pos,
                                       int pos, int bf16, int B, int T,
                                       int H, int K, int hd, int chunk,
                                       int n_split, float scale, float* m,
                                       float* l, float* acc, void* o,
                                       int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int vec = bf16 ? 8 : 4;
  if (K < 1 || H % K != 0 || H / K > 16 || hd < 1 || hd > 128 ||
      hd % vec != 0 || chunk < 1 || n_split != (T + chunk - 1) / chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? (hd <= 64 ? launch_mma<64>(q, k, v, k_pos, pos, B, T, H, K, hd,
                                        chunk, n_split, scale, m, l, acc, st)
                       : launch_mma<128>(q, k, v, k_pos, pos, B, T, H, K, hd,
                                         chunk, n_split, scale, m, l, acc,
                                         st))
           : launch_simt(q, k, v, k_pos, pos, B, T, H, K, hd, chunk, n_split,
                         scale, m, l, acc, st);
  if (err == cudaSuccess)
    err = bf16 ? launch_combine<__nv_bfloat16>(m, l, acc, o, B, H, hd,
                                               n_split, st)
               : launch_combine<float>(m, l, acc, o, B, H, hd, n_split, st);
  return static_cast<int>(err);
}
