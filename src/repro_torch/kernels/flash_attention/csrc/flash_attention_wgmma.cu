// Flash-attention forward kernel for Hopper (sm_90a) on the tensor cores:
// bf16 inputs, head_dim a multiple of 8 up to 128.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _fwd_kernel (launched by flash_attention_fwd; public op ops.py::
// flash_attention) for bf16, as kernel.py::route sends it here; float32
// keeps the SIMT kernel of flash_attention.cu. It computes the port's plain
// version, src/repro_torch/kernels/flash_attention/ref.py::attention_ref:
// causal and/or sliding-window GQA attention, query head h reading KV head
// h / (H / K), positions 0..S-1 (queries) and 0..T-1 (keys), scores scaled
// by hd^-0.5 and masked to -1e30, softmax, the probabilities rounded to
// bf16 for the P V product (as the plain version's p.to(v.dtype)), the
// weighted sum of V accumulated in float32.
//
// Bound. The QK^T and PV products, 4 B H hd S(S+1)/2 flops for causal
// attention, against the bf16 tensor-core rate: 0.070 ms for the 8 x
// 1,024-token qwen3-8b prefill per layer, where the bytes (q, k, v read
// once, o written once) take 0.050 ms. So operations bound it, and only
// wgmma reaches that rate.
//
// Design. One block takes one (head, batch, 128-row query tile); the query
// tiles are walked last first (blockIdx.z reversed), so the longest causal
// tiles start first and the short ones fill in behind them. 384 threads:
// consumer warpgroups 0 and 1 own query rows 0-63 and 64-127 of the tile,
// warpgroup 2 is the producer, whose one elected thread issues TMA loads
// (setmaxnreg moves registers from it to the consumers: 40 / 232).
//  - TMA: 4-D tensor maps over the model's [B, S, H, hd] and [B, T, K, hd]
//    layouts (no transposes); GQA is the KV-head coordinate h / G of the
//    box. A box is 64 columns x 128 rows with the 128-byte swizzle, so head
//    dim 128 is two 64-column slabs; columns past hd (hd 120) and rows past
//    S or T read as zeros. Q is loaded once; K and V come through a 3-stage
//    ring of 128-key tiles with full / empty mbarriers and expect_tx byte
//    counts (hd 128: Q 32 KB + 3 x (32 + 32) KB = 224 KB of shared memory).
//  - S = Q K^T: wgmma m64n128k16, A (Q) and B (K) both K-major in shared
//    memory, 4 k-steps per slab.
//  - Online softmax in the accumulator's register layout: a thread holds
//    rows r and r + 8 of its warp's 16; a row's max and sum are quad
//    shuffles; the scores stay unscaled, so e^(scale (s - m)) is one FFMA
//    and one ex2. Masking follows the TPU kernel: masked scores are -1e30
//    (scaled), not -inf, so a row whose first visited KV tile is fully
//    masked (a sliding window) accumulates exp(0) = 1 terms that a later
//    real score wipes with corr = exp(-1e30 - m) = 0; keys past T are -inf
//    and add exactly 0. Only tiles that cross the diagonal, the window edge
//    or T are masked; tiles wholly outside the band are skipped.
//  - O += P V: wgmma m64n64k16 per slab, A = P rounded to bf16 from
//    registers (the S accumulator's layout is the A operand's), B = V in
//    shared memory read MN-major through the transpose bit. m, l and O stay
//    in float32 registers.
//  - Overlap: a warpgroup issues S of tile i + 1 together with P_i V_i and
//    runs the softmax of tile i + 1 while P_i V_i is on the tensor cores;
//    the two warpgroups take turns to issue (pingpong, on named barriers),
//    so that one's softmax runs while the other's products do. The softmax
//    was the half of the time that did not overlap before (PERF.md).
//  - Epilogue: O / max(l, 1e-30), rounded to bf16, stored straight from
//    registers (rows past S and columns past hd are not stored). Given an
//    lse pointer (the training forward; serving passes none), it also
//    stores each row's natural log-sum-exp, scale m + log(l), [B, H, S]
//    float32, for the backward (flash_attention_bwd.cu); m and l are the
//    final ones, after any tile of mask values was wiped.
// The tensor map encoder is the driver's cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so the library links no libcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                // query rows per block
constexpr int kBN = 128;                // keys per K / V tile
constexpr int kSlab = 64;               // bf16 columns per swizzled box
constexpr int kSlabBytes = 128 * 128;   // 128 rows x 128 bytes
constexpr int kStages = 3;              // K / V ring depth
constexpr int kThreads = 384;           // 2 consumer + 1 producer warpgroup
constexpr int kConsumerWarps = 8;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Barriers {
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile whose rows
// are 128 bytes: start address, leading byte offset 16 (not read: each
// operand spans one swizzle atom along it), stride byte offset 1024 (8 rows
// of 128 bytes), layout 128B swizzle. The tile base is 1024-aligned; a
// K-major operand's k-step moves the start by 32 bytes inside the atom,
// an MN-major one's by 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator registers across the
// asynchronous wgmma issue / wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online softmax for a thread's two rows. The scores stay raw
// (q . k, unscaled; masked scores are -1e30 / scale, i.e. -1e30 once
// scaled) and m with them, so e^(scale (s - m)) is one FFMA and one ex2,
// ex2(s sl2 - m sl2) with sl2 = scale log2(e), in a tile that masks
// nothing (m is then a real score's). Masks s [4 j + 2 ii + c]
// (row r0 + 8 ii, key t0 + 8 j + cq + c) in place, turns it into
// e^(scale (s - m_new)), and updates m and l; returns the factor corr by
// which the rows' O must be rescaled.
__device__ __forceinline__ void online_softmax(
    float (&s)[64], float (&m_i)[2], float (&l_i)[2], float (&corr)[2],
    bool edge, int r0, int t0, int cq, int causal, int window, int Tk,
    float sl2, float neg_raw) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int idx = 0; idx < 64; ++idx) {
    const int ii = (idx >> 1) & 1;
    if (edge) {
      const int qi = r0 + 8 * ii;
      const int kj = t0 + 8 * (idx >> 2) + cq + (idx & 1);
      const bool valid =
          (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
      if (!valid) s[idx] = neg_raw;
      if (kj >= Tk) s[idx] = -INFINITY;  // past the end: exactly 0 below
    }
    mx[ii] = fmaxf(mx[ii], s[idx]);
  }
  float msl[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 1));
    mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 2));
    const float m_new = fmaxf(m_i[ii], mx[ii]);
    corr[ii] = ex2((m_i[ii] - m_new) * sl2);
    m_i[ii] = m_new;
    msl[ii] = m_new * sl2;
  }
  if (edge) {
    // m may be the mask value here, where s sl2 - m sl2 would read the
    // rounding error of a 1e30-sized product: subtract first
#pragma unroll
    for (int idx = 0; idx < 64; ++idx) {
      const int ii = (idx >> 1) & 1;
      s[idx] = ex2((s[idx] - m_i[ii]) * sl2);
      ps[ii] += s[idx];
    }
  } else {
#pragma unroll
    for (int idx = 0; idx < 64; ++idx) {
      const int ii = (idx >> 1) & 1;
      s[idx] = ex2(fmaf(s[idx], sl2, -msl[ii]));
      ps[ii] += s[idx];
    }
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    ps[ii] += __shfl_xor_sync(0xffffffffu, ps[ii], 1);
    ps[ii] += __shfl_xor_sync(0xffffffffu, ps[ii], 2);
    l_i[ii] = corr[ii] * l_i[ii] + ps[ii];
  }
}

// Named barriers 1 and 2 (0 is __syncthreads') order the two consumer
// warpgroups' turns at the tensor cores.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// d (+)= A B, A [64 x 16] and B [16 x 128] from shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, A [64 x 16] bf16 from registers, B [16 x 64] from shared
// memory stored MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int S, int Tk,
                           int H, int K, int hd, int causal, int window,
                           float scale) {
  constexpr int NS = HDP / kSlab;                // 64-column slabs
  constexpr int kTileBytes = NS * kSlabBytes;    // one Q, K or V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers bars;
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + kTileBytes;
  const uint32_t sV = sK + kStages * kTileBytes;

  const int h = blockIdx.x, b = blockIdx.y, kh = h / (H / K);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // last tiles first
  const int q_last = min(q0 + kBM, S) - 1;
  // KV tiles that can hold an unmasked key for some row of this tile
  const int t_end = causal ? min(Tk, q_last + 1) : Tk;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / kBN * kBN : 0;
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kBN - 1) / kBN : 0;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(smem_u32(&bars.q_full), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&bars.k_full[s]), 1);
      mbar_init(smem_u32(&bars.v_full[s]), 1);
      mbar_init(smem_u32(&bars.empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      const uint32_t qf = smem_u32(&bars.q_full);
      mbar_expect_tx(qf, kTileBytes);
#pragma unroll
      for (int s = 0; s < NS; ++s)
        tma_load_4d(sQ + s * kSlabBytes, &tm_q, qf, s * kSlab, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, t0 = t_begin + i * kBN;
        if (i >= kStages)  // the consumers are done with this stage's last fill
          mbar_wait(smem_u32(&bars.empty[st]), ((i / kStages) - 1) & 1);
        const uint32_t kf = smem_u32(&bars.k_full[st]);
        const uint32_t vf = smem_u32(&bars.v_full[st]);
        mbar_expect_tx(kf, kTileBytes);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          tma_load_4d(sK + st * kTileBytes + s * kSlabBytes, &tm_k, kf,
                      s * kSlab, kh, t0, b);
        mbar_expect_tx(vf, kTileBytes);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          tma_load_4d(sV + st * kTileBytes + s * kSlabBytes, &tm_v, vf,
                      s * kSlab, kh, t0, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows wg * 64 .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int rw0 = q0 + wg * 64;                    // the warpgroup's rows
    const int r0 = rw0 + warp * 16 + lane / 4;       // rows r0 and r0 + 8
    const int cq = 2 * (lane % 4);                   // column pair in an 8
    const float sl2 = scale * kLog2e, neg_raw = kNegInf / scale;
    float oacc[NS][32], s[64];
    uint32_t p[kBN / 16][4];  // P in bf16: the A operand of 8 k-steps
#pragma unroll
    for (int ns = 0; ns < NS; ++ns)
#pragma unroll
      for (int j = 0; j < 32; ++j) oacc[ns][j] = 0.f;
#pragma unroll
    for (int j = 0; j < 64; ++j) s[j] = 0.f;
    float m_i[2] = {neg_raw, neg_raw};
    float l_i[2] = {0.f, 0.f}, corr[2];

    // S = Q K^T of tile i for the warpgroup's 64 rows x 128 keys, issued
    // and committed as one group
    auto issue_s = [&](int i) {
      const int st = i % kStages;
      mbar_wait(smem_u32(&bars.k_full[st]), (i / kStages) & 1);
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int ns = 0; ns < NS; ++ns)
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk)
          wgmma_ss_m64n128(
              s, sw128_desc(sQ + ns * kSlabBytes + wg * 64 * 128 + kk * 32),
              sw128_desc(sK + st * kTileBytes + ns * kSlabBytes + kk * 32),
              (ns | kk) != 0);
      wgmma_commit();
    };
    auto softmax = [&](int i) {
      const int t0 = t_begin + i * kBN;
      // only tiles that cross the diagonal, the window edge or T are masked
      const bool edge = (causal && t0 + kBN - 1 > rw0) ||
                        (window > 0 && rw0 + 63 - t0 >= window) ||
                        t0 + kBN > Tk;
      online_softmax(s, m_i, l_i, corr, edge, r0, t0, cq, causal, window,
                     Tk, sl2, neg_raw);
    };
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int ns = 0; ns < NS; ++ns)
#pragma unroll
        for (int j = 0; j < 32; ++j) oacc[ns][j] *= corr[(j >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };

    // O += P_i V_i, issued and committed as one group
    auto issue_pv = [&](int i) {
      const int st = i % kStages;
      mbar_wait(smem_u32(&bars.v_full[st]), (i / kStages) & 1);
#pragma unroll
      for (int ns = 0; ns < NS; ++ns) reg_fence(oacc[ns]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int ns = 0; ns < NS; ++ns)
          wgmma_rs_m64n64_tb(
              oacc[ns], p[kk],
              sw128_desc(sV + st * kTileBytes + ns * kSlabBytes +
                         kk * 16 * 128));
      wgmma_commit();
    };
    // P_i V_i is done: O, P and the stage of tile i are free
    auto retire_pv = [&](int i) {
      wgmma_wait<0>();
      reg_fence(s);
#pragma unroll
      for (int ns = 0; ns < NS; ++ns) reg_fence(oacc[ns]);
      if (lane == 0) mbar_arrive(smem_u32(&bars.empty[i % kStages]));
    };
    // The warpgroups take turns to issue their products (pingpong): one
    // runs its softmax while the other's wgmmas occupy the tensor cores.
    // A warpgroup waits for its turn on barrier 1 + wg and hands the turn
    // on at barrier 2 - wg; warpgroup 1 first hands warpgroup 0 its first
    // turn, and skips the hand-on after its last one, so every sync has
    // its matching arrivals.
    const int n_turns = n_tiles > 0 ? n_tiles + 1 : 0;
    int turn = 0;
    auto take_turn = [&]() { named_sync(1 + wg); };
    auto pass_turn = [&]() {
      if (wg == 0 || ++turn < n_turns) named_arrive(2 - wg);
    };
    if (wg == 1 && n_turns > 0) named_arrive(1);

    mbar_wait(smem_u32(&bars.q_full), 0);
    if (n_tiles > 0) {
      take_turn();
      issue_s(0);
      pass_turn();
      wgmma_wait<0>();
      reg_fence(s);
      softmax(0);
      rescale_and_pack();
    }
    // Tile i < n - 1: S of tile i + 1 and O += P_i V_i go to the tensor
    // cores together; the softmax of tile i + 1 runs while P_i V_i does,
    // and O is rescaled and P repacked once it is done. The last tile is
    // peeled off, so that every wait below sees the same groups in flight.
    for (int i = 0; i + 1 < n_tiles; ++i) {
      take_turn();
      issue_s(i + 1);
      issue_pv(i);
      pass_turn();
      wgmma_wait<1>();  // S of tile i + 1 is in
      reg_fence(s);
      softmax(i + 1);
      retire_pv(i);
      rescale_and_pack();
    }
    if (n_tiles > 0) {
      take_turn();
      issue_pv(n_tiles - 1);
      pass_turn();
      retire_pv(n_tiles - 1);
    }

    // O / l, rounded to bf16; oacc[ns][4 j + 2 ii + c] is row r0 + 8 ii,
    // column 64 ns + 8 j + cq + c
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int qi = r0 + 8 * ii;
      if (qi >= S) continue;
      const float inv = 1.f / fmaxf(l_i[ii], 1e-30f);
      if (lse != nullptr && (lane & 3) == 0)
        lse[((size_t)b * H + h) * S + qi] = scale * m_i[ii] + logf(l_i[ii]);
      __nv_bfloat16* orow = o + ((size_t)b * S + qi) * H * hd + (size_t)h * hd;
#pragma unroll
      for (int ns = 0; ns < NS; ++ns)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = ns * kSlab + 8 * j + cq;
          if (col < hd)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(oacc[ns][4 * j + 2 * ii] * inv,
                                      oacc[ns][4 * j + 2 * ii + 1] * inv);
        }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no libcuda
// link)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a contiguous bf16 [n3, n2, n1, hd] tensor (the model's
// [B, rows, heads, hd]); box 64 columns x 1 head x 128 rows x 1 batch,
// 128-byte swizzle, zeros outside the tensor.
bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int hd,
              int heads, int rows, int batch) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t row = (cuuint64_t)hd * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * rows};
  const cuuint32_t box[4] = {kSlab, 1, kBM, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, void* o, float* lse, int B,
                   int S, int Tk,
                   int H, int K, int hd, int causal, int window, float scale,
                   cudaStream_t stream) {
  // Q tile + kStages x (K tile + V tile), and 1 KB to align the base
  constexpr size_t smem = 1024 + (size_t)(1 + 2 * kStages) * (HDP / kSlab) *
                                     kSlabBytes;
  auto kern = flash_fwd_wgmma_kernel<HDP>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(H, B, (S + kBM - 1) / kBM), block(kThreads);
  kern<<<grid, block, smem, stream>>>(mq, mk, mv,
                                      static_cast<__nv_bfloat16*>(o), lse, S,
                                      Tk, H, K, hd, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o [B, S, H, hd]; k, v [B, T, K, hd]; all contiguous bfloat16 on CUDA
// device `device`, 16-byte aligned; H % K == 0, hd % 8 == 0, 8 <= hd <=
// 128. lse, if not null, is [B, H, S] float32 and receives each row's
// log-sum-exp. window <= 0 means no window. Launches on `stream` and
// returns the CUDA error of the launch (0 when it was accepted;
// cudaErrorInvalidValue for a shape it does not take or a tensor map the
// driver refused).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o,
                                            void* lse, int B,
                                            int S, int T, int H, int K,
                                            int hd, int causal, int window,
                                            float scale, int device,
                                            void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (hd % 8 != 0 || hd < 8 || hd > 128 || K < 1 || H % K != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn enc = encode_tiled();
  CUtensorMap mq, mk, mv;
  if (enc == nullptr || !make_map(enc, &mq, q, hd, H, S, B) ||
      !make_map(enc, &mk, k, hd, K, T, B) ||
      !make_map(enc, &mv, v, hd, K, T, B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      hd <= 64 ? launch<64>(mq, mk, mv, o, static_cast<float*>(lse), B, S, T,
                            H, K, hd, causal, window, scale, st)
               : launch<128>(mq, mk, mv, o, static_cast<float*>(lse), B, S,
                             T, H, K, hd, causal, window, scale, st);
  return static_cast<int>(err);
}
