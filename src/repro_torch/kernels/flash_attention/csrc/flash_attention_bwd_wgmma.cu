// Flash-attention backward for Hopper (sm_90a) on the tensor cores: dq, dk
// and dv of causal and/or sliding-window GQA attention, bf16 inputs,
// head_dim a multiple of 8 up to 128 (the "wgmma" route), three launches a
// call.
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
//   D  = rowsum(dO * O)                     (float32)
//   dS = P * (dO.v - D)
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
// dK and dV summed over the G = H / K query heads of each KV head. Query
// head h reads KV head h / G; positions are 0..S-1 (queries) and 0..T-1
// (keys); scores are masked as the forward masks them. The float32 route
// (and a head_dim this one does not take) is flash_attention_bwd.cu's.
//
// Bound. The function needs five products per visible (query, key) pair
// (S, dP, dV, dK, dQ): at starcoder2-3b's training shape (4 x 2,048
// tokens, 24 heads over 2 KV heads, hd 128, causal) 2.6e11 flop, 0.261 ms
// at the bf16 tensor-core rate, where the bytes (q, o, dO, dq, k, v, dk,
// dv, lse once each) take about 0.07 ms. So operations bound it, and only
// wgmma reaches that rate. dQ is a pass of its own that recomputes S and
// dP, so that every grad is summed in a fixed order (the same bits every
// run): seven products, 0.365 ms at that rate.
//
// Design. Both product kernels are warp-specialised as the forward kernel
// (flash_attention_wgmma.cu): 384 threads, consumer warpgroups 0 and 1
// multiply, warpgroup 2 is the producer, whose one elected thread issues
// TMA loads into an mbarrier ring (setmaxnreg moves registers from it to
// the consumers: 40 / 232). Tiles come through 4-D tensor maps over the
// model's [B, N, heads, hd] layouts (no transposes), boxes of 64 columns
// with the 128-byte swizzle, so head dim 128 is two 64-column slabs;
// columns past hd (hd 120) and rows past S or T read as zeros, and stores
// are cut at hd, S and T. Products are wgmma with float32 accumulators in
// registers; a product that multiplies by Q, dO or K along their rows
// reads the same tile MN-major through the transpose bit (as the forward
// reads V), so each tile is loaded once for both of its uses.
//  (a) flash_bwd_delta_wgmma_kernel: D = rowsum(dO * O) and -lse log2(e),
//      [B, H, S_pad] float32 each, rows padded with zeros to a multiple
//      of 64, so that the dK / dV producer copies a query tile's 64 of
//      each with one 256-byte bulk copy. 16 lanes a row, 16-byte loads,
//      rows in the inputs' order.
//  (b) flash_bwd_dkdv_wgmma_kernel: one block takes one (128-key tile, KV
//      head, batch, group of query heads); consumer warpgroup w owns keys
//      64 w .. 64 w + 63 and keeps their dK and dV (64 x hd float32 each)
//      in registers across the group's heads, so GQA needs no atomics. K
//      and V come once; the producer streams, through a 2-stage ring, each
//      head's 64-row query tiles that see the key tile (causal: the tiles
//      at or after it; a window: those within it): Q, dO, and their rows
//      of -lse log2(e) and D. Per query tile a warpgroup computes S^T = K
//      Q^T and dP^T = V dO^T (A and B both from shared memory, m64n64k16,
//      keys as the rows), then in registers P^T = exp2(S^T scale log2(e) -
//      lse log2(e)), masked to 0, and dS^T = P^T (dP^T - D); the
//      accumulator layout of P^T and dS^T is the A operand's, so dV += P^T
//      dO and dK += dS^T Q take them from registers (m64n64k16 a slab) with
//      B the same Q / dO tiles read MN-major. A warpgroup skips a tile none
//      of whose pairs it sees (it still waits for and frees the stage).
//      Where B K (T / 128) blocks would not fill the card, the wrapper
//      splits the G heads into `gsplit` groups: each block writes its
//      float32 partial dK / dV, and the last block of a key tile to finish
//      (an atomic ticket) sums the partials in group order and writes
//      bf16, so the result does not depend on which block finished last;
//      it also sets the ticket back to 0, so the wrapper keeps one zeroed
//      ticket buffer from call to call. Blocks are numbered key tile
//      slowest, so the long causal tiles start first.
//  (c) flash_bwd_dq_wgmma_kernel: one block takes one (128-row query tile,
//      head, batch), consumer warpgroup w the rows 64 w .. 64 w + 63; Q
//      and dO come once, the 128-key K / V tiles the rows see through a
//      2-stage ring. Per key tile: S = Q K^T and dP = dO V^T (both from
//      shared memory, m64n128k16), dS = P (dP - D) in registers, then dQ
//      += dS K with dS from registers and K read MN-major. Query tiles are
//      numbered last first (the long ones).
//  Each warpgroup issues S (S^T) and dP (dP^T) as two commit groups and
//  turns S into P while dP is still on the tensor cores. P is rounded to
//  bf16 after normalising, as the plain version rounds it for its P V
//  product; dS is rounded to bf16 for the dK and dQ products, and the
//  grads are rounded to bf16 once at the end. Only tiles that cross the
//  diagonal, a window edge, S or T are masked element by element.
// The tensor map encoder is the CUDA driver API's cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links no libcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kSlab = 64;          // bf16 columns per swizzled box
constexpr int kKeys = 128;         // keys: a dK / dV block, a dQ K / V tile
constexpr int kQTile = 64;         // query rows of a dK / dV Q / dO tile
constexpr int kQBlock = 128;       // query rows of a dQ block
constexpr int kRowPad = 64;        // -lse log2(e) and D rows padded to this
constexpr int kStages = 2;         // ring depth of both product kernels
constexpr int kThreads = 384;      // 2 consumer + 1 producer warpgroup
constexpr int kConsumerWarps = 8;
constexpr int kDThreads = 128;     // D kernel: 8 rows a block
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

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

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to shared
// `dst`, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
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

// Named barrier 1 (0 is __syncthreads') joins the two consumer warpgroups.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ bool visible(int qi, int kj, int S, int Tk,
                                        int causal, int window) {
  return qi < S && kj < Tk && (!causal || kj <= qi) &&
         (window <= 0 || qi - kj < window);
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

// d (+)= A B, A [64 x 16] and B [16 x 64] from shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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

// The A operand of k-step kk from an accumulator whose columns are that
// product's K dimension: columns 16 kk .. 16 kk + 15, rounded to bf16
template <int N>
__device__ __forceinline__ void to_a(const float (&d)[N], int kk,
                                     uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// ---------------------------------------------------------------------------
// (a) D = rowsum(dO * O) and -lse log2(e), [B, H, S_pad] float32 each
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kDThreads)
    flash_bwd_delta_wgmma_kernel(const __nv_bfloat16* __restrict__ o,
                                 const __nv_bfloat16* __restrict__ d_o,
                                 const float* __restrict__ lse,
                                 float* __restrict__ nl,
                                 float* __restrict__ delta, int rows, int S,
                                 int S_pad, int H, int hd) {
  // row r = (b S_pad + s) H + h: the inputs' order, S padded; 16 lanes a
  // row, one 16-byte chunk of O and of dO a lane
  const int r = (blockIdx.x * kDThreads + threadIdx.x) / 16;
  const int sub = threadIdx.x % 16;
  const int s = (r / H) % S_pad, b = r / (H * S_pad), h = r % H;
  float acc = 0.f;
  if (r < rows && s < S && sub * 8 < hd) {
    const size_t off = (((size_t)b * S + s) * H + h) * hd + sub * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 g = *reinterpret_cast<const uint4*>(d_o + off);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]);
      const float2 y = __bfloat1622float2(g2[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && sub == 0) {
    const size_t bh = (size_t)b * H + h;
    delta[bh * S_pad + s] = s < S ? acc : 0.f;
    nl[bh * S_pad + s] = s < S ? -lse[bh * S + s] * kLog2e : 0.f;
  }
}

// ---------------------------------------------------------------------------
// (b) dK, dV
// ---------------------------------------------------------------------------

template <int HDP>
struct DkdvSmem {
  static constexpr int NS = HDP / kSlab;
  static constexpr int kKVBytes = NS * kKeys * 128;   // a K or V tile
  static constexpr int kQBytes = NS * kQTile * 128;   // a Q or dO tile
  static constexpr int kRowBytes = 2 * kQTile * 4;    // -lse log2(e), D
  // K, V; kStages x (Q, dO); kStages x rows; 1 KB to align the base
  static constexpr size_t bytes = 1024 + 2 * (size_t)kKVBytes +
                                  kStages * (2 * (size_t)kQBytes + kRowBytes);
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_do,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const float* __restrict__ nl,
                                const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv,
                                float* __restrict__ ws,
                                int* __restrict__ tickets, int B, int S,
                                int S_pad, int Tk, int H, int K, int hd,
                                int causal, int window, float scale,
                                int gsplit, int n_kt) {
  using L = DkdvSmem<HDP>;
  constexpr int NS = L::NS;
  constexpr int kQSlab = kQTile * 128, kKSlab = kKeys * 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t kv_full, full[kStages], empty[kStages];
  __shared__ int s_last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + L::kKVBytes;
  // stage st: Q at sQ + 2 st kQBytes, dO after it; its rows at
  // sRows + st kRowBytes
  const uint32_t sQ = sV + L::kKVBytes;
  const uint32_t sRows = sQ + kStages * 2 * L::kQBytes;
  const float* fRows = reinterpret_cast<const float*>(smem_raw + (sRows - raw));

  int idx = blockIdx.x;
  const int kt = idx / (B * K * gsplit);  // key tile slowest: long first
  idx %= B * K * gsplit;
  const int gs = idx % gsplit;
  idx /= gsplit;
  const int kh = idx % K, b = idx / K;
  const int G = H / K, gper = G / gsplit, g0 = gs * gper;
  const int t0 = kt * kKeys;
  // the query tiles that see this key tile
  const int q_lo = causal ? t0 : 0;
  const int q_hi = window > 0 ? min(S, t0 + kKeys - 1 + window) : S;
  const int qt_begin = q_lo / kQTile;
  const int n_q = q_hi > q_lo ? (q_hi + kQTile - 1) / kQTile - qt_begin : 0;
  const int n_it = gper * n_q;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(smem_u32(&kv_full), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256 && n_it > 0) {
      const uint32_t kvf = smem_u32(&kv_full);
      mbar_expect_tx(kvf, 2 * L::kKVBytes);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        tma_load_4d(sK + s * kKSlab, &tm_k, kvf, s * kSlab, kh, t0, b);
        tma_load_4d(sV + s * kKSlab, &tm_v, kvf, s * kSlab, kh, t0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        if (it >= kStages)  // the consumers are done with its last fill
          mbar_wait(smem_u32(&empty[st]), ((it / kStages) - 1) & 1);
        const int h = kh * G + g0 + it / n_q;
        const int q0 = (qt_begin + it % n_q) * kQTile;
        const uint32_t f = smem_u32(&full[st]);
        const uint32_t cQ = sQ + st * 2 * L::kQBytes, cdO = cQ + L::kQBytes;
        mbar_expect_tx(f, 2 * L::kQBytes + L::kRowBytes);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          tma_load_4d(cQ + s * kQSlab, &tm_q, f, s * kSlab, h, q0, b);
          tma_load_4d(cdO + s * kQSlab, &tm_do, f, s * kSlab, h, q0, b);
        }
        const size_t row = ((size_t)b * H + h) * S_pad + q0;
        const uint32_t cR = sRows + st * L::kRowBytes;
        bulk_load(cR, nl + row, kQTile * 4, f);
        bulk_load(cR + kQTile * 4, delta + row, kQTile * 4, f);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys t0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int kw0 = t0 + wg * 64;                  // the warpgroup's keys
    const int kr0 = kw0 + warp * 16 + lane / 4;    // keys kr0 and kr0 + 8
    const int cq = 2 * (lane % 4);                 // column pair in an 8
    const float sl2 = scale * kLog2e;
    float dka[NS][32], dva[NS][32], st_[32], dpt[32];
#pragma unroll
    for (int ns = 0; ns < NS; ++ns)
#pragma unroll
      for (int j = 0; j < 32; ++j) dka[ns][j] = dva[ns][j] = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) st_[j] = dpt[j] = 0.f;

    if (n_it > 0) mbar_wait(smem_u32(&kv_full), 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const int q0 = (qt_begin + it % n_q) * kQTile;
      const uint32_t cQ = sQ + st * 2 * L::kQBytes, cdO = cQ + L::kQBytes;
      mbar_wait(smem_u32(&full[st]), (it / kStages) & 1);
      // some (query, key) pair of this warpgroup's 64 x 64 is visible
      const bool any = kw0 < Tk && q0 < S &&
                       (!causal || q0 + kQTile - 1 >= kw0) &&
                       (window <= 0 || q0 - (kw0 + 63) < window);
      if (any) {
        // S^T = K Q^T and dP^T = V dO^T, two commit groups
        reg_fence(st_);
        reg_fence(dpt);
        wgmma_fence();
#pragma unroll
        for (int ns = 0; ns < NS; ++ns)
#pragma unroll
          for (int kk = 0; kk < kSlab / 16; ++kk)
            wgmma_ss_m64n64(
                st_, sw128_desc(sK + ns * kKSlab + wg * 64 * 128 + kk * 32),
                sw128_desc(cQ + ns * kQSlab + kk * 32), (ns | kk) != 0);
        wgmma_commit();
#pragma unroll
        for (int ns = 0; ns < NS; ++ns)
#pragma unroll
          for (int kk = 0; kk < kSlab / 16; ++kk)
            wgmma_ss_m64n64(
                dpt, sw128_desc(sV + ns * kKSlab + wg * 64 * 128 + kk * 32),
                sw128_desc(cdO + ns * kQSlab + kk * 32), (ns | kk) != 0);
        wgmma_commit();
        const bool edge = (causal && kw0 + 63 > q0) ||
                          (window > 0 && q0 + kQTile - 1 - kw0 >= window) ||
                          q0 + kQTile > S || kw0 + 64 > Tk;
        const float* rows = fRows + st * (L::kRowBytes / 4);
        wgmma_wait<1>();  // S^T is in
        reg_fence(st_);
        // P^T; element [4 j + 2 ii + c] is key kr0 + 8 ii, query
        // q0 + 8 j + cq + c
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, c = e & 1, ii = e >> 1;
            float p = ex2(fmaf(st_[i], sl2, c ? l2.y : l2.x));
            if (edge && !visible(q0 + 8 * j + cq + c, kr0 + 8 * ii, S, Tk,
                                 causal, window))
              p = 0.f;
            st_[i] = p;
          }
        }
        wgmma_wait<0>();  // dP^T is in
        reg_fence(dpt);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(rows + kQTile + 8 * j + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            dpt[i] = st_[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x));
          }
        }
        // dV += P^T dO and dK += dS^T Q over the tile's 64 queries
        uint32_t pa[kQTile / 16][4], sa[kQTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kQTile / 16; ++kk) {
          to_a(st_, kk, pa[kk]);
          to_a(dpt, kk, sa[kk]);
        }
#pragma unroll
        for (int ns = 0; ns < NS; ++ns) {
          reg_fence(dka[ns]);
          reg_fence(dva[ns]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQTile / 16; ++kk)
#pragma unroll
          for (int ns = 0; ns < NS; ++ns) {
            wgmma_rs_m64n64_tb(
                dva[ns], pa[kk],
                sw128_desc(cdO + ns * kQSlab + kk * 16 * 128));
            wgmma_rs_m64n64_tb(
                dka[ns], sa[kk],
                sw128_desc(cQ + ns * kQSlab + kk * 16 * 128));
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int ns = 0; ns < NS; ++ns) {
          reg_fence(dka[ns]);
          reg_fence(dva[ns]);
        }
      }
      if (lane == 0) mbar_arrive(smem_u32(&empty[st]));  // stage free
    }

    // dka[ns][4 j + 2 ii + c] is key kr0 + 8 ii, column 64 ns + 8 j + cq + c
    if (gsplit == 1) {
#pragma unroll
      for (int ns = 0; ns < NS; ++ns)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int col = ns * kSlab + 8 * j + cq, kr = kr0 + 8 * ii;
            if (col >= hd || kr >= Tk) continue;
            const size_t off = (((size_t)b * Tk + kr) * K + kh) * hd + col;
            *reinterpret_cast<__nv_bfloat162*>(dk + off) =
                __floats2bfloat162_rn(dka[ns][4 * j + 2 * ii] * scale,
                                      dka[ns][4 * j + 2 * ii + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dv + off) =
                __floats2bfloat162_rn(dva[ns][4 * j + 2 * ii],
                                      dva[ns][4 * j + 2 * ii + 1]);
          }
      return;
    }
    // this group's float32 partials: ws [gsplit][2][B][T][K][hd]
    const size_t plane = (size_t)B * Tk * K * hd;
    float* pk = ws + (size_t)gs * 2 * plane;
    float* pv = pk + plane;
#pragma unroll
    for (int ns = 0; ns < NS; ++ns)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int col = ns * kSlab + 8 * j + cq, kr = kr0 + 8 * ii;
          if (col >= hd || kr >= Tk) continue;
          const size_t off = (((size_t)b * Tk + kr) * K + kh) * hd + col;
          *reinterpret_cast<float2*>(pk + off) =
              make_float2(dka[ns][4 * j + 2 * ii] * scale,
                          dka[ns][4 * j + 2 * ii + 1] * scale);
          *reinterpret_cast<float2*>(pv + off) = make_float2(
              dva[ns][4 * j + 2 * ii], dva[ns][4 * j + 2 * ii + 1]);
        }
    // the last group of this key tile to finish sums the partials in group
    // order and writes bf16
    __threadfence();
    consumers_sync();
    int* ticket = tickets + ((size_t)b * K + kh) * n_kt + kt;
    if (tid == 0) s_last = atomicAdd(ticket, 1) == gsplit - 1;
    consumers_sync();
    if (!s_last) return;
    __threadfence();
    const int rows = min(kKeys, Tk - t0), pairs = hd / 2;
    for (int i = tid; i < rows * pairs; i += 256) {
      const int r = i / pairs, col = 2 * (i % pairs);
      const size_t off = (((size_t)b * Tk + t0 + r) * K + kh) * hd + col;
      float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
      for (int s = 0; s < gsplit; ++s) {
        const float2 a =
            __ldcg(reinterpret_cast<const float2*>(ws + s * 2 * plane + off));
        const float2 c = __ldcg(
            reinterpret_cast<const float2*>(ws + s * 2 * plane + plane + off));
        sk.x += a.x;
        sk.y += a.y;
        sv.x += c.x;
        sv.y += c.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(sk.x, sk.y);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(sv.x, sv.y);
    }
    if (tid == 0) *ticket = 0;  // ready for another call
  }
}

// ---------------------------------------------------------------------------
// (c) dQ
// ---------------------------------------------------------------------------

template <int HDP>
struct DqSmem {
  static constexpr int NS = HDP / kSlab;
  static constexpr int kTileBytes = NS * 128 * 128;  // a 128-row tile
  // Q, dO; kStages x (K, V); 1 KB to align the base
  static constexpr size_t bytes =
      1024 + (size_t)(2 + 2 * kStages) * kTileBytes;
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const float* __restrict__ nl,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int B, int S,
                              int S_pad, int Tk, int H, int K, int hd,
                              int causal, int window, float scale, int n_qt) {
  using L = DqSmem<HDP>;
  constexpr int NS = L::NS;
  constexpr int kSlabBytes = 128 * 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, k_full[kStages], v_full[kStages],
      empty[kStages];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + L::kTileBytes;
  // stage st: K at sK + 2 st kTileBytes, V after it
  const uint32_t sK = sdO + L::kTileBytes;

  int idx = blockIdx.x;
  const int qt = n_qt - 1 - idx / (B * H);  // long causal tiles first
  idx %= B * H;
  const int h = idx % H, b = idx / H, kh = h / (H / K);
  const int q0 = qt * kQBlock;
  const int q_last = min(q0 + kQBlock, S) - 1;
  // the key tiles that hold a visible key for some row of this tile
  const int t_end = causal ? min(Tk, q_last + 1) : Tk;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;
  const int n_tiles =
      t_end > t_begin ? (t_end - t_begin + kKeys - 1) / kKeys : 0;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(smem_u32(&q_full), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&k_full[s]), 1);
      mbar_init(smem_u32(&v_full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256 && n_tiles > 0) {
      const uint32_t qf = smem_u32(&q_full);
      mbar_expect_tx(qf, 2 * L::kTileBytes);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        tma_load_4d(sQ + s * kSlabBytes, &tm_q, qf, s * kSlab, h, q0, b);
        tma_load_4d(sdO + s * kSlabBytes, &tm_do, qf, s * kSlab, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, t0 = t_begin + i * kKeys;
        if (i >= kStages)  // the consumers are done with its last fill
          mbar_wait(smem_u32(&empty[st]), ((i / kStages) - 1) & 1);
        const uint32_t cK = sK + st * 2 * L::kTileBytes;
        const uint32_t cV = cK + L::kTileBytes;
        const uint32_t kf = smem_u32(&k_full[st]);
        const uint32_t vf = smem_u32(&v_full[st]);
        mbar_expect_tx(kf, L::kTileBytes);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          tma_load_4d(cK + s * kSlabBytes, &tm_k, kf, s * kSlab, kh, t0, b);
        mbar_expect_tx(vf, L::kTileBytes);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          tma_load_4d(cV + s * kSlabBytes, &tm_v, vf, s * kSlab, kh, t0, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int rw0 = q0 + wg * 64;                  // the warpgroup's rows
    const int r0 = rw0 + warp * 16 + lane / 4;     // rows r0 and r0 + 8
    const int cq = 2 * (lane % 4);                 // column pair in an 8
    const float sl2 = scale * kLog2e;
    float nlr[2], dd[2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int r = r0 + 8 * ii;
      const size_t i = ((size_t)b * H + h) * S_pad + r;
      nlr[ii] = r < S ? nl[i] : 0.f;
      dd[ii] = r < S ? delta[i] : 0.f;
    }
    float dqa[NS][32], s[64], dp[64];
#pragma unroll
    for (int ns = 0; ns < NS; ++ns)
#pragma unroll
      for (int j = 0; j < 32; ++j) dqa[ns][j] = 0.f;
#pragma unroll
    for (int j = 0; j < 64; ++j) s[j] = dp[j] = 0.f;

    if (n_tiles > 0) mbar_wait(smem_u32(&q_full), 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages, t0 = t_begin + i * kKeys;
      const uint32_t cK = sK + st * 2 * L::kTileBytes;
      const uint32_t cV = cK + L::kTileBytes;
      // some (row, key) pair of this warpgroup's 64 x 128 is visible
      const bool any = rw0 < S && t0 < Tk && (!causal || t0 <= rw0 + 63) &&
                       (window <= 0 || rw0 - (t0 + kKeys - 1) < window);
      mbar_wait(smem_u32(&k_full[st]), (i / kStages) & 1);
      mbar_wait(smem_u32(&v_full[st]), (i / kStages) & 1);
      if (any) {
        // S = Q K^T and dP = dO V^T, two commit groups
        reg_fence(s);
        reg_fence(dp);
        wgmma_fence();
#pragma unroll
        for (int ns = 0; ns < NS; ++ns)
#pragma unroll
          for (int kk = 0; kk < kSlab / 16; ++kk)
            wgmma_ss_m64n128(
                s, sw128_desc(sQ + ns * kSlabBytes + wg * 64 * 128 + kk * 32),
                sw128_desc(cK + ns * kSlabBytes + kk * 32), (ns | kk) != 0);
        wgmma_commit();
#pragma unroll
        for (int ns = 0; ns < NS; ++ns)
#pragma unroll
          for (int kk = 0; kk < kSlab / 16; ++kk)
            wgmma_ss_m64n128(
                dp,
                sw128_desc(sdO + ns * kSlabBytes + wg * 64 * 128 + kk * 32),
                sw128_desc(cV + ns * kSlabBytes + kk * 32), (ns | kk) != 0);
        wgmma_commit();
        const bool edge = (causal && t0 + kKeys - 1 > rw0) ||
                          (window > 0 && rw0 + 63 - t0 >= window) ||
                          t0 + kKeys > Tk || rw0 + 64 > S;
        wgmma_wait<1>();  // S is in
        reg_fence(s);
        // P; element [4 j + 2 ii + c] is row r0 + 8 ii, key
        // t0 + 8 j + cq + c
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const int ii = (e >> 1) & 1;
          float p = ex2(fmaf(s[e], sl2, nlr[ii]));
          if (edge && !visible(r0 + 8 * ii, t0 + 8 * (e >> 2) + cq + (e & 1),
                               S, Tk, causal, window))
            p = 0.f;
          s[e] = p;
        }
        wgmma_wait<0>();  // dP is in
        reg_fence(dp);
#pragma unroll
        for (int e = 0; e < 64; ++e) s[e] *= dp[e] - dd[(e >> 1) & 1];
        // dQ += dS K over the tile's 128 keys
        uint32_t sa[kKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) to_a(s, kk, sa[kk]);
#pragma unroll
        for (int ns = 0; ns < NS; ++ns) reg_fence(dqa[ns]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
          for (int ns = 0; ns < NS; ++ns)
            wgmma_rs_m64n64_tb(
                dqa[ns], sa[kk],
                sw128_desc(cK + ns * kSlabBytes + kk * 16 * 128));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int ns = 0; ns < NS; ++ns) reg_fence(dqa[ns]);
      }
      if (lane == 0) mbar_arrive(smem_u32(&empty[st]));  // stage free
    }

    // dqa[ns][4 j + 2 ii + c] is row r0 + 8 ii, column 64 ns + 8 j + cq + c
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int qi = r0 + 8 * ii;
      if (qi >= S) continue;
      __nv_bfloat16* row = dq + (((size_t)b * S + qi) * H + h) * hd;
#pragma unroll
      for (int ns = 0; ns < NS; ++ns)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = ns * kSlab + 8 * j + cq;
          if (col < hd)
            *reinterpret_cast<__nv_bfloat162*>(row + col) =
                __floats2bfloat162_rn(dqa[ns][4 * j + 2 * ii] * scale,
                                      dqa[ns][4 * j + 2 * ii + 1] * scale);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, from the CUDA driver API through the runtime
// (no libcuda link)
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

// A 4-D map over a contiguous bf16 [batch, rows, heads, hd] tensor; box 64
// columns x 1 head x `box_rows` rows x 1 batch, 128-byte swizzle, zeros
// outside the tensor.
bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int hd,
              int heads, int rows, int batch, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t row = (cuuint64_t)hd * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * rows};
  const cuuint32_t box[4] = {kSlab, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v, *o, *lse, *d_o;
  void *dq, *dk, *dv;
  float *nl, *delta;  // [B, H, S_pad] each
  float* ws;
  int* tickets;
  int B, S, S_pad, T, H, K, hd, causal, window, gsplit;
  float scale;
  cudaStream_t stream;
  cudaEvent_t* events;  // null, or four events to record around the launches
};

// q and dO at the dK / dV kernel's 64-row box and the dQ kernel's 128, k
// and v at 128
struct Maps {
  CUtensorMap q64, do64, q128, do128, k, v;
};

// records events[i] on the stream, where the caller asked for them
cudaError_t mark(const Args& a, int i) {
  return a.events ? cudaEventRecord(a.events[i], a.stream) : cudaSuccess;
}

template <int HDP>
cudaError_t launch_products(const Args& a, const Maps& m) {
  using bf = __nv_bfloat16;
  constexpr size_t kv_smem = DkdvSmem<HDP>::bytes;
  constexpr size_t q_smem = DqSmem<HDP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_smem);
  if (err != cudaSuccess) return err;
  const int n_kt = (a.T + kKeys - 1) / kKeys;
  const int n_qt = (a.S + kQBlock - 1) / kQBlock;
  flash_bwd_dkdv_wgmma_kernel<HDP><<<n_kt * a.B * a.K * a.gsplit, kThreads,
                                     kv_smem, a.stream>>>(
      m.q64, m.do64, m.k, m.v, a.nl, a.delta, static_cast<bf*>(a.dk),
      static_cast<bf*>(a.dv), a.ws, a.tickets, a.B, a.S, a.S_pad, a.T, a.H,
      a.K, a.hd, a.causal, a.window, a.scale, a.gsplit, n_kt);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(a, 2);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<HDP><<<n_qt * a.B * a.H, kThreads, q_smem,
                                   a.stream>>>(
      m.q128, m.do128, m.k, m.v, a.nl, a.delta, static_cast<bf*>(a.dq), a.B,
      a.S, a.S_pad, a.T, a.H, a.K, a.hd, a.causal, a.window, a.scale, n_qt);
  return cudaGetLastError();
}

}  // namespace

// q, o, dO, dq [B, S, H, hd]; k, v, dk, dv [B, T, K, hd]; all contiguous
// bfloat16 on CUDA device `device`, 16-byte aligned (the TMA maps' rule);
// H % K == 0, hd % 8 == 0, 8 <= hd <= 128; lse [B, H, S] float32, the
// forward's. rows is [2, B, H, S_pad] float32 scratch, S_pad = S rounded
// up to a multiple of 64 (written: -lse log2(e) and D). Each KV head's G
// query heads are split into `gsplit` groups (G % gsplit == 0); with
// gsplit > 1, ws holds gsplit x 2 x B T K hd floats and tickets B K
// ceil(T / 128) zeroed ints, which the call leaves at 0. window <= 0 means
// no window. Launches three kernels on `stream` and returns the first CUDA
// error (0 when all three were accepted; cudaErrorInvalidValue for a shape
// it does not take or a tensor map that cuTensorMapEncodeTiled refused).
// `events`, where not null, holds four created events, recorded before D,
// after D, after dK / dV and after dQ, so a caller can time each launch.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* d_o, void* dq, void* dk, void* dv,
    void* rows, void* ws, void* tickets, int B, int S, int T, int H, int K,
    int hd, int causal, int window, float scale, int gsplit, int device,
    void* stream, void* events) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (K < 1 || H % K != 0 || hd % 8 != 0 || hd < 8 || hd > 128 ||
      gsplit < 1 || (H / K) % gsplit != 0 ||
      (gsplit > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int S_pad = (S + kRowPad - 1) / kRowPad * kRowPad;
  float* nl = static_cast<float*>(rows);
  Args a{q, k, v, o, lse, d_o, dq, dk, dv, nl, nl + (size_t)B * H * S_pad,
         static_cast<float*>(ws), static_cast<int*>(tickets), B, S, S_pad,
         T, H, K, hd, causal, window, gsplit, scale,
         static_cast<cudaStream_t>(stream), static_cast<cudaEvent_t*>(events)};
  const EncodeTiledFn enc = encode_tiled();
  Maps m;
  if (enc == nullptr || !make_map(enc, &m.q64, q, hd, H, S, B, kQTile) ||
      !make_map(enc, &m.do64, d_o, hd, H, S, B, kQTile) ||
      !make_map(enc, &m.q128, q, hd, H, S, B, kQBlock) ||
      !make_map(enc, &m.do128, d_o, hd, H, S, B, kQBlock) ||
      !make_map(enc, &m.k, k, hd, K, T, B, kKeys) ||
      !make_map(enc, &m.v, v, hd, K, T, B, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = mark(a, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d_rows = B * S_pad * H;
  flash_bwd_delta_wgmma_kernel<<<(d_rows + kDThreads / 16 - 1) /
                                     (kDThreads / 16),
                                 kDThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(d_o),
      static_cast<const float*>(lse), a.nl, a.delta, d_rows, S, S_pad, H,
      hd);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(a, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hd <= 64 ? launch_products<64>(a, m) : launch_products<128>(a, m);
  if (err == cudaSuccess) err = mark(a, 3);
  return static_cast<int>(err);
}
