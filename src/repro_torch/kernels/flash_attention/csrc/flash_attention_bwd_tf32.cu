// Flash-attention backward for Hopper (sm_90a) on the tensor cores in
// float32: split TF32 ("tf32x3"), dq, dk and dv of causal and/or
// sliding-window GQA attention, head_dim a multiple of 8 up to 128, three
// launches a call.
//
// Replaces, for float32, the recompute of src/repro_torch/kernels/
// flash_attention/ops.py::_Flash.backward, the port of the TPU reference's
// src/repro/kernels/flash_attention/ops.py::_flash_bwd (XLA's VJP of its
// jnp oracle; it reaches no Pallas kernel), as kernel.py::bwd_route sends
// it here; bf16 is flash_attention_bwd_wgmma.cu's, a head_dim that is not a
// multiple of 8 the SIMT kernels' (flash_attention_bwd.cu). It computes the
// port's plain version ref.py::attention_bwd_ref, the FlashAttention-2
// backward: from q, k, v, the forward's o and its row log-sum-exp lse
// ([B, H, S] float32, written by the forward kernels when asked) and dO,
//   P  = exp(scale q.k - lse) on unmasked (query, key) pairs, 0 elsewhere
//   D  = rowsum(dO * O)
//   dS = P * (dO.v - D)
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
// dK and dV summed over the G = H / K query heads of each KV head, all in
// float32. Query head h reads KV head h / G; positions are 0..S-1
// (queries) and 0..T-1 (keys); scores are masked as the forward masks
// them.
//
// The split. As flash_attention_tf32.cu: every operand x of a product is
// x = hi + lo in TF32 (cvt.rna of x, then of x - hi), and a b is summed as
// hi_a lo_b + lo_a hi_b + hi_a hi_b in one float32 accumulator on the
// tensor cores, about 2^-22 of |a b| from the float32 product
// (ref.py::mm_tf32x3 models it).
//
// Bound. The function needs five products per visible (query, key) pair
// (S, dP, dV, dK, dQ): at starcoder2-3b's training shape (4 x 2,048
// tokens, 24 heads over 2 KV heads, hd 128, causal) 2.58e11 flop, three
// TF32 products each: 1.56 ms at the TF32 tensor rate, where float32 FMAs
// would take 3.85 ms and the bytes (q, o, dO, dq, k, v, dk, dv, lse once
// each) about 0.13 ms. So operations bound it. dQ is a pass of its own
// that recomputes S and dP, so that every grad is summed in a fixed order
// (the same bits every run): seven products, 2.19 ms.
//
// Design. dK / dV and dQ are one kernel, flash_bwd_tf32_kernel<HDP, DKDV>:
// a block holds a fixed 64-row tile X1, X2 and streams 32-row tiles Y1, Y2
// past it.
//   dK / dV (DKDV): X = K, V over 64 keys of a KV head; Y = Q, dO over the
//     query tiles, of each query head of the block's group, that see the
//     keys, with their rows of -lse log2(e) and D.
//     S^T = K Q^T, dP^T = V dO^T; P^T, dS^T in registers;
//     dV += P^T dO, dK += dS^T Q (accumulators kept across the heads).
//   dQ: X = Q, dO over 64 queries of a head; Y = K, V over the key tiles
//     the queries see. S = Q K^T, dP = dO V^T; P, dS; dQ += dS K.
// 160 threads: warps 0-3 are the consumer warpgroup, warp 4 the producer,
// whose one elected thread issues TMA loads (X once, Y through a ring of
// raw stages, full / empty mbarriers and expect_tx; the rows by bulk copy
// from the D kernel's padded arrays).
//  - Layout. For 32-bit types wgmma reads shared-memory operands K-major
//    only. The first two products contract over hd and read X and Y as
//    stored; the last ones contract over Y's rows and need Y^T. Each raw Y
//    tile is read twice by the consumers: first split into hi / lo in the
//    layout it arrived in (W slots), after the first products split and
//    transposed into the same slots (the first products have read them),
//    Y's row j at K position j / 2 + 4 (j % 2) of its 8 so that the A
//    fragment of P or dS comes straight from the accumulator (see
//    flash_attention_tf32.cu). The raw stage then goes back to the
//    producer, so the next tile's copy overlaps this one's last products.
//    X is split in place once (hi over the raw tile, lo beside it).
//  - Shared memory at hd 128: X hi / lo 4 x 32 KB, W 4 x 16 KB, one raw
//    stage of Y1, Y2 32 KB and its rows: 224 KB of the 227. So one
//    warpgroup a block (a second would need its own X), the streamed tile
//    is 32 rows and the ring holds one stage at hd 128, two below it.
//  - Registers: dK and dV (2 x hd / 2 floats a thread at 64 rows), a
//    product's column chunk and the split P or dS fragments; 160 threads
//    leave 255 a thread, and dK / dV at hd 128 spills 8 bytes (32-column
//    chunks spill nothing but read 1.5-3% slower: tools/
//    flash_tf32_variants.py).
//  - Products: wgmma m64n32k8 for S and dP (A = X, B = W, both from shared
//    memory, hd / 8 k-steps x 3), then m64n64k8 (m64n32k8 at hd <= 32)
//    with A = P or dS split in registers (4 k-steps x 3) and B = W^T, in
//    64-column chunks; per product the correction terms first, hi hi last.
//    Only tiles that cross the diagonal, a window edge, S or T are masked
//    element by element; a tile none of whose pairs is visible is skipped.
//  - Promotion. The grads are float32 registers of their own: each tile's
//    dV, dK or dQ product is summed on the tensor cores from zero and then
//    added to them. Carried in one wgmma accumulator across the 768 query
//    tiles (12 heads x 64) that a key tile of starcoder2-3b's training
//    shape sees, dK and dV read 1.6-1.8e-4 of the largest grad from the
//    float32 plain version on an H100, over the 1e-4 bar, where dQ,
//    carried across 64 key tiles, read 1.1e-6 (the "unpromoted" variant
//    of tools/flash_tf32_variants.py): the tensor cores' sum drifts with
//    the number of products carried in one accumulator.
//  - GQA: where B K ceil(T / 64) blocks would not fill the card, the
//    wrapper splits each KV head's G query heads into `gsplit` groups; each
//    block writes its partial dK / dV, and the last block of a key tile to
//    finish (an atomic ticket) sums the partials in group order, so the
//    result does not depend on which block finished last, and sets the
//    ticket back to 0. Key tiles (dK / dV) and query tiles (dQ) are
//    numbered long first.
//  (a) flash_bwd_delta_tf32_kernel: D = rowsum(dO * O) and -lse log2(e),
//      [B, H, S_pad] float32 each, rows padded with zeros to a multiple of
//      64 (16 lanes a row, float4 loads).
// The tensor map encoder is the CUDA driver API's cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links no libcuda.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kSlab = 32;          // float32 columns per swizzled box
constexpr int kRows = 64;          // rows of a fixed tile (one warpgroup's M)
constexpr int kTile = 32;          // rows of a streamed tile
constexpr int kRowPad = 64;        // -lse log2(e) and D rows padded to this
constexpr int kThreads = 160;      // one consumer warpgroup + a producer warp
constexpr int kConsumers = 128;
constexpr int kDThreads = 128;     // D kernel: 8 rows a block
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the HDP instance (HDP = hd rounded up to 32, 64 or 128)
template <int HDP>
struct PassSmem {
  static constexpr int NS = HDP / kSlab;
  static constexpr int kStages = HDP == 128 ? 1 : 2;  // raw Y ring
  static constexpr int kFixBytes = HDP * 256;    // X hi or lo: 64 rows
  static constexpr int kTileBytes = HDP * 128;   // a raw Y, a W slot
  static constexpr int kRowBytes = 2 * kTile * 4;  // -lse log2(e), D
  // X1, X2 hi / lo; W1, W2 hi / lo; kStages x (raw Y1, raw Y2); kStages x
  // rows; 1 KB to align the base
  static constexpr size_t bytes = 1024 + 4 * (size_t)kFixBytes +
                                  (4 + 2 * kStages) * (size_t)kTileBytes +
                                  kStages * kRowBytes;
};

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

// wgmma shared-memory descriptor of a 128-byte-swizzled K-major tile whose
// rows are 128 bytes (32 float32): start address, leading byte offset 16
// (not read: an operand's k-step lies inside one swizzle atom), stride
// byte offset 1024 (8 rows of 128 bytes), layout 128B swizzle. The tile
// base is 1024-aligned; k-step kk (8 TF32 values, 32 bytes) of a slab
// moves the start by 32 kk bytes inside the atom.
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
// the generic-proxy writes to shared memory before it become visible to
// the async proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving accumulator registers across the
// asynchronous wgmma issue / wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barrier 1 (0 is __syncthreads') joins the consumer warpgroup.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ bool visible(int qi, int kj, int S, int Tk,
                                        int causal, int window) {
  return qi < S && kj < Tk && (!causal || kj <= qi) &&
         (window <= 0 || qi - kj < window);
}

// x rounded to the nearest TF32 value, ties away from zero, as a float32
// bit pattern (low 13 mantissa bits zero)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo: hi the TF32 value nearest x, lo the one nearest x - hi
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

// Byte offset of element (n, k) in a K-major tile of rows of 32 float32
// (128 bytes) under the 128-byte swizzle: 16-byte chunk k / 4 of row n
// sits at chunk (k / 4) ^ (n % 8).
__device__ __forceinline__ uint32_t sw128_offset(int n, int k) {
  return n * 128 + ((((k >> 2) ^ n) & 7) << 4) + (k & 3) * 4;
}

// The K position at which a transposed operand stores row j of its source
// tile: within each 8, j / 2 + 4 (j % 2), so that A position t holds the
// accumulator's column 2t and position t + 4 its column 2t + 1 (see
// a_frag)
__device__ __forceinline__ int k_perm(int j) {
  return (j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2);
}

// Split transpose of a raw [32 rows x HDP] tile (TMA layout: HDP / 32
// slabs of 32 rows x 128 bytes, swizzled) into hi and lo [HDP rows x 32]
// K-major tiles, row j of the source at K position k_perm(j). Thread
// `t` of `n_threads` (a multiple of 32) reads float4s of row t % 32: 32
// rows a warp on reads, 32 K positions of one row on writes, free of bank
// conflicts both ways.
template <int HDP>
__device__ __forceinline__ void split_transpose(const uint8_t* raw,
                                                uint8_t* hi, uint8_t* lo,
                                                int t, int n_threads) {
  const int j = t & 31, kp = k_perm(j);
#pragma unroll 4
  for (int c = t; c < HDP * 8; c += n_threads) {
    const int cg = c >> 5;  // 4-column group 0 .. HDP / 4 - 1
    const float4 x = *reinterpret_cast<const float4*>(
        raw + (cg >> 3) * (32 * 128) + j * 128 + ((((cg & 7) ^ j) & 7) << 4));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t h, l;
      split(xs[e], h, l);
      const uint32_t off = sw128_offset(4 * cg + e, kp);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) = l;
    }
  }
}

// Split of `bytes` of a tile in the layout it has: hi over (or beside) the
// raw values, lo beside them
__device__ __forceinline__ void split_copy(const uint8_t* raw, uint8_t* hi,
                                           uint8_t* lo, int bytes, int t,
                                           int n_threads) {
#pragma unroll 4
  for (int c = t; c < bytes / 16; c += n_threads) {
    const float4 x = reinterpret_cast<const float4*>(raw)[c];
    uint4 h, l;
    split4(x, h, l);
    reinterpret_cast<uint4*>(hi)[c] = h;
    reinterpret_cast<uint4*>(lo)[c] = l;
  }
}

// The hi and lo A fragments of k-step kk from an accumulator whose columns
// are the product's K dimension (see k_perm)
template <int N>
__device__ __forceinline__ void a_frag(const float (&d)[N], int kk,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(d[4 * kk], hi[0], lo[0]);
  split(d[4 * kk + 2], hi[1], lo[1]);
  split(d[4 * kk + 1], hi[2], lo[2]);
  split(d[4 * kk + 3], hi[3], lo[3]);
}

// d (+)= A B, A [64 x 8] and B [8 x 32] tf32 from shared memory, both
// K-major (32-bit types take no transpose)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B, A [64 x 8] tf32 from registers, B [8 x 32] tf32 from
// shared memory, K-major
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A B, A [64 x 8] tf32 from registers, B [8 x 64] tf32 from
// shared memory, K-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A B, A [64 x 8] tf32 from registers, B [8 x 128] tf32 from
// shared memory, K-major
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// acc += A W over one streamed tile: A (kTile / 8 k-steps of hi / lo
// fragments) from registers, W ([HDP rows x kTile] hi / lo at w_hi / w_lo)
// from shared memory. The tile's product is summed on the tensor cores
// from zero, CH columns at a time (the correction terms, then hi hi), and
// added to acc in float32 registers: the tensor cores' sum, carried across
// hundreds of tiles in one accumulator, drifts from the float32 one (see
// the note at the top), where one tile's 12 products do not.
template <int HDP, int CH>
__device__ __forceinline__ void add_product(float (&acc)[HDP / 2],
                                            const uint32_t (&fh)[kTile / 8][4],
                                            const uint32_t (&fl)[kTile / 8][4],
                                            uint32_t w_hi, uint32_t w_lo) {
  float part[CH / 2];
#pragma unroll
  for (int e = 0; e < CH / 2; ++e) part[e] = 0.f;
#pragma unroll
  for (int n0 = 0; n0 < HDP; n0 += CH) {
    reg_fence(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 8; ++kk) {
      wgmma_rs(part, fh[kk], sw128_desc(w_lo + n0 * 128 + kk * 32), kk != 0);
      wgmma_rs(part, fl[kk], sw128_desc(w_hi + n0 * 128 + kk * 32), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 8; ++kk)
      wgmma_rs(part, fh[kk], sw128_desc(w_hi + n0 * 128 + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(part);
#pragma unroll
    for (int e = 0; e < CH / 2; ++e) acc[n0 / 2 + e] += part[e];
  }
}

// ---------------------------------------------------------------------------
// (a) D = rowsum(dO * O) and -lse log2(e), [B, H, S_pad] float32 each
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kDThreads)
    flash_bwd_delta_tf32_kernel(const float* __restrict__ o,
                                const float* __restrict__ d_o,
                                const float* __restrict__ lse,
                                float* __restrict__ nl,
                                float* __restrict__ delta, int rows, int S,
                                int S_pad, int H, int hd) {
  // row r = (b S_pad + s) H + h: the inputs' order, S padded; 16 lanes a
  // row, two float4s of O and of dO a lane
  const int r = (blockIdx.x * kDThreads + threadIdx.x) / 16;
  const int sub = threadIdx.x % 16;
  const int s = (r / H) % S_pad, b = r / (H * S_pad), h = r % H;
  float acc = 0.f;
  if (r < rows && s < S && sub * 8 < hd) {
    const size_t off = (((size_t)b * S + s) * H + h) * hd + sub * 8;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float4 a = *reinterpret_cast<const float4*>(o + off + 4 * e);
      const float4 g = *reinterpret_cast<const float4*>(d_o + off + 4 * e);
      acc = fmaf(a.x, g.x, acc);
      acc = fmaf(a.y, g.y, acc);
      acc = fmaf(a.z, g.z, acc);
      acc = fmaf(a.w, g.w, acc);
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
// (b) dK / dV (DKDV) and (c) dQ
// ---------------------------------------------------------------------------

// DKDV: tm_x1 / tm_x2 map k / v (64-row boxes), tm_y1 / tm_y2 q / dO
// (32-row boxes), out1 = dk, out2 = dv, n_fix the key tiles. Else tm_x1 /
// tm_x2 map q / dO (64), tm_y1 / tm_y2 k / v (32), out1 = dq, n_fix the
// query tiles.
template <int HDP, bool DKDV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_tf32_kernel(const __grid_constant__ CUtensorMap tm_x1,
                          const __grid_constant__ CUtensorMap tm_x2,
                          const __grid_constant__ CUtensorMap tm_y1,
                          const __grid_constant__ CUtensorMap tm_y2,
                          const float* __restrict__ nl,
                          const float* __restrict__ delta,
                          float* __restrict__ out1, float* __restrict__ out2,
                          float* __restrict__ ws, int* __restrict__ tickets,
                          int B, int S, int S_pad, int Tk, int H, int K,
                          int hd, int causal, int window, float scale,
                          int gsplit, int n_fix) {
  using L = PassSmem<HDP>;
  constexpr int NS = L::NS, kStages = L::kStages;
  constexpr int kFB = L::kFixBytes, kTB = L::kTileBytes;
  constexpr int kXSlab = kRows * 128, kYSlab = kTile * 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t fix_full, full[2], empty[2];
  __shared__ int s_last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sX1h = (raw + 1023u) & ~1023u, sX1l = sX1h + kFB;
  const uint32_t sX2h = sX1l + kFB, sX2l = sX2h + kFB;
  const uint32_t sW1h = sX2l + kFB, sW1l = sW1h + kTB;
  const uint32_t sW2h = sW1l + kTB, sW2l = sW2h + kTB;
  // stage st: raw Y1 at sRaw + 2 st kTB, Y2 after it; its rows at
  // sRows + st kRowBytes (-lse log2(e), then D)
  const uint32_t sRaw = sW2l + kTB;
  const uint32_t sRows = sRaw + kStages * 2 * kTB;
  // the generic address of shared address a
  auto gp = [&](uint32_t a) { return smem_raw + (a - raw); };

  const int G = H / K;
  int idx = blockIdx.x, b, kh, xh, x0, gs = 0, gper = 1, n_y, y_begin;
  if (DKDV) {
    const int kt = idx / (B * K * gsplit);  // key tile slowest: long first
    idx %= B * K * gsplit;
    gs = idx % gsplit;
    idx /= gsplit;
    kh = idx % K;
    b = idx / K;
    gper = G / gsplit;
    xh = kh;
    x0 = kt * kRows;
    // the query tiles that see these keys
    const int q_lo = causal ? x0 : 0;
    const int q_hi = window > 0 ? min(S, x0 + kRows - 1 + window) : S;
    y_begin = q_lo / kTile * kTile;
    n_y = q_hi > q_lo ? (q_hi - y_begin + kTile - 1) / kTile : 0;
  } else {
    const int qt = n_fix - 1 - idx / (B * H);  // long causal tiles first
    idx %= B * H;
    xh = idx % H;
    b = idx / H;
    kh = xh / G;
    x0 = qt * kRows;
    // the key tiles that hold a visible key for some row of these queries
    const int q_last = min(x0 + kRows, S) - 1;
    const int t_end = causal ? min(Tk, q_last + 1) : Tk;
    y_begin = window > 0 ? max(0, x0 - window + 1) / kTile * kTile : 0;
    n_y = t_end > y_begin ? (t_end - y_begin + kTile - 1) / kTile : 0;
  }
  const int n_it = gper * n_y;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(smem_u32(&fix_full), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    if (tid == kConsumers && n_it > 0) {
      const uint32_t xf = smem_u32(&fix_full);
      mbar_expect_tx(xf, 2 * kFB);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        tma_load_4d(sX1h + s * kXSlab, &tm_x1, xf, s * kSlab, xh, x0, b);
        tma_load_4d(sX2h + s * kXSlab, &tm_x2, xf, s * kSlab, xh, x0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        if (it >= kStages)  // the consumers have read its last fill
          mbar_wait(smem_u32(&empty[st]), ((it / kStages) - 1) & 1);
        const int yh = DKDV ? kh * G + gs * gper + it / n_y : kh;
        const int y0 = y_begin + (it % n_y) * kTile;
        const uint32_t f = smem_u32(&full[st]);
        const uint32_t cY1 = sRaw + st * 2 * kTB, cY2 = cY1 + kTB;
        mbar_expect_tx(f, 2 * kTB + (DKDV ? L::kRowBytes : 0));
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          tma_load_4d(cY1 + s * kYSlab, &tm_y1, f, s * kSlab, yh, y0, b);
          tma_load_4d(cY2 + s * kYSlab, &tm_y2, f, s * kSlab, yh, y0, b);
        }
        if (DKDV) {
          const size_t row = ((size_t)b * H + yh) * S_pad + y0;
          const uint32_t cR = sRows + st * L::kRowBytes;
          bulk_load(cR, nl + row, kTile * 4, f);
          bulk_load(cR + kTile * 4, delta + row, kTile * 4, f);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: accumulator rows x0 + 16 warp + lane / 4
  // (+ 8), keys (DKDV) or queries; columns 8 j + cq + c of the streamed
  // tile ----
  const int warp = tid / 32, lane = tid % 32;
  const int rr0 = x0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl2 = scale * kLog2e;
  float nlr[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  if (!DKDV) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int r = rr0 + 8 * ii;
      const size_t i = ((size_t)b * H + xh) * S_pad + r;
      nlr[ii] = r < S ? nl[i] : 0.f;
      dd[ii] = r < S ? delta[i] : 0.f;
    }
  }
  float acc1[HDP / 2], acc2[HDP / 2], c1[16], c2[16];
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j) acc1[j] = acc2[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) c1[j] = c2[j] = 0.f;

  if (n_it > 0) {
    // X1 and X2 split in place: hi over the raw tile
    mbar_wait(smem_u32(&fix_full), 0);
    split_copy(gp(sX1h), gp(sX1h), gp(sX1l), kFB, tid, kConsumers);
    split_copy(gp(sX2h), gp(sX2h), gp(sX2l), kFB, tid, kConsumers);
    fence_async_smem();
    consumers_sync();
  }
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int y0 = y_begin + (it % n_y) * kTile;
    const uint32_t cY1 = sRaw + st * 2 * kTB, cY2 = cY1 + kTB;
    const float* rows =
        reinterpret_cast<const float*>(gp(sRows + st * L::kRowBytes));
    mbar_wait(smem_u32(&full[st]), (it / kStages) & 1);
    // some (row, column) pair of this 64 x 32 is visible
    const bool any =
        DKDV ? x0 < Tk && y0 < S && (!causal || y0 + kTile - 1 >= x0) &&
                   (window <= 0 || y0 - (x0 + kRows - 1) < window)
             : x0 < S && y0 < Tk && (!causal || y0 <= x0 + kRows - 1) &&
                   (window <= 0 || x0 - (y0 + kTile - 1) < window);
    if (any) {
      // W = Y1, Y2 split as stored (the last tile's products are done)
      consumers_sync();
      split_copy(gp(cY1), gp(sW1h), gp(sW1l), kTB, tid, kConsumers);
      split_copy(gp(cY2), gp(sW2h), gp(sW2l), kTB, tid, kConsumers);
      fence_async_smem();
      consumers_sync();
      // C1 = X1 Y1^T and C2 = X2 Y2^T (S^T and dP^T, or S and dP), two
      // commit groups; the correction terms, then hi hi
      reg_fence(c1);
      reg_fence(c2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 8; ++kk) {
        const uint32_t xa = (kk >> 2) * kXSlab + (kk & 3) * 32;
        const uint32_t yb = (kk >> 2) * kYSlab + (kk & 3) * 32;
        wgmma_ss(c1, sw128_desc(sX1h + xa), sw128_desc(sW1l + yb), kk != 0);
        wgmma_ss(c1, sw128_desc(sX1l + xa), sw128_desc(sW1h + yb), 1);
      }
#pragma unroll
      for (int kk = 0; kk < HDP / 8; ++kk) {
        const uint32_t xa = (kk >> 2) * kXSlab + (kk & 3) * 32;
        const uint32_t yb = (kk >> 2) * kYSlab + (kk & 3) * 32;
        wgmma_ss(c1, sw128_desc(sX1h + xa), sw128_desc(sW1h + yb), 1);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HDP / 8; ++kk) {
        const uint32_t xa = (kk >> 2) * kXSlab + (kk & 3) * 32;
        const uint32_t yb = (kk >> 2) * kYSlab + (kk & 3) * 32;
        wgmma_ss(c2, sw128_desc(sX2h + xa), sw128_desc(sW2l + yb), kk != 0);
        wgmma_ss(c2, sw128_desc(sX2l + xa), sw128_desc(sW2h + yb), 1);
      }
#pragma unroll
      for (int kk = 0; kk < HDP / 8; ++kk) {
        const uint32_t xa = (kk >> 2) * kXSlab + (kk & 3) * 32;
        const uint32_t yb = (kk >> 2) * kYSlab + (kk & 3) * 32;
        wgmma_ss(c2, sw128_desc(sX2h + xa), sw128_desc(sW2h + yb), 1);
      }
      wgmma_commit();
      const bool edge =
          DKDV ? (causal && x0 + kRows - 1 > y0) ||
                     (window > 0 && y0 + kTile - 1 - x0 >= window) ||
                     y0 + kTile > S || x0 + kRows > Tk
               : (causal && y0 + kTile - 1 > x0) ||
                     (window > 0 && x0 + kRows - 1 - y0 >= window) ||
                     y0 + kTile > Tk || x0 + kRows > S;
      wgmma_wait<1>();  // C1 is in
      reg_fence(c1);
      // P (P^T); element [4 j + 2 ii + c] is row rr0 + 8 ii, column
      // y0 + 8 j + cq + c
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int ii = (e >> 1) & 1, col = 8 * (e >> 2) + cq + (e & 1);
        float p = ex2(fmaf(c1[e], sl2, DKDV ? rows[col] : nlr[ii]));
        if (edge && !(DKDV ? visible(y0 + col, rr0 + 8 * ii, S, Tk, causal,
                                     window)
                           : visible(rr0 + 8 * ii, y0 + col, S, Tk, causal,
                                     window)))
          p = 0.f;
        c1[e] = p;
      }
      wgmma_wait<0>();  // C2 is in
      reg_fence(c2);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int ii = (e >> 1) & 1, col = 8 * (e >> 2) + cq + (e & 1);
        c2[e] = c1[e] * (c2[e] - (DKDV ? rows[kTile + col] : dd[ii]));
      }
      // W = Y1^T (and Y2^T), split and transposed (C1 and C2 have read W)
      consumers_sync();
      split_transpose<HDP>(gp(cY1), gp(sW1h), gp(sW1l), tid, kConsumers);
      if (DKDV)
        split_transpose<HDP>(gp(cY2), gp(sW2h), gp(sW2l), tid, kConsumers);
      fence_async_smem();
      consumers_sync();
    }
    if (tid == 0) mbar_arrive(smem_u32(&empty[st]));  // raw stage free
    if (any) {
      // DKDV: dV += P^T dO (A = P^T, B = dO^T in W2), dK += dS^T Q (B =
      // Q^T in W1); else dQ += dS K (B = K^T in W1)
      constexpr int CH = HDP < 64 ? HDP : 64;  // the column chunk
      uint32_t fh[kTile / 8][4], fl[kTile / 8][4];
      if (DKDV) {
#pragma unroll
        for (int kk = 0; kk < kTile / 8; ++kk) a_frag(c1, kk, fh[kk], fl[kk]);
        add_product<HDP, CH>(acc2, fh, fl, sW2h, sW2l);
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 8; ++kk) a_frag(c2, kk, fh[kk], fl[kk]);
      add_product<HDP, CH>(acc1, fh, fl, sW1h, sW1l);
    }
  }

  // acc[4 j + 2 ii + c] is row rr0 + 8 ii, column 8 j + cq + c
  if (!DKDV) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int qi = rr0 + 8 * ii;
      if (qi >= S) continue;
      float* row = out1 + (((size_t)b * S + qi) * H + xh) * hd;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < hd)
          *reinterpret_cast<float2*>(row + col) = make_float2(
              acc1[4 * j + 2 * ii] * scale, acc1[4 * j + 2 * ii + 1] * scale);
      }
    }
    return;
  }
  // dK, dV: straight to the grads, or this group's partials ws [gsplit][2]
  // [B][T][K][hd] when the heads are split
  const size_t plane = (size_t)B * Tk * K * hd;
  float* pk = gsplit == 1 ? out1 : ws + (size_t)gs * 2 * plane;
  float* pv = gsplit == 1 ? out2 : pk + plane;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int kr = rr0 + 8 * ii;
    if (kr >= Tk) continue;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= hd) continue;
      const size_t off = (((size_t)b * Tk + kr) * K + kh) * hd + col;
      *reinterpret_cast<float2*>(pk + off) = make_float2(
          acc1[4 * j + 2 * ii] * scale, acc1[4 * j + 2 * ii + 1] * scale);
      *reinterpret_cast<float2*>(pv + off) =
          make_float2(acc2[4 * j + 2 * ii], acc2[4 * j + 2 * ii + 1]);
    }
  }
  if (gsplit == 1) return;
  // the last group of this key tile to finish sums the partials in group
  // order
  __threadfence();
  consumers_sync();
  int* ticket = tickets + ((size_t)b * K + kh) * n_fix + x0 / kRows;
  if (tid == 0) s_last = atomicAdd(ticket, 1) == gsplit - 1;
  consumers_sync();
  if (!s_last) return;
  __threadfence();
  const int rows = min(kRows, Tk - x0), pairs = hd / 2;
  for (int i = tid; i < rows * pairs; i += kConsumers) {
    const int r = i / pairs, col = 2 * (i % pairs);
    const size_t off = (((size_t)b * Tk + x0 + r) * K + kh) * hd + col;
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
    *reinterpret_cast<float2*>(out1 + off) = sk;
    *reinterpret_cast<float2*>(out2 + off) = sv;
  }
  if (tid == 0) *ticket = 0;  // ready for another call
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

// A 4-D map over a contiguous float32 [batch, rows, heads, hd] tensor; box
// 32 columns x 1 head x `box_rows` rows x 1 batch, 128-byte swizzle, zeros
// outside the tensor.
bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int hd,
              int heads, int rows, int batch, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t row = (cuuint64_t)hd * 4;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * rows};
  const cuuint32_t box[4] = {kSlab, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *o, *lse, *d_o;
  float *dq, *dk, *dv;
  float *nl, *delta;  // [B, H, S_pad] each
  float* ws;
  int* tickets;
  int B, S, S_pad, T, H, K, hd, causal, window, gsplit;
  float scale;
  cudaStream_t stream;
  cudaEvent_t* events;  // null, or four events to record around the launches
};

// the fixed tiles' maps (64-row boxes) and the streamed tiles' (32)
struct Maps {
  CUtensorMap q64, do64, k64, v64, q32, do32, k32, v32;
};

// records events[i] on the stream, where the caller asked for them
cudaError_t mark(const Args& a, int i) {
  return a.events ? cudaEventRecord(a.events[i], a.stream) : cudaSuccess;
}

template <int HDP>
cudaError_t launch_products(const Args& a, const Maps& m) {
  constexpr size_t smem = PassSmem<HDP>::bytes;
  auto dkdv = flash_bwd_tf32_kernel<HDP, true>;
  auto dq = flash_bwd_tf32_kernel<HDP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int n_kt = (a.T + kRows - 1) / kRows;
  const int n_qt = (a.S + kRows - 1) / kRows;
  dkdv<<<n_kt * a.B * a.K * a.gsplit, kThreads, smem, a.stream>>>(
      m.k64, m.v64, m.q32, m.do32, a.nl, a.delta, a.dk, a.dv, a.ws,
      a.tickets, a.B, a.S, a.S_pad, a.T, a.H, a.K, a.hd, a.causal, a.window,
      a.scale, a.gsplit, n_kt);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(a, 2);
  if (err != cudaSuccess) return err;
  dq<<<n_qt * a.B * a.H, kThreads, smem, a.stream>>>(
      m.q64, m.do64, m.k32, m.v32, a.nl, a.delta, a.dq, nullptr, nullptr,
      nullptr, a.B, a.S, a.S_pad, a.T, a.H, a.K, a.hd, a.causal, a.window,
      a.scale, 1, n_qt);
  return cudaGetLastError();
}

}  // namespace

// q, o, dO, dq [B, S, H, hd]; k, v, dk, dv [B, T, K, hd]; all contiguous
// float32 on CUDA device `device`, 16-byte aligned (the TMA maps' rule);
// H % K == 0, hd % 8 == 0, 8 <= hd <= 128; lse [B, H, S] float32, the
// forward's. rows is [2, B, H, S_pad] float32 scratch, S_pad = S rounded
// up to a multiple of 64 (written: -lse log2(e) and D). Each KV head's G
// query heads are split into `gsplit` groups (G % gsplit == 0); with
// gsplit > 1, ws holds gsplit x 2 x B T K hd floats and tickets B K
// ceil(T / 64) zeroed ints, which the call leaves at 0. window <= 0 means
// no window. Launches three kernels on `stream` and returns the first CUDA
// error (0 when all three were accepted; cudaErrorInvalidValue for a shape
// it does not take or a tensor map that cuTensorMapEncodeTiled refused).
// `events`, where not null, holds four created events, recorded before D,
// after D, after dK / dV and after dQ, so a caller can time each launch.
extern "C" int flash_attention_bwd_tf32_launch(
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
  Args a{o, lse, d_o, static_cast<float*>(dq), static_cast<float*>(dk),
         static_cast<float*>(dv), nl, nl + (size_t)B * H * S_pad,
         static_cast<float*>(ws), static_cast<int*>(tickets), B, S, S_pad,
         T, H, K, hd, causal, window, gsplit, scale,
         static_cast<cudaStream_t>(stream), static_cast<cudaEvent_t*>(events)};
  const EncodeTiledFn enc = encode_tiled();
  Maps m;
  if (enc == nullptr || !make_map(enc, &m.q64, q, hd, H, S, B, kRows) ||
      !make_map(enc, &m.do64, d_o, hd, H, S, B, kRows) ||
      !make_map(enc, &m.k64, k, hd, K, T, B, kRows) ||
      !make_map(enc, &m.v64, v, hd, K, T, B, kRows) ||
      !make_map(enc, &m.q32, q, hd, H, S, B, kTile) ||
      !make_map(enc, &m.do32, d_o, hd, H, S, B, kTile) ||
      !make_map(enc, &m.k32, k, hd, K, T, B, kTile) ||
      !make_map(enc, &m.v32, v, hd, K, T, B, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = mark(a, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d_rows = B * S_pad * H;
  flash_bwd_delta_tf32_kernel<<<(d_rows + kDThreads / 16 - 1) /
                                    (kDThreads / 16),
                                kDThreads, 0, a.stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(d_o),
      static_cast<const float*>(lse), a.nl, a.delta, d_rows, S, S_pad, H, hd);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(a, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hd <= 32   ? launch_products<32>(a, m)
        : hd <= 64 ? launch_products<64>(a, m)
                   : launch_products<128>(a, m);
  if (err == cudaSuccess) err = mark(a, 3);
  return static_cast<int>(err);
}
