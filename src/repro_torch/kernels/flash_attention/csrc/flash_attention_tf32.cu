// Flash-attention forward kernel for Hopper (sm_90a) on the tensor cores in
// float32: split TF32 ("tf32x3"), head_dim a multiple of 8 up to 128.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _fwd_kernel (launched by flash_attention_fwd; public op ops.py::
// flash_attention) for float32, as kernel.py::route sends it here; bf16 is
// flash_attention_wgmma.cu's, a head_dim that is not a multiple of 8 the
// SIMT kernel's (flash_attention.cu). It computes the port's plain
// version, src/repro_torch/kernels/flash_attention/ref.py::attention_ref:
// causal and/or sliding-window GQA attention, query head h reading KV head
// h / (H / K), positions 0..S-1 (queries) and 0..T-1 (keys), scores scaled
// by hd^-0.5 and masked to -1e30, softmax, the weighted sum of V, all in
// float32.
//
// The split. TF32 keeps 10 of float32's 23 mantissa bits, too few for the
// float32 bar (2e-5). Each operand x is written x = hi + lo, hi the TF32
// value nearest x (cvt.rna) and lo the TF32 value nearest x - hi (which is
// exact in float32); then a b = hi_a hi_b + hi_a lo_b + lo_a hi_b up to
// lo_a lo_b and lo's rounding, about 2^-22 of |a b|, summed in float32 on
// the tensor cores: per product the two correction terms first, hi hi
// last, into one accumulator. It is the arithmetic of CUTLASS's
// OpMultiplyAddFastF32 (PyTorch's float32 memory-efficient attention on
// sm80+); ref.py::mm_tf32x3 models it for the tests.
//
// Bound. The QK^T and PV products, 4 B H hd S(S+1)/2 flops for causal
// attention, three TF32 products each: at the 8 x 1,024-token qwen3-8b
// prefill per layer 6.9e10 flop, 0.417 ms at 3 x the TF32 tensor rate,
// where float32 FMAs outside the tensor cores would take 1.03 ms and the
// bytes (q, k, v read once, o written once) 0.10 ms. So operations bound
// it, and only wgmma reaches a rate above the FFMA one.
//
// Design. One block takes one (head, batch, 128-row query tile), walked
// last first (blockIdx.z reversed) so the long causal tiles start first.
// 288 threads: consumer warpgroups 0 and 1 own query rows 0-63 and 64-127,
// warp 8 is the producer, whose one elected thread issues TMA loads.
//  - TMA: 4-D tensor maps over the model's [B, S, H, hd] and [B, T, K, hd]
//    float32 layouts; a box is 32 columns (128 bytes) with the 128-byte
//    swizzle, so head_dim 128 is four 32-column slabs; columns past hd and
//    rows past S or T read as zeros. Q comes once, K and V in 32-key tiles
//    through a ring of raw stages (full / empty mbarriers, expect_tx).
//  - Layout. For 32-bit types wgmma reads shared-memory operands K-major
//    only. S = Q K^T reads Q and K as stored (hd is their K dimension).
//    O += P V needs V^T (keys as K): V is transposed in shared memory.
//  - Split passes. Each warpgroup splits its 64 rows of Q in place (the
//    raw tile becomes hi, lo goes to a second buffer) once. Per KV tile the
//    256 consumer threads read the raw stage once and write K hi / lo in
//    the layout it arrived in (element by element, the swizzle kept) and
//    V^T hi / lo transposed into the swizzled K-major layout wgmma reads
//    (float4 reads along a key's row, 32 keys a warp, scalar writes along
//    a column: both free of bank conflicts); then the raw stage goes back
//    to the producer, so the next tile's copy overlaps this one's
//    products. A fence.proxy.async makes the writes visible to wgmma.
//  - P from registers. The S accumulator's layout gives a thread keys
//    2t and 2t + 1 of each 8, where a TF32 A fragment wants keys t and
//    t + 4. Rather than shuffle, the K dimension is permuted: A position
//    t holds key 2t, position t + 4 key 2t + 1, and the V^T pass writes
//    key j of each 8 at position j / 2 + 4 (j % 2), so the product is the
//    same sum. P is split into hi / lo in registers.
//  - Shared memory at hd 128: Q hi + lo 2 x 64 KB, one raw stage (K, V) 32
//    KB, K hi / lo and V^T hi / lo 4 x 16 KB: 224 KB of the 227. So the
//    key tile is 32 (64 would need 128 KB of split K / V alone) and the
//    ring holds one stage at hd 128, two below it.
//  - S = Q K^T: wgmma m64n32k8, A (Q hi or lo) and B (K hi or lo) from
//    shared memory, hd / 8 k-steps x 3. Online softmax in the accumulator's
//    register layout as the bf16 kernel's: scores stay raw, e^(scale
//    (s - m)) is one FFMA and one ex2; masked scores are -1e30 (scaled),
//    keys past T -inf; only tiles that cross the diagonal, the window edge
//    or T are masked element by element, tiles outside the band are not
//    loaded, and a warpgroup skips the products of a tile none of its rows
//    sees. O += P V: wgmma m64n{hd}k8, A = P from registers, B = V^T hi or
//    lo, 4 k-steps x 3. m, l and O stay in float32 registers.
//  - Epilogue: O / max(l, 1e-30) stored as float32 from registers; given an
//    lse pointer (the training forward), each row's natural log-sum-exp,
//    scale m + log(l), [B, H, S] float32, for the backward
//    (flash_attention_bwd_tf32.cu).
// The tensor map encoder is the driver's cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so the library links no libcuda.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;              // query rows per block
constexpr int kBN = 32;               // keys per K / V tile
constexpr int kSlab = 32;             // float32 columns per swizzled box
constexpr int kThreads = 288;         // 2 consumer warpgroups + 1 producer warp
constexpr int kConsumers = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the HDP instance (HDP = hd rounded up to 32, 64 or 128)
template <int HDP>
struct FwdSmem {
  static constexpr int NS = HDP / kSlab;            // 32-column slabs
  static constexpr int kStages = HDP == 128 ? 1 : 2;  // raw K / V ring
  static constexpr int kQBytes = NS * kBM * 128;    // Q hi or lo
  // a raw K or V tile, K hi or lo (32 rows x HDP), V^T hi or lo (HDP rows
  // x 32 keys): HDP x 128 bytes each
  static constexpr int kTileBytes = HDP * 128;
  // Q hi, Q lo; K hi, K lo, V^T hi, V^T lo; kStages x (raw K, raw V); 1 KB
  // to align the base
  static constexpr size_t bytes = 1024 + 2 * (size_t)kQBytes +
                                  (4 + 2 * kStages) * (size_t)kTileBytes;
};

struct Barriers {
  uint64_t q_full, full[2], empty[2];
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
// accumulator's column 2t and position t + 4 its column 2t + 1 (the A
// fragment of a k-step is then d[4 kk], d[4 kk + 2], d[4 kk + 1],
// d[4 kk + 3]; see a_frag)
__device__ __forceinline__ int k_perm(int j) {
  return (j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2);
}

// Split transpose of a raw [32 rows x HDP] tile (TMA layout: HDP / 32
// slabs of 32 rows x 128 bytes, swizzled) into hi and lo [HDP rows x 32]
// K-major tiles, row j of the source at K position k_perm(j). Thread
// `t` of `n_threads` (a multiple of 32) reads float4s of row t % 32.
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

// Split of `bytes` of a tile in place of its layout: hi over the raw
// values (hi may be raw), lo beside them
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

// One tile's online softmax for a thread's two rows, as
// flash_attention_wgmma.cu's over 32 keys. The scores stay raw (q . k,
// unscaled; masked scores are -1e30 / scale, i.e. -1e30 once scaled) and m
// with them, so e^(scale (s - m)) is one FFMA and one ex2. Masks s
// [4 j + 2 ii + c] (row r0 + 8 ii, key t0 + 8 j + cq + c) in place, turns
// it into e^(scale (s - m_new)), and updates m and l; returns the factor
// corr by which the rows' O must be rescaled.
__device__ __forceinline__ void online_softmax(
    float (&s)[16], float (&m_i)[2], float (&l_i)[2], float (&corr)[2],
    bool edge, int r0, int t0, int cq, int causal, int window, int Tk,
    float sl2, float neg_raw) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int idx = 0; idx < 16; ++idx) {
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
    for (int idx = 0; idx < 16; ++idx) {
      const int ii = (idx >> 1) & 1;
      s[idx] = ex2((s[idx] - m_i[ii]) * sl2);
      ps[ii] += s[idx];
    }
  } else {
#pragma unroll
    for (int idx = 0; idx < 16; ++idx) {
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

// Named barrier 1 (0 is __syncthreads') joins the 256 consumer threads;
// 2 + wg one warpgroup's 128.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          float* __restrict__ o, float* __restrict__ lse,
                          int S, int Tk, int H, int K, int hd, int causal,
                          int window, float scale) {
  using L = FwdSmem<HDP>;
  constexpr int NS = L::NS, kStages = L::kStages, kTB = L::kTileBytes;
  constexpr int kQSlab = kBM * 128, kKSlab = kBN * 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers bars;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQh = (raw + 1023u) & ~1023u;
  const uint32_t sQl = sQh + L::kQBytes;
  const uint32_t sKh = sQl + L::kQBytes, sKl = sKh + kTB;
  const uint32_t sVh = sKl + kTB, sVl = sVh + kTB;
  const uint32_t sRaw = sVl + kTB;  // stage st: K at + 2 st kTB, V after
  // the generic address of shared address a
  auto gp = [&](uint32_t a) { return smem_raw + (a - raw); };

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
      mbar_init(smem_u32(&bars.full[s]), 1);
      mbar_init(smem_u32(&bars.empty[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    if (tid == kConsumers) {
      const uint32_t qf = smem_u32(&bars.q_full);
      mbar_expect_tx(qf, L::kQBytes);
#pragma unroll
      for (int s = 0; s < NS; ++s)
        tma_load_4d(sQh + s * kQSlab, &tm_q, qf, s * kSlab, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, t0 = t_begin + i * kBN;
        if (i >= kStages)  // the consumers have read this stage's last fill
          mbar_wait(smem_u32(&bars.empty[st]), ((i / kStages) - 1) & 1);
        const uint32_t f = smem_u32(&bars.full[st]);
        const uint32_t cK = sRaw + st * 2 * kTB, cV = cK + kTB;
        mbar_expect_tx(f, 2 * kTB);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          tma_load_4d(cK + s * kKSlab, &tm_k, f, s * kSlab, kh, t0, b);
          tma_load_4d(cV + s * kKSlab, &tm_v, f, s * kSlab, kh, t0, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows wg * 64 .. + 63 ----
  const int wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int rw0 = q0 + wg * 64;                    // the warpgroup's rows
  const int r0 = rw0 + warp * 16 + lane / 4;       // rows r0 and r0 + 8
  const int cq = 2 * (lane % 4);                   // column pair in an 8
  const float sl2 = scale * kLog2e, neg_raw = kNegInf / scale;
  float oacc[HDP / 2], s[16];
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j) oacc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = 0.f;
  float m_i[2] = {neg_raw, neg_raw};
  float l_i[2] = {0.f, 0.f}, corr[2];

  // this warpgroup's Q rows, split in place: hi over the raw tile
  mbar_wait(smem_u32(&bars.q_full), 0);
#pragma unroll
  for (int ns = 0; ns < NS; ++ns) {
    const uint32_t off = ns * kQSlab + wg * 64 * 128;
    split_copy(gp(sQh + off), gp(sQh + off), gp(sQl + off), 64 * 128, wt,
               128);
  }
  fence_async_smem();
  warpgroup_sync(wg);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages, t0 = t_begin + i * kBN;
    const uint32_t cK = sRaw + st * 2 * kTB, cV = cK + kTB;
    mbar_wait(smem_u32(&bars.full[st]), (i / kStages) & 1);
    // both warpgroups are done with the last tile's split operands
    consumers_sync();
    split_copy(gp(cK), gp(sKh), gp(sKl), kTB, tid, kConsumers);
    split_transpose<HDP>(gp(cV), gp(sVh), gp(sVl), tid, kConsumers);
    fence_async_smem();
    consumers_sync();
    if (tid == 0) mbar_arrive(smem_u32(&bars.empty[st]));  // raw stage free

    // some (row, key) pair of this warpgroup's 64 x 32 is visible
    const bool any = rw0 < S && (!causal || t0 <= rw0 + 63) &&
                     (window <= 0 || rw0 - (t0 + kBN - 1) < window);
    if (!any) continue;
    // S = Q K^T: the correction terms, then hi hi
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 8; ++kk) {
      const uint32_t qa = (kk >> 2) * kQSlab + wg * 64 * 128 + (kk & 3) * 32;
      const uint32_t kb = (kk >> 2) * kKSlab + (kk & 3) * 32;
      wgmma_ss(s, sw128_desc(sQh + qa), sw128_desc(sKl + kb), kk != 0);
      wgmma_ss(s, sw128_desc(sQl + qa), sw128_desc(sKh + kb), 1);
    }
#pragma unroll
    for (int kk = 0; kk < HDP / 8; ++kk) {
      const uint32_t qa = (kk >> 2) * kQSlab + wg * 64 * 128 + (kk & 3) * 32;
      const uint32_t kb = (kk >> 2) * kKSlab + (kk & 3) * 32;
      wgmma_ss(s, sw128_desc(sQh + qa), sw128_desc(sKh + kb), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    // only tiles that cross the diagonal, the window edge or T are masked
    const bool edge = (causal && t0 + kBN - 1 > rw0) ||
                      (window > 0 && rw0 + 63 - t0 >= window) ||
                      t0 + kBN > Tk;
    online_softmax(s, m_i, l_i, corr, edge, r0, t0, cq, causal, window, Tk,
                   sl2, neg_raw);
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) oacc[j] *= corr[(j >> 1) & 1];
    // O += P V: P from registers, V^T hi / lo from shared memory
    uint32_t ph[kBN / 8][4], pl[kBN / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk) a_frag(s, kk, ph[kk], pl[kk]);
    reg_fence(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk) {
      wgmma_rs(oacc, ph[kk], sw128_desc(sVl + kk * 32), 1);
      wgmma_rs(oacc, pl[kk], sw128_desc(sVh + kk * 32), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk)
      wgmma_rs(oacc, ph[kk], sw128_desc(sVh + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(oacc);
  }

  // O / l; oacc[4 j + 2 ii + c] is row r0 + 8 ii, column 8 j + cq + c
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int qi = r0 + 8 * ii;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l_i[ii], 1e-30f);
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * H + h) * S + qi] = scale * m_i[ii] + logf(l_i[ii]);
    float* orow = o + ((size_t)b * S + qi) * H * hd + (size_t)h * hd;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < hd)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(oacc[4 * j + 2 * ii] * inv,
                        oacc[4 * j + 2 * ii + 1] * inv);
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

template <int HDP>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, void* o, float* lse, int B, int S,
                   int Tk, int H, int K, int hd, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = FwdSmem<HDP>::bytes;
  auto kern = flash_fwd_tf32_kernel<HDP>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(H, B, (S + kBM - 1) / kBM), block(kThreads);
  kern<<<grid, block, smem, stream>>>(mq, mk, mv, static_cast<float*>(o), lse,
                                      S, Tk, H, K, hd, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o [B, S, H, hd]; k, v [B, T, K, hd]; all contiguous float32 on CUDA
// device `device`, 16-byte aligned; H % K == 0, hd % 8 == 0, 8 <= hd <=
// 128. lse, if not null, is [B, H, S] float32 and receives each row's
// log-sum-exp. window <= 0 means no window. Launches on `stream` and
// returns the CUDA error of the launch (0 when it was accepted;
// cudaErrorInvalidValue for a shape it does not take or a tensor map the
// driver refused).
extern "C" int flash_attention_tf32_launch(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int S, int T, int H, int K,
                                           int hd, int causal, int window,
                                           float scale, int device,
                                           void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (hd % 8 != 0 || hd < 8 || hd > 128 || K < 1 || H % K != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn enc = encode_tiled();
  CUtensorMap mq, mk, mv;
  if (enc == nullptr || !make_map(enc, &mq, q, hd, H, S, B, kBM) ||
      !make_map(enc, &mk, k, hd, K, T, B, kBN) ||
      !make_map(enc, &mv, v, hd, K, T, B, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      hd <= 32   ? launch<32>(mq, mk, mv, o, l, B, S, T, H, K, hd, causal,
                              window, scale, st)
      : hd <= 64 ? launch<64>(mq, mk, mv, o, l, B, S, T, H, K, hd, causal,
                              window, scale, st)
                 : launch<128>(mq, mk, mv, o, l, B, S, T, H, K, hd, causal,
                               window, scale, st);
  return static_cast<int>(err);
}
