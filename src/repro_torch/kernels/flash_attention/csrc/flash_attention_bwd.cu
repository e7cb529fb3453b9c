// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of causal
// and/or sliding-window GQA attention, three launches a call.
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
// (keys); scores are masked as the forward masks them.
//
// Bound. The function needs five products per visible (query, key) pair
// (S, dP, dV, dK, dQ): 2.5 times the forward's 4 B H hd S(S+1)/2 flops,
// at starcoder2-3b's training shape (4 x 2,048 tokens, 24 heads, hd 128,
// causal) 2.6e11 flop, 0.261 ms at the bf16 tensor-core rate, where the
// bytes (q, o, dO, dq, k, v, dk, dv, lse, D once each) take about
// 0.07 ms. So operations bound it, and only the tensor cores reach that
// rate. This design recomputes S and dP for dQ in a pass of its own, so
// it does seven products (3.5 times the forward's, 0.365 ms at that rate).
//
// Design (bf16, head_dim a multiple of 8 up to 128: the "mma" route).
//  (a) flash_bwd_delta_kernel: D, 16 lanes a row, 16-byte loads.
//  (b) flash_bwd_dkdv_mma_kernel: one block of 4 warps takes one (64-key
//      tile, KV head, batch, group of query heads) and loops over the
//      group's heads and, for each, over the 64-row query tiles that see
//      the key tile (causal: the tiles at or after it; a window: those
//      within it). Warp w owns keys 16 w .. 16 w + 15 and keeps their dK
//      and dV in float32 registers across all the heads, so GQA needs no
//      atomics. It computes S^T = K Q^T and dP^T = V dO^T (keys as the
//      rows), so that P^T and dS^T come out in the accumulator layout
//      that is the A operand of dV += P^T dO and dK += dS^T Q: no trip
//      through shared memory. Where B K (T / 64) blocks would not fill the
//      card once, two a multiprocessor (starcoder2-3b: 256 blocks of 12
//      heads, the first key tile's block 32 times the last's work), the
//      wrapper splits the G heads into `gsplit` groups: each block writes
//      its float32 partial dK / dV, and the last block of a key tile to
//      finish (an atomic ticket) sums the partials in group order and
//      writes bf16, so the result does not depend on which block finished
//      last; it also sets the ticket back to 0, so the wrapper keeps one
//      zeroed ticket buffer from call to call. Blocks are numbered key
//      tile slowest, so the long causal tiles start first.
//  (c) flash_bwd_dq_mma_kernel: one block of 4 warps takes one (64-row
//      query tile, head, batch), warp w the queries 16 w .. 16 w + 15,
//      loops over the key tiles its rows see, recomputes S and dP, and
//      accumulates dQ += dS K in float32 registers: deterministic, no
//      atomics. Query tiles are numbered last first (the long ones).
//  All products are mma.sync m16n8k16 (bf16 in, float32 accumulators),
//  their operands read with ldmatrix (.trans for the [k][n]-stored B
//  operands) from tiles that cp.async stages in shared memory, rows of
//  16-byte chunks XOR-swizzled by row % 8 so ldmatrix is conflict-free;
//  chunks past hd and rows past S or T are zero-filled. The next query
//  (b) or key (c) tile's copies are in flight while the current one is
//  multiplied (two buffers). P is rounded to bf16 after normalising, as
//  the plain version rounds it for its P V product; dS is rounded to bf16
//  for the dK and dQ products, and the grads are rounded to bf16 once at
//  the end. Only tiles that cross the diagonal, a window edge, S or T
//  are masked element by element.
// Float32 (and any other head_dim): the "simt" route, the same three
// kernels in float32 FMAs on the CUDA cores (no TF32, as the forward's
// SIMT route), P and dS passing through shared memory; no head split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query and key rows per tile (mma route)
constexpr int kThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes where !full (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
// 4 bytes from src, or 4 zero bytes where !full
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// The A operand of a k16 step from two neighbouring n8 accumulator tiles
// (rows g, g + 8; columns 16 kk .. 16 kk + 15), rounded to bf16
__device__ __forceinline__ void to_a(const float (&lo)[4],
                                     const float (&hi)[4], uint32_t (&a)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Shared address of 16-byte chunk c of row `row` in a [kTile][HDP] bf16
// tile at `base` (chunks XOR-swizzled by row % 8)
template <int HDP>
__device__ __forceinline__ uint32_t at(uint32_t base, int row, int c) {
  return base + (uint32_t)((row * (HDP / 8) + (c ^ (row & 7))) << 4);
}

// Rows r0 .. r0 + kTile - 1 of head `head` of a [B, N, heads, hd] bf16
// tensor into a swizzled tile (zeros past N and hd)
template <int HDP>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* x, int b,
                                          int r0, int N, int heads,
                                          int head, int hd) {
  constexpr int CH = HDP / 8;
  for (int j = threadIdx.x; j < kTile * CH; j += kThreads) {
    const int row = j / CH, c = j % CH, r = r0 + row;
    const bool full = r < N && c * 8 < hd;
    const __nv_bfloat16* src =
        full ? x + (((size_t)b * N + r) * heads + head) * hd + c * 8 : x;
    cp_async16(at<HDP>(dst, row, c), src, full);
  }
}

// x[bh, r0 .. r0 + kTile - 1] of a [B H, N] float32 tensor into shared
// memory (zeros past N)
__device__ __forceinline__ void load_row(uint32_t dst, const float* x,
                                         size_t bh, int r0, int N) {
  const int t = threadIdx.x;
  if (t < kTile) {
    const bool ok = r0 + t < N;
    cp_async4(dst + 4 * t, ok ? x + bh * N + r0 + t : x, ok);
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int S, int Tk,
                                        int causal, int window) {
  return qi < S && kj < Tk && (!causal || kj <= qi) &&
         (window <= 0 || qi - kj < window);
}

// a tile pair that some (query, key) of it does not see: masked element
// by element
__device__ __forceinline__ bool edge_tile(int q0, int t0, int tq, int tk,
                                          int S, int Tk, int causal,
                                          int window) {
  return (causal && t0 + tk - 1 > q0) ||
         (window > 0 && q0 + tq - 1 - t0 >= window) || q0 + tq > S ||
         t0 + tk > Tk;
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

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ d_o,
                           float* __restrict__ delta, int rows, int S, int H,
                           int hd) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 16;
  const int sub = threadIdx.x % 16;
  float acc = 0.f;
  if (row < rows) {
    const size_t base = (size_t)row * hd;
    if (VEC) {  // bf16, hd % 8 == 0, hd <= 128: one 16-byte chunk a lane
      if (sub * 8 < hd) {
        const uint4 a = *reinterpret_cast<const uint4*>(o + base + sub * 8);
        const uint4 g = *reinterpret_cast<const uint4*>(d_o + base + sub * 8);
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
    } else {
      for (int d = sub; d < hd; d += 16)
        acc = fmaf(to_f(o[base + d]), to_f(d_o[base + d]), acc);
    }
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
// (b) dK, dV on the tensor cores
// ---------------------------------------------------------------------------

template <int HDP>
constexpr size_t mma_smem_bytes() {
  // four tiles of kTile x HDP bf16 and two more, four rows of kTile
  // floats, and 128 bytes to align the base
  return 128 + 6 * (size_t)kTile * HDP * 2 + 4 * kTile * 4;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkdv_mma_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ d_o, const float* __restrict__ lse,
        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
        __nv_bfloat16* __restrict__ dv, float* __restrict__ ws,
        int* __restrict__ tickets, int B, int S, int Tk, int H, int K,
        int hd, int causal, int window, float scale, int gsplit, int n_kt) {
  constexpr int TB = kTile * HDP * 2;  // bytes of one tile
  constexpr int NT = HDP / 8;          // n8 tiles of dK / dV
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  const uint32_t sK = smem_u32(smem), sV = sK + TB;
  const uint32_t sQ = sV + TB, sdO = sQ + 2 * TB;  // two buffers each
  const uint32_t sL = sdO + 2 * TB, sD = sL + 2 * kTile * 4;
  const float* fL = reinterpret_cast<const float*>(smem + 6 * TB);
  const float* fD = fL + 2 * kTile;

  int idx = blockIdx.x;
  const int kt = idx / (B * K * gsplit);  // key tile slowest: long first
  idx %= B * K * gsplit;
  const int gs = idx % gsplit;
  idx /= gsplit;
  const int kh = idx % K, b = idx / K;
  const int G = H / K, gper = G / gsplit, g0 = gs * gper;
  const int t0 = kt * kTile;
  // the query tiles that see this key tile
  const int q_lo = causal ? t0 : 0;
  const int q_hi = window > 0 ? min(S, t0 + kTile - 1 + window) : S;
  const int qt_begin = q_lo / kTile;
  const int n_q = q_hi > q_lo ? (q_hi + kTile - 1) / kTile - qt_begin : 0;
  const int n_it = gper * n_q;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, c2 = 2 * (lane % 4);
  const float sl2 = scale * kLog2e;

  auto issue = [&](int it) {
    const int h = kh * G + g0 + it / n_q;
    const int r0 = (qt_begin + it % n_q) * kTile, buf = it & 1;
    load_tile<HDP>(sQ + buf * TB, q, b, r0, S, H, h, hd);
    load_tile<HDP>(sdO + buf * TB, d_o, b, r0, S, H, h, hd);
    load_row(sL + buf * kTile * 4, lse, (size_t)b * H + h, r0, S);
    load_row(sD + buf * kTile * 4, delta, (size_t)b * H + h, r0, S);
  };
  load_tile<HDP>(sK, k, b, t0, Tk, K, kh, hd);
  load_tile<HDP>(sV, v, b, t0, Tk, K, kh, hd);
  if (n_it > 0) issue(0);
  cp_async_commit();

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[n][c] = dva[n][c] = 0.f;

  // ldmatrix rows: the A operand (this warp's 16 keys), a B operand read
  // as stored [n][k] (16 queries), a B operand read transposed ([k][n])
  const int a_row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_col = lane >> 4;
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = (lane >> 3) & 1;
  const int kr0 = t0 + 16 * warp + g8;  // this thread's keys kr0, kr0 + 8

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = it & 1, q0 = (qt_begin + it % n_q) * kTile;
    const uint32_t cQ = sQ + buf * TB, cdO = sdO + buf * TB;
    const float* Ls = fL + buf * kTile;
    const float* Ds = fD + buf * kTile;

    // S^T = K Q^T and dP^T = V dO^T: [16 keys x 64 queries] a warp
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[j][c] = dpt[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(at<HDP>(sK, a_row, 2 * kk + a_col), ak);
      ldsm_x4(at<HDP>(sV, a_row, 2 * kk + a_col), av);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4], bo[4];
        ldsm_x4(at<HDP>(cQ, 16 * np + b_row, 2 * kk + b_col), bq);
        ldsm_x4(at<HDP>(cdO, 16 * np + b_row, 2 * kk + b_col), bo);
        mma(st[2 * np], ak, bq[0], bq[1]);
        mma(st[2 * np + 1], ak, bq[2], bq[3]);
        mma(dpt[2 * np], av, bo[0], bo[1]);
        mma(dpt[2 * np + 1], av, bo[2], bo[3]);
      }
    }
    // P^T = exp(scale s - lse), dS^T = P^T (dP^T - D); element [j][c] is
    // key kr0 + 8 (c >> 1), query q0 + 8 j + c2 + (c & 1)
    const bool edge =
        edge_tile(q0, t0, kTile, kTile, S, Tk, causal, window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(Ls + 8 * j + c2);
      const float2 d2 = *reinterpret_cast<const float2*>(Ds + 8 * j + c2);
      const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
      const float dd[2] = {d2.x, d2.y};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = ex2(fmaf(st[j][c], sl2, nl[c & 1]));
        if (edge && !visible(q0 + 8 * j + c2 + (c & 1), kr0 + 8 * (c >> 1),
                             S, Tk, causal, window))
          p = 0.f;
        dpt[j][c] = p * (dpt[j][c] - dd[c & 1]);
        st[j][c] = p;
      }
    }
    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t pa[4], sa[4];
      to_a(st[2 * kq], st[2 * kq + 1], pa);
      to_a(dpt[2 * kq], dpt[2 * kq + 1], sa);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(at<HDP>(cdO, 16 * kq + a_row - 16 * warp,
                              2 * np + a_col),
                      bo);
        ldsm_x4_trans(at<HDP>(cQ, 16 * kq + a_row - 16 * warp,
                              2 * np + a_col),
                      bq);
        mma(dva[2 * np], pa, bo[0], bo[1]);
        mma(dva[2 * np + 1], pa, bo[2], bo[3]);
        mma(dka[2 * np], sa, bq[0], bq[1]);
        mma(dka[2 * np + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

  if (gsplit == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + c2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kr = kr0 + 8 * half;
        if (col >= hd || kr >= Tk) continue;
        const size_t off = (((size_t)b * Tk + kr) * K + kh) * hd + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
            dka[n][2 * half] * scale, dka[n][2 * half + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(
            dva[n][2 * half], dva[n][2 * half + 1]);
      }
    }
    return;
  }
  // this group's float32 partials: ws [gsplit][2][B][T][K][hd]
  const size_t plane = (size_t)B * Tk * K * hd;
  float* pk = ws + (size_t)gs * 2 * plane;
  float* pv = pk + plane;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + c2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kr = kr0 + 8 * half;
      if (col >= hd || kr >= Tk) continue;
      const size_t off = (((size_t)b * Tk + kr) * K + kh) * hd + col;
      *reinterpret_cast<float2*>(pk + off) =
          make_float2(dka[n][2 * half] * scale, dka[n][2 * half + 1] * scale);
      *reinterpret_cast<float2*>(pv + off) =
          make_float2(dva[n][2 * half], dva[n][2 * half + 1]);
    }
  }
  // the last group of this key tile to finish sums the partials in group
  // order and writes bf16
  __threadfence();
  __syncthreads();
  int* ticket = tickets + ((size_t)b * K + kh) * n_kt + kt;
  if (tid == 0) s_last = atomicAdd(ticket, 1) == gsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int rows = min(kTile, Tk - t0), pairs = hd / 2;
  for (int i = tid; i < rows * pairs; i += kThreads) {
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

// ---------------------------------------------------------------------------
// (c) dQ on the tensor cores
// ---------------------------------------------------------------------------

template <int HDP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ d_o,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int B, int S,
                            int Tk, int H, int K, int hd, int causal,
                            int window, float scale, int n_qt) {
  constexpr int TB = kTile * HDP * 2;
  constexpr int NT = HDP / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  const uint32_t sQ = smem_u32(smem), sdO = sQ + TB;
  const uint32_t sK = sdO + TB, sV = sK + 2 * TB;  // two buffers each

  int idx = blockIdx.x;
  const int qt = n_qt - 1 - idx / (B * H);  // long causal tiles first
  idx %= B * H;
  const int h = idx % H, b = idx / H, kh = h / (H / K);
  const int q0 = qt * kTile;
  // the key tiles this query tile sees
  const int t_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_hi = causal ? min(Tk, q0 + kTile) : Tk;
  const int kt_begin = t_lo / kTile;
  const int n_it = t_hi > t_lo ? (t_hi + kTile - 1) / kTile - kt_begin : 0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, c2 = 2 * (lane % 4);
  const float sl2 = scale * kLog2e;

  auto issue = [&](int it) {
    const int r0 = (kt_begin + it) * kTile, buf = it & 1;
    load_tile<HDP>(sK + buf * TB, k, b, r0, Tk, K, kh, hd);
    load_tile<HDP>(sV + buf * TB, v, b, r0, Tk, K, kh, hd);
  };
  load_tile<HDP>(sQ, q, b, q0, S, H, h, hd);
  load_tile<HDP>(sdO, d_o, b, q0, S, H, h, hd);
  if (n_it > 0) issue(0);
  cp_async_commit();

  // this thread's rows qr0 and qr0 + 8: -lse log2(e) and D
  const int qr0 = q0 + 16 * warp + g8;
  float nl[2], dd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qr = qr0 + 8 * half;
    const size_t i = ((size_t)b * H + h) * S + qr;
    nl[half] = qr < S ? -lse[i] * kLog2e : 0.f;
    dd[half] = qr < S ? delta[i] : 0.f;
  }
  float dqa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dqa[n][c] = 0.f;

  const int a_row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_col = lane >> 4;
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = (lane >> 3) & 1;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = it & 1, t0 = (kt_begin + it) * kTile;
    const uint32_t cK = sK + buf * TB, cV = sV + buf * TB;

    // S = Q K^T and dP = dO V^T: [16 queries x 64 keys] a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(at<HDP>(sQ, a_row, 2 * kk + a_col), aq);
      ldsm_x4(at<HDP>(sdO, a_row, 2 * kk + a_col), ao);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(at<HDP>(cK, 16 * np + b_row, 2 * kk + b_col), bk);
        ldsm_x4(at<HDP>(cV, 16 * np + b_row, 2 * kk + b_col), bv);
        mma(s[2 * np], aq, bk[0], bk[1]);
        mma(s[2 * np + 1], aq, bk[2], bk[3]);
        mma(dp[2 * np], ao, bv[0], bv[1]);
        mma(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
    // dS = P (dP - D); element [j][c] is query qr0 + 8 (c >> 1), key
    // t0 + 8 j + c2 + (c & 1)
    const bool edge =
        edge_tile(q0, t0, kTile, kTile, S, Tk, causal, window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = ex2(fmaf(s[j][c], sl2, nl[c >> 1]));
        if (edge && !visible(qr0 + 8 * (c >> 1), t0 + 8 * j + c2 + (c & 1),
                             S, Tk, causal, window))
          p = 0.f;
        s[j][c] = p * (dp[j][c] - dd[c >> 1]);
      }
    // dQ += dS K over the tile's 64 keys
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t sa[4];
      to_a(s[2 * kq], s[2 * kq + 1], sa);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4_trans(at<HDP>(cK, 16 * kq + a_row - 16 * warp,
                              2 * np + a_col),
                      bk);
        mma(dqa[2 * np], sa, bk[0], bk[1]);
        mma(dqa[2 * np + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + c2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qr = qr0 + 8 * half;
      if (col >= hd || qr >= S) continue;
      *reinterpret_cast<__nv_bfloat162*>(
          dq + (((size_t)b * S + qr) * H + h) * hd + col) =
          __floats2bfloat162_rn(dqa[n][2 * half] * scale,
                                dqa[n][2 * half + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// the SIMT route (float32, or a head_dim the mma route does not take)
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
  float* ws;
  int* tickets;
  int B, S, T, H, K, hd, causal, window, gsplit;
  float scale;
  cudaStream_t stream;
  cudaEvent_t* events;  // null, or four events to record around the launches
};

// records events[i] on the stream, where the caller asked for them
cudaError_t mark(const Args& a, int i) {
  return a.events ? cudaEventRecord(a.events[i], a.stream) : cudaSuccess;
}

template <typename T>
cudaError_t launch_delta(const Args& a, bool vec) {
  const int rows = a.B * a.S * a.H;
  const dim3 grid((rows + kThreads / 16 - 1) / (kThreads / 16));
  const T* o = static_cast<const T*>(a.o);
  const T* g = static_cast<const T*>(a.d_o);
  if (vec)
    flash_bwd_delta_kernel<T, true>
        <<<grid, kThreads, 0, a.stream>>>(o, g, a.delta, rows, a.S, a.H, a.hd);
  else
    flash_bwd_delta_kernel<T, false>
        <<<grid, kThreads, 0, a.stream>>>(o, g, a.delta, rows, a.S, a.H, a.hd);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_mma(const Args& a) {
  using bf = __nv_bfloat16;
  constexpr size_t smem = mma_smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const bf *q = static_cast<const bf*>(a.q), *k = static_cast<const bf*>(a.k);
  const bf *v = static_cast<const bf*>(a.v);
  const bf* g = static_cast<const bf*>(a.d_o);
  const float* lse = static_cast<const float*>(a.lse);
  const int n_kt = (a.T + kTile - 1) / kTile;
  const int n_qt = (a.S + kTile - 1) / kTile;
  flash_bwd_dkdv_mma_kernel<HDP><<<n_kt * a.B * a.K * a.gsplit, kThreads,
                                   smem, a.stream>>>(
      q, k, v, g, lse, a.delta, static_cast<bf*>(a.dk),
      static_cast<bf*>(a.dv), a.ws, a.tickets, a.B, a.S, a.T, a.H, a.K, a.hd,
      a.causal, a.window, a.scale, a.gsplit, n_kt);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(a, 2);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma_kernel<HDP><<<n_qt * a.B * a.H, kThreads, smem,
                                 a.stream>>>(
      q, k, v, g, lse, a.delta, static_cast<bf*>(a.dq), a.B, a.S, a.T, a.H,
      a.K, a.hd, a.causal, a.window, a.scale, n_qt);
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
cudaError_t launch_simt_hd(const Args& a) {
  if (a.hd <= 32) return launch_simt<T, 32>(a);
  if (a.hd <= 64) return launch_simt<T, 64>(a);
  return launch_simt<T, 128>(a);
}

}  // namespace

// q, o, dO, dq [B, S, H, hd]; k, v, dk, dv [B, T, K, hd]; all contiguous,
// float32 (bf16 == 0) or bfloat16 (bf16 == 1), on CUDA device `device`;
// lse and delta [B, H, S] float32 (delta is written: D). mma == 1 takes
// the tensor-core route (bf16, hd % 8 == 0, 8 <= hd <= 128, tensors
// 16-byte aligned), splitting each KV head's G query heads into `gsplit`
// groups (G % gsplit == 0); with gsplit > 1, ws holds gsplit x 2 x
// B T K hd floats and tickets B K ceil(T / 64) zeroed ints. mma == 0 takes
// the SIMT route (gsplit 1). window <= 0 means no window. Launches three
// kernels on `stream` and returns the first CUDA error (0 when all three
// were accepted). `events`, where not null, holds four created events,
// recorded before D, after D, after dK / dV and after dQ, so a caller can
// time each launch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* d_o, void* dq, void* dk, void* dv,
    void* delta, void* ws, void* tickets, int bf16, int mma, int B, int S,
    int T, int H, int K, int hd, int causal, int window, float scale,
    int gsplit, int device, void* stream, void* events) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (K < 1 || H % K != 0 || hd < 1 || hd > 128 || gsplit < 1 ||
      (H / K) % gsplit != 0 || (mma && (!bf16 || hd % 8 != 0)) ||
      (!mma && gsplit != 1) || (gsplit > 1 && (ws == nullptr ||
                                               tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, lse, d_o, dq, dk, dv, static_cast<float*>(delta),
         static_cast<float*>(ws), static_cast<int*>(tickets), B, S, T, H, K,
         hd, causal, window, gsplit, scale,
         static_cast<cudaStream_t>(stream), static_cast<cudaEvent_t*>(events)};
  cudaError_t err = mark(a, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bf16 ? launch_delta<__nv_bfloat16>(a, hd % 8 == 0)
             : launch_delta<float>(a, false);
  if (err == cudaSuccess) err = mark(a, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mma)
    err = hd <= 64 ? launch_mma<64>(a) : launch_mma<128>(a);
  else
    err = bf16 ? launch_simt_hd<__nv_bfloat16>(a) : launch_simt_hd<float>(a);
  if (err == cudaSuccess) err = mark(a, 3);
  return static_cast<int>(err);
}
