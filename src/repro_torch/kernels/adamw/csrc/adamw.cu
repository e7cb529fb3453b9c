// AdamW for Hopper (sm_90a) as multi-tensor kernels: a pass that writes
// the gradients' sums of squares a block, a one-block pass that turns them
// into the global norm and the clip factor, and an update pass that reads
// p, g, m and v once and writes p, m and v once, in place.
//
// Replaces no Pallas kernel: the JAX package (src/repro/optim/adamw.py)
// leaves AdamW to XLA's fusion. The port's plain version,
// src/repro_torch/optim/adamw.py::_update with global_norm, runs it as
// about two dozen unfused float32 passes over each piece of each leaf,
// launched from Python; in the starcoder2-3b training step (3.18e9
// parameters) those passes took 257 ms, 32% of the step. This file was
// added for that.
//
// Arithmetic: _update's, in its order, in float32 (the build keeps
// -fmad=false, IEEE sqrtf and division, so no product is fused into an
// add): g *= clip; m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g;
// delta = (m / c1) / (sqrt(v / c2) + eps) + wd p; p = p - lr delta; each
// result rounded to its tensor's type to nearest even. clip, c1, c2 and lr
// are read from device memory; b1, 1 - b1, b2, 1 - b2, eps and wd come as
// the float32 values PyTorch casts the Python floats to. With the same
// scalars the update equals _update bit for bit. The norm is
// sqrt(sum g^2): squares summed in float32 over eight elements, then in
// double, in a fixed order (no atomics), so the same gradients give the
// same bits; the clip is min(1, grad_clip * (1 / max(norm, 1e-9))), as
// PyTorch evaluates grad_clip / clamp(norm, 1e-9) from Python, or 1 when
// grad_clip is 0.
//
// Bound. Bytes: an update reads p, g, m, v and writes p, m, v; with bf16
// p and g and float32 m and v that is 2 + 2 + 4 + 4 read and 2 + 4 + 4
// written, 22 bytes a parameter (70.0 GB at 3.18e9 parameters, 20.9 ms at
// 3.35 TB/s). The clip needs the norm before any update, so g is read a
// second time: 2 bytes a parameter more (6.4 GB, 1.9 ms). The arithmetic
// (about 15 float32 operations, a square root and two divisions a
// parameter) is far below the card's rate, so the design is about
// streaming bytes at HBM's rate.
//
// Design. Each launch takes a group of tensors by value in its argument
// struct (pointers, sizes and each tensor's first block; at most
// kUpdateGroup or kNormGroup tensors, so the struct stays under the 4 KB
// kernel-argument limit): no table is copied to the device and nothing
// synchronises. Block b finds its tensor in the struct's prefix of first
// blocks and takes one chunk of it (kChunk elements). A thread moves 8
// elements at a time, as 16-byte loads and stores (one of a bf16 tensor,
// two of a float32 one), neighbouring threads on neighbouring addresses,
// and every load of the 8 is issued before any arithmetic. A tensor's
// elements from its first element at which all of its pointers are 16-byte
// aligned go in such vectors; the few before it in each chunk, and the
// ragged end, go one at a time (as does a tensor whose pointers share no
// aligned element). 256 threads a block with 8 elements each keep about
// 96 bytes a thread and some 100 KB an SM in flight, more than HBM's
// latency needs on 132 SMs. Launches: ceil(tensors / kNormGroup) for the
// norm, one for the finalize, ceil(tensors / kUpdateGroup) for the update,
// per combination of types.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;              // elements a thread moves at once
constexpr int64_t kChunk = 65536;    // elements a block (a multiple of kVec)
constexpr int kUpdateGroup = 88;     // tensors a launch of the update
constexpr int kNormGroup = 184;      // tensors a launch of the norm pass
constexpr int kFinalThreads = 1024;  // threads of the one finalize block

static_assert(kChunk % kVec == 0, "a chunk starts on a vector boundary");

// 8 elements of type T <-> 8 floats; one element <-> a float.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  static __device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  static __device__ __forceinline__ void store1(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  // a 32-bit word holds two bf16 values, the lower-addressed in its low half
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                               float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
            << 16);
  }
  static __device__ __forceinline__ void store8(__nv_bfloat16* p,
                                                const float (&f)[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]), pack(f[6], f[7]));
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

// A launch's tensors. start[i] is tensor i's first block in the launch,
// start[count] the launch's blocks; head[i] the first element at which all
// of tensor i's pointers are 16-byte aligned (0-7), or -1 if there is none.
struct UpdateTable {
  void* p[kUpdateGroup];
  const void* g[kUpdateGroup];
  void* m[kUpdateGroup];
  void* v[kUpdateGroup];
  long long n[kUpdateGroup];
  int start[kUpdateGroup + 1];
  signed char head[kUpdateGroup];
  int count;
};

struct NormTable {
  const void* g[kNormGroup];
  long long n[kNormGroup];
  int start[kNormGroup + 1];
  signed char head[kNormGroup];
  int count;
};

// the update's scalars: clip, c1, c2 and lr on the device, the rest by value
struct Scalars {
  const float* clip;
  const float* c1;
  const float* c2;
  const float* lr;
  float b1, omb1, b2, omb2, eps, wd;
};

// the 4 KB kernel-argument limit
static_assert(sizeof(UpdateTable) + sizeof(Scalars) <= 4096,
              "the update's arguments exceed the kernel-argument limit");
static_assert(sizeof(NormTable) + sizeof(double*) <= 4096,
              "the norm pass's arguments exceed the kernel-argument limit");

struct Consts {
  float clip, c1, c2, lr, b1, omb1, b2, omb2, eps, wd;
};

// _update's arithmetic on one element, in its order
__device__ __forceinline__ void adamw_one(float& p, float g, float& m,
                                          float& v, const Consts& k) {
  g = g * k.clip;
  m = k.b1 * m + k.omb1 * g;
  v = k.b2 * v + k.omb2 * (g * g);
  const float delta = (m / k.c1) / (sqrtf(v / k.c2) + k.eps) + k.wd * p;
  p = p - k.lr * delta;
}

// the tensor of block b: the last i with start[i] <= b
template <int N>
__device__ __forceinline__ int tensor_of(const int (&start)[N], int count,
                                         int b) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// A chunk [lo, hi) of a tensor whose aligned elements start at head:
// vectors over [vs, ve), single elements over [lo, vs) and [ve, hi).
__device__ __forceinline__ void split(long long lo, long long hi, int head,
                                      long long& vs, long long& ve) {
  if (head < 0) {
    vs = ve = hi;
    return;
  }
  vs = lo + head < hi ? lo + head : hi;
  ve = vs + (hi - vs) / kVec * kVec;
}

template <typename TP, typename TG, typename TM>
__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(const __grid_constant__ UpdateTable t, const Scalars s) {
  const int i = tensor_of(t.start, t.count, blockIdx.x);
  const long long lo = static_cast<long long>(blockIdx.x - t.start[i]) * kChunk;
  const long long n = t.n[i];
  const long long hi = lo + kChunk < n ? lo + kChunk : n;
  TP* __restrict__ p = static_cast<TP*>(t.p[i]);
  const TG* __restrict__ g = static_cast<const TG*>(t.g[i]);
  TM* __restrict__ m = static_cast<TM*>(t.m[i]);
  TM* __restrict__ v = static_cast<TM*>(t.v[i]);
  const Consts k{*s.clip, *s.c1, *s.c2, *s.lr, s.b1,
                 s.omb1,  s.b2,  s.omb2, s.eps, s.wd};
  long long vs, ve;
  split(lo, hi, t.head[i], vs, ve);
  for (long long e = vs + threadIdx.x * kVec; e < ve;
       e += kThreads * kVec) {
    float pf[8], gf[8], mf[8], vf[8];
    Io<TP>::load8(p + e, pf);
    Io<TG>::load8(g + e, gf);
    Io<TM>::load8(m + e, mf);
    Io<TM>::load8(v + e, vf);
#pragma unroll
    for (int j = 0; j < kVec; ++j) adamw_one(pf[j], gf[j], mf[j], vf[j], k);
    Io<TP>::store8(p + e, pf);
    Io<TM>::store8(m + e, mf);
    Io<TM>::store8(v + e, vf);
  }
  // single elements: [lo, vs) (the whole chunk if nothing is aligned), then
  // [ve, hi)
  for (int part = 0; part < 2; ++part) {
    const long long a = part ? ve : lo, b = part ? hi : vs;
    for (long long e = a + threadIdx.x; e < b; e += kThreads) {
      float pf = Io<TP>::load1(p + e), mf = Io<TM>::load1(m + e),
            vf = Io<TM>::load1(v + e);
      adamw_one(pf, Io<TG>::load1(g + e), mf, vf, k);
      Io<TP>::store1(p + e, pf);
      Io<TM>::store1(m + e, mf);
      Io<TM>::store1(v + e, vf);
    }
  }
}

// sum over the block of x, in a fixed order; the result in thread 0
template <int kBlock>
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < kBlock / 32 ? warp_sums[threadIdx.x] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

template <typename TG>
__global__ void __launch_bounds__(kThreads)
    adamw_sumsq_kernel(const __grid_constant__ NormTable t,
                       double* __restrict__ partials) {
  const int i = tensor_of(t.start, t.count, blockIdx.x);
  const long long lo = static_cast<long long>(blockIdx.x - t.start[i]) * kChunk;
  const long long n = t.n[i];
  const long long hi = lo + kChunk < n ? lo + kChunk : n;
  const TG* __restrict__ g = static_cast<const TG*>(t.g[i]);
  long long vs, ve;
  split(lo, hi, t.head[i], vs, ve);
  double acc = 0.0;
  for (long long e = vs + threadIdx.x * kVec; e < ve;
       e += kThreads * kVec) {
    float gf[8];
    Io<TG>::load8(g + e, gf);
    const float s = ((gf[0] * gf[0] + gf[1] * gf[1]) +
                     (gf[2] * gf[2] + gf[3] * gf[3])) +
                    ((gf[4] * gf[4] + gf[5] * gf[5]) +
                     (gf[6] * gf[6] + gf[7] * gf[7]));
    acc += static_cast<double>(s);
  }
  for (int part = 0; part < 2; ++part) {
    const long long a = part ? ve : lo, b = part ? hi : vs;
    for (long long e = a + threadIdx.x; e < b; e += kThreads) {
      const float x = Io<TG>::load1(g + e);
      acc += static_cast<double>(x * x);
    }
  }
  acc = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kFinalThreads)
    adamw_finalize_kernel(const double* __restrict__ partials, int count,
                          float grad_clip, float* gnorm, float* clip) {
  double acc = 0.0;
  for (int j = threadIdx.x; j < count; j += kFinalThreads) acc += partials[j];
  acc = block_sum<kFinalThreads>(acc);
  if (threadIdx.x == 0) {
    const float norm = static_cast<float>(sqrt(acc));
    float c = 1.0f;
    if (grad_clip > 0.0f) {
      const float d = isnan(norm) ? norm : fmaxf(norm, 1e-9f);
      const float r = (1.0f / d) * grad_clip;
      c = isnan(r) ? r : fminf(r, 1.0f);
    }
    *gnorm = norm;
    *clip = c;
  }
}

// the first of 8 elements at which every pointer is 16-byte aligned, or -1
int head_of(const void* const* ptrs, const int* sizes, int k) {
  for (int h = 0; h < kVec; ++h) {
    bool ok = true;
    for (int j = 0; j < k; ++j)
      ok = ok && (reinterpret_cast<uintptr_t>(ptrs[j]) + h * sizes[j]) % 16 == 0;
    if (ok) return h;
  }
  return -1;
}

int chunks(long long n) { return static_cast<int>((n + kChunk - 1) / kChunk); }

template <typename TP, typename TG, typename TM>
cudaError_t launch_update(const UpdateTable& t, const Scalars& s,
                          cudaStream_t st) {
  adamw_update_kernel<TP, TG, TM>
      <<<t.start[t.count], kThreads, 0, st>>>(t, s);
  return cudaGetLastError();
}

template <typename TP, typename TG>
cudaError_t update_by_moment(int mv_bf16, const UpdateTable& t,
                             const Scalars& s, cudaStream_t st) {
  return mv_bf16 ? launch_update<TP, TG, __nv_bfloat16>(t, s, st)
                 : launch_update<TP, TG, float>(t, s, st);
}

}  // namespace

// kChunk: the wrapper sizes the norm's partials by it
extern "C" long long adamw_chunk() { return kChunk; }

// Sums of squares of count gradients (all bf16, or all float32), one a
// chunk of kChunk elements, into partials (sum of ceil(n / kChunk) doubles,
// in the gradients' order). *launches gets the launches made.
extern "C" int adamw_sumsq_launch(int count, const void* const* g,
                                  const long long* n, int g_bf16,
                                  double* partials, int device, void* stream,
                                  int* launches) {
  *launches = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int size = g_bf16 ? 2 : 4;
  for (int first = 0; first < count; first += kNormGroup) {
    NormTable t;
    t.count = count - first < kNormGroup ? count - first : kNormGroup;
    t.start[0] = 0;
    for (int i = 0; i < t.count; ++i) {
      t.g[i] = g[first + i];
      t.n[i] = n[first + i];
      t.head[i] = static_cast<signed char>(head_of(&t.g[i], &size, 1));
      t.start[i + 1] = t.start[i] + chunks(t.n[i]);
    }
    if (t.start[t.count] > 0) {
      if (g_bf16)
        adamw_sumsq_kernel<__nv_bfloat16><<<t.start[t.count], kThreads, 0, st>>>(
            t, partials);
      else
        adamw_sumsq_kernel<float><<<t.start[t.count], kThreads, 0, st>>>(
            t, partials);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      ++*launches;
    }
    partials += t.start[t.count];
  }
  return 0;
}

// The norm sqrt(sum of count partials) into *gnorm and the clip factor
// into *clip, by one block.
extern "C" int adamw_finalize_launch(const double* partials, int count,
                                     float grad_clip, float* gnorm,
                                     float* clip, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  adamw_finalize_kernel<<<1, kFinalThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      partials, count, grad_clip, gnorm, clip);
  return static_cast<int>(cudaGetLastError());
}

// The update of count (p, g, m, v), in place: p bf16 or float32
// (p_bf16), g likewise (g_bf16), m and v both bf16 or both float32
// (mv_bf16); n[i] elements each. *launches gets the launches made.
extern "C" int adamw_update_launch(
    int count, void* const* p, const void* const* g, void* const* m,
    void* const* v, const long long* n, int p_bf16, int g_bf16, int mv_bf16,
    const float* clip, const float* c1, const float* c2, const float* lr,
    float b1, float omb1, float b2, float omb2, float eps, float wd,
    int device, void* stream, int* launches) {
  *launches = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scalars s{clip, c1, c2, lr, b1, omb1, b2, omb2, eps, wd};
  const int sizes[4] = {p_bf16 ? 2 : 4, g_bf16 ? 2 : 4, mv_bf16 ? 2 : 4,
                        mv_bf16 ? 2 : 4};
  for (int first = 0; first < count; first += kUpdateGroup) {
    UpdateTable t;
    t.count = count - first < kUpdateGroup ? count - first : kUpdateGroup;
    t.start[0] = 0;
    for (int i = 0; i < t.count; ++i) {
      const int f = first + i;
      t.p[i] = p[f];
      t.g[i] = g[f];
      t.m[i] = m[f];
      t.v[i] = v[f];
      t.n[i] = n[f];
      const void* ptrs[4] = {p[f], g[f], m[f], v[f]};
      t.head[i] = static_cast<signed char>(head_of(ptrs, sizes, 4));
      t.start[i + 1] = t.start[i] + chunks(t.n[i]);
    }
    if (t.start[t.count] == 0) continue;
    if (p_bf16)
      err = g_bf16 ? update_by_moment<__nv_bfloat16, __nv_bfloat16>(mv_bf16, t, s, st)
                   : update_by_moment<__nv_bfloat16, float>(mv_bf16, t, s, st);
    else
      err = g_bf16 ? update_by_moment<float, __nv_bfloat16>(mv_bf16, t, s, st)
                   : update_by_moment<float, float>(mv_bf16, t, s, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}
