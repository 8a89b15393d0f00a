// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + w).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py:25 `rmsnorm`
// (body `_kernel` at :17). Statistics in f32, output in x's dtype (bf16 or
// f32), gain 1 + w with w in f32, as in repro.models.layers.rmsnorm.
// w holds G rows of d gains and row r of x takes gain row r mod G: G = 1
// for a [D] weight, G = H for Mamba-2's gated norm of y [B, S, H, P] with
// a weight per head [H, P] (the reference broadcasts it the same way).
//
// Bound on the H100: memory. Each element is read once, squared, scaled
// and written once: ~5 flops against 4 bytes of traffic (bf16), far below
// the ~295 flops/byte where the tensor cores would be the limit. At
// prefill (2048 rows x 2048 bf16, 16.8 MB) the least time is 5.0 us at
// 3.35 TB/s; at decode (4 rows x 2048) the call moves 32 KB and latency
// bounds it. A call of a few MB is resident on the 132 SMs in about one
// wave, so its time is one row's chain of dependent steps (load, reduce,
// scale, store) plus the bytes over HBM's rate: the design shortens that
// chain and keeps every lane busy.
//
// Design: each lane loads its 16-byte vectors of a row (8 bf16 or 4 f32)
// and their gains into registers, sums the squares in f32, reduces over
// the lanes of the row, and scales and writes from the same registers: x
// is read once, and the gains' latency hides behind x's instead of
// following the reduction. Routes, by the row's width in vectors
// c = d / (16 / sizeof(T)):
// - small (c <= 32): a segment of L lanes a row, L the power of two >= c,
//   32 / L rows a warp; the reduction is log2(L) xor shuffles inside the
//   segment, with no shared memory and no __syncthreads. Mamba-2's and
//   Jamba's gated norms (d = 64: 8 lanes a row in bf16, 16 in f32) take it.
// - wide (32 < c <= 1024): kWideVectors vectors a lane, a warp a row up to
//   c = 128 and a block of L / 32 warps beyond, L the power of two >=
//   c / kWideVectors. Every [D] norm of the main paths (d = 1536, 2048,
//   4096) takes it. Four vectors a lane, not eight or sixteen, keep each
//   lane's serial work short enough for the 4-row decode call.
// - general: one block a row, one vector (or, unaligned, one element) a
//   thread, reading the row twice; for widths that are no multiple of the
//   vector, unaligned pointers and rows wider than the wide route holds.
// Every route adds the squares in the general route's order: each
// vector's in turn, a butterfly over each 32 consecutive vectors, then one
// over those groups. So all give the general route's bits on aligned rows,
// which the bf16 serving gates need: they sit within rounding of their
// limits, and a per-lane order moved qwen2-vl-2b's prefill argmax against
// the plain versions from 0.9517 to 0.9473, under its 0.95 gate.
// rmsnorm_design reports the route, its shape and the compiler's registers
// and local bytes of the kernel each (d, dtype, alignment) runs.
//
// Measured by chip_smoke.py (device time from torch.profiler; NVIDIA H100
// 80GB HBM3, 700.00 W): small route, x [2, 1024, 48, 64] bf16 7.87 us
// against a 7.52 us bound, [2, 1024, 128, 64] bf16 24.32 against 20.04,
// [2, 1024, 48, 64] f32 16.58 against 15.03; wide route, 2048 rows of
// 1536, 2048 and 4096 bf16 5.03, 6.49 and 11.69 us against 3.76, 5.01 and
// 10.02 (F.rms_norm 5.68, 7.12, 12.73); [4, 2048] bf16 1.58 us.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmallThreads = 128;  // threads a block, small route
constexpr int kWideVectors = 4;     // 16-byte vectors a lane holds, wide route
constexpr int kWideThreads = 128;   // threads a block when a row takes at most a warp
constexpr int kMaxLanes = 256;      // widest row of the wide route: 1024 vectors

enum Route { kGeneral = 0, kSmall = 1, kWide = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A 16-byte vector as floats and back: 8 bf16 (element 0 in the low half
// of each word, as memory holds them) or 4 f32.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]), bf16_pair(f[4], f[5]),
                    bf16_pair(f[6], f[7]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// Sum of v over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  v = lane < n_warps ? partial[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the L lanes of each aligned segment of a warp (L <= 32);
// every lane of the segment gets the same total. With one vector's sum a
// lane and lanes past the row at 0, it adds in block_sum's order.
template <int L>
__device__ __forceinline__ float segment_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of a row of c <= 1024 vectors held by L >= 32 lanes, NV a lane, from
// p[i], the sum of vector lane + L * i's squares, in block_sum's order on
// one vector a thread: a butterfly over each 32 consecutive vectors, then
// one over the (c + 31) / 32 groups' sums. Every lane gets the total, and
// the row's output the general route's bits.
template <int L, int NV>
__device__ __forceinline__ float row_sum(float (&p)[NV], int c) {
  __shared__ float group_sums[L > 32 ? 1 : kWideThreads / 32][32];
  float* sums = group_sums[L > 32 ? 0 : threadIdx.x / 32];
  const int lane = threadIdx.x & 31, n_groups = (c + 31) / 32;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    for (int o = 16; o > 0; o >>= 1) p[i] += __shfl_xor_sync(0xffffffffu, p[i], o);
    // vector lane + L * i lies in group (lane + L * i) / 32
    const int group = (L > 32 ? threadIdx.x / 32 : 0) + L / 32 * i;
    if (lane == 0 && group < n_groups) sums[group] = p[i];
  }
  __syncthreads();
  float v = lane < n_groups ? sums[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The small route (NV == 1, L <= 32) and the wide one (NV > 1, L >= 32).
// A row is held by L lanes, NV vectors each (vector j of the row in lane
// j % L). L <= 32: the block holds blockDim / L rows, one to each aligned
// segment of L lanes, so a warp's loads are contiguous. L > 32: the block
// is one row (blockDim == L).
template <typename T, int L, int NV>
__global__ void __launch_bounds__(L > 32 ? L : kSmallThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                    int rows, int d, int groups, float eps) {
  constexpr int N = 16 / sizeof(T);
  const int c = d / N;
  const int lane = L > 32 ? threadIdx.x : threadIdx.x % L;
  const int64_t row = L > 32 ? blockIdx.x
                             : static_cast<int64_t>(blockIdx.x) * (blockDim.x / L) + threadIdx.x / L;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  const float4* wr = reinterpret_cast<const float4*>(
      w + static_cast<int64_t>(groups == 1 ? 0 : static_cast<int>(row % groups)) * d);

  // The lane's vectors of x and, before the reduction, their gains: the
  // gains' latency hides behind x's instead of following the reduction.
  uint4 v[NV];
  float4 g[NV][N / 4];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + L * i;
    const bool in = row < rows && j < c;
    v[i] = in ? __ldg(xr + j) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      g[i][q] = in ? __ldg(wr + j * (N / 4) + q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float p[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float f[N];
    unpack(v[i], f);
    p[i] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) p[i] = fmaf(f[e], f[e], p[i]);
  }
  float ss;
  if constexpr (NV == 1) {
    ss = segment_sum<L>(p[0]);
  } else {
    ss = row_sum<L, NV>(p, c);
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  if (row >= rows) return;

  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + L * i;
    if (j >= c) continue;
    float f[N];
    unpack(v[i], f);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      f[4 * q] = f[4 * q] * r * (1.f + g[i][q].x);
      f[4 * q + 1] = f[4 * q + 1] * r * (1.f + g[i][q].y);
      f[4 * q + 2] = f[4 * q + 2] * r * (1.f + g[i][q].z);
      f[4 * q + 3] = f[4 * q + 3] * r * (1.f + g[i][q].w);
    }
    yr[j] = pack(f);
  }
}

// The general route: one block a row, the row read twice. VEC: 16-byte
// vectors of N = 16 / sizeof(T); otherwise one element a load.
template <typename T, bool VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                               T* __restrict__ y, int rows, int d, int groups, float eps) {
  constexpr int N = VEC ? 16 / sizeof(T) : 1;
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * d;
  const float* wr = w + static_cast<int64_t>(blockIdx.x % groups) * d;
  T* yr = y + static_cast<int64_t>(blockIdx.x) * d;
  const int n_chunks = d / N;

  float ss = 0.f;
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    alignas(16) T e[N];
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(xr)[c];
    } else {
      e[0] = xr[c];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float f = to_f32(e[j]);
      ss = fmaf(f, f, ss);
    }
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);

  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    alignas(16) T e[N];
    alignas(16) float g[N];
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(xr)[c];
#pragma unroll
      for (int j = 0; j < N; j += 4)
        *reinterpret_cast<float4*>(g + j) = reinterpret_cast<const float4*>(wr)[(c * N + j) / 4];
    } else {
      e[0] = xr[c];
      g[0] = wr[c];
    }
    alignas(16) T o[N];
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = from_f32<T>(to_f32(e[j]) * r * (1.f + g[j]));
    if constexpr (VEC) {
      reinterpret_cast<uint4*>(yr)[c] = *reinterpret_cast<const uint4*>(o);
    } else {
      yr[c] = o[0];
    }
  }
}

template <typename T>
using Kernel = void (*)(const T*, const float*, T*, int, int, int, float);

// What runs a row of d elements of T: the kernel and its launch shape.
template <typename T>
struct Design {
  Kernel<T> fn;
  int route, lanes, rows_per_block, threads, vectors, load_bytes;
};

// The kernel of NV vectors a lane for a row of `lanes` lanes, a power of
// two in [L, LMAX].
template <typename T, int NV, int L, int LMAX>
Kernel<T> rows_kernel(int lanes) {
  if constexpr (L == LMAX) {
    return rmsnorm_rows_kernel<T, L, NV>;
  } else {
    if (lanes == L) return rmsnorm_rows_kernel<T, L, NV>;
    return rows_kernel<T, NV, 2 * L, LMAX>(lanes);
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// aligned: x, y and w all 16-byte aligned.
template <typename T>
Design<T> design_for(int d, bool aligned) {
  constexpr int N = 16 / sizeof(T);
  const int c = d / N;
  const bool vec = aligned && d % N == 0;
  if (vec && c <= 32) {
    const int lanes = pow2_at_least(c);
    return {rows_kernel<T, 1, 1, 32>(lanes), kSmall, lanes, kSmallThreads / lanes, kSmallThreads,
            1, 16};
  }
  if (vec && c <= kMaxLanes * kWideVectors) {
    // at least a warp a row, so that row_sum's butterflies span whole warps
    const int lanes = pow2_at_least(
        (c + kWideVectors - 1) / kWideVectors > 32 ? (c + kWideVectors - 1) / kWideVectors : 32);
    const int threads = lanes > 32 ? lanes : kWideThreads;
    return {rows_kernel<T, kWideVectors, 32, kMaxLanes>(lanes), kWide, lanes, threads / lanes,
            threads, kWideVectors, 16};
  }
  int threads = ((vec ? c : d) + 31) / 32 * 32;
  threads = threads > 1024 ? 1024 : threads;
  return {vec ? rmsnorm_kernel<T, true> : rmsnorm_kernel<T, false>, kGeneral, threads, 1, threads,
          0, vec ? 16 : static_cast<int>(sizeof(T))};
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d, int groups,
                   float eps, cudaStream_t stream) {
  // Every row of w starts 16-byte aligned when w does and d is a multiple
  // of the vector: a row is d * 4 bytes and N >= 4.
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  const Design<T> g = design_for<T>(d, aligned);
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(rows) +
                                                 g.rows_per_block - 1) / g.rows_per_block);
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* yt = static_cast<T*>(y);
  void* args[] = {&xt, &wt, &yt, &rows, &d, &groups, &eps};
  cudaLaunchKernel(reinterpret_cast<const void*>(g.fn), dim3(blocks), dim3(g.threads), args, 0,
                   stream);
  return cudaGetLastError();
}

template <typename T>
cudaError_t design(int d, bool aligned, int* out) {
  const Design<T> g = design_for<T>(d, aligned);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(g.fn));
  if (err != cudaSuccess) return err;
  const int fields[] = {g.route,      g.lanes,     g.lanes > 32 ? 0 : 32 / g.lanes,
                        g.threads,    g.vectors,   g.load_bytes,
                        attr.numRegs, static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 8; ++i) out[i] = fields[i];
  return cudaSuccess;
}

}  // namespace

// w: [groups, d] f32, row r of x takes w's row r % groups. dtype: 0 =
// float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, long long rows, int d,
                              int groups, float eps, int dtype, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0 || groups <= 0 || rows % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(rows);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(x, w, y, n, d, groups, eps, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(x, w, y, n, d, groups, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The design that rmsnorm_launch runs for rows of d elements of `dtype`
// (as there) with 16-byte aligned pointers or not: out[0..7] = route (0
// general, 1 small, 2 wide), lanes a row, rows a warp (0 when a row spans
// several warps), threads a block, 16-byte vectors a lane holds (0: the
// general route holds none), bytes a load, and the kernel's registers and
// local-memory bytes a thread.
extern "C" int rmsnorm_design(int d, int dtype, int aligned, int* out) {
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return static_cast<int>(design<float>(d, aligned != 0, out));
    case 1: return static_cast<int>(design<__nv_bfloat16>(d, aligned != 0, out));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
