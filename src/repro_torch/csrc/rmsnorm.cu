// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + w).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py:25 `rmsnorm`
// (body `_kernel` at :17). Statistics in f32, output in x's dtype (bf16 or
// f32), gain 1 + w with w in f32, as in repro.models.layers.rmsnorm.
// w holds G rows of d gains and row r of x takes gain row r mod G: G = 1
// for a [D] weight, G = H for Mamba-2's gated norm of y [B, S, H, P] with
// a weight per head [H, P] (the reference broadcasts it the same way).
//
// Bound on the H100: memory. Each element is read, squared, read again and
// written: ~4 flops against 4 bytes of traffic (bf16), far below the ~295
// flops/byte where the tensor cores would be the limit. At prefill
// (2048 rows x 2048) the least time is the bytes over 3.35 TB/s; at decode
// (4 rows x 2048) the whole call moves 32 KB and launch latency bounds it.
//
// Design: one block per row, so a row's sum of squares never leaves the SM.
// Threads read 16-byte vectors (8 bf16 or 4 f32), square-sum in f32, reduce
// by warp shuffles and one shared-memory step, then read the row again (an
// L1/L2 hit: a row is a few KB) and write it once. A scalar variant covers
// widths that are not a multiple of the vector or unaligned pointers. At
// d = 64 (the gated norm's head width) a row is 8 bf16 vectors, so 24 of
// the block's 32 threads have nothing to do: simple, not yet tuned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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

// VEC: rows are read and written as 16-byte vectors of N = 16 / sizeof(T).
template <typename T, bool VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                               T* __restrict__ y, int d, int groups, float eps) {
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
cudaError_t launch(const void* x, const void* w, void* y, long long rows, int d, int groups,
                   float eps, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  // Every row of w starts 16-byte aligned when w does: a row is d * 4
  // bytes and d % N == 0 (N >= 4).
  const bool vec = d % N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int chunks = vec ? d / N : d;
  int threads = ((chunks + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* yt = static_cast<T*>(y);
  const unsigned blocks = static_cast<unsigned>(rows);
  if (vec) {
    rmsnorm_kernel<T, true><<<blocks, threads, 0, stream>>>(xt, wt, yt, d, groups, eps);
  } else {
    rmsnorm_kernel<T, false><<<blocks, threads, 0, stream>>>(xt, wt, yt, d, groups, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// w: [groups, d] f32, row r of x takes w's row r % groups. dtype: 0 =
// float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, long long rows, int d,
                              int groups, float eps, int dtype, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0 || groups <= 0 || rows % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(x, w, y, rows, d, groups, eps, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(x, w, y, rows, d, groups, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
