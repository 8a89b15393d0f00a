// Sliding-window flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention.py:81
// `swa_attention` (body `_kernel` at :27). q, k, v: [BH, S, D] in bf16 or
// f32, output in q's dtype. softmax(q k^T / sqrt(D)) v with key j visible to
// query i iff (not causal or j <= i) and (no window or j > i - window).
// As on the TPU, every product runs in f32 (q, k, v are widened on load) and
// the online-softmax state m, l, acc is f32.
//
// Bound on the H100: at the prefill shape (BH 32, S 1024, D 128, causal) the
// inputs and output are 33.5 MB (10 us at 3.35 TB/s) and the band needs
// 8.6 GFLOP (8.7 us at the bf16 tensor-core peak), so the least time is set
// by the bytes. This first kernel does its products in f32 on the CUDA
// cores (67 TFLOP/s peak, no wgmma), so in practice the FMA rate and the
// shared-memory traffic that feeds it bound it, far above that least time.
//
// Design: one block of 128 threads per (bh, 32-row q tile). The q tile and
// each 32-row K/V tile are staged in shared memory as f32; rows past S are
// zero-filled and masked, so a ragged S needs no padding. Each q tile loops
// only over the k tiles of its band: from the first key its window reaches
// (q_lo - window + 1) to the last key its causal limit reaches (q_hi). The
// TPU kernel visits every k block and skips work under pl.when; here the
// tiles outside the band are never loaded. Per k tile:
//   scores: warp w owns rows w, w+4, ..., w+28 and lane j owns key j, so a
//     row's max and sum are warp shuffles; m and l live in registers.
//   P.V: thread t owns a fixed set of output columns and rows; acc stays in
//     registers (at most 64 floats, D = 256) and is rescaled by alpha.
// Q and K rows are padded to D + 4 floats: 16-byte loads stay aligned and
// the 32 lanes reading 32 different K rows hit distinct banks.
// Shared memory is 54.5 KB at D = 128 and 103.7 KB at D = 256; both are
// above the 48 KB static limit and opted into with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;   // query rows per block
constexpr int BK = 32;   // keys per tile (one per lane)
constexpr int NT = 128;  // threads per block: 4 warps
constexpr int WARPS = NT / 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;

__host__ __device__ constexpr int cgcd(int a, int b) { return b == 0 ? a : cgcd(b, a % b); }

template <int D>
struct Shape {
  static_assert(D % 8 == 0 && D <= 256, "D must be a multiple of 8, at most 256");
  static constexpr int LD = D + 4;                  // padded row stride of Q and K
  static constexpr int NCG = cgcd(D, NT);           // threads across columns in P.V
  static constexpr int CPT = D / NCG;               // columns per thread
  static constexpr int RG = NT / NCG;               // row groups
  static constexpr int RPT = BQ / RG;               // rows per thread
  static constexpr int SMEM_FLOATS = BQ * LD + BK * LD + BK * D + BQ * BK + 2 * BQ;
  static_assert(BQ % RG == 0, "row groups must divide the q tile");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [row0, row0 + 32) of a [S, D] matrix into shared memory as f32
// with row stride ld; rows at or past s are zero. Global reads are 16-byte
// vectors (the wrapper checks alignment; D * sizeof(T) is a multiple of 16).
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0, int s,
                                          float* __restrict__ dst, int ld) {
  constexpr int N = 16 / sizeof(T);
  constexpr int VPR = D / N;  // vectors per row
  for (int v = threadIdx.x; v < 32 * VPR; v += NT) {
    const int r = v / VPR, c = (v % VPR) * N;
    alignas(16) T e[N];
    if (row0 + r < s) {
      *reinterpret_cast<uint4*>(e) =
          *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(row0 + r) * D + c);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) e[j] = from_f32<T>(0.f);
    }
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      *reinterpret_cast<float4*>(dst + r * ld + c + j) =
          make_float4(to_f32(e[j]), to_f32(e[j + 1]), to_f32(e[j + 2]), to_f32(e[j + 3]));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int s, int n_qt, int causal, int window, float scale) {
  using Sh = Shape<D>;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][LD]
  float* Ks = Qs + BQ * Sh::LD;                    // [BK][LD]
  float* Vs = Ks + BK * Sh::LD;                    // [BK][D]
  float* Ps = Vs + BK * D;                         // [BQ][BK]
  float* As = Ps + BQ * BK;                        // [BQ] rescale of acc this tile
  float* Ls = As + BQ;                             // [BQ] final softmax denominators

  const int bh = blockIdx.x / n_qt;
  const int q_lo = (blockIdx.x % n_qt) * BQ;
  const int q_hi = min(q_lo + BQ, s) - 1;
  const int64_t base = static_cast<int64_t>(bh) * s * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The band of keys any row of this tile can see.
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? q_hi + 1 : s;  // exclusive
  const int kt_first = k_begin / BK, kt_last = (k_end - 1) / BK;

  load_tile<T, D>(q + base, q_lo, s, Qs, Sh::LD);

  float m_run[ROWS_PER_WARP], l_run[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  const int cg = threadIdx.x % Sh::NCG, rg = threadIdx.x / Sh::NCG;
  float acc[Sh::RPT][Sh::CPT];
#pragma unroll
  for (int r = 0; r < Sh::RPT; ++r)
#pragma unroll
    for (int c = 0; c < Sh::CPT; ++c) acc[r][c] = 0.f;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();  // the previous tile's P.V is done with Ks, Vs, Ps
    load_tile<T, D>(k + base, k_lo, s, Ks, Sh::LD);
    load_tile<T, D>(v + base, k_lo, s, Vs, D);
    __syncthreads();

    // Scores and online softmax: lane = key, warp rows warp + WARPS * r.
    float sc[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) sc[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(Ks + lane * Sh::LD + d);
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (warp + WARPS * r) * Sh::LD + d);
        sc[r] = fmaf(qv.x, kv.x, sc[r]);
        sc[r] = fmaf(qv.y, kv.y, sc[r]);
        sc[r] = fmaf(qv.z, kv.z, sc[r]);
        sc[r] = fmaf(qv.w, kv.w, sc[r]);
      }
    }
    const int kpos = k_lo + lane;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int row = warp + WARPS * r;
      const int qpos = q_lo + row;
      const bool valid = kpos < s && (!causal || kpos <= qpos) &&
                         (window <= 0 || kpos > qpos - window);
      const float x = valid ? sc[r] * scale : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(x));
      float p, alpha;
      if (m_new == -INFINITY) {  // no visible key for this row yet
        p = 0.f;
        alpha = 1.f;
      } else {
        p = valid ? expf(x - m_new) : 0.f;
        alpha = expf(m_run[r] - m_new);
      }
      l_run[r] = l_run[r] * alpha + warp_sum(p);
      m_run[r] = m_new;
      Ps[row * BK + lane] = p;
      if (lane == 0) As[row] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P . V for this thread's rows and columns.
#pragma unroll
    for (int r = 0; r < Sh::RPT; ++r) {
      const float a = As[rg * Sh::RPT + r];
#pragma unroll
      for (int c = 0; c < Sh::CPT; ++c) acc[r][c] *= a;
    }
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vv[4][Sh::CPT];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < Sh::CPT; ++c) vv[jj][c] = Vs[(j + jj) * D + c * Sh::NCG + cg];
#pragma unroll
      for (int r = 0; r < Sh::RPT; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(Ps + (rg * Sh::RPT + r) * BK + j);
#pragma unroll
        for (int c = 0; c < Sh::CPT; ++c) {
          acc[r][c] = fmaf(p.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(p.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(p.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(p.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) Ls[warp + WARPS * r] = l_run[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < Sh::RPT; ++r) {
    const int row = rg * Sh::RPT + r;
    if (q_lo + row >= s) continue;
    const float inv = 1.f / fmaxf(Ls[row], 1e-30f);
    T* out = o + base + static_cast<int64_t>(q_lo + row) * D;
#pragma unroll
    for (int c = 0; c < Sh::CPT; ++c) out[c * Sh::NCG + cg] = from_f32<T>(acc[r][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int s,
                   int causal, int window, cudaStream_t stream) {
  const size_t smem = Shape<D>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(swa_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (s + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(n_qt) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  swa_attention_kernel<T, D><<<static_cast<unsigned>(blocks), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, n_qt, causal, window, 1.f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int bh, int s, int d,
                     int causal, int window, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, bh, s, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, s, causal, window, stream);
    case 80: return launch<T, 80>(q, k, v, o, bh, s, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, s, causal, window, stream);
    case 256: return launch<T, 256>(q, k, v, o, bh, s, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [bh, s, d] contiguous, 16-byte aligned. dtype: 0 = float32,
// 1 = bfloat16. window <= 0 means no window. Returns the launch's cudaError_t.
extern "C" int swa_attention_launch(const void* q, const void* k, const void* v, void* o, int bh,
                                    int s, int d, int causal, int window, int dtype,
                                    void* stream) {
  if (bh <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_d<float>(q, k, v, o, bh, s, d, causal, window, st));
    case 1:
      return static_cast<int>(launch_d<__nv_bfloat16>(q, k, v, o, bh, s, d, causal, window, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* swa_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
