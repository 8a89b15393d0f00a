// Sliding-window flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention.py:81
// `swa_attention` (body `_kernel` at :27). q: [BH, Sq, D], k, v: [BH, Sk, D]
// in bf16 or f32, D in {32, 64, 80, 128, 256}, output [BH, Sq, D] in q's
// dtype. softmax(q k^T / sqrt(D)) v with query row i at position
// p = q_offset + i and key j visible to it iff (not causal or j <= p) and
// (no window or j > p - window). Self-attention is Sq = Sk, q_offset = 0;
// cross-attention (whisper's decoder over its encoder's frames) has
// Sq != Sk. Every query row sees at least one key (the wrapper checks).
// The online-softmax state m, l, acc is f32.
//
// Bound on the H100: at the prefill shape (BH 32, S 1024, D 128, causal) the
// inputs and output are 33.5 MB (10.0 us at 3.35 TB/s) and the band needs
// 8.6 GFLOP (8.7 us at the 989 TFLOP/s bf16 tensor-core peak): bytes and
// operations bound it about equally, so the kernel must stream K/V from L2
// while the tensor cores stay busy. Whisper's cross-attention at one query
// row (BH 32, Sq 1, Sk 1500, D 64) reads 12.3 MB of K and V for 12.3 MFLOP:
// bytes bound it (3.7 us).
//
// Two kernels, chosen by dtype (the wrapper says which):
//
// bf16: tensor cores (`swa_attention_mma_kernel`). One block of 4 warps per
//   (bh, 64-row q tile); warp w owns q rows 16w..16w+15 as one m16 tile.
//   Q.K^T and P.V are mma.sync.m16n8k16 bf16 products with f32 accumulators
//   in registers (the FA2 register layout): the scores of a 64-key tile are
//   8 m16n8 fragments, which become P's A fragments in place; ldmatrix feeds
//   Q and K, ldmatrix.trans feeds V. Q (D <= 128) is read into registers
//   once; at D = 256 it is re-read from shared memory per tile to leave the
//   registers to the 128-float output accumulator. The softmax folds
//   log2(e)/sqrt(D) into one scale for exp2f; row max is a quad shuffle,
//   row sums stay per thread until the end. P is split into bf16 hi + lo
//   halves (p to about 16 bits; FA2 and SDPA round it to 8): both multiply
//   the same V fragments, which costs a third more MMAs and no shared-memory
//   traffic. Rounded to bf16 alone, P moved the full-depth prefill's argmax
//   agreement with the plain version below its 0.95 gate.
//   K/V tiles of 64 keys go through a 2-stage cp.async ring in shared
//   memory, the next tile's copy overlapping this tile's math; all data
//   stays bf16 in shared memory, rows padded to D + 8 elements (16 bytes)
//   so that the 8 rows of each ldmatrix hit distinct banks at every D,
//   80 included (its 160-byte rows need no swizzle box). Query rows
//   past Sq and keys past Sk are zero-filled by cp.async and masked, each
//   on its own: a ragged Sq or Sk needs no padding (whisper's 1,500 frames
//   are 23 tiles of 64 and one of 28). Each q tile visits only the k tiles
//   of its band, [p_lo - window + 1, p_hi] in positions; a warp skips a
//   tile none of its rows can see, and masks elements only on tiles that
//   straddle the diagonal, the window edge or Sk. The grid launches the
//   last (causally heaviest) q tiles first. A decode step's one query row
//   (Sq = 1) runs in a 64-row tile: 15 of warp 0's 16 rows idle, and warps
//   1-3 skip every tile. Shared memory: (64 + 2 * 2 * 64) * (D + 8) * 2 bytes,
//   87 KB at D = 128 and 169 KB at D = 256, opted into with
//   cudaFuncSetAttribute; 128 threads, __launch_bounds__(128, 2).
//   Registers (-O3, sm_90a): 210 at D = 128 without spills, 255 with 24
//   bytes spilled at D = 256; so two blocks, 8 warps, per SM (one at
//   D = 256). Two small blocks ran faster than one of 128 rows and 8 warps
//   (PERF.md), for twice the K/V reads from L2: a block's barrier holds 4
//   warps, not 8, so the two blocks of an SM can be in different phases.
//   What bounds it is latency, as far as the measurements show: 2 warps
//   per SM sub-partition, and the tensor-core, shared-memory and softmax
//   phases of a warp's tile do not overlap. wgmma with warp-specialised
//   loads is the next step.
//
// f32: CUDA cores (`swa_attention_kernel`), kept because TF32 tensor cores
//   cannot hold the reference's f32 tolerance (2e-5). One block of 128
//   threads per (bh, 32-row q tile); the q tile and each 32-row K/V tile
//   are staged in shared memory as f32, rows past Sq or Sk zero-filled and
//   masked;
//   each q tile loops over the k tiles of its band only. Scores: warp w
//   owns rows w, w+4, ..., w+28 and lane j owns key j, so a row's max and
//   sum are warp shuffles. P.V: thread t owns a fixed set of output columns
//   and rows; acc stays in registers (at most 64 floats, D = 256). Q and K
//   rows are padded to D + 4 floats. Shared memory is 54.5 KB at D = 128
//   and 103.7 KB at D = 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ------------------------------------------------------ f32 on CUDA cores --

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
                     T* __restrict__ o, int sq, int sk, int n_qt, int causal, int window,
                     int q_offset, float scale) {
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
  const int q_hi = min(q_lo + BQ, sq) - 1;
  const int64_t q_base = static_cast<int64_t>(bh) * sq * D;
  const int64_t kv_base = static_cast<int64_t>(bh) * sk * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The band of keys any row of this tile can see (row r at position
  // q_offset + r).
  const int k_begin = window > 0 ? max(0, q_offset + q_lo - window + 1) : 0;
  const int k_end = causal ? min(sk, q_offset + q_hi + 1) : sk;  // exclusive
  const int kt_first = k_begin / BK, kt_last = (k_end - 1) / BK;

  load_tile<T, D>(q + q_base, q_lo, sq, Qs, Sh::LD);

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
    load_tile<T, D>(k + kv_base, k_lo, sk, Ks, Sh::LD);
    load_tile<T, D>(v + kv_base, k_lo, sk, Vs, D);
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
      const int qpos = q_offset + q_lo + row;
      const bool valid = kpos < sk && (!causal || kpos <= qpos) &&
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
    if (q_lo + row >= sq) continue;
    const float inv = 1.f / fmaxf(Ls[row], 1e-30f);
    T* out = o + q_base + static_cast<int64_t>(q_lo + row) * D;
#pragma unroll
    for (int c = 0; c < Sh::CPT; ++c) out[c * Sh::NCG + cg] = from_f32<T>(acc[r][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                   int causal, int window, int q_offset, cudaStream_t stream) {
  const size_t smem = Shape<D>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(swa_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(n_qt) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  swa_attention_kernel<T, D><<<static_cast<unsigned>(blocks), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, n_qt, causal, window, q_offset,
      1.f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// The design fields of swa_attention_design, for this kernel as built.
inline cudaError_t describe(const void* kernel, int q_rows, int kv_keys, int stages, int warps,
                            size_t smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  const int fields[] = {q_rows, kv_keys, stages, warps, static_cast<int>(smem), a.numRegs,
                        static_cast<int>(a.localSizeBytes)};
  for (int i = 0; i < 7; ++i) out[i] = fields[i];
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t design(int* out) {
  return describe(reinterpret_cast<const void*>(swa_attention_kernel<T, D>), BQ, BK, 1, WARPS,
                  Shape<D>::SMEM_FLOATS * sizeof(float), out);
}

// ------------------------------------------------- bf16 on tensor cores --
namespace mma {

constexpr int BQ = 64;         // q rows per block
constexpr int BKV = 64;        // keys per K/V tile
constexpr int WARPS = 4;       // warp w owns q rows 16w..16w+15
constexpr int NT = 32 * WARPS;
constexpr int STAGES = 2;      // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

template <int D>
struct Shape {
  static_assert(D % 16 == 0 && D <= 256, "D must be a multiple of 16, at most 256");
  static constexpr int LD = D + 8;           // smem row stride (elements)
  static constexpr int KD = D / 16;          // k-steps of Q.K^T
  static constexpr int ND = D / 8;           // n-tiles of the output
  static constexpr int NS = BKV / 8;         // n-tiles of the scores
  static constexpr bool Q_IN_REGS = D <= 128;
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int KV_ELEMS = BKV * LD;
  static constexpr size_t SMEM_BYTES = (Q_ELEMS + 2 * STAGES * KV_ELEMS) * sizeof(bf16);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi): hi + lo
// holds x to about 16 bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Rows [row0, row0 + NROWS) of a [S, D] matrix into shared memory with row
// stride LD, by cp.async; rows at or past s are zero-filled.
template <int D, int NROWS>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src, int row0, int s,
                                          bf16* __restrict__ dst) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < NROWS * CPR; c += NT) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = row0 + r < s;
    cp_async16(dst + r * Shape<D>::LD + col,
               src + static_cast<int64_t>(ok ? row0 + r : 0) * D + col, ok);
  }
}

// The m16n8k16 A fragment of the 16 x 16 block at `tile` of a row-major
// smem tile with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int lane) {
  ldmatrix_x4(a, tile + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8);
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
swa_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o, int bh, int sq,
                         int sk, int n_qt, int causal, int window, int q_offset,
                         float scale_log2) {
  using Sh = Shape<D>;
  constexpr int LD = Sh::LD;
  extern __shared__ float4 smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + Sh::Q_ELEMS;                   // [STAGES][BKV][LD]
  bf16* Vs = Ks + STAGES * Sh::KV_ELEMS;         // [STAGES][BKV][LD]

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh;  // heaviest first
  const int b = static_cast<int>(blockIdx.x) % bh;
  const int q_lo = qt * BQ;
  const int q_hi = min(q_lo + BQ, sq) - 1;
  const int64_t q_base = static_cast<int64_t>(b) * sq * D;
  const int64_t kv_base = static_cast<int64_t>(b) * sk * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in quad
  const int wq_lo = q_lo + 16 * warp;     // the warp's first q row
  const int wp_lo = q_offset + wq_lo, wp_hi = wp_lo + 15;  // its rows' positions

  // The band of keys any row of this tile can see.
  const int k_begin = window > 0 ? max(0, q_offset + q_lo - window + 1) : 0;
  const int k_end = causal ? min(sk, q_offset + q_hi + 1) : sk;  // exclusive
  const int kt_first = k_begin / BKV;
  const int n_kt = (k_end - 1) / BKV - kt_first + 1;

  load_rows<D, BQ>(q + q_base, q_lo, sq, Qs);
  load_rows<D, BKV>(k + kv_base, kt_first * BKV, sk, Ks);
  load_rows<D, BKV>(v + kv_base, kt_first * BKV, sk, Vs);
  cp_async_commit();

  uint32_t qf[Sh::Q_IN_REGS ? Sh::KD : 1][4];
  float acc[Sh::ND][4];
#pragma unroll
  for (int n = 0; n < Sh::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, raw scores
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

  for (int i = 0; i < n_kt; ++i) {
    const int stage = i % STAGES;
    const int k_lo = (kt_first + i) * BKV;
    if (i + 1 < n_kt) {  // the next tile's copy overlaps this tile's math
      const int nxt = (i + 1) % STAGES;
      load_rows<D, BKV>(k + kv_base, k_lo + BKV, sk, Ks + nxt * Sh::KV_ELEMS);
      load_rows<D, BKV>(v + kv_base, k_lo + BKV, sk, Vs + nxt * Sh::KV_ELEMS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + stage * Sh::KV_ELEMS;
    const bf16* Vt = Vs + stage * Sh::KV_ELEMS;
    const bf16* Qw = Qs + 16 * warp * LD;
    if constexpr (Sh::Q_IN_REGS) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < Sh::KD; ++kk) load_a<LD>(qf[kk], Qw + kk * 16, lane);
      }
    }

    // Warp-uniform: does any row of this warp see a key of this tile, and
    // do all of its rows see all of them?
    const bool skip = wq_lo >= sq || (causal && k_lo > wp_hi) ||
                      (window > 0 && k_lo + BKV - 1 <= wp_lo - window);
    if (!skip) {
      const bool full = k_lo + BKV <= sk && (!causal || k_lo + BKV - 1 <= wp_lo) &&
                        (window <= 0 || k_lo > wp_hi - window);

      // S = Q K^T: 16 rows x 64 keys, 8 fragments of m16n8.
      float sc[Sh::NS][4];
#pragma unroll
      for (int n = 0; n < Sh::NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < Sh::KD; ++kk) {
        uint32_t a[4];
        if constexpr (Sh::Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          load_a<LD>(a, Qw + kk * 16, lane);
        }
#pragma unroll
        for (int nj = 0; nj < Sh::NS / 2; ++nj) {
          // keys 16nj..16nj+15 at d 16kk..16kk+15: b0, b1 of two n-tiles
          uint32_t bk[4];
          ldmatrix_x4(bk, Kt + (nj * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * nj], a, bk[0], bk[1]);
          mma_bf16(sc[2 * nj + 1], a, bk[2], bk[3]);
        }
      }

      if (!full) {
#pragma unroll
        for (int n = 0; n < Sh::NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = wp_lo + g + (e >> 1) * 8;  // a position
            const int key = k_lo + 8 * n + 2 * t + (e & 1);
            const bool ok = key < sk && (!causal || key <= row) &&
                            (window <= 0 || key > row - window);
            if (!ok) sc[n][e] = -INFINITY;
          }
      }

      // Online softmax over the two rows this thread holds.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < Sh::NS; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);
        // no visible key for this row yet: p = 0 and acc, l stay 0
        const float m_scaled = m_new == -INFINITY ? 0.f : m_new * scale_log2;
        const float alpha = exp2f(m_run[r] * scale_log2 - m_scaled);
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < Sh::NS; ++n) {
          sc[n][2 * r] = exp2f(fmaf(sc[n][2 * r], scale_log2, -m_scaled));
          sc[n][2 * r + 1] = exp2f(fmaf(sc[n][2 * r + 1], scale_log2, -m_scaled));
          sum += sc[n][2 * r] + sc[n][2 * r + 1];
        }
        l_run[r] = l_run[r] * alpha + sum;
#pragma unroll
        for (int n = 0; n < Sh::ND; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }

      // acc += P V. P's A fragments are the score fragments, each split
      // into bf16 hi + lo halves; every V fragment feeds both products.
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* p = &sc[2 * kk + (e >> 1)][(e & 1) * 2];
          split_bf16(p[0], p[1], hi[e], lo[e]);
        }
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          // keys 16kk..16kk+15 at d 16dn..16dn+15, transposed: b0, b1 of two n-tiles
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                    dn * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dn], hi, bv[0], bv[1]);
          mma_bf16(acc[2 * dn + 1], hi, bv[2], bv[3]);
          mma_bf16(acc[2 * dn], lo, bv[0], bv[1]);
          mma_bf16(acc[2 * dn + 1], lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the copy two tiles ahead
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = wq_lo + g + 8 * r;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* out = o + q_base + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < Sh::ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                   int causal, int window, int q_offset, cudaStream_t stream) {
  const size_t smem = Shape<D>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(swa_attention_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(n_qt) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  swa_attention_mma_kernel<D><<<static_cast<unsigned>(blocks), NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), bh, sq, sk, n_qt, causal, window, q_offset,
      LOG2E / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <int D>
cudaError_t design(int* out) {
  return describe(reinterpret_cast<const void*>(swa_attention_mma_kernel<D>), BQ, BKV, STAGES,
                  WARPS, Shape<D>::SMEM_BYTES, out);
}

}  // namespace mma

// bf16 to the tensor-core kernel, f32 to the CUDA-core kernel.
template <typename T, int D>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                         int sk, int causal, int window, int q_offset, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>) {
    return launch<float, D>(q, k, v, o, bh, sq, sk, causal, window, q_offset, stream);
  } else {
    return mma::launch<D>(q, k, v, o, bh, sq, sk, causal, window, q_offset, stream);
  }
}

template <typename T, int D>
cudaError_t design_dtype(int* out) {
  if constexpr (std::is_same_v<T, float>) {
    return design<float, D>(out);
  } else {
    return mma::design<D>(out);
  }
}

template <typename T>
cudaError_t design_d(int d, int* out) {
  switch (d) {
    case 32: return design_dtype<T, 32>(out);
    case 64: return design_dtype<T, 64>(out);
    case 80: return design_dtype<T, 80>(out);
    case 128: return design_dtype<T, 128>(out);
    case 256: return design_dtype<T, 256>(out);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                     int d, int causal, int window, int q_offset, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_dtype<T, 32>(q, k, v, o, bh, sq, sk, causal, window, q_offset, stream);
    case 64: return launch_dtype<T, 64>(q, k, v, o, bh, sq, sk, causal, window, q_offset, stream);
    case 80: return launch_dtype<T, 80>(q, k, v, o, bh, sq, sk, causal, window, q_offset, stream);
    case 128:
      return launch_dtype<T, 128>(q, k, v, o, bh, sq, sk, causal, window, q_offset, stream);
    case 256:
      return launch_dtype<T, 256>(q, k, v, o, bh, sq, sk, causal, window, q_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: [bh, sq, d] and k, v: [bh, sk, d], contiguous, 16-byte aligned;
// query row i sits at position q_offset + i. dtype: 0 = float32 (CUDA-core
// kernel), 1 = bfloat16 (tensor-core kernel). window <= 0 means no window.
// Every query row must see a key (the caller checks). Returns the launch's
// cudaError_t.
extern "C" int swa_attention_launch(const void* q, const void* k, const void* v, void* o, int bh,
                                    int sq, int sk, int d, int causal, int window, int q_offset,
                                    int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || q_offset < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_d<float>(q, k, v, o, bh, sq, sk, d, causal, window, q_offset, st));
    case 1:
      return static_cast<int>(
          launch_d<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, causal, window, q_offset, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The design of the kernel that runs `dtype` (as in swa_attention_launch) at
// head dim d, as built: out[0..6] = q rows per block, keys per K/V tile, K/V
// ring stages, warps per block, dynamic shared-memory bytes, registers per
// thread, local-memory (spill) bytes per thread. Returns a cudaError_t.
extern "C" int swa_attention_design(int dtype, int d, int* out) {
  switch (dtype) {
    case 0: return static_cast<int>(design_d<float>(d, out));
    case 1: return static_cast<int>(design_d<__nv_bfloat16>(d, out));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* swa_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
