// Mamba-2's chunked SSD (state-space duality), forward and backward, for
// Hopper (sm_90a): the function of repro_torch.kernels.ref.ssd and its
// gradient with respect to all five inputs.
//
// Replaces no TPU kernel: the reference computes the SSD in plain jnp
// (src/repro/models/mamba2.py:99-126, `_ssd_chunk` and `ssd`) and leaves
// its fusion to XLA. The port's plain version is a Python loop over chunks
// of ~35 torch ops each: ~275 kernels a layer-call forward, ~600 backward,
// and autograd kept four f32 [B, Q, Q, H] tensors a chunk. These kernels do
// the same arithmetic in 3 launches forward and 4 backward, and keep
// nothing of [Q, Q] size per head from the forward to the backward.
//
// Notation (one batch row b, one head h, one chunk of L <= Q rows i, j;
// T is the activation dtype, T(v) v rounded to it):
//   cs_i  = sum_{k <= i} dA_k                        f32, within the chunk
//   CB_ij = sum_n C_in B_jn                          f32 sums of exact products
//   M_ij  = CB_ij exp(cs_i - cs_j) dt_j,  j <= i     f32
//   y_i   = T( T(sum_j T(M_ij) x_j) + exp(cs_i) C_i . h )
//   h'    = exp(cs_{L-1}) h + sum_j exp(cs_{L-1} - cs_j) dt_j x_j (x) B_j
// with h the f32 [P, N] state entering the chunk (zero for the first).
// These are the plain version's casts: C.B in f32, M rounded to T before
// its product with x, that product rounded as the einsum rounds it, the
// inter-chunk term and the state in f32, the two branches' sum rounded
// once.
//
// Forward, 3 launches:
//   1. ssd_chunk_fwd, blocks of two kinds: (b, c, I, J) 64 x 64 tiles of CB
//      (J <= I), once a chunk for every head (B and C are shared by the
//      heads); (b, c, h) the cumsum cs and the chunk's own state term dh.
//   2. ssd_state_pass: each (b, h, p, n) walks the chunks in order and
//      leaves, in place of dh, the state entering each chunk.
//   3. ssd_out_fwd, (b, c, h, I): 64 rows of y, M recomputed tile by tile
//      from CB, cs and dt, the inter-chunk term from the state.
// Backward, 4 launches, for the cotangent dy (in f32 throughout: no term
// of the backward is rounded to T, and each gradient is rounded once):
//   1. ssd_chunk_bwd: (b, c, I, J, head group) CB again and, summed over
//      the group's heads, dCB_ij = sum_h (dy_i . x_j) exp(cs_i - cs_j) dt_j;
//      (b, c, h) D = sum_i exp(cs_i) dy_i (x) C_i, the state's cotangent
//      from the chunk's own output.
//   2. ssd_state_pass in reverse: in place of D, the cotangent G of the
//      state leaving each chunk (G_c = D_{c+1} + exp(cs_last) G_{c+1}).
//   3. ssd_head_bwd, (b, c, h): dx, ddt and ddA (the reverse cumsum of
//      dcs) from dM = dy x^T, M and the state's terms.
//   4. ssd_bc_bwd, (b, c, 64 rows, N tile, dC or dB): the sums over heads.
// Every sum runs in a fixed order (no atomics), so a call repeats bit for
// bit.
//
// Bound on the H100: at mamba2-780m's train shape ([2, 2048], H 48, P 64,
// N 128, Q 256) a forward call is ~10 GFLOP against ~60 MB moved, the
// backward ~2.5 times that: operations, at the tensor cores' rate.
// Design: every product is mma.sync m16n8k16 with bf16 operands and f32
// accumulation, fed from shared memory by ldmatrix (.trans where a tile is
// stored k-major, so that every tile keeps its global layout). A bf16
// value enters as itself, and the product of two is exact in f32. An f32
// value v enters as three bf16 parts, hi = bf16(v), mid = bf16(v - hi),
// lo = bf16(v - hi - mid), which hold its 24 bits; a product takes the
// part pairs whose indices sum below 3 (3 products against a bf16 value,
// 6 against another f32), the terms an f32 FMA keeps. So in bf16 the
// inter-chunk term, the state and the whole backward keep f32 precision,
// and f32 activations keep theirs. A block of 256 threads (8 warps, 4 x 2
// over a 64 x WN output) computes 64 x 64 tiles; global memory is read as
// 16-byte vectors into registers, and a loop fetches its next tile before
// the current tile's product, so the loads fly while it runs. Only tiles
// on or below the diagonal of a chunk's causal [Q, Q] block are computed;
// off the diagonal the decay exp(cs_i - cs_j) is the product of a factor
// per row and one per column (split_decay), 128 exponentials a tile in
// place of 4,096, in the backward. The forward keeps the plain version's
// order where the rounding of M to T depends on it: cs is one running sum
// row by row (torch.cumsum's order on the card), each decay is
// exp(cs_i - cs_j), and no multiply and add are fused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kT = 64;             // tile rows: chunk rows, or head dims
constexpr int kP = 64;             // head dim
constexpr int kMaxQ = 256;         // longest chunk
constexpr int kHeadsPerGroup = 16; // heads summed by one dCB block

struct Dims {
  int B, S, H, N, Q, nc, nt;  // nc chunks of Q rows; nt 64-row tiles a chunk
  int ldq;                    // row stride of cb and dcb: nt * 64, whole tiles
};

// bf16 parts an operand of type T takes: one for bf16, three for f32.
template <typename T> __host__ __device__ constexpr int parts() { return std::is_same<T, bf16>::value ? 1 : 3; }
// Row stride, in bf16, of a shared-memory tile C elements wide: 16 bytes of
// padding put the 8 rows an ldmatrix reads on distinct banks.
__host__ __device__ constexpr int ld_of(int C) { return C + 8; }
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Two consecutive values of T at p (4 or 8 bytes, aligned).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ------------------------------------------------------- tensor cores ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// A 64 x WN output tile over 8 warps, 4 (rows) x 2 (columns): warp w owns
// rows m0() .. + 16 and columns n0() .. + WN / 2, as NT m16n8 accumulators;
// acc[j][e] sits at row(e), col(j, e).
template <int WN> struct Frag {
  static_assert(WN == 16 || WN == 32 || WN == 64 || WN == 128, "output width");
  static constexpr int NT = WN / 16;
  __device__ static int warp() { return threadIdx.x >> 5; }
  __device__ static int lane() { return threadIdx.x & 31; }
  __device__ static int m0() { return (warp() & 3) * 16; }
  __device__ static int n0() { return (warp() >> 2) * (WN / 2); }
  __device__ static int row(int e) { return m0() + (lane() >> 2) + (e >> 1) * 8; }
  __device__ static int col(int j, int e) { return n0() + j * 8 + 2 * (lane() & 3) + (e & 1); }
};

template <int NT> __device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc[m][n] += sum_{k < K} A[m][k] B[k][n] over bf16 tiles in shared
// memory of NPA and NPB parts (part p at base + p * part stride). A is
// stored [m][k] (row stride lda), or [k][m] when A_KM; B is stored [n][k],
// or [k][n] when B_KM. Part pairs (pa, pb) with pa + pb < 3 are summed.
template <int WN, int NPA, int NPB, bool A_KM, bool B_KM>
__device__ __forceinline__ void mma_gemm(float (&acc)[WN / 16][4], const bf16* A, int lda,
                                         int aps, const bf16* B, int ldb, int bps, int K) {
  using F = Frag<WN>;
  const int lane = F::lane(), m0 = F::m0(), n0 = F::n0();
  const int r8 = lane & 7, q1 = (lane >> 3) & 1, q2 = lane >> 4;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[NPA][4];
#pragma unroll
    for (int pa = 0; pa < NPA; ++pa) {
      if constexpr (A_KM)
        ldsm_x4_t(a[pa], A + pa * aps + (k0 + q2 * 8 + r8) * lda + m0 + q1 * 8);
      else
        ldsm_x4(a[pa], A + pa * aps + (m0 + q1 * 8 + r8) * lda + k0 + q2 * 8);
    }
    if constexpr (WN >= 32) {
#pragma unroll
      for (int nj = 0; nj < WN / 32; ++nj) {
        uint32_t b[NPB][4];
#pragma unroll
        for (int pb = 0; pb < NPB; ++pb) {
          if constexpr (B_KM)
            ldsm_x4_t(b[pb], B + pb * bps + (k0 + q1 * 8 + r8) * ldb + n0 + nj * 16 + q2 * 8);
          else
            ldsm_x4(b[pb], B + pb * bps + (n0 + nj * 16 + q2 * 8 + r8) * ldb + k0 + q1 * 8);
        }
#pragma unroll
        for (int pa = 0; pa < NPA; ++pa)
#pragma unroll
          for (int pb = 0; pb < NPB; ++pb)
            if (pa + pb < 3) {
              mma_bf16(acc[2 * nj], a[pa], b[pb][0], b[pb][1]);
              mma_bf16(acc[2 * nj + 1], a[pa], b[pb][2], b[pb][3]);
            }
      }
    } else {
      uint32_t b[NPB][2];
#pragma unroll
      for (int pb = 0; pb < NPB; ++pb) {
        if constexpr (B_KM)
          ldsm_x2_t(b[pb], B + pb * bps + (k0 + q1 * 8 + r8) * ldb + n0);
        else
          ldsm_x2(b[pb], B + pb * bps + (n0 + r8) * ldb + k0 + q1 * 8);
      }
#pragma unroll
      for (int pa = 0; pa < NPA; ++pa)
#pragma unroll
        for (int pb = 0; pb < NPB; ++pb)
          if (pa + pb < 3) mma_bf16(acc[0], a[pa], b[pb][0], b[pb][1]);
    }
  }
}

// ------------------------------------------------------------- tiles ----
struct One {
  __device__ float operator()(int) const { return 1.f; }
};
struct Keep {
  __device__ float operator()(int, int, float v) const { return v; }
};

// 16 bytes of T, unpacked to floats.
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4], const float*) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8], const bf16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// VW floats into NP bf16 parts at s (part stride ps): NP 1 rounds each
// value to bf16; NP 3 splits it into hi, mid and lo.
template <int NP, int VW>
__device__ __forceinline__ void store_parts(bf16* s, int ps, const float (&x)[VW]) {
  float r[VW];
#pragma unroll
  for (int e = 0; e < VW; ++e) r[e] = x[e];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    __nv_bfloat162 h[VW / 2];
#pragma unroll
    for (int e = 0; e < VW; e += 2) {
      h[e / 2] = __floats2bfloat162_rn(r[e], r[e + 1]);
      const float2 f = __bfloat1622float2(h[e / 2]);
      r[e] -= f.x;
      r[e + 1] -= f.y;
    }
    if constexpr (VW == 8)
      *reinterpret_cast<uint4*>(s + p * ps) = *reinterpret_cast<const uint4*>(h);
    else
      *reinterpret_cast<uint2*>(s + p * ps) = *reinterpret_cast<const uint2*>(h);
  }
}

// A tile of R rows of C elements of a row-major global block (row r at
// g + r * gld, 16-byte aligned), fetched into registers as 16-byte vectors
// by fetch() and written to shared memory by store(): a loop issues the
// next tile's fetch before the current tile's product, so that the loads
// fly while it runs. Rows r >= valid read 0; each row is scaled by f(r),
// and g(r, c, v) maps each value on its way. store() writes NP bf16 parts
// at s[r * ld + c] (part stride ps): the tile keeps its global layout.
template <int R, int C, typename T>
struct TileRegs {
  static constexpr int VW = 16 / static_cast<int>(sizeof(T));
  static_assert(C % VW == 0, "a row is whole 16-byte vectors");
  static constexpr int CV = C / VW;
  static constexpr int NV = (R * CV + kThreads - 1) / kThreads;
  uint4 v[NV];
  float k[NV];

  template <typename F>
  __device__ __forceinline__ void fetch(const T* __restrict__ g, long long gld, int valid, F f) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int idx = threadIdx.x + u * kThreads, r = idx % R, cv = idx / R;
      if (idx < R * CV && r < valid) {
        v[u] = __ldg(reinterpret_cast<const uint4*>(g + r * gld + cv * VW));
        k[u] = f(r);
      } else {
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        k[u] = 0.f;
      }
    }
  }
  template <int NP, typename G = Keep>
  __device__ __forceinline__ void store(bf16* s, int ld, int ps, G g = G{}) const {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int idx = threadIdx.x + u * kThreads, r = idx % R, cv = idx / R;
      if (idx >= R * CV) break;
      bf16* d = s + r * ld + cv * VW;
      if constexpr (NP == 1 && std::is_same<T, bf16>::value && std::is_same<G, Keep>::value) {
        *reinterpret_cast<uint4*>(d) = v[u];  // exact: the row scale is 1, or the row 0
      } else {
        float x[VW];
        unpack(v[u], x, static_cast<const T*>(nullptr));
#pragma unroll
        for (int e = 0; e < VW; ++e) x[e] = g(r, cv * VW + e, x[e] * k[u]);
        store_parts<NP>(d, ps, x);
      }
    }
  }
};

// TileRegs' fetch and store at once, with row stride ld_of(C).
template <int NP, int R, int C, typename T, typename F>
__device__ __forceinline__ void load_tile(bf16* s, int ps, const T* __restrict__ g, long long gld,
                                          int valid, F f) {
  TileRegs<R, C, T> t;
  t.fetch(g, gld, valid, f);
  t.template store<NP>(s, ld_of(C), ps);
}

// ------------------------------------------------------------ helpers ----
// In place suffix sums of v[0, n) (n <= kMaxQ): v[i] becomes the sum of
// v[i..n). Called by one whole warp.
__device__ void suffix_sums(float* v, int n) {
  const int lane = threadIdx.x & 31;
  constexpr int per = kMaxQ / 32;
  float loc[per], run = 0.f;
#pragma unroll
  for (int k = 0; k < per; ++k) {
    const int q = lane * per + k, i = n - 1 - q;
    run += q < n ? v[i] : 0.f;
    loc[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  const float excl = incl - run;
#pragma unroll
  for (int k = 0; k < per; ++k) {
    const int q = lane * per + k, i = n - 1 - q;
    if (q < n) v[i] = loc[k] + excl;
  }
}

// Sum of v over the block, in a fixed order; red holds kThreads / 32 floats.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// Sums over the 4 lanes of a quad (a row's columns in a warp's
// accumulators), and over the 8 quads of a warp (a column's rows).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ void pair_of(int p, int& I, int& J) {
  I = 0;
  while (p > I) { p -= I + 1; ++I; }
  J = p;
}

__device__ __forceinline__ int chunk_len(const Dims& d, int c) {
  return min(d.Q, d.S - c * d.Q);
}

// One head's values over a chunk's L rows (g[i * H]) into shared memory;
// rows past L read 0.
__device__ __forceinline__ void load_rows(float* s, const float* __restrict__ g, int H,
                                          int L) {
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads) s[i] = i < L ? g[(long long)i * H] : 0.f;
}

// exp(cs_i - cs_j) for row i of tile I and row j of tile J < I, as
// ei[i] * fj[j] = exp(cs_i - cs_m) * exp(cs_m - cs_j) with m the J tile's
// last row: cs falls along the chunk (dA <= 0), so both factors lie in
// [0, 1]. Rows of I past L read 0.
__device__ __forceinline__ void split_decay(float* ei, float* fj, const float* cs, int I, int J,
                                            int L) {
  const float m = cs[J * kT + kT - 1];
  for (int t = threadIdx.x; t < 2 * kT; t += kThreads) {
    if (t < kT) {
      const int gi = I * kT + t;
      ei[t] = gi < L ? expf(cs[gi] - m) : 0.f;
    } else {
      fj[t - kT] = expf(m - cs[J * kT + t - kT]);
    }
  }
}

// Shared memory, in bf16, of cb_tile's two tiles.
template <typename T> __host__ __device__ constexpr int cb_smem() { return 2 * parts<T>() * kT * ld_of(64); }

// The tile (I, J) of CB = C B^T into cb (row stride ldq), the sum over N
// in steps of 64 through sa and sb (NP parts of 64 x 72 bf16 each); rows
// and columns past the chunk read 0.
template <typename T, int N>
__device__ void cb_tile(const T* __restrict__ Bm, const T* __restrict__ Cm, float* cb,
                        const Dims& d, long long row0, int L, int I, int J, bf16* sa,
                        bf16* sb) {
  constexpr int KC = N < 64 ? N : 64, NP = parts<T>(), PS = kT * ld_of(64);
  using F = Frag<64>;
  const T* Ci = Cm + (row0 + I * kT) * N;
  const T* Bj = Bm + (row0 + J * kT) * N;
  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < N; k0 += KC) {
    load_tile<NP, kT, KC>(sa, PS, Ci + k0, N, L - I * kT, One{});
    load_tile<NP, kT, KC>(sb, PS, Bj + k0, N, L - J * kT, One{});
    __syncthreads();
    mma_gemm<64, NP, NP, false, false>(acc, sa, ld_of(KC), PS, sb, ld_of(KC), PS, KC);
    __syncthreads();
  }
  float* out = cb + (long long)I * kT * d.ldq + J * kT;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      store2(out + F::row(e) * d.ldq + F::col(j, e), acc[j][e], acc[j][e + 1]);
}

// ---------------------------------------------------------------- forward --
constexpr int kRowsStep = 32;  // chunk rows a step of the state's products

template <typename T, int N> __host__ __device__ constexpr int chunk_fwd_smem() {
  return max_of(kRowsStep * ld_of(kP) * 3 + kRowsStep * ld_of(N) * parts<T>(), cb_smem<T>());
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_fwd(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
              const float* __restrict__ dt, const float* __restrict__ dA,
              float* __restrict__ cs, float* __restrict__ cb, float* __restrict__ st, Dims d) {
  extern __shared__ __align__(16) bf16 smem[];
  __shared__ float scs[kMaxQ], sw[kMaxQ];
  constexpr int KJ = kRowsStep;
  const int n_pairs = d.nt * (d.nt + 1) / 2;
  int blk = blockIdx.x;
  if (blk < d.B * d.nc * n_pairs) {
    // (b, c, I, J): a tile of CB, once for every head
    int I, J;
    pair_of(blk % n_pairs, I, J);
    blk /= n_pairs;
    const int c = blk % d.nc, b = blk / d.nc, L = chunk_len(d, c);
    if (I * kT >= L) return;
    cb_tile<T, N>(Bm, Cm, cb + (long long)(b * d.nc + c) * d.ldq * d.ldq, d,
                  (long long)b * d.S + c * d.Q, L, I, J, smem, smem + cb_smem<T>() / 2);
    return;
  }
  // (b, c, h): cs, then dh[p][n] = sum_j (w_j x_jp) B_jn with
  // w_j = exp(cs_last - cs_j) dt_j, into st [B, nc, H, P, N]
  blk -= d.B * d.nc * n_pairs;
  const int h = blk % d.H, c = (blk / d.H) % d.nc, b = blk / (d.H * d.nc);
  const int L = chunk_len(d, c);
  const long long row0 = (long long)b * d.S + c * d.Q;  // first row of the chunk
  load_rows(scs, dA + row0 * d.H + h, d.H, L);
  __syncthreads();
  // one running sum, row by row: the order of torch.cumsum over a chunk's
  // rows on the card, so that cs, the decays and the rounding of M to T
  // are the plain version's
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int i = 0; i < L; ++i) scs[i] = run = __fadd_rn(run, scs[i]);
  }
  __syncthreads();
  const float last = scs[L - 1];
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads) {
    if (i < L) {
      cs[(row0 + i) * d.H + h] = scs[i];
      sw[i] = expf(last - scs[i]) * dt[(row0 + i) * d.H + h];
    } else {
      sw[i] = 0.f;
    }
  }
  __syncthreads();
  constexpr int PSA = KJ * ld_of(kP), PSB = KJ * ld_of(N);
  bf16* sa = smem;            // w o x rows [j][p], 3 parts
  bf16* sb = smem + 3 * PSA;  // B rows [j][n]
  using F = Frag<N>;
  float acc[F::NT][4];
  zero(acc);
  const long long xs = (long long)d.H * kP;  // row stride of x
  const T* xr = x + (row0 * d.H + h) * kP;
  const T* Br = Bm + row0 * N;
  TileRegs<KJ, kP, T> tx_;
  TileRegs<KJ, N, T> tb_;
  auto fetch = [&](int j0) {
    const float* w = sw + j0;
    tx_.fetch(xr + j0 * xs, xs, L - j0, [w](int r) { return w[r]; });
    tb_.fetch(Br + (long long)j0 * N, N, L - j0, One{});
  };
  fetch(0);
  for (int j0 = 0; j0 < L; j0 += KJ) {
    tx_.template store<3>(sa, ld_of(kP), PSA);
    tb_.template store<parts<T>()>(sb, ld_of(N), PSB);
    __syncthreads();
    if (j0 + KJ < L) fetch(j0 + KJ);
    mma_gemm<N, 3, parts<T>(), true, true>(acc, sa, ld_of(kP), PSA, sb, ld_of(N), PSB, KJ);
    __syncthreads();
  }
  float* out = st + ((long long)(b * d.nc + c) * d.H + h) * kP * N;
#pragma unroll
  for (int j = 0; j < F::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      store2(out + F::row(e) * N + F::col(j, e), acc[j][e], acc[j][e + 1]);
}

// Walks the chunks of each (b, h, p, n) in order (in reverse order when
// reverse) and leaves in place of each chunk's term t_c the running value
// before it: v = exp(cs_last(c)) v + t_c. Loads go out 8 chunks at a time.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass(float* __restrict__ st, const float* __restrict__ cs, Dims d, int reverse) {
  constexpr int kBatch = 8;
  const long long PN = (long long)kP * d.N;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)d.B * d.H * PN) return;
  const int e = static_cast<int>(idx % PN);
  const int h = static_cast<int>((idx / PN) % d.H), b = static_cast<int>(idx / (PN * d.H));
  float v = 0.f;
  for (int k0 = 0; k0 < d.nc; k0 += kBatch) {
    float t[kBatch], decay[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u, c = reverse ? d.nc - 1 - k : k;
      if (k < d.nc) {
        t[u] = st[((long long)(b * d.nc + c) * d.H + h) * PN + e];
        decay[u] = expf(cs[((long long)b * d.S + c * d.Q + chunk_len(d, c) - 1) * d.H + h]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u, c = reverse ? d.nc - 1 - k : k;
      if (k < d.nc) {
        st[((long long)(b * d.nc + c) * d.H + h) * PN + e] = v;
        v = __fadd_rn(__fmul_rn(v, decay[u]), t[u]);
      }
    }
  }
}

template <typename T> __host__ __device__ constexpr int out_fwd_smem() { return (3 + 2 * parts<T>()) * kT * ld_of(64); }

// (b, c, h, I): 64 rows of y.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_out_fwd(const T* __restrict__ x, const T* __restrict__ Cm, const float* __restrict__ dt,
            const float* __restrict__ cs, const float* __restrict__ cb,
            const float* __restrict__ st, T* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) bf16 smem[];
  __shared__ float scs[kMaxQ], sdt[kMaxQ];
  constexpr int KC = N < 64 ? N : 64, NP = parts<T>(), LD = ld_of(64), PS = kT * LD;
  bf16* s3 = smem;           // h rows [p][n], 3 parts
  bf16* sa = smem + 3 * PS;  // C rows [i][n], then T(M) [i][j]
  bf16* sb = sa + NP * PS;   // x rows [j][p]
  using F = Frag<64>;
  int blk = blockIdx.x;
  const int I = blk % d.nt;
  blk /= d.nt;
  const int h = blk % d.H, c = (blk / d.H) % d.nc, b = blk / (d.H * d.nc);
  const int L = chunk_len(d, c);
  if (I * kT >= L) return;
  const int rows_i = min(kT, L - I * kT);
  const long long row0 = (long long)b * d.S + c * d.Q;
  const long long xs = (long long)d.H * kP;
  load_rows(scs, cs + row0 * d.H + h, d.H, L);
  load_rows(sdt, dt + row0 * d.H + h, d.H, L);
  __syncthreads();

  // inter-chunk: C_i . h, then times exp(cs_i)
  float inter[4][4];
  zero(inter);
  const T* Ci = Cm + (row0 + I * kT) * N;
  const float* hs = st + ((long long)(b * d.nc + c) * d.H + h) * kP * N;
  for (int k0 = 0; k0 < N; k0 += KC) {
    load_tile<NP, kT, KC>(sa, PS, Ci + k0, N, rows_i, One{});
    load_tile<3, kP, KC>(s3, PS, hs + k0, N, kP, One{});
    __syncthreads();
    mma_gemm<64, NP, 3, false, false>(inter, sa, ld_of(KC), PS, s3, ld_of(KC), PS, KC);
    __syncthreads();
  }

  // intra-chunk: sum over J <= I of T(M[I, J]) x[J]; T(M) is exact in NP parts
  float intra[4][4];
  zero(intra);
  const float* cbi = cb + (long long)(b * d.nc + c) * d.ldq * d.ldq + (long long)I * kT * d.ldq;
  const T* xr = x + (row0 * d.H + h) * kP;
  TileRegs<kT, kT, float> tc;  // CB[I][J]
  TileRegs<kT, kP, T> tx_;     // x[J]
  tc.fetch(cbi, d.ldq, kT, One{});
  tx_.fetch(xr, xs, L, One{});
  for (int J = 0; J <= I; ++J) {
    const bool diag = J == I;
    // M = (CB exp(cs_i - cs_j)) dt_j, each product rounded on its own as
    // the plain version rounds it
    tc.template store<NP>(sa, LD, PS, [&](int i, int j, float v) {
      const int gi = I * kT + i, gj = J * kT + j;
      if (gi >= L || gj > gi) return 0.f;
      return round_to<T>(__fmul_rn(__fmul_rn(v, expf(scs[gi] - scs[gj])), sdt[gj]));
    });
    tx_.template store<NP>(sb, LD, PS);
    __syncthreads();
    if (!diag) {
      tc.fetch(cbi + (J + 1) * kT, d.ldq, kT, One{});
      tx_.fetch(xr + (long long)(J + 1) * kT * xs, xs, L - (J + 1) * kT, One{});
    }
    mma_gemm<64, NP, NP, false, true>(intra, sa, LD, PS, sb, LD, PS, kT);
    __syncthreads();
  }

  T* yr = y + ((row0 + I * kT) * d.H + h) * kP;
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int i = F::row(e);
    if (i >= rows_i) continue;
    const float ex = expf(scs[I * kT + i]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store2(yr + i * xs + F::col(j, e),
             __fadd_rn(round_to<T>(intra[j][e]), __fmul_rn(inter[j][e], ex)),
             __fadd_rn(round_to<T>(intra[j][e + 1]), __fmul_rn(inter[j][e + 1], ex)));
  }
}

// --------------------------------------------------------------- backward --
template <typename T, int N> __host__ __device__ constexpr int chunk_bwd_smem() {
  return max_of(max_of(2 * parts<T>() * kT * ld_of(kP),
                       kRowsStep * ld_of(kP) * parts<T>() + kRowsStep * ld_of(N) * 3),
                cb_smem<T>());
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd(const T* __restrict__ dy, const T* __restrict__ x, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const float* __restrict__ dt,
              const float* __restrict__ cs, float* __restrict__ cb, float* __restrict__ dcb,
              float* __restrict__ g, Dims d, int groups) {
  extern __shared__ __align__(16) bf16 smem[];
  __shared__ float sv[kMaxQ];
  constexpr int NP = parts<T>();
  const int n_pairs = d.nt * (d.nt + 1) / 2;
  const long long xs = (long long)d.H * kP;
  const long long QQ = (long long)d.ldq * d.ldq;
  int blk = blockIdx.x;
  if (blk < d.B * d.nc * n_pairs * groups) {
    // (b, c, I, J, group): CB (group 0) and the group's part of dCB
    using F = Frag<64>;
    constexpr int LD = ld_of(kP), PS = kT * LD;
    const int grp = blk % groups;
    blk /= groups;
    int I, J;
    pair_of(blk % n_pairs, I, J);
    blk /= n_pairs;
    const int c = blk % d.nc, b = blk / d.nc, L = chunk_len(d, c);
    if (I * kT >= L) return;
    const int rows_i = min(kT, L - I * kT), rows_j = min(kT, L - J * kT);
    const long long row0 = (long long)b * d.S + c * d.Q;
    if (grp == 0)
      cb_tile<T, N>(Bm, Cm, cb + (long long)(b * d.nc + c) * QQ, d, row0, L, I, J, smem,
                    smem + cb_smem<T>() / 2);
    bf16* sa = smem;            // dy rows [i][p]
    bf16* sb = smem + NP * PS;  // x rows [j][p]
    const int per = (d.H + groups - 1) / groups;
    const int h0 = grp * per, h1 = min(d.H, h0 + per);
    const bool diag = I == J;
    // per head: dy[I], x[J] and a value a row (t < 128): on the diagonal
    // tile cs of the rows and dt of the columns, else the two factors of
    // the decay (split_decay), dt folded into the columns'
    TileRegs<kT, kP, T> tdy, tx_;
    float fac = 0.f;
    auto fetch = [&](int h) {
      tdy.fetch(dy + ((row0 + I * kT) * d.H + h) * kP, xs, rows_i, One{});
      tx_.fetch(x + ((row0 + J * kT) * d.H + h) * kP, xs, rows_j, One{});
      const int t = threadIdx.x;
      if (t < 2 * kT) {
        const float* csh = cs + row0 * d.H + h;
        const int gi = (t < kT ? I : J) * kT + t % kT;
        const float ci = gi < L ? csh[(long long)gi * d.H] : 0.f;
        const float m = diag ? 0.f : csh[(long long)(J * kT + kT - 1) * d.H];
        if (t < kT) {
          fac = diag ? ci : (gi < L ? expf(ci - m) : 0.f);
        } else {
          const float dtj = gi < L ? dt[(row0 + gi) * d.H + h] : 0.f;
          fac = diag ? dtj : expf(m - ci) * dtj;
        }
      }
    };
    float dcb_acc[4][4];
    zero(dcb_acc);
    if (h0 < h1) fetch(h0);
    for (int h = h0; h < h1; ++h) {
      tdy.template store<NP>(sa, LD, PS);
      tx_.template store<NP>(sb, LD, PS);
      if (threadIdx.x < 2 * kT) sv[threadIdx.x] = fac;
      __syncthreads();
      if (h + 1 < h1) fetch(h + 1);
      float dm[4][4];
      zero(dm);
      mma_gemm<64, NP, NP, false, false>(dm, sa, LD, PS, sb, LD, PS, kP);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = F::row(e), jj = F::col(j, e), gi = I * kT + i, gj = J * kT + jj;
          if (gi < L && gj <= gi)
            dcb_acc[j][e] += diag ? dm[j][e] * expf(sv[i] - sv[jj]) * sv[kT + jj]
                                  : dm[j][e] * sv[i] * sv[kT + jj];
        }
      __syncthreads();
    }
    float* out = dcb + ((long long)grp * d.B + b) * d.nc * QQ + c * QQ +
                 (long long)I * kT * d.ldq + J * kT;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        store2(out + F::row(e) * d.ldq + F::col(j, e), dcb_acc[j][e], dcb_acc[j][e + 1]);
    return;
  }
  // (b, c, h): D[p][n] = sum_i dy_ip (exp(cs_i) C_in), into g [B, nc, H, P, N]
  using F = Frag<N>;
  constexpr int KI = kRowsStep, PSA = KI * ld_of(kP), PSB = KI * ld_of(N);
  blk -= d.B * d.nc * n_pairs * groups;
  const int h = blk % d.H, c = (blk / d.H) % d.nc, b = blk / (d.H * d.nc);
  const int L = chunk_len(d, c);
  const long long row0 = (long long)b * d.S + c * d.Q;
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads)
    sv[i] = i < L ? expf(cs[(row0 + i) * d.H + h]) : 0.f;
  __syncthreads();
  bf16* sa = smem;             // dy rows [i][p]
  bf16* sb = smem + NP * PSA;  // exp(cs) o C rows [i][n], 3 parts
  float acc[F::NT][4];
  zero(acc);
  const T* dyr = dy + (row0 * d.H + h) * kP;
  const T* Cr = Cm + row0 * N;
  TileRegs<KI, kP, T> tdy;
  TileRegs<KI, N, T> tc;
  auto fetch = [&](int i0) {
    const float* e = sv + i0;
    tdy.fetch(dyr + i0 * xs, xs, L - i0, One{});
    tc.fetch(Cr + (long long)i0 * N, N, L - i0, [e](int r) { return e[r]; });
  };
  fetch(0);
  for (int i0 = 0; i0 < L; i0 += KI) {
    tdy.template store<NP>(sa, ld_of(kP), PSA);
    tc.template store<3>(sb, ld_of(N), PSB);
    __syncthreads();
    if (i0 + KI < L) fetch(i0 + KI);
    mma_gemm<N, NP, 3, true, true>(acc, sa, ld_of(kP), PSA, sb, ld_of(N), PSB, KI);
    __syncthreads();
  }
  float* out = g + ((long long)(b * d.nc + c) * d.H + h) * kP * N;
#pragma unroll
  for (int j = 0; j < F::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      store2(out + F::row(e) * N + F::col(j, e), acc[j][e], acc[j][e + 1]);
}

// Shared memory of ssd_head_bwd: three tiles of 64 x 72 bf16 in 3 parts,
// then floats: 8 vectors of kMaxQ, the decay's factors and the reductions'.
constexpr int kHeadTiles = 3 * 3 * kT * ld_of(64);
constexpr int kHeadFloats = 8 * kMaxQ + 2 * kT + 4 * kT + kThreads / 32;
constexpr int kHeadSmemBytes = kHeadTiles * 2 + kHeadFloats * 4;

// (b, c, h): dx, ddt and ddA of one head over one chunk.
//   dx_j  = dt_j sum_{i >= j} CBd_ij dy_i + w_j (B_j G^T),  CBd_ij = CB_ij exp(cs_i - cs_j),
//           w_j = exp(cs_last - cs_j) dt_j
//   ddt_j = sum_{i >= j} dM_ij CBd_ij + exp(cs_last - cs_j) u_j,  u_j = x_j . (B_j G^T)
//   dcs_i = sum_j Z_ij - sum_k Z_ki + exp(cs_i) dy_i . (C_i h^T) - w_i u_i
//           (+ exp(cs_last) <G, h> + sum_j w_j u_j at i = L - 1),  Z_ij = dM_ij CBd_ij dt_j
//   ddA_k = sum_{i >= k} dcs_i
// with dM = dy x^T, h the state entering the chunk and G the cotangent of
// the state leaving it.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM: at most 128 registers
ssd_head_bwd(const T* __restrict__ dy, const T* __restrict__ x, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const float* __restrict__ dt,
             const float* __restrict__ cs, const float* __restrict__ cb,
             const float* __restrict__ st, const float* __restrict__ g, T* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ ddA, Dims d) {
  extern __shared__ __align__(16) bf16 smem[];
  constexpr int NP = parts<T>(), KC = N < 64 ? N : 64, LD = ld_of(64), PS = kT * LD;
  bf16* r1 = smem;            // B[J] rows [j][n]; CBd [i][j], 3 parts; C[I] rows [i][n]
  bf16* r2 = r1 + 3 * PS;     // G rows [p][n], 3 parts; dy[I] rows [i][p]; h rows [p][n]
  bf16* r3 = r2 + 3 * PS;     // x[J] rows [j][p]
  float* scs = reinterpret_cast<float*>(smem + kHeadTiles);  // cs_i
  float* sdt = scs + kMaxQ;        // dt_i
  float* sw = sdt + kMaxQ;         // w_i
  float* srow = sw + kMaxQ;        // [2][kMaxQ]: sum_j Z_ij and the inter-chunk term,
                                   // by column half
  float* scol = srow + 2 * kMaxQ;  // sum_k Z_kj
  float* su = scol + kMaxQ;        // -w_i u_i
  float* sddt = su + kMaxQ;        // ddt_i
  float* sei = sddt + kMaxQ;       // split_decay's factors
  float* sfj = sei + kT;
  float* red = sfj + kT;           // [4][kT] partial sums, then a warp's sum each
  using F = Frag<64>;

  const int blk = blockIdx.x;
  const int h = blk % d.H, c = (blk / d.H) % d.nc, b = blk / (d.H * d.nc);
  const int L = chunk_len(d, c);
  const long long row0 = (long long)b * d.S + c * d.Q;
  const long long xs = (long long)d.H * kP;  // row stride of x and dy
  const T* xr = x + (row0 * d.H + h) * kP;
  const T* dyr = dy + (row0 * d.H + h) * kP;
  const float* cbc = cb + (long long)(b * d.nc + c) * d.ldq * d.ldq;
  const float* hs = st + ((long long)(b * d.nc + c) * d.H + h) * kP * N;
  const float* gs = g + ((long long)(b * d.nc + c) * d.H + h) * kP * N;
  load_rows(scs, cs + row0 * d.H + h, d.H, L);
  load_rows(sdt, dt + row0 * d.H + h, d.H, L);
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads)
    srow[i] = srow[kMaxQ + i] = scol[i] = su[i] = sddt[i] = 0.f;
  __syncthreads();
  const float last = scs[L - 1];
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads)
    sw[i] = i < L ? expf(last - scs[i]) * sdt[i] : 0.f;
  const int lane = F::lane(), wm = F::warp() & 3, wn = F::warp() >> 2;
  float wu = 0.f;  // this thread's part of sum_j w_j u_j

  for (int J = 0; J * kT < L; ++J) {
    const int rows_j = min(kT, L - J * kT);
    // the state's term: s[j][p] = (B_j G^T)_p
    float acc[4][4];
    zero(acc);
    for (int k0 = 0; k0 < N; k0 += KC) {
      load_tile<NP, kT, KC>(r1, PS, Bm + (row0 + J * kT) * N + k0, N, rows_j, One{});
      load_tile<3, kP, KC>(r2, PS, gs + k0, N, kP, One{});
      __syncthreads();
      mma_gemm<64, NP, 3, false, false>(acc, r1, ld_of(KC), PS, r2, ld_of(KC), PS, KC);
      __syncthreads();
    }
    load_tile<NP, kT, kP>(r3, PS, xr + J * kT * xs, xs, rows_j, One{});
    // u_j = x_j . s_j: a quad's columns, then the two column halves
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int j = F::row(e), gj = J * kT + j;
      float u = 0.f;
      if (j < rows_j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 xv = load2(xr + (long long)gj * xs + F::col(q, e));
          u += xv.x * acc[q][e] + xv.y * acc[q][e + 1];
        }
      }
      u = quad_sum(u);
      if ((lane & 3) == 0) red[wn * kT + j] = u;
    }
    __syncthreads();
    if (threadIdx.x < kT) {
      const int gj = J * kT + threadIdx.x;
      if (gj < L) {
        const float u = red[threadIdx.x] + red[kT + threadIdx.x], w = sw[gj];
        sddt[gj] += expf(last - scs[gj]) * u;
        su[gj] -= w * u;
        wu += w * u;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float w = sw[J * kT + F::row(e)];  // 0 past L
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q][e] *= w;
    }
    // dx's intra-chunk part is dt_j sum_i CBd_ij dy_i; Z's row sums here,
    // its column sums dt_j times those of dM o CBd, which are also ddt_j's
    // intra-chunk part
    float intra[4][4], dtcol[4][2];
    zero(intra);
#pragma unroll
    for (int q = 0; q < 4; ++q) dtcol[q][0] = dtcol[q][1] = 0.f;
    TileRegs<kT, kP, T> tdy;     // dy[I]
    TileRegs<kT, kT, float> tc;  // CB[I][J]
    tdy.fetch(dyr + J * kT * xs, xs, L - J * kT, One{});
    tc.fetch(cbc + (long long)J * kT * d.ldq + J * kT, d.ldq, kT, One{});
    for (int I = J; I * kT < L; ++I) {
      const bool diag = I == J, more = (I + 1) * kT < L;
      tdy.template store<NP>(r2, LD, PS);
      if (!diag) split_decay(sei, sfj, scs, I, J, L);
      __syncthreads();
      if (more) tdy.fetch(dyr + (I + 1) * kT * xs, xs, L - (I + 1) * kT, One{});
      // dM[i][j] = dy_i . x_j
      float dm[4][4];
      zero(dm);
      mma_gemm<64, NP, NP, false, false>(dm, r2, LD, PS, r3, LD, PS, kP);
      // CBd[i][j] into r1, 3 parts (the A operand of dx's product, k = i)
      tc.template store<3>(r1, LD, PS, [&](int i, int j, float v) {
        const int gi = I * kT + i, gj = J * kT + j;
        if (gi >= L || gj > gi) return 0.f;
        return v * (diag ? expf(scs[gi] - scs[gj]) : sei[i] * sfj[j]);
      });
      __syncthreads();
      if (more) tc.fetch(cbc + (long long)(I + 1) * kT * d.ldq + J * kT, d.ldq, kT, One{});
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = F::row(e), gi = I * kT + i;
        float z = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = F::col(q, e);
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const bf16* p = r1 + i * LD + j + s;
            const float a = dm[q][e + s] * (to_f(p[0]) + to_f(p[PS]) + to_f(p[2 * PS]));
            dtcol[q][s] += a;
            z += a * sdt[J * kT + j + s];
          }
        }
        // row i's sum over this warp's columns; rows past L have CBd 0
        z = quad_sum(z);
        if ((lane & 3) == 0 && gi < L) srow[wn * kMaxQ + gi] += z;
      }
      // sum_i CBd[i][j] dy[i][p]
      mma_gemm<64, 3, NP, true, true>(intra, r1, LD, PS, r2, LD, PS, kT);
      __syncthreads();
    }
    // column sums over the 4 row warps, in a fixed order
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float v = column_sum(dtcol[q][s]);
        if (lane < 4) red[wm * kT + F::col(q, s)] = v;
      }
    __syncthreads();
    if (threadIdx.x < kT) {
      const float ds = red[threadIdx.x] + red[kT + threadIdx.x] + red[2 * kT + threadIdx.x] +
                       red[3 * kT + threadIdx.x];
      const int gj = J * kT + threadIdx.x;
      if (gj < L) {
        scol[gj] += ds * sdt[gj];
        sddt[gj] += ds;
      }
    }
    // dx of the J tile
    T* dxr = dx + (row0 * d.H + h) * kP + J * kT * xs;
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int j = F::row(e);
      if (j >= rows_j) continue;
      const float t = sdt[J * kT + j];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        store2(dxr + j * xs + F::col(q, e), acc[q][e] + t * intra[q][e],
               acc[q][e + 1] + t * intra[q][e + 1]);
    }
    __syncthreads();
  }

  // the inter-chunk term: exp(cs_i) dy_i . (C_i h^T)
  for (int I = 0; I * kT < L; ++I) {
    const int rows_i = min(kT, L - I * kT);
    float acc[4][4];
    zero(acc);
    for (int k0 = 0; k0 < N; k0 += KC) {
      load_tile<NP, kT, KC>(r1, PS, Cm + (row0 + I * kT) * N + k0, N, rows_i, One{});
      load_tile<3, kP, KC>(r2, PS, hs + k0, N, kP, One{});
      __syncthreads();
      mma_gemm<64, NP, 3, false, false>(acc, r1, ld_of(KC), PS, r2, ld_of(KC), PS, KC);
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int i = F::row(e), gi = I * kT + i;
      float s = 0.f;
      if (i < rows_i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 dv = load2(dyr + (long long)gi * xs + F::col(q, e));
          s += dv.x * acc[q][e] + dv.y * acc[q][e + 1];
        }
      }
      s = quad_sum(s);
      if ((lane & 3) == 0 && i < rows_i) srow[wn * kMaxQ + gi] += expf(scs[gi]) * s;
    }
  }
  // exp(cs_last) <G, h> + sum_j w_j u_j, added at the last row
  float gh = 0.f;
  for (int e = threadIdx.x; e < kP * N; e += kThreads) gh += gs[e] * hs[e];
  const float tail = block_sum(gh * expf(last) + wu, red + 4 * kT);
  __syncthreads();
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads)
    srow[i] = i < L ? srow[i] + srow[kMaxQ + i] - scol[i] + su[i] + (i == L - 1 ? tail : 0.f)
                    : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) suffix_sums(srow, L);
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += kThreads) {
    ddA[(row0 + i) * d.H + h] = srow[i];
    ddt[(row0 + i) * d.H + h] = sddt[i];
  }
}

template <int N> __host__ __device__ constexpr int bc_width() { return N < 64 ? N : 64; }
template <int N> __host__ __device__ constexpr int bc_bwd_smem() {
  return 3 * kT * ld_of(64) + 3 * kT * ld_of(bc_width<N>());
}

// (b, c, R, n tile, which): 64 rows and WN columns of dC (which 0) or dB (1):
//   dC_rn = sum_{j <= r} dCB_rj B_jn + sum_h exp(cs_r) sum_p dy_rp h_pn
//   dB_rn = sum_{i >= r} dCB_ir C_in + sum_h w_r sum_p x_rp G_pn
// with dCB summed over the head groups as it is read, and each head's
// product scaled by its row factor after it.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bc_bwd(const T* __restrict__ dy, const T* __restrict__ x, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ dt, const float* __restrict__ cs,
           const float* __restrict__ dcb, const float* __restrict__ st,
           const float* __restrict__ g, T* __restrict__ dB, T* __restrict__ dC, Dims d,
           int groups) {
  constexpr int WN = bc_width<N>(), NT = N / WN, NP = parts<T>();
  constexpr int LDA = ld_of(64), PSA = kT * LDA, LDB = ld_of(WN), PSB = kT * LDB;
  using F = Frag<WN>;
  extern __shared__ __align__(16) bf16 smem[];
  bf16* sa = smem;            // dCB, 3 parts; dy or x rows [r][p]
  bf16* sb = smem + 3 * PSA;  // B or C rows [k][n]; h or G rows [p][n], 3 parts
  int blk = blockIdx.x;
  const int which = blk % 2;
  blk /= 2;
  const int nt_i = blk % NT;
  blk /= NT;
  const int R = blk % d.nt;
  blk /= d.nt;
  const int c = blk % d.nc, b = blk / d.nc, L = chunk_len(d, c);
  if (R * kT >= L) return;
  const int rows_r = min(kT, L - R * kT), n0 = nt_i * WN;
  const long long row0 = (long long)b * d.S + c * d.Q;
  const long long xs = (long long)d.H * kP;
  const long long QQ = (long long)d.ldq * d.ldq;
  const long long gstride = (long long)d.B * d.nc * QQ;
  const float* dcbc = dcb + (long long)(b * d.nc + c) * QQ;
  float acc[F::NT][4];
  zero(acc);
  // the intra-chunk part through dCB: tiles (R, K <= R) for dC, as A
  // [r][j]; tiles (K >= R, R) for dB, as A stored [i][r] (k-major)
  for (int K = which ? R : 0; which ? K * kT < L : K <= R; ++K) {
    const float* t = dcbc + (which ? (long long)K * kT * d.ldq + R * kT
                                   : (long long)R * kT * d.ldq + K * kT);
#pragma unroll
    for (int u = 0; u < kT * kT / 4 / kThreads; ++u) {
      const int idx = threadIdx.x + u * kThreads, r = idx % kT, cv = idx / kT;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int gg = 0; gg < groups; ++gg) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(
            t + gg * gstride + (long long)r * d.ldq + cv * 4));
        v[0] += w.x; v[1] += w.y; v[2] += w.z; v[3] += w.w;
      }
      store_parts<3>(sa + r * LDA + cv * 4, PSA, v);
    }
    load_tile<NP, kT, WN>(sb, PSB, (which ? Cm : Bm) + (row0 + K * kT) * N + n0, N,
                          L - K * kT, One{});
    __syncthreads();
    if (which)
      mma_gemm<WN, 3, NP, true, true>(acc, sa, LDA, PSA, sb, LDB, PSB, kT);
    else
      mma_gemm<WN, 3, NP, false, true>(acc, sa, LDA, PSA, sb, LDB, PSB, kT);
    __syncthreads();
  }
  // the sums over heads: dC through the state entering the chunk, dB
  // through the cotangent of the state leaving it
  const float* s = which ? g : st;
  const T* src = which ? x : dy;
  TileRegs<kT, kP, T> ta;
  TileRegs<kP, WN, float> tb;
  float fr[2], fn[2];  // this thread's two rows' factors: this head's, the next's
  auto fetch = [&](int h) {
    ta.fetch(src + ((row0 + R * kT) * d.H + h) * kP, xs, rows_r, One{});
    tb.fetch(s + ((long long)(b * d.nc + c) * d.H + h) * kP * N + n0, N, kP, One{});
    const float* csh = cs + row0 * d.H + h;
    const float last = csh[(long long)(L - 1) * d.H];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = F::row(2 * e);
      const long long o = (long long)(R * kT + r) * d.H;
      fn[e] = r >= rows_r ? 0.f : which ? expf(last - csh[o]) * dt[row0 * d.H + h + o]
                                        : expf(csh[o]);
    }
  };
  fetch(0);
  for (int h = 0; h < d.H; ++h) {
    ta.template store<NP>(sa, LDA, PSA);
    tb.template store<3>(sb, LDB, PSB);
    fr[0] = fn[0];
    fr[1] = fn[1];
    __syncthreads();
    if (h + 1 < d.H) fetch(h + 1);
    float ah[F::NT][4];
    zero(ah);
    mma_gemm<WN, NP, 3, false, true>(ah, sa, LDA, PSA, sb, LDB, PSB, kP);
#pragma unroll
    for (int j = 0; j < F::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += fr[e >> 1] * ah[j][e];
    __syncthreads();
  }
  T* out = (which ? dB : dC) + (row0 + R * kT) * N + n0;
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int i = F::row(e);
    if (i >= rows_r) continue;
#pragma unroll
    for (int j = 0; j < F::NT; ++j)
      store2(out + (long long)i * N + F::col(j, e), acc[j][e], acc[j][e + 1]);
  }
}

// ---------------------------------------------------------------- host ----
Dims make_dims(int B, int S, int H, int N, int Q) {
  const int nc = (S + Q - 1) / Q, nt = (Q + kT - 1) / kT;
  return Dims{B, S, H, N, Q, nc, nt, nt * kT};
}

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// Opts `kernel` into `bytes` of dynamic shared memory (above 48 KB it must
// ask; the setting is per function and device, so it is made at each call).
template <typename K>
cudaError_t smem_for(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

#define SSD_CHECK(call)                            \
  do {                                             \
    if (cudaError_t e_ = (call)) return static_cast<int>(e_); \
  } while (0)

template <typename T, int N>
int run_forward(const void* x, const void* Bm, const void* Cm, const float* dt, const float* dA,
                float* cs, float* cb, float* st, void* y, const Dims& d, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const long long pairs = (long long)d.B * d.nc * (d.nt * (d.nt + 1) / 2);
  constexpr int s1 = chunk_fwd_smem<T, N>() * 2, s3 = out_fwd_smem<T>() * 2;
  SSD_CHECK(smem_for(ssd_chunk_fwd<T, N>, s1));
  ssd_chunk_fwd<T, N><<<static_cast<unsigned>(pairs + (long long)d.B * d.nc * d.H), kThreads,
                        s1, s>>>(xt, bt, ct, dt, dA, cs, cb, st, d);
  SSD_CHECK(cudaGetLastError());
  ssd_state_pass<<<blocks_for((long long)d.B * d.H * kP * N), kThreads, 0, s>>>(st, cs, d, 0);
  SSD_CHECK(cudaGetLastError());
  SSD_CHECK(smem_for(ssd_out_fwd<T, N>, s3));
  ssd_out_fwd<T, N><<<static_cast<unsigned>((long long)d.B * d.nc * d.H * d.nt), kThreads, s3,
                      s>>>(xt, ct, dt, cs, cb, st, static_cast<T*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int run_backward(const void* dy, const void* x, const void* Bm, const void* Cm, const float* dt,
                 const float* cs, const float* st, float* cb, float* dcb, float* g, void* dx,
                 void* dB, void* dC, float* ddt, float* ddA, const Dims& d, int groups,
                 cudaStream_t s) {
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const long long pairs = (long long)d.B * d.nc * (d.nt * (d.nt + 1) / 2) * groups;
  constexpr int s1 = chunk_bwd_smem<T, N>() * 2, s4 = bc_bwd_smem<N>() * 2;
  constexpr int NT = N / bc_width<N>();
  SSD_CHECK(smem_for(ssd_chunk_bwd<T, N>, s1));
  ssd_chunk_bwd<T, N><<<static_cast<unsigned>(pairs + (long long)d.B * d.nc * d.H), kThreads,
                        s1, s>>>(dyt, xt, bt, ct, dt, cs, cb, dcb, g, d, groups);
  SSD_CHECK(cudaGetLastError());
  ssd_state_pass<<<blocks_for((long long)d.B * d.H * kP * N), kThreads, 0, s>>>(g, cs, d, 1);
  SSD_CHECK(cudaGetLastError());
  SSD_CHECK(smem_for(ssd_head_bwd<T, N>, kHeadSmemBytes));
  ssd_head_bwd<T, N><<<static_cast<unsigned>((long long)d.B * d.nc * d.H), kThreads,
                       kHeadSmemBytes, s>>>(dyt, xt, bt, ct, dt, cs, cb, st, g,
                                            static_cast<T*>(dx), ddt, ddA, d);
  SSD_CHECK(cudaGetLastError());
  SSD_CHECK(smem_for(ssd_bc_bwd<T, N>, s4));
  ssd_bc_bwd<T, N><<<static_cast<unsigned>((long long)d.B * d.nc * d.nt * NT * 2), kThreads, s4,
                     s>>>(dyt, xt, bt, ct, dt, cs, dcb, st, g, static_cast<T*>(dB),
                          static_cast<T*>(dC), d, groups);
  return static_cast<int>(cudaGetLastError());
}

// The state widths built: jamba-v0.1-52b's 16 and mamba2-780m's 128 (each
// width is a set of template instances, and the build's time grows with them).
bool valid(int B, int S, int H, int N, int Q) {
  return B > 0 && S > 0 && H > 0 && Q > 0 && Q <= kMaxQ && (N == 16 || N == 128);
}

}  // namespace

#define SSD_BY_N(MACRO, TYPE) \
  if (N == 16) return MACRO(TYPE, 16); \
  return MACRO(TYPE, 128);

// dtype: 0 f32, 1 bf16 (x, Bm, Cm, y). x [B, S, H, 64]; Bm, Cm [B, S, N];
// dt, dA [B, S, H] f32. Writes cs [B, S, H], st [B, nc, H, 64, N] (the
// state entering each chunk) and y; cb [B, nc, Qt, Qt] is scratch, Qt the
// chunk rounded up to whole 64-row tiles. Returns the cudaError_t of the
// first call that failed, 0 on success.
extern "C" int ssd_forward_launch(const void* x, const void* Bm, const void* Cm, const void* dt,
                                  const void* dA, void* cs, void* cb, void* st, void* y, int B,
                                  int S, int H, int N, int Q, int dtype, void* stream) {
  if (!valid(B, S, H, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(B, S, H, N, Q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* dAf = static_cast<const float*>(dA);
  float *csf = static_cast<float*>(cs), *cbf = static_cast<float*>(cb),
        *stf = static_cast<float*>(st);
#define SSD_FWD(TYPE, NN) run_forward<TYPE, NN>(x, Bm, Cm, dtf, dAf, csf, cbf, stf, y, d, s)
  if (dtype == 1) { SSD_BY_N(SSD_FWD, bf16) }
  SSD_BY_N(SSD_FWD, float)
#undef SSD_FWD
}

// The cotangents dx (dtype), dB, dC (dtype), ddt, ddA (f32) of
// ssd_forward_launch's inputs for dy, from its inputs, cs and st; cb
// [B, nc, Qt, Qt], dcb [groups, B, nc, Qt, Qt] and g [B, nc, H, 64, N] are
// scratch, f32.
extern "C" int ssd_backward_launch(const void* dy, const void* x, const void* Bm,
                                   const void* Cm, const void* dt, const void* cs,
                                   const void* st, void* cb, void* dcb, void* g, void* dx,
                                   void* dB, void* dC, void* ddt, void* ddA, int B, int S,
                                   int H, int N, int Q, int groups, int dtype, void* stream) {
  if (!valid(B, S, H, N, Q) || groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(B, S, H, N, Q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* csf = static_cast<const float*>(cs);
  const float* stf = static_cast<const float*>(st);
  float *cbf = static_cast<float*>(cb), *dcbf = static_cast<float*>(dcb),
        *gf = static_cast<float*>(g), *ddtf = static_cast<float*>(ddt),
        *ddAf = static_cast<float*>(ddA);
#define SSD_BWD(TYPE, NN)                                                                 \
  run_backward<TYPE, NN>(dy, x, Bm, Cm, dtf, csf, stf, cbf, dcbf, gf, dx, dB, dC, ddtf, ddAf, \
                         d, groups, s)
  if (dtype == 1) { SSD_BY_N(SSD_BWD, bf16) }
  SSD_BY_N(SSD_BWD, float)
#undef SSD_BWD
}

#undef SSD_BY_N

// Heads summed by one block of dCB: the wrapper sizes dcb's groups from it.
extern "C" int ssd_heads_per_group() { return kHeadsPerGroup; }

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
