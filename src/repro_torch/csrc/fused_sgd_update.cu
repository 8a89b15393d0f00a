// Fused momentum-SGD update over flat f32 buffers, for Hopper (sm_90a):
//   g'   = g + wd * p
//   mu'  = m * mu + g'
//   step = nesterov ? g' + m * mu' : mu'
//   p'   = p - lr * step
// p and mu are updated in place; g is read only.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_update.py:31
// `fused_sgd_update` (body `_kernel` at :19). The TPU kernel pads the buffer
// to whole 65536-element blocks and walks them on a sequential grid, with lr
// in SMEM; here one launch covers the whole buffer, any length, and masks
// its own tail, so nothing is padded or copied. lr, momentum, weight decay
// and nesterov are runtime arguments: an eq. 7 LR rescale rebuilds nothing.
//
// Bound on the H100: memory. Per element 3 reads (p, g, mu) and 2 writes
// (p, mu) of 4 bytes against 6-8 flops, far below the card's
// flops-per-byte balance. For ResNet-110 (n = 1,727,962) that is 34.6 MB,
// 10.3 us at 3.35 TB/s. The buffers fit in the 50 MB L2, so a kernel timed
// back to back on one buffer reads L2, not HBM: time it over copies.
//
// Design: a grid-stride loop in which each thread moves 16-byte float4
// vectors of p, g and mu (coalesced 512-byte warp transactions), with at
// most as many blocks as the SMs hold at once (8 x 256 threads each): every
// thread has three independent 16-byte loads in flight per iteration, and
// no block waits for a free SM. Views into a flat
// buffer start at any 4-byte offset: when p, g and mu share their offset
// modulo 16 bytes, the few elements before the first aligned address (the
// head) and after the last whole vector (the tail) go through a scalar
// path of the same loop; otherwise the whole range runs scalar. Each
// multiply and add is rounded on its own (__fmul_rn / __fadd_rn, no FMA
// contraction), in the order of the plain PyTorch version, so the kernel
// matches it bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Hyper {
  float lr, momentum, weight_decay;
};

template <bool NESTEROV>
__device__ __forceinline__ void sgd_one(float& p, float g, float& mu, const Hyper& h) {
  const float gd = __fadd_rn(g, __fmul_rn(h.weight_decay, p));
  const float mu_new = __fadd_rn(__fmul_rn(h.momentum, mu), gd);
  const float step = NESTEROV ? __fadd_rn(gd, __fmul_rn(h.momentum, mu_new)) : mu_new;
  p = __fsub_rn(p, __fmul_rn(h.lr, step));
  mu = mu_new;
}

// Elements [head, head + 4 * n_vec) are float4-aligned in all three
// buffers; [0, head) and [head + 4 * n_vec, n) are done one by one.
template <bool NESTEROV>
__global__ void __launch_bounds__(256)
fused_sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
                 float* __restrict__ mu, long long n, long long head,
                 long long n_vec, Hyper h) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;

  float4* p4 = reinterpret_cast<float4*>(p + head);
  const float4* g4 = reinterpret_cast<const float4*>(g + head);
  float4* mu4 = reinterpret_cast<float4*>(mu + head);
  for (long long i = tid; i < n_vec; i += stride) {
    float4 pv = p4[i];
    const float4 gv = __ldcs(g4 + i);  // read once: stream past the cache
    float4 mv = mu4[i];
    sgd_one<NESTEROV>(pv.x, gv.x, mv.x, h);
    sgd_one<NESTEROV>(pv.y, gv.y, mv.y, h);
    sgd_one<NESTEROV>(pv.z, gv.z, mv.z, h);
    sgd_one<NESTEROV>(pv.w, gv.w, mv.w, h);
    p4[i] = pv;
    mu4[i] = mv;
  }

  const long long tail0 = head + 4 * n_vec;
  const long long n_scalar = head + (n - tail0);
  for (long long i = tid; i < n_scalar; i += stride) {
    const long long j = i < head ? i : tail0 + (i - head);
    float pj = p[j], mj = mu[j];
    sgd_one<NESTEROV>(pj, g[j], mj, h);
    p[j] = pj;
    mu[j] = mj;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). n may be 0.
extern "C" int fused_sgd_update_launch(void* p, const void* g, void* mu, long long n,
                                       float lr, float momentum, float weight_decay,
                                       int nesterov, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(p);
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  const uintptr_t ma = reinterpret_cast<uintptr_t>(mu);
  if ((pa | ga | ma) % 4) return static_cast<int>(cudaErrorMisalignedAddress);

  long long head = n, n_vec = 0;  // all scalar unless the offsets agree
  if (pa % 16 == ga % 16 && pa % 16 == ma % 16) {
    head = static_cast<long long>((16 - pa % 16) % 16) / 4;
    if (head > n) head = n;
    n_vec = (n - head) / 4;
  }

  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  constexpr int kThreads = 256;
  const long long work = n_vec + (n - 4 * n_vec);  // vectors + scalars
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long max_blocks = 8LL * sms;  // 8 blocks of 256 fill an SM's 2048 threads
  if (blocks > max_blocks) blocks = max_blocks;

  const Hyper h{lr, momentum, weight_decay};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  const float* gf = static_cast<const float*>(g);
  float* mf = static_cast<float*>(mu);
  if (nesterov) {
    fused_sgd_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        pf, gf, mf, n, head, n_vec, h);
  } else {
    fused_sgd_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        pf, gf, mf, n, head, n_vec, h);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_sgd_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
