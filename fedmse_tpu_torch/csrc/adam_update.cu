// The update of one local-training step for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (fedmse_tpu_torch/ops/native.py).
//
// Replaces no Pallas kernel: on the TPU, optax's Adam update, the FedProx
// term and the loss sum of fedmse_tpu/federation/local_training.py were
// XLA's fusion of plain array code. In eager PyTorch they were some 30
// kernels a step (ops/adam_update.adam_update_plain, which this kernel
// reproduces bit for bit). For every row s (a cohort client) and parameter j
// of an [S, P] f32 buffer, with step = has[s] & active[s]:
//   under FedProx (prev given), at the pre-update p:
//     d = p - prev;  g = g + mu (2 d);  the row's loss gains mu sum_j d^2
//   loss_sum[s] += has[s] ? loss[s] : 0                    (loss_sum given)
//   where step:  optax's Adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)
//     m = (1 - b1) g + b1 m        v = (1 - b2) g^2 + b2 v
//     count += 1 (int32, saturating)
//     p = p + (-lr) (m / (1 - b1^count))
//             / (sqrt(v / (1 - b2^count) + 0) + eps)
// Every operation is rounded where torch's op sequence rounds it: explicit
// _rn intrinsics (no FMA contraction), powf for the bias corrections, and
// each constant the f32 value of optim.py's double expression, as torch
// casts a Python scalar. A row that does not step is neither read nor
// written in p, m, v or count (its grads may be NaN: an all-masked batch).
// Only the FedProx loss sum is taken in another order than torch's.
//
// Bound on an H100 SXM (3.35 TB/s): p, g, m and v read (and prev under
// FedProx), p, m and v written: 7 (8) x S x P x 4 bytes, plus 16 bytes a
// row; ~3 FLOP a byte, far below the ridge. At S = 250, P = 6,764: 47.3 MB
// (54.1 MB), 14.1 us (16.2 us). At S = 5 the same is 0.3 us: a launch's
// latency, not its bytes, bounds the step there.
//
// Design. One thread-block cluster of C CTAs per row, C = min(8, ceil(P /
// 1024)) from P alone (7 at P = 6,764, so S = 5 still runs 35 CTAs); CTA c
// owns the chunk [c K, (c + 1) K) of the row, K = ceil(P / C) rounded up to
// 4, in groups of 4 elements (16-byte loads and stores where P % 4 == 0 and
// the buffers are aligned, four scalar ones otherwise: the same groups).
// Thread t takes groups t, t + 256, ... of its chunk. The row's count is
// read by every CTA and written by rank 0 alone: each CTA arrives on the
// cluster barrier once it has read it, and rank 0 writes after the wait;
// the other CTAs never wait and leave when done. Under FedProx each thread
// sums d^2 over its groups in order, a fixed xor shuffle tree joins a
// warp, thread 0 the 8 warps in order, and each CTA stores its partial
// into rank 0's shared memory (DSMEM) once that barrier shows rank 0
// running; after a second barrier phase, which only rank 0 waits for, it
// sums the C partials in rank order. The order is
// fixed by P alone, never by S, the grid or the launch: a row gets the same
// bits alone and inside any cohort. No atomics, no scratch in device memory.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCtas = 16;  // the cluster's CTAs a launch may ask for

// optim.py's constants as torch casts its Python scalars: the double
// expression rounded to f32
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kB1 = static_cast<float>(0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kB2 = static_cast<float>(0.999);
constexpr float kEps = static_cast<float>(1e-8);
constexpr float kEpsRoot = static_cast<float>(0.0);

struct Args {
  float* p;
  float* mu;
  float* nu;
  int* count;
  const float* grads;
  const float* prev;       // FedProx anchors, or null
  const float* loss;       // [S], or null
  float* loss_sum;         // [S], or null
  const unsigned char* has;  // [S] bool, stride has_stride
  long long has_stride;
  const unsigned char* active;  // [S] bool, stride active_stride, or null
  long long active_stride;
  int P;
  int ctas;   // C: CTAs a row, the cluster
  int chunk;  // K: elements a CTA
  float neg_lr;
  float prox_mu;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Store v at the address of `p` in the shared memory of cluster rank 0.
__device__ __forceinline__ void store_at_rank0(float* p, float v) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
               : "=r"(remote)
               : "r"(local));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

// FedProx on one element at the pre-update p: d^2 into acc, and the
// gradient g + mu (2 d).
__device__ __forceinline__ float prox(float g, float p, float prev, float mu,
                                      float& acc) {
  const float d = __fsub_rn(p, prev);
  acc = __fadd_rn(acc, __fmul_rn(d, d));
  return __fadd_rn(g, __fmul_rn(mu, __fmul_rn(2.f, d)));
}

// Adam on one element: m, v and p in place.
__device__ __forceinline__ void adam(float g, float& p, float& m, float& v,
                                     float bc1, float bc2, float neg_lr) {
  m = __fadd_rn(__fmul_rn(kOneMinusB1, g), __fmul_rn(kB1, m));
  v = __fadd_rn(__fmul_rn(kOneMinusB2, __fmul_rn(g, g)), __fmul_rn(kB2, v));
  const float den =
      __fadd_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(v, bc2), kEpsRoot)), kEps);
  p = __fadd_rn(p, __fmul_rn(neg_lr, __fdiv_rn(__fdiv_rn(m, bc1), den)));
}

template <bool kProx>
__device__ __forceinline__ void one(const Args& a, size_t i, bool step,
                                    float bc1, float bc2, float& acc) {
  if (!step) {  // the FedProx loss sum alone
    if (kProx) prox(0.f, a.p[i], __ldg(a.prev + i), a.prox_mu, acc);
    return;
  }
  float p = a.p[i];
  float g = __ldg(a.grads + i);
  if (kProx) g = prox(g, p, __ldg(a.prev + i), a.prox_mu, acc);
  float m = a.mu[i], v = a.nu[i];
  adam(g, p, m, v, bc1, bc2, a.neg_lr);
  a.p[i] = p;
  a.mu[i] = m;
  a.nu[i] = v;
}

template <bool kProx>
__device__ __forceinline__ void four(const Args& a, size_t i, bool step,
                                     float bc1, float bc2, float& acc) {
  if (!step && !kProx) return;
  float4 p = *reinterpret_cast<const float4*>(a.p + i);
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kProx) r = __ldg(reinterpret_cast<const float4*>(a.prev + i));
  if (!step) {  // the FedProx loss sum alone
    prox(0.f, p.x, r.x, a.prox_mu, acc);
    prox(0.f, p.y, r.y, a.prox_mu, acc);
    prox(0.f, p.z, r.z, a.prox_mu, acc);
    prox(0.f, p.w, r.w, a.prox_mu, acc);
    return;
  }
  float4 g = __ldg(reinterpret_cast<const float4*>(a.grads + i));
  float4 m = *reinterpret_cast<const float4*>(a.mu + i);
  float4 v = *reinterpret_cast<const float4*>(a.nu + i);
  if (kProx) {
    g.x = prox(g.x, p.x, r.x, a.prox_mu, acc);
    g.y = prox(g.y, p.y, r.y, a.prox_mu, acc);
    g.z = prox(g.z, p.z, r.z, a.prox_mu, acc);
    g.w = prox(g.w, p.w, r.w, a.prox_mu, acc);
  }
  adam(g.x, p.x, m.x, v.x, bc1, bc2, a.neg_lr);
  adam(g.y, p.y, m.y, v.y, bc1, bc2, a.neg_lr);
  adam(g.z, p.z, m.z, v.z, bc1, bc2, a.neg_lr);
  adam(g.w, p.w, m.w, v.w, bc1, bc2, a.neg_lr);
  *reinterpret_cast<float4*>(a.p + i) = p;
  *reinterpret_cast<float4*>(a.mu + i) = m;
  *reinterpret_cast<float4*>(a.nu + i) = v;
}

// kProx: prev is given (and so is loss_sum); kVec: P % 4 == 0 and every
// [S, P] buffer is 16-byte aligned.
template <bool kProx, bool kVec>
__global__ void __launch_bounds__(kThreads)
    adam_update_kernel(const Args a) {
  __shared__ float warp_part[kWarps];
  __shared__ float rank_part[kMaxCtas];
  const int s = blockIdx.x / a.ctas, c = blockIdx.x % a.ctas;
  const bool has = a.has[s * a.has_stride] != 0;
  const bool step =
      has && (a.active == nullptr || a.active[s * a.active_stride] != 0);
  const bool lead = c == 0 && threadIdx.x == 0;
  // uniform over the cluster, which is one row: its CTAs leave together
  if (!step && !(kProx && has)) {
    if (lead && a.loss_sum != nullptr)
      a.loss_sum[s] = __fadd_rn(a.loss_sum[s], has ? a.loss[s] : 0.f);
    return;
  }
  int count = 0;
  float bc1 = 1.f, bc2 = 1.f;
  if (step) {
    const int was = a.count[s];
    count = was < INT_MAX ? was + 1 : was;
    const float cf = static_cast<float>(count);
    bc1 = __fsub_rn(1.f, powf(kB1, cf));
    bc2 = __fsub_rn(1.f, powf(kB2, cf));
  }
  cluster_arrive();  // this CTA has read count: rank 0 may write it

  const size_t row = static_cast<size_t>(s) * a.P;
  const int lo = c * a.chunk;
  const int hi = min(lo + a.chunk, a.P);
  float acc = 0.f;
  for (int i = lo + 4 * static_cast<int>(threadIdx.x); i < hi;
       i += 4 * kThreads) {
    if (kVec) {
      four<kProx>(a, row + i, step, bc1, bc2, acc);
    } else {
      const int end = min(i + 4, hi);
      for (int j = i; j < end; ++j)
        one<kProx>(a, row + j, step, bc1, bc2, acc);
    }
  }

  if (kProx) {
    for (int o = 16; o > 0; o >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = acc;
    __syncthreads();
    cluster_wait();  // rank 0 has started: its shared memory takes partials
    if (threadIdx.x == 0) {
      float t = warp_part[0];
      for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, warp_part[w]);
      store_at_rank0(&rank_part[c], t);
    }
    cluster_arrive();  // this CTA's partial is stored
  }
  // the other ranks leave; rank 0 waits until each has arrived (or left):
  // every count read and, under FedProx, every partial stored
  if (c != 0) return;
  cluster_wait();
  if (!lead) return;
  if (a.loss_sum != nullptr) {
    float loss = a.loss[s];
    if (kProx) {
      float t = rank_part[0];
      for (int r = 1; r < a.ctas; ++r) t = __fadd_rn(t, rank_part[r]);
      loss = __fadd_rn(loss, __fmul_rn(a.prox_mu, t));
    }
    a.loss_sum[s] = __fadd_rn(a.loss_sum[s], has ? loss : 0.f);
  }
  if (step) a.count[s] = count;
}

template <bool kProx, bool kVec>
int launch(const Args& a, int S, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(S * a.ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, adam_update_kernel<kProx, kVec>, a);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <bool kProx>
int launch_vec(const Args& a, int S, int vec, cudaStream_t stream) {
  return vec ? launch<kProx, true>(a, S, stream)
             : launch<kProx, false>(a, S, stream);
}

}  // namespace

extern "C" {

// Launches the step's update on `stream` of `device` as S clusters of
// `ctas` CTAs (1 <= ctas <= 16; more than 8 is refused by the launch
// unless the card allows it), in place on p, mu, nu [S, P] f32 and count
// [S] int32 (see the header). grads [S, P] f32; prev [S, P] f32 or null
// (no FedProx); loss [S] f32 and loss_sum [S] f32, both or neither, and
// both where prev is given; has
// and active [S] bool with the given element strides (active may be null:
// every row active). vec != 0 takes 16-byte accesses (P % 4 == 0 and every
// [S, P] buffer 16-byte aligned). Returns cudaGetLastError() after the
// launch (0 on success). The caller guarantees S, P > 0.
int adam_update(void* p, void* mu, void* nu, void* count, const void* grads,
                const void* prev, const void* loss, void* loss_sum,
                const void* has, long long has_stride, const void* active,
                long long active_stride, int S, int P, int ctas,
                float neg_lr, float prox_mu, int vec, int device,
                void* stream) {
  if (ctas < 1 || ctas > kMaxCtas || S < 1 || P < 1 ||
      static_cast<long long>(S) * ctas > INT_MAX ||
      (loss == nullptr) != (loss_sum == nullptr) ||
      (prev != nullptr && loss_sum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  Args a;
  a.p = static_cast<float*>(p);
  a.mu = static_cast<float*>(mu);
  a.nu = static_cast<float*>(nu);
  a.count = static_cast<int*>(count);
  a.grads = static_cast<const float*>(grads);
  a.prev = static_cast<const float*>(prev);
  a.loss = static_cast<const float*>(loss);
  a.loss_sum = static_cast<float*>(loss_sum);
  a.has = static_cast<const unsigned char*>(has);
  a.has_stride = has_stride;
  a.active = static_cast<const unsigned char*>(active);
  a.active_stride = active_stride;
  a.P = P;
  a.ctas = ctas;
  a.chunk = ((P + ctas - 1) / ctas + 3) / 4 * 4;
  a.neg_lr = neg_lr;
  a.prox_mu = prox_mu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = prev == nullptr ? launch_vec<false>(a, S, vec, s)
                                 : launch_vec<true>(a, S, vec, s);
  if (current != device) cudaSetDevice(current);
  return rc;
}

const char* adam_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
