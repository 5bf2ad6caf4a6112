// Squared-distance tiles of query rows against per-row reference banks, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (fedmse_tpu_torch/ops/native.py).
//
// Replaces the TPU kernel fedmse_tpu/knn/score.py::_dist_kernel (launched by
// _dist_pallas, public entry dist_tiles). For every query row i against its
// own bank g = gw[i] (bank 0 when gw is null):
//   out[i, j] = max((|q_i|^2 - 2 q_i . b_{g,j}) + |b_{g,j}|^2, 0)
// q [T, L] is f32 or bf16 (upcast in registers, which is exact), banks
// [N, B, L] and out [T, B] are f32; gw is int32 [T]. The TPU kernel took one
// bank per call, so the JAX serving path encoded the routing in a one-hot
// [T, N*L] operand or gathered a bank per row; here the per-row bank index
// makes both the evaluator's client-major rows and a serving bucket's routed
// rows one launch. A row whose bank index lies outside [0, N) gets NaN in
// every column.
//
// The association is the JAX kernel's: (qn - 2 * cross) + bn, then the clamp
// at 0 (which keeps NaN, like jnp.maximum). qn, bn and cross are fixed-order
// fmaf sums over l from 0 to L-1, in every path below (bank in registers,
// loaded by the warp or by the thread, or streamed for wide latents), so a
// row's distances are the same bits whichever path and tile computes them:
// a served kNN score equals the evaluator's. 2 * cross is exact, so nvcc
// contracting qn - 2 * cross into one fma changes nothing. No tensor cores,
// TF32, fast math or atomics: results do not change from run to run, and
// the plain PyTorch twin (fedmse_tpu_torch/knn/score.py dist_tiles_plain)
// differs by summation order only.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
//   bytes: 4 T B written, 4 T L (2 T L in bf16) + 4 T read, 4 B L per
//   distinct bank read; operations: 2 L T B for the cross term.
// At L = 7 that is 14 FLOP per 4-byte output, under the card's ~20 FLOP/B
// f32 balance: the kernel is bound by the bytes of its output (the
// evaluation's 30,000 x 512 is 61 MB, 0.0187 ms). The tensor cores would buy
// nothing at this depth.
//
// Design.
//   - Plan (knn/score.py dist_plan, checked here): each thread owns groups
//     of 4 consecutive slots; one pass over a row takes `groups` groups (the
//     power of two covering ceil(B / 4), from one warp to the whole CTA of
//     256 threads, so 1,024 slots; wider banks take several passes), and a
//     CTA of 8 warps works on 256 / groups rows at a time. A launch is at
//     most 3 CTAs per SM (80 registers a thread: at 4, 64 registers spilled
//     and every shape ran slower), each given an equal contiguous run of
//     rows, so a bucket spreads over hundreds of CTAs and the evaluation is
//     one wave.
//   - Each warp takes its rows 32 at a time: lane t loads row t's bank
//     index and q and forms its |q|^2, and each row's values then come from
//     its lane by shuffles. So a batch's loads are all in flight at once,
//     before its first store, and no barrier stands between a launch and
//     its first bank load. (Measured on an H100: a CTA that staged q for
//     its rows spent ~1,700 cycles staging, as much as a bucket row's whole
//     bank load; a warp that loaded each row's q as it came waited ~1,600
//     cycles a row behind the evaluation's stream of stores.)
//   - Output: each thread writes its 4 distances as one 16-byte store (a
//     warp 512 contiguous bytes) where B % 4 == 0 and the pointers are
//     16-byte aligned, else 4 scalar stores. Stores carry the
//     evict-first hint (st.global.cs) when the plan says so: when the
//     output is larger than the L2, which nothing then reads back from it.
//   - Bank reuse: for L <= 8 each thread keeps its 4 slots' bank values and
//     |b|^2 in registers and reloads them only when its row's bank changes,
//     so the evaluator's client-major rows load a bank about once per CTA.
//   - Routed rows (a serving bucket) reload for almost every row. A warp's
//     bank data for one row is one contiguous run of 128 L floats (3.5 KB
//     at L = 7): the warp reads it as coalesced 16-byte loads into shared
//     memory and each lane takes its 4 L floats back out (a stride of 28
//     words at L = 7, free of bank conflicts), instead of each lane reading
//     its own 112 bytes, which spans 28 cache lines per load instruction.
//     Misaligned banks take per-thread scalar loads.
//   - L > 8 streams each row's bank values through the read-only path.
// Rows are indexed in 32 bits within a CTA's run, addresses in 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 3;   // dist_plan's CTAs per SM
constexpr int kCacheLatent = 8;   // latents up to this width keep the bank
constexpr int kMinGroups = 32;    // slot groups per pass: one warp ...
constexpr int kMaxGroups = 256;   // ... up to the whole CTA
constexpr int kMaxLatent = 128;
constexpr int kMaxDevices = 64;
constexpr long long kStreamBytes = 48LL << 20;  // dist_plan's STREAM_BYTES

std::atomic<int> g_sms[kMaxDevices];

struct Args {
  const void* q;
  const float* banks;
  const int32_t* gw;
  float* out;
  int per_cta, extra;  // rows = per_cta * CTAs + extra
  int n_banks, B, L;
  int groups;     // slot groups (4 slots each) per pass over a row
  int chunks;     // passes over a row
  int vec;        // 16-byte bank loads and output stores
  int streaming;  // evict-first output stores
};

// (qn - 2 cross) + bn, clamped at 0 in a way that keeps NaN, like
// jnp.maximum(d, 0)
__device__ __forceinline__ float clamp_dist(float qn, float cross, float bn) {
  const float d = (qn - 2.f * cross) + bn;
  return d < 0.f ? 0.f : d;
}

// One element of a query row as f32 (bf16 upcast, which is exact), through
// the read-only path: every lane of a warp reads the same row, so a load is
// one broadcast.
__device__ __forceinline__ float load_q(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_q(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// The thread's 4 slots' bank values (bv[c][l] of slot j + c) and |b|^2.
// The vector path is taken by the whole warp (its row, and so its bank, is
// the same on every lane): the warp's run of 128 slots is read as coalesced
// float4s into its shared `stage` and each lane takes its own 4 LC floats.
template <int LC>
__device__ __forceinline__ void load_bank(const Args& a, int g, int wg0,
                                          int lane, int valid, float4* stage,
                                          float (&bv)[4][LC],
                                          float (&bn)[4]) {
  const long long s0 = static_cast<long long>(g) * a.B + 4 * wg0;
  if (a.vec) {
    const int nv = min(128, a.B - 4 * wg0) * LC / 4;  // float4s in the run
    const float4* __restrict__ src =
        reinterpret_cast<const float4*>(a.banks + s0 * LC);
#pragma unroll
    for (int k = 0; k < LC; ++k) {
      const int v = lane + 32 * k;
      if (v < nv) stage[v] = __ldg(src + v);
    }
    __syncwarp();
    if (valid > 0) {
      float f[4 * LC];
#pragma unroll
      for (int k = 0; k < LC; ++k) {
        const float4 v = stage[lane * LC + k];
        f[4 * k] = v.x;
        f[4 * k + 1] = v.y;
        f[4 * k + 2] = v.z;
        f[4 * k + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int l = 0; l < LC; ++l) bv[c][l] = f[c * LC + l];
    }
    __syncwarp();
  } else {
    const float* __restrict__ b = a.banks + (s0 + 4 * lane) * LC;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int l = 0; l < LC; ++l)
        bv[c][l] = c < valid ? __ldg(b + c * LC + l) : 0.f;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < LC; ++l) s = fmaf(bv[c][l], bv[c][l], s);
    bn[c] = s;
  }
}

__device__ __forceinline__ void store4(const Args& a, float* dst,
                                       const float (&d)[4], int valid) {
  if (a.vec) {
    const float4 v = make_float4(d[0], d[1], d[2], d[3]);
    if (a.streaming)
      __stcs(reinterpret_cast<float4*>(dst), v);
    else
      *reinterpret_cast<float4*>(dst) = v;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= valid) break;
    if (a.streaming)
      __stcs(dst + c, d[c]);
    else
      dst[c] = d[c];
  }
}

// LC = L (1..8): the bank in registers; LC = 0: any L, streamed.
template <typename Q, int LC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    dist_tiles_kernel(const Args a) {
  // each warp's bank staging (L <= 8): 128 slots x LC floats
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* stage = smem4 + warp * 32 * LC;

  const int wpr = a.groups >> 5;  // warps per pass over a row
  const int row_step = kWarps / wpr;
  const int rl = warp / wpr;
  const int wgroup = (warp - rl * wpr) * 32;  // the warp's first group
  const int n_groups = (a.B + 3) >> 2;
  // the CTA's run of rows: per_cta, one more for the first `extra` CTAs
  const int b = blockIdx.x;
  const int n = a.per_cta + (b < a.extra ? 1 : 0);
  const long long begin =
      static_cast<long long>(b) * a.per_cta + (b < a.extra ? b : a.extra);
  const float nan = __int_as_float(0x7fc00000);
  const Q* __restrict__ q = static_cast<const Q*>(a.q) + begin * a.L;
  const int32_t* __restrict__ gw = a.gw != nullptr ? a.gw + begin : nullptr;
  float* __restrict__ out = a.out + begin * a.B;

  float bv[4][LC > 0 ? LC : 1];
  float bn[4];
  int cached = -1;  // the (bank, pass) whose values bv and bn hold

  // The warp walks its rows (every row_step-th of the run) 32 at a time:
  // lane t loads row t's bank index and q (L <= 8) and forms its |q|^2,
  // all before the batch's first store; each row then takes them from its
  // lane by shuffles.
  for (int r0 = rl; r0 < n; r0 += 32 * row_step) {
    const int rt = r0 + lane * row_step;
    int g_t = -1;
    float q_t[LC > 0 ? LC : 1];
    float qn_t = 0.f;
    if (rt < n) {
      const int g = gw != nullptr ? __ldg(gw + rt) : 0;
      g_t = (g >= 0 && g < a.n_banks) ? g : -1;
      const Q* qr = q + static_cast<long long>(rt) * a.L;
      if constexpr (LC > 0) {
#pragma unroll
        for (int l = 0; l < LC; ++l) q_t[l] = load_q(qr + l);
#pragma unroll
        for (int l = 0; l < LC; ++l) qn_t = fmaf(q_t[l], q_t[l], qn_t);
      } else {
        for (int l = 0; l < a.L; ++l) {
          const float v = load_q(qr + l);
          qn_t = fmaf(v, v, qn_t);
        }
      }
    }
    for (int k = 0; k < 32; ++k) {
      const int r = r0 + k * row_step;
      if (r >= n) break;
      const int g = __shfl_sync(0xffffffffu, g_t, k);
      const float qn = __shfl_sync(0xffffffffu, qn_t, k);
      float* orow = out + static_cast<long long>(r) * a.B;
      for (int ch = 0; ch < a.chunks; ++ch) {
        const int wg0 = ch * a.groups + wgroup;
        if (wg0 >= n_groups) continue;  // the whole warp is past the bank
        const int j = 4 * (wg0 + lane);
        const int valid = min(4, a.B - j);  // <= 0: this lane is past it
        float d[4] = {nan, nan, nan, nan};
        if (g >= 0) {
          // cross[c] and |b|^2 of slot j + c, each over l = 0 .. L-1
          float cross[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (LC > 0) {
            const int key = g * a.chunks + ch;
            if (key != cached) {
              load_bank<LC>(a, g, wg0, lane, valid, stage, bv, bn);
              cached = key;
            }
#pragma unroll
            for (int l = 0; l < LC; ++l) {
              const float ql = __shfl_sync(0xffffffffu, q_t[l], k);
#pragma unroll
              for (int c = 0; c < 4; ++c)
                cross[c] = fmaf(ql, bv[c][l], cross[c]);
            }
          } else {
            const Q* qr = q + static_cast<long long>(r) * a.L;
            const float* __restrict__ bk =
                a.banks + (static_cast<long long>(g) * a.B + j) * a.L;
#pragma unroll
            for (int c = 0; c < 4; ++c) bn[c] = 0.f;
            for (int l = 0; l < a.L; ++l) {
              const float ql = load_q(qr + l);
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (c < valid) {
                  const float v = __ldg(bk + c * a.L + l);
                  cross[c] = fmaf(ql, v, cross[c]);
                  bn[c] = fmaf(v, v, bn[c]);
                }
              }
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) d[c] = clamp_dist(qn, cross[c], bn[c]);
        }
        if (valid > 0) store4(a, orow + j, d, valid);
      }
    }
  }
}

template <typename Q, int LC>
cudaError_t launch_one(const Args& a, int ctas, size_t smem,
                       cudaStream_t st) {
  dist_tiles_kernel<Q, LC><<<ctas, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename Q>
cudaError_t launch(const Args& a, int ctas, cudaStream_t st) {
  const size_t stage = static_cast<size_t>(kWarps) * 128 * a.L * sizeof(float);
  switch (a.L <= kCacheLatent ? a.L : 0) {
    case 1: return launch_one<Q, 1>(a, ctas, stage, st);
    case 2: return launch_one<Q, 2>(a, ctas, stage, st);
    case 3: return launch_one<Q, 3>(a, ctas, stage, st);
    case 4: return launch_one<Q, 4>(a, ctas, stage, st);
    case 5: return launch_one<Q, 5>(a, ctas, stage, st);
    case 6: return launch_one<Q, 6>(a, ctas, stage, st);
    case 7: return launch_one<Q, 7>(a, ctas, stage, st);
    case 8: return launch_one<Q, 8>(a, ctas, stage, st);
    default: return launch_one<Q, 0>(a, ctas, 0, st);
  }
}

// dist_plan's slot groups per pass: the power of two covering ceil(B / 4),
// between one warp and the whole CTA
int plan_groups(int B) {
  const int n_groups = (B + 3) / 4;
  int groups = kMinGroups;
  while (groups < n_groups && groups < kMaxGroups) groups *= 2;
  return groups;
}

}  // namespace

extern "C" {

// Launches the distance tiles on `stream` of `device` as `ctas` CTAs of
// `groups` slot groups per pass; returns cudaGetLastError() after the launch
// (0 on success). q is bf16 when q_bf16 != 0, else f32; gw is int32 [rows]
// or null (bank 0 for every row). The plan (groups, ctas, streaming) must be
// the one knn/score.py dist_plan gives for (rows, B, L) on this device: the
// entry refuses any other with cudaErrorInvalidValue, before it touches a
// pointer. The caller guarantees contiguous q [rows, L], banks
// [n_banks, B, L] and out [rows, B].
int dist_tiles(const void* q, const void* banks, const void* gw, void* out,
               long long rows, int n_banks, int B, int L, int q_bf16,
               int groups, int ctas, int streaming, int device,
               void* stream) {
  if (rows < 1 || n_banks < 1 || B < 1 || L < 1 || L > kMaxLatent ||
      (q_bf16 & ~1) != 0 || (streaming & ~1) != 0 || device < 0 ||
      device >= kMaxDevices || groups != plan_groups(B) || ctas < 1 ||
      streaming != (4LL * rows * B > kStreamBytes ? 1 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  int rc = 0;
  int sms = g_sms[device].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      g_sms[device].store(sms, std::memory_order_relaxed);
    else
      rc = static_cast<int>(err);
  }
  if (rc == 0) {
    const long long row_step = kWarps / (groups / 32);
    long long want = (rows + row_step - 1) / row_step;
    if (want > static_cast<long long>(kBlocksPerSM) * sms)
      want = static_cast<long long>(kBlocksPerSM) * sms;
    // a CTA's run of rows is indexed in 32 bits
    if (ctas != want || rows / ctas >= (1LL << 30))
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc == 0) {
    Args a;
    a.q = q;
    a.banks = static_cast<const float*>(banks);
    a.gw = static_cast<const int32_t*>(gw);
    a.out = static_cast<float*>(out);
    a.per_cta = static_cast<int>(rows / ctas);
    a.extra = static_cast<int>(rows % ctas);
    a.n_banks = n_banks;
    a.B = B;
    a.L = L;
    a.groups = groups;
    a.chunks = ((B + 3) / 4 + groups - 1) / groups;
    a.vec = B % 4 == 0 && (reinterpret_cast<uintptr_t>(banks) & 15) == 0 &&
            (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    a.streaming = streaming;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    rc = static_cast<int>(q_bf16 ? launch<__nv_bfloat16>(a, ctas, st)
                                 : launch<float>(a, ctas, st));
  }
  if (current != device) cudaSetDevice(current);
  return rc;
}

const char* dist_tiles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
