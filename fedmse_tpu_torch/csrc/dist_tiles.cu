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
#include <climits>

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
// the read-only path (in dist_tiles_kernel every lane of a warp reads the
// same row, so a load is one broadcast).
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

// ---------------------------------------------------------------------------
// The kNN score in one pass (knn_score): for every query row i, its
// distances to the slots of its own bank g = gw[i] as above, the count mask
// (slot >= count -> +inf), the bin minima (approximate top-k; exact top-k is
// one slot a bin), the k-th smallest candidate, sqrt. Only the [T] score is
// written: no [T, B] tile, mask copy, bin array or torch.topk. It replaces
// the composition dist_tiles -> _mask_padding -> _smallest_k ->
// _kth_of_smallest of knn/score.py (the JAX package's Pallas distance
// kernel followed by its XLA top-k), and gives the same bits:
//   - each distance is the fmaf chain of dist_tiles_kernel (clamp_dist,
//     load_q, qn / bn / cross over l = 0 .. L-1 from 0);
//   - slot s lies in bin s % bins; a bin keeps its minimum, NaN winning (as
//     amin); the candidates (bins, or slots when exact) are padded with
//     +inf up to k (as _pad_inf), and the one at rank min(count, k) - 1,
//     NaN ranking above +inf (as torch.topk(largest=False)), is the k-th;
//   - sqrt of it; 0 for an empty bank; NaN for a bank index outside [0, N).
// Distances are >= +0 (never -0), +inf or NaN, so their bit patterns as
// unsigned integers order them as torch.topk does, NaN above +inf: the
// selection runs on those keys and returns the selected value's own bits.
//
// Bound on an H100 SXM: compute. 2 L T B FLOP for the cross term (14 a row
// and slot at L = 7) with nothing streamed out; bytes 4 T L (2 T L in bf16)
// of q, 4 T of bank index and score, 4 B L a distinct bank. At the hybrid
// evaluation's 1.5M rows x 512 slots x 500 banks that is 10.75 GFLOP, 0.16
// ms at 67 TFLOP/s, against 0.02 ms of bytes.
//
// Design (knn/score.py knn_plan, checked here).
//   - A warp walks its own contiguous run of rows 32 at a time (lane t
//     loads row t's bank index, count and q); CTAs of 4 warps, one wave,
//     at least one row a warp, so a serving bucket spreads over hundreds of
//     warps. Each batch takes one of two paths.
//   - The lane path, for a batch of 16 rows or more in ONE bank (the
//     evaluation's client-major rows): one LANE per row, so the selection
//     needs no exchange between lanes. The warp stages the bank once in its
//     shared memory as [B][LP] floats (the L values, zeros up to 7 or 8,
//     and |b|^2: LP = 8, or 12 at L = 8) and every lane reads the same slot
//     at the same time, a broadcast, 16 bytes at a time: one load of a slot
//     serves 32 rows. The stage is reloaded only when the batch's bank
//     changes. A lane walks
//     its row's bank bin by bin, keeps each bin's minimum in a register and
//     inserts it into a sorted list of the KP smallest keys (KP = 8 or 32
//     >= k) in registers, 4 bins' loads and fmaf chains at a time and no
//     branch between them. The k-th is the list's entry at rank
//     min(count, k) - 1.
//   - The warp path, for every other batch (routed rows of a serving
//     bucket, a batch across a bank boundary, a short run, L > 8): the
//     whole warp on one row at a time, lane l on bins l, l + 32, ..., so a
//     load instruction reads 32 neighbouring slots; each lane keeps the KP
//     smallest of its bins, and the warp pops the k-th off the lanes'
//     sorted lists (a warp minimum a rank). |b|^2 is formed on the way, the
//     same fmaf chain; L > 8 streams q and the bank, as dist_tiles does.
// No atomics, no tensor cores, no fast math: a row's score is the same bits
// whichever path and batch computes it.

constexpr int kScoreWarps = 4;         // knn_plan's warps per CTA
constexpr int kScoreBlocksPerSM = 4;   // at most 16 warps an SM
constexpr int kMaxK = 32;
constexpr int kStageWarpBytes = 32 << 10;  // knn_plan's STAGE_WARP_BYTES
constexpr int kStageSMBytes = 192 << 10;   // knn_plan's STAGE_SM_BYTES
constexpr int kLaneRows = 16;  // a batch takes the lane path from 16 rows
constexpr unsigned kInfKey = 0x7f800000u;  // +inf
constexpr unsigned kAbsentKey = 0xffffffffu;  // above every distance's key

struct ScoreArgs {
  const void* q;
  const float* banks;
  const int32_t* gw;
  const void* counts;  // null: count_value for every row
  int counts_i64, count_per_bank, count_value;
  float* out;
  int per_warp, extra;  // rows = per_warp * warps + extra
  int n_banks, B, L, k, bins, pads;
  int q_bf16;           // q is bf16, else f32
  int stage;            // warp-uniform batches stage their bank
};

// The latent width a kernel holds in registers: L <= 7 as 7 and L = 8 as
// 8, the values past L zero (so 6 kernels build, not 36); 0: streamed. A
// zero term adds fmaf(0, 0, x) = x to each chain (x is never -0: every
// chain starts at +0), so the chains keep dist_tiles_kernel's bits.
constexpr int latent_regs(int L) { return L <= 7 ? 7 : (L == 8 ? 8 : 0); }

// the floats a staged slot takes: its LC values, |b|^2, padded to float4s
template <int LC>
struct StageFloats {
  static constexpr int value = (LC + 4) & ~3;
};

// element i of q as f32 (bf16 upcast, which is exact)
__device__ __forceinline__ float q_at(const ScoreArgs& a, long long i) {
  return a.q_bf16 ? load_q(static_cast<const __nv_bfloat16*>(a.q) + i)
                  : load_q(static_cast<const float*>(a.q) + i);
}

// min of two keys with NaN winning, as amin
__device__ __forceinline__ unsigned nan_min(unsigned a, unsigned b) {
  const unsigned hi = max(a, b), lo = min(a, b);
  return hi > kInfKey ? hi : lo;
}

// key into the ascending list of the KP smallest (the largest drops out)
template <int KP>
__device__ __forceinline__ void insert(unsigned (&list)[KP], unsigned key) {
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    const unsigned lo = min(list[i], key);
    key = max(list[i], key);
    list[i] = lo;
  }
}

// one slot's key: its distance's bits, +inf past the count
template <int LC, bool STAGED>
__device__ __forceinline__ unsigned slot_key(
    const ScoreArgs& a, const float4* stage, const float* bank, int s,
    const float (&q)[LC > 0 ? LC : 1], float qn, int cnt) {
  float cross = 0.f, bn = 0.f;
  if constexpr (STAGED) {
    constexpr int LP = StageFloats<LC>::value;
    float b[LP];
#pragma unroll
    for (int v = 0; v < LP / 4; ++v) {
      const float4 x = stage[s * (LP / 4) + v];
      b[4 * v] = x.x;
      b[4 * v + 1] = x.y;
      b[4 * v + 2] = x.z;
      b[4 * v + 3] = x.w;
    }
#pragma unroll
    for (int l = 0; l < LC; ++l) cross = fmaf(q[l], b[l], cross);
    bn = b[LC];
  } else {
    const float* __restrict__ bk = bank + static_cast<long long>(s) * a.L;
#pragma unroll
    for (int l = 0; l < LC; ++l) {
      const float v = l < a.L ? __ldg(bk + l) : 0.f;
      cross = fmaf(q[l], v, cross);
      bn = fmaf(v, v, bn);
    }
  }
  const float d = clamp_dist(qn, cross, bn);
  return s < cnt ? __float_as_uint(d) : kInfKey;
}

// L > 8: q (row elements from q0 on) and the bank streamed per slot
__device__ __forceinline__ unsigned slot_key_streamed(
    const ScoreArgs& a, long long q0, const float* bank, int s, float qn,
    int cnt) {
  const float* __restrict__ bk = bank + static_cast<long long>(s) * a.L;
  float cross = 0.f, bn = 0.f;
  for (int l = 0; l < a.L; ++l) {
    const float ql = q_at(a, q0 + l);
    const float v = __ldg(bk + l);
    cross = fmaf(ql, v, cross);
    bn = fmaf(v, v, bn);
  }
  const float d = clamp_dist(qn, cross, bn);
  return s < cnt ? __float_as_uint(d) : kInfKey;
}

// The minima of the U bins bin0 + u * stride (u < U) of a row, bin b
// holding slots b, b + bins, b + 2 bins, ...: key(s) is slot s's key, a bin
// at or past `bins` gives kAbsentKey. The U bins' loads and fmaf chains are
// independent, for the scheduler to overlap.
template <int U, typename KeyOf>
__device__ __forceinline__ void bin_minima(unsigned (&m)[U], int bin0,
                                           int stride, int bins, int per_bin,
                                           KeyOf key) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int b = bin0 + u * stride;
    m[u] = b < bins ? key(b) : kAbsentKey;
  }
  for (int t = 1; t < per_bin; ++t) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = bin0 + u * stride;
      if (b < bins) m[u] = nan_min(m[u], key(b + t * bins));
    }
  }
}

constexpr int kBinsAtOnce = 4;

// The lane path: every lane its own row, the warp's bank staged. The KP
// smallest candidates of the lane's row, ascending: its bins' minima and
// the +inf pads.
template <int LC, int KP>
__device__ __forceinline__ void select_lane_row(
    const ScoreArgs& a, const float4* stage, const float (&q)[LC], float qn,
    int cnt, unsigned (&list)[KP]) {
#pragma unroll
  for (int i = 0; i < KP; ++i) list[i] = kAbsentKey;
  const int per_bin = a.B / a.bins;
  const auto key = [&](int s) {
    return slot_key<LC, true>(a, stage, nullptr, s, q, qn, cnt);
  };
  for (int j = 0; j < a.bins; j += kBinsAtOnce) {
    unsigned m[kBinsAtOnce];
    bin_minima<kBinsAtOnce>(m, j, 1, a.bins, per_bin, key);
#pragma unroll
    for (int u = 0; u < kBinsAtOnce; ++u) insert<KP>(list, m[u]);
  }
  for (int p = 0; p < a.pads; ++p) insert<KP>(list, kInfKey);
}

// The warp path: the whole warp on one row, lane l on bins l, l + 32, ...
// (each bin's slots its own), then the candidate at `rank` of the union of
// the lanes' sorted lists, popped off their heads in rank order. The
// score's bits, as the lane path's.
template <int LC, int KP>
__device__ __forceinline__ unsigned select_warp_row(
    const ScoreArgs& a, const float* bank, long long q0,
    const float (&q)[LC > 0 ? LC : 1], float qn, int cnt, int rank,
    int lane) {
  unsigned list[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i) list[i] = kAbsentKey;
  const int per_bin = a.B / a.bins;
  const auto key = [&](int s) {
    if constexpr (LC > 0)
      return slot_key<LC, false>(a, nullptr, bank, s, q, qn, cnt);
    else
      return slot_key_streamed(a, q0, bank, s, qn, cnt);
  };
  for (int b0 = 0; b0 < a.bins; b0 += 32 * kBinsAtOnce) {
    unsigned m[kBinsAtOnce];  // a lane past the last bin adds nothing
    bin_minima<kBinsAtOnce>(m, b0 + lane, 32, a.bins, per_bin, key);
#pragma unroll
    for (int u = 0; u < kBinsAtOnce; ++u) insert<KP>(list, m[u]);
  }
  if (lane == 0)
    for (int p = 0; p < a.pads; ++p) insert<KP>(list, kInfKey);
  unsigned key_at = kAbsentKey;
  for (int i = 0; i <= rank; ++i) {
    key_at = __reduce_min_sync(0xffffffffu, list[0]);
    const unsigned holders = __ballot_sync(0xffffffffu, list[0] == key_at);
    if (lane == __ffs(holders) - 1) {  // one holder pops its head
#pragma unroll
      for (int x = 0; x + 1 < KP; ++x) list[x] = list[x + 1];
      list[KP - 1] = kAbsentKey;
    }
  }
  return key_at;
}

// the score of a selected candidate, as _kth_of_smallest: sqrt, or 0 for
// an empty bank
__device__ __forceinline__ float score_of(unsigned key, int cnt) {
  return cnt > 0 ? sqrtf(__uint_as_float(key)) : 0.f;
}

template <int LC, int KP>
__global__ void __launch_bounds__(kScoreWarps * 32, kScoreBlocksPerSM)
    knn_score_kernel(const ScoreArgs a) {
  extern __shared__ float4 stages[];  // each warp's staged bank
  constexpr int LP = StageFloats<LC>::value;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* stage = stages + static_cast<size_t>(warp) * a.B * (LP / 4);
  // the warp's run of rows: per_warp, one more for the first `extra` warps
  const int w = blockIdx.x * kScoreWarps + warp;
  const int n = a.per_warp + (w < a.extra ? 1 : 0);
  const long long begin =
      static_cast<long long>(w) * a.per_warp + (w < a.extra ? w : a.extra);
  const long long q0 = begin * a.L;  // the run's first element of q
  const int32_t* __restrict__ gw = a.gw != nullptr ? a.gw + begin : nullptr;
  float* __restrict__ out = a.out + begin;
  const float nan = __int_as_float(0x7fc00000);
  int staged = -1;  // the bank the warp's stage holds

  // The warp takes its rows 32 at a time: lane t loads row t's bank index,
  // count and q and forms its |q|^2.
  for (int r0 = 0; r0 < n; r0 += 32) {
    const int r = r0 + lane;
    const int rows = min(32, n - r0);
    const bool active = lane < rows;
    int g = -1, cnt = 0;
    float qv[LC > 0 ? LC : 1] = {};
    float qn = 0.f;
    const long long qr = q0 + static_cast<long long>(active ? r : 0) * a.L;
    if (active) {
      const int gi = gw != nullptr ? __ldg(gw + r) : 0;
      if (gi >= 0 && gi < a.n_banks) g = gi;
    }
    if (g >= 0) {
      if (a.counts == nullptr) {
        cnt = a.count_value;
      } else {
        const int ci = a.count_per_bank ? g : 0;
        cnt = a.counts_i64
                  ? static_cast<int>(max(min(
                        __ldg(static_cast<const long long*>(a.counts) + ci),
                        static_cast<long long>(INT_MAX)),
                        static_cast<long long>(INT_MIN)))
                  : __ldg(static_cast<const int32_t*>(a.counts) + ci);
      }
    }
    if constexpr (LC > 0) {
#pragma unroll
      for (int l = 0; l < LC; ++l)
        qv[l] = active && l < a.L ? q_at(a, qr + l) : 0.f;
#pragma unroll
      for (int l = 0; l < LC; ++l) qn = fmaf(qv[l], qv[l], qn);
    } else {
      if (active)
        for (int l = 0; l < a.L; ++l) {
          const float v = q_at(a, qr + l);
          qn = fmaf(v, v, qn);
        }
    }
    if constexpr (LC > 0) {
      // a batch of enough rows in one bank: the lane path
      const int lo = __reduce_min_sync(0xffffffffu, g >= 0 ? g : INT_MAX);
      const int hi = __reduce_max_sync(0xffffffffu, g);
      if (a.stage && lo == hi && rows >= kLaneRows) {
        if (staged != lo) {
          __syncwarp();  // every lane is done with the old stage
          // the bank's B L floats read in order (coalesced), then each
          // slot's zeros up to LC and its |b|^2
          const float* src = a.banks + static_cast<long long>(lo) * a.B * a.L;
          float* st = reinterpret_cast<float*>(stage);
          for (int e = lane; e < a.B * a.L; e += 32) {
            const int s = e / a.L;
            st[s * LP + e - s * a.L] = __ldg(src + e);
          }
          __syncwarp();
          for (int s = lane; s < a.B; s += 32) {
            float bn = 0.f;
#pragma unroll
            for (int l = 0; l < LC; ++l) {
              if (l >= a.L) st[s * LP + l] = 0.f;
              bn = fmaf(st[s * LP + l], st[s * LP + l], bn);
            }
            st[s * LP + LC] = bn;
          }
          __syncwarp();
          staged = lo;
        }
        unsigned list[KP];
        select_lane_row<LC, KP>(a, stage, qv, qn, cnt, list);
        if (active) {
          // the candidate at rank min(count, k) - 1, as _kth_of_smallest
          const int rank = max(min(cnt, a.k) - 1, 0);
          unsigned key = list[0];
#pragma unroll
          for (int i = 1; i < KP; ++i)
            if (i == rank) key = list[i];
          out[r] = g < 0 ? nan : score_of(key, cnt);
        }
        continue;
      }
    }
    // else the warp path, row by row
    for (int j = 0; j < rows; ++j) {
      const int gj = __shfl_sync(0xffffffffu, g, j);
      const int cj = __shfl_sync(0xffffffffu, cnt, j);
      if (gj < 0) {
        if (lane == 0) out[r0 + j] = nan;
        continue;
      }
      float qj[LC > 0 ? LC : 1];
#pragma unroll
      for (int l = 0; l < (LC > 0 ? LC : 1); ++l)
        qj[l] = __shfl_sync(0xffffffffu, qv[l], j);
      const float qnj = __shfl_sync(0xffffffffu, qn, j);
      const float* bank = a.banks + static_cast<long long>(gj) * a.B * a.L;
      const int rank = max(min(cj, a.k) - 1, 0);
      const unsigned key = select_warp_row<LC, KP>(
          a, bank, q0 + static_cast<long long>(r0 + j) * a.L, qj, qnj, cj,
          rank, lane);
      if (lane == 0) out[r0 + j] = score_of(key, cj);
    }
  }
}

template <int LC, int KP>
cudaError_t score_one(const ScoreArgs& a, int ctas, cudaStream_t st) {
  const size_t smem =
      a.stage ? static_cast<size_t>(kScoreWarps) * a.B *
                    StageFloats<LC>::value * sizeof(float)
              : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_score_kernel<LC, KP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  knn_score_kernel<LC, KP><<<ctas, kScoreWarps * 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <int KP>
cudaError_t score_launch(const ScoreArgs& a, int ctas, cudaStream_t st) {
  switch (latent_regs(a.L)) {
    case 7: return score_one<7, KP>(a, ctas, st);
    case 8: return score_one<8, KP>(a, ctas, st);
    default: return score_one<0, KP>(a, ctas, st);
  }
}

// knn_plan's stage rule: a warp's [B][LP] stage for L <= 8, up to
// kStageWarpBytes; 0 when the bank is not staged
long long stage_warp_bytes(int B, int L) {
  if (latent_regs(L) == 0) return 0;
  const long long bytes = 4LL * B *
      (latent_regs(L) == 7 ? StageFloats<7>::value : StageFloats<8>::value);
  return bytes <= kStageWarpBytes ? bytes : 0;
}

// Runs launch(sms) with `device` current, its SM count read once and
// kept, then makes the caller's device current again; returns the first
// error (0 on success).
template <typename Launch>
int on_device(int device, Launch launch) {
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
  if (rc == 0) rc = launch(sms);
  if (current != device) cudaSetDevice(current);
  return rc;
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
  return on_device(device, [&](int sms) {
    const long long row_step = kWarps / (groups / 32);
    long long want = (rows + row_step - 1) / row_step;
    if (want > static_cast<long long>(kBlocksPerSM) * sms)
      want = static_cast<long long>(kBlocksPerSM) * sms;
    // a CTA's run of rows is indexed in 32 bits
    if (ctas != want || rows / ctas >= (1LL << 30))
      return static_cast<int>(cudaErrorInvalidValue);
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
    return static_cast<int>(q_bf16 ? launch<__nv_bfloat16>(a, ctas, st)
                                   : launch<float>(a, ctas, st));
  });
}

// Launches the kNN score on `stream` of `device` as `ctas` CTAs of 4 warps:
// out[i] = the k-th neighbour distance of row i in bank gw[i] (bank 0 when
// gw is null) over `bins` strided bins (bins == B: exact), as knn_score's
// header says. counts: null (count_value for every row), or int32 (int64
// when counts_i64) read at the row's bank (count_per_bank) or at 0. The
// plan (ctas, stage) must be the one knn/score.py knn_plan gives for
// (rows, B, L, k) on this device, and 1 <= k <= 32, bins a divisor of B:
// the entry refuses anything else with cudaErrorInvalidValue, before it
// touches a pointer. The caller guarantees contiguous q [rows, L], banks
// [n_banks, B, L] and out [rows].
int knn_score(const void* q, const void* banks, const void* gw,
              const void* counts, int counts_i64, int count_per_bank,
              int count_value, void* out, long long rows, int n_banks,
              int B, int L, int q_bf16, int k, int bins, int ctas,
              int stage, int device, void* stream) {
  const long long stage_bytes = stage_warp_bytes(B, L);
  if (rows < 1 || n_banks < 1 || B < 1 || L < 1 || L > kMaxLatent ||
      (q_bf16 & ~1) != 0 || (counts_i64 & ~1) != 0 ||
      (count_per_bank & ~1) != 0 || k < 1 || k > kMaxK || bins < 1 ||
      bins > B || B % bins != 0 || (stage & ~1) != 0 ||
      stage != (stage_bytes > 0 ? 1 : 0) || device < 0 ||
      device >= kMaxDevices || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&](int sms) {
    long long per_sm = kScoreBlocksPerSM;
    if (stage) {
      per_sm = kStageSMBytes / (kScoreWarps * stage_bytes);
      if (per_sm > kScoreBlocksPerSM) per_sm = kScoreBlocksPerSM;
      if (per_sm < 1) per_sm = 1;
    }
    long long want = (rows + kScoreWarps - 1) / kScoreWarps;
    if (want > per_sm * sms) want = per_sm * sms;
    // a warp's run of rows is indexed in 32 bits
    if (ctas != want || rows / (static_cast<long long>(ctas) * kScoreWarps)
                            >= (1LL << 30))
      return static_cast<int>(cudaErrorInvalidValue);
    ScoreArgs a;
    a.q = q;
    a.banks = static_cast<const float*>(banks);
    a.gw = static_cast<const int32_t*>(gw);
    a.counts = counts;
    a.counts_i64 = counts_i64;
    a.count_per_bank = count_per_bank;
    a.count_value = count_value;
    a.out = static_cast<float*>(out);
    const long long warps = static_cast<long long>(ctas) * kScoreWarps;
    a.per_warp = static_cast<int>(rows / warps);
    a.extra = static_cast<int>(rows % warps);
    a.n_banks = n_banks;
    a.B = B;
    a.L = L;
    a.k = k;
    a.bins = bins;
    a.pads = k > bins ? k - bins : 0;
    a.q_bf16 = q_bf16;
    a.stage = stage;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(k <= 8 ? score_launch<8>(a, ctas, st)
                                   : score_launch<kMaxK>(a, ctas, st));
  });
}

const char* dist_tiles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
