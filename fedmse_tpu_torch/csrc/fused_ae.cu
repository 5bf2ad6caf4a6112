// Fused autoencoder forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (fedmse_tpu_torch/ops/native.py).
//
// Replaces the TPU kernel fedmse_tpu/ops/pallas_ae.py:130 _kernel (launched
// by _fused_pallas, public entry fused_forward_stats). Per row:
//   h1 = cast(relu(x W1 + b1))      z  = h1 W2 + b2
//   h2 = cast(relu(cast(z) W3 + b3))  recon = h2 W4 + b4
// and three outputs: the latent z [R, L], the reconstruction MSE
// sum_j (x_j - recon_j)^2 / D [R] and the latent norm sqrt(sum_k z_k^2) [R].
// cast() rounds to bf16 in bf16 mode and is the identity in f32 mode, exactly
// where _kernel calls .astype(cdt); every dot accumulates in f32; z, recon,
// the error and all outputs stay f32; biases are f32. Each row carries its own
// model index, so one launch scores rows of many per-gateway models (the
// evaluator's [N, T] rows, the serving engine's routed buckets). A row whose
// model index lies outside [0, n_models) gets NaN in all three outputs.
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 989 TFLOP/s
// bf16 on them, 3.35 TB/s): 2 (DH + HL + LH + HD) = 13,176 FLOP per row at
// 115/27/7, and per row 4D (f32) or 2D (bf16) bytes of x, 4 of model index
// and 4 (L + 2) of outputs, plus each model used read once (26 KB in f32).
//   - f32 evaluation (70,080 rows, 10 models): 0.92 GFLOP against 35 MB, so
//     bound by operations (0.0138 ms): FFMA throughput is what counts.
//   - bf16 evaluation: the tensor cores make the FLOPs ~nothing; bound by
//     bytes (0.0057 ms).
//   - routed serving buckets (256 rows over 10 models, 1024 rows over 512):
//     bound by bytes, mostly the weights of the models the bucket touches
//     (0.00012 / 0.0043 ms); in practice by the latency of each row's
//     chain of weight loads.
//
// Design. The launch walks tiles of `tile` rows (8, 16, 32 or 64, planned by
// the wrapper from R alone, ops/fused_ae.tile_plan; the entry takes no other
// size); each CTA of 256 threads takes a contiguous run of tiles, so
// consecutive tiles mostly share a model. Per tile the CTA reads the tile's model indices, finds its
// runs of rows of one model, and picks a path itself (the wrapper reads no
// device data):
//   - Uniform path (at most 4 runs, averaging 16 rows or more: every launch
//     outside serving lays rows out client-major, so a tile is one run, or
//     two across a client boundary). x arrives by cp.async as it lies in
//     memory, into two buffers in turn: the next tile's copy is in flight
//     while this one computes. Each run's model has its four weight
//     matrices and biases staged in shared memory (cp.async in f32; in bf16
//     through registers, transposed for the tensor cores), and only when the
//     model changes, so a CTA stages a model once for all the tiles of its
//     run. In f32 each layer is a register-tiled product from shared memory
//     on FFMA: every thread owns blocks of 4 rows x 4 outputs, 16
//     independent accumulators, one weight float4 per k (layer 1 reads x
//     row-major; the activations are kept transposed, one float4 per k).
//     In bf16 each warp owns 16 rows and runs all four layers on mma.sync
//     m16n8k16 (bf16 operands, f32 accumulation: a bf16 x bf16 product is
//     exact in f32, so the recipe is unchanged), K and N zero-padded to the
//     instruction's multiples (K 115 -> 128, 27 -> 32, 7 -> 16; N 27 -> 32,
//     7 -> 16, 115 -> 120); an accumulator fragment of one layer becomes,
//     rounded to bf16, the A fragment of the next in registers, so the
//     activations never touch shared memory.
//   - Mixed path (rows of many models, or bad indices: a routed serving
//     bucket). One warp per row; each row fetches its own model's weights
//     through the read-only path, the k loops unrolled so that many loads
//     are in flight; a layer's outputs are spread over the lanes, up to four
//     per lane. Each dot is one fmaf chain in k order, as in a uniform f32
//     block, and the row sums follow the uniform f32 order too, so a row's
//     f32 outputs are the same bits on either path: a served score equals
//     the evaluator's (the chains cost latency only; the loads dominate).
//     The wrapper picks small tiles for small R, so a 256-row bucket runs
//     on 32 CTAs, not 4.
// The row MSE and ||z|| are reduced in a fixed order: 4 lanes per row, each
// over every 4th feature, joined by a fixed xor tree (f32 uniform and mixed
// tiles), or over the quad of lanes that hold a row's fragments (bf16
// uniform). Index walks take their divisions once,
// when a walk starts (Walk); loops of the bf16 path are templated on the
// padded depths, with the paper's 115/27/7 instantiated. No atomics, no
// TF32, no --use_fast_math (the division by D and the sqrt stay IEEE): two
// calls on the same inputs give the same bits. Shared memory above 48 KB is
// allowed, and the carveout set to all shared, once per kernel instance and
// device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 64;  // ops/fused_ae.py MAX_TILE
constexpr int kMaxDevices = 64;
constexpr int kMaxRuns = 4;    // model runs in a tile the uniform path takes
constexpr int kMinRun = 16;    // ... when its runs average this many rows
constexpr int kInstances = 3;  // f32; bf16 at the paper's depths; bf16 any

std::atomic<int> g_optin[kMaxDevices];
std::atomic<int> g_attr_set[kInstances][kMaxDevices];

// Widths, paddings and the shared-memory carve-up of one launch (host-made).
struct Dims {
  int D, H, L, tile, uniform;
  int D4, H4, L4, P;       // f32 uniform: padded columns, activation stride
  int Dk, Hk, Lk, Dn;      // bf16 uniform: padded depths and widths
  int scratch;             // floats of one warp's mixed-path scratch
  int xbuf;                // bytes of one of the two x buffers (uniform)
  // byte offsets into dynamic shared memory
  int o_ms, o_scr, o_w1, o_w2, o_w3, o_w4, o_b1, o_b2, o_b3, o_b4, o_x, o_h,
      o_z;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Round an f32 activation to the compute type and back (identity for f32).
__device__ __forceinline__ float to_compute(float v, const float*) { return v; }
__device__ __forceinline__ float to_compute(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// max(v, 0) that keeps NaN, like jnp.maximum and torch.relu.
__device__ __forceinline__ float relu(float v) {
  return (v > 0.f || v != v) ? v : 0.f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most the N most recent groups of this thread's copies are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A flat index p = a X + b that starts at `base` and moves by `stride`,
// split without a division per step (two divisions when made).
struct Walk {
  int a, b, da, db, X;
  __device__ __forceinline__ Walk(int base, int stride, int x) : X(x) {
    a = base / x;
    b = base - a * x;
    da = stride / x;
    db = stride - da * x;
  }
  __device__ __forceinline__ void next() {
    a += da;
    b += db;
    if (b >= X) {
      b -= X;
      ++a;
    }
  }
};

// ---------------------------- mixed tiles ---------------------------------

// One dense layer of one row on one warp: out_c = sum_k in(k) w[k N + c] +
// b[c] for c < N. Lane l owns outputs l, l + 32, ..., up to four in one pass
// over k; each output's dot is one fmaf chain in k order, exactly as a
// uniform tile's f32 block computes it, so a row's f32 outputs do not
// depend on which kind of tile it lands in. The k loop is unrolled so that
// many weight loads are in flight at once (the layer is bound by their
// latency, not by the chains). epi(c, value) runs on the owning lane.
template <typename T, typename In, typename Epi>
__device__ __forceinline__ void warp_layer(In in, const T* __restrict__ w,
                                           const float* __restrict__ b, int K,
                                           int N, Epi epi) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int c0 = lane; c0 < N; c0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float v = in(k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + 32 * j < N)
          acc[j] = fmaf(v, load(w + k * N + c0 + 32 * j), acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + 32 * j < N) epi(c0 + 32 * j, acc[j] + __ldg(b + c0 + 32 * j));
  }
}

// Rows of several models: one warp per row, weights through the read-only
// path at the row's own model; the row's x, h and z in the warp's scratch.
template <typename T>
__device__ void mixed_tile(const Dims& s, const T* __restrict__ x,
                           const int* ms, const T* __restrict__ w1,
                           const float* __restrict__ b1,
                           const T* __restrict__ w2,
                           const float* __restrict__ b2,
                           const T* __restrict__ w3,
                           const float* __restrict__ b3,
                           const T* __restrict__ w4,
                           const float* __restrict__ b4,
                           float* __restrict__ latent, float* __restrict__ mse,
                           float* __restrict__ znorm, int n, int64_t row0,
                           float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = s.D, H = s.H, L = s.L;
  float* xw = scratch + warp * s.scratch;
  float* hw = xw + ((D + 3) & ~3);
  float* zw = hw + ((H + 3) & ~3);
  const T* tag = nullptr;  // selects the to_compute overload
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll 1
  for (int r = warp; r < n; r += kWarps) {
    const int m = ms[r];
    const int64_t row = row0 + r;
    if (m < 0) {
      for (int c = lane; c < L; c += 32) latent[row * L + c] = nan;
      if (lane == 0) {
        mse[row] = nan;
        znorm[row] = nan;
      }
      continue;
    }
    const T* xr = x + row * D;
    for (int k = lane; k < D; k += 32) xw[k] = load(xr + k);
    __syncwarp();
    // h1 = cast(relu(x W1 + b1))
    warp_layer(
        [&](int k) { return xw[k]; }, w1 + static_cast<int64_t>(m) * D * H,
        b1 + static_cast<int64_t>(m) * H, D, H,
        [&](int c, float v) { hw[c] = to_compute(relu(v), tag); });
    __syncwarp();
    // z = h1 W2 + b2
    warp_layer(
        [&](int k) { return hw[k]; }, w2 + static_cast<int64_t>(m) * H * L,
        b2 + static_cast<int64_t>(m) * L, H, L, [&](int c, float v) {
          zw[c] = v;
          latent[row * L + c] = v;
        });
    __syncwarp();
    // h2 = cast(relu(cast(z) W3 + b3)), over h1
    warp_layer(
        [&](int k) { return to_compute(zw[k], tag); },
        w3 + static_cast<int64_t>(m) * L * H, b3 + static_cast<int64_t>(m) * H,
        L, H,
        [&](int c, float v) { hw[c] = to_compute(relu(v), tag); });
    __syncwarp();
    // recon = h2 W4 + b4; the squared error over x, then summed as a
    // uniform f32 tile sums it (4 lanes, every 4th feature, a fixed tree)
    warp_layer(
        [&](int k) { return hw[k]; }, w4 + static_cast<int64_t>(m) * H * D,
        b4 + static_cast<int64_t>(m) * D, H, D, [&](int c, float v) {
          const float d = xw[c] - v;
          xw[c] = d * d;
        });
    __syncwarp();
    float e = 0.f, q = 0.f;
    if (lane < 4) {
      for (int j = lane; j < D; j += 4) e += xw[j];
      for (int j = lane; j < L; j += 4) q = fmaf(zw[j], zw[j], q);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      e += __shfl_xor_sync(0xffffffffu, e, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) {
      mse[row] = e / static_cast<float>(D);
      znorm[row] = sqrtf(q);
    }
    __syncwarp();  // the next row overwrites the scratch
  }
}

// ------------------------- uniform tiles: staging -------------------------

// dst[k][c] = c < N ? src[k N + c] : 0 for k < K, c < ld (cp.async, 4 B).
__device__ __forceinline__ void stage_f32(float* dst, int ld,
                                          const float* __restrict__ src, int K,
                                          int N) {
  const int total = K * ld;
  if (static_cast<int>(threadIdx.x) >= total) return;
  Walk wk(threadIdx.x, kThreads, ld);
#pragma unroll 1
  for (int p = threadIdx.x; p < total; p += kThreads, wk.next()) {
    if (wk.b < N)
      cp_async4(dst + p, src + wk.a * N + wk.b);
    else
      dst[p] = 0.f;
  }
}

// `bytes` of the tile's x (rows of D values, contiguous) to shared memory
// as they lie: cp.async 16 B at a time, the tail 4 then 2 B; element by
// element (`esize` bytes) where either address is not 16-byte aligned.
__device__ __forceinline__ void stage_flat(void* dst, const void* src,
                                           int bytes, int esize) {
  char* d = static_cast<char*>(dst);
  const char* g = static_cast<const char*>(src);
  if (((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(g)) &
       15) != 0) {
    for (int i = esize * threadIdx.x; i < bytes; i += esize * kThreads) {
      if (esize == 4)
        *reinterpret_cast<float*>(d + i) =
            __ldg(reinterpret_cast<const float*>(g + i));
      else
        *reinterpret_cast<unsigned short*>(d + i) =
            __ldg(reinterpret_cast<const unsigned short*>(g + i));
    }
    return;
  }
  const int body = bytes & ~15, body4 = bytes & ~3;
  for (int i = 16 * threadIdx.x; i < body; i += 16 * kThreads)
    cp_async16(d + i, g + i);
  for (int i = body + 4 * threadIdx.x; i < body4; i += 4 * kThreads)
    cp_async4(d + i, g + i);
  if (body4 < bytes && threadIdx.x == 0)
    *reinterpret_cast<unsigned short*>(d + body4) =
        __ldg(reinterpret_cast<const unsigned short*>(g + body4));
}

// ------------------------- uniform tiles, f32 ----------------------------

// For r in [lo, hi) and c < N: sum_k A(r, k) w[k ldw + c], handed to
// epi(r0, c, v, full) four rows at a time: v[i] belongs to row r0 + i, and
// `full` says all four lie in [lo, hi) (else epi writes only those that
// do). Each thread owns blocks of 4 rows (aligned: from lo & ~3) x 4
// columns, 16 independent accumulators. A is either row-major (kRows:
// A(r, k) = a[r lda + k], the staged x; consecutive threads take
// consecutive column blocks, so a warp's loads of a are a few rows,
// broadcast) or transposed (A(r, k) = a[k lda + r], the activations: one
// float4 per k; consecutive threads take consecutive row groups, so a
// warp's loads of a are one contiguous span and its float4 stores of a
// result column are contiguous too). The weight row is one float4 per k.
// Rows of a block outside [lo, hi) are computed from whatever the buffer
// holds there and never written. w holds zeros up to a multiple of 4
// columns.
template <bool kRows, typename Epi>
__device__ __forceinline__ void tile_matmul(const float* a, int lda,
                                            const float* w, int ldw, int lo,
                                            int hi, int N, int K, Epi epi) {
  const int g0 = lo >> 2, rg = ((hi + 3) >> 2) - g0, cb = (N + 3) >> 2;
  const int blocks = rg * cb;
  if (static_cast<int>(threadIdx.x) >= blocks) return;
  Walk wk(threadIdx.x, kThreads, kRows ? cb : rg);
#pragma unroll 1
  for (int p = threadIdx.x; p < blocks; p += kThreads, wk.next()) {
    const int r0 = (g0 + (kRows ? wk.a : wk.b)) * 4;
    const int c0 = (kRows ? wk.b : wk.a) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const float* ap = kRows ? a + r0 * lda : a + r0;
    const float* wp = w + c0;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[4];
      if (kRows) {
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ap[i * lda + k];
      } else {
        const float4 q = *reinterpret_cast<const float4*>(ap + k * lda);
        av[0] = q.x;
        av[1] = q.y;
        av[2] = q.z;
        av[3] = q.w;
      }
      const float4 b = *reinterpret_cast<const float4*>(wp + k * ldw);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    const bool full = r0 >= lo && r0 + 4 <= hi;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < N) {
        float v[4] = {acc[0][j], acc[1][j], acc[2][j], acc[3][j]};
        epi(r0, c0 + j, v, full);
      }
  }
}

// Store four rows' values of one column of a transposed buffer: one float4
// when all four rows are in [lo, hi), else each row that is.
__device__ __forceinline__ void put4(float* col, int r0, const float (&v)[4],
                                     bool full, int lo, int hi) {
  if (full) {
    *reinterpret_cast<float4*>(col + r0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (r0 + i >= lo && r0 + i < hi) col[r0 + i] = v[i];
}

struct F32Smem {
  float *w1, *w2, *w3, *w4, *b1, *b2, *b3, *b4, *x, *h, *z;
  __device__ F32Smem(const Dims& s, unsigned char* base)
      : w1(reinterpret_cast<float*>(base + s.o_w1)),
        w2(reinterpret_cast<float*>(base + s.o_w2)),
        w3(reinterpret_cast<float*>(base + s.o_w3)),
        w4(reinterpret_cast<float*>(base + s.o_w4)),
        b1(reinterpret_cast<float*>(base + s.o_b1)),
        b2(reinterpret_cast<float*>(base + s.o_b2)),
        b3(reinterpret_cast<float*>(base + s.o_b3)),
        b4(reinterpret_cast<float*>(base + s.o_b4)),
        x(reinterpret_cast<float*>(base + s.o_x)),
        h(reinterpret_cast<float*>(base + s.o_h)),
        z(reinterpret_cast<float*>(base + s.o_z)) {}
};

__device__ void stage_model(const Dims& s, const F32Smem& sm, int m,
                            const float* w1, const float* b1, const float* w2,
                            const float* b2, const float* w3, const float* b3,
                            const float* w4, const float* b4) {
  const int D = s.D, H = s.H, L = s.L;
  stage_f32(sm.w1, s.H4, w1 + static_cast<int64_t>(m) * D * H, D, H);
  stage_f32(sm.w2, s.L4, w2 + static_cast<int64_t>(m) * H * L, H, L);
  stage_f32(sm.w3, s.H4, w3 + static_cast<int64_t>(m) * L * H, L, H);
  stage_f32(sm.w4, s.D4, w4 + static_cast<int64_t>(m) * H * D, H, D);
  stage_f32(sm.b1, s.H4, b1 + static_cast<int64_t>(m) * H, 1, H);
  stage_f32(sm.b2, s.L4, b2 + static_cast<int64_t>(m) * L, 1, L);
  stage_f32(sm.b3, s.H4, b3 + static_cast<int64_t>(m) * H, 1, H);
  stage_f32(sm.b4, s.D4, b4 + static_cast<int64_t>(m) * D, 1, D);
}

// Rows [first, first + n) of the tile (one run of the staged model), f32,
// on FFMA; x is staged row-major, the activations are kept transposed.
__device__ void uniform_tile_f32(const Dims& s, const F32Smem& sm, int first,
                                 int n, int64_t row0,
                                 float* __restrict__ latent,
                                 float* __restrict__ mse,
                                 float* __restrict__ znorm) {
  const int D = s.D, H = s.H, L = s.L, P = s.P;
  const int lo = first, hi = first + n;
  float* xs = sm.x;
  float* hT = sm.h;
  float* zT = sm.z;
  const float* b1 = sm.b1;
  const float* b2 = sm.b2;
  const float* b3 = sm.b3;
  const float* b4 = sm.b4;
  // h1 = relu(x W1 + b1)
  tile_matmul<true>(xs, D, sm.w1, s.H4, lo, hi, H, D,
              [&](int r0, int c, float (&v)[4], bool full) {
                const float b = b1[c];
#pragma unroll
                for (int i = 0; i < 4; ++i) v[i] = relu(v[i] + b);
                put4(hT + c * P, r0, v, full, lo, hi);
              });
  __syncthreads();
  // z = h1 W2 + b2, written out as the latent
  tile_matmul<false>(hT, P, sm.w2, s.L4, lo, hi, L, H,
              [&](int r0, int c, float (&v)[4], bool full) {
                const float b = b2[c];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  v[i] += b;
                  if (r0 + i >= lo && r0 + i < hi)
                    latent[(row0 + r0 + i) * L + c] = v[i];
                }
                put4(zT + c * P, r0, v, full, lo, hi);
              });
  __syncthreads();
  // h2 = relu(z W3 + b3), over h1
  tile_matmul<false>(zT, P, sm.w3, s.H4, lo, hi, H, L,
              [&](int r0, int c, float (&v)[4], bool full) {
                const float b = b3[c];
#pragma unroll
                for (int i = 0; i < 4; ++i) v[i] = relu(v[i] + b);
                put4(hT + c * P, r0, v, full, lo, hi);
              });
  __syncthreads();
  // recon = h2 W4 + b4; the squared error replaces x in place (each element
  // is read and written by the one thread that owns it)
  tile_matmul<false>(hT, P, sm.w4, s.D4, lo, hi, D, H,
                     [&](int r0, int c, float (&v)[4], bool) {
                       const float b = b4[c];
#pragma unroll
                       for (int i = 0; i < 4; ++i)
                         if (r0 + i >= lo && r0 + i < hi) {
                           float* e = xs + (r0 + i) * D + c;
                           const float d = *e - (v[i] + b);
                           *e = d * d;
                         }
                     });
  __syncthreads();
  // row sums: 4 lanes per row, each over every 4th feature, then a fixed
  // xor tree over the 4
  const int lane = threadIdx.x & 31, sub = lane & 3;
#pragma unroll 1
  for (int base = (threadIdx.x >> 5) * 8; base < n; base += kWarps * 8) {
    const int i = base + (lane >> 2), r = first + i;
    float e = 0.f, q = 0.f;
    if (i < n) {
      for (int j = sub; j < D; j += 4) e += xs[r * D + j];
      for (int j = sub; j < L; j += 4) q = fmaf(zT[j * P + r], zT[j * P + r], q);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      e += __shfl_xor_sync(0xffffffffu, e, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (i < n && sub == 0) {
      mse[row0 + r] = e / static_cast<float>(D);
      znorm[row0 + r] = sqrtf(q);
    }
  }
}

// ------------------------- uniform tiles, bf16 ---------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two f32 values rounded to bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += A B for one 16 x 8 x 16 step: a[0..3] the A fragment (rows g and
// g + 8, columns 2t and 2t + 8 of the k-step), b0 / b1 the B fragment (rows
// 2t and 2t + 8 of column g), with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dst[j][k] = (j < N && k < K) ? src[k N + j] : 0 for j < rows, k < ld (ld
// even): a [K, N] weight matrix transposed, zero-padded, for B fragments;
// two values per 32-bit store, a thread's loads issued before its stores.
__device__ __forceinline__ void stage_t(bf16* dst, int ld, int rows,
                                        const bf16* __restrict__ src, int K,
                                        int N) {
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  const int half = ld >> 1, total = rows * half;
  constexpr int kBatch = 4;
  if (static_cast<int>(threadIdx.x) >= total) return;
  Walk wk(threadIdx.x, kThreads, half);
#pragma unroll 1
  for (int p0 = threadIdx.x; p0 < total; p0 += kBatch * kThreads) {
    uint32_t lo[kBatch], hi[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = wk.a, k = 2 * wk.b;
      const bool live = p0 + u * kThreads < total;
      lo[u] = live && j < N && k < K ? __ldg(s16 + k * N + j) : 0u;
      hi[u] = live && j < N && k + 1 < K ? __ldg(s16 + (k + 1) * N + j) : 0u;
      at[u] = live ? j * ld + k : -1;
      wk.next();
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (at[u] >= 0)
        *reinterpret_cast<uint32_t*>(dst + at[u]) = lo[u] | (hi[u] << 16);
  }
}

__device__ __forceinline__ void stage_bias(float* dst, int len,
                                           const float* __restrict__ src,
                                           int n) {
  for (int i = threadIdx.x; i < len; i += kThreads)
    dst[i] = i < n ? __ldg(src + i) : 0.f;
}

struct Bf16Smem {
  bf16 *w1, *w2, *w3, *w4, *x;
  float *b1, *b2, *b3, *b4;
  __device__ Bf16Smem(const Dims& s, unsigned char* base)
      : w1(reinterpret_cast<bf16*>(base + s.o_w1)),
        w2(reinterpret_cast<bf16*>(base + s.o_w2)),
        w3(reinterpret_cast<bf16*>(base + s.o_w3)),
        w4(reinterpret_cast<bf16*>(base + s.o_w4)),
        x(reinterpret_cast<bf16*>(base + s.o_x)),
        b1(reinterpret_cast<float*>(base + s.o_b1)),
        b2(reinterpret_cast<float*>(base + s.o_b2)),
        b3(reinterpret_cast<float*>(base + s.o_b3)),
        b4(reinterpret_cast<float*>(base + s.o_b4)) {}
};

__device__ void stage_model(const Dims& s, const Bf16Smem& sm, int m,
                            const bf16* w1, const float* b1, const bf16* w2,
                            const float* b2, const bf16* w3, const float* b3,
                            const bf16* w4, const float* b4) {
  const int D = s.D, H = s.H, L = s.L;
  stage_t(sm.w1, s.Dk + 8, s.Hk, w1 + static_cast<int64_t>(m) * D * H, D, H);
  stage_t(sm.w2, s.Hk + 8, s.Lk, w2 + static_cast<int64_t>(m) * H * L, H, L);
  stage_t(sm.w3, s.Lk + 8, s.Hk, w3 + static_cast<int64_t>(m) * L * H, L, H);
  stage_t(sm.w4, s.Hk + 8, s.Dn, w4 + static_cast<int64_t>(m) * H * D, H, D);
  stage_bias(sm.b1, s.Hk, b1 + static_cast<int64_t>(m) * H, H);
  stage_bias(sm.b2, s.Lk, b2 + static_cast<int64_t>(m) * L, L);
  stage_bias(sm.b3, s.Hk, b3 + static_cast<int64_t>(m) * H, H);
  stage_bias(sm.b4, s.Dn, b4 + static_cast<int64_t>(m) * D, D);
}

// One layer on the tensor cores for a warp's 16 rows, whose A fragments
// (KA k-steps of 16) are in registers: the result, with its bias, through
// relu and rounded to bf16, becomes the A fragments of the next layer (KO
// k-steps: output n-tiles 2s and 2s + 1 form k-step s).
template <int KA, int KO>
__device__ __forceinline__ void mma_layer(uint32_t (&out)[KO][4],
                                          const uint32_t (&in)[KA][4], int ka,
                                          int ko, const bf16* w, int ldw,
                                          const float* bias) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s2 = 0; s2 < KO; ++s2) {
    if (s2 >= ko) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nt = 2 * s2 + half;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* wb = w + (nt * 8 + g) * ldw + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KA; ++ks) {
        if (ks >= ka) break;
        mma_bf16(c, in[ks], ld32(wb + 16 * ks), ld32(wb + 16 * ks + 8));
      }
      const int col = nt * 8 + 2 * t;
      const float b0 = bias[col], b1 = bias[col + 1];
      out[s2][2 * half] = pack_bf16(relu(c[0] + b0), relu(c[1] + b1));
      out[s2][2 * half + 1] = pack_bf16(relu(c[2] + b0), relu(c[3] + b1));
    }
  }
}

// Rows [first, first + n) of the tile (one run of the staged model), bf16,
// on mma.sync: each warp runs all four layers for 16 rows; KD, KH, KL bound
// the padded depths in k-steps of 16 (the loops stop at the launch's own).
template <int KD, int KH, int KL>
__device__ void uniform_tile_bf16(const Dims& s, const Bf16Smem& sm,
                                  int first, int n, int64_t row0,
                                  float* __restrict__ latent,
                                  float* __restrict__ mse,
                                  float* __restrict__ znorm) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int D = s.D, L = s.L;
  const int ld1 = s.Dk + 8, ld2 = s.Hk + 8, ld4 = s.Hk + 8;
  const int kd = s.Dk >> 4, kh = s.Hk >> 4, kl = s.Lk >> 4, nd = s.Dn >> 3;
  // x as staged, rows of D: a fragment's pair of columns as one word, zero
  // from column D on (K's padding)
  const unsigned short* xt =
      reinterpret_cast<const unsigned short*>(sm.x) + first * D;
  auto pair = [&](const unsigned short* row, int col) -> uint32_t {
    const uint32_t lo = col < D ? row[col] : 0u;
    const uint32_t hi = col + 1 < D ? row[col + 1] : 0u;
    return lo | (hi << 16);
  };
  row0 += first;
#pragma unroll 1
  for (int r0 = (threadIdx.x >> 5) * 16; r0 < n; r0 += kWarps * 16) {
    uint32_t ax[KD][4];
    const unsigned short* x0 = xt + (r0 + g) * D;
    const unsigned short* x1 = x0 + 8 * D;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      if (ks >= kd) break;
      const int col = 16 * ks + 2 * t;
      ax[ks][0] = pair(x0, col);
      ax[ks][1] = pair(x1, col);
      ax[ks][2] = pair(x0, col + 8);
      ax[ks][3] = pair(x1, col + 8);
    }
    // h1 = cast(relu(x W1 + b1))
    uint32_t ah[KH][4];
    mma_layer<KD, KH>(ah, ax, kd, kh, sm.w1, ld1, sm.b1);
    // z = h1 W2 + b2: the latent out, ||z||^2 of rows g and g + 8, cast(z)
    // as the A fragments of layer 3
    uint32_t az[KL][4];
    float q0 = 0.f, q1 = 0.f;
    const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
    for (int s3 = 0; s3 < KL; ++s3) {
      if (s3 >= kl) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * s3 + half;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        const bf16* wb = sm.w2 + (nt * 8 + g) * ld2 + 2 * t;
#pragma unroll
        for (int ks = 0; ks < KH; ++ks) {
          if (ks >= kh) break;
          mma_bf16(c, ah[ks], ld32(wb + 16 * ks), ld32(wb + 16 * ks + 8));
        }
        const int col = nt * 8 + 2 * t;
        const float z00 = c[0] + sm.b2[col], z01 = c[1] + sm.b2[col + 1];
        const float z10 = c[2] + sm.b2[col], z11 = c[3] + sm.b2[col + 1];
        if (col < L) {
          q0 = fmaf(z00, z00, q0);
          q1 = fmaf(z10, z10, q1);
          if (ra < n) latent[(row0 + ra) * L + col] = z00;
          if (rb < n) latent[(row0 + rb) * L + col] = z10;
        }
        if (col + 1 < L) {
          q0 = fmaf(z01, z01, q0);
          q1 = fmaf(z11, z11, q1);
          if (ra < n) latent[(row0 + ra) * L + col + 1] = z01;
          if (rb < n) latent[(row0 + rb) * L + col + 1] = z11;
        }
        az[s3][2 * half] = pack_bf16(z00, z01);
        az[s3][2 * half + 1] = pack_bf16(z10, z11);
      }
    }
    // h2 = cast(relu(cast(z) W3 + b3))
    uint32_t ah2[KH][4];
    mma_layer<KL, KH>(ah2, az, kl, kh, sm.w3, s.Lk + 8, sm.b3);
    // recon = h2 W4 + b4, n-tile by n-tile; squared errors summed per row
    float e0 = 0.f, e1 = 0.f;
#pragma unroll 1
    for (int nt = 0; nt < nd; ++nt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* wb = sm.w4 + (nt * 8 + g) * ld4 + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KH; ++ks) {
        if (ks >= kh) break;
        mma_bf16(c, ah2[ks], ld32(wb + 16 * ks), ld32(wb + 16 * ks + 8));
      }
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (col + j < D) {
          const float b = sm.b4[col + j];
          const float d0 =
              __bfloat162float(__ushort_as_bfloat16(x0[col + j])) - (c[j] + b);
          const float d1 =
              __bfloat162float(__ushort_as_bfloat16(x1[col + j])) -
              (c[2 + j] + b);
          e0 = fmaf(d0, d0, e0);
          e1 = fmaf(d1, d1, e1);
        }
      }
    }
    // the quad of lanes t = 0..3 holds a row's parts: a fixed xor tree
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      e0 += __shfl_xor_sync(0xffffffffu, e0, o);
      e1 += __shfl_xor_sync(0xffffffffu, e1, o);
      q0 += __shfl_xor_sync(0xffffffffu, q0, o);
      q1 += __shfl_xor_sync(0xffffffffu, q1, o);
    }
    if (t == 0) {
      if (ra < n) {
        mse[row0 + ra] = e0 / static_cast<float>(D);
        znorm[row0 + ra] = sqrtf(q0);
      }
      if (rb < n) {
        mse[row0 + rb] = e1 / static_cast<float>(D);
        znorm[row0 + rb] = sqrtf(q1);
      }
    }
  }
}

// ------------------------------ the kernel --------------------------------

// The first row after r0 (< n) that starts a run, else n; `starts` holds one
// bit per row of the tile.
__device__ __forceinline__ int next_start(const unsigned* starts, int r0,
                                          int n) {
  int r = r0 + 1;
  int word = r >> 5;
  unsigned bits = word < kMaxTile / 32 ? starts[word] & (~0u << (r & 31)) : 0u;
  while (bits == 0u && ++word < kMaxTile / 32) bits = starts[word];
  if (bits == 0u) return n;
  const int at = word * 32 + __ffs(bits) - 1;
  return at < n ? at : n;
}

// NaN in all three outputs of rows [row, row + count).
__device__ __forceinline__ void nan_rows(float* latent, float* mse,
                                         float* znorm, int64_t row, int count,
                                         int L) {
  const float nan = __int_as_float(0x7fc00000);
  for (int i = threadIdx.x; i < count * L; i += kThreads)
    latent[row * L + i] = nan;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    mse[row + i] = nan;
    znorm[row + i] = nan;
  }
}

// Two CTAs per SM where the widths allow (f32 at 64-row tiles: ~97 KB of
// shared memory each; bf16 at the paper's depths: 128 registers).
template <typename T, int KD, int KH, int KL>
__global__ void __launch_bounds__(kThreads, KH <= 2 ? 2 : 1)
    fused_ae_forward_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ model_idx,
    const T* __restrict__ w1, const float* __restrict__ b1,
    const T* __restrict__ w2, const float* __restrict__ b2,
    const T* __restrict__ w3, const float* __restrict__ b3,
    const T* __restrict__ w4, const float* __restrict__ b4,
    float* __restrict__ latent, float* __restrict__ mse,
    float* __restrict__ znorm, int64_t rows, int n_models, const Dims s,
    int64_t tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kEsize = sizeof(T);
  int* ms = reinterpret_cast<int*>(smem + s.o_ms);
  unsigned* starts = reinterpret_cast<unsigned*>(ms + kMaxTile);
  // this CTA's contiguous run of tiles
  const int64_t t_begin = static_cast<int64_t>(blockIdx.x) * tiles / gridDim.x;
  const int64_t t_end =
      static_cast<int64_t>(blockIdx.x + 1) * tiles / gridDim.x;
  // the uniform path's x goes to two buffers in turn: the next tile's copy
  // is in flight while this one computes
  auto tile_rows = [&](int64_t t) {
    const int64_t left = rows - t * s.tile;
    return left < s.tile ? static_cast<int>(left) : s.tile;
  };
  auto xbuf = [&](int b) { return smem + s.o_x + b * s.xbuf; };
  auto prefetch = [&](int64_t t, int b) {
    stage_flat(xbuf(b), x + t * s.tile * s.D, tile_rows(t) * s.D * kEsize,
               kEsize);
    cp_async_commit();
  };
  auto stage_weights = [&](int m) {
    if constexpr (kBf16)
      stage_model(s, Bf16Smem(s, smem), m, w1, b1, w2, b2, w3, b3, w4, b4);
    else
      stage_model(s, F32Smem(s, smem), m, w1, b1, w2, b2, w3, b3, w4, b4);
    cp_async_commit();
  };
  int staged = -1;  // the model whose weights sit in shared memory
  int buf = 0;
  if (s.uniform && t_begin < t_end) prefetch(t_begin, 0);
#pragma unroll 1
  for (int64_t tile = t_begin; tile < t_end; ++tile) {
    const int64_t row0 = tile * s.tile;
    const int n = tile_rows(tile);
    const int tid = threadIdx.x;
    int m = -1;
    if (tid < n) {  // tile <= kThreads: one row per thread
      m = model_idx != nullptr ? __ldg(model_idx + row0 + tid) : 0;
      m = (m >= 0 && m < n_models) ? m : -1;
      ms[tid] = m;
    }
    __syncthreads();
    // a run of rows of one model starts at row 0 and wherever the model
    // changes: one bit per row in `starts`
    const bool first = tid < n && (tid == 0 || ms[tid - 1] != m);
    const unsigned ball = __ballot_sync(0xffffffffu, first);
    if ((tid & 31) == 0 && tid < kMaxTile) starts[tid >> 5] = ball;
    const int runs = __syncthreads_count(first);
    const bool uniform = s.uniform && runs <= kMaxRuns && runs * kMinRun <= n;
    // the first run's weights (when they change), then the next tile's x;
    // then wait for all but that prefetch: this tile's x and the weights
    const int m0 = ms[0];
    if (uniform && m0 >= 0 && m0 != staged) {
      stage_weights(m0);
      staged = m0;
    }
    const bool ahead = s.uniform && tile + 1 < t_end;
    if (ahead) prefetch(tile + 1, buf ^ 1);
    if (ahead)
      cp_async_wait_group<1>();
    else
      cp_async_wait_all();
    __syncthreads();
    float* scratch = reinterpret_cast<float*>(
        s.uniform ? xbuf(buf) : smem + s.o_scr);
    if (uniform) {
      // each run on the uniform path, its model staged when it changes
      int r0 = 0;
#pragma unroll 1
      for (int k = 0; k < runs; ++k) {
        const int r1 = next_start(starts, r0, n);
        const int mr = ms[r0];
        if (mr >= 0 && mr != staged) {
          stage_weights(mr);
          staged = mr;
          cp_async_wait_all();
          __syncthreads();
        }
        if (mr < 0) {
          nan_rows(latent, mse, znorm, row0 + r0, r1 - r0, s.L);
        } else if constexpr (kBf16) {
          Bf16Smem sm(s, smem);
          sm.x = reinterpret_cast<bf16*>(xbuf(buf));
          uniform_tile_bf16<KD, KH, KL>(s, sm, r0, r1 - r0, row0, latent,
                                        mse, znorm);
        } else {
          F32Smem sm(s, smem);
          sm.x = reinterpret_cast<float*>(xbuf(buf));
          uniform_tile_f32(s, sm, r0, r1 - r0, row0, latent, mse, znorm);
        }
        __syncthreads();  // the next run may restage the weights
        r0 = r1;
      }
    } else {
      mixed_tile(s, x, ms, w1, b1, w2, b2, w3, b3, w4, b4, latent, mse, znorm,
                 n, row0, scratch);
    }
    __syncthreads();  // the next tile rewrites ms, this x buffer, activations
    buf ^= 1;
  }
  cp_async_wait_all();
}

// --------------------------------- host -----------------------------------

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Offsets of every region; returns the bytes of shared memory.
size_t carve(Dims& s, bool bf16) {
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += (bytes + 15) & ~static_cast<size_t>(15);
    return static_cast<int>(at);
  };
  s.o_ms = take(4 * (kMaxTile + kMaxTile / 32));  // ms, then `starts`
  const int scratch = 4 * kWarps * s.scratch;
  if (!s.uniform) {
    s.o_scr = take(scratch);
    return off;
  }
  if (bf16) {
    s.o_w1 = take(2 * s.Hk * (s.Dk + 8));
    s.o_w2 = take(2 * s.Lk * (s.Hk + 8));
    s.o_w3 = take(2 * s.Hk * (s.Lk + 8));
    s.o_w4 = take(2 * s.Dn * (s.Hk + 8));
    s.o_b1 = take(4 * s.Hk);
    s.o_b2 = take(4 * s.Lk);
    s.o_b3 = take(4 * s.Hk);
    s.o_b4 = take(4 * s.Dn);
    // x as it lies, rows of D; a run's last m-tile reads up to 15 rows past
    // the tile; a mixed tile takes this region as the warps' scratch
    const int xb = 2 * (s.tile + 16) * s.D;
    s.xbuf = ((xb > scratch ? xb : scratch) + 15) & ~15;
    s.o_x = take(2 * s.xbuf);
  } else {
    s.o_w1 = take(4 * s.D * s.H4);
    s.o_w2 = take(4 * s.H * s.L4);
    s.o_w3 = take(4 * s.L * s.H4);
    s.o_w4 = take(4 * s.H * s.D4);
    s.o_b1 = take(4 * s.H4);
    s.o_b2 = take(4 * s.L4);
    s.o_b3 = take(4 * s.H4);
    s.o_b4 = take(4 * s.D4);
    // x as it lies, rows of D; the activations transposed, a row of P per
    // feature; a mixed tile takes x's region as the warps' scratch
    const int xb = 4 * s.tile * s.D;
    s.xbuf = ((xb > scratch ? xb : scratch) + 15) & ~15;
    s.o_x = take(2 * s.xbuf);
    s.o_h = take(4 * s.H * s.P);
    s.o_z = take(4 * s.L * s.P);
  }
  s.o_scr = s.o_x;
  return off;
}

// The launch's Dims and shared memory: the uniform path where its staged
// model and tile fit the card's opt-in shared memory, else mixed tiles only.
size_t make_dims(Dims& s, int D, int H, int L, int tile, bool bf16,
                 int optin) {
  s = Dims{};
  s.D = D;
  s.H = H;
  s.L = L;
  s.tile = tile;
  s.D4 = round_up(D, 4);
  s.H4 = round_up(H, 4);
  s.L4 = round_up(L, 4);
  // 8 past the tile: a row-sum warp's 4 features x 8 rows fall in distinct
  // banks
  s.P = tile + 8;
  s.Dk = round_up(D, 16);
  s.Hk = round_up(H, 16);
  s.Lk = round_up(L, 16);
  s.Dn = round_up(D, 8);
  s.scratch = round_up(D, 4) + round_up(H, 4) + round_up(L, 4);
  s.uniform = 1;
  size_t bytes = carve(s, bf16);
  if (bytes > static_cast<size_t>(optin)) {
    s.uniform = 0;
    bytes = carve(s, bf16);
  }
  return bytes;
}

template <typename T, int KD, int KH, int KL>
int launch(int slot, const void* x, const void* model_idx, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* w3,
           const void* b3, const void* w4, const void* b4, void* latent,
           void* mse, void* znorm, long long rows, int n_models, const Dims& s,
           size_t smem, int ctas, int device, int optin, cudaStream_t stream) {
  auto kernel = fused_ae_forward_kernel<T, KD, KH, KL>;
  std::atomic<int>& attr_set = g_attr_set[slot][device];
  if (!attr_set.load(std::memory_order_relaxed)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    // all of the SM's unified memory as shared memory, so that two CTAs
    // with ~97 KB each (f32 at 64-row tiles) share an SM
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set.store(1, std::memory_order_relaxed);
  }
  const long long tiles = (rows + s.tile - 1) / s.tile;
  const unsigned grid =
      static_cast<unsigned>(ctas < tiles ? ctas : tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(model_idx),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<const T*>(w3), static_cast<const float*>(b3),
      static_cast<const T*>(w4), static_cast<const float*>(b4),
      static_cast<float*>(latent), static_cast<float*>(mse),
      static_cast<float*>(znorm), rows, n_models, s, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the fused forward on `stream` of `device` as at most `ctas` CTAs
// over tiles of `tile` rows (8, 16, 32 or 64: tile_plan's sizes); returns
// cudaGetLastError() after the launch (0 on success). x and w1..w4 are bf16
// when use_bf16 != 0, else f32; biases and outputs are f32; model_idx is int32
// [rows] or null (model 0). The caller guarantees rows > 0, D, H <= 128 and
// L + 2 <= 128.
int fused_ae_forward(const void* x, const void* model_idx, const void* w1,
                     const void* b1, const void* w2, const void* b2,
                     const void* w3, const void* b3, const void* w4,
                     const void* b4, void* latent, void* mse, void* znorm,
                     long long rows, int n_models, int D, int H, int L,
                     int tile, int ctas, int use_bf16, int device,
                     void* stream) {
  if (tile < 8 || tile > kMaxTile || (tile & (tile - 1)) != 0 || ctas < 1 ||
      device < 0 || device >= kMaxDevices || D < 1 || H < 1 || L < 1 ||
      D > 128 || H > 128 || L + 2 > 128 || rows < 1 ||
      (rows + tile - 1) / tile > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  int rc = 0;
  int optin = g_optin[device].load(std::memory_order_relaxed);
  if (optin == 0) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err == cudaSuccess)
      g_optin[device].store(optin, std::memory_order_relaxed);
    else
      rc = static_cast<int>(err);
  }
  if (rc == 0) {
    Dims s;
    const size_t smem = make_dims(s, D, H, L, tile, use_bf16 != 0, optin);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (!use_bf16)
      rc = launch<float, 1, 1, 1>(0, x, model_idx, w1, b1, w2, b2, w3, b3,
                                  w4, b4, latent, mse, znorm, rows, n_models,
                                  s, smem, ctas, device, optin, st);
    else if (s.Hk <= 32 && s.Lk <= 16)  // the paper's 115/27/7
      rc = launch<bf16, 8, 2, 1>(1, x, model_idx, w1, b1, w2, b2, w3, b3, w4,
                                 b4, latent, mse, znorm, rows, n_models, s,
                                 smem, ctas, device, optin, st);
    else
      rc = launch<bf16, 8, 8, 8>(2, x, model_idx, w1, b1, w2, b2, w3, b3, w4,
                                 b4, latent, mse, znorm, rows, n_models, s,
                                 smem, ctas, device, optin, st);
  }
  if (current != device) cudaSetDevice(current);
  return rc;
}

const char* fused_ae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
