// The distance kernel's first design, kept unchanged as the yardstick that
// chip_smoke.py times beside csrc/dist_tiles.cu on the same inputs in the
// same run (and holds bit for bit against it: both sum in the same order).
// Nothing in the package calls it; it takes f32 queries only. Its entry has
// the same name and arguments as before the redesign; it is built into a
// library of its own (ops/native.py, BASELINE_SOURCES).
//
// Squared-distance tiles of query rows against per-row reference banks, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (fedmse_tpu_torch/ops/native.py).
//
// Replaces the TPU kernel fedmse_tpu/knn/score.py::_dist_kernel (launched by
// _dist_pallas, public entry dist_tiles). For every query row i against its
// own bank g = gw[i] (bank 0 when gw is null):
//   out[i, j] = max((|q_i|^2 - 2 q_i . b_{g,j}) + |b_{g,j}|^2, 0)
// q [T, L], banks [N, B, L] and out [T, B] are f32; gw is int32 [T]. The TPU
// kernel took one bank per call, so the JAX serving path encoded the routing
// in a one-hot [T, N*L] operand or gathered a bank per row; here the per-row
// bank index makes both the evaluator's client-major rows and a serving
// bucket's routed rows one launch. A row whose bank index lies outside
// [0, N) gets NaN in every column.
//
// The association is the JAX kernel's: (qn - 2 * cross) + bn, then the clamp
// at 0 (which keeps NaN, like jnp.maximum). qn, bn and cross are fixed-order
// fmaf sums over l from 0 to L-1; 2 * cross is exact, so nvcc contracting
// qn - 2 * cross into one fma changes nothing. No fast math, no TF32, no
// atomics: results do not change from run to run, and the plain PyTorch
// twin (fedmse_tpu_torch/knn/score.py dist_tiles_plain) differs by summation
// order only.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
//   bytes: 4 T B written, 4 T (L + 1) read, 4 B L per distinct bank read;
//   operations: 2 L T B for the cross term (the norms are lower order).
// At L = 7 that is 14 FLOP per 4-byte output, under the card's ~20 FLOP/B
// f32 balance: the kernel is bound by the bytes of its output.
//
// Design, simple and exact first: one thread per output element, consecutive
// threads on consecutive columns j so the output stores coalesce; a CTA
// stages its tile of query rows, their bank index and |q|^2 in shared memory
// and walks kRowsPerThread rows per thread; bank rows come through the
// read-only path (a bank is 14 KB at B = 512, L = 7; all 512 gateways' banks,
// 7.3 MB, stay in L2). The bank is [N, B, L], so a warp's load of element l
// of 32 consecutive slots spans L cache lines: reloading the bank row for
// every output row made the kernel bound by L1 wavefronts, not by its
// output. For L <= kRegLatent (the model's L = 7) each thread therefore keeps
// its bank row and |b|^2 in registers while consecutive rows of its tile
// route to the same bank (the evaluator's client-major rows); wider latents
// take the generic loop, which reloads per row. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kRegLatent = 8;  // latents up to this width stay in registers

// Stages the CTA's query rows, their bank index (-1 when out of range) and
// |q|^2 in shared memory; returns the number of valid rows in the tile.
__device__ __forceinline__ int stage_tile(const float* __restrict__ q,
                                          const int32_t* __restrict__ gw,
                                          int64_t rows, int n_banks, int L,
                                          int64_t row0, int tile_rows,
                                          float* qs, float* qn, int* gs) {
  const int64_t left = rows - row0;
  const int nrows = left < tile_rows ? static_cast<int>(left) : tile_rows;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const float* qt = q + row0 * L;
  for (int p = tid; p < nrows * L; p += nthreads) qs[p] = __ldg(qt + p);
  for (int r = tid; r < nrows; r += nthreads) {
    const int g = gw != nullptr ? __ldg(gw + row0 + r) : 0;
    gs[r] = (g >= 0 && g < n_banks) ? g : -1;
  }
  __syncthreads();
  for (int r = tid; r < nrows; r += nthreads) {
    const float* qr = qs + r * L;
    float s = 0.f;
    for (int l = 0; l < L; ++l) s = fmaf(qr[l], qr[l], s);
    qn[r] = s;
  }
  __syncthreads();
  return nrows;
}

// (qn - 2 cross) + bn, clamped at 0 in a way that keeps NaN, like
// jnp.maximum(d, 0)
__device__ __forceinline__ float clamp_dist(float qn, float cross, float bn) {
  const float d = (qn - 2.f * cross) + bn;
  return d < 0.f ? 0.f : d;
}

// L <= kRegLatent: the bank row and its norm live in registers and are
// reloaded only when the row's bank changes.
__global__ void __launch_bounds__(kThreads) dist_tiles_reg_kernel(
    const float* __restrict__ q, const float* __restrict__ banks,
    const int32_t* __restrict__ gw, float* __restrict__ out, int64_t rows,
    int n_banks, int B, int L) {
  extern __shared__ float smem[];
  const int tile_rows = blockDim.y * kRowsPerThread;
  float* qs = smem;
  float* qn = qs + tile_rows * L;
  int* gs = reinterpret_cast<int*>(qn + tile_rows);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int nrows = stage_tile(q, gw, rows, n_banks, L, row0, tile_rows, qs,
                               qn, gs);

  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= B) return;
  const float nan = __int_as_float(0x7fc00000);
  float bv[kRegLatent];
  float bn = 0.f;
  int cached = -1;
  for (int r = threadIdx.y; r < nrows; r += blockDim.y) {
    const int g = gs[r];
    float d = nan;
    if (g >= 0) {
      if (g != cached) {
        const float* b = banks + (static_cast<int64_t>(g) * B + j) * L;
        bn = 0.f;
#pragma unroll
        for (int l = 0; l < kRegLatent; ++l) {
          bv[l] = l < L ? __ldg(b + l) : 0.f;
          if (l < L) bn = fmaf(bv[l], bv[l], bn);
        }
        cached = g;
      }
      const float* qr = qs + r * L;
      float cross = 0.f;
#pragma unroll
      for (int l = 0; l < kRegLatent; ++l)
        if (l < L) cross = fmaf(qr[l], bv[l], cross);
      d = clamp_dist(qn[r], cross, bn);
    }
    out[(row0 + r) * B + j] = d;
  }
}

__global__ void __launch_bounds__(kThreads) dist_tiles_kernel(
    const float* __restrict__ q, const float* __restrict__ banks,
    const int32_t* __restrict__ gw, float* __restrict__ out, int64_t rows,
    int n_banks, int B, int L) {
  extern __shared__ float smem[];
  const int tile_rows = blockDim.y * kRowsPerThread;
  float* qs = smem;                                   // [tile_rows][L]
  float* qn = qs + tile_rows * L;                     // [tile_rows]
  int* gs = reinterpret_cast<int*>(qn + tile_rows);   // [tile_rows]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int nrows = stage_tile(q, gw, rows, n_banks, L, row0, tile_rows, qs,
                               qn, gs);

  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= B) return;
  const float nan = __int_as_float(0x7fc00000);
  for (int r = threadIdx.y; r < nrows; r += blockDim.y) {
    const int g = gs[r];
    float d = nan;
    if (g >= 0) {
      const float* b = banks + (static_cast<int64_t>(g) * B + j) * L;
      const float* qr = qs + r * L;
      float cross = 0.f, bn = 0.f;
      for (int l = 0; l < L; ++l) {
        const float v = __ldg(b + l);
        cross = fmaf(qr[l], v, cross);
        bn = fmaf(v, v, bn);
      }
      d = clamp_dist(qn[r], cross, bn);
    }
    out[(row0 + r) * B + j] = d;
  }
}

}  // namespace

extern "C" {

// Launches the distance tiles on `stream`; returns cudaGetLastError() after
// the launch (0 on success). gw is int32 [rows] or null (bank 0 for every
// row). The caller guarantees rows > 0, B > 0, 1 <= L <= 128 and contiguous
// f32 q [rows, L], banks [n_banks, B, L] and out [rows, B].
int dist_tiles(const void* q, const void* banks, const void* gw, void* out,
               long long rows, int n_banks, int B, int L, void* stream) {
  // column tile: the power of two covering B, between one warp and 128
  int tc = 32;
  while (tc < B && tc < 128) tc *= 2;
  const dim3 block(tc, kThreads / tc);
  const int tile_rows = static_cast<int>(block.y) * kRowsPerThread;
  const long long row_tiles = (rows + tile_rows - 1) / tile_rows;
  const long long col_tiles = (static_cast<long long>(B) + tc - 1) / tc;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>(col_tiles));
  const size_t smem = static_cast<size_t>(tile_rows) * (L + 2) * sizeof(float);
  auto kernel = L <= kRegLatent ? dist_tiles_reg_kernel : dist_tiles_kernel;
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(banks),
      static_cast<const int32_t*>(gw), static_cast<float*>(out), rows,
      n_banks, B, L);
  return static_cast<int>(cudaGetLastError());
}

const char* dist_tiles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
