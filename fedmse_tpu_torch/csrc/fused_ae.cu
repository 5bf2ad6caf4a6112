// Fused autoencoder forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (fedmse_tpu_torch/ops/native.py).
//
// Replaces the TPU kernel fedmse_tpu/ops/pallas_ae.py::_kernel (launched by
// _fused_pallas, public entry fused_forward_stats). Per row:
//   h1 = cast(relu(x W1 + b1))      z  = h1 W2 + b2
//   h2 = cast(relu(cast(z) W3 + b3))  recon = h2 W4 + b4
// and three outputs: the latent z [R, L], the reconstruction MSE
// sum_j (x_j - recon_j)^2 / D [R] and the latent norm sqrt(sum_k z_k^2) [R].
// cast() rounds to bf16 in bf16 mode and is the identity in f32 mode, exactly
// where _kernel calls .astype(cdt); every dot accumulates in f32; z, recon,
// the error and all outputs stay f32; biases are f32. Each row carries its own
// model index, so one launch scores rows of many per-gateway models (the
// evaluator's [N, T] rows, the serving engine's routed buckets).
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s):
//   operations: 2 (DH + HL + LH + HD) = 13,176 FLOP per row at 115/27/7;
//   bytes: 4D + 4 + 4 (L + 2) ~ 500 B per row in f32 (~270 B in bf16), the
//   weights (26 KB per model in f32) served from L2.
// In f32 the work is bound by operations (26 FLOP/B against the card's
// 20 FLOP/B f32 balance); in bf16 by bytes. At a 1k-row serving bucket a
// launch does ~13 MFLOP, far below the cost of the launch itself: serving is
// launch-bound until its buckets are captured in CUDA graphs.
//
// Design, simple and exact first: one CTA per tile of rows; the x tile and
// the h1 / z / h2 activations sit in shared memory in f32 (the squared error
// overwrites x in place); weights come through the read-only path, indexed by
// each row's model; every dot is a fixed-order fmaf loop (no TF32, no tensor
// cores); the per-row sums are fixed-order loops in one thread (no atomics),
// so results do not change from run to run. Build without --use_fast_math:
// the division by D and the sqrt must be IEEE. A row whose model index lies
// outside [0, n_models) gets NaN in all three outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 64;
constexpr int kSmemBudget = 48 * 1024;  // no opt-in needed up to 48 KB

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

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_ae_forward_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ model_idx,
    const T* __restrict__ w1, const float* __restrict__ b1,
    const T* __restrict__ w2, const float* __restrict__ b2,
    const T* __restrict__ w3, const float* __restrict__ b3,
    const T* __restrict__ w4, const float* __restrict__ b4,
    float* __restrict__ latent, float* __restrict__ mse,
    float* __restrict__ znorm, int64_t rows, int n_models, int D, int H,
    int L, int tile) {
  extern __shared__ float smem[];
  float* xs = smem;           // [tile][D]: x, then the squared error
  float* hs = xs + tile * D;  // [tile][H]: h1, then h2
  float* zs = hs + tile * H;  // [tile][L]: z (f32)
  __shared__ int ms[kMaxTile];

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t left = rows - row0;
  const int nrows = left < tile ? static_cast<int>(left) : tile;
  const T* tag = nullptr;  // selects the to_compute overload

  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    int m = model_idx != nullptr ? __ldg(model_idx + row0 + r) : 0;
    ms[r] = (m >= 0 && m < n_models) ? m : -1;
  }
  const T* xt = x + row0 * D;
  for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) xs[i] = load(xt + i);
  __syncthreads();

  // h1 = cast(relu(x W1 + b1))
  for (int p = threadIdx.x; p < nrows * H; p += blockDim.x) {
    const int r = p / H, j = p - r * H, m = ms[r];
    float acc = 0.f;
    if (m >= 0) {
      const T* w = w1 + static_cast<int64_t>(m) * D * H + j;
      const float* xr = xs + r * D;
      for (int k = 0; k < D; ++k) acc = fmaf(xr[k], load(w + k * H), acc);
      acc = to_compute(relu(acc + __ldg(b1 + static_cast<int64_t>(m) * H + j)), tag);
    }
    hs[p] = acc;
  }
  __syncthreads();

  // z = h1 W2 + b2
  for (int p = threadIdx.x; p < nrows * L; p += blockDim.x) {
    const int r = p / L, j = p - r * L, m = ms[r];
    float acc = 0.f;
    if (m >= 0) {
      const T* w = w2 + static_cast<int64_t>(m) * H * L + j;
      const float* hr = hs + r * H;
      for (int k = 0; k < H; ++k) acc = fmaf(hr[k], load(w + k * L), acc);
      acc += __ldg(b2 + static_cast<int64_t>(m) * L + j);
    }
    zs[p] = acc;
  }
  __syncthreads();

  // h2 = cast(relu(cast(z) W3 + b3)), written over h1
  for (int p = threadIdx.x; p < nrows * H; p += blockDim.x) {
    const int r = p / H, j = p - r * H, m = ms[r];
    float acc = 0.f;
    if (m >= 0) {
      const T* w = w3 + static_cast<int64_t>(m) * L * H + j;
      const float* zr = zs + r * L;
      for (int k = 0; k < L; ++k)
        acc = fmaf(to_compute(zr[k], tag), load(w + k * H), acc);
      acc = to_compute(relu(acc + __ldg(b3 + static_cast<int64_t>(m) * H + j)), tag);
    }
    hs[p] = acc;
  }
  __syncthreads();

  // recon = h2 W4 + b4; the squared error replaces x in place (each element
  // is read and written by the one thread that owns it)
  for (int p = threadIdx.x; p < nrows * D; p += blockDim.x) {
    const int r = p / D, j = p - r * D, m = ms[r];
    if (m < 0) continue;
    const T* w = w4 + static_cast<int64_t>(m) * H * D + j;
    const float* hr = hs + r * H;
    float acc = 0.f;
    for (int k = 0; k < H; ++k) acc = fmaf(hr[k], load(w + k * D), acc);
    const float err = xs[p] - (acc + __ldg(b4 + static_cast<int64_t>(m) * D + j));
    xs[p] = err * err;
  }
  __syncthreads();

  const float nan = __int_as_float(0x7fc00000);
  for (int i = threadIdx.x; i < nrows * L; i += blockDim.x)
    latent[row0 * L + i] = ms[i / L] >= 0 ? zs[i] : nan;
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    if (ms[r] < 0) {
      mse[row0 + r] = nan;
      znorm[row0 + r] = nan;
      continue;
    }
    const float* er = xs + r * D;
    float s = 0.f;
    for (int j = 0; j < D; ++j) s += er[j];
    mse[row0 + r] = s / static_cast<float>(D);
    const float* zr = zs + r * L;
    float q = 0.f;
    for (int k = 0; k < L; ++k) q += zr[k] * zr[k];
    znorm[row0 + r] = sqrtf(q);
  }
}

int pick_tile(int D, int H, int L) {
  int tile = kMaxTile;
  while (tile > 1 && tile * (D + H + L) * static_cast<int>(sizeof(float)) > kSmemBudget)
    tile /= 2;
  return tile;
}

template <typename T>
int launch(const void* x, const void* model_idx, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* w3, const void* b3,
           const void* w4, const void* b4, void* latent, void* mse, void* znorm,
           long long rows, int n_models, int D, int H, int L,
           cudaStream_t stream) {
  const int tile = pick_tile(D, H, L);
  const long long blocks = (rows + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tile) * (D + H + L) * sizeof(float);
  fused_ae_forward_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(model_idx),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<const T*>(w3), static_cast<const float*>(b3),
      static_cast<const T*>(w4), static_cast<const float*>(b4),
      static_cast<float*>(latent), static_cast<float*>(mse),
      static_cast<float*>(znorm), rows, n_models, D, H, L, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the fused forward on `stream`; returns cudaGetLastError() after
// the launch (0 on success). x and w1..w4 are bf16 when bf16 != 0, else f32;
// biases and outputs are f32; model_idx is int32 [rows] or null (model 0).
// The caller guarantees rows > 0, D, H <= 128 and L + 2 <= 128.
int fused_ae_forward(const void* x, const void* model_idx, const void* w1,
                     const void* b1, const void* w2, const void* b2,
                     const void* w3, const void* b3, const void* w4,
                     const void* b4, void* latent, void* mse, void* znorm,
                     long long rows, int n_models, int D, int H, int L,
                     int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, model_idx, w1, b1, w2, b2, w3, b3, w4, b4,
                                 latent, mse, znorm, rows, n_models, D, H, L, s);
  return launch<float>(x, model_idx, w1, b1, w2, b2, w3, b3, w4, b4, latent,
                       mse, znorm, rows, n_models, D, H, L, s);
}

const char* fused_ae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
