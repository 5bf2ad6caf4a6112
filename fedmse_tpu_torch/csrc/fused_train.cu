// Fused autoencoder train step for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (fedmse_tpu_torch/ops/native.py).
//
// Replaces the TPU kernel fedmse_tpu/ops/pallas_ae.py:309 _train_kernel
// (launched by _fused_train_pallas, public entries fused_train_grads and
// make_fused_train_loss). For every client g of a cohort, over its batch rows
// r with row mask m_r, it computes the forward of fused_ae.cu
//   h1 = cast(relu(x W1 + b1))      z  = h1 W2 + b2
//   h2 = cast(relu(cast(z) W3 + b3))  recon = h2 W4 + b4
// the loss partials
//   s_mse = sum_r m_r sum_j (x - recon)_j^2      s_zn = sum_r m_r ||z_r||
// (||.|| the safe norm: exactly 0 at z = 0) and the hand-derived backward of
// L~ = s_mse / D + lam s_zn, i.e. every gradient of the loss times sum_r m_r:
//   dr  = (-2/D) m (x - recon)         db4 = sum_r dr    dW4 = h2^T cast(dr)
//   da3 = [h2 > 0] cast(dr) W4^T       db3 = sum_r da3   dW3 = cast(z)^T cast(da3)
//   dz  = cast(da3) W3^T + lam m z / ||z|| (0 at z = 0)
//                                      db2 = sum_r dz    dW2 = h1^T cast(dz)
//   da1 = [h1 > 0] cast(dz) W2^T       db1 = sum_r da1   dW1 = x^T cast(da1)
// cast() rounds to bf16 in bf16 mode and is the identity in f32 mode, at
// exactly _train_kernel's .astype(cdt) points (h1, cast(z), h2, and the
// cotangents before each product); weights round to bf16 as they load, as
// the TPU entry's pack_params(params, bf16) does. Biases, sums, the loss
// partials and all gradients stay f32. The ReLU gates read the rounded
// activations (relu'(0) = 0). The wrapper (ops/fused_train.py) scales the
// partials by 1 / sum_r m_r.
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s):
//   operations: forward 2 (DH + HL + LH + HD) = 13,176 FLOP per row and
//   backward 2 (2HD + 2LH + 2HL + DH) = 20,142 FLOP per row at 115/27/7:
//   33,318 FLOP per row;
//   bytes: x (4D or 2D per row), the mask (4 per row), each client's 6,764
//   f32 parameters read once and its 6,766 f32 outputs written once.
// A local-training step of the main path (G = 5 clients, R = 12 rows) is
// ~2.0 MFLOP and ~0.30 MB: a bound of ~0.09 us, far below the launch
// itself, which sets the step's time. The later fix is to capture the
// batch loop (this launch plus the optimizer's ops) in a CUDA graph.
//
// Design, simple and right first. On the TPU the grid walks row blocks in
// order and carries dW in VMEM; here one CTA owns one (client, chunk of 128
// rows). It copies the client's parameters into shared memory (rounded to
// the compute type), keeps the client's whole gradient (P + 2 floats, 27 KB
// at 115/27/7) in shared memory, and loops over tiles of <= 64 rows whose
// activations and cotangents also sit in shared memory. Every gradient
// element is owned by one thread, which sums its rows in a fixed order: no
// atomics, no TF32, no tensor cores, no --use_fast_math, so results do not
// change from run to run. When a client's rows span several chunks, each
// chunk writes its partials to a scratch [G, C, P + 2] buffer and a second
// small launch sums them over C in order; at R <= 128 (a training batch is
// 12 rows) a whole cohort's step is one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 64;
constexpr int kChunkRows = 128;
constexpr int kErrTooWide = 1000;  // the model does not fit shared memory

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Round an f32 value to the compute type and back (identity for f32).
__device__ __forceinline__ float to_compute(float v, const float*) { return v; }
__device__ __forceinline__ float to_compute(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// max(v, 0) that keeps NaN, like jnp.maximum and torch.relu.
__device__ __forceinline__ float relu(float v) {
  return (v > 0.f || v != v) ? v : 0.f;
}

// Offsets of the eight leaves in a flat parameter row (models/flat.py).
struct Layout {
  int D, H, L;
  int w1, b1, w2, b2, w3, b3, w4, b4, P;
};

Layout make_layout(int D, int H, int L) {
  Layout s;
  s.D = D;
  s.H = H;
  s.L = L;
  s.w1 = 0;
  s.b1 = s.w1 + D * H;
  s.w2 = s.b1 + H;
  s.b2 = s.w2 + H * L;
  s.w3 = s.b2 + L;
  s.b3 = s.w3 + L * H;
  s.w4 = s.b3 + H;
  s.b4 = s.w4 + H * D;
  s.P = s.b4 + D;
  return s;
}

size_t smem_bytes(const Layout& s, int tile) {
  const size_t per_row = 2 * s.D + 4 * s.H + 2 * s.L + 4;
  return sizeof(float) * (2 * static_cast<size_t>(s.P) + 2 + tile * per_row);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_ae_train_kernel(
    const T* __restrict__ x, long long x_stride, const float* __restrict__ mask,
    long long m_stride, const float* __restrict__ params,
    float* __restrict__ out, int R, Layout s, int tile, float lam) {
  extern __shared__ float smem[];
  const int D = s.D, H = s.H, L = s.L, P = s.P;
  float* w = smem;            // [P]: the client's parameters
  float* acc = w + P;         // [P + 2]: gradient sums, then s_mse, s_zn
  float* xs = acc + P + 2;    // [tile][D]: x
  float* h1 = xs + tile * D;  // [tile][H]
  float* zs = h1 + tile * H;  // [tile][L]: z (f32)
  float* h2 = zs + tile * L;  // [tile][H]
  float* dr = h2 + tile * H;  // [tile][D]: x - recon, then dL~/drecon
  float* da3 = dr + tile * D; // [tile][H]
  float* dz = da3 + tile * H; // [tile][L]
  float* da1 = dz + tile * L; // [tile][H]
  float* ms = da1 + tile * H; // [tile]: row mask
  float* inv = ms + tile;     // [tile]: safe 1 / ||z||
  float* rse = inv + tile;    // [tile]: m sum_j err^2
  float* rzn = rse + tile;    // [tile]: m ||z||

  const int tid = threadIdx.x, nt = blockDim.x;
  const int g = blockIdx.x, c = blockIdx.y;
  const T* tag = nullptr;  // selects the to_compute overload

  const float* pg = params + static_cast<int64_t>(g) * P;
  for (int i = tid; i < P; i += nt) {
    const float v = __ldg(pg + i);
    const bool bias = (i >= s.b1 && i < s.w2) || (i >= s.b2 && i < s.w3) ||
                      (i >= s.b3 && i < s.w4) || i >= s.b4;
    w[i] = bias ? v : to_compute(v, tag);
  }
  for (int i = tid; i < P + 2; i += nt) acc[i] = 0.f;
  const float *W1 = w + s.w1, *B1 = w + s.b1, *W2 = w + s.w2, *B2 = w + s.b2;
  const float *W3 = w + s.w3, *B3 = w + s.b3, *W4 = w + s.w4, *B4 = w + s.b4;

  const T* xg = x + static_cast<int64_t>(g) * x_stride;
  const float* mg = mask + static_cast<int64_t>(g) * m_stride;
  const float coef = static_cast<float>(-2.0 / D);
  const int row_end = min(R, (c + 1) * kChunkRows);

  for (int t0 = c * kChunkRows; t0 < row_end; t0 += tile) {
    const int n = min(tile, row_end - t0);
    for (int i = tid; i < n * D; i += nt)
      xs[i] = load(xg + static_cast<int64_t>(t0) * D + i);
    for (int r = tid; r < n; r += nt) ms[r] = __ldg(mg + t0 + r);
    __syncthreads();

    // ---- forward --------------------------------------------------------
    for (int p = tid; p < n * H; p += nt) {  // h1 = cast(relu(x W1 + b1))
      const int r = p / H, j = p - r * H;
      const float* xr = xs + r * D;
      float a = 0.f;
      for (int k = 0; k < D; ++k) a = fmaf(xr[k], W1[k * H + j], a);
      h1[p] = to_compute(relu(a + B1[j]), tag);
    }
    __syncthreads();
    for (int p = tid; p < n * L; p += nt) {  // z = h1 W2 + b2
      const int r = p / L, j = p - r * L;
      const float* hr = h1 + r * H;
      float a = 0.f;
      for (int k = 0; k < H; ++k) a = fmaf(hr[k], W2[k * L + j], a);
      zs[p] = a + B2[j];
    }
    __syncthreads();
    for (int p = tid; p < n * H; p += nt) {  // h2 = cast(relu(cast(z) W3 + b3))
      const int r = p / H, j = p - r * H;
      const float* zr = zs + r * L;
      float a = 0.f;
      for (int k = 0; k < L; ++k)
        a = fmaf(to_compute(zr[k], tag), W3[k * H + j], a);
      h2[p] = to_compute(relu(a + B3[j]), tag);
    }
    __syncthreads();
    for (int p = tid; p < n * D; p += nt) {  // err = x - (h2 W4 + b4)
      const int r = p / D, j = p - r * D;
      const float* hr = h2 + r * H;
      float a = 0.f;
      for (int k = 0; k < H; ++k) a = fmaf(hr[k], W4[k * D + j], a);
      dr[p] = xs[p] - (a + B4[j]);
    }
    __syncthreads();

    // ---- per row: loss terms, safe norm; err becomes dL~/drecon ----------
    for (int r = tid; r < n; r += nt) {
      const float m = ms[r];
      float* er = dr + r * D;
      float se = 0.f;
      for (int j = 0; j < D; ++j) se += m * (er[j] * er[j]);
      const float* zr = zs + r * L;
      float sq = 0.f;
      for (int k = 0; k < L; ++k) sq += zr[k] * zr[k];
      const float nz = sq > 0.f ? 1.f : 0.f;
      const float zn = sqrtf(sq > 0.f ? sq : 1.f) * nz;
      inv[r] = nz / (sq > 0.f ? zn : 1.f);
      rse[r] = se;
      rzn[r] = m * zn;
      for (int j = 0; j < D; ++j) er[j] = coef * (m * er[j]);
    }
    __syncthreads();
    if (tid == 0) {  // the loss partials, rows in order
      for (int r = 0; r < n; ++r) {
        acc[P] += rse[r];
        acc[P + 1] += rzn[r];
      }
    }

    // ---- backward: each gradient element is owned by one thread ---------
    for (int p = tid; p < n * H; p += nt) {  // da3 = [h2 > 0] cast(dr) W4^T
      const int r = p / H, k = p - r * H;
      const float* d = dr + r * D;
      const float* wk = W4 + k * D;
      float a = 0.f;
      for (int j = 0; j < D; ++j) a = fmaf(to_compute(d[j], tag), wk[j], a);
      da3[p] = h2[p] > 0.f ? a : 0.f;
    }
    for (int e = tid; e < H * D; e += nt) {  // dW4 = h2^T cast(dr)
      const int k = e / D, j = e - k * D;
      float a = 0.f;
      for (int r = 0; r < n; ++r)
        a = fmaf(h2[r * H + k], to_compute(dr[r * D + j], tag), a);
      acc[s.w4 + e] += a;
    }
    for (int j = tid; j < D; j += nt) {  // db4 = sum_r dr
      float a = 0.f;
      for (int r = 0; r < n; ++r) a += dr[r * D + j];
      acc[s.b4 + j] += a;
    }
    __syncthreads();
    for (int p = tid; p < n * L; p += nt) {  // dz = cast(da3) W3^T + shrink
      const int r = p / L, l = p - r * L;
      const float* d = da3 + r * H;
      const float* wl = W3 + l * H;
      float a = 0.f;
      for (int k = 0; k < H; ++k) a = fmaf(to_compute(d[k], tag), wl[k], a);
      dz[p] = a + ((lam * ms[r]) * zs[p]) * inv[r];
    }
    for (int e = tid; e < L * H; e += nt) {  // dW3 = cast(z)^T cast(da3)
      const int l = e / H, k = e - l * H;
      float a = 0.f;
      for (int r = 0; r < n; ++r)
        a = fmaf(to_compute(zs[r * L + l], tag),
                 to_compute(da3[r * H + k], tag), a);
      acc[s.w3 + e] += a;
    }
    for (int k = tid; k < H; k += nt) {  // db3 = sum_r da3
      float a = 0.f;
      for (int r = 0; r < n; ++r) a += da3[r * H + k];
      acc[s.b3 + k] += a;
    }
    __syncthreads();
    for (int p = tid; p < n * H; p += nt) {  // da1 = [h1 > 0] cast(dz) W2^T
      const int r = p / H, k = p - r * H;
      const float* d = dz + r * L;
      const float* wk = W2 + k * L;
      float a = 0.f;
      for (int l = 0; l < L; ++l) a = fmaf(to_compute(d[l], tag), wk[l], a);
      da1[p] = h1[p] > 0.f ? a : 0.f;
    }
    for (int e = tid; e < H * L; e += nt) {  // dW2 = h1^T cast(dz)
      const int k = e / L, l = e - k * L;
      float a = 0.f;
      for (int r = 0; r < n; ++r)
        a = fmaf(h1[r * H + k], to_compute(dz[r * L + l], tag), a);
      acc[s.w2 + e] += a;
    }
    for (int l = tid; l < L; l += nt) {  // db2 = sum_r dz
      float a = 0.f;
      for (int r = 0; r < n; ++r) a += dz[r * L + l];
      acc[s.b2 + l] += a;
    }
    __syncthreads();
    for (int e = tid; e < D * H; e += nt) {  // dW1 = x^T cast(da1)
      const int i = e / H, k = e - i * H;
      float a = 0.f;
      for (int r = 0; r < n; ++r)
        a = fmaf(xs[r * D + i], to_compute(da1[r * H + k], tag), a);
      acc[s.w1 + e] += a;
    }
    for (int k = tid; k < H; k += nt) {  // db1 = sum_r da1
      float a = 0.f;
      for (int r = 0; r < n; ++r) a += da1[r * H + k];
      acc[s.b1 + k] += a;
    }
    __syncthreads();  // the next tile overwrites every row buffer
  }

  float* o = out + (static_cast<int64_t>(g) * gridDim.y + c) * (P + 2);
  for (int i = tid; i < P + 2; i += nt) o[i] = acc[i];
}

// out[g][i] = sum over c, in order, of part[g][c][i]
__global__ void sum_chunks_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int G, int C,
                                  int W) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(G) * W) return;
  const int64_t g = idx / W, i = idx - g * W;
  const float* p = part + g * C * W + i;
  float a = 0.f;
  for (int c = 0; c < C; ++c) a += p[static_cast<int64_t>(c) * W];
  out[idx] = a;
}

template <typename T>
int launch(const void* x, long long x_stride, const void* mask,
           long long m_stride, const void* params, void* out, void* scratch,
           int G, int R, int D, int H, int L, float lam, cudaStream_t stream) {
  const Layout s = make_layout(D, H, L);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int tile = R < kMaxTile ? R : kMaxTile;
  while (tile > 1 && smem_bytes(s, tile) > static_cast<size_t>(optin)) tile /= 2;
  const size_t smem = smem_bytes(s, tile);
  if (smem > static_cast<size_t>(optin)) return kErrTooWide;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_ae_train_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int chunks = (R + kChunkRows - 1) / kChunkRows;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  float* target = static_cast<float*>(chunks > 1 ? scratch : out);
  fused_ae_train_kernel<T><<<dim3(G, chunks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), x_stride, static_cast<const float*>(mask),
      m_stride, static_cast<const float*>(params), target, R, s, tile, lam);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(G) * (s.P + 2);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  sum_chunks_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<float*>(out), G, chunks,
      s.P + 2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows per chunk: a client with more rows than this gets several CTAs and
// the wrapper passes a scratch [G, ceil(R / chunk), P + 2] f32 buffer.
int fused_ae_train_chunk_rows() { return kChunkRows; }

// Launches the fused train step on `stream`; returns cudaGetLastError()
// after the launch(es) (0 on success) or 1000 when the model's parameters,
// gradient and one row of buffers do not fit in shared memory. x is
// [G, R, D] (bf16 when bf16 != 0, else f32) with client stride x_stride
// elements and row stride D; mask is f32 [G, R] with client stride
// m_stride; params is f32 [G, P]; out is f32 [G, P + 2] (gradient partials,
// then s_mse and s_zn). The caller guarantees G, R > 0.
int fused_ae_train(const void* x, long long x_stride, const void* mask,
                   long long m_stride, const void* params, void* out,
                   void* scratch, int G, int R, int D, int H, int L,
                   float lam, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, x_stride, mask, m_stride, params, out,
                                 scratch, G, R, D, H, L, lam, s);
  return launch<float>(x, x_stride, mask, m_stride, params, out, scratch, G,
                       R, D, H, L, lam, s);
}

const char* fused_ae_train_error_string(int code) {
  if (code == kErrTooWide)
    return "the model's parameters and gradient do not fit in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
