// KitNET's two kernels for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (fedmse_tpu_torch/ops/native.py).
//
// Replaces no Pallas kernel: the TPU package has no KitNET. The model
// (Kitsune, NDSS 2018; models/kitnet.py) is an ensemble of k tied-weight
// sigmoid autoencoders, member a reading the n_a features of cluster a of a
// feature map, and an output autoencoder over the members' RMSEs:
//   y = sigma(u W + b),  o = y W^T + c,  z = sigma(o)        (each autoencoder)
//   s_a = sqrt(mean_j (x_{v_a,j} - z_j)^2)                   (member a's RMSE)
//   s^_a = (s_a - lo_a) / (hi_a - lo_a + 1e-16)   (s_a itself where hi < lo)
//   the row's statistic: mean_i (s^_i - z_out,i)^2
//   the row's loss: sum over every autoencoder of sum_j softplus(o_j) - u_j o_j
//     (the reconstruction cross-entropy in logit form; its gradient at o is
//     z - u), s^ a constant to the output autoencoder.
//
// kitnet_forward: per row of x [R, D] under the model model_idx[r] of the
// stacked params [G, P] and statistics [G, 2k]: the statistic and the loss.
// kitnet_train: per client c of S, its batch x[c] [R, D] (row mask [R]):
// first (lo, hi) of client c take the min and max of s over the batch's real
// rows under the pre-step params (where active[c]), then the loss and every
// parameter's gradient, both normalised by 1 / sum(mask) (x / 0 where the
// mask is empty: NaN, as the autoencoder's train kernel gives).
//
// Bound on an H100 SXM (67 TFLOP/s f32, 3.35 TB/s). The forward's
// 2 (2 sum_a n_a h_a + 2 k h_o) FLOPs a row (about 3.9k at the 115-feature
// map of 23 clusters of 5: 3.4k in the ensemble) against its 4 D + 12 bytes
// (x, the model index and two outputs) put it at 8 FLOP a byte, below the
// ridge (20): bandwidth bounds it, and a row's sigmoids and softpluses
// (about 2 (D + k) transcendentals) sit beside its FLOPs. The train step
// adds the backward, 3 n h multiply-adds an autoencoder, on R = 12 rows
// a client: 12 x 13.6k FLOPs against the client's P params read and P
// gradients written; at S = 250 both are microseconds of work, so a step
// is one launch's latency (one wave of 250 CTAs).
//
// Design. A small int table in device memory describes the map (below);
// every CTA stages it in shared memory. Work inside a CTA is a list of
// items (autoencoder, row) or (unit, row) taken by the CTA's 256 threads in
// turn, between barriers:
//   forward (one CTA a tile of `tile` rows, 8 to 32): the tile's rows into
//   shared memory; each ensemble member on each row (its hidden units into
//   shared memory, its RMSE and cross-entropy); s^ per (member, row); the
//   output autoencoder's hidden units per (unit, row), its visible units
//   per (unit, row); per row, the sums in a fixed order. Weights are read
//   from device memory through L1 (a tile's rows mostly share a model).
//   train (one CTA a client): the client's params, rows and mask into
//   shared memory; the ensemble forward, keeping the hidden activations and
//   the masked output errors m (z - x); the statistics update per member;
//   s^; the output autoencoder's hidden units and, in the same phase, the
//   ensemble's hidden errors (dz W) y (1 - y); the output's visible errors;
//   its hidden errors; then each parameter's gradient as a sum over the
//   rows in order (thread t takes parameters t, t + 256, ...; the table
//   names each parameter's autoencoder), and the loss by one thread.
// Every sum runs in an order fixed by the shapes alone. No atomics, no
// scratch in device memory. Shared-memory strides are odd (no bank
// conflicts between rows).
//
// The table (int32): [0] k, [1] D, [2] Hs (the members' hidden units in
// all), [3] h_o, [4] P, [5] o_w, [6] o_b, [7] o_c (the output autoencoder's
// offsets); at 8 + 5a member a's n, h, f (its first position in the map
// order), w (its W's offset; b follows W, c follows b), y (its first hidden
// unit among the Hs); at 8 + 5k the D feature indices in map order; at
// 8 + 5k + D each parameter's autoencoder (k: the output one).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeader = 8;
constexpr int kErrTooWide = 1000;
constexpr int kSmemMax = 227 * 1024;  // an H100 CTA's opt-in shared memory

struct Dims {
  int k, D, Hs, ho, P, Q, table_len;
};

__host__ __device__ inline int odd(int v) { return v | 1; }
__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

// The forward CTA's shared memory, offsets in 4-byte words.
struct FwdSmem {
  int xs, ys, sv, ce, sh, yo, oc, mrow, total;
};

__host__ __device__ inline FwdSmem fwd_smem(const Dims& d, int tile) {
  FwdSmem s;
  s.xs = up4(d.table_len);
  s.ys = s.xs + tile * odd(d.D);
  s.sv = s.ys + tile * odd(d.Hs);
  s.ce = s.sv + tile * odd(d.k);
  s.sh = s.ce + tile * odd(d.k);
  s.yo = s.sh + tile * odd(d.k);
  s.oc = s.yo + tile * odd(d.ho);
  s.mrow = s.oc + tile * odd(d.k);
  s.total = s.mrow + tile;
  return s;
}

// The train CTA's shared memory, offsets in 4-byte words.
struct TrainSmem {
  int ps, xs, ys, dz, da, sv, ce, sh, yo, dzo, dao, oc, mk, lohi, misc, total;
};

__host__ __device__ inline TrainSmem train_smem(const Dims& d, int rows) {
  TrainSmem s;
  const int xd = odd(d.D), hs = odd(d.Hs), kk = odd(d.k), hh = odd(d.ho);
  s.ps = up4(d.table_len);
  s.xs = s.ps + up4(d.P);
  s.ys = s.xs + rows * xd;
  s.dz = s.ys + rows * hs;
  s.da = s.dz + rows * xd;
  s.sv = s.da + rows * hs;
  s.ce = s.sv + rows * kk;
  s.sh = s.ce + rows * kk;
  s.yo = s.sh + rows * kk;
  s.dzo = s.yo + rows * hh;
  s.dao = s.dzo + rows * kk;
  s.oc = s.dao + rows * hh;
  s.mk = s.oc + rows * kk;
  s.lohi = s.mk + rows;
  s.misc = s.lohi + 2 * d.k;
  s.total = s.misc + 4;
  return s;
}

__device__ __forceinline__ float sigmoid(float a) {
  return 1.0f / (1.0f + expf(-a));
}

__device__ __forceinline__ float softplus(float o) {
  return fmaxf(o, 0.0f) + log1pf(expf(-fabsf(o)));
}

__device__ __forceinline__ float normalized(float s, float lo, float hi) {
  return hi >= lo ? (s - lo) / (hi - lo + 1e-16f) : s;
}

// One ensemble member `d` (its table entry) on one row xr (in feature
// order) under params p: its hidden units into y, its RMSE and
// cross-entropy; with dz, m (z - x) of each visible unit in map order.
__device__ void member_row(const float* __restrict__ p, const int* d,
                           const int* feats, const float* xr, float* y,
                           float* s_out, float* ce_out, float* dz, float m) {
  const int n = d[0], h = d[1];
  const int* fi = feats + d[2];
  const float* W = p + d[3];
  const float* b = W + n * h;
  const float* c = b + h;
  for (int q = 0; q < h; ++q) {
    float acc = b[q];
    for (int j = 0; j < n; ++j) acc = fmaf(xr[fi[j]], W[j * h + q], acc);
    y[q] = sigmoid(acc);
  }
  float se = 0.0f, cs = 0.0f;
  for (int j = 0; j < n; ++j) {
    float o = c[j];
    for (int q = 0; q < h; ++q) o = fmaf(y[q], W[j * h + q], o);
    const float z = sigmoid(o), xj = xr[fi[j]], e = xj - z;
    se = fmaf(e, e, se);
    cs += softplus(o) - xj * o;
    if (dz != nullptr) dz[j] = m * (z - xj);
  }
  *s_out = sqrtf(se / static_cast<float>(n));
  *ce_out = cs;
}

struct FwdArgs {
  const float* x;
  long long ldx;
  const int* model_idx;
  const float* params;
  const float* stats;
  const int* table;
  float* stat;
  float* loss;
  int R, G, tile;
  Dims d;
};

__global__ void __launch_bounds__(kThreads) forward_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const Dims d = a.d;
  const FwdSmem at = fwd_smem(d, a.tile);
  int* T = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < d.table_len; i += kThreads) T[i] = a.table[i];
  const int k = d.k, D = d.D, ho = d.ho;
  const int xd = odd(D), hs = odd(d.Hs), kk = odd(k), hh = odd(ho);
  float* xs = smem + at.xs;
  float* ys = smem + at.ys;
  float* sv = smem + at.sv;
  float* ce = smem + at.ce;
  float* sh = smem + at.sh;
  float* yo = smem + at.yo;
  float* oc = smem + at.oc;
  int* mrow = reinterpret_cast<int*>(smem + at.mrow);
  const long long row0 = static_cast<long long>(blockIdx.x) * a.tile;
  const int rows = static_cast<int>(min(static_cast<long long>(a.tile),
                                        a.R - row0));
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int m = a.model_idx != nullptr ? a.model_idx[row0 + r] : 0;
    mrow[r] = (m >= 0 && m < a.G) ? m : -1;
  }
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, j = e - r * D;
    xs[r * xd + j] = a.x[(row0 + r) * a.ldx + j];
  }
  __syncthreads();
  const int* feats = T + kHeader + 5 * k;
  for (int it = threadIdx.x; it < k * rows; it += kThreads) {
    const int m = it / rows, r = it - m * rows;
    if (mrow[r] < 0) continue;
    const int* dm = T + kHeader + 5 * m;
    member_row(a.params + static_cast<long long>(mrow[r]) * d.P, dm, feats,
               xs + r * xd, ys + r * hs + dm[4], sv + r * kk + m,
               ce + r * kk + m, nullptr, 0.0f);
  }
  __syncthreads();
  for (int it = threadIdx.x; it < k * rows; it += kThreads) {
    const int i = it / rows, r = it - i * rows;
    if (mrow[r] < 0) continue;
    const float* st = a.stats + static_cast<long long>(mrow[r]) * d.Q;
    sh[r * kk + i] = normalized(sv[r * kk + i], st[i], st[k + i]);
  }
  __syncthreads();
  const int ow = T[5], ob = T[6], ocf = T[7];
  for (int it = threadIdx.x; it < ho * rows; it += kThreads) {
    const int q = it / rows, r = it - q * rows;
    if (mrow[r] < 0) continue;
    const float* p = a.params + static_cast<long long>(mrow[r]) * d.P;
    float acc = p[ob + q];
    for (int i = 0; i < k; ++i) acc = fmaf(sh[r * kk + i], p[ow + i * ho + q],
                                           acc);
    yo[r * hh + q] = sigmoid(acc);
  }
  __syncthreads();
  for (int it = threadIdx.x; it < k * rows; it += kThreads) {
    const int i = it / rows, r = it - i * rows;
    if (mrow[r] < 0) continue;
    const float* p = a.params + static_cast<long long>(mrow[r]) * d.P;
    float o = p[ocf + i];
    for (int q = 0; q < ho; ++q) o = fmaf(yo[r * hh + q], p[ow + i * ho + q],
                                          o);
    const float u = sh[r * kk + i], e = u - sigmoid(o);
    sv[r * kk + i] = e * e;
    oc[r * kk + i] = softplus(o) - u * o;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    float stat = nanf(""), loss = nanf("");
    if (mrow[r] >= 0) {
      float s2 = 0.0f, l = 0.0f;
      for (int i = 0; i < k; ++i) s2 += sv[r * kk + i];
      for (int m = 0; m < k; ++m) l += ce[r * kk + m];
      for (int i = 0; i < k; ++i) l += oc[r * kk + i];
      stat = s2 / static_cast<float>(k);
      loss = l;
    }
    a.stat[row0 + r] = stat;
    a.loss[row0 + r] = loss;
  }
}

struct TrainArgs {
  const float* x;
  long long ldx;
  const float* mask;
  long long ldm;
  const float* params;
  float* stats;
  const unsigned char* active;
  long long active_stride;
  const int* table;
  float* loss;
  float* grads;
  int R;
  Dims d;
};

__global__ void __launch_bounds__(kThreads) train_kernel(TrainArgs a) {
  extern __shared__ float smem[];
  const Dims d = a.d;
  const int R = a.R;
  const TrainSmem at = train_smem(d, R);
  const long long c = blockIdx.x;
  int* T = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < d.table_len; i += kThreads) T[i] = a.table[i];
  const int k = d.k, D = d.D, ho = d.ho, P = d.P;
  const int xd = odd(D), hs = odd(d.Hs), kk = odd(k), hh = odd(ho);
  float* ps = smem + at.ps;
  float* xs = smem + at.xs;
  float* ys = smem + at.ys;
  float* dz = smem + at.dz;
  float* da = smem + at.da;
  float* sv = smem + at.sv;
  float* ce = smem + at.ce;
  float* sh = smem + at.sh;
  float* yo = smem + at.yo;
  float* dzo = smem + at.dzo;
  float* dao = smem + at.dao;
  float* oc = smem + at.oc;
  float* mk = smem + at.mk;
  float* lohi = smem + at.lohi;
  float* misc = smem + at.misc;
  const float* pg = a.params + c * P;
  for (int i = threadIdx.x; i < P; i += kThreads) ps[i] = pg[i];
  const float* xc = a.x + c * a.ldx;
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, j = e - r * D;
    xs[r * xd + j] = xc[static_cast<long long>(r) * D + j];
  }
  for (int r = threadIdx.x; r < R; r += kThreads) mk[r] = a.mask[c * a.ldm + r];
  __syncthreads();
  if (threadIdx.x == 0) {
    float msum = 0.0f;
    for (int r = 0; r < R; ++r) msum += mk[r];
    misc[0] = 1.0f / msum;  // x / 0 where the mask is empty
  }
  const int* feats = T + kHeader + 5 * k;
  // the ensemble's forward, the masked output errors kept
  for (int it = threadIdx.x; it < k * R; it += kThreads) {
    const int m = it / R, r = it - m * R;
    const int* dm = T + kHeader + 5 * m;
    member_row(ps, dm, feats, xs + r * xd, ys + r * hs + dm[4],
               sv + r * kk + m, ce + r * kk + m, dz + r * xd + dm[2], mk[r]);
  }
  __syncthreads();
  // the running statistics, before the output autoencoder normalises
  const bool act = a.active == nullptr || a.active[c * a.active_stride] != 0;
  float* st = a.stats + c * d.Q;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    float lo = st[i], hi = st[k + i];
    if (act) {
      float mn = INFINITY, mx = -INFINITY;
      for (int r = 0; r < R; ++r) {
        if (mk[r] > 0.0f) {
          mn = fminf(mn, sv[r * kk + i]);
          mx = fmaxf(mx, sv[r * kk + i]);
        }
      }
      lo = fminf(lo, mn);
      hi = fmaxf(hi, mx);
      st[i] = lo;
      st[k + i] = hi;
    }
    lohi[i] = lo;
    lohi[k + i] = hi;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < k * R; it += kThreads) {
    const int i = it / R, r = it - i * R;
    sh[r * kk + i] = normalized(sv[r * kk + i], lohi[i], lohi[k + i]);
  }
  __syncthreads();
  const int ow = T[5], ob = T[6], ocf = T[7];
  // the output autoencoder's hidden units; the ensemble's hidden errors
  for (int it = threadIdx.x; it < ho * R; it += kThreads) {
    const int q = it / R, r = it - q * R;
    float acc = ps[ob + q];
    for (int i = 0; i < k; ++i) acc = fmaf(sh[r * kk + i], ps[ow + i * ho + q],
                                           acc);
    yo[r * hh + q] = sigmoid(acc);
  }
  for (int it = threadIdx.x; it < k * R; it += kThreads) {
    const int m = it / R, r = it - m * R;
    const int* dm = T + kHeader + 5 * m;
    const int n = dm[0], h = dm[1];
    const float* W = ps + dm[3];
    const float* e = dz + r * xd + dm[2];
    float* y = ys + r * hs + dm[4];
    float* g = da + r * hs + dm[4];
    for (int q = 0; q < h; ++q) {
      float t = 0.0f;
      for (int j = 0; j < n; ++j) t = fmaf(e[j], W[j * h + q], t);
      g[q] = t * (y[q] * (1.0f - y[q]));
    }
  }
  __syncthreads();
  for (int it = threadIdx.x; it < k * R; it += kThreads) {
    const int i = it / R, r = it - i * R;
    float o = ps[ocf + i];
    for (int q = 0; q < ho; ++q) o = fmaf(yo[r * hh + q], ps[ow + i * ho + q],
                                          o);
    const float u = sh[r * kk + i];
    dzo[r * kk + i] = mk[r] * (sigmoid(o) - u);
    oc[r * kk + i] = softplus(o) - u * o;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < ho * R; it += kThreads) {
    const int q = it / R, r = it - q * R;
    float t = 0.0f;
    for (int i = 0; i < k; ++i) t = fmaf(dzo[r * kk + i], ps[ow + i * ho + q],
                                         t);
    const float y = yo[r * hh + q];
    dao[r * hh + q] = t * (y * (1.0f - y));
  }
  __syncthreads();
  const float inv = misc[0];
  const int* owner = feats + D;
  float* gc = a.grads + c * P;
  for (int idx = threadIdx.x; idx < P; idx += kThreads) {
    const int m = owner[idx];
    float g = 0.0f;
    if (m < k) {
      const int* dm = T + kHeader + 5 * m;
      const int n = dm[0], h = dm[1], f = dm[2], y0 = dm[4];
      const int local = idx - dm[3];
      if (local < n * h) {
        const int j = local / h, q = local - j * h, fj = feats[f + j];
        for (int r = 0; r < R; ++r) {
          g = fmaf(xs[r * xd + fj], da[r * hs + y0 + q], g);
          g = fmaf(dz[r * xd + f + j], ys[r * hs + y0 + q], g);
        }
      } else if (local < n * h + h) {
        const int q = local - n * h;
        for (int r = 0; r < R; ++r) g += da[r * hs + y0 + q];
      } else {
        const int j = local - n * h - h;
        for (int r = 0; r < R; ++r) g += dz[r * xd + f + j];
      }
    } else {
      const int local = idx - ow;
      if (local < k * ho) {
        const int i = local / ho, q = local - i * ho;
        for (int r = 0; r < R; ++r) {
          g = fmaf(sh[r * kk + i], dao[r * hh + q], g);
          g = fmaf(dzo[r * kk + i], yo[r * hh + q], g);
        }
      } else if (local < k * ho + ho) {
        const int q = local - k * ho;
        for (int r = 0; r < R; ++r) g += dao[r * hh + q];
      } else {
        const int i = local - k * ho - ho;
        for (int r = 0; r < R; ++r) g += dzo[r * kk + i];
      }
    }
    gc[idx] = inv * g;
  }
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int r = 0; r < R; ++r) {
      float row = 0.0f;
      for (int m = 0; m < k; ++m) row += ce[r * kk + m];
      for (int i = 0; i < k; ++i) row += oc[r * kk + i];
      total += mk[r] * row;
    }
    a.loss[c] = inv * total;
  }
}

int set_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  return 0;
}

// Opts the kernel in to `bytes` of dynamic shared memory once it needs more
// than the default 48 KB (a host call: allowed while a stream captures).
template <typename K>
int allow_smem(K kernel, int bytes, int* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *allowed = bytes;
  return 0;
}

int g_fwd_allowed = 0;
int g_train_allowed = 0;

Dims make_dims(int k, int D, int Hs, int ho, int P, int Q, int table_len) {
  Dims d;
  d.k = k;
  d.D = D;
  d.Hs = Hs;
  d.ho = ho;
  d.P = P;
  d.Q = Q;
  d.table_len = table_len;
  return d;
}

}  // namespace

extern "C" {

// The forward's tile: the largest of 32, 16, 8 rows whose shared memory
// fits, halved (down to 8) until the launch has a CTA per SM; 0 if not
// even 8 rows fit.
int kitnet_forward_tile(int R, int sms, int k, int D, int Hs, int ho, int P,
                        int Q, int table_len) {
  const Dims d = make_dims(k, D, Hs, ho, P, Q, table_len);
  int tile = 32;
  while (tile >= 8 && 4 * fwd_smem(d, tile).total > kSmemMax) tile /= 2;
  if (tile < 8) return 0;
  while (tile > 8 && (R + tile - 1) / tile < sms) tile /= 2;
  return tile;
}

// Launches the forward on `stream` of `device`: ceil(R / tile) CTAs, over x
// [R, D] f32 (row stride ldx), model_idx [R] int32 or null (every row model
// 0), params [G, P] and stats [G, Q] f32, the table (int32, table_len); the
// statistic and the loss [R] f32 out (NaN where the row's model lies
// outside [0, G)). Returns cudaGetLastError() after the launch, or
// kErrTooWide when the tile's shared memory does not fit.
int kitnet_forward(const void* x, long long ldx, const void* model_idx,
                   const void* params, const void* stats, const void* table,
                   void* stat, void* loss, int R, int G, int tile, int k,
                   int D, int Hs, int ho, int P, int Q, int table_len,
                   int device, void* stream) {
  if (R < 1 || G < 1 || tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  int rc = set_device(device);
  if (rc != 0) return rc;
  FwdArgs a;
  a.x = static_cast<const float*>(x);
  a.ldx = ldx;
  a.model_idx = static_cast<const int*>(model_idx);
  a.params = static_cast<const float*>(params);
  a.stats = static_cast<const float*>(stats);
  a.table = static_cast<const int*>(table);
  a.stat = static_cast<float*>(stat);
  a.loss = static_cast<float*>(loss);
  a.R = R;
  a.G = G;
  a.tile = tile;
  a.d = make_dims(k, D, Hs, ho, P, Q, table_len);
  const int bytes = 4 * fwd_smem(a.d, tile).total;
  if (bytes > kSmemMax) return kErrTooWide;
  if ((rc = allow_smem(forward_kernel, bytes, &g_fwd_allowed)) != 0) return rc;
  const int ctas = (R + tile - 1) / tile;
  forward_kernel<<<ctas, kThreads, bytes,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launches the train step on `stream` of `device`: S CTAs, client c's rows
// x + c ldx ([R, D] f32, rows contiguous) with mask + c ldm ([R] f32), its
// params [P] (params [S, P] contiguous) and stats [Q] (updated in place
// where active, a bool [S] of element stride active_stride or null: every
// client); loss [S] and grads [S, P] f32 out. Returns cudaGetLastError()
// after the launch, or kErrTooWide when a client's batch does not fit in
// shared memory.
int kitnet_train(const void* x, long long ldx, const void* mask,
                 long long ldm, const void* params, void* stats,
                 const void* active, long long active_stride,
                 const void* table, void* loss, void* grads, int S, int R,
                 int k, int D, int Hs, int ho, int P, int Q, int table_len,
                 int device, void* stream) {
  if (S < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  int rc = set_device(device);
  if (rc != 0) return rc;
  TrainArgs a;
  a.x = static_cast<const float*>(x);
  a.ldx = ldx;
  a.mask = static_cast<const float*>(mask);
  a.ldm = ldm;
  a.params = static_cast<const float*>(params);
  a.stats = static_cast<float*>(stats);
  a.active = static_cast<const unsigned char*>(active);
  a.active_stride = active_stride;
  a.table = static_cast<const int*>(table);
  a.loss = static_cast<float*>(loss);
  a.grads = static_cast<float*>(grads);
  a.R = R;
  a.d = make_dims(k, D, Hs, ho, P, Q, table_len);
  const int bytes = 4 * train_smem(a.d, R).total;
  if (bytes > kSmemMax) return kErrTooWide;
  if ((rc = allow_smem(train_kernel, bytes, &g_train_allowed)) != 0) return rc;
  train_kernel<<<S, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* kitnet_error_string(int code) {
  if (code == kErrTooWide)
    return "the feature map or the batch needs more shared memory than a "
           "CTA has";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
