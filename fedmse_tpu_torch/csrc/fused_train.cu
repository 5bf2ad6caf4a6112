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
// activations (relu'(0) = 0). The epilogue normalizes as the TPU entry's
// host code does: inv_m = 1 / max(sum_r m_r, 0) (the reference's floor of
// 1e-38 is subnormal and flushed, so an all-masked client divides by 0 and
// gets NaN loss and grads), loss = inv_m (s_mse / D + lam s_zn) and
// grads = inv_m * partials, written straight to loss [G] and grads [G, P].
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s):
//   operations: forward 2 (DH + HL + LH + HD) = 13,176 FLOP per row and
//   backward 2 (2HD + 2LH + 2HL + DH) = 20,142 FLOP per row at 115/27/7:
//   33,318 FLOP per row;
//   bytes: x (4D or 2D per row), the mask (4 per row), each client's 6,764
//   f32 parameters read once, its 6,764 gradients and its loss written once.
// A local-training step of the main path (G = 5 clients, R = 12 rows) is
// ~2.0 MFLOP and ~0.30 MB: a bound of ~0.09 us. The step is latency, not
// work: a chain of dependent phases, each a few hundred cycles.
//
// Design. One thread-block cluster per client; CTA c of a cluster of C
// (chosen by the wrapper, 1 <= C <= min(8, H)) owns the contiguous slice
// Hc = [c H / C, (c + 1) H / C) of the H hidden units. That slice carries
// W1[:, Hc], b1[Hc], W2[Hc, :], W3[:, Hc], b3[Hc], W4[Hc, :], their
// gradients, and the activations h1, h2, da3, da1 of its units, so every
// product but three stays inside the CTA. The three sums that cross CTAs,
//   z = sum_c h1[:, Hc] W2[Hc, :]      recon = sum_c h2[:, Hc] W4[Hc, :]
//   dz = sum_c cast(da3[:, Hc]) W3[:, Hc]^T,
// go through distributed shared memory and are summed in rank order 0, 1,
// ..., C - 1. Each CTA pushes its partials with st.async into receive
// slots of the CTAs that sum them; every st.async counts its bytes on the
// receiver's mbarrier, and a receiver waits on its own mbarrier for the
// bytes of the tile. No cluster-wide barrier (whose release fence costs
// ~900 cycles on an H100) and no remote read is on the path; one relaxed
// cluster barrier at the start makes the mbarriers' initialization
// visible. The small partials (z and dz, T x L) go to every CTA, which sums
// its C slots. The large one (recon, T x D) is split by columns: CTA c
// also owns the columns Dc = [c D / C, (c + 1) D / C), receives the C
// partials of those columns only, sums them, forms err, its part of the
// loss and dr = (-2/D) m err there, and pushes dr of its columns to every
// CTA, which then holds the whole dr. Rank 0 sums the C parts of the
// squared error at the end; b2, its gradient and the loss are rank 0's;
// b4's gradient is split with the columns. At the main path's G = 5 and
// H = 27 this is 8 CTAs of 512 threads per client (slices of 3 or 4 units,
// 14 or 15 columns): 40 CTAs, where one CTA per client would leave 127 of
// the 132 SMs idle. From 17 clients on the cluster shrinks, and at C = 1
// (67 clients and more) a CTA has 256 threads, so two fit an SM.
//   The step is a chain of short phases, so each phase's latency is what the
// design cuts. Every index is walked without a division (the quotient and
// remainder of the thread's first index and of the block's stride are
// taken once). The dots that are D long (x W1[:, Hc] and cast(dr)
// W4[Hc, :]^T) are split over the lanes of a segment of 4 to 32 lanes, four
// independent accumulators per lane, joined by a fixed xor shuffle tree;
// ||z|| takes a segment per row; each CTA's squared error is a tree over
// its threads and warps; the tile's loss sums are one warp over the rows.
// No thread walks a D-long dot alone or sums the loss partials serially.
// Each gradient element is owned by one thread, which sums its rows in
// order, tile after tile, in shared memory. Loops that run a few times per
// tile are not unrolled: the whole step is one pass over the kernel's code,
// so its size is fetch time.
//   Each CTA stages only its parameter slice (about 4.4 KB at 115/27/7 and
// C = 8) with cp.async, together with the row tile's x (f32: cp.async; bf16
// goes through registers, as cp.async moves 4, 8 or 16 bytes) and its mask.
// The cluster walks all R rows in tiles of up to 32, so a client of any R
// is one launch and one kernel: no second pass, no scratch buffer.
//   Determinism and precision: no atomics, no TF32, no --use_fast_math; every
// sum has a fixed order, so two runs give the same bits. f32 products run on
// FMA. The bf16 products could run on mma.sync.m16n8k16 (bf16 operands, f32
// accumulation is exactly the recipe), but at the main path's 12 rows a
// CTA's products are 12 x 4 x 115 MACs, latency-bound, and rows would pad
// to 16: the kernel keeps FMA in both modes.
//   Shared memory per CTA, in floats, with hm = ceil(H / C) and
// dm = ceil(D / C): 2 (2 hm (D + L) + 2 hm + L + D) + D + 28 + warps
// + tile (2 D + C dm + 2 (C + 1) L + 4 hm + 3); a model whose one-row tile
// does not fit the card's 227 KB is refused as too wide (at H = 8, L = 4,
// C = 8: about 4 (10 D + 150) bytes, D above about 5,800).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxTile = 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxDevices = 64;
constexpr int kErrTooWide = 1000;  // the model does not fit shared memory
// mbarriers at the start of shared memory: one per exchange of a tile, and
// one for the squared-error parts that rank 0 gathers at the end
enum Barrier { kBarZ, kBarRecon, kBarDr, kBarDz, kBarLoss, kBarriers };
constexpr int kBarrierBytes = 64;

// per device: the opt-in shared memory per block, and whether each kernel
// instance has been allowed to use it
std::atomic<int> g_optin[kMaxDevices];
std::atomic<int> g_attr_set[4][kMaxDevices];

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy from global to shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The same shared-memory address in the CTA of the given cluster rank.
__device__ __forceinline__ uint32_t peer(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Store v at a peer's address and count its 4 bytes on the peer's mbarrier.
__device__ __forceinline__ void push(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// The one local arrival of a phase, with the bytes the phase waits for.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of the given parity; acquire at cluster scope, where
// st.async releases its bytes.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// x rows of a tile into shared memory: f32 by cp.async, bf16 through
// registers (upcast exactly).
template <int kThreads>
__device__ __forceinline__ void stage_x(float* xs, const float* src, int n) {
#pragma unroll 1
  for (int i = threadIdx.x; i < n; i += kThreads) cp_async4(xs + i, src + i);
}
template <int kThreads>
__device__ __forceinline__ void stage_x(float* xs, const __nv_bfloat16* src,
                                        int n) {
#pragma unroll 1
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kThreads) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = i < n ? load(src + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * kThreads < n) xs[i0 + u * kThreads] = v[u];
  }
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

// Sum of v over the `width` lanes of an aligned segment of a warp (width a
// power of two <= 32) by a fixed xor tree: every lane of the segment gets
// the same bits. All 32 lanes of the warp call it together.
__device__ __forceinline__ float segment_sum(float v, int width) {
#pragma unroll 1
  for (int o = width >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lanes per segment for `items` segments' work over the block: the widest
// power of two from 4 to 32 with which each item gets its own segment,
// else 4.
template <int kThreads>
__device__ __forceinline__ int segment_width(int items) {
  int w = 32;
  while (w > 4 && w * items > kThreads) w >>= 1;
  return w;
}

// For r < n, j < J: fin(r J + j, j, sum_k cast(a[r K + k]) b[j K + k]), each
// dot split over the `width` lanes of a segment (lane l takes k = l,
// l + width, ... into four accumulators in turn) and joined by
// segment_sum. Every thread runs the same number of rounds, so the shuffles
// stay convergent.
template <int kThreads, typename Cast, typename Fin>
__device__ __forceinline__ void segment_dots(const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             int n, int J, int K, Cast cast,
                                             Fin fin) {
  const int width = segment_width<kThreads>(n * J);
  const int seg = threadIdx.x / width, lane = threadIdx.x - seg * width;
  const int segments = kThreads / width, total = n * J;
  Walk w(seg, segments, J);
#pragma unroll 1
  for (int o = seg; o - seg < total; o += segments, w.next()) {
    float acc = 0.f;
    if (o < total) {
      const float* ar = a + w.a * K;
      const float* bj = b + w.b * K;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int k = lane;
#pragma unroll 1
      for (; k + 3 * width < K; k += 4 * width) {
        a0 = fmaf(cast(ar[k]), bj[k], a0);
        a1 = fmaf(cast(ar[k + width]), bj[k + width], a1);
        a2 = fmaf(cast(ar[k + 2 * width]), bj[k + 2 * width], a2);
        a3 = fmaf(cast(ar[k + 3 * width]), bj[k + 3 * width], a3);
      }
#pragma unroll 1
      for (; k < K; k += width) a0 = fmaf(cast(ar[k]), bj[k], a0);
      acc = (a0 + a1) + (a2 + a3);
    }
    acc = segment_sum(acc, width);
    if (o < total && lane == 0) fin(o, w.b, acc);
  }
}

// For r < n, x < X: fin(r X + x, r, x, sum_{j < J} cast(a[r J + j]) b[j X + x]),
// one thread per output; `w` walks p = r X + x from the thread's index.
template <int kThreads, typename Cast, typename Fin>
__device__ __forceinline__ void rows_times(const float* __restrict__ a,
                                           const float* __restrict__ b, int n,
                                           int J, int X, Walk w, Cast cast,
                                           Fin fin) {
#pragma unroll 1
  for (int p = threadIdx.x; p < n * X; p += kThreads, w.next()) {
    const float* ar = a + w.a * J;
    const float* bx = b + w.b;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < J; ++j) acc = fmaf(cast(ar[j]), bx[j * X], acc);
    fin(p, w.a, w.b, acc);
  }
}

// For r < n, j < J: fin(r J + j, j, sum_{k < K} cast(a[r K + k]) b[j K + k]),
// one thread per output (K short); `w` walks o = r J + j.
template <int kThreads, typename Cast, typename Fin>
__device__ __forceinline__ void rows_dot_rows(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              int n, int J, int K, Walk w,
                                              Cast cast, Fin fin) {
#pragma unroll 1
  for (int o = threadIdx.x; o < n * J; o += kThreads, w.next()) {
    const float* ar = a + w.a * K;
    const float* bj = b + w.b * K;
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) acc = fmaf(cast(ar[k]), bj[k], acc);
    fin(o, w.b, acc);
  }
}

// G[j X + x] += sum_{r < n} ca(a[r J + j]) cb(b[r X + x]) for j < J, x < X:
// one thread per gradient element, rows in order; thread t of the loop
// (any numbering of the block's threads) starts at e = t, and `w` walks
// e = j X + x from there.
template <int kThreads, typename CA, typename CB>
__device__ __forceinline__ void grad_atb(int t, const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         float* __restrict__ G, int n, int J,
                                         int X, Walk w, CA ca, CB cb) {
#pragma unroll 1
  for (int e = t; e < J * X; e += kThreads, w.next()) {
    const float* aj = a + w.a;
    const float* bx = b + w.b;
    float acc = 0.f;
#pragma unroll 4
    for (int r = 0; r < n; ++r) acc = fmaf(ca(aj[r * J]), cb(bx[r * X]), acc);
    G[e] += acc;
  }
}

// G[x] += sum_{r < n} a[r stride + x] for x < X, rows in order; thread t
// of the loop starts at x = t.
template <int kThreads>
__device__ __forceinline__ void col_sums(int t, const float* __restrict__ a,
                                         float* __restrict__ G, int n, int X,
                                         int stride) {
#pragma unroll 1
  for (int x = t; x < X; x += kThreads) {
    float acc = 0.f;
#pragma unroll 4
    for (int r = 0; r < n; ++r) acc += a[r * stride + x];
    G[x] += acc;
  }
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

// Floats of a CTA's parameter slice for hc hidden units (and of its
// gradient slice): W1[:, Hc] and W4[Hc, :], W2[Hc, :] and W3[:, Hc],
// b1[Hc] and b3[Hc], then room for b2 and b4.
__host__ __device__ __forceinline__ int slice_floats(const Layout& s, int hc) {
  return 2 * hc * (s.D + s.L) + 2 * hc + s.L + s.D;
}

// f(index in the slice, offset in the flat row, is a weight) for each
// element of the slice [h0, h0 + hc) that this thread handles, the same
// elements on every call with the same arguments. The slice's order:
// W1[:, Hc] as [hc][D], W2[Hc, :] as [hc][L], W3[:, Hc] as [hc][L],
// W4[Hc, :] as [hc][D], b1[Hc], b3[Hc], b2 (with_b2), b4 (its columns
// [b4_lo, b4_hi) at their own places). W1 and W3 are read along rows,
// j fastest, so neighbouring threads touch neighbouring addresses.
template <int kThreads, typename F>
__device__ __forceinline__ void for_slice(const Layout& s, int h0, int hc,
                                          bool with_b2, int b4_lo, int b4_hi,
                                          F f) {
  const int D = s.D, H = s.H, L = s.L, tid = threadIdx.x;
  Walk w(tid, kThreads, hc);  // e = k hc + j
#pragma unroll 1
  for (int e = tid; e < D * hc; e += kThreads, w.next())
    f(w.b * D + w.a, s.w1 + w.a * H + h0 + w.b, true);
  int base = hc * D;
#pragma unroll 1
  for (int e = tid; e < hc * L; e += kThreads)
    f(base + e, s.w2 + h0 * L + e, true);
  base += hc * L;
  w = Walk(tid, kThreads, hc);  // e = l hc + j
#pragma unroll 1
  for (int e = tid; e < L * hc; e += kThreads, w.next())
    f(base + w.b * L + w.a, s.w3 + w.a * H + h0 + w.b, true);
  base += hc * L;
#pragma unroll 1
  for (int e = tid; e < hc * D; e += kThreads)
    f(base + e, s.w4 + h0 * D + e, true);
  base += hc * D;
#pragma unroll 1
  for (int j = tid; j < hc; j += kThreads) {
    f(base + j, s.b1 + h0 + j, false);
    f(base + hc + j, s.b3 + h0 + j, false);
  }
  base += 2 * hc;
  if (with_b2) {
#pragma unroll 1
    for (int l = tid; l < L; l += kThreads) f(base + l, s.b2 + l, false);
  }
#pragma unroll 1
  for (int i = b4_lo + tid; i < b4_hi; i += kThreads)
    f(base + L + i, s.b4 + i, false);
}

// Shared memory: the barriers, then (at offsets that are the same in every
// CTA, as peers write there) the receive slots and the gathered dr, then
// the CTA's own buffers.
size_t smem_bytes(const Layout& s, int C, int threads, int tile) {
  const int hm = (s.H + C - 1) / C, dm = (s.D + C - 1) / C;
  const size_t per_row =
      2 * s.D + C * dm + 2 * (C + 1) * s.L + 4 * hm + 3;
  const size_t fixed = 2 * static_cast<size_t>(slice_floats(s, hm)) + 4 +
                       kMaxCluster + s.D + threads / 32;
  return kBarrierBytes + sizeof(float) * (fixed + tile * per_row);
}

template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
    fused_ae_train_kernel(const T* __restrict__ x, long long x_stride,
                          const float* __restrict__ mask, long long m_stride,
                          const float* __restrict__ params,
                          float* __restrict__ loss,
                          float* __restrict__ grads, int R, Layout s,
                          int tile, float lam) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.x / C;
  const int D = s.D, H = s.H, L = s.L, P = s.P;
  const int h0 = c * H / C, hc = (c + 1) * H / C - h0;
  const int d0 = c * D / C, dc = (c + 1) * D / C - d0;
  const int hm = (H + C - 1) / C, dm = (D + C - 1) / C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kWarps = kThreads / 32;
  const T* tag = nullptr;  // selects the to_compute overload

  const uint32_t bars = smem_addr(smem_raw);  // kBarriers mbarriers, 8 bytes each
  float* zr = reinterpret_cast<float*>(smem_raw + kBarrierBytes);
  float* rr = zr + C * tile * L;       // [C][tile][dm]: recon parts, own columns
  float* dzr = rr + C * tile * dm;     // [C][tile][L]: cast(da3) W3^T parts
  float* dr = dzr + C * tile * L;      // [tile][D]: dL~/drecon, gathered
  float* lse = dr + tile * D;          // [kMaxCluster]: squared-error parts
  int* owner = reinterpret_cast<int*>(lse + kMaxCluster);  // [D]: column's rank, index
  float* w = reinterpret_cast<float*>(owner + D);  // the parameter slice
  float* acc = w + slice_floats(s, hm);            // its gradient, then 3 sums
  float* xs = acc + slice_floats(s, hm) + 4;       // [tile][D]: x
  float* h1 = xs + tile * D;           // [tile][hc]
  float* h2 = h1 + tile * hm;          // [tile][hc]
  float* da3 = h2 + tile * hm;         // [tile][hc]
  float* da1 = da3 + tile * hm;        // [tile][hc]
  float* zs = da1 + tile * hm;         // [tile][L]: z (f32)
  float* dz = zs + tile * L;           // [tile][L]
  float* ms = dz + tile * L;           // [tile]: row mask
  float* inv = ms + tile;              // [tile]: safe 1 / ||z||
  float* rzn = inv + tile;             // [tile]: m ||z||
  float* sew = rzn + tile;             // [kWarps]: the tile's squared error

  const float *W1 = w, *W2 = W1 + hc * D, *W3 = W2 + hc * L;
  const float *W4 = W3 + hc * L, *B1 = W4 + hc * D, *B3 = B1 + hc;
  const float *B2 = B3 + hc, *B4 = B2 + L;
  float *G1 = acc, *G2 = G1 + hc * D, *G3 = G2 + hc * L, *G4 = G3 + hc * L;
  float *GB1 = G4 + hc * D, *GB3 = GB1 + hc, *GB2 = GB3 + hc, *GB4 = GB2 + L;
  float* sums = GB4 + D;  // this CTA's squared error, s_zn, sum_r m_r

  // the copies first: the parameter slice, and the first tile below
  const float* pg = params + static_cast<int64_t>(g) * P;
  for_slice<kThreads>(s, h0, hc, true, d0, d0 + dc, [&](int i, int off, bool) {
    cp_async4(w + i, pg + off);
  });
  const T* xg = x + static_cast<int64_t>(g) * x_stride;
  const float* mg = mask + static_cast<int64_t>(g) * m_stride;
  const int rev = kThreads - 1 - tid;  // numbers a phase's second loop
  if (rev == 0) {  // the last thread stages the least
#pragma unroll 1
    for (int b = 0; b < kBarriers; ++b) bar_init(bars + 8 * b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (c == 0) bar_expect(bars + 8 * kBarLoss, 4 * C);
  }
  // peers may signal these barriers once every CTA has passed the wait
  // before the first push
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const float coef = static_cast<float>(-2.0 / D);
  const auto ident = [](float v) { return v; };
  const auto cast = [tag](float v) { return to_compute(v, tag); };
  const Walk walk_d(tid, kThreads, D), walk_l(tid, kThreads, L);
  const Walk walk_h(tid, kThreads, hc), walk_lr(rev, kThreads, L);
#pragma unroll 1
  for (int e = tid; e < slice_floats(s, hc) + 3; e += kThreads) acc[e] = 0.f;
#pragma unroll 1
  for (int i = tid; i < D; i += kThreads) {
    const int q = ((i + 1) * C + D - 1) / D - 1;
    owner[i] = q | ((i - q * D / C) << 8);
  }
  const int norm_width = L <= 4 ? 4 : (L <= 8 ? 8 : (L <= 16 ? 16 : 32));

  uint32_t parity = 0;
#pragma unroll 1
  for (int t0 = 0; t0 < R; t0 += tile, parity ^= 1) {
    const int n = min(tile, R - t0);
    if (rev == 0) {  // the bytes this tile's four exchanges bring here
      bar_expect(bars + 8 * kBarZ, 4 * C * n * L);
      bar_expect(bars + 8 * kBarRecon, 4 * C * n * dc);
      bar_expect(bars + 8 * kBarDr, 4 * n * D);
      bar_expect(bars + 8 * kBarDz, 4 * C * n * L);
    }
    stage_x<kThreads>(xs, xg + static_cast<int64_t>(t0) * D, n * D);
#pragma unroll 1
    for (int r = tid; r < n; r += kThreads) cp_async4(ms + r, mg + t0 + r);
    cp_async_wait_all();
    __syncthreads();
    if (t0 == 0 && sizeof(T) == 2) {  // weights (the slice's first floats)
#pragma unroll 1
      for (int e = tid; e < 2 * hc * (D + L); e += kThreads)
        w[e] = to_compute(w[e], tag);
      __syncthreads();
    }

    // ---- forward --------------------------------------------------------
    segment_dots<kThreads>(xs, W1, n, hc, D, ident,  // h1 = cast(relu(x W1 + b1))
                           [&](int o, int j, float a) {
                             h1[o] = to_compute(relu(a + B1[j]), tag);
                           });
    __syncthreads();
    if (t0 == 0) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    rows_times<kThreads>(h1, W2, n, hc, L, walk_l, ident,  // z parts to all
                         [&](int p, int, int, float a) {
                           const uint32_t at = smem_addr(zr + c * tile * L + p);
#pragma unroll 1
                           for (int q = 0; q < C; ++q)
                             push(peer(at, q), a, peer(bars + 8 * kBarZ, q));
                         });
    bar_wait(bars + 8 * kBarZ, parity);
    {
      Walk wl = walk_l;
#pragma unroll 1
      for (int p = tid; p < n * L; p += kThreads, wl.next()) {  // z
        float a = zr[p];
#pragma unroll 1
        for (int q = 1; q < C; ++q) a += zr[q * tile * L + p];
        zs[p] = a + B2[wl.b];
      }
    }
    __syncthreads();
    rows_dot_rows<kThreads>(zs, W3, n, hc, L, walk_h, cast,  // h2 = cast(relu(cast(z) W3 + b3))
                            [&](int o, int j, float a) {
                              h2[o] = to_compute(relu(a + B3[j]), tag);
                            });
    {  // ||z||, a segment per row, numbered from the block's last thread
      const int seg = rev / norm_width, sl = rev - seg * norm_width;
#pragma unroll 1
      for (int r0 = 0; r0 < n; r0 += kThreads / norm_width) {
        const int r = r0 + seg;
        float sq = 0.f;
        if (r < n) {
#pragma unroll 1
          for (int l = sl; l < L; l += norm_width)
            sq += zs[r * L + l] * zs[r * L + l];
        }
        sq = segment_sum(sq, norm_width);
        if (r < n && sl == 0) {
          const float nz = sq > 0.f ? 1.f : 0.f;
          const float zn = sqrtf(sq > 0.f ? sq : 1.f) * nz;
          inv[r] = nz / (sq > 0.f ? zn : 1.f);
          rzn[r] = ms[r] * zn;
        }
      }
    }
    __syncthreads();
    rows_times<kThreads>(h2, W4, n, hc, D, walk_d, ident,  // recon parts to the column owners
                         [&](int, int r, int i, float a) {
                           const int q = owner[i] & 0xff, k = owner[i] >> 8;
                           const uint32_t at =
                               smem_addr(rr + (c * tile + r) * dm + k);
                           push(peer(at, q), a, peer(bars + 8 * kBarRecon, q));
                         });
    bar_wait(bars + 8 * kBarRecon, parity);
    float se = 0.f;  // own columns: err, the squared error, dr to all
    if (dc > 0) {
      Walk wc(tid, kThreads, dc);
#pragma unroll 1
      for (int p = tid; p < n * dc; p += kThreads, wc.next()) {
        const int r = wc.a, k = wc.b, i = d0 + k;
        float a = rr[r * dm + k];
#pragma unroll 1
        for (int q = 1; q < C; ++q) a += rr[(q * tile + r) * dm + k];
        const float err = xs[r * D + i] - (a + B4[i]);
        const float m = ms[r];
        se += m * (err * err);
        const float v = coef * (m * err);
        const uint32_t at = smem_addr(dr + r * D + i);
#pragma unroll 1
        for (int q = 0; q < C; ++q)
          push(peer(at, q), v, peer(bars + 8 * kBarDr, q));
      }
    }
    se = segment_sum(se, 32);
    if (lane == 0) sew[warp] = se;
    bar_wait(bars + 8 * kBarDr, parity);

    // ---- backward: each gradient element is owned by one thread ---------
    segment_dots<kThreads>(dr, W4, n, hc, D, cast,  // da3 = [h2 > 0] cast(dr) W4^T
                           [&](int o, int, float a) {
                             da3[o] = h2[o] > 0.f ? a : 0.f;
                           });
    grad_atb<kThreads>(tid, h2, dr, G4, n, hc, D, walk_d, ident, cast);  // dW4 = h2^T cast(dr)
    col_sums<kThreads>(rev, dr + d0, GB4 + d0, n, dc, D);  // db4 = sum_r dr, own columns
    __syncthreads();
    if (warp == kWarps - 1) {  // the tile's loss sums and mask sum, one tree each
      float a = 0.f, b = 0.f, mm = 0.f;
#pragma unroll 1
      for (int v = lane; v < kWarps; v += 32) a += sew[v];
#pragma unroll 1
      for (int r = lane; r < n; r += 32) {
        b += rzn[r];
        mm += ms[r];
      }
      a = segment_sum(a, 32);
      b = segment_sum(b, 32);
      mm = segment_sum(mm, 32);
      if (lane == 0) {
        sums[0] += a;
        sums[1] += b;
        sums[2] += mm;
      }
    }
    rows_times<kThreads>(da3, W3, n, hc, L, walk_l, cast,  // dz parts to all
                         [&](int p, int, int, float a) {
                           const uint32_t at = smem_addr(dzr + c * tile * L + p);
#pragma unroll 1
                           for (int q = 0; q < C; ++q)
                             push(peer(at, q), a, peer(bars + 8 * kBarDz, q));
                         });
    grad_atb<kThreads>(rev, da3, zs, G3, n, hc, L, walk_lr, cast, cast);  // dW3 = cast(z)^T cast(da3)
    col_sums<kThreads>(rev, da3, GB3, n, hc, hc);  // db3 = sum_r da3
    bar_wait(bars + 8 * kBarDz, parity);
    {
      Walk wl = walk_l;
#pragma unroll 1
      for (int p = tid; p < n * L; p += kThreads, wl.next()) {  // dz
        float a = dzr[p];
#pragma unroll 1
        for (int q = 1; q < C; ++q) a += dzr[q * tile * L + p];
        const int r = wl.a;
        dz[p] = a + ((lam * ms[r]) * zs[p]) * inv[r];
      }
    }
    __syncthreads();
    rows_dot_rows<kThreads>(dz, W2, n, hc, L, walk_h, cast,  // da1 = [h1 > 0] cast(dz) W2^T
                            [&](int o, int, float a) {
                              da1[o] = h1[o] > 0.f ? a : 0.f;
                            });
    grad_atb<kThreads>(rev, h1, dz, G2, n, hc, L, walk_lr, ident, cast);  // dW2 = h1^T cast(dz)
    if (c == 0) col_sums<kThreads>(rev, dz, GB2, n, L, L);  // db2 = sum_r dz
    __syncthreads();
    grad_atb<kThreads>(tid, da1, xs, G1, n, hc, D, walk_d, cast, ident);  // dW1 = x^T cast(da1)
    col_sums<kThreads>(rev, da1, GB1, n, hc, hc);  // db1 = sum_r da1
    __syncthreads();  // the next tile overwrites every row buffer
  }

  // ---- epilogue: normalize as the TPU entry's host code, write out ------
  // (each CTA's squared error goes to rank 0, which sums the parts once
  // its own writes are out)
  if (rev == 0)
    push(peer(smem_addr(lse + c), 0), sums[0], peer(bars + 8 * kBarLoss, 0));
  const float msum = sums[2];
  const float inv_m = 1.f / (msum < 0.f ? 0.f : msum);
  float* og = grads + static_cast<int64_t>(g) * P;
  for_slice<kThreads>(s, h0, hc, c == 0, d0, d0 + dc,
                      [&](int i, int off, bool) { og[off] = inv_m * acc[i]; });
  if (c == 0 && warp == kWarps - 1) {  // one tree over the C parts
    bar_wait(bars + 8 * kBarLoss, 0);
    const float s_mse = segment_sum(lane < C ? lse[lane] : 0.f, 32);
    if (rev == 0)
      loss[g] = inv_m * (s_mse / static_cast<float>(D) + lam * sums[1]);
  }
}

template <typename T, int kThreads>
int launch(const void* x, long long x_stride, const void* mask,
           long long m_stride, const void* params, void* loss, void* grads,
           int G, int R, const Layout& s, int C, float lam, int device,
           int optin, cudaStream_t stream) {
  int tile = R < kMaxTile ? R : kMaxTile;
  while (tile > 1 && smem_bytes(s, C, kThreads, tile) >
                         static_cast<size_t>(optin))
    tile /= 2;
  const size_t smem = smem_bytes(s, C, kThreads, tile);
  if (smem > static_cast<size_t>(optin)) return kErrTooWide;
  std::atomic<int>& attr_set =
      g_attr_set[2 * (sizeof(T) == 2) + (kThreads == 512)][device];
  cudaError_t err;
  if (!attr_set.load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(fused_ae_train_kernel<T, kThreads>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set.store(1, std::memory_order_relaxed);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(G * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_ae_train_kernel<T, kThreads>,
                           static_cast<const T*>(x), x_stride,
                           static_cast<const float*>(mask), m_stride,
                           static_cast<const float*>(params),
                           static_cast<float*>(loss),
                           static_cast<float*>(grads), R, s, tile, lam);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// A cluster of one CTA per client runs 256 threads, so that two CTAs share
// an SM when the clients alone fill the card; a wider cluster runs 512.
template <typename T>
int launch_any(const void* x, long long x_stride, const void* mask,
               long long m_stride, const void* params, void* loss,
               void* grads, int G, int R, int D, int H, int L, int C,
               float lam, int device, cudaStream_t stream) {
  if (C < 1 || C > kMaxCluster || C > H || device < 0 ||
      device >= kMaxDevices || static_cast<long long>(G) * C > INT_MAX ||
      D >= (1 << 23))
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = g_optin[device].load(std::memory_order_relaxed);
  if (optin == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_optin[device].store(optin, std::memory_order_relaxed);
  }
  const Layout s = make_layout(D, H, L);
  if (C == 1)
    return launch<T, 256>(x, x_stride, mask, m_stride, params, loss, grads,
                          G, R, s, C, lam, device, optin, stream);
  return launch<T, 512>(x, x_stride, mask, m_stride, params, loss, grads, G,
                        R, s, C, lam, device, optin, stream);
}

}  // namespace

extern "C" {

// Launches the fused train step on `stream` of `device` as G clusters of
// `cluster` CTAs (1 <= cluster <= min(8, H)); returns cudaGetLastError()
// after the launch (0 on success), or 1000 when a one-row tile with the
// parameter and gradient slices does not fit in shared memory. x is
// [G, R, D] (bf16 when bf16 != 0, else f32) with client stride x_stride
// elements and row stride D; mask is f32 [G, R] with client stride
// m_stride; params is f32 [G, P]; loss is f32 [G] and grads f32 [G, P],
// both written whole (normalized by 1 / sum of the client's mask). The
// caller guarantees G, R > 0.
int fused_ae_train(const void* x, long long x_stride, const void* mask,
                   long long m_stride, const void* params, void* loss,
                   void* grads, int G, int R, int D, int H, int L,
                   int cluster, float lam, int bf16, int device,
                   void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      bf16 ? launch_any<__nv_bfloat16>(x, x_stride, mask, m_stride, params,
                                       loss, grads, G, R, D, H, L, cluster,
                                       lam, device, s)
           : launch_any<float>(x, x_stride, mask, m_stride, params, loss,
                               grads, G, R, D, H, L, cluster, lam, device, s);
  if (current != device) cudaSetDevice(current);
  return rc;
}

const char* fused_ae_train_error_string(int code) {
  if (code == kErrTooWide)
    return "the model's parameter and gradient slices and one row of "
           "buffers do not fit in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
