// Batch norm and conditional batch norm, with the ReLU that follows them,
// forward and backward: the SNGAN generators' normalisations.
//
// Replaces no TPU kernel: the JAX package's norms
// (gan_lib_tensorflow_tpu/ops/norms.py) are plain jnp, which XLA fuses into
// the convolutions' neighbours. In eager PyTorch the same arithmetic was
// about 20 ATen passes forward and 30 backward, each moving a float32 copy
// of the activation through a broadcasting kernel; these kernels move each
// element the fewest times the algorithm allows.
//
// Semantics (ops/norms.py, the wrapper, holds the plain version):
//   statistics per (group, channel) over the group's samples and H*W, in
//   float32: mean = sum(x) / n, var = max(sum(x^2) / n - mean^2, 0),
//   rstd = rsqrt(var + eps); y = ((x - mean) * rstd) * gamma[s, c] +
//   beta[s, c], rounded to the output type, then ReLU when asked. gamma and
//   beta are per-sample rows (conditional BN's class embeddings, or the
//   affine weight and bias with a row stride of 0), or absent.
//   y's products and sums are rounded one at a time (no fused multiply-add),
//   in the plain version's order; the running statistics advance as
//   keep * running + take * stat with one fused multiply-add, as ATen's
//   add_(stat, alpha=take) computes it on the card.
//
// Bound. Every pass reads or writes each element once and does a few flops
// per element, far below the card's flop/byte ratio: HBM bytes bound it.
// Forward 6 bytes per bf16 element (x read by the statistics pass, x read
// and y written by the apply pass), backward 10 (x and dy read by the
// reduction pass, x and dy read and dx written by the apply pass).
//
// Design.
//   - Layouts: channels-last ([N, H, W, C] in memory, and [N, C]) and
//     NCHW-contiguous. Each thread keeps a fixed set of channels and walks
//     rows: in channels-last a thread owns V neighbouring channels and loads
//     V elements (16 bytes of bf16) of one row at a time; in NCHW a warp owns
//     one (sample, channel) plane and its lanes load V neighbouring elements
//     along H*W. So every per-channel constant (mean, rstd, gamma, beta) is
//     loaded once per thread, outside the streaming loop. V is 8, or 1 when
//     C (channels-last) or H*W (NCHW) is not a multiple of 8 or a pointer is
//     off a 16-byte boundary.
//   - Grid: one block (channels-last) or one warp (NCHW) per (sample, chunk
//     of H*W, channel tile); the wrapper picks the chunk count from the row
//     count and the SM count, so a few waves of blocks cover the card
//     whatever the shape. Four vectors of x (and four of dy) in flight per
//     thread, kept packed (4 registers per 16 bytes) until used.
//   - Reductions are deterministic and use no float atomics: each block
//     writes its partial sums per (sample, channel), and a second kernel
//     adds them in a fixed order, one warp per output (lanes over samples,
//     then a fixed xor tree). The partial sums per (sample, channel) are
//     also what the backward needs for conditional BN's gamma/beta rows.
//   - Inside a sharded step the wrapper all-reduces the [2, groups, C] sums
//     between the reduction and the apply pass; the apply pass computes
//     mean and rstd from them, and the backward recomputes them the same way
//     (nothing but x, the sums and the gamma/beta rows is saved).
//   - The backward recomputes the ReLU mask from the forward's arithmetic:
//     masked where y rounded to the output type is <= 0 (PyTorch's
//     threshold_backward on the ReLU's result), tested on the float32 y
//     against the largest value that rounds to 0 (relu_zero).
//
// Kernel names avoid "conv", "gemm", "copy", "pool", "sort", "reduce_kernel"
// and "elementwise", so a profile's kind table does not count them as
// PyTorch's own kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;    // vectors of x (and of dy) in flight per thread
constexpr int kF32 = 0;       // dtype codes, as the wrapper passes them
constexpr int kBF16 = 1;
constexpr int kChannelsLast = 0;
constexpr int kNCHW = 1;

struct Params {
  const void* x;
  const void* dy;          // backward only
  void* out;               // y (forward) or dx (backward)
  const float* gamma;      // [N, C] rows with row stride gamma_stride, or null
  const float* beta;
  long long gamma_stride;
  long long beta_stride;
  const float* sums;       // [2, G, C]: sum x, sum x^2 (batch statistics)
  const float* run_mean;   // [C] running statistics (when sums is null)
  float* run_var_out;      // running var to update, or null
  float* run_mean_out;     // running mean to update, or null
  const float* run_var;
  const float* grad_sums;  // backward: [2, G, C] sums of gamma*dy' and gamma*dy'*xhat
  float* partial;          // [N, K, 2, C]
  int N, C, HW, K, chunk, G;
  float count, eps, keep, take;   // keep, take: running-statistics momentum
  int relu, batch_stats;
};

template <int DT> struct Elem;
template <> struct Elem<kF32> { using T = float; };
template <> struct Elem<kBF16> { using T = __nv_bfloat16; };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The ReLU after the cast to the output type: the rounded y is <= 0 exactly
// where y <= zero_below<DT>: in bf16 the values up to 2^-134 (half the
// smallest subnormal) round to 0, in float32 none. NaN passes, as in
// PyTorch's ReLU and its threshold_backward.
template <int DT> __device__ __forceinline__ bool relu_zero(float y) {
  if constexpr (DT == kBF16) return y <= 0x1p-134f;
  else return y <= 0.0f;
}

// V elements as loaded: one 16-byte word (8 bf16), two (8 float32), or one
// element. Kept packed while in flight, unpacked to float where used.
template <int DT, int V>
struct alignas(V == 8 ? 16 : sizeof(typename Elem<DT>::T)) Pack {
  typename Elem<DT>::T v[V];
};

template <int DT, int V>
__device__ __forceinline__ Pack<DT, V> load(const void* base, long long off) {
  return *reinterpret_cast<const Pack<DT, V>*>(static_cast<const typename Elem<DT>::T*>(base) +
                                                off);
}

template <int DT, int V>
__device__ __forceinline__ void unpack(const Pack<DT, V>& raw, float* v) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_float(raw.v[j]);
}

template <int DT, int V>
__device__ __forceinline__ void store(void* base, long long off, const float* v) {
  using T = typename Elem<DT>::T;
  T* p = static_cast<T*>(base) + off;
  if constexpr (V == 1) {
    if constexpr (DT == kBF16) p[0] = __float2bfloat16_rn(v[0]);
    else p[0] = v[0];
  } else if constexpr (DT == kBF16) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// What one thread walks: `iters` vectors of V elements, the i-th at
// off0 + i * step, all of sample n; channel c0 + j for element j in
// channels-last (dc = 1), channel c0 for every element in NCHW (dc = 0).
struct Walk {
  bool active;
  int n, k, c0, dc, iters;
  long long off0, step;
};

// Channels-last: block (n * K + k, tile); a tile is ct vector columns and
// rpi = kThreads / ct rows at a time.
template <int V>
__device__ __forceinline__ Walk walk_channels_last(const Params& p, int& rsub, int& col) {
  Walk w;
  const int cv = p.C / V;
  const int ct = cv < kThreads ? cv : kThreads;
  const int rpi = kThreads / ct;
  col = threadIdx.x % ct;
  rsub = threadIdx.x / ct;
  const int vcol = blockIdx.y * ct + col;
  w.n = blockIdx.x / p.K;
  w.k = blockIdx.x % p.K;
  w.c0 = vcol * V;
  w.dc = 1;
  const int r0 = w.k * p.chunk + rsub;
  const int r_end = min((w.k + 1) * p.chunk, p.HW);
  w.active = vcol < cv && rsub < rpi && r0 < r_end;
  w.iters = w.active ? (r_end - r0 + rpi - 1) / rpi : 0;
  w.off0 = (static_cast<long long>(w.n) * p.HW + r0) * p.C + w.c0;
  w.step = static_cast<long long>(rpi) * p.C;
  return w;
}

// NCHW: warp (n, c, k) of the block's kWarps, lanes along H*W.
template <int V>
__device__ __forceinline__ Walk walk_nchw(const Params& p) {
  Walk w;
  const long long pair = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long pairs = static_cast<long long>(p.N) * p.C * p.K;
  w.k = static_cast<int>(pair % p.K);
  w.c0 = static_cast<int>((pair / p.K) % p.C);
  w.n = static_cast<int>(pair / (static_cast<long long>(p.K) * p.C));
  w.dc = 0;
  const int e0 = w.k * p.chunk + lane * V;
  const int e_end = min((w.k + 1) * p.chunk, p.HW);
  w.active = pair < pairs && e0 < e_end;
  w.iters = w.active ? (e_end - e0 + 32 * V - 1) / (32 * V) : 0;
  w.off0 = (static_cast<long long>(w.n) * p.C + w.c0) * p.HW + e0;
  w.step = 32 * V;
  return w;
}

// Channel constants of element j of a thread's vectors: mean, rstd, gamma,
// beta, and (backward) the two gradient means and whether the variance was
// clamped at 0 (then no gradient flows through it).
template <int V>
struct Consts {
  float mean[V], rstd[V], gamma[V], beta[V], gmean[V], gxmean[V];
};

// The group's moments from the sums (batch statistics) or the running ones;
// `live` is false where the variance was clamped at 0 (no gradient flows
// through it then).
__device__ __forceinline__ void moments(const Params& p, int g, int c, float& mean, float& var,
                                        bool& live) {
  if (p.batch_stats) {
    // sums / count as PyTorch computes a division by a host scalar on the card
    const float inv = __fdiv_rn(1.0f, p.count);
    mean = __fmul_rn(p.sums[static_cast<long long>(g) * p.C + c], inv);
    const float m2 = __fmul_rn(p.sums[(static_cast<long long>(p.G) + g) * p.C + c], inv);
    const float d = __fsub_rn(m2, __fmul_rn(mean, mean));
    live = d >= 0.0f;
    var = live ? d : 0.0f;
  } else {
    mean = p.run_mean[c];
    var = p.run_var[c];
    live = true;
  }
}

template <int V>
__device__ __forceinline__ void load_consts(const Params& p, const Walk& w, bool backward,
                                            Consts<V>& k) {
  const int g = w.n / (p.N / p.G);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = w.c0 + j * w.dc;
    float var;
    bool live;
    moments(p, g, c, k.mean[j], var, live);
    k.rstd[j] = rsqrtf(__fadd_rn(var, p.eps));
    k.gamma[j] = p.gamma ? p.gamma[w.n * p.gamma_stride + c] : 1.0f;
    k.beta[j] = p.beta ? p.beta[w.n * p.beta_stride + c] : 0.0f;
    k.gmean[j] = k.gxmean[j] = 0.0f;
    if (backward && p.batch_stats) {
      const float inv = __fdiv_rn(1.0f, p.count);
      k.gmean[j] = __fmul_rn(p.grad_sums[static_cast<long long>(g) * p.C + c], inv);
      k.gxmean[j] = live ? __fmul_rn(p.grad_sums[(static_cast<long long>(p.G) + g) * p.C + c],
                                     inv) : 0.0f;
    }
  }
}

__device__ __forceinline__ float xhat_of(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

__device__ __forceinline__ float affine(const Params& p, float xh, float gamma, float beta) {
  float y = p.gamma ? __fmul_rn(xh, gamma) : xh;
  return p.beta ? __fadd_rn(y, beta) : y;
}

// The streaming loop: for each vector of the walk, load x (and dy), call
// body(x, dy, offset). kUnroll vectors of each are loaded before their use.
template <int DX, int DY, int V, bool WITH_DY, typename Body>
__device__ __forceinline__ void stream(const Params& p, const Walk& w, Body body) {
  for (int i = 0; i < w.iters; i += kUnroll) {
    Pack<DX, V> xr[kUnroll];
    Pack<DY, V> dr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u < w.iters) {
        const long long off = w.off0 + (i + u) * w.step;
        xr[u] = load<DX, V>(p.x, off);
        if constexpr (WITH_DY) dr[u] = load<DY, V>(p.dy, off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u < w.iters) {
        float xv[V], dv[V];
        unpack<DX, V>(xr[u], xv);
        if constexpr (WITH_DY) unpack<DY, V>(dr[u], dv);
        body(xv, dv, w.off0 + (i + u) * w.step);
      }
    }
  }
}

// Sums of the block's threads into partial[n, k, q, c], q = 0, 1, in a fixed
// order: channels-last, each (q, channel) of the tile adds its rpi rows in
// order, every thread taking some; NCHW, the warp's xor tree.
template <int LAYOUT, int V>
__device__ __forceinline__ void write_partial(const Params& p, const Walk& w, int rsub, int col,
                                              const float* a, const float* b) {
  const long long base = (static_cast<long long>(w.n) * p.K + w.k) * 2 * p.C;
  if constexpr (LAYOUT == kChannelsLast) {
    __shared__ float sh[2][kThreads * V];
    const int cv = p.C / V;
    const int ct = cv < kThreads ? cv : kThreads;
    const int rpi = kThreads / ct;
    if (rsub < rpi) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sh[0][(rsub * ct + col) * V + j] = w.active ? a[j] : 0.0f;
        sh[1][(rsub * ct + col) * V + j] = w.active ? b[j] : 0.0f;
      }
    }
    __syncthreads();
    const int width = ct * V;                 // channels of the tile
    const int c_tile = blockIdx.y * width;
    for (int o = threadIdx.x; o < 2 * width; o += kThreads) {
      const int q = o / width, e = o % width;
      if (c_tile + e >= p.C) continue;
      float sum = 0.0f;
      for (int r = 0; r < rpi; ++r) sum = __fadd_rn(sum, sh[q][r * width + e]);
      p.partial[base + q * p.C + c_tile + e] = sum;
    }
  } else {
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s0 = __fadd_rn(s0, a[j]);
      s1 = __fadd_rn(s1, b[j]);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, m));
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, m));
    }
    const long long pair = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
    if (threadIdx.x % 32 == 0 && pair < static_cast<long long>(p.N) * p.C * p.K) {
      p.partial[base + w.c0] = s0;
      p.partial[base + p.C + w.c0] = s1;
    }
  }
}

template <int LAYOUT, int V>
__device__ __forceinline__ Walk walk(const Params& p, int& rsub, int& col) {
  if constexpr (LAYOUT == kChannelsLast) return walk_channels_last<V>(p, rsub, col);
  rsub = col = 0;
  return walk_nchw<V>(p);
}

// Forward statistics: partial sums of x and x^2 per (sample, chunk, channel).
template <int LAYOUT, int DX, int V>
__global__ void __launch_bounds__(kThreads, 3) bn_stats_partial(Params p) {
  int rsub, col;
  const Walk w = walk<LAYOUT, V>(p, rsub, col);
  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = b[j] = 0.0f;
  stream<DX, DX, V, false>(p, w, [&](const float* x, const float*, long long) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = __fadd_rn(a[j], x[j]);
      b[j] = __fadd_rn(b[j], __fmul_rn(x[j], x[j]));
    }
  });
  write_partial<LAYOUT, V>(p, w, rsub, col, a, b);
}

// Forward apply: y = ((x - mean) * rstd) * gamma + beta, rounded, ReLU; the
// first block of each channel tile advances the running statistics.
template <int LAYOUT, int DX, int DY, int V>
__global__ void __launch_bounds__(kThreads, 2) bn_apply(Params p) {
  int rsub, col;
  const Walk w = walk<LAYOUT, V>(p, rsub, col);
  if (w.c0 >= p.C || w.n >= p.N) return;
  Consts<V> k;
  load_consts<V>(p, w, false, k);
  if (p.run_mean_out && w.n == 0 && w.k == 0 && rsub == 0 &&
      (LAYOUT == kChannelsLast || threadIdx.x % 32 == 0)) {
    for (int j = 0; j < (LAYOUT == kChannelsLast ? V : 1); ++j) {
      const int c = w.c0 + j;
      float mean, var;
      bool live;
      moments(p, 0, c, mean, var, live);
      // running.mul_(keep).add_(stat, alpha=take), as the plain version
      p.run_mean_out[c] = __fmaf_rn(p.take, mean, __fmul_rn(p.run_mean_out[c], p.keep));
      p.run_var_out[c] = __fmaf_rn(p.take, var, __fmul_rn(p.run_var_out[c], p.keep));
    }
  }
  stream<DX, DY, V, false>(p, w, [&](const float* x, const float*, long long off) {
    float y[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = affine(p, xhat_of(x[j], k.mean[j], k.rstd[j]), k.gamma[j], k.beta[j]);
      y[j] = (p.relu && relu_zero<DY>(v)) ? 0.0f : v;  // rounded by the store
    }
    store<DY, V>(p.out, off, y);
  });
}

// Backward reduction: partial sums of dy' and dy' * xhat per (sample,
// chunk, channel), dy' = dy masked by the recomputed ReLU.
template <int LAYOUT, int DX, int DY, int V>
__global__ void __launch_bounds__(kThreads, 2) bn_grad_partial(Params p) {
  int rsub, col;
  const Walk w = walk<LAYOUT, V>(p, rsub, col);
  Consts<V> k;
  if (w.active) load_consts<V>(p, w, false, k);
  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = b[j] = 0.0f;
  stream<DX, DY, V, true>(p, w, [&](const float* x, const float* dy, long long) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xh = xhat_of(x[j], k.mean[j], k.rstd[j]);
      float d = dy[j];
      if (p.relu && relu_zero<DY>(affine(p, xh, k.gamma[j], k.beta[j]))) d = 0.0f;
      a[j] = __fadd_rn(a[j], d);
      b[j] = __fadd_rn(b[j], __fmul_rn(d, xh));
    }
  });
  write_partial<LAYOUT, V>(p, w, rsub, col, a, b);
}

// Backward apply: dx = rstd * (gamma * dy' - mean(gamma dy') - xhat *
// mean(gamma dy' xhat)); with running statistics dx = rstd * gamma * dy'.
template <int LAYOUT, int DX, int DY, int V>
__global__ void __launch_bounds__(kThreads, 2) bn_grad_apply(Params p) {
  int rsub, col;
  const Walk w = walk<LAYOUT, V>(p, rsub, col);
  if (w.c0 >= p.C || w.n >= p.N) return;
  Consts<V> k;
  load_consts<V>(p, w, true, k);
  stream<DX, DY, V, true>(p, w, [&](const float* x, const float* dy, long long off) {
    float dx[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xh = xhat_of(x[j], k.mean[j], k.rstd[j]);
      float d = dy[j];
      if (p.relu && relu_zero<DY>(affine(p, xh, k.gamma[j], k.beta[j]))) d = 0.0f;
      const float gd = p.gamma ? __fmul_rn(k.gamma[j], d) : d;
      dx[j] = __fmul_rn(k.rstd[j],
                        __fsub_rn(__fsub_rn(gd, k.gmean[j]), __fmul_rn(xh, k.gxmean[j])));
    }
    store<DX, V>(p.out, off, dx);
  });
}

// The fixed-order combine: one warp per output (q, g, c). Lane l adds the
// K chunks of samples g * n_g + l, l + 32, ...; with `rows` it writes each
// sample's sum to rows[q, n, c]; with `weights` it weights sample n by
// weights[n * stride + c]; the xor tree gives out[q, g, c].
__global__ void __launch_bounds__(kThreads)
bn_sums_combine(const float* __restrict__ partial, const float* __restrict__ weights,
                long long stride, int N, int K, int C, int G, float* __restrict__ out,
                float* __restrict__ rows) {
  const long long o = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (o >= 2LL * G * C) return;
  const int c = static_cast<int>(o % C);
  const int g = static_cast<int>((o / C) % G);
  const int q = static_cast<int>(o / (static_cast<long long>(C) * G));
  const int ng = N / G;
  float acc = 0.0f;
  for (int j = lane; j < ng; j += 32) {
    const int n = g * ng + j;
    float r = 0.0f;
    for (int k = 0; k < K; ++k)
      r = __fadd_rn(r, partial[((static_cast<long long>(n) * K + k) * 2 + q) * C + c]);
    if (rows) rows[(static_cast<long long>(q) * N + n) * C + c] = r;
    acc = __fadd_rn(acc, weights ? __fmul_rn(weights[n * stride + c], r) : r);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
  if (lane == 0) out[o] = acc;
}

inline dim3 grid_of(const Params& p, int layout, int v) {
  if (layout == kChannelsLast) {
    const int cv = p.C / v;
    const int ct = cv < kThreads ? cv : kThreads;
    return dim3(static_cast<unsigned>(p.N) * p.K, (cv + ct - 1) / ct);
  }
  const long long pairs = static_cast<long long>(p.N) * p.C * p.K;
  return dim3(static_cast<unsigned>((pairs + kWarps - 1) / kWarps));
}

bool aligned(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// One kernel instance for the run-time layout, dtypes and vector width.
template <template <int, int, int, int> class K>
int dispatch(const Params& p, int layout, int dx, int dy, int v, cudaStream_t s) {
  const dim3 grid = grid_of(p, layout, v);
  const dim3 block(kThreads);
#define GL_BN_CASE(L, X, Y, W)                                                       \
  if (layout == L && dx == X && dy == Y && v == W) {                                 \
    K<L, X, Y, W>::launch(grid, block, s, p);                                        \
    return static_cast<int>(cudaGetLastError());                                     \
  }
#define GL_BN_TYPES(L, W)                                                            \
  GL_BN_CASE(L, kF32, kF32, W) GL_BN_CASE(L, kF32, kBF16, W)                         \
  GL_BN_CASE(L, kBF16, kF32, W) GL_BN_CASE(L, kBF16, kBF16, W)
  GL_BN_TYPES(kChannelsLast, 1) GL_BN_TYPES(kChannelsLast, 8)
  GL_BN_TYPES(kNCHW, 1) GL_BN_TYPES(kNCHW, 8)
#undef GL_BN_TYPES
#undef GL_BN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int L, int X, int Y, int W> struct StatsLaunch {
  static void launch(dim3 g, dim3 b, cudaStream_t s, const Params& p) {
    bn_stats_partial<L, X, W><<<g, b, 0, s>>>(p);  // Y unused: one kernel per x dtype
  }
};
template <int L, int X, int Y, int W> struct ApplyLaunch {
  static void launch(dim3 g, dim3 b, cudaStream_t s, const Params& p) {
    bn_apply<L, X, Y, W><<<g, b, 0, s>>>(p);
  }
};
template <int L, int X, int Y, int W> struct GradPartialLaunch {
  static void launch(dim3 g, dim3 b, cudaStream_t s, const Params& p) {
    bn_grad_partial<L, X, Y, W><<<g, b, 0, s>>>(p);
  }
};
template <int L, int X, int Y, int W> struct GradApplyLaunch {
  static void launch(dim3 g, dim3 b, cudaStream_t s, const Params& p) {
    bn_grad_apply<L, X, Y, W><<<g, b, 0, s>>>(p);
  }
};

int check(const Params& p, int layout, int v) {
  if (p.N <= 0 || p.C <= 0 || p.HW <= 0 || p.K <= 0 || p.chunk <= 0 || p.G <= 0 ||
      p.N % p.G != 0 || (v != 1 && v != 8) || (layout != kChannelsLast && layout != kNCHW))
    return static_cast<int>(cudaErrorInvalidValue);
  if (v == 8) {
    if ((layout == kChannelsLast ? p.C : p.HW) % 8 != 0 || (layout == kNCHW && p.chunk % 8 != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    if (!aligned(p.x) || (p.dy && !aligned(p.dy)) || (p.out && !aligned(p.out)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

Params params(const void* x, const void* dy, void* out, const float* gamma,
              long long gamma_stride, const float* beta, long long beta_stride,
              const float* sums, const float* run_mean, const float* run_var,
              const float* grad_sums, float* partial, int n, int c, int hw, int k, int chunk,
              int groups, float count, float eps, int relu) {
  Params p;
  p.x = x; p.dy = dy; p.out = out;
  p.gamma = gamma; p.gamma_stride = gamma_stride;
  p.beta = beta; p.beta_stride = beta_stride;
  p.sums = sums; p.run_mean = run_mean; p.run_var = run_var;
  p.run_mean_out = nullptr; p.run_var_out = nullptr;
  p.grad_sums = grad_sums; p.partial = partial;
  p.N = n; p.C = c; p.HW = hw; p.K = k; p.chunk = chunk; p.G = groups;
  p.count = count; p.eps = eps; p.keep = p.take = 0.0f;
  p.relu = relu; p.batch_stats = sums != nullptr;
  return p;
}

int combine(const float* partial, const float* weights, long long stride, int n, int k, int c,
            int groups, float* out, float* rows, cudaStream_t s) {
  const long long outs = 2LL * groups * c;
  bn_sums_combine<<<static_cast<unsigned>((outs + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      partial, weights, stride, n, k, c, groups, out, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Layout 0 channels-last (x is [N, HW, C] in memory), 1 NCHW ([N, C, HW]);
// dtype codes 0 float32, 1 bf16; vec 8 or 1 (see the note above). Every
// buffer is a device pointer; `partial` holds N * K * 2 * C floats. Each
// function returns the cudaError_t of its launches (0 on success).

// Forward statistics: sums[2, G, C] of x and x^2 per group and channel.
int gl_bn_forward_sums(const void* x, int dtype_x, int layout, int vec, int n, int c, int hw,
                       int k, int chunk, int groups, float* partial, float* sums,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p = params(x, nullptr, nullptr, nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr,
                    nullptr, partial, n, c, hw, k, chunk, groups, 1.0f, 0.0f, 0);
  int err = check(p, layout, vec);
  if (err) return err;
  err = dispatch<StatsLaunch>(p, layout, dtype_x, kF32, vec, s);
  if (err) return err;
  return combine(partial, nullptr, 0, n, k, c, groups, sums, nullptr, s);
}

// Forward apply: y from x with batch statistics (`sums`, over `count`
// elements a group) or running ones (sums null: run_mean, run_var);
// run_mean_out/run_var_out (or null) become keep * running + take * stat.
int gl_bn_forward_apply(const void* x, int dtype_x, void* y, int dtype_y, int layout, int vec,
                        int n, int c, int hw, int k, int chunk, int groups,
                        const float* gamma, long long gamma_stride, const float* beta,
                        long long beta_stride, const float* sums, float count,
                        const float* run_mean, const float* run_var, float* run_mean_out,
                        float* run_var_out, float keep, float take, float eps, int relu,
                        void* stream) {
  Params p = params(x, nullptr, y, gamma, gamma_stride, beta, beta_stride, sums, run_mean,
                    run_var, nullptr, nullptr, n, c, hw, k, chunk, groups, count, eps, relu);
  p.run_mean_out = run_mean_out;
  p.run_var_out = run_var_out;
  p.keep = keep;
  p.take = take;
  const int err = check(p, layout, vec);
  if (err) return err;
  if ((run_mean_out || run_var_out) && (!sums || groups != 1 || !run_mean_out || !run_var_out))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<ApplyLaunch>(p, layout, dtype_x, dtype_y, vec, static_cast<cudaStream_t>(stream));
}

// Backward reduction: rows[2, N, C] = per-sample sums of dy' and dy' * xhat
// (the gradients of beta's and gamma's rows), and, with batch statistics,
// grad_sums[2, G, C] = their gamma-weighted sums per group.
int gl_bn_backward_sums(const void* x, int dtype_x, const void* dy, int dtype_dy, int layout,
                        int vec, int n, int c, int hw, int k, int chunk, int groups,
                        const float* gamma, long long gamma_stride, const float* beta,
                        long long beta_stride, const float* sums, float count,
                        const float* run_mean, const float* run_var, float eps, int relu,
                        float* partial, float* rows, float* grad_sums, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p = params(x, dy, nullptr, gamma, gamma_stride, beta, beta_stride, sums, run_mean,
                    run_var, nullptr, partial, n, c, hw, k, chunk, groups, count, eps, relu);
  int err = check(p, layout, vec);
  if (err) return err;
  err = dispatch<GradPartialLaunch>(p, layout, dtype_x, dtype_dy, vec, s);
  if (err) return err;
  return combine(partial, gamma, gamma_stride, n, k, c, groups, grad_sums, rows, s);
}

// Backward apply: dx (x's dtype) from x, dy and grad_sums (null with
// running statistics).
int gl_bn_backward_apply(const void* x, int dtype_x, const void* dy, int dtype_dy, void* dx,
                         int layout, int vec, int n, int c, int hw, int k, int chunk,
                         int groups, const float* gamma, long long gamma_stride,
                         const float* beta, long long beta_stride, const float* sums,
                         float count, const float* run_mean, const float* run_var,
                         const float* grad_sums, float eps, int relu, void* stream) {
  Params p = params(x, dy, dx, gamma, gamma_stride, beta, beta_stride, sums, run_mean, run_var,
                    grad_sums, nullptr, n, c, hw, k, chunk, groups, count, eps, relu);
  const int err = check(p, layout, vec);
  if (err) return err;
  if (sums && !grad_sums) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<GradApplyLaunch>(p, layout, dtype_x, dtype_dy, vec,
                                   static_cast<cudaStream_t>(stream));
}

const char* gl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
