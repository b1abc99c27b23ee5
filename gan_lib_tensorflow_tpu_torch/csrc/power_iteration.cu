// Batched spectral-norm power iteration: one step for every SN weight of a
// discriminator in a single launch, one thread-block cluster per large
// weight.
//
// Replaces gan_lib_tensorflow_tpu/ops/pallas_kernels.py:63
// batched_power_iteration (body _power_iter_kernel, :46). For each weight i,
// with W_i in R^{M x K} ([fan_in, out]) and u_i in R^K:
//   v = l2n(u W^T),  u' = l2n(v W),  sigma = v W u'^T
// with l2n(x) = x * rsqrt(sum(x^2) + 1e-12), as the reference does.
//
// Layout. The Pallas kernel took one zero-padded [N, Mmax, Kmax] stack (8/128
// padding was a TPU tiling rule). This kernel reads every weight ragged, in
// the port's own layout: a conv weight in OIHW (or a Dense weight [out, in])
// is exactly W^T as a row-major [K, M] matrix, so nothing is transposed,
// padded or packed. The wrapper (ops/power_iteration.py) plans the work on
// the host once per discriminator (plan_power_iteration, a pure function of
// the shapes, tested on the CPU) and writes a device table with one int64
// row per CTA:
//   (w_ptr, u_ptr, M, K, v_offset, u_offset, col0, width, kind, weight, stream)
// Parameters are updated in place, so their pointers stay valid across steps.
//
// Bound. On the CIFAR discriminator (11 weights, 1,052,544 fp32 values) W is
// 4.21 MB that must be read at least once: 1.270 us at 3.35 TB/s with u in,
// sigma, u' and v out. The arithmetic, 4*M*K flops per weight, takes 0.063 us
// at the 67 TFLOP/s fp32 rate, so the bound is bytes.
//
// Design. The first version ran one 1024-thread block per weight (11 of the
// card's 132 SMs), walked each column of W^T as a chain of dependent loads
// for v and read W a second time, from L2, for u': its time was load latency,
// 34-67x the bound. This version:
//   - launches with cudaLaunchKernelEx and a cluster dimension of 8 CTAs (the
//     portable size; 16, with the non-portable attribute, measured no
//     faster on the card). A weight larger than 64 KB gets
//     a whole cluster: CTA c owns the columns [col0, col0 + width) of W^T,
//     width = M / 8 rounded up to 4. For a [1152, 128] weight that is 144
//     columns, a slab of 128 x 144 fp32 = 72 KB in dynamic shared memory
//     (87 KB per CTA with u, v and the partial sums); the 7 such CIFAR
//     weights cover 56 SMs;
//   - loads its slab once with cp.async (16-byte copies when the rows and
//     the slab are 16-byte aligned, 4-byte copies otherwise), all copies in
//     flight together, one wait; a TMA bulk copy per row measured slower;
//   - computes its v slice from the slab (each warp a set of rows, each lane
//     8 columns 32 apart, the warps' partials added in order), then, from
//     the same slab and before v is normalised, its K partial sums of W^T v
//     (each warp 8 rows at a time, their shuffle trees interleaved);
//   - pushes its |v|^2 partial and its K partial sums into the shared memory
//     of every rank of its cluster (distributed shared memory stores, never
//     remote loads), waits once at a cluster barrier, and then every rank
//     adds the same partials in rank order: |v|^2, W^T v scaled by 1/|v|,
//     and |W^T v|^2. All ranks so agree on sigma and u' with one barrier;
//     rank c writes its v slice and rows [c K/8, (c+1) K/8) of u';
//   - packs the small weights ([27, 128], [3, 128], [128, 128], [128, 1]),
//     one CTA each, into the ranks of a shared cluster that never touches
//     distributed shared memory;
//   - streams a slab that does not fit in 227 KB (the ImageNet-128 D's
//     [4608, 1024] and [9216, 1024] 3x3 convs): its two passes then read the
//     CTA's columns of W from global memory, so W is read twice. Only
//     correctness is asked of that path for now.
// No atomics, and every sum is taken in a fixed order, so two launches on
// the same inputs give bit-identical sigma, u' and v. v and u' go to flat
// output buffers (the backward needs both); u' is also written into the u
// buffers when the caller asks. The kernel allocates nothing and launches on
// the caller's stream; a refused launch (cluster or shared-memory request)
// comes back as the cudaError_t and the wrapper raises.
//
// Measured by chip_smoke.py phase 8 (device time of CUDA-graph replays, W in
// L2 as the replays leave it; PERF.md section 6 has every run): on an H100
// 80GB HBM3 at 700 W, 7.18-7.22 us per launch at the CIFAR-D shapes against
// the first version's 37.28-37.39 us in the same call, a 1.270 us bound and
// a 1.01-1.02 us floor for an empty kernel launched with the same grid,
// clusters and shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // = 32 * WARPS in ops/power_iteration.py
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;             // columns per lane in the v pass
constexpr int kChunk = 32 * kCols;   // columns per chunk of the v pass
constexpr int kRows = 8;             // rows of W^T one warp reduces at a time in the u' pass
constexpr int kCluster = 8;  // CTAs per cluster, the portable size; CLUSTER in ops/power_iteration.py
constexpr int kTableCols = 11;
constexpr int kMaxDevices = 64;
enum Kind { kIdle = 0, kSolo = 1, kSplit = 2 };

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum of x over the block in a fixed order; every thread gets the result.
// scratch holds kWarps + 1 floats.
__device__ float block_sum(float x, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // earlier readers of scratch are done
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? scratch[lane] : 0.0f;
    t = warp_sum(t);
    if (lane == 0) scratch[kWarps] = t;
  }
  __syncthreads();
  return scratch[kWarps];
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Shared memory of one CTA, in floats; plan_power_iteration computes the same
// sum. First the part that peers write into, at offsets that depend only on
// (nranks, K) and so are the same on every rank of a weight: the |v|^2
// partial of each rank and each rank's K partial sums of W^T v. Then the slab
// (absent when streamed; 16-byte aligned), u, the v slice, the row-group
// partials of the v pass and block_sum's scratch.
__device__ __forceinline__ int peer_floats(int nranks, int k) {
  return kCluster + ((nranks * k + 3) & ~3);
}

__device__ __forceinline__ long long smem_floats(int k, int width, int nranks, bool stream) {
  return peer_floats(nranks, k) + (stream ? 0LL : static_cast<long long>(k) * width) + k +
         width + kWarps * kChunk + kWarps + 1;
}

// The CTA's slab of W^T, row r and column j (0 <= j < width).
struct SharedSlab {
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int j) const { return p[r * ld + j]; }
};
struct GlobalSlab {
  const float* p;
  long long ld;
  __device__ __forceinline__ float operator()(int r, int j) const { return __ldg(p + r * ld + j); }
};

struct Work {
  float* u;
  float* sigma;
  float* u_out;
  float* v_out;
  long long v_off, u_off;
  int k, col0, width, weight, write_u;
  int rank, nranks;
  bool split;
  float* red_v;  // [kCluster] |v|^2 partial of each rank
  float* ygath;  // [nranks, K] each rank's partial sums of W^T v
  float* su;     // [K] u
  float* sv;     // [width] v slice
  float* vpart;  // [kWarps, kChunk] partials of the v pass
  float* scratch;
};

// Steps 2-5 for one CTA (see the file's note). Ranks never read remote
// shared memory: each pushes its partials into every peer's shared memory,
// and one cluster barrier orders the pushes before the reads. After it every
// rank adds the same partials in the same order, so all ranks agree on
// |v|, W^T v and |W^T v| without a second barrier.
template <class Slab>
__device__ __forceinline__ void power_step(const Slab& S, const Work& w) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k = w.k;

  // 2. the v slice before normalising, v_j = sum_r u_r W^T[r, j]: warp g adds
  // the rows r = g (mod kWarps), each lane kCols columns 32 apart; the kWarps
  // partials of a column are then added in order
  for (int c0 = 0; c0 < w.width; c0 += kChunk) {
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
#pragma unroll 2
    for (int r = warp; r < k; r += kWarps) {
      const float ur = w.su[r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = c0 + lane + 32 * c;
        if (j < w.width) acc[c] = fmaf(ur, S(r, j), acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) w.vpart[warp * kChunk + lane + 32 * c] = acc[c];
    __syncthreads();
    for (int j = tid; j < kChunk && c0 + j < w.width; j += kThreads) {
      float x = 0.0f;
#pragma unroll
      for (int g = 0; g < kWarps; ++g) x += w.vpart[g * kChunk + j];
      w.sv[c0 + j] = x;
    }
    __syncthreads();  // vpart is free for the next chunk
  }
  float ss = 0.0f;
  for (int j = tid; j < w.width; j += kThreads) ss = fmaf(w.sv[j], w.sv[j], ss);
  ss = block_sum(ss, w.scratch);

  // 3. this slab's K partial sums of W^T v (v not yet normalised): warp g
  // takes kRows rows at a time, r = g + kWarps * t, so their loads and
  // shuffle trees overlap; the partials go to this rank's slot of ygath
  float* mine = w.ygath + w.rank * k;
  for (int rb = warp; rb < k; rb += kWarps * kRows) {
    float acc[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc[t] = 0.0f;
    for (int j = lane; j < w.width; j += 32) {
      const float x = w.sv[j];
#pragma unroll
      for (int t = 0; t < kRows; ++t)
        if (rb + kWarps * t < k) acc[t] = fmaf(S(rb + kWarps * t, j), x, acc[t]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < kRows; ++t) acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
    }
    float y = acc[0];
#pragma unroll
    for (int t = 1; t < kRows; ++t) y = lane == t ? acc[t] : y;
    if (lane < kRows && rb + kWarps * lane < k) mine[rb + kWarps * lane] = y;
  }
  if (tid == 0) w.red_v[w.rank] = ss;
  __syncthreads();

  // 4. push this rank's partials into every peer, then the one barrier
  if (w.split) {
    cg::cluster_group cluster = cg::this_cluster();
    // a rank may write into a peer's shared memory only once the peer runs:
    // this waits on the arrival every rank made on entry
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int i = tid; i < w.nranks * k; i += kThreads) {
      const int q = i / k, r = i - q * k;
      if (q != w.rank) cluster.map_shared_rank(mine, q)[r] = mine[r];
    }
    if (tid < w.nranks && tid != w.rank) cluster.map_shared_rank(w.red_v, tid)[w.rank] = ss;
    cluster.sync();  // the last access to a peer's shared memory is before this barrier
  }

  // 5. every rank adds the partials in rank order: |v|^2, then W^T v, then
  // |W^T v|^2; it writes its v slice and its share of the rows of u'
  float ssv = 0.0f;
  for (int q = 0; q < w.nranks; ++q) ssv += w.red_v[q];
  const float inv_v = rsqrtf(ssv + 1e-12f);
  for (int j = tid; j < w.width; j += kThreads) w.v_out[w.v_off + w.col0 + j] = w.sv[j] * inv_v;
  float ss2 = 0.0f;
  for (int r = tid; r < k; r += kThreads) {
    float y = 0.0f;
    for (int q = 0; q < w.nranks; ++q) y += w.ygath[q * k + r];
    y *= inv_v;
    w.ygath[r] = y;  // rank 0's slot of row r: no other thread reads it now
    ss2 = fmaf(y, y, ss2);
  }
  const float s = block_sum(ss2, w.scratch);
  const float inv_u = rsqrtf(s + 1e-12f);
  if (w.rank == 0 && tid == 0) w.sigma[w.weight] = s * inv_u;  // (W^T v) . u'
  const int rows = (k + w.nranks - 1) / w.nranks;
  const int r1 = min(k, (w.rank + 1) * rows);
  for (int r = w.rank * rows + tid; r < r1; r += kThreads) {
    const float x = w.ygath[r] * inv_u;
    w.u_out[w.u_off + r] = x;
    if (w.write_u) w.u[r] = x;  // every rank read u in step 1, before the barrier
  }
}

__global__ void __launch_bounds__(kThreads)
power_iteration_kernel(const long long* __restrict__ table, float* __restrict__ sigma,
                       float* __restrict__ u_out, float* __restrict__ v_out, int write_u) {
  extern __shared__ __align__(16) float smem[];
  const long long* row = table + kTableCols * static_cast<long long>(blockIdx.x);
  const int kind = static_cast<int>(row[8]);
  if (kind == kIdle) return;  // a spare rank of a packed cluster
  const float* w = reinterpret_cast<const float*>(row[0]);  // W^T [K, M]
  const int m = static_cast<int>(row[2]);
  const bool stream = row[10] != 0;
  Work wk;
  wk.u = reinterpret_cast<float*>(row[1]);
  wk.sigma = sigma;
  wk.u_out = u_out;
  wk.v_out = v_out;
  wk.k = static_cast<int>(row[3]);
  wk.v_off = row[4];
  wk.u_off = row[5];
  wk.col0 = static_cast<int>(row[6]);
  wk.width = static_cast<int>(row[7]);
  wk.weight = static_cast<int>(row[9]);
  wk.write_u = write_u;
  // kind is the same on every rank of a cluster, so the cluster barriers are
  // reached by all of its CTAs or by none
  wk.split = kind == kSplit;
  wk.nranks = wk.split ? static_cast<int>(cg::this_cluster().num_blocks()) : 1;
  wk.rank = wk.split ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  if (wk.split) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int k = wk.k, width = wk.width, col0 = wk.col0;
  const int tid = threadIdx.x;

  unsigned dyn_bytes;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn_bytes));
  if (wk.nranks > kCluster || 4 * smem_floats(k, width, wk.nranks, stream) > dyn_bytes)
    __trap();  // the planner and the kernel disagree
  wk.red_v = smem;
  wk.ygath = smem + kCluster;
  float* slab = smem + peer_floats(wk.nranks, k);
  wk.su = slab + (stream ? 0 : static_cast<long long>(k) * width);
  wk.sv = wk.su + k;
  wk.vpart = wk.sv + width;
  wk.scratch = wk.vpart + kWarps * kChunk;

  // 1. the slab of W^T [K, width] into shared memory, once, all copies in
  // flight together; u beside it
  if (!stream) {
    const bool vec = ((reinterpret_cast<uintptr_t>(w) & 15u) | (m & 3) | (col0 & 3) | (width & 3)) == 0;
    if (vec) {
      const int w4 = width / 4;
      for (int i = tid; i < k * w4; i += kThreads) {
        const int r = i / w4, c = 4 * (i - r * w4);
        cp_async16(slab + r * width + c, w + static_cast<long long>(r) * m + col0 + c);
      }
    } else {
      for (int i = tid; i < k * width; i += kThreads) {
        const int r = i / width, c = i - r * width;
        cp_async4(slab + r * width + c, w + static_cast<long long>(r) * m + col0 + c);
      }
    }
  }
  for (int r = tid; r < k; r += kThreads) wk.su[r] = wk.u[r];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (stream)
    power_step(GlobalSlab{w + col0, m}, wk);
  else
    power_step(SharedSlab{slab, width}, wk);
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

// Launch `kernel` on n_ctas blocks of kThreads in clusters of kCluster, with
// smem_bytes of dynamic shared memory. The attribute is set once per device
// and size. A refused call's error is returned and cleared, so that it does
// not surface again at the next launch.
template <typename... Params, typename... Args>
int launch_clustered(void (*kernel)(Params...), int* smem_set, int n_ctas, int smem_bytes,
                     cudaStream_t stream, Args... args) {
  if (n_ctas <= 0) return 0;
  if (n_ctas % kCluster != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto fail = [](cudaError_t err) {
    cudaGetLastError();
    return static_cast<int>(err);
  };
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return fail(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem_bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return fail(err);
    smem_set[dev] = smem_bytes;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(n_ctas));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return fail(err);
  return static_cast<int>(cudaGetLastError());
}

int g_smem_set[kMaxDevices] = {};
int g_empty_smem_set[kMaxDevices] = {};

}  // namespace

extern "C" {

// table: device int64 [n_ctas, 11] from plan_power_iteration, n_ctas a
// multiple of kCluster; sigma: device fp32 [number of weights]; u_out: fp32
// [sum K]; v_out: fp32 [sum M]. Returns the cudaError_t of the launch (0 on
// success).
int gl_power_iteration(const void* table, int n_ctas, int smem_bytes, void* sigma,
                       void* u_out, void* v_out, int write_u, void* stream) {
  return launch_clustered(power_iteration_kernel, g_smem_set, n_ctas, smem_bytes,
                          static_cast<cudaStream_t>(stream),
                          static_cast<const long long*>(table), static_cast<float*>(sigma),
                          static_cast<float*>(u_out), static_cast<float*>(v_out), write_u);
}

// An empty kernel launched with the same grid, clusters and shared memory:
// the floor that launching alone costs.
int gl_power_iteration_empty(int n_ctas, int smem_bytes, void* stream) {
  return launch_clustered(empty_kernel, g_empty_smem_set, n_ctas, smem_bytes,
                          static_cast<cudaStream_t>(stream));
}

const char* gl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
