// Batched spectral-norm power iteration: one step for every SN weight of a
// discriminator in a single launch.
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
// padded or packed. A device table of int64 rows
//   (w_ptr, u_ptr, M, K, v_offset, u_offset)
// is built once per discriminator by the wrapper; parameters are updated in
// place, so their pointers stay valid across steps.
//
// Bound. On the CIFAR discriminator (11 weights, 1,052,544 fp32 values) the
// weights are 4.21 MB that must be read at least once: about 1.3 us at
// 3.35 TB/s (2.5 us if W is read twice, as here: once for v, once for u').
// The arithmetic is 4*M*K flops per weight, far below the fp32 rate, so the
// bound is bytes, and in practice the launch latency sets the floor.
//
// Design. One block of 1024 threads per weight: a pass over the columns of
// W^T for v (each thread owns some columns and walks the K rows, neighbouring
// threads on neighbouring addresses), a block reduction for |v|, then one
// warp per row of W^T for u' = l2n(W^T v), and sigma = |vW|^2 *
// rsqrt(|vW|^2 + 1e-12), which is (vW).u'. The second pass finds W in L2.
// Each thread's loads form one long dependent walk, so the time is load
// latency, not bandwidth: the inner loops are unrolled by 8 to keep several
// loads in flight, and the block is as wide as the card allows. 11 blocks
// use 11 of the card's 132 SMs; splitting the large weights over several
// blocks (with a cross-block reduction) is left to a later change. v and u'
// are written to flat output buffers (the backward needs both); u' is also
// written into the u buffers when the caller asks.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTableCols = 6;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum of x over the block; every thread gets the result. scratch holds
// kWarps + 1 floats.
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

__global__ void __launch_bounds__(kThreads)
power_iteration_kernel(const long long* __restrict__ table,
                       float* __restrict__ sigma,
                       float* __restrict__ u_out,
                       float* __restrict__ v_out,
                       int write_u) {
  __shared__ float scratch[kWarps + 1];
  const long long* row = table + kTableCols * blockIdx.x;
  const float* __restrict__ w = reinterpret_cast<const float*>(row[0]);  // [K, M]
  float* u = reinterpret_cast<float*>(row[1]);                            // [K]
  const int m = static_cast<int>(row[2]);
  const int k = static_cast<int>(row[3]);
  float* v = v_out + row[4];   // [M]
  float* un = u_out + row[5];  // [K]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // v = W u: thread owns columns j of W^T and walks its K rows
  float ss = 0.0f;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    float acc = 0.0f;
#pragma unroll 8
    for (int r = 0; r < k; ++r) acc = fmaf(u[r], w[static_cast<size_t>(r) * m + j], acc);
    v[j] = acc;
    ss = fmaf(acc, acc, ss);
  }
  const float inv_v = rsqrtf(block_sum(ss, scratch) + 1e-12f);
  for (int j = threadIdx.x; j < m; j += kThreads) v[j] *= inv_v;
  __syncthreads();  // all of v is written and visible to the block

  // y = W^T v: one warp per row of W^T
  float ss2 = 0.0f;
  for (int r = warp; r < k; r += kWarps) {
    const float* wr = w + static_cast<size_t>(r) * m;
    float acc = 0.0f;
#pragma unroll 8
    for (int j = lane; j < m; j += 32) acc = fmaf(wr[j], v[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      un[r] = acc;
      ss2 = fmaf(acc, acc, ss2);
    }
  }
  // every read of u happened before the first block_sum's barriers
  const float s = block_sum(ss2, scratch);
  const float inv_u = rsqrtf(s + 1e-12f);
  if (threadIdx.x == 0) sigma[blockIdx.x] = s * inv_u;
  if (lane == 0) {
    for (int r = warp; r < k; r += kWarps) {
      const float val = un[r] * inv_u;
      un[r] = val;
      if (write_u) u[r] = val;
    }
  }
}

}  // namespace

extern "C" {

// table: device int64 [n, 6]; sigma: device fp32 [n]; u_out: fp32 [sum K];
// v_out: fp32 [sum M]. Returns the cudaError_t of the launch (0 on success).
int gl_power_iteration(const void* table, int n, void* sigma, void* u_out,
                       void* v_out, int write_u, void* stream) {
  if (n <= 0) return 0;
  power_iteration_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), static_cast<float*>(sigma),
      static_cast<float*>(u_out), static_cast<float*>(v_out), write_u);
  return static_cast<int>(cudaGetLastError());
}

const char* gl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
