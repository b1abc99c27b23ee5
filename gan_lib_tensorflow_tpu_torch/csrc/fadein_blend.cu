// PGGAN fade-in blend: out[i] = alpha * a[i] + (1 - alpha) * b[i], fp32.
//
// Replaces gan_lib_tensorflow_tpu/ops/pallas_kernels.py:122 fadein_blend
// (body _fadein_kernel, :117). alpha is a runtime scalar passed by value.
//
// Layout. The Pallas version flattened a and b, padded them to whole
// [1024, 128] tiles (a TPU tiling rule) and sliced the result back. Here the
// three buffers are read and written in place as flat arrays of n floats:
// the wrapper (ops/fadein.py) accepts only tensors that are dense with the
// same strides, so element i of a, b and out is the same logical element in
// any dense layout (NCHW or channels-last). Nothing is padded or copied.
//
// Bound. 12 bytes per element move (read a and b, write out) against 3
// flops: about 0.25 flop/byte, far below the card's ratio, so the bound is
// bytes over the memory rate. At the PGGAN 1024^2 rung the G blend is
// [4, 3, 1024, 1024] (151 MB, 45 us at 3.35 TB/s) and the D blend
// [4, 32, 512, 512] (403 MB, 120 us).
//
// Design. A grid-stride loop with 64-bit indices; when all three pointers
// are 16-byte aligned each thread moves float4s (one 16-byte load per
// thread per input, neighbouring threads on neighbouring addresses), and a
// scalar loop covers the last n % 4 elements. The grid is a few waves of
// blocks per SM, enough loads in flight to reach the memory rate. The
// products and the sum are rounded separately (__fmul_rn, __fadd_rn, no
// fused multiply-add), as the plain PyTorch version rounds them, and
// 1 - alpha comes from the wrapper, so the two agree bit for bit. The
// kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float blend(float alpha, float beta, float x, float y) {
  return __fadd_rn(__fmul_rn(alpha, x), __fmul_rn(beta, y));
}

__global__ void __launch_bounds__(kThreads)
fadein_blend_vec4(const float4* __restrict__ a, const float4* __restrict__ b,
                  float4* __restrict__ out, float alpha, float beta, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += stride) {
    const float4 x = a[i];
    const float4 y = b[i];
    out[i] = make_float4(blend(alpha, beta, x.x, y.x), blend(alpha, beta, x.y, y.y),
                         blend(alpha, beta, x.z, y.z), blend(alpha, beta, x.w, y.w));
  }
}

__global__ void __launch_bounds__(kThreads)
fadein_blend_scalar(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, float alpha, float beta,
                    long long begin, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = begin + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    out[i] = blend(alpha, beta, a[i], b[i]);
  }
}

int grid_for(long long work) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

extern "C" {

// a, b, out: device fp32 buffers of n elements; beta = 1 - alpha as the
// caller rounds it. Returns the cudaError_t of the launches (0 on success).
int gl_fadein_blend(const void* a, const void* b, void* out, float alpha,
                    float beta, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(out);
  long long done = 0;
  if ((any & 15u) == 0) {
    const long long n4 = n / 4;
    if (n4 > 0) {
      fadein_blend_vec4<<<grid_for(n4), kThreads, 0, s>>>(
          static_cast<const float4*>(a), static_cast<const float4*>(b),
          static_cast<float4*>(out), alpha, beta, n4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    done = n4 * 4;
  }
  if (done < n) {
    fadein_blend_scalar<<<grid_for(n - done), kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), alpha, beta, done, n);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
