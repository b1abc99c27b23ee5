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
// [4, 3, 1024, 1024] (151 MB, 45.07 us at 3.35 TB/s) and the D blend
// [4, 32, 512, 512] (403 MB, 120.19 us).
//
// Design. The first version (a grid-stride loop capped at 8 blocks of 256
// threads per SM, a device query on every launch) reached 81-84% of the
// memory rate and lost to torch.lerp by 3-8%. This one:
//   - covers n in one pass: a grid of ceil(n / 4 / 1024) blocks of 1024
//     threads, one float4 of a, b and out per thread, no grid-stride loop
//     and no cap, so blocks retire and refill SMs with no tail wave of a
//     strided walk; it needs no SM count, so the host queries nothing per
//     launch;
//   - loads with __ldcs and stores with __stcs (evict-first streaming): no
//     byte is reused, and 151 MB and 403 MB exceed the 50 MB L2. The
//     streaming store mattered most among the variants tried;
//   - keeps 64-bit indices and a scalar kernel for the ragged tail (n % 4)
//     and for pointers off a 16-byte boundary.
// Variants tried on the card before this choice: 2, 4 or 8 float4s of a and
// of b in flight per thread (each slower than one), 128 to 1024 threads per
// block, a grid-stride loop of whole waves, plain or L2-prefetching loads,
// an L2 evict-first policy and a permuted block order. Full occupancy
// already keeps enough loads in flight, so plain vector loads were kept
// over a cp.async.bulk pipeline through shared memory, which would stage
// bytes that are used once.
// The products and the sum are rounded separately (__fmul_rn, __fadd_rn, no
// fused multiply-add), as the plain PyTorch version rounds them, and
// 1 - alpha comes from the wrapper, so the two agree bit for bit. The
// kernel allocates nothing and launches on the caller's stream.
//
// Measured by chip_smoke.py phase 8 (device time of CUDA-graph replays;
// PERF.md section 6 has every run): on an H100 80GB HBM3 at 700 W, the G
// blend [4, 3, 1024, 1024] takes 50.81-51.08 us and the D blend
// [4, 32, 512, 512] 131.35-131.64 us (2.96-3.07 TB/s), against torch.lerp's
// 51.32-51.53 and 132.12-132.25 us and the first version's 52.92-53.14 and
// 140.48-140.49 us in the same call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float blend(float alpha, float beta, float x, float y) {
  return __fadd_rn(__fmul_rn(alpha, x), __fmul_rn(beta, y));
}

// One float4 of a, b and out per thread; the grid covers n4 in one pass.
__global__ void __launch_bounds__(kThreads)
fadein_blend_vec4(const float4* __restrict__ a, const float4* __restrict__ b,
                  float4* __restrict__ out, float alpha, float beta, long long n4) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n4) {
    const float4 x = __ldcs(a + i);
    const float4 y = __ldcs(b + i);
    __stcs(out + i, make_float4(blend(alpha, beta, x.x, y.x), blend(alpha, beta, x.y, y.y),
                                blend(alpha, beta, x.z, y.z), blend(alpha, beta, x.w, y.w)));
  }
}

__global__ void __launch_bounds__(kThreads)
fadein_blend_scalar(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, float alpha, float beta,
                    long long begin, long long n) {
  const long long i = begin + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) __stcs(out + i, blend(alpha, beta, __ldcs(a + i), __ldcs(b + i)));
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
      const long long blocks = (n4 + kThreads - 1) / kThreads;
      fadein_blend_vec4<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const float4*>(a), static_cast<const float4*>(b),
          static_cast<float4*>(out), alpha, beta, n4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    done = n4 * 4;
  }
  if (done < n) {
    const long long blocks = (n - done + kThreads - 1) / kThreads;
    fadein_blend_scalar<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), alpha, beta, done, n);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
