// RMSNorm forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm (Pallas body
// _kernel): out = x * rsqrt(mean(x^2) + eps) * (1 + w), row by row, with the
// statistics and (1 + w) in FP32 and the result stored in x's dtype
// (float32, bfloat16 or float16; w is float32).
//
// One thread block owns one row. Its threads walk the row at a stride of
// the block, neighbouring threads on neighbouring elements, sum x^2 in FP32
// (each product and sum rounded, as the plain version's x * x then sum),
// reduce through the warps and shared memory, and read the row a second
// time (from L1 / L2: a row of d 3072 in bfloat16 is 6 KB) to write it.
//
// What bounds it on the H100: bytes -- x read once and out written once;
// about 4 FP32 operations per element. Row-tiling (the TPU's block_rows)
// changes no result, so the block walks one row and the grid covers them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

#include "lamp_device.cuh"

namespace {

using namespace lamp_dev;

constexpr int NT = 256;   // threads per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// round to nearest even, as torch's .to(dtype)
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

template <typename T>
__global__ void __launch_bounds__(NT) rmsnorm_kernel(const T* __restrict__ x,
                                                     const float* __restrict__ w,
                                                     T* __restrict__ out, int d,
                                                     float eps) {
  __shared__ float part[NT / 32];
  const size_t base = (size_t)blockIdx.x * d;
  const T* xr = x + base;
  T* orow = out + base;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += NT) {
    const float v = to_f32(xr[i]);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int j = 0; j < NT / 32; ++j) total = __fadd_rn(total, part[j]);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(total, (float)d), eps));

  for (int i = threadIdx.x; i < d; i += NT) {
    const float v = to_f32(xr[i]);
    store(orow + i, __fmul_rn(__fmul_rn(v, r), __fadd_rn(1.f, w[i])));
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (x and out). Returns the CUDA
// error of the launch (0 = cudaSuccess).
int lamp_rmsnorm(const void* x, const void* w, void* out, long long rows, int d,
                 int dtype, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)rows), block(NT);
  const float* wf = (const float*)w;
  switch (dtype) {
    case 0:
      rmsnorm_kernel<float><<<grid, block, 0, s>>>((const float*)x, wf, (float*)out, d, eps);
      break;
    case 1:
      rmsnorm_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          (const __nv_bfloat16*)x, wf, (__nv_bfloat16*)out, d, eps);
      break;
    case 2:
      rmsnorm_kernel<__half><<<grid, block, 0, s>>>((const __half*)x, wf, (__half*)out, d, eps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
