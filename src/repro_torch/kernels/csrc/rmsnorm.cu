// RMSNorm forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm (Pallas body
// _kernel): out = x * rsqrt(mean(x^2) + eps) * (1 + w), row by row, with the
// statistics and (1 + w) in FP32 and the result stored in x's dtype
// (float32, bfloat16 or float16; w is float32). Row-tiling (the TPU's
// block_rows) changes no result.
//
// What bounds it on the H100: bytes -- x read once and out written once,
// for about 4 FP32 operations an element. What the design does about it
// (the vector path):
//   - A row belongs to ROW_WARPS = 2 warps, and holds in their registers as
//     16-byte vectors, all of a thread's loads issued together (d 3,072 in
//     bfloat16: 6 vectors a thread), so x crosses HBM exactly once. The
//     blocks (4 rows each) walk the rows at a grid stride, over a grid of
//     as many blocks as the card holds at once.
//   - x^2 is summed in FP32, each thread over its vectors (r, r + 64, ...
//     for thread r of its row; the elements of a vector in order), across
//     each warp by an xor butterfly of shuffles (which leaves the same total
//     in every lane), and the row's two warp sums added in warp order
//     through shared memory: one barrier a row.
//   - (1 + w) comes from float4 loads of w (12 KB at d 3,072, resident in
//     L1 / L2 for every row), and the output is written straight from the
//     registers in 16-byte stores.
//   - Why two warps a row and not one: a whole row a warp (12 vectors a
//     lane at d 3,072) costs 80 registers a thread or more and ran 15%
//     slower on the card at the Gemma-7B row; four and eight warps a row
//     ran 3% and 7% slower than two (launch/rmsnorm_variants.py).
// The general path keeps a block of 256 threads a row, walking the row at
// a stride of the block and reading it a second time (from L1 / L2) to
// write it. It takes a row that is not a whole number of 16-byte vectors,
// x, w or out not 16-byte aligned, and a row past the register budget
// VEC_MAX_BYTES.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "lamp_device.cuh"

namespace {

using namespace lamp_dev;

constexpr int NT = 256;                  // threads per block
constexpr int WPB = NT / 32;             // warps per block
constexpr int ROW_WARPS = 2;             // vector path: warps a row
constexpr int RPB = WPB / ROW_WARPS;     // vector path: rows a block holds at once
constexpr int VEC_MAX_BYTES = 16384;     // vector path: 8,192 two-byte or 4,096
                                         // four-byte elements a row at most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// round to nearest even, as torch's .to(dtype)
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

// A 16-byte vector of T as floats, and back (rounded to nearest even).
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <> struct Vec<__half> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The vector path. A row belongs to ROW_WARPS warps (RPB rows a block);
// thread r of a row's 32 ROW_WARPS holds its vectors r, r + 32 ROW_WARPS,
// ... (at most NV, a bucket of d) in registers.
template <typename T, int NV>
__global__ void __launch_bounds__(NT) rmsnorm_vec_kernel(const T* __restrict__ x,
                                                         const float* __restrict__ w,
                                                         T* __restrict__ out,
                                                         long long rows, int d,
                                                         float eps) {
  constexpr int N = Vec<T>::N, RT = 32 * ROW_WARPS;
  __shared__ float part[2][WPB];
  const int warp = threadIdx.x >> 5, r = threadIdx.x % RT, nvec = d / N;
  const float fd = (float)d;
  int parity = 0;
  for (long long row0 = (long long)blockIdx.x * RPB; row0 < rows;
       row0 += (long long)gridDim.x * RPB, parity ^= 1) {
    const long long row = row0 + threadIdx.x / RT;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * d);
    uint4 buf[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (live && r + RT * i < nvec) buf[i] = __ldcs(xr + r + RT * i);

    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live && r + RT * i < nvec) {
        float f[N];
        Vec<T>::unpack(buf[i], f);
#pragma unroll
        for (int e = 0; e < N; ++e) ss = __fadd_rn(ss, __fmul_rn(f[e], f[e]));
      }
    }
    ss = warp_sum(ss);
    if (ROW_WARPS > 1) {            // the row's warps, in order, through shared memory
      if ((threadIdx.x & 31) == 0) part[parity][warp] = ss;
      __syncthreads();
      const int w0 = warp - warp % ROW_WARPS;
      ss = part[parity][w0];
      for (int j = 1; j < ROW_WARPS; ++j) ss = __fadd_rn(ss, part[parity][w0 + j]);
    }
    if (!live) continue;
    const float rs = rsqrtf(__fadd_rn(__fdiv_rn(ss, fd), eps));

    uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = r + RT * i;
      if (v < nvec) {
        float f[N];
        Vec<T>::unpack(buf[i], f);
#pragma unroll
        for (int e = 0; e < N; e += 4) {
          const float4 w4 = __ldg(reinterpret_cast<const float4*>(w + v * N + e));
          f[e] = __fmul_rn(__fmul_rn(f[e], rs), __fadd_rn(1.f, w4.x));
          f[e + 1] = __fmul_rn(__fmul_rn(f[e + 1], rs), __fadd_rn(1.f, w4.y));
          f[e + 2] = __fmul_rn(__fmul_rn(f[e + 2], rs), __fadd_rn(1.f, w4.z));
          f[e + 3] = __fmul_rn(__fmul_rn(f[e + 3], rs), __fadd_rn(1.f, w4.w));
        }
        __stcs(orow + v, Vec<T>::pack(f));
      }
    }
  }
}

// The general path: a block a row.
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

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

bool vector_path(const void* x, const void* w, const void* out, int d, int elem) {
  return d % (16 / elem) == 0 && (long long)d * elem <= VEC_MAX_BYTES && aligned16(x) &&
         aligned16(w) && aligned16(out);
}

// As many blocks as the card holds at once, or fewer if the rows need fewer.
template <typename T, int NV>
cudaError_t launch_vec(const T* x, const float* w, T* out, long long rows, int d,
                       float eps, cudaStream_t s) {
  static int per_sm = 0;
  cudaError_t err;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rmsnorm_vec_kernel<T, NV>,
                                                        NT, 0);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  const long long need = (rows + RPB - 1) / RPB;
  const long long fit = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const dim3 grid((unsigned)(need < fit ? need : fit));
  rmsnorm_vec_kernel<T, NV><<<grid, NT, 0, s>>>(x, w, out, rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* w, void* out, long long rows, int d,
                   float eps, cudaStream_t s) {
  const T* xt = (const T*)x;
  T* ot = (T*)out;
  if (!vector_path(x, w, out, d, sizeof(T))) {
    if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_kernel<T><<<(unsigned)rows, NT, 0, s>>>(xt, w, ot, d, eps);
    return cudaGetLastError();
  }
  // the vectors a thread holds, rounded up to a bucket
  const int per = (d / Vec<T>::N + 32 * ROW_WARPS - 1) / (32 * ROW_WARPS);
  if (per <= 1) return launch_vec<T, 1>(xt, w, ot, rows, d, eps, s);
  if (per <= 2) return launch_vec<T, 2>(xt, w, ot, rows, d, eps, s);
  if (per <= 3) return launch_vec<T, 3>(xt, w, ot, rows, d, eps, s);
  if (per <= 4) return launch_vec<T, 4>(xt, w, ot, rows, d, eps, s);
  if (per <= 6) return launch_vec<T, 6>(xt, w, ot, rows, d, eps, s);
  if (per <= 8) return launch_vec<T, 8>(xt, w, ot, rows, d, eps, s);
  if (per <= 12) return launch_vec<T, 12>(xt, w, ot, rows, d, eps, s);
  if (per <= 16) return launch_vec<T, 16>(xt, w, ot, rows, d, eps, s);
  // VEC_MAX_BYTES is 16 vectors a thread at two warps a row
  return cudaErrorInvalidValue;
}

const int ELEM[3] = {4, 2, 2};

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (x and out). Returns the CUDA
// error of the launch (0 = cudaSuccess).
int lamp_rmsnorm(const void* x, const void* w, void* out, long long rows, int d,
                 int dtype, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* wf = (const float*)w;
  if (dtype == 0) return (int)launch<float>(x, wf, out, rows, d, eps, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, wf, out, rows, d, eps, s);
  return (int)launch<__half>(x, wf, out, rows, d, eps, s);
}

// 1 where lamp_rmsnorm takes the vector path for these pointers, d and
// dtype, else 0.
int lamp_rmsnorm_vector_path(const void* x, const void* w, const void* out, int d,
                             int dtype) {
  if (d <= 0 || dtype < 0 || dtype > 2) return 0;
  return vector_path(x, w, out, d, ELEM[dtype]) ? 1 : 0;
}

}  // extern "C"
