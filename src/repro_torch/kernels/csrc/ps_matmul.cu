// Blocked matmul with PS(mu) accumulation, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ps_matmul.py::ps_matmul (Pallas body
// _kernel): C = A @ B, (M, K) @ (K, N) in FP32, where every output's running
// accumulator is rounded to PS(mu) each time the FP32 partial sum of one
// block_k slab of K is added to it (no rounding at mu >= 23).
//
// block_k is semantics (it fixes the rounding points); the output tiling is
// not. One thread block owns a 64 x 64 output tile, 256 threads each owning
// 4 x 4 outputs (rows ty + 16 i, columns tx + 16 j, so the warps' shared
// memory reads are broadcasts or consecutive). K is walked in order in
// tiles of 16 staged in shared memory (A transposed and padded); each
// output's slab sum runs lane by lane, k ascending, every product and sum
// rounded to FP32 (__fmul_rn / __fadd_rn, built with -fmad=false), so the
// kernel is bit-exact with the plain version
// (repro_torch.kernels.ps_matmul.slab_sums), which spells the same order.
//
// What bounds it on the H100: operations -- 2 M N K FP32 operations on the
// CUDA cores, issued as a separate multiply and add (no FMA: the rounding
// points are the product's and the sum's), against (M K + K N + M N) 4
// bytes. Tensor cores would sum a slab in another order; that is a later
// design, which must then name a one-step slack against the plain version.

#include <cuda_runtime.h>
#include <math.h>

#include "lamp_device.cuh"

namespace {

using namespace lamp_dev;

constexpr int BM = 64, BN = 64;   // output tile
constexpr int BKT = 16;           // k staged per shared-memory tile
constexpr int TM = 4, TN = 4;     // outputs per thread
constexpr int NT = 256;           // threads: 16 x 16

__global__ void __launch_bounds__(NT) ps_matmul_kernel(const float* __restrict__ A,
                                                       const float* __restrict__ B,
                                                       float* __restrict__ C, int M,
                                                       int N, int K, int mu, int bk) {
  __shared__ float sA[BKT][BM + 1];   // sA[k][m]
  __shared__ float sB[BKT][BN];       // sB[k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN], part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = part[i][j] = 0.f;

  int in_slab = 0;
  for (int k0 = 0; k0 < K; k0 += BKT) {
    for (int i = threadIdx.x; i < BM * BKT; i += NT) {
      const int m = i / BKT, kk = i % BKT;
      const int gm = m0 + m, gk = k0 + kk;
      sA[kk][m] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = threadIdx.x; i < BKT * BN; i += NT) {
      const int kk = i / BN, n = i % BN;
      const int gk = k0 + kk, gn = n0 + n;
      sB[kk][n] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
    const int kend = min(BKT, K - k0);
    for (int kk = 0; kk < kend; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sA[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          part[i][j] = __fadd_rn(part[i][j], __fmul_rn(a[i], b[j]));
      if (++in_slab == bk) {   // the slab is complete: fold and round
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = round_to_mantissa(__fadd_rn(acc[i][j], part[i][j]), mu);
            part[i][j] = 0.f;
          }
        in_slab = 0;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// A (M, K), B (K, N), C (M, N), all float32 row-major; block_k divides K.
// Returns the CUDA error of the launch (0 = cudaSuccess).
int lamp_ps_matmul(const void* a, const void* b, void* c, int M, int N, int K,
                   int mu, int block_k, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || block_k <= 0 || K % block_k != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM), block(NT);
  ps_matmul_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)c, M, N, K, mu, block_k);
  return (int)cudaGetLastError();
}

}  // extern "C"
