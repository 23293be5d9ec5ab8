// LAMP decode attention over a dense KV cache (exact two-pass relaxed
// rule), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::flash_decode
// (Pallas bodies _smax_kernel and _decode_kernel). One query per (batch b,
// head h) attends to the valid keys [0, length[b]) of a (B, H, S, D) cache:
//
//   pass 1 (stats): smax = max(y + log|y|) of the PS(mu) logits y_low over
//       the valid keys. y_low sums q . k in chunks of k_subtile lanes and
//       rounds the running sum to PS(mu) after each chunk (unrounded at
//       mu >= 23).
//   pass 2 (attend): recompute y_low identically, select the keys with
//       y + log|y| > log(max(tau, 1e-30)) + smax, replace their logits by
//       the FP32 product, online softmax and P.V; count selections per
//       (b, h) in integers. A row of length 0 gives 0, as in JAX.
//
// The grid's block_k is no part of the result, so one thread block owns one
// (b, h) and walks its valid keys in chunks of NW * 32 staged in shared
// memory (one key per thread; K rows padded to D + 1 against bank
// conflicts), every lane running its key's y_low chain; keys past
// length[b] are never read. Each warp keeps its own online-softmax state;
// the warps merge through shared memory at the end (the layout of
// paged_decode.cu, over a dense cache).
//
// What bounds it on the H100: the bytes of the valid K (pass 1) and K and V
// (pass 2) rows, and the CUDA-core work of y_low (D dependent multiply and
// add steps per key). One thread block per (b, h) leaves SMs idle at small
// batch; a split over keys is for a later PR.

#include <cuda_runtime.h>
#include <math.h>

#include "lamp_device.cuh"

namespace {

using namespace lamp_dev;

constexpr int NW = 4;              // warps per thread block
constexpr int CK = NW * 32;        // keys staged per chunk: one per thread
constexpr int MAXD = 128;          // largest head dim
constexpr int DPL = MAXD / 32;     // accumulator slots per lane

struct Params {
  const float* q;        // (BH, D): the (B, H, 1, D) queries
  const float* k;        // (BH, S, D)
  const float* v;        // (BH, S, D)
  const int* length;     // (B,)
  float* smax;           // (BH,) pass-1 statistic
  float* out;            // (BH, D)
  int* cnt;              // (BH,) selections
  int H, S, D, mu, sub;
  float log_tau, scale;
};

__host__ __device__ constexpr int smem_floats(int D, bool stats) {
  return MAXD + CK * (D + 1) + (stats ? 0 : CK * D);
}

template <bool STATS>
__global__ void __launch_bounds__(NW * 32) flash_decode_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ int sC[NW];
  const int bh = blockIdx.x, b = bh / p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = p.D, ks = D + 1;
  float* sQ = smem;
  float* sK = smem + MAXD;
  float* sV = sK + CK * ks;

  const int L = min(max(p.length[b], 0), p.S);
  const float* kb = p.k + (size_t)bh * p.S * D;
  const float* vb = p.v + (size_t)bh * p.S * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    sQ[d] = __fmul_rn(p.q[(size_t)bh * D + d], p.scale);
  const float thr = STATS ? 0.f : __fadd_rn(p.log_tau, p.smax[bh]);

  // this warp's state. STATS: smax. Else: m, l, count, acc
  float st_m = NEG, st_l = 0.f, st_x = NEG;
  int count = 0;
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  const int vec = D / 4;
  for (int kc = 0; kc < L; kc += CK) {
    __syncthreads();   // sQ written / previous chunk consumed
    for (int i = threadIdx.x; i < CK * vec; i += blockDim.x) {
      const int key = i / vec, d = (i % vec) * 4;
      const int pos = kc + key;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (pos < L) {
        kk = *reinterpret_cast<const float4*>(kb + (size_t)pos * D + d);
        if (!STATS) vv = *reinterpret_cast<const float4*>(vb + (size_t)pos * D + d);
      }
      float* kr = sK + key * ks + d;
      kr[0] = kk.x; kr[1] = kk.y; kr[2] = kk.z; kr[3] = kk.w;
      if (!STATS) *reinterpret_cast<float4*>(sV + key * D + d) = vv;
    }
    __syncthreads();
    const int kw = kc + warp * 32;                  // this warp's first key
    if (kw >= L) continue;                          // warp-uniform
    const bool ok = kw + lane < L;
    const float* kv = sK + (warp * 32 + lane) * ks;
    float y = dot_low_chunked(sQ, kv, D, p.mu, p.sub);
    const float s = ok ? __fadd_rn(y, logf(fabsf(y))) : NEG;   // -inf at y == 0

    if (STATS) {
      st_x = fmaxf(st_x, warp_max(s));
      continue;
    }

    const bool sel = ok && s > thr;
    count += __popc(__ballot_sync(FULL, sel));
    if (sel) y = dot_exact(sQ, kv, D);
    y = ok ? y : NEG;
    const float m_new = fmaxf(st_m, warp_max(y));
    const float pr = ok ? expf(y - m_new) : 0.f;
    const float corr = expf(st_m - m_new);
    st_l = st_l * corr + warp_sum(pr);
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= corr;
    const float* vw = sV + warp * 32 * D;
    for (int key = 0; key < 32; ++key) {
      const float pj = __shfl_sync(FULL, pr, key);
      if (pj == 0.f) continue;                      // masked key: never read its V
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc[j] = fmaf(pj, vw[key * D + d], acc[j]);
      }
    }
    st_m = m_new;
  }

  // merge the warps' partial states through shared memory (the key buffer
  // is free now)
  __syncthreads();
  float* sM = sK;
  float* sL = sM + NW;
  float* sX = sL + NW;
  float* sA = sX + NW;                              // (NW, D)
  if (lane == 0) {
    sM[warp] = st_m;
    sL[warp] = st_l;
    sX[warp] = st_x;
    sC[warp] = count;
  }
  if (!STATS) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) sA[warp * D + d] = acc[j];
    }
  }
  __syncthreads();
  if (STATS) {
    if (threadIdx.x == 0) {
      float x = NEG;
      for (int w = 0; w < NW; ++w) x = fmaxf(x, sX[w]);
      p.smax[bh] = x;
    }
    return;
  }
  float m = NEG;
  for (int w = 0; w < NW; ++w) m = fmaxf(m, sM[w]);
  float l = 0.f;
  for (int w = 0; w < NW; ++w) l += sL[w] * expf(sM[w] - m);
  const float den = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int w = 0; w < NW; ++w) a += sA[w * D + d] * expf(sM[w] - m);
    p.out[(size_t)bh * D + d] = a / den;
  }
  if (threadIdx.x == 0) {
    int c = 0;
    for (int w = 0; w < NW; ++w) c += sC[w];
    p.cnt[bh] = c;
  }
}

// Above 48 KB a block's dynamic shared memory must be opted into; done once
// per instantiation (again only for a larger size than granted).
template <bool STATS>
cudaError_t opt_in_smem(size_t bytes) {
  static size_t granted = 48 * 1024;
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

}  // namespace

extern "C" {

// pass 1 = smax, pass 2 = select, recompute and attend. q (BH, D), k and v
// (BH, S, D) float32, length (B,) int32 with B = BH / H; smax (BH,) float32,
// out (BH, D) float32, cnt (BH,) int32. Returns the CUDA error of the launch
// (0 = cudaSuccess).
int lamp_flash_decode(const void* q, const void* k, const void* v, const void* length,
                      void* smax, void* out, void* cnt, int BH, int H, int S, int D,
                      int mu, int k_subtile, float log_tau, float scale, int pass,
                      void* stream) {
  if (D > MAXD || D % 4 != 0 || D <= 0 || H <= 0 || k_subtile <= 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  if (BH <= 0) return 0;
  Params p;
  p.q = (const float*)q; p.k = (const float*)k; p.v = (const float*)v;
  p.length = (const int*)length; p.smax = (float*)smax; p.out = (float*)out;
  p.cnt = (int*)cnt;
  p.H = H; p.S = S; p.D = D; p.mu = mu; p.sub = k_subtile;
  p.log_tau = log_tau; p.scale = scale;
  const dim3 grid(BH), block(NW * 32);
  cudaStream_t s = (cudaStream_t)stream;
  const bool stats = pass == 1;
  const size_t bytes = sizeof(float) * smem_floats(D, stats);
  const cudaError_t err = stats ? opt_in_smem<true>(bytes) : opt_in_smem<false>(bytes);
  if (err != cudaSuccess) return (int)err;
  if (stats) {
    flash_decode_kernel<true><<<grid, block, bytes, s>>>(p);
  } else {
    flash_decode_kernel<false><<<grid, block, bytes, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
