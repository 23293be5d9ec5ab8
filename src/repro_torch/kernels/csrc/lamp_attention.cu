// One-pass relaxed-LAMP flash attention, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lamp_attention.py::
// lamp_flash_attention (Pallas body _kernel), the paper's Sec 4.4 rule: for
// each query row, the keys are walked in k-blocks of block_k; the PS(mu)
// logits y_low (q . k summed in chunks of k_subtile lanes, the running sum
// rounded to PS(mu) after each chunk; unrounded at mu >= 23) of k-block ik
// are selected against the RUNNING row max of s = y + log|y| over k-blocks
// 0..ik, the current block included: select when s > log(max(tau, 1e-30)) +
// smax. Selected logits are replaced by the FP32 product; online softmax
// and P.V give the output. Causal or not; selections counted per query row
// in integers.
//
// block_k is semantics here (it fixes the selection checkpoints), block_q
// is not. One thread block owns QT = 16 query rows of one (b, h), four
// rows per warp. For each k-block it runs two phases over chunks of CK keys
// staged in shared memory (K rows padded to D + 1, one key per lane):
//   A: y_low of every (row, key) of the block, kept in shared memory
//      (QT x block_k floats), and the block's row max of s folded into each
//      row's running smax;
//   B: with K and V staged again, select against the updated smax,
//      recompute the selected logits in FP32, and update the row's online
//      softmax (m, l and acc over the warp's lanes).
// Keys past the tile's last row are masked for every row of the tile when
// causal, so those keys (and wholly masked k-blocks) are never read.
//
// What bounds it on the H100: operations -- per causal (query, key) pair,
// D dependent multiply and add steps for y_low and D multiply-adds of P.V
// on the CUDA cores, against bytes that are read once per head (q, K, V,
// out). No tensor cores: a mma tile would sum each chunk in another order
// than the plain version; that is a later design.

#include <cuda_runtime.h>
#include <math.h>

#include "lamp_device.cuh"

namespace {

using namespace lamp_dev;

constexpr int NW = 4;              // warps per thread block
constexpr int QT = 16;             // query rows per thread block
constexpr int RPW = QT / NW;       // query rows per warp
constexpr int CK = 64;             // keys staged per chunk
constexpr int MAXD = 128;          // largest head dim
constexpr int DPL = MAXD / 32;     // accumulator slots per lane

struct Params {
  const float* q;        // (BH, T, D)
  const float* k;        // (BH, S, D)
  const float* v;        // (BH, S, D)
  float* out;            // (BH, T, D)
  int* cnt;              // (BH, T) selections per query row
  int T, S, D, mu, sub, causal, bk;
  float log_tau, scale;
};

// dynamic shared memory in floats: q tile, K chunk (padded), V chunk, y_low
// of one k-block for every row of the tile
__host__ __device__ constexpr int smem_floats(int D, int bk) {
  return QT * D + CK * (D + 1) + CK * D + QT * bk;
}

__global__ void __launch_bounds__(NW * 32) lamp_attention_kernel(Params p) {
  extern __shared__ float smem[];
  const int bh = blockIdx.y, q0 = blockIdx.x * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = p.D, ks = D + 1, bk = p.bk;
  float* sQ = smem;
  float* sK = sQ + QT * D;
  float* sV = sK + CK * ks;
  float* sY = sV + CK * D;

  const float* kb = p.k + (size_t)bh * p.S * D;
  const float* vb = p.v + (size_t)bh * p.S * D;
  for (int i = threadIdx.x; i < QT * D; i += blockDim.x) {
    const int row = q0 + i / D;
    sQ[i] = row < p.T ? __fmul_rn(p.q[((size_t)bh * p.T + row) * D + i % D], p.scale) : 0.f;
  }
  const int last_row = min(q0 + QT, p.T) - 1;
  const int key_end = p.causal ? min(p.S, last_row + 1) : p.S;

  float m[RPW], l[RPW], smax[RPW], acc[RPW][DPL];
  int count[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
    smax[r] = NEG;
    count[r] = 0;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }

  const int vec = D / 4;
  for (int kb0 = 0; kb0 < key_end; kb0 += bk) {
    const int kb_end = min(kb0 + bk, key_end);

    // phase A: y_low of the block, and its row max of s
    float bmax[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) bmax[r] = NEG;
    for (int kc = kb0; kc < kb_end; kc += CK) {
      __syncthreads();   // sQ written / previous chunk consumed
      for (int i = threadIdx.x; i < CK * vec; i += blockDim.x) {
        const int key = i / vec, d = (i % vec) * 4;
        float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kc + key < kb_end)
          kk = *reinterpret_cast<const float4*>(kb + (size_t)(kc + key) * D + d);
        float* kr = sK + key * ks + d;
        kr[0] = kk.x; kr[1] = kk.y; kr[2] = kk.z; kr[3] = kk.w;
      }
      __syncthreads();
      for (int g = 0; g < CK; g += 32) {
        if (kc + g >= kb_end) break;               // uniform over the block
        const int kj = kc + g + lane;
        const bool in_block = kj < kb_end;
        const float* kr = sK + (g + lane) * ks;
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int lr = warp * RPW + r, row = q0 + lr;
          const bool ok = in_block && row < p.T && (!p.causal || kj <= row);
          const float y = dot_low_chunked(sQ + lr * D, kr, D, p.mu, p.sub);
          if (in_block) sY[lr * bk + (kj - kb0)] = y;
          const float s = ok ? __fadd_rn(y, logf(fabsf(y))) : NEG;   // -inf at y == 0
          bmax[r] = fmaxf(bmax[r], s);
        }
      }
    }
    float thr[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      smax[r] = fmaxf(smax[r], warp_max(bmax[r]));
      thr[r] = __fadd_rn(p.log_tau, smax[r]);
    }

    // phase B: select, recompute, online softmax and P.V
    for (int kc = kb0; kc < kb_end; kc += CK) {
      __syncthreads();
      for (int i = threadIdx.x; i < CK * vec; i += blockDim.x) {
        const int key = i / vec, d = (i % vec) * 4;
        float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
        if (kc + key < kb_end) {
          kk = *reinterpret_cast<const float4*>(kb + (size_t)(kc + key) * D + d);
          vv = *reinterpret_cast<const float4*>(vb + (size_t)(kc + key) * D + d);
        }
        float* kr = sK + key * ks + d;
        kr[0] = kk.x; kr[1] = kk.y; kr[2] = kk.z; kr[3] = kk.w;
        *reinterpret_cast<float4*>(sV + key * D + d) = vv;
      }
      __syncthreads();
      for (int g = 0; g < CK; g += 32) {
        if (kc + g >= kb_end) break;
        const int kj = kc + g + lane;
        const bool in_block = kj < kb_end;
        const float* kr = sK + (g + lane) * ks;
        const float* vw = sV + g * D;
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int lr = warp * RPW + r, row = q0 + lr;
          const bool ok = in_block && row < p.T && (!p.causal || kj <= row);
          float y = in_block ? sY[lr * bk + (kj - kb0)] : 0.f;
          const float s = ok ? __fadd_rn(y, logf(fabsf(y))) : NEG;
          const bool sel = ok && s > thr[r];
          count[r] += __popc(__ballot_sync(FULL, sel));
          if (sel) y = dot_exact(sQ + lr * D, kr, D);
          y = ok ? y : NEG;
          const float m_new = fmaxf(m[r], warp_max(y));
          const float pr = ok ? expf(y - m_new) : 0.f;
          const float corr = expf(m[r] - m_new);
          l[r] = l[r] * corr + warp_sum(pr);
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[r][j] *= corr;
          for (int key = 0; key < 32; ++key) {
            const float pj = __shfl_sync(FULL, pr, key);
            if (pj == 0.f) continue;               // masked key: its V is not used
#pragma unroll
            for (int j = 0; j < DPL; ++j) {
              const int d = lane + 32 * j;
              if (d < D) acc[r][j] = fmaf(pj, vw[key * D + d], acc[r][j]);
            }
          }
          m[r] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= p.T) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* o = p.out + ((size_t)bh * p.T + row) * D;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) o[d] = acc[r][j] / den;
    }
    if (lane == 0) p.cnt[(size_t)bh * p.T + row] = count[r];
  }
}

cudaError_t opt_in_smem(size_t bytes) {
  static size_t granted = 48 * 1024;
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      lamp_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs, in bytes (the wrapper checks it
// against the card's limit before launching).
long long lamp_flash_attention_smem(int D, int block_k) {
  return (long long)sizeof(float) * smem_floats(D, block_k);
}

// q (BH, T, D), k and v (BH, S, D), out (BH, T, D) float32; cnt (BH, T)
// int32; block_k divides S. Returns the CUDA error of the launch
// (0 = cudaSuccess).
int lamp_flash_attention(const void* q, const void* k, const void* v, void* out,
                         void* cnt, int BH, int T, int S, int D, int mu,
                         int k_subtile, int causal, int block_k, float log_tau,
                         float scale, void* stream) {
  if (D > MAXD || D % 4 != 0 || D <= 0 || k_subtile <= 0 || block_k <= 0 || S % block_k != 0)
    return (int)cudaErrorInvalidValue;
  if (BH <= 0 || T <= 0) return 0;
  Params p;
  p.q = (const float*)q; p.k = (const float*)k; p.v = (const float*)v;
  p.out = (float*)out; p.cnt = (int*)cnt;
  p.T = T; p.S = S; p.D = D; p.mu = mu; p.sub = k_subtile; p.causal = causal;
  p.bk = block_k; p.log_tau = log_tau; p.scale = scale;
  const size_t bytes = sizeof(float) * smem_floats(D, block_k);
  const cudaError_t err = opt_in_smem(bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + QT - 1) / QT, BH), block(NW * 32);
  lamp_attention_kernel<<<grid, block, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
