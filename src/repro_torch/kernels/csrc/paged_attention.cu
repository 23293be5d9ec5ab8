// Paged LAMP attention over mixed rows, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_prefill_attention (alias paged_mixed_attention; Pallas bodies
// _pre_stats_kernel and _pre_kernel). It computes the same function, not
// the same block structure:
//
//   pass 1 (lamp_pre_stats): per query row, the look-ahead statistics of
//       the PS(mu) logits y_low over the row's live keys: smax = max(y +
//       log|y|), m = max y, l = sum exp(y - m).
//   pass 2 (lamp_pre_attend): recompute y_low identically, select with the
//       rule (strict / relaxed / relaxed_ln) against the pass-1 statistics
//       and tau (read from device memory: the engine's per-layer taus[l]),
//       replace the selected logits by the FP32 product, run the online
//       softmax and P.V, and count selections per (row, head, query).
//
// One thread block owns one (row b, head h, tile of TQ queries). It reads
// block_tables[b], starts[b] and qlens[b] itself and walks only the keys
// its live queries can see: positions [lo, last live query], where lo is
// the first key of the first block inside the sliding window (0 without
// one). Blocks outside that range are never read, so a dead block --
// even one full of NaN -- cannot reach the output. Keys are staged in
// shared memory CK = 32 at a time (one key per lane of a warp); each warp
// carries QPW queries. GQA is resolved in the head index (kv head =
// h / (H / Hkv)), so K and V are never repeated in memory.
//
// What bounds it on the H100: the bytes of the live K and V blocks (pass 1
// reads K, pass 2 reads K and V) and, at granularity 1, the CUDA-core work
// of y_low: hd dependent multiply, add and round steps per (query, key).
// The design keeps every key read from device memory once per pass and
// tile (shared-memory staging), keeps q, the softmax state and the
// accumulator in shared memory and registers, and spreads keys over lanes
// so the sequential y_low chains of 32 keys run side by side. It uses CUDA
// cores only: no tensor cores, no TMA.
//
// Bit-exactness: y_low, round_to_mantissa and the selection rules are the
// shared helpers of lamp_device.cuh (see there).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lamp_device.cuh"

namespace {

using namespace lamp_dev;

constexpr int CK = 32;             // keys staged per chunk: one per lane
constexpr int NW = 4;              // warps per thread block
constexpr int QPW = 4;             // queries per warp
constexpr int TQ = NW * QPW;       // queries per thread block
constexpr int MAXD = 128;          // largest head dim
constexpr int DPL = MAXD / 32;     // accumulator slots per lane

struct Params {
  const float* q;        // (B, H, W, hd)
  const float* k;        // (n_blocks, bs, Hkv, hd)
  const float* v;        // (n_blocks, bs, Hkv, hd)
  const int* bt;         // (B, n_max)
  const int* starts;     // (B,)
  const int* qlens;      // (B,)
  const float* tau;      // (1,)
  float* smax;           // (B, H, W) pass-1 statistics
  float* mlow;
  float* llow;
  float* out;            // (B, H, W, hd)
  float* cnt;            // (B, H, W) selections per query and head
  int B, H, Hkv, W, hd, bs, n_max;
  int mu, gran, rule, lamp, n_ref, window;   // window <= 0: none
  float scale;
};

template <bool STATS>
__global__ void __launch_bounds__(NW * 32) paged_lamp_kernel(Params p) {
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = p.hd, bs = p.bs;
  const int w0 = t * TQ;
  const int start = p.starts[b];
  const int qe = min(min(max(p.qlens[b] - w0, 0), TQ), p.W - w0);  // live queries
  const int kvh = h / (p.H / p.Hkv);
  const size_t row = ((size_t)b * p.H + h) * p.W;

  __shared__ float sQ[TQ][MAXD];
  __shared__ float sK[CK][MAXD + 1];   // +1: lanes read different rows, same column
  __shared__ float sV[STATS ? 1 : CK][MAXD + 1];

  if (!STATS) {
    // queries past qlens[b] are padding: zero output, zero count
    for (int i = threadIdx.x; i < (TQ - qe) * hd; i += blockDim.x) {
      const int w = w0 + qe + i / hd;
      if (w < p.W) {
        p.out[(row + w) * hd + i % hd] = 0.f;
        if (i % hd == 0) p.cnt[row + w] = 0.f;
      }
    }
  }
  if (qe <= 0) return;

  for (int i = threadIdx.x; i < TQ * hd; i += blockDim.x) {
    const int qq = i / hd, d = i % hd;
    sQ[qq][d] = qq < qe ? __fmul_rn(p.q[(row + w0 + qq) * hd + d], p.scale) : 0.f;
  }

  const int q_first = start + w0;
  const int hi_key = min(q_first + qe - 1, p.n_max * bs - 1);
  int lo_blk = 0;
  if (p.window > 0) lo_blk = min(max(q_first - p.window + 1, 0) / bs, hi_key / bs);
  const int lo_key = lo_blk * bs;
  const int cap = p.window > 0 ? p.window : p.n_max * bs;    // relaxed_ln n_row cap

  const bool lamp = p.lamp != 0;
  const bool selecting = lamp && p.rule != RULE_NONE;
  const bool cast_only = p.mu >= 23 || p.gran == 0 || p.gran >= hd;
  const float tau = selecting ? *p.tau : 0.f;
  const float log_tau = logf(tau);

  // per-query state; query qq = warp + NW * i
  float st_m[QPW], st_l[QPW], st_x[QPW];       // STATS: m, l, smax. else m, l, count
  float sx[QPW], mx[QPW], lx[QPW];             // pass-1 statistics (pass 2)
  float acc[QPW][DPL];
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    st_m[i] = NEG;
    st_l[i] = 0.f;
    st_x[i] = STATS ? NEG : 0.f;
    sx[i] = mx[i] = lx[i] = 0.f;
    const int qq = warp + NW * i;
    if (!STATS && selecting && qq < qe) {
      sx[i] = p.smax[row + w0 + qq];
      mx[i] = p.mlow[row + w0 + qq];
      lx[i] = p.llow[row + w0 + qq];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  const int vec = hd / 4;
  for (int kc = lo_key; kc <= hi_key; kc += CK) {
    __syncthreads();   // sQ written / previous chunk consumed
    for (int i = threadIdx.x; i < CK * vec; i += blockDim.x) {
      const int key = i / vec, d = (i % vec) * 4;
      const int pos = kc + key;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (pos <= hi_key) {
        const int blk = p.bt[(size_t)b * p.n_max + pos / bs];
        const size_t base = (((size_t)blk * bs + pos % bs) * p.Hkv + kvh) * hd + d;
        kk = *reinterpret_cast<const float4*>(p.k + base);
        if (!STATS) vv = *reinterpret_cast<const float4*>(p.v + base);
      }
      sK[key][d] = kk.x; sK[key][d + 1] = kk.y; sK[key][d + 2] = kk.z; sK[key][d + 3] = kk.w;
      if (!STATS) {
        sV[key][d] = vv.x; sV[key][d + 1] = vv.y; sV[key][d + 2] = vv.z; sV[key][d + 3] = vv.w;
      }
    }
    __syncthreads();
    const int nk = min(CK, hi_key - kc + 1);
    const int kj = kc + lane;

#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      const int qq = warp + NW * i;
      if (qq >= qe) continue;                       // warp-uniform
      const int qi = q_first + qq;                  // absolute query position
      bool ok = lane < nk && kj <= qi;
      if (p.window > 0) ok = ok && kj > qi - p.window;
      const float* qv = sQ[qq];
      const float* kv = sK[lane];

      float exact = 0.f, y;
      bool have_exact = false;
      if (!lamp) {
        y = dot_exact(qv, kv, hd);
      } else {
        if (cast_only) {
          exact = dot_exact(qv, kv, hd);
          have_exact = true;
          y = round_to_mantissa(exact, p.mu);
        } else {
          y = dot_low_chunked(qv, kv, hd, p.mu, p.gran);
        }
      }

      if (STATS) {
        const float s = ok ? __fadd_rn(y, logf(fabsf(y))) : NEG;
        st_x[i] = fmaxf(st_x[i], warp_max(s));
        const float m_new = fmaxf(st_m[i], warp_max(ok ? y : NEG));
        const float pr = ok ? expf(y - m_new) : 0.f;
        st_l[i] = st_l[i] * expf(st_m[i] - m_new) + warp_sum(pr);
        st_m[i] = m_new;
        continue;
      }

      if (selecting) {
        const int n_row = min(max(qi + 1, 0), cap);
        const bool sel = lamp_selects(p.rule, y, ok, sx[i], mx[i], lx[i], tau,
                                      log_tau, n_row, p.n_ref);
        st_x[i] += (float)__popc(__ballot_sync(FULL, sel));
        if (sel) y = have_exact ? exact : dot_exact(qv, kv, hd);
      }

      y = ok ? y : NEG;
      const float m_new = fmaxf(st_m[i], warp_max(y));
      const float pr = ok ? expf(y - m_new) : 0.f;
      const float corr = expf(st_m[i] - m_new);
      st_l[i] = st_l[i] * corr + warp_sum(pr);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= corr;
      for (int key = 0; key < nk; ++key) {
        const float pj = __shfl_sync(FULL, pr, key);
        if (pj == 0.f) continue;                    // masked key: never read its V
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < hd) acc[i][j] = fmaf(pj, sV[key][d], acc[i][j]);
        }
      }
      st_m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    const int qq = warp + NW * i;
    if (qq >= qe) continue;
    const size_t r = row + w0 + qq;
    if (STATS) {
      if (lane == 0) {
        p.smax[r] = st_x[i];
        p.mlow[r] = st_m[i];
        p.llow[r] = st_l[i];
      }
    } else {
      const float inv_l = fmaxf(st_l[i], TINY);
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) p.out[r * hd + d] = acc[i][j] / inv_l;
      }
      if (lane == 0) p.cnt[r] = st_x[i];
    }
  }
}

__global__ void round_to_mantissa_kernel(const float* x, float* y, long long n, int mu) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = round_to_mantissa(x[i], mu);
}

}  // namespace

extern "C" {

// pass 1 = look-ahead statistics, pass 2 = select, recompute and attend.
// Returns the CUDA error of the launch (0 = cudaSuccess).
int lamp_paged_mixed_attention(const void* q, const void* k, const void* v,
                               const void* bt, const void* starts, const void* qlens,
                               const void* tau, void* smax, void* mlow, void* llow,
                               void* out, void* cnt,
                               int B, int H, int Hkv, int W, int hd, int bs, int n_max,
                               int mu, int gran, int rule, int lamp, int n_ref,
                               int window, float scale, int pass, void* stream) {
  Params p;
  p.q = (const float*)q; p.k = (const float*)k; p.v = (const float*)v;
  p.bt = (const int*)bt; p.starts = (const int*)starts; p.qlens = (const int*)qlens;
  p.tau = (const float*)tau;
  p.smax = (float*)smax; p.mlow = (float*)mlow; p.llow = (float*)llow;
  p.out = (float*)out; p.cnt = (float*)cnt;
  p.B = B; p.H = H; p.Hkv = Hkv; p.W = W; p.hd = hd; p.bs = bs; p.n_max = n_max;
  p.mu = mu; p.gran = gran; p.rule = rule; p.lamp = lamp; p.n_ref = n_ref;
  p.window = window; p.scale = scale;
  if (hd > MAXD || hd % 4 != 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TQ - 1) / TQ, H, B), block(NW * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (pass == 1) {
    paged_lamp_kernel<true><<<grid, block, 0, s>>>(p);
  } else {
    paged_lamp_kernel<false><<<grid, block, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

int lamp_round_to_mantissa(const void* x, void* y, long long n, int mu, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  round_to_mantissa_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n, mu);
  return (int)cudaGetLastError();
}

}  // extern "C"
