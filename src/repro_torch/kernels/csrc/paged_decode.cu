// Paged LAMP decode attention, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_decode_attention (Pallas bodies _dec_stats_kernel and _dec_kernel,
// mask _dec_mask). One query per (row r, head h) attends to the valid keys
// [0, lengths[r]) of row r's block table -- the last `window` of them with a
// sliding window -- in the same two passes:
//
//   pass 1 (stats): smax = max(y + log|y|), m = max y and l = sum exp(y - m)
//       of the PS(mu) logits y_low over the valid keys. Only launched for a
//       rule that selects (not for "none", not with LAMP off).
//   pass 2 (attend): recompute y_low identically, select with the rule
//       against the pass-1 statistics and tau (read from device memory: the
//       engine's per-layer taus[l]), replace the selected logits by the FP32
//       product, online softmax and P.V, and count selections per (r, h).
//       relaxed_ln's row length is lengths[r], not capped by the window, as
//       in the JAX kernel.
//
// One thread block owns one (row, head). It reads lengths[r] and
// block_tables[r] itself and walks only positions [lo, L - 1], where lo is
// the first key of the first block inside the window (0 without one): a dead
// block, even one full of NaN, is never read. All NW warps stage a chunk of
// NW * 32 keys (and, in pass 2, their values) in shared memory, one key per
// thread, and every lane runs its key's y_low chain. Each warp keeps its own
// online-softmax state (m, l, and acc[hd] spread over its lanes); the warps
// merge through shared memory at the end. GQA is resolved in the head index
// (kv head = h / (H / Hkv)), so K and V are never repeated in memory.
//
// What bounds it on the H100: the bytes of the live K (pass 1) and K and V
// (pass 2) blocks, and at granularity 1 the CUDA-core work of y_low (hd
// dependent multiply, add and round steps per key). Unlike the mixed kernel
// at qlen 1, where three of four warps idle, every warp here works on keys.
// One thread block per (row, head) leaves the card under-filled at small
// batch; a split over keys (flash-decoding), TMA and tensor cores are for a
// later PR.
//
// Bit-exactness: y_low, round_to_mantissa and the selection rules are the
// shared helpers of lamp_device.cuh.

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
  const float* q;        // (R, H, hd): the (R, H, 1, hd) queries
  const float* k;        // (n_blocks, bs, Hkv, hd)
  const float* v;        // (n_blocks, bs, Hkv, hd)
  const int* bt;         // (R, n_max)
  const int* lengths;    // (R,) effective lengths: valid keys [0, L)
  const float* tau;      // (1,)
  float* smax;           // (R, H) pass-1 statistics
  float* mlow;
  float* llow;
  float* out;            // (R, H, hd)
  float* cnt;            // (R, H) selections per row and head
  int R, H, Hkv, hd, bs, n_max;
  int mu, gran, rule, lamp, n_ref, window;   // window <= 0: none
  float scale;
};

// Dynamic shared memory of one thread block, in floats: q, then CK keys
// (rows padded to hd + 1 against bank conflicts: lanes read different rows
// in the same column), then in pass 2 CK values (lanes read one row).
__host__ __device__ constexpr int smem_floats(int hd, bool stats) {
  return MAXD + CK * (hd + 1) + (stats ? 0 : CK * hd);
}

template <bool STATS>
__global__ void __launch_bounds__(NW * 32) paged_decode_kernel(Params p) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, r = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = p.hd, bs = p.bs, ks = hd + 1;
  float* sQ = smem;
  float* sK = smem + MAXD;
  float* sV = sK + CK * ks;

  const int L = p.lengths[r];
  const int kvh = h / (p.H / p.Hkv);
  const size_t row = (size_t)r * p.H + h;
  const int hi_key = min(L - 1, p.n_max * bs - 1);
  int lo_blk = 0;
  if (p.window > 0) lo_blk = min(max(L - p.window, 0) / bs, max(hi_key, 0) / bs);
  const int lo_key = lo_blk * bs;

  for (int d = threadIdx.x; d < hd; d += blockDim.x)
    sQ[d] = __fmul_rn(p.q[row * hd + d], p.scale);

  const bool lamp = p.lamp != 0;
  const bool selecting = lamp && p.rule != RULE_NONE;
  const bool cast_only = p.mu >= 23 || p.gran == 0 || p.gran >= hd;
  const float tau = selecting ? *p.tau : 0.f;
  const float log_tau = logf(tau);
  float sx = 0.f, mx = 0.f, lx = 0.f;            // pass-1 statistics (pass 2)
  if (!STATS && selecting) {
    sx = p.smax[row];
    mx = p.mlow[row];
    lx = p.llow[row];
  }

  // this warp's state. STATS: m, l, smax. Else: m, l, count, acc
  float st_m = NEG, st_l = 0.f, st_x = STATS ? NEG : 0.f;
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  const int vec = hd / 4;
  for (int kc = lo_key; kc <= hi_key; kc += CK) {
    __syncthreads();   // sQ written / previous chunk consumed
    for (int i = threadIdx.x; i < CK * vec; i += blockDim.x) {
      const int key = i / vec, d = (i % vec) * 4;
      const int pos = kc + key;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (pos <= hi_key) {
        const int blk = p.bt[(size_t)r * p.n_max + pos / bs];
        const size_t base = (((size_t)blk * bs + pos % bs) * p.Hkv + kvh) * hd + d;
        kk = *reinterpret_cast<const float4*>(p.k + base);
        if (!STATS) vv = *reinterpret_cast<const float4*>(p.v + base);
      }
      float* kr = sK + key * ks + d;
      kr[0] = kk.x; kr[1] = kk.y; kr[2] = kk.z; kr[3] = kk.w;
      if (!STATS) *reinterpret_cast<float4*>(sV + key * hd + d) = vv;
    }
    __syncthreads();
    const int kw = kc + warp * 32;                  // this warp's first key
    if (kw > hi_key) continue;                      // warp-uniform
    const int kj = kw + lane;
    bool ok = kj <= hi_key;
    if (p.window > 0) ok = ok && kj > L - 1 - p.window;
    const float* kv = sK + (warp * 32 + lane) * ks;

    float exact = 0.f, y;
    bool have_exact = false;
    if (!lamp) {
      y = dot_exact(sQ, kv, hd);
    } else if (cast_only) {
      exact = dot_exact(sQ, kv, hd);
      have_exact = true;
      y = round_to_mantissa(exact, p.mu);
    } else {
      y = dot_low_chunked(sQ, kv, hd, p.mu, p.gran);
    }

    if (STATS) {
      const float s = ok ? __fadd_rn(y, logf(fabsf(y))) : NEG;
      st_x = fmaxf(st_x, warp_max(s));
      const float m_new = fmaxf(st_m, warp_max(ok ? y : NEG));
      const float pr = ok ? expf(y - m_new) : 0.f;
      st_l = st_l * expf(st_m - m_new) + warp_sum(pr);
      st_m = m_new;
      continue;
    }

    if (selecting) {
      const bool sel = lamp_selects(p.rule, y, ok, sx, mx, lx, tau, log_tau, L, p.n_ref);
      st_x += (float)__popc(__ballot_sync(FULL, sel));
      if (sel) y = have_exact ? exact : dot_exact(sQ, kv, hd);
    }

    y = ok ? y : NEG;
    const float m_new = fmaxf(st_m, warp_max(y));
    const float pr = ok ? expf(y - m_new) : 0.f;
    const float corr = expf(st_m - m_new);
    st_l = st_l * corr + warp_sum(pr);
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= corr;
    const float* vw = sV + warp * 32 * hd;
    for (int key = 0; key < 32; ++key) {
      const float pj = __shfl_sync(FULL, pr, key);
      if (pj == 0.f) continue;                      // masked key: never read its V
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) acc[j] = fmaf(pj, vw[key * hd + d], acc[j]);
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
  float* sA = sX + NW;                              // (NW, hd)
  if (lane == 0) {
    sM[warp] = st_m;
    sL[warp] = st_l;
    sX[warp] = st_x;
  }
  if (!STATS) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) sA[warp * hd + d] = acc[j];
    }
  }
  __syncthreads();
  float m = NEG;
  for (int w = 0; w < NW; ++w) m = fmaxf(m, sM[w]);
  float l = 0.f;
  for (int w = 0; w < NW; ++w) l += sL[w] * expf(sM[w] - m);
  if (STATS) {
    if (threadIdx.x == 0) {
      float x = NEG;
      for (int w = 0; w < NW; ++w) x = fmaxf(x, sX[w]);
      p.smax[row] = x;
      p.mlow[row] = m;
      p.llow[row] = l;
    }
    return;
  }
  const float inv_l = fmaxf(l, TINY);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int w = 0; w < NW; ++w) a += sA[w * hd + d] * expf(sM[w] - m);
    p.out[row * hd + d] = a / inv_l;
  }
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int w = 0; w < NW; ++w) c += sX[w];
    p.cnt[row] = c;
  }
}

// Above 48 KB a block's dynamic shared memory must be opted into. Done
// once per instantiation (again only for a larger size than granted), so a
// launch adds no driver call.
template <bool STATS>
cudaError_t opt_in_smem(size_t bytes) {
  static size_t granted = 48 * 1024;
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

}  // namespace

extern "C" {

// pass 1 = look-ahead statistics, pass 2 = select, recompute and attend.
// Returns the CUDA error of the launch (0 = cudaSuccess).
int lamp_paged_decode_attention(const void* q, const void* k, const void* v,
                                const void* bt, const void* lengths, const void* tau,
                                void* smax, void* mlow, void* llow, void* out, void* cnt,
                                int R, int H, int Hkv, int hd, int bs, int n_max,
                                int mu, int gran, int rule, int lamp, int n_ref,
                                int window, float scale, int pass, void* stream) {
  Params p;
  p.q = (const float*)q; p.k = (const float*)k; p.v = (const float*)v;
  p.bt = (const int*)bt; p.lengths = (const int*)lengths; p.tau = (const float*)tau;
  p.smax = (float*)smax; p.mlow = (float*)mlow; p.llow = (float*)llow;
  p.out = (float*)out; p.cnt = (float*)cnt;
  p.R = R; p.H = H; p.Hkv = Hkv; p.hd = hd; p.bs = bs; p.n_max = n_max;
  p.mu = mu; p.gran = gran; p.rule = rule; p.lamp = lamp; p.n_ref = n_ref;
  p.window = window; p.scale = scale;
  if (hd > MAXD || hd % 4 != 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (R <= 0) return 0;
  const dim3 grid(H, R), block(NW * 32);
  cudaStream_t s = (cudaStream_t)stream;
  const bool stats = pass == 1;
  const size_t bytes = sizeof(float) * smem_floats(hd, stats);
  const cudaError_t err = stats ? opt_in_smem<true>(bytes) : opt_in_smem<false>(bytes);
  if (err != cudaSuccess) return (int)err;
  if (stats) {
    paged_decode_kernel<true><<<grid, block, bytes, s>>>(p);
  } else {
    paged_decode_kernel<false><<<grid, block, bytes, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
