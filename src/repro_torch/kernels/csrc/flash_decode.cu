// LAMP decode attention over a dense KV cache (exact two-pass relaxed
// rule), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::flash_decode
// (Pallas bodies _smax_kernel and _decode_kernel). One query per (batch b,
// head h) attends to the valid keys [0, length[b]) of a (B, H, S, D) cache
// of float32 or bfloat16 (widened to FP32 as it is read, as the Pallas
// bodies do):
//
//   pass 1 (stats): y_low = q . k summed in chunks of k_subtile lanes, the
//       running sum rounded to PS(mu) after each chunk (unrounded at
//       mu >= 23); smax = max(y + log|y|) over the valid keys.
//   pass 2 (attend): select the keys with y + log|y| > log(max(tau,
//       1e-30)) + smax, replace their logits by the FP32 product, softmax
//       and P.V; count selections per (b, h) in integers. A row of length
//       0 gives 0, as in JAX.
//
// What bounds it on the H100: bytes. A valid key brings 8 D bytes of K and
// V (float32; half that in bfloat16) for about 4 D FP32 operations, far
// below the card's 20 operations a byte, so the valid K and V rows read
// once from HBM set the least time (25 MB, 7.5 us, at the micro-benchmark's
// full-width decode row). What the design does about it:
//   - Split over keys. The grid is (B*H, ceil(S / KS)) with KS = NW * 32
//     keys a thread block, one key a thread. A block whose keys all lie
//     past length[b] exits at once, so the live blocks follow the valid keys
//     and no single long row sets the time. Keys past the length are never
//     read.
//   - K crosses HBM once. Pass 1 writes each valid key's y_low (lamp_dev's
//     chunk order, bit for bit) to a float32 scratch of (B*H, S) values and
//     each split's max of s = y + log|y|. Pass 2 reads y_low back, takes
//     smax as the max of its row's split maxima (a max is exact in any
//     order, so it selects what one walk over the row would) and reads a K
//     row only for a selected key, to take its FP32 logit (fmaf in d order,
//     as lamp_dev::dot_exact).
//   - Loads overlap work. Tiles of K (pass 1) and V (pass 2) come into
//     shared memory by cp.async in the cache's own dtype, 4 elements a copy;
//     pass 2 selects and recomputes while its V tile is in flight. A staged
//     row is padded to an odd number of 4-element groups, so one-row-a-
//     thread reads hit distinct banks. Pass 2 is launched as a programmatic
//     dependent launch: its blocks start staging V while pass 1 still runs,
//     and wait (griddepcontrol.wait) only before they read what pass 1
//     wrote. Several blocks share an SM, so one block's loads overlap
//     another's y_low. (A K tile issued in two column halves, y_low begun on
//     the first, ran 2-6% slower on the card: launch/flash_decode_variants.)
//   - Each split writes its softmax partial (m, l, acc[D], count). The last
//     block of a row to arrive (an arrival counter that pass 1 zeroes)
//     merges the row's partials in split order, so every call gives the
//     same bits; a row of one split writes its output directly.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "lamp_device.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace lamp_dev;
using tf32_mma::cp_async_commit;
using tf32_mma::cp_async_wait;

constexpr int NW = 4;              // warps per thread block
constexpr int KS = NW * 32;        // keys a split: one per thread
constexpr int MAXD = 128;          // largest head dim
constexpr int DPL = MAXD / 32;     // accumulator slots per lane

// Row stride of a staged tile in elements: D rounded up to an odd number of
// 4-element groups.
__host__ __device__ constexpr int tile_stride(int D) { return ((D / 4) | 1) * 4; }

// The scratch a call needs, in bytes from its start, each part 16-aligned.
struct Workspace {
  size_t ylow, smax, m, l, acc, cnt, arrive, bytes;
};

inline size_t up16(long long n) { return (size_t)((n + 15) & ~15LL); }

inline Workspace workspace(long long BH, int S, int D) {
  const long long NS = (S + KS - 1) / KS;
  Workspace w;
  w.ylow = 0;
  w.smax = w.ylow + up16(4 * BH * S);
  w.m = w.smax + up16(4 * BH * NS);
  w.l = w.m + up16(4 * BH * NS);
  w.acc = w.l + up16(4 * BH * NS);
  w.cnt = w.acc + up16(4 * BH * NS * D);
  w.arrive = w.cnt + up16(4 * BH * NS);
  w.bytes = w.arrive + up16(4 * BH);
  return w;
}

struct Params {
  const float* q;       // (BH, D) float32
  const void* k;        // (BH, S, D) float32 or bfloat16
  const void* v;        // (BH, S, D) float32 or bfloat16
  const int* length;    // (B,)
  float* ylow;          // (BH, S): y_low of the valid keys
  float* smax_part;     // (BH, NS): each split's max of s
  float* m_part;        // (BH, NS): each split's logit max
  float* l_part;        // (BH, NS): each split's sum of exp
  float* acc_part;      // (BH, NS, D): each split's P.V
  int* cnt_part;        // (BH, NS): each split's selections
  int* arrive;          // (BH,): splits of the row done with pass 2
  float* out;           // (BH, D)
  int* cnt;             // (BH,)
  int H, S, D, NS, mu, sub;
  float log_tau, scale;
};

// Four consecutive elements of a row as floats (bfloat16 widened exactly).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  tf32_mma::cp_async16(dst, src, ok);
}

__device__ __forceinline__ void copy4(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                      bool ok) {
  tf32_mma::cp_async8(dst, src, ok);
}

// Stage the split's KS keys from `rows` (the (S, D) cache of one (b, h));
// keys at or past L are zero-filled, never read.
template <typename T>
__device__ __forceinline__ void stage(T* tile, const T* rows, int k0, int L, int D) {
  const int ld = tile_stride(D), groups = D / 4;
  for (int i = threadIdx.x; i < KS * groups; i += KS) {
    const int key = i / groups, c = (i % groups) * 4;
    const bool ok = k0 + key < L;
    copy4(tile + key * ld + c, rows + (size_t)(ok ? k0 + key : 0) * D + c, ok);
  }
}

// lamp_dev::dot_low_chunked on a staged row, 4 elements a read.
template <typename T>
__device__ __forceinline__ float dot_low_row(const float* q, const T* k, int D, int mu,
                                             int g) {
  float acc = 0.f, part = 0.f;
  int n = 0;                        // lanes summed into part, the open chunk
  for (int c = 0; c < D; c += 4) {
    const float4 k4 = load4(k + c);
    const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float prod = __fmul_rn(q[c + j], kk[j]);
      part = n == 0 ? prod : __fadd_rn(part, prod);
      if (++n == g || c + j == D - 1) {
        acc = round_to_mantissa(__fadd_rn(acc, part), mu);
        n = 0;
      }
    }
  }
  return acc;
}

// lamp_dev::dot_exact on a cache row in device memory.
template <typename T>
__device__ __forceinline__ float dot_exact_row(const float* q, const T* k, int D) {
  float acc = 0.f;
  for (int c = 0; c < D; c += 4) {
    const float4 k4 = ldg4(k + c);
    acc = fmaf(q[c], k4.x, acc);
    acc = fmaf(q[c + 1], k4.y, acc);
    acc = fmaf(q[c + 2], k4.z, acc);
    acc = fmaf(q[c + 3], k4.w, acc);
  }
  return acc;
}

__host__ __device__ constexpr size_t stats_smem(int D, size_t elem) {
  return sizeof(float) * MAXD + elem * KS * tile_stride(D);
}

__host__ __device__ constexpr size_t attend_smem(int D, size_t elem) {
  return sizeof(float) * (MAXD + NW * MAXD) + elem * KS * tile_stride(D);
}

__device__ __forceinline__ void load_q(float* sQ, const Params& p, int bh) {
  for (int d = threadIdx.x; d < p.D; d += KS)
    sQ[d] = __fmul_rn(p.q[(size_t)bh * p.D + d], p.scale);
}

// Pass 1: y_low of the split's keys into the scratch, the split's max of s.
template <typename TK>
__global__ void __launch_bounds__(KS) stats_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sX[NW];
  const int bh = blockIdx.x, split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, D = p.D;
  const int L = min(max(p.length[bh / p.H], 0), p.S);
  const int k0 = split * KS;
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");   // pass 2 may start
  if (split == 0 && tid == 0) p.arrive[bh] = 0;
  if (k0 >= L) return;

  float* sQ = reinterpret_cast<float*>(smem);
  TK* sK = reinterpret_cast<TK*>(sQ + MAXD);
  const TK* kb = static_cast<const TK*>(p.k) + (size_t)bh * p.S * D;
  stage(sK, kb, k0, L, D);
  cp_async_commit();
  load_q(sQ, p, bh);
  cp_async_wait<0>();
  __syncthreads();

  const bool ok = k0 + tid < L;
  const float y = dot_low_row(sQ, sK + tid * tile_stride(D), D, p.mu, p.sub);
  if (ok) p.ylow[(size_t)bh * p.S + k0 + tid] = y;
  const float s = warp_max(ok ? __fadd_rn(y, logf(fabsf(y))) : NEG);   // -inf at y == 0
  if (lane == 0) sX[warp] = s;
  __syncthreads();
  if (tid == 0) {
    float x = NEG;
    for (int w = 0; w < NW; ++w) x = fmaxf(x, sX[w]);
    p.smax_part[(size_t)bh * p.NS + split] = x;
  }
}

// Pass 2: select, recompute, the split's softmax partial; the row's last
// split to arrive merges.
template <typename TK, typename TV>
__global__ void __launch_bounds__(KS) attend_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sM[NW], sL[NW];
  __shared__ int sC[NW];
  __shared__ bool sLast;
  const int bh = blockIdx.x, split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, D = p.D;
  const int L = min(max(p.length[bh / p.H], 0), p.S);
  const int nlive = (L + KS - 1) / KS, k0 = split * KS;
  if (split >= nlive) {
    if (split == 0) {                         // length 0: out 0, nothing selected
      for (int d = tid; d < D; d += KS) p.out[(size_t)bh * D + d] = 0.f;
      if (tid == 0) p.cnt[bh] = 0;
    }
    return;
  }

  float* sQ = reinterpret_cast<float*>(smem);
  float* sA = sQ + MAXD;                      // (NW, D): the warps' P.V
  TV* sV = reinterpret_cast<TV*>(sA + NW * MAXD);
  const int ld = tile_stride(D);
  stage(sV, static_cast<const TV*>(p.v) + (size_t)bh * p.S * D, k0, L, D);
  cp_async_commit();
  load_q(sQ, p, bh);
  asm volatile("griddepcontrol.wait;" ::: "memory");   // pass 1 done, its writes seen

  const int pos = k0 + tid;
  const bool ok = pos < L;
  float y = ok ? p.ylow[(size_t)bh * p.S + pos] : 0.f;
  // smax: the max of the row's split maxima, each warp on its own
  float x = NEG;
  for (int i = lane; i < nlive; i += 32) x = fmaxf(x, p.smax_part[(size_t)bh * p.NS + i]);
  const float thr = __fadd_rn(p.log_tau, warp_max(x));
  const bool sel = ok && __fadd_rn(y, logf(fabsf(y))) > thr;
  const int c = __popc(__ballot_sync(FULL, sel));
  __syncthreads();                            // sQ written
  if (sel)
    y = dot_exact_row(sQ, static_cast<const TK*>(p.k) + ((size_t)bh * p.S + pos) * D, D);
  y = ok ? y : NEG;
  const float wm = warp_max(y);
  if (lane == 0) {
    sM[warp] = wm;
    sC[warp] = c;
  }
  __syncthreads();
  float m = sM[0];
  for (int w = 1; w < NW; ++w) m = fmaxf(m, sM[w]);
  const float pr = ok ? expf(y - m) : 0.f;
  const float wl = warp_sum(pr);
  if (lane == 0) sL[warp] = wl;
  cp_async_wait<0>();
  __syncthreads();                            // V staged

  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;
  if (k0 + warp * 32 < L) {                   // warp-uniform: a live key
    const TV* vw = sV + warp * 32 * ld;
    for (int key = 0; key < 32; ++key) {
      const float pj = __shfl_sync(FULL, pr, key);
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc[j] = fmaf(pj, to_f32(vw[key * ld + d]), acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    if (d < D) sA[warp * D + d] = acc[j];
  }
  __syncthreads();
  float l = sL[0];
  int cnt = sC[0];
  for (int w = 1; w < NW; ++w) {
    l += sL[w];
    cnt += sC[w];
  }
  const size_t row = (size_t)bh * p.NS;
  for (int d = tid; d < D; d += KS) {
    float a = sA[d];
    for (int w = 1; w < NW; ++w) a += sA[w * D + d];
    if (nlive == 1)
      p.out[(size_t)bh * D + d] = a / fmaxf(l, 1e-30f);
    else
      p.acc_part[(row + split) * D + d] = a;
  }
  if (nlive == 1) {
    if (tid == 0) p.cnt[bh] = cnt;
    return;
  }
  if (tid == 0) {
    p.m_part[row + split] = m;
    p.l_part[row + split] = l;
    p.cnt_part[row + split] = cnt;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sLast = atomicAdd(p.arrive + bh, 1) == nlive - 1;
  __syncthreads();
  if (!sLast) return;
  __threadfence();

  // the row's last split: merge the partials in split order
  float mx = __ldcg(p.m_part + row);
  for (int i = 1; i < nlive; ++i) mx = fmaxf(mx, __ldcg(p.m_part + row + i));
  float lsum = __ldcg(p.l_part + row) * expf(__ldcg(p.m_part + row) - mx);
  for (int i = 1; i < nlive; ++i)
    lsum += __ldcg(p.l_part + row + i) * expf(__ldcg(p.m_part + row + i) - mx);
  const float den = fmaxf(lsum, 1e-30f);
  for (int d = tid; d < D; d += KS) {
    float a = __ldcg(p.acc_part + row * D + d) * expf(__ldcg(p.m_part + row) - mx);
    for (int i = 1; i < nlive; ++i)
      a += __ldcg(p.acc_part + (row + i) * D + d) * expf(__ldcg(p.m_part + row + i) - mx);
    p.out[(size_t)bh * D + d] = a / den;
  }
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < nlive; ++i) n += __ldcg(p.cnt_part + row + i);
    p.cnt[bh] = n;
  }
}

// Above 48 KB a block's dynamic shared memory must be opted into; done once
// per kernel (again only for a larger size than granted).
// `early`: programmatic dependent launch, the kernel's blocks may start
// while the stream's previous kernel runs (they wait in griddepcontrol.wait).
template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t& granted, size_t bytes, dim3 grid,
                   cudaStream_t s, const Params& p, bool early) {
  if (bytes > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    granted = bytes;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(KS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = early ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TK>
cudaError_t launch_stats(dim3 grid, cudaStream_t s, const Params& p) {
  static size_t granted = 48 * 1024;
  return launch(stats_kernel<TK>, granted, stats_smem(p.D, sizeof(TK)), grid, s, p,
                false);
}

template <typename TK, typename TV>
cudaError_t launch_attend(dim3 grid, cudaStream_t s, const Params& p) {
  static size_t granted = 48 * 1024;
  return launch(attend_kernel<TK, TV>, granted, attend_smem(p.D, sizeof(TV)), grid, s,
                p, true);
}

}  // namespace

extern "C" {

// Bytes of the scratch `work` that lamp_flash_decode needs for BH rows of S
// keys of head dim D.
long long lamp_flash_decode_workspace(int BH, int S, int D) {
  return (long long)workspace(BH, S, D).bytes;
}

// pass 1 = y_low and the split maxima, pass 2 = select, recompute, attend and
// merge. q (BH, D) float32; k and v (BH, S, D), 16-byte aligned, of dtype
// k_dtype / v_dtype (0 float32, 1 bfloat16); length (B,) int32 with
// B = BH / H; work: lamp_flash_decode_workspace bytes, the same for both
// passes; out (BH, D) float32, cnt (BH,) int32. Returns the CUDA error of
// the launch (0 = cudaSuccess).
int lamp_flash_decode(const void* q, const void* k, const void* v, const void* length,
                      void* work, void* out, void* cnt, int BH, int H, int S, int D,
                      int mu, int k_subtile, float log_tau, float scale, int pass,
                      int k_dtype, int v_dtype, void* stream) {
  if (D > MAXD || D % 4 != 0 || D <= 0 || H <= 0 || k_subtile <= 0 || S <= 0 ||
      (S + KS - 1) / KS > 65535 || (unsigned)k_dtype > 1u || (unsigned)v_dtype > 1u)
    return (int)cudaErrorInvalidValue;
  if (BH <= 0) return 0;
  const Workspace ws = workspace(BH, S, D);
  unsigned char* w = static_cast<unsigned char*>(work);
  Params p;
  p.q = (const float*)q; p.k = k; p.v = v; p.length = (const int*)length;
  p.ylow = (float*)(w + ws.ylow); p.smax_part = (float*)(w + ws.smax);
  p.m_part = (float*)(w + ws.m); p.l_part = (float*)(w + ws.l);
  p.acc_part = (float*)(w + ws.acc); p.cnt_part = (int*)(w + ws.cnt);
  p.arrive = (int*)(w + ws.arrive);
  p.out = (float*)out; p.cnt = (int*)cnt;
  p.H = H; p.S = S; p.D = D; p.NS = (S + KS - 1) / KS; p.mu = mu; p.sub = k_subtile;
  p.log_tau = log_tau; p.scale = scale;
  const dim3 grid(BH, p.NS);
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (pass == 1)
    return (int)(k_dtype ? launch_stats<bf16>(grid, s, p) : launch_stats<float>(grid, s, p));
  if (k_dtype)
    return (int)(v_dtype ? launch_attend<bf16, bf16>(grid, s, p)
                         : launch_attend<bf16, float>(grid, s, p));
  return (int)(v_dtype ? launch_attend<float, bf16>(grid, s, p)
                       : launch_attend<float, float>(grid, s, p));
}

}  // extern "C"
