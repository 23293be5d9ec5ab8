// One-pass relaxed-LAMP flash attention, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lamp_attention.py::
// lamp_flash_attention (Pallas body _kernel), the paper's Sec 4.4 rule: for
// each query row, the keys are walked in k-blocks of block_k; the PS(mu)
// logits y_low (q . k summed in chunks of k_subtile lanes, each chunk from a
// zero partial, k ascending; the running sum rounded to PS(mu) after each
// chunk, not at mu >= 23) of k-block ik are selected against the RUNNING
// row max of s = y + log|y| over k-blocks 0..ik, the current block
// included: select when s > log(max(tau, 1e-30)) + smax. Selected logits
// are replaced by the FP32 product, which is the same chunk partials summed
// unrounded (y_exact: "both values fall out of the same MXU pass", as in the
// Pallas kernel). Online softmax and P.V give the output. Causal or not;
// selections counted per query row in integers.
//
// What bounds it on the H100: operations. Bit-exact y_low is 2 D FP32
// operations per (query, key) pair on the CUDA cores (a multiply and an
// add, each rounded: no FMA), against q, K, V and out read or written once.
// At GPT-2 small prefill width (12 heads, T 1024, D 64, causal) that is 6.3 M
// pairs; the bound counts 4 D per pair (y_low, and P.V) at 67 TFLOP/s
// (kernels_micro): y_exact comes from the same chunk partials, one add a
// chunk, and costs no product of its own.
//
// Design. A thread block owns BQ = 32 query rows of one (b, h) and walks the
// keys up to its last live row in tiles of at most KT = 128 keys staged in
// shared memory; blocks are launched longest causal walk first.
//   * Register tiles for y_low: each of the 8 warps owns 8 rows x 64 keys,
//     each thread 4 rows x 4 keys (16 pairs, 16 independent chains). Per 4
//     lanes of D a thread loads 4 float4 of q (two addresses a warp: a
//     broadcast) and 4 float4 of K (rows of D + 4 floats: no bank conflict),
//     then does 64 multiplies and 64 adds: a shared load per 16 operations.
//   * y_exact from the same partials: at each chunk end acc = PS(mu)(acc +
//     part) and exact = exact + part. No second dot product, no divergence.
//   * s = y + logf|y| once per pair; the row max of s (and of the logits,
//     the softmax's reference m) by half-warp shuffles and one shared-memory
//     exchange between the two warps of a row. A tile holds whole k-blocks
//     (block_k <= 128) and walks them in order: with one k-block a tile,
//     the row max is the block max; with several, each row's block maxima
//     and running thresholds are taken from shared memory. A k-block longer
//     than 128 keys spans tiles and is walked twice: once for its row
//     maxima, once more, recomputing the same logits, to select and sum.
//   * K and V are each staged once per tile by cp.async, the next tile's K
//     and this tile's V in flight while this tile's y_low runs.
//   * P.V on the tensor cores, 3xTF32 mma.sync m16n8k8: p = expf(y - m) is
//     split into tf32 hi and lo once, as it is written to shared memory (in
//     the K tile's place); each warp owns 8 (or 16) output columns of all 32
//     rows, so each V value is read and split exactly once, by the one warp
//     that uses it. A single TF32 pass would miss rtol 2e-5 (its error is
//     2^-11 relative).
//   * NaN and Inf in V come out as in FP32 (split_keep: a non-finite value
//     keeps its bits in hi and drops from the cross products; a subnormal p
//     enters as FLT_MIN, so that p Inf stays Inf).
// 115,200 bytes of shared memory at D 64 and 128 registers a thread: two
// blocks (16 warps) an SM.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "lamp_device.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace lamp_dev;
using namespace tf32_mma;

constexpr int BQ = 32;             // query rows per thread block
constexpr int KT = 128;            // key slots per tile
constexpr int NTH = 256;           // threads per thread block: 8 warps
constexpr int MAXD = 128;          // largest head dim
constexpr int SP = KT + 4;         // P row stride: ldmatrix conflict-free
constexpr int SMEM_MAX = 232448;   // a block's dynamic shared memory on an H100

enum Mode {
  ONE_BLOCK = 0,    // a tile is one k-block (block_k in 65..128, or one block of S)
  SCAN = 1,         // a tile holds several k-blocks
  MULTI = 2,        // a k-block spans several tiles (block_k > 128)
};

struct Params {
  const float* q;        // (BH, T, D)
  const float* k;        // (BH, S, D)
  const float* v;        // (BH, S, D)
  float* out;            // (BH, T, D)
  int* cnt;              // (BH, T) selections per query row
  int T, S, D, mu, sub, causal, bk;
  float log_tau, scale;
  // layout (floats): strides and region offsets
  int SQ, SK, SV, Dp, stage, stages, off_v, off_x;
  int kt;                // keys per tile (ONE_BLOCK, SCAN): whole k-blocks
  int nbm;               // most k-blocks a tile holds (SCAN)
};

// Shared memory, in floats: the q tile (rows of D + 4; the 4 spare floats
// of a row take the row's cross-warp reductions), K stages (two where they
// fit: the next tile's K lands while this one's y_low runs; a stage takes
// P hi, P lo and corr once its K is consumed), the V tile, and the mode's
// extra region.
struct Layout {
  int mode, SQ, SK, SV, Dp, q, stage, v, x, kt, nbm, stages;
  Layout(int D, int bk) {
    SQ = D + 4;
    SK = D + 4;
    Dp = (D + 7) / 8 * 8;
    SV = Dp + ((8 - Dp % 32) + 32) % 32;            // SV = 8 mod 32: banks 8 t + g
    q = BQ * SQ;
    const int p_floats = 2 * BQ * SP + BQ;         // P hi, P lo, corr
    stage = KT * SK > p_floats ? KT * SK : p_floats;
    v = KT * SV;
    if (bk <= KT) {
      nbm = KT / bk;
      kt = nbm * bk;
      mode = nbm > 1 ? SCAN : ONE_BLOCK;
      x = mode == SCAN ? BQ * SP + BQ * (nbm + 1) : 0;
    } else {
      nbm = 1;
      kt = KT;
      mode = MULTI;
      x = 0;
    }
    stages = mode != MULTI && 4 * (q + 2 * stage + v + x) <= SMEM_MAX ? 2 : 1;
  }
  int floats() const { return q + stages * stage + v + x; }
};

// Stage rows [k0, k0 + n) of a (rows, D) matrix into rows of `stride` floats,
// `cols` floats each (zero past D); rows n..KT-1 zero-filled.
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* src,
                                           int k0, int n, int D, int cols) {
  const int cpr = cols / 4;
  for (int i = threadIdx.x; i < KT * cpr; i += NTH) {
    const int r = i / cpr, c = (i - r * cpr) * 4;
    const bool ok = r < n && c < D;
    cp_async16(dst + r * stride + c, ok ? src + (size_t)(k0 + r) * D + c : src, ok);
  }
}

// y_low and y_exact of the thread's 4 x 4 pairs: rows qr + i SQ, keys
// kr + 16 j SK. V4: k_subtile % 4 == 0, so a chunk is whole float4s.
template <bool V4>
__device__ __forceinline__ void tile_logits(const float* __restrict__ qr,
                                            const float* __restrict__ kr, const Params& p,
                                            float (&yl)[4][4], float (&ye)[4][4]) {
  const int D = p.D, SQ = p.SQ, SK = p.SK;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) yl[i][j] = ye[i][j] = 0.f;
  for (int s = 0; s < D; s += p.sub) {
    const int e = min(s + p.sub, D);
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
    if (V4) {
#pragma unroll 1
      for (int d = s; d < e; d += 4) {
        float4 a4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a4[i] = *reinterpret_cast<const float4*>(qr + i * SQ + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(kr + 16 * j * SK + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = part[i][j];
            x = __fadd_rn(x, __fmul_rn(a4[i].x, b.x));
            x = __fadd_rn(x, __fmul_rn(a4[i].y, b.y));
            x = __fadd_rn(x, __fmul_rn(a4[i].z, b.z));
            part[i][j] = __fadd_rn(x, __fmul_rn(a4[i].w, b.w));
          }
        }
      }
    } else {
      for (int d = s; d < e; ++d) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[i][j] = __fadd_rn(part[i][j], __fmul_rn(qr[i * SQ + d], kr[16 * j * SK + d]));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        yl[i][j] = round_to_mantissa(__fadd_rn(yl[i][j], part[i][j]), p.mu);
        ye[i][j] = __fadd_rn(ye[i][j], part[i][j]);
      }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// The thread's place: warp w owns rows 8 (w % 4) .. + 7 and key slots
// 64 (w / 4) .. + 63; lane = 16 rg + kc owns rows 8 (w % 4) + 4 rg + i and
// slots 64 (w / 4) + kc + 16 j (i, j < 4).
struct Place {
  int warp, lane, h, kc, rbase, cbase;
  __device__ Place() {
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    h = warp >> 2;
    kc = lane & 15;
    rbase = 8 * (warp & 3) + 4 * (lane >> 4);
    cbase = 64 * h + kc;
  }
};

// Pair (i, j) of the thread is live: its row is below T, its key among the
// tile's n, and (causal) not above the diagonal.
__device__ __forceinline__ bool pair_ok(const Params& p, const Place& at, int q0, int k0,
                                        int n, int i, int j) {
  const int row = q0 + at.rbase + i, c = at.cbase + 16 * j;
  return row < p.T && c < n && (!p.causal || k0 + c <= row);
}

// The tile's logits and scores: yl, ye and s = y_low + logf|y_low| of the
// thread's pairs, s = NEG where the pair is not live.
template <bool V4>
__device__ __forceinline__ void tile_scores(const Params& p, const Place& at,
                                            const float* sQ, const float* sK, int q0,
                                            int k0, int n, float (&yl)[4][4],
                                            float (&ye)[4][4], float (&sc)[4][4]) {
  tile_logits<V4>(sQ + at.rbase * p.SQ, sK + at.cbase * p.SK, p, yl, ye);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)   // -inf at y 0
      sc[i][j] = pair_ok(p, at, q0, k0, n, i, j)
                     ? __fadd_rn(yl[i][j], logf(fabsf(yl[i][j]))) : NEG;
}

// Fold the thread's live pairs into its rows' maxima: ms of s, my of both
// logits (the softmax's reference m need only bound the logits it exps).
__device__ __forceinline__ void fold_row_maxima(const Params& p, const Place& at, int q0,
                                                int k0, int n, const float (&yl)[4][4],
                                                const float (&ye)[4][4],
                                                const float (&sc)[4][4], float (&ms)[4],
                                                float (&my)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ms[i] = fmaxf(ms[i], sc[i][j]);
      if (pair_ok(p, at, q0, k0, n, i, j)) my[i] = fmaxf(my[i], fmaxf(yl[i][j], ye[i][j]));
    }
}

// A k-block's row maxima in: the running smax and its threshold, and the
// online softmax's new m with corr = exp(m_old - m).
__device__ __forceinline__ void update_rows(const Params& p, const float (&ms)[4],
                                            const float (&my)[4], float (&smax)[4],
                                            float (&thr)[4], float (&m)[4], float (&corr)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    smax[i] = fmaxf(smax[i], ms[i]);
    thr[i] = __fadd_rn(p.log_tau, smax[i]);
    const float mn = fmaxf(m[i], my[i]);
    corr[i] = expf(__fsub_rn(m[i], mn));
    m[i] = mn;
  }
}

// Row maxima of s and of the logits over a row's 128 slots: half-warp
// shuffles, then the two warps of a row through the 4 spare floats at the
// end of each q row (sQ[row][D..D+3]). Ends with __syncthreads().
__device__ __forceinline__ void row_max_exchange(const Params& p, const Place& at, float* sQ,
                                                 float (&ms)[4], float (&my)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ms[i] = half_warp_max(ms[i]);
    my[i] = half_warp_max(my[i]);
    if (at.kc == 0) {
      float* red = sQ + (at.rbase + i) * p.SQ + p.D;
      red[at.h] = ms[i];
      red[2 + at.h] = my[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* red = sQ + (at.rbase + i) * p.SQ + p.D;
    ms[i] = fmaxf(red[0], red[1]);
    my[i] = fmaxf(red[2], red[3]);
  }
}

// Selection, p = expf(y - m) and the row sums; p written split into tf32
// hi and lo to sP (hi rows, then lo rows, stride SP), corr to sCorr.
template <int MODE>
__device__ __forceinline__ void select_and_write_p(
    const Params& p, const Place& at, int q0, int k0, int n, const float (&yl)[4][4],
    const float (&ye)[4][4], const float (&sc)[4][4], const float (&thr)[4],
    const float* sThr, const float (&m)[4], const float (&corr)[4], float (&l)[4],
    int (&cnt)[4], float* sP, float* sCorr) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = at.rbase + i;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = at.cbase + 16 * j;
      const bool ok = pair_ok(p, at, q0, k0, n, i, j);
      float t = thr[i];
      if (MODE == SCAN) t = ok ? sThr[r * (p.nbm + 1) + c / p.bk] : 0.f;
      const bool sel = ok && sc[i][j] > t;
      cnt[i] += sel;
      const float y = sel ? ye[i][j] : yl[i][j];
      const float pv = ok ? expf(__fsub_rn(y, m[i])) : 0.f;
      ls = __fadd_rn(ls, pv);
      uint32_t hi, lo, hx;
      split_keep(pv, hi, lo, hx);
      if (pv < FLT_MIN && pv > 0.f) {   // a subnormal p: tf32 can make it 0,
        hi = __float_as_uint(FLT_MIN);   // and 0 Inf is NaN; FLT_MIN moves a
        lo = 0u;                         // finite p v by less than 2^-126 |v|
      }
      sP[r * SP + c] = __uint_as_float(hi);
      sP[(BQ + r) * SP + c] = __uint_as_float(lo);
    }
    l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), ls);
    if (at.h == 0 && at.kc == 0) sCorr[r] = corr[i];
  }
}

// out = out corr + P V over the tile's first n keys, for the NU n-tiles of
// 8 columns of warp w (NU w .. NU w + NU - 1) and all 32 rows: each V value
// is read and split by one warp. 3xTF32: the hi.hi product of every PV_FOLD
// k-steps is summed into a zeroed accumulator and then added into out with
// an IEEE add, lo.hi and hi.lo (2^-11 of it) into one accumulator over the
// tile. The tensor cores' accumulation rounds less exactly than FP32 adds,
// and its error grows with the MMAs summed into one accumulator.
constexpr int PV_FOLD = 1;   // k-steps of 8 keys between folds of hi.hi into out

template <int NU>
__device__ __forceinline__ void tile_pv(const Params& p, const Place& at, const float* sP,
                                       const float* sCorr, const float* sV, int n,
                                       float (&o)[2][NU][4]) {
  const int g = at.lane >> 2, t = at.lane & 3;
  const int nt0 = at.warp * NU, nu = min(NU, p.Dp / 8 - nt0);   // this warp's n-tiles
  float part[2][NU][4], fine[2][NU][4];   // hi.hi, and lo.hi + hi.lo
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float c = sCorr[mt * 16 + g + 8 * (r >> 1)];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        o[mt][u][r] = __fmul_rn(o[mt][u][r], c);
        part[mt][u][r] = fine[mt][u][r] = 0.f;
      }
    }
  const int nks = nu > 0 ? (n + 7) / 8 : 0;
  const float* ph = sP + ((at.lane & 7) + 8 * ((at.lane >> 3) & 1)) * SP + 4 * (at.lane >> 4);
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      ldmatrix_x4(ahi[mt], ph + mt * 16 * SP + ks * 8);
      ldmatrix_x4(alo[mt], ph + (BQ + mt * 16) * SP + ks * 8);
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      if (u >= nu) break;                          // uniform over the warp
      const float* vb = sV + (ks * 8 + t) * p.SV + (nt0 + u) * 8 + g;
      uint32_t bhi[2], blo[2], bhx[2];
      split_keep(vb[0], bhi[0], blo[0], bhx[0]);            // (k t, n g)
      split_keep(vb[4 * p.SV], bhi[1], blo[1], bhx[1]);     // (k t + 4, n g)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(fine[mt][u], alo[mt], bhx);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(fine[mt][u], ahi[mt], blo);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][u], ahi[mt], bhi);
    }
    if (ks % PV_FOLD == PV_FOLD - 1) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int u = 0; u < NU; ++u)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            o[mt][u][r] = __fadd_rn(o[mt][u][r], part[mt][u][r]);
            part[mt][u][r] = 0.f;
          }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        o[mt][u][r] = __fadd_rn(o[mt][u][r], __fadd_rn(part[mt][u][r], fine[mt][u][r]));
}

template <bool V4, int MODE, int NU>
__global__ void __launch_bounds__(NTH, 2) lamp_attention_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;
  float* sStage0 = smem + BQ * p.SQ;      // p.stages stages of p.stage floats
  float* sV = smem + p.off_v;
  float* sX = smem + p.off_x;
  const Place at;
  const int D = p.D, bh = blockIdx.x;
  const int nqt = (p.T + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - (int)blockIdx.y) * BQ;   // longest causal walks first
  const float* kb = p.k + (size_t)bh * p.S * D;
  const float* vb = p.v + (size_t)bh * p.S * D;

  const int vec = D / 4;
  for (int i = threadIdx.x; i < BQ * vec; i += NTH) {
    const int r = i / vec, c = (i - r * vec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.T) x = *reinterpret_cast<const float4*>(p.q + ((size_t)bh * p.T + q0 + r) * D + c);
    float* d = sQ + r * p.SQ + c;
    d[0] = __fmul_rn(x.x, p.scale);
    d[1] = __fmul_rn(x.y, p.scale);
    d[2] = __fmul_rn(x.z, p.scale);
    d[3] = __fmul_rn(x.w, p.scale);
  }
  // SCAN: s of the tile (BQ x SP), then per row nbm thresholds and smax
  float* sS = sX;
  float* sThr = sX + BQ * SP;
  if (MODE == SCAN && threadIdx.x < BQ) sThr[threadIdx.x * (p.nbm + 1) + p.nbm] = NEG;

  const int last_row = min(q0 + BQ, p.T) - 1;
  const int key_end = p.causal ? min(p.S, last_row + 1) : p.S;

  float m[4], l[4], smax[4], o[2][NU][4];
  int cnt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
    smax[i] = NEG;
    cnt[i] = 0;
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[mt][u][r] = 0.f;

  float yl[4][4], ye[4][4], sc[4][4], thr[4], corr[4];

  if (MODE != MULTI) {
    const int kt = p.kt, ntiles = (key_end + kt - 1) / kt;
    const bool two = p.stages == 2;
    if (two) stage_rows(sStage0, p.SK, kb, 0, min(kt, key_end), D, D);
    cp_async_commit();
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = t * kt, n = min(kt, key_end - k0);
      float* sK = sStage0 + (two ? (t & 1) * p.stage : 0);
      cp_async_wait<0>();
      __syncthreads();               // K(t) landed (two stages); the last P.V is done
      if (!two) stage_rows(sK, p.SK, kb, k0, n, D, D);
      cp_async_commit();
      stage_rows(sV, p.SV, vb, k0, n, D, p.Dp);
      cp_async_commit();
      if (two && t + 1 < ntiles)
        stage_rows(sStage0 + ((t + 1) & 1) * p.stage, p.SK, kb, k0 + kt,
                   min(kt, key_end - k0 - kt), D, D);
      cp_async_commit();
      if (!two) {
        cp_async_wait<2>();           // K(t) landed
        __syncthreads();
      }

      tile_scores<V4>(p, at, sQ, sK, q0, k0, n, yl, ye, sc);
      float ms[4] = {NEG, NEG, NEG, NEG}, my[4] = {NEG, NEG, NEG, NEG};
      fold_row_maxima(p, at, q0, k0, n, yl, ye, sc, ms, my);
      if (MODE == SCAN) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sS[(at.rbase + i) * SP + at.cbase + 16 * j] = sc[i][j];
      }
      row_max_exchange(p, at, sQ, ms, my);    // also: every warp is done with K(t)
      if (MODE == SCAN) {
        // one thread a row: the block maxima of the tile's k-blocks, in order
        if (threadIdx.x < BQ) {
          float* tr = sThr + threadIdx.x * (p.nbm + 1);
          const float* sr = sS + threadIdx.x * SP;
          float run = tr[p.nbm];
          for (int b = 0, c = 0; c < n; ++b) {
            const int e = min(c + p.bk, n);
            float bm = NEG;
            for (; c < e; ++c) bm = fmaxf(bm, sr[c]);
            run = fmaxf(run, bm);
            tr[b] = __fadd_rn(p.log_tau, run);
          }
          tr[p.nbm] = run;
        }
        __syncthreads();
      }
      update_rows(p, ms, my, smax, thr, m, corr);
      select_and_write_p<MODE>(p, at, q0, k0, n, yl, ye, sc, thr, sThr, m, corr, l, cnt, sK,
                               sK + 2 * BQ * SP);
      cp_async_wait<1>();             // V(t) landed
      __syncthreads();
      tile_pv<NU>(p, at, sK, sK + 2 * BQ * SP, sV, n, o);
    }
  } else {
    // a k-block spans tiles: one walk over its tiles for the block's row
    // maxima, then a second that recomputes the same logits (bit for bit)
    // to select, exp and multiply by V. Nothing waits in shared memory, so
    // any block_k fits, at twice the y_low work.
    for (int kb0 = 0; kb0 < key_end; kb0 += p.bk) {
      const int nkb = min(p.bk, key_end - kb0), nti = (nkb + KT - 1) / KT;
      float ms[4] = {NEG, NEG, NEG, NEG}, my[4] = {NEG, NEG, NEG, NEG};
      for (int it = 0; it < nti; ++it) {
        const int k0 = kb0 + it * KT, n = min(KT, kb0 + nkb - k0);
        __syncthreads();             // every warp is done with the last K
        stage_rows(sStage0, p.SK, kb, k0, n, D, D);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        tile_scores<V4>(p, at, sQ, sStage0, q0, k0, n, yl, ye, sc);
        fold_row_maxima(p, at, q0, k0, n, yl, ye, sc, ms, my);
      }
      row_max_exchange(p, at, sQ, ms, my);
      update_rows(p, ms, my, smax, thr, m, corr);
      for (int it = 0; it < nti; ++it) {
        const int k0 = kb0 + it * KT, n = min(KT, kb0 + nkb - k0);
        __syncthreads();             // K, V and the P region are free
        stage_rows(sStage0, p.SK, kb, k0, n, D, D);
        cp_async_commit();
        stage_rows(sV, p.SV, vb, k0, n, D, p.Dp);
        cp_async_commit();
        cp_async_wait<1>();          // K landed
        __syncthreads();
        tile_scores<V4>(p, at, sQ, sStage0, q0, k0, n, yl, ye, sc);
        __syncthreads();             // every warp is done with K: P takes its place
        float c1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) c1[i] = it == 0 ? corr[i] : 1.f;
        select_and_write_p<MODE>(p, at, q0, k0, n, yl, ye, sc, thr, sThr, m, c1, l, cnt,
                                 sStage0, sStage0 + 2 * BQ * SP);
        cp_async_wait<0>();          // V landed
        __syncthreads();
        tile_pv<NU>(p, at, sStage0, sStage0 + 2 * BQ * SP, sV, n, o);
      }
    }
  }

  // each row's l and count: half-warp sums, then the row's two warps
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int s = 8; s > 0; s >>= 1) {
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(FULL, l[i], s));
      cnt[i] += __shfl_xor_sync(FULL, cnt[i], s);
    }
  }
  __syncthreads();
  if (at.kc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* red = sQ + (at.rbase + i) * p.SQ + D;
      red[at.h] = l[i];
      red[2 + at.h] = __int_as_float(cnt[i]);
    }
  }
  __syncthreads();
  const int g = at.lane >> 2, t = at.lane & 3;
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int col = (at.warp * NU + u) * 8 + 2 * t;
    if (col >= D) break;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = mt * 16 + g + 8 * hr;
        if (q0 + r >= p.T) continue;
        const float* red = sQ + r * p.SQ + D;
        const float den = fmaxf(__fadd_rn(red[0], red[1]), 1e-30f);
        float2 w = make_float2(o[mt][u][2 * hr] / den, o[mt][u][2 * hr + 1] / den);
        *reinterpret_cast<float2*>(p.out + ((size_t)bh * p.T + q0 + r) * D + col) = w;
      }
  }
  if (threadIdx.x < BQ && q0 + (int)threadIdx.x < p.T) {
    const float* red = sQ + threadIdx.x * p.SQ + D;
    p.cnt[(size_t)bh * p.T + q0 + threadIdx.x] = __float_as_int(red[2]) + __float_as_int(red[3]);
  }
}

template <bool V4, int MODE, int NU>
cudaError_t launch(const Params& p, int BH, size_t bytes, cudaStream_t stream) {
  static size_t granted = 0;   // dynamic shared memory opted in for this instance
  if (bytes > granted) {
    cudaError_t err = cudaFuncSetAttribute(lamp_attention_kernel<V4, MODE, NU>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(lamp_attention_kernel<V4, MODE, NU>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    granted = bytes;
  }
  const dim3 grid(BH, (p.T + BQ - 1) / BQ), block(NTH);
  lamp_attention_kernel<V4, MODE, NU><<<grid, block, bytes, stream>>>(p);
  return cudaGetLastError();
}

// P.V: each warp owns 2 n-tiles of 8 columns at D > 64, else 1
template <bool V4, int MODE>
cudaError_t launch_nu(const Params& p, int BH, size_t bytes, cudaStream_t stream) {
  return p.Dp > 64 ? launch<V4, MODE, 2>(p, BH, bytes, stream)
                   : launch<V4, MODE, 1>(p, BH, bytes, stream);
}

template <int MODE>
cudaError_t launch_v4(const Params& p, int BH, size_t bytes, cudaStream_t stream) {
  return p.sub % 4 == 0 ? launch_nu<true, MODE>(p, BH, bytes, stream)
                        : launch_nu<false, MODE>(p, BH, bytes, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs, in bytes (the wrapper checks it
// against the card's limit before launching). At D 64: 115,200 with
// block_k 65..128, 132,480 with block_k 64 (two k-blocks a tile), 80,384
// with any block_k above 128 (one K stage); at most 154,112 at D 128.
long long lamp_flash_attention_smem(int D, int block_k) {
  return (long long)sizeof(float) * Layout(D, block_k).floats();
}

// q (BH, T, D), k and v (BH, S, D), out (BH, T, D) float32, each 16-byte
// aligned; cnt (BH, T) int32; block_k divides S. Returns the CUDA error of
// the launch (0 = cudaSuccess).
int lamp_flash_attention(const void* q, const void* k, const void* v, void* out,
                         void* cnt, int BH, int T, int S, int D, int mu,
                         int k_subtile, int causal, int block_k, float log_tau,
                         float scale, void* stream) {
  if (D > MAXD || D % 4 != 0 || D <= 0 || k_subtile <= 0 || block_k <= 0 || S % block_k != 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (BH <= 0 || T <= 0) return 0;
  const Layout L(D, block_k);
  Params p;
  p.q = (const float*)q; p.k = (const float*)k; p.v = (const float*)v;
  p.out = (float*)out; p.cnt = (int*)cnt;
  p.T = T; p.S = S; p.D = D; p.mu = mu; p.sub = k_subtile; p.causal = causal;
  p.bk = block_k; p.log_tau = log_tau; p.scale = scale;
  p.SQ = L.SQ; p.SK = L.SK; p.SV = L.SV; p.Dp = L.Dp; p.stage = L.stage;
  p.stages = L.stages; p.off_v = L.q + L.stages * L.stage; p.off_x = p.off_v + L.v;
  p.kt = L.kt; p.nbm = L.nbm;
  const size_t bytes = sizeof(float) * L.floats();
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = L.mode == ONE_BLOCK ? launch_v4<ONE_BLOCK>(p, BH, bytes, st)
                          : L.mode == SCAN    ? launch_v4<SCAN>(p, BH, bytes, st)
                                              : launch_v4<MULTI>(p, BH, bytes, st);
  return (int)err;
}

}  // extern "C"
