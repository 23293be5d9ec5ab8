// Paged LAMP attention over mixed rows and decode rows, for NVIDIA Hopper
// (sm_90a): one kernel design for both entry points.
//
// Replaces two TPU kernels of repro/kernels/paged_attention.py:
//   - paged_prefill_attention (alias paged_mixed_attention; Pallas bodies
//     _pre_stats_kernel and _pre_kernel): row b's queries sit at absolute
//     positions starts[b] .. starts[b] + qlens[b] - 1, each attends causally
//     (and within the sliding window) to row b's block table;
//   - paged_decode_attention (Pallas bodies _dec_stats_kernel and
//     _dec_kernel): one query per row at position lengths[r] - 1, keys
//     [max(L - window, 0), L); relaxed_ln's row length is L itself, not
//     capped by the window.
// Both compute the same two passes:
//   pass 1 (stats): the PS(mu) logits y_low of every live (query, key) pair
//       and, per query, smax = max(y + log|y|), m = max y, l = sum exp(y - m).
//       Launched only for a rule that selects.
//   pass 2 (attend): select with the rule (strict / relaxed / relaxed_ln)
//       against the pass-1 statistics and tau (read from device memory: the
//       engine's per-layer taus[l]), replace the selected logits by the FP32
//       product, softmax and P.V, and count selections per (row, head,
//       query). Queries past qlens[b] are padding: zero output, zero count.
//
// What bounds it on the H100. Bytes are few (5.6 MB at the engine's 8-row
// decode bucket: 1.7 us of HBM); the work is y_low at granularity 1: hd
// dependent multiply, add and round steps per pair, on the CUDA cores. So
// the time is the latency of the longest chain of dependent steps a unit
// walks, and the design cuts that chain:
//   - Split over keys. The unit of work is (row b, head h, a tile of TQ of
//     the row's queries, a split of KS keys). The grid is (splits, tiles,
//     B * H); a unit whose split lies outside the causal (and window) span of
//     its tile's live queries exits at once, and a key outside that span is
//     never read, so a dead block -- even one full of NaN -- cannot reach
//     the output (the JAX _pre_mask liveness rule). No row's length sets the
//     time any more: a unit walks at most KS keys.
//   - Independent chains. Each thread of a unit holds a QPT x KPT register
//     tile of (query, key) pairs, so its y_low chains run side by side
//     (TileOne: 64 keys on two rows of 64 threads for width-1 buckets;
//     TileWide: 8 queries x 64 keys on 128 threads for verify rows and
//     prefill windows). At granularity 1 a step of a chain
//     is a multiply, an add and a branch-free rounding (lamp_dev::round_ps).
//   - No repeated work. Pass 1 writes each live pair's y_low to a scratch
//     (the FP32 product itself where y_low is its rounding: granularity 0,
//     g >= hd, mu >= 23) and each split's (smax, m, l) per query. Pass 2
//     merges the splits' statistics (smax and m are maxima, exact in any
//     order; l is merged in split order, so every unit computes the same
//     bits), reads y_low back and re-reads a K row only for a selected pair.
//     Where the scratch of a bucket would pass YLOW_KEEP_MAX_BYTES (a wrapper
//     constant), pass 1 keeps nothing and pass 2 stages K and recomputes
//     y_low; one-pass calls (rule none, LAMP off) always compute in pass 2.
//   - Loads overlap work. K (pass 1; pass 2 when it recomputes) and V
//     (pass 2) are staged in shared memory by cp.async, V in flight while the
//     selection runs. Pass 2 of a two-pass call is a programmatic dependent
//     launch: its units stage q and V while pass 1 still runs and wait
//     (griddepcontrol.wait) only before they read what pass 1 wrote.
//   - Deterministic merge. Each split writes its softmax partial (m, l, acc,
//     count) per query; the last unit of a (row, head, tile) to arrive (an
//     arrival counter) merges the partials in split order, so calls give the
//     same bits, and resets the counter to 0 for the next call (a one-pass
//     call has no pass 1 to zero it). A tile with one split writes directly.
// GQA is resolved in the head index (kv head = h / (H / Hkv)): K and V are
// never repeated in memory. The arena is float32, bfloat16 or float16 (the
// engine's kv_dtype; both passes templated on its element type E): K and V
// are staged in E (cp.async of 4 elements, 16 or 8 bytes) and widened to
// FP32 as they are read from shared memory (or, in pass 2's recompute of a
// kept y_low, from device memory), as the Pallas bodies widen any arena
// dtype. Widening is exact, so q, the outputs, y_low and all arithmetic
// stay FP32 and a narrow arena gives the bits of its float32 widening. CUDA cores only: y_low must be bit-exact, and
// P.V's few products gain nothing from the tensor cores at these widths.
//
// Bit-exactness: y_low follows lamp_dev::dot_low_chunked (the chunk order of
// dot_ps), the FP32 product lamp_dev::dot_exact's order (d ascending, every
// product and sum rounded to FP32: no fmaf, so the plain version spells it
// as core.mixed_matmul.slab_sums(q, k, 23, hd)), and the selection rules
// lamp_dev::lamp_selects.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lamp_device.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace lamp_dev;
using tf32_mma::cp_async16;
using tf32_mma::cp_async_commit;
using tf32_mma::cp_async_wait;

constexpr int MAXD = 128;          // largest head dim
constexpr int DPL = MAXD / 32;     // P.V output columns a lane

// A unit's tile: NT threads in TR thread rows over the queries (a warp never
// spans two rows), each thread QPT queries x KPT keys. Thread (r, c) holds
// queries r QPT + i and keys c + TC j of the split.
template <int NT_, int TR_, int QPT_, int KPT_>
struct Tile {
  static constexpr int NT = NT_, TR = TR_, QPT = QPT_, KPT = KPT_;
  static constexpr int NWARP = NT / 32;
  static constexpr int TC = NT / TR;                    // threads along the keys
  static constexpr int TQ = TR * QPT;                   // queries a unit
  static constexpr int KS = TC * KPT;                   // keys a split
  static constexpr int RW = TC / 32;                    // warps a thread row
  static constexpr int NWQ = TQ < NWARP ? TQ : NWARP;   // P.V: warps along queries
  static constexpr int G = NWARP / NWQ;                 // P.V: key groups
  static constexpr int QPW = TQ / NWQ;                  // P.V: queries a warp
  static_assert(TC % 32 == 0 && NWARP % NWQ == 0 && TQ % NWQ == 0, "tile shape");
};
// Measured on the card (launch/paged_attention_variants.py): smaller units
// win while a row's keys fill the card; more pairs a thread lose.
using TileOne = Tile<128, 2, 1, 1>;    // width 1: 64 keys; the second row's
                                       // query slot stays empty, yet this ran
                                       // the draft's bucket 4% faster than 64
                                       // threads; 128 keys a split: as fast
                                       // there, 5% faster at 8 mixed rows
using TileWide = Tile<128, 4, 2, 2>;   // width 2 and up (verify rows, prefill
                                       // windows): 8 queries x 64 keys

// Row stride of a staged K or V tile in elements: hd rounded up to an odd
// number of 4-element groups, so one-row-a-lane reads of a group (16 bytes
// in float32, 8 in bfloat16 / float16) hit distinct banks.
__host__ __device__ constexpr int tile_stride(int hd) { return ((hd / 4) | 1) * 4; }

// Arena element types by the C entries' kv_dtype code.
enum KvDtype { KV_F32 = 0, KV_BF16 = 1, KV_F16 = 2 };

// Four consecutive arena elements as floats (bfloat16 and float16 widened
// exactly), from shared memory (load4) or device memory (ldg4).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 bf16x4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float f16_bits(unsigned h) {
  return __half2float(__ushort_as_half((unsigned short)h));
}

__device__ __forceinline__ float4 f16x4(uint2 u) {
  return make_float4(f16_bits(u.x & 0xffffu), f16_bits(u.x >> 16), f16_bits(u.y & 0xffffu),
                     f16_bits(u.y >> 16));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return bf16x4(*reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ float4 load4(const __half* p) {
  return f16x4(*reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  return bf16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}

__device__ __forceinline__ float4 ldg4(const __half* p) {
  return f16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// cp.async of four elements: 16 bytes of float32, 8 of a 16-bit type.
template <class E>
__device__ __forceinline__ void copy4(E* dst, const E* src, bool ok) {
  if constexpr (sizeof(E) == 4)
    cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src), ok);
  else
    tf32_mma::cp_async8(dst, src, ok);
}

struct Params {
  const float* q;        // (B, H, W, hd)
  const void* k;         // (n_blocks, bs, Hkv, hd) of kv_dtype
  const void* v;         // (n_blocks, bs, Hkv, hd) of kv_dtype
  const int* bt;         // (B, n_max)
  const int* starts;     // (B,) first query position; decode: lengths L
  const int* qlens;      // (B,) live queries; decode: unused
  const float* tau;      // (1,)
  float* ylow;           // (B H W, Tk) pass 1's logits, when kept
  float* sx;             // (B H W, NS) pass 1 per split: max of s
  float* sm;             //   max of y_low
  float* sl;             //   sum of exp(y_low - m)
  float* pm;             // (B H W, NS) pass 2 per split: logit max
  float* pl;             //   sum of p
  float* pc;             //   selections
  float* pa;             // (B H W, NS, hd) P.V
  int* arrive;           // (B H, ntile) units of a tile done with pass 2
  float* out;            // (B, H, W, hd)
  float* cnt;            // (B, H, W)
  int B, H, Hkv, W, hd, bs, n_max, Tk, NS, ntile;
  int bs_shift;          // log2(bs) for a power-of-two block size, else -1
  int mu, gran, rule, lamp, n_ref, window;   // window <= 0: none
  int kv_dtype;          // KvDtype
  bool keep, decode, pdl;
  float scale;
};

// What a unit sees of its row: its tile's live queries and their key span.
struct Geo {
  int b, h, kvh, w0, qe, q_first, lo_key, hi_key, nlive, L;
};

template <class T>
__device__ __forceinline__ Geo geometry(const Params& p, int t, int bh) {
  Geo g;
  g.b = bh / p.H;
  g.h = bh - g.b * p.H;
  g.kvh = g.h / (p.H / p.Hkv);
  int start, qlen;
  if (p.decode) {
    g.L = p.starts[g.b];
    start = g.L - 1;
    qlen = g.L > 0 ? 1 : 0;
  } else {
    g.L = 0;
    start = p.starts[g.b];
    qlen = p.qlens[g.b];
  }
  g.w0 = t * T::TQ;
  g.qe = min(min(max(qlen - g.w0, 0), T::TQ), p.W - g.w0);
  g.q_first = start + g.w0;
  g.hi_key = min(g.q_first + g.qe - 1, p.Tk - 1);
  int lo_blk = 0;
  if (p.window > 0)
    lo_blk = min(max(g.q_first - p.window + 1, 0) / p.bs, max(g.hi_key, 0) / p.bs);
  g.lo_key = lo_blk * p.bs;
  g.nlive = g.qe > 0 && g.hi_key >= g.lo_key ? (g.hi_key - g.lo_key + T::KS) / T::KS : 0;
  return g;
}

// Pair (query qq of the tile, key at position pos) is live: a live query,
// a key of the split, causal, inside the window.
__device__ __forceinline__ bool pair_ok(const Params& p, const Geo& g, int qq, int key,
                                        int n, int pos) {
  const int qi = g.q_first + qq;
  bool ok = qq < g.qe && key < n && pos <= qi;
  if (p.window > 0) ok = ok && pos > qi - p.window;
  return ok;
}

// Offset of the K / V row of position pos (a key of row g.b) in the arena.
__device__ __forceinline__ size_t kv_offset(const Params& p, const Geo& g, int pos) {
  const int i = p.bs_shift >= 0 ? pos >> p.bs_shift : pos / p.bs;
  const int o = p.bs_shift >= 0 ? pos & (p.bs - 1) : pos % p.bs;
  const int blk = p.bt[(size_t)g.b * p.n_max + i];
  return (((size_t)blk * p.bs + o) * p.Hkv + g.kvh) * p.hd;
}

// Stage the split's keys [k0, k0 + n) of K into sK and V into sV (either
// may be null); rows n..KS-1 zero-filled, never read from device memory.
// Each key's row is located once, all keys' block-table reads in flight
// together; then, where the 4-float groups of a row divide the threads, a
// thread keeps one column and walks the keys, else the (key, column) pairs
// are strided over the threads. All threads of the unit call it.
template <class T, class E>
__device__ __forceinline__ void stage(E* sK, E* sV, const Params& p, const Geo& g,
                                      int k0, int n) {
  __shared__ long long sOff[T::KS];
  for (int key = threadIdx.x; key < T::KS; key += T::NT)
    sOff[key] = key < n ? (long long)kv_offset(p, g, k0 + key) : -1;
  __syncthreads();
  const int groups = p.hd >> 2, ld = tile_stride(p.hd);
  const bool fixed = T::NT % groups == 0;
  const int step = fixed ? T::NT / groups : 1;
  const int first = fixed ? threadIdx.x / groups : 0;
  for (int key = first; key < T::KS; key += step) {
    const long long off = sOff[key];
    const bool ok = off >= 0;
    const size_t at = ok ? (size_t)off : 0;
    for (int c = fixed ? threadIdx.x % groups : threadIdx.x; c < groups;
         c += fixed ? groups : T::NT) {
      if (sK) copy4(sK + key * ld + 4 * c, static_cast<const E*>(p.k) + at + 4 * c, ok);
      if (sV) copy4(sV + key * ld + 4 * c, static_cast<const E*>(p.v) + at + 4 * c, ok);
    }
  }
}

// The tile's queries, scaled; dead query rows zero.
template <class T>
__device__ __forceinline__ void load_q(float* sQ, const Params& p, const Geo& g, int bh) {
  const size_t base = ((size_t)bh * p.W + g.w0) * p.hd;
  for (int i = threadIdx.x; i < T::TQ * p.hd; i += T::NT) {
    const int qq = i / p.hd, d = i - qq * p.hd;
    sQ[qq * MAXD + d] = qq < g.qe ? __fmul_rn(p.q[base + (size_t)qq * p.hd + d], p.scale)
                                  : 0.f;
  }
}

// The thread's logits from staged q and K: y_low (dot_low_chunked's chunk
// order) and, where y_low is the FP32 product rounded (or LAMP is off), the
// FP32 product ye itself (dot_exact's order) with y = its rounding. At
// granularity 1 each step is one multiply, one add and one rounding, with
// the rounding's constants hoisted: no branch in the loop.
template <class T, class E>
__device__ __forceinline__ void tile_logits(const Params& p, const float* sQ,
                                            const E* sK, int r, int c, bool exact,
                                            float (&y)[T::QPT][T::KPT],
                                            float (&ye)[T::QPT][T::KPT]) {
  const int hd = p.hd, ld = tile_stride(hd);
  const float* qr = sQ + r * T::QPT * MAXD;
  const E* kr = sK + c * ld;
  float part[T::QPT][T::KPT];
#pragma unroll
  for (int i = 0; i < T::QPT; ++i)
#pragma unroll
    for (int j = 0; j < T::KPT; ++j) y[i][j] = ye[i][j] = part[i][j] = 0.f;
  if (exact) {
#pragma unroll 1
    for (int d = 0; d < hd; d += 4) {
      float4 a[T::QPT], b[T::KPT];
#pragma unroll
      for (int i = 0; i < T::QPT; ++i) a[i] = *reinterpret_cast<const float4*>(qr + i * MAXD + d);
#pragma unroll
      for (int j = 0; j < T::KPT; ++j)
        b[j] = load4(kr + j * T::TC * ld + d);
#pragma unroll
      for (int i = 0; i < T::QPT; ++i)
#pragma unroll
        for (int j = 0; j < T::KPT; ++j) {
          float x = ye[i][j];
          x = __fadd_rn(x, __fmul_rn(a[i].x, b[j].x));
          x = __fadd_rn(x, __fmul_rn(a[i].y, b[j].y));
          x = __fadd_rn(x, __fmul_rn(a[i].z, b[j].z));
          ye[i][j] = __fadd_rn(x, __fmul_rn(a[i].w, b[j].w));
        }
    }
#pragma unroll
    for (int i = 0; i < T::QPT; ++i)
#pragma unroll
      for (int j = 0; j < T::KPT; ++j)
        y[i][j] = p.lamp ? round_to_mantissa(ye[i][j], p.mu) : ye[i][j];
    return;
  }
  const PsRound ps = ps_round(p.mu);
  if (p.gran == 1) {
#pragma unroll 1
    for (int d = 0; d < hd; d += 4) {
      float4 a[T::QPT], b[T::KPT];
#pragma unroll
      for (int i = 0; i < T::QPT; ++i) a[i] = *reinterpret_cast<const float4*>(qr + i * MAXD + d);
#pragma unroll
      for (int j = 0; j < T::KPT; ++j)
        b[j] = load4(kr + j * T::TC * ld + d);
#pragma unroll
      for (int i = 0; i < T::QPT; ++i)
#pragma unroll
        for (int j = 0; j < T::KPT; ++j) {
          float x = y[i][j];
          x = round_ps(__fadd_rn(x, __fmul_rn(a[i].x, b[j].x)), ps);
          x = round_ps(__fadd_rn(x, __fmul_rn(a[i].y, b[j].y)), ps);
          x = round_ps(__fadd_rn(x, __fmul_rn(a[i].z, b[j].z)), ps);
          y[i][j] = round_ps(__fadd_rn(x, __fmul_rn(a[i].w, b[j].w)), ps);
        }
    }
    return;
  }
  int n = 0;                         // lanes summed into part: the open chunk
#pragma unroll 1
  for (int d = 0; d < hd; d += 4) {
    float4 a[T::QPT], b[T::KPT];
#pragma unroll
    for (int i = 0; i < T::QPT; ++i) a[i] = *reinterpret_cast<const float4*>(qr + i * MAXD + d);
#pragma unroll
    for (int j = 0; j < T::KPT; ++j)
      b[j] = load4(kr + j * T::TC * ld + d);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int i = 0; i < T::QPT; ++i) {
        const float qa = e == 0 ? a[i].x : e == 1 ? a[i].y : e == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < T::KPT; ++j) {
          const float kb = e == 0 ? b[j].x : e == 1 ? b[j].y : e == 2 ? b[j].z : b[j].w;
          const float prod = __fmul_rn(qa, kb);
          part[i][j] = n == 0 ? prod : __fadd_rn(part[i][j], prod);
        }
      }
      if (++n == p.gran || d + e == hd - 1) {
#pragma unroll
        for (int i = 0; i < T::QPT; ++i)
#pragma unroll
          for (int j = 0; j < T::KPT; ++j) y[i][j] = round_ps(__fadd_rn(y[i][j], part[i][j]), ps);
        n = 0;
      }
    }
  }
}

// lamp_dev::dot_exact of a staged query and a K row in device memory.
template <class E>
__device__ __forceinline__ float dot_exact_row(const float* q, const E* k, int hd) {
  float acc = 0.f;
  for (int d = 0; d < hd; d += 4) {
    const float4 k4 = ldg4(k + d);
    acc = __fadd_rn(acc, __fmul_rn(q[d], k4.x));
    acc = __fadd_rn(acc, __fmul_rn(q[d + 1], k4.y));
    acc = __fadd_rn(acc, __fmul_rn(q[d + 2], k4.z));
    acc = __fadd_rn(acc, __fmul_rn(q[d + 3], k4.w));
  }
  return acc;
}

// Reduce x and z over a thread row's TC threads (max or sum); every thread
// of the row gets the results. Warps first (xor butterflies), then, for a
// row of several warps, the warps in order through `red` (2 NWARP floats).
// All threads call it.
template <class T, bool MAX>
__device__ __forceinline__ void row_reduce(float& x, float& z, float* red) {
  x = MAX ? warp_max(x) : warp_sum(x);
  z = MAX ? warp_max(z) : warp_sum(z);
  if (T::RW == 1) return;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = x;
    red[T::NWARP + warp] = z;
  }
  __syncthreads();
  const int w0 = (warp / T::RW) * T::RW;
  x = red[w0];
  z = red[T::NWARP + w0];
#pragma unroll
  for (int w = 1; w < T::RW; ++w) {
    x = MAX ? fmaxf(x, red[w0 + w]) : x + red[w0 + w];
    z = MAX ? fmaxf(z, red[T::NWARP + w0 + w]) : z + red[T::NWARP + w0 + w];
  }
  __syncthreads();
}

// Dynamic shared memory of a pass in bytes: q (floats), the staged K and V
// tiles (elements of esize bytes; each a multiple of 16 bytes), then pass
// 2's numerators and key groups' P.V (floats).
__host__ __device__ constexpr size_t stats_smem_bytes(int TQ, int KS, int hd, int esize) {
  return 4 * (size_t)TQ * MAXD + (size_t)esize * KS * tile_stride(hd);
}

__host__ __device__ constexpr size_t attend_smem_bytes(int TQ, int KS, int G, int hd,
                                                       bool keep, int esize) {
  return 4 * (size_t)TQ * MAXD + (size_t)esize * (keep ? 1 : 2) * KS * tile_stride(hd) +
         4 * ((size_t)TQ * KS + (G > 1 ? (size_t)G * TQ * MAXD : 0));
}

// Pass 1: y_low of the split's live pairs into the scratch (when kept), and
// the split's (smax, m, l) per live query.
template <class T, class E>
__global__ void __launch_bounds__(T::NT) stats_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2 * T::NWARP];
  const int s = blockIdx.x, t = blockIdx.y, bh = blockIdx.z;
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");   // pass 2 may start
  const Geo g = geometry<T>(p, t, bh);
  if (s >= g.nlive) return;
  const int k0 = g.lo_key + s * T::KS, n = min(T::KS, g.hi_key - k0 + 1);
  float* sQ = smem;
  E* sK = reinterpret_cast<E*>(sQ + T::TQ * MAXD);
  stage<T, E>(sK, nullptr, p, g, k0, n);
  cp_async_commit();
  load_q<T>(sQ, p, g, bh);
  cp_async_wait<0>();
  __syncthreads();

  const int r = threadIdx.x / T::TC, c = threadIdx.x % T::TC;
  const bool exact = p.mu >= 23 || p.gran <= 0 || p.gran >= p.hd;
  float y[T::QPT][T::KPT], ye[T::QPT][T::KPT];
  tile_logits<T, E>(p, sQ, sK, r, c, exact, y, ye);
#pragma unroll
  for (int i = 0; i < T::QPT; ++i) {
    const int qq = r * T::QPT + i;
    const size_t qrow = (size_t)bh * p.W + g.w0 + qq;
    float xs = NEG, xm = NEG;
    bool ok[T::KPT];
#pragma unroll
    for (int j = 0; j < T::KPT; ++j) {
      const int key = c + T::TC * j, pos = k0 + key;
      ok[j] = pair_ok(p, g, qq, key, n, pos);
      if (ok[j]) {
        if (p.keep) p.ylow[qrow * p.Tk + pos] = exact ? ye[i][j] : y[i][j];
        xs = fmaxf(xs, __fadd_rn(y[i][j], logf(fabsf(y[i][j]))));   // -inf at y 0
        xm = fmaxf(xm, y[i][j]);
      }
    }
    row_reduce<T, true>(xs, xm, red);
    float ls = 0.f, unused = 0.f;
#pragma unroll
    for (int j = 0; j < T::KPT; ++j) ls += ok[j] ? expf(y[i][j] - xm) : 0.f;
    row_reduce<T, false>(ls, unused, red);
    if (c == 0 && qq < g.qe) {
      const size_t at = qrow * p.NS + s;
      p.sx[at] = xs;
      p.sm[at] = xm;
      p.sl[at] = ls;
    }
  }
}

// Pass 2: select, recompute, the split's softmax partial; the tile's last
// unit to arrive merges the splits.
template <class T, bool KEEP, class E>
__global__ void __launch_bounds__(T::NT) attend_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2 * T::NWARP];
  __shared__ float sSx[T::TQ], sSm[T::TQ], sSl[T::TQ];   // merged pass-1 statistics
  __shared__ float sRm[T::TQ], sRl[T::TQ], sRc[T::TQ];   // this split's m, l, count
  __shared__ bool sLast;
  const int s = blockIdx.x, t = blockIdx.y, bh = blockIdx.z;
  const int tid = threadIdx.x, hd = p.hd, ld = tile_stride(hd);
  const Geo g = geometry<T>(p, t, bh);
  const size_t row0 = (size_t)bh * p.W + g.w0;    // the tile's first query row
  if (s == 0) {                // queries with no key: padding, or a dead tile
    const int first = g.nlive > 0 ? g.qe : 0;
    const int last = min(T::TQ, p.W - g.w0);
    for (int i = first * hd + tid; i < last * hd; i += T::NT) {
      p.out[row0 * hd + i] = 0.f;
      if (i % hd == 0) p.cnt[row0 + i / hd] = 0.f;
    }
  }
  if (s >= g.nlive) return;
  const int k0 = g.lo_key + s * T::KS, n = min(T::KS, g.hi_key - k0 + 1);

  float* sQ = smem;
  E* sK = reinterpret_cast<E*>(sQ + T::TQ * MAXD);   // staged only when recomputing
  E* sV = sK + (KEEP ? 0 : T::KS * ld);
  float* sP = reinterpret_cast<float*>(sV + T::KS * ld);   // (TQ, KS) numerators
  float* sA = sP + T::TQ * T::KS;                 // (G, TQ, MAXD) key groups' P.V
  stage<T, E>(KEEP ? nullptr : sK, sV, p, g, k0, n);
  cp_async_commit();
  load_q<T>(sQ, p, g, bh);
  if (p.pdl) asm volatile("griddepcontrol.wait;" ::: "memory");   // pass 1 done

  const bool lamp = p.lamp != 0;
  const bool selecting = lamp && p.rule != RULE_NONE;
  const bool exact = !lamp || p.mu >= 23 || p.gran <= 0 || p.gran >= hd;
  const float tau = selecting ? *p.tau : 0.f;
  const float log_tau = logf(tau);
  if (selecting && tid < g.qe && tid < T::TQ) {   // the splits' statistics, in order
    const float* sx = p.sx + (row0 + tid) * p.NS;
    const float* sm = p.sm + (row0 + tid) * p.NS;
    const float* sl = p.sl + (row0 + tid) * p.NS;
    float x = sx[0], m = sm[0];
    for (int i = 1; i < g.nlive; ++i) {
      x = fmaxf(x, sx[i]);
      m = fmaxf(m, sm[i]);
    }
    float l = 0.f;
    for (int i = 0; i < g.nlive; ++i) l += sl[i] * expf(sm[i] - m);
    sSx[tid] = x;
    sSm[tid] = m;
    sSl[tid] = l;
  }
  if (!KEEP) cp_async_wait<0>();                  // K staged (and V with it)
  __syncthreads();

  const int r = tid / T::TC, c = tid % T::TC;
  float y[T::QPT][T::KPT], ye[T::QPT][T::KPT];
  if (!KEEP) tile_logits<T, E>(p, sQ, sK, r, c, exact, y, ye);
  const int cap = p.window > 0 ? p.window : p.Tk;   // relaxed_ln row length cap
#pragma unroll
  for (int i = 0; i < T::QPT; ++i) {
    const int qq = r * T::QPT + i, qi = g.q_first + qq;
    const size_t qrow = row0 + qq;
    const int n_row = p.decode ? g.L : min(max(qi + 1, 0), cap);
    float pr[T::KPT];
    bool live[T::KPT];
    float xm = NEG, cnt = 0.f;
#pragma unroll
    for (int j = 0; j < T::KPT; ++j) {
      const int key = c + T::TC * j, pos = k0 + key;
      const bool ok = pair_ok(p, g, qq, key, n, pos);
      float yv = 0.f;
      if (KEEP) {
        if (ok) {
          yv = p.ylow[qrow * p.Tk + pos];
          ye[i][j] = yv;
          yv = exact ? round_to_mantissa(yv, p.mu) : yv;
        }
      } else {
        yv = y[i][j];
      }
      if (selecting) {
        const bool sel = lamp_selects(p.rule, yv, ok, sSx[qq], sSm[qq], sSl[qq], tau,
                                      log_tau, n_row, p.n_ref);
        if (sel) {
          cnt += 1.f;
          if (exact) yv = ye[i][j];
          else if (KEEP)
            yv = dot_exact_row(sQ + qq * MAXD,
                               static_cast<const E*>(p.k) + kv_offset(p, g, pos), hd);
          else yv = dot_exact(sQ + qq * MAXD, sK + key * ld, hd);
        }
      }
      live[j] = ok;
      pr[j] = ok ? yv : NEG;
      xm = fmaxf(xm, pr[j]);
    }
    float m = xm, unused = NEG;
    row_reduce<T, true>(m, unused, red);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < T::KPT; ++j) {
      const int key = c + T::TC * j;
      const float e = live[j] ? expf(pr[j] - m) : 0.f;
      ls += e;
      sP[qq * T::KS + key] = e;
    }
    row_reduce<T, false>(ls, cnt, red);
    if (c == 0) {
      sRm[qq] = m;
      sRl[qq] = ls;
      sRc[qq] = cnt;
    }
  }
  cp_async_wait<0>();                             // V staged (KEEP: in flight so far)
  __syncthreads();

  // P.V: warp w owns queries wq + NWQ a of key group wg, lane the columns
  // lane + 32 j; keys in order, skipping p == 0 (a masked key's V unread)
  const int warp = tid >> 5, lane = tid & 31;
  const int wq = warp % T::NWQ, wg = warp / T::NWQ;
  constexpr int KG = T::KS / T::G;
  float acc[T::QPW][DPL];
#pragma unroll
  for (int a = 0; a < T::QPW; ++a)
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[a][j] = 0.f;
  for (int kk = wg * KG; kk < min((wg + 1) * KG, n); ++kk) {
    const E* vr = sV + kk * ld;
    float vv[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) vv[j] = lane + 32 * j < hd ? to_f32(vr[lane + 32 * j]) : 0.f;
#pragma unroll
    for (int a = 0; a < T::QPW; ++a) {
      const float pj = sP[(wq + T::NWQ * a) * T::KS + kk];
      if (pj == 0.f) continue;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[a][j] = fmaf(pj, vv[j], acc[a][j]);
    }
  }
  if (T::G > 1) {              // the key groups' sums, in group order
#pragma unroll
    for (int a = 0; a < T::QPW; ++a)
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        sA[(wg * T::TQ + wq + T::NWQ * a) * MAXD + lane + 32 * j] = acc[a][j];
    __syncthreads();
  }

  // the split's P.V: written out (one split) or kept as its partial
  const size_t NS = p.NS;
  if (T::G == 1) {
    // each lane writes its own accumulators: query wq + NWQ a, column lane + 32 j
#pragma unroll
    for (int a = 0; a < T::QPW; ++a) {
      const int qq = wq + T::NWQ * a;
      if (qq >= g.qe) continue;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d >= hd) continue;
        if (g.nlive == 1)
          p.out[(row0 + qq) * hd + d] = acc[a][j] / fmaxf(sRl[qq], TINY);
        else
          p.pa[((row0 + qq) * NS + s) * hd + d] = acc[a][j];
      }
    }
  } else {
    for (int i = tid; i < g.qe * hd; i += T::NT) {
      const int qq = i / hd, d = i - qq * hd;
      float v = sA[qq * MAXD + d];
#pragma unroll
      for (int gg = 1; gg < T::G; ++gg) v += sA[(gg * T::TQ + qq) * MAXD + d];
      if (g.nlive == 1)
        p.out[(row0 + qq) * hd + d] = v / fmaxf(sRl[qq], TINY);
      else
        p.pa[((row0 + qq) * NS + s) * hd + d] = v;
    }
  }
  if (g.nlive == 1) {
    if (tid < g.qe) p.cnt[row0 + tid] = sRc[tid];
    return;
  }
  if (tid < g.qe) {
    const size_t at = (row0 + tid) * NS + s;
    p.pm[at] = sRm[tid];
    p.pl[at] = sRl[tid];
    p.pc[at] = sRc[tid];
  }
  __threadfence();
  __syncthreads();
  int* arrive = p.arrive + (size_t)bh * p.ntile + t;
  if (tid == 0) sLast = atomicAdd(arrive, 1) == g.nlive - 1;
  __syncthreads();
  if (!sLast) return;
  __threadfence();

  // the tile's last unit: merge the splits' partials in split order, each
  // query's max and normalizer first
  if (tid == 0) *arrive = 0;                      // ready for the next call
  if (tid < g.qe) {
    const size_t base = (row0 + tid) * NS;
    float mx = __ldcg(p.pm + base);
    for (int k = 1; k < g.nlive; ++k) mx = fmaxf(mx, __ldcg(p.pm + base + k));
    float l = 0.f, cs = 0.f;
    for (int k = 0; k < g.nlive; ++k) {
      l += __ldcg(p.pl + base + k) * expf(__ldcg(p.pm + base + k) - mx);
      cs += __ldcg(p.pc + base + k);
    }
    sRm[tid] = mx;
    sRl[tid] = fmaxf(l, TINY);
    p.cnt[row0 + tid] = cs;
  }
  __syncthreads();
  for (int i = tid; i < g.qe * hd; i += T::NT) {
    const int qq = i / hd, d = i - qq * hd;
    const size_t base = (row0 + qq) * NS;
    float a = 0.f;
    for (int k = 0; k < g.nlive; ++k)
      a += __ldcg(p.pa + (base + k) * hd + d) * expf(__ldcg(p.pm + base + k) - sRm[qq]);
    p.out[(row0 + qq) * hd + d] = a / sRl[qq];
  }
}

// The scratch a call needs, in bytes from its start, each part 16-aligned.
struct Workspace {
  size_t ylow, sx, sm, sl, pm, pl, pc, pa, bytes;
};

inline size_t up16(long long n) { return (size_t)((n + 15) & ~15LL); }

template <class T>
Workspace workspace(long long rows, int Tk, int hd, bool keep) {
  const long long NS = (Tk + T::KS - 1) / T::KS, part = 4 * rows * NS;
  Workspace w;
  w.ylow = 0;
  w.sx = keep ? up16(4 * rows * Tk) : 0;
  w.sm = w.sx + up16(part);
  w.sl = w.sm + up16(part);
  w.pm = w.sl + up16(part);
  w.pl = w.pm + up16(part);
  w.pc = w.pl + up16(part);
  w.pa = w.pc + up16(part);
  w.bytes = w.pa + up16(part * hd);
  return w;
}

// Above 48 KB a block's dynamic shared memory must be opted into; done once
// per kernel (again only for a larger size than granted).
// `early`: programmatic dependent launch, the kernel's units may start while
// the stream's previous kernel (pass 1) runs; they wait in griddepcontrol.wait.
template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t& granted, size_t bytes, dim3 grid,
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
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = early ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Bind the workspace and launch one pass with tile T on an arena of E.
template <class T, class E>
int run(Params p, void* work, int pass, cudaStream_t s) {
  const long long rows = (long long)p.B * p.H * p.W;
  const Workspace ws = workspace<T>(rows, p.Tk, p.hd, p.keep);
  unsigned char* w = static_cast<unsigned char*>(work);
  p.ylow = (float*)(w + ws.ylow);
  p.sx = (float*)(w + ws.sx); p.sm = (float*)(w + ws.sm); p.sl = (float*)(w + ws.sl);
  p.pm = (float*)(w + ws.pm); p.pl = (float*)(w + ws.pl); p.pc = (float*)(w + ws.pc);
  p.pa = (float*)(w + ws.pa);
  p.NS = (p.Tk + T::KS - 1) / T::KS;
  p.ntile = (p.W + T::TQ - 1) / T::TQ;
  if (p.ntile > 65535 || (long long)p.B * p.H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(p.NS, p.ntile, p.B * p.H);
  if (pass == 1) {
    static size_t granted = 48 * 1024;
    const size_t bytes = stats_smem_bytes(T::TQ, T::KS, p.hd, sizeof(E));
    return (int)launch(stats_kernel<T, E>, T::NT, granted, bytes, grid, s, p, false);
  }
  p.pdl = p.lamp && p.rule != RULE_NONE;          // a two-pass call: after pass 1
  const size_t bytes = attend_smem_bytes(T::TQ, T::KS, T::G, p.hd, p.keep, sizeof(E));
  if (p.keep) {
    static size_t granted = 48 * 1024;
    return (int)launch(attend_kernel<T, true, E>, T::NT, granted, bytes, grid, s, p, p.pdl);
  }
  static size_t granted = 48 * 1024;
  return (int)launch(attend_kernel<T, false, E>, T::NT, granted, bytes, grid, s, p, p.pdl);
}

template <class T>
int run_dtype(Params& p, void* work, int pass, cudaStream_t s) {
  if (p.kv_dtype == KV_BF16) return run<T, __nv_bfloat16>(p, work, pass, s);
  if (p.kv_dtype == KV_F16) return run<T, __half>(p, work, pass, s);
  return run<T, float>(p, work, pass, s);
}

// The tile a call of W queries a row uses.
inline int tile_of(int W) { return W == 1 ? 0 : 1; }

int dispatch(Params& p, void* work, int pass, cudaStream_t s) {
  if (p.hd > MAXD || p.hd % 4 != 0 || p.hd <= 0 || p.Hkv <= 0 || p.H % p.Hkv != 0 ||
      p.bs <= 0 || p.n_max <= 0 || p.W <= 0 || (pass != 1 && pass != 2) ||
      (unsigned)p.kv_dtype > (unsigned)KV_F16)
    return (int)cudaErrorInvalidValue;
  if (p.B <= 0) return 0;
  p.Tk = p.n_max * p.bs;
  p.bs_shift = (p.bs & (p.bs - 1)) == 0 ? __builtin_ctz((unsigned)p.bs) : -1;
  // one-pass calls have no pass 1 to keep y_low: pass 2 computes it
  p.keep = p.keep && p.lamp && p.rule != RULE_NONE;
  return tile_of(p.W) == 0 ? run_dtype<TileOne>(p, work, pass, s)
                           : run_dtype<TileWide>(p, work, pass, s);
}

long long workspace_bytes(int B, int H, int W, int hd, int bs, int n_max, int keep) {
  const long long rows = (long long)B * H * W;
  const int Tk = n_max * bs;
  return (long long)(tile_of(W) == 0 ? workspace<TileOne>(rows, Tk, hd, keep)
                                      : workspace<TileWide>(rows, Tk, hd, keep)).bytes;
}

__global__ void round_to_mantissa_kernel(const float* x, float* y, long long n, int mu) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = round_to_mantissa(x[i], mu);
}

}  // namespace

extern "C" {

// Bytes of the scratch `work` a call of (B, H, W, hd) queries against block
// tables of n_max blocks of bs keys needs; keep: pass 1 keeps y_low.
long long lamp_paged_attention_workspace(int B, int H, int W, int hd, int bs, int n_max,
                                         int keep) {
  return workspace_bytes(B, H, W, hd, bs, n_max, keep);
}

// Arrival counters a call needs: one per (row, head, query tile). They must
// be zero before the first call; each call leaves them zero.
long long lamp_paged_attention_arrivals(int B, int H, int W) {
  const int tq = tile_of(W) == 0 ? TileOne::TQ : TileWide::TQ;
  return (long long)B * H * ((W + tq - 1) / tq);
}

// Mixed rows. pass 1 = y_low and the split statistics (a selecting rule
// only), pass 2 = select, recompute, attend and merge. work:
// lamp_paged_attention_workspace bytes, the same for both passes; arrive:
// lamp_paged_attention_arrivals int32 counters, zero; q float32; k and v
// the arena of kv_dtype (0 float32, 1 bfloat16, 2 float16), 16-byte
// aligned; out (B, H, W, hd) and cnt (B, H, W) float32. Returns the CUDA
// error of the launch (0 = success).
int lamp_paged_mixed_attention(const void* q, const void* k, const void* v,
                               const void* bt, const void* starts, const void* qlens,
                               const void* tau, void* work, void* arrive, void* out,
                               void* cnt, int B, int H, int Hkv, int W, int hd, int bs,
                               int n_max, int mu, int gran, int rule, int lamp, int n_ref,
                               int window, int keep, int kv_dtype, float scale, int pass,
                               void* stream) {
  Params p = {};
  p.q = (const float*)q; p.k = k; p.v = v;
  p.bt = (const int*)bt; p.starts = (const int*)starts; p.qlens = (const int*)qlens;
  p.tau = (const float*)tau; p.arrive = (int*)arrive;
  p.out = (float*)out; p.cnt = (float*)cnt;
  p.B = B; p.H = H; p.Hkv = Hkv; p.W = W; p.hd = hd; p.bs = bs; p.n_max = n_max;
  p.mu = mu; p.gran = gran; p.rule = rule; p.lamp = lamp; p.n_ref = n_ref;
  p.window = window; p.scale = scale; p.kv_dtype = kv_dtype;
  p.keep = keep != 0;
  p.decode = false;
  return dispatch(p, work, pass, (cudaStream_t)stream);
}

// Decode rows: one query per row at position lengths[r] - 1, the mixed
// kernel at W = 1 with relaxed_ln's row length L. q (R, H, 1, hd); out
// (R, H, 1, hd), cnt (R, H); work, arrive, k, v and kv_dtype as for the
// mixed rows at W = 1.
int lamp_paged_decode_attention(const void* q, const void* k, const void* v,
                                const void* bt, const void* lengths, const void* tau,
                                void* work, void* arrive, void* out, void* cnt, int R,
                                int H, int Hkv, int hd, int bs, int n_max, int mu,
                                int gran, int rule, int lamp, int n_ref, int window,
                                int keep, int kv_dtype, float scale, int pass,
                                void* stream) {
  Params p = {};
  p.q = (const float*)q; p.k = k; p.v = v;
  p.bt = (const int*)bt; p.starts = (const int*)lengths; p.qlens = nullptr;
  p.tau = (const float*)tau; p.arrive = (int*)arrive;
  p.out = (float*)out; p.cnt = (float*)cnt;
  p.B = R; p.H = H; p.Hkv = Hkv; p.W = 1; p.hd = hd; p.bs = bs; p.n_max = n_max;
  p.mu = mu; p.gran = gran; p.rule = rule; p.lamp = lamp; p.n_ref = n_ref;
  p.window = window; p.scale = scale; p.kv_dtype = kv_dtype;
  p.keep = keep != 0;
  p.decode = true;
  return dispatch(p, work, pass, (cudaStream_t)stream);
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
