// Blocked matmul with PS(mu) accumulation, for NVIDIA Hopper (sm_90a), on
// the tensor cores.
//
// Replaces the TPU kernel repro/kernels/ps_matmul.py::ps_matmul (Pallas body
// _kernel): C = A @ B, (M, K) @ (K, N) in FP32, where every output's running
// accumulator is rounded to PS(mu) each time the FP32 partial sum of one
// block_k slab of K is added to it (no rounding at mu >= 23). block_k is
// semantics (it fixes the rounding points); the output tiling is not.
//
// Design. A thread block owns a 64 x 64 output tile; its 4 warps each own
// 32 x 32 outputs as 2 x 4 fragments of mma.sync m16n8k8 (tf32 in, f32
// out). At <= 128 registers a thread, 4 blocks (16 warps) share an SM, so
// one block's barrier waits are covered by the others' work. K is staged in
// tiles of 32 in a ring of 3 shared-memory stages, filled by cp.async
// (zero-fill past M, N and K). The A tile (k contiguous) has rows of 32 + 4
// floats, read by ldmatrix (one instruction a fragment), and the B tile (n
// contiguous) rows of 64 + 8, read a value a lane: both hit 32 distinct
// banks. Each slab's sum is an FP32 sum in 3xTF32: every value is split
// into hi = tf32(x) and lo = tf32(x - hi) as its fragment is loaded (tf32
// rounds to nearest, ties away, as cvt.rna.tf32.f32 does, but on the
// integer pipe), and each k-step of 8 issues lo.hi and hi.lo first, then
// hi.hi, into the slab's own accumulator `part` (a single TF32 pass would
// keep about 10 mantissa bits, and the slab would no longer be an FP32
// sum). When a slab is complete, acc = round_to_mantissa(acc + part) and
// part restarts at 0, elementwise on the fragments' registers. A k-step
// never straddles a slab edge: K is walked in a padded index space where
// each slab takes ceil(block_k / 8) * 8 lanes, the pad copied in as zeros
// (zero products add exact zeros), so any block_k that divides K works.
// The split, not the tensor cores, takes most of the issue slots: 16
// values (5 integer and FP32 operations each, and the flag's compare)
// per 24 MMAs a warp and k-step.
//
// Two walks of K. The tiled walk, where slabs are whole staged tiles
// (block_k a multiple of 32) and rows of A and B start on 16 bytes, copies
// 16 bytes at a time from pointers that step a tile, and folds only after
// a tile's last k-step. Every other shape takes the general walk: 4-byte
// copies mapped lane by lane, and the slab edge checked every k-step.
//
// NaN and Inf come out as in FP32. 3xTF32 alone loses them (the integer
// tf32 rounding wraps a NaN of a high payload into a zero; the cross
// products make 1 . Inf a NaN), so the split flags a value whose x - hi is
// not finite, one FP32 compare a value, and a warp that met one, or whose
// outputs are not finite, sums its outputs again on the CUDA cores in
// slab_sums' order (exact_tile) before it ends.
//
// What bounds it on the H100: operations -- 3 x 2 M N K on the tensor cores
// at the dense TF32 rate (495 TFLOP/s). At GPT-2 small's MLP up-projection,
// (1024, 768) @ (768, 3072): 3 x 4,831,838,208 FLOP = 0.02928 ms, against
// 25,165,824 bytes at 3.35 TB/s = 0.00751 ms.
//
// Against the plain version (repro_torch.core.mixed_matmul.slab_sums, each
// slab summed lane by lane in k order) the slab sum is taken in another
// order, inside the MMA, and without the lo.lo term (about 2^-22 relative),
// so it can differ by an FP32 roundoff. Where a running accumulator sits
// on a PS(mu) rounding midpoint, that roundoff tips it one PS(mu) step the
// other way, and the step carries to the output. Such outputs are rare
// (a fraction of a percent at mu 7) and each is within 2^(1-mu) (|A| @ |B|);
// at mu 23 every output is an FP32 sum within roundoff of the plain one.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "lamp_device.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace lamp_dev;
using namespace tf32_mma;

constexpr int BM = 64, BN = 64;     // block tile
constexpr int BK = 32;              // k (padded lanes) per staged tile
constexpr int WM = 32, WN = 32;     // warp tile
constexpr int MF = WM / 16, NF = WN / 8;
constexpr int WARPS_N = BN / WN;
constexpr int NT = 32 * (BM / WM) * WARPS_N;   // 4 warps: 2 (m) x 2 (n)
constexpr int BLOCKS_PER_SM = 4;    // registers (<= 128 a thread) and shared memory
constexpr int STAGES = 3;
constexpr int SA = BK + 4;          // A tile row stride: banks 4 g + t
constexpr int SB = BN + 8;          // B tile row stride: banks 8 t + g
constexpr int A_TILE = BM * SA, B_TILE = BK * SB;
constexpr size_t SMEM_BYTES = sizeof(float) * STAGES * (A_TILE + B_TILE);

struct Params {
  const float* A;
  const float* B;
  float* C;
  int M, N, K, mu;
  int bk, bkp, nslab;   // slab width, padded to a multiple of 8, slab count
  int kp;               // padded length of K: nslab * bkp
};

// Padded lane p -> global k, or -1 on a pad lane or past the end.
__device__ __forceinline__ int k_of(const Params& p, int lane) {
  if (p.bkp == p.bk) return lane < p.K ? lane : -1;   // no pad lanes
  const int s = lane / p.bkp, o = lane - s * p.bkp;
  return (s < p.nslab && o < p.bk) ? s * p.bk + o : -1;
}

// Stage the k-tile starting at padded lane p0 into sA (BM x BK, k
// contiguous) and sB (BK x BN, n contiguous) by 4-byte copies: any shape,
// pad lanes and lanes past K zero-filled.
__device__ __forceinline__ void load_tile(const Params& p, float* sA, float* sB, int m0,
                                          int n0, int p0) {
  const int tid = threadIdx.x;
  for (int i = tid; i < BM * BK; i += NT) {
    const int m = i / BK, c = i % BK;
    const int gm = m0 + m, gk = k_of(p, p0 + c);
    const bool ok = gm < p.M && gk >= 0;
    cp_async4(sA + m * SA + c, ok ? p.A + (size_t)gm * p.K + gk : p.A, ok);
  }
  for (int i = tid; i < BK * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    const int gk = k_of(p, p0 + r), gn = n0 + c;
    const bool ok = gk >= 0 && gn < p.N;
    cp_async4(sB + r * SB + c, ok ? p.B + (size_t)gk * p.N + gn : p.B, ok);
  }
}

// The TILED loader (K a whole number of tiles, no pad lanes, 16-byte
// rows): each thread copies the same chunks of every tile, its source
// pointers stepping by BK lanes of K.
constexpr int A_CH = BM * BK / 4 / NT, B_CH = BK * BN / 4 / NT;   // chunks a thread
static_assert(NT % (BK / 4) == 0 && NT % (BN / 4) == 0, "fixed chunk columns");
static_assert(BM * BK / 4 % NT == 0 && BK * BN / 4 % NT == 0, "whole chunks a thread");

struct FastLoader {
  const float* a[A_CH];
  const float* b[B_CH];
  bool a_ok[A_CH], b_ok[B_CH];
  int a_off, b_off;   // shared-memory offsets of the thread's first chunks
  size_t b_step;      // floats of B per tile: BK rows

  __device__ __forceinline__ FastLoader(const Params& p, int m0, int n0) {
    const int tid = threadIdx.x;
    const int am = tid / (BK / 4), ac = (tid % (BK / 4)) * 4;
    const int br = tid / (BN / 4), bc = (tid % (BN / 4)) * 4;
#pragma unroll
    for (int j = 0; j < A_CH; ++j) {
      const int gm = m0 + am + j * (NT / (BK / 4));
      a_ok[j] = gm < p.M;
      a[j] = p.A + (size_t)(a_ok[j] ? gm : 0) * p.K + ac;
    }
#pragma unroll
    for (int j = 0; j < B_CH; ++j) {
      b_ok[j] = n0 + bc < p.N;
      b[j] = p.B + (size_t)(br + j * (NT / (BN / 4))) * p.N + (b_ok[j] ? n0 + bc : 0);
    }
    a_off = am * SA + ac;
    b_off = br * SB + bc;
    b_step = (size_t)BK * p.N;
  }

  __device__ __forceinline__ void load(float* sA, float* sB, int kt) const {
#pragma unroll
    for (int j = 0; j < A_CH; ++j)
      cp_async16(sA + a_off + j * (NT / (BK / 4)) * SA, a[j] + kt * BK, a_ok[j]);
#pragma unroll
    for (int j = 0; j < B_CH; ++j)
      cp_async16(sB + b_off + j * (NT / (BN / 4)) * SB, b[j] + kt * b_step, b_ok[j]);
  }
};

using Frag = float[MF][NF][4];

// One k-step of 8 lanes (ks-th of the staged tile) into part: split the
// warp's fragments into tf32 hi and lo, then lo.hi, hi.lo and hi.hi. Each
// pass runs over all MF x NF fragments before the next, so the three
// products into one fragment are never back to back.
__device__ __forceinline__ void k_step(const float* sA, const float* sB, int ks, int wm,
                                       int wn, int g, int t, int lane, Frag& part,
                                       bool& bad) {
  uint32_t ahi[MF][4], alo[MF][4], bhi[NF][2], blo[NF][2];
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    uint32_t raw[4];
    ldmatrix_x4(raw, sA + (wm + i * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * SA + ks * 8 +
                         4 * (lane / 16));
#pragma unroll
    for (int r = 0; r < 4; ++r) split(__uint_as_float(raw[r]), ahi[i][r], alo[i][r], bad);
  }
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const float* b = sB + (ks * 8 + t) * SB + wn + j * 8 + g;
    split(b[0], bhi[j][0], blo[j][0], bad);        // (k t, n g)
    split(b[4 * SB], bhi[j][1], blo[j][1], bad);   // (k t + 4, n g)
  }
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) mma_tf32(part[i][j], alo[i], bhi[j]);
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) mma_tf32(part[i][j], ahi[i], blo[j]);
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) mma_tf32(part[i][j], ahi[i], bhi[j]);
}

// The slab is complete: acc = PS(mu)(acc + part), part = 0.
__device__ __forceinline__ void fold(Frag& acc, Frag& part, int mu) {
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i][j][r] = round_to_mantissa(__fadd_rn(acc[i][j][r], part[i][j][r]), mu);
        part[i][j][r] = 0.f;
      }
}

// The warp tile at (mb, nb) summed again on the CUDA cores, read from
// global memory: each slab lane by lane in FP32, k ascending, then folded
// as above (slab_sums' order), so NaN and Inf come out as in FP32.
__device__ __noinline__ void exact_tile(const Params p, int mb, int nb, int g, int t) {
  for (int e = 0; e < MF * NF * 4; ++e) {
    const int i = e / (NF * 4), j = e / 4 % NF, r = e % 4;
    const int m = mb + i * 16 + g + 8 * (r / 2), n = nb + j * 8 + 2 * t + r % 2;
    if (m >= p.M || n >= p.N) continue;
    float acc = 0.f;
    for (int s = 0; s < p.nslab; ++s) {
      const float* a = p.A + (size_t)m * p.K + (size_t)s * p.bk;
      const float* b = p.B + (size_t)s * p.bk * p.N + n;
      float part = 0.f;
      for (int k = 0; k < p.bk; ++k)
        part = __fadd_rn(part, __fmul_rn(a[k], b[(size_t)k * p.N]));
      acc = round_to_mantissa(__fadd_rn(acc, part), p.mu);
    }
    p.C[(size_t)m * p.N + n] = acc;
  }
}

// How a launch walks K (see the head of the file): TILED, FastLoader fills
// the stages, a tile's k-steps run unguarded and a fold can only follow the
// last of them; otherwise load_tile maps every lane, and each k-step checks
// the tile's end and the slab edge.
template <bool TILED>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) ps_matmul_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const FastLoader fast(p, m0, n0);
  auto stage = [&](int kt) {
    float* sA = smem + (kt % STAGES) * (A_TILE + B_TILE);
    if (TILED) fast.load(sA, sA + A_TILE, kt);
    else load_tile(p, sA, sA + A_TILE, m0, n0, kt * BK);
  };

  Frag acc, part;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = part[i][j][r] = 0.f;

  const int ntiles = (p.kp + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) stage(s);
    cp_async_commit();   // an empty group past the end keeps the count
  }

  int in_slab = 0;   // padded lanes of the current slab summed into part
  bool bad = false;  // a value of this thread's fragments split to a non-finite x - hi
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; tile kt - 1 is consumed
    if (kt + STAGES - 1 < ntiles) stage(kt + STAGES - 1);
    cp_async_commit();
    const float* sA = smem + (kt % STAGES) * (A_TILE + B_TILE);
    const float* sB = sA + A_TILE;
    if (TILED) {
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) k_step(sA, sB, ks, wm, wn, g, t, lane, part, bad);
      in_slab += BK;
      if (in_slab == p.bkp) {
        fold(acc, part, p.mu);
        in_slab = 0;
      }
    } else {
      const int ksteps = min(BK, p.kp - kt * BK) / 8;
      for (int ks = 0; ks < ksteps; ++ks) {
        k_step(sA, sB, ks, wm, wn, g, t, lane, part, bad);
        in_slab += 8;
        if (in_slab == p.bkp) {
          fold(acc, part, p.mu);
          in_slab = 0;
        }
      }
    }
  }
  cp_async_wait<0>();

  // fragment element r: row g + 8 (r / 2), column 2 t + r % 2
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gm = m0 + wm + i * 16 + g + 8 * (r / 2);
        const int gn = n0 + wn + j * 8 + 2 * t + r % 2;
        if (gm < p.M && gn < p.N) p.C[(size_t)gm * p.N + gn] = acc[i][j][r];
        bad |= !(fabsf(acc[i][j][r]) <= FLT_MAX);
      }
  // A NaN or Inf operand, or a sum past FLT_MAX: the warp's outputs again
  if (__any_sync(FULL, bad)) exact_tile(p, m0 + wm, n0 + wn, g, t);
}

template <bool TILED>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static bool granted = false;   // > 48 KB of shared memory, opted in once
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ps_matmul_kernel<TILED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    granted = true;
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM), block(NT);
  ps_matmul_kernel<TILED><<<grid, block, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

// Test entry: for each x, split(x) and cvt.rna.tf32.f32 of x and of x - hi,
// and split's flag.
__global__ void tf32_split_kernel(const float* __restrict__ x, uint32_t* __restrict__ out,
                                  long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t hi, lo;
  bool bad = false;
  split(x[i], hi, lo, bad);
  const uint32_t hc = tf32_cvt(x[i]);
  out[5 * i] = hi;
  out[5 * i + 1] = lo;
  out[5 * i + 2] = hc;
  out[5 * i + 3] = tf32_cvt(__fsub_rn(x[i], __uint_as_float(hc)));
  out[5 * i + 4] = bad;
}

}  // namespace

extern "C" {

// x (n,) float32 -> out (n, 5) uint32: the kernel's hi and lo of each x, the
// same two from cvt.rna.tf32.f32, and 1 where split flags x as not finite.
// Returns the CUDA error of the launch.
int lamp_tf32_split(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  tf32_split_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                      (cudaStream_t)stream>>>((const float*)x, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}


// A (M, K), B (K, N), C (M, N), all float32 row-major; block_k divides K.
// Returns the CUDA error of the launch (0 = cudaSuccess).
int lamp_ps_matmul(const void* a, const void* b, void* c, int M, int N, int K,
                   int mu, int block_k, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || block_k <= 0 || K % block_k != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.A = (const float*)a; p.B = (const float*)b; p.C = (float*)c;
  p.M = M; p.N = N; p.K = K; p.mu = mu;
  p.bk = block_k; p.bkp = (block_k + 7) / 8 * 8; p.nslab = K / block_k;
  p.kp = p.nslab * p.bkp;
  // the tiled walk copies 16 bytes at a time: rows of A and B on 16 bytes
  const bool tiled = block_k % BK == 0 && N % 4 == 0 && (uintptr_t)a % 16 == 0 &&
                     (uintptr_t)b % 16 == 0;
  return (int)(tiled ? launch<true>(p, (cudaStream_t)stream)
                     : launch<false>(p, (cudaStream_t)stream));
}

}  // extern "C"
