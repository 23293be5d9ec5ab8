// Device helpers shared by the paged LAMP attention kernels
// (paged_attention.cu serves both), so the PS(mu) rounding and the
// selection rules are defined once.
//
// Bit-exactness: round_to_mantissa is bit-exact with
// repro_torch.core.numerics.round_to_mantissa. dot_low_chunked spells each
// product and sum with __fmul_rn / __fadd_rn (and the sources are built with
// -fmad=false), so at granularity 1 it matches
// repro_torch.core.mixed_matmul.dot_ps bit for bit. expf, logf, sqrtf and
// division are the IEEE-accurate ones (never --use_fast_math): they feed the
// selection thresholds.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lamp_dev {

constexpr float NEG = -1e30f;
constexpr float TINY = 1.1754944e-38f;
constexpr unsigned FULL = 0xffffffffu;

enum Rule { RULE_NONE = 0, RULE_STRICT = 1, RULE_RELAXED = 2, RULE_RELAXED_LN = 3 };

// PS(mu) rounding constants for mu < 23, hoisted out of a loop of roundings.
struct PsRound {
  unsigned shift, half_m1, keep;   // 23 - mu; half an ulp minus 1; kept bits
};

__device__ __forceinline__ PsRound ps_round(int mu) {
  PsRound r;
  r.shift = 23u - (unsigned)mu;
  r.half_m1 = (1u << (r.shift - 1u)) - 1u;
  r.keep = ~((1u << r.shift) - 1u);
  return r;
}

// Round to nearest, ties to even, without branches: adding half an ulp
// minus 1, plus the kept lsb, carries into the kept bits exactly when the
// dropped bits are above half, or at half with the lsb odd (the carry may
// reach the exponent); Inf and NaN keep their bits.
__device__ __forceinline__ float round_ps(float x, PsRound r) {
  const unsigned bits = __float_as_uint(x);
  const unsigned up = (bits + r.half_m1 + ((bits >> r.shift) & 1u)) & r.keep;
  return __uint_as_float((bits & 0x7F800000u) == 0x7F800000u ? bits : up);
}

__device__ __forceinline__ float round_to_mantissa(float x, int mu) {
  return mu >= 23 ? x : round_ps(x, ps_round(mu));
}

__device__ __forceinline__ float dot_exact(const float* q, const float* k, int hd) {
  float acc = 0.f;
  for (int d = 0; d < hd; ++d) acc = fmaf(q[d], k[d], acc);
  return acc;
}

// PS(mu) logit with the rounding points of dot_ps at granularity g >= 1
// (g < hd). Granularity 0, g >= hd and mu >= 23 go through dot_exact.
__device__ __forceinline__ float dot_low_chunked(const float* q, const float* k,
                                                 int hd, int mu, int g) {
  float acc = 0.f;
  for (int s = 0; s < hd; s += g) {
    const int e = min(s + g, hd);
    float part = __fmul_rn(q[s], k[s]);
    for (int d = s + 1; d < e; ++d) part = __fadd_rn(part, __fmul_rn(q[d], k[d]));
    acc = round_to_mantissa(__fadd_rn(acc, part), mu);
  }
  return acc;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// The look-ahead rule on one low-precision logit y of a valid key (ok),
// against the row's pass-1 statistics: smax = max(y + log|y|) for the
// relaxed rules, m and l (max and normalizer of the y_low softmax) for the
// strict rule. n_row is the softmax row's length for relaxed_ln.
__device__ __forceinline__ bool lamp_selects(int rule, float y, bool ok, float smax,
                                             float m, float l, float tau,
                                             float log_tau, int n_row, int n_ref) {
  if (rule == RULE_STRICT) {
    float z = ok ? expf(y - m) : 0.f;
    z = z / fmaxf(l, TINY);
    return ok && __fmul_rn(__fmul_rn(2.f * z, 1.f - z), fabsf(y)) > tau;
  }
  const float s = __fadd_rn(y, logf(fabsf(y)));   // -inf at y == 0: never selects
  float thr;
  if (rule == RULE_RELAXED) {
    thr = log_tau + smax;
  } else {                                         // RULE_RELAXED_LN
    float tau_row = __fmul_rn(tau, sqrtf(__fdiv_rn((float)n_ref, (float)max(n_row, 1))));
    tau_row = fminf(tau_row, 0.999999f);
    thr = logf(tau_row) + smax;
  }
  return ok && s > thr;
}

}  // namespace lamp_dev
