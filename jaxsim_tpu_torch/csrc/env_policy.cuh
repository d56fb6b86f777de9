// What the env rollouts (K5: env_rollout.cu on the soft lane step,
// env_rollout_rr.cu on the relaxed-rigid step) share besides their step: the
// policy's sizes (JX_POLICY 0 PD, 1 linear, 2 the tanh MLP of JX_HIDDEN
// units), the episode options, the policy rows' arithmetic and the reset
// noise's Philox stream. Each policy row is the plain version's sequence of
// multiply-adds (jaxsim_tpu_torch/ops/policies.py), bias first, then the
// rows in order, each product and sum rounded on its own (no FMA
// contraction), so kernel and plain version compute the same float32 sums.

#pragma once

#include "step_env.cuh"

#ifndef JX_POLICY
#error "JX_POLICY (0 = PD, 1 = linear, 2 = MLP) must be defined"
#endif

namespace {

constexpr int OBS = 2 * NJ + 11;  // the observation [s, sd, q, v, p_z]
#if JX_POLICY == 2
constexpr int H = JX_HIDDEN;
constexpr int WSZ = H * OBS + H + NJ * H + NJ;  // W1 | b1 | W2 | b2
constexpr int H_ROWS = H;
#elif JX_POLICY == 1
constexpr int WSZ = NJ * OBS + NJ;  // W | b
constexpr int H_ROWS = 0;
#else
constexpr int WSZ = 0;
constexpr int H_ROWS = 0;
#endif

struct Options {
  int episode_length;
  float z_lo, z_hi;
  int clip;
  float tau_limit;
  float noise_half;  // sqrt(3) * reset_noise; 0 turns the noise off
  unsigned seed;
  int envs_per_candidate;
};

// round(acc + w * x) with the product rounded first, as the plain version.
__device__ __forceinline__ float mac(float acc, float w, float x) { return __fadd_rn(acc, __fmul_rn(w, x)); }

// jnp.clip / torch.clamp: a NaN passes through.
__device__ __forceinline__ float clip_tau(float x, const Options& o) {
  if (!o.clip) return x;
  return x < -o.tau_limit ? -o.tau_limit : (x > o.tau_limit ? o.tau_limit : x);
}

// Sequential multiply-adds of a dense layer's row: b + w[0] x(0) + w[1] x(1) + ...
template <int N, class X>
__device__ __forceinline__ float affine_row(float bias, const float* w, X x) {
  float acc = mac(bias, w[0], x(0));
  for (int k = 1; k < N; ++k) acc = mac(acc, w[k], x(k));
  return acc;
}

// Philox4x32-10, first output word, key (seed, env), counter (step, row, 0, 0).
__device__ __forceinline__ unsigned philox_word0(unsigned seed, unsigned env, unsigned step, unsigned row) {
  unsigned c0 = step, c1 = row, c2 = 0u, c3 = 0u, k0 = seed, k1 = env;
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned lo0 = c0 * 0xD2511F53u, hi0 = __umulhi(c0, 0xD2511F53u);
    const unsigned lo1 = c2 * 0xCD9E8D57u, hi1 = __umulhi(c2, 0xCD9E8D57u);
    const unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

}  // namespace
