// Auto-resetting RL evaluation rollout in one launch: one CUDA thread per env.
//
// Replaces jaxsim_tpu/ops/pallas_step.py::_env_rollout_kernel (built by
// build_pallas_env_rollout, K5) for flat ground without per-env domain
// multipliers. Each env, for n_steps:
//   1. computes its torques from the state before the step: the PD closure,
//      a linear policy tau = W obs + b, or a one-hidden-layer tanh MLP
//      tau = W2 tanh(W1 obs + b1) + b2 (JX_POLICY 0, 1, 2; JX_HIDDEN = H),
//      clipped to +-tau_limit for the linear and MLP policies;
//   2. takes one engine step (step_env, step_env.cuh);
//   3. ends the episode when the base height leaves (z_lo, z_hi) or the
//      episode reaches episode_length steps, adds the default reward
//      min(z, 2) - 0.001 sum(tau^2) of the transition, and on an end
//      respawns at the episode-start state (re-read from the input buffers,
//      which the outputs never alias), optionally with uniform noise on the
//      base position from a counter-based Philox4x32-10.
// The observation is [s, sd, q, v, p_z] (obs_dim = 2n + 11). The policy's
// products are the JAX kernel's sequential multiply-adds, bias first, then
// the rows in order, each product and sum rounded on its own (no FMA
// contraction), as the plain version computes them.
//
// Weights are call-time inputs, so new weights need no rebuild. With P
// candidates (per-candidate weights, the JAX per_tile_weights) env b uses
// candidate b / (B / P); the wrapper requires B / P to be a multiple of the
// block size, so each block loads one candidate's weights into shared
// memory next to the model arrays (dynamic shared memory: the MLP's weights
// grow with H).
//
// What bounds it on the card: the rollout kernel's per-thread latency
// (rollout.cu). The policy adds about 1.3 k multiply-adds and the episode
// logic a few dozen operations to a step of about 10^5; the respawn reads
// the 812 B of an env's start state again, from L2 or HBM, once an episode.

#include "step_env.cuh"

#ifndef JX_POLICY
#error "JX_POLICY (0 = PD, 1 = linear, 2 = MLP) must be defined"
#endif

namespace {

constexpr int OBS = 2 * NJ + 11;
#if JX_POLICY == 2
constexpr int H = JX_HIDDEN;
constexpr int WSZ = H * OBS + H + NJ * H + NJ;  // W1 | b1 | W2 | b2
#elif JX_POLICY == 1
constexpr int WSZ = NJ * OBS + NJ;  // W | b
#else
constexpr int WSZ = 0;
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
__device__ __forceinline__ float mac(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}

// jnp.clip / torch.clamp: a NaN passes through.
__device__ __forceinline__ float clip_tau(float x, const Options& o) {
  if (!o.clip) return x;
  return x < -o.tau_limit ? -o.tau_limit : (x > o.tau_limit ? o.tau_limit : x);
}

// Sequential multiply-adds of a dense layer's row: b + w[0] x[0] + w[1] x[1] + ...
template <int N>
__device__ __forceinline__ float affine_row(float bias, const float* w, const float* x) {
  float acc = mac(bias, w[0], x[0]);
  for (int k = 1; k < N; ++k) acc = mac(acc, w[k], x[k]);
  return acc;
}

__device__ void policy(const Env& e, const float* Wt, const Scalars& sc, const Options& o,
                       float* tau) {
#if JX_POLICY == 0
  (void)Wt;
  (void)o;
  for (int k = 0; k < NJ; ++k) tau[k] = -sc.kp * e.s[k] - sc.kd * e.sd[k];
#else
  (void)sc;
  float obs[OBS];
  for (int k = 0; k < NJ; ++k) {
    obs[k] = e.s[k];
    obs[NJ + k] = e.sd[k];
  }
  for (int k = 0; k < 4; ++k) obs[2 * NJ + k] = e.q[k];
  for (int k = 0; k < 6; ++k) obs[2 * NJ + 4 + k] = e.v[k];
  obs[2 * NJ + 10] = e.p[2];
#if JX_POLICY == 1
  const float* W = Wt;
  const float* bias = Wt + NJ * OBS;
  for (int a = 0; a < NJ; ++a) tau[a] = clip_tau(affine_row<OBS>(bias[a], W + a * OBS, obs), o);
#else
  const float* W1 = Wt;
  const float* b1 = W1 + H * OBS;
  const float* W2 = b1 + H;
  const float* b2 = W2 + NJ * H;
  float hid[H];
  for (int j = 0; j < H; ++j) hid[j] = tanhf(affine_row<OBS>(b1[j], W1 + j * OBS, obs));
  for (int a = 0; a < NJ; ++a) tau[a] = clip_tau(affine_row<H>(b2[a], W2 + a * H, hid), o);
#endif
#endif
}

// Philox4x32-10, first output word, key (seed, env), counter (step, row, 0, 0).
__device__ __forceinline__ unsigned philox_word0(unsigned seed, unsigned env, unsigned step,
                                                 unsigned row) {
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

__global__ void __launch_bounds__(BLOCK)
    env_rollout_kernel(const float* __restrict__ params, const float* __restrict__ weights,
                       StateIn in, StateOut out, float* __restrict__ reward_out,
                       int* __restrict__ resets_out, int* __restrict__ steps_out, int B,
                       int n_steps, Scalars sc, Options o) {
  extern __shared__ float smem[];
  float* P = smem;
  float* Wt = smem + N_PARAMS;
  load_params(params, P);
  if (WSZ > 0) {
    const int candidate = (blockIdx.x * blockDim.x) / o.envs_per_candidate;
    const float* src = weights + static_cast<size_t>(candidate) * WSZ;
    for (int k = threadIdx.x; k < WSZ; k += blockDim.x) Wt[k] = src[k];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Env e;
  load_env(in, B, b, e);
  Work w;
  float tau[NJA];
  int steps = 0, resets = 0;
  float reward_sum = 0.0f;
  for (int t = 0; t < n_steps; ++t) {
    policy(e, Wt, sc, o, tau);
    step_env(P, sc, w, e.s, e.sd, e.p, e.q, e.v, e.m, ArrayTau{tau});

    const int steps1 = steps + 1;
    const float z = e.p[2];
    // The JAX kernel's comparisons: a NaN height ends no episode.
    const bool done = (z < o.z_lo) || (z > o.z_hi) || (steps1 >= o.episode_length);
    float ctrl = 0.0f;
    for (int k = 0; k < NJ; ++k) ctrl = k ? mac(ctrl, tau[k], tau[k]) : __fmul_rn(tau[k], tau[k]);
    const float upright = z > 2.0f ? 2.0f : z;  // jnp.minimum: a NaN passes through
    reward_sum = __fadd_rn(reward_sum, __fsub_rn(upright, __fmul_rn(0.001f, ctrl)));

    if (done) {
      load_env(in, B, b, e);
      if (o.noise_half > 0.0f) {
        for (int r = 0; r < 3; ++r) {
          const unsigned bits = philox_word0(o.seed, b, t, r);
          const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
          e.p[r] = __fadd_rn(e.p[r], __fmul_rn(o.noise_half, 2.0f * u - 1.0f));
        }
      }
      steps = 0;
      ++resets;
    } else {
      steps = steps1;
    }
  }

  store_env(e, B, b, out);
  reward_out[b] = reward_sum;
  resets_out[b] = resets;
  steps_out[b] = steps;
}

}  // namespace

extern "C" {

int jx_param_count() { return N_PARAMS; }

int jx_weight_count() { return WSZ; }

int jx_env_rollout(const float* params, const float* s, const float* sd, const float* p,
                   const float* q, const float* v, const float* m, const float* weights,
                   float* s_out, float* sd_out, float* p_out, float* q_out, float* v_out,
                   float* m_out, float* reward_out, int* resets_out, int* steps_out, int B,
                   int n_steps, float K, float D, float k_over_d, float mu, float hc_p,
                   float hc_q, float gz, float dt, float kp, float kd, int episode_length,
                   float z_lo, float z_hi, int clip, float tau_limit, float noise_half,
                   unsigned seed, int envs_per_candidate, void* stream) {
  const Scalars sc{K, D, k_over_d, mu, hc_p, hc_q, gz, dt, kp, kd};
  const Options o{episode_length, z_lo, z_hi, clip, tau_limit, noise_half, seed,
                  envs_per_candidate};
  const size_t smem = static_cast<size_t>(N_PARAMS + WSZ) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        env_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int blocks = (B + BLOCK - 1) / BLOCK;
  env_rollout_kernel<<<blocks, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      params, weights, StateIn{s, sd, p, q, v, m},
      StateOut{s_out, sd_out, p_out, q_out, v_out, m_out}, reward_out, resets_out, steps_out, B,
      n_steps, sc, o);
  return static_cast<int>(cudaGetLastError());
}

const char* jx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
