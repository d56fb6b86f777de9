// Auto-resetting RL evaluation rollout in one launch: each env on
// JX_LN_LANES lanes of a warp, its state and the step's working set in a slot
// of shared memory for the whole launch.
//
// Replaces jaxsim_tpu/ops/pallas_step.py::_env_rollout_kernel (built by
// build_pallas_env_rollout, K5) for soft contacts on flat ground, an
// inclined plane or Fourier terrain (JX_TERRAIN), with the JAX kernel's
// per-env options: the five domain multipliers (JX_DOMAIN) and the terrain
// offset (JX_TERR_OFF), loaded once a launch into each env's lanes, and the
// terrain-relative base height (JX_TERRAIN_REL: p_z - h(p_x - ox, p_y - oy)
// in the observation's last row and in the healthy-height test; the reward
// keeps the absolute p_z, as the JAX kernel's default reward does). Each
// env, for n_steps:
//   1. computes its torques from the state before the step: the PD closure,
//      a linear policy tau = W obs + b, or a one-hidden-layer tanh MLP
//      tau = W2 tanh(W1 obs + b1) + b2 (JX_POLICY 0, 1, 2; JX_HIDDEN = H),
//      clipped to +-tau_limit for the linear and MLP policies;
//   2. takes one engine step (soft_step_lanes, soft_step_lanes.cuh, on the
//      forward-only slot: it reads the state from the slot and writes the
//      new state back there);
//   3. ends the episode when the base height leaves (z_lo, z_hi) or the
//      episode reaches episode_length steps, adds the default reward
//      min(z, 2) - 0.001 sum(tau^2) of the transition, and on an end
//      respawns at the episode-start state (re-read from the input buffers,
//      which the outputs never alias), optionally with uniform noise on the
//      base position from a counter-based Philox4x32-10.
// The observation is [s, sd, q, v, p_z] (obs_dim = 2n + 11), the slot's
// state rows in that order. Each hidden unit's row and each torque's row is
// computed whole on one lane, dealt round-robin, by the JAX kernel's
// sequential multiply-adds, bias first, then the rows in order, each product
// and sum rounded on its own (no FMA contraction), as the plain version
// computes them; the torques go to a row of the slot that the step reads.
// Lane 0 keeps the reward sum (the control sum in joint order) and the
// resets; every lane keeps the episode's steps and takes the done test from
// the new base height in the slot, and on a respawn re-reads its share of
// the start state (the lane that loads a base position row adds its noise).
//
// Weights are call-time inputs, so new weights need no rebuild. With P
// candidates (per-candidate weights, the JAX per_tile_weights) env b uses
// candidate b / (B / P); the wrapper requires B / P to be a multiple of the
// envs a block (JX_LN_ENVS), so each block loads one candidate's weights
// into shared memory beside the model arrays and its envs' slots.
//
// What bounds it on the card: latency, as in the soft rollout (rollout.cu,
// which says what the lanes and the slot do about it). The policy adds about
// 1.3 k multiply-adds and the episode logic a few dozen operations to a step
// of about 10^4; the respawn reads the 812 B of an env's start state again,
// from L2 or HBM, once an episode.

#include "soft_step_lanes.cuh"
#include "env_policy.cuh"

static_assert(FORWARD, "env_rollout.cu takes the forward-only slot (JX_LN_FORWARD 1)");
static_assert(INTEGRATOR == 0, "env_rollout.cu implements semi-implicit Euler (JX_INTEGRATOR 0)");

#ifndef JX_TERRAIN_REL
#define JX_TERRAIN_REL 0
#endif

namespace {

constexpr bool TERRAIN_REL = JX_TERRAIN_REL != 0;
static_assert(!TERRAIN_REL || TERRAIN == 2, "a terrain-relative height needs Fourier terrain");

// An env's rows past the step's slot: its torques, the MLP's hidden units,
// and with JX_TERRAIN_REL the observation's terrain-relative height.
constexpr int SL_TAU = SLOT, SL_HID = SLOT + NJ, SL_HREL = SLOT + NJ + H_ROWS,
              ENV_ROWS = SLOT + NJ + H_ROWS + (TERRAIN_REL ? 1 : 0);
constexpr size_t K5_SMEM_BYTES =
    (static_cast<size_t>(N_PARAMS) + WSZ + static_cast<size_t>(ENV_ROWS) * ES) * sizeof(float);

// Entry k of the observation [s, sd, q, v, p_z]: the slot's state rows (the
// last, with JX_TERRAIN_REL, the terrain-relative height's row).
struct Obs {
  Slot sl;
  __device__ __forceinline__ float operator()(int k) const {
    if constexpr (TERRAIN_REL) {
      if (k == ST_P) return sl[SL_HREL];
    }
    return sl[SL_ST + (k < ST_P ? k : ST_P + 2)];
  }
};

// The base's height: p_z, or with JX_TERRAIN_REL the terrain-relative
// p_z - h(p_x - ox, p_y - oy).
template <class X>
__device__ __forceinline__ float base_height(const float* P, const X& x) {
  if constexpr (TERRAIN_REL && TERR_OFF) {
    return x.p[2] - fourier_height(P, x.p[0] - x.dom.ox, x.p[1] - x.dom.oy);
  } else if constexpr (TERRAIN_REL) {
    return x.p[2] - fourier_height(P, x.p[0], x.p[1]);
  } else {
    (void)P;
    return x.p[2];
  }
}

// Entry k of the slot's rows from j0 on.
struct SlotRow {
  Slot sl;
  int j0;
  __device__ __forceinline__ float operator()(int k) const { return sl[j0 + k]; }
};

// The step's torques: the slot's torque row.
struct SlotTau {
  Slot sl;
  __device__ __forceinline__ float operator()(int k) const { return sl[SL_TAU + k]; }
};

// The torques of the state in the slot, into its torque row, each row whole
// on one lane (unit j on lane j % G). Every lane of the block calls it.
__device__ void policy(const float* Wt, const Scalars& sc, const Options& o, Slot sl, const EnvState<float>& x,
                       int g) {
#if JX_POLICY == 0
  (void)Wt;
  (void)o;
  for (int k = g; k < NJ; k += G) sl[SL_TAU + k] = -sc.kp * x.s[k] - sc.kd * x.sd[k];
#else
  (void)sc;
  (void)x;
#if JX_POLICY == 1
  const float* W = Wt;
  const float* bias = Wt + NJ * OBS;
  for (int a = g; a < NJ; a += G) sl[SL_TAU + a] = clip_tau(affine_row<OBS>(bias[a], W + a * OBS, Obs{sl}), o);
#else
  const float* W1 = Wt;
  const float* b1 = W1 + H * OBS;
  const float* W2 = b1 + H;
  const float* b2 = W2 + NJ * H;
  for (int j = g; j < H; j += G) sl[SL_HID + j] = tanhf(affine_row<OBS>(b1[j], W1 + j * OBS, Obs{sl}));
  ln_sync();
  for (int a = g; a < NJ; a += G)
    sl[SL_TAU + a] = clip_tau(affine_row<H>(b2[a], W2 + a * H, SlotRow{sl, SL_HID}), o);
#endif
#endif
}

__global__ void __launch_bounds__(LN_THREADS, 1)
    env_rollout_kernel(const float* __restrict__ params, const float* __restrict__ weights, StateIn in,
                       StateOut out, float* __restrict__ reward_out, int* __restrict__ resets_out,
                       int* __restrict__ steps_out, int B, int n_steps, Scalars sc, Options o, DomainRows dr) {
  extern __shared__ float smem[];
  float* P = smem;
  float* Wt = smem + N_PARAMS;
  load_params(params, P);
  if (WSZ > 0) {
    const int candidate = (blockIdx.x * ENVS) / o.envs_per_candidate;
    const float* src = weights + static_cast<size_t>(candidate) * WSZ;
    for (int k = threadIdx.x; k < WSZ; k += blockDim.x) Wt[k] = src[k];
  }
  // Env e of the block on lanes e*G .. e*G + G-1; an env past the batch runs
  // env B - 1's steps beside the others, so that every lane reaches every
  // barrier and shuffle, and stores nothing.
  const int e = threadIdx.x / G, g = threadIdx.x % G;
  const int b0 = blockIdx.x * ENVS + e;
  const bool valid = b0 < B;
  const int b = valid ? b0 : B - 1;
  const Slot sl{smem + N_PARAMS + WSZ + e};
  const auto x = env_slot_state(sl, dr, B, b);
  load_state(in, B, b, x, g);
  __syncthreads();

  int steps = 0, resets = 0;
  float reward_sum = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    if constexpr (TERRAIN_REL && JX_POLICY != 0) {  // the observation's height row
      if (g == 0) sl[SL_HREL] = base_height(P, x);
      ln_sync();
    }
    policy(Wt, sc, o, sl, x, g);
    ln_sync();
    soft_step_lanes(P, sc, sl, g, x, SlotTau{sl}, nullptr);
    ln_sync();

    const int steps1 = steps + 1;
    const float pz = x.p[2], z = base_height(P, x);
    // The JAX kernel's comparisons: a NaN height ends no episode.
    const bool done = (z < o.z_lo) || (z > o.z_hi) || (steps1 >= o.episode_length);
    if (g == 0) {
      float ctrl = 0.0f;
      for (int k = 0; k < NJ; ++k) {
        const float tk = sl[SL_TAU + k];
        ctrl = k ? mac(ctrl, tk, tk) : __fmul_rn(tk, tk);
      }
      const float upright = pz > 2.0f ? 2.0f : pz;  // jnp.minimum: a NaN passes through
      reward_sum = __fadd_rn(reward_sum, __fsub_rn(upright, __fmul_rn(0.001f, ctrl)));
      resets += done;
    }
    ln_sync();  // every lane has read p before a respawn writes it
    if (done) {
      load_state(in, B, b, x, g);
      if (o.noise_half > 0.0f) {
        for (int r = g; r < 3; r += G) {  // the rows load_state gave this lane
          const unsigned bits = philox_word0(o.seed, b, t, r);
          const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
          x.p[r] = __fadd_rn(x.p[r], __fmul_rn(o.noise_half, 2.0f * u - 1.0f));
        }
      }
    }
    steps = done ? 0 : steps1;
    ln_sync();
  }

  if (valid) {
    store_state(x, B, b, out, g);
    if (g == 0) {
      reward_out[b] = reward_sum;
      resets_out[b] = resets;
      steps_out[b] = steps;
    }
  }
}

}  // namespace

extern "C" {

int jx_param_count() { return N_PARAMS; }

int jx_weight_count() { return WSZ; }

int jx_env_rollout(const float* params, const float* s, const float* sd, const float* p, const float* q,
                   const float* v, const float* m, const float* weights, float* s_out, float* sd_out, float* p_out,
                   float* q_out, float* v_out, float* m_out, float* reward_out, int* resets_out, int* steps_out,
                   int B, int n_steps, float K, float D, float k_over_d, float mu, float hc_p, float hc_q, float gz,
                   float dt, float kp, float kd, int episode_length, float z_lo, float z_hi, int clip,
                   float tau_limit, float noise_half, unsigned seed, int envs_per_candidate, const float* domain,
                   const float* terr_off, void* stream) {
  const Scalars sc{K, D, k_over_d, mu, hc_p, hc_q, gz, dt, kp, kd};
  const Options o{episode_length, z_lo, z_hi, clip, tau_limit, noise_half, seed, envs_per_candidate};
  const cudaError_t rc = cudaFuncSetAttribute(env_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(K5_SMEM_BYTES));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int blocks = (B + ENVS - 1) / ENVS;
  env_rollout_kernel<<<blocks, LN_THREADS, K5_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      params, weights, StateIn{s, sd, p, q, v, m}, StateOut{s_out, sd_out, p_out, q_out, v_out, m_out}, reward_out,
      resets_out, steps_out, B, n_steps, sc, o, DomainRows{domain, terr_off});
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry, for the reports: threads a block, envs a block,
// dynamic shared memory a block in bytes, and blocks an SM holds at once
// (the occupancy calculator: registers, threads and shared memory).
int jx_env_geometry(int* out) {
  cudaError_t rc = cudaFuncSetAttribute(env_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(K5_SMEM_BYTES));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks_per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, env_rollout_kernel, LN_THREADS, K5_SMEM_BYTES);
  out[0] = LN_THREADS;
  out[1] = ENVS;
  out[2] = static_cast<int>(K5_SMEM_BYTES);
  out[3] = blocks_per_sm;
  return static_cast<int>(rc);
}

const char* jx_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
