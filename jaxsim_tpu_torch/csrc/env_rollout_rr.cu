// Auto-resetting RL evaluation rollout in one launch, relaxed-rigid contacts:
// each env on JX_RR_LANES lanes of a warp, the contact solve's working set in
// its slot of shared memory, K1-rr's step and launch geometry.
//
// Replaces jaxsim_tpu/ops/pallas_step.py::_env_rollout_kernel (built by
// build_pallas_env_rollout, K5) for relaxed-rigid engines on flat ground, an
// inclined plane or Fourier terrain (JX_TERRAIN), with the JAX kernel's
// per-env options as the soft K5 takes them: the multiplier rows (JX_DOMAIN;
// the relaxed-rigid step reads gmul and Mmul), the terrain offset
// (JX_TERR_OFF), each env's loaded once a launch (rr_load_domain), and the
// terrain-relative base height (JX_TERRAIN_REL: p_z - h(p_x - ox, p_y - oy)
// in the observation's last row and in the healthy-height test, the reward
// keeping the absolute height). Each env, for n_steps, as the soft K5
// (env_rollout.cu):
//   1. computes its torques from the state before the step: the PD closure,
//      a linear policy tau = W obs + b, or a one-hidden-layer tanh MLP
//      tau = W2 tanh(W1 obs + b1) + b2 (JX_POLICY 0, 1, 2; JX_HIDDEN = H),
//      clipped to +-tau_limit for the linear and MLP policies, into the
//      env's torque row of the slot;
//   2. takes one relaxed-rigid step (rr_step_env, rr_step.cuh) with those
//      torques (SlotTauRr);
//   3. ends the episode when the base height leaves (z_lo, z_hi) or the
//      episode reaches episode_length steps, adds the default reward
//      min(z, 2) - 0.001 sum(tau^2) of the transition (the new height, the
//      step's torques), and on an end respawns at the episode-start state,
//      re-read from the input buffers (which the outputs never alias),
//      optionally with uniform noise on the base position from the
//      counter-based Philox4x32-10 of ops/philox.py. The start state here
//      includes m, the solved point forces that warm-start the next solve.
//
// Who does what. The lanes keep K1-rr's roles between steps: lane g of env
// threadIdx.x / G holds s and sd of its links' joints (lane 0 also p, q and
// v) and the m rows of its point slots; each lane writes its entries of the
// observation [s, sd, q, v, p_z] into the env's slot, in rows that no lane
// reads between a step's contact solve and the next step's free ABA (the F
// rows and the base factor L0, which the next step writes before it reads
// them); the policy runs on the env's lanes, each hidden unit's row and each
// torque's row computed whole on one lane, dealt round-robin, bias first,
// each product and sum rounded on its own, as env_rollout.cu does; the
// hidden units sit beside the observation when they fit there, else in rows
// of their own past the slot. Lane 0 runs the done test, the reward and the
// base's respawn, and leaves the step's done flag in the last of those rows,
// where each lane reads it to re-read its own joints' and point slots' start
// rows on a respawn.
//
// Weights are call-time inputs, so new weights need no rebuild. With P
// candidates (per-candidate weights, the JAX per_tile_weights) env b uses
// candidate b / (B / P); the wrapper requires B / P to be a multiple of the
// envs a block (JX_RR_ENVS, sized by cuda_build.rr_tables with the weights
// in the block), so each block loads one candidate's weights into shared
// memory beside the model arrays and its envs' slots.
//
// What bounds it on the card: K1-rr's step (see rollout_rr.cu). The policy
// adds about 1.3 k multiply-adds on 8 lanes and the episode logic a few
// dozen operations to a step of about 1.8 * 10^4; the respawn reads an env's
// start state again, from L2 or HBM, once an episode.

#include "rr_step.cuh"
#include "env_policy.cuh"

#ifndef JX_TERRAIN_REL
#define JX_TERRAIN_REL 0
#endif

static_assert(INTEGRATOR == 0, "env_rollout_rr.cu implements semi-implicit Euler (JX_INTEGRATOR 0)");
static_assert(JX_RR_TAU_ROW, "env_rollout_rr.cu writes the policy's torques into the slot's torque row");

namespace {

constexpr bool TERRAIN_REL = JX_TERRAIN_REL != 0;
static_assert(!TERRAIN_REL || TERRAIN == 2, "a terrain-relative height needs Fourier terrain");

// The base's height in the slot (lane 0's rows): p_z, or with
// JX_TERRAIN_REL the terrain-relative p_z - h(p_x - ox, p_y - oy).
__device__ __forceinline__ float rr_base_height(const float* P, Slot sl, const EnvDomain& dom) {
  const float pz = sl[rr_base_at(2)];
  if constexpr (TERRAIN_REL) {
    const float x = sl[rr_base_at(0)], y = sl[rr_base_at(1)];
    return pz - fourier_height(P, TERR_OFF ? x - dom.ox : x, TERR_OFF ? y - dom.oy : y);
  } else {
    (void)P;
    (void)dom;
    return pz;
  }
}

// The rows of an env's slot that no thread reads between a step's contact
// solve and the next step's free ABA: the F rows and L0 (cuda_build's
// rr_dead_rows).
constexpr int DEAD = NL * 6 + 36;
static_assert(SL_L0 == SL_F + NL * 6 && SL_PAR == SL_L0 + 36, "the F rows and L0 lie together");
constexpr int SL_OBS = SL_F;              // (OBS) the observation of the state before the step
constexpr int SL_DONE = SL_F + DEAD - 1;  // the step's done flag
constexpr bool HID_DEAD = OBS + H_ROWS + 1 <= DEAD;
constexpr int SL_HID = HID_DEAD ? SL_OBS + OBS : SLOT;  // (H) the MLP's hidden units
constexpr int ROWS = SLOT + (HID_DEAD ? 0 : H_ROWS);
static_assert(OBS + 1 <= DEAD, "the observation and the done flag fit the dead rows");
static_assert(ROWS == JX_RR_ROWS, "the generated header sizes an env's rows as this layout does");
constexpr size_t K5_SMEM_BYTES = (static_cast<size_t>(ROWS) * ES + N_PARAMS + WSZ) * sizeof(float);

// Entry k of the slot's rows from j0 on.
struct SlotRow {
  Slot sl;
  int j0;
  __device__ __forceinline__ float operator()(int k) const { return sl[j0 + k]; }
};

// The linear or MLP policy's torques of the observation in the env's slot
// `sl`, into its torque row, each row whole on one lane (row j on lane
// j % G). Every lane of the block calls it.
__device__ void policy(const float* Wt, const Options& o, Slot sl, int g) {
#if JX_POLICY == 1
  const float* W = Wt;
  const float* bias = Wt + NJ * OBS;
  for (int a = g; a < NJ; a += G) sl[SL_TAU + a] = clip_tau(affine_row<OBS>(bias[a], W + a * OBS, SlotRow{sl, SL_OBS}), o);
#elif JX_POLICY == 2
  const float* W1 = Wt;
  const float* b1 = W1 + H * OBS;
  const float* W2 = b1 + H;
  const float* b2 = W2 + NJ * H;
  for (int j = g; j < H; j += G) sl[SL_HID + j] = tanhf(affine_row<OBS>(b1[j], W1 + j * OBS, SlotRow{sl, SL_OBS}));
  __syncwarp();
  for (int a = g; a < NJ; a += G)
    sl[SL_TAU + a] = clip_tau(affine_row<H>(b2[a], W2 + a * H, SlotRow{sl, SL_HID}), o);
#else
  (void)Wt;
  (void)o;
  (void)sl;
  (void)g;
#endif
}

__global__ void __launch_bounds__(RR_THREADS, 1)
    env_rollout_rr_kernel(const float* __restrict__ params, const float* __restrict__ weights, StateIn in,
                          StateOut out, float* __restrict__ reward_out, int* __restrict__ resets_out,
                          int* __restrict__ steps_out, int B, int n_steps, Scalars sc, Options o, DomainRows dr) {
  extern __shared__ float smem[];
  float* P = smem;
  float* Wt = smem + N_PARAMS;
  float* slots = smem + N_PARAMS + WSZ;
  load_params(params, P);
  if (WSZ > 0) {
    const int candidate = (blockIdx.x * ENVS) / o.envs_per_candidate;
    const float* src = weights + static_cast<size_t>(candidate) * WSZ;
    for (int k = threadIdx.x; k < WSZ; k += blockDim.x) Wt[k] = src[k];
  }
  // Lane g of env threadIdx.x / G holds its share of the env's state and the
  // m rows of its point slots. The envs past B run env B - 1's steps beside
  // the others, so that every lane of a warp takes part in its shuffles, and
  // store nothing.
  const int e = threadIdx.x / G, g = threadIdx.x % G;
  const int b = blockIdx.x * ENVS + e, bl = b < B ? b : B - 1;
  const Slot sl{slots + e};

  int pt[OWN];
  float m[OWN * 3];
  rr_points(g, pt);
  rr_load_m(in.m, B, bl, pt, m);
  RrLane st;
  rr_load_lane(in, B, bl, g, sl, st);
  const EnvDomain dom = rr_load_domain(dr, B, bl);
  __syncthreads();

  int steps = 0, resets = 0;
  float reward_sum = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    // 1. The torques of the state before the step, into the torque row.
#pragma unroll
    for (int lev = 0; lev < NLEV; ++lev)
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        const int i = rr_link(lev, r, g), k = i - 1, j = lev * ROUNDS + r;
        if (i < 0) continue;
#if JX_POLICY == 0
        sl[SL_TAU + k] = -sc.kp * st.s[j] - sc.kd * st.sd[j];
#else
        sl[SL_OBS + k] = st.s[j];
        sl[SL_OBS + NJ + k] = st.sd[j];
#endif
      }
#if JX_POLICY != 0
    if (g == 0) {
#pragma unroll
      for (int k = 0; k < 10; ++k) sl[SL_OBS + 2 * NJ + k] = sl[rr_base_at(3 + k)];  // q, v
      sl[SL_OBS + 2 * NJ + 10] = rr_base_height(P, sl, dom);
    }
    __syncwarp();  // the observation is in
    policy(Wt, o, sl, g);
#endif
    __syncwarp();  // the torques are in

    // 2. The step.
    rr_step_env(P, sc, sl, g, st, m, SlotTauRr{sl}, dom);

    // 3. The episode's end, the reward and the base's respawn, on lane 0; the
    // lanes re-read their joints' and m rows on the flag it leaves.
    if (g == 0) {
      const int steps1 = steps + 1;
      const float pz = sl[rr_base_at(2)], z = rr_base_height(P, sl, dom);
      // The JAX kernel's comparisons: a NaN height ends no episode.
      const bool done = (z < o.z_lo) || (z > o.z_hi) || (steps1 >= o.episode_length);
      float ctrl = 0.0f;
      for (int k = 0; k < NJ; ++k) {
        const float tk = sl[SL_TAU + k];
        ctrl = k ? mac(ctrl, tk, tk) : __fmul_rn(tk, tk);
      }
      const float upright = pz > 2.0f ? 2.0f : pz;  // jnp.minimum: a NaN passes through
      reward_sum = __fadd_rn(reward_sum, __fsub_rn(upright, __fmul_rn(0.001f, ctrl)));
      resets += done;
      steps = done ? 0 : steps1;
      sl[SL_DONE] = done ? 1.0f : 0.0f;
    }
    __syncwarp();
    if (sl[SL_DONE] != 0.0f) {
      rr_load_lane(in, B, bl, g, sl, st);
      if (g == 0 && o.noise_half > 0.0f) {
        for (int r = 0; r < 3; ++r) {
          const unsigned bits = philox_word0(o.seed, bl, t, r);
          const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
          sl[rr_base_at(r)] = __fadd_rn(sl[rr_base_at(r)], __fmul_rn(o.noise_half, 2.0f * u - 1.0f));
        }
      }
      rr_step_points(g, pt);
      rr_load_m(in.m, B, bl, pt, m);
    }
  }

  if (b < B) {
    rr_step_points(g, pt);
    rr_store_m(out.m, B, b, pt, m);
    rr_store_lane(out, B, b, g, sl, st);
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

int jx_env_rollout_rr(const float* params, const float* s, const float* sd, const float* p, const float* q,
                      const float* v, const float* m, const float* weights, float* s_out, float* sd_out,
                      float* p_out, float* q_out, float* v_out, float* m_out, float* reward_out, int* resets_out,
                      int* steps_out, int B, int n_steps, float K, float D, float k_over_d, float mu, float hc_p,
                      float hc_q, float gz, float dt, float kp, float kd, float rr_ca, float rr_cb, float rr_mid,
                      float rr_power, float rr_width, float rr_dmin, float rr_dmax, float rr_span, float rr_stiff,
                      float rr_damp, float rr_c2mu2, float rr_c1mu2, float rr_reg, int episode_length, float z_lo,
                      float z_hi, int clip, float tau_limit, float noise_half, unsigned seed, int envs_per_candidate,
                      const float* domain, const float* terr_off, void* stream) {
  const Scalars sc{K,        D,       k_over_d, mu,       hc_p,     hc_q,    gz,
                   dt,       kp,      kd,       rr_ca,    rr_cb,    rr_mid,  rr_power,
                   rr_width, rr_dmin, rr_dmax,  rr_span,  rr_stiff, rr_damp, rr_c2mu2,
                   rr_c1mu2, rr_reg};
  const Options o{episode_length, z_lo, z_hi, clip, tau_limit, noise_half, seed, envs_per_candidate};
  const cudaError_t rc = cudaFuncSetAttribute(env_rollout_rr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(K5_SMEM_BYTES));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int blocks = (B + ENVS - 1) / ENVS;
  env_rollout_rr_kernel<<<blocks, RR_THREADS, K5_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      params, weights, StateIn{s, sd, p, q, v, m}, StateOut{s_out, sd_out, p_out, q_out, v_out, m_out}, reward_out,
      resets_out, steps_out, B, n_steps, sc, o, DomainRows{domain, terr_off});
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry, for the reports: threads a block, envs a block,
// dynamic shared memory a block in bytes, and blocks an SM holds at once
// (the occupancy calculator: registers, threads and shared memory).
int jx_env_rr_geometry(int* out) {
  cudaError_t rc = cudaFuncSetAttribute(env_rollout_rr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(K5_SMEM_BYTES));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks_per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, env_rollout_rr_kernel, RR_THREADS,
                                                     K5_SMEM_BYTES);
  out[0] = RR_THREADS;
  out[1] = ENVS;
  out[2] = static_cast<int>(K5_SMEM_BYTES);
  out[3] = blocks_per_sm;
  return static_cast<int>(rc);
}

const char* jx_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
