// Whole-horizon rollout of the batched engine with soft contacts: each env on
// JX_LN_LANES lanes of a warp, its state and the step's working set in a
// slot of shared memory for the whole horizon.
//
// Replaces jaxsim_tpu/ops/pallas_step.py::_rollout_kernel (built by
// build_pallas_rollout) for Hunt/Crossley soft contacts on flat ground, with
// the three-pass articulated-body algorithm and the 6x6 base Cholesky, the
// engine's integrator (JX_INTEGRATOR: semi-implicit Euler, RK4, or RK4-fast,
// whose contact forces and m's rate are frozen at the step's start), and the
// PD policy tau = -kp*s - kd*sd. Each env advances n_steps inside one launch;
// the state crosses device memory once on the way in and once on the way
// out. The step is soft_step_lanes (soft_step_lanes.cuh) on the forward-only
// slot (JX_LN_FORWARD), which reads the state from the slot and writes the
// new state back there, or under RK4 the stage state's rate. The
// relaxed-rigid rollout is rollout_rr.cu.
//
// What bounds it on the card: latency, not HBM (the humanoid's state is
// 6.6 MB for 8192 envs, read and written once a launch). One thread an env
// (the earlier design) kept a 24-link tree's working set in a
// 10,864-B local-memory frame, with 8192 threads as 1.94 warps an SM: each
// thread walked a long chain of dependent local loads, and 1000 steps took
// 241 ms on an H100.
//
// What this design does about it: the tree passes run a level at a time
// across an env's lanes (7 levels, not 23 links, in sequence for the
// humanoid) and the contact points across the lanes, on a working set in
// shared memory; the slot keeps only what the forward step reads (about
// 1.6 k floats an env for the humanoid, against K4's 2.8 k), so a block of
// JX_LN_ENVS envs (32 for the humanoid) and the model arrays, loaded once a
// block, fit in one SM's shared memory. A block runs every step of its envs,
// so the grid's waves are whole horizons: 32 envs an SM put 8192 envs in two
// waves on 132 SMs.
//
// RK4 (the twin's _rk4_step): four rates of the step a step, from one torque
// per joint that the env's lanes write into the slot's torque row at the
// step's start (the policy is evaluated once a step, at the start, as the
// JAX rollout kernel evaluates it). The step's start state y0 and the
// accumulator k1 + 2 k2 + 2 k3 + k4 do not fit beside 32 slots in a block's
// shared memory (two more copies of the humanoid's 203-float state), so they
// live in the registers of the env's lanes: lane g holds the state's entries
// g, g + G, ... (RK_N of them, 51 for the humanoid), which it alone reads
// and writes between the rates. Between the rates, each lane forms its
// entries' next stage state y0 + c dt k in the slot's state rows, which the
// next rate reads.

#include "soft_step_lanes.cuh"

static_assert(FORWARD, "rollout.cu takes the forward-only slot (JX_LN_FORWARD 1)");

namespace {

// The state's entries a lane holds through an RK4 step: lane g's j-th is
// entry g + G j (past ST_N on the last lanes, none).
constexpr int RK_N = (ST_N + G - 1) / G;

constexpr size_t K1_SMEM_BYTES = (static_cast<size_t>(N_PARAMS) + static_cast<size_t>(SLOT) * ES) * sizeof(float);

// n_steps RK4 (INTEGRATOR 1) or RK4-fast (2) steps of the env on lanes g of
// the slot `sl`, whose state rows hold the state.
__device__ __forceinline__ void rk4_steps(const float* P, const Scalars& sc, Slot sl, int g, const EnvState<float>& x,
                                          int n_steps) {
  float* st = sl.base + SL_ST * ES;  // the state's entry e at st[e * ES]
  float* const mine = st + g * ES;   // the lane's j-th entry at mine[j * G * ES]
  const ColTau tau{{st + ST_TAU * ES, ES}};
  const float dt = sc.dt;
  float y0[RK_N], acc[RK_N];  // the lane's entries of y0 and of the sum
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    if (g == 0) quat_normalize(x.q);
    ln_sync();
#pragma unroll
    for (int j = 0; j < RK_N; ++j)
      if (g + G * j < ST_N) y0[j] = mine[j * G * ES];
    for (int k = g; k < NJ; k += G) st[(ST_TAU + k) * ES] = -sc.kp * x.s[k] - sc.kd * x.sd[k];
    ln_sync();
#pragma unroll 1
    for (int stage = 0; stage < 4; ++stage) {
      if (INTEGRATOR == 2 && stage > 0) {
        soft_step_lanes<STEP_RATE_FROZEN>(P, sc, sl, g, x, tau, nullptr);
      } else {
        soft_step_lanes<STEP_RATE>(P, sc, sl, g, x, tau, nullptr);
      }
      ln_sync();
      // The lane's entries after stage S, its rates in their rows: one loop
      // for each stage, so that rk4_entry's weights and its division by 6
      // fold to the stage's own.
      const auto update = [&](auto s) {
        constexpr int S = decltype(s)::value;
#pragma unroll
        for (int j = 0; j < RK_N; ++j) {
          const int e = g + G * j;
          if (e < ST_N) {
            const float y = rk4_entry(S, dt, mine[j * G * ES], y0[j], acc[j]);
            // RK4-fast: m's rows keep the rate of the step's start through
            // the stages (a frozen rate reads no stage state).
            if (INTEGRATOR != 2 || e < ST_M || S == 3) mine[j * G * ES] = y;
          }
        }
      };
      if (stage == 0) {
        update(std::integral_constant<int, 0>{});
      } else if (stage == 1) {
        update(std::integral_constant<int, 1>{});
      } else if (stage == 2) {
        update(std::integral_constant<int, 2>{});
      } else {
        update(std::integral_constant<int, 3>{});
      }
      ln_sync();
    }
    if (g == 0) quat_normalize(x.q);
    ln_sync();
  }
}

__global__ void __launch_bounds__(LN_THREADS, 1) rollout_kernel(const float* __restrict__ params, StateIn in,
                                                                 StateOut out, int B, int n_steps, Scalars sc) {
  extern __shared__ float smem[];
  float* P = smem;
  load_params(params, P);
  // Env e of the block on lanes e*G .. e*G + G-1; an env past the batch runs
  // env B - 1's steps beside the others, so that every lane reaches every
  // barrier and shuffle, and stores nothing.
  const int e = threadIdx.x / G, g = threadIdx.x % G;
  const int b0 = blockIdx.x * ENVS + e;
  const bool valid = b0 < B;
  const int b = valid ? b0 : B - 1;
  const Slot sl{smem + N_PARAMS + e};
  const EnvState<float> x = slot_state(sl);
  load_state(in, B, b, x, g);
  __syncthreads();

  if constexpr (INTEGRATOR == 0) {
    const SlotPd tau{x.s, x.sd, sc.kp, sc.kd};
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) {
      soft_step_lanes(P, sc, sl, g, x, tau, nullptr);
      ln_sync();
    }
  } else {
    rk4_steps(P, sc, sl, g, x, n_steps);
  }
  if (valid) store_state(x, B, b, out, g);
}

}  // namespace

extern "C" {

int jx_param_count() { return N_PARAMS; }

int jx_rollout(const float* params, const float* s, const float* sd, const float* p, const float* q, const float* v,
               const float* m, float* s_out, float* sd_out, float* p_out, float* q_out, float* v_out, float* m_out,
               int B, int n_steps, float K, float D, float k_over_d, float mu, float hc_p, float hc_q, float gz,
               float dt, float kp, float kd, void* stream) {
  const Scalars sc{K, D, k_over_d, mu, hc_p, hc_q, gz, dt, kp, kd};
  const cudaError_t rc = cudaFuncSetAttribute(rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(K1_SMEM_BYTES));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int blocks = (B + ENVS - 1) / ENVS;
  rollout_kernel<<<blocks, LN_THREADS, K1_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      params, StateIn{s, sd, p, q, v, m}, StateOut{s_out, sd_out, p_out, q_out, v_out, m_out}, B, n_steps, sc);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry, for the reports: threads a block, envs a block,
// dynamic shared memory a block in bytes, and blocks an SM holds at once
// (the occupancy calculator: registers, threads and shared memory).
int jx_rollout_geometry(int* out) {
  cudaError_t rc = cudaFuncSetAttribute(rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(K1_SMEM_BYTES));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks_per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, rollout_kernel, LN_THREADS, K1_SMEM_BYTES);
  out[0] = LN_THREADS;
  out[1] = ENVS;
  out[2] = static_cast<int>(K1_SMEM_BYTES);
  out[3] = blocks_per_sm;
  return static_cast<int>(rc);
}

const char* jx_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
