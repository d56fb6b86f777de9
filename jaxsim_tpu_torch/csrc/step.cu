// One step of the batched engine per launch: one CUDA thread per env.
//
// Replaces two kernels of jaxsim_tpu/ops/pallas_step.py:
//  * _step_kernel (built by build_pallas_step, K2): one step under a policy
//    compiled into the kernel. PD, tau = -kp*s - kd*sd, is the JAX default
//    closure and the one policy expressed here: step_pd_kernel.
//  * _step_tau_kernel (built by build_pallas_step_tau, K3): one step with
//    the torques as an input and the model arrays as call-time inputs (the
//    JAX `pr`), so new arrays need no rebuild: step_tau_kernel. The wrapper
//    packs `pr` into the same buffer layout the other kernels read.
// The step is step_env (step_env.cuh), one thread an env.
//
// What bounds it on the card: per-thread latency (a 10.9-kB local-memory
// frame of dependent loads a step, as the soft rollout had before it moved
// to lanes), paid once per launch, plus the launch itself. The
// state crosses device memory twice a step (13.3 MB for the humanoid at 8192
// envs, about 4 us at 3.35 TB/s), far below the step's arithmetic latency,
// so the design is the rollout kernel's with n_steps = 1: one thread per
// env, the model arrays in shared memory, the batch trailing so the state's
// loads and stores coalesce across the warp.

#include "step_env.cuh"

namespace {

__global__ void __launch_bounds__(BLOCK)
    step_pd_kernel(const float* __restrict__ params, StateIn in, StateOut out, int B,
                   Scalars sc) {
  __shared__ float P[N_PARAMS];
  load_params(params, P);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Env e;
  load_env(in, B, b, e);
  Work w;
  step_env(P, sc, w, e.s, e.sd, e.p, e.q, e.v, e.m, PdTau{});
  store_env(e, B, b, out);
}

__global__ void __launch_bounds__(BLOCK)
    step_tau_kernel(const float* __restrict__ params, StateIn in,
                    const float* __restrict__ tau_in, StateOut out, int B, Scalars sc) {
  __shared__ float P[N_PARAMS];
  load_params(params, P);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Env e;
  load_env(in, B, b, e);
  float tau[NJA];
  for (int k = 0; k < NJ; ++k) tau[k] = tau_in[k * B + b];
  Work w;
  step_env(P, sc, w, e.s, e.sd, e.p, e.q, e.v, e.m, ArrayTau{tau});
  store_env(e, B, b, out);
}

}  // namespace

extern "C" {

int jx_param_count() { return N_PARAMS; }

int jx_step_pd(const float* params, const float* s, const float* sd, const float* p,
               const float* q, const float* v, const float* m, float* s_out, float* sd_out,
               float* p_out, float* q_out, float* v_out, float* m_out, int B, float K, float D,
               float k_over_d, float mu, float hc_p, float hc_q, float gz, float dt, float kp,
               float kd, void* stream) {
  const Scalars sc{K, D, k_over_d, mu, hc_p, hc_q, gz, dt, kp, kd};
  const int blocks = (B + BLOCK - 1) / BLOCK;
  step_pd_kernel<<<blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      params, StateIn{s, sd, p, q, v, m}, StateOut{s_out, sd_out, p_out, q_out, v_out, m_out},
      B, sc);
  return static_cast<int>(cudaGetLastError());
}

int jx_step_tau(const float* params, const float* s, const float* sd, const float* p,
                const float* q, const float* v, const float* m, const float* tau, float* s_out,
                float* sd_out, float* p_out, float* q_out, float* v_out, float* m_out, int B,
                float K, float D, float k_over_d, float mu, float hc_p, float hc_q, float gz,
                float dt, void* stream) {
  const Scalars sc{K, D, k_over_d, mu, hc_p, hc_q, gz, dt, 0.0f, 0.0f};
  const int blocks = (B + BLOCK - 1) / BLOCK;
  step_tau_kernel<<<blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      params, StateIn{s, sd, p, q, v, m}, tau,
      StateOut{s_out, sd_out, p_out, q_out, v_out, m_out}, B, sc);
  return static_cast<int>(cudaGetLastError());
}

const char* jx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
