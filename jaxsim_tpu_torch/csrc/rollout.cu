// Whole-horizon rollout of the batched engine with soft contacts: one CUDA
// thread per env.
//
// Replaces jaxsim_tpu/ops/pallas_step.py::_rollout_kernel (built by
// build_pallas_rollout) for Hunt/Crossley soft contacts on flat ground, with
// the three-pass articulated-body algorithm and the 6x6 base Cholesky,
// semi-implicit Euler, and the PD policy tau = -kp*s - kd*sd. Each env
// advances n_steps inside one launch; the state crosses device memory once on
// the way in and once on the way out. The step itself is step_env
// (step_env.cuh), shared with the one-step and env-rollout kernels. The
// relaxed-rigid rollout is rollout_rr.cu.
//
// What bounds it on the card: per-thread latency and local-memory traffic,
// not HBM. The humanoid's state is 6.6 MB for 8192 envs and is read and
// written once per 1000 steps, while every step walks a 24-link tree whose
// per-link working set (rotations, velocities, articulated inertias: about
// 2.7 k floats per env) cannot live in the 255 registers a thread may hold,
// so it lives in local memory, cached by L1 and L2. The design's answers
// (compile-time topology, model arrays in shared memory, trailing-batch
// layout, IEEE float32) are listed at the top of step_env.cuh.
//
// One thread per env leaves the card mostly idle at the flagship batch
// (8192 threads = 256 warps over 132 SMs); spreading one env over a warp is
// the first target of later performance work.

#include "step_env.cuh"

static_assert(!RELAXED, "rollout.cu is the soft-contact rollout; relaxed-rigid engines build rollout_rr.cu");

namespace {

// The state lives in separate per-leaf arrays, not in an Env struct: for
// sm_90a the struct gives this kernel a 10,920-B frame instead of 10,864 B
// and 406 local loads in its SASS instead of 289.
__global__ void __launch_bounds__(BLOCK) rollout_kernel(
    const float* __restrict__ params, const float* __restrict__ s_in,
    const float* __restrict__ sd_in, const float* __restrict__ p_in,
    const float* __restrict__ q_in, const float* __restrict__ v_in,
    const float* __restrict__ m_in, float* __restrict__ s_out, float* __restrict__ sd_out,
    float* __restrict__ p_out, float* __restrict__ q_out, float* __restrict__ v_out,
    float* __restrict__ m_out, int B, int n_steps, Scalars sc) {
  __shared__ float P[N_PARAMS];
  load_params(params, P);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float s[NJA], sd[NJA], p[3], q[4], v[6], m[NCM * 3];
  for (int k = 0; k < NJ; ++k) {
    s[k] = s_in[k * B + b];
    sd[k] = sd_in[k * B + b];
  }
  for (int k = 0; k < 3; ++k) p[k] = p_in[k * B + b];
  for (int k = 0; k < 4; ++k) q[k] = q_in[k * B + b];
  for (int k = 0; k < 6; ++k) v[k] = v_in[k * B + b];
  for (int k = 0; k < NCM * 3; ++k) m[k] = m_in[k * B + b];

  Work w;
  for (int t = 0; t < n_steps; ++t) step_env(P, sc, w, s, sd, p, q, v, m, PdTau{});

  for (int k = 0; k < NJ; ++k) {
    s_out[k * B + b] = s[k];
    sd_out[k * B + b] = sd[k];
  }
  for (int k = 0; k < 3; ++k) p_out[k * B + b] = p[k];
  for (int k = 0; k < 4; ++k) q_out[k * B + b] = q[k];
  for (int k = 0; k < 6; ++k) v_out[k * B + b] = v[k];
  for (int k = 0; k < NCM * 3; ++k) m_out[k * B + b] = m[k];
}

}  // namespace

extern "C" {

int jx_param_count() { return N_PARAMS; }

int jx_rollout(const float* params, const float* s, const float* sd, const float* p,
               const float* q, const float* v, const float* m, float* s_out, float* sd_out,
               float* p_out, float* q_out, float* v_out, float* m_out, int B, int n_steps,
               float K, float D, float k_over_d, float mu, float hc_p, float hc_q, float gz,
               float dt, float kp, float kd, void* stream) {
  const Scalars sc{K, D, k_over_d, mu, hc_p, hc_q, gz, dt, kp, kd};
  const int blocks = (B + BLOCK - 1) / BLOCK;
  rollout_kernel<<<blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      params, s, sd, p, q, v, m, s_out, sd_out, p_out, q_out, v_out, m_out, B, n_steps, sc);
  return static_cast<int>(cudaGetLastError());
}

const char* jx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
