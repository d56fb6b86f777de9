// Whole-horizon rollout of the batched engine with relaxed-rigid contacts:
// each env on JX_RR_LANES lanes of a warp, the contact solve's working set in
// shared memory.
//
// Replaces jaxsim_tpu/ops/pallas_step.py::_rollout_kernel (built by
// build_pallas_rollout) for relaxed-rigid engines: flat ground, the
// three-pass articulated-body algorithm with the 6x6 base Cholesky, the
// matrix-free PCG of JX_RR_ITERS iterations warm-started from the forces the
// state's m carries, semi-implicit Euler, and the PD policy
// tau = -kp*s - kd*sd. Each env advances n_steps inside one launch. The step
// is rr_step_env (rr_step.cuh), written for the relaxed-rigid variants of the
// one-step and env-rollout kernels to include too.
//
// What bounds it on the card: latency, not HBM (the state crosses device
// memory once each way a launch; the least operations of a humanoid step take
// under 1 ms of a 400-step launch at 8192 envs). A step is one free ABA and
// 1 + JX_RR_ITERS + 1 M^-1 J^T applications: a scatter over the points, the
// tree up and down, a gather. One thread an env keeping the whole working set
// in local memory needs a 15,968-B frame: 8192 x 15,968 B = 131 MB across the
// batch against 50 MB of L2, about 0.99 MB an SM against at most 256 KB of L1
// and shared memory, so each of the passes' dependent loads at topology
// offsets (the parent's force, U, d, the child -> parent pair, the parents'
// rotations) goes to L2, with 1.94 warps an SM at B = 8192 to hide it
// (0.295 ms a pass on an H100).
//
// What this design does about it. The passes' working set (per link U, d,
// iR, ip, u and a force/acceleration row; L0; the contact parents' rows:
// 3,216 B an env for the humanoid) lives in a slot of dynamic shared memory,
// 64 envs a block (209 KB with the model arrays' 9.7 KB for the humanoid), so
// the 8192 envs fit in one wave of 128 blocks; the point vectors live in the
// registers of the env's lanes, and the passes run across the lanes, while
// the free ABA runs one thread an env on the block's first warps (see
// rr_step.cuh): 0.025 ms a pass on an H100. What stays in local memory is
// the free ABA's working set (RrWork, once a step), now the larger part of a
// step, and, with one lane an env, the point vectors.

#include "rr_step.cuh"

namespace {

__global__ void __launch_bounds__(RR_THREADS, 1) rollout_rr_kernel(
    const float* __restrict__ params, StateIn in, StateOut out, int B, int n_steps, Scalars sc) {
  extern __shared__ float smem[];
  float* P = smem;
  load_params(params, P);
  __syncthreads();

  // Thread t < ENVS holds env t's s, sd, p, q and v (rr_step_env); lane g of
  // env threadIdx.x / G the m rows of its point slots. The envs past B run
  // env B - 1's step beside the others, so that every thread reaches every
  // barrier, and store nothing.
  const int b_aba = blockIdx.x * ENVS + threadIdx.x, b_pcg = blockIdx.x * ENVS + threadIdx.x / G;
  const bool aba = threadIdx.x < ENVS;
  const int g = threadIdx.x % G;

  int pt[OWN];
  float m[OWN * 3];
  {
    const int b = b_pcg < B ? b_pcg : B - 1;
#pragma unroll
    for (int k = 0; k < OWN; ++k) {
      pt[k] = JX_RR_SLOT_POINT[g + G * k];
#pragma unroll
      for (int j = 0; j < 3; ++j) m[k * 3 + j] = pt[k] >= 0 ? in.m[(pt[k] * 3 + j) * B + b] : 0.0f;
    }
  }
  float s[NJA], sd[NJA], p[3], q[4], v[6];
  if (aba) {
    const int b = b_aba < B ? b_aba : B - 1;
    for (int k = 0; k < NJ; ++k) {
      s[k] = in.s[k * B + b];
      sd[k] = in.sd[k * B + b];
    }
    for (int k = 0; k < 3; ++k) p[k] = in.p[k * B + b];
    for (int k = 0; k < 4; ++k) q[k] = in.q[k * B + b];
    for (int k = 0; k < 6; ++k) v[k] = in.v[k * B + b];
  }

  RrWork w;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) rr_step_env(P, sc, w, smem + N_PARAMS, pt, s, sd, p, q, v, m, PdTau{});

  if (b_pcg < B) {
#pragma unroll
    for (int k = 0; k < OWN; ++k)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (pt[k] >= 0) out.m[(pt[k] * 3 + j) * B + b_pcg] = m[k * 3 + j];
  }
  if (aba && b_aba < B) {
    for (int k = 0; k < NJ; ++k) {
      out.s[k * B + b_aba] = s[k];
      out.sd[k * B + b_aba] = sd[k];
    }
    for (int k = 0; k < 3; ++k) out.p[k * B + b_aba] = p[k];
    for (int k = 0; k < 4; ++k) out.q[k * B + b_aba] = q[k];
    for (int k = 0; k < 6; ++k) out.v[k * B + b_aba] = v[k];
  }
}

}  // namespace

extern "C" {

int jx_param_count() { return N_PARAMS; }

int jx_rollout_rr(const float* params, const float* s, const float* sd, const float* p, const float* q,
                  const float* v, const float* m, float* s_out, float* sd_out, float* p_out, float* q_out,
                  float* v_out, float* m_out, int B, int n_steps, float K, float D, float k_over_d, float mu,
                  float hc_p, float hc_q, float gz, float dt, float kp, float kd, float rr_ca, float rr_cb,
                  float rr_mid, float rr_power, float rr_width, float rr_dmin, float rr_dmax, float rr_span,
                  float rr_stiff, float rr_damp, float rr_c2mu2, float rr_c1mu2, float rr_reg, void* stream) {
  const Scalars sc{K,        D,       k_over_d, mu,       hc_p,     hc_q,    gz,
                   dt,       kp,      kd,       rr_ca,    rr_cb,    rr_mid,  rr_power,
                   rr_width, rr_dmin, rr_dmax,  rr_span,  rr_stiff, rr_damp, rr_c2mu2,
                   rr_c1mu2, rr_reg};
  const cudaError_t rc = cudaFuncSetAttribute(rollout_rr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(RR_SMEM_BYTES));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int blocks = (B + ENVS - 1) / ENVS;
  rollout_rr_kernel<<<blocks, RR_THREADS, RR_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      params, StateIn{s, sd, p, q, v, m}, StateOut{s_out, sd_out, p_out, q_out, v_out, m_out}, B, n_steps,
      sc);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry, for the reports: threads a block, envs a block,
// dynamic shared memory a block in bytes, and blocks an SM holds at once
// (the occupancy calculator: registers, threads and shared memory).
int jx_rr_geometry(int* out) {
  cudaError_t rc = cudaFuncSetAttribute(rollout_rr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(RR_SMEM_BYTES));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks_per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, rollout_rr_kernel, RR_THREADS, RR_SMEM_BYTES);
  out[0] = RR_THREADS;
  out[1] = ENVS;
  out[2] = static_cast<int>(RR_SMEM_BYTES);
  out[3] = blocks_per_sm;
  return static_cast<int>(rc);
}

const char* jx_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
