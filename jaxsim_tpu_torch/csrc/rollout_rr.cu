// Whole-horizon rollout of the batched engine with relaxed-rigid contacts:
// each env on JX_RR_LANES lanes of a warp, the contact solve's working set in
// shared memory.
//
// Replaces jaxsim_tpu/ops/pallas_step.py::_rollout_kernel (built by
// build_pallas_rollout) for relaxed-rigid engines: flat ground, an inclined
// plane or Fourier terrain (JX_TERRAIN; on Fourier terrain each point's own
// normal and the block-Jacobi PCG on the nominal Delassus blocks rrKc), the
// three-pass articulated-body algorithm with the 6x6 base Cholesky, the
// matrix-free PCG of JX_RR_ITERS iterations warm-started from the forces the
// state's m carries, the engine's integrator (JX_INTEGRATOR: semi-implicit
// Euler, RK4, or RK4-fast with the contact forces frozen at the step's
// start; the RK4 builds on flat ground only), and the PD policy tau = -kp*s -
// kd*sd, evaluated once a step at its start. A semi-implicit Euler build
// takes the JAX kernel's per-env options: the multiplier rows (JX_DOMAIN, of
// which the relaxed-rigid step reads gmul and Mmul) and the terrain offset
// (JX_TERR_OFF), each env's loaded once a launch into its lanes' registers
// (rr_load_domain). Each env advances n_steps inside one launch. Launched for one step
// it is also the relaxed-rigid K2 (_step_kernel under the PD policy,
// cuda_step.step_pd). The step is rr_step_env, or rr_rk4_step (rr_step.cuh),
// which the relaxed-rigid K3 (step_rr.cu) and env rollout
// (env_rollout_rr.cu) share; so do the state's loads and stores
// (rr_load_lane, rr_load_m, ...). An RK4
// step is four such solves (RK4-fast: one solve and four ABAs with the
// frozen forces); its start state and accumulator live in device memory
// (Rk4Scratch).
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
// registers of the env's lanes, and the passes run across the lanes (0.025
// ms a pass on an H100). The free ABA runs on the same lanes, level by level,
// what a link hands to the next level passed by warp shuffles from its lane's
// registers (see rr_step.cuh); the state is dealt to the lanes that update
// it. An env's step touches only its own warp; one block barrier a step,
// after the free ABA, keeps the block's warps in one phase, which the card
// runs faster than warps spread over the ABA's and the solve's code.

#include "rr_step.cuh"

namespace {

__global__ void __launch_bounds__(RR_THREADS, 1) rollout_rr_kernel(
    const float* __restrict__ params, StateIn in, StateOut out, int B, int n_steps, Scalars sc, Rk4Scratch rk,
    DomainRows dr) {
  extern __shared__ float smem[];
  float* P = smem;
  load_params(params, P);
  __syncthreads();

  // Lane g of env threadIdx.x / G holds its share of the env's state
  // (RrLane) and the m rows of its point slots. The envs past B run env
  // B - 1's steps beside the others, so that every lane of a warp takes part
  // in its shuffles, and store nothing.
  const int e = threadIdx.x / G, g = threadIdx.x % G;
  const int b = blockIdx.x * ENVS + e, bl = b < B ? b : B - 1;
  const Slot sl{smem + N_PARAMS + e};

  int pt[OWN];
  float m[OWN * 3];
  rr_points(g, pt);
  rr_load_m(in.m, B, bl, pt, m);
  RrLane st;
  rr_load_lane(in, B, bl, g, sl, st);

  if constexpr (INTEGRATOR == 0) {
    const EnvDomain dom = rr_load_domain(dr, B, bl);
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) rr_step_env(P, sc, sl, g, st, m, RrPdTau{sc.kp, sc.kd}, dom);
  } else {
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) rr_rk4_step<INTEGRATOR>(P, sc, sl, g, st, m, rk, b);
  }

  if (b < B) {
    rr_step_points(g, pt);
    rr_store_m(out.m, B, b, pt, m);
    rr_store_lane(out, B, b, g, sl, st);
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
                  float rr_stiff, float rr_damp, float rr_c2mu2, float rr_c1mu2, float rr_reg, float* rk4_y0,
                  float* rk4_acc, int rk4_stride, const float* domain, const float* terr_off, void* stream) {
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
      sc, Rk4Scratch{rk4_y0, rk4_acc, rk4_stride}, DomainRows{domain, terr_off});
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
