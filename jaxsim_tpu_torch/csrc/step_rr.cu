// One relaxed-rigid step of the batched engine per launch with the torques as
// an input (K3): each env on JX_RR_LANES lanes of a warp, the contact solve's
// working set in its slot of shared memory, the state in from device columns
// and out to device columns.
//
// Replaces, for relaxed-rigid engines, _step_tau_kernel of
// jaxsim_tpu/ops/pallas_step.py (built by build_pallas_step_tau, K3): one
// step with the torques as an input and the model arrays as call-time inputs
// (the JAX `pr`, rrMinv included, and on Fourier terrain rrKc), so new arrays
// need no rebuild; flat ground, an inclined plane or Fourier terrain
// (JX_TERRAIN), without per-env rows, as the JAX kernel. The
// wrapper packs `pr` into the same buffer layout the other kernels read.
// Its relaxed-rigid sibling K2 (_step_kernel, one step under the PD policy)
// needs no source of its own: it is K1-rr (rollout_rr.cu) launched for one
// step, on the same geometry, with the same loads and stores.
//
// step_tau_rr_kernel runs K1-rr's step (rr_step_env, rr_step.cuh) once, on
// K1-rr's launch geometry, the state loaded into the lanes that hold it
// between steps (each lane s and sd of its links' joints, lane 0 p, q, v, and
// each lane the m rows of its point slots: rr_load_lane, rr_load_m) and
// stored back from them. Each lane copies its joints' torques from their
// device columns into the env's torque row of the slot before the step
// (SlotTauRr), where its links' pass 2 reads them.
//
// What bounds a one-step launch on the card: the step. A relaxed-rigid
// humanoid step takes about 0.44 ms on an H100 inside K1-rr (one free ABA
// and 1 + JX_RR_ITERS + 1 M^-1 J^T applications across the env's lanes; see
// rr_step.cuh and rollout_rr.cu); the state crosses device memory once each
// way, 6.6 MB in and out for the humanoid at 8192
// envs, about 4 us at 3.35 TB/s, and the torques 0.75 MB. So a launch keeps
// K1-rr's geometry (64 envs a block: 8192 envs in one wave of 128 blocks)
// and moves its state as K1-rr does, one lane a column entry; the soft
// one-step kernels' block-wide staging (step.cu) would buy a few
// microseconds of a launch of about 0.45 ms.

#include "rr_step.cuh"

static_assert(INTEGRATOR == 0, "step_rr.cu implements semi-implicit Euler (JX_INTEGRATOR 0)");
static_assert(JX_RR_TAU_ROW, "step_rr.cu takes K3's torques in the slot's torque row (JX_RR_TAU_ROW 1)");
static_assert(!DOMAIN && !TERR_OFF, "step_rr.cu takes no per-env rows");

namespace {

// One step of the block's envs: lane g of env threadIdx.x / G holds its
// share of the env's state and the m rows of its point slots, the torques
// tau_in's columns. The envs past B run env B - 1's step beside the others,
// so that every lane of a warp takes part in its shuffles, and store
// nothing.
__global__ void __launch_bounds__(RR_THREADS, 1)
    step_tau_rr_kernel(const float* __restrict__ params, StateIn in, const float* __restrict__ tau_in,
                       StateOut out, int B, Scalars sc) {
  extern __shared__ float smem[];
  float* P = smem;
  load_params(params, P);
  const int e = threadIdx.x / G, g = threadIdx.x % G;
  const int b = blockIdx.x * ENVS + e, bl = b < B ? b : B - 1;
  const Slot sl{smem + N_PARAMS + e};

  int pt[OWN];
  float m[OWN * 3];
  rr_points(g, pt);
  rr_load_m(in.m, B, bl, pt, m);
  RrLane st;
  rr_load_lane(in, B, bl, g, sl, st);
#pragma unroll
  for (int lev = 0; lev < NLEV; ++lev)
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int i = rr_link(lev, r, g);
      if (i >= 0) sl[SL_TAU + i - 1] = __ldg(tau_in + (i - 1) * B + bl);
    }
  __syncthreads();

  rr_step_env(P, sc, sl, g, st, m, SlotTauRr{sl}, EnvDomain{1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 0.0f, 0.0f});

  if (b < B) {
    rr_step_points(g, pt);
    rr_store_m(out.m, B, b, pt, m);
    rr_store_lane(out, B, b, g, sl, st);
  }
}

}  // namespace

extern "C" {

// Opts the kernel in to RR_SMEM_BYTES of dynamic shared memory, at each
// launch as K1-rr and K5 do (soft K3 sets it once, beside its 0.08-ms
// launches).
static int allow_smem(const void* kernel) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(RR_SMEM_BYTES)));
}

int jx_param_count() { return N_PARAMS; }

int jx_step_tau_rr(const float* params, const float* s, const float* sd, const float* p, const float* q,
                   const float* v, const float* m, const float* tau, float* s_out, float* sd_out, float* p_out,
                   float* q_out, float* v_out, float* m_out, int B, float K, float D, float k_over_d, float mu,
                   float hc_p, float hc_q, float gz, float dt, float rr_ca, float rr_cb, float rr_mid,
                   float rr_power, float rr_width, float rr_dmin, float rr_dmax, float rr_span, float rr_stiff,
                   float rr_damp, float rr_c2mu2, float rr_c1mu2, float rr_reg, void* stream) {
  const Scalars sc{K,        D,       k_over_d, mu,       hc_p,     hc_q,    gz,
                   dt,       0.0f,    0.0f,     rr_ca,    rr_cb,    rr_mid,  rr_power,
                   rr_width, rr_dmin, rr_dmax,  rr_span,  rr_stiff, rr_damp, rr_c2mu2,
                   rr_c1mu2, rr_reg};
  const int rc = allow_smem(reinterpret_cast<const void*>(step_tau_rr_kernel));
  if (rc != 0) return rc;
  const int blocks = (B + ENVS - 1) / ENVS;
  step_tau_rr_kernel<<<blocks, RR_THREADS, RR_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      params, StateIn{s, sd, p, q, v, m}, tau, StateOut{s_out, sd_out, p_out, q_out, v_out, m_out}, B, sc);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry, for the reports: threads a block, envs a block,
// dynamic shared memory a block in bytes, and blocks an SM holds at once
// (the occupancy calculator: registers, threads and shared memory).
int jx_step_rr_geometry(int* out) {
  const int rc = allow_smem(reinterpret_cast<const void*>(step_tau_rr_kernel));
  if (rc != 0) return rc;
  int blocks_per_sm = 0;
  const cudaError_t occ =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, step_tau_rr_kernel, RR_THREADS, RR_SMEM_BYTES);
  out[0] = RR_THREADS;
  out[1] = ENVS;
  out[2] = static_cast<int>(RR_SMEM_BYTES);
  out[3] = blocks_per_sm;
  return static_cast<int>(occ);
}

const char* jx_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
