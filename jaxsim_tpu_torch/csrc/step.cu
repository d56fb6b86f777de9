// One step of the batched engine per launch (K2, K3): each env on
// JX_LN_LANES lanes of a warp, on the forward-only slot of the lane-spread
// soft step, the state in from device columns and out to device columns.
//
// Replaces two kernels of jaxsim_tpu/ops/pallas_step.py:
//  * _step_kernel (built by build_pallas_step, K2): one step under a policy
//    compiled into the kernel. PD, tau = -kp*s - kd*sd, is the JAX default
//    closure and the one policy expressed here: step_pd_kernel.
//  * _step_tau_kernel (built by build_pallas_step_tau, K3): one step with
//    the torques as an input and the model arrays as call-time inputs (the
//    JAX `pr`), so new arrays need no rebuild: step_tau_kernel. The wrapper
//    packs `pr` into the same buffer layout the other kernels read.
// Both take flat ground, an inclined plane or Fourier terrain (JX_TERRAIN:
// the lane step's contact law, the spectrum in the packed model arrays), and
// no per-env options, as the JAX kernels take none.
// Both run step_block, whose template argument picks the torque source: the
// soft rollout's kernel (rollout.cu) with one step, soft_step_lanes
// (soft_step_lanes.cuh) on the forward-only slot (JX_LN_FORWARD), which
// reads the state from the slot and writes the new state back there. K2's
// torques are the PD policy of the slot's state before the step (SlotPd);
// K3's are copied into a row of the env's slot beside its state (SlotTau).
//
// What bounds it on the card: latency. The state crosses device memory once
// each way (6.6 MB in and out for the humanoid at 8192 envs, about 4 us at
// 3.35 TB/s), and the step is a long chain of dependent shared-memory reads.
// One thread an env (the earlier design, a 10,864-B local-memory frame of
// dependent loads, 1.94 warps an SM) took 0.35 ms a humanoid step; the
// lanes put the tree passes a level at a time across an env's lanes, as in
// the rollouts. With one step a launch, the state's load and store are the
// block's own serial latency, which a rollout pays once a horizon: so the
// whole block moves them, row by row, a warp's loads covering consecutive
// envs of one row (coalesced), CHUNK loads in flight a thread before their
// stores to shared memory. The block's envs (JX_LN_ENVS, chosen by
// chip_probe.py step and sized by cuda_build.lane_tables) need not hold a
// horizon. The block loads the model arrays of the call into shared memory
// beside its slots (reading them from device memory through L1 instead,
// which leaves the shared memory to the slots, was slower: PERF.md §6).

#include <atomic>

#include "soft_step_lanes.cuh"

static_assert(FORWARD, "step.cu takes the forward-only slot (JX_LN_FORWARD 1)");
static_assert(INTEGRATOR == 0, "step.cu implements semi-implicit Euler (JX_INTEGRATOR 0)");
static_assert(!DOMAIN && !TERR_OFF, "step.cu takes no per-env options");

namespace {

// The model arrays' floats at the front of a block's shared memory.
constexpr int SMEM_PARAMS = N_PARAMS;
// An env's rows past the step's slot: its torques (K3's; K2 leaves them).
constexpr int SL_TAU = SLOT, ENV_ROWS = SLOT + NJ;
constexpr size_t STEP_SMEM_BYTES =
    (static_cast<size_t>(SMEM_PARAMS) + static_cast<size_t>(ENV_ROWS) * ES) * sizeof(float);
// The rows a launch moves between device memory and the block's slots: the
// state leaves in their device order (s, sd, p, q, v, m), then K3's tau.
constexpr int STATE_ROWS = 2 * NJ + 13 + 3 * NCM;
constexpr int CHUNK = 8;  // loads in flight a thread

// The device rows of a launch: the six state leaves, and K3's torques.
template <class T>
struct Leaves {
  T *s, *sd, *p, *q, *v, *m, *tau;
};

// Device row r's first entry, and its row j of the env's slot.
template <class T>
__device__ __forceinline__ T* device_row(const Leaves<T>& x, int r, int B, int& j) {
  if (r < NJ) return j = SL_ST + ST_S + r, x.s + r * B;
  if ((r -= NJ) < NJ) return j = SL_ST + ST_SD + r, x.sd + r * B;
  if ((r -= NJ) < 3) return j = SL_ST + ST_P + r, x.p + r * B;
  if ((r -= 3) < 4) return j = SL_ST + ST_Q + r, x.q + r * B;
  if ((r -= 4) < 6) return j = SL_ST + ST_V + r, x.v + r * B;
  if ((r -= 6) < 3 * NCM) return j = SL_ST + ST_M + r, x.m + r * B;
  r -= 3 * NCM;
  return j = SL_TAU + r, x.tau + r * B;
}

// The block's envs b0 .. b0 + ENVS - 1 from the first ROWS device rows into
// their slots (env e's slot row j at slots[j * ES + e]); an env past the
// batch takes env B - 1's columns.
template <int ROWS>
__device__ __forceinline__ void load_block(const Leaves<const float>& in, int B, int b0, float* slots) {
  constexpr int N = ROWS * ENVS;
#pragma unroll 1
  for (int i0 = threadIdx.x; i0 < N; i0 += CHUNK * LN_THREADS) {
    float val[CHUNK];
    int dst[CHUNK];
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      const int i = i0 + u * LN_THREADS, e = i % ENVS;
      if (i < N) {
        int j;
        const float* row = device_row(in, i / ENVS, B, j);
        val[u] = __ldg(row + (b0 + e < B ? b0 + e : B - 1));
        dst[u] = j * ES + e;
      }
    }
#pragma unroll
    for (int u = 0; u < CHUNK; ++u)
      if (i0 + u * LN_THREADS < N) slots[dst[u]] = val[u];
  }
}

// The block's envs' new state from their slots to the output columns, for
// the envs in the batch.
__device__ __forceinline__ void store_block(const float* slots, int B, int b0, const Leaves<float>& out) {
  constexpr int N = STATE_ROWS * ENVS;
#pragma unroll 4
  for (int i = threadIdx.x; i < N; i += LN_THREADS) {
    const int e = i % ENVS;
    if (b0 + e < B) {
      int j;
      float* row = device_row(out, i / ENVS, B, j);
      row[b0 + e] = slots[j * ES + e];
    }
  }
}

// The step's torques: the env's torque row, which the load filled.
struct SlotTau {
  Slot sl;
  __device__ __forceinline__ float operator()(int k) const { return sl[SL_TAU + k]; }
};

// One step of the block's envs, env e of the block on lanes e*G .. e*G + G-1;
// an env past the batch runs env B - 1's step beside the others, so that
// every lane reaches every barrier and shuffle, and stores nothing. With
// tau_in (K3) the torques are its columns, else (K2) the PD policy.
template <bool TAU>
__device__ __forceinline__ void step_block(const float* __restrict__ params, const StateIn& in,
                                           const float* __restrict__ tau_in, const StateOut& out, int B,
                                           const Scalars& sc) {
  extern __shared__ float smem[];
  const float* P = smem;
  load_params(params, smem);
  float* slots = smem + SMEM_PARAMS;
  const int b0 = blockIdx.x * ENVS;
  load_block<TAU ? STATE_ROWS + NJ : STATE_ROWS>({in.s, in.sd, in.p, in.q, in.v, in.m, tau_in}, B, b0, slots);
  __syncthreads();

  const int e = threadIdx.x / G, g = threadIdx.x % G;
  const Slot sl{slots + e};
  const EnvState<float> x = slot_state(sl);
  if constexpr (TAU) {
    soft_step_lanes(P, sc, sl, g, x, SlotTau{sl}, nullptr);
  } else {
    soft_step_lanes(P, sc, sl, g, x, SlotPd{x.s, x.sd, sc.kp, sc.kd}, nullptr);
  }
  __syncthreads();

  store_block(slots, B, b0, {out.s, out.sd, out.p, out.q, out.v, out.m, nullptr});
}

__global__ void __launch_bounds__(LN_THREADS)
    step_pd_kernel(const float* __restrict__ params, StateIn in, StateOut out, int B, Scalars sc) {
  step_block<false>(params, in, nullptr, out, B, sc);
}

__global__ void __launch_bounds__(LN_THREADS)
    step_tau_kernel(const float* __restrict__ params, StateIn in, const float* __restrict__ tau_in, StateOut out,
                    int B, Scalars sc) {
  step_block<true>(params, in, tau_in, out, B, sc);
}

}  // namespace

extern "C" {

// Opts a kernel in to STEP_SMEM_BYTES of dynamic shared memory where that
// is past the 48 KB every kernel may take: once a kernel and device (bit d
// of *done for device d < 32), since K3 runs a thousand launches a second
// and the attribute outlives them.
static int allow_smem(const void* kernel, std::atomic<unsigned>* done) {
  if (STEP_SMEM_BYTES <= 48 * 1024) return 0;
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (bit & done->load(std::memory_order_relaxed)) return 0;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(STEP_SMEM_BYTES));
  if (rc == cudaSuccess) done->fetch_or(bit, std::memory_order_relaxed);
  return static_cast<int>(rc);
}
static std::atomic<unsigned> pd_smem_set{0}, tau_smem_set{0};

int jx_param_count() { return N_PARAMS; }

int jx_step_pd(const float* params, const float* s, const float* sd, const float* p, const float* q, const float* v,
               const float* m, float* s_out, float* sd_out, float* p_out, float* q_out, float* v_out, float* m_out,
               int B, float K, float D, float k_over_d, float mu, float hc_p, float hc_q, float gz, float dt, float kp,
               float kd, void* stream) {
  const Scalars sc{K, D, k_over_d, mu, hc_p, hc_q, gz, dt, kp, kd};
  const int rc = allow_smem(reinterpret_cast<const void*>(step_pd_kernel), &pd_smem_set);
  if (rc != 0) return rc;
  const int blocks = (B + ENVS - 1) / ENVS;
  step_pd_kernel<<<blocks, LN_THREADS, STEP_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      params, StateIn{s, sd, p, q, v, m}, StateOut{s_out, sd_out, p_out, q_out, v_out, m_out}, B, sc);
  return static_cast<int>(cudaGetLastError());
}

int jx_step_tau(const float* params, const float* s, const float* sd, const float* p, const float* q, const float* v,
                const float* m, const float* tau, float* s_out, float* sd_out, float* p_out, float* q_out,
                float* v_out, float* m_out, int B, float K, float D, float k_over_d, float mu, float hc_p, float hc_q,
                float gz, float dt, void* stream) {
  const Scalars sc{K, D, k_over_d, mu, hc_p, hc_q, gz, dt, 0.0f, 0.0f};
  const int rc = allow_smem(reinterpret_cast<const void*>(step_tau_kernel), &tau_smem_set);
  if (rc != 0) return rc;
  const int blocks = (B + ENVS - 1) / ENVS;
  step_tau_kernel<<<blocks, LN_THREADS, STEP_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      params, StateIn{s, sd, p, q, v, m}, tau, StateOut{s_out, sd_out, p_out, q_out, v_out, m_out}, B, sc);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry of step_tau_kernel (step_pd_kernel's is the same), for
// the reports: threads a block, envs a block, dynamic shared memory a block
// in bytes, and blocks an SM holds at once (the occupancy calculator:
// registers, threads and shared memory).
int jx_step_geometry(int* out) {
  const int rc = allow_smem(reinterpret_cast<const void*>(step_tau_kernel), &tau_smem_set);
  if (rc != 0) return rc;
  int blocks_per_sm = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, step_tau_kernel, LN_THREADS, STEP_SMEM_BYTES);
  out[0] = LN_THREADS;
  out[1] = ENVS;
  out[2] = static_cast<int>(STEP_SMEM_BYTES);
  out[3] = blocks_per_sm;
  return static_cast<int>(occ);
}

const char* jx_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
