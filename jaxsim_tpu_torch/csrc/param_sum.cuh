// The fixed-order sum of per-block (or per-env) rows of model-array
// cotangents, which the two step VJP kernels share: K4 (step_vjp.cu) and
// K4-rr (step_vjp_rr.cu). N_PARAMS is the including kernel's.

#pragma once

#include "step_env.cuh"

namespace {

// out[k] = the sum over the blocks of partials[blk][k], in a fixed order: a
// block of SUM_WARPS warps takes SUM_ENTRIES (16) neighbouring entries, lane
// l entry l % 16; half h = l / 16 of warp w takes the rows 2w + h + 2
// SUM_WARPS t, so a load of the warp reads two rows' 64 neighbouring bytes
// (whole 32-byte sectors). A lane adds its rows into four accumulators by
// t % 4, then (a0 + a1) + (a2 + a3); a shuffle adds the warp's two halves,
// and the first warp adds the warps' sums in warp order through shared
// memory: no atomics, two runs agree to the bit. The humanoid's 1,989
// entries make 125 blocks, about one an SM of the card's 132. Of 4, 8, 16
// and 32 warps a block, 16 and 32 were the fastest on an H100 at the
// humanoid's 1,024 rows (chip_probe.py param_sum).
constexpr int SUM_ENTRIES = 16;
constexpr int SUM_WARPS = 16;

__global__ void __launch_bounds__(32 * SUM_WARPS) param_sum_kernel(const float* __restrict__ partials,
                                                                  int n_blocks, float* __restrict__ out) {
  __shared__ float part[SUM_WARPS][SUM_ENTRIES];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int k = blockIdx.x * SUM_ENTRIES + lane % SUM_ENTRIES;
  int r = 2 * w + lane / SUM_ENTRIES;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  if (k < N_PARAMS) {
    constexpr int S = 2 * SUM_WARPS;
#pragma unroll 4
    for (; r + 3 * S < n_blocks; r += 4 * S) {
      a0 += partials[r * N_PARAMS + k];
      a1 += partials[(r + S) * N_PARAMS + k];
      a2 += partials[(r + 2 * S) * N_PARAMS + k];
      a3 += partials[(r + 3 * S) * N_PARAMS + k];
    }
    if (r < n_blocks) a0 += partials[r * N_PARAMS + k];
    if (r + S < n_blocks) a1 += partials[(r + S) * N_PARAMS + k];
    if (r + 2 * S < n_blocks) a2 += partials[(r + 2 * S) * N_PARAMS + k];
  }
  float x = (a0 + a1) + (a2 + a3);
  x += __shfl_xor_sync(0xffffffffu, x, SUM_ENTRIES);
  if (lane < SUM_ENTRIES) part[w][lane] = x;
  __syncthreads();
  if (w == 0 && lane < SUM_ENTRIES && k < N_PARAMS) {
    float y = part[0][lane];
#pragma unroll
    for (int j = 1; j < SUM_WARPS; ++j) y += part[j][lane];
    out[k] = y;
  }
}

}  // namespace
