// FMA-rate probes on the CUDA cores: one thread runs CH independent chains
// a <- a*k + e from a = x * 0.5^i for T iterations, sums them and writes the
// sum, so no FMA can be dropped.
//
// Replaces two TPU kernels that compute these chains on the vector unit:
// bench.py's fma_kernel (the all-FMA peak that divides its utilisation
// readout, float32) and scripts/bf16_probe.py's kern (float32, bf16, and
// bf16 storage with float32 math). Three variants, one template each:
//  * f32: FFMA, one element a chain;
//  * bf16: packed __nv_bfloat162 chains with __hfma2 (HFMA2.BF16), two
//    elements a chain, which is how Hopper's CUDA cores retire bf16
//    elementwise FMAs;
//  * bf16_store: bf16 in storage, each iteration widened to float32, one
//    FFMA, and rounded back to bf16.
//
// What bounds it: operations only (a thread reads 4 bytes and writes 4).
// The rate is taken from the difference of a long and a short T, so launch
// and set-up costs cancel. k and e are kernel arguments, not literals: in
// bf16 0.9999991 rounds to 1 and 1.1e-7 vanishes against the chains' values,
// and a compiler that saw them could fold a*1 + e to a and drop the loop.
// The timed loop is UNROLL iterations of the CH chains a trip, with the trip
// loop kept rolled, so its body holds exactly UNROLL * CH FFMA (or HFMA2)
// instructions; ops/fma_probe.py checks that count in the SASS.
//
// The launch shape is Hopper's, not the TPU's (32, 128) tile grid: THREADS =
// 128 (one warp per SM sub-partition and block) and a grid of blocks per SM
// times the SM count, both swept with CH by ops/fma_probe.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 16;

template <int CH>
__global__ void __launch_bounds__(THREADS)
    fma_f32_kernel(const float* __restrict__ x, float* __restrict__ out, int trips, float k, float e) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const float x0 = x[t];
  float a[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) a[i] = x0 * (1.0f / static_cast<float>(1 << i));
#pragma unroll 1
  for (int it = 0; it < trips; ++it) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < CH; ++i) a[i] = fmaf(a[i], k, e);
  }
  float acc = a[0];
#pragma unroll
  for (int i = 1; i < CH; ++i) acc = acc + a[i];
  out[t] = acc;
}

template <int CH>
__global__ void __launch_bounds__(THREADS) fma_bf16_kernel(const __nv_bfloat162* __restrict__ x,
                                                           __nv_bfloat162* __restrict__ out,
                                                           int trips, float k, float e) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const __nv_bfloat162 k2 = __float2bfloat162_rn(k);
  const __nv_bfloat162 e2 = __float2bfloat162_rn(e);
  const __nv_bfloat162 x0 = x[t];
  __nv_bfloat162 a[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) a[i] = __hmul2(x0, __float2bfloat162_rn(1.0f / static_cast<float>(1 << i)));
#pragma unroll 1
  for (int it = 0; it < trips; ++it) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < CH; ++i) a[i] = __hfma2(a[i], k2, e2);
  }
  __nv_bfloat162 acc = a[0];
#pragma unroll
  for (int i = 1; i < CH; ++i) acc = __hadd2(acc, a[i]);
  out[t] = acc;
}

template <int CH>
__global__ void __launch_bounds__(THREADS) fma_bf16_store_kernel(const __nv_bfloat16* __restrict__ x,
                                                                 __nv_bfloat16* __restrict__ out,
                                                                 int trips, float k, float e) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const float x0 = __bfloat162float(x[t]);
  __nv_bfloat16 a[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) a[i] = __float2bfloat16_rn(x0 * (1.0f / static_cast<float>(1 << i)));
#pragma unroll 1
  for (int it = 0; it < trips; ++it) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < CH; ++i) a[i] = __float2bfloat16_rn(fmaf(__bfloat162float(a[i]), k, e));
  }
  __nv_bfloat16 acc = a[0];
#pragma unroll
  for (int i = 1; i < CH; ++i) acc = __float2bfloat16_rn(__bfloat162float(acc) + __bfloat162float(a[i]));
  out[t] = acc;
}

template <int CH>
void launch(int variant, const void* x, void* out, int blocks, int trips, float k, float e, cudaStream_t stream) {
  if (variant == 0) {
    fma_f32_kernel<CH><<<blocks, THREADS, 0, stream>>>(static_cast<const float*>(x), static_cast<float*>(out),
                                                       trips, k, e);
  } else if (variant == 1) {
    fma_bf16_kernel<CH><<<blocks, THREADS, 0, stream>>>(static_cast<const __nv_bfloat162*>(x),
                                                        static_cast<__nv_bfloat162*>(out), trips, k, e);
  } else {
    fma_bf16_store_kernel<CH><<<blocks, THREADS, 0, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                                              static_cast<__nv_bfloat16*>(out), trips, k, e);
  }
}

}  // namespace

extern "C" {

int jx_param_count() { return 0; }

// variant: 0 f32, 1 bf16, 2 bf16_store; chains: 1, 2, 4 or 8; blocks of
// THREADS threads, one x and one out element (a bf16 pair for bf16) each;
// T = trips * UNROLL iterations.
int jx_fma_probe(int variant, int chains, const void* x, void* out, int blocks, int trips, float k, float e,
                 void* stream) {
  if (variant < 0 || variant > 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: launch<1>(variant, x, out, blocks, trips, k, e, st); break;
    case 2: launch<2>(variant, x, out, blocks, trips, k, e, st); break;
    case 4: launch<4>(variant, x, out, blocks, trips, k, e, st); break;
    case 8: launch<8>(variant, x, out, blocks, trips, k, e, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* jx_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
