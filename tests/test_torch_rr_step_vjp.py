"""The relaxed-rigid step VJP kernel K4-rr (``csrc/step_vjp_rr.cu``) on the CPU.

The kernel source up to its ``extern "C"`` block is compiled with g++
(``-std=c++20``) against ``test_torch_rr_step.SHIM`` (one ``std::thread`` a
CUDA thread, a block at a time, shared memory filled with NaN before each
block, so that a row of the tape read before it is written, or after it
was reused, shows), its warp shuffles taken by the lanes of their mask
alone (``MASKED_SHUFFLE``: the model arrays' sums run on the lanes of one
link or point), and a harness that runs every block of one launch: the
output cotangents one buffer of the leaves in order with a block's envs of
NaN past its end, and the torques' likewise, so that a store by an env past
the batch lands on the next row and shows; the block rows of model-array
cotangents filled with NaN, and added on the host in ``param_sum_kernel``'s
order. The binary runs as a subprocess with a hard timeout and is held against the
plain version, ``cuda_step_vjp.step_vjp_reference`` (``torch.autograd.grad``
through the twin's step and its implicit PCG backward): every cotangent leaf
and ``tau``'s within ``chip_smoke.TOL`` relative to max(1, max |plain|), the
model arrays (``rrMinv``'s included) within chip_smoke's ``PARAMS_RTOL``
and ``PARAMS_ATOL``. The cases: the box dropped low and moving, and garpez
tilted low with its joints displaced and moving, both with points in
contact, ``m`` seeded, torques 0.1·N(0, 1), random cotangents on all six
leaves (``m``'s included), a ragged batch (13 envs: a block of 8, two
warps of 4 envs at 8 lanes, and a partial one), with and without
``params_grad``. Those starts touch the ground with the base's points
alone, and the float32 limits leave room for a small fault under rounding
(lambda at 1/reg on inactive points): the same body built with ``float``
as ``double`` (``JX_DOUBLE``) is held against the float64 twin within
1e-9 on garpez rolled onto its limbs, where the transposed tree passes
carry children's adjoints. To run these alone:

    python -m pytest -q tests/test_torch_rr_step_vjp.py
"""

from __future__ import annotations

import copy
import shutil
import subprocess

import numpy as np
import pytest
import torch

from jaxsim_tpu_torch import bridge
from jaxsim_tpu_torch.ops import cuda_build, cuda_step_vjp
from jaxsim_tpu_torch.ops.batched_engine import BatchedState
from tests.test_torch_autograd import F64
from tests.test_torch_lane_forward import TIMEOUT_S, TOL
from tests.test_torch_rr_step import ENVS, SHIM, _engine, _start

torch.set_num_threads(1)

PARAMS_RTOL, PARAMS_ATOL = 5e-3, 5e-4  # chip_smoke.PARAMS_RTOL, PARAMS_ATOL
B = 13  # one block of 8 envs and a ragged one
# __shfl_xor_sync taken by the lanes of its mask alone: a barrier for each
# (warp, mask), of the mask's lanes.
MASKED_SHUFFLE = r"""
#include <map>
#include <mutex>
namespace shim {
inline std::mutex mask_mutex;
inline std::map<std::pair<int, unsigned>, std::unique_ptr<std::barrier<>>> mask_bars;
inline std::barrier<>& mask_bar(unsigned mask) {
  std::lock_guard<std::mutex> lock(mask_mutex);
  auto& bar = mask_bars[{int(threadIdx.x / 32), mask}];
  if (!bar) bar = std::make_unique<std::barrier<>>(__builtin_popcount(mask));
  return *bar;
}
}  // namespace shim
inline float __shfl_xor_sync(unsigned mask, float x, int off) {
  shim::Warp& w = *shim::warps[threadIdx.x / 32];
  std::barrier<>& bar = mask == 0xffffffffu ? w.bar : shim::mask_bar(mask);
  const int lane = threadIdx.x % 32;
  w.val[lane] = x;
  bar.arrive_and_wait();
  const float y = w.val[lane ^ off];
  bar.arrive_and_wait();
  return y;
}
namespace shim {
inline double dval[32][32];
}
inline double __shfl_xor_sync(unsigned mask, double x, int off) {
  std::barrier<>& bar = mask == 0xffffffffu ? shim::warps[threadIdx.x / 32]->bar : shim::mask_bar(mask);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  shim::dval[warp][lane] = x;
  bar.arrive_and_wait();
  const double y = shim::dval[warp][lane ^ off];
  bar.arrive_and_wait();
  return y;
}
"""
_SHFL = SHIM[SHIM.index("inline float __shfl_xor_sync") : SHIM.index("inline float __ldg")]

# argv = in.bin out.bin B, then the Scalars' 23 floats in C99 hex. in.bin
# holds the packed model arrays, the state leaves s, sd, p, q, v, m, tau and
# the output cotangents' leaves; out.bin gets the input cotangents' leaves,
# tau's and (with params_grad) the model arrays' summed over the batch.
HARNESS = r"""
#include "cuda_runtime.h"
#include <cstdio>
#include <cstdlib>
#include <limits>
#if JX_DOUBLE
using Real = double;
#else
using Real = float;
#endif
namespace {
alignas(16) Real smem[232448 / 4];
}
#if JX_DOUBLE
// The body in double: float, and the float math functions, as double's.
#define float double
#define sqrtf sqrt
#define fmaxf fmax
#define fminf fmin
#define fabsf fabs
#define powf pow
#define sinf sin
#define cosf cos
#endif
#include "body.cu"
#if JX_DOUBLE
#undef float
#endif

int main(int argc, char** argv) {
  int a = 1;
  const char* in_path = argv[a++];
  const char* out_path = argv[a++];
  const int B = std::atoi(argv[a++]);
  Real f[23];
  for (Real& x : f) x = std::strtod(argv[a++], nullptr);
  const Scalars sc{f[0],  f[1],  f[2],  f[3],  f[4],  f[5],  f[6],  f[7],  f[8],  f[9],  f[10], f[11],
                   f[12], f[13], f[14], f[15], f[16], f[17], f[18], f[19], f[20], f[21], f[22]};
  std::vector<Real> in;
  {
    FILE* fp = std::fopen(in_path, "rb");
    Real x;
    while (std::fread(&x, sizeof(Real), 1, fp) == 1) in.push_back(x);
    std::fclose(fp);
  }
  const Real nan = std::numeric_limits<Real>::quiet_NaN();
  const size_t sizes[6] = {size_t(NJ) * B, size_t(NJ) * B, 3u * B, 4u * B, 6u * B, size_t(NCM) * 3 * B};
  size_t total = 0;
  for (size_t n : sizes) total += n;
  const Real* params = in.data();
  const Real* state = params + N_PARAMS;
  const Real* tau = state + total;
  const Real* cot = tau + size_t(NJ) * B;
  std::vector<Real> out(total + ENVS, nan), ct_tau(size_t(NJ) * B + ENVS, nan);
  const int blocks = (B + ENVS - 1) / ENVS;
  std::vector<Real> partials(size_t(blocks) * N_PARAMS, nan);
  const Real* si[6];
  const Real* ci[6];
  Real* oi[6];
  size_t off = 0;
  for (int k = 0; k < 6; ++k) {
    si[k] = state + off;
    ci[k] = cot + off;
    oi[k] = out.data() + off;
    off += sizes[k];
  }
  const StateIn x{si[0], si[1], si[2], si[3], si[4], si[5]};
  const StateIn c{ci[0], ci[1], ci[2], ci[3], ci[4], ci[5]};
  const StateOut o{oi[0], oi[1], oi[2], oi[3], oi[4], oi[5]};
  for (int blk = 0; blk < blocks; ++blk) {
    for (Real& y : smem) y = nan;
    shim::run_block(blk, RR_THREADS, [&] {
      step_vjp_rr_kernel(params, x, tau, c, o, ct_tau.data(), PARAMS_GRAD ? partials.data() : nullptr, B, sc);
    });
  }
  FILE* fp = std::fopen(out_path, "wb");
  std::fwrite(out.data(), sizeof(Real), total, fp);
  std::fwrite(ct_tau.data(), sizeof(Real), size_t(NJ) * B, fp);
  if (PARAMS_GRAD) {
    // param_sum_kernel's order: half h of warp w takes the rows 2w + h + 2
    // SUM_WARPS t into four accumulators by t % 4; the halves, then the
    // warps in order.
    for (int k = 0; k < N_PARAMS; ++k) {
      Real part[SUM_WARPS];
      for (int w = 0; w < SUM_WARPS; ++w) {
        Real half[2];
        for (int h = 0; h < 2; ++h) {
          const int S = 2 * SUM_WARPS;
          Real a[4] = {0, 0, 0, 0};
          int r = 2 * w + h;
          for (; r + 3 * S < blocks; r += 4 * S)
            for (int j = 0; j < 4; ++j) a[j] += partials[size_t(r + j * S) * N_PARAMS + k];
          for (int j = 0; j < 3; ++j)
            if (r + j * S < blocks) a[j] += partials[size_t(r + j * S) * N_PARAMS + k];
          half[h] = (a[0] + a[1]) + (a[2] + a[3]);
        }
        part[w] = half[0] + half[1];
      }
      Real y = part[0];
      for (int w = 1; w < SUM_WARPS; ++w) y += part[w];
      std::fwrite(&y, sizeof(Real), 1, fp);
    }
  }
  std::fclose(fp);
  return 0;
}
"""


def _build(tmp_path, engine, job, double: bool = False):
    """``step_vjp_rr.cu`` up to its ``extern "C"`` block and the harness,
    compiled with g++ for ``engine``'s generated header (with ``double``,
    the body with ``float`` as ``double``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    text = job.source.read_text()
    (tmp_path / "body.cu").write_text(text[: text.index('extern "C" {')])
    (tmp_path / "cuda_runtime.h").write_text(SHIM.replace(_SHFL, MASKED_SHUFFLE))
    header = cuda_build.topology_header(engine, job.defines)
    assert f"#define JX_RR_ENVS {ENVS}\n" in header
    (tmp_path / cuda_build.GENERATED_HEADER).write_text(header)
    (tmp_path / "harness.cpp").write_text(HARNESS)
    binary = tmp_path / "harness"
    cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-DJX_DOUBLE={int(double)}", "-I", str(tmp_path),
           "-I", str(cuda_build.CSRC), str(tmp_path / "harness.cpp"), "-o", str(binary)]  # fmt: skip
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=TIMEOUT_S)
    return binary


def _run(tmp_path, binary, engine, state, tau, ct, params_grad, double: bool = False):
    real = np.float64 if double else np.float32
    arrays = [cuda_build.packed_params(engine), *state.fields(), tau, *ct.fields()]
    np.concatenate([a.detach().numpy().astype(real).ravel() for a in arrays]).tofile(tmp_path / "in.bin")
    scalars = (*cuda_build.engine_scalars(engine), 0.0, 0.0, *cuda_build.rr_scalars(engine))
    args = [str(binary), str(tmp_path / "in.bin"), str(tmp_path / "out.bin"), str(state.p.shape[-1]),
            *(float(real(x)).hex() for x in scalars)]  # fmt: skip
    subprocess.run(args, check=True, capture_output=True, timeout=TIMEOUT_S)
    flat = np.fromfile(tmp_path / "out.bin", dtype=real)
    leaves, off = {}, 0
    for name, t in zip(bridge.STATE_FIELDS, state.fields()):
        leaves[name] = flat[off : off + t.numel()].reshape(t.shape)
        off += t.numel()
    got_tau = flat[off : off + tau.numel()].reshape(tau.shape)
    off += tau.numel()
    got_params = cuda_step_vjp.unpack_params(engine, torch.from_numpy(flat[off:].copy())) if params_grad else None
    return leaves, got_tau, got_params


def _inputs(name: str, seed: int):
    eng = _engine(name)
    state = _start(name, B, seed)
    rng = np.random.default_rng(seed + 1)
    tau = torch.from_numpy((0.1 * rng.standard_normal((eng.n_joints, B))).astype(np.float32))
    ct = BatchedState(*(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)) for t in state.fields()))
    return eng, state, tau, ct


def _leaf_ratio(got, want) -> float:
    """A cotangent leaf's largest |Δ| over TOL·max(1, max |plain|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - want).max()) / (TOL * max(1.0, float(np.abs(want).max()))) if want.size else 0.0


def _params_ratio(got, want) -> float:
    """chip_smoke.params_gate's statistic of one model array: the larger of
    each entry's |Δ| over PARAMS_RTOL·|plain| + PARAMS_ATOL·max(1, max
    |plain|), and of the entries above that absolute part their relative
    error over PARAMS_RTOL."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.isfinite(got).all():
        return float("inf")
    if not want.size:
        return 0.0
    d, atol = np.abs(got - want), PARAMS_ATOL * max(1.0, float(np.abs(want).max()))
    share = float((d / (PARAMS_RTOL * np.abs(want) + atol)).max())
    big = np.abs(want) > atol
    rel = float((d[big] / np.abs(want[big])).max()) if big.any() else 0.0
    return max(share, rel / PARAMS_RTOL)


def _assert_close(label, got, want32, want64, ratio) -> None:
    """``got`` within its limit of the float32 plain version; where float32
    alone breaches the limit (the float32 plain version against the float64
    one), within 2 × that breach of the float64 plain version, as
    chip_smoke's relaxed-rigid cases are held."""
    r = ratio(got, want32)
    if r <= 1.0:
        return
    r32, r64 = ratio(want32, want64), ratio(got, want64)
    assert r32 > 1.0 and r64 <= 2.0 * r32, (label, r, r32, r64)


@pytest.mark.parametrize("params_grad", [False, True], ids=["state", "params_grad"])
@pytest.mark.parametrize("name", ["box", "garpez"])
def test_step_vjp_rr_body_matches_plain(tmp_path, name, params_grad):
    """K4-rr's body against the twin's step under autograd, from a start
    with points in contact, on a ragged batch."""
    eng, state, tau, ct = _inputs(name, seed=60)
    active = int(eng._point_geometry(*eng.fk(state), eng.params())["active"].sum())
    assert active > 0
    job = cuda_step_vjp.job(eng, params_grad, envs=ENVS)
    got, got_tau, got_params = _run(tmp_path, _build(tmp_path, eng, job), eng, state, tau, ct, params_grad)
    want = cuda_step_vjp.step_vjp_reference(eng, state, tau, ct, params_grad=params_grad)
    wide = BatchedState(*(t.double() for t in state.fields())), tau.double(), BatchedState(*(t.double() for t in ct.fields()))
    want64 = cuda_step_vjp.step_vjp_reference(copy.deepcopy(eng).to(torch.float64), *wide, params_grad=params_grad)
    for k, a, b in zip(bridge.STATE_FIELDS, want[0].fields(), want64[0].fields()):
        _assert_close(f"ct.{k}", got[k], a.numpy(), b.numpy(), _leaf_ratio)
    _assert_close("ct_tau", got_tau, want[1].numpy(), want64[1].numpy(), _leaf_ratio)
    if params_grad:
        assert set(got_params) == set(eng.PARAM_NAMES) and "rrMinv" in got_params
        for k in eng.PARAM_NAMES:
            _assert_close(f"ct_pr.{k}", got_params[k].numpy(), want[2][k].numpy(), want64[2][k].numpy(), _params_ratio)


# Garpez rolled onto its limbs: the base and its second and third links in
# contact, so that the transposed tree passes carry children's adjoints (the
# starts above touch with the base's points alone).
ROLLED_QUAT = (-0.348, -0.348, 0.596, -0.635)


def test_step_vjp_rr_body_in_double_matches_float64_plain(tmp_path):
    """K4-rr's body built with ``float`` as ``double``, with params_grad,
    against the float64 twin within ``test_torch_autograd.F64`` (1e-9), on
    garpez rolled onto its limbs, each env lowered 4 mm into the ground: at
    the float32 limits above a fault in the body's logic can hide under
    rounding (lambda at 1/reg on inactive points), here it cannot."""
    eng, state, tau, ct = _inputs("garpez", seed=60)
    eng = copy.deepcopy(eng).to(torch.float64)
    arrays = bridge.state_to_numpy(state)
    q = np.asarray(ROLLED_QUAT) / np.linalg.norm(ROLLED_QUAT)
    arrays["q"] = np.tile(q[:, None], (1, B))
    arrays["s"] = 1.2 * np.random.default_rng(0).standard_normal(arrays["s"].shape)
    arrays["p"][2] = 0.0

    def as_state(a):
        return bridge.state_from_numpy({k: np.asarray(v, np.float64) for k, v in a.items()}, device="cpu", dtype=torch.float64)

    z = eng._point_geometry(*eng.fk(as_state(arrays)), eng.params())["pc"][2]
    arrays["p"][2] = -(z.min(0).values.numpy() + 0.004)
    state = as_state(arrays)
    active = eng._point_geometry(*eng.fk(state), eng.params())["active"]
    parents = torch.tensor(eng.contact_parent)
    assert sum(int(active[parents == i].sum()) > 0 for i in range(1, eng.n_links)) >= 2
    tau, ct = tau.double(), BatchedState(*(t.double() for t in ct.fields()))
    job = cuda_step_vjp.job(eng, True, envs=ENVS)
    got, got_tau, got_params = _run(tmp_path, _build(tmp_path, eng, job, double=True), eng, state, tau, ct, True, True)
    want = cuda_step_vjp.step_vjp_reference(eng, state, tau, ct, params_grad=True)
    for k, w in zip(bridge.STATE_FIELDS, want[0].fields()):
        np.testing.assert_allclose(got[k], w.numpy(), err_msg=f"ct.{k}", **F64)
    np.testing.assert_allclose(got_tau, want[1].numpy(), err_msg="ct_tau", **F64)
    for k in eng.PARAM_NAMES:
        np.testing.assert_allclose(got_params[k].numpy(), want[2][k].numpy(), err_msg=f"ct_pr.{k}", **F64)
