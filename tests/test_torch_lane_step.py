"""The one-step kernels K2 and K3 (``csrc/step.cu``) on the lane-spread
step's forward-only slot, on the CPU.

The layout: for the pendulum, garpez and the humanoid at 2, 4 and 8 lanes
an env, and each count of envs a block (one warp's up to the most that
fit), the block the generated header sizes is what ``step.cu`` takes and
fits in an H100's 227 KB.

The kernels' logic: ``step.cu`` up to its ``extern "C"`` block, with both
entry kernels, is compiled once a build with g++ (``-std=c++20``) against
``test_torch_lane_forward.CUDA_SHIM`` (one ``std::thread`` a CUDA thread, a
block at a time, shared memory filled with NaN before each block) and a
harness that chains steps on the host, computing K3's torques from the
state between steps as ``-kp·s - kd·ṡ``. The state is one buffer, the
leaves in order, with a block's envs of NaN past its end, so a store by an
env past the batch lands on the first envs of the next row and shows. The binary
runs as a subprocess with a hard timeout and is held against
``step_pd_reference`` and ``step_tau_reference`` at ``chip_smoke.TOL``, K3
also with ``M`` scaled by 1.2 through ``pr``, which must move the state. To
run these alone:

    python -m pytest -q tests/test_torch_lane_step.py            # pendulum, garpez
    python -m pytest -q -m slow tests/test_torch_lane_step.py    # the humanoid
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np
import pytest

from jaxsim_tpu_torch.ops import cuda_build, cuda_step
from tests.test_torch_lane_forward import CUDA_SHIM, TIMEOUT_S, TOL, _engine, _fields, _header, _state

N_STEPS = 10
KP, KD = 60.0, 0.5

# argv = in.bin out.bin B n_steps kernel (2: K2, 3: K3), then the Scalars'
# ten floats in C99 hex (kp, kd last: K2's gains, and the gains of K3's
# torques). in.bin holds the packed model arrays and the state leaves s, sd,
# p, q, v, m; out.bin gets the state leaves after n_steps.
HARNESS = r"""
#include "cuda_runtime.h"
#include <cstdio>
#include <cstdlib>
#include <limits>
namespace {
alignas(16) float smem[232448 / 4];
}
#include "body.cu"

int main(int argc, char** argv) {
  int a = 1;
  const char* in_path = argv[a++];
  const char* out_path = argv[a++];
  const int B = std::atoi(argv[a++]), n_steps = std::atoi(argv[a++]), kernel = std::atoi(argv[a++]);
  float f[10];
  for (float& x : f) x = std::strtof(argv[a++], nullptr);
  const Scalars sc_pd{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9]};
  const Scalars sc_tau{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], 0.0f, 0.0f};
  std::vector<float> in;
  {
    FILE* fp = std::fopen(in_path, "rb");
    float x;
    while (std::fread(&x, 4, 1, fp) == 1) in.push_back(x);
    std::fclose(fp);
  }
  const size_t sizes[6] = {size_t(NJ) * B, size_t(NJ) * B, 3u * B, 4u * B, 6u * B, size_t(NCM) * 3 * B};
  size_t total = 0;
  for (size_t n : sizes) total += n;
  const float* params = in.data();
  // The state, one buffer of the leaves in order and a block's envs past it.
  std::vector<float> cur(in.begin() + N_PARAMS, in.begin() + N_PARAMS + total), tau(size_t(NJ) * B);
  cur.resize(total + ENVS, std::numeric_limits<float>::quiet_NaN());
  for (int t = 0; t < n_steps; ++t) {
    std::vector<float> nxt(total + ENVS, std::numeric_limits<float>::quiet_NaN());
    const float* ci[6];
    float* no[6];
    size_t off = 0;
    for (int k = 0; k < 6; ++k) {
      ci[k] = cur.data() + off;
      no[k] = nxt.data() + off;
      off += sizes[k];
    }
    for (size_t k = 0; k < tau.size(); ++k) tau[k] = -f[8] * ci[0][k] - f[9] * ci[1][k];
    const StateIn si{ci[0], ci[1], ci[2], ci[3], ci[4], ci[5]};
    const StateOut so{no[0], no[1], no[2], no[3], no[4], no[5]};
    for (int blk = 0; blk < (B + ENVS - 1) / ENVS; ++blk) {
      for (float& x : smem) x = std::numeric_limits<float>::quiet_NaN();
      shim::run_block(blk, LN_THREADS, [&] {
        if (kernel == 2)
          step_pd_kernel(params, si, so, B, sc_pd);
        else
          step_tau_kernel(params, si, tau.data(), so, B, sc_tau);
      });
    }
    cur.swap(nxt);
  }
  FILE* fp = std::fopen(out_path, "wb");
  std::fwrite(cur.data(), 4, total, fp);
  std::fclose(fp);
  return 0;
}
"""


def _build(tmp_path, engine, job):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    text = job.source.read_text()
    (tmp_path / "body.cu").write_text(text[: text.index('extern "C" {')])
    (tmp_path / "cuda_runtime.h").write_text(CUDA_SHIM)
    (tmp_path / cuda_build.GENERATED_HEADER).write_text(cuda_build.topology_header(engine, job.defines))
    (tmp_path / "harness.cpp").write_text(HARNESS)
    binary = tmp_path / "harness"
    cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-w", "-I", str(tmp_path), "-I", str(cuda_build.CSRC),
           str(tmp_path / "harness.cpp"), "-o", str(binary)]  # fmt: skip
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=TIMEOUT_S)
    return binary


def _run(tmp_path, binary, engine, state, kernel: int, params) -> dict[str, np.ndarray]:
    arrays = [params, *state.fields()]
    np.concatenate([a.detach().numpy().astype(np.float32).ravel() for a in arrays]).tofile(tmp_path / "in.bin")
    args = [str(binary), str(tmp_path / "in.bin"), str(tmp_path / "out.bin"), str(state.p.shape[-1]), str(N_STEPS),
            str(kernel)]  # fmt: skip
    args += [float(np.float32(x)).hex() for x in (*cuda_build.engine_scalars(engine), KP, KD)]
    subprocess.run(args, check=True, capture_output=True, timeout=TIMEOUT_S)
    got, _ = _fields(np.fromfile(tmp_path / "out.bin", dtype=np.float32), state)
    return got


def _max_diff(got: dict, want) -> float:
    """The largest |Δ| over every field's entries (inf where one is not finite)."""
    err = 0.0
    for name, t in zip(("s", "sd", "p", "q", "v", "m"), want.fields()):
        if not np.isfinite(got[name]).all():
            return float("inf")
        if t.numel():
            err = max(err, float(np.abs(got[name] - t.numpy()).max()))
    return err


def _step_case(tmp_path, name, lanes, envs, B):
    """K2 and K3 over N_STEPS chained steps of B envs (an env past the batch
    in the last block), and K3 under ``M`` ×1.2, against the plain versions."""
    eng = _engine(name)
    job = cuda_step.job(eng, lanes, envs)
    defines, _ = _header(name, job)
    assert defines["JX_LN_ENVS"] == envs and B % envs
    binary = _build(tmp_path, eng, job)
    state = _state(name, B, seed=30 + lanes)
    plain, plain_scaled = state, state
    pr = {"M": 1.2 * eng.M}
    for _ in range(N_STEPS):
        plain = cuda_step.step_pd_reference(eng, plain, KP, KD)
        plain_scaled = cuda_step.step_tau_reference(eng, plain_scaled, -KP * plain_scaled.s - KD * plain_scaled.sd, pr)
    k2 = _run(tmp_path, binary, eng, state, 2, cuda_build.packed_params(eng))
    k3 = _run(tmp_path, binary, eng, state, 3, cuda_build.packed_params(eng))
    k3_scaled = _run(tmp_path, binary, eng, state, 3, cuda_build.packed_params(eng, pr))
    assert _max_diff(k2, plain) <= TOL
    assert _max_diff(k3, plain) <= TOL
    assert _max_diff(k3_scaled, plain_scaled) <= TOL
    moved = max(float(np.abs(k3_scaled[k] - k3[k]).max()) for k in k3 if k3[k].size)
    assert moved > 1e-4


@pytest.mark.parametrize("lanes", (2, 4, 8))
@pytest.mark.parametrize("name", ("pendulum1", "garpez", "humanoid23"))
def test_step_header_sizes_the_block(name, lanes):
    """For each envs a block the probe tries: the generated header's block
    is the envs asked, its slot the forward-only layout with the state, and
    its shared memory (the model arrays, then the slots
    and a torque row an env at the odd stride) what step.cu takes, within
    227 KB; the most envs are at least the rollouts'."""
    eng = _engine(name)
    n_params = cuda_build.packed_params(eng).numel()
    envs_tried = cuda_step.block_envs(eng, lanes)
    assert envs_tried and envs_tried[0] == 32 // lanes
    for envs in envs_tried:
        defines, header = _header(name, cuda_step.job(eng, lanes, envs))
        assert defines["JX_LN_ENVS"] == envs and defines["JX_LN_FORWARD"] == 1
        stride = envs + 1 - envs % 2
        smem = 4 * (n_params + (defines["JX_LN_SLOT"] + eng.n_joints) * stride)
        t = cuda_build.lane_tables(eng, lanes, forward=True, step_envs=envs)
        assert t["smem_bytes"] == smem <= cuda_build.MAX_SMEM_BYTES
        assert t["slot"] == cuda_build.lane_tables(eng, lanes, forward=True)["slot"]
    if name == "humanoid23":
        assert envs_tried[-1] == 32


@pytest.mark.parametrize("lanes, envs", [(cuda_step.LANES, cuda_step.ENVS), (8, 4), (2, 16)])
@pytest.mark.parametrize("name", ("pendulum1", "garpez"))
def test_step_bodies_match_plain(tmp_path, name, lanes, envs):
    """K2, K3 and K3 with ``pr`` over 10 chained steps, two blocks of which
    the second runs envs past the batch."""
    _step_case(tmp_path, name, lanes, envs, B=2 * envs - 3)


@pytest.mark.slow
def test_humanoid_step_bodies_match_plain(tmp_path):
    """The humanoid at the wrapper's lanes and block."""
    envs = cuda_build.lane_tables(_engine("humanoid23"), cuda_step.LANES, forward=True, step_envs=cuda_step.ENVS)["envs"]
    _step_case(tmp_path, "humanoid23", cuda_step.LANES, envs, B=envs + 3)
