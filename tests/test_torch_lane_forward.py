"""The soft rollouts K1 (``csrc/rollout.cu``) and K5 (``csrc/env_rollout.cu``)
on the lane-spread step's forward-only slot (``csrc/soft_step_lanes.cuh``
with ``JX_LN_FORWARD``), on the CPU.

The layout: for the pendulum, garpez and the humanoid at 1, 2, 4 and 8 lanes
an env, the forward-only slot's rows fill the size the generated header
declares, the rows that share room are the ones the source overlays, a
block's shared memory fits in an H100's 227 KB, and K5's envs a block
divide 1024 (the ES main path's envs a candidate).

The kernels' logic: each kernel body, up to its ``extern "C"`` block, is
compiled with g++ (``-std=c++20``) against ``CUDA_SHIM`` below, a small
header of the CUDA names: one ``std::thread`` a CUDA thread and a block at
a time, ``__syncthreads`` and ``__syncwarp`` as ``std::barrier``s, a warp's
``__shfl_xor_sync`` through one of two arrays by turns behind one barrier,
shared memory one array filled with NaN before each block (a field read
before it is written shows). The binary runs as a subprocess with a hard
timeout, so a barrier that deadlocks fails the test instead of hanging the
suite, and its output is held against the plain versions
(``rollout_reference``, ``env_rollout_reference``) at ``chip_smoke.TOL``;
K1 also built for RK4 and RK4-fast engines (``JX_INTEGRATOR`` 1 and 2),
whose torques the body captures once a step, and those two built with
``float`` as ``double`` (``JX_DOUBLE``) on garpez rolled onto its limbs,
held against the float64 plain rollout within 1e-9, where a fault of the
stage update cannot hide under float32's rounding. To run these alone:

    python -m pytest -q tests/test_torch_lane_forward.py            # pendulum, garpez
    python -m pytest -q -m slow tests/test_torch_lane_forward.py    # the humanoid
"""

from __future__ import annotations

import functools
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, bridge, models
from jaxsim_tpu_torch.api.model import IntegratorType
from jaxsim_tpu_torch.ops import cuda_build, cuda_env_rollout, cuda_rollout

URDFS = dict(
    pendulum1=lambda: models.build_pendulum_urdf(1),
    garpez=models.build_garpez_urdf,
    humanoid23=models.build_humanoid_urdf,
)
LANES = (1, 2, 4, 8)
TOL = 1e-3  # chip_smoke.TOL: every field's largest |Δ| against the plain version
TIMEOUT_S = 60
ES_ENVS_PER_CANDIDATE = 1024  # chip_smoke.ES["envs_per"]
# The forward-only slot's rows in soft_step_lanes.cuh, (name, floats) in
# order: a link's, a contact parent's, the base's. On a link's T row (28)
# lie its world pose and velocity (WR, WP, WV) until pass 2, and a in pass 3.
LINK_ROWS = (("T", 28), ("V", 6), ("IR", 9), ("IP", 3), ("UDU", 8))
T_OVERLAY = (("WR", 9), ("WP", 3), ("WV", 6), ("A", 6))
PAR_ROWS = (("F", 6),)
BASE_ROWS = (("MA0", 36), ("PA0", 6))


INTEGRATORS = dict(sie=IntegratorType.SemiImplicitEuler, rk4=IntegratorType.RungeKutta4,
                   rk4fast=IntegratorType.RungeKutta4Fast)  # fmt: skip


@functools.lru_cache(maxsize=None)
def _engine(name: str, integrator: str = "sie") -> BatchedEngine:
    model = JaxSimModel.build_from_model_description(URDFS[name](), integrator=INTEGRATORS[integrator])
    return BatchedEngine.build(model, device="cpu")


def _forward_constants() -> dict[str, int]:
    """The integer constants of the forward-only layout in soft_step_lanes.cuh
    (the ``#if JX_LN_FORWARD`` branch)."""
    text = (cuda_build.CSRC / "soft_step_lanes.cuh").read_text()
    branch = text[text.index("#if JX_LN_FORWARD\n") : text.index("#else", text.index("#if JX_LN_FORWARD\n"))]
    return {k: int(v) for k, v in re.findall(r"\b((?:LK|PR|BS)_\w+|LK|PR|BS) = (\d+)\b", branch)}


def _header(name: str, job: cuda_build.BuildJob) -> tuple[dict[str, int], str]:
    header = cuda_build.topology_header(_engine(name), job.defines)
    return {k: int(v) for k, v in re.findall(r"^#define (\w+) (-?\d+)$", header, re.M)}, header


def test_forward_slot_rows():
    """Each row group's rows start where the one before ends and fill the
    group's size, which cuda_build counts; WR, Wp, Wv and a lie on T, a
    past Wv, so that link 0's pose and velocity outlive its a."""
    consts = _forward_constants()
    for prefix, rows in (("LK", LINK_ROWS), ("PR", PAR_ROWS), ("BS", BASE_ROWS)):
        offset = 0
        for name, width in rows:
            assert consts[f"{prefix}_{name}"] == offset, name
            offset += width
        assert consts[prefix] == offset
    assert (consts["LK"], consts["PR"], consts["BS"]) == cuda_build.LN_FLOATS[True]
    offset = consts["LK_T"]
    for name, width in T_OVERLAY:
        assert consts[f"LK_{name}"] == offset, name
        offset += width
    assert offset <= consts["LK_T"] + dict(LINK_ROWS)["T"]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", sorted(URDFS))
def test_forward_header_slot_fits_a_block(name, lanes):
    """For K1 and for K5 with each policy: the header's slot is the layout's
    size with the state (2 a joint, 13 for the base, 3 an m row); a block's
    slots at the odd stride, with the kernel's rows past the slot, the model
    arrays and a candidate's weights, fit in 227 KB; K5's envs a block
    divide 1024 and are what its wrapper checks the candidates against."""
    eng = _engine(name)
    link, par, base = cuda_build.LN_FLOATS[True]
    n_par = len(set(eng.contact_parent))
    slot = link * eng.n_links + par * n_par + base + 2 * eng.n_joints + 13 + 3 * eng.m_rows
    n_params = cuda_build.packed_params(eng).numel()
    d = 2 * eng.n_joints + 11
    policies = {"pd": (0, 0), "linear": (eng.n_joints * d + eng.n_joints, 0), "mlp": (16 * d + 16 + eng.n_joints * 16 + eng.n_joints, 16)}  # fmt: skip
    jobs = {"rollout": (cuda_rollout.job(eng, lanes), 0, 0, None)}
    for kind, (weights, hidden) in policies.items():
        pol = cuda_env_rollout.Policy(kind, hidden=hidden)
        jobs[kind] = (cuda_env_rollout.job(eng, pol, lanes), weights, eng.n_joints + hidden, pol)
    for label, (job, weights, env_rows, pol) in jobs.items():
        defines, _ = _header(name, job)
        assert defines["JX_LN_LANES"] == lanes and defines["JX_LN_FORWARD"] == 1, label
        assert defines["JX_LN_SLOT"] == slot, label
        envs = defines["JX_LN_ENVS"]
        stride = envs + 1 - envs % 2
        smem = 4 * ((slot + env_rows) * stride + n_params + weights)
        assert smem <= cuda_build.MAX_SMEM_BYTES, label
        assert envs & (envs - 1) == 0 and envs * lanes % 32 in (0, envs * lanes), label
        if pol is not None:
            assert cuda_build.policy_weight_count(eng.n_joints, cuda_env_rollout.POLICY_KINDS[pol.kind], hidden) == weights
            assert ES_ENVS_PER_CANDIDATE % envs == 0 and cuda_env_rollout.envs_per_block(eng, pol, lanes) == envs
    if name == "humanoid23":
        assert slot == 1577 and defines["JX_LN_ENVS"] == 32 and defines["JX_LN_NLEV"] == 7


def test_candidates_fill_whole_blocks():
    """The env rollout's wrapper refuses candidates whose envs do not fill
    whole blocks of the kernel (checked on the CPU, before any launch)."""
    eng = _engine("garpez")
    n, d = eng.n_joints, 2 * eng.n_joints + 11
    pol = cuda_env_rollout.make_policy(eng, W=torch.zeros(4, n, d))
    envs = cuda_env_rollout.envs_per_block(eng, pol)
    cuda_env_rollout.check_candidates(eng, 4 * envs, pol)
    with pytest.raises(ValueError, match=f"P · k · {envs} envs"):
        cuda_env_rollout.check_candidates(eng, 4 * envs + 4, pol)
    with pytest.raises(ValueError, match="whole blocks"):
        cuda_env_rollout.check_candidates(eng, 4 * (envs // 2), pol)


# ----- the kernel bodies under g++ -----

CUDA_SHIM = r"""
// The CUDA names the kernel bodies use, for a host rehearsal: one
// std::thread a CUDA thread, a block at a time (shim::run_block).
#pragma once
#include <barrier>
#include <cfloat>
#include <cmath>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__ static const
#define __shared__
#define __launch_bounds__(...)

struct dim3_ {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3_ threadIdx, blockIdx;
inline dim3_ blockDim;

namespace shim {
struct Warp {
  std::barrier<> bar;
  float val[32];
  explicit Warp(int n) : bar(n) {}
};
inline std::unique_ptr<std::barrier<>> block_bar;
inline std::vector<std::unique_ptr<Warp>> warps;

// Runs fn() on `threads` threads as block `block`.
template <class F>
void run_block(int block, int threads, F fn) {
  blockDim.x = threads;
  block_bar = std::make_unique<std::barrier<>>(threads);
  warps.clear();
  for (int w = 0; w * 32 < threads; ++w) warps.push_back(std::make_unique<Warp>(threads - w * 32 < 32 ? threads - w * 32 : 32));
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([=] {
      threadIdx.x = t;
      blockIdx.x = block;
      fn();
    });
  for (auto& th : pool) th.join();
}
}  // namespace shim

inline void __syncthreads() { shim::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { shim::warps[threadIdx.x / 32]->bar.arrive_and_wait(); }
// A warp's xor shuffle through one of two buffers by turns, behind one warp
// barrier: every lane of a warp makes the same shuffles in order, so no lane
// writes a buffer before every lane has read it.
inline float __shfl_xor_sync(unsigned, float x, int off) {
  static float buf[2][1024];
  static thread_local int turn = 0;
  const int t = turn;
  turn ^= 1;
  buf[t][threadIdx.x] = x;
  shim::warps[threadIdx.x / 32]->bar.arrive_and_wait();
  return buf[t][threadIdx.x ^ off];
}
inline float __ldg(const float* p) { return *p; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline unsigned __umulhi(unsigned a, unsigned b) { return static_cast<unsigned>((1ull * a * b) >> 32); }
"""

# The harness: argv = in.bin out.bin B n_steps, then the Scalars' ten floats
# and (K5) the Options' entries, floats in C99 hex. in.bin holds the packed
# model arrays, the state leaves s, sd, p, q, v, m, (K5) the weights, and
# the per-env rows the build takes: the five multipliers (JX_DOMAIN) and the
# terrain offset (JX_TERR_OFF); out.bin gets the state leaves and (K5) the
# reward sums, resets and steps. JX_DOUBLE 1 builds the body with ``float``
# as ``double`` (in.bin and out.bin then hold doubles), as
# test_torch_rr_step's harness does.
HARNESS = r"""
#include "cuda_runtime.h"
#include <cstdio>
#include <cstdlib>
#include <limits>
#if JX_DOUBLE
using Real = double;
// The CUDA names the body calls, on double: the xor shuffle as CUDA_SHIM's.
inline double __shfl_xor_sync(unsigned, double x, int off) {
  static double buf[2][1024];
  static thread_local int turn = 0;
  const int t = turn;
  turn ^= 1;
  buf[t][threadIdx.x] = x;
  shim::warps[threadIdx.x / 32]->bar.arrive_and_wait();
  return buf[t][threadIdx.x ^ off];
}
#define float double
#define sqrtf sqrt
#define fmaxf fmax
#define fminf fmin
#define powf pow
#define sinf sin
#define cosf cos
#define tanhf tanh
inline double __fadd_rn(double a, double b) { return a + b; }
inline double __fsub_rn(double a, double b) { return a - b; }
inline double __fmul_rn(double a, double b) { return a * b; }
#else
using Real = float;
#endif
namespace {
alignas(16) Real smem[232448 / 4];
}
#include "body.cu"
#if JX_DOUBLE
#undef float
#endif

int main(int argc, char** argv) {
  int a = 1;
  const char* in_path = argv[a++];
  const char* out_path = argv[a++];
  const int B = std::atoi(argv[a++]), n_steps = std::atoi(argv[a++]);
  Real f[10];
  for (Real& x : f) x = std::strtod(argv[a++], nullptr);
  const Scalars sc{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9]};
  std::vector<Real> in;
  {
    FILE* fp = std::fopen(in_path, "rb");
    Real x;
    while (std::fread(&x, sizeof(Real), 1, fp) == 1) in.push_back(x);
    std::fclose(fp);
  }
  const size_t sizes[6] = {size_t(NJ) * B, size_t(NJ) * B, 3u * B, 4u * B, 6u * B, size_t(NCM) * 3 * B};
  const Real* params = in.data();
  const Real* leaf[6];
  size_t off = N_PARAMS;
  for (int k = 0; k < 6; ++k) {
    leaf[k] = in.data() + off;
    off += sizes[k];
  }
  std::vector<Real> outs[6];
  for (int k = 0; k < 6; ++k) outs[k].assign(sizes[k], std::numeric_limits<Real>::quiet_NaN());
  const StateIn state_in{leaf[0], leaf[1], leaf[2], leaf[3], leaf[4], leaf[5]};
  const StateOut sout{outs[0].data(), outs[1].data(), outs[2].data(), outs[3].data(), outs[4].data(), outs[5].data()};
#if JX_KERNEL == 5
  const Real* weights = in.data() + off;
  off += static_cast<size_t>(WSZ) * (B / std::atoi(argv[a + 7]));  // a candidate's weights each
#endif
  const Real* dom_mul = nullptr;
  const Real* dom_off = nullptr;
#if JX_DOMAIN
  dom_mul = in.data() + off;
  off += 5u * B;
#endif
#if JX_TERR_OFF
  dom_off = in.data() + off;
  off += 2u * B;
#endif
  const DomainRows rows{dom_mul, dom_off};
#if JX_KERNEL == 5
  const Options o{std::atoi(argv[a]), std::strtof(argv[a + 1], nullptr), std::strtof(argv[a + 2], nullptr),
                  std::atoi(argv[a + 3]), std::strtof(argv[a + 4], nullptr), std::strtof(argv[a + 5], nullptr),
                  static_cast<unsigned>(std::strtoul(argv[a + 6], nullptr, 10)), std::atoi(argv[a + 7])};
  std::vector<float> reward(B);
  std::vector<int> resets(B), steps(B);
#endif
  for (int blk = 0; blk < (B + ENVS - 1) / ENVS; ++blk) {
    for (Real& x : smem) x = std::numeric_limits<Real>::quiet_NaN();
    shim::run_block(blk, LN_THREADS, [&] {
#if JX_KERNEL == 5
      env_rollout_kernel(params, weights, state_in, sout, reward.data(), resets.data(), steps.data(), B, n_steps, sc, o,
                         rows);
#else
      rollout_kernel(params, state_in, sout, B, n_steps, sc, rows);
#endif
    });
  }
  FILE* fp = std::fopen(out_path, "wb");
  for (auto& o : outs) std::fwrite(o.data(), sizeof(Real), o.size(), fp);
#if JX_KERNEL == 5
  for (int b = 0; b < B; ++b) {
    const float r[3] = {reward[b], float(resets[b]), float(steps[b])};
    std::fwrite(r, 4, 3, fp);
  }
#endif
  std::fclose(fp);
  return 0;
}
"""


def _build(tmp_path, engine, job, kernel: int, double: bool = False, csrc=None):
    """The kernel body of ``job.source`` (up to its ``extern "C"`` block)
    and the harness, compiled with g++ for ``engine``'s generated header
    (with ``double``, the body with ``float`` as ``double``), from ``csrc``
    (the checkout's ``csrc/`` by default)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    csrc = csrc or cuda_build.CSRC
    text = (csrc / job.source.name).read_text()
    (tmp_path / "body.cu").write_text(text[: text.index('extern "C" {')])
    (tmp_path / "cuda_runtime.h").write_text(CUDA_SHIM)
    (tmp_path / cuda_build.GENERATED_HEADER).write_text(cuda_build.topology_header(engine, job.defines))
    (tmp_path / "harness.cpp").write_text(HARNESS)
    binary = tmp_path / "harness"
    cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-DJX_KERNEL={kernel}", f"-DJX_DOUBLE={int(double)}",
           "-I", str(tmp_path), "-I", str(csrc), str(tmp_path / "harness.cpp"), "-o", str(binary)]  # fmt: skip
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=TIMEOUT_S)
    return binary


def _run(tmp_path, binary, engine, state, n_steps, scalars, options=(), weights=None, double=False, rows=()) -> np.ndarray:
    """The harness on ``state``; ``rows``: the per-env rows the build takes
    (the multipliers (5, B), the terrain offset (2, B))."""
    real = np.float64 if double else np.float32
    arrays = [cuda_build.packed_params(engine), *state.fields(), *(() if weights is None else (weights,)), *rows]
    np.concatenate([a.detach().numpy().astype(real).ravel() for a in arrays]).tofile(tmp_path / "in.bin")
    args = [str(binary), str(tmp_path / "in.bin"), str(tmp_path / "out.bin"), str(state.p.shape[-1]), str(n_steps)]
    args += [float(real(x)).hex() for x in scalars] + [str(x) for x in options]
    subprocess.run(args, check=True, capture_output=True, timeout=TIMEOUT_S)
    return np.fromfile(tmp_path / "out.bin", dtype=real)


# Base heights of the seeded starts: garpez low and tilted, so that points
# touch the ground from the first step; the humanoid standing.
BASE_Z = dict(pendulum1=0.0, garpez=0.015, humanoid23=0.9)


def _state(name, B, seed):
    """B envs of model ``name``, seeded: the joints displaced and moving,
    and for a floating base a tilted, moving base at ``BASE_Z``."""
    engine = _engine(name)
    rng = np.random.default_rng(seed)
    st = bridge.state_to_numpy(engine.init_state(B, base_position=(0.0, 0.0, BASE_Z[name])))
    st["s"] = (0.3 * rng.standard_normal(st["s"].shape)).astype(np.float32)
    st["sd"] = (0.5 * rng.standard_normal(st["sd"].shape)).astype(np.float32)
    if engine.floating_base:
        st["v"] = (0.3 * rng.standard_normal(st["v"].shape)).astype(np.float32)
        q = np.array([1.0, 0.05, -0.04, 0.02]) + 0.01 * rng.standard_normal((B, 4))
        st["q"] = (q / np.linalg.norm(q, axis=1, keepdims=True)).T.astype(np.float32)
    return bridge.state_from_numpy(st, device="cpu")


def _fields(flat: np.ndarray, state) -> dict[str, np.ndarray]:
    out, off = {}, 0
    for name, t in zip(bridge.STATE_FIELDS, state.fields()):
        out[name] = flat[off : off + t.numel()].reshape(t.shape)
        off += t.numel()
    return out, off


def _assert_close(got: dict, want) -> None:
    for name, t in zip(bridge.STATE_FIELDS, want.fields()):
        ref = t.numpy()
        assert np.isfinite(got[name]).all(), name
        err = float(np.abs(got[name] - ref).max()) if ref.size else 0.0
        assert err <= TOL, (name, err)


def _rollout_case(tmp_path, name, lanes, B, n_steps, integrator="sie", gains=(60.0, 0.5)):
    eng = _engine(name, integrator)
    state = _state(name, B, seed=lanes)
    binary = _build(tmp_path, eng, cuda_rollout.job(eng, lanes), 1)
    kp, kd = gains
    flat = _run(tmp_path, binary, eng, state, n_steps, (*cuda_build.engine_scalars(eng), kp, kd))
    got, _ = _fields(flat, state)
    _assert_close(got, cuda_rollout.rollout_reference(eng, state, n_steps, kp, kd))
    return eng, state, got


def _env_case(tmp_path, name, lanes, candidates, n_steps):
    eng = _engine(name)
    n, d, H = eng.n_joints, 2 * eng.n_joints + 11, 8
    rng = np.random.default_rng(10 + lanes)

    def w(*shape):
        return torch.from_numpy((0.2 * rng.standard_normal(shape)).astype(np.float32))

    pol = cuda_env_rollout.make_policy(
        eng, W1=w(candidates, H, d), b1=w(candidates, H, 1), W2=w(candidates, n, H), b2=w(candidates, n, 1)
    )
    B = candidates * cuda_env_rollout.envs_per_block(eng, pol, lanes)
    state = _state(name, B, seed=20 + lanes)
    opts = dict(episode_length=7, healthy_z_range=(-1.0, 5.0), tau_limit=5.0, reset_noise=0.02, seed=3)
    binary = _build(tmp_path, eng, cuda_env_rollout.job(eng, pol, lanes), 5)
    options = (opts["episode_length"], *(float(np.float32(z)).hex() for z in opts["healthy_z_range"]), 1,
               float(np.float32(opts["tau_limit"])).hex(), float(np.float32(opts["reset_noise"] * 3.0**0.5)).hex(),
               opts["seed"], B // candidates)  # fmt: skip
    flat = _run(tmp_path, binary, eng, state, n_steps, (*cuda_build.engine_scalars(eng), 60.0, 0.5), options,
                pol.packed())  # fmt: skip
    got, off = _fields(flat, state)
    final, reward, resets, steps = cuda_env_rollout.env_rollout_reference(
        eng, state, n_steps, W1=pol.weights[0], b1=pol.weights[1], W2=pol.weights[2], b2=pol.weights[3], **opts
    )
    sums = flat[off:].reshape(B, 3)
    assert np.array_equal(sums[:, 1], resets.numpy()) and np.array_equal(sums[:, 2], steps.numpy())
    assert int(resets.sum()) == B * (n_steps // opts["episode_length"])
    assert float(np.abs(sums[:, 0] - reward.numpy()).max()) <= TOL
    _assert_close(got, final)


@pytest.mark.parametrize("lanes", (1, 4, 8))
@pytest.mark.parametrize("name", ("pendulum1", "garpez"))
def test_rollout_body_matches_plain(tmp_path, name, lanes):
    """K1's body, 20 steps of a few envs (one block, the rest of it running
    the last env), against the plain rollout."""
    _rollout_case(tmp_path, name, lanes, B=5, n_steps=20)


@pytest.mark.parametrize("lanes", (1, 4, 8))
@pytest.mark.parametrize("name", ("pendulum1", "garpez"))
def test_env_rollout_body_matches_plain(tmp_path, name, lanes):
    """K5's body with the tanh MLP of two candidates, a block each,
    episodes of 7 (two resets in 20 steps) and reset noise, against the
    plain env rollout: resets and steps equal in every env."""
    _env_case(tmp_path, name, lanes, candidates=2, n_steps=20)


@pytest.mark.slow
@pytest.mark.parametrize("kernel", ("rollout", "env_rollout"))
def test_humanoid_bodies_match_plain(tmp_path, kernel):
    """The humanoid at the wrappers' lanes: K1 over 20 steps, K5 (one
    candidate) over 20 steps with two resets."""
    if kernel == "rollout":
        _rollout_case(tmp_path, "humanoid23", cuda_rollout.LANES, B=3, n_steps=20)
    else:
        _env_case(tmp_path, "humanoid23", cuda_env_rollout.LANES, candidates=1, n_steps=20)


@pytest.mark.parametrize("integrator", ("rk4", "rk4fast"))
@pytest.mark.parametrize("name", ("pendulum1", "garpez"))
def test_rk4_rollout_body_matches_plain(tmp_path, name, integrator):
    """K1's RK4 and RK4-fast bodies at the wrapper's lanes, 20 steps of a
    few envs (one block, the rest of it running the last env), against the
    plain rollout."""
    _rollout_case(tmp_path, name, cuda_rollout.LANES, B=5, n_steps=20, integrator=integrator)


STIFF_GAINS = (2000.0, 20.0)


@pytest.mark.parametrize("integrator", ("rk4", "rk4fast"))
def test_rk4_body_captures_the_torques_once(tmp_path, integrator, monkeypatch):
    """The pendulum under stiff PD gains (``STIFF_GAINS``), 20 steps: a
    rollout whose RK4 stages evaluate the policy at the stage's state, not
    once at the step's start, lies more than 10 TOL from the plain rollout;
    the body holds the plain rollout to TOL, so it reads the torques the
    step captured."""
    eng, state, got = _rollout_case(tmp_path, "pendulum1", cuda_rollout.LANES, B=5, n_steps=20,
                                    integrator=integrator, gains=STIFF_GAINS)  # fmt: skip
    kp, kd = STIFF_GAINS
    derivatives = eng.derivatives
    monkeypatch.setattr(eng, "derivatives", lambda st, tau, pr=None, frozen_contacts=None: derivatives(
        st, -kp * st.s - kd * st.sd, pr, frozen_contacts))  # fmt: skip
    staged = cuda_rollout.rollout_reference(eng, state, 20, kp, kd)
    assert max(float(np.abs(got[k] - t.numpy()).max()) for k, t in zip(bridge.STATE_FIELDS, staged.fields())
               if t.numel()) > 10 * TOL  # fmt: skip


@pytest.mark.slow
@pytest.mark.parametrize("integrator", ("rk4", "rk4fast"))
def test_humanoid_rk4_body_matches_plain(tmp_path, integrator):
    """The humanoid's RK4 and RK4-fast K1 bodies at the wrapper's lanes, 10
    steps of 3 envs."""
    _rollout_case(tmp_path, "humanoid23", cuda_rollout.LANES, B=3, n_steps=10, integrator=integrator)


# ----- K1's RK4 bodies in float64 -----

# Garpez rolled onto its limbs (test_torch_rr_step's start, soft contacts):
# the base and at least two child links' points in contact, the base
# spinning, so that the stage update of the state's m rows, of a child's s
# and ṡ and of the base's quaternion reach the output; ``RK4_DOUBLE_B``
# envs, a block's other envs past the batch.
ROLLED_QUAT = (-0.348, -0.348, 0.596, -0.635)
ROLLED_SPIN = (4.0, -3.0, 6.0)
RK4_DOUBLE_B, RK4_DOUBLE_STEPS = 3, 3
F64 = dict(rtol=1e-9, atol=1e-9)  # test_torch_autograd.F64


@functools.lru_cache(maxsize=None)
def _engine64(integrator: str) -> BatchedEngine:
    model = JaxSimModel.build_from_model_description(models.build_garpez_urdf(), integrator=INTEGRATORS[integrator])
    return BatchedEngine.build(model, device="cpu").to(torch.float64)


def _rolled64(eng: BatchedEngine, B: int):
    """Garpez rolled onto its limbs, its base spinning, its joints displaced
    1.2·N(0, 1) rad and moving, each env lowered 4 mm into the ground,
    float64."""
    rng = np.random.default_rng(0)
    st = {k: np.asarray(v, np.float64) for k, v in bridge.state_to_numpy(eng.init_state(B)).items()}
    st["q"] = np.tile((np.asarray(ROLLED_QUAT) / np.linalg.norm(ROLLED_QUAT))[:, None], (1, B))
    st["s"] = 1.2 * rng.standard_normal(st["s"].shape)
    st["sd"] = 0.3 * rng.standard_normal(st["sd"].shape)
    st["v"][:3] = 0.1 * rng.standard_normal((3, B))
    st["v"][3:] = np.asarray(ROLLED_SPIN)[:, None]
    st["p"][2] = 0.0

    def as_state(a):
        return bridge.state_from_numpy(a, device="cpu", dtype=torch.float64)

    z = eng._point_geometry(*eng.fk(as_state(st)), eng.params())["pc"][2]
    st["p"][2] = -(z.min(0).values.numpy() + 0.004)
    state = as_state(st)
    z = eng._point_geometry(*eng.fk(state), eng.params())["pc"][2]
    parents = torch.tensor(eng.contact_parent)
    assert sum(bool((z[parents == i] < 0).any()) for i in range(1, eng.n_links)) >= 2
    return state


def _rk4_double_case(tmp_path, integrator: str, csrc=None) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """K1's RK4 or RK4-fast body built with ``float`` as ``double`` from
    ``csrc`` (the checkout's by default), one launch of RK4_DOUBLE_STEPS
    steps on the rolled garpez, and the float64 plain rollout, by field."""
    eng = _engine64(integrator)
    state = _rolled64(eng, RK4_DOUBLE_B)
    binary = _build(tmp_path, eng, cuda_rollout.job(eng), 1, double=True, csrc=csrc)
    kp, kd = 60.0, 0.5
    flat = _run(tmp_path, binary, eng, state, RK4_DOUBLE_STEPS, (*cuda_build.engine_scalars(eng), kp, kd), double=True)
    got, _ = _fields(flat, state)
    want = cuda_rollout.rollout_reference(eng, state, RK4_DOUBLE_STEPS, kp, kd)
    return {name: (got[name], w.numpy()) for name, w in zip(bridge.STATE_FIELDS, want.fields())}


@pytest.mark.parametrize("integrator", ("rk4", "rk4fast"))
def test_rk4_bodies_in_double_match_float64_plain(tmp_path, integrator):
    """K1's RK4 and RK4-fast bodies built with ``float`` as ``double``
    against the float64 plain rollout within 1e-9 in every field
    (``_rk4_double_case``): at the float32 limits a fault of the stage
    update can hide under rounding; here it cannot."""
    fields = _rk4_double_case(tmp_path, integrator)
    for name, (got, want) in fields.items():
        np.testing.assert_allclose(got, want, err_msg=name, **F64)
    m0 = _rolled64(_engine64(integrator), RK4_DOUBLE_B).m.numpy()
    assert float(np.abs(fields["m"][1] - m0).max()) > 1e-6


def test_rk4_double_rehearsal_refuses_the_stage_update_fault(tmp_path):
    """``chip_probe.RK4_FAULTS``' fault of the stage update, seeded into a
    copy of ``csrc/``, moves some field of the RK4 body's float64 rehearsal
    beyond 1e-9 of the float64 plain rollout."""
    from tests.test_torch_rk4 import _chip_probe

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    for file, old, new in _chip_probe().RK4_FAULTS["y0 captured once a launch"]:
        text = (csrc / file).read_text()
        assert text.count(old) == 1
        (csrc / file).write_text(text.replace(old, new))
    fields = _rk4_double_case(tmp_path, "rk4", csrc)
    assert not all(np.allclose(got, want, **F64) for got, want in fields.values())
