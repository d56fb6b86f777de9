"""The relaxed-rigid one-step kernels K2-rr (K1-rr, ``csrc/rollout_rr.cu``,
launched for one step) and K3-rr (``csrc/step_rr.cu``) and the relaxed-rigid
env rollout K5-rr (``csrc/env_rollout_rr.cu``), on the CPU.

The layout: the generated header of K3's and K5's relaxed-rigid builds
names the contact model, gives each env's slot a torque row, and sizes a
block that fits an H100's 227 KB: the humanoid's 64 envs, also with the ES
main path's MLP and its candidate's weights, whose envs a block divide the
1024 envs of a candidate.

The kernels' logic: each kernel source up to its ``extern "C"`` block is
compiled with g++ (``-std=c++20``) against
``test_torch_lane_forward.CUDA_SHIM`` (one ``std::thread`` a CUDA thread, a
block at a time, shared memory filled with NaN before each block) and a
harness: for ``rollout_rr.cu`` (K2: one step a launch) and ``step_rr.cu``
(K3) it chains steps on the host, computing K3's torques from the state
between steps as ``-kp·s - kd·ṡ``, the state one buffer of the leaves in order with a
block's envs of NaN past its end, so that a store by an env past the batch
lands on the next row and shows; for ``env_rollout_rr.cu`` it runs one
launch. The blocks are 8 envs (two warps: the ABA threads of a block's
envs on the first, the lanes of its last four envs on the second), one
g++ binary for each model and source. The binary runs as a subprocess with a
hard timeout and is held against the plain versions (``step_pd_reference``,
``step_tau_reference``, ``env_rollout_reference``) at ``chip_smoke.TOL``,
every state field, ``m`` (the solved point forces, in newtons) relative to
max(1, max |plain m|):

* K2 and K3 on the box dropped low and on garpez tilted low (points in
  contact from the first step), 5 chained steps of a ragged batch; K3 also
  with ``M`` ×1.2 and ``rrMinv`` /1.2 through ``pr``, which must move the
  state;
* K5 on garpez with the tanh MLP of two candidates and with the PD closure
  on a ragged batch, episodes of 3 from a start whose ``m`` is not the solved forces:
  6 steps with reset noise end at a respawn, where ``m`` must be the
  start's, and 5 steps end mid-episode; resets and steps equal in every env;
* K3 and K1 under RK4 and RK4-fast built with ``float`` as ``double`` on
  garpez rolled onto its limbs, its base spinning, 3 PCG iterations,
  against the float64 twin within 1e-9 (the float32 cases touch the ground
  with garpez's base alone; there a child's pulled share could go missing
  unseen); under ``-m slow``, that this rehearsal refuses each seeded fault
  of ``chip_probe.py`` it reaches.

The generated tables of the free ABA on the lanes, and the text of the
probe's seeded edits, are checked without a build.

To run these alone:

    python -m pytest -q tests/test_torch_rr_step.py            # box, garpez
    python -m pytest -q -m slow tests/test_torch_rr_step.py    # the humanoid
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
from jaxsim_tpu_torch.ops import cuda_build, cuda_env_rollout, cuda_rollout, cuda_step
from jaxsim_tpu_torch.ops.contacts.relaxed_rigid import RelaxedRigidContacts
from tests.test_torch_lane_forward import CUDA_SHIM, TIMEOUT_S, TOL

torch.set_num_threads(1)

URDFS = dict(box=models.build_box_urdf, garpez=models.build_garpez_urdf, humanoid23=models.build_humanoid_urdf)
ENVS = 8  # envs a block of the rehearsed builds
N_STEPS = 5
GAINS = dict(box=(0.0, 0.0), garpez=(20.0, 0.1), humanoid23=(60.0, 0.5))
HIDDEN = 8
ES_ENVS_PER_CANDIDATE = 1024  # chip_smoke.ES["envs_per"]
# The CUDA names the relaxed-rigid step uses past the soft kernels': its
# calls kept out of line (inlined or not here alike), and the shuffles, xor
# and the free ABA's from one lane of a group of `width`, each through one of
# two buffers by turns behind one warp barrier, where CUDA_SHIM's xor shuffle
# waits at two: every lane of a warp makes the same shuffles in order, so no
# lane writes a buffer before all have read it (the rehearsals take about
# half the time).
_XOR = CUDA_SHIM[CUDA_SHIM.index("inline float __shfl_xor_sync") : CUDA_SHIM.index("inline float __ldg")]
SHIM = CUDA_SHIM.replace(_XOR, r"""namespace shim {
inline double shfl[2][1024];  // by turn and thread, as double: the float and double shuffles share it
inline thread_local int shfl_turn = 0;
template <class T>
inline T shfl_from(T x, int from) {
  Warp& w = *warps[threadIdx.x / 32];
  const int turn = shfl_turn;
  shfl_turn ^= 1;
  shfl[turn][threadIdx.x] = x;
  w.bar.arrive_and_wait();
  return static_cast<T>(shfl[turn][(threadIdx.x & ~31) + from]);
}
}  // namespace shim
inline float __shfl_xor_sync(unsigned, float x, int off) { return shim::shfl_from(x, threadIdx.x % 32 ^ off); }
""") + "inline float __fdiv_rn(float a, float b) { return a / b; }\n" + r"""
#define __noinline__
inline float __shfl_sync(unsigned, float x, int src, int width = 32) {
  return shim::shfl_from(x, (threadIdx.x % 32 & ~(width - 1)) | (src & (width - 1)));
}
"""

# The harness is compiled with JX_KERNEL 1 (K1: rollout_rr.cu's body, one
# launch of n_steps, with the RK4 scratch an RK4 build takes), 2 (K2: the
# same body, one step a launch), 3 (K3: step_rr.cu's) or 5 (K5:
# env_rollout_rr.cu's), and JX_DOUBLE 1 builds the body with ``float`` as
# ``double``. argv = in.bin out.bin B n_steps, then the Scalars' 23 floats in
# C99 hex (kp, kd the 9th and 10th: K1's, K2's and K5's gains, and the gains
# of K3's torques) and (K5) the Options' entries. in.bin holds the packed
# model arrays, the state leaves s, sd, p, q, v, m, (K5) the weights, and
# the per-env rows the build takes (K1, K5): the five multipliers
# (JX_DOMAIN) and the terrain offset (JX_TERR_OFF); out.bin gets the state
# leaves after n_steps and (K5) each env's reward sum, resets and steps.
HARNESS = r"""
#include "cuda_runtime.h"
#include <cstdio>
#include <cstdlib>
#include <limits>
#if JX_DOUBLE
using Real = double;
// The CUDA names the body calls, on double.
inline double __shfl_sync(unsigned, double x, int src, int width = 32) {
  return shim::shfl_from(x, (threadIdx.x % 32 & ~(width - 1)) | (src & (width - 1)));
}
inline double __shfl_xor_sync(unsigned, double x, int off) { return shim::shfl_from(x, threadIdx.x % 32 ^ off); }
inline double __ldg(const double* p) { return *p; }
inline double __fadd_rn(double a, double b) { return a + b; }
inline double __fsub_rn(double a, double b) { return a - b; }
inline double __fmul_rn(double a, double b) { return a * b; }
inline double __fdiv_rn(double a, double b) { return a / b; }
#define float double
#define sqrtf sqrt
#define fmaxf fmax
#define fminf fmin
#define fabsf fabs
#define powf pow
#define sinf sin
#define cosf cos
#define tanhf tanh
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
  Real f[23];
  for (Real& x : f) x = std::strtod(argv[a++], nullptr);
  Scalars sc{f[0],  f[1],  f[2],  f[3],  f[4],  f[5],  f[6],  f[7],  f[8],  f[9],  f[10], f[11],
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
  // The state, one buffer of the leaves in order and a block's envs past it.
  std::vector<Real> cur(in.begin() + N_PARAMS, in.begin() + N_PARAMS + total);
  cur.resize(total + ENVS, nan);
  const int blocks = (B + ENVS - 1) / ENVS;
  size_t row_at = N_PARAMS + total;
#if JX_KERNEL == 5
  row_at += static_cast<size_t>(WSZ) * (B / std::atoi(argv[a + 7]));  // a candidate's weights each
#endif
  const Real* dom_mul = nullptr;
  const Real* dom_off = nullptr;
#if JX_DOMAIN
  dom_mul = in.data() + row_at;
  row_at += 5u * B;
#endif
#if JX_TERR_OFF
  dom_off = in.data() + row_at;
#endif
  const DomainRows dom_rows{dom_mul, dom_off};
#if JX_KERNEL == 5 || JX_KERNEL == 1
  std::vector<Real> nxt(total + ENVS, nan);
  const Real* ci[6];
  Real* no[6];
  size_t off = 0;
  for (int k = 0; k < 6; ++k) {
    ci[k] = cur.data() + off;
    no[k] = nxt.data() + off;
    off += sizes[k];
  }
  const StateIn si{ci[0], ci[1], ci[2], ci[3], ci[4], ci[5]};
  const StateOut so{no[0], no[1], no[2], no[3], no[4], no[5]};
#endif
#if JX_KERNEL == 5
  const Real* weights = in.data() + N_PARAMS + total;
  const Options o{std::atoi(argv[a]), std::strtof(argv[a + 1], nullptr), std::strtof(argv[a + 2], nullptr),
                  std::atoi(argv[a + 3]), std::strtof(argv[a + 4], nullptr), std::strtof(argv[a + 5], nullptr),
                  static_cast<unsigned>(std::strtoul(argv[a + 6], nullptr, 10)), std::atoi(argv[a + 7])};
  std::vector<Real> reward(B);
  std::vector<int> resets(B), steps(B);
  for (int blk = 0; blk < blocks; ++blk) {
    for (Real& x : smem) x = nan;
    shim::run_block(blk, RR_THREADS, [&] {
      env_rollout_rr_kernel(params, weights, si, so, reward.data(), resets.data(), steps.data(), B, n_steps, sc, o,
                            dom_rows);
    });
  }
  cur.swap(nxt);
#elif JX_KERNEL == 1
  // The RK4 scratch, rows 2 NJ + 13 + 3 NCM, a column for every env of the
  // blocks (cuda_rollout.rk4_scratch); NaN, so that a read before its write
  // shows.
  const int stride = B + ENVS;
  const size_t rows = 2 * NJ + 13 + 3 * NCM;
  std::vector<Real> y0(rows * stride, nan), acc(rows * stride, nan);
  for (int blk = 0; blk < blocks; ++blk) {
    for (Real& x : smem) x = nan;
    shim::run_block(blk, RR_THREADS, [&] {
      rollout_rr_kernel(params, si, so, B, n_steps, sc, Rk4Scratch{y0.data(), acc.data(), stride}, dom_rows);
    });
  }
  cur.swap(nxt);
#else
  const Real kp = f[8], kd = f[9];
  std::vector<Real> tau(size_t(NJ) * B);
  for (int t = 0; t < n_steps; ++t) {
    std::vector<Real> nxt(total + ENVS, nan);
    const Real* ci[6];
    Real* no[6];
    size_t off = 0;
    for (int k = 0; k < 6; ++k) {
      ci[k] = cur.data() + off;
      no[k] = nxt.data() + off;
      off += sizes[k];
    }
    for (size_t k = 0; k < tau.size(); ++k) tau[k] = -kp * ci[0][k] - kd * ci[1][k];
    const StateIn si{ci[0], ci[1], ci[2], ci[3], ci[4], ci[5]};
    const StateOut so{no[0], no[1], no[2], no[3], no[4], no[5]};
    for (int blk = 0; blk < blocks; ++blk) {
      for (Real& x : smem) x = nan;
      shim::run_block(blk, RR_THREADS, [&] {
#if JX_KERNEL == 2
        rollout_rr_kernel(params, si, so, B, 1, sc, Rk4Scratch{nullptr, nullptr, 0}, dom_rows);
#else
        Scalars s3 = sc;
        s3.kp = s3.kd = 0.0f;
        step_tau_rr_kernel(params, si, tau.data(), so, B, s3);
#endif
      });
    }
    cur.swap(nxt);
  }
#endif
  FILE* fp = std::fopen(out_path, "wb");
  std::fwrite(cur.data(), sizeof(Real), total, fp);
#if JX_KERNEL == 5
  for (int b = 0; b < B; ++b) {
    const float r[3] = {float(reward[b]), float(resets[b]), float(steps[b])};
    std::fwrite(r, 4, 3, fp);
  }
#endif
  std::fclose(fp);
  return 0;
}
"""


@functools.lru_cache(maxsize=None)
def _engine(name: str) -> BatchedEngine:
    model = JaxSimModel.build_from_model_description(URDFS[name](), contact_model=RelaxedRigidContacts())
    return BatchedEngine.build(model, device="cpu")


def _defines(header: str) -> dict[str, int]:
    return {k: int(v) for k, v in re.findall(r"^#define (\w+) (-?\d+)$", header, re.M)}


def _with_envs(job: cuda_build.BuildJob, envs: int) -> cuda_build.BuildJob:
    """``job`` with blocks of at most ``envs`` envs."""
    defines = tuple(d for d in job.defines if d[0] != "JX_RR_MAX_ENVS") + (("JX_RR_MAX_ENVS", envs),)
    return cuda_build.BuildJob(job.engine, job.source, job.signatures, defines)


def _build(tmp_path, engine, job, kernel: int, double: bool = False, csrc=None):
    """The kernel source of ``job`` up to its ``extern "C"`` block and the
    harness, compiled with g++ for ``engine``'s generated header in a
    directory of ``tmp_path`` of its own (with ``double``, the body with
    ``float`` as ``double``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp_path = tmp_path / f"k{kernel}{'d' if double else ''}"
    tmp_path.mkdir()
    csrc = csrc or cuda_build.CSRC
    text = (csrc / job.source.name).read_text()
    (tmp_path / "body.cu").write_text(text[: text.index('extern "C" {')])
    (tmp_path / "cuda_runtime.h").write_text(SHIM)
    header = cuda_build.topology_header(engine, job.defines)
    assert _defines(header)["JX_RR_ENVS"] == ENVS
    (tmp_path / cuda_build.GENERATED_HEADER).write_text(header)
    (tmp_path / "harness.cpp").write_text(HARNESS)
    binary = tmp_path / f"harness{kernel}"
    cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-DJX_KERNEL={kernel}", f"-DJX_DOUBLE={int(double)}",
           "-I", str(tmp_path), "-I", str(csrc), str(tmp_path / "harness.cpp"), "-o", str(binary)]  # fmt: skip
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=TIMEOUT_S)
    return binary


def _run(tmp_path, binary, engine, state, n_steps, params, gains, options=(), weights=None,
         double: bool = False, rows=()) -> np.ndarray:
    """The harness on ``state``; ``rows``: the per-env rows the build takes
    (the multipliers (5, B), the terrain offset (2, B))."""
    real = np.float64 if double else np.float32
    arrays = [params, *state.fields(), *(() if weights is None else (weights,)), *rows]
    np.concatenate([a.detach().numpy().astype(real).ravel() for a in arrays]).tofile(tmp_path / "in.bin")
    scalars = (*cuda_build.engine_scalars(engine), *gains, *cuda_build.rr_scalars(engine))
    args = [str(binary), str(tmp_path / "in.bin"), str(tmp_path / "out.bin"), str(state.p.shape[-1]), str(n_steps),
            *(float(real(x)).hex() for x in scalars), *map(str, options)]  # fmt: skip
    subprocess.run(args, check=True, capture_output=True, timeout=TIMEOUT_S)
    return np.fromfile(tmp_path / "out.bin", dtype=real)


def _fields(flat: np.ndarray, state) -> tuple[dict[str, np.ndarray], int]:
    out, off = {}, 0
    for name, t in zip(bridge.STATE_FIELDS, state.fields()):
        out[name] = flat[off : off + t.numel()].reshape(t.shape)
        off += t.numel()
    return out, off


def _ratio(got: dict, want) -> float:
    """Every field's largest |Δ| (m's over max(1, max |plain m|)) over TOL:
    the worst; inf where the kernel's output is not finite."""
    worst = 0.0
    for name, t in zip(bridge.STATE_FIELDS, want.fields()):
        ref = t.numpy()
        if not np.isfinite(got[name]).all():
            return float("inf")
        if ref.size:
            scale = max(1.0, float(np.abs(ref).max())) if name == "m" else 1.0
            worst = max(worst, float(np.abs(got[name] - ref).max()) / scale / TOL)
    return worst


def _start(name: str, B: int, seed: int):
    """B envs in contact from the first step: the box dropped low and moving,
    garpez tilted low with its joints displaced and moving, the humanoid
    standing with its joints displaced and moving; m seeded, not the solved
    forces, so that a respawn that keeps the last step's m shows."""
    eng = _engine(name)
    rng = np.random.default_rng(seed)
    st = bridge.state_to_numpy(eng.init_state(B))
    if name == "box":
        st["p"] = np.array([0.0, 0.0, 0.05])[:, None] + 0.02 * rng.standard_normal((3, B))
        st["v"] = 0.1 * rng.standard_normal((6, B))
    elif name == "garpez":
        st["p"] = np.tile(np.array([0.0, 0.0, 0.015])[:, None], (1, B))
        st["q"] = np.tile(np.array([0.995, 0.0998, 0.0, 0.0])[:, None], (1, B))
    st["s"] = 0.05 * rng.standard_normal(st["s"].shape)
    st["sd"] = 0.3 * rng.standard_normal(st["sd"].shape)
    st["m"] = 2.0 * rng.standard_normal(st["m"].shape)
    return bridge.state_from_numpy({k: np.asarray(v, np.float32) for k, v in st.items()}, device="cpu")


def _step_case(tmp_path, name: str, B: int):
    """K2, K3 and K3 under ``pr`` over N_STEPS chained steps of B envs (envs
    past the batch in the last block), against the plain versions."""
    eng = _engine(name)
    k2_binary = _build(tmp_path, eng, _with_envs(cuda_rollout.job(eng), ENVS), 2)
    k3_binary = _build(tmp_path, eng, _with_envs(cuda_step.job(eng), ENVS), 3)
    state, gains = _start(name, B, seed=40), GAINS[name]
    kp, kd = gains
    pr = {"M": 1.2 * eng.M, "rrMinv": eng.rrMinv / 1.2}
    plain, plain_pr = state, state
    for _ in range(N_STEPS):
        plain = cuda_step.step_pd_reference(eng, plain, kp, kd)
        plain_pr = cuda_step.step_tau_reference(eng, plain_pr, -kp * plain_pr.s - kd * plain_pr.sd, pr)
    assert int(eng._point_geometry(*eng.fk(plain), eng.params())["active"].sum()) > 0
    own, scaled = cuda_build.packed_params(eng), cuda_build.packed_params(eng, pr)
    k2, _ = _fields(_run(tmp_path, k2_binary, eng, state, N_STEPS, own, gains), state)
    k3, _ = _fields(_run(tmp_path, k3_binary, eng, state, N_STEPS, own, gains), state)
    k3_pr, _ = _fields(_run(tmp_path, k3_binary, eng, state, N_STEPS, scaled, gains), state)
    assert _ratio(k2, plain) <= 1.0
    assert _ratio(k3, plain) <= 1.0
    assert _ratio(k3_pr, plain_pr) <= 1.0
    moved = max(float(np.abs(k3_pr[k] - k3[k]).max()) for k in k3 if k3[k].size)
    assert moved > 1e-4


def _env_case(tmp_path, name: str, policy: str, candidates: int, B: int):
    """K5 over episodes of 3: 6 steps with reset noise (ending at a respawn)
    and 5 without (ending mid-episode), against the plain env rollout."""
    eng = _engine(name)
    n, d = eng.n_joints, 2 * eng.n_joints + 11
    rng = np.random.default_rng(50)

    def w(*shape):
        return torch.from_numpy((0.2 * rng.standard_normal(shape)).astype(np.float32))

    if policy == "mlp":
        weights = dict(W1=w(candidates, HIDDEN, d), b1=w(candidates, HIDDEN, 1), W2=w(candidates, n, HIDDEN),
                       b2=w(candidates, n, 1))  # fmt: skip
    else:
        weights = {}
    pol = cuda_env_rollout.make_policy(eng, **weights)
    binary = _build(tmp_path, eng, _with_envs(cuda_env_rollout.job(eng, pol), ENVS), 5)
    state, gains = _start(name, B, seed=41), GAINS[name]
    tau_limit = 5.0 if weights else None
    for n_steps, noise in ((6, 0.02), (5, 0.0)):
        opts = dict(episode_length=3, healthy_z_range=(-1.0, 5.0), tau_limit=tau_limit, reset_noise=noise, seed=3)
        options = (3, float(np.float32(-1.0)).hex(), float(np.float32(5.0)).hex(), int(tau_limit is not None),
                   float(np.float32(tau_limit or 0.0)).hex(), float(np.float32(noise * 3.0**0.5)).hex(), 3,
                   B // pol.candidates)  # fmt: skip
        flat = _run(tmp_path, binary, eng, state, n_steps, cuda_build.packed_params(eng), gains, options,
                    pol.packed() if weights else None)  # fmt: skip
        got, off = _fields(flat, state)
        final, reward, resets, steps = cuda_env_rollout.env_rollout_reference(
            eng, state, n_steps, kp=gains[0], kd=gains[1], **weights, **opts
        )
        sums = flat[off:].reshape(B, 3)
        assert np.array_equal(sums[:, 1], resets.numpy()) and np.array_equal(sums[:, 2], steps.numpy())
        assert int(resets.sum()) == B * (n_steps // 3)
        assert float(np.abs(sums[:, 0] - reward.numpy()).max()) <= TOL
        assert _ratio(got, final) <= 1.0
        if n_steps % 3 == 0:  # at a respawn: the start's m, not the solved forces
            assert np.array_equal(got["m"], state.m.numpy())


@pytest.mark.parametrize("name", ("box", "garpez"))
def test_step_rr_bodies_match_plain(tmp_path, name):
    """K2, K3 and K3 under ``pr`` on a ragged batch: two blocks of 8 envs, the
    second running three envs past the batch."""
    _step_case(tmp_path, name, B=2 * ENVS - 3)


@pytest.mark.parametrize("policy, candidates, B", [("mlp", 2, 2 * ENVS), ("pd", 1, 2 * ENVS - 3)])
def test_env_rollout_rr_body_matches_plain(tmp_path, policy, candidates, B):
    """K5 on garpez: under the tanh MLP of two candidates, a block each;
    under the PD closure on a ragged batch. (The plain env rollout's reward,
    as JAX's, takes a model with joints: not the box.)"""
    _env_case(tmp_path, "garpez", policy, candidates, B)


@pytest.mark.slow
@pytest.mark.parametrize("kernel", ("step", "env_rollout"))
def test_humanoid_rr_bodies_match_plain(tmp_path, kernel):
    """The humanoid: K2, K3 and K3 under ``pr`` on a ragged batch; K5 under
    the tanh MLP of two candidates."""
    if kernel == "step":
        _step_case(tmp_path, "humanoid23", B=ENVS + 3)
    else:
        _env_case(tmp_path, "humanoid23", "mlp", 2, 2 * ENVS)


# Garpez rolled onto its limbs: the base and its second and third links in
# contact, so that the free ABA's pulled shares and, under RK4-fast, a child
# parent's frozen wrench reach the state (the starts above touch the ground
# with the base's points alone).
ROLLED_QUAT = (-0.348, -0.348, 0.596, -0.635)
# Its base spinning, so that the RK4 stages' quaternions leave the unit norm
# by more than the Baumgarte term's rounding; 3 PCG iterations, where the
# solve has not converged, so that its warm start and its iterations show.
ROLLED_SPIN = (4.0, -3.0, 6.0)
ROLLED_ITERS = 3
F64 = dict(rtol=1e-9, atol=1e-9)  # test_torch_autograd.F64


@functools.lru_cache(maxsize=None)
def _engine64(integrator: str) -> BatchedEngine:
    model = JaxSimModel.build_from_model_description(
        models.build_garpez_urdf(), contact_model=RelaxedRigidContacts(), integrator=IntegratorType[integrator]
    )
    engine = BatchedEngine.build(model, device="cpu").to(torch.float64)
    engine.rr_iterations = ROLLED_ITERS
    return engine


def _rolled(eng: BatchedEngine, B: int):
    """Garpez rolled onto its limbs, its base spinning, its joints displaced
    1.2·N(0, 1) rad and moving, each env lowered 4 mm into the ground,
    float64; at least two of its child links in contact."""
    arrays = {k: np.asarray(v, np.float64) for k, v in bridge.state_to_numpy(_start("garpez", B, seed=42)).items()}
    arrays["q"] = np.tile((np.asarray(ROLLED_QUAT) / np.linalg.norm(ROLLED_QUAT))[:, None], (1, B))
    arrays["s"] = 1.2 * np.random.default_rng(0).standard_normal(arrays["s"].shape)
    arrays["v"][3:] = np.asarray(ROLLED_SPIN)[:, None]
    arrays["p"][2] = 0.0

    def as_state(a):
        return bridge.state_from_numpy(a, device="cpu", dtype=torch.float64)

    z = eng._point_geometry(*eng.fk(as_state(arrays)), eng.params())["pc"][2]
    arrays["p"][2] = -(z.min(0).values.numpy() + 0.004)
    state = as_state(arrays)
    active = eng._point_geometry(*eng.fk(state), eng.params())["active"]
    parents = torch.tensor(eng.contact_parent)
    assert sum(int(active[parents == i].sum()) > 0 for i in range(1, eng.n_links)) >= 2
    return state


def _double_case(tmp_path, integrator: str, csrc=None) -> dict[str, np.ndarray]:
    """The body built with ``float`` as ``double`` from ``csrc`` (the
    checkout's by default), on garpez rolled onto its limbs at
    ``ROLLED_ITERS`` PCG iterations, and the float64 twin, field by field:
    K3 over 2 chained steps under semi-implicit Euler, K1 (one launch) over
    2 RK4 or RK4-fast steps, one block of envs."""
    eng = _engine64(integrator)
    B, n_steps = ENVS, 2
    kp, kd = GAINS["garpez"]
    state = _rolled(eng, B)
    if integrator == "SemiImplicitEuler":
        binary = _build(tmp_path, eng, _with_envs(cuda_step.job(eng), ENVS), 3, double=True, csrc=csrc)
        want = state
        for _ in range(n_steps):
            want = cuda_step.step_tau_reference(eng, want, -kp * want.s - kd * want.sd)
    else:
        binary = _build(tmp_path, eng, _with_envs(cuda_rollout.job(eng), ENVS), 1, double=True, csrc=csrc)
        want = cuda_rollout.rollout_reference(eng, state, n_steps, kp, kd)
    flat = _run(tmp_path, binary, eng, state, n_steps, cuda_build.packed_params(eng), (kp, kd), double=True)
    got, _ = _fields(flat, state)
    return {name: (got[name], w.numpy()) for name, w in zip(bridge.STATE_FIELDS, want.fields())}


@pytest.mark.parametrize("integrator", ["SemiImplicitEuler", "RungeKutta4", "RungeKutta4Fast"])
def test_rr_bodies_in_double_match_float64_plain(tmp_path, integrator):
    """The relaxed-rigid step's body built with ``float`` as ``double``
    against the float64 twin within 1e-9 in every field (``_double_case``).
    At the float32 limits a fault in the body's logic can hide under
    rounding; here it cannot."""
    fields = _double_case(tmp_path, integrator)
    for name, (got, want) in fields.items():
        np.testing.assert_allclose(got, want, err_msg=name, **F64)
    assert float(np.abs(fields["m"][0]).max()) > 0


# The seeded faults of the relaxed-rigid step (chip_probe's) that the float64
# rehearsal reaches, with the builds that include them: all of RR_FAULTS;
# RK4_FAULTS' in rr_step.cuh or step_env.cuh but the Baumgarte term, whose
# effect lies along q, which the kinematics divide out and the step's end
# renormalises (test_torch_rk4's quat_rate test holds it); RR_STEP_FAULTS'
# in step_rr.cu and rollout_rr.cu (K5's lie in env_rollout_rr.cu).
DOUBLE_FAULTS = {
    **{f"RR_FAULTS: {n}": ("RR_FAULTS", n, ("SemiImplicitEuler", "RungeKutta4")) for n in (
        "impedance floor dropped", "warm start forced cold", "one PCG iteration fewer",
        "a child's pulled pass-2 share dropped")},
    "RK4_FAULTS: stage weights": ("RK4_FAULTS", "stage weights (1, 2, 2, 2)/6", ("RungeKutta4", "RungeKutta4Fast")),
    "RK4_FAULTS: torques re-read": ("RK4_FAULTS", "torques re-read from the stage state", ("RungeKutta4",)),
    "RK4_FAULTS: stage PCG warm start": ("RK4_FAULTS", "stage PCG warm-started from the start's m", ("RungeKutta4",)),
    "RR_STEP_FAULTS: K3's torques": ("RR_STEP_FAULTS", "K3 reads env b + 1's torques", ("SemiImplicitEuler",)),
    "RR_STEP_FAULTS: K1's m": ("RR_STEP_FAULTS", "K2's m not stored", ("RungeKutta4",)),
}


@pytest.mark.slow
@pytest.mark.parametrize("fault", sorted(DOUBLE_FAULTS))
def test_double_rehearsal_refuses_seeded_faults(tmp_path, fault):
    """Each seeded fault the float64 rehearsal reaches, in a copy of
    ``csrc/``, moves some field beyond 1e-9 of the float64 twin, in each
    build that includes it (a few g++ builds each)."""
    import shutil

    from tests.test_torch_rk4 import _chip_probe

    table, name, integrators = DOUBLE_FAULTS[fault]
    edits = getattr(_chip_probe(), table)[name]
    edits = [("rr_step.cuh", *edits)] if table == "RR_FAULTS" else edits
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    for file, old, new in edits:
        (csrc / file).write_text((csrc / file).read_text().replace(old, new))
    for integrator in integrators:
        (tmp_path / integrator).mkdir()
        fields = _double_case(tmp_path / integrator, integrator, csrc)
        assert not all(np.allclose(got, want, **F64) for got, want in fields.values()), integrator


def test_rr_step_faults_apply_once():
    """Each edit of ``chip_probe.RR_STEP_FAULTS`` finds its text once in its
    source, so the probe's seeded copies build what they name."""
    from tests.test_torch_rk4 import _chip_probe

    for name, edits in _chip_probe().RR_STEP_FAULTS.items():
        for file, old, _ in edits:
            assert (cuda_build.CSRC / file).read_text().count(old) == 1, name


def test_rr_faults_and_phase_stamps_apply_once():
    """Each edit of ``chip_probe.RR_FAULTS`` (``rr_step.cuh``), each of the
    clock stamps of ``chip_probe.py rr_phases`` for the lane-spread free ABA
    (applied in order) and each of ``chip_probe.RR_STEP_VARIANTS`` finds its
    text once, so the probe's seeded copies build what they name."""
    from tests.test_torch_rk4 import _chip_probe

    probe = _chip_probe()
    text = (cuda_build.CSRC / "rr_step.cuh").read_text()
    for name, (old, new) in probe.RR_FAULTS.items():
        assert text.count(old) == 1 and old != new, name
    texts = {f: (cuda_build.CSRC / f).read_text() for f in ("rr_step.cuh", "rollout_rr.cu")}
    for file, old, new in probe._PH_COMMON + probe._PH_ABA["lanes"]:
        assert texts[file].count(old) == 1, (file, old)
        texts[file] = texts[file].replace(old, new)
    for name, edits in probe.RR_STEP_VARIANTS.items():
        for file, old, new in edits:
            assert (cuda_build.CSRC / file).read_text().count(old) == 1 and old != new, name


@pytest.mark.parametrize("lanes", (1, 4, 8))
@pytest.mark.parametrize("name", ("humanoid23", "garpez", "box"))
def test_rr_lane_aba_tables(name, lanes):
    """The free ABA's tables in the generated header: each link's place in
    its level (the base's 0), the most children a link has at the base and
    at each level, each link's row among the contact parents, the widest
    level; and every link's parent one level up."""
    eng = _engine(name)
    job = cuda_rollout.job(eng, lanes)
    t = cuda_build._lane_schedule(eng, lanes)
    a = cuda_build.rr_lane_aba(t)
    lam, n_lev, off, links = list(eng.lam), t["n_lev"], t["lev_off"], t["lev_link"]
    level = {0: -1}
    for lev in range(n_lev):
        for n in range(off[lev], off[lev + 1]):
            level[links[n]] = lev
            assert a["pos"][links[n]] == n - off[lev] and level[lam[links[n]]] == lev - 1
    children = [[c for c in range(1, eng.n_links) if lam[c] == i] for i in range(eng.n_links)]
    assert a["pulls"][0] == len(children[0])
    for lev in range(n_lev):
        assert a["pulls"][lev + 1] == max(len(children[i]) for i in links[off[lev] : off[lev + 1]])
    assert a["width"] == max([off[k + 1] - off[k] for k in range(n_lev)], default=1)
    assert [i for i, r in enumerate(a["par"]) if r >= 0] == sorted(set(eng.contact_parent))
    assert all(t["par_link"][r] == i for i, r in enumerate(a["par"]) if r >= 0)
    header = cuda_build.topology_header(eng, job.defines)
    assert f"#define JX_RR_WIDTH {a['width']}\n" in header
    assert f"JX_RR_POS[{eng.n_links}] = {{{', '.join(map(str, a['pos']))}}};" in header


@pytest.mark.parametrize("name", ("humanoid23", "garpez", "box"))
def test_rr_builds_take_a_torque_row(name):
    """The relaxed-rigid builds of K3 and K5 (each policy) name the
    contact model, give the slot a row of torques, and fit a block in 227 KB:
    the model arrays and the candidate's weights once, each env's rows at the
    odd stride; the humanoid takes 64 envs a block (one wave of 8192 envs on
    an H100), so K5's envs a block divide a candidate's 1024 envs."""
    eng = _engine(name)
    n_par = len(set(eng.contact_parent))
    slot = 26 * eng.n_links + 36 + 24 * n_par + eng.n_joints
    n_params = cuda_build.packed_params(eng).numel()
    d = 2 * eng.n_joints + 11
    jobs = {"step": (cuda_step.job(eng), 0, 0)}
    for kind, hidden in (("pd", 0), ("linear", 0), ("mlp", 16)):
        pol = cuda_env_rollout.Policy(kind, hidden=hidden)
        weights = cuda_build.policy_weight_count(eng.n_joints, cuda_env_rollout.POLICY_KINDS[kind], max(hidden, 1))
        jobs[kind] = (cuda_env_rollout.job(eng, pol), weights, pol)
    for label, (job, weights, pol) in jobs.items():
        assert job.source.name == ("step_rr.cu" if label == "step" else "env_rollout_rr.cu")
        defines = _defines(cuda_build.topology_header(eng, job.defines))
        assert defines["JX_CONTACT"] == 1 and defines["JX_RR_TAU_ROW"] == 1 and defines["JX_RR_SLOT"] == slot, label
        hidden_rows = 16 if label == "mlp" and d + 16 + 1 > cuda_build.rr_dead_rows(eng) else 0
        assert defines["JX_RR_ROWS"] == slot + hidden_rows, label
        envs = defines["JX_RR_ENVS"]
        smem = 4 * ((slot + hidden_rows) * (envs + 1) + n_params + weights)
        assert smem <= cuda_build.MAX_SMEM_BYTES and envs * cuda_step.RR_LANES % 32 == 0, label
        if pol:
            assert cuda_env_rollout.envs_per_block(eng, pol) == envs and ES_ENVS_PER_CANDIDATE % envs == 0, label
        if name == "humanoid23":
            assert envs == 64 and slot == 827 and not hidden_rows, label
