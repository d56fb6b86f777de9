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
  start's, and 5 steps end mid-episode; resets and steps equal in every env.

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
# The CUDA names the relaxed-rigid step uses past the soft kernels'.
SHIM = CUDA_SHIM + "inline float __fdiv_rn(float a, float b) { return a / b; }\n"

# The harness is compiled with JX_KERNEL 2 (K2: rollout_rr.cu's body), 3 (K3:
# step_rr.cu's) or 5 (K5: env_rollout_rr.cu's). argv = in.bin out.bin B
# n_steps, then the Scalars' 23 floats in C99 hex (kp, kd the 9th and 10th: K2's and K5's
# gains, and the gains of K3's torques) and (K5) the Options' entries. in.bin
# holds the packed model arrays, the state leaves s, sd, p, q, v, m and (K5)
# the weights; out.bin gets the state leaves after n_steps and (K5) each
# env's reward sum, resets and steps.
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
  const int B = std::atoi(argv[a++]), n_steps = std::atoi(argv[a++]);
  float f[23];
  for (float& x : f) x = std::strtof(argv[a++], nullptr);
  Scalars sc{f[0],  f[1],  f[2],  f[3],  f[4],  f[5],  f[6],  f[7],  f[8],  f[9],  f[10], f[11],
             f[12], f[13], f[14], f[15], f[16], f[17], f[18], f[19], f[20], f[21], f[22]};
  std::vector<float> in;
  {
    FILE* fp = std::fopen(in_path, "rb");
    float x;
    while (std::fread(&x, 4, 1, fp) == 1) in.push_back(x);
    std::fclose(fp);
  }
  const float nan = std::numeric_limits<float>::quiet_NaN();
  const size_t sizes[6] = {size_t(NJ) * B, size_t(NJ) * B, 3u * B, 4u * B, 6u * B, size_t(NCM) * 3 * B};
  size_t total = 0;
  for (size_t n : sizes) total += n;
  const float* params = in.data();
  // The state, one buffer of the leaves in order and a block's envs past it.
  std::vector<float> cur(in.begin() + N_PARAMS, in.begin() + N_PARAMS + total);
  cur.resize(total + ENVS, nan);
  const int blocks = (B + ENVS - 1) / ENVS;
#if JX_KERNEL == 5
  const float* weights = in.data() + N_PARAMS + total;
  const Options o{std::atoi(argv[a]), std::strtof(argv[a + 1], nullptr), std::strtof(argv[a + 2], nullptr),
                  std::atoi(argv[a + 3]), std::strtof(argv[a + 4], nullptr), std::strtof(argv[a + 5], nullptr),
                  static_cast<unsigned>(std::strtoul(argv[a + 6], nullptr, 10)), std::atoi(argv[a + 7])};
  std::vector<float> nxt(total + ENVS, nan), reward(B);
  std::vector<int> resets(B), steps(B);
  const float* ci[6];
  float* no[6];
  size_t off = 0;
  for (int k = 0; k < 6; ++k) {
    ci[k] = cur.data() + off;
    no[k] = nxt.data() + off;
    off += sizes[k];
  }
  const StateIn si{ci[0], ci[1], ci[2], ci[3], ci[4], ci[5]};
  const StateOut so{no[0], no[1], no[2], no[3], no[4], no[5]};
  for (int blk = 0; blk < blocks; ++blk) {
    for (float& x : smem) x = nan;
    shim::run_block(blk, RR_THREADS, [&] {
      env_rollout_rr_kernel(params, weights, si, so, reward.data(), resets.data(), steps.data(), B, n_steps, sc, o);
    });
  }
  cur.swap(nxt);
#else
  const float kp = f[8], kd = f[9];
  std::vector<float> tau(size_t(NJ) * B);
  for (int t = 0; t < n_steps; ++t) {
    std::vector<float> nxt(total + ENVS, nan);
    const float* ci[6];
    float* no[6];
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
      for (float& x : smem) x = nan;
      shim::run_block(blk, RR_THREADS, [&] {
#if JX_KERNEL == 2
        rollout_rr_kernel(params, si, so, B, 1, sc, Rk4Scratch{nullptr, nullptr, 0});
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
  std::fwrite(cur.data(), 4, total, fp);
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


def _build(tmp_path, engine, job, kernel: int):
    """The kernel source of ``job`` up to its ``extern "C"`` block and the
    harness, compiled with g++ for ``engine``'s generated header in a
    directory of ``tmp_path`` of its own."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp_path = tmp_path / f"k{kernel}"
    tmp_path.mkdir()
    text = job.source.read_text()
    (tmp_path / "body.cu").write_text(text[: text.index('extern "C" {')])
    (tmp_path / "cuda_runtime.h").write_text(SHIM)
    header = cuda_build.topology_header(engine, job.defines)
    assert _defines(header)["JX_RR_ENVS"] == ENVS
    (tmp_path / cuda_build.GENERATED_HEADER).write_text(header)
    (tmp_path / "harness.cpp").write_text(HARNESS)
    binary = tmp_path / f"harness{kernel}"
    cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-DJX_KERNEL={kernel}", "-I", str(tmp_path),
           "-I", str(cuda_build.CSRC), str(tmp_path / "harness.cpp"), "-o", str(binary)]  # fmt: skip
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=TIMEOUT_S)
    return binary


def _run(tmp_path, binary, engine, state, n_steps, params, gains, options=(), weights=None) -> np.ndarray:
    arrays = [params, *state.fields(), *(() if weights is None else (weights,))]
    np.concatenate([a.detach().numpy().astype(np.float32).ravel() for a in arrays]).tofile(tmp_path / "in.bin")
    scalars = (*cuda_build.engine_scalars(engine), *gains, *cuda_build.rr_scalars(engine))
    args = [str(binary), str(tmp_path / "in.bin"), str(tmp_path / "out.bin"), str(state.p.shape[-1]), str(n_steps),
            *(float(np.float32(x)).hex() for x in scalars), *map(str, options)]  # fmt: skip
    subprocess.run(args, check=True, capture_output=True, timeout=TIMEOUT_S)
    return np.fromfile(tmp_path / "out.bin", dtype=np.float32)


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


def test_rr_step_faults_apply_once():
    """Each edit of ``chip_probe.RR_STEP_FAULTS`` finds its text once in its
    source, so the probe's seeded copies build what they name."""
    from tests.test_torch_rk4 import _chip_probe

    for name, edits in _chip_probe().RR_STEP_FAULTS.items():
        for file, old, _ in edits:
            assert (cuda_build.CSRC / file).read_text().count(old) == 1, name


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
