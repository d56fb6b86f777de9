"""Per-env domain multipliers, terrain offsets and the terrain-relative
height in the port, on the CPU.

* The multipliers ``Kmul``, ``Dmul``, ``mumul`` equal an engine built with K,
  D and μ scaled, and ``gmul``, ``Mmul`` one with gravity and ``M`` scaled
  (the twin, as ``tests/test_batched_engine.py``'s domain test holds the JAX
  engine).
* K5's plain path (``env_rollout_reference``) with the five multipliers,
  ``terr_off`` and ``terrain_relative`` under an MLP policy, against a JAX
  loop of the JAX package's own pieces (the engine's step under the same
  ``pr``, ``pallas_step._mlp_policy_tau`` with the terrain-relative height
  row, ``_default_reward``, respawn at the start), as JAX's XLA env
  references run (``tests/test_envs.py``); and ``BatchedEnv`` with
  ``terrain_relative`` against the JAX env: observations, rewards and
  terminations. The model is a floating sphere with one collision point and
  one joint on Fourier terrain.
* The bridge carries the Fourier spectrum, a plane and ``terrain_relative``.
* The lane step's terrain and domain body under g++: K1 (``rollout.cu`` with
  JX_TERRAIN 2, JX_DOMAIN and JX_TERR_OFF) built with ``float`` as
  ``double`` on garpez rolled onto its limbs on Fourier terrain, against the
  float64 plain rollout within 1e-9; and K5 (``env_rollout.cu`` with the
  three options) in float32 at ``chip_smoke.TOL`` (the harness of
  ``tests/test_torch_lane_forward.py``).
* The wrappers (``cuda_build.build`` stubbed): K1, K2, K3 and K5 take a plane
  or Fourier engine and the per-env options to the right build and header,
  check the rows' shapes, types and devices, and refuse, each naming its
  ROADMAP item, what stays unported: the RK4 builds, K4 and the
  differentiable step off flat ground or with per-env options, and the
  relaxed-rigid kernels off flat ground or with per-env options.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jaxsim_tpu.api as js
import jaxsim_tpu.envs as jax_envs
import jaxsim_tpu.terrain as jax_terrain
from jaxsim_tpu.ops import pallas_step as ps
from jaxsim_tpu.ops.batched_engine import BatchedEngine as JaxEngine
from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState
from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, bridge, models, terrain
from jaxsim_tpu_torch.api.model import IntegratorType
from jaxsim_tpu_torch.envs import BatchedEnv
from jaxsim_tpu_torch.envs.env import EnvState
from jaxsim_tpu_torch.models.builders import _joint, _link, _sphere_collision, _sphere_inertia
from jaxsim_tpu_torch.ops import cuda_build, cuda_env_rollout, cuda_rollout, cuda_step, cuda_step_vjp, diff_step
from jaxsim_tpu_torch.ops.contacts.relaxed_rigid import RelaxedRigidContacts
from tests.test_torch_lane_forward import F64, ROLLED_QUAT, ROLLED_SPIN, TOL, _build, _fields, _run

torch.set_num_threads(1)

FOURIER = dict(seed=5, num_components=3, amplitude=0.05, wavelength=0.6)
TIER_T1 = dict(rtol=1e-3, atol=5e-4)  # docs/architecture.md tier T, per 10 steps
DOMAIN_SCALES = dict(Kmul=0.3, Dmul=0.3, mumul=0.2, gmul=0.05, Mmul=0.1)  # chip_smoke's exp(σ·N)


def _domain(B: int, rng, terr_off: float | None = None) -> dict[str, np.ndarray]:
    out = {k: np.exp(s * rng.standard_normal(B)) for k, s in DOMAIN_SCALES.items()}
    if terr_off is not None:
        out["terrOff"] = terr_off * rng.standard_normal((2, B))
    return out


# ----- the multipliers by a second engine -----


def test_multipliers_equal_engines_with_scaled_parameters():
    """Two envs of a box on a Fourier terrain, 30 steps with per-env
    multipliers, against one engine per env built with K, D, μ and gravity
    scaled, and with M scaled by call-time model arrays."""
    def model(**kw):
        return JaxSimModel.build_from_model_description(
            models.build_box_urdf(), terrain=terrain.FourierTerrain.build(**FOURIER), **kw)  # fmt: skip

    base = model()
    eng = BatchedEngine.build(base, device="cpu")
    scales = [dict(Kmul=0.5, Dmul=1.0, mumul=1.0, gmul=1.1, Mmul=1.3), dict(Kmul=2.0, Dmul=0.7, mumul=0.3, gmul=0.9, Mmul=0.8)]
    domain = {k: torch.tensor([s[k] for s in scales]) for k in scales[0]}
    st = eng.init_state(2, base_position=(0.0, 0.0, 0.12))
    out = eng.rollout(st, 30, domain=domain)
    for i, s in enumerate(scales):
        p = base.contact_params
        scaled = model(gravity=-base.gravity * s["gmul"]).replace(
            contact_params=dataclasses.replace(p, K=p.K * s["Kmul"], D=p.D * s["Dmul"], mu=p.mu * s["mumul"]))
        eng_i = BatchedEngine.build(scaled, device="cpu")
        ref = eng_i.rollout(eng_i.init_state(1, base_position=(0.0, 0.0, 0.12)), 30, pr={"M": eng_i.M * s["Mmul"]})
        np.testing.assert_allclose(out.p[:, i], ref.p[:, 0], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out.v[:, i], ref.v[:, 0], rtol=1e-4, atol=1e-4)
    assert not torch.allclose(out.p[2, 0], out.p[2, 1])


# ----- K5's plain path and BatchedEnv against the JAX package -----


def _tiny_floating_urdf() -> str:
    """A floating sphere and one revolute joint (test_torch_engine's)."""
    return (
        '<robot name="tiny">'
        + _link("base", 1.0, _sphere_inertia(1.0, 0.1), collision=_sphere_collision(0.1))
        + _joint("j1", "revolute", "base", "tip", xyz=(0, 0, 0.15), axis=(0, 1, 0))
        + _link("tip", 0.3, _sphere_inertia(0.3, 0.05), com=(0, 0, 0.05))
        + "</robot>"
    )


@functools.lru_cache(maxsize=None)
def _tiny():
    """(JAX engine, port engine, JAX terrain) of the floating sphere with
    one collision point on the Fourier terrain."""
    terr = jax_terrain.FourierTerrain.build(**FOURIER)
    old = os.environ.get("JAXSIM_COLLISION_SPHERE_POINTS")
    os.environ["JAXSIM_COLLISION_SPHERE_POINTS"] = "1"
    try:
        model = js.JaxSimModel.build_from_model_description(_tiny_floating_urdf(), terrain=terr)
    finally:
        if old is None:
            os.environ.pop("JAXSIM_COLLISION_SPHERE_POINTS")
        else:
            os.environ["JAXSIM_COLLISION_SPHERE_POINTS"] = old
    jeng = JaxEngine.build(model)
    return jeng, bridge.engine_from_numpy(*bridge.reference_engine_arrays(jeng), device="cpu"), terr


def _tiny_start(B: int, rng, off=None) -> dict[str, np.ndarray]:
    """Envs about the sphere's radius above the terrain under them (with the
    env's offset), 0.08-0.16 m, moving, the joint displaced and moving."""
    jeng, teng, terr = _tiny()
    st = bridge.state_to_numpy(teng.init_state(B))
    st["p"][:2] = 0.3 * rng.standard_normal((2, B))
    x, y = (st["p"][:2] if off is None else st["p"][:2] - off)
    st["p"][2] = np.asarray(terr.height(x, y)) + rng.uniform(0.08, 0.16, B)
    st["v"] = 0.3 * rng.standard_normal((6, B))
    st["s"], st["sd"] = 0.3 * rng.standard_normal((2, 1, B))
    return {k: np.asarray(a, np.float32) for k, a in st.items()}


def test_env_rollout_plain_matches_jax_loop():
    """16 envs, 6 steps, an MLP with H = 8, the five multipliers, terr_off
    = 2·N(0, 1) and the terrain-relative height, episodes of 4 and a
    healthy relative height of (0, 0.12), so that envs end by height and by
    length: the final state, the reward sums, the resets and the steps."""
    jeng, teng, _ = _tiny()
    B, n_steps, H = 16, 6, 8
    rng = np.random.default_rng(4)
    dom = _domain(B, rng, terr_off=2.0)
    arrays = _tiny_start(B, rng, dom["terrOff"])
    d = 2 * jeng.n_joints + 11
    w = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
         for k, s in dict(W1=(H, d), b1=(H, 1), W2=(jeng.n_joints, H), b2=(jeng.n_joints, 1)).items()}  # fmt: skip
    opts = dict(episode_length=4, healthy_z_range=(0.0, 0.12), tau_limit=5.0)

    def loop(init, pr, w):
        """The steps under ``lax.fori_loop``: one step body to trace and
        compile."""
        hrel = lambda s: s.p[2] - jeng._fourier_height_grad(pr, s.p[0], s.p[1])[0]  # noqa: E731
        policy = lambda s: ps._mlp_policy_tau(  # noqa: E731
            s, lambda h, k: w["W1"][h, k], lambda h: w["b1"][h, 0], lambda a, h: w["W2"][a, h],
            lambda a: w["b2"][a, 0], jeng.n_joints, H, opts["tau_limit"], hrel)  # fmt: skip

        def body(_, carry):
            st, rew, resets, steps = carry
            tau = policy(st)
            new = jeng.step(st, tau, pr)
            z = hrel(new)
            done = (z < opts["healthy_z_range"][0]) | (z > opts["healthy_z_range"][1]) | (steps + 1 >= opts["episode_length"])
            st = jax.tree.map(lambda f, x: jnp.where(done, f, x), init, new)
            return st, rew + ps._default_reward(carry[0], tau, new), resets + done, jnp.where(done, 0, steps + 1)

        zeros = jnp.zeros(B, jnp.int32)
        return jax.lax.fori_loop(0, n_steps, body, (init, jnp.zeros(B), zeros, zeros))

    _, params = bridge.reference_engine_arrays(jeng)
    pr = {**{k: jnp.asarray(a) for k, a in params.items()}, **{k: jnp.asarray(a, jnp.float32) for k, a in dom.items()}}
    ref = jax.jit(loop)(JaxState(**{k: jnp.asarray(a) for k, a in arrays.items()}), pr, w)
    tdom = bridge.domain_from_numpy(dom, device="cpu")
    got = cuda_env_rollout.env_rollout(
        teng, bridge.state_from_numpy(arrays, device="cpu"), n_steps, **bridge.policy_weights_from_numpy(device="cpu", **w),
        terr_off=tdom.pop("terrOff"), domain=tdom, terrain_relative=True, **opts)  # fmt: skip
    resets = np.asarray(ref[2])
    assert 0 < int((resets > 0).sum()) and np.array_equal(got[2].numpy(), resets)
    assert np.array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **TIER_T1)
    fields = bridge.reference_state_arrays(ref[0])
    for k, t in bridge.state_to_numpy(got[0]).items():
        np.testing.assert_allclose(t, fields[k], err_msg=k, **TIER_T1)
    # Ended by relative height before its length: the absolute height would
    # end other envs.
    assert int(resets.sum()) > B * (n_steps // opts["episode_length"])


def test_batched_env_terrain_relative_matches_jax_env():
    """``BatchedEnv(terrain_relative=True)`` against the JAX env from the
    same 16 envs (no reset noise, so a respawn is the same on both sides),
    3 steps of seeded actions: each step's observation (its last row the
    terrain-relative height), reward and done."""
    jeng, teng, _ = _tiny()
    B = 16
    rng = np.random.default_rng(6)
    arrays = _tiny_start(B, rng)
    kw = dict(episode_length=5, healthy_z_range=(0.09, 0.14), reset_noise_std=0.0, reset_base_position=(0.0, 0.0, 0.3),
              terrain_relative=True)  # fmt: skip
    jenv, tenv = jax_envs.BatchedEnv(engine=jeng, **kw), BatchedEnv(engine=teng, **kw)
    jst = jax_envs.env.EnvState(sim=JaxState(**{k: jnp.asarray(a) for k, a in arrays.items()}),
                                steps=jnp.zeros(B, jnp.int32), key=jax.random.PRNGKey(0))  # fmt: skip
    tst = EnvState(sim=bridge.state_from_numpy(arrays, device="cpu"), steps=torch.zeros(B, dtype=torch.int32),
                   generator=torch.Generator().manual_seed(0))  # fmt: skip
    np.testing.assert_allclose(tenv._obs(tst.sim).numpy(), np.asarray(jenv._obs(jst.sim)), rtol=1e-6, atol=1e-6)
    jstep = jax.jit(jenv.step)
    dones = 0
    for _ in range(3):
        action = (2.0 * rng.standard_normal((1, B))).astype(np.float32)
        jst, jobs, jrew, jdone = jstep(jst, jnp.asarray(action))
        tst, tobs, trew, tdone = tenv.step(tst, torch.from_numpy(action))
        assert np.array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TIER_T1)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **TIER_T1)
        dones += int(tdone.sum())
    assert 0 < dones < 3 * B
    with pytest.raises(ValueError, match="FourierTerrain"):
        BatchedEnv(engine=BatchedEngine.build(JaxSimModel.build_from_model_description(models.build_box_urdf()),
                                              device="cpu"), terrain_relative=True)  # fmt: skip


def test_fused_eval_rollout_takes_the_domain():
    """``BatchedEnv.fused_eval_rollout(domain=)`` pops ``terrOff`` out of the
    domain and runs K5 (its plain version on the CPU) with the multipliers,
    the offset and the env's ``terrain_relative``; misshapen rows and
    unknown names raise."""
    _, teng, _ = _tiny()
    B = 8
    env = BatchedEnv(engine=teng, reset_base_position=(0.0, 0.0, 0.12), healthy_z_range=(0.09, 0.2),
                     terrain_relative=True, episode_length=3)  # fmt: skip
    dom = bridge.domain_from_numpy(_domain(B, np.random.default_rng(3), terr_off=1.0), device="cpu")
    got = env.fused_eval_rollout(torch.Generator().manual_seed(0), B, 4, domain=dom)
    sim = env._fresh_sim(B, torch.Generator().manual_seed(0))
    rows = {k: t for k, t in dom.items() if k != "terrOff"}
    want = cuda_env_rollout.env_rollout_reference(
        teng, sim, 4, domain=rows, terr_off=dom["terrOff"], terrain_relative=True, episode_length=3,
        healthy_z_range=(0.09, 0.2),
    )  # fmt: skip
    for a, b in zip((*got[0].fields(), got[1], got[2]), (*want[0].fields(), want[1], want[2])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        env.fused_eval_rollout(torch.Generator(), B, 1, domain={"Kmul": torch.ones(B + 1)})
    with pytest.raises(ValueError, match="shape"):
        env.fused_eval_rollout(torch.Generator(), B, 1, domain={"terrOff": torch.ones(3, B)})
    with pytest.raises(ValueError, match="unknown"):
        env.fused_eval_rollout(torch.Generator(), B, 1, domain={"Kscale": torch.ones(B)})


def test_bridge_carries_terrain_and_env():
    jeng, teng, terr = _tiny()
    assert teng.terrain_kind == "fourier" and teng.PARAM_NAMES[-1] == "terr"
    assert np.array_equal(teng.terr.numpy(), terr.spectrum().astype(np.float32))
    assert teng.terrain_offset == terr._h0
    plane = JaxEngine.build(js.JaxSimModel.build_from_model_description(
        models.build_box_urdf(), terrain=jax_terrain.PlaneTerrain.build(0.05, normal=(0.1, 0.0, 1.0))))  # fmt: skip
    tplane = bridge.engine_from_numpy(*bridge.reference_engine_arrays(plane), device="cpu")
    assert (tplane.terrain, tplane.terrain_normal, tplane.terrain_offset) == (
        "plane", plane.terrain_normal, plane.terrain_offset)  # fmt: skip
    port_plane = BatchedEngine.build(JaxSimModel.build_from_model_description(
        models.build_box_urdf(), terrain=terrain.PlaneTerrain.build(0.05, normal=(0.1, 0.0, 1.0))), device="cpu")  # fmt: skip
    assert (port_plane.terrain_normal, port_plane.terrain_offset) == (tplane.terrain_normal, tplane.terrain_offset)
    fields = bridge.reference_env_fields(jax_envs.BatchedEnv(engine=jeng, terrain_relative=True))
    assert fields["terrain_relative"] and bridge.env_from_numpy(fields, teng).terrain_relative
    pr = bridge.reference_params_arrays(jeng.params())
    assert np.array_equal(bridge.params_from_numpy(pr, device="cpu")["terr"].numpy(), teng.terr.numpy())
    dom = _domain(4, np.random.default_rng(0), terr_off=1.0)
    back = bridge.domain_to_numpy(bridge.domain_from_numpy(dom, device="cpu"))
    assert all(np.array_equal(back[k], dom[k].astype(np.float32)) for k in dom)


# ----- the lane step's terrain and domain body under g++ -----


@functools.lru_cache(maxsize=None)
def _garpez_rough(dtype=torch.float32) -> BatchedEngine:
    model = JaxSimModel.build_from_model_description(
        models.build_garpez_urdf(), terrain=terrain.FourierTerrain.build(**FOURIER))  # fmt: skip
    return BatchedEngine.build(model, device="cpu").to(dtype)


def _rolled_rough(eng: BatchedEngine, B: int, off: torch.Tensor):
    """Garpez rolled onto its limbs (test_torch_lane_forward's start), its
    base spinning, its joints displaced and moving, each env lowered until
    its deepest point is 4 mm into the terrain under it (the env's own
    patch, by its offset): child links' points in contact on slopes."""
    rng = np.random.default_rng(0)
    dtype = eng.S.dtype
    st = {k: np.asarray(v, np.float64) for k, v in bridge.state_to_numpy(eng.init_state(B)).items()}
    st["q"] = np.tile((np.asarray(ROLLED_QUAT) / np.linalg.norm(ROLLED_QUAT))[:, None], (1, B))
    st["s"] = 1.2 * rng.standard_normal(st["s"].shape)
    st["sd"] = 0.3 * rng.standard_normal(st["sd"].shape)
    st["v"][:3] = 0.1 * rng.standard_normal((3, B))
    st["v"][3:] = np.asarray(ROLLED_SPIN)[:, None]
    st["p"][2] = 0.0
    pr = eng.params({"terrOff": off})

    def gap(state):
        g = eng._point_geometry(*eng.fk(state), pr)
        h, dhx, dhy = eng._fourier_height_grad(pr, g["pc"][0], g["pc"][1])
        return g["pc"][2] - h, 1.0 / torch.sqrt(dhx * dhx + dhy * dhy + 1.0)

    st["p"][2] = -(gap(bridge.state_from_numpy(st, device="cpu", dtype=dtype))[0].min(0).values.numpy() + 0.004)
    state = bridge.state_from_numpy(st, device="cpu", dtype=dtype)
    z, nz = gap(state)
    parents = torch.tensor(eng.contact_parent)
    assert sum(bool((z[parents == i] < 0).any()) for i in range(1, eng.n_links)) >= 2
    assert int(((z < 0) & (nz < 0.99)).sum()) >= B
    return state


def test_k1_rough_domain_body_in_double_matches_float64_plain(tmp_path):
    """K1's body with JX_TERRAIN 2, JX_DOMAIN and JX_TERR_OFF, built with
    ``float`` as ``double``: 3 envs (the block's others past the batch), 3
    steps, terrOff 10·N(0, 1), against the float64 plain rollout within 1e-9
    in every field."""
    eng = _garpez_rough(torch.float64)
    B, n_steps, kp, kd = 3, 3, 60.0, 0.5
    rng = np.random.default_rng(2)
    dom = {k: torch.from_numpy(a) for k, a in _domain(B, rng, terr_off=10.0).items()}
    off = dom.pop("terrOff")
    state = _rolled_rough(eng, B, off)
    binary = _build(tmp_path, eng, cuda_rollout.job(eng, domain=True, terr_off=True), 1, double=True)
    mul = torch.stack([dom[k] for k in DOMAIN_SCALES])
    flat = _run(tmp_path, binary, eng, state, n_steps, (*cuda_build.engine_scalars(eng), kp, kd), double=True,
                rows=(mul, off))  # fmt: skip
    got, _ = _fields(flat, state)
    want = cuda_rollout.rollout_reference(eng, state, n_steps, kp, kd, domain=dom, terr_off=off)
    for name, w in zip(bridge.STATE_FIELDS, want.fields()):
        np.testing.assert_allclose(got[name], w.numpy(), err_msg=name, **F64)
    # The offsets and multipliers reach the state: without them it differs.
    bare = cuda_rollout.rollout_reference(eng, state, n_steps, kp, kd)
    assert float((bare.sd - want.sd).abs().max()) > 1e-3


def test_k5_rough_domain_body_matches_plain(tmp_path):
    """K5's body with the three options (the five multipliers, terr_off and
    the terrain-relative height) in float32: one block of envs, an MLP with
    H = 8, 8 steps, episodes of 4, a healthy relative height that ends some
    envs early, against the plain version at chip_smoke.TOL (equal resets
    and steps)."""
    eng = _garpez_rough()
    n, d, H = eng.n_joints, 2 * eng.n_joints + 11, 8
    rng = np.random.default_rng(12)

    def w(*shape):
        return torch.from_numpy((0.2 * rng.standard_normal(shape)).astype(np.float32))

    pol = cuda_env_rollout.make_policy(eng, W1=w(1, H, d), b1=w(1, H, 1), W2=w(1, n, H), b2=w(1, n, 1))
    B = cuda_env_rollout.envs_per_block(eng, pol, terrain_rel=True)
    dom = {k: torch.from_numpy(a.astype(np.float32)) for k, a in _domain(B, rng, terr_off=10.0).items()}
    off = dom.pop("terrOff")
    state = _rolled_rough(eng, B, off)
    opts = dict(episode_length=4, healthy_z_range=(0.02, 0.3), tau_limit=5.0)
    binary = _build(tmp_path, eng, cuda_env_rollout.job(eng, pol, domain=True, terr_off=True, terrain_rel=True), 5)
    options = (opts["episode_length"], *(float(np.float32(z)).hex() for z in opts["healthy_z_range"]), 1,
               float(np.float32(opts["tau_limit"])).hex(), float(np.float32(0.0)).hex(), 0, B)  # fmt: skip
    mul = torch.stack([dom[k] for k in DOMAIN_SCALES])
    flat = _run(tmp_path, binary, eng, state, 8, (*cuda_build.engine_scalars(eng), 60.0, 0.5), options, pol.packed(),
                rows=(mul, off))  # fmt: skip
    got, at = _fields(flat, state)
    final, reward, resets, steps = cuda_env_rollout.env_rollout_reference(
        eng, state, 8, W1=pol.weights[0], b1=pol.weights[1], W2=pol.weights[2], b2=pol.weights[3], domain=dom,
        terr_off=off, terrain_relative=True, **opts,
    )  # fmt: skip
    sums = flat[at:].reshape(B, 3)
    assert np.array_equal(sums[:, 1], resets.numpy()) and np.array_equal(sums[:, 2], steps.numpy())
    assert int(resets.sum()) > B * 2  # some envs end by their relative height
    assert float(np.abs(sums[:, 0] - reward.numpy()).max()) <= TOL
    for name, t in zip(bridge.STATE_FIELDS, final.fields()):
        assert float(np.abs(got[name] - t.numpy()).max(initial=0.0)) <= TOL, name


# ----- the wrappers -----


class _Built(Exception):
    """Raised by a stub of ``cuda_build.build`` with the job it was given."""


def _job_built(call, monkeypatch) -> cuda_build.BuildJob:
    """The job ``call()`` builds on a state its kernel would take, without
    nvcc: the stub of ``cuda_build.build`` stops it there."""

    def stub(job):
        raise _Built(job)

    monkeypatch.setattr(cuda_build, "is_cpu", lambda state, what: False)
    monkeypatch.setattr(cuda_build, "build", stub)
    with pytest.raises(_Built) as built:
        call()
    return built.value.args[0]


def _defines(eng, job) -> dict[str, str]:
    header = cuda_build.topology_header(eng, job.defines)
    return dict(ln.split()[1:3] for ln in header.splitlines() if ln.startswith("#define"))


@functools.lru_cache(maxsize=None)
def _engines(integrator=IntegratorType.SemiImplicitEuler, contact_model=None) -> dict[str, BatchedEngine]:
    out = {}
    for kind, terr in (("flat", None), ("plane", terrain.PlaneTerrain.build(0.05, normal=(0.1, 0.0, 1.0))),
                       ("fourier", terrain.FourierTerrain.build(seed=0, num_components=8, amplitude=0.04, wavelength=0.7))):  # fmt: skip
        if kind == "fourier" and contact_model is not None:
            continue
        model = JaxSimModel.build_from_model_description(models.build_garpez_urdf(), terrain=terr,
                                                         integrator=integrator, contact_model=contact_model)  # fmt: skip
        out[kind] = BatchedEngine.build(model, device="cpu")
    return out


@pytest.mark.parametrize("kind", ["plane", "fourier"])
def test_wrappers_take_terrain_and_options(kind, monkeypatch):
    """K1, K2, K3 and K5 build their soft sources for the engine's terrain:
    the header's JX_TERRAIN (and the plane's normal, the Fourier terrain's
    components), the packed arrays ending with the spectrum; K1 and K5 each
    per-env option as a define, K5's terrain-relative height as a slot row
    past its hidden units; a flat build's header has no terrain in it."""
    eng = _engines()[kind]
    B = 64
    st = eng.init_state(B)
    ones = torch.ones(B)
    off = dict(terr_off=torch.zeros(2, B)) if kind == "fourier" else {}
    mlp = dict(W1=torch.zeros(1, 16, 2 * eng.n_joints + 11), b1=torch.zeros(1, 16, 1),
               W2=torch.zeros(1, eng.n_joints, 16), b2=torch.zeros(1, eng.n_joints, 1))  # fmt: skip
    calls = dict(
        rollout=(lambda: cuda_rollout.rollout(eng, st, 1, domain={"Kmul": ones}, **off), "rollout.cu"),
        step_pd=(lambda: cuda_step.step_pd(eng, st), "step.cu"),
        step_tau=(lambda: cuda_step.step_tau(eng, st, torch.zeros_like(st.s), {"M": eng.M}), "step.cu"),
        env_rollout=(lambda: cuda_env_rollout.env_rollout(eng, st, 1, domain={"gmul": ones}, **off, **mlp,
                                                          terrain_relative=kind == "fourier"), "env_rollout.cu"),  # fmt: skip
    )
    for name, (call, source) in calls.items():
        job = _job_built(call, monkeypatch)
        assert job.source.name == source, name
        defines = _defines(eng, job)
        assert defines["JX_TERRAIN"] == ("2" if kind == "fourier" else "1"), name
        if kind == "fourier":
            assert defines["JX_TERR_K"] == "8" and defines.get("JX_TERR_OFF") == ("1" if name in ("rollout", "env_rollout") else None)
        else:
            assert float.fromhex(defines["JX_TERR_NX"][:-1]) == float(np.float32(eng.terrain_normal[0]))
        assert defines.get("JX_DOMAIN") == ("1" if name in ("rollout", "env_rollout") else None), name
    packed = cuda_build.packed_params(eng)
    if kind == "fourier":
        assert torch.equal(packed[-32:], eng.terr.reshape(-1))
        t = cuda_build.lane_tables(eng, 4, forward=True, policy=2, hidden=16, terrain_rel=True)
        assert t["env_floats"] == eng.n_joints + 16 + 1
    flat = _engines()["flat"]
    assert "JX_TERR" not in cuda_build.topology_header(flat, cuda_rollout.job(flat).defines)


def test_wrappers_check_the_rows(monkeypatch):
    """The multipliers are (B,) and terr_off (2, B), float32 on the engine's
    device; unknown names and terr_off off Fourier terrain raise before any
    build."""
    engines = _engines()
    eng, plane = engines["fourier"], engines["plane"]
    B = 64
    st = eng.init_state(B)
    monkeypatch.setattr(cuda_build, "is_cpu", lambda state, what: False)
    bad = [
        (dict(domain={"Kmul": torch.ones(B + 1)}), "shape"),
        (dict(domain={"Kmul": torch.ones(B, dtype=torch.float64)}), "float32"),
        (dict(domain={"Kmul": torch.ones(B, device="meta")}), "meta"),
        (dict(domain={"Kscale": torch.ones(B)}), "unknown"),
        (dict(domain={"terrOff": torch.ones(2, B)}), "terr_off"),
        (dict(terr_off=torch.ones(3, B)), "shape"),
    ]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            cuda_rollout.rollout(eng, st, 1, **kw)
    with pytest.raises(ValueError, match="Fourier"):
        cuda_rollout.rollout(plane, plane.init_state(B), 1, terr_off=torch.zeros(2, B))
    with pytest.raises(ValueError, match="Fourier"):
        cuda_env_rollout.env_rollout(plane, plane.init_state(B), 1, terrain_relative=True)


def test_what_stays_refused(monkeypatch):
    """Each refusal names its ROADMAP item, before any build: the RK4 builds
    off flat ground or with per-env options (soft and relaxed-rigid), K4 and
    the differentiable step off flat ground or with per-env options (K4-rr
    too), K3 with per-env options (K3-rr too), and a Python closure on the
    card (Queue 2 item 6); the engine refuses heightmap terrain (Queue 1
    item 8) and rigid contacts (item 6). (The relaxed-rigid kernels now take
    a plane, Fourier terrain and the per-env rows: ``tests/test_torch_rough_rr.py``.)"""
    monkeypatch.setattr(cuda_build, "is_cpu", lambda state, what: False)
    B = 64
    rk4 = _engines(IntegratorType.RungeKutta4)
    for kind in ("plane", "fourier"):
        with pytest.raises(ValueError, match="Queue 2 item 6"):
            cuda_rollout.rollout(rk4[kind], rk4[kind].init_state(B), 1)
    with pytest.raises(ValueError, match="Queue 2 item 6"):
        cuda_rollout.rollout(rk4["flat"], rk4["flat"].init_state(B), 1, domain={"Kmul": torch.ones(B)})
    soft = _engines()
    for kind in ("plane", "fourier"):
        eng, st = soft[kind], soft[kind].init_state(B)
        with pytest.raises(ValueError, match="Queue 2 item 6"):
            cuda_step_vjp.step_vjp(eng, st, torch.zeros_like(st.s), st)
        with pytest.raises(ValueError, match="Queue 2 item 6"):
            diff_step.fused_diff_step(eng)
        with pytest.raises(ValueError, match="Queue 2 item 6"):
            diff_step.fused_diff_rollout(eng, 2)
    flat, st = soft["flat"], soft["flat"].init_state(B)
    with pytest.raises(ValueError, match="Queue 2 item 6"):
        cuda_step.step_tau(flat, st, torch.zeros_like(st.s), {"Kmul": torch.ones(B)})
    with pytest.raises(ValueError, match="Queue 2 item 6"):  # a Python closure on the card
        cuda_env_rollout.check_options(flat, torch.device("cuda"), policy=lambda s: s.s)
    with pytest.raises(ValueError, match="Queue 2 item 6"):
        cuda_step.rollout_per_step(flat, st, 1, policy=lambda s: s.s)
    with pytest.raises(ValueError, match="Queue 2 item 6"):
        diff_step.fused_diff_rollout(flat, 2, params_grad=True)(st, lambda s: torch.zeros_like(s.s), pr={"gmul": torch.ones(B)})
    rr = _engines(contact_model=RelaxedRigidContacts())
    rr_rk4 = _engines(IntegratorType.RungeKutta4, RelaxedRigidContacts())
    plane, st = rr["plane"], rr["plane"].init_state(B)
    with pytest.raises(ValueError, match="Queue 2 item 6"):
        cuda_rollout.rollout(rr_rk4["plane"], rr_rk4["plane"].init_state(B), 1)
    with pytest.raises(ValueError, match="Queue 2 item 6"):
        cuda_rollout.rollout(rr_rk4["flat"], rr_rk4["flat"].init_state(B), 1, domain={"gmul": torch.ones(B)})
    with pytest.raises(ValueError, match="Queue 2 item 6"):
        cuda_step_vjp.step_vjp(plane, st, torch.zeros_like(st.s), st)
    with pytest.raises(ValueError, match="Queue 2 item 6"):
        cuda_step.step_tau(plane, st, torch.zeros_like(st.s), {"gmul": torch.ones(B)})
    static, params = bridge.reference_engine_arrays(_tiny()[0])
    with pytest.raises(ValueError, match="Queue 1 item 8"):
        bridge.engine_from_numpy({**static, "terrain_kind": "heightmap"}, params, device="cpu")
    with pytest.raises(ValueError, match="Queue 1 item 6"):
        bridge.engine_from_numpy({**static, "contact_model": "rigid"}, params, device="cpu")
