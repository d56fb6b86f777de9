"""The port's plain-torch engine (the CPU twin) against the JAX BatchedEngine.

Both engines get the same model arrays (through the bridge) and the same
state and inputs, made with NumPy from a fixed seed. Tolerances are the
float32 tiers of docs/architecture.md: K for kinematics, C for contacts, D
for dynamics and T for trajectories.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jaxsim_tpu.api as js
from jaxsim_tpu.ops.batched_engine import BatchedEngine as JaxEngine
from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState
from jaxsim_tpu.terrain import PlaneTerrain
from jaxsim_tpu_torch import bridge, models
from jaxsim_tpu_torch.models.builders import _joint, _link, _sphere_collision, _sphere_inertia
from tests.test_torch_lowering import _lumped_chain_urdf

torch.set_num_threads(1)

TIER_K = dict(rtol=2e-5, atol=1e-6)
TIER_C = dict(rtol=1e-3, atol=1e-4)
TIER_D = dict(rtol=2e-3, atol=2e-3)  # accelerations: the tier's upper end


def tier_t(n_steps):
    return dict(rtol=1e-3, atol=5e-4 * max(1, n_steps / 10))


def _tiny_floating_urdf() -> str:
    """Floating sphere base with ONE collision point + one revolute joint
    (the small contact model of tests/test_batched_engine.py)."""
    return (
        '<robot name="tiny">'
        + _link("base", 1.0, _sphere_inertia(1.0, 0.1), collision=_sphere_collision(0.1))
        + _joint("j1", "revolute", "base", "tip", xyz=(0, 0, 0.15), axis=(0, 1, 0))
        + _link("tip", 0.3, _sphere_inertia(0.3, 0.05), com=(0, 0, 0.05))
        + "</robot>"
    )


# name: (URDF, sphere points, terrain, base height range, B)
CASES = {
    "pendulum1": (lambda: models.build_pendulum_urdf(1), None, None, (0.0, 0.0), 16),
    "sphere8": (lambda: models.build_sphere_urdf(), "8", None, (0.08, 0.2), 64),
    "tiny_floating": (_tiny_floating_urdf, "1", None, (0.07, 0.12), 64),
    "sphere8_plane": (
        lambda: models.build_sphere_urdf(),
        "8",
        PlaneTerrain.build(0.02, normal=(0.1, -0.05, 1.0)),
        (0.08, 0.2),
        64,
    ),
    # A lumped fixed joint and a prismatic joint.
    "lumped_chain": (_lumped_chain_urdf, None, None, (0.03, 0.08), 32),
    "humanoid23": (lambda: models.build_humanoid_urdf(), None, None, (0.86, 0.9), 8),
}


def _random_state(n, m_rows, B, z_range, rng):
    q = np.concatenate([np.ones((1, B)), 0.05 * rng.standard_normal((3, B))])
    return dict(
        s=0.3 * rng.standard_normal((n, B)),
        sd=0.5 * rng.standard_normal((n, B)),
        p=np.concatenate(
            [0.05 * rng.standard_normal((2, B)), rng.uniform(*z_range, size=(1, B))]
        ),
        q=q / np.linalg.norm(q, axis=0),
        v=0.3 * rng.standard_normal((6, B)),
        m=1e-3 * rng.standard_normal((m_rows, 3, B)),
    )


# The humanoid compiles once, in test_humanoid_step_parts, and its
# trajectory runs in test_humanoid_rollout_100_steps (slow).
SMALL_CASES = sorted(set(CASES) - {"humanoid23"})
CONTACT_CASES = sorted(set(SMALL_CASES) - {"pendulum1"})


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX engine, port engine, state arrays, tau, f_ext) for a case."""
    urdf, sphere_points, terrain, z_range, B = CASES[name]
    old = os.environ.get("JAXSIM_COLLISION_SPHERE_POINTS")
    if sphere_points is not None:
        os.environ["JAXSIM_COLLISION_SPHERE_POINTS"] = sphere_points
    try:
        kwargs = {} if terrain is None else dict(terrain=terrain)
        model = js.JaxSimModel.build_from_model_description(urdf(), **kwargs)
    finally:
        if old is None:
            os.environ.pop("JAXSIM_COLLISION_SPHERE_POINTS", None)
        else:
            os.environ["JAXSIM_COLLISION_SPHERE_POINTS"] = old
    if name == "humanoid23":
        model = model.replace(
            contact_params=js.contact.estimate_good_contact_parameters(
                model,
                number_of_active_collidable_points_steady_state=8,
                max_penetration=0.006,
                damping_ratio=0.15,
            )
        )
    jeng = JaxEngine.build(model)
    teng = bridge.engine_from_numpy(*bridge.reference_engine_arrays(jeng), device="cpu")
    rng = np.random.default_rng(7)
    arrays = {
        k: a.astype(np.float32)
        for k, a in _random_state(jeng.n_joints, jeng.m_rows, B, z_range, rng).items()
    }
    tau = (5.0 * rng.standard_normal((jeng.n_joints, B))).astype(np.float32)
    f_ext = (5.0 * rng.standard_normal((jeng.n_links, 6, B))).astype(np.float32)
    return jeng, teng, arrays, tau, f_ext


def _jstate(arrays):
    return JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()})


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX engine's fk, contacts, ABA (with f_ext) and step on the case's
    inputs, traced and compiled once: compiling the humanoid dominates. The
    engine's fk and contact law are jitted on a copy of it and called with
    the arrays the step passes them, so that the step's own calls of them
    reuse their traces (the same arithmetic; the humanoid's trace takes a
    fifth less time)."""
    import dataclasses

    jeng, _, arrays, tau, f_ext = _case(name)
    eng = dataclasses.replace(jeng)
    for stage in ("fk", "soft_contact_forces"):
        object.__setattr__(eng, stage, jax.jit(getattr(eng, stage)))

    def run(st, tau, fl, pr):
        W = eng.fk(st, pr)
        contacts = eng.soft_contact_forces(*W, st.m, pr) if eng.n_points else None
        return dict(fk=W, contacts=contacts, aba=eng.aba(st, *W, fl, tau, pr), step=eng.step(st, tau, pr))

    fl = [jnp.asarray(f_ext[i]) for i in range(jeng.n_links)]
    return jax.jit(run)(_jstate(arrays), jnp.asarray(tau), fl, jeng.params())


def _close(got, ref, tol, what):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64), err_msg=what, **tol
    )


def _check_fk(name):
    jeng, teng, arrays, _, _ = _case(name)
    ref = _reference(name)["fk"]
    got = teng.fk(bridge.state_from_numpy(arrays, device="cpu"))
    for name, r, g in zip(("W_R", "W_p", "W_v"), ref, got):
        for i in range(jeng.n_links):
            _close(g[i], r[i], TIER_K, f"{name}[{i}]")


def _contact_regimes(teng, W_R, W_p, W_v, m):
    """Counts of (above ground, sticking, sliding) points, by the contact law."""
    eps = np.finfo(np.float32).eps
    a = np.asarray(teng.terrain_normal)[:, None]
    out = np.zeros(3, dtype=int)
    for c, parent in enumerate(teng.contact_parent):
        R, p, v = (np.asarray(x[parent], dtype=np.float64) for x in (W_R, W_p, W_v))
        pc = np.einsum("ijb,j->ib", R, teng.cpoint[c].numpy()) + p
        pd = v[0:3] + np.cross(v[3:6], pc, axis=0)
        delta = np.maximum(0.0, teng.terrain_offset - (a * pc).sum(0))
        ndotv = (a * pd).sum(0)
        dp, dq = (delta + eps) ** teng.hc_p, (delta + eps) ** teng.hc_q
        fn = np.maximum(0.0, teng.K * dp * delta - teng.D * dq * ndotv * (delta > 0))
        mc = m[c].astype(np.float64)
        f_t = -(teng.K * dp * (mc - a * (a * mc).sum(0)) + teng.D * dq * (pd - a * ndotv))
        stick = (f_t**2).sum(0) <= (teng.mu * fn) ** 2
        out += [np.sum(delta <= 0), np.sum((delta > 0) & stick), np.sum((delta > 0) & ~stick)]
    return out


def _check_contacts(name):
    jeng, teng, arrays, _, _ = _case(name)
    ref_f, ref_md = _reference(name)["contacts"]
    W = teng.fk(bridge.state_from_numpy(arrays, device="cpu"))
    got_f, got_md = teng.soft_contact_forces(*W, bridge.state_from_numpy(arrays, device="cpu").m)
    for i in range(jeng.n_links):
        assert (got_f[i] is None) == (ref_f[i] is None), i
        if ref_f[i] is not None:
            _close(got_f[i], ref_f[i], TIER_C, f"f_links[{i}]")
    _close(got_md, ref_md, TIER_C, "m_dot")
    if name != "humanoid23":  # the humanoid starts standing: feet stick
        above, sticking, sliding = _contact_regimes(teng, *W, arrays["m"])
        assert above > 0 and sticking > 0 and sliding > 0, (above, sticking, sliding)


def _check_aba(name):
    jeng, teng, arrays, tau, f_ext = _case(name)
    ref = _reference(name)["aba"]
    tst = bridge.state_from_numpy(arrays, device="cpu")
    got = teng.aba(tst, *teng.fk(tst), [torch.from_numpy(f) for f in f_ext], torch.from_numpy(tau))
    _close(got[0], ref[0], TIER_D, "W_a")
    _close(got[1], ref[1], TIER_D, "sdd")


def _check_step(name):
    jeng, teng, arrays, tau, _ = _case(name)
    ref = bridge.reference_state_arrays(_reference(name)["step"])
    got = bridge.state_to_numpy(teng.step(bridge.state_from_numpy(arrays, device="cpu"), torch.from_numpy(tau)))
    for k in bridge.STATE_FIELDS:
        _close(got[k], ref[k], tier_t(1), k)


@pytest.mark.parametrize("name", SMALL_CASES)
def test_fk(name):
    _check_fk(name)


@pytest.mark.parametrize("name", CONTACT_CASES)
def test_soft_contact_forces(name):
    _check_contacts(name)


@pytest.mark.parametrize("name", SMALL_CASES)
def test_aba(name):
    _check_aba(name)


@pytest.mark.parametrize("name", SMALL_CASES)
def test_step(name):
    _check_step(name)


def test_humanoid_step_parts():
    """fk (tier K), contacts (C), ABA (D) and one step (T) of the flagship."""
    for check in (_check_fk, _check_contacts, _check_aba, _check_step):
        check("humanoid23")


def _rollout_matches(jeng, teng, arrays, n_steps):
    ref = bridge.reference_state_arrays(jax.jit(lambda st: jeng.rollout(st, n_steps))(_jstate(arrays)))
    got = bridge.state_to_numpy(teng.rollout(bridge.state_from_numpy(arrays, device="cpu"), n_steps))
    for k in bridge.STATE_FIELDS:
        _close(got[k], ref[k], tier_t(n_steps), k)


@pytest.mark.parametrize("name", SMALL_CASES)
def test_rollout_20_steps(name):
    jeng, teng, arrays, _, _ = _case(name)
    _rollout_matches(jeng, teng, arrays, 20)


@pytest.mark.slow
def test_humanoid_rollout_100_steps():
    model = js.JaxSimModel.build_from_model_description(models.build_humanoid_urdf())
    model = model.replace(
        contact_params=js.contact.estimate_good_contact_parameters(
            model,
            number_of_active_collidable_points_steady_state=8,
            max_penetration=0.006,
            damping_ratio=0.15,
        )
    )
    jeng = JaxEngine.build(model)
    teng = bridge.engine_from_numpy(*bridge.reference_engine_arrays(jeng), device="cpu")
    rng = np.random.default_rng(3)
    B = 8
    p = np.concatenate([0.01 * rng.standard_normal((2, B)), 0.9 + 0.01 * rng.standard_normal((1, B))])
    arrays = bridge.state_to_numpy(teng.init_state(B))
    arrays["p"] = p.astype(np.float32)
    _rollout_matches(jeng, teng, arrays, 100)


@pytest.mark.parametrize("name", SMALL_CASES)
def test_float64_twin_runs(name):
    """The float64 option for fault triage: same model, twice the width."""
    jeng, _, arrays, tau, _ = _case(name)
    teng = bridge.engine_from_numpy(
        *bridge.reference_engine_arrays(jeng), device="cpu", dtype=torch.float64
    )
    out = teng.step(bridge.state_from_numpy(arrays, device="cpu", dtype=torch.float64), torch.from_numpy(tau).double())
    assert all(t.dtype == torch.float64 and torch.isfinite(t).all() for t in out.fields())
