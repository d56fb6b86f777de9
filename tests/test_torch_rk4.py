"""RK4 and RK4-fast in the port against the JAX package's.

The twin's step (``BatchedEngine.step`` with ``integrator`` ``"rk4"`` or
``"rk4fast"``, RK4-fast freezing the contact forces and ṁ at the step's
start) against the JAX engine's on the same NumPy inputs: a box in contact
with soft and with relaxed-rigid contacts and the fixed-base 2-link pendulum, in
float32 at the relaxed-rigid tests' tolerances (``BOX_TOL``, ``M_RTOL``) and
in float64 to 1e-9 after each of 5 steps; the quaternion's Baumgarte term;
a soft RK4 step's VJP under autograd against ``jax.vjp`` (a floating
sphere on a joint, in contact, and the pendulum); K1's plain path
against the JAX fused rollout of an RK4 engine in Pallas interpret mode;
the bridge and the model carrying the integrator; and K2-K5 refusing an RK4
engine, which K1 takes. Under ``slow``: garpez with relaxed-rigid contacts
and the humanoid. Tests marked ``gpu`` hold K1's RK4 and RK4-fast builds,
soft and relaxed-rigid, against their plain versions on the card and skip
without one; they import no JAX:

    python -m pytest -q tests/test_torch_rk4.py
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_rk4.py
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, bridge, models
from jaxsim_tpu_torch.api.model import IntegratorType
from jaxsim_tpu_torch.models.builders import _joint, _link, _sphere_collision, _sphere_inertia
from jaxsim_tpu_torch.ops import cuda_build, cuda_env_rollout, cuda_rollout, cuda_step, cuda_step_vjp
from jaxsim_tpu_torch.ops.contacts.relaxed_rigid import RelaxedRigidContacts

torch.set_num_threads(1)

INTEGRATORS = ("rk4", "rk4fast")
F64 = dict(rtol=1e-9, atol=1e-9)
# test_torch_relaxed_rigid.py's BOX_TOL and M_RTOL: the JAX package's
# tolerances for a relaxed-rigid box over 5 steps, and m 1e-3 relative to its
# largest entry. The pendulum's joint fields at the same rtol.
BOX_TOL = dict(p=dict(rtol=1e-3, atol=1e-5), q=dict(rtol=1e-3, atol=1e-5), v=dict(rtol=2e-3, atol=2e-4))
PENDULUM_TOL = dict(s=dict(rtol=1e-3, atol=1e-5), sd=dict(rtol=2e-3, atol=2e-4))
M_RTOL = 1e-3


def _tiny_floating_urdf() -> str:
    """A floating sphere and one revolute joint, as in
    ``tests/test_torch_autograd.py``, built with one collision point on the
    sphere (``SPHERE_POINTS``): a contact and a torque in a graph whose VJP
    compiles in seconds."""
    return (
        '<robot name="tiny">'
        + _link("base", 1.0, _sphere_inertia(1.0, 0.1), collision=_sphere_collision(0.1))
        + _joint("j1", "revolute", "base", "tip", xyz=(0, 0, 0.15), axis=(0, 1, 0))
        + _link("tip", 0.3, _sphere_inertia(0.3, 0.05), com=(0, 0, 0.05))
        + "</robot>"
    )


SPHERE_POINTS = "1"
# The cases: (URDF, relaxed-rigid contacts).
CASES = dict(
    box_soft=(models.build_box_urdf, False),
    box_relaxed_rigid=(models.build_box_urdf, True),
    pendulum=(lambda: models.build_pendulum_urdf(2), False),
    pendulum1=(lambda: models.build_pendulum_urdf(1), False),
    tiny_floating=(_tiny_floating_urdf, False),
    garpez_relaxed_rigid=(models.build_garpez_urdf, True),
    humanoid=(models.build_humanoid_urdf, False),
)
JAX_INTEGRATOR = dict(sie="SemiImplicitEuler", rk4="RungeKutta4", rk4fast="RungeKutta4Fast")
# XLA's CPU backend without its optimization passes: an RK4 step's graph
# (four contact solves for relaxed-rigid contacts) compiles in about 60 % of
# the time, and the results differ from the optimized build's only in
# float32 rounding.
XLA_OPTIONS = {"xla_backend_optimization_level": 0}


def _compiled(fn, *args):
    """``fn`` compiled by XLA for ``args`` with ``XLA_OPTIONS``."""
    import jax

    return jax.jit(fn).lower(*args).compile(compiler_options=XLA_OPTIONS)


@functools.lru_cache(maxsize=None)
def _jax_engine(case: str, integrator: str):
    import jaxsim_tpu.api as js
    from jaxsim_tpu.api.model import IntegratorType as JaxIntegrator
    from jaxsim_tpu.ops.batched_engine import BatchedEngine as JaxEngine
    from jaxsim_tpu.ops.contacts.relaxed_rigid import RelaxedRigidContacts as JaxRelaxedRigid

    urdf, relaxed = CASES[case]
    old = os.environ.get("JAXSIM_COLLISION_SPHERE_POINTS")
    os.environ["JAXSIM_COLLISION_SPHERE_POINTS"] = SPHERE_POINTS
    try:
        model = js.JaxSimModel.build_from_model_description(
            urdf(),
            contact_model=JaxRelaxedRigid() if relaxed else None,
            integrator=getattr(JaxIntegrator, JAX_INTEGRATOR[integrator]),
        )
    finally:
        if old is None:
            os.environ.pop("JAXSIM_COLLISION_SPHERE_POINTS")
        else:
            os.environ["JAXSIM_COLLISION_SPHERE_POINTS"] = old
    return JaxEngine.build(model)


def _stages_traced_once(jeng):
    """A copy of the JAX engine whose derivative, which an RK4 step evaluates
    four times, is one jitted function: tracing the step then traces it once
    and JAX inlines it four times, the same arithmetic."""
    import jax

    eng = dataclasses.replace(jeng)
    object.__setattr__(eng, "derivatives", jax.jit(eng.derivatives))
    return eng


def _port_engine(case: str, integrator: str, dtype=torch.float32) -> BatchedEngine:
    return bridge.engine_from_numpy(*bridge.reference_engine_arrays(_jax_engine(case, integrator)), device="cpu",
                                    dtype=dtype)  # fmt: skip


def _arrays(case: str, engine: BatchedEngine, B: int = 4, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded start states. The box (and garpez) as the relaxed-rigid tests
    set them up, low enough that most envs start in contact (the box's base
    0.05 + 0.02·N(0, 1) m up, moving; garpez tilted low, two corners in the
    ground), the box turning at about 17 rad/s, so that the quaternion rate's
    Baumgarte term moves q by far more than 1e-9 in 5 steps;
    the pendulum and the humanoid with their joints displaced and moving;
    the floating sphere 0.07-0.12 m up (its point on both sides of the
    ground), moving, its joint displaced and moving."""
    rng = np.random.default_rng(seed)
    st = bridge.state_to_numpy(engine.init_state(B, base_position=(0.0, 0.0, 0.9 if case == "humanoid" else 0.0)))
    if case == "tiny_floating":
        st["p"][2] = rng.uniform(0.07, 0.12, B)
        st["v"] = 0.2 * rng.standard_normal((6, B))
    if case.startswith("box"):
        st["p"] = np.array([0.0, 0.0, 0.05])[:, None] + 0.02 * rng.standard_normal((3, B))
        st["v"] = 0.1 * rng.standard_normal((6, B))
        st["v"][3:] += 10.0 * rng.standard_normal((3, B))
    elif case.startswith("garpez"):
        st["s"] = 0.05 * rng.standard_normal(st["s"].shape)
        st["p"] = np.tile(np.array([0.0, 0.0, 0.015])[:, None], (1, B))
        st["q"] = np.tile(np.array([0.995, 0.0998, 0.0, 0.0])[:, None], (1, B))
    if case != "humanoid" and not case.startswith(("box", "garpez")):
        st["s"] = 0.3 * rng.standard_normal(st["s"].shape) + (0.4 if case.startswith("pendulum") else 0.0)
        st["sd"] = 0.5 * rng.standard_normal(st["sd"].shape)
    elif case == "humanoid":
        st["s"] = 0.3 * rng.standard_normal(st["s"].shape)
        st["sd"] = 0.5 * rng.standard_normal(st["sd"].shape)
    return {k: np.asarray(a, np.float64) for k, a in st.items()}


def _tau_fn(case: str):
    """The torques of a case as a function of (s, sd): the flagship PD law,
    garpez's that of the JAX package's relaxed-rigid garpez test."""
    if case.startswith("garpez"):
        return lambda s, sd: -20.0 * s - 0.1 * sd
    return lambda s, sd: -60.0 * s - 0.5 * sd


def _jax_steps(case, integrator, arrays, n_steps, x64):
    """States after each of ``n_steps`` JAX engine steps (one compile)."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    jeng, tau_fn = _stages_traced_once(_jax_engine(case, integrator)), _tau_fn(case)
    _, params = bridge.reference_engine_arrays(jeng)
    with jax.enable_x64(x64):
        dtype = jnp.float64 if x64 else jnp.float32
        pr = {k: jnp.asarray(a, dtype) for k, a in params.items()}
        st = JaxState(**{k: jnp.asarray(a, dtype) for k, a in arrays.items()})
        step = _compiled(lambda st: jeng.step(st, tau_fn(st.s, st.sd), pr), st)
        out = []
        for _ in range(n_steps):
            st = step(st)
            out.append(bridge.reference_state_arrays(st))
    return out


def _port_steps(engine, case, arrays, n_steps):
    st = bridge.state_from_numpy(arrays, device="cpu", dtype=engine.S.dtype)
    tau_fn, out = _tau_fn(case), []
    with torch.no_grad():
        for _ in range(n_steps):
            st = engine.step(st, tau_fn(st.s, st.sd))
            out.append(bridge.state_to_numpy(st))
    return out


def _in_contact(engine, arrays) -> int:
    st = bridge.state_from_numpy(arrays, device="cpu", dtype=engine.S.dtype)
    return int(engine._point_geometry(*engine.fk(st), engine.params())["active"].sum())


def _float32_case(case, integrator, n_steps=5):
    teng = _port_engine(case, integrator)
    arrays = _arrays(case, teng)
    if teng.n_points:
        assert _in_contact(teng, arrays) > 0
    got = _port_steps(teng, case, arrays, n_steps)[-1]
    ref = _jax_steps(case, integrator, arrays, n_steps, x64=False)[-1]
    tols = PENDULUM_TOL if case.startswith("pendulum") else BOX_TOL if case.startswith("box") else dict(
        p=dict(rtol=1e-3, atol=1e-4), s=dict(rtol=1e-3, atol=1e-4), sd=dict(rtol=1e-2, atol=1e-2))  # fmt: skip
    for k, tol in tols.items():
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)
    if teng.n_points:
        assert np.abs(ref["m"]).max() > 0
        np.testing.assert_allclose(got["m"], ref["m"], rtol=M_RTOL, atol=M_RTOL * np.abs(ref["m"]).max(), err_msg="m")


# ----- the twin's step against the JAX engine's -----


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("case", ["box_soft", "box_relaxed_rigid", "pendulum"])
def test_step_matches_jax_float32(case, integrator):
    """Five steps in float32, at the relaxed-rigid tests' tolerances."""
    _float32_case(case, integrator)


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("case", ["box_soft", "box_relaxed_rigid", "pendulum"])
def test_step_matches_jax_float64(case, integrator):
    """Five steps in float64: every state field after each step to 1e-9."""
    teng = _port_engine(case, integrator, torch.float64)
    arrays = _arrays(case, teng)
    got = _port_steps(teng, case, arrays, 5)
    ref = _jax_steps(case, integrator, arrays, 5, x64=True)
    for t, (g, r) in enumerate(zip(got, ref)):
        for k in bridge.STATE_FIELDS:
            np.testing.assert_allclose(g[k], r[k], err_msg=f"{k} after step {t + 1}", **F64)


def test_quat_derivative_baumgarte_matches_jax():
    """``_quat_derivative`` with K = 1 (the RK4 derivative's) and K = 0
    (the SIE step's) against the JAX engine's, in float64, at quaternions
    off the unit sphere."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedEngine as JaxEngine

    rng = np.random.default_rng(5)
    q = rng.standard_normal((4, 16))
    q *= (1.0 + 0.1 * rng.standard_normal(16)) / np.linalg.norm(q, axis=0)
    omega = 3.0 * rng.standard_normal((3, 16))
    for K in (0.0, 1.0):
        with jax.enable_x64(True):
            ref = np.asarray(JaxEngine._quat_derivative(jnp.asarray(q), jnp.asarray(omega), K=K))
        got = BatchedEngine._quat_derivative(torch.from_numpy(q), torch.from_numpy(omega), K=K).numpy()
        np.testing.assert_allclose(got, ref, **F64)
    plain = BatchedEngine._quat_derivative(torch.from_numpy(q), torch.from_numpy(omega)).numpy()
    assert np.abs(got - plain).max() > 1e-3  # the term moves q̇ off the unit sphere


# The kernels' quaternion rate (``quat_rate`` of ``csrc/step_env.cuh``, which
# the relaxed-rigid and soft lane steps' RK4 stages call), compiled with g++
# for the box's header: argv = n, then n quaternions' and angular velocities'
# 7 floats each in C99 hex; prints each rate's 4 floats in C99 hex.
QUAT_RATE_HARNESS = r"""
#include "cuda_runtime.h"
#include <cstdio>
#include <cstdlib>
#include "step_env.cuh"

int main(int argc, char** argv) {
  const int n = std::atoi(argv[1]);
  for (int e = 0; e < n; ++e) {
    float x[7];
    for (int k = 0; k < 7; ++k) x[k] = std::strtof(argv[2 + 7 * e + k], nullptr);
    float qd[4];
    quat_rate(x, x + 4, qd);
    for (float y : qd) std::printf("%a\n", y);
  }
  return 0;
}
"""


def _quat_rate(csrc, tmp_path, q: np.ndarray, omega: np.ndarray) -> np.ndarray:
    """``quat_rate`` of ``csrc``'s ``step_env.cuh`` at each column of q (4, n)
    and omega (3, n), float32."""
    import shutil
    import subprocess

    from tests.test_torch_lane_forward import CUDA_SHIM, TIMEOUT_S

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp_path.mkdir()
    eng = BatchedEngine.build(JaxSimModel.build_from_model_description(models.build_box_urdf()), device="cpu")
    (tmp_path / cuda_build.GENERATED_HEADER).write_text(cuda_build.topology_header(eng))
    (tmp_path / "cuda_runtime.h").write_text(CUDA_SHIM)
    (tmp_path / "harness.cpp").write_text(QUAT_RATE_HARNESS)
    binary = tmp_path / "harness"
    cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-w", "-I", str(tmp_path), "-I", str(csrc),
           str(tmp_path / "harness.cpp"), "-o", str(binary)]  # fmt: skip
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=TIMEOUT_S)
    x = np.concatenate([q, omega]).astype(np.float32)
    args = [str(binary), str(x.shape[1]), *(float(v).hex() for v in x.T.ravel())]
    out = subprocess.run(args, check=True, capture_output=True, text=True, timeout=TIMEOUT_S).stdout.split()
    return np.array([float.fromhex(v) for v in out], np.float32).reshape(-1, 4).T


def test_kernel_quat_rate_keeps_the_baumgarte_term(tmp_path):
    """The kernels' ``quat_rate`` at quaternions off the unit sphere and
    nonzero angular velocities against the twin's ``_quat_derivative`` with
    K = 1 (the RK4 derivative's), float32; the same source with
    ``chip_probe.RK4_FAULTS``' "Baumgarte term dropped" edit is refused:
    the term moves the rate by far more than the limit."""
    import shutil

    rng = np.random.default_rng(11)
    q = rng.standard_normal((4, 16))
    q *= (1.0 + 0.1 * rng.standard_normal(16)) / np.linalg.norm(q, axis=0)
    omega = 3.0 * rng.standard_normal((3, 16))
    q, omega = q.astype(np.float32), omega.astype(np.float32)
    want = BatchedEngine._quat_derivative(torch.from_numpy(q), torch.from_numpy(omega), K=1.0).numpy()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_quat_rate(cuda_build.CSRC, tmp_path / "sound", q, omega), want, **tol)
    (edit,) = _chip_probe().RK4_FAULTS["Baumgarte term dropped"]
    file, old, new = edit
    seeded = tmp_path / "seeded"
    shutil.copytree(cuda_build.CSRC, seeded)
    (seeded / file).write_text((seeded / file).read_text().replace(old, new))
    got = _quat_rate(seeded, tmp_path / "seeded_build", q, omega)
    assert not np.allclose(got, want, **tol)


# ----- autograd through a soft RK4 step -----


@pytest.mark.parametrize("case", ["tiny_floating", "pendulum"])
def test_soft_rk4_step_vjp_matches_jax(case):
    """One soft RK4 step's VJP under autograd against ``jax.vjp`` of the JAX
    step, in every state leaf and ``tau``, float64, for a seeded output
    cotangent: the floating sphere (its point in and out of contact) and
    the pendulum (the box's VJP has no ``tau`` and compiles for 20 s)."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    jeng = _stages_traced_once(_jax_engine(case, "rk4"))
    teng = _port_engine(case, "rk4", torch.float64)
    arrays = _arrays(case, teng)
    rng = np.random.default_rng(7)
    tau = rng.standard_normal(arrays["s"].shape)
    ct = {k: rng.standard_normal(a.shape) for k, a in arrays.items()}
    _, params = bridge.reference_engine_arrays(jeng)
    with jax.enable_x64(True):
        pr = {k: jnp.asarray(a, jnp.float64) for k, a in params.items()}

        def vjp(st, t, c):
            return jax.vjp(lambda st, t: jeng.step(st, t, pr), st, t)[1](c)

        args = [JaxState(**{k: jnp.asarray(a) for k, a in d.items()}) for d in (arrays, ct)]
        args.insert(1, jnp.asarray(tau))
        ct_state, ct_tau = _compiled(vjp, *args)(*args)
        ref = {**bridge.reference_state_arrays(ct_state), "tau": np.asarray(ct_tau)}
    st = bridge.state_from_numpy(arrays, device="cpu", dtype=torch.float64)
    for t in st.fields():
        t.requires_grad_()
    tt = torch.from_numpy(tau).requires_grad_()
    out = teng.step(st, tt)
    grads = torch.autograd.grad(
        out.fields(), [*st.fields(), tt], [torch.from_numpy(ct[k]) for k in bridge.STATE_FIELDS], allow_unused=True
    )
    for k, g in zip((*bridge.STATE_FIELDS, "tau"), grads):
        g = np.zeros_like(ref[k]) if g is None else g.numpy()
        np.testing.assert_allclose(g, ref[k], err_msg=k, **F64)


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_relaxed_rigid_rk4_step_vjp_matches_jax_vjp(integrator):
    """The relaxed-rigid RK4 and RK4-fast steps' VJP under autograd, on the
    box in contact, through four implicit PCG backwards (RK4) or one with
    frozen wrenches (RK4-fast), against ``jax.vjp`` of the JAX step in every
    state leaf, float64, for a seeded output cotangent (the JAX VJPs take
    about 40 s and 20 s to trace and compile, one a case, so that two
    workers take them side by side)."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    jeng = _stages_traced_once(_jax_engine("box_relaxed_rigid", integrator))
    teng = _port_engine("box_relaxed_rigid", integrator, torch.float64)
    arrays = _arrays("box_relaxed_rigid", teng)
    rng = np.random.default_rng(7)
    ct = {k: rng.standard_normal(a.shape) for k, a in arrays.items()}
    _, params = bridge.reference_engine_arrays(jeng)
    with jax.enable_x64(True):
        pr = {k: jnp.asarray(a, jnp.float64) for k, a in params.items()}

        def vjp(st, c):
            return jax.vjp(lambda st: jeng.step(st, None, pr), st)[1](c)[0]

        args = [JaxState(**{k: jnp.asarray(a) for k, a in d.items()}) for d in (arrays, ct)]
        ref = bridge.reference_state_arrays(_compiled(vjp, *args)(*args))
    st = bridge.state_from_numpy(arrays, device="cpu", dtype=torch.float64)
    for t in st.fields():
        t.requires_grad_()
    out = teng.step(st)
    grads = torch.autograd.grad(
        out.fields(), list(st.fields()), [torch.from_numpy(ct[k]) for k in bridge.STATE_FIELDS], allow_unused=True
    )
    for k, g in zip(bridge.STATE_FIELDS, grads):
        g = np.zeros_like(ref[k]) if g is None else g.numpy()
        np.testing.assert_allclose(g, ref[k], err_msg=f"{integrator} {k}", **F64)
    assert np.abs(ref["q"]).max() > 0


# ----- the model, the bridge, K1's plain path -----


def test_model_and_bridge_carry_the_integrator():
    """``JaxSimModel.build_from_model_description(integrator=...)`` lowers to
    the engine's integrator as the JAX build does, and the bridge carries
    the JAX engine's across; SIE is the default; an unknown one raises."""
    for integrator, member in JAX_INTEGRATOR.items():
        model = JaxSimModel.build_from_model_description(models.build_box_urdf(), integrator=IntegratorType[member])
        assert BatchedEngine.build(model, device="cpu").integrator == integrator
        if integrator != "sie":
            static, _ = bridge.reference_engine_arrays(_jax_engine("box_soft", integrator))
            assert static["integrator"] == integrator == _port_engine("box_soft", integrator).integrator
    assert JaxSimModel.build_from_model_description(models.build_box_urdf()).integrator is IntegratorType.SemiImplicitEuler
    assert [m.name for m in IntegratorType] == list(JAX_INTEGRATOR.values())
    static, params = bridge.reference_engine_arrays(_jax_engine("box_soft", "rk4"))
    with pytest.raises(ValueError, match="integrator"):
        bridge.engine_from_numpy({**static, "integrator": "rk45"}, params, device="cpu")


def test_cpu_rollout_matches_pallas_rollout_in_interpret_mode():
    """Fixed-base pendulum, RK4, B = 128, 3 steps: the port's rollout on the
    CPU (K1's plain path) against the JAX fused rollout kernel of an RK4
    engine run by the Pallas interpreter, as test_torch_rollout_kernel.py
    holds the SIE one."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from jaxsim_tpu.ops import pallas_step as ps
    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    jeng = _jax_engine("pendulum1", "rk4")
    teng = _port_engine("pendulum1", "rk4")
    arrays = {k: a.astype(np.float32) for k, a in _arrays("pendulum1", teng, B=128).items()}
    policy = lambda st: -60.0 * st.s - 0.5 * st.sd  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        jst = ps.tile_state(JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()}))
        ref = bridge.reference_state_arrays(ps.untile_state(ps.build_pallas_rollout(jeng, 3, policy)(jst)))
    before = cuda_rollout.ROLLOUT_KERNEL_LAUNCHES
    got = bridge.state_to_numpy(cuda_rollout.rollout(teng, bridge.state_from_numpy(arrays, device="cpu"), 3))
    assert cuda_rollout.ROLLOUT_KERNEL_LAUNCHES == before  # the plain path
    for k in bridge.STATE_FIELDS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)


# ----- what the kernels take -----


WRAPPERS = dict(
    step_pd=lambda eng, st: cuda_step.step_pd(eng, st),
    step_tau=lambda eng, st: cuda_step.step_tau(eng, st, torch.zeros_like(st.s)),
    env_rollout=lambda eng, st: cuda_env_rollout.env_rollout(eng, st, 1),
    step_vjp=lambda eng, st: cuda_step_vjp.step_vjp(eng, st, torch.zeros_like(st.s), st),
)


def _humanoid(integrator: str, relaxed: bool = False, device="cpu") -> BatchedEngine:
    model = JaxSimModel.build_from_model_description(
        models.build_humanoid_urdf(), contact_model=RelaxedRigidContacts() if relaxed else None,
        integrator=IntegratorType[JAX_INTEGRATOR[integrator]],
    )  # fmt: skip
    return BatchedEngine.build(model, device=device)


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_one_step_kernels_refuse_rk4(kernel, integrator, monkeypatch):
    """K2, K3, K5 and K4 implement semi-implicit Euler only: on a state their
    kernel would take, an RK4 engine raises ValueError before any build,
    and K1 accepts it, soft and relaxed-rigid."""
    monkeypatch.setattr(cuda_build, "is_cpu", lambda state, what: False)
    eng = _humanoid(integrator)
    st = eng.init_state(4)
    with pytest.raises(ValueError, match="semi-implicit Euler"):
        WRAPPERS[kernel](eng, st)
    for e in (eng, _humanoid(integrator, relaxed=True)):
        assert cuda_build.check_cuda_call(e, e.init_state(4), cuda_rollout.CONTACT_MODELS, cuda_rollout.INTEGRATORS) == 4


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("entry", ["BatchedEnv.step", "fused_diff_rollout"])
def test_env_and_gradient_paths_surface_the_refusal(entry, integrator, monkeypatch):
    """On a state the kernels would take, ``BatchedEnv.step`` (K3) and a
    fused differentiable rollout (K3 forward) of an RK4 engine raise K3's
    ValueError, before any build."""
    from jaxsim_tpu_torch.envs import BatchedEnv
    from jaxsim_tpu_torch.ops import diff_step

    monkeypatch.setattr(cuda_build, "is_cpu", lambda state, what: False)
    eng = _humanoid(integrator)
    st = eng.init_state(4)
    with pytest.raises(ValueError, match="semi-implicit Euler"):
        if entry == "BatchedEnv.step":
            env = BatchedEnv(engine=eng)
            env_state, _ = env.reset(torch.Generator().manual_seed(0), 4)
            env.step(env_state, torch.zeros(eng.n_joints, 4))
        else:
            gains = torch.tensor([60.0, 0.5], requires_grad=True)
            diff_step.fused_diff_rollout(eng, 2)(st, lambda s, g: -g[0] * s.s - g[1] * s.sd, gains)


@pytest.mark.parametrize("integrator", ("sie", *INTEGRATORS))
def test_rk4_headers_and_slots(integrator):
    """The generated header names the integrator (0, 1, 2), so each builds
    a library of its own; an RK4 build's slots take a row of torques
    (captured once a step), soft and relaxed-rigid, and still fit the
    humanoid's blocks: 32 envs (soft) and 64 (relaxed-rigid)."""
    code = BatchedEngine.INTEGRATORS.index(integrator)
    extra = 0 if integrator == "sie" else 23
    soft, rr = _humanoid(integrator), _humanoid(integrator, relaxed=True)
    keys = set()
    for eng, lanes, slot, envs in ((soft, cuda_rollout.LANES, 1577, 32), (rr, cuda_rollout.RR_LANES, 804, 64)):
        job = cuda_rollout.job(eng)
        header = cuda_build.topology_header(eng, job.defines)
        assert f"#define JX_INTEGRATOR {code}\n" in header
        tables = (cuda_build.lane_tables(eng, lanes, forward=True) if eng.contact_model == "soft"
                  else cuda_build.rr_tables(eng, lanes))  # fmt: skip
        assert tables["slot"] == slot + extra and tables["envs"] == envs
        assert tables["smem_bytes"] <= cuda_build.MAX_SMEM_BYTES
        keys.add(cuda_build.build_key(job.source, header))
    assert len(keys) == 2


def test_flop_count_of_rk4_steps():
    """``flop_count.least_step_ops`` of an RK4 step counts four derivatives
    (each ABA without the joint transforms its forward kinematics made) and
    their sums, and of an RK4-fast step one contact evaluation: on garpez
    tilted low with the joints moving, soft and relaxed-rigid, an RK4 step
    needs 4-6 SIE steps' operations and an RK4-fast step fewer than an RK4
    one."""
    from jaxsim_tpu_torch.ops import flop_count

    for relaxed in (False, True):
        ops = {}
        for integrator in ("sie", *INTEGRATORS):
            model = JaxSimModel.build_from_model_description(
                models.build_garpez_urdf(), contact_model=RelaxedRigidContacts() if relaxed else None,
                integrator=IntegratorType[JAX_INTEGRATOR[integrator]],
            )  # fmt: skip
            eng = BatchedEngine.build(model, device="cpu")
            arrays = _arrays("garpez_relaxed_rigid", eng, B=3)
            arrays["sd"] = 0.5 * np.random.default_rng(1).standard_normal(arrays["sd"].shape)
            st = bridge.state_from_numpy(arrays, device="cpu")

            def step(s):
                return cuda_rollout.rollout_reference(eng, s, 1)

            ops[integrator] = flop_count.least_step_ops(eng, step, st)
        assert 4.0 * ops["sie"] < ops["rk4"] < 6.0 * ops["sie"], ops
        assert ops["rk4fast"] < ops["rk4"], ops


def _chip_probe():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_probe.py"
    spec = importlib.util.spec_from_file_location("chip_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fault", ["stage weights", "torques re-read", "Baumgarte", "y0 captured", "stage PCG"])
def test_rk4_faults_seed_into_the_sources(fault):
    """Each of ``chip_probe.RK4_FAULTS`` edits text that its source file
    holds exactly once, and the edit changes it, so the probe's seeded
    builds differ from the sound ones in that place only."""
    faults = _chip_probe().RK4_FAULTS
    (name,) = [n for n in faults if n.startswith(fault)]
    for file, old, new in faults[name]:
        assert old != new
        assert (cuda_build.CSRC / file).read_text().count(old) == 1, (name, file)


def test_rk4_variants_and_stamps_apply_once():
    """Each edit of ``chip_probe.RK4_VARIANTS``, of the owned-entries
    variant and of the clock stamps (``chip_probe.py rk4_variants``) finds
    its text once in its source, so the probe builds what it names."""
    probe = _chip_probe()
    edits = [e for edits in probe.RK4_VARIANTS.values() for e in edits] + probe._RK4_OWNED + probe._RK4_PH
    for file, old, new in edits:
        assert (cuda_build.CSRC / file).read_text().count(old) == 1 and old != new, old


# ----- slow: garpez with relaxed-rigid contacts, the humanoid -----


@pytest.mark.slow
@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_garpez_relaxed_rigid_matches_jax(integrator):
    """Garpez tilted low with relaxed-rigid contacts, 5 steps in float32 at
    the relaxed-rigid garpez test's tolerances, m relative to its largest."""
    _float32_case("garpez_relaxed_rigid", integrator)


@pytest.mark.slow
@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_humanoid_matches_jax(integrator):
    """The soft humanoid with the joints moving, 5 steps in float32."""
    teng = _port_engine("humanoid", integrator)
    arrays = _arrays("humanoid", teng)
    got = _port_steps(teng, "humanoid", arrays, 5)[-1]
    ref = _jax_steps("humanoid", integrator, arrays, 5, x64=False)[-1]
    for k in bridge.STATE_FIELDS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, atol=1e-3, err_msg=k)


# ----- on the card -----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_engine(name: str, integrator: str, relaxed: bool, device) -> BatchedEngine:
    urdf = dict(pendulum=lambda: models.build_pendulum_urdf(1), box=models.build_box_urdf,
                garpez=models.build_garpez_urdf)[name]  # fmt: skip
    model = JaxSimModel.build_from_model_description(
        urdf(), contact_model=RelaxedRigidContacts() if relaxed else None,
        integrator=IntegratorType[JAX_INTEGRATOR[integrator]],
    )  # fmt: skip
    return BatchedEngine.build(model, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name,relaxed", [("pendulum", False), ("box", False), ("garpez", True), ("box", True)])
def test_kernel_matches_plain_small_batch(cuda, name, relaxed, integrator):
    """K1's RK4 and RK4-fast builds, soft and relaxed-rigid, through the
    wrapper, against the twin: 50 steps at B = 100 (not a multiple of a
    block's envs) from a seeded moving start, every field within 1e-3 (m
    relative to its largest); two launches agree to the bit."""
    eng = _card_engine(name, integrator, relaxed, cuda)
    rng = np.random.default_rng(0)
    B = 100
    arrays = bridge.state_to_numpy(eng.init_state(B, base_position=(0.0, 0.0, 0.0 if name == "pendulum" else 0.05)))
    if name == "garpez":
        arrays["p"][2] = 0.015
        arrays["q"] = np.tile(np.array([0.995, 0.0998, 0.0, 0.0], np.float32)[:, None], (1, B))
    arrays["s"] = (0.3 * rng.standard_normal(arrays["s"].shape)).astype(np.float32)
    arrays["sd"] = (0.5 * rng.standard_normal(arrays["sd"].shape)).astype(np.float32)
    if eng.floating_base:
        arrays["v"] = (0.3 * rng.standard_normal(arrays["v"].shape)).astype(np.float32)
    st = bridge.state_from_numpy(arrays, device=cuda)
    counter = "ROLLOUT_RR_KERNEL_LAUNCHES" if relaxed else "ROLLOUT_KERNEL_LAUNCHES"
    before = getattr(cuda_rollout, counter)
    kern = cuda_rollout.rollout(eng, st, 50)
    again = cuda_rollout.rollout(eng, st, 50)
    torch.cuda.synchronize()
    assert getattr(cuda_rollout, counter) == before + 2
    plain = cuda_rollout.rollout_reference(eng, st, 50)
    for k, a, a2, b in zip(bridge.STATE_FIELDS, kern.fields(), again.fields(), plain.fields()):
        assert torch.equal(a, a2), k
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), k
        if a.numel():
            scale = max(1.0, float(b.abs().max())) if k == "m" and relaxed else 1.0
            assert float((a - b).abs().max()) <= 1e-3 * scale, (k, float((a - b).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_one_step_kernels_raise_on_the_card(kernel, cuda):
    eng = _humanoid("rk4", device=cuda)
    with pytest.raises(ValueError, match="semi-implicit Euler"):
        WRAPPERS[kernel](eng, eng.init_state(64))
