"""Gradients through the port's physics against the JAX package's.

The twin's step under ``torch.autograd`` (K4's plain version) against
``jax.vjp`` of the JAX ``BatchedEngine.step``, in every state leaf, ``tau`` and
every model array, on the same inputs and cotangents (made with NumPy from a
seed, carried across by the bridge): float32 at the JAX tier of
``tests/test_batched_engine.py`` (rtol 1e-4, atol 1e-5), float64 at 1e-9.
Then the differentiable rollouts of ``ops/diff_step.py`` (their plain
versions on the CPU) against ``jax.grad`` through a ``lax.scan`` of the JAX
step, and K4's wrapper. Tests marked ``gpu`` hold K4 against its plain
version on the card and skip without one; they import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_autograd.py
"""

from __future__ import annotations

import contextlib
import copy
import functools
import os
import pathlib

import numpy as np
import pytest
import torch

from jaxsim_tpu_torch import bridge, models
from jaxsim_tpu_torch.ops import cuda_build, cuda_step, cuda_step_vjp, diff_step
from jaxsim_tpu_torch.models.builders import _joint, _link, _sphere_collision, _sphere_inertia
from jaxsim_tpu_torch.ops.batched_engine import BatchedEngine, BatchedState

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
F64 = dict(rtol=1e-9, atol=1e-9)
# Batch-summed model-array cotangents: the sums' order differs between the
# frameworks, so each entry is held relative to its array's largest.
SUMMED = dict(rtol=1e-4, atol_scale=1e-5)


def _tiny_floating_urdf() -> str:
    """A floating sphere (one collision point) and one revolute joint, as in
    ``tests/test_torch_engine.py``."""
    return (
        '<robot name="tiny">'
        + _link("base", 1.0, _sphere_inertia(1.0, 0.1), collision=_sphere_collision(0.1))
        + _joint("j1", "revolute", "base", "tip", xyz=(0, 0, 0.15), axis=(0, 1, 0))
        + _link("tip", 0.3, _sphere_inertia(0.3, 0.05), com=(0, 0, 0.05))
        + "</robot>"
    )


# (URDF, sphere points, base height range, B). The default tier runs the
# fixed-base pendulum and the floating sphere with one revolute joint and one
# contact point (``tiny_floating`` of ``test_torch_engine.py``), which starts
# on both sides of the ground, so its batch has the point out of contact,
# sticking and slipping; their JAX graphs compile in seconds. The garpez
# chain (32 points; about a minute a dtype on one core) and the humanoid
# (minutes) are ``slow``.
CASES = {
    "pendulum2": (lambda: models.build_pendulum_urdf(2), None, (0.0, 0.0), 16),
    "tiny_floating": (_tiny_floating_urdf, "1", (0.07, 0.12), 32),
    "garpez": (models.build_garpez_urdf, None, (-0.01, 0.02), 32),
    "humanoid23": (models.build_humanoid_urdf, None, (0.86, 0.9), 8),
}


def _random_arrays(n, m_rows, B, z_range, rng) -> dict[str, np.ndarray]:
    q = np.concatenate([np.ones((1, B)), 0.05 * rng.standard_normal((3, B))])
    arrays = dict(
        s=0.3 * rng.standard_normal((n, B)),
        sd=0.5 * rng.standard_normal((n, B)),
        p=np.concatenate([0.05 * rng.standard_normal((2, B)), rng.uniform(*z_range, size=(1, B))]),
        q=q / np.linalg.norm(q, axis=0),
        v=0.3 * rng.standard_normal((6, B)),
        m=1e-3 * rng.standard_normal((m_rows, 3, B)),
    )
    # A quarter of the envs at rest, so some points stick.
    for k in ("sd", "v"):
        arrays[k][..., : B // 4] = 0.0
    return arrays


@contextlib.contextmanager
def _sphere_points(value):
    old = os.environ.get("JAXSIM_COLLISION_SPHERE_POINTS")
    if value is not None:
        os.environ["JAXSIM_COLLISION_SPHERE_POINTS"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("JAXSIM_COLLISION_SPHERE_POINTS", None)
        else:
            os.environ["JAXSIM_COLLISION_SPHERE_POINTS"] = old


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX engine, state arrays, tau, output cotangent arrays), float64."""
    import jaxsim_tpu.api as js
    from jaxsim_tpu.ops.batched_engine import BatchedEngine as JaxEngine

    urdf, sphere_points, z_range, B = CASES[name]
    with _sphere_points(sphere_points):
        model = js.JaxSimModel.build_from_model_description(urdf())
    if name == "humanoid23":
        model = model.replace(
            contact_params=js.contact.estimate_good_contact_parameters(
                model, number_of_active_collidable_points_steady_state=8, max_penetration=0.006, damping_ratio=0.15
            )
        )
    jeng = JaxEngine.build(model)
    rng = np.random.default_rng(3)
    arrays = _random_arrays(jeng.n_joints, jeng.m_rows, B, z_range, rng)
    tau = 3.0 * rng.standard_normal((jeng.n_joints, B))
    ct = {k: rng.standard_normal(a.shape) for k, a in arrays.items()}
    return jeng, arrays, tau, ct


def _port_engine(jeng, dtype=torch.float32) -> BatchedEngine:
    return bridge.engine_from_numpy(*bridge.reference_engine_arrays(jeng), device="cpu", dtype=dtype)


def _cast(arrays, dtype):
    return {k: np.asarray(a, dtype=dtype) for k, a in arrays.items()}


def _jax_vjp(jeng, arrays, tau, ct, pr, x64: bool):
    """``jax.vjp`` of the JAX step at (state, tau, pr) for ``ct``, as NumPy."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    with jax.enable_x64(x64):
        dtype = jnp.float64 if x64 else jnp.float32
        st = JaxState(**{k: jnp.asarray(a, dtype) for k, a in arrays.items()})
        jpr = {k: jnp.asarray(a, dtype) for k, a in pr.items()}
        cts = JaxState(**{k: jnp.asarray(a, dtype) for k, a in ct.items()})

        def vjp(st, tau, jpr, cts):
            return jax.vjp(lambda a, b, c: jeng.step(a, b, c), st, tau, jpr)[1](cts)

        g_st, g_tau, g_pr = jax.jit(vjp)(st, jnp.asarray(tau, dtype), jpr, cts)
        return bridge.reference_state_arrays(g_st), np.asarray(g_tau), bridge.reference_params_arrays(g_pr)


def _port_vjp(teng, arrays, tau, ct, pr, dtype):
    f = functools.partial(bridge.state_from_numpy, device="cpu", dtype=dtype)
    got = cuda_step_vjp.step_vjp(
        teng, f(arrays), torch.as_tensor(tau, dtype=dtype), f(ct),
        bridge.params_from_numpy(pr, device="cpu", dtype=dtype), params_grad=True,
    )  # fmt: skip
    return bridge.state_to_numpy(got[0]), got[1].numpy(), bridge.params_to_numpy(got[2])


def _assert_vjp_close(got, ref, tol, summed_tol=None):
    for k in bridge.STATE_FIELDS:
        np.testing.assert_allclose(got[0][k], ref[0][k], err_msg=f"ct.{k}", **tol)
        assert np.isfinite(got[0][k]).all(), k
    np.testing.assert_allclose(got[1], ref[1], err_msg="ct_tau", **tol)
    # The engine's own model arrays: a relaxed-rigid engine's add rrMinv.
    assert list(got[2]) == list(ref[2]), (list(got[2]), list(ref[2]))
    for k in got[2]:
        if summed_tol is None:
            np.testing.assert_allclose(got[2][k], ref[2][k], err_msg=f"ct_pr.{k}", **tol)
        else:
            atol = summed_tol["atol_scale"] * max(1.0, float(np.abs(ref[2][k]).max()))
            np.testing.assert_allclose(got[2][k], ref[2][k], rtol=summed_tol["rtol"], atol=atol, err_msg=f"ct_pr.{k}")


def _check_vjp(name, x64: bool):
    jeng, arrays, tau, ct = _case(name)
    dtype_np, dtype = (np.float64, torch.float64) if x64 else (np.float32, torch.float32)
    arrays, ct, tau = _cast(arrays, dtype_np), _cast(ct, dtype_np), np.asarray(tau, dtype_np)
    pr = _cast(bridge.reference_params_arrays(jeng.params()), dtype_np)
    ref = _jax_vjp(jeng, arrays, tau, ct, pr, x64)
    got = _port_vjp(_port_engine(jeng, dtype), arrays, tau, ct, pr, dtype)
    _assert_vjp_close(got, ref, F64 if x64 else F32, None if x64 else SUMMED)


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("name", ["pendulum2", "tiny_floating"])
def test_step_vjp_matches_jax_vjp(name, x64):
    """Every state leaf's, tau's and model array's cotangent."""
    _check_vjp(name, x64)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["garpez", "humanoid23"])
def test_large_model_step_vjp_matches_jax_vjp(name):
    _check_vjp(name, x64=False)


def _branches(teng, state) -> tuple[int, int, int]:
    """Points (out of contact, sticking, slipping) of ``state``, by the
    twin's own contact law."""
    from tests.test_torch_engine import _contact_regimes

    return tuple(int(x) for x in _contact_regimes(teng, *teng.fk(state), bridge.state_to_numpy(state)["m"]))


def test_batch_covers_every_contact_branch_with_finite_cotangents():
    """The tiny model's batch above has its point out of contact, sticking
    and slipping, and every cotangent of the VJP there is finite."""
    jeng, arrays, tau, ct = _case("tiny_floating")
    teng = _port_engine(jeng)
    state = bridge.state_from_numpy(_cast(arrays, np.float32), device="cpu")
    above, sticking, slipping = _branches(teng, state)
    assert above > 0 and sticking > 0 and slipping > 0, (above, sticking, slipping)
    got = cuda_step_vjp.step_vjp(
        teng, state, torch.as_tensor(tau, dtype=torch.float32),
        bridge.state_from_numpy(_cast(ct, np.float32), device="cpu"), params_grad=True,
    )  # fmt: skip
    leaves = [*got[0].fields(), got[1], *got[2].values()]
    assert all(bool(torch.isfinite(t).all()) for t in leaves)


def test_tie_at_zero_penetration_matches_jax():
    """The sphere resting level with its contact point exactly on the ground,
    δ = 0, where JAX's ``max(0, x)`` passes half the cotangent
    (``torch.clamp`` would pass all of it), in every env of the batch."""
    jeng, arrays, tau, ct = _case("tiny_floating")
    teng = _port_engine(jeng)
    arrays = _cast(arrays, np.float32)
    arrays["p"][:2] = 0.0
    arrays["p"][2] = -teng.cpoint[0, 2].item()
    arrays["q"][:] = np.array([1.0, 0.0, 0.0, 0.0], np.float32)[:, None]
    W_R, W_p, _ = teng.fk(bridge.state_from_numpy(arrays, device="cpu"))
    assert bool(((W_R[0][2] * teng.cpoint[0][:, None]).sum(0) + W_p[0][2] == 0).all())
    tau, ct = np.asarray(tau, np.float32), _cast(ct, np.float32)
    pr = bridge.reference_params_arrays(jeng.params())
    ref = _jax_vjp(jeng, arrays, tau, ct, pr, x64=False)
    got = _port_vjp(teng, arrays, tau, ct, pr, torch.float32)
    _assert_vjp_close(got, ref, F32, SUMMED)


# ----- the differentiable rollouts -----

GAINS = (5.0, 0.1)
ROLLOUT_STEPS = 4


def _gains_policy(st, gains):
    return -gains[0] * st.s - gains[1] * st.sd


@functools.lru_cache(maxsize=None)
def _jax_rollout_grad(name, n_steps):
    """``jax.grad`` of ``mean(ṡ²) + mean(p_z)`` after ``n_steps`` of the JAX
    step under the gains policy, through a ``lax.scan``."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    jeng, arrays, _, _ = _case(name)
    st = JaxState(**{k: jnp.asarray(a, jnp.float32) for k, a in arrays.items()})

    def loss(gains):
        def body(s, _):
            return jeng.step(s, _gains_policy(s, gains)), None

        out, _ = jax.lax.scan(body, st, None, length=n_steps)
        return jnp.mean(out.sd**2) + jnp.mean(out.p[2])

    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(GAINS, jnp.float32)))


def _rollout_grad(name, rollout):
    jeng, arrays, _, _ = _case(name)
    state = bridge.state_from_numpy(arrays, device="cpu")
    gains = torch.tensor(GAINS, requires_grad=True)
    out = rollout(_port_engine(jeng))(state, _gains_policy, gains)
    loss = (out.sd**2).mean() + out.p[2].mean()
    return torch.autograd.grad(loss, gains)[0].numpy()


ROLLOUTS = {
    "fused": lambda eng: diff_step.fused_diff_rollout(eng, ROLLOUT_STEPS),
    "fused_params_grad": lambda eng: diff_step.fused_diff_rollout(eng, ROLLOUT_STEPS, params_grad=True),
    "fused_chunk2": lambda eng: diff_step.fused_diff_rollout(eng, ROLLOUT_STEPS, checkpoint_chunk=2),
    "fused_chunk3": lambda eng: diff_step.fused_diff_rollout(eng, ROLLOUT_STEPS, checkpoint_chunk=3),
    "fused_params_grad_chunk1": lambda eng: diff_step.fused_diff_rollout(
        eng, ROLLOUT_STEPS, params_grad=True, checkpoint_chunk=1
    ),
}


@pytest.mark.parametrize("tier", sorted(ROLLOUTS))
def test_rollout_gains_gradient_matches_jax(tier):
    """The gains' gradient through 4 steps of each differentiable rollout
    (checkpointed in chunks of 2, of 3 with a remainder, and of 1) against
    ``jax.grad``."""
    ref = _jax_rollout_grad("tiny_floating", ROLLOUT_STEPS)
    got = _rollout_grad("tiny_floating", ROLLOUTS[tier])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-7)
    assert np.abs(got).max() > 0


def test_params_grad_rollout_matches_jax_grad_of_pr():
    """``M`` and ``cpoint`` cotangents through 3 steps of the fused rollout
    with ``params_grad`` against ``jax.grad`` with respect to ``pr``."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    jeng, arrays, _, _ = _case("tiny_floating")
    base = jeng.params()
    hw = {"M": base["M"], "cpoint": base["cpoint"]}
    st = JaxState(**{k: jnp.asarray(a, jnp.float32) for k, a in arrays.items()})

    def loss(hw):
        def body(s, _):
            return jeng.step(s, _gains_policy(s, jnp.asarray(GAINS)), {**base, **hw}), None

        out, _ = jax.lax.scan(body, st, None, length=3)
        return jnp.sum(out.p[2]) + 0.1 * jnp.sum(out.sd**2)

    ref = bridge.reference_params_arrays(jax.jit(jax.grad(loss))(hw))
    teng = _port_engine(jeng)
    pr = {k: t.requires_grad_() for k, t in bridge.params_from_numpy(bridge.reference_params_arrays(hw), device="cpu").items()}
    out = diff_step.fused_diff_rollout(teng, 3, params_grad=True)(
        bridge.state_from_numpy(arrays, device="cpu"), _gains_policy, torch.tensor(GAINS), pr=pr
    )
    got = torch.autograd.grad(out.p[2].sum() + 0.1 * (out.sd**2).sum(), list(pr.values()))
    for (k, r), g in zip(ref.items(), got):
        atol = SUMMED["atol_scale"] * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g.numpy(), r, rtol=SUMMED["rtol"], atol=atol, err_msg=k)
        assert np.abs(r).max() > 0, k


def test_checkpointed_rollout_runs_each_chunk_forward_again(monkeypatch):
    """With ``checkpoint_chunk`` the backward runs each chunk's forward steps
    again (the step twice a step in all) and the step VJP once a step, and
    the gradient is the unchunked rollout's."""
    eng, state = _pendulum()
    calls = dict.fromkeys(("step_tau", "step_vjp"), 0)
    for mod, name in ((cuda_step, "step_tau"), (cuda_step_vjp, "step_vjp")):

        def counted(*args, _f=getattr(mod, name), _name=name, **kwargs):
            calls[_name] += 1
            return _f(*args, **kwargs)

        monkeypatch.setattr(mod, name, counted)
    grads = []
    for chunk, want in ((None, (5, 5)), (2, (10, 5))):
        calls.update(step_tau=0, step_vjp=0)
        gains = torch.tensor(GAINS, requires_grad=True)
        out = diff_step.fused_diff_rollout(eng, 5, checkpoint_chunk=chunk)(state, _gains_policy, gains)
        (out.sd**2).sum().backward()
        assert (calls["step_tau"], calls["step_vjp"]) == want, chunk
        grads.append(gains.grad)
    assert torch.equal(grads[0], grads[1]) and float(grads[0].abs().max()) > 0
    with pytest.raises(ValueError, match="checkpoint_chunk"):
        diff_step.fused_diff_rollout(eng, 5, checkpoint_chunk=0)


# ----- the wrappers -----


def _pendulum(B=4):
    from jaxsim_tpu_torch import JaxSimModel

    eng = BatchedEngine.build(JaxSimModel.build_from_model_description(models.build_pendulum_urdf(2)), device="cpu")
    state = eng.init_state(B, base_position=(0.0, 0.0, 0.0))
    state.s = 0.3 * torch.randn(state.s.shape, generator=torch.Generator().manual_seed(0))
    return eng, state


def test_model_arrays_take_the_engines_names():
    """``diff_step`` reads the model arrays' names from the engine: a
    relaxed-rigid engine's carry ``rrMinv`` (its own ``PARAM_NAMES``), a
    soft engine's the six soft arrays, and the soft path's gradients with
    respect to all of them are the twin's under autograd."""
    from jaxsim_tpu_torch import JaxSimModel
    from jaxsim_tpu_torch.ops.contacts.relaxed_rigid import RelaxedRigidContacts

    rr = BatchedEngine.build(
        JaxSimModel.build_from_model_description(models.build_garpez_urdf(), contact_model=RelaxedRigidContacts()),
        device="cpu",
    )
    arrays = diff_step._model_arrays(rr, {"rrMinv": 2.0 * rr.rrMinv})
    assert rr.PARAM_NAMES[-1] == "rrMinv" and len(arrays) == len(rr.PARAM_NAMES) == 7
    assert torch.equal(arrays[-1], 2.0 * rr.rrMinv)
    assert list(diff_step._as_pr(rr, arrays)) == list(rr.PARAM_NAMES)

    eng, state = _pendulum()
    assert eng.PARAM_NAMES == BatchedEngine.PARAM_NAMES
    pr = {k: t.clone().requires_grad_() for k, t in eng.params().items()}
    gains = torch.tensor(GAINS)
    out = diff_step.fused_diff_rollout(eng, 3, params_grad=True)(state, _gains_policy, gains, pr=pr)
    got = torch.autograd.grad(out.p[2].sum() + (out.sd**2).sum(), list(pr.values()))
    twin = {k: t.clone().requires_grad_() for k, t in eng.params().items()}
    st = state
    for _ in range(3):
        st = eng.step(st, _gains_policy(st, gains), twin)
    ref = torch.autograd.grad(st.p[2].sum() + (st.sd**2).sum(), list(twin.values()), allow_unused=True)
    for k, g, r in zip(pr, got, ref):
        torch.testing.assert_close(g, torch.zeros_like(g) if r is None else r, rtol=1e-5, atol=1e-6, msg=k)
    assert any(float(g.abs().max()) > 0 for g in got)


def test_step_vjp_on_a_cpu_state_runs_the_plain_version():
    eng, state = _pendulum()
    tau = torch.ones_like(state.s)
    ct = BatchedState(*(torch.ones_like(t) for t in state.fields()))
    before = cuda_step_vjp.STEP_VJP_KERNEL_LAUNCHES, cuda_step_vjp.PARAM_SUM_KERNEL_LAUNCHES
    got = cuda_step_vjp.step_vjp(eng, state, tau, ct, params_grad=True)
    ref = cuda_step_vjp.step_vjp_reference(eng, state, tau, ct, params_grad=True)
    assert (cuda_step_vjp.STEP_VJP_KERNEL_LAUNCHES, cuda_step_vjp.PARAM_SUM_KERNEL_LAUNCHES) == before
    for a, b in zip([*got[0].fields(), got[1], *got[2].values()], [*ref[0].fields(), ref[1], *ref[2].values()]):
        assert torch.equal(a, b)
    partials = torch.randn(5, cuda_step_vjp.packed_params(eng).numel())
    assert torch.equal(cuda_step_vjp.sum_partials(eng, partials), partials.sum(0))


def test_step_vjp_refuses_what_it_does_not_differentiate():
    eng, state = _pendulum()
    tau = torch.zeros_like(state.s)
    ct = BatchedState(*(torch.ones_like(t) for t in state.fields()))
    tilted = copy.copy(eng)
    tilted.terrain_normal = (0.0, 0.1, 1.0)
    with pytest.raises(ValueError, match="ROADMAP Queue 2 item 6"):
        cuda_step_vjp.step_vjp(tilted, state, tau, ct)
    with pytest.raises(ValueError, match="ROADMAP Queue 2 item 6"):
        diff_step.fused_diff_step(tilted)
    with pytest.raises(ValueError, match="shape"):
        cuda_step_vjp.step_vjp(eng, state, tau, ct, {"M": eng.M[:1]})
    with pytest.raises(ValueError, match="params_grad"):
        diff_step.fused_diff_rollout(eng, 1)(state, _gains_policy, torch.tensor(GAINS), pr={"M": eng.M})


def test_diff_step_lets_a_kernel_error_through(monkeypatch):
    """Nothing in ``diff_step`` catches an error of the kernels' wrappers: a
    failing backward fails the ``backward`` call."""
    source = (pathlib.Path(diff_step.__file__)).read_text()
    assert "try:" not in source and "except" not in source
    eng, state = _pendulum()

    def broken(*args, **kwargs):
        raise RuntimeError("jx_step_vjp launch failed: seeded")

    monkeypatch.setattr(cuda_step_vjp, "step_vjp", broken)
    gains = torch.tensor(GAINS, requires_grad=True)
    out = diff_step.fused_diff_rollout(eng, 2)(state, _gains_policy, gains)
    with pytest.raises(RuntimeError, match="seeded"):
        out.sd.sum().backward()


# ----- on the card -----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_case(name, device, B):
    from jaxsim_tpu_torch import JaxSimModel

    urdf = {"pendulum1": models.build_pendulum_urdf(1), "garpez": models.build_garpez_urdf()}[name.split()[0]]
    eng = BatchedEngine.build(JaxSimModel.build_from_model_description(urdf), device=device)
    rng = np.random.default_rng(11)
    z = (0.0, 0.0) if name == "pendulum1" else (-0.01, 0.02)
    arrays = _random_arrays(eng.n_joints, eng.m_rows, B, z, rng)
    if name == "garpez in contact":
        # chip_smoke.py's tilted-low start: two corners penetrate from step 0.
        arrays.update(
            p=np.tile([[0.0], [0.0], [0.015]], (1, B)),
            q=np.tile([[0.995], [0.0998], [0.0], [0.0]], (1, B)),
            s=0.05 * rng.standard_normal((eng.n_joints, B)),
            sd=np.zeros((eng.n_joints, B)),
            v=np.zeros((6, B)),
            m=np.zeros((eng.m_rows, 3, B)),
        )
    tau = 3.0 * rng.standard_normal((eng.n_joints, B))
    ct = {k: rng.standard_normal(a.shape) for k, a in arrays.items()}
    f = functools.partial(bridge.state_from_numpy, device=device)
    return eng, f(arrays), torch.as_tensor(tau, dtype=torch.float32, device=device).contiguous(), f(ct)


@pytest.mark.gpu
@pytest.mark.parametrize("params_grad", [False, True])
@pytest.mark.parametrize("name", ["pendulum1", "garpez", "garpez in contact"])
def test_step_vjp_kernel_matches_plain(cuda, name, params_grad):
    """K4 against its plain version at B = 256: every cotangent per env within
    1e-3·max(1, max|plain|); the batch-summed model-array cotangents at
    rtol 5e-3, atol 5e-4·max(1, max|plain|). Garpez also from the tilted-low
    start, points in contact."""
    eng, state, tau, ct = _card_case(name, cuda, 256)
    got = cuda_step_vjp.step_vjp(eng, state, tau, ct, params_grad=params_grad)
    ref = cuda_step_vjp.step_vjp_reference(eng, state, tau, ct, params_grad=params_grad)
    torch.cuda.synchronize()
    for a, b in zip([*got[0].fields(), got[1]], [*ref[0].fields(), ref[1]]):
        if b.numel():
            assert float((a - b).abs().max()) <= 1e-3 * max(1.0, float(b.abs().max()))
    if params_grad:
        for k in BatchedEngine.PARAM_NAMES:
            a, b = got[2][k], ref[2][k]
            torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-4 * max(1.0, float(b.abs().max())))


@pytest.mark.gpu
def test_fused_diff_step_launches_k3_and_k4_once(cuda):
    eng, state, tau, _ = _card_case("garpez", cuda, 256)
    tau.requires_grad_()
    before = cuda_step.STEP_TAU_KERNEL_LAUNCHES, cuda_step_vjp.STEP_VJP_KERNEL_LAUNCHES
    out = diff_step.fused_diff_step(eng)(state, tau)
    (out.sd**2).sum().backward()
    torch.cuda.synchronize()
    after = cuda_step.STEP_TAU_KERNEL_LAUNCHES, cuda_step_vjp.STEP_VJP_KERNEL_LAUNCHES
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    assert bool(torch.isfinite(tau.grad).all()) and float(tau.grad.abs().max()) > 0


@pytest.mark.gpu
def test_checkpointed_rollout_launches_k3_twice_and_k4_once_a_step(cuda):
    eng, state, _, _ = _card_case("garpez", cuda, 256)
    gains = torch.tensor(GAINS, device=cuda, requires_grad=True)
    before = cuda_step.STEP_TAU_KERNEL_LAUNCHES, cuda_step_vjp.STEP_VJP_KERNEL_LAUNCHES
    out = diff_step.fused_diff_rollout(eng, 5, checkpoint_chunk=2)(state, _gains_policy, gains)
    (out.sd**2).sum().backward()
    torch.cuda.synchronize()
    after = cuda_step.STEP_TAU_KERNEL_LAUNCHES, cuda_step_vjp.STEP_VJP_KERNEL_LAUNCHES
    assert (after[0] - before[0], after[1] - before[1]) == (10, 5)
    assert bool(torch.isfinite(gains.grad).all()) and float(gains.grad.abs().max()) > 0


@pytest.mark.gpu
def test_sum_partials_is_reproducible_and_matches_torch_sum(cuda):
    """K4's partials' sum over the humanoid's blocks at B = 8192 (a row a
    block of ``envs_per_block`` envs) of garpez's model arrays: one launch a
    call, two runs equal to the bit, and within 1e-6 relative of
    ``torch.sum`` (the scale: the largest sum)."""
    from jaxsim_tpu_torch import JaxSimModel

    hum = BatchedEngine.build(JaxSimModel.build_from_model_description(models.build_humanoid_urdf()), device="cpu")
    eng, *_ = _card_case("garpez", cuda, 32)
    n = cuda_build.packed_params(eng).numel()
    gen = torch.Generator(cuda).manual_seed(0)
    partials = torch.randn(-(-8192 // cuda_step_vjp.envs_per_block(hum, True)), n, generator=gen, device=cuda)
    before = cuda_step_vjp.PARAM_SUM_KERNEL_LAUNCHES
    got, again = cuda_step_vjp.sum_partials(eng, partials), cuda_step_vjp.sum_partials(eng, partials)
    torch.cuda.synchronize()
    assert cuda_step_vjp.PARAM_SUM_KERNEL_LAUNCHES == before + 2
    assert torch.equal(got, again)
    ref = torch.sum(partials, 0)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * float(ref.abs().max()))
