"""Gradients through the twin's relaxed-rigid step against the JAX package's.

The twin differentiates its contact solve implicitly (``_PcgImplicit`` in
``jaxsim_tpu_torch/ops/batched_engine.py``), as the JAX engine does with
``pcg_implicit``: λ = PCG(x̄) from zero on the same operator, −b's cotangent
λ, the operator's inputs ∂⟨−λ, A(θ)x⟩/∂θ, none for the preconditioner and
the warm start. Held here, on the same inputs and cotangents (made with
NumPy from a seed, carried across by the bridge):

* the twin's step under autograd (K4-rr's plain version,
  ``cuda_step_vjp.step_vjp_reference``) against ``jax.vjp`` of the JAX
  ``BatchedEngine.step``, the function that JAX's K4 body traces, in every
  state leaf, ``tau`` and every model array, ``rrMinv``'s included: the box
  dropped low and moving and garpez tilted low with its joints displaced
  and moving, points in contact, B = 4, random cotangents on all six leaves
  (``m``'s too, whose share of x̄ reaches λ through inactive points at
  1/reg), float64 within 1e-9 and float32 within ``RR_F32``; the Pallas
  K4's interpret mode is too slow for the JAX package's own relaxed-rigid
  test of it (``tests/test_batched_engine.py:574-575``);
* the gains' gradient through 3 steps of ``diff_step.fused_diff_rollout``
  (its plain version on the CPU) on garpez against the chain rule through
  the same 3 steps of the JAX step, each step's ``jax.vjp``, float64.

The JAX step's output and VJP are one compiled function a model and
precision (``_jax_step_vjp``), which the garpez float64 case and the
rollout's chain share: in one process by ``jax.jit``'s cache, across the
test workers by JAX's persistent compilation cache (``tests/conftest.py``).

Garpez in float32 and the humanoid in float64 are ``slow`` (their JAX VJPs
compile for about a minute and four). The humanoid with its joints moving
is held in float64 only: there float32 roundoff alone moves a few entries
of the state's cotangents 0.4 % (K4-rr's gates on the card, held against
the float64 twin, show the same).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from jaxsim_tpu_torch import bridge
from jaxsim_tpu_torch.ops import diff_step
from tests.test_torch_autograd import F64, _assert_vjp_close, _cast, _port_vjp
from tests.test_torch_relaxed_rigid import (
    _active_points, _box_arrays, _garpez_random_state, _jax_engine, _port_engine,
)  # fmt: skip

torch.set_num_threads(1)

# Float32: each entry within rtol·|JAX| + atol_scale·max(1, max |JAX leaf|):
# the relaxed-rigid forward tests' rtol (BOX_TOL, 1e-3) and an absolute part
# of 1e-4 of the leaf's largest cotangent (BOX_TOL's p is 1e-5 m on
# positions of 0.05 m, 2e-4 of its scale). The two frameworks sum the PCG's
# dot products in other orders, and float32 roundoff in λ (1e6·x̄ on
# inactive points) reaches the active points' digits.
RR_F32 = dict(rtol=1e-3, atol_scale=1e-4)
B = 4


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX engine, state arrays, tau, output cotangent arrays), float64."""
    jeng = _jax_engine(name)
    if name == "box":
        arrays = _box_arrays(B)
    elif name == "garpez":
        arrays = _garpez_random_state(jeng.n_joints, B)
    else:
        arrays = _humanoid_arrays(jeng, B)
    rng = np.random.default_rng(5)
    tau = 0.1 * rng.standard_normal((jeng.n_joints, B))
    ct = {k: rng.standard_normal(a.shape) for k, a in arrays.items()}
    return jeng, arrays, tau, ct


def _humanoid_arrays(jeng, B, seed=2):
    """The humanoid standing with its joints moving 0.5·N(0, 1) rad/s, its
    base 22 mm low so that the feet (2 cm up at rest) press 2 mm into the
    ground."""
    teng = _port_engine(jeng, torch.float64)
    arrays = bridge.state_to_numpy(teng.init_state(B))
    rng = np.random.default_rng(seed)
    arrays["sd"] = 0.5 * rng.standard_normal(arrays["sd"].shape)
    arrays["p"][2] -= 0.022
    return arrays


_STEP_VJPS: dict = {}


def _jax_step_vjp(jeng):
    """The JAX step's output and ``jax.vjp`` at (state, tau, pr) for an
    output cotangent, jitted: one compile a model and precision (``_case``
    keeps one JAX engine a model), its VJP traced by JAX's JVP and partial
    evaluation (``jax_use_direct_linearize`` off while it traces: the same
    arithmetic, and for garpez's step a fifth less trace and compile time
    than the direct linearization)."""
    import jax

    if id(jeng) not in _STEP_VJPS:

        def step_vjp(st, tau, pr, cts):
            out, back = jax.vjp(lambda a, b, c: jeng.step(a, b, c), st, tau, pr)
            return out, back(cts)

        jitted = jax.jit(step_vjp)

        def call(*args):
            old = jax.config.jax_use_direct_linearize
            jax.config.update("jax_use_direct_linearize", False)
            try:
                return jitted(*args)
            finally:
                jax.config.update("jax_use_direct_linearize", old)

        _STEP_VJPS[id(jeng)] = call
    return _STEP_VJPS[id(jeng)]


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
        _, (g_st, g_tau, g_pr) = _jax_step_vjp(jeng)(st, jnp.asarray(tau, dtype), jpr, cts)
        return bridge.reference_state_arrays(g_st), np.asarray(g_tau), bridge.reference_params_arrays(g_pr)


def _check(name, x64: bool):
    jeng, arrays, tau, ct = _case(name)
    dtype_np, dtype = (np.float64, torch.float64) if x64 else (np.float32, torch.float32)
    arrays, ct, tau = _cast(arrays, dtype_np), _cast(ct, dtype_np), np.asarray(tau, dtype_np)
    teng = _port_engine(jeng, dtype)
    assert _active_points(teng, arrays) > 0
    pr = _cast(bridge.reference_params_arrays(jeng.params()), dtype_np)
    # The reference is the JAX VJP in float64 (on the float32 case's
    # float32-rounded inputs): the float64 case's compiled VJP, one trace and
    # compile a model for both cases.
    ref = _jax_vjp(jeng, _cast(arrays, np.float64), np.asarray(tau, np.float64), _cast(ct, np.float64),
                   _cast(pr, np.float64), True)
    got = _port_vjp(teng, arrays, tau, ct, pr, dtype)
    assert "rrMinv" in got[2] and np.abs(ref[2]["rrMinv"]).max() > 0
    if x64:
        _assert_vjp_close(got, ref, F64)
        return
    pairs = [*((f"ct.{k}", got[0][k], ref[0][k]) for k in bridge.STATE_FIELDS), ("ct_tau", got[1], ref[1])]
    pairs += [(f"ct_pr.{k}", got[2][k], ref[2][k]) for k in got[2]]
    for label, a, b in pairs:
        atol = RR_F32["atol_scale"] * max(1.0, float(np.abs(b).max(initial=0.0)))
        np.testing.assert_allclose(a, b, rtol=RR_F32["rtol"], atol=atol, err_msg=label)


def test_rr_rollout_gains_gradient_matches_jax():
    """The PD gains' gradient through 3 steps of ``fused_diff_rollout`` on
    garpez tilted low, joints displaced and moving, against the chain rule
    through the same 3 JAX steps (each step's ``jax.vjp``, the policy's by
    hand), float64."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    jeng, arrays, _, _ = _case("garpez")
    gains0 = np.array([20.0, 0.1])

    def policy(st, gains):
        return -gains[0] * st.s - gains[1] * st.sd

    with jax.enable_x64(True):
        step_vjp = _jax_step_vjp(jeng)
        pr = {k: jnp.asarray(a, jnp.float64) for k, a in bridge.reference_params_arrays(jeng.params()).items()}
        states = [JaxState(**{k: jnp.asarray(a, jnp.float64) for k, a in arrays.items()})]
        zero = JaxState(**{k: jnp.zeros(a.shape, jnp.float64) for k, a in arrays.items()})
        for _ in range(3):
            states.append(step_vjp(states[-1], policy(states[-1], gains0), pr, zero)[0])
        # loss = mean(ṡ²) + mean(p_z) + mean(m²) of the last state.
        out = states[-1]
        p_bar = jnp.zeros_like(out.p).at[2].set(1.0 / out.p.shape[-1])
        ct = JaxState(s=zero.s, sd=2.0 * out.sd / out.sd.size, p=p_bar, q=zero.q, v=zero.v, m=2.0 * out.m / out.m.size)
        ref = np.zeros(2)
        for st in reversed(states[:-1]):
            tau = policy(st, gains0)
            _, (g_st, g_tau, _) = step_vjp(st, tau, pr, ct)
            ref += [float(-(g_tau * st.s).sum()), float(-(g_tau * st.sd).sum())]
            ct = JaxState(s=g_st.s - gains0[0] * g_tau, sd=g_st.sd - gains0[1] * g_tau, p=g_st.p, q=g_st.q,
                          v=g_st.v, m=g_st.m)  # fmt: skip

    teng = _port_engine(jeng, torch.float64)
    gains = torch.tensor(gains0, requires_grad=True)
    out = diff_step.fused_diff_rollout(teng, 3)(bridge.state_from_numpy(arrays, device="cpu", dtype=torch.float64),
                                                policy, gains)  # fmt: skip
    loss = (out.sd**2).mean() + out.p[2].mean() + (out.m**2).mean()
    got = torch.autograd.grad(loss, gains)[0].numpy()
    np.testing.assert_allclose(got, ref, **F64)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize(
    "name, x64", [("garpez", True), ("box", True), ("box", False)], ids=["garpez-float64", "box-float64", "box-float32"]
)
def test_rr_step_vjp_matches_jax_vjp(name, x64):
    """Every state leaf's, tau's and model array's cotangent, rrMinv's too.
    Garpez in float64 comes first, right after the rollout gradient's test,
    which takes the same compiled JAX step VJP: consecutive tests tend to go
    to one test worker, where the compile is done once, and the module's
    longest compile starts early."""
    _check(name, x64)


@pytest.mark.slow
@pytest.mark.parametrize("name, x64", [("garpez", False), ("humanoid23", True)], ids=["garpez-float32", "humanoid23-float64"])
def test_large_rr_step_vjp_matches_jax_vjp(name, x64):
    _check(name, x64)
