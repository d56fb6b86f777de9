"""The one-step kernels' module, ``jaxsim_tpu_torch.ops.cuda_step`` (K2, K3),
and the twin's call-time model arrays ``pr``.

On the CPU the wrappers take their plain versions, which are held against
the JAX package: the Pallas one-step kernels in interpret mode on the
fixed-base pendulum (1e-5), and the JAX engine's ``step(state, tau, pr)`` and
PD rollout on the small floating models of ``test_torch_engine.py`` (tier T).
Tests marked ``gpu`` compare each CUDA kernel with its plain version on the
card and skip without one; they import no JAX, so they also run on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_step_kernels.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jaxsim_tpu_torch import bridge, models
from jaxsim_tpu_torch.ops import cuda_step
from jaxsim_tpu_torch.ops.batched_engine import BatchedState

torch.set_num_threads(1)

KP, KD = 60.0, 0.5  # the default PD policy
INTERPRET_TOL = dict(rtol=1e-5, atol=1e-5)


def tier_t(n_steps):
    return dict(rtol=1e-3, atol=5e-4 * max(1, n_steps / 10))


def _jax_state(arrays):
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    return JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _pendulum_pair():
    import jaxsim_tpu.api as js
    from jaxsim_tpu.ops.batched_engine import BatchedEngine as JaxEngine

    jeng = JaxEngine.build(js.JaxSimModel.build_from_model_description(models.build_pendulum_urdf(1)))
    teng = bridge.engine_from_numpy(*bridge.reference_engine_arrays(jeng), device="cpu")
    rng = np.random.default_rng(0)
    arrays = bridge.state_to_numpy(teng.init_state(128, base_position=(0.0, 0.0, 0.0)))
    arrays["s"] = (0.4 + 0.2 * rng.standard_normal(arrays["s"].shape)).astype(np.float32)
    arrays["sd"] = (0.3 * rng.standard_normal(arrays["sd"].shape)).astype(np.float32)
    tau = (2.0 * rng.standard_normal(arrays["s"].shape)).astype(np.float32)
    return jeng, teng, arrays, tau


def _perturbed(params: dict[str, np.ndarray], which: str) -> dict[str, np.ndarray]:
    """Model arrays to override: ``M`` scaled by 1.2, or every array moved."""
    if which == "M":
        return {"M": 1.2 * params["M"]}
    out = {
        "S": 1.1 * params["S"],
        "M": 1.2 * params["M"],
        "axis": 0.9 * params["axis"],
        "lamH": params["lamH"].copy(),
        "sucH": params["sucH"].copy(),
        "cpoint": 1.1 * params["cpoint"],
    }
    out["lamH"][:, :3, 3] += 0.01
    out["sucH"][:, :3, 3] -= 0.01
    return out


def _assert_states_close(got, ref, tol):
    got, ref = bridge.state_to_numpy(got), bridge.reference_state_arrays(ref)
    for k in bridge.STATE_FIELDS:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)


def test_step_pd_reference_matches_pallas_step_in_interpret_mode():
    """K2's plain version against ``build_pallas_step`` (its default PD
    closure) run by the Pallas interpreter, fixed-base pendulum, B = 128."""
    from jax.experimental.pallas import tpu as pltpu

    from jaxsim_tpu.ops import pallas_step as ps

    jeng, teng, arrays, _ = _pendulum_pair()
    with pltpu.force_tpu_interpret_mode():
        ref = ps.untile_state(ps.build_pallas_step(jeng)(ps.tile_state(_jax_state(arrays))))
    before = cuda_step.STEP_PD_KERNEL_LAUNCHES
    got = cuda_step.step_pd(teng, bridge.state_from_numpy(arrays, device="cpu"), KP, KD)
    assert cuda_step.STEP_PD_KERNEL_LAUNCHES == before  # the plain path
    _assert_states_close(got, ref, INTERPRET_TOL)


@pytest.mark.parametrize("which", [None, "M"])
def test_step_tau_reference_matches_pallas_step_tau_in_interpret_mode(which):
    """K3's plain version against ``build_pallas_step_tau`` with the same
    torques and the same call-time model arrays, in the Pallas interpreter."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from jaxsim_tpu.ops import pallas_step as ps

    jeng, teng, arrays, tau = _pendulum_pair()
    over = {} if which is None else _perturbed(bridge.reference_engine_arrays(jeng)[1], which)
    jpr = {**jeng.params(), **{k: jnp.asarray(v) for k, v in over.items()}}
    with pltpu.force_tpu_interpret_mode():
        ref = ps.build_pallas_step_tau(jeng)(
            ps.tile_state(_jax_state(arrays)), jnp.asarray(tau).reshape(tau.shape[0], -1, 128), jpr
        )
    tpr = {k: torch.from_numpy(v) for k, v in over.items()} or None
    got = cuda_step.step_tau(
        teng, bridge.state_from_numpy(arrays, device="cpu"), torch.from_numpy(tau), tpr
    )
    _assert_states_close(got, ps.untile_state(ref), INTERPRET_TOL)


@pytest.mark.parametrize("which", [None, "M", "all"])
@pytest.mark.parametrize("name", ["sphere8", "tiny_floating", "lumped_chain"])
def test_step_tau_matches_engine_step_with_pr(name, which):
    """The twin's step under call-time model arrays against the JAX engine's
    ``step(state, tau, pr)`` (tier T), and the override really moves it."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_engine import _case

    jeng, teng, arrays, tau, _ = _case(name)
    params = bridge.reference_engine_arrays(jeng)[1]
    params["axis"] = params["axis"].reshape(teng.axis.shape)
    over = {} if which is None else _perturbed(params, which)
    jpr = {**jeng.params(), **{k: jnp.asarray(v).reshape(params[k].shape) for k, v in over.items()}}
    ref = jax.jit(lambda st, t, pr: jeng.step(st, t, pr))(_jax_state(arrays), jnp.asarray(tau), jpr)
    state = bridge.state_from_numpy(arrays, device="cpu")
    tpr = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in over.items()} or None
    got = cuda_step.step_tau(teng, state, torch.from_numpy(tau), tpr)
    _assert_states_close(got, ref, tier_t(1))
    if which is not None:
        plain = teng.step(state, torch.from_numpy(tau))
        assert _max_field_diff(got, plain) > 1e-4


def test_rollout_per_step_matches_engine_rollout():
    """20 chained K2 steps (their plain version) against the JAX engine's
    PD rollout, the counterpart of ``pallas_rollout``, on the tiny floating
    model (tier T over 20 steps)."""
    import jax

    from tests.test_torch_engine import _case

    jeng, teng, arrays, _, _ = _case("tiny_floating")
    ref = jax.jit(lambda st: jeng.rollout(st, 20))(_jax_state(arrays))
    before = cuda_step.STEP_PD_KERNEL_LAUNCHES
    got = cuda_step.rollout_per_step(teng, bridge.state_from_numpy(arrays, device="cpu"), 20)
    assert cuda_step.STEP_PD_KERNEL_LAUNCHES == before
    _assert_states_close(got, ref, tier_t(20))
    closure = cuda_step.rollout_per_step(
        teng, bridge.state_from_numpy(arrays, device="cpu"), 20, policy=lambda st: -KP * st.s - KD * st.sd
    )
    for a, b in zip(got.fields(), closure.fields()):
        assert torch.equal(a, b)


def test_pr_refuses_unknown_or_misshapen_arrays():
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel

    eng = BatchedEngine.build(
        JaxSimModel.build_from_model_description(models.build_pendulum_urdf(1)), device="cpu"
    )
    st = eng.init_state(4, base_position=(0.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="unknown"):
        eng.step(st, None, {"Kscale": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        eng.step(st, None, {"M": eng.M[:1]})


def _pendulum_state(eng, B, seed):
    gen = torch.Generator().manual_seed(seed)
    st = eng.init_state(B, base_position=(0.0, 0.0, 0.0))
    return BatchedState(
        *(t + 0.3 * torch.randn(t.shape, generator=gen) if k in ("s", "sd") else t
          for k, t in zip(bridge.STATE_FIELDS, st.fields()))
    )  # fmt: skip


def test_flop_count_counts_arithmetic_per_env():
    """The op counter behind the kernels' bounds: one operation per needed
    output element of elementwise arithmetic (none for a product with 0 or
    ±1, a sum with 0, a negation), the nonzero terms a sum folds in, nothing
    for data movement; and the count per env of a batch of equal envs is the
    count that one more env adds."""
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel
    from jaxsim_tpu_torch.ops import flop_count

    x = torch.full((4, 5), 3.0)
    x[0] = 0.0
    assert flop_count.count_flops(lambda: (x * 2.0 + x).sum(0)) == 15 + 15 + 2 * 5
    assert flop_count.count_flops(lambda: -(x * 1.0) + x * -1.0) == 15
    assert flop_count.count_flops(lambda: torch.cat([x, x]).transpose(0, 1).clone()) == 0
    eng = BatchedEngine.build(
        JaxSimModel.build_from_model_description(models.build_pendulum_urdf(2)), device="cpu"
    )
    one = _pendulum_state(eng, 1, 0)
    same = BatchedState(*(t.repeat_interleave(4, dim=-1) for t in one.fields()))
    per_env = flop_count.ops_per_env(lambda st: cuda_step.step_pd_reference(eng, st), same)
    assert per_env > 0 and per_env == flop_count.ops_per_env(lambda st: cuda_step.step_pd_reference(eng, st), same, 1)


def test_least_algebra_of_aba_pass2_matches_the_twin():
    """The bound's count takes ABA pass 2 in its least algebra: the (R, p)
    form of ``Xᵀ Mₐ X`` and ``Mₐ``'s distinct entries once. Both forms give
    the twin's result (float64, 1e-12) and the least one needs fewer
    operations; a step counted with generic model arrays needs more than
    with the model's own, whose zeros and units cost nothing."""
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel
    from jaxsim_tpu_torch.ops import batched_engine as be
    from jaxsim_tpu_torch.ops import flop_count

    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, 3, generator=gen, dtype=torch.float64)

    def sym():
        a = rand(6, 6)
        return a + a.transpose(0, 1)

    R = torch.stack([torch.linalg.qr(torch.randn(3, 3, generator=gen, dtype=torch.float64)).Q for _ in range(3)], -1)
    R = R * torch.linalg.det(R.permute(2, 0, 1)).sign()  # rotations
    art = (sym(), rand(6), rand(6), 1.0 / (1.0 + rand(1)[0].abs()), rand(1)[0], rand(6))
    Ma, pa = be._articulated(*art)
    par = (sym(), rand(6), R, rand(3), Ma, pa)
    for twin, least, args in ((be._articulated, flop_count.articulated_least, art),
                              (be._to_parent, flop_count.to_parent_least, par)):  # fmt: skip
        for a, b in zip(twin(*args), least(*args)):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
        first = [a[..., :1] for a in args]
        assert flop_count.count_flops(least, *first) < flop_count.count_flops(twin, *first)

    eng = BatchedEngine.build(
        JaxSimModel.build_from_model_description(models.build_pendulum_urdf(3)), device="cpu"
    )
    state = _pendulum_state(eng, 5, 1)
    own = flop_count.least_step_ops(eng, lambda st: cuda_step.step_pd_reference(eng, st), state)
    generic = flop_count.generic_arrays(eng)
    dense = flop_count.least_step_ops(
        eng, lambda st: cuda_step.step_tau_reference(eng, st, -KP * st.s - KD * st.sd, generic), state, pr=generic
    )
    assert 0 < own < dense


# ----- on the card -----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _engines(device):
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel
    from jaxsim_tpu_torch.api.contact import estimate_good_contact_parameters

    pend = BatchedEngine.build(
        JaxSimModel.build_from_model_description(models.build_pendulum_urdf(1)), device=device
    )
    model = JaxSimModel.build_from_model_description(models.build_humanoid_urdf())
    params = estimate_good_contact_parameters(
        model, number_of_active_collidable_points_steady_state=8, max_penetration=0.006, damping_ratio=0.15
    )
    return pend, BatchedEngine.build(model.replace(contact_params=params), device=device)


def _moving(engine, B, seed, z):
    rng = np.random.default_rng(seed)
    arrays = bridge.state_to_numpy(engine.init_state(B, base_position=(0.0, 0.0, z)))
    arrays["s"] = (0.3 * rng.standard_normal(arrays["s"].shape)).astype(np.float32)
    arrays["sd"] = (0.5 * rng.standard_normal(arrays["sd"].shape)).astype(np.float32)
    return bridge.state_from_numpy(arrays, device=engine.S.device)


def _max_field_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a.fields(), b.fields()) if x.numel())


@pytest.mark.gpu
def test_step_kernels_match_plain(cuda):
    """K2 and K3 against their plain versions, 10 chained steps with the
    joints moving, pendulum (B = 1024) and humanoid (B = 8192): every field
    within 1e-3 in every env."""
    for engine, B, z in zip(_engines(cuda), (1024, 8192), (0.0, 0.9)):
        state = _moving(engine, B, 0, z)
        k2, k3, plain = state, state, state
        for _ in range(10):
            k2 = cuda_step.step_pd(engine, k2)
            k3 = cuda_step.step_tau(engine, k3, (-KP * k3.s - KD * k3.sd).contiguous())
            plain = cuda_step.step_pd_reference(engine, plain)
        torch.cuda.synchronize()
        assert _max_field_diff(k2, plain) <= 1e-3
        assert _max_field_diff(k3, plain) <= 1e-3


@pytest.mark.gpu
def test_step_tau_takes_call_time_model_arrays(cuda):
    """K3 with ``M`` scaled by 1.2 matches its plain version under the same
    ``pr`` and differs from the unscaled step."""
    _, hum = _engines(cuda)
    state = _moving(hum, 8192, 1, 0.9)
    tau = (-KP * state.s - KD * state.sd).contiguous()
    pr = {"M": (1.2 * hum.M).contiguous()}
    before = cuda_step.STEP_TAU_KERNEL_LAUNCHES
    scaled = cuda_step.step_tau(hum, state, tau, pr)
    unscaled = cuda_step.step_tau(hum, state, tau)
    torch.cuda.synchronize()
    assert cuda_step.STEP_TAU_KERNEL_LAUNCHES == before + 2
    assert _max_field_diff(scaled, cuda_step.step_tau_reference(hum, state, tau, pr)) <= 1e-3
    assert _max_field_diff(scaled, unscaled) > 1e-4
