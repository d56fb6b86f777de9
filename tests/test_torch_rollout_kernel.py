"""The CUDA rollout kernel's module, ``jaxsim_tpu_torch.ops.cuda_rollout``.

On the CPU, ``rollout`` takes its plain version; it is held against the JAX
package's fused rollout kernel (``build_pallas_rollout``) in interpret mode,
and against ``BatchedEngine.rollout``, the kernel's plain reference in the JAX
package. Tests marked ``gpu`` compare the CUDA kernel with the plain version
on the card and skip without one. JAX is imported inside the tests that use
it, so the ``gpu`` tests also run on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_rollout_kernel.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, bridge, models
from jaxsim_tpu_torch.api.contact import estimate_good_contact_parameters
from jaxsim_tpu_torch.ops import cuda_build, cuda_rollout

torch.set_num_threads(1)

KP, KD = 60.0, 0.5  # the flagship PD policy


def _pendulum(device="cpu"):
    return BatchedEngine.build(
        JaxSimModel.build_from_model_description(models.build_pendulum_urdf(1)), device=device
    )


def _humanoid(device="cpu"):
    model = JaxSimModel.build_from_model_description(models.build_humanoid_urdf())
    params = estimate_good_contact_parameters(
        model,
        number_of_active_collidable_points_steady_state=8,
        max_penetration=0.006,
        damping_ratio=0.15,
    )
    return BatchedEngine.build(model.replace(contact_params=params), device=device)


def _pendulum_state(engine, B, rng):
    st = bridge.state_to_numpy(engine.init_state(B))
    st["s"] = (0.4 + 0.2 * rng.standard_normal(st["s"].shape)).astype(np.float32)
    st["sd"] = (0.3 * rng.standard_normal(st["sd"].shape)).astype(np.float32)
    return st


def _jax_engine(urdf):
    import jaxsim_tpu.api as js
    from jaxsim_tpu.ops.batched_engine import BatchedEngine as JaxEngine

    return JaxEngine.build(js.JaxSimModel.build_from_model_description(urdf))


def _jax_state(arrays):
    import jax.numpy as jnp
    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    return JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def test_cpu_rollout_matches_pallas_rollout_in_interpret_mode():
    """Fixed-base pendulum, B = 128, 3 steps: the port's rollout on the CPU
    against the JAX fused rollout kernel run by the Pallas interpreter."""
    from jax.experimental.pallas import tpu as pltpu

    from jaxsim_tpu.ops import pallas_step as ps

    jeng = _jax_engine(models.build_pendulum_urdf(1))
    teng = bridge.engine_from_numpy(*bridge.reference_engine_arrays(jeng), device="cpu")
    arrays = _pendulum_state(teng, 128, np.random.default_rng(0))
    policy = lambda st: -KP * st.s - KD * st.sd  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        ref = ps.untile_state(ps.build_pallas_rollout(jeng, 3, policy)(ps.tile_state(_jax_state(arrays))))
    before = cuda_rollout.ROLLOUT_KERNEL_LAUNCHES
    got = cuda_rollout.rollout(teng, bridge.state_from_numpy(arrays, device="cpu"), 3, kp=KP, kd=KD)
    assert cuda_rollout.ROLLOUT_KERNEL_LAUNCHES == before  # the plain path
    got, ref = bridge.state_to_numpy(got), bridge.reference_state_arrays(ref)
    for k in bridge.STATE_FIELDS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["pendulum2", "sphere"])
def test_cpu_rollout_matches_engine_rollout(name, monkeypatch):
    """20 steps of the port's rollout on the CPU against the JAX engine's
    ``rollout`` under the same PD policy (tier T: atol 5e-4 per 10 steps)."""
    import jax

    monkeypatch.setenv("JAXSIM_COLLISION_SPHERE_POINTS", "8")

    urdf = models.build_pendulum_urdf(2) if name == "pendulum2" else models.build_sphere_urdf()
    jeng = _jax_engine(urdf)
    teng = bridge.engine_from_numpy(*bridge.reference_engine_arrays(jeng), device="cpu")
    rng = np.random.default_rng(1)
    if name == "pendulum2":
        arrays = _pendulum_state(teng, 32, rng)
    else:
        arrays = bridge.state_to_numpy(teng.init_state(32, base_position=(0.0, 0.0, 0.16)))
        arrays["v"] = (0.5 * rng.standard_normal((6, 32))).astype(np.float32)
    policy = lambda st: -KP * st.s - KD * st.sd  # noqa: E731
    ref = jax.jit(lambda st: jeng.rollout(st, 20, policy=policy))(_jax_state(arrays))
    got = cuda_rollout.rollout(teng, bridge.state_from_numpy(arrays, device="cpu"), 20, kp=KP, kd=KD)
    got, ref = bridge.state_to_numpy(got), bridge.reference_state_arrays(ref)
    for k in bridge.STATE_FIELDS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, atol=1e-3, err_msg=k)


def test_kernel_inputs_for_the_humanoid():
    """What the wrapper hands the kernel: the topology header and the packed
    model arrays (7956 B for the humanoid, as the JAX kernel's inputs)."""
    eng = _humanoid()
    header = cuda_build.topology_header(eng)
    for line in ("#define JX_NL 24", "#define JX_NJ 23", "#define JX_NC 48", "#define JX_FLOATING 1"):
        assert line in header
    assert f"JX_LAM[24] = {{{', '.join(map(str, eng.lam))}}}" in header
    params = cuda_rollout.packed_params(eng)
    assert params.dtype == torch.float32 and params.numel() * 4 == 7956
    offsets = np.cumsum([0] + [t.numel() for t in eng.params().values()])
    assert torch.equal(params[offsets[1] : offsets[2]], eng.M.reshape(-1))


def test_rollout_refuses_other_devices():
    eng = _pendulum(device="meta")
    with pytest.raises(ValueError, match="meta"):
        cuda_rollout.rollout(eng, eng.init_state(4), 1)


# ----- on the card -----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_vs_plain(engine, state, n_steps, tol, stat="max"):
    """Every state field's |Δ| per env (its largest entry) after ``n_steps``,
    taken over the envs by ``stat`` (max or p99.9), is at most ``tol``."""
    before = cuda_rollout.ROLLOUT_KERNEL_LAUNCHES
    kern = cuda_rollout.rollout(engine, state, n_steps)
    torch.cuda.synchronize()
    assert cuda_rollout.ROLLOUT_KERNEL_LAUNCHES == before + 1
    plain = cuda_rollout.rollout_reference(engine, state, n_steps)
    for k, a, b in zip(bridge.STATE_FIELDS, kern.fields(), plain.fields()):
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), k
        per_env = (a - b).abs().reshape(-1, a.shape[-1]).amax(0)
        got = per_env.max() if stat == "max" else torch.quantile(per_env.double(), 0.999)
        assert float(got) <= tol, (k, stat, float(got))


@pytest.mark.gpu
def test_kernel_matches_plain_pendulum(cuda):
    eng = _pendulum(cuda)
    st = bridge.state_from_numpy(_pendulum_state(eng, 1024, np.random.default_rng(0)), device=cuda)
    _kernel_vs_plain(eng, st, 100, tol=1e-4)


@pytest.mark.gpu
def test_kernel_matches_plain_humanoid(cuda):
    """8192 envs: 100 steps from rest; and with the joints displaced and
    moving, so the PD torque and the velocity-product terms matter, 10 steps
    in every env and 100 steps in 99.9 % of them (float32 rounding alone
    sends a few envs far apart by then, in the plain version too)."""
    eng = _humanoid(cuda)
    rng = np.random.default_rng(0)
    arrays = bridge.state_to_numpy(eng.init_state(8192))
    arrays["p"][2] += (0.01 * rng.standard_normal(8192)).astype(np.float32)
    _kernel_vs_plain(eng, bridge.state_from_numpy(arrays, device=cuda), 100, tol=1e-3)
    arrays["s"] = (0.3 * rng.standard_normal(arrays["s"].shape)).astype(np.float32)
    arrays["sd"] = (0.5 * rng.standard_normal(arrays["sd"].shape)).astype(np.float32)
    moving = bridge.state_from_numpy(arrays, device=cuda)
    _kernel_vs_plain(eng, moving, 10, tol=1e-3)
    _kernel_vs_plain(eng, moving, 100, tol=1e-3, stat="p99.9")


@pytest.mark.gpu
def test_kernel_refuses_float64(cuda):
    eng = _pendulum(cuda).to(torch.float64)
    with pytest.raises(ValueError, match="float32"):
        cuda_rollout.rollout(eng, eng.init_state(4), 1)
