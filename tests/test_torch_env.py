"""The RL evaluation path of the port: the env rollout (K5,
``jaxsim_tpu_torch.ops.cuda_env_rollout``), its reset noise, and
``jaxsim_tpu_torch.envs.BatchedEnv``.

On the CPU the plain versions are held against the JAX package on the tiny
floating model of ``test_torch_engine.py``: ``env_rollout_reference``
against a JAX loop with the env rollout kernel's semantics, built from the
JAX package's own ``engine.step`` and ``pallas_step`` policy and reward
helpers; the JAX kernel itself in interpret mode (``slow``); and
``BatchedEnv`` against the JAX ``BatchedEnv``. Tests marked ``gpu`` compare
the CUDA kernel with its plain version on the card and skip without one;
they import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_env.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jaxsim_tpu_torch import bridge
from jaxsim_tpu_torch.envs import BatchedEnv
from jaxsim_tpu_torch.ops import cuda_env_rollout, philox
from jaxsim_tpu_torch.ops.policies import obs_dim

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B = 64
Z_RANGE = (0.05, 2.0)


def _tiny():
    """(JAX engine, port engine) of the tiny floating model (one contact
    point, one revolute joint)."""
    from tests.test_torch_engine import _case

    jeng, teng, _, _, _ = _case("tiny_floating")
    return jeng, teng


def _rr_garpez():
    """(JAX engine, port engine) of garpez with relaxed-rigid contacts (the
    JAX model's ``RelaxedRigidContacts()`` defaults, lowered by the JAX
    package and bridged)."""
    from tests.test_torch_relaxed_rigid import _jax_engine, _port_engine

    jeng = _jax_engine("garpez")
    return jeng, _port_engine(jeng)


# Relaxed-rigid garpez: its base 2 mm below the plane of its four lowest
# corners, which start in contact; a healthy range nothing leaves; and the
# tolerances of the JAX package's relaxed-rigid garpez test over 5 float32
# steps (tests/test_batched_engine.py:1018-1022, GARPEZ_TOL of
# test_torch_relaxed_rigid.py; ṡ rtol 1e-2, atol 1e-2), q and v the box's
# (BOX_TOL), m within 1e-3 of its largest force.
RR_BASE = (0.0, 0.0, -0.002)
RR_Z_RANGE = (-1.0, 2.0)
RR_TOL = dict(s=dict(rtol=1e-3, atol=1e-4), sd=dict(rtol=1e-2, atol=1e-2), p=dict(rtol=1e-3, atol=1e-4),
              q=dict(rtol=1e-3, atol=1e-5), v=dict(rtol=2e-3, atol=2e-4))  # fmt: skip
RR_M_RTOL = 1e-3


def _start_arrays(teng, batch=B, seed=0):
    """Episode-start states at 0.35 m, joints displaced and moving, the base
    moving: the policies' inputs are far from zero."""
    rng = np.random.default_rng(seed)
    arrays = bridge.state_to_numpy(teng.init_state(batch, base_position=(0.0, 0.0, 0.35)))
    arrays["s"] = (0.3 * rng.standard_normal(arrays["s"].shape)).astype(np.float32)
    arrays["sd"] = (0.5 * rng.standard_normal(arrays["sd"].shape)).astype(np.float32)
    arrays["v"] = (0.3 * rng.standard_normal(arrays["v"].shape)).astype(np.float32)
    return arrays


def _jax_state(arrays):
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    return JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _jax_env_loop(jeng, arrays, n_steps, policy, episode_length, z_range=Z_RANGE):
    """The env rollout kernel's semantics (``_env_rollout_kernel``) as a
    plain JAX loop over the JAX engine's step, with its default reward."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops import pallas_step as ps

    init = _jax_state(arrays)

    @jax.jit
    def body(sim, steps, rew, resets):
        tau = policy(sim)
        new = jeng.step(sim, tau)
        steps1 = steps + 1
        z = new.p[2]
        done = (z < z_range[0]) | (z > z_range[1]) | (steps1 >= episode_length)
        rew = rew + ps._default_reward(sim, tau, new)
        sim = jax.tree.map(lambda f, n_: jnp.where(done, f, n_), init, new)
        return sim, jnp.where(done, 0, steps1), rew, resets + done.astype(jnp.int32)

    batch = arrays["p"].shape[-1]
    carry = (init, jnp.zeros(batch, jnp.int32), jnp.zeros(batch, jnp.float32), jnp.zeros(batch, jnp.int32))
    for _ in range(n_steps):
        carry = body(*carry)
    sim, steps, rew, resets = carry
    return bridge.reference_state_arrays(sim), np.asarray(rew), np.asarray(resets), np.asarray(steps)


def _assert_matches(got, ref):
    sim, rew, resets, steps = got
    ref_sim, ref_rew, ref_resets, ref_steps = ref
    np.testing.assert_array_equal(resets.numpy(), ref_resets)
    np.testing.assert_array_equal(steps.numpy(), ref_steps)
    np.testing.assert_allclose(rew.numpy(), ref_rew, err_msg="reward_sum", **TOL)
    for k, v in bridge.state_to_numpy(sim).items():
        np.testing.assert_allclose(v, ref_sim[k], err_msg=k, **TOL)


def _linear_weights(n, seed):
    rng = np.random.default_rng(seed)
    return (
        (0.3 * rng.standard_normal((n, obs_dim(n)))).astype(np.float32),
        (0.1 * rng.standard_normal((n, 1))).astype(np.float32),
    )


def _mlp_weights(n, H, seed):
    rng = np.random.default_rng(seed)
    d = obs_dim(n)
    return tuple(
        (scale * rng.standard_normal(shape)).astype(np.float32)
        for scale, shape in ((0.5, (H, d)), (0.1, (H, 1)), (2.0, (n, H)), (0.1, (n, 1)))
    )


def _jax_linear(W, b, n, tau_limit=None):
    from jaxsim_tpu.ops import pallas_step as ps

    return lambda st: ps._linear_policy_tau(st, lambda a, k: W[a, k], lambda a: b[a, 0], n, tau_limit)


def _jax_mlp(W1, b1, W2, b2, n, tau_limit=None):
    from jaxsim_tpu.ops import pallas_step as ps

    return lambda st: ps._mlp_policy_tau(
        st, lambda h, k: W1[h, k], lambda h: b1[h, 0], lambda a, h: W2[a, h], lambda a: b2[a, 0],
        n, W1.shape[0], tau_limit,
    )  # fmt: skip


def test_env_rollout_pd_with_truncation_matches_jax_loop():
    """The PD closure, 5 steps with episodes of 2: truncation fires mid-
    rollout, so respawned envs are stepped again."""
    jeng, teng = _tiny()
    arrays = _start_arrays(teng)
    ref = _jax_env_loop(jeng, arrays, 5, lambda st: -60.0 * st.s - 0.5 * st.sd, 2)
    before = cuda_env_rollout.ENV_ROLLOUT_KERNEL_LAUNCHES
    got = cuda_env_rollout.env_rollout(
        teng, bridge.state_from_numpy(arrays, device="cpu"), 5, episode_length=2, healthy_z_range=Z_RANGE
    )
    assert cuda_env_rollout.ENV_ROLLOUT_KERNEL_LAUNCHES == before  # the plain path
    assert int(got[2].sum()) == 2 * B
    _assert_matches(got, ref)


def test_env_rollout_relaxed_rigid_matches_jax_loop():
    """Relaxed-rigid garpez in contact under the PD law of the JAX package's
    garpez test (kp 20, kd 0.1), 5 steps with episodes of 3: every env
    respawns at step 3, with the start's m (seeded, not the solved forces),
    and steps twice more warm-started from it; at step 6 it respawns again,
    and its m is the start's."""
    jeng, teng = _rr_garpez()
    rng = np.random.default_rng(5)
    arrays = _start_arrays(teng, batch=16, seed=5)
    arrays["p"] = np.tile(np.asarray(RR_BASE, np.float32)[:, None], (1, 16))
    arrays["s"] = (0.05 * rng.standard_normal(arrays["s"].shape)).astype(np.float32)
    arrays["m"] = (2.0 * rng.standard_normal(arrays["m"].shape)).astype(np.float32)
    policy = lambda st: -20.0 * st.s - 0.1 * st.sd  # noqa: E731
    state = bridge.state_from_numpy(arrays, device="cpu")
    kw = dict(kp=20.0, kd=0.1, episode_length=3, healthy_z_range=RR_Z_RANGE)
    ref = _jax_env_loop(jeng, arrays, 5, policy, 3, RR_Z_RANGE)
    got = cuda_env_rollout.env_rollout(teng, state, 5, **kw)
    assert int(got[2].sum()) == 16 and int(teng._point_geometry(*teng.fk(got[0]), teng.params())["active"].sum())
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    np.testing.assert_array_equal(got[3].numpy(), ref[3])
    np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-3, atol=1e-4, err_msg="reward_sum")
    final = bridge.state_to_numpy(got[0])
    for k, tol in RR_TOL.items():
        np.testing.assert_allclose(final[k], ref[0][k], err_msg=k, **tol)
    scale = max(1.0, float(np.abs(ref[0]["m"]).max()))
    np.testing.assert_allclose(final["m"], ref[0]["m"], rtol=0, atol=RR_M_RTOL * scale, err_msg="m")
    again = cuda_env_rollout.env_rollout(teng, state, 6, **kw)
    assert torch.equal(again[0].m, state.m) and int(again[2].sum()) == 32


def test_env_rollout_linear_policy_matches_jax_loop():
    """``tau = clip(W @ obs + b)``, episodes of 3 over 5 steps."""
    jeng, teng = _tiny()
    n = teng.n_joints
    W, b = _linear_weights(n, 1)
    arrays = _start_arrays(teng, seed=1)
    ref = _jax_env_loop(jeng, arrays, 5, _jax_linear(W, b, n, tau_limit=2.0), 3)
    w = bridge.policy_weights_from_numpy(W=W, b=b, device="cpu")
    got = cuda_env_rollout.env_rollout_reference(
        teng, bridge.state_from_numpy(arrays, device="cpu"), 5,
        episode_length=3, healthy_z_range=Z_RANGE, tau_limit=2.0, **w,
    )  # fmt: skip
    _assert_matches(got, ref)


def test_env_rollout_mlp_per_candidate_matches_jax_loop():
    """A tanh MLP with two candidates over 64 envs: each half matches the
    JAX loop under its own candidate's weights, and the two halves differ."""
    jeng, teng = _tiny()
    n, H = teng.n_joints, 8
    cands = [_mlp_weights(n, H, seed) for seed in (2, 3)]
    arrays = _start_arrays(teng, seed=2)
    half = B // 2
    refs = [
        _jax_env_loop(jeng, {k: v[..., i * half : (i + 1) * half] for k, v in arrays.items()}, 4,
                      _jax_mlp(*cands[i], n, tau_limit=5.0), 3)
        for i in range(2)
    ]  # fmt: skip
    ref = tuple(
        {k: np.concatenate([refs[0][0][k], refs[1][0][k]], -1) for k in refs[0][0]} if j == 0
        else np.concatenate([refs[0][j], refs[1][j]], -1)
        for j in range(4)
    )  # fmt: skip
    stacked = {name: np.stack([c[i] for c in cands]) for i, name in enumerate(("W1", "b1", "W2", "b2"))}
    w = bridge.policy_weights_from_numpy(device="cpu", **stacked)
    got = cuda_env_rollout.env_rollout(
        teng, bridge.state_from_numpy(arrays, device="cpu"), 4,
        episode_length=3, healthy_z_range=Z_RANGE, tau_limit=5.0, **w,
    )  # fmt: skip
    _assert_matches(got, ref)
    assert not np.allclose(refs[0][1], refs[1][1])  # the candidates differ
    single = cuda_env_rollout.env_rollout(
        teng, bridge.state_from_numpy(arrays, device="cpu"), 4,
        episode_length=3, healthy_z_range=Z_RANGE, tau_limit=5.0,
        **bridge.policy_weights_from_numpy(device="cpu", **dict(zip(("W1", "b1", "W2", "b2"), cands[0]))),
    )  # fmt: skip
    assert torch.equal(single[1][:half], got[1][:half])
    assert not torch.equal(single[1][half:], got[1][half:])


@pytest.mark.slow
def test_env_rollout_matches_pallas_env_rollout_in_interpret_mode():
    """The JAX env rollout kernel, run by the Pallas interpreter (B = 1024,
    PD closure, 3 steps with episodes of 2), against the port's plain version."""
    from jax.experimental.pallas import tpu as pltpu

    from jaxsim_tpu.ops import pallas_step as ps

    jeng, teng = _tiny()
    arrays = _start_arrays(teng, batch=1024)
    policy = lambda st: -5.0 * st.s - 0.1 * st.sd  # noqa: E731
    run = ps.build_pallas_env_rollout(jeng, 3, policy=policy, episode_length=2, healthy_z_range=Z_RANGE)
    with pltpu.force_tpu_interpret_mode():
        out, rew, resets, steps = run(ps.tile_state(_jax_state(arrays)))
    ref = (
        bridge.reference_state_arrays(ps.untile_state(out)),
        *(np.asarray(a).reshape(-1) for a in (rew, resets, steps)),
    )
    got = cuda_env_rollout.env_rollout(
        teng, bridge.state_from_numpy(arrays, device="cpu"), 3, kp=5.0, kd=0.1,
        episode_length=2, healthy_z_range=Z_RANGE,
    )  # fmt: skip
    assert int(got[2].sum()) > 0
    _assert_matches(got, ref)


# ----- BatchedEnv -----


@pytest.mark.parametrize(
    "case",
    ["running", "truncation", "termination", "relaxed_rigid"],
)
def test_batched_env_matches_jax_env(case):
    """``reset`` and five ``step``s of the port's BatchedEnv against the JAX
    BatchedEnv (no reset noise): shapes, obs, reward, done, steps. Episodes
    of 3 truncate at step 3; an impossible healthy range terminates every
    step. The relaxed-rigid case is garpez in contact (its base at
    ``RR_BASE``), episodes of 3 so that the respawned state, ``m`` with it,
    is stepped again; its obs at the relaxed-rigid tolerances (``RR_TOL``
    by the observation's rows), its reward at rtol 1e-3, atol 1e-4."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.envs import BatchedEnv as JaxEnv

    jeng, teng = _rr_garpez() if case == "relaxed_rigid" else _tiny()
    kwargs = dict(reset_base_position=(0.0, 0.0, 0.35), reset_noise_std=0.0, healthy_z_range=Z_RANGE)
    kwargs.update(dict(running={}, truncation=dict(episode_length=3),
                       termination=dict(healthy_z_range=(10.0, 20.0)),
                       relaxed_rigid=dict(episode_length=3, reset_base_position=RR_BASE,
                                          healthy_z_range=RR_Z_RANGE))[case])  # fmt: skip
    jenv = JaxEnv(engine=jeng, action_scale=2.0, **kwargs)
    env = bridge.env_from_numpy(bridge.reference_env_fields(jenv), teng)
    batch, n = 8, teng.n_joints
    jstate, jobs = jenv.reset(jax.random.PRNGKey(0), batch)
    state, obs = env.reset(torch.Generator().manual_seed(0), batch)
    assert tuple(obs.shape) == (obs_dim(n), batch)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)
    rng = np.random.default_rng(4)
    jstep = jax.jit(jenv.step)
    dones = []
    # Per observation row [s, sd, q, v, p_z], its tolerance.
    rows = [TOL] * obs_dim(n) if case != "relaxed_rigid" else (
        [RR_TOL["s"]] * n + [RR_TOL["sd"]] * n + [RR_TOL["q"]] * 4 + [RR_TOL["v"]] * 6 + [RR_TOL["p"]])
    rew_tol = dict(rtol=1e-3, atol=1e-4) if case == "relaxed_rigid" else TOL
    for _ in range(5):
        action = rng.standard_normal((n, batch)).astype(np.float32)
        jstate, jobs, jrew, jdone = jstep(jstate, jnp.asarray(action))
        state, obs, rew, done = env.step(state, torch.from_numpy(action))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(state.steps.numpy(), np.asarray(jstate.steps))
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), **rew_tol)
        for row, tol in enumerate(rows):
            np.testing.assert_allclose(obs[row].numpy(), np.asarray(jobs)[row], err_msg=f"obs row {row}", **tol)
        dones.append(done)
    if case == "relaxed_rigid":
        assert int(teng._point_geometry(*teng.fk(state.sim), teng.params())["active"].sum()) > 0
    dones = torch.stack(dones)
    want = dict(running=[False] * 5, truncation=[False, False, True, False, False], termination=[True] * 5,
                relaxed_rigid=[False, False, True, False, False])[case]  # fmt: skip
    assert dones.all(1).tolist() == want and (dones.any(1) == dones.all(1)).all()


def test_fused_eval_rollout_is_the_env_rollout_from_a_fresh_sim():
    """On a CPU engine ``fused_eval_rollout`` is the env rollout's plain
    version from ``reset``'s fresh state; ``rollout`` stacks ``step``."""
    _, teng = _tiny()
    env = BatchedEnv(engine=teng, episode_length=3, reset_base_position=(0.0, 0.0, 0.35), healthy_z_range=Z_RANGE)
    W, b = (torch.from_numpy(x) for x in _linear_weights(teng.n_joints, 5))
    final, rew, resets = env.fused_eval_rollout(torch.Generator().manual_seed(3), 16, 5, W=W, b=b)
    sim = env.reset(torch.Generator().manual_seed(3), 16)[0].sim
    ref = cuda_env_rollout.env_rollout_reference(
        teng, sim, 5, W=W, b=b, episode_length=3, healthy_z_range=Z_RANGE
    )
    assert torch.equal(rew, ref[1]) and torch.equal(resets, ref[2]) and int(resets.sum()) == 16
    for a, c in zip(final.fields(), ref[0].fields()):
        assert torch.equal(a, c)
    state, _ = env.reset(torch.Generator().manual_seed(0), 16)
    _, (obs, rewards, dones) = env.rollout(state, lambda o: torch.zeros(teng.n_joints, 16), 4)
    assert tuple(obs.shape) == (4, obs_dim(teng.n_joints), 16) and tuple(rewards.shape) == (4, 16)
    assert dones[2].all() and not dones[[0, 1, 3]].any()


# ----- reset noise -----


def _np_philox4x32(counter, key):
    """Philox4x32-10 in NumPy uint64 arithmetic (32 × 32-bit products are
    exact there), independent of the port's torch limbs."""
    mask = np.uint64(0xFFFFFFFF)
    c = [np.asarray(x, dtype=np.uint64) & mask for x in counter]
    k0, k1 = (np.asarray(x, dtype=np.uint64) & mask for x in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + np.uint64(0x9E3779B9)) & mask, (k1 + np.uint64(0xBB67AE85)) & mask
        p0 = c[0] * np.uint64(0xD2511F53)
        p1 = c[2] * np.uint64(0xCD9E8D57)
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & mask, (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & mask]
    return c


def test_philox_matches_numpy_and_the_known_answer():
    # Random123's known-answer vector for philox4x32-10 at counter 0, key 0.
    assert [int(x) for x in philox.philox4x32((0, 0, 0, 0), (0, 0))] == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8,
    ]  # fmt: skip
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(6, 4096), dtype=np.uint64)
    got = philox.philox4x32(
        [torch.from_numpy(w.astype(np.int64)) for w in words[:4]],
        [torch.from_numpy(w.astype(np.int64)) for w in words[4:]],
    )
    want = _np_philox4x32(words[:4], words[4:])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def test_reset_noise_distribution():
    """Uniform noise of the asked standard deviation, fresh at every step
    and in every env and row."""
    noise = torch.cat([philox.reset_noise(7, step, 20000, 0.02) for step in range(5)], 1)
    assert tuple(noise.shape) == (3, 100000)
    assert float(noise.abs().max()) <= 0.02 * 3**0.5
    np.testing.assert_allclose(noise.mean(1).numpy(), 0.0, atol=3e-4)
    np.testing.assert_allclose(noise.std(1).numpy(), 0.02, rtol=1e-2)
    assert not torch.equal(philox.reset_noise(7, 0, 8, 0.02), philox.reset_noise(7, 1, 8, 0.02))
    assert not torch.equal(philox.reset_noise(7, 0, 8, 0.02), philox.reset_noise(8, 0, 8, 0.02))


def test_env_rollout_reset_noise_moves_only_respawned_envs():
    _, teng = _tiny()
    arrays = _start_arrays(teng)
    state = bridge.state_from_numpy(arrays, device="cpu")
    kw = dict(episode_length=2, healthy_z_range=Z_RANGE, seed=11)
    quiet = cuda_env_rollout.env_rollout(teng, state, 2, **kw)
    noisy = cuda_env_rollout.env_rollout(teng, state, 2, reset_noise=0.02, **kw)
    assert int(noisy[2].sum()) == B  # every env respawned once, at step 1
    expected = quiet[0].p + philox.reset_noise(11, 1, B, 0.02)
    assert torch.equal(noisy[0].p, expected)
    for name in ("s", "sd", "q", "v", "m"):
        assert torch.equal(getattr(noisy[0], name), getattr(quiet[0], name))


# ----- what is not ported -----


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(domain={"Kscale": None}), "unknown domain multipliers"),
        (dict(terr_off=object()), "Fourier"),
        (dict(terrain_relative=True), "Fourier"),
        (dict(policy=lambda st: st.s), "closure"),
        (dict(reward=lambda st, tau, new: new.p[2]), "closure"),
        (dict(tau_limit=1.0), "tau_limit"),
        (dict(policy=lambda st: st.s, learned=True), "either"),
    ],
)
def test_options_refused_before_any_launch(kwargs, match):
    """The argument check that runs first for a CUDA state, on a CUDA-typed
    device, with no card needed (the engine on flat ground, so that a
    terrain offset and the terrain-relative height have no terrain)."""
    _, teng = _tiny()
    with pytest.raises(ValueError, match=match):
        cuda_env_rollout.check_options(teng, torch.device("cuda"), **kwargs)


def test_refusals_on_the_cpu():
    _, teng = _tiny()
    state = bridge.state_from_numpy(_start_arrays(teng), device="cpu")
    with pytest.raises(ValueError, match="Fourier"):
        cuda_env_rollout.env_rollout(teng, state, 1, terr_off=torch.zeros(2, B))
    with pytest.raises(ValueError, match="FourierTerrain"):
        BatchedEnv(engine=teng, terrain_relative=True)
    # On the CPU a closure runs in the plain version: zero torques and the
    # bare height are the PD policy with zero gains and the default reward.
    closures = cuda_env_rollout.env_rollout(
        teng, state, 2, policy=lambda st: 0.0 * st.s, reward=lambda st, tau, new: new.p[2]
    )
    zero_gains = cuda_env_rollout.env_rollout(teng, state, 2, kp=0.0, kd=0.0)
    assert torch.equal(closures[0].p, zero_gains[0].p) and torch.equal(closures[1], zero_gains[1])


# ----- on the card -----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _humanoid(device):
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, models
    from jaxsim_tpu_torch.api.contact import estimate_good_contact_parameters

    model = JaxSimModel.build_from_model_description(models.build_humanoid_urdf())
    params = estimate_good_contact_parameters(
        model, number_of_active_collidable_points_steady_state=8, max_penetration=0.006, damping_ratio=0.15
    )
    return BatchedEngine.build(model.replace(contact_params=params), device=device)


def _max_field_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a.fields(), b.fields()) if x.numel())


@pytest.mark.gpu
def test_env_rollout_kernel_matches_plain(cuda):
    """Humanoid, 2048 envs, 8 MLP candidates (H = 16), episodes of 4 and a
    healthy range nothing leaves, 10 steps, with reset noise: resets and steps
    equal in every env, fields and rewards within 1e-3."""
    hum = _humanoid(cuda)
    rng = np.random.default_rng(0)
    arrays = bridge.state_to_numpy(hum.init_state(2048))
    arrays["s"] = (0.3 * rng.standard_normal(arrays["s"].shape)).astype(np.float32)
    arrays["sd"] = (0.5 * rng.standard_normal(arrays["sd"].shape)).astype(np.float32)
    state = bridge.state_from_numpy(arrays, device=cuda)
    n, H, P = hum.n_joints, 16, 8
    gen = torch.Generator(cuda).manual_seed(0)
    d = obs_dim(n)
    w = dict(
        W1=0.1 * torch.randn(P, H, d, generator=gen, device=cuda),
        b1=0.1 * torch.randn(P, H, 1, generator=gen, device=cuda),
        W2=0.1 * torch.randn(P, n, H, generator=gen, device=cuda),
        b2=0.1 * torch.randn(P, n, 1, generator=gen, device=cuda),
    )
    kw = dict(episode_length=4, healthy_z_range=(-1e6, 1e6), tau_limit=100.0, reset_noise=0.02, seed=3, **w)
    before = cuda_env_rollout.ENV_ROLLOUT_KERNEL_LAUNCHES
    kern = cuda_env_rollout.env_rollout(hum, state, 10, **kw)
    torch.cuda.synchronize()
    assert cuda_env_rollout.ENV_ROLLOUT_KERNEL_LAUNCHES == before + 1
    plain = cuda_env_rollout.env_rollout_reference(hum, state, 10, **kw)
    assert torch.equal(kern[2], plain[2]) and torch.equal(kern[3], plain[3])
    assert int(kern[2].sum()) == 2 * 2048
    assert _max_field_diff(kern[0], plain[0]) <= 1e-3
    assert float((kern[1] - plain[1]).abs().max()) <= 1e-3


@pytest.mark.gpu
def test_batched_env_step_runs_the_step_kernel(cuda):
    from jaxsim_tpu_torch.ops import cuda_step

    hum = _humanoid(cuda)
    env = BatchedEnv(engine=hum, episode_length=3)
    state, obs = env.reset(torch.Generator(cuda).manual_seed(0), 1024)
    before = cuda_step.STEP_TAU_KERNEL_LAUNCHES
    for _ in range(4):
        state, obs, rew, done = env.step(state, torch.zeros(hum.n_joints, 1024, device=cuda))
    torch.cuda.synchronize()
    assert cuda_step.STEP_TAU_KERNEL_LAUNCHES == before + 4
    assert torch.isfinite(obs).all() and int(state.steps.max()) == 1
