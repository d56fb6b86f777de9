"""Auto-resetting RL evaluation rollout in one CUDA kernel launch (K5).

Counterpart of ``jaxsim_tpu/ops/pallas_step.py::build_pallas_env_rollout``
and its ``_env_rollout_kernel``: step, termination on the healthy height
range or the episode length, auto-reset to the episode-start state, and
per-env sums of the reward, the resets and the steps, all in one launch of
``jaxsim_tpu_torch/csrc/env_rollout.cu`` for soft contacts (``LANES`` lanes
an env, its state and the step's working set in shared memory, as the soft
K1) or of ``jaxsim_tpu_torch/csrc/env_rollout_rr.cu`` for relaxed-rigid
contacts (K1-rr's step and geometry, ``RR_LANES`` lanes an env; the respawn
restores the start's ``m`` too), semi-implicit Euler only, on flat ground, an
inclined plane or Fourier terrain.

Ported options: the policy (the PD closure with gains ``kp``, ``kd``; a
linear policy ``W``, ``b``; a tanh MLP ``W1``, ``b1``, ``W2``, ``b2``, one
library per hidden width), per-candidate weights (a leading population axis
``P``: env ``e`` uses candidate ``e // (B // P)``, the JAX
``per_tile_weights``), ``episode_length``, ``healthy_z_range``,
``tau_limit`` (a clip of the linear and MLP policies' torques, as in JAX),
the default reward and ``reset_noise`` with ``seed`` (Philox4x32-10, see
:mod:`jaxsim_tpu_torch.ops.philox`); ``domain``, the five per-env
multipliers ``Kmul``, ``Dmul``, ``mumul``, ``gmul``, ``Mmul`` (each ``(B,)``,
a missing one 1; a relaxed-rigid engine's step reads ``gmul`` and ``Mmul``,
its solve the engine's μ, as the JAX engine's), and on Fourier terrain
``terr_off`` ``(2, B)``
and ``terrain_relative`` (the base height less the terrain's under it, with
the env's offset, in the observation's last row and in the healthy-height
test; the reward keeps the absolute height, as JAX's default reward).
Weights are call-time inputs.

Refused with ``ValueError``: a Python ``policy`` or ``reward`` closure on a
CUDA state (a CPU state runs one in the plain version; ROADMAP Queue 2 item
6).

:func:`env_rollout` takes :func:`env_rollout_reference`, the plain version
(a loop over the twin's step with :mod:`jaxsim_tpu_torch.ops.policies`), for
a CPU state and the kernel for a CUDA state; a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import cuda_build, cuda_rollout
from .batched_engine import DOMAIN_NAMES, BatchedEngine, BatchedState
from .cuda_build import CSRC, F32, I32, PTR, BuildJob, KernelBuild, packed_params
from .philox import reset_noise as philox_reset_noise
from .policies import default_reward, linear_policy_tau, mlp_policy_tau, obs_dim, select

# Launches of the CUDA kernel made by env_rollout(), in this process: of its
# soft build, and of its relaxed-rigid one.
ENV_ROLLOUT_KERNEL_LAUNCHES = 0
ENV_ROLLOUT_RR_KERNEL_LAUNCHES = 0

SOURCE = CSRC / "env_rollout.cu"
SIGNATURES = {
    "jx_weight_count": [],
    "jx_env_rollout": [PTR] * 17 + [I32, I32] + [F32] * 10
    + [I32, F32, F32, I32, F32, F32, ctypes.c_uint, I32, PTR, PTR, PTR],
    "jx_env_geometry": [PTR],
}
RR_SOURCE = CSRC / "env_rollout_rr.cu"
# The relaxed-rigid entry point's arguments: the soft one's with the
# relaxed-rigid tail of the scalars (cuda_build.rr_scalars) after kp, kd.
RR_SIGNATURES = {
    "jx_weight_count": [],
    "jx_env_rollout_rr": [PTR] * 17 + [I32, I32] + [F32] * 23
    + [I32, F32, F32, I32, F32, F32, ctypes.c_uint, I32, PTR, PTR, PTR],
    "jx_env_rr_geometry": [PTR],
}
POLICY_KINDS = {"pd": 0, "linear": 1, "mlp": 2}
# Lanes of a warp that carry one env (a build-time constant; PERF.md §6 has
# the times of the counts tried): the soft build's, and the relaxed-rigid
# one's (K1-rr's).
LANES = 4
RR_LANES = cuda_rollout.RR_LANES


@dataclasses.dataclass(frozen=True)
class Policy:
    """The policy of an env rollout: its kind, and its weights with a leading
    population axis ``(P, ...)`` (``P = 1`` for one policy for every env)."""

    kind: str  # "pd", "linear" or "mlp"
    weights: tuple[torch.Tensor, ...] = ()
    hidden: int = 0  # H of the MLP

    @property
    def candidates(self) -> int:
        return self.weights[0].shape[0] if self.weights else 1

    def packed(self) -> torch.Tensor:
        """``(P, weight count)``: each candidate's weights flattened in the
        kernel's order (``W | b`` or ``W1 | b1 | W2 | b2``)."""
        return torch.cat([w.reshape(w.shape[0], -1) for w in self.weights], 1).contiguous()


def make_policy(engine: BatchedEngine, W=None, b=None, W1=None, b1=None, W2=None, b2=None) -> Policy:
    """The :class:`Policy` of the given weights (the PD closure when none are
    given), each with a population axis and checked against the engine."""
    n, d = engine.n_joints, obs_dim(engine.n_joints)
    if W is not None and W1 is not None:
        raise ValueError("pass either the linear weights W, b or the MLP weights W1, b1, W2, b2")
    if W is None and W1 is None:
        if any(x is not None for x in (b, b1, W2, b2)):
            raise ValueError("biases or W2 without W or W1")
        return Policy("pd")
    if W is not None:
        lead = (W.shape[0],) if W.ndim == 3 else ()
        b = torch.zeros(lead + (n, 1), dtype=W.dtype, device=W.device) if b is None else b
        named = dict(W=(W, (n, d)), b=(b, (n, 1)))
        kind, hidden = "linear", 0
    else:
        if W2 is None or b1 is None or b2 is None:
            raise ValueError("the MLP policy takes W1, b1, W2 and b2")
        lead = (W1.shape[0],) if W1.ndim == 3 else ()
        hidden = W1.shape[-2]
        if hidden < 1:
            raise ValueError("the MLP needs a hidden width of at least 1")
        named = dict(W1=(W1, (hidden, d)), b1=(b1, (hidden, 1)), W2=(W2, (n, hidden)), b2=(b2, (n, 1)))
        kind = "mlp"
    weights = []
    for name, (w, shape) in named.items():
        if name.startswith("b"):  # JAX takes a bias as (k,) or (k, 1)
            w = w.reshape(lead + shape)
        if tuple(w.shape) != lead + shape:
            raise ValueError(f"{name} must have shape {lead + shape}, got {tuple(w.shape)}")
        weights.append(w if lead else w.unsqueeze(0))
    return Policy(kind, tuple(weights), hidden)


def check_options(
    engine: BatchedEngine,
    device: torch.device,
    *,
    policy=None,
    reward=None,
    tau_limit=None,
    learned: bool = False,
    domain=None,
    terr_off=None,
    terrain_relative: bool = False,
) -> None:
    """Refuse what the port does not run, before anything is built or
    launched; ``device`` is the state's."""
    unknown = set(domain or {}) - set(DOMAIN_NAMES)
    if unknown:
        raise ValueError(f"unknown domain multipliers: {sorted(unknown)} (terrOff is the terr_off argument)")
    if (terr_off is not None or terrain_relative) and engine.terrain_kind != "fourier":
        raise ValueError("terr_off and terrain_relative need a Fourier-terrain engine")
    if policy is not None and learned:
        raise ValueError("pass either a policy closure or policy weights")
    if tau_limit is not None and not learned:
        raise ValueError("tau_limit clips the linear and MLP policies' torques only, as in JAX")
    if device.type == "cuda" and (policy is not None or reward is not None):
        raise ValueError(
            "a Python policy or reward closure cannot run inside the CUDA kernel"
            f" (custom closures: {cuda_build.ITEM_VARIANTS}); on a CUDA state the kernel"
            " takes the PD gains or linear/MLP weights and the default reward"
        )


def _policy_fn(policy: Policy, kp, kd, tau_limit, candidates_axis: bool, hrel_fn=None):
    """The plain policy; ``hrel_fn(state)`` gives the observation's
    terrain-relative height row where there is one."""
    if policy.kind == "pd":
        return lambda st: -kp * st.s - kd * st.sd
    w = policy.weights if candidates_axis else tuple(x[0] for x in policy.weights)
    hrel = hrel_fn or (lambda st: None)
    if policy.kind == "linear":
        return lambda st: linear_policy_tau(st, *w, tau_limit, hrel(st))
    return lambda st: mlp_policy_tau(st, *w, tau_limit, hrel(st))


def env_rollout_reference(
    engine: BatchedEngine,
    state: BatchedState,
    n_steps: int,
    *,
    policy=None,
    reward=None,
    kp: float = 60.0,
    kd: float = 0.5,
    W=None,
    b=None,
    W1=None,
    b1=None,
    W2=None,
    b2=None,
    episode_length: int = 1000,
    healthy_z_range=(0.4, 2.0),
    tau_limit: float | None = None,
    reset_noise: float = 0.0,
    seed: int = 0,
    domain=None,
    terr_off=None,
    terrain_relative: bool = False,
    trace=None,
):
    """The plain version of :func:`env_rollout`: a loop over the twin's step.
    A Python ``policy(state) -> tau`` and ``reward(state, tau, new) -> (B,)``
    may replace the PD closure and the default reward. ``trace(t, sim,
    reward_sum, z, resets, steps)``, when given, sees after each step ``t``
    the state, the reward sums and counts as they stand, and the base height
    of the step's termination test (before a respawn)."""
    learned = W is not None or W1 is not None
    check_options(
        engine, torch.device("cpu"), policy=policy, reward=reward, tau_limit=tau_limit, learned=learned,
        domain=domain, terr_off=terr_off, terrain_relative=terrain_relative,
    )  # fmt: skip
    pol = make_policy(engine, W, b, W1, b1, W2, b2)
    B = state.p.shape[-1]
    if B % pol.candidates:
        raise ValueError(f"the batch {B} does not split into {pol.candidates} candidates")
    pr = engine.params({**(domain or {}), **({} if terr_off is None else {"terrOff": terr_off})})

    def hrel_fn(st):  # the JAX kernel's terrain-relative height, with the env's offset
        return st.p[2] - engine._fourier_height_grad(pr, st.p[0], st.p[1])[0]

    tau_fn = policy or _policy_fn(pol, kp, kd, tau_limit, pol.candidates > 1, hrel_fn if terrain_relative else None)
    reward = reward or default_reward
    z_lo, z_hi = float(healthy_z_range[0]), float(healthy_z_range[1])

    device = state.p.device
    init, sim = state, state
    steps = torch.zeros(B, dtype=torch.int32, device=device)
    resets = torch.zeros(B, dtype=torch.int32, device=device)
    reward_sum = torch.zeros(B, dtype=state.p.dtype, device=device)
    for t in range(n_steps):
        tau = tau_fn(sim)
        new = engine.step(sim, tau, pr)
        steps1 = steps + 1
        z = hrel_fn(new) if terrain_relative else new.p[2]
        done = (z < z_lo) | (z > z_hi) | (steps1 >= episode_length)
        reward_sum = reward_sum + reward(sim, tau, new)
        p0 = init.p
        if reset_noise > 0.0:
            p0 = p0 + philox_reset_noise(seed, t, B, reset_noise, device).to(p0.dtype)
        fresh = (init.s, init.sd, p0, init.q, init.v, init.m)
        sim = BatchedState(*(select(done, f, x) for f, x in zip(fresh, new.fields())))
        steps = torch.where(done, torch.zeros_like(steps1), steps1)
        resets = resets + done.to(torch.int32)
        if trace is not None:
            trace(t, sim, reward_sum, z, resets, steps)
    return sim, reward_sum, resets, steps


def job(
    engine: BatchedEngine, policy: Policy, lanes: int | None = None, *, domain: bool = False, terr_off: bool = False,
    terrain_rel: bool = False,
) -> BuildJob:
    """The library for ``engine`` and ``policy``: the soft env rollout or the
    relaxed-rigid one, with ``lanes`` lanes an env (``LANES`` or
    ``RR_LANES`` by default); the per-env options (``domain``:
    ``JX_DOMAIN``, ``terr_off``: ``JX_TERR_OFF``, ``terrain_rel``:
    ``JX_TERRAIN_REL``) each build a library of their own."""
    kind = (("JX_POLICY", POLICY_KINDS[policy.kind]), ("JX_HIDDEN", max(policy.hidden, 1)))
    options = (("JX_DOMAIN", 1),) * domain + (("JX_TERR_OFF", 1),) * terr_off + (("JX_TERRAIN_REL", 1),) * terrain_rel
    if engine.contact_model == "relaxed_rigid":
        defines = (*kind, ("JX_RR_LANES", int(lanes or RR_LANES)), ("JX_RR_TAU_ROW", 1), *options)
        return BuildJob(engine, RR_SOURCE, RR_SIGNATURES, defines)
    return BuildJob(engine, SOURCE, SIGNATURES,
                    (*kind, ("JX_LN_LANES", int(lanes or LANES)), ("JX_LN_FORWARD", 1), *options))  # fmt: skip


def build(engine: BatchedEngine, policy: Policy, **options) -> KernelBuild:
    return cuda_build.build(job(engine, policy, **options))


def envs_per_block(engine: BatchedEngine, policy: Policy, lanes: int | None = None, terrain_rel: bool = False) -> int:
    """Envs a block of the kernel for ``policy`` takes (the generated
    header's: :func:`cuda_build.lane_tables`, or :func:`cuda_build.rr_tables`
    for a relaxed-rigid engine)."""
    kind, hidden = POLICY_KINDS[policy.kind], max(policy.hidden, 1)
    if engine.contact_model == "relaxed_rigid":
        return cuda_build.rr_tables(engine, lanes or RR_LANES, tau_row=True, policy=kind, hidden=hidden)["envs"]
    return cuda_build.lane_tables(engine, lanes or LANES, forward=True, policy=kind, hidden=hidden,
                                  terrain_rel=terrain_rel)["envs"]  # fmt: skip


def check_candidates(
    engine: BatchedEngine, B: int, policy: Policy, lanes: int | None = None, terrain_rel: bool = False
) -> None:
    """A batch of ``B`` envs splits evenly into the policy's candidates, and
    with several candidates each candidate's envs fill whole blocks of the
    kernel, so that a block loads one candidate's weights."""
    P, envs = policy.candidates, envs_per_block(engine, policy, lanes, terrain_rel)
    if B % P or (P > 1 and (B // P) % envs):
        raise ValueError(
            f"{P} candidates need a batch of P · k · {envs} envs (whole blocks per candidate), got {B}"
        )


def geometry(kernel: KernelBuild) -> dict[str, int]:
    """The kernel's launch: threads and envs a block, the dynamic shared
    memory a block takes in bytes, and the blocks an SM holds at once (CUDA's
    occupancy calculator)."""
    relaxed = hasattr(kernel.lib, "jx_env_rr_geometry")
    return cuda_build.geometry(kernel, "jx_env_rr_geometry" if relaxed else "jx_env_geometry")


def launch(
    kernel: KernelBuild, engine: BatchedEngine, state: BatchedState, n_steps: int, policy: Policy, *, kp, kd,
    episode_length, healthy_z_range, tau_limit, reset_noise, seed, mul=None, off=None,
):
    """One launch of ``kernel`` (the engine's env-rollout library for
    ``policy``, or a variant of it) on a checked CUDA state, with the
    build's checked per-env rows ``mul`` and ``off``
    (:func:`cuda_build.domain_rows`); counts nothing. Returns as
    :func:`env_rollout`."""
    weights = policy.packed() if policy.weights else None
    if weights is not None:
        cuda_build.check_tensor("policy weights", weights, weights.shape, engine.S.device)
    if kernel.lib.jx_weight_count() != (weights.shape[1] if weights is not None else 0):
        raise RuntimeError("packed policy weights disagree with the kernel's layout")
    B, device = state.p.shape[-1], state.p.device
    relaxed = engine.contact_model == "relaxed_rigid"
    out = cuda_build.empty_state_like(state)
    reward_sum = torch.empty(B, dtype=torch.float32, device=device)
    resets = torch.empty(B, dtype=torch.int32, device=device)
    steps = torch.empty(B, dtype=torch.int32, device=device)
    cuda_build.launch(
        kernel, "jx_env_rollout_rr" if relaxed else "jx_env_rollout", packed_params(engine), device,
        *cuda_build.state_pointers(state), None if weights is None else weights.data_ptr(),
        *cuda_build.state_pointers(out), reward_sum.data_ptr(), resets.data_ptr(), steps.data_ptr(),
        B, int(n_steps), *cuda_build.engine_scalars(engine), float(kp), float(kd),
        *(cuda_build.rr_scalars(engine) if relaxed else ()),
        int(episode_length), float(healthy_z_range[0]), float(healthy_z_range[1]), int(tau_limit is not None), float(tau_limit or 0.0),
        float(reset_noise * 3.0**0.5) if reset_noise > 0.0 else 0.0,
        int(seed) & 0xFFFFFFFF, B // policy.candidates,
        *(None if t is None else t.data_ptr() for t in (mul, off)),
    )  # fmt: skip
    return out, reward_sum, resets, steps


def env_rollout(
    engine: BatchedEngine,
    state: BatchedState,
    n_steps: int,
    *,
    policy=None,
    reward=None,
    kp: float = 60.0,
    kd: float = 0.5,
    W=None,
    b=None,
    W1=None,
    b1=None,
    W2=None,
    b2=None,
    episode_length: int = 1000,
    healthy_z_range=(0.4, 2.0),
    tau_limit: float | None = None,
    reset_noise: float = 0.0,
    seed: int = 0,
    domain=None,
    terr_off=None,
    terrain_relative: bool = False,
):
    """Run ``n_steps`` of auto-resetting episodes in every env; returns
    ``(final_state, reward_sum (B,) float32, resets (B,) int32, steps (B,)
    int32)``. One kernel launch for a CUDA state; the plain version for a
    CPU state."""
    global ENV_ROLLOUT_KERNEL_LAUNCHES, ENV_ROLLOUT_RR_KERNEL_LAUNCHES
    opts = dict(
        policy=policy, reward=reward, kp=kp, kd=kd, W=W, b=b, W1=W1, b1=b1, W2=W2, b2=b2,
        episode_length=episode_length, healthy_z_range=healthy_z_range, tau_limit=tau_limit,
        reset_noise=reset_noise, seed=seed, domain=domain, terr_off=terr_off,
        terrain_relative=terrain_relative,
    )  # fmt: skip
    if cuda_build.is_cpu(state, "env rollout"):
        return env_rollout_reference(engine, state, n_steps, **opts)
    learned = W is not None or W1 is not None
    check_options(
        engine, state.p.device, policy=policy, reward=reward, tau_limit=tau_limit, learned=learned,
        domain=domain, terr_off=terr_off, terrain_relative=terrain_relative,
    )  # fmt: skip
    B = cuda_build.check_cuda_call(engine, state, cuda_rollout.CONTACT_MODELS, terrains=cuda_build.TERRAINS)
    mul, off = cuda_build.domain_rows(engine, B, domain, terr_off, engine.S.device)
    pol = make_policy(engine, W, b, W1, b1, W2, b2)
    check_candidates(engine, B, pol, terrain_rel=terrain_relative)
    kernel = build(engine, pol, domain=mul is not None, terr_off=off is not None, terrain_rel=bool(terrain_relative))
    out = launch(
        kernel, engine, state, n_steps, pol, kp=kp, kd=kd, episode_length=episode_length,
        healthy_z_range=healthy_z_range, tau_limit=tau_limit, reset_noise=reset_noise, seed=seed, mul=mul, off=off,
    )  # fmt: skip
    if engine.contact_model == "relaxed_rigid":
        ENV_ROLLOUT_RR_KERNEL_LAUNCHES += 1
    else:
        ENV_ROLLOUT_KERNEL_LAUNCHES += 1
    return out
