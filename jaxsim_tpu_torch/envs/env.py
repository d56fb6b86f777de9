"""Auto-resetting batched RL environment over the port's engine.

Counterpart of ``jaxsim_tpu/envs/env.py``: a vectorized environment with
termination, truncation and in-step auto-reset, in the engine's
trailing-batch layout. It runs where its engine runs. On the card,
:meth:`BatchedEnv.step` takes its physics step in one launch of the one-step
kernel K3 (:func:`jaxsim_tpu_torch.ops.cuda_step.step_tau`), and its reset
selection and observation are elementwise torch ops around it, as the JAX
version leaves them to XLA around the engine step;
:meth:`BatchedEnv.fused_eval_rollout` runs a whole evaluation in one launch
of K5 (:func:`jaxsim_tpu_torch.ops.cuda_env_rollout.env_rollout`).

An explicit ``torch.Generator`` on the engine's device replaces the JAX
key. The kernels are built once per topology and option set and take the
policy weights as inputs, so there is no cache keyed by callables.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from jaxsim_tpu_torch.ops import cuda_env_rollout, cuda_step
from jaxsim_tpu_torch.ops.batched_engine import BatchedEngine, BatchedState
from jaxsim_tpu_torch.ops.policies import select


@dataclasses.dataclass
class EnvState:
    """Per-env simulation state plus episode bookkeeping (trailing batch)."""

    sim: BatchedState
    steps: torch.Tensor  # (B,) int32 steps since episode start
    generator: torch.Generator  # drives the reset noise


@dataclasses.dataclass(frozen=True)
class BatchedEnv:
    """Vectorized environment: ``reset``/``step`` with per-env auto-reset.

    Args:
        engine: The batch-minor physics engine.
        episode_length: Truncation horizon (steps).
        action_scale: Torques are ``action · action_scale``.
        reset_base_position: Episode-start base position.
        reset_noise_std: Std of the Gaussian noise on the reset position.
        healthy_z_range: Episode terminates when base height leaves it.
        terrain_relative: With a Fourier-terrain engine, use the
            terrain-relative base height (p_z − h(x, y)) in the default
            observation and in the healthy-height termination test.
        reward_fn: ``(prev_sim, action, new_sim) -> (B,)``; default is an
            upright-height bonus minus a control cost.
        obs_fn: ``sim -> (obs_dim, B)``; default concatenates
            ``[s, sd, q, v, p_z]``.
    """

    engine: BatchedEngine
    episode_length: int = 1000
    action_scale: float = 1.0
    reset_base_position: tuple = (0.0, 0.0, 0.9)
    reset_noise_std: float = 0.01
    healthy_z_range: tuple = (0.4, 2.0)
    terrain_relative: bool = False
    reward_fn: Callable | None = None
    obs_fn: Callable | None = None

    def __post_init__(self):
        if self.terrain_relative and self.engine.terrain_kind != "fourier":
            raise ValueError("terrain_relative requires a FourierTerrain engine")

    def _height_rel(self, sim: BatchedState) -> torch.Tensor:
        """p_z less the terrain's height under the base (the engine's own
        arrays, no per-env offset)."""
        return sim.p[2] - self.engine._fourier_height_grad(self.engine.params(), sim.p[0], sim.p[1])[0]

    @property
    def action_size(self) -> int:
        return self.engine.n_joints

    def _obs(self, sim: BatchedState) -> torch.Tensor:
        if self.obs_fn is not None:
            return self.obs_fn(sim)
        z = self._height_rel(sim)[None] if self.terrain_relative else sim.p[2:3]
        return torch.cat([sim.s, sim.sd, sim.q, sim.v, z], dim=0)

    def _reward(self, prev: BatchedState, action, new: BatchedState):
        if self.reward_fn is not None:
            return self.reward_fn(prev, action, new)
        # Height clamped so a diverging env cannot bank an arbitrarily large
        # reward on its final pre-reset transition (as the fused kernel).
        return new.p[2].clamp(max=2.0) - 0.001 * (action * action).sum(0)

    def _fresh_sim(self, B: int, generator: torch.Generator) -> BatchedState:
        st = self.engine.init_state(B, base_position=self.reset_base_position)
        noise = torch.randn((3, B), generator=generator, dtype=st.p.dtype, device=st.p.device)
        return dataclasses.replace(st, p=st.p + self.reset_noise_std * noise)

    def reset(self, generator: torch.Generator, batch_size: int) -> tuple[EnvState, torch.Tensor]:
        """Start ``batch_size`` episodes; returns ``(state, obs)``."""
        sim = self._fresh_sim(batch_size, generator)
        steps = torch.zeros(batch_size, dtype=torch.int32, device=sim.p.device)
        return EnvState(sim=sim, steps=steps, generator=generator), self._obs(sim)

    def step(self, state: EnvState, action: torch.Tensor):
        """Advance one control step; envs that end restart in place.

        Returns ``(state, obs, reward, done)`` with ``done`` flagging the
        transition that ENDED the old episode (termination or truncation);
        ``obs`` is the post-auto-reset observation, as in brax/gymnax.
        """
        B = state.steps.shape[0]
        if tuple(action.shape) != (self.engine.n_joints, B):
            raise ValueError(
                f"action must have shape ({self.engine.n_joints}, {B})"
                f" (n_joints, batch); got {tuple(action.shape)}"
            )
        tau = (self.action_scale * action).contiguous()
        new_sim = cuda_step.step_tau(self.engine, state.sim, tau)
        steps = state.steps + 1

        lo, hi = self.healthy_z_range
        z = self._height_rel(new_sim) if self.terrain_relative else new_sim.p[2]
        done = (z < lo) | (z > hi) | (steps >= self.episode_length)
        reward = self._reward(state.sim, action, new_sim)

        fresh = self._fresh_sim(B, state.generator)
        sim = BatchedState(*(select(done, f, n) for f, n in zip(fresh.fields(), new_sim.fields())))
        steps = torch.where(done, torch.zeros_like(steps), steps)
        state = EnvState(sim=sim, steps=steps, generator=state.generator)
        return state, self._obs(sim), reward, done

    def fused_eval_rollout(
        self,
        generator: torch.Generator,
        batch_size: int,
        n_steps: int,
        policy: Callable | None = None,
        W=None,
        b=None,
        mlp_weights: tuple | None = None,
        domain: dict | None = None,
    ):
        """Policy-evaluation rollout in ONE launch of the env-rollout kernel
        (K5) on a CUDA engine, the plain version on a CPU engine: step,
        termination/truncation and auto-reset to the episode-start state.

        The policy is the PD closure by default; ``W`` (+ optional ``b``) a
        linear policy ``tau = W @ obs + b``; ``mlp_weights=(W1, b1, W2, b2)``
        a tanh MLP. Weights are call-time inputs, with an optional leading
        population axis ``P`` (env ``e`` uses candidate ``e // (B // P)``).
        A ``policy`` closure runs on a CPU engine only (it raises
        ``ValueError`` otherwise).

        ``domain``: optional per-env multipliers, each ``(batch_size,)``:
        ``Kmul``/``Dmul``/``mumul`` (contacts), ``gmul`` (gravity), ``Mmul``
        (link inertias); with a Fourier-terrain engine also ``terrOff``
        ``(2, batch_size)``, each env's terrain translation. The env's
        ``terrain_relative`` carries over.

        Auto-reset respawns at the episode-start state without reset noise.
        Returns ``(final_sim, reward_sum (B,), resets (B,))``.
        """
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if sum(x is not None for x in (policy, W, mlp_weights)) > 1:
            raise ValueError("pass exactly one of policy (closure), W/b (linear), or mlp_weights")
        W1, b1, W2, b2 = mlp_weights if mlp_weights is not None else (None,) * 4
        terr_off = None
        if domain is not None:
            domain = dict(domain)  # its names are checked with the options
            terr_off = domain.pop("terrOff", None)
            for name, t in domain.items():
                if tuple(t.shape) != (batch_size,):
                    raise ValueError(f"domain[{name!r}] must have shape ({batch_size},), got {tuple(t.shape)}")
            if terr_off is not None and tuple(terr_off.shape) != (2, batch_size):
                raise ValueError(f"domain['terrOff'] must have shape (2, {batch_size}), got {tuple(terr_off.shape)}")
            domain = domain or None
        sim = self._fresh_sim(batch_size, generator)
        final, reward_sum, resets, _ = cuda_env_rollout.env_rollout(
            self.engine, sim, n_steps, policy=policy, reward=self.reward_fn,
            W=W, b=b, W1=W1, b1=b1, W2=W2, b2=b2,
            episode_length=self.episode_length, healthy_z_range=self.healthy_z_range,
            domain=domain, terr_off=terr_off, terrain_relative=self.terrain_relative,
        )  # fmt: skip
        return final, reward_sum, resets

    def rollout(self, state: EnvState, policy: Callable, n_steps: int):
        """``n_steps`` of ``action = policy(obs)``; returns the final state
        and stacked ``(obs, reward, done)`` trajectories."""
        obs, rewards, dones = [], [], []
        for _ in range(n_steps):
            state, o, r, d = self.step(state, policy(self._obs(state.sim)))
            obs.append(o)
            rewards.append(r)
            dones.append(d)
        return state, (torch.stack(obs), torch.stack(rewards), torch.stack(dones))
