"""Differentiable engine steps and rollouts: gradients through the physics.

Counterparts of ``jaxsim_tpu/ops/pallas_step.py``'s fused differentiable
tier (``build_fused_diff_pallas_step`` / ``_rollout``), as a
``torch.autograd.Function`` over flat tensors (the six state leaves, the
torques ``tau`` and the model arrays in the engine's ``PARAM_NAMES`` order):
forward K3 (:func:`cuda_step.step_tau`), backward K4
(:func:`cuda_step_vjp.step_vjp`); for a relaxed-rigid engine K3-rr and K4-rr,
whose backward differentiates the contact solve implicitly, as the JAX
engine's ``pcg_implicit``. Flat ground only, without per-env options: an
engine on an inclined plane or Fourier terrain raises when the step or
rollout is made (K4 has no terrain build yet, ROADMAP Queue 2 item 6). Without ``params_grad`` the model arrays
are the engine's and constant; with it, gradients also flow to ``pr``, the
model arrays by name (the engine's own ``PARAM_NAMES``: a relaxed-rigid
engine's add ``rrMinv``), merged over the engine's own.

A rollout calls ``policy_fn(state, *policy_args) -> tau`` between steps, in
torch ops, so gradients reach the policy's tensors. For a CPU state every
forward and backward is the plain version; for a CUDA state K3 and K4 run and
nothing else, and a failed build or launch raises.

Autograd saves each step's inputs: the humanoid at 8192 envs keeps about
7.4 MB of state and torques a step. With ``checkpoint_chunk`` it keeps only
each chunk's start state, and the backward runs the chunk's K3 steps again
before their K4 steps.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import cuda_build, cuda_step, cuda_step_vjp
from .batched_engine import BatchedEngine, BatchedState


def _model_arrays(engine: BatchedEngine, pr) -> tuple[torch.Tensor, ...]:
    """``pr`` merged over the engine's own arrays, in the engine's
    ``PARAM_NAMES`` order; per-env options (domain multipliers, ``terrOff``)
    raise, since K3 and K4 take none."""
    per_env = sorted(set(pr or {}) - set(engine.PARAM_NAMES))
    if per_env:
        raise ValueError(f"the differentiable step takes no per-env options {per_env} ({cuda_build.ITEM_VARIANTS})")
    arrays = engine.params(pr)
    return tuple(arrays[k].contiguous() for k in engine.PARAM_NAMES)


def _as_pr(engine: BatchedEngine, params) -> dict[str, torch.Tensor] | None:
    return dict(zip(engine.PARAM_NAMES, params)) if params else None


class _Step(torch.autograd.Function):
    """One K3 step as an autograd node whose backward is K4, with the model
    arrays' cotangents when the node takes them as inputs."""

    @staticmethod
    def forward(ctx, engine, *flat):
        ctx.engine = engine
        ctx.save_for_backward(*flat)
        state, tau, params = BatchedState(*flat[:6]), flat[6], flat[7:]
        return cuda_step.step_tau(engine, state, tau, _as_pr(engine, params)).fields()

    @staticmethod
    def backward(ctx, *ct):
        flat = ctx.saved_tensors
        state, tau, params = BatchedState(*flat[:6]), flat[6], flat[7:]
        ct = BatchedState(*(torch.zeros_like(x) if c is None else c.contiguous() for c, x in zip(ct, flat)))
        res = cuda_step_vjp.step_vjp(ctx.engine, state, tau, ct, _as_pr(ctx.engine, params), bool(params))
        grads = (*res[0].fields(), res[1])
        if params:
            grads += tuple(res[2][k] for k in ctx.engine.PARAM_NAMES)
        return (None, *grads)


def _step(engine, state: BatchedState, tau, params=()) -> BatchedState:
    return BatchedState(*_Step.apply(engine, *state.fields(), tau.contiguous(), *params))


def fused_diff_step(engine: BatchedEngine, params_grad: bool = False):
    """``(state, tau) -> state`` (with ``params_grad``: ``(state, tau,
    pr=None) -> state``), forward K3 and backward K4."""
    cuda_step_vjp.check_scope(engine)
    if not params_grad:
        return lambda state, tau: _step(engine, state, tau)
    return lambda state, tau, pr=None: _step(engine, state, tau, _model_arrays(engine, pr))


def fused_diff_rollout(
    engine: BatchedEngine, n_steps: int, params_grad: bool = False, checkpoint_chunk: int | None = None
):
    """``(state, policy_fn, *policy_args, pr=None) -> state``: ``n_steps``
    fused differentiable steps with ``tau = policy_fn(state, *policy_args)``
    between them; ``pr`` (with ``params_grad`` only) is differentiable. With
    ``checkpoint_chunk``, chunks of that many steps (and one of the
    remainder) each keep only their start state for the backward."""
    cuda_step_vjp.check_scope(engine)
    if checkpoint_chunk is not None and checkpoint_chunk < 1:
        raise ValueError(f"checkpoint_chunk must be a positive step count, not {checkpoint_chunk}")

    def steps(state, n, policy_fn, policy_args, params):
        for _ in range(n):
            state = _step(engine, state, policy_fn(state, *policy_args), params)
        return state

    def rollout(state: BatchedState, policy_fn, *policy_args, pr=None) -> BatchedState:
        if pr is not None and not params_grad:
            raise ValueError("pr is differentiated only by a rollout built with params_grad=True")
        params = _model_arrays(engine, pr) if params_grad else ()
        if checkpoint_chunk is None:
            return steps(state, n_steps, policy_fn, policy_args, params)
        n_chunks, rem = divmod(n_steps, checkpoint_chunk)
        for length in [checkpoint_chunk] * n_chunks + ([rem] if rem else []):
            state = checkpoint(steps, state, length, policy_fn, policy_args, params, use_reentrant=False)
        return state

    return rollout
