"""jaxsim-tpu-torch: the PyTorch and CUDA port of :mod:`jaxsim_tpu`.

The port mirrors the JAX package's module paths, so the counterpart of
``jaxsim_tpu/ops/batched_engine.py`` is ``jaxsim_tpu_torch/ops/batched_engine.py``.
It imports ``torch`` and NumPy and never ``jax``. It covers the flagship
rollout: URDF → model → :class:`~jaxsim_tpu_torch.ops.batched_engine.BatchedEngine`
(Hunt/Crossley soft or relaxed-rigid contacts, plane terrain and, for soft
contacts, Fourier rough terrain (:mod:`jaxsim_tpu_torch.terrain`) with per-env
domain multipliers; semi-implicit Euler, RK4 or RK4-fast), with the whole
horizon in one hand-written CUDA kernel
(:mod:`jaxsim_tpu_torch.ops.cuda_rollout`, soft and relaxed-rigid bodies);
one step per launch
(:mod:`jaxsim_tpu_torch.ops.cuda_step`); and RL policy evaluation,
:class:`~jaxsim_tpu_torch.envs.BatchedEnv` over the auto-resetting env
rollout kernel (:mod:`jaxsim_tpu_torch.ops.cuda_env_rollout`); and gradients
through the physics (:mod:`jaxsim_tpu_torch.ops.diff_step`), whose backward
is the fused step VJP kernel (:mod:`jaxsim_tpu_torch.ops.cuda_step_vjp`);
and the card's measured FMA rates (:mod:`jaxsim_tpu_torch.ops.fma_probe`).
Entry points run on the CUDA card unless the caller names another device.
"""

from __future__ import annotations

from . import api, envs, math, models, ops, parsers, terrain
from .api.model import JaxSimModel
from .ops.batched_engine import BatchedEngine, BatchedState

__version__ = "0.1.0"
