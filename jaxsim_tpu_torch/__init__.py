"""jaxsim-tpu-torch: the PyTorch and CUDA port of :mod:`jaxsim_tpu`.

The port mirrors the JAX package's module paths, so the counterpart of
``jaxsim_tpu/ops/batched_engine.py`` is ``jaxsim_tpu_torch/ops/batched_engine.py``.
It imports ``torch`` and NumPy and never ``jax``. This first slice covers the
flagship rollout: URDF → model → :class:`~jaxsim_tpu_torch.ops.batched_engine.BatchedEngine`
(Hunt/Crossley soft contacts, plane terrain, semi-implicit Euler), with the
whole horizon in one hand-written CUDA kernel
(:mod:`jaxsim_tpu_torch.ops.cuda_rollout`).
"""

from __future__ import annotations

from . import api, math, models, ops, parsers
from .api.model import JaxSimModel
from .ops.batched_engine import BatchedEngine, BatchedState

__version__ = "0.1.0"
