"""Observation, policies, reward and reset selection of the RL evaluation
rollout, in plain PyTorch.

Counterparts of ``jaxsim_tpu/ops/pallas_step.py``'s ``obs_dim``,
``_obs_rows`` (with its terrain-relative height row), ``_linear_policy_tau``, ``_mlp_policy_tau``,
``_default_reward`` and ``_sel``, used by the plain version of the env
rollout (:func:`jaxsim_tpu_torch.ops.cuda_env_rollout.env_rollout_reference`).
Every product is the JAX code's sequence of multiply-adds, bias first and the
rows in order, so the plain version and the CUDA kernel compute the same
float32 sums.

Weights have the JAX shapes: ``W (n, d)``, ``b (n, 1)``; ``W1 (H, d)``,
``b1 (H, 1)``, ``W2 (n, H)``, ``b2 (n, 1)``. With a leading population axis
``P`` (per-candidate weights) env ``e`` of ``B`` uses candidate
``e // (B // P)``: :func:`per_env` expands such weights to a trailing batch
axis.
"""

from __future__ import annotations

import torch

from .batched_engine import BatchedState


def obs_dim(n_joints: int) -> int:
    """Size of the default observation ``[s, sd, q, v, p_z]``."""
    return 2 * n_joints + 11


def obs_rows(st: BatchedState, hrel: torch.Tensor | None = None) -> list[torch.Tensor]:
    """The observation ``[s, sd, q, v, p_z]`` as a list of ``(B,)`` rows;
    with ``hrel`` its last row is that terrain-relative height in place of
    ``p_z`` (the JAX kernel's ``_obs_rows(st, hrel)``)."""
    return [*st.s, *st.sd, *st.q, *st.v, st.p[2] if hrel is None else hrel]


def per_env(w: torch.Tensor, batch: int, n_lead: int) -> torch.Tensor:
    """Weights ``w`` of ``n_lead`` dims, or ``(P, ...)`` with a population
    axis, as ``(..., 1)`` or ``(..., B)``: broadcastable over a trailing batch."""
    if w.ndim == n_lead:
        return w.unsqueeze(-1)
    P = w.shape[0]
    if w.ndim != n_lead + 1 or batch % P:
        raise ValueError(f"weights of shape {tuple(w.shape)} do not fit a batch of {batch}")
    candidate = torch.arange(batch, device=w.device) // (batch // P)
    return w[candidate].movedim(0, -1)


def _clip(x, limit):
    return x if limit is None else torch.clamp(x, -limit, limit)


def _affine(W, b, rows, limit=None):
    """``b + W @ rows`` as sequential multiply-adds over the rows; ``W`` is
    ``(m, k, 1|B)``, ``b`` ``(m, 1, 1|B)``."""
    acc = b[:, 0] + W[:, 0] * rows[0]
    for k in range(1, len(rows)):
        acc = acc + W[:, k] * rows[k]
    return _clip(acc, limit)


def linear_policy_tau(st: BatchedState, W, b, tau_limit=None, hrel=None) -> torch.Tensor:
    """``tau = W @ obs + b``, clipped to ``±tau_limit`` when given; ``hrel``
    as in :func:`obs_rows`."""
    B = st.p.shape[-1]
    return _affine(per_env(W, B, 2), per_env(b, B, 2), obs_rows(st, hrel), tau_limit)


def mlp_policy_tau(st: BatchedState, W1, b1, W2, b2, tau_limit=None, hrel=None) -> torch.Tensor:
    """``tau = W2 @ tanh(W1 @ obs + b1) + b2``, clipped to ``±tau_limit``;
    ``hrel`` as in :func:`obs_rows`."""
    B = st.p.shape[-1]
    hidden = torch.tanh(_affine(per_env(W1, B, 2), per_env(b1, B, 2), obs_rows(st, hrel)))
    return _affine(per_env(W2, B, 2), per_env(b2, B, 2), list(hidden), tau_limit)


def default_reward(st: BatchedState, tau: torch.Tensor, new: BatchedState) -> torch.Tensor:
    """Upright height, clamped at 2 m, minus ``0.001 · Σ tau²`` (summed over
    the joints in order)."""
    ctrl = tau[0] * tau[0]
    for i in range(1, tau.shape[0]):
        ctrl = ctrl + tau[i] * tau[i]
    return new.p[2].clamp(max=2.0) - 0.001 * ctrl


def select(done: torch.Tensor, fresh: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Per env (trailing axis): ``fresh`` where ``done``, else ``new``."""
    return torch.where(done, fresh, new)
