"""Carry a model, a state, an env and policy weights across from the JAX
package, as NumPy arrays and Python values.

The functions here import neither ``jax`` nor ``jaxsim_tpu``: a caller that
has both packages (the tests) hands over NumPy arrays, e.g. from
:func:`reference_engine_arrays` and :func:`reference_state_arrays`, which read
a JAX engine or state through ``np.asarray`` alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jaxsim_tpu_torch.ops.batched_engine import (
    DOMAIN_NAMES, ITEM_HEIGHTMAP, ITEM_RIGID, BatchedEngine, BatchedState, resolve_device,
)  # fmt: skip

# Static fields of the JAX BatchedEngine that the port's engine takes.
STATIC_FIELDS = (
    "n_links",
    "n_joints",
    "n_points",
    "lam",
    "joint_types",
    "contact_parent",
    "K",
    "D",
    "mu",
    "hc_p",
    "hc_q",
    "gravity_z",
    "dt",
    "floating_base",
    "terrain_normal",
    "terrain_offset",
    "terrain_kind",
    "contact_model",
    "integrator",
)
# A relaxed-rigid engine's static fields besides those.
RR_FIELDS = (
    "rr_d_min",
    "rr_d_max",
    "rr_width",
    "rr_midpoint",
    "rr_power",
    "rr_stiff",
    "rr_damp",
    "rr_reg",
    "rr_iterations",
)

STATE_FIELDS = ("s", "sd", "p", "q", "v", "m")

# Fields of the JAX BatchedEnv that the port's env takes as they are.
ENV_FIELDS = (
    "episode_length",
    "action_scale",
    "reset_base_position",
    "reset_noise_std",
    "healthy_z_range",
    "terrain_relative",
)
POLICY_WEIGHTS = ("W", "b", "W1", "b1", "W2", "b2")
# Per-env rows of a rollout's ``domain``: the multipliers, each (B,), and
# on Fourier terrain the terrain offset, (2, B).
DOMAIN_ROWS = (*DOMAIN_NAMES, "terrOff")

# Static fields whose value the port's engine does not implement otherwise:
# each must be one of its tuple's values.
_REQUIRED = dict(terrain_kind=BatchedEngine.TERRAIN_KINDS, integrator=BatchedEngine.INTEGRATORS, constraint_parents=((),))
# Every model array a port engine may take, in the order of the kernels' packing.
PARAM_NAMES = BatchedEngine.RR_PARAM_NAMES + (BatchedEngine.RR_KC_PARAM, BatchedEngine.TERRAIN_PARAM)


def reference_engine_arrays(engine) -> tuple[dict, dict[str, np.ndarray]]:
    """``(static, params)`` of a ``jaxsim_tpu`` BatchedEngine: its public
    dataclass fields and its ``params()`` as NumPy arrays."""
    static = {
        f.name: getattr(engine, f.name)
        for f in dataclasses.fields(engine)
        if not f.name.startswith("_")
    }
    return static, {k: np.asarray(v) for k, v in engine.params().items()}


def reference_state_arrays(state) -> dict[str, np.ndarray]:
    """The leaves of a ``jaxsim_tpu`` BatchedState as NumPy arrays."""
    return {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}


def engine_from_numpy(
    static: dict,
    params: dict[str, np.ndarray],
    *,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> BatchedEngine:
    """The port's engine from the JAX engine's static fields and ``params()``,
    on ``device`` (by default the CUDA card): soft or relaxed-rigid contacts,
    plane terrain or Fourier terrain (whose spectrum is ``params["terr"]``;
    a relaxed-rigid engine there also takes the JAX engine's block-Jacobi
    blocks ``params["rrKc"]``, or without them computes its own),
    semi-implicit Euler, RK4 or RK4-fast."""
    for key, allowed in _REQUIRED.items():
        got = static.get(key, allowed[0])
        if (tuple(got) if isinstance(got, (list, tuple)) else got) not in allowed:
            item = f" ({ITEM_HEIGHTMAP})" if key == "terrain_kind" else ""
            raise ValueError(f"the port's engine requires {key} in {allowed!r}, got {got!r}{item}")
    if static["contact_model"] not in BatchedEngine.CONTACT_MODELS:
        raise ValueError(
            f"the port's engine requires contact_model in {BatchedEngine.CONTACT_MODELS}, got"
            f" {static['contact_model']!r} ({ITEM_RIGID})"
        )
    relaxed = static["contact_model"] == "relaxed_rigid"
    # The JAX engine stores a joint-free model's axis array as (0,), and a
    # point-free relaxed-rigid model's rrMinv as (0, 3, 3).
    params = {**params, "axis": np.reshape(params["axis"], (static["n_joints"], 3))}
    if relaxed and not static["n_points"]:
        params["rrMinv"] = np.zeros((1, 3, 3))
    names = BatchedEngine.RR_PARAM_NAMES if relaxed else BatchedEngine.PARAM_NAMES
    if static.get("terrain_kind", "plane") == "fourier":
        if relaxed and static["n_points"]:
            names = names + (BatchedEngine.RR_KC_PARAM,)
        names = names + (BatchedEngine.TERRAIN_PARAM,)
    return BatchedEngine(
        **{k: static.get(k, "plane") if k == "terrain_kind" else static[k] for k in STATIC_FIELDS},
        **({k: static[k] for k in RR_FIELDS} if relaxed else {}),
        **{k: params[k] for k in names if k != BatchedEngine.RR_KC_PARAM or k in params},
        device=device,
        dtype=dtype,
    )


def state_from_numpy(
    arrays: dict[str, np.ndarray],
    *,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> BatchedState:
    """A :class:`BatchedState` from ``{"s", "sd", "p", "q", "v", "m"}`` arrays
    with a trailing batch axis, on ``device`` (by default the CUDA card)."""
    device = resolve_device(device)
    return BatchedState(
        **{
            k: torch.as_tensor(np.asarray(arrays[k]), dtype=dtype, device=device)
            for k in STATE_FIELDS
        }
    )


def state_to_numpy(state: BatchedState) -> dict[str, np.ndarray]:
    """The leaves of a state, or of a cotangent of one (a state-shaped
    :class:`BatchedState`, which :func:`state_from_numpy` also builds)."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE_FIELDS}


def reference_params_arrays(pr) -> dict[str, np.ndarray]:
    """The :data:`PARAM_NAMES` entries of a ``jaxsim_tpu`` model-array dict
    (``params()``, an override ``pr``, or the cotangent of one from
    ``jax.vjp``/``jax.grad``) as NumPy arrays; a joint-free model's ``(0,)``
    axis array comes back as ``(0, 3)``."""
    out = {k: np.asarray(pr[k]) for k in PARAM_NAMES if k in pr}
    if "axis" in out:
        out["axis"] = out["axis"].reshape(-1, 3)
    return out


def params_from_numpy(
    arrays: dict[str, np.ndarray],
    *,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """A ``pr`` dict of model arrays by name (see
    :meth:`BatchedEngine.params`) from NumPy arrays, on ``device`` (by
    default the CUDA card)."""
    unknown = set(arrays) - set(PARAM_NAMES)
    if unknown:
        raise ValueError(f"unknown model arrays: {sorted(unknown)}")
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(a), dtype=dtype, device=device) for k, a in arrays.items()}


def params_to_numpy(pr: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Model arrays (or their cotangents) by name as NumPy arrays."""
    return {k: t.detach().cpu().numpy() for k, t in pr.items()}


def domain_from_numpy(
    arrays: dict[str, np.ndarray],
    *,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """A rollout's ``domain`` (:data:`DOMAIN_ROWS`: multiplier rows ``(B,)``,
    ``terrOff`` ``(2, B)``) from NumPy arrays, contiguous, on ``device`` (by
    default the CUDA card)."""
    unknown = set(arrays) - set(DOMAIN_ROWS)
    if unknown:
        raise ValueError(f"unknown domain rows: {sorted(unknown)}")
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(a), dtype=dtype, device=device).contiguous() for k, a in arrays.items()}


def domain_to_numpy(domain: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A ``domain``'s rows as NumPy arrays."""
    return {k: t.detach().cpu().numpy() for k, t in domain.items()}


def reference_env_fields(env) -> dict:
    """The :data:`ENV_FIELDS` of a ``jaxsim_tpu`` BatchedEnv, as Python values."""
    for name in ("reward_fn", "obs_fn"):
        if getattr(env, name) is not None:
            raise ValueError(f"a JAX {name} closure cannot be carried across")
    return {name: getattr(env, name) for name in ENV_FIELDS}


def env_from_numpy(static_env_fields: dict, engine: BatchedEngine):
    """The port's :class:`~jaxsim_tpu_torch.envs.BatchedEnv` over ``engine``
    from a JAX BatchedEnv's :data:`ENV_FIELDS` (see :func:`reference_env_fields`)."""
    from jaxsim_tpu_torch.envs import BatchedEnv

    f = static_env_fields
    return BatchedEnv(
        engine=engine,
        episode_length=int(f["episode_length"]),
        action_scale=float(f["action_scale"]),
        reset_base_position=tuple(float(x) for x in f["reset_base_position"]),
        reset_noise_std=float(f["reset_noise_std"]),
        healthy_z_range=tuple(float(x) for x in f["healthy_z_range"]),
        terrain_relative=bool(f.get("terrain_relative", False)),
    )


def policy_weights_from_numpy(
    *,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
    **weights: np.ndarray | None,
) -> dict[str, torch.Tensor]:
    """The JAX env rollout's policy weights (``W``, ``b`` or ``W1``, ``b1``,
    ``W2``, ``b2``, with or without the population axis) as the port's
    tensors, on ``device`` (by default the CUDA card); ``None`` entries are
    dropped."""
    unknown = set(weights) - set(POLICY_WEIGHTS)
    if unknown:
        raise ValueError(f"unknown policy weights: {sorted(unknown)}")
    device = resolve_device(device)
    return {
        k: torch.as_tensor(np.asarray(w), dtype=dtype, device=device).contiguous()
        for k, w in weights.items()
        if w is not None
    }
