"""Carry a model and a state across from the JAX package, as NumPy arrays.

The functions here import neither ``jax`` nor ``jaxsim_tpu``: a caller that
has both packages (the tests) hands over NumPy arrays, e.g. from
:func:`reference_engine_arrays` and :func:`reference_state_arrays`, which read
a JAX engine or state through ``np.asarray`` alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jaxsim_tpu_torch.ops.batched_engine import BatchedEngine, BatchedState

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
)

STATE_FIELDS = ("s", "sd", "p", "q", "v", "m")

# Static fields whose value the port's engine does not implement otherwise.
_REQUIRED = dict(
    terrain_kind="plane", integrator="sie", contact_model="soft", constraint_parents=()
)


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
    """The port's engine from the JAX engine's static fields and ``params()``."""
    for key, want in _REQUIRED.items():
        got = static.get(key, want)
        if (tuple(got) if isinstance(want, tuple) else got) != want:
            raise ValueError(f"the port's engine requires {key}={want!r}, got {got!r}")
    # The JAX engine stores a joint-free model's axis array as (0,).
    params = {**params, "axis": np.reshape(params["axis"], (static["n_joints"], 3))}
    return BatchedEngine(
        **{k: static[k] for k in STATIC_FIELDS},
        **{k: params[k] for k in BatchedEngine.PARAM_NAMES},
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
    with a trailing batch axis."""
    return BatchedState(
        **{
            k: torch.as_tensor(np.asarray(arrays[k]), dtype=dtype, device=device)
            for k in STATE_FIELDS
        }
    )


def state_to_numpy(state: BatchedState) -> dict[str, np.ndarray]:
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE_FIELDS}
