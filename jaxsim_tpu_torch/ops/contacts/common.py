"""Contact-parameter estimation shared by the contact models.

Counterpart of ``ContactsParams.build_default_from_jaxsim_model`` in
``jaxsim_tpu/ops/contacts/common.py``, eager NumPy only (the JAX package's
model-build path). The arithmetic keeps the JAX package's dtypes step by step
(a float32 mass sum, then float64), so both packages estimate the same K and D.
"""

from __future__ import annotations

import dataclasses

import numpy as np

STANDARD_GRAVITY = 9.81
MAX_STIFFNESS = 1e6
MAX_DAMPING = 1e4


@dataclasses.dataclass(frozen=True)
class ContactsParams:
    """Base class of contact-model parameters."""

    @classmethod
    def build(cls, **kwargs) -> "ContactsParams":
        raise NotImplementedError

    @classmethod
    def build_default_from_jaxsim_model(
        cls,
        model,
        *,
        stiffness: float | None = None,
        damping: float | None = None,
        standard_gravity: float = STANDARD_GRAVITY,
        static_friction_coefficient: float = 0.5,
        max_penetration: float = 0.001,
        number_of_active_collidable_points_steady_state: int = 1,
        damping_ratio: float = 1.0,
        p: float = 0.5,
        q: float = 0.5,
        **kwargs,
    ) -> "ContactsParams":
        """Estimate K, D from the model mass and the desired steady-state
        penetration δ_max."""
        mass = np.asarray(model.kin_dyn_parameters.link_parameters.mass)
        f32 = mass.dtype.type
        m = np.sum(mass)

        if stiffness is None:
            f_average = (
                m
                * f32(standard_gravity)
                / f32(number_of_active_collidable_points_steady_state)
            )
            stiffness = np.float64(f_average) / np.power(
                np.float64(max_penetration), 1.0 + p
            )
            stiffness = np.clip(stiffness, 0, MAX_STIFFNESS)

        if damping is None:
            critical_damping = 2 * np.sqrt(stiffness * np.float64(m))
            damping = np.clip(damping_ratio * critical_damping, 0, MAX_DAMPING)

        return cls.build(
            K=stiffness,
            D=damping,
            mu=static_friction_coefficient,
            p=p,
            q=q,
            **kwargs,
        )
