"""Relaxed-rigid contacts (MJX-style soft-constraint model): the parameters.

Counterpart of ``RelaxedRigidContactsParams`` and ``RelaxedRigidContacts`` in
``jaxsim_tpu/ops/contacts/relaxed_rigid.py``. The contact solve itself, a
matrix-free preconditioned CG on the engine's factorization, is
:meth:`jaxsim_tpu_torch.ops.batched_engine.BatchedEngine.relaxed_rigid_contact_forces`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import common

# Parameters are frozen to float32, as the JAX package's jnp.asarray(..., float).
_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class RelaxedRigidContactsParams(common.ContactsParams):
    """Impedance ξ(pos) sigmoid (d_min, d_max, width, midpoint, power), the
    reference-acceleration time constant and damping coefficient, optional
    direct K and D (used when negative), and the friction coefficient μ."""

    time_constant: np.float32 = _F32(0.02)
    damping_coefficient: np.float32 = _F32(1.0)
    d_min: np.float32 = _F32(0.9)
    d_max: np.float32 = _F32(0.95)
    width: np.float32 = _F32(0.001)
    midpoint: np.float32 = _F32(0.5)
    power: np.float32 = _F32(2.0)
    K: np.float32 = _F32(0.0)
    D: np.float32 = _F32(0.0)
    mu: np.float32 = _F32(0.005)

    @classmethod
    def build(cls, **kwargs) -> "RelaxedRigidContactsParams":
        """The defaults, with the fields named in ``kwargs`` (and not None)
        replaced; other keywords are ignored."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _F32(v) for k, v in kwargs.items() if k in known and v is not None})

    @classmethod
    def build_default_from_jaxsim_model(cls, model, **kwargs) -> "RelaxedRigidContactsParams":
        """The defaults: relaxed-rigid parameters do not depend on the model."""
        return cls.build(**kwargs)

    def valid(self) -> bool:
        return bool(
            self.time_constant >= 0
            and self.damping_coefficient > 0
            and self.d_min >= 0
            and self.d_max <= 1.0
            and self.d_min <= self.d_max
            and self.width >= 0
            and self.midpoint >= 0
            and self.power >= 0
            and self.mu >= 0
        )


@dataclasses.dataclass(frozen=True)
class RelaxedRigidContacts:
    """The relaxed-rigid contact model; ``regularization`` is added to the
    diagonal of the contact system."""

    regularization: float = 1e-6

    @property
    def _parameters_class(self) -> type[RelaxedRigidContactsParams]:
        return RelaxedRigidContactsParams
