"""Hunt/Crossley soft contacts: the parameters.

Counterpart of ``SoftContactsParams`` and ``_stability_clamped_defaults`` in
``jaxsim_tpu/ops/contacts/soft.py``. The
contact forces themselves are computed by
:meth:`jaxsim_tpu_torch.ops.batched_engine.BatchedEngine.soft_contact_forces`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import common

# Parameters are frozen to float32, as the JAX package's jnp.asarray(..., float).
_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class SoftContactsParams(common.ContactsParams):
    """Hunt/Crossley parameters (K, D, μ and nonlinearity exponents p, q)."""

    K: np.float32 = _F32(1e6)
    D: np.float32 = _F32(2000.0)
    mu: np.float32 = _F32(0.5)
    p: np.float32 = _F32(0.5)
    q: np.float32 = _F32(0.5)

    @classmethod
    def build_default_from_jaxsim_model(cls, model, **kwargs):
        """The shared estimation plus a stability clamp for the model's time
        step (see :func:`_stability_clamped_defaults`)."""
        params = super().build_default_from_jaxsim_model(model, **kwargs)
        K, D = _stability_clamped_defaults(
            model, params.K, params.D, kwargs.get("max_penetration", 0.001)
        )
        return dataclasses.replace(params, K=K, D=D)

    @classmethod
    def build(cls, *, K=1e6, D=2000.0, mu=0.5, p=0.5, q=0.5, **kwargs):
        return cls(K=_F32(K), D=_F32(D), mu=_F32(mu), p=_F32(p), q=_F32(q))


@dataclasses.dataclass(frozen=True)
class SoftContacts:
    """The Hunt/Crossley soft contact model (a model's default)."""

    @property
    def _parameters_class(self) -> type[SoftContactsParams]:
        return SoftContactsParams


def _stability_clamped_defaults(model, K, D, max_penetration):
    """Clamp K, D so the semi-implicit Euler integration of the contact
    dynamics is stable at the model's time step. For every link owning
    enabled collidable points:

        damping:   dt · (D √δ · n_pts) / m  ≤ 0.5
        stiffness: dt · √(1.5 K √δ · n_pts / m) ≤ 0.33
    """
    kdp = model.kin_dyn_parameters
    cp = kdp.contact_parameters
    idx = cp.indices_of_enabled_collidable_points
    if len(idx) == 0:
        return K, D

    dt = float(model.time_step)
    masses = np.asarray(kdp.link_parameters.mass)
    parents = np.asarray(cp.body)[idx]
    sqrt_d = float(np.sqrt(max_penetration))

    K_cap, D_cap = np.inf, np.inf
    for link in np.unique(parents):
        n_pts = int(np.sum(parents == link))
        m = float(masses[link])
        if m <= 0:
            continue
        D_cap = min(D_cap, 0.5 * m / (dt * sqrt_d * n_pts))
        K_cap = min(K_cap, (0.33 / dt) ** 2 * m / (1.5 * sqrt_d * n_pts))

    return _F32(np.minimum(K, K_cap)), _F32(np.minimum(D, D_cap))
