"""The time-invariant model: parameters + simulation configuration.

Counterpart of ``JaxSimModel.build_from_model_description`` and
``JaxSimModel.build`` in ``jaxsim_tpu/api/model.py``, reduced to what
:meth:`~jaxsim_tpu_torch.ops.batched_engine.BatchedEngine.build` reads: the
kin-dyn parameters, the contact model (soft or relaxed-rigid) and its
parameters, the fixed-step integrator (semi-implicit Euler, RK4 or
RK4-fast), the time step and gravity, and the terrain (flat, an inclined
plane or Fourier rough terrain). The functional API (``js.model.step`` and
the rest) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import enum
import pathlib

import numpy as np

from jaxsim_tpu_torch.api.kin_dyn_parameters import FROZEN_DTYPE, KinDynParameters
from jaxsim_tpu_torch.ops.contacts.common import STANDARD_GRAVITY
from jaxsim_tpu_torch.ops.contacts.relaxed_rigid import RelaxedRigidContacts, RelaxedRigidContactsParams
from jaxsim_tpu_torch.ops.contacts.soft import SoftContacts, SoftContactsParams
from jaxsim_tpu_torch.parsers import build_model_description
from jaxsim_tpu_torch.terrain import FlatTerrain, Terrain


class IntegratorType(enum.IntEnum):
    """Fixed-step integrators, as ``jaxsim_tpu.api.model.IntegratorType``
    names them: RK4-fast is RK4 with the contact forces frozen at the step's
    start."""

    SemiImplicitEuler = enum.auto()
    RungeKutta4 = enum.auto()
    RungeKutta4Fast = enum.auto()


@dataclasses.dataclass(frozen=True)
class JaxSimModel:
    """Model parameters on a terrain, with a fixed-step integrator."""

    model_name: str
    kin_dyn_parameters: KinDynParameters
    contact_params: SoftContactsParams | RelaxedRigidContactsParams | None = None
    contact_model: SoftContacts | RelaxedRigidContacts = SoftContacts()
    integrator: IntegratorType = IntegratorType.SemiImplicitEuler
    terrain: Terrain = dataclasses.field(default_factory=FlatTerrain.build)
    # Negative: the z component of the gravity acceleration.
    gravity: float = -STANDARD_GRAVITY
    time_step: np.float32 = FROZEN_DTYPE(1e-3)
    _fixed_base: bool = False

    @staticmethod
    def build_from_model_description(
        model_description: str | pathlib.Path,
        *,
        model_name: str | None = None,
        time_step: float | None = None,
        contact_model: SoftContacts | RelaxedRigidContacts | None = None,
        contact_params: SoftContactsParams | RelaxedRigidContactsParams | None = None,
        integrator: IntegratorType | None = None,
        gravity: float = STANDARD_GRAVITY,
        terrain: Terrain | None = None,
    ) -> "JaxSimModel":
        """Parse a URDF (path or string) and build a model. Without
        ``contact_params`` the contact model's defaults are taken: the soft
        model's are estimated from the model, the relaxed-rigid model's are
        its parameters' own (μ = 0.005). The integrator defaults to
        semi-implicit Euler, the terrain to flat ground at z = 0."""
        description = build_model_description(model_description)
        model = JaxSimModel(
            model_name=model_name if model_name is not None else description.name,
            kin_dyn_parameters=KinDynParameters.build(description),
            gravity=-float(gravity),
            time_step=FROZEN_DTYPE(time_step if time_step is not None else 1e-3),
            contact_model=contact_model if contact_model is not None else SoftContacts(),
            integrator=IntegratorType(integrator) if integrator is not None else IntegratorType.SemiImplicitEuler,
            terrain=terrain if terrain is not None else FlatTerrain.build(),
            _fixed_base=bool(description.fixed_base),
        )
        if contact_params is None:
            contact_params = model.contact_model._parameters_class.build_default_from_jaxsim_model(model)
        return model.replace(contact_params=contact_params)

    def replace(self, **kwargs) -> "JaxSimModel":
        return dataclasses.replace(self, **kwargs)

    def floating_base(self) -> bool:
        return not self._fixed_base
