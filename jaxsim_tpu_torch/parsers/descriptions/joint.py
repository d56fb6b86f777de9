"""Joint description (offline, NumPy).

Counterpart of ``jaxsim_tpu/parsers/descriptions/joint.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import numpy.typing as npt

from jaxsim_tpu_torch.math.joint_model import JointType  # re-export int enum

from .link import LinkDescription

__all__ = ["JointType", "JointDescription", "JointGenericAxis"]


@dataclasses.dataclass(frozen=True)
class JointGenericAxis:
    """Hashable wrapper of a joint axis."""

    axis: tuple[float, float, float]

    def __hash__(self) -> int:
        return hash(self.axis)


@dataclasses.dataclass(eq=False)
class JointDescription:
    """In-memory description of a robot joint.

    Attributes:
        name: Joint name.
        axis: Motion axis (normalized on construction).
        pose: 4×4 pose of the joint frame w.r.t. the parent link frame.
        jtype: Integer joint type.
        parent/child: Connected link descriptions.
        index: Index assigned by the graph (= child link index, 1-based).
    """

    name: str
    axis: npt.NDArray
    pose: npt.NDArray
    jtype: int
    parent: LinkDescription
    child: LinkDescription
    index: int | None = None

    friction_static: float = 0.0
    friction_viscous: float = 0.0

    position_limit_damper: float = 0.0
    position_limit_spring: float = 0.0

    position_limit: tuple[float, float] = (-np.inf, np.inf)
    initial_position: float = 0.0

    motor_inertia: float = 0.0
    motor_viscous_friction: float = 0.0
    motor_gear_ratio: float = 1.0

    def __post_init__(self):
        if self.axis is not None:
            axis = np.asarray(self.axis, dtype=float).squeeze()
            norm = np.linalg.norm(axis)
            if norm > 0:
                axis = axis / norm
            self.axis = axis

    def __hash__(self) -> int:
        return hash(self.name)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, JointDescription) and self.name == other.name
