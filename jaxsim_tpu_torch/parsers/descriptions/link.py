"""Link description (offline, NumPy).

Counterpart of ``jaxsim_tpu/parsers/descriptions/link.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import numpy.typing as npt


@dataclasses.dataclass(eq=False)
class LinkDescription:
    """In-memory description of a robot link.

    Attributes:
        name: Link name.
        mass: Link mass.
        inertia: 6×6 spatial inertia expressed in the link frame.
        index: BFS index assigned by the kinematic graph (root = 0).
        parent_name: Name of the parent link (None for the root).
        pose: 4×4 pose of the link w.r.t. its parent joint's successor frame.
    """

    name: str
    mass: float = 0.0
    inertia: npt.NDArray = dataclasses.field(default_factory=lambda: np.zeros((6, 6)))
    index: int | None = None
    parent_name: str | None = None
    pose: npt.NDArray = dataclasses.field(default_factory=lambda: np.eye(4))
    children: tuple[str, ...] = dataclasses.field(default_factory=tuple)

    def __hash__(self) -> int:
        return hash(self.name)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, LinkDescription) and self.name == other.name

    def lump_with(
        self, link: "LinkDescription", lumped_H_removed: npt.NDArray
    ) -> "LinkDescription":
        """Merge ``link`` (pose ``lumped_H_removed`` w.r.t. self) into this link.

        The removed link's spatial inertia is transported with the force-adjoint
        congruence  M' = Xᶠ M Xᶠᵀ ... equivalently  M' = X⁻ᵀ... we use the
        standard  M_lumped = M_self + X*ᵀ M_removed X*  with X* the motion
        adjoint of removed_H_lumped (reference ``descriptions/link.py:86-115``).
        """
        H = np.asarray(lumped_H_removed)
        R, p = H[:3, :3], H[:3, 3]

        def skew(v):
            return np.array(
                [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=float
            )

        # Motion adjoint of removed_H_lumped = H⁻¹ (linear-first convention).
        Rt = R.T
        Xi = np.block([[Rt, -Rt @ skew(p)], [np.zeros((3, 3)), Rt]])
        M_removed_in_lumped = Xi.T @ np.asarray(link.inertia) @ Xi

        return dataclasses.replace(
            self,
            mass=self.mass + link.mass,
            inertia=np.asarray(self.inertia) + M_removed_in_lumped,
        )
