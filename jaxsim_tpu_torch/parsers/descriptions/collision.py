"""Collision shape descriptions (offline, NumPy).

Counterpart of ``jaxsim_tpu/parsers/descriptions/collision.py``.
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np
import numpy.typing as npt

from .link import LinkDescription


@dataclasses.dataclass
class CollidablePoint:
    """A point rigidly attached to a link, participating in contacts."""

    parent_link: LinkDescription
    position: npt.NDArray = dataclasses.field(default_factory=lambda: np.zeros(3))
    enabled: bool = True

    def change_link(
        self, new_link: LinkDescription, new_H_old: npt.NDArray
    ) -> "CollidablePoint":
        """Re-express this point in another link frame (used when lumping)."""
        pos_h = np.hstack([np.asarray(self.position, dtype=float), 1.0])
        return CollidablePoint(
            parent_link=new_link,
            position=(np.asarray(new_H_old) @ pos_h)[0:3],
            enabled=self.enabled,
        )

    def __hash__(self) -> int:
        return hash(
            (
                self.parent_link.name,
                tuple(np.asarray(self.position).tolist()),
                self.enabled,
            )
        )

    def __eq__(self, other: object) -> bool:
        return isinstance(other, CollidablePoint) and hash(self) == hash(other)


@dataclasses.dataclass
class CollisionShape(abc.ABC):
    """A collision shape, represented by its collidable points."""

    collidable_points: tuple[CollidablePoint, ...]


@dataclasses.dataclass
class BoxCollision(CollisionShape):
    center: npt.NDArray = dataclasses.field(default_factory=lambda: np.zeros(3))


@dataclasses.dataclass
class SphereCollision(CollisionShape):
    center: npt.NDArray = dataclasses.field(default_factory=lambda: np.zeros(3))

