"""Collision point generation from geometric primitives.

Counterpart of ``jaxsim_tpu/parsers/collision_utils.py`` for boxes and
spheres: boxes become their 8 corner points (or bottom 4 with
``JAXSIM_COLLISION_USE_BOTTOM_ONLY``), spheres a fibonacci point cloud
(``JAXSIM_COLLISION_SPHERE_POINTS``, default 50). Mesh collisions are not
ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import numpy.typing as npt

from .descriptions.collision import BoxCollision, CollidablePoint, SphereCollision
from .descriptions.link import LinkDescription


def fibonacci_sphere(samples: int) -> npt.NDArray:
    """Uniformly-distributed unit-sphere points (golden-angle spiral).

    ``samples == 1`` degenerates to the single ground-facing point
    ``(0, 0, -1)`` (the spiral needs ≥ 2 points; one point is only useful
    for minimal ground-contact models)."""
    if samples == 1:
        return np.array([(0.0, 0.0, -1.0)])
    points = []
    phi = np.pi * (3.0 - np.sqrt(5.0))
    for i in range(samples):
        y = 1 - (i / float(samples - 1)) * 2
        radius = np.sqrt(1 - y * y)
        theta = phi * i
        points.append((np.cos(theta) * radius, y, np.sin(theta) * radius))
    return np.array(points)


def create_box_collision(
    link: LinkDescription, size: npt.NDArray, L_H_C: npt.NDArray
) -> BoxCollision:
    """Box → corner collidable points in the link frame."""
    x, y, z = np.asarray(size, dtype=float)
    corners = (
        np.vstack(
            [
                np.array([sx, sy, sz])
                for sx in (-x / 2, x / 2)
                for sy in (-y / 2, y / 2)
                for sz in (-z / 2, z / 2)
            ]
        )
    )
    if os.environ.get("JAXSIM_COLLISION_USE_BOTTOM_ONLY", "0") == "1":
        corners = corners[corners[:, 2] < 0]

    H = np.asarray(L_H_C, dtype=float)
    corners_link = (H @ np.hstack([corners, np.ones((len(corners), 1))]).T).T[:, :3]

    return BoxCollision(
        collidable_points=tuple(
            CollidablePoint(parent_link=link, position=p, enabled=True)
            for p in corners_link
        ),
        center=H[:3, 3],
    )


def create_sphere_collision(
    link: LinkDescription, radius: float, L_H_C: npt.NDArray
) -> SphereCollision:
    """Sphere → fibonacci point cloud in the link frame."""
    n = int(os.environ.get("JAXSIM_COLLISION_SPHERE_POINTS", "50"))
    points = radius * fibonacci_sphere(samples=n)
    H = np.asarray(L_H_C, dtype=float)
    points_link = (H @ np.hstack([points, np.ones((len(points), 1))]).T).T[:, :3]
    return SphereCollision(
        collidable_points=tuple(
            CollidablePoint(parent_link=link, position=p, enabled=True)
            for p in points_link
        ),
        center=H[:3, 3],
    )
