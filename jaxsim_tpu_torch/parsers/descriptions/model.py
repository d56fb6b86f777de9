"""Complete model description: kinematic graph + collisions.

Counterpart of ``jaxsim_tpu/parsers/descriptions/model.py`` (the build path;
model-level reduction and per-link collision edits are not ported yet).
"""

from __future__ import annotations

import dataclasses
import logging
from collections.abc import Sequence

import numpy as np

from jaxsim_tpu_torch.parsers.kinematic_graph import (
    KinematicGraph,
    KinematicGraphTransforms,
    RootPose,
)

from .collision import CollidablePoint, CollisionShape
from .joint import JointDescription
from .link import LinkDescription

_log = logging.getLogger(__name__)


@dataclasses.dataclass(eq=False)
class ModelDescription(KinematicGraph):
    """Intermediate full description of a robot model."""

    name: str = None
    fixed_base: bool = True
    collision_shapes: list[CollisionShape] = dataclasses.field(default_factory=list)

    @staticmethod
    def build_model_from(
        name: str,
        links: list[LinkDescription],
        joints: list[JointDescription],
        frames: list[LinkDescription] | None = None,
        collisions: list[CollisionShape] | None = None,
        fixed_base: bool = False,
        base_link_name: str | None = None,
        considered_joints: Sequence[str] | None = None,
        model_pose: RootPose = RootPose(),
    ) -> "ModelDescription":
        """Build a model description, optionally reducing it on the fly.

        Collision points of links that get lumped by the (optional) reduction
        are re-expressed on the new parent link (reference
        ``descriptions/model.py:35-155``).
        """
        collisions = collisions or []

        graph = KinematicGraph.build_from(
            links=links,
            joints=joints,
            frames=frames,
            root_link_name=base_link_name,
            root_pose=model_pose,
        )

        if considered_joints is not None:
            graph = graph.reduce(considered_joints=list(considered_joints))

        fk = KinematicGraphTransforms(graph=graph)

        final_collisions: list[CollisionShape] = []
        for shape in collisions:
            new_points: list[CollidablePoint] = []
            for point in shape.collidable_points:
                name_of_parent = point.parent_link.name
                if name_of_parent in graph.links_dict:
                    # Parent link survived; rebind to the graph's instance.
                    new_points.append(
                        CollidablePoint(
                            parent_link=graph.links_dict[name_of_parent],
                            position=np.asarray(point.position, dtype=float),
                            enabled=point.enabled,
                        )
                    )
                elif name_of_parent in graph.frames_dict:
                    # Parent link was lumped: move the point to the real link.
                    real_parent = fk.find_parent_link_of_frame(name=name_of_parent)
                    L_H_F = fk.relative_transform(
                        relative_to=real_parent, name=name_of_parent
                    )
                    new_points.append(
                        point.change_link(
                            new_link=graph.links_dict[real_parent],
                            new_H_old=L_H_F,
                        )
                    )
                else:
                    _log.debug(
                        f"Dropping collision point of removed link '{name_of_parent}'"
                    )
            if new_points:
                shape = dataclasses.replace(
                    shape, collidable_points=tuple(new_points)
                )
                final_collisions.append(shape)

        model = ModelDescription(
            name=name,
            root_pose=graph.root_pose,
            fixed_base=fixed_base,
            collision_shapes=final_collisions,
            root=graph.root,
            joints=graph.joints,
            frames=graph.frames,
            _joints_removed=graph.joints_removed,
        )
        assert model.name == name, (model.name, name)
        return model

    def all_enabled_collidable_points(self) -> list[CollidablePoint]:
        """All enabled collidable points (reference ``model.py:233-248``)."""
        return [
            point
            for shape in self.collision_shapes
            for point in shape.collidable_points
            if point.enabled
        ]

