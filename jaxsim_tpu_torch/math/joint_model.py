"""Joint kinematic model: the fixed frames around every joint.

Counterpart of ``jaxsim_tpu/math/joint_model.py`` (``JointType`` and
``JointModel.build``), in NumPy. Joint index convention as there: index 0 is
the dummy world→base joint; joint i (1-based) has child link i.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import numpy.typing as npt


class JointType:
    """Integer joint types."""

    Fixed = 0
    Revolute = 1
    Prismatic = 2


@dataclasses.dataclass(frozen=True)
class JointModel:
    """Fixed joint transforms + static metadata.

    Attributes:
        lambda_H_pre: ``(1+n_joints, 4, 4)`` parent-link → joint-predecessor frames.
        suc_H_i: ``(1+n_joints, 4, 4)`` joint-successor → child-link frames
            (index 0 stores the base pose w.r.t. the model root frame).
        joint_axis: ``(n_joints, 3)`` motion axes.
        joint_dofs/joint_names/joint_types: per-joint metadata, index 0
            being the world→base joint.
    """

    lambda_H_pre: npt.NDArray
    suc_H_i: npt.NDArray
    joint_axis: npt.NDArray

    joint_dofs: tuple[int, ...] = ()
    joint_names: tuple[str, ...] = ()
    joint_types: tuple[int, ...] = ()

    @staticmethod
    def build(description) -> "JointModel":
        """Build from a :class:`~jaxsim_tpu_torch.parsers.descriptions.ModelDescription`,
        with the offline graph FK at the initial joint configuration."""
        from jaxsim_tpu_torch.parsers.kinematic_graph import KinematicGraphTransforms

        ordered_links = sorted(description.links_dict.values(), key=lambda l: l.index)
        ordered_joints = sorted(description.joints_dict.values(), key=lambda j: j.index)

        n = len(ordered_joints)
        lambda_H_pre = np.zeros((1 + n, 4, 4))
        suc_H_i = np.zeros((1 + n, 4, 4))
        lambda_H_pre[0] = np.eye(4)
        # Index 0 stores the (optional) base pose w.r.t. the model root frame.
        suc_H_i[0] = np.asarray(ordered_links[0].pose)

        fk = KinematicGraphTransforms(graph=description)
        for joint in ordered_joints:
            lambda_H_pre[joint.index] = fk.relative_transform(
                relative_to=joint.parent.name, name=joint.name
            )
            suc_H_i[joint.index] = fk.relative_transform(
                relative_to=joint.name, name=joint.child.name
            )

        axes = (
            np.stack([np.asarray(j.axis).squeeze() for j in ordered_joints])
            if n > 0
            else np.zeros((0, 3))
        )

        base_dofs = 0 if description.fixed_base else 6

        return JointModel(
            lambda_H_pre=np.asarray(lambda_H_pre, dtype=float),
            suc_H_i=np.asarray(suc_H_i, dtype=float),
            joint_axis=np.asarray(axes, dtype=float),
            joint_dofs=tuple([base_dofs] + [1] * n),
            joint_names=tuple(["world_to_base"] + [j.name for j in ordered_joints]),
            joint_types=tuple([JointType.Fixed] + [j.jtype for j in ordered_joints]),
        )
