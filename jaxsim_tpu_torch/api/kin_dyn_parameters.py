"""Kinematic/dynamic model parameters: the build path.

Counterpart of ``jaxsim_tpu/api/kin_dyn_parameters.py`` (``LinkParameters``,
``ContactParameters.build_from``, ``KinDynParameters.build``), in NumPy. The
JAX package freezes the parsed description into float32 device arrays with
one ``jax.device_put``; here the same freeze is a cast of every numeric leaf
to ``np.float32``, so both packages start from the same rounded numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import numpy.typing as npt

from jaxsim_tpu_torch.math import JointModel, JointType, np_spatial
from jaxsim_tpu_torch.parsers.descriptions import ModelDescription

# The JAX package's default float width after its device_put freeze.
FROZEN_DTYPE = np.float32


@dataclasses.dataclass(frozen=True)
class LinkParameters:
    """Inertial parameters of every link, stacked.

    ``inertia_elements`` stores the upper triangle (xx, xy, xz, yy, yz, zz) of
    the 3×3 inertia about the link CoM, link-frame oriented.
    """

    mass: npt.NDArray
    center_of_mass: npt.NDArray
    inertia_elements: npt.NDArray

    @staticmethod
    def build_from_spatial_inertias(M: list[npt.NDArray]) -> "LinkParameters":
        params = [np_spatial.spatial_inertia_to_params(np.asarray(Mi)) for Mi in M]
        return LinkParameters(
            mass=np.array([m for m, _, _ in params], dtype=FROZEN_DTYPE),
            center_of_mass=np.array([c for _, c, _ in params], dtype=FROZEN_DTYPE),
            inertia_elements=np.array(
                [
                    [I[0, 0], I[0, 1], I[0, 2], I[1, 1], I[1, 2], I[2, 2]]
                    for _, _, I in params
                ],
                dtype=FROZEN_DTYPE,
            ).reshape(len(M), 6),
        )

    def spatial_inertia(self) -> npt.NDArray:
        """6×6 spatial inertia of every link in its link frame, ``(nL, 6, 6)``,
        computed in the frozen dtype from the stacked parameters (the formula
        of ``jaxsim_tpu.math.Inertia.to_sixd``)."""
        m = self.mass[:, None, None]
        c = self.center_of_mass
        zero = np.zeros_like(c[:, 0])
        cx = np.stack(
            [
                np.stack([zero, -c[:, 2], c[:, 1]], -1),
                np.stack([c[:, 2], zero, -c[:, 0]], -1),
                np.stack([-c[:, 1], c[:, 0], zero], -1),
            ],
            -2,
        )
        xx, xy, xz, yy, yz, zz = (self.inertia_elements[:, i] for i in range(6))
        I = np.stack(
            [
                np.stack([xx, xy, xz], -1),
                np.stack([xy, yy, yz], -1),
                np.stack([xz, yz, zz], -1),
            ],
            -2,
        )
        cxT = np.swapaxes(cx, -1, -2)
        eye = np.broadcast_to(np.eye(3, dtype=c.dtype), cx.shape)
        top = np.concatenate([m * eye, m * cxT], -1)
        bot = np.concatenate([m * cx, I + m * (cx @ cxT)], -1)
        return np.concatenate([top, bot], -2)


@dataclasses.dataclass(frozen=True)
class ContactParameters:
    """Collidable points: parent-link indices + positions in the parent frame."""

    body: tuple[int, ...] = ()
    enabled: tuple[bool, ...] = ()
    point: npt.NDArray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), dtype=FROZEN_DTYPE)
    )

    @property
    def indices_of_enabled_collidable_points(self) -> np.ndarray:
        return np.where(np.array(self.enabled, dtype=bool))[0]

    @staticmethod
    def build_from(model_description: ModelDescription) -> "ContactParameters":
        # Disabled points are kept too, in shape order, as the JAX package does.
        all_points = [
            p
            for shape in model_description.collision_shapes
            for p in shape.collidable_points
        ]
        if len(all_points) == 0:
            return ContactParameters()
        return ContactParameters(
            body=tuple(int(p.parent_link.index) for p in all_points),
            enabled=tuple(bool(p.enabled) for p in all_points),
            point=np.array([p.position for p in all_points], dtype=FROZEN_DTYPE),
        )


@dataclasses.dataclass(frozen=True)
class KinDynParameters:
    """Frozen numeric model: topology + stacked parameters."""

    link_names: tuple[str, ...]
    parent_array_static: tuple[int, ...]
    motion_subspaces: npt.NDArray  # S, (nL, 6), linear-first; row 0 zeros
    link_parameters: LinkParameters
    joint_model: JointModel
    contact_parameters: ContactParameters

    @staticmethod
    def build(model_description: ModelDescription) -> "KinDynParameters":
        ordered_links = sorted(
            model_description.links_dict.values(), key=lambda l: l.index
        )
        ordered_joints = sorted(
            model_description.joints_dict.values(), key=lambda j: j.index
        )

        link_parameters = LinkParameters.build_from_spatial_inertias(
            [link.inertia for link in ordered_links]
        )

        jm = JointModel.build(description=model_description)
        joint_model = dataclasses.replace(
            jm,
            lambda_H_pre=jm.lambda_H_pre.astype(FROZEN_DTYPE),
            suc_H_i=jm.suc_H_i.astype(FROZEN_DTYPE),
            joint_axis=jm.joint_axis.astype(FROZEN_DTYPE),
        )

        links_dict = model_description.links_dict
        parent_array = [-1] * len(ordered_links)
        for link in ordered_links:
            if link.parent_name is not None and link.parent_name in links_dict:
                parent_array[link.index] = links_dict[link.parent_name].index

        # Motion subspaces S (linear-first): revolute → [0; a], prismatic →
        # [a; 0]; row 0 is the world→base joint (zeros).
        S = np.zeros((len(ordered_links), 6))
        for joint in ordered_joints:
            axis = np.asarray(joint.axis, dtype=float).squeeze()
            if joint.jtype == JointType.Revolute:
                S[joint.index, 3:6] = axis
            elif joint.jtype == JointType.Prismatic:
                S[joint.index, 0:3] = axis

        return KinDynParameters(
            link_names=tuple(l.name for l in ordered_links),
            parent_array_static=tuple(int(i) for i in parent_array),
            motion_subspaces=S.astype(FROZEN_DTYPE),
            link_parameters=link_parameters,
            joint_model=joint_model,
            contact_parameters=ContactParameters.build_from(model_description),
        )

    def number_of_links(self) -> int:
        return len(self.link_names)

    def number_of_joints(self) -> int:
        return len(self.joint_model.joint_names) - 1
