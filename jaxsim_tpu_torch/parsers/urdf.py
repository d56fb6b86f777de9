"""URDF parser (stdlib XML, no ``rod`` dependency).

Counterpart of ``jaxsim_tpu/parsers/urdf.py``. Produces the inputs of
:class:`~jaxsim_tpu_torch.parsers.descriptions.model.ModelDescription`
using the URDF frame convention: joint frame ≡ child link frame, joint pose
expressed w.r.t. the parent link frame.

Conventions of the produced descriptions:
* ``link.pose``  = joint_H_link (identity in URDF), root: model_H_root;
* ``joint.pose`` = parentlink_H_jointframe (URDF ``<origin>``);
* ``frame.pose`` = parentlink_H_frame (massless links become frames).
"""

from __future__ import annotations

import logging
import os
import pathlib
import xml.etree.ElementTree as ET

import numpy as np
import numpy.typing as npt

from jaxsim_tpu_torch.math import np_spatial

from . import collision_utils
from .descriptions.collision import CollisionShape
from .descriptions.joint import JointDescription, JointType
from .descriptions.link import LinkDescription
from .kinematic_graph import RootPose

_log = logging.getLogger(__name__)

_JOINT_TYPES = {
    "fixed": JointType.Fixed,
    "revolute": JointType.Revolute,
    "continuous": JointType.Revolute,
    "prismatic": JointType.Prismatic,
}


def _rpy_to_matrix(rpy: npt.NDArray) -> npt.NDArray:
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _origin_to_matrix(element: ET.Element | None) -> npt.NDArray:
    H = np.eye(4)
    if element is None:
        return H
    xyz = np.fromstring(element.get("xyz", "0 0 0"), sep=" ")
    rpy = np.fromstring(element.get("rpy", "0 0 0"), sep=" ")
    H[:3, :3] = _rpy_to_matrix(rpy)
    H[:3, 3] = xyz
    return H


def _parse_inertial(link_el: ET.Element) -> tuple[float, npt.NDArray]:
    """Return (mass, 6×6 spatial inertia in the link frame)."""
    inertial = link_el.find("inertial")
    if inertial is None:
        return 0.0, np.zeros((6, 6))

    mass_el = inertial.find("mass")
    mass = float(mass_el.get("value", "0")) if mass_el is not None else 0.0

    H = _origin_to_matrix(inertial.find("origin"))
    com, R = H[:3, 3], H[:3, :3]

    inertia_el = inertial.find("inertia")
    if inertia_el is not None:
        ixx = float(inertia_el.get("ixx", "0"))
        iyy = float(inertia_el.get("iyy", "0"))
        izz = float(inertia_el.get("izz", "0"))
        ixy = float(inertia_el.get("ixy", "0"))
        ixz = float(inertia_el.get("ixz", "0"))
        iyz = float(inertia_el.get("iyz", "0"))
        I_com = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    else:
        I_com = np.zeros((3, 3))

    # Rotate the CoM inertia into the link frame orientation, then build the
    # 6×6 spatial inertia about the link origin (Inertia.to_sixd takes the
    # inertia about the CoM, link-frame oriented).
    I_com_link = R @ I_com @ R.T
    M = np_spatial.spatial_inertia(mass, com, I_com_link)
    return mass, M


def _parse_collisions(
    link_el: ET.Element, link: LinkDescription
) -> list[CollisionShape]:
    shapes: list[CollisionShape] = []
    for collision in link_el.findall("collision"):
        geometry = collision.find("geometry")
        if geometry is None:
            continue
        L_H_C = _origin_to_matrix(collision.find("origin"))
        box = geometry.find("box")
        sphere = geometry.find("sphere")
        cylinder = geometry.find("cylinder")
        mesh = geometry.find("mesh")
        if box is not None:
            size = np.fromstring(box.get("size", "0 0 0"), sep=" ")
            shapes.append(collision_utils.create_box_collision(link, size, L_H_C))
        elif sphere is not None:
            radius = float(sphere.get("radius", "0"))
            shapes.append(collision_utils.create_sphere_collision(link, radius, L_H_C))
        elif cylinder is not None:
            # Approximate cylinder with the corner circle points of a box of
            # matching bounding dimensions (cheap, same contact behavior for
            # locomotion-style use).
            radius = float(cylinder.get("radius", "0"))
            length = float(cylinder.get("length", "0"))
            size = np.array([2 * radius, 2 * radius, length])
            shapes.append(collision_utils.create_box_collision(link, size, L_H_C))
        elif mesh is not None:
            if os.environ.get("JAXSIM_COLLISION_MESH_ENABLED", "0") != "1":
                _log.debug("Mesh collisions disabled; skipping")
                continue
            raise NotImplementedError(
                "mesh collisions are not ported yet (jaxsim_tpu/parsers/meshes.py)"
            )
    return shapes


def parse_urdf(
    urdf: str | pathlib.Path,
) -> tuple[
    str,
    list[LinkDescription],
    list[LinkDescription],
    list[JointDescription],
    list[CollisionShape],
    bool,
    RootPose,
    str | None,
]:
    """Parse a URDF string/path.

    Returns (model_name, links, frames, joints, collisions, fixed_base,
    root_pose, base_link_name).
    """
    text = urdf
    if isinstance(urdf, pathlib.Path) or (
        isinstance(urdf, str) and len(urdf) < 4096 and os.path.exists(urdf)
    ):
        text = pathlib.Path(urdf).read_text()

    root = ET.fromstring(text)
    if root.tag != "robot":
        raise ValueError(f"Not a URDF: root tag '{root.tag}'")
    model_name = root.get("name", "robot")

    joint_els = root.findall("joint")
    link_els = root.findall("link")

    # Detect fixed-base: a massless 'world' link connected by a fixed joint.
    world_names = {
        l.get("name") for l in link_els if l.get("name", "").lower() == "world"
    }
    fixed_base = False
    base_link_name = None
    world_H_base = np.eye(4)

    default_spring = float(os.environ.get("JAXSIM_JOINT_POSITION_LIMIT_SPRING", "0"))
    default_damper = float(os.environ.get("JAXSIM_JOINT_POSITION_LIMIT_DAMPER", "0"))

    links: dict[str, LinkDescription] = {}
    frames: list[LinkDescription] = []
    parsed_links: list[LinkDescription] = []

    for link_el in link_els:
        name = link_el.get("name")
        if name in world_names:
            continue
        mass, M = _parse_inertial(link_el)
        link = LinkDescription(name=name, mass=mass, inertia=M, pose=np.eye(4))
        links[name] = link
        parsed_links.append(link)

    joints: list[JointDescription] = []
    frame_candidates: dict[str, tuple[str, npt.NDArray]] = {}

    # Links that act as a parent of some joint can never be frames.
    parents_of_joints = {
        j.find("parent").get("link")
        for j in joint_els
        if j.find("parent") is not None
    }

    for joint_el in joint_els:
        jname = joint_el.get("name")
        jtype_str = joint_el.get("type", "fixed")
        parent_name = joint_el.find("parent").get("link")
        child_name = joint_el.find("child").get("link")
        H = _origin_to_matrix(joint_el.find("origin"))

        if parent_name in world_names:
            # World-attached joint: the model is fixed-base, the child is the
            # base link (reference ``parsers/rod/parser.py:147-197``).
            if jtype_str != "fixed":
                raise ValueError(
                    f"Only fixed world joints are supported, got {jtype_str}"
                )
            fixed_base = True
            base_link_name = child_name
            world_H_base = H
            continue

        if jtype_str not in _JOINT_TYPES:
            raise ValueError(f"Unsupported joint type: {jtype_str}")

        child_link = links.get(child_name)
        parent_link = links.get(parent_name)
        if child_link is None or parent_link is None:
            _log.warning(f"Joint '{jname}' references unknown links; skipping")
            continue

        axis_el = joint_el.find("axis")
        axis = (
            np.fromstring(axis_el.get("xyz", "1 0 0"), sep=" ")
            if axis_el is not None
            else np.array([1.0, 0, 0])
        )

        limit_el = joint_el.find("limit")
        if limit_el is not None and jtype_str in ("revolute", "prismatic"):
            lower = float(limit_el.get("lower", "-inf"))
            upper = float(limit_el.get("upper", "inf"))
        else:
            lower, upper = -np.inf, np.inf

        dynamics_el = joint_el.find("dynamics")
        damping = (
            float(dynamics_el.get("damping", "0")) if dynamics_el is not None else 0.0
        )
        friction = (
            float(dynamics_el.get("friction", "0")) if dynamics_el is not None else 0.0
        )

        if (
            jtype_str == "fixed"
            and child_link.mass == 0.0
            and child_name not in parents_of_joints
        ):
            # A fixed joint to a massless leaf link defines a frame.
            frame_candidates[child_name] = (parent_name, H)
            continue

        joints.append(
            JointDescription(
                name=jname,
                axis=axis,
                pose=H,
                jtype=_JOINT_TYPES[jtype_str],
                parent=parent_link,
                child=child_link,
                position_limit=(lower, upper),
                friction_viscous=damping,
                friction_static=friction,
                position_limit_spring=default_spring,
                position_limit_damper=default_damper,
            )
        )

    # Massless leaves attached by fixed joints become frames; chase chains of
    # frames down to a real parent link.
    def resolve_frame_parent(name: str) -> tuple[str, npt.NDArray] | None:
        parent, H = frame_candidates[name]
        hops = 0
        while parent in frame_candidates:
            parent_parent, parent_H = frame_candidates[parent]
            H = parent_H @ H
            parent = parent_parent
            hops += 1
            if hops > 1000:
                return None
        return (parent, H) if parent in links else None

    for fname in frame_candidates:
        resolved = resolve_frame_parent(fname)
        if resolved is None:
            _log.warning(f"Dropping frame '{fname}' with no link ancestor")
            continue
        parent, H = resolved
        frame = links.pop(fname, None)
        if frame is None:
            continue
        parsed_links.remove(frame)
        frame.parent_name = parent
        frame.pose = H
        frame.mass = 0.0
        frame.inertia = np.zeros((6, 6))
        frames.append(frame)

    # Fixed-base: fold the world→base pose into the base link pose so the
    # kinematics pick it up via suc_H_i[0] with an identity base transform.
    if fixed_base and base_link_name in links:
        links[base_link_name].pose = world_H_base

    collisions: list[CollisionShape] = []
    for link_el in link_els:
        name = link_el.get("name")
        if name in links:
            collisions.extend(_parse_collisions(link_el, links[name]))

    root_pose = RootPose(
        root_position=world_H_base[:3, 3],
        root_quaternion=_matrix_to_wxyz(world_H_base[:3, :3]),
    )

    return (
        model_name,
        parsed_links,
        frames,
        joints,
        collisions,
        fixed_base,
        root_pose,
        base_link_name,
    )


def _matrix_to_wxyz(R: npt.NDArray) -> npt.NDArray:
    return np_spatial.quat_wxyz_from_dcm(np.asarray(R))
