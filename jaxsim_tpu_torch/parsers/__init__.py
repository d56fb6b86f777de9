"""Model description pipeline: URDF → :class:`ModelDescription`.

Counterpart of ``jaxsim_tpu/parsers/__init__.py`` for URDF inputs. SDF is
not ported yet and raises.
"""

from __future__ import annotations

import os
import pathlib

from . import descriptions
from .kinematic_graph import KinematicGraph, KinematicGraphTransforms, RootPose


def _detect_format(model: str | pathlib.Path) -> str:
    """Return "urdf" or "sdf"."""
    text = model
    if isinstance(model, pathlib.Path) or (
        isinstance(model, str) and len(model) < 4096 and os.path.exists(model)
    ):
        path = pathlib.Path(model)
        text = path.read_text()
        if path.suffix.lower() == ".urdf":
            return "urdf"
        if path.suffix.lower() in (".sdf", ".world"):
            return "sdf"
    import re

    m = re.search(r"<\s*(robot|sdf|model)[\s>]", text.lstrip())
    if m is None:
        raise ValueError("Cannot detect model format (no robot/sdf/model root tag)")
    return "urdf" if m.group(1) == "robot" else "sdf"


def build_model_description(
    model: str | pathlib.Path,
    *,
    is_urdf: bool | None = None,
    considered_joints: list[str] | None = None,
) -> descriptions.ModelDescription:
    """Parse a URDF (path or string) into a :class:`ModelDescription`.

    By default all fixed joints are lumped away, as in the JAX package.
    """
    from jaxsim_tpu_torch.math.joint_model import JointType

    fmt = _detect_format(model) if is_urdf is None else ("urdf" if is_urdf else "sdf")
    if fmt != "urdf":
        raise NotImplementedError("SDF parsing is not ported yet (jaxsim_tpu/parsers/sdf.py)")

    from .urdf import parse_urdf

    (
        name,
        links,
        frames,
        joints,
        collisions,
        fixed_base,
        root_pose,
        base_link_name,
    ) = parse_urdf(model)

    if considered_joints is None:
        considered_joints = [
            j.name for j in joints if j.jtype is not JointType.Fixed
        ]

    return descriptions.ModelDescription.build_model_from(
        name=name,
        links=links,
        joints=joints,
        frames=frames,
        collisions=collisions,
        fixed_base=fixed_base,
        base_link_name=base_link_name,
        considered_joints=considered_joints,
        model_pose=root_pose,
    )


__all__ = [
    "KinematicGraph",
    "KinematicGraphTransforms",
    "RootPose",
    "build_model_description",
    "descriptions",
]
