"""Offline NumPy spatial-math helpers for the model-description layer.

Counterpart of ``jaxsim_tpu/math/np_spatial.py``, unchanged: the description
pipeline (parsers, kinematic graph, parameter freezing) is plain NumPy that
runs once per model build, before any tensor exists.
"""

from __future__ import annotations

import numpy as np
import numpy.typing as npt


def skew(v: npt.ArrayLike) -> npt.NDArray:
    v = np.asarray(v, dtype=float)
    return np.array(
        [
            [0.0, -v[2], v[1]],
            [v[2], 0.0, -v[0]],
            [-v[1], v[0], 0.0],
        ]
    )


def spatial_inertia(
    mass: float, com: npt.ArrayLike, I_com: npt.ArrayLike
) -> npt.NDArray:
    """6×6 spatial inertia (linear-first) about the link-frame origin from
    mass, CoM offset, and the 3×3 inertia about the CoM (link-frame oriented).
    Same formula as ``jaxsim_tpu.math.Inertia.to_sixd``."""
    m = float(mass)
    c = skew(com)
    I_com = np.asarray(I_com, dtype=float)
    M = np.zeros((6, 6))
    M[0:3, 0:3] = m * np.eye(3)
    M[0:3, 3:6] = m * c.T
    M[3:6, 0:3] = m * c
    M[3:6, 3:6] = I_com + m * (c @ c.T)
    return M


def spatial_inertia_to_params(
    M: npt.ArrayLike,
) -> tuple[float, npt.NDArray, npt.NDArray]:
    """(mass, com, 3×3 inertia about the CoM) from a 6×6 spatial inertia.
    Same formula as ``jaxsim_tpu.math.Inertia.to_params``."""
    M = np.asarray(M, dtype=float)
    m = float(np.trace(M[0:3, 0:3]) / 3.0)
    mC = M[3:6, 0:3]
    if m == 0.0:
        return 0.0, np.zeros(3), M[3:6, 3:6].copy()
    c = np.array([mC[2, 1], mC[0, 2], mC[1, 0]]) / m
    I_com = M[3:6, 3:6] - mC @ mC.T / m
    return m, c, I_com


def dcm_from_quat_wxyz(q: npt.ArrayLike) -> npt.NDArray:
    w, x, y, z = np.asarray(q, dtype=float) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_wxyz_from_dcm(R: npt.ArrayLike) -> npt.NDArray:
    """wxyz quaternion from a rotation matrix (Shepperd's branch method)."""
    R = np.asarray(R, dtype=float)
    t = np.trace(R)
    if t > 0.0:
        s = np.sqrt(t + 1.0) * 2.0
        q = np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        q = np.array(
            [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
        )
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        q = np.array(
            [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s]
        )
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        q = np.array(
            [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s]
        )
    # Canonical sign (w ≥ 0) and unit norm.
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def transform_from_quat_trans(
    quaternion_wxyz: npt.ArrayLike, translation: npt.ArrayLike
) -> npt.NDArray:
    H = np.eye(4)
    H[:3, :3] = dcm_from_quat_wxyz(quaternion_wxyz)
    H[:3, 3] = np.asarray(translation, dtype=float)
    return H


def rodrigues(axis: npt.ArrayLike, angle: float) -> npt.NDArray:
    """Rotation matrix about a (unit) axis by ``angle``."""
    a = np.asarray(axis, dtype=float)
    n = np.linalg.norm(a)
    if n < 1e-12:
        return np.eye(3)
    a = a / n
    K = skew(a)
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def joint_transform(
    joint_type: int, joint_axis: npt.ArrayLike, joint_position: float
) -> npt.NDArray:
    """pre_H_suc(s) for one joint (single-joint form of
    ``jaxsim_tpu.math.supported_joint_motion``)."""
    from .joint_model import JointType

    H = np.eye(4)
    s = float(joint_position)
    axis = np.asarray(joint_axis, dtype=float).squeeze()
    if joint_type == JointType.Revolute:
        # s*axis is a ROTATION VECTOR (matches the traced
        # supported_joint_motion): a non-unit URDF axis scales the angle.
        rotvec = s * axis
        H[:3, :3] = rodrigues(rotvec, float(np.linalg.norm(rotvec)))
    elif joint_type == JointType.Prismatic:
        H[:3, 3] = s * axis
    return H
