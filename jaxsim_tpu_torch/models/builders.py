"""Programmatic URDF model builders (the same strings as
``jaxsim_tpu/models/builders.py``).

Upstream jaxsim builds its test-model zoo with ``rod.builder`` primitives
and ``robot_descriptions`` downloads; these generators produce URDF for the
same model categories without either dependency: single bodies (box/sphere), fixed-base chains (pendulums, arm),
cartpole, and a 23-DoF floating-base humanoid used as the benchmark flagship
(iCub-like locomotion DoF layout: 3 torso + 2×4 arms + 2×6 legs).
"""

from __future__ import annotations


def _box_inertia(mass: float, x: float, y: float, z: float) -> dict:
    ixx = mass / 12 * (y**2 + z**2)
    iyy = mass / 12 * (x**2 + z**2)
    izz = mass / 12 * (x**2 + y**2)
    return {"ixx": ixx, "iyy": iyy, "izz": izz, "ixy": 0.0, "ixz": 0.0, "iyz": 0.0}


def _cylinder_inertia(mass: float, radius: float, length: float) -> dict:
    ixx = iyy = mass / 12 * (3 * radius**2 + length**2)
    izz = mass / 2 * radius**2
    return {"ixx": ixx, "iyy": iyy, "izz": izz, "ixy": 0.0, "ixz": 0.0, "iyz": 0.0}


def _sphere_inertia(mass: float, radius: float) -> dict:
    i = 2.0 / 5.0 * mass * radius**2
    return {"ixx": i, "iyy": i, "izz": i, "ixy": 0.0, "ixz": 0.0, "iyz": 0.0}


def _link(
    name: str,
    mass: float,
    inertia: dict,
    com: tuple = (0, 0, 0),
    collision: str = "",
    visual: str | None = None,
) -> str:
    i = inertia
    # Default visual: reuse the collision geometry; else a small marker box
    # at the CoM so every link renders in MuJoCo.
    if visual is None:
        if collision:
            visual = collision.replace("<collision>", "<visual>").replace(
                "</collision>", "</visual>"
            )
        else:
            visual = f"""
    <visual>
      <origin xyz="{com[0]} {com[1]} {com[2]}" rpy="0 0 0"/>
      <geometry><box size="0.04 0.04 0.04"/></geometry>
    </visual>"""
    return f"""
  <link name="{name}">
    <inertial>
      <origin xyz="{com[0]} {com[1]} {com[2]}" rpy="0 0 0"/>
      <mass value="{mass}"/>
      <inertia ixx="{i["ixx"]}" ixy="{i["ixy"]}" ixz="{i["ixz"]}"
               iyy="{i["iyy"]}" iyz="{i["iyz"]}" izz="{i["izz"]}"/>
    </inertial>{visual}{collision}
  </link>"""


def _box_collision(x: float, y: float, z: float, origin=(0, 0, 0)) -> str:
    return f"""
    <collision>
      <origin xyz="{origin[0]} {origin[1]} {origin[2]}" rpy="0 0 0"/>
      <geometry><box size="{x} {y} {z}"/></geometry>
    </collision>"""


def _sphere_collision(radius: float, origin=(0, 0, 0)) -> str:
    return f"""
    <collision>
      <origin xyz="{origin[0]} {origin[1]} {origin[2]}" rpy="0 0 0"/>
      <geometry><sphere radius="{radius}"/></geometry>
    </collision>"""


def _joint(
    name: str,
    jtype: str,
    parent: str,
    child: str,
    xyz=(0, 0, 0),
    rpy=(0, 0, 0),
    axis=(0, 0, 1),
    lower: float | None = None,
    upper: float | None = None,
    damping: float = 0.0,
    effort: float = 500.0,
    velocity: float = 10.0,
) -> str:
    limit = ""
    if jtype in ("revolute", "prismatic"):
        lo = lower if lower is not None else -3.14
        hi = upper if upper is not None else 3.14
        limit = (
            f'\n    <limit lower="{lo}" upper="{hi}" effort="{effort}"'
            f' velocity="{velocity}"/>'
        )
    return f"""
  <joint name="{name}" type="{jtype}">
    <origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" rpy="{rpy[0]} {rpy[1]} {rpy[2]}"/>
    <parent link="{parent}"/>
    <child link="{child}"/>
    <axis xyz="{axis[0]} {axis[1]} {axis[2]}"/>{limit}
    <dynamics damping="{damping}" friction="0"/>
  </joint>"""


def build_box_urdf(
    mass: float = 1.0, size: tuple = (0.3, 0.2, 0.1), name: str = "box"
) -> str:
    """Floating-base single box with corner collision points."""
    x, y, z = size
    return f"""<robot name="{name}">{_link(name + "_link", mass, _box_inertia(mass, x, y, z), collision=_box_collision(x, y, z))}
</robot>"""


def build_sphere_urdf(mass: float = 1.0, radius: float = 0.15, name: str = "sphere") -> str:
    """Floating-base single sphere with fibonacci collision points."""
    return f"""<robot name="{name}">{_link(name + "_link", mass, _sphere_inertia(mass, radius), collision=_sphere_collision(radius))}
</robot>"""


def build_pendulum_urdf(num_links: int = 1, name: str | None = None) -> str:
    """Fixed-base n-link pendulum: links of length 1 m, point mass 1 kg at the
    tip of each rod, rotating about +y, hanging along -z."""
    name = name or (f"pendulum_{num_links}" if num_links != 2 else "double_pendulum")
    parts = ['  <link name="world"/>']
    parts.append(
        _joint("world_to_base", "fixed", "world", "base", xyz=(0, 0, 0))
    )
    parts.append(_link("base", 1.0, _box_inertia(1.0, 0.1, 0.1, 0.1)))
    parent = "base"
    for i in range(num_links):
        link_name = f"link{i + 1}"
        # Rod of length 1, CoM at the middle, slender-rod inertia.
        parts.append(
            _joint(
                f"joint{i + 1}",
                "revolute",
                parent,
                link_name,
                xyz=(0, 0, 0 if i == 0 else -1.0),
                axis=(0, 1, 0),
                lower=-6.28,
                upper=6.28,
            )
        )
        parts.append(
            _link(
                link_name,
                1.0,
                _cylinder_inertia(1.0, 0.02, 1.0),
                com=(0, 0, -0.5),
            )
        )
        parent = link_name
    body = "".join(parts)
    return f'<robot name="{name}">\n{body}\n</robot>'


def build_cartpole_urdf(name: str = "cartpole") -> str:
    """Fixed-base cartpole: prismatic cart on a rail + revolute pole."""
    parts = ['  <link name="world"/>']
    parts.append(_joint("world_to_rail", "fixed", "world", "rail"))
    parts.append(_link("rail", 5.0, _box_inertia(5.0, 5.0, 0.1, 0.1)))
    parts.append(
        _joint(
            "linear",
            "prismatic",
            "rail",
            "cart",
            axis=(1, 0, 0),
            lower=-2.4,
            upper=2.4,
        )
    )
    parts.append(_link("cart", 1.0, _box_inertia(1.0, 0.3, 0.2, 0.1)))
    parts.append(
        _joint(
            "pivot",
            "revolute",
            "cart",
            "pole",
            axis=(0, 1, 0),
            lower=-6.28,
            upper=6.28,
        )
    )
    parts.append(
        _link("pole", 0.5, _cylinder_inertia(0.5, 0.02, 1.0), com=(0, 0, 0.5))
    )
    body = "".join(parts)
    return f'<robot name="{name}">\n{body}\n</robot>'


def build_arm_urdf(num_joints: int = 6, name: str = "arm6") -> str:
    """Fixed-base serial arm (UR10-ish scale) with alternating joint axes."""
    parts = ['  <link name="world"/>']
    parts.append(_joint("world_to_base", "fixed", "world", "base_link"))
    parts.append(_link("base_link", 4.0, _cylinder_inertia(4.0, 0.08, 0.2)))
    parent = "base_link"
    axes = [(0, 0, 1), (0, 1, 0), (0, 1, 0), (0, 1, 0), (0, 0, 1), (0, 1, 0)]
    lengths = [0.18, 0.6, 0.57, 0.12, 0.12, 0.1]
    masses = [7.8, 12.9, 3.9, 1.3, 1.3, 0.4]
    for i in range(num_joints):
        ln = f"arm_link{i + 1}"
        parts.append(
            _joint(
                f"arm_joint{i + 1}",
                "revolute",
                parent,
                ln,
                xyz=(0, 0, lengths[i % 6]),
                axis=axes[i % 6],
                lower=-6.28,
                upper=6.28,
                damping=0.1,
            )
        )
        m = masses[i % 6]
        parts.append(
            _link(ln, m, _cylinder_inertia(m, 0.05, lengths[i % 6]), com=(0, 0, lengths[i % 6] / 2))
        )
        parent = ln
    # A frame at the tool tip.
    parts.append(
        _joint("ee_fixed", "fixed", parent, "ee_frame", xyz=(0, 0, lengths[(num_joints - 1) % 6]))
    )
    parts.append('  <link name="ee_frame"/>')
    body = "".join(parts)
    return f'<robot name="{name}">\n{body}\n</robot>'


def build_humanoid_urdf(name: str = "humanoid23") -> str:
    """Floating-base humanoid with the iCub locomotion DoF layout:
    3 torso + 2×4 arm + 2×6 leg = 23 revolute joints, 24 links, box feet
    with 8 collision points each (plus base/sole points).

    Benchmark flagship model (BASELINE.json: 23-DoF iCub, soft contacts).
    """
    parts = []
    # Base: pelvis (floating).
    parts.append(
        _link(
            "pelvis",
            9.0,
            _box_inertia(9.0, 0.15, 0.25, 0.15),
            collision=_box_collision(0.15, 0.25, 0.15),
        )
    )

    def add(jname, parent, child_spec, xyz, axis, lo=-2.5, hi=2.5):
        cname, cmass, csize, ccom, ccol = child_spec
        parts.append(
            _joint(jname, "revolute", parent, cname, xyz=xyz, axis=axis, lower=lo, upper=hi, damping=0.1)
        )
        parts.append(
            _link(cname, cmass, _box_inertia(cmass, *csize), com=ccom, collision=ccol)
        )

    # --- torso: 3 DoF (roll, pitch, yaw) ---
    add("torso_roll", "pelvis", ("torso_1", 2.0, (0.1, 0.2, 0.1), (0, 0, 0.05), ""), (0, 0, 0.1), (1, 0, 0))
    add("torso_pitch", "torso_1", ("torso_2", 2.0, (0.1, 0.2, 0.1), (0, 0, 0.05), ""), (0, 0, 0.1), (0, 1, 0))
    add("torso_yaw", "torso_2", ("chest", 12.0, (0.15, 0.3, 0.25), (0, 0, 0.1), _box_collision(0.15, 0.3, 0.25, origin=(0, 0, 0.1))), (0, 0, 0.1), (0, 0, 1))

    # --- arms: 4 DoF each (shoulder 3 + elbow) ---
    for side, sy in (("l", 1.0), ("r", -1.0)):
        add(f"{side}_shoulder_pitch", "chest", (f"{side}_upper_arm_1", 0.8, (0.06, 0.06, 0.1), (0, 0, -0.05), ""), (0, sy * 0.18, 0.2), (0, 1, 0))
        add(f"{side}_shoulder_roll", f"{side}_upper_arm_1", (f"{side}_upper_arm_2", 0.8, (0.06, 0.06, 0.1), (0, 0, -0.05), ""), (0, 0, 0), (1, 0, 0))
        add(f"{side}_shoulder_yaw", f"{side}_upper_arm_2", (f"{side}_upper_arm", 1.2, (0.06, 0.06, 0.25), (0, 0, -0.12), ""), (0, 0, 0), (0, 0, 1))
        add(f"{side}_elbow", f"{side}_upper_arm", (f"{side}_forearm", 1.0, (0.05, 0.05, 0.25), (0, 0, -0.12), _box_collision(0.05, 0.05, 0.25, origin=(0, 0, -0.12))), (0, 0, -0.25), (0, 1, 0))

    # --- legs: 6 DoF each (hip 3 + knee + ankle 2), box-foot collisions ---
    foot_col = _box_collision(0.22, 0.12, 0.05, origin=(0.03, 0, -0.025))
    for side, sy in (("l", 1.0), ("r", -1.0)):
        add(f"{side}_hip_pitch", "pelvis", (f"{side}_hip_1", 1.5, (0.08, 0.08, 0.08), (0, 0, 0), ""), (0, sy * 0.09, -0.08), (0, 1, 0))
        add(f"{side}_hip_roll", f"{side}_hip_1", (f"{side}_hip_2", 1.5, (0.08, 0.08, 0.08), (0, 0, 0), ""), (0, 0, 0), (1, 0, 0))
        add(f"{side}_hip_yaw", f"{side}_hip_2", (f"{side}_thigh", 4.0, (0.1, 0.1, 0.35), (0, 0, -0.17), ""), (0, 0, 0), (0, 0, 1))
        add(f"{side}_knee", f"{side}_thigh", (f"{side}_shin", 2.5, (0.08, 0.08, 0.35), (0, 0, -0.17), ""), (0, 0, -0.35), (0, 1, 0), lo=-2.8, hi=0.1)
        add(f"{side}_ankle_pitch", f"{side}_shin", (f"{side}_ankle_1", 0.7, (0.06, 0.06, 0.06), (0, 0, 0), ""), (0, 0, -0.35), (0, 1, 0))
        add(f"{side}_ankle_roll", f"{side}_ankle_1", (f"{side}_foot", 1.5, (0.22, 0.12, 0.05), (0.03, 0, -0.025), foot_col), (0, 0, -0.05), (1, 0, 0))

    # Sole frames for each foot.
    for side in ("l", "r"):
        parts.append(
            _joint(f"{side}_sole_fixed", "fixed", f"{side}_foot", f"{side}_sole", xyz=(0.03, 0, -0.04))
        )
        parts.append(f'  <link name="{side}_sole"/>')

    body = "".join(parts)
    return f'<robot name="{name}">\n{body}\n</robot>'


def build_quadruped_urdf(name: str = "quadruped12") -> str:
    """Floating-base quadruped with the standard 12-DoF layout (Go2/ANYmal
    class): per leg, hip abduction (roll, x), hip pitch (y), knee pitch (y).
    13 links; box feet give 8 collision points per leg plus 8 trunk corners
    (40 total), fewer than the humanoid's 48, so the fused hot path covers
    it directly.

    Covers the "floating-base legged robot" category of upstream jaxsim's
    test zoo (which uses ErgoCub; the zoo here is programmatic) and adds a
    second locomotion model family next to :func:`build_humanoid_urdf`.
    """
    parts = []
    # Trunk: floating base, Go2-ish scale.
    parts.append(
        _link(
            "trunk",
            10.0,
            _box_inertia(10.0, 0.38, 0.19, 0.11),
            collision=_box_collision(0.38, 0.19, 0.11),
        )
    )

    foot_col = _box_collision(0.05, 0.04, 0.03, origin=(0.0, 0.0, -0.215))
    # (front/rear, left/right) hip attachment offsets on the trunk.
    for prefix, sx, sy in (
        ("fl", 1.0, 1.0),
        ("fr", 1.0, -1.0),
        ("rl", -1.0, 1.0),
        ("rr", -1.0, -1.0),
    ):
        hip = f"{prefix}_hip"
        thigh = f"{prefix}_thigh"
        calf = f"{prefix}_calf"
        # Hip abduction/adduction about +x.
        parts.append(
            _joint(
                f"{prefix}_hip_roll",
                "revolute",
                "trunk",
                hip,
                xyz=(sx * 0.17, sy * 0.06, 0.0),
                axis=(1, 0, 0),
                lower=-0.8,
                upper=0.8,
                damping=0.1,
                effort=35.0,
                velocity=20.0,
            )
        )
        parts.append(_link(hip, 0.7, _cylinder_inertia(0.7, 0.035, 0.08)))
        # Hip flexion/extension about +y; thigh hangs along -z.
        parts.append(
            _joint(
                f"{prefix}_hip_pitch",
                "revolute",
                hip,
                thigh,
                xyz=(0.0, sy * 0.055, 0.0),
                axis=(0, 1, 0),
                lower=-1.6,
                upper=2.6,
                damping=0.1,
                effort=35.0,
                velocity=20.0,
            )
        )
        parts.append(
            _link(thigh, 1.1, _box_inertia(1.1, 0.04, 0.04, 0.21), com=(0, 0, -0.105))
        )
        # Knee about +y; calf carries the box foot collision at its tip.
        parts.append(
            _joint(
                f"{prefix}_knee",
                "revolute",
                thigh,
                calf,
                xyz=(0.0, 0.0, -0.21),
                axis=(0, 1, 0),
                lower=-2.7,
                upper=-0.2,
                damping=0.1,
                effort=45.0,
                velocity=20.0,
            )
        )
        parts.append(
            _link(
                calf,
                0.3,
                _box_inertia(0.3, 0.03, 0.03, 0.21),
                com=(0, 0, -0.105),
                collision=foot_col,
            )
        )
        # Foot frame at the contact patch center.
        parts.append(
            _joint(f"{prefix}_foot_fixed", "fixed", calf, f"{prefix}_foot", xyz=(0, 0, -0.215))
        )
        parts.append(f'  <link name="{prefix}_foot"/>')

    body = "".join(parts)
    return f'<robot name="{name}">\n{body}\n</robot>'


def build_garpez_urdf(
    name: str = "garpez",
    dims: tuple = ((0.2, 0.2, 0.2), (0.15, 0.15, 0.6), (0.1, 0.5, 0.1), (0.3, 0.1, 0.1)),
    densities: tuple = (1000.0, 1000.0, 1000.0, 2000.0),
) -> str:
    """4-link scalable chain used by hardware-parametrization tests
    (box → box → box → box with mixed axes), mirroring the reference's
    'garpez' fixture role (``tests/conftest.py``)."""
    parts = []
    names = ["garpez_base", "garpez_l1", "garpez_l2", "garpez_l3"]
    axes = [(0, 0, 1), (0, 1, 0), (1, 0, 0)]
    prev = None
    for i, (n, d, rho) in enumerate(zip(names, dims, densities, strict=True)):
        x, y, z = d
        mass = rho * x * y * z
        col = _box_collision(x, y, z, origin=(0, 0, z / 2))
        parts_link = _link(n, mass, _box_inertia(mass, x, y, z), com=(0, 0, z / 2), collision=col)
        if prev is not None:
            parts.append(
                _joint(
                    f"garpez_j{i}",
                    "revolute",
                    prev,
                    n,
                    xyz=(0, 0, dims[i - 1][2]),
                    axis=axes[(i - 1) % 3],
                    lower=-3.14,
                    upper=3.14,
                )
            )
        parts.append(parts_link)
        prev = n
    body = "".join(parts)
    return f'<robot name="{name}">\n{body}\n</robot>'
