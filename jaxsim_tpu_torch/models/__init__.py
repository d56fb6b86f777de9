from .builders import (
    build_arm_urdf,
    build_box_urdf,
    build_cartpole_urdf,
    build_garpez_urdf,
    build_humanoid_urdf,
    build_pendulum_urdf,
    build_quadruped_urdf,
    build_sphere_urdf,
)
