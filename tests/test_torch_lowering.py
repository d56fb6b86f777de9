"""The port's URDF → BatchedEngine lowering against the JAX package's.

Both packages parse the same URDF string; the port's engine must carry the
same topology exactly (parent array, joint types, contact order) and the
same model arrays to float32 roundoff (atol 1e-6: both freeze the parsed
float64 description to float32 before computing the spatial inertias).
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

import jaxsim_tpu.api as js
from jaxsim_tpu import models as jax_models
from jaxsim_tpu.ops.batched_engine import BatchedEngine as JaxEngine
from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, bridge, models
from jaxsim_tpu_torch.api.contact import estimate_good_contact_parameters

torch.set_num_threads(1)

# bench.py's contact-parameter arguments for the flagship humanoid.
BENCH_CONTACT_ARGS = dict(
    number_of_active_collidable_points_steady_state=8,
    max_penetration=0.006,
    damping_ratio=0.15,
)

def _lumped_chain_urdf() -> str:
    """A floating chain whose middle link hangs on a FIXED joint, carries
    mass and a collision box: reduction lumps it into its parent, re-poses
    the joint below it and moves its collidable points onto the parent."""
    from jaxsim_tpu_torch.models.builders import _box_collision, _box_inertia, _joint, _link

    return (
        '<robot name="lumped">'
        + _link("base", 2.0, _box_inertia(2.0, 0.2, 0.2, 0.1), collision=_box_collision(0.2, 0.2, 0.1))
        + _joint("j1", "revolute", "base", "l1", xyz=(0, 0, 0.1), axis=(0, 1, 0))
        + _link("l1", 1.0, _box_inertia(1.0, 0.05, 0.05, 0.3), com=(0, 0, 0.15))
        + _joint("weld", "fixed", "l1", "l2", xyz=(0.02, 0, 0.3), rpy=(0.3, 0, 0.2))
        + _link("l2", 0.5, _box_inertia(0.5, 0.1, 0.1, 0.1), com=(0, 0.01, 0.05),
                collision=_box_collision(0.1, 0.1, 0.1, origin=(0, 0, 0.05)))
        + _joint("j2", "prismatic", "l2", "l3", xyz=(0, 0, 0.1), axis=(1, 0, 0))
        + _link("l3", 0.3, _box_inertia(0.3, 0.05, 0.05, 0.05))
        + "</robot>"
    )


MODELS = {
    "lumped_chain": _lumped_chain_urdf,
    "box": lambda: models.build_box_urdf(),
    "sphere8": lambda: models.build_sphere_urdf(),
    "pendulum1": lambda: models.build_pendulum_urdf(1),
    "pendulum2": lambda: models.build_pendulum_urdf(2),
    "arm6": lambda: models.build_arm_urdf(6),
    "humanoid23": lambda: models.build_humanoid_urdf(),
}


def _both(urdf: str, contact_args: dict | None = None):
    """(JAX engine, port engine) from one URDF string."""
    jm = js.JaxSimModel.build_from_model_description(urdf)
    tm = JaxSimModel.build_from_model_description(urdf)
    if contact_args is not None:
        jm = jm.replace(
            contact_params=js.contact.estimate_good_contact_parameters(jm, **contact_args)
        )
        tm = tm.replace(contact_params=estimate_good_contact_parameters(tm, **contact_args))
    return JaxEngine.build(jm), BatchedEngine.build(tm, device="cpu")


def _assert_same_engine(jeng, teng, scalar_rtol):
    static, params = bridge.reference_engine_arrays(jeng)
    for name in ("n_links", "n_joints", "n_points", "floating_base"):
        assert getattr(teng, name) == static[name], name
    for name in ("lam", "joint_types", "contact_parent"):
        assert tuple(getattr(teng, name)) == tuple(static[name]), name
    for name in ("K", "D", "mu", "hc_p", "hc_q", "gravity_z", "dt"):
        np.testing.assert_allclose(getattr(teng, name), static[name], rtol=scalar_rtol, err_msg=name)
    for name, ref in params.items():
        got = getattr(teng, name).numpy()
        if ref.size == 0:  # the JAX engine stores an empty axis array as (0,)
            assert got.size == 0, name
            continue
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_lowering_matches_jax(name, monkeypatch):
    # Eight points per sphere, so the sphere case stays small.
    monkeypatch.setenv("JAXSIM_COLLISION_SPHERE_POINTS", "8")
    jeng, teng = _both(MODELS[name]())
    _assert_same_engine(jeng, teng, scalar_rtol=1e-6)


def test_lumped_chain_reduces_the_fixed_joint():
    jeng, teng = _both(_lumped_chain_urdf())
    assert (teng.n_links, teng.n_joints, teng.n_points) == (3, 2, 16)
    assert teng.joint_types == (0, 1, 2)


def test_humanoid_bench_contact_parameters():
    """The flagship lowering with bench.py's contact estimation: 24 links
    after lumping the sole frames, 48 points in the JAX contact order."""
    jeng, teng = _both(models.build_humanoid_urdf(), BENCH_CONTACT_ARGS)
    assert (teng.n_links, teng.n_joints, teng.n_points) == (24, 23, 48)
    _assert_same_engine(jeng, teng, scalar_rtol=1e-6)
    # The bridge builds the same engine from the JAX engine's arrays.
    beng = bridge.engine_from_numpy(*bridge.reference_engine_arrays(jeng), device="cpu")
    for name, t in teng.params().items():
        assert torch.equal(getattr(beng, name), t), name


_BUILDERS = sorted(
    name for name, fn in inspect.getmembers(models.builders, inspect.isfunction)
    if name.startswith("build_")
)


@pytest.mark.parametrize("builder", _BUILDERS)
def test_builders_give_the_same_urdf(builder):
    assert getattr(models, builder)() == getattr(jax_models, builder)()


def test_unsupported_configurations_raise():
    static, params = bridge.reference_engine_arrays(
        JaxEngine.build(js.JaxSimModel.build_from_model_description(models.build_box_urdf()))
    )
    for key, value in (("integrator", "euler"), ("contact_model", "rigid"), ("terrain_kind", "heightmap")):
        with pytest.raises(ValueError, match=key):
            bridge.engine_from_numpy({**static, key: value}, params, device="cpu")
