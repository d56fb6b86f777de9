"""Rough terrain in the port against the JAX package.

The terrain objects (``jaxsim_tpu_torch.terrain``): the Fourier spectrum
drawn from a seed, bit for bit, and the height and analytic normal of a
Fourier terrain and of a plane at seeded points, with and without a per-env
offset of the query. The twin (``BatchedEngine``) on a box resting on a
Fourier terrain and on an inclined plane, with the five per-env domain
multipliers and, on Fourier terrain, ``terrOff``, against the JAX engine on
the same NumPy inputs, in float32 at the tiers of docs/architecture.md and
in float64 to 1e-9: the contact forces and ṁ, one step, and five steps of
``rollout(domain=)`` taken through K1's plain path (``cuda_rollout.rollout``
on a CPU state), the one step through K3's plain path (``cuda_step.step_tau``
on a CPU state). Each start has active points on slopes (n_z < 0.99). The
JAX side is one jitted function per terrain and dtype, the engine's step
jitted on a copy of it so that the rollout's steps reuse its trace.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jaxsim_tpu.api as js
import jaxsim_tpu.terrain as jax_terrain
from jaxsim_tpu.ops.batched_engine import BatchedEngine as JaxEngine
from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState
from jaxsim_tpu_torch import bridge, models, terrain
from jaxsim_tpu_torch.ops import cuda_rollout, cuda_step

torch.set_num_threads(1)

F64 = dict(rtol=1e-9, atol=1e-9)
TIER_C = dict(rtol=1e-3, atol=1e-4)
TIER_T1 = dict(rtol=1e-3, atol=5e-4)  # tier T, per 10 steps
# The terrains of the engine cases: bench.py's rough terrain is
# build(seed=0, 8, 0.04, 0.7); this one is rougher (slopes to n_z ~ 0.6), and
# the plane steep enough that its n_z is 0.94.
FOURIER = dict(seed=5, num_components=3, amplitude=0.05, wavelength=0.6)
PLANE = dict(height=0.05, normal=(0.3, -0.2, 1.0))
B = 16


# ----- the terrain objects -----


@pytest.mark.parametrize("kwargs", [dict(seed=0, num_components=8, amplitude=0.04, wavelength=0.7), FOURIER])
def test_fourier_spectrum_is_the_jax_spectrum(kwargs):
    got = terrain.FourierTerrain.build(**kwargs)
    ref = jax_terrain.FourierTerrain.build(**kwargs)
    assert np.array_equal(got.spectrum(), ref.spectrum())
    assert (got._h0, got._amp, got._kx, got._ky, got._phase) == (ref._h0, ref._amp, ref._kx, ref._ky, ref._phase)


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("kind", ["fourier", "plane"])
def test_height_and_normal_match_jax(kind, offset):
    """64 seeded points in float64, the query translated by a per-point
    offset 10·N(0, 1) (as ``terrOff`` translates it) or not."""
    if kind == "fourier":
        got_t = terrain.FourierTerrain.build(**FOURIER, height=0.02)
        ref_t = jax_terrain.FourierTerrain.build(**FOURIER, height=0.02)
    else:
        got_t, ref_t = terrain.PlaneTerrain.build(**PLANE), jax_terrain.PlaneTerrain.build(**PLANE)
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-2.0, 2.0, (2, 64))
    if offset:
        ox, oy = 10.0 * rng.standard_normal((2, 64))
        x, y = x - ox, y - oy
    with jax.enable_x64(True):
        h_ref, n_ref = np.asarray(ref_t.height(x, y)), np.asarray(ref_t.normal(x, y))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(got_t.height(tx, ty).numpy(), h_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_t.normal(tx, ty).numpy(), n_ref, rtol=1e-12, atol=1e-12)
    if kind == "fourier":
        assert (n_ref[:, 2] < 0.99).mean() > 0.5  # the points sample its slopes


# ----- the twin on rough terrain against the JAX engine -----


def _jax_terrain(kind: str):
    return jax_terrain.FourierTerrain.build(**FOURIER) if kind == "fourier" else jax_terrain.PlaneTerrain.build(**PLANE)


@functools.lru_cache(maxsize=None)
def _params(kind: str, x64: bool) -> dict[str, np.ndarray]:
    """The JAX engine's own arrays in float64 or float32, which its
    ``rollout`` reads: the port's engine takes the same."""
    with jax.enable_x64(x64):
        return bridge.reference_engine_arrays(_case(kind)[0])[1]


@functools.lru_cache(maxsize=None)
def _case(kind: str):
    """(JAX engine, its static fields and arrays, start arrays, domain
    arrays): a box resting on the terrain, each env at its own place and
    (Fourier) its own offset 10·N(0, 1), 5 mm into the ground at the base,
    moving, with the five multipliers exp(0.3 N), exp(0.3 N), exp(0.2 N),
    exp(0.05 N), exp(0.1 N) and (Fourier) terrOff."""
    terr = _jax_terrain(kind)
    jeng = JaxEngine.build(js.JaxSimModel.build_from_model_description(models.build_box_urdf(), terrain=terr))
    static, params = bridge.reference_engine_arrays(jeng)
    rng = np.random.default_rng(11)
    st = bridge.state_to_numpy(bridge.engine_from_numpy(static, params, device="cpu").init_state(B))
    st["p"] = 0.2 * rng.standard_normal((3, B))
    st["v"] = 0.3 * rng.standard_normal((6, B))
    st["m"] = 1e-3 * rng.standard_normal(st["m"].shape)
    domain = dict(
        Kmul=np.exp(0.3 * rng.standard_normal(B)), Dmul=np.exp(0.3 * rng.standard_normal(B)),
        mumul=np.exp(0.2 * rng.standard_normal(B)), gmul=np.exp(0.05 * rng.standard_normal(B)),
        Mmul=np.exp(0.1 * rng.standard_normal(B)),
    )  # fmt: skip
    x, y = st["p"][0], st["p"][1]
    if kind == "fourier":
        domain["terrOff"] = 10.0 * rng.standard_normal((2, B))
        x, y = x - domain["terrOff"][0], y - domain["terrOff"][1]
    with jax.enable_x64(True):
        st["p"][2] = np.asarray(terr.height(x, y)) + 0.045  # the box's half height is 0.05
    return jeng, static, params, st, domain


@functools.lru_cache(maxsize=None)
def _reference(kind: str, x64: bool):
    """The JAX engine on the case's inputs, one compile: the contact forces
    and ṁ with the domain, one step with it, and five steps of
    ``rollout(domain=)``."""
    import dataclasses

    jeng, _, _, st, domain = _case(kind)
    eng = dataclasses.replace(jeng)
    object.__setattr__(eng, "step", jax.jit(eng.step))
    params = _params(kind, x64)
    with jax.enable_x64(x64):
        dtype = jnp.float64 if x64 else jnp.float32
        pr = {k: jnp.asarray(a, dtype) for k, a in params.items()}
        dom = {k: jnp.asarray(a, dtype) for k, a in domain.items()}

        def run(st, pr, dom):
            prd = {**pr, **dom}
            return dict(
                contacts=eng.soft_contact_forces(*eng.fk(st, pr), st.m, prd),
                step=eng.step(st, jnp.zeros((0, B), dtype), prd),
                rollout=eng.rollout(st, 5, domain=dom),
            )

        out = jax.jit(run)(JaxState(**{k: jnp.asarray(a, dtype) for k, a in st.items()}), pr, dom)
        return jax.tree.map(np.asarray, out)


def _engine(kind: str, dtype):
    static = _case(kind)[1]
    return bridge.engine_from_numpy(static, _params(kind, dtype == torch.float64), device="cpu", dtype=dtype)


def _close(got: dict, ref: dict, tol, what):
    for k in bridge.STATE_FIELDS:
        if ref[k].size:
            np.testing.assert_allclose(got[k], ref[k], err_msg=f"{what}: {k}", **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["fourier", "plane"])
def test_twin_matches_jax_engine(kind, dtype):
    x64 = dtype == torch.float64
    _, _, _, arrays, domain = _case(kind)
    ref = _reference(kind, x64)
    teng = _engine(kind, dtype)
    st = bridge.state_from_numpy(arrays, device="cpu", dtype=dtype)
    dom = bridge.domain_from_numpy(domain, device="cpu", dtype=dtype)
    pr = teng.params(dom)

    # The start: points in contact on slopes (n_z < 0.99, from the law's own
    # normal: the terrain's at each point, with the env's offset).
    W = teng.fk(st)
    Rp = torch.stack([W[0][i] for i in teng.contact_parent], 2)
    pc = (Rp * teng.cpoint.transpose(0, 1)[None, :, :, None]).sum(1) + torch.stack(
        [W[1][i] for i in teng.contact_parent], 1)  # fmt: skip
    if kind == "fourier":
        h, dhx, dhy = teng._fourier_height_grad(pr, pc[0], pc[1])
        active, nz = h > pc[2], 1.0 / torch.sqrt(dhx * dhx + dhy * dhy + 1.0)
    else:
        n = torch.tensor(teng.terrain_normal, dtype=dtype)
        active, nz = teng.terrain_offset > (n[:, None, None] * pc).sum(0), n[2].expand(pc[0].shape)
    assert int(active.sum()) >= B and int((active & (nz < 0.99)).sum()) >= B // 2

    f_links, md = teng.soft_contact_forces(*W, st.m, pr)
    tol_c = F64 if x64 else TIER_C
    np.testing.assert_allclose(f_links[0].numpy(), ref["contacts"][0][0], err_msg="f_links", **tol_c)
    np.testing.assert_allclose(md.numpy(), ref["contacts"][1], err_msg="m_dot", **tol_c)
    assert np.abs(ref["contacts"][1]).max() > 0

    with torch.no_grad():
        one = bridge.state_to_numpy(cuda_step.step_tau(teng, st, torch.zeros(0, B, dtype=dtype), dom))
        terr_off = dom.pop("terrOff", None)
        five = bridge.state_to_numpy(cuda_rollout.rollout(teng, st, 5, domain=dom, terr_off=terr_off))
        bare = bridge.state_to_numpy(teng.step(st, torch.zeros(0, B, dtype=dtype)))
    _close(one, bridge.reference_state_arrays(ref["step"]), F64 if x64 else TIER_T1, "K3 plain, one step")
    _close(five, bridge.reference_state_arrays(ref["rollout"]), F64 if x64 else TIER_T1, "K1 plain, 5 steps")
    # The per-env options move the step: without them it is another state.
    assert np.abs(one["v"] - bare["v"]).max() > 1e-3
