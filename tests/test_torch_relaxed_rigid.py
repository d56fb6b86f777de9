"""Relaxed-rigid contacts in the port against the JAX package's.

The lowering (``BatchedEngine.build`` of a model with
``RelaxedRigidContacts()``), the articulated substitution passes
(``_minv_apply``), the matrix-free PCG's solved forces and the
contact-coupled accelerations (``relaxed_rigid_contact_forces``), and the
twin's relaxed-rigid step, on the same NumPy inputs as the JAX engine's:
in float32 at the JAX package's own tolerances for these set-ups
(``tests/test_batched_engine.py:938-1037``) and in float64 to 1e-9. Then
what the kernels' wrappers take: K1's relaxed-rigid kernel (``rollout_rr.cu``: its generated
header, slots and level schedule, and what it refuses), K2, K3 and K5 taking
a relaxed-rigid engine to their relaxed-rigid builds (RK4 refused), and K4
refusing it. Tests marked ``gpu`` hold K1's relaxed-rigid kernel
against the twin on the card and skip without one; they import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_relaxed_rigid.py
"""

from __future__ import annotations

import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, bridge, models
from jaxsim_tpu_torch.ops import cuda_build, cuda_env_rollout, cuda_rollout, cuda_step, cuda_step_vjp
from jaxsim_tpu_torch.ops.contacts.relaxed_rigid import RelaxedRigidContacts, RelaxedRigidContactsParams

torch.set_num_threads(1)

F64 = dict(rtol=1e-9, atol=1e-9)
# The JAX package's tolerances for a relaxed-rigid box (B = 4, 5 steps,
# tests/test_batched_engine.py:966-973) and a tilted garpez (:1018-1022),
# and for the solved forces m (not compared there) 1e-3 relative to the
# largest force.
BOX_TOL = dict(p=dict(rtol=1e-3, atol=1e-5), q=dict(rtol=1e-3, atol=1e-5), v=dict(rtol=2e-3, atol=2e-4))
GARPEZ_TOL = dict(p=dict(rtol=1e-3, atol=1e-4), s=dict(rtol=1e-3, atol=1e-4), sd=dict(rtol=1e-2, atol=1e-2))
M_RTOL = 1e-3

URDFS = dict(box=models.build_box_urdf, garpez=models.build_garpez_urdf, humanoid23=models.build_humanoid_urdf)


@functools.lru_cache(maxsize=None)
def _jax_engine(name, rr_iterations=0):
    import jaxsim_tpu.api as js
    from jaxsim_tpu.ops.batched_engine import BatchedEngine as JaxEngine
    from jaxsim_tpu.ops.contacts.relaxed_rigid import RelaxedRigidContacts as JaxRelaxedRigid

    model = js.JaxSimModel.build_from_model_description(URDFS[name](), contact_model=JaxRelaxedRigid())
    eng = JaxEngine.build(model)
    return dataclasses.replace(eng, rr_iterations=rr_iterations) if rr_iterations else eng


def _port_engine(jeng, dtype=torch.float32) -> BatchedEngine:
    return bridge.engine_from_numpy(*bridge.reference_engine_arrays(jeng), device="cpu", dtype=dtype)


def _box_arrays(B=4, seed=0):
    """The set-up of the JAX box test, 0.03 m lower so that most envs start
    in contact: base 0.05 + 0.02·N(0, 1) m up (the box's half-height is
    0.05 m), linear and angular velocities 0.1·N(0, 1)."""
    rng = np.random.default_rng(seed)
    p = np.array([0.0, 0.0, 0.05])[:, None] + 0.02 * rng.standard_normal((3, B))
    return dict(
        s=np.zeros((0, B)),
        sd=np.zeros((0, B)),
        p=p,
        q=np.tile(np.array([1.0, 0.0, 0.0, 0.0])[:, None], (1, B)),
        v=0.1 * rng.standard_normal((6, B)),
        m=np.zeros((8, 3, B)),
    )


def _garpez_arrays(n_joints, B=4, seed=0):
    """The tilted low base of the JAX garpez test: two corners in definite
    penetration from step 0; joints 0.05·N(0, 1) rad."""
    rng = np.random.default_rng(seed)
    return dict(
        s=0.05 * rng.standard_normal((n_joints, B)),
        sd=np.zeros((n_joints, B)),
        p=np.tile(np.array([0.0, 0.0, 0.015])[:, None], (1, B)),
        q=np.tile(np.array([0.995, 0.0998, 0.0, 0.0])[:, None], (1, B)),
        v=np.zeros((6, B)),
        m=np.zeros((32, 3, B)),
    )


def _tau_fn(name):
    """The torques of a case, as a function of (s, sd): none for the box,
    the JAX garpez test's PD law for garpez."""
    return (lambda s, sd: 0.0 * s) if name == "box" else (lambda s, sd: -20.0 * s - 0.1 * sd)


def _case(name):
    """(JAX engine, state arrays, torques as a function of (s, sd))."""
    jeng = _jax_engine(name)
    arrays = _box_arrays() if name == "box" else _garpez_arrays(jeng.n_joints)
    return jeng, arrays, _tau_fn(name)


@functools.lru_cache(maxsize=None)
def _jax_step(name, rr_iterations, x64):
    """The jitted JAX engine step of a case (one compile per case and dtype)."""
    import jax
    import jax.numpy as jnp

    jeng, tau_fn = _jax_engine(name, rr_iterations), _tau_fn(name)
    _, params = bridge.reference_engine_arrays(jeng)
    with jax.enable_x64(x64):
        pr = {k: jnp.asarray(a, jnp.float64 if x64 else jnp.float32) for k, a in params.items()}
    return jax.jit(lambda st: jeng.step(st, tau_fn(st.s, st.sd), pr))


def _jax_steps(name, arrays, n_steps, x64, rr_iterations=0):
    """States after each of ``n_steps`` JAX engine steps, as NumPy."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    step = _jax_step(name, rr_iterations, x64)
    with jax.enable_x64(x64):
        dtype = jnp.float64 if x64 else jnp.float32
        st = JaxState(**{k: jnp.asarray(a, dtype) for k, a in arrays.items()})
        out = []
        for _ in range(n_steps):
            st = step(st)
            out.append(bridge.reference_state_arrays(st))
    return out


def _port_steps(teng, arrays, tau_fn, n_steps):
    st = bridge.state_from_numpy(arrays, device="cpu", dtype=teng.S.dtype)
    out = []
    for _ in range(n_steps):
        st = teng.step(st, tau_fn(st.s, st.sd))
        out.append(bridge.state_to_numpy(st))
    return out


def _active_points(teng, arrays) -> int:
    st = bridge.state_from_numpy(arrays, device="cpu", dtype=teng.S.dtype)
    return int(teng._point_geometry(*teng.fk(st), teng.params())["active"].sum())


# ----- the lowering -----


@pytest.mark.parametrize("name", sorted(URDFS))
def test_lowering_matches_jax(name):
    """``BatchedEngine.build`` of a relaxed-rigid model against the JAX
    build: the resolved scalars, ``rrMinv`` and the PCG budget, to 1e-6."""
    jeng = _jax_engine(name)
    teng = BatchedEngine.build(
        JaxSimModel.build_from_model_description(URDFS[name](), contact_model=RelaxedRigidContacts()), device="cpu"
    )
    static, params = bridge.reference_engine_arrays(jeng)
    assert teng.contact_model == static["contact_model"] == "relaxed_rigid"
    for key in (*bridge.RR_FIELDS, "mu", "K", "D", "dt", "gravity_z"):
        np.testing.assert_allclose(getattr(teng, key), static[key], rtol=1e-6, atol=0, err_msg=key)
    assert teng.PARAM_NAMES == BatchedEngine.RR_PARAM_NAMES
    np.testing.assert_allclose(teng.rrMinv.numpy(), params["rrMinv"], rtol=0, atol=1e-6)
    assert teng._rr_n_iter == jeng._rr_n_iter == min(teng.n_points // 4 + 6, 8)


def test_relaxed_rigid_parameters():
    """The defaults, frozen to float32 as the JAX package's; ``build`` keeps
    the fields it is given; ``valid``."""
    p = RelaxedRigidContactsParams()
    assert p.mu == np.float32(0.005) and p.d_max == np.float32(0.95) and p.valid()
    q = RelaxedRigidContactsParams.build(mu=0.5, time_constant=None, unknown=3)
    assert q.mu == np.float32(0.5) and q.time_constant == p.time_constant
    assert not RelaxedRigidContactsParams.build(d_min=0.99).valid()
    model = JaxSimModel.build_from_model_description(models.build_box_urdf(), contact_model=RelaxedRigidContacts())
    assert model.contact_params == RelaxedRigidContactsParams()


def test_rr_iterations_override_the_budget():
    """``rr_iterations`` fixes the PCG's iterations in the twin, as in the
    JAX engine, and in the kernel's generated header."""
    jeng = _jax_engine("garpez", rr_iterations=3)
    teng = _port_engine(jeng)
    assert teng._rr_n_iter == jeng._rr_n_iter == 3
    assert "#define JX_RR_ITERS 3\n" in cuda_build.topology_header(teng)
    arrays, tau_fn = _garpez_arrays(jeng.n_joints), _tau_fn("garpez")
    got = _port_steps(teng, arrays, tau_fn, 1)[0]
    ref = _jax_steps("garpez", arrays, 1, x64=False, rr_iterations=3)[0]
    np.testing.assert_allclose(got["m"], ref["m"], rtol=M_RTOL, atol=M_RTOL * np.abs(ref["m"]).max())
    default = _port_steps(_port_engine(_jax_engine("garpez")), arrays, tau_fn, 1)[0]
    assert np.abs(default["m"] - got["m"]).max() > 1e-3 * np.abs(got["m"]).max()


# ----- the solve's pieces, float64 -----


def _garpez_random_state(n_joints, B=8, seed=1):
    """A garpez state low enough that points touch, joints displaced and
    moving, the base moving, previous forces in m for half the points."""
    rng = np.random.default_rng(seed)
    arrays = _garpez_arrays(n_joints, B, seed)
    arrays["sd"] = 0.5 * rng.standard_normal(arrays["sd"].shape)
    arrays["v"] = 0.2 * rng.standard_normal((6, B))
    arrays["m"][:16] = 50.0 * rng.standard_normal((16, 3, B))
    return arrays


def test_minv_apply_and_pcg_match_jax_in_float64():
    """At a garpez state with active points: the factorization's M⁻¹Jᵀ
    passes on random link forces, and the PCG's solved forces and
    contact-coupled accelerations, against the JAX engine's, to 1e-10."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    jeng = _jax_engine("garpez")
    teng = _port_engine(jeng, torch.float64)
    arrays = _garpez_random_state(jeng.n_joints)
    B = arrays["p"].shape[-1]
    assert _active_points(teng, arrays) > 0
    rng = np.random.default_rng(2)
    f_loc = [None if i == 2 else rng.standard_normal((6, B)) for i in range(teng.n_links)]
    tau = 3.0 * rng.standard_normal((teng.n_joints, B))
    _, params = bridge.reference_engine_arrays(jeng)
    # The free ABA jitted on a copy of the engine: the solve's own call of it
    # (the same arguments) reuses the reference's trace.
    eng = dataclasses.replace(jeng)
    object.__setattr__(eng, "aba", jax.jit(eng.aba, static_argnames=("return_aux",)))
    with jax.enable_x64(True):
        pr = {k: jnp.asarray(a, jnp.float64) for k, a in params.items()}
        st = JaxState(**{k: jnp.asarray(a, jnp.float64) for k, a in arrays.items()})
        tj = jnp.asarray(tau)

        @jax.jit
        def reference(st):
            W_R, W_p, W_v = eng.fk(st, pr)
            _, _, fact = eng.aba(st, W_R, W_p, W_v, [None] * eng.n_links, tj, pr, return_aux=True)
            fl = [None if f is None else jnp.asarray(f) for f in f_loc]
            a, sdd = eng._minv_apply(fact, fl, st.p.shape[1:], pr)
            _, (W_a, sdd_c), xs = eng.relaxed_rigid_contact_forces(st, W_R, W_p, W_v, tj, pr, return_accelerations=True)
            return jnp.stack(a), sdd, W_a, sdd_c, xs

        ref = [np.asarray(x) for x in reference(st)]

    ts = bridge.state_from_numpy(arrays, device="cpu", dtype=torch.float64)
    tt = torch.from_numpy(tau)
    pr = teng.params()
    W_R, W_p, W_v = teng.fk(ts, pr)
    _, _, fact = teng.aba(ts, W_R, W_p, W_v, [None] * teng.n_links, tt, pr, return_aux=True)
    a, sdd = teng._minv_apply(fact, [None if f is None else torch.from_numpy(f) for f in f_loc], pr)
    W_a, sdd_c, xs = teng.relaxed_rigid_contact_forces(ts, W_R, W_p, W_v, tt, pr)
    got = [torch.stack(a).numpy(), sdd.numpy(), W_a.numpy(), sdd_c.numpy(), xs.numpy()]
    for what, g, r in zip(("M⁻¹Jᵀ link accelerations", "M⁻¹Jᵀ joint accelerations", "W_a", "sdd", "xs"), got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-10, atol=1e-10 * max(1.0, np.abs(r).max()), err_msg=what)


# ----- the step -----


@pytest.mark.parametrize("n_steps", [1, 5])
@pytest.mark.parametrize("name", ["box", "garpez"])
def test_step_matches_jax_float32(name, n_steps):
    """The float32 twin against the JAX engine's step on the same (float32)
    inputs, at the JAX package's float32 tolerances. The reference is the
    JAX step in float64, the compiled step of ``test_step_matches_jax_float64``
    (one trace and compile a model for both tests)."""
    jeng, arrays, tau_fn = _case(name)
    teng = _port_engine(jeng)
    assert _active_points(teng, arrays) > 0
    got = _port_steps(teng, arrays, tau_fn, n_steps)[-1]
    inputs = {k: np.asarray(a, np.float32).astype(np.float64) for k, a in arrays.items()}
    ref = _jax_steps(name, inputs, n_steps, x64=True)[-1]
    for k, tol in (BOX_TOL if name == "box" else GARPEZ_TOL).items():
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)
    assert np.abs(ref["m"]).max() > 0
    np.testing.assert_allclose(got["m"], ref["m"], rtol=M_RTOL, atol=M_RTOL * np.abs(ref["m"]).max(), err_msg="m")


@pytest.mark.parametrize("name", ["box", "garpez"])
def test_step_matches_jax_float64(name):
    """Five steps in float64: every state field after each step to 1e-9."""
    jeng, arrays, tau_fn = _case(name)
    got = _port_steps(_port_engine(jeng, torch.float64), arrays, tau_fn, 5)
    ref = _jax_steps(name, arrays, 5, x64=True)
    for t, (g, r) in enumerate(zip(got, ref)):
        for k in bridge.STATE_FIELDS:
            np.testing.assert_allclose(g[k], r[k], err_msg=f"{k} after step {t + 1}", **F64)


def test_box_settles_on_the_plane():
    """The JAX package's settling test: a box dropped from 0.12 m on
    relaxed-rigid contacts, with the automatic iteration budget, rests on
    the plane after 300 steps."""
    teng = _port_engine(_jax_engine("box"))
    out = teng.rollout(teng.init_state(2, base_position=(0.0, 0.0, 0.12)), 300, policy=lambda st: torch.zeros_like(st.s))
    assert torch.all(out.p[2] > 0.040) and torch.all(out.p[2] < 0.055)
    assert torch.all(out.v.abs() < 0.05)


def test_step_refuses_autograd():
    """The relaxed-rigid step no longer refuses inputs that require grad: it
    differentiates its solve implicitly (``_PcgImplicit``; held against
    ``jax.vjp`` in ``test_torch_rr_autograd.py``). Under autograd its
    forward is the plain step's to the bit, and the gradients with respect
    to v, m and M are finite; v's and M's are nonzero, m's reaches only
    the warm start and is zero, as JAX's."""
    teng = _port_engine(_jax_engine("garpez"))
    arrays = _garpez_random_state(teng.n_joints)
    with torch.no_grad():
        plain = teng.step(bridge.state_from_numpy(arrays, device="cpu"))
    st = bridge.state_from_numpy(arrays, device="cpu")
    st.v.requires_grad_()
    st.m.requires_grad_()
    pr = {"M": teng.M.clone().requires_grad_()}
    out = teng.step(st, pr=pr)
    for a, b in zip(out.fields(), plain.fields()):
        assert torch.equal(a.detach(), b)
    loss = (out.sd**2).sum() + out.p[2].sum() + (out.m**2).sum()
    g_v, g_m, g_M = torch.autograd.grad(loss, [st.v, st.m, pr["M"]])
    for g in (g_v, g_m, g_M):
        assert bool(torch.isfinite(g).all())
    assert float(g_v.abs().max()) > 0 and float(g_M.abs().max()) > 0
    assert float(g_m.abs().max()) <= 1e-6 * float((out.m.detach() ** 2).sum().sqrt() + 1.0)


# ----- what the kernels take -----


def _humanoid_rr(device="cpu"):
    return BatchedEngine.build(
        JaxSimModel.build_from_model_description(models.build_humanoid_urdf(), contact_model=RelaxedRigidContacts()),
        device=device,
    )


def test_kernel_inputs_for_the_relaxed_rigid_humanoid():
    """K1's relaxed-rigid build: the header names the contact model and the
    PCG's iterations, the packed arrays end with rrMinv (9,684 B in all), and
    the scalars carry the constants folded in double."""
    eng = _humanoid_rr()
    header = cuda_build.topology_header(eng)
    assert "#define JX_CONTACT 1\n" in header and "#define JX_RR_ITERS 8\n" in header
    soft = cuda_build.topology_header(BatchedEngine.build(JaxSimModel.build_from_model_description(models.build_pendulum_urdf(1)), device="cpu"))
    assert "#define JX_CONTACT 0\n" in soft and "#define JX_RR_ITERS 0\n" in soft
    params = cuda_build.packed_params(eng)
    assert params.numel() * 4 == 9684
    assert torch.equal(params[-eng.rrMinv.numel() :], eng.rrMinv.reshape(-1))
    rr = cuda_build.rr_scalars(eng)
    assert len(rr) == 13 and rr[:4] == (2.0, 2.0, eng.rr_midpoint, 2.0) and rr[-1] == 1e-6
    assert cuda_build.engine_scalars(eng)[2] == 0.0  # K/D of an engine with D = 0


def _header_tables(header: str) -> tuple[dict[str, int], dict[str, list[int]]]:
    defines = {k: int(v) for k, v in re.findall(r"^#define (\w+) (-?\d+)$", header, re.M)}
    arrays = {k: [int(x) for x in v.split(", ")] for k, v in re.findall(r"__constant__ int (\w+)\[\d+\] = \{([^}]*)\};", header)}
    return defines, arrays


@pytest.mark.parametrize("lanes", [1, 4, 8])
@pytest.mark.parametrize("name", ["humanoid23", "garpez", "box"])
def test_relaxed_rigid_kernel_header(name, lanes):
    """The generated header of the relaxed-rigid kernel names the contact
    model, the PCG's iterations and the slot; every contact point has one
    slot, a group of ``lanes`` slots one parent; the level schedule holds
    each link once, a parent on an earlier level than its children, and each
    link's children in descending order; the slots and the model arrays of a
    block fit in its shared memory, the humanoid's 64 envs in one block."""
    eng = BatchedEngine.build(
        JaxSimModel.build_from_model_description(URDFS[name](), contact_model=RelaxedRigidContacts()), device="cpu"
    )
    job = cuda_rollout.job(eng, lanes)
    assert job.source == cuda_rollout.RR_SOURCE and dict(job.defines) == {"JX_RR_LANES": lanes}
    defines, arrays = _header_tables(cuda_build.topology_header(eng, job.defines))
    n_par = len(set(eng.contact_parent))
    assert defines["JX_CONTACT"] == 1 and defines["JX_RR_ITERS"] == eng._rr_n_iter == 8
    assert defines["JX_RR_LANES"] == lanes and defines["JX_RR_NPAR"] == n_par
    assert defines["JX_RR_SLOT"] == 26 * eng.n_links + 36 + 24 * n_par
    own, slots = defines["JX_RR_OWN"], arrays["JX_RR_SLOT_POINT"]
    assert len(slots) == lanes * own and sorted(c for c in slots if c >= 0) == list(range(eng.n_points))
    for k in range(own):
        group = [slots[g + lanes * k] for g in range(lanes)]
        assert {eng.contact_parent[c] for c in group if c >= 0} == {arrays["JX_RR_GROUP_LINK"][k]}
        assert arrays["JX_RR_PAR_LINK"][arrays["JX_RR_GROUP_PAR"][k]] == arrays["JX_RR_GROUP_LINK"][k]
    lev_off, lev_link = arrays["JX_RR_LEV_OFF"], arrays["JX_RR_LEV_LINK"]
    assert len(lev_off) == defines["JX_RR_NLEV"] + 1 and lev_off[-1] == eng.n_links - 1
    level = {i: lev for lev in range(defines["JX_RR_NLEV"]) for i in lev_link[lev_off[lev] : lev_off[lev + 1]]}
    assert sorted(level) == list(range(1, eng.n_links))
    assert all(eng.lam[i] == 0 or level[eng.lam[i]] < level[i] for i in level)
    ch_off, ch = arrays["JX_RR_CH_OFF"], arrays["JX_RR_CH"]
    for i in range(eng.n_links):
        kids = ch[ch_off[i] : ch_off[i + 1]]
        assert kids == sorted((c for c in range(1, eng.n_links) if eng.lam[c] == i), reverse=True)
    tables = cuda_build.rr_tables(eng, lanes)
    assert tables["envs"] == defines["JX_RR_ENVS"] and tables["envs"] * lanes % 32 == 0
    n_params = cuda_build.packed_params(eng).numel()
    assert tables["smem_bytes"] == 4 * (defines["JX_RR_SLOT"] * (tables["envs"] + 1) + n_params)
    assert tables["smem_bytes"] <= cuda_build.MAX_SMEM_BYTES
    if name == "humanoid23":
        assert tables["envs"] == 64 and own * lanes == 48 and defines["JX_RR_NLEV"] == 7


def test_relaxed_rigid_kernel_refuses(monkeypatch):
    """The relaxed-rigid kernel takes relaxed-rigid, float32 engines with
    contact points: a soft engine has no relaxed-rigid header, and the
    wrapper raises on a float64 engine and, for an RK4 engine, on a raised
    plane before any build (the semi-implicit Euler build takes a plane and
    Fourier terrain: tests/test_torch_rough_rr.py); the lanes an env divide a
    warp."""
    monkeypatch.setattr(cuda_build, "is_cpu", lambda state, what: False)
    soft = BatchedEngine.build(JaxSimModel.build_from_model_description(models.build_box_urdf()), device="cpu")
    with pytest.raises(ValueError, match="relaxed-rigid engine"):
        cuda_build.rr_tables(soft, cuda_rollout.RR_LANES)
    assert cuda_rollout.job(soft).source == cuda_rollout.SOURCE
    eng = _port_engine(_jax_engine("box"))
    with pytest.raises(ValueError, match="divide"):
        cuda_build.rr_tables(eng, 3)
    tilted = _port_engine(_jax_engine("box"))
    tilted.terrain_offset = 0.1
    tilted.integrator = "rk4"
    with pytest.raises(ValueError, match="flat ground"):
        cuda_rollout.rollout(tilted, tilted.init_state(4), 1)
    wide = _port_engine(_jax_engine("box"), torch.float64)
    with pytest.raises(ValueError, match="float32"):
        cuda_rollout.rollout(wide, wide.init_state(4), 1)


WRAPPERS = dict(
    step_pd=lambda eng, st: cuda_step.step_pd(eng, st),
    step_tau=lambda eng, st: cuda_step.step_tau(eng, st, torch.zeros_like(st.s)),
    env_rollout=lambda eng, st: cuda_env_rollout.env_rollout(eng, st, 1),
    step_vjp=lambda eng, st: cuda_step_vjp.step_vjp(eng, st, torch.zeros_like(st.s), st),
)


RR_WRAPPERS = ("step_pd", "step_tau", "env_rollout")
RR_SOURCES = dict(step_pd="rollout_rr.cu", step_tau="step_rr.cu", env_rollout="env_rollout_rr.cu")


class _Built(Exception):
    """Raised by a stub of ``cuda_build.build`` with the job it was given."""


def _job_built(call, eng, st, monkeypatch) -> cuda_build.BuildJob:
    """The job a wrapper's ``call(eng, st)`` builds on a state its kernel
    would take, without nvcc: the stub of ``cuda_build.build`` stops it there."""

    def stub(job):
        raise _Built(job)

    monkeypatch.setattr(cuda_build, "is_cpu", lambda state, what: False)
    monkeypatch.setattr(cuda_build, "build", stub)
    with pytest.raises(_Built) as built:
        call(eng, st)
    return built.value.args[0]


def _rr_tape_rows(eng) -> int:
    """K4-rr's tape past the slot, an env (``ROWS - SLOT`` of
    ``step_vjp_rr.cu``), evaluated from the source's constants for ``eng``'s
    sizes."""
    text = (cuda_build.CSRC / "step_vjp_rr.cu").read_text()
    rows = dict(NC=eng.n_points, NL=eng.n_links, SLOT=0)
    for decl in re.findall(r"^constexpr int ([^;]+);", text, re.M):
        for name, expr in re.findall(r"(\w+) = ([^,]+)", decl):
            if re.fullmatch(r"T_\w+|RW|BASE|ROWS", name):
                rows[name] = eval(expr, {}, dict(rows))  # the constants are sums and products of the sizes
    return rows["ROWS"]


@pytest.mark.parametrize("kernel", ["step_vjp"])
def test_soft_only_kernels_refuse_relaxed_rigid(kernel, monkeypatch):
    """K4 takes a relaxed-rigid engine to its relaxed-rigid build, K4-rr: on
    the humanoid's state, with and without ``params_grad``, the wrapper
    builds ``step_vjp_rr.cu``, whose generated header names relaxed-rigid
    contacts, K3-rr's lanes, no torque row (K4-rr reads the torques from
    device memory), K4-rr's rows and blocks of ``RR_ENVS`` envs (12 with
    ``params_grad``, whose warps' rows of model-array cotangents take room
    beside the slots and the model arrays), and whose tape past K3-rr's
    slot takes 3 floats a point, 84
    a link and 43 for the base (about 12 KB an env in shared memory for the
    humanoid, with the slot); the differentiable step and rollouts of
    ``diff_step`` are built and their forward goes to K3-rr. A relaxed-rigid
    engine with RK4 or RK4-fast still raises ValueError before any build."""
    from jaxsim_tpu_torch.api.model import IntegratorType
    from jaxsim_tpu_torch.ops import diff_step

    eng = _humanoid_rr()
    st = eng.init_state(64)
    tau = torch.zeros_like(st.s)
    slot = 26 * eng.n_links + 36 + 24 * len(set(eng.contact_parent))
    rows = _rr_tape_rows(eng)
    assert rows == 3 * eng.n_points + 84 * eng.n_links + 43 and 12_000 < 4 * (slot + rows) < 12_100
    for pg in (False, True):
        job = _job_built(lambda e, s: cuda_step_vjp.step_vjp(e, s, tau, s, params_grad=pg), eng, st, monkeypatch)
        assert job.engine is eng and job.source.name == "step_vjp_rr.cu"
        defines, _ = _header_tables(cuda_build.topology_header(eng, job.defines))
        assert defines["JX_CONTACT"] == 1 and defines["JX_PARAMS_GRAD"] == pg and "JX_RR_TAU_ROW" not in defines
        envs = 12 if pg else cuda_step_vjp.RR_ENVS  # a row of 2,421 floats a warp leaves room for 3 warps
        assert defines["JX_RR_LANES"] == cuda_rollout.RR_LANES and defines["JX_RR_ENVS"] == envs
        assert defines["JX_RR_SLOT"] == slot and defines["JX_RR_ROWS"] == slot + rows
        assert cuda_step_vjp.rr_envs_per_block(eng, pg) == envs
    for call in (lambda e, s: diff_step.fused_diff_step(e)(s, tau),
                 lambda e, s: diff_step.fused_diff_rollout(e, 2)(s, lambda x: tau),
                 lambda e, s: diff_step.fused_diff_step(e, params_grad=True)(s, tau)):  # fmt: skip
        assert _job_built(call, eng, st, monkeypatch).source.name == "step_rr.cu"
    for integrator in (IntegratorType.RungeKutta4, IntegratorType.RungeKutta4Fast):
        model = JaxSimModel.build_from_model_description(
            models.build_garpez_urdf(), contact_model=RelaxedRigidContacts(), integrator=integrator
        )
        rk = BatchedEngine.build(model, device="cpu")
        s = rk.init_state(64)
        with pytest.raises(ValueError, match="semi-implicit Euler"):
            WRAPPERS[kernel](rk, s)


@pytest.mark.parametrize("kernel", RR_WRAPPERS)
def test_kernels_take_relaxed_rigid(kernel, monkeypatch):
    """K2, K3 and K5 take a relaxed-rigid engine to their relaxed-rigid build:
    on the humanoid's state, the wrapper builds K1-rr's ``rollout_rr.cu``
    (K2, launched for one step), ``step_rr.cu`` or ``env_rollout_rr.cu``,
    whose generated header names relaxed-rigid contacts and blocks of 64
    envs, and for K3 and K5 gives the slot a row of torques, for K5 the ES
    main path's MLP with its candidate's weights beside them."""
    eng = _humanoid_rr()
    B = 64
    st = eng.init_state(B)
    if kernel == "env_rollout":
        d, H = 2 * eng.n_joints + 11, 16
        mlp = dict(W1=torch.zeros(1, H, d), b1=torch.zeros(1, H, 1), W2=torch.zeros(1, eng.n_joints, H),
                   b2=torch.zeros(1, eng.n_joints, 1))  # fmt: skip
        job = _job_built(lambda e, s: cuda_env_rollout.env_rollout(e, s, 1, **mlp), eng, st, monkeypatch)
        assert dict(job.defines)["JX_POLICY"] == 2 and dict(job.defines)["JX_HIDDEN"] == H
    else:
        job = _job_built(WRAPPERS[kernel], eng, st, monkeypatch)
    assert job.engine is eng and job.source.name == RR_SOURCES[kernel]
    defines, _ = _header_tables(cuda_build.topology_header(eng, job.defines))
    n_par = len(set(eng.contact_parent))
    tau_row = kernel != "step_pd"
    assert defines["JX_CONTACT"] == 1 and defines["JX_INTEGRATOR"] == 0 and defines.get("JX_RR_TAU_ROW", 0) == tau_row
    assert defines["JX_RR_LANES"] == cuda_rollout.RR_LANES and defines["JX_RR_ENVS"] == 64
    assert defines["JX_RR_SLOT"] == 26 * eng.n_links + 36 + 24 * n_par + tau_row * eng.n_joints


@pytest.mark.parametrize("kernel", RR_WRAPPERS)
def test_kernels_refuse_relaxed_rigid_rk4(kernel, monkeypatch):
    """K2, K3 and K5 implement semi-implicit Euler only: a relaxed-rigid
    engine with RK4 or RK4-fast raises ValueError before any build."""
    from jaxsim_tpu_torch.api.model import IntegratorType

    monkeypatch.setattr(cuda_build, "is_cpu", lambda state, what: False)
    for integrator in (IntegratorType.RungeKutta4, IntegratorType.RungeKutta4Fast):
        model = JaxSimModel.build_from_model_description(
            models.build_garpez_urdf(), contact_model=RelaxedRigidContacts(), integrator=integrator
        )
        eng = BatchedEngine.build(model, device="cpu")
        with pytest.raises(ValueError, match="semi-implicit Euler"):
            WRAPPERS[kernel](eng, eng.init_state(64))


# ----- slow: the JAX fused rollout and the humanoid -----


@pytest.mark.slow
def test_plain_rollout_matches_pallas_rollout_in_interpret_mode():
    """Garpez tilted low, B = 128, 6 PCG iterations, 3 steps: the port's
    rollout on the CPU (K1's plain version) against the JAX fused rollout
    kernel run by the Pallas interpreter, at the JAX package's tolerance for
    its relaxed-rigid kernel test (tests/test_batched_engine.py:1059-1062)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from jaxsim_tpu.ops import pallas_step as ps
    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    jeng = _jax_engine("garpez", rr_iterations=6)
    teng = _port_engine(jeng)
    arrays = {k: a.astype(np.float32) for k, a in _garpez_arrays(jeng.n_joints, B=128).items()}
    policy = lambda st: -60.0 * st.s - 0.5 * st.sd  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        jst = ps.tile_state(JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()}))
        ref = bridge.reference_state_arrays(ps.untile_state(ps.build_pallas_rollout(jeng, 3, policy)(jst)))
    got = bridge.state_to_numpy(cuda_rollout.rollout(teng, bridge.state_from_numpy(arrays, device="cpu"), 3))
    for k in bridge.STATE_FIELDS:
        scale = max(1.0, np.abs(ref[k]).max()) if k == "m" else 1.0
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5 * scale, err_msg=k)


@pytest.mark.slow
def test_humanoid_rollout_100_steps():
    """The relaxed-rigid humanoid from bench.py's start (0.9 m, 0.01·N(0, 1)
    noise), 100 steps under the PD policy: the twin against the JAX engine's
    rollout at tier T (rtol 1e-3, atol 5e-3), m relative to its largest."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    jeng = _jax_engine("humanoid23")
    teng = _port_engine(jeng)
    rng = np.random.default_rng(3)
    arrays = bridge.state_to_numpy(teng.init_state(8))
    arrays["p"] = (arrays["p"] + 0.01 * rng.standard_normal((3, 8))).astype(np.float32)
    ref = bridge.reference_state_arrays(
        jax.jit(lambda st: jeng.rollout(st, 100))(JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    )
    got = bridge.state_to_numpy(teng.rollout(bridge.state_from_numpy(arrays, device="cpu"), 100))
    assert _active_points(teng, got) > 0
    for k in bridge.STATE_FIELDS:
        scale = max(1.0, np.abs(ref[k]).max()) if k == "m" else 1.0
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, atol=5e-3 * scale, err_msg=k)


# ----- on the card -----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_relaxed_rigid(cuda):
    """K1's relaxed-rigid kernel, through the wrapper, against the twin: the humanoid from rest at
    B = 8192 over 50 steps, and garpez tilted low at B = 1024 over 100, in
    every field (m relative to its largest) within 1e-3, with active points."""
    garpez = BatchedEngine.build(
        JaxSimModel.build_from_model_description(models.build_garpez_urdf(), contact_model=RelaxedRigidContacts()),
        device=cuda,
    )
    hum = _humanoid_rr(cuda)
    rng = np.random.default_rng(0)
    arrays = bridge.state_to_numpy(hum.init_state(8192))
    arrays["p"] = (arrays["p"] + 0.01 * rng.standard_normal((3, 8192))).astype(np.float32)
    cases = (
        (hum, bridge.state_from_numpy(arrays, device=cuda), 50, (60.0, 0.5)),
        (garpez, bridge.state_from_numpy(_garpez_arrays(garpez.n_joints, B=1024), device=cuda), 100, (20.0, 0.1)),
    )
    for eng, st, n_steps, (kp, kd) in cases:
        before = cuda_rollout.ROLLOUT_RR_KERNEL_LAUNCHES
        kern = cuda_rollout.rollout(eng, st, n_steps, kp, kd)
        torch.cuda.synchronize()
        assert cuda_rollout.ROLLOUT_RR_KERNEL_LAUNCHES == before + 1
        plain = cuda_rollout.rollout_reference(eng, st, n_steps, kp, kd)
        assert int(eng._point_geometry(*eng.fk(plain), eng.params())["active"].sum()) > 0
        for k, a, b in zip(bridge.STATE_FIELDS, kern.fields(), plain.fields()):
            assert torch.isfinite(a).all() and torch.isfinite(b).all(), k
            scale = max(1.0, float(b.abs().max())) if k == "m" else 1.0
            assert float((a - b).abs().max()) <= 1e-3 * scale, (k, float((a - b).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 4, 8])
@pytest.mark.parametrize("name", ["box", "garpez"])
def test_kernel_matches_plain_small_batch(cuda, name, lanes):
    """The relaxed-rigid kernel at 1, 4 and 8 lanes an env against the twin:
    the box dropped low and moving (no torques) and garpez tilted low under
    its PD law, 100 steps at a small B (not a multiple of a block's envs),
    every field within 1e-3 (m relative to its largest), with points active."""
    eng = BatchedEngine.build(
        JaxSimModel.build_from_model_description(URDFS[name](), contact_model=RelaxedRigidContacts()), device=cuda
    )
    B = 100
    arrays = _box_arrays(B) if name == "box" else _garpez_arrays(eng.n_joints, B)
    arrays = {k: a.astype(np.float32) for k, a in arrays.items()}
    st = bridge.state_from_numpy(arrays, device=cuda)
    kp, kd = (0.0, 0.0) if name == "box" else (20.0, 0.1)
    kernel = cuda_build.build(cuda_rollout.job(eng, lanes))
    kern = cuda_rollout.launch(kernel, eng, st, 100, kp, kd)
    again = cuda_rollout.launch(kernel, eng, st, 100, kp, kd)
    torch.cuda.synchronize()
    plain = cuda_rollout.rollout_reference(eng, st, 100, kp, kd)
    assert int(eng._point_geometry(*eng.fk(plain), eng.params())["active"].sum()) > 0
    for k, a, a2, b in zip(bridge.STATE_FIELDS, kern.fields(), again.fields(), plain.fields()):
        assert torch.equal(a, a2), k
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), k
        if a.numel():  # the box has no joints
            scale = max(1.0, float(b.abs().max())) if k == "m" else 1.0
            assert float((a - b).abs().max()) <= 1e-3 * scale, (k, float((a - b).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_soft_only_kernels_raise_on_the_card(kernel, cuda):
    """K2, K3, K4 and K5 launch their relaxed-rigid kernel (counted once)
    on the card and give finite outputs; K4-rr's cotangents within 1e-3 of
    its plain version relative to max(1, max |plain|) from the rest start."""
    eng = _humanoid_rr(cuda)
    st = eng.init_state(64)
    module, counter = dict(step_pd=(cuda_step, "STEP_PD_RR_KERNEL_LAUNCHES"),
                           step_tau=(cuda_step, "STEP_TAU_RR_KERNEL_LAUNCHES"),
                           env_rollout=(cuda_env_rollout, "ENV_ROLLOUT_RR_KERNEL_LAUNCHES"),
                           step_vjp=(cuda_step_vjp, "STEP_VJP_RR_KERNEL_LAUNCHES"))[kernel]  # fmt: skip
    before = getattr(module, counter)
    out = WRAPPERS[kernel](eng, st)
    torch.cuda.synchronize()
    assert getattr(module, counter) == before + 1
    state = out[0] if isinstance(out, tuple) else out
    assert all(bool(torch.isfinite(t).all()) for t in state.fields())
    if kernel == "step_vjp":
        plain = cuda_step_vjp.step_vjp_reference(eng, st, torch.zeros_like(st.s), st)
        for a, b in zip([*out[0].fields(), out[1]], [*plain[0].fields(), plain[1]]):
            if b.numel():
                assert float((a - b).abs().max()) <= 1e-3 * max(1.0, float(b.abs().max()))
