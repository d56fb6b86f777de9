"""Relaxed-rigid contacts on rough terrain and with domain randomization in
the port, on the CPU, against the JAX package.

* The twin's block-Jacobi payload ``rrKc`` (the nominal per-point Delassus
  blocks, :func:`batched_engine.nominal_delassus_blocks`, computed by the
  port's own passes) against the JAX engine's ``params()["rrKc"]`` (its CRBA
  and contact Jacobians) from the same model arrays, float64, 1e-9
  relative; the port's own build at the lowering's 1e-6; the bridge carrying
  the JAX engine's blocks. The humanoid under ``-m slow``.
* The PCG budget off the plane, ``min(3·nC, 16)``, and ``rr_iterations``
  winning over it, in the twin, the JAX engine and the kernels' header.
* The twin's relaxed-rigid step on bench.py's Fourier terrain with each
  env's ``terrOff`` and the five multipliers, and on an inclined plane,
  against the JAX engine's step on the same NumPy inputs: the box in float64
  within 1e-9 over 3 steps at 3 PCG iterations (the solve not converged, so
  that the block preconditioner and the per-point normals show; the solved
  forces are the state's ``m``), and the float32 twin within tier T of the
  same reference; points on slopes asserted. Under ``-m slow``: garpez (its
  JAX step compiles for about 30 s) and the Fourier box's step VJP against
  ``jax.vjp`` in every state leaf, ``tau``, model array (``rrKc``'s
  cotangent zero, as JAX's: the preconditioner's) and row (the JAX VJP
  compiles for about three minutes).
* ``Kmul``, ``Dmul`` and ``mumul`` change nothing on a relaxed-rigid engine;
  the block preconditioner is the inverse of its blocks and converges where
  scalar Jacobi does, on another path at 3 iterations.
* The kernels' relaxed-rigid bodies under g++ (the harness of
  ``tests/test_torch_rr_step.py``): K1-rr with JX_TERRAIN 2, JX_DOMAIN and
  JX_TERR_OFF, and K3-rr on the inclined plane, built with ``float`` as
  ``double``, on garpez rolled onto its limbs at 3 PCG iterations, against
  the float64 twin within 1e-9; K5-rr with the three options in float32 at
  ``chip_smoke.TOL``; under ``-m slow`` K3-rr on Fourier terrain in double
  and the rehearsal refusing ``chip_probe.ROUGH_RR_FAULTS`` (scalar Jacobi
  in place of the block form, flat ground's normal, gmul ignored, terrOff's
  sign flipped).
* The headers: the rough builds' terrain, iterations and envs a block with
  ``rrKc`` in the block's model arrays; the wrappers taking the rough
  engine and the per-env rows to the relaxed-rigid builds.

To run these alone:

    python -m pytest -q tests/test_torch_rough_rr.py
    python -m pytest -q -m slow tests/test_torch_rough_rr.py
"""

from __future__ import annotations

import functools
import shutil

import numpy as np
import pytest
import torch

from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, bridge, models, terrain
from jaxsim_tpu_torch.ops import batched_engine, cuda_build, cuda_env_rollout, cuda_rollout, cuda_step
from jaxsim_tpu_torch.ops.contacts.relaxed_rigid import RelaxedRigidContacts
from tests.test_torch_lane_forward import TOL
from tests.test_torch_rr_step import (
    ENVS, GAINS, ROLLED_ITERS, ROLLED_QUAT, ROLLED_SPIN, _build, _fields, _run, _with_envs,
)  # fmt: skip

torch.set_num_threads(1)

URDFS = dict(box=models.build_box_urdf, garpez=models.build_garpez_urdf, humanoid23=models.build_humanoid_urdf)
FOURIER = dict(seed=0, num_components=8, amplitude=0.04, wavelength=0.7)  # bench.py's rough terrain
PLANE = dict(height=0.05, normal=(0.1, 0.0, 1.0))  # chip_smoke.PLANE
F64 = dict(rtol=1e-9, atol=1e-9)
TIER_T1 = dict(rtol=1e-3, atol=5e-4)  # docs/architecture.md tier T, per 10 steps
M_RTOL = 1e-3  # the solved forces, relative to the largest (test_torch_relaxed_rigid)
DOMAIN_SCALES = dict(Kmul=0.3, Dmul=0.3, mumul=0.2, gmul=0.05, Mmul=0.1)  # chip_smoke's exp(σ·N)
B = 6
N_STEPS = 3


def _terrains():
    import jaxsim_tpu.terrain as jax_terrain

    return dict(
        fourier=(jax_terrain.FourierTerrain.build(**FOURIER), terrain.FourierTerrain.build(**FOURIER)),
        plane=(jax_terrain.PlaneTerrain.build(PLANE["height"], normal=PLANE["normal"]),
               terrain.PlaneTerrain.build(PLANE["height"], normal=PLANE["normal"])),
    )  # fmt: skip


@functools.lru_cache(maxsize=None)
def _jax_engine(name: str, kind: str, rr_iterations: int = 0):
    """The JAX engine of ``name`` with relaxed-rigid contacts on ``kind``
    terrain, its model and arrays in float64 (so that its ``rrKc`` is)."""
    import dataclasses

    import jax

    import jaxsim_tpu.api as js
    from jaxsim_tpu.ops.batched_engine import BatchedEngine as JaxEngine
    from jaxsim_tpu.ops.contacts.relaxed_rigid import RelaxedRigidContacts as JaxRelaxedRigid

    with jax.enable_x64(True):
        model = js.JaxSimModel.build_from_model_description(
            URDFS[name](), contact_model=JaxRelaxedRigid(), terrain=_terrains()[kind][0])  # fmt: skip
        eng = JaxEngine.build(model)
    return dataclasses.replace(eng, rr_iterations=rr_iterations) if rr_iterations else eng


def _arrays(jeng) -> tuple[dict, dict[str, np.ndarray]]:
    """The JAX engine's static fields and model arrays, float64."""
    import jax

    with jax.enable_x64(True):
        return bridge.reference_engine_arrays(jeng)


def _port_engine(jeng, dtype=torch.float64) -> BatchedEngine:
    return bridge.engine_from_numpy(*_arrays(jeng), device="cpu", dtype=dtype)


def _port_build(name: str, kind: str, dtype=torch.float32) -> BatchedEngine:
    model = JaxSimModel.build_from_model_description(
        URDFS[name](), contact_model=RelaxedRigidContacts(), terrain=_terrains()[kind][1])  # fmt: skip
    return BatchedEngine.build(model, device="cpu", dtype=dtype)


# ----- rrKc and the budget -----


def _check_rrkc(name: str):
    jeng = _jax_engine(name, "fourier")
    static, params = _arrays(jeng)
    want = params["rrKc"]
    assert want.dtype == np.float64 and want.shape == (jeng.n_points, 3, 3)
    own = {k: a for k, a in params.items() if k != "rrKc"}
    got = bridge.engine_from_numpy(static, own, device="cpu", dtype=torch.float64).rrKc.numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * scale)
    # The port's own build (its model arrays from its own parser, float32).
    np.testing.assert_allclose(_port_build(name, "fourier", torch.float64).rrKc.numpy(), want, rtol=0, atol=1e-6 * scale)
    # The bridge carries the JAX engine's blocks; an engine off Fourier
    # terrain has none.
    carried = bridge.engine_from_numpy(static, params, device="cpu", dtype=torch.float64)
    assert np.array_equal(carried.rrKc.numpy(), want)
    assert carried.PARAM_NAMES == (*BatchedEngine.RR_PARAM_NAMES, "rrKc", "terr")
    assert "rrKc" not in _port_build(name, "plane").PARAM_NAMES
    assert "rrKc" in bridge.reference_params_arrays(jeng.params())


@pytest.mark.parametrize("name", ["box", "garpez"])
def test_rrkc_matches_jax(name):
    """rrKc from the JAX engine's arrays within 1e-9 of the JAX engine's
    own (symmetric, with the scalar 1/m of rrMinv on its diagonal's scale)."""
    _check_rrkc(name)


@pytest.mark.slow
def test_humanoid_rrkc_matches_jax():
    _check_rrkc("humanoid23")


def test_rr_n_iter_off_the_plane():
    """Fourier terrain: min(3·nC, 16) iterations in the twin, the JAX engine
    and the header; the plane keeps min(nC // 4 + 6, 8); rr_iterations wins."""
    for name in ("box", "garpez"):
        for kind, want in (("fourier", 16), ("plane", 8)):
            jeng, teng = _jax_engine(name, kind), _port_build(name, kind)
            assert teng._rr_n_iter == jeng._rr_n_iter == want, (name, kind)
            assert f"#define JX_RR_ITERS {want}\n" in cuda_build.topology_header(teng)
    teng = _port_build("box", "fourier")
    assert teng.n_points == 8 and min(3 * teng.n_points, 16) == 16
    teng.rr_iterations = 5
    assert teng._rr_n_iter == 5 and "#define JX_RR_ITERS 5\n" in cuda_build.topology_header(teng)


# ----- the step against the JAX engine -----


def _start(teng: BatchedEngine, name: str, kind: str, seed: int = 0):
    """B envs of ``name`` 4 mm into the terrain under them (each env's own
    patch on Fourier terrain), the base tilted and moving, joints displaced
    and moving; the per-env rows: terrOff 2·N(0, 1) m on Fourier terrain and
    the five multipliers at chip_smoke's spreads."""
    rng = np.random.default_rng(seed)
    dom = {k: np.exp(s * rng.standard_normal(B)) for k, s in DOMAIN_SCALES.items()}
    if kind == "fourier":
        dom["terrOff"] = 2.0 * rng.standard_normal((2, B))
    st = {k: np.asarray(v, np.float64) for k, v in bridge.state_to_numpy(teng.init_state(B)).items()}
    st["p"][:2] = 0.3 * rng.standard_normal((2, B))
    q = np.array([1.0, 0.08, -0.06, 0.0])[:, None] + 0.03 * rng.standard_normal((4, B))
    st["q"] = q / np.linalg.norm(q, axis=0)
    st["v"] = 0.2 * rng.standard_normal((6, B))
    st["s"] = 0.1 * rng.standard_normal(st["s"].shape)
    st["sd"] = 0.3 * rng.standard_normal(st["sd"].shape)
    pr = teng.params({k: torch.from_numpy(a) for k, a in dom.items()})
    st["p"][2] = 0.0
    g = teng._point_geometry(*teng.fk(bridge.state_from_numpy(st, device="cpu", dtype=torch.float64)), pr)
    if kind == "fourier":
        gap = g["pc"][2] - teng._fourier_height_grad(pr, g["pc"][0], g["pc"][1])[0]
    else:
        nx, ny, nz = teng.terrain_normal
        gap = (nx * g["pc"][0] + ny * g["pc"][1] + nz * g["pc"][2] - teng.terrain_offset) / nz
    st["p"][2] = -(gap.min(0).values.numpy() + 0.004)
    return st, dom


def _tau(name):
    return (lambda s, sd: 0.0 * s) if name == "box" else (lambda s, sd: -20.0 * s - 0.1 * sd)


@functools.lru_cache(maxsize=None)
def _jax_step(name: str, kind: str, rr_iterations: int):
    """The JAX step at (state, tau, pr), jitted once, float64."""
    import jax

    jeng = _jax_engine(name, kind, rr_iterations)
    return jax.jit(lambda st, tau, pr: jeng.step(st, tau, pr))


def _jax_inputs(name: str, kind: str, rr_iterations: int):
    """(twin engine float64, start arrays, per-env rows, JAX model arrays
    with the rows, torques as a function of (s, sd))."""
    jeng = _jax_engine(name, kind, rr_iterations)
    teng = _port_engine(jeng)
    st, dom = _start(teng, name, kind)
    _, params = _arrays(jeng)
    return teng, st, dom, {**params, **dom}, _tau(name)


def _check_step(name: str, kind: str, rr_iterations: int):
    """N_STEPS of the twin (float64 and float32) against the JAX step from
    the same inputs with the per-env rows."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    teng, st, dom, params, tau_fn = _jax_inputs(name, kind, rr_iterations)
    step = _jax_step(name, kind, rr_iterations)
    with jax.enable_x64(True):
        jpr = {k: jnp.asarray(a, jnp.float64) for k, a in params.items()}
        js = JaxState(**{k: jnp.asarray(a) for k, a in st.items()})
        ref = []
        for _ in range(N_STEPS):
            js = step(js, tau_fn(js.s, js.sd), jpr)
            ref.append(bridge.reference_state_arrays(js))
    for dtype in (torch.float64, torch.float32):
        eng = teng if dtype == torch.float64 else _port_engine(_jax_engine(name, kind, rr_iterations), torch.float32)
        pr = eng.params({k: torch.from_numpy(a).to(dtype) for k, a in dom.items()})
        ts = bridge.state_from_numpy(st, device="cpu", dtype=dtype)
        for t in range(N_STEPS):
            ts = eng.step(ts, tau_fn(ts.s, ts.sd), pr)
            got = bridge.state_to_numpy(ts)
            for k in bridge.STATE_FIELDS:
                r, what = ref[t][k], f"{k} after step {t + 1}, {dtype}"
                if dtype == torch.float64:
                    np.testing.assert_allclose(got[k], r, err_msg=what, **F64)
                elif k == "m":
                    np.testing.assert_allclose(got[k], r, rtol=M_RTOL, atol=M_RTOL * np.abs(r).max(), err_msg=what)
                else:
                    np.testing.assert_allclose(got[k], r, err_msg=what, **TIER_T1)
    # Points in contact, and on Fourier terrain on slopes (n_z < 0.99).
    pr = teng.params({k: torch.from_numpy(a) for k, a in dom.items()})
    g = teng._point_geometry(*teng.fk(bridge.state_from_numpy(st, device="cpu", dtype=torch.float64)), pr)
    active = g["active"] > 0
    assert int(active.sum()) >= B and np.abs(ref[-1]["m"]).max() > 0
    if kind == "fourier":
        assert int((active & (g["n"][2] < 0.99)).sum()) >= B // 2


@pytest.mark.parametrize("kind", ["fourier", "plane"])
def test_box_step_matches_jax(kind):
    """The box, 3 steps at 3 PCG iterations with the per-env rows: float64
    within 1e-9, float32 within tier T."""
    _check_step("box", kind, ROLLED_ITERS)


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["fourier", "plane"])
def test_garpez_step_matches_jax(kind):
    """Garpez at the default budget (16 on Fourier terrain, 8 on the
    plane), its joints displaced and moving (its JAX step compiles for about
    30 s)."""
    _check_step("garpez", kind, 0)


@pytest.mark.slow
def test_rough_step_vjp_matches_jax_vjp():
    """The box's step on Fourier terrain at 3 PCG iterations with the per-env
    rows under autograd (the twin's implicit PCG backward with the block
    preconditioner) against ``jax.vjp`` of the JAX step, float64 within
    1e-9: every state leaf, tau, every model array (rrKc's cotangent zero on
    both sides: the preconditioner's) and the rows gmul, Mmul and terrOff
    (the JAX VJP compiles for about three minutes)."""
    import jax
    import jax.numpy as jnp

    from jaxsim_tpu.ops.batched_engine import BatchedState as JaxState

    teng, st, dom, params, tau_fn = _jax_inputs("box", "fourier", ROLLED_ITERS)
    jeng = _jax_engine("box", "fourier", ROLLED_ITERS)
    rng = np.random.default_rng(7)
    ct = {k: rng.standard_normal(a.shape) for k, a in st.items()}

    def step_vjp(st, pr, ct):
        out, back = jax.vjp(lambda a, c: jeng.step(a, tau_fn(a.s, a.sd), c), st, pr)
        return back(ct)

    with jax.enable_x64(True):
        g_st, g_pr = jax.jit(step_vjp)(JaxState(**{k: jnp.asarray(a) for k, a in st.items()}),
                                       {k: jnp.asarray(a, jnp.float64) for k, a in params.items()},
                                       JaxState(**{k: jnp.asarray(a) for k, a in ct.items()}))  # fmt: skip
        ref_st, ref_pr = bridge.reference_state_arrays(g_st), {k: np.asarray(v) for k, v in g_pr.items()}
    leaves = {k: torch.from_numpy(a.copy()).requires_grad_(True) for k, a in st.items()}
    arrays = {k: getattr(teng, k).clone().requires_grad_(True) for k in teng.PARAM_NAMES}
    rows = {k: torch.from_numpy(a.copy()).requires_grad_(True) for k, a in dom.items()}
    state = batched_engine.BatchedState(**leaves)
    out = teng.step(state, tau_fn(state.s, state.sd), {**arrays, **rows})
    inputs = {**{f"ct.{k}": v for k, v in leaves.items()}, **arrays, **rows}
    grads = torch.autograd.grad(out.fields(), list(inputs.values()),
                                [torch.from_numpy(ct[k]) for k in bridge.STATE_FIELDS], allow_unused=True)  # fmt: skip
    got = {k: np.zeros(tuple(v.shape)) if g is None else g.numpy() for (k, v), g in zip(inputs.items(), grads)}
    want = {**{f"ct.{k}": v for k, v in ref_st.items()}, **ref_pr}
    want["axis"] = want["axis"].reshape(got["axis"].shape)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **F64)
    assert not np.abs(got["rrKc"]).any() and not np.abs(want["rrKc"]).any()
    assert np.abs(got["gmul"]).max() > 0 and np.abs(got["terrOff"]).max() > 0


def test_kmul_dmul_mumul_change_nothing():
    """A relaxed-rigid step reads gmul and Mmul of the rows; Kmul, Dmul and
    mumul leave it bit for bit as it is, as on the JAX engine."""
    st, dom = _start(_port_build("garpez", "fourier", torch.float64), "garpez", "fourier")
    eng = _port_build("garpez", "fourier")
    state = bridge.state_from_numpy({k: a.astype(np.float32) for k, a in st.items()}, device="cpu")
    rows = {k: torch.from_numpy(a.astype(np.float32)) for k, a in dom.items()}
    tau = _tau("garpez")(state.s, state.sd)
    some = eng.step(state, tau, eng.params({k: rows[k] for k in ("gmul", "Mmul", "terrOff")}))
    every = eng.step(state, tau, eng.params(rows))
    assert all(torch.equal(a, b) for a, b in zip(some.fields(), every.fields()))
    bare = eng.step(state, tau, eng.params({"terrOff": rows["terrOff"]}))
    assert float((bare.sd - some.sd).abs().max()) > 1e-3


def test_block_preconditioner():
    """The block-Jacobi blocks' inverse is the inverse of act·K + diag(r) +
    reg·I; the block and scalar forms reach one solution at 60 iterations
    and part at 3 (so the 3-iteration cases see the form)."""
    eng = _port_build("garpez", "fourier", torch.float64)
    st, dom = _start(eng, "garpez", "fourier")
    st["p"][2] -= 0.02  # a few of each env's points in contact, coupled through the tree
    state = bridge.state_from_numpy(st, device="cpu", dtype=torch.float64)
    pr = eng.params({k: torch.from_numpy(a) for k, a in dom.items()})
    rng = np.random.default_rng(1)
    act = torch.from_numpy((rng.random((eng.n_points, B)) < 0.6).astype(np.float64))
    rdiag = torch.from_numpy(rng.random((eng.n_points, 3, B)))
    Pinv = batched_engine._block_jacobi_inverse(pr["rrKc"], act, rdiag, eng.rr_reg)
    P = act[:, None, None] * pr["rrKc"][..., None] + torch.diag_embed(rdiag.transpose(1, 2) + eng.rr_reg).permute(0, 2, 3, 1)
    eye = torch.einsum("cijb,cjkb->cikb", Pinv, P).numpy()
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3)[None, :, :, None], eye.shape), atol=1e-9)

    def solve(n_iter: int, block: bool):
        """The solved forces at ``n_iter`` iterations, with the block form
        or, without rrKc among the model arrays, scalar Jacobi."""
        eng.rr_iterations = n_iter
        arrays = pr if block else {k: v for k, v in pr.items() if k != "rrKc"}
        if not block:
            own = eng.params
            eng.params = lambda p=None: {k: v for k, v in own(p).items() if k != "rrKc"}
        try:
            return eng.relaxed_rigid_contact_forces(state, *eng.fk(state, arrays), torch.zeros_like(state.s), arrays)[2]
        finally:
            if not block:
                del eng.params

    block60, block3, scalar60, scalar3 = solve(60, True), solve(3, True), solve(60, False), solve(3, False)
    scale = float(block60.abs().max())
    assert float((block60 - scalar60).abs().max()) < 1e-6 * scale
    assert float((block3 - scalar3).abs().max()) > 1e-3 * scale


# ----- the kernels' bodies under g++ -----


@functools.lru_cache(maxsize=None)
def _garpez64(kind: str) -> BatchedEngine:
    """Garpez at 3 PCG iterations in float64; the plane's normal and offset
    rounded to float32, as the generated header's literals are (a double
    build keeps them)."""
    engine = _port_build("garpez", kind, torch.float64)
    engine.rr_iterations = ROLLED_ITERS
    if kind == "plane":
        engine.terrain_normal = tuple(float(np.float32(x)) for x in engine.terrain_normal)
        engine.terrain_offset = float(np.float32(engine.terrain_offset))
    return engine


def _rolled(eng: BatchedEngine, n: int, off=None):
    """Garpez rolled onto its limbs (test_torch_rr_step's start), its base
    spinning, its joints displaced and moving, each env lowered until its
    deepest point is 4 mm into the terrain under it (on Fourier terrain the
    env's own patch, by its offset ``off``): child links' points in contact
    (two links' on Fourier terrain, one's on the plane), on slopes on
    Fourier terrain."""
    rng = np.random.default_rng(0)
    st = {k: np.asarray(v, np.float64) for k, v in bridge.state_to_numpy(eng.init_state(n)).items()}
    st["q"] = np.tile((np.asarray(ROLLED_QUAT) / np.linalg.norm(ROLLED_QUAT))[:, None], (1, n))
    st["s"] = 1.2 * rng.standard_normal(st["s"].shape)
    st["sd"] = 0.3 * rng.standard_normal(st["sd"].shape)
    st["v"][:3] = 0.1 * rng.standard_normal((3, n))
    st["v"][3:] = np.asarray(ROLLED_SPIN)[:, None]
    st["m"] = 2.0 * rng.standard_normal(st["m"].shape)
    st["p"][2] = 0.0
    pr = eng.params({} if off is None else {"terrOff": off})

    def gap(state):
        g = eng._point_geometry(*eng.fk(state), pr)
        if eng.terrain_kind == "fourier":
            return g["pc"][2] - eng._fourier_height_grad(pr, g["pc"][0], g["pc"][1])[0]
        nx, ny, nz = eng.terrain_normal
        return (nx * g["pc"][0] + ny * g["pc"][1] + nz * g["pc"][2] - eng.terrain_offset) / nz

    st["p"][2] = -(gap(bridge.state_from_numpy(st, device="cpu", dtype=eng.S.dtype)).min(0).values.numpy() + 0.004)
    state = bridge.state_from_numpy(st, device="cpu", dtype=eng.S.dtype)
    g = eng._point_geometry(*eng.fk(state), pr)
    parents = torch.tensor(eng.contact_parent)
    children = sum(bool((g["active"][parents == i] > 0).any()) for i in range(1, eng.n_links))
    assert children >= (2 if eng.terrain_kind == "fourier" else 1)
    if eng.terrain_kind == "fourier":
        assert int(((g["active"] > 0) & (g["n"][2] < 0.99)).sum()) >= n
    return state


def _rows(n: int, dtype=np.float64):
    """The five multipliers and terrOff 10·N(0, 1) m, as torch rows."""
    rng = np.random.default_rng(2)
    dom = {k: torch.from_numpy(np.exp(s * rng.standard_normal(n)).astype(dtype)) for k, s in DOMAIN_SCALES.items()}
    return dom, torch.from_numpy((10.0 * rng.standard_normal((2, n))).astype(dtype))


def _double_rough_case(tmp_path, kernel: int, kind: str, csrc=None) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """The body in double from ``csrc`` (the checkout's by default) on
    garpez rolled onto ``kind`` terrain, 3 PCG iterations, against the
    float64 twin, field by field: K1-rr (``kernel`` 1) one launch of 2 steps
    with the five multipliers and terrOff (on Fourier terrain), or K3-rr
    (3) 2 chained steps; 3 envs, the block's others past the batch."""
    eng = _garpez64(kind)
    n, n_steps = 3, 2
    kp, kd = GAINS["garpez"]
    dom, off = _rows(n)
    fourier = kind == "fourier"
    state = _rolled(eng, n, off if fourier else None)
    if kernel == 1:
        job = cuda_rollout.job(eng, domain=True, terr_off=fourier)
        rows = (torch.stack([dom[k] for k in DOMAIN_SCALES]), *((off,) if fourier else ()))
        want = cuda_rollout.rollout_reference(eng, state, n_steps, kp, kd, domain=dom, terr_off=off if fourier else None)
    else:
        job, rows, want = cuda_step.job(eng), (), state
        for _ in range(n_steps):
            want = cuda_step.step_tau_reference(eng, want, -kp * want.s - kd * want.sd)
    binary = _build(tmp_path, eng, _with_envs(job, ENVS), kernel, double=True, csrc=csrc)
    flat = _run(tmp_path, binary, eng, state, n_steps, cuda_build.packed_params(eng), (kp, kd), double=True, rows=rows)
    got, _ = _fields(flat, state)
    return {name: (got[name], w.numpy()) for name, w in zip(bridge.STATE_FIELDS, want.fields())}


@pytest.mark.parametrize("kernel, kind", [(1, "fourier"), (3, "plane")], ids=["k1-fourier-domain", "k3-plane"])
def test_rough_rr_bodies_in_double_match_float64_plain(tmp_path, kernel, kind):
    """K1-rr with JX_TERRAIN 2, JX_DOMAIN and JX_TERR_OFF, and K3-rr with
    JX_TERRAIN 1, built with ``float`` as ``double``, within 1e-9 of the
    float64 twin in every field."""
    fields = _double_rough_case(tmp_path, kernel, kind)
    for name, (got, want) in fields.items():
        np.testing.assert_allclose(got, want, err_msg=name, **F64)
    assert float(np.abs(fields["m"][1]).max()) > 0


@pytest.mark.slow
def test_rough_k3_rr_body_in_double_matches_float64_plain(tmp_path):
    """K3-rr with JX_TERRAIN 2 (no per-env rows, as the JAX kernel)."""
    for name, (got, want) in _double_rough_case(tmp_path, 3, "fourier").items():
        np.testing.assert_allclose(got, want, err_msg=name, **F64)


@pytest.mark.slow
@pytest.mark.parametrize("fault", ["scalar Jacobi in place of the block form", "flat ground's normal",
                                   "gmul ignored", "terrOff's sign flipped"])  # fmt: skip
def test_double_rehearsal_refuses_rough_faults(tmp_path, fault):
    """Each of ``chip_probe.ROUGH_RR_FAULTS``, in a copy of ``csrc/``, moves
    some field of K1-rr's rough build beyond 1e-9 of the float64 twin."""
    from tests.test_torch_rk4 import _chip_probe

    old, new = _chip_probe().ROUGH_RR_FAULTS[fault]
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    text = (csrc / "rr_step.cuh").read_text()
    assert text.count(old) == 1
    (csrc / "rr_step.cuh").write_text(text.replace(old, new))
    fields = _double_rough_case(tmp_path, 1, "fourier", csrc)
    assert not all(np.allclose(got, want, **F64) for got, want in fields.values())


def test_rough_faults_apply_once():
    from tests.test_torch_rk4 import _chip_probe

    text = (cuda_build.CSRC / "rr_step.cuh").read_text()
    for name, (old, new) in _chip_probe().ROUGH_RR_FAULTS.items():
        assert text.count(old) == 1 and old != new, name


def test_k5_rr_rough_body_matches_plain(tmp_path):
    """K5-rr with the three options (the five multipliers, terr_off and the
    terrain-relative height) in float32: one block of envs, garpez rolled on
    Fourier terrain, an MLP with H = 8, 6 steps, episodes of 4, a healthy
    relative height that ends some envs early, against the plain version at
    chip_smoke.TOL (equal resets and steps)."""
    eng = _port_build("garpez", "fourier")
    eng.rr_iterations = ROLLED_ITERS
    n, d, H = eng.n_joints, 2 * eng.n_joints + 11, 8
    rng = np.random.default_rng(12)

    def w(*shape):
        return torch.from_numpy((0.2 * rng.standard_normal(shape)).astype(np.float32))

    pol = cuda_env_rollout.make_policy(eng, W1=w(1, H, d), b1=w(1, H, 1), W2=w(1, n, H), b2=w(1, n, 1))
    dom, off = _rows(ENVS, np.float32)
    state = _rolled(eng, ENVS, off)
    opts = dict(episode_length=4, healthy_z_range=(0.02, 0.3), tau_limit=5.0)
    job = _with_envs(cuda_env_rollout.job(eng, pol, domain=True, terr_off=True, terrain_rel=True), ENVS)
    binary = _build(tmp_path, eng, job, 5)
    options = (opts["episode_length"], *(float(np.float32(z)).hex() for z in opts["healthy_z_range"]), 1,
               float(np.float32(opts["tau_limit"])).hex(), float(np.float32(0.0)).hex(), 0, ENVS)  # fmt: skip
    kp, kd = GAINS["garpez"]
    mul = torch.stack([dom[k] for k in DOMAIN_SCALES])
    flat = _run(tmp_path, binary, eng, state, 6, cuda_build.packed_params(eng), (kp, kd), options, pol.packed(),
                rows=(mul, off))  # fmt: skip
    got, at = _fields(flat, state)
    final, reward, resets, steps = cuda_env_rollout.env_rollout_reference(
        eng, state, 6, W1=pol.weights[0], b1=pol.weights[1], W2=pol.weights[2], b2=pol.weights[3], domain=dom,
        terr_off=off, terrain_relative=True, **opts,
    )  # fmt: skip
    sums = flat[at:].reshape(ENVS, 3)
    assert np.array_equal(sums[:, 1], resets.numpy()) and np.array_equal(sums[:, 2], steps.numpy())
    assert int(resets.sum()) > ENVS  # some envs end by their relative height
    assert float(np.abs(sums[:, 0] - reward.numpy()).max()) <= TOL
    for name, t in zip(bridge.STATE_FIELDS, final.fields()):
        scale = max(1.0, float(t.abs().max())) if name == "m" else 1.0
        assert float(np.abs(got[name] - t.numpy()).max(initial=0.0)) <= TOL * scale, name


# ----- the builds and the wrappers -----


def test_rough_rr_wrappers_and_headers(monkeypatch):
    """The wrappers take a relaxed-rigid engine on Fourier terrain or a
    plane to the relaxed-rigid builds (``cuda_build.build`` stubbed): K1-rr
    and K5-rr with the per-env rows as defines (JX_DOMAIN, JX_TERR_OFF, K5's
    JX_TERRAIN_REL), K2-rr (K1-rr for one step) and K3-rr with the terrain
    alone; the header's terrain and 16 PCG iterations on Fourier terrain;
    the packed arrays rrMinv, rrKc, then the spectrum; a flat engine's
    header and packed arrays without either."""
    from tests.test_torch_domain import _defines, _job_built

    B = 64
    for kind in ("fourier", "plane"):
        eng = _port_build("garpez", kind)
        st = eng.init_state(B)
        ones = torch.ones(B)
        off = dict(terr_off=torch.zeros(2, B)) if kind == "fourier" else {}
        mlp = dict(W1=torch.zeros(1, 16, 2 * eng.n_joints + 11), b1=torch.zeros(1, 16, 1),
                   W2=torch.zeros(1, eng.n_joints, 16), b2=torch.zeros(1, eng.n_joints, 1))  # fmt: skip
        calls = dict(
            rollout=(lambda: cuda_rollout.rollout(eng, st, 1, domain={"gmul": ones, "Mmul": ones}, **off), "rollout_rr.cu"),
            step_pd=(lambda: cuda_step.step_pd(eng, st), "rollout_rr.cu"),
            step_tau=(lambda: cuda_step.step_tau(eng, st, torch.zeros_like(st.s), {"M": eng.M}), "step_rr.cu"),
            env_rollout=(lambda: cuda_env_rollout.env_rollout(
                eng, st, 1, domain={"gmul": ones}, **off, **mlp, terrain_relative=kind == "fourier"), "env_rollout_rr.cu"),
        )  # fmt: skip
        for name, (call, source) in calls.items():
            job = _job_built(call, monkeypatch)
            assert job.source.name == source, name
            defines = _defines(eng, job)
            assert defines["JX_CONTACT"] == "1" and defines["JX_TERRAIN"] == ("2" if kind == "fourier" else "1"), name
            assert defines["JX_RR_ITERS"] == ("16" if kind == "fourier" else "8"), name
            per_env = name in ("rollout", "env_rollout")
            assert defines.get("JX_DOMAIN") == ("1" if per_env else None), name
            assert defines.get("JX_TERR_OFF") == ("1" if per_env and kind == "fourier" else None), name
            assert defines.get("JX_TERRAIN_REL") == ("1" if name == "env_rollout" and kind == "fourier" else None), name
        packed = cuda_build.packed_params(eng)
        tail = [eng.rrMinv, *((eng.rrKc, eng.terr) if kind == "fourier" else ())]
        n_tail = sum(t.numel() for t in tail)
        assert torch.equal(packed[-n_tail:], torch.cat([t.reshape(-1) for t in tail]))
    flat = BatchedEngine.build(JaxSimModel.build_from_model_description(
        models.build_garpez_urdf(), contact_model=RelaxedRigidContacts()), device="cpu")  # fmt: skip
    assert "JX_TERR" not in cuda_build.topology_header(flat, cuda_rollout.job(flat).defines)
    assert flat.PARAM_NAMES == BatchedEngine.RR_PARAM_NAMES


@pytest.mark.parametrize("kind", ["fourier", "plane"])
def test_rough_rr_tables(kind):
    """rr_tables counts rrKc (9 floats a point) and the spectrum among a
    block's model arrays; the humanoid's relaxed-rigid builds on Fourier
    terrain still take 64 envs a block in 227 KB: K1-rr, K3-rr and K5-rr
    under the ES main path's MLP (H = 16), whose envs a block divide a
    candidate's 1024 envs."""
    eng = _port_build("humanoid23", kind)
    n_params = cuda_build.packed_params(eng).numel()
    flat_params = sum(getattr(eng, k).numel() for k in BatchedEngine.RR_PARAM_NAMES)
    assert n_params == flat_params + (9 * eng.n_points + 4 * 8 if kind == "fourier" else 0)
    mlp = cuda_env_rollout.Policy("mlp", hidden=16)
    for label, job in (("k1", cuda_rollout.job(eng, domain=True, terr_off=kind == "fourier")),
                       ("k3", cuda_step.job(eng)),
                       ("k5", cuda_env_rollout.job(eng, mlp, domain=True, terr_off=kind == "fourier",
                                                   terrain_rel=kind == "fourier"))):  # fmt: skip
        d = dict(job.defines)
        t = cuda_build.rr_tables(eng, d["JX_RR_LANES"], tau_row=bool(d.get("JX_RR_TAU_ROW")), policy=d.get("JX_POLICY", -1),
                                 hidden=d.get("JX_HIDDEN", 0))  # fmt: skip
        weights = cuda_build.policy_weight_count(eng.n_joints, 2, 16) if label == "k5" else 0
        assert t["block_floats"] == n_params + weights, label
        assert t["envs"] == 64 and t["smem_bytes"] == 4 * (t["rows"] * 65 + n_params + weights), label
        assert t["smem_bytes"] <= cuda_build.MAX_SMEM_BYTES, label
    assert 1024 % cuda_env_rollout.envs_per_block(eng, mlp) == 0
