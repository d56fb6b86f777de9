"""Batch-minor simulation engine in plain PyTorch (the CPU twin).

Counterpart of ``jaxsim_tpu/ops/batched_engine.py`` on plane terrain
(flat ground or an inclined plane) and on Fourier rough terrain:
Hunt/Crossley soft contacts, or relaxed-rigid contacts (a matrix-free
preconditioned CG on the articulated factorization: scalar Jacobi on plane
terrain, block Jacobi on the nominal Delassus blocks ``rrKc`` on Fourier
terrain, with each point's own normal there), the
per-env domain multipliers and terrain offset of the JAX engine's ``pr``
(:data:`DOMAIN_NAMES`, ``terrOff``), the three-pass
ABA with the 6×6 base Cholesky, and the JAX engine's three fixed-step
integrators (semi-implicit Euler, RK4, and RK4-fast, whose contact forces
are frozen at the step's start). Every tensor keeps the env batch in
the TRAILING axis, ``(..., B)``, as the JAX engine does; that is also the
coalesced layout of the one-thread-per-env CUDA kernel in
:mod:`jaxsim_tpu_torch.ops.cuda_rollout`, which is held against this module.

The static tree topology is unrolled as Python loops over the parent array,
and small matrix algebra is written as broadcast multiply-and-sum over the
leading axes, so no product goes through a matrix library (and none through
TF32 on a GPU). The JAX engine's other contact models (rigid, ROADMAP Queue
1 item 6) and terrains (heightmaps, item 8) are not ported yet; the build and
the bridge refuse them with ``ValueError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .contacts.relaxed_rigid import RelaxedRigidContacts
from .contacts.soft import SoftContacts

# ----------------------------------------------------------------------
# Trailing-batch algebra helpers. Operands are (n, m, *b) / (n, *b); a model
# constant carries a trailing 1 in place of the batch axis.
# ----------------------------------------------------------------------


def _mm(A, B):
    """(n,k,*b) @ (k,m,*b)."""
    return (A.unsqueeze(2) * B.unsqueeze(0)).sum(1)


def _mv(A, v):
    """(n,k,*b) @ (k,*b)."""
    return (A * v.unsqueeze(0)).sum(1)


def _mtv(A, v):
    """Aᵀ v for (k,n,*b) A."""
    return (A * v.unsqueeze(1)).sum(0)


def _cross(a, b):
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def _maximum(x, floor: float):
    """max(x, floor) with JAX's derivative at a tie, half to each side, as
    ``jnp.maximum`` has it (``torch.clamp`` passes all of it to ``x``)."""
    return torch.maximum(x, x.new_tensor(floor))


def _minimum(x, ceiling: float):
    """min(x, ceiling) with JAX's derivative at a tie (see :func:`_maximum`)."""
    return torch.minimum(x, x.new_tensor(ceiling))


def _c(a):
    """Model constant → broadcastable against one trailing batch axis."""
    return a.unsqueeze(-1)


def _skew(a):
    """(3,3) skew matrix of a (3,) vector."""
    z = torch.zeros_like(a[0])
    return torch.stack(
        [
            torch.stack([z, -a[2], a[1]]),
            torch.stack([a[2], z, -a[0]]),
            torch.stack([-a[1], a[0], z]),
        ]
    )


def _quat_to_rot(q):
    """(4,*b) wxyz → (3,3,*b) (norm-robust)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / torch.where(n == 0, torch.ones_like(n), n)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    one = torch.ones_like(w)
    return torch.stack(
        [
            torch.stack([one - (yy + zz), xy - wz, xz + wy]),
            torch.stack([xy + wz, one - (xx + zz), yz - wx]),
            torch.stack([xz - wy, yz + wx, one - (xx + yy)]),
        ]
    )


def _xv(R, p, v6):
    """Motion transform [[R, p̂R],[0,R]] applied to (6,*b)."""
    lin, ang = v6[0:3], v6[3:6]
    Ra = _mv(R, ang)
    return torch.cat([_mv(R, lin) + _cross(p, Ra), Ra])


def _xtf(R, p, f6):
    """Force co-transform Xᵀ f for X = [[R, p̂R],[0,R]]:
    [Rᵀ f_l ; Rᵀ(f_a − p × f_l)]."""
    lin, ang = f6[0:3], f6[3:6]
    return torch.cat([_mtv(R, lin), _mtv(R, ang - _cross(p, lin))])


def _inv_rp(R, p):
    """Inverse transform pair."""
    Rt = R.transpose(0, 1)
    return Rt, -_mv(Rt, p)


def _build_X(R, p):
    """Explicit 6×6 adjoint (6,6,*b) from an (R, p) pair."""
    z = torch.zeros_like(p[0])
    px = torch.stack(
        [
            torch.stack([z, -p[2], p[1]]),
            torch.stack([p[2], z, -p[0]]),
            torch.stack([-p[1], p[0], z]),
        ]
    )
    top = torch.cat([R, _mm(px, R)], dim=1)
    bot = torch.cat([torch.zeros_like(R), R], dim=1)
    return torch.cat([top, bot], dim=0)


def _chol6_factor(M):
    """Unrolled Cholesky factor L of an SPD (6,6,*b) matrix, element-wise
    over the batch. Returns a 6×6 lower list-of-lists."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        s = M[i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = torch.sqrt(_maximum(s, 1e-12))
        inv_d = 1.0 / L[i][i]
        for j in range(i + 1, 6):
            s = M[j, i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s * inv_d
    return L


def _chol6_substitute(L, b):
    """Forward/backward substitution with a :func:`_chol6_factor` factor."""
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def _articulated(MA, pA, U, inv_d, u, c):
    """ABA pass 2 at one link: the articulated inertia and bias force the
    link hands its parent, Mₐ = MA − U Uᵀ/d and pₐ = pA + Mₐ c + U u/d."""
    Ma = MA - U.unsqueeze(1) * U.unsqueeze(0) * inv_d
    return Ma, pA + _mv(Ma, c) + U * (u * inv_d)


def _to_parent(MA_parent, pA_parent, R, p, Ma, pa):
    """Accumulate a link's Mₐ and pₐ into its parent's, through the explicit
    6×6 ``X`` of the child→parent (R, p) pair: Xᵀ Mₐ X and Xᵀ pₐ."""
    X = _build_X(R, p)
    return MA_parent + _mm(X.transpose(0, 1), _mm(Ma, X)), pA_parent + _mtv(X, pa)


def _vx(v, w):
    """Motion cross product ν × w: [[ω̂, v̂],[0, ω̂]] w."""
    vl, va = v[0:3], v[3:6]
    wl, wa = w[0:3], w[3:6]
    return torch.cat([_cross(va, wl) + _cross(vl, wa), _cross(va, wa)])


def _vxstar_Mv(v, M):
    """ν×* (M ν): [ω×f_l ; v×f_l + ω×f_a] with f = M ν."""
    Mv = _mv(M, v)
    vl, va = v[0:3], v[3:6]
    fl, fa = Mv[0:3], Mv[3:6]
    return torch.cat([_cross(va, fl), _cross(vl, fl) + _cross(va, fa)])


# ----------------------------------------------------------------------
# The relaxed-rigid solve and its implicit backward
# ----------------------------------------------------------------------


class _RrOperator:
    """The relaxed-rigid operator ``A y = act·J M⁻¹ Jᵀ (act·y) + (r + reg) y``
    as a function of its inputs, a flat list of tensors cut by ``counts``
    (name → how many): the activity ``act``, the points' parent rotations
    ``Rp`` and offsets ``Lp``, the regularizer ``rdiag``, the motion
    subspaces ``S`` and the free ABA's factorization (``U``, ``d``,
    ``inv_R``, ``inv_p`` of links 1.., the base factor ``L0``'s lower
    triangle by rows). ``a0`` shapes the substitution's zero accelerations."""

    def __init__(self, engine: BatchedEngine, counts: dict[str, int], a0: torch.Tensor):
        self.engine, self.counts, self.a0 = engine, counts, a0

    def __call__(self, flat):
        ops, k = {}, 0
        for name, n in self.counts.items():
            ops[name], k = list(flat[k : k + n]), k + n
        fact = dict(a=[self.a0], U=[None, *ops["U"]], d=[None, *ops["d"]],
                    inv_R=[None, *ops["inv_R"]], inv_p=[None, *ops["inv_p"]], L0=None)  # fmt: skip
        if ops["L0"]:
            it = iter(ops["L0"])
            fact["L0"] = [[next(it) for _ in range(i + 1)] + [None] * (5 - i) for i in range(6)]
        (act,), (Rp,), (Lp,), (rdiag,), (S,) = (ops[k] for k in ("act", "Rp", "Lp", "rdiag", "S"))
        eng, reg = self.engine, self.engine.rr_reg

        def A_apply(y):
            """A y = G y + (r + reg) y for y (nC,3,B)."""
            f_loc = eng._rr_scatter(Rp, Lp, (act * y).transpose(0, 1))
            a_c, _ = eng._minv_apply(fact, f_loc, dict(S=S))
            return act * eng._rr_gather(Rp, Lp, a_c).transpose(0, 1) + (rdiag + reg) * y

        return A_apply


def _prec_apply(prec, r):
    """The preconditioner on a residual ``r (nC,3,B)``: ``r / prec`` for the
    scalar Jacobi diagonal ``prec (nC,3,B)``, or for the inverted 3×3 blocks
    ``prec (nC,3,3,B)`` of block Jacobi, ``z_i = Σ_j prec_ij r_j`` summed in
    j's order (the JAX engine's ``prec_apply``)."""
    if prec.dim() == r.dim():
        return r / prec
    return prec[:, :, 0] * r[:, None, 0] + prec[:, :, 1] * r[:, None, 1] + prec[:, :, 2] * r[:, None, 2]


def _block_jacobi_inverse(Kc, act, rdiag, reg: float):
    """The inverted block-Jacobi blocks ``(nC,3,3,B)``: P_c = act·K_c +
    diag(r_c) + reg·I per point and env, inverted in closed form by the
    symmetric adjugate over the determinant, as the JAX engine forms them
    (``Kc (nC,3,3)``, ``act (nC,B)``, ``rdiag (nC,3,B)``)."""
    K = Kc[..., None]
    m00 = act * K[:, 0, 0] + rdiag[:, 0] + reg
    m11 = act * K[:, 1, 1] + rdiag[:, 1] + reg
    m22 = act * K[:, 2, 2] + rdiag[:, 2] + reg
    m01 = act * K[:, 0, 1]
    m02 = act * K[:, 0, 2]
    m12 = act * K[:, 1, 2]
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    inv_det = 1.0 / (m00 * c00 + m01 * c01 + m02 * c02)
    rows = [torch.stack([c00, c01, c02], 1), torch.stack([c01, c11, c12], 1), torch.stack([c02, c12, c22], 1)]
    return torch.stack(rows, 1) * inv_det[:, None, None]


def _pcg(A_apply, b, prec, n_iter: int, x0=None):
    """``n_iter`` iterations of preconditioned CG on ``A x = b`` (scalar or
    block Jacobi, :func:`_prec_apply`), no early exit, from ``x0`` or,
    without it, from zero (the JAX engine's ``pcg_run``)."""
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - A_apply(x0)
    z = _prec_apply(prec, r)
    p, rz = z, (r * z).sum((0, 1))
    for _ in range(n_iter):
        Ap = A_apply(p)
        alpha = rz / ((p * Ap).sum((0, 1)) + 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = _prec_apply(prec, r)
        rz_n = (r * z).sum((0, 1))
        beta = rz_n / (rz + 1e-20)
        p, rz = z + beta * p, rz_n
    return x


class _PcgImplicit(torch.autograd.Function):
    """``x = A(θ)⁻¹ (−b)`` by :func:`_pcg` from the warm start ``x0``, with
    the JAX engine's implicit VJP (``pcg_implicit``, ``pcg_fwd``,
    ``pcg_bwd``): for x̄, λ = PCG(x̄) from zero on the same operator and
    preconditioner; −b's cotangent is λ, the operator inputs θ get
    ∂⟨−λ, A(θ) x⟩/∂θ, and the preconditioner and the warm start get none
    (at convergence they do not move the solution), whether it is the
    scalar or the block Jacobi one. Autograd through the unrolled iterations
    would give another gradient and NaN on inactive points (``prec`` = reg
    there)."""

    @staticmethod
    def forward(ctx, operator: _RrOperator, n_iter: int, neg_b, prec, x0, *ops):
        x = _pcg(operator(ops), neg_b, prec, n_iter, x0)
        ctx.operator, ctx.n_iter = operator, n_iter
        ctx.save_for_backward(x, prec, *ops)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        x, prec, *ops = ctx.saved_tensors
        lam = _pcg(ctx.operator(ops), x_bar, prec, ctx.n_iter)
        wanted = [k for k, t in enumerate(ops) if ctx.needs_input_grad[5 + k]]
        grads = [None] * len(ops)
        if wanted:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(k in wanted) for k, t in enumerate(ops)]
                Ax = ctx.operator(leaves)(x)
                got = torch.autograd.grad(Ax, [leaves[k] for k in wanted], -lam, allow_unused=True)
            for k, g in zip(wanted, got):
                grads[k] = g
        return (None, None, lam if ctx.needs_input_grad[2] else None, None, None, *grads)


# ----------------------------------------------------------------------
# State + engine
# ----------------------------------------------------------------------

# Per-env domain multipliers, each (B,), that an engine call may take in its
# ``pr`` (the JAX engine's ``rollout(domain=)``): the soft contact law's
# stiffness, damping and friction, gravity, and every link's spatial inertia.
DOMAIN_NAMES = ("Kmul", "Dmul", "mumul", "gmul", "Mmul")
# What a refusal of the JAX engine's other contact models and terrains names.
ITEM_RIGID = "rigid contacts: ROADMAP Queue 1 item 6"
ITEM_HEIGHTMAP = "heightmap terrain: ROADMAP Queue 1 item 8"


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on: the caller's, else the CUDA card.

    With no device named and no CUDA device visible this raises instead of
    running on the CPU: a CPU run is asked for with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible and no device was named: pass"
            ' device="cpu" to run the plain PyTorch version on the CPU'
        )
    return torch.device("cuda")


@dataclasses.dataclass
class BatchedState:
    """Structure-of-arrays env-batch state: every tensor has a trailing batch
    axis ``B``."""

    s: torch.Tensor  # (n, B) joint positions
    sd: torch.Tensor  # (n, B) joint velocities
    p: torch.Tensor  # (3, B) base position
    q: torch.Tensor  # (4, B) base quaternion (wxyz)
    v: torch.Tensor  # (6, B) base inertial velocity
    m: torch.Tensor  # (nC, 3, B) tangential deformation (soft); solved point forces (relaxed-rigid)

    def fields(self) -> tuple[torch.Tensor, ...]:
        return (self.s, self.sd, self.p, self.q, self.v, self.m)


class BatchedEngine(nn.Module):
    """Static topology + scalar parameters as attributes; the numeric model
    arrays (``S``, ``M``, ``axis``, ``lamH``, ``sucH``, ``cpoint``, and for
    relaxed-rigid contacts ``rrMinv``) as buffers, so ``.to(device)`` moves
    them. An instance's ``PARAM_NAMES`` lists its own arrays."""

    PARAM_NAMES = ("S", "M", "axis", "lamH", "sucH", "cpoint")
    # A relaxed-rigid engine's: rrMinv is the per-point inverse of the
    # parent link's 3×3 linear mass block (the regularizer and the Jacobi
    # preconditioner of the contact solve).
    RR_PARAM_NAMES = PARAM_NAMES + ("rrMinv",)
    # A relaxed-rigid engine on Fourier terrain adds rrKc (nC, 3, 3) after
    # them: the nominal per-point Delassus blocks of the block-Jacobi
    # preconditioner (the JAX engine's ``params()["rrKc"]``).
    RR_KC_PARAM = "rrKc"
    # A Fourier-terrain engine's arrays end with the spectrum ``terr`` (4, K):
    # rows amp, kx, ky, phase (the JAX engine's ``params()["terr"]``).
    TERRAIN_PARAM = "terr"
    CONTACT_MODELS = ("soft", "relaxed_rigid")
    # ``plane`` is flat ground (the default normal and offset) or an
    # inclined plane; ``fourier`` the spectral rough terrain.
    TERRAIN_KINDS = ("plane", "fourier")
    # Fixed-step integrators: semi-implicit Euler, RK4, and RK4 with the
    # contact forces and ṁ frozen at the step's start.
    INTEGRATORS = ("sie", "rk4", "rk4fast")

    def __init__(
        self,
        *,
        n_links: int,
        n_joints: int,
        n_points: int,
        lam: tuple[int, ...],
        joint_types: tuple[int, ...],
        contact_parent: tuple[int, ...],
        K: float,
        D: float,
        mu: float,
        hc_p: float,
        hc_q: float,
        gravity_z: float,
        dt: float,
        floating_base: bool,
        S,
        M,
        axis,
        lamH,
        sucH,
        cpoint,
        terrain_normal: tuple[float, float, float] = (0.0, 0.0, 1.0),
        terrain_offset: float = 0.0,
        terrain_kind: str = "plane",
        terr=None,
        contact_model: str = "soft",
        rr_d_min: float = 0.9,
        rr_d_max: float = 0.95,
        rr_width: float = 0.001,
        rr_midpoint: float = 0.5,
        rr_power: float = 2.0,
        rr_stiff: float = 0.0,
        rr_damp: float = 0.0,
        rr_reg: float = 1e-6,
        rr_iterations: int = 0,
        rrMinv=None,
        rrKc=None,
        integrator: str = "sie",
        dtype: torch.dtype = torch.float32,
        device: torch.device | str | None = None,
    ):
        """``device`` defaults to the CUDA card (see :func:`resolve_device`).
        ``contact_model`` is ``"soft"`` (K, D, hc_p, hc_q are Hunt/Crossley's)
        or ``"relaxed_rigid"`` (the ``rr_*`` scalars, ``rrMinv``, and μ;
        ``rr_iterations`` fixes the PCG's iterations, 0 for the automatic
        budget :attr:`_rr_n_iter`). ``integrator`` is one of
        :attr:`INTEGRATORS`. ``terrain_kind`` is ``"plane"`` (the plane
        ``terrain_normal``·p = ``terrain_offset``) or ``"fourier"`` (the
        spectrum ``terr``, offset by ``terrain_offset``). A relaxed-rigid
        engine with contact points on Fourier terrain takes ``rrKc``, the
        nominal per-point Delassus blocks; without it the engine computes
        them (:func:`nominal_delassus_blocks`)."""
        super().__init__()
        device = resolve_device(device)
        if contact_model not in self.CONTACT_MODELS:
            raise ValueError(f"contact_model must be one of {self.CONTACT_MODELS}, got {contact_model!r} ({ITEM_RIGID})")
        if terrain_kind not in self.TERRAIN_KINDS:
            raise ValueError(f"terrain_kind must be one of {self.TERRAIN_KINDS}, got {terrain_kind!r} ({ITEM_HEIGHTMAP})")
        if (terrain_kind == "fourier") != (terr is not None):
            raise ValueError("a Fourier-terrain engine, and only one, takes the spectrum terr")
        if integrator not in self.INTEGRATORS:
            raise ValueError(f"integrator must be one of {self.INTEGRATORS}, got {integrator!r}")
        self.contact_model = contact_model
        self.integrator = integrator
        self.rr_d_min = float(rr_d_min)
        self.rr_d_max = float(rr_d_max)
        self.rr_width = float(rr_width)
        self.rr_midpoint = float(rr_midpoint)
        self.rr_power = float(rr_power)
        self.rr_stiff = float(rr_stiff)
        self.rr_damp = float(rr_damp)
        self.rr_reg = float(rr_reg)
        self.rr_iterations = int(rr_iterations)
        self.n_links = int(n_links)
        self.n_joints = int(n_joints)
        self.n_points = int(n_points)
        self.lam = tuple(int(i) for i in lam)
        self.joint_types = tuple(int(t) for t in joint_types)
        self.contact_parent = tuple(int(i) for i in contact_parent)
        self.K = float(K)
        self.D = float(D)
        self.mu = float(mu)
        self.hc_p = float(hc_p)
        self.hc_q = float(hc_q)
        self.gravity_z = float(gravity_z)
        self.dt = float(dt)
        self.floating_base = bool(floating_base)
        # Plane terrain through (0, 0, H) with unit normal n̂ = (a, b, c);
        # terrain_offset = c·H, so the penetration is δ = max(0, offset − n̂·p).
        # The default (ẑ, 0) takes the flat-ground code path. Fourier terrain:
        # h(x, y) = terrain_offset + Σ amp sin(kx x + ky y + phase).
        self.terrain_kind = terrain_kind
        self.terrain_normal = tuple(float(x) for x in terrain_normal)
        self.terrain_offset = float(terrain_offset)

        arrays = dict(S=S, M=M, axis=axis, lamH=lamH, sucH=sucH, cpoint=cpoint, rrMinv=rrMinv, rrKc=rrKc, terr=terr)
        shapes = dict(
            S=(self.n_links, 6),
            M=(self.n_links, 6, 6),
            axis=(self.n_joints, 3),
            lamH=(1 + self.n_joints, 4, 4),
            sucH=(1 + self.n_joints, 4, 4),
            cpoint=(self.m_rows, 3),
            rrMinv=(self.m_rows, 3, 3),
            rrKc=(self.m_rows, 3, 3),
            terr=(4, np.shape(terr)[-1] if terr is not None else 0),
        )
        if contact_model == "relaxed_rigid":
            self.PARAM_NAMES = self.RR_PARAM_NAMES
            if rrMinv is None:
                raise ValueError("a relaxed-rigid engine needs rrMinv")
        block = contact_model == "relaxed_rigid" and terrain_kind == "fourier" and self.n_points > 0
        if rrKc is not None and not block:
            raise ValueError("rrKc is the block-Jacobi preconditioner of a relaxed-rigid engine on Fourier terrain")
        if block:
            self.PARAM_NAMES = self.PARAM_NAMES + (self.RR_KC_PARAM,)
        if terrain_kind == "fourier":
            self.PARAM_NAMES = self.PARAM_NAMES + (self.TERRAIN_PARAM,)
        if len(self.lam) != self.n_links or len(self.joint_types) != 1 + self.n_joints:
            raise ValueError("topology sizes disagree with n_links/n_joints")
        if len(self.contact_parent) != self.n_points:
            raise ValueError("contact_parent must have n_points entries")
        if block and rrKc is None:
            arrays["rrKc"] = np.zeros(shapes["rrKc"])  # computed below, from the other arrays
        for name in self.PARAM_NAMES:
            t = torch.tensor(np.array(arrays[name]), dtype=dtype, device=device)
            if tuple(t.shape) != shapes[name]:
                raise ValueError(f"{name} must have shape {shapes[name]}, got {tuple(t.shape)}")
            self.register_buffer(name, t)
        if block and rrKc is None:
            self.rrKc.copy_(torch.tensor(nominal_delassus_blocks(self, arrays), dtype=dtype))

    @staticmethod
    def build(
        model, *, dtype: torch.dtype = torch.float32, device=None
    ) -> "BatchedEngine":
        """Lower a :class:`~jaxsim_tpu_torch.api.model.JaxSimModel` (soft or
        relaxed-rigid contacts, flat ground, an inclined plane or Fourier
        terrain, any of its integrators: the configurations
        the port's model expresses) to engine arrays, on ``device`` (by
        default the CUDA card; see :func:`resolve_device`), as
        ``jaxsim_tpu/ops/batched_engine.py::BatchedEngine.build`` does."""
        from jaxsim_tpu_torch.terrain import FlatTerrain, FourierTerrain

        if isinstance(model.terrain, FourierTerrain):
            terrain = dict(terrain_kind="fourier", terrain_offset=float(model.terrain._h0),
                           terr=model.terrain.spectrum())  # fmt: skip
        elif isinstance(model.terrain, FlatTerrain):
            normal = tuple(float(x) for x in getattr(model.terrain, "_normal", (0.0, 0.0, 1.0)))
            terrain = dict(terrain_normal=normal, terrain_offset=normal[2] * float(model.terrain._height))
        else:
            raise ValueError(
                f"the port's engine supports flat, plane and Fourier terrain, not {model.terrain!r} ({ITEM_HEIGHTMAP})"
            )
        kdp = model.kin_dyn_parameters
        cp = kdp.contact_parameters
        idx = cp.indices_of_enabled_collidable_points
        pars = model.contact_params
        M_links = kdp.link_parameters.spatial_inertia()
        if isinstance(model.contact_model, RelaxedRigidContacts):
            xi_max = float(pars.d_max)
            Omega = float(pars.time_constant)
            zeta = float(pars.damping_coefficient)
            stiff = 1.0 / (xi_max * Omega * zeta) ** 2
            damp = 2.0 / (xi_max * Omega)
            if float(pars.K) < 0:
                stiff = -float(pars.K) / xi_max**2
            if float(pars.D) < 0:
                damp = -float(pars.D) / xi_max
            contact = dict(
                contact_model="relaxed_rigid",
                # K and D are unused by the relaxed-rigid solve.
                K=0.0,
                D=0.0,
                hc_p=0.0,
                hc_q=0.0,
                rr_d_min=float(pars.d_min),
                rr_d_max=xi_max,
                rr_width=float(pars.width),
                rr_midpoint=float(pars.midpoint),
                rr_power=float(pars.power),
                rr_stiff=stiff,
                rr_damp=damp,
                rr_reg=float(model.contact_model.regularization),
                rrMinv=np.stack([np.linalg.inv(np.asarray(M_links[int(cp.body[i])])[0:3, 0:3]) for i in idx])
                if len(idx)
                else np.zeros((1, 3, 3)),
            )
        elif isinstance(model.contact_model, SoftContacts):
            contact = dict(K=float(pars.K), D=float(pars.D), hc_p=float(pars.p), hc_q=float(pars.q))
        else:
            raise ValueError(
                f"the port implements soft and relaxed-rigid contacts, not {model.contact_model!r} ({ITEM_RIGID})"
            )
        from jaxsim_tpu_torch.api.model import IntegratorType

        integrator = {
            IntegratorType.SemiImplicitEuler: "sie",
            IntegratorType.RungeKutta4: "rk4",
            IntegratorType.RungeKutta4Fast: "rk4fast",
        }[model.integrator]
        return BatchedEngine(
            **contact,
            **terrain,
            integrator=integrator,
            n_links=kdp.number_of_links(),
            n_joints=kdp.number_of_joints(),
            n_points=len(idx),
            lam=kdp.parent_array_static,
            joint_types=kdp.joint_model.joint_types,
            contact_parent=tuple(int(cp.body[i]) for i in idx),
            mu=float(pars.mu),
            gravity_z=float(model.gravity),
            dt=float(model.time_step),
            floating_base=model.floating_base(),
            S=kdp.motion_subspaces,
            M=M_links,
            axis=kdp.joint_model.joint_axis,
            lamH=kdp.joint_model.lambda_H_pre,
            sucH=kdp.joint_model.suc_H_i,
            # Contact-free models pad to one zero row (never read).
            cpoint=cp.point[idx] if len(idx) else np.zeros((1, 3)),
            dtype=dtype,
            device=device,
        )

    def params(self, pr: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        """The numeric model arrays by name; entries of ``pr`` override the
        engine's own (the call-time model arrays of the JAX engine's ``pr``).
        ``pr`` may also hold the per-env domain multipliers
        (:data:`DOMAIN_NAMES`, each ``(B,)``) and, on Fourier terrain, the
        per-env terrain offset ``terrOff`` ``(2, B)``, which translates each
        env's terrain query."""
        own = {name: getattr(self, name) for name in self.PARAM_NAMES}
        if pr is None:
            return own
        unknown = set(pr) - set(own) - set(DOMAIN_NAMES) - {"terrOff"}
        if unknown:
            raise ValueError(f"unknown model arrays in pr: {sorted(unknown)}")
        for name, t in pr.items():
            if name in DOMAIN_NAMES:
                if t.ndim != 1:
                    raise ValueError(f"pr[{name!r}] must be a (B,) row, got {tuple(t.shape)}")
            elif name == "terrOff":
                if self.terrain_kind != "fourier":
                    raise ValueError("terrOff translates a Fourier terrain; this engine's terrain is a plane")
                if t.ndim != 2 or t.shape[0] != 2:
                    raise ValueError(f"pr['terrOff'] must have shape (2, B), got {tuple(t.shape)}")
            elif tuple(t.shape) != tuple(own[name].shape):
                raise ValueError(
                    f"pr[{name!r}] must have shape {tuple(own[name].shape)}, got {tuple(t.shape)}"
                )
        return {**own, **pr}

    @property
    def m_rows(self) -> int:
        """Leading size of the ``m`` state leaf: contact-free models carry one
        inert zero row, as in the JAX engine."""
        return max(self.n_points, 1)

    @property
    def flat(self) -> bool:
        return self.terrain_kind == "plane" and self.terrain_normal == (0.0, 0.0, 1.0) and self.terrain_offset == 0.0

    @property
    def terrain(self) -> str:
        """``"flat"``, ``"plane"`` (an inclined or raised plane) or ``"fourier"``."""
        return "flat" if self.flat else self.terrain_kind

    def init_state(
        self,
        B: int,
        *,
        base_position=(0.0, 0.0, 0.9),
        generator: torch.Generator | None = None,
    ) -> BatchedState:
        """Rest state at ``base_position``; with a generator, 0.01·N(0, 1)
        noise on the base position (drawn on the generator's device, which
        must be the engine's)."""
        dtype, device = self.S.dtype, self.S.device
        p0 = torch.as_tensor(base_position, dtype=dtype, device=device)[:, None].repeat(1, B)
        if generator is not None:
            p0 = p0 + 0.01 * torch.randn(
                (3, B), generator=generator, dtype=dtype, device=device
            )
        q0 = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)[:, None]
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
        return BatchedState(
            s=zeros(self.n_joints, B),
            sd=zeros(self.n_joints, B),
            p=p0,
            q=q0.repeat(1, B),
            v=zeros(6, B),
            m=zeros(self.m_rows, 3, B),
        )

    # ----- kinematics -----

    def _relative_transforms(self, s, pr):
        """Forward parent→child (R, p) pairs per joint i = 1..nL-1."""
        out_R, out_p = [], []
        eye = _c(torch.eye(3, dtype=s.dtype, device=s.device))
        for j in range(1, self.n_joints + 1):
            lamH, sucH = pr["lamH"][j], pr["sucH"][j]
            jt = self.joint_types[j]
            th = s[j - 1]
            if jt == 1:  # revolute: Rodrigues about the joint axis
                K = _skew(pr["axis"][j - 1])
                K2 = _mm(K, K)
                R_j = eye + torch.sin(th) * _c(K) + (1 - torch.cos(th)) * _c(K2)
                p_j = torch.zeros((3,) + th.shape, dtype=th.dtype, device=th.device)
            elif jt == 2:  # prismatic
                R_j = eye.expand(3, 3, th.shape[0])
                p_j = _c(pr["axis"][j - 1]) * th
            else:  # fixed
                R_j = eye.expand(3, 3, th.shape[0])
                p_j = torch.zeros((3,) + th.shape, dtype=th.dtype, device=th.device)

            # λ_H_i = λ_H_pre ∘ joint ∘ suc_H_i.
            R1, p1 = _c(lamH[:3, :3]), _c(lamH[:3, 3])
            R2, p2 = _c(sucH[:3, :3]), _c(sucH[:3, 3])
            R_a = _mm(R1, R_j)
            p_a = p1 + _mv(R1, p_j)
            out_R.append(_mm(R_a, R2))
            out_p.append(p_a + _mv(R_a, p2))
        return out_R, out_p

    def fk(self, state: BatchedState, pr=None):
        """World (R, p) pose pairs + inertial 6D velocities of all links."""
        pr = self.params(pr)
        rel_R, rel_p = self._relative_transforms(state.s, pr)

        R_B = _quat_to_rot(state.q)
        suc0 = pr["sucH"][0]
        W_R = [_mm(R_B, _c(suc0[:3, :3]))]
        W_p = [state.p + _mv(R_B, _c(suc0[:3, 3]))]
        W_v = [state.v if self.floating_base else torch.zeros_like(state.v)]

        for i in range(1, self.n_links):
            lam = self.lam[i]
            Rl, pl = W_R[lam], W_p[lam]
            Ri = _mm(Rl, rel_R[i - 1])
            pi = pl + _mv(Rl, rel_p[i - 1])
            W_R.append(Ri)
            W_p.append(pi)
            S = _c(pr["S"][i])
            sdi = state.sd[i - 1]
            RSa = _mv(Ri, S[3:6] * sdi)
            dv = torch.cat([_mv(Ri, S[0:3] * sdi) + _cross(pi, RSa), RSa])
            W_v.append(W_v[lam] + dv)
        return W_R, W_p, W_v

    # ----- contacts -----

    def _fourier_height_grad(self, pr, x, y):
        """Height h(x, y) and gradient (∂h/∂x, ∂h/∂y) of the spectral terrain
        ``pr["terr"]``, elementwise, its components summed in order; an
        optional ``pr["terrOff"]`` ((2,) or (2, B)) translates each env's
        terrain query."""
        T = pr["terr"]
        if "terrOff" in pr:
            x = x - pr["terrOff"][0]
            y = y - pr["terrOff"][1]
        h = torch.zeros_like(x)
        dhx = torch.zeros_like(x)
        dhy = torch.zeros_like(x)
        for k in range(T.shape[1]):
            a, kx, ky, ph = T[0, k], T[1, k], T[2, k], T[3, k]
            arg = kx * x + ky * y + ph
            h = h + a * torch.sin(arg)
            c_ = a * torch.cos(arg)
            dhx = dhx + kx * c_
            dhy = dhy + ky * c_
        return self.terrain_offset + h, dhx, dhy

    def soft_contact_forces(self, W_R, W_p, W_v, m, pr=None):
        """Hunt/Crossley per point, vectorized over the points; per-link 6D
        inertial forces (list of (6,B) or None) and ṁ (nC,3,B). The plane's
        static normal, or on Fourier terrain the analytic normal at each
        point, with δ = (h − z)·n̂_z; ``pr``'s ``Kmul``, ``Dmul`` and
        ``mumul`` scale K, D and μ per env."""
        f_links = [None] * self.n_links
        if self.n_points == 0:
            return f_links, torch.zeros_like(m)
        pr = self.params(pr)
        eps = torch.finfo(torch.float32).eps
        ax, ay, az = self.terrain_normal
        off = self.terrain_offset
        flat = self.flat
        fourier = self.terrain_kind == "fourier"
        K = self.K * pr["Kmul"] if "Kmul" in pr else self.K
        D = self.D * pr["Dmul"] if "Dmul" in pr else self.D
        mu = self.mu * pr["mumul"] if "mumul" in pr else self.mu

        parents = self.contact_parent
        Rp = torch.stack([W_R[i] for i in parents], 2)  # (3,3,nC,B)
        pp = torch.stack([W_p[i] for i in parents], 1)  # (3,nC,B)
        vp = torch.stack([W_v[i] for i in parents], 1)  # (6,nC,B)
        Lp = pr["cpoint"].transpose(0, 1)[:, :, None]  # (3,nC,1)
        pc = _mv(Rp, Lp) + pp
        pd = vp[0:3] + _cross(vp[3:6], pc)

        mc = m.transpose(0, 1)  # (3,nC,B)
        zb = torch.zeros_like(pd[0])
        if flat:
            delta = _maximum(-pc[2], 0.0)
            delta_dot = torch.where(delta > 0, -pd[2], zb)
        elif fourier:
            # The analytic height and normal at each point (δ = (h − z)·n̂_z).
            h, dhx, dhy = self._fourier_height_grad(pr, pc[0], pc[1])
            inv_n = 1.0 / torch.sqrt(dhx * dhx + dhy * dhy + 1.0)
            ax, ay, az = -dhx * inv_n, -dhy * inv_n, inv_n
            ndotv = ax * pd[0] + ay * pd[1] + az * pd[2]
            delta = _maximum((h - pc[2]) * az, 0.0)
            delta_dot = torch.where(delta > 0, -ndotv, zb)
        else:
            ndotp = ax * pc[0] + ay * pc[1] + az * pc[2]
            ndotv = ax * pd[0] + ay * pd[1] + az * pd[2]
            delta = _maximum(off - ndotp, 0.0)
            delta_dot = torch.where(delta > 0, -ndotv, zb)

        dp = torch.pow(delta + eps, self.hc_p)
        dq = torch.pow(delta + eps, self.hc_q)
        fn_mag = _maximum((K * dp) * delta + (D * dq) * delta_dot, 0.0)

        if flat:
            v_t = torch.stack([pd[0], pd[1], zb])
            m_n = torch.stack([zb, zb, mc[2]])
            m_t = torch.stack([mc[0], mc[1], zb])
        else:
            v_t = torch.stack(
                [pd[0] - ndotv * ax, pd[1] - ndotv * ay, pd[2] - ndotv * az]
            )
            mdotn = ax * mc[0] + ay * mc[1] + az * mc[2]
            m_n = torch.stack([mdotn * ax, mdotn * ay, mdotn * az])
            m_t = mc - m_n

        f_t = -((K * dp) * m_t + (D * dq) * v_t)
        f_t_sq = (f_t * f_t).sum(0)
        no_contact = delta <= 0
        sticking = no_contact | (f_t_sq <= (mu * fn_mag) ** 2)
        norm = torch.sqrt(_maximum(f_t_sq, eps**2))
        scale = torch.minimum(mu * fn_mag, norm) / norm
        f_t = torch.where(sticking, f_t, f_t * scale)
        f_t = torch.where(no_contact, torch.zeros_like(f_t), f_t)

        md_nc = -(K / D) * mc
        md_st = v_t - (K / D) * m_n
        md_sl = -(f_t + (K * dp) * m_t) / (D * dq)
        md = torch.where(no_contact, md_nc, torch.where(sticking, md_st, md_sl))

        if flat:
            f_lin = torch.stack([f_t[0], f_t[1], f_t[2] + fn_mag])
        else:
            f_lin = torch.stack(
                [f_t[0] + fn_mag * ax, f_t[1] + fn_mag * ay, f_t[2] + fn_mag * az]
            )
        f6 = torch.cat([f_lin, _cross(pc, f_lin)])  # (6,nC,B)

        # Sum into the parent links in contact-index order.
        for c, parent in enumerate(parents):
            f_links[parent] = f6[:, c] if f_links[parent] is None else f_links[parent] + f6[:, c]
        return f_links, md.transpose(0, 1)

    # ----- relaxed-rigid contacts -----

    @property
    def _rr_n_iter(self) -> int:
        """PCG iterations of the relaxed-rigid solve: ``rr_iterations`` when
        set, else the JAX engine's warm-started budget, ``min(3·nC, 16)`` on
        Fourier terrain and ``min(nC // 4 + 6, 8)`` on plane terrain."""
        if self.rr_iterations:
            return int(self.rr_iterations)
        if not self.n_points:
            return 0
        if self.terrain_kind != "plane":
            return min(3 * self.n_points, 16)
        return min(self.n_points // 4 + 6, 8)

    def _minv_apply(self, fact, f_loc, pr):
        """Zero-velocity articulated substitution passes: link-frame spatial
        forces ``f_loc`` (list, None allowed) → link-frame accelerations and
        joint accelerations, the generalized M⁻¹ Jᵀ action, reusing the
        factorization :meth:`aba` returns with ``return_aux``."""
        nL = self.n_links
        S_all = pr["S"]
        zeros6 = torch.zeros_like(fact["a"][0])
        pA = [-f if f is not None else zeros6 for f in f_loc]
        u = [None] * nL
        for i in range(nL - 1, 0, -1):
            lam = self.lam[i]
            u[i] = -(_c(S_all[i]) * pA[i]).sum(0)
            pa = pA[i] + fact["U"][i] * (u[i] / fact["d"][i])
            if lam != 0 or self.floating_base:
                pA[lam] = pA[lam] + _xtf(fact["inv_R"][i], fact["inv_p"][i], pa)

        a = [None] * nL
        a[0] = -_chol6_substitute(fact["L0"], pA[0]) if self.floating_base else zeros6
        sdd = []
        for i in range(1, nL):
            a_i = _xv(fact["inv_R"][i], fact["inv_p"][i], a[self.lam[i]])
            sdd_i = (u[i] - (fact["U"][i] * a_i).sum(0)) / fact["d"][i]
            sdd.append(sdd_i)
            a[i] = a_i + _c(S_all[i]) * sdd_i
        return a, torch.stack(sdd) if sdd else zeros6[:0]

    def _point_geometry(self, W_R, W_p, W_v, pr):
        """The contact points' parent rotations ``Rp (3,3,nC,B)``, body-frame
        offsets ``Lp (3,nC,1)``, world positions ``pc`` and velocities ``pd``
        (3,nC,B), the parents' angular velocities ``omega``, the penetration
        ``delta`` and the activity ``active = (delta > 0)`` (nC,B), and the
        unit normal ``n``: the plane's (three floats), or on Fourier terrain
        each point's in each env (three (nC,B) tensors, from the analytic
        gradient at the point, ``pr``'s ``terrOff`` honoured), with δ =
        max(0, (h − z)·n̂_z); vectorized over the points."""
        ax, ay, az = self.terrain_normal
        parents = self.contact_parent
        Rp = torch.stack([W_R[i] for i in parents], 2)
        pp = torch.stack([W_p[i] for i in parents], 1)
        vp = torch.stack([W_v[i] for i in parents], 1)
        Lp = pr["cpoint"].transpose(0, 1)[:, :, None]
        pc = _mv(Rp, Lp) + pp
        omega = vp[3:6]
        pd = vp[0:3] + _cross(omega, pc)
        if self.flat:
            delta = _maximum(-pc[2], 0.0)
        elif self.terrain_kind == "fourier":
            h, dhx, dhy = self._fourier_height_grad(pr, pc[0], pc[1])
            inv_n = 1.0 / torch.sqrt(dhx * dhx + dhy * dhy + 1.0)
            ax, ay, az = -dhx * inv_n, -dhy * inv_n, inv_n
            delta = _maximum((h - pc[2]) * az, 0.0)
        else:
            delta = _maximum(self.terrain_offset - (ax * pc[0] + ay * pc[1] + az * pc[2]), 0.0)
        active = (delta > 0).to(pc.dtype)
        return dict(Rp=Rp, Lp=Lp, pc=pc, pd=pd, omega=omega, delta=delta, active=active, n=(ax, ay, az))

    def _rr_scatter(self, Rp, Lp, y):
        """Point forces ``y (3,nC,B)`` in world axes → link-frame wrenches of
        the parent links (list, None for a link without points), summed in
        contact-index order."""
        Rty = _mtv(Rp, y)
        f6 = torch.cat([Rty, _cross(Lp, Rty)])
        f_loc = [None] * self.n_links
        for c, parent in enumerate(self.contact_parent):
            f_loc[parent] = f6[:, c] if f_loc[parent] is None else f_loc[parent] + f6[:, c]
        return f_loc

    def _rr_gather(self, Rp, Lp, a):
        """Link-frame accelerations ``a`` (list of (6,B)) → the contact
        points' world accelerations Rp (a_lin + ω̇ × Lp), (3,nC,B)."""
        ac = torch.stack([a[i] for i in self.contact_parent], 1)
        return _mv(Rp, ac[0:3] + _cross(ac[3:6], Lp))

    def relaxed_rigid_contact_forces(self, state: BatchedState, W_R, W_p, W_v, tau, pr=None, return_wrenches=False):
        """Relaxed-rigid (MJX-style soft-constraint) contact solve on plane
        or Fourier terrain, as ``jaxsim_tpu/ops/batched_engine.py::relaxed_rigid_contact_forces``
        computes it with ``return_accelerations``.

        The SPD system ``A x = −b``, ``A = J M⁻¹ Jᵀ + diag(r) + reg·I``, is
        solved matrix-free with ``_rr_n_iter`` iterations of preconditioned
        CG, scalar Jacobi on plane terrain and block Jacobi on the nominal
        Delassus blocks ``rrKc`` on Fourier terrain (where each point's
        normal is its own), warm-started from the previous step's forces in
        ``state.m`` (a point without them starts from the preconditioner's
        estimate P⁻¹(−b)). Each ``A y`` scatters the point forces to link wrenches,
        runs :meth:`_minv_apply` on the free ABA's factorization and
        gathers the point accelerations. Returns the contact-coupled
        accelerations ``(W_a, sdd)``, the free ones plus M⁻¹ Jᵀ x, and the
        solved point forces ``xs (nC,3,B)``; with ``return_wrenches``, in
        place of the accelerations, the per-link world 6D contact forces
        (list, None for a link without points) that :meth:`aba` takes as
        ``f_ext``, and ``xs``: the JAX engine's frozen forces of RK4-fast."""
        pr = self.params(pr)
        mu, reg = self.mu, self.rr_reg
        width, mid, power = self.rr_width, self.rr_midpoint, self.rr_power
        xi_min, xi_max = self.rr_d_min, self.rr_d_max

        # Free dynamics (gravity and torques, no contacts) and factorization.
        _, sdd_free, fact = self.aba(state, W_R, W_p, W_v, [None] * self.n_links, tau, pr, return_aux=True)
        a_free = fact["a"]

        g = self._point_geometry(W_R, W_p, W_v, pr)
        Rp, Lp, pd, omega, delta, active = (g[k] for k in ("Rp", "Lp", "pd", "omega", "delta", "active"))

        # Impedance ξ per component of pos = −δ n̂ (elementwise sigmoid), the
        # reference acceleration and the μ²-scaled regularizer's coefficient.
        xi, aref, coeff = [], [], []
        for j in range(3):
            pos_j = -delta * g["n"][j]
            x_j = delta * abs(g["n"][j]) / width
            ya = (1.0 / mid ** (power - 1.0)) * torch.pow(x_j, power)
            yb = 1.0 - (1.0 / (1.0 - mid) ** (power - 1.0)) * torch.pow(_maximum(1.0 - x_j, 0.0), power)
            y_j = torch.where(x_j < mid, ya, yb)
            # jnp.clip is maximum then minimum, and so are its derivatives at a tie.
            xi_j = _minimum(_maximum(xi_min + y_j * (xi_max - xi_min), xi_min), xi_max)
            xi_j = torch.where(x_j > 1.0, torch.full_like(xi_j, xi_max), xi_j)
            xi.append(xi_j)
            aref.append(-(self.rr_damp * pd[j] + self.rr_stiff * xi_j * pos_j))
            coeff.append((2.0 * mu * mu * (1.0 - xi_j) / (xi_j + 1e-12)) * (1.0 + mu * mu))

        # Free point acceleration p̈ = R(a_lin + ω̇ × Lp) + g + ω × ṗ.
        acc = self._rr_gather(Rp, Lp, a_free)
        wxpd = _cross(omega, pd)
        gz = self._gravity(torch.zeros_like(state.p[0]), pr)
        pdd = torch.stack([acc[0] + wxpd[0], acc[1] + wxpd[1], acc[2] + gz + wxpd[2]])

        # The μ²-scaled regularizer plus the impedance floor (1−ξ)/ξ · M⁻¹_jj,
        # the right-hand side and the Jacobi preconditioner, per component.
        Minv = pr["rrMinv"][..., None]
        b, prec, rdiag = [], [], []
        for j in range(3):
            r_j = active * (
                sum(coeff[i] * Minv[:, i, j] for i in range(3))
                + ((1.0 - xi[j]) / (xi[j] + 1e-12)) * Minv[:, j, j]
            )
            rdiag.append(r_j)
            b.append(active * (pdd[j] - aref[j]))
            prec.append(active * Minv[:, j, j] + r_j + reg)
        neg_b = -torch.stack(b, 1)  # (nC,3,B), the JAX solve's layout
        rdiag = torch.stack(rdiag, 1)
        if "rrKc" in pr:  # block Jacobi on Fourier terrain
            prec = _block_jacobi_inverse(pr["rrKc"], active, rdiag, reg)
        else:
            prec = torch.stack(prec, 1)
        act = active[:, None]

        # Everything the operator reads is an input of the implicit solve, as
        # the JAX engine's ``ops`` pytree is of its ``pcg_implicit``.
        L0 = fact["L0"]
        ops = dict(
            act=[act], Rp=[Rp], Lp=[Lp], rdiag=[rdiag], S=[pr["S"]],
            U=fact["U"][1:], d=fact["d"][1:], inv_R=fact["inv_R"][1:], inv_p=fact["inv_p"][1:],
            L0=[L0[i][j] for i in range(6) for j in range(i + 1)] if L0 is not None else [],
        )  # fmt: skip
        operator = _RrOperator(self, {k: len(v) for k, v in ops.items()}, a_free[0].detach())

        # Warm start from the previous step's forces (masked to the active
        # points); a point without them starts from the preconditioner's
        # estimate.
        m_carried = act * state.m
        has_warm = (m_carried * m_carried).sum(1, keepdim=True) > 0.0
        x0 = torch.where(has_warm, m_carried, _prec_apply(prec, neg_b))

        # Preconditioned CG on A x = −b, a fixed number of iterations, with
        # its implicit backward (:class:`_PcgImplicit`).
        x = _PcgImplicit.apply(operator, self._rr_n_iter, neg_b, prec, x0, *(t for v in ops.values() for t in v))

        if return_wrenches:
            # World wrenches [x ; pc × x] summed into the parent links in
            # contact-index order, as the JAX engine forms them.
            xw = x.transpose(0, 1)
            f6 = torch.cat([xw, _cross(g["pc"], xw)])
            f_links = [None] * self.n_links
            for c, parent in enumerate(self.contact_parent):
                f_links[parent] = f6[:, c] if f_links[parent] is None else f_links[parent] + f6[:, c]
            return f_links, x

        # The contact-coupled accelerations: free ones plus M⁻¹ Jᵀ x.
        a_cont, sdd_cont = self._minv_apply(fact, self._rr_scatter(Rp, Lp, x.transpose(0, 1)), pr)
        if self.floating_base:
            zb = torch.zeros_like(state.p[0])
            g6 = torch.stack([zb, zb, gz, zb, zb, zb])
            W_a = _xv(W_R[0], W_p[0], a_free[0] + a_cont[0]) + g6
        else:
            W_a = torch.zeros_like(state.v)
        return W_a, sdd_free + sdd_cont, x

    # ----- dynamics -----

    def _gravity(self, zb, pr):
        """The gravity's z component per env from a zero row ``zb`` (B,):
        ``gravity_z``, times ``pr["gmul"]`` when given."""
        gz = zb + self.gravity_z
        return gz * pr["gmul"] if "gmul" in pr else gz

    def aba(self, state: BatchedState, W_R, W_p, W_v, f_ext, tau, pr=None, return_aux: bool = False):
        """Articulated-Body Algorithm, trailing batch, unrolled tree.
        ``pr``'s ``gmul`` scales gravity and its ``Mmul`` every link's
        spatial inertia, per env.
        ``f_ext``: per-link world 6D forces, (6,B) or None. With
        ``return_aux`` a third value holds the link-frame accelerations ``a``
        and the configuration-only factorization (``U``, ``d``, the
        child→parent pairs ``inv_R``/``inv_p``, the base Cholesky factor
        ``L0``) that :meth:`_minv_apply` reuses."""
        nL = self.n_links
        pr = self.params(pr)
        S_all, M_all = pr["S"], pr["M"]
        if "Mmul" in pr:
            M_all = M_all[..., None] * pr["Mmul"]  # (nL, 6, 6, B)
        rel_R, rel_p = self._relative_transforms(state.s, pr)
        zb = torch.zeros_like(state.p[0])
        g6 = torch.stack([zb, zb, self._gravity(zb, pr), zb, zb, zb])

        inv_R = [None] * nL
        inv_p = [None] * nL
        for i in range(1, nL):
            inv_R[i], inv_p[i] = _inv_rp(rel_R[i - 1], rel_p[i - 1])

        R0, p0 = W_R[0], W_p[0]
        R0_inv, p0_inv = _inv_rp(R0, p0)

        v = [None] * nL
        c = [None] * nL
        pA = [None] * nL
        MA = [None] * nL
        v[0] = _xv(R0_inv, p0_inv, state.v) if self.floating_base else torch.zeros_like(state.v)

        MA[0] = M_all[0] if "Mmul" in pr else _c(M_all[0])
        pA[0] = _vxstar_Mv(v[0], MA[0])
        if f_ext[0] is not None:
            pA[0] = pA[0] - _xtf(R0, p0, f_ext[0])

        for i in range(1, nL):
            lam = self.lam[i]
            vJ = _c(S_all[i]) * state.sd[i - 1]
            v[i] = _xv(inv_R[i], inv_p[i], v[lam]) + vJ
            c[i] = _vx(v[i], vJ)
            MA[i] = M_all[i] if "Mmul" in pr else _c(M_all[i])
            pA[i] = _vxstar_Mv(v[i], MA[i])
            if f_ext[i] is not None:
                pA[i] = pA[i] - _xtf(W_R[i], W_p[i], f_ext[i])

        U = [None] * nL
        d = [None] * nL
        u = [None] * nL
        for i in range(nL - 1, 0, -1):
            lam = self.lam[i]
            S = _c(S_all[i])
            U[i] = _mv(MA[i], S)
            d[i] = (S * U[i]).sum(0)
            u[i] = tau[i - 1] - (S * pA[i]).sum(0)
            inv_d = 1.0 / d[i]
            Ma, pa = _articulated(MA[i], pA[i], U[i], inv_d, u[i], c[i])
            if lam != 0 or self.floating_base:
                MA[lam], pA[lam] = _to_parent(MA[lam], pA[lam], inv_R[i], inv_p[i], Ma, pa)

        L0 = None
        if self.floating_base:
            L0 = _chol6_factor(MA[0])
            a0 = -_chol6_substitute(L0, pA[0])
        else:
            a0 = -_xv(R0_inv, p0_inv, g6)

        a = [None] * nL
        a[0] = a0
        sdd = [None] * self.n_joints
        for i in range(1, nL):
            lam = self.lam[i]
            a_i = _xv(inv_R[i], inv_p[i], a[lam]) + c[i]
            sdd_i = (u[i] - (U[i] * a_i).sum(0)) / d[i]
            sdd[i - 1] = sdd_i
            a[i] = a_i + _c(S_all[i]) * sdd_i

        W_a = _xv(R0, p0, a0) + g6 if self.floating_base else torch.zeros_like(g6)
        sdd_out = torch.stack(sdd) if sdd else torch.zeros_like(state.s)
        if return_aux:
            return W_a, sdd_out, dict(a=a, U=U, d=d, inv_R=inv_R, inv_p=inv_p, L0=L0)
        return W_a, sdd_out

    # ----- the step -----

    @staticmethod
    def _quat_derivative(q, omega, K: float = 0.0):
        """q̇ = ½ [0, ω] ⊗ q with inertial-fixed ω and, for ``K`` > 0, the
        Baumgarte norm stabilization ½ K ‖ω‖ (1 − ‖q‖) q, as the JAX engine's
        ``_quat_derivative`` (its SIE step takes K = 0, its RK4 derivative
        K = 1)."""
        qw, qx, qy, qz = q[0], q[1], q[2], q[3]
        ox, oy, oz = omega[0], omega[1], omega[2]
        qd = 0.5 * torch.stack(
            [
                -qx * ox - qy * oy - qz * oz,
                qw * ox - qy * oz + qz * oy,
                qw * oy + qx * oz - qz * ox,
                qw * oz - qx * oy + qy * ox,
            ]
        )
        if K:
            nw = torch.sqrt(_maximum(ox * ox + oy * oy + oz * oz, 1e-14))
            nq = torch.sqrt(_maximum((q * q).sum(0), 1e-14))
            qd = qd + (0.5 * K) * (nw * (1.0 - nq)) * q
        return qd

    @staticmethod
    def _normalize_quat(q):
        return q / torch.sqrt(_maximum((q * q).sum(0), 1e-12))

    def _contact_forces(self, state: BatchedState, W_R, W_p, W_v, tau, pr):
        """The contact model's per-link world 6D forces and ṁ at ``state``
        (what RK4-fast freezes): for relaxed-rigid contacts ṁ steers m to
        the solved forces, so the next solve warm-starts from them."""
        if self.contact_model == "relaxed_rigid" and self.n_points > 0:
            f_links, xs = self.relaxed_rigid_contact_forces(state, W_R, W_p, W_v, tau, pr, return_wrenches=True)
            return f_links, (xs - state.m) / self.dt
        return self.soft_contact_forces(W_R, W_p, W_v, state.m, pr)

    def derivatives(self, state: BatchedState, tau=None, pr=None, frozen_contacts=None) -> BatchedState:
        """The continuous-time state derivative ẏ as a :class:`BatchedState`
        of the leaves' rates, as the JAX engine's ``derivatives``:
        ``frozen_contacts`` optionally gives precomputed ``(f_links, ṁ)``
        (RK4-fast's stages); the quaternion's rate carries the Baumgarte
        term with K = 1."""
        pr = self.params(pr)
        tau = tau if tau is not None else torch.zeros_like(state.s)
        W_R, W_p, W_v = self.fk(state, pr)
        if frozen_contacts is not None:
            f_links, md = frozen_contacts
            W_a, sdd = self.aba(state, W_R, W_p, W_v, f_links, tau, pr)
        elif self.contact_model == "relaxed_rigid" and self.n_points > 0:
            W_a, sdd, xs = self.relaxed_rigid_contact_forces(state, W_R, W_p, W_v, tau, pr)
            # Carry the solved forces in m for the next solve's warm start.
            md = (xs - state.m) / self.dt
        else:
            f_links, md = self.soft_contact_forces(W_R, W_p, W_v, state.m, pr)
            W_a, sdd = self.aba(state, W_R, W_p, W_v, f_links, tau, pr)
        omega = state.v[3:6]
        pd = state.v[0:3] + _cross(omega, state.p)
        qd = self._quat_derivative(state.q, omega, K=1.0)
        return BatchedState(s=state.sd, sd=sdd, p=pd, q=qd, v=W_a, m=md)

    def _rk4_step(self, state: BatchedState, tau, pr) -> BatchedState:
        """Classic RK4 from one ``tau``: q normalised first, four
        :meth:`derivatives`, ``(k1 + 2 k2 + 2 k3 + k4) / 6``, q normalised
        last; with ``integrator == "rk4fast"`` the contact forces and ṁ are
        evaluated once, at the normalised start, and frozen for the stages,
        as the JAX engine's ``_rk4_step``."""
        dt = self.dt
        state = dataclasses.replace(state, q=self._normalize_quat(state.q))
        frozen = None
        if self.integrator == "rk4fast" and self.n_points > 0:
            frozen = self._contact_forces(state, *self.fk(state, pr), tau, pr)

        def f(st):
            return self.derivatives(st, tau, pr, frozen_contacts=frozen)

        def axpy(c, k):
            return BatchedState(*(y + c * d for y, d in zip(state.fields(), k.fields())))

        k1 = f(state)
        k2 = f(axpy(0.5 * dt, k1))
        k3 = f(axpy(0.5 * dt, k2))
        k4 = f(axpy(dt, k3))
        comb = BatchedState(
            *((a + 2.0 * b + 2.0 * c + d) / 6.0 for a, b, c, d in zip(k1.fields(), k2.fields(), k3.fields(), k4.fields()))
        )
        new = axpy(dt, comb)
        return dataclasses.replace(new, q=self._normalize_quat(new.q))

    def step(
        self, state: BatchedState, tau: torch.Tensor | None = None, pr=None
    ) -> BatchedState:
        """One step of the engine's integrator (semi-implicit Euler, RK4 or
        RK4-fast) with its contact model. ``pr`` overrides model arrays by
        name (see :meth:`params`) for this step only. A relaxed-rigid step
        differentiates its contact solve implicitly (:class:`_PcgImplicit`)."""
        tau = tau if tau is not None else torch.zeros_like(state.s)
        pr = self.params(pr)
        if self.integrator in ("rk4", "rk4fast"):
            return self._rk4_step(state, tau, pr)

        W_R, W_p, W_v = self.fk(state, pr)
        if self.contact_model == "relaxed_rigid" and self.n_points > 0:
            W_a, sdd, xs = self.relaxed_rigid_contact_forces(state, W_R, W_p, W_v, tau, pr)
            # Carry the solved forces in m for the next step's warm start.
            md = (xs - state.m) / self.dt
        else:
            f_links, md = self.soft_contact_forces(W_R, W_p, W_v, state.m, pr)
            W_a, sdd = self.aba(state, W_R, W_p, W_v, f_links, tau, pr)

        dt = self.dt
        v_new = state.v + dt * W_a
        sd_new = state.sd + dt * sdd

        # The position update uses the NEW linear velocity and the OLD p.
        omega = v_new[3:6]
        pd = v_new[0:3] + _cross(omega, state.p)
        p_new = state.p + dt * pd

        qd = self._quat_derivative(state.q, omega)
        q_new = self._normalize_quat(state.q + dt * qd)

        return BatchedState(
            s=state.s + dt * sd_new,
            sd=sd_new,
            p=p_new,
            q=q_new,
            v=v_new,
            m=state.m + dt * md,
        )

    def rollout(self, state: BatchedState, n_steps: int, policy=None, pr=None, domain=None) -> BatchedState:
        """``n_steps`` of :meth:`step`; ``policy(state) -> (n, B)`` torques,
        by default the PD policy ``-60·s - 0.5·ṡ``; ``pr`` as in :meth:`step`;
        ``domain``, per-env multipliers (:data:`DOMAIN_NAMES`) and on Fourier
        terrain ``terrOff``, merged into ``pr`` (the JAX engine's
        ``rollout(domain=)``)."""
        policy = policy or (lambda st: -60.0 * st.s - 0.5 * st.sd)
        pr = self.params({**(pr or {}), **(domain or {})})
        for _ in range(n_steps):
            state = self.step(state, policy(state), pr)
        return state


def nominal_delassus_blocks(engine: BatchedEngine, arrays: dict) -> np.ndarray:
    """``(nC, 3, 3)`` per-point Delassus blocks ``G_cc = (J M⁻¹ Jᵀ)_cc`` at
    the nominal configuration (zero joints, the base at the origin with the
    identity orientation, zero velocity), symmetrised as ½(K + Kᵀ): the
    block-Jacobi preconditioner's payload of a relaxed-rigid engine on
    Fourier terrain, as the JAX engine's ``_nominal_delassus_blocks`` builds
    it through its CRBA and contact Jacobians. Here it comes from the
    engine's own passes, in float64 on the CPU, from the model ``arrays`` by
    name: the nominal free ABA's factorization (:meth:`BatchedEngine.aba`
    with ``return_aux``), then for each point c and axis j a unit world
    force scattered to the parent link (:meth:`BatchedEngine._rr_scatter`),
    the substitution passes (:meth:`BatchedEngine._minv_apply`) and point
    c's world acceleration gathered (:meth:`BatchedEngine._rr_gather`), the
    3·nC unit forces batched as envs. At zero velocity the product does not
    depend on how the base's velocity is represented."""
    nC = engine.n_points
    B = 3 * nC
    f64 = dict(dtype=torch.float64, device="cpu")
    pr = {k: torch.tensor(np.array(arrays[k]), **f64) for k in engine.PARAM_NAMES}
    zeros = lambda *shape: torch.zeros(shape, **f64)  # noqa: E731
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], **f64)[:, None].repeat(1, B)
    state = BatchedState(s=zeros(engine.n_joints, B), sd=zeros(engine.n_joints, B), p=zeros(3, B), q=q,
                         v=zeros(6, B), m=zeros(engine.m_rows, 3, B))  # fmt: skip
    W_R, W_p, W_v = engine.fk(state, pr)
    _, _, fact = engine.aba(state, W_R, W_p, W_v, [None] * engine.n_links, zeros(engine.n_joints, B), pr,
                            return_aux=True)  # fmt: skip
    Rp = torch.stack([W_R[i] for i in engine.contact_parent], 2)
    Lp = pr["cpoint"].transpose(0, 1)[:, :, None]
    # Env 3c + j carries the unit force along axis j at point c.
    y = torch.eye(B, **f64).reshape(nC, 3, B).transpose(0, 1)  # (3, nC, B)
    a, _ = engine._minv_apply(fact, engine._rr_scatter(Rp, Lp, y), pr)
    acc = engine._rr_gather(Rp, Lp, a)  # (3, nC, B): acc[i, c', 3c + j]
    K = torch.stack([acc[:, c, 3 * c : 3 * c + 3] for c in range(nC)])  # (nC, 3, 3): K[c, i, j]
    return (0.5 * (K + K.transpose(1, 2))).numpy()
