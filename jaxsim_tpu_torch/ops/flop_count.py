"""Count the floating-point operations a plain PyTorch function needs.

Used for the kernels' bounds (the least time the card could take for a
kernel's work). A kernel computes what its plain version computes, so the
plain version's arithmetic, run under a ``TorchDispatchMode`` on the data of
a run, counts the work, with what that work does not need taken out:

* a product with an operand that is exactly 0, 1 or -1, and a sum or
  difference with an operand that is exactly 0, cost nothing (the structural
  zeros of the spatial algebra: the zero block of a motion transform, the
  zero diagonal of a cross-product matrix, the unit entries of a joint's
  motion subspace; and the zeros of the data, such as the forces of points
  out of contact);
* a sum costs one operation per nonzero term it folds in after the first;
* a negation costs nothing (it is an operand modifier on the card);
* the other elementwise arithmetic costs one operation per output element,
  a sine or a cosine (the Fourier terrain's, a revolute joint's) one like a
  product; copies, views, selections, comparisons and integer ops cost
  nothing.

:func:`least_step_ops` also counts the articulated-body algorithm's second
pass in its least algebra: the twin forms each link's articulated inertia
``Mₐ`` in full and moves it to the parent as the dense 6×6 product
``Xᵀ Mₐ X``; :func:`articulated_least` and :func:`to_parent_least` form the
21 distinct entries once and use the (R, p) form. It takes out the twin's
second pass over the joint transforms, which the kernels do not make. Left
in: the soft contact model's candidate results, computed for every point and
then selected (three ṁ and the slip scaling). A relaxed-rigid step is counted
the same way; its contact solve's work depends on the data through the
points out of contact, whose activity 0 makes their share of each M⁻¹Jᵀ pass
a product with 0. An RK4 step is four of the twin's derivatives and their
sums, an RK4-fast step the same with the contact forces evaluated once; each
derivative's ABA reuses its forward kinematics' joint transforms, and
RK4-fast's contact evaluation the first stage's forward kinematics. A step on
rough terrain or with per-env multipliers (:func:`least_rollout_step_ops`)
counts the terrain's sines and cosines at every point and the multipliers'
products, each env's rows sliced with its state.
"""

from __future__ import annotations

import collections
import numbers
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import batched_engine
from .batched_engine import BatchedEngine, BatchedState, _mm, _mtv, _mv, _skew, _xtf

ELEMENTWISE = frozenset(
    "reciprocal pow sqrt rsqrt sin cos tanh exp abs clamp clamp_min clamp_max maximum minimum".split()
)
MUL, ADD, DIV = frozenset(("mul",)), frozenset(("add", "sub", "rsub")), frozenset(("div",))
REDUCTIONS = frozenset(("sum",))


def _mask(x, shape, skip_units: bool) -> torch.Tensor:
    """Where operand ``x`` (a tensor or a number), broadcast to ``shape``,
    makes an operation needed: it is not 0 (nor ±1 with ``skip_units``)."""
    x = x if isinstance(x, torch.Tensor) else torch.tensor(float(x))
    needed = x != 0
    if skip_units:
        needed = needed & (x.abs() != 1)
    return torch.broadcast_to(needed, shape)


def _operand(x) -> bool:
    return isinstance(x, (torch.Tensor, numbers.Number)) and not isinstance(x, bool)


class FlopCounter(TorchDispatchMode):
    """Counts the operations a computation needs, by aten op name, while
    active (the rules are in the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.by_op: collections.Counter[str] = collections.Counter()

    @property
    def total(self) -> int:
        return sum(self.by_op.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__.rstrip("_")
        if not (isinstance(out, torch.Tensor) and out.dtype.is_floating_point):
            return out
        if name in MUL | ADD | DIV and len(args) >= 2 and _operand(args[1]):
            a, b = args[0], args[1]
            if name in MUL:
                needed = _mask(a, out.shape, True) & _mask(b, out.shape, True)
            elif name in ADD:
                needed = _mask(a, out.shape, False) & _mask(b, out.shape, False)
            else:
                needed = _mask(a, out.shape, False) & _mask(b, out.shape, True)
            self.by_op[name] += int(needed.sum())
        elif name in REDUCTIONS:
            terms = func((args[0] != 0).to(torch.float64), *args[1:], **{**kwargs, "dtype": torch.float64})
            self.by_op[name] += int((terms - 1).clamp(min=0).sum())
        elif name in ELEMENTWISE:
            self.by_op[name] += out.numel()
        return out


def count_flops(fn, *args, **kwargs) -> int:
    """Operations that ``fn(*args, **kwargs)`` needs."""
    with FlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.total


def head(state: BatchedState, k: int) -> BatchedState:
    """The first ``k`` envs of ``state``."""
    return BatchedState(*(t[..., :k] for t in state.fields()))


def ops_per_env(fn, state: BatchedState, n: int | None = None) -> float:
    """Operations ``fn(state)`` needs per env, averaged over envs 1..n of
    ``state`` (all but the first by default): the count at ``n + 1`` envs
    minus the count at one, over ``n``. Work that does not grow with the batch
    (the twin's model-constant algebra, which the kernels redo per env) drops
    out, so the count stays a lower bound."""
    n = state.p.shape[-1] - 1 if n is None else n
    return (count_flops(fn, head(state, n + 1)) - count_flops(fn, head(state, 1))) / n


# ----- ABA pass 2 at one link, in its least algebra -----


def _sym(entries):
    """A symmetric (3,3,*b) matrix from its upper entries ``{(i, j): x}``."""
    return torch.stack([torch.stack([entries[min(i, j), max(i, j)] for j in range(3)]) for i in range(3)])


UPPER = [(i, j) for i in range(3) for j in range(i, 3)]


def articulated_least(MA, pA, U, inv_d, u, c):
    """:func:`batched_engine._articulated` with ``Mₐ``'s 21 distinct entries
    formed once."""
    Ud = U * inv_d
    upper = {(i, j): MA[i, j] - Ud[i] * U[j] for i in range(6) for j in range(i, 6)}
    Ma = torch.stack([torch.stack([upper[min(i, j), max(i, j)] for j in range(6)]) for i in range(6)])
    return Ma, pA + _mv(Ma, c) + U * (u * inv_d)


def to_parent_least(MA_parent, pA_parent, R, p, Ma, pa):
    """:func:`batched_engine._to_parent` in the (R, p) form, each symmetric
    block's six distinct entries computed once: with ``Mₐ = [[A, B], [Bᵀ, C]]``,
    ``r = Rᵀp``, ``A₁ = RᵀAR``, ``B₁ = RᵀBR``, ``C₁ = RᵀCR`` and ``T = A₁r̂ + B₁``,
    ``Xᵀ Mₐ X = [[A₁, T], [Tᵀ, C₁ + B₁ᵀr̂ − r̂T]]``; the force is ``_xtf``."""

    def rotate_sym(S):  # RᵀSR, six entries
        SR = _mm(S, R)
        return _sym({(i, j): (R[:, i] * SR[:, j]).sum(0) for i, j in UPPER})

    A1, C1 = rotate_sym(Ma[:3, :3]), rotate_sym(Ma[3:, 3:])
    B1 = _mm(R.transpose(0, 1), _mm(Ma[:3, 3:], R))
    rx = _skew(_mtv(R, p))
    T = _mm(A1, rx) + B1
    BR = _sym({
        (i, j): C1[i, j] + (B1[:, i] * rx[:, j]).sum(0) - (rx[i, :] * T[:, j]).sum(0) for i, j in UPPER
    })  # fmt: skip
    upper = {**{(i, j): A1[i, j] for i, j in UPPER}, **{(i + 3, j + 3): BR[i, j] for i, j in UPPER},
             **{(i, j + 3): T[i, j] for i in range(3) for j in range(3)}}  # fmt: skip
    new = {k: MA_parent[k] + x for k, x in upper.items()}
    MA = torch.stack([torch.stack([new[min(i, j), max(i, j)] for j in range(6)]) for i in range(6)])
    return MA, pA_parent + _xtf(R, p, pa)


def least_step_ops(engine: BatchedEngine, fn, state: BatchedState, n: int | None = None, pr=None) -> float:
    """Operations per env of ``fn(state)``, a function that makes one twin
    step per env with the model arrays ``pr`` (with whatever surrounds the
    step), counted with ABA pass 2 in its least algebra
    (:func:`articulated_least`, :func:`to_parent_least`) and without what
    the twin computes twice and the kernels once: each ABA's pass over the
    joint transforms, which its forward kinematics made, and RK4-fast's
    forward kinematics at the step's start, which its first stage makes."""
    calls = collections.Counter()

    def counted(name, f):
        def call(*args, **kwargs):
            calls[name] += 1
            return f(*args, **kwargs)

        return call

    with mock.patch.object(batched_engine, "_articulated", articulated_least), \
            mock.patch.object(batched_engine, "_to_parent", to_parent_least), \
            mock.patch.object(engine, "aba", counted("aba", engine.aba)):  # fmt: skip
        ops = ops_per_env(fn, state, n)
    transforms = ops_per_env(lambda st: engine._relative_transforms(st.s, engine.params(pr)), state, n)
    ops -= calls["aba"] // 2 * transforms  # ops_per_env runs fn twice
    if engine.integrator == "rk4fast" and engine.n_points:
        ops -= ops_per_env(lambda st: engine.fk(st, pr), state, n)
    return ops


def least_rollout_step_ops(
    engine: BatchedEngine, state: BatchedState, n: int | None = None, domain=None, terr_off=None, kp=60.0, kd=0.5
) -> float:
    """:func:`least_step_ops` of one step of K1's plain version under the PD
    policy, with the per-env ``domain`` multipliers and ``terr_off`` (rows
    over ``state``'s envs, sliced with it)."""
    from .cuda_rollout import rollout_reference

    def step(st):
        k = st.p.shape[-1]
        dom = None if domain is None else {name: t[..., :k] for name, t in domain.items()}
        off = None if terr_off is None else terr_off[..., :k]
        return rollout_reference(engine, st, 1, kp, kd, dom, off)

    return least_step_ops(engine, step, state, n)


def least_vjp_ops(
    engine: BatchedEngine, state: BatchedState, tau, ct: BatchedState, n: int | None = None, params_grad=False
) -> float:
    """Operations per env of one step's VJP at ``(state, tau)`` for the
    output cotangent ``ct`` (K4's work: the step and its transpose), counted
    on its plain version as :func:`least_step_ops` counts the step: ABA pass
    2 in its least algebra, forward and transposed, and without the twin's
    second pass over the joint transforms, forward and transposed, which the
    kernel does not make."""
    from .cuda_step_vjp import step_vjp_reference

    n = state.p.shape[-1] - 1 if n is None else n
    tensors = [*state.fields(), tau, *ct.fields()]

    def per_env(fn):
        return (count_flops(fn, *(t[..., : n + 1] for t in tensors)) - count_flops(fn, *(t[..., :1] for t in tensors))) / n

    def vjp(*x):
        return step_vjp_reference(engine, BatchedState(*x[:6]), x[6], BatchedState(*x[7:]), params_grad=params_grad)

    gen = torch.Generator().manual_seed(0)

    def transforms_vjp(s, *_):
        with torch.enable_grad():
            s = s.detach().requires_grad_()
            outs = [t for pair in zip(*engine._relative_transforms(s, engine.params())) for t in pair]
            cts = [torch.randn(t.shape, generator=gen, dtype=t.dtype) for t in outs]
            return torch.autograd.grad(outs, s, cts)

    with mock.patch.object(batched_engine, "_articulated", articulated_least), \
            mock.patch.object(batched_engine, "_to_parent", to_parent_least):  # fmt: skip
        ops = per_env(vjp)
    return ops - per_env(transforms_vjp)


def generic_arrays(engine: BatchedEngine, seed: int = 0) -> dict[str, torch.Tensor]:
    """Model arrays of ``engine``'s shapes and dtype with no zero or unit
    entry by construction: motion subspaces, inertias (symmetric), joint axes
    (unit) and contact points in general directions, and joint frames with
    general rotations. Counted with them in ``pr``, a step keeps only the
    algebra's own zeros, not the model's."""
    gen = torch.Generator().manual_seed(seed)
    own = engine.params()

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    def frames(k):
        H = torch.zeros(k, 4, 4, dtype=torch.float64)
        H[:, :3, :3] = torch.linalg.qr(rand(k, 3, 3)).Q
        H[:, :3, 3], H[:, 3, 3] = rand(k, 3), 1.0
        return H

    M = rand(*own["M"].shape)
    axis = rand(*own["axis"].shape)
    arrays = dict(
        S=rand(*own["S"].shape),
        M=M + M.transpose(1, 2),
        axis=axis / axis.norm(dim=-1, keepdim=True),
        lamH=frames(own["lamH"].shape[0]),
        sucH=frames(own["sucH"].shape[0]),
        cpoint=rand(*own["cpoint"].shape),
    )
    return {k: v.to(own[k].dtype) for k, v in arrays.items()}
