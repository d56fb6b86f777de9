"""Whole-horizon rollout in one CUDA kernel launch (K1).

Counterpart of ``jaxsim_tpu/ops/pallas_step.py::build_pallas_rollout`` and its
``_rollout_kernel``, for two bodies: soft or relaxed-rigid contacts, each on
flat ground with the engine's integrator (semi-implicit Euler, RK4 or
RK4-fast) and the PD policy ``tau = -kp·s - kd·ṡ``, evaluated once a step at
its start. The semi-implicit Euler bodies also take an inclined plane and
Fourier terrain (the relaxed-rigid one with each point's own normal and the
block-Jacobi PCG there), and the JAX kernel's per-env options: ``domain``,
the five multipliers ``Kmul``, ``Dmul``, ``mumul``, ``gmul``, ``Mmul`` (each
``(B,)``, a missing one 1; the relaxed-rigid step reads ``gmul`` and
``Mmul``, its solve the engine's μ, as the JAX engine's), and ``terr_off``
``(2, B)`` on Fourier terrain. The RK4 builds take neither (ROADMAP Queue 2
item 6). The soft kernel is
``jaxsim_tpu_torch/csrc/rollout.cu`` (``LANES`` lanes an env, its state and
the step's working set in shared memory: ``soft_step_lanes.cuh``'s
forward-only slot), the relaxed-rigid one
``jaxsim_tpu_torch/csrc/rollout_rr.cu`` (``RR_LANES`` lanes an env, the
contact solve's working set in shared memory), each built per topology and
integrator; see the notes at their tops. The soft RK4 build holds the
step's start state and the stages' sum in its lanes' registers; the
relaxed-rigid one takes them as two scratch arrays in device memory, which
:func:`launch` allocates.

:func:`rollout` dispatches on the device of the state: a CPU state goes to
:func:`rollout_reference`, the plain version (a loop over
:meth:`BatchedEngine.step`); a CUDA state goes to the kernel, built by
:mod:`jaxsim_tpu_torch.ops.cuda_build` at first use. A failed build or launch
raises; nothing falls back.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .batched_engine import BatchedEngine, BatchedState
from .cuda_build import CSRC, F32, I32, PTR, BuildJob, KernelBuild, packed_params

# Launches of the CUDA kernel made by rollout(), in this process: of its
# soft-contact build, and of its relaxed-rigid build.
ROLLOUT_KERNEL_LAUNCHES = 0
ROLLOUT_RR_KERNEL_LAUNCHES = 0

SOURCE = CSRC / "rollout.cu"
# The entry points' arguments: the model arrays, the state in and out, B and
# the steps, the scalars, the per-env rows (multipliers, terrain offset; null
# where the build takes none), the stream; the relaxed-rigid one's also the
# RK4 scratch before the rows (two pointers and their stride: null and 0 for
# a semi-implicit Euler build).
SIGNATURES = {"jx_rollout": [PTR] * 13 + [I32, I32] + [F32] * 10 + [PTR] * 3, "jx_rollout_geometry": [PTR]}
RR_SOURCE = CSRC / "rollout_rr.cu"
RR_SIGNATURES = {
    "jx_rollout_rr": [PTR] * 13 + [I32, I32] + [F32] * 23 + [PTR, PTR, I32] + [PTR] * 3, "jx_rr_geometry": [PTR],
}
# Lanes of a warp that carry one env in the soft and the relaxed-rigid
# kernel (build-time constants; PERF.md §6 has the times of the counts tried).
LANES = 4
RR_LANES = 8
CONTACT_MODELS = ("soft", "relaxed_rigid")
INTEGRATORS = ("sie", "rk4", "rk4fast")


def job(engine: BatchedEngine, lanes: int | None = None, domain: bool = False, terr_off: bool = False) -> BuildJob:
    """The library for ``engine``: the soft rollout or the relaxed-rigid one,
    with ``lanes`` lanes an env (``LANES`` or ``RR_LANES`` by default); the
    generated header names the engine's integrator and terrain, so each
    builds a library of its own, and so do the per-env options (``domain``:
    ``JX_DOMAIN``, ``terr_off``: ``JX_TERR_OFF``)."""
    options = (("JX_DOMAIN", 1),) * domain + (("JX_TERR_OFF", 1),) * terr_off
    if engine.contact_model == "relaxed_rigid":
        return BuildJob(engine, RR_SOURCE, RR_SIGNATURES, (("JX_RR_LANES", int(lanes or RR_LANES)), *options))
    return BuildJob(engine, SOURCE, SIGNATURES, (("JX_LN_LANES", int(lanes or LANES)), ("JX_LN_FORWARD", 1), *options))


def build(engine: BatchedEngine, domain: bool = False, terr_off: bool = False) -> KernelBuild:
    """Compile (or load from ``BUILD_DIR``) the kernel for ``engine``'s
    topology and the per-env options."""
    return cuda_build.build(job(engine, domain=domain, terr_off=terr_off))


def geometry(kernel: KernelBuild) -> dict[str, int]:
    """The soft kernel's launch: threads and envs a block, the dynamic shared
    memory a block takes in bytes, and the blocks an SM holds at once (CUDA's
    occupancy calculator)."""
    return cuda_build.geometry(kernel, "jx_rollout_geometry")


def lane_local_memory(kernel: KernelBuild) -> dict[str, int]:
    """The local loads and stores (``LDL``, ``STL``) in the SASS of a kernel
    on the forward-only lane step (the soft rollout or the env rollout): in
    all; in the step's tree passes and contact phase (``soft_step_lanes.cuh``
    from fk to the base's SIE) and in the whole step; and in the algebra it
    inlines (``step_env.cuh``, which the line table names for an inlined
    function's instructions)."""
    header = (CSRC / "soft_step_lanes.cuh").read_text().splitlines()

    def line_of(text: str) -> int:
        return next(n for n, ln in enumerate(header, 1) if text in ln)

    return cuda_build.local_memory(kernel, dict(
        passes=("soft_step_lanes.cuh", line_of("// ----- forward kinematics"),
                line_of("// ----- the base's semi-implicit Euler")),
        step=("soft_step_lanes.cuh", 1, 10**6),
        algebra=("step_env.cuh", 1, 10**6),
    ))  # fmt: skip


def rr_geometry(kernel: KernelBuild) -> dict[str, int]:
    """The relaxed-rigid kernel's launch: threads and envs a block, the
    dynamic shared memory a block takes in bytes, and the blocks an SM holds
    at once (CUDA's occupancy calculator)."""
    return cuda_build.geometry(kernel, "jx_rr_geometry")


def rr_local_memory(kernel: KernelBuild) -> dict[str, int]:
    """The local loads and stores (``LDL``, ``STL``) in the relaxed-rigid
    kernel's SASS: in all, in the M⁻¹Jᵀ pass (``rr_scatter``, ``rr_minv``,
    ``rr_gather`` of ``rr_step.cuh``), in the CG loop around it (``rr_cg``),
    and in the free ABA on the lanes (``rr_free_body``; its local arrays s,
    sd and sdd included)."""
    header = (CSRC / "rr_step.cuh").read_text().splitlines()

    def line_of(text: str) -> int:
        return next(n for n, ln in enumerate(header, 1) if text in ln)

    return cuda_build.local_memory(kernel, dict(
        passes=("rr_step.cuh", line_of("void rr_scatter("), line_of("float rr_prec(")),
        cg_loop=("rr_step.cuh", line_of("void rr_cg("), line_of("void rr_solve(")),
        free_aba=("rr_step.cuh", line_of("// ----- the free ABA on the env's lanes"),
                  line_of("// ----- the forward step: the state on the lanes")),
    ))  # fmt: skip


def rollout_reference(
    engine: BatchedEngine, state: BatchedState, n_steps: int, kp: float = 60.0, kd: float = 0.5, domain=None,
    terr_off=None,
) -> BatchedState:
    """The plain version: ``n_steps`` of the twin's step (its integrator's)
    under the PD policy, with the per-env ``domain`` and ``terr_off``."""
    domain = {**(domain or {}), **({} if terr_off is None else {"terrOff": terr_off})}
    return engine.rollout(state, n_steps, policy=lambda st: -kp * st.s - kd * st.sd, domain=domain)


def rk4_scratch(engine: BatchedEngine, B: int) -> tuple[torch.Tensor | None, int]:
    """A relaxed-rigid RK4 launch's scratch in device memory, the step's
    start state and the stages' sum, each with a column for every env of
    the launch's blocks (``B`` and the last block's envs past it), and its
    stride; None and 0 for a semi-implicit Euler engine."""
    if engine.integrator == "sie":
        return None, 0
    stride = B + cuda_build.RR_MAX_ENVS
    rows = 2 * engine.n_joints + 13 + 3 * engine.m_rows
    return torch.empty((2, rows, stride), dtype=engine.S.dtype, device=engine.S.device), stride


def launch(
    kernel: KernelBuild, engine: BatchedEngine, state: BatchedState, n_steps: int, kp: float, kd: float, mul=None,
    off=None,
):
    """One launch of ``kernel`` (the engine's rollout library, or a variant
    of it built from another source) on a checked CUDA state, with the
    build's checked per-env rows ``mul`` and ``off``
    (:func:`cuda_build.domain_rows`); counts nothing."""
    relaxed = engine.contact_model == "relaxed_rigid"
    out = cuda_build.empty_state_like(state)
    B = state.p.shape[-1]
    rows = tuple(None if t is None else t.data_ptr() for t in (mul, off))
    if relaxed:
        scratch, stride = rk4_scratch(engine, B)
        y0, acc = (0, 0) if scratch is None else (scratch[0].data_ptr(), scratch[1].data_ptr())
        rr_args = (*cuda_build.rr_scalars(engine), y0, acc, stride, *rows)
    else:
        rr_args = rows
    cuda_build.launch(
        kernel, "jx_rollout_rr" if relaxed else "jx_rollout", packed_params(engine), state.p.device,
        *cuda_build.state_pointers(state), *cuda_build.state_pointers(out),
        B, int(n_steps), *cuda_build.engine_scalars(engine), float(kp), float(kd), *rr_args,
    )  # fmt: skip
    return out


def rollout(
    engine: BatchedEngine, state: BatchedState, n_steps: int, kp: float = 60.0, kd: float = 0.5, domain=None,
    terr_off=None,
) -> BatchedState:
    """Advance every env ``n_steps`` under ``tau = -kp·s - kd·ṡ`` with the
    engine's integrator, with the per-env ``domain`` multipliers (each
    ``(B,)``, float32 on the state's device; a missing one is 1) and on
    Fourier terrain ``terr_off`` ``(2, B)``: in one CUDA kernel launch for a
    CUDA state, with the plain version for a CPU state."""
    global ROLLOUT_KERNEL_LAUNCHES, ROLLOUT_RR_KERNEL_LAUNCHES
    if cuda_build.is_cpu(state, "rollout"):
        return rollout_reference(engine, state, n_steps, kp, kd, domain, terr_off)
    B = cuda_build.check_cuda_call(engine, state, CONTACT_MODELS, INTEGRATORS, cuda_build.TERRAINS)
    mul, off = cuda_build.domain_rows(engine, B, domain, terr_off, engine.S.device)
    out = launch(build(engine, mul is not None, off is not None), engine, state, n_steps, kp, kd, mul, off)
    if engine.contact_model == "relaxed_rigid":
        ROLLOUT_RR_KERNEL_LAUNCHES += 1
    else:
        ROLLOUT_KERNEL_LAUNCHES += 1
    return out
