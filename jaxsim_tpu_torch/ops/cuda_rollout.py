"""Whole-horizon rollout in one CUDA kernel launch (K1).

Counterpart of ``jaxsim_tpu/ops/pallas_step.py::build_pallas_rollout`` and its
``_rollout_kernel``, for two bodies: soft or relaxed-rigid contacts, each on
flat ground with semi-implicit Euler and the PD policy ``tau = -kp·s - kd·ṡ``,
without per-env options. The soft kernel is
``jaxsim_tpu_torch/csrc/rollout.cu`` (one thread an env), the relaxed-rigid
one ``jaxsim_tpu_torch/csrc/rollout_rr.cu`` (``RR_LANES`` lanes an env, the
contact solve's working set in shared memory), each built per topology; see
the notes at their tops.

:func:`rollout` dispatches on the device of the state: a CPU state goes to
:func:`rollout_reference`, the plain version (a loop over
:meth:`BatchedEngine.step`); a CUDA state goes to the kernel, built by
:mod:`jaxsim_tpu_torch.ops.cuda_build` at first use. A failed build or launch
raises; nothing falls back.
"""

from __future__ import annotations

from . import cuda_build
from .batched_engine import BatchedEngine, BatchedState
from .cuda_build import CSRC, F32, I32, PTR, BuildJob, KernelBuild, packed_params

# Launches of the CUDA kernel made by rollout(), in this process: of its
# soft-contact build, and of its relaxed-rigid build.
ROLLOUT_KERNEL_LAUNCHES = 0
ROLLOUT_RR_KERNEL_LAUNCHES = 0

SOURCE = CSRC / "rollout.cu"
SIGNATURES = {"jx_rollout": [PTR] * 13 + [I32, I32] + [F32] * 10 + [PTR]}
RR_SOURCE = CSRC / "rollout_rr.cu"
RR_SIGNATURES = {"jx_rollout_rr": [PTR] * 13 + [I32, I32] + [F32] * 23 + [PTR], "jx_rr_geometry": [PTR]}
# Lanes of a warp that carry one env in the relaxed-rigid kernel (a
# build-time constant; PERF.md §6 has the times of 1, 4 and 8).
RR_LANES = 8
CONTACT_MODELS = ("soft", "relaxed_rigid")


def job(engine: BatchedEngine, lanes: int = RR_LANES) -> BuildJob:
    """The library for ``engine``: the soft rollout, or the relaxed-rigid one
    with ``lanes`` lanes an env."""
    if engine.contact_model == "relaxed_rigid":
        return BuildJob(engine, RR_SOURCE, RR_SIGNATURES, (("JX_RR_LANES", int(lanes)),))
    return BuildJob(engine, SOURCE, SIGNATURES)


def build(engine: BatchedEngine) -> KernelBuild:
    """Compile (or load from ``BUILD_DIR``) the kernel for ``engine``'s topology."""
    return cuda_build.build(job(engine))


def rr_geometry(kernel: KernelBuild) -> dict[str, int]:
    """The relaxed-rigid kernel's launch: threads and envs a block, the
    dynamic shared memory a block takes in bytes, and the blocks an SM holds
    at once (CUDA's occupancy calculator)."""
    return cuda_build.geometry(kernel, "jx_rr_geometry")


def rr_local_memory(kernel: KernelBuild) -> dict[str, int]:
    """The local loads and stores (``LDL``, ``STL``) in the relaxed-rigid
    kernel's SASS: in all, in the M⁻¹Jᵀ pass (``rr_scatter``, ``rr_minv``,
    ``rr_gather`` of ``rr_step.cuh``), and in the CG loop around it."""
    header = (CSRC / "rr_step.cuh").read_text().splitlines()

    def line_of(text: str) -> int:
        return next(n for n, ln in enumerate(header, 1) if text in ln)

    return cuda_build.local_memory(kernel, dict(
        passes=("rr_step.cuh", line_of("void rr_scatter("), line_of("float rr_prec(")),
        cg_loop=("rr_step.cuh", line_of("for (int it = -1; it <= JX_RR_ITERS; ++it)"),
                 line_of("// m <- the solved forces")),
    ))  # fmt: skip


def rollout_reference(
    engine: BatchedEngine, state: BatchedState, n_steps: int, kp: float = 60.0, kd: float = 0.5
) -> BatchedState:
    """The plain version: ``n_steps`` of the twin's step under the PD policy."""
    return engine.rollout(state, n_steps, policy=lambda st: -kp * st.s - kd * st.sd)


def launch(kernel: KernelBuild, engine: BatchedEngine, state: BatchedState, n_steps: int, kp: float, kd: float):
    """One launch of ``kernel`` (the engine's rollout library, or a variant
    of it built from another source) on a checked CUDA state; counts nothing."""
    relaxed = engine.contact_model == "relaxed_rigid"
    out = cuda_build.empty_state_like(state)
    cuda_build.launch(
        kernel, "jx_rollout_rr" if relaxed else "jx_rollout", packed_params(engine), state.p.device,
        *cuda_build.state_pointers(state), *cuda_build.state_pointers(out),
        state.p.shape[-1], int(n_steps), *cuda_build.engine_scalars(engine), float(kp), float(kd),
        *(cuda_build.rr_scalars(engine) if relaxed else ()),
    )  # fmt: skip
    return out


def rollout(
    engine: BatchedEngine, state: BatchedState, n_steps: int, kp: float = 60.0, kd: float = 0.5
) -> BatchedState:
    """Advance every env ``n_steps`` under ``tau = -kp·s - kd·ṡ``: in one CUDA
    kernel launch for a CUDA state, with the plain version for a CPU state."""
    global ROLLOUT_KERNEL_LAUNCHES, ROLLOUT_RR_KERNEL_LAUNCHES
    if cuda_build.is_cpu(state, "rollout"):
        return rollout_reference(engine, state, n_steps, kp, kd)
    cuda_build.check_cuda_call(engine, state, CONTACT_MODELS)
    out = launch(build(engine), engine, state, n_steps, kp, kd)
    if engine.contact_model == "relaxed_rigid":
        ROLLOUT_RR_KERNEL_LAUNCHES += 1
    else:
        ROLLOUT_KERNEL_LAUNCHES += 1
    return out
