"""Whole-horizon rollout in one CUDA kernel launch (K1).

Counterpart of ``jaxsim_tpu/ops/pallas_step.py::build_pallas_rollout`` and its
``_rollout_kernel``, for two bodies: soft or relaxed-rigid contacts, each on
flat ground with semi-implicit Euler and the PD policy ``tau = -kp·s - kd·ṡ``,
without per-env options. The kernel is ``jaxsim_tpu_torch/csrc/rollout.cu``,
built per topology and contact model; see the note at its top.

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
SIGNATURES = {"jx_rollout": [PTR] * 13 + [I32, I32] + [F32] * 23 + [PTR]}
CONTACT_MODELS = ("soft", "relaxed_rigid")


def job(engine: BatchedEngine) -> BuildJob:
    return BuildJob(engine, SOURCE, SIGNATURES)


def build(engine: BatchedEngine) -> KernelBuild:
    """Compile (or load from ``BUILD_DIR``) the kernel for ``engine``'s topology."""
    return cuda_build.build(job(engine))


def rollout_reference(
    engine: BatchedEngine, state: BatchedState, n_steps: int, kp: float = 60.0, kd: float = 0.5
) -> BatchedState:
    """The plain version: ``n_steps`` of the twin's step under the PD policy."""
    return engine.rollout(state, n_steps, policy=lambda st: -kp * st.s - kd * st.sd)


def rollout(
    engine: BatchedEngine, state: BatchedState, n_steps: int, kp: float = 60.0, kd: float = 0.5
) -> BatchedState:
    """Advance every env ``n_steps`` under ``tau = -kp·s - kd·ṡ``: in one CUDA
    kernel launch for a CUDA state, with the plain version for a CPU state."""
    global ROLLOUT_KERNEL_LAUNCHES, ROLLOUT_RR_KERNEL_LAUNCHES
    if cuda_build.is_cpu(state, "rollout"):
        return rollout_reference(engine, state, n_steps, kp, kd)
    B = cuda_build.check_cuda_call(engine, state, CONTACT_MODELS)
    kernel = build(engine)
    out = cuda_build.empty_state_like(state)
    cuda_build.launch(
        kernel, "jx_rollout", packed_params(engine), state.p.device,
        *cuda_build.state_pointers(state), *cuda_build.state_pointers(out),
        B, int(n_steps), *cuda_build.engine_scalars(engine), float(kp), float(kd),
        *cuda_build.rr_scalars(engine),
    )  # fmt: skip
    if engine.contact_model == "relaxed_rigid":
        ROLLOUT_RR_KERNEL_LAUNCHES += 1
    else:
        ROLLOUT_KERNEL_LAUNCHES += 1
    return out
