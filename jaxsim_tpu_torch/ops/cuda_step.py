"""One engine step per CUDA kernel launch (K2 and K3).

Counterparts of ``jaxsim_tpu/ops/pallas_step.py``:

* :func:`step_pd` of ``build_pallas_step`` (``_step_kernel``, K2) under its
  default closure, the PD policy ``tau = -kp·s - kd·ṡ``. CUDA expresses no
  other closure: a Python ``policy`` on a CUDA state raises.
* :func:`step_tau` of ``build_pallas_step_tau`` (``_step_tau_kernel``, K3):
  torques as an input, and ``pr``, the model arrays by name, at call time.
  The arrays are packed into the kernel's parameter buffer on every call,
  so a changed ``M`` needs no rebuild.
* :func:`rollout_per_step` of ``pallas_rollout``: one K2 launch a step.

For soft contacts both kernels are ``jaxsim_tpu_torch/csrc/step.cu``: each
env on ``LANES`` lanes of a warp, ``ENVS`` envs a block, on the lane-spread
soft step's forward-only slot (``soft_step_lanes.cuh``), the state read from
device columns into the block's slots and written back out. For
relaxed-rigid contacts K2 is K1-rr (``cuda_rollout``'s relaxed-rigid build,
``jaxsim_tpu_torch/csrc/rollout_rr.cu``) launched for one step, and K3 is
``jaxsim_tpu_torch/csrc/step_rr.cu``: K1-rr's step (``rr_step.cuh``) once,
on K1-rr's geometry (``RR_LANES`` lanes an env, the envs a block that fit,
up to 64), with a torque row in each env's slot. See the notes at the tops
of the sources. Each wrapper takes its plain
version (:func:`step_pd_reference`, :func:`step_tau_reference`, which call
the twin) for a CPU state and its kernel for a CUDA state; a failed build or
launch raises. Both take semi-implicit Euler only, on flat ground, an
inclined plane or Fourier terrain, without per-env options, as the JAX
kernels (a ``pr`` with domain multipliers or ``terrOff`` runs on the CPU
only).
"""

from __future__ import annotations

from . import cuda_build, cuda_rollout
from .batched_engine import BatchedEngine, BatchedState
from .cuda_build import CSRC, F32, I32, PTR, BuildJob, KernelBuild, packed_params

# Launches of each CUDA kernel made by the wrappers below, in this process:
# of the soft build, and of the relaxed-rigid one.
STEP_PD_KERNEL_LAUNCHES = 0
STEP_TAU_KERNEL_LAUNCHES = 0
STEP_PD_RR_KERNEL_LAUNCHES = 0
STEP_TAU_RR_KERNEL_LAUNCHES = 0

SOURCE = CSRC / "step.cu"
SIGNATURES = {
    "jx_step_pd": [PTR] * 13 + [I32] + [F32] * 10 + [PTR],
    "jx_step_tau": [PTR] * 14 + [I32] + [F32] * 8 + [PTR],
    "jx_step_geometry": [PTR],
}
# Build-time constants (PERF.md §6 has the times of the choices tried,
# ``chip_probe.py step``): lanes of a warp that carry one env, and envs a
# block (``cuda_build.lane_tables`` halves them until the block fits).
LANES = 8
ENVS = 32
RR_SOURCE = CSRC / "step_rr.cu"
# The relaxed-rigid K3's arguments: the soft one's and the relaxed-rigid
# tail of the scalars (cuda_build.rr_scalars).
RR_SIGNATURES = {"jx_step_tau_rr": [PTR] * 14 + [I32] + [F32] * 21 + [PTR], "jx_step_rr_geometry": [PTR]}
# Lanes an env of the relaxed-rigid build: K1-rr's.
RR_LANES = cuda_rollout.RR_LANES


def job(engine: BatchedEngine, lanes: int | None = None, envs: int | None = None) -> BuildJob:
    """The library for ``engine``, with ``lanes`` lanes an env and ``envs``
    envs a block (the module's constants by default; for a relaxed-rigid
    engine, K3 alone, with the most envs up to ``envs`` that fit, 64 by
    default)."""
    if engine.contact_model == "relaxed_rigid":
        defines = (("JX_RR_LANES", int(lanes or RR_LANES)), ("JX_RR_TAU_ROW", 1))
        return BuildJob(engine, RR_SOURCE, RR_SIGNATURES, defines + ((("JX_RR_MAX_ENVS", int(envs)),) if envs else ()))
    return BuildJob(engine, SOURCE, SIGNATURES, (
        ("JX_LN_LANES", int(lanes or LANES)), ("JX_LN_FORWARD", 1), ("JX_STEP_ENVS", int(envs or ENVS)),
    ))  # fmt: skip


def block_envs(engine: BatchedEngine, lanes: int) -> list[int]:
    """The envs a block that a build may take at ``lanes`` lanes an env:
    one warp's (32 / ``lanes``), doubled while the block fits in shared
    memory (``cuda_build.lane_tables``), has at most 1024 threads and at
    most 128 envs (a batch of 1024 then still makes 8 blocks)."""
    envs, out = 32 // lanes, []
    while envs * lanes <= 1024 and envs <= 128:
        t = cuda_build.lane_tables(engine, lanes, forward=True, step_envs=envs)
        if t["envs"] != envs:
            break
        out.append(envs)
        envs *= 2
    return out


def build(engine: BatchedEngine) -> KernelBuild:
    return cuda_build.build(job(engine))


def geometry(kernel: KernelBuild) -> dict[str, int]:
    """The kernels' launch: threads and envs a block, the dynamic shared
    memory a block takes in bytes, and the blocks an SM holds at once (CUDA's
    occupancy calculator)."""
    relaxed = hasattr(kernel.lib, "jx_step_rr_geometry")
    return cuda_build.geometry(kernel, "jx_step_rr_geometry" if relaxed else "jx_step_geometry")


def step_pd_reference(
    engine: BatchedEngine, state: BatchedState, kp: float = 60.0, kd: float = 0.5
) -> BatchedState:
    """The plain version of K2: the twin's step under the PD policy."""
    return engine.step(state, -kp * state.s - kd * state.sd)


def step_tau_reference(
    engine: BatchedEngine, state: BatchedState, tau, pr=None
) -> BatchedState:
    """The plain version of K3: the twin's step with ``tau`` and ``pr``."""
    return engine.step(state, tau, pr)


def launch_pd(kernel: KernelBuild, engine: BatchedEngine, state: BatchedState, kp: float, kd: float) -> BatchedState:
    """One soft K2 launch of ``kernel`` (the engine's library, or a variant
    of it built from another source) on a checked CUDA state; counts
    nothing."""
    out = cuda_build.empty_state_like(state)
    cuda_build.launch(
        kernel, "jx_step_pd", packed_params(engine), state.p.device,
        *cuda_build.state_pointers(state), *cuda_build.state_pointers(out),
        state.p.shape[-1], *cuda_build.engine_scalars(engine), float(kp), float(kd),
    )  # fmt: skip
    return out


def launch_tau(kernel: KernelBuild, engine: BatchedEngine, state: BatchedState, tau, params) -> BatchedState:
    """One K3 launch of ``kernel`` on a checked CUDA state, checked torques
    and packed model arrays ``params``; counts nothing."""
    relaxed = engine.contact_model == "relaxed_rigid"
    out = cuda_build.empty_state_like(state)
    cuda_build.launch(
        kernel, "jx_step_tau_rr" if relaxed else "jx_step_tau", params, state.p.device,
        *cuda_build.state_pointers(state), tau.data_ptr(), *cuda_build.state_pointers(out),
        state.p.shape[-1], *cuda_build.engine_scalars(engine), *(cuda_build.rr_scalars(engine) if relaxed else ()),
    )  # fmt: skip
    return out


def step_pd(
    engine: BatchedEngine, state: BatchedState, kp: float = 60.0, kd: float = 0.5
) -> BatchedState:
    """One step under ``tau = -kp·s - kd·ṡ``: one K2 launch for a CUDA state
    (for a relaxed-rigid engine, K1-rr's for one step), the plain version for
    a CPU state."""
    global STEP_PD_KERNEL_LAUNCHES, STEP_PD_RR_KERNEL_LAUNCHES
    if cuda_build.is_cpu(state, "step"):
        return step_pd_reference(engine, state, kp, kd)
    cuda_build.check_cuda_call(engine, state, cuda_rollout.CONTACT_MODELS, terrains=cuda_build.TERRAINS)
    if engine.contact_model == "relaxed_rigid":
        out = cuda_rollout.launch(cuda_rollout.build(engine), engine, state, 1, kp, kd)
        STEP_PD_RR_KERNEL_LAUNCHES += 1
    else:
        out = launch_pd(build(engine), engine, state, kp, kd)
        STEP_PD_KERNEL_LAUNCHES += 1
    return out


def step_tau(
    engine: BatchedEngine, state: BatchedState, tau, pr=None
) -> BatchedState:
    """One step with torques ``tau (n_joints, B)`` and the model arrays
    overridden by ``pr`` (see :meth:`BatchedEngine.params`): one K3 launch
    for a CUDA state, the plain version for a CPU state."""
    global STEP_TAU_KERNEL_LAUNCHES, STEP_TAU_RR_KERNEL_LAUNCHES
    if cuda_build.is_cpu(state, "step"):
        return step_tau_reference(engine, state, tau, pr)
    B = cuda_build.check_cuda_call(engine, state, cuda_rollout.CONTACT_MODELS, terrains=cuda_build.TERRAINS)
    cuda_build.check_tensor("tau", tau, (engine.n_joints, B), engine.S.device)
    per_env = sorted(set(pr or {}) - set(engine.PARAM_NAMES))
    if per_env:
        raise ValueError(
            f"K3 takes the model arrays as pr, not per-env options {per_env}, as the JAX kernel"
            f" ({cuda_build.ITEM_VARIANTS})"
        )
    for name, t in (pr or {}).items():
        cuda_build.check_tensor(f"pr[{name!r}]", t, t.shape, engine.S.device)
    out = launch_tau(build(engine), engine, state, tau, packed_params(engine, pr))
    if engine.contact_model == "relaxed_rigid":
        STEP_TAU_RR_KERNEL_LAUNCHES += 1
    else:
        STEP_TAU_KERNEL_LAUNCHES += 1
    return out


def rollout_per_step(
    engine: BatchedEngine,
    state: BatchedState,
    n_steps: int,
    kp: float = 60.0,
    kd: float = 0.5,
    policy=None,
) -> BatchedState:
    """``n_steps`` chained steps, one K2 launch each (the JAX
    ``pallas_rollout``). A Python ``policy(state) -> tau`` runs only on a CPU
    state, through the twin; on a CUDA state it raises."""
    if policy is not None:
        if not cuda_build.is_cpu(state, "rollout"):
            raise ValueError(
                "a Python policy closure cannot run inside the CUDA kernel: the"
                " per-step kernel takes the PD gains kp, kd (or use"
                f" cuda_step.step_tau with torques computed outside; {cuda_build.ITEM_VARIANTS})"
            )
        return engine.rollout(state, n_steps, policy=policy)
    for _ in range(n_steps):
        state = step_pd(engine, state, kp, kd)
    return state
