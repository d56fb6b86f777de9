"""The fused backward of one engine step as a CUDA kernel (K4).

Counterpart of ``build_pallas_step_vjp`` (``_step_vjp_kernel``) of
``jaxsim_tpu/ops/pallas_step.py``: for a state, torques ``tau`` and a
cotangent ``ct`` of the step's output state, one launch recomputes the step
and returns the cotangents of the input state and of ``tau``; with
``params_grad`` also the cotangents of every model array
(``BatchedEngine.PARAM_NAMES``), summed over the batch.

The kernel is ``jaxsim_tpu_torch/csrc/step_vjp.cu``, built per topology and
per ``params_grad`` (a build-time define, so two libraries a topology): each
env on ``LANES`` lanes of a warp, its tape in shared memory, a block one warp
of :func:`envs_per_block` envs. With ``params_grad`` each block sums its
envs' model-array cotangents in shared memory and writes one partial row; a
second small kernel of the same file, :func:`sum_partials`, adds the
partials in a fixed order (each entry by a block's warps, then in warp
order), so two runs agree to the bit.

:func:`step_vjp` takes its plain version, :func:`step_vjp_reference`
(``torch.autograd.grad`` through the twin's step), for a CPU state and the
kernel for a CUDA state; a failed build or launch raises. Scope: soft
contacts, flat ground, semi-implicit Euler, the body K3 has.

For a relaxed-rigid engine the kernel is K4-rr,
``jaxsim_tpu_torch/csrc/step_vjp_rr.cu`` (built per topology and per
``params_grad`` as K4): each env on ``RR_LANES`` lanes of a warp, the envs
a block that fit up to ``RR_ENVS`` (``cuda_build.vjp_rr_tables``), its
tape in shared memory; the forward's free ABA, the transposed step's tree
passes level by level on the env's lanes, the forward's and the implicit
backward's PCG and the per-point work on the lanes of the points' slots;
with ``params_grad`` each block sums its envs' model-array cotangents
(``rrMinv``'s included) in shared memory and writes one partial row, and
the same fixed-order sum adds the rows. It differentiates the solve as the
twin's ``_PcgImplicit`` does, which is its plain version.
"""

from __future__ import annotations

import weakref

import torch

from . import cuda_build, cuda_rollout
from .batched_engine import BatchedEngine, BatchedState
from .cuda_build import CSRC, F32, I32, PTR, BuildJob, KernelBuild, packed_params

# Launches of each CUDA kernel made by the wrappers below, in this process.
STEP_VJP_KERNEL_LAUNCHES = 0
STEP_VJP_RR_KERNEL_LAUNCHES = 0
PARAM_SUM_KERNEL_LAUNCHES = 0
PARAM_SUM_RR_KERNEL_LAUNCHES = 0

SOURCE = CSRC / "step_vjp.cu"
SIGNATURES = {
    "jx_step_vjp": [PTR] * 22 + [I32] + [F32] * 8 + [PTR],
    "jx_param_sum": [PTR, I32, PTR, PTR],
    "jx_vjp_geometry": [PTR],
}
_ENVS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
# Lanes of a warp that carry one env (a build-time constant; PERF.md §6 has
# the times of the counts tried).
LANES = 4
# The contact models K4 differentiates: soft (step_vjp.cu) and relaxed-rigid
# (step_vjp_rr.cu).
CONTACT_MODELS = ("soft", "relaxed_rigid")


RR_SOURCE = CSRC / "step_vjp_rr.cu"
# K4-rr's arguments: K4's, and the relaxed-rigid tail of the scalars
# (cuda_build.rr_scalars).
RR_SIGNATURES = {
    "jx_step_vjp_rr": [PTR] * 22 + [I32] + [F32] * 21 + [PTR],
    "jx_param_sum": [PTR, I32, PTR, PTR],
    "jx_vjp_rr_geometry": [PTR],
}
# K4-rr's lanes an env (K3-rr's) and envs a block, at most (PERF.md §6 has
# the times of the geometries tried).
RR_LANES = cuda_rollout.RR_LANES
RR_ENVS = 16


def job(engine: BatchedEngine, params_grad: bool = False, lanes: int | None = None, envs: int | None = None) -> BuildJob:
    """The library for ``engine``: K4 (``lanes`` lanes an env, ``LANES`` by
    default), or for a relaxed-rigid engine K4-rr (``lanes``, ``RR_LANES`` by
    default, and at most ``envs`` envs a block, ``RR_ENVS`` by default)."""
    if engine.contact_model == "relaxed_rigid":
        defines = (("JX_PARAMS_GRAD", int(params_grad)), ("JX_RR_LANES", int(lanes or RR_LANES)),
                   ("JX_RR_VJP", 1), ("JX_RR_MAX_ENVS", int(envs or RR_ENVS)))  # fmt: skip
        return BuildJob(engine, RR_SOURCE, RR_SIGNATURES, defines)
    return BuildJob(engine, SOURCE, SIGNATURES, (("JX_PARAMS_GRAD", int(params_grad)), ("JX_LN_LANES", int(lanes or LANES))))


def envs_per_block(engine: BatchedEngine, params_grad: bool = False, lanes: int = LANES) -> int:
    """Envs a block of the kernel takes: the rows of ``partials`` are the
    batch over this, rounded up. Kept by engine after the first call."""
    cache = _ENVS.setdefault(engine, {})
    if (params_grad, lanes) not in cache:
        cache[(params_grad, lanes)] = cuda_build.lane_tables(engine, lanes, params_grad)["envs"]
    return cache[(params_grad, lanes)]


def geometry(kernel: KernelBuild) -> dict[str, int]:
    """The kernel's launch: threads and envs a block, the dynamic shared
    memory a block takes in bytes, and the blocks an SM holds at once (CUDA's
    occupancy calculator)."""
    relaxed = hasattr(kernel.lib, "jx_vjp_rr_geometry")
    return cuda_build.geometry(kernel, "jx_vjp_rr_geometry" if relaxed else "jx_vjp_geometry")


def local_memory(kernel: KernelBuild) -> dict[str, int]:
    """The local loads and stores in K4's SASS: in all, in the forward
    recompute (``soft_step_lanes.cuh``), in the reverse sweep
    (``step_vjp_lanes`` in ``step_vjp.cu``) and in the transposes it calls
    (``vjp_algebra.cuh``)."""
    text = SOURCE.read_text().splitlines()

    def line_of(pattern: str) -> int:
        return next(n for n, ln in enumerate(text, 1) if pattern in ln)

    return cuda_build.local_memory(kernel, dict(
        forward=("soft_step_lanes.cuh", 1, 10**6),
        reverse=("step_vjp.cu", line_of("// The block's row of model-array cotangents"), line_of("// ----- kernels -----")),
        transposes=("vjp_algebra.cuh", 1, 10**6),
    ))  # fmt: skip


def rr_local_memory(kernel: KernelBuild) -> dict[str, int]:
    """The local loads and stores in K4-rr's SASS: in all, in the solves'
    passes (``rr_step.cuh``), in the forward's free ABA and substitution and
    in the transposed step (``step_vjp_rr.cu``), and in the transposes it
    calls (``vjp_algebra.cuh``)."""
    text = RR_SOURCE.read_text().splitlines()

    def line_of(pattern: str) -> int:
        return next(n for n, ln in enumerate(text, 1) if pattern in ln)

    forward, reverse = line_of("// ----- the forward:"), line_of("// ----- the transposed step -----")
    return cuda_build.local_memory(kernel, dict(
        solves=("rr_step.cuh", 1, 10**6), forward=("step_vjp_rr.cu", forward, reverse),
        reverse=("step_vjp_rr.cu", reverse, line_of("// ----- the kernel -----")),
        transposes=("vjp_algebra.cuh", 1, 10**6),
    ))  # fmt: skip


def build(engine: BatchedEngine, params_grad: bool = False) -> KernelBuild:
    return cuda_build.build(job(engine, params_grad))


def check_scope(engine: BatchedEngine) -> None:
    """K4 and its plain version differentiate the soft-contact or
    relaxed-rigid step on flat ground; anything else raises. (The plain
    version differentiates any of the twin's integrators; K4 itself takes
    semi-implicit Euler only, and its wrapper refuses the others.)"""
    if engine.contact_model not in CONTACT_MODELS:
        raise ValueError(f"the step VJP covers soft and relaxed-rigid contacts, not {engine.contact_model}")
    if not engine.flat:
        raise ValueError(
            f"the step VJP covers flat ground, not {engine.terrain} terrain: K4 on an inclined plane and on"
            f" Fourier terrain is {cuda_build.ITEM_VARIANTS}"
        )


def unpack_params(engine: BatchedEngine, flat: torch.Tensor) -> dict[str, torch.Tensor]:
    """Model arrays by name from the kernels' packed layout."""
    own = engine.params()
    parts = torch.split(flat, [t.numel() for t in own.values()])
    return {k: p.reshape(t.shape) for (k, t), p in zip(own.items(), parts)}


def step_vjp_reference(
    engine: BatchedEngine, state: BatchedState, tau, ct: BatchedState, pr=None, params_grad: bool = False
):
    """K4's plain version: ``torch.autograd.grad`` through the twin's step at
    ``(state, tau, pr)`` for the output cotangent ``ct``. Returns
    ``(ct_state, ct_tau)``, and with ``params_grad`` the model arrays'
    cotangents by name as a third element."""
    check_scope(engine)
    arrays = engine.params(pr)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in state.fields()]
        tau_in = tau.detach().requires_grad_()
        pr_in = {k: t.detach().requires_grad_(params_grad) for k, t in arrays.items()}
        out = engine.step(BatchedState(*leaves), tau_in, pr_in)
        inputs = [*leaves, tau_in, *(pr_in.values() if params_grad else ())]
        grads = torch.autograd.grad(out.fields(), inputs, ct.fields(), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
    ct_state, ct_tau = BatchedState(*grads[:6]), grads[6]
    if params_grad:
        return ct_state, ct_tau, dict(zip(arrays, grads[7:]))
    return ct_state, ct_tau


def sum_partials_reference(partials: torch.Tensor) -> torch.Tensor:
    """The plain version of the partials' sum: over the blocks, axis 0."""
    return partials.sum(0)


def sum_partials(engine: BatchedEngine, partials: torch.Tensor) -> torch.Tensor:
    """The partial sums ``(n_rows, n_params)`` of K4's model-array cotangents
    (a row a block) added over the rows: one launch of
    the fixed-order sum for a CUDA tensor, the plain version for a CPU
    tensor."""
    global PARAM_SUM_KERNEL_LAUNCHES, PARAM_SUM_RR_KERNEL_LAUNCHES
    if partials.device.type == "cpu":
        return sum_partials_reference(partials)
    kernel = build(engine, True)
    n = kernel.param_count
    cuda_build.check_tensor("partials", partials, (partials.shape[0], n), engine.S.device)
    out = torch.empty(n, dtype=partials.dtype, device=partials.device)
    cuda_build.launch(kernel, "jx_param_sum", None, partials.device, partials.data_ptr(), partials.shape[0], out.data_ptr())
    if engine.contact_model == "relaxed_rigid":
        PARAM_SUM_RR_KERNEL_LAUNCHES += 1
    else:
        PARAM_SUM_KERNEL_LAUNCHES += 1
    return out


def rr_envs_per_block(engine: BatchedEngine, params_grad: bool = False, lanes: int = RR_LANES,
                      envs: int = RR_ENVS) -> int:
    """Envs a block of K4-rr: the most up to ``envs`` whose slots fit
    (``cuda_build.vjp_rr_tables``); the rows of ``partials`` are the batch
    over this, rounded up. Kept by engine after the first call."""
    cache = _ENVS.setdefault(engine, {})
    key = ("relaxed_rigid", params_grad, lanes, envs)
    if key not in cache:
        cache[key] = cuda_build.vjp_rr_tables(engine, lanes, params_grad, max_envs=envs)["envs"]
    return cache[key]


def launch_rr(kernel: KernelBuild, engine: BatchedEngine, state: BatchedState, tau, ct: BatchedState, pr=None,
              params_grad: bool = False, lanes: int = RR_LANES, envs: int = RR_ENVS):
    """One launch of ``kernel`` (the engine's K4-rr library, or a variant of
    it built from another source, lane count or block) on checked CUDA
    tensors; counts nothing. Returns ``(ct_state, ct_tau, partials)``,
    ``partials`` (a row of model-array cotangents a block) None without
    ``params_grad``."""
    params = packed_params(engine, pr)
    out = cuda_build.empty_state_like(state)
    ct_tau = torch.empty_like(tau)
    B = state.p.shape[-1]
    n_blocks = -(-B // rr_envs_per_block(engine, params_grad, lanes, envs))
    partials = torch.empty(n_blocks, params.numel(), device=tau.device) if params_grad else None
    cuda_build.launch(
        kernel, "jx_step_vjp_rr", params, state.p.device,
        *cuda_build.state_pointers(state), tau.data_ptr(), *cuda_build.state_pointers(ct),
        *cuda_build.state_pointers(out), ct_tau.data_ptr(),
        None if partials is None else partials.data_ptr(),
        B, *cuda_build.engine_scalars(engine), *cuda_build.rr_scalars(engine),
    )  # fmt: skip
    return out, ct_tau, partials


def launch(kernel: KernelBuild, engine: BatchedEngine, state: BatchedState, tau, ct: BatchedState, pr=None,
           params_grad: bool = False, lanes: int = LANES):
    """One launch of ``kernel`` (the engine's K4 library, or a variant of it
    built from another source or lane count) on checked CUDA tensors; counts
    nothing. Returns ``(ct_state, ct_tau, partials)``, ``partials`` None
    without ``params_grad``."""
    params = packed_params(engine, pr)
    out = cuda_build.empty_state_like(state)
    ct_tau = torch.empty_like(tau)
    B = state.p.shape[-1]
    n_blocks = -(-B // envs_per_block(engine, params_grad, lanes))
    partials = torch.empty(n_blocks, params.numel(), device=tau.device) if params_grad else None
    cuda_build.launch(
        kernel, "jx_step_vjp", params, state.p.device,
        *cuda_build.state_pointers(state), tau.data_ptr(), *cuda_build.state_pointers(ct),
        *cuda_build.state_pointers(out), ct_tau.data_ptr(),
        None if partials is None else partials.data_ptr(),
        B, *cuda_build.engine_scalars(engine),
    )  # fmt: skip
    return out, ct_tau, partials


def step_vjp(
    engine: BatchedEngine, state: BatchedState, tau, ct: BatchedState, pr=None, params_grad: bool = False
):
    """Cotangents of one step's inputs for the output cotangent ``ct``: one
    K4 launch (and, with ``params_grad``, one launch of the partials' sum)
    for a CUDA state, the plain version for a CPU state. Returns as
    :func:`step_vjp_reference`."""
    global STEP_VJP_KERNEL_LAUNCHES, STEP_VJP_RR_KERNEL_LAUNCHES
    check_scope(engine)
    engine.params(pr)  # refuses unknown or misshapen arrays on either path
    if cuda_build.is_cpu(state, "step VJP"):
        return step_vjp_reference(engine, state, tau, ct, pr, params_grad)
    B = cuda_build.check_cuda_call(engine, state, CONTACT_MODELS)
    cuda_build.check_tensor("tau", tau, (engine.n_joints, B), engine.S.device)
    for name, t, like in zip(BatchedState.__dataclass_fields__, ct.fields(), state.fields()):
        cuda_build.check_tensor(f"ct.{name}", t, like.shape, engine.S.device)
    for name, t in (pr or {}).items():
        cuda_build.check_tensor(f"pr[{name!r}]", t, t.shape, engine.S.device)
    if engine.contact_model == "relaxed_rigid":
        out, ct_tau, partials = launch_rr(build(engine, params_grad), engine, state, tau, ct, pr, params_grad)
        STEP_VJP_RR_KERNEL_LAUNCHES += 1
    else:
        out, ct_tau, partials = launch(build(engine, params_grad), engine, state, tau, ct, pr, params_grad)
        STEP_VJP_KERNEL_LAUNCHES += 1
    if params_grad:
        return out, ct_tau, unpack_params(engine, sum_partials(engine, partials))
    return out, ct_tau
