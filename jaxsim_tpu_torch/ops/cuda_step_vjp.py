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
"""

from __future__ import annotations

import weakref

import torch

from . import cuda_build
from .batched_engine import BatchedEngine, BatchedState
from .cuda_build import CSRC, F32, I32, PTR, BuildJob, KernelBuild, packed_params

# Launches of each CUDA kernel made by the wrappers below, in this process.
STEP_VJP_KERNEL_LAUNCHES = 0
PARAM_SUM_KERNEL_LAUNCHES = 0

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


def job(engine: BatchedEngine, params_grad: bool = False, lanes: int = LANES) -> BuildJob:
    return BuildJob(engine, SOURCE, SIGNATURES, (("JX_PARAMS_GRAD", int(params_grad)), ("JX_LN_LANES", int(lanes))))


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
    return cuda_build.geometry(kernel, "jx_vjp_geometry")


def local_memory(kernel: KernelBuild) -> dict[str, int]:
    """The local loads and stores in the kernel's SASS: in all, in the
    forward recompute (``soft_step_lanes.cuh``) and in the reverse sweep
    (``step_vjp_lanes`` and the transposes it calls in ``step_vjp.cu``)."""
    text = SOURCE.read_text().splitlines()

    def line_of(pattern: str) -> int:
        return next(n for n, ln in enumerate(text, 1) if pattern in ln)

    return cuda_build.local_memory(kernel, dict(
        forward=("soft_step_lanes.cuh", 1, 10**6),
        reverse=("step_vjp.cu", line_of("// ----- transposes of the small algebra"), line_of("// ----- kernels -----")),
    ))  # fmt: skip


def build(engine: BatchedEngine, params_grad: bool = False) -> KernelBuild:
    return cuda_build.build(job(engine, params_grad))


def check_scope(engine: BatchedEngine) -> None:
    """K4 and its plain version differentiate the soft-contact, flat-ground,
    semi-implicit Euler step; anything else raises."""
    if not engine.flat or engine.contact_model != "soft":
        raise ValueError(
            "the step VJP covers soft contacts on flat ground with semi-implicit"
            " Euler; other terrains, contact models and integrators come with"
            " their twins (ROADMAP Queue 1 item 4)"
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
    """The per-block partial sums ``(n_blocks, n_params)`` of K4's model-array
    cotangents added over the blocks: one launch of the fixed-order sum for
    a CUDA tensor, the plain version for a CPU tensor."""
    global PARAM_SUM_KERNEL_LAUNCHES
    if partials.device.type == "cpu":
        return sum_partials_reference(partials)
    kernel = build(engine, True)
    n = kernel.param_count
    cuda_build.check_tensor("partials", partials, (partials.shape[0], n), engine.S.device)
    out = torch.empty(n, dtype=partials.dtype, device=partials.device)
    cuda_build.launch(kernel, "jx_param_sum", None, partials.device, partials.data_ptr(), partials.shape[0], out.data_ptr())
    PARAM_SUM_KERNEL_LAUNCHES += 1
    return out


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
    global STEP_VJP_KERNEL_LAUNCHES
    check_scope(engine)
    engine.params(pr)  # refuses unknown or misshapen arrays on either path
    if cuda_build.is_cpu(state, "step VJP"):
        return step_vjp_reference(engine, state, tau, ct, pr, params_grad)
    B = cuda_build.check_cuda_call(engine, state)
    cuda_build.check_tensor("tau", tau, (engine.n_joints, B), engine.S.device)
    for name, t, like in zip(BatchedState.__dataclass_fields__, ct.fields(), state.fields()):
        cuda_build.check_tensor(f"ct.{name}", t, like.shape, engine.S.device)
    for name, t in (pr or {}).items():
        cuda_build.check_tensor(f"pr[{name!r}]", t, t.shape, engine.S.device)
    out, ct_tau, partials = launch(build(engine, params_grad), engine, state, tau, ct, pr, params_grad)
    STEP_VJP_KERNEL_LAUNCHES += 1
    if params_grad:
        return out, ct_tau, unpack_params(engine, sum_partials(engine, partials))
    return out, ct_tau
