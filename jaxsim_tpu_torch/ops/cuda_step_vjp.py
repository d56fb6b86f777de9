"""The fused backward of one engine step as a CUDA kernel (K4).

Counterpart of ``build_pallas_step_vjp`` (``_step_vjp_kernel``) of
``jaxsim_tpu/ops/pallas_step.py``: for a state, torques ``tau`` and a
cotangent ``ct`` of the step's output state, one launch recomputes the step
and returns the cotangents of the input state and of ``tau``; with
``params_grad`` also the cotangents of every model array
(``BatchedEngine.PARAM_NAMES``), summed over the batch.

The kernel is ``jaxsim_tpu_torch/csrc/step_vjp.cu``, built per topology and
per ``params_grad`` (a build-time define, so two libraries a topology). With
``params_grad`` it writes one partial sum a 32-env block; a second small
kernel of the same file, :func:`sum_partials`, adds the partials in a fixed
order (each entry over a group of lanes, then a shuffle tree), so two runs
agree to the bit.

:func:`step_vjp` takes its plain version, :func:`step_vjp_reference`
(``torch.autograd.grad`` through the twin's step), for a CPU state and the
kernel for a CUDA state; a failed build or launch raises. Scope: soft
contacts, flat ground, semi-implicit Euler, the body K3 has.
"""

from __future__ import annotations

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
}
BLOCK = 32  # envs a block of the kernel, one partial sum each


def job(engine: BatchedEngine, params_grad: bool = False) -> BuildJob:
    return BuildJob(engine, SOURCE, SIGNATURES, (("JX_PARAMS_GRAD", int(params_grad)),))


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
    params = packed_params(engine, pr)
    out = cuda_build.empty_state_like(state)
    ct_tau = torch.empty_like(tau)
    n_blocks = (B + BLOCK - 1) // BLOCK
    partials = torch.empty(n_blocks, params.numel(), device=tau.device) if params_grad else None
    cuda_build.launch(
        build(engine, params_grad), "jx_step_vjp", params, state.p.device,
        *cuda_build.state_pointers(state), tau.data_ptr(), *cuda_build.state_pointers(ct),
        *cuda_build.state_pointers(out), ct_tau.data_ptr(),
        None if partials is None else partials.data_ptr(),
        B, *cuda_build.engine_scalars(engine),
    )  # fmt: skip
    STEP_VJP_KERNEL_LAUNCHES += 1
    if params_grad:
        return out, ct_tau, unpack_params(engine, sum_partials(engine, partials))
    return out, ct_tau
