"""Whole-horizon rollout in one CUDA kernel launch.

Counterpart of ``jaxsim_tpu/ops/pallas_step.py::build_pallas_rollout`` and its
``_rollout_kernel``, for the base body (soft contacts, flat ground,
semi-implicit Euler, PD policy ``tau = -kp·s - kd·ṡ``, no per-env options).
The kernel is ``jaxsim_tpu_torch/csrc/rollout.cu``; see the note at its top.

:func:`rollout` dispatches on the device of the state: a CPU state goes to
:func:`rollout_reference`, the plain version (a loop over
:meth:`BatchedEngine.step`); a CUDA state goes to the kernel, which is
compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/jaxsim_tpu_torch_kernels/`` and loaded through a plain C interface
with ``ctypes``. A failed build or launch raises; nothing falls back.

The kernel builds from a source checkout: ``csrc/`` is not installed as
package data, and the libraries go to the checkout's ``build/`` directory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from .batched_engine import BatchedEngine, BatchedState

# Launches of the CUDA kernel made by rollout(), in this process.
ROLLOUT_KERNEL_LAUNCHES = 0

_PACKAGE = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PACKAGE / "csrc" / "rollout.cu"
BUILD_DIR = _PACKAGE.parent / "build" / "jaxsim_tpu_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)  # fmt: skip


@dataclasses.dataclass(frozen=True)
class KernelBuild:
    """A built and loaded kernel library for one model topology."""

    lib: ctypes.CDLL
    path: pathlib.Path
    seconds: float  # wall time of the nvcc call; 0 when loaded from disk
    ptxas_log: str  # what -Xptxas -v reported (registers, spills)


_BUILDS: dict[str, KernelBuild] = {}


def topology_header(engine: BatchedEngine) -> str:
    """The generated header that specializes the kernel to one topology."""

    def arr(name, values):
        values = list(values) or [0]
        return f"__constant__ int {name}[{len(values)}] = {{{', '.join(map(str, values))}}};\n"

    has_f = [int(i in engine.contact_parent) for i in range(engine.n_links)]
    return (
        "// Generated by jaxsim_tpu_torch/ops/cuda_rollout.py; do not edit.\n"
        "#pragma once\n"
        f"#define JX_NL {engine.n_links}\n"
        f"#define JX_NJ {engine.n_joints}\n"
        f"#define JX_NC {engine.n_points}\n"
        f"#define JX_FLOATING {int(engine.floating_base)}\n"
        + arr("JX_LAM", engine.lam)
        + arr("JX_JTYPE", engine.joint_types)
        + arr("JX_CPARENT", engine.contact_parent)
        + arr("JX_HASF", has_f)
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(engine: BatchedEngine) -> KernelBuild:
    """Compile (or load from ``BUILD_DIR``) the kernel for ``engine``'s topology."""
    if not SOURCE.is_file():
        raise FileNotFoundError(f"{SOURCE} is missing: the CUDA kernel builds from a source checkout")
    header = topology_header(engine)
    key = hashlib.sha256(
        "\0".join([header, SOURCE.read_text(), *NVCC_FLAGS]).encode()
    ).hexdigest()[:16]
    if key in _BUILDS:
        return _BUILDS[key]

    out_dir = BUILD_DIR / key
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "librollout.so"
    log = out_dir / "ptxas.log"
    seconds = 0.0
    if not so.exists():
        (out_dir / "jx_topology.h").write_text(header)
        tmp = out_dir / f"librollout.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(out_dir), "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}{res.stderr}"
            )
        log.write_text(res.stdout + res.stderr)
        os.replace(tmp, so)

    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.jx_rollout.argtypes = [ptr] * 13 + [i32, i32] + [f32] * 10 + [ptr]
    lib.jx_rollout.restype = i32
    lib.jx_param_count.argtypes = []
    lib.jx_param_count.restype = i32
    lib.jx_error_string.argtypes = [i32]
    lib.jx_error_string.restype = ctypes.c_char_p
    built = KernelBuild(lib=lib, path=so, seconds=seconds, ptxas_log=log.read_text())
    _BUILDS[key] = built
    return built


def packed_params(engine: BatchedEngine) -> torch.Tensor:
    """The model arrays flattened in ``PARAM_NAMES`` order (the kernel's
    shared-memory layout)."""
    return torch.cat([t.reshape(-1) for t in engine.params().values()]).contiguous()


def rollout_reference(
    engine: BatchedEngine, state: BatchedState, n_steps: int, kp: float = 60.0, kd: float = 0.5
) -> BatchedState:
    """The plain version: ``n_steps`` of the twin's step under the PD policy."""
    return engine.rollout(state, n_steps, policy=lambda st: -kp * st.s - kd * st.sd)


def _check_state(engine: BatchedEngine, state: BatchedState) -> int:
    B = state.p.shape[-1]
    want = dict(
        s=(engine.n_joints, B),
        sd=(engine.n_joints, B),
        p=(3, B),
        q=(4, B),
        v=(6, B),
        m=(engine.m_rows, 3, B),
    )
    device = engine.S.device
    for name, shape in want.items():
        t = getattr(state, name)
        if t.device != device:
            raise ValueError(f"state.{name} is on {t.device}, the engine on {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the kernel takes float32; state.{name} is {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"state.{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"state.{name} must be contiguous")
    return B


def rollout(
    engine: BatchedEngine, state: BatchedState, n_steps: int, kp: float = 60.0, kd: float = 0.5
) -> BatchedState:
    """Advance every env ``n_steps`` under ``tau = -kp·s - kd·ṡ``: in one CUDA
    kernel launch for a CUDA state, with the plain version for a CPU state."""
    global ROLLOUT_KERNEL_LAUNCHES
    device = state.p.device
    if device.type == "cpu":
        return rollout_reference(engine, state, n_steps, kp, kd)
    if device.type != "cuda":
        raise ValueError(f"no rollout for a state on {device}")
    if not engine.flat:
        raise ValueError("the CUDA rollout implements flat ground only")
    if engine.S.dtype != torch.float32:
        raise ValueError(f"the kernel takes a float32 engine, got {engine.S.dtype}")
    B = _check_state(engine, state)
    params = packed_params(engine)
    kernel = build(engine)
    if kernel.lib.jx_param_count() != params.numel():
        raise RuntimeError("packed model arrays disagree with the kernel's layout")

    out = BatchedState(*(torch.empty_like(t) for t in state.fields()))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel.lib.jx_rollout(
            params.data_ptr(),
            *(t.data_ptr() for t in state.fields()),
            *(t.data_ptr() for t in out.fields()),
            B,
            int(n_steps),
            engine.K,
            engine.D,
            engine.K / engine.D,
            engine.mu,
            engine.hc_p,
            engine.hc_q,
            engine.gravity_z,
            engine.dt,
            float(kp),
            float(kd),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"rollout kernel launch failed: {kernel.lib.jx_error_string(rc).decode()}")
    ROLLOUT_KERNEL_LAUNCHES += 1
    return out
