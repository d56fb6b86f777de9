"""Build, load and launch the port's hand-written CUDA kernels.

Every engine kernel source in ``jaxsim_tpu_torch/csrc/`` (``rollout.cu``,
``step.cu``, ``env_rollout.cu``, ``step_vjp.cu``) includes the shared step
body ``step_env.cuh`` and a generated header, ``jx_topology.h``, that makes
one model topology's sizes and tables, its contact model and its PCG
iterations compile-time constants; ``fma_probe.cu`` takes no engine and no
header. :func:`build_many`
compiles each (source, topology, build-time defines) once with ``nvcc`` for
``sm_90a``, all of them at the same time, into
``build/jaxsim_tpu_torch_kernels/<key>/`` of the source checkout, and loads it
through its plain C interface with ``ctypes``. The key hashes the generated
header, the flags and the text of every file the source includes, so a
changed ``step_env.cuh`` builds a new library. A loaded library is kept for
the process by (source, generated header): a launch reads no file. A failed
build or launch raises; nothing falls back.

The CUDA sources are not installed as package data: the kernels build from a
source checkout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
import weakref

import torch

from .batched_engine import BatchedEngine, BatchedState

_PACKAGE = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "jaxsim_tpu_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)  # fmt: skip
GENERATED_HEADER = "jx_topology.h"

# Every library exports these besides its own entry points.
_COMMON_SIGNATURES = {"jx_param_count": [], "jx_error_string": [ctypes.c_int]}
PTR, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclasses.dataclass(frozen=True)
class KernelBuild:
    """A built and loaded kernel library for one model topology."""

    lib: ctypes.CDLL
    path: pathlib.Path
    seconds: float  # wall time of the nvcc call; 0 when loaded from disk
    ptxas_log: str  # what -Xptxas -v reported (registers, stack, spills)


@dataclasses.dataclass(frozen=True)
class BuildJob:
    """One library to build: a source of ``csrc/``, the engine whose topology
    it is specialised to (None for a source that includes no generated
    header), extra ``#define``s, and the ``argtypes`` of its entry points
    (every entry point returns a CUDA error code)."""

    engine: BatchedEngine | None
    source: pathlib.Path
    signatures: dict[str, list]
    defines: tuple[tuple[str, int], ...] = ()


# Loaded libraries by (source, generated header), for the whole process.
_BUILDS: dict[tuple[pathlib.Path, str], KernelBuild] = {}
# Each engine's own model arrays packed for the kernels, with the tensors'
# (pointer, version) they were packed from.
_PACKED: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def topology_header(engine: BatchedEngine | None, defines=()) -> str:
    """The generated header that specializes a kernel to one topology and
    contact model (``JX_CONTACT``: 0 soft, 1 relaxed-rigid, with
    ``JX_RR_ITERS`` PCG iterations); empty without an engine."""
    if engine is None:
        return ""

    def arr(name, values):
        values = list(values) or [0]
        return f"__constant__ int {name}[{len(values)}] = {{{', '.join(map(str, values))}}};\n"

    has_f = [int(i in engine.contact_parent) for i in range(engine.n_links)]
    return (
        "// Generated by jaxsim_tpu_torch/ops/cuda_build.py; do not edit.\n"
        "#pragma once\n"
        f"#define JX_NL {engine.n_links}\n"
        f"#define JX_NJ {engine.n_joints}\n"
        f"#define JX_NC {engine.n_points}\n"
        f"#define JX_FLOATING {int(engine.floating_base)}\n"
        f"#define JX_CONTACT {engine.CONTACT_MODELS.index(engine.contact_model)}\n"
        f"#define JX_RR_ITERS {engine._rr_n_iter if engine.contact_model == 'relaxed_rigid' else 0}\n"
        + "".join(f"#define {name} {int(value)}\n" for name, value in defines)
        + arr("JX_LAM", engine.lam)
        + arr("JX_JTYPE", engine.joint_types)
        + arr("JX_CPARENT", engine.contact_parent)
        + arr("JX_HASF", has_f)
    )


def included_files(source: pathlib.Path) -> list[pathlib.Path]:
    """``source`` and every file it includes with ``#include "..."``, found
    beside it, recursively (the generated header excepted)."""
    seen: list[pathlib.Path] = []
    todo = [source]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        if not path.is_file():
            raise FileNotFoundError(f"{path} is missing: the CUDA kernels build from a source checkout")
        seen.append(path)
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
            if name != GENERATED_HEADER:
                todo.append(path.parent / name)
    return seen


def build_key(source: pathlib.Path, header: str) -> str:
    """The cache key of a library: the generated header, the flags, and the
    name and text of every file the source includes."""
    parts = [header, *NVCC_FLAGS]
    for path in included_files(source):
        parts += [path.name, path.read_text()]
    return hashlib.sha256("\0".join(parts).encode()).hexdigest()[:16]


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``): on the path, else
    under ``$CUDA_HOME/bin`` (``/usr/local/cuda`` by default)."""
    return shutil.which(name) or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)


def _load(so: pathlib.Path, signatures: dict[str, list]) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name, argtypes in {**_COMMON_SIGNATURES, **signatures}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "jx_error_string" else ctypes.c_int
    return lib


def build_many(jobs: list[BuildJob]) -> list[KernelBuild]:
    """Compile (or load from ``BUILD_DIR``) each job's library. The ``nvcc``
    calls of the libraries not built yet all run at the same time."""
    handles = [(job.source, topology_header(job.engine, job.defines)) for job in jobs]
    keyed, pending = {}, {}
    for job, handle in zip(jobs, handles):
        if handle in _BUILDS or handle in keyed:
            continue
        header = handle[1]
        key = keyed[handle] = f"{job.source.stem}-{build_key(job.source, header)}"
        so = BUILD_DIR / key / f"lib{job.source.stem}.so"
        if key in pending or so.exists():
            continue
        out_dir = so.parent
        out_dir.mkdir(parents=True, exist_ok=True)
        if job.engine is not None:
            (out_dir / GENERATED_HEADER).write_text(header)
        tmp = out_dir / f"lib{job.source.stem}.{os.getpid()}.so"
        cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-I", str(out_dir), "-o", str(tmp), str(job.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending[key] = (proc, cmd, tmp, so, time.perf_counter())

    seconds, failures = {}, []
    for key, (proc, cmd, tmp, so, t0) in pending.items():
        log, _ = proc.communicate()
        seconds[key] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            continue
        (so.parent / "ptxas.log").write_text(log)
        os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))

    for job, handle in zip(jobs, handles):
        if handle not in _BUILDS:
            so = BUILD_DIR / keyed[handle] / f"lib{job.source.stem}.so"
            log = so.parent / "ptxas.log"
            _BUILDS[handle] = KernelBuild(
                lib=_load(so, job.signatures),
                path=so,
                seconds=seconds.get(keyed[handle], 0.0),
                ptxas_log=log.read_text() if log.exists() else "",
            )
    return [_BUILDS[handle] for handle in handles]


def build(job: BuildJob) -> KernelBuild:
    return build_many([job])[0]


# ----- what the wrappers share -----


def packed_params(engine: BatchedEngine, pr: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """The model arrays, with ``pr``'s overrides, flattened in
    ``PARAM_NAMES`` order (the kernels' shared-memory layout). The engine's
    own arrays are packed once and again only after they change."""
    arrays = engine.params(pr)
    if pr:
        return torch.cat([t.reshape(-1) for t in arrays.values()]).contiguous()
    stamp = tuple((t.data_ptr(), t._version) for t in arrays.values())
    cached = _PACKED.get(engine)
    if cached is None or cached[0] != stamp:
        cached = _PACKED[engine] = (stamp, torch.cat([t.reshape(-1) for t in arrays.values()]).contiguous())
    return cached[1]


def engine_scalars(engine: BatchedEngine) -> tuple[float, ...]:
    """``K, D, K/D, mu, hc_p, hc_q, gz, dt``: the head of the kernels' ``Scalars``
    (K/D is 0 for a relaxed-rigid engine, whose K and D are 0)."""
    return (
        engine.K, engine.D, engine.K / engine.D if engine.D else 0.0, engine.mu,
        engine.hc_p, engine.hc_q, engine.gravity_z, engine.dt,
    )  # fmt: skip


def rr_scalars(engine: BatchedEngine) -> tuple[float, ...]:
    """The relaxed-rigid tail of ``Scalars`` (zeros for a soft engine):
    the sigmoid's ``1/mid^(power-1)`` and ``1/(1-mid)^(power-1)``, ``mid``,
    ``power``, ``width``, ``d_min``, ``d_max``, ``d_max - d_min``, the
    stiffness and damping of the reference acceleration, ``2·mu²``,
    ``1 + mu²`` and the regularization. The constants the JAX engine folds
    in double at trace time are folded here in double too, and rounded to
    float32 once, by the call."""
    if engine.contact_model != "relaxed_rigid":
        return (0.0,) * 13
    mid, power, mu = engine.rr_midpoint, engine.rr_power, engine.mu
    return (
        1.0 / mid ** (power - 1.0), 1.0 / (1.0 - mid) ** (power - 1.0), mid, power, engine.rr_width,
        engine.rr_d_min, engine.rr_d_max, engine.rr_d_max - engine.rr_d_min, engine.rr_stiff, engine.rr_damp,
        2.0 * mu * mu, 1.0 + mu * mu, engine.rr_reg,
    )  # fmt: skip


def is_cpu(state: BatchedState, what: str) -> bool:
    """True for a CPU state (the plain version runs); False for a CUDA state
    (the kernel runs); raises for any other device."""
    device = state.p.device
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no {what} for a state on {device}")
    return False


def check_cuda_call(engine: BatchedEngine, state: BatchedState, contact_models=("soft",)) -> int:
    """What every kernel takes: a flat-ground float32 engine with one of the
    kernel's ``contact_models``, and a state on the engine's device, float32,
    contiguous, of the engine's shapes. Returns the batch size."""
    if engine.contact_model not in contact_models:
        raise ValueError(
            f"this kernel implements {' and '.join(contact_models)} contacts, not {engine.contact_model}"
        )
    if not engine.flat:
        raise ValueError("the CUDA kernels implement flat ground only")
    if engine.S.dtype != torch.float32:
        raise ValueError(f"the kernel takes a float32 engine, got {engine.S.dtype}")
    B = state.p.shape[-1]
    want = dict(
        s=(engine.n_joints, B),
        sd=(engine.n_joints, B),
        p=(3, B),
        q=(4, B),
        v=(6, B),
        m=(engine.m_rows, 3, B),
    )
    for name, shape in want.items():
        check_tensor(f"state.{name}", getattr(state, name), shape, engine.S.device)
    return B


def check_tensor(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the engine on {device}")
    if t.dtype != dtype:
        raise ValueError(f"the kernel takes {dtype}; {name} is {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def empty_state_like(state: BatchedState) -> BatchedState:
    """Output buffers: never the input's, so a kernel can re-read its input."""
    return BatchedState(*(torch.empty_like(t) for t in state.fields()))


def state_pointers(state: BatchedState) -> list[int]:
    return [t.data_ptr() for t in state.fields()]


def launch(kernel: KernelBuild, fn: str, params: torch.Tensor | None, device, *args) -> None:
    """Call entry point ``fn`` on the current stream of ``device``, after
    checking the packed model arrays against the kernel's layout (``None``
    for an entry point that takes none); raises on a launch error."""
    if params is not None:
        if kernel.lib.jx_param_count() != params.numel():
            raise RuntimeError("packed model arrays disagree with the kernel's layout")
        args = (params.data_ptr(), *args)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(kernel.lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: {kernel.lib.jx_error_string(rc).decode()}")
