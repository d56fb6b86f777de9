"""Build, load and launch the port's hand-written CUDA kernels.

Every engine kernel source in ``jaxsim_tpu_torch/csrc/`` (``rollout.cu``,
``env_rollout.cu``, ``step.cu`` and ``step_vjp.cu``, whose step is the
lane-spread ``soft_step_lanes.cuh``; ``rollout_rr.cu``, ``step_rr.cu``,
``env_rollout_rr.cu`` and ``step_vjp_rr.cu``, whose relaxed-rigid step is
``rr_step.cuh``) includes the shared algebra ``step_env.cuh`` and a
generated header, ``jx_topology.h``, that makes one model topology's sizes
and tables, its contact model, its PCG iterations and its integrator
compile-time constants, and for the kernels that put an env on several lanes the lanes
an env, the point slots and the tree's level schedule (:func:`rr_tables`,
:func:`lane_tables`); ``fma_probe.cu`` takes no engine and no header.
:func:`build_many`
compiles each (source, topology, build-time defines) once with ``nvcc`` for
``sm_90a``, all of them at the same time, into
``build/jaxsim_tpu_torch_kernels/<key>/`` of the source checkout, and loads it
through its plain C interface with ``ctypes``. The key hashes the generated
header, the flags and the text of every file the source includes, so a
changed ``step_env.cuh`` builds a new library. A loaded library is kept for
the process by (source, generated header), and :func:`build` keeps it by
engine and job too, so a launch neither reads a file nor generates a header.
A failed build or launch raises; nothing falls back.

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
# -lineinfo maps the SASS to source lines (cuda_rollout.rr_local_memory)
# and leaves the code as it is.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
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
    param_count: int  # floats of packed model arrays the library's layout takes


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
# The same by engine, then (source, defines, PCG iterations, integrator):
# what build() reads on every launch. The iterations and the integrator are
# the header inputs that an engine lets its user change after it is built.
_ENGINE_BUILDS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_NO_ENGINE_BUILDS: dict[tuple, KernelBuild] = {}
# Dynamic shared memory a block may take on sm_90 (227 KB).
MAX_SMEM_BYTES = 232_448
RR_MAX_ENVS = 64  # envs a block of the relaxed-rigid kernel, at most
# Each engine's own model arrays packed for the kernels, with the tensors'
# (pointer, version) they were packed from.
_PACKED: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def topology_header(engine: BatchedEngine | None, defines=()) -> str:
    """The generated header that specializes a kernel to one topology,
    contact model (``JX_CONTACT``: 0 soft, 1 relaxed-rigid, with
    ``JX_RR_ITERS`` PCG iterations) and integrator (``JX_INTEGRATOR``: 0
    semi-implicit Euler, 1 RK4, 2 RK4-fast); empty without an engine."""
    if engine is None:
        return ""

    def arr(name, values):
        values = list(values) or [0]
        return f"__constant__ int {name}[{len(values)}] = {{{', '.join(map(str, values))}}};\n"

    has_f = [int(i in engine.contact_parent) for i in range(engine.n_links)]
    lanes = dict(defines).get("JX_RR_LANES")
    ln_lanes = dict(defines).get("JX_LN_LANES")
    return (
        "// Generated by jaxsim_tpu_torch/ops/cuda_build.py; do not edit.\n"
        "#pragma once\n"
        f"#define JX_NL {engine.n_links}\n"
        f"#define JX_NJ {engine.n_joints}\n"
        f"#define JX_NC {engine.n_points}\n"
        f"#define JX_FLOATING {int(engine.floating_base)}\n"
        f"#define JX_CONTACT {engine.CONTACT_MODELS.index(engine.contact_model)}\n"
        f"#define JX_RR_ITERS {engine._rr_n_iter if engine.contact_model == 'relaxed_rigid' else 0}\n"
        f"#define JX_INTEGRATOR {engine.INTEGRATORS.index(engine.integrator)}\n"
        + "".join(f"#define {name} {int(value)}\n" for name, value in defines)
        + arr("JX_LAM", engine.lam)
        + arr("JX_JTYPE", engine.joint_types)
        + arr("JX_CPARENT", engine.contact_parent)
        + arr("JX_HASF", has_f)
        + ("" if lanes is None else rr_header(engine, dict(defines)))
        + ("" if ln_lanes is None else lane_header(engine, dict(defines)))
    )


def _lane_schedule(engine: BatchedEngine, lanes: int) -> dict:
    """What a kernel that puts an env on ``lanes`` lanes of a warp takes from
    the topology:

    * ``slot_point``: the point slots, lane ``g``'s ``k``-th at ``g + lanes·k``;
      each contact parent's points in contact-index order (parents in order of
      first appearance), padded with -1 to a multiple of ``lanes``, so the
      ``lanes`` slots of group ``k`` share one parent, ``group_link[k]``, whose
      row among the parents is ``group_par[k]``; ``par_link``: the parents;
    * the level schedule of links 1..nL-1 by depth (``lev_off``,
      ``lev_link``) and each link's children in descending index order
      (``ch_off``, ``ch``)."""
    if 32 % lanes:
        raise ValueError(f"lanes an env must divide a warp's 32, got {lanes}")
    nL, lam = engine.n_links, list(engine.lam)
    parents = list(dict.fromkeys(engine.contact_parent))
    slots = []
    for par in parents:
        pts = [c for c, p in enumerate(engine.contact_parent) if p == par]
        slots += pts + [-1] * (-len(pts) % lanes)
    own = len(slots) // lanes
    group_link = [engine.contact_parent[slots[lanes * k]] for k in range(own)]
    depth = [0] * nL
    for i in range(1, nL):
        depth[i] = depth[lam[i]] + 1
    n_lev = max(depth, default=0)
    children = [sorted((c for c in range(1, nL) if lam[c] == i), reverse=True) for i in range(nL)]
    return dict(
        slot_point=slots,
        group_link=group_link, group_par=[parents.index(p) for p in group_link], par_link=parents,
        own=own, n_lev=n_lev, lev_link=sorted(range(1, nL), key=lambda i: (depth[i], i)),
        lev_off=[sum(1 for i in range(1, nL) if depth[i] <= d) for d in range(n_lev + 1)],
        ch_off=[sum(len(ch) for ch in children[:i]) for i in range(nL + 1)], ch=[c for ch in children for c in ch],
    )  # fmt: skip


def _schedule_header(prefix: str, t: dict) -> str:
    """The generated header's defines and tables of a :func:`_lane_schedule`."""

    def arr(name, values):
        values = list(values) or [0]
        return f"__constant__ int {prefix}_{name}[{len(values)}] = {{{', '.join(map(str, values))}}};\n"

    return (
        f"#define {prefix}_OWN {t['own']}\n#define {prefix}_NPAR {len(t['par_link'])}\n"
        f"#define {prefix}_NLEV {t['n_lev']}\n#define {prefix}_ENVS {t['envs']}\n#define {prefix}_SLOT {t['slot']}\n"
        + arr("SLOT_POINT", t["slot_point"]) + arr("GROUP_LINK", t["group_link"])
        + arr("GROUP_PAR", t["group_par"]) + arr("PAR_LINK", t["par_link"])
        + arr("LEV_OFF", t["lev_off"]) + arr("LEV_LINK", t["lev_link"])
        + arr("CH_OFF", t["ch_off"]) + arr("CH", t["ch"])
    )  # fmt: skip


def rr_tables(
    engine: BatchedEngine, lanes: int, *, tau_row: bool = False, policy: int = -1, hidden: int = 0,
    max_envs: int = RR_MAX_ENVS,
) -> dict:
    """What a relaxed-rigid kernel (``rr_step.cuh``) takes from the topology
    for ``lanes`` lanes an env: :func:`_lane_schedule`'s point slots and
    level schedule; ``slot``: floats of an env's slot in shared memory, with
    a row of the step's torques for an RK4 engine (captured once a step) or
    with ``tau_row`` (K3's and the env rollout's torques);
    ``rows``: an env's floats, the slot and, for the env rollout's MLP
    (``policy`` 2 with ``hidden`` units) whose hidden units do not fit beside
    the observation in the rows a step leaves dead (:func:`rr_dead_rows`), a row
    for them; ``block_floats``: the model arrays and the env rollout's
    candidate weights (``policy`` 0, 1 or 2); ``envs``: envs a block, the
    most up to ``max_envs`` whose rows and block floats fit in a block's
    shared memory; and ``smem_bytes``."""
    if engine.contact_model != "relaxed_rigid":
        raise ValueError(f"the relaxed-rigid kernel takes a relaxed-rigid engine, not {engine.contact_model}")
    if not engine.n_points:
        raise ValueError("the relaxed-rigid kernel needs contact points")
    t = _lane_schedule(engine, lanes)
    torques = engine.n_joints if tau_row or engine.integrator != "sie" else 0
    slot = 26 * engine.n_links + 36 + 24 * len(t["par_link"]) + torques
    n_params = sum(x.numel() for x in engine.params().values())
    obs = 2 * engine.n_joints + 11
    rows = slot + (hidden if policy == 2 and obs + hidden + 1 > rr_dead_rows(engine) else 0)
    block_floats = n_params + (policy_weight_count(engine.n_joints, policy, hidden) if policy >= 0 else 0)
    envs = max_envs
    while (rows * (envs + 1) + block_floats) * 4 > MAX_SMEM_BYTES and envs > 1 and (envs // 2) * lanes % 32 == 0:
        envs //= 2
    smem = (rows * (envs + 1) + block_floats) * 4
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a relaxed-rigid block of {envs} envs needs {smem} B of shared memory")
    return dict(t, slot=slot, rows=rows, block_floats=block_floats, envs=envs, smem_bytes=smem)


def rr_dead_rows(engine: BatchedEngine) -> int:
    """Floats of a relaxed-rigid slot that no thread reads between a step's
    contact solve and the next step's free ABA (its F rows and the base
    factor L0): the env rollout's observation, hidden units and done flag
    live there between steps."""
    return 6 * engine.n_links + 36


# Floats of K4-rr's tape past its slot (``step_vjp_rr.cu``): a link's, a
# point's and the base's.
VJP_RR_FLOATS = (84, 3, 43)


def vjp_rr_tables(engine: BatchedEngine, lanes: int, params_grad: bool = False, *, max_envs: int) -> dict:
    """What K4-rr (``step_vjp_rr.cu``) takes from the topology for ``lanes``
    lanes an env: :func:`rr_tables`' schedule and slot (without a torque
    row: K4-rr reads the torques from device memory); ``rows``: an env's
    floats, the slot and the tape past it; ``envs``: envs a block, the most
    up to ``max_envs``, in whole warps, whose rows, the model arrays and,
    with ``params_grad``, a row of model-array cotangents a warp fit in a
    block's shared memory; ``smem_bytes``; and ``par_row``, each link's row
    among the contact parents (-1 for a link without points)."""
    t = rr_tables(engine, lanes, max_envs=max_envs)
    link, point, base = VJP_RR_FLOATS
    rows = t["slot"] + link * engine.n_links + point * engine.n_points + base
    n_params = sum(x.numel() for x in engine.params().values())

    def smem(envs):
        return 4 * (rows * (envs + 1) + n_params + (envs * lanes // 32 * n_params if params_grad else 0))

    warp = 32 // lanes
    envs = max_envs - max_envs % warp
    while envs > warp and smem(envs) > MAX_SMEM_BYTES:
        envs -= warp
    if envs < warp or smem(envs) > MAX_SMEM_BYTES:
        raise ValueError(f"a K4-rr block of {warp} envs at {lanes} lanes needs {smem(warp)} B of shared memory")
    return dict(t, rows=rows, envs=envs, smem_bytes=smem(envs), par_row=rr_lane_aba(t)["par"])


def rr_lane_aba(t: dict) -> dict:
    """What the relaxed-rigid step's free ABA on an env's lanes
    (``rr_step.cuh``) takes from a :func:`_lane_schedule` ``t``: ``width``,
    the most links a level holds (at least 1); ``pos``, each link's place in
    its level (the base's 0), so link ``i`` runs on lane ``pos[i] % lanes``
    in round ``pos[i] // lanes``; ``pulls``, the most children a link has,
    for the base, then for each level; and ``par``, each link's row among the
    contact parents (-1 for a link without points)."""
    off, links, ch_off = t["lev_off"], t["lev_link"], t["ch_off"]
    pos = [0] * (len(ch_off) - 1)
    for lev in range(t["n_lev"]):
        for n in range(off[lev], off[lev + 1]):
            pos[links[n]] = n - off[lev]
    n_ch = [ch_off[i + 1] - ch_off[i] for i in range(len(pos))]
    pulls = [n_ch[0]] + [max(n_ch[links[n]] for n in range(off[lev], off[lev + 1])) for lev in range(t["n_lev"])]
    width = max([off[lev + 1] - off[lev] for lev in range(t["n_lev"])], default=1)
    par = [t["par_link"].index(i) if i in t["par_link"] else -1 for i in range(len(pos))]
    return dict(width=width, pos=pos, pulls=pulls, par=par)


def _lane_aba_header(t: dict) -> str:
    """:func:`rr_lane_aba`'s part of the forward kernels' generated header
    (K4-rr's has none: ``rr_step.cuh`` compiles the free ABA on the lanes
    only where ``JX_RR_WIDTH`` is defined)."""
    a = rr_lane_aba(t)

    def arr(name, values):
        return f"__constant__ int JX_RR_{name}[{len(values)}] = {{{', '.join(map(str, values))}}};\n"

    return f"#define JX_RR_WIDTH {a['width']}\n" + arr("POS", a["pos"]) + arr("PULLS", a["pulls"]) + arr("PAR_OF", a["par"])


def rr_header(engine: BatchedEngine, defines: dict) -> str:
    """The relaxed-rigid kernel's part of the generated header (:func:`rr_tables`
    of the job's ``defines``; K4-rr's, ``JX_RR_VJP``, :func:`vjp_rr_tables`)."""
    if defines.get("JX_RR_VJP"):
        t = vjp_rr_tables(engine, defines["JX_RR_LANES"], bool(defines.get("JX_PARAMS_GRAD")),
                          max_envs=defines["JX_RR_MAX_ENVS"])  # fmt: skip
        rows = ", ".join(map(str, t["par_row"]))
        return (_schedule_header("JX_RR", t) + f"#define JX_RR_ROWS {t['rows']}\n"
                + f"__constant__ int JX_RR_PAR_ROW[{engine.n_links}] = {{{rows}}};\n")  # fmt: skip
    t = rr_tables(
        engine, defines["JX_RR_LANES"], tau_row=bool(defines.get("JX_RR_TAU_ROW")),
        policy=defines.get("JX_POLICY", -1), hidden=defines.get("JX_HIDDEN", 0),
        max_envs=defines.get("JX_RR_MAX_ENVS", RR_MAX_ENVS),
    )  # fmt: skip
    return _schedule_header("JX_RR", t) + f"#define JX_RR_ROWS {t['rows']}\n" + _lane_aba_header(t)


# Floats of the lane-spread soft step's slot (soft_step_lanes.cuh) in each
# layout: a link's rows, a contact parent's and the base's, in K4's layout
# (``forward`` False) and in the forward-only one of the rollouts K1 and K5,
# which adds the state: 2 floats a joint, 13 for the base and 3 an m row.
LN_FLOATS = {False: (106, 30, 43), True: (54, 6, 42)}
# Envs a block of the forward-only layout, at most: a block runs all its
# envs' steps, and 32 envs an SM put 8192 envs in two waves on 132 SMs.
LN_FORWARD_MAX_ENVS = 32


def policy_weight_count(n_joints: int, policy: int, hidden: int) -> int:
    """Floats of one candidate's weights in the env rollout (K5): none for
    the PD policy (0), ``W | b`` for the linear one (1), ``W1 | b1 | W2 |
    b2`` for the tanh MLP of ``hidden`` units (2)."""
    d = 2 * n_joints + 11
    return {0: 0, 1: n_joints * d + n_joints, 2: hidden * d + hidden + n_joints * hidden + n_joints}[policy]


def lane_tables(
    engine: BatchedEngine, lanes: int, params_grad: bool = False, *, forward: bool = False, policy: int = -1,
    hidden: int = 0, step_envs: int = 0,
) -> dict:
    """What the lane-spread soft step (``soft_step_lanes.cuh``) takes from
    the topology for ``lanes`` lanes an env: :func:`_lane_schedule`'s point
    slots and level schedule, and the slot of shared memory an env takes
    with the block around it.

    K4 (``step_vjp.cu``, ``forward`` False) takes K4's layout and a block of
    one warp (32 / ``lanes`` envs), with ``params_grad`` a row of the model
    arrays' cotangents. The rollouts take the forward-only layout
    (``forward``) and a block of ``LN_FORWARD_MAX_ENVS`` envs, with the model
    arrays; the env rollout (K5, ``policy`` 0, 1 or 2 with ``hidden`` units)
    also a candidate's weights, and for each env its torques and hidden
    units; the rollout K1 of an RK4 engine a row of the step's torques,
    captured once a step. The one-step kernels (K2, K3: ``forward`` with ``step_envs``)
    take a block of ``step_envs`` envs, each with a row of torques, and the
    model arrays. Each halves its envs while the block does not fit in its shared
    memory.

    Returns the schedule with ``slot``: floats of the step's slot an env;
    ``env_floats``: the kernel's floats an env past it; ``block_floats``: the
    block's floats beside the slots; ``envs``: envs a block; ``stride``: the
    odd stride of a slot's fields (the block's envs minor); ``smem_bytes``;
    and ``par_row``, each link's row among the contact parents (-1 for a
    link without points)."""
    if engine.contact_model != "soft":
        raise ValueError(f"the lane-spread soft step takes a soft engine, not {engine.contact_model}")
    t = _lane_schedule(engine, lanes)
    link, par, base = LN_FLOATS[forward]
    slot = link * engine.n_links + par * len(t["par_link"]) + base
    n_params = sum(x.numel() for x in engine.params().values())
    if forward:
        slot += 2 * engine.n_joints + 13 + 3 * engine.m_rows
        if policy < 0 and not step_envs and engine.integrator != "sie":
            slot += engine.n_joints
    if step_envs:
        block_floats, env_floats, envs = n_params, engine.n_joints, step_envs
    elif forward:
        block_floats = n_params + (policy_weight_count(engine.n_joints, policy, hidden) if policy >= 0 else 0)
        env_floats = engine.n_joints + (hidden if policy == 2 else 0) if policy >= 0 else 0
        envs = LN_FORWARD_MAX_ENVS
    else:
        block_floats, env_floats, envs = n_params if params_grad else 0, 0, 32 // lanes

    def smem(envs):
        return 4 * ((slot + env_floats) * (envs + 1 - envs % 2) + block_floats)

    while smem(envs) > MAX_SMEM_BYTES and envs > 1:
        envs //= 2
    if smem(envs) > MAX_SMEM_BYTES:
        raise ValueError(f"one env of the lane-spread step needs {smem(envs)} B of shared memory")
    par_row = [t["par_link"].index(i) if i in t["par_link"] else -1 for i in range(engine.n_links)]
    return dict(
        t, par_row=par_row, slot=slot, env_floats=env_floats, block_floats=block_floats, envs=envs,
        stride=envs + 1 - envs % 2, smem_bytes=smem(envs),
    )  # fmt: skip


def lane_header(engine: BatchedEngine, defines: dict) -> str:
    """The lane-spread soft step's part of the generated header
    (:func:`lane_tables` of the job's ``defines``): the schedule, and each
    link's row among the contact parents (-1 for a link without points)."""
    t = lane_tables(
        engine, defines["JX_LN_LANES"], bool(defines.get("JX_PARAMS_GRAD")),
        forward=bool(defines.get("JX_LN_FORWARD")), policy=defines.get("JX_POLICY", -1),
        hidden=defines.get("JX_HIDDEN", 0), step_envs=defines.get("JX_STEP_ENVS", 0),
    )  # fmt: skip
    rows = ", ".join(map(str, t["par_row"]))
    return _schedule_header("JX_LN", t) + f"__constant__ int JX_LN_PAR_ROW[{engine.n_links}] = {{{rows}}};\n"


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
            lib = _load(so, job.signatures)
            _BUILDS[handle] = KernelBuild(
                lib=lib,
                path=so,
                seconds=seconds.get(keyed[handle], 0.0),
                ptxas_log=log.read_text() if log.exists() else "",
                param_count=lib.jx_param_count(),
            )
    return [_BUILDS[handle] for handle in handles]


def build(job: BuildJob) -> KernelBuild:
    """:func:`build_many` of one job, kept by engine and job after the first
    call, so a wrapper's launch regenerates no header."""
    key = (job.source, job.defines, *((job.engine._rr_n_iter, job.engine.integrator) if job.engine is not None else ()))
    cache = _NO_ENGINE_BUILDS if job.engine is None else _ENGINE_BUILDS.setdefault(job.engine, {})
    kernel = cache.get(key)
    if kernel is None:
        kernel = cache[key] = build_many([job])[0]
    return kernel


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


_STATE_NAMES = tuple(f"state.{f.name}" for f in dataclasses.fields(BatchedState))


_INTEGRATOR_NAMES = dict(sie="semi-implicit Euler", rk4="RK4", rk4fast="RK4-fast")


def check_cuda_call(engine: BatchedEngine, state: BatchedState, contact_models=("soft",), integrators=("sie",)) -> int:
    """What every kernel takes: a flat-ground float32 engine with one of the
    kernel's ``contact_models`` and ``integrators``, and a state on the
    engine's device, float32, contiguous, of the engine's shapes. Returns the
    batch size."""
    if engine.contact_model not in contact_models:
        raise ValueError(
            f"this kernel implements {' and '.join(contact_models)} contacts, not {engine.contact_model}"
        )
    if engine.integrator not in integrators:
        raise ValueError(
            f"this kernel implements {', '.join(_INTEGRATOR_NAMES[i] for i in integrators)}, "
            f"not {_INTEGRATOR_NAMES[engine.integrator]}"
        )
    if not engine.flat:
        raise ValueError("the CUDA kernels implement flat ground only")
    S = engine.S
    if S.dtype != torch.float32:
        raise ValueError(f"the kernel takes a float32 engine, got {S.dtype}")
    B = state.p.shape[-1]
    n, device = engine.n_joints, S.device
    shapes = ((n, B), (n, B), (3, B), (4, B), (6, B), (engine.m_rows, 3, B))
    for name, t, shape in zip(_STATE_NAMES, state.fields(), shapes):
        check_tensor(name, t, shape, device)
    return B


def check_tensor(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if t.device == device and t.dtype == dtype and t.shape == tuple(shape) and t.is_contiguous():
        return  # the common case, in one test
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


def geometry(kernel: KernelBuild, fn: str) -> dict[str, int]:
    """A kernel's launch from its geometry entry point ``fn``: threads and
    envs a block, the dynamic shared memory a block takes in bytes, and the
    blocks an SM holds at once (CUDA's occupancy calculator)."""
    out = (ctypes.c_int * 4)()
    rc = getattr(kernel.lib, fn)(ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"{fn} failed: {kernel.lib.jx_error_string(rc).decode()}")
    return dict(threads=out[0], envs=out[1], smem_bytes=out[2], blocks_per_sm=out[3])


def local_memory(kernel: KernelBuild, windows: dict[str, tuple[str, int, int]]) -> dict[str, int]:
    """The local loads and stores (``LDL``, ``STL``) in a library's SASS
    (``nvdisasm -g`` of its cubin, which the ``-lineinfo`` build maps to
    source lines): in all, and in each window ``(file name, first line, line
    past the last)``."""
    out_dir = kernel.path.parent / "cubin"
    out_dir.mkdir(exist_ok=True)
    subprocess.run([cuda_tool("cuobjdump"), "-xelf", "all", str(kernel.path)], cwd=out_dir,
                   check=True, capture_output=True)  # fmt: skip
    counts = dict.fromkeys(("all", *windows), 0)
    for cubin in sorted(out_dir.glob("*.cubin")):
        sass = subprocess.run([cuda_tool("nvdisasm"), "-g", "-c", str(cubin)],
                              check=True, capture_output=True, text=True).stdout  # fmt: skip
        here = None
        for ln in sass.splitlines():
            loc = re.search(r'//## File "([^"]+)", line (\d+)', ln)
            if loc:
                here = (pathlib.Path(loc.group(1)).name, int(loc.group(2)))
            elif re.search(r"\b(LDL|STL)(\.\w+)*\b", ln):
                counts["all"] += 1
                for name, (file, lo, hi) in windows.items():
                    if here and here[0] == file and lo <= here[1] < hi:
                        counts[name] += 1
    return counts


def launch(kernel: KernelBuild, fn: str, params: torch.Tensor | None, device: torch.device, *args) -> None:
    """Call entry point ``fn`` on the current stream of ``device``, after
    checking the packed model arrays against the kernel's layout (``None``
    for an entry point that takes none); raises on a launch error. The
    device context is switched only when ``device`` is not the current one."""
    if params is not None:
        if kernel.param_count != params.numel():
            raise RuntimeError("packed model arrays disagree with the kernel's layout")
        args = (params.data_ptr(), *args)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        # The raw handle of the current stream, without building a Stream.
        rc = getattr(kernel.lib, fn)(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            rc = getattr(kernel.lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: {kernel.lib.jx_error_string(rc).decode()}")
