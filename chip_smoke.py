#!/usr/bin/env python3
"""Drive the PyTorch port's flagship rollout once on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA rollout kernel from ``jaxsim_tpu_torch/csrc`` with
``nvcc``, holds it against its plain PyTorch version on the card in every
state field (the fixed-base pendulum, then the 23-DoF humanoid at 8192 envs
from the main path's start and with its joints moving; see ``CASES``), then
runs the main path: the humanoid with soft contacts on flat ground,
semi-implicit Euler and the PD policy ``tau = -60·s - 0.5·ṡ``, 8192 envs
and five chained 1000-step rollouts, each one kernel launch. It prints the
card's name and power limit, a JSON line with each kernel's numbers, and
last ``{"ok": true, "device": {...}}``. Any failure raises, and the script
then exits non-zero without that line; it also exits non-zero when no CUDA
device is visible.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

BATCH = 8192
HORIZON = 1000  # steps per main-path call
TIMED_CALLS = 5
# Kernel vs plain twin: the limit on |Δ| in every state field (s, sd, p, q, v,
# m), taken per env as the largest entry, then over the envs by the case's
# statistic (below).
TOL = 1e-3
# (start state, steps, statistic over envs). From rest every env is held at
# its max. With the joints moving, float32 rounding alone sends a few envs of
# 8192 far apart by 100 steps (the float32 and float64 plain versions differ
# there by up to 1.9e-2 in ṡ): that start is held at its max after 10 steps,
# and at the 99.9th percentile over envs after 100.
CASES = (
    ("pendulum1", 100, "max"),
    ("humanoid23 main-path start", 100, "max"),
    ("humanoid23 joints moving", 10, "max"),
    ("humanoid23 joints moving", 100, "p99.9"),
)
# m, plausible base heights after the main path: a humanoid that fell lies
# with the pelvis centre about its smallest half-extent (0.075 m) above the
# ground; lower means it sank through the floor, higher that it flew off.
HEIGHT_BAND = (0.05, 1.2)


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def humanoid_engine(device):
    """The flagship model, lowered as bench.py lowers it."""
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, models
    from jaxsim_tpu_torch.api.contact import estimate_good_contact_parameters

    model = JaxSimModel.build_from_model_description(models.build_humanoid_urdf())
    params = estimate_good_contact_parameters(
        model,
        number_of_active_collidable_points_steady_state=8,
        max_penetration=0.006,
        damping_ratio=0.15,
    )
    return BatchedEngine.build(model.replace(contact_params=params)).to(device)


def pendulum_engine(device):
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, models

    return BatchedEngine.build(
        JaxSimModel.build_from_model_description(models.build_pendulum_urdf(1))
    ).to(device)


def per_env_abs_diff(a, b) -> dict:
    """|Δ| per field and env: the largest entry of each env's slice."""
    return {
        k: (x - y).abs().reshape(-1, x.shape[-1]).amax(0)
        for k, x, y in zip("s sd p q v m".split(), a.fields(), b.fields())
    }


def all_finite(state) -> bool:
    import torch

    return all(bool(torch.isfinite(t).all()) for t in state.fields())


def compare(name, engine, state, n_steps, stat, sync) -> float:
    """Kernel vs plain version on the same state. Fails when ``stat`` (max or
    p99.9 over envs) of any field's per-env |Δ| exceeds TOL; returns the
    largest max |Δ| over the fields."""
    import torch

    from jaxsim_tpu_torch.ops import cuda_rollout

    kern = cuda_rollout.rollout(engine, state, n_steps)
    plain = cuda_rollout.rollout_reference(engine, state, n_steps)
    sync()
    if not (all_finite(kern) and all_finite(plain)):
        raise RuntimeError(f"{name}: non-finite state after {n_steps} steps")
    diff = per_env_abs_diff(kern, plain)
    err = {k: float(d.max()) for k, d in diff.items()}
    p999 = {k: float(torch.quantile(d.double(), 0.999)) for k, d in diff.items()}
    print(f"{name}: kernel vs plain after {n_steps} steps, max |Δ| {json.dumps(err)}, "
          f"p99.9 over envs {json.dumps(p999)}", flush=True)
    gated = err if stat == "max" else p999
    bad = {k: e for k, e in gated.items() if not e <= TOL}
    if bad:
        raise RuntimeError(f"{name}: kernel disagrees with plain beyond {TOL} ({stat}): {bad}")
    return max(err.values())


def moving_joints(state, gen):
    """The same envs with the joints displaced (0.3·N(0,1) rad) and moving
    (0.5·N(0,1) rad/s), so the PD torque and the velocity-product terms of
    the dynamics are far from zero."""
    import torch

    def noise(t, scale):
        return scale * torch.randn(t.shape, generator=gen, device=t.device)

    return dataclasses.replace(state, s=noise(state.s, 0.3), sd=noise(state.sd, 0.5))


def start_states(pend, hum) -> dict:
    """The kernel-vs-plain cases' start states, by name: (engine, state)."""
    import torch

    device = hum.S.device
    gen = torch.Generator(device).manual_seed(0)
    pend_state = pend.init_state(1024, base_position=(0.0, 0.0, 0.0))
    pend_state.s = (0.4 + 0.1 * torch.randn(pend_state.s.shape, generator=gen, device=device)).contiguous()
    state0 = hum.init_state(BATCH, base_position=(0.0, 0.0, 0.9), generator=gen)
    return {
        "pendulum1": (pend, pend_state),
        "humanoid23 main-path start": (hum, state0),
        "humanoid23 joints moving": (hum, moving_joints(state0, gen)),
    }


def main() -> int:
    import torch

    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(_run(["nvcc", "--version"]).splitlines()[-1], flush=True)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])

    from jaxsim_tpu_torch.ops import cuda_rollout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    sync = torch.cuda.synchronize

    # ----- build -----
    hum = humanoid_engine(device)
    pend = pendulum_engine(device)
    t0 = time.perf_counter()
    builds = [cuda_rollout.build(e) for e in (pend, hum)]
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {[round(b.seconds, 2) for b in builds]} s)")
    for b in builds:
        print(f"ptxas {b.path.parent.name}: " + " | ".join(
            ln.strip() for ln in b.ptxas_log.splitlines() if "registers" in ln or "spill" in ln or "stack frame" in ln
        ), flush=True)

    # ----- kernel vs plain -----
    starts = start_states(pend, hum)
    state0 = starts["humanoid23 main-path start"][1]
    max_errs = []
    for name, n_steps, stat in CASES:
        engine, state = starts[name]
        err = compare(f"{name} B={state.p.shape[-1]}", engine, state, n_steps, stat, sync)
        if stat == "max":
            max_errs.append(err)

    # ----- main path -----
    cuda_rollout.ROLLOUT_KERNEL_LAUNCHES = 0
    out = cuda_rollout.rollout(hum, state0, HORIZON)  # warm-up
    sync()
    wall, dev_ms = [], []
    for _ in range(TIMED_CALLS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = cuda_rollout.rollout(hum, out, HORIZON)
        end.record()
        sync()
        wall.append(time.perf_counter() - t0)
        dev_ms.append(start.elapsed_time(end))
    launches = cuda_rollout.ROLLOUT_KERNEL_LAUNCHES
    kernel_s = statistics.median(wall)
    print(f"kernel: {BATCH}x{HORIZON} steps per call, wall s {wall}, device ms {dev_ms}")
    print(f"kernel env_steps_per_s (median): {BATCH * HORIZON / kernel_s:.6g}", flush=True)

    sync()
    t0 = time.perf_counter()
    plain = cuda_rollout.rollout_reference(hum, state0, HORIZON)
    sync()
    plain_s = time.perf_counter() - t0
    print(f"plain twin: {BATCH}x{HORIZON} steps in {plain_s:.4f} s, env_steps_per_s {BATCH * HORIZON / plain_s:.6g}")

    # ----- checks -----
    if launches != 1 + TIMED_CALLS:
        raise RuntimeError(f"main path launched the kernel {launches} times, expected {1 + TIMED_CALLS}")
    if not (all_finite(out) and all_finite(plain)):
        raise RuntimeError("non-finite final state")
    z = out.p[2]
    z_min, z_max = float(z.min()), float(z.max())
    standing = float((z > 0.5).float().mean())
    print(f"base height after {(1 + TIMED_CALLS) * HORIZON} steps: min {z_min:.4f} m,"
          f" max {z_max:.4f} m, share of envs above 0.5 m {standing:.4f}")
    if not HEIGHT_BAND[0] <= z_min <= z_max <= HEIGHT_BAND[1]:
        raise RuntimeError(f"base height outside {HEIGHT_BAND} m")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "rollout",
        "route": "cuda",
        "source": "jaxsim_tpu_torch/csrc/rollout.cu",
        "replaces": "jaxsim_tpu/ops/pallas_step.py:664",
        "launches": launches,
        "max_abs_err": max(max_errs),
        "ms": statistics.median(dev_ms),
        "plain_ms": plain_s * 1e3,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
