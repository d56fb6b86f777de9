#!/usr/bin/env python3
"""Measure the CUDA rollout kernel's batch scaling, the plain twin's launch
pattern and the spread that float32 rounding leaves, on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 chip_probe.py [sweep] [profile] [rounding] [k1] [launch] [terminations] [rr]

With no argument it runs the first three. Probes of the flagship humanoid
(soft contacts, flat ground, PD policy):

* the batch sweep: device time of one 1000-step kernel launch at each batch
  size in ``BATCHES`` (CUDA events, median of ``REPEATS`` launches after a
  warm-up), and the rate in env·steps/s it implies;
* the plain twin under ``torch.profiler`` over ``PROFILE_STEPS`` steps at
  8192 envs: the number of CUDA kernels it launches and their device time;
* float32 rounding: from ``chip_smoke.py``'s two humanoid start states (rest,
  and the joints displaced and moving), 8192 envs after each of ``ROUNDING_STEPS``
  steps, the kernel and the float32 plain version each against the float64
  plain version, and against each other. Per field, the per-env |Δ| (the
  largest entry of the env's slice) at the 50th, 99th and 99.9th percentile
  over envs and at the max. It shows how far rounding alone carries two
  correct float32 trajectories apart, which sets ``chip_smoke.py``'s gate;
* k1: device time of the 8192-env, 1000-step K1 call (median of ``REPEATS``
  after a warm-up); it uses only what every version of the port has, so a
  copy of this script in an older checkout times that checkout's kernel;
* launch: one K1 launch against its steps (``LAUNCH_STEPS``) at two batch
  sizes (``LAUNCH_BATCHES``), and one K2 and one K3 launch beside it, each
  read three ways: CUDA events around the wrapper call (median of
  ``LAUNCH_REPEATS``), the kernel's own device time from ``torch.profiler``
  (mean over ``LAUNCH_REPEATS`` launches), and the wrapper's host time. The
  events' intercept is what a launch costs before its first step; the
  profiler says how much of it the kernel itself takes;
* terminations: the env rollout with real terminations as first posed (the
  linear policy with ``W, b = 0.2·N(0, 1)``, healthy height (0.6, 1.2) m,
  100 steps, from the joints-moving start at 8192 envs), run by the kernel,
  the float32 plain version and the float64 plain version: for each pair,
  the share of envs whose resets, and whose step counts, agree;
* rr: K1's relaxed-rigid build on the humanoid (``chip_smoke.py``'s
  relaxed-rigid model) from the relaxed-rigid main path's start: device ms a
  step at 8192 envs for each PCG budget in ``RR_ITERATIONS`` (a step makes
  iterations + 2 M⁻¹Jᵀ passes), with the least-squares ms a pass and the
  intercept; then at each batch size in ``RR_BATCHES`` with the humanoid's
  own budget. Each build's ptxas registers and frame are printed.

It prints the card's name and power limit, then JSON lines keyed by probe,
and exits non-zero when no CUDA device is visible.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

BATCHES = (1024, 4096, 8192, 16384, 32768, 65536, 131072)
HORIZON = 1000
REPEATS = 3
PROFILE_BATCH = 8192
PROFILE_STEPS = 2
ROUNDING_STEPS = (1, 10, 100)
QUANTILES = (0.5, 0.99, 0.999)
K1_REPEATS = 5
LAUNCH_STEPS = (1, 2, 10, 100)
LAUNCH_BATCHES = (1024, 8192)
LAUNCH_REPEATS = 15
TERMINATION_STEPS = 100
RR_ITERATIONS = (1, 2, 4, 8, 16)
RR_BATCHES = (8192, 32768, 65536)
RR_STEPS = 100


def _summary(a, b) -> dict[str, list[float]]:
    """Per field: the per-env |Δ| at each of QUANTILES over envs, then the max."""
    import torch

    out = {}
    for k, x, y in zip("s sd p q v m".split(), a.fields(), b.fields()):
        d = (x.double() - y.double()).abs().reshape(-1, x.shape[-1]).amax(0)
        qs = torch.quantile(d, torch.tensor(QUANTILES, dtype=d.dtype, device=d.device))
        out[k] = [float(v) for v in qs] + [float(d.max())]
    return out


def rounding_probe(hum, h64, start: str, state) -> None:
    """Kernel (k), float32 plain (t32) and float64 plain (t64) from one state."""
    from jaxsim_tpu_torch.ops import cuda_rollout
    from jaxsim_tpu_torch.ops.batched_engine import BatchedState

    t32, t64 = state, BatchedState(*(t.double() for t in state.fields()))
    done = 0
    for n in ROUNDING_STEPS:
        k = cuda_rollout.rollout(hum, state, n)
        t32 = cuda_rollout.rollout_reference(hum, t32, n - done)
        t64 = cuda_rollout.rollout_reference(h64, t64, n - done)
        done = n
        print(json.dumps({"rounding": {
            "start": start, "steps": n, "quantiles": [*QUANTILES, "max"],
            "k-t32": _summary(k, t32), "k-t64": _summary(k, t64), "t32-t64": _summary(t32, t64),
        }}), flush=True)  # fmt: skip


def device_ms(fn, repeats: int) -> float:
    """Median CUDA-event milliseconds of ``repeats`` calls of ``fn``."""
    import torch

    ms = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.median(ms)


def sweep_probe(hum, gen) -> None:
    from jaxsim_tpu_torch.ops import cuda_rollout

    for B in BATCHES:
        state = hum.init_state(B, base_position=(0.0, 0.0, 0.9), generator=gen)
        cuda_rollout.rollout(hum, state, HORIZON)  # warm-up (and build)
        med = device_ms(lambda: cuda_rollout.rollout(hum, state, HORIZON), REPEATS)
        print(json.dumps({"sweep": {"B": B, "ms": med, "env_steps_per_s": B * HORIZON / (med * 1e-3)}}), flush=True)


def profile_probe(hum, gen) -> None:
    import torch

    from jaxsim_tpu_torch.ops import cuda_rollout

    state = hum.init_state(PROFILE_BATCH, base_position=(0.0, 0.0, 0.9), generator=gen)
    cuda_rollout.rollout_reference(hum, state, 1)  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cuda_rollout.rollout_reference(hum, state, PROFILE_STEPS)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(json.dumps({"plain_twin_profile": {
        "B": PROFILE_BATCH,
        "steps": PROFILE_STEPS,
        "cuda_kernels": len(kernels),
        "device_ms": device_us * 1e-3,
    }}), flush=True)  # fmt: skip


def k1_probe(hum, gen) -> float:
    from jaxsim_tpu_torch.ops import cuda_rollout

    state = hum.init_state(PROFILE_BATCH, base_position=(0.0, 0.0, 0.9), generator=gen)
    cuda_rollout.rollout(hum, state, HORIZON)  # warm-up (and build)
    med = device_ms(lambda: cuda_rollout.rollout(hum, state, HORIZON), K1_REPEATS)
    print(json.dumps({"k1": {"B": PROFILE_BATCH, "steps": HORIZON, "ms": med}}), flush=True)
    return med


def _profiled_us(fn, kernel: str) -> float:
    """Mean device microseconds of the CUDA kernels named ``kernel`` over
    ``LAUNCH_REPEATS`` calls of ``fn``, read by ``torch.profiler``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(LAUNCH_REPEATS):
            fn()
        torch.cuda.synchronize()
    times = [
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name
    ]  # fmt: skip
    if len(times) != LAUNCH_REPEATS:
        raise RuntimeError(f"the profiler saw {len(times)} launches of {kernel}, expected {LAUNCH_REPEATS}")
    return statistics.mean(times)


def _host_ms(fn) -> float:
    """Median host milliseconds of a call of ``fn`` (not synchronised)."""
    import time

    import torch

    times = []
    for _ in range(LAUNCH_REPEATS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def launch_probe(hum, gen) -> None:
    from jaxsim_tpu_torch.ops import cuda_rollout, cuda_step

    for B in LAUNCH_BATCHES:
        state = hum.init_state(B, base_position=(0.0, 0.0, 0.9), generator=gen)
        tau = (-60.0 * state.s - 0.5 * state.sd).contiguous()
        calls = {f"k1_{n}_steps": (lambda n=n: cuda_rollout.rollout(hum, state, n), "rollout_kernel")
                 for n in LAUNCH_STEPS}  # fmt: skip
        calls["k2"] = (lambda: cuda_step.step_pd(hum, state), "step_pd_kernel")
        calls["k3"] = (lambda: cuda_step.step_tau(hum, state, tau), "step_tau_kernel")
        for fn, _ in calls.values():
            fn()  # warm-up (and build)
        for name, (fn, kernel) in calls.items():
            print(json.dumps({"launch": {
                "B": B, "call": name, "event_ms": device_ms(fn, LAUNCH_REPEATS),
                "kernel_ms": _profiled_us(fn, kernel) * 1e-3, "host_ms": _host_ms(fn),
            }}), flush=True)  # fmt: skip


def terminations_probe(hum, gen) -> None:
    import torch

    from chip_smoke import humanoid_engine, pendulum_engine, start_states
    from jaxsim_tpu_torch.ops import cuda_env_rollout
    from jaxsim_tpu_torch.ops.policies import obs_dim

    state = start_states(pendulum_engine(hum.S.device), hum)["humanoid23 joints moving"][1]
    n, d = hum.n_joints, obs_dim(hum.n_joints)
    W = 0.2 * torch.randn(n, d, generator=gen, device=gen.device)
    b = 0.2 * torch.randn(n, 1, generator=gen, device=gen.device)
    opts = dict(healthy_z_range=(0.6, 1.2))
    h64 = humanoid_engine(hum.S.device).to(torch.float64)
    s64 = type(state)(*(t.double() for t in state.fields()))
    runs = {
        "k": cuda_env_rollout.env_rollout(hum, state, TERMINATION_STEPS, W=W, b=b, **opts),
        "t32": cuda_env_rollout.env_rollout_reference(hum, state, TERMINATION_STEPS, W=W, b=b, **opts),
        "t64": cuda_env_rollout.env_rollout_reference(
            h64, s64, TERMINATION_STEPS, W=W.double(), b=b.double(), **opts),
    }  # fmt: skip
    torch.cuda.synchronize()
    out = {name: {"envs_that_reset": int((r[2] > 0).sum()), "resets": int(r[2].sum())} for name, r in runs.items()}
    for x, y in (("k", "t32"), ("k", "t64"), ("t32", "t64")):
        (_, _, rx, sx), (_, _, ry, sy) = runs[x], runs[y]
        out[f"{x}-{y}"] = {
            "resets_equal_share": float((rx == ry).float().mean()),
            "steps_equal_share": float((sx == sy).float().mean()),
        }
    print(json.dumps({"terminations": {"B": state.p.shape[-1], "steps": TERMINATION_STEPS, **out}}), flush=True)


def rr_probe(hum, gen) -> None:
    from chip_smoke import rr_humanoid_engine
    from jaxsim_tpu_torch.ops import cuda_build, cuda_rollout

    engines = {}
    for n in RR_ITERATIONS:
        engines[n] = rr_humanoid_engine(hum.S.device)
        engines[n].rr_iterations = n
    own = rr_humanoid_engine(hum.S.device)
    builds = cuda_build.build_many([cuda_rollout.job(e) for e in (*engines.values(), own)])
    for n, b in zip((*RR_ITERATIONS, "own"), builds):
        ptxas = [ln.strip() for ln in b.ptxas_log.splitlines() if "registers" in ln or "stack frame" in ln]
        print(json.dumps({"rr_build": {"iterations": n, "ptxas": ptxas}}), flush=True)
    rows = []
    for n, eng in engines.items():
        state = eng.init_state(PROFILE_BATCH, generator=gen)
        cuda_rollout.rollout(eng, state, RR_STEPS)  # warm-up
        ms = device_ms(lambda: cuda_rollout.rollout(eng, state, RR_STEPS), REPEATS) / RR_STEPS
        rows.append((n + 2, ms))
        print(json.dumps({"rr_iterations": {"B": PROFILE_BATCH, "iterations": n, "passes": n + 2, "ms_per_step": ms}}),
              flush=True)  # fmt: skip
    mx, my = statistics.mean(r[0] for r in rows), statistics.mean(r[1] for r in rows)
    slope = sum((x - mx) * (y - my) for x, y in rows) / sum((x - mx) ** 2 for x, _ in rows)
    print(json.dumps({"rr_fit": {"ms_per_pass": slope, "ms_intercept": my - slope * mx}}), flush=True)
    for B in RR_BATCHES:
        state = own.init_state(B, generator=gen)
        cuda_rollout.rollout(own, state, RR_STEPS)  # warm-up
        ms = device_ms(lambda: cuda_rollout.rollout(own, state, RR_STEPS), REPEATS)
        print(json.dumps({"rr_sweep": {"B": B, "iterations": own._rr_n_iter, "ms": ms,
                                       "env_steps_per_s": B * RR_STEPS / (ms * 1e-3)}}), flush=True)  # fmt: skip


PROBES = {
    "sweep": sweep_probe,
    "profile": profile_probe,
    "k1": k1_probe,
    "launch": launch_probe,
    "terminations": terminations_probe,
    "rr": rr_probe,
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from chip_smoke import humanoid_engine, pendulum_engine, start_states

    names = sys.argv[1:] or ["sweep", "profile", "rounding"]
    unknown = set(names) - set(PROBES) - {"rounding"}
    if unknown:
        print(f"chip_probe: unknown probes {sorted(unknown)}", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)  # fmt: skip
    device = torch.device("cuda:0")
    hum = humanoid_engine(device)
    gen = torch.Generator(device).manual_seed(0)
    for name in names:
        if name == "rounding":
            h64 = humanoid_engine(device).to(torch.float64)
            starts = start_states(pendulum_engine(device), hum)
            for start in ("humanoid23 main-path start", "humanoid23 joints moving"):
                rounding_probe(hum, h64, start, starts[start][1])
        else:
            PROBES[name](hum, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
