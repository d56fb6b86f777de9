#!/usr/bin/env python3
"""Measure the CUDA rollout kernel's batch scaling, the plain twin's launch
pattern and the spread that float32 rounding leaves, on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 chip_probe.py

Three probes of the flagship humanoid (soft contacts, flat ground, PD policy):

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
  correct float32 trajectories apart, which sets ``chip_smoke.py``'s gate.

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from chip_smoke import humanoid_engine, pendulum_engine, start_states
    from jaxsim_tpu_torch.ops import cuda_rollout

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)  # fmt: skip
    device = torch.device("cuda:0")
    hum = humanoid_engine(device)
    gen = torch.Generator(device).manual_seed(0)

    sweep = []
    for B in BATCHES:
        state = hum.init_state(B, base_position=(0.0, 0.0, 0.9), generator=gen)
        cuda_rollout.rollout(hum, state, HORIZON)  # warm-up (and build)
        ms = []
        for _ in range(REPEATS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            cuda_rollout.rollout(hum, state, HORIZON)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        med = statistics.median(ms)
        sweep.append({"B": B, "ms": med, "env_steps_per_s": B * HORIZON / (med * 1e-3)})
        print(json.dumps({"sweep": sweep[-1]}), flush=True)

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

    h64 = humanoid_engine(device).to(torch.float64)
    starts = start_states(pendulum_engine(device), hum)
    for name in ("humanoid23 main-path start", "humanoid23 joints moving"):
        rounding_probe(hum, h64, name, starts[name][1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
