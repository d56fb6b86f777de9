#!/usr/bin/env python3
"""Measure the CUDA rollout kernel's batch scaling, the plain twin's launch
pattern and the spread that float32 rounding leaves, on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 chip_probe.py [sweep] [profile] [rounding] [k1] [launch] [terminations] [rr] [rr_faults] [param_sum]
        [profiler] [vjp] [vjp_faults]

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
  sizes (``LAUNCH_BATCHES``), and one K2, one K3 and one launch of K4's
  partials' sum beside it, and ``torch.sum`` of the same partials, each
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
* rr: K1's relaxed-rigid kernel on the humanoid (``chip_smoke.py``'s
  relaxed-rigid model) from the relaxed-rigid main path's start: for each
  count of lanes an env in ``RR_LANES`` (1 is one thread an env), device ms
  a step at 8192 envs for each PCG budget in ``RR_ITERATIONS`` (a step makes
  iterations + 2 M⁻¹Jᵀ passes), with the least-squares ms a pass and the
  intercept; then, with the wrapper's lanes, at each batch size in
  ``RR_BATCHES`` with the humanoid's own budget. Each build's ptxas
  registers and frame and its launch geometry are printed, and at the
  humanoid's budget the local loads and stores in its SASS;
* param_sum: K4's partials' sum at each of ``SUM_WARPS`` warps a block,
  kernel-only and event µs beside ``torch.sum``'s;
* profiler: how many of ``LAUNCH_REPEATS`` short launches (K2 at 1024
  envs, K4's partials' sum, ``torch.sum``) ``torch.profiler`` records in
  each of ``PROFILER_WINDOWS`` windows, with and without idle host time
  at the window's ends;
* rr_faults: ``RR_FAULTS`` seeded into copies of ``csrc/`` under ``build/``,
  each held with the sound kernel to ``chip_smoke.py``'s RR_CASES limits:
  per case the worst field's statistic over its limit (> 1 is refused);
* vjp: K4 (the fused step VJP) at each count of lanes an env in
  ``VJP_LANES``, plain and with the model arrays' cotangents, on the
  humanoid at 8192 envs (the gradient main paths' start and PD torques) and
  on garpez at 1024 (the APG start and policy), for one seeded output
  cotangent: each build's ptxas line, launch geometry (envs and shared
  memory a block, blocks an SM) and local loads and stores in its SASS (in
  all, the forward recompute, the reverse sweep); kernel-only ms
  (``torch.profiler``, mean of ``LAUNCH_REPEATS``) and CUDA-event ms of a
  launch (median); and the worst cotangent's |Δ| over max(1, max |plain|)
  and the model arrays' share of ``chip_smoke.py``'s limit;
* vjp_faults: ``VJP_FAULTS`` seeded into copies of ``csrc/`` under
  ``build/``, each held with the sound kernel to ``chip_smoke.py``'s K4
  limits (``vjp_gates``): per case the worst statistic over its limit.

It prints the card's name and power limit, then JSON lines keyed by probe,
and exits non-zero when no CUDA device is visible.
"""

from __future__ import annotations

import dataclasses
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
RR_ITERATIONS = (1, 4, 8, 16)
SUM_WARPS = (16, 32, 8)  # the partials' sum's warps a block; the first is step_vjp.cu's
RR_LANES = (1, 4, 8)
PROFILER_WINDOWS = 20
PROFILER_PADS_S = (0.0, 0.02)
RR_BATCHES = (8192, 32768, 65536)
VJP_LANES = (4, 8, 16, 1)  # K4's lanes an env; the first is the wrapper's
VJP_BATCH = dict(humanoid23=8192, garpez=1024)
RR_STEPS = 100
# Seeded faults of the relaxed-rigid step, each one edit of rr_step.cuh
# (the text, its replacement): the impedance floor dropped from the
# regularizer, the warm start forced cold, one PCG iteration fewer.
RR_FAULTS = {
    "impedance floor dropped": (
        """((coeff[0] * Mi[j] + coeff[1] * Mi[3 + j] + coeff[2] * Mi[6 + j]) +
                               ((1.0f - xi[j]) / (xi[j] + 1e-12f)) * Mi[j * 4])""",
        "(coeff[0] * Mi[j] + coeff[1] * Mi[3 + j] + coeff[2] * Mi[6 + j])",
    ),
    "warm start forced cold": (
        "x[k * 3 + j] = warm > 0.0f ? a_k * m[k * 3 + j] : neg_b / prec;",
        "x[k * 3 + j] = neg_b / prec;",
    ),
    "one PCG iteration fewer": (
        "for (int it = -1; it <= JX_RR_ITERS; ++it) {\n    const bool first = it < 0, last = it == JX_RR_ITERS;",
        "for (int it = -1; it <= JX_RR_ITERS - 1; ++it) {\n    const bool first = it < 0, last = it == JX_RR_ITERS - 1;",
    ),
}


# Seeded faults of K4, each one edit (the file of csrc/, the text, its
# replacement): the Coriolis term's adjoint (c = v x vJ) dropped, the slip
# scaling's adjoint dropped, the model arrays' sum over the block's envs
# started a lane too low (so it adds a neighbouring link's contribution),
# and the points' group sum run one lane past the env (so it adds the next
# env's).
VJP_FAULTS = {
    "Coriolis dropped": ("step_vjp.cu", "        vx_vjp(v, vJ, gc, gv, bvJ);\n", ""),
    "slip scaling dropped": ("step_vjp.cu", "bft[j] += scale * bfs[j];", "bft[j] += bfs[j];"),
    "env sum takes a neighbouring link": (
        "step_vjp.cu", "for (int o = G; o < LN_THREADS; o <<= 1)", "for (int o = G / 2; o < LN_THREADS; o <<= 1)"
    ),
    "group sum crosses into the next env": (
        "soft_step_lanes.cuh", "for (int off = 1; off < G; off <<= 1)", "for (int off = 1; off <= G; off <<= 1)"
    ),
}


def _seeded_copy(kind: str, name: str, file: str, old: str, new: str):
    """A copy of ``csrc/`` under ``build/<kind>/<name>`` with ``old``
    replaced by ``new`` in ``file`` (which must hold it once)."""
    import shutil

    from jaxsim_tpu_torch.ops import cuda_build

    copy = cuda_build.BUILD_DIR.parent / kind / name
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, copy)
    text = (copy / file).read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: the text to replace is not in {file} once")
    (copy / file).write_text(text.replace(old, new))
    return copy


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
    from chip_smoke import profiled_ms

    return profiled_ms(fn, kernel, LAUNCH_REPEATS) * 1e3


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
    import torch

    from jaxsim_tpu_torch.ops import cuda_build, cuda_rollout, cuda_step, cuda_step_vjp

    for B in LAUNCH_BATCHES:
        state = hum.init_state(B, base_position=(0.0, 0.0, 0.9), generator=gen)
        tau = (-60.0 * state.s - 0.5 * state.sd).contiguous()
        calls = {f"k1_{n}_steps": (lambda n=n: cuda_rollout.rollout(hum, state, n), "rollout_kernel")
                 for n in LAUNCH_STEPS}  # fmt: skip
        calls["k2"] = (lambda: cuda_step.step_pd(hum, state), "step_pd_kernel")
        calls["k3"] = (lambda: cuda_step.step_tau(hum, state, tau), "step_tau_kernel")
        # K4's partials' sum at this B's blocks, and torch.sum of the same
        # (whose one kernel is every kernel the profiler sees).
        partials = torch.randn(-(-B // cuda_step_vjp.envs_per_block(hum, True)), cuda_build.packed_params(hum).numel(),
                               generator=gen, device=gen.device)  # fmt: skip
        calls["param_sum"] = (lambda: cuda_step_vjp.sum_partials(hum, partials), "param_sum_kernel")
        calls["torch_sum"] = (lambda: torch.sum(partials, 0), "")
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
    keys = [(lanes, n) for lanes in RR_LANES for n in RR_ITERATIONS]
    builds = dict(zip(keys, cuda_build.build_many([cuda_rollout.job(engines[n], lanes) for lanes, n in keys])))
    for (lanes, n), b in builds.items():
        ptxas = [ln.strip() for ln in b.ptxas_log.splitlines() if "registers" in ln or "stack frame" in ln]
        print(json.dumps({"rr_build": {"lanes": lanes, "iterations": n, "ptxas": ptxas,
                                       "geometry": cuda_rollout.rr_geometry(b)}}), flush=True)  # fmt: skip
        if n == own._rr_n_iter:
            print(json.dumps({"rr_sass": {"lanes": lanes, "local_loads_and_stores": cuda_rollout.rr_local_memory(b)}}),
                  flush=True)  # fmt: skip
    for lanes in RR_LANES:
        rows = []
        for n, eng in engines.items():
            kernel = builds[(lanes, n)]
            state = eng.init_state(PROFILE_BATCH, generator=gen)
            cuda_rollout.launch(kernel, eng, state, RR_STEPS, 60.0, 0.5)  # warm-up
            ms = device_ms(lambda: cuda_rollout.launch(kernel, eng, state, RR_STEPS, 60.0, 0.5), REPEATS) / RR_STEPS
            rows.append((n + 2, ms))
            print(json.dumps({"rr_iterations": {"B": PROFILE_BATCH, "lanes": lanes, "iterations": n, "passes": n + 2,
                                                "ms_per_step": ms}}), flush=True)  # fmt: skip
        mx, my = statistics.mean(r[0] for r in rows), statistics.mean(r[1] for r in rows)
        slope = sum((x - mx) * (y - my) for x, y in rows) / sum((x - mx) ** 2 for x, _ in rows)
        print(json.dumps({"rr_fit": {"lanes": lanes, "ms_per_pass": slope, "ms_intercept": my - slope * mx}}),
              flush=True)  # fmt: skip
    for B in RR_BATCHES:
        state = own.init_state(B, generator=gen)
        cuda_rollout.rollout(own, state, RR_STEPS)  # warm-up
        ms = device_ms(lambda: cuda_rollout.rollout(own, state, RR_STEPS), REPEATS)
        print(json.dumps({"rr_sweep": {"B": B, "lanes": cuda_rollout.RR_LANES, "iterations": own._rr_n_iter, "ms": ms,
                                       "env_steps_per_s": B * RR_STEPS / (ms * 1e-3)}}), flush=True)  # fmt: skip


def rr_faults_probe(hum, gen) -> None:
    """Each of RR_FAULTS seeded into a copy of ``csrc/`` under ``build/``,
    built beside the sound source, and every variant held to
    ``chip_smoke.py``'s RR_CASES limits: per case, the worst field's
    statistic over its limit (> 1 is refused)."""
    import torch

    from chip_smoke import rr_garpez_engine, rr_gates, rr_humanoid_engine, rr_start_states, rr_touchdown_engine
    from jaxsim_tpu_torch.ops import cuda_build, cuda_rollout

    device = hum.S.device
    hum_rr, garp_rr, hum_td = rr_humanoid_engine(device), rr_garpez_engine(device), rr_touchdown_engine(device)
    sources = {"control": cuda_rollout.RR_SOURCE}
    for name, (old, new) in RR_FAULTS.items():
        sources[name] = _seeded_copy("rr_faults", name, "rr_step.cuh", old, new) / "rollout_rr.cu"
    jobs = {(name, id(eng)): dataclasses.replace(cuda_rollout.job(eng), source=src)
            for name, src in sources.items() for eng in (hum_rr, garp_rr, hum_td)}  # fmt: skip
    kernels = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))

    def variant(name):
        return lambda eng, st, n, kp, kd: cuda_rollout.launch(kernels[(name, id(eng))], eng, st, n, kp, kd)

    starts = rr_start_states(hum_rr, garp_rr, hum_td, torch.Generator(device).manual_seed(6))
    _, ratios = rr_gates(starts, {name: variant(name) for name in sources})
    print(json.dumps({"rr_faults": ratios}), flush=True)


def _vjp_cases(hum):
    """K4's probe cases by name: (engine, state, torques)."""
    import torch

    from chip_smoke import apg_policy, apg_setup, garpez_engine

    garp = garpez_engine(hum.S.device)
    apg = apg_setup(garp)
    state = hum.init_state(VJP_BATCH["humanoid23"], base_position=(0.0, 0.0, 0.9),
                           generator=torch.Generator(hum.S.device).manual_seed(0))  # fmt: skip
    with torch.no_grad():
        garp_tau = apg_policy(apg["start"], apg["weights"], apg["target"]).contiguous()
    return dict(
        humanoid23=(hum, state, (-60.0 * state.s - 0.5 * state.sd).contiguous()),
        garpez=(garp, apg["start"], garp_tau),
    )


def vjp_probe(hum, gen) -> None:
    """K4 at each count of lanes in VJP_LANES, plain and with params_grad,
    on the humanoid and on garpez (``_vjp_cases``): ptxas, geometry, SASS
    local accesses, kernel-only and event ms, and its distance to plain."""
    import torch

    from chip_smoke import params_shares, profiled_ms, vjp_cotangents, vjp_diff
    from jaxsim_tpu_torch.ops import cuda_build, cuda_step_vjp

    cases = _vjp_cases(hum)
    keys = [(name, lanes, pg) for name in cases for lanes in VJP_LANES for pg in (False, True)]
    jobs = [cuda_step_vjp.job(cases[name][0], pg, lanes) for name, lanes, pg in keys]
    builds = dict(zip(keys, cuda_build.build_many(jobs)))
    for (name, lanes, pg), kernel in builds.items():
        engine, state, tau = cases[name]
        ct = vjp_cotangents(state, gen)["all six"]

        def run():
            return cuda_step_vjp.launch(kernel, engine, state, tau, ct, None, pg, lanes)

        got = run()
        plain = cuda_step_vjp.step_vjp_reference(engine, state, tau, ct, params_grad=pg)
        torch.cuda.synchronize()
        scaled, _ = vjp_diff(got, plain)
        err = {"cotangents": max(float(d.max()) for d in scaled.values())}
        if pg:
            sums = cuda_step_vjp.unpack_params(engine, got[2].sum(0))
            err["params_share"] = max(params_shares(sums, plain[2]).values())
        print(json.dumps({"vjp": {
            "model": name, "B": state.p.shape[-1], "lanes": lanes, "params_grad": pg,
            "ptxas": [ln.strip() for ln in kernel.ptxas_log.splitlines() if "registers" in ln or "stack frame" in ln],
            "geometry": cuda_step_vjp.geometry(kernel), "local_loads_and_stores": cuda_step_vjp.local_memory(kernel),
            "kernel_ms": profiled_ms(run, "step_vjp_kernel", LAUNCH_REPEATS),
            "event_ms": device_ms(run, LAUNCH_REPEATS), "vs_plain": err,
        }}), flush=True)  # fmt: skip


def vjp_faults_probe(hum, gen) -> None:
    """Each of VJP_FAULTS seeded into a copy of ``csrc/`` under ``build/``,
    built beside the sound source for each K4 case's engine, plain and with
    params_grad, and every variant held to ``chip_smoke.py``'s K4 limits
    (``vjp_gates``): per case, the worst statistic over its limit (> 1 is
    refused)."""
    import torch

    from chip_smoke import apg_setup, garpez_engine, pendulum_engine, vjp_gates, vjp_starts
    from jaxsim_tpu_torch.ops import cuda_build, cuda_step_vjp

    device = hum.S.device
    garp = garpez_engine(device)
    starts, case_tau = vjp_starts(pendulum_engine(device), hum, garp, apg_setup(garp))

    sources = {"control": cuda_step_vjp.SOURCE}
    for name, (file, old, new) in VJP_FAULTS.items():
        sources[name] = _seeded_copy("vjp_faults", name, file, old, new) / "step_vjp.cu"
    engines = list({id(e): e for e, _ in starts.values()}.values())
    jobs = {(name, id(eng), pg): dataclasses.replace(cuda_step_vjp.job(eng, pg), source=src)
            for name, src in sources.items() for eng in engines for pg in (False, True)}  # fmt: skip
    kernels = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))

    def variant(name):
        def run(engine, state, tau, ct, params_grad=False):
            out, ct_tau, partials = cuda_step_vjp.launch(
                kernels[(name, id(engine), params_grad)], engine, state, tau, ct, None, params_grad)
            if not params_grad:
                return out, ct_tau
            return out, ct_tau, cuda_step_vjp.unpack_params(engine, partials.sum(0))
        return run

    _, ratios = vjp_gates(starts, case_tau, torch.Generator(device).manual_seed(3),
                          {name: variant(name) for name in sources})  # fmt: skip
    print(json.dumps({"vjp_faults": ratios}), flush=True)


def param_sum_probe(hum, gen) -> None:
    """K4's partials' sum built with each warp count a block in
    ``SUM_WARPS`` (copies of ``csrc/`` under ``build/``, the constant
    edited), on the partials of 8192 envs (a row a block of the humanoid's
    1,989 entries): kernel-only µs (``torch.profiler``, mean of
    ``LAUNCH_REPEATS``) and CUDA-event µs of the wrapper's path (median),
    beside ``torch.sum``'s; each variant equal over two runs and within
    1e-6 relative of ``torch.sum``."""
    import torch

    from jaxsim_tpu_torch.ops import cuda_build, cuda_step_vjp

    old = f"constexpr int SUM_WARPS = {SUM_WARPS[0]};"
    jobs = {}
    for n in SUM_WARPS:
        copy = _seeded_copy("param_sum", str(n), "step_vjp.cu", old, f"constexpr int SUM_WARPS = {n};")
        jobs[n] = dataclasses.replace(cuda_step_vjp.job(hum, params_grad=True), source=copy / "step_vjp.cu")
    kernels = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))
    partials = torch.randn(-(-PROFILE_BATCH // cuda_step_vjp.envs_per_block(hum, True)),
                           cuda_build.packed_params(hum).numel(), generator=gen, device=gen.device)  # fmt: skip
    ref = torch.sum(partials, 0)

    def variant(kernel):
        def run():
            out = torch.empty(partials.shape[1], device=partials.device)
            cuda_build.launch(kernel, "jx_param_sum", None, partials.device, partials.data_ptr(),
                              partials.shape[0], out.data_ptr())  # fmt: skip
            return out
        return run

    calls = {f"param_sum_{n}": (variant(k), "param_sum_kernel") for n, k in kernels.items()}
    calls["torch_sum"] = (lambda: torch.sum(partials, 0), "")
    for name, (fn, kernel) in calls.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise RuntimeError(f"{name}: two runs differ")
        torch.testing.assert_close(a, ref, rtol=1e-6, atol=1e-6 * float(ref.abs().max()))
        print(json.dumps({"param_sum": {"call": name, "kernel_us": _profiled_us(fn, kernel),
                                        "event_us": 1e3 * device_ms(fn, LAUNCH_REPEATS)}}), flush=True)  # fmt: skip


def profiler_probe(hum, gen) -> None:
    """How many launches ``torch.profiler`` records of short kernels: per
    call, ``PROFILER_WINDOWS`` windows of ``LAUNCH_REPEATS`` calls at each
    idle pad in ``PROFILER_PADS_S`` (``chip_smoke.profiled_window``), the
    count seen in each and the start µs of the first kernel seen."""
    import torch

    from chip_smoke import profiled_window
    from jaxsim_tpu_torch.ops import cuda_build, cuda_step, cuda_step_vjp

    state = hum.init_state(LAUNCH_BATCHES[0], base_position=(0.0, 0.0, 0.9), generator=gen)
    partials = torch.randn(-(-PROFILE_BATCH // cuda_step_vjp.envs_per_block(hum, True)),
                           cuda_build.packed_params(hum).numel(), generator=gen, device=gen.device)  # fmt: skip
    calls = {
        "k2": (lambda: cuda_step.step_pd(hum, state), "step_pd_kernel"),
        "param_sum": (lambda: cuda_step_vjp.sum_partials(hum, partials), "param_sum_kernel"),
        "torch_sum": (lambda: torch.sum(partials, 0), ""),
    }
    for fn, _ in calls.values():
        fn()  # warm-up (and build)
    for pad in PROFILER_PADS_S:
        for name, (fn, kernel) in calls.items():
            windows = [profiled_window(fn, kernel, LAUNCH_REPEATS, pad) for _ in range(PROFILER_WINDOWS)]
            print(json.dumps({"profiler": {
                "call": name, "pad_s": pad, "launches": LAUNCH_REPEATS, "seen": [len(w) for w in windows],
                "first_start_us": [min((t0 for t0, _ in w), default=None) for w in windows],
            }}), flush=True)  # fmt: skip


PROBES = {
    "sweep": sweep_probe,
    "profile": profile_probe,
    "k1": k1_probe,
    "launch": launch_probe,
    "terminations": terminations_probe,
    "rr": rr_probe,
    "rr_faults": rr_faults_probe,
    "param_sum": param_sum_probe,
    "profiler": profiler_probe,
    "vjp": vjp_probe,
    "vjp_faults": vjp_faults_probe,
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
