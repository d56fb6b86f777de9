#!/usr/bin/env python3
"""Measure the CUDA rollout kernel's batch scaling, the plain twin's launch
pattern and the spread that float32 rounding leaves, on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 chip_probe.py [sweep] [profile] [rounding] [k1] [launch] [terminations] [rr] [rr_faults] [param_sum]
        [profiler] [vjp] [vjp_faults] [lanes] [quat] [k1_faults] [step] [step_faults] [kernels] [rk4_faults]
        [rr_step] [rr_step_faults] [rr_vjp] [rr_vjp_faults] [rr_vjp_phases] [rr_envs] [rr_phases]
        [rr_variants] [rk4_variants]

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
  limits (``vjp_gates``): per case the worst statistic over its limit;
* lanes: the soft K1 and K5 at each count of lanes an env in
  ``LANE_COUNTS``, K1 on the flagship's shape (the humanoid, 8192 envs,
  ``HORIZON`` steps), K5 on the ES generation's (8 candidates × 1024 envs,
  the MLP of 16, 500 steps, ``chip_smoke.ES_OPTIONS``): each build's ptxas
  line, launch geometry and local loads and stores in its SASS by source
  window; kernel-only ms (``torch.profiler``, mean of ``LANE_REPEATS``) and
  CUDA-event ms of a launch (median); and each K1 build's worst field's max
  |Δ| against the plain twin after ``LANE_CHECK_STEPS`` steps; K1 also with
  the child -> parent pairs recomputed from s, not read from the slot
  (``RECOMPUTE_PAIR``);
* quat: the plain twin with its quaternion renormalisation dropped,
  against the sound float32 twin, beside the float32 twin's own distance
  to the float64 one, after ``QUAT_STEPS`` steps at ``QUAT_BATCH`` envs
  from the humanoid's joints-moving start, the humanoid spinning in the air
  (the main-path start lifted and turned as ``chip_smoke.BOX_SPIN``), and
  CASES' spinning box: per start and field, the max over envs of each
  per-env |Δ| (what chose the box for CASES);
* k1_faults: ``K1_FAULTS`` seeded into copies of ``csrc/`` under
  ``build/``, each held with the sound kernel to ``chip_smoke.py``'s CASES
  limits (``k1_gates``): per case the worst field's statistic over its limit.
* step: K2 and K3 (``step.cu``) at each count of lanes an env in
  ``STEP_LANES``, each envs a block from one warp's to the most that fit
  (``cuda_step.block_envs``), the model arrays in shared memory (the
  source) or read from device memory through L1 (``STEP_L1``, seeded into a
  copy of ``csrc/`` under ``build/``): K2 and K3 on the humanoid at 8192 envs (the main-path start
  and its PD torques) and K3 on garpez at 1024 (the APG start and policy),
  each build's ptxas line, launch geometry and local loads and stores in its
  SASS by source window; kernel-only ms (``torch.profiler``, mean of
  ``LAUNCH_REPEATS``) and CUDA-event ms of a launch (median); and the
  largest |Δ| against the plain version after ``LANE_CHECK_STEPS`` chained
  steps (the humanoid from the joints-moving start, garpez from the APG
  start under the APG policy);
* step_faults: ``STEP_FAULTS`` seeded into copies of ``csrc/`` under
  ``build/``, and K3 given the engine's own model arrays in place of
  ``pr``'s, each held with the sound kernel to ``chip_smoke.py``'s K2 and K3
  limits (``step_gates``): per case the worst field's statistic over its
  limit.
* kernels: each kernel of the main paths at its main path's shape (K1 at
  8192 envs and ``HORIZON`` steps, K5 on the ES generation, K4 plain and
  with the model arrays' cotangents, K1-rr at 8192 envs and
  ``chip_smoke.RR_HORIZON`` steps, K2 and K3 at 8192 envs, K3 on garpez at
  1024, K2-rr and K3-rr at 8192 envs, which checkouts before the
  relaxed-rigid K2 and K3 refuse; BASELINE config 5 and K1-rr RK4-fast at
  ``chip_smoke.RR_RK4_HORIZON`` steps, K5-rr on the relaxed-rigid ES
  generation, the relaxed-rigid ``BatchedEnv.step``'s wall ms a step, and
  the soft K1's RK4 and RK4-fast builds at 8192 envs and
  ``chip_smoke.SOFT_RK4_HORIZON`` steps):
  kernel-only ms (``torch.profiler``) and CUDA-event ms (median),
  through entry points that the checkouts since the lane-spread K1 and K5
  share, so that a copy of this script times an older checkout's kernels in
  the same call; and the SHA-256 of each library's SASS instructions.
* rk4_faults: ``RK4_FAULTS`` seeded into copies of ``csrc/`` under
  ``build/``, each built for the RK4 and RK4-fast engines beside the sound
  source and held with it to ``chip_smoke.py``'s RK4 limits: the soft K1
  builds by ``k1_gates`` (RK4_CASES), the relaxed-rigid ones by
  ``rr_gates`` (RR_RK4_CASES); per case the worst field's statistic over
  its limit (> 1 is refused). A fault whose source edit a build does not
  include gives that build's own numbers.
* rr_step: K3-rr (``step_rr.cu``) at each envs a block in ``RR_STEP_ENVS``
  (the most that fit up to it), on the relaxed-rigid humanoid at 8192 envs
  (the relaxed-rigid main path's start and its PD torques) and on garpez
  tilted low at 1024 (``chip_smoke.RR_GARPEZ``): each build's ptxas line
  (registers, stack, spills), launch geometry and local loads and stores in
  its SASS; kernel-only ms (``torch.profiler``, mean of ``LAUNCH_REPEATS``)
  and CUDA-event ms of a launch (median); and the worst field's largest
  |Δ| (m's relative) against the plain twin after ``LANE_CHECK_STEPS``
  chained steps.
* rr_step_faults: ``RR_STEP_FAULTS`` seeded into copies of ``csrc/`` under
  ``build/``, each built beside the sound source for every engine of the
  gates, and held with it to ``chip_smoke.py``'s limits: K2-rr (K1-rr's
  ``rollout_rr.cu`` for one step) and K3-rr (``step_rr.cu``), chained, by
  ``rr_gates`` on RR_CASES, K5-rr by ``rr_env_gates`` on
  RR_ENV_CASES; per case the worst statistic over its limit (> 1 is
  refused).
* rr_vjp: K4-rr (``step_vjp_rr.cu``) at each of ``RR_VJP_GEOMETRIES``
  (lanes an env, envs a block at most), plain and with params_grad, on the
  relaxed-rigid humanoid at 8192 envs and garpez tilted low at 1024;
  rr_vjp_faults: ``RR_VJP_FAULTS`` held with ``chip_smoke.rr_vjp_gates``;
  rr_vjp_phases: K4-rr's cycles by phase (``RR_VJP_PHASES``) and inside the
  PCG iterations, from clock stamps seeded into a copy of the source.
* rr_envs: the relaxed-rigid forward builds at each envs a block of
  ``RR_ENVS_SWEEP`` (the most that fit up to it) on the relaxed-rigid
  humanoid at 8192 envs from the relaxed-rigid main path's start: K1-rr
  under semi-implicit Euler (``chip_smoke.RR_HORIZON`` steps), RK4 (BASELINE
  config 5) and RK4-fast (``chip_smoke.RR_RK4_HORIZON`` steps), K3-rr (one
  step, the start's PD torques) and K5-rr (the relaxed-rigid ES generation,
  the MLP of 16): each build's ptxas line, launch geometry and local loads
  and stores; kernel-only ms (``torch.profiler``) and CUDA-event ms
  (median); and for K1-rr under semi-implicit Euler and RK4 the worst
  field's largest |Δ| (m's relative) against the plain twin after
  ``LANE_CHECK_STEPS`` steps.
* rr_variants: the same builds from copies of ``csrc/`` with each of
  ``RR_STEP_VARIANTS`` seeded (the free ABA inlined; a warp barrier in place
  of the block barrier after it), beside the checkout's, with each build's
  ptxas spill stores summed over its functions.
* rr_phases: K1-rr's cycles a step in the free ABA, the contact solve and
  the rest, under semi-implicit Euler, RK4 and RK4-fast, from clock stamps
  seeded into a copy of ``csrc/`` (warp 0's, each block's, averaged over
  blocks; ``_PH_COMMON`` and ``_PH_ABA``, one set for the one-thread free
  ABA and one for the lane-spread one, so that a copy of this script times
  a parent checkout too).
* rk4_variants: the soft K1's RK4 and RK4-fast builds on the soft RK4 main
  path's shape, as the checkout builds them (y0 and the stages' sum in the
  env's lanes' registers) and with each of ``RK4_VARIANTS`` seeded into a
  copy of ``csrc/`` (the two as a local array; in shared memory at 16 and
  24 envs a block); and with clock stamps (``_RK4_PH``), each step's cycles
  in its four rates and in the rest. A variant whose text the checkout's
  source lacks is left out and the stamps fit the parent's source, so a
  copy of this script in the parent's checkout times the parent's design.

It prints the card's name and power limit, then JSON lines keyed by probe,
and exits non-zero when no CUDA device is visible.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
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
LANE_COUNTS = (4, 8, 2, 1)  # the soft K1's and K5's lanes an env; the first is the wrappers'
LANE_REPEATS = 3
LANE_CHECK_STEPS = 10
QUAT_STEPS = 100
QUAT_BATCH = 1024
STEP_LANES = (8, 4, 2)  # K2's and K3's lanes an env; the first is the wrappers'
RR_STEP_ENVS = (64, 32, 16)  # K3-rr's envs a block tried; the first is the wrappers'
# The relaxed-rigid forward builds' envs a block tried by rr_envs (the most
# that fit up to each); the first is the builds' own.
RR_ENVS_SWEEP = (64, 32, 16)
# Two choices of rr_step.cuh's forward step, undone in copies of csrc/ for
# the rr_variants probe (each an edit of rr_step.cuh: the text, its
# replacement): the free ABA inlined into the step, not a call of its own;
# and the block barrier after the ABA a warp barrier.
RR_STEP_VARIANTS = {
    "ABA inlined": [("rr_step.cuh", "__device__ __noinline__ void rr_free_lanes(",
                     "__device__ __forceinline__ void rr_free_lanes(")],
    "warp barrier after the ABA": [("rr_step.cuh", "  __syncthreads();\n}\n\n// rr_free_body in a call of its own",
                                    "  __syncwarp();\n}\n\n// rr_free_body in a call of its own")],
}
# Seeded faults of the relaxed-rigid step, each one edit of rr_step.cuh
# (the text, its replacement): the impedance floor dropped from the
# regularizer, the warm start forced cold, one PCG iteration fewer, and in
# the free ABA on the lanes each link's first pulled child (its highest
# index) left out of pass 2's sums.
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
        "for (int it = warm ? -1 : 0; it <= JX_RR_ITERS; ++it) {\n    const bool first = it < 0, last = it == JX_RR_ITERS;",
        "for (int it = warm ? -1 : 0; it <= JX_RR_ITERS - 1; ++it) {\n    const bool first = it < 0, last = it == JX_RR_ITERS - 1;",
    ),
    "a child's pulled pass-2 share dropped": (
        "        for (int h = 0; h < pulls; ++h) {", "        for (int h = 1; h < pulls; ++h) {"
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


# Seeded faults of K4-rr, each a list of edits of step_vjp_rr.cu (the file,
# the text, its replacement): the backward PCG warm-started from the
# forward's solution in place of zero; the operator's term <-lambda, A(theta)
# x> dropped (its gather and its regularizer's share); rrMinv's cotangent
# dropped; lambda's sign flipped.
RR_VJP_FAULTS = {
    "backward PCG warm-started": [(
        "step_vjp_rr.cu",
        "  for (int k = 0; k < OWN * 3; ++k) xs[k] = 0.0f;\n  rr_cg(P, sc, sl, g, pt, act, rj, r, xs, false, false);",
        "  for (int k = 0; k < OWN * 3; ++k) xs[k] = pt[k / 3] >= 0 ? sl[T_X + pt[k / 3] * 3 + k % 3] : 0.0f;\n"
        "  rr_cg(P, sc, sl, g, pt, act, rj, r, xs, true, false);",
    )],
    "operator term dropped": [
        ("step_vjp_rr.cu", "        gather_vjp(Rp, Lp, ac, bo, w + 6, gR, gL);\n", ""),
        ("step_vjp_rr.cu", "        br[j] = -lam[k * 3 + j] * xc[j];", "        br[j] = 0.0f;"),
    ],
    "rrMinv's cotangent dropped": [("step_vjp_rr.cu", "      acc.add(OFF_RRMINV + ci * 9, 9, gM);\n", "")],
    "lambda's sign flipped": [
        ("step_vjp_rr.cu", "  points_vjp(P, sc, sl, g, pt, xs, acc);",
         "  for (int k = 0; k < OWN * 3; ++k) xs[k] = -xs[k];\n  points_vjp(P, sc, sl, g, pt, xs, acc);")],
}
# K4-rr's phases for the rr_vjp_phases probe: each line of step_vjp_rr.cu's
# kernel after which warp 0 stamps its clock (a seeded copy of the source;
# the kernel itself has no instrumentation).
RR_VJP_PHASE_LANES = (8, 16)
RR_VJP_PHASES = (
    ("free ABA", "  free_aba_lanes(P, sc, sl, g, x, tau);\n"),
    ("forward PCG", "  rr_cg(P, sc, sl, g, pt, act, rj, r, xs, true, false);\n"),
    ("substitution", "  subst_lanes(P, sl, g, pt, act, xs);\n"),
    ("SIE transposed, x-bar", "  x_bar_lanes(P, sc, sl, g, pt, c, out.m + b, B, valid, r);\n"),
    ("backward PCG", "  rr_cg(P, sc, sl, g, pt, act, rj, r, xs, false, false);\n"),
    ("points' seeds", "  points_vjp(P, sc, sl, g, pt, xs, acc);\n"),
    ("pass 3 transposed", "  pass3_vjp(P, sc, sl, g, x, c, tau, acc);\n"),
    ("base transposed", "  if (g == 0) base_vjp(sc, sl);\n"),
    ("pass 2 transposed", "  pass2_vjp(P, sl, g, x, tau, ct_tau + b, B, valid, acc);\n"),
    ("scatter transposed", "  scatter_vjp(P, sl, g, pt, acc);\n"),
    ("pass 1 transposed", "  pass1_vjp(P, sc, sl, g, x, c, o, B, valid, acc);\n"),
)


# K4-rr's geometries for the rr_vjp probe: lanes an env, and envs a block at
# most (whole warps; cuda_build.vjp_rr_tables halves them until the block
# fits).
RR_VJP_GEOMETRIES = ((4, 8), (4, 16), (8, 8), (8, 12), (8, 16))


# Seeded faults of the soft K1's lane step, each one edit of
# soft_step_lanes.cuh (the text, its replacement): m's update dropped, a
# contact parent's point wrenches carried into the next parent's sum, the
# quaternion not renormalised, and the ṡ of the links on the group's last
# lane not written (s still moves with it).
K1_FAULTS = {
    "m's update dropped": ("x.m[c * 3 + j] = mc[j] + sc.dt * h.md[j];", "x.m[c * 3 + j] = mc[j];"),
    "a parent's wrench summed into the next parent's": (
        "        // The next parent's points start a sum of their own.\n#pragma unroll\n"
        "        for (int j = 0; j < 6; ++j) acc[j] = 0.0f;\n",
        "",
    ),
    "quaternion not renormalised": ("x.q[k] = qn[k] / nq;", "x.q[k] = qn[k];"),
    "one lane's ṡ not written": ("        x.sd[i - 1] = sdn;\n", "        if (g != G - 1) x.sd[i - 1] = sdn;\n"),
}


# Seeded faults of the one-step kernels, each one edit of step.cu (the
# text, its replacement): K3's torques read from the next env's column, the
# store's entries of each warp's last lane dropped, and the envs past the
# batch storing (at their own columns, which lie past the row's end).
STEP_FAULTS = {
    "tau from the next env's column": ("return j = SL_TAU + r, x.tau + r * B;", "return j = SL_TAU + r, x.tau + r * B + 1;"),
    "one lane's share of the store dropped": ("    if (b0 + e < B) {\n      int j;\n      float* row",
                                              "    if (b0 + e < B && threadIdx.x % 32 != 31) {\n      int j;\n      float* row"),
    "envs past the batch store": ("    if (b0 + e < B) {\n      int j;\n      float* row", "    {\n      int j;\n      float* row"),
}

# Seeded faults of K1's RK4 and RK4-fast builds, each a list of edits of
# csrc/ (the file, the text, its replacement): the stage weights (1, 2, 2, 2)
# / 6 in place of (1, 2, 2, 1) / 6; the torques re-read from each stage's
# state, not captured once at the step's start; the Baumgarte term dropped
# from the quaternion's rate; the soft build's y0, held in its lanes'
# registers, captured at the launch's first step only; and (K1-rr under RK4)
# each stage's PCG warm-started from the step's start m, not the stage's.
RK4_FAULTS = {
    "stage weights (1, 2, 2, 2)/6": [("step_env.cuh", "acc + (stage == 3 ? k : 2.0f * k)", "acc + 2.0f * k")],
    "torques re-read from the stage state": [
        ("rollout.cu", "const ColTau tau{{st + ST_TAU * ES, ES}};", "const SlotPd tau{x.s, x.sd, sc.kp, sc.kd};"),
        ("rr_step.cuh", "  const SlotTauRr tau{sl};\n", "  const RrPdTau tau{sc.kp, sc.kd};\n"),
    ],
    "Baumgarte term dropped": [("step_env.cuh", "const float r = 0.5f * (nw * (1.0f - nq));", "const float r = 0.0f;")],
    "y0 captured once a launch": [(
        "rollout.cu", "      if (g + G * j < ST_N) y0[j] = mine[j * G * ES];",
        "      if (t == 0 && g + G * j < ST_N) y0[j] = mine[j * G * ES];")],
    "stage PCG warm-started from the start's m": [(
        "rr_step.cuh", "      rr_solve(P, sc, sl, g, pt, m, x);\n      if (Integrator == 2)",
        "      float wm[OWN * 3];\n#pragma unroll\n      for (int k = 0; k < OWN * 3; ++k)\n"
        "        wm[k] = Integrator == 1 && pt[k / 3] >= 0 ? y0m[(pt[k / 3] * 3 + k % 3) * rs] : m[k];\n"
        "      rr_solve(P, sc, sl, g, pt, wm, x);\n      if (Integrator == 2)",
    )],
}

# y0 and the stages' sum in shared memory, a lane's j-th entry at
# [j * LN_THREADS], with ENVS envs a block (32 leave them no room).
_RK4_SMEM = [
    ("rollout.cu",
     "constexpr size_t K1_SMEM_BYTES = (static_cast<size_t>(N_PARAMS) + static_cast<size_t>(SLOT) * ES) * sizeof(float);\n",
     "constexpr size_t K1_SMEM_BYTES =\n"
     "    (static_cast<size_t>(N_PARAMS) + static_cast<size_t>(SLOT) * ES + 2 * RK_N * LN_THREADS) * sizeof(float);\n\n"
     "struct RkRow {\n  float* p;\n"
     "  __device__ __forceinline__ float& operator[](int j) const { return p[j * LN_THREADS]; }\n};\n"),
    ("rollout.cu", "  float y0[RK_N], acc[RK_N];  // the lane's entries of y0 and of the sum\n",
     "  extern __shared__ float smem[];\n"
     "  const RkRow y0{smem + N_PARAMS + SLOT * ES + threadIdx.x}, acc{y0.p + RK_N * LN_THREADS};\n"),
]


def _rk4_smem(envs: int) -> list:
    """_RK4_SMEM at ``envs`` envs a block."""
    return [("soft_step_lanes.cuh", "constexpr int ENVS = JX_LN_ENVS;", f"constexpr int ENVS = {envs};"), *_RK4_SMEM]


# Lane g's entries g RK_N .. (g + 1) RK_N - 1, a block of rows, with RK_N
# an odd multiple of 32 / G, so that the lanes of a warp's envs reach
# distinct banks (entry e of the block's env b at [e * ES + b], ES odd).
_RK4_BLOCKED = [
    ("rollout.cu", "constexpr int RK_N = (ST_N + G - 1) / G;\n",
     "constexpr int RK_N = G == 1 ? ST_N : ((ST_N + G - 1) / G + 32 / G - 1) / (32 / G) / 2 * 2 * (32 / G) + 32 / G;\n"),
    ("rollout.cu", "  float* const mine = st + g * ES;", "  float* const mine = st + g * RK_N * ES;"),
    ("rollout.cu", "      if (g + G * j < ST_N) y0[j] = mine[j * G * ES];", "      if (g * RK_N + j < ST_N) y0[j] = mine[j * ES];"),
    ("rollout.cu", "          const int e = g + G * j;", "          const int e = g * RK_N + j;"),
    ("rollout.cu", "rk4_entry(S, dt, mine[j * G * ES], y0[j], acc[j]);", "rk4_entry(S, dt, mine[j * ES], y0[j], acc[j]);"),
    ("rollout.cu", "S == 3) mine[j * G * ES] = y;", "S == 3) mine[j * ES] = y;"),
]
# Designs of the soft K1's RK4 stage update beside the checkout's (y0 and
# the stages' sum in the registers of the env's lanes, lane g the entries
# g, g + G, ...), each a list of edits of csrc/, for the rk4_variants probe:
# the two as a local array of the lane (the update's loops not unrolled, so
# that they index it at run time: local memory, through L1 and L2); in
# registers with one update loop for every stage, whose weights and
# division by 6 are chosen per entry at run time; in registers, a lane's
# entries a block of rows; in shared memory at 16 and 24 envs a block.
RK4_VARIANTS = {
    "local array": [
        ("rollout.cu", "#pragma unroll\n    for (int j = 0; j < RK_N; ++j)\n      if (g + G * j < ST_N)",
         "#pragma unroll 1\n    for (int j = 0; j < RK_N; ++j)\n      if (g + G * j < ST_N)"),
        ("rollout.cu", "#pragma unroll\n        for (int j = 0; j < RK_N; ++j) {",
         "#pragma unroll 1\n        for (int j = 0; j < RK_N; ++j) {"),
    ],
    "registers, one update for every stage": [
        ("rollout.cu", "constexpr int S = decltype(s)::value;", "const int S = stage;"),
        ("rollout.cu", "      if (stage == 0) {\n        update(std::integral_constant<int, 0>{});\n      } else if (stage == 1) {\n"
         "        update(std::integral_constant<int, 1>{});\n      } else if (stage == 2) {\n"
         "        update(std::integral_constant<int, 2>{});\n      } else {\n"
         "        update(std::integral_constant<int, 3>{});\n      }\n",
         "      update(0);\n"),
    ],
    "registers, a lane's entries in a block of rows": _RK4_BLOCKED,
    "shared memory, 16 envs a block": _rk4_smem(16),
    "shared memory, 24 envs a block": _rk4_smem(24),
}

# The same in registers, each lane holding the entries it writes as rates
# (its links' s and ṡ, its point slots' m, on lane 0 the base's q, v and p),
# which no other lane reads, so that no barrier surrounds the update and the
# lane that holds a joint writes its torque: a copy of rk4_steps over a
# table of each lane's entries (``_rk4_owned_header``, a file of the seeded
# copy), which the block keeps in shared memory.
_RK4_OWNED_FN = """// n_steps RK4 steps, each lane holding the entries it writes as rates.
#include "rk4_owned.h"  // JX_RK_OWNED_N; lane g's j-th entry at JX_RK_OWNED[j * G + g], -1 for none
__device__ __forceinline__ void rk4_steps_owned(const float* P, const Scalars& sc, Slot sl, int g,
                                                const EnvState<float>& x, int n_steps) {
  constexpr int RN = JX_RK_OWNED_N;
  __shared__ int owned[RN * G];
  for (int k = threadIdx.x; k < RN * G; k += blockDim.x) owned[k] = JX_RK_OWNED[k];
  __syncthreads();
  float* st = sl.base + SL_ST * ES;
  const ColTau tau{{st + ST_TAU * ES, ES}};
  const float dt = sc.dt;
  float y0[RN], acc[RN];
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    if (g == 0) quat_normalize(x.q);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int e = owned[j * G + g];
      if (e >= 0) {
        y0[j] = st[e * ES];
        if (e < ST_SD) st[(ST_TAU + e) * ES] = -sc.kp * x.s[e] - sc.kd * x.sd[e];
      }
    }
#pragma unroll 1
    for (int stage = 0; stage < 4; ++stage) {
      if (INTEGRATOR == 2 && stage > 0) {
        soft_step_lanes<STEP_RATE_FROZEN>(P, sc, sl, g, x, tau, nullptr);
      } else {
        soft_step_lanes<STEP_RATE>(P, sc, sl, g, x, tau, nullptr);
      }
      const auto update = [&](auto s) {
        constexpr int S = decltype(s)::value;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int e = owned[j * G + g];
          if (e >= 0) {
            const float y = rk4_entry(S, dt, st[e * ES], y0[j], acc[j]);
            if (INTEGRATOR != 2 || e < ST_M || S == 3) st[e * ES] = y;
          }
        }
      };
      if (stage == 0) {
        update(std::integral_constant<int, 0>{});
      } else if (stage == 1) {
        update(std::integral_constant<int, 1>{});
      } else if (stage == 2) {
        update(std::integral_constant<int, 2>{});
      } else {
        update(std::integral_constant<int, 3>{});
      }
    }
    if (g == 0) quat_normalize(x.q);
  }
  ln_sync();
}

"""
_RK4_OWNED = [
    ("rollout.cu", "// n_steps RK4 (INTEGRATOR 1) or RK4-fast (2) steps of the env on lanes g of\n",
     _RK4_OWNED_FN + "// n_steps RK4 (INTEGRATOR 1) or RK4-fast (2) steps of the env on lanes g of\n"),
    ("rollout.cu", "    rk4_steps(P, sc, sl, g, x, n_steps);\n", "    rk4_steps_owned(P, sc, sl, g, x, n_steps);\n"),
]


def _rk4_owned_header(engine, lanes: int) -> str:
    """``rk4_owned.h`` of the owned-entries variant for ``engine`` at
    ``lanes`` lanes an env: each lane's entries of the state rows (those it
    writes as rates, by soft_step_lanes.cuh's deal of links and point
    slots), padded with -1 to the most a lane holds."""
    from jaxsim_tpu_torch.ops import cuda_build

    t = cuda_build._lane_schedule(engine, lanes)
    nj, st_m = engine.n_joints, 2 * engine.n_joints + 13
    entries = [[] for _ in range(lanes)]
    for lev in range(t["n_lev"]):
        for n in range(t["lev_off"][lev], t["lev_off"][lev + 1]):
            i = t["lev_link"][n]
            entries[(n - t["lev_off"][lev]) % lanes] += [i - 1, nj + i - 1]
    for k, c in enumerate(t["slot_point"]):
        if c >= 0:
            entries[k % lanes] += [st_m + 3 * c + j for j in range(3)]
    entries[0] += list(range(2 * nj, st_m))  # q, v, p
    n = max(map(len, entries))
    table = [entries[g][j] if j < len(entries[g]) else -1 for j in range(n) for g in range(lanes)]
    return f"#define JX_RK_OWNED_N {n}\n__device__ const int JX_RK_OWNED[{n * lanes}] = {{{', '.join(map(str, table))}}};\n"


# Clock stamps for the rk4_variants probe (edits of rollout.cu that fit its
# parent's text too): warp 0's first thread sums the cycles of the rates
# (each with the barrier after it) and takes those of the whole step loop,
# and writes both over its block's first env's p rows at the end.
_RK4_RATE = (
    "      if (INTEGRATOR == 2 && stage > 0) {\n"
    "        soft_step_lanes<STEP_RATE_FROZEN>(P, sc, sl, g, x, tau, nullptr);\n"
    "      } else {\n        soft_step_lanes<STEP_RATE>(P, sc, sl, g, x, tau, nullptr);\n      }\n      ln_sync();\n"
)
_RK4_PH = [
    ("rollout.cu", 'static_assert(FORWARD, "rollout.cu takes the forward-only slot (JX_LN_FORWARD 1)");\n',
     'static_assert(FORWARD, "rollout.cu takes the forward-only slot (JX_LN_FORWARD 1)");\n\n'
     "__device__ __forceinline__ long long& jx_ph() {\n  __shared__ long long acc;\n  return acc;\n}\n"),
    ("rollout.cu", _RK4_RATE,
     "      const long long jx0 = clock64();\n" + _RK4_RATE
     + "      if (threadIdx.x == 0) jx_ph() += clock64() - jx0;\n"),
    ("rollout.cu", "  if constexpr (INTEGRATOR == 0) {\n",
     "  if (threadIdx.x == 0) jx_ph() = 0;\n  const long long jxk = clock64();\n  if constexpr (INTEGRATOR == 0) {\n"),
    ("rollout.cu", "  if (valid) store_state(x, B, b, out, g);\n}\n",
     "  if (valid) store_state(x, B, b, out, g);\n  const long long jxt = clock64() - jxk;\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n    out.p[blockIdx.x * ENVS] = static_cast<float>(jxt);\n"
     "    out.p[B + blockIdx.x * ENVS] = static_cast<float>(jx_ph());\n  }\n}\n"),
]

# Seeded faults of the relaxed-rigid one-step kernels and env rollout, each a
# list of edits of csrc/ (the file, the text, its replacement): K3-rr reading
# the next env's torques; K2-rr (K1-rr launched for one step) not storing m;
# K5-rr not re-reading m on a respawn; K5-rr's reward taken at the height
# the episode respawns at, on its last step.
RR_STEP_FAULTS = {
    "K3 reads env b + 1's torques": [
        ("step_rr.cu", "__ldg(tau_in + (i - 1) * B + bl);", "__ldg(tau_in + (i - 1) * B + bl + 1);")],
    "K2's m not stored": [
        ("rollout_rr.cu", "    rr_store_m(out.m, B, b, pt, m);\n", "")],
    "K5 does not restore m on a respawn": [
        ("env_rollout_rr.cu", "      rr_load_m(in.m, B, bl, pt, m);\n", "")],
    "K5's reward from the state after the respawn": [
        ("env_rollout_rr.cu", "      const float upright = z > 2.0f ? 2.0f : z;",
         "      const float zr = done ? in.p[2 * B + bl] : z;\n      const float upright = zr > 2.0f ? 2.0f : zr;")],
}

# The one-step kernels' model arrays read from device memory through L1 in
# place of the block's copy in shared memory (edits of step.cu), for the
# step probe.
STEP_L1 = (
    ("constexpr int SMEM_PARAMS = N_PARAMS;", "constexpr int SMEM_PARAMS = 0;"),
    ("  const float* P = smem;\n  load_params(params, smem);\n", "  const float* P = params;\n"),
)


# The lane step's child -> parent pairs recomputed from s where pass 2 and
# pass 3 read them (the edit of soft_step_lanes.cuh's link_pair), for the
# lanes probe: the slot keeps them, 12 floats a link.
RECOMPUTE_PAIR = (
    "  (void)P;\n  (void)si;\n  sl.ld(i * LK + LK_IR, 9, iR);\n  sl.ld(i * LK + LK_IP, 3, ip);\n",
    "  float rR[9], rp[3], t[3];\n  relative_transform(P, i, si, rR, rp);\n  (void)sl;\n"
    "  for (int r = 0; r < 3; ++r)\n    for (int cc = 0; cc < 3; ++cc) iR[r * 3 + cc] = rR[cc * 3 + r];\n"
    "  mv3(iR, rp, t);\n  for (int k = 0; k < 3; ++k) ip[k] = -t[k];\n",
)


def _seeded_copy(kind: str, name: str, file: str, old: str, new: str, more=()):
    """A copy of ``csrc/`` under ``build/<kind>/<name>`` with ``old``
    replaced by ``new`` in ``file`` (which must hold it once), and so each
    further ``(old, new)`` of ``more``."""
    return _seeded_edits(kind, name, [(file, o, n) for o, n in ((old, new), *more)])


def _seeded_edits(kind: str, name: str, edits) -> pathlib.Path:
    """A copy of ``csrc/`` under ``build/<kind>/<name>`` with each ``(file,
    old, new)`` of ``edits`` made (each ``old`` once in its file)."""
    import shutil

    from jaxsim_tpu_torch.ops import cuda_build

    copy = cuda_build.BUILD_DIR.parent / kind / name
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, copy)
    for file, old, new in edits:
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


def _profiled_us(fn, kernel: str) -> float | None:
    """Mean device microseconds of the CUDA kernels named ``kernel`` over
    ``LAUNCH_REPEATS`` calls of ``fn``, read by ``torch.profiler``; None
    (not measured) where every window the profiler gave missed a launch."""
    from chip_smoke import profiled_ms

    try:
        return profiled_ms(fn, kernel, LAUNCH_REPEATS) * 1e3
    except RuntimeError as err:
        print(f"{kernel}: {err}; kernel time not measured", flush=True)
        return None


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
                "kernel_ms": None if (us := _profiled_us(fn, kernel)) is None else us * 1e-3, "host_ms": _host_ms(fn),
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


def rr_vjp_probe(hum, gen) -> None:
    """K4-rr at each of RR_VJP_GEOMETRIES, plain and with params_grad, on the
    relaxed-rigid humanoid at 8192 envs (the relaxed-rigid main path's start,
    its PD torques) and on garpez tilted low at its 1,024 (0.1·N(0, 1)
    torques), one seeded output cotangent each: ptxas, geometry, SASS local
    accesses by source, kernel-only and event ms, and the largest cotangent
    |Δ| over max(1, max |plain|) (the model arrays' share of their limit
    with params_grad)."""
    import torch

    from chip_smoke import (
        BATCH, garpez_tilted, params_shares, profiled_ms, rr_garpez_engine, rr_humanoid_engine, vjp_cotangents, vjp_diff,
    )  # fmt: skip
    from jaxsim_tpu_torch.ops import cuda_build, cuda_step_vjp

    device = hum.S.device
    hum_rr, garp_rr = rr_humanoid_engine(device), rr_garpez_engine(device)
    hstate = hum_rr.init_state(BATCH, generator=torch.Generator(device).manual_seed(6))
    gstate = garpez_tilted(garp_rr, torch.Generator(device).manual_seed(6))
    cases = {
        "humanoid23": (hum_rr, hstate, (-60.0 * hstate.s - 0.5 * hstate.sd).contiguous()),
        "garpez": (garp_rr, gstate, (0.1 * torch.randn(gstate.s.shape, generator=gen, device=device)).contiguous()),
    }
    keys = [(model, lanes, envs, pg) for model in cases for lanes, envs in RR_VJP_GEOMETRIES for pg in (False, True)]
    jobs = [cuda_step_vjp.job(cases[m][0], pg, lanes=lanes, envs=envs) for m, lanes, envs, pg in keys]
    builds = dict(zip(keys, cuda_build.build_many(jobs)))
    for model, (engine, state, tau) in cases.items():
        ct = vjp_cotangents(state, gen)["all six"]
        plain = cuda_step_vjp.step_vjp_reference(engine, state, tau, ct, params_grad=True)
        for (m, lanes, envs, pg), kernel in builds.items():
            if m != model:
                continue

            def run():
                return cuda_step_vjp.launch_rr(kernel, engine, state, tau, ct, None, pg, lanes, envs)

            got = run()
            torch.cuda.synchronize()
            scaled, _ = vjp_diff(got, plain[:2])
            err = {"cotangents": max(float(d.max()) for d in scaled.values())}
            if pg:
                sums = cuda_step_vjp.unpack_params(engine, got[2].sum(0))
                err["params_share"] = max(params_shares(sums, plain[2]).values())
            print(json.dumps({"rr_vjp": {
                "model": model, "B": state.p.shape[-1], "lanes": lanes, "envs_at_most": envs, "params_grad": pg,
                "ptxas": [ln.strip() for ln in kernel.ptxas_log.splitlines() if "registers" in ln or "stack frame" in ln],
                "geometry": cuda_step_vjp.geometry(kernel), "local_loads_and_stores": cuda_step_vjp.rr_local_memory(kernel),
                "kernel_ms": profiled_ms(run, "step_vjp_rr_kernel", LAUNCH_REPEATS),
                "event_ms": device_ms(run, LAUNCH_REPEATS), "vs_plain": err,
            }}), flush=True)  # fmt: skip


def rr_vjp_phases_probe(hum, gen) -> None:
    """K4-rr's time by phase on the relaxed-rigid humanoid at 8192 envs (the
    rr_vjp probe's start): a copy of ``step_vjp_rr.cu`` under ``build/`` in
    which every thread stamps ``clock64()`` after a warp barrier at each of
    RR_VJP_PHASES, and each block's first thread writes its warp's cycles a
    phase into the torques' cotangent rows of the block's first env; per
    phase the mean cycles over blocks and their share, beside the kernel's
    event ms, plain and with params_grad."""
    import torch

    from chip_smoke import BATCH, rr_humanoid_engine, vjp_cotangents
    from jaxsim_tpu_torch.ops import cuda_build, cuda_step_vjp

    device = hum.S.device
    hum_rr = rr_humanoid_engine(device)
    state = hum_rr.init_state(BATCH, generator=torch.Generator(device).manual_seed(6))
    tau = (-60.0 * state.s - 0.5 * state.sd).contiguous()
    ct = vjp_cotangents(state, gen)["all six"]
    n = len(RR_VJP_PHASES)
    if n + 3 > hum_rr.n_joints:
        raise RuntimeError("more phases than rows of the torques' cotangent")
    edits = [("step_vjp_rr.cu", "  // 1. The forward:", "  long long jx_clk[%d];\n  jx_clk[0] = clock64();\n  // 1. The forward:" % (n + 1))]
    for k, (_, line) in enumerate(RR_VJP_PHASES, 1):
        edits.append(("step_vjp_rr.cu", line, line + f"  __syncwarp();\n  jx_clk[{k}] = clock64();\n"))
    tail = "      partials[static_cast<size_t>(blockIdx.x) * N_PARAMS + k] = s;\n    }\n  }\n"
    edits.append(("step_vjp_rr.cu", tail, tail + "  if (threadIdx.x == 0)\n    for (int k = 0; k < %d; ++k)"
                  " ct_tau[k * B + b] = static_cast<float>(jx_clk[k + 1] - jx_clk[k]);\n" % n))  # fmt: skip
    # Inside each PCG iteration (rr_cg, both solves): the scatter, the
    # substitution passes and the rest, summed by the block's first thread
    # in shared memory and written after the phases.
    edits += [
        ("rr_step.cuh", "__device__ __forceinline__ void rr_cg(",
         "__device__ __forceinline__ long long& jx_pcg(int k) {\n  __shared__ long long acc[3];\n  return acc[k];\n}\n"
         "__device__ __forceinline__ void rr_cg("),
        ("rr_step.cuh", "    rr_scatter(P, sl, g, pt, act, pp, !last);\n    rr_minv(P, sl, g, last);\n    if (last) break;\n",
         "    const long long jx0 = clock64();\n    rr_scatter(P, sl, g, pt, act, pp, !last);\n"
         "    const long long jx1 = clock64();\n    rr_minv(P, sl, g, last);\n    const long long jx2 = clock64();\n"
         "    if (threadIdx.x == 0) {\n      jx_pcg(0) += jx1 - jx0;\n      jx_pcg(1) += jx2 - jx1;\n    }\n"
         "    if (last) break;\n"),
        ("rr_step.cuh", "    rz = rz_n;\n  }\n}\n",
         "    rz = rz_n;\n    if (threadIdx.x == 0) jx_pcg(2) += clock64() - jx2;\n  }\n}\n"),
        ("rr_step.cuh", "      rz = lanes_sum(dot);\n      continue;\n",
         "      rz = lanes_sum(dot);\n      if (threadIdx.x == 0) jx_pcg(2) += clock64() - jx2;\n      continue;\n"),
        ("step_vjp_rr.cu", "  long long jx_clk[%d];\n" % (n + 1),
         "  long long jx_clk[%d];\n  if (threadIdx.x == 0) jx_pcg(0) = jx_pcg(1) = jx_pcg(2) = 0;\n" % (n + 1)),
        ("step_vjp_rr.cu", " ct_tau[k * B + b] = static_cast<float>(jx_clk[k + 1] - jx_clk[k]);\n",
         " ct_tau[k * B + b] = static_cast<float>(jx_clk[k + 1] - jx_clk[k]);\n"
         "  if (threadIdx.x == 0)\n    for (int k = 0; k < 3; ++k) ct_tau[(%d + k) * B + b] = static_cast<float>(jx_pcg(k));\n" % n),
    ]
    src = _seeded_edits("rr_vjp_phases", "stamps", _merged(edits)) / "step_vjp_rr.cu"
    jobs = {(pg, lanes): dataclasses.replace(cuda_step_vjp.job(hum_rr, pg, lanes=lanes), source=src)
            for pg in (False, True) for lanes in RR_VJP_PHASE_LANES}  # fmt: skip
    kernels = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))
    for (pg, lanes), kernel in kernels.items():
        envs = cuda_step_vjp.rr_envs_per_block(hum_rr, pg, lanes)

        def run():
            return cuda_step_vjp.launch_rr(kernel, hum_rr, state, tau, ct, None, pg, lanes)

        run()
        got = run()
        torch.cuda.synchronize()
        cycles = got[1][: n + 3, ::envs].double().mean(1).tolist()
        total = sum(cycles[:n])
        pcg = dict(zip(("scatter", "substitution passes", "gather and vectors"), cycles[n:]))
        print(json.dumps({"rr_vjp_phases": {
            "B": BATCH, "params_grad": pg, "lanes": lanes, "envs_a_block": envs, "event_ms": device_ms(run, 20),
            "cycles_a_block": round(total), "phases": {name: [round(c), round(c / total, 4)]
                                                        for (name, _), c in zip(RR_VJP_PHASES, cycles)},
            "pcg_iterations_both_solves": {k: [round(c), round(c / total, 4)] for k, c in pcg.items()},
        }}), flush=True)  # fmt: skip


def _merged(edits):
    """``edits`` with the later edits of one text applied to the earlier's
    replacement (each ``old`` of the result still once in its file)."""
    out = []
    for file, old, new in edits:
        for n, (f, o, w) in enumerate(out):
            if f == file and old in w:
                out[n] = (f, o, w.replace(old, new))
                break
        else:
            out.append((file, old, new))
    return out


def rr_vjp_faults_probe(hum, gen) -> None:
    """Each of RR_VJP_FAULTS seeded into a copy of ``csrc/`` under
    ``build/``, built beside the sound source for each K4-rr case's engine,
    plain and with params_grad, and every variant held to ``chip_smoke.py``'s
    K4-rr limits (``rr_vjp_gates``): per case, the worst ratio over its limit
    (> 1 is refused)."""
    import torch

    from chip_smoke import (
        rr_garpez_engine, rr_humanoid_engine, rr_start_states, rr_vjp_garpez_engine, rr_vjp_gates, rr_vjp_starts,
    )  # fmt: skip
    from jaxsim_tpu_torch.ops import cuda_build, cuda_step_vjp

    device = hum.S.device
    hum_rr, garp_rr = rr_humanoid_engine(device), rr_garpez_engine(device)
    rr_starts = rr_start_states(hum_rr, garp_rr, hum_rr, torch.Generator(device).manual_seed(6))
    starts = rr_vjp_starts(rr_starts, rr_vjp_garpez_engine(device), torch.Generator(device).manual_seed(8))
    sources = {"control": cuda_step_vjp.RR_SOURCE}
    for name, edits in RR_VJP_FAULTS.items():
        sources[name] = _seeded_edits("rr_vjp_faults", name, edits) / "step_vjp_rr.cu"
    engines = list({id(e): e for e, _, _ in starts.values()}.values())
    jobs = {(name, id(eng), pg): dataclasses.replace(cuda_step_vjp.job(eng, pg), source=src)
            for name, src in sources.items() for eng in engines for pg in (False, True)}  # fmt: skip
    kernels = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))

    def variant(name):
        def run(engine, state, tau, ct, params_grad=False):
            out, ct_tau, partials = cuda_step_vjp.launch_rr(
                kernels[(name, id(engine), params_grad)], engine, state, tau, ct, None, params_grad)
            if not params_grad:
                return out, ct_tau
            return out, ct_tau, cuda_step_vjp.unpack_params(engine, partials.sum(0))
        return run

    _, ratios = rr_vjp_gates(starts, torch.Generator(device).manual_seed(3), {name: variant(name) for name in sources})
    print(json.dumps({"rr_vjp_faults": ratios}), flush=True)


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
        copy = _seeded_copy("param_sum", str(n), "param_sum.cuh", old, f"constexpr int SUM_WARPS = {n};")
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


def lanes_probe(hum, gen) -> None:
    """The soft K1 and K5 at each of LANE_COUNTS lanes an env, on the
    flagship's and the ES generation's shapes."""
    import torch

    from chip_smoke import ES, ES_OPTIONS, es_population, es_sizes, profiled_ms
    from jaxsim_tpu_torch.ops import cuda_build, cuda_env_rollout, cuda_rollout
    from jaxsim_tpu_torch.ops.policies import obs_dim

    n, d = hum.n_joints, obs_dim(hum.n_joints)
    state = hum.init_state(PROFILE_BATCH, base_position=(0.0, 0.0, 0.9), generator=gen)
    _, weights = es_population(0.1 * torch.randn(sum(es_sizes(n, d)), generator=gen, device=gen.device), gen, n, d)
    pol = cuda_env_rollout.make_policy(hum, **weights)
    es_state = hum.init_state(ES["candidates"] * ES["envs_per"], base_position=(0.0, 0.0, 0.9), generator=gen)
    jobs = {("k1", lanes): cuda_rollout.job(hum, lanes) for lanes in LANE_COUNTS}
    recompute = _seeded_copy("lanes", "pairs recomputed", "soft_step_lanes.cuh", *RECOMPUTE_PAIR)
    jobs[("k1, iR and ip recomputed", LANE_COUNTS[0])] = dataclasses.replace(
        cuda_rollout.job(hum, LANE_COUNTS[0]), source=recompute / "rollout.cu")
    jobs.update({("k5", lanes): cuda_env_rollout.job(hum, pol, lanes) for lanes in LANE_COUNTS})
    builds = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))
    plain = cuda_rollout.rollout_reference(hum, state, LANE_CHECK_STEPS)
    for (kernel_name, lanes), kernel in builds.items():
        if kernel_name.startswith("k1"):
            geo, local = cuda_rollout.geometry(kernel), cuda_rollout.lane_local_memory(kernel)

            def run(steps=HORIZON):
                return cuda_rollout.launch(kernel, hum, state, steps, 60.0, 0.5)

            got = run(LANE_CHECK_STEPS)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got.fields(), plain.fields()))
            extra, name = {"B": PROFILE_BATCH, "steps": HORIZON, "max_abs_err_vs_plain": err}, "rollout_kernel"
        else:
            geo, local = cuda_env_rollout.geometry(kernel), cuda_rollout.lane_local_memory(kernel)

            def run():
                return cuda_env_rollout.launch(kernel, hum, es_state, ES["steps"], pol, kp=60.0, kd=0.5,
                                               reset_noise=0.0, seed=0, **ES_OPTIONS)  # fmt: skip

            extra, name = {"B": es_state.p.shape[-1], "steps": ES["steps"]}, "env_rollout_kernel"
        run()  # warm-up
        print(json.dumps({"lanes": {
            "kernel": kernel_name, "lanes": lanes, **extra,
            "ptxas": [ln.strip() for ln in kernel.ptxas_log.splitlines() if "registers" in ln or "stack frame" in ln],
            "geometry": geo, "local_loads_and_stores": local,
            "kernel_ms": profiled_ms(run, name, LANE_REPEATS), "event_ms": device_ms(run, LANE_REPEATS),
        }}), flush=True)  # fmt: skip


def quat_probe(hum, gen) -> None:
    """The plain twin without its quaternion renormalisation against the
    sound one, beside float32's own spread (float32 against float64)."""
    import copy

    import torch

    from chip_smoke import BOX_SPIN, box_engine, moving_joints, over_envs, per_env_abs_diff
    from jaxsim_tpu_torch import BatchedState
    from jaxsim_tpu_torch.ops.batched_engine import BatchedEngine

    def spin(state):
        v = state.v.clone()
        v[3:6] = BOX_SPIN["rate"] / 3**0.5 * torch.randn(v[3:6].shape, generator=gen, device=v.device)
        p = state.p + torch.tensor([[0.0], [0.0], [BOX_SPIN["height"]]], device=v.device)
        return dataclasses.replace(state, p=p, v=v)

    state0 = hum.init_state(QUAT_BATCH, base_position=(0.0, 0.0, 0.9), generator=gen)
    box = box_engine(hum.S.device)
    starts = {
        "humanoid23 joints moving": (hum, moving_joints(state0, gen)),
        "humanoid23 spinning in the air": (hum, spin(state0)),
        "box spinning in the air": (box, spin(box.init_state(QUAT_BATCH, base_position=(0.0, 0.0, 0.0), generator=gen))),
    }
    normalize = BatchedEngine.__dict__["_normalize_quat"]
    for name, (engine, state) in starts.items():
        def run(eng, st):
            with torch.no_grad():
                return eng.rollout(st, QUAT_STEPS, policy=lambda x: -60.0 * x.s - 0.5 * x.sd)

        sound = run(engine, state)
        wide = run(copy.deepcopy(engine).double(), BatchedState(*(t.double() for t in state.fields())))
        BatchedEngine._normalize_quat = staticmethod(lambda q: q)
        try:
            fault = run(engine, state)
        finally:
            BatchedEngine._normalize_quat = normalize
        print(json.dumps({"quat": {
            "start": name, "B": QUAT_BATCH, "steps": QUAT_STEPS,
            "float32_vs_float64": over_envs(per_env_abs_diff(BatchedState(*(t.double() for t in sound.fields())), wide),
                                            "max"),
            "not_renormalised_vs_float32": over_envs(per_env_abs_diff(fault, sound), "max"),
        }}), flush=True)  # fmt: skip


def k1_faults_probe(hum, gen) -> None:
    """Each of K1_FAULTS seeded into a copy of ``csrc/`` under ``build/``,
    built beside the sound source for each engine of CASES, and every
    variant held to ``chip_smoke.py``'s CASES limits (``k1_gates``): per
    case, the worst field's statistic over its limit (> 1 is refused)."""
    from chip_smoke import k1_gates, pendulum_engine, start_states
    from jaxsim_tpu_torch.ops import cuda_build, cuda_rollout

    starts = start_states(pendulum_engine(hum.S.device), hum)
    sources = {"control": cuda_rollout.SOURCE}
    for name, (old, new) in K1_FAULTS.items():
        sources[name] = _seeded_copy("k1_faults", name, "soft_step_lanes.cuh", old, new) / "rollout.cu"
    engines = list({id(e): e for e, _ in starts.values()}.values())
    jobs = {(name, id(eng)): dataclasses.replace(cuda_rollout.job(eng), source=src)
            for name, src in sources.items() for eng in engines}  # fmt: skip
    kernels = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))

    def variant(name):
        return lambda eng, st, n: cuda_rollout.launch(kernels[(name, id(eng))], eng, st, n, 60.0, 0.5)

    _, ratios = k1_gates(starts, {name: variant(name) for name in sources})
    print(json.dumps({"k1_faults": ratios}), flush=True)


def step_probe(hum, gen) -> None:
    """K2 and K3 at each lane count, envs a block and place of the model
    arrays, on the humanoid and on garpez (see the module's note)."""
    import torch

    from chip_smoke import apg_setup, garpez_engine, pendulum_engine, profiled_ms, vjp_starts
    from jaxsim_tpu_torch.ops import cuda_build, cuda_rollout, cuda_step

    garp = garpez_engine(hum.S.device)
    starts, case_tau = vjp_starts(pendulum_engine(hum.S.device), hum, garp, apg_setup(garp))
    garp_start = starts["garpez APG start"][1]
    # Per model: the engine, the timed state, the checked start, and the
    # torques of a state (K3's; K2's are the PD policy's, the humanoid's too).
    cases = dict(
        humanoid23=(hum, starts["humanoid23 main-path start"][1], starts["humanoid23 joints moving"][1],
                    lambda st: case_tau("humanoid23", st), ("k2", "k3")),
        garpez=(garp, garp_start, garp_start, lambda st: case_tau("garpez", st), ("k3",)),
    )  # fmt: skip
    l1 = _seeded_copy("step", "L1", "step.cu", *STEP_L1[0], STEP_L1[1:])
    sources = {"shared": cuda_step.SOURCE, "L1": l1 / "step.cu"}
    keys = [(name, lanes, envs, arrays) for name, (eng, *_) in cases.items() for lanes in STEP_LANES
            for arrays in sources for envs in cuda_step.block_envs(eng, lanes)]  # fmt: skip
    jobs = [dataclasses.replace(cuda_step.job(cases[name][0], lanes, envs), source=sources[arrays])
            for name, lanes, envs, arrays in keys]  # fmt: skip
    builds = dict(zip(keys, cuda_build.build_many(jobs)))
    plains = {}
    for name, (eng, _, check, tau_of, _) in cases.items():
        st = check
        for _ in range(LANE_CHECK_STEPS):
            st = cuda_step.step_tau_reference(eng, st, tau_of(st))
        plains[name] = st
    for (name, lanes, envs, arrays), kernel in builds.items():
        eng, state, check, tau_of, kinds = cases[name]
        params, tau = cuda_build.packed_params(eng), tau_of(state)
        steps = dict(k2=lambda st: cuda_step.launch_pd(kernel, eng, st, 60.0, 0.5),
                     k3=lambda st: cuda_step.launch_tau(kernel, eng, st, tau_of(st), params))  # fmt: skip
        runs = dict(k2=(lambda: cuda_step.launch_pd(kernel, eng, state, 60.0, 0.5), "step_pd_kernel"),
                    k3=(lambda: cuda_step.launch_tau(kernel, eng, state, tau, params), "step_tau_kernel"))  # fmt: skip
        for kind in kinds:
            st = check
            for _ in range(LANE_CHECK_STEPS):
                st = steps[kind](st)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(st.fields(), plains[name].fields()) if a.numel())
            run, kname = runs[kind]
            run()  # warm-up
            print(json.dumps({"step": {
                "kernel": kind, "model": name, "B": state.p.shape[-1], "lanes": lanes, "envs": envs,
                "model_arrays": arrays,
                "ptxas": [ln.strip() for ln in kernel.ptxas_log.splitlines() if "registers" in ln or "stack frame" in ln],
                "geometry": cuda_step.geometry(kernel), "local_loads_and_stores": cuda_rollout.lane_local_memory(kernel),
                "kernel_ms": profiled_ms(run, kname, LAUNCH_REPEATS), "event_ms": device_ms(run, LAUNCH_REPEATS),
                "max_abs_err_vs_plain": err,
            }}), flush=True)  # fmt: skip


def step_faults_probe(hum, gen) -> None:
    """Each of STEP_FAULTS seeded into a copy of ``csrc/`` under ``build/``,
    built beside the sound source for each engine of ``step_gates``' cases,
    and K3 launched with the engine's own model arrays in place of ``pr``'s;
    every variant held to ``chip_smoke.py``'s K2 and K3 limits: per case,
    the worst field's statistic over its limit (> 1 is refused)."""
    from chip_smoke import apg_setup, garpez_engine, pendulum_engine, step_gates, vjp_starts
    from jaxsim_tpu_torch.ops import cuda_build, cuda_step

    device = hum.S.device
    garp = garpez_engine(device)
    starts, case_tau = vjp_starts(pendulum_engine(device), hum, garp, apg_setup(garp))
    sources = {"control": cuda_step.SOURCE}
    for name, (old, new) in STEP_FAULTS.items():
        sources[name] = _seeded_copy("step_faults", name, "step.cu", old, new) / "step.cu"
    engines = list({id(e): e for e, _ in starts.values()}.values())
    jobs = {(name, id(eng)): dataclasses.replace(cuda_step.job(eng), source=src)
            for name, src in sources.items() for eng in engines}  # fmt: skip
    kernels = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))

    def variant(name, own_params=False):
        def k2(eng, st):
            return cuda_step.launch_pd(kernels[(name, id(eng))], eng, st, 60.0, 0.5)

        def k3(eng, st, tau, pr):
            params = cuda_build.packed_params(eng, None if own_params else pr)
            return cuda_step.launch_tau(kernels[(name, id(eng))], eng, st, tau, params)

        return k2, k3

    variants = {name: variant(name) for name in sources}
    variants["model arrays from the engine, not pr"] = variant("control", own_params=True)
    _, ratios = step_gates(starts, case_tau, variants)
    print(json.dumps({"step_faults": ratios}), flush=True)


def kernels_probe(hum, gen) -> None:
    """Each kernel of the main paths at its main path's shape (see the
    module's note), from entry points every version of the port since the
    lane-spread K1 and K5 has, so that a copy of this script in an older
    checkout times that checkout's kernels; and the SHA-256 of each loaded
    library's SASS instructions (``cuobjdump -sass``), equal where the
    machine code is."""
    import hashlib
    import re
    import time

    import torch

    from chip_smoke import (
        ENV_STEPS, ES, ES_OPTIONS, RK4_INTEGRATORS, RR_CASES, RR_HORIZON, RR_RK4_HORIZON, SOFT_RK4_HORIZON, apg_setup,
        es_population, es_sizes, garpez_engine, pendulum_engine, profiled_ms, rr_garpez_engine, rr_humanoid_engine,
        rr_start_states, vjp_cotangents, vjp_starts, with_integrator,
    )  # fmt: skip
    from jaxsim_tpu_torch.ops import cuda_build, cuda_env_rollout, cuda_rollout, cuda_step, cuda_step_vjp
    from jaxsim_tpu_torch.ops.policies import obs_dim

    device = hum.S.device
    garp = garpez_engine(device)
    apg = apg_setup(garp)
    starts, case_tau = vjp_starts(pendulum_engine(device), hum, garp, apg)
    state0 = starts["humanoid23 main-path start"][1]
    tau0 = (-60.0 * state0.s - 0.5 * state0.sd).contiguous()
    ct0 = vjp_cotangents(state0, gen)["all six"]
    garp_tau = case_tau("garpez", apg["start"])
    n, d = hum.n_joints, obs_dim(hum.n_joints)
    _, weights = es_population(0.1 * torch.randn(sum(es_sizes(n, d)), generator=gen, device=device), gen, n, d)
    pol = cuda_env_rollout.make_policy(hum, **weights)
    es_state = hum.init_state(ES["candidates"] * ES["envs_per"], base_position=(0.0, 0.0, 0.9), generator=gen)
    hum_rr = rr_humanoid_engine(device)
    rr_start = rr_start_states(hum_rr, rr_garpez_engine(device), hum_rr, torch.Generator(device).manual_seed(6))[
        RR_CASES[0][0]][1]  # fmt: skip
    rr_tau = (-60.0 * rr_start.s - 0.5 * rr_start.sd).contiguous()
    cuda_build.build_many([cuda_rollout.job(hum), cuda_rollout.job(hum_rr), cuda_env_rollout.job(hum, pol),
                           cuda_step_vjp.job(hum), cuda_step_vjp.job(hum, params_grad=True), cuda_step.job(hum),
                           cuda_step.job(garp), cuda_step.job(hum_rr)])  # fmt: skip
    # Built for their SASS only: K1's RK4 and RK4-fast builds, soft and
    # relaxed-rigid, K5-rr and K4-rr (all but K4-rr timed below).
    cuda_build.build_many([
        *(cuda_rollout.job(with_integrator(e, i)) for e in (hum, hum_rr) for i in RK4_INTEGRATORS),
        cuda_env_rollout.job(hum_rr, cuda_env_rollout.make_policy(hum_rr, **weights)),
        cuda_step_vjp.job(hum_rr), cuda_step_vjp.job(hum_rr, params_grad=True),
    ])  # fmt: skip
    rr_rk4 = {i: with_integrator(hum_rr, i) for i in RK4_INTEGRATORS}
    soft_rk4 = {i: with_integrator(hum, i) for i in RK4_INTEGRATORS}
    rr_pol = cuda_env_rollout.make_policy(hum_rr, **weights)
    from jaxsim_tpu_torch.envs import BatchedEnv

    rr_env = BatchedEnv(engine=hum_rr, episode_length=ES_OPTIONS["episode_length"],
                        healthy_z_range=ES_OPTIONS["healthy_z_range"])  # fmt: skip
    calls = dict(
        rollout=(lambda: cuda_rollout.rollout(hum, state0, HORIZON), "rollout_kernel", 3),
        env_rollout=(lambda: cuda_env_rollout.env_rollout(hum, es_state, ES["steps"], **ES_OPTIONS, **weights),
                     "env_rollout_kernel", 3),
        step_vjp=(lambda: cuda_step_vjp.step_vjp(hum, state0, tau0, ct0), "step_vjp_kernel", LAUNCH_REPEATS),
        step_vjp_params_grad=(lambda: cuda_step_vjp.step_vjp(hum, state0, tau0, ct0, params_grad=True),
                              "step_vjp_kernel", LAUNCH_REPEATS),
        rollout_relaxed_rigid=(lambda: cuda_rollout.rollout(hum_rr, rr_start, RR_HORIZON), "rollout_rr_kernel", 3),
        # K2-rr's kernel is named "step_pd_rr_kernel" in the checkouts that
        # gave it a source of its own, "rollout_rr_kernel" (K1-rr) after.
        step_pd_relaxed_rigid=(lambda: cuda_step.step_pd(hum_rr, rr_start), "_rr_kernel", LAUNCH_REPEATS),
        step_tau_relaxed_rigid=(lambda: cuda_step.step_tau(hum_rr, rr_start, rr_tau), "step_tau_rr_kernel",
                                LAUNCH_REPEATS),
        step_pd=(lambda: cuda_step.step_pd(hum, state0), "step_pd_kernel", LAUNCH_REPEATS),
        step_tau=(lambda: cuda_step.step_tau(hum, state0, tau0), "step_tau_kernel", LAUNCH_REPEATS),
        step_tau_garpez=(lambda: cuda_step.step_tau(garp, apg["start"], garp_tau), "step_tau_kernel", LAUNCH_REPEATS),
        # BASELINE config 5 (K1-rr RK4) and K1-rr RK4-fast, each at
        # RR_RK4_HORIZON steps; K5-rr on the relaxed-rigid ES generation.
        rollout_rr_rk4=(lambda: cuda_rollout.rollout(rr_rk4["rk4"], rr_start, RR_RK4_HORIZON), "rollout_rr_kernel", 3),
        rollout_rr_rk4fast=(lambda: cuda_rollout.rollout(rr_rk4["rk4fast"], rr_start, RR_RK4_HORIZON),
                            "rollout_rr_kernel", 3),
        env_rollout_relaxed_rigid=(lambda: cuda_env_rollout.env_rollout(hum_rr, rr_start, ES["steps"], **ES_OPTIONS,
                                                                        **weights), "env_rollout_rr_kernel", 3),
        # The soft RK4 main path's K1 and soft RK4-fast, SOFT_RK4_HORIZON steps.
        rollout_rk4=(lambda: cuda_rollout.rollout(soft_rk4["rk4"], state0, SOFT_RK4_HORIZON), "rollout_kernel", 3),
        rollout_rk4fast=(lambda: cuda_rollout.rollout(soft_rk4["rk4fast"], state0, SOFT_RK4_HORIZON), "rollout_kernel",
                         3),
    )  # fmt: skip
    for name, (fn, kernel, repeats) in calls.items():
        fn()  # warm-up
        row = {"call": name, "event_ms": device_ms(fn, repeats)}
        try:
            row["kernel_ms"] = profiled_ms(fn, kernel, repeats)
        except RuntimeError as exc:  # the profiler dropped a launch in every window
            row["kernel_ms"] = str(exc)
        print(json.dumps({"kernels": row}), flush=True)
    # The relaxed-rigid BatchedEnv.step (K3-rr and the torch ops around it):
    # wall ms a step over ENV_STEPS, synchronised, as chip_smoke.py times it.
    env_state, _ = rr_env.reset(torch.Generator(device).manual_seed(2), rr_start.p.shape[-1])
    env_state, _, _, _ = rr_env.step(env_state, torch.zeros_like(env_state.sim.s))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENV_STEPS):
        env_state, _, _, _ = rr_env.step(env_state, (-60.0 * env_state.sim.s - 0.5 * env_state.sim.sd).contiguous())
    torch.cuda.synchronize()
    print(json.dumps({"kernels": {"call": "batched_env_step_relaxed_rigid",
                                  "wall_ms": (time.perf_counter() - t0) * 1e3 / ENV_STEPS}}), flush=True)  # fmt: skip
    for (source, header), build in cuda_build._BUILDS.items():
        sass = subprocess.run([cuda_build.cuda_tool("cuobjdump"), "-sass", str(build.path)],
                              capture_output=True, text=True, check=True).stdout  # fmt: skip
        code = "\n".join(ln.strip() for ln in sass.splitlines() if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln))
        # A library by its source and generated header, which a parent and a
        # change share where the topology tables are the same (the build
        # key also hashes the sources' text).
        print(json.dumps({"kernels_sass": {
            "library": build.path.parent.name, "source": pathlib.Path(source).name,
            "header_sha256": hashlib.sha256(header.encode()).hexdigest()[:16],
            "sha256": hashlib.sha256(code.encode()).hexdigest(),
        }}), flush=True)  # fmt: skip


def rk4_faults_probe(hum, gen) -> None:
    """Each of RK4_FAULTS seeded into a copy of ``csrc/`` under ``build/``,
    built for every RK4 and RK4-fast engine of the gates beside the sound
    source, and every variant held to ``chip_smoke.py``'s RK4 limits
    (``k1_gates`` with RK4_CASES, ``rr_gates`` with RR_RK4_CASES): per integrator and case,
    the worst field's statistic over its limit (> 1 is refused)."""
    import torch

    from chip_smoke import (
        RK4_CASES, RK4_INTEGRATORS, RR_RK4_CASES, k1_gates, pendulum_engine, rr_garpez_engine, rr_gates,
        rr_humanoid_engine, rr_start_states, start_states, with_integrator,
    )  # fmt: skip
    from jaxsim_tpu_torch.ops import cuda_build, cuda_rollout

    device = hum.S.device
    starts = start_states(pendulum_engine(device), hum)
    dirs = {"control": cuda_build.CSRC}
    for name, edits in RK4_FAULTS.items():
        dirs[name] = _seeded_edits("rk4_faults", name, edits)
    ratios = {}
    for i in RK4_INTEGRATORS:
        engines = {id(e): with_integrator(e, i) for e, _ in starts.values()}
        soft = {name: (engines[id(starts[name][0])], starts[name][1]) for name, *_ in RK4_CASES}
        hum_rr, garp_rr = rr_humanoid_engine(device, i), rr_garpez_engine(device, i)
        rr = rr_start_states(hum_rr, garp_rr, hum_rr, torch.Generator(device).manual_seed(6))
        jobs = {}
        for name, d in dirs.items():
            for eng in [*engines.values(), hum_rr, garp_rr]:
                job = cuda_rollout.job(eng)
                jobs[(name, id(eng))] = dataclasses.replace(job, source=d / job.source.name)
        kernels = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))

        def variant(name, rr_gains=False):
            if rr_gains:
                return lambda eng, st, n, kp, kd: cuda_rollout.launch(kernels[(name, id(eng))], eng, st, n, kp, kd)
            return lambda eng, st, n: cuda_rollout.launch(kernels[(name, id(eng))], eng, st, n, 60.0, 0.5)

        _, ratios[f"soft {i}"] = k1_gates(soft, {name: variant(name) for name in dirs}, RK4_CASES)
        _, ratios[f"relaxed-rigid {i}"] = rr_gates(rr, {name: variant(name, True) for name in dirs}, RR_RK4_CASES)
    print(json.dumps({"rk4_faults": ratios}), flush=True)


def rr_step_probe(hum, gen) -> None:
    """K3-rr at each envs a block of RR_STEP_ENVS on the relaxed-rigid
    humanoid and garpez (see the module's note)."""
    import torch

    from chip_smoke import RR_CASES, profiled_ms, rr_diff, rr_garpez_engine, rr_humanoid_engine, rr_start_states
    from jaxsim_tpu_torch.ops import cuda_build, cuda_rollout, cuda_step

    device = hum.S.device
    hum_rr, garp_rr = rr_humanoid_engine(device), rr_garpez_engine(device)
    starts = rr_start_states(hum_rr, garp_rr, hum_rr, torch.Generator(device).manual_seed(6))
    cases = dict(humanoid23=starts[RR_CASES[0][0]], garpez=starts[RR_CASES[5][0]])
    keys = [(name, envs) for name in cases for envs in RR_STEP_ENVS]
    builds = dict(zip(keys, cuda_build.build_many([cuda_step.job(cases[name][0], envs=envs) for name, envs in keys])))
    plains = {}
    for name, (eng, st, (kp, kd)) in cases.items():
        for _ in range(LANE_CHECK_STEPS):
            st = cuda_step.step_tau_reference(eng, st, -kp * st.s - kd * st.sd)
        plains[name] = st
    for (name, envs), kernel in builds.items():
        eng, state, (kp, kd) = cases[name]
        params, tau = cuda_build.packed_params(eng), (-kp * state.s - kd * state.sd).contiguous()
        st = state
        for _ in range(LANE_CHECK_STEPS):
            st = cuda_step.launch_tau(kernel, eng, st, (-kp * st.s - kd * st.sd).contiguous(), params)
        torch.cuda.synchronize()
        err = max(float(d.max()) for d in rr_diff(st, plains[name]).values())

        def run():
            return cuda_step.launch_tau(kernel, eng, state, tau, params)

        run()  # warm-up
        print(json.dumps({"rr_step": {
            "kernel": "k3", "model": name, "B": state.p.shape[-1], "envs_asked": envs,
            "ptxas": [ln.strip() for ln in kernel.ptxas_log.splitlines()
                      if "registers" in ln or "stack frame" in ln or "spill" in ln],
            "geometry": cuda_step.geometry(kernel), "local_loads_and_stores": cuda_rollout.rr_local_memory(kernel),
            "kernel_ms": profiled_ms(run, "step_tau_rr_kernel", LAUNCH_REPEATS), "event_ms": device_ms(run, LAUNCH_REPEATS),
            "max_abs_err_vs_plain_m_relative": err,
        }}), flush=True)  # fmt: skip


def rr_step_faults_probe(hum, gen) -> None:
    """Each of RR_STEP_FAULTS seeded into a copy of ``csrc/`` under
    ``build/``, built beside the sound source for every engine of the gates,
    and every variant held to ``chip_smoke.py``'s limits: K2-rr and K3-rr
    chained by ``rr_gates`` (RR_CASES), K5-rr by ``rr_env_gates``
    (RR_ENV_CASES, from ``chip_smoke.rr_env_cases``); per case the worst
    statistic over its limit (> 1 is refused)."""
    import torch

    from chip_smoke import (
        es_population, es_sizes, pd_tau_as_kernels, rr_env_cases, rr_env_gates, rr_garpez_engine, rr_gates,
        rr_humanoid_engine, rr_start_states, rr_touchdown_engine,
    )  # fmt: skip
    from jaxsim_tpu_torch.ops import cuda_build, cuda_env_rollout, cuda_rollout, cuda_step
    from jaxsim_tpu_torch.ops.policies import obs_dim

    device = hum.S.device
    hum_rr, garp_rr, hum_td = rr_humanoid_engine(device), rr_garpez_engine(device), rr_touchdown_engine(device)
    dirs = {"control": cuda_build.CSRC}
    for name, edits in RR_STEP_FAULTS.items():
        dirs[name] = _seeded_edits("rr_step_faults", name, edits)
    touched = {name: {file for file, _, _ in edits} for name, edits in RR_STEP_FAULTS.items()}

    # K2-rr (rollout_rr.cu, one step a launch) and K3-rr (step_rr.cu),
    # chained, on RR_CASES.
    sources = dict(K2=("rollout_rr.cu", cuda_rollout.job), K3=("step_rr.cu", cuda_step.job))
    variant_keys = [(name, kind) for name in dirs for kind, (file, _) in sources.items()
                    if name == "control" or file in touched[name]]  # fmt: skip
    jobs = {(name, kind, id(eng)): dataclasses.replace(sources[kind][1](eng), source=dirs[name] / sources[kind][0])
            for name, kind in variant_keys for eng in (hum_rr, garp_rr, hum_td)}  # fmt: skip
    kernels = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))

    def k2(name):
        def run(eng, st, n, kp, kd):
            for _ in range(n):
                st = cuda_rollout.launch(kernels[(name, "K2", id(eng))], eng, st, 1, kp, kd)
            return st

        return run

    def k3(name):
        def run(eng, st, n, kp, kd):
            params = cuda_build.packed_params(eng)
            for _ in range(n):
                st = cuda_step.launch_tau(kernels[(name, "K3", id(eng))], eng, st, pd_tau_as_kernels(st, kp, kd),
                                          params)  # fmt: skip
            return st

        return run

    starts = rr_start_states(hum_rr, garp_rr, hum_td, torch.Generator(device).manual_seed(6))
    variants = {f"{name}, {kind}": dict(K2=k2, K3=k3)[kind](name) for name, kind in variant_keys}
    _, ratios = rr_gates(starts, variants)
    print(json.dumps({"rr_step_faults": ratios}), flush=True)

    # K5-rr on RR_ENV_CASES (chip_smoke.rr_env_cases, with ES weights of the
    # probe's own seed).
    n, d = hum_rr.n_joints, obs_dim(hum_rr.n_joints)
    gen1 = torch.Generator(device).manual_seed(1)
    _, mlp = es_population(0.1 * torch.randn(sum(es_sizes(n, d)), generator=gen1, device=device), gen1, n, d)
    cases = rr_env_cases(hum_rr, garp_rr, starts, mlp)
    env_names = [name for name in dirs if name == "control" or "env_rollout_rr.cu" in touched[name]]
    weight_names = ("W", "b", "W1", "b1", "W2", "b2")
    # env_rollout's defaults of the options a case may leave out.
    defaults = dict(kp=60.0, kd=0.5, episode_length=1000, healthy_z_range=(0.4, 2.0), tau_limit=None,
                    reset_noise=0.0, seed=0)  # fmt: skip

    def split(eng, opts):
        pol = cuda_env_rollout.make_policy(eng, **{k: v for k, v in opts.items() if k in weight_names})
        return pol, {**defaults, **{k: v for k, v in opts.items() if k not in weight_names}}

    env_jobs = {}
    for name in env_names:
        for _, eng, _, _, _, opts in cases:
            pol = split(eng, opts)[0]
            env_jobs[(name, id(eng), pol.kind)] = dataclasses.replace(
                cuda_env_rollout.job(eng, pol), source=dirs[name] / "env_rollout_rr.cu")
    env_kernels = dict(zip(env_jobs, cuda_build.build_many(list(env_jobs.values()))))

    def k5(name):
        def run(eng, st, steps, **opts):
            pol, rest = split(eng, opts)
            return cuda_env_rollout.launch(env_kernels[(name, id(eng), pol.kind)], eng, st, steps, pol, **rest)

        return run

    _, env_ratios = rr_env_gates(cases, {name: k5(name) for name in env_names})
    print(json.dumps({"rr_env_faults": env_ratios}), flush=True)


def _rr_forward_rows(hum, gen, probe: str, builds: dict) -> None:
    """K1-rr (SIE, RK4, RK4-fast), K3-rr and K5-rr on the relaxed-rigid
    humanoid at the main path's shapes for each of ``builds`` (a key: the
    copy of ``csrc/`` to build, None for the checkout's, and the envs a
    block at most), a JSON line each under ``probe`` (see the module's note
    on rr_envs)."""
    import re

    import torch

    from chip_smoke import (
        ES, ES_OPTIONS, RR_CASES, RR_HORIZON, RR_RK4_HORIZON, es_population, es_sizes, profiled_ms, rr_diff,
        rr_garpez_engine, rr_humanoid_engine, rr_start_states, with_integrator,
    )  # fmt: skip
    from jaxsim_tpu_torch.ops import cuda_build, cuda_env_rollout, cuda_rollout, cuda_step
    from jaxsim_tpu_torch.ops.policies import obs_dim

    device = hum.S.device
    hum_rr = rr_humanoid_engine(device)
    start = rr_start_states(hum_rr, rr_garpez_engine(device), hum_rr, torch.Generator(device).manual_seed(6))[
        RR_CASES[0][0]][1]  # fmt: skip
    n, d = hum_rr.n_joints, obs_dim(hum_rr.n_joints)
    _, weights = es_population(0.1 * torch.randn(sum(es_sizes(n, d)), generator=gen, device=device), gen, n, d)
    pol = cuda_env_rollout.make_policy(hum_rr, **weights)
    engines = {"sie": hum_rr, "rk4": with_integrator(hum_rr, "rk4"), "rk4fast": with_integrator(hum_rr, "rk4fast")}

    def with_envs(job, envs):
        return dataclasses.replace(job, defines=(*job.defines, ("JX_RR_MAX_ENVS", envs)))

    def of(job, copy, envs):
        job = with_envs(job, envs)
        return job if copy is None else dataclasses.replace(job, source=copy / job.source.name)

    jobs = {}
    for key, (copy, envs) in builds.items():
        for name, eng in engines.items():
            jobs[(f"k1_{name}", key)] = of(cuda_rollout.job(eng), copy, envs)
        jobs[("k3", key)] = of(cuda_step.job(hum_rr), copy, envs)
        jobs[("k5", key)] = of(cuda_env_rollout.job(hum_rr, pol), copy, envs)
    kernels = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))
    tau = (-60.0 * start.s - 0.5 * start.sd).contiguous()
    plains = {name: cuda_rollout.rollout_reference(eng, start, LANE_CHECK_STEPS) for name, eng in engines.items()
              if name != "rk4fast"}  # fmt: skip
    for (kind, key), kernel in kernels.items():
        if kind.startswith("k1_"):
            eng = engines[kind[3:]]
            steps = RR_HORIZON if kind == "k1_sie" else RR_RK4_HORIZON

            def run(eng=eng, kernel=kernel, steps=steps):
                return cuda_rollout.launch(kernel, eng, start, steps, 60.0, 0.5)

            name, repeats = "rollout_rr_kernel", REPEATS
            geometry = cuda_rollout.rr_geometry(kernel)
        elif kind == "k3":
            params = cuda_build.packed_params(hum_rr)

            def run(kernel=kernel, params=params):
                return cuda_step.launch_tau(kernel, hum_rr, start, tau, params)

            name, repeats, geometry = "step_tau_rr_kernel", LAUNCH_REPEATS, cuda_step.geometry(kernel)
        else:
            def run(kernel=kernel):
                return cuda_env_rollout.launch(kernel, hum_rr, start, ES["steps"], pol, kp=60.0, kd=0.5, reset_noise=0.0,
                                               seed=0, **ES_OPTIONS)  # fmt: skip

            name, repeats, geometry = "env_rollout_rr_kernel", REPEATS, cuda_env_rollout.geometry(kernel)
        row = {"kernel": kind, "build": key, "geometry": geometry,
               "ptxas": [ln.strip() for ln in kernel.ptxas_log.splitlines()
                         if "registers" in ln or "stack frame" in ln or "spill" in ln],
               "spill_stores": sum(map(int, re.findall(r"(\d+) bytes spill stores", kernel.ptxas_log))),
               "local_loads_and_stores": cuda_rollout.rr_local_memory(kernel)}  # fmt: skip
        if kind[3:] in plains:
            got = cuda_rollout.launch(kernel, engines[kind[3:]], start, LANE_CHECK_STEPS, 60.0, 0.5)
            torch.cuda.synchronize()
            row["max_abs_err_vs_plain_m_relative"] = max(float(x.max()) for x in rr_diff(got, plains[kind[3:]]).values())
        run()  # warm-up
        try:
            row["kernel_ms"] = profiled_ms(run, name, repeats)
        except RuntimeError as exc:  # the profiler dropped a launch in every window
            row["kernel_ms"] = str(exc)
        row["event_ms"] = device_ms(run, repeats)
        print(json.dumps({probe: row}), flush=True)


def rr_envs_probe(hum, gen) -> None:
    """The relaxed-rigid forward builds at each envs a block of RR_ENVS_SWEEP."""
    _rr_forward_rows(hum, gen, "rr_envs", {envs: (None, envs) for envs in RR_ENVS_SWEEP})


def rr_variants_probe(hum, gen) -> None:
    """The relaxed-rigid forward builds from copies of ``csrc/`` with each of
    RR_STEP_VARIANTS seeded, beside the checkout's, 64 envs a block."""
    from jaxsim_tpu_torch.ops import cuda_build

    builds = {"as built": (None, cuda_build.RR_MAX_ENVS)}
    for name, edits in RR_STEP_VARIANTS.items():
        builds[name] = (_seeded_edits("rr_variants", name, edits), cuda_build.RR_MAX_ENVS)
    _rr_forward_rows(hum, gen, "rr_variants", builds)


# Clock stamps for the rr_phases probe, for the parent's one-thread free ABA
# and for the lane-spread one (each edit is tried on the source it names; a
# set applies where every one of its texts is there once): each accumulates
# warp 0's cycles in the free ABA (jx_ph(0)) and the contact solve (jx_ph(1))
# of every step or stage, and around the kernel's step loop (jx_ph(2)); the
# block's first thread writes them over its env's p rows at the end.
_PH_COMMON = [
    ("rr_step.cuh", "struct Slot {\n",
     "__device__ __forceinline__ long long& jx_ph(int k) {\n  __shared__ long long acc[3];\n  return acc[k];\n}\n\n"
     "struct Slot {\n"),
    ("rollout_rr.cu", "  if constexpr (INTEGRATOR == 0) {\n",
     "  if (threadIdx.x == 0) jx_ph(0) = jx_ph(1) = 0;\n  const long long jxk = clock64();\n"
     "  if constexpr (INTEGRATOR == 0) {\n"),
    ("rollout_rr.cu", "\n}\n\n}  // namespace",
     "\n  if (threadIdx.x == 0) {\n    jx_ph(2) = clock64() - jxk;\n"
     "    for (int k = 0; k < 3; ++k) out.p[k * B + blockIdx.x * ENVS] = static_cast<float>(jx_ph(k));\n  }\n"
     "}\n\n}  // namespace"),
]


def _ph_wrap(call: str, indent: str, k: int = 0) -> str:
    return (f"{indent}const long long jx{k} = clock64();\n{call}"
            f"{indent}if (threadIdx.x == 0) jx_ph({k}) += clock64() - jx{k};\n")


_PH_ABA = {
    "one thread an env": [
        ("rr_step.cuh", c, _ph_wrap(c, i)) for c, i in (
            ("  if (aba) rr_free_step(P, sc, w, mine, s, sd, p, q, v, sdd, tau_of);\n  __syncthreads();\n", "  "),
            ("      if (aba) rr_free_step(P, sc, w, mine, s, sd, p, q, v, sdd, tau);\n      __syncthreads();\n", "      "),
            ("      rr_free_step<true>(P, sc, w, mine, s, sd, p, q, v, sdd, tau);\n", "      "))] + [
        ("rr_step.cuh", c, _ph_wrap(c, i, 1)) for c, i in (
            ("  float x[OWN * 3];\n  rr_solve(P, sc, sl, g, pt, m, x);\n", "  "),
            ("      rr_solve(P, sc, sl, g, pt, m, x);\n", "      "))],
    "lanes": [
        ("rr_step.cuh", c, _ph_wrap(c, i)) for c, i in (
            ("  rr_free_lanes<false>(P, sc.gz, sl, g, st, sdd, tau_of);\n", "  "),
            ("      if (Integrator == 2)\n        rr_free_body<false>(P, sc.gz, sl, g, st, sdd, tau);\n"
             "      else\n        rr_free_lanes<false>(P, sc.gz, sl, g, st, sdd, tau);\n", "      "),
            ("    if (Integrator == 2) rr_free_body<true>(P, sc.gz, sl, g, st, sdd, tau);\n", "    "))] + [
        ("rr_step.cuh", c, _ph_wrap(c, i, 1)) for c, i in (
            ("  float x[OWN * 3];\n  rr_solve(P, sc, sl, g, pt, m, x);\n", "  "),
            ("      rr_solve(P, sc, sl, g, pt, m, x);\n", "      "))],
}


def rr_phases_probe(hum, gen) -> None:
    """K1-rr's cycles a step by phase (the module's note) on the relaxed-rigid
    humanoid at 8192 envs from the main path's start: a copy of ``csrc/``
    under ``build/`` with the clock stamps of whichever free ABA the checkout
    has, built under semi-implicit Euler, RK4 and RK4-fast; per build the mean
    over blocks of warp 0's cycles a step in the free ABA, the contact solve
    and the rest, and their shares, beside the launch's event ms."""
    import torch

    from chip_smoke import RR_CASES, rr_garpez_engine, rr_humanoid_engine, rr_start_states, with_integrator
    from jaxsim_tpu_torch.ops import cuda_build, cuda_rollout

    device = hum.S.device
    hum_rr = rr_humanoid_engine(device)
    start = rr_start_states(hum_rr, rr_garpez_engine(device), hum_rr, torch.Generator(device).manual_seed(6))[
        RR_CASES[0][0]][1]  # fmt: skip
    texts = {f: (cuda_build.CSRC / f).read_text() for f in ("rr_step.cuh", "rollout_rr.cu")}
    (design,) = [k for k, edits in _PH_ABA.items() if all(texts[f].count(o) == 1 for f, o, _ in edits)]
    src = _seeded_edits("rr_phases", "stamps", _PH_COMMON + _PH_ABA[design]) / "rollout_rr.cu"
    engines = {i: with_integrator(hum_rr, i) for i in ("sie", "rk4", "rk4fast")}
    jobs = {i: dataclasses.replace(cuda_rollout.job(e), source=src) for i, e in engines.items()}
    kernels = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))
    envs = cuda_rollout.rr_geometry(kernels["sie"])["envs"]
    for i, kernel in kernels.items():
        def run(i=i, kernel=kernel):
            return cuda_rollout.launch(kernel, engines[i], start, RR_STEPS, 60.0, 0.5)

        run()
        cycles = run().p[:, ::envs].double().mean(1).tolist()
        torch.cuda.synchronize()
        aba, solve, total = (c / RR_STEPS for c in cycles)
        print(json.dumps({"rr_phases": {
            "design": design, "integrator": i, "B": start.p.shape[-1], "steps": RR_STEPS, "envs_a_block": envs,
            "event_ms": device_ms(run, REPEATS), "cycles_a_step": round(total),
            "free_aba": [round(aba), round(aba / total, 4)], "contact_solve": [round(solve), round(solve / total, 4)],
            "rest": [round(total - aba - solve), round((total - aba - solve) / total, 4)],
        }}), flush=True)  # fmt: skip


def rk4_variants_probe(hum, gen) -> None:
    """The soft K1's RK4 and RK4-fast builds on the soft RK4 main path's shape
    (the humanoid at 8192 envs from the main-path start, SOFT_RK4_HORIZON
    steps), as the checkout builds them and with each of RK4_VARIANTS and
    _RK4_OWNED whose texts the checkout's source holds; and built with the
    clock stamps (_RK4_PH; also on _RK4_BLOCKED), each step's cycles in its
    four rates and in the rest (the stage updates, y0, the torques, the
    quaternion's normalisations and the barriers between them). Per build: its ptxas lines, spill stores,
    launch geometry and local loads and stores, the worst field's max |Δ|
    against the plain twin after LANE_CHECK_STEPS steps, kernel-only ms
    (``torch.profiler``) and CUDA-event ms (median of REPEATS)."""
    import re

    import torch

    from chip_smoke import RK4_INTEGRATORS, SOFT_RK4_HORIZON, pendulum_engine, profiled_ms, start_states, with_integrator
    from jaxsim_tpu_torch.ops import cuda_build, cuda_rollout

    device = hum.S.device
    state = start_states(pendulum_engine(device), hum)["humanoid23 main-path start"][1]
    def fits(edits):
        return all((cuda_build.CSRC / file).read_text().count(old) == 1 for file, old, _ in edits)

    designs = {"as built": None}
    for name, edits in RK4_VARIANTS.items():
        if fits(edits):
            designs[name] = _seeded_edits("rk4_variants", name, edits)
    if fits(_RK4_OWNED):
        owned = designs["registers, entries a lane writes"] = _seeded_edits("rk4_variants", "owned", _RK4_OWNED)
        (owned / "rk4_owned.h").write_text(_rk4_owned_header(hum, cuda_rollout.LANES))
    designs["clock stamps"] = _seeded_edits("rk4_variants", "clock stamps", _RK4_PH)
    if fits(_RK4_BLOCKED):
        designs["clock stamps, a lane's entries in a block of rows"] = _seeded_edits(
            "rk4_variants", "clock stamps, blocked", _RK4_BLOCKED + _RK4_PH)
    engines = {i: with_integrator(hum, i) for i in RK4_INTEGRATORS}
    jobs = {}
    for name, copy in designs.items():
        for i, eng in engines.items():
            job = cuda_rollout.job(eng)
            jobs[(name, i)] = job if copy is None else dataclasses.replace(job, source=copy / job.source.name)
    kernels = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))
    plains = {i: cuda_rollout.rollout_reference(eng, state, LANE_CHECK_STEPS) for i, eng in engines.items()}
    for (name, i), kernel in kernels.items():
        def run(kernel=kernel, eng=engines[i], steps=SOFT_RK4_HORIZON):
            return cuda_rollout.launch(kernel, eng, state, steps, 60.0, 0.5)

        geometry = cuda_rollout.geometry(kernel)
        row = {"design": name, "integrator": i, "B": state.p.shape[-1], "steps": SOFT_RK4_HORIZON,
               "geometry": geometry,
               "ptxas": [ln.strip() for ln in kernel.ptxas_log.splitlines()
                         if "registers" in ln or "stack frame" in ln or "spill" in ln],
               "spill_stores": sum(map(int, re.findall(r"(\d+) bytes spill stores", kernel.ptxas_log))),
               "local_loads_and_stores": cuda_rollout.lane_local_memory(kernel)}  # fmt: skip
        if name.startswith("clock stamps"):
            total, rates = (run().p[:2, :: geometry["envs"]].double().mean(1) / SOFT_RK4_HORIZON).tolist()
            row.update(cycles_a_step=round(total), rates=[round(rates), round(rates / total, 4)],
                       rest=[round(total - rates), round((total - rates) / total, 4)])  # fmt: skip
        else:
            got = run(steps=LANE_CHECK_STEPS)
            row["max_abs_err_vs_plain"] = max(float((a - b).abs().max()) for a, b in zip(got.fields(), plains[i].fields())
                                              if a.numel())  # fmt: skip
        run()  # warm-up
        row["event_ms"] = device_ms(run, REPEATS)
        try:
            row["kernel_ms"] = profiled_ms(run, "rollout_kernel", REPEATS)
        except RuntimeError as exc:  # the profiler dropped a launch in every window
            row["kernel_ms"] = str(exc)
        print(json.dumps({"rk4_variants": row}), flush=True)


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
    "lanes": lanes_probe,
    "quat": quat_probe,
    "k1_faults": k1_faults_probe,
    "step": step_probe,
    "step_faults": step_faults_probe,
    "kernels": kernels_probe,
    "rk4_faults": rk4_faults_probe,
    "rr_step": rr_step_probe,
    "rr_step_faults": rr_step_faults_probe,
    "rr_vjp": rr_vjp_probe,
    "rr_vjp_faults": rr_vjp_faults_probe,
    "rr_vjp_phases": rr_vjp_phases_probe,
    "rr_envs": rr_envs_probe,
    "rr_variants": rr_variants_probe,
    "rr_phases": rr_phases_probe,
    "rk4_variants": rk4_variants_probe,
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
