#!/usr/bin/env python3
"""Drive the PyTorch port's kernels and main paths once on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``jaxsim_tpu_torch/csrc`` with
``nvcc`` (one process per library, all at once) and holds each against its
plain PyTorch version on the card:

* K1 (``rollout.cu``), K2 and K3 (``step.cu``), in every state field, on the
  fixed-base pendulum, on the 23-DoF humanoid at 8192 envs, from the main
  path's start and with the joints moving, and on a box spinning in the air
  (``CASES``); two K1 launches from the same start to the bit; K1's relaxed-rigid
  kernel (``rollout_rr.cu``) likewise on the humanoid, on garpez tilted
  low (also on a ragged batch), and on the humanoid's touchdown with 3 PCG
  iterations (``RR_CASES``), ``m`` (the solved point forces) relative to its
  size, with the active contact points of each case counted, and beside it
  on each case the relaxed-rigid K2 (``rollout_rr.cu`` for one step) and K3
  (``step_rr.cu``) chained one launch a step, against the same plain
  trajectories, K3-rr also under
  call-time ``M`` and ``rrMinv`` (``RR_PR``); K2 and K3 also on a batch that is
  not a multiple of their block (``STEP_RAGGED``), and K3 under call-time
  model arrays (``M`` scaled by 1.2) and on the garpez chain through one APG
  window from the APG main path's start (``step_gates``);
* K5 (``env_rollout.cu``) in every state field, the reward sums, the resets
  and the steps: truncation only (the MLP policy with 8 candidates), real
  terminations (the linear policy), and respawns with reset noise; and the
  relaxed-rigid K5 (``env_rollout_rr.cu``) on ``RR_ENV_CASES``: the ES main
  path's shapes, the humanoid in the air under the linear policy (the reward
  at a respawn), and garpez with a seeded ``m`` that a respawn must restore;
* K4 (``step_vjp.cu``, the fused step VJP, with and without the model
  arrays' cotangents) in every cotangent field per env, for seeded random
  output cotangents one state field at a time and all six at once, on the
  pendulum, the humanoid, garpez at the APG main path's start and garpez
  tilted low with points in contact (``VJP_CASES``), with the contact
  branches of the start states counted; the model arrays' cotangents entry
  by entry (``VJP_PARAMS_CASES``); its partials' sum against
  ``torch.sum``, and two runs of it to the bit; and the
  PD gains' gradient through a 10-step ``fused_diff_rollout`` against the
  plain twin under autograd;
* K4-rr (``step_vjp_rr.cu``, the relaxed-rigid step VJP with the implicit
  PCG backward, with and without the model arrays' cotangents, rrMinv's
  included) in every cotangent field per env and the model arrays entry by
  entry, for seeded output cotangents on all six leaves, on ``RR_VJP_CASES``:
  the JAX package's own case (garpez tilted low, B = 1024, 8 PCG
  iterations, tau = 0.1·N(0, 1)), the relaxed-rigid humanoid's main-path
  start and joints-moving start, garpez built with 3 PCG iterations, and
  garpez's ragged batch, held against the float64 twin where float32 alone
  breaches the limit; its block rows' sum (a row a block) against
  ``torch.sum`` and two runs of it to the bit; and the PD gains' gradient through a 10-step relaxed-rigid
  ``fused_diff_rollout`` on garpez against the plain twin under autograd;
* K1's RK4 and RK4-fast builds (``rollout.cu`` and ``rollout_rr.cu`` with
  ``JX_INTEGRATOR`` 1 and 2) in every state field: the soft one on CASES'
  starts over shorter horizons and on the soft humanoid's touchdown
  (``RK4_CASES``), the relaxed-rigid one on
  RR_CASES' starts over shorter horizons (``RR_RK4_CASES``), by the same
  statistics and limits;
* K6 and K7 (``fma_probe.cu``), each FMA-rate probe variant against its
  plain version at a small T, in units in the last place, at a multiplier
  and increment that move every chain at every iteration; and the FMA
  instructions in each probe's timed loop, read from its SASS.

Then it runs the main paths, each with every launch counter set to 0 just
before it and read just after:

* the flagship rollout: humanoid, soft contacts, flat ground, semi-implicit
  Euler, PD policy, 8192 envs, five chained 1000-step K1 launches;
* the per-step rollout (the JAX ``pallas_rollout``): 100 K2 launches;
* evolution strategies, ``examples/train_es_mlp.py``'s configuration uncut:
  8 candidates × 1024 envs, a tanh MLP with H = 16 and per-candidate
  weights, 500 steps a generation, episodes of 400, healthy height
  (0.6, 1.2) m, torques clipped at 100; three generations, one K5 launch each;
* ``BatchedEnv.step``: 20 steps at 8192 envs, one K3 launch each;
* the relaxed-rigid per-step rollout, ES generations and ``BatchedEnv.step``:
  the same three paths on the relaxed-rigid humanoid (bench.py's
  ``relaxed_rigid`` model) from the relaxed-rigid main path's start, on
  K2-rr, K5-rr and K3-rr;
* the policy gradient, bench.py's gradient path uncut: the gains of
  ``tau = -g0·s - g1·ṡ`` through 100 fused differentiable steps at 8192
  envs, ``mean(ṡ²) + mean(p_z)``, ``.backward()``: K3 forward, K4 backward;
* the hardware-parameter gradient: the same with respect to ``M`` and
  ``cpoint``, K4 with the model arrays' cotangents;
* the relaxed-rigid policy gradient and hardware-parameter gradient: the
  same two on the relaxed-rigid humanoid (8 PCG iterations a step) from the
  relaxed-rigid main path's start, K3-rr forward and K4-rr backward;
* APG training, ``examples/train_apg.py``'s configuration uncut: the garpez
  chain, 1024 envs, a tanh MLP with H = 32 through 30-step windows, Adam,
  the running state advanced with gradients off; three windows;
* the relaxed-rigid rollout, bench.py's ``relaxed_rigid`` uncut: the humanoid
  with ``RelaxedRigidContacts()`` and its default parameters, flat ground,
  semi-implicit Euler, the PD policy, 8192 envs, four chained 400-step K1
  launches (8 PCG iterations a step);
* BASELINE config 5, bench.py's ``relaxed_rigid_rk4`` uncut: the relaxed-rigid
  humanoid with RK4, flat ground, the PD policy, 8192 envs, four chained
  200-step K1 launches (8 PCG iterations a stage);
* the soft RK4 rollout at the flagship's settings: four chained K1 launches
  of ``SOFT_RK4_HORIZON`` steps;
* RK4-fast, soft and relaxed-rigid, one K1 launch each at the two RK4 main
  paths' shapes (timing only);
* the FMA-rate probes: K6's float32 peak, which is K7's float32 rate (one
  sweep, its launches counted as both), and K7's two bf16 rates, each the
  best of a sweep over chains per thread and blocks per SM, with its share
  of the data-sheet peak; the bounds then give every operations-bound
  kernel's share of the measured peak beside its share of the data sheet's.

It prints each build's ptxas line; the soft K1's, K5's, K2's and K3's
(``step.cu``, on the humanoid and on garpez), K4's and the relaxed-rigid
kernels' (K1-rr, K2-rr and K3-rr, K5-rr, K4-rr) launch geometry (threads, envs and shared memory a block, blocks or
envs an SM, waves) and the local loads and stores in their SASS (K1's, K5's
and ``step.cu``'s in the lane step's passes, K4's in the forward and the
reverse sweep, the relaxed-rigid kernels' in the M⁻¹Jᵀ pass); the
kernel-only times of K2, K3 (also on garpez at the APG start), K2-rr, K3-rr,
K4, K4-rr, the partials' sums and ``torch.sum``
beside it (``torch.profiler``). It prints each phase's seconds, the card's name and
power limit, a JSON line
with each kernel's numbers (device ms per launch, the plain version's ms for
the same work, the bound the card's peaks set, the launches of the main
path) and last ``{"ok": true, "device": {...}}``. Any failure raises, and the
script then exits non-zero without that line; it also exits non-zero when no
CUDA device is visible.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

DEVICE = "cuda:0"
BATCH = 8192
HORIZON = 1000  # steps per K1 main-path call
TIMED_CALLS = 5
# torch.profiler at times leaves out the records of some short launches
# of a window (``chip_probe.py profiler`` counts them); a kernel-only time
# is read from a window that saw every launch.
PROFILER_PAD_S = 0.02
PROFILER_TRIES = 5
# The plain twin takes 50-110 ms a humanoid step on the card (thousands of
# small launches); its time is taken over fewer steps than the kernel's
# launch and scaled to the same work, linearly in the steps.
PLAIN_TIMED_STEPS = dict(rollout=100, step_pd=10, step_tau=10, env_rollout=20, step_vjp=3, rollout_relaxed_rigid=20,
                         rollout_rk4=10, rollout_rk4fast=10, rollout_relaxed_rigid_rk4=5,
                         rollout_relaxed_rigid_rk4fast=5, step_pd_relaxed_rigid=3, step_tau_relaxed_rigid=3,
                         env_rollout_relaxed_rigid=5, step_vjp_relaxed_rigid=3)  # fmt: skip
PER_STEP_LAUNCHES = 100  # K2 main path
ENV_STEPS = 20  # BatchedEnv.step main path
# ES main path: examples/train_es_mlp.py uncut.
ES = dict(candidates=8, envs_per=1024, hidden=16, steps=500, generations=3, sigma=0.05, lr=0.03)
ES_OPTIONS = dict(episode_length=400, healthy_z_range=(0.6, 1.2), tau_limit=100.0)
# Kernel vs plain: the limit on |Δ| in every state field (s, sd, p, q, v,
# m) and in the reward sums, taken per env as the largest entry, then over
# the envs by the case's statistic (below).
TOL = 1e-3
# (start state, steps, statistic over envs). From rest every env is held at
# its max. With the joints moving, float32 rounding alone sends a few envs of
# 8192 far apart by 100 steps (the float32 and float64 plain versions differ
# there by up to 1.9e-2 in ṡ): that start is held at its max after 10 steps,
# and at the 99.9th percentile over envs after 100. The spinning box (no
# joints) starts BOX_SPIN["height"] up, turning at BOX_SPIN["rate"] about a
# random axis: in the air only the base's gyroscopic terms and its
# quaternion integration act, so float32 rounding stays far below TOL while
# a step that does not renormalise q moves q past it in 100 steps; the
# humanoid's starts, spinning or not, see that fault below float32's own
# spread or TOL (``chip_probe.py quat`` measures both).
CASES = (
    ("pendulum1", 100, "max"),
    ("humanoid23 main-path start", 100, "max"),
    ("humanoid23 joints moving", 10, "max"),
    ("humanoid23 joints moving", 100, "p99.9"),
    ("box spinning in the air", 100, "max"),
)
BOX_SPIN = dict(batch=1024, height=1.0, rate=10.0)  # m, rad/s
# K2's and K3's ragged case: CASES' joints-moving humanoid without its last
# STEP_RAGGED envs, 10 steps, held at its max, so that the last block of the
# one-step kernels runs envs past the batch (every other case's batch is a
# multiple of the envs a block), which must store nothing.
STEP_RAGGED = 7
# K4 vs plain: (start state, statistic over envs) for every output cotangent
# (``vjp_cotangents``); each env's largest |Δ| of a cotangent field over
# max(1, max |plain field|) is held to TOL. With the joints moving, a few
# humanoid envs sit near a contact's stick/slip boundary, where one float32
# rounding can send kernel and plain down different branches: that start is
# held at the 99.9th percentile over envs. Garpez is held where the APG main
# path starts, under the APG policy's torques, and in contact: RR_GARPEZ's
# tilted-low start (two corners penetrating) as soft contacts, under the same
# torques. With the model arrays' cotangents K4 is held in VJP_PARAMS_CASES,
# for the six output cotangents together.
VJP_CASES = (
    ("pendulum1", "max"),
    ("humanoid23 main-path start", "max"),
    ("humanoid23 joints moving", "p99.9"),
    ("garpez APG start", "max"),
    ("garpez tilted low, in contact", "max"),
)
VJP_PARAMS_CASES = ("humanoid23 main-path start", "humanoid23 joints moving", "garpez tilted low, in contact")
# The model arrays' batch-summed cotangents: the tolerance of the JAX
# package's own test of them (tests/test_batched_engine.py:779-785), each
# entry within PARAMS_RTOL·|plain| + PARAMS_ATOL·max(1, max |plain array|);
# and each entry above that absolute part within PARAMS_RTOL·|plain|, since
# an absolute part scaled by the array's largest entry passes a dropped term
# that reaches only its small entries (a seeded fault that left entries of
# S's cotangent 2.4 % off reached 6 % of the first limit).
PARAMS_RTOL, PARAMS_ATOL = 5e-3, 5e-4
# K1's relaxed-rigid build vs plain: (start state, steps, statistic over
# envs, held against float64), as CASES; m holds the solved point forces in
# newtons and is held relative to max(1, max |plain m|). With the joints
# moving, float32 rounding alone carries relaxed-rigid envs apart: a point
# at δ ≈ 0 switches its constraint on in one version and not in the other,
# and 8 CG iterations pass on the difference. Two such starts: ṡ =
# 0.5·N(0, 1) rad/s from the standing pose, and CASES' start (joints
# displaced 0.3·N(0, 1) rad as well). On an H100 the float32 and float64
# twins differ at the first by 2.1e-2 in ṡ after 10 steps (max over 8192
# envs) and by 5.9e-2 at p99.9 after 100 steps (this script prints both).
# Those cases hold the kernel against the float64 twin, each field within
# max(TOL, 2 × the float32 twin's own distance to it) at the case's
# statistic. Garpez starts tilted low (base
# 0.015 m up, turned 0.2 rad about x, joints 0.05·N(0, 1) rad) so that two
# corners penetrate from step 0, under tau = -20·s - 0.1·ṡ, the set-up of the
# JAX package's relaxed-rigid garpez test (tests/test_batched_engine.py:991-1013).
# The touchdown case drops the humanoid from RR_TOUCHDOWN's base height (3 cm
# above the standing pose), so its feet strike the ground from a cold start
# about 75 steps in. At the main path's 8 PCG iterations the solve has
# converged below float32's own spread there (the float64 twin at 7 against
# 8 iterations: 0.03 of this case's limit on the CPU), so no case at 8 can
# see one iteration fewer; this one runs the same kernel source built with 3
# iterations, where each iteration still moves the state (2 against 3: 282
# times the limit, in ṡ). The ragged case is garpez's start without its last
# STEP_RAGGED envs, so that the last block of every relaxed-rigid kernel runs
# envs past the batch, which must store nothing. The relaxed-rigid one-step
# kernels K2-rr (K1-rr launched for one step) and K3-rr are held beside K1-rr
# on every case of a semi-implicit Euler engine, chained one launch a step,
# against the same plain trajectories. K3's torques, computed between
# launches, are the PD law's rounded as the kernels' PD law is
# (pd_tau_as_kernels), so that K3-rr takes the float32 rounding path of K1-rr
# and is held to the same limits; rr_k3_witness counts the envs in which one
# K3-rr step from each start equals K2-rr's to the bit. A fault of K3's own
# torque path moves every start's 10-step state by tens of times the limit
# (chip_probe.py rr_step_faults).
RR_CASES = (
    ("humanoid23 relaxed-rigid main-path start", 100, "max", False),
    ("humanoid23 relaxed-rigid joints moving", 10, "max", True),
    ("humanoid23 relaxed-rigid joints moving", 100, "p99.9", True),
    ("humanoid23 relaxed-rigid joints displaced and moving", 10, "max", True),
    ("humanoid23 relaxed-rigid joints displaced and moving", 100, "p99.9", True),
    ("garpez relaxed-rigid tilted low", 100, "max", False),
    ("humanoid23 relaxed-rigid touchdown, 3 PCG iterations", 100, "max", True),
    ("garpez relaxed-rigid tilted low, ragged batch", 10, "max", False),
)
RR_TOUCHDOWN = dict(batch=1024, base=(0.0, 0.0, 0.93), iterations=3)
# K1's RK4 and RK4-fast builds vs plain: CASES' and RR_CASES' starts, the
# same statistics and limits, over shorter horizons, since an RK4 step of the
# plain twin is four of its derivatives (a soft humanoid step about 0.3 s on
# the card, a relaxed-rigid one about 0.9 s). The relaxed-rigid touchdown
# start is left out: its feet strike about 75 steps in, and a relaxed-rigid
# RK4 twin there would take minutes. The soft humanoid drops from
# RR_TOUCHDOWN's base (``SOFT_TOUCHDOWN``, its own seed) over 100 steps, held
# at its max as the relaxed-rigid touchdown and CASES' main-path start are:
# its points engage from about 55 steps in (over a thousand of 48 × 1024 by
# step 90), so that the stage update of m is held while they do; in the air
# the joints rest, and the float32 and float64 twins stay 3e-5 apart in ṡ
# by step 90 (on the CPU).
RK4_CASES = (
    ("pendulum1", 100, "max"),
    ("humanoid23 main-path start", 25, "max"),
    ("humanoid23 joints moving", 10, "max"),
    ("humanoid23 joints moving", 25, "p99.9"),
    ("box spinning in the air", 100, "max"),
    ("humanoid23 touchdown", 100, "max"),
)
SOFT_TOUCHDOWN = dict(batch=1024, base=(0.0, 0.0, 0.93), seed=7)
RR_RK4_CASES = (
    ("humanoid23 relaxed-rigid main-path start", 20, "max", False),
    ("humanoid23 relaxed-rigid joints moving", 10, "max", True),
    ("humanoid23 relaxed-rigid joints displaced and moving", 10, "max", True),
    ("garpez relaxed-rigid tilted low", 25, "max", False),
)
RK4_INTEGRATORS = ("rk4", "rk4fast")
# BASELINE config 5: bench.py's relaxed_rigid_rk4 (bench.py:363-382) uncut.
RR_RK4_HORIZON = 200  # steps per K1 launch
RK4_TIMED_CALLS = 3
# The soft RK4 main path: the flagship's settings, steps a K1 launch chosen
# so that a launch takes under 1 s.
SOFT_RK4_HORIZON = 2000
RR_JOINT_SPEED = 0.5  # rad/s, the moving start's ṡ scale
# K3-rr under call-time model arrays: RR_CASES' garpez start, M scaled and
# rrMinv (its points' inverse mass blocks) scaled back, 10 steps.
RR_PR = dict(M=1.2, rrMinv=1 / 1.2, steps=10)
# K5-rr vs plain (rr_env_gates): (case, steps, options), each held at the max
# over envs, resets and steps equal in every env, every field and the reward
# sums within TOL (m relative to max(1, max |plain m|)):
# * the ES main path's shapes, policy and options, from the relaxed-rigid
#   main path's start advanced 20 steps by K1-rr (m the solved forces),
#   episodes of 4, so that 6 steps end two steps after a respawn;
# * the touchdown start (RR_TOUCHDOWN's base, the main path's 8 iterations)
#   under the linear policy written as the PD law, episodes of 40 over 80
#   steps: each episode respawns before the feet strike (about 75 steps in),
#   so no point touches the ground and the case holds the reward at a
#   respawn, not the solve: the base falls about 8 mm in an episode, so a
#   reward read after the respawn moves the sums ~8 TOL an episode;
# * garpez tilted low with m seeded 2·N(0, 1) (not the solved forces) under
#   its PD law, with reset noise, 12 steps of episodes of 4: the last step
#   respawns, and m must be the start's.
# The third entry says whether the case holds the contact solve: such a case
# fails if no point of its plain trajectory's start or end is in contact.
RR_ENV_CASES = (
    ("humanoid23 relaxed-rigid, ES shapes, episodes of 4", 6, True,
     dict(episode_length=4, healthy_z_range=(-1e6, 1e6), tau_limit=100.0)),
    ("humanoid23 relaxed-rigid in the air, linear PD, episodes of 40: the reward at a respawn", 80, False,
     dict(episode_length=40, healthy_z_range=(-1e6, 1e6))),
    ("garpez relaxed-rigid tilted low, m seeded, reset noise, episodes of 4", 12, True,
     dict(episode_length=4, healthy_z_range=(-1e6, 1e6), reset_noise=0.02, seed=9, kp=20.0, kd=0.1)),
)  # fmt: skip
RR_GARPEZ = dict(batch=1024, base=(0.0, 0.0, 0.015), quat=(0.995, 0.0998, 0.0, 0.0), joints=0.05, gains=(20.0, 0.1))
# K4-rr vs plain (rr_vjp_gates): (start, statistic over envs), each with
# seeded N(0, 1) output cotangents on all six leaves at once (m's share of
# x-bar reaches lambda at 1/reg through the inactive points, whose lambda then
# enters the backward PCG's dot products), without and with the model
# arrays' cotangents (rrMinv's too). Each cotangent field's per-env |Δ| over
# max(1, max |plain field|) is held to TOL at the case's statistic, the
# model arrays by params_shares. Where float32 alone breaches that (the
# float32 twin against the float64 one), the field is held against the
# float64 twin within max(TOL, 2 × the float32 twin's own distance), as
# RR_CASES are: on an H100 the float32 twin is 8-11 times the model arrays'
# limit from the float64 one at the main path's start (S's and M's batch sums
# cancel), and with the joints displaced as well as moving tens of times the
# state's (that start is left out: float32 there gates nothing). The
# cases: JAX's own (tests/test_batched_engine.py:561-590: garpez tilted low,
# B = 1024, 8 PCG iterations, tau = 0.1·N(0, 1)); the relaxed-rigid main
# path's start under its PD torques; the joints moving (p99.9); garpez built
# with RR_VJP_ITERATIONS PCG iterations, where the forward's and the
# backward's iteration counts both move the cotangents; and garpez's ragged
# batch. A case fails if its start has no point in contact.
RR_VJP_CASES = (
    ("garpez relaxed-rigid tilted low", "max"),
    ("humanoid23 relaxed-rigid main-path start", "max"),
    ("humanoid23 relaxed-rigid joints moving", "p99.9"),
    ("garpez relaxed-rigid tilted low, 3 PCG iterations", "max"),
    ("garpez relaxed-rigid tilted low, ragged batch", "max"),
)
RR_VJP_ITERATIONS = 3
# Relaxed-rigid main path: bench.py's relaxed_rigid (bench.py:338-361) uncut.
RR_HORIZON = 400  # steps per K1 launch
RR_TIMED_CALLS = 3
RR_ITERATIONS = 8  # _rr_n_iter of the humanoid's 48 points
# K6/K7 vs plain: T of the comparison, and the limit in units in the last
# place (the plain version rounds each fused step twice, through float64,
# the kernel once; the two differ only at a tie after the first rounding).
# The comparison runs at fma_probe.GATE_K and GATE_E, where the plain
# output moves with every trip of the kernel's loop.
PROBE_GATE_T, PROBE_ULPS = 64, 1
# Gradient main paths: bench.py's gradient path uncut (BASELINE config 4).
GRAD = dict(steps=100, gains=(60.0, 0.5), timed=3, check_steps=10, check_rtol=1e-3)
# APG main path: examples/train_apg.py uncut, three windows.
APG = dict(batch=1024, horizon=30, hidden=32, windows=3, lr=3e-3, target=(0.4, -0.6, 0.3, -0.2))
# m, the healthy range of the K5 real-terminations case: from the joints-
# moving start, under the stable policy of that case, most envs sink below
# 0.87 m within 100 steps, so episodes end by height. A policy that leaves
# (0.6, 1.2) m as fast is chaotic enough that rounding alone moves when
# episodes end: there the float32 and float64 plain versions disagree on the
# step counts of many envs (``chip_probe.py terminations``).
TERMINATION_Z = (0.87, 1.2)
# m, plausible base heights after the main path: a humanoid that fell lies
# with the pelvis centre about its smallest half-extent (0.075 m) above the
# ground; lower means it sank through the floor, higher that it flew off.
HEIGHT_BAND = (0.05, 1.2)
# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): float32 outside
# the tensor cores, and device memory.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Envs of a main path's state over which the operations of an env-step are
# counted and averaged (the count depends on the data: which contact points
# touch the ground, which entries are zero).
COUNT_ENVS = 32
REPLACES = dict(
    rollout="jaxsim_tpu/ops/pallas_step.py:664",
    step_pd="jaxsim_tpu/ops/pallas_step.py:86",
    step_tau="jaxsim_tpu/ops/pallas_step.py:178",
    env_rollout="jaxsim_tpu/ops/pallas_step.py:787",
    step_vjp="jaxsim_tpu/ops/pallas_step.py:262",
    step_vjp_params_grad="jaxsim_tpu/ops/pallas_step.py:262",
    # The partials' sum replaces the kernel's accumulation across grid steps.
    param_sum="jaxsim_tpu/ops/pallas_step.py:306",
    rollout_relaxed_rigid="jaxsim_tpu/ops/pallas_step.py:664",
    rollout_rk4="jaxsim_tpu/ops/pallas_step.py:664",
    rollout_rk4fast="jaxsim_tpu/ops/pallas_step.py:664",
    rollout_relaxed_rigid_rk4="jaxsim_tpu/ops/pallas_step.py:664",
    rollout_relaxed_rigid_rk4fast="jaxsim_tpu/ops/pallas_step.py:664",
    step_pd_relaxed_rigid="jaxsim_tpu/ops/pallas_step.py:86",
    step_tau_relaxed_rigid="jaxsim_tpu/ops/pallas_step.py:178",
    env_rollout_relaxed_rigid="jaxsim_tpu/ops/pallas_step.py:787",
    step_vjp_relaxed_rigid="jaxsim_tpu/ops/pallas_step.py:262",
    step_vjp_relaxed_rigid_params_grad="jaxsim_tpu/ops/pallas_step.py:262",
    param_sum_relaxed_rigid="jaxsim_tpu/ops/pallas_step.py:306",
    fma_probe="bench.py:716",
    bf16_probe_f32="scripts/bf16_probe.py:36",
    bf16_probe_bf16="scripts/bf16_probe.py:36",
    bf16_probe_bf16_store="scripts/bf16_probe.py:36",
)
SOURCES = dict(
    rollout="jaxsim_tpu_torch/csrc/rollout.cu",
    step_pd="jaxsim_tpu_torch/csrc/step.cu",
    step_tau="jaxsim_tpu_torch/csrc/step.cu",
    env_rollout="jaxsim_tpu_torch/csrc/env_rollout.cu",
    step_vjp="jaxsim_tpu_torch/csrc/step_vjp.cu",
    step_vjp_params_grad="jaxsim_tpu_torch/csrc/step_vjp.cu",
    param_sum="jaxsim_tpu_torch/csrc/param_sum.cuh",
    rollout_relaxed_rigid="jaxsim_tpu_torch/csrc/rollout_rr.cu",
    rollout_rk4="jaxsim_tpu_torch/csrc/rollout.cu",
    rollout_rk4fast="jaxsim_tpu_torch/csrc/rollout.cu",
    rollout_relaxed_rigid_rk4="jaxsim_tpu_torch/csrc/rollout_rr.cu",
    rollout_relaxed_rigid_rk4fast="jaxsim_tpu_torch/csrc/rollout_rr.cu",
    step_pd_relaxed_rigid="jaxsim_tpu_torch/csrc/rollout_rr.cu",
    step_tau_relaxed_rigid="jaxsim_tpu_torch/csrc/step_rr.cu",
    env_rollout_relaxed_rigid="jaxsim_tpu_torch/csrc/env_rollout_rr.cu",
    step_vjp_relaxed_rigid="jaxsim_tpu_torch/csrc/step_vjp_rr.cu",
    step_vjp_relaxed_rigid_params_grad="jaxsim_tpu_torch/csrc/step_vjp_rr.cu",
    param_sum_relaxed_rigid="jaxsim_tpu_torch/csrc/param_sum.cuh",
    fma_probe="jaxsim_tpu_torch/csrc/fma_probe.cu",
    bf16_probe_f32="jaxsim_tpu_torch/csrc/fma_probe.cu",
    bf16_probe_bf16="jaxsim_tpu_torch/csrc/fma_probe.cu",
    bf16_probe_bf16_store="jaxsim_tpu_torch/csrc/fma_probe.cu",
)


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def integrator_type(integrator: str):
    """The port's IntegratorType member of an engine's integrator name."""
    from jaxsim_tpu_torch.api.model import IntegratorType

    return dict(sie=IntegratorType.SemiImplicitEuler, rk4=IntegratorType.RungeKutta4,
                rk4fast=IntegratorType.RungeKutta4Fast)[integrator]  # fmt: skip


def with_integrator(engine, integrator: str):
    """A copy of ``engine`` with another integrator (its arrays copied)."""
    import copy

    out = copy.deepcopy(engine)
    out.integrator = integrator
    return out


def humanoid_engine(device, integrator="sie"):
    """The flagship model, lowered as bench.py lowers it."""
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, models
    from jaxsim_tpu_torch.api.contact import estimate_good_contact_parameters

    model = JaxSimModel.build_from_model_description(models.build_humanoid_urdf(),
                                                     integrator=integrator_type(integrator))  # fmt: skip
    params = estimate_good_contact_parameters(
        model,
        number_of_active_collidable_points_steady_state=8,
        max_penetration=0.006,
        damping_ratio=0.15,
    )
    return BatchedEngine.build(model.replace(contact_params=params), device=device)


def rr_humanoid_engine(device, integrator="sie"):
    """bench.py's relaxed-rigid model: the humanoid with
    ``RelaxedRigidContacts()`` and the default parameters (μ = 0.005); with
    ``integrator="rk4"`` BASELINE config 5 (bench.py's relaxed_rigid_rk4)."""
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, models
    from jaxsim_tpu_torch.ops.contacts.relaxed_rigid import RelaxedRigidContacts

    model = JaxSimModel.build_from_model_description(models.build_humanoid_urdf(), contact_model=RelaxedRigidContacts(),
                                                     integrator=integrator_type(integrator))  # fmt: skip
    return BatchedEngine.build(model, device=device)


def rr_garpez_engine(device, integrator="sie"):
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, models
    from jaxsim_tpu_torch.ops.contacts.relaxed_rigid import RelaxedRigidContacts

    model = JaxSimModel.build_from_model_description(models.build_garpez_urdf(), contact_model=RelaxedRigidContacts(),
                                                     integrator=integrator_type(integrator))  # fmt: skip
    return BatchedEngine.build(model, device=device)


def pendulum_engine(device):
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, models

    return BatchedEngine.build(
        JaxSimModel.build_from_model_description(models.build_pendulum_urdf(1)), device=device
    )


def box_engine(device):
    """A free box with soft contacts at its 8 corners and no joints."""
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, models

    return BatchedEngine.build(JaxSimModel.build_from_model_description(models.build_box_urdf()), device=device)


def per_env_abs_diff(a, b) -> dict:
    """|Δ| per field and env: the largest entry of each env's slice."""
    return {
        k: (x - y).abs().reshape(-1, x.shape[-1]).amax(0)
        for k, x, y in zip("s sd p q v m".split(), a.fields(), b.fields())
        if x.numel()
    }


def all_finite(state) -> bool:
    import torch

    return all(bool(torch.isfinite(t).all()) for t in state.fields())


def over_envs(diff: dict, stat: str) -> dict[str, float]:
    """``stat`` (max or p99.9) over envs of each entry's per-env |Δ|."""
    import torch

    if stat == "max":
        return {k: float(d.max()) for k, d in diff.items()}
    return {k: float(torch.quantile(d.double(), 0.999)) for k, d in diff.items()}


def gate(name: str, diff: dict, stat: str, limits: dict | None = None) -> float:
    """Fails when ``stat`` (max or p99.9 over envs) of any entry's per-env
    |Δ| exceeds its limit (TOL unless ``limits`` names one); returns the
    largest max |Δ| over the entries."""
    err, p999 = over_envs(diff, "max"), over_envs(diff, "p99.9")
    print(f"{name}: max |Δ| {json.dumps(err)}, p99.9 over envs {json.dumps(p999)}", flush=True)
    gated = err if stat == "max" else p999
    limits = limits or {}
    bad = {k: e for k, e in gated.items() if not e <= limits.get(k, TOL)}
    if bad:
        raise RuntimeError(f"{name}: kernel disagrees with plain beyond {limits or TOL} ({stat}): {bad}")
    return max(err.values())


def compare_states(name, kern, plain, stat) -> float:
    if not (all_finite(kern) and all_finite(plain)):
        raise RuntimeError(f"{name}: non-finite state")
    return gate(name, per_env_abs_diff(kern, plain), stat)


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
    moving = moving_joints(state0, gen)
    box = box_engine(device)
    spin = box.init_state(BOX_SPIN["batch"], base_position=(0.0, 0.0, BOX_SPIN["height"]), generator=gen)
    spin.v[3:6] = BOX_SPIN["rate"] / 3**0.5 * torch.randn((3, BOX_SPIN["batch"]), generator=gen, device=device)
    touchdown = hum.init_state(SOFT_TOUCHDOWN["batch"], base_position=SOFT_TOUCHDOWN["base"],
                               generator=torch.Generator(device).manual_seed(SOFT_TOUCHDOWN["seed"]))  # fmt: skip
    return {
        "pendulum1": (pend, pend_state),
        "humanoid23 main-path start": (hum, state0),
        "humanoid23 joints moving": (hum, moving),
        "box spinning in the air": (box, spin),
        "humanoid23 touchdown": (hum, touchdown),
    }


def counters() -> dict[str, int]:
    from jaxsim_tpu_torch.ops import cuda_env_rollout, cuda_rollout, cuda_step, cuda_step_vjp, fma_probe

    return dict(
        rollout=cuda_rollout.ROLLOUT_KERNEL_LAUNCHES,
        step_pd=cuda_step.STEP_PD_KERNEL_LAUNCHES,
        step_tau=cuda_step.STEP_TAU_KERNEL_LAUNCHES,
        env_rollout=cuda_env_rollout.ENV_ROLLOUT_KERNEL_LAUNCHES,
        step_vjp=cuda_step_vjp.STEP_VJP_KERNEL_LAUNCHES,
        param_sum=cuda_step_vjp.PARAM_SUM_KERNEL_LAUNCHES,
        step_vjp_relaxed_rigid=cuda_step_vjp.STEP_VJP_RR_KERNEL_LAUNCHES,
        param_sum_relaxed_rigid=cuda_step_vjp.PARAM_SUM_RR_KERNEL_LAUNCHES,
        rollout_relaxed_rigid=cuda_rollout.ROLLOUT_RR_KERNEL_LAUNCHES,
        step_pd_relaxed_rigid=cuda_step.STEP_PD_RR_KERNEL_LAUNCHES,
        step_tau_relaxed_rigid=cuda_step.STEP_TAU_RR_KERNEL_LAUNCHES,
        env_rollout_relaxed_rigid=cuda_env_rollout.ENV_ROLLOUT_RR_KERNEL_LAUNCHES,
        fma_probe=fma_probe.FMA_PROBE_LAUNCHES,
        **{f"bf16_probe_{v}": n for v, n in fma_probe.BF16_PROBE_LAUNCHES.items()},
    )


def zero_counters() -> None:
    from jaxsim_tpu_torch.ops import cuda_env_rollout, cuda_rollout, cuda_step, cuda_step_vjp, fma_probe

    cuda_rollout.ROLLOUT_KERNEL_LAUNCHES = 0
    cuda_rollout.ROLLOUT_RR_KERNEL_LAUNCHES = 0
    cuda_step.STEP_PD_KERNEL_LAUNCHES = 0
    cuda_step.STEP_TAU_KERNEL_LAUNCHES = 0
    cuda_step.STEP_PD_RR_KERNEL_LAUNCHES = 0
    cuda_step.STEP_TAU_RR_KERNEL_LAUNCHES = 0
    cuda_env_rollout.ENV_ROLLOUT_KERNEL_LAUNCHES = 0
    cuda_env_rollout.ENV_ROLLOUT_RR_KERNEL_LAUNCHES = 0
    cuda_step_vjp.STEP_VJP_KERNEL_LAUNCHES = 0
    cuda_step_vjp.PARAM_SUM_KERNEL_LAUNCHES = 0
    cuda_step_vjp.STEP_VJP_RR_KERNEL_LAUNCHES = 0
    cuda_step_vjp.PARAM_SUM_RR_KERNEL_LAUNCHES = 0
    fma_probe.FMA_PROBE_LAUNCHES = 0
    fma_probe.BF16_PROBE_LAUNCHES.update(dict.fromkeys(fma_probe.VARIANTS, 0))


def main_path(name: str, expect: dict[str, int], drive):
    """Run ``drive()`` with every launch counter set to 0 just before it;
    fail unless the counts read just after are ``expect`` (0 elsewhere)."""
    zero_counters()
    out = drive()
    got = counters()
    want = {k: expect.get(k, 0) for k in got}
    print(f"main path {name}: launches {json.dumps(got)}", flush=True)
    if got != want:
        raise RuntimeError(f"main path {name} launched {got}, expected {want}")
    return out, got


def device_ms(fn, repeats: int) -> list[float]:
    """CUDA-event milliseconds of each of ``repeats`` calls of ``fn``."""
    import torch

    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def profiled_window(fn, kernel: str, repeats: int, pad_s: float = PROFILER_PAD_S) -> list[tuple[float, float]]:
    """One ``torch.profiler`` window around ``repeats`` calls of ``fn``, with
    ``pad_s`` idle host seconds inside it before the first call and after
    the last: (start µs from the window's start, device µs) of each CUDA
    kernel whose name holds ``kernel``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(pad_s)
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return [
        (e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name
    ]  # fmt: skip


def profiled_ms(fn, kernel: str, repeats: int) -> float:
    """Device milliseconds a call of the CUDA kernel whose name holds
    ``kernel``, one launch a call, over ``repeats`` calls of ``fn``, read by
    ``torch.profiler`` from the first of ``PROFILER_TRIES`` windows that saw
    every launch."""
    for _ in range(PROFILER_TRIES):
        seen = profiled_window(fn, kernel, repeats)
        if len(seen) > repeats:
            raise RuntimeError(f"the profiler saw {len(seen)} launches of {kernel!r}, expected {repeats}")
        if len(seen) == repeats:
            return sum(t for _, t in seen) / repeats / 1e3
        print(f"the profiler saw {len(seen)} of {repeats} launches of {kernel!r}; another window", flush=True)
    raise RuntimeError(f"the profiler missed launches of {kernel!r} in {PROFILER_TRIES} windows")


def chained(engine, start, horizon: int, calls: int):
    """K1 from ``start``: a warm-up launch, then ``calls`` chained launches
    of ``horizon`` steps, each timed by wall clock and CUDA events and ended
    by a synchronize: the last state and ``[(wall s, device ms), ...]``."""
    import torch

    from jaxsim_tpu_torch.ops import cuda_rollout

    out = cuda_rollout.rollout(engine, start, horizon)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start_ev.record()
        out = cuda_rollout.rollout(engine, out, horizon)
        end_ev.record()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0, start_ev.elapsed_time(end_ev)))
    return out, times


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take for the work, and what binds."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def state_bytes(engine, B: int) -> int:
    return 4 * B * (2 * engine.n_joints + 3 + 4 + 6 + 3 * engine.m_rows)


def cpu_head(state):
    """Envs 0..COUNT_ENVS of a state (or of a cotangent of one), on the CPU."""
    from jaxsim_tpu_torch.ops import flop_count

    return flop_count.head(type(state)(*(t.cpu() for t in state.fields())), COUNT_ENVS + 1)


def ops_per_env_step(engine, step_state, env_state, policy_weights, **options) -> dict[str, float]:
    """Floating-point operations one env-step needs (see
    ``jaxsim_tpu_torch.ops.flop_count``), counted on a CPU copy of the engine
    at the run's own data, envs 1..COUNT_ENVS of a main path's state: the
    step under the PD policy at ``step_state``; the env rollout's step, with
    its policy, reward and reset selection, at ``env_state``; and, for
    reference, the step with generic model arrays in place of the
    humanoid's, which keeps only the algebra's own zeros."""
    from jaxsim_tpu_torch.ops import cuda_env_rollout, cuda_step, flop_count

    step_state, env_state = cpu_head(step_state), cpu_head(env_state)
    generic = flop_count.generic_arrays(engine)
    return dict(
        step=flop_count.least_step_ops(engine, lambda st: cuda_step.step_pd_reference(engine, st), step_state),
        env_step=flop_count.least_step_ops(engine, lambda st: cuda_env_rollout.env_rollout_reference(
            engine, st, 1, **policy_weights, **options), env_state),
        step_generic_model=flop_count.least_step_ops(engine, lambda st: cuda_step.step_tau_reference(
            engine, st, -60.0 * st.s - 0.5 * st.sd, generic), step_state, pr=generic),
    )  # fmt: skip


def es_sizes(n: int, d: int) -> list[int]:
    """Sizes of an MLP candidate's W1, b1, W2, b2, flattened in that order."""
    H = ES["hidden"]
    return [H * d, H, n * H, n]


def es_population(theta_mu, gen, n: int, d: int):
    """ES candidates around the mean ``theta_mu``, as examples/train_es_mlp.py
    samples them: antithetic perturbations ``theta_mu ± sigma·eps``, returned
    with the weights (a leading population axis, one candidate per 1024-env
    slice)."""
    import torch

    H, P = ES["hidden"], ES["candidates"]
    eps = torch.randn(P // 2, theta_mu.numel(), generator=gen, device=theta_mu.device)
    eps = torch.cat([eps, -eps])
    parts = torch.split(theta_mu[None] + ES["sigma"] * eps, es_sizes(n, d), dim=1)
    shapes = ((H, d), (H, 1), (n, H), (n, 1))
    return eps, {k: t.reshape(P, *s).contiguous() for k, t, s in zip(("W1", "b1", "W2", "b2"), parts, shapes)}


def garpez_engine(device):
    from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, models

    return BatchedEngine.build(JaxSimModel.build_from_model_description(models.build_garpez_urdf()), device=device)


def contact_branches(engine, state) -> tuple[int, int, int]:
    """Contact points of ``state`` (over all envs) out of contact, sticking
    and slipping, by the twin's contact law on flat ground."""
    import torch

    if not engine.n_points:
        return 0, 0, 0
    eps = torch.finfo(torch.float32).eps
    W_R, W_p, W_v = engine.fk(state)
    par = engine.contact_parent
    R, p, v = (torch.stack([W[i] for i in par], -2) for W in (W_R, W_p, W_v))  # (..., nC, B)
    pc = (R * engine.cpoint.transpose(0, 1)[None, :, :, None]).sum(1) + p
    pd = v[:3] + torch.linalg.cross(v[3:], pc, dim=0)
    delta = torch.clamp(-pc[2], min=0.0)
    dp, dq = (delta + eps) ** engine.hc_p, (delta + eps) ** engine.hc_q
    fn = torch.clamp(engine.K * dp * delta + engine.D * dq * torch.where(delta > 0, -pd[2], 0.0), min=0.0)
    m = state.m.transpose(0, 1)
    f_t = -(engine.K * dp * m[:2] + engine.D * dq * pd[:2])
    out = delta <= 0
    stick = ~out & ((f_t * f_t).sum(0) <= (engine.mu * fn) ** 2)
    return int(out.sum()), int(stick.sum()), int((~out & ~stick).sum())


def vjp_cotangents(state, gen) -> dict:
    """Seeded N(0, 1) output cotangents of one step: each state field alone
    (the others 0), then all six."""
    import torch

    from jaxsim_tpu_torch import BatchedState

    full = [torch.randn(t.shape, generator=gen, device=t.device) for t in state.fields()]
    out = {
        name: BatchedState(*(f if j == i else torch.zeros_like(f) for j, f in enumerate(full)))
        for i, name in enumerate("s sd p q v m".split())
        if full[i].numel()
    }
    out["all six"] = BatchedState(*full)
    return out


def vjp_diff(kern, plain) -> tuple[dict, float]:
    """Per env, each cotangent field's largest |Δ| over max(1, max |plain
    field|); and the largest |Δ| unscaled."""
    import torch

    scaled, raw = {}, 0.0
    for name, a, b in zip("s sd p q v m tau".split(), [*kern[0].fields(), kern[1]], [*plain[0].fields(), plain[1]]):
        if not b.numel():
            continue
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise RuntimeError(f"non-finite cotangent of {name}")
        d = (a - b).abs().reshape(-1, b.shape[-1]).amax(0)
        raw = max(raw, float(d.max()))
        scaled[name] = d / max(1.0, float(b.abs().max()))
    return scaled, raw


def params_shares(kern: dict, plain: dict, label: str | None = None) -> dict[str, float]:
    """Each model array's batch-summed cotangent entry by entry against
    PARAMS_RTOL·|plain| + PARAMS_ATOL·max(1, max |plain|), and the entries
    above that absolute part against PARAMS_RTOL·|plain|: each array's larger
    share of its limit (≤ 1 passes; non-finite is inf). With ``label`` it
    prints per array the largest |Δ| over the first limit and the largest
    relative error |Δ|/|plain| above the absolute part."""
    import torch

    ratios = {}
    for k, b in plain.items():
        a = kern[k]
        if not bool(torch.isfinite(a).all()):
            ratios[k] = math.inf
            continue
        atol = PARAMS_ATOL * max(1.0, float(b.abs().max()))
        d = (a - b).abs()
        share = float((d / (PARAMS_RTOL * b.abs() + atol)).max())
        big = b.abs() > atol
        rel = float((d[big] / b.abs()[big]).max()) if bool(big.any()) else 0.0
        ratios[k] = max(share, rel / PARAMS_RTOL)
        if label:
            print(f"{label}: ct {k} max|Δ| {float(d.max()):.6g}, max|plain| {float(b.abs().max()):.6g}, "
                  f"max |Δ|/limit {share:.6g}, max |Δ|/|plain| where |plain| > atol {rel:.6g}")  # fmt: skip
    return ratios


def params_gate(label: str, kern: dict, plain: dict) -> dict[str, float]:
    """:func:`params_shares`, printed; fails unless every array's is ≤ 1."""
    ratios = params_shares(kern, plain, label)
    bad = {k: r for k, r in ratios.items() if not r <= 1.0}
    if bad:
        raise RuntimeError(f"{label}: model-array cotangents beyond rtol {PARAMS_RTOL}, atol {PARAMS_ATOL}: {bad}")
    return ratios


def vjp_gates(starts, case_tau, gen, variants=None) -> tuple[dict[str, list[float]], dict[str, dict[str, float]]]:
    """K4 against its plain version: in each of VJP_CASES for each seeded
    output cotangent (``vjp_cotangents``), and with the model arrays'
    cotangents in each of VJP_PARAMS_CASES for the six together, every
    cotangent field's per-env |Δ| over max(1, max |plain field|) at the
    case's statistic over envs, held to TOL, and the model arrays' by
    ``params_shares``. ``variants`` maps a name to a function ``(engine,
    state, tau, ct, params_grad=...)`` returning as ``step_vjp`` (by default
    the wrapper, which is gated: a breach raises, and with params_grad two
    runs must agree to the bit); other variants (seeded faults) are held to
    the same limits without raising. Fails when the cases leave a contact
    branch without a point, or the in-contact case has no point in contact.
    Returns the largest unscaled |Δ| of each case held at its max (the
    default variant's, by kernel name), and for each variant and case its
    worst statistic over its limit (> 1 is refused)."""
    import torch

    from jaxsim_tpu_torch.ops import cuda_step_vjp

    gated = variants is None
    variants = variants or {"kernel": cuda_step_vjp.step_vjp}
    errs, ratios = {"step_vjp": [], "step_vjp_params_grad": []}, {name: {} for name in variants}
    branches = [0, 0, 0]
    cases = [(name, stat, False) for name, stat in VJP_CASES]
    cases += [(name, dict(VJP_CASES)[name], True) for name in VJP_PARAMS_CASES]
    for name, stat, pg in cases:
        engine, state = starts[name]
        tau = case_tau(name, state)
        cts = vjp_cotangents(state, gen)
        if pg:
            cts = {"all six": cts["all six"]}
        else:
            counts = contact_branches(engine, state)
            branches = [a + b for a, b in zip(branches, counts)]
            print(f"step_vjp {name}: contact points out of contact, sticking, slipping {counts}", flush=True)
            if "in contact" in name and not counts[1] + counts[2]:
                raise RuntimeError(f"{name}: no point in contact, so the case holds nothing of the contacts")
        kind = "step_vjp_params_grad" if pg else "step_vjp"
        for ct_name, ct in cts.items():
            plain = cuda_step_vjp.step_vjp_reference(engine, state, tau, ct, params_grad=pg)
            for vname, run in variants.items():
                kern = run(engine, state, tau, ct, params_grad=pg)
                torch.cuda.synchronize()
                label = (f"{kind} {vname} vs plain, {name} B={state.p.shape[-1]}, ct of {ct_name}, "
                         "|Δ|/max(1, max|plain|)")  # fmt: skip
                case = f"{name}, ct of {ct_name}" + (", params_grad" if pg else "")
                if not gated and not all(bool(torch.isfinite(t).all()) for t in [*kern[0].fields(), kern[1]]):
                    ratios[vname][case] = math.inf
                    print(f"{label}: non-finite, refused", flush=True)
                    continue
                scaled, raw = vjp_diff(kern, plain)
                ratio = max(over_envs(scaled, stat).values()) / TOL
                if pg:
                    ratio = max(ratio, *params_shares(kern[2], plain[2]).values())
                ratios[vname][case] = ratio
                if not gated:
                    print(f"{label}: worst statistic over its limit {ratio:.6g}", flush=True)
                    continue
                gate(label, scaled, stat)
                if pg:
                    params_gate(f"{kind} {name}", kern[2], plain[2])
                    raw = max(raw, *(float((kern[2][k] - plain[2][k]).abs().max()) for k in plain[2]))
                    again = run(engine, state, tau, ct, params_grad=pg)
                    if not all(torch.equal(x, y) for x, y in zip(vjp_leaves(kern), vjp_leaves(again))):
                        raise RuntimeError(f"two runs of step_vjp with params_grad differ, {name}")
                if stat == "max":
                    errs[kind].append(raw)
    if not all(branches):
        raise RuntimeError(f"the K4 start states leave a contact branch without a point: {branches}")
    return errs, ratios


def rr_vjp_garpez_engine(device):
    """Garpez's relaxed-rigid engine with RR_VJP_ITERATIONS PCG iterations."""
    engine = rr_garpez_engine(device)
    engine.rr_iterations = RR_VJP_ITERATIONS
    return engine


def rr_vjp_starts(rr_starts, garp_rr_few, gen) -> dict:
    """K4-rr's cases (RR_VJP_CASES) by name, (engine, state, tau), from
    :func:`rr_start_states`' starts: the humanoid's under the main path's PD
    torques, garpez's under 0.1·N(0, 1) torques (the JAX package's case),
    garpez tilted low also on ``garp_rr_few`` (:func:`rr_vjp_garpez_engine`)."""
    import torch

    few = f", {RR_VJP_ITERATIONS} PCG iterations"
    out = {}
    for name, _ in RR_VJP_CASES:
        engine, state, _ = rr_starts[name.replace(few, "")]
        if name.endswith(few):
            engine = garp_rr_few
        if name.startswith("garpez"):
            tau = 0.1 * torch.randn(state.s.shape, generator=gen, device=state.s.device)
        else:
            tau = -60.0 * state.s - 0.5 * state.sd
        out[name] = (engine, state, tau.contiguous())
    return out


def vjp_ratios(kern, plain, stat: str, params_grad: bool) -> tuple[dict[str, float], float]:
    """Each cotangent field's statistic over envs of its per-env |Δ| over
    max(1, max |plain field|), over TOL, and with ``params_grad`` each model
    array's :func:`params_shares` (> 1 breaches); and the largest |Δ|
    unscaled, the model arrays' included."""
    scaled, raw = vjp_diff(kern, plain)
    out = {k: v / TOL for k, v in over_envs(scaled, stat).items()}
    if params_grad:
        out.update({f"pr.{k}": r for k, r in params_shares(kern[2], plain[2]).items()})
        raw = max(raw, *(float((kern[2][k] - plain[2][k]).abs().max()) for k in plain[2]))
    return out, raw


def rr_vjp_gates(starts, gen, variants=None) -> tuple[dict[str, list[float]], dict[str, dict[str, float]]]:
    """K4-rr against its plain version on RR_VJP_CASES (``starts`` from
    :func:`rr_vjp_starts`), without and with the model arrays' cotangents,
    for one seeded output cotangent on all six leaves a case: every field
    and model array by :func:`vjp_ratios` against the float32 twin; a field
    beyond its limit there is held against the float64 twin within
    max(1, 2 × the float32 twin's own ratio to it). ``variants`` as in
    :func:`vjp_gates`: by default the wrapper, gated (a breach raises, and
    with params_grad two runs must agree to the bit); other variants (seeded
    faults) print each case's worst ratio over its limit. Fails a case whose
    start has no point in contact. Returns the largest unscaled |Δ| of each
    case held at its max (the default variant's, by kernel name), and for
    each variant and case its worst ratio over its limit (> 1 is refused)."""
    import copy

    import torch

    from jaxsim_tpu_torch import BatchedState
    from jaxsim_tpu_torch.ops import cuda_step_vjp

    def wide(res):
        out = [BatchedState(*(t.double() for t in res[0].fields())), res[1].double()]
        return (*out, {k: t.double() for k, t in res[2].items()}) if len(res) > 2 else tuple(out)

    gated = variants is None
    variants = variants or {"kernel": cuda_step_vjp.step_vjp}
    errs = {"step_vjp_relaxed_rigid": [], "step_vjp_relaxed_rigid_params_grad": []}
    ratios = {name: {} for name in variants}
    for name, stat in RR_VJP_CASES:
        engine, state, tau = starts[name]
        active = rr_active_points(engine, state)
        print(f"step_vjp relaxed-rigid {name} B={state.p.shape[-1]}: {active} contact points in contact, "
              f"{engine._rr_n_iter} PCG iterations", flush=True)  # fmt: skip
        if not active:
            raise RuntimeError(f"{name}: no point in contact, so the case holds nothing of the contact solve")
        ct = vjp_cotangents(state, gen)["all six"]
        plain = cuda_step_vjp.step_vjp_reference(engine, state, tau, ct, params_grad=True)
        plain64 = []  # the float64 twin's, made when a field breaches
        for pg in (False, True):
            kind = "step_vjp_relaxed_rigid" + ("_params_grad" if pg else "")
            want = plain if pg else plain[:2]
            for vname, run in variants.items():
                kern = run(engine, state, tau, ct, params_grad=pg)
                torch.cuda.synchronize()
                label = f"{kind} {vname} vs plain, {name} B={state.p.shape[-1]}, ct of all six"
                case = name + (", params_grad" if pg else "")
                if not all(bool(torch.isfinite(t).all()) for t in vjp_leaves(kern)):
                    if gated:
                        raise RuntimeError(f"{label}: non-finite cotangent")
                    ratios[vname][case] = math.inf
                    print(f"{label}: non-finite, refused", flush=True)
                    continue
                got, raw = vjp_ratios(kern, want, stat, pg)
                over = sorted(k for k, r in got.items() if not r <= 1.0)
                note = ""
                if over:
                    if not plain64:
                        e64 = copy.deepcopy(engine).to(torch.float64)
                        args = (BatchedState(*(t.double() for t in state.fields())), tau.double(),
                                BatchedState(*(t.double() for t in ct.fields())))  # fmt: skip
                        plain64.append(cuda_step_vjp.step_vjp_reference(e64, *args, params_grad=True))
                    p64 = plain64[0] if pg else plain64[0][:2]
                    k64, _ = vjp_ratios(wide(kern), p64, stat, pg)
                    t64, _ = vjp_ratios(wide(want), p64, stat, pg)
                    for k in over:
                        got[k] = k64[k] / max(1.0, 2.0 * t64[k])
                    note = "; beyond the float32 twin's limit, against the float64 twin (kernel, float32 twin): " + \
                        json.dumps({k: [round(k64[k], 4), round(t64[k], 4)] for k in over})
                ratio = max(got.values())
                ratios[vname][case] = ratio
                print(f"{label}: worst ratio over its limit {ratio:.6g} ({stat} over envs); fields "
                      f"{json.dumps({k: round(r, 4) for k, r in got.items()})}{note}", flush=True)  # fmt: skip
                if not gated:
                    continue
                if not ratio <= 1.0:
                    raise RuntimeError(f"{label}: beyond its limits")
                if pg:
                    again = run(engine, state, tau, ct, params_grad=pg)
                    if not all(torch.equal(x, y) for x, y in zip(vjp_leaves(kern), vjp_leaves(again))):
                        raise RuntimeError(f"two runs of the relaxed-rigid step_vjp with params_grad differ, {name}")
                if stat == "max":
                    errs[kind].append(raw)
    return errs, ratios


def vjp_leaves(res) -> list:
    """A step VJP's cotangents as one list: the state's, tau's, the model arrays'."""
    return [*res[0].fields(), res[1], *(res[2].values() if len(res) > 2 else ())]


def garpez_tilted(engine, gen):
    """Garpez tilted low (RR_GARPEZ): two corners penetrate from step 0."""
    import torch

    g = RR_GARPEZ
    tilted = engine.init_state(g["batch"], base_position=g["base"])
    tilted.q = torch.tensor(g["quat"], device=engine.S.device)[:, None].repeat(1, g["batch"])
    tilted.s = g["joints"] * torch.randn(tilted.s.shape, generator=gen, device=engine.S.device)
    return tilted


def rr_touchdown_engine(device):
    """The relaxed-rigid humanoid with RR_TOUCHDOWN's PCG iterations."""
    engine = rr_humanoid_engine(device)
    engine.rr_iterations = RR_TOUCHDOWN["iterations"]
    return engine


def rr_start_states(hum_rr, garp_rr, hum_td, gen) -> dict:
    """K1-rr's cases' start states by name: (engine, state, PD gains). The
    humanoid's is the relaxed-rigid main path's start; ``hum_td`` is
    :func:`rr_touchdown_engine`'s."""
    import torch

    from jaxsim_tpu_torch import BatchedState

    device = hum_rr.S.device
    start = hum_rr.init_state(BATCH, generator=gen)
    moving = dataclasses.replace(start, sd=RR_JOINT_SPEED * torch.randn(start.sd.shape, generator=gen, device=device))
    tilted = garpez_tilted(garp_rr, gen)
    return {
        RR_CASES[0][0]: (hum_rr, start, (60.0, 0.5)),
        RR_CASES[1][0]: (hum_rr, moving, (60.0, 0.5)),
        RR_CASES[3][0]: (hum_rr, moving_joints(start, gen), (60.0, 0.5)),
        RR_CASES[5][0]: (garp_rr, tilted, RR_GARPEZ["gains"]),
        RR_CASES[6][0]: (hum_td, hum_td.init_state(RR_TOUCHDOWN["batch"], base_position=RR_TOUCHDOWN["base"],
                                                   generator=gen), (60.0, 0.5)),
        RR_CASES[7][0]: (garp_rr, BatchedState(*(t[..., :-STEP_RAGGED].contiguous() for t in tilted.fields())),
                         RR_GARPEZ["gains"]),
    }  # fmt: skip


def rr_active_points(engine, state) -> int:
    """Contact points of ``state``, over all envs, in contact (δ > 0, the
    relaxed-rigid solve's switch), by the twin's geometry."""
    W_R, W_p, W_v = engine.fk(state)
    return int(engine._point_geometry(W_R, W_p, W_v, engine.params())["active"].sum())


def kernel_suffix(engine) -> str:
    """The suffix of a K1 build's name in the kernels line: its integrator's."""
    return "" if engine.integrator == "sie" else f"_{engine.integrator}"


def k1_gates(starts, variants=None, cases=None) -> tuple[list[float], dict[str, dict[str, float]]]:
    """K1's soft build against the plain twin in each of ``cases`` (CASES by
    default, RK4_CASES for the starts of RK4 or RK4-fast engines; ``starts`` maps
    a case's name to (engine, state)), every field at the case's statistic
    over envs held to TOL, the plain trajectory of a start run once.
    ``variants`` maps a name to a function like ``cuda_rollout.rollout``: by
    default the wrapper, which is gated (a breach raises); other variants
    (seeded faults) are held to the same limits without raising. Returns the
    largest |Δ| of each case held at its max (the default variant's), and
    for each variant and case its worst field's statistic over its limit
    (> 1 is refused; a non-finite state is infinitely far)."""
    import torch

    from jaxsim_tpu_torch.ops import cuda_rollout

    gated = variants is None
    variants = variants or {"kernel": cuda_rollout.rollout}
    cases = cases or CASES
    errs, ratios = [], {name: {} for name in variants}
    for name in dict.fromkeys(case[0] for case in cases):
        engine, state = starts[name]
        steps = [(n, stat) for case, n, stat in cases if case == name]
        plain, st = {}, state
        with torch.no_grad():
            for t in range(1, max(n for n, _ in steps) + 1):
                st = cuda_rollout.rollout_reference(engine, st, 1)
                if t in dict(steps):
                    plain[t] = st
        for n, stat in steps:
            label = f"rollout{kernel_suffix(engine)} {{}} vs plain, {name} B={state.p.shape[-1]} {n} steps"
            for vname, run in variants.items():
                kern = run(engine, state, n)
                torch.cuda.synchronize()
                if gated:
                    err = compare_states(label.format(vname), kern, plain[n], stat)
                    if stat == "max":
                        errs.append(err)
                ratio = math.inf
                if all_finite(kern):
                    ratio = max(over_envs(per_env_abs_diff(kern, plain[n]), stat).values()) / TOL
                ratios[vname][f"{name} {n} steps, {stat}"] = ratio
                if not gated:
                    print(f"{label.format(vname)}: worst field's {stat} over its limit {ratio:.6g}", flush=True)
    return errs, ratios


def step_gates(starts, case_tau, variants=None, plains=None) -> tuple[dict[str, list[float]], dict[str, dict[str, float]]]:
    """K2 and K3 against their plain versions: in each of CASES (K2 chained
    as ``rollout_per_step`` chains it, K3 chained under the PD torques) and
    in the ragged case (STEP_RAGGED); K3 also under call-time model arrays
    (``M`` ×1.2 from the joints-moving start, 10 steps, which must move the
    state by more than 1e-4) and on garpez through one APG window from the
    APG start under the APG policy (``case_tau``). ``variants`` maps a name
    to a pair of one-step functions ``(k2(engine, state), k3(engine, state,
    tau, pr))``: by default the wrappers, which are gated (a breach raises);
    other variants (seeded faults) are held to the same limits without
    raising. ``plains`` maps (case, steps) of CASES to the plain state after
    them, where the caller has it. Returns the largest |Δ| of each case held
    at its max, by kernel (the default variant's), and for each variant and
    case its worst field's statistic over its limit (> 1 is refused; a
    non-finite state is infinitely far, and so is a K3 that ``M`` ×1.2 does
    not move)."""
    import torch

    from jaxsim_tpu_torch import BatchedState
    from jaxsim_tpu_torch.ops import cuda_rollout, cuda_step

    gated = variants is None
    variants = variants or {"kernel": (cuda_step.step_pd, cuda_step.step_tau)}
    errs, ratios = {"step_pd": [], "step_tau": []}, {name: {} for name in variants}

    def pd(state):
        return (-60.0 * state.s - 0.5 * state.sd).contiguous()

    def chain(step, state, n):
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
        return state

    def check(vname, kname, label, kern, plain, stat):
        ratio = math.inf
        if all_finite(kern):
            ratio = max(over_envs(per_env_abs_diff(kern, plain), stat).values()) / TOL
        ratios[vname][f"{kname} {label}, {stat}"] = ratio
        if gated:
            err = compare_states(f"{kname} vs plain, {label}", kern, plain, stat)
            if stat == "max":
                errs[kname].append(err)
        else:
            print(f"{kname} {vname} vs plain, {label}: worst field's {stat} over its limit {ratio:.6g}", flush=True)

    hum, moving = starts["humanoid23 joints moving"]
    ragged = BatchedState(*(t[..., :-STEP_RAGGED].contiguous() for t in moving.fields()))
    cases = [(name, n, stat, *starts[name]) for name, n, stat in CASES]
    cases.append(("humanoid23 joints moving, ragged batch", 10, "max", hum, ragged))
    for name, n, stat, engine, state in cases:
        label = f"{name} B={state.p.shape[-1]} {n} steps"
        plain = (plains or {}).get((name, n))
        if plain is None:
            plain = cuda_rollout.rollout_reference(engine, state, n)
        for vname, (k2, k3) in variants.items():
            check(vname, "step_pd", label, chain(lambda st: k2(engine, st), state, n), plain, stat)
            check(vname, "step_tau", label, chain(lambda st: k3(engine, st, pd(st), None), state, n), plain, stat)

    # K3 under call-time model arrays.
    pr = {"M": (1.2 * hum.M).contiguous()}
    plain = chain(lambda st: cuda_step.step_tau_reference(hum, st, pd(st), pr), moving, 10)
    for vname, (_, k3) in variants.items():
        scaled = chain(lambda st: k3(hum, st, pd(st), pr), moving, 10)
        unscaled = chain(lambda st: k3(hum, st, pd(st), None), moving, 10)
        check(vname, "step_tau", "pr M x1.2, 10 steps", scaled, plain, "max")
        moved = max(float(d.max()) for d in per_env_abs_diff(scaled, unscaled).values())
        ratios[vname]["step_tau pr M x1.2 moves the state"] = 1e-4 / moved if moved > 0 else math.inf
        print(f"step_tau {vname}: M x1.2 moves the state by {moved:.6g} after 10 steps", flush=True)
        if gated and not moved > 1e-4:
            raise RuntimeError("K3 ignored the call-time model arrays")

    # K3 on garpez through one APG window under the APG policy.
    garp, start = starts["garpez APG start"]
    plain = chain(lambda st: cuda_step.step_tau_reference(garp, st, case_tau("garpez", st)), start, APG["horizon"])
    for vname, (_, k3) in variants.items():
        kern = chain(lambda st: k3(garp, st, case_tau("garpez", st), None), start, APG["horizon"])
        check(vname, "step_tau", f"garpez APG start B={APG['batch']} {APG['horizon']} steps, APG policy", kern, plain,
              "max")  # fmt: skip
    return errs, ratios


def rr_diff(a, b) -> dict:
    """:func:`per_env_abs_diff`, m's over max(1, max |m| of ``b``)."""
    diff = per_env_abs_diff(a, b)
    diff["m"] = diff["m"] / max(1.0, float(b.m.abs().max()))
    return diff


def pd_tau_as_kernels(state, kp: float, kd: float):
    """The PD torques ``-kp·s - kd·ṡ`` of ``state`` rounded as the kernels'
    PD law (``PdTau``, ``step_env.cuh``) is, which nvcc contracts to
    ``fma(-kp, s, -(kd·ṡ))``: ``kd·ṡ`` rounded to float32, ``-kp·s`` exact in
    float64, their difference rounded to float32 once (through float64,
    exact unless the two differ by more than 2^24 in size)."""
    return (-kp * state.s.double() - (kd * state.sd).double()).float().contiguous()


def rr_wrappers(engine) -> dict:
    """:func:`rr_gates`' default variants on ``engine``, rollout functions
    ``(engine, state, n, kp, kd)`` by kernel: K1-rr, and for a
    semi-implicit Euler engine K2-rr and K3-rr chained one launch a step
    (K3's torques the PD law's, computed between launches and rounded as
    the kernels' are: :func:`pd_tau_as_kernels`)."""
    from jaxsim_tpu_torch.ops import cuda_rollout, cuda_step

    def k3(engine, state, n, kp, kd):
        for _ in range(n):
            state = cuda_step.step_tau(engine, state, pd_tau_as_kernels(state, kp, kd))
        return state

    out = {"rollout": cuda_rollout.rollout}
    if engine.integrator == "sie":
        out.update(step_pd=cuda_step.rollout_per_step, step_tau=k3)
    return out


def rr_k3_witness(starts) -> None:
    """Prints, for each of :func:`rr_start_states`' starts, the envs in
    which one K3-rr step equals one K2-rr step to the bit in every state
    field: K3's torques rounded as the kernels' PD law is
    (:func:`pd_tau_as_kernels`), and as the twin's (``-kp·s - kd·ṡ`` in
    float32). Not gated: it shows which rounding K3's gate takes."""
    import torch

    from jaxsim_tpu_torch.ops import cuda_step

    for name, (engine, state, (kp, kd)) in starts.items():
        k2 = cuda_step.step_pd(engine, state, kp, kd)
        same = {}
        for rounding, tau in (("as the kernels'", pd_tau_as_kernels(state, kp, kd)),
                              ("as the twin's", (-kp * state.s - kd * state.sd).contiguous())):  # fmt: skip
            k3 = cuda_step.step_tau(engine, state, tau)
            equal = torch.ones(state.p.shape[-1], dtype=torch.bool, device=state.p.device)
            for a, b in zip(k3.fields(), k2.fields()):
                equal &= (a == b).reshape(-1, a.shape[-1]).all(0)
            same[rounding] = int(equal.sum())
        print(f"K3-rr vs K2-rr, one step from {name} B={state.p.shape[-1]}: envs equal to the bit, K3's torques "
              f"rounded {json.dumps(same)}", flush=True)  # fmt: skip


def rr_gates(starts, variants=None, cases=None) -> tuple[dict[str, list[float]], dict[str, dict[str, float]]]:
    """The relaxed-rigid kernels against the plain twin in each of ``cases``
    (RR_CASES by default, RR_RK4_CASES for an RK4 engine's starts):
    every state field's per-env |Δ|, m's over max(1, max |plain m|), at the
    case's statistic over envs; against the float64 twin where the case says
    so (RR_CASES). Fails a case whose plain trajectory has no active contact
    point. ``variants`` maps a name to a rollout function ``(engine, state,
    n, kp, kd)``; by default the wrappers of :func:`rr_wrappers` (K1-rr, and
    K2-rr and K3-rr chained), which are gated: a breach raises. A map of
    other variants (seeded faults) is held to the same limits without
    raising. Returns the largest unscaled |Δ| of each case held at its max against
    the float32 twin, by kernel (the default variants'), and for each variant
    and case its worst field's statistic over its limit (> 1 is refused)."""
    import copy

    import torch

    from jaxsim_tpu_torch import BatchedState

    gated = variants is None
    errs, ratios = {}, {name: {} for name in variants or {}}
    all_cases = cases or RR_CASES
    for name in dict.fromkeys(case[0] for case in all_cases):
        engine, state, (kp, kd) = starts[name]
        cases = [case[1:] for case in all_cases if case[0] == name]
        twins = {"float32": (engine, state)}
        if any(against64 for *_, against64 in cases):
            twins["float64"] = (copy.deepcopy(engine).double(), BatchedState(*(t.double() for t in state.fields())))
        plain, active = {k: {} for k in twins}, []
        with torch.no_grad():
            for kind, (eng, st) in twins.items():
                for t in range(1, max(n for n, *_ in cases) + 1):
                    if kind == "float32":
                        active.append(rr_active_points(eng, st))
                    st = eng.step(st, -kp * st.s - kd * st.sd)
                    plain[kind][t] = BatchedState(*(x.float() for x in st.fields()))
        B = state.p.shape[-1]
        for n, stat, against64 in cases:
            case = f"{name} B={B} {n} steps" + ("" if engine.integrator == "sie" else f", {engine.integrator}")
            print(f"relaxed-rigid kernels vs plain, {case}: active contact points summed over the steps "
                  f"{sum(active[:n])}, at the first step {active[0]}, at the last {active[n - 1]}", flush=True)  # fmt: skip
            if not sum(active[:n]):
                raise RuntimeError(f"{case}: no contact point is active, so the gate proves nothing about the solve")
            print(f"{case}: max |plain m| {float(plain['float32'][n].m.abs().max()):.6g} N, m over max(1, that)")
            if against64:
                spread = over_envs(rr_diff(plain["float32"][n], plain["float64"][n]), stat)
                print(f"{case}: float32 twin vs float64 twin, {stat} over envs {json.dumps(spread)}")
                limits, ref = {k: max(TOL, 2 * e) for k, e in spread.items()}, plain["float64"][n]
            else:
                limits, ref = {}, plain["float32"][n]
            for vname, run in (rr_wrappers(engine) if gated else variants).items():
                kname = f"{vname}_relaxed_rigid{kernel_suffix(engine)}"
                label = f"{kname} vs plain, {case}" if gated else f"{vname} vs plain, {case}"
                kern = run(engine, state, n, kp, kd)
                torch.cuda.synchronize()
                if not all(all_finite(p[n]) for p in plain.values()):
                    raise RuntimeError(f"{label}: non-finite plain state")
                if not all_finite(kern):
                    if gated:
                        raise RuntimeError(f"{label}: non-finite state")
                    ratios[vname][f"{case}, {stat}"] = math.inf
                    print(f"{label}: non-finite state, refused", flush=True)
                    continue
                if against64:
                    d32 = over_envs(rr_diff(kern, plain["float32"][n]), stat)
                    print(f"{label}: against the float32 twin (not gated), {stat} over envs {json.dumps(d32)}")
                    label += ", against the float64 twin"
                diff = rr_diff(kern, ref)
                ratio = max(e / limits.get(k, TOL) for k, e in over_envs(diff, stat).items())
                ratios.setdefault(vname, {})[f"{case}, {stat}"] = ratio
                print(f"{label}: worst field's {stat} over its limit {ratio:.6g}", flush=True)
                if gated:
                    gate(label, diff, stat, limits)
                    if stat == "max" and not against64:
                        errs.setdefault(kname, []).append(
                            max(float(d.max()) for d in per_env_abs_diff(kern, ref).values()))
    return errs, ratios


def rr_pr_gate(starts, variants=None) -> tuple[list[float], dict[str, dict[str, float]]]:
    """K3-rr under call-time model arrays: RR_CASES' garpez start, ``M`` and
    ``rrMinv`` scaled by RR_PR through ``pr``, RR_PR["steps"] steps under its
    PD law against the plain twin with the same ``pr``, every field at its
    max over envs (m's over max(1, max |plain m|)) held to TOL, and the state
    moved by more than 1e-4 from K3's without ``pr``. ``variants`` maps a
    name to a one-step function ``(engine, state, tau, pr)``: by default the
    wrapper, ``cuda_step.step_tau``, which is gated (a breach raises); other
    variants are held without raising. Returns the largest |Δ| (the
    wrapper's), and for each variant its worst statistic over its limit."""
    import torch

    from jaxsim_tpu_torch.ops import cuda_step

    gated = variants is None
    variants = variants or {"kernel": cuda_step.step_tau}
    engine, start, (kp, kd) = starts[RR_CASES[5][0]]
    pr = {k: (RR_PR[k] * getattr(engine, k)).contiguous() for k in ("M", "rrMinv")}
    n = RR_PR["steps"]

    def chain(step, with_pr):
        st = start
        for _ in range(n):
            st = step(engine, st, (-kp * st.s - kd * st.sd).contiguous(), pr if with_pr else None)
        torch.cuda.synchronize()
        return st

    plain = chain(cuda_step.step_tau_reference, True)
    errs, ratios = [], {}
    for vname, k3 in variants.items():
        label = f"step_tau_relaxed_rigid {vname} vs plain, {RR_CASES[5][0]}, pr M x{RR_PR['M']:.3g}, rrMinv x{RR_PR['rrMinv']:.3g}, {n} steps"
        scaled, unscaled = chain(k3, True), chain(k3, False)
        moved = max(float(d.max()) for d in per_env_abs_diff(scaled, unscaled).values())
        ratio = math.inf
        if all_finite(scaled):
            ratio = max(over_envs(rr_diff(scaled, plain), "max").values()) / TOL
        ratios[vname] = {"pr": ratio, "pr moves the state": 1e-4 / moved if moved > 0 else math.inf}
        print(f"{label}: worst field's max over its limit {ratio:.6g}; pr moves the state by {moved:.6g}", flush=True)
        if gated:
            if not all_finite(scaled):
                raise RuntimeError(f"{label}: non-finite state")
            gate(label, rr_diff(scaled, plain), "max")
            if not moved > 1e-4:
                raise RuntimeError("K3-rr ignored the call-time model arrays")
            errs.append(max(float(d.max()) for d in per_env_abs_diff(scaled, plain).values()))
    return errs, ratios


def rr_env_gates(cases, variants=None) -> tuple[list[float], dict[str, dict[str, float]]]:
    """K5-rr against ``env_rollout_reference`` on each of ``cases``, a list of
    (label, engine, state, steps, contact, options): resets and steps equal
    in every env, and every state field (m's over max(1, max |plain m|)) and the
    reward sums at the max over envs within TOL. ``variants`` maps a name to
    a function like ``cuda_env_rollout.env_rollout``: by default the
    wrapper, which is gated (a breach raises); other variants (seeded
    faults) are held to the same limits without raising (resets or steps
    that differ are infinitely far). Returns the largest unscaled |Δ| of
    each case (the wrapper's), and for each variant and case its worst
    statistic over its limit. Fails a case meant to hold the contact solve
    (``contact``) whose plain run has no active contact point at its start
    or its end."""
    import torch

    from jaxsim_tpu_torch.ops import cuda_env_rollout

    gated = variants is None
    variants = variants or {"kernel": cuda_env_rollout.env_rollout}
    errs, ratios = [], {name: {} for name in variants}
    for label, engine, state, n, contact, opts in cases:
        plain = cuda_env_rollout.env_rollout_reference(engine, state, n, **opts)
        B = state.p.shape[-1]
        active = (rr_active_points(engine, state), rr_active_points(engine, plain[0]))
        print(f"env_rollout_relaxed_rigid vs plain, {label} B={B} {n} steps: envs that reset "
              f"{int((plain[2] > 0).sum())} of {B}, resets {int(plain[2].sum())}, active contact points at the start "
              f"{active[0]}, at the end {active[1]}", flush=True)  # fmt: skip
        if contact and not sum(active):
            raise RuntimeError(f"{label}: no contact point is active, so the case proves nothing about the solve")
        for vname, run in variants.items():
            kern = run(engine, state, n, **opts)
            torch.cuda.synchronize()
            name = f"env_rollout_relaxed_rigid {vname} vs plain, {label} B={B} {n} steps"
            same = bool(torch.equal(kern[2], plain[2]) and torch.equal(kern[3], plain[3]))
            finite = all_finite(kern[0]) and bool(torch.isfinite(kern[1]).all())
            ratio = math.inf
            if same and finite:
                diff = {**rr_diff(kern[0], plain[0]), "reward_sum": (kern[1] - plain[1]).abs()}
                ratio = max(over_envs(diff, "max").values()) / TOL
            ratios[vname][label] = ratio
            print(f"{name}: resets and steps equal in every env {same}; worst field's max over its limit "
                  f"{ratio:.6g}", flush=True)  # fmt: skip
            if gated:
                if not (same and finite):
                    raise RuntimeError(f"{name}: resets or steps differ, or a non-finite output")
                gate(name, diff, "max")
                raw = {**per_env_abs_diff(kern[0], plain[0]), "reward_sum": (kern[1] - plain[1]).abs()}
                errs.append(max(float(d.max()) for d in raw.values()))
    return errs, ratios


def pd_as_linear(engine, kp: float = 60.0, kd: float = 0.5) -> dict:
    """The PD law tau = -kp·s - kd·ṡ written as a linear policy's ``W``, ``b``."""
    import torch

    n, d, device = engine.n_joints, 2 * engine.n_joints + 11, engine.S.device
    W = torch.zeros(n, d, device=device)
    W[:, :n] = -kp * torch.eye(n, device=device)
    W[:, n : 2 * n] = -kd * torch.eye(n, device=device)
    return dict(W=W, b=torch.zeros(n, 1, device=device))


def rr_env_cases(hum_rr, garp_rr, rr_starts, mlp) -> list:
    """RR_ENV_CASES as :func:`rr_env_gates` takes them, (label, engine, state,
    steps, contact, options): the ES shapes' case from the relaxed-rigid main path's
    start advanced 20 steps by K1-rr under ``mlp`` (the ES weights), the
    touchdown start in the air under :func:`pd_as_linear`, garpez's start (``rr_starts``, from
    :func:`rr_start_states`) with m seeded."""
    import torch

    from jaxsim_tpu_torch.ops import cuda_rollout

    gen = torch.Generator(hum_rr.S.device).manual_seed(8)
    garp = rr_starts[RR_CASES[5][0]][1]
    garp = dataclasses.replace(garp, m=2.0 * torch.randn(garp.m.shape, generator=gen, device=garp.m.device))
    touchdown = hum_rr.init_state(RR_TOUCHDOWN["batch"], base_position=RR_TOUCHDOWN["base"], generator=gen)
    starts = (cuda_rollout.rollout(hum_rr, rr_starts[RR_CASES[0][0]][1], 20), touchdown, garp)
    return [(label, eng, st, steps, contact, {**opts, **extra}) for (label, steps, contact, opts), eng, st, extra
            in zip(RR_ENV_CASES, (hum_rr, hum_rr, garp_rr), starts, (mlp, pd_as_linear(hum_rr), {}))]  # fmt: skip


def probe_gates(device) -> dict[str, float]:
    """Each variant of K7 (K6 is its float32 one) against the plain version
    at PROBE_GATE_T and the gate's k and e, for every compiled chain count,
    at the sweep's largest grid: at most PROBE_ULPS apart. Fails unless the
    plain output moves in every element with the last trip of the loop.
    Returns each probe's largest |Δ|."""
    import torch

    from jaxsim_tpu_torch.ops import fma_probe as fp

    n = torch.cuda.get_device_properties(device).multi_processor_count * max(fp.BLOCKS_PER_SM) * fp.THREADS
    k, e = fp.GATE_K, fp.GATE_E
    errs = {}
    for variant in fp.VARIANTS:
        name = "fma_probe = bf16_probe_f32" if variant == "f32" else f"bf16_probe_{variant}"
        ulps, err = 0, 0.0
        for chains in fp.CHAINS:
            x = fp.make_input(variant, n, device, seed=chains)
            if not fp.moves_every_trip(variant, x, PROBE_GATE_T, chains, k, e):
                raise RuntimeError(f"{name}: the plain output does not move with every trip, so the gate is blind")
            if variant == "f32":
                kern = fp.fma_probe(x, PROBE_GATE_T, chains, k, e)
            else:
                kern = fp.bf16_probe(variant, x, PROBE_GATE_T, chains, k, e)
            plain = fp.probe_reference(variant, x, PROBE_GATE_T, chains, k, e)
            torch.cuda.synchronize()
            ulps = max(ulps, int(fp.ulp_distance(kern, plain).max()))
            err = max(err, float((kern.float() - plain.float()).abs().max()))
        print(f"{name} vs plain, {n} threads, T={PROBE_GATE_T}, k={k} e={e}, chains {fp.CHAINS}: max {ulps} ulp, "
              f"max|Δ| {err:.6g}")  # fmt: skip
        if ulps > PROBE_ULPS:
            raise RuntimeError(f"{name}: kernel and plain {ulps} ulp apart, beyond {PROBE_ULPS}")
        errs[f"bf16_probe_{variant}"] = err
    errs["fma_probe"] = errs["bf16_probe_f32"]
    return errs


def pd_gains(state, gains):
    return -gains[0] * state.s - gains[1] * state.sd


def grad_loss(state):
    """bench.py's gradient-path loss."""
    return (state.sd**2).mean() + state.p[2].mean()


def apg_setup(garp) -> dict:
    """The APG main path's seeded MLP weights (requiring grad), joint target
    and start state."""
    import torch

    device = garp.S.device
    ng, H = garp.n_joints, APG["hidden"]
    gen = torch.Generator(device).manual_seed(4)
    weights = dict(
        W1=0.3 * torch.randn(H, 2 * ng, generator=gen, device=device),
        b1=torch.zeros(H, device=device),
        W2=0.05 * torch.randn(ng, H, generator=gen, device=device),
        b2=torch.zeros(ng, device=device),
    )
    for t in weights.values():
        t.requires_grad_()
    start = garp.init_state(APG["batch"], generator=gen)
    start.s = 0.2 * torch.randn(start.s.shape, generator=gen, device=device)
    return dict(weights=weights, target=torch.tensor(APG["target"][:ng], device=device), start=start)


def apg_policy(state, params, target):
    """examples/train_apg.py's policy: a tanh MLP on [s - s*, ṡ], 5·tanh out."""
    import torch

    obs = torch.cat([state.s - target[:, None], state.sd])
    h = torch.tanh(params["W1"] @ obs + params["b1"][:, None])
    return 5.0 * torch.tanh(params["W2"] @ h + params["b2"][:, None])


def vjp_starts(pend, hum, garp, apg) -> tuple[dict, object]:
    """K4's cases' start states by name, (engine, state): ``start_states``'
    and garpez's (the APG start and, seeded, tilted low in contact); and
    ``case_tau(name, state)``, the torques the main path gives a step at
    ``state``: the APG policy's on garpez, the PD policy's elsewhere."""
    import torch

    starts = start_states(pend, hum)
    starts["garpez APG start"] = (garp, apg["start"])
    starts["garpez tilted low, in contact"] = (garp, garpez_tilted(garp, torch.Generator(hum.S.device).manual_seed(7)))

    def case_tau(name, state):
        if name.startswith("garpez"):
            with torch.no_grad():
                return apg_policy(state, apg["weights"], apg["target"]).contiguous()
        return (-60.0 * state.s - 0.5 * state.sd).contiguous()

    return starts, case_tau


def main() -> int:
    import torch

    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(_run(["nvcc", "--version"]).splitlines()[-1], flush=True)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])

    from jaxsim_tpu_torch import BatchedState
    from jaxsim_tpu_torch.envs import BatchedEnv
    from jaxsim_tpu_torch.ops import (
        cuda_build, cuda_env_rollout, cuda_rollout, cuda_step, cuda_step_vjp, diff_step, flop_count, fma_probe,
    )  # fmt: skip
    from jaxsim_tpu_torch.ops.policies import obs_dim

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(DEVICE)
    sync = torch.cuda.synchronize
    t_start = time.perf_counter()

    hum = humanoid_engine(device)
    pend = pendulum_engine(device)
    garp = garpez_engine(device)
    hum_rr, garp_rr, hum_td = rr_humanoid_engine(device), rr_garpez_engine(device), rr_touchdown_engine(device)
    garp_rr_few = rr_vjp_garpez_engine(device)
    n, d = hum.n_joints, obs_dim(hum.n_joints)
    gen = torch.Generator(device).manual_seed(1)
    # The real-terminations case's linear policy: the PD gains written as a
    # linear policy, perturbed by 0.01·N, with a 0.5·N bias (TERMINATION_Z).
    W = torch.zeros(n, d, device=device)
    W[:, :n] = -60.0 * torch.eye(n, device=device)
    W[:, n : 2 * n] = -0.5 * torch.eye(n, device=device)
    lin = dict(W=W + 0.01 * torch.randn(n, d, generator=gen, device=device),
               b=0.5 * torch.randn(n, 1, generator=gen, device=device))  # fmt: skip
    theta_mu = 0.1 * torch.randn(sum(es_sizes(n, d)), generator=gen, device=device)
    _, mlp = es_population(theta_mu, gen, n, d)
    pols = {k: cuda_env_rollout.make_policy(hum, **w) for k, w in (("linear", lin), ("mlp", mlp))}
    apg = apg_setup(garp)
    # K5-rr's policies (RR_ENV_CASES): the ES main path's MLP, the PD law
    # written as a linear policy; garpez's PD closure.
    pols_rr = {"mlp": cuda_env_rollout.make_policy(hum_rr, **mlp),
               "linear": cuda_env_rollout.make_policy(hum_rr, **pd_as_linear(hum_rr))}  # fmt: skip
    pd_policy = cuda_env_rollout.make_policy(garp_rr)

    starts, case_tau = vjp_starts(pend, hum, garp, apg)
    box = starts["box spinning in the air"][0]
    # RK4 and RK4-fast: the humanoids through the model's integrator (the main
    # paths' engines), the pendulum and the box as copies; CASES' and
    # RR_CASES' starts.
    hum_rk4 = {i: humanoid_engine(device, i) for i in RK4_INTEGRATORS}
    hum_rr_rk4 = {i: rr_humanoid_engine(device, i) for i in RK4_INTEGRATORS}
    garp_rr_rk4 = {i: rr_garpez_engine(device, i) for i in RK4_INTEGRATORS}
    rk4_engines = {i: {id(pend): with_integrator(pend, i), id(hum): hum_rk4[i], id(box): with_integrator(box, i)}
                   for i in RK4_INTEGRATORS}  # fmt: skip
    rk4_starts = {i: {name: (rk4_engines[i][id(starts[name][0])], starts[name][1]) for name, *_ in RK4_CASES}
                  for i in RK4_INTEGRATORS}  # fmt: skip

    # ----- build: every library at once -----
    with phase("build"):
        jobs = dict(
            rollout_pend=cuda_rollout.job(pend), rollout=cuda_rollout.job(hum), step_pend=cuda_step.job(pend),
            step=cuda_step.job(hum), **{f"env_rollout_{k}": cuda_env_rollout.job(hum, p) for k, p in pols.items()},
            vjp=cuda_step_vjp.job(hum), vjp_params_grad=cuda_step_vjp.job(hum, params_grad=True),
            vjp_pend=cuda_step_vjp.job(pend), step_garp=cuda_step.job(garp), vjp_garp=cuda_step_vjp.job(garp),
            vjp_garp_params_grad=cuda_step_vjp.job(garp, params_grad=True), rr_touchdown=cuda_rollout.job(hum_td),
            rr=cuda_rollout.job(hum_rr), rr_garp=cuda_rollout.job(garp_rr), fma_probe=fma_probe.job(),
            rollout_box=cuda_rollout.job(box), step_box=cuda_step.job(box),
            **{f"rollout_{i}_{e.n_links}": cuda_rollout.job(e) for i in RK4_INTEGRATORS for e in rk4_engines[i].values()},
            **{f"rr_{i}": cuda_rollout.job(hum_rr_rk4[i]) for i in RK4_INTEGRATORS},
            **{f"rr_garp_{i}": cuda_rollout.job(garp_rr_rk4[i]) for i in RK4_INTEGRATORS},
            step_rr=cuda_step.job(hum_rr), step_rr_garp=cuda_step.job(garp_rr), step_rr_touchdown=cuda_step.job(hum_td),
            **{f"env_rollout_rr_{k}": cuda_env_rollout.job(hum_rr, p) for k, p in pols_rr.items()},
            env_rollout_rr_garp=cuda_env_rollout.job(garp_rr, pd_policy),
            **{f"vjp_rr{'_params_grad' * pg}_{k}": cuda_step_vjp.job(e, params_grad=pg)
               for k, e in (("hum", hum_rr), ("garp", garp_rr), ("garp_few", garp_rr_few)) for pg in (False, True)},
        )  # fmt: skip
        builds = dict(zip(jobs, cuda_build.build_many(list(jobs.values()))))
    print(f"nvcc seconds {json.dumps({k: round(b.seconds, 2) for k, b in builds.items()})}")
    for b in builds.values():
        print(f"ptxas {b.path.parent.name}: " + " | ".join(
            ln.strip() for ln in b.ptxas_log.splitlines() if "registers" in ln or "spill" in ln or "stack frame" in ln
        ), flush=True)  # fmt: skip

    for b, pg in ((builds["vjp"], False), (builds["vjp_params_grad"], True)):
        geo = cuda_step_vjp.geometry(b)
        print(f"step_vjp{' params_grad' if pg else ''} ({cuda_step_vjp.LANES} lanes an env): {geo['threads']} threads"
              f" and {geo['envs']} envs a block, {geo['smem_bytes']} B of dynamic shared memory a block,"
              f" {geo['blocks_per_sm']} blocks an SM (occupancy calculator); SASS local loads and stores (LDL, STL)"
              f" {json.dumps(cuda_step_vjp.local_memory(b))}", flush=True)  # fmt: skip
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    lane_kernels = dict(
        rollout=(builds["rollout"], cuda_rollout.geometry, cuda_rollout.LANES, BATCH),
        **{f"rollout_{i}": (builds[f"rollout_{i}_{hum.n_links}"], cuda_rollout.geometry, cuda_rollout.LANES, BATCH)
           for i in RK4_INTEGRATORS},
        rollout_pendulum=(builds["rollout_pend"], cuda_rollout.geometry, cuda_rollout.LANES, 1024),
        **{f"env_rollout {k}": (builds[f"env_rollout_{k}"], cuda_env_rollout.geometry, cuda_env_rollout.LANES, BATCH)
           for k in pols},
        step=(builds["step"], cuda_step.geometry, cuda_step.LANES, BATCH),
        step_garpez=(builds["step_garp"], cuda_step.geometry, cuda_step.LANES, APG["batch"]),
    )  # fmt: skip
    for name, (b, geometry, lanes, B) in lane_kernels.items():
        geo = geometry(b)
        places = sms * geo["blocks_per_sm"] * geo["envs"]
        print(f"{name} ({lanes} lanes an env): {geo['threads']} threads and {geo['envs']} envs a block,"
              f" {geo['smem_bytes']} B of dynamic shared memory a block, {geo['blocks_per_sm']} blocks an SM"
              f" (occupancy calculator), so {geo['blocks_per_sm'] * geo['envs']} envs an SM; {B} envs make"
              f" {-(-B // geo['envs'])} blocks, {B / places:.3g} waves of {places} over {sms} SMs; ptxas "
              + " | ".join(ln.strip() for ln in b.ptxas_log.splitlines() if "registers" in ln or "stack frame" in ln)
              + f"; SASS local loads and stores (LDL, STL) {json.dumps(cuda_rollout.lane_local_memory(b))}",
              flush=True)  # fmt: skip
    for name, rr_build in (("rollout_relaxed_rigid", builds["rr"]),
                           *((f"rollout_relaxed_rigid_{i}", builds[f"rr_{i}"]) for i in RK4_INTEGRATORS)):  # fmt: skip
        geo = cuda_rollout.rr_geometry(rr_build)
        print(f"{name} ({cuda_rollout.RR_LANES} lanes an env): {geo['threads']} threads and {geo['envs']}"
              f" envs a block, {geo['smem_bytes']} B of dynamic shared memory a block, {geo['blocks_per_sm']} blocks an"
              f" SM (occupancy calculator), so {geo['blocks_per_sm'] * geo['envs']} envs an SM; {BATCH} envs make"
              f" {-(-BATCH // geo['envs'])} blocks over {sms} SMs; ptxas "
              + " | ".join(ln.strip() for ln in rr_build.ptxas_log.splitlines() if "registers" in ln or "stack frame" in ln)
              + f"; SASS local loads and stores (LDL, STL): {json.dumps(cuda_rollout.rr_local_memory(rr_build))}",
              flush=True)  # fmt: skip

    for name, rr_build, geometry in (("step_tau_relaxed_rigid", builds["step_rr"], cuda_step.geometry),
                                     *((f"env_rollout_relaxed_rigid {k}", builds[f"env_rollout_rr_{k}"],
                                        cuda_env_rollout.geometry) for k in pols_rr)):  # fmt: skip
        geo = geometry(rr_build)
        print(f"{name} ({cuda_rollout.RR_LANES} lanes an env): {geo['threads']} threads and {geo['envs']}"
              f" envs a block, {geo['smem_bytes']} B of dynamic shared memory a block, {geo['blocks_per_sm']} blocks an"
              f" SM (occupancy calculator); {BATCH} envs make {-(-BATCH // geo['envs'])} blocks over {sms} SMs; ptxas "
              + " | ".join(ln.strip() for ln in rr_build.ptxas_log.splitlines() if "registers" in ln or "stack frame" in ln)
              + f"; SASS local loads and stores (LDL, STL): {json.dumps(cuda_rollout.rr_local_memory(rr_build))}",
              flush=True)  # fmt: skip

    for pg in (False, True):
        b = builds[f"vjp_rr{'_params_grad' * pg}_hum"]
        geo = cuda_step_vjp.geometry(b)
        rows = cuda_build.vjp_rr_tables(hum_rr, cuda_step_vjp.RR_LANES, pg, max_envs=cuda_step_vjp.RR_ENVS)["rows"]
        print(f"step_vjp_relaxed_rigid{' params_grad' if pg else ''} ({cuda_step_vjp.RR_LANES} lanes an env, the"
              f" transposed step's tree passes level by level on them): {geo['threads']} threads and {geo['envs']} envs"
              f" a block, {geo['smem_bytes']} B of dynamic shared memory a block, {geo['blocks_per_sm']} blocks an SM"
              f" (occupancy calculator); {BATCH} envs make {-(-BATCH // geo['envs'])} blocks over {sms} SMs; slot and"
              f" tape {4 * rows} B an env in shared memory; ptxas "
              + " | ".join(ln.strip() for ln in b.ptxas_log.splitlines() if "registers" in ln or "stack frame" in ln)
              + f"; SASS local loads and stores (LDL, STL): {json.dumps(cuda_step_vjp.rr_local_memory(b))}",
              flush=True)  # fmt: skip

    sass = fma_probe.check_sass(builds["fma_probe"])
    print("probe SASS, FMA instructions (in the timed loop / in all) by (variant, chains): "
          + ", ".join(f"{k[0]} {k[1]}: {v['op']} {v['in_loop']}/{v['total']}" for k, v in sorted(sass.items())))  # fmt: skip

    # ----- K1, K2, K3 vs plain: one plain trajectory gates all three -----
    # The plain versions of K1 (rollout_reference), K2 (step_pd_reference,
    # chained) and K3 (step_tau_reference with the PD torques, chained) are
    # the same twin steps under the same PD torques, so one plain run holds
    # all three kernels.
    max_errs = {k: [] for k in SOURCES}
    with phase("K1 K2 K3 vs plain"):
        state0 = starts["humanoid23 main-path start"][1]
        plains = {}
        for name, n_steps, stat in CASES:
            engine, state = starts[name]
            plain = plains[(name, n_steps)] = cuda_rollout.rollout_reference(engine, state, n_steps)
            kern = cuda_rollout.rollout(engine, state, n_steps)
            sync()
            err = compare_states(f"rollout vs plain, {name} B={state.p.shape[-1]} {n_steps} steps", kern, plain, stat)
            if stat == "max":
                max_errs["rollout"].append(err)

        # K1 twice from the same start: the same bits.
        moving = starts["humanoid23 joints moving"][1]
        first, again = cuda_rollout.rollout(hum, moving, 100), cuda_rollout.rollout(hum, moving, 100)
        sync()
        if not all(torch.equal(a, b) for a, b in zip(first.fields(), again.fields())):
            raise RuntimeError("two K1 launches from the same start differ")
        print("rollout: two launches from the joints-moving start, 100 steps, agree to the bit", flush=True)

        # K2 and K3: CASES, the ragged batch, call-time model arrays, garpez.
        errs, _ = step_gates(starts, case_tau, plains=plains)
        for kname, e in errs.items():
            max_errs[kname] += e

    # ----- K1's relaxed-rigid build vs plain -----
    with phase("K1 K2 K3 relaxed-rigid vs plain"):
        rr_starts = rr_start_states(hum_rr, garp_rr, hum_td, torch.Generator(device).manual_seed(6))
        rr_k3_witness(rr_starts)
        errs, _ = rr_gates(rr_starts)
        for kname, e in errs.items():
            max_errs[kname] += e
        max_errs["step_tau_relaxed_rigid"] += rr_pr_gate(rr_starts)[0]
        rr_start = rr_starts[RR_CASES[0][0]][1]

    with phase("K5 relaxed-rigid vs plain"):
        max_errs["env_rollout_relaxed_rigid"], _ = rr_env_gates(rr_env_cases(hum_rr, garp_rr, rr_starts, mlp))

    # ----- K1's RK4 and RK4-fast builds vs plain -----
    with phase("K1 RK4 and RK4-fast vs plain"):
        for i in RK4_INTEGRATORS:
            max_errs[f"rollout_{i}"], _ = k1_gates(rk4_starts[i], cases=RK4_CASES)
            rr_rk4_starts = rr_start_states(hum_rr_rk4[i], garp_rr_rk4[i], hum_rr_rk4[i], torch.Generator(device).manual_seed(6))
            errs, _ = rr_gates(rr_rk4_starts, cases=RR_RK4_CASES)
            for kname, e in errs.items():
                max_errs[kname] += e

    # ----- K6, K7 vs plain -----
    with phase("K6 K7 vs plain"):
        for name, err in probe_gates(device).items():
            max_errs[name] = [err]

    # ----- K5 vs plain -----
    def env_case(label, state, n_steps, stat, resets_share, **kw):
        kern = cuda_env_rollout.env_rollout(hum, state, n_steps, **kw)
        plain = cuda_env_rollout.env_rollout_reference(hum, state, n_steps, **kw)
        sync()
        same_resets = float((kern[2] == plain[2]).float().mean())
        same_steps = float((kern[3] == plain[3]).float().mean())
        print(f"env_rollout {label}: envs that reset {int((plain[2] > 0).sum())} of {BATCH}, resets "
              f"{int(plain[2].sum())}; resets equal in {same_resets:.6f}, steps in {same_steps:.6f} of envs")  # fmt: skip
        if same_resets < resets_share or same_steps < resets_share:
            raise RuntimeError(f"env_rollout {label}: resets or steps differ beyond {resets_share}")
        if not (all_finite(kern[0]) and bool(torch.isfinite(kern[1]).all())):
            raise RuntimeError(f"env_rollout {label}: non-finite output")
        diff = {**per_env_abs_diff(kern[0], plain[0]), "reward_sum": (kern[1] - plain[1]).abs()}
        err = gate(f"env_rollout vs plain, {label}", diff, stat)
        if stat == "max":
            max_errs["env_rollout"].append(err)
        return kern

    with phase("K5 vs plain"):
        truncation = dict(episode_length=4, healthy_z_range=(-1e6, 1e6), tau_limit=100.0, **mlp)
        env_case("truncation only, MLP H=16 P=8, episodes of 4, 10 steps", state0, 10, "max", 1.0, **truncation)
        env_case(f"real terminations, linear, z in {TERMINATION_Z}, 100 steps", moving, 100, "p99.9", 0.999,
                 healthy_z_range=TERMINATION_Z, **lin)  # fmt: skip
        noisy = env_case("reset noise 0.02, MLP, episodes of 4, 8 steps", state0, 8, "max", 1.0,
                         reset_noise=0.02, seed=5, **truncation)  # fmt: skip
        spread = float((noisy[0].p[0] - state0.p[0]).std())
        print(f"env_rollout: respawned p[0] - start p[0] std {spread:.6g} (asked 0.02)")
        if not 0.018 <= spread <= 0.022:
            raise RuntimeError("reset noise off its standard deviation")

    # ----- K4 vs plain -----
    vjp_gen = torch.Generator(device).manual_seed(3)

    with phase("K4 vs plain"):
        errs, _ = vjp_gates(starts, case_tau, vjp_gen)
        for name, e in errs.items():
            max_errs[name] += e
        print("step_vjp params_grad: two runs agree to the bit", flush=True)

        partials = torch.randn(-(-BATCH // cuda_step_vjp.envs_per_block(hum, True)),
                               cuda_build.packed_params(hum).numel(), generator=vjp_gen, device=device)  # fmt: skip
        kern, plain = cuda_step_vjp.sum_partials(hum, partials), cuda_step_vjp.sum_partials_reference(partials)
        again = cuda_step_vjp.sum_partials(hum, partials)
        sync()
        if not torch.equal(kern, again):
            raise RuntimeError("two runs of param_sum differ")
        err = float((kern - plain).abs().max())
        print(f"param_sum vs plain, {tuple(partials.shape)}: max|Δ| {err:.6g}, max|plain| {float(plain.abs().max()):.6g}")
        if not err <= 1e-4 * max(1.0, float(plain.abs().max())):
            raise RuntimeError("param_sum disagrees with plain")
        max_errs["param_sum"].append(err)

    # ----- K4-rr vs plain -----
    with phase("K4-rr vs plain"):
        rr_vjp = rr_vjp_starts(rr_starts, garp_rr_few, torch.Generator(device).manual_seed(8))
        errs, _ = rr_vjp_gates(rr_vjp, vjp_gen)
        for name, e in errs.items():
            max_errs[name] += e
        print("step_vjp relaxed-rigid params_grad: two runs agree to the bit", flush=True)
        # K4-rr's partials: a row a block.
        rr_rows = -(-BATCH // cuda_step_vjp.rr_envs_per_block(hum_rr, True))
        rr_partials = torch.randn(rr_rows, cuda_build.packed_params(hum_rr).numel(), generator=vjp_gen, device=device)
        kern = cuda_step_vjp.sum_partials(hum_rr, rr_partials)
        plain, again = cuda_step_vjp.sum_partials_reference(rr_partials), cuda_step_vjp.sum_partials(hum_rr, rr_partials)
        sync()
        if not torch.equal(kern, again):
            raise RuntimeError("two runs of the relaxed-rigid param_sum differ")
        err = float((kern - plain).abs().max())
        print(f"param_sum relaxed-rigid vs plain, {tuple(rr_partials.shape)}: max|Δ| {err:.6g}, "
              f"max|plain| {float(plain.abs().max()):.6g}")  # fmt: skip
        if not err <= 1e-4 * max(1.0, float(plain.abs().max())):
            raise RuntimeError("the relaxed-rigid param_sum disagrees with plain")
        max_errs["param_sum_relaxed_rigid"].append(err)

    with phase("rollout gradient vs plain"):
        steps = GRAD["check_steps"]
        gains = torch.tensor(GRAD["gains"], device=device, requires_grad=True)
        kern = torch.autograd.grad(grad_loss(diff_step.fused_diff_rollout(hum, steps)(state0, pd_gains, gains)), gains)[0]
        st = state0
        for _ in range(steps):
            st = hum.step(st, pd_gains(st, gains))
        plain = torch.autograd.grad(grad_loss(st), gains)[0]
        sync()
        rel = float(((kern - plain).abs() / plain.abs()).max())
        print(f"gains gradient through {steps} steps at B={BATCH}: fused {kern.tolist()}, plain {plain.tolist()},"
              f" max relative |Δ| {rel:.6g}")  # fmt: skip
        if not rel <= GRAD["check_rtol"]:
            raise RuntimeError(f"the fused rollout's gradient disagrees with plain beyond {GRAD['check_rtol']}")

    with phase("relaxed-rigid rollout gradient vs plain"):
        # K3-rr forward and K4-rr backward against the twin under autograd,
        # garpez tilted low under its PD law.
        g_engine, g_start, g_gains = rr_starts[RR_CASES[5][0]]
        steps = GRAD["check_steps"]
        gains = torch.tensor(g_gains, device=device, requires_grad=True)
        kern = torch.autograd.grad(grad_loss(diff_step.fused_diff_rollout(g_engine, steps)(g_start, pd_gains, gains)),
                                   gains)[0]  # fmt: skip
        st = g_start
        for _ in range(steps):
            st = g_engine.step(st, pd_gains(st, gains))
        plain = torch.autograd.grad(grad_loss(st), gains)[0]
        sync()
        rel = float(((kern - plain).abs() / plain.abs()).max())
        print(f"relaxed-rigid gains gradient through {steps} steps, garpez B={g_start.p.shape[-1]}: fused "
              f"{kern.tolist()}, plain {plain.tolist()}, max relative |Δ| {rel:.6g}")  # fmt: skip
        if not rel <= GRAD["check_rtol"]:
            raise RuntimeError(f"the relaxed-rigid fused rollout's gradient disagrees with plain beyond {GRAD['check_rtol']}")

    # ----- main paths -----
    results = {}
    with phase("main path: flagship rollout (K1)"):
        (out, times), launches = main_path("flagship", dict(rollout=1 + TIMED_CALLS),
                                           lambda: chained(hum, state0, HORIZON, TIMED_CALLS))  # fmt: skip
        wall = [t[0] for t in times]
        results["rollout"] = dict(launches=launches["rollout"], ms=statistics.median(t[1] for t in times))
        print(f"K1: {BATCH}x{HORIZON} steps per call, wall s {wall}, device ms {[t[1] for t in times]}")
        print(f"K1 env_steps_per_s (median wall): {BATCH * HORIZON / statistics.median(wall):.6g}", flush=True)
        if not all_finite(out):
            raise RuntimeError("non-finite final state")
        z = out.p[2]
        z_min, z_max = float(z.min()), float(z.max())
        print(f"base height after {(1 + TIMED_CALLS) * HORIZON} steps: min {z_min:.4f} m,"
              f" max {z_max:.4f} m, share of envs above 0.5 m {float((z > 0.5).float().mean()):.4f}")  # fmt: skip
        if not HEIGHT_BAND[0] <= z_min <= z_max <= HEIGHT_BAND[1]:
            raise RuntimeError(f"base height outside {HEIGHT_BAND} m")
        flagship_final = out

    with phase("main path: per-step rollout (K2)"):
        def per_step():
            cuda_step.rollout_per_step(hum, state0, 1)  # warm-up
            sync()
            holder = {}
            ms = device_ms(lambda: holder.update(out=cuda_step.rollout_per_step(hum, state0, PER_STEP_LAUNCHES)), 1)[0]
            return holder["out"], ms

        (out, ms), launches = main_path("per-step rollout", dict(step_pd=1 + PER_STEP_LAUNCHES), per_step)
        results["step_pd"] = dict(launches=launches["step_pd"], ms=ms / PER_STEP_LAUNCHES)
        print(f"K2: {PER_STEP_LAUNCHES} launches at B={BATCH}, device ms per launch {ms / PER_STEP_LAUNCHES:.6g}")
        if not all_finite(out):
            raise RuntimeError("non-finite state after the per-step rollout")

    with phase("main path: ES generations (K5)"):
        def es():
            cuda_env_rollout.env_rollout(hum, state0, ES["steps"], **ES_OPTIONS, **mlp)  # warm-up
            sync()
            mean, gens = theta_mu.clone(), []
            for _ in range(ES["generations"]):
                eps, w = es_population(mean, gen, n, d)  # fresh weights every generation
                holder = {}
                ms = device_ms(lambda: holder.update(
                    out=cuda_env_rollout.env_rollout(hum, state0, ES["steps"], **ES_OPTIONS, **w)), 1)[0]  # fmt: skip
                final, reward, resets, steps = holder["out"]
                fitness = reward.reshape(ES["candidates"], -1).mean(1)
                gens.append(dict(ms=ms, final=final, reward=reward, resets=resets, steps=steps, fitness=fitness))
                adv = (fitness - fitness.mean()) / (fitness.std() + 1e-8)
                mean = mean + ES["lr"] / (ES["candidates"] * ES["sigma"]) * (adv[:, None] * eps).sum(0)
            return gens

        gens, launches = main_path("ES", dict(env_rollout=1 + ES["generations"]), es)
        results["env_rollout"] = dict(launches=launches["env_rollout"], ms=statistics.median(g["ms"] for g in gens))
        lo, hi = ES_OPTIONS["healthy_z_range"]
        for i, g in enumerate(gens):
            per_cand = g["resets"].reshape(ES["candidates"], -1).sum(1).tolist()
            print(f"ES generation {i}: device ms {g['ms']:.6g}, env_steps_per_s "
                  f"{BATCH * ES['steps'] / (g['ms'] * 1e-3):.6g}, resets per candidate {per_cand}, "
                  f"mean reward per candidate {[round(x, 4) for x in g['fitness'].tolist()]}")  # fmt: skip
            z = g["final"].p[2]
            if not (all_finite(g["final"]) and bool(torch.isfinite(g["reward"]).all())):
                raise RuntimeError("ES: non-finite output")
            # Every final state is either stepped and healthy, or respawned.
            if not (lo <= float(z.min()) and float(z.max()) <= hi):
                raise RuntimeError(f"ES: final base height outside the healthy range {lo, hi}")
            if not (int(g["steps"].max()) < ES_OPTIONS["episode_length"] and int(g["resets"].sum()) > 0):
                raise RuntimeError("ES: episode bookkeeping out of range")

    with phase("main path: BatchedEnv.step (K3)"):
        env = BatchedEnv(engine=hum, episode_length=ES_OPTIONS["episode_length"],
                         healthy_z_range=ES_OPTIONS["healthy_z_range"])  # fmt: skip

        def env_steps():
            state, obs = env.reset(torch.Generator(device).manual_seed(2), BATCH)
            state, obs, _, _ = env.step(state, torch.zeros(n, BATCH, device=device))  # warm-up
            sync()
            t0 = time.perf_counter()
            rewards = []
            for _ in range(ENV_STEPS):
                action = (-60.0 * state.sim.s - 0.5 * state.sim.sd).contiguous()
                state, obs, reward, done = env.step(state, action)
                rewards.append(reward)
            sync()
            return state, obs, rewards, (time.perf_counter() - t0) * 1e3 / ENV_STEPS

        (state, obs, rewards, step_ms), launches = main_path("BatchedEnv.step", dict(step_tau=1 + ENV_STEPS), env_steps)
        results["step_tau"] = dict(launches=launches["step_tau"])
        print(f"BatchedEnv.step: B={BATCH}, wall ms per step {step_ms:.6g}")
        if not (bool(torch.isfinite(obs).all()) and all(bool(torch.isfinite(r).all()) for r in rewards)):
            raise RuntimeError("BatchedEnv.step: non-finite output")
        if tuple(obs.shape) != (d, BATCH) or int(state.steps.max()) > 1 + ENV_STEPS:
            raise RuntimeError("BatchedEnv.step: wrong shapes or step counts")

    def timed_gradients(once, n: int):
        """``once()`` for a warm-up, then ``n`` times, each ended by a
        synchronize: ``[(wall s, result), ...]`` of the timed calls."""
        once()
        sync()
        runs = []
        for _ in range(n):
            t0 = time.perf_counter()
            res = once()
            sync()
            runs.append((time.perf_counter() - t0, res))
        return runs

    def report_gradient(name, runs):
        wall = [r[0] for r in runs]
        rate = BATCH * GRAD["steps"] / statistics.median(wall)
        print(f"{name}: B={BATCH}, {GRAD['steps']} steps, wall s {wall}, gradient env_steps_per_s (median wall) {rate:.6g}")
        return rate

    grad_launches = (1 + GRAD["timed"]) * GRAD["steps"]
    with phase("main path: policy gradient (K3, K4)"):
        pg_rollout = diff_step.fused_diff_rollout(hum, GRAD["steps"])

        def policy_gradient():
            gains = torch.tensor(GRAD["gains"], device=device, requires_grad=True)
            out = pg_rollout(state0, pd_gains, gains)
            loss = grad_loss(out)
            loss.backward()
            return out, loss.detach(), gains.grad

        runs, launches = main_path("policy gradient", dict(step_tau=grad_launches, step_vjp=grad_launches),
                                   lambda: timed_gradients(policy_gradient, GRAD["timed"]))  # fmt: skip
        results["step_vjp"] = dict(launches=launches["step_vjp"])
        report_gradient("policy gradient", runs)
        grad_final, loss, g = runs[-1][1]
        print(f"policy gradient: loss {float(loss):.6g}, d loss / d gains {g.tolist()}", flush=True)
        if not (bool(torch.isfinite(g).all()) and bool((g != 0).any()) and all_finite(grad_final)):
            raise RuntimeError("policy gradient: non-finite or all-zero gradient")

    with phase("main path: hardware-parameter gradient (K3, K4 params_grad)"):
        hw_rollout = diff_step.fused_diff_rollout(hum, GRAD["steps"], params_grad=True)
        fixed_gains = torch.tensor(GRAD["gains"], device=device)

        def hardware_gradient():
            hw = {k: getattr(hum, k).clone().requires_grad_() for k in ("M", "cpoint")}
            loss = grad_loss(hw_rollout(state0, pd_gains, fixed_gains, pr=hw))
            loss.backward()
            return loss.detach(), {k: t.grad for k, t in hw.items()}

        runs, launches = main_path(
            "hardware-parameter gradient",
            dict(step_tau=grad_launches, step_vjp=grad_launches, param_sum=grad_launches),
            lambda: timed_gradients(hardware_gradient, GRAD["timed"]),
        )
        results["step_vjp_params_grad"] = dict(launches=launches["step_vjp"])
        results["param_sum"] = dict(launches=launches["param_sum"])
        report_gradient("hardware-parameter gradient", runs)
        loss, g = runs[-1][1]
        print(f"hardware-parameter gradient: loss {float(loss):.6g}, "
              + ", ".join(f"max|d loss / d {k}| {float(t.abs().max()):.6g}" for k, t in g.items()), flush=True)  # fmt: skip
        if not (all(bool(torch.isfinite(t).all()) for t in g.values()) and any(bool((t != 0).any()) for t in g.values())):
            raise RuntimeError("hardware-parameter gradient: non-finite or all-zero gradients")

    with phase("main path: APG training (K3, K4)"):
        weights, target = apg["weights"], apg["target"]
        opt = torch.optim.Adam(weights.values(), lr=APG["lr"])
        apg_rollout = diff_step.fused_diff_rollout(garp, APG["horizon"])

        def train():
            state, losses = apg["start"], []
            for _ in range(APG["windows"]):
                opt.zero_grad()
                out = apg_rollout(state, apg_policy, weights, target)
                loss = ((out.s - target[:, None]) ** 2).mean() + 0.02 * (out.sd**2).mean()
                loss.backward()
                opt.step()
                # SHAC truncation: the running state advances under the
                # updated policy with gradients off.
                with torch.no_grad():
                    state = apg_rollout(state, apg_policy, weights, target)
                losses.append(float(loss.detach()))
            return state, losses

        windows = APG["windows"] * APG["horizon"]
        (apg_final, losses), _ = main_path("APG", dict(step_tau=2 * windows, step_vjp=windows), train)
        print(f"APG: garpez B={APG['batch']}, windows of {APG['horizon']} steps, losses {losses}", flush=True)
        if not (all(map(math.isfinite, losses)) and all_finite(apg_final)):
            raise RuntimeError("APG: non-finite loss or state")

    with phase("main path: relaxed-rigid rollout (K1)"):
        if hum_rr._rr_n_iter != RR_ITERATIONS:
            raise RuntimeError(f"the relaxed-rigid humanoid runs {hum_rr._rr_n_iter} PCG iterations, not {RR_ITERATIONS}")

        (rr_final, times), launches = main_path("relaxed-rigid rollout", dict(rollout_relaxed_rigid=1 + RR_TIMED_CALLS),
                                                lambda: chained(hum_rr, rr_start, RR_HORIZON, RR_TIMED_CALLS))  # fmt: skip
        wall = [t[0] for t in times]
        results["rollout_relaxed_rigid"] = dict(launches=launches["rollout_relaxed_rigid"],
                                                ms=statistics.median(t[1] for t in times))  # fmt: skip
        print(f"K1 relaxed-rigid: {BATCH}x{RR_HORIZON} steps per call, {hum_rr._rr_n_iter} PCG iterations a step, "
              f"wall s {wall}, device ms {[t[1] for t in times]}")  # fmt: skip
        print(f"K1 relaxed-rigid env_steps_per_s (median wall): {BATCH * RR_HORIZON / statistics.median(wall):.6g}",
              flush=True)  # fmt: skip
        if not all_finite(rr_final):
            raise RuntimeError("relaxed-rigid rollout: non-finite final state")
        z = rr_final.p[2]
        z_min, z_max = float(z.min()), float(z.max())
        print(f"relaxed-rigid base height after {(1 + RR_TIMED_CALLS) * RR_HORIZON} steps: min {z_min:.4f} m, "
              f"max {z_max:.4f} m, share of envs above 0.5 m {float((z > 0.5).float().mean()):.4f}; "
              f"max |m| {float(rr_final.m.abs().max()):.6g} N")  # fmt: skip
        if not HEIGHT_BAND[0] <= z_min <= z_max <= HEIGHT_BAND[1]:
            raise RuntimeError(f"relaxed-rigid base height outside {HEIGHT_BAND} m")

    with phase("main path: relaxed-rigid per-step rollout (K2-rr)"):
        def rr_per_step():
            cuda_step.rollout_per_step(hum_rr, rr_start, 1)  # warm-up
            sync()
            holder = {}
            ms = device_ms(lambda: holder.update(out=cuda_step.rollout_per_step(hum_rr, rr_start, PER_STEP_LAUNCHES)),
                           1)[0]  # fmt: skip
            return holder["out"], ms

        (out, ms), launches = main_path("relaxed-rigid per-step rollout",
                                        dict(step_pd_relaxed_rigid=1 + PER_STEP_LAUNCHES), rr_per_step)  # fmt: skip
        results["step_pd_relaxed_rigid"] = dict(launches=launches["step_pd_relaxed_rigid"], ms=ms / PER_STEP_LAUNCHES)
        print(f"K2-rr: {PER_STEP_LAUNCHES} launches at B={BATCH}, device ms per launch {ms / PER_STEP_LAUNCHES:.6g}")
        if not all_finite(out):
            raise RuntimeError("non-finite state after the relaxed-rigid per-step rollout")

    with phase("main path: relaxed-rigid ES generations (K5-rr)"):
        def rr_es():
            cuda_env_rollout.env_rollout(hum_rr, rr_start, ES["steps"], **ES_OPTIONS, **mlp)  # warm-up
            sync()
            mean, gens = theta_mu.clone(), []
            for _ in range(ES["generations"]):
                eps, w = es_population(mean, gen, n, d)
                holder = {}
                ms = device_ms(lambda: holder.update(
                    out=cuda_env_rollout.env_rollout(hum_rr, rr_start, ES["steps"], **ES_OPTIONS, **w)), 1)[0]  # fmt: skip
                final, reward, resets, steps = holder["out"]
                fitness = reward.reshape(ES["candidates"], -1).mean(1)
                gens.append(dict(ms=ms, final=final, reward=reward, resets=resets, steps=steps, fitness=fitness))
                adv = (fitness - fitness.mean()) / (fitness.std() + 1e-8)
                mean = mean + ES["lr"] / (ES["candidates"] * ES["sigma"]) * (adv[:, None] * eps).sum(0)
            return gens

        rr_gens, launches = main_path("relaxed-rigid ES", dict(env_rollout_relaxed_rigid=1 + ES["generations"]), rr_es)
        results["env_rollout_relaxed_rigid"] = dict(launches=launches["env_rollout_relaxed_rigid"],
                                                    ms=statistics.median(g["ms"] for g in rr_gens))  # fmt: skip
        lo, hi = ES_OPTIONS["healthy_z_range"]
        for i, g in enumerate(rr_gens):
            per_cand = g["resets"].reshape(ES["candidates"], -1).sum(1).tolist()
            print(f"relaxed-rigid ES generation {i}: device ms {g['ms']:.6g}, env_steps_per_s "
                  f"{BATCH * ES['steps'] / (g['ms'] * 1e-3):.6g}, resets per candidate {per_cand}, "
                  f"mean reward per candidate {[round(x, 4) for x in g['fitness'].tolist()]}")  # fmt: skip
            z = g["final"].p[2]
            if not (all_finite(g["final"]) and bool(torch.isfinite(g["reward"]).all())):
                raise RuntimeError("relaxed-rigid ES: non-finite output")
            if not (lo <= float(z.min()) and float(z.max()) <= hi):
                raise RuntimeError(f"relaxed-rigid ES: final base height outside the healthy range {lo, hi}")
            if not (int(g["steps"].max()) < ES_OPTIONS["episode_length"] and int(g["resets"].sum()) > 0):
                raise RuntimeError("relaxed-rigid ES: episode bookkeeping out of range")

    with phase("main path: relaxed-rigid BatchedEnv.step (K3-rr)"):
        rr_env = BatchedEnv(engine=hum_rr, episode_length=ES_OPTIONS["episode_length"],
                            healthy_z_range=ES_OPTIONS["healthy_z_range"])  # fmt: skip

        def rr_env_steps():
            state, obs = rr_env.reset(torch.Generator(device).manual_seed(2), BATCH)
            state, obs, _, _ = rr_env.step(state, torch.zeros(n, BATCH, device=device))  # warm-up
            sync()
            t0 = time.perf_counter()
            rewards = []
            for _ in range(ENV_STEPS):
                action = (-60.0 * state.sim.s - 0.5 * state.sim.sd).contiguous()
                state, obs, reward, done = rr_env.step(state, action)
                rewards.append(reward)
            sync()
            return state, obs, rewards, (time.perf_counter() - t0) * 1e3 / ENV_STEPS

        (state, obs, rewards, step_ms), launches = main_path(
            "relaxed-rigid BatchedEnv.step", dict(step_tau_relaxed_rigid=1 + ENV_STEPS), rr_env_steps)
        results["step_tau_relaxed_rigid"] = dict(launches=launches["step_tau_relaxed_rigid"])
        print(f"BatchedEnv.step relaxed-rigid: B={BATCH}, wall ms per step {step_ms:.6g}; max |m| "
              f"{float(state.sim.m.abs().max()):.6g} N")  # fmt: skip
        if not (bool(torch.isfinite(obs).all()) and all(bool(torch.isfinite(r).all()) for r in rewards)):
            raise RuntimeError("relaxed-rigid BatchedEnv.step: non-finite output")
        if tuple(obs.shape) != (d, BATCH) or int(state.steps.max()) > 1 + ENV_STEPS:
            raise RuntimeError("relaxed-rigid BatchedEnv.step: wrong shapes or step counts")

    with phase("main path: relaxed-rigid policy gradient (K3-rr, K4-rr)"):
        rr_pg_rollout = diff_step.fused_diff_rollout(hum_rr, GRAD["steps"])

        def rr_policy_gradient():
            gains = torch.tensor(GRAD["gains"], device=device, requires_grad=True)
            out = rr_pg_rollout(rr_start, pd_gains, gains)
            loss = grad_loss(out)
            loss.backward()
            return out, loss.detach(), gains.grad

        runs, launches = main_path(
            "relaxed-rigid policy gradient", dict(step_tau_relaxed_rigid=grad_launches, step_vjp_relaxed_rigid=grad_launches),
            lambda: timed_gradients(rr_policy_gradient, GRAD["timed"]),
        )  # fmt: skip
        results["step_vjp_relaxed_rigid"] = dict(launches=launches["step_vjp_relaxed_rigid"])
        report_gradient("relaxed-rigid policy gradient", runs)
        rr_grad_final, loss, g = runs[-1][1]
        print(f"relaxed-rigid policy gradient: loss {float(loss):.6g}, d loss / d gains {g.tolist()}", flush=True)
        if not (bool(torch.isfinite(g).all()) and bool((g != 0).any()) and all_finite(rr_grad_final)):
            raise RuntimeError("relaxed-rigid policy gradient: non-finite or all-zero gradient")

    with phase("main path: relaxed-rigid hardware-parameter gradient (K3-rr, K4-rr params_grad)"):
        rr_hw_rollout = diff_step.fused_diff_rollout(hum_rr, GRAD["steps"], params_grad=True)
        fixed_gains = torch.tensor(GRAD["gains"], device=device)

        def rr_hardware_gradient():
            hw = {k: getattr(hum_rr, k).clone().requires_grad_() for k in ("M", "cpoint")}
            loss = grad_loss(rr_hw_rollout(rr_start, pd_gains, fixed_gains, pr=hw))
            loss.backward()
            return loss.detach(), {k: t.grad for k, t in hw.items()}

        runs, launches = main_path(
            "relaxed-rigid hardware-parameter gradient",
            dict(step_tau_relaxed_rigid=grad_launches, step_vjp_relaxed_rigid=grad_launches,
                 param_sum_relaxed_rigid=grad_launches),
            lambda: timed_gradients(rr_hardware_gradient, GRAD["timed"]),
        )  # fmt: skip
        results["step_vjp_relaxed_rigid_params_grad"] = dict(launches=launches["step_vjp_relaxed_rigid"])
        results["param_sum_relaxed_rigid"] = dict(launches=launches["param_sum_relaxed_rigid"])
        report_gradient("relaxed-rigid hardware-parameter gradient", runs)
        loss, g = runs[-1][1]
        print(f"relaxed-rigid hardware-parameter gradient: loss {float(loss):.6g}, "
              + ", ".join(f"max|d loss / d {k}| {float(t.abs().max()):.6g}" for k, t in g.items()), flush=True)  # fmt: skip
        if not (all(bool(torch.isfinite(t).all()) for t in g.values()) and any(bool((t != 0).any()) for t in g.values())):
            raise RuntimeError("relaxed-rigid hardware-parameter gradient: non-finite or all-zero gradients")

    rk4_finals = {}
    with phase("main path: BASELINE config 5, relaxed-rigid RK4 rollout (K1)"):
        cfg5 = hum_rr_rk4["rk4"]
        if cfg5._rr_n_iter != RR_ITERATIONS:
            raise RuntimeError(f"config 5 runs {cfg5._rr_n_iter} PCG iterations a stage, not {RR_ITERATIONS}")
        (out, times), launches = main_path("BASELINE config 5", dict(rollout_relaxed_rigid=1 + RK4_TIMED_CALLS),
                                           lambda: chained(cfg5, rr_start, RR_RK4_HORIZON, RK4_TIMED_CALLS))  # fmt: skip
        wall = [t[0] for t in times]
        results["rollout_relaxed_rigid_rk4"] = dict(launches=launches["rollout_relaxed_rigid"],
                                                    ms=statistics.median(t[1] for t in times))  # fmt: skip
        print(f"config 5 (relaxed-rigid, RK4): {BATCH}x{RR_RK4_HORIZON} steps per call, {cfg5._rr_n_iter} PCG"
              f" iterations a stage, wall s {wall}, device ms {[t[1] for t in times]}")  # fmt: skip
        print(f"config 5 env_steps_per_s (median wall): {BATCH * RR_RK4_HORIZON / statistics.median(wall):.6g}",
              flush=True)  # fmt: skip
        rk4_finals["rollout_relaxed_rigid_rk4"] = out

    with phase("main path: soft RK4 rollout (K1)"):
        (out, times), launches = main_path("soft RK4 rollout", dict(rollout=1 + RK4_TIMED_CALLS),
                                           lambda: chained(hum_rk4["rk4"], state0, SOFT_RK4_HORIZON, RK4_TIMED_CALLS))  # fmt: skip
        wall = [t[0] for t in times]
        results["rollout_rk4"] = dict(launches=launches["rollout"], ms=statistics.median(t[1] for t in times))
        print(f"soft RK4: {BATCH}x{SOFT_RK4_HORIZON} steps per call, wall s {wall}, device ms {[t[1] for t in times]}")
        print(f"soft RK4 env_steps_per_s (median wall): {BATCH * SOFT_RK4_HORIZON / statistics.median(wall):.6g}",
              flush=True)  # fmt: skip
        rk4_finals["rollout_rk4"] = out

    with phase("main path: RK4-fast timing (K1)"):
        for name, engine, start, horizon, counter in (
            ("rollout_rk4fast", hum_rk4["rk4fast"], state0, SOFT_RK4_HORIZON, "rollout"),
            ("rollout_relaxed_rigid_rk4fast", hum_rr_rk4["rk4fast"], rr_start, RR_RK4_HORIZON, "rollout_relaxed_rigid"),
        ):  # fmt: skip
            def once():
                holder = {}
                ms = device_ms(lambda: holder.update(out=cuda_rollout.rollout(engine, start, horizon)), 1)[0]
                return holder["out"], ms

            (out, ms), launches = main_path(f"{name} timing", {counter: 1}, once)
            results[name] = dict(launches=launches[counter], ms=ms)
            print(f"{name}: {BATCH}x{horizon} steps, one launch, device ms {ms:.6g}, env_steps_per_s "
                  f"{BATCH * horizon / (ms * 1e-3):.6g}", flush=True)  # fmt: skip
            rk4_finals[name] = out

    for name, out in rk4_finals.items():
        if not all_finite(out):
            raise RuntimeError(f"{name}: non-finite final state")
        z = out.p[2]
        z_min, z_max = float(z.min()), float(z.max())
        print(f"{name} base height after its main path: min {z_min:.4f} m, max {z_max:.4f} m, share of envs above"
              f" 0.5 m {float((z > 0.5).float().mean()):.4f}; max |m| {float(out.m.abs().max()):.6g}")  # fmt: skip
        if not HEIGHT_BAND[0] <= z_min <= z_max <= HEIGHT_BAND[1]:
            raise RuntimeError(f"{name}: base height outside {HEIGHT_BAND} m")

    probe_names = ("fma_probe", *(f"bf16_probe_{v}" for v in fma_probe.VARIANTS))
    with phase("main path: FMA-rate probes (K6, K7)"):
        def probes():
            # K6 is K7's float32 chain: one sweep, counted as both.
            rates = {f"bf16_probe_{v}": fma_probe.measure(v, device) for v in fma_probe.VARIANTS}
            rates["fma_probe"] = rates["bf16_probe_f32"]
            return rates

        rates, launches = main_path("FMA-rate probes", dict.fromkeys(probe_names, fma_probe.sweep_launches()), probes)
        for name, r in rates.items():
            peak = fma_probe.PEAK_FLOPS[r["variant"]]
            results[name] = dict(launches=launches[name], ms=r["ms"])
            if name == "fma_probe":
                continue
            print(f"{name}: {r['rate'] / 1e12:.6g} TFLOP/s, {100 * r['rate'] / peak:.4g} % of the data sheet's "
                  f"{peak / 1e12:g} ({r['variant']}), at {r['chains']} chains a thread and {r['blocks_per_sm']} blocks "
                  f"of {fma_probe.THREADS} an SM; T={fma_probe.T_LONG} {r['ms']:.6g} ms, T={fma_probe.T_SHORT} "
                  f"{r['ms_short']:.6g} ms")  # fmt: skip
            print(f"{name} sweep (chains, blocks/SM, TFLOP/s): "
                  + ", ".join(f"({c['chains']}, {c['blocks_per_sm']}, {c['rate'] / 1e12:.4g})" for c in r["sweep"]))
            if not r["rate"] <= 1.05 * peak:
                raise RuntimeError(f"{name} above 105 % of the data-sheet peak: the compiler removed work")
        measured_peak = dict(f32=rates["fma_probe"]["rate"], bf16=rates["bf16_probe_bf16"]["rate"])

    # ----- kernel and plain times at the main paths' shapes -----
    with phase("timing"):
        tau0 = (-60.0 * state0.s - 0.5 * state0.sd).contiguous()
        cuda_step.step_tau(hum, state0, tau0)
        sync()
        results["step_tau"]["ms"] = statistics.median(device_ms(lambda: cuda_step.step_tau(hum, state0, tau0), 20))
        tau_rr0 = (-60.0 * rr_start.s - 0.5 * rr_start.sd).contiguous()
        cuda_step.step_tau(hum_rr, rr_start, tau_rr0)
        sync()
        results["step_tau_relaxed_rigid"]["ms"] = statistics.median(
            device_ms(lambda: cuda_step.step_tau(hum_rr, rr_start, tau_rr0), 20))  # fmt: skip
        plain_ms = dict(
            rollout=wall_ms(lambda: cuda_rollout.rollout_reference(hum, state0, PLAIN_TIMED_STEPS["rollout"]))
            * HORIZON / PLAIN_TIMED_STEPS["rollout"],
            step_pd=wall_ms(lambda: [cuda_step.step_pd_reference(hum, state0) for _ in range(PLAIN_TIMED_STEPS["step_pd"])])
            / PLAIN_TIMED_STEPS["step_pd"],
            step_tau=wall_ms(lambda: [cuda_step.step_tau_reference(hum, state0, tau0)
                                      for _ in range(PLAIN_TIMED_STEPS["step_tau"])])
            / PLAIN_TIMED_STEPS["step_tau"],
            env_rollout=wall_ms(lambda: cuda_env_rollout.env_rollout_reference(
                hum, state0, PLAIN_TIMED_STEPS["env_rollout"], **ES_OPTIONS, **mlp))
            * ES["steps"] / PLAIN_TIMED_STEPS["env_rollout"],
        )  # fmt: skip
        # K4 at the gradient main paths' shapes, and the partials' sum.
        ct0 = vjp_cotangents(state0, vjp_gen)["all six"]
        n_vjp = PLAIN_TIMED_STEPS["step_vjp"]
        vjp_calls = dict(
            step_vjp=lambda: cuda_step_vjp.step_vjp(hum, state0, tau0, ct0),
            step_vjp_params_grad=lambda: cuda_step_vjp.step_vjp(hum, state0, tau0, ct0, params_grad=True),
            param_sum=lambda: cuda_step_vjp.sum_partials(hum, partials),
        )
        for name, call in vjp_calls.items():
            call()
            sync()
            results[name]["ms"] = statistics.median(device_ms(call, 20))
        # K4-rr at the relaxed-rigid gradient main paths' shapes, and its partials' sum.
        ct_rr0 = vjp_cotangents(rr_start, vjp_gen)["all six"]
        vjp_calls.update(
            step_vjp_relaxed_rigid=lambda: cuda_step_vjp.step_vjp(hum_rr, rr_start, tau_rr0, ct_rr0),
            step_vjp_relaxed_rigid_params_grad=lambda: cuda_step_vjp.step_vjp(hum_rr, rr_start, tau_rr0, ct_rr0,
                                                                              params_grad=True),
            param_sum_relaxed_rigid=lambda: cuda_step_vjp.sum_partials(hum_rr, rr_partials),
        )  # fmt: skip
        for name in ("step_vjp_relaxed_rigid", "step_vjp_relaxed_rigid_params_grad", "param_sum_relaxed_rigid"):
            vjp_calls[name]()
            sync()
            results[name]["ms"] = statistics.median(device_ms(vjp_calls[name], 20))
        garp_tau0 = case_tau("garpez", apg["start"])
        kernel_only = dict(
            step_pd=profiled_ms(lambda: cuda_step.step_pd(hum, state0), "step_pd_kernel", 10),
            step_tau=profiled_ms(lambda: cuda_step.step_tau(hum, state0, tau0), "step_tau_kernel", 10),
            step_tau_garpez=profiled_ms(lambda: cuda_step.step_tau(garp, apg["start"], garp_tau0), "step_tau_kernel", 10),
            step_vjp=profiled_ms(vjp_calls["step_vjp"], "step_vjp_kernel", 10),
            step_vjp_params_grad=profiled_ms(vjp_calls["step_vjp_params_grad"], "step_vjp_kernel", 10),
            param_sum=profiled_ms(vjp_calls["param_sum"], "param_sum_kernel", 10),
            step_pd_relaxed_rigid=profiled_ms(lambda: cuda_step.step_pd(hum_rr, rr_start), "rollout_rr_kernel", 10),
            step_tau_relaxed_rigid=profiled_ms(lambda: cuda_step.step_tau(hum_rr, rr_start, tau_rr0),
                                               "step_tau_rr_kernel", 10),
            step_vjp_relaxed_rigid=profiled_ms(vjp_calls["step_vjp_relaxed_rigid"], "step_vjp_rr_kernel", 10),
            step_vjp_relaxed_rigid_params_grad=profiled_ms(vjp_calls["step_vjp_relaxed_rigid_params_grad"],
                                                           "step_vjp_rr_kernel", 10),
            param_sum_relaxed_rigid=profiled_ms(vjp_calls["param_sum_relaxed_rigid"], "param_sum_kernel", 10),
        )
        library_kernel_only = dict(param_sum=profiled_ms(lambda: torch.sum(partials, 0), "", 10),
                                   param_sum_relaxed_rigid=profiled_ms(lambda: torch.sum(rr_partials, 0), "", 10))
        print(f"library kernel-only device ms a launch (torch.profiler, mean of 10): {json.dumps(library_kernel_only)}")
        print(f"kernel-only device ms a launch (torch.profiler, mean of 10): {json.dumps(kernel_only)}")
        event_ms = {k: results[k]["ms"] for k in kernel_only if k in results}
        event_ms["step_tau_garpez"] = statistics.median(device_ms(lambda: cuda_step.step_tau(garp, apg["start"], garp_tau0), 20))
        print(f"device ms a launch (CUDA events around the wrapper, median of 20; step_pd's over the per-step main"
              f" path's {PER_STEP_LAUNCHES} launches; step_tau_garpez is K3 at the APG start, B={APG['batch']}):"
              f" {json.dumps(event_ms)}")  # fmt: skip
        plain_ms.update(
            step_vjp=wall_ms(lambda: [cuda_step_vjp.step_vjp_reference(hum, state0, tau0, ct0) for _ in range(n_vjp)])
            / n_vjp,
            step_vjp_params_grad=wall_ms(lambda: [cuda_step_vjp.step_vjp_reference(
                hum, state0, tau0, ct0, params_grad=True) for _ in range(n_vjp)]) / n_vjp,
            param_sum=wall_ms(lambda: [cuda_step_vjp.sum_partials_reference(partials) for _ in range(20)]) / 20,
            param_sum_relaxed_rigid=wall_ms(lambda: [cuda_step_vjp.sum_partials_reference(rr_partials)
                                                     for _ in range(20)]) / 20,
        )  # fmt: skip
        n_rr = PLAIN_TIMED_STEPS["step_vjp_relaxed_rigid"]
        for name, pg in (("step_vjp_relaxed_rigid", False), ("step_vjp_relaxed_rigid_params_grad", True)):
            plain_ms[name] = wall_ms(lambda: [cuda_step_vjp.step_vjp_reference(
                hum_rr, rr_start, tau_rr0, ct_rr0, params_grad=pg) for _ in range(n_rr)]) / n_rr  # fmt: skip
        plain_ms["rollout_relaxed_rigid"] = wall_ms(lambda: cuda_rollout.rollout_reference(
            hum_rr, rr_start, PLAIN_TIMED_STEPS["rollout_relaxed_rigid"])) * RR_HORIZON / PLAIN_TIMED_STEPS[
            "rollout_relaxed_rigid"]  # fmt: skip
        n_rr = PLAIN_TIMED_STEPS["step_pd_relaxed_rigid"]
        plain_ms["step_pd_relaxed_rigid"] = wall_ms(lambda: [cuda_step.step_pd_reference(hum_rr, rr_start)
                                                             for _ in range(n_rr)]) / n_rr  # fmt: skip
        n_rr = PLAIN_TIMED_STEPS["step_tau_relaxed_rigid"]
        plain_ms["step_tau_relaxed_rigid"] = wall_ms(lambda: [cuda_step.step_tau_reference(hum_rr, rr_start, tau_rr0)
                                                              for _ in range(n_rr)]) / n_rr  # fmt: skip
        n_rr = PLAIN_TIMED_STEPS["env_rollout_relaxed_rigid"]
        plain_ms["env_rollout_relaxed_rigid"] = wall_ms(lambda: cuda_env_rollout.env_rollout_reference(
            hum_rr, rr_start, n_rr, **ES_OPTIONS, **mlp)) * ES["steps"] / n_rr  # fmt: skip
        for i in RK4_INTEGRATORS:
            for name, engine, start, horizon in ((f"rollout_{i}", hum_rk4[i], state0, SOFT_RK4_HORIZON),
                                                 (f"rollout_relaxed_rigid_{i}", hum_rr_rk4[i], rr_start, RR_RK4_HORIZON)):
                n_plain = PLAIN_TIMED_STEPS[name]
                plain_ms[name] = wall_ms(lambda: cuda_rollout.rollout_reference(engine, start, n_plain)) * horizon / n_plain
        # The probes' plain versions at their best configuration, over 256
        # iterations, scaled to T_LONG (K6's are K7 float32's).
        for v in fma_probe.VARIANTS:
            r = rates[f"bf16_probe_{v}"]
            x = fma_probe.make_input(v, r["n_threads"], device)
            plain_ms[f"bf16_probe_{v}"] = wall_ms(lambda: fma_probe.probe_reference(v, x, 256, r["chains"])) * (
                fma_probe.T_LONG / 256)  # fmt: skip
        plain_ms["fma_probe"] = plain_ms["bf16_probe_f32"]
        library_ms = dict(param_sum=statistics.median(device_ms(lambda: torch.sum(partials, 0), 20)),
                          param_sum_relaxed_rigid=statistics.median(device_ms(lambda: torch.sum(rr_partials, 0), 20)))
        print(f"plain ms for each kernel's launch (timed over {json.dumps(PLAIN_TIMED_STEPS)} steps): {json.dumps(plain_ms)}")
        print(f"library ms (one torch call, CUDA events, median of 20): {json.dumps(library_ms)}")

    # ----- bounds -----
    with phase("bounds"):
        cpu_hum = humanoid_engine("cpu")
        one = {k: v[0].cpu() for k, v in mlp.items()}
        flops = ops_per_env_step(cpu_hum, flagship_final, gens[-1]["final"], one, **ES_OPTIONS)
        print(f"float32 operations an env-step needs (twin under TorchDispatchMode, mean over {COUNT_ENVS} envs of"
              f" the flagship's and the last ES generation's final states): {json.dumps(flops)}")  # fmt: skip
        # K4's: the plain version's forward and transposed step, at the
        # policy-gradient main path's final state, its PD torques and the
        # timed random cotangent.
        vjp_state = cpu_head(grad_final)
        vjp_args = (vjp_state, -60.0 * vjp_state.s - 0.5 * vjp_state.sd, cpu_head(ct0))
        flops.update(
            vjp=flop_count.least_vjp_ops(cpu_hum, *vjp_args, COUNT_ENVS),
            vjp_params_grad=flop_count.least_vjp_ops(cpu_hum, *vjp_args, COUNT_ENVS, params_grad=True),
        )
        print(f"float32 operations an env's step VJP needs (the same count, over {COUNT_ENVS} envs of the policy"
              f" gradient's final state): {flops['vjp']}, with the model arrays' cotangents {flops['vjp_params_grad']}")
        cpu_hum_rr = rr_humanoid_engine("cpu")
        flops["rr_step"] = flop_count.least_step_ops(
            cpu_hum_rr, lambda st: cuda_rollout.rollout_reference(cpu_hum_rr, st, 1), cpu_head(rr_final)
        )
        flops["rr_env_step"] = flop_count.least_step_ops(cpu_hum_rr, lambda st: cuda_env_rollout.env_rollout_reference(
            cpu_hum_rr, st, 1, **one, **ES_OPTIONS), cpu_head(rr_gens[-1]["final"]))  # fmt: skip
        print(f"float32 operations a relaxed-rigid env-step needs (the same count, over {COUNT_ENVS} envs of the "
              f"relaxed-rigid main path's final state): {flops['rr_step']}; the relaxed-rigid env rollout's step, with "
              f"its policy, reward and reset selection (over the last relaxed-rigid ES generation's final state): "
              f"{flops['rr_env_step']}")  # fmt: skip
        # K4-rr's: the plain version's forward, implicit backward and
        # transposed step, at the relaxed-rigid policy gradient's final state,
        # its PD torques and the timed random cotangent.
        rr_vjp_state = cpu_head(rr_grad_final)
        rr_vjp_args = (rr_vjp_state, -60.0 * rr_vjp_state.s - 0.5 * rr_vjp_state.sd, cpu_head(ct_rr0))
        flops.update(
            rr_vjp=flop_count.least_vjp_ops(cpu_hum_rr, *rr_vjp_args, COUNT_ENVS),
            rr_vjp_params_grad=flop_count.least_vjp_ops(cpu_hum_rr, *rr_vjp_args, COUNT_ENVS, params_grad=True),
        )
        print(f"float32 operations a relaxed-rigid env's step VJP needs (the same count, over {COUNT_ENVS} envs of the"
              f" relaxed-rigid policy gradient's final state): {flops['rr_vjp']}, with the model arrays' cotangents"
              f" {flops['rr_vjp_params_grad']}")  # fmt: skip
        for i in RK4_INTEGRATORS:
            for kind, make in (("step", humanoid_engine), ("rr_step", rr_humanoid_engine)):
                cpu = make("cpu", i)
                final = rk4_finals[f"rollout_{i}" if kind == "step" else f"rollout_relaxed_rigid_{i}"]
                flops[f"{kind}_{i}"] = flop_count.least_step_ops(
                    cpu, lambda st: cuda_rollout.rollout_reference(cpu, st, 1), cpu_head(final))
        print(f"float32 operations an RK4 and an RK4-fast env-step need, soft and relaxed-rigid (the same count, over"
              f" {COUNT_ENVS} envs of each RK4 main path's final state): "
              + json.dumps({k: v for k, v in flops.items() if k.endswith(RK4_INTEGRATORS)}))  # fmt: skip
        sb, pb = state_bytes(hum, BATCH), 4 * cuda_build.packed_params(hum).numel()
        n_blocks, n_params = partials.shape
        vjp_bytes = 3 * sb + pb + 8 * n * BATCH  # state, tau, ct in; ct_state, ct_tau out
        rr_pb, (rr_rows, rr_n_params) = 4 * cuda_build.packed_params(hum_rr).numel(), rr_partials.shape
        rr_vjp_bytes = 3 * sb + rr_pb + 8 * n * BATCH
        work = dict(
            rollout=(flops["step"] * BATCH * HORIZON, 2 * sb + pb),
            step_pd=(flops["step"] * BATCH, 2 * sb + pb),
            step_tau=(flops["step"] * BATCH, 2 * sb + pb + 4 * n * BATCH),
            env_rollout=(flops["env_step"] * BATCH * ES["steps"],
                         2 * sb + pb + 12 * BATCH + 4 * pols["mlp"].packed().numel()),
            step_vjp=(flops["vjp"] * BATCH, vjp_bytes),
            step_vjp_params_grad=(flops["vjp_params_grad"] * BATCH, vjp_bytes + 4 * n_params),
            param_sum=((n_blocks - 1) * n_params, 4 * (n_blocks + 1) * n_params),
            step_vjp_relaxed_rigid=(flops["rr_vjp"] * BATCH, rr_vjp_bytes),
            step_vjp_relaxed_rigid_params_grad=(flops["rr_vjp_params_grad"] * BATCH, rr_vjp_bytes + rr_pb),
            param_sum_relaxed_rigid=((rr_rows - 1) * rr_n_params, 4 * (rr_rows + 1) * rr_n_params),
            rollout_relaxed_rigid=(flops["rr_step"] * BATCH * RR_HORIZON,
                                   2 * sb + 4 * cuda_build.packed_params(hum_rr).numel()),
            step_pd_relaxed_rigid=(flops["rr_step"] * BATCH, 2 * sb + 4 * cuda_build.packed_params(hum_rr).numel()),
            step_tau_relaxed_rigid=(flops["rr_step"] * BATCH,
                                    2 * sb + 4 * cuda_build.packed_params(hum_rr).numel() + 4 * n * BATCH),
            env_rollout_relaxed_rigid=(flops["rr_env_step"] * BATCH * ES["steps"],
                                       2 * sb + 4 * cuda_build.packed_params(hum_rr).numel() + 12 * BATCH
                                       + 4 * pols_rr["mlp"].packed().numel()),
            # The RK4 builds' start states and stage sums in device memory are
            # the design's own traffic, outside the bound.
            **{f"rollout_{i}": (flops[f"step_{i}"] * BATCH * SOFT_RK4_HORIZON, 2 * sb + pb) for i in RK4_INTEGRATORS},
            **{f"rollout_relaxed_rigid_{i}": (flops[f"rr_step_{i}"] * BATCH * RR_RK4_HORIZON,
                                              2 * sb + 4 * cuda_build.packed_params(hum_rr).numel())
               for i in RK4_INTEGRATORS},
        )  # fmt: skip
        peaks = {}
        for name in probe_names:
            r = rates[name]
            item = 4 if r["variant"] == "f32" else 2 * fma_probe.lanes(r["variant"])
            work[name] = (fma_probe.operations(r["variant"], r["n_threads"], r["chains"], fma_probe.T_LONG),
                          2 * item * r["n_threads"])  # fmt: skip
            peaks[name] = fma_probe.PEAK_FLOPS[r["variant"]]

    kernels = []
    for name in SOURCES:
        peak = peaks.get(name, PEAK_FLOPS)
        bound_ms, bound_by = bound(*work[name], peak)
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=results[name]["launches"], max_abs_err=max(max_errs[name]),
            ms=results[name]["ms"], plain_ms=plain_ms[name], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms.get(name),
        ))  # fmt: skip
        line = (f"{name}: {results[name]['ms']:.6g} ms a launch, bound {bound_ms:.6g} ms ({bound_by}), "
                f"{100 * bound_ms / results[name]['ms']:.3g} % of the bound")  # fmt: skip
        if bound_by == "operations":
            kind = "bf16" if peak != PEAK_FLOPS else "f32"
            measured_ms = work[name][0] / measured_peak[kind] * 1e3
            line += (f"; share of the data sheet's {peak / 1e12:g} TFLOP/s {100 * bound_ms / results[name]['ms']:.3g} %, "
                     f"of the measured {measured_peak[kind] / 1e12:.4g} {100 * measured_ms / results[name]['ms']:.3g} %")
        print(line)
    # K4's per-block partials are this design's own traffic: the function
    # (step_vjp_params_grad's bound) writes the batch sums once.
    pair_ms = results["step_vjp_params_grad"]["ms"] + results["param_sum"]["ms"]
    pair_bound, _ = bound(*work["step_vjp_params_grad"])
    print(f"model arrays' partials: {n_blocks} rows of {n_params} floats, {8 * n_blocks * n_params} B written and"
          f" read back ({8 * n_blocks * n_params / PEAK_BYTES * 1e3:.6g} ms at the memory rate), outside"
          f" step_vjp_params_grad's bound; it and param_sum together {pair_ms:.6g} ms a launch,"
          f" {100 * pair_bound / pair_ms:.3g} % of its bound")  # fmt: skip
    print(f"total: {time.perf_counter() - t_start:.2f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))  # fmt: skip
    return 0


if __name__ == "__main__":
    sys.exit(main())
