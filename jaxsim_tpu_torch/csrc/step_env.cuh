// The algebra shared by the batched engine's CUDA kernels, for one env.
//
// It is the arithmetic of jaxsim_tpu/ops/batched_engine.py::BatchedEngine.step
// on flat ground with the three-pass articulated-body algorithm, the 6x6 base
// Cholesky and the SIE update, with Hunt/Crossley soft contacts, in pieces:
// the small dense algebra, the joint transforms, the Cholesky solve and the
// contact law (hc_law on flat ground; hc_terrain_law on an inclined plane or
// Fourier terrain, JX_TERRAIN, and with the env's domain multipliers and
// terrain offset, JX_DOMAIN and JX_TERR_OFF); and what the rollouts' RK4
// steps (JX_INTEGRATOR 1 and 2) add:
// the quaternion's rate with its Baumgarte term, and an entry's stage and
// accumulator update. It is written after jaxsim_tpu_torch/ops/batched_engine.py
// (the plain version) line by line. The lane-spread soft step
// (soft_step_lanes.cuh: K1's rollout.cu, K2's and K3's step.cu, K5's
// env_rollout.cu, K4's step_vjp.cu) and the relaxed-rigid step (rr_step.cuh,
// built by rollout_rr.cu) take its algebra, hc_law, its Scalars, the state's
// device layout and the packed layout from here.
//
// Conventions of every including kernel:
//  * jx_topology.h (generated per model topology by
//    jaxsim_tpu_torch/ops/cuda_build.py) makes sizes, loop bounds and the
//    parent/joint/contact tables compile-time constants.
//  * The model arrays (S, M, axis, lamH, sucH, cpoint) are packed in
//    BatchedEngine.PARAM_NAMES order, row-major, and copied into shared
//    memory once per block: every thread of a warp reads the same address,
//    so each read is a broadcast.
//  * The state keeps the env batch trailing, x[k * B + b], so the loads and
//    stores of consecutive envs are coalesced across a warp.
//  * IEEE float32 math (sqrtf, powf, sinf, cosf, true division), no
//    --use_fast_math and no __sinf/__cosf (a Fourier terrain's arguments reach
//    hundreds of radians under a per-env terrain offset, where the fast
//    intrinsics' error grows with the argument), and the plain version's
//    clamps, so a kernel tracks the plain version to float32 roundoff.

#pragma once

#include <cuda_runtime.h>
#include <cfloat>

#include "jx_topology.h"  // JX_NL, JX_NJ, JX_NC, JX_FLOATING, JX_CONTACT, JX_RR_ITERS, JX_INTEGRATOR, JX_LAM, ...

#ifndef JX_INTEGRATOR
#define JX_INTEGRATOR 0
#endif
// The terrain (0 flat ground, 1 an inclined or raised plane, 2 Fourier
// terrain of JX_TERR_K components), the plane's unit normal JX_TERR_N* and
// offset JX_TERR_H (n.p = H on the plane; h0 of a Fourier terrain), and the
// per-env options of the rollouts: the domain multipliers (JX_DOMAIN)
// and the terrain offset (JX_TERR_OFF). The generated header defines them
// for a build that takes them only.
#ifndef JX_TERRAIN
#define JX_TERRAIN 0
#endif
#ifndef JX_TERR_K
#define JX_TERR_K 0
#endif
#ifndef JX_TERR_NX
#define JX_TERR_NX 0.0f
#define JX_TERR_NY 0.0f
#define JX_TERR_NZ 1.0f
#endif
#ifndef JX_TERR_H
#define JX_TERR_H 0.0f
#endif
#ifndef JX_DOMAIN
#define JX_DOMAIN 0
#endif
#ifndef JX_TERR_OFF
#define JX_TERR_OFF 0
#endif

namespace {

constexpr int NL = JX_NL;
constexpr int NJ = JX_NJ;
constexpr int NC = JX_NC;
constexpr int NJA = NJ > 0 ? NJ : 1;     // array sizes must be positive
constexpr int NCM = NC > 0 ? NC : 1;     // rows of the m state leaf
constexpr bool FLOATING = JX_FLOATING != 0;
constexpr bool RELAXED = JX_CONTACT == 1;  // relaxed-rigid contacts, else soft
// 0 semi-implicit Euler; 1 RK4; 2 RK4-fast (RK4 with the contact forces and
// m's rate frozen at the step's start).
constexpr int INTEGRATOR = JX_INTEGRATOR;
static_assert(INTEGRATOR >= 0 && INTEGRATOR <= 2, "JX_INTEGRATOR is 0, 1 or 2");
constexpr int TERRAIN = JX_TERRAIN;
constexpr int TERR_K = JX_TERR_K;
constexpr bool DOMAIN = JX_DOMAIN != 0;
constexpr bool TERR_OFF = JX_TERR_OFF != 0;
static_assert(TERRAIN >= 0 && TERRAIN <= 2 && (TERRAIN == 2) == (TERR_K > 0), "JX_TERRAIN is 0, 1 or 2");
static_assert(!TERR_OFF || TERRAIN == 2, "a terrain offset translates a Fourier terrain");

// Packed model arrays, in BatchedEngine.PARAM_NAMES order, row-major.
constexpr int OFF_S = 0;                          // (NL, 6)
constexpr int OFF_M = OFF_S + NL * 6;             // (NL, 6, 6)
constexpr int OFF_AXIS = OFF_M + NL * 36;         // (NJ, 3)
constexpr int OFF_LAMH = OFF_AXIS + NJ * 3;       // (1+NJ, 4, 4)
constexpr int OFF_SUCH = OFF_LAMH + (1 + NJ) * 16;  // (1+NJ, 4, 4)
constexpr int OFF_CP = OFF_SUCH + (1 + NJ) * 16;  // (NCM, 3)
constexpr int OFF_RRMINV = OFF_CP + NCM * 3;      // (NCM, 3, 3), relaxed-rigid only
// (NCM, 3, 3): the nominal Delassus blocks of the block-Jacobi PCG, a
// relaxed-rigid engine's on Fourier terrain only.
constexpr int OFF_RRKC = OFF_RRMINV + (RELAXED ? NCM * 9 : 0);
constexpr int OFF_TERR = OFF_RRKC + (RELAXED && TERRAIN == 2 ? NCM * 9 : 0);  // (4, TERR_K): amp, kx, ky, phase
constexpr int N_PARAMS = OFF_TERR + 4 * TERR_K;
static_assert(N_PARAMS * 4 <= 48 * 1024, "model arrays exceed static shared memory");

// The relaxed-rigid tail (rr_*) is zero for a soft engine, and the kernels
// built only for soft engines leave it out of their aggregate initializers.
// See cuda_build.rr_scalars for its entries.
struct Scalars {
  float K, D, k_over_d, mu, hc_p, hc_q, gz, dt, kp, kd;
  float rr_ca, rr_cb, rr_mid, rr_power, rr_width, rr_dmin, rr_dmax, rr_span, rr_stiff, rr_damp,
      rr_c2mu2, rr_c1mu2, rr_reg;
};

// The six state leaves of a batch, each (rows, B) with the batch trailing.
struct StateIn {
  const float *s, *sd, *p, *q, *v, *m;
};
struct StateOut {
  float *s, *sd, *p, *q, *v, *m;
};

// A relaxed-rigid RK4 rollout's rows in device memory: the step's start state
// y0 and the accumulator k1 + 2 k2 + 2 k3 + k4, entry e of env b at [e * stride + b].
// The stride is at least the launch's envs, so that an env past the batch
// (which runs env B - 1's steps) has columns of its own.
struct Rk4Scratch {
  float* y0;
  float* acc;
  int stride;
};

// The packed model arrays into shared memory, by the whole block.
__device__ __forceinline__ void load_params(const float* params, float* P) {
  for (int k = threadIdx.x; k < N_PARAMS; k += blockDim.x) P[k] = params[k];
}

// The PD policy tau = -kp*s - kd*sd, read from the state before the step (a
// torque source of rr_step_env, passed by value).
struct PdTau {
  __device__ float operator()(const Scalars& sc, const float* s, const float* sd, int k) const {
    return -sc.kp * s[k] - sc.kd * sd[k];
  }
};

// ----- small dense algebra; 3x3 and 6x6 matrices are row-major -----

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void mm3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = A[i * 3 + 0] * B[0 * 3 + j] + A[i * 3 + 1] * B[1 * 3 + j] +
                     A[i * 3 + 2] * B[2 * 3 + j];
}

__device__ __forceinline__ void mv3(const float* A, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = A[i * 3 + 0] * v[0] + A[i * 3 + 1] * v[1] + A[i * 3 + 2] * v[2];
}

__device__ __forceinline__ void mtv3(const float* A, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = A[0 * 3 + i] * v[0] + A[1 * 3 + i] * v[1] + A[2 * 3 + i] * v[2];
}

// 3x3 block of a row-major 4x4 homogeneous transform, and its translation.
__device__ __forceinline__ void h_rot(const float* H, float* R) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i * 3 + j] = H[i * 4 + j];
}

__device__ __forceinline__ void h_pos(const float* H, float* p) {
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = H[i * 4 + 3];
}

// Motion transform [[R, p^R],[0, R]] applied to a 6-vector (linear first).
__device__ __forceinline__ void xv(const float* R, const float* p, const float* v, float* o) {
  float Ra[3], Rl[3], c[3];
  mv3(R, v + 3, Ra);
  mv3(R, v, Rl);
  cross3(p, Ra, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = Rl[i] + c[i];
    o[i + 3] = Ra[i];
  }
}

// Force co-transform X^T f: [R^T f_l ; R^T (f_a - p x f_l)].
__device__ __forceinline__ void xtf(const float* R, const float* p, const float* f, float* o) {
  float c[3], t[3];
  cross3(p, f, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = f[i + 3] - c[i];
  mtv3(R, f, o);
  mtv3(R, t, o + 3);
}

// Motion cross product v x w.
__device__ __forceinline__ void vx(const float* v, const float* w, float* o) {
  float a[3], b[3], c[3];
  cross3(v + 3, w, a);
  cross3(v, w + 3, b);
  cross3(v + 3, w + 3, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = a[i] + b[i];
    o[i + 3] = c[i];
  }
}

__device__ __forceinline__ void mv6(const float* M, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) acc += M[i * 6 + j] * v[j];
    o[i] = acc;
  }
}

// v x* (M v): [w x f_l ; v x f_l + w x f_a] with f = M v.
__device__ __forceinline__ void vxstar_Mv(const float* v, const float* M, float* o) {
  float f[6], a[3], b[3], c[3];
  mv6(M, v, f);
  cross3(v + 3, f, a);
  cross3(v, f, b);
  cross3(v + 3, f + 3, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = a[i];
    o[i + 3] = b[i] + c[i];
  }
}

// The index of entry (r, c) of a symmetric 6x6 matrix's lower triangle,
// row by row.
__device__ __forceinline__ int tri(int r, int c) { return r >= c ? r * (r + 1) / 2 + c : c * (c + 1) / 2 + r; }

// The motion subspace times a joint velocity, and the bias c = v x vJ.
__device__ __forceinline__ void joint_bias(const float* S, float sdi, const float* v, float* c) {
  float vJ[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) vJ[k] = S[k] * sdi;
  vx(v, vJ, c);
}

// The base's world rotation RB from its quaternion (the twin's fk).
__device__ __forceinline__ void quat_rot(const float* q, float* RB) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float n = qw * qw + qx * qx + qy * qy + qz * qz;
  const float s2 = 2.0f / (n == 0.0f ? 1.0f : n);
  const float wx = s2 * qw * qx, wy = s2 * qw * qy, wz = s2 * qw * qz;
  const float xx = s2 * qx * qx, xy = s2 * qx * qy, xz = s2 * qx * qz;
  const float yy = s2 * qy * qy, yz = s2 * qy * qz, zz = s2 * qz * qz;
  RB[0] = 1.0f - (yy + zz), RB[1] = xy - wz, RB[2] = xz + wy;
  RB[3] = xy + wz, RB[4] = 1.0f - (xx + zz), RB[5] = yz - wx;
  RB[6] = xz - wy, RB[7] = yz + wx, RB[8] = 1.0f - (xx + yy);
}

// Explicit 6x6 adjoint [[R, p^ R],[0, R]].
__device__ __forceinline__ void build_X(const float* R, const float* p, float* X) {
  const float px[9] = {0.0f, -p[2], p[1], p[2], 0.0f, -p[0], -p[1], p[0], 0.0f};
  float pR[9];
  mm3(px, R, pR);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      X[i * 6 + j] = R[i * 3 + j];
      X[i * 6 + j + 3] = pR[i * 3 + j];
      X[(i + 3) * 6 + j] = 0.0f;
      X[(i + 3) * 6 + j + 3] = R[i * 3 + j];
    }
}

// The Cholesky factor L (row-major, lower) of an SPD 6x6 M, unrolled.
__device__ __forceinline__ void chol6_factor(const float* M, float* L) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = M[i * 6 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i * 6 + k] * L[i * 6 + k];
    L[i * 6 + i] = sqrtf(fmaxf(s, 1e-12f));
    const float inv_d = 1.0f / L[i * 6 + i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) {
      float t = M[j * 6 + i];
#pragma unroll
      for (int k = 0; k < i; ++k) t -= L[j * 6 + k] * L[i * 6 + k];
      L[j * 6 + i] = t * inv_d;
    }
  }
}

// Forward and backward substitution with a chol6_factor factor: x = M^-1 b.
__device__ __forceinline__ void chol6_substitute(const float* L, const float* b, float* x) {
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i * 6 + k] * y[k];
    y[i] = s / L[i * 6 + i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k * 6 + i] * x[k];
    x[i] = s / L[i * 6 + i];
  }
}

// Solve M x = b for an SPD 6x6 M by an unrolled Cholesky factorization.
__device__ __forceinline__ void chol6_solve(const float* M, const float* b, float* x) {
  float L[36];
  chol6_factor(M, L);
  chol6_substitute(L, b, x);
}

// Parent -> child transform of joint j (= child link j) at position th:
// lamH_pre * joint(th) * sucH.
__device__ void relative_transform(const float* P, int j, float th, float* R, float* p) {
  const float* lamH = P + OFF_LAMH + j * 16;
  const float* sucH = P + OFF_SUCH + j * 16;
  float Rj[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float pj[3] = {0.0f, 0.0f, 0.0f};
  const int jt = JX_JTYPE[j];
  if (jt == 1) {  // revolute: Rodrigues about the joint axis
    const float* a = P + OFF_AXIS + (j - 1) * 3;
    const float K[9] = {0.0f, -a[2], a[1], a[2], 0.0f, -a[0], -a[1], a[0], 0.0f};
    float K2[9];
    mm3(K, K, K2);
    const float sn = sinf(th), omc = 1.0f - cosf(th);
#pragma unroll
    for (int k = 0; k < 9; ++k) Rj[k] = Rj[k] + sn * K[k] + omc * K2[k];
  } else if (jt == 2) {  // prismatic
    const float* a = P + OFF_AXIS + (j - 1) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) pj[k] = a[k] * th;
  }
  float R1[9], p1[3], R2[9], p2[3], Ra[9], t[3];
  h_rot(lamH, R1);
  h_pos(lamH, p1);
  h_rot(sucH, R2);
  h_pos(sucH, p2);
  mm3(R1, Rj, Ra);
  mv3(R1, pj, t);
  float pa[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) pa[k] = p1[k] + t[k];
  mm3(Ra, R2, R);
  mv3(Ra, p2, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = pa[k] + t[k];
}

// The Hunt/Crossley law of one point on flat ground, from its world position
// pc and velocity pd and its m row: the linear force f_lin, m's rate md, and
// the intermediates and branch flags that K4's reverse sweep (step_vjp.cu)
// reads, so that the backward takes the branch the forward took.
struct HcLaw {
  float delta, delta_dot, Kdp, Ddq, arg, fn, mu_fn, f_t_sq, norm, mn, scale;
  float v_t[3], m_t[3], f_t[3], f_s[3], f_lin[3], md[3];
  bool no_contact, sticking;
};

__device__ __forceinline__ HcLaw hc_law(const Scalars& sc, const float* pc, const float* pd, const float* mc) {
  HcLaw h;
  h.delta = fmaxf(0.0f, -pc[2]);
  h.delta_dot = h.delta > 0.0f ? -pd[2] : 0.0f;
  const float dp = powf(h.delta + FLT_EPSILON, sc.hc_p);
  const float dq = powf(h.delta + FLT_EPSILON, sc.hc_q);
  h.Kdp = sc.K * dp, h.Ddq = sc.D * dq;
  h.arg = h.Kdp * h.delta + h.Ddq * h.delta_dot;
  h.fn = fmaxf(0.0f, h.arg);
  const float m_n[3] = {0.0f, 0.0f, mc[2]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    h.v_t[k] = k < 2 ? pd[k] : 0.0f;
    h.m_t[k] = k < 2 ? mc[k] : 0.0f;
    h.f_t[k] = -(h.Kdp * h.m_t[k] + h.Ddq * h.v_t[k]);
  }
  h.f_t_sq = h.f_t[0] * h.f_t[0] + h.f_t[1] * h.f_t[1] + h.f_t[2] * h.f_t[2];
  h.no_contact = h.delta <= 0.0f;
  h.mu_fn = sc.mu * h.fn;
  h.sticking = h.no_contact || h.f_t_sq <= h.mu_fn * h.mu_fn;
  // f_s: f_t scaled into the friction cone where the point slips, 0 where it
  // is out of contact; scale is 1 where it sticks.
  h.norm = 1.0f, h.mn = 0.0f, h.scale = 1.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) h.f_s[k] = h.f_t[k];
  if (!h.sticking) {
    h.norm = sqrtf(fmaxf(h.f_t_sq, FLT_EPSILON * FLT_EPSILON));
    h.mn = fminf(h.mu_fn, h.norm);
    h.scale = h.mn / h.norm;
#pragma unroll
    for (int k = 0; k < 3; ++k) h.f_s[k] = h.f_t[k] * h.scale;
  }
  if (h.no_contact) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      h.f_s[k] = 0.0f;
      h.md[k] = -sc.k_over_d * mc[k];
    }
  } else if (h.sticking) {
#pragma unroll
    for (int k = 0; k < 3; ++k) h.md[k] = h.v_t[k] - sc.k_over_d * m_n[k];
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) h.md[k] = -(h.f_s[k] + h.Kdp * h.m_t[k]) / h.Ddq;
  }
  h.f_lin[0] = h.f_s[0];
  h.f_lin[1] = h.f_s[1];
  h.f_lin[2] = h.f_s[2] + h.fn;
  return h;
}

// ----- terrain and per-env domain -----

// An env's domain multipliers (JX_DOMAIN) and terrain offset (JX_TERR_OFF),
// which a rollout's lanes load once a launch and keep in registers (a
// relaxed-rigid step reads gmul, Mmul and the offset).
struct EnvDomain {
  float Kmul, Dmul, mumul, gmul, Mmul, ox, oy;
};

// A launch's per-env rows in device memory: the multipliers Kmul, Dmul,
// mumul, gmul, Mmul (5 rows of B) and the terrain offset (2 rows of B), each
// null where the build takes none.
struct DomainRows {
  const float* mul;
  const float* off;
};

// Env b's EnvDomain (1 and 0 where the build takes no multipliers or offset).
__device__ __forceinline__ EnvDomain load_domain(const DomainRows& r, int B, int b) {
  EnvDomain d{1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 0.0f, 0.0f};
  if constexpr (DOMAIN) {
    d.Kmul = r.mul[b], d.Dmul = r.mul[B + b], d.mumul = r.mul[2 * B + b];
    d.gmul = r.mul[3 * B + b], d.Mmul = r.mul[4 * B + b];
  }
  if constexpr (TERR_OFF) d.ox = r.off[b], d.oy = r.off[B + b];
  return d;
}

// The Fourier terrain's height h0 + sum a sin(kx x + ky y + ph) and its
// gradient at (x, y), the components summed in order as the twin sums them.
// The argument is rounded at each product and sum (no FMA contraction), as
// the plain version rounds it: it reaches hundreds of radians, where one
// contraction moves it by 1e-5.
__device__ __forceinline__ void fourier_height_grad(const float* T, float x, float y, float& h, float& dhx,
                                                    float& dhy) {
  h = 0.0f, dhx = 0.0f, dhy = 0.0f;
#pragma unroll
  for (int k = 0; k < TERR_K; ++k) {
    const float a = T[k], kx = T[TERR_K + k], ky = T[2 * TERR_K + k], ph = T[3 * TERR_K + k];
    const float arg = __fadd_rn(__fadd_rn(__fmul_rn(kx, x), __fmul_rn(ky, y)), ph);
    const float sn = sinf(arg), cs = cosf(arg);
    h = h + a * sn;
    const float c = a * cs;
    dhx = dhx + kx * c;
    dhy = dhy + ky * c;
  }
  h = JX_TERR_H + h;
}

// The Fourier terrain's height at (x, y), the env's terrain offset already
// taken off (K5's terrain-relative base height).
__device__ __forceinline__ float fourier_height(const float* P, float x, float y) {
  float h, dhx, dhy;
  fourier_height_grad(P + OFF_TERR, x, y, h, dhx, dhy);
  return h;
}

// What hc_terrain_law gives: the point's linear force and m's rate.
struct TerrainLaw {
  float f_lin[3], md[3];
};

// The Hunt/Crossley law of one point on the build's terrain, with the env's
// multipliers: the twin's soft_contact_forces off flat ground (and on flat
// ground with multipliers, which its normal (0, 0, 1) reduces to hc_law's
// arithmetic). The plane's static normal, or the Fourier terrain's analytic
// normal at the point's (x - ox, y - oy); the penetration delta = max(0,
// offset - n.p) on the plane, max(0, (h - z) n_z) on Fourier terrain; v and
// m split along the normal; K, D, K/D and mu the env's. hc_law itself stays
// flat ground's: K4's reverse sweep reads its HcLaw fields.
__device__ __forceinline__ TerrainLaw hc_terrain_law(const float* P, const Scalars& sc, const EnvDomain& dom,
                                                     const float* pc, const float* pd, const float* mc) {
  float n[3], delta, ndotv;
  if constexpr (TERRAIN == 2) {
    float h, dhx, dhy;
    const float x = TERR_OFF ? pc[0] - dom.ox : pc[0], y = TERR_OFF ? pc[1] - dom.oy : pc[1];
    fourier_height_grad(P + OFF_TERR, x, y, h, dhx, dhy);
    const float inv_n = 1.0f / sqrtf(dhx * dhx + dhy * dhy + 1.0f);
    n[0] = -dhx * inv_n, n[1] = -dhy * inv_n, n[2] = inv_n;
    ndotv = n[0] * pd[0] + n[1] * pd[1] + n[2] * pd[2];
    delta = fmaxf(0.0f, (h - pc[2]) * n[2]);
  } else {
    n[0] = JX_TERR_NX, n[1] = JX_TERR_NY, n[2] = JX_TERR_NZ;
    ndotv = n[0] * pd[0] + n[1] * pd[1] + n[2] * pd[2];
    delta = fmaxf(0.0f, JX_TERR_H - (n[0] * pc[0] + n[1] * pc[1] + n[2] * pc[2]));
  }
  const float delta_dot = delta > 0.0f ? -ndotv : 0.0f;
  const float K = DOMAIN ? sc.K * dom.Kmul : sc.K, D = DOMAIN ? sc.D * dom.Dmul : sc.D;
  const float mu = DOMAIN ? sc.mu * dom.mumul : sc.mu, k_over_d = DOMAIN ? K / D : sc.k_over_d;
  const float Kdp = K * powf(delta + FLT_EPSILON, sc.hc_p), Ddq = D * powf(delta + FLT_EPSILON, sc.hc_q);
  const float fn = fmaxf(0.0f, Kdp * delta + Ddq * delta_dot);
  const float mdotn = n[0] * mc[0] + n[1] * mc[1] + n[2] * mc[2];
  float v_t[3], m_n[3], m_t[3], f_t[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v_t[k] = pd[k] - ndotv * n[k];
    m_n[k] = mdotn * n[k];
    m_t[k] = mc[k] - m_n[k];
    f_t[k] = -(Kdp * m_t[k] + Ddq * v_t[k]);
  }
  const float f_t_sq = f_t[0] * f_t[0] + f_t[1] * f_t[1] + f_t[2] * f_t[2];
  const bool no_contact = delta <= 0.0f;
  const float mu_fn = mu * fn;
  const bool sticking = no_contact || f_t_sq <= mu_fn * mu_fn;
  if (!sticking) {
    const float norm = sqrtf(fmaxf(f_t_sq, FLT_EPSILON * FLT_EPSILON));
    const float scale = fminf(mu_fn, norm) / norm;
#pragma unroll
    for (int k = 0; k < 3; ++k) f_t[k] = f_t[k] * scale;
  }
  TerrainLaw out;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (no_contact) {
      f_t[k] = 0.0f;
      out.md[k] = -k_over_d * mc[k];
    } else if (sticking) {
      out.md[k] = v_t[k] - k_over_d * m_n[k];
    } else {
      out.md[k] = -(f_t[k] + Kdp * m_t[k]) / Ddq;
    }
    out.f_lin[k] = f_t[k] + fn * n[k];
  }
  return out;
}

// ----- the RK4 step's pieces (the twin's _rk4_step and derivatives) -----

// One entry of an RK4 step after stage `stage` (0..3) gave its rate k: the
// accumulator (k1, then + 2 k2, + 2 k3, + k4: the twin's k1 + 2 k2 + 2 k3 + k4
// in its order of sums) and the entry's next value, the next stage's state
// y0 + c dt k (c = 1/2, 1/2, 1), or after the last stage the new state
// y0 + dt (acc / 6).
__device__ __forceinline__ float rk4_entry(int stage, float dt, float k, float y0, float& acc) {
  acc = stage == 0 ? k : acc + (stage == 3 ? k : 2.0f * k);
  if (stage < 3) return y0 + (stage < 2 ? 0.5f * dt : dt) * k;
  return y0 + dt * (acc / 6.0f);
}

// The base quaternion's rate in the RK4 derivative: 1/2 [0, w] (x) q with
// inertial-fixed w, plus the Baumgarte norm stabilization 1/2 K |w| (1 - |q|) q
// with K = 1.
__device__ __forceinline__ void quat_rate(const float* q, const float* w, float* qd) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float ox = w[0], oy = w[1], oz = w[2];
  const float nw = sqrtf(fmaxf(ox * ox + oy * oy + oz * oz, 1e-14f));
  const float nq = sqrtf(fmaxf(qw * qw + qx * qx + qy * qy + qz * qz, 1e-14f));
  const float r = 0.5f * (nw * (1.0f - nq));
  qd[0] = 0.5f * (-qx * ox - qy * oy - qz * oz) + r * qw;
  qd[1] = 0.5f * (qw * ox - qy * oz + qz * oy) + r * qx;
  qd[2] = 0.5f * (qw * oy + qx * oz - qz * ox) + r * qy;
  qd[3] = 0.5f * (qw * oz - qx * oy + qy * ox) + r * qz;
}

// q <- q / |q| (the RK4 step's, at its start and its end); `q` indexes four
// entries (an array, or a column of a slot).
template <class Q>
__device__ __forceinline__ void quat_normalize(const Q& q) {
  const float n = sqrtf(fmaxf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], 1e-12f));
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
}

}  // namespace
