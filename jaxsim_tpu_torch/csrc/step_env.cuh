// The step body shared by the batched engine's CUDA kernels: one semi-
// implicit Euler step of one env, computed by one thread.
//
// It is the arithmetic of jaxsim_tpu/ops/batched_engine.py::BatchedEngine.step
// on flat ground with the three-pass articulated-body algorithm, the 6x6 base
// Cholesky and the SIE update, with Hunt/Crossley soft contacts. It is
// written after jaxsim_tpu_torch/ops/batched_engine.py (the plain version)
// line by line. The kernels that include it (rollout.cu, step.cu,
// env_rollout.cu, step_vjp.cu) differ in what surrounds the step: how many
// steps a launch takes, where the torques come from, and what happens between
// steps. The relaxed-rigid step (rr_step.cuh, built by rollout_rr.cu) takes
// its algebra, its Scalars and the packed layout from here.
//
// Conventions of every including kernel:
//  * jx_topology.h (generated per model topology by
//    jaxsim_tpu_torch/ops/cuda_build.py) makes sizes, loop bounds and the
//    parent/joint/contact tables compile-time constants.
//  * The model arrays (S, M, axis, lamH, sucH, cpoint) are packed in
//    BatchedEngine.PARAM_NAMES order, row-major, and copied into shared
//    memory once per block: every thread of a warp reads the same address,
//    so each read is a broadcast.
//  * The state keeps the env batch trailing, x[k * B + b], so thread b's
//    loads and stores are coalesced across the warp; the per-link working
//    set (Work, about 2.7 k floats for the humanoid) lives in local memory,
//    which is interleaved per thread and so coalesced too.
//  * IEEE float32 math (sqrtf, powf, sinf, cosf, true division), no
//    --use_fast_math, and the plain version's clamps, so a kernel tracks the
//    plain version to float32 roundoff.

#pragma once

#include <cuda_runtime.h>
#include <cfloat>

#include "jx_topology.h"  // JX_NL, JX_NJ, JX_NC, JX_FLOATING, JX_CONTACT, JX_RR_ITERS, JX_LAM, ...

namespace {

constexpr int NL = JX_NL;
constexpr int NJ = JX_NJ;
constexpr int NC = JX_NC;
constexpr int NJA = NJ > 0 ? NJ : 1;     // array sizes must be positive
constexpr int NCM = NC > 0 ? NC : 1;     // rows of the m state leaf
constexpr bool FLOATING = JX_FLOATING != 0;
constexpr bool RELAXED = JX_CONTACT == 1;  // relaxed-rigid contacts, else soft
constexpr int BLOCK = 32;  // threads a block: one warp

// Packed model arrays, in BatchedEngine.PARAM_NAMES order, row-major.
constexpr int OFF_S = 0;                          // (NL, 6)
constexpr int OFF_M = OFF_S + NL * 6;             // (NL, 6, 6)
constexpr int OFF_AXIS = OFF_M + NL * 36;         // (NJ, 3)
constexpr int OFF_LAMH = OFF_AXIS + NJ * 3;       // (1+NJ, 4, 4)
constexpr int OFF_SUCH = OFF_LAMH + (1 + NJ) * 16;  // (1+NJ, 4, 4)
constexpr int OFF_CP = OFF_SUCH + (1 + NJ) * 16;  // (NCM, 3)
constexpr int OFF_RRMINV = OFF_CP + NCM * 3;      // (NCM, 3, 3), relaxed-rigid only
constexpr int N_PARAMS = OFF_RRMINV + (RELAXED ? NCM * 9 : 0);
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

// One env's state, held by its thread.
struct Env {
  float s[NJA], sd[NJA], p[3], q[4], v[6], m[NCM * 3];
};

__device__ __forceinline__ void load_env(const StateIn& in, int B, int b, Env& e) {
  for (int k = 0; k < NJ; ++k) {
    e.s[k] = in.s[k * B + b];
    e.sd[k] = in.sd[k * B + b];
  }
  for (int k = 0; k < 3; ++k) e.p[k] = in.p[k * B + b];
  for (int k = 0; k < 4; ++k) e.q[k] = in.q[k * B + b];
  for (int k = 0; k < 6; ++k) e.v[k] = in.v[k * B + b];
  for (int k = 0; k < NCM * 3; ++k) e.m[k] = in.m[k * B + b];
}

__device__ __forceinline__ void store_env(const Env& e, int B, int b, const StateOut& out) {
  for (int k = 0; k < NJ; ++k) {
    out.s[k * B + b] = e.s[k];
    out.sd[k * B + b] = e.sd[k];
  }
  for (int k = 0; k < 3; ++k) out.p[k * B + b] = e.p[k];
  for (int k = 0; k < 4; ++k) out.q[k * B + b] = e.q[k];
  for (int k = 0; k < 6; ++k) out.v[k * B + b] = e.v[k];
  for (int k = 0; k < NCM * 3; ++k) out.m[k * B + b] = e.m[k];
}

// The packed model arrays into shared memory, by the whole block.
__device__ __forceinline__ void load_params(const float* params, float* P) {
  for (int k = threadIdx.x; k < N_PARAMS; k += blockDim.x) P[k] = params[k];
}

// Torque sources for step_env, passed by value. They read only what step_env
// holds already (the scalars and the state) or a pointer, so they add nothing
// to a kernel's stack frame when step_env is compiled as a call.
// The PD policy tau = -kp*s - kd*sd, read from the state before the step.
struct PdTau {
  __device__ float operator()(const Scalars& sc, const float* s, const float* sd, int k) const {
    return -sc.kp * s[k] - sc.kd * sd[k];
  }
};

// Torques held by the thread, tau[k] for joint k.
struct ArrayTau {
  const float* tau;
  __device__ float operator()(const Scalars&, const float*, const float*, int k) const {
    return tau[k];
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

struct Work {
  float WR[NL][9], Wp[NL][3], Wv[NL][6];  // world poses and velocities
  float iR[NL][9], ip[NL][3];             // child -> parent transforms
  float f[NL][6];                         // world contact wrenches per link
  float v[NL][6], c[NL][6], pA[NL][6], MA[NL][36], a[NL][6];
  float U[NL][6], d[NL], u[NL];
};

// One semi-implicit Euler step of one env, in place; the soft contact
// wrenches enter ABA pass 1. `tau(i)` gives the
// torque of joint i (0-based); it is called in ABA pass 2, before any state
// leaf changes, so a policy that reads s and sd sees the state before the step.
template <class Tau>
__device__ void step_env(const float* P, const Scalars& sc, Work& w, float* s, float* sd,
                         float* p, float* q, float* v, float* m, Tau tau_of) {
  // ----- forward kinematics -----
  {
    const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
    const float n = qw * qw + qx * qx + qy * qy + qz * qz;
    const float s2 = 2.0f / (n == 0.0f ? 1.0f : n);
    const float wx = s2 * qw * qx, wy = s2 * qw * qy, wz = s2 * qw * qz;
    const float xx = s2 * qx * qx, xy = s2 * qx * qy, xz = s2 * qx * qz;
    const float yy = s2 * qy * qy, yz = s2 * qy * qz, zz = s2 * qz * qz;
    const float RB[9] = {1.0f - (yy + zz), xy - wz, xz + wy,
                         xy + wz, 1.0f - (xx + zz), yz - wx,
                         xz - wy, yz + wx, 1.0f - (xx + yy)};
    float R0[9], p0[3], t[3];
    h_rot(P + OFF_SUCH, R0);
    h_pos(P + OFF_SUCH, p0);
    mm3(RB, R0, w.WR[0]);
    mv3(RB, p0, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) w.Wp[0][k] = p[k] + t[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) w.Wv[0][k] = FLOATING ? v[k] : 0.0f;
  }
#pragma unroll 1
  for (int i = 1; i < NL; ++i) {
    const int lam = JX_LAM[i];
    float rR[9], rp[3], t[3];
    relative_transform(P, i, s[i - 1], rR, rp);
    mm3(w.WR[lam], rR, w.WR[i]);
    mv3(w.WR[lam], rp, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) w.Wp[i][k] = w.Wp[lam][k] + t[k];
    // Inverse pair for the dynamics: (rR^T, -rR^T rp).
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) w.iR[i][r * 3 + cc] = rR[cc * 3 + r];
    mv3(w.iR[i], rp, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) w.ip[i][k] = -t[k];

    const float* S = P + OFF_S + i * 6;
    const float sdi = sd[i - 1];
    const float Sl[3] = {S[0] * sdi, S[1] * sdi, S[2] * sdi};
    const float Sa[3] = {S[3] * sdi, S[4] * sdi, S[5] * sdi};
    float RSa[3], RSl[3], cr[3];
    mv3(w.WR[i], Sa, RSa);
    mv3(w.WR[i], Sl, RSl);
    cross3(w.Wp[i], RSa, cr);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w.Wv[i][k] = w.Wv[lam][k] + (RSl[k] + cr[k]);
      w.Wv[i][k + 3] = w.Wv[lam][k + 3] + RSa[k];
    }
  }

  // ----- Hunt/Crossley soft contacts on flat ground (m updated in place) -----
#pragma unroll 1
  for (int i = 0; i < NL; ++i)
#pragma unroll
    for (int k = 0; k < 6; ++k) w.f[i][k] = 0.0f;
#pragma unroll 1
  for (int ci = 0; ci < NC; ++ci) {
    const int par = JX_CPARENT[ci];
    const float* Lp = P + OFF_CP + ci * 3;
    float pc[3], pd[3], t[3];
    mv3(w.WR[par], Lp, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) pc[k] = t[k] + w.Wp[par][k];
    cross3(w.Wv[par] + 3, pc, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) pd[k] = w.Wv[par][k] + t[k];

    float* mc = m + ci * 3;
    const HcLaw h = hc_law(sc, pc, pd, mc);
#pragma unroll
    for (int k = 0; k < 3; ++k) mc[k] = mc[k] + sc.dt * h.md[k];

    const float* f_lin = h.f_lin;
    float f_ang[3];
    cross3(pc, f_lin, f_ang);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w.f[par][k] += f_lin[k];
      w.f[par][k + 3] += f_ang[k];
    }
  }

  // ----- articulated-body algorithm -----
  const float* R0 = w.WR[0];
  const float* p0 = w.Wp[0];
  float R0i[9], p0i[3];
  {
    float t[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) R0i[r * 3 + cc] = R0[cc * 3 + r];
    mv3(R0i, p0, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) p0i[k] = -t[k];
  }
  const float g6[6] = {0.0f, 0.0f, sc.gz, 0.0f, 0.0f, 0.0f};

  // Pass 1: body velocities, bias accelerations and forces.
  if (FLOATING) {
    xv(R0i, p0i, v, w.v[0]);
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) w.v[0][k] = 0.0f;
  }
  {
    const float* M0 = P + OFF_M;
#pragma unroll
    for (int k = 0; k < 36; ++k) w.MA[0][k] = M0[k];
    float fb[6];
    vxstar_Mv(w.v[0], w.MA[0], w.pA[0]);
    if (JX_HASF[0]) {
      xtf(R0, p0, w.f[0], fb);
#pragma unroll
      for (int k = 0; k < 6; ++k) w.pA[0][k] -= fb[k];
    }
  }
#pragma unroll 1
  for (int i = 1; i < NL; ++i) {
    const int lam = JX_LAM[i];
    const float* S = P + OFF_S + i * 6;
    const float sdi = sd[i - 1];
    float vJ[6], t[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) vJ[k] = S[k] * sdi;
    xv(w.iR[i], w.ip[i], w.v[lam], t);
#pragma unroll
    for (int k = 0; k < 6; ++k) w.v[i][k] = t[k] + vJ[k];
    vx(w.v[i], vJ, w.c[i]);
    const float* Mi = P + OFF_M + i * 36;
#pragma unroll
    for (int k = 0; k < 36; ++k) w.MA[i][k] = Mi[k];
    vxstar_Mv(w.v[i], w.MA[i], w.pA[i]);
    if (JX_HASF[i]) {
      xtf(w.WR[i], w.Wp[i], w.f[i], t);
#pragma unroll
      for (int k = 0; k < 6; ++k) w.pA[i][k] -= t[k];
    }
  }

  // Pass 2: articulated inertias and bias forces, leaves to root.
#pragma unroll 1
  for (int i = NL - 1; i > 0; --i) {
    const int lam = JX_LAM[i];
    const float* S = P + OFF_S + i * 6;
    float* U = w.U[i];
    mv6(w.MA[i], S, U);
    float dd = 0.0f, sp = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      dd += S[k] * U[k];
      sp += S[k] * w.pA[i][k];
    }
    const float tau = tau_of(sc, s, sd, i - 1);
    w.d[i] = dd;
    w.u[i] = tau - sp;
    const float inv_d = 1.0f / dd;
    float Ma[36];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int cc = 0; cc < 6; ++cc) Ma[r * 6 + cc] = w.MA[i][r * 6 + cc] - U[r] * U[cc] * inv_d;
    float pa[6], t[6];
    mv6(Ma, w.c[i], t);
    const float ud = w.u[i] * inv_d;
#pragma unroll
    for (int k = 0; k < 6; ++k) pa[k] = w.pA[i][k] + t[k] + U[k] * ud;
    if (lam != 0 || FLOATING) {
      float X[36], MaX[36];
      build_X(w.iR[i], w.ip[i], X);
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < 6; ++k) acc += Ma[r * 6 + k] * X[k * 6 + cc];
          MaX[r * 6 + cc] = acc;
        }
#pragma unroll
      for (int r = 0; r < 6; ++r) {
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < 6; ++k) acc += X[k * 6 + r] * MaX[k * 6 + cc];
          w.MA[lam][r * 6 + cc] += acc;
        }
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) acc += X[k * 6 + r] * pa[k];
        w.pA[lam][r] += acc;
      }
    }
  }

  // Pass 3: accelerations, root to leaves.
  if (FLOATING) {
    float x[6];
    chol6_solve(w.MA[0], w.pA[0], x);
#pragma unroll
    for (int k = 0; k < 6; ++k) w.a[0][k] = -x[k];
  } else {
    float t[6];
    xv(R0i, p0i, g6, t);
#pragma unroll
    for (int k = 0; k < 6; ++k) w.a[0][k] = -t[k];
  }
  float sdd[NJA];
#pragma unroll 1
  for (int i = 1; i < NL; ++i) {
    const int lam = JX_LAM[i];
    const float* S = P + OFF_S + i * 6;
    float a_i[6];
    xv(w.iR[i], w.ip[i], w.a[lam], a_i);
    float ua = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      a_i[k] += w.c[i][k];
      ua += w.U[i][k] * a_i[k];
    }
    const float sddi = (w.u[i] - ua) / w.d[i];
    sdd[i - 1] = sddi;
#pragma unroll
    for (int k = 0; k < 6; ++k) w.a[i][k] = a_i[k] + S[k] * sddi;
  }
  float W_a[6];
  if (FLOATING) {
    xv(R0, p0, w.a[0], W_a);
#pragma unroll
    for (int k = 0; k < 6; ++k) W_a[k] += g6[k];
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) W_a[k] = 0.0f;
  }

  // ----- semi-implicit Euler -----
  const float dt = sc.dt;
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = v[k] + dt * W_a[k];
#pragma unroll 1
  for (int k = 0; k < NJ; ++k) {
    sd[k] = sd[k] + dt * sdd[k];
    s[k] = s[k] + dt * sd[k];
  }
  // The position update uses the NEW linear velocity and the OLD p.
  float wp[3];
  cross3(v + 3, p, wp);
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = p[k] + dt * (v[k] + wp[k]);
  const float ox = v[3], oy = v[4], oz = v[5];
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  float qn[4] = {qw + dt * (0.5f * (-qx * ox - qy * oy - qz * oz)),
                 qx + dt * (0.5f * (qw * ox - qy * oz + qz * oy)),
                 qy + dt * (0.5f * (qw * oy + qx * oz - qz * ox)),
                 qz + dt * (0.5f * (qw * oz - qx * oy + qy * ox))};
  const float nq = sqrtf(fmaxf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3], 1e-12f));
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = qn[k] / nq;
}

}  // namespace
