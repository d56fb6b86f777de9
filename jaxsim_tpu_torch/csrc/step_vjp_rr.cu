// The fused backward of one relaxed-rigid engine step (K4-rr): K3-rr's
// geometry, each env on JX_RR_LANES lanes of a warp, the contact solves on
// its lanes and the transposed step on one thread an env, with a tape in
// device memory.
//
// Replaces, for relaxed-rigid engines, _step_vjp_kernel of
// jaxsim_tpu/ops/pallas_step.py (built by build_pallas_step_vjp), which
// traces jax.vjp of the engine step inside the kernel and so differentiates
// the contact solve through its hand-written implicit VJP (pcg_implicit,
// pcg_fwd, pcg_bwd of jaxsim_tpu/ops/batched_engine.py). Here the transposed
// step is written by hand from the math, as the twin's _PcgImplicit
// (jaxsim_tpu_torch/ops/batched_engine.py) computes it. For a state, torques
// tau and a cotangent of the output state, one launch
//  1. recomputes the step's forward: the free ABA on the ABA thread
//     (rr_free_step, rr_step.cuh), whose working set RrWork stays in the
//     thread's local memory as the free ABA's tape, and the warm-started PCG
//     on the env's lanes (rr_setup, rr_cg), whose solved forces x go to the
//     tape;
//  2. on the ABA thread: the substitution of the solved forces a_cont =
//     M^-1 J^T x (link by link, the twin's _minv_apply) and the transposed
//     semi-implicit Euler update with the quaternion's renormalization; then
//     x's cotangent: the transposed substitution at the base's and joints'
//     acceleration cotangents, through the scatter, plus m's update
//     m + dt ((x - m) / dt);
//  3. on the env's lanes: lambda = PCG(x-bar) from zero, rr_cg on the same
//     operator and preconditioner;
//  4. on the ABA thread, per point: b-bar = -lambda through the free point
//     acceleration, the reference acceleration, the impedance and delta;
//     <-lambda, A(theta) x>'s cotangents through the gather, the
//     regularizer r_j and rrMinv; then one transposed pass 3, base solve and
//     pass 2 of the articulated-body algorithm for both chains that share the
//     factorization (the free ABA, and the substitution of x, which also
//     carries the operator's term: the scatter of act x is the scatter of x,
//     x being 0 on inactive points); the scatter's transpose; and pass 1 and
//     the kinematics, leaves to root.
// The preconditioner and the warm start get no cotangent, so state.m's
// cotangent comes from m's update alone. Derivatives at a tie of max/min
// are JAX's (max_grad): half to each side.
//
// With JX_PARAMS_GRAD each env adds its model-array cotangents, rrMinv's
// included, into a row of its own in device memory, and param_sum_kernel
// (param_sum.cuh, K4's) adds the rows in a fixed order: two runs agree to
// the bit.
//
// What bounds it on the card: per-env latency, not HBM. The state, tau and
// the cotangents cross device memory once each way (about 21 MB for the
// humanoid at 8192 envs, 6 us at 3.35 TB/s), and its least operations take
// 7.5 us at the float32 peak (PERF.md); the tape (13 KB an env for the
// humanoid) is written and read by its own thread. This first design runs
// the transposed step on one thread an env, 1/JX_RR_LANES of the block's
// threads, as K3-rr runs its free ABA: simple and right before fast.

#include "rr_step.cuh"

#ifndef JX_PARAMS_GRAD
#define JX_PARAMS_GRAD 0
#endif

static_assert(INTEGRATOR == 0, "step_vjp_rr.cu implements semi-implicit Euler (JX_INTEGRATOR 0)");
static_assert(JX_RR_TAU_ROW, "step_vjp_rr.cu takes the torques in the slot's torque row (JX_RR_TAU_ROW 1)");

#include "vjp_algebra.cuh"
#include "param_sum.cuh"

namespace {

constexpr bool PARAMS_GRAD = JX_PARAMS_GRAD != 0;

// An env's column of the tape in device memory: row j at base[j * stride].
struct Col {
  float* base;
  int stride;
  __device__ __forceinline__ float& operator[](int j) const { return base[static_cast<size_t>(j) * stride]; }
};

// The tape's rows, an env's column.
constexpr int T_X = 0;                 // (NC, 3) the solved forces x
constexpr int T_L = T_X + NC * 3;      // (NC, 3) x's cotangent, then lambda
constexpr int T_PA0 = T_L + NC * 3;    // (NL, 6) the substitution's bias forces, accumulated
constexpr int T_U0 = T_PA0 + NL * 6;   // (NL) its u
constexpr int T_A0 = T_U0 + NL;        // (NL, 6) its link accelerations (a_cont)
constexpr int T_GAF = T_A0 + NL * 6;   // (NL, 6) adjoint of the free ABA's a
constexpr int T_GA0 = T_GAF + NL * 6;  // (NL, 6) adjoint of the substitution's a
constexpr int T_GU = T_GA0 + NL * 6;   // (NL, 2) adjoints of u: free, substitution
constexpr int T_GUD = T_GU + NL * 2;   // (NL, 7) adjoints of U and d
constexpr int T_GC = T_GUD + NL * 7;   // (NL, 6) adjoint of c
constexpr int T_GX = T_GC + NL * 6;    // (NL, 12) adjoints of the child -> parent pair (iR, ip)
constexpr int T_GMA = T_GX + NL * 12;  // (NL, 36) adjoint of MA
constexpr int T_GPF = T_GMA + NL * 36; // (NL, 6) adjoint of the free ABA's pA
constexpr int T_GP0 = T_GPF + NL * 6;  // (NL, 6) adjoint of the substitution's pA
constexpr int T_GW = T_GP0 + NL * 6;   // (NL, 18) adjoints of the world pose and velocity: WR, Wp, Wv
constexpr int T_GV = T_GW + NL * 18;   // (NL, 6) adjoint of v
constexpr int TAPE_ROWS = T_GV + NL * 6;

__device__ __forceinline__ void col_ld(Col t, int off, int n, float* o) {
  for (int k = 0; k < n; ++k) o[k] = t[off + k];
}
__device__ __forceinline__ void col_st(Col t, int off, int n, const float* x) {
  for (int k = 0; k < n; ++k) t[off + k] = x[k];
}
__device__ __forceinline__ void col_add(Col t, int off, int n, const float* x) {
  for (int k = 0; k < n; ++k) t[off + k] += x[k];
}
__device__ __forceinline__ void col_zero(Col t, int off, int n) {
  for (int k = 0; k < n; ++k) t[off + k] = 0.0f;
}

// An env's row of model-array cotangents in device memory (null without
// params_grad, and for an env past the batch).
struct EnvAcc {
  float* row;
  __device__ __forceinline__ void add(int off, float x) const {
    if (PARAMS_GRAD && row) row[off] += x;
  }
  __device__ __forceinline__ void add(int off, int n, const float* x) const {
    for (int k = 0; k < n; ++k) add(off + k, x[k]);
  }
};

// The pair (iR, ip) of link i from the slot.
__device__ __forceinline__ void load_pair(Slot sl, int i, float* iR, float* ip) {
  load_vec(sl, SL_IR + i * 9, 6, iR);
  load_vec(sl, SL_IR + i * 9 + 6, 3, iR + 6);
  load_vec(sl, SL_IP + i * 3, 3, ip);
}

// The substitution of the solved forces x (the tape's X rows), the twin's
// _minv_apply on the free ABA's factorization with the link forces of
// _rr_scatter: its bias forces, u and link accelerations to the tape.
__device__ void rr_subst_forward(const float* P, const RrWork& w, Slot sl, Col t) {
  col_zero(t, T_PA0, NL * 6);
#pragma unroll 1
  for (int c = 0; c < NC; ++c) {
    const int par = JX_CPARENT[c];
    const float* Lp = P + OFF_CP + c * 3;
    float xc[3], f[6];
    col_ld(t, T_X + c * 3, 3, xc);
    mtv3(w.WR[par], xc, f);
    cross3(Lp, f, f + 3);
#pragma unroll
    for (int k = 0; k < 6; ++k) t[T_PA0 + par * 6 + k] -= f[k];
  }
#pragma unroll 1
  for (int i = NL - 1; i > 0; --i) {
    const float* S = P + OFF_S + i * 6;
    float pA[6], sp = 0.0f;
    col_ld(t, T_PA0 + i * 6, 6, pA);
#pragma unroll
    for (int k = 0; k < 6; ++k) sp += S[k] * pA[k];
    const float u = -sp;
    t[T_U0 + i] = u;
    if (JX_LAM[i] != 0 || FLOATING) {
      float U[6], iR[9], ip[3], pa[6], o[6];
      load_vec(sl, SL_U + i * 6, 6, U);
      load_pair(sl, i, iR, ip);
      const float ud = u / sl[SL_D + i];
#pragma unroll
      for (int k = 0; k < 6; ++k) pa[k] = pA[k] + U[k] * ud;
      xtf(iR, ip, pa, o);
      col_add(t, T_PA0 + JX_LAM[i] * 6, 6, o);
    }
  }
  float a0[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (FLOATING) {
    float L[36], pA[6], x[6];
#pragma unroll
    for (int k = 0; k < 36; ++k) L[k] = sl[SL_L0 + k];
    col_ld(t, T_PA0, 6, pA);
    chol6_substitute(L, pA, x);
#pragma unroll
    for (int k = 0; k < 6; ++k) a0[k] = -x[k];
  }
  col_st(t, T_A0, 6, a0);
#pragma unroll 1
  for (int i = 1; i < NL; ++i) {
    const float* S = P + OFF_S + i * 6;
    float al[6], ai[6], U[6], iR[9], ip[3];
    col_ld(t, T_A0 + JX_LAM[i] * 6, 6, al);
    load_pair(sl, i, iR, ip);
    load_vec(sl, SL_U + i * 6, 6, U);
    xv(iR, ip, al, ai);
    float ua = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) ua += U[k] * ai[k];
    const float sdd = (t[T_U0 + i] - ua) / sl[SL_D + i];
#pragma unroll
    for (int k = 0; k < 6; ++k) t[T_A0 + i * 6 + k] = ai[k] + S[k] * sdd;
  }
}

// The cotangent of the substituted link forces for the cotangents of the
// link accelerations in the GA0 rows and of the joint accelerations `bsdd`
// (the linear part of the substitution's transpose): -pA's adjoint, in the
// GP0 rows. Uses the GA0 and GU rows as scratch.
__device__ void rr_subst_force_vjp(const float* P, Slot sl, Col t, const float* bsdd) {
#pragma unroll 1
  for (int i = NL - 1; i > 0; --i) {
    const float* S = P + OFF_S + i * 6;
    float ga[6], U[6], iR[9], ip[3], o[6];
    col_ld(t, T_GA0 + i * 6, 6, ga);
    load_vec(sl, SL_U + i * 6, 6, U);
    load_pair(sl, i, iR, ip);
    float b = bsdd[i - 1];
#pragma unroll
    for (int k = 0; k < 6; ++k) b += S[k] * ga[k];
    const float bd = b / sl[SL_D + i];
    t[T_GU + i * 2 + 1] = bd;
#pragma unroll
    for (int k = 0; k < 6; ++k) ga[k] -= U[k] * bd;
    xtf(iR, ip, ga, o);
    col_add(t, T_GA0 + JX_LAM[i] * 6, 6, o);
  }
  float gp[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (FLOATING) {
    float L[36], ga[6], y[6];
#pragma unroll
    for (int k = 0; k < 36; ++k) L[k] = sl[SL_L0 + k];
    col_ld(t, T_GA0, 6, ga);
    chol6_substitute(L, ga, y);
#pragma unroll
    for (int k = 0; k < 6; ++k) gp[k] = -y[k];
  }
  col_st(t, T_GP0, 6, gp);
#pragma unroll 1
  for (int i = 1; i < NL; ++i) {
    const float* S = P + OFF_S + i * 6;
    float gpa[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float bu = t[T_GU + i * 2 + 1];
    if (JX_LAM[i] != 0 || FLOATING) {
      float iR[9], ip[3], gl[6], U[6];
      load_pair(sl, i, iR, ip);
      col_ld(t, T_GP0 + JX_LAM[i] * 6, 6, gl);
      xv(iR, ip, gl, gpa);
      load_vec(sl, SL_U + i * 6, 6, U);
      float ug = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) ug += U[k] * gpa[k];
      bu += ug / sl[SL_D + i];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) t[T_GP0 + i * 6 + k] = gpa[k] - S[k] * bu;
  }
}

// The free point kinematics of point c (parent link par): its world
// position pc and velocity pd, the parent's angular velocity om.
__device__ __forceinline__ void point_kin(const float* P, const RrWork& w, int c, int par, float* pc, float* pd,
                                          float* om) {
  const float* Lp = P + OFF_CP + c * 3;
  float t[3];
  mv3(w.WR[par], Lp, t);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    pc[j] = t[j] + w.Wp[par][j];
    om[j] = w.Wv[par][j + 3];
  }
  cross3(om, pc, t);
#pragma unroll
  for (int j = 0; j < 3; ++j) pd[j] = w.Wv[par][j] + t[j];
}

// The transpose of the gather Rp (a_lin + a_ang x Lp) at the point's
// cotangent bo: the link-frame acceleration cotangent `ga` (added), and
// Rp's and Lp's (added).
__device__ __forceinline__ void gather_vjp(const float* Rp, const float* Lp, const float* a, const float* bo,
                                           float* ga, float* gR, float* gL) {
  float u[3], t[3], bu[3] = {0.0f, 0.0f, 0.0f};
  cross3(a + 3, Lp, t);
#pragma unroll
  for (int j = 0; j < 3; ++j) u[j] = a[j] + t[j];
  mv3_vjp(Rp, u, bo, gR, bu);
#pragma unroll
  for (int j = 0; j < 3; ++j) ga[j] += bu[j];
  cross3_vjp(a + 3, Lp, bu, ga + 3, gL);
}

// d/dxi of (1 - xi) / (xi + 1e-12), as autograd forms it.
__device__ __forceinline__ float ratio_grad(float xi) {
  const float den = xi + 1e-12f;
  return -1.0f / den - (1.0f - xi) / (den * den);
}

// Part 2 on the ABA thread: the substitution of x, the transposed SIE update
// and x's cotangent into the tape's L rows; m's cotangent out. Leaves in the
// tape what part 4 reads, and returns the base acceleration's cotangent
// `ga0`, the base pose's `gW0` (WR0, Wp0), the new base velocity's `bvn`,
// q's and p's (`bq`, `bp`) and the joint accelerations' `bsdd`.
__device__ void rr_vjp_x_bar(const float* P, const Scalars& sc, const RrWork& w, Slot sl, Col t, const float* q,
                             const float* p, const float* v, const StateIn& ct, int B, int b, float* out_m, bool valid,
                             float* ga0, float* gW0, float* bvn, float* bq, float* bp, float* bsdd) {
  const float dt = sc.dt;
  rr_subst_forward(P, w, sl, t);
  // The new base velocity v + dt W_a, W_a = X0 (a_free0 + a_cont0) + g.
  float a0[6], vn[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) a0[k] = w.a[0][k] + t[T_A0 + k];
  if (FLOATING) {
    float W_a[6];
    xv(w.WR[0], w.Wp[0], a0, W_a);
    W_a[2] += sc.gz;
#pragma unroll
    for (int k = 0; k < 6; ++k) vn[k] = v[k] + dt * W_a[k];
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) vn[k] = v[k];
  }

  // ----- semi-implicit Euler with the quaternion's renormalization -----
#pragma unroll
  for (int k = 0; k < 6; ++k) bvn[k] = ct.v[k * B + b];
  {
    // q' = qn / sqrt(max(|qn|^2, 1e-12)), qn = q + dt (0.5 Omega(w') q).
    const float ox = vn[3], oy = vn[4], oz = vn[5];
    const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
    const float qn[4] = {qw + dt * (0.5f * (-qx * ox - qy * oy - qz * oz)),
                         qx + dt * (0.5f * (qw * ox - qy * oz + qz * oy)),
                         qy + dt * (0.5f * (qw * oy + qx * oz - qz * ox)),
                         qz + dt * (0.5f * (qw * oz - qx * oy + qy * ox))};
    const float n2 = qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3];
    const float nq = sqrtf(fmaxf(n2, 1e-12f));
    float dot = 0.0f, bqn[4], cq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cq[k] = ct.q[k * B + b];
      bqn[k] = cq[k] / nq;
      dot += qn[k] * cq[k];
    }
    const float bn2 = -dot / (nq * nq) * (0.5f / nq) * max_grad(n2, 1e-12f);
#pragma unroll
    for (int k = 0; k < 4; ++k) bqn[k] += 2.0f * qn[k] * bn2;
    const float h = 0.5f * dt;
    bq[0] = bqn[0] + h * (bqn[1] * ox + bqn[2] * oy + bqn[3] * oz);
    bq[1] = bqn[1] + h * (-bqn[0] * ox + bqn[2] * oz - bqn[3] * oy);
    bq[2] = bqn[2] + h * (-bqn[0] * oy - bqn[1] * oz + bqn[3] * ox);
    bq[3] = bqn[3] + h * (-bqn[0] * oz + bqn[1] * oy - bqn[2] * ox);
    bvn[3] += h * (-bqn[0] * qx + bqn[1] * qw - bqn[2] * qz + bqn[3] * qy);
    bvn[4] += h * (-bqn[0] * qy + bqn[1] * qz + bqn[2] * qw - bqn[3] * qx);
    bvn[5] += h * (-bqn[0] * qz - bqn[1] * qy + bqn[2] * qx + bqn[3] * qw);
  }
  {
    // p' = p + dt (v'_l + w' x p).
    float dcp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      bp[k] = ct.p[k * B + b];
      dcp[k] = dt * bp[k];
      bvn[k] += dcp[k];
    }
    cross3_vjp(vn + 3, p, dcp, bvn + 3, bp);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) ga0[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < 12; ++k) gW0[k] = 0.0f;
  if (FLOATING) {
    float bWa[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) bWa[k] = dt * bvn[k];
    xv_vjp(w.WR[0], w.Wp[0], a0, bWa, gW0, gW0 + 9, ga0);
  }
  // s' = s + dt sd', sd' = sd + dt sdd.
#pragma unroll 1
  for (int k = 0; k < NJ; ++k) bsdd[k] = dt * (ct.sd[k * B + b] + dt * ct.s[k * B + b]);

  // ----- x's cotangent: the substitution's transpose, the scatter's, m's update -----
  col_zero(t, T_GA0, NL * 6);
  col_st(t, T_GA0, 6, ga0);
  rr_subst_force_vjp(P, sl, t, bsdd);
#pragma unroll 1
  for (int c = 0; c < NC; ++c) {
    const int par = JX_CPARENT[c];
    const float* Lp = P + OFF_CP + c * 3;
    // f = [y ; Lp x y], y = Rp^T x; pA = -f.
    float gf[6], by[3], bx[3];
#pragma unroll
    for (int k = 0; k < 6; ++k) gf[k] = -t[T_GP0 + par * 6 + k];
#pragma unroll
    for (int j = 0; j < 3; ++j) by[j] = gf[j];
    cross3_vjp(Lp, by, gf + 3, nullptr, by);  // by is read before it is added to
    mv3(w.WR[par], by, bx);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      // m' = m + dt md, md = (x - m) / dt.
      const float cm = ct.m[(c * 3 + j) * B + b];
      const float bmd = dt * cm;
      t[T_L + c * 3 + j] = bx[j] + bmd / dt;
      if (valid) out_m[(c * 3 + j) * B] = cm - bmd / dt;
    }
  }
}

// Part 4 on the ABA thread, after lambda is in the tape's L rows: every
// remaining cotangent, out to the state's, tau's and (with params_grad) the
// env's row of model arrays.
__device__ void rr_vjp_rest(const float* P, const Scalars& sc, const RrWork& w, Slot sl, Col t, const float* s,
                            const float* sd, const float* q, const float* v, const StateIn& ct, int B, int b,
                            const StateOut& out, float* ct_tau, bool valid, const EnvAcc& acc, const float* ga0,
                            const float* gW0, const float* bvn, const float* bq_in, const float* bp_in,
                            const float* bsdd) {
  const float dt = sc.dt;
  // The accumulators: the link-acceleration cotangents of both chains, the
  // world pose and velocity's, v's.
  col_zero(t, T_GAF, NL * 6);
  col_zero(t, T_GA0, NL * 6);
  col_zero(t, T_GW, NL * 18);
  col_zero(t, T_GV, NL * 6);
  col_zero(t, T_GUD, NL * 7);
  col_zero(t, T_GX, NL * 12);
  col_zero(t, T_GC, NL * 6);
  col_zero(t, T_GMA, NL * 36);
  col_st(t, T_GAF, 6, ga0);
  col_st(t, T_GA0, 6, ga0);
  col_st(t, T_GW, 12, gW0);

  // ----- (a) per point: b-bar = -lambda, and <-lambda, A(theta) x> -----
  const float nh[3] = {0.0f, 0.0f, 1.0f};
#pragma unroll 1
  for (int c = 0; c < NC; ++c) {
    const int par = JX_CPARENT[c];
    const float* Lp = P + OFF_CP + c * 3;
    const float* Rp = w.WR[par];
    float pc[3], pd[3], om[3];
    point_kin(P, w, c, par, pc, pd, om);
    const float delta = fmaxf(-pc[2], 0.0f);
    const float act = delta > 0.0f ? 1.0f : 0.0f;
    float lam[3], xc[3];
    col_ld(t, T_L + c * 3, 3, lam);
    col_ld(t, T_X + c * 3, 3, xc);
    float xi[3], xx[3], y[3], z[3], coeff[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      xx[j] = delta * fabsf(nh[j]) / sc.rr_width;
      const float ya = sc.rr_ca * rr_pow(xx[j], sc.rr_power);
      const float yb = 1.0f - sc.rr_cb * rr_pow(fmaxf(1.0f - xx[j], 0.0f), sc.rr_power);
      y[j] = xx[j] < sc.rr_mid ? ya : yb;
      z[j] = sc.rr_dmin + y[j] * sc.rr_span;
      float xj = fminf(fmaxf(z[j], sc.rr_dmin), sc.rr_dmax);
      xi[j] = xx[j] > 1.0f ? sc.rr_dmax : xj;
      coeff[j] = (sc.rr_c2mu2 * (1.0f - xi[j]) / (xi[j] + 1e-12f)) * sc.rr_c1mu2;
    }
    const float* Mi = P + OFF_RRMINV + c * 9;
    // neg_b's cotangent is lambda: b_j = act (pdd_j - aref_j).
    float bo[3], baref[3], br[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      bo[j] = -act * lam[j];
      baref[j] = act * lam[j];
      br[j] = -lam[j] * xc[j];  // <-lambda, (r + reg) x>
    }
    float gR[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gL[3] = {0.0f, 0.0f, 0.0f};
    float gp[3] = {0.0f, 0.0f, 0.0f}, gpd[3] = {0.0f, 0.0f, 0.0f}, gom[3] = {0.0f, 0.0f, 0.0f};
    {
      // The operator's gather, act Rp (a_c_lin + a_c_ang x Lp), at -act lambda,
      // and the free point acceleration's, pdd = Rp (a_lin + a_ang x Lp) + w x pd + g.
      float ac[6], af[6], g0[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gf[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      col_ld(t, T_A0 + par * 6, 6, ac);
#pragma unroll
      for (int k = 0; k < 6; ++k) af[k] = w.a[par][k];
      gather_vjp(Rp, Lp, ac, bo, g0, gR, gL);
      gather_vjp(Rp, Lp, af, bo, gf, gR, gL);
      col_add(t, T_GA0 + par * 6, 6, g0);
      col_add(t, T_GAF + par * 6, 6, gf);
      cross3_vjp(om, pd, bo, gom, gpd);
    }
    // r_j = act (sum_i coeff_i Minv[i][j] + h_j Minv[j][j]), h_j = (1 - xi_j) / (xi_j + 1e-12).
    float bxi[3] = {0.0f, 0.0f, 0.0f}, bcoeff[3] = {0.0f, 0.0f, 0.0f};
    float gM[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float b = act * br[j];
      const float h = (1.0f - xi[j]) / (xi[j] + 1e-12f);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        bcoeff[i] += b * Mi[i * 3 + j];
        gM[i * 3 + j] += b * coeff[i];
      }
      gM[j * 4] += b * h;
      bxi[j] += b * Mi[j * 4] * ratio_grad(xi[j]);
    }
    acc.add(OFF_RRMINV + c * 9, 9, gM);
    // coeff_i = (2 mu^2 (1 - xi_i) / (xi_i + 1e-12)) (1 + mu^2)
#pragma unroll
    for (int i = 0; i < 3; ++i) bxi[i] += bcoeff[i] * sc.rr_c1mu2 * sc.rr_c2mu2 * ratio_grad(xi[i]);
    // aref_j = -(damp pd_j + stiff xi_j pos_j), pos_j = -delta n_j.
    float bdelta = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float pos = -delta * nh[j];
      gpd[j] += -sc.rr_damp * baref[j];
      bxi[j] += -sc.rr_stiff * pos * baref[j];
      bdelta += -nh[j] * (-sc.rr_stiff * xi[j] * baref[j]);
    }
    // xi_j = x_j > 1 ? d_max : clip(d_min + y_j span, d_min, d_max)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (xx[j] > 1.0f) continue;
      const float zc = fmaxf(z[j], sc.rr_dmin);
      const float bz = bxi[j] * max_grad(sc.rr_dmax, zc) * max_grad(z[j], sc.rr_dmin);
      const float by = bz * sc.rr_span;
      float bx;
      if (xx[j] < sc.rr_mid) {
        bx = by * sc.rr_ca * sc.rr_power * (sc.rr_power == 2.0f ? xx[j] : powf(xx[j], sc.rr_power - 1.0f));
      } else {
        const float om1 = fmaxf(1.0f - xx[j], 0.0f);
        const float dw = sc.rr_power == 2.0f ? om1 : powf(om1, sc.rr_power - 1.0f);
        bx = -by * sc.rr_cb * sc.rr_power * dw * -max_grad(1.0f - xx[j], 0.0f);
      }
      bdelta += bx * fabsf(nh[j]) / sc.rr_width;
    }
    // delta = max(-pc_z, 0)
    gp[2] += -bdelta * max_grad(-pc[2], 0.0f);
    // pd = v_l + w x pc, pc = Rp Lp + p (of the parent link).
    float gw[18];
#pragma unroll
    for (int k = 0; k < 18; ++k) gw[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gw[12 + j] += gpd[j];
      gw[15 + j] += gom[j];
    }
    cross3_vjp(om, pc, gpd, gw + 15, gp);
#pragma unroll
    for (int j = 0; j < 3; ++j) gw[9 + j] += gp[j];
    mv3_vjp(Rp, Lp, gp, gR, gL);
#pragma unroll
    for (int k = 0; k < 9; ++k) gw[k] += gR[k];
    col_add(t, T_GW + par * 18, 18, gw);
    acc.add(OFF_CP + c * 3, 3, gL);
  }

  // ----- (b) pass 3 of both chains, leaves to root -----
#pragma unroll 1
  for (int i = NL - 1; i > 0; --i) {
    const int lam = JX_LAM[i];
    const float* S = P + OFF_S + i * 6;
    float U[6], iR[9], ip[3], gU[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gS[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float gX[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    load_vec(sl, SL_U + i * 6, 6, U);
    load_pair(sl, i, iR, ip);
    const float d = sl[SL_D + i];
#pragma unroll 1
    for (int chain = 0; chain < 2; ++chain) {
      // chain 0: the free ABA (a_i = X a_lam + c); 1: the substitution.
      const int GA = chain == 0 ? T_GAF : T_GA0;
      float al[6], ai[6], ga[6], u;
      if (chain == 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) al[k] = w.a[lam][k];
        u = w.u[i];
      } else {
        col_ld(t, T_A0 + lam * 6, 6, al);
        u = t[T_U0 + i];
      }
      xv(iR, ip, al, ai);
      if (chain == 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) ai[k] += w.c[i][k];
      }
      float ua = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) ua += U[k] * ai[k];
      const float sdd = (u - ua) / d;
      col_ld(t, GA + i * 6, 6, ga);
      float bs = bsdd[i - 1];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        bs += S[k] * ga[k];
        gS[k] += sdd * ga[k];
      }
      const float bu = bs / d;
      t[T_GU + i * 2 + chain] = bu;
      gU[6] += -bs * sdd / d;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        gU[k] += -bu * ai[k];
        ga[k] -= bu * U[k];  // now ai's cotangent
      }
      if (chain == 0) col_st(t, T_GC + i * 6, 6, ga);
      xv_vjp(iR, ip, al, ga, gX, gX + 9, nullptr);
      float o[6];
      xtf(iR, ip, ga, o);
      col_add(t, GA + lam * 6, 6, o);
    }
    col_st(t, T_GUD + i * 7, 7, gU);
    col_st(t, T_GX + i * 12, 12, gX);
    acc.add(OFF_S + i * 6, 6, gS);
  }
  // The base: a0 = -MA0^-1 pA0 by the Cholesky of MA0's lower triangle
  // (both chains), or a0 = -X0^-1 g (the free ABA of a fixed base).
  float bR0i[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, bp0i[3] = {0.0f, 0.0f, 0.0f};
  float R0i[9], p0i[3];
  {
    float tt[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) R0i[r * 3 + cc] = w.WR[0][cc * 3 + r];
    mv3(R0i, w.Wp[0], tt);
#pragma unroll
    for (int k = 0; k < 3; ++k) p0i[k] = -tt[k];
  }
  {
    float gMA0[36];
#pragma unroll
    for (int k = 0; k < 36; ++k) gMA0[k] = 0.0f;
    float gpf[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gp0[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (FLOATING) {
      float L[36];
#pragma unroll
      for (int k = 0; k < 36; ++k) L[k] = sl[SL_L0 + k];
#pragma unroll 1
      for (int chain = 0; chain < 2; ++chain) {
        float ga[6], bx[6], y[6], a0[6];
        col_ld(t, chain == 0 ? T_GAF : T_GA0, 6, ga);
        if (chain == 0) {
#pragma unroll
          for (int k = 0; k < 6; ++k) a0[k] = w.a[0][k];
        } else {
          col_ld(t, T_A0, 6, a0);
        }
#pragma unroll
        for (int k = 0; k < 6; ++k) bx[k] = -ga[k];
        chol6_substitute(L, bx, y);
        float* gp = chain == 0 ? gpf : gp0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          gp[i] = y[i];
          const float xi = -a0[i];
          gMA0[i * 6 + i] += -y[i] * xi;
#pragma unroll
          for (int j = 0; j < i; ++j) gMA0[i * 6 + j] += -(y[i] * -a0[j] + y[j] * xi);
        }
      }
    } else {
      const float g6[6] = {0.0f, 0.0f, sc.gz, 0.0f, 0.0f, 0.0f};
      float ga[6];
      col_ld(t, T_GAF, 6, ga);
#pragma unroll
      for (int k = 0; k < 6; ++k) ga[k] = -ga[k];
      xv_vjp(R0i, p0i, g6, ga, bR0i, bp0i, nullptr);
    }
    col_st(t, T_GMA, 36, gMA0);
    col_st(t, T_GPF, 6, gpf);
    col_st(t, T_GP0, 6, gp0);
  }

  // ----- (c) pass 2 of both chains (the articulated inertias shared), root to leaves -----
#pragma unroll 1
  for (int i = 1; i < NL; ++i) {
    const int lam = JX_LAM[i];
    const float* S = P + OFF_S + i * 6;
    float U[6], iR[9], ip[3], gU[7], Ma[36], bMa[36], pf[6], p0[6];
    load_vec(sl, SL_U + i * 6, 6, U);
    load_pair(sl, i, iR, ip);
    col_ld(t, T_GUD + i * 7, 7, gU);
    const float d = sl[SL_D + i];
    const float inv_d = 1.0f / d;
    const float uf = w.u[i], u0 = t[T_U0 + i];
    float buf = t[T_GU + i * 2], bu0 = t[T_GU + i * 2 + 1];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int cc = 0; cc < 6; ++cc) Ma[r * 6 + cc] = w.MA[i][r * 6 + cc] - U[r] * U[cc] * inv_d;
    // The chains' pa: pA + Ma c + U (u inv_d) (free), pA + U (u / d) (substitution).
    float paf[6], pa0[6];
    {
      float tt[6];
      mv6(Ma, w.c[i], tt);
      const float ud = uf * inv_d, ud0 = u0 / d;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        pf[k] = w.pA[i][k];
        p0[k] = t[T_PA0 + i * 6 + k];
        paf[k] = pf[k] + tt[k] + U[k] * ud;
        pa0[k] = p0[k] + U[k] * ud0;
      }
    }
#pragma unroll
    for (int k = 0; k < 36; ++k) bMa[k] = 0.0f;
    float bpaf[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, bpa0[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (lam != 0 || FLOATING) {
      // MA_lam += X^T Ma X, pA_lam += X^T pa (each chain).
      float X[36], XbO[36], XbOt[36], bO[36], bpf[6], bp0[6], bX[36];
      col_ld(t, T_GMA + lam * 36, 36, bO);
      col_ld(t, T_GPF + lam * 6, 6, bpf);
      col_ld(t, T_GP0 + lam * 6, 6, bp0);
      build_X(iR, ip, X);
#pragma unroll 1
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) {
          float a = 0.0f, at = 0.0f;
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            a += X[r * 6 + k] * bO[k * 6 + cc];
            at += X[r * 6 + k] * bO[cc * 6 + k];
          }
          XbO[r * 6 + cc] = a;
          XbOt[r * 6 + cc] = at;
        }
#pragma unroll 1
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) {
          float a = 0.0f;
#pragma unroll
          for (int k = 0; k < 6; ++k) a += XbO[r * 6 + k] * X[cc * 6 + k];
          bMa[r * 6 + cc] += a;
        }
#pragma unroll 1
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) {
          float a = paf[r] * bpf[cc] + pa0[r] * bp0[cc];
#pragma unroll
          for (int k = 0; k < 6; ++k) a += Ma[r * 6 + k] * XbOt[k * 6 + cc] + Ma[k * 6 + r] * XbO[k * 6 + cc];
          bX[r * 6 + cc] = a;
        }
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        float a = 0.0f, b = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          a += X[r * 6 + k] * bpf[k];
          b += X[r * 6 + k] * bp0[k];
        }
        bpaf[r] += a;
        bpa0[r] += b;
      }
      float gX[12];
      col_ld(t, T_GX + i * 12, 12, gX);
      build_X_vjp(iR, ip, bX, gX, gX + 9);
      col_st(t, T_GX + i * 12, 12, gX);
    }
    float bU[6], binv_d = 0.0f, bd = gU[6], gc[6], gpf[6], gp0[6], gS[6];
    col_ld(t, T_GC + i * 6, 6, gc);
    // free: pa = pA + Ma c + U ud, ud = u inv_d
    {
      float bud = 0.0f, bud0 = 0.0f;
      const float ud = uf * inv_d, ud0 = u0 / d;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        gpf[k] = bpaf[k];
        gp0[k] = bpa0[k];
        bU[k] = gU[k] + ud * bpaf[k] + ud0 * bpa0[k];
        bud += U[k] * bpaf[k];
        bud0 += U[k] * bpa0[k];
      }
      mv6_vjp(Ma, w.c[i], bpaf, bMa, gc);
      buf += inv_d * bud;
      binv_d += uf * bud;
      bu0 += bud0 / d;
      bd += -bud0 * ud0 / d;
    }
    // Ma = MA - U U^T inv_d
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int cc = 0; cc < 6; ++cc) {
        const float bm = bMa[r * 6 + cc];
        bU[r] -= bm * U[cc] * inv_d;
        bU[cc] -= bm * U[r] * inv_d;
        binv_d -= bm * U[r] * U[cc];
      }
    // inv_d = 1 / d; u = tau - S.pA (free), -S.pA (substitution); d = S.U; U = MA S.
    bd += -binv_d * inv_d * inv_d;
    if (valid) ct_tau[(i - 1) * B] = buf;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      gpf[k] += -buf * S[k];
      gp0[k] += -bu0 * S[k];
      bU[k] += bd * S[k];
      gS[k] = -buf * pf[k] - bu0 * p0[k] + bd * U[k];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int cc = 0; cc < 6; ++cc) gS[cc] += w.MA[i][r * 6 + cc] * bU[r];
    acc.add(OFF_S + i * 6, 6, gS);
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int cc = 0; cc < 6; ++cc) bMa[r * 6 + cc] += bU[r] * S[cc];
    col_st(t, T_GMA + i * 36, 36, bMa);
    col_st(t, T_GPF + i * 6, 6, gpf);
    col_st(t, T_GP0 + i * 6, 6, gp0);
    col_st(t, T_GC + i * 6, 6, gc);
  }

  // ----- (d) the scatter of x (pA = -f): Rp's and Lp's cotangents -----
#pragma unroll 1
  for (int c = 0; c < NC; ++c) {
    const int par = JX_CPARENT[c];
    const float* Lp = P + OFF_CP + c * 3;
    float xc[3], y[3], gf[6], by[3], gL[3] = {0.0f, 0.0f, 0.0f};
    float gR[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    col_ld(t, T_X + c * 3, 3, xc);
    mtv3(w.WR[par], xc, y);
#pragma unroll
    for (int k = 0; k < 6; ++k) gf[k] = -t[T_GP0 + par * 6 + k];
#pragma unroll
    for (int j = 0; j < 3; ++j) by[j] = gf[j];
    cross3_vjp(Lp, y, gf + 3, gL, by);
    mtv3_vjp(w.WR[par], xc, by, gR, nullptr);
    col_add(t, T_GW + par * 18, 9, gR);
    acc.add(OFF_CP + c * 3, 3, gL);
  }

  // ----- (e) pass 1 of the free ABA and the kinematics, leaves to root -----
#pragma unroll 1
  for (int i = NL - 1; i >= 0; --i) {
    float gv[6], gW[18], gpA[6];
    col_ld(t, T_GV + i * 6, 6, gv);
    col_ld(t, T_GW + i * 18, 18, gW);
    col_ld(t, T_GPF + i * 6, 6, gpA);
    // pA = v x* (M v); MA = M (+ the children's, taken in (c)).
    const float* Mi = P + OFF_M + i * 36;
    {
      float gM[36];
#pragma unroll
      for (int k = 0; k < 36; ++k) gM[k] = 0.0f;
      vxstar_Mv_vjp(w.v[i], Mi, gpA, gv, PARAMS_GRAD ? gM : nullptr);
      if (PARAMS_GRAD) {
#pragma unroll
        for (int k = 0; k < 36; ++k) gM[k] += t[T_GMA + i * 36 + k];
        acc.add(OFF_M + i * 36, 36, gM);
      }
    }
    if (i == 0) {
      // v0 = X0^-1 v; R0i = R0^T, p0i = -R0i p0; WR0 = RB R_suc0,
      // Wp0 = p + RB p_suc0, Wv0 = v (floating base).
      float bv[6], bp[3], bq[4];
#pragma unroll
      for (int k = 0; k < 6; ++k) bv[k] = bvn[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) bp[k] = bp_in[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) bq[k] = bq_in[k];
      if (FLOATING) xv_vjp(R0i, p0i, v, gv, bR0i, bp0i, bv);
      const float nb[3] = {-bp0i[0], -bp0i[1], -bp0i[2]};
      mv3_vjp(R0i, w.Wp[0], nb, bR0i, gW + 9);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) gW[cc * 3 + r] += bR0i[r * 3 + cc];
      const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
      const float nrm = qw * qw + qx * qx + qy * qy + qz * qz;
      const float nn = nrm == 0.0f ? 1.0f : nrm;
      const float s2 = 2.0f / nn;
      float RB[9], Rs[9], ps[3], bRB[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      {
        const float wx = s2 * qw * qx, wy = s2 * qw * qy, wz = s2 * qw * qz;
        const float xx = s2 * qx * qx, xy = s2 * qx * qy, xz = s2 * qx * qz;
        const float yy = s2 * qy * qy, yz = s2 * qy * qz, zz = s2 * qz * qz;
        const float R[9] = {1.0f - (yy + zz), xy - wz, xz + wy, xy + wz, 1.0f - (xx + zz), yz - wx,
                            xz - wy, yz + wx, 1.0f - (xx + yy)};
#pragma unroll
        for (int k = 0; k < 9; ++k) RB[k] = R[k];
      }
      h_rot(P + OFF_SUCH, Rs);
      h_pos(P + OFF_SUCH, ps);
      if (FLOATING) {
#pragma unroll
        for (int k = 0; k < 6; ++k) bv[k] += gW[12 + k];
      }
      add3(bp, gW + 9);
      mm3_vjp(RB, Rs, gW, bRB, nullptr);
      mv3_vjp(RB, ps, gW + 9, bRB, nullptr);
      if (PARAMS_GRAD) {
        float bRs[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float bps[3] = {0.0f, 0.0f, 0.0f}, gs[12];
        mm3_vjp(RB, Rs, gW, nullptr, bRs);
        mv3_vjp(RB, ps, gW + 9, nullptr, bps);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) gs[r * 4 + cc] = bRs[r * 3 + cc];
          gs[r * 4 + 3] = bps[r];
        }
        acc.add(OFF_SUCH, 12, gs);
      }
      const float bxx = -(bRB[4] + bRB[8]), byy = -(bRB[0] + bRB[8]), bzz = -(bRB[0] + bRB[4]);
      const float bxy = bRB[1] + bRB[3], bxz = bRB[2] + bRB[6], byz = bRB[5] + bRB[7];
      const float bwx = bRB[7] - bRB[5], bwy = bRB[2] - bRB[6], bwz = bRB[3] - bRB[1];
      const float bs2 = bwx * qw * qx + bwy * qw * qy + bwz * qw * qz + bxx * qx * qx + bxy * qx * qy +
                        bxz * qx * qz + byy * qy * qy + byz * qy * qz + bzz * qz * qz;
      const float bn = nrm == 0.0f ? 0.0f : -bs2 * s2 / nn;
      bq[0] += s2 * (bwx * qx + bwy * qy + bwz * qz) + 2.0f * qw * bn;
      bq[1] += s2 * (bwx * qw + 2.0f * bxx * qx + bxy * qy + bxz * qz) + 2.0f * qx * bn;
      bq[2] += s2 * (bwy * qw + bxy * qx + 2.0f * byy * qy + byz * qz) + 2.0f * qy * bn;
      bq[3] += s2 * (bwz * qw + bxz * qx + byz * qy + 2.0f * bzz * qz) + 2.0f * qz * bn;
      if (valid) {
#pragma unroll
        for (int k = 0; k < 3; ++k) out.p[k * B] = bp[k];
#pragma unroll
        for (int k = 0; k < 4; ++k) out.q[k * B] = bq[k];
#pragma unroll
        for (int k = 0; k < 6; ++k) out.v[k * B] = bv[k];
      }
      continue;
    }
    const int lam = JX_LAM[i];
    const float* S = P + OFF_S + i * 6;
    const float sdi = sd[i - 1], si = s[i - 1];
    float iR[9], ip[3], T[12], gS[6], gc[6];
    load_pair(sl, i, iR, ip);
    col_ld(t, T_GX + i * 12, 12, T);
    col_ld(t, T_GC + i * 6, 6, gc);
    float bsd = ct.sd[(i - 1) * B + b] + dt * ct.s[(i - 1) * B + b];
    {
      // c = v x vJ, v = X v_lam + vJ
      float vJ[6], bvJ[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, up[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 6; ++k) vJ[k] = S[k] * sdi;
      vx_vjp(w.v[i], vJ, gc, gv, bvJ);
#pragma unroll
      for (int k = 0; k < 6; ++k) bvJ[k] += gv[k];
      xv_vjp(iR, ip, w.v[lam], gv, T, T + 9, up);
      col_add(t, T_GV + lam * 6, 6, up);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        bsd += S[k] * bvJ[k];
        gS[k] = sdi * bvJ[k];
      }
    }
    // Wv_i = Wv_lam + [R Sl + Wp_i x R Sa ; R Sa]
    float rR[9], rp[3];
    relative_transform(P, i, si, rR, rp);
    {
      const float Sl[3] = {S[0] * sdi, S[1] * sdi, S[2] * sdi};
      const float Sa[3] = {S[3] * sdi, S[4] * sdi, S[5] * sdi};
      float RSa[3];
      mv3(w.WR[i], Sa, RSa);
      float bRSa[3] = {gW[15], gW[16], gW[17]};
      float bSl[3] = {0.0f, 0.0f, 0.0f}, bSa[3] = {0.0f, 0.0f, 0.0f};
      col_add(t, T_GW + lam * 18 + 12, 6, gW + 12);
      cross3_vjp(w.Wp[i], RSa, gW + 12, gW + 9, bRSa);
      mv3_vjp(w.WR[i], Sa, bRSa, gW, bSa);
      mv3_vjp(w.WR[i], Sl, gW + 12, gW, bSl);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bsd += S[k] * bSl[k] + S[k + 3] * bSa[k];
        gS[k] += sdi * bSl[k];
        gS[k + 3] += sdi * bSa[k];
      }
    }
    acc.add(OFF_S + i * 6, 6, gS);
    // iR = rR^T, ip = -iR rp
    float brR[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float brp[3] = {0.0f, 0.0f, 0.0f};
    {
      const float nb[3] = {-T[9], -T[10], -T[11]};
      mv3_vjp(iR, rp, nb, T, brp);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) brR[cc * 3 + r] += T[r * 3 + cc];
    }
    // Wp_i = Wp_lam + WR_lam rp, WR_i = WR_lam rR
    {
      float up[12];
#pragma unroll
      for (int k = 0; k < 9; ++k) up[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) up[9 + k] = gW[9 + k];
      mv3_vjp(w.WR[lam], rp, gW + 9, up, brp);
      mm3_vjp(w.WR[lam], rR, gW, up, brR);
      col_add(t, T_GW + lam * 18, 12, up);
    }
    const float bs = ct.s[(i - 1) * B + b] + relative_transform_vjp<PARAMS_GRAD>(P, i, si, brR, brp, acc);
    if (valid) {
      out.s[(i - 1) * B] = bs;
      out.sd[(i - 1) * B] = bsd;
    }
  }
}

// ----- the kernel -----

// One env's VJP on its JX_RR_LANES lanes (env threadIdx.x / G, lane g) and
// its ABA thread (thread t < ENVS, env t), the envs past B running env
// B - 1's beside the others so that every thread reaches every barrier, and
// writing nothing. `tape` holds TAPE_ROWS rows of `stride` floats (at least
// the launch's envs); `partials`, with params_grad, B rows of N_PARAMS.
__global__ void __launch_bounds__(RR_THREADS, 1)
    step_vjp_rr_kernel(const float* __restrict__ params, StateIn in, const float* __restrict__ tau_in, StateIn ct,
                       StateOut out, float* __restrict__ ct_tau, float* __restrict__ tape, int stride,
                       float* __restrict__ partials, int B, Scalars sc) {
  extern __shared__ float smem[];
  float* P = smem;
  float* slots = smem + N_PARAMS;
  load_params(params, P);
  const int e_pcg = threadIdx.x / G;
  const int b_aba = blockIdx.x * ENVS + threadIdx.x, b_pcg = blockIdx.x * ENVS + e_pcg;
  const bool aba = threadIdx.x < ENVS;
  const int g = threadIdx.x % G;
  const Slot mine{slots + (aba ? threadIdx.x : 0)};
  const int ba = b_aba < B ? b_aba : B - 1;

  int pt[OWN];
  float m[OWN * 3];
  rr_points(g, pt);
  rr_load_m(in.m, B, b_pcg < B ? b_pcg : B - 1, pt, m);
  float s[NJA], sd[NJA], p[3], q[4], v[6];
  if (aba) {
    rr_load_body(in, B, ba, s, sd, p, q, v);
#pragma unroll 4
    for (int k = 0; k < NJ; ++k) mine[SL_TAU + k] = __ldg(tau_in + k * B + ba);
  }
  __syncthreads();

  // 1. The forward: the free ABA, then the warm-started PCG on the lanes.
  RrWork w;
  if (aba) {
    float sdd[NJA];
    rr_free_step(P, sc, w, mine, s, sd, p, q, v, sdd, SlotTauRr{mine});
  }
  __syncthreads();
  const Slot sl{slots + e_pcg};
  const Col tl{tape + blockIdx.x * ENVS + e_pcg, stride};
  float act[OWN], rj[OWN * 3], r[OWN * 3], x[OWN * 3];
  rr_setup(P, sc, sl, pt, m, act, rj, r, x);
  rr_cg(P, sc, sl, g, pt, act, rj, r, x, true, false);
#pragma unroll
  for (int k = 0; k < OWN * 3; ++k)
    if (pt[k / 3] >= 0) tl[T_X + pt[k / 3] * 3 + k % 3] = x[k];
  __syncthreads();

  // 2. x's cotangent, on the ABA thread.
  const Col ta{tape + b_aba, stride};
  const bool valid = aba && b_aba < B;
  float ga0[6], gW0[12], bvn[6], bq[4], bp[3], bsdd[NJA];
  if (aba)
    rr_vjp_x_bar(P, sc, w, mine, ta, q, p, v, ct, B, ba, out.m + ba, valid, ga0, gW0, bvn, bq, bp, bsdd);
  __syncthreads();

  // 3. lambda = PCG(x-bar) from zero on the lanes.
#pragma unroll
  for (int k = 0; k < OWN * 3; ++k) {
    r[k] = pt[k / 3] >= 0 ? tl[T_L + pt[k / 3] * 3 + k % 3] : 0.0f;
    x[k] = 0.0f;
  }
  rr_cg(P, sc, sl, g, pt, act, rj, r, x, false, false);
#pragma unroll
  for (int k = 0; k < OWN * 3; ++k)
    if (pt[k / 3] >= 0) tl[T_L + pt[k / 3] * 3 + k % 3] = x[k];
  __syncthreads();

  // 4. The rest, on the ABA thread.
  if (aba) {
    float* row = PARAMS_GRAD && valid ? partials + static_cast<size_t>(b_aba) * N_PARAMS : nullptr;
    if (row) {
#pragma unroll 1
      for (int k = 0; k < N_PARAMS; ++k) row[k] = 0.0f;
    }
    const StateOut o{out.s + ba, out.sd + ba, out.p + ba, out.q + ba, out.v + ba, out.m + ba};
    rr_vjp_rest(P, sc, w, mine, ta, s, sd, q, v, ct, B, ba, o, ct_tau + ba, valid, EnvAcc{row}, ga0, gW0, bvn, bq,
                bp, bsdd);
  }
}

}  // namespace

extern "C" {

static int allow_smem(const void* kernel) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(RR_SMEM_BYTES)));
}

int jx_param_count() { return N_PARAMS; }

// Floats of the tape an env: the wrapper allocates this many rows of at
// least the launch's envs (jx_vjp_rr_geometry's envs a block, rounded up).
int jx_vjp_rr_tape_rows() { return TAPE_ROWS; }

int jx_step_vjp_rr(const float* params, const float* s, const float* sd, const float* p, const float* q,
                   const float* v, const float* m, const float* tau, const float* ct_s, const float* ct_sd,
                   const float* ct_p, const float* ct_q, const float* ct_v, const float* ct_m, float* out_s,
                   float* out_sd, float* out_p, float* out_q, float* out_v, float* out_m, float* out_tau,
                   float* tape, int stride, float* partials, int B, float K, float D, float k_over_d, float mu,
                   float hc_p, float hc_q, float gz, float dt, float rr_ca, float rr_cb, float rr_mid,
                   float rr_power, float rr_width, float rr_dmin, float rr_dmax, float rr_span, float rr_stiff,
                   float rr_damp, float rr_c2mu2, float rr_c1mu2, float rr_reg, void* stream) {
  const int blocks = (B + ENVS - 1) / ENVS;
  if ((PARAMS_GRAD && partials == nullptr) || stride < blocks * ENVS) return static_cast<int>(cudaErrorInvalidValue);
  const Scalars sc{K,        D,       k_over_d, mu,       hc_p,     hc_q,    gz,
                   dt,       0.0f,    0.0f,     rr_ca,    rr_cb,    rr_mid,  rr_power,
                   rr_width, rr_dmin, rr_dmax,  rr_span,  rr_stiff, rr_damp, rr_c2mu2,
                   rr_c1mu2, rr_reg};
  const int rc = allow_smem(reinterpret_cast<const void*>(step_vjp_rr_kernel));
  if (rc != 0) return rc;
  step_vjp_rr_kernel<<<blocks, RR_THREADS, RR_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      params, StateIn{s, sd, p, q, v, m}, tau, StateIn{ct_s, ct_sd, ct_p, ct_q, ct_v, ct_m},
      StateOut{out_s, out_sd, out_p, out_q, out_v, out_m}, out_tau, tape, stride, partials, B, sc);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry, for the reports: threads a block, envs a block,
// dynamic shared memory a block in bytes, and blocks an SM holds at once.
int jx_vjp_rr_geometry(int* out) {
  const int rc = allow_smem(reinterpret_cast<const void*>(step_vjp_rr_kernel));
  if (rc != 0) return rc;
  int blocks_per_sm = 0;
  const cudaError_t occ =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, step_vjp_rr_kernel, RR_THREADS, RR_SMEM_BYTES);
  out[0] = RR_THREADS;
  out[1] = ENVS;
  out[2] = static_cast<int>(RR_SMEM_BYTES);
  out[3] = blocks_per_sm;
  return static_cast<int>(occ);
}

// The env rows of model-array cotangents summed in a fixed order (K4's sum).
int jx_param_sum(const float* partials, int n_rows, float* out, void* stream) {
  param_sum_kernel<<<(N_PARAMS + SUM_ENTRIES - 1) / SUM_ENTRIES, 32 * SUM_WARPS, 0,
                     static_cast<cudaStream_t>(stream)>>>(partials, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}

const char* jx_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
