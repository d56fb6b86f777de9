// The fused backward of one engine step (K4): one env on a group of
// JX_LN_LANES lanes of a warp, its tape in shared memory.
//
// Replaces _step_vjp_kernel of jaxsim_tpu/ops/pallas_step.py (built by
// build_pallas_step_vjp), which traces jax.vjp of the engine step inside the
// kernel. Here the transposed step is written by hand, from the math: for a
// state, torques tau and a cotangent of the output state, one launch
//  1. recomputes the step with soft_step_lanes (soft_step_lanes.cuh) on the
//     env's lanes, which leaves its tape in the env's slot of shared memory:
//     per link the world pose, the child -> parent pair, v, MA, pA and a;
//     per contact parent its wrench and world velocity;
//  2. sweeps the transposed step in four phases apart by warp barriers, each
//     tree phase level by level with a link on the lane that ran it forward:
//     (A) SIE and ABA pass 3, leaves to root, then the base Cholesky;
//     (B) ABA pass 2, root to leaves; (C) the contacts, the points dealt to
//     the lanes as in the forward; (D) ABA pass 1 with the kinematics,
//     leaves to root, then the base. A link's adjoints that its parent
//     consumes (of a, v, the world pose and velocity) are pulled by the
//     parent from the child's rows in descending child order. Per-point
//     contact quantities, U, d, u, c and each joint's transform are
//     recomputed, not stored.
// The sweep reuses the slot's rows once the forward's values in them are
// dead: a link's a row holds the adjoint of c after (A); MA and pA hold their
// adjoints after (B); T holds (U, d, u)'s and (iR, ip)'s adjoints from (A) to
// (D), and the link's pulled adjoints after; a parent's wrench row holds the
// wrench's adjoint after (C). Derivatives at a tie of max/min are JAX's: half
// to each side. A branch the forward did not take (no contact, sticking,
// slipping) passes nothing.
//
// With JX_PARAMS_GRAD (a build-time define, in the generated header) the
// kernel also sums the model arrays' cotangents, in the packed layout, into
// one row of shared memory a block: each contribution is added over the
// block's envs (a fixed xor shuffle tree over the lanes that run the same
// link or point) and by one lane into the row, which only that lane writes
// at that time; the block writes its row to `partials`, and param_sum_kernel
// adds the partials in a fixed order. No float atomics: two runs agree to
// the bit.
//
// What bounds it on the card: per-env latency, not HBM (the state, tau and
// cotangents cross device memory once each way, about 33 MB for the
// humanoid at 8192 envs, 10 us at 3.35 TB/s). One thread an env (the earlier
// design) kept two Work structs, about 21 KB, in local memory, and 1,989
// accumulators with params_grad, with 1.94 warps an SM at 8192 envs: 1.31
// and 2.59 ms on an H100. Here the tape is in shared memory (11 KB an env
// for the humanoid), the tree passes run a level at a time across the lanes
// (7 levels, not 23 links, in sequence), the points across the lanes, and
// the model-array cotangents never leave shared memory: 0.47 and 0.59 ms at
// 4 lanes an env (8 envs a block, 2 blocks an SM; PERF.md has 1, 8 and 16).
// The model arrays are read from device memory through L1, which leaves the
// block's shared memory to the slots.

#include "soft_step_lanes.cuh"

#ifndef JX_PARAMS_GRAD
#define JX_PARAMS_GRAD 0
#endif

namespace {

constexpr bool PARAMS_GRAD = JX_PARAMS_GRAD != 0;
static_assert(!FORWARD && LN_THREADS <= 32, "K4 takes the full slot, and a block of at most one warp");
static_assert(INTEGRATOR == 0, "step_vjp.cu implements semi-implicit Euler (JX_INTEGRATOR 0)");
constexpr size_t VJP_SMEM_BYTES = (static_cast<size_t>(SLOT) * ES + (PARAMS_GRAD ? N_PARAMS : 0)) * sizeof(float);

}  // namespace

#include "vjp_algebra.cuh"

namespace {

// The block's row of model-array cotangents, as one lane sees it: `add`
// sums a contribution over the block's envs (the lanes in `mask`, which run
// the same link or point) and the first env's lane adds it into the row.
// Envs past the batch add zeros. Without params_grad it does nothing.
struct Acc {
  float* row;
  unsigned mask;
  bool valid, lead;
  __device__ __forceinline__ void add(int off, float x) const {
    if (!PARAMS_GRAD) return;
    x = valid ? x : 0.0f;
#pragma unroll
    for (int o = G; o < LN_THREADS; o <<= 1) x += __shfl_xor_sync(mask, x, o);
    if (lead) row[off] += x;
  }
  __device__ __forceinline__ void add(int off, int n, const float* x) const {
#pragma unroll
    for (int k = 0; k < 36; ++k)
      if (k < n) add(off + k, x[k]);
  }
};

// One env's cotangents in and out, as columns: the output state's
// cotangents `c`, and where the input's and the torques' go (nothing is
// written for an env past the batch).
struct VjpOut {
  float *s, *sd, *p, *q, *v, *m, *tau;
  int B;
  bool valid;
  __device__ __forceinline__ void put(float* x, int k, float value) const {
    if (valid) x[k * B] = value;
  }
};

// The transposed step of one env on lane g, after soft_step_lanes filled its
// slot `sl` and gave lane 0 the new base velocity `vn`. Every lane of the
// block calls it together.
template <class Tau>
__device__ void step_vjp_lanes(const float* P, const Scalars& sc, Slot sl, int g, const EnvIn& x, Tau tau,
                               const EnvIn& c, const VjpOut& out, const Acc& acc, const float* vn) {
  const float dt = sc.dt;

  // ----- semi-implicit Euler, with the quaternion renormalization (lane 0);
  // a joint's part is taken by its link's lane where needed -----
  if (g == 0) {
    float bvn[6], bq[4], bp[3];
#pragma unroll
    for (int k = 0; k < 6; ++k) bvn[k] = c.v[k];
    {
      // q' = qn / sqrt(max(|qn|^2, 1e-12)), qn = q + dt (0.5 Omega(w') q).
      const float ox = vn[3], oy = vn[4], oz = vn[5];
      const float qw = x.q[0], qx = x.q[1], qy = x.q[2], qz = x.q[3];
      const float qn[4] = {qw + dt * (0.5f * (-qx * ox - qy * oy - qz * oz)),
                           qx + dt * (0.5f * (qw * ox - qy * oz + qz * oy)),
                           qy + dt * (0.5f * (qw * oy + qx * oz - qz * ox)),
                           qz + dt * (0.5f * (qw * oz - qx * oy + qy * ox))};
      const float n2 = qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3];
      const float nq = sqrtf(fmaxf(n2, 1e-12f));
      float dot = 0.0f, bqn[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bqn[k] = c.q[k] / nq;
        dot += qn[k] * c.q[k];
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
      const float p[3] = {x.p[0], x.p[1], x.p[2]};
      float dcp[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bp[k] = c.p[k];
        dcp[k] = dt * c.p[k];
        bvn[k] += dcp[k];
      }
      cross3_vjp(vn + 3, p, dcp, bvn + 3, bp);
    }
    // v' = v + dt W_a, W_a = X0 a0 + g.
    float bWa[6], ga0[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float gWR0[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gWp0[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 6; ++k) bWa[k] = dt * bvn[k];
    if (FLOATING) {
      float R0[9], p0[3], a0[6];
      sl.ld(LK_WR, 9, R0);
      sl.ld(LK_WP, 3, p0);
      sl.ld(LK_A, 6, a0);
      xv_vjp(R0, p0, a0, bWa, gWR0, gWp0, ga0);
    }
    sl.st(SL_BASE + BS_GA0, 6, ga0);
    sl.st(SL_BASE + BS_GWR0, 9, gWR0);
    sl.st(SL_BASE + BS_GWP0, 3, gWp0);
    sl.st(SL_BASE + BS_BV, 6, bvn);
    sl.st(SL_BASE + BS_BP, 3, bp);
    sl.st(SL_BASE + BS_BQ, 4, bq);
  }
  ln_sync();

  // ----- (A) ABA pass 3 (accelerations), leaves to root -----
#pragma unroll 1
  for (int lev = NLEV - 1; lev >= 0; --lev) {
#pragma unroll 1
    for (int n = JX_LN_LEV_OFF[lev] + g; n < JX_LN_LEV_OFF[lev + 1]; n += G) {
      const int i = JX_LN_LEV_LINK[n], lam = JX_LAM[i];
      const float* S = P + OFF_S + i * 6;
      float U[6], d, u, a_i[6], iR[9], ip[3], al[6], ga[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      {
        float MA[36], pA[6], v[6], cb[6];
        sl.ld(i * LK + LK_MA, 36, MA);
        sl.ld(i * LK + LK_PA, 6, pA);
        link_udu(MA, pA, S, tau(i - 1), U, d, u);
        sl.ld(i * LK + LK_V, 6, v);
        joint_bias(S, x.sd[i - 1], v, cb);
        sl.ld(i * LK + LK_IR, 9, iR);
        sl.ld(i * LK + LK_IP, 3, ip);
        sl.ld(lam * LK + LK_A, 6, al);
        xv(iR, ip, al, a_i);
#pragma unroll
        for (int k = 0; k < 6; ++k) a_i[k] += cb[k];
      }
      float ua = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) ua += U[k] * a_i[k];
      const float sddi = (u - ua) / d;
      // The children's a_lam adjoints: X^T of their c adjoints.
#pragma unroll 1
      for (int h = JX_LN_CH_OFF[i]; h < JX_LN_CH_OFF[i + 1]; ++h) {
        const int ch = JX_LN_CH[h];
        float cR[9], cp[3], gc[6], t[6];
        sl.ld(ch * LK + LK_IR, 9, cR);
        sl.ld(ch * LK + LK_IP, 3, cp);
        sl.ld(ch * LK + LK_A, 6, gc);
        xtf(cR, cp, gc, t);
#pragma unroll
        for (int k = 0; k < 6; ++k) ga[k] += t[k];
      }
      // a[i] = a_i + S sdd, sdd = (u - U.a_i) / d; sd' = sd + dt sdd.
      float bsddi = dt * (c.sd[i - 1] + dt * c.s[i - 1]);
      float gS[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        bsddi += S[k] * ga[k];
        gS[k] = sddi * ga[k];
      }
      acc.add(OFF_S + i * 6, 6, gS);
      const float bua = -bsddi / d;
      float T[20], gc[6];
      T[6] = -bsddi * sddi / d;  // d
      T[7] = bsddi / d;          // u
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        T[k] = bua * a_i[k];  // U
        gc[k] = ga[k] + bua * U[k];
      }
#pragma unroll
      for (int k = 8; k < 20; ++k) T[k] = 0.0f;
      xv_vjp(iR, ip, al, gc, T + 8, T + 17, nullptr);
      sl.st(i * LK + LK_T, 20, T);
      sl.st(i * LK + LK_A, 6, gc);
    }
    ln_sync();
  }
  if (g == 0) {
    float ga0[6], gMA0[36], gpA0[6];
    sl.ld(SL_BASE + BS_GA0, 6, ga0);
#pragma unroll 1
    for (int h = JX_LN_CH_OFF[0]; h < JX_LN_CH_OFF[1]; ++h) {
      const int ch = JX_LN_CH[h];
      float cR[9], cp[3], gc[6], t[6];
      sl.ld(ch * LK + LK_IR, 9, cR);
      sl.ld(ch * LK + LK_IP, 3, cp);
      sl.ld(ch * LK + LK_A, 6, gc);
      xtf(cR, cp, gc, t);
#pragma unroll
      for (int k = 0; k < 6; ++k) ga0[k] += t[k];
    }
#pragma unroll
    for (int k = 0; k < 36; ++k) gMA0[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) gpA0[k] = 0.0f;
    float bR0i[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, bp0i[3] = {0.0f, 0.0f, 0.0f};
    if (FLOATING) {
      // a0 = -x, x = MA0^-1 pA0 through the Cholesky of MA0's lower triangle.
      float bx[6], y[6], MA0[36], a0[6];
      sl.ld(LK_MA, 36, MA0);
      sl.ld(LK_A, 6, a0);
#pragma unroll
      for (int k = 0; k < 6; ++k) bx[k] = -ga0[k];
      chol6_solve(MA0, bx, y);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        gpA0[i] = y[i];
        const float xi = -a0[i];
        gMA0[i * 6 + i] = -y[i] * xi;
#pragma unroll
        for (int j = 0; j < i; ++j) gMA0[i * 6 + j] = -(y[i] * -a0[j] + y[j] * xi);
      }
    } else {
      // a0 = -X0^-1 g
      const float g6[6] = {0.0f, 0.0f, sc.gz, 0.0f, 0.0f, 0.0f};
      const float ba0[6] = {-ga0[0], -ga0[1], -ga0[2], -ga0[3], -ga0[4], -ga0[5]};
      float R0i[9], p0i[3];
      base_inverse(sl, R0i, p0i);
      xv_vjp(R0i, p0i, g6, ba0, bR0i, bp0i, nullptr);
    }
    sl.st(LK_MA, 36, gMA0);
    sl.st(LK_PA, 6, gpA0);
    sl.st(SL_BASE + BS_BR0I, 9, bR0i);
    sl.st(SL_BASE + BS_BP0I, 3, bp0i);
  }
  ln_sync();

  // ----- (B) ABA pass 2 (articulated inertias), root to leaves -----
#pragma unroll 1
  for (int lev = 0; lev < NLEV; ++lev) {
#pragma unroll 1
    for (int n = JX_LN_LEV_OFF[lev] + g; n < JX_LN_LEV_OFF[lev + 1]; n += G) {
      const int i = JX_LN_LEV_LINK[n], lam = JX_LAM[i];
      const float* S = P + OFF_S + i * 6;
      float U[6], d, u, cb[6], pA[6], Ma[36], T[20], gc[6];
      {
        float v[6];
        sl.ld(i * LK + LK_MA, 36, Ma);
        sl.ld(i * LK + LK_PA, 6, pA);
        link_udu(Ma, pA, S, tau(i - 1), U, d, u);
        sl.ld(i * LK + LK_V, 6, v);
        joint_bias(S, x.sd[i - 1], v, cb);
      }
      sl.ld(i * LK + LK_T, 20, T);
      sl.ld(i * LK + LK_A, 6, gc);
      const float inv_d = 1.0f / d;
      const float ud = u * inv_d;
      float pa[6], t[6];
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) Ma[r * 6 + cc] -= U[r] * U[cc] * inv_d;
      mv6(Ma, cb, t);
#pragma unroll
      for (int k = 0; k < 6; ++k) pa[k] = pA[k] + t[k] + U[k] * ud;

      float bMa[36], bpa[6];
#pragma unroll
      for (int k = 0; k < 36; ++k) bMa[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) bpa[k] = 0.0f;
      if (lam != 0 || FLOATING) {
        // MA_lam += X^T Ma X, pA_lam += X^T pa; the parent's rows hold
        // their adjoints bO, bpO now.
        float iR[9], ip[3], X[36], XbO[36], XbOt[36], bO[36], bpO[6];
        sl.ld(i * LK + LK_IR, 9, iR);
        sl.ld(i * LK + LK_IP, 3, ip);
        sl.ld(lam * LK + LK_MA, 36, bO);
        sl.ld(lam * LK + LK_PA, 6, bpO);
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
        // bMa = X bO X^T = XbO X^T
#pragma unroll 1
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int cc = 0; cc < 6; ++cc) {
            float a = 0.0f;
#pragma unroll
            for (int k = 0; k < 6; ++k) a += XbO[r * 6 + k] * X[cc * 6 + k];
            bMa[r * 6 + cc] += a;
          }
        // bX = Ma X bO^T + Ma^T X bO + pa bpO^T
        float bX[36];
#pragma unroll 1
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int cc = 0; cc < 6; ++cc) {
            float a = pa[r] * bpO[cc];
#pragma unroll
            for (int k = 0; k < 6; ++k) a += Ma[r * 6 + k] * XbOt[k * 6 + cc] + Ma[k * 6 + r] * XbO[k * 6 + cc];
            bX[r * 6 + cc] = a;
          }
        // bpa = X bpO
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          float a = 0.0f;
#pragma unroll
          for (int k = 0; k < 6; ++k) a += X[r * 6 + k] * bpO[k];
          bpa[r] += a;
        }
        build_X_vjp(iR, ip, bX, T + 8, T + 17);
      }
      // pa = pA + Ma c + U ud
      float bU[6], bud = 0.0f, gpA[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        gpA[k] = bpa[k];
        bU[k] = T[k] + ud * bpa[k];
        bud += U[k] * bpa[k];
      }
      mv6_vjp(Ma, cb, bpa, bMa, gc);
      const float bu = T[7] + inv_d * bud;
      float binv_d = u * bud;
      // Ma = MA - U U^T inv_d
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) {
          const float b = bMa[r * 6 + cc];
          bU[r] -= b * U[cc] * inv_d;
          bU[cc] -= b * U[r] * inv_d;
          binv_d -= b * U[r] * U[cc];
        }
      // inv_d = 1 / d, u = tau - S.pA, d = S.U, U = MA S
      const float bdd = T[6] - binv_d * inv_d * inv_d;
      out.put(out.tau, i - 1, bu);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        gpA[k] += -bu * S[k];
        bU[k] += bdd * S[k];
      }
      if (PARAMS_GRAD) {
        float gS[6], MA[36];
        sl.ld(i * LK + LK_MA, 36, MA);
#pragma unroll
        for (int k = 0; k < 6; ++k) gS[k] = -bu * pA[k] + bdd * U[k];
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int cc = 0; cc < 6; ++cc) gS[cc] += MA[r * 6 + cc] * bU[r];
        acc.add(OFF_S + i * 6, 6, gS);
      }
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) bMa[r * 6 + cc] += bU[r] * S[cc];
      sl.st(i * LK + LK_MA, 36, bMa);
      sl.st(i * LK + LK_PA, 6, gpA);
      sl.st(i * LK + LK_A, 6, gc);
      sl.st(i * LK + LK_T + 8, 12, T + 8);
    }
    ln_sync();
  }

  // ----- (C) soft contacts: wrenches and m's rate, per point -----
  // The wrench's adjoint of each contact parent (pA -= X^T f in pass 1),
  // with its share of the parent's world pose adjoint.
#pragma unroll 1
  for (int n = g; n < NPAR; n += G) {
    const int i = JX_LN_PAR_LINK[n], o = SL_PAR + n * PR;
    float R[9], Wp[3], f[6], gpA[6];
    sl.ld(i * LK + LK_WR, 9, R);
    sl.ld(i * LK + LK_WP, 3, Wp);
    sl.ld(o + PR_F, 6, f);
    sl.ld(i * LK + LK_PA, 6, gpA);
    const float nb[6] = {-gpA[0], -gpA[1], -gpA[2], -gpA[3], -gpA[4], -gpA[5]};
    float gW[18], gf[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 18; ++k) gW[k] = 0.0f;
    xtf_vjp(R, Wp, f, nb, gW, gW + 9, gf);  // gWR, gWp; gWv stays 0
    sl.st(o + PR_GWR, 18, gW);
    sl.st(o + PR_F, 6, gf);
  }
  ln_sync();
  {
    constexpr float eps = FLT_EPSILON;
    float acc18[18];
#pragma unroll
    for (int j = 0; j < 18; ++j) acc18[j] = 0.0f;
#pragma unroll 1
    for (int k = 0; k < OWN; ++k) {
      const int ci = JX_LN_SLOT_POINT[g + G * k], par = JX_LN_GROUP_LINK[k];
      const int o = SL_PAR + JX_LN_GROUP_PAR[k] * PR;
      // The point's adjoints of its parent's world rotation, position and
      // velocity (PR_GWR's order: WR, Wp, Wv).
      float w[18];
#pragma unroll
      for (int j = 0; j < 18; ++j) w[j] = 0.0f;
      if (ci >= 0) {
        const float* Lp = P + OFF_CP + ci * 3;
        float R[9], Wp[3], Wv[6], pc[3], pd[3], gf[6];
        parent_pose(sl, par, false, R, Wp, Wv);
        point_kinematics(P, ci, R, Wp, Wv, pc, pd);
        sl.ld(o + PR_F, 6, gf);
        const float mc[3] = {x.m[ci * 3], x.m[ci * 3 + 1], x.m[ci * 3 + 2]};
        const float cm[3] = {c.m[ci * 3], c.m[ci * 3 + 1], c.m[ci * 3 + 2]};
        // The forward's law, from the same code (hc_law), so that the sweep
        // takes the branch the forward took.
        const HcLaw h = hc_law(sc, pc, pd, mc);
        const float delta = h.delta, delta_dot = h.delta_dot, Kdp = h.Kdp, Ddq = h.Ddq, arg = h.arg;
        const float f_t_sq = h.f_t_sq, mu_fn = h.mu_fn, norm = h.norm, mn = h.mn, scale = h.scale;
        const bool no_contact = h.no_contact, sticking = h.sticking;
        const float *v_t = h.v_t, *m_t = h.m_t, *f_t = h.f_t, *f_s = h.f_s, *f_lin = h.f_lin;

        // m' = m + dt md; f[par] += [f_lin ; pc x f_lin].
        float bmd[3], bpc[3] = {0.0f, 0.0f, 0.0f}, bpd[3] = {0.0f, 0.0f, 0.0f};
        float bf_lin[3] = {gf[0], gf[1], gf[2]};
        float bmc[3] = {cm[0], cm[1], cm[2]};
#pragma unroll
        for (int j = 0; j < 3; ++j) bmd[j] = dt * cm[j];
        cross3_vjp(pc, f_lin, gf + 3, bpc, bf_lin);
        float bfn = bf_lin[2];
        float bft[3] = {0.0f, 0.0f, 0.0f}, bv_t[3] = {0.0f, 0.0f, 0.0f}, bm_t[3] = {0.0f, 0.0f, 0.0f};
        float bKdp = 0.0f, bDdq = 0.0f;
        if (no_contact) {  // md = -(K/D) m; f_t = 0
#pragma unroll
          for (int j = 0; j < 3; ++j) bmc[j] += -sc.k_over_d * bmd[j];
        } else if (sticking) {  // md = v_t - (K/D) m_n
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            bv_t[j] += bmd[j];
            bft[j] += bf_lin[j];
          }
          bmc[2] += -sc.k_over_d * bmd[2];
        } else {  // md = -(f_s + Kdp m_t) / Ddq, f_s = f_t min(mu fn, |f_t|) / |f_t|
          float bfs[3], bscale = 0.0f;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            bfs[j] = bf_lin[j] - bmd[j] / Ddq;
            bm_t[j] += -Kdp * bmd[j] / Ddq;
            bKdp += -m_t[j] * bmd[j] / Ddq;
            bDdq += (f_s[j] + Kdp * m_t[j]) * bmd[j] / (Ddq * Ddq);
            bft[j] += scale * bfs[j];
            bscale += f_t[j] * bfs[j];
          }
          const float bmn = bscale / norm;
          float bnorm = -bscale * mn / (norm * norm);
          const float bmu_fn = bmn * max_grad(norm, mu_fn);  // min(mu_fn, norm): mu_fn's side
          bnorm += bmn * max_grad(mu_fn, norm);
          bfn += sc.mu * bmu_fn;
          const float bsq = bnorm * (0.5f / norm) * max_grad(f_t_sq, eps * eps);
#pragma unroll
          for (int j = 0; j < 3; ++j) bft[j] += 2.0f * f_t[j] * bsq;
        }
        // f_t = -(Kdp m_t + Ddq v_t)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          bKdp += -m_t[j] * bft[j];
          bm_t[j] += -Kdp * bft[j];
          bDdq += -v_t[j] * bft[j];
          bv_t[j] += -Ddq * bft[j];
        }
        // fn = max(0, Kdp delta + Ddq delta_dot)
        const float barg = bfn * max_grad(arg, 0.0f);
        bKdp += delta * barg;
        bDdq += delta_dot * barg;
        float bdelta = Kdp * barg;
        const float bdelta_dot = Ddq * barg;
        // Kdp = K (delta + eps)^p, Ddq = D (delta + eps)^q
        bdelta += sc.K * bKdp * sc.hc_p * powf(delta + eps, sc.hc_p - 1.0f) +
                  sc.D * bDdq * sc.hc_q * powf(delta + eps, sc.hc_q - 1.0f);
        if (delta > 0.0f) bpd[2] += -bdelta_dot;
        bpc[2] += -bdelta * max_grad(-pc[2], 0.0f);  // delta = max(0, -pc_z)
        bpd[0] += bv_t[0];
        bpd[1] += bv_t[1];
        bmc[0] += bm_t[0];
        bmc[1] += bm_t[1];
#pragma unroll
        for (int j = 0; j < 3; ++j) out.put(out.m, ci * 3 + j, bmc[j]);
        // pd = v_l + w x pc, pc = R Lp + p (of the parent link)
        float gcp[3] = {0.0f, 0.0f, 0.0f};
        add3(w + 12, bpd);
        cross3_vjp(Wv + 3, pc, bpd, w + 15, bpc);
        add3(w + 9, bpc);
        mv3_vjp(R, Lp, bpc, w, gcp);
        acc.add(OFF_CP + ci * 3, 3, gcp);
      }
#pragma unroll
      for (int j = 0; j < 18; ++j) acc18[j] += lanes_sum(w[j]);
      if (k == OWN - 1 || JX_LN_GROUP_LINK[k + 1] != par) {
        if (g == 0) sl.add(o + PR_GWR, 18, acc18);
#pragma unroll
        for (int j = 0; j < 18; ++j) acc18[j] = 0.0f;
      }
    }
    if (NC == 0 && g == 0) {
#pragma unroll 1
      for (int k = 0; k < NCM * 3; ++k) out.put(out.m, k, c.m[k]);
    }
  }
  ln_sync();

  // ----- (D) ABA pass 1 (velocities, bias forces) and the kinematics,
  // leaves to root -----
#pragma unroll 1
  for (int lev = NLEV - 1; lev >= -1; --lev) {
    const int n0 = lev < 0 ? 0 : JX_LN_LEV_OFF[lev] + g, n1 = lev < 0 ? (g == 0 ? 1 : 0) : JX_LN_LEV_OFF[lev + 1];
#pragma unroll 1
    for (int n = n0; n < n1; n += G) {
      const int i = lev < 0 ? 0 : JX_LN_LEV_LINK[n];
      // The adjoints of v and of the world velocity, position and rotation:
      // the contacts' (a parent's row), then the children's, pulled.
      float gv[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gW[18];  // gW: WR 9, Wp 3, Wv 6
      if (JX_LN_PAR_ROW[i] >= 0) {
        sl.ld(SL_PAR + JX_LN_PAR_ROW[i] * PR + PR_GWR, 18, gW);
      } else {
#pragma unroll
        for (int k = 0; k < 18; ++k) gW[k] = 0.0f;
      }
      if (i == 0) {
        float b[12];
        sl.ld(SL_BASE + BS_GWR0, 12, b);
#pragma unroll
        for (int k = 0; k < 12; ++k) gW[k] += b[k];
      }
#pragma unroll 1
      for (int h = JX_LN_CH_OFF[i]; h < JX_LN_CH_OFF[i + 1]; ++h) {
        const Slot ch{sl.base + JX_LN_CH[h] * LK * ES};
#pragma unroll
        for (int k = 0; k < 6; ++k) gv[k] += ch[LK_T + k];
        // T's order after (D): v, Wv, Wp, WR.
#pragma unroll
        for (int k = 0; k < 6; ++k) gW[12 + k] += ch[LK_T + 6 + k];
#pragma unroll
        for (int k = 0; k < 3; ++k) gW[9 + k] += ch[LK_T + 12 + k];
#pragma unroll
        for (int k = 0; k < 9; ++k) gW[k] += ch[LK_T + 15 + k];
      }
      // pA = v x* (M v) (- X^T f, taken in (C)); MA = M.
      const float* Mi = P + OFF_M + i * 36;
      float v[6];
      sl.ld(i * LK + LK_V, 6, v);
      {
        float gpA[6], gM[36];
        sl.ld(i * LK + LK_PA, 6, gpA);
#pragma unroll
        for (int k = 0; k < 36; ++k) gM[k] = 0.0f;
        vxstar_Mv_vjp(v, Mi, gpA, gv, PARAMS_GRAD ? gM : nullptr);
        if (PARAMS_GRAD) {
          float gMA[36];
          sl.ld(i * LK + LK_MA, 36, gMA);
#pragma unroll
          for (int k = 0; k < 36; ++k) gM[k] += gMA[k];
          acc.add(OFF_M + i * 36, 36, gM);
        }
      }
      if (i == 0) {
        // v0 = X0^-1 v; R0i = R0^T, p0i = -R0i p0; WR0 = RB R_suc0,
        // Wp0 = p + RB p_suc0, Wv0 = v (floating base).
        float R0i[9], p0i[3], p0[3], bR0i[9], bp0i[3], bv[6], bp[3], bq[4];
        base_inverse(sl, R0i, p0i);
        sl.ld(LK_WP, 3, p0);
        sl.ld(SL_BASE + BS_BR0I, 9, bR0i);
        sl.ld(SL_BASE + BS_BP0I, 3, bp0i);
        sl.ld(SL_BASE + BS_BV, 6, bv);
        sl.ld(SL_BASE + BS_BP, 3, bp);
        sl.ld(SL_BASE + BS_BQ, 4, bq);
        if (FLOATING) {
          const float vin[6] = {x.v[0], x.v[1], x.v[2], x.v[3], x.v[4], x.v[5]};
          xv_vjp(R0i, p0i, vin, gv, bR0i, bp0i, bv);
        }
        const float nb[3] = {-bp0i[0], -bp0i[1], -bp0i[2]};
        mv3_vjp(R0i, p0, nb, bR0i, gW + 9);
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) gW[cc * 3 + r] += bR0i[r * 3 + cc];
        const float q[4] = {x.q[0], x.q[1], x.q[2], x.q[3]};
        const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
        const float nrm = qw * qw + qx * qx + qy * qy + qz * qz;
        const float nn = nrm == 0.0f ? 1.0f : nrm;
        const float s2 = 2.0f / nn;
        float RB[9], Rs[9], ps[3], bRB[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        quat_rot(q, RB);
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
#pragma unroll
        for (int k = 0; k < 3; ++k) out.put(out.p, k, bp[k]);
#pragma unroll
        for (int k = 0; k < 4; ++k) out.put(out.q, k, bq[k]);
#pragma unroll
        for (int k = 0; k < 6; ++k) out.put(out.v, k, bv[k]);
        continue;
      }
      const int lam = JX_LAM[i];
      const float* S = P + OFF_S + i * 6;
      const float sdi = x.sd[i - 1], si = x.s[i - 1];
      float iR[9], ip[3], T[12], gS[6], up[24];
      sl.ld(i * LK + LK_IR, 9, iR);
      sl.ld(i * LK + LK_IP, 3, ip);
      sl.ld(i * LK + LK_T + 8, 12, T);  // the adjoints of iR and ip
      float bsd = c.sd[i - 1] + dt * c.s[i - 1];
      {
        // c = v x vJ, v = X v_lam + vJ
        float vJ[6], bvJ[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gc[6], vl[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) vJ[k] = S[k] * sdi;
        sl.ld(i * LK + LK_A, 6, gc);
        vx_vjp(v, vJ, gc, gv, bvJ);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          bvJ[k] += gv[k];
          up[k] = 0.0f;
        }
        sl.ld(lam * LK + LK_V, 6, vl);
        xv_vjp(iR, ip, vl, gv, T, T + 9, up);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          bsd += S[k] * bvJ[k];
          gS[k] = sdi * bvJ[k];
        }
      }
      // Wv_i = Wv_lam + [R Sl + Wp_i x R Sa ; R Sa]
      float rR[9], rp[3], WR[9], Wp[3];
      relative_transform(P, i, si, rR, rp);
      sl.ld(i * LK + LK_WR, 9, WR);
      sl.ld(i * LK + LK_WP, 3, Wp);
      {
        const float Sl[3] = {S[0] * sdi, S[1] * sdi, S[2] * sdi};
        const float Sa[3] = {S[3] * sdi, S[4] * sdi, S[5] * sdi};
        float RSa[3];
        mv3(WR, Sa, RSa);
        float bRSa[3] = {gW[15], gW[16], gW[17]};
        float bSl[3] = {0.0f, 0.0f, 0.0f}, bSa[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < 6; ++k) up[6 + k] = gW[12 + k];
        cross3_vjp(Wp, RSa, gW + 12, gW + 9, bRSa);
        mv3_vjp(WR, Sa, bRSa, gW, bSa);
        mv3_vjp(WR, Sl, gW + 12, gW, bSl);
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
        float WRl[9];
        sl.ld(lam * LK + LK_WR, 9, WRl);
#pragma unroll
        for (int k = 0; k < 3; ++k) up[12 + k] = gW[9 + k];
#pragma unroll
        for (int k = 0; k < 9; ++k) up[15 + k] = 0.0f;
        mv3_vjp(WRl, rp, gW + 9, up + 15, brp);
        mm3_vjp(WRl, rR, gW, up + 15, brR);
      }
      const float bs = c.s[i - 1] + relative_transform_vjp<PARAMS_GRAD>(P, i, si, brR, brp, acc);
      out.put(out.s, i - 1, bs);
      out.put(out.sd, i - 1, bsd);
      sl.st(i * LK + LK_T, 24, up);
    }
    ln_sync();
  }
}

// ----- kernels -----

__global__ void __launch_bounds__(LN_THREADS)
    step_vjp_kernel(const float* __restrict__ params, StateIn in, const float* __restrict__ tau_in, StateIn ct,
                    StateOut out, float* __restrict__ ct_tau, float* __restrict__ partials, int B, Scalars sc) {
  extern __shared__ float smem[];
  // Env e of the block on lanes e*G .. e*G + G-1; an env past the batch runs
  // env B - 1's step beside the others, so that every lane reaches every
  // barrier and shuffle, and writes and adds nothing.
  const int e = threadIdx.x / G, g = threadIdx.x % G;
  const int b0 = blockIdx.x * ENVS + e;
  const bool valid = b0 < B;
  const int b = valid ? b0 : B - 1;
  const Slot sl{smem + e};
  float* row = smem + SLOT * ES;
  unsigned mask = 0u;
#pragma unroll
  for (int k = 0; k < ENVS; ++k) mask |= 1u << (g + k * G);
  const Acc acc{row, mask, valid, e == 0};
  if (PARAMS_GRAD) {
#pragma unroll 1
    for (int k = threadIdx.x; k < N_PARAMS; k += LN_THREADS) row[k] = 0.0f;
  }
  const EnvIn x = env_in(in, B, b), c = env_in(ct, B, b);
  const ColTau tau{{tau_in + b, B}};
  float vn[6];
  soft_step_lanes(params, sc, sl, g, x, tau, vn);
  ln_sync();
  const VjpOut o{out.s + b, out.sd + b, out.p + b, out.q + b, out.v + b, out.m + b, ct_tau + b, B, valid};
  step_vjp_lanes(params, sc, sl, g, x, tau, c, o, acc, vn);
  if (PARAMS_GRAD) {
    ln_sync();
#pragma unroll 1
    for (int k = threadIdx.x; k < N_PARAMS; k += LN_THREADS) partials[blockIdx.x * N_PARAMS + k] = row[k];
  }
}

}  // namespace

#include "param_sum.cuh"

extern "C" {

int jx_param_count() { return N_PARAMS; }

int jx_step_vjp(const float* params, const float* s, const float* sd, const float* p, const float* q,
                const float* v, const float* m, const float* tau, const float* ct_s, const float* ct_sd,
                const float* ct_p, const float* ct_q, const float* ct_v, const float* ct_m, float* out_s,
                float* out_sd, float* out_p, float* out_q, float* out_v, float* out_m, float* out_tau,
                float* partials, int B, float K, float D, float k_over_d, float mu, float hc_p, float hc_q,
                float gz, float dt, void* stream) {
  if (PARAMS_GRAD && partials == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Scalars sc{K, D, k_over_d, mu, hc_p, hc_q, gz, dt, 0.0f, 0.0f};
  const cudaError_t rc = cudaFuncSetAttribute(step_vjp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(VJP_SMEM_BYTES));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int blocks = (B + ENVS - 1) / ENVS;
  step_vjp_kernel<<<blocks, LN_THREADS, VJP_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      params, StateIn{s, sd, p, q, v, m}, tau, StateIn{ct_s, ct_sd, ct_p, ct_q, ct_v, ct_m},
      StateOut{out_s, out_sd, out_p, out_q, out_v, out_m}, out_tau, partials, B, sc);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry, for the reports: threads a block, envs a block,
// dynamic shared memory a block in bytes, and blocks an SM holds at once
// (the occupancy calculator: registers, threads and shared memory).
int jx_vjp_geometry(int* out) {
  cudaError_t rc = cudaFuncSetAttribute(step_vjp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(VJP_SMEM_BYTES));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks_per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, step_vjp_kernel, LN_THREADS, VJP_SMEM_BYTES);
  out[0] = LN_THREADS;
  out[1] = ENVS;
  out[2] = static_cast<int>(VJP_SMEM_BYTES);
  out[3] = blocks_per_sm;
  return static_cast<int>(rc);
}

int jx_param_sum(const float* partials, int n_blocks, float* out, void* stream) {
  param_sum_kernel<<<(N_PARAMS + SUM_ENTRIES - 1) / SUM_ENTRIES, 32 * SUM_WARPS, 0,
                     static_cast<cudaStream_t>(stream)>>>(partials, n_blocks, out);
  return static_cast<int>(cudaGetLastError());
}

const char* jx_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
