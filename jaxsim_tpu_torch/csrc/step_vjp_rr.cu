// The fused backward of one relaxed-rigid engine step (K4-rr): each env on
// JX_RR_LANES lanes of a warp, its tape in the env's slot of shared memory,
// the model arrays' cotangents summed in shared memory, a row a block out.
//
// Replaces, for relaxed-rigid engines, _step_vjp_kernel of
// jaxsim_tpu/ops/pallas_step.py (built by build_pallas_step_vjp), which
// traces jax.vjp of the engine step inside the kernel and so differentiates
// the contact solve through its hand-written implicit VJP (pcg_implicit,
// pcg_fwd, pcg_bwd of jaxsim_tpu/ops/batched_engine.py). Here the transposed
// step is written by hand from the math, as the twin's _PcgImplicit
// (jaxsim_tpu_torch/ops/batched_engine.py) computes it. For a state, torques
// tau and a cotangent of the output state, one launch runs, in phases apart
// by warp barriers, each tree phase level by level (the header's schedule
// from JX_LAM: the humanoid's tree is 7 deep and at most 4 wide) with a link
// on a lane, each point phase with a point on the lane of its slot:
//  1. the forward: kinematics with the body velocities, root to leaves; the
//     free ABA's pass 2, leaves to root, a link pulling its children's
//     X^T Ma X (lower triangle, mirrored) and X^T pa in descending child
//     order, then the base's Cholesky; its pass 3, root to leaves; the
//     warm-started PCG (rr_setup, rr_cg of rr_step.cuh); the substitution
//     of the solved forces x, a_cont = M^-1 J^T x (the scatter, the
//     substitution passes on the free ABA's factorization);
//  2. on lane 0 the transposed semi-implicit Euler update with the
//     quaternion's renormalization; x's cotangent: the transposed
//     substitution at the base's and joints' acceleration cotangents, then
//     per point the scatter's transpose and m's update m + dt ((x - m) / dt);
//  3. lambda = PCG(x-bar) from zero (rr_cg, the same operator and
//     preconditioner), left in the lanes' registers;
//  4. per point: b-bar = -lambda through the free point acceleration, the
//     reference acceleration, the impedance and delta; <-lambda, A(theta) x>'s
//     cotangents through the gather, the regularizer r_j and rrMinv, summed
//     into the parents' seeds; pass 3 transposed for both chains that share
//     the factorization (the free ABA, and the substitution of x, which also
//     carries the operator's term: the scatter of act x is the scatter of x,
//     x being 0 on inactive points), leaves to root; the base's Cholesky
//     transposed on lane 0; pass 2 transposed, root to leaves; per point the
//     scatter's transpose; pass 1 and the kinematics transposed, leaves to
//     root. A link's adjoints that its parent consumes are pulled by the
//     parent from the child's rows in descending child order, so the tree
//     sums round alike whatever the lanes.
// The preconditioner and the warm start get no cotangent, so state.m's
// cotangent comes from m's update alone. Derivatives at a tie of max/min
// are JAX's (max_grad): half to each side.
//
// The tape: the env's slot is rr_step.cuh's (the free ABA's factorization
// U, d, iR, ip, L0, the contact parents' rows, the solves' F and UM rows),
// then per link the world pose (WR, Wp), v, pA, a and a record of 54 (MA's
// lower triangle, the substitution's a and pA, and the adjoints of U, d, u,
// iR and ip), per point x, and a base row; the torques, the state and the
// output cotangents are read from device memory where they are needed.
// Rows are reused once their forward values are dead: the a row holds the
// world velocity during the kinematics and the adjoint of c after the
// transposed pass 3; pA's row and MA's record hold their adjoints after the
// transposed pass 2; the record holds pass 2's contribution to the parent
// during the forward and pass 1's pulled adjoints during its transpose; F
// and UM hold the transposed substitution of x-bar and the free chain's
// seeds; a contact parent's row holds its world pose and velocity
// adjoints from the points. c, u and the per-point quantities (point_kin,
// the impedance, xi, r_j) are recomputed.
//
// With JX_PARAMS_GRAD each warp sums its model-array cotangents, rrMinv's
// included, in a row of shared memory: a contribution is added over the
// warp's envs by a fixed xor shuffle tree over the lanes that run the same
// link or point, and one lane adds it into the row, which only that lane
// writes at that time. The block adds its warps' rows in warp order into its
// row of `partials` (one a block), and param_sum_kernel (param_sum.cuh,
// K4's) adds the rows in a fixed order: no float atomics, two runs agree to
// the bit.
//
// What bounds it on the card: per-env latency, not HBM. The state, tau and
// the cotangents cross device memory once each way (about 21 MB for the
// humanoid at 8192 envs, 6 us at 3.35 TB/s), and its least operations take
// 7.5 us at the float32 peak (PERF.md). The earlier design ran the
// transposed step on one thread an env with the free ABA's working set in
// local memory and the tape in device memory (1.93 / 3.55 ms kernel only on
// an H100); here the tape stays on chip, 12 KB an env for the humanoid, so
// a block of 16 envs (12 with params_grad, whose warps' rows take room) is
// all an SM holds: 1.55 / 2.45 ms. The model arrays sit in shared memory
// beside the slots, as K3-rr's do: read through the L1 that the slots leave
// (about 28 KB) they made the solves 61 % of the kernel, and they are 68 %
// of it still, 17 M^-1 J^T passes of dependent shared-memory steps at 4 warps
// an SM (chip_probe.py rr_vjp_phases).

#include "rr_step.cuh"

#ifndef JX_PARAMS_GRAD
#define JX_PARAMS_GRAD 0
#endif

static_assert(INTEGRATOR == 0, "step_vjp_rr.cu implements semi-implicit Euler (JX_INTEGRATOR 0)");
static_assert(!JX_RR_TAU_ROW, "step_vjp_rr.cu reads the torques from device memory (JX_RR_TAU_ROW 0)");

#include "vjp_algebra.cuh"
#include "param_sum.cuh"

namespace {

constexpr bool PARAMS_GRAD = JX_PARAMS_GRAD != 0;
constexpr int WARPS = RR_THREADS / 32;

// The tape's rows past rr_step.cuh's slot, an env.
constexpr int T_WR = SLOT;            // (NL, 9) world rotation
constexpr int T_WP = T_WR + NL * 9;   // (NL, 3) world position
constexpr int T_V = T_WP + NL * 3;    // (NL, 6) body velocity
constexpr int T_PA = T_V + NL * 6;    // (NL, 6) the free pA, then its adjoint
constexpr int T_A = T_PA + NL * 6;    // (NL, 6) world velocity (kinematics), free a, then c's adjoint
constexpr int RW = 54;                // a link's record:
constexpr int R_MA = 0;               //  MA's lower triangle (21), then MA's adjoint (36)
constexpr int R_CON = 21;             //  pass 2: X^T Ma X's lower triangle (21) and X^T pa (6) for the parent
constexpr int R_A0 = 21;              //  the substitution's a (6), then its a_i's adjoint
constexpr int R_GUD = 27;             //  the adjoints of U and d (7); the points' seed of the substitution's a first
constexpr int R_GU = 34;              //  the adjoints of u, free and substitution (2)
constexpr int R_P0 = 36;              //  the substitution's pA (6), then its adjoint
constexpr int R_GX = 42;              //  the adjoints of iR and ip (12)
constexpr int R_PULL = 30;            //  pass 1's adjoints for the parent (24): v, Wv, Wp, WR
constexpr int T_R = T_A + NL * 6;     // (NL, RW)
constexpr int T_X = T_R + NL * RW;    // (NC, 3) the solved forces x
constexpr int T_BASE = T_X + NC * 3;  // the base's adjoints:
constexpr int B_GA0 = 0, B_GW0 = 6, B_BV = 18, B_BQ = 24, B_BP = 28, B_BR0I = 31, B_BP0I = 40, BASE = 43;
constexpr int ROWS = T_BASE + BASE;
static_assert(ROWS == JX_RR_ROWS, "the generated header sizes the env's rows as this layout does");
// A contact parent's row after the points' cotangents: the adjoints of its
// world rotation, position and velocity (18 of 24).
constexpr int PG_WR = 0, PG_WP = 9, PG_WV = 12;
constexpr size_t VJP_SMEM_BYTES =
    (static_cast<size_t>(ROWS) * ES + N_PARAMS + (PARAMS_GRAD ? WARPS * N_PARAMS : 0)) * sizeof(float);

__device__ __forceinline__ void sld(Slot sl, int j, int n, float* o) {
#pragma unroll
  for (int k = 0; k < 36; ++k)
    if (k < n) o[k] = sl[j + k];
}
__device__ __forceinline__ void sst(Slot sl, int j, int n, const float* x) {
#pragma unroll
  for (int k = 0; k < 36; ++k)
    if (k < n) sl[j + k] = x[k];
}
__device__ __forceinline__ int rec(int i) { return T_R + i * RW; }

// A link's pair (iR, ip) from the slot.
__device__ __forceinline__ void load_pair(Slot sl, int i, float* iR, float* ip) {
  sld(sl, SL_IR + i * 9, 9, iR);
  sld(sl, SL_IP + i * 3, 3, ip);
}

// A link's full MA from its lower triangle.
__device__ __forceinline__ void load_ma(Slot sl, int i, float* MA) {
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int cc = 0; cc < 6; ++cc) MA[r * 6 + cc] = sl[rec(i) + R_MA + tri(r, cc)];
}

// -S.f: a pass's u from its bias force (the free one adds tau).
__device__ __forceinline__ float neg_sdot(const float* S, const float* f) {
  float sp = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) sp += S[k] * f[k];
  return -sp;
}

// One row of a state leaf for one env: entry k at x[k * n].
struct Col {
  const float* x;
  int n;
  __device__ __forceinline__ float operator[](int k) const { return x[k * n]; }
};
struct EnvCols {
  Col s, sd, p, q, v, m;
};
__device__ __forceinline__ EnvCols env_cols(const StateIn& in, int B, int b) {
  return EnvCols{{in.s + b, B}, {in.sd + b, B}, {in.p + b, B}, {in.q + b, B}, {in.v + b, B}, {in.m + b, B}};
}

// The warp's row of model-array cotangents, as one lane sees it: `add` sums
// a contribution over the warp's envs (the lanes in `mask`, which run the
// same link or point) and the first env's lane adds it into the row. Envs
// past the batch add zeros. Without params_grad it does nothing.
struct Acc {
  float* row;
  unsigned mask;
  bool valid, lead;
  __device__ __forceinline__ void add(int off, float x) const {
    if (!PARAMS_GRAD) return;
    x = valid ? x : 0.0f;
#pragma unroll
    for (int o = G; o < 32; o <<= 1) x += __shfl_xor_sync(mask, x, o);
    if (lead) row[off] += x;
  }
  __device__ __forceinline__ void add(int off, int n, const float* x) const {
#pragma unroll
    for (int k = 0; k < 36; ++k)
      if (k < n) add(off + k, x[k]);
  }
};

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

// (R0^T, -R0^T p0): the inverse of the base's world pose.
__device__ __forceinline__ void base_inverse(Slot sl, float* R0i, float* p0i) {
  float R0[9], p0[3], t[3];
  sld(sl, T_WR, 9, R0);
  sld(sl, T_WP, 3, p0);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) R0i[r * 3 + cc] = R0[cc * 3 + r];
  mv3(R0i, p0, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) p0i[k] = -t[k];
}

// The links of level `lev` on lane g (lev -1: the base, on lane 0).
struct Level {
  int n0, n1;
  __device__ __forceinline__ Level(int lev, int g)
      : n0(lev < 0 ? 0 : JX_RR_LEV_OFF[lev] + g), n1(lev < 0 ? (g == 0 ? 1 : 0) : JX_RR_LEV_OFF[lev + 1]) {}
  static __device__ __forceinline__ int link(int lev, int n) { return lev < 0 ? 0 : JX_RR_LEV_LINK[n]; }
};

// ----- the forward: kinematics and the free articulated-body algorithm -----

// Fills the slot's factorization and contact-parent rows (for rr_setup and
// rr_cg) and the tape's pose, v, MA, pA and a.
__device__ void free_aba_lanes(const float* P, const Scalars& sc, Slot sl, int g, const EnvCols& x,
                               const Col& tau) {
  // Kinematics and the body velocities, root to leaves.
  if (g == 0) {
    const float q[4] = {x.q[0], x.q[1], x.q[2], x.q[3]};
    float RB[9], Rs[9], ps[3], WR[9], Wp[3], t[3], Wv[6], v0[6];
    quat_rot(q, RB);
    h_rot(P + OFF_SUCH, Rs);
    h_pos(P + OFF_SUCH, ps);
    mm3(RB, Rs, WR);
    mv3(RB, ps, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) Wp[k] = x.p[k] + t[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) Wv[k] = FLOATING ? x.v[k] : 0.0f;
    sst(sl, T_WR, 9, WR);
    sst(sl, T_WP, 3, Wp);
    sst(sl, T_A, 6, Wv);
    if (FLOATING) {
      float R0i[9], p0i[3];
      base_inverse(sl, R0i, p0i);
      xv(R0i, p0i, Wv, v0);
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k) v0[k] = 0.0f;
    }
    sst(sl, T_V, 6, v0);
    if (JX_HASF[0]) {
      const int o = SL_PAR + JX_RR_PAR_ROW[0] * 24;
      sst(sl, o + PAR_WR, 9, WR);
      sst(sl, o + PAR_WP, 3, Wp);
      sst(sl, o + PAR_WV, 6, Wv);
    }
  }
  __syncwarp();
#pragma unroll 1
  for (int lev = 0; lev < NLEV; ++lev) {
#pragma unroll 1
    for (int n = JX_RR_LEV_OFF[lev] + g; n < JX_RR_LEV_OFF[lev + 1]; n += G) {
      const int i = JX_RR_LEV_LINK[n], lam = JX_LAM[i];
      float rR[9], rp[3], t[3], WRl[9], Wpl[3], Wvl[6], WR[9], Wp[3], iR[9], ip[3];
      relative_transform(P, i, x.s[i - 1], rR, rp);
      sld(sl, T_WR + lam * 9, 9, WRl);
      sld(sl, T_WP + lam * 3, 3, Wpl);
      sld(sl, T_A + lam * 6, 6, Wvl);
      mm3(WRl, rR, WR);
      mv3(WRl, rp, t);
#pragma unroll
      for (int k = 0; k < 3; ++k) Wp[k] = Wpl[k] + t[k];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) iR[r * 3 + cc] = rR[cc * 3 + r];
      mv3(iR, rp, t);
#pragma unroll
      for (int k = 0; k < 3; ++k) ip[k] = -t[k];
      const float* S = P + OFF_S + i * 6;
      const float sdi = x.sd[i - 1];
      const float Sl[3] = {S[0] * sdi, S[1] * sdi, S[2] * sdi};
      const float Sa[3] = {S[3] * sdi, S[4] * sdi, S[5] * sdi};
      float RSa[3], RSl[3], cr[3], Wv[6];
      mv3(WR, Sa, RSa);
      mv3(WR, Sl, RSl);
      cross3(Wp, RSa, cr);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        Wv[k] = Wvl[k] + (RSl[k] + cr[k]);
        Wv[k + 3] = Wvl[k + 3] + RSa[k];
      }
      sst(sl, T_WR + i * 9, 9, WR);
      sst(sl, T_WP + i * 3, 3, Wp);
      sst(sl, SL_IR + i * 9, 9, iR);
      sst(sl, SL_IP + i * 3, 3, ip);
      sst(sl, T_A + i * 6, 6, Wv);
      float vl[6], v[6];
      sld(sl, T_V + lam * 6, 6, vl);
      xv(iR, ip, vl, v);
#pragma unroll
      for (int k = 0; k < 6; ++k) v[k] += S[k] * sdi;
      sst(sl, T_V + i * 6, 6, v);
      if (JX_HASF[i]) {
        const int o = SL_PAR + JX_RR_PAR_ROW[i] * 24;
        sst(sl, o + PAR_WR, 9, WR);
        sst(sl, o + PAR_WP, 3, Wp);
        sst(sl, o + PAR_WV, 6, Wv);
      }
    }
    __syncwarp();
  }

  // Pass 2: articulated inertias and bias forces, leaves to root; the base
  // (lane 0) last.
#pragma unroll 1
  for (int lev = NLEV - 1; lev >= -1; --lev) {
    const Level L(lev, g);
#pragma unroll 1
    for (int n = L.n0; n < L.n1; n += G) {
      const int i = Level::link(lev, n), lam = JX_LAM[i];
      const float* Mi = P + OFF_M + i * 36;
      float v[6], MA[36], pA[6];
      sld(sl, T_V + i * 6, 6, v);
      vxstar_Mv(v, Mi, pA);
#pragma unroll
      for (int k = 0; k < 36; ++k) MA[k] = Mi[k];
      if (i != 0 || FLOATING) {
#pragma unroll 1
        for (int h = JX_RR_CH_OFF[i]; h < JX_RR_CH_OFF[i + 1]; ++h) {
          const int ch = JX_RR_CH[h];
#pragma unroll
          for (int r = 0; r < 6; ++r)
#pragma unroll
            for (int cc = 0; cc < 6; ++cc) MA[r * 6 + cc] += sl[rec(ch) + R_CON + tri(r, cc)];
#pragma unroll
          for (int k = 0; k < 6; ++k) pA[k] += sl[rec(ch) + R_CON + 21 + k];
        }
      }
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc <= r; ++cc) sl[rec(i) + R_MA + tri(r, cc)] = MA[r * 6 + cc];
      sst(sl, T_PA + i * 6, 6, pA);
      if (i == 0) {
        float a0[6];
        if (FLOATING) {
          float Lc[36], xs[6];
          chol6_factor(MA, Lc);
          chol6_substitute(Lc, pA, xs);
          sst(sl, SL_L0, 36, Lc);
#pragma unroll
          for (int k = 0; k < 6; ++k) a0[k] = -xs[k];
        } else {
          const float g6[6] = {0.0f, 0.0f, sc.gz, 0.0f, 0.0f, 0.0f};
          float R0i[9], p0i[3], t[6];
          base_inverse(sl, R0i, p0i);
          xv(R0i, p0i, g6, t);
#pragma unroll
          for (int k = 0; k < 6; ++k) a0[k] = -t[k];
        }
        sst(sl, T_A, 6, a0);
        if (JX_HASF[0]) sst(sl, SL_PAR + JX_RR_PAR_ROW[0] * 24 + PAR_A, 6, a0);
        continue;
      }
      const float* S = P + OFF_S + i * 6;
      float U[6], dd = 0.0f;
      mv6(MA, S, U);
#pragma unroll
      for (int k = 0; k < 6; ++k) dd += S[k] * U[k];
      sst(sl, SL_U + i * 6, 6, U);
      sl[SL_D + i] = dd;
      if (lam == 0 && !FLOATING) continue;
      const float u = tau[i - 1] + neg_sdot(S, pA);
      float c[6], Ma[36], pa[6], t[6], iR[9], ip[3], X[36], MaX[36];
      joint_bias(S, x.sd[i - 1], v, c);
      const float inv_d = 1.0f / dd;
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) Ma[r * 6 + cc] = MA[r * 6 + cc] - U[r] * U[cc] * inv_d;
      mv6(Ma, c, t);
      const float ud = u * inv_d;
#pragma unroll
      for (int k = 0; k < 6; ++k) pa[k] = pA[k] + t[k] + U[k] * ud;
      load_pair(sl, i, iR, ip);
      build_X(iR, ip, X);
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
        for (int cc = 0; cc <= r; ++cc) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < 6; ++k) acc += X[k * 6 + r] * MaX[k * 6 + cc];
          sl[rec(i) + R_CON + tri(r, cc)] = acc;
        }
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) acc += X[k * 6 + r] * pa[k];
        sl[rec(i) + R_CON + 21 + r] = acc;
      }
    }
    __syncwarp();
  }

  // Pass 3: the free accelerations, root to leaves.
#pragma unroll 1
  for (int lev = 0; lev < NLEV; ++lev) {
#pragma unroll 1
    for (int n = JX_RR_LEV_OFF[lev] + g; n < JX_RR_LEV_OFF[lev + 1]; n += G) {
      const int i = JX_RR_LEV_LINK[n], lam = JX_LAM[i];
      const float* S = P + OFF_S + i * 6;
      float U[6], pA[6], v[6], c[6], iR[9], ip[3], al[6], a_i[6];
      sld(sl, SL_U + i * 6, 6, U);
      sld(sl, T_PA + i * 6, 6, pA);
      sld(sl, T_V + i * 6, 6, v);
      joint_bias(S, x.sd[i - 1], v, c);
      load_pair(sl, i, iR, ip);
      sld(sl, T_A + lam * 6, 6, al);
      xv(iR, ip, al, a_i);
      float ua = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        a_i[k] += c[k];
        ua += U[k] * a_i[k];
      }
      const float u = tau[i - 1] + neg_sdot(S, pA);
      const float sddi = (u - ua) / sl[SL_D + i];
#pragma unroll
      for (int k = 0; k < 6; ++k) a_i[k] += S[k] * sddi;
      sst(sl, T_A + i * 6, 6, a_i);
      if (JX_HASF[i]) sst(sl, SL_PAR + JX_RR_PAR_ROW[i] * 24 + PAR_A, 6, a_i);
    }
    __syncwarp();
  }
}

// The substitution of the solved forces x (the lanes' slots), the twin's
// _minv_apply on the free ABA's factorization with the link forces of
// _rr_scatter: each link's bias force pA0 and acceleration a0 to its record.
__device__ void subst_lanes(const float* P, Slot sl, int g, const int* pt, const float* act, const float* x) {
  rr_scatter(P, sl, g, pt, act, x, false);  // the F rows: the parents' negated point forces, 0 elsewhere
#pragma unroll 1
  for (int lev = NLEV - 1; lev >= -1; --lev) {
    const Level L(lev, g);
#pragma unroll 1
    for (int n = L.n0; n < L.n1; n += G) {
      const int i = Level::link(lev, n);
      float f[6];
      sld(sl, SL_F + i * 6, 6, f);
#pragma unroll 1
      for (int h = JX_RR_CH_OFF[i]; h < JX_RR_CH_OFF[i + 1]; ++h) {
        const int ch = JX_RR_CH[h];
#pragma unroll
        for (int k = 0; k < 6; ++k) f[k] += sl[SL_F + ch * 6 + k];
      }
      sst(sl, rec(i) + R_P0, 6, f);
      if (i == 0) {
        float a0[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (FLOATING) {
          float Lc[36], xs[6];
          sld(sl, SL_L0, 36, Lc);
          chol6_substitute(Lc, f, xs);
#pragma unroll
          for (int k = 0; k < 6; ++k) a0[k] = -xs[k];
        }
        sst(sl, rec(0) + R_A0, 6, a0);
        continue;
      }
      if (JX_LAM[i] != 0 || FLOATING) {
        const float u = neg_sdot(P + OFF_S + i * 6, f);
        const float ud = u / sl[SL_D + i];
        float pa[6], t[6], U[6], iR[9], ip[3];
        sld(sl, SL_U + i * 6, 6, U);
        load_pair(sl, i, iR, ip);
#pragma unroll
        for (int k = 0; k < 6; ++k) pa[k] = f[k] + U[k] * ud;
        xtf(iR, ip, pa, t);
        sst(sl, SL_F + i * 6, 6, t);
      }
    }
    __syncwarp();
  }
#pragma unroll 1
  for (int lev = 0; lev < NLEV; ++lev) {
#pragma unroll 1
    for (int n = JX_RR_LEV_OFF[lev] + g; n < JX_RR_LEV_OFF[lev + 1]; n += G) {
      const int i = JX_RR_LEV_LINK[n];
      const float* S = P + OFF_S + i * 6;
      float al[6], ai[6], U[6], iR[9], ip[3], p0[6];
      sld(sl, rec(JX_LAM[i]) + R_A0, 6, al);
      load_pair(sl, i, iR, ip);
      sld(sl, SL_U + i * 6, 6, U);
      sld(sl, rec(i) + R_P0, 6, p0);
      xv(iR, ip, al, ai);
      float ua = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) ua += U[k] * ai[k];
      const float sdd = (neg_sdot(S, p0) - ua) / sl[SL_D + i];
#pragma unroll
      for (int k = 0; k < 6; ++k) ai[k] += S[k] * sdd;
      sst(sl, rec(i) + R_A0, 6, ai);
    }
    __syncwarp();
  }
}

// ----- the transposed step -----

// Lane 0: the transposed semi-implicit Euler update with the quaternion's
// renormalization, into the base row: the base acceleration's cotangent, the
// base pose's (WR0, Wp0), the new base velocity's, q's and p's.
__device__ void sie_vjp(const Scalars& sc, Slot sl, const EnvCols& x, const EnvCols& c) {
  const float dt = sc.dt;
  float a0[6], vn[6], WR0[9], Wp0[3];
  sld(sl, T_WR, 9, WR0);
  sld(sl, T_WP, 3, Wp0);
#pragma unroll
  for (int k = 0; k < 6; ++k) a0[k] = sl[T_A + k] + sl[rec(0) + R_A0 + k];
  if (FLOATING) {
    float W_a[6];
    xv(WR0, Wp0, a0, W_a);
    W_a[2] += sc.gz;
#pragma unroll
    for (int k = 0; k < 6; ++k) vn[k] = x.v[k] + dt * W_a[k];
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) vn[k] = x.v[k];
  }
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
    float dot = 0.0f, bqn[4], cq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cq[k] = c.q[k];
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
    const float p[3] = {x.p[0], x.p[1], x.p[2]};
    float dcp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      bp[k] = c.p[k];
      dcp[k] = dt * bp[k];
      bvn[k] += dcp[k];
    }
    cross3_vjp(vn + 3, p, dcp, bvn + 3, bp);
  }
  float ga0[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gW0[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) gW0[k] = 0.0f;
  if (FLOATING) {
    float bWa[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) bWa[k] = dt * bvn[k];
    xv_vjp(WR0, Wp0, a0, bWa, gW0, gW0 + 9, ga0);
  }
  sst(sl, T_BASE + B_GA0, 6, ga0);
  sst(sl, T_BASE + B_GW0, 12, gW0);
  sst(sl, T_BASE + B_BV, 6, bvn);
  sst(sl, T_BASE + B_BQ, 4, bq);
  sst(sl, T_BASE + B_BP, 3, bp);
}

// x's cotangent into the lanes' `r` (their slots' x-bar), and m's out: the
// substitution's transpose at the base acceleration's cotangent and the
// joint accelerations', then per point the scatter's and m's update.
__device__ void x_bar_lanes(const float* P, const Scalars& sc, Slot sl, int g, const int* pt, const EnvCols& c,
                            float* out_m, int B, bool valid, float* r) {
  const float dt = sc.dt;
  // Leaves to root: a link's a_i cotangent (F) and its joint's u cotangent
  // (UM); the parent pulls X^T of its children's.
#pragma unroll 1
  for (int lev = NLEV - 1; lev >= -1; --lev) {
    const Level L(lev, g);
#pragma unroll 1
    for (int n = L.n0; n < L.n1; n += G) {
      const int i = Level::link(lev, n);
      float ga[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (i == 0) sld(sl, T_BASE + B_GA0, 6, ga);
#pragma unroll 1
      for (int h = JX_RR_CH_OFF[i]; h < JX_RR_CH_OFF[i + 1]; ++h) {
        const int ch = JX_RR_CH[h];
        float cR[9], cp[3], gc[6], t[6];
        load_pair(sl, ch, cR, cp);
        sld(sl, SL_F + ch * 6, 6, gc);
        xtf(cR, cp, gc, t);
#pragma unroll
        for (int k = 0; k < 6; ++k) ga[k] += t[k];
      }
      if (i == 0) {
        float gp[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (FLOATING) {
          float Lc[36], y[6];
          sld(sl, SL_L0, 36, Lc);
          chol6_substitute(Lc, ga, y);
#pragma unroll
          for (int k = 0; k < 6; ++k) gp[k] = -y[k];
        }
        sst(sl, SL_F, 6, gp);
        continue;
      }
      const float* S = P + OFF_S + i * 6;
      float U[6];
      sld(sl, SL_U + i * 6, 6, U);
      float b = dt * (c.sd[i - 1] + dt * c.s[i - 1]);
#pragma unroll
      for (int k = 0; k < 6; ++k) b += S[k] * ga[k];
      const float bd = b / sl[SL_D + i];
      sl[SL_UM + i] = bd;
#pragma unroll
      for (int k = 0; k < 6; ++k) ga[k] -= U[k] * bd;
      sst(sl, SL_F + i * 6, 6, ga);
    }
    __syncwarp();
  }
  // Root to leaves: -pA's cotangent (F).
#pragma unroll 1
  for (int lev = 0; lev < NLEV; ++lev) {
#pragma unroll 1
    for (int n = JX_RR_LEV_OFF[lev] + g; n < JX_RR_LEV_OFF[lev + 1]; n += G) {
      const int i = JX_RR_LEV_LINK[n];
      const float* S = P + OFF_S + i * 6;
      float gpa[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float bu = sl[SL_UM + i];
      if (JX_LAM[i] != 0 || FLOATING) {
        float iR[9], ip[3], gl[6], U[6];
        load_pair(sl, i, iR, ip);
        sld(sl, SL_F + JX_LAM[i] * 6, 6, gl);
        xv(iR, ip, gl, gpa);
        sld(sl, SL_U + i * 6, 6, U);
        float ug = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) ug += U[k] * gpa[k];
        bu += ug / sl[SL_D + i];
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) gpa[k] -= S[k] * bu;
      sst(sl, SL_F + i * 6, 6, gpa);
    }
    __syncwarp();
  }
  // Per point: f = [y ; Lp x y], y = Rp^T x, pA = -f; and m' = m + dt md,
  // md = (x - m) / dt.
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    const int ci = pt[k];
#pragma unroll
    for (int j = 0; j < 3; ++j) r[k * 3 + j] = 0.0f;
    if (ci < 0) continue;
    const int par = JX_RR_GROUP_LINK[k];
    const float* Lp = P + OFF_CP + ci * 3;
    float gf[6], by[3], bx[3], WR[9];
#pragma unroll
    for (int j = 0; j < 6; ++j) gf[j] = -sl[SL_F + par * 6 + j];
#pragma unroll
    for (int j = 0; j < 3; ++j) by[j] = gf[j];
    cross3_vjp(Lp, by, gf + 3, nullptr, by);  // by is read before it is added to
    sld(sl, T_WR + par * 9, 9, WR);
    mv3(WR, by, bx);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float cm = c.m[ci * 3 + j];
      const float bmd = dt * cm;
      r[k * 3 + j] = bx[j] + bmd / dt;
      if (valid) out_m[(ci * 3 + j) * B] = cm - bmd / dt;
    }
  }
}

// Per point, after lambda (the lanes' `lam`): b-bar = -lambda and
// <-lambda, A(theta) x>'s cotangents, summed over each parent's points into
// its seeds: the free chain's a (F row), the substitution's a (the record's
// GUD rows) and the world pose and velocity (the parent's row); rrMinv's and
// the points' Lp into the model arrays' row.
__device__ void points_vjp(const float* P, const Scalars& sc, Slot sl, int g, const int* pt, const float* lam,
                           const Acc& acc) {
  const float nh[3] = {0.0f, 0.0f, 1.0f};
  float sum[30];
#pragma unroll
  for (int j = 0; j < 30; ++j) sum[j] = 0.0f;
  // Unrolled, so that the lane's point vectors stay in registers.
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    const int ci = pt[k], par = JX_RR_GROUP_LINK[k];
    const int o = SL_PAR + JX_RR_GROUP_PAR[k] * 24;
    // The point's seeds: the free a's (0..5), the substitution's (6..11),
    // the parent's world rotation, position and velocity (12..29).
    float w[30];
#pragma unroll
    for (int j = 0; j < 30; ++j) w[j] = 0.0f;
    if (ci >= 0) {
      const float* Lp = P + OFF_CP + ci * 3;
      float Rp[9], Wp[3], Wv[6], pc[3], pd[3], t3[3];
      sld(sl, o + PAR_WR, 9, Rp);
      sld(sl, o + PAR_WP, 3, Wp);
      sld(sl, o + PAR_WV, 6, Wv);
      const float* om = Wv + 3;
      mv3(Rp, Lp, t3);
#pragma unroll
      for (int j = 0; j < 3; ++j) pc[j] = t3[j] + Wp[j];
      cross3(om, pc, t3);
#pragma unroll
      for (int j = 0; j < 3; ++j) pd[j] = Wv[j] + t3[j];
      const float delta = fmaxf(-pc[2], 0.0f);
      const float act = delta > 0.0f ? 1.0f : 0.0f;
      float xc[3];
      sld(sl, T_X + ci * 3, 3, xc);
      float xi[3], xx[3], z[3], coeff[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        xx[j] = delta * fabsf(nh[j]) / sc.rr_width;
        const float ya = sc.rr_ca * rr_pow(xx[j], sc.rr_power);
        const float yb = 1.0f - sc.rr_cb * rr_pow(fmaxf(1.0f - xx[j], 0.0f), sc.rr_power);
        const float y = xx[j] < sc.rr_mid ? ya : yb;
        z[j] = sc.rr_dmin + y * sc.rr_span;
        const float xj = fminf(fmaxf(z[j], sc.rr_dmin), sc.rr_dmax);
        xi[j] = xx[j] > 1.0f ? sc.rr_dmax : xj;
        coeff[j] = (sc.rr_c2mu2 * (1.0f - xi[j]) / (xi[j] + 1e-12f)) * sc.rr_c1mu2;
      }
      const float* Mi = P + OFF_RRMINV + ci * 9;
      // neg_b's cotangent is lambda: b_j = act (pdd_j - aref_j).
      float bo[3], baref[3], br[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        bo[j] = -act * lam[k * 3 + j];
        baref[j] = act * lam[k * 3 + j];
        br[j] = -lam[k * 3 + j] * xc[j];  // <-lambda, (r + reg) x>
      }
      float gR[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gL[3] = {0.0f, 0.0f, 0.0f};
      float gp[3] = {0.0f, 0.0f, 0.0f}, gpd[3] = {0.0f, 0.0f, 0.0f}, gom[3] = {0.0f, 0.0f, 0.0f};
      {
        // The operator's gather, act Rp (a_c_lin + a_c_ang x Lp), at -act lambda,
        // and the free point acceleration's, pdd = Rp (a_lin + a_ang x Lp) + w x pd + g.
        float ac[6], af[6];
        sld(sl, rec(par) + R_A0, 6, ac);
        sld(sl, o + PAR_A, 6, af);
        gather_vjp(Rp, Lp, ac, bo, w + 6, gR, gL);
        gather_vjp(Rp, Lp, af, bo, w, gR, gL);
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
      acc.add(OFF_RRMINV + ci * 9, 9, gM);
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
      float* gw = w + 12;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gw[PG_WV + j] += gpd[j];
        gw[PG_WV + 3 + j] += gom[j];
      }
      cross3_vjp(om, pc, gpd, gw + PG_WV + 3, gp);
#pragma unroll
      for (int j = 0; j < 3; ++j) gw[PG_WP + j] += gp[j];
      mv3_vjp(Rp, Lp, gp, gR, gL);
#pragma unroll
      for (int j = 0; j < 9; ++j) gw[PG_WR + j] += gR[j];
      acc.add(OFF_CP + ci * 3, 3, gL);
    }
#pragma unroll
    for (int j = 0; j < 30; ++j) sum[j] += lanes_sum(w[j]);
    if (k == OWN - 1 || JX_RR_GROUP_LINK[k + 1] != par) {
      // The parent's last group: every lane has read its rows.
      if (g == 0) {
        sst(sl, SL_F + par * 6, 6, sum);
        sst(sl, rec(par) + R_GUD, 6, sum + 6);
        sst(sl, o, 18, sum + 12);
      }
#pragma unroll
      for (int j = 0; j < 30; ++j) sum[j] = 0.0f;
    }
  }
  __syncwarp();
}

// Pass 3 transposed, leaves to root, for both chains: the free ABA (0) and
// the substitution (1). Leaves per link the adjoints of c (the a row), of U
// and d, of u and of (iR, ip), and the substitution's a_i adjoint (its A0
// rows) for the parent.
__device__ void pass3_vjp(const float* P, const Scalars& sc, Slot sl, int g, const EnvCols& x, const EnvCols& c,
                          const Col& tau, const Acc& acc) {
  const float dt = sc.dt;
#pragma unroll 1
  for (int lev = NLEV - 1; lev >= 0; --lev) {
#pragma unroll 1
    for (int n = JX_RR_LEV_OFF[lev] + g; n < JX_RR_LEV_OFF[lev + 1]; n += G) {
      const int i = JX_RR_LEV_LINK[n], lam = JX_LAM[i];
      const float* S = P + OFF_S + i * 6;
      // The seeds (the points'), then the children's adjoints pulled.
      float gf[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, g0[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (JX_HASF[i]) {
        sld(sl, SL_F + i * 6, 6, gf);
        sld(sl, rec(i) + R_GUD, 6, g0);
      }
#pragma unroll 1
      for (int h = JX_RR_CH_OFF[i]; h < JX_RR_CH_OFF[i + 1]; ++h) {
        const int ch = JX_RR_CH[h];
        float cR[9], cp[3], b[6], t[6];
        load_pair(sl, ch, cR, cp);
        sld(sl, T_A + ch * 6, 6, b);
        xtf(cR, cp, b, t);
#pragma unroll
        for (int k = 0; k < 6; ++k) gf[k] += t[k];
        sld(sl, rec(ch) + R_A0, 6, b);
        xtf(cR, cp, b, t);
#pragma unroll
        for (int k = 0; k < 6; ++k) g0[k] += t[k];
      }
      float U[6], iR[9], ip[3], v[6], cb[6], pf[6], p0[6];
      float gU[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gS[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float gX[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gu[2];
      sld(sl, SL_U + i * 6, 6, U);
      load_pair(sl, i, iR, ip);
      sld(sl, T_V + i * 6, 6, v);
      sld(sl, T_PA + i * 6, 6, pf);
      sld(sl, rec(i) + R_P0, 6, p0);
      joint_bias(S, x.sd[i - 1], v, cb);
      const float d = sl[SL_D + i];
      const float bsdd = dt * (c.sd[i - 1] + dt * c.s[i - 1]);
#pragma unroll 1
      for (int chain = 0; chain < 2; ++chain) {
        float al[6], ai[6], ga[6], u;
        if (chain == 0) {
          sld(sl, T_A + lam * 6, 6, al);
          u = tau[i - 1] + neg_sdot(S, pf);
        } else {
          sld(sl, rec(lam) + R_A0, 6, al);
          u = neg_sdot(S, p0);
        }
        xv(iR, ip, al, ai);
        if (chain == 0) {
#pragma unroll
          for (int k = 0; k < 6; ++k) ai[k] += cb[k];
        }
        float ua = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          ua += U[k] * ai[k];
          ga[k] = chain == 0 ? gf[k] : g0[k];
        }
        const float sdd = (u - ua) / d;
        float bs = bsdd;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          bs += S[k] * ga[k];
          gS[k] += sdd * ga[k];
        }
        const float bu = bs / d;
        gu[chain] = bu;
        gU[6] += -bs * sdd / d;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          gU[k] += -bu * ai[k];
          ga[k] -= bu * U[k];  // now ai's cotangent
        }
        sst(sl, chain == 0 ? T_A + i * 6 : rec(i) + R_A0, 6, ga);
        xv_vjp(iR, ip, al, ga, gX, gX + 9, nullptr);
      }
      sst(sl, rec(i) + R_GUD, 7, gU);
      sst(sl, rec(i) + R_GU, 2, gu);
      sst(sl, rec(i) + R_GX, 12, gX);
      acc.add(OFF_S + i * 6, 6, gS);
    }
    __syncwarp();
  }
}

// Lane 0: the base, a0 = -MA0^-1 pA0 by the Cholesky of MA0's lower
// triangle (both chains), or a0 = -X0^-1 g (the free ABA of a fixed base):
// MA0's, pA0's (both chains) and the base pose's adjoints.
__device__ void base_vjp(const Scalars& sc, Slot sl) {
  float gaf[6], ga0[6];
  sld(sl, T_BASE + B_GA0, 6, gaf);
#pragma unroll
  for (int k = 0; k < 6; ++k) ga0[k] = gaf[k];
  if (JX_HASF[0]) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      gaf[k] += sl[SL_F + k];
      ga0[k] += sl[rec(0) + R_GUD + k];
    }
  }
#pragma unroll 1
  for (int h = JX_RR_CH_OFF[0]; h < JX_RR_CH_OFF[1]; ++h) {
    const int ch = JX_RR_CH[h];
    float cR[9], cp[3], b[6], t[6];
    load_pair(sl, ch, cR, cp);
    sld(sl, T_A + ch * 6, 6, b);
    xtf(cR, cp, b, t);
#pragma unroll
    for (int k = 0; k < 6; ++k) gaf[k] += t[k];
    sld(sl, rec(ch) + R_A0, 6, b);
    xtf(cR, cp, b, t);
#pragma unroll
    for (int k = 0; k < 6; ++k) ga0[k] += t[k];
  }
  float gMA0[36], gp[2][6], bR0i[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
                            bp0i[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 36; ++k) gMA0[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) gp[0][k] = gp[1][k] = 0.0f;
  if (FLOATING) {
    float Lc[36];
    sld(sl, SL_L0, 36, Lc);
#pragma unroll 1
    for (int chain = 0; chain < 2; ++chain) {
      float bx[6], y[6], a0[6];
      sld(sl, chain == 0 ? T_A : rec(0) + R_A0, 6, a0);
#pragma unroll
      for (int k = 0; k < 6; ++k) bx[k] = -(chain == 0 ? gaf[k] : ga0[k]);
      chol6_substitute(Lc, bx, y);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        gp[chain][i] = y[i];
        const float xi = -a0[i];
        gMA0[i * 6 + i] += -y[i] * xi;
#pragma unroll
        for (int j = 0; j < i; ++j) gMA0[i * 6 + j] += -(y[i] * -a0[j] + y[j] * xi);
      }
    }
  } else {
    const float g6[6] = {0.0f, 0.0f, sc.gz, 0.0f, 0.0f, 0.0f};
    const float ba0[6] = {-gaf[0], -gaf[1], -gaf[2], -gaf[3], -gaf[4], -gaf[5]};
    float R0i[9], p0i[3];
    base_inverse(sl, R0i, p0i);
    xv_vjp(R0i, p0i, g6, ba0, bR0i, bp0i, nullptr);
  }
  sst(sl, rec(0) + R_MA, 36, gMA0);
  sst(sl, T_PA, 6, gp[0]);
  sst(sl, rec(0) + R_P0, 6, gp[1]);
  sst(sl, T_BASE + B_BR0I, 9, bR0i);
  sst(sl, T_BASE + B_BP0I, 3, bp0i);
}

// Pass 2 transposed (the articulated inertias shared by both chains), root
// to leaves: a link reads its parent's adjoints of MA, the free pA and the
// substitution's pA, and leaves its own in their rows; tau's cotangent out.
__device__ void pass2_vjp(const float* P, Slot sl, int g, const EnvCols& x, const Col& tau, float* ct_tau, int B,
                          bool valid, const Acc& acc) {
#pragma unroll 1
  for (int lev = 0; lev < NLEV; ++lev) {
#pragma unroll 1
    for (int n = JX_RR_LEV_OFF[lev] + g; n < JX_RR_LEV_OFF[lev + 1]; n += G) {
      const int i = JX_RR_LEV_LINK[n], lam = JX_LAM[i];
      const float* S = P + OFF_S + i * 6;
      float U[6], iR[9], ip[3], gU[7], Ma[36], bMa[36], pf[6], p0[6], cb[6], gX[12];
      sld(sl, SL_U + i * 6, 6, U);
      load_pair(sl, i, iR, ip);
      sld(sl, rec(i) + R_GUD, 7, gU);
      sld(sl, T_PA + i * 6, 6, pf);
      sld(sl, rec(i) + R_P0, 6, p0);
      sld(sl, rec(i) + R_GX, 12, gX);
      {
        float v[6];
        sld(sl, T_V + i * 6, 6, v);
        joint_bias(S, x.sd[i - 1], v, cb);
      }
      const float d = sl[SL_D + i];
      const float inv_d = 1.0f / d;
      const float uf = tau[i - 1] + neg_sdot(S, pf), u0 = neg_sdot(S, p0);
      float buf = sl[rec(i) + R_GU], bu0 = sl[rec(i) + R_GU + 1];
      load_ma(sl, i, Ma);
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) Ma[r * 6 + cc] -= U[r] * U[cc] * inv_d;
      // The chains' pa: pA + Ma c + U (u inv_d) (free), pA + U (u / d) (substitution).
      float paf[6], pa0[6];
      {
        float tt[6];
        mv6(Ma, cb, tt);
        const float ud = uf * inv_d, ud0 = u0 / d;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          paf[k] = pf[k] + tt[k] + U[k] * ud;
          pa0[k] = p0[k] + U[k] * ud0;
        }
      }
#pragma unroll
      for (int k = 0; k < 36; ++k) bMa[k] = 0.0f;
      float bpaf[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, bpa0[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (lam != 0 || FLOATING) {
        // MA_lam += X^T Ma X, pA_lam += X^T pa (each chain); the parent's
        // rows hold their adjoints bO, bpf, bp0 now. Ma is symmetric (MA
        // mirrored from its lower triangle, less U U^T / d), so X's adjoint
        // Ma X bO^T + Ma^T X bO is Ma X (bO + bO^T). Unrolled, so that the
        // 6x6 operands stay in registers.
        float X[36], XbO[36], XbS[36], bpf[6], bp0[6], bX[36];
        sld(sl, T_PA + lam * 6, 6, bpf);
        sld(sl, rec(lam) + R_P0, 6, bp0);
        build_X(iR, ip, X);
        {
          float bO[36];
          sld(sl, rec(lam) + R_MA, 36, bO);
#pragma unroll
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
              XbS[r * 6 + cc] = a + at;
            }
        }
        // bMa = X bO X^T
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int cc = 0; cc < 6; ++cc) {
            float a = 0.0f;
#pragma unroll
            for (int k = 0; k < 6; ++k) a += XbO[r * 6 + k] * X[cc * 6 + k];
            bMa[r * 6 + cc] += a;
          }
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int cc = 0; cc < 6; ++cc) {
            float a = paf[r] * bpf[cc] + pa0[r] * bp0[cc];
#pragma unroll
            for (int k = 0; k < 6; ++k) a += Ma[r * 6 + k] * XbS[k * 6 + cc];
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
        build_X_vjp(iR, ip, bX, gX, gX + 9);
      }
      float bU[6], binv_d = 0.0f, bd = gU[6], gc[6], gpf[6], gp0[6];
      sld(sl, T_A + i * 6, 6, gc);
      // free: pa = pA + Ma c + U ud, ud = u inv_d
      {
        float bud = 0.0f, bud0 = 0.0f;
        const float ud0 = u0 / d;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          gpf[k] = bpaf[k];
          gp0[k] = bpa0[k];
          bU[k] = gU[k] + uf * inv_d * bpaf[k] + ud0 * bpa0[k];
          bud += U[k] * bpaf[k];
          bud0 += U[k] * bpa0[k];
        }
        mv6_vjp(Ma, cb, bpaf, bMa, gc);
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
      }
      if (PARAMS_GRAD) {
        float gS[6], MA[36];
        load_ma(sl, i, MA);
#pragma unroll
        for (int k = 0; k < 6; ++k) gS[k] = -buf * pf[k] - bu0 * p0[k] + bd * U[k];
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
      sst(sl, rec(i) + R_MA, 36, bMa);
      sst(sl, T_PA + i * 6, 6, gpf);
      sst(sl, rec(i) + R_P0, 6, gp0);
      sst(sl, rec(i) + R_GX, 12, gX);
      sst(sl, T_A + i * 6, 6, gc);
    }
    __syncwarp();
  }
}

// Per point: the scatter of x transposed (pA = -f, f = [y ; Lp x y], y =
// Rp^T x), Rp's cotangent summed into the parent's world rotation adjoint,
// Lp's into the model arrays' row.
__device__ void scatter_vjp(const float* P, Slot sl, int g, const int* pt, const Acc& acc) {
  float sum[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) sum[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    const int ci = pt[k], par = JX_RR_GROUP_LINK[k];
    float gR[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (ci >= 0) {
      const float* Lp = P + OFF_CP + ci * 3;
      float xc[3], y[3], gf[6], by[3], WR[9], gL[3] = {0.0f, 0.0f, 0.0f};
      sld(sl, T_X + ci * 3, 3, xc);
      sld(sl, T_WR + par * 9, 9, WR);
      mtv3(WR, xc, y);
#pragma unroll
      for (int j = 0; j < 6; ++j) gf[j] = -sl[rec(par) + R_P0 + j];
#pragma unroll
      for (int j = 0; j < 3; ++j) by[j] = gf[j];
      cross3_vjp(Lp, y, gf + 3, gL, by);
      mtv3_vjp(WR, xc, by, gR, nullptr);
      acc.add(OFF_CP + ci * 3, 3, gL);
    }
#pragma unroll
    for (int j = 0; j < 9; ++j) sum[j] += lanes_sum(gR[j]);
    if (k == OWN - 1 || JX_RR_GROUP_LINK[k + 1] != par) {
      if (g == 0) {
        const int o = SL_PAR + JX_RR_GROUP_PAR[k] * 24 + PG_WR;
#pragma unroll
        for (int j = 0; j < 9; ++j) sl[o + j] += sum[j];
      }
#pragma unroll
      for (int j = 0; j < 9; ++j) sum[j] = 0.0f;
    }
  }
  __syncwarp();
}

// Pass 1 and the kinematics transposed, leaves to root, then the base on
// lane 0: the state's cotangents out, and a link's adjoints of its parent's
// v, world velocity, position and rotation in its record for the parent.
__device__ void pass1_vjp(const float* P, const Scalars& sc, Slot sl, int g, const EnvCols& x, const EnvCols& c,
                          const StateOut& out, int B, bool valid, const Acc& acc) {
  const float dt = sc.dt;
#pragma unroll 1
  for (int lev = NLEV - 1; lev >= -1; --lev) {
    const Level L(lev, g);
#pragma unroll 1
    for (int n = L.n0; n < L.n1; n += G) {
      const int i = Level::link(lev, n);
      // The adjoints of v and of the world rotation, position and velocity:
      // the points' (a parent's row), the base's, then the children's, pulled.
      float gv[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gW[18];  // gW: WR 9, Wp 3, Wv 6
      if (JX_HASF[i]) {
        sld(sl, SL_PAR + JX_RR_PAR_ROW[i] * 24, 18, gW);
      } else {
#pragma unroll
        for (int k = 0; k < 18; ++k) gW[k] = 0.0f;
      }
      if (i == 0) {
        float b[12];
        sld(sl, T_BASE + B_GW0, 12, b);
#pragma unroll
        for (int k = 0; k < 12; ++k) gW[k] += b[k];
      }
#pragma unroll 1
      for (int h = JX_RR_CH_OFF[i]; h < JX_RR_CH_OFF[i + 1]; ++h) {
        const int o = rec(JX_RR_CH[h]) + R_PULL;
#pragma unroll
        for (int k = 0; k < 6; ++k) gv[k] += sl[o + k];
#pragma unroll
        for (int k = 0; k < 6; ++k) gW[PG_WV + k] += sl[o + 6 + k];
#pragma unroll
        for (int k = 0; k < 3; ++k) gW[PG_WP + k] += sl[o + 12 + k];
#pragma unroll
        for (int k = 0; k < 9; ++k) gW[PG_WR + k] += sl[o + 15 + k];
      }
      // pA = v x* (M v); MA = M (+ the children's, taken in pass 2).
      const float* Mi = P + OFF_M + i * 36;
      float v[6];
      sld(sl, T_V + i * 6, 6, v);
      {
        float gpA[6], gM[36];
        sld(sl, T_PA + i * 6, 6, gpA);
#pragma unroll
        for (int k = 0; k < 36; ++k) gM[k] = 0.0f;
        vxstar_Mv_vjp(v, Mi, gpA, gv, PARAMS_GRAD ? gM : nullptr);
        if (PARAMS_GRAD) {
          float gMA[36];
          sld(sl, rec(i) + R_MA, 36, gMA);
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
        sld(sl, T_WP, 3, p0);
        sld(sl, T_BASE + B_BR0I, 9, bR0i);
        sld(sl, T_BASE + B_BP0I, 3, bp0i);
        sld(sl, T_BASE + B_BV, 6, bv);
        sld(sl, T_BASE + B_BP, 3, bp);
        sld(sl, T_BASE + B_BQ, 4, bq);
        if (FLOATING) {
          const float vin[6] = {x.v[0], x.v[1], x.v[2], x.v[3], x.v[4], x.v[5]};
          xv_vjp(R0i, p0i, vin, gv, bR0i, bp0i, bv);
        }
        const float nb[3] = {-bp0i[0], -bp0i[1], -bp0i[2]};
        mv3_vjp(R0i, p0, nb, bR0i, gW + PG_WP);
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
          for (int k = 0; k < 6; ++k) bv[k] += gW[PG_WV + k];
        }
        add3(bp, gW + PG_WP);
        mm3_vjp(RB, Rs, gW, bRB, nullptr);
        mv3_vjp(RB, ps, gW + PG_WP, bRB, nullptr);
        if (PARAMS_GRAD) {
          float bRs[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          float bps[3] = {0.0f, 0.0f, 0.0f}, gs[12];
          mm3_vjp(RB, Rs, gW, nullptr, bRs);
          mv3_vjp(RB, ps, gW + PG_WP, nullptr, bps);
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
      const float sdi = x.sd[i - 1], si = x.s[i - 1];
      float iR[9], ip[3], T[12], gS[6], gc[6], up[24];  // up: v, Wv, Wp, WR of the parent
      load_pair(sl, i, iR, ip);
      sld(sl, rec(i) + R_GX, 12, T);
      sld(sl, T_A + i * 6, 6, gc);
      float bsd = c.sd[i - 1] + dt * c.s[i - 1];
      {
        // c = v x vJ, v = X v_lam + vJ
        float vJ[6], bvJ[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, vl[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          vJ[k] = S[k] * sdi;
          up[k] = 0.0f;
        }
        vx_vjp(v, vJ, gc, gv, bvJ);
#pragma unroll
        for (int k = 0; k < 6; ++k) bvJ[k] += gv[k];
        sld(sl, T_V + lam * 6, 6, vl);
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
      sld(sl, T_WR + i * 9, 9, WR);
      sld(sl, T_WP + i * 3, 3, Wp);
      {
        const float Sl[3] = {S[0] * sdi, S[1] * sdi, S[2] * sdi};
        const float Sa[3] = {S[3] * sdi, S[4] * sdi, S[5] * sdi};
        float RSa[3];
        mv3(WR, Sa, RSa);
        float bRSa[3] = {gW[PG_WV + 3], gW[PG_WV + 4], gW[PG_WV + 5]};
        float bSl[3] = {0.0f, 0.0f, 0.0f}, bSa[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < 6; ++k) up[6 + k] = gW[PG_WV + k];
        cross3_vjp(Wp, RSa, gW + PG_WV, gW + PG_WP, bRSa);
        mv3_vjp(WR, Sa, bRSa, gW, bSa);
        mv3_vjp(WR, Sl, gW + PG_WV, gW, bSl);
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
        sld(sl, T_WR + lam * 9, 9, WRl);
#pragma unroll
        for (int k = 0; k < 3; ++k) up[12 + k] = gW[PG_WP + k];
#pragma unroll
        for (int k = 0; k < 9; ++k) up[15 + k] = 0.0f;
        mv3_vjp(WRl, rp, gW + PG_WP, up + 15, brp);
        mm3_vjp(WRl, rR, gW, up + 15, brR);
      }
      const float bs = c.s[i - 1] + relative_transform_vjp<PARAMS_GRAD>(P, i, si, brR, brp, acc);
      if (valid) {
        out.s[(i - 1) * B] = bs;
        out.sd[(i - 1) * B] = bsd;
      }
      sst(sl, rec(i) + R_PULL, 24, up);
    }
    __syncwarp();
  }
}

// ----- the kernel -----

// One env's VJP on its JX_RR_LANES lanes (env threadIdx.x / G of the block,
// lane g); an env past the batch runs env B - 1's beside the others, so
// that every lane reaches every barrier and shuffle, and writes and adds
// nothing. `partials`, with params_grad, gets a row of N_PARAMS a block.
__global__ void __launch_bounds__(RR_THREADS)
    step_vjp_rr_kernel(const float* __restrict__ params, StateIn in, const float* __restrict__ tau_in, StateIn ct,
                       StateOut out, float* __restrict__ ct_tau, float* __restrict__ partials, int B, Scalars sc) {
  extern __shared__ float smem[];
  float* P = smem + ROWS * ES;
  load_params(params, P);
  const int e = threadIdx.x / G, g = threadIdx.x % G, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b0 = blockIdx.x * ENVS + e;
  const bool valid = b0 < B;
  const int b = valid ? b0 : B - 1;
  const Slot sl{smem + e};
  float* rows = P + N_PARAMS;
  float* row = rows + warp * N_PARAMS;
  unsigned mask = 0u;
#pragma unroll
  for (int k = 0; k < 32 / G; ++k) mask |= 1u << (g + k * G);
  const Acc acc{row, mask, valid, lane < G};
  if (PARAMS_GRAD) {
#pragma unroll 1
    for (int k = lane; k < N_PARAMS; k += 32) row[k] = 0.0f;
  }
  const EnvCols x = env_cols(in, B, b), c = env_cols(ct, B, b);
  const Col tau{tau_in + b, B};
  __syncthreads();

  // 1. The forward: the free ABA, the warm-started PCG, the substitution of x.
  free_aba_lanes(P, sc, sl, g, x, tau);
  int pt[OWN];
  float act[OWN], rj[OWN * 3], r[OWN * 3], xs[OWN * 3];
  rr_points(g, pt);
  {
    float m[OWN * 3];
    rr_load_m(in.m, B, b, pt, m);
    rr_setup(P, sc, sl, pt, m, act, rj, r, xs);
  }
  rr_cg(P, sc, sl, g, pt, act, rj, r, xs, true, false);
#pragma unroll
  for (int k = 0; k < OWN * 3; ++k)
    if (pt[k / 3] >= 0) sl[T_X + pt[k / 3] * 3 + k % 3] = xs[k];
  subst_lanes(P, sl, g, pt, act, xs);

  // 2. x's cotangent.
  if (g == 0) sie_vjp(sc, sl, x, c);
  __syncwarp();
  x_bar_lanes(P, sc, sl, g, pt, c, out.m + b, B, valid, r);

  // 3. lambda = PCG(x-bar) from zero.
#pragma unroll
  for (int k = 0; k < OWN * 3; ++k) xs[k] = 0.0f;
  rr_cg(P, sc, sl, g, pt, act, rj, r, xs, false, false);

  // 4. The rest.
  points_vjp(P, sc, sl, g, pt, xs, acc);
  pass3_vjp(P, sc, sl, g, x, c, tau, acc);
  if (g == 0) base_vjp(sc, sl);
  __syncwarp();
  pass2_vjp(P, sl, g, x, tau, ct_tau + b, B, valid, acc);
  scatter_vjp(P, sl, g, pt, acc);
  const StateOut o{out.s + b, out.sd + b, out.p + b, out.q + b, out.v + b, out.m + b};
  pass1_vjp(P, sc, sl, g, x, c, o, B, valid, acc);
  if (PARAMS_GRAD) {
    // The block's row: its warps' rows in warp order.
    __syncthreads();
#pragma unroll 1
    for (int k = threadIdx.x; k < N_PARAMS; k += RR_THREADS) {
      float s = rows[k];
#pragma unroll 1
      for (int w = 1; w < WARPS; ++w) s += rows[w * N_PARAMS + k];
      partials[static_cast<size_t>(blockIdx.x) * N_PARAMS + k] = s;
    }
  }
}

}  // namespace

extern "C" {

static int allow_smem(const void* kernel) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(VJP_SMEM_BYTES)));
}

int jx_param_count() { return N_PARAMS; }

int jx_step_vjp_rr(const float* params, const float* s, const float* sd, const float* p, const float* q,
                   const float* v, const float* m, const float* tau, const float* ct_s, const float* ct_sd,
                   const float* ct_p, const float* ct_q, const float* ct_v, const float* ct_m, float* out_s,
                   float* out_sd, float* out_p, float* out_q, float* out_v, float* out_m, float* out_tau,
                   float* partials, int B, float K, float D, float k_over_d, float mu, float hc_p, float hc_q,
                   float gz, float dt, float rr_ca, float rr_cb, float rr_mid, float rr_power, float rr_width,
                   float rr_dmin, float rr_dmax, float rr_span, float rr_stiff, float rr_damp, float rr_c2mu2,
                   float rr_c1mu2, float rr_reg, void* stream) {
  if (PARAMS_GRAD && partials == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Scalars sc{K,        D,       k_over_d, mu,       hc_p,     hc_q,    gz,
                   dt,       0.0f,    0.0f,     rr_ca,    rr_cb,    rr_mid,  rr_power,
                   rr_width, rr_dmin, rr_dmax,  rr_span,  rr_stiff, rr_damp, rr_c2mu2,
                   rr_c1mu2, rr_reg};
  const int rc = allow_smem(reinterpret_cast<const void*>(step_vjp_rr_kernel));
  if (rc != 0) return rc;
  const int blocks = (B + ENVS - 1) / ENVS;
  step_vjp_rr_kernel<<<blocks, RR_THREADS, VJP_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      params, StateIn{s, sd, p, q, v, m}, tau, StateIn{ct_s, ct_sd, ct_p, ct_q, ct_v, ct_m},
      StateOut{out_s, out_sd, out_p, out_q, out_v, out_m}, out_tau, partials, B, sc);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry, for the reports: threads a block, envs a block,
// dynamic shared memory a block in bytes, and blocks an SM holds at once.
int jx_vjp_rr_geometry(int* out) {
  const int rc = allow_smem(reinterpret_cast<const void*>(step_vjp_rr_kernel));
  if (rc != 0) return rc;
  int blocks_per_sm = 0;
  const cudaError_t occ =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, step_vjp_rr_kernel, RR_THREADS, VJP_SMEM_BYTES);
  out[0] = RR_THREADS;
  out[1] = ENVS;
  out[2] = static_cast<int>(VJP_SMEM_BYTES);
  out[3] = blocks_per_sm;
  return static_cast<int>(occ);
}

// The block rows of model-array cotangents summed in a fixed order (K4's sum).
int jx_param_sum(const float* partials, int n_rows, float* out, void* stream) {
  param_sum_kernel<<<(N_PARAMS + SUM_ENTRIES - 1) / SUM_ENTRIES, 32 * SUM_WARPS, 0,
                     static_cast<cudaStream_t>(stream)>>>(partials, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}

const char* jx_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
