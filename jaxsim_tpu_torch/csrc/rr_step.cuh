// The relaxed-rigid step of the batched engine, one env on a group of
// JX_RR_LANES lanes of a warp, with the contact solve's working set in shared
// memory.
//
// It is the arithmetic of jaxsim_tpu/ops/batched_engine.py::BatchedEngine.step
// with relaxed_rigid_contact_forces and _minv_apply on flat ground, the
// three-pass articulated-body algorithm, the 6x6 base Cholesky and the SIE
// update, as the twin (jaxsim_tpu_torch/ops/batched_engine.py) computes it:
// the free ABA (gravity and torques, no contacts), then per contact point the
// impedance, the reference acceleration, the regularizer with its impedance
// floor and the Jacobi preconditioner; the warm start from m (a point with
// |act m|^2 > 0 starts from its carried force, any other from the Jacobi
// estimate); JX_RR_ITERS iterations of the preconditioned CG on
// A x = -b, A = J M^-1 J^T + diag(r) + reg, with no early exit; the
// accelerations a_free + M^-1 J^T x; m <- x, rounded operation by operation
// as the twin writes it, m + dt ((x - m) / dt). IEEE float32 throughout.
//
// Who does what. One thread an env runs forward kinematics and the free ABA,
// as in step_env.cuh, on the block's first warps with every lane busy (on
// an env's own lanes it would leave 1 - 1/JX_RR_LANES of each warp's issue
// slots idle, and the free ABA issues more instructions than the passes), and
// writes the factorization the contact solve reuses into the env's slot of
// shared memory: per link U, d and the
// child -> parent pair (iR, ip), the base Cholesky factor L0, and for each
// contact parent its world pose, velocity and free acceleration. Every
// M^-1 J^T application (one for the warm start, JX_RR_ITERS in the CG, one
// for the final forces) then runs on all the env's lanes:
//  * scatter: the contact points are dealt to the lanes in slots (generated
//    header: each parent's points in contact-index order, padded to a
//    multiple of the lanes, so a group of JX_RR_LANES slots has one parent);
//    each lane turns its point's force into a link wrench, a fixed xor
//    shuffle tree sums the group, and the groups of a parent add in order;
//  * the substitution passes run level by level (the header's schedule from
//    JX_LAM: the humanoid's tree is 7 deep and at most 4 wide), the links of
//    a level spread over the lanes; a link pulls its children's forces in
//    descending index order, the order in which a sequential leaves-to-root
//    loop pushes them, so the tree passes round alike whatever the lanes;
//  * gather and the CG's vector updates: each lane its own slots, the dot
//    products through a fixed xor shuffle tree over the lanes.
// A lane keeps its slots' point vectors (m, x, r, p, A p, the regularizer's
// r_j and the activity) in registers (at 8 lanes and 128 registers a few
// spill to local memory, outside the passes); the Jacobi diagonal and r + reg are
// recomputed from r_j, the activity and rrMinv, by the same expressions.
// Only the order of the sums in the dot products, and in the scatter within
// a parent's points, depends on the lanes: with one lane it is the
// sequential order. Two runs agree to the bit.
//
// The slot: field-major, the block's envs minor with an odd stride, so the
// envs of a warp reading one field fall in distinct banks.

#pragma once

#include "step_env.cuh"

namespace {

constexpr int G = JX_RR_LANES;          // lanes an env
constexpr int OWN = JX_RR_OWN;          // point slots a lane
constexpr int NPAR = JX_RR_NPAR;        // links with contact points
constexpr int NLEV = JX_RR_NLEV;        // depth levels of links 1..NL-1
constexpr int ENVS = JX_RR_ENVS;        // envs a block
constexpr int ES = ENVS + 1;            // slot stride: odd, so envs fall in distinct banks
constexpr int RR_THREADS = ENVS * G;
constexpr unsigned FULL = 0xffffffffu;
static_assert(RELAXED && NC > 0, "rr_step.cuh is the relaxed-rigid step of a model with contact points");
static_assert(32 % G == 0 && RR_THREADS % 32 == 0, "an env's lanes share a warp; a block is whole warps");

// An env's slot, in floats.
constexpr int SL_U = 0;                  // (NL, 6)
constexpr int SL_D = SL_U + NL * 6;      // (NL)
constexpr int SL_IR = SL_D + NL;         // (NL, 9) child -> parent rotation
constexpr int SL_IP = SL_IR + NL * 9;    // (NL, 3) child -> parent offset
constexpr int SL_UM = SL_IP + NL * 3;    // (NL) a pass's u; the joint accelerations in the last
constexpr int SL_F = SL_UM + NL;         // (NL, 6) forces up the tree, accelerations down it
constexpr int SL_L0 = SL_F + NL * 6;     // (36) the base Cholesky factor
constexpr int SL_PAR = SL_L0 + 36;       // (NPAR, 24) contact parents: WR, Wp, Wv, free a
constexpr int SLOT = SL_PAR + NPAR * 24;
constexpr int PAR_WR = 0, PAR_WP = 9, PAR_WV = 12, PAR_A = 18;
static_assert(SLOT == JX_RR_SLOT, "the generated header sizes the slot as this layout does");
constexpr size_t RR_SMEM_BYTES = (static_cast<size_t>(SLOT) * ES + N_PARAMS) * sizeof(float);

struct Slot {
  float* base;  // the env's first float; field j at base[j * ES]
  __device__ __forceinline__ float& operator[](int j) const { return base[j * ES]; }
};

// The free ABA's working set (local memory, as in step_env).
struct RrWork {
  float WR[NL][9], Wp[NL][3], Wv[NL][6];
  float v[NL][6], c[NL][6], pA[NL][6], MA[NL][36], a[NL][6], u[NL];
};

__device__ __forceinline__ void load_vec(Slot sl, int off, int n, float* o) {
#pragma unroll
  for (int k = 0; k < 6; ++k)
    if (k < n) o[k] = sl[off + k];
}

// The sum of x over the env's lanes, every lane getting the same bits: an
// xor butterfly (a + b and b + a round alike).
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// pow(x, power) as the plain version's torch.pow computes it: power 2 as
// x*x (torch.pow and XLA both square there; powf need not round so).
__device__ __forceinline__ float rr_pow(float x, float power) {
  return power == 2.0f ? x * x : powf(x, power);
}

// ----- one thread an env: forward kinematics and the free ABA -----
//
// The loops of step_env.cuh's fk and ABA, written again here: these keep the
// factorization in the slot instead of a Work frame and take no contact
// wrenches, and a shared version would move the register allocation of the
// soft kernels that include step_env.cuh.

// Fills w and the slot's factorization and contact-parent rows, and sdd with
// the free joint accelerations. `tau_of` as in step_env.
template <class Tau>
__device__ void rr_free_step(const float* P, const Scalars& sc, RrWork& w, Slot sl, const float* s,
                             const float* sd, const float* p, const float* q, const float* v,
                             float* sdd, Tau tau_of) {
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
    float rR[9], rp[3], t[3], iR[9];
    relative_transform(P, i, s[i - 1], rR, rp);
    mm3(w.WR[lam], rR, w.WR[i]);
    mv3(w.WR[lam], rp, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) w.Wp[i][k] = w.Wp[lam][k] + t[k];
    // Inverse pair for the dynamics: (rR^T, -rR^T rp).
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) iR[r * 3 + cc] = rR[cc * 3 + r];
    mv3(iR, rp, t);
#pragma unroll
    for (int k = 0; k < 9; ++k) sl[SL_IR + i * 9 + k] = iR[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) sl[SL_IP + i * 3 + k] = -t[k];

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

  // ----- the free articulated-body algorithm -----
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
    vxstar_Mv(w.v[0], w.MA[0], w.pA[0]);
  }
#pragma unroll 1
  for (int i = 1; i < NL; ++i) {
    const int lam = JX_LAM[i];
    const float* S = P + OFF_S + i * 6;
    const float sdi = sd[i - 1];
    float vJ[6], t[6], iR[9], ip[3];
    load_vec(sl, SL_IR + i * 9, 6, iR);
    load_vec(sl, SL_IR + i * 9 + 6, 3, iR + 6);
    load_vec(sl, SL_IP + i * 3, 3, ip);
#pragma unroll
    for (int k = 0; k < 6; ++k) vJ[k] = S[k] * sdi;
    xv(iR, ip, w.v[lam], t);
#pragma unroll
    for (int k = 0; k < 6; ++k) w.v[i][k] = t[k] + vJ[k];
    vx(w.v[i], vJ, w.c[i]);
    const float* Mi = P + OFF_M + i * 36;
#pragma unroll
    for (int k = 0; k < 36; ++k) w.MA[i][k] = Mi[k];
    vxstar_Mv(w.v[i], w.MA[i], w.pA[i]);
  }

  // Pass 2: articulated inertias and bias forces, leaves to root.
#pragma unroll 1
  for (int i = NL - 1; i > 0; --i) {
    const int lam = JX_LAM[i];
    const float* S = P + OFF_S + i * 6;
    float U[6];
    mv6(w.MA[i], S, U);
    float dd = 0.0f, sp = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      dd += S[k] * U[k];
      sp += S[k] * w.pA[i][k];
    }
    const float tau = tau_of(sc, s, sd, i - 1);
#pragma unroll
    for (int k = 0; k < 6; ++k) sl[SL_U + i * 6 + k] = U[k];
    sl[SL_D + i] = dd;
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
      float X[36], MaX[36], iR[9], ip[3];
      load_vec(sl, SL_IR + i * 9, 6, iR);
      load_vec(sl, SL_IR + i * 9 + 6, 3, iR + 6);
      load_vec(sl, SL_IP + i * 3, 3, ip);
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

  // Pass 3: accelerations, root to leaves; the base factor stays for the
  // contact solve.
  if (FLOATING) {
    float L[36], x[6];
    chol6_factor(w.MA[0], L);
    chol6_substitute(L, w.pA[0], x);
#pragma unroll
    for (int k = 0; k < 36; ++k) sl[SL_L0 + k] = L[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) w.a[0][k] = -x[k];
  } else {
    float t[6];
    xv(R0i, p0i, g6, t);
#pragma unroll
    for (int k = 0; k < 6; ++k) w.a[0][k] = -t[k];
  }
#pragma unroll 1
  for (int i = 1; i < NL; ++i) {
    const int lam = JX_LAM[i];
    const float* S = P + OFF_S + i * 6;
    float a_i[6], iR[9], ip[3], U[6];
    load_vec(sl, SL_IR + i * 9, 6, iR);
    load_vec(sl, SL_IR + i * 9 + 6, 3, iR + 6);
    load_vec(sl, SL_IP + i * 3, 3, ip);
    load_vec(sl, SL_U + i * 6, 6, U);
    xv(iR, ip, w.a[lam], a_i);
    float ua = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      a_i[k] += w.c[i][k];
      ua += U[k] * a_i[k];
    }
    const float sddi = (w.u[i] - ua) / sl[SL_D + i];
    sdd[i - 1] = sddi;
#pragma unroll
    for (int k = 0; k < 6; ++k) w.a[i][k] = a_i[k] + S[k] * sddi;
  }

  // The contact parents' rows, for the lanes.
#pragma unroll 1
  for (int n = 0; n < NPAR; ++n) {
    const int i = JX_RR_PAR_LINK[n];
    const int o = SL_PAR + n * 24;
#pragma unroll
    for (int k = 0; k < 9; ++k) sl[o + PAR_WR + k] = w.WR[i][k];
#pragma unroll
    for (int k = 0; k < 3; ++k) sl[o + PAR_WP + k] = w.Wp[i][k];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      sl[o + PAR_WV + k] = w.Wv[i][k];
      sl[o + PAR_A + k] = w.a[i][k];
    }
  }
}

// ----- all lanes: the M^-1 J^T application -----

// Point forces y (world axes, the lane's slots), masked by the activity when
// `masked`, to the parents' link-frame wrenches, negated, in the slot's F
// rows; F rows of links without points are zeroed.
__device__ __forceinline__ void rr_scatter(const float* P, Slot sl, int g, const int* pt,
                                           const float* act, const float* y, bool masked) {
  __syncwarp();  // every lane has read the F rows of the last pass
#pragma unroll 1
  for (int i = g; i < NL; i += G)
    if (!JX_HASF[i]) {
#pragma unroll
      for (int k = 0; k < 6; ++k) sl[SL_F + i * 6 + k] = 0.0f;
    }
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    float w6[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const int c = pt[k];
    if (c >= 0) {
      const int o = SL_PAR + JX_RR_GROUP_PAR[k] * 24 + PAR_WR;
      const float* Lp = P + OFF_CP + c * 3;
      float Rp[9], yc[3];
#pragma unroll
      for (int j = 0; j < 9; ++j) Rp[j] = sl[o + j];
#pragma unroll
      for (int j = 0; j < 3; ++j) yc[j] = masked ? act[k] * y[k * 3 + j] : y[k * 3 + j];
      mtv3(Rp, yc, w6);
      cross3(Lp, w6, w6 + 3);
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[j] -= lanes_sum(w6[j]);
    if (k == OWN - 1 || JX_RR_GROUP_LINK[k + 1] != JX_RR_GROUP_LINK[k]) {
      const int par = JX_RR_GROUP_LINK[k];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if (g == 0) sl[SL_F + par * 6 + j] = acc[j];
        acc[j] = 0.0f;
      }
    }
  }
  __syncwarp();
}

// The zero-velocity substitution passes on the free ABA's factorization:
// the negated link forces in the F rows to link-frame accelerations there.
// With `last` the joint accelerations go to the UM rows.
__device__ __forceinline__ void rr_minv(const float* P, Slot sl, int g, bool last) {
  // Leaves to root: a link pulls its children's transmitted forces.
#pragma unroll 1
  for (int lev = NLEV - 1; lev >= 0; --lev) {
#pragma unroll 1
    for (int n = JX_RR_LEV_OFF[lev] + g; n < JX_RR_LEV_OFF[lev + 1]; n += G) {
      const int i = JX_RR_LEV_LINK[n];
      float f[6];
      load_vec(sl, SL_F + i * 6, 6, f);
#pragma unroll 1
      for (int h = JX_RR_CH_OFF[i]; h < JX_RR_CH_OFF[i + 1]; ++h) {
        const int ch = JX_RR_CH[h];
#pragma unroll
        for (int k = 0; k < 6; ++k) f[k] += sl[SL_F + ch * 6 + k];
      }
      const float* S = P + OFF_S + i * 6;
      float sp = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) sp += S[k] * f[k];
      const float u = -sp;
      sl[SL_UM + i] = u;
      if (JX_LAM[i] != 0 || FLOATING) {
        const float ud = u / sl[SL_D + i];
        float pa[6], t[6], U[6], iR[9], ip[3];
        load_vec(sl, SL_U + i * 6, 6, U);
        load_vec(sl, SL_IR + i * 9, 6, iR);
        load_vec(sl, SL_IR + i * 9 + 6, 3, iR + 6);
        load_vec(sl, SL_IP + i * 3, 3, ip);
#pragma unroll
        for (int k = 0; k < 6; ++k) pa[k] = f[k] + U[k] * ud;
        xtf(iR, ip, pa, t);
#pragma unroll
        for (int k = 0; k < 6; ++k) sl[SL_F + i * 6 + k] = t[k];
      }
    }
    __syncwarp();
  }
  if (g == 0) {
    float a0[6];
    if (FLOATING) {
      float f[6];
      load_vec(sl, SL_F, 6, f);
#pragma unroll 1
      for (int h = JX_RR_CH_OFF[0]; h < JX_RR_CH_OFF[1]; ++h) {
        const int ch = JX_RR_CH[h];
#pragma unroll
        for (int k = 0; k < 6; ++k) f[k] += sl[SL_F + ch * 6 + k];
      }
      float L[36], x[6];
#pragma unroll
      for (int k = 0; k < 36; ++k) L[k] = sl[SL_L0 + k];
      chol6_substitute(L, f, x);
#pragma unroll
      for (int k = 0; k < 6; ++k) a0[k] = -x[k];
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k) a0[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) sl[SL_F + k] = a0[k];
  }
  __syncwarp();
  // Root to leaves.
#pragma unroll 1
  for (int lev = 0; lev < NLEV; ++lev) {
#pragma unroll 1
    for (int n = JX_RR_LEV_OFF[lev] + g; n < JX_RR_LEV_OFF[lev + 1]; n += G) {
      const int i = JX_RR_LEV_LINK[n];
      const float* S = P + OFF_S + i * 6;
      float a_lam[6], a_i[6], U[6], iR[9], ip[3];
      load_vec(sl, SL_F + JX_LAM[i] * 6, 6, a_lam);
      load_vec(sl, SL_U + i * 6, 6, U);
      load_vec(sl, SL_IR + i * 9, 6, iR);
      load_vec(sl, SL_IR + i * 9 + 6, 3, iR + 6);
      load_vec(sl, SL_IP + i * 3, 3, ip);
      xv(iR, ip, a_lam, a_i);
      float ua = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) ua += U[k] * a_i[k];
      const float sddi = (sl[SL_UM + i] - ua) / sl[SL_D + i];
      if (last) sl[SL_UM + i] = sddi;
#pragma unroll
      for (int k = 0; k < 6; ++k) sl[SL_F + i * 6 + k] = a_i[k] + S[k] * sddi;
    }
    __syncwarp();
  }
}

// The world acceleration of the lane's slot k (point c): Rp (a_lin + a_ang x
// Lp) from its parent's free accelerations (`free_a`) or from the F rows.
__device__ __forceinline__ void rr_gather(const float* P, Slot sl, int k, int c, bool free_a, float* acc) {
  const int o = SL_PAR + JX_RR_GROUP_PAR[k] * 24;
  const float* Lp = P + OFF_CP + c * 3;
  float a[6], Rp[9], t[3], u[3];
  load_vec(sl, free_a ? o + PAR_A : SL_F + JX_RR_GROUP_LINK[k] * 6, 6, a);
#pragma unroll
  for (int j = 0; j < 9; ++j) Rp[j] = sl[o + PAR_WR + j];
  cross3(a + 3, Lp, t);
#pragma unroll
  for (int j = 0; j < 3; ++j) u[j] = a[j] + t[j];
  mv3(Rp, u, acc);
}

// The Jacobi diagonal of point c's component j, from its regularizer r_j.
__device__ __forceinline__ float rr_prec(const float* P, const Scalars& sc, int c, int j, float act, float rj) {
  return c < 0 ? 1.0f : act * P[OFF_RRMINV + c * 9 + j * 4] + rj + sc.rr_reg;
}

// ----- the step -----

// One semi-implicit Euler step of a block's ENVS envs, in place, in three
// phases apart by block barriers: thread t < ENVS runs env t's free ABA (the
// first ENVS / 32 warps, every lane busy) and, after the contact solve, its
// SIE update, and holds its s, sd, p, q and v; the contact solve runs on
// all the block's threads, env threadIdx.x / G on lane g = threadIdx.x % G,
// each lane holding the m rows of its point slots `pt` (-1 for a padding
// slot). `slots` is the block's first slot.
template <class Tau>
__device__ void rr_step_env(const float* P, const Scalars& sc, RrWork& w, float* slots, const int* pt,
                            float* s, float* sd, float* p, float* q, float* v, float* m, Tau tau_of) {
  const bool aba = threadIdx.x < ENVS;
  const Slot mine{slots + (aba ? threadIdx.x : 0)};
  float sdd[NJA];
  if (aba) rr_free_step(P, sc, w, mine, s, sd, p, q, v, sdd, tau_of);
  __syncthreads();

  const int g = threadIdx.x % G;
  const Slot sl{slots + threadIdx.x / G};

  // Per point slot: the activity, the regularizer r_j, the residual of the
  // start -b and the warm start.
  const float nh[3] = {0.0f, 0.0f, 1.0f};  // flat ground's normal
  float act[OWN], rj[OWN * 3], x[OWN * 3], r[OWN * 3], pp[OWN * 3], Ap[OWN * 3];
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    const int c = pt[k];
    act[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) rj[k * 3 + j] = r[k * 3 + j] = x[k * 3 + j] = 0.0f;
    if (c < 0) continue;
    const int o = SL_PAR + JX_RR_GROUP_PAR[k] * 24;
    const float* Lp = P + OFF_CP + c * 3;
    float Rp[9], Wp[3], Wv[6];
#pragma unroll
    for (int j = 0; j < 9; ++j) Rp[j] = sl[o + PAR_WR + j];
#pragma unroll
    for (int j = 0; j < 3; ++j) Wp[j] = sl[o + PAR_WP + j];
    load_vec(sl, o + PAR_WV, 6, Wv);
    const float* om = Wv + 3;
    float pc[3], pd[3], t[3];
    mv3(Rp, Lp, t);
#pragma unroll
    for (int j = 0; j < 3; ++j) pc[j] = t[j] + Wp[j];
    cross3(om, pc, t);
#pragma unroll
    for (int j = 0; j < 3; ++j) pd[j] = Wv[j] + t[j];
    const float delta = fmaxf(-pc[2], 0.0f);
    const float a_k = delta > 0.0f ? 1.0f : 0.0f;
    act[k] = a_k;

    // Free point acceleration R(a_lin + w' x Lp) + g + w x pd.
    float acc[3], wxpd[3];
    rr_gather(P, sl, k, c, true, acc);
    cross3(om, pd, wxpd);
    const float pdd[3] = {acc[0] + wxpd[0], acc[1] + wxpd[1], (acc[2] + sc.gz) + wxpd[2]};

    float xi[3], aref[3], coeff[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float pos = -delta * nh[j];
      const float xx = delta * fabsf(nh[j]) / sc.rr_width;
      const float ya = sc.rr_ca * rr_pow(xx, sc.rr_power);
      const float yb = 1.0f - sc.rr_cb * rr_pow(fmaxf(1.0f - xx, 0.0f), sc.rr_power);
      const float y = xx < sc.rr_mid ? ya : yb;
      float xj = fminf(fmaxf(sc.rr_dmin + y * sc.rr_span, sc.rr_dmin), sc.rr_dmax);
      xj = xx > 1.0f ? sc.rr_dmax : xj;
      xi[j] = xj;
      aref[j] = -(sc.rr_damp * pd[j] + sc.rr_stiff * xj * pos);
      coeff[j] = (sc.rr_c2mu2 * (1.0f - xj) / (xj + 1e-12f)) * sc.rr_c1mu2;
    }
    const float* Mi = P + OFF_RRMINV + c * 9;
    float warm = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float mj = a_k * m[k * 3 + j];
      warm += mj * mj;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float rjj = a_k * ((coeff[0] * Mi[j] + coeff[1] * Mi[3 + j] + coeff[2] * Mi[6 + j]) +
                               ((1.0f - xi[j]) / (xi[j] + 1e-12f)) * Mi[j * 4]);
      const float prec = rr_prec(P, sc, c, j, a_k, rjj);
      const float neg_b = -(a_k * (pdd[j] - aref[j]));
      rj[k * 3 + j] = rjj;
      r[k * 3 + j] = neg_b;
      x[k * 3 + j] = warm > 0.0f ? a_k * m[k * 3 + j] : neg_b / prec;
    }
  }

  // Preconditioned CG on A x = -b, warm-started: one pass for A x, one a CG
  // iteration, and one for M^-1 J^T x, all through one copy of the pass.
  float rz = 0.0f;
#pragma unroll 1
  for (int it = -1; it <= JX_RR_ITERS; ++it) {
    const bool first = it < 0, last = it == JX_RR_ITERS;
    if (first || last) {
#pragma unroll
      for (int k = 0; k < OWN * 3; ++k) pp[k] = x[k];
    }
    rr_scatter(P, sl, g, pt, act, pp, !last);
    rr_minv(P, sl, g, last);
    if (last) break;
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < OWN; ++k) {
      const int c = pt[k];
      float acc[3] = {0.0f, 0.0f, 0.0f};
      if (c >= 0) rr_gather(P, sl, k, c, false, acc);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int e = k * 3 + j;
        Ap[e] = c < 0 ? 0.0f : act[k] * acc[j] + (rj[e] + sc.rr_reg) * pp[e];
        if (!first) dot += pp[e] * Ap[e];
      }
    }
    if (first) {
#pragma unroll
      for (int k = 0; k < OWN; ++k)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int e = k * 3 + j;
          r[e] = r[e] - Ap[e];
          const float z = r[e] / rr_prec(P, sc, pt[k], j, act[k], rj[e]);
          pp[e] = z;
          dot += r[e] * z;
        }
      rz = lanes_sum(dot);
      continue;
    }
    const float alpha = rz / (lanes_sum(dot) + 1e-20f);
    float rz_n = 0.0f;
#pragma unroll
    for (int k = 0; k < OWN; ++k)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int e = k * 3 + j;
        x[e] = x[e] + alpha * pp[e];
        r[e] = r[e] - alpha * Ap[e];
        rz_n += r[e] * (r[e] / rr_prec(P, sc, pt[k], j, act[k], rj[e]));
      }
    rz_n = lanes_sum(rz_n);
    const float beta = rz_n / (rz + 1e-20f);
#pragma unroll
    for (int k = 0; k < OWN; ++k)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int e = k * 3 + j;
        pp[e] = r[e] / rr_prec(P, sc, pt[k], j, act[k], rj[e]) + beta * pp[e];
      }
    rz = rz_n;
  }

  // m <- the solved forces, written as m + dt (x - m)/dt with each operation
  // rounded alone, as the plain version computes it.
  const float dt = sc.dt;
#pragma unroll
  for (int k = 0; k < OWN * 3; ++k) {
    const float md = __fdiv_rn(__fsub_rn(x[k], m[k]), dt);
    m[k] = __fadd_rn(m[k], __fmul_rn(dt, md));
  }
  __syncthreads();
  if (!aba) return;

  // The free ABA's thread: the contact-coupled accelerations, the free ones
  // plus M^-1 J^T x, and the semi-implicit Euler update.
#pragma unroll 1
  for (int k = 0; k < NJ; ++k) sdd[k] = sdd[k] + mine[SL_UM + k + 1];
  float W_a[6];
  if (FLOATING) {
    float a0[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) a0[k] = w.a[0][k] + mine[SL_F + k];
    xv(w.WR[0], w.Wp[0], a0, W_a);
    W_a[2] += sc.gz;
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) W_a[k] = 0.0f;
  }
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
