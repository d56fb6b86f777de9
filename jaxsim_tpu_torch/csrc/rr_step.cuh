// The relaxed-rigid step of the batched engine, one env on a group of
// JX_RR_LANES lanes of a warp, with the contact solve's working set in shared
// memory.
//
// It is the arithmetic of jaxsim_tpu/ops/batched_engine.py::BatchedEngine.step
// with relaxed_rigid_contact_forces and _minv_apply, the three-pass
// articulated-body algorithm, the 6x6 base Cholesky and the SIE update, as
// the twin (jaxsim_tpu_torch/ops/batched_engine.py) computes it: the free ABA
// (gravity and torques, no contacts), then per contact point the normal and
// penetration (flat ground's; JX_TERRAIN 1, the plane's static ones from the
// generated header; JX_TERRAIN 2, the Fourier terrain's at the point, from
// fourier_height_grad, offset by the env's terrOff under JX_TERR_OFF), the
// impedance, the reference acceleration, the regularizer with its impedance
// floor and the preconditioner (scalar Jacobi; block Jacobi on Fourier
// terrain, rr_block_prec, from the nominal Delassus blocks rrKc); the warm
// start from m (a point with |act m|^2 > 0 starts from its carried force, any
// other from the preconditioner's estimate); JX_RR_ITERS iterations of the
// preconditioned CG on
// A x = -b, A = J M^-1 J^T + diag(r) + reg, with no early exit; the
// accelerations a_free + M^-1 J^T x; m <- x, rounded operation by operation
// as the twin writes it, m + dt ((x - m) / dt). With JX_DOMAIN the env's
// gmul scales gravity (the free ABA's, the points' free acceleration's and
// the base's world acceleration's) and its Mmul every link's inertia in the
// free ABA (rr_step_env takes the env's rows); its Kmul, Dmul and mumul are
// not read: the solve takes the engine's mu, as the JAX engine's. IEEE
// float32 throughout.
//
// Who does what. Everything of an env runs on its own JX_RR_LANES lanes, so
// a step needs warp barriers only; it takes one block barrier, after the free
// ABA, to keep the block's warps in one phase:
//  * forward kinematics and the free ABA (rr_free_body) run level by level
//    (the header's schedule from JX_LAM: the humanoid's tree is 7 deep and at
//    most 4 wide), a link a lane: link i on lane JX_RR_POS[i] % G, in round
//    JX_RR_POS[i] / G of its level. What a link hands to the next level
//    stays in its lane's registers and the next level pulls it by a warp
//    shuffle: its world pose, world velocity and body velocity down the tree;
//    up it, its share of its parent's articulated inertia and bias force,
//    X^T Ma X (the lower triangle, mirrored) and X^T pa, pulled in descending
//    child index, the order in which a sequential leaves-to-root loop pushes
//    them, so the tree sums round alike whatever the lanes; then the base's
//    Cholesky on lane 0; down it again, the accelerations. What a link
//    keeps from one pass to the next stays in its slot rows: the body
//    velocity in its F row and u in its UM row until the contact solve
//    reuses them, and the factorization the solve reads (per link U, d and
//    the child -> parent pair (iR, ip), the base Cholesky factor L0, and for
//    each contact parent its world pose, velocity and free acceleration);
//  * every M^-1 J^T application (one for the warm start, JX_RR_ITERS in the
//    CG, one for the final forces) then runs on the same lanes:
//    - scatter: the contact points are dealt to the lanes in slots (generated
//      header: each parent's points in contact-index order, padded to a
//      multiple of the lanes, so a group of JX_RR_LANES slots has one parent);
//      each lane turns its point's force into a link wrench, a fixed xor
//      shuffle tree sums the group, and the groups of a parent add in order;
//    - the substitution passes run on the ABA's level schedule, a link
//      pulling its children's forces in descending index order;
//    - gather and the CG's vector updates: each lane its own slots, the dot
//      products through a fixed xor shuffle tree over the lanes;
//  * the state is dealt to the lanes that use it: a lane holds s and sd of
//    its links' joints (RrLane, in local memory) and updates them, lane 0 the
//    base's p, q and v (in link 0's slot rows, which no pass uses), each lane
//    the m rows of its point slots.
// A lane keeps its slots' point vectors (m, x, r, p, A p, the regularizer's
// r_j and the activity) in registers; the Jacobi diagonal (or block) and
// r + reg are recomputed from r_j, the activity and rrMinv (or rrKc), by the
// same expressions.
// Only the order of the sums in the dot products, and in the scatter within
// a parent's points, depends on the lanes: with one lane it is the
// sequential order. Two runs agree to the bit.
//
// RK4 and RK4-fast (JX_INTEGRATOR 1 and 2; rr_rk4_step), as the twin's
// _rk4_step: q normalised, the torques captured once into the slot's torque
// row, then four stages. Under RK4 each stage is the step above in its rate
// form: the free ABA and the PCG, warm-started from the stage's m, give the
// stage's accelerations and m' = (x - m) / dt; each lane forms the rates of
// its entries (lane 0 the base's: p, q with the Baumgarte term, and v) and
// their next stage state y0 + c dt k and the accumulator, which live in
// device memory (Rk4Scratch: the slot has no room for two more states beside
// 64 envs). Under RK4-fast one PCG at the step's start gives the forces,
// which the lanes freeze as the parents' world wrenches (in the PAR_A rows,
// free after the solve), and m' = (x - m) / dt; then each of the four stages
// is one free ABA on the lanes with those wrenches as external forces
// (rr_free_lanes' Frozen form), as the twin runs its aba with the frozen
// f_links.
//
// The slot: field-major, the block's envs minor with an odd stride, so the
// envs of a warp reading one field fall in distinct banks.

#pragma once

#include "step_env.cuh"

#ifndef JX_RR_TAU_ROW
#define JX_RR_TAU_ROW 0
#endif

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
static_assert(INTEGRATOR == 0 || (TERRAIN == 0 && !DOMAIN && !TERR_OFF),
              "the relaxed-rigid RK4 and RK4-fast builds take flat ground and no per-env rows");
static_assert(32 % G == 0 && RR_THREADS % 32 == 0, "an env's lanes share a warp; a block is whole warps");

// An env's slot, in floats.
constexpr int SL_U = 0;                  // (NL, 6)
constexpr int SL_D = SL_U + NL * 6;      // (NL)
constexpr int SL_IR = SL_D + NL;         // (NL, 9) child -> parent rotation
constexpr int SL_IP = SL_IR + NL * 9;    // (NL, 3) child -> parent offset
constexpr int SL_UM = SL_IP + NL * 3;    // (NL) the free ABA's u; a pass's u; the joint accelerations in the last
constexpr int SL_F = SL_UM + NL;         // (NL, 6) ABA: body velocities; solve: forces up, accelerations down
constexpr int SL_L0 = SL_F + NL * 6;     // (36) the base Cholesky factor
constexpr int SL_PAR = SL_L0 + 36;       // (NPAR, 24) contact parents: WR, Wp, Wv, free a
constexpr int SL_TAU = SL_PAR + NPAR * 24;  // (NJ) the step's torques: RK4's, K3's, K5's (JX_RR_TAU_ROW)
constexpr int SLOT = SL_TAU + (INTEGRATOR != 0 || JX_RR_TAU_ROW ? NJ : 0);
// A parent's row; under RK4-fast PAR_A holds the frozen world wrench after
// the step's solve.
constexpr int PAR_WR = 0, PAR_WP = 9, PAR_WV = 12, PAR_A = 18;
static_assert(SLOT == JX_RR_SLOT, "the generated header sizes the slot as this layout does");
constexpr size_t RR_SMEM_BYTES = (static_cast<size_t>(SLOT) * ES + N_PARAMS) * sizeof(float);

struct Slot {
  float* base;  // the env's first float; field j at base[j * ES]
  __device__ __forceinline__ float& operator[](int j) const { return base[j * ES]; }
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

// Block Jacobi (JX_TERRAIN 2): z = P^-1 r for point c's residual r, P = act
// K_c + diag(r_j) + reg I with K_c point c's nominal Delassus block (rrKc),
// inverted in closed form by the symmetric adjugate over the determinant as
// the twin's _block_jacobi_inverse, the product summed in j's order. P^-1 is
// rebuilt from rrKc, the activity and r_j at each use, as rr_prec rebuilds
// the diagonal: the solve's point vectors already fill the registers. A
// padding slot (c < 0) takes z = r.
__device__ __forceinline__ void rr_block_prec(const float* P, const Scalars& sc, int c, float act, const float* rj,
                                              const float* r, float* z) {
  if (c < 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) z[j] = r[j];
    return;
  }
  const float* K = P + OFF_RRKC + c * 9;
  const float m00 = act * K[0] + rj[0] + sc.rr_reg;
  const float m11 = act * K[4] + rj[1] + sc.rr_reg;
  const float m22 = act * K[8] + rj[2] + sc.rr_reg;
  const float m01 = act * K[1], m02 = act * K[2], m12 = act * K[5];
  const float c00 = m11 * m22 - m12 * m12;
  const float c01 = m02 * m12 - m01 * m22;
  const float c02 = m01 * m12 - m02 * m11;
  const float c11 = m00 * m22 - m02 * m02;
  const float c12 = m01 * m02 - m00 * m12;
  const float c22 = m00 * m11 - m01 * m01;
  const float inv_det = 1.0f / (m00 * c00 + m01 * c01 + m02 * c02);
  const float Pi[9] = {c00 * inv_det, c01 * inv_det, c02 * inv_det, c01 * inv_det, c11 * inv_det,
                       c12 * inv_det, c02 * inv_det, c12 * inv_det, c22 * inv_det};
#pragma unroll
  for (int i = 0; i < 3; ++i) z[i] = Pi[i * 3] * r[0] + Pi[i * 3 + 1] * r[1] + Pi[i * 3 + 2] * r[2];
}

// Env b's rows of a relaxed-rigid build (JX_DOMAIN, JX_TERR_OFF): gmul, Mmul
// and the terrain offset; Kmul, Dmul and mumul, which its solve does not
// read, stay 1.
__device__ __forceinline__ EnvDomain rr_load_domain(const DomainRows& r, int B, int b) {
  EnvDomain d{1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 0.0f, 0.0f};
  if constexpr (DOMAIN) d.gmul = r.mul[3 * B + b], d.Mmul = r.mul[4 * B + b];
  if constexpr (TERR_OFF) d.ox = r.off[b], d.oy = r.off[B + b];
  return d;
}

// ----- the step -----

// The contact solve's set-up on the env's lanes (lane g of the env's slot
// `sl`, its point slots `pt`, -1 for a padding slot), after the free ABA has
// filled the slot: per point slot the activity `act`, the regularizer `rj`,
// the right-hand side -b in `r` and the warm start in `x` from `m` (the
// lane's m rows); `dom`, the env's gmul and terrain offset.
__device__ __forceinline__ void rr_setup(const float* P, const Scalars& sc, Slot sl, const int* pt, const float* m,
                                         float* act, float* rj, float* r, float* x,
                                         const EnvDomain& dom = EnvDomain{1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 0.0f, 0.0f}) {
  const float gz = DOMAIN ? sc.gz * dom.gmul : sc.gz;
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
    // The point's unit normal and penetration.
    float nh[3], delta;
    if constexpr (TERRAIN == 2) {
      float h, dhx, dhy;
      const float qx = TERR_OFF ? pc[0] - dom.ox : pc[0], qy = TERR_OFF ? pc[1] - dom.oy : pc[1];
      fourier_height_grad(P + OFF_TERR, qx, qy, h, dhx, dhy);
      const float inv_n = 1.0f / sqrtf(dhx * dhx + dhy * dhy + 1.0f);
      nh[0] = -dhx * inv_n, nh[1] = -dhy * inv_n, nh[2] = inv_n;
      delta = fmaxf((h - pc[2]) * nh[2], 0.0f);
    } else if constexpr (TERRAIN == 1) {
      nh[0] = JX_TERR_NX, nh[1] = JX_TERR_NY, nh[2] = JX_TERR_NZ;
      delta = fmaxf(JX_TERR_H - (nh[0] * pc[0] + nh[1] * pc[1] + nh[2] * pc[2]), 0.0f);
    } else {
      nh[0] = 0.0f, nh[1] = 0.0f, nh[2] = 1.0f;
      delta = fmaxf(-pc[2], 0.0f);
    }
    const float a_k = delta > 0.0f ? 1.0f : 0.0f;
    act[k] = a_k;

    // Free point acceleration R(a_lin + w' x Lp) + g + w x pd.
    float acc[3], wxpd[3];
    rr_gather(P, sl, k, c, true, acc);
    cross3(om, pd, wxpd);
    const float pdd[3] = {acc[0] + wxpd[0], acc[1] + wxpd[1], (acc[2] + gz) + wxpd[2]};

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
      if constexpr (TERRAIN == 2) {
        x[k * 3 + j] = a_k * m[k * 3 + j];  // a cold point's estimate follows
      } else {
        x[k * 3 + j] = warm > 0.0f ? a_k * m[k * 3 + j] : neg_b / prec;
      }
    }
    if constexpr (TERRAIN == 2) {
      if (!(warm > 0.0f)) rr_block_prec(P, sc, c, a_k, rj + k * 3, r + k * 3, x + k * 3);
    }
  }
}

// JX_RR_ITERS iterations of the preconditioned CG on A x = r on the env's
// lanes, as the twin's _pcg: with `warm` from x (one pass for A x first),
// else from zero (x must hold zeros); with `final_pass` then the M^-1 J^T
// pass of the solved forces, which leaves the contact accelerations in the
// F rows (link-frame, by link) and the UM rows (joint accelerations). Every
// pass goes through one copy of the pass. `r` is the residual on return.
__device__ __forceinline__ void rr_cg(const float* P, const Scalars& sc, Slot sl, int g, const int* pt,
                                      const float* act, const float* rj, float* r, float* x, bool warm,
                                      bool final_pass) {
  float pp[OWN * 3], Ap[OWN * 3];
  float rz = 0.0f;
  if (!warm) {
    // From zero: the residual is the right-hand side.
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < OWN; ++k) {
      if constexpr (TERRAIN == 2) {
        rr_block_prec(P, sc, pt[k], act[k], rj + k * 3, r + k * 3, pp + k * 3);
#pragma unroll
        for (int j = 0; j < 3; ++j) dot += r[k * 3 + j] * pp[k * 3 + j];
      } else {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int e = k * 3 + j;
          const float z = r[e] / rr_prec(P, sc, pt[k], j, act[k], rj[e]);
          pp[e] = z;
          dot += r[e] * z;
        }
      }
    }
    rz = lanes_sum(dot);
  }
#pragma unroll 1
  for (int it = warm ? -1 : 0; it <= JX_RR_ITERS; ++it) {
    const bool first = it < 0, last = it == JX_RR_ITERS;
    if (last && !final_pass) break;
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
      for (int k = 0; k < OWN; ++k) {
        if constexpr (TERRAIN == 2) {
#pragma unroll
          for (int j = 0; j < 3; ++j) r[k * 3 + j] = r[k * 3 + j] - Ap[k * 3 + j];
          rr_block_prec(P, sc, pt[k], act[k], rj + k * 3, r + k * 3, pp + k * 3);
#pragma unroll
          for (int j = 0; j < 3; ++j) dot += r[k * 3 + j] * pp[k * 3 + j];
        } else {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int e = k * 3 + j;
            r[e] = r[e] - Ap[e];
            const float z = r[e] / rr_prec(P, sc, pt[k], j, act[k], rj[e]);
            pp[e] = z;
            dot += r[e] * z;
          }
        }
      }
      rz = lanes_sum(dot);
      continue;
    }
    const float alpha = rz / (lanes_sum(dot) + 1e-20f);
    float rz_n = 0.0f;
    if constexpr (TERRAIN == 2) {
      // The block form's z = P^-1 r once a point, in Ap's place (Ap is
      // spent once r is updated).
#pragma unroll
      for (int k = 0; k < OWN; ++k) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int e = k * 3 + j;
          x[e] = x[e] + alpha * pp[e];
          r[e] = r[e] - alpha * Ap[e];
        }
        rr_block_prec(P, sc, pt[k], act[k], rj + k * 3, r + k * 3, Ap + k * 3);
#pragma unroll
        for (int j = 0; j < 3; ++j) rz_n += r[k * 3 + j] * Ap[k * 3 + j];
      }
      rz_n = lanes_sum(rz_n);
      const float beta = rz_n / (rz + 1e-20f);
#pragma unroll
      for (int k = 0; k < OWN * 3; ++k) pp[k] = Ap[k] + beta * pp[k];
    } else {
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
    }
    rz = rz_n;
  }
}

// The contact solve on the env's lanes (lane g of the env's slot `sl`, its
// point slots `pt`, -1 for a padding slot), after the free ABA has filled
// the slot: rr_setup, then the PCG warm-started from `m` and the M^-1 J^T
// pass of the solved forces (rr_cg). The lane's solved forces go to `x`;
// `dom`, the env's gmul and terrain offset.
__device__ __forceinline__ void rr_solve(const float* P, const Scalars& sc, Slot sl, int g, const int* pt,
                                         const float* m, float* x,
                                         const EnvDomain& dom = EnvDomain{1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 0.0f, 0.0f}) {
  float act[OWN], rj[OWN * 3], r[OWN * 3];
  rr_setup(P, sc, sl, pt, m, act, rj, r, x, dom);
  rr_cg(P, sc, sl, g, pt, act, rj, r, x, true, true);
}

// Under RK4-fast: the lanes' solved forces x as the parents' world wrenches
// [x ; pc x x], summed as rr_scatter sums (a group's slots by the xor tree,
// a parent's groups in order), into the parents' PAR_A rows.
__device__ __forceinline__ void rr_wrenches(const float* P, Slot sl, int g, const int* pt, const float* x) {
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    float w6[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const int c = pt[k];
    const int o = SL_PAR + JX_RR_GROUP_PAR[k] * 24;
    if (c >= 0) {
      float Rp[9], Wp[3], pc[3], t[3];
#pragma unroll
      for (int j = 0; j < 9; ++j) Rp[j] = sl[o + PAR_WR + j];
#pragma unroll
      for (int j = 0; j < 3; ++j) Wp[j] = sl[o + PAR_WP + j];
      mv3(Rp, P + OFF_CP + c * 3, t);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        pc[j] = t[j] + Wp[j];
        w6[j] = x[k * 3 + j];
      }
      cross3(pc, w6, w6 + 3);
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[j] += lanes_sum(w6[j]);
    if (k == OWN - 1 || JX_RR_GROUP_LINK[k + 1] != JX_RR_GROUP_LINK[k]) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if (g == 0) sl[o + PAR_A + j] = acc[j];
        acc[j] = 0.0f;
      }
    }
  }
  __syncwarp();
}

// ----- the state between device memory and the lanes -----
//
// The state leaves keep the batch trailing (x[row * B + b]). Each lane of an
// env holds the m rows of its point slots, and in the forward kernels s and
// sd of its links' joints (RrLane), lane 0 the base's p, q and v.

// Lane g's point slots: the contact point of each, -1 for a padding slot.
__device__ __forceinline__ void rr_points(int g, int* pt) {
#pragma unroll
  for (int k = 0; k < OWN; ++k) pt[k] = JX_RR_SLOT_POINT[g + G * k];
}

// Env b's m rows of the lane's point slots pt (0 for a padding slot).
__device__ __forceinline__ void rr_load_m(const float* m_in, int B, int b, const int* pt, float* m) {
#pragma unroll
  for (int k = 0; k < OWN; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) m[k * 3 + j] = pt[k] >= 0 ? m_in[(pt[k] * 3 + j) * B + b] : 0.0f;
}

__device__ __forceinline__ void rr_store_m(float* m_out, int B, int b, const int* pt, const float* m) {
#pragma unroll
  for (int k = 0; k < OWN; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (pt[k] >= 0) m_out[(pt[k] * 3 + j) * B + b] = m[k * 3 + j];
}

// ----- the forward kernels' step -----
//
// Their generated headers define JX_RR_WIDTH and the free ABA's tables;
// K4-rr's (step_vjp_rr.cu) does not, and compiles none of what follows.

#ifdef JX_RR_WIDTH

constexpr int ROUNDS = (JX_RR_WIDTH + G - 1) / G;          // a level's links on one lane, at most
constexpr int NE = NLEV * ROUNDS > 0 ? NLEV * ROUNDS : 1;  // a lane's links, at most

// ----- the free ABA on the env's lanes -----
//
// The twin's fk and ABA loops, level by level; they keep the factorization
// in the slot and take no contact wrenches.

// A lane's share of its env's state between steps: s and sd of the joints of
// its links (entry e = lev * ROUNDS + r: its link of round r at level lev,
// joint i - 1). The passes index them (and the step's sdd) by level at run
// time, which keeps them in local memory, read a few times a link and step:
// registers stay for the contact solve's point vectors.
struct RrLane {
  float s[NE], sd[NE];
};

// Link 0's rows of U, d, iR, ip and u, which no pass uses (the base has no
// joint): lane 0 keeps the base's state there between steps, p, q and v
// (entry k of the 13 at rr_base_at(k)), and the free ABA's base
// acceleration in the U row (SL_A0) for the update after the contact solve.
constexpr int SL_A0 = SL_U;
__device__ __forceinline__ int rr_base_at(int k) { return k < 9 ? SL_IR + k : k < 12 ? SL_IP + k - 9 : SL_UM; }

// The base's p, q, v as x[0..2], x[3..6], x[7..12].
__device__ __forceinline__ void rr_base_load(Slot sl, float* x) {
#pragma unroll
  for (int k = 0; k < 13; ++k) x[k] = sl[rr_base_at(k)];
}

__device__ __forceinline__ void rr_base_store(Slot sl, const float* x) {
#pragma unroll
  for (int k = 0; k < 13; ++k) sl[rr_base_at(k)] = x[k];
}

// Lane g's link of round r at level lev, or -1.
__device__ __forceinline__ int rr_link(int lev, int r, int g) {
  const int n = JX_RR_LEV_OFF[lev] + g + G * r;
  return n < JX_RR_LEV_OFF[lev + 1] ? JX_RR_LEV_LINK[n] : -1;
}

// Link j's N floats, from the registers h (by round) of the lane that ran it:
// take(k, x) for each when j >= 0; all the env's lanes take part.
template <int N, class Take>
__device__ __forceinline__ void rr_pull(const float (&h)[ROUNDS][N], int j, Take take) {
  const int pos = j >= 0 ? JX_RR_POS[j] : 0, src = pos % G, rj = pos / G;
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float x = __shfl_sync(FULL, h[q][k], src, G);
      if (j >= 0 && q == rj) take(k, x);
    }
}

// Row and column of entry k of a symmetric 6x6 matrix's lower triangle (tri).
__device__ __forceinline__ int tri_row(int k) {
  return k < 1 ? 0 : k < 3 ? 1 : k < 6 ? 2 : k < 10 ? 3 : k < 15 ? 4 : 5;
}
__device__ __forceinline__ int tri_col(int k) { return k - tri_row(k) * (tri_row(k) + 1) / 2; }

// The base's world pose (the twin's fk), and its inverse (R^T, -R^T p).
__device__ __forceinline__ void rr_base_pose(const float* P, const float* q, const float* p, float* WR, float* Wp) {
  float RB[9], R0[9], p0[3], t[3];
  quat_rot(q, RB);
  h_rot(P + OFF_SUCH, R0);
  h_pos(P + OFF_SUCH, p0);
  mm3(RB, R0, WR);
  mv3(RB, p0, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) Wp[k] = p[k] + t[k];
}

__device__ __forceinline__ void rr_inverse(const float* R, const float* p, float* Ri, float* pi) {
  float t[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) Ri[r * 3 + cc] = R[cc * 3 + r];
  mv3(Ri, p, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) pi[k] = -t[k];
}

// A link's share of its parent's articulated inertia and bias force,
// X^T Ma X (its lower triangle, row by row) and X^T pa, X = build_X(iR, ip):
// the products with X's zero block left out, the others summed in the full
// product's order, so each entry rounds as the full product's does.
__device__ __forceinline__ void rr_to_parent(const float* iR, const float* ip, const float* Ma, const float* pa,
                                             float* C) {
  float X[36], MaX[36];
  build_X(iR, ip, X);
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int cc = 0; cc < 6; ++cc) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        if (k < 3 || cc >= 3) acc += Ma[r * 6 + k] * X[k * 6 + cc];
      MaX[r * 6 + cc] = acc;
    }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int cc = 0; cc <= r; ++cc) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        if (k < 3 || r >= 3) acc += X[k * 6 + r] * MaX[k * 6 + cc];
      C[tri(r, cc)] = acc;
    }
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (k < 3 || r >= 3) acc += X[k * 6 + r] * pa[k];
    C[21 + r] = acc;
  }
}

// The PD closure's torque of joint k from the state before the step.
struct RrPdTau {
  float kp, kd;
  __device__ float operator()(float s, float sd, int) const { return -kp * s - kd * sd; }
};

// The step's torques from the slot's torque row: an RK4 step wrote it once at
// its start; the one-step kernel K3 copies its input there, the env rollout
// its policy's torques.
struct SlotTauRr {
  Slot sl;
  __device__ float operator()(float, float, int k) const { return sl[SL_TAU + k]; }
};

constexpr int KIN = 24;  // what a link hands its children: WR, Wp, Wv, v
constexpr int CON = 27;  // what it hands its parent: X^T Ma X's lower triangle, X^T pa

// The free step of the env of slot `sl` on its lane g: fills the slot's
// factorization and contact-parent rows, each lane's sdd with its links'
// free joint accelerations (by entry, as RrLane), and the slot's SL_A0 row
// with the base's; gz is gravity's z, mmul the env's Mmul (read by a
// JX_DOMAIN build only). `tau_of(s, sd, k)` gives joint k's
// torque. Frozen (RK4-fast's stages): the parents' PAR_A rows hold world
// wrenches that act as external forces, and stay.
template <bool Frozen, class Tau>
__device__ __forceinline__ void rr_free_body(const float* P, float gz, float mmul, Slot sl, int g,
                                             const RrLane& st, float (&sdd)[NE], Tau tau_of) {
  __syncwarp();  // the env's lanes are done with the slot's last use
  // Forward kinematics and the body velocities, root to leaves. A link's F
  // row takes its body velocity; its registers, what its children pull.
  {
    float K[ROUNDS][KIN] = {};
    if (g == 0) {
      float* WR = K[0];
      float* Wp = K[0] + 9;
      float* Wv = K[0] + 12;
      float* v0 = K[0] + 18;
      float x[13];
      rr_base_load(sl, x);
      rr_base_pose(P, x + 3, x, WR, Wp);
#pragma unroll
      for (int k = 0; k < 6; ++k) Wv[k] = FLOATING ? x[7 + k] : 0.0f;
      if (FLOATING) {
        float Ri[9], pi[3];
        rr_inverse(WR, Wp, Ri, pi);
        xv(Ri, pi, x + 7, v0);
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) sl[SL_F + k] = v0[k];
      if (JX_RR_PAR_OF[0] >= 0) {
        const int o = SL_PAR + JX_RR_PAR_OF[0] * 24;
#pragma unroll
        for (int k = 0; k < 18; ++k) sl[o + PAR_WR + k] = K[0][k];
      }
    }
#pragma unroll 1
    for (int lev = 0; lev < NLEV; ++lev) {
      float Kn[ROUNDS][KIN];
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        const int i = rr_link(lev, r, g);
        float Kl[KIN];
        rr_pull(K, i >= 0 ? JX_LAM[i] : -1, [&](int k, float x) { Kl[k] = x; });
#pragma unroll
        for (int k = 0; k < KIN; ++k) Kn[r][k] = 0.0f;
        if (i < 0) continue;
        const int e = lev * ROUNDS + r;
        const float sdi = st.sd[e];
        float* WR = Kn[r];
        float* Wp = Kn[r] + 9;
        float* Wv = Kn[r] + 12;
        float* v = Kn[r] + 18;
        float rR[9], rp[3], t[6], iR[9], ip[3];
        relative_transform(P, i, st.s[e], rR, rp);
        mm3(Kl, rR, WR);
        mv3(Kl, rp, t);
#pragma unroll
        for (int k = 0; k < 3; ++k) Wp[k] = Kl[9 + k] + t[k];
        // Inverse pair for the dynamics: (rR^T, -rR^T rp).
        rr_inverse(rR, rp, iR, ip);
#pragma unroll
        for (int k = 0; k < 9; ++k) sl[SL_IR + i * 9 + k] = iR[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) sl[SL_IP + i * 3 + k] = ip[k];
        const float* S = P + OFF_S + i * 6;
        const float Sl[3] = {S[0] * sdi, S[1] * sdi, S[2] * sdi};
        const float Sa[3] = {S[3] * sdi, S[4] * sdi, S[5] * sdi};
        float RSa[3], RSl[3], cr[3];
        mv3(WR, Sa, RSa);
        mv3(WR, Sl, RSl);
        cross3(Wp, RSa, cr);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          Wv[k] = Kl[12 + k] + (RSl[k] + cr[k]);
          Wv[k + 3] = Kl[15 + k] + RSa[k];
        }
        xv(iR, ip, Kl + 18, t);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          v[k] = t[k] + S[k] * sdi;
          sl[SL_F + i * 6 + k] = v[k];
        }
        if (JX_RR_PAR_OF[i] >= 0) {
          const int o = SL_PAR + JX_RR_PAR_OF[i] * 24;
#pragma unroll
          for (int k = 0; k < 18; ++k) sl[o + PAR_WR + k] = Kn[r][k];
        }
      }
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r)
#pragma unroll
        for (int k = 0; k < KIN; ++k) K[r][k] = Kn[r][k];
    }
  }

  // Pass 2: articulated inertias and bias forces, leaves to root, each link
  // pulling its children's shares; the base (lane 0) last, its Cholesky
  // factor to the slot. A link's U and d go to the slot, its u to its UM row.
  {
    float C[ROUNDS][CON] = {};
#pragma unroll 1
    for (int lev = NLEV - 1; lev >= -1; --lev) {
      const int pulls = lev < 0 && !FLOATING ? 0 : JX_RR_PULLS[lev + 1];
      float Cn[ROUNDS][CON];
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        const int i = lev >= 0 ? rr_link(lev, r, g) : g == 0 && r == 0 ? 0 : -1;
        float MA[36], pA[6], v[6];
        if (i >= 0) {
          const float* M = P + OFF_M + i * 36;
          load_vec(sl, SL_F + i * 6, 6, v);
          if constexpr (DOMAIN) {
            // The env's inertia, M times Mmul (the twin's aba).
#pragma unroll
            for (int k = 0; k < 36; ++k) MA[k] = M[k] * mmul;
            vxstar_Mv(v, MA, pA);
          } else {
#pragma unroll
            for (int k = 0; k < 36; ++k) MA[k] = M[k];
            vxstar_Mv(v, M, pA);
          }
          if (Frozen && JX_RR_PAR_OF[i] >= 0) {
            // The frozen wrench f enters as the twin's aba takes f_ext:
            // pA -= X^T f at the link's world pose.
            const int o = SL_PAR + JX_RR_PAR_OF[i] * 24;
            float WR[9], Wp[3], f[6], t[6];
#pragma unroll
            for (int k = 0; k < 9; ++k) WR[k] = sl[o + PAR_WR + k];
            load_vec(sl, o + PAR_WP, 3, Wp);
            load_vec(sl, o + PAR_A, 6, f);
            xtf(WR, Wp, f, t);
#pragma unroll
            for (int k = 0; k < 6; ++k) pA[k] -= t[k];
          }
        }
#pragma unroll 1
        for (int h = 0; h < pulls; ++h) {
          const int c0 = i >= 0 ? JX_RR_CH_OFF[i] : 0;
          const int ch = i >= 0 && c0 + h < JX_RR_CH_OFF[i + 1] ? JX_RR_CH[c0 + h] : -1;
          rr_pull(C, ch, [&](int k, float x) {
            if (k < 21) {
              const int r = tri_row(k), c = tri_col(k);
              MA[r * 6 + c] += x;
              if (r != c) MA[c * 6 + r] += x;
            } else {
              pA[k - 21] += x;
            }
          });
        }
#pragma unroll
        for (int k = 0; k < CON; ++k) Cn[r][k] = 0.0f;
        if (i < 0) continue;
        if (i == 0) {
          // The base: its acceleration, and the factor the solve reuses.
          if (FLOATING) {
            float L[36], x[6];
            chol6_factor(MA, L);
            chol6_substitute(L, pA, x);
#pragma unroll
            for (int k = 0; k < 36; ++k) sl[SL_L0 + k] = L[k];
#pragma unroll
            for (int k = 0; k < 6; ++k) sl[SL_A0 + k] = -x[k];
          } else {
            const float g6[6] = {0.0f, 0.0f, gz, 0.0f, 0.0f, 0.0f};
            float x[13], WR[9], Wp[3], Ri[9], pi[3], t[6];
            rr_base_load(sl, x);
            rr_base_pose(P, x + 3, x, WR, Wp);
            rr_inverse(WR, Wp, Ri, pi);
            xv(Ri, pi, g6, t);
#pragma unroll
            for (int k = 0; k < 6; ++k) sl[SL_A0 + k] = -t[k];
          }
          continue;
        }
        const int e = lev * ROUNDS + r;
        const float sdi = st.sd[e];
        const float* S = P + OFF_S + i * 6;
        float U[6];
        mv6(MA, S, U);
        float dd = 0.0f, sp = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          dd += S[k] * U[k];
          sp += S[k] * pA[k];
        }
        const float tau = tau_of(st.s[e], sdi, i - 1);
#pragma unroll
        for (int k = 0; k < 6; ++k) sl[SL_U + i * 6 + k] = U[k];
        sl[SL_D + i] = dd;
        const float u = tau - sp;
        sl[SL_UM + i] = u;
        if (JX_LAM[i] == 0 && !FLOATING) continue;
        const float inv_d = 1.0f / dd;
#pragma unroll
        for (int rr = 0; rr < 6; ++rr)
#pragma unroll
          for (int cc = 0; cc < 6; ++cc) MA[rr * 6 + cc] = MA[rr * 6 + cc] - U[rr] * U[cc] * inv_d;  // Ma
        float c[6], t[6], pa[6], iR[9], ip[3];
        joint_bias(S, sdi, v, c);
        mv6(MA, c, t);
        const float ud = u * inv_d;
#pragma unroll
        for (int k = 0; k < 6; ++k) pa[k] = pA[k] + t[k] + U[k] * ud;
        load_vec(sl, SL_IR + i * 9, 6, iR);
        load_vec(sl, SL_IR + i * 9 + 6, 3, iR + 6);
        load_vec(sl, SL_IP + i * 3, 3, ip);
        rr_to_parent(iR, ip, MA, pa, Cn[r]);
      }
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r)
#pragma unroll
        for (int k = 0; k < CON; ++k) C[r][k] = Cn[r][k];
    }
  }

  // Pass 3: accelerations, root to leaves, each link pulling its parent's.
  {
    float A[ROUNDS][6] = {};
    if (g == 0) {
      load_vec(sl, SL_A0, 6, A[0]);
      if (!Frozen && JX_RR_PAR_OF[0] >= 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) sl[SL_PAR + JX_RR_PAR_OF[0] * 24 + PAR_A + k] = A[0][k];
      }
    }
#pragma unroll 1
    for (int lev = 0; lev < NLEV; ++lev) {
      float An[ROUNDS][6];
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        const int i = rr_link(lev, r, g);
        float al[6];
        rr_pull(A, i >= 0 ? JX_LAM[i] : -1, [&](int k, float x) { al[k] = x; });
#pragma unroll
        for (int k = 0; k < 6; ++k) An[r][k] = 0.0f;
        if (i < 0) continue;
        const int e = lev * ROUNDS + r;
        const float* S = P + OFF_S + i * 6;
        float v[6], c[6], a_i[6], iR[9], ip[3], U[6];
        load_vec(sl, SL_F + i * 6, 6, v);
        joint_bias(S, st.sd[e], v, c);
        load_vec(sl, SL_IR + i * 9, 6, iR);
        load_vec(sl, SL_IR + i * 9 + 6, 3, iR + 6);
        load_vec(sl, SL_IP + i * 3, 3, ip);
        load_vec(sl, SL_U + i * 6, 6, U);
        xv(iR, ip, al, a_i);
        float ua = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          a_i[k] += c[k];
          ua += U[k] * a_i[k];
        }
        const float sddi = (sl[SL_UM + i] - ua) / sl[SL_D + i];
        sdd[e] = sddi;
#pragma unroll
        for (int k = 0; k < 6; ++k) An[r][k] = a_i[k] + S[k] * sddi;
        if (!Frozen && JX_RR_PAR_OF[i] >= 0) {
#pragma unroll
          for (int k = 0; k < 6; ++k) sl[SL_PAR + JX_RR_PAR_OF[i] * 24 + PAR_A + k] = An[r][k];
        }
      }
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r)
#pragma unroll
        for (int k = 0; k < 6; ++k) A[r][k] = An[r][k];
    }
  }
  // The factorization and the parents' rows are in for the lanes. A block
  // barrier, though the lanes need a warp's alone: it starts the block's
  // warps on the contact solve together, so that they run one stretch of
  // code (on an H100 K1-rr ran 32 % slower without it, PERF.md).
  __syncthreads();
}

// rr_free_body in a call of its own, so that the contact solve's registers
// are not the ABA's: on an H100 the one-step K3-rr ran 23 % slower with it
// inlined, K1-rr and K5-rr 2-3 % (PERF.md). RK4-fast, whose four frozen
// ABAs a step outnumber its one solve, inlines the body.
template <bool Frozen, class Tau>
__device__ __noinline__ void rr_free_lanes(const float* P, float gz, float mmul, Slot sl, int g, const RrLane& st,
                                          float (&sdd)[NE], Tau tau_of) {
  rr_free_body<Frozen>(P, gz, mmul, sl, g, st, sdd, tau_of);
}

// ----- the forward step: the state on the lanes, the SIE and RK4 steps -----

// Env b's s, sd, p, q and v into lane g's share, and on lane 0 the base's
// into the slot `sl`.
__device__ __forceinline__ void rr_load_lane(const StateIn& in, int B, int b, int g, Slot sl, RrLane& st) {
#pragma unroll
  for (int e = 0; e < NE; ++e) st.s[e] = st.sd[e] = 0.0f;
#pragma unroll
  for (int lev = 0; lev < NLEV; ++lev)
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int i = rr_link(lev, r, g), e = lev * ROUNDS + r;
      if (i < 0) continue;
      st.s[e] = in.s[(i - 1) * B + b];
      st.sd[e] = in.sd[(i - 1) * B + b];
    }
  if (g != 0) return;
#pragma unroll
  for (int k = 0; k < 13; ++k)
    sl[rr_base_at(k)] = k < 3 ? in.p[k * B + b] : k < 7 ? in.q[(k - 3) * B + b] : in.v[(k - 7) * B + b];
}

__device__ __forceinline__ void rr_store_lane(const StateOut& out, int B, int b, int g, Slot sl, const RrLane& st) {
#pragma unroll
  for (int lev = 0; lev < NLEV; ++lev)
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int i = rr_link(lev, r, g), e = lev * ROUNDS + r;
      if (i < 0) continue;
      out.s[(i - 1) * B + b] = st.s[e];
      out.sd[(i - 1) * B + b] = st.sd[e];
    }
  if (g != 0) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) out.p[k * B + b] = sl[rr_base_at(k)];
#pragma unroll
  for (int k = 0; k < 4; ++k) out.q[k * B + b] = sl[rr_base_at(3 + k)];
#pragma unroll
  for (int k = 0; k < 6; ++k) out.v[k * B + b] = sl[rr_base_at(7 + k)];
}

// Lane g's point slots (rr_points), computed from a copy of g that the
// compiler cannot see through: at each step, so that it cannot keep the
// slots' tables and addresses in registers across a step loop, where the
// contact solve needs them (these three helpers cut ptxas' spills, PERF.md).
__device__ __forceinline__ void rr_step_points(int g, int* pt) {
  asm volatile("" : "+r"(g));
  rr_points(g, pt);
}

// P and the slot's base address, from copies the compiler cannot see
// through, for the same reason.
__device__ __forceinline__ void rr_step_bases(const float*& P, Slot& sl) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+l"(P), "+l"(sl.base));
#endif
}

// m's rows from a pointer at an offset the compiler cannot see to be 0
// (blockDim.x < 2048): so indexed, the lane's m rows stay in local memory,
// read by the solve's warm start and the update after it, and the
// registers are left to the solve's point vectors.
__device__ __forceinline__ float* rr_local_rows(float* m) { return m + static_cast<int>(blockDim.x >> 11); }

// The base's world-frame acceleration from its link-frame one a (gravity gz
// added), at the pose of the base's state x (rr_base_load).
__device__ __forceinline__ void rr_world_a(const float* P, float gz, const float* x, const float* a, float* W_a) {
  if (FLOATING) {
    float WR[9], Wp[3];
    rr_base_pose(P, x + 3, x, WR, Wp);
    xv(WR, Wp, a, W_a);
    W_a[2] += gz;
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) W_a[k] = 0.0f;
  }
}

// One semi-implicit Euler step of the env of slot `sl` on its lane g, in
// place: the free ABA (rr_free_lanes), the contact solve (rr_solve) on the
// lane's point slots and m rows, and the update, each lane its own entries;
// `dom`, the env's rows (rr_load_domain), which a build without JX_DOMAIN
// and JX_TERR_OFF does not read.
template <class Tau>
__device__ void rr_step_env(const float* P, const Scalars& sc, Slot sl, int g, RrLane& st, float* m, Tau tau_of,
                            const EnvDomain& dom) {
  float sdd[NE];
  const float gz = DOMAIN ? sc.gz * dom.gmul : sc.gz;
  rr_free_lanes<false>(P, gz, dom.Mmul, sl, g, st, sdd, tau_of);
  m = rr_local_rows(m);
  int pt[OWN];
  rr_step_points(g, pt);
  rr_step_bases(P, sl);
  float x[OWN * 3];
  rr_solve(P, sc, sl, g, pt, m, x, dom);

  // m <- the solved forces, written as m + dt (x - m)/dt with each operation
  // rounded alone, as the plain version computes it.
  const float dt = sc.dt;
#pragma unroll
  for (int k = 0; k < OWN * 3; ++k) {
    const float md = __fdiv_rn(__fsub_rn(x[k], m[k]), dt);
    m[k] = __fadd_rn(m[k], __fmul_rn(dt, md));
  }

  // The contact-coupled accelerations, the free ones plus M^-1 J^T x (the UM
  // rows, the base's F row), and the semi-implicit Euler update.
#pragma unroll
  for (int lev = 0; lev < NLEV; ++lev)
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int i = rr_link(lev, r, g), e = lev * ROUNDS + r;
      if (i < 0) continue;
      st.sd[e] = st.sd[e] + dt * (sdd[e] + sl[SL_UM + i]);
      st.s[e] = st.s[e] + dt * st.sd[e];
    }
  if (g != 0) return;
  float base[13], a[6], W_a[6];
  rr_base_load(sl, base);
#pragma unroll
  for (int k = 0; k < 6; ++k) a[k] = sl[SL_A0 + k] + sl[SL_F + k];
  rr_world_a(P, gz, base, a, W_a);
  float* const p = base;
  float* const q = base + 3;
  float* const v = base + 7;
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = v[k] + dt * W_a[k];
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
  rr_base_store(sl, base);
}

// One RK4 (Integrator 1) or RK4-fast (2) step of the env of slot `sl` on its
// lane g, in place (see the note at the top). `rk` holds the step's start
// state y0 and the accumulator in env b's column: the rows s, sd, p, q, v
// first, then the m rows by point; each lane reads and writes its entries'.
template <int Integrator>
__device__ void rr_rk4_step(const float* P, const Scalars& sc, Slot sl, int g, RrLane& st, float* m,
                            const Rk4Scratch& rk, int b) {
  constexpr int NB = 2 * NJ + 13;  // the rows s, sd, p, q, v
  constexpr int R_SD = NJ, R_P = 2 * NJ;
  const float dt = sc.dt;
  const int rs = rk.stride;
  float* const y0a = rk.y0 + b;
  float* const acca = rk.acc + b;
  float* const y0m = rk.y0 + NB * rs + b;
  float* const accm = rk.acc + NB * rs + b;
  const SlotTauRr tau{sl};
  m = rr_local_rows(m);

  // The step's start: q normalised, the torques, y0.
#pragma unroll
  for (int lev = 0; lev < NLEV; ++lev)
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int i = rr_link(lev, r, g), e = lev * ROUNDS + r;
      if (i < 0) continue;
      sl[SL_TAU + i - 1] = -sc.kp * st.s[e] - sc.kd * st.sd[e];
      y0a[(i - 1) * rs] = st.s[e];
      y0a[(R_SD + i - 1) * rs] = st.sd[e];
    }
  if (g == 0) {
    float base[13];
    rr_base_load(sl, base);
    quat_normalize(base + 3);
    rr_base_store(sl, base);
#pragma unroll
    for (int k = 0; k < 13; ++k) y0a[(R_P + k) * rs] = base[k];
  }
  if (Integrator == 1) {
    int pt[OWN];
    rr_step_points(g, pt);
#pragma unroll
    for (int k = 0; k < OWN; ++k)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (pt[k] >= 0) y0m[(pt[k] * 3 + j) * rs] = m[k * 3 + j];
  }

#pragma unroll 1
  for (int stage = 0; stage < 4; ++stage) {
    float sdd[NE];
    const bool solve = Integrator == 1 || stage == 0;
    if (solve) {
      int pt[OWN];
      rr_step_points(g, pt);
      if (Integrator == 2)
        rr_free_body<false>(P, sc.gz, 1.0f, sl, g, st, sdd, tau);
      else
        rr_free_lanes<false>(P, sc.gz, 1.0f, sl, g, st, sdd, tau);
      float x[OWN * 3];
      rr_solve(P, sc, sl, g, pt, m, x);
      if (Integrator == 2) rr_wrenches(P, sl, g, pt, x);
#pragma unroll
      for (int k = 0; k < OWN; ++k)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int e = k * 3 + j;
          if (pt[k] < 0) continue;
          // m's rate steers m to the solved forces.
          const float md = (x[e] - m[e]) / dt;
          if (Integrator == 1) {
            const int row = (pt[k] * 3 + j) * rs;
            float a = stage == 0 ? 0.0f : accm[row];
            m[e] = rk4_entry(stage, dt, md, y0m[row], a);
            accm[row] = a;
          } else {
            // RK4-fast: the rate is frozen for the four stages.
            float a = 0.0f, y = 0.0f;
#pragma unroll
            for (int st4 = 0; st4 < 4; ++st4) y = rk4_entry(st4, dt, md, m[e], a);
            m[e] = y;
          }
        }
    }
    // The stage's accelerations: the free ones plus the contacts' (RK4), or
    // the free ABA under the frozen wrenches (RK4-fast).
    if (Integrator == 2) rr_free_body<true>(P, sc.gz, 1.0f, sl, g, st, sdd, tau);

    // Each lane the rates of its entries and their next values.
#pragma unroll
    for (int lev = 0; lev < NLEV; ++lev)
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        const int i = rr_link(lev, r, g), e = lev * ROUNDS + r;
        if (i < 0) continue;
        const int k = i - 1;
        const float sddi = Integrator == 1 ? sdd[e] + sl[SL_UM + i] : sdd[e];
        float a = stage == 0 ? 0.0f : acca[k * rs];
        const float ks = st.sd[e];
        st.s[e] = rk4_entry(stage, dt, ks, y0a[k * rs], a);
        acca[k * rs] = a;
        a = stage == 0 ? 0.0f : acca[(R_SD + k) * rs];
        st.sd[e] = rk4_entry(stage, dt, sddi, y0a[(R_SD + k) * rs], a);
        acca[(R_SD + k) * rs] = a;
      }
    if (g != 0) continue;
    float base[13], a[6], W_a[6], pd[3], qd[4];
    rr_base_load(sl, base);
#pragma unroll
    for (int k = 0; k < 6; ++k) a[k] = Integrator == 1 ? sl[SL_A0 + k] + sl[SL_F + k] : sl[SL_A0 + k];
    rr_world_a(P, sc.gz, base, a, W_a);
    cross3(base + 10, base, pd);
#pragma unroll
    for (int k = 0; k < 3; ++k) pd[k] = base[7 + k] + pd[k];
    quat_rate(base + 3, base + 10, qd);
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      const int row = (R_P + k) * rs;
      float a = stage == 0 ? 0.0f : acca[row];
      const float rate = k < 3 ? pd[k] : k < 7 ? qd[k - 3] : W_a[k - 7];
      base[k] = rk4_entry(stage, dt, rate, y0a[row], a);
      acca[row] = a;
    }
    if (stage == 3) quat_normalize(base + 3);
    rr_base_store(sl, base);
  }
}

#endif  // JX_RR_WIDTH

}  // namespace
