// The soft-contact step of the batched engine, one env on a group of
// JX_LN_LANES lanes of a warp, with the step's working set in a slot of
// shared memory.
//
// It is the arithmetic of the twin's step (ops/batched_engine.py) with
// step_env.cuh's algebra (fk, Hunt/Crossley soft contacts on flat ground, the
// three-pass articulated-body algorithm with the 6x6 base Cholesky,
// semi-implicit Euler), as one thread an env once ran it, rearranged for lanes:
//  * the tree passes run level by level (the generated header's schedule
//    from JX_LAM; the humanoid's tree is 7 deep and at most 4 wide), the
//    links of a level dealt to the env's lanes, a lane per link; a link's
//    lane is the same in every pass, so a joint's quantities stay with one
//    lane. Pass 1's velocities ride with fk (root to leaves), its bias forces
//    with pass 2;
//  * in pass 2 a link writes its X^T Ma X (its lower triangle: Ma is
//    symmetric, so MA is symmetric by construction) and X^T pa to its T row,
//    and its parent pulls them in descending child order, the order in which
//    a one-thread leaves-to-root loop over the links pushes them;
//  * the contact points are dealt to the lanes in slots (each parent's
//    points in contact-index order, padded to a multiple of the lanes, so a
//    group of JX_LN_LANES slots has one parent); a fixed xor shuffle tree
//    sums a group's wrenches, and a parent's groups add in order;
//  * the base (link 0, the Cholesky, the base's SIE) runs on lane 0.
// Only the order of the sums within a parent's points and of a link's
// children, and MA's upper triangle (mirrored from the lower), differ from
// that one-thread step; two runs agree to the bit.
//
// The step reads its state from columns of device memory (EnvIn: K4's
// forward recompute, which gives lane 0 the new base velocity and writes
// nothing else), or from the env's state rows in its slot (slot_state: the
// rollouts K1 and K5, and the one-step K2 and K3 of step.cu, whose block
// loads the rows from device columns and stores them back after the step),
// which it overwrites with the new state, each piece by
// the lane that owns it: a joint's s and sd by its link's lane in pass 3, a
// point's m by its slot's lane in the contact phase, the base's p, q and v
// by lane 0. Step t + 1 then reads what step t wrote after one ln_sync().
//
// The RK4 rollouts (rollout.cu with JX_INTEGRATOR 1 and 2) take the step's
// rate form (STEP_RATE): the same passes from a stage's state, which write
// the state's rate in its place, piece by piece as above: s' = sd, sd' the
// joint accelerations, m' the contact law's, p' = v + w x p, q' with the
// Baumgarte term, v' the base's world acceleration. STEP_RATE_FROZEN skips
// the contact phase and leaves m as it is: pass 2 then takes the parents'
// wrenches that the last STEP_RATE wrote (RK4-fast's, frozen at the step's
// start).
//
// The slot has one of two layouts, chosen at build time (JX_LN_FORWARD in
// the generated header; cuda_build.lane_tables sizes both):
//  * K4's (0) keeps what K4's reverse sweep reads (step_vjp.cu says which
//    rows it reuses for adjoints): per link the world pose (WR, Wp), the
//    child -> parent pair (iR, ip), the body velocity v, the articulated
//    inertia MA and bias force pA, the acceleration a, and a T row of 28
//    (the world velocity during fk and the contacts, the pass-2 contribution
//    to the parent after); per contact parent its wrench and world velocity;
//    and a base row. U, d, u and c are recomputed where needed.
//  * The forward-only one (1) keeps per link iR, ip, v, and (U, d, u) from
//    pass 2 for pass 3 in place of MA and pA (link 0's MA and pA, for the
//    base's Cholesky, in the base's row); WR, Wp and Wv live on the T row
//    until the link writes its pass-2 contribution there (a contact parent
//    reads its pose in pass 2 before it does; link 0 writes none, so its
//    pose stays for the base's SIE), and a after Wv on the same row in pass
//    3; per contact parent its wrench; then the state.
// The slot is field-major with the block's envs minor at an odd stride
// (ES), so the envs of a warp reading one field fall in distinct banks.

#pragma once

#include <type_traits>

#include "step_env.cuh"

#ifndef JX_LN_FORWARD
#define JX_LN_FORWARD 0
#endif

namespace {

constexpr int G = JX_LN_LANES;      // lanes an env
constexpr int OWN = JX_LN_OWN;      // point slots a lane
constexpr int NPAR = JX_LN_NPAR;    // links with contact points
constexpr int NLEV = JX_LN_NLEV;    // depth levels of links 1..NL-1
constexpr int ENVS = JX_LN_ENVS;    // envs a block
constexpr int ES = ENVS + 1 - ENVS % 2;  // slot stride: odd
constexpr int LN_THREADS = ENVS * G;     // a block: part of a warp, or whole warps
constexpr unsigned LN_MASK = LN_THREADS >= 32 ? 0xffffffffu : (1u << LN_THREADS) - 1u;
constexpr bool FORWARD = JX_LN_FORWARD != 0;
static_assert(!RELAXED, "soft_step_lanes.cuh is the soft-contact step");
static_assert(32 % G == 0 && (LN_THREADS <= 32 || LN_THREADS % 32 == 0), "an env's lanes share a warp");

#if JX_LN_FORWARD
// A link's rows: T (28) holds WR (9), Wp (3) and Wv (6) during fk and the
// contacts, the pass-2 contribution after, and a (6, at LK_A) in pass 3.
constexpr int LK_T = 0, LK_WR = 0, LK_WP = 9, LK_WV = 12, LK_A = 18, LK_V = 28, LK_IR = 34, LK_IP = 43,
              LK_UDU = 46, LK = 54;
// A contact parent's row: its wrench.
constexpr int PR_F = 0, PR = 6;
// The base's rows: link 0's MA and pA.
constexpr int BS_MA0 = 0, BS_PA0 = 36, BS = 42;
// The state's rows, in the order of K5's observation [s, sd, q, v, p_z]
// (ST_N entries), then for an RK4 rollout the step's torques.
constexpr int ST_S = 0, ST_SD = NJ, ST_Q = 2 * NJ, ST_V = 2 * NJ + 4, ST_P = 2 * NJ + 10, ST_M = 2 * NJ + 13,
              ST_N = 2 * NJ + 13 + NCM * 3, ST_TAU = ST_N, ST = ST_N + (INTEGRATOR != 0 ? NJ : 0);
#else
// A link's rows.
constexpr int LK_WR = 0, LK_WP = 9, LK_IR = 12, LK_IP = 21, LK_V = 24, LK_MA = 30, LK_PA = 66, LK_A = 72,
              LK_T = 78, LK = 106;
constexpr int LK_WV = LK_T;  // the world velocity, on T during fk and the contacts
// A contact parent's rows: its wrench, world velocity, and (K4) the
// adjoints of its world pose and velocity from the contacts.
constexpr int PR_F = 0, PR_WV = 6, PR_GWR = 12, PR_GWP = 21, PR_GWV = 24, PR = 30;
// The base's rows (K4's adjoints of the base).
constexpr int BS_GA0 = 0, BS_BR0I = 6, BS_BP0I = 15, BS_GWR0 = 18, BS_GWP0 = 27, BS_BV = 30, BS_BP = 36,
              BS_BQ = 39, BS = 43;
constexpr int ST = 0;
#endif
constexpr int SL_PAR = NL * LK, SL_BASE = SL_PAR + NPAR * PR, SL_ST = SL_BASE + BS, SLOT = SL_ST + ST;
static_assert(SLOT == JX_LN_SLOT, "the generated header sizes the slot as this layout does");
// T's pass-2 contribution: X^T Ma X's lower triangle, then X^T pa.
constexpr int T_PA = 21;

struct Slot {
  float* base;  // the env's first float; field j at base[j * ES]
  __device__ __forceinline__ float& operator[](int j) const { return base[j * ES]; }
  __device__ __forceinline__ void ld(int j, int n, float* o) const {
#pragma unroll
    for (int k = 0; k < 36; ++k)
      if (k < n) o[k] = base[(j + k) * ES];
  }
  __device__ __forceinline__ void st(int j, int n, const float* x) const {
#pragma unroll
    for (int k = 0; k < 36; ++k)
      if (k < n) base[(j + k) * ES] = x[k];
  }
  __device__ __forceinline__ void add(int j, int n, const float* x) const {
#pragma unroll
    for (int k = 0; k < 36; ++k)
      if (k < n) base[(j + k) * ES] += x[k];
  }
};

// One row of a state leaf for one env: x[k] is entry k, n floats apart
// (a leaf's batch in device memory, or ES in a slot).
template <class T>
struct Col {
  T* x;
  int n;
  __device__ __forceinline__ T& operator[](int k) const { return x[k * n]; }
};

// One env's state, as columns; a step overwrites a state of writable columns.
template <class T>
struct EnvState {
  Col<T> s, sd, p, q, v, m;
  static constexpr bool writes = !std::is_const<T>::value;
};
using EnvIn = EnvState<const float>;

__device__ __forceinline__ EnvIn env_in(const StateIn& in, int B, int b) {
  return EnvIn{{in.s + b, B}, {in.sd + b, B}, {in.p + b, B}, {in.q + b, B}, {in.v + b, B}, {in.m + b, B}};
}

__device__ __forceinline__ void ln_sync() { __syncwarp(LN_MASK); }

// The sum of x over the env's lanes, every lane getting the same bits: an
// xor butterfly, called by every lane of the warp together.
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) x += __shfl_xor_sync(LN_MASK, x, off);
  return x;
}

// (R0^T, -R0^T p0): the inverse of the base's world pose.
__device__ __forceinline__ void base_inverse(Slot sl, float* R0i, float* p0i) {
  float R0[9], p0[3], t[3];
  sl.ld(LK_WR, 9, R0);
  sl.ld(LK_WP, 3, p0);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) R0i[r * 3 + cc] = R0[cc * 3 + r];
  mv3(R0i, p0, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) p0i[k] = -t[k];
}

// A link's U = MA S, d = S.U and u = tau - S.pA.
__device__ __forceinline__ void link_udu(const float* MA, const float* pA, const float* S, float tau, float* U,
                                         float& d, float& u) {
  mv6(MA, S, U);
  float dd = 0.0f, sp = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    dd += S[k] * U[k];
    sp += S[k] * pA[k];
  }
  d = dd;
  u = tau - sp;
}

// A link's child -> parent pair (iR, ip), as fk stored it from the joint
// position si.
__device__ __forceinline__ void link_pair(const float* P, Slot sl, int i, float si, float* iR, float* ip) {
  (void)P;
  (void)si;
  sl.ld(i * LK + LK_IR, 9, iR);
  sl.ld(i * LK + LK_IP, 3, ip);
}

// A point's world position and velocity from its parent's rows.
__device__ __forceinline__ void point_kinematics(const float* P, int c, const float* R, const float* Wp,
                                                 const float* Wv, float* pc, float* pd) {
  const float* Lp = P + OFF_CP + c * 3;
  float t[3];
  mv3(R, Lp, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) pc[k] = t[k] + Wp[k];
  cross3(Wv + 3, pc, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) pd[k] = Wv[k] + t[k];
}

// A contact parent's world pose and velocity (the velocity from its T row
// during fk and the contacts, from its parent row after: K4's layout only).
__device__ __forceinline__ void parent_pose(Slot sl, int par, bool from_t, float* R, float* Wp, float* Wv) {
  sl.ld(par * LK + LK_WR, 9, R);
  sl.ld(par * LK + LK_WP, 3, Wp);
#if JX_LN_FORWARD
  (void)from_t;
  sl.ld(par * LK + LK_WV, 6, Wv);
#else
  sl.ld(from_t ? par * LK + LK_WV : SL_PAR + JX_LN_PAR_ROW[par] * PR + PR_WV, 6, Wv);
#endif
}

// The torques of one env, tau[k] for joint k.
struct ColTau {
  Col<const float> tau;
  __device__ __forceinline__ float operator()(int k) const { return tau[k]; }
};

#if JX_LN_FORWARD
// The env's state rows in its slot, which a step overwrites.
__device__ __forceinline__ EnvState<float> slot_state(Slot sl) {
  float* st = sl.base + SL_ST * ES;
  return EnvState<float>{{st + ST_S * ES, ES}, {st + ST_SD * ES, ES}, {st + ST_P * ES, ES},
                         {st + ST_Q * ES, ES}, {st + ST_V * ES, ES}, {st + ST_M * ES, ES}};
}

// The PD policy tau = -kp*s - kd*sd of the state before the step (a slot's:
// pass 2 reads it before pass 3 writes the new s and sd).
struct SlotPd {
  Col<float> s, sd;
  float kp, kd;
  __device__ __forceinline__ float operator()(int k) const { return -kp * s[k] - kd * sd[k]; }
};

// Env b's state from the batch's leaves into its slot rows, each lane a
// share of the entries (lane g the entries g, g + G, ... of each leaf).
__device__ __forceinline__ void load_state(const StateIn& in, int B, int b, const EnvState<float>& x, int g) {
  for (int k = g; k < NJ; k += G) {
    x.s[k] = in.s[k * B + b];
    x.sd[k] = in.sd[k * B + b];
  }
  for (int k = g; k < 3; k += G) x.p[k] = in.p[k * B + b];
  for (int k = g; k < 4; k += G) x.q[k] = in.q[k * B + b];
  for (int k = g; k < 6; k += G) x.v[k] = in.v[k * B + b];
  for (int k = g; k < NCM * 3; k += G) x.m[k] = in.m[k * B + b];
}

// The slot's state to env b of the batch's leaves, shared as load_state.
__device__ __forceinline__ void store_state(const EnvState<float>& x, int B, int b, const StateOut& out, int g) {
  for (int k = g; k < NJ; k += G) {
    out.s[k * B + b] = x.s[k];
    out.sd[k * B + b] = x.sd[k];
  }
  for (int k = g; k < 3; k += G) out.p[k * B + b] = x.p[k];
  for (int k = g; k < 4; k += G) out.q[k * B + b] = x.q[k];
  for (int k = g; k < 6; k += G) out.v[k * B + b] = x.v[k];
  for (int k = g; k < NCM * 3; k += G) out.m[k * B + b] = x.m[k];
}
#endif

// The step's forms (above): the semi-implicit Euler step, and the rate of
// the state with the contact phase or with the contacts frozen.
constexpr int STEP_SIE = 0, STEP_RATE = 1, STEP_RATE_FROZEN = 2;

// One semi-implicit Euler step (Mode STEP_SIE) of one env on lane g of its
// group, from the state `x`: fills the slot `sl` (above); a writable state
// gets the new state, an EnvIn gives lane 0 the new base velocity in `vn`.
// With Mode STEP_RATE or STEP_RATE_FROZEN a writable state gets its rate.
// `tau(k)` gives joint k's torque. Every lane of the block calls it together.
template <int Mode = STEP_SIE, class In, class Tau>
__device__ void soft_step_lanes(const float* P, const Scalars& sc, Slot sl, int g, const In& x, Tau tau,
                                float* vn) {
  static_assert(Mode == STEP_SIE || (In::writes && FORWARD), "the rate form writes a slot's state");
  // ----- forward kinematics, with pass 1's body velocities -----
  if (g == 0) {
    const float q[4] = {x.q[0], x.q[1], x.q[2], x.q[3]};
    float RB[9], Rs[9], ps[3], WR[9], t[3], Wv[6], v0[6];
    quat_rot(q, RB);
    h_rot(P + OFF_SUCH, Rs);
    h_pos(P + OFF_SUCH, ps);
    mm3(RB, Rs, WR);
    mv3(RB, ps, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = x.p[k] + t[k];
    sl.st(LK_WR, 9, WR);
    sl.st(LK_WP, 3, t);
#pragma unroll
    for (int k = 0; k < 6; ++k) Wv[k] = FLOATING ? x.v[k] : 0.0f;
    sl.st(LK_WV, 6, Wv);
    if (FLOATING) {
      float R0i[9], p0i[3];
      base_inverse(sl, R0i, p0i);
      xv(R0i, p0i, Wv, v0);
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k) v0[k] = 0.0f;
    }
    sl.st(LK_V, 6, v0);
  }
  ln_sync();
#pragma unroll 1
  for (int lev = 0; lev < NLEV; ++lev) {
#pragma unroll 1
    for (int n = JX_LN_LEV_OFF[lev] + g; n < JX_LN_LEV_OFF[lev + 1]; n += G) {
      const int i = JX_LN_LEV_LINK[n], lam = JX_LAM[i];
      float rR[9], rp[3], t[3], WRl[9], Wpl[3], Wvl[6], WR[9], Wp[3], iR[9], ip[3];
      relative_transform(P, i, x.s[i - 1], rR, rp);
      sl.ld(lam * LK + LK_WR, 9, WRl);
      sl.ld(lam * LK + LK_WP, 3, Wpl);
      sl.ld(lam * LK + LK_WV, 6, Wvl);
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
      sl.st(i * LK + LK_WR, 9, WR);
      sl.st(i * LK + LK_WP, 3, Wp);
      sl.st(i * LK + LK_IR, 9, iR);
      sl.st(i * LK + LK_IP, 3, ip);
      sl.st(i * LK + LK_WV, 6, Wv);
      // v = X v_lam + vJ
      float vl[6], v[6];
      sl.ld(lam * LK + LK_V, 6, vl);
      xv(iR, ip, vl, v);
#pragma unroll
      for (int k = 0; k < 6; ++k) v[k] += S[k] * sdi;
      sl.st(i * LK + LK_V, 6, v);
    }
    ln_sync();
  }

  // ----- soft contacts: the parents' wrenches, m's update -----
  if constexpr (Mode != STEP_RATE_FROZEN) {
    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int k = 0; k < OWN; ++k) {
      const int c = JX_LN_SLOT_POINT[g + G * k], par = JX_LN_GROUP_LINK[k];
      float w6[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (c >= 0) {
        float R[9], Wp[3], Wv[6], pc[3], pd[3];
        parent_pose(sl, par, true, R, Wp, Wv);
        point_kinematics(P, c, R, Wp, Wv, pc, pd);
        const float mc[3] = {x.m[c * 3], x.m[c * 3 + 1], x.m[c * 3 + 2]};
        const HcLaw h = hc_law(sc, pc, pd, mc);
        if constexpr (Mode != STEP_SIE) {
#pragma unroll
          for (int j = 0; j < 3; ++j) x.m[c * 3 + j] = h.md[j];
        } else if constexpr (In::writes) {
#pragma unroll
          for (int j = 0; j < 3; ++j) x.m[c * 3 + j] = mc[j] + sc.dt * h.md[j];
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) w6[j] = h.f_lin[j];
        cross3(pc, h.f_lin, w6 + 3);
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) acc[j] += lanes_sum(w6[j]);
      if (k == OWN - 1 || JX_LN_GROUP_LINK[k + 1] != par) {
        if (g == 0) {
          const int o = SL_PAR + JX_LN_GROUP_PAR[k] * PR;
          sl.st(o + PR_F, 6, acc);
#if !JX_LN_FORWARD
          float Wv[6];
          sl.ld(par * LK + LK_T, 6, Wv);
          sl.st(o + PR_WV, 6, Wv);
#endif
        }
        // The next parent's points start a sum of their own.
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[j] = 0.0f;
      }
    }
    ln_sync();
  }

  // ----- ABA pass 2 with pass 1's bias forces, leaves to root -----
#pragma unroll 1
  for (int lev = NLEV - 1; lev >= -1; --lev) {
    const int n0 = lev < 0 ? 0 : JX_LN_LEV_OFF[lev] + g, n1 = lev < 0 ? (g == 0 ? 1 : 0) : JX_LN_LEV_OFF[lev + 1];
#pragma unroll 1
    for (int n = n0; n < n1; n += G) {
      const int i = lev < 0 ? 0 : JX_LN_LEV_LINK[n];
      const float* Mi = P + OFF_M + i * 36;
      float v[6], MA[36], pA[6];
      sl.ld(i * LK + LK_V, 6, v);
      vxstar_Mv(v, Mi, pA);
      if (JX_HASF[i]) {
        float R[9], Wp[3], f[6], t[6];
        sl.ld(i * LK + LK_WR, 9, R);
        sl.ld(i * LK + LK_WP, 3, Wp);
        sl.ld(SL_PAR + JX_LN_PAR_ROW[i] * PR + PR_F, 6, f);
        xtf(R, Wp, f, t);
#pragma unroll
        for (int k = 0; k < 6; ++k) pA[k] -= t[k];
      }
#pragma unroll
      for (int k = 0; k < 36; ++k) MA[k] = Mi[k];
      if (i != 0 || FLOATING) {
#pragma unroll 1
        for (int h = JX_LN_CH_OFF[i]; h < JX_LN_CH_OFF[i + 1]; ++h) {
          const Slot ch{sl.base + JX_LN_CH[h] * LK * ES};
#pragma unroll
          for (int r = 0; r < 6; ++r)
#pragma unroll
            for (int cc = 0; cc < 6; ++cc) MA[r * 6 + cc] += ch[LK_T + tri(r, cc)];
#pragma unroll
          for (int k = 0; k < 6; ++k) pA[k] += ch[LK_T + T_PA + k];
        }
      }
      const int lam = JX_LAM[i];
#if JX_LN_FORWARD
      if (i == 0) {
        sl.st(SL_BASE + BS_MA0, 36, MA);
        sl.st(SL_BASE + BS_PA0, 6, pA);
        continue;
      }
#else
      sl.st(i * LK + LK_MA, 36, MA);
      sl.st(i * LK + LK_PA, 6, pA);
      if (i == 0 || (lam == 0 && !FLOATING)) continue;
#endif
      const float* S = P + OFF_S + i * 6;
      float U[6], d, u, c[6];
      link_udu(MA, pA, S, tau(i - 1), U, d, u);
#if JX_LN_FORWARD
      sl.st(i * LK + LK_UDU, 6, U);
      sl[i * LK + LK_UDU + 6] = d;
      sl[i * LK + LK_UDU + 7] = u;
      if (lam == 0 && !FLOATING) continue;
#endif
      joint_bias(S, x.sd[i - 1], v, c);
      const float inv_d = 1.0f / d;
      float Ma[36], pa[6], t[6];
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) Ma[r * 6 + cc] = MA[r * 6 + cc] - U[r] * U[cc] * inv_d;
      mv6(Ma, c, t);
      const float ud = u * inv_d;
#pragma unroll
      for (int k = 0; k < 6; ++k) pa[k] = pA[k] + t[k] + U[k] * ud;
      float iR[9], ip[3], X[36], MaX[36];
      link_pair(P, sl, i, x.s[i - 1], iR, ip);
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
          sl[i * LK + LK_T + tri(r, cc)] = acc;
        }
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) acc += X[k * 6 + r] * pa[k];
        sl[i * LK + LK_T + T_PA + r] = acc;
      }
    }
    ln_sync();
  }

  // ----- ABA pass 3 (accelerations), root to leaves -----
  const float dt = sc.dt;
  if (g == 0) {
    float a0[6];
    if (FLOATING) {
      float MA[36], pA[6], xs[6];
#if JX_LN_FORWARD
      sl.ld(SL_BASE + BS_MA0, 36, MA);
      sl.ld(SL_BASE + BS_PA0, 6, pA);
#else
      sl.ld(LK_MA, 36, MA);
      sl.ld(LK_PA, 6, pA);
#endif
      chol6_solve(MA, pA, xs);
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
    sl.st(LK_A, 6, a0);
  }
  ln_sync();
#pragma unroll 1
  for (int lev = 0; lev < NLEV; ++lev) {
#pragma unroll 1
    for (int n = JX_LN_LEV_OFF[lev] + g; n < JX_LN_LEV_OFF[lev + 1]; n += G) {
      const int i = JX_LN_LEV_LINK[n], lam = JX_LAM[i];
      const float* S = P + OFF_S + i * 6;
      float U[6], d, u, v[6], c[6], iR[9], ip[3], al[6], a_i[6];
#if JX_LN_FORWARD
      sl.ld(i * LK + LK_UDU, 6, U);
      d = sl[i * LK + LK_UDU + 6];
      u = sl[i * LK + LK_UDU + 7];
#else
      float MA[36], pA[6];
      sl.ld(i * LK + LK_MA, 36, MA);
      sl.ld(i * LK + LK_PA, 6, pA);
      link_udu(MA, pA, S, tau(i - 1), U, d, u);
#endif
      sl.ld(i * LK + LK_V, 6, v);
      const float sdi = x.sd[i - 1];
      joint_bias(S, sdi, v, c);
      link_pair(P, sl, i, x.s[i - 1], iR, ip);
      sl.ld(lam * LK + LK_A, 6, al);
      xv(iR, ip, al, a_i);
      float ua = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        a_i[k] += c[k];
        ua += U[k] * a_i[k];
      }
      const float sddi = (u - ua) / d;
#pragma unroll
      for (int k = 0; k < 6; ++k) a_i[k] += S[k] * sddi;
      sl.st(i * LK + LK_A, 6, a_i);
      if constexpr (Mode != STEP_SIE) {
        x.s[i - 1] = sdi;
        x.sd[i - 1] = sddi;
      } else if constexpr (In::writes) {
        const float sdn = sdi + dt * sddi;
        x.sd[i - 1] = sdn;
        x.s[i - 1] = x.s[i - 1] + dt * sdn;
      }
    }
    ln_sync();
  }

  // ----- the base's semi-implicit Euler (its rates in the rate form) -----
  if (g == 0) {
    float W_a[6];
    if (FLOATING) {
      float R0[9], p0[3], a0[6];
      sl.ld(LK_WR, 9, R0);
      sl.ld(LK_WP, 3, p0);
      sl.ld(LK_A, 6, a0);
      xv(R0, p0, a0, W_a);
      W_a[2] += sc.gz;
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k) W_a[k] = 0.0f;
    }
    if constexpr (Mode != STEP_SIE) {
      // p' = v + w x p, q' with the Baumgarte term, v' = W_a, all at the
      // stage's v.
      const float p[3] = {x.p[0], x.p[1], x.p[2]}, q[4] = {x.q[0], x.q[1], x.q[2], x.q[3]};
      const float v6[6] = {x.v[0], x.v[1], x.v[2], x.v[3], x.v[4], x.v[5]};
      float wp[3], qd[4];
      cross3(v6 + 3, p, wp);
      quat_rate(q, v6 + 3, qd);
#pragma unroll
      for (int k = 0; k < 3; ++k) x.p[k] = v6[k] + wp[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) x.q[k] = qd[k];
#pragma unroll
      for (int k = 0; k < 6; ++k) x.v[k] = W_a[k];
      return;
    }
    float vnew[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) vnew[k] = x.v[k] + dt * W_a[k];
    if constexpr (In::writes) {
      // The position update uses the NEW linear velocity and the OLD p.
      const float p[3] = {x.p[0], x.p[1], x.p[2]};
      float wp[3];
      cross3(vnew + 3, p, wp);
#pragma unroll
      for (int k = 0; k < 3; ++k) x.p[k] = p[k] + dt * (vnew[k] + wp[k]);
      const float ox = vnew[3], oy = vnew[4], oz = vnew[5];
      const float qw = x.q[0], qx = x.q[1], qy = x.q[2], qz = x.q[3];
      const float qn[4] = {qw + dt * (0.5f * (-qx * ox - qy * oy - qz * oz)),
                           qx + dt * (0.5f * (qw * ox - qy * oz + qz * oy)),
                           qy + dt * (0.5f * (qw * oy + qx * oz - qz * ox)),
                           qz + dt * (0.5f * (qw * oz - qx * oy + qy * ox))};
      const float nq = sqrtf(fmaxf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3], 1e-12f));
#pragma unroll
      for (int k = 0; k < 4; ++k) x.q[k] = qn[k] / nq;
#pragma unroll
      for (int k = 0; k < 6; ++k) x.v[k] = vnew[k];
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k) vn[k] = vnew[k];
    }
  }
}

}  // namespace
