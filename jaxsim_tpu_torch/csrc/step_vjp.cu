// The fused backward of one engine step (K4): one CUDA thread per env.
//
// Replaces _step_vjp_kernel of jaxsim_tpu/ops/pallas_step.py (built by
// build_pallas_step_vjp), which traces jax.vjp of the engine step inside the
// kernel. Here the transposed step is written by hand, from the math: for a
// state, torques tau and a cotangent of the output state, one launch
//  1. recomputes the step with step_env (step_env.cuh), the code K3 runs, on
//     a copy of the input state, so the linearization point is K3's to the
//     bit; its Work then holds the world poses and velocities, the inverse
//     joint transforms and ABA's per-link v, c, pA, MA, a, U, d and u;
//  2. sweeps the transposed step, stage by stage from the last forward block
//     to the first, each stage the transpose of a block of step_env (SIE,
//     ABA pass 3 with the base Cholesky, pass 2, pass 1, the contacts, the
//     kinematics), accumulating adjoints in a second Work. Per-point contact
//     quantities and each joint's transform are recomputed, not stored.
// Derivatives at a tie of max/min are JAX's: half to each side. A branch
// the forward did not take (no contact, sticking, slipping) passes nothing.
//
// With JX_PARAMS_GRAD (a build-time define, in the generated header) the
// kernel also accumulates each thread's cotangents of the model arrays, in
// the packed layout, sums them across the warp with shuffles and writes one
// partial a block; param_sum_kernel adds the partials in a fixed order. No
// float atomics: two runs agree to the bit.
//
// What bounds it on the card: as K3, per-thread latency, now of a forward and
// a reverse sweep of about twice its operations, with two Work structs
// (about 20 kB for the humanoid) and, with params_grad, 1,989 accumulators in
// local memory. The state, tau and cotangents cross device memory once each
// way (about 33 MB for the humanoid at 8192 envs, 10 us at 3.35 TB/s). The
// design is K3's: the model arrays in shared memory, the batch trailing so
// loads and stores coalesce, the state as per-leaf arrays.

#include "step_env.cuh"

#ifndef JX_PARAMS_GRAD
#define JX_PARAMS_GRAD 0
#endif

namespace {

constexpr bool PARAMS_GRAD = JX_PARAMS_GRAD != 0;

// A pointer into the model-array cotangents, or nullptr without params_grad
// (every use below then compiles away).
__device__ __forceinline__ float* pg(float* gP, int off) { return PARAMS_GRAD ? gP + off : nullptr; }

__device__ __forceinline__ void add3(float* a, const float* b) {
#pragma unroll
  for (int k = 0; k < 3; ++k) a[k] += b[k];
}

// ----- transposes of the small algebra; b* are adjoints, accumulated -----

// c = a x b: ba += b x bc, bb += bc x a.
__device__ __forceinline__ void cross3_vjp(const float* a, const float* b, const float* bc, float* ba,
                                           float* bb) {
  float t[3];
  if (ba) {
    cross3(b, bc, t);
    add3(ba, t);
  }
  if (bb) {
    cross3(bc, a, t);
    add3(bb, t);
  }
}

// o = A v (3x3, A with row stride `ld`): bA += bo v^T, bv += A^T bo.
__device__ __forceinline__ void mv3_vjp(const float* A, const float* v, const float* bo, float* bA,
                                        float* bv, int ld = 3) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (bA) bA[i * ld + j] += bo[i] * v[j];
      if (bv) bv[j] += A[i * 3 + j] * bo[i];
    }
}

// o = A^T v (3x3): bA += v bo^T, bv += A bo.
__device__ __forceinline__ void mtv3_vjp(const float* A, const float* v, const float* bo, float* bA,
                                         float* bv) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (bA) bA[k * 3 + i] += v[k] * bo[i];
      if (bv) bv[k] += A[k * 3 + i] * bo[i];
    }
}

// C = A B (3x3; bA with row stride `lda`): bA += bC B^T, bB += A^T bC.
__device__ __forceinline__ void mm3_vjp(const float* A, const float* B, const float* bC, float* bA,
                                        float* bB, int lda = 3) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (bA) bA[i * lda + k] += bC[i * 3 + j] * B[k * 3 + j];
        if (bB) bB[k * 3 + j] += A[i * 3 + k] * bC[i * 3 + j];
      }
}

// o = M v (6x6): bM += bo v^T, bv += M^T bo.
__device__ __forceinline__ void mv6_vjp(const float* M, const float* v, const float* bo, float* bM,
                                        float* bv) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (bM) bM[i * 6 + j] += bo[i] * v[j];
      if (bv) bv[j] += M[i * 6 + j] * bo[i];
    }
}

// xv: o = [R v_l + p x (R v_a) ; R v_a].
__device__ __forceinline__ void xv_vjp(const float* R, const float* p, const float* v, const float* bo,
                                       float* bR, float* bp, float* bv) {
  float Ra[3], bRa[3] = {bo[3], bo[4], bo[5]};
  mv3(R, v + 3, Ra);
  cross3_vjp(p, Ra, bo, bp, bRa);
  mv3_vjp(R, v, bo, bR, bv);
  mv3_vjp(R, v + 3, bRa, bR, bv ? bv + 3 : nullptr);
}

// xtf: o = [R^T f_l ; R^T (f_a - p x f_l)].
__device__ __forceinline__ void xtf_vjp(const float* R, const float* p, const float* f, const float* bo,
                                        float* bR, float* bp, float* bf) {
  float c[3], t[3], bt[3] = {0.0f, 0.0f, 0.0f};
  cross3(p, f, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = f[k + 3] - c[k];
  mtv3_vjp(R, f, bo, bR, bf);
  mtv3_vjp(R, t, bo + 3, bR, bt);
  add3(bf + 3, bt);
  const float bc[3] = {-bt[0], -bt[1], -bt[2]};
  cross3_vjp(p, f, bc, bp, bf);
}

// vx: o = [w_a x u_l + v_l x u_a ; w_a x u_a] for v = (v_l, w_a), u = (u_l, u_a).
__device__ __forceinline__ void vx_vjp(const float* v, const float* u, const float* bo, float* bv,
                                       float* bu) {
  cross3_vjp(v + 3, u, bo, bv + 3, bu);
  cross3_vjp(v, u + 3, bo, bv, bu + 3);
  cross3_vjp(v + 3, u + 3, bo + 3, bv + 3, bu + 3);
}

// vxstar_Mv: f = M v, o = [w x f_l ; v_l x f_l + w x f_a].
__device__ __forceinline__ void vxstar_Mv_vjp(const float* v, const float* M, const float* bo, float* bv,
                                              float* bM) {
  float f[6], bf[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  mv6(M, v, f);
  cross3_vjp(v + 3, f, bo, bv + 3, bf);
  cross3_vjp(v, f, bo + 3, bv, bf);
  cross3_vjp(v + 3, f + 3, bo + 3, bv + 3, bf + 3);
  mv6_vjp(M, v, bf, bM, bv);
}

// X = [[R, p^ R],[0, R]] (build_X): adjoints of R and p from bX.
__device__ __forceinline__ void build_X_vjp(const float* R, const float* p, const float* bX, float* bR,
                                            float* bp) {
  const float px[9] = {0.0f, -p[2], p[1], p[2], 0.0f, -p[0], -p[1], p[0], 0.0f};
  float bpR[9], bpx[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      bR[i * 3 + j] += bX[i * 6 + j] + bX[(i + 3) * 6 + j + 3];
      bpR[i * 3 + j] = bX[i * 6 + j + 3];
    }
  mm3_vjp(px, R, bpR, bpx, bR);
  bp[0] += bpx[7] - bpx[5];
  bp[1] += bpx[2] - bpx[6];
  bp[2] += bpx[3] - bpx[1];
}

// Adds the adjoint of the skew matrix of a 3-vector to that vector's.
__device__ __forceinline__ void skew_vjp(const float* bK, float* ba) {
  ba[0] += bK[7] - bK[5];
  ba[1] += bK[2] - bK[6];
  ba[2] += bK[3] - bK[1];
}

// d/dx of max(x, floor) (or of min(floor, x) with the signs swapped): 1 on
// x's side, 0 on the other, one half at a tie, as JAX differentiates.
__device__ __forceinline__ float max_grad(float x, float floor) {
  return x > floor ? 1.0f : (x == floor ? 0.5f : 0.0f);
}

// Transpose of relative_transform(P, j, th): from the adjoints of the
// parent -> child pair (R, p) to th's (returned) and, with params_grad, to
// lamH[j], sucH[j] and axis[j - 1].
__device__ float relative_transform_vjp(const float* P, int j, float th, const float* bR, const float* bp,
                                        float* gP) {
  const float* lamH = P + OFF_LAMH + j * 16;
  const float* sucH = P + OFF_SUCH + j * 16;
  float Rj[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float pj[3] = {0.0f, 0.0f, 0.0f};
  float K[9], K2[9], sn = 0.0f, omc = 0.0f;
  const int jt = JX_JTYPE[j];
  const float* a = P + OFF_AXIS + (j - 1) * 3;
  if (jt == 1) {
    const float Kv[9] = {0.0f, -a[2], a[1], a[2], 0.0f, -a[0], -a[1], a[0], 0.0f};
#pragma unroll
    for (int k = 0; k < 9; ++k) K[k] = Kv[k];
    mm3(K, K, K2);
    sn = sinf(th);
    omc = 1.0f - cosf(th);
#pragma unroll
    for (int k = 0; k < 9; ++k) Rj[k] = Rj[k] + sn * K[k] + omc * K2[k];
  } else if (jt == 2) {
#pragma unroll
    for (int k = 0; k < 3; ++k) pj[k] = a[k] * th;
  }
  float R1[9], p1[3], R2[9], p2[3], Ra[9];
  h_rot(lamH, R1);
  h_pos(lamH, p1);
  h_rot(sucH, R2);
  h_pos(sucH, p2);
  mm3(R1, Rj, Ra);

  // R = Ra R2, p = pa + Ra p2, pa = p1 + R1 pj.
  float bRa[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  mm3_vjp(Ra, R2, bR, bRa, nullptr);
  mv3_vjp(Ra, p2, bp, bRa, nullptr);
  if (PARAMS_GRAD) {
    float bR2[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float bp2[3] = {0.0f, 0.0f, 0.0f};
    mm3_vjp(Ra, R2, bR, nullptr, bR2);
    mv3_vjp(Ra, p2, bp, nullptr, bp2);
    float* gs = gP + OFF_SUCH + j * 16;
    float* gl = gP + OFF_LAMH + j * 16;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) gs[r * 4 + c] += bR2[r * 3 + c];
      gs[r * 4 + 3] += bp2[r];
      gl[r * 4 + 3] += bp[r];  // p1
    }
    // Ra = R1 Rj, and R1 pj in pa.
    mm3_vjp(R1, Rj, bRa, gl, nullptr, 4);
    mv3_vjp(R1, pj, bp, gl, nullptr, 4);
  }
  float bRj[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float bpj[3] = {0.0f, 0.0f, 0.0f};
  mm3_vjp(R1, Rj, bRa, nullptr, bRj);
  mv3_vjp(R1, pj, bp, nullptr, bpj);

  float bth = 0.0f;
  if (jt == 1) {  // Rj = I + sin(th) K + (1 - cos(th)) K K
    float bsn = 0.0f, bomc = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      bsn += bRj[k] * K[k];
      bomc += bRj[k] * K2[k];
    }
    bth = bsn * cosf(th) + bomc * sinf(th);
    if (PARAMS_GRAD) {
      float bK[9], bK2[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        bK[k] = sn * bRj[k];
        bK2[k] = omc * bRj[k];
      }
      mm3_vjp(K, K, bK2, bK, bK);
      skew_vjp(bK, gP + OFF_AXIS + (j - 1) * 3);
    }
  } else if (jt == 2) {  // pj = axis th
#pragma unroll
    for (int k = 0; k < 3; ++k) bth += a[k] * bpj[k];
    if (PARAMS_GRAD) {
#pragma unroll
      for (int k = 0; k < 3; ++k) gP[OFF_AXIS + (j - 1) * 3 + k] += th * bpj[k];
    }
  }
  return bth;
}

// The transposed step. In: the model arrays P, the input state (s, sd, p,
// q, v, m), the torques, the forward's Work `w` and new velocity `vn`, and
// the cotangents of the output state (cs, csd, cp, cq, cv, cm). Out: the
// cotangents of the input state (bs, bsd, bp, bq, bv, bm) and of the torques
// (btau), and with params_grad the model arrays' added into gP. `g` is the
// adjoint Work, zeroed by the caller.
__device__ void step_env_vjp(const float* P, const Scalars& sc, const Work& w, Work& g, const float* s,
                             const float* sd, const float* p, const float* q, const float* v,
                             const float* m, const float* tau, const float* vn, const float* cs,
                             const float* csd, const float* cp, const float* cq, const float* cv,
                             const float* cm, float* bs, float* bsd, float* bp, float* bq, float* bv,
                             float* bm, float* btau, float* gP) {
  const float dt = sc.dt;
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
  float bR0i[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float bp0i[3] = {0.0f, 0.0f, 0.0f};
  const float g6[6] = {0.0f, 0.0f, sc.gz, 0.0f, 0.0f, 0.0f};

  // ----- 1. semi-implicit Euler, with the quaternion renormalization -----
  float bsdd[NJA];
#pragma unroll 1
  for (int k = 0; k < NJ; ++k) {
    bs[k] = cs[k];  // s' = s + dt sd'
    const float bsdn = csd[k] + dt * cs[k];
    bsd[k] = bsdn;  // sd' = sd + dt sdd
    bsdd[k] = dt * bsdn;
  }
  float bvn[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) bvn[k] = cv[k];
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
    float dot = 0.0f, bqn[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
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
      bp[k] = cp[k];
      dcp[k] = dt * cp[k];
      bvn[k] += dcp[k];
    }
    cross3_vjp(vn + 3, p, dcp, bvn + 3, bp);
  }
  float bWa[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    bv[k] = bvn[k];  // v' = v + dt W_a
    bWa[k] = dt * bvn[k];
  }

  // ----- 2. ABA pass 3 (accelerations) -----
  if (FLOATING) xv_vjp(R0, p0, w.a[0], bWa, g.WR[0], g.Wp[0], g.a[0]);  // W_a = X0 a0 + g
#pragma unroll 1
  for (int i = NL - 1; i > 0; --i) {
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
    // a[i] = a_i + S sdd
    float ba[6], bsddi = bsdd[i - 1];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      ba[k] = g.a[i][k];
      bsddi += S[k] * g.a[i][k];
    }
    if (PARAMS_GRAD) {
#pragma unroll
      for (int k = 0; k < 6; ++k) gP[OFF_S + i * 6 + k] += sddi * g.a[i][k];
    }
    // sdd = (u - U.a_i) / d
    const float bua = -bsddi / w.d[i];
    g.u[i] += bsddi / w.d[i];
    g.d[i] += -bsddi * sddi / w.d[i];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      g.U[i][k] += bua * a_i[k];
      ba[k] += bua * w.U[i][k];
      g.c[i][k] += ba[k];
    }
    xv_vjp(w.iR[i], w.ip[i], w.a[lam], ba, g.iR[i], g.ip[i], g.a[lam]);
  }
  if (FLOATING) {
    // a0 = -x, x = MA0^-1 pA0 through the Cholesky of MA0's lower triangle.
    float bx[6], y[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) bx[k] = -g.a[0][k];
    chol6_solve(w.MA[0], bx, y);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      g.pA[0][i] += y[i];
      const float xi = -w.a[0][i];
      g.MA[0][i * 6 + i] += -y[i] * xi;
#pragma unroll
      for (int j = 0; j < i; ++j) g.MA[0][i * 6 + j] += -(y[i] * -w.a[0][j] + y[j] * xi);
    }
  } else {
    const float ba0[6] = {-g.a[0][0], -g.a[0][1], -g.a[0][2], -g.a[0][3], -g.a[0][4], -g.a[0][5]};
    xv_vjp(R0i, p0i, g6, ba0, bR0i, bp0i, nullptr);  // a0 = -X0^-1 g
  }

  // ----- 3. ABA pass 2 (articulated inertias), root to leaves -----
#pragma unroll 1
  for (int i = 1; i < NL; ++i) {
    const int lam = JX_LAM[i];
    const float* S = P + OFF_S + i * 6;
    const float* U = w.U[i];
    const float inv_d = 1.0f / w.d[i];
    const float ud = w.u[i] * inv_d;
    float Ma[36], pa[6], t[6];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int cc = 0; cc < 6; ++cc) Ma[r * 6 + cc] = w.MA[i][r * 6 + cc] - U[r] * U[cc] * inv_d;
    mv6(Ma, w.c[i], t);
#pragma unroll
    for (int k = 0; k < 6; ++k) pa[k] = w.pA[i][k] + t[k] + U[k] * ud;

    float bMa[36], bpa[6];
#pragma unroll
    for (int k = 0; k < 36; ++k) bMa[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) bpa[k] = 0.0f;
    if (lam != 0 || FLOATING) {
      // MA_lam += X^T Ma X, pA_lam += X^T pa.
      float X[36], XbO[36], XbOt[36], bX[36];
      build_X(w.iR[i], w.ip[i], X);
      const float* bO = g.MA[lam];
#pragma unroll 1
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) {
          float acc = 0.0f, acct = 0.0f;
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            acc += X[r * 6 + k] * bO[k * 6 + cc];
            acct += X[r * 6 + k] * bO[cc * 6 + k];
          }
          XbO[r * 6 + cc] = acc;
          XbOt[r * 6 + cc] = acct;
        }
      // bMa = X bO X^T = XbO X^T
#pragma unroll 1
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < 6; ++k) acc += XbO[r * 6 + k] * X[cc * 6 + k];
          bMa[r * 6 + cc] += acc;
        }
      // bX = Ma X bO^T + Ma^T X bO + pa bpO^T
#pragma unroll 1
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) {
          float acc = pa[r] * g.pA[lam][cc];
#pragma unroll
          for (int k = 0; k < 6; ++k) acc += Ma[r * 6 + k] * XbOt[k * 6 + cc] + Ma[k * 6 + r] * XbO[k * 6 + cc];
          bX[r * 6 + cc] = acc;
        }
      // bpa = X bpO
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) acc += X[r * 6 + k] * g.pA[lam][k];
        bpa[r] += acc;
      }
      build_X_vjp(w.iR[i], w.ip[i], bX, g.iR[i], g.ip[i]);
    }
    // pa = pA + Ma c + U ud
    float bU[6], bud = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      g.pA[i][k] += bpa[k];
      bU[k] = g.U[i][k] + ud * bpa[k];
      bud += U[k] * bpa[k];
    }
    mv6_vjp(Ma, w.c[i], bpa, bMa, g.c[i]);
    float bu = g.u[i] + inv_d * bud;
    float binv_d = w.u[i] * bud;
    // Ma = MA - U U^T inv_d
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int cc = 0; cc < 6; ++cc) {
        const float b = bMa[r * 6 + cc];
        g.MA[i][r * 6 + cc] += b;
        bU[r] -= b * U[cc] * inv_d;
        bU[cc] -= b * U[r] * inv_d;
        binv_d -= b * U[r] * U[cc];
      }
    // inv_d = 1 / d, u = tau - S.pA, d = S.U, U = MA S
    const float bdd = g.d[i] - binv_d * inv_d * inv_d;
    btau[i - 1] = bu;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      g.pA[i][k] += -bu * S[k];
      bU[k] += bdd * S[k];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int cc = 0; cc < 6; ++cc) g.MA[i][r * 6 + cc] += bU[r] * S[cc];
    if (PARAMS_GRAD) {
      float* gS = gP + OFF_S + i * 6;
#pragma unroll
      for (int k = 0; k < 6; ++k) gS[k] += -bu * w.pA[i][k] + bdd * U[k];
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) gS[cc] += w.MA[i][r * 6 + cc] * bU[r];
    }
  }

  // ----- 4. ABA pass 1 (velocities, bias forces), leaves to root -----
#pragma unroll 1
  for (int i = NL - 1; i >= 0; --i) {
    const float* Mi = P + OFF_M + i * 36;
    if (JX_HASF[i]) {  // pA -= X^T f
      const float nb[6] = {-g.pA[i][0], -g.pA[i][1], -g.pA[i][2], -g.pA[i][3], -g.pA[i][4], -g.pA[i][5]};
      xtf_vjp(w.WR[i], w.Wp[i], w.f[i], nb, g.WR[i], g.Wp[i], g.f[i]);
    }
    vxstar_Mv_vjp(w.v[i], Mi, g.pA[i], g.v[i], pg(gP, OFF_M + i * 36));
    if (PARAMS_GRAD) {
#pragma unroll
      for (int k = 0; k < 36; ++k) gP[OFF_M + i * 36 + k] += g.MA[i][k];  // MA = M
    }
    if (i == 0) break;
    const int lam = JX_LAM[i];
    const float* S = P + OFF_S + i * 6;
    const float sdi = sd[i - 1];
    float vJ[6], bvJ[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 6; ++k) vJ[k] = S[k] * sdi;
    vx_vjp(w.v[i], vJ, g.c[i], g.v[i], bvJ);  // c = v x vJ
#pragma unroll
    for (int k = 0; k < 6; ++k) bvJ[k] += g.v[i][k];
    xv_vjp(w.iR[i], w.ip[i], w.v[lam], g.v[i], g.iR[i], g.ip[i], g.v[lam]);  // v = X v_lam + vJ
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      bsd[i - 1] += S[k] * bvJ[k];
      if (PARAMS_GRAD) gP[OFF_S + i * 6 + k] += sdi * bvJ[k];
    }
  }
  if (FLOATING) xv_vjp(R0i, p0i, v, g.v[0], bR0i, bp0i, bv);  // v0 = X0^-1 v
  {
    // R0i = R0^T, p0i = -R0i p0.
    const float nb[3] = {-bp0i[0], -bp0i[1], -bp0i[2]};
    mv3_vjp(R0i, p0, nb, bR0i, g.Wp[0]);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) g.WR[0][cc * 3 + r] += bR0i[r * 3 + cc];
  }

  // ----- 5. soft contacts: wrenches and m's rate, per point -----
  {
    constexpr float eps = FLT_EPSILON;
#pragma unroll 1
    for (int k = 0; k < NCM * 3; ++k) bm[k] = cm[k];
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

      const float* mc = m + ci * 3;
      const float delta = fmaxf(0.0f, -pc[2]);
      const float delta_dot = delta > 0.0f ? -pd[2] : 0.0f;
      const float dp = powf(delta + eps, sc.hc_p);
      const float dq = powf(delta + eps, sc.hc_q);
      const float Kdp = sc.K * dp, Ddq = sc.D * dq;
      const float arg = Kdp * delta + Ddq * delta_dot;
      const float fn = fmaxf(0.0f, arg);
      const float v_t[3] = {pd[0], pd[1], 0.0f};
      const float m_t[3] = {mc[0], mc[1], 0.0f};
      float f_t[3], f_s[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) f_t[k] = -(Kdp * m_t[k] + Ddq * v_t[k]);
      const float f_t_sq = f_t[0] * f_t[0] + f_t[1] * f_t[1] + f_t[2] * f_t[2];
      const bool no_contact = delta <= 0.0f;
      const float mu_fn = sc.mu * fn;
      const bool sticking = no_contact || f_t_sq <= mu_fn * mu_fn;
      float norm = 1.0f, mn = 0.0f, scale = 1.0f;
      if (!sticking) {
        norm = sqrtf(fmaxf(f_t_sq, eps * eps));
        mn = fminf(mu_fn, norm);
        scale = mn / norm;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) f_s[k] = no_contact ? 0.0f : f_t[k] * scale;
      const float f_lin[3] = {f_s[0], f_s[1], f_s[2] + fn};

      // m' = m + dt md; f[par] += [f_lin ; pc x f_lin].
      float bmd[3], bpc[3] = {0.0f, 0.0f, 0.0f}, bpd[3] = {0.0f, 0.0f, 0.0f};
      float bf_lin[3] = {g.f[par][0], g.f[par][1], g.f[par][2]};
#pragma unroll
      for (int k = 0; k < 3; ++k) bmd[k] = dt * cm[ci * 3 + k];
      cross3_vjp(pc, f_lin, g.f[par] + 3, bpc, bf_lin);
      float bfn = bf_lin[2];
      float bft[3] = {0.0f, 0.0f, 0.0f}, bv_t[3] = {0.0f, 0.0f, 0.0f}, bm_t[3] = {0.0f, 0.0f, 0.0f};
      float bKdp = 0.0f, bDdq = 0.0f;
      float* bmc = bm + ci * 3;
      if (no_contact) {  // md = -(K/D) m; f_t = 0
#pragma unroll
        for (int k = 0; k < 3; ++k) bmc[k] += -sc.k_over_d * bmd[k];
      } else if (sticking) {  // md = v_t - (K/D) m_n
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          bv_t[k] += bmd[k];
          bft[k] += bf_lin[k];
        }
        bmc[2] += -sc.k_over_d * bmd[2];
      } else {  // md = -(f_s + Kdp m_t) / Ddq, f_s = f_t min(mu fn, |f_t|) / |f_t|
        float bfs[3], bscale = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          bfs[k] = bf_lin[k] - bmd[k] / Ddq;
          bm_t[k] += -Kdp * bmd[k] / Ddq;
          bKdp += -m_t[k] * bmd[k] / Ddq;
          bDdq += (f_s[k] + Kdp * m_t[k]) * bmd[k] / (Ddq * Ddq);
          bft[k] += scale * bfs[k];
          bscale += f_t[k] * bfs[k];
        }
        const float bmn = bscale / norm;
        float bnorm = -bscale * mn / (norm * norm);
        const float bmu_fn = bmn * max_grad(norm, mu_fn);  // min(mu_fn, norm): mu_fn's side
        bnorm += bmn * max_grad(mu_fn, norm);
        bfn += sc.mu * bmu_fn;
        const float bsq = bnorm * (0.5f / norm) * max_grad(f_t_sq, eps * eps);
#pragma unroll
        for (int k = 0; k < 3; ++k) bft[k] += 2.0f * f_t[k] * bsq;
      }
      // f_t = -(Kdp m_t + Ddq v_t)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bKdp += -m_t[k] * bft[k];
        bm_t[k] += -Kdp * bft[k];
        bDdq += -v_t[k] * bft[k];
        bv_t[k] += -Ddq * bft[k];
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
      // pd = v_l + w x pc, pc = R Lp + p (of the parent link)
      add3(g.Wv[par], bpd);
      cross3_vjp(w.Wv[par] + 3, pc, bpd, g.Wv[par] + 3, bpc);
      add3(g.Wp[par], bpc);
      mv3_vjp(w.WR[par], Lp, bpc, g.WR[par], pg(gP, OFF_CP + ci * 3));
    }
  }

  // ----- 6. forward kinematics, leaves to root -----
#pragma unroll 1
  for (int i = NL - 1; i > 0; --i) {
    const int lam = JX_LAM[i];
    float rR[9], rp[3];
    relative_transform(P, i, s[i - 1], rR, rp);
    const float* S = P + OFF_S + i * 6;
    const float sdi = sd[i - 1];
    const float Sl[3] = {S[0] * sdi, S[1] * sdi, S[2] * sdi};
    const float Sa[3] = {S[3] * sdi, S[4] * sdi, S[5] * sdi};
    float RSa[3];
    mv3(w.WR[i], Sa, RSa);
    // Wv_i = Wv_lam + [R Sl + Wp_i x R Sa ; R Sa]
    float bRSa[3] = {g.Wv[i][3], g.Wv[i][4], g.Wv[i][5]};
    float bSl[3] = {0.0f, 0.0f, 0.0f}, bSa[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 6; ++k) g.Wv[lam][k] += g.Wv[i][k];
    cross3_vjp(w.Wp[i], RSa, g.Wv[i], g.Wp[i], bRSa);
    mv3_vjp(w.WR[i], Sa, bRSa, g.WR[i], bSa);
    mv3_vjp(w.WR[i], Sl, g.Wv[i], g.WR[i], bSl);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      bsd[i - 1] += S[k] * bSl[k] + S[k + 3] * bSa[k];
      if (PARAMS_GRAD) {
        gP[OFF_S + i * 6 + k] += sdi * bSl[k];
        gP[OFF_S + i * 6 + k + 3] += sdi * bSa[k];
      }
    }
    // iR = rR^T, ip = -iR rp
    float brR[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float brp[3] = {0.0f, 0.0f, 0.0f};
    {
      float biR[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) biR[k] = g.iR[i][k];
      const float nb[3] = {-g.ip[i][0], -g.ip[i][1], -g.ip[i][2]};
      mv3_vjp(w.iR[i], rp, nb, biR, brp);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) brR[cc * 3 + r] += biR[r * 3 + cc];
    }
    // Wp_i = Wp_lam + WR_lam rp, WR_i = WR_lam rR
    add3(g.Wp[lam], g.Wp[i]);
    mv3_vjp(w.WR[lam], rp, g.Wp[i], g.WR[lam], brp);
    mm3_vjp(w.WR[lam], rR, g.WR[i], g.WR[lam], brR);
    bs[i - 1] += relative_transform_vjp(P, i, s[i - 1], brR, brp, gP);
  }
  {
    // WR0 = RB R_suc0, Wp0 = p + RB p_suc0, Wv0 = v (floating base).
    const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
    const float n = qw * qw + qx * qx + qy * qy + qz * qz;
    const float nn = n == 0.0f ? 1.0f : n;
    const float s2 = 2.0f / nn;
    const float wx = s2 * qw * qx, wy = s2 * qw * qy, wz = s2 * qw * qz;
    const float xx = s2 * qx * qx, xy = s2 * qx * qy, xz = s2 * qx * qz;
    const float yy = s2 * qy * qy, yz = s2 * qy * qz, zz = s2 * qz * qz;
    const float RB[9] = {1.0f - (yy + zz), xy - wz, xz + wy,
                         xy + wz, 1.0f - (xx + zz), yz - wx,
                         xz - wy, yz + wx, 1.0f - (xx + yy)};
    float Rs[9], ps[3], bRB[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    h_rot(P + OFF_SUCH, Rs);
    h_pos(P + OFF_SUCH, ps);
    if (FLOATING) {
#pragma unroll
      for (int k = 0; k < 6; ++k) bv[k] += g.Wv[0][k];
    }
    add3(bp, g.Wp[0]);
    mm3_vjp(RB, Rs, g.WR[0], bRB, nullptr);
    mv3_vjp(RB, ps, g.Wp[0], bRB, nullptr);
    if (PARAMS_GRAD) {
      float bRs[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float bps[3] = {0.0f, 0.0f, 0.0f};
      mm3_vjp(RB, Rs, g.WR[0], nullptr, bRs);
      mv3_vjp(RB, ps, g.Wp[0], nullptr, bps);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) gP[OFF_SUCH + r * 4 + c] += bRs[r * 3 + c];
        gP[OFF_SUCH + r * 4 + 3] += bps[r];
      }
    }
    const float bxx = -(bRB[4] + bRB[8]), byy = -(bRB[0] + bRB[8]), bzz = -(bRB[0] + bRB[4]);
    const float bxy = bRB[1] + bRB[3], bxz = bRB[2] + bRB[6], byz = bRB[5] + bRB[7];
    const float bwx = bRB[7] - bRB[5], bwy = bRB[2] - bRB[6], bwz = bRB[3] - bRB[1];
    const float bs2 = bwx * qw * qx + bwy * qw * qy + bwz * qw * qz + bxx * qx * qx + bxy * qx * qy +
                      bxz * qx * qz + byy * qy * qy + byz * qy * qz + bzz * qz * qz;
    const float bn = n == 0.0f ? 0.0f : -bs2 * s2 / nn;
    bq[0] += s2 * (bwx * qx + bwy * qy + bwz * qz) + 2.0f * qw * bn;
    bq[1] += s2 * (bwx * qw + 2.0f * bxx * qx + bxy * qy + bxz * qz) + 2.0f * qx * bn;
    bq[2] += s2 * (bwy * qw + bxy * qx + 2.0f * byy * qy + byz * qz) + 2.0f * qy * bn;
    bq[3] += s2 * (bwz * qw + bxz * qx + byz * qy + 2.0f * bzz * qz) + 2.0f * qz * bn;
  }
}

__device__ __forceinline__ void zero_work(Work& g) {
  float* f = reinterpret_cast<float*>(&g);
#pragma unroll 1
  for (int k = 0; k < static_cast<int>(sizeof(Work) / sizeof(float)); ++k) f[k] = 0.0f;
}

// ----- kernels -----

__global__ void __launch_bounds__(BLOCK)
    step_vjp_kernel(const float* __restrict__ params, StateIn in, const float* __restrict__ tau_in,
                    StateIn ct, StateOut out, float* __restrict__ ct_tau, float* __restrict__ partials,
                    int B, Scalars sc) {
  __shared__ float P[N_PARAMS];
  load_params(params, P);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  float gPbuf[PARAMS_GRAD ? N_PARAMS : 1];
  float* gP = PARAMS_GRAD ? gPbuf : nullptr;
  if (PARAMS_GRAD) {
#pragma unroll 1
    for (int k = 0; k < N_PARAMS; ++k) gPbuf[k] = 0.0f;
  }
  if (b < B) {
    // The input state, and the copy step_env advances in place.
    float s[NJA], sd[NJA], p[3], q[4], v[6], m[NCM * 3], tau[NJA];
    float s1[NJA], sd1[NJA], p1[3], q1[4], v1[6], m1[NCM * 3];
    for (int k = 0; k < NJ; ++k) {
      s1[k] = s[k] = in.s[k * B + b];
      sd1[k] = sd[k] = in.sd[k * B + b];
      tau[k] = tau_in[k * B + b];
    }
    for (int k = 0; k < 3; ++k) p1[k] = p[k] = in.p[k * B + b];
    for (int k = 0; k < 4; ++k) q1[k] = q[k] = in.q[k * B + b];
    for (int k = 0; k < 6; ++k) v1[k] = v[k] = in.v[k * B + b];
    for (int k = 0; k < NCM * 3; ++k) m1[k] = m[k] = in.m[k * B + b];
    Work w;
    step_env(P, sc, w, s1, sd1, p1, q1, v1, m1, ArrayTau{tau});

    // The output cotangents, then the input cotangents in their place.
    float cs[NJA], csd[NJA], cp[3], cq[4], cv[6], cm[NCM * 3];
    for (int k = 0; k < NJ; ++k) {
      cs[k] = ct.s[k * B + b];
      csd[k] = ct.sd[k * B + b];
    }
    for (int k = 0; k < 3; ++k) cp[k] = ct.p[k * B + b];
    for (int k = 0; k < 4; ++k) cq[k] = ct.q[k * B + b];
    for (int k = 0; k < 6; ++k) cv[k] = ct.v[k * B + b];
    for (int k = 0; k < NCM * 3; ++k) cm[k] = ct.m[k * B + b];
    Work g;
    zero_work(g);
    float bs[NJA], bsd[NJA], bp[3], bq[4], bv[6], bm[NCM * 3], btau[NJA];
    step_env_vjp(P, sc, w, g, s, sd, p, q, v, m, tau, v1, cs, csd, cp, cq, cv, cm, bs, bsd, bp, bq, bv, bm,
                 btau, gP);
    for (int k = 0; k < NJ; ++k) {
      out.s[k * B + b] = bs[k];
      out.sd[k * B + b] = bsd[k];
      ct_tau[k * B + b] = btau[k];
    }
    for (int k = 0; k < 3; ++k) out.p[k * B + b] = bp[k];
    for (int k = 0; k < 4; ++k) out.q[k * B + b] = bq[k];
    for (int k = 0; k < 6; ++k) out.v[k * B + b] = bv[k];
    for (int k = 0; k < NCM * 3; ++k) out.m[k * B + b] = bm[k];
  }
  if (PARAMS_GRAD) {
    // This block's sum of the model-array cotangents: a shuffle tree over the
    // warp (threads past B add zeros), one partial row a block.
#pragma unroll 1
    for (int k = 0; k < N_PARAMS; ++k) {
      float x = gPbuf[k];
#pragma unroll
      for (int off = BLOCK / 2; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if (threadIdx.x == 0) partials[blockIdx.x * N_PARAMS + k] = x;
    }
  }
}

// out[k] = the sum over the blocks of partials[blk][k], in a fixed order: a
// warp takes SUM_PARAMS neighbouring entries, SUM_GROUP lanes each (lane l:
// entry l % SUM_PARAMS, blocks l / SUM_PARAMS + SUM_GROUP t), so a load of
// the warp reads SUM_GROUP rows of SUM_PARAMS neighbouring words. A lane adds
// its blocks into four accumulators by t % 4, then (a0 + a1) + (a2 + a3), and
// a fixed xor shuffle tree adds the group's lanes: no atomics, two runs agree
// to the bit. One warp a block: the humanoid's 1,989 entries make 498 blocks,
// more than the card's 132 SMs. Of 2, 4, 8 and 16 entries a warp, 4 was the
// fastest on an H100 (chip_probe.py param_sum).
constexpr int SUM_PARAMS = 4;
constexpr int SUM_GROUP = 32 / SUM_PARAMS;

__global__ void __launch_bounds__(32) param_sum_kernel(const float* __restrict__ partials, int n_blocks,
                                                       float* __restrict__ out) {
  const int k = blockIdx.x * SUM_PARAMS + threadIdx.x % SUM_PARAMS;
  int blk = threadIdx.x / SUM_PARAMS;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  if (k < N_PARAMS) {
    constexpr int S = SUM_GROUP;
    // Unrolled so that a lane's loads of the humanoid's 256 blocks are all
    // in flight before its first add.
#pragma unroll 16
    for (; blk + 3 * S < n_blocks; blk += 4 * S) {
      a0 += partials[blk * N_PARAMS + k];
      a1 += partials[(blk + S) * N_PARAMS + k];
      a2 += partials[(blk + 2 * S) * N_PARAMS + k];
      a3 += partials[(blk + 3 * S) * N_PARAMS + k];
    }
    if (blk < n_blocks) a0 += partials[blk * N_PARAMS + k];
    if (blk + S < n_blocks) a1 += partials[(blk + S) * N_PARAMS + k];
    if (blk + 2 * S < n_blocks) a2 += partials[(blk + 2 * S) * N_PARAMS + k];
  }
  float x = (a0 + a1) + (a2 + a3);
#pragma unroll
  for (int off = SUM_PARAMS; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if (threadIdx.x < SUM_PARAMS && k < N_PARAMS) out[k] = x;
}

}  // namespace

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
  const int blocks = (B + BLOCK - 1) / BLOCK;
  step_vjp_kernel<<<blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      params, StateIn{s, sd, p, q, v, m}, tau, StateIn{ct_s, ct_sd, ct_p, ct_q, ct_v, ct_m},
      StateOut{out_s, out_sd, out_p, out_q, out_v, out_m}, out_tau, partials, B, sc);
  return static_cast<int>(cudaGetLastError());
}

int jx_param_sum(const float* partials, int n_blocks, float* out, void* stream) {
  param_sum_kernel<<<(N_PARAMS + SUM_PARAMS - 1) / SUM_PARAMS, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n_blocks, out);
  return static_cast<int>(cudaGetLastError());
}

const char* jx_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
