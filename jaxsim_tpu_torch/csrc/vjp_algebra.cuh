// The transposes of the small algebra of step_env.cuh and of the joint
// transform, which the two step VJP kernels share: K4 (step_vjp.cu, soft
// contacts) and K4-rr (step_vjp_rr.cu, relaxed-rigid contacts). Adjoints (b*)
// are accumulated: each function adds to what its outputs hold. Derivatives
// at a tie of max/min are JAX's: half to each side.

#pragma once

#include "step_env.cuh"

namespace {

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
// lamH[j], sucH[j] and axis[j - 1] through `acc.add(offset, n, values)`.
template <bool ParamsGrad, class Acc>
__device__ float relative_transform_vjp(const float* P, int j, float th, const float* bR, const float* bp,
                                        const Acc& acc) {
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
  float R1[9], R2[9], p2[3], Ra[9];
  h_rot(lamH, R1);
  h_rot(sucH, R2);
  h_pos(sucH, p2);
  mm3(R1, Rj, Ra);

  // R = Ra R2, p = pa + Ra p2, pa = p1 + R1 pj.
  float bRa[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  mm3_vjp(Ra, R2, bR, bRa, nullptr);
  mv3_vjp(Ra, p2, bp, bRa, nullptr);
  if (ParamsGrad) {
    // sucH's and lamH's top three rows, four wide.
    float gs[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float gl[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float bR2[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float bp2[3] = {0.0f, 0.0f, 0.0f};
    mm3_vjp(Ra, R2, bR, nullptr, bR2);
    mv3_vjp(Ra, p2, bp, nullptr, bp2);
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
    acc.add(OFF_SUCH + j * 16, 12, gs);
    acc.add(OFF_LAMH + j * 16, 12, gl);
  }
  float bRj[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float bpj[3] = {0.0f, 0.0f, 0.0f};
  mm3_vjp(R1, Rj, bRa, nullptr, bRj);
  mv3_vjp(R1, pj, bp, nullptr, bpj);

  float bth = 0.0f;
  float gax[3] = {0.0f, 0.0f, 0.0f};
  if (jt == 1) {  // Rj = I + sin(th) K + (1 - cos(th)) K K
    float bsn = 0.0f, bomc = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      bsn += bRj[k] * K[k];
      bomc += bRj[k] * K2[k];
    }
    bth = bsn * cosf(th) + bomc * sinf(th);
    if (ParamsGrad) {
      float bK[9], bK2[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        bK[k] = sn * bRj[k];
        bK2[k] = omc * bRj[k];
      }
      mm3_vjp(K, K, bK2, bK, bK);
      skew_vjp(bK, gax);
    }
  } else if (jt == 2) {  // pj = axis th
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      bth += a[k] * bpj[k];
      gax[k] = th * bpj[k];
    }
  }
  if (jt != 0) acc.add(OFF_AXIS + (j - 1) * 3, 3, gax);
  return bth;
}

}  // namespace
