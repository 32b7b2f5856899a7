// The normal equations of bundle adjustment in one pass over the
// observations, for Hopper (sm_90a): K7.
//
// Replaces no Pallas kernel: the JAX package (opencv_tpu/optim/ba.py,
// `normal_equations` and `_blocks`) forms each observation's residual and
// Jacobians with XLA ops, their products by einsum and the block sums by
// segment-sums. The port did the same with about twenty small PyTorch ops,
// five einsums (cuBLAS's gemm and batched gemv on [O,2,D] and [O,2,3]
// blocks, a contracted dimension of 2) and four index_add_s, every
// intermediate a round trip through device memory: ~75 % of global BA's
// time on an H100 once the Schur CG had its own kernel (csrc/schur_cg.cu).
//
// What it computes, for cameras of width D (6: rvec, t; or BAL's 9: rvec,
// t, f, k1, k2). First a table of the cameras (neq_table, one thread a
// camera: R, t, dR/drvec by the closed form of geometry/rotation.py's
// guarded Rodrigues formula and its derivative, BAL's intrinsics). Then,
// per observation o of camera c and point p, from the camera's row of the
// table and the point: the residual r [2], Jc [2,D] and Jp
// [2,3] with exactly optim/ba.py `_blocks`' mathematics (the z guard,
// BAL's distortion chain rule, the obs_valid mask and the Huber weight),
// then
//   A_o = Jc^T Jp [D,3]            written in observation order
//   U_c += Jc^T Jc, bc_c -= Jc^T r  (U's upper triangle summed, both halves written)
//   V_p += Jp^T Jp, bp_p -= Jp^T r
// all in f32. The sums go by one of three routes:
//   SMEM     a block-private copy of its cameras' U and bc in shared memory
//            (shared-memory atomics), written out as a partial [Q, C, K];
//            where one block cannot hold every camera, the cameras are split
//            into R ranges and each range has its own blocks, each block
//            skipping the observations of other ranges; a second kernel sums
//            the Q partials in block order
//   GLOBAL   red.global.add into one [C, K] (maps beyond R = 4 ranges)
//   ORDERED  each observation's camera and point terms written out, then
//            summed camera by camera and point by point in observation
//            order (deterministic algorithms: the same bits run after run)
// Point sums in SMEM and GLOBAL: a segmented sum over each warp's runs of
// equal points (observations come point by point from every generator of
// the benchmark), then one set of atomics a run. Any observation order is
// right; point-major order is the fast one.
//
// Bound: bytes. The pass must read an observation's camera and point
// indices (16 B), its uv (8 B) and its mask (1 B), and write A (12 D B:
// 72 at D = 6, 108 at 9); per point read the point (12 B) and write V and
// bp (48 B); the camera tables and U are a few hundred kB. ~230 MB at
// KITTI 07's 2.2 M observations: 0.069 ms at 3.35 TB/s. The products are
// two-row outer products (~1 kFLOP an observation), so operations do not
// bound it. Nothing observation-sized reaches device memory but A (and
// the ORDERED route's terms); the camera rows and points are gathers that
// stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int REDUCE_THREADS = 256;
constexpr int ORDERED_THREADS = 128;
constexpr int POINT_THREADS = 256;
constexpr int TABLE_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

enum Acc { SMEM = 0, GLOBAL = 1, ORDERED = 2 };

template <int D>
struct Cam {
  static constexpr int T = D * (D + 1) / 2;     // U's upper triangle, row by row
  static constexpr int K = T + D;               // then bc
  static constexpr int TW = D == 6 ? 40 : 44;   // a table row: R 9, t 3, dR 27, (f, k1, k2), padding to 16 B
};

struct Args {
  const long long* cam;        // [O]
  const long long* pt;         // [O]
  const float2* uv;            // [O]
  const unsigned char* valid;  // [O] bool
  const float* table;          // [C, TW]
  const float* points;         // [P, 3]
  float* A;                    // [O, D, 3]
  float* V;                    // [P, 3, 3], zeroed (SMEM, GLOBAL)
  float* bp;                   // [P, 3], zeroed (SMEM, GLOBAL)
  float* camo;                 // SMEM [Q, C, K]; GLOBAL [C, K] zeroed; ORDERED [O, K]
  float* pto;                  // ORDERED [O, 9]: V's upper triangle, then bp
  long long O;
  int C, ranges, huber;
  float delta;
};

// r, Jc and Jp of observation o (camera c, point p), weighted: _blocks'.
template <int D>
__device__ __forceinline__ void observe(const Args& a, long long o, long long c, long long p, float (&r)[2],
                                        float (&jc)[2][D], float (&jp)[2][3]) {
  constexpr int TW = Cam<D>::TW;
  float tb[TW];
  const float4* row = reinterpret_cast<const float4*>(a.table) + (size_t)(TW / 4) * c;
#pragma unroll
  for (int i = 0; i < TW / 4; ++i) {
    const float4 v = __ldg(row + i);
    tb[4 * i] = v.x;
    tb[4 * i + 1] = v.y;
    tb[4 * i + 2] = v.z;
    tb[4 * i + 3] = v.w;
  }
  const float* R = tb;        // R[3 i + j]
  const float* t = tb + 9;
  const float* dR = tb + 12;  // dR_ij / drvec_k at 9 i + 3 j + k
  float X[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) X[k] = __ldg(a.points + 3 * p + k);
  float pc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) pc[i] = fmaf(R[3 * i + 2], X[2], fmaf(R[3 * i + 1], X[1], R[3 * i] * X[0])) + t[i];
  const bool guard = fabsf(pc[2]) < 1e-9f;
  const float zs = guard ? 1e-9f : pc[2];
  const float u = pc[0] / zs, v = pc[1] / zs;
  const float iz = 1.0f / zs;
  const float du0 = guard ? 0.f : -u / zs, du1 = guard ? 0.f : -v / zs;
  // d residual / d P: d uv / d P, or with BAL's intrinsics -(d pixel / d p) (d uv / d P)
  float dP[2][3] = {{iz, 0.f, du0}, {0.f, iz, du1}};
  const float2 ob = a.uv[o];
  float res[2];
  if constexpr (D == 6) {
    res[0] = u - ob.x;
    res[1] = v - ob.y;
  } else {
    const float f = tb[39], k1 = tb[40], k2 = tb[41];
    const float p0 = -u, p1 = -v;
    const float s = p0 * p0 + p1 * p1;
    const float d = 1.f + s * (k1 + k2 * s);
    res[0] = (f * d) * p0 - ob.x;
    res[1] = (f * d) * p1 - ob.y;
    const float e = 2.f * (k1 + 2.f * k2 * s);
    const float m00 = f * (d + e * (p0 * p0)), m01 = f * (e * (p0 * p1)), m11 = f * (d + e * (p1 * p1));
    dP[0][0] = -(m00 * iz);
    dP[0][1] = -(m01 * iz);
    dP[0][2] = -(m00 * du0 + m01 * du1);
    dP[1][0] = -(m01 * iz);
    dP[1][1] = -(m11 * iz);
    dP[1][2] = -(m01 * du0 + m11 * du1);
    const float fs = f * s, fss = fs * s;
    jc[0][6] = d * p0;
    jc[1][6] = d * p1;
    jc[0][7] = fs * p0;
    jc[1][7] = fs * p1;
    jc[0][8] = fss * p0;
    jc[1][8] = fss * p1;
  }
  float dr[3][3];  // d P / d rvec
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dr[i][k] = fmaf(dR[9 * i + 6 + k], X[2], fmaf(dR[9 * i + 3 + k], X[1], dR[9 * i + k] * X[0]));
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      jc[q][k] = fmaf(dP[q][2], dr[2][k], fmaf(dP[q][1], dr[1][k], dP[q][0] * dr[0][k]));
      jc[q][3 + k] = dP[q][k];
      jp[q][k] = fmaf(dP[q][2], R[6 + k], fmaf(dP[q][1], R[3 + k], dP[q][0] * R[k]));
    }
  }
  float w = a.valid[o] ? 1.f : 0.f;
  if (a.huber) {
    const float nrm = sqrtf(res[0] * res[0] + res[1] * res[1] + 1e-18f);
    w *= sqrtf(fminf(a.delta / nrm, 1.f));
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    r[q] = res[q] * w;
#pragma unroll
    for (int i = 0; i < D; ++i) jc[q][i] *= w;
#pragma unroll
    for (int k = 0; k < 3; ++k) jp[q][k] *= w;
  }
}

__device__ __forceinline__ float two(float a0, float b0, float a1, float b1) { return fmaf(a1, b1, a0 * b0); }

// A point's 9 terms (V's upper triangle, bp) summed over each run of
// equal points in the warp's lanes (an inclusive segmented scan), then one
// set of atomics by the run's last lane. p < 0: no point (its terms are 0).
__device__ __forceinline__ void point_sums(const Args& a, long long p, float (&v)[9]) {
  const int lane = threadIdx.x & 31;
  const long long prev = __shfl_up_sync(FULL, p, 1);
  const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != p);
  const unsigned upto = lane == 31 ? FULL : (2u << lane) - 1u;
  const int start = 31 - __clz(heads & upto);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float u = __shfl_up_sync(FULL, v[k], d);
      if (lane - d >= start) v[k] += u;
    }
  }
  const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  if (!tail || p < 0) return;
  float* Vp = a.V + 9 * p;
  atomicAdd(Vp + 0, v[0]);
  atomicAdd(Vp + 1, v[1]);
  atomicAdd(Vp + 3, v[1]);
  atomicAdd(Vp + 2, v[2]);
  atomicAdd(Vp + 6, v[2]);
  atomicAdd(Vp + 4, v[3]);
  atomicAdd(Vp + 5, v[4]);
  atomicAdd(Vp + 7, v[4]);
  atomicAdd(Vp + 8, v[5]);
#pragma unroll
  for (int k = 0; k < 3; ++k) atomicAdd(a.bp + 3 * p + k, v[6 + k]);
}

template <int ACC>
__device__ __forceinline__ void put(float* dst, float v) {
  if constexpr (ACC == ORDERED) *dst = v;
  else atomicAdd(dst, v);
}

// Block b: camera range b % R, observations [q per, (q + 1) per) for
// q = b / R; a tile of THREADS consecutive observations at a time, one a
// thread.
template <int D, int ACC>
__global__ void __launch_bounds__(THREADS, 1) neq_pass(const Args a) {
  using Cm = Cam<D>;
  extern __shared__ __align__(16) float cam_s[];  // SMEM: K terms of each camera of the range
  const int tid = threadIdx.x;
  const int nq = gridDim.x / a.ranges, q = blockIdx.x / a.ranges, rg = blockIdx.x % a.ranges;
  const int cr = (a.C + a.ranges - 1) / a.ranges;
  const int c_lo = min(a.C, rg * cr), c_hi = min(a.C, c_lo + cr);
  const int n_s = (c_hi - c_lo) * Cm::K;
  if constexpr (ACC == SMEM) {
    for (int i = tid; i < n_s; i += THREADS) cam_s[i] = 0.f;
    __syncthreads();
  }
  const long long per = ((a.O + nq - 1) / nq + 31) & ~31LL;
  const long long o0 = q * per, o1 = min(a.O, o0 + per);
  for (long long base = o0; base < o1; base += THREADS) {
    const long long o = base + tid;
    long long c = -1, p = -1;
    if (o < o1) {
      c = a.cam[o];
      if (c >= c_lo && c < c_hi) p = a.pt[o];
      else c = -1;
    }
    float pv[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float r[2], jc[2][D], jp[2][3];
    if (c >= 0) {
      observe<D>(a, o, c, p, r, jc, jp);
      float* Ao = a.A + (size_t)3 * D * o;
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int k = 0; k < 3; ++k) Ao[3 * i + k] = two(jc[0][i], jp[0][k], jc[1][i], jp[1][k]);
      }
      int n = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = i; j < 3; ++j) pv[n++] = two(jp[0][i], jp[0][j], jp[1][i], jp[1][j]);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) pv[6 + i] = -two(jp[0][i], r[0], jp[1][i], r[1]);
    }
    if constexpr (ACC == ORDERED) {
      if (c >= 0) {
#pragma unroll
        for (int k = 0; k < 9; ++k) a.pto[9 * o + k] = pv[k];
      }
    } else {
      point_sums(a, p, pv);
    }
    if (c >= 0) {
      float* dst = ACC == SMEM     ? cam_s + (size_t)Cm::K * (c - c_lo)
                   : ACC == GLOBAL ? a.camo + (size_t)Cm::K * c
                                   : a.camo + (size_t)Cm::K * o;
      int n = 0;
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int j = i; j < D; ++j) put<ACC>(dst + n++, two(jc[0][i], jc[0][j], jc[1][i], jc[1][j]));
      }
#pragma unroll
      for (int i = 0; i < D; ++i) put<ACC>(dst + Cm::T + i, -two(jc[0][i], r[0], jc[1][i], r[1]));
    }
  }
  if constexpr (ACC == SMEM) {
    __syncthreads();
    float* out = a.camo + ((size_t)q * a.C + c_lo) * Cm::K;
    for (int i = tid; i < n_s; i += THREADS) out[i] = cam_s[i];
  }
}

// Term k of camera c's K into U (both halves of the upper triangle's
// entry) or bc.
template <int D>
__device__ __forceinline__ void store_cam(float* U, float* bc, long long c, int k, float h) {
  if (k >= Cam<D>::T) {
    bc[(size_t)D * c + k - Cam<D>::T] = h;
    return;
  }
  int i = 0;
  while (k >= D - i) {
    k -= D - i;
    ++i;
  }
  const int j = i + k;
  U[((size_t)D * c + i) * D + j] = h;
  U[((size_t)D * c + j) * D + i] = h;
}

// U and bc from the partials [nparts, C, K], summed in block order.
template <int D>
__global__ void __launch_bounds__(REDUCE_THREADS) neq_cam_reduce(const float* __restrict__ parts, int nparts,
                                                                 int C, float* U, float* bc) {
  constexpr int K = Cam<D>::K;
  const long long e = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (e >= (long long)C * K) return;
  float h = 0.f;
  for (int b = 0; b < nparts; ++b) h += __ldg(parts + (size_t)b * C * K + e);
  store_cam<D>(U, bc, e / K, (int)(e % K), h);
}

// ORDERED: U and bc of camera blockIdx.x from its observations' terms in
// observation order (idx, off: a stable sort by camera), strided over the
// threads, then a fixed tree.
template <int D>
__global__ void __launch_bounds__(ORDERED_THREADS) neq_cam_ordered(const float* __restrict__ camo,
                                                                   const long long* __restrict__ idx,
                                                                   const long long* __restrict__ off, float* U,
                                                                   float* bc) {
  constexpr int K = Cam<D>::K, WARPS = ORDERED_THREADS / 32;
  __shared__ float red[WARPS][K];
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  for (long long j = off[c] + tid; j < off[c + 1]; j += ORDERED_THREADS) {
    const float* w = camo + (size_t)K * idx[j];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += w[k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = acc[k];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(FULL, v, d);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  for (int k = tid; k < K; k += ORDERED_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][k];
    store_cam<D>(U, bc, c, k, s);
  }
}

// ORDERED: V and bp of each point from its observations' terms in
// observation order (idx, off: a stable sort by point).
__global__ void __launch_bounds__(POINT_THREADS) neq_pt_ordered(const float* __restrict__ pto,
                                                                const long long* __restrict__ idx,
                                                                const long long* __restrict__ off, int P,
                                                                float* V, float* bp) {
  const long long p = (long long)blockIdx.x * POINT_THREADS + threadIdx.x;
  if (p >= P) return;
  float s[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (long long j = off[p]; j < off[p + 1]; ++j) {
    const float* w = pto + 9 * idx[j];
#pragma unroll
    for (int k = 0; k < 9; ++k) s[k] += w[k];
  }
  float* Vp = V + 9 * p;
  Vp[0] = s[0];
  Vp[1] = Vp[3] = s[1];
  Vp[2] = Vp[6] = s[2];
  Vp[4] = s[3];
  Vp[5] = Vp[7] = s[4];
  Vp[8] = s[5];
#pragma unroll
  for (int k = 0; k < 3; ++k) bp[3 * p + k] = s[6 + k];
}

// hat(v) @ x = v x x, row-major
__device__ __forceinline__ void hat(const float (&v)[3], float (&h)[9]) {
  h[0] = 0.f;
  h[1] = -v[2];
  h[2] = v[1];
  h[3] = v[2];
  h[4] = 0.f;
  h[5] = -v[0];
  h[6] = -v[1];
  h[7] = v[0];
  h[8] = 0.f;
}

__device__ __forceinline__ void mat3(const float (&a)[9], const float (&b)[9], float (&c)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c[3 * i + j] = fmaf(a[3 * i + 2], b[6 + j], fmaf(a[3 * i + 1], b[3 + j], a[3 * i] * b[j]));
  }
}

// Camera c's row of the pass's table: R, t, dR/drvec, (f, k1, k2), zeros.
// R is geometry/rotation.py `rodrigues`' formula, R = I + a K + b K^2 with
// K = hat(rvec), x = th^2, a = sin(th)/th, b = (1 - cos(th))/x, and
// dR/drvec_m its derivative, a1 r_m K + a hat(e_m) + b1 r_m K^2 + b
// (hat(e_m) K + K hat(e_m)) with a1 = 2 da/dx, b1 = 2 db/dx, as
// `rodrigues_jacobian` takes it. Evaluated without cancellation: below
// x = 1e-2 by their series to x^3 (which `rodrigues` truncates to x below
// 1e-8), above with 1 - cos(th) = 2 sin^2(th/2). In float32 the formulas
// as written lose up to ~1e-4 of dR/drvec at th ~ 1e-4 to 1e-3.
template <int D>
__global__ void __launch_bounds__(TABLE_THREADS) neq_table(const float* __restrict__ rvec,
                                                           const float* __restrict__ tvec,
                                                           const float* __restrict__ intr, int C, float* table) {
  constexpr int TW = Cam<D>::TW;
  const int c = blockIdx.x * TABLE_THREADS + threadIdx.x;
  if (c >= C) return;
  const float r[3] = {rvec[3 * c], rvec[3 * c + 1], rvec[3 * c + 2]};
  const float th2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  const float th = sqrtf(th2 + 1e-16f);
  const float x = th2;
  float a, b, a1, b1;
  if (x < 1e-2f) {
    a = 1.f + x * (-1.f / 6.f + x * (1.f / 120.f - x / 5040.f));
    b = 0.5f + x * (-1.f / 24.f + x * (1.f / 720.f - x / 40320.f));
    a1 = -1.f / 3.f + x * (1.f / 30.f + x * (-1.f / 840.f + x / 45360.f));
    b1 = -1.f / 12.f + x * (1.f / 180.f + x * (-1.f / 6720.f + x / 453600.f));
  } else {
    const float sn = sinf(th), cs = cosf(th), h = sinf(0.5f * th);
    a = sn / th;
    b = 2.f * h * h / x;
    a1 = (cs * th - sn) / (x * th);
    b1 = (sn * th - 4.f * h * h) / (x * x);
  }
  float K[9], K2[9];
  hat(r, K);
  mat3(K, K, K2);
  float* out = table + (size_t)TW * c;
#pragma unroll
  for (int e = 0; e < 9; ++e) out[e] = (e % 4 == 0 ? 1.f : 0.f) + a * K[e] + b * K2[e];
#pragma unroll
  for (int k = 0; k < 3; ++k) out[9 + k] = tvec[3 * c + k];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float em[3] = {m == 0 ? 1.f : 0.f, m == 1 ? 1.f : 0.f, m == 2 ? 1.f : 0.f};
    float E[9], EK[9], KE[9];
    hat(em, E);
    mat3(E, K, EK);
    mat3(K, E, KE);
#pragma unroll
    for (int e = 0; e < 9; ++e)
      out[12 + 3 * e + m] = (a1 * r[m]) * K[e] + a * E[e] + (b1 * r[m]) * K2[e] + b * (EK[e] + KE[e]);
  }
  int n = 39;
  if constexpr (D == 9) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out[n++] = intr[3 * c + k];
  }
  for (; n < TW; ++n) out[n] = 0.f;
}

int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return -1;
  return bytes;
}

template <int D>
int smem_bytes(int acc, int C, int ranges) {
  return acc == SMEM ? 4 * Cam<D>::K * ((C + ranges - 1) / ranges) : 0;
}

template <int D, int ACC>
cudaError_t opt_in() {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidValue;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(neq_pass<D, ACC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  return cudaSuccess;
}

// Observation parts a range takes: as many blocks as the card holds at
// once over the ranges, no more than tiles of observations.
template <int D, int ACC>
int blocks(long long O, int C, int ranges) {
  if (opt_in<D, ACC>() != cudaSuccess) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, neq_pass<D, ACC>, THREADS,
                                                    smem_bytes<D>(ACC, C, ranges)) != cudaSuccess ||
      per_sm < 1)
    return -1;
  const long long tiles = (O + THREADS - 1) / THREADS;
  const long long want = ((long long)sms * per_sm + ranges - 1) / ranges;
  return (int)(tiles < want ? (tiles < 1 ? 1 : tiles) : want);
}

template <int D>
int blocks_of(int acc, long long O, int C, int ranges) {
  switch (acc) {
    case SMEM: return blocks<D, SMEM>(O, C, ranges);
    case GLOBAL: return blocks<D, GLOBAL>(O, C, ranges);
    default: return blocks<D, ORDERED>(O, C, ranges);
  }
}

template <int D, int ACC>
cudaError_t launch_pass(const Args& a, int nq, cudaStream_t st) {
  cudaError_t err = opt_in<D, ACC>();
  if (err != cudaSuccess) return err;
  const int bytes = smem_bytes<D>(ACC, a.C, a.ranges);
  if (bytes > smem_optin()) return cudaErrorInvalidValue;
  neq_pass<D, ACC><<<nq * a.ranges, THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_width(int acc, const Args& a, int nq, cudaStream_t st) {
  switch (acc) {
    case SMEM: return launch_pass<D, SMEM>(a, nq, st);
    case GLOBAL: return launch_pass<D, GLOBAL>(a, nq, st);
    default: return launch_pass<D, ORDERED>(a, nq, st);
  }
}

bool width_ok(int D) { return D == 6 || D == 9; }

}  // namespace

extern "C" {

// The shared memory a block may opt into on the current device (-1 on error).
int normal_eq_smem_optin(void) { return smem_optin(); }

// The shared memory a pass of route `acc` (0 SMEM, 1 GLOBAL, 2 ORDERED)
// takes over C cameras of width D (6 or 9; -1 for another) split into
// `ranges` ranges.
int normal_eq_smem_bytes(int D, int acc, int C, int ranges) {
  if (!width_ok(D) || acc < SMEM || acc > ORDERED || C < 0 || ranges < 1) return -1;
  return D == 6 ? smem_bytes<6>(acc, C, ranges) : smem_bytes<9>(acc, C, ranges);
}

// The observation parts Q of each camera range a pass launches (its grid
// is Q ranges blocks; SMEM's partials are [Q, C, K]); -1 on error.
int normal_eq_blocks(int D, int acc, long long O, int C, int ranges) {
  if (!width_ok(D) || acc < SMEM || acc > ORDERED || O < 0 || C < 0 || ranges < 1) return -1;
  return D == 6 ? blocks_of<6>(acc, O, C, ranges) : blocks_of<9>(acc, O, C, ranges);
}

// One pass over O observations at camera width D (6 or 9) by route acc,
// with nq observation parts a camera range; every array contiguous, of
// the shapes in Args (pto only for ORDERED; huber 0: no Huber weight).
// Returns a cudaError_t (0 = launched).
int normal_eq_pass_launch(int D, int acc, const long long* cam, const long long* pt, const float* uv,
                          const unsigned char* valid, const float* table, const float* points, float* A, float* V,
                          float* bp, float* camo, float* pto, long long O, int C, int ranges, int nq, int huber,
                          float delta, void* stream) {
  if (!width_ok(D) || acc < SMEM || acc > ORDERED || O < 1 || C < 1 || ranges < 1 || nq < 1 ||
      (acc != SMEM && ranges != 1) || (acc == ORDERED && !pto) || (acc != ORDERED && (!V || !bp)))
    return (int)cudaErrorInvalidValue;
  Args a{cam, pt, reinterpret_cast<const float2*>(uv), valid, table, points, A, V, bp, camo, pto, O, C, ranges,
         huber, delta};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(D == 6 ? launch_width<6>(acc, a, nq, st) : launch_width<9>(acc, a, nq, st));
}

// U [C, D, D] and bc [C, D] from `nparts` partials [nparts, C, K] summed in
// block order (SMEM, GLOBAL), or, with idx and off (a stable sort of the
// observations by camera and the cameras' offsets in it), from the
// ORDERED route's terms [O, K] camera by camera.
int normal_eq_cam_launch(int D, const float* parts, int nparts, const long long* idx, const long long* off, int C,
                         float* U, float* bc, void* stream) {
  if (!width_ok(D) || C < 0 || (!idx && nparts < 1) || (!idx != !off)) return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (idx) {
    if (D == 6) neq_cam_ordered<6><<<C, ORDERED_THREADS, 0, st>>>(parts, idx, off, U, bc);
    else neq_cam_ordered<9><<<C, ORDERED_THREADS, 0, st>>>(parts, idx, off, U, bc);
  } else {
    const long long n = (long long)C * (D == 6 ? Cam<6>::K : Cam<9>::K);
    const int grid = (int)((n + REDUCE_THREADS - 1) / REDUCE_THREADS);
    if (D == 6) neq_cam_reduce<6><<<grid, REDUCE_THREADS, 0, st>>>(parts, nparts, C, U, bc);
    else neq_cam_reduce<9><<<grid, REDUCE_THREADS, 0, st>>>(parts, nparts, C, U, bc);
  }
  return (int)cudaGetLastError();
}

// ORDERED: V [P, 3, 3] and bp [P, 3] from the terms [O, 9] point by point
// (idx, off: a stable sort of the observations by point and the points'
// offsets in it).
int normal_eq_point_launch(const float* pto, const long long* idx, const long long* off, int P, float* V, float* bp,
                           void* stream) {
  if (P < 0 || !pto || !idx || !off) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  neq_pt_ordered<<<(P + POINT_THREADS - 1) / POINT_THREADS, POINT_THREADS, 0, (cudaStream_t)stream>>>(
      pto, idx, off, P, V, bp);
  return (int)cudaGetLastError();
}

// The pass's table [C, TW] of C cameras of width D (6 or 9) from rvec and
// tvec [C, 3] (and, at 9, the intrinsics [C, 3]).
int normal_eq_table_launch(int D, const float* rvec, const float* tvec, const float* intr, int C, float* table,
                           void* stream) {
  if (!width_ok(D) || C < 0 || (D == 9 && !intr)) return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  const int grid = (C + TABLE_THREADS - 1) / TABLE_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 6) neq_table<6><<<grid, TABLE_THREADS, 0, st>>>(rvec, tvec, intr, C, table);
  else neq_table<9><<<grid, TABLE_THREADS, 0, st>>>(rvec, tvec, intr, C, table);
  return (int)cudaGetLastError();
}

const char* normal_eq_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
