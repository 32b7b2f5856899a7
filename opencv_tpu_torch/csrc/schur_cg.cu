// The Schur-CG products of bundle adjustment as one point-major pass over
// A, for Hopper (sm_90a), and the CG's vector work between two products.
//
// Replaces no Pallas kernel: the JAX package (opencv_tpu/optim/ba.py,
// `schur_cg_solve`) applies W and W^T per observation through A [O,6,3]
// and leaves the two gathers and segment-sums to XLA. The port did the
// same with einsum (cuBLAS's batched gemv) and index_add_, two products a
// CG iteration, each writing its [O,3] or [O,6] intermediate to device
// memory and reading it back. This kernel is added because those products
// held ~85 % of global BA's time on an H100.
//
// What it computes. With the observations sorted by point (the wrapper's
// point-major layout: A_pm [O+2,6,3], (camera, point) pairs [O+2] int32,
// point offsets [P+5], chunks of whole points, each chunk's observations
// in camera order), one launch in
//   FULL   x -> g_p = sum_o A_o^T x_c(o) -> z_p = V_p^-1 g_p -> h_c += A_o z_p
//   HZ     g given (bp, or an all-reduced W^T x) -> z_p = V_p^-1 g_p -> h_c += A_o z_p
//   BACK   x -> out_p = V_p^-1 (bp_p - sum_o A_o^T x_c(o))   (back-substitution);
//          without x, out_p = V_p^-1 r_p for r given (a process group's
//          back-substitution, r = bp - the all-reduced W^T x)
//   GONLY  x -> out_p = sum_o A_o^T x_c(o)
// x is multiplied by the camera mask where one is given. Every mode forms
// z_p by the same code, so FULL gives the bits of GONLY followed by HZ,
// and BACK those of GONLY, bp - g and BACK without x. h goes by one of
// three accumulators:
//   SMEM     h [C,6] private to the block in shared memory, added to by
//            runs of one camera in a fixed order (no atomics), written out
//            as a partial [blocks, C, 6]
//   GLOBAL   red.global.add into one h [C,6] (x read through L1): for maps
//            whose x and h do not fit in shared memory beside the ring
//   ORDERED  each observation's A_o z_p written out [O,6] in point-major
//            order, for a camera-ordered sum (deterministic algorithms)
// A second small kernel sums the partials in a fixed order for each camera
// entry (the ORDERED products first go camera by camera through a third)
// and finishes the product there: out = mask * (Ud (x*mask) - h), or
// mask * (base - h), or h alone; for the CG it also sums p.Sp over each
// of its blocks. A fourth, one block, does the CG's vector work between
// two products (alpha, x, r, the block-Jacobi preconditioner, beta, p),
// so an iteration is three launches on one card.
//
// Bound: bytes of A. The product must read A once (72 B an observation)
// and its camera (4 B), the point offsets (4 B a point), V^-1 (36 B a
// point), x and h (24 B a camera each): ~81 B an observation, ~53 us at
// KITTI 07's 2.2 M observations at 3.35 TB/s. This design moves ~9 % more:
// the point index beside the camera (4 B), the camera order (2 B) and the
// block partials (24 B a camera a block).
//
// Design. One persistent block of 512 threads on each SM walks the chunks
// the schedule gives it (chunk k: the points whose observations begin in
// [k*416, (k+1)*416), so a chunk holds whole points and at most 512
// observations unless a point has more than 97). Thread 0 streams each
// chunk into a ring of 2-3 stages in shared memory with 1-D bulk copies
// (cp.async.bulk, completion on an mbarrier), issued as soon as the block
// has released the stage, so the loads stay in flight while the block
// computes: the rows of A, the index pairs, the camera order and, for at
// most 192 points, their offsets and V^-1. Per chunk (tile()): thread j
// forms t_j = A_j^T x_c into shared memory, keeping A_j in registers; the
// first observation of each point sums its point's t in observation order
// and applies V^-1 (no float atomics for g); thread j forms w_j = A_j z;
// the first of each run of one camera in the chunk's camera order sums the
// run's w and adds it to h_s. Shared-memory float atomics (a compare-and-
// swap loop on sm_90) took ~40 % of the pass in the first design; the
// camera runs took them out and make the pass's sums a fixed order. A
// chunk above 512 observations is walked point by point from device
// memory (slower, rare). No intermediate [O,3] or [O,6] reaches device
// memory outside the ORDERED accumulator.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;  // one observation a thread in a stage
constexpr int TILE = 512;     // observations a stage holds
constexpr int ROW = 18;       // floats of A an observation, [6, 3]
constexpr int QCAP = 192;     // points a stage holds the offsets and V^-1 of
constexpr int A_BYTES = (TILE + 2) * ROW * 4;  // +2 rows: copies start at an even row
constexpr int IDX_BYTES = (TILE + 2) * 8;
constexpr int CS_BYTES = (TILE + 16) * 2;      // copies start at a multiple of 8 observations
constexpr int OFF_BYTES = (QCAP + 8) * 4;      // copies start at a point that is a multiple of 4
constexpr int VINV_BYTES = (QCAP + 8) * 36;
constexpr int STAGE_BYTES = A_BYTES + IDX_BYTES + CS_BYTES + OFF_BYTES + VINV_BYTES;
constexpr int MAX_STAGES = 3;
constexpr int WARPS = THREADS / 32;

enum Mode { FULL = 0, HZ = 1, BACK = 2, GONLY = 3 };
enum Acc { SMEM = 0, GLOBAL = 1, ORDERED = 2 };

struct Args {
  const float* A;        // [O + 2, 6, 3], point-major
  const int2* idx;       // [O + 2] (camera, point), point-major
  const short* cs;       // [O + 8] (SMEM): each chunk's observations in camera order (tile())
  const int* off;        // [P + 5]: the observations of point p are [off[p], off[p+1])
  const int* chunk_obs;  // [K + 1]: chunk k's observations are [chunk_obs[k], chunk_obs[k+1])
  const int* chunk_pt;   // [K + 1]: and its points [chunk_pt[k], chunk_pt[k+1])
  const float* x;        // [C, 6]; null in BACK: the sum is 0
  const float* mask;     // [C] or null
  const float* vinv;     // [P + 4, 3, 3]
  const float* pin;      // [P, 3]: g given (HZ), or bp or r (BACK)
  float* pout;           // [P, 3] (BACK, GONLY)
  float* hout;           // SMEM [blocks, C, 6]; GLOBAL [C, 6], zeroed; ORDERED [O, 6]
  int K, C, stages, x_smem, h_smem;
};

// Byte offsets of the parts of a block's shared memory.
struct Carve {
  int bar, meta, red, t, w, x, h, total;
};

__host__ __device__ inline Carve carve(int stages, int C, int x_smem, int h_smem) {
  Carve L;
  L.bar = stages * STAGE_BYTES;
  L.meta = L.bar + 8 * MAX_STAGES + 8;      // 32 bytes of mbarriers
  L.red = L.meta + 16 * MAX_STAGES;         // int4 (s, e, q0, q1) a stage
  L.t = L.red + 4 * (3 * WARPS + 4);        // a block sum's warp partials
  L.w = L.t + 4 * 3 * TILE;                 // t_o (then z) of a stage
  L.x = L.w + (h_smem ? 4 * 6 * TILE : 0);  // w_o of a stage (SMEM)
  L.h = L.x + (x_smem ? 24 * C : 0);
  L.total = L.h + (h_smem ? 24 * C : 0);
  return L;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Whether a chunk's points' offsets and V^-1 come in its stage.
__device__ __forceinline__ bool points_staged(int4 m) {
  return m.y > m.x && m.y - m.x <= TILE && m.w - m.z <= QCAP;
}

// Thread 0: record chunk k in stage st and start its copies: rows of A and
// index pairs (none for an empty chunk or one above TILE observations,
// which is read in place), and, for at most QCAP points, their offsets
// and V^-1 from point (q0 & ~3) on.
__device__ void issue(const Args& a, unsigned char* smem, const Carve& L, long long k, int st) {
  const int4 m = make_int4(a.chunk_obs[k], a.chunk_obs[k + 1], a.chunk_pt[k], a.chunk_pt[k + 1]);
  reinterpret_cast<int4*>(smem + L.meta)[st] = m;
  const uint32_t bar = saddr(smem + L.bar) + 8 * st;
  const int s = m.x, e = m.y, n = e - s;
  if (n > 0 && n <= TILE) {
    const int s0 = s & ~1;                  // 72 and 8 bytes a row: an even row is 16-byte aligned
    const int rows = ((e + 1) & ~1) - s0;   // and an even count a multiple of 16 bytes
    const uint32_t ba = (uint32_t)rows * ROW * 4, bi = (uint32_t)rows * 8;
    const int c0 = s & ~7;                  // 2 bytes an entry: 8 entries a 16 bytes
    const uint32_t bc = a.cs ? (uint32_t)((e - c0 + 7) & ~7) * 2 : 0;
    uint32_t bo = 0, bv = 0;
    const int qa = m.z & ~3;
    if (points_staged(m)) {
      bo = (uint32_t)((m.w + 1 - qa + 3) & ~3) * 4;   // off[qa .. q1], 4 points a 16 bytes
      bv = (uint32_t)((m.w - qa + 3) & ~3) * 36;      // V^-1 of points qa .. q1 - 1
    }
    const uint32_t dst = saddr(smem + st * STAGE_BYTES);
    mbar_expect_tx(bar, ba + bi + bc + bo + bv);
    bulk_load(dst, a.A + (size_t)s0 * ROW, ba, bar);
    bulk_load(dst + A_BYTES, a.idx + s0, bi, bar);
    if (bc) bulk_load(dst + A_BYTES + IDX_BYTES, a.cs + c0, bc, bar);
    if (bo) {
      bulk_load(dst + A_BYTES + IDX_BYTES + CS_BYTES, a.off + qa, bo, bar);
      bulk_load(dst + A_BYTES + IDX_BYTES + CS_BYTES + OFF_BYTES, a.vinv + (size_t)9 * qa, bv, bar);
    }
  } else {
    mbar_arrive(bar);
  }
}

__device__ __forceinline__ void load_row(float (&r)[ROW], const float* src) {
  const float2* p = reinterpret_cast<const float2*>(src);
#pragma unroll
  for (int i = 0; i < ROW / 2; ++i) {
    const float2 v = p[i];
    r[2 * i] = v.x;
    r[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load_row_global(float (&r)[ROW], const float* src) {
  const float2* p = reinterpret_cast<const float2*>(src);
#pragma unroll
  for (int i = 0; i < ROW / 2; ++i) {
    const float2 v = __ldg(p + i);
    r[2 * i] = v.x;
    r[2 * i + 1] = v.y;
  }
}

// x_c (times the mask), from shared memory or through L1
__device__ __forceinline__ void load_x(float (&xv)[6], const Args& a, const float* x_s, int c) {
  if (a.x_smem) {
    const float2* p = reinterpret_cast<const float2*>(x_s + 6 * c);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float2 v = p[i];
      xv[2 * i] = v.x;
      xv[2 * i + 1] = v.y;
    }
    return;
  }
  const float2* p = reinterpret_cast<const float2*>(a.x + (size_t)6 * c);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float2 v = __ldg(p + i);
    xv[2 * i] = v.x;
    xv[2 * i + 1] = v.y;
  }
  if (a.mask) {
    const float m = __ldg(a.mask + c);
#pragma unroll
    for (int i = 0; i < 6; ++i) xv[i] = xv[i] * m;
  }
}

// t = A^T x (3), w = A z (6): A is [6, 3] row-major
__device__ __forceinline__ void at_x(float (&t)[3], const float (&r)[ROW], const float (&xv)[6]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float acc = r[j] * xv[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) acc = fmaf(r[3 * i + j], xv[i], acc);
    t[j] = acc;
  }
}

__device__ __forceinline__ void a_z(float (&w)[6], const float (&r)[ROW], const float (&z)[3]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) w[i] = fmaf(r[3 * i + 2], z[2], fmaf(r[3 * i + 1], z[1], r[3 * i] * z[0]));
}

// z = V^-1 g (one code path for every mode, so equal inputs give equal bits)
template <int MODE>
__device__ __forceinline__ void point_z(float (&z)[3], const float (&vi)[9], const float (&g)[3]) {
  if constexpr (MODE == GONLY) {
#pragma unroll
    for (int r = 0; r < 3; ++r) z[r] = g[r];
  } else {
#pragma unroll
    for (int r = 0; r < 3; ++r) z[r] = fmaf(vi[3 * r + 2], g[2], fmaf(vi[3 * r + 1], g[1], vi[3 * r] * g[0]));
  }
}

template <int MODE>
__device__ __forceinline__ void load_point(float (&vi)[9], float (&pin)[3], const Args& a, int p,
                                           const float* vinv_s = nullptr) {
  if (MODE != GONLY) {
#pragma unroll
    for (int k = 0; k < 9; ++k) vi[k] = vinv_s ? vinv_s[k] : __ldg(a.vinv + (size_t)9 * p + k);
  }
  if (MODE == HZ || MODE == BACK) {
#pragma unroll
    for (int k = 0; k < 3; ++k) pin[k] = __ldg(a.pin + (size_t)3 * p + k);
  }
}

// g of a point from the sum over its observations
template <int MODE>
__device__ __forceinline__ void point_g(float (&g)[3], const float (&sum)[3], const float (&pin)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) g[k] = MODE == HZ ? pin[k] : MODE == BACK ? pin[k] - sum[k] : sum[k];
}

// h of the GLOBAL and ORDERED accumulators (SMEM adds by camera runs)
template <int ACC>
__device__ __forceinline__ void accumulate(const Args& a, int c, int o, const float (&w)[6]) {
  if (ACC == GLOBAL) {
#pragma unroll
    for (int i = 0; i < 6; ++i) atomicAdd(a.hout + (size_t)6 * c + i, w[i]);
  } else {
    float2* d = reinterpret_cast<float2*>(a.hout + (size_t)6 * o);
    d[0] = make_float2(w[0], w[1]);
    d[1] = make_float2(w[2], w[3]);
    d[2] = make_float2(w[4], w[5]);
  }
}

// A point-per-output mode's points without observations: g = 0.
template <int MODE>
__device__ __forceinline__ void empty_points(const Args& a, int q0, int q1) {
  for (int q = q0 + (int)threadIdx.x; q < q1; q += THREADS) {
    if (__ldg(a.off + q) != __ldg(a.off + q + 1)) continue;
    float vi[9], pin[3], g[3], z[3];
    const float zero[3] = {0.f, 0.f, 0.f};
    load_point<MODE>(vi, pin, a, q);
    point_g<MODE>(g, zero, pin);
    point_z<MODE>(z, vi, g);
#pragma unroll
    for (int k = 0; k < 3; ++k) a.pout[(size_t)3 * q + k] = z[k];
  }
}

// A chunk of at most TILE observations, in stage memory.
//   1. thread j: t_j = A_j^T x_c(j) into t_s[j];
//   2. the first observation of each point: g = its t summed in
//      observation order, z = V^-1 g (or the mode's point output), z into
//      t_s at that observation;
//   3. thread j: w_j = A_j z_p(j); SMEM: into w_s[j], then the first of
//      each run of one camera in the chunk's camera order (point-major
//      within a camera) sums w over the run and adds it to h_s[c]: one
//      thread a camera a chunk, no atomics, a fixed order; GLOBAL and
//      ORDERED: w_j added or written out at once.
template <int MODE, int ACC>
__device__ __forceinline__ void tile(const Args& a, const unsigned char* stage, int4 m, float* t_s,
                                     float* w_s, const float* x_s, float* h_s) {
  const bool do_g = MODE != HZ && a.x;
  constexpr bool DO_H = MODE == FULL || MODE == HZ;
  constexpr bool WRITE = MODE == BACK || MODE == GONLY;
  const int tid = threadIdx.x;
  const int s = m.x, n = m.y - m.x, sh = s & 1;
  const float* A_s = reinterpret_cast<const float*>(stage) + (size_t)sh * ROW;
  const int2* I_s = reinterpret_cast<const int2*>(stage + A_BYTES) + sh;
  const int* off_s = reinterpret_cast<const int*>(stage + A_BYTES + IDX_BYTES + CS_BYTES);
  const float* vinv_s = reinterpret_cast<const float*>(stage + A_BYTES + IDX_BYTES + CS_BYTES + OFF_BYTES);
  const bool staged = points_staged(m);
  const int qa = m.z & ~3;
  const bool act = tid < n;
  int c = 0, p = 0, lo = 0;
  float r[ROW];
  if (act) {
    const int2 cp = I_s[tid];
    c = cp.x;
    p = cp.y;
    lo = (staged ? off_s[p - qa] : __ldg(a.off + p)) - s;
    load_row(r, A_s + (size_t)tid * ROW);
    if (do_g) {
      float xv[6], t[3];
      load_x(xv, a, x_s, c);
      at_x(t, r, xv);
#pragma unroll
      for (int k = 0; k < 3; ++k) t_s[3 * tid + k] = t[k];
    }
  }
  if (do_g) __syncthreads();
  if (act && tid == lo) {
    const int hi = (staged ? off_s[p - qa + 1] : __ldg(a.off + p + 1)) - s;
    float sum[3] = {0.f, 0.f, 0.f}, vi[9], pin[3], g[3], z[3];
    if (do_g) {
#pragma unroll 4
      for (int j = lo; j < hi; ++j) {
#pragma unroll
        for (int k = 0; k < 3; ++k) sum[k] += t_s[3 * j + k];
      }
    }
    load_point<MODE>(vi, pin, a, p, staged ? vinv_s + 9 * (p - qa) : nullptr);
    point_g<MODE>(g, sum, pin);
    point_z<MODE>(z, vi, g);
    if (WRITE) {
#pragma unroll
      for (int k = 0; k < 3; ++k) a.pout[(size_t)3 * p + k] = z[k];
    }
    if (DO_H) {
#pragma unroll
      for (int k = 0; k < 3; ++k) t_s[3 * lo + k] = z[k];
    }
  }
  if (WRITE) empty_points<MODE>(a, m.z, m.w);
  if (!DO_H) return;
  __syncthreads();
  float w[6];
  if (act) {
    const float z[3] = {t_s[3 * lo], t_s[3 * lo + 1], t_s[3 * lo + 2]};
    a_z(w, r, z);
  }
  if (ACC != SMEM) {
    if (act) accumulate<ACC>(a, c, s + tid, w);
    return;
  }
  if (act) {
    float2* d = reinterpret_cast<float2*>(w_s + 6 * tid);
    d[0] = make_float2(w[0], w[1]);
    d[1] = make_float2(w[2], w[3]);
    d[2] = make_float2(w[4], w[5]);
  }
  __syncthreads();
  // camera order: a chunk-local observation in bits 0-14, bit 15 on the first of a camera's run
  const unsigned short* cs_s = reinterpret_cast<const unsigned short*>(stage + A_BYTES + IDX_BYTES) + (s & 7);
  const int head = act ? cs_s[tid] : 0;
  if (!(head & 0x8000)) return;
  const int j0 = head & 0x7fff;
  const int cam = I_s[j0].x;
  float acc[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[i] = w_s[6 * j0 + i];
  for (int q = tid + 1; q < n; ++q) {
    const int e = cs_s[q];
    if (e & 0x8000) break;
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[i] += w_s[6 * e + i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) h_s[6 * cam + i] += acc[i];
}

// A chunk above TILE observations: point by point from device memory,
// g by a fixed-order block sum.
template <int MODE, int ACC>
__device__ void big(const Args& a, int4 m, float* red, const float* x_s, float* h_s) {
  const bool do_g = MODE != HZ && a.x;
  constexpr bool DO_H = MODE == FULL || MODE == HZ;
  constexpr bool WRITE = MODE == BACK || MODE == GONLY;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int q = m.z; q < m.w; ++q) {
    const int lo = __ldg(a.off + q), hi = __ldg(a.off + q + 1);
    float sum[3] = {0.f, 0.f, 0.f}, vi[9], pin[3], g[3], z[3], r[ROW];
    if (do_g) {
      for (int o = lo + tid; o < hi; o += THREADS) {
        float xv[6], t[3];
        load_row_global(r, a.A + (size_t)o * ROW);
        load_x(xv, a, x_s, __ldg(&a.idx[o].x));
        at_x(t, r, xv);
#pragma unroll
        for (int k = 0; k < 3; ++k) sum[k] += t[k];
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
        for (int k = 0; k < 3; ++k) sum[k] += __shfl_down_sync(0xffffffffu, sum[k], d);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) red[3 * warp + k] = sum[k];
      }
      __syncthreads();
      if (tid == 0) {
        float acc[3] = {0.f, 0.f, 0.f};
        for (int w = 0; w < WARPS; ++w) {
#pragma unroll
          for (int k = 0; k < 3; ++k) acc[k] += red[3 * w + k];
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) red[3 * WARPS + k] = acc[k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 3; ++k) sum[k] = red[3 * WARPS + k];
    }
    load_point<MODE>(vi, pin, a, q);
    point_g<MODE>(g, sum, pin);
    point_z<MODE>(z, vi, g);
    if (WRITE && tid == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) a.pout[(size_t)3 * q + k] = z[k];
    }
    if (DO_H && ACC == SMEM) {
      // warp 0, 32 observations at a time, its lanes adding in turn: a fixed order
      for (int base = lo; warp == 0 && base < hi; base += 32) {
        const int o = base + lane;
        float w[6];
        int c = -1;
        if (o < hi) {
          load_row_global(r, a.A + (size_t)o * ROW);
          a_z(w, r, z);
          c = __ldg(&a.idx[o].x);
        }
        for (int l = 0; l < 32; ++l) {
          if (lane == l && c >= 0) {
#pragma unroll
            for (int i = 0; i < 6; ++i) h_s[6 * c + i] += w[i];
          }
          __syncwarp();
        }
      }
    } else if (DO_H) {
      for (int o = lo + tid; o < hi; o += THREADS) {
        float w[6];
        load_row_global(r, a.A + (size_t)o * ROW);
        a_z(w, r, z);
        accumulate<ACC>(a, __ldg(&a.idx[o].x), o, w);
      }
    }
    __syncthreads();  // red is read again by the next point
  }
}

template <int MODE, int ACC>
__global__ void __launch_bounds__(THREADS, 1) point_pass(const Args a) {
  constexpr bool DO_H = MODE == FULL || MODE == HZ;
  extern __shared__ __align__(128) unsigned char smem[];
  const Carve L = carve(a.stages, a.C, a.x_smem, a.h_smem);
  float* t_s = reinterpret_cast<float*>(smem + L.t);
  float* w_s = reinterpret_cast<float*>(smem + L.w);
  float* x_s = reinterpret_cast<float*>(smem + L.x);
  float* h_s = reinterpret_cast<float*>(smem + L.h);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int4* meta = reinterpret_cast<const int4*>(smem + L.meta);
  const uint32_t bar0 = saddr(smem + L.bar);
  const int tid = threadIdx.x, C6 = 6 * a.C;
  const long long k0 = (long long)blockIdx.x * a.K / gridDim.x;
  const long long k1 = (long long)(blockIdx.x + 1) * a.K / gridDim.x;

  if (tid == 0) {  // the first stages' loads go out before x is staged
    for (int s = 0; s < a.stages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < a.stages && k0 + j < k1; ++j) issue(a, smem, L, k0 + j, j);
  }
  if (a.x_smem)
    for (int i = tid; i < C6; i += THREADS) x_s[i] = a.mask ? a.x[i] * a.mask[i / 6] : a.x[i];
  if (a.h_smem)
    for (int i = tid; i < C6; i += THREADS) h_s[i] = 0.f;
  __syncthreads();

  for (long long k = k0; k < k1; ++k) {
    const int st = (int)((k - k0) % a.stages);
    mbar_wait(bar0 + 8 * st, (uint32_t)(((k - k0) / a.stages) & 1));
    const int4 m = meta[st];
    if (m.y - m.x <= TILE)
      tile<MODE, ACC>(a, smem + st * STAGE_BYTES, m, t_s, w_s, x_s, h_s);
    else
      big<MODE, ACC>(a, m, red, x_s, h_s);
    __syncthreads();  // the stage and t_s are free again
    if (tid == 0 && k + a.stages < k1) issue(a, smem, L, k + a.stages, st);
  }
  if (DO_H && ACC == SMEM) {
    __syncthreads();
    float* out = a.hout + (size_t)blockIdx.x * C6;
    for (int i = tid; i < C6; i += THREADS) out[i] = h_s[i];
  }
}

// The product's end for camera entry e of the sum h.
struct Finish {
  const float* ud;    // [C, 6, 6] or null
  const float* x;     // [C, 6] (with ud)
  const float* base;  // [C, 6] (without ud)
  const float* mask;  // [C] or null: out = h
  float* out;         // [C, 6]
};

__device__ __forceinline__ float finish(const Finish& f, int e, float h) {
  if (!f.mask) {
    f.out[e] = h;
    return h;
  }
  const int c = e / 6, i = e % 6;
  const float m = f.mask[c];
  float b;
  if (f.ud) {
    const float* u = f.ud + (size_t)36 * c + 6 * i;
    const float* x = f.x + (size_t)6 * c;
    b = u[0] * (x[0] * m);
#pragma unroll
    for (int j = 1; j < 6; ++j) b = fmaf(u[j], x[j] * m, b);
  } else {
    b = f.base[e];
  }
  const float out = (b - h) * m;
  f.out[e] = out;
  return out;
}

// The sum of v over the block, in a fixed order (a shuffle tree in each
// warp, then the warps in order), on thread 0. Ends with the block past a
// barrier; `red` holds a float a warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float sum = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) sum += red[w];
  return sum;
}

constexpr int REDUCE_THREADS = 256;

// h[e] = the partials summed in block order, then finished; with `dots`,
// each block's sum of x[e] * out[e] (the CG's p.Sp) into dots[block].
__global__ void __launch_bounds__(REDUCE_THREADS) reduce_parts(const float* __restrict__ parts, int nparts,
                                                               int C6, Finish f, float* dots) {
  __shared__ float red[REDUCE_THREADS / 32];
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  float dot = 0.f;
  if (e < C6) {
    float h = 0.f;
#pragma unroll 8
    for (int b = 0; b < nparts; ++b) h += __ldg(parts + (size_t)b * C6 + e);
    const float out = finish(f, e, h);
    if (dots) dot = __fmul_rn(f.x[e], out);
  }
  if (dots) {
    const float sum = block_sum(dot, red);
    if (threadIdx.x == 0) dots[blockIdx.x] = sum;
  }
}

constexpr int CG_THREADS = 1024;

// The CG's vector work between two products, in one block. step 1: alpha =
// rz / (p.Sp) (the reduce's dot partials summed in order; 0 where |p.Sp| <=
// 1e-30), x += alpha p, r -= alpha Sp, z = mask Minv r, rz' = r.z, beta =
// rz' / rz (0 where |rz| <= 1e-30), p = z + beta p, rz = rz'. step 0 starts
// the CG from r (the right-hand side): x = 0, z = mask Minv r, p = z,
// rz = r.z. Products and sums outside Minv r round as separate operations
// (no fused multiply-add), as PyTorch's do; the sums take a fixed order.
__global__ void __launch_bounds__(CG_THREADS) cg_update(int step, int C6, const float* __restrict__ sp,
                                                        const float* __restrict__ dots, int ndots,
                                                        const float* __restrict__ minv,
                                                        const float* __restrict__ mask, float* x, float* r,
                                                        float* z, float* p, float* rz) {
  __shared__ float red[CG_THREADS / 32];
  __shared__ float scal[2];  // alpha, beta
  const int tid = threadIdx.x;
  const float rz0 = rz[0];  // every thread reads it before block_sum's barrier; thread 0 writes after
  if (step) {
    if (tid == 0) {
      float d = 0.f;
      for (int b = 0; b < ndots; ++b) d = __fadd_rn(d, dots[b]);
      scal[0] = fabsf(d) > 1e-30f ? __fdiv_rn(rz0, d) : 0.f;
    }
    __syncthreads();
    const float alpha = scal[0];
    for (int e = tid; e < C6; e += CG_THREADS) {
      x[e] = __fadd_rn(x[e], __fmul_rn(alpha, p[e]));
      r[e] = __fsub_rn(r[e], __fmul_rn(alpha, sp[e]));
    }
  } else {
    for (int e = tid; e < C6; e += CG_THREADS) x[e] = 0.f;
  }
  __syncthreads();  // r whole before a camera's rows read it
  float part = 0.f;
  for (int e = tid; e < C6; e += CG_THREADS) {
    const int c = e / 6, i = e - 6 * c;
    const float* M = minv + (size_t)36 * c + 6 * i;
    const float* rc = r + (size_t)6 * c;
    float v = M[0] * rc[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) v = fmaf(M[j], rc[j], v);
    v = __fmul_rn(v, mask[c]);
    z[e] = v;
    part = __fadd_rn(part, __fmul_rn(r[e], v));
  }
  const float rz1 = block_sum(part, red);
  if (tid == 0) {
    scal[1] = step && fabsf(rz0) > 1e-30f ? __fdiv_rn(rz1, rz0) : 0.f;
    rz[0] = rz1;
  }
  __syncthreads();
  const float beta = scal[1];
  for (int e = tid; e < C6; e += CG_THREADS) p[e] = step ? __fadd_rn(z[e], __fmul_rn(beta, p[e])) : z[e];
}

constexpr int ORDERED_THREADS = 128;

// h [C, 6], one block a camera: its observations' products in camera-major
// order (point-major within a camera), strided over the threads, then a
// fixed tree. reduce_parts finishes h.
__global__ void reduce_ordered(const float* __restrict__ wz, const int* __restrict__ cidx,
                               const int* __restrict__ coff, float* __restrict__ h) {
  __shared__ float red[ORDERED_THREADS][6];
  const int c = blockIdx.x, tid = threadIdx.x;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = coff[c] + tid; j < coff[c + 1]; j += ORDERED_THREADS) {
    const float* w = wz + (size_t)6 * cidx[j];
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[i] += w[i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) red[tid][i] = acc[i];
  __syncthreads();
  for (int d = ORDERED_THREADS / 2; d > 0; d >>= 1) {
    if (tid < d) {
#pragma unroll
      for (int i = 0; i < 6; ++i) red[tid][i] += red[tid + d][i];
    }
    __syncthreads();
  }
  if (tid < 6) h[6 * c + tid] = red[0][tid];
}

int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return -1;
  return bytes;
}

template <int MODE, int ACC>
cudaError_t launch_pass(const Args& a, int blocks, cudaStream_t st) {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int bytes = carve(a.stages, a.C, a.x_smem, a.h_smem).total;
  if (dev >= 64 || bytes > smem_optin()) return cudaErrorInvalidValue;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(point_pass<MODE, ACC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_optin());
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  point_pass<MODE, ACC><<<blocks, THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(int acc, const Args& a, int blocks, cudaStream_t st) {
  switch (acc) {
    case SMEM: return launch_pass<MODE, SMEM>(a, blocks, st);
    case GLOBAL: return launch_pass<MODE, GLOBAL>(a, blocks, st);
    default: return launch_pass<MODE, ORDERED>(a, blocks, st);
  }
}

}  // namespace

extern "C" {

// The shared memory a block may opt into on the current device (-1 on error).
int schur_cg_smem_optin(void) { return smem_optin(); }

// The shared memory a pass takes with `stages` ring stages and x and/or h
// of C cameras in shared memory.
int schur_cg_smem_bytes(int stages, int C, int x_smem, int h_smem) {
  return carve(stages, C, x_smem, h_smem).total;
}

// One point-major pass (mode 0 FULL, 1 HZ, 2 BACK, 3 GONLY; acc 0 SMEM,
// 1 GLOBAL, 2 ORDERED) over `blocks` blocks; every array contiguous, of
// the shapes in Args; x null only in BACK. x_smem stages x in shared
// memory (modes that read x); the SMEM accumulator keeps h there (modes
// that make h). Returns a cudaError_t (0 = launched).
int schur_cg_pass_launch(int mode, int acc, const float* A, const int* idx, const short* cs,
                         const int* off, const int* chunk_obs, const int* chunk_pt, int K, const float* x,
                         const float* mask, const float* vinv, const float* pin, float* pout,
                         float* hout, int C, int blocks, int stages, int x_smem, void* stream) {
  if (mode < FULL || mode > GONLY || acc < SMEM || acc > ORDERED || K < 1 || C < 0 ||
      blocks < 1 || blocks > K || stages < 1 || stages > MAX_STAGES || (acc == SMEM && !cs) ||
      (!x && (mode == FULL || mode == GONLY)))
    return (int)cudaErrorInvalidValue;
  const bool reads_x = mode != HZ && x, makes_h = mode == FULL || mode == HZ;
  Args a{reinterpret_cast<const float*>(A), reinterpret_cast<const int2*>(idx), cs, off, chunk_obs,
         chunk_pt, x, mask, vinv, pin, pout, hout, K, C, stages,
         reads_x && x_smem ? 1 : 0, makes_h && acc == SMEM ? 1 : 0};
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case FULL: return (int)launch_mode<FULL>(acc, a, blocks, st);
    case HZ: return (int)launch_mode<HZ>(acc, a, blocks, st);
    case BACK: return (int)launch_mode<BACK>(acc, a, blocks, st);
    default: return (int)launch_mode<GONLY>(acc, a, blocks, st);
  }
}

// ordered = 0: out [C, 6] from `nparts` partials [nparts, C, 6], summed
// in block order, then out = h (mask null), mask * (ud (x * mask) - h)
// (ud given) or mask * (base - h); with `dots` (ud given), the sums of
// x * out over each of the schur_cg_reduce_blocks(C) blocks.
// ordered = 1: out = h [C, 6] from the ordered products wz [O, 6] with
// the camera-major order cidx [O] and camera offsets coff [C + 1]; no
// finish (mask, ud, base and dots null).
int schur_cg_reduce_launch(int ordered, const float* parts, int nparts, const int* cidx,
                           const int* coff, int C, const float* ud, const float* x,
                           const float* base, const float* mask, float* out, float* dots,
                           void* stream) {
  if (C < 0 || (!ordered && nparts < 1) || (mask && !ud && !base) || (dots && !ud) ||
      (ordered && (mask || dots || !cidx || !coff)))
    return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  Finish f{ud, x, base, mask, out};
  cudaStream_t st = (cudaStream_t)stream;
  if (ordered)
    reduce_ordered<<<C, ORDERED_THREADS, 0, st>>>(parts, cidx, coff, out);
  else
    reduce_parts<<<(6 * C + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, st>>>(
        parts, nparts, 6 * C, f, dots);
  return (int)cudaGetLastError();
}

// Blocks of a partials reduce over C cameras: the dot partials it writes.
int schur_cg_reduce_blocks(int C) { return (6 * C + REDUCE_THREADS - 1) / REDUCE_THREADS; }

// One CG update (step 1) or start (step 0) over C cameras in one block:
// sp, x, r, z, p [C, 6], minv [C, 6, 6], mask [C], rz [1], dots [ndots]
// (step 1), all contiguous f32.
int schur_cg_update_launch(int step, int C, const float* sp, const float* dots, int ndots,
                           const float* minv, const float* mask, float* x, float* r, float* z,
                           float* p, float* rz, void* stream) {
  if (C < 0 || (step && (!sp || !dots || ndots < 1))) return (int)cudaErrorInvalidValue;
  cg_update<<<1, CG_THREADS, 0, (cudaStream_t)stream>>>(step, 6 * C, sp, dots, ndots, minv, mask, x, r, z,
                                                        p, rz);
  return (int)cudaGetLastError();
}

const char* schur_cg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
