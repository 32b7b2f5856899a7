// FAST segment-test score + 3x3 non-maximum suppression, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of opencv_tpu/ops/pallas/fast_kernel.py:
//   K1 `_fast_nms_strip_kernel` (score, threshold, border cut, 3x3 NMS) and
//   K2 `_fast_strip_kernel` (score only), as one template: NMS=false is K2.
//
// Score of a pixel p with ring taps t_i (ring of N = 16, 12 or 8 taps):
//   V(p) = max( max_s min_{j<arc} (t_{s+j} - p), max_s min_{j<arc} -(t_{s+j} - p) )
// Every operation is an f32 subtract, negate, min or max, so the kernel
// equals the plain PyTorch version (ops/cuda/fast_kernel.py) bit for bit:
// t - p gives +0 for equal taps and its negation -0, so among finite
// values no two distinct bit patterns compare equal inside one min or
// max, and the order of the mins and maxes does not change the result.
//
// Bound on an H100 SXM: operations and bytes, about equally. The least
// work known is this kernel's 121 f32 operations per pixel (112 for the
// score, as below, then the threshold and 8 NMS compares); the 8 ORB
// levels of a 480x640 frame hold 0.95 M pixels: 0.0034 ms at 128 f32
// min/max/add per clock per SM (132 SMs, 1980 MHz), and 0.0034 ms for
// their 11.4 MB of reads and writes at 3.35 TB/s.
//
// Design:
// - The arc is a template parameter for the three default (ring, arc)
//   pairs (16/9, 12/7, 8/5); other arcs take a generic instantiation with
//   a runtime arc. For a compiled-in arc, starts s and s+1 (s even) share
//   a window of arc-1 taps W, and max(min(W, d_s), min(W, d_{s+arc})) =
//   min(W, max(d_s, d_{s+arc})); so the kernel takes the arc-1 minima
//   at the odd starts only, by doubling (min2 -> min4 -> min8 for arc 9),
//   then one max and one min per pair and a tree over the pairs: 47
//   min/max per sign at arc 9, against 79 for the minima of all 16
//   windows. The window maxima of the same differences give the dark side
//   as -(min_s max_j d): 112 operations per pixel in all.
// - The ring's offsets are compile-time constants, so each tap is one
//   shared-memory load at an immediate offset.
// - A block of 256 threads computes a 32x32 output tile. It stages the
//   tile with a halo of the ring radius (+1 for NMS) in shared memory, all
//   of a thread's loads issued before the first is stored, scores the
//   tile plus a 1-pixel ring (34x34, each pixel once, 13 % more than the
//   tile), thresholds it and cuts the global border (the ring radius)
//   BEFORE NMS, then applies NMS with the JAX tie-break: `>` toward
//   neighbours that come earlier in row-major order, `>=` toward later
//   ones. Taps outside the image read 0; those pixels lie in the cut
//   border.
// - One launch covers every level of a pyramid: a table of up to 16
//   levels (pointers, H, W, first tile) travels in the kernel's argument
//   struct and blockIdx.x walks the tiles of all levels.
//
// The first design (32x8 tiles, one launch per level, a runtime arc that
// kept the 16 x 15 guarded minima of every start, and the 34x10 score
// ring in two passes of 256 threads) took 0.1119 ms for the 8 levels of a
// 480x640 frame; this design takes 0.0166 ms in one launch (NVIDIA H100 80GB
// HBM3, 700.00 W, chip_smoke.py; per-level times in PERF.md).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE_W = 32;  // output tile: TILE_W x TILE_H pixels
constexpr int TILE_H = 32;
constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;
constexpr float NEG = -1e9f;

struct Level {
  const float* img;
  float* score;
  float* nms;
  int h, w, tiles_x, first_tile;
};

struct Levels {
  Level l[kMaxLevels];
  int n;
};

// Bresenham rings (dx, dy), clockwise from 12 o'clock: the CIRCLE16/12/8
// tables of opencv_tpu/ops/fast.py. Tap i's offset is a constant once the
// loop over taps is unrolled, so every tap is one shared-memory load at an
// immediate offset.
template <int N>
__host__ __device__ constexpr int ring_dx(int i) {
  constexpr int d16[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int d12[12] = {0, 1, 2, 2, 2, 1, 0, -1, -2, -2, -2, -1};
  constexpr int d8[8] = {0, 1, 1, 1, 0, -1, -1, -1};
  return N == 16 ? d16[i] : (N == 12 ? d12[i] : d8[i]);
}
template <int N>
__host__ __device__ constexpr int ring_dy(int i) {
  constexpr int d16[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int d12[12] = {-2, -2, -1, 0, 1, 2, 2, 2, 1, 0, -1, -2};
  constexpr int d8[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
  return N == 16 ? d16[i] : (N == 12 ? d12[i] : d8[i]);
}

// level i of the table, read at compile-time offsets (a runtime index
// into a kernel parameter would copy the whole table to local memory)
__device__ __forceinline__ Level level_at(const Levels& lv, int i) {
  static_assert(kMaxLevels == 16, "level_at lists 16 levels");
  switch (i) {
#define FAST_LEVEL(k) \
  case k: return lv.l[k];
    FAST_LEVEL(1) FAST_LEVEL(2) FAST_LEVEL(3) FAST_LEVEL(4) FAST_LEVEL(5)
    FAST_LEVEL(6) FAST_LEVEL(7) FAST_LEVEL(8) FAST_LEVEL(9) FAST_LEVEL(10)
    FAST_LEVEL(11) FAST_LEVEL(12) FAST_LEVEL(13) FAST_LEVEL(14) FAST_LEVEL(15)
#undef FAST_LEVEL
    default: return lv.l[0];
  }
}

template <int N>
__host__ __device__ constexpr int ring_radius() { return N == 16 ? 3 : (N == 12 ? 2 : 1); }

template <int N>
__host__ __device__ constexpr int default_arc() { return N == 16 ? 9 : (N == 12 ? 7 : 5); }

// cyclic windows of length L over d[N]: out[i] = min (MAX: max) of
// d[i..i+L-1], by binary decomposition of L (`pw` holds windows of 2^b,
// `out` the windows of the bits taken so far); the compiler keeps only
// the entries a caller reads
template <int N, int L, bool MAX>
__device__ __forceinline__ void windows(const float (&d)[N], float (&out)[N]) {
  float pw[N];
  int len = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) pw[i] = d[i];
#pragma unroll
  for (int b = 0; (1 << b) <= L; ++b) {
    if (L & (1 << b)) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float v = pw[(i + len) % N];
        out[i] = len == 0 ? v : (MAX ? fmaxf(out[i], v) : fminf(out[i], v));
      }
      len += 1 << b;
    }
    if ((2 << b) <= L) {
      float nx[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float v = pw[(i + (1 << b)) % N];
        nx[i] = MAX ? fmaxf(pw[i], v) : fminf(pw[i], v);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) pw[i] = nx[i];
    }
  }
}

// max over the N starts s of the min over d[s..s+ARC-1] (MAX: the min
// over starts of the max over windows). Starts s and s+1 (s even) share
// the ARC-1 window W at s+1, and max(min(W, d[s]), min(W, d[s+ARC])) =
// min(W, max(d[s], d[s+ARC])): windows of ARC-1 at the odd starts only,
// then one max and one min per pair, then a tree over the N/2 pairs
template <int N, int ARC, bool MAX>
__device__ __forceinline__ float arc_extreme(const float (&d)[N]) {
  static_assert(N % 2 == 0 && ARC >= 2, "pairs of starts");
  float w[N], m[N / 2];
  windows<N, ARC - 1, MAX>(d, w);
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const float e = d[2 * k], f = d[(2 * k + ARC) % N];
    m[k] = MAX ? fmaxf(w[2 * k + 1], fminf(e, f)) : fminf(w[2 * k + 1], fmaxf(e, f));
  }
#pragma unroll
  for (int step = 1; step < N / 2; step *= 2) {
#pragma unroll
    for (int k = 0; k + step < N / 2; k += 2 * step)
      m[k] = MAX ? fminf(m[k], m[k + step]) : fmaxf(m[k], m[k + step]);
  }
  return m[0];
}

// score of the pixel at q (in a shared tile of row stride TW; the ring
// lies inside the tile). ARC = 0: the runtime arc `arc`.
template <int N, int ARC, int TW>
__device__ __forceinline__ float arc_score(const float* q, int arc) {
  const float c = q[0];
  float d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = q[ring_dy<N>(i) * TW + ring_dx<N>(i)] - c;
  if constexpr (ARC > 0) {
    const float vb = arc_extreme<N, ARC, false>(d);   // max_s min_j d
    const float vd = -arc_extreme<N, ARC, true>(d);   // max_s min_j -d
    return fmaxf(vb, vd);
  } else {
    float vb = -INFINITY, vd = -INFINITY;
#pragma unroll
    for (int s = 0; s < N; ++s) {
      float mb = d[s], md = -d[s];
#pragma unroll
      for (int j = 1; j < N; ++j) {
        if (j < arc) {
          const float v = d[(s + j) % N];
          mb = fminf(mb, v);
          md = fminf(md, -v);
        }
      }
      vb = fmaxf(vb, mb);
      vd = fmaxf(vd, md);
    }
    return fmaxf(vb, vd);
  }
}

template <int N, int ARC, bool NMS>
__global__ void __launch_bounds__(kThreads)
fast_kernel(Levels lv, float threshold, int arc) {
  constexpr int R = ring_radius<N>();
  constexpr int HALO = NMS ? R + 1 : R;
  constexpr int TW = TILE_W + 2 * HALO, TH = TILE_H + 2 * HALO;
  constexpr int EW = TILE_W + 2, EH = TILE_H + 2;  // NMS score region: the tile plus a 1-pixel ring
  __shared__ float tile[TH * TW];
  __shared__ float masked[NMS ? EH * EW : 1];

  // this block's level: the levels' first tiles increase
  int li = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) li += i < lv.n && (int)blockIdx.x >= lv.l[i].first_tile;
  const Level L = level_at(lv, li);
  const int h = L.h, w = L.w;
  const int t = blockIdx.x - L.first_tile;
  const int ty = t / L.tiles_x;
  const int y0 = ty * TILE_H, x0 = (t - ty * L.tiles_x) * TILE_W;
  const int tid = threadIdx.x;

  // the tile and its halo, every load issued before the first store
  {
    constexpr int B = (TH * TW + kThreads - 1) / kThreads;
    float v[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int k = tid + i * kThreads;
      const int yy = k / TW, xx = k - yy * TW;
      const int gy = y0 - HALO + yy, gx = x0 - HALO + xx;
      v[i] = (k < TH * TW && gy >= 0 && gy < h && gx >= 0 && gx < w)
                 ? __ldg(L.img + (size_t)gy * w + gx) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < B; ++i)
      if (tid + i * kThreads < TH * TW) tile[tid + i * kThreads] = v[i];
  }
  __syncthreads();

  const int tx = tid % TILE_W;
  if constexpr (!NMS) {
#pragma unroll
    for (int i = 0; i < TILE_W * TILE_H / kThreads; ++i) {
      const int oy = tid / TILE_W + i * (kThreads / TILE_W);
      const int gy = y0 + oy, gx = x0 + tx;
      if (gy < h && gx < w) {
        const bool inside = gy >= R && gy < h - R && gx >= R && gx < w - R;
        const float s = arc_score<N, ARC, TW>(tile + (oy + HALO) * TW + tx + HALO, arc);
        L.score[(size_t)gy * w + gx] = inside ? s : NEG;
      }
    }
    return;
  }

  // score on the tile plus a 1-pixel ring, each pixel once, thresholded
  // and border-cut
  for (int k = tid; k < EH * EW; k += kThreads) {
    const int ey = k / EW, ex = k - ey * EW;
    const int py = y0 - 1 + ey, px = x0 - 1 + ex;
    const float s = arc_score<N, ARC, TW>(tile + (ey + HALO - 1) * TW + ex + HALO - 1, arc);
    const bool inside = py >= R && py < h - R && px >= R && px < w - R;
    masked[k] = (inside && s > threshold) ? s : NEG;
    if (ey >= 1 && ey <= TILE_H && ex >= 1 && ex <= TILE_W && py < h && px < w)
      L.score[(size_t)py * w + px] = inside ? s : NEG;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TILE_W * TILE_H / kThreads; ++i) {
    const int oy = tid / TILE_W + i * (kThreads / TILE_W);
    const int gy = y0 + oy, gx = x0 + tx;
    if (gy >= h || gx >= w) continue;
    const float* m = masked + (oy + 1) * EW + tx + 1;
    const float cur = m[0];
    bool keep = cur > NEG;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const float nb = m[dy * EW + dx];
        const bool earlier = dy < 0 || (dy == 0 && dx < 0);
        keep = keep && (earlier ? (cur > nb) : (cur >= nb));
      }
    }
    L.nms[(size_t)gy * w + gx] = keep ? cur : NEG;
  }
}

template <int N, int ARC>
cudaError_t launch_arc(const Levels& lv, int tiles, float threshold, int arc, int do_nms,
                       cudaStream_t s) {
  if (do_nms)
    fast_kernel<N, ARC, true><<<tiles, kThreads, 0, s>>>(lv, threshold, arc);
  else
    fast_kernel<N, ARC, false><<<tiles, kThreads, 0, s>>>(lv, threshold, arc);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch(const Levels& lv, int tiles, float threshold, int arc, int do_nms,
                   cudaStream_t s) {
  return arc == default_arc<N>() ? launch_arc<N, default_arc<N>()>(lv, tiles, threshold, arc, do_nms, s)
                                 : launch_arc<N, 0>(lv, tiles, threshold, arc, do_nms, s);
}

}  // namespace

extern "C" {

// One launch over n_levels (1 to 16) images: imgs[i], scores[i] (and
// nmss[i] when do_nms) are contiguous f32 [hs[i], ws[i]] on the current
// device. Returns a cudaError_t (0 = launched).
int fast_launch_levels(int n_levels, const float* const* imgs, float* const* scores,
                       float* const* nmss, const int* hs, const int* ws, float threshold,
                       int arc, int pattern, int do_nms, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || arc < 1 || arc > pattern)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  long long tiles = 0;
  for (int i = 0; i < n_levels; ++i) {
    if (hs[i] < 1 || ws[i] < 1 || imgs[i] == nullptr || scores[i] == nullptr ||
        (do_nms && nmss[i] == nullptr))
      return (int)cudaErrorInvalidValue;
    const int tx = (ws[i] + TILE_W - 1) / TILE_W, ty = (hs[i] + TILE_H - 1) / TILE_H;
    lv.l[i] = Level{imgs[i], scores[i], do_nms ? nmss[i] : nullptr, hs[i], ws[i], tx, (int)tiles};
    tiles += (long long)tx * ty;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  lv.n = n_levels;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pattern) {
    case 16: return (int)launch<16>(lv, (int)tiles, threshold, arc, do_nms, s);
    case 12: return (int)launch<12>(lv, (int)tiles, threshold, arc, do_nms, s);
    case 8: return (int)launch<8>(lv, (int)tiles, threshold, arc, do_nms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fast_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
