// FAST segment-test score + 3x3 non-maximum suppression, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of opencv_tpu/ops/pallas/fast_kernel.py:
//   K1 `_fast_nms_strip_kernel` (score, threshold, border cut, 3x3 NMS) and
//   K2 `_fast_strip_kernel` (score only), as one template: NMS=false is K2.
//
// Score of a pixel p with ring taps t_i (ring of N = 16, 12 or 8 taps):
//   V(p) = max( max_s min_{j<arc} (t_{s+j} - p), max_s min_{j<arc} -(t_{s+j} - p) )
// Every operation is an f32 subtract, negate, min or max, so the kernel
// equals the plain PyTorch version (ops/cuda/fast_kernel.py) bit for bit.
//
// Design: one thread per output pixel. A block of 32x8 threads stages its
// input tile in shared memory with a 4-pixel halo (ring radius 3 + 1 for
// NMS), computes the score on the tile plus a 1-pixel ring into shared
// memory, thresholds it, cuts the global border (the ring radius) BEFORE
// NMS, then applies NMS with the JAX tie-break: `>` toward neighbours that
// come earlier in row-major order, `>=` toward later ones. Taps outside the
// image read 0; those pixels lie in the cut border.
//
// Bound on an H100 SXM at 480x640, all 8 ORB levels: about 12 MB moved
// (one f32 read, two f32 writes per pixel), a few microseconds at
// 3.35 TB/s; the least work, about 185 f32 subtract/min/max per pixel
// (arc-9 window minima by doubling), takes about as long at the FP32
// add rate of 128 per clock per SM. The launch per level costs more than
// the work at these sizes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int HALO = 4;
constexpr int TW = BX + 2 * HALO;
constexpr int TH = BY + 2 * HALO;
constexpr int EW = BX + 2;  // score region: tile plus a 1-pixel ring
constexpr int EH = BY + 2;
constexpr float NEG = -1e9f;

// Bresenham rings (dx, dy), clockwise from 12 o'clock: the CIRCLE16/12/8
// tables of opencv_tpu/ops/fast.py.
__constant__ int8_t kRing16[16][2] = {
    {0, -3}, {1, -3}, {2, -2}, {3, -1}, {3, 0}, {3, 1}, {2, 2}, {1, 3},
    {0, 3}, {-1, 3}, {-2, 2}, {-3, 1}, {-3, 0}, {-3, -1}, {-2, -2}, {-1, -3}};
__constant__ int8_t kRing12[12][2] = {
    {0, -2}, {1, -2}, {2, -1}, {2, 0}, {2, 1}, {1, 2},
    {0, 2}, {-1, 2}, {-2, 1}, {-2, 0}, {-2, -1}, {-1, -2}};
__constant__ int8_t kRing8[8][2] = {
    {0, -1}, {1, -1}, {1, 0}, {1, 1}, {0, 1}, {-1, 1}, {-1, 0}, {-1, -1}};

template <int N>
__device__ __forceinline__ int ring_dx(int i) {
  return N == 16 ? kRing16[i][0] : (N == 12 ? kRing12[i][0] : kRing8[i][0]);
}
template <int N>
__device__ __forceinline__ int ring_dy(int i) {
  return N == 16 ? kRing16[i][1] : (N == 12 ? kRing12[i][1] : kRing8[i][1]);
}

// score at tile coordinate (ty, tx); the ring lies inside the tile
template <int N>
__device__ __forceinline__ float arc_score(const float (*tile)[TW], int ty, int tx, int arc) {
  const float c = tile[ty][tx];
  float d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = tile[ty + ring_dy<N>(i)][tx + ring_dx<N>(i)] - c;
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

template <int N, bool NMS>
__global__ void __launch_bounds__(BX * BY)
fast_kernel(const float* __restrict__ img, float* __restrict__ score,
            float* __restrict__ nms, int h, int w, float threshold, int arc) {
  constexpr int R = N == 16 ? 3 : (N == 12 ? 2 : 1);
  __shared__ float tile[TH][TW];
  __shared__ float masked[EH][EW];

  const int x0 = blockIdx.x * BX;
  const int y0 = blockIdx.y * BY;
  const int tid = threadIdx.y * BX + threadIdx.x;

  for (int k = tid; k < TH * TW; k += BX * BY) {
    const int ty = k / TW, tx = k % TW;
    const int gy = y0 - HALO + ty, gx = x0 - HALO + tx;
    tile[ty][tx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[(size_t)gy * w + gx] : 0.0f;
  }
  __syncthreads();

  const int gy = y0 + threadIdx.y, gx = x0 + threadIdx.x;
  const bool in_img = gy < h && gx < w;

  if (!NMS) {
    if (in_img) {
      const bool inside = gy >= R && gy < h - R && gx >= R && gx < w - R;
      const float s = arc_score<N>(tile, threadIdx.y + HALO, threadIdx.x + HALO, arc);
      score[(size_t)gy * w + gx] = inside ? s : NEG;
    }
    return;
  }

  // score on the tile plus a 1-pixel ring, thresholded and border-cut
  for (int k = tid; k < EH * EW; k += BX * BY) {
    const int ey = k / EW, ex = k % EW;
    const int py = y0 - 1 + ey, px = x0 - 1 + ex;
    const float s = arc_score<N>(tile, ey + HALO - 1, ex + HALO - 1, arc);
    const bool inside = py >= R && py < h - R && px >= R && px < w - R;
    masked[ey][ex] = (inside && s > threshold) ? s : NEG;
    if (ey >= 1 && ey <= BY && ex >= 1 && ex <= BX && py < h && px < w)
      score[(size_t)py * w + px] = inside ? s : NEG;
  }
  __syncthreads();

  if (!in_img) return;
  const int ey = threadIdx.y + 1, ex = threadIdx.x + 1;
  const float cur = masked[ey][ex];
  bool keep = cur > NEG;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float nb = masked[ey + dy][ex + dx];
      const bool earlier = dy < 0 || (dy == 0 && dx < 0);
      keep = keep && (earlier ? (cur > nb) : (cur >= nb));
    }
  }
  nms[(size_t)gy * w + gx] = keep ? cur : NEG;
}

template <int N>
cudaError_t launch(const float* img, float* score, float* nms, int h, int w,
                   float threshold, int arc, int do_nms, cudaStream_t stream) {
  const dim3 block(BX, BY);
  const dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY);
  if (do_nms)
    fast_kernel<N, true><<<grid, block, 0, stream>>>(img, score, nms, h, w, threshold, arc);
  else
    fast_kernel<N, false><<<grid, block, 0, stream>>>(img, score, nms, h, w, threshold, arc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// img, score (and nms when do_nms) are contiguous f32 [h, w] on the
// current device. Returns a cudaError_t (0 = launched).
int fast_launch(const float* img, float* score, float* nms, int h, int w, float threshold,
                int arc, int pattern, int do_nms, void* stream) {
  if (h < 1 || w < 1 || (h + BY - 1) / BY > 65535 || arc < 1 || arc > pattern)
    return (int)cudaErrorInvalidValue;
  if (do_nms && nms == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pattern) {
    case 16: return (int)launch<16>(img, score, nms, h, w, threshold, arc, do_nms, s);
    case 12: return (int)launch<12>(img, score, nms, h, w, threshold, arc, do_nms, s);
    case 8: return (int)launch<8>(img, score, nms, h, w, threshold, arc, do_nms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fast_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
