// Bilinear LK window sampler, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of opencv_tpu/ops/pallas/lk_sample.py:
//   K4 `_tmpl_kernel` (sample_channels_pallas and its wrappers
//      sample_templates_pallas / sample_single_pallas): win x win bilinear
//      windows of C channels around N points, a tap counting only when its
//      source pixel lies in [0,H) x [0,W); and
//   K5 `_sample_kernel` (sample_windows_pallas): one channel, rows and
//      columns clamped to the image edge, interpolated rows first (its
//      banded two-tap products), as the CLAMP mode of the same kernel.
//
// For a point p the window origin is s = p - win/2 (non-finite -> -1e6,
// then clamped to [-1e6, 1e6]), i0 = floor(s), f = s - i0, and output
// (r, c) of channel k is, in this order of operations,
//   K4: ((t00*m00 + t01*m01) + t10*m10) + t11*m11,
//       m00 = valid(row i0y+r, col i0x+c) ? (1-fy)*(1-fx) : 0, ...
//   K5: (1-fx)*((1-fy)*t00 + fy*t10) + fx*((1-fy)*t01 + fy*t11)
// with tij the pixel at (row i0y+r+i, col i0x+c+j), its indices clamped
// to the image. Every multiply and add is an __fmul_rn / __fadd_rn, which
// nvcc never contracts into an FMA, so the result equals the plain
// PyTorch version (ops/cuda/lk_sample.py) bit for bit.
//
// Design: one block per point; its threads walk the C*win*win outputs in
// row-major order, so each warp writes consecutive addresses. The taps
// are read straight from the level images through L2 (a 480x640 level of
// three channels is 3.7 MB; the L2 holds 50 MB). The TPU kernel's aligned
// tile DMA, lane rotations and two-slot prefetch served Mosaic's layout
// rules and the TPU's sequential grid and have no counterpart here.
//
// Bound on an H100 SXM: bytes. At the engine's track set (N = 2000, C = 3,
// win 21) the call writes 10.6 MB and reads 3.7 MB of level, about 4.3 us
// at 3.35 TB/s; its 7 f32 operations per output take about 0.6 us at the
// FP32 rate. The LK path calls it three times per frame pair, so launch
// latency, not either bound, is what it costs at these sizes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;

struct Channels {
  const float* p[kMaxChannels];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// window origin along one axis: (integer part, fraction)
__device__ __forceinline__ void origin(float p, int half, int* i0, float* f) {
  float s = __fsub_rn(p, (float)half);
  if (!isfinite(s)) s = -1e6f;
  s = fminf(fmaxf(s, -1e6f), 1e6f);
  const float fl = floorf(s);
  *i0 = (int)fl;
  *f = __fsub_rn(s, fl);
}

template <bool CLAMP>
__global__ void __launch_bounds__(kThreads)
lk_sample_kernel(Channels ch, int n_ch, const float* __restrict__ pts, float* __restrict__ out,
                 int n, int h, int w, int win) {
  const int pt = blockIdx.x;
  int ix0, iy0;
  float fx, fy;
  origin(pts[2 * pt], win / 2, &ix0, &fx);
  origin(pts[2 * pt + 1], win / 2, &iy0, &fy);
  const float gy = __fsub_rn(1.0f, fy);
  const float gx = __fsub_rn(1.0f, fx);
  const float w00 = __fmul_rn(gy, gx), w01 = __fmul_rn(gy, fx);
  const float w10 = __fmul_rn(fy, gx), w11 = __fmul_rn(fy, fx);
  const int area = win * win;

  for (int k = threadIdx.x; k < n_ch * area; k += kThreads) {
    const int c = k / area;
    const int rem = k - c * area;
    const int r = rem / win;
    const int col = rem - r * win;
    const int y0 = iy0 + r, x0 = ix0 + col;
    const float* img = ch.p[c];
    const int ry0 = clampi(y0, 0, h - 1), ry1 = clampi(y0 + 1, 0, h - 1);
    const int cx0 = clampi(x0, 0, w - 1), cx1 = clampi(x0 + 1, 0, w - 1);
    const float t00 = __ldg(img + (size_t)ry0 * w + cx0);
    const float t01 = __ldg(img + (size_t)ry0 * w + cx1);
    const float t10 = __ldg(img + (size_t)ry1 * w + cx0);
    const float t11 = __ldg(img + (size_t)ry1 * w + cx1);
    float v;
    if (CLAMP) {
      const float a = __fadd_rn(__fmul_rn(gy, t00), __fmul_rn(fy, t10));
      const float b = __fadd_rn(__fmul_rn(gy, t01), __fmul_rn(fy, t11));
      v = __fadd_rn(__fmul_rn(gx, a), __fmul_rn(fx, b));
    } else {
      const bool vr0 = y0 >= 0 && y0 <= h - 1, vr1 = y0 + 1 >= 0 && y0 + 1 <= h - 1;
      const bool vc0 = x0 >= 0 && x0 <= w - 1, vc1 = x0 + 1 >= 0 && x0 + 1 <= w - 1;
      const float m00 = (vr0 && vc0) ? w00 : 0.0f, m01 = (vr0 && vc1) ? w01 : 0.0f;
      const float m10 = (vr1 && vc0) ? w10 : 0.0f, m11 = (vr1 && vc1) ? w11 : 0.0f;
      v = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t00, m00), __fmul_rn(t01, m01)),
                              __fmul_rn(t10, m10)),
                    __fmul_rn(t11, m11));
    }
    // out is [C, N, win, win]
    out[((size_t)c * n + pt) * area + rem] = v;
  }
}

}  // namespace

extern "C" {

// c0..c3: the channels, contiguous f32 [h, w] each (unused ones may be
// null); pts: contiguous f32 [n, 2] (x, y); out: contiguous f32
// [n_ch, n, win, win]. Returns a cudaError_t (0 = launched).
int lk_sample_launch(const float* c0, const float* c1, const float* c2, const float* c3,
                     int n_ch, const float* pts, float* out, int n, int h, int w, int win,
                     int clamp, void* stream) {
  if (n_ch < 1 || n_ch > kMaxChannels || h < 1 || w < 1 || win < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (clamp && n_ch != 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Channels ch = {{c0, c1, c2, c3}};
  for (int c = 0; c < n_ch; ++c)
    if (ch.p[c] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (clamp)
    lk_sample_kernel<true><<<n, kThreads, 0, s>>>(ch, n_ch, pts, out, n, h, w, win);
  else
    lk_sample_kernel<false><<<n, kThreads, 0, s>>>(ch, n_ch, pts, out, n, h, w, win);
  return (int)cudaGetLastError();
}

const char* lk_sample_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
