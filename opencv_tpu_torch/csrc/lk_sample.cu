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
// Bound on an H100 SXM: bytes, and almost all of them written. At the klt
// engine's track set (N = 2000) one level-0 track samples three sites,
// templates (C = 3, win 21), patches (C = 1, win 48) and the polish
// (C = 1, win 21): 8.1 M outputs, 32 MB written, against at most 3.7 MB
// of level read; 0.0115 ms at 3.35 TB/s. Its 7 f32 operations per output
// take under 0.002 ms at the FP32 rate.
//
// Design. On the card the sampler's time followed its instructions per
// output more than its bytes: in one experiment (its harness is not kept
// in the repository), a variant that computed every output but stored
// none timed within a few per cent of the kernel at every site, and
// occupancy, block size and asynchronous copies moved nothing. So this
// design cuts the instructions per output.
// - A block takes P consecutive points and all C channels (grid
//   ceil(N/P)); P = max(1, 1024 / (C*win*win)): 2 at C = 1 and win 21, 1
//   for the templates (C = 3) and at win 48. `out` is [C, N, win, win], so
//   in each channel those P windows are one contiguous run of P*win*win
//   floats; the threads walk the run in order, so each warp stores 128
//   consecutive bytes, across window boundaries too.
// - Per point and tap row/column j the block first computes the clamped
//   row offset and column index, the validity code of window row and
//   column j (whether j and j + 1 lie in the image), and 16 masked weight
//   quadruples, one per pair of codes. An output then reads its weights
//   with one shared-memory load at the sum of its row's and column's
//   codes instead of masking four weights, and serves every channel.
// - The block stages each window's (win+1) x (win+1) taps of every
//   channel in shared memory, row by row at the clamped indices (the same
//   floats the four tap reads of an output would fetch), all of a thread's
//   loads issued before the first is stored. Each source pixel is read
//   once per window, not four times. A generic window whose taps do not
//   fit in the card's shared memory (on an H100, win > 238 for one
//   channel, > 119 for four) reads its four taps per output from global
//   memory at the same clamped indices instead: the same floats.
// - The kernel is a template on the channel count (1 to 4) and the window:
//   win 21 (the LK default: templates and polish) and win 48 (patches) are
//   compiled in; one generic instantiation serves every other width.
//   Threads step through (point, row, column) by adding a fixed stride with
//   carries, so no output costs an integer division (the generic
//   instantiation divides once per thread).
//
// The first design (one 256-thread block per point and channel, two
// runtime divisions, four global tap reads and four masked weights per
// output) took 0.0601 ms for the three sites at N = 2000 and 0.0232 ms at
// N = 512, slower than one F.grid_sample (0.0443, 0.0163); this design
// takes 0.0314 and 0.0142 ms, against 0.0115 and 0.0036 ms bounds (NVIDIA
// H100 80GB HBM3, 700.00 W, chip_smoke.py; per-site times in PERF.md).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;
constexpr int kOutputsPerBlock = 1024;
constexpr int kMaxPoints = 64;  // per block, for tiny windows

struct Channels {
  const float* p[kMaxChannels];
};

// channel i's pointer, read at compile-time offsets of the argument (a
// runtime index would copy the struct to local memory)
__device__ __forceinline__ const float* channel(const Channels& ch, int i) {
  switch (i) {
    case 1: return ch.p[1];
    case 2: return ch.p[2];
    case 3: return ch.p[3];
    default: return ch.p[0];
  }
}

__host__ __device__ constexpr int points_per_block(int win, int nc = 1) {
  return nc * win * win >= kOutputsPerBlock ? 1
         : (kOutputsPerBlock / (nc * win * win) > kMaxPoints ? kMaxPoints
                                                              : kOutputsPerBlock / (nc * win * win));
}

// shared memory of a block of P points at window `win`, in this order:
// K4: 16 masked weight quadruples per point (one per pair of row and
//     column validity codes); K5: one weight quadruple per point;
// STAGE: the (win+1)^2 taps per point and channel; the clamped row
// offset and column index of each of the win+1 tap rows and columns per
// point; K4: the validity code of each window row and column per point
__host__ __device__ constexpr size_t smem_bytes(int win, int p, int nc, bool clamp, bool stage) {
  return (size_t)p * (clamp ? 1 : 16) * 16 +
         (stage ? (size_t)nc * p * (win + 1) * (win + 1) * 4 : 0) + (size_t)p * (win + 1) * 8 +
         (clamp ? 0 : (size_t)p * win * 2);
}

// the card's shared memory per block, with the opt-in beyond 48 KB
inline size_t smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)optin;
}

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

// k -> (p, r, c) over [*][rows][cols], stepped by kThreads: the stride is
// split once into (dp, dr, dc) and every step adds it with two carries
struct Walk {
  int p, r, c, dp, dr, dc;
  __device__ __forceinline__ Walk(int k, int rows, int cols) {
    const int plane = rows * cols;
    p = k / plane;
    r = (k - p * plane) / cols;
    c = k - p * plane - r * cols;
    dp = kThreads / plane;
    dr = (kThreads - dp * plane) / cols;
    dc = kThreads - dp * plane - dr * cols;
  }
  __device__ __forceinline__ void next(int rows, int cols) {
    c += dc;
    if (c >= cols) { c -= cols; ++r; }
    r += dr;
    if (r >= rows) { r -= rows; ++p; }
    p += dp;
  }
};

// whether index i and i + 1 lie in [0, len): bit 0 and bit 1
__device__ __forceinline__ int valid_code(int i, int len) {
  return ((unsigned)i < (unsigned)len) | (((unsigned)(i + 1) < (unsigned)len) << 1);
}

// NC channels; WIN_T = 0: the generic instantiation, window `win_rt`;
// STAGE: taps from shared memory, else from global memory
template <int WIN_T, int NC, bool CLAMP, bool STAGE>
__global__ void __launch_bounds__(kThreads)
lk_sample_kernel(Channels ch, const float* __restrict__ pts, float* __restrict__ out,
                 int n, int h, int w, int win_rt) {
  static_assert(NC >= 1 && NC <= kMaxChannels && (!CLAMP || NC == 1), "channels");
  static_assert(STAGE || !WIN_T, "the compiled-in windows stage their taps");
  const int win = WIN_T ? WIN_T : win_rt;
  const int P = points_per_block(win, NC);
  const int area = win * win, tw = win + 1, tarea = tw * tw;

  extern __shared__ float4 smem[];
  float4* wt = smem;  // K4: [P][16] masked (w00 w01 w10 w11); K5: [P] (gy fy gx fx)
  float* taps = reinterpret_cast<float*>(wt + P * (CLAMP ? 1 : 16));  // [NC][P][win+1][win+1]
  int* rowoff = reinterpret_cast<int*>(taps + (STAGE ? NC * P * tarea : 0));  // [P][win+1]: row*w
  int* colidx = rowoff + P * tw;  // [P][win+1]: clamped column
  unsigned char* rowc = reinterpret_cast<unsigned char*>(colidx + P * tw);  // [P][win]: code << 2
  unsigned char* colc = rowc + P * win;                                       // [P][win]: code

  const int p0 = blockIdx.x * P;
  const int np = min(P, n - p0);
  const int tid = threadIdx.x;

  // per point and tap row/column j: the clamped tap indices, the validity
  // codes and the weights (each thread of a point derives its origin)
  for (int t = tid; t < np * tw; t += kThreads) {
    const int p = t / tw, j = t - p * tw;
    int ix0, iy0;
    float fx, fy;
    origin(pts[2 * (p0 + p)], win / 2, &ix0, &fx);
    origin(pts[2 * (p0 + p) + 1], win / 2, &iy0, &fy);
    rowoff[t] = clampi(iy0 + j, 0, h - 1) * w;
    colidx[t] = clampi(ix0 + j, 0, w - 1);
    const float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);
    if (CLAMP) {
      if (j == 0) wt[p] = make_float4(gy, fy, gx, fx);
    } else {
      if (j < win) {
        rowc[p * win + j] = (unsigned char)(valid_code(iy0 + j, h) << 2);
        colc[p * win + j] = (unsigned char)valid_code(ix0 + j, w);
      }
      const float w00 = __fmul_rn(gy, gx), w01 = __fmul_rn(gy, fx);
      const float w10 = __fmul_rn(fy, gx), w11 = __fmul_rn(fy, fx);
      for (int e = j; e < 16; e += tw) {  // e = row code << 2 | column code
        const int rc = e >> 2, cc = e & 3;
        wt[p * 16 + e] = make_float4((rc & cc & 1) ? w00 : 0.0f,
                                     ((rc & 1) && (cc & 2)) ? w01 : 0.0f,
                                     ((rc & 2) && (cc & 1)) ? w10 : 0.0f,
                                     (rc & cc & 2) ? w11 : 0.0f);
      }
    }
  }
  __syncthreads();

  // taps, row by row, in batches of B loads a thread, all issued before
  // the first is stored: one memory latency a batch (a single batch for
  // the compiled-in windows)
  if (STAGE) {
    constexpr int B = WIN_T ? (points_per_block(WIN_T, NC) * (WIN_T + 1) * (WIN_T + 1) +
                               kThreads - 1) / kThreads
                            : 8;
    const int total = np * tarea;
    Walk k3(tid, tw, tw);
    for (int base = tid; base < total; base += B * kThreads) {
      float v[NC][B];
#pragma unroll
      for (int i = 0; i < B; ++i, k3.next(tw, tw)) {
        if (base + i * kThreads < total) {
          const int off = rowoff[k3.p * tw + k3.r] + colidx[k3.p * tw + k3.c];
#pragma unroll
          for (int c = 0; c < NC; ++c) v[c][i] = __ldg(channel(ch, c) + off);
        }
      }
#pragma unroll
      for (int i = 0; i < B; ++i)
        if (base + i * kThreads < total) {
#pragma unroll
          for (int c = 0; c < NC; ++c) taps[c * P * tarea + base + i * kThreads] = v[c][i];
        }
    }
    __syncthreads();
  }

  // outputs in the order of out: [C, N, win, win], this block's run in
  // each channel
  float* __restrict__ dst = out + (size_t)p0 * area;
  const size_t plane = (size_t)n * area;
  Walk o3(tid, win, win);
  for (int k = tid; k < np * area; k += kThreads, o3.next(win, win)) {
    const int toff = o3.p * tarea + o3.r * tw + o3.c;
    const float4 m = CLAMP ? wt[o3.p]
                           : wt[o3.p * 16 + rowc[o3.p * win + o3.r] + colc[o3.p * win + o3.c]];
    int r0 = 0, r1 = 0, c0 = 0, c1 = 0;
    if (!STAGE) {
      r0 = rowoff[o3.p * tw + o3.r];
      r1 = rowoff[o3.p * tw + o3.r + 1];
      c0 = colidx[o3.p * tw + o3.c];
      c1 = colidx[o3.p * tw + o3.c + 1];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float t00, t01, t10, t11;
      if (STAGE) {
        const float* t = taps + c * P * tarea + toff;
        t00 = t[0], t01 = t[1], t10 = t[tw], t11 = t[tw + 1];
      } else {
        const float* src = channel(ch, c);
        t00 = __ldg(src + r0 + c0), t01 = __ldg(src + r0 + c1);
        t10 = __ldg(src + r1 + c0), t11 = __ldg(src + r1 + c1);
      }
      float v;
      if (CLAMP) {
        const float a = __fadd_rn(__fmul_rn(m.x, t00), __fmul_rn(m.y, t10));
        const float b = __fadd_rn(__fmul_rn(m.x, t01), __fmul_rn(m.y, t11));
        v = __fadd_rn(__fmul_rn(m.z, a), __fmul_rn(m.w, b));
      } else {
        v = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t00, m.x), __fmul_rn(t01, m.y)),
                                __fmul_rn(t10, m.z)),
                      __fmul_rn(t11, m.w));
      }
      dst[c * plane + k] = v;
    }
  }
}

template <int WIN_T, int NC, bool CLAMP, bool STAGE>
cudaError_t launch(const Channels& ch, const float* pts, float* out, int n, int h, int w, int win,
                   cudaStream_t s) {
  const auto kernel = lk_sample_kernel<WIN_T, NC, CLAMP, STAGE>;
  const int p = points_per_block(win, NC);
  const size_t bytes = smem_bytes(win, p, NC, CLAMP, STAGE);
  if (bytes > 48 * 1024) {
    if (bytes > smem_optin()) return cudaErrorInvalidValue;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n + p - 1) / p;
  kernel<<<blocks, kThreads, bytes, s>>>(ch, pts, out, n, h, w, win);
  return cudaGetLastError();
}

// the generic instantiation: taps staged where they fit in shared memory
template <int NC, bool CLAMP>
cudaError_t launch_generic(const Channels& ch, const float* pts, float* out, int n, int h, int w,
                           int win, cudaStream_t s) {
  const size_t staged = smem_bytes(win, points_per_block(win, NC), NC, CLAMP, true);
  if (staged <= 48 * 1024 || staged <= smem_optin())
    return launch<0, NC, CLAMP, true>(ch, pts, out, n, h, w, win, s);
  return launch<0, NC, CLAMP, false>(ch, pts, out, n, h, w, win, s);
}

// K4 at window 21 (templates, polish) or 48 (patches), else generic
template <int NC>
cudaError_t launch_win(const Channels& ch, const float* pts, float* out, int n, int h, int w,
                       int win, cudaStream_t s) {
  switch (win) {
    case 21: return launch<21, NC, false, true>(ch, pts, out, n, h, w, win, s);
    case 48: return launch<48, NC, false, true>(ch, pts, out, n, h, w, win, s);
    default: return launch_generic<NC, false>(ch, pts, out, n, h, w, win, s);
  }
}

}  // namespace

extern "C" {

// c0..c3: the channels, contiguous f32 [h, w] each (unused ones may be
// null); pts: contiguous f32 [n, 2] (x, y); out: contiguous f32
// [n_ch, n, win, win]; h * w < 2^31. Returns a cudaError_t (0 =
// launched); a window whose index tables exceed the card's shared memory
// (on an H100, win > 23218 for K4, > 29053 for K5) is refused.
int lk_sample_launch(const float* c0, const float* c1, const float* c2, const float* c3,
                     int n_ch, const float* pts, float* out, int n, int h, int w, int win,
                     int clamp, void* stream) {
  if (n_ch < 1 || n_ch > kMaxChannels || h < 1 || w < 1 || win < 1 || n < 0 ||
      (long long)h * w > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (clamp && n_ch != 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Channels ch = {{c0, c1, c2, c3}};
  for (int c = 0; c < n_ch; ++c)
    if (ch.p[c] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (clamp)
    return (int)(win == 21 ? launch<21, 1, true, true>(ch, pts, out, n, h, w, win, s)
                           : launch_generic<1, true>(ch, pts, out, n, h, w, win, s));
  switch (n_ch) {
    case 1: return (int)launch_win<1>(ch, pts, out, n, h, w, win, s);
    case 2: return (int)launch_win<2>(ch, pts, out, n, h, w, win, s);
    case 3: return (int)launch_win<3>(ch, pts, out, n, h, w, win, s);
    default: return (int)launch_win<4>(ch, pts, out, n, h, w, win, s);
  }
}

const char* lk_sample_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
