// Streaming 2-NN Hamming matcher over packed 256-bit descriptors, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_knn2_kernel` of opencv_tpu/ops/pallas/knn.py
// (called through knn2_hamming / knn_match_streaming). The TPU kernel turns
// Hamming distance into a +-1 bf16 matmul on the MXU; here the distance is
// the exact integer __popc(q ^ t) summed over 8 words, and the [Nq, Nt]
// distance matrix never exists.
//
// Semantics (equal to the Pallas kernel and to the plain PyTorch version in
// ops/cuda/knn.py): each query keeps a running (d1, d2, i1), initialised to
// (512, 512, 0). Train rows are scanned in ascending order with strict `<`:
//   d < d1 -> (d2, i1, d1) = (d1, j, d);  else d < d2 -> d2 = d
// so the lowest index wins ties. Invalid train rows are skipped, which
// equals the Pallas penalty column (a penalised row never beats 512).
//
// Design: one thread per query, its 8 words in registers. A block of 128
// queries stages train tiles of 256 rows (8 KB) through shared memory; every
// thread of a warp reads the same row, a broadcast. 2000 queries make only
// 16 blocks, so the train set is split over blockIdx.y; `knn2_merge` folds
// the per-split partials in split order with the same strict `<`, which
// keeps the earliest-index rule across splits.
//
// Bound on an H100 SXM at 2000 x 128000: 2.05e9 popcounts at 16/clk/SM on
// 132 SMs, about 0.55 ms at 1.755 GHz (the 4 MB of input moves in ~1 us).
// A +-1 bf16 tensor-core product would need 0.13 ms at 989 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 128;  // queries per block, one per thread
constexpr int TT = 256;  // train rows per shared-memory tile
constexpr int FAR = 512;

__global__ void __launch_bounds__(TQ)
knn2_partial(const uint4* __restrict__ q, const uint4* __restrict__ t,
             const uint8_t* __restrict__ tvalid, int nq, int nt, int rows_per_split,
             int* __restrict__ pd1, int* __restrict__ pd2, int* __restrict__ pi1) {
  __shared__ uint4 st[TT][2];
  __shared__ uint8_t sv[TT];

  const int qi = blockIdx.x * TQ + threadIdx.x;
  const int split = blockIdx.y;
  const int j0 = split * rows_per_split;
  const int j1 = min(nt, j0 + rows_per_split);

  uint4 qa = make_uint4(0, 0, 0, 0), qb = make_uint4(0, 0, 0, 0);
  if (qi < nq) {
    qa = q[2 * (size_t)qi];
    qb = q[2 * (size_t)qi + 1];
  }
  int d1 = FAR, d2 = FAR, i1 = 0;

  for (int base = j0; base < j1; base += TT) {
    const int n = min(TT, j1 - base);
    for (int k = threadIdx.x; k < 2 * n; k += TQ)
      st[k >> 1][k & 1] = t[2 * (size_t)base + k];
    for (int k = threadIdx.x; k < n; k += TQ)
      sv[k] = tvalid == nullptr ? 1 : tvalid[base + k];
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      if (!sv[r]) continue;
      const uint4 a = st[r][0];
      const uint4 b = st[r][1];
      const int d = __popc(qa.x ^ a.x) + __popc(qa.y ^ a.y) + __popc(qa.z ^ a.z) +
                    __popc(qa.w ^ a.w) + __popc(qb.x ^ b.x) + __popc(qb.y ^ b.y) +
                    __popc(qb.z ^ b.z) + __popc(qb.w ^ b.w);
      if (d < d1) {
        d2 = d1;
        d1 = d;
        i1 = base + r;
      } else if (d < d2) {
        d2 = d;
      }
    }
    __syncthreads();
  }
  if (qi < nq) {
    const size_t o = (size_t)split * nq + qi;
    pd1[o] = d1;
    pd2[o] = d2;
    pi1[o] = i1;
  }
}

__global__ void knn2_merge(const int* __restrict__ pd1, const int* __restrict__ pd2,
                           const int* __restrict__ pi1, int nq, int splits,
                           float* __restrict__ d1o, float* __restrict__ d2o,
                           int* __restrict__ i1o) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  int d1 = FAR, d2 = FAR, i1 = 0;
  for (int s = 0; s < splits; ++s) {
    const size_t o = (size_t)s * nq + qi;
    const int a = pd1[o], b = pd2[o];
    if (a < d1) {
      d2 = min(d1, b);
      d1 = a;
      i1 = pi1[o];
    } else {
      d2 = min(d2, a);
    }
  }
  d1o[qi] = (float)d1;
  d2o[qi] = (float)d2;
  i1o[qi] = i1;
}

}  // namespace

extern "C" {

int knn2_tile_rows() { return TT; }

// q: [nq, 8] u32, t: [nt, 8] u32 (16-byte aligned, contiguous); tvalid: u8
// [nt] or null. Scratch pd1/pd2/pi1: i32 [splits, nq]. Outputs d1/d2 f32
// [nq], i1 i32 [nq]. rows_per_split is a multiple of the tile height.
// Returns a cudaError_t (0 = both kernels launched).
int knn2_launch(const void* q, const void* t, const uint8_t* tvalid, int nq, int nt,
                int rows_per_split, int splits, int* pd1, int* pd2, int* pi1,
                float* d1, float* d2, int* i1, void* stream) {
  if (nq < 1 || nt < 1 || splits < 1 || splits > 65535 || rows_per_split < 1 ||
      (long long)rows_per_split * splits < nt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((nq + TQ - 1) / TQ, splits);
  knn2_partial<<<grid, TQ, 0, s>>>((const uint4*)q, (const uint4*)t, tvalid, nq, nt,
                                   rows_per_split, pd1, pd2, pi1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn2_merge<<<(nq + 255) / 256, 256, 0, s>>>(pd1, pd2, pi1, nq, splits, d1, d2, i1);
  return (int)cudaGetLastError();
}

const char* knn2_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
