// Streaming 2-NN Hamming matcher over packed 256-bit (ORB) and 512-bit
// (BRISK, AKAZE) descriptors, for Hopper (sm_90a), on the int8 tensor cores.
//
// Replaces the Pallas TPU kernel `_knn2_kernel` of opencv_tpu/ops/pallas/knn.py:30
// (called through knn2_hamming / knn_match_streaming). Like the TPU kernel,
// it turns Hamming distance into an exact matrix product and never writes
// the [Nq, Nt] distance matrix.
//
// Semantics (equal to the Pallas kernel and to the plain PyTorch version in
// ops/cuda/knn.py): each query keeps a running (d1, d2, i1), initialised to
// (512, 512, 0) at both widths. Train rows are scanned in ascending order with strict `<`:
//   d < d1 -> (d2, i1, d1) = (d1, j, d);  else d < d2 -> d2 = d
// so d1 is the least distance, i1 the lowest index that reaches it and d2
// the second value of the multiset; invalid rows and distances of 512 or
// more never enter.
//
// Bound on an H100 SXM: the product, 2 * nq * nt * bits int8 operations at
// 1979 TOP/s (0.060 ms at 2000 x 115 200 valid rows x 256 bits); the 4 MB
// of packed input moves in ~1 us. The first design (a CUDA-core thread per
// query, one __popc per word and pair) was held to 16 popcounts a clock per
// SM, ~0.44 ms at that shape.
//
// Design. A block holds 128 queries and streams train tiles of 128 rows
// (the MMA's N) over its split of the train set, with three warpgroups:
//  * Product: two consumer warpgroups of 64 queries (one m64 each) run
//    wgmma.mma_async m64n128k32 s8 x u8 -> s32, both operands K-major in
//    shared memory (no-swizzle core-matrix layout), one k32 step per 32-bit
//    descriptor word. Bit 8b + m of a word is byte 4m + b of its K block,
//    for queries and train alike. Train bytes are 0 or 2^m (m < 7; 0 or 1
//    for m = 7) and query bytes +-64 / 2^m (+-64), so every product is +-64
//    or 0 and the sum over the descriptor is 64 (popc(q) - d).
//  * One more k32 step carries each train row's rank in its lane (below)
//    and its validity: A is a constant row (1, -128 x 4), B holds
//    (rank, 255 x 4 if the row is invalid or past the split). So the
//    accumulator is a key 64 (popc(q) - d) + rank, less 130 560 for an
//    invalid row: the largest key is the least distance at the lowest
//    index, and an invalid row decodes to d >= 2040 > 512.
//  * A producer warpgroup unpacks each tile from its packed words into a
//    ring of stages (4 at 256 bits, 2 at 512), one mask per 4 bytes,
//    loading the next tile meanwhile; fence.proxy.async and mbarriers
//    (full: the producer's 128 threads; empty: the consumers' 256) hand
//    the stages over.
//  * The consumers take the tensor cores in turns (named barriers): one
//    warpgroup's product runs while the other folds its last tile.
//  * Epilogue, fused: a thread holds rows 16w + l/4 and +8 of its
//    warpgroup and columns 8j + 2(l%4) + {0,1}. Per row and tile it finds
//    the two largest of its 32 keys by a tree of pairs, decodes them, and
//    folds them into its running (d1, d2, i1) with the rule above (its
//    columns ascend tile after tile). At the end of the split the 4 lanes
//    of a row merge lexicographically on (d1, i1): the lowest index wins
//    ties and d2 stays the multiset's second value.
//  * 2000 queries make only 16 blocks, so the train set is split over
//    blockIdx.y into about one block per SM; `knn2_merge` folds the
//    per-split partials in split order with the same strict `<`, which
//    keeps the earliest-index rule.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 128;         // queries per block: two consumer warpgroups of 64
constexpr int TT = 128;         // train rows per tile: the MMA's N
constexpr int CONSUMERS = 256;  // threads of the two consumer warpgroups
constexpr int THREADS = 384;    // and one producer warpgroup
constexpr int FAR = 512;
constexpr int KB = TT * 32;     // bytes of one 32-byte K block of 128 rows

// Byte offset of 16-byte chunk h (0 or 1) of row r in a K block: 8x16-byte
// core matrices, the two along K 128 bytes apart (LBO), 8-row groups 256
// bytes apart (SBO).
__device__ __forceinline__ int chunk_at(int r, int h) {
  return (r >> 3) * 256 + h * 128 + (r & 7) * 16;
}

template <int W>  // 32-bit words per descriptor: 8 (256 bits) or 16 (512 bits)
struct Layout {
  static constexpr int STAGES = W == 8 ? 4 : 2;
  static constexpr int A = 0;              // W K blocks of the 128 queries
  static constexpr int AX = W * KB;        // the constant extra K block, 64 rows
  static constexpr int B = AX + 64 * 32;   // STAGES stages of W + 1 K blocks of train
  static constexpr int STAGE = (W + 1) * KB;
  static constexpr int BAR = B + STAGES * STAGE;  // mbarriers: full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 16 * STAGES;
};

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);  // layout type 0 (no swizzle), base offset 0
}

__device__ __forceinline__ void mma_s8u8(uint32_t (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Pin the accumulators at a point of the program: no read moves above a
// wait, no write below an issue.
__device__ __forceinline__ void pin(uint32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// Named barriers between the two consumer warpgroups (256 threads: one
// warpgroup arrives, the other waits).
__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

// One train tile in the producer's registers: each thread's 16-byte groups
// of packed words and, for a row's first group, the row's validity (false
// past the split).
template <int W>
struct Packed {
  static constexpr int G = W / 4;                   // 16-byte groups per row
  static constexpr int N = TT * G / (THREADS - CONSUMERS);  // groups per producer thread
  uint4 v[N];
  bool ok[N];
};

template <int W>
__device__ __forceinline__ void load_tile(Packed<W>& p, int ptid, const uint4* __restrict__ t,
                                          const uint8_t* __restrict__ tvalid, int base, int n) {
  constexpr int G = Packed<W>::G;
#pragma unroll
  for (int i = 0; i < Packed<W>::N; ++i) {
    const int it = ptid + i * (THREADS - CONSUMERS), r = it / G, g = it % G;
    p.v[i] = r < n ? t[(size_t)(base + r) * G + g] : make_uint4(0, 0, 0, 0);
    p.ok[i] = g == 0 && r < n && (tvalid == nullptr || tvalid[base + r] != 0);
  }
}

// A tile into one stage: W K blocks of bit bytes, then the extra block's
// first chunk (rank, penalty); its second chunk is zero from the start.
// The m-th 4 bytes of word w are w & (0x01010101 << m), bytes of 0 or 2^m,
// for m < 7 (the queries' bytes there are +-64 / 2^m), and
// (w >> 7) & 0x01010101 for m = 7: every product is +-64 or 0.
template <int W>
__device__ __forceinline__ void store_tile(uint8_t* st, const Packed<W>& p, int ptid) {
  constexpr int G = Packed<W>::G;
#pragma unroll
  for (int i = 0; i < Packed<W>::N; ++i) {
    const int it = ptid + i * (THREADS - CONSUMERS), r = it / G, g = it % G;
    const uint32_t w4[4] = {p.v[i].x, p.v[i].y, p.v[i].z, p.v[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w = w4[j];
      uint8_t* o = st + (4 * g + j) * KB + chunk_at(r, 0);
      *(uint4*)o = make_uint4(w & 0x01010101u, w & 0x02020202u, w & 0x04040404u, w & 0x08080808u);
      *(uint4*)(o + 128) = make_uint4(w & 0x10101010u, w & 0x20202020u, w & 0x40404040u,
                                      (w >> 7) & 0x01010101u);
    }
    if (g == 0) {
      const uint32_t rank = 31 - (2 * (r >> 3) + (r & 1));  // 31 for a lane's first column
      *(uint4*)(st + W * KB + chunk_at(r, 0)) =
          make_uint4(rank | (p.ok[i] ? 0u : 0xFFFFFF00u), p.ok[i] ? 0u : 0xFFu, 0u, 0u);
    }
  }
}

// (h, l), the two largest of a set, merged with (h2, l2), another set's.
__device__ __forceinline__ void top2_merge(int& h, int& l, int h2, int l2) {
  const int lo = min(h, h2);
  h = max(h, h2);
  l = max(max(l, l2), lo);
}

// Fold one tile's keys into the running (d1, d2, i1) of the thread's rows:
// the two largest of a row's 32 keys by a tree of pairs, decoded.
__device__ __forceinline__ void fold_tile(const uint32_t (&acc)[64], const int (&pq)[2], int quad,
                                          int base, int (&d1)[2], int (&d2)[2], int (&i1)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int hi[16], lo[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int x = (int)acc[4 * j + 2 * h], y = (int)acc[4 * j + 2 * h + 1];
      hi[j] = max(x, y);
      lo[j] = min(x, y);
    }
#pragma unroll
    for (int step = 1; step < 16; step *= 2) {
#pragma unroll
      for (int j = 0; j < 16; j += 2 * step) top2_merge(hi[j], lo[j], hi[j + step], lo[j + step]);
    }
    const int k1 = hi[0], k2 = lo[0];
    const int l1 = pq[h] - (k1 >> 6), l2 = pq[h] - (k2 >> 6);
    const int o1 = 31 - (k1 & 63);  // the lane's column order of the best key
    if (l1 < d1[h]) {
      d2[h] = min(d1[h], l2);
      d1[h] = l1;
      i1[h] = base + 8 * (o1 >> 1) + 2 * quad + (o1 & 1);
    } else {
      d2[h] = min(d2[h], l1);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
knn2_partial(const uint4* __restrict__ q, const uint4* __restrict__ t,
             const uint8_t* __restrict__ tvalid, int nq, int nt, int rows_per_split,
             int* __restrict__ pd1, int* __restrict__ pd2, int* __restrict__ pi1) {
  using L = Layout<W>;
  constexpr int G = W / 4;
  constexpr int S = L::STAGES;
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int j0 = split * rows_per_split;
  const int j1 = min(nt, j0 + rows_per_split);
  const int tiles = (j1 - j0 + TT - 1) / TT;
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t full = s0 + L::BAR, empty = s0 + L::BAR + 8 * S;

  // queries as bytes of +-64 / 2^m against the train's 0 / 2^m (m < 7) and
  // +-64 against 0 / 1 (m = 7), rows past nq zero
  for (int it = tid; it < TQ * G; it += THREADS) {
    const int r = it / G, g = it % G;
    const bool in = q0 + r < nq;
    const uint4 v = in ? q[(size_t)(q0 + r) * G + g] : make_uint4(0, 0, 0, 0);
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w = w4[j];
      uint32_t o[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const uint32_t pos = m < 7 ? 64u >> m : 64u, neg = 256u - pos;  // +-pos as bytes
        o[m] = in ? (neg * 0x01010101u) ^ (((w >> m) & 0x01010101u) * (pos ^ neg)) : 0u;
      }
      uint8_t* p = smem + L::A + (4 * g + j) * KB + chunk_at(r, 0);
      *(uint4*)p = make_uint4(o[0], o[1], o[2], o[3]);
      *(uint4*)(p + 128) = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
  if (tid < 64) {  // the extra block of A: (1, -128, -128, -128, -128, 0, ...)
    *(uint4*)(smem + L::AX + chunk_at(tid, 0)) = make_uint4(0x80808001u, 0x80u, 0u, 0u);
    *(uint4*)(smem + L::AX + chunk_at(tid, 1)) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int it = tid; it < S * TT; it += THREADS)  // second chunk of every stage's extra block
    *(uint4*)(smem + L::B + (it / TT) * L::STAGE + W * KB + chunk_at(it % TT, 1)) =
        make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, THREADS - CONSUMERS);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (tid >= CONSUMERS) {
    // Producer warpgroup: unpack tile ti into stage ti % S once the
    // consumers have released it, loading tile ti + 1 meanwhile.
    const int ptid = tid - CONSUMERS;
    Packed<W> cur, nxt;
    load_tile<W>(nxt, ptid, t, tvalid, j0, min(TT, j1 - j0));
    for (int ti = 0; ti < tiles; ++ti) {
      const int s = ti % S;
      cur = nxt;
      if (ti + 1 < tiles)
        load_tile<W>(nxt, ptid, t, tvalid, j0 + (ti + 1) * TT, min(TT, j1 - j0 - (ti + 1) * TT));
      mbar_wait(empty + 8 * s, ((ti / S) & 1) ^ 1);
      store_tile<W>(smem + L::B + s * L::STAGE, cur, ptid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + 8 * s);
    }
    return;
  }

  // Consumer warpgroups. Each holds 64 queries; they take the tensor cores
  // in turn (named barriers 1 and 2), so one folds a tile while the
  // other's product runs. A thread holds two rows and a four-lane group of
  // the accumulator layout.
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane & 3;
  int row[2], pq[2], d1[2], d2[2], i1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
    pq[h] = 0;
    if (row[h] < nq) {
      const uint32_t* qw = (const uint32_t*)q + (size_t)row[h] * W;
#pragma unroll
      for (int k = 0; k < W; ++k) pq[h] += __popc(qw[k]);
    }
    d1[h] = FAR;
    d2[h] = FAR;
    i1[h] = 0;
  }
  const uint64_t da = smem_desc(s0 + L::A + wg * 64 * 32);
  const uint64_t dax = smem_desc(s0 + L::AX);
  const uint64_t db = smem_desc(s0 + L::B);
  uint32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (int ti = 0; ti < tiles; ++ti) {
    const int s = ti % S;
    const uint64_t dbs = db + (uint64_t)((s * L::STAGE) >> 4);
    mbar_wait(full + 8 * s, (ti / S) & 1);
    if (wg == 1) bar_sync(2);
    else if (ti > 0) bar_sync(1);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    pin(acc);
#pragma unroll
    for (int k = 0; k < W; ++k)
      mma_s8u8(acc, da + (uint64_t)((k * KB) >> 4), dbs + (uint64_t)((k * KB) >> 4), k);
    mma_s8u8(acc, dax, dbs + (uint64_t)((W * KB) >> 4), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    pin(acc);
    if (wg == 0) bar_arrive(2);
    else if (ti + 1 < tiles) bar_arrive(1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin(acc);
    mbar_arrive(empty + 8 * s);
    fold_tile(acc, pq, quad, j0 + ti * TT, d1, d2, i1);
  }

  // the four lanes of a row: lexicographic on (d1, i1)
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b1 = __shfl_xor_sync(0xFFFFFFFFu, d1[h], m);
      const int b2 = __shfl_xor_sync(0xFFFFFFFFu, d2[h], m);
      const int bi = __shfl_xor_sync(0xFFFFFFFFu, i1[h], m);
      if (b1 < d1[h] || (b1 == d1[h] && bi < i1[h])) {
        d2[h] = min(d1[h], b2);
        d1[h] = b1;
        i1[h] = bi;
      } else {
        d2[h] = min(d2[h], b1);
      }
    }
  }
  if (quad == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] < nq) {
        const size_t o = (size_t)split * nq + row[h];
        pd1[o] = d1[h];
        pd2[o] = d2[h];
        pi1[o] = i1[h];
      }
    }
  }
}

__global__ void knn2_merge(const int* __restrict__ pd1, const int* __restrict__ pd2,
                           const int* __restrict__ pi1, int nq, int splits,
                           float* __restrict__ d1o, float* __restrict__ d2o,
                           long long* __restrict__ i1o) {
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

template <int W>
cudaError_t launch_partial(dim3 grid, cudaStream_t s, const uint4* q, const uint4* t,
                           const uint8_t* tvalid, int nq, int nt, int rows_per_split, int* pd1,
                           int* pd2, int* pi1) {
  constexpr int bytes = Layout<W>::BYTES;
  const cudaError_t err =
      cudaFuncSetAttribute(knn2_partial<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  knn2_partial<W><<<grid, THREADS, bytes, s>>>(q, t, tvalid, nq, nt, rows_per_split, pd1, pd2, pi1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int knn2_tile_rows() { return TT; }

// q: [nq, 4 * chunks] u32, t: [nt, 4 * chunks] u32 (16-byte aligned,
// contiguous), chunks 2 (256 bits) or 4 (512 bits); tvalid: u8 [nt] or null.
// Scratch pd1/pd2/pi1: i32 [splits, nq]. Outputs d1/d2 f32 [nq], i1 i64 [nq].
// rows_per_split is a multiple of the tile height. Returns a cudaError_t
// (0 = both kernels launched).
int knn2_launch(const void* q, const void* t, const uint8_t* tvalid, int nq, int nt,
                int chunks, int rows_per_split, int splits, int* pd1, int* pd2, int* pi1,
                float* d1, float* d2, long long* i1, void* stream) {
  if (nq < 1 || nt < 1 || splits < 1 || splits > 65535 || rows_per_split < 1 ||
      rows_per_split % TT != 0 || (long long)rows_per_split * splits < nt ||
      (long long)rows_per_split * (splits - 1) >= nt || (chunks != 2 && chunks != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((nq + TQ - 1) / TQ, splits);
  const uint4* qv = (const uint4*)q;
  const uint4* tv = (const uint4*)t;
  cudaError_t err = chunks == 2
      ? launch_partial<8>(grid, s, qv, tv, tvalid, nq, nt, rows_per_split, pd1, pd2, pi1)
      : launch_partial<16>(grid, s, qv, tv, tvalid, nq, nt, rows_per_split, pd1, pd2, pi1);
  if (err != cudaSuccess) return (int)err;
  knn2_merge<<<(nq + 255) / 256, 256, 0, s>>>(pd1, pd2, pi1, nq, splits, d1, d2, i1);
  return (int)cudaGetLastError();
}

const char* knn2_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
