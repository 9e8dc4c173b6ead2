// knn3: each point's mean squared distance to its 3 nearest other points,
// for the initial Gaussian scales (instantsplat_tpu_torch/ops/knn.py).
//
// Replaces no Pallas kernel. The JAX package computes the same function
// with plain jnp (instantsplat_tpu/ops/knn.py: a chunked Gram matrix and
// lax.top_k), and the port's plain version does the same with chunked
// torch.cdist and torch.topk. That plain version writes a [1024, N]
// distance matrix for every chunk of 1024 queries and runs a multi-pass
// radix top-k over it, moving tens of TB through device memory to keep a
// few candidates a row; at the 1.43 M points of a 12-view scene it took
// 44 s of a 70 s stage-2 scene on an H100. This kernel was added for that.
//
// What bounds it. The work is N (N - 1) point pairs, each 8 float
// operations (3 differences, 3 products, 2 sums) and a compare against
// the query's current third best. Nothing else grows with N squared: the
// cloud (12 B a point) is read from L2 once per block. So it is bound by
// the rate at which the SMs issue float instructions, ~3.35e13 lane
// operations a second (67 TFLOP/s counts an FMA as two), and the least
// time is pairs x 8 / 67 TFLOP/s.
//
// The design.
// - Queries in registers: each thread owns Q = 2 queries, query q of
//   thread t of block b being point b * THREADS * Q + q * THREADS + t.
//   For each it holds the point and its three best squared distances,
//   sorted ascending. On an H100, Q = 2 came within 2% (431,795 points)
//   and 6% (1,429,807) of the better of Q = 1 and Q = 4: more queries a
//   thread share each shared-memory read, fewer give a small cloud enough
//   blocks to fill the last wave.
// - The cloud in tiles of TILE points in shared memory, as float4, staged
//   with cp.async into a double buffer: tile t + 1 is in flight while
//   tile t is scanned. Every thread of a warp reads the same tile point (a
//   broadcast), and one read serves the thread's Q queries.
// - Exact distances, never the Gram form: d2 = (dx*dx + dy*dy) + dz*dz on
//   the coordinate differences, each step rounded (__fsub_rn, __fmul_rn,
//   __fadd_rn, so nothing is contracted into an FMA). That is the rounding
//   of the plain version's exact pass, so the result is the true 3
//   nearest by exact distance and no candidate margin is needed.
// - The running top-3: four points' distances are computed for a query
//   at once, and the insertion runs only when the least of them is below
//   the third best, which is rare after the first tiles.
// - Self by index: j != i is tested only in the tiles that overlap the
//   block's own queries. A duplicate point, at distance 0, is a neighbour.
// - The ragged last tile is scanned to its length; nothing is padded.
// - The epilogue writes max(((b0 + b1) + b2) / 3, 1e-7): the plain
//   version's mean and clamp, in the same order.
// No atomics and one launch a call, so the output is the same every call.
// The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int Q = 2;        // queries a thread
constexpr int TILE = 1024;  // cloud points a shared-memory tile holds
constexpr int GROUP = 4;    // tile points scanned together per query

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// points [start, start + count) of the [N, 3] cloud into buf as float4
// (x, y, z; w is never read); the block's threads take consecutive floats
__device__ __forceinline__ void stage_tile(float4* buf, const float* pts,
                                           int start, int count) {
  float* dst = reinterpret_cast<float*>(buf);
  const float* src = pts + 3 * static_cast<size_t>(start);
  for (int f = threadIdx.x; f < 3 * count; f += THREADS) {
    const int p = f / 3;
    cp_async4(dst + 4 * p + (f - 3 * p), src + f);
  }
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       float4 p) {
  const float dx = __fsub_rn(qx, p.x), dy = __fsub_rn(qy, p.y),
              dz = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// d into the ascending (b0, b1, b2) when it is below b2
__device__ __forceinline__ void insert(float d, float& b0, float& b1,
                                       float& b2) {
  if (d < b2) {
    if (d < b1) {
      b2 = b1;
      if (d < b0) {
        b1 = b0;
        b0 = d;
      } else {
        b1 = d;
      }
    } else {
      b2 = d;
    }
  }
}

// one tile, points [start, start + count) of the cloud, against the
// thread's Q queries; SELF: the tile overlaps the block's own queries
template <bool SELF>
__device__ __forceinline__ void scan_tile(const float4* buf, int start,
                                          int count, const float (&qx)[Q],
                                          const float (&qy)[Q],
                                          const float (&qz)[Q],
                                          const int (&qi)[Q], float (&b0)[Q],
                                          float (&b1)[Q], float (&b2)[Q]) {
  int j = 0;
  for (; j + GROUP <= count; j += GROUP) {
    float4 p[GROUP];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) p[u] = buf[j + u];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float d[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        d[u] = dist2(qx[q], qy[q], qz[q], p[u]);
        if (SELF && start + j + u == qi[q]) d[u] = inf();
      }
      const float least = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
      if (least < b2[q]) {
#pragma unroll
        for (int u = 0; u < GROUP; ++u) insert(d[u], b0[q], b1[q], b2[q]);
      }
    }
  }
  for (; j < count; ++j) {
    const float4 p = buf[j];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (SELF && start + j == qi[q]) continue;
      insert(dist2(qx[q], qy[q], qz[q], p), b0[q], b1[q], b2[q]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    knn3_kernel(const float* __restrict__ pts, float* __restrict__ out,
                int n) {
  __shared__ float4 tiles[2][TILE];
  const int first = blockIdx.x * THREADS * Q;
  const int last = min(first + THREADS * Q, n);  // the block's queries
  float qx[Q], qy[Q], qz[Q], b0[Q], b1[Q], b2[Q];
  int qi[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    qi[q] = first + q * THREADS + threadIdx.x;
    // a query past the end scans as a copy of the last point and is not
    // written
    const int c = min(qi[q], n - 1);
    qx[q] = pts[3 * c];
    qy[q] = pts[3 * c + 1];
    qz[q] = pts[3 * c + 2];
    b0[q] = b1[q] = b2[q] = inf();
  }
  const int n_tiles = (n + TILE - 1) / TILE;
  stage_tile(tiles[0], pts, 0, min(TILE, n));
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int start = t * TILE, count = min(TILE, n - start);
    if (t + 1 < n_tiles)
      stage_tile(tiles[(t + 1) & 1], pts, start + TILE,
                 min(TILE, n - start - TILE));
    cp_async_commit();  // an empty group after the last tile
    cp_async_wait_one();  // tile t has landed (this thread's copies)
    __syncthreads();      // ... and every thread's
    if (start < last && first < start + count)
      scan_tile<true>(tiles[t & 1], start, count, qx, qy, qz, qi, b0, b1, b2);
    else
      scan_tile<false>(tiles[t & 1], start, count, qx, qy, qz, qi, b0, b1,
                       b2);
    __syncthreads();  // the buffer is staged again at t + 1
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (qi[q] < n)
      out[qi[q]] = fmaxf(
          __fdiv_rn(__fadd_rn(__fadd_rn(b0[q], b1[q]), b2[q]), 3.0f), 1e-7f);
  }
}

}  // namespace

// pts [n, 3] float32, contiguous, n >= 4; out [n] float32. Returns the
// launch's cudaError.
extern "C" int knn3(const float* pts, float* out, int n, void* stream) {
  const int grid = (n + THREADS * Q - 1) / (THREADS * Q);
  knn3_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, out, n);
  return static_cast<int>(cudaGetLastError());
}
