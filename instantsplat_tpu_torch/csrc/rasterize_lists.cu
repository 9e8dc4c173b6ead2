// List compositors for Hopper (sm_90a): the 1-D binned forward K3 and
// backward K4, and the 2-D tiled forward K5 and backward K6.
//
// Replaces the TPU kernels instantsplat_tpu/ops/rasterize_pallas_binned.py::
// _fwd_kernel (K3, launched by _run_fwd_strip) and ::_bwd_kernel (K4,
// _run_bwd_strip), and instantsplat_tpu/ops/rasterize_pallas_tiled.py::
// _fwd_kernel (K5, _run_fwd) and ::_bwd_kernel (K6, _run_bwd). Same
// compositing rules as the plain version and as K1/K2 (csrc/rasterize.cu):
// alpha = min(0.99, exp(power + lo)), skip power > 0 or alpha < 1/255,
// per-pixel latched stop once log T would fall below log(1e-4) (the firing
// splat is excluded).
//
// Lists. The image is cut into segments of SEG_ROWS x seg_w pixels: 4-row
// bands of the 128-padded width for K3/K4 (one segment per row block),
// 8 x 128 tiles for K5/K6. The wrapper builds, in plain torch, each
// segment's list of splat indices (ops/rasterize_lists.py): the (segment,
// splat) candidates of each splat's alpha-cutoff extent, sorted by
// segment * N + splat, so a list is ascending in the global depth-sorted
// index. `order` holds the lists back to back; segment s owns entries
// [seg_start[s], seg_start[s] + seg_count[s]). seg_count already excludes
// what does not fit in the capacity the backend string asked for, so the
// kernels drop exactly the pairs the TPU kernels drop. The TPU's 256-slot
// alignment padding and its chunk->segment map are not needed here.
//
// Layout. A segment is covered by several CTAs of SEG_ROWS x CTA_COLS
// pixels, one thread per pixel (K3: 4 x 64, K5: 8 x 32; the TPU's 8 x 128
// tile would give 192 CTAs at 512x384, too few for 132 SMs). All CTAs of a
// segment walk its whole list: batches of 256 entries are gathered from
// packed [N,10] into shared memory, then each pixel evaluates them in
// order. A CTA leaves as soon as every pixel has stopped. An empty list
// writes acc 0, T 1, lc -1.
//
// What bounds them. As for K1/K2, moving the data is small (K3/K5: 40 B a
// list entry and 24 B a pixel) and the work is the (pixel, entry) pairs:
// about 30 float operations, two exps and one log1p each forward, about
// twice that backward. They are bound by operations; the lists' answer is
// to evaluate only the splats whose extent reaches the segment (the TPU's
// sorted-list binning), with the latched stop on top. The 1-D bands still
// evaluate every splat of the band against every column span; the tiles
// bound both axes.
//
// K4/K6 start from the list position past the segment's largest
// last-contributor index (found by a binary search: lists are ascending)
// and walk back to front. Each pixel rebuilds the transmittance incident on
// each contributor from T_final, carries the suffix sum S of w * (g . c),
// and forms d alpha = (g . c) T - (S + g_T T_final) / (1 - alpha), exactly
// as K2. The ten gradients are summed across the warp with shuffles and
// lane 0 adds them into dpacked at the entry's global index with atomicAdd.
// The TPU wrote per-slot rows and folded them through an inverse slot map
// because its scatter-add is serialized; that workaround is not ported.
// Atomic order varies, so the sums vary in the last bits between runs.
//
// Numerics as K1/K2: the falloff power with explicitly rounded
// __fmul_rn/__fadd_rn (no FMA contraction), the accurate expf/log1pf (build
// without --use_fast_math), log(1e-4) passed in from Python.
//
// Plain C interface, loaded with ctypes; each entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;  // threads per CTA, one per pixel
constexpr int BATCH = 256;  // list entries per shared-memory batch
constexpr int NCOL = 10;    // packed columns
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;

struct SharedBatch {
  float col[NCOL][BATCH];  // splat columns of the batch's entries
  int idx[BATCH];          // global (sorted) index of each entry
};

__device__ __forceinline__ float falloff_power(float dx, float dy, float ca,
                                               float cb, float cc) {
  // -0.5 * (ca*dx*dx + cc*dy*dy) - cb*dx*dy, each step rounded on its own
  const float a = __fmul_rn(__fmul_rn(ca, dx), dx);
  const float c = __fmul_rn(__fmul_rn(cc, dy), dy);
  const float b = __fmul_rn(__fmul_rn(cb, dx), dy);
  return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(a, c)), b);
}

// Gathers entries [first, first + count) of `order` (count <= BATCH) into
// shared memory and synchronises. Every thread of the block must call it;
// the caller synchronises before the call so the previous batch is no
// longer read.
__device__ __forceinline__ void load_entries(SharedBatch& sb,
                                             const float* __restrict__ packed,
                                             const int* __restrict__ order,
                                             int first, int count) {
  const int t = threadIdx.x;
  if (t < count) {
    const int j = order[first + t];
    const float* src = packed + (size_t)j * NCOL;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) sb.col[c][t] = src[c];
    sb.idx[t] = j;
  }
  __syncthreads();
}

// Pixel of this thread: segment blockIdx.x of a grid of n_seg_cols segments
// per row, column span blockIdx.y of CTA_COLS pixels inside the segment.
template <int SEG_ROWS, int CTA_COLS>
struct PixelOf {
  int px, py;
  __device__ PixelOf(int n_seg_cols, int seg_w) {
    const int seg = blockIdx.x;
    const int sy = seg / n_seg_cols, sx = seg - sy * n_seg_cols;
    px = sx * seg_w + blockIdx.y * CTA_COLS + (int)threadIdx.x % CTA_COLS;
    py = sy * SEG_ROWS + (int)threadIdx.x / CTA_COLS;
  }
};

template <int SEG_ROWS, int CTA_COLS>
__global__ void __launch_bounds__(BLOCK)
lists_forward_kernel(const float* __restrict__ packed,
                     const int* __restrict__ order,
                     const int* __restrict__ seg_start,
                     const int* __restrict__ seg_count, int n_seg_cols,
                     int seg_w, int height, int width, float log_term,
                     float* __restrict__ acc, float* __restrict__ tfin,
                     int* __restrict__ lc) {
  static_assert(SEG_ROWS * CTA_COLS == BLOCK, "one thread per pixel");
  __shared__ SharedBatch sb;
  const PixelOf<SEG_ROWS, CTA_COLS> pix(n_seg_cols, seg_w);
  const bool inside = pix.px < width && pix.py < height;
  const float fx = (float)pix.px, fy = (float)pix.py;
  const int first = seg_start[blockIdx.x], count = seg_count[blockIdx.x];

  float logT = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int last = -1;
  bool done = !inside;
  for (int b = 0; b < count; b += BATCH) {
    // doubles as the barrier before load_entries overwrites shared memory
    if (__syncthreads_count(done) == BLOCK) break;
    const int cnt = min(BATCH, count - b);
    load_entries(sb, packed, order, first + b, cnt);
    if (done) continue;
    for (int k = 0; k < cnt; ++k) {
      const float dx = fx - sb.col[0][k], dy = fy - sb.col[1][k];
      const float power =
          falloff_power(dx, dy, sb.col[2][k], sb.col[3][k], sb.col[4][k]);
      if (power > 0.f) continue;
      const float alpha =
          fminf(ALPHA_MAX, expf(__fadd_rn(power, sb.col[5][k])));
      if (alpha < ALPHA_EPS) continue;
      const float l = log1pf(-alpha);
      const float logT_post = logT + l;
      if (logT_post < log_term) {  // latched stop; this splat is excluded
        done = true;
        break;
      }
      const float w = alpha * expf(logT);
      a0 += w * sb.col[6][k];
      a1 += w * sb.col[7][k];
      a2 += w * sb.col[8][k];
      a3 += w * sb.col[9][k];
      logT = logT_post;
      last = sb.idx[k];
    }
  }
  if (inside) {
    const size_t p = (size_t)pix.py * width + pix.px;
    const size_t hw = (size_t)height * width;
    acc[p] = a0;
    acc[hw + p] = a1;
    acc[2 * hw + p] = a2;
    acc[3 * hw + p] = a3;
    tfin[p] = expf(logT);
    lc[p] = last;
  }
}

template <int SEG_ROWS, int CTA_COLS>
__global__ void __launch_bounds__(BLOCK)
lists_backward_kernel(const float* __restrict__ packed,
                      const int* __restrict__ order,
                      const int* __restrict__ seg_start,
                      const int* __restrict__ seg_count, int n_seg_cols,
                      int seg_w, int height, int width,
                      const float* __restrict__ g_acc,
                      const float* __restrict__ gtu,
                      const float* __restrict__ tfin,
                      const int* __restrict__ lc,
                      float* __restrict__ dpacked) {
  static_assert(SEG_ROWS * CTA_COLS == BLOCK, "one thread per pixel");
  __shared__ SharedBatch sb;
  __shared__ int s_max_lc, s_end;
  const int t = threadIdx.x, lane = t & 31;
  const PixelOf<SEG_ROWS, CTA_COLS> pix(n_seg_cols, seg_w);
  const bool inside = pix.px < width && pix.py < height;
  const float fx = (float)pix.px, fy = (float)pix.py;
  const size_t p = (size_t)pix.py * width + pix.px;
  const size_t hw = (size_t)height * width;
  const int first = seg_start[blockIdx.x], count = seg_count[blockIdx.x];

  const int my_lc = inside ? lc[p] : -1;
  if (t == 0) s_max_lc = -1;
  __syncthreads();
  int m = my_lc;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) atomicMax(&s_max_lc, m);
  __syncthreads();
  const int max_lc = s_max_lc;
  if (max_lc < 0) return;  // uniform: no pixel of the CTA has a contributor
  if (t == 0) {
    // entries past the largest last contributor contribute nowhere: the
    // walk starts at the first entry whose index exceeds max_lc
    int lo = 0, hi = count;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (order[first + mid] <= max_lc) lo = mid + 1; else hi = mid;
    }
    s_end = lo;
  }
  __syncthreads();
  const int end = s_end;

  float logT = 0.f, gt = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f;
  if (inside) {
    logT = logf(fmaxf(tfin[p], 1e-30f));
    gt = gtu[p];
    g0 = g_acc[p];
    g1 = g_acc[hw + p];
    g2 = g_acc[2 * hw + p];
    g3 = g_acc[3 * hw + p];
  }
  float S = 0.f;  // sum over later contributors of w * (g . c)

  for (int b = ((end - 1) / BATCH) * BATCH; b >= 0 && end > 0; b -= BATCH) {
    const int cnt = min(BATCH, end - b);
    __syncthreads();
    load_entries(sb, packed, order, first + b, cnt);
    for (int k = cnt - 1; k >= 0; --k) {
      const int j = sb.idx[k];
      float d[NCOL];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) d[c] = 0.f;
      bool contrib = false;
      if (j <= my_lc) {
        const float ca = sb.col[2][k], cb = sb.col[3][k], cc = sb.col[4][k];
        const float dx = fx - sb.col[0][k], dy = fy - sb.col[1][k];
        const float power = falloff_power(dx, dy, ca, cb, cc);
        const float a_un = expf(__fadd_rn(power, sb.col[5][k]));
        const float alpha = fminf(ALPHA_MAX, a_un);
        if (power <= 0.f && alpha >= ALPHA_EPS) {
          contrib = true;
          logT -= log1pf(-alpha);  // log T incident on splat j
          const float T = expf(logT);
          const float w = alpha * T;
          const float c0 = sb.col[6][k], c1 = sb.col[7][k];
          const float c2 = sb.col[8][k], c3 = sb.col[9][k];
          const float b1 = g0 * c0 + g1 * c1 + g2 * c2 + g3 * c3;
          const float dalpha = b1 * T - (S + gt) / (1.f - alpha);
          S += w * b1;
          const float dpow = dalpha * (a_un < ALPHA_MAX ? a_un : 0.f);
          d[0] = dpow * (ca * dx + cb * dy);
          d[1] = dpow * (cc * dy + cb * dx);
          d[2] = dpow * (-0.5f * dx * dx);
          d[3] = dpow * (-dx * dy);
          d[4] = dpow * (-0.5f * dy * dy);
          d[5] = dpow;
          d[6] = w * g0;
          d[7] = w * g1;
          d[8] = w * g2;
          d[9] = w * g3;
        }
      }
      // cnt is uniform over the block, so every lane reaches this vote
      if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
        for (int c = 0; c < NCOL; ++c) {
          float v = d[c];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, o);
          d[c] = v;
        }
        if (lane == 0) {
          float* dst = dpacked + (size_t)j * NCOL;
#pragma unroll
          for (int c = 0; c < NCOL; ++c) atomicAdd(dst + c, d[c]);
        }
      }
    }
  }
}

// Segment geometry of each backend: rows per segment (the TPU kernels'
// BLOCK_ROWS) and pixels per CTA row.
constexpr int BINNED_ROWS = 4, BINNED_CTA_COLS = 64;
constexpr int TILED_ROWS = 8, TILED_CTA_COLS = 32;

template <int SEG_ROWS, int CTA_COLS>
int launch_forward(const float* packed, const int* order,
                   const int* seg_start, const int* seg_count, int n_seg,
                   int n_seg_cols, int seg_w, int height, int width,
                   float log_term, float* acc, float* tfin, int* lc,
                   void* stream) {
  if (n_seg <= 0 || n_seg_cols <= 0 || n_seg % n_seg_cols != 0 ||
      seg_w <= 0 || seg_w % CTA_COLS != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_seg, seg_w / CTA_COLS);
  lists_forward_kernel<SEG_ROWS, CTA_COLS>
      <<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
          packed, order, seg_start, seg_count, n_seg_cols, seg_w, height,
          width, log_term, acc, tfin, lc);
  return (int)cudaGetLastError();
}

template <int SEG_ROWS, int CTA_COLS>
int launch_backward(const float* packed, const int* order,
                    const int* seg_start, const int* seg_count, int n_seg,
                    int n_seg_cols, int seg_w, int height, int width,
                    const float* g_acc, const float* gtu, const float* tfin,
                    const int* lc, float* dpacked, void* stream) {
  if (n_seg <= 0 || n_seg_cols <= 0 || n_seg % n_seg_cols != 0 ||
      seg_w <= 0 || seg_w % CTA_COLS != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_seg, seg_w / CTA_COLS);
  lists_backward_kernel<SEG_ROWS, CTA_COLS>
      <<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
          packed, order, seg_start, seg_count, n_seg_cols, seg_w, height,
          width, g_acc, gtu, tfin, lc, dpacked);
  return (int)cudaGetLastError();
}

}  // namespace

#define FORWARD_ARGS                                                        \
  const float *packed, const int *order, const int *seg_start,             \
      const int *seg_count, int n_seg, int n_seg_cols, int seg_w,          \
      int height, int width, float log_term, float *acc, float *tfin,      \
      int *lc, void *stream
#define FORWARD_CALL                                                        \
  packed, order, seg_start, seg_count, n_seg, n_seg_cols, seg_w, height,  \
      width, log_term, acc, tfin, lc, stream
#define BACKWARD_ARGS                                                       \
  const float *packed, const int *order, const int *seg_start,             \
      const int *seg_count, int n_seg, int n_seg_cols, int seg_w,          \
      int height, int width, const float *g_acc, const float *gtu,         \
      const float *tfin, const int *lc, float *dpacked, void *stream
#define BACKWARD_CALL                                                       \
  packed, order, seg_start, seg_count, n_seg, n_seg_cols, seg_w, height,  \
      width, g_acc, gtu, tfin, lc, dpacked, stream

extern "C" int k3_forward(FORWARD_ARGS) {
  return launch_forward<BINNED_ROWS, BINNED_CTA_COLS>(FORWARD_CALL);
}

extern "C" int k4_backward(BACKWARD_ARGS) {
  return launch_backward<BINNED_ROWS, BINNED_CTA_COLS>(BACKWARD_CALL);
}

extern "C" int k5_forward(FORWARD_ARGS) {
  return launch_forward<TILED_ROWS, TILED_CTA_COLS>(FORWARD_CALL);
}

extern "C" int k6_backward(BACKWARD_ARGS) {
  return launch_backward<TILED_ROWS, TILED_CTA_COLS>(BACKWARD_CALL);
}
