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
// pixels (K3/K4: 4 x 64, K5/K6: 8 x 32; the TPU's 8 x 128 tile would give
// 192 CTAs at 512x384, too few for 132 SMs), one thread per pixel, a warp
// per 8x4-pixel block: eight blocks side by side in a band's span, four by
// two in a tile's. A CTA that lies wholly in the padding beyond the image
// leaves at once. An empty list writes acc 0, T 1, lc -1.
//
// What bounds them on this card. Not bytes (4 B a list entry, 40 B a
// splat, 24 B a pixel), and not the operations of the pairs that
// contribute. In order:
//
// 1. The instructions of pairs that contribute nothing. A list bounds one
//    axis only (a band) or is coarse in both (a tile of 8 x 128), and a
//    CTA in which every pixel evaluates every entry of its segment's list
//    evaluates tens of times the pairs that contribute. Answer: the block
//    masks of compositor.cuh, taken over the CTA's span at its pixel
//    origin. Thread t computes for queued entry t which of the CTA's eight
//    8x4 blocks the splat reaches at alpha >= 1/255; each warp compacts the
//    chunk's slots that reach its block, in list order (order decides lc
//    and the stop), and walks only those, with no test per slot, two at a
//    time in the forward.
// 2. Fetching 40 bytes to reject an entry, in a chain. Most entries of a
//    segment's list miss a given span. Answer: k1_rects (rasterize.cu) runs
//    in front, as it does for K1/K2, and the kernels test an entry's 8-byte
//    tile rectangle against the span's tiles before anything else is read;
//    the rectangle comes from the same alpha-cutoff radius as the lists, so
//    it never drops a contributor. The test is a scan apart from the
//    compositing (scan_pass): 1024 list entries a pass, four independent
//    index loads and four independent rectangle loads a thread, survivors
//    placed by ballots and one prefix sum over the warps into a queue in
//    shared memory, in list order. Only survivors' rows are fetched, 256 at
//    a time, one thread a row. A pass whose entries all miss costs one test
//    an entry and no pair. Whole chunks of 256 are composited as soon as
//    they wait; the incomplete chunk that is left moves to the queue's
//    front and waits for the next pass. K3/K5 still leave as soon as every
//    pixel of the CTA has stopped, tested at every chunk.
// 3. K4/K6's gradient sums: fifty shuffles and ten scalar global atomics
//    per (entry, warp). Answer: K2's scheme (compositor.cuh): the
//    12-shuffle halving butterfly, per-slot sums in shared memory, and
//    after each chunk three atomicAdd(float4*) per (entry, CTA) into a
//    16-byte-aligned [N, 12] scratch. Atomic order varies, so the sums
//    vary in the last bits between runs.
//
// K4/K6 start from the list position past the CTA's largest
// last-contributor index (found by a binary search: lists are ascending)
// and scan and walk back to front, filling the queue from its top end
// downward. Each pixel skips the entries past its own last contributor,
// rebuilds the transmittance incident on each contributor from T_final,
// carries the suffix sum S of w * (g . c), and forms d alpha = (g . c) T -
// (S + g_T T_final) / (1 - alpha), exactly as K2. The TPU wrote per-slot
// rows and folded them through an inverse slot map because its scatter-add
// is serialized; that workaround is not ported.
//
// Numerics as K1/K2: the falloff power with explicitly rounded
// __fmul_rn/__fadd_rn (no FMA contraction), the accurate expf/log1pf (build
// without --use_fast_math), log(1e-4) and log(1/255) passed in from Python,
// transmittance as exp of a sum of logs. Tensor cores do not apply to this
// per-pair transcendental work. Shared memory is static and under 48 KB
// (forward 20 KB, backward 32 KB), so five or six CTAs share an SM and fill
// each other's barriers (BINNED_MIN_CTAS, TILED_MIN_CTAS).
//
// Plain C interface, loaded with ctypes; each entry point returns the
// cudaError_t of its launch.

#include "compositor.cuh"

namespace {

constexpr int LANE_ENTRIES = 4;  // list entries a thread tests in a scan pass
constexpr int WARP_ENTRIES = 32 * LANE_ENTRIES;
constexpr int PASS = NWARP * WARP_ENTRIES;  // list entries a scan pass takes
constexpr int QCAP = PASS + CHUNK;  // a pass's survivors and a waiting chunk

struct Shared {
  int queue[QCAP];     // splat indices of the entries that passed the scan
  Chunk ch;            // the chunk being composited
  int sums[2][NWARP];  // survivors per warp, by the pass's parity
};

// The SEG_ROWS x CTA_COLS pixels of this CTA: segment blockIdx.x of a grid
// of n_seg_cols segments per row, column span blockIdx.y inside the
// segment; and this thread's pixel, in its warp's 8x4 block.
template <int SEG_ROWS, int CTA_COLS>
struct Span {
  static constexpr int BLOCKS_X = CTA_COLS / BLOCK_W;
  static_assert(SEG_ROWS * CTA_COLS == BLOCK, "one thread per pixel");
  static_assert(TILE % SEG_ROWS == 0 && CTA_COLS % TILE == 0,
                "a span lies in one row of rectangle tiles");
  int x0, y0;          // pixel origin
  int px, py;          // this thread's pixel
  int tx_lo, tx_hi, ty;  // the rectangle tiles the span lies in
  __device__ Span(int n_seg_cols, int seg_w) {
    const int seg = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int sy = seg / n_seg_cols, sx = seg - sy * n_seg_cols;
    x0 = sx * seg_w + blockIdx.y * CTA_COLS;
    y0 = sy * SEG_ROWS;
    px = x0 + (warp % BLOCKS_X) * BLOCK_W + (lane & 7);
    py = y0 + (warp / BLOCKS_X) * BLOCK_H + (lane >> 3);
    tx_lo = x0 / TILE;
    tx_hi = tx_lo + CTA_COLS / TILE - 1;
    ty = y0 / TILE;
  }
  // the tile rectangle (xs, ys) reaches the span
  __device__ __forceinline__ bool reached_by(int xs, int ys) const {
    return low16(xs) <= tx_hi && high16(xs) >= tx_lo && low16(ys) <= ty &&
           high16(ys) >= ty;
  }
};

// One scan pass: entries [pass * PASS, (pass + 1) * PASS) of the list, up
// to `limit`. Each warp takes WARP_ENTRIES consecutive entries, a lane
// every 32nd; the entries whose tile rectangle reaches the span go to the
// queue in list order, from queue[at] upward, or (FROM_TOP) so that they
// end below queue[at]. Returns how many. One barrier, before the queue is
// written; the caller synchronises before it reads the queue.
template <bool FROM_TOP, class SpanT>
__device__ __forceinline__ int scan_pass(Shared& sh,
                                         const int* __restrict__ list,
                                         const int2* __restrict__ rect,
                                         const SpanT& span, int pass,
                                         int limit, int at) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e0 = pass * PASS + warp * WARP_ENTRIES + lane;
  int j[LANE_ENTRIES];
#pragma unroll
  for (int u = 0; u < LANE_ENTRIES; ++u) {
    const int e = e0 + 32 * u;
    j[u] = e < limit ? __ldg(list + e) : -1;
  }
  int2 r[LANE_ENTRIES];
#pragma unroll
  for (int u = 0; u < LANE_ENTRIES; ++u)
    r[u] = j[u] >= 0 ? __ldg(rect + j[u]) : make_int2(0, 0);
  int pos[LANE_ENTRIES], n = 0;  // place among the warp's survivors, or -1
#pragma unroll
  for (int u = 0; u < LANE_ENTRIES; ++u) {
    const bool hit = j[u] >= 0 && span.reached_by(r[u].x, r[u].y);
    const unsigned b = __ballot_sync(FULL, hit);
    pos[u] = hit ? n + __popc(b & ((1u << lane) - 1u)) : -1;
    n += __popc(b);
  }
  int* sums = sh.sums[pass & 1];
  if (lane == 0) sums[warp] = n;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    const int c = sums[w];
    before += w < warp ? c : 0;
    total += c;
  }
  int* dst = sh.queue + (FROM_TOP ? at - total : at) + before;
#pragma unroll
  for (int u = 0; u < LANE_ENTRIES; ++u)
    if (pos[u] >= 0) dst[pos[u]] = j[u];
  return total;
}

template <int SEG_ROWS, int CTA_COLS, int MIN_CTAS>
__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
lists_forward_kernel(const float* __restrict__ packed,
                     const int2* __restrict__ rect,
                     const int* __restrict__ order,
                     const int* __restrict__ seg_start,
                     const int* __restrict__ seg_count, int n_seg_cols,
                     int seg_w, int height, int width, float log_term,
                     float log_alpha_eps, float* __restrict__ acc,
                     float* __restrict__ tfin, int* __restrict__ lc) {
  using SpanT = Span<SEG_ROWS, CTA_COLS>;
  __shared__ Shared sh;
  const SpanT span(n_seg_cols, seg_w);
  if (span.x0 >= width || span.y0 >= height) return;  // uniform: padding
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool inside = span.px < width && span.py < height;
  const float fx = (float)span.px, fy = (float)span.py;
  const int* list = order + seg_start[blockIdx.x];
  const int count = seg_count[blockIdx.x];
  const int n_passes = (count + PASS - 1) / PASS;

  Pixel pixel;
  bool done = !inside, all_done = false;
  int pending = 0;  // queue entries waiting to be composited

  PHASE_START;
  for (int pass = 0; pass < n_passes && !all_done; ++pass) {
    pending += scan_pass<false>(sh, list, rect, span, pass, count, pending);
    PHASE(0);  // scan
    const bool last = pass + 1 == n_passes;
    if (pending < CHUNK && !last) continue;
    // composite whole chunks, and on the last pass the incomplete one too
    __syncthreads();  // queue written; the slots' last readers are through
    PHASE(1);  // waiting for the other warps
    int c0 = 0;
    for (; c0 < pending && (last || c0 + CHUNK <= pending); c0 += CHUNK) {
      if (c0 != 0) __syncthreads();  // the previous chunk's slots are read
      PHASE(1);
      const int cnt = min(CHUNK, pending - c0);
      if (t < cnt)
        load_slot<SEG_ROWS, SpanT::BLOCKS_X>(sh.ch, packed, sh.queue[c0 + t],
                                             log_alpha_eps, span.x0, span.y0);
      PHASE(2);  // rows and block masks
      // barrier for the slots; leave once every pixel has stopped
      if (__syncthreads_count(done) == BLOCK) {
        all_done = true;
        break;
      }
      PHASE(1);
      const int n_mine = build_list(sh.ch, cnt, warp, lane);
      PHASE(3);  // the warp's list
      walk_forward(sh.ch, n_mine, warp, fx, fy, log_term, pixel, done);
      PHASE(4);  // compositing
    }
    // what is left, less than a chunk and stored past the first chunk,
    // moves to the front; the next pass writes behind it after its barrier
    const int left = all_done ? 0 : max(pending - c0, 0);
    if (t < left) sh.queue[t] = sh.queue[c0 + t];
    pending = left;
  }
  if (inside) pixel.store(span.px, span.py, height, width, acc, tfin, lc);
}

template <int SEG_ROWS, int CTA_COLS, int MIN_CTAS>
__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
lists_backward_kernel(const float* __restrict__ packed,
                      const int2* __restrict__ rect,
                      const int* __restrict__ order,
                      const int* __restrict__ seg_start,
                      const int* __restrict__ seg_count, int n_seg_cols,
                      int seg_w, int height, int width, float log_alpha_eps,
                      const float* __restrict__ g_acc,
                      const float* __restrict__ gtu,
                      const float* __restrict__ tfin,
                      const int* __restrict__ lc,
                      float* __restrict__ dscratch) {
  using SpanT = Span<SEG_ROWS, CTA_COLS>;
  __shared__ Shared sh;
  __shared__ __align__(16) float gsum[CHUNK][GRAD_W];  // per-slot sums
  __shared__ int s_max_lc, s_end;
  const SpanT span(n_seg_cols, seg_w);
  if (span.x0 >= width || span.y0 >= height) return;  // uniform: padding
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool inside = span.px < width && span.py < height;
  const int* list = order + seg_start[blockIdx.x];
  const int count = seg_count[blockIdx.x];

  PixelGrad pixel;
  pixel.fx = (float)span.px, pixel.fy = (float)span.py;
  pixel.my_lc = inside ? lc[(size_t)span.py * width + span.px] : -1;
#pragma unroll
  for (int c = 0; c < GRAD_W; ++c) gsum[t][c] = 0.f;
  const int max_lc = block_max_lc(pixel.my_lc, &s_max_lc);
  if (max_lc < 0) return;  // uniform: no pixel of the CTA has a contributor
  if (t == 0) {
    // entries past the largest last contributor contribute nowhere: the
    // walk starts at the first entry whose index exceeds max_lc
    int lo = 0, hi = count;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (list[mid] <= max_lc) lo = mid + 1; else hi = mid;
    }
    s_end = lo;
  }
  __syncthreads();
  const int end = s_end;
  pixel.load(inside, span.px, span.py, height, width, g_acc, gtu, tfin);

  int pending = 0;  // entries queued, at the top end of the queue
  PHASE_START;
  for (int pass = (end - 1) / PASS; pass >= 0 && end > 0; --pass) {
    pending += scan_pass<true>(sh, list, rect, span, pass, end,
                               QCAP - pending);
    PHASE(0);  // scan
    const bool last = pass == 0;
    if (pending < CHUNK && !last) continue;
    // whole chunks from the top, and on the last pass the incomplete one
    __syncthreads();  // queue written
    PHASE(1);  // waiting for the other warps
    const int low = QCAP - pending;
    int top = QCAP;
    while (top > low && (last || top - CHUNK >= low)) {
      // slots and sums are free: a barrier follows every chunk's walk
      const int bottom = max(top - CHUNK, low), cnt = top - bottom;
      int j = 0;
      if (t < cnt) {
        j = sh.queue[bottom + t];
        load_slot<SEG_ROWS, SpanT::BLOCKS_X>(sh.ch, packed, j, log_alpha_eps,
                                             span.x0, span.y0);
      }
      PHASE(2);  // rows and block masks
      __syncthreads();
      PHASE(1);
      const int n_mine = build_list(sh.ch, cnt, warp, lane);
      PHASE(3);  // the warp's list
      walk_backward(sh.ch, gsum, n_mine, warp, lane, pixel);
      PHASE(4);  // the walk
      __syncthreads();  // the chunk's sums are complete
      PHASE(1);
      flush_sums(gsum, cnt, j, dscratch);
      PHASE(5);  // flushing the sums
      top = bottom;
    }
    // what is left, less than a chunk and stored below the top chunk,
    // moves up to the top; the next pass writes below it after its barrier
    const int left = top - low;
    if (t < left) sh.queue[QCAP - left + t] = sh.queue[low + t];
    pending = left;
  }
}

// Segment geometry of each backend: rows per segment (the TPU kernels'
// BLOCK_ROWS) and pixels per CTA row; and the CTAs per SM that the compiler
// fits the registers to (6: 40 a thread, 5: 48, a few spilled either way).
// A launch at 512x384 is 768 CTAs: the 70-odd registers the compiler takes
// unbounded leave 396 resident, 5 an SM 660, 6 an SM all of them. The band
// spans gain from 6; the tile spans pay more for the spills than they gain.
constexpr int BINNED_ROWS = 4, BINNED_CTA_COLS = 64, BINNED_MIN_CTAS = 6;
constexpr int TILED_ROWS = 8, TILED_CTA_COLS = 32, TILED_MIN_CTAS = 5;

bool bad_geometry(int n_seg, int n_seg_cols, int seg_w, int cta_cols) {
  return n_seg <= 0 || n_seg_cols <= 0 || n_seg % n_seg_cols != 0 ||
         seg_w <= 0 || seg_w % cta_cols != 0;
}

template <int SEG_ROWS, int CTA_COLS, int MIN_CTAS>
int launch_forward(const float* packed, const int* rect, const int* order,
                   const int* seg_start, const int* seg_count, int n_seg,
                   int n_seg_cols, int seg_w, int height, int width,
                   float log_term, float log_alpha_eps, float* acc,
                   float* tfin, int* lc, void* stream) {
  if (bad_geometry(n_seg, n_seg_cols, seg_w, CTA_COLS))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_seg, seg_w / CTA_COLS);
  lists_forward_kernel<SEG_ROWS, CTA_COLS, MIN_CTAS>
      <<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
          packed, reinterpret_cast<const int2*>(rect), order, seg_start,
          seg_count, n_seg_cols, seg_w, height, width, log_term,
          log_alpha_eps, acc, tfin, lc);
  return (int)cudaGetLastError();
}

template <int SEG_ROWS, int CTA_COLS, int MIN_CTAS>
int launch_backward(const float* packed, const int* rect, const int* order,
                    const int* seg_start, const int* seg_count, int n_seg,
                    int n_seg_cols, int seg_w, int height, int width,
                    float log_alpha_eps, const float* g_acc,
                    const float* gtu, const float* tfin, const int* lc,
                    float* dscratch, void* stream) {
  if (bad_geometry(n_seg, n_seg_cols, seg_w, CTA_COLS))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_seg, seg_w / CTA_COLS);
  lists_backward_kernel<SEG_ROWS, CTA_COLS, MIN_CTAS>
      <<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
          packed, reinterpret_cast<const int2*>(rect), order, seg_start,
          seg_count, n_seg_cols, seg_w, height, width, log_alpha_eps, g_acc,
          gtu, tfin, lc, dscratch);
  return (int)cudaGetLastError();
}

}  // namespace

#define FORWARD_ARGS                                                        \
  const float *packed, const int *rect, const int *order,                  \
      const int *seg_start, const int *seg_count, int n_seg,               \
      int n_seg_cols, int seg_w, int height, int width, float log_term,    \
      float log_alpha_eps, float *acc, float *tfin, int *lc, void *stream
#define FORWARD_CALL                                                        \
  packed, rect, order, seg_start, seg_count, n_seg, n_seg_cols, seg_w,     \
      height, width, log_term, log_alpha_eps, acc, tfin, lc, stream
#define BACKWARD_ARGS                                                       \
  const float *packed, const int *rect, const int *order,                  \
      const int *seg_start, const int *seg_count, int n_seg,               \
      int n_seg_cols, int seg_w, int height, int width,                    \
      float log_alpha_eps, const float *g_acc, const float *gtu,           \
      const float *tfin, const int *lc, float *dscratch, void *stream
#define BACKWARD_CALL                                                       \
  packed, rect, order, seg_start, seg_count, n_seg, n_seg_cols, seg_w,     \
      height, width, log_alpha_eps, g_acc, gtu, tfin, lc, dscratch, stream

extern "C" int k3_forward(FORWARD_ARGS) {
  return launch_forward<BINNED_ROWS, BINNED_CTA_COLS, BINNED_MIN_CTAS>(
      FORWARD_CALL);
}

extern "C" int k4_backward(BACKWARD_ARGS) {
  return launch_backward<BINNED_ROWS, BINNED_CTA_COLS, BINNED_MIN_CTAS>(
      BACKWARD_CALL);
}

extern "C" int k5_forward(FORWARD_ARGS) {
  return launch_forward<TILED_ROWS, TILED_CTA_COLS, TILED_MIN_CTAS>(
      FORWARD_CALL);
}

extern "C" int k6_backward(BACKWARD_ARGS) {
  return launch_backward<TILED_ROWS, TILED_CTA_COLS, TILED_MIN_CTAS>(
      BACKWARD_CALL);
}
