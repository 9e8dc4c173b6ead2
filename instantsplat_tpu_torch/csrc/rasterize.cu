// Dense Gaussian compositor for Hopper (sm_90a): the rectangle pass
// k1_rects, forward K1 and backward K2.
//
// Replaces the TPU kernels instantsplat_tpu/ops/rasterize_pallas.py::_fwd_kernel
// (K1, launched by _multi_fwd_call) and ::_bwd_kernel (K2, launched by
// _strip_bwd_call), and the culling bitmap ::_row_block_bitmap that feeds
// them. Same compositing rules as the plain version
// (instantsplat_tpu_torch/ops/rasterize.py): alpha = min(0.99, exp(power + lo)),
// skip power > 0 or alpha < 1/255, per-pixel latched stop once
// log T would fall below log(1e-4) (the firing splat is excluded).
//
// Layout. One CTA per 16x16 pixel tile, one thread per pixel, a warp per
// 8x4-pixel block. Input is packed [N,10] f32, depth-sorted: mx, my, conic
// a b c, log-opacity, r, g, b, depth.
//
// What bounds K1 and K2 on this card. Not bytes (40 B a splat, 24 B a
// pixel). A tile is covered by about one splat in two hundred, in depth
// order, so the first cost is finding them: a walk in rounds of 256
// splats, each round a chain of dependent loads and barriers that yields
// about one splat, is bound by latency (N/256 rounds per CTA) and by L2
// reads (tiles x N rectangles per launch). The second cost is the
// instructions of the pairs a pixel evaluates: every pixel of a tile
// evaluating every splat that touches the tile is several times the
// pairs that contribute, and a backward that shuffles fifty times and
// adds ten scalars to global memory per (splat, warp) pays again. With
// the design below, the scan is about a sixth of a K1 CTA's cycles and
// what is left is the instructions of the pairs themselves (about 90 a
// pair in K1, accurate expf and log1pf included), dispatched below the
// SMs' peak rate, plus the wait of a tile's lighter warps for its heaviest
// one (scripts/torch_dense_phases.py prints the shares). The design's
// answers, in turn:
//
// 1. k1_rects, one launch, one thread per splat, writes each splat's tile
//    rectangle (x_lo, x_hi, y_lo, y_hi) as 4 x int16, from the alpha-cutoff
//    radius sqrt(2 max(lo - log(1/255), 0) lambda_max) * 1.001 + 1 (never
//    the 3-sigma radius, which drops contributors), an empty rectangle
//    being (32767, -1, 32767, -1); and the scan's coarse level, mask
//    [n_words, n_tiles] uint32: bit b of mask[w][tile] is set when any of
//    the 32 splats of group 32 w + b covers the tile. A CTA of 1024 threads
//    owns one word of every tile: it ORs bits into shared memory and writes
//    each word once, so the mask needs no clearing and no global atomics.
//    The rectangle array is padded with empty ones to whole mask words, so
//    a group is always 32 rectangles. Every step that the plain version
//    rounds is rounded here (__fmul_rn, __fdiv_rn, __fsqrt_rn), so the
//    rectangles come out equal.
// 2. The scan (scan_pass) is apart from the compositing and takes 65,536
//    splats a pass, each step spread over the whole block with no chain
//    from one splat to the next: the tile's 64 mask words are read at once
//    and their marked groups compacted by a prefix sum; the rectangles of
//    marked groups only are read, four threads a group, four independent
//    16-byte loads a thread, into one survivor bit mask per group; a second
//    prefix sum places every survivor, and the survivors' indices go to a
//    queue in shared memory in sorted order (order decides the
//    last-contributor index and the stop). Rectangle tests per launch fall
//    from tiles x N to 32 per marked (group, tile). Passes go on filling
//    the queue until 512 entries wait or the splats end; a pass that finds
//    more than the queue holds hands them over a window at a time.
// 3. The queue is composited 256 entries at a time: thread t fetches entry
//    t's row (five 8-byte loads) into shared memory as three float4 that
//    are read back as broadcasts. K1 leaves as soon as every pixel of the
//    tile has stopped.
// 4. Fewer pairs are evaluated. With the row, thread t computes which of
//    the tile's eight 8x4 blocks the splat can reach at all (block_mask:
//    the least of the quadratic form over each pixel row's x range against
//    the cutoff, with slack), and each warp compacts the chunk's slots that
//    reach its block into a list of its own. A warp then walks only its
//    list, with no test per slot; K1 takes two entries at a time, since
//    their alphas are independent and only the transmittance is carried.
// 5. K2 walks the same passes back to front from the pass that holds the
//    tile's largest last-contributor index (later splats are never
//    queued), filling the queue from its top end downward. Each pixel
//    rebuilds the transmittance incident on each contributor by subtracting
//    log(1 - alpha) from log T_final, carries the suffix sum S of
//    w * (g . c), and forms d alpha = (g . c) T - (S + g_T T_final) /
//    (1 - alpha). A warp sums the ten gradients with a halving butterfly
//    (12 shuffles: 10 values -> 5 -> 3 -> 2 -> 1, then the pair), ten
//    lanes add the totals to the chunk's per-slot sums in shared memory,
//    and after the chunk thread t adds slot t's sums to the global scratch
//    [N,12] with three 16-byte atomicAdd(float4*): three vector atomics per
//    (splat, tile) instead of ten scalar ones per (splat, warp). Atomic
//    order varies, so K2's sums vary in the last bits from run to run.
//
// Tensor cores do not apply to this per-pair transcendental math. Shared
// memory stays under 48 KB static (K1 34 KB, K2 46 KB) so four CTAs share
// an SM and fill each other's barriers; only k1_rects takes dynamic shared
// memory (4 B a tile) and raises its limit when that passes 48 KB.
//
// The falloff power is evaluated with explicitly rounded multiplies and adds
// (__fmul_rn / __fadd_rn): a contracted FMA would round differently from
// the plain version and move pixels across the 1/255 cutoff. expf and
// log1pf are the accurate library versions: build without --use_fast_math.
//
// The chunk, the block masks, the per-warp lists, both walks and the
// gradient sums (points 3 to 5) are in compositor.cuh, which the list
// compositors (rasterize_lists.cu) share.
//
// Plain C interface, loaded with ctypes; each entry point returns the
// cudaError_t of its attribute call or launch.

#include "compositor.cuh"

namespace {

static_assert(TILE * TILE == BLOCK, "one thread per pixel of a tile");
constexpr int GROUP = 32;           // splats per bit of the coarse mask
constexpr int WORD_SPLATS = 32 * GROUP;      // splats per mask word
constexpr int PASS_WORDS = 64;      // mask words taken in a scan pass
constexpr int PASS_GROUPS = PASS_WORDS * 32;
constexpr int PASS_SPLATS = PASS_GROUPS * GROUP;
constexpr int GROUP_THREADS = 4;    // threads that test one group together
constexpr int QCAP = 2048;          // queue entries
constexpr int DRAIN_AT = 512;       // composite once this many are queued
constexpr int RECT_BLOCK = WORD_SPLATS;      // k1_rects threads per CTA

// ---------------------------------------------------------------------------
// k1_rects
// ---------------------------------------------------------------------------

// floor(v / 16) clamped to [-1, n] before the int cast, as the plain
// version does it
__device__ __forceinline__ int tile_floor(float v, int n) {
  return (int)fminf(fmaxf(floorf(__fmul_rn(v, 0.0625f)), -1.f), (float)n);
}

__global__ void __launch_bounds__(RECT_BLOCK)
k1_rects_kernel(const float* __restrict__ packed, int n, int n_tx, int n_ty,
                float log_alpha_eps, int2* __restrict__ rect,
                unsigned* __restrict__ mask) {
  extern __shared__ unsigned s_mask[];  // this word of every tile
  const int t = threadIdx.x, n_tiles = n_tx * n_ty;
  for (int i = t; i < n_tiles; i += RECT_BLOCK) s_mask[i] = 0u;
  __syncthreads();
  const int j = blockIdx.x * RECT_BLOCK + t;  // rect has a row for each
  if (j >= n) {
    rect[j] = make_int2(pack16(32767, -1), pack16(32767, -1));
  } else {
    const float2* row =
        reinterpret_cast<const float2*>(packed + (size_t)j * NCOL);
    const float2 m01 = __ldg(row), c01 = __ldg(row + 1), c2l = __ldg(row + 2);
    const float mx = m01.x, my = m01.y, ca = c01.x, cb = c01.y, cc = c2l.x;
    const float lo = c2l.y;
    const float det = __fsub_rn(__fmul_rn(ca, cc), __fmul_rn(cb, cb));
    const bool ok = lo > -INFINITY && det > 0.f && ca > 0.f;
    const float det_c = fmaxf(det, 1e-30f);
    const float tr_cov = ok ? __fdiv_rn(__fadd_rn(ca, cc), det_c) : 0.f;
    const float det_cov = ok ? __fdiv_rn(1.f, det_c) : 0.f;
    const float mid = __fmul_rn(0.5f, tr_cov);
    const float lam = __fadd_rn(mid, __fsqrt_rn(fmaxf(
        __fsub_rn(__fmul_rn(mid, mid), det_cov), 0.f)));
    const float m = fmaxf(__fsub_rn(lo, log_alpha_eps), 0.f);
    const float r = __fadd_rn(__fmul_rn(__fsqrt_rn(__fmul_rn(
        __fmul_rn(2.f, m), lam)), 1.001f), 1.f);
    bool alive = ok && m > 0.f;
    const int x_lo = max(tile_floor(__fsub_rn(mx, r), n_tx), 0);
    const int x_hi = min(tile_floor(__fadd_rn(mx, r), n_tx), n_tx - 1);
    const int y_lo = max(tile_floor(__fsub_rn(my, r), n_ty), 0);
    const int y_hi = min(tile_floor(__fadd_rn(my, r), n_ty), n_ty - 1);
    alive = alive && x_lo <= x_hi && y_lo <= y_hi;
    if (alive) {
      rect[j] = make_int2(pack16(x_lo, x_hi), pack16(y_lo, y_hi));
      const unsigned bit = 1u << (t >> 5);
      for (int y = y_lo; y <= y_hi; ++y)
        for (int x = x_lo; x <= x_hi; ++x) atomicOr(&s_mask[y * n_tx + x], bit);
    } else {
      rect[j] = make_int2(pack16(32767, -1), pack16(32767, -1));
    }
  }
  __syncthreads();
  unsigned* out = mask + (size_t)blockIdx.x * n_tiles;
  for (int i = t; i < n_tiles; i += RECT_BLOCK) out[i] = s_mask[i];
}

// ---------------------------------------------------------------------------
// the scan and the queue shared by K1 and K2
// ---------------------------------------------------------------------------

struct Shared {
  int queue[QCAP];                      // sorted indices of queued splats
  Chunk ch;                             // the chunk being composited
  unsigned survivors[PASS_GROUPS];      // per marked group of the pass
  unsigned short marked[PASS_GROUPS];   // the pass's marked groups, sorted
  int marked_total[NWARP], survivor_total[NWARP];  // block_scan's sums
};

__device__ __forceinline__ unsigned covers(int xs, int ys, int tx, int ty) {
  return tx >= low16(xs) && tx <= high16(xs) && ty >= low16(ys) &&
         ty <= high16(ys);
}

// One scan pass over PASS_WORDS mask words (PASS_SPLATS splats), for splats
// up to `last` only. Three steps, each spread over the whole block:
// the marked groups of the tile's mask words, compacted in order into
// sh.marked; their rectangles, GROUP_THREADS threads a group and four
// 16-byte loads a thread in flight, giving each marked group's survivors
// as a bit mask in sh.survivors; and a prefix sum over the survivor
// counts. Thread t then owns the marked groups [*lo, *hi), whose first
// survivor stands at *start of the pass's *total, in sorted order.
__device__ __forceinline__ void scan_pass(
    Shared& sh, const int4* __restrict__ rect2,
    const unsigned* __restrict__ mask, int n_words, int n_tiles, int tile,
    int tx, int ty, int pass, int last, int* lo, int* hi, int* start,
    int* total) {
  const int t = threadIdx.x;
  // marked groups
  const int wi = pass * PASS_WORDS + t, last_group = last / GROUP;
  unsigned word = 0u;
  if (t < PASS_WORDS && wi < n_words && wi * 32 <= last_group) {
    word = __ldg(mask + (size_t)wi * n_tiles + tile);
    if (last_group - wi * 32 < 31) word &= (2u << (last_group - wi * 32)) - 1u;
  }
  int n_marked;
  int at = block_scan(__popc(word), sh.marked_total, &n_marked);
  while (word) {
    sh.marked[at++] = (unsigned short)(t * 32 + __ffs(word) - 1);
    word &= word - 1u;
  }
  __syncthreads();
  // survivors of each marked group
  const int part = t % GROUP_THREADS;
  constexpr int PART_RECTS = GROUP / GROUP_THREADS;
  for (int i0 = 0; i0 < n_marked; i0 += BLOCK / GROUP_THREADS) {
    const int i = i0 + t / GROUP_THREADS;
    unsigned m = 0u;
    int g = 0;
    if (i < n_marked) {
      g = pass * PASS_GROUPS + sh.marked[i];
      const int4* p = rect2 + (size_t)g * (GROUP / 2) + part * (PART_RECTS / 2);
      int4 v[PART_RECTS / 2];
#pragma unroll
      for (int u = 0; u < PART_RECTS / 2; ++u) v[u] = __ldg(p + u);
#pragma unroll
      for (int u = 0; u < PART_RECTS / 2; ++u) {
        m |= covers(v[u].x, v[u].y, tx, ty) << (part * PART_RECTS + 2 * u);
        m |= covers(v[u].z, v[u].w, tx, ty) << (part * PART_RECTS + 2 * u + 1);
      }
    }
#pragma unroll
    for (int o = 1; o < GROUP_THREADS; o <<= 1)
      m |= __shfl_xor_sync(FULL, m, o);
    if (i < n_marked && part == 0) {
      const int left = last - g * GROUP;  // splats past `last` drop
      sh.survivors[i] = left < GROUP - 1 ? m & ((2u << left) - 1u) : m;
    }
  }
  __syncthreads();
  // positions
  const int per = (n_marked + BLOCK - 1) / BLOCK;
  *lo = min(t * per, n_marked);
  *hi = min(*lo + per, n_marked);
  int cnt = 0;
  for (int i = *lo; i < *hi; ++i) cnt += __popc(sh.survivors[i]);
  *start = block_scan(cnt, sh.survivor_total, total);
}

// Writes this thread's survivors whose position in the pass lies in
// [first, first + take) to queue[at + position - first].
__device__ __forceinline__ void queue_write(Shared& sh, int pass, int lo,
                                            int hi, int start, int first,
                                            int take, int at) {
  int pos = start - first;
  for (int i = lo; i < hi; ++i) {
    const int base = (pass * PASS_GROUPS + sh.marked[i]) * GROUP;
    unsigned m = sh.survivors[i];
    while (m) {
      if (pos >= 0 && pos < take) sh.queue[at + pos] = base + __ffs(m) - 1;
      m &= m - 1u;
      ++pos;
    }
  }
}

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

constexpr int TILE_BLOCKS_X = TILE / BLOCK_W;  // 8x4 blocks side by side

__global__ void __launch_bounds__(BLOCK)
k1_forward_kernel(const float* __restrict__ packed, int n,
                  const int4* __restrict__ rect2,
                  const unsigned* __restrict__ mask, int n_words, int height,
                  int width, float log_term, float log_alpha_eps,
                  float* __restrict__ acc, float* __restrict__ tfin,
                  int* __restrict__ lc) {
  __shared__ Shared sh;
  const int tx = blockIdx.x, ty = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int n_tiles = gridDim.x * gridDim.y, tile = ty * gridDim.x + tx;
  const int px = tx * TILE + (warp & 1) * BLOCK_W + (lane & 7);
  const int py = ty * TILE + (warp >> 1) * BLOCK_H + (lane >> 3);
  const bool inside = px < width && py < height;
  const float fx = (float)px, fy = (float)py;
  const int n_passes = (n_words + PASS_WORDS - 1) / PASS_WORDS;

  Pixel px_state;
  bool done = !inside, all_done = false;
  int pending = 0;  // queue entries waiting to be composited

  PHASE_START;
  for (int pass = 0; pass < n_passes && !all_done; ++pass) {
    int lo, hi, start, total;
    scan_pass(sh, rect2, mask, n_words, n_tiles, tile, tx, ty, pass, n - 1,
              &lo, &hi, &start, &total);
    for (int written = 0;;) {
      const int take = min(QCAP - pending, total - written);
      queue_write(sh, pass, lo, hi, start, written, take, pending);
      PHASE(0);  // scan
      pending += take;
      written += take;
      if (written == total && pending < DRAIN_AT && pass + 1 < n_passes) break;
      // composite the queue, CHUNK entries at a time
      __syncthreads();  // queue written; the slots' last readers are through
      PHASE(1);  // waiting for the other warps
      for (int c0 = 0; c0 < pending; c0 += CHUNK) {
        if (c0 != 0) __syncthreads();  // the previous chunk's slots are read
        PHASE(1);
        const int cnt = min(CHUNK, pending - c0);
        if (t < cnt)
          load_slot<TILE, TILE_BLOCKS_X>(sh.ch, packed, sh.queue[c0 + t],
                                         log_alpha_eps, tx * TILE, ty * TILE);
        PHASE(2);  // rows and block masks
        // barrier for the slots; leave once every pixel has stopped
        if (__syncthreads_count(done) == BLOCK) {
          all_done = true;
          break;
        }
        PHASE(1);
        const int n_mine = build_list(sh.ch, cnt, warp, lane);
        PHASE(3);  // the warp's list
        walk_forward(sh.ch, n_mine, warp, fx, fy, log_term, px_state, done);
        PHASE(4);  // compositing
      }
      pending = 0;
      if (all_done || written == total) break;
    }
  }
  if (inside) px_state.store(px, py, height, width, acc, tfin, lc);
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK)
k2_backward_kernel(const float* __restrict__ packed, int n,
                   const int4* __restrict__ rect2,
                   const unsigned* __restrict__ mask, int n_words, int height,
                   int width, float log_alpha_eps,
                   const float* __restrict__ g_acc,
                   const float* __restrict__ gtu,
                   const float* __restrict__ tfin,
                   const int* __restrict__ lc, float* __restrict__ dscratch) {
  __shared__ Shared sh;
  __shared__ __align__(16) float gsum[CHUNK][GRAD_W];  // per-slot sums
  __shared__ int s_max_lc;
  const int tx = blockIdx.x, ty = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int n_tiles = gridDim.x * gridDim.y, tile = ty * gridDim.x + tx;
  const int px = tx * TILE + (warp & 1) * BLOCK_W + (lane & 7);
  const int py = ty * TILE + (warp >> 1) * BLOCK_H + (lane >> 3);
  const bool inside = px < width && py < height;

  PixelGrad pixel;
  pixel.fx = (float)px, pixel.fy = (float)py;
  pixel.my_lc = inside ? lc[(size_t)py * width + px] : -1;
#pragma unroll
  for (int c = 0; c < GRAD_W; ++c) gsum[t][c] = 0.f;
  const int max_lc = min(block_max_lc(pixel.my_lc, &s_max_lc), n - 1);
  if (max_lc < 0) return;  // uniform: no pixel of the tile has a contributor
  pixel.load(inside, px, py, height, width, g_acc, gtu, tfin);

  int pending = 0;  // entries queued, at the top end of the queue
  PHASE_START;
  for (int pass = max_lc / PASS_SPLATS; pass >= 0; --pass) {
    int lo, hi, start, total;
    scan_pass(sh, rect2, mask, n_words, n_tiles, tile, tx, ty, pass, max_lc,
              &lo, &hi, &start, &total);
    for (int written = 0;;) {  // the pass's last survivors go in first
      const int take = min(QCAP - pending, total - written);
      queue_write(sh, pass, lo, hi, start, total - written - take, take,
                  QCAP - pending - take);
      PHASE(0);  // scan
      pending += take;
      written += take;
      if (written == total && pending < DRAIN_AT && pass > 0) break;
      __syncthreads();  // queue written
      PHASE(1);  // waiting for the other warps
      for (int top = QCAP; top > QCAP - pending; top -= CHUNK) {
        // slots and sums are free: a barrier follows every chunk's walk
        const int bottom = max(top - CHUNK, QCAP - pending), cnt = top - bottom;
        int j = 0;
        if (t < cnt) {
          j = sh.queue[bottom + t];
          load_slot<TILE, TILE_BLOCKS_X>(sh.ch, packed, j, log_alpha_eps,
                                         tx * TILE, ty * TILE);
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
      }
      pending = 0;
      if (written == total) break;
    }
  }
}

}  // namespace

extern "C" int k1_rects(const float* packed, int n, int height, int width,
                        float log_alpha_eps, int* rect, int* mask,
                        void* stream) {
  const int n_tx = (width + TILE - 1) / TILE, n_ty = (height + TILE - 1) / TILE;
  const size_t smem = sizeof(unsigned) * (size_t)n_tx * n_ty;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k1_rects_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_words = (n + WORD_SPLATS - 1) / WORD_SPLATS;
  k1_rects_kernel<<<n_words, RECT_BLOCK, smem, (cudaStream_t)stream>>>(
      packed, n, n_tx, n_ty, log_alpha_eps, reinterpret_cast<int2*>(rect),
      reinterpret_cast<unsigned*>(mask));
  return (int)cudaGetLastError();
}

extern "C" int k1_forward(const float* packed, int n, const int* rect,
                          const int* mask, int n_words, int height, int width,
                          float log_term, float log_alpha_eps, float* acc,
                          float* tfin, int* lc, void* stream) {
  const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
  k1_forward_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      packed, n, reinterpret_cast<const int4*>(rect),
      reinterpret_cast<const unsigned*>(mask), n_words, height, width,
      log_term, log_alpha_eps, acc, tfin, lc);
  return (int)cudaGetLastError();
}

extern "C" int k2_backward(const float* packed, int n, const int* rect,
                           const int* mask, int n_words, int height,
                           int width, float log_alpha_eps, const float* g_acc,
                           const float* gtu, const float* tfin, const int* lc,
                           float* dscratch, void* stream) {
  const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
  k2_backward_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      packed, n, reinterpret_cast<const int4*>(rect),
      reinterpret_cast<const unsigned*>(mask), n_words, height, width,
      log_alpha_eps, g_acc, gtu, tfin, lc, dscratch);
  return (int)cudaGetLastError();
}
