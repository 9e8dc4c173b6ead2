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
// Plain C interface, loaded with ctypes; each entry point returns the
// cudaError_t of its attribute call or launch.

#include <cuda_runtime.h>

// Built with -DPHASE_CLOCKS (scripts/torch_dense_phases.py), thread 0 of
// every CTA adds the clock64() cycles it spends in each phase of K1 or K2
// to phase_clocks[]; phase_clocks_read copies the sums out and clears
// them. Without the flag PHASE(i) is nothing.
#ifdef PHASE_CLOCKS
__device__ unsigned long long phase_clocks[8];
#define PHASE_START long long phase_tick_ = clock64()
#define PHASE(i)                                                       \
  do {                                                                 \
    if (threadIdx.x == 0) {                                            \
      const long long now_ = clock64();                                \
      atomicAdd(&phase_clocks[i], (unsigned long long)(now_ - phase_tick_)); \
      phase_tick_ = now_;                                              \
    }                                                                  \
  } while (0)
extern "C" int phase_clocks_read(unsigned long long* out) {
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, phase_clocks, sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(phase_clocks, zero, sizeof(zero));
  return (int)err;
}
#else
#define PHASE_START
#define PHASE(i)
#endif

namespace {

constexpr int TILE = 16;
constexpr int BLOCK = TILE * TILE;  // threads per CTA, one per pixel
constexpr int NWARP = BLOCK / 32;
constexpr int BLOCK_W = 8, BLOCK_H = 4;  // pixels of a tile that a warp owns
constexpr int NCOL = 10;            // packed columns
constexpr int GROUP = 32;           // splats per bit of the coarse mask
constexpr int WORD_SPLATS = 32 * GROUP;      // splats per mask word
constexpr int PASS_WORDS = 64;      // mask words taken in a scan pass
constexpr int PASS_GROUPS = PASS_WORDS * 32;
constexpr int PASS_SPLATS = PASS_GROUPS * GROUP;
constexpr int GROUP_THREADS = 4;    // threads that test one group together
constexpr int QCAP = 2048;          // queue entries
constexpr int DRAIN_AT = 512;       // composite once this many are queued
constexpr int CHUNK = BLOCK;        // queue entries composited at a time
constexpr int GRAD_W = 12;          // floats per splat in the gradient scratch
constexpr int RECT_BLOCK = WORD_SPLATS;      // k1_rects threads per CTA
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float falloff_power(float dx, float dy, float ca,
                                               float cb, float cc) {
  // -0.5 * (ca*dx*dx + cc*dy*dy) - cb*dx*dy, each step rounded on its own
  const float a = __fmul_rn(__fmul_rn(ca, dx), dx);
  const float c = __fmul_rn(__fmul_rn(cc, dy), dy);
  const float b = __fmul_rn(__fmul_rn(cb, dx), dy);
  return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(a, c)), b);
}

__device__ __forceinline__ int pack16(int lo, int hi) {
  return (int)(((unsigned)hi << 16) | ((unsigned)lo & 0xffffu));
}
__device__ __forceinline__ int low16(int v) { return (int)(short)(v & 0xffff); }
__device__ __forceinline__ int high16(int v) { return v >> 16; }

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

struct Slot {     // one queued splat in shared memory
  float4 q0;      // mx, my, log-opacity, (unused)
  float4 q1;      // conic a, b, c, global sorted index (bits)
  float4 q2;      // r, g, b, depth
};

struct Shared {
  int queue[QCAP];                      // sorted indices of queued splats
  Slot slots[CHUNK];                    // the chunk being composited
  unsigned char blocks[CHUNK];          // its block masks
  unsigned char mine[NWARP][CHUNK];     // per warp: the slots that reach it
  unsigned survivors[PASS_GROUPS];      // per marked group of the pass
  unsigned short marked[PASS_GROUPS];   // the pass's marked groups, sorted
  int marked_total[NWARP], survivor_total[NWARP];  // block_scan's sums
};

__device__ __forceinline__ unsigned covers(int xs, int ys, int tx, int ty) {
  return tx >= low16(xs) && tx <= high16(xs) && ty >= low16(ys) &&
         ty <= high16(ys);
}

// Exclusive prefix sum of v over the block's threads, and the block's
// total; `sums` is NWARP ints of shared memory that are not touched again
// before the block's next barrier. One barrier.
__device__ __forceinline__ int block_scan(int v, int* sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  int before = incl - v, sum = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    const int c = sums[w];
    before += w < warp ? c : 0;
    sum += c;
  }
  *total = sum;
  return before;
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

// The 8x4-pixel blocks of tile (tx, ty), one per warp (bit = 2 * block row
// + block column), in which the splat can reach alpha >= 1/255: the least
// of q = ca dx^2 + 2 cb dx dy + cc dy^2 over each pixel row's x range (at
// dx = -cb dy / ca, clamped to the range) against 2 (lo - log(1/255)),
// with a slack far above the rounding of this and of the compositor's own
// power.
__device__ __forceinline__ unsigned block_mask(float mx, float my, float ca,
                                               float cb, float cc, float lo,
                                               float log_alpha_eps, int tx,
                                               int ty) {
  const float m2 = 2.f * (lo - log_alpha_eps) + 1e-2f;
  const float slope = -cb / ca;
  const float x0 = (float)(tx * TILE) - mx;
  unsigned mask = 0u;
#pragma unroll 1
  for (int row = 0; row < TILE; ++row) {
    const float dy = (float)(ty * TILE + row) - my;
    const float t3 = cc * dy * dy, at = slope * dy;
#pragma unroll
    for (int bx = 0; bx < TILE / BLOCK_W; ++bx) {
      const float lo_x = x0 + (float)(bx * BLOCK_W);
      const float dx = fminf(fmaxf(at, lo_x), lo_x + (float)(BLOCK_W - 1));
      const float t1 = ca * dx * dx, t2 = 2.f * cb * dx * dy;
      if (t1 + t2 + t3 <= m2 + 1e-5f * (t1 + fabsf(t2) + t3))
        mask |= 1u << ((row / BLOCK_H) * (TILE / BLOCK_W) + bx);
    }
  }
  return mask;
}

// Thread t brings queue entry j into slot t: five 8-byte loads, the block
// mask, three 16-byte stores.
__device__ __forceinline__ void load_slot(Shared& sh,
                                          const float* __restrict__ packed,
                                          int j, float log_alpha_eps, int tx,
                                          int ty) {
  const int t = threadIdx.x;
  const float2* src =
      reinterpret_cast<const float2*>(packed + (size_t)j * NCOL);
  float2 v[5];
#pragma unroll
  for (int u = 0; u < 5; ++u) v[u] = __ldg(src + u);
  sh.blocks[t] = (unsigned char)block_mask(v[0].x, v[0].y, v[1].x, v[1].y,
                                           v[2].x, v[2].y, log_alpha_eps, tx,
                                           ty);
  sh.slots[t].q0 = make_float4(v[0].x, v[0].y, v[2].y, 0.f);
  sh.slots[t].q1 = make_float4(v[1].x, v[1].y, v[2].x, __int_as_float(j));
  sh.slots[t].q2 = make_float4(v[3].x, v[3].y, v[4].x, v[4].y);
}

// The chunk's slots whose block mask marks this warp's block, in order,
// into the warp's own list; returns how many.
__device__ __forceinline__ int build_list(Shared& sh, int cnt, int warp,
                                          int lane) {
  int n = 0;
  for (int i = 0; i < cnt; i += 32) {
    const int k = i + lane;
    const bool has = k < cnt && ((sh.blocks[k] >> warp) & 1);
    const unsigned b = __ballot_sync(FULL, has);
    if (has) sh.mine[warp][n + __popc(b & ((1u << lane) - 1u))] = (unsigned char)k;
    n += __popc(b);
  }
  __syncwarp();
  return n;
}

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

struct Pixel {  // one pixel's running composite
  float logT = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int last = -1;

  // Adds a contributor (alpha, l = log(1 - alpha), colors q2, index bits);
  // false when the latched stop fires, which excludes this splat.
  __device__ __forceinline__ bool add(float alpha, float l, const float4 q2,
                                      float index_bits, float log_term) {
    const float logT_post = logT + l;
    if (logT_post < log_term) return false;
    const float w = alpha * expf(logT);
    a0 += w * q2.x;
    a1 += w * q2.y;
    a2 += w * q2.z;
    a3 += w * q2.w;
    logT = logT_post;
    last = __float_as_int(index_bits);
    return true;
  }
};

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
          load_slot(sh, packed, sh.queue[c0 + t], log_alpha_eps, tx, ty);
        PHASE(2);  // rows and block masks
        // barrier for the slots; leave once every pixel has stopped
        if (__syncthreads_count(done) == BLOCK) {
          all_done = true;
          break;
        }
        PHASE(1);
        const int n_mine = build_list(sh, cnt, warp, lane);
        PHASE(3);  // the warp's list
        // two slots at a time: their alphas are independent, only the
        // transmittance is carried from one to the next
        for (int i = 0; i < n_mine && !done; i += 2) {
          const bool two = i + 1 < n_mine;
          const int ka = sh.mine[warp][i], kb = sh.mine[warp][two ? i + 1 : i];
          const float4 q0a = sh.slots[ka].q0, q1a = sh.slots[ka].q1;
          const float4 q0b = sh.slots[kb].q0, q1b = sh.slots[kb].q1;
          const float pa = falloff_power(fx - q0a.x, fy - q0a.y, q1a.x, q1a.y, q1a.z);
          const float pb = falloff_power(fx - q0b.x, fy - q0b.y, q1b.x, q1b.y, q1b.z);
          const float ea = __fadd_rn(pa, q0a.z), eb = __fadd_rn(pb, q0b.z);
          const float alpha_a = fminf(ALPHA_MAX, expf(ea));
          const float alpha_b = fminf(ALPHA_MAX, expf(eb));
          const bool va = !(pa > 0.f) && !(alpha_a < ALPHA_EPS);
          const bool vb = two && !(pb > 0.f) && !(alpha_b < ALPHA_EPS);
          if (!va && !vb) continue;
          const float la = log1pf(-alpha_a), lb = log1pf(-alpha_b);
          if (va && !px_state.add(alpha_a, la, sh.slots[ka].q2, q1a.w,
                                  log_term)) {
            done = true;
            break;
          }
          if (vb && !px_state.add(alpha_b, lb, sh.slots[kb].q2, q1b.w,
                                  log_term)) {
            done = true;
            break;
          }
        }
        PHASE(4);  // compositing
      }
      pending = 0;
      if (all_done || written == total) break;
    }
  }
  if (inside) {
    const size_t p = (size_t)py * width + px, hw = (size_t)height * width;
    acc[p] = px_state.a0;
    acc[hw + p] = px_state.a1;
    acc[2 * hw + p] = px_state.a2;
    acc[3 * hw + p] = px_state.a3;
    tfin[p] = expf(px_state.logT);
    lc[p] = px_state.last;
  }
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// One halving step of the warp sum: n values become ceil(n/2). A lane
// whose bit `o` is clear keeps the lower half and takes its partner's,
// the other lane the upper half.
template <int N>
__device__ __forceinline__ void halve(float (&a)[NCOL], int lane, int o) {
  constexpr int H = (N + 1) / 2;
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = a[i], hi = i + H < N ? a[i + H] : 0.f;
    const float got = __shfl_xor_sync(FULL, up ? lo : hi, o);
    a[i] = (up ? hi : lo) + got;
  }
}

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
  const float fx = (float)px, fy = (float)py;
  const size_t p = (size_t)py * width + px, hw = (size_t)height * width;

  const int my_lc = inside ? lc[p] : -1;
  if (t == 0) s_max_lc = -1;
#pragma unroll
  for (int c = 0; c < GRAD_W; ++c) gsum[t][c] = 0.f;
  __syncthreads();
  int mlc = my_lc;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mlc = max(mlc, __shfl_xor_sync(FULL, mlc, o));
  if (lane == 0) atomicMax(&s_max_lc, mlc);
  __syncthreads();
  const int max_lc = min(s_max_lc, n - 1);
  if (max_lc < 0) return;  // uniform: no pixel of the tile has a contributor

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

  // the column this lane holds after the butterfly (see halve): the steps
  // 16, 8, 4, 2 add 5, 3, 2, 1 to the position for a set lane bit; a
  // position past the step's count holds padding
  const int p2 = (lane & 2 ? 1 : 0);
  const int p4 = p2 + (lane & 4 ? 2 : 0);
  const int p8 = p4 + (lane & 8 ? 3 : 0);
  const int col = p8 + (lane & 16 ? 5 : 0);
  const bool holds = !(lane & 1) && p4 < 3 && p8 < 5;

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
          load_slot(sh, packed, j, log_alpha_eps, tx, ty);
        }
        PHASE(2);  // rows and block masks
        __syncthreads();
        PHASE(1);
        const int n_mine = build_list(sh, cnt, warp, lane);
        PHASE(3);  // the warp's list
        for (int i = n_mine - 1; i >= 0; --i) {
          const int k = sh.mine[warp][i];
          const float4 q0 = sh.slots[k].q0, q1 = sh.slots[k].q1;
          float d[NCOL];
#pragma unroll
          for (int c = 0; c < NCOL; ++c) d[c] = 0.f;
          bool contrib = false;
          if (__float_as_int(q1.w) <= my_lc) {
            const float ca = q1.x, cb = q1.y, cc = q1.z;
            const float dx = fx - q0.x, dy = fy - q0.y;
            const float power = falloff_power(dx, dy, ca, cb, cc);
            const float e = __fadd_rn(power, q0.z);
            const float a_un = expf(e);
            const float alpha = fminf(ALPHA_MAX, a_un);
            if (power <= 0.f && alpha >= ALPHA_EPS) {
              contrib = true;
              logT -= log1pf(-alpha);  // log T incident on this splat
              const float T = expf(logT);
              const float w = alpha * T;
              const float4 q2 = sh.slots[k].q2;
              const float b1 = g0 * q2.x + g1 * q2.y + g2 * q2.z + g3 * q2.w;
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
          // the list is the warp's, so every lane reaches this vote
          if (__any_sync(FULL, contrib)) {
            halve<10>(d, lane, 16);
            halve<5>(d, lane, 8);
            halve<3>(d, lane, 4);
            halve<2>(d, lane, 2);
            const float v = d[0] + __shfl_xor_sync(FULL, d[0], 1);
            if (holds) atomicAdd(&gsum[k][col], v);
          }
        }
        PHASE(4);  // the walk
        __syncthreads();  // the chunk's sums are complete
        PHASE(1);
        if (t < cnt) {
          const float4* s4 = reinterpret_cast<const float4*>(gsum[t]);
          const float4 v0 = s4[0], v1 = s4[1], v2 = s4[2];
          const bool any = v0.x != 0.f || v0.y != 0.f || v0.z != 0.f ||
                           v0.w != 0.f || v1.x != 0.f || v1.y != 0.f ||
                           v1.z != 0.f || v1.w != 0.f || v2.x != 0.f ||
                           v2.y != 0.f;
          if (any) {
            float4* dst = reinterpret_cast<float4*>(dscratch + (size_t)j * GRAD_W);
            atomicAdd(dst, v0);
            atomicAdd(dst + 1, v1);
            atomicAdd(dst + 2, v2);
#pragma unroll
            for (int c = 0; c < GRAD_W; ++c) gsum[t][c] = 0.f;
          }
        }
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
