// Dense Gaussian compositor for Hopper (sm_90a): forward K1 and backward K2.
//
// Replaces the TPU kernels instantsplat_tpu/ops/rasterize_pallas.py::_fwd_kernel
// (K1, launched by _multi_fwd_call) and ::_bwd_kernel (K2, launched by
// _strip_bwd_call). Same compositing rules as the plain version
// (instantsplat_tpu_torch/ops/rasterize.py): alpha = min(0.99, exp(power + lo)),
// skip power > 0 or alpha < 1/255, per-pixel latched stop once
// log T would fall below log(1e-4) (the firing splat is excluded).
//
// Layout. One CTA per 16x16 pixel tile, one thread per pixel. Depth-sorted
// splats (packed [N,10] f32: mx, my, conic a b c, log-opacity, r, g, b,
// depth) stream through shared memory in batches of 256. The wrapper
// computes, in plain torch, each splat's tile rectangle from its
// alpha-cutoff radius sqrt(2 max(lo - log(1/255), 0) lambda_max) * 1.001 + 1
// (never the 3-sigma radius, which drops contributors) and each batch's
// union rectangle. A batch whose rectangle misses the tile is skipped
// without a load; the splats of a loaded batch that miss the tile are
// dropped by an order-preserving compaction, so each pixel evaluates only
// the splats whose rectangle covers its tile.
//
// What bounds it. Moving the data is small (K1: 40 B a splat plus 24 B a
// pixel). The work is the (pixel, splat) pairs inside the covering
// rectangles: about 30 float operations, two exps and one log1p each in
// K1, about twice that in K2, so both are bound by operations (issue rate
// and the special-function units), not bytes. The design's answer is to
// evaluate fewer pairs (batch skip, compaction, the latched stop with a
// block exit once every pixel has stopped) rather than to feed the pairs
// faster; tensor cores do not apply to this per-pair transcendental math.
//
// K2 walks the same batches back to front from the batch that holds the
// tile's largest last-contributor index. Each pixel rebuilds the
// transmittance incident on each contributor by subtracting log(1 - alpha)
// from log T_final, carries the suffix sum S of w * (g . c), and forms
// d alpha = (g . c) T - (S + g_T T_final) / (1 - alpha). The ten per-splat
// gradients are summed across the warp with shuffles, then lane 0 adds them
// to dpacked with atomicAdd (the TPU kernel instead owned one output block
// per chunk). Atomic order varies, so K2's sums vary in the last bits from
// run to run.
//
// The falloff power is evaluated with explicitly rounded multiplies and adds
// (__fmul_rn / __fadd_rn): a contracted FMA would round differently from
// the plain version and move pixels across the 1/255 cutoff. expf and
// log1pf are the accurate library versions: build without --use_fast_math.
//
// Plain C interface, loaded with ctypes; each entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int BLOCK = TILE * TILE;  // threads per CTA, one per pixel
constexpr int BATCH = BLOCK;        // splats per shared-memory batch
constexpr int NWARP = BLOCK / 32;
constexpr int NCOL = 10;            // packed columns
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;

struct SharedBatch {
  float col[NCOL][BATCH];  // compacted splat columns
  int idx[BATCH];          // global (sorted) index of each compacted splat
  int warp_count[NWARP];
};

__device__ __forceinline__ float falloff_power(float dx, float dy, float ca,
                                               float cb, float cc) {
  // -0.5 * (ca*dx*dx + cc*dy*dy) - cb*dx*dy, each step rounded on its own
  const float a = __fmul_rn(__fmul_rn(ca, dx), dx);
  const float c = __fmul_rn(__fmul_rn(cc, dy), dy);
  const float b = __fmul_rn(__fmul_rn(cb, dx), dy);
  return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(a, c)), b);
}

__device__ __forceinline__ bool rect_covers(const int4 r, int tx, int ty) {
  return tx >= r.x && tx <= r.y && ty >= r.z && ty <= r.w;
}

// Loads batch b's splats whose rectangle covers tile (tx, ty) into shared
// memory, in their sorted order, and returns how many there are. Every
// thread of the block must call it; the caller synchronises before the call
// so the previous batch's shared data is no longer read.
__device__ int load_batch(SharedBatch& sb, const float* __restrict__ packed,
                          int n, const int4* __restrict__ splat_rect, int b,
                          int tx, int ty) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int j = b * BATCH + t;
  const bool keep = j < n && rect_covers(splat_rect[j], tx, ty);
  const unsigned mask = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) sb.warp_count[warp] = __popc(mask);
  __syncthreads();
  int offset = 0, total = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    const int c = sb.warp_count[w];
    offset += w < warp ? c : 0;
    total += c;
  }
  if (keep) {
    const int slot = offset + __popc(mask & ((1u << lane) - 1u));
    const float* src = packed + (size_t)j * NCOL;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) sb.col[c][slot] = src[c];
    sb.idx[slot] = j;
  }
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(BLOCK)
k1_forward_kernel(const float* __restrict__ packed, int n,
                  const int4* __restrict__ splat_rect,
                  const int4* __restrict__ batch_rect, int n_batches,
                  int height, int width, float log_term,
                  float* __restrict__ acc, float* __restrict__ tfin,
                  int* __restrict__ lc) {
  __shared__ SharedBatch sb;
  const int tx = blockIdx.x, ty = blockIdx.y, t = threadIdx.x;
  const int px = tx * TILE + (t % TILE), py = ty * TILE + (t / TILE);
  const bool inside = px < width && py < height;
  const float fx = (float)px, fy = (float)py;

  float logT = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int last = -1;
  bool done = !inside;
  for (int b = 0; b < n_batches; ++b) {
    // doubles as the barrier before load_batch overwrites shared memory
    if (__syncthreads_count(done) == BLOCK) break;
    if (!rect_covers(batch_rect[b], tx, ty)) continue;  // uniform per block
    const int count = load_batch(sb, packed, n, splat_rect, b, tx, ty);
    if (done) continue;
    for (int k = 0; k < count; ++k) {
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
    const size_t p = (size_t)py * width + px, hw = (size_t)height * width;
    acc[p] = a0;
    acc[hw + p] = a1;
    acc[2 * hw + p] = a2;
    acc[3 * hw + p] = a3;
    tfin[p] = expf(logT);
    lc[p] = last;
  }
}

__global__ void __launch_bounds__(BLOCK)
k2_backward_kernel(const float* __restrict__ packed, int n,
                   const int4* __restrict__ splat_rect,
                   const int4* __restrict__ batch_rect, int height, int width,
                   const float* __restrict__ g_acc,
                   const float* __restrict__ gtu,
                   const float* __restrict__ tfin,
                   const int* __restrict__ lc, float* __restrict__ dpacked) {
  __shared__ SharedBatch sb;
  __shared__ int s_max_lc;
  const int tx = blockIdx.x, ty = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31;
  const int px = tx * TILE + (t % TILE), py = ty * TILE + (t / TILE);
  const bool inside = px < width && py < height;
  const float fx = (float)px, fy = (float)py;
  const size_t p = (size_t)py * width + px, hw = (size_t)height * width;

  const int my_lc = inside ? lc[p] : -1;
  if (t == 0) s_max_lc = -1;
  __syncthreads();
  int m = my_lc;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) atomicMax(&s_max_lc, m);
  __syncthreads();
  const int max_lc = s_max_lc;
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

  for (int b = max_lc / BATCH; b >= 0; --b) {
    if (!rect_covers(batch_rect[b], tx, ty)) continue;  // uniform per block
    __syncthreads();
    const int count = load_batch(sb, packed, n, splat_rect, b, tx, ty);
    for (int k = count - 1; k >= 0; --k) {
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
      // count is uniform over the block, so every lane reaches this vote
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

}  // namespace

extern "C" int k1_forward(const float* packed, int n, const int* splat_rect,
                          const int* batch_rect, int n_batches, int height,
                          int width, float log_term, float* acc, float* tfin,
                          int* lc, void* stream) {
  const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
  k1_forward_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      packed, n, reinterpret_cast<const int4*>(splat_rect),
      reinterpret_cast<const int4*>(batch_rect), n_batches, height, width,
      log_term, acc, tfin, lc);
  return (int)cudaGetLastError();
}

extern "C" int k2_backward(const float* packed, int n, const int* splat_rect,
                           const int* batch_rect, int height, int width,
                           const float* g_acc, const float* gtu,
                           const float* tfin, const int* lc, float* dpacked,
                           void* stream) {
  const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
  k2_backward_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      packed, n, reinterpret_cast<const int4*>(splat_rect),
      reinterpret_cast<const int4*>(batch_rect), height, width, g_acc, gtu,
      tfin, lc, dpacked);
  return (int)cudaGetLastError();
}
