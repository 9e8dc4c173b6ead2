// What the dense compositor (rasterize.cu: K1, K2) and the list compositors
// (rasterize_lists.cu: K3-K6) share: a CTA of 256 threads, one per pixel, a
// warp per 8x4-pixel block; a chunk of 256 queued splats in shared memory
// with each splat's block mask; per-warp lists; the per-pair arithmetic of
// the forward and of the backward walk; the warp and block sums of the
// gradients. The header notes of the two sources say what bounds each
// kernel and which of these pieces answers it.
//
// ops/cuda_build.py hashes every header of csrc/ with the source, so an
// edit here rebuilds both libraries.

#pragma once

#include <cuda_runtime.h>

// Built with -DPHASE_CLOCKS (scripts/torch_dense_phases.py), thread 0 of
// every CTA adds the clock64() cycles it spends in each phase of a kernel
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

constexpr int TILE = 16;     // pixels per side of a rectangle-pass tile
constexpr int BLOCK = 256;   // threads per CTA, one per pixel
constexpr int NWARP = BLOCK / 32;
constexpr int BLOCK_W = 8, BLOCK_H = 4;  // pixels of a CTA that a warp owns
constexpr int NCOL = 10;     // packed columns
constexpr int CHUNK = BLOCK; // queue entries composited at a time
constexpr int GRAD_W = 12;   // floats per splat in the gradient scratch
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

// A tile rectangle is (x_lo, x_hi, y_lo, y_hi) as 4 x int16, read as two
// ints; an empty one is (32767, -1, 32767, -1).
__device__ __forceinline__ int pack16(int lo, int hi) {
  return (int)(((unsigned)hi << 16) | ((unsigned)lo & 0xffffu));
}
__device__ __forceinline__ int low16(int v) { return (int)(short)(v & 0xffff); }
__device__ __forceinline__ int high16(int v) { return v >> 16; }

struct Slot {     // one queued splat in shared memory
  float4 q0;      // mx, my, log-opacity, (unused)
  float4 q1;      // conic a, b, c, global sorted index (bits)
  float4 q2;      // r, g, b, depth
};

struct Chunk {                          // the queue entries being composited
  Slot slots[CHUNK];
  unsigned char blocks[CHUNK];          // their block masks
  unsigned char mine[NWARP][CHUNK];     // per warp: the slots that reach it
};

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

// The 8x4-pixel blocks of a CTA's ROWS x (8 BLOCKS_X) pixels at pixel
// origin (x0, y0), one per warp (bit = block row * BLOCKS_X + block
// column), in which the splat can reach alpha >= 1/255: the least of
// q = ca dx^2 + 2 cb dx dy + cc dy^2 over each pixel row's x range (at
// dx = -cb dy / ca, clamped to the range) against 2 (lo - log(1/255)),
// with a slack far above the rounding of this and of the compositor's own
// power.
template <int ROWS, int BLOCKS_X>
__device__ __forceinline__ unsigned block_mask(float mx, float my, float ca,
                                               float cb, float cc, float lo,
                                               float log_alpha_eps, int x0,
                                               int y0) {
  static_assert(ROWS % BLOCK_H == 0 && ROWS / BLOCK_H * BLOCKS_X == NWARP,
                "a warp per block");
  const float m2 = 2.f * (lo - log_alpha_eps) + 1e-2f;
  const float slope = -cb / ca;
  const float xr = (float)x0 - mx;
  unsigned mask = 0u;
#pragma unroll 1
  for (int row = 0; row < ROWS; ++row) {
    const float dy = (float)(y0 + row) - my;
    const float t3 = cc * dy * dy, at = slope * dy;
#pragma unroll
    for (int bx = 0; bx < BLOCKS_X; ++bx) {
      const float lo_x = xr + (float)(bx * BLOCK_W);
      const float dx = fminf(fmaxf(at, lo_x), lo_x + (float)(BLOCK_W - 1));
      const float t1 = ca * dx * dx, t2 = 2.f * cb * dx * dy;
      if (t1 + t2 + t3 <= m2 + 1e-5f * (t1 + fabsf(t2) + t3))
        mask |= 1u << ((row / BLOCK_H) * BLOCKS_X + bx);
    }
  }
  return mask;
}

// Thread t brings queue entry j into slot t: five 8-byte loads, the block
// mask, three 16-byte stores.
template <int ROWS, int BLOCKS_X>
__device__ __forceinline__ void load_slot(Chunk& ch,
                                          const float* __restrict__ packed,
                                          int j, float log_alpha_eps, int x0,
                                          int y0) {
  const int t = threadIdx.x;
  const float2* src =
      reinterpret_cast<const float2*>(packed + (size_t)j * NCOL);
  float2 v[5];
#pragma unroll
  for (int u = 0; u < 5; ++u) v[u] = __ldg(src + u);
  ch.blocks[t] = (unsigned char)block_mask<ROWS, BLOCKS_X>(
      v[0].x, v[0].y, v[1].x, v[1].y, v[2].x, v[2].y, log_alpha_eps, x0, y0);
  ch.slots[t].q0 = make_float4(v[0].x, v[0].y, v[2].y, 0.f);
  ch.slots[t].q1 = make_float4(v[1].x, v[1].y, v[2].x, __int_as_float(j));
  ch.slots[t].q2 = make_float4(v[3].x, v[3].y, v[4].x, v[4].y);
}

// The chunk's slots whose block mask marks this warp's block, in order,
// into the warp's own list; returns how many.
__device__ __forceinline__ int build_list(Chunk& ch, int cnt, int warp,
                                          int lane) {
  int n = 0;
  for (int i = 0; i < cnt; i += 32) {
    const int k = i + lane;
    const bool has = k < cnt && ((ch.blocks[k] >> warp) & 1);
    const unsigned b = __ballot_sync(FULL, has);
    if (has) ch.mine[warp][n + __popc(b & ((1u << lane) - 1u))] = (unsigned char)k;
    n += __popc(b);
  }
  __syncwarp();
  return n;
}

// ---------------------------------------------------------------------------
// forward
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

  __device__ __forceinline__ void store(int px, int py, int height, int width,
                                        float* __restrict__ acc,
                                        float* __restrict__ tfin,
                                        int* __restrict__ lc) const {
    const size_t p = (size_t)py * width + px, hw = (size_t)height * width;
    acc[p] = a0;
    acc[hw + p] = a1;
    acc[2 * hw + p] = a2;
    acc[3 * hw + p] = a3;
    tfin[p] = expf(logT);
    lc[p] = last;
  }
};

// Composites the first n_mine slots of the warp's list onto the pixel at
// (fx, fy), front to back, until its latched stop fires (`done`). Two slots
// at a time: their alphas are independent, only the transmittance is
// carried from one to the next.
__device__ __forceinline__ void walk_forward(const Chunk& ch, int n_mine,
                                             int warp, float fx, float fy,
                                             float log_term, Pixel& pixel,
                                             bool& done) {
  for (int i = 0; i < n_mine && !done; i += 2) {
    const bool two = i + 1 < n_mine;
    const int ka = ch.mine[warp][i], kb = ch.mine[warp][two ? i + 1 : i];
    const float4 q0a = ch.slots[ka].q0, q1a = ch.slots[ka].q1;
    const float4 q0b = ch.slots[kb].q0, q1b = ch.slots[kb].q1;
    const float pa = falloff_power(fx - q0a.x, fy - q0a.y, q1a.x, q1a.y, q1a.z);
    const float pb = falloff_power(fx - q0b.x, fy - q0b.y, q1b.x, q1b.y, q1b.z);
    const float ea = __fadd_rn(pa, q0a.z), eb = __fadd_rn(pb, q0b.z);
    const float alpha_a = fminf(ALPHA_MAX, expf(ea));
    const float alpha_b = fminf(ALPHA_MAX, expf(eb));
    const bool va = !(pa > 0.f) && !(alpha_a < ALPHA_EPS);
    const bool vb = two && !(pb > 0.f) && !(alpha_b < ALPHA_EPS);
    if (!va && !vb) continue;
    const float la = log1pf(-alpha_a), lb = log1pf(-alpha_b);
    if (va && !pixel.add(alpha_a, la, ch.slots[ka].q2, q1a.w, log_term)) {
      done = true;
      break;
    }
    if (vb && !pixel.add(alpha_b, lb, ch.slots[kb].q2, q1b.w, log_term)) {
      done = true;
      break;
    }
  }
}

// ---------------------------------------------------------------------------
// backward
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

struct PixelGrad {  // one pixel's state in the backward walk
  float fx, fy;
  int my_lc;        // the pixel's last contributor; later splats are skipped
  float gt = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f;  // cotangents
  float logT = 0.f; // log T behind the splats walked so far
  float S = 0.f;    // sum over later contributors of w * (g . c)

  __device__ __forceinline__ void load(bool inside, int px, int py,
                                       int height, int width,
                                       const float* __restrict__ g_acc,
                                       const float* __restrict__ gtu,
                                       const float* __restrict__ tfin) {
    if (!inside) return;
    const size_t p = (size_t)py * width + px, hw = (size_t)height * width;
    logT = logf(fmaxf(tfin[p], 1e-30f));
    gt = gtu[p];
    g0 = g_acc[p];
    g1 = g_acc[hw + p];
    g2 = g_acc[2 * hw + p];
    g3 = g_acc[3 * hw + p];
  }
};

// The first n_mine slots of the warp's list, back to front: each pixel
// rebuilds the transmittance incident on each contributor by subtracting
// log(1 - alpha) from log T, carries S, and forms d alpha = (g . c) T -
// (S + g_T T_final) / (1 - alpha). The warp sums the ten gradients with a
// halving butterfly (12 shuffles: 10 values -> 5 -> 3 -> 2 -> 1, then the
// pair) and ten lanes add the totals to the slot's sums in shared memory.
__device__ __forceinline__ void walk_backward(const Chunk& ch,
                                              float (*gsum)[GRAD_W],
                                              int n_mine, int warp, int lane,
                                              PixelGrad& px) {
  // the column this lane holds after the butterfly (see halve): the steps
  // 16, 8, 4, 2 add 5, 3, 2, 1 to the position for a set lane bit; a
  // position past the step's count holds padding
  const int p2 = (lane & 2 ? 1 : 0);
  const int p4 = p2 + (lane & 4 ? 2 : 0);
  const int p8 = p4 + (lane & 8 ? 3 : 0);
  const int col = p8 + (lane & 16 ? 5 : 0);
  const bool holds = !(lane & 1) && p4 < 3 && p8 < 5;

  for (int i = n_mine - 1; i >= 0; --i) {
    const int k = ch.mine[warp][i];
    const float4 q0 = ch.slots[k].q0, q1 = ch.slots[k].q1;
    float d[NCOL];
#pragma unroll
    for (int c = 0; c < NCOL; ++c) d[c] = 0.f;
    bool contrib = false;
    if (__float_as_int(q1.w) <= px.my_lc) {
      const float ca = q1.x, cb = q1.y, cc = q1.z;
      const float dx = px.fx - q0.x, dy = px.fy - q0.y;
      const float power = falloff_power(dx, dy, ca, cb, cc);
      const float e = __fadd_rn(power, q0.z);
      const float a_un = expf(e);
      const float alpha = fminf(ALPHA_MAX, a_un);
      if (power <= 0.f && alpha >= ALPHA_EPS) {
        contrib = true;
        px.logT -= log1pf(-alpha);  // log T incident on this splat
        const float T = expf(px.logT);
        const float w = alpha * T;
        const float4 q2 = ch.slots[k].q2;
        const float b1 =
            px.g0 * q2.x + px.g1 * q2.y + px.g2 * q2.z + px.g3 * q2.w;
        const float dalpha = b1 * T - (px.S + px.gt) / (1.f - alpha);
        px.S += w * b1;
        const float dpow = dalpha * (a_un < ALPHA_MAX ? a_un : 0.f);
        d[0] = dpow * (ca * dx + cb * dy);
        d[1] = dpow * (cc * dy + cb * dx);
        d[2] = dpow * (-0.5f * dx * dx);
        d[3] = dpow * (-dx * dy);
        d[4] = dpow * (-0.5f * dy * dy);
        d[5] = dpow;
        d[6] = w * px.g0;
        d[7] = w * px.g1;
        d[8] = w * px.g2;
        d[9] = w * px.g3;
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
}

// After a chunk's walk and a barrier: thread t < cnt adds slot t's sums,
// the gradient of splat j, to the global scratch [N, GRAD_W] with three
// 16-byte atomicAdd(float4*) and clears them. Three vector atomics per
// (splat, CTA); their order varies, so the sums vary in the last bits from
// run to run.
__device__ __forceinline__ void flush_sums(float (*gsum)[GRAD_W], int cnt,
                                           int j,
                                           float* __restrict__ dscratch) {
  const int t = threadIdx.x;
  if (t >= cnt) return;
  const float4* s4 = reinterpret_cast<const float4*>(gsum[t]);
  const float4 v0 = s4[0], v1 = s4[1], v2 = s4[2];
  const bool any = v0.x != 0.f || v0.y != 0.f || v0.z != 0.f ||
                   v0.w != 0.f || v1.x != 0.f || v1.y != 0.f ||
                   v1.z != 0.f || v1.w != 0.f || v2.x != 0.f || v2.y != 0.f;
  if (!any) return;
  float4* dst = reinterpret_cast<float4*>(dscratch + (size_t)j * GRAD_W);
  atomicAdd(dst, v0);
  atomicAdd(dst + 1, v1);
  atomicAdd(dst + 2, v2);
#pragma unroll
  for (int c = 0; c < GRAD_W; ++c) gsum[t][c] = 0.f;
}

// The largest last-contributor index over the CTA's pixels (-1: none).
// `s_max` is one int of shared memory; two barriers.
__device__ __forceinline__ int block_max_lc(int my_lc, int* s_max) {
  if (threadIdx.x == 0) *s_max = -1;
  __syncthreads();
  int m = my_lc;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(FULL, m, o));
  if ((threadIdx.x & 31) == 0) atomicMax(s_max, m);
  __syncthreads();
  return *s_max;
}

}  // namespace
