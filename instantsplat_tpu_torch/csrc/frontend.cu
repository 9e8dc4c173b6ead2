// frontend: the geometry front end of a render (activations, covariance,
// SH shading, EWA projection, the cull) as one forward launch and one
// backward launch, plus a fixed-order sum of the pose gradient; for
// instantsplat_tpu_torch/ops/frontend.py (`frontend_rows`).
//
// Replaces no Pallas kernel. The JAX package computes the front end with
// plain jnp (instantsplat_tpu/ops/frontend.py::compute_columns), which XLA
// fuses. The port's plain version (ops/frontend.py::compute_columns, the
// CPU route and the reference of the tests) is [N]-column arithmetic in
// eager PyTorch that autograd differentiates: ~340 kernels forward and
// ~730 backward at SH degree 0, each a pass over a column of N floats.
//
// What bounds it. Per Gaussian the forward reads 56 B at degree 0 (xyz,
// rotation, scaling, opacity, features_dc) plus 12 B per higher SH
// coefficient it uses, and writes 49 B (a packed row of 10 floats, the
// sort key, the radius, the valid byte); the backward reads the same
// inputs and a 40-byte row of upstream gradients and writes 56 B of
// gradients plus the features_rest row (zeros where the degree does not
// read it). The arithmetic, ~560 operations a Gaussian forward and
// backward, takes a tenth of the time those bytes take at 3.35 TB/s, so
// it is bound by device memory.
//
// The design.
// - One thread a Gaussian, THREADS to a block, in both directions. The
//   SH degree is a template parameter (0-3), so the degree-0 kernels read
//   features_dc alone.
// - Per-view values (the world-to-camera R and t, fx, fy, cx, cy) are
//   read through device pointers, never passed by value: a captured CUDA
//   graph gathers its view on the device before each replay. Host
//   arguments are fixed per graph: N, H, W, the degree, the SH row
//   length, the scale modifier.
// - The forward writes the rows that the depth sort gathers (mx, my,
//   conic a b c, log-opacity with -inf on culled rows, r, g, b, the key
//   with the 1e30 sentinel on culled rows), the key again as a contiguous
//   column for the sort, the radius and the valid flag.
// - Rounding as eager PyTorch on the card: every product, sum and
//   quotient rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
//   __fdiv_rn: nothing is contracted into an FMA) in the order of
//   compute_columns' expressions, expf/logf/rsqrtf/sqrt as torch's
//   kernels call them, no fast math. So the forward's columns, the radius
//   (a ceil) and the valid flag are those of the plain version on the card.
// - The backward recomputes the forward in registers (the same function,
//   so the same bits, culls and tie tests) instead of reading ~40 saved
//   columns, and differentiates it by hand with JAX's tie rule at
//   maximum/minimum (half the gradient to each side of a tie) and
//   torch.where's (none to the branch not taken).
// - The pose gradient (dL/dR, 9, and dL/dt, 3: the view means and the
//   EWA Jacobian's use of R) is summed without float atomics: warp
//   shuffles, a block's warps in order into one row of 12 partials a
//   block, then frontend_pose_reduce_kernel sums the rows in a fixed
//   order. The result is the same bits every call.
// - Each gradient pointer may be null (autograd does not need it): the
//   pose refiner differentiates the pose alone, and a null partials
//   buffer skips the pose sums.
// The kernels allocate nothing and do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NCOL = 10;  // a packed row: mx my ca cb cc lo r g b key
constexpr int POSE = 12;  // dL/dR row-major, then dL/dt
constexpr int WARPS = THREADS / 32;
// ops/projection.py, render/driver.py
constexpr float LOW_PASS = 0.3f;
constexpr float NEAR_CULL_Z = 0.2f;
constexpr float INVALID_DEPTH = 1e30f;
// utils/sh.py
constexpr float SH_C0 = 0.28209479177387814f;
constexpr float SH_C1 = 0.4886025119029199f;
constexpr float SH_C2_0 = 1.0925484305920792f;
constexpr float SH_C2_1 = -1.0925484305920792f;
constexpr float SH_C2_2 = 0.31539156525252005f;
constexpr float SH_C2_3 = -1.0925484305920792f;
constexpr float SH_C2_4 = 0.5462742152960396f;
constexpr float SH_C3_0 = -0.5900435899266435f;
constexpr float SH_C3_1 = 2.890611442640554f;
constexpr float SH_C3_2 = -0.4570457994644658f;
constexpr float SH_C3_3 = 0.3731763325901154f;
constexpr float SH_C3_4 = -0.4570457994644658f;
constexpr float SH_C3_5 = 1.445305721320277f;
constexpr float SH_C3_6 = -0.5900435899266435f;

// one rounding per operation, as one PyTorch kernel per operation gives
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }
// torch.maximum / torch.minimum against a constant (a NaN is kept)
__device__ __forceinline__ float tmax(float x, float f) { return x < f ? f : x; }
__device__ __forceinline__ float tmin(float x, float f) { return x > f ? f : x; }
// the share of the gradient that maximum(x, f) / minimum(x, f) passes to
// x: all, half at a tie, none
__device__ __forceinline__ float max_share(float x, float f) {
  return x < f ? 0.0f : (x == f ? 0.5f : 1.0f);
}
__device__ __forceinline__ float min_share(float x, float f) {
  return x > f ? 0.0f : (x == f ? 0.5f : 1.0f);
}

struct Inputs {
  const float* xyz;    // [N, 3]
  const float* rot;    // [N, 4] wxyz, not normalised
  const float* scl;    // [N, 3] log scales
  const float* opa;    // [N, 1] logit
  const float* fdc;    // [N, 1, 3]
  const float* frest;  // [N, rest, 3]
  int rest;            // SH coefficients a row of frest holds
};

// the view, read through device pointers
struct View {
  float R[9], t[3], fx, fy, cx, cy, limx, limy;
};

__device__ __forceinline__ View load_view(const float* R, const float* t,
                                          const float* fx, const float* fy,
                                          const float* cx, const float* cy,
                                          int height, int width) {
  View v;
#pragma unroll
  for (int k = 0; k < 9; ++k) v.R[k] = __ldg(R + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) v.t[k] = __ldg(t + k);
  v.fx = __ldg(fx);
  v.fy = __ldg(fy);
  v.cx = __ldg(cx);
  v.cy = __ldg(cy);
  // 1.3 tan(fov / 2) = 1.3 * (width / (2 fx)); torch computes a Python
  // number over a tensor as the tensor's reciprocal times the number
  v.limx = mul(1.3f, mul(rcp(mul(2.0f, v.fx)), static_cast<float>(width)));
  v.limy = mul(1.3f, mul(rcp(mul(2.0f, v.fy)), static_cast<float>(height)));
  return v;
}

// the forward's values of one Gaussian, everything the backward reads
template <int DEG>
struct Front {
  static constexpr int K = (DEG + 1) * (DEG + 1);  // SH coefficients used
  float p[3];                      // world mean
  float q[4], qinv;                // raw quaternion, rsqrt of its norm^2
  float w, x, y, z;                // normalised quaternion
  float Q[9];                      // its rotation, row-major
  float e[3], sc[3];               // exp(scaling), activated scales
  float M[9];                      // Q diag(sc)
  float c00, c01, c02, c11, c12, c22;  // M M^T
  float sig, lop, lo;              // sigmoid, its floor, the log
  float vx, vy, vz;                // view-space mean
  float nrm, dinv, dx, dy, dz;     // SH view direction (DEG > 0)
  float f[K][3];                   // SH coefficients
  float B[K];                      // SH basis at the direction
  float col[3];                    // SH sum + 0.5, before the clamp
  float iz, ux, uy, txz, tyz, tx, ty;
  float j00, j02, j11, j12;
  float m0[3], m1[3], s0[3], s1[3];  // J W rows, C times each
  float a, bq, c, det, idet;
  float mx, my, radius;
  bool valid;
};

template <int DEG>
__device__ __forceinline__ void front(int i, const Inputs& in, const View& v,
                                      float smod, int height, int width,
                                      Front<DEG>& s) {
  constexpr int K = Front<DEG>::K;
#pragma unroll
  for (int k = 0; k < 3; ++k) s.p[k] = in.xyz[3 * i + k];
#pragma unroll
  for (int k = 0; k < 4; ++k) s.q[k] = in.rot[4 * i + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.e[k] = expf(in.scl[3 * i + k]);
    s.sc[k] = mul(s.e[k], smod);
  }
  // log(max(sigmoid(o), 1e-12)); torch's sigmoid is 1 / (1 + exp(-o))
  s.sig = __fdiv_rn(1.0f, add(1.0f, expf(-in.opa[i])));
  s.lop = tmax(s.sig, 1e-12f);
  s.lo = logf(s.lop);

  // view-space mean
  s.vx = add(add(add(mul(v.R[0], s.p[0]), mul(v.R[1], s.p[1])),
                 mul(v.R[2], s.p[2])), v.t[0]);
  s.vy = add(add(add(mul(v.R[3], s.p[0]), mul(v.R[4], s.p[1])),
                 mul(v.R[5], s.p[2])), v.t[1]);
  s.vz = add(add(add(mul(v.R[6], s.p[0]), mul(v.R[7], s.p[1])),
                 mul(v.R[8], s.p[2])), v.t[2]);

  // SH colours at the camera-frame view direction
#pragma unroll
  for (int c = 0; c < 3; ++c) s.f[0][c] = in.fdc[3 * i + c];
#pragma unroll
  for (int k = 1; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s.f[k][c] = in.frest[(static_cast<size_t>(i) * in.rest + k - 1) * 3 + c];
  }
  s.B[0] = SH_C0;
  if (DEG > 0) {
    s.nrm = __fsqrt_rn(add(add(mul(s.vx, s.vx), mul(s.vy, s.vy)),
                           mul(s.vz, s.vz)));
    s.dinv = rcp(tmax(s.nrm, 1e-8f));
    s.dx = mul(s.vx, s.dinv);
    s.dy = mul(s.vy, s.dinv);
    s.dz = mul(s.vz, s.dinv);
    const float x = s.dx, y = s.dy, z = s.dz;
    s.B[1] = mul(-SH_C1, y);
    s.B[2] = mul(SH_C1, z);
    s.B[3] = mul(-SH_C1, x);
    if (DEG > 1) {
      const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
      const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
      s.B[4] = mul(SH_C2_0, xy);
      s.B[5] = mul(SH_C2_1, yz);
      s.B[6] = mul(SH_C2_2, sub(sub(mul(2.0f, zz), xx), yy));
      s.B[7] = mul(SH_C2_3, xz);
      s.B[8] = mul(SH_C2_4, sub(xx, yy));
      if (DEG > 2) {
        s.B[9] = mul(mul(SH_C3_0, y), sub(mul(3.0f, xx), yy));
        s.B[10] = mul(mul(SH_C3_1, xy), z);
        s.B[11] = mul(mul(SH_C3_2, y), sub(sub(mul(4.0f, zz), xx), yy));
        s.B[12] = mul(mul(SH_C3_3, z),
                      sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
        s.B[13] = mul(mul(SH_C3_4, x), sub(sub(mul(4.0f, zz), xx), yy));
        s.B[14] = mul(mul(SH_C3_5, z), sub(xx, yy));
        s.B[15] = mul(mul(SH_C3_6, x), sub(xx, mul(3.0f, yy)));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float col = mul(SH_C0, s.f[0][c]);
#pragma unroll
    for (int k = 1; k < K; ++k) col = add(col, mul(s.B[k], s.f[k][c]));
    s.col[c] = add(col, 0.5f);
  }

  // covariance (R S)(R S)^T from the normalised quaternion
  const float n2 = add(add(add(add(mul(s.q[0], s.q[0]), mul(s.q[1], s.q[1])),
                               mul(s.q[2], s.q[2])), mul(s.q[3], s.q[3])),
                       1e-12f);
  s.qinv = rsqrtf(n2);
  s.w = mul(s.q[0], s.qinv);
  s.x = mul(s.q[1], s.qinv);
  s.y = mul(s.q[2], s.qinv);
  s.z = mul(s.q[3], s.qinv);
  {
    const float w = s.w, x = s.x, y = s.y, z = s.z;
    s.Q[0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
    s.Q[1] = mul(2.0f, sub(mul(x, y), mul(w, z)));
    s.Q[2] = mul(2.0f, add(mul(x, z), mul(w, y)));
    s.Q[3] = mul(2.0f, add(mul(x, y), mul(w, z)));
    s.Q[4] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
    s.Q[5] = mul(2.0f, sub(mul(y, z), mul(w, x)));
    s.Q[6] = mul(2.0f, sub(mul(x, z), mul(w, y)));
    s.Q[7] = mul(2.0f, add(mul(y, z), mul(w, x)));
    s.Q[8] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) s.M[3 * r + k] = mul(s.Q[3 * r + k], s.sc[k]);
  }
  const float* M = s.M;
  s.c00 = add(add(mul(M[0], M[0]), mul(M[1], M[1])), mul(M[2], M[2]));
  s.c01 = add(add(mul(M[0], M[3]), mul(M[1], M[4])), mul(M[2], M[5]));
  s.c02 = add(add(mul(M[0], M[6]), mul(M[1], M[7])), mul(M[2], M[8]));
  s.c11 = add(add(mul(M[3], M[3]), mul(M[4], M[4])), mul(M[5], M[5]));
  s.c12 = add(add(mul(M[3], M[6]), mul(M[4], M[7])), mul(M[5], M[8]));
  s.c22 = add(add(mul(M[6], M[6]), mul(M[7], M[7])), mul(M[8], M[8]));

  // EWA projection
  s.iz = rcp(fabsf(s.vz) < 1e-8f ? 1e-8f : s.vz);
  s.ux = mul(s.vx, s.iz);
  s.uy = mul(s.vy, s.iz);
  s.txz = tmin(tmax(s.ux, -v.limx), v.limx);
  s.tyz = tmin(tmax(s.uy, -v.limy), v.limy);
  s.tx = mul(s.txz, s.vz);
  s.ty = mul(s.tyz, s.vz);
  s.j00 = mul(v.fx, s.iz);
  s.j02 = mul(mul(mul(-v.fx, s.tx), s.iz), s.iz);
  s.j11 = mul(v.fy, s.iz);
  s.j12 = mul(mul(mul(-v.fy, s.ty), s.iz), s.iz);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.m0[k] = add(mul(s.j00, v.R[k]), mul(s.j02, v.R[6 + k]));
    s.m1[k] = add(mul(s.j11, v.R[3 + k]), mul(s.j12, v.R[6 + k]));
  }
  const float cm[9] = {s.c00, s.c01, s.c02, s.c01, s.c11,
                       s.c12, s.c02, s.c12, s.c22};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    s.s0[r] = add(add(mul(cm[3 * r], s.m0[0]), mul(cm[3 * r + 1], s.m0[1])),
                  mul(cm[3 * r + 2], s.m0[2]));
    s.s1[r] = add(add(mul(cm[3 * r], s.m1[0]), mul(cm[3 * r + 1], s.m1[1])),
                  mul(cm[3 * r + 2], s.m1[2]));
  }
  s.a = add(add(add(mul(s.m0[0], s.s0[0]), mul(s.m0[1], s.s0[1])),
                mul(s.m0[2], s.s0[2])), LOW_PASS);
  s.bq = add(add(mul(s.m0[0], s.s1[0]), mul(s.m0[1], s.s1[1])),
             mul(s.m0[2], s.s1[2]));
  s.c = add(add(add(mul(s.m1[0], s.s1[0]), mul(s.m1[1], s.s1[1])),
                mul(s.m1[2], s.s1[2])), LOW_PASS);
  s.det = sub(mul(s.a, s.c), mul(s.bq, s.bq));
  s.idet = rcp(s.det <= 0.0f ? 1.0f : s.det);

  const float mid = mul(0.5f, add(s.a, s.c));
  const float lam1 = add(mid, __fsqrt_rn(tmax(sub(mul(mid, mid), s.det),
                                              0.1f)));
  const float radius = ceilf(mul(3.0f, __fsqrt_rn(lam1)));
  s.mx = add(mul(mul(v.fx, s.tx), s.iz), v.cx);
  s.my = add(mul(mul(v.fy, s.ty), s.iz), v.cy);
  s.valid = s.vz > NEAR_CULL_Z && s.det > 0.0f &&
            add(s.mx, radius) > 0.0f &&
            sub(s.mx, radius) < static_cast<float>(width) &&
            add(s.my, radius) > 0.0f &&
            sub(s.my, radius) < static_cast<float>(height);
  s.radius = s.valid ? radius : 0.0f;
}

template <int DEG>
__global__ void __launch_bounds__(THREADS)
    frontend_forward_kernel(Inputs in, const float* R, const float* t,
                            const float* fx, const float* fy, const float* cx,
                            const float* cy, float smod, int n, int height,
                            int width, float* __restrict__ rows,
                            float* __restrict__ key,
                            float* __restrict__ radius,
                            bool* __restrict__ valid) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const View v = load_view(R, t, fx, fy, cx, cy, height, width);
  Front<DEG> s;
  front<DEG>(i, in, v, smod, height, width, s);
  const float k = s.valid ? s.vz : INVALID_DEPTH;
  float* row = rows + static_cast<size_t>(i) * NCOL;
  row[0] = s.mx;
  row[1] = s.my;
  row[2] = mul(s.c, s.idet);
  row[3] = mul(-s.bq, s.idet);
  row[4] = mul(s.a, s.idet);
  row[5] = s.valid ? s.lo : -__int_as_float(0x7f800000);
#pragma unroll
  for (int c = 0; c < 3; ++c) row[6 + c] = tmax(s.col[c], 0.0f);
  row[9] = k;
  key[i] = k;
  radius[i] = s.radius;
  valid[i] = s.valid;
}

// warp lane 0 gets the warp's sum, always added in the same order
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

template <int DEG>
__global__ void __launch_bounds__(THREADS)
    frontend_backward_kernel(Inputs in, const float* R, const float* t,
                             const float* fx, const float* fy,
                             const float* cx, const float* cy, float smod,
                             int n, int height, int width,
                             const float* __restrict__ g_rows,
                             float* __restrict__ g_xyz,
                             float* __restrict__ g_rot,
                             float* __restrict__ g_scl,
                             float* __restrict__ g_opa,
                             float* __restrict__ g_fdc,
                             float* __restrict__ g_frest,
                             float* __restrict__ partials) {
  constexpr int K = Front<DEG>::K;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const View v = load_view(R, t, fx, fy, cx, cy, height, width);
  float pose[POSE];
#pragma unroll
  for (int k = 0; k < POSE; ++k) pose[k] = 0.0f;

  if (i < n) {
    Front<DEG> s;
    front<DEG>(i, in, v, smod, height, width, s);
    const float* g = g_rows + static_cast<size_t>(i) * NCOL;
    const float g_mx = g[0], g_my = g[1], g_ca = g[2], g_cb = g[3],
                g_cc = g[4];
    // the packed row's -inf and 1e30 on a culled row pass nothing back
    const float g_lo = s.valid ? g[5] : 0.0f;
    const float g_depth = s.valid ? g[9] : 0.0f;

    // screen-space mean: m = f t iz + c
    float d_tx = g_mx * v.fx * s.iz, d_ty = g_my * v.fy * s.iz;
    float d_iz = g_mx * v.fx * s.tx + g_my * v.fy * s.ty;
    // conic: (c, -b, a) / det, det kept where it is positive
    const float d_idet = g_ca * s.c - g_cb * s.bq + g_cc * s.a;
    float d_a = g_cc * s.idet, d_bq = -g_cb * s.idet, d_c = g_ca * s.idet;
    const float d_det =
        s.det <= 0.0f ? 0.0f : -d_idet * (s.idet * s.idet);
    d_a += d_det * s.c;
    d_c += d_det * s.a;
    d_bq -= 2.0f * s.bq * d_det;
    // a = m0.C m0 + 0.3, b = m0.C m1, c = m1.C m1 + 0.3
    float d_m0[3], d_m1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d_m0[k] = 2.0f * d_a * s.s0[k] + d_bq * s.s1[k];
      d_m1[k] = d_bq * s.s0[k] + 2.0f * d_c * s.s1[k];
    }
    const float* m0 = s.m0;
    const float* m1 = s.m1;
    const float dc00 = d_a * m0[0] * m0[0] + d_bq * m0[0] * m1[0] +
                       d_c * m1[0] * m1[0];
    const float dc11 = d_a * m0[1] * m0[1] + d_bq * m0[1] * m1[1] +
                       d_c * m1[1] * m1[1];
    const float dc22 = d_a * m0[2] * m0[2] + d_bq * m0[2] * m1[2] +
                       d_c * m1[2] * m1[2];
    const float dc01 = 2.0f * d_a * m0[0] * m0[1] +
                       d_bq * (m0[0] * m1[1] + m0[1] * m1[0]) +
                       2.0f * d_c * m1[0] * m1[1];
    const float dc02 = 2.0f * d_a * m0[0] * m0[2] +
                       d_bq * (m0[0] * m1[2] + m0[2] * m1[0]) +
                       2.0f * d_c * m1[0] * m1[2];
    const float dc12 = 2.0f * d_a * m0[1] * m0[2] +
                       d_bq * (m0[1] * m1[2] + m0[2] * m1[1]) +
                       2.0f * d_c * m1[1] * m1[2];
    // J W rows: m0 = j00 R0 + j02 R2, m1 = j11 R1 + j12 R2
    float d_j00 = 0.0f, d_j02 = 0.0f, d_j11 = 0.0f, d_j12 = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d_j00 += d_m0[k] * v.R[k];
      d_j02 += d_m0[k] * v.R[6 + k];
      d_j11 += d_m1[k] * v.R[3 + k];
      d_j12 += d_m1[k] * v.R[6 + k];
      pose[k] += s.j00 * d_m0[k];
      pose[3 + k] += s.j11 * d_m1[k];
      pose[6 + k] += s.j02 * d_m0[k] + s.j12 * d_m1[k];
    }
    // J: j00 = fx iz, j02 = -fx tx iz^2 (and y)
    d_iz += v.fx * d_j00 + v.fy * d_j11 -
            2.0f * v.fx * s.tx * s.iz * d_j02 -
            2.0f * v.fy * s.ty * s.iz * d_j12;
    d_tx -= v.fx * s.iz * s.iz * d_j02;
    d_ty -= v.fy * s.iz * s.iz * d_j12;
    // t = clamp(v / z) z
    float d_vz = g_depth + d_tx * s.txz + d_ty * s.tyz;
    const float d_ux = d_tx * s.vz * max_share(s.ux, -v.limx) *
                       min_share(tmax(s.ux, -v.limx), v.limx);
    const float d_uy = d_ty * s.vz * max_share(s.uy, -v.limy) *
                       min_share(tmax(s.uy, -v.limy), v.limy);
    float d_vx = d_ux * s.iz, d_vy = d_uy * s.iz;
    d_iz += d_ux * s.vx + d_uy * s.vy;
    // iz = 1 / z, z kept where |z| >= 1e-8
    if (!(fabsf(s.vz) < 1e-8f)) d_vz -= d_iz * s.iz * s.iz;

    // colours: max(SH + 0.5, 0)
    float d_col[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      d_col[c] = g[6 + c] * max_share(s.col[c], 0.0f);
    if (DEG > 0) {
      float dB[K];
#pragma unroll
      for (int k = 1; k < K; ++k)
        dB[k] = s.f[k][0] * d_col[0] + s.f[k][1] * d_col[1] +
                s.f[k][2] * d_col[2];
      const float x = s.dx, y = s.dy, z = s.dz;
      float ddx = -SH_C1 * dB[3], ddy = -SH_C1 * dB[1], ddz = SH_C1 * dB[2];
      if (DEG > 1) {
        ddx += SH_C2_0 * y * dB[4] - 2.0f * SH_C2_2 * x * dB[6] +
               SH_C2_3 * z * dB[7] + 2.0f * SH_C2_4 * x * dB[8];
        ddy += SH_C2_0 * x * dB[4] + SH_C2_1 * z * dB[5] -
               2.0f * SH_C2_2 * y * dB[6] - 2.0f * SH_C2_4 * y * dB[8];
        ddz += SH_C2_1 * y * dB[5] + 4.0f * SH_C2_2 * z * dB[6] +
               SH_C2_3 * x * dB[7];
        if (DEG > 2) {
          const float xx = x * x, yy = y * y, zz = z * z;
          ddx += SH_C3_0 * 6.0f * x * y * dB[9] + SH_C3_1 * y * z * dB[10] -
                 SH_C3_2 * 2.0f * x * y * dB[11] -
                 SH_C3_3 * 6.0f * x * z * dB[12] +
                 SH_C3_4 * (4.0f * zz - 3.0f * xx - yy) * dB[13] +
                 SH_C3_5 * 2.0f * x * z * dB[14] +
                 SH_C3_6 * 3.0f * (xx - yy) * dB[15];
          ddy += SH_C3_0 * 3.0f * (xx - yy) * dB[9] +
                 SH_C3_1 * x * z * dB[10] +
                 SH_C3_2 * (4.0f * zz - xx - 3.0f * yy) * dB[11] -
                 SH_C3_3 * 6.0f * y * z * dB[12] -
                 SH_C3_4 * 2.0f * x * y * dB[13] -
                 SH_C3_5 * 2.0f * y * z * dB[14] -
                 SH_C3_6 * 6.0f * x * y * dB[15];
          ddz += SH_C3_1 * x * y * dB[10] + SH_C3_2 * 8.0f * y * z * dB[11] +
                 SH_C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * dB[12] +
                 SH_C3_4 * 8.0f * x * z * dB[13] +
                 SH_C3_5 * (xx - yy) * dB[14];
        }
      }
      // direction = v / max(|v|, 1e-8)
      d_vx += s.dinv * ddx;
      d_vy += s.dinv * ddy;
      d_vz += s.dinv * ddz;
      const float d_dinv = s.vx * ddx + s.vy * ddy + s.vz * ddz;
      const float d_nrm =
          -d_dinv * (s.dinv * s.dinv) * max_share(s.nrm, 1e-8f);
      const float d_n2 = d_nrm / (2.0f * s.nrm);
      d_vx += 2.0f * s.vx * d_n2;
      d_vy += 2.0f * s.vy * d_n2;
      d_vz += 2.0f * s.vz * d_n2;
    }

    // view-space mean: v = R p + t
    const float d_v[3] = {d_vx, d_vy, d_vz};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int k = 0; k < 3; ++k) pose[3 * r + k] += d_v[r] * s.p[k];
      pose[9 + r] += d_v[r];
    }

    if (g_xyz) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        g_xyz[3 * i + k] =
            v.R[k] * d_vx + v.R[3 + k] * d_vy + v.R[6 + k] * d_vz;
    }
    if (g_fdc) {
#pragma unroll
      for (int c = 0; c < 3; ++c) g_fdc[3 * i + c] = SH_C0 * d_col[c];
    }
    // a degree-0 block's features_rest rows are one contiguous run: they
    // are zeroed by the whole block below
    if (g_frest && DEG > 0) {
      float* gr = g_frest + static_cast<size_t>(i) * in.rest * 3;
      for (int k = 1; k <= in.rest; ++k) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          gr[3 * (k - 1) + c] = k < K ? s.B[k] * d_col[c] : 0.0f;
      }
    }
    if (g_opa) {
      // log(max(sigmoid(o), 1e-12))
      const float d_sig = g_lo / s.lop * max_share(s.sig, 1e-12f);
      g_opa[i] = d_sig * (1.0f - s.sig) * s.sig;
    }
    if (g_scl || g_rot) {
      // C = M M^T, M = Q diag(sc)
      const float* M = s.M;
      float dM[9];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dM[k] = 2.0f * dc00 * M[k] + dc01 * M[3 + k] + dc02 * M[6 + k];
        dM[3 + k] = dc01 * M[k] + 2.0f * dc11 * M[3 + k] + dc12 * M[6 + k];
        dM[6 + k] = dc02 * M[k] + dc12 * M[3 + k] + 2.0f * dc22 * M[6 + k];
      }
      if (g_scl) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float d_sc =
              dM[k] * s.Q[k] + dM[3 + k] * s.Q[3 + k] + dM[6 + k] * s.Q[6 + k];
          g_scl[3 * i + k] = d_sc * smod * s.e[k];
        }
      }
      if (g_rot) {
        float dQ[9];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int k = 0; k < 3; ++k) dQ[3 * r + k] = dM[3 * r + k] * s.sc[k];
        }
        const float w = s.w, x = s.x, y = s.y, z = s.z;
        const float dw = 2.0f * (-z * dQ[1] + y * dQ[2] + z * dQ[3] -
                                 x * dQ[5] - y * dQ[6] + x * dQ[7]);
        const float dx = 2.0f * (y * dQ[1] + z * dQ[2] + y * dQ[3] -
                                 2.0f * x * dQ[4] - w * dQ[5] + z * dQ[6] +
                                 w * dQ[7] - 2.0f * x * dQ[8]);
        const float dy = 2.0f * (-2.0f * y * dQ[0] + x * dQ[1] + w * dQ[2] +
                                 x * dQ[3] + z * dQ[5] - w * dQ[6] +
                                 z * dQ[7] - 2.0f * y * dQ[8]);
        const float dz = 2.0f * (-2.0f * z * dQ[0] - w * dQ[1] + x * dQ[2] +
                                 w * dQ[3] - 2.0f * z * dQ[4] + y * dQ[5] +
                                 x * dQ[6] + y * dQ[7]);
        // (w, x, y, z) = q * rsqrt(|q|^2 + 1e-12)
        const float d_inv =
            dw * s.q[0] + dx * s.q[1] + dy * s.q[2] + dz * s.q[3];
        const float d_n2 = -0.5f * d_inv * s.qinv * s.qinv * s.qinv;
        const float dq[4] = {dw, dx, dy, dz};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          g_rot[4 * i + k] = dq[k] * s.qinv + 2.0f * s.q[k] * d_n2;
      }
    }
  }

  if (DEG == 0 && g_frest && in.rest > 0) {
    // this block's features_rest rows, zeroed by the block together
    const size_t first = static_cast<size_t>(blockIdx.x) * THREADS;
    const size_t last = first + THREADS < static_cast<size_t>(n)
                            ? first + THREADS
                            : static_cast<size_t>(n);
    const size_t stride = static_cast<size_t>(in.rest) * 3;
    for (size_t f = first * stride + threadIdx.x; f < last * stride;
         f += THREADS)
      g_frest[f] = 0.0f;
  }

  if (partials) {
    // the block's pose sums: each warp by shuffles, then the warps in
    // order, into the block's row
    __shared__ float warp_rows[WARPS][POSE];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < POSE; ++k) {
      const float sum = warp_sum(pose[k]);
      if (lane == 0) warp_rows[warp][k] = sum;
    }
    __syncthreads();
    if (threadIdx.x < POSE) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += warp_rows[w][threadIdx.x];
      partials[static_cast<size_t>(blockIdx.x) * POSE + threadIdx.x] = sum;
    }
  }
}

// out[k] = the sum of partials[:, k]; warp k sums column k, lane l rows
// l, l + 32, ..., then the lanes by shuffles
__global__ void __launch_bounds__(32 * POSE)
    frontend_pose_reduce_kernel(const float* __restrict__ partials,
                                int rows, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, col = threadIdx.x >> 5;
  float sum = 0.0f;
  for (int r = lane; r < rows; r += 32)
    sum += partials[static_cast<size_t>(r) * POSE + col];
  sum = warp_sum(sum);
  if (lane == 0) out[col] = sum;
}

Inputs inputs(const float* xyz, const float* rot, const float* scl,
              const float* opa, const float* fdc, const float* frest,
              int rest) {
  return Inputs{xyz, rot, scl, opa, fdc, frest, rest};
}

int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// xyz [n,3], rot [n,4], scl [n,3], opa [n,1], fdc [n,1,3], frest
// [n,rest,3], float32, contiguous; R [3,3], t [3], fx, fy, cx, cy
// float32 on the device; degree 0-3 with (degree+1)^2 - 1 <= rest.
// Writes rows [n,10], key [n], radius [n] (float32) and valid [n]
// (bool). Returns the launch's cudaError (-1 for a degree outside 0-3).
extern "C" int frontend_forward(const float* xyz, const float* rot,
                                const float* scl, const float* opa,
                                const float* fdc, const float* frest,
                                int rest, const float* R, const float* t,
                                const float* fx, const float* fy,
                                const float* cx, const float* cy, float smod,
                                int degree, int n, int height, int width,
                                float* rows, float* key, float* radius,
                                bool* valid, void* stream) {
  const Inputs in = inputs(xyz, rot, scl, opa, fdc, frest, rest);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FRONTEND_FORWARD(D)                                                 \
  frontend_forward_kernel<D><<<blocks(n), THREADS, 0, s>>>(                 \
      in, R, t, fx, fy, cx, cy, smod, n, height, width, rows, key, radius, \
      valid)
  switch (degree) {
    case 0: FRONTEND_FORWARD(0); break;
    case 1: FRONTEND_FORWARD(1); break;
    case 2: FRONTEND_FORWARD(2); break;
    case 3: FRONTEND_FORWARD(3); break;
    default: return -1;
  }
#undef FRONTEND_FORWARD
  return static_cast<int>(cudaGetLastError());
}

// The inputs as frontend_forward's; g_rows [n,10] the gradient of rows;
// each gradient (shaped as its input) may be null; partials, when not
// null, [ceil(n / 256), 12].
extern "C" int frontend_backward(const float* xyz, const float* rot,
                                 const float* scl, const float* opa,
                                 const float* fdc, const float* frest,
                                 int rest, const float* R, const float* t,
                                 const float* fx, const float* fy,
                                 const float* cx, const float* cy,
                                 float smod, int degree, int n, int height,
                                 int width, const float* g_rows,
                                 float* g_xyz, float* g_rot, float* g_scl,
                                 float* g_opa, float* g_fdc, float* g_frest,
                                 float* partials, void* stream) {
  const Inputs in = inputs(xyz, rot, scl, opa, fdc, frest, rest);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FRONTEND_BACKWARD(D)                                                \
  frontend_backward_kernel<D><<<blocks(n), THREADS, 0, s>>>(                \
      in, R, t, fx, fy, cx, cy, smod, n, height, width, g_rows, g_xyz,     \
      g_rot, g_scl, g_opa, g_fdc, g_frest, partials)
  switch (degree) {
    case 0: FRONTEND_BACKWARD(0); break;
    case 1: FRONTEND_BACKWARD(1); break;
    case 2: FRONTEND_BACKWARD(2); break;
    case 3: FRONTEND_BACKWARD(3); break;
    default: return -1;
  }
#undef FRONTEND_BACKWARD
  return static_cast<int>(cudaGetLastError());
}

// out [12] = dL/dR (row-major), dL/dt: the column sums of partials
// [rows, 12], in a fixed order.
extern "C" int frontend_pose_reduce(const float* partials, int rows,
                                    float* out, void* stream) {
  frontend_pose_reduce_kernel<<<1, 32 * POSE, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      partials, rows, out);
  return static_cast<int>(cudaGetLastError());
}
