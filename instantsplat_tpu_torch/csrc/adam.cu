// adam: one Adam step over the seven parameter groups of a GaussianModel
// as two launches; for instantsplat_tpu_torch/ops/adam.py (`fused_step`,
// which GaussianOptimizer.apply_step calls on CUDA tensors).
//
// Replaces no Pallas kernel. The JAX package's Adam is plain jnp
// (instantsplat_tpu/opt/gaussian_opt.py), which XLA fuses. The port's plain
// version (GaussianOptimizer.apply_step_plain, the CPU route and the
// reference of the tests) runs ~18 PyTorch elementwise ops a group, each a
// pass over the group with a full-size temporary, a sum(g*g) reduction and
// two copies back: ~42 passes over every element.
//
// What bounds it. Per element the update reads p, g, m, v and writes p, m,
// v (28 B); a group whose whole-tensor skip holds reads p, m, v and writes
// p (16 B); xyz reads a per-point rate besides (4 B a Gaussian). The flag
// pass reads every gradient once (4 B an element). A few operations an
// element: bound by device memory.
//
// The design.
// - adam_flags_kernel (pp_optimizer only) reads every group's gradient and
//   sets two integer flags a group with integer atomics: some
//   __fmul_rn(g, g) > 0, and some g*g is NaN. The plain version's rule
//   torch.sum(g*g) > 0 holds exactly when the first is set and the second
//   is not (a sum of non-negative terms is positive iff one term is, and
//   NaN iff one term is), underflow and NaN included. The flags are
//   zeroed by a memset in front of the launch.
// - adam_update_kernel<PP> is multi-tensor: a table of the groups (their
//   pointers, element counts and first blocks) passed by value; each block
//   takes CHUNK elements of one group. Where every pointer of a group is
//   16-byte aligned a thread moves float4s, with a scalar tail; elsewhere
//   single floats. A group whose skip holds reads no gradient and writes
//   no moment (torch.where leaves them), and its parameters still take the
//   step from the old moments.
// - Group s takes its factor from scalars[s] and sqrt(bc2) from
//   scalars[count] (a row of GaussianOptimizer.step_scalars, on the
//   device, so a captured graph reads each step's row); beta1, 1 - beta1,
//   beta2, 1 - beta2 and eps are the configuration's, as float32.
// - Rounding as the plain version's PyTorch ops on the card: each product,
//   sum, quotient and square root rounded on its own (__fmul_rn, __fadd_rn,
//   __fdiv_rn, __fsqrt_rn: nothing contracted into an FMA) in its order:
//   m = b1*m + (1-b1)*g, v = b2*v + ((1-b2)*g)*g, then with pp_optimizer
//   p -= ((factor*m) / (sqrt(v) + eps)) * ppl, else p -= (factor*m) /
//   (sqrt(v)/sqrt(bc2) + eps). The result is the plain version's bits.
// - Block 0 adds one to skipped[s] for each group s whose skip held: the
//   counter ops/adam.py's callers read. No float atomics anywhere.
// The kernels allocate nothing and do not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;    // floats a float4
constexpr int ITEMS = 4;  // float4s a thread
constexpr long long CHUNK = THREADS * VEC * ITEMS;  // elements a block
constexpr int MAX_GROUPS = 8;

struct Group {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;      // elements
  long long first;  // the group's first block
  bool vec;         // all four pointers 16-byte aligned
};

struct Groups {
  Group at[MAX_GROUPS];
  int count;
  long long blocks;
};

struct Consts {
  float b1, omb1, b2, omb2, eps;
};

// Block b's group, found with constant indices only (a dynamic index into
// the parameter table would copy it to local memory).
__device__ __forceinline__ int group_of(const Groups& gs, long long b) {
  int s = 0;
#pragma unroll
  for (int k = 1; k < MAX_GROUPS; ++k)
    if (k < gs.count && gs.at[k].first <= b) s = k;
  return s;
}

__device__ __forceinline__ Group group_at(const Groups& gs, int s) {
  Group out = gs.at[0];
#pragma unroll
  for (int k = 1; k < MAX_GROUPS; ++k)
    if (k == s) out = gs.at[k];
  return out;
}

// torch.sum(g*g) > 0 fails for group s: no positive square, or a NaN one.
__device__ __forceinline__ bool skips(const int* flags, int s) {
  return !(flags[2 * s] && !flags[2 * s + 1]);
}

__device__ __forceinline__ void note(float g, int& pos, int& nan) {
  const float sq = __fmul_rn(g, g);
  pos |= sq > 0.0f;
  nan |= sq != sq;
}

__global__ void __launch_bounds__(THREADS)
    adam_flags_kernel(Groups gs, int* flags) {
  const long long b = blockIdx.x;
  int pos = 0, nan = 0;
  const int s = group_of(gs, b);
  if (b < gs.blocks) {
    const Group gr = group_at(gs, s);
    const long long base = (b - gr.first) * CHUNK;
    for (int it = 0; it < ITEMS; ++it) {
      const long long e = base + (it * THREADS + threadIdx.x) * VEC;
      if (gr.vec && e + VEC <= gr.n) {
        const float4 q = *reinterpret_cast<const float4*>(gr.g + e);
        note(q.x, pos, nan);
        note(q.y, pos, nan);
        note(q.z, pos, nan);
        note(q.w, pos, nan);
      } else {
        for (int k = 0; k < VEC && e + k < gr.n; ++k) note(gr.g[e + k], pos, nan);
      }
    }
  }
  pos = __syncthreads_or(pos);
  nan = __syncthreads_or(nan);
  if (threadIdx.x == 0 && b < gs.blocks) {
    if (pos) atomicOr(flags + 2 * s, 1);
    if (nan) atomicOr(flags + 2 * s + 1, 1);
  }
}

// One element's step, in the plain version's order of operations.
template <bool PP>
__device__ __forceinline__ void step_one(float& p, float g, float& m, float& v,
                                         bool skip, float factor,
                                         float sq_bc2, const float* lr,
                                         const Consts& c) {
  if (!skip) {
    m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
    v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, g), g));
  }
  const float num = __fmul_rn(factor, m);
  if (PP) {
    float upd = __fdiv_rn(num, __fadd_rn(__fsqrt_rn(v), c.eps));
    if (lr != nullptr) upd = __fmul_rn(upd, *lr);
    p = __fsub_rn(p, upd);
  } else {
    p = __fsub_rn(p, __fdiv_rn(num, __fadd_rn(__fdiv_rn(__fsqrt_rn(v), sq_bc2),
                                               c.eps)));
  }
}

template <bool PP>
__global__ void __launch_bounds__(THREADS)
    adam_update_kernel(Groups gs, const float* __restrict__ ppl,
                       const float* __restrict__ scalars, Consts c,
                       const int* __restrict__ flags, int* skipped) {
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  if (PP && b == 0 && t < gs.count && skips(flags, t)) skipped[t] += 1;
  if (b >= gs.blocks) return;
  const int s = group_of(gs, b);
  const Group gr = group_at(gs, s);
  const bool skip = PP && skips(flags, s);
  const float factor = scalars[s];
  const float sq_bc2 = scalars[gs.count];
  const float* lr = s == 0 ? ppl : nullptr;  // ppl scales xyz, [N, 3]
  const long long base = (b - gr.first) * CHUNK;
  for (int it = 0; it < ITEMS; ++it) {
    const long long e = base + (it * THREADS + threadIdx.x) * VEC;
    if (gr.vec && e + VEC <= gr.n) {
      float4 p = *reinterpret_cast<const float4*>(gr.p + e);
      float4 m = *reinterpret_cast<const float4*>(gr.m + e);
      float4 v = *reinterpret_cast<const float4*>(gr.v + e);
      float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (!skip) g = *reinterpret_cast<const float4*>(gr.g + e);
      step_one<PP>(p.x, g.x, m.x, v.x, skip, factor, sq_bc2,
                   lr ? lr + e / 3 : nullptr, c);
      step_one<PP>(p.y, g.y, m.y, v.y, skip, factor, sq_bc2,
                   lr ? lr + (e + 1) / 3 : nullptr, c);
      step_one<PP>(p.z, g.z, m.z, v.z, skip, factor, sq_bc2,
                   lr ? lr + (e + 2) / 3 : nullptr, c);
      step_one<PP>(p.w, g.w, m.w, v.w, skip, factor, sq_bc2,
                   lr ? lr + (e + 3) / 3 : nullptr, c);
      *reinterpret_cast<float4*>(gr.p + e) = p;
      if (!skip) {
        *reinterpret_cast<float4*>(gr.m + e) = m;
        *reinterpret_cast<float4*>(gr.v + e) = v;
      }
    } else {
      for (int k = 0; k < VEC && e + k < gr.n; ++k) {
        const long long i = e + k;
        float p = gr.p[i], m = gr.m[i], v = gr.v[i];
        step_one<PP>(p, skip ? 0.0f : gr.g[i], m, v, skip, factor, sq_bc2,
                     lr ? lr + i / 3 : nullptr, c);
        gr.p[i] = p;
        if (!skip) {
          gr.m[i] = m;
          gr.v[i] = v;
        }
      }
    }
  }
}

bool aligned(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

// The table of `count` groups: element counts n, and each group's
// parameter, gradient, first and second moment pointers.
bool make_groups(int count, const long long* n, void* const* p,
                 void* const* g, void* const* m, void* const* v, Groups* gs) {
  if (count < 1 || count > MAX_GROUPS) return false;
  long long blocks = 0;
  for (int s = 0; s < count; ++s) {
    gs->at[s] = Group{static_cast<float*>(p[s]),
                      static_cast<const float*>(g[s]),
                      static_cast<float*>(m[s]),
                      static_cast<float*>(v[s]),
                      n[s],
                      blocks,
                      aligned(p[s]) && aligned(g[s]) && aligned(m[s]) &&
                          aligned(v[s])};
    blocks += (n[s] + CHUNK - 1) / CHUNK;
  }
  gs->count = count;
  gs->blocks = blocks;
  return blocks < (1LL << 31);
}

int grid(const Groups& gs) {
  return static_cast<int>(gs.blocks > 0 ? gs.blocks : 1);
}

}  // namespace

// flags [2 * count] int32: zeroed, then for each group (some g*g > 0,
// some g*g NaN).
extern "C" int adam_flags(int count, const long long* n, void* const* p,
                          void* const* g, void* const* m, void* const* v,
                          int* flags, void* stream) {
  Groups gs;
  if (!make_groups(count, n, p, g, m, v, &gs)) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(flags, 0, 2 * count * sizeof(int), st);
  adam_flags_kernel<<<grid(gs), THREADS, 0, st>>>(gs, flags);
  return static_cast<int>(cudaGetLastError());
}

// One step in place on every group. ppl: null, or [n[0] / 3] per-point
// rates that scale group 0 (xyz, rows of 3); scalars [count + 1]; pp: the
// per-point formulation, with flags (adam_flags') and skipped [count]
// int32 (each group's count of skipped steps); without pp both are unread.
extern "C" int adam_update(int count, const long long* n, void* const* p,
                           void* const* g, void* const* m, void* const* v,
                           const float* ppl, const float* scalars, int pp,
                           float b1, float omb1, float b2, float omb2,
                           float eps, const int* flags, int* skipped,
                           void* stream) {
  Groups gs;
  if (!make_groups(count, n, p, g, m, v, &gs)) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Consts c{b1, omb1, b2, omb2, eps};
  if (pp)
    adam_update_kernel<true><<<grid(gs), THREADS, 0, st>>>(gs, ppl, scalars,
                                                            c, flags, skipped);
  else
    adam_update_kernel<false><<<grid(gs), THREADS, 0, st>>>(
        gs, nullptr, scalars, c, flags, skipped);
  return static_cast<int>(cudaGetLastError());
}
