// The train step's gated Adam update of every parameter group in one
// launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's update is optax's adam per
// group (tpusplat/train/step.py, make_optimizer), elementwise code that
// XLA fuses and writes into the jitted step's donated state. The port's
// plain version of it, tpusplat_torch/train/step.py::adam_update, runs about
// 14 full-size ATen kernels a group, apply_gradients gates each new tensor
// with torch.where, and the compiled step's body (compiled.py::_Entry.body)
// then copies the new parameters and moments into the donated buffers:
// some 188 B moved a parameter, 51% of a bicycle train step. This kernel
// serves every CUDA call of apply_gradients (train/adam.py, fused_adam);
// adam_update stays the route of the CPU, of the sharded steps
// (parallel/sharded.py), and the yardstick chip_smoke.py holds this kernel
// to.
//
// What it computes, per parameter group (means, log_scales, quats,
// opacities, sh; each a flat float32 array): optax's step in its order of
// operations,
//   m' = (1 - b1) g + b1 m,   v' = (1 - b2) (g g) + b2 v,
//   p' = p + (-lr) ((m' / (1 - b1^c)) / (sqrt(v' / (1 - b2^c)) + eps)),
// c the group's update count plus one and lr its learning rate at the
// count before the increment (constant, or optax.exponential_decay with its
// end value as a floor or a ceiling), gated: while any of the render's
// three overflow counters is nonzero, the state stays as it was.
//
// Bound: bytes. A parameter reads p, g, m and v and writes p, m and v once:
// 28 B, at bicycle's 354M parameters (6M Gaussians x 59) 9.9 GB, 2.96 ms at
// 3.35 TB/s; its 14 float operations a parameter would take 0.07 ms at
// 67 TFLOP/s.
//
// Design:
//  * One launch for all groups. The wrapper hands a table of (p, g, m, v,
//    the three outputs, the count, numel, the learning-rate schedule) by
//    value; the C entry gives each group a run of blocks, sized from its
//    numel, so every block works in one group. A thread moves kVecs float4s
//    of each array with 16-byte loads and stores (the wrapper checks that
//    every array is contiguous and 16-byte aligned); all its loads are
//    issued before any arithmetic. A group whose numel is not a multiple of
//    4 ends in one partial vector, read and written a float at a time.
//  * The gate and the scalars are read on the device: the first thread of a
//    block reads the three overflow counters and the group's count and
//    computes the bias corrections 1 - b1^c and 1 - b2^c and the learning
//    rate with powf, as PyTorch's pow kernel does, into shared memory. So
//    a CUDA graph replay sees each step's counters and count, and the ~50
//    scalar launches of the plain version are gone. The count is only read
//    here; the gated increment stays with the caller, after this launch,
//    so no block races another for it.
//  * In place or not: the outputs may be the inputs (a compiled step's body
//    writing its donated state, train/step.py::apply_gradients decides), or
//    fresh buffers (an eager step, whose old state stays intact, as a JAX
//    array does). A gated step writes nothing where an output is its input,
//    and copies the input where it is not, so the state it returns is the
//    old one bit for bit either way.
//  * Zeros: an IEEE division with a zero dividend, and a square root of
//    zero, leave the fast path for a slow one, and a dead slot (or a
//    Gaussian no view has seen yet) has zero gradients and moments. Such a
//    division is taken as the product that gives the same signed zero, the
//    root as the zero itself: with zeros on every other Gaussian the kernel
//    read 0.975 ms at garden and 4.115 at bicycle without this, 0.766 and
//    3.239 with it, bit-equal either way, and no slower on states without
//    zeros (H100, 700 W).
//  * Rounding: the plain version rounds after every elementwise op, so the
//    arithmetic here runs in its order with __fmul_rn / __fadd_rn /
//    __fdiv_rn / __fsqrt_rn, which nvcc never contracts into FMAs. The
//    Python float constants arrive as the floats PyTorch rounds them to
//    (1 - b1 is rounded after Python's double subtraction); a division of a
//    tensor by a Python number is a product with its float reciprocal
//    (PyTorch's div_true for a CPU scalar), as in the learning rate's
//    count / steps. So the kernel gives the plain update and its gate on the
//    card bit for bit (chip_smoke.py's adam phase holds it to them).

#include <cuda_runtime.h>

#include <cstdint>

// One parameter group, as train/adam.py's _Group lays it out. Outside the
// anonymous namespace: the C entry takes it, and its symbol must stay exported.
struct AdamGroup {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  const int* count;  // 0-d int32: the updates applied so far
  long long numel;
  float lr;       // the constant learning rate, or the decay's initial value
  float lr_end;   // the decay's end value
  float lr_rate;  // the decay rate
  int lr_steps;   // the decay's transition steps
  int lr_mode;    // kConstant, kDecayFloor or kDecayCeiling
};

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // float4s of each array a thread moves
constexpr long long kBlockVecs = static_cast<long long>(kThreads) * kVecs;
constexpr int kMaxGroups = 8;

// How a group's learning rate follows its count (train/adam.py's CONSTANT,
// DECAY_FLOOR, DECAY_CEILING).
constexpr int kConstant = 0;
constexpr int kDecayFloor = 1;    // exponential decay, clamp_min(end)
constexpr int kDecayCeiling = 2;  // exponential decay, clamp_max(end)

struct Table {
  AdamGroup group[kMaxGroups];
  long long first_block[kMaxGroups + 1];
  int n;
  const int* overflow[3];  // the render's 0-d int32 counters
  float c1m, b1, c1v, b2, eps;  // 1 - b1, b1, 1 - b2, b2, eps
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// torch.clamp_min / torch.clamp_max by a scalar, NaN propagating as
// PyTorch's CUDA kernels are.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// Optimizer.learning_rate at count c: init * rate^(c / steps) (init for
// c <= 0), clamped by the end value.
__device__ float learning_rate(const AdamGroup& G, int c) {
  if (G.lr_mode == kConstant) return G.lr;
  const float inv_steps = __fdiv_rn(1.0f, static_cast<float>(G.lr_steps));
  const float decayed = mul(G.lr, powf(G.lr_rate, mul(static_cast<float>(c), inv_steps)));
  const float value = c <= 0 ? G.lr : decayed;
  return G.lr_mode == kDecayFloor ? clamp_min(value, G.lr_end) : clamp_max(value, G.lr_end);
}

struct Scalars {
  float neg_lr, bc1, bc2;
};

// IEEE a / b. A zero a over a finite nonzero b gives the signed zero that
// a * b gives, without the division's slow path, which a zero dividend
// takes (a dead slot's moments are zero).
__device__ __forceinline__ float div(float a, float b) {
  return a == 0.0f && isfinite(b) && b != 0.0f ? mul(a, b) : __fdiv_rn(a, b);
}

// IEEE sqrt(a); sqrt(+-0) is +-0, without the slow path.
__device__ __forceinline__ float sqrt_rn(float a) { return a == 0.0f ? a : __fsqrt_rn(a); }

__device__ __forceinline__ void step(const Table& t, const Scalars& s, float p, float g,
                                     float m, float v, float& p2, float& m2, float& v2) {
  m2 = add(mul(t.c1m, g), mul(t.b1, m));
  v2 = add(mul(t.c1v, mul(g, g)), mul(t.b2, v));
  const float m_hat = div(m2, s.bc1);
  const float v_hat = div(v2, s.bc2);
  const float u = div(m_hat, add(sqrt_rn(v_hat), t.eps));
  p2 = add(p, mul(s.neg_lr, u));
}

__device__ __forceinline__ float4 step4(const Table& t, const Scalars& s, float4 p, float4 g,
                                        float4 m, float4 v, float4& m2, float4& v2) {
  float4 p2;
  step(t, s, p.x, g.x, m.x, v.x, p2.x, m2.x, v2.x);
  step(t, s, p.y, g.y, m.y, v.y, p2.y, m2.y, v2.y);
  step(t, s, p.z, g.z, m.z, v.z, p2.z, m2.z, v2.z);
  step(t, s, p.w, g.w, m.w, v.w, p2.w, m2.w, v2.w);
  return p2;
}

__global__ void __launch_bounds__(kThreads) adam_kernel(const __grid_constant__ Table t) {
  __shared__ Scalars s_scalars;
  __shared__ int s_ok;
  const long long block = blockIdx.x;
  int gi = 0;
  while (gi + 1 < t.n && block >= t.first_block[gi + 1]) ++gi;
  const AdamGroup& G = t.group[gi];
  if (threadIdx.x == 0) {
    // (capacity + gauss + tile) == 0 on int32 tensors, which wrap.
    const unsigned sum = static_cast<unsigned>(*t.overflow[0]) +
                         static_cast<unsigned>(*t.overflow[1]) +
                         static_cast<unsigned>(*t.overflow[2]);
    s_ok = sum == 0u;
    const int c = *G.count;
    const float cf = static_cast<float>(static_cast<int>(static_cast<unsigned>(c) + 1u));
    s_scalars.bc1 = __fsub_rn(1.0f, powf(t.b1, cf));
    s_scalars.bc2 = __fsub_rn(1.0f, powf(t.b2, cf));
    s_scalars.neg_lr = -learning_rate(G, c);
  }
  __syncthreads();
  const bool ok = s_ok;
  const bool in_place = G.p_out == G.p && G.m_out == G.m && G.v_out == G.v;
  if (!ok && in_place) return;  // a gated step leaves the donated state as it was
  const Scalars s = s_scalars;

  const long long nvec = G.numel / 4;  // whole float4s
  const long long base = (block - t.first_block[gi]) * kBlockVecs + threadIdx.x;
  const float4* p4 = reinterpret_cast<const float4*>(G.p);
  const float4* g4 = reinterpret_cast<const float4*>(G.g);
  const float4* m4 = reinterpret_cast<const float4*>(G.m);
  const float4* v4 = reinterpret_cast<const float4*>(G.v);
  float4 p[kVecs], g[kVecs], m[kVecs], v[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long i = base + j * kThreads;
    if (i < nvec) {
      p[j] = p4[i];
      m[j] = m4[i];
      v[j] = v4[i];
      if (ok) g[j] = __ldg(g4 + i);
    }
  }
  float4* po = reinterpret_cast<float4*>(G.p_out);
  float4* mo = reinterpret_cast<float4*>(G.m_out);
  float4* vo = reinterpret_cast<float4*>(G.v_out);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long i = base + j * kThreads;
    if (i < nvec) {
      if (ok) {
        float4 m2, v2;
        po[i] = step4(t, s, p[j], g[j], m[j], v[j], m2, v2);
        mo[i] = m2;
        vo[i] = v2;
      } else {
        po[i] = p[j];
        mo[i] = m[j];
        vo[i] = v[j];
      }
    } else if (i == nvec) {  // the partial vector at the end, a float at a time
      for (long long e = 4 * i; e < G.numel; ++e) {
        const float p1 = G.p[e], m1 = G.m[e], v1 = G.v[e];
        float p2 = p1, m2 = m1, v2 = v1;
        if (ok) step(t, s, p1, G.g[e], m1, v1, p2, m2, v2);
        G.p_out[e] = p2;
        G.m_out[e] = m2;
        G.v_out[e] = v2;
      }
    }
  }
}

}  // namespace

// tpusplat_torch/train/adam.py's launch. ``groups`` (host memory) holds
// ``n_groups`` groups; the three overflow counters and every array lie on
// the device of ``stream``. Returns the launch's cudaError_t (0 when there
// is nothing to update).
extern "C" int tpusplat_adam(const AdamGroup* groups, int n_groups, const int* capacity_overflow,
                             const int* gauss_overflow, const int* tile_overflow, float c1m,
                             float b1, float c1v, float b2, float eps, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups) return cudaErrorInvalidValue;
  Table t = {};
  t.n = n_groups;
  t.overflow[0] = capacity_overflow;
  t.overflow[1] = gauss_overflow;
  t.overflow[2] = tile_overflow;
  t.c1m = c1m;
  t.b1 = b1;
  t.c1v = c1v;
  t.b2 = b2;
  t.eps = eps;
  long long blocks = 0;
  for (int i = 0; i < n_groups; ++i) {
    t.group[i] = groups[i];
    t.first_block[i] = blocks;
    // every vector, the partial one included
    blocks += (groups[i].numel + 4 * kBlockVecs - 1) / (4 * kBlockVecs);
  }
  t.first_block[n_groups] = blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
