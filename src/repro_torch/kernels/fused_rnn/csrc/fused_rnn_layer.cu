// Whole-layer fused SRU/QRNN kernel for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of the JAX package:
//   * src/repro/kernels/fused_rnn/fused_rnn.py::fused_rnn_pallas   (one layer)
//   * src/repro/kernels/fused_rnn/stacked.py::fused_rnn_stack_pallas (L layers)
// The stack runs as this same kernel once per layer, with a pre-norm prologue
// and a residual epilogue (entry point `fused_rnn_stack_layer_launch`): layer
// l+1's RMSNorm contracts over the full width of layer l's output, so lanes
// cannot be split across CTAs inside one launch without a grid-wide barrier.
//
// What it computes per layer, for every (time, batch) row and hidden lane:
//   z      = u_row . w3 (+ u_prev_row . w3_prev for QRNN)   fp32 accumulate
//   x_hat  = z_x + b_x   (tanh for QRNN);  f = sigmoid(z_f + b_f);  r = sigmoid(z_r + b_r)
//   c      = f * c + (1 - f) * x_hat        (fp32 carry across all T)
//   h      = r * tanh(c) + (1 - r) * skip   (skip: input | u . w_skip | none)
// Stack mode: u = rmsnorm(x) * g computed in-kernel from the fp32 residual
// stream x, and the kernel writes x_out = x + h in fp32.
//
// Int8 gate slabs (the TPU kernels' s3 / sL operands). The weight type TW is
// a template parameter apart from the IO type TIO: (fp32, fp32), (bf16,
// bf16), (fp32, int8) and (bf16, int8). Each int8 value is widened exactly
// (to fp32 in the CUDA-core body, to bf16 in the tensor-core one). The fp32 scales (compact: one per gate and block of kScaleBlock lanes,
// (3, nb)) multiply each gate's sum AFTER the k-split partial sums are
// reduced, before the bias: z = (u . wq) * s + b. The skip projection of
// sru_proj (fourth column) comes from the fp w_skip and is not scaled.
//
// Two bodies. The bf16-IO instances (fp or int8 slabs) run the tensor-core
// kernel `fused_rnn_mma_kernel`; the fp32-IO instances run the CUDA-core
// kernel `fused_rnn_layer_kernel`, whose fp32 SIMT FMAs keep fp32 products.
//
// On the TPU the time-chunk grid axis ran in order with the carry in VMEM
// scratch. Here blocks run in no order, so a CTA owns a block of hidden lanes
// for all B rows and walks every time chunk in an in-block loop, with the
// carry in shared memory. The ragged lane edge is masked, not padded.
//
// Tensor-core body (bf16 IO). A lane block is NL = 32 / sizeof(slab) lanes
// (16 bf16, 32 int8), so one (k, gate) run of the slab is one full 32-byte
// sector. The contraction axis (d, or [d ; d] for QRNN's shifted input, each
// tap padded to 64 rows) is split across a thread block cluster of CTAs that
// share the lane block; the wrapper's plan sizes it from the SM count and
// the clusters the card holds at once (cluster 2 at H = 1024: 128 CTAs for
// bf16, 64 for int8, whose clusters of 4 the H100 cannot all hold). Each CTA
//   1. has one thread start tensor copies (TMA) of its whole slab slice, 64
//      rows x 3 gates x NL lanes each, in the stored type (96 KB for bf16
//      QRNN), completing on one mbarrier; the slice stays resident for every
//      time chunk. The carry, biases, scales and gain load meanwhile;
//   2. per chunk of `bt` time steps (bt * B <= 128 rows), copies the raw
//      input tiles of its K range (bf16 u, or the stack's fp32 x) by
//      cp.async through a ring of two or three stages, and runs the gate
//      GEMM on mma.sync.m16n8k16 (bf16 in, fp32 accumulate): A fragments by
//      ldmatrix, or in stack mode x * rstd * g computed as they load and
//      split into u_hi + u_lo; B fragments by ldmatrix.trans from the
//      swizzled slice, an int8 slab widened to bf16, exactly, as they load;
//      warps split rows, and K where rows are few;
//   3. stores its partial gate sums into the shared memory of the CTA whose
//      epilogue owns their lanes (distributed shared memory); after a
//      cluster barrier each CTA sums the partials of its NL / cluster lanes
//      and runs their nonlinearities, the fp32 recurrence and the highway
//      output (stack mode: x_out = x + h), as the CUDA-core body does.
// The stack's pre-norm sums each row's squares whole at decode and splits
// the width across the cluster over a prompt. Gate activations never reach
// device memory.
//
// Bound. Decode (T = 1) streams the (K, 3, H) slab once: bytes-bound (6 MiB
// bf16 at H = 1024, ~1.9 us at 3.35 TB/s; 3 MiB int8, ~0.95 us). Every byte
// of a CTA's slice is requested at its start, in full sectors. Prefill at
// T * B = 256 rows is a 1.6 GFLOP GEMM, under the bytes bound on bf16
// tensor cores; the slice is read once per launch, not once per time chunk.
// Measurements in PERF.md.
//
// CUDA-core body (fp32 IO): kLanes = 8 lanes per CTA, the slab streamed
// through shared-memory tiles per chunk, fp32 SIMT FMAs; at decode the K
// axis is split over the warps and reduced in shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (see repro_torch/kernels/build.py). Each entry point returns
// cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;      // hidden lanes per CTA
constexpr int kMaxRows = 128;  // (time, batch) rows per chunk
constexpr int kRowsPerThread = 4;  // consecutive (time, batch) rows per GEMM thread
constexpr int kMaxGates = 4;   // x_hat, f, r (+ skip projection)
constexpr int kWStride = kLanes * kMaxGates + 4;  // weight tile floats per k: [lane][gate] + pad
constexpr int kInFlight = 4;   // 8-element loads each thread issues before using any
constexpr int kScaleBlock = 128;  // lanes per int8 scale (layout.py's SCALE_BLOCK)
static_assert(kLanes == 8, "the weight loader reads one 8-lane run per (k, gate)");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid_f(float z) { return 1.0f / (1.0f + expf(-z)); }

// Eight consecutive elements as raw bits: 16 bytes of bf16 (lo) or 32 of fp32.
struct Raw8 {
  uint4 lo, hi;
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// Load elements p[0..n) (n <= 8; the rest are zero). A full, aligned run is
// one (bf16) or two (fp32) 16-byte loads. Nothing converts here, so a thread
// can keep several loads in flight and convert when it stores.
__device__ __forceinline__ Raw8 load8(const float* p, int n) {
  Raw8 r;
  if (n == 8 && aligned16(p)) {
    r.lo = __ldg(reinterpret_cast<const uint4*>(p));
    r.hi = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  } else {
    unsigned v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < n ? __float_as_uint(p[i]) : 0u;
    r.lo = make_uint4(v[0], v[1], v[2], v[3]);
    r.hi = make_uint4(v[4], v[5], v[6], v[7]);
  }
  return r;
}

__device__ __forceinline__ Raw8 load8(const __nv_bfloat16* p, int n) {
  Raw8 r;
  r.hi = make_uint4(0u, 0u, 0u, 0u);
  if (n == 8 && aligned16(p)) {
    r.lo = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    unsigned v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < n ? static_cast<unsigned>(__bfloat16_as_ushort(p[i])) : 0u;
    r.lo = make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16), v[4] | (v[5] << 16),
                      v[6] | (v[7] << 16));
  }
  return r;
}

// Eight consecutive int8 weights, 8 bytes in r.lo.x (elements 0-3) and
// r.lo.y (4-7): one 8-byte load when the run is full and aligned.
__device__ __forceinline__ Raw8 load8(const int8_t* p, int n) {
  Raw8 r;
  r.lo = make_uint4(0u, 0u, 0u, 0u);
  r.hi = r.lo;
  if (n == 8 && (reinterpret_cast<unsigned long long>(p) & 7ull) == 0) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.lo.x = v.x;
    r.lo.y = v.y;
  } else {
    unsigned v[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) v[i / 4] |= static_cast<unsigned>(static_cast<uint8_t>(p[i])) << (8 * (i % 4));
    r.lo.x = v[0];
    r.lo.y = v[1];
  }
  return r;
}

// Widen eight int8 values (load8 above) to fp32: exact.
__device__ __forceinline__ void unpack8_i8(const Raw8& r, float* o) {
  const unsigned w[2] = {r.lo.x, r.lo.y};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = static_cast<float>(static_cast<int>(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
}

__device__ __forceinline__ void unpack8(const Raw8& r, bool f32, float* o) {
  const unsigned w[8] = {r.lo.x, r.lo.y, r.lo.z, r.lo.w, r.hi.x, r.hi.y, r.hi.z, r.hi.w};
  if (f32) {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __uint_as_float(w[i]);
  } else {  // bf16 pairs: element 2i in the low half of word i
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

struct Args {
  const void* u;        // (T, B, d): io dtype; fp32 residual stream in stack mode
  const void* w3;       // (d, 3, H) slab against u_t: io dtype or int8
  const void* w3_prev;  // (d, 3, H) slab against u_{t-1} (QRNN) or null
  const float* wscale;  // (3, nb) fp32 scales of an int8 slab, shared by both taps
  const void* b3;       // (3, H)
  const void* c0;       // (B, H)
  const void* tail0;    // (B, d) u_{-1} for QRNN (stack: already normed)
  const void* skip;     // (T, B, H) highway input (skip_mode 1, layer mode): u itself
                        // when d == H, a shard's own lane slice of u otherwise
  const void* wskip;    // (d, H) highway projection (skip_mode 2)
  const void* ln_g;     // (d,) pre-norm gain (stack mode)
  void* h_out;          // (T, B, H) io dtype (layer mode)
  float* x_out;         // (T, B, H) fp32 residual stream out (stack mode)
  void* c_last;         // (B, H) io dtype
  void* tail_last;      // (B, d) io dtype: normed u[T-1] (stack QRNN) or null
  int T, B, d, H;
  int bt;               // time steps per chunk
  int K;                // contraction: d, or 2d with w3_prev
  int ng;               // gate columns per lane: 3, or 4 with the skip projection
  int rg, ks, bk;       // GEMM thread split: row groups x k-splits (rg * ks = 32), k tile
  int xhat_tanh, skip_mode, prenorm;
  int nb;               // scale blocks, ceil((scale_lane0 + H) / kScaleBlock) (int8 slabs)
  int scale_lane0;      // lane 0's place in wscale's block numbering (a shard's offset
                        // into its first block; 0 for a whole layer)
  float eps;
  // Tensor-core body only (from the wrapper's plan; see Geo below).
  int cluster;          // CTAs per cluster, splitting K: 1, 2, 4 or 8
  int k_tile;           // input-tile columns per step (multiple of 16)
  int taps;             // 1, or 2 with w3_prev (QRNN)
  int vec_w, vec_skip;  // slab / w_skip runs may be copied 16 bytes at a time
};

template <typename TIO>
__device__ __forceinline__ float load_row(const Args& a, const float* rs, int t0, int t, int b,
                                          int k) {
  // Element k of the layer input at time t (>= 0), batch b.
  const size_t off = (static_cast<size_t>(t) * a.B + b) * a.d + k;
  if (a.prenorm) {
    const float x = static_cast<const float*>(a.u)[off];
    const float g = to_f(static_cast<const TIO*>(a.ln_g)[k]);
    return x * rs[(t - t0 + 1) * a.B + b] * g;
  }
  return to_f(static_cast<const TIO*>(a.u)[off]);
}

// Element k of tile row `row` (time t0 + row / B, batch row % B) of the
// contraction input: u_t for k < d, u_{t-1} (the tail at t = 0) above.
template <typename TIO>
__device__ __forceinline__ float u_value(const Args& a, const float* rs, int t0, int M, int row,
                                         int k) {
  if (row >= M || k >= a.K) return 0.0f;
  const int t = t0 + row / a.B, b = row % a.B;
  if (k < a.d) return load_row<TIO>(a, rs, t0, t, b, k);
  if (t == 0) return to_f(static_cast<const TIO*>(a.tail0)[b * a.d + (k - a.d)]);
  return load_row<TIO>(a, rs, t0, t - 1, b, k - a.d);
}

// Eight consecutive k (k % 8 == 0) of one tile row, as raw loads; the store
// applies `scale` (the row's rstd) and the gain g[gk..] when `gain` is set.
struct Seg {
  Raw8 raw;
  float scale;
  int gk;
  bool f32, gain;
};

template <typename TIO>
__device__ __forceinline__ Seg u_segment(const Args& a, const float* rs, int t0, int M, int row,
                                         int k) {
  constexpr bool kF32 = std::is_same<TIO, float>::value;
  Seg s;
  s.scale = 1.0f;
  s.gk = 0;
  s.f32 = kF32;
  s.gain = false;
  if (row >= M || k >= a.K) {
    s.raw = load8(static_cast<const TIO*>(nullptr), 0);
    return s;
  }
  if (a.d % 8 != 0) {  // a run may cross the u_t / u_{t-1} boundary: per element
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = u_value<TIO>(a, rs, t0, M, row, k + i);
    s.raw.lo = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                          __float_as_uint(v[3]));
    s.raw.hi = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]), __float_as_uint(v[6]),
                          __float_as_uint(v[7]));
    s.f32 = true;
    return s;
  }
  const int t = t0 + row / a.B, b = row % a.B;
  const bool shifted = k >= a.d;
  const int kk = shifted ? k - a.d : k;
  const int ts = shifted ? t - 1 : t;
  if (ts < 0) {  // QRNN u_{-1}: the carried tail (already normed in stack mode)
    s.raw = load8(static_cast<const TIO*>(a.tail0) + b * a.d + kk, 8);
    return s;
  }
  const size_t off = (static_cast<size_t>(ts) * a.B + b) * a.d + kk;
  if (a.prenorm) {
    s.raw = load8(static_cast<const float*>(a.u) + off, 8);
    s.f32 = true;
    s.scale = rs[(ts - t0 + 1) * a.B + b];
    s.gain = true;
    s.gk = kk;
  } else {
    s.raw = load8(static_cast<const TIO*>(a.u) + off, 8);
  }
  return s;
}

// NG: gate columns per lane, 3 (x_hat, f, r) or 4 (+ the skip projection).
// TW: the gate slabs' type, TIO or int8_t (then a.wscale holds the scales), or
// bf16 under float IO.
template <typename TIO, typename TW, int NG>
__global__ void __launch_bounds__(kThreads) fused_rnn_layer_kernel(Args a) {
  constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kLanes;
  const int B = a.B, d = a.d, H = a.H, K = a.K, bk = a.bk;
  constexpr int NC = NG * kLanes;
  const int max_rows = a.bt * B;
  const int rows_p = a.rg * kRowsPerThread;  // >= max_rows: whole row groups
  const int rowsp = rows_p + 4;              // +4: stagger banks, keep 16-byte rows

  // Tiles are k-major so that each thread reads its 4 rows, and its lane's
  // gates, as one 16-byte load per k.
  float* u_s = smem;                         // bk x rowsp: input tile
  float* w_s = u_s + bk * rowsp;             // bk x kWStride: [k][lane][gate]
  float* red = w_s + bk * kWStride;          // ks x rows_p x NC partial sums
  float* fa = red + a.ks * rows_p * NC;      // max_rows x kLanes: f
  float* fb = fa + max_rows * kLanes;        // (1 - f) * x_hat
  float* rr = fb + max_rows * kLanes;        // r
  float* sk = rr + max_rows * kLanes;        // skip term
  float* cc = sk + max_rows * kLanes;        // carry after each row
  float* rs = cc + max_rows * kLanes;        // (bt + 1) x B rstd (stack mode)
  float* carry = rs + (a.bt + 1) * B;        // B x kLanes
  float* g_s = carry + B * kLanes;           // d: pre-norm gain (stack mode)

  const TW* w3 = static_cast<const TW*>(a.w3);
  const TW* w3p = static_cast<const TW*>(a.w3_prev);
  const TIO* b3 = static_cast<const TIO*>(a.b3);
  const size_t H3 = static_cast<size_t>(3) * H;

  for (int p = tid; p < B * kLanes; p += kThreads) {
    const int lane = j0 + p % kLanes;
    carry[p] = lane < H ? to_f(static_cast<const TIO*>(a.c0)[(p / kLanes) * H + lane]) : 0.0f;
  }
  if (a.prenorm) {
    for (int k = tid; k < d; k += kThreads) g_s[k] = to_f(static_cast<const TIO*>(a.ln_g)[k]);
  }

  // GEMM thread coordinates: lane jj, k-split s, row group rgi.
  const int jj = tid % kLanes;
  const int rest = tid / kLanes;  // 0..31 == rg * ks
  const int s = rest % a.ks;
  const int rgi = rest / a.ks;
  const int warp = tid / 32, wl = tid % 32;

  for (int t0 = 0; t0 < a.T; t0 += a.bt) {
    const int bt_c = min(a.bt, a.T - t0);
    const int M = bt_c * B;

    if (a.prenorm) {
      // rstd of every row this chunk reads: times t0-1 .. t0+bt_c-1
      // (t0-1 only feeds the QRNN shifted input; at t0 == 0 the tail is used).
      for (int q = warp; q < (bt_c + 1) * B; q += kThreads / 32) {
        const int t = t0 - 1 + q / B, b = q % B;
        if (t < 0) continue;
        const float* xr = static_cast<const float*>(a.u) + (static_cast<size_t>(t) * B + b) * d;
        float acc = 0.0f;
        if (d % 4 == 0 && aligned16(xr)) {
          for (int k = wl; k < d / 4; k += 32) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(xr) + k);
            acc += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
          }
        } else {
          for (int k = wl; k < d; k += 32) acc += xr[k] * xr[k];
        }
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (wl == 0) rs[q] = rsqrtf(acc / static_cast<float>(d) + a.eps);
      }
      __syncthreads();
    }

    float acc[kRowsPerThread][NG];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int g = 0; g < NG; ++g) acc[i][g] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += bk) {
      // Input tile (bk x rows_p) and weight tile (bk x lanes x gates), 8
      // elements per load, kInFlight loads per thread outstanding before the
      // first store. Consecutive threads take consecutive rows, so the
      // k-major stores do not collide in shared-memory banks.
      const int n_useg = (bk / 8) * rows_p;
      for (int s0 = tid; s0 < n_useg; s0 += kThreads * kInFlight) {
        Seg sg[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int seg = s0 + q * kThreads;
          const int row = seg < n_useg ? seg % rows_p : rows_p;  // rows >= M load zeros
          sg[q] = u_segment<TIO>(a, rs, t0, M, row, k0 + (seg / rows_p) * 8);
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int seg = s0 + q * kThreads;
          if (seg >= n_useg) break;
          float v[8];
          unpack8(sg[q].raw, sg[q].f32, v);
          float* dst = u_s + (seg / rows_p) * 8 * rowsp + seg % rows_p;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            dst[i * rowsp] = sg[q].gain ? v[i] * sg[q].scale * g_s[sg[q].gk + i] : v[i];
        }
      }
      const int nl = min(kLanes, H - j0);  // lanes of this CTA inside H
      for (int s0 = tid; s0 < bk * NG; s0 += kThreads * kInFlight) {
        Raw8 rw[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int seg = s0 + q * kThreads, kk = seg / NG, g = seg % NG, k = k0 + kk;
          const bool live = seg < bk * NG && k < K;
          if (g == 3) {  // the fp skip projection, in the IO dtype
            const TIO* src = nullptr;
            if (live) src = static_cast<const TIO*>(a.wskip) + static_cast<size_t>(k) * H + j0;
            rw[q] = load8(src, live ? nl : 0);
          } else {
            const TW* src = nullptr;
            if (live) src = k < d ? w3 + k * H3 + g * H + j0 : w3p + (k - d) * H3 + g * H + j0;
            rw[q] = load8(src, live ? nl : 0);
          }
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int seg = s0 + q * kThreads;
          if (seg >= bk * NG) break;
          float v[8];
          if (kInt8 && seg % NG != 3) {
            unpack8_i8(rw[q], v);
          } else {  // the skip projection in the IO dtype, the gate slabs in theirs
            unpack8(rw[q], seg % NG == 3 ? std::is_same<TIO, float>::value
                                         : std::is_same<TW, float>::value, v);
          }
          float* dst = w_s + (seg / NG) * kWStride + seg % NG;
#pragma unroll
          for (int i = 0; i < 8; ++i) dst[i * kMaxGates] = v[i];
        }
      }
      __syncthreads();
      for (int kk = s; kk < bk; kk += a.ks) {
        const float4 w4 = *reinterpret_cast<const float4*>(w_s + kk * kWStride + jj * kMaxGates);
        const float4 u4 = *reinterpret_cast<const float4*>(u_s + kk * rowsp + rgi * kRowsPerThread);
        const float wv[kMaxGates] = {w4.x, w4.y, w4.z, w4.w};  // wv[3] unused when NG == 3
        const float uv[kRowsPerThread] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int g = 0; g < NG; ++g) acc[i][g] += uv[i] * wv[g];
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = rgi * kRowsPerThread + i;
#pragma unroll
      for (int g = 0; g < NG; ++g) red[(s * rows_p + row) * NC + g * kLanes + jj] = acc[i][g];
    }
    __syncthreads();

    // Gate nonlinearities, one (row, lane) per thread.
    for (int p = tid; p < M * kLanes; p += kThreads) {
      const int row = p / kLanes, q = p % kLanes, lane = j0 + q;
      if (lane >= H) continue;
      float z[kMaxGates] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int sp = 0; sp < a.ks; ++sp) {
#pragma unroll
        for (int g = 0; g < NG; ++g) z[g] += red[(sp * rows_p + row) * NC + g * kLanes + q];
      }
      if (kInt8) {  // dequantize the whole sum, then the bias
        const float* sc = a.wscale + (a.scale_lane0 + lane) / kScaleBlock;
#pragma unroll
        for (int g = 0; g < 3; ++g) z[g] *= __ldg(sc + g * a.nb);
      }
      const float zx = z[0] + to_f(b3[lane]);
      const float f = sigmoid_f(z[1] + to_f(b3[H + lane]));
      const float r = sigmoid_f(z[2] + to_f(b3[2 * H + lane]));
      const float xh = a.xhat_tanh ? tanhf(zx) : zx;
      const int t = t0 + row / B, b = row % B;
      float skip = 0.0f;
      if (a.skip_mode == 1) {
        skip = a.prenorm ? load_row<TIO>(a, rs, t0, t, b, lane)
                         : to_f(static_cast<const TIO*>(a.skip)[(static_cast<size_t>(t) * B + b) * H + lane]);
      } else if (NG == 4) {  // skip_mode 2: the in-kernel projection
        skip = z[3];
      }
      fa[p] = f;
      fb[p] = (1.0f - f) * xh;
      rr[p] = r;
      sk[p] = skip;
      if (a.tail_last != nullptr && t == a.T - 1 && lane < d) {
        static_cast<TIO*>(a.tail_last)[b * d + lane] = from_f<TIO>(load_row<TIO>(a, rs, t0, t, b, lane));
      }
    }
    __syncthreads();

    // The recurrence: sequential in time, one thread per (batch, lane).
    for (int p = tid; p < B * kLanes; p += kThreads) {
      const int b = p / kLanes, q = p % kLanes;
      float c = carry[p];
      for (int tt = 0; tt < bt_c; ++tt) {
        const int e = (tt * B + b) * kLanes + q;
        c = fa[e] * c + fb[e];
        cc[e] = c;
      }
      carry[p] = c;
    }
    __syncthreads();

    // Highway output (and the residual add in stack mode).
    for (int p = tid; p < M * kLanes; p += kThreads) {
      const int row = p / kLanes, lane = j0 + p % kLanes;
      if (lane >= H) continue;
      float h = rr[p] * tanhf(cc[p]);
      if (a.skip_mode != 0) h = h + (1.0f - rr[p]) * sk[p];
      const size_t off = (static_cast<size_t>(t0) * B + row) * H + lane;
      if (a.prenorm) {
        a.x_out[off] = static_cast<const float*>(a.u)[off] + h;
      } else {
        static_cast<TIO*>(a.h_out)[off] = from_f<TIO>(h);
      }
    }
    __syncthreads();
  }

  for (int p = tid; p < B * kLanes; p += kThreads) {
    const int lane = j0 + p % kLanes;
    if (lane < H) static_cast<TIO*>(a.c_last)[(p / kLanes) * H + lane] = from_f<TIO>(carry[p]);
  }
}

// Host-side tiling choice: shared by both entry points.
void plan(Args& a) {
  a.bt = a.bt < 1 ? 1 : a.bt;
  if (a.bt > a.T) a.bt = a.T;
  if (a.bt * a.B > kMaxRows) a.bt = kMaxRows / a.B;
  const int max_rows = a.bt * a.B;
  const int need = (max_rows + kRowsPerThread - 1) / kRowsPerThread;
  int rg = 1;
  while (rg < need && rg < 32) rg *= 2;
  a.rg = rg;
  a.ks = 32 / rg;
  // k tile: the two tiles within 96 KB; decode (4 rows) takes 512 k per tile.
  int bk = (24576 / (rg * kRowsPerThread + 4 + kWStride)) / 32 * 32;
  if (bk > 512) bk = 512;
  if (bk < 32) bk = 32;
  const int k_round = (a.K + 31) / 32 * 32;
  if (bk > k_round) bk = k_round;
  a.bk = bk;
}

size_t smem_bytes(const Args& a) {
  const int max_rows = a.bt * a.B, rows_p = a.rg * kRowsPerThread, NC = a.ng * kLanes;
  const size_t floats = static_cast<size_t>(a.bk) * (rows_p + 4) + static_cast<size_t>(a.bk) * kWStride +
                        static_cast<size_t>(a.ks) * rows_p * NC + 5 * max_rows * kLanes +
                        (a.bt + 1) * a.B + a.B * kLanes + a.d;
  return floats * sizeof(float);
}

// With info, the instance is described (fused_rnn_info's fields) instead of
// launched.
template <typename TIO, typename TW, int NG>
int launch(Args a, cudaStream_t stream, int* info) {
  plan(a);
  const size_t bytes = smem_bytes(a);
  auto kern = fused_rnn_layer_kernel<TIO, TW, NG>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.H + kLanes - 1) / kLanes);
  if (info != nullptr) {
    cudaFuncAttributes fattr{};
    err = cudaFuncGetAttributes(&fattr, kern);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[0] = static_cast<int>(bytes);
    info[2] = fattr.numRegs;
    info[3] = kLanes;
    info[4] = 1;
    info[5] = static_cast<int>(grid.x);
    info[6] = 0;
    info[7] = a.bt * a.B;
    info[8] = a.bk;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], kern, kThreads, bytes));
  }
  fused_rnn_layer_kernel<TIO, TW, NG><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIO, typename TW>
int launch_ng(const Args& a, cudaStream_t s, int* info) {
  return a.ng == 4 ? launch<TIO, TW, 4>(a, s, info) : launch<TIO, TW, 3>(a, s, info);
}

// ---------------------------------------------------------------------------
// Tensor-core body: the bf16-IO instances (fp or int8 slabs).
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kMaxSeg = 4;       // 8-column input segments a thread stages per tile
constexpr int kRowPad = 16;      // bytes after each input-tile row: ldmatrix rows on distinct banks
constexpr int kRun = 32;         // bytes of one (k, gate) slab run of a CTA's lanes
constexpr int kGateRow = 3 * kRun;  // shared bytes per k of the three gate runs
constexpr int kBoxK = 64;        // contraction rows per tensor copy; each tap is padded to it
constexpr int kSmemMax = 232448;    // dynamic shared memory a CTA may have
constexpr int kAlign = 1024;     // the swizzled slab's alignment (slack added once)
constexpr int kMaxCluster = 8;

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 15) / 16 * 16;
  return at;
}

// Sizes and shared-memory offsets of one launch, the same on host and device
// (offsets from the CTA's kAlign-aligned base). The wrapper's `plan`
// (fused_rnn.py) mirrors them to pick cluster and k_tile.
struct Geo {
  int bt, rows, mp, wm, wk;  // chunk steps, rows, rows padded to 16, warps over rows x over K
  int dpad, kp, kc;          // a tap's d padded to kBoxK, padded K, K per CTA (kBoxK multiple)
  int ne, nstage, ustride;   // epilogue lanes per CTA, input-tile stages, tile row bytes
  size_t slab, skip, u, stage, part, recv, epi, ssr, rs, eb, carry, gain, bar, total;  // bytes
};

__host__ __device__ inline void place(Geo& g, const Args& a, int nl, int ng, bool stack) {
  const size_t nq = static_cast<size_t>(g.bt + 1) * a.B;
  const size_t f4 = sizeof(float);
  size_t off = 0;
  g.slab = take(off, static_cast<size_t>(g.kc) * kGateRow);
  g.skip = take(off, ng == 4 ? static_cast<size_t>(g.kc) * nl * 2 : 0);
  g.stage = static_cast<size_t>(g.mp) * g.ustride;
  g.u = take(off, g.nstage * g.stage);
  g.part = take(off, g.wk > 1 ? static_cast<size_t>(g.wk) * g.mp * ng * nl * f4 : 0);
  g.recv = take(off, static_cast<size_t>(g.mp) * ng * nl * f4);
  g.epi = take(off, 5 * static_cast<size_t>(g.rows) * g.ne * f4);
  g.ssr = take(off, stack ? a.cluster * nq * f4 : 0);
  g.rs = take(off, stack ? nq * f4 : 0);
  g.eb = take(off, 6 * static_cast<size_t>(g.ne) * f4);
  g.carry = take(off, static_cast<size_t>(a.B) * g.ne * f4);
  g.gain = take(off, stack ? static_cast<size_t>(g.dpad) * f4 : 0);
  g.bar = take(off, sizeof(uint64_t));
  g.total = off + kAlign;
}

// Three input-tile stages where there is room, else two; one when the
// CTA's K range is one tile.
__host__ __device__ inline Geo geometry(const Args& a, int nl, int ng, bool stack) {
  Geo g{};
  int bt = a.bt < 1 ? 1 : a.bt;
  if (bt > a.T) bt = a.T;
  if (bt * a.B > kMaxRows) bt = kMaxRows / a.B;
  g.bt = bt;
  g.rows = bt * a.B;
  const int mtiles = (g.rows + 15) / 16;
  g.mp = 16 * mtiles;
  g.wm = 1;
  while (g.wm < mtiles) g.wm *= 2;
  g.wk = kThreads / 32 / g.wm;
  g.dpad = round_up(a.d, kBoxK);
  g.kp = a.taps * g.dpad;
  g.kc = round_up((g.kp + a.cluster - 1) / a.cluster, kBoxK);
  g.ne = nl / a.cluster;
  g.ustride = a.k_tile * (stack ? 4 : 2) + (stack ? 32 : 16);
  g.nstage = a.k_tile >= g.kc ? 1 : 3;
  place(g, a, nl, ng, stack);
  if (g.nstage == 3 && g.total > static_cast<size_t>(kSmemMax)) {
    g.nstage = 2;
    place(g, a, nl, ng, stack);
  }
  return g;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The one-shot barrier on which the slab's tensor copies complete.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(1));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}

// Tensor copies of a box at coordinates (c0, c1[, c2]) of `map` into shared memory.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// The cluster barrier in two halves: arrive (release) after this thread's
// shared-memory writes (its own or the other CTAs') or reads of its own,
// wait (acquire) before it depends on the other CTAs'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Where the tensor copy (swizzle 32B) puts 16-byte piece c of slab row r
// (r = k * 3 + gate, 32 bytes a row): ldmatrix then reads 8 consecutive k
// of one gate from 8 distinct bank groups.
__device__ __forceinline__ int swz_gate(int r, int c) { return r * kRun + ((c ^ ((r >> 2) & 1)) << 4); }

// The same for row k of the bf16 skip column (sru_proj): NL * 2 bytes a
// row, swizzle 32B (16 lanes) or 64B (32 lanes).
template <int NL>
__device__ __forceinline__ int swz_skip(int k, int c) {
  if (NL == 16) return k * 32 + ((c ^ ((k >> 2) & 1)) << 4);
  return k * 64 + ((c ^ ((k >> 1) & 3)) << 4);
}

// Four int8 weights (bytes b0..b3 of w) widened to bf16, exactly (|q| <= 127):
// even = (b0, b2), odd = (b1, b3), low half first. 2^23 + (q + 128) is an
// fp32 whose low byte is q + 128; subtracting 2^23 + 128 leaves q.
__device__ __forceinline__ void widen_i8x4(uint32_t w, uint32_t& even, uint32_t& odd) {
  const uint32_t x = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | i)) - 8388736.0f;
  }
  const __nv_bfloat162 e = __floats2bfloat162_rn(f[0], f[2]);
  const __nv_bfloat162 o = __floats2bfloat162_rn(f[1], f[3]);
  even = *reinterpret_cast<const uint32_t*>(&e);
  odd = *reinterpret_cast<const uint32_t*>(&o);
}

// (v0, v1) -> hi and lo bf16 pairs with hi + lo = v to about 16 bits.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Row k (0 <= k < kp) of the padded contraction [w3 ; w3_prev]: tap k / dpad
// at row k % dpad, or null in a tap's padding.
template <typename TW>
__device__ __forceinline__ const TW* tap_row(const Args& a, int k, int dpad) {
  const int half = k >= dpad ? 1 : 0, kin = k - half * dpad;
  if (kin >= a.d) return nullptr;
  const TW* w = static_cast<const TW*>(half == 0 ? a.w3 : a.w3_prev);
  return w + static_cast<size_t>(kin) * 3 * a.H;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy input tile [k0, k0 + k_tile) (inside one tap) of the chunk's M rows,
// as stored (bf16 u, or the stack's fp32 x), into a stage buffer: row `row`
// at row * ustride. 16-byte cp.async pieces where the source allows; the
// QRNN tail (u_{-1}) of the stack, unaligned rows and d % 8 != 0 by element
// copies; zeros in the padding. Source row r = t0 * B + row - half * B
// (time * B + batch) needs no division; r < 0 is the tail.
template <bool kStack>
__device__ __forceinline__ void issue_tile(const Args& a, const Geo& g, int t0, int M, int k0,
                                           int lpr, bool vec_u, bool vec_tail, unsigned char* dst) {
  using TIn = typename std::conditional<kStack, float, bf16>::type;
  constexpr int kEs = sizeof(TIn);
  const int per_row = a.k_tile >> 3;
  const int half = k0 >= g.dpad ? 1 : 0, kin0 = k0 - half * g.dpad;
  const TIn* u = static_cast<const TIn*>(a.u);
  const bf16* tail = static_cast<const bf16*>(a.tail0);
#pragma unroll
  for (int i = 0; i < kMaxSeg; ++i) {
    const int s = threadIdx.x + i * kThreads;
    if (s >= M * per_row) break;
    const int row = s >> lpr, kin = kin0 + (s & (per_row - 1)) * 8;
    const int r = t0 * a.B + row - half * a.B;
    unsigned char* o = dst + row * g.ustride + (kin - kin0) * kEs;
    if (kin >= a.d) {  // padding
      cp_async16(o, a.u, 0);
      if (kStack) cp_async16(o + 16, a.u, 0);
      continue;
    }
    if (r >= 0 && vec_u) {
      const TIn* src = u + static_cast<size_t>(r) * a.d + kin;
      cp_async16(o, src, 16);
      if (kStack) cp_async16(o + 16, src + 4, 16);
      continue;
    }
    if (r < 0 && !kStack && vec_tail) {
      cp_async16(o, tail + static_cast<size_t>(r + a.B) * a.d + kin, 16);
      continue;
    }
    const int n = a.d - kin < 8 ? a.d - kin : 8;
    const Raw8 raw = r < 0 ? load8(tail + static_cast<size_t>(r + a.B) * a.d + kin, n)
                           : load8(u + static_cast<size_t>(r) * a.d + kin, n);
    if (kStack) {  // the stack's tile is fp32: its bf16 tail rows are widened
      float v[8];
      unpack8(raw, r >= 0, v);
      reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      *reinterpret_cast<uint4*>(o) = raw.lo;
    }
  }
}

// Column (gate * NL + lane) of the partial sums that column c of n-tile nt
// holds. bf16: n-tile nt is gate nt / 2, lanes (nt % 2) * 8 + c. int8 gates:
// ldmatrix.trans hands each thread two neighbouring lanes per k pair, so
// n-tile nt holds gate nt / 4, lanes (nt % 4 / 2) * 16 + 2c + nt % 2. The
// bf16 skip column (sru_proj) follows the gates in natural order.
template <bool kInt8>
__device__ __forceinline__ int part_col(int nt, int c) {
  if (kInt8 && nt < 12) return (nt >> 1) * 16 + 2 * c + (nt & 1);
  return nt * 8 + c;
}

// One input tile's gate GEMM for this warp: rows mg * 16.., k-steps kg,
// kg + wk, ... of the tile, every n-tile of the CTA's lanes. wk0: the
// tile's first row in the CTA's slab slice. bf16 input feeds the A
// fragments by ldmatrix; the stack's fp32 x is normed as its fragments load
// (x * rstd * g, or the tail as it is) and split into hi and lo bf16 terms.
// rs0 / rs1: the row scales of this thread's rows (0 for a tail row), gk:
// the gain at the tile's first column.
template <typename TW, int NG, bool kStack, int NT>
__device__ __forceinline__ void mma_tile(const Geo& g, const unsigned char* ubuf,
                                         const unsigned char* ws, const unsigned char* sks,
                                         int wk0, int mg, int kg, int cols, const float* gk,
                                         float rs0, float rs1, float (&acc)[NT][4]) {
  constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  constexpr int NL = 32 / static_cast<int>(sizeof(TW));
  const int ln = threadIdx.x & 31, r16 = ln & 15, hsel = ln >> 4;
  const unsigned char* arow = ubuf + (mg * 16 + r16) * g.ustride + hsel * 16;
  const int q2 = (ln & 3) * 2;
  const float* x0 = reinterpret_cast<const float*>(ubuf + (mg * 16 + (ln >> 2)) * g.ustride) + q2;
  const float* x1 = x0 + 8 * g.ustride / 4;
  for (int ks = kg; ks < cols / 16; ks += g.wk) {
    uint32_t af[kStack ? 2 : 1][4];
    if constexpr (kStack) {
      const int c = ks * 16;
      float2 v[4] = {*reinterpret_cast<const float2*>(x0 + c), *reinterpret_cast<const float2*>(x1 + c),
                     *reinterpret_cast<const float2*>(x0 + c + 8), *reinterpret_cast<const float2*>(x1 + c + 8)};
      const float2 ga = *reinterpret_cast<const float2*>(gk + c + q2);
      const float2 gb = *reinterpret_cast<const float2*>(gk + c + q2 + 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = e & 1 ? rs1 : rs0;
        const float2 gg = e < 2 ? ga : gb;
        if (s != 0.0f) v[e] = make_float2(v[e].x * s * gg.x, v[e].y * s * gg.y);
        split2(v[e].x, v[e].y, af[0][e], af[kStack ? 1 : 0][e]);
      }
    } else {
      ldsm_x4(af[0], arow + ks * 32);
    }
    const int kk = wk0 + ks * 16 + r16;  // this lane's slab row for ldmatrix
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
      uint32_t bq[4];
      ldsm_x4_t(bq, ws + swz_gate(kk * 3 + gate, hsel));
      if constexpr (kInt8) {
        uint32_t e[4], o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) widen_i8x4(bq[i], e[i], o[i]);
#pragma unroll
        for (int p = 0; p < (kStack ? 2 : 1); ++p) {
          mma16816(acc[4 * gate], af[p], e[0], e[1]);
          mma16816(acc[4 * gate + 1], af[p], o[0], o[1]);
          mma16816(acc[4 * gate + 2], af[p], e[2], e[3]);
          mma16816(acc[4 * gate + 3], af[p], o[2], o[3]);
        }
      } else {
#pragma unroll
        for (int p = 0; p < (kStack ? 2 : 1); ++p) {
          mma16816(acc[2 * gate], af[p], bq[0], bq[1]);
          mma16816(acc[2 * gate + 1], af[p], bq[2], bq[3]);
        }
      }
    }
    if constexpr (NG == 4) {  // the bf16 skip projection (layer mode only)
#pragma unroll
      for (int h = 0; h < NL / 16; ++h) {
        uint32_t bq[4];
        ldsm_x4_t(bq, sks + swz_skip<NL>(kk, 2 * h + hsel));
        mma16816(acc[3 * NL / 8 + 2 * h], af[0], bq[0], bq[1]);
        mma16816(acc[3 * NL / 8 + 2 * h + 1], af[0], bq[2], bq[3]);
      }
    }
  }
}

// Where lane q (of a CTA's ne epilogue lanes) of gate `gate` sits in the
// owner's recv rows: int8 fragments hold lanes 2c + parity, so the owner
// keeps each parity together and a thread's two neighbouring fragment
// columns land side by side (one 8-byte store).
template <bool kInt8>
__device__ __forceinline__ int recv_slot(int gate, int q, int ne) {
  return kInt8 && gate < 3 ? (q & 1) * (ne >> 1) + (q >> 1) : q;
}

// NG: gate columns per lane, 3, or 4 with sru_proj's skip projection (layer
// mode). kStack: pre-norm of the fp32 residual stream and x_out = x + h.
// tm0 / tm1 / tmk: tensor maps of the taps and of w_skip, read when a.vec_w.
template <typename TW, int NG, bool kStack>
__global__ void __launch_bounds__(kThreads, 1)
    fused_rnn_mma_kernel(Args a, const __grid_constant__ CUtensorMap tm0,
                         const __grid_constant__ CUtensorMap tm1,
                         const __grid_constant__ CUtensorMap tmk) {
  constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  constexpr int NL = 32 / static_cast<int>(sizeof(TW));
  constexpr int NC = NG * NL;
  constexpr int NT = NC / 8;
  constexpr int kPer = 16 / static_cast<int>(sizeof(TW));  // slab elements per 16 bytes
  using Bits = typename std::conditional<kInt8, uint8_t, unsigned short>::type;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  unsigned char* base = smem_mma + ((kAlign - (smem_u32(smem_mma) & (kAlign - 1))) & (kAlign - 1));
  const Geo g = geometry(a, NL, NG, kStack);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j0 = static_cast<int>(blockIdx.x) / a.cluster * NL;
  const int e0 = rank * g.ne;  // this CTA's epilogue lanes: j0 + e0 .. + ne
  const int lne = __ffs(g.ne) - 1;  // ne is a power of two
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const int B = a.B, d = a.d, H = a.H;
  const int k_lo = rank * g.kc;
  const int k_n = max(0, min(g.kp - k_lo, g.kc));  // this CTA's K rows (a multiple of kBoxK)
  unsigned char* ws = base + g.slab;
  unsigned char* sks = base + g.skip;
  unsigned char* us = base + g.u;
  float* part = reinterpret_cast<float*>(base + g.part);
  float* recv = reinterpret_cast<float*>(base + g.recv);
  float* fa = reinterpret_cast<float*>(base + g.epi);
  float* fb = fa + g.rows * g.ne;
  float* rr = fb + g.rows * g.ne;
  float* sk = rr + g.rows * g.ne;
  float* xl = sk + g.rows * g.ne;  // the chunk's input at the epilogue lanes (skip, residual)
  float* ssr = reinterpret_cast<float*>(base + g.ssr);
  float* rs = reinterpret_cast<float*>(base + g.rs);
  float* eb = reinterpret_cast<float*>(base + g.eb);  // biases, then int8 scales, per lane
  float* carry = reinterpret_cast<float*>(base + g.carry);
  float* gain = reinterpret_cast<float*>(base + g.gain);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + g.bar);

  // 1. The CTA's slab slice, resident from here on. One thread asks the
  //    tensor memory accelerator for it, kBoxK rows x 3 gates x NL lanes a
  //    copy, all at once (zeros past H and in each tap's padding); the other
  //    threads go on. Operands a tensor copy cannot take (not 16-byte
  //    aligned) are copied element by element into the same layout.
  if (a.vec_w) {
    if (tid == 0) {
      mbar_init(bar);
      const int nbox = k_n / kBoxK;
      mbar_expect_tx(bar, nbox * kBoxK * (kGateRow + (NG == 4 ? NL * 2 : 0)));
      for (int b = 0; b < nbox; ++b) {
        const int k = k_lo + b * kBoxK, half = k >= g.dpad ? 1 : 0, row = k - half * g.dpad;
        tma_load_3d(ws + b * kBoxK * kGateRow, half ? &tm1 : &tm0, j0, 0, row, bar);
        if (NG == 4) tma_load_2d(sks + b * kBoxK * NL * 2, &tmk, j0, row, bar);
      }
    }
  } else {
    for (int c = tid; c < k_n * 6; c += kThreads) {
      const int kk = c / 6, gate = (c >> 1) % 3, h = c & 1;
      Bits* o = reinterpret_cast<Bits*>(ws + swz_gate(kk * 3 + gate, h));
      const TW* row = tap_row<TW>(a, k_lo + kk, g.dpad);
      const Bits* src = row == nullptr ? nullptr
                                       : reinterpret_cast<const Bits*>(row + static_cast<size_t>(gate) * H + j0 + h * kPer);
      for (int i = 0; i < kPer; ++i) o[i] = src != nullptr && j0 + h * kPer + i < H ? src[i] : Bits(0);
    }
    if constexpr (NG == 4) {
      constexpr int kCh = NL / 8;  // 16-byte pieces per k
      for (int c = tid; c < k_n * kCh; c += kThreads) {
        const int kk = c / kCh, h = c % kCh, k = k_lo + kk;  // sru_proj has one tap
        unsigned short* o = reinterpret_cast<unsigned short*>(sks + swz_skip<NL>(kk, h));
        const unsigned short* src =
            reinterpret_cast<const unsigned short*>(static_cast<const bf16*>(a.wskip) + static_cast<size_t>(k) * H + j0 + h * 8);
        for (int i = 0; i < 8; ++i) {
          o[i] = k < d && j0 + h * 8 + i < H ? src[i] : static_cast<unsigned short>(0);
        }
      }
    }
  }

  // 2. While it streams in: the carry, biases and int8 scales of the
  //    epilogue lanes, the norm's gain (zeros in the padding).
  for (int p = tid; p < B * g.ne; p += kThreads) {
    const int lane = j0 + e0 + (p & (g.ne - 1));
    carry[p] = lane < H ? to_f(static_cast<const bf16*>(a.c0)[(p >> lne) * H + lane]) : 0.0f;
  }
  for (int p = tid; p < 6 * g.ne; p += kThreads) {
    const int gate = p >> lne, lane = j0 + e0 + (p & (g.ne - 1));
    float v = 0.0f;
    if (lane < H && gate < 3) v = to_f(static_cast<const bf16*>(a.b3)[gate * H + lane]);
    if (lane < H && gate >= 3 && kInt8) {
      v = __ldg(a.wscale + (gate - 3) * a.nb + (a.scale_lane0 + lane) / kScaleBlock);
    }
    eb[p] = v;
  }
  if (kStack) {
    for (int k = tid; k < g.dpad; k += kThreads) {
      gain[k] = k < d ? to_f(static_cast<const bf16*>(a.ln_g)[k]) : 0.0f;
    }
  }
  __syncthreads();  // the barrier is initialized before any thread waits on it

  const int mg = warp % g.wm, kg = warp / g.wm;
  const int ntiles = k_n / a.k_tile;  // the plan's k_tile divides the CTA's K range
  const int lpr = __ffs(a.k_tile >> 3) - 1;  // k_tile / 8 is a power of two
  const int ahead = min(max(g.nstage - 1, 1), ntiles);  // tiles in flight before the first
  const bool vec_u = d % 8 == 0 && aligned16(a.u);
  const bool vec_tail = d % 8 == 0 && aligned16(a.tail0);
  const int first_q = a.taps == 2 ? 0 : B;  // rows at t0 - 1 feed only QRNN's shifted input
  for (int t0 = 0; t0 < a.T; t0 += g.bt) {
    const int bt_c = min(g.bt, a.T - t0), M = bt_c * B, mtiles = (M + 15) / 16;
    if (t0 > 0) {
      cluster_wait();  // the cluster is done with our recv and ssr of the last chunk
      __syncthreads();  // and this CTA with the last chunk's epilogue buffers
    }

    // 3. The first input tiles in flight; then, while they land, the input
    //    at the epilogue lanes (the skip, the residual) and in stack mode the
    //    rstd of the rows at t0 - 1 .. t0 + bt_c - 1 (q = (t - t0 + 1) * B + b,
    //    source row (t0 - 1) * B + q).
    for (int p = 0; p < ahead; ++p) {
      issue_tile<kStack>(a, g, t0, M, k_lo + p * a.k_tile, lpr, vec_u, vec_tail,
                         us + (p % g.nstage) * g.stage);
      cp_async_commit();
    }
    if (kStack || a.skip_mode == 1) {
      for (int p = tid; p < M * g.ne; p += kThreads) {
        const int lane = j0 + e0 + (p & (g.ne - 1));
        const size_t off = static_cast<size_t>(t0 * B + (p >> lne)) * H + lane;  // stack: d == H
        xl[p] = lane >= H ? 0.0f
                          : kStack ? static_cast<const float*>(a.u)[off]
                                   : to_f(static_cast<const bf16*>(a.skip)[off]);
      }
    }
    if constexpr (kStack) {
      // Few rows (decode): each CTA sums every row whole. Many: each sums its
      // share of the width and hands it to every CTA of the cluster. Four
      // rows a warp, all their loads issued first.
      const int nq = (bt_c + 1) * B;
      const bool whole = nq - first_q <= 16;
      const int share = round_up((d + a.cluster - 1) / a.cluster, 4);
      const int c_lo = whole ? 0 : min(d, rank * share), c_hi = whole ? d : min(d, c_lo + share);
      const bool vec = d % 4 == 0 && aligned16(a.u);
      const float* x = static_cast<const float*>(a.u);
      for (int q0 = first_q + warp; q0 < nq; q0 += 32) {
        float acc4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int c0 = c_lo; c0 < c_hi; c0 += 512) {
          if (vec) {
            float4 v[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int q = q0 + 8 * i, r = (t0 - 1) * B + q;
              const float* xr = x + static_cast<size_t>(r < 0 ? 0 : r) * d;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int c = c0 + 4 * ln + 128 * j;
                v[i][j] = q < nq && r >= 0 && c < c_hi ? __ldg(reinterpret_cast<const float4*>(xr + c))
                                                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc4[i] += v[i][j].x * v[i][j].x + v[i][j].y * v[i][j].y + v[i][j].z * v[i][j].z +
                           v[i][j].w * v[i][j].w;
          } else {
            for (int i = 0; i < 4; ++i) {
              const int q = q0 + 8 * i, r = (t0 - 1) * B + q;
              if (q >= nq || r < 0) continue;
              const float* xr = x + static_cast<size_t>(r) * d;
              for (int c = c0 + ln; c < c0 + 512 && c < c_hi; c += 32) acc4[i] += xr[c] * xr[c];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = acc4[i];
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          const int q = q0 + 8 * i;
          if (ln == 0 && q < nq) {
            if (whole) {
              rs[q] = rsqrtf(v / static_cast<float>(d) + a.eps);
            } else {
              for (int r = 0; r < a.cluster; ++r) cluster.map_shared_rank(ssr, r)[rank * nq + q] = v;
            }
          }
        }
      }
      if (!whole) {
        cluster_arrive();
        cluster_wait();
        for (int q = first_q + tid; q < nq; q += kThreads) {
          float tot = 0.0f;
          for (int r = 0; r < a.cluster; ++r) tot += ssr[r * nq + q];
          rs[q] = rsqrtf(tot / static_cast<float>(d) + a.eps);
        }
      }
    }

    // 4. The gate GEMM over this CTA's K range: tile kt + ahead in flight
    //    (cp.async) while the tensor cores run on tile kt.
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    if (t0 == 0 && a.vec_w) mbar_wait(bar, 0);
    const int row0 = mg * 16 + (ln >> 2);
    for (int kt = 0; kt < ntiles; ++kt) {
      if (min(kt + ahead, ntiles) - (kt + 1) > 0) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (kt + ahead < ntiles) {
        issue_tile<kStack>(a, g, t0, M, k_lo + (kt + ahead) * a.k_tile, lpr, vec_u, vec_tail,
                           us + ((kt + ahead) % g.nstage) * g.stage);
        cp_async_commit();
      }
      if (mg < mtiles) {
        const int k0 = k_lo + kt * a.k_tile, half = k0 >= g.dpad ? 1 : 0;
        float rs0 = 0.0f, rs1 = 0.0f;  // the row scales; 0 leaves a tail row as it is
        if (kStack) {
          const int lead = t0 * B - half * B;
          if (row0 < M && lead + row0 >= 0) rs0 = rs[row0 + (1 - half) * B];
          if (row0 + 8 < M && lead + row0 + 8 >= 0) rs1 = rs[row0 + 8 + (1 - half) * B];
        }
        mma_tile<TW, NG, kStack, NT>(g, us + (kt % g.nstage) * g.stage, ws, sks, kt * a.k_tile,
                                     mg, kg, a.k_tile, gain + (k0 - half * g.dpad), rs0, rs1,
                                     acc);
      }
    }

    // 5. Partial sums straight to the CTA whose epilogue owns their lanes
    //    (recv[source rank][row][gate][slot], into its shared memory; a
    //    store of this CTA's own lanes stays local), summed first over the
    //    warps that split K.
    auto recv_at = [&](int row, int col) {
      const int gate = col / NL, ll = col - gate * NL, owner = ll >> lne;
      float* r = owner == rank ? recv : cluster.map_shared_rank(recv, owner);
      return r + ((rank * g.mp + row) * NG + gate) * g.ne + recv_slot<kInt8>(gate, ll & (g.ne - 1), g.ne);
    };
    if (g.wk == 1) {
      if (mg < mtiles) {
        const int c2 = (ln & 3) * 2;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = part_col<kInt8>(nt, c2);
          if (row0 < M) *reinterpret_cast<float2*>(recv_at(row0, col)) = make_float2(acc[nt][0], acc[nt][1]);
          if (row0 + 8 < M) {
            *reinterpret_cast<float2*>(recv_at(row0 + 8, col)) = make_float2(acc[nt][2], acc[nt][3]);
          }
        }
      }
    } else {
      if (mg < mtiles) {
        const int c2 = (ln & 3) * 2;
        float* pr = part + (kg * g.mp + row0) * NC;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c0 = part_col<kInt8>(nt, c2), c1 = part_col<kInt8>(nt, c2 + 1);
          pr[c0] = acc[nt][0];
          pr[c1] = acc[nt][1];
          pr[8 * NC + c0] = acc[nt][2];
          pr[8 * NC + c1] = acc[nt][3];
        }
      }
      __syncthreads();
      for (int p = tid; p < M * NC; p += kThreads) {
        float s = part[p];
        for (int w = 1; w < g.wk; ++w) s += part[w * g.mp * NC + p];
        *recv_at(p / NC, p % NC) = s;
      }
    }
    cluster_arrive();
    cluster_wait();

    // 6. Gate nonlinearities of this CTA's epilogue lanes, one (row, lane) per
    //    thread, from the partial sums the cluster handed it.
    for (int p = tid; p < M * g.ne; p += kThreads) {
      const int row = p >> lne, q = p & (g.ne - 1), lane = j0 + e0 + q;
      if (lane >= H) continue;
      float z[NG];
#pragma unroll
      for (int gg = 0; gg < NG; ++gg) {
        z[gg] = 0.0f;
        for (int r = 0; r < a.cluster; ++r) {
          z[gg] += recv[((r * g.mp + row) * NG + gg) * g.ne + recv_slot<kInt8>(gg, q, g.ne)];
        }
      }
      if (kInt8) {  // dequantize the whole sum, then the bias
#pragma unroll
        for (int gg = 0; gg < 3; ++gg) z[gg] *= eb[(3 + gg) * g.ne + q];
      }
      const float zx = z[0] + eb[q];
      const float f = sigmoid_f(z[1] + eb[g.ne + q]);
      const float r = sigmoid_f(z[2] + eb[2 * g.ne + q]);
      const float xh = a.xhat_tanh ? tanhf(zx) : zx;
      const float normed = kStack ? xl[p] * rs[row + B] * gain[lane] : xl[p];
      float skip = 0.0f;
      if (a.skip_mode == 1) {
        skip = normed;
      } else if (NG == 4) {
        skip = z[NG - 1];
      }
      fa[p] = f;
      fb[p] = (1.0f - f) * xh;
      rr[p] = r;
      sk[p] = skip;
      if (kStack && a.tail_last != nullptr && t0 * B + row >= (a.T - 1) * B) {
        static_cast<bf16*>(a.tail_last)[(t0 * B + row - (a.T - 1) * B) * d + lane] =
            __float2bfloat16(normed);
      }
    }
    cluster_arrive();  // this CTA is done with its recv and ssr of this chunk
    __syncthreads();

    // 7. The recurrence, one thread per (batch, lane); then the highway output.
    for (int p = tid; p < B * g.ne; p += kThreads) {
      const int b = p >> lne, q = p & (g.ne - 1);
      float c = carry[p];
      for (int tt = 0; tt < bt_c; ++tt) {
        const int e = (tt * B + b) * g.ne + q;
        c = fa[e] * c + fb[e];
        fa[e] = c;
      }
      carry[p] = c;
    }
    __syncthreads();
    for (int p = tid; p < M * g.ne; p += kThreads) {
      const int row = p >> lne, lane = j0 + e0 + (p & (g.ne - 1));
      if (lane >= H) continue;
      float h = rr[p] * tanhf(fa[p]);
      if (a.skip_mode != 0) h = h + (1.0f - rr[p]) * sk[p];
      const size_t off = static_cast<size_t>(t0 * B + row) * H + lane;
      if (kStack) {
        a.x_out[off] = xl[p] + h;
      } else {
        static_cast<bf16*>(a.h_out)[off] = __float2bfloat16(h);
      }
    }
  }

  for (int p = tid; p < B * g.ne; p += kThreads) {
    const int lane = j0 + e0 + (p & (g.ne - 1));
    if (lane < H) static_cast<bf16*>(a.c_last)[(p >> lne) * H + lane] = __float2bfloat16(carry[p]);
  }
  cluster_wait();  // no CTA leaves while the cluster may still write its shared memory
}

// cuTensorMapEncodeTiled, looked up through the runtime, so the library links
// no more than the other sources do.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// The tensor map of a (d, 3, H) tap, boxes of NL lanes x 3 gates x kBoxK
// rows, swizzle 32B; or of the (d, H) w_skip, boxes of NL lanes x kBoxK rows.
template <typename TW>
int tap_map(CUtensorMap* m, const void* w, int d, int H) {
  constexpr int NL = 32 / static_cast<int>(sizeof(TW));
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H), 3, static_cast<cuuint64_t>(d)};
  const cuuint64_t strides[2] = {H * sizeof(TW), 3 * H * sizeof(TW)};
  const cuuint32_t box[3] = {NL, 3, kBoxK}, one[3] = {1, 1, 1};
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return -5;
  const CUresult r = encode(
      m, std::is_same<TW, int8_t>::value ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(w), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -5;
}

template <int NL>
int skip_map(CUtensorMap* m, const void* w, int d, int H) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(d)};
  const cuuint64_t strides[1] = {H * sizeof(bf16)};
  const cuuint32_t box[2] = {NL, kBoxK}, one[2] = {1, 1};
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return -5;
  const CUresult r = encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
                            strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            NL == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -5;
}

// Launch (or, with info, describe) one tensor-core instance. The wrapper's
// plan gives a.cluster and a.k_tile; -3 refuses a plan this shape cannot take.
template <typename TW, int NG, bool kStack>
int launch_mma(Args a, cudaStream_t stream, int* info) {
  constexpr int NL = 32 / static_cast<int>(sizeof(TW));
  if (a.cluster != 1 && a.cluster != 2 && a.cluster != 4 && a.cluster != 8) return -3;
  const Geo g = geometry(a, NL, NG, kStack);
  if (a.k_tile < 16 || (a.k_tile & (a.k_tile - 1)) != 0 || g.kc % a.k_tile != 0 ||
      g.dpad % a.k_tile != 0 || g.rows * (a.k_tile / 8) > kThreads * kMaxSeg ||
      g.total > static_cast<size_t>(kSmemMax)) {
    return -3;
  }
  auto kern = fused_rnn_mma_kernel<TW, NG, kStack>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.H + NL - 1) / NL;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * a.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = g.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (info != nullptr) {
    cudaFuncAttributes fattr{};
    err = cudaFuncGetAttributes(&fattr, kern);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[0] = static_cast<int>(g.total);
    info[2] = fattr.numRegs;
    info[3] = NL;
    info[4] = a.cluster;
    info[5] = blocks * a.cluster;
    info[7] = g.rows;
    info[8] = a.k_tile;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], kern, kThreads, g.total);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(&info[6], kern, &cfg));
  }
  // Tensor copies need 16-byte aligned operands and row strides.
  a.vec_w = aligned16(a.w3) && (a.w3_prev == nullptr || aligned16(a.w3_prev)) &&
            (static_cast<size_t>(a.H) * sizeof(TW)) % 16 == 0 &&
            (NG != 4 || (aligned16(a.wskip) && a.H % 8 == 0));
  CUtensorMap tm[3] = {};
  if (a.vec_w) {
    int rc = tap_map<TW>(&tm[0], a.w3, a.d, a.H);
    if (rc == 0 && a.w3_prev != nullptr) rc = tap_map<TW>(&tm[1], a.w3_prev, a.d, a.H);
    if (rc == 0 && NG == 4) rc = skip_map<NL>(&tm[2], a.wskip, a.d, a.H);
    if (rc != 0) return rc;
  }
  err = cudaLaunchKernelEx(&cfg, kern, a, tm[0], tm[1], tm[2]);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TW>
int launch_bf16(const Args& a, cudaStream_t s, int* info) {
  if (a.prenorm) return launch_mma<TW, 3, true>(a, s, info);
  return a.ng == 4 ? launch_mma<TW, 4, false>(a, s, info) : launch_mma<TW, 3, false>(a, s, info);
}

// dtype: 0 = float32, 1 = bfloat16 (activations, biases, carries, w_skip);
// wdtype: the gate slabs', the same code, 2 = int8 with fp32 scales, or 1
// (bf16 slabs) under float32 IO, widened exactly as they load.
// float32 runs the CUDA-core body, bfloat16 the tensor-core one. The source
// is built twice (kernels/build.py), so that the two nvcc runs go in
// parallel: plain for the fp weight instances, with -DFUSED_RNN_INT8 for the
// int8 ones. Each library refuses the other's pairs with -2. With info, the
// instance is described instead of launched (fused_rnn_info).
int dispatch(int dtype, int wdtype, Args a, void* stream, int* info) {
  if (a.B < 1 || a.B > kMaxRows || a.T < 1 || a.H < 1 || a.d < 1) return -1;
  auto s = static_cast<cudaStream_t>(stream);
#ifdef FUSED_RNN_INT8
  if (wdtype == 2) {
    if (a.wscale == nullptr && info == nullptr) return -1;
    a.nb = (a.scale_lane0 + a.H + kScaleBlock - 1) / kScaleBlock;
    if (dtype == 0) return launch_ng<float, int8_t>(a, s, info);
    if (dtype == 1) return launch_bf16<int8_t>(a, s, info);
  }
#else
  if (dtype == 0 && wdtype == 0) return launch_ng<float, float>(a, s, info);
  if (dtype == 0 && wdtype == 1) return launch_ng<float, bf16>(a, s, info);
  if (dtype == 1 && wdtype == 1) return launch_bf16<bf16>(a, s, info);
#endif
  return -2;
}

Args layer_args(const void* u, const void* w3, const void* w3_prev, const float* wscale,
                const void* b3, const void* c0, const void* tail0, const void* skip,
                const void* wskip, void* h_out, void* c_last, int T, int B, int d, int H,
                int block_t, int xhat_tanh, int skip_mode, int cluster, int k_tile,
                int scale_lane0) {
  Args a{};
  a.u = u; a.w3 = w3; a.w3_prev = w3_prev; a.wscale = wscale; a.b3 = b3; a.c0 = c0;
  a.tail0 = tail0;
  a.skip = skip; a.wskip = wskip; a.h_out = h_out; a.c_last = c_last;
  a.T = T; a.B = B; a.d = d; a.H = H; a.bt = block_t;
  a.taps = w3_prev != nullptr ? 2 : 1;
  a.K = a.taps * d;
  a.ng = skip_mode == 2 ? 4 : 3;
  a.xhat_tanh = xhat_tanh; a.skip_mode = skip_mode; a.prenorm = 0; a.eps = 0.0f;
  a.cluster = cluster; a.k_tile = k_tile;
  a.scale_lane0 = scale_lane0;
  return a;
}

Args stack_args(const float* x, const void* w3, const void* w3_prev, const float* wscale,
                const void* b3, const void* ln_g, const void* c0, const void* tail0,
                float* x_out, void* c_last, void* tail_last, int T, int B, int H, int block_t,
                float eps, int cluster, int k_tile) {
  Args a{};
  a.u = x; a.w3 = w3; a.w3_prev = w3_prev; a.wscale = wscale; a.b3 = b3; a.ln_g = ln_g;
  a.c0 = c0; a.tail0 = tail0; a.x_out = x_out; a.c_last = c_last; a.tail_last = tail_last;
  a.T = T; a.B = B; a.d = H; a.H = H; a.bt = block_t;
  a.taps = w3_prev != nullptr ? 2 : 1;
  a.K = a.taps * H;
  a.ng = 3;
  a.xhat_tanh = a.taps == 2 ? 1 : 0; a.skip_mode = a.taps == 2 ? 0 : 1; a.prenorm = 1;
  a.eps = eps;
  a.cluster = cluster; a.k_tile = k_tile;
  return a;
}

}  // namespace

extern "C" {

// One SRU/QRNN layer (fused_rnn_pallas). dtype: 0 = float32, 1 = bfloat16
// for every tensor but the gate slabs; wdtype: the slabs' (dtype, 2 = int8
// with the (3, nb) fp32 wscale, kScaleBlock lanes per scale, or 1 = bfloat16
// under float32 IO).
// skip_mode: 0 none (QRNN), 1 input (skip: (T, B, H), u itself when d == H),
// 2 projection.
// scale_lane0: lane 0's place in wscale's block numbering, where the layer is
// a shard of a wider one whose lanes start inside a scale block (< kScaleBlock;
// wscale then holds the shard's blocks, ceil((scale_lane0 + H) / kScaleBlock)
// of them a gate).
// w3_prev / tail0 non-null selects the QRNN shifted-input contraction.
// cluster / k_tile: the wrapper's plan for the bf16 instances (read by them
// only; -3 when this shape cannot take it).
// An unknown (dtype, wdtype) pair returns -2 and launches nothing.
int fused_rnn_layer_launch(int dtype, int wdtype, const void* u, const void* w3,
                           const void* w3_prev, const float* wscale, const void* b3,
                           const void* c0, const void* tail0, const void* skip,
                           const void* wskip, void* h_out, void* c_last, int T, int B, int d,
                           int H, int block_t, int xhat_tanh, int skip_mode, int cluster,
                           int k_tile, int scale_lane0, void* stream) {
  if (scale_lane0 < 0 || scale_lane0 >= kScaleBlock) return -1;
  const Args a = layer_args(u, w3, w3_prev, wscale, b3, c0, tail0, skip, wskip, h_out, c_last,
                            T, B, d, H, block_t, xhat_tanh, skip_mode, cluster, k_tile,
                            scale_lane0);
  return dispatch(dtype, wdtype, a, stream, nullptr);
}

// One layer of the depth-fused stack (fused_rnn_stack_pallas): pre-norm of
// the fp32 residual stream x (d == H), gates, recurrence, highway with the
// normed input as skip (SRU) or none (QRNN), x_out = x + h in fp32.
// QRNN (w3_prev non-null) reads the normed tail and writes the normed u[T-1].
// dtype / wdtype / wscale / cluster / k_tile as for fused_rnn_layer_launch.
int fused_rnn_stack_layer_launch(int dtype, int wdtype, const float* x, const void* w3,
                                 const void* w3_prev, const float* wscale, const void* b3,
                                 const void* ln_g, const void* c0, const void* tail0,
                                 float* x_out, void* c_last, void* tail_last, int T, int B,
                                 int H, int block_t, float eps, int cluster, int k_tile,
                                 void* stream) {
  const Args a = stack_args(x, w3, w3_prev, wscale, b3, ln_g, c0, tail0, x_out, c_last,
                            tail_last, T, B, H, block_t, eps, cluster, k_tile);
  return dispatch(dtype, wdtype, a, stream, nullptr);
}

// The instance that a call of this shape and plan runs, the tensor-core
// body's (dtype 1) or the CUDA-core body's (dtype 0; cluster and k_tile
// unread): info[0] dynamic shared memory per CTA (bytes), [1] resident CTAs
// per SM, [2] registers per thread, [3] lanes per CTA, [4] CTAs per cluster,
// [5] grid (CTAs), [6] clusters the card can hold at once (0 for the
// CUDA-core body, which runs no cluster), [7] rows per chunk, [8] input-tile
// columns. stack: the stack layer (d == H, ng 3); taps: 2 for QRNN; ng: 4
// with sru_proj's skip projection.
int fused_rnn_info(int dtype, int wdtype, int ng, int stack, int taps, int T, int B, int d,
                   int H, int block_t, int cluster, int k_tile, int* info) {
  if (info == nullptr || (stack && (d != H || ng != 3)) || taps < 1 || taps > 2) return -1;
  const void* tap2 = taps == 2 ? info : nullptr;  // any non-null pointer selects QRNN
  const Args a = stack ? stack_args(nullptr, nullptr, tap2, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, nullptr, T, B, H, block_t, 0.0f,
                                    cluster, k_tile)
                       : layer_args(nullptr, nullptr, tap2, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, nullptr, T, B, d, H, block_t,
                                    taps == 2, ng == 4 ? 2 : (taps == 2 ? 0 : 1), cluster,
                                    k_tile, 0);
  return dispatch(dtype, wdtype, a, nullptr, info);
}

// How many clusters of 1, 2, 4 and 8 CTAs (out[0..3]) the card holds at
// once when each CTA fills an SM's shared memory: the grid a plan may use
// without a second wave (the GPCs' SM counts set it, not the SM count).
int fused_rnn_cluster_slots(int* out) {
#ifdef FUSED_RNN_INT8
  auto kern = fused_rnn_mma_kernel<int8_t, 3, false>;
#else
  auto kern = fused_rnn_mma_kernel<bf16, 3, false>;
#endif
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < 4; ++i) {
    const int cluster = 1 << i;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster * kMaxCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemMax;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&out[i], kern, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
