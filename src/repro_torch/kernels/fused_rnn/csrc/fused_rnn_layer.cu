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
// bf16), (fp32, int8) and (bf16, int8). An int8 slab is read 8 bytes per
// 8-lane run and each value is widened to fp32, exactly, as it is stored into
// the shared weight tile, so the FMA loop is the same for every instance.
// The fp32 scales (compact: one per gate and block of kScaleBlock lanes,
// (3, nb)) multiply each gate's sum AFTER the k-split partial sums are
// reduced, before the bias: z = (u . wq) * s + b. The skip projection of
// sru_proj (fourth column) comes from the fp w_skip and is not scaled.
//
// Design. On the TPU the time-chunk grid axis ran in order with the carry in
// VMEM scratch. Here blocks run in no order, so each CTA owns kLanes hidden
// lanes for all B rows and walks every time chunk in an in-block loop, with
// the carry in shared memory. kLanes = 8 gives H / 8 = 128 CTAs at H = 1024
// (132 SMs); the TPU's block_h = 128 would give 8. The ragged lane edge
// (H % 8) is masked, not padded.
//
// Per chunk of `bt` time steps (bt * B <= 128 rows):
//   1. gate GEMM (rows x K) x (K x 3*kLanes [+ kLanes skip proj]) through
//      shared-memory tiles, fp32 SIMT FMAs. At decode (4 rows) the K axis is
//      split over the warps and reduced in shared memory, so all 256 threads
//      stream the weight slice.
//   2. nonlinearities for every (row, lane) in parallel;
//   3. the bt-step recurrence, one thread per (batch, lane);
//   4. the highway output, in parallel, written straight to device memory.
// Gate activations never reach device memory.
//
// Bound. Decode (T = 1) streams the (K, 3, H) slab once: bytes-bound
// (6 MiB bf16 at H = 1024, ~1.9 us at 3.35 TB/s; 3 MiB int8, ~0.95 us). The kernel keeps 16-byte
// loads in flight (kInFlight per thread) and splits K over the warps so every
// thread streams weights, but with one CTA per SM it holds ~16 KB in flight
// per SM, so decode is latency-bound, not bytes-bound. Prefill at T*B = 256
// rows is a 1.6 GFLOP GEMM: bytes-bound for the tensor cores, but above the
// ridge for fp32 SIMT, so this kernel is bound by its FMA issue rate and by
// tile loads it does not overlap with compute. The tensor-core form and
// double-buffered tiles are later work (measurements in PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (see repro_torch/kernels/build.py). Each entry point returns
// cudaGetLastError() after the launch.

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

__device__ __forceinline__ bool aligned16(const void* p) {
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
  const void* skip;     // (T, B, H) highway input (skip_mode 1, layer mode)
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
  int nb;               // scale blocks, ceil(H / kScaleBlock) (int8 slabs)
  float eps;
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
// TW: the gate slabs' type, TIO or int8_t (then a.wscale holds the scales).
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
          } else {
            unpack8(rw[q], std::is_same<TIO, float>::value, v);
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
        const float* sc = a.wscale + lane / kScaleBlock;
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

template <typename TIO, typename TW, int NG>
int launch(Args a, cudaStream_t stream) {
  plan(a);
  const size_t bytes = smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(fused_rnn_layer_kernel<TIO, TW, NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.H + kLanes - 1) / kLanes);
  fused_rnn_layer_kernel<TIO, TW, NG><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIO, typename TW>
int launch_ng(const Args& a, cudaStream_t s) {
  return a.ng == 4 ? launch<TIO, TW, 4>(a, s) : launch<TIO, TW, 3>(a, s);
}

// dtype: 0 = float32, 1 = bfloat16 (activations, biases, carries, w_skip);
// wdtype: the gate slabs', the same code, or 2 = int8 with fp32 scales.
// The source is built twice (kernels/build.py), so that the two nvcc runs go
// in parallel: plain for the fp weight instances, with -DFUSED_RNN_INT8 for
// the int8 ones. Each library refuses the other's pairs with -2.
int dispatch(int dtype, int wdtype, Args a, void* stream) {
  if (a.B < 1 || a.B > kMaxRows || a.T < 1 || a.H < 1 || a.d < 1) return -1;
  auto s = static_cast<cudaStream_t>(stream);
#ifdef FUSED_RNN_INT8
  if (wdtype == 2) {
    if (a.wscale == nullptr) return -1;
    a.nb = (a.H + kScaleBlock - 1) / kScaleBlock;
    if (dtype == 0) return launch_ng<float, int8_t>(a, s);
    if (dtype == 1) return launch_ng<__nv_bfloat16, int8_t>(a, s);
  }
#else
  if (dtype == 0 && wdtype == 0) return launch_ng<float, float>(a, s);
  if (dtype == 1 && wdtype == 1) return launch_ng<__nv_bfloat16, __nv_bfloat16>(a, s);
#endif
  return -2;
}

}  // namespace

extern "C" {

// One SRU/QRNN layer (fused_rnn_pallas). dtype: 0 = float32, 1 = bfloat16
// for every tensor but the gate slabs; wdtype: the slabs' (dtype, or 2 =
// int8 with the (3, nb) fp32 wscale, kScaleBlock lanes per scale).
// skip_mode: 0 none (QRNN), 1 input, 2 projection.
// w3_prev / tail0 non-null selects the QRNN shifted-input contraction.
// An unknown (dtype, wdtype) pair returns -2 and launches nothing.
int fused_rnn_layer_launch(int dtype, int wdtype, const void* u, const void* w3,
                           const void* w3_prev, const float* wscale, const void* b3,
                           const void* c0, const void* tail0, const void* skip,
                           const void* wskip, void* h_out, void* c_last, int T, int B, int d,
                           int H, int block_t, int xhat_tanh, int skip_mode,
                           void* stream) {
  Args a{};
  a.u = u; a.w3 = w3; a.w3_prev = w3_prev; a.wscale = wscale; a.b3 = b3; a.c0 = c0;
  a.tail0 = tail0;
  a.skip = skip; a.wskip = wskip; a.h_out = h_out; a.c_last = c_last;
  a.T = T; a.B = B; a.d = d; a.H = H; a.bt = block_t;
  a.K = w3_prev != nullptr ? 2 * d : d;
  a.ng = skip_mode == 2 ? 4 : 3;
  a.xhat_tanh = xhat_tanh; a.skip_mode = skip_mode; a.prenorm = 0; a.eps = 0.0f;
  return dispatch(dtype, wdtype, a, stream);
}

// One layer of the depth-fused stack (fused_rnn_stack_pallas): pre-norm of
// the fp32 residual stream x (d == H), gates, recurrence, highway with the
// normed input as skip (SRU) or none (QRNN), x_out = x + h in fp32.
// QRNN (w3_prev non-null) reads the normed tail and writes the normed u[T-1].
// dtype / wdtype / wscale as for fused_rnn_layer_launch.
int fused_rnn_stack_layer_launch(int dtype, int wdtype, const float* x, const void* w3,
                                 const void* w3_prev, const float* wscale, const void* b3,
                                 const void* ln_g, const void* c0, const void* tail0,
                                 float* x_out, void* c_last, void* tail_last, int T, int B,
                                 int H, int block_t, float eps, void* stream) {
  Args a{};
  a.u = x; a.w3 = w3; a.w3_prev = w3_prev; a.wscale = wscale; a.b3 = b3; a.ln_g = ln_g;
  a.c0 = c0; a.tail0 = tail0; a.x_out = x_out; a.c_last = c_last; a.tail_last = tail_last;
  a.T = T; a.B = B; a.d = H; a.H = H; a.bt = block_t;
  const bool qrnn = w3_prev != nullptr;
  a.K = qrnn ? 2 * H : H;
  a.ng = 3;
  a.xhat_tanh = qrnn ? 1 : 0; a.skip_mode = qrnn ? 0 : 1; a.prenorm = 1; a.eps = eps;
  return dispatch(dtype, wdtype, a, stream);
}

}  // extern "C"
