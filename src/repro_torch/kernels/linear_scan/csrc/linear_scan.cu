// First-order linear recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/linear_scan/linear_scan.py::linear_scan_pallas
// (B3; bodies _kernel_sequential and _kernel_hillis_steele). It computes
//   c_t = a_t * c_{t-1} + b_t      for t = 0 .. T-1, elementwise over F,
// with a, b: (T, F) and c0: (F,) read in their dtype and widened to fp32, the
// carry in fp32 for all T, and each c_t stored in the operands' dtype. The
// product and the sum are rounded separately (__fmul_rn, __fadd_rn: no FMA
// contraction), as the plain version ref.py rounds them, so the two agree
// bit for bit.
//
// Design. On the TPU the grid walked `block_t` time chunks in order and kept
// the carry in VMEM scratch between grid steps. Blocks on Hopper run in no
// order, so here one thread owns kVec neighbouring features for ALL of T and
// loops over time with the carry in registers; the time block of the TPU
// kernel changes no value and is not an argument. Neighbouring threads take
// neighbouring features, so every load of a row of a_t or b_t is coalesced.
// The loads of the next kAhead time steps do not depend on the carry and are
// issued before the FMA chain that consumes them. The vector path reads kVec
// = 8 bytes of each operand per thread and step (2 fp32 or 4 bf16); it needs
// F % kVec == 0 and 8-byte aligned pointers. Any other F or pointer takes the
// per-element path (kVec = 1). The ragged F edge is masked: a thread with no
// feature returns.
//
// Bound. Bytes: the kernel reads a and b once and writes c once (2 fp32
// operations per element). On the serving path F = B * H = 4 * 1024 = 4096
// in bf16: at T = 64 that is 3 * 64 * 4096 * 2 B = 1.57 MB, 0.47 us at
// 3.35 TB/s; at T = 1 it is 24.6 KB and the launch itself dominates.
// F = 4096 gives only 1024 threads (16 CTAs of 64 on 132 SMs) with kAhead
// steps in flight each, so the kernel is latency-bound, not bytes-bound; a
// two-pass chunked scan across CTAs (per-chunk (A, B) composition, then a
// carry pass) is the later fix (measurements in PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (see repro_torch/kernels/build.py). The entry point returns
// cudaGetLastError() after the launch, or a negative code for arguments it
// refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;    // threads per CTA
constexpr int kAhead = 16;      // time steps loaded before the carry chain uses them
constexpr int kVecBytes = 8;    // bytes of each operand a thread reads per step (vector path)

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

// kVec consecutive elements, loaded and stored as one aligned access.
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c0,
                   T* __restrict__ out, int n_t, int n_f) {
  using P = Pack<T, kVec>;
  const int64_t f0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (f0 >= n_f) return;  // ragged edge; the vector path has n_f % kVec == 0

  float c[kVec];
  const P cp = *reinterpret_cast<const P*>(c0 + f0);
#pragma unroll
  for (int v = 0; v < kVec; ++v) c[v] = to_f(cp.v[v]);

  for (int t0 = 0; t0 < n_t; t0 += kAhead) {
    P av[kAhead], bv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < n_t) {
        const int64_t off = static_cast<int64_t>(t0 + u) * n_f + f0;
        av[u] = *reinterpret_cast<const P*>(a + off);
        bv[u] = *reinterpret_cast<const P*>(b + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < n_t) {
        P o;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          c[v] = __fadd_rn(__fmul_rn(to_f(av[u].v[v]), c[v]), to_f(bv[u].v[v]));
          o.v[v] = from_f<T>(c[v]);
        }
        *reinterpret_cast<P*>(out + static_cast<int64_t>(t0 + u) * n_f + f0) = o;
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % static_cast<std::uintptr_t>(bytes) == 0;
}

template <typename T>
int launch(const void* a, const void* b, const void* c0, void* out, int n_t, int n_f,
           cudaStream_t stream) {
  constexpr int kVec = kVecBytes / static_cast<int>(sizeof(T));
  const auto* pa = static_cast<const T*>(a);
  const auto* pb = static_cast<const T*>(b);
  const auto* pc = static_cast<const T*>(c0);
  auto* po = static_cast<T*>(out);
  const bool vec = n_f % kVec == 0 && aligned(a, kVecBytes) && aligned(b, kVecBytes) &&
                   aligned(c0, kVecBytes) && aligned(out, kVecBytes);
  if (vec) {
    const int threads = n_f / kVec;
    linear_scan_kernel<T, kVec><<<(threads + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        pa, pb, pc, po, n_t, n_f);
  } else {
    linear_scan_kernel<T, 1><<<(n_f + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        pa, pb, pc, po, n_t, n_f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// c_t = a_t * c_{t-1} + b_t over (T, F) row-major, contiguous operands.
// dtype: 0 = float32, 1 = bfloat16, for a, b, c0 and out alike.
int linear_scan_launch(int dtype, const void* a, const void* b, const void* c0, void* out,
                       int n_t, int n_f, void* stream) {
  if (n_t < 1 || n_f < 1) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, c0, out, n_t, n_f, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c0, out, n_t, n_f, s);
  return -2;
}

}  // extern "C"
