// Decode-shape GQA attention over a KV cache for Hopper (sm_90a), plain C
// interface.
//
// Replaces src/repro/kernels/gqa_decode/gqa_decode.py::gqa_decode_pallas
// (B5; body _decode_kernel). For every lane b and KV head h, the G query
// heads of that group attend to the first lengths[b] rows of the cache:
//   s[g, r] = (q[g] . k[r]) * Dh**-0.5          fp32, rows r < lengths[b]
//   out[g]  = sum_r softmax_r(s[g])[r] * v[r]    fp32, stored in q's dtype
// with q (B, Hq = Hkv * G, Dh), k and v (B, S, Hkv, Dh) and lengths (B,)
// int32, read from device memory. Rows at or past the length take no part.
//
// Design. On the TPU one program walked the S axis in order, carrying the
// online-softmax state (m, l, acc) in VMEM scratch from one grid step to the
// next. Blocks on Hopper run in parallel and in no order, and with B = 4 and
// Hkv = 8 there are only 32 (lane, head) pairs for 132 SMs. So the S axis is
// cut into n_split splits of rows_per_split rows (the wrapper picks them for
// about four CTAs per SM), and
//   pass 1: one CTA of 128 threads per (split, head, lane) walks its rows in
//           tiles of kTile = 32 with its own (m, l, acc) in fp32. The next
//           tile's K and V rows are loaded with 16-byte loads into registers
//           while the current tile is computed from shared memory (fp32,
//           rows padded so that neither phase has bank conflicts). Scores:
//           warp w takes the heads g = w, w+4, .. and lane j the tile's row
//           j, so the row max and sum of the online softmax are warp
//           shuffles. P.V: each thread owns 4 columns of some heads and
//           reads each V row once for all of them. A split whose rows all lie
//           at or past the length writes l = 0 and stops: the combine gives
//           it zero weight (with the TPU's finite -1e30 mask it would carry
//           the weight of its masked rows).
//   pass 2: one thread per output element combines the splits' partials,
//           out = sum_i exp(m_i - M) acc_i / sum_i exp(m_i - M) l_i over the
//           splits with l_i > 0. With one split pass 1 writes the output and
//           pass 2 is not launched.
// The kernel has an instance per dtype, head dim (16, 32, 64, 128) and group
// bucket (G <= 4, 8, 32), so registers and the unrolled head loops follow the
// group size. Softmax in expf (not __expf), the final division as the TPU
// kernel's acc / l; no fast-math flags.
//
// Bound. Bytes: every valid K and V row is read once (the cache is not
// reused beyond the G heads of a group), plus q and out. At the llama3-8b
// serve shape (B = 4, Hkv = 8, Dh = 128, bf16, 1025 valid rows) that is
// 16.8 MB, 5.0 us at 3.35 TB/s; the G * Dh FMAs per row (4 per byte) are far
// below the fp32 rate. Tensor cores, TMA and wgmma are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (see repro_torch/kernels/build.py). gqa_decode_launch returns
// cudaGetLastError() after the launches, or a negative code for arguments it
// refuses; gqa_decode_info reports an instance's shared memory and occupancy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // cache rows per tile: one per lane in the score phase
constexpr int kMaxG = 32;      // query heads per KV head (instances for G <= 4, 8, 32)
constexpr int kPad = 4;        // floats of padding per shared row

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int kDh, int kG>
struct Shape {
  static constexpr int kStride = kDh + kPad;                 // floats per shared K/V row
  static constexpr int kPStride = kTile + 1;                 // floats per shared P row
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte load
  static constexpr int kVecsPerRow = kDh / kElems;
  static constexpr int kVecsPerThread = (kTile * kVecsPerRow + kThreads - 1) / kThreads;
  static constexpr int kGScore = (kG + kWarps - 1) / kWarps;  // heads per warp, score phase
  static constexpr int kCols = kDh / 4;                       // 4-column groups of a row
  static constexpr int kPvGroups = kThreads / kCols;          // head groups, P.V phase
  static constexpr int kGPv = (kG + kPvGroups - 1) / kPvGroups;  // heads per thread, P.V
  static int smem_bytes(int g) {
    return static_cast<int>(sizeof(float)) *
           (g * kDh + 2 * kTile * kStride + g * kPStride + 2 * g);
  }
};

// One CTA per (split, KV head, lane): the online softmax over the split's
// valid rows. Writes the output (n_split == 1) or the split's partial
// (m, l) into part_ml (B, Hkv, n_split, G, 2) and acc into part_acc
// (B, Hkv, n_split, G, Dh). Instances for G <= kG, so that registers and
// the unrolled head loops follow the group size.
template <typename T, int kDh, int kG>
__global__ void __launch_bounds__(kThreads)
gqa_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int n_s, int n_kv, int n_g,
                        int rows_per_split, float scale) {
  using Sh = Shape<T, kDh, kG>;
  extern __shared__ float smem[];
  float* q_s = smem;                              // (G, Dh)
  float* k_s = q_s + n_g * kDh;                   // (kTile, kStride)
  float* v_s = k_s + kTile * Sh::kStride;         // (kTile, kStride)
  float* p_s = v_s + kTile * Sh::kStride;         // (G, kPStride)
  float* ml_s = p_s + n_g * Sh::kPStride;         // (G, 2): corr per tile, then (m, l)

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], n_s);
  const int row0 = split * rows_per_split;
  const int row_end = min(row0 + rows_per_split, len);
  const int64_t part = (static_cast<int64_t>(b) * n_kv + h) * n_split + split;

  if (n_split > 1 && row0 >= row_end) {  // no valid row: zero weight in the combine
    for (int g = tid; g < n_g; g += kThreads) {
      part_ml[(part * n_g + g) * 2] = -INFINITY;
      part_ml[(part * n_g + g) * 2 + 1] = 0.f;
    }
    return;
  }

  const int64_t q_off = (static_cast<int64_t>(b) * n_kv + h) * n_g * kDh;
  for (int i = tid; i < n_g * kDh; i += kThreads) q_s[i] = to_f(q[q_off + i]);

  // Row r of this (lane, head) starts at ((b * S + r) * Hkv + h) * Dh.
  const int64_t row_stride = static_cast<int64_t>(n_kv) * kDh;
  const T* k_bh = k + static_cast<int64_t>(b) * n_s * row_stride + static_cast<int64_t>(h) * kDh;
  const T* v_bh = v + static_cast<int64_t>(b) * n_s * row_stride + static_cast<int64_t>(h) * kDh;

  uint4 kreg[Sh::kVecsPerThread], vreg[Sh::kVecsPerThread];
  auto load_tile = [&](int t0) {  // rows at or past row_end load as zeros
#pragma unroll
    for (int j = 0; j < Sh::kVecsPerThread; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / Sh::kVecsPerRow, c = (i % Sh::kVecsPerRow) * Sh::kElems;
      kreg[j] = vreg[j] = make_uint4(0u, 0u, 0u, 0u);
      if (r < kTile && t0 + r < row_end) {
        const int64_t off = (t0 + r) * row_stride + c;
        kreg[j] = *reinterpret_cast<const uint4*>(k_bh + off);
        vreg[j] = *reinterpret_cast<const uint4*>(v_bh + off);
      }
    }
  };
  auto store_tile = [&]() {  // registers -> fp32 shared rows
#pragma unroll
    for (int j = 0; j < Sh::kVecsPerThread; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / Sh::kVecsPerRow, c = (i % Sh::kVecsPerRow) * Sh::kElems;
      if (r < kTile) {
        const T* kv = reinterpret_cast<const T*>(&kreg[j]);
        const T* vv = reinterpret_cast<const T*>(&vreg[j]);
#pragma unroll
        for (int e = 0; e < Sh::kElems; e += 4) {
          *reinterpret_cast<float4*>(k_s + r * Sh::kStride + c + e) =
              make_float4(to_f(kv[e]), to_f(kv[e + 1]), to_f(kv[e + 2]), to_f(kv[e + 3]));
          *reinterpret_cast<float4*>(v_s + r * Sh::kStride + c + e) =
              make_float4(to_f(vv[e]), to_f(vv[e + 1]), to_f(vv[e + 2]), to_f(vv[e + 3]));
        }
      }
    }
  };

  // Score phase state: warp w owns heads w + i * kWarps (replicated over lanes).
  float m[Sh::kGScore], l[Sh::kGScore];
#pragma unroll
  for (int i = 0; i < Sh::kGScore; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  // P.V phase state: thread owns columns 4 * col .. +3 of heads grp + i * kPvGroups.
  const int col = tid % Sh::kCols, grp = tid / Sh::kCols;
  float4 acc[Sh::kGPv];
#pragma unroll
  for (int i = 0; i < Sh::kGPv; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  load_tile(row0);
  for (int t0 = row0; t0 < row_end; t0 += kTile) {
    __syncthreads();  // the last tile's P.V reads are done
    store_tile();
    __syncthreads();
    if (t0 + kTile < row_end) load_tile(t0 + kTile);  // in flight during this tile

    // Scores and the online softmax: lane = row of the tile.
    float s[Sh::kGScore];
#pragma unroll
    for (int i = 0; i < Sh::kGScore; ++i) s[i] = 0.f;
    const float* krow = k_s + lane * Sh::kStride;
#pragma unroll 4
    for (int c = 0; c < kDh; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int i = 0; i < Sh::kGScore; ++i) {
        const int g = warp + i * kWarps;
        if (g < n_g) {
          const float4 qq = *reinterpret_cast<const float4*>(q_s + g * kDh + c);
          s[i] = fmaf(qq.x, kk.x, s[i]);
          s[i] = fmaf(qq.y, kk.y, s[i]);
          s[i] = fmaf(qq.z, kk.z, s[i]);
          s[i] = fmaf(qq.w, kk.w, s[i]);
        }
      }
    }
    const bool valid = t0 + lane < row_end;
#pragma unroll
    for (int i = 0; i < Sh::kGScore; ++i) {
      const int g = warp + i * kWarps;
      if (g < n_g) {
        const float sc = valid ? s[i] * scale : -INFINITY;
        const float m_new = fmaxf(m[i], warp_max(sc));  // finite: row t0 is valid
        const float p = valid ? expf(sc - m_new) : 0.f;
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(p);
        m[i] = m_new;
        p_s[g * Sh::kPStride + lane] = p;
        if (lane == 0) ml_s[2 * g] = corr;
      }
    }
    __syncthreads();

    // P.V: each V row is read once for all of this thread's heads.
#pragma unroll
    for (int i = 0; i < Sh::kGPv; ++i) {
      const int g = grp + i * Sh::kPvGroups;
      if (g < n_g) {
        const float corr = ml_s[2 * g];
        acc[i].x *= corr;
        acc[i].y *= corr;
        acc[i].z *= corr;
        acc[i].w *= corr;
      }
    }
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      const float4 vv = *reinterpret_cast<const float4*>(v_s + r * Sh::kStride + 4 * col);
#pragma unroll
      for (int i = 0; i < Sh::kGPv; ++i) {
        const int g = grp + i * Sh::kPvGroups;
        if (g < n_g) {
          const float p = p_s[g * Sh::kPStride + r];
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
    }
  }

  __syncthreads();  // the last tile's corr reads are done
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < Sh::kGScore; ++i) {
      const int g = warp + i * kWarps;
      if (g < n_g) {
        ml_s[2 * g] = m[i];
        ml_s[2 * g + 1] = l[i];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < Sh::kGPv; ++i) {
    const int g = grp + i * Sh::kPvGroups;
    if (g < n_g) {
      if (n_split == 1) {  // the output directly: acc / l, as the TPU kernel
        const float lg = ml_s[2 * g + 1];
        T* o = out + q_off + g * kDh + 4 * col;
        o[0] = from_f<T>(acc[i].x / lg);
        o[1] = from_f<T>(acc[i].y / lg);
        o[2] = from_f<T>(acc[i].z / lg);
        o[3] = from_f<T>(acc[i].w / lg);
      } else {
        *reinterpret_cast<float4*>(part_acc + (part * n_g + g) * kDh + 4 * col) = acc[i];
      }
    }
  }
  if (n_split > 1) {
    for (int g = tid; g < n_g; g += kThreads) {
      part_ml[(part * n_g + g) * 2] = ml_s[2 * g];
      part_ml[(part * n_g + g) * 2 + 1] = ml_s[2 * g + 1];
    }
  }
}

// One thread per output element (b, h * G + g, d): the splits' partials
// weighted by exp(m_i - M), splits without a valid row skipped.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gqa_decode_combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                          T* __restrict__ out, int64_t n_out, int n_g, int n_dh, int n_split) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n_out) return;
  const int d = static_cast<int>(idx % n_dh);
  const int64_t bg = idx / n_dh;  // (b * Hkv + h) * G + g
  const int g = static_cast<int>(bg % n_g);
  const int64_t bh = bg / n_g;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) {
    const int64_t p = (bh * n_split + s) * n_g + g;
    if (part_ml[2 * p + 1] > 0.f) mx = fmaxf(mx, part_ml[2 * p]);
  }
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const int64_t p = (bh * n_split + s) * n_g + g;
    const float ls = part_ml[2 * p + 1];
    if (ls > 0.f) {
      const float w = expf(part_ml[2 * p] - mx);
      den = fmaf(ls, w, den);
      num = fmaf(part_acc[p * n_dh + d], w, num);
    }
  }
  out[idx] = from_f<T>(num / den);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* out;
  float *part_ml, *part_acc;
  int n_b, n_s, n_kv, n_g, n_split, rows_per_split;
  cudaStream_t stream;
};

// Launches the instance for (T, kDh, kG); with `info` it launches nothing and
// writes the instance's dynamic shared memory per CTA and resident CTAs per
// SM for a.n_g into info[0], info[1].
template <typename T, int kDh, int kG>
int launch(const Args& a, int* info) {
  using Sh = Shape<T, kDh, kG>;
  auto kernel = gqa_decode_split_kernel<T, kDh, kG>;
  static bool smem_set = false;  // once per instance: the largest G's shared memory
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::smem_bytes(kG));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int smem = Sh::smem_bytes(a.n_g);
  if (info != nullptr) {
    info[0] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], kernel, kThreads, smem));
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(kDh));
  const dim3 grid(a.n_split, a.n_kv, a.n_b);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.lengths, static_cast<T*>(a.out), a.part_ml, a.part_acc, a.n_s, a.n_kv, a.n_g,
      a.rows_per_split, scale);
  if (a.n_split > 1) {
    const int64_t n_out = static_cast<int64_t>(a.n_b) * a.n_kv * a.n_g * kDh;
    const int blocks = static_cast<int>((n_out + kThreads - 1) / kThreads);
    gqa_decode_combine_kernel<T><<<blocks, kThreads, 0, a.stream>>>(
        a.part_ml, a.part_acc, static_cast<T*>(a.out), n_out, a.n_g, kDh, a.n_split);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kDh>
int launch_g(const Args& a, int* info) {
  if (a.n_g <= 4) return launch<T, kDh, 4>(a, info);
  if (a.n_g <= 8) return launch<T, kDh, 8>(a, info);
  return launch<T, kDh, kMaxG>(a, info);
}

int dispatch(int dtype, int n_dh, const Args& a, int* info) {
  if (a.n_g < 1 || a.n_g > kMaxG) return -1;
  if (dtype != 0 && dtype != 1) return -2;
  const bool f32 = dtype == 0;
  switch (n_dh) {
    case 16: return f32 ? launch_g<float, 16>(a, info) : launch_g<__nv_bfloat16, 16>(a, info);
    case 32: return f32 ? launch_g<float, 32>(a, info) : launch_g<__nv_bfloat16, 32>(a, info);
    case 64: return f32 ? launch_g<float, 64>(a, info) : launch_g<__nv_bfloat16, 64>(a, info);
    case 128:
      return f32 ? launch_g<float, 128>(a, info) : launch_g<__nv_bfloat16, 128>(a, info);
    default: return -3;
  }
}

}  // namespace

extern "C" {

// q (B, Hkv * G, Dh), k and v (B, S, Hkv, Dh), out like q: contiguous,
// 16-byte aligned, one dtype (0 = float32, 1 = bfloat16). lengths (B,) int32
// on the device. part_ml (B, Hkv, n_split, G, 2) and part_acc
// (B, Hkv, n_split, G, Dh) fp32 scratch, unused when n_split == 1.
int gqa_decode_launch(int dtype, const void* q, const void* k, const void* v,
                      const void* lengths, void* out, void* part_ml, void* part_acc, int n_b,
                      int n_s, int n_kv, int n_g, int n_dh, int n_split, int rows_per_split,
                      void* stream) {
  if (n_b < 1 || n_s < 1 || n_kv < 1 || n_split < 1 || rows_per_split < 1 ||
      static_cast<int64_t>(n_split) * rows_per_split < n_s) {
    return -1;
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) ||
      !aligned16(part_acc)) {
    return -4;
  }
  const Args a{q, k, v, static_cast<const int*>(lengths), out, static_cast<float*>(part_ml),
               static_cast<float*>(part_acc), n_b, n_s, n_kv, n_g, n_split, rows_per_split,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, n_dh, a, nullptr);
}

// The instance's dynamic shared memory per CTA (info[0], bytes) and resident
// CTAs per SM (info[1]) for this dtype, head dim and group size.
int gqa_decode_info(int dtype, int n_dh, int n_g, int* info) {
  Args a{};
  a.n_g = n_g;
  return dispatch(dtype, n_dh, a, info);
}

}  // extern "C"
