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
// Any G >= 1 and any Dh that is a multiple of 8 up to 256.
//
// Bound. Bytes: every valid K and V row is read once (no reuse beyond the
// G heads of a group), plus q and out. At the llama3-8b serve shape (B = 4,
// Hkv = 8, Dh = 128, bf16, 1025 valid rows) that is 16.8 MB, 5.0 us at
// 3.35 TB/s; the 4 G Dh operations per row are far below the tensor rate.
// A CTA's life is a chain of dependent memory round trips (the length, the
// first tiles, the arrival, the combine) plus about 2 us per tile it walks
// (H100 80GB HBM3, 700 W, PERF.md), so the design keeps several tiles in
// flight per CTA, spends one launch per call and as few round trips as it
// can after the tiles.
//
// Design. On the TPU one program walked the S axis in order, carrying the
// online-softmax state (m, l, acc) in VMEM from one grid step to the next.
// Blocks on Hopper run in parallel and in no order, and with B = 4 and
// Hkv = 8 there are only 32 (lane, head) pairs for 132 SMs. So the S axis is
// cut into n_split splits of rows_per_split rows (the wrapper sizes them for
// one wave of the instance's resident CTAs), one CTA of 128 threads per
// (split, head block, KV head, lane):
//   bf16 (tensor cores): K and V stay bf16 in shared memory, in a ring of
//     kStages tiles of 64 rows (3 up to Dh 128, 2 above) filled by 16-byte
//     cp.async copies (rows past the length are zero-filled, not read); q
//     is copied the same way before the length is read. The scores are
//     mma.sync.m16n8k16 products: 16 query heads (padded; q is zero past
//     G) form M, the tile's rows N, Dh K in 16-column steps, fragments by
//     ldmatrix from rows padded by 16 bytes (no bank conflicts). A warp
//     owns one 16-head block and a slice of the tile's rows (4 slices at
//     G <= 16, 2 at G <= 32, 1 at G <= 64), so every K and V byte is read
//     from shared memory once per 16-head block. The online softmax runs
//     on the accumulator fragments (row max and sum by quad shuffles, -inf
//     masking before expf). P.V: P is fp32; it is split as P_hi + P_lo,
//     both bf16, and both go through mma.sync into one fp32 accumulator
//     (error near 2^-17 of P, where a single bf16 rounding would be 2^-9;
//     the tensor cores have the time to spare). The warps' row slices are
//     combined through shared memory at the end. Groups above 64 take a
//     grid axis of 64-head blocks.
//   fp32 (CUDA cores, exact fp32 products): tiles of 32 rows widened into
//     shared memory, the next tile loaded into registers while the current
//     one is computed; warp w scores the heads w, w+4, .. with lane j on the
//     tile's row j; in P.V each thread owns 4 columns of some heads. Head
//     blocks of 32 (instances for G <= 4, 8, 32), head-dim buckets 32, 64,
//     128, 256 with the columns past Dh never stored.
//   Splits are combined by the last CTA to arrive: each CTA writes its
//   partial (m, l, acc; a split with no valid row l = 0 and acc = 0), one
//   thread fences and adds one to the (lane, KV head, head block) counter;
//   the CTA that brings it to n_split combines the partials in one pass
//   with a running max, out = sum_i exp(m_i - M) acc_i / sum_i exp(m_i - M)
//   l_i over the splits with l_i > 0, every load independent of the others,
//   and sets the counter back to 0 for the next call. With one split the
//   CTA stores the output directly.
// Softmax in expf (not __expf), the final division as the TPU kernel's
// acc / l; no fast-math flags.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (see repro_torch/kernels/build.py). gqa_decode_launch returns
// cudaGetLastError() after the launch, or a negative code for arguments it
// refuses; gqa_decode_info reports an instance's resources.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 256;    // largest head dim
constexpr int kMmaHeads = 64;  // query heads per CTA, bf16 (16 per m-block, 4 m-blocks)
constexpr int kMmaRows = 64;   // cache rows per tile, bf16
constexpr int kTile = 32;      // cache rows per tile, fp32: one per lane in the score phase
constexpr int kPad = 4;        // floats of padding per shared row, fp32

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

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

// ---------------------------------------------------------------------------
// The CTA's result -> the output, or a split's partial and the last-CTA
// combine. res_ml (n_h, 2) holds (m, l) and res_acc (n_h, n_dh) the
// unnormalised acc of this CTA's heads g_lo .. g_lo + n_h - 1, in shared
// memory. out_bh points at out[b, h * G + g_lo]; part_* are
// (B, Hkv, n_split, G, 2) and (B, Hkv, n_split, G, Dh); bh = b * Hkv + h.
// ---------------------------------------------------------------------------

template <typename T>
__device__ void finish(const float* res_ml, const float* res_acc, int n_h, int g_lo, int n_dh,
                       int n_g, int64_t bh, T* out_bh, float* part_ml, float* part_acc,
                       int* counter) {
  __shared__ int s_last;
  const int tid = threadIdx.x, n_split = gridDim.x, split = blockIdx.x;
  if (n_split == 1) {  // the output directly: acc / l, as the TPU kernel
    for (int i = tid; i < n_h * n_dh; i += kThreads) {
      out_bh[i] = from_f<T>(res_acc[i] / res_ml[2 * (i / n_dh) + 1]);
    }
    return;
  }
  // This split's partial; a split with no valid row writes l = 0 and a zero acc.
  const int64_t p0 = (bh * n_split + split) * n_g + g_lo;
  for (int i = tid; i < 2 * n_h; i += kThreads) part_ml[2 * p0 + i] = res_ml[i];
  const int n4 = n_h * n_dh / 4;
  for (int i = tid; i < n4; i += kThreads) {
    reinterpret_cast<float4*>(part_acc + p0 * n_dh)[i] =
        reinterpret_cast<const float4*>(res_acc)[i];
  }
  __syncthreads();
  if (tid == 0) {  // the CTA's partials are visible before its arrival
    __threadfence();
    s_last = atomicAdd(counter, 1) == n_split - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // The last CTA: every split's partial has arrived (read past L1). One
  // pass over the splits with a running max, so that every load is
  // independent of the others: w_i = exp(m_i - M) for the splits with
  // l_i > 0, rescaled as M grows.
  const int q4 = n_dh / 4;
  const int64_t stride = n_g;  // partials of one split apart
  const float2* ml_bh = reinterpret_cast<const float2*>(part_ml) + bh * n_split * stride + g_lo;
  const float* acc_bh = part_acc + (bh * n_split * stride + g_lo) * n_dh;
  for (int i = tid; i < n4; i += kThreads) {
    const int j = i / q4, c = (i % q4) * 4;
    float mx = -INFINITY, den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      const float2 ml = __ldcg(ml_bh + s * stride + j);
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(acc_bh + (s * stride + j) * n_dh + c));
      const float ms = ml.y > 0.f ? ml.x : -INFINITY;  // l = 0 (acc = 0): no weight
      const float m_new = fmaxf(mx, ms);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(mx - mu), w = expf(ms - mu);
      den = fmaf(ml.y, w, den * corr);
      num.x = fmaf(a.x, w, num.x * corr);
      num.y = fmaf(a.y, w, num.y * corr);
      num.z = fmaf(a.z, w, num.z * corr);
      num.w = fmaf(a.w, w, num.w * corr);
      mx = m_new;
    }
    T* o = out_bh + j * n_dh + c;
    o[0] = from_f<T>(num.x / den);
    o[1] = from_f<T>(num.y / den);
    o[2] = from_f<T>(num.z / den);
    o[3] = from_f<T>(num.w / den);
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros, and nothing read, when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a (16 x 16, row-major) . b (16 x 8, col-major), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// (x, y) -> their bf16 roundings (hi) and the bf16 roundings of the rests (lo).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const bf16 hx = __float2bfloat16(x), hy = __float2bfloat16(y);
  hi = pack_bf16(hx, hy);
  lo = pack_bf16(__float2bfloat16(x - __bfloat162float(hx)),
                 __float2bfloat16(y - __bfloat162float(hy)));
}

// An instance per head-dim bucket kDh (64, 128, 256) and m-blocks kMB (1, 2,
// 4 blocks of 16 heads). Shared rows are round_up(Dh, 16) bf16 plus 16 bytes.
template <int kDh, int kMB>
struct MmaShape {
  static constexpr int kRG = kWarps / kMB;       // row slices of a tile (warps per m-block)
  static constexpr int kRowsW = kMmaRows / kRG;  // a warp's rows per tile: 16, 32, 64
  static constexpr int kNB = kRowsW / 8;         // score n-blocks per warp
  static constexpr int kKS = kDh / 16;           // k-steps at most
  static constexpr int kDB = kDh / 8;            // output n-blocks at most
  static constexpr int kStages = kDh <= 128 ? 3 : 2;
  static constexpr bool kQInRegs = kDh <= 128;  // q fragments in registers, else ldmatrix
  __host__ __device__ static int stride(int n_dh) {  // bytes
    return 2 * ((n_dh + 15) / 16 * 16) + 16;
  }
  static int smem_bytes(int n_dh) {
    const int rows = stride(n_dh) * (16 * kMB + 2 * kStages * kMmaRows);  // q, ring
    const int reduce = static_cast<int>(sizeof(float)) * (kWarps * 16 + kMmaHeads) * n_dh;
    return rows > reduce ? rows : reduce;
  }
};

// One CTA per (split, KV head x head block, lane): the online softmax over
// the split's valid rows for up to 16 * kMB heads.
template <int kDh, int kMB>
__global__ void __launch_bounds__(kThreads)
gqa_decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const int* __restrict__ lengths,
                      bf16* __restrict__ out, float* __restrict__ part_ml,
                      float* __restrict__ part_acc, int* __restrict__ counters, int n_s,
                      int n_kv, int n_g, int n_dh, int rows_per_split, float scale) {
  using Sh = MmaShape<kDh, kMB>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_ml[kWarps][16][2];  // per warp and head row: (m, l)
  __shared__ float res_ml[kMmaHeads][2];   // per head of the CTA: (M, L)
  __shared__ float wts[kMmaHeads][Sh::kRG];

  const int n_hb = (n_g + 16 * kMB - 1) / (16 * kMB);
  const int split = blockIdx.x, h = blockIdx.y / n_hb, hb = blockIdx.y % n_hb, b = blockIdx.z;
  const int g_lo = hb * 16 * kMB, n_h = min(16 * kMB, n_g - g_lo);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % Sh::kRG, mb = warp / Sh::kRG;
  const bool active = mb * 16 < n_h;  // warp-uniform: its m-block holds a head
  const int64_t bh = static_cast<int64_t>(b) * n_kv + h;
  const int rd = (n_dh + 15) / 16 * 16;  // columns of a shared row used by the mma
  const int n_ks = rd / 16, n_c = n_dh / 8;
  const int stride = Sh::stride(n_dh);
  unsigned char* q_s = smem;                       // (16 kMB, stride)
  unsigned char* ring = smem + stride * 16 * kMB;  // (kStages, 2, kMmaRows, stride)

  // q rows first (zero past the group and past Dh): their copies need no
  // length, so they are in flight while the length is read.
  const bf16* q_bh = q + (bh * n_g + g_lo) * n_dh;
  for (int i = tid; i < 16 * kMB * (rd / 8); i += kThreads) {
    const int j = i / (rd / 8), c = (i % (rd / 8)) * 8;
    const bool valid = j < n_h && c < n_dh;
    cp_async16(q_s + j * stride + 2 * c, q_bh + (valid ? j * n_dh + c : 0), valid);
  }

  const int len = min(lengths[b], n_s);
  const int row0 = split * rows_per_split;
  const int row_end = min(row0 + rows_per_split, len);
  const int n_tiles = row_end > row0 ? (row_end - row0 + kMmaRows - 1) / kMmaRows : 0;
  const int row_stride = n_kv * n_dh;  // elements between cache rows
  const int64_t kv_off = (static_cast<int64_t>(b) * n_s * n_kv + h) * n_dh;
  const bf16* k_bh = k + kv_off;
  const bf16* v_bh = v + kv_off;

  // A thread copies the 16-byte pieces tid, tid + kThreads, .. of a tile;
  // (row, piece) advance by (kThreads / n_c, kThreads % n_c) with a carry.
  const int r_first = tid / n_c, c_first = tid % n_c;
  const int dr = kThreads / n_c, dc = kThreads % n_c;
  auto load_tile = [&](int t, int slot) {  // rows at or past row_end are zero-filled
    const int t0 = row0 + t * kMmaRows;
    const int n_valid = row_end - t0;  // >= 1
    const bf16* kt = k_bh + static_cast<int64_t>(t0) * row_stride;
    const bf16* vt = v_bh + static_cast<int64_t>(t0) * row_stride;
    unsigned char* ks = ring + (2 * slot) * kMmaRows * stride;
    unsigned char* vs = ks + kMmaRows * stride;
    for (int r = r_first, c = c_first; r < kMmaRows;) {
      const bool valid = r < n_valid;
      const int src = (valid ? r * row_stride : 0) + 8 * c;
      const int dst = r * stride + 16 * c;
      cp_async16(ks + dst, kt + src, valid);
      cp_async16(vs + dst, vt + src, valid);
      r += dr;
      c += dc;
      if (c >= n_c) {
        c -= n_c;
        ++r;
      }
    }
  };
#pragma unroll
  for (int s = 0; s < Sh::kStages - 1; ++s) {  // q joins the first group
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }
  if (rd != n_dh) {  // the zero columns past Dh of every ring row
    for (int r = tid; r < 2 * Sh::kStages * kMmaRows; r += kThreads) {
      *reinterpret_cast<uint4*>(ring + r * stride + 2 * n_dh) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_wait<Sh::kStages - 2>();
  __syncthreads();  // q, the first tile and the zero columns are in shared memory

  // Fragment addresses: ldmatrix lane -> (row, column) of its 8 x 8 matrix.
  const int mat = lane >> 3, mrow = lane & 7;
  const int a_row = (mat & 1) * 8 + mrow, a_col = (mat >> 1) * 8;  // q (A) and V (B, .trans)
  const int b_row = (mat >> 1) * 8 + mrow, b_col = (mat & 1) * 8;  // K (B)
  const unsigned char* q_frag = q_s + (mb * 16 + a_row) * stride + 2 * a_col;

  uint32_t qa[Sh::kQInRegs ? Sh::kKS : 1][4];
  if constexpr (Sh::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < Sh::kKS; ++kk) {
      if (kk < n_ks) ldmatrix_x4(qa[kk], q_frag + 32 * kk);
    }
  }

  // Online-softmax state of heads lane/4 and lane/4 + 8 of the m-block:
  // m quad-uniform, l this thread's share of the row sum.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[Sh::kDB][4];
#pragma unroll
  for (int nb = 0; nb < Sh::kDB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<Sh::kStages - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    {
      const int tn = t + Sh::kStages - 1;
      if (tn < n_tiles) load_tile(tn, tn % Sh::kStages);
      cp_async_commit();
    }
    if (!active) continue;
    const unsigned char* ks = ring + (2 * (t % Sh::kStages)) * kMmaRows * stride;
    const unsigned char* vs = ks + kMmaRows * stride;
    const int wrow = rg * Sh::kRowsW;  // the warp's first row in the tile

    // Scores: s[j] is n-block j of the warp's rows, heads (lane/4, lane/4 + 8).
    float s[Sh::kNB][4];
#pragma unroll
    for (int j = 0; j < Sh::kNB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Sh::kKS; ++kk) {
      if (kk < n_ks) {
        uint32_t a[4];
        if constexpr (Sh::kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
        } else {
          ldmatrix_x4(a, q_frag + 32 * kk);
        }
#pragma unroll
        for (int np = 0; np < Sh::kNB / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + (wrow + np * 16 + b_row) * stride + 2 * (kk * 16 + b_col));
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }

    // Online softmax on the fragments: mask, row max over the quad, exp.
    const int t0 = row0 + t * kMmaRows + wrow + 2 * (lane & 3);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < Sh::kNB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = t0 + j * 8 + (e & 1) < row_end ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float corr[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;  // no valid row yet: p = 0, not NaN
      corr[i] = expf(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < Sh::kNB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mu[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int nb = 0; nb < Sh::kDB; ++nb) {
      acc[nb][0] *= corr[0];
      acc[nb][1] *= corr[0];
      acc[nb][2] *= corr[1];
      acc[nb][3] *= corr[1];
    }

    // P.V: the score fragments of two n-blocks are the A fragment of one
    // k-step; P = P_hi + P_lo, two mma into one fp32 accumulator.
#pragma unroll
    for (int kstep = 0; kstep < Sh::kRowsW / 16; ++kstep) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kstep][0], s[2 * kstep][1], ph[0], pl[0]);
      split_bf16(s[2 * kstep][2], s[2 * kstep][3], ph[1], pl[1]);
      split_bf16(s[2 * kstep + 1][0], s[2 * kstep + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kstep + 1][2], s[2 * kstep + 1][3], ph[3], pl[3]);
      const unsigned char* vrow = vs + (wrow + kstep * 16 + a_row) * stride + 2 * a_col;
#pragma unroll
      for (int dp = 0; dp < Sh::kDB / 2; ++dp) {
        if (dp < n_ks) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vrow + 32 * dp);
          mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
          mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
          mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
        }
      }
    }
  }

  // The warps' row slices -> one (M, L, acc) per head, in shared memory.
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the reduction
  float* red_acc = reinterpret_cast<float*>(smem);  // (kWarps, 16, n_dh)
  float* res_acc = red_acc + kWarps * 16 * n_dh;     // (n_h, n_dh)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int hrow = lane >> 2;
  if ((lane & 3) == 0) {
    red_ml[warp][hrow][0] = m[0];
    red_ml[warp][hrow][1] = l[0];
    red_ml[warp][hrow + 8][0] = m[1];
    red_ml[warp][hrow + 8][1] = l[1];
  }
#pragma unroll
  for (int nb = 0; nb < Sh::kDB; ++nb) {
    if (nb < n_c) {
      float* r = red_acc + (warp * 16 + hrow) * n_dh + nb * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(r) = make_float2(acc[nb][0], acc[nb][1]);
      *reinterpret_cast<float2*>(r + 8 * n_dh) = make_float2(acc[nb][2], acc[nb][3]);
    }
  }
  __syncthreads();
  for (int j = tid; j < n_h; j += kThreads) {
    const int w0 = (j / 16) * Sh::kRG, row = j % 16;
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < Sh::kRG; ++r) {
      if (red_ml[w0 + r][row][1] > 0.f) M = fmaxf(M, red_ml[w0 + r][row][0]);
    }
    float L = 0.f;
#pragma unroll
    for (int r = 0; r < Sh::kRG; ++r) {
      const float lr = red_ml[w0 + r][row][1];
      const float w = lr > 0.f ? expf(red_ml[w0 + r][row][0] - M) : 0.f;
      wts[j][r] = w;
      L = fmaf(lr, w, L);
    }
    res_ml[j][0] = M;
    res_ml[j][1] = L;
  }
  __syncthreads();
  for (int i = tid; i < n_h * n_dh; i += kThreads) {
    const int j = i / n_dh, d = i % n_dh;
    const int w0 = (j / 16) * Sh::kRG, row = j % 16;
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < Sh::kRG; ++r) {
      o = fmaf(red_acc[((w0 + r) * 16 + row) * n_dh + d], wts[j][r], o);
    }
    res_acc[i] = o;
  }
  __syncthreads();
  finish<bf16>(&res_ml[0][0], res_acc, n_h, g_lo, n_dh, n_g, bh, out + (bh * n_g + g_lo) * n_dh,
               part_ml, part_acc, counters + (static_cast<int64_t>(b) * gridDim.y + blockIdx.y));
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

// An instance per head-dim bucket kDh (32, 64, 128, 256; Dh <= kDh is a
// runtime argument) and group bucket kG (heads per CTA: 4, 8, 32).
template <int kDh, int kG>
struct SimtShape {
  static constexpr int kStride = kDh + kPad;                 // floats per shared K/V row
  static constexpr int kPStride = kTile + 1;                 // floats per shared P row
  static constexpr int kElems = 4;                           // floats per 16-byte load
  static constexpr int kVecsPerThread = (kTile * kDh / kElems + kThreads - 1) / kThreads;
  static constexpr int kGScore = (kG + kWarps - 1) / kWarps;  // heads per warp, score phase
  // P.V: 4-column groups of the bucket's row (the bucket is a power of two,
  // so they divide the CTA); columns past Dh are computed and never stored.
  static constexpr int kCols = kDh / 4;
  static constexpr int kPvGroups = kThreads / kCols;          // head groups, P.V phase
  static constexpr int kGPv = (kG + kPvGroups - 1) / kPvGroups;  // heads per thread, P.V
  static_assert(kThreads % kCols == 0, "4-column groups divide the CTA");
  static int smem_bytes(int hc) {  // hc: heads per CTA
    return static_cast<int>(sizeof(float)) *
           (hc * kDh + 2 * kTile * kStride + hc * kPStride + 2 * hc);
  }
};

// One CTA per (split, KV head x head block, lane), heads g_lo .. g_lo + n_h - 1
// with n_h <= hc = min(G, kG).
template <int kDh, int kG>
__global__ void __launch_bounds__(kThreads)
gqa_decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ lengths,
                        float* __restrict__ out, float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int* __restrict__ counters, int n_s,
                        int n_kv, int n_g, int n_dh, int rows_per_split, float scale) {
  using Sh = SimtShape<kDh, kG>;
  extern __shared__ __align__(16) float smemf[];
  const int hc = min(n_g, kG), n_hb = (n_g + kG - 1) / kG;
  float* q_s = smemf;                             // (hc, kDh)
  float* k_s = q_s + hc * kDh;                    // (kTile, kStride)
  float* v_s = k_s + kTile * Sh::kStride;         // (kTile, kStride)
  float* p_s = v_s + kTile * Sh::kStride;         // (hc, kPStride)
  float* ml_s = p_s + hc * Sh::kPStride;          // (hc, 2): corr per tile, then (m, l)

  const int split = blockIdx.x, h = blockIdx.y / n_hb, hb = blockIdx.y % n_hb, b = blockIdx.z;
  const int g_lo = hb * kG, n_h = min(kG, n_g - g_lo);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], n_s);
  const int row0 = split * rows_per_split;
  const int row_end = min(row0 + rows_per_split, len);
  const int64_t bh = static_cast<int64_t>(b) * n_kv + h;

  // Row r of this (lane, head) starts at ((b * S + r) * Hkv + h) * Dh.
  const int64_t row_stride = static_cast<int64_t>(n_kv) * n_dh;
  const int64_t kv_off = (static_cast<int64_t>(b) * n_s * n_kv + h) * n_dh;
  const float* k_bh = k + kv_off;
  const float* v_bh = v + kv_off;
  const int n_vec = n_dh / Sh::kElems;  // 16-byte pieces of a row

  float4 kreg[Sh::kVecsPerThread], vreg[Sh::kVecsPerThread];
  auto load_tile = [&](int t0) {  // rows at or past row_end load as zeros
#pragma unroll
    for (int j = 0; j < Sh::kVecsPerThread; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / n_vec, c = (i % n_vec) * Sh::kElems;
      kreg[j] = vreg[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < kTile && t0 + r < row_end) {
        const int64_t off = (t0 + r) * row_stride + c;
        kreg[j] = *reinterpret_cast<const float4*>(k_bh + off);
        vreg[j] = *reinterpret_cast<const float4*>(v_bh + off);
      }
    }
  };
  auto store_tile = [&]() {  // registers -> shared rows
#pragma unroll
    for (int j = 0; j < Sh::kVecsPerThread; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / n_vec, c = (i % n_vec) * Sh::kElems;
      if (r < kTile) {
        *reinterpret_cast<float4*>(k_s + r * Sh::kStride + c) = kreg[j];
        *reinterpret_cast<float4*>(v_s + r * Sh::kStride + c) = vreg[j];
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

  if (row0 < row_end) load_tile(row0);
  const float* q_bh = q + (bh * n_g + g_lo) * n_dh;  // while the first tile is in flight
  for (int i = tid; i < n_h * n_dh; i += kThreads) q_s[(i / n_dh) * kDh + i % n_dh] = q_bh[i];
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
    for (int c = 0; c < n_dh; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int i = 0; i < Sh::kGScore; ++i) {
        const int g = warp + i * kWarps;
        if (g < n_h) {
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
      if (g < n_h) {
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
      if (g < n_h) {
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
        if (g < n_h) {
          const float p = p_s[g * Sh::kPStride + r];
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
    }
  }

  __syncthreads();  // the last tile's reads are done: k_s holds the result next
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < Sh::kGScore; ++i) {
      const int g = warp + i * kWarps;
      if (g < n_h) {
        ml_s[2 * g] = m[i];
        ml_s[2 * g + 1] = l[i];
      }
    }
  }
  float* res_acc = k_s;  // (n_h, n_dh): at most kG * kDh floats, inside k_s and v_s
#pragma unroll
  for (int i = 0; i < Sh::kGPv; ++i) {
    const int g = grp + i * Sh::kPvGroups;
    if (g < n_h && 4 * col < n_dh) {
      *reinterpret_cast<float4*>(res_acc + g * n_dh + 4 * col) = acc[i];
    }
  }
  __syncthreads();
  finish<float>(ml_s, res_acc, n_h, g_lo, n_dh, n_g, bh, out + (bh * n_g + g_lo) * n_dh,
                part_ml, part_acc, counters + (static_cast<int64_t>(b) * gridDim.y + blockIdx.y));
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* out;
  float *part_ml, *part_acc;
  int* counters;
  int n_b, n_s, n_kv, n_g, n_dh, n_split, rows_per_split;
  cudaStream_t stream;
};

// What gqa_decode_info reports of an instance, in this order.
enum Info { kSmem, kCtasPerSm, kStagesInfo, kTileRows, kRegs, kHeadsPerCta };

// Launches `kernel` on grid (n_split, n_kv * head blocks, n_b) with `smem`
// bytes (`max_smem` for the instance's largest operands, set once per
// instance through `smem_set`); with `info` it launches nothing and fills
// info[kSmem], info[kCtasPerSm], info[kRegs] and info[kHeadsPerCta] instead.
template <typename T, typename K>
int launch_kernel(K kernel, bool& smem_set, const Args& a, int* info, int smem, int max_smem,
                  int heads_per_cta) {
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  if (info != nullptr) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    info[kSmem] = smem;
    info[kRegs] = attr.numRegs;
    info[kHeadsPerCta] = heads_per_cta;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[kCtasPerSm], kernel, kThreads, smem));
  }
  const int n_hb = (a.n_g + heads_per_cta - 1) / heads_per_cta;
  const float scale = 1.0f / sqrtf(static_cast<float>(a.n_dh));
  const dim3 grid(a.n_split, a.n_kv * n_hb, a.n_b);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.lengths, static_cast<T*>(a.out), a.part_ml, a.part_acc, a.counters, a.n_s, a.n_kv, a.n_g,
      a.n_dh, a.rows_per_split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kDh, int kMB>
int launch_mma(const Args& a, int* info) {
  using Sh = MmaShape<kDh, kMB>;
  static bool smem_set = false;
  if (info != nullptr) {
    info[kStagesInfo] = Sh::kStages;
    info[kTileRows] = kMmaRows;
  }
  return launch_kernel<bf16>(gqa_decode_mma_kernel<kDh, kMB>, smem_set, a, info,
                             Sh::smem_bytes(a.n_dh), Sh::smem_bytes(kDh), 16 * kMB);
}

template <int kDh>
int launch_mma_g(const Args& a, int* info) {
  if (a.n_g <= 16) return launch_mma<kDh, 1>(a, info);
  if (a.n_g <= 32) return launch_mma<kDh, 2>(a, info);
  return launch_mma<kDh, 4>(a, info);
}

template <int kDh, int kG>
int launch_simt(const Args& a, int* info) {
  using Sh = SimtShape<kDh, kG>;
  static bool smem_set = false;
  if (info != nullptr) {
    info[kStagesInfo] = 2;  // one tile in shared memory, the next in registers
    info[kTileRows] = kTile;
  }
  const int hc = a.n_g < kG ? a.n_g : kG;
  return launch_kernel<float>(gqa_decode_split_kernel<kDh, kG>, smem_set, a, info,
                              Sh::smem_bytes(hc), Sh::smem_bytes(kG), kG);
}

template <int kDh>
int launch_simt_g(const Args& a, int* info) {
  if (a.n_g <= 4) return launch_simt<kDh, 4>(a, info);
  if (a.n_g <= 8) return launch_simt<kDh, 8>(a, info);
  return launch_simt<kDh, 32>(a, info);
}

int dispatch(int dtype, const Args& a, int* info) {
  if (a.n_g < 1) return -1;
  if (dtype != 0 && dtype != 1) return -2;
  if (a.n_dh < 8 || a.n_dh > kMaxDh || a.n_dh % 8 != 0) return -3;
  if (dtype == 1) {  // bf16 buckets: <= 64, <= 128, <= 256
    if (a.n_dh <= 64) return launch_mma_g<64>(a, info);
    if (a.n_dh <= 128) return launch_mma_g<128>(a, info);
    return launch_mma_g<256>(a, info);
  }
  if (a.n_dh <= 32) return launch_simt_g<32>(a, info);
  if (a.n_dh <= 64) return launch_simt_g<64>(a, info);
  if (a.n_dh <= 128) return launch_simt_g<128>(a, info);
  return launch_simt_g<256>(a, info);
}

}  // namespace

extern "C" {

// q (B, Hkv * G, Dh), k and v (B, S, Hkv, Dh), out like q: contiguous,
// 16-byte aligned, one dtype (0 = float32, 1 = bfloat16). lengths (B,) int32
// on the device. part_ml (B, Hkv, n_split, G, 2) and part_acc
// (B, Hkv, n_split, G, Dh) fp32 scratch and counters (B * Hkv * head blocks)
// int32, zero before the first call and left zero by each, all unused when
// n_split == 1.
int gqa_decode_launch(int dtype, const void* q, const void* k, const void* v,
                      const void* lengths, void* out, void* part_ml, void* part_acc,
                      void* counters, int n_b, int n_s, int n_kv, int n_g, int n_dh, int n_split,
                      int rows_per_split, void* stream) {
  if (n_b < 1 || n_s < 1 || n_kv < 1 || n_split < 1 || rows_per_split < 1 ||
      static_cast<int64_t>(n_split) * rows_per_split < n_s) {
    return -1;
  }
  if (n_split > 1 && (part_ml == nullptr || counters == nullptr)) return -1;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) ||
      !aligned16(part_acc)) {
    return -4;
  }
  const Args a{q, k, v, static_cast<const int*>(lengths), out, static_cast<float*>(part_ml),
               static_cast<float*>(part_acc), static_cast<int*>(counters), n_b, n_s, n_kv, n_g,
               n_dh, n_split, rows_per_split, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, a, nullptr);
}

// The instance for this dtype, head dim and group: info[0] dynamic shared
// memory per CTA (bytes), info[1] resident CTAs per SM, info[2] tiles in
// flight per CTA, info[3] cache rows per tile, info[4] registers per thread,
// info[5] query heads per CTA (a larger group takes a grid axis of head
// blocks).
int gqa_decode_info(int dtype, int n_dh, int n_g, int* info) {
  Args a{};
  a.n_g = n_g;
  a.n_dh = n_dh;
  return dispatch(dtype, a, info);
}

}  // extern "C"
