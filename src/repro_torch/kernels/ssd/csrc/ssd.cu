// Chunked Mamba-2 SSD (state-space duality) for Hopper (sm_90a), plain C
// interface.
//
// Replaces src/repro/kernels/ssd/ssd.py::ssd_pallas (B4; body _ssd_kernel)
// together with the operand preparation of its wrapper
// src/repro/kernels/ssd/ops.py::ssd. For every lane b and head h, with group
// g = h / (H / G), the recurrence over t < S on an (N, P) fp32 state is
//   S_t[n, p] = exp(A_h dt_t) S_{t-1}[n, p] + B_t[g, n] dt_t x_t[h, p]
//   y_t[h, p] = sum_n C_t[g, n] S_t[n, p] + D_h x_t[h, p]
// from S_{-1} = s0 (or zero). The kernel reads the model-side layout as it
// is: x (B, S, H, P) in the compute dtype, dt (B, S, H) fp32, A and D (H,)
// fp32, B and C (B, S, G, N) in their own dtype, each with its own strides
// and a unit stride on its last axis. The fold x * dt, the log-decay A * dt,
// the group index, the D skip and the cast of y happen inside, so the four
// fp32 transposed copies JAX's ops.py makes are not made. All arithmetic is
// fp32; y is stored in x's dtype (round to nearest), the final state (B, H,
// N, P) in fp32. The state may be written over s0 in place: each CTA reads
// its own block of s0 before it writes that block.
//
// Design. On the TPU one program per (b, h) walked the chunks in grid order
// with the state in VMEM scratch, on fp32 tiles of about 200 KB at L = N =
// 128. Blocks on Hopper run in parallel and in no order, and one CTA has at
// most 227 KB of shared memory, so:
//   ssd_chunk_kernel (S > 1): one CTA of 256 threads per (P slice of 64
//     columns, head, lane) walks the sequence in chunks of kL = 64 steps
//     with its (N, 64) slice of the state in shared memory. Column p of y
//     and of the state depends only on column p of x, so the P slices are
//     independent. Per chunk, with lambda_t the in-chunk cumsum of A dt
//     (a warp scan):
//       1. C, B (kL, N) into shared memory as they are (bf16 or fp32), and
//          xdt (kL, 64) in fp32; steps past S (the ragged last chunk) are
//          zero, and dt there is zero, so lambda stays flat and they add
//          nothing;
//       2. M[t, s] = (C_t . B_s) exp(lambda_t - lambda_s) for s <= t, in
//          4x4 register blocks over the lower triangle only; the mask is
//          applied before the exp (above the diagonal the exponent is
//          positive and could overflow to inf, and inf * 0 is NaN);
//       3. y = exp(lambda_t) (C @ S_prev) + M @ xdt (+ D x), 4x4 register
//          blocks, stored;
//       4. S = exp(lambda_T) S + B^T @ (exp(lambda_T - lambda_s) xdt), each
//          thread its own 4x4 blocks.
//     The decays scale the fp32 products, not the C and B tiles, so these
//     stay in their input type: at N = 128 with bf16 C and B the CTA takes
//     104 KB of shared memory and two CTAs share an SM (fp32 C and B: 137
//     KB, one), so mamba2's 80 heads x 4 lanes run as 320 CTAs in about
//     1.2 rounds. The chunk is this kernel's tiling: it changes no value,
//     only the order of fp32 sums.
//   ssd_step_kernel (S == 1, decode): one CTA per (head, lane); thread
//     (r, p) updates rows n = r, r + R, .. of column p of the state
//     (R = 256 / P), accumulates its part of C . S_new, and the parts of a
//     column are summed in a fixed order through shared memory. With one
//     step y = C . S_new + D x is exactly the chunked formula at L = 1.
// No atomics: every output is summed in a fixed order. expf (not __expf),
// no fast-math flags.
//
// Bound. Prefill is bound by operations: per (b, h) chunk of L steps the
// lower triangle of C B^T (L(L+1)/2 N), of M @ xdt (L(L+1)/2 P), and
// C @ S and B^T @ xdt (2 L N P) multiply-adds; at the prompt-1024 serve
// shape (B = 4, H = 80, P = 64, N = 128) that is 15.0 GFLOP against about
// 98 MB. Decode is bound by bytes: the (N, P) fp32 state of every (b, h) is
// read and written once, 21 MB at B = 4 (6.3 us at 3.35 TB/s). This first
// version multiplies in fp32 on the CUDA cores; tensor cores, one C B^T per
// group instead of per head, and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (see repro_torch/kernels/build.py). ssd_launch returns cudaGetLastError()
// after the launch, or a negative code for arguments it refuses; ssd_info
// reports the chunk kernel's shared memory and occupancy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads per CTA, both kernels
constexpr int kL = 64;         // time steps per chunk (chunk kernel)
constexpr int kPS = 64;        // state columns per CTA (chunk kernel)
constexpr int kRsP = kPS + 4;  // row stride of the xdt and state tiles (floats)
constexpr int kRsL = kL + 4;   // row stride of the score tile
constexpr int kMaxN = 128;     // state size N the kernels take
constexpr int kMaxP = kThreads;  // head dim P the step kernel takes

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Args {
  const void* x;      // (B, S, H, P) TX
  const float* dt;    // (B, S, H)
  const float* A;     // (H,)
  const void* B;      // (B, S, G, N) TB
  const void* C;      // (B, S, G, N) TB
  const float* D;     // (H,) or null
  const float* s0;    // (B, H, N, P) contiguous, or null for zero
  void* y;            // (B, S, H, P) TX contiguous
  float* state;       // (B, H, N, P) contiguous
  int n_b, n_s, n_h, n_g, n_p, n_n;
  // element strides of (batch, step, head or group); the last axis is unit
  long long sx[3], sdt[3], sb[3], sc[3];
  cudaStream_t stream;
};

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Shared memory of the chunk kernel for state size n: C and B in their own
// type TB, then fp32 xdt, state, scores, lambda and its two exponentials,
// exp(lambda_T).
template <typename TB>
__host__ __device__ __forceinline__ size_t chunk_smem_bytes(int n) {
  const int rs_n = round4(n) + 4;
  return sizeof(TB) * static_cast<size_t>(2 * kL * rs_n) +
         sizeof(float) * (static_cast<size_t>(kL * kRsP) + round4(n) * kRsP + kL * kRsL +
                          3 * kL + 4);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four bf16 (8-byte aligned) widened to fp32.
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// acc[i][j] += sum_k a[i].k * b[k].j for 4x4 blocks: a rows i, b rows k.
__device__ __forceinline__ void mac4x4(float (&acc)[4][4], const float4 (&a)[4],
                                       const float4 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ai[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[i][0] = fmaf(ai[k], b[k].x, acc[i][0]);
      acc[i][1] = fmaf(ai[k], b[k].y, acc[i][1]);
      acc[i][2] = fmaf(ai[k], b[k].z, acc[i][2]);
      acc[i][3] = fmaf(ai[k], b[k].w, acc[i][3]);
    }
  }
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_kernel(const Args a) {
  const int p0 = blockIdx.x * kPS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.n_h / a.n_g);
  const int tid = threadIdx.x;
  const int N = a.n_n, P = a.n_p;
  const int Np = round4(N), rs_n = Np + 4;

  extern __shared__ float4 smem4[];
  TB* Cs = reinterpret_cast<TB*>(smem4);         // (kL, rs_n) as read
  TB* Bs = Cs + kL * rs_n;                       // (kL, rs_n) as read
  float* Xs = reinterpret_cast<float*>(Bs + kL * rs_n);  // (kL, kRsP) xdt
  float* Ss = Xs + kL * kRsP;                    // (Np, kRsP) state slice
  float* Ms = Ss + Np * kRsP;                    // (kL, kRsL) scores
  float* lam = Ms + kL * kRsL;                   // (kL,) lambda_t
  float* e_lam = lam + kL;                       // exp(lambda_t)
  float* e_end = e_lam + kL;                     // exp(lambda_T - lambda_t)
  float* e_last = e_end + kL;                    // exp(lambda_T)

  const TX* x = static_cast<const TX*>(a.x) + b * a.sx[0] + h * a.sx[2];
  const float* dt = a.dt + b * a.sdt[0] + h * a.sdt[2];
  const TB* Bg = static_cast<const TB*>(a.B) + b * a.sb[0] + g * a.sb[2];
  const TB* Cg = static_cast<const TB*>(a.C) + b * a.sc[0] + g * a.sc[2];
  const float A_h = a.A[h];
  const long long state_base = (static_cast<long long>(b) * a.n_h + h) * N * P;

  for (int i = tid; i < Np * kPS; i += kThreads) {
    const int n = i / kPS, p = i % kPS;
    float v = 0.f;
    if (a.s0 != nullptr && n < N && p0 + p < P) v = a.s0[state_base + n * P + p0 + p];
    Ss[n * kRsP + p] = v;
  }

  for (int t0 = 0; t0 < a.n_s; t0 += kL) {
    const int nv = min(kL, a.n_s - t0);  // valid steps in this chunk

    // 1. lambda (warp 0, two steps a lane), and the C, B, xdt tiles.
    //    lambda_T is lambda at the last valid step itself, not the scan's
    //    total, which sums the same terms in another order: the two must
    //    be equal for exp(lambda_T - lambda_t) to be 1 at t = T.
    if (tid < 32) {
      const int t = 2 * tid;
      const float d0 = t < nv ? dt[(t0 + t) * a.sdt[1]] : 0.f;
      const float d1 = t + 1 < nv ? dt[(t0 + t + 1) * a.sdt[1]] : 0.f;
      const float l0 = A_h * d0, l1 = A_h * d1;
      const float pair = l0 + l1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float excl = incl - pair;
      const float lam0 = excl + l0, lam1 = excl + l0 + l1;
      const int last = nv - 1;
      const float lam_T = __shfl_sync(0xffffffffu, (last & 1) ? lam1 : lam0, last >> 1);
      if (tid == 0) e_last[0] = expf(lam_T);
      lam[t] = lam0;
      lam[t + 1] = lam1;
      e_lam[t] = expf(lam0);
      e_lam[t + 1] = expf(lam1);
      e_end[t] = expf(lam_T - lam0);
      e_end[t + 1] = expf(lam_T - lam1);
    }
    const TB zero = from_f<TB>(0.f);
    for (int i = tid; i < kL * Np; i += kThreads) {
      const int t = i / Np, n = i % Np;
      const bool ok = t < nv && n < N;
      Cs[t * rs_n + n] = ok ? Cg[(t0 + t) * a.sc[1] + n] : zero;
      Bs[t * rs_n + n] = ok ? Bg[(t0 + t) * a.sb[1] + n] : zero;
    }
    for (int i = tid; i < kL * kPS; i += kThreads) {
      const int t = i / kPS, p = i % kPS;
      float v = 0.f;
      if (t < nv && p0 + p < P) {
        v = to_f(x[(t0 + t) * a.sx[1] + p0 + p]) * dt[(t0 + t) * a.sdt[1]];
      }
      Xs[t * kRsP + p] = v;
    }
    __syncthreads();

    // 2. Scores on the lower triangle of 4x4 blocks (tb, sb), sb <= tb.
    constexpr int kBlocks = kL / 4;
    if (tid < kBlocks * (kBlocks + 1) / 2) {
      int tb = 0;
      while ((tb + 1) * (tb + 2) / 2 <= tid) ++tb;
      const int sb = tid - tb * (tb + 1) / 2;
      if (4 * tb < nv && 4 * sb < nv) {
        float acc[4][4] = {};
        for (int n = 0; n < Np; n += 4) {
          float4 c[4], bt[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            c[i] = ld4(Cs + (4 * tb + i) * rs_n + n);
            bt[i] = ld4(Bs + (4 * sb + i) * rs_n + n);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float v = acc[i][j];
              v = fmaf(c[i].x, bt[j].x, v);
              v = fmaf(c[i].y, bt[j].y, v);
              v = fmaf(c[i].z, bt[j].z, v);
              v = fmaf(c[i].w, bt[j].w, v);
              acc[i][j] = v;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * tb + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = 4 * sb + j;
            Ms[t * kRsL + s] = s <= t ? acc[i][j] * expf(lam[t] - lam[s]) : 0.f;
          }
        }
      }
    }
    __syncthreads();

    const float e_total = e_last[0];

    // 3. y = exp(lambda_t) (C @ S_prev) + M @ xdt (+ D x): thread (tb, pb)
    //    owns rows 4 tb.., columns 4 pb.. of the chunk's output.
    {
      const int tb = tid / (kPS / 4), pb = tid % (kPS / 4);
      if (4 * tb < nv) {
        float acc[4][4] = {};
        for (int n = 0; n < Np; n += 4) {
          float4 c[4], sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            c[i] = ld4(Cs + (4 * tb + i) * rs_n + n);
            sv[i] = ld4(Ss + (n + i) * kRsP + 4 * pb);
          }
          mac4x4(acc, c, sv);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = e_lam[4 * tb + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] *= e;
        }
        for (int s = 0; s <= 4 * tb && s < nv; s += 4) {
          float4 m[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            m[i] = ld4(Ms + (4 * tb + i) * kRsL + s);
            xv[i] = ld4(Xs + (s + i) * kRsP + 4 * pb);
          }
          mac4x4(acc, m, xv);
        }
        const float D_h = a.D != nullptr ? a.D[h] : 0.f;
        TX* y = static_cast<TX*>(a.y);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * tb + i;
          if (t >= nv) continue;
          const long long row = ((static_cast<long long>(b) * a.n_s + t0 + t) * a.n_h + h) * P;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = p0 + 4 * pb + j;
            if (p >= P) continue;
            float v = acc[i][j];
            if (a.D != nullptr) v += to_f(x[(t0 + t) * a.sx[1] + p]) * D_h;
            y[row + p] = from_f<TX>(v);
          }
        }
      }
    }
    __syncthreads();

    // 4. S = exp(lambda_T) S + B^T @ (exp(lambda_T - lambda_s) xdt): thread
    //    blocks (nb, pb) of 4x4.
    for (int blk = tid; blk < (Np / 4) * (kPS / 4); blk += kThreads) {
      const int nb = blk / (kPS / 4), pb = blk % (kPS / 4);
      float acc[4][4] = {};
      for (int s = 0; s < nv; s += 4) {
        float4 bv[4], xv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bv[k] = ld4(Bs + (s + k) * rs_n + 4 * nb);
          const float4 v = ld4(Xs + (s + k) * kRsP + 4 * pb);
          const float e = e_end[s + k];
          xv[k] = make_float4(v.x * e, v.y * e, v.z * e, v.w * e);
        }
        // acc[i][j] += sum_k B[s + k][4 nb + i] * xdt[s + k][4 pb + j]
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float bk[4] = {bv[k].x, bv[k].y, bv[k].z, bv[k].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(bk[i], xv[k].x, acc[i][0]);
            acc[i][1] = fmaf(bk[i], xv[k].y, acc[i][1]);
            acc[i][2] = fmaf(bk[i], xv[k].z, acc[i][2]);
            acc[i][3] = fmaf(bk[i], xv[k].w, acc[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* row = Ss + (4 * nb + i) * kRsP + 4 * pb;
#pragma unroll
        for (int j = 0; j < 4; ++j) row[j] = e_total * row[j] + acc[i][j];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < N * kPS; i += kThreads) {
    const int n = i / kPS, p = i % kPS;
    if (p0 + p < P) a.state[state_base + n * P + p0 + p] = Ss[n * kRsP + p];
  }
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads) ssd_step_kernel(const Args a) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (a.n_h / a.n_g);
  const int tid = threadIdx.x;
  const int N = a.n_n, P = a.n_p;
  const int R = kThreads / P;  // state rows per pass

  __shared__ float Bsh[kMaxN], Csh[kMaxN];
  __shared__ float part[kThreads];

  const TB* Bg = static_cast<const TB*>(a.B) + b * a.sb[0] + g * a.sb[2];
  const TB* Cg = static_cast<const TB*>(a.C) + b * a.sc[0] + g * a.sc[2];
  for (int n = tid; n < N; n += kThreads) {
    Bsh[n] = to_f(Bg[n]);
    Csh[n] = to_f(Cg[n]);
  }
  const float dt = a.dt[b * a.sdt[0] + h * a.sdt[2]];
  const float decay = expf(a.A[h] * dt);
  const TX* x = static_cast<const TX*>(a.x) + b * a.sx[0] + h * a.sx[2];
  __syncthreads();

  const int p = tid % P, r = tid / P;
  float acc = 0.f;
  if (r < R) {
    const float xdt = to_f(x[p]) * dt;
    const long long base = (static_cast<long long>(b) * a.n_h + h) * N * P + p;
#pragma unroll 4
    for (int n = r; n < N; n += R) {
      const float s_prev = a.s0 != nullptr ? a.s0[base + static_cast<long long>(n) * P] : 0.f;
      const float s = fmaf(decay, s_prev, Bsh[n] * xdt);
      a.state[base + static_cast<long long>(n) * P] = s;
      acc = fmaf(Csh[n], s, acc);
    }
  }
  part[tid] = acc;
  __syncthreads();
  if (tid < P) {
    float v = 0.f;
    for (int rr = 0; rr < R; ++rr) v += part[rr * P + tid];
    if (a.D != nullptr) v += to_f(x[tid]) * a.D[h];
    TX* y = static_cast<TX*>(a.y);
    y[(static_cast<long long>(b) * a.n_h + h) * P + tid] = from_f<TX>(v);
  }
}

template <typename TX, typename TB>
int launch(const Args& a, int* info) {
  const size_t smem = chunk_smem_bytes<TB>(a.n_n);
  auto chunk = ssd_chunk_kernel<TX, TB>;
  cudaError_t err = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(chunk_smem_bytes<TB>(kMaxN)));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info != nullptr) {
    info[0] = static_cast<int>(smem);
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], chunk, kThreads, smem));
  }
  if (a.n_s == 1) {
    ssd_step_kernel<TX, TB><<<dim3(a.n_h, a.n_b), kThreads, 0, a.stream>>>(a);
  } else {
    const dim3 grid((a.n_p + kPS - 1) / kPS, a.n_h, a.n_b);
    chunk<<<grid, kThreads, smem, a.stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype codes: 0 = float32, 1 = bfloat16.
int dispatch(int x_dtype, int bc_dtype, const Args& a, int* info) {
  if (x_dtype == 0 && bc_dtype == 0) return launch<float, float>(a, info);
  if (x_dtype == 1 && bc_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, info);
  if (x_dtype == 1 && bc_dtype == 0) return launch<__nv_bfloat16, float>(a, info);
  if (x_dtype == 0 && bc_dtype == 1) return launch<float, __nv_bfloat16>(a, info);
  return -2;
}

}  // namespace

extern "C" {

// x (B, S, H, P) and y in x_dtype, B and C (B, S, G, N) in bc_dtype; dt
// (B, S, H), A (H,) and D (H,) fp32 (D may be null); s0 (may be null) and
// state (B, H, N, P) fp32 contiguous (state may be s0). y is contiguous.
// strides: 12 element strides, (batch, step, head) of x and dt, (batch,
// step, group) of B and C; every last axis has unit stride. S == 1 runs the
// step kernel, S > 1 the chunk kernel.
int ssd_launch(int x_dtype, int bc_dtype, const void* x, const void* dt, const void* A,
               const void* B, const void* C, const void* D, const void* s0, void* y,
               void* state, int n_b, int n_s, int n_h, int n_g, int n_p, int n_n,
               const long long* strides, void* stream) {
  if (n_b < 1 || n_s < 1 || n_h < 1 || n_g < 1 || n_p < 1 || n_n < 1 || n_h % n_g != 0) {
    return -1;
  }
  if (n_n > kMaxN || n_p > kMaxP) return -3;
  if (x == nullptr || dt == nullptr || A == nullptr || B == nullptr || C == nullptr ||
      y == nullptr || state == nullptr || strides == nullptr) {
    return -4;
  }
  Args a{};
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.B = B;
  a.C = C;
  a.D = static_cast<const float*>(D);
  a.s0 = static_cast<const float*>(s0);
  a.y = y;
  a.state = static_cast<float*>(state);
  a.n_b = n_b;
  a.n_s = n_s;
  a.n_h = n_h;
  a.n_g = n_g;
  a.n_p = n_p;
  a.n_n = n_n;
  for (int i = 0; i < 3; ++i) {
    a.sx[i] = strides[i];
    a.sdt[i] = strides[3 + i];
    a.sb[i] = strides[6 + i];
    a.sc[i] = strides[9 + i];
  }
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(x_dtype, bc_dtype, a, nullptr);
}

// The chunk kernel's dynamic shared memory per CTA (info[0], bytes) and
// resident CTAs per SM (info[1]) at state size n_n.
int ssd_info(int x_dtype, int bc_dtype, int n_n, int* info) {
  if (n_n < 1 || n_n > kMaxN) return -3;
  Args a{};
  a.n_n = n_n;
  return dispatch(x_dtype, bc_dtype, a, info);
}

}  // extern "C"
