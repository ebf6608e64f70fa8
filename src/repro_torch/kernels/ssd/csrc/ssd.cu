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
// the group index, the D skip and the cast of y happen inside. y is stored
// in x's dtype (round to nearest), the final state (B, H, N, P) in fp32. The
// state may be written over s0 in place: each CTA reads its own block of s0
// before it writes that block.
//
// Design. On the TPU one program per (b, h) walked the chunks in grid order
// with the state in VMEM scratch. Blocks on Hopper run in parallel and in no
// order, so every chunk kernel here is one CTA that walks its chunks of
// kL = 64 steps in order with its slice of the state on chip; the state
// never goes through device memory between chunks. Per chunk, with lambda_t
// the in-chunk cumsum of A dt (a warp scan) and lambda_T its value at the
// last valid step:
//   y = exp(lambda_t) (C @ S_prev) + tril((C B^T) o exp(lambda_t - lambda_s)) @ xdt (+ D x)
//   S = exp(lambda_T) S_prev + B^T @ (exp(lambda_T - lambda_s) xdt)
// Steps past S (the ragged last chunk) are zero, and dt there is zero, so
// lambda stays flat and they add nothing. The mask is applied before the
// exp: above the diagonal the exponent is positive and could overflow to
// inf, and inf * 0 is NaN.
//
//   ssd_chunk_mma_kernel (S > 1, bf16 x and bf16 B, C: the mamba2 serve
//     path). One CTA of 16 warps per (P slice of kTP = 32 columns, block of
//     up to kMaxHB = 5 heads of one group, lane). The four products run on
//     the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate,
//     fragments by ldmatrix), each with one operand that is exact in bf16
//     and the other, where it is fp32, split as hi + lo (two bf16 terms,
//     about 16 mantissa bits; tests/test_torch_ssd.py emulates the scheme
//     against JAX's ssd_ref at S = 1024 and shows one bf16 term out of
//     tolerance):
//       1. C B^T (64 x 64 x 128, both exact), once per chunk for all the
//          CTA's heads, kept in registers over the lower triangle;
//       2. per head, the scores times xdt as (M o dt_s) @ x: the masked,
//          decayed score tile scaled by dt_s in fp32, split, times x (exact);
//       3. C @ S_prev: C exact, S split into two bf16 planes in shared memory;
//       4. the state update as B^T @ (w o x), w_s = exp(lambda_T - lambda_s)
//          dt_s: B^T exact (ldmatrix.trans), the (64 x 32) scaled x split.
//     Scaling x rather than B splits a 64 x 32 tile instead of a 64 x 128
//     one. The hi and lo products of 3, 4 and the score product go to
//     separate accumulators, which halves their dependency chains. The
//     state slice (N = 128 rows, zero-padded, x 32 columns per head) stays
//     in registers as the fp32 accumulator of product 4, scaled by
//     exp(lambda_T) each chunk; s0 comes in and the final state goes out
//     through shared memory in 16-byte rows. The next chunk's C, B, x and dt
//     are in flight (cp.async into a second buffer) while a chunk computes;
//     operands that are not 16-byte aligned are copied element by element
//     instead. The heads per CTA come from the wrapper's plan
//     (ssd.py::chunk_plan): at the mamba2 shape (B = 4, H = 80, P = 64,
//     G = 1) five heads per CTA and two P slices give 4 x 16 x 2 = 128 CTAs
//     of 176 KB of shared memory and at most 128 registers a thread, one
//     per SM, so the 320 (lane, head) pairs run in one round on 128 of the
//     132 SMs; C B^T is computed 32 times per (lane, chunk) instead of 80.
//     The kernel is latency-bound, not bound by the tensor cores: two
//     barriers per head, and the planes, the y epilogue and its 4-byte
//     global stores take most of a chunk.
//   ssd_chunk_kernel (S > 1, the other dtype instances: fp32 x or fp32 B,
//     C, as the fp32 parity runs and the small fp32 cases use). The first
//     port's CUDA-core design, kept as it was: one CTA of 256 threads per
//     (P slice of 64, head, lane), fp32 4x4 register blocks, the state slice
//     in shared memory, C and B in their own type.
//   ssd_step_vec_kernel (S == 1, decode; P % 4 == 0 and 16-byte aligned
//     states). One CTA per (head, lane); thread (r, c) holds columns 4c..4c+3
//     of rows r, r + R, ... (R = 256 / (P / 4)): it starts all of its 16-byte
//     state loads (eight at the mamba2 shape, 128 bytes) before the first
//     use, writes the new state with 16-byte stores, and accumulates its part
//     of C . S_new; the parts of a column are summed in a fixed order through
//     shared memory. ssd_step_kernel is the same with 4-byte accesses, for
//     the shapes the vector form does not take.
// No atomics: every output is summed in a fixed order. expf (not __expf),
// no fast-math flags.
//
// Bound. At the prompt-1024 serve shape (B = 4, H = 80, P = 64, N = 128)
// the chunked algorithm is 15.0 GFLOP against about 98 MB moved: 29.2 us of
// bytes at 3.35 TB/s, 15 us of bf16 tensor-core work at 989 TFLOP/s (221 us
// at the fp32 CUDA-core rate, which the first design was held to). With the
// two-term split the tensor cores do about twice the mma work of the plain
// algorithm. Decode is bound by bytes: the (N, P) fp32 state of every
// (b, h) read and written once, 21 MB at B = 4 (6.3 us).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (see repro_torch/kernels/build.py). ssd_launch returns cudaGetLastError()
// after the launch, or a negative code for arguments it refuses; ssd_info
// reports the chunk kernel instance's resources.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads per CTA, the fp32 chunk and the step kernels
constexpr int kL = 64;         // time steps per chunk (chunk kernels)
constexpr int kPS = 64;        // state columns per CTA (fp32 chunk kernel)
constexpr int kRsP = kPS + 4;  // row stride of the xdt and state tiles (floats)
constexpr int kRsL = kL + 4;   // row stride of the score tile
constexpr int kMaxN = 128;     // state size N the kernels take
constexpr int kMaxP = kThreads;  // head dim P the step kernels take
// mma chunk kernel
constexpr int kTP = 32;          // state columns per CTA
constexpr int kMmaThreads = 512;  // threads per CTA
constexpr int kMaxHB = 5;        // heads per CTA
constexpr int kRsCB = kMaxN + 8;  // bf16 row stride of the C and B tiles (272 bytes)
constexpr int kRsX = kTP + 8;     // x, scaled-x and state-plane tiles (80 bytes)
constexpr int kRsM = kL + 8;      // score planes (144 bytes)
constexpr int kRsF = kTP + 8;     // fp32 state tile staged through shared memory
// The three bf16 strides are odd multiples of 16 bytes, so the eight rows an
// ldmatrix reads fall on distinct banks.
constexpr int kStepRows = 8;     // 16-byte state loads a thread has in flight (step kernel)

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
  int heads_per_cta;  // mma chunk kernel
  bool vec;           // x, B, C rows copy in 16-byte pieces (mma chunk kernel)
  cudaStream_t stream;
};

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Shared memory of the fp32 chunk kernel for state size n: C and B in their
// own type TB, then fp32 xdt, state, scores, lambda and its two
// exponentials, exp(lambda_T).
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

// ---------------------------------------------------------------------------
// The mma chunk kernel (bf16 x, bf16 B and C)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

struct alignas(16) MmaSmem {
  bf16 C[2][kL][kRsCB];           // chunk c and c + 1, as read (N zero-padded to 128)
  bf16 B[2][kL][kRsCB];
  bf16 X[2][kMaxHB][kL][kRsX];    // x of each head, this CTA's 32 columns
  float dt[2][kMaxHB][kL];
  bf16 Mh[kL][kRsM], Ml[kL][kRsM];    // (C B^T o decay o dt_s) of one head, hi + lo
  bf16 Sh[kMaxN][kRsX], Sl[kMaxN][kRsX];  // S_prev of one head, hi + lo
  bf16 Wh[kL][kRsX], Wl[kL][kRsX];    // (w o x) of one head, hi + lo
  float lam[kMaxHB][kL];           // lambda_t
  float e_lam[kMaxHB][kL];         // exp(lambda_t)
  float w[kMaxHB][kL];             // exp(lambda_T - lambda_s) dt_s
  float e_last[kMaxHB];            // exp(lambda_T)
};
// One head's fp32 state tile, staged in and out through the second x buffer.
static_assert(sizeof(float) * kMaxN * kRsF <= sizeof(bf16) * kMaxHB * kL * kRsX, "state staging");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// (v0, v1) -> hi and lo bf16 pairs with hi + lo = v to about 16 bits.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void store_split2(bf16* hi, bf16* lo, float v0, float v1) {
  uint32_t h, l;
  split2(v0, v1, h, l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = l;
}

// Chunk [t0, t0 + nv) of C, B (all N), x (nh heads from h0, this CTA's
// columns) and dt into buffer buf, zero where it is out of range; one
// cp.async group (empty of copies when the operands are not aligned).
__device__ __forceinline__ void load_chunk(MmaSmem& sm, const int buf, const Args& a,
                                           const bf16* Cg, const bf16* Bg, const bf16* xh,
                                           const float* dth, const int nh, const int p0,
                                           const int t0, const int nv, const int tid) {
  constexpr int kPieces = kMaxN / 8;
  for (int i = tid; i < kL * kPieces; i += kMmaThreads) {
    const int t = i / kPieces, n = (i % kPieces) * 8;
    const long long oc = static_cast<long long>(t0 + t) * a.sc[1] + n;
    const long long ob = static_cast<long long>(t0 + t) * a.sb[1] + n;
    if (a.vec) {
      const bool ok = t < nv && n < a.n_n;
      cp_async16(&sm.C[buf][t][n], ok ? Cg + oc : Cg, ok ? 16 : 0);
      cp_async16(&sm.B[buf][t][n], ok ? Bg + ob : Bg, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool ok = t < nv && n + k < a.n_n;
        sm.C[buf][t][n + k] = ok ? Cg[oc + k] : __float2bfloat16_rn(0.f);
        sm.B[buf][t][n + k] = ok ? Bg[ob + k] : __float2bfloat16_rn(0.f);
      }
    }
  }
  constexpr int kXPieces = kTP / 8;
  for (int i = tid; i < nh * kL * kXPieces; i += kMmaThreads) {
    const int hh = i / (kL * kXPieces), rem = i % (kL * kXPieces);
    const int t = rem / kXPieces, p = (rem % kXPieces) * 8;
    const long long o = hh * a.sx[2] + static_cast<long long>(t0 + t) * a.sx[1] + p0 + p;
    if (a.vec) {
      const bool ok = t < nv && p0 + p < a.n_p;
      cp_async16(&sm.X[buf][hh][t][p], ok ? xh + o : xh, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool ok = t < nv && p0 + p + k < a.n_p;
        sm.X[buf][hh][t][p + k] = ok ? xh[o + k] : __float2bfloat16_rn(0.f);
      }
    }
  }
  for (int i = tid; i < nh * kL; i += kMmaThreads) {
    const int hh = i / kL, t = i % kL;
    if (t < nv) {
      cp_async4(&sm.dt[buf][hh][t],
                dth + hh * a.sdt[2] + static_cast<long long>(t0 + t) * a.sdt[1]);
    } else {
      sm.dt[buf][hh][t] = 0.f;
    }
  }
  cp_async_commit();
}

// Rows n < N, columns p0 .. p0 + kTP - 1 of one (N, P) fp32 state block into
// a (kMaxN, kRsF) tile (zero elsewhere), and back: 16-byte pieces when
// `vec`, else element by element.
__device__ __forceinline__ void stage_in(float* tile, const float* src, const int N, const int P,
                                         const int p0, const bool vec, const int tid) {
  for (int i = tid; i < kMaxN * (kTP / 4); i += kMmaThreads) {
    const int n = i / (kTP / 4), p = (i % (kTP / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < N) {
      const float* row = src + static_cast<long long>(n) * P + p0 + p;
      if (vec) {
        if (p0 + p < P) v = *reinterpret_cast<const float4*>(row);
      } else {
        v.x = p0 + p < P ? row[0] : 0.f;
        v.y = p0 + p + 1 < P ? row[1] : 0.f;
        v.z = p0 + p + 2 < P ? row[2] : 0.f;
        v.w = p0 + p + 3 < P ? row[3] : 0.f;
      }
    }
    *reinterpret_cast<float4*>(tile + n * kRsF + p) = v;
  }
}

__device__ __forceinline__ void stage_out(float* dst, const float* tile, const int N, const int P,
                                          const int p0, const bool vec, const int tid) {
  for (int i = tid; i < N * (kTP / 4); i += kMmaThreads) {
    const int n = i / (kTP / 4), p = (i % (kTP / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(tile + n * kRsF + p);
    float* row = dst + static_cast<long long>(n) * P + p0 + p;
    if (vec) {
      if (p0 + p < P) *reinterpret_cast<float4*>(row) = v;
    } else {
      if (p0 + p < P) row[0] = v.x;
      if (p0 + p + 1 < P) row[1] = v.y;
      if (p0 + p + 2 < P) row[2] = v.z;
      if (p0 + p + 3 < P) row[3] = v.w;
    }
  }
}

// Warp w (of 16) owns, for every head, the state block of rows 16 (w / 2)
// and columns 16 (w % 2) (fragment rows gq, gq + 8; columns 8 j + 2 q, + 1
// of n-tile j); the C B^T and score tile of time rows 16 (w / 4) and
// columns 16 (w % 4); and the y tile of time rows 16 (w / 4) and columns
// 8 (w % 4).
__global__ void __launch_bounds__(kMmaThreads, 1) ssd_chunk_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MmaSmem& sm = *reinterpret_cast<MmaSmem*>(smem_raw);
  const int hb = a.heads_per_cta;
  const int rep = a.n_h / a.n_g;
  const int blocks = (rep + hb - 1) / hb;
  const int g = blockIdx.y / blocks;
  const int h0 = g * rep + (blockIdx.y % blocks) * hb;
  const int nh = min(hb, (g + 1) * rep - h0);
  const int p0 = blockIdx.x * kTP;
  const int b = blockIdx.z;
  const int N = a.n_n, P = a.n_p;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q = lane & 3;  // fragment row and column pair
  const int j8 = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix and row this lane addresses
  const int sr = 16 * (warp >> 1), sc = 16 * (warp & 1);  // state block
  const int tb = warp >> 2, sb = warp & 3;                 // score tile (time, step blocks)
  const int yc = 8 * (warp & 3);                           // y columns

  const bf16* xh = static_cast<const bf16*>(a.x) + b * a.sx[0] + h0 * a.sx[2];
  const float* dth = a.dt + b * a.sdt[0] + h0 * a.sdt[2];
  const bf16* Bg = static_cast<const bf16*>(a.B) + b * a.sb[0] + g * a.sb[2];
  const bf16* Cg = static_cast<const bf16*>(a.C) + b * a.sc[0] + g * a.sc[2];
  const long long head0 = (static_cast<long long>(b) * a.n_h + h0) * N * P;  // state of h0
  // 16-byte state rows: whole 4-column pieces of 16-byte aligned rows.
  const bool vec_state = P % 4 == 0 && (reinterpret_cast<uintptr_t>(a.state) & 15) == 0 &&
                         (a.s0 == nullptr || (reinterpret_cast<uintptr_t>(a.s0) & 15) == 0);

  const int n_chunks = (a.n_s + kL - 1) / kL;
  load_chunk(sm, 0, a, Cg, Bg, xh, dth, nh, p0, 0, min(kL, a.n_s), tid);

  // The state, fp32, in registers: st[head][n-tile][fragment element]; s0
  // comes in through shared memory (x buffer 1, free until chunk 1's
  // copies) in rows of 16-byte loads.
  float st[kMaxHB][2][4];
  float* stage = reinterpret_cast<float*>(&sm.X[1][0][0][0]);  // (kMaxN, kRsF) fp32
#pragma unroll
  for (int hh = 0; hh < kMaxHB; ++hh) {
#pragma unroll
    for (int j = 0; j < 2; ++j) st[hh][j][0] = st[hh][j][1] = st[hh][j][2] = st[hh][j][3] = 0.f;
    if (a.s0 == nullptr || hh >= nh) continue;
    stage_in(stage, a.s0 + head0 + hh * static_cast<long long>(N) * P, N, P, p0, vec_state, tid);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = sr + gq, p = sc + 8 * j + 2 * q;
      const float2 lo = *reinterpret_cast<const float2*>(stage + n * kRsF + p);
      const float2 hi = *reinterpret_cast<const float2*>(stage + (n + 8) * kRsF + p);
      st[hh][j][0] = lo.x;
      st[hh][j][1] = lo.y;
      st[hh][j][2] = hi.x;
      st[hh][j][3] = hi.y;
    }
    __syncthreads();
  }

  const bool cb_tile = sb <= tb;  // this warp's score tile is on or below the diagonal

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, t0 = c * kL, nv = min(kL, a.n_s - t0);
    if (c + 1 < n_chunks) {
      load_chunk(sm, buf ^ 1, a, Cg, Bg, xh, dth, nh, p0, t0 + kL, min(kL, a.n_s - t0 - kL), tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // lambda of head `warp`, two steps a lane. lambda_T is lambda at the
    // last valid step itself, not the scan's total, which sums the same
    // terms in another order: exp(lambda_T - lambda_t) must be 1 at t = T.
    if (warp < nh) {
      const float A_h = a.A[h0 + warp];
      const float* d = sm.dt[buf][warp];
      const int t = 2 * lane;
      const float l0 = A_h * d[t], l1 = A_h * d[t + 1];
      const float pair = l0 + l1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float excl = incl - pair;
      const float lam0 = excl + l0, lam1 = excl + l0 + l1;
      const int last = nv - 1;
      const float lam_T = __shfl_sync(0xffffffffu, (last & 1) ? lam1 : lam0, last >> 1);
      if (lane == 0) sm.e_last[warp] = expf(lam_T);
      sm.lam[warp][t] = lam0;
      sm.lam[warp][t + 1] = lam1;
      sm.e_lam[warp][t] = expf(lam0);
      sm.e_lam[warp][t + 1] = expf(lam1);
      sm.w[warp][t] = expf(lam_T - lam0) * d[t];
      sm.w[warp][t + 1] = expf(lam_T - lam1) * d[t + 1];
    }

    // 1. C B^T, this warp's 16 x 16 tile, once for all heads.
    float cb[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.f;
    if (cb_tile) {
#pragma unroll
      for (int ks = 0; ks < kMaxN / 16; ++ks) {
        if (16 * ks >= N) break;
        uint32_t af[4], bfr[4];
        ldsm_x4(af, &sm.C[buf][16 * tb + (lane & 15)][16 * ks + (lane >> 4) * 8]);
        ldsm_x4(bfr, &sm.B[buf][16 * sb + (j8 >> 1) * 8 + r8][16 * ks + (j8 & 1) * 8]);
        mma16816(cb[0], af, bfr[0], bfr[1]);
        mma16816(cb[1], af, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // lambda

#pragma unroll
    for (int hh = 0; hh < kMaxHB; ++hh) {
      if (hh >= nh) break;
      // Operand planes of this head: scores, scaled x, S_prev.
      if (cb_tile) {
        const float* lam = sm.lam[hh];
        const float* d = sm.dt[buf][hh];
        const int ta = 16 * tb + gq, tbb = ta + 8;
        const float la = lam[ta], lb = lam[tbb];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int s = 16 * sb + 8 * j + 2 * q;
          const float ls0 = lam[s], ls1 = lam[s + 1], d0 = d[s], d1 = d[s + 1];
          const float v0 = s <= ta ? cb[j][0] * expf(la - ls0) * d0 : 0.f;
          const float v1 = s + 1 <= ta ? cb[j][1] * expf(la - ls1) * d1 : 0.f;
          const float v2 = s <= tbb ? cb[j][2] * expf(lb - ls0) * d0 : 0.f;
          const float v3 = s + 1 <= tbb ? cb[j][3] * expf(lb - ls1) * d1 : 0.f;
          store_split2(&sm.Mh[ta][s], &sm.Ml[ta][s], v0, v1);
          store_split2(&sm.Mh[tbb][s], &sm.Ml[tbb][s], v2, v3);
        }
      }
      {
        const int s = tid >> 3, pc = (tid & 7) * 4;
        const float ws = sm.w[hh][s];
        const uint2 raw = *reinterpret_cast<const uint2*>(&sm.X[buf][hh][s][pc]);
        const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        uint2 hi, lo;
        split2(f0.x * ws, f0.y * ws, hi.x, lo.x);
        split2(f1.x * ws, f1.y * ws, hi.y, lo.y);
        *reinterpret_cast<uint2*>(&sm.Wh[s][pc]) = hi;
        *reinterpret_cast<uint2*>(&sm.Wl[s][pc]) = lo;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = sr + gq, p = sc + 8 * j + 2 * q;
        store_split2(&sm.Sh[n][p], &sm.Sl[n][p], st[hh][j][0], st[hh][j][1]);
        store_split2(&sm.Sh[n + 8][p], &sm.Sl[n + 8][p], st[hh][j][2], st[hh][j][3]);
      }
      __syncthreads();  // planes

      // 2, 3. y rows 16 tb.., columns yc.. of this head; the hi and lo
      // products in their own accumulators (shorter dependency chains).
      {
        float y1h[4] = {}, y1l[4] = {}, y2h[4] = {}, y2l[4] = {};
#pragma unroll
        for (int k2 = 0; k2 < kMaxN / 32; ++k2) {  // two k-steps of 16 per pass
          if (32 * k2 >= N) break;
          uint32_t a0[4], a1[4], bh[4], bl[4];
          ldsm_x4(a0, &sm.C[buf][16 * tb + (lane & 15)][32 * k2 + (lane >> 4) * 8]);
          ldsm_x4(a1, &sm.C[buf][16 * tb + (lane & 15)][32 * k2 + 16 + (lane >> 4) * 8]);
          ldsm_x4_t(bh, &sm.Sh[32 * k2 + 8 * j8 + r8][yc]);
          ldsm_x4_t(bl, &sm.Sl[32 * k2 + 8 * j8 + r8][yc]);
          mma16816(y1h, a0, bh[0], bh[1]);
          mma16816(y1l, a0, bl[0], bl[1]);
          mma16816(y1h, a1, bh[2], bh[3]);
          mma16816(y1l, a1, bl[2], bl[3]);
        }
#pragma unroll
        for (int kb = 0; kb < kL / 16; ++kb) {
          if (kb > tb) break;
          uint32_t mh[4], ml[4], xb[2];
          ldsm_x4(mh, &sm.Mh[16 * tb + (lane & 15)][16 * kb + (lane >> 4) * 8]);
          ldsm_x4(ml, &sm.Ml[16 * tb + (lane & 15)][16 * kb + (lane >> 4) * 8]);
          ldsm_x2_t(xb, &sm.X[buf][hh][16 * kb + 8 * (j8 & 1) + r8][yc]);
          mma16816(y2h, mh, xb[0], xb[1]);
          mma16816(y2l, ml, xb[0], xb[1]);
        }
        const float D_h = a.D != nullptr ? a.D[h0 + hh] : 0.f;
        bf16* y = static_cast<bf16*>(a.y);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = 16 * tb + gq + 8 * r;
          if (t >= nv) continue;
          const float el = sm.e_lam[hh][t];
          const long long row =
              ((static_cast<long long>(b) * a.n_s + t0 + t) * a.n_h + h0 + hh) * P;
          const int pl = yc + 2 * q, p = p0 + pl;
          float v0 = el * (y1h[2 * r] + y1l[2 * r]) + (y2h[2 * r] + y2l[2 * r]);
          float v1 = el * (y1h[2 * r + 1] + y1l[2 * r + 1]) + (y2h[2 * r + 1] + y2l[2 * r + 1]);
          if (a.D != nullptr) {
            v0 += __bfloat162float(sm.X[buf][hh][t][pl]) * D_h;
            v1 += __bfloat162float(sm.X[buf][hh][t][pl + 1]) * D_h;
          }
          if (p + 1 < P && (P & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(y + row + p) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (p < P) y[row + p] = __float2bfloat16_rn(v0);
            if (p + 1 < P) y[row + p + 1] = __float2bfloat16_rn(v1);
          }
        }
      }

      // 4. S = exp(lambda_T) S + B^T @ (w o x), this warp's block of this
      //    head; the lo products summed apart, then added.
      {
        const float e = sm.e_last[hh];
        float lo[2][4] = {};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k) st[hh][j][k] *= e;
        }
        if (sr < N) {
#pragma unroll
          for (int ks = 0; ks < kL / 16; ++ks) {
            if (16 * ks >= nv) break;
            uint32_t af[4], wh[4], wl[4];
            ldsm_x4_t(af, &sm.B[buf][16 * ks + (j8 >> 1) * 8 + r8][sr + (j8 & 1) * 8]);
            ldsm_x4_t(wh, &sm.Wh[16 * ks + (j8 & 1) * 8 + r8][sc + (j8 >> 1) * 8]);
            ldsm_x4_t(wl, &sm.Wl[16 * ks + (j8 & 1) * 8 + r8][sc + (j8 >> 1) * 8]);
            mma16816(st[hh][0], af, wh[0], wh[1]);
            mma16816(st[hh][1], af, wh[2], wh[3]);
            mma16816(lo[0], af, wl[0], wl[1]);
            mma16816(lo[1], af, wl[2], wl[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k) st[hh][j][k] += lo[j][k];
        }
      }
      __syncthreads();  // the planes are rewritten for the next head
    }
  }

  // The final state out through shared memory, in rows of 16-byte stores.
#pragma unroll
  for (int hh = 0; hh < kMaxHB; ++hh) {
    if (hh >= nh) break;
    float* out = stage;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = sr + gq, p = sc + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(out + n * kRsF + p) = make_float2(st[hh][j][0], st[hh][j][1]);
      *reinterpret_cast<float2*>(out + (n + 8) * kRsF + p) =
          make_float2(st[hh][j][2], st[hh][j][3]);
    }
    __syncthreads();
    stage_out(a.state + head0 + hh * static_cast<long long>(N) * P, out, N, P, p0, vec_state,
              tid);
    __syncthreads();
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
__global__ void __launch_bounds__(kThreads) ssd_step_vec_kernel(const Args a) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (a.n_h / a.n_g);
  const int tid = threadIdx.x;
  const int N = a.n_n, P4 = a.n_p / 4;
  const int R = kThreads / P4;  // state rows per pass

  __shared__ float Bsh[kMaxN], Csh[kMaxN];
  __shared__ float4 part[kThreads];

  const TB* Bg = static_cast<const TB*>(a.B) + b * a.sb[0] + g * a.sb[2];
  const TB* Cg = static_cast<const TB*>(a.C) + b * a.sc[0] + g * a.sc[2];
  for (int n = tid; n < N; n += kThreads) {
    Bsh[n] = to_f(Bg[n]);
    Csh[n] = to_f(Cg[n]);
  }
  const float dt = a.dt[b * a.sdt[0] + h * a.sdt[2]];
  const float decay = expf(a.A[h] * dt);
  const TX* x = static_cast<const TX*>(a.x) + b * a.sx[0] + h * a.sx[2];
  const int c = tid % P4, r = tid / P4;
  const long long base = (static_cast<long long>(b) * a.n_h + h) * N * P4 + c;  // float4 units
  const float4* s0 = reinterpret_cast<const float4*>(a.s0);
  float4* state = reinterpret_cast<float4*>(a.state);
  __syncthreads();

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < R) {
    const float xd[4] = {to_f(x[4 * c]) * dt, to_f(x[4 * c + 1]) * dt, to_f(x[4 * c + 2]) * dt,
                         to_f(x[4 * c + 3]) * dt};
    for (int n0 = r; n0 < N; n0 += kStepRows * R) {
      float4 v[kStepRows];
#pragma unroll
      for (int k = 0; k < kStepRows; ++k) {  // every load started before the first use
        const int n = n0 + k * R;
        v[k] = s0 != nullptr && n < N ? s0[base + static_cast<long long>(n) * P4]
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kStepRows; ++k) {
        const int n = n0 + k * R;
        if (n >= N) break;
        const float bn = Bsh[n], cn = Csh[n];
        float4 s;
        s.x = fmaf(decay, v[k].x, bn * xd[0]);
        s.y = fmaf(decay, v[k].y, bn * xd[1]);
        s.z = fmaf(decay, v[k].z, bn * xd[2]);
        s.w = fmaf(decay, v[k].w, bn * xd[3]);
        state[base + static_cast<long long>(n) * P4] = s;
        acc.x = fmaf(cn, s.x, acc.x);
        acc.y = fmaf(cn, s.y, acc.y);
        acc.z = fmaf(cn, s.z, acc.z);
        acc.w = fmaf(cn, s.w, acc.w);
      }
    }
  }
  part[tid] = acc;
  __syncthreads();
  if (tid < P4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int rr = 0; rr < R; ++rr) {
      const float4 u = part[rr * P4 + tid];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const float D_h = a.D != nullptr ? a.D[h] : 0.f;
    const float out[4] = {v.x, v.y, v.z, v.w};
    TX* y = static_cast<TX*>(a.y) + (static_cast<long long>(b) * a.n_h + h) * a.n_p + 4 * tid;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float o = out[k];
      if (a.D != nullptr) o += to_f(x[4 * tid + k]) * D_h;
      y[k] = from_f<TX>(o);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TX, typename TB>
int launch(const Args& a, int* info) {
  // bf16 x with bf16 B and C: the mma chunk kernel; else the fp32 one.
  constexpr bool kMma = sizeof(TX) == 2 && sizeof(TB) == 2;
  const void* chunk;
  size_t smem_max, smem;
  if constexpr (kMma) {
    chunk = reinterpret_cast<const void*>(ssd_chunk_mma_kernel);
    smem_max = smem = sizeof(MmaSmem);
  } else {
    chunk = reinterpret_cast<const void*>(ssd_chunk_kernel<TX, TB>);
    smem_max = chunk_smem_bytes<TB>(kMaxN);
    smem = chunk_smem_bytes<TB>(a.n_n);
  }
  cudaError_t err = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info != nullptr) {
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, chunk);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[0] = static_cast<int>(smem);
    info[2] = attr.numRegs;
    info[3] = kMma ? kMaxHB : 1;
    info[4] = kMma ? kTP : kPS;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[1], chunk, kMma ? kMmaThreads : kThreads, smem));
  }
  if (a.n_s == 1) {
    const dim3 grid(a.n_h, a.n_b);
    if (a.n_p % 4 == 0 && (a.s0 == nullptr || aligned16(a.s0)) && aligned16(a.state)) {
      ssd_step_vec_kernel<TX, TB><<<grid, kThreads, 0, a.stream>>>(a);
    } else {
      ssd_step_kernel<TX, TB><<<grid, kThreads, 0, a.stream>>>(a);
    }
  } else if constexpr (kMma) {
    const int rep = a.n_h / a.n_g;
    if (a.heads_per_cta < 1 || a.heads_per_cta > kMaxHB) return -1;
    Args v = a;
    v.vec = aligned16(a.x) && aligned16(a.B) && aligned16(a.C) && a.n_n % 8 == 0 &&
            a.n_p % 8 == 0;
    for (int i = 0; i < 3; ++i) {
      v.vec = v.vec && a.sx[i] % 8 == 0 && a.sb[i] % 8 == 0 && a.sc[i] % 8 == 0;
    }
    const int head_blocks = (rep + a.heads_per_cta - 1) / a.heads_per_cta;
    const dim3 grid((a.n_p + kTP - 1) / kTP, a.n_g * head_blocks, a.n_b);
    ssd_chunk_mma_kernel<<<grid, kMmaThreads, smem, a.stream>>>(v);
  } else {
    const dim3 grid((a.n_p + kPS - 1) / kPS, a.n_h, a.n_b);
    ssd_chunk_kernel<TX, TB><<<grid, kThreads, smem, a.stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The one-step kernel's instance (vec: its 16-byte state form): info[0]
// dynamic shared memory per CTA (0: it declares its own), [1] resident CTAs
// per SM, [2] registers per thread, [3] static shared memory per CTA.
template <typename TX, typename TB>
int step_info(int vec, int* info) {
  const void* step = vec ? reinterpret_cast<const void*>(ssd_step_vec_kernel<TX, TB>)
                         : reinterpret_cast<const void*>(ssd_step_kernel<TX, TB>);
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(&attr, step);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = 0;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], step, kThreads, 0));
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
// step, group) of B and C; every last axis has unit stride. S == 1 runs a
// step kernel, S > 1 a chunk kernel; heads_per_cta (1 to 5, from the
// wrapper's plan) is read by the mma chunk kernel only.
int ssd_launch(int x_dtype, int bc_dtype, const void* x, const void* dt, const void* A,
               const void* B, const void* C, const void* D, const void* s0, void* y,
               void* state, int n_b, int n_s, int n_h, int n_g, int n_p, int n_n,
               int heads_per_cta, const long long* strides, void* stream) {
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
  a.heads_per_cta = heads_per_cta;
  for (int i = 0; i < 3; ++i) {
    a.sx[i] = strides[i];
    a.sdt[i] = strides[3 + i];
    a.sb[i] = strides[6 + i];
    a.sc[i] = strides[9 + i];
  }
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(x_dtype, bc_dtype, a, nullptr);
}

// The chunk kernel instance of these dtypes at state size n_n: dynamic
// shared memory per CTA (info[0], bytes), resident CTAs per SM (info[1]),
// registers per thread (info[2]), most heads per CTA (info[3]) and state
// columns per CTA (info[4]).
int ssd_info(int x_dtype, int bc_dtype, int n_n, int* info) {
  if (n_n < 1 || n_n > kMaxN) return -3;
  Args a{};
  a.n_n = n_n;
  return dispatch(x_dtype, bc_dtype, a, info);
}

// The one-step kernel instance (S == 1) of these dtypes, ``vec`` its
// 16-byte state form: step_info's fields.
int ssd_step_info(int x_dtype, int bc_dtype, int vec, int* info) {
  if (info == nullptr) return -1;
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && bc_dtype == 0) return step_info<float, float>(vec, info);
  if (x_dtype == 1 && bc_dtype == 1) return step_info<bf16, bf16>(vec, info);
  if (x_dtype == 1 && bc_dtype == 0) return step_info<bf16, float>(vec, info);
  if (x_dtype == 0 && bc_dtype == 1) return step_info<float, bf16>(vec, info);
  return -2;
}

}  // extern "C"
