// First-order linear recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/linear_scan/linear_scan.py::linear_scan_pallas
// (B3; bodies _kernel_sequential and _kernel_hillis_steele) and, for its VJP
// (src/repro/kernels/linear_scan/ops.py::_bwd_rule), the reverse-time call
// on flipped operands with the products around it. The forward computes
//   c_t = a_t * c_{t-1} + b_t      for t = 0 .. T-1, elementwise over F,
// with a, b: (T, F) and c0: (F,) read in their dtype and widened to fp32, an
// fp32 carry, and each c_t stored in the operands' dtype. The backward
// computes, at cotangent g,
//   cbar_t = g_t + a_{t+1} * cbar_{t+1}   (a_T = 0), walking t from T-1 down,
//   db_t = cbar_t,  da_t = cbar_t * c_{t-1} (c_{-1} = c0),  dc0 = a_0 * cbar_0,
// with cbar stored in g's dtype and the two products taken of the stored
// value, as JAX's rule takes them. Products and sums are rounded separately
// (__fmul_rn, __fadd_rn: no FMA contraction), as the plain versions in
// ref.py round them, so the two agree bit for bit.
//
// Design. On the TPU the grid walked time blocks in order with the carry in
// VMEM scratch. Here T is cut into chunks of `chunk` steps (ref.py's
// chunk_len: 64, a function of T alone) and each CTA, one warp, takes one
// (chunk, column tile): 32 threads x 4 bytes of columns (one fp32 or a bf16
// pair; one bf16 column where a pair would be unaligned or F is odd). It
// copies its tile of every step of the chunk into shared memory at once
// (cp.async, all in flight; the 2-byte path by plain loads), so a and b are
// read from device memory once. With more than one chunk it then computes
// the chunk's aggregate, A = the product of its a in time order and B = its
// scan from carry 0, writes it to a global record and raises the chunk's
// ready flag. Its carry in is c0 folded through A_j * c + B_j for every
// earlier chunk j, always from j = 0 up: only published aggregates, never a
// neighbour's running prefix, so the bits do not depend on which CTA ran
// first. Then it walks its chunk from that carry, storing each step. T <=
// chunk is one chunk, no flags, and the plain sequential walk.
//
// Scheduling. Chunk indices come from a 64-bit ticket word, chunk-major, so
// every CTA whose flag a CTA waits for took an earlier ticket and is already
// running: no deadlock whatever the card runs beside it. The word's high
// bits are an epoch that tags the launch's flags; the CTA that draws the
// last ticket starts the next epoch with a count of 0. So the flags are
// never cleared. Launches that share a word must run one after another:
// the wrapper keeps one word per stream, and a launch captured into a CUDA
// graph gets a word of its own.
//
// Bound. Bytes: a and b read once, c written once (backward: a, c, g read,
// da, db written), 2 fp32 operations per element. T = 64, F = 4096 bf16 is
// 1.57 MB, 0.47 us at 3.35 TB/s; one step is 24.6 KB and the launch
// dominates. The chunk's copies are one round trip, and its two walks over
// at most 64 steps (the aggregate, then the outputs) are the critical
// path; the fold adds one step per earlier chunk (measurements in PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (see repro_torch/kernels/build.py). The launch entry points return
// cudaGetLastError() after the launch, or a negative code for arguments they
// refuse; linear_scan_info reports an instance's resources.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 32;                 // one warp per CTA
constexpr int kAggBatch = 32;                // predecessor records staged at a time
constexpr int kCountBits = 24;               // ticket count; the epoch above it
constexpr unsigned long long kCountMask = (1ull << kCountBits) - 1;
constexpr long long kSpinLimit = 1ll << 25;  // polls before a wait traps (~seconds)
constexpr int kMaxChunk = 64;                // steps per chunk; shared memory <= 40 KB

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

// The kE columns of one thread, loaded and stored as one access.
template <typename T, int kE>
struct alignas(sizeof(T) * kE) Pack {
  T v[kE];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread's columns of one step, device memory -> shared memory: 4 bytes
// by cp.async; 2 bytes (a lone bf16 column) by an ordinary load and store.
template <int kBytes>
__device__ __forceinline__ void copy_in(void* dst, const void* src) {
  if constexpr (kBytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
    *static_cast<unsigned short*>(dst) = __ldg(static_cast<const unsigned short*>(src));
  }
}

__device__ __forceinline__ void copy_in16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The (chunk, tile) a CTA computes and its launch's flag tag.
struct Work {
  int chunk;
  int tile;
  unsigned tag;
};

__device__ __forceinline__ Work take_work(unsigned long long* ticket, int n_chunks, int n_tiles) {
  __shared__ unsigned long long s_old;
  if (n_chunks == 1) return {0, static_cast<int>(blockIdx.x), 0u};
  if (threadIdx.x == 0) {
    const unsigned long long old = atomicAdd(ticket, 1ull);
    const unsigned long long idx = old & kCountMask;
    if (idx >= gridDim.x) __trap();  // the word was left mid-launch: refuse, do not hang
    if (idx == gridDim.x - 1) atomicExch(ticket, ((old >> kCountBits) + 1) << kCountBits);
    s_old = old;
  }
  __syncthreads();
  const int idx = static_cast<int>(s_old & kCountMask);
  return {idx / n_tiles, idx % n_tiles, static_cast<unsigned>(s_old >> kCountBits) + 1u};
}

// Publish this thread's aggregate (A, B), then, once the whole CTA has
// written, the chunk's ready flag.
__device__ __forceinline__ void publish(float4* rec, bool live, float4 v, unsigned* flag,
                                        unsigned tag) {
  if (live) *rec = v;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, tag);
}

// The carry into chunk w.chunk: `c` folded through the aggregates of chunks
// 0 .. w.chunk-1 of this tile, in that order, as they are published.
template <int kE>
__device__ __forceinline__ void fold(float (&c)[kE], const Work& w, int n_tiles, bool live,
                                     const unsigned* flags, const float4* agg, float4* s_agg) {
  const int tid = threadIdx.x;
  for (int j = tid; j < w.chunk; j += kThreads) {
    const unsigned* f = flags + static_cast<int64_t>(j) * n_tiles + w.tile;
    long long spins = 0;
    while (ld_acquire(f) != w.tag) {
      if (++spins > kSpinLimit) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
  for (int j0 = 0; j0 < w.chunk; j0 += kAggBatch) {
    const int nj = min(kAggBatch, w.chunk - j0);
    if (live) {
      for (int j = 0; j < nj; ++j) {
        copy_in16(&s_agg[j * kThreads + tid],
                  &agg[(static_cast<int64_t>(j0 + j) * n_tiles + w.tile) * kThreads + tid]);
      }
    }
    copies_done();
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      const float4 q = s_agg[j * kThreads + tid];
      c[0] = __fadd_rn(__fmul_rn(q.x, c[0]), q.z);
      if constexpr (kE == 2) c[1] = __fadd_rn(__fmul_rn(q.y, c[1]), q.w);
    }
  }
}

template <typename T, int kE>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c0,
                   T* __restrict__ out, int n_t, int n_f, int chunk, int n_tiles,
                   unsigned long long* ticket, unsigned* flags, float4* agg) {
  using P = Pack<T, kE>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_chunks = (n_t + chunk - 1) / chunk;
  const int cap = min(chunk, n_t);
  P* s_a = reinterpret_cast<P*>(smem);
  P* s_b = s_a + cap * kThreads;
  float4* s_agg = reinterpret_cast<float4*>(s_b + cap * kThreads);

  const Work w = take_work(ticket, n_chunks, n_tiles);
  const int tid = threadIdx.x;
  const int64_t f0 = (static_cast<int64_t>(w.tile) * kThreads + tid) * kE;
  const bool live = f0 < n_f;  // the ragged edge; a pair needs n_f even (launcher)
  const int t0 = w.chunk * chunk;
  const int rows = min(chunk, n_t - t0);

  if (live) {
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      const int64_t off = static_cast<int64_t>(t0 + r) * n_f + f0;
      copy_in<sizeof(P)>(&s_a[r * kThreads + tid], a + off);
      copy_in<sizeof(P)>(&s_b[r * kThreads + tid], b + off);
    }
  }
  float c[kE];
  if (live) {
    const P p = *reinterpret_cast<const P*>(c0 + f0);
#pragma unroll
    for (int v = 0; v < kE; ++v) c[v] = to_f(p.v[v]);
  }
  copies_done();

  if (w.chunk < n_chunks - 1) {
    float A[kE], B[kE];
#pragma unroll
    for (int v = 0; v < kE; ++v) A[v] = 1.0f, B[v] = 0.0f;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      const P pa = s_a[r * kThreads + tid], pb = s_b[r * kThreads + tid];
#pragma unroll
      for (int v = 0; v < kE; ++v) {
        const float av = to_f(pa.v[v]);
        A[v] = __fmul_rn(A[v], av);
        B[v] = __fadd_rn(__fmul_rn(av, B[v]), to_f(pb.v[v]));
      }
    }
    publish(&agg[(static_cast<int64_t>(w.chunk) * n_tiles + w.tile) * kThreads + tid], live,
            make_float4(A[0], A[kE - 1], B[0], B[kE - 1]),
            flags + static_cast<int64_t>(w.chunk) * n_tiles + w.tile, w.tag);
  }
  if (w.chunk > 0) fold<kE>(c, w, n_tiles, live, flags, agg, s_agg);
  if (!live) return;

#pragma unroll 8
  for (int r = 0; r < rows; ++r) {
    const P pa = s_a[r * kThreads + tid], pb = s_b[r * kThreads + tid];
    P o;
#pragma unroll
    for (int v = 0; v < kE; ++v) {
      c[v] = __fadd_rn(__fmul_rn(to_f(pa.v[v]), c[v]), to_f(pb.v[v]));
      o.v[v] = from_f<T>(c[v]);
    }
    *reinterpret_cast<P*>(out + static_cast<int64_t>(t0 + r) * n_f + f0) = o;
  }
}

// Reverse-time chunk k holds steps t = T-1-k*chunk down to T-(k+1)*chunk
// (or 0): the forward's chunking applied to the time-flipped operands.
template <typename T, int kE>
__global__ void __launch_bounds__(kThreads)
linear_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ c, const T* __restrict__ c0,
                       const T* __restrict__ g, T* __restrict__ da, T* __restrict__ db,
                       T* __restrict__ dc0, int n_t, int n_f, int chunk, int n_tiles,
                       unsigned long long* ticket, unsigned* flags, float4* agg) {
  using P = Pack<T, kE>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_chunks = (n_t + chunk - 1) / chunk;
  const int cap = min(chunk, n_t);
  P* s_an = reinterpret_cast<P*>(smem);  // a_{t+1}
  P* s_g = s_an + cap * kThreads;
  P* s_cp = s_g + cap * kThreads;        // c_{t-1}
  float4* s_agg = reinterpret_cast<float4*>(s_cp + cap * kThreads);

  const Work w = take_work(ticket, n_chunks, n_tiles);
  const int tid = threadIdx.x;
  const int64_t f0 = (static_cast<int64_t>(w.tile) * kThreads + tid) * kE;
  const bool live = f0 < n_f;
  const int t_hi = n_t - 1 - w.chunk * chunk;  // the chunk's first step, walking down
  const int rows = min(chunk, t_hi + 1);

  if (live) {
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const int t = t_hi - r;
      const int64_t off = static_cast<int64_t>(t) * n_f + f0;
      if (t + 1 < n_t) {
        copy_in<sizeof(P)>(&s_an[r * kThreads + tid], a + off + n_f);
      } else {
        P z;
#pragma unroll
        for (int v = 0; v < kE; ++v) z.v[v] = from_f<T>(0.0f);
        s_an[r * kThreads + tid] = z;
      }
      copy_in<sizeof(P)>(&s_g[r * kThreads + tid], g + off);
      copy_in<sizeof(P)>(&s_cp[r * kThreads + tid], t > 0 ? c + off - n_f : c0 + f0);
    }
  }
  float a0[kE];  // a_0, for dc0, in the chunk that holds t = 0
  if (live && w.chunk == n_chunks - 1) {
    const P p = *reinterpret_cast<const P*>(a + f0);
#pragma unroll
    for (int v = 0; v < kE; ++v) a0[v] = to_f(p.v[v]);
  }
  copies_done();

  if (w.chunk < n_chunks - 1) {
    float A[kE], B[kE];
#pragma unroll
    for (int v = 0; v < kE; ++v) A[v] = 1.0f, B[v] = 0.0f;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      const P pa = s_an[r * kThreads + tid], pg = s_g[r * kThreads + tid];
#pragma unroll
      for (int v = 0; v < kE; ++v) {
        const float av = to_f(pa.v[v]);
        A[v] = __fmul_rn(A[v], av);
        B[v] = __fadd_rn(__fmul_rn(av, B[v]), to_f(pg.v[v]));
      }
    }
    publish(&agg[(static_cast<int64_t>(w.chunk) * n_tiles + w.tile) * kThreads + tid], live,
            make_float4(A[0], A[kE - 1], B[0], B[kE - 1]),
            flags + static_cast<int64_t>(w.chunk) * n_tiles + w.tile, w.tag);
  }
  float cb[kE];
#pragma unroll
  for (int v = 0; v < kE; ++v) cb[v] = 0.0f;
  if (w.chunk > 0) fold<kE>(cb, w, n_tiles, live, flags, agg, s_agg);
  if (!live) return;

#pragma unroll 8
  for (int r = 0; r < rows; ++r) {
    const int t = t_hi - r;
    const P pa = s_an[r * kThreads + tid], pg = s_g[r * kThreads + tid];
    const P pc = s_cp[r * kThreads + tid];
    P od, ob;
#pragma unroll
    for (int v = 0; v < kE; ++v) {
      cb[v] = __fadd_rn(__fmul_rn(to_f(pa.v[v]), cb[v]), to_f(pg.v[v]));
      ob.v[v] = from_f<T>(cb[v]);  // cbar as stored; the products take this value
      od.v[v] = from_f<T>(__fmul_rn(to_f(ob.v[v]), to_f(pc.v[v])));
    }
    const int64_t off = static_cast<int64_t>(t) * n_f + f0;
    *reinterpret_cast<P*>(db + off) = ob;
    *reinterpret_cast<P*>(da + off) = od;
    if (t == 0) {
      P o0;
#pragma unroll
      for (int v = 0; v < kE; ++v) o0.v[v] = from_f<T>(__fmul_rn(a0[v], to_f(ob.v[v])));
      *reinterpret_cast<P*>(dc0 + f0) = o0;
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % static_cast<std::uintptr_t>(bytes) == 0;
}

// One call's grid and shared memory, or false for arguments the kernels do
// not take. A thread copies and walks a bf16 pair where F is even and every
// operand is 4-byte aligned. `operands`: rows staged per step (2 forward, 3
// backward).
struct Grid {
  int n_chunks, n_tiles, ctas, smem;
  bool pair;
};

// The grid and shared memory of a call whose threads walk a bf16 pair each
// (`pair`) or one element, or false for shapes the kernels do not take.
bool grid_of(int esize, int n_t, int n_f, int chunk, int operands, bool pair, Grid* grid) {
  if (n_t < 1 || n_f < 1 || chunk < 1 || chunk > kMaxChunk) return false;
  const int elems = pair ? 2 : 1;
  const int64_t n_chunks = (static_cast<int64_t>(n_t) + chunk - 1) / chunk;
  const int64_t n_tiles = (static_cast<int64_t>(n_f) + kThreads * elems - 1) / (kThreads * elems);
  const int64_t ctas = n_chunks * n_tiles;
  if (ctas > static_cast<int64_t>(kCountMask)) return false;
  const int rows = chunk < n_t ? chunk : n_t;
  int smem = operands * rows * kThreads * esize * elems;
  if (n_chunks > 1) smem += (n_chunks - 1 < kAggBatch ? n_chunks - 1 : kAggBatch) * kThreads * 16;
  *grid = {static_cast<int>(n_chunks), static_cast<int>(n_tiles), static_cast<int>(ctas), smem,
           pair};
  return true;
}

bool make_grid(int esize, int n_t, int n_f, int chunk, int operands, const void* const* ptrs,
               int n_ptrs, const void* sync, const void* agg, Grid* grid) {
  bool pair = esize == 2 && n_f % 2 == 0;
  for (int i = 0; i < n_ptrs; ++i) pair = pair && aligned(ptrs[i], 4);
  if (!grid_of(esize, n_t, n_f, chunk, operands, pair, grid)) return false;
  return grid->n_chunks == 1 ||
         (sync != nullptr && agg != nullptr && aligned(sync, 8) && aligned(agg, 16));
}

// What linear_scan_info reports of an instance, in this order.
enum Info { kSmem, kCtasPerSm, kRegs, kStaticSmem, kCtas };

template <typename K>
int describe(K kernel, const Grid& gr, int* info) {
  cudaFuncAttributes attr{};
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  info[kSmem] = gr.smem;
  info[kRegs] = attr.numRegs;
  info[kStaticSmem] = static_cast<int>(attr.sharedSizeBytes);
  info[kCtas] = gr.ctas;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[kCtasPerSm], kernel, kThreads, gr.smem));
}

template <typename T, int kE>
int describe_dir(bool backward, const Grid& gr, int* info) {
  return backward ? describe(linear_scan_bwd_kernel<T, kE>, gr, info)
                  : describe(linear_scan_kernel<T, kE>, gr, info);
}

template <typename T, int kE>
int launch_fwd(const void* a, const void* b, const void* c0, void* out, int n_t, int n_f,
               int chunk, const Grid& gr, void* sync, void* agg, cudaStream_t stream) {
  auto* ticket = static_cast<unsigned long long*>(sync);
  auto* flags = sync == nullptr ? nullptr : static_cast<unsigned*>(sync) + 2;
  linear_scan_kernel<T, kE><<<gr.ctas, kThreads, gr.smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(c0),
      static_cast<T*>(out), n_t, n_f, chunk, gr.n_tiles, ticket, flags, static_cast<float4*>(agg));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kE>
int launch_bwd(const void* a, const void* c, const void* c0, const void* g, void* da, void* db,
               void* dc0, int n_t, int n_f, int chunk, const Grid& gr, void* sync, void* agg,
               cudaStream_t stream) {
  auto* ticket = static_cast<unsigned long long*>(sync);
  auto* flags = sync == nullptr ? nullptr : static_cast<unsigned*>(sync) + 2;
  linear_scan_bwd_kernel<T, kE><<<gr.ctas, kThreads, gr.smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(c), static_cast<const T*>(c0),
      static_cast<const T*>(g), static_cast<T*>(da), static_cast<T*>(db), static_cast<T*>(dc0),
      n_t, n_f, chunk, gr.n_tiles, ticket, flags, static_cast<float4*>(agg));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// c_t = a_t * c_{t-1} + b_t over (T, F) row-major, contiguous operands.
// dtype: 0 = float32, 1 = bfloat16, for a, b, c0 and out alike. chunk: steps
// per chunk, 1 .. 64 (ref.py's chunk_len). With more than one chunk, sync is
// a zeroed 64-bit ticket word followed by a 32-bit flag per (chunk, tile of
// 32 columns), kept between the calls of one stream, and agg (16-byte
// aligned) holds 16 bytes per column of every chunk but the last. -1:
// arguments the kernel does not take; -2: an unknown dtype.
int linear_scan_launch(int dtype, const void* a, const void* b, const void* c0, void* out,
                       int n_t, int n_f, int chunk, void* sync, void* agg, void* stream) {
  if (dtype != 0 && dtype != 1) return -2;
  const void* ptrs[] = {a, b, c0, out};
  Grid gr;
  if (!make_grid(dtype == 0 ? 4 : 2, n_t, n_f, chunk, 2, ptrs, 4, sync, agg, &gr)) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float, 1>(a, b, c0, out, n_t, n_f, chunk, gr, sync, agg, s);
  if (gr.pair)
    return launch_fwd<__nv_bfloat16, 2>(a, b, c0, out, n_t, n_f, chunk, gr, sync, agg, s);
  return launch_fwd<__nv_bfloat16, 1>(a, b, c0, out, n_t, n_f, chunk, gr, sync, agg, s);
}

// The VJP at cotangent g of c = linear_scan(a, b, c0): da, db (T, F) and
// dc0 (F,), from a, c, g (T, F) and c0 (F,), all of one dtype; chunk, sync
// and agg as for linear_scan_launch.
int linear_scan_bwd_launch(int dtype, const void* a, const void* c, const void* c0,
                           const void* g, void* da, void* db, void* dc0, int n_t, int n_f,
                           int chunk, void* sync, void* agg, void* stream) {
  if (dtype != 0 && dtype != 1) return -2;
  const void* ptrs[] = {a, c, c0, g, da, db, dc0};
  Grid gr;
  if (!make_grid(dtype == 0 ? 4 : 2, n_t, n_f, chunk, 3, ptrs, 7, sync, agg, &gr)) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float, 1>(a, c, c0, g, da, db, dc0, n_t, n_f, chunk, gr, sync, agg, s);
  if (gr.pair) {
    return launch_bwd<__nv_bfloat16, 2>(a, c, c0, g, da, db, dc0, n_t, n_f, chunk, gr, sync,
                                        agg, s);
  }
  return launch_bwd<__nv_bfloat16, 1>(a, c, c0, g, da, db, dc0, n_t, n_f, chunk, gr, sync, agg,
                                      s);
}

// The instance a call of these operands runs, described instead of
// launched: info[0] dynamic shared memory per CTA (bytes), [1] resident CTAs
// per SM, [2] registers per thread, [3] static shared memory (bytes), [4]
// grid (CTAs). backward: the VJP's kernel; pair: every operand 4-byte
// aligned (a bf16 pair a thread where F is even). -1: shapes the kernels
// do not take; -2: an unknown dtype.
int linear_scan_info(int dtype, int n_t, int n_f, int chunk, int backward, int pair, int* info) {
  if (dtype != 0 && dtype != 1) return -2;
  const int esize = dtype == 0 ? 4 : 2;
  Grid gr;
  if (info == nullptr ||
      !grid_of(esize, n_t, n_f, chunk, backward ? 3 : 2, esize == 2 && pair && n_f % 2 == 0, &gr))
    return -1;
  if (dtype == 0) return describe_dir<float, 1>(backward, gr, info);
  if (gr.pair) return describe_dir<__nv_bfloat16, 2>(backward, gr, info);
  return describe_dir<__nv_bfloat16, 1>(backward, gr, info);
}

}  // extern "C"
