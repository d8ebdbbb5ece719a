// chess_hvp.cuh: the chess_hvp kernel template and what surrounds a device
// form, shared by csrc/chess_hvp.cu (the hand-written forms of the paper's
// test functions) and the generated forms of kernels/codegen.py (any
// hmath-written f, one translation unit per traced function and n).
//
// A device form F plugs into chess_hvp_kernel<F, C, kStaged>: the kernel
// stages a CTA's instances (a, v, a zeroed output row and F's primal tables)
// in shared memory, runs F's cells, and writes the rows once.  This header
// holds the cell (Cell, cell_at, active, seed_at), the scatter of a cell's
// direct and mirrored terms, the shared-memory layout, the dtype conversion,
// the kernel and its launch (launch_entry, the checks of the C entry
// points).  See csrc/chess_hvp.cu for the design of the kernel and its
// forms.
//
// A generated form (kernels/codegen.py) is the structural evaluation of f's
// traced graph: its instance() computes, once an instance and a thread per
// element, the values no seed reaches into the instance's slot (kRows rows
// and kScalars scalars past a, v and out), with a barrier (CHESS_SYNC)
// between levels; its eval<C> runs each cell over the seeds' support only
// (slot loops over windows around i and the carried columns, lane loops
// that derive a lane's own column), reading those values from the slot and
// keeping in local arrays only small values two loops read.
//
// Compiled by nvcc for the card; without __CUDACC__ (a host C++ compiler:
// the CPU check of a generated form, tests/test_torch_chess_traced.py) only
// the cell, the scatter and the host driver host_lanes<F> remain: one
// thread runs each instance's instance pass, then its cells, and atomicAdd
// is a plain add.
#pragma once

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#define CHESS_LDG(p) __ldg(p)
#define CHESS_TID static_cast<int>(threadIdx.x)
#define CHESS_NTHREADS static_cast<int>(blockDim.x)
#define CHESS_SYNC() __syncthreads()
#else
#include <algorithm>
#include <vector>
#define CHESS_LDG(p) (*(p))
#define CHESS_TID 0
#define CHESS_NTHREADS 1
#define CHESS_SYNC()
#endif

#include <type_traits>

#include "hdual.cuh"

namespace chessfad {

// The lane instantiations a form is built at: bit log2(C) of F::kLaneMask
// where the form declares one (a generated form leaves out the widths whose
// local memory would not fit), else all seven.
template <class F, class = void>
struct LaneMask {
  static constexpr unsigned value = 0x7fu;
};
template <class F>
struct LaneMask<F, std::void_t<decltype(F::kLaneMask)>> {
  static constexpr unsigned value = F::kLaneMask;
};
constexpr int ilog2(int c) { return c <= 1 ? 0 : 1 + ilog2(c / 2); }

// Whether a form that runs its own cells has a staged variant (its
// constant matrices in shared memory): Fletcher-Powell's; a generated form
// says kStages = false and is built unstaged only.
template <class F, class = void>
struct Stages {
  static constexpr bool value = true;
};
template <class F>
struct Stages<F, std::void_t<decltype(F::kStages)>> {
  static constexpr bool value = F::kStages;
};

#ifndef __CUDACC__
using std::max;
using std::min;

// one thread runs every cell on the host: a shared-memory atomic is an add
inline float atomicAdd(float* p, float x) {
  const float old = *p;
  *p = old + x;
  return old;
}
#endif


constexpr int kThreads = 256;     // threads per CTA; kernels/chess_hvp.py::THREADS
constexpr int kWarpsMax = 8;      // Fletcher-Powell warps per CTA, at most (WARPS)
constexpr int kSmemMax = 232448;  // opt-in shared memory per CTA (SMEM_MAX)

// odd row stride of the per-instance rows and of the staged matrices
__host__ __device__ inline int padded(int n) { return n | 1; }
__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

struct Consts {
  const float* At;  // Fletcher-Powell A transposed: At[k * n + r] = A[r, k]
  const float* Bt;  // B transposed
  const float* E;   // E (n,)
};

// an hDual in shared memory, 16-byte aligned so that it reads in 128 bits
template <int C>
struct alignas(16) SharedHDual {
  HDual<C> h;
};

// One cell (or sub-cell): row i, first carried column sub, carried lanes
// width, and the chunk's first column cstart (for the mirror).  Below 64
// lanes a sub-cell is its whole chunk (csize <= C); saying so at compile
// time keeps the sub-cell arithmetic out of those instantiations.
struct Cell {
  int i, sub, width, cstart;
};

template <int C>
__device__ __forceinline__ Cell cell_at(const int* rows, const int* starts,
                                        int p, int csize) {
  Cell c;
  c.i = CHESS_LDG(rows + p);
  c.sub = CHESS_LDG(starts + p);
  c.cstart = C < 64 ? c.sub : (c.sub / csize) * csize;
  c.width = C < 64 ? csize : min(C, c.cstart + csize - c.sub);
  return c;
}

// The coordinate in slot j of the active set S, or -1: slots j < C hold the
// carried columns sub + j (masked at width and n), slot C holds i when it is
// not one of them.
template <int C>
__device__ __forceinline__ int active(int j, const Cell& c, int n) {
  if (j < C) {
    const int k = c.sub + j;
    return (j < c.width && k < n) ? k : -1;
  }
  return (c.i >= c.sub && c.i < c.sub + c.width) ? -1 : c.i;
}

template <int C>
__device__ __forceinline__ HDual<C> seed_at(const float* a, int k,
                                            const Cell& c) {
  return seed<C>(a[k], k, c.i, c.sub, c.width);
}

// The cell's direct term into o[i] and, off the diagonal block of the
// symmetric schedule, its mirrored terms into o[col]; reads only r.dij.
template <int C>
__device__ __forceinline__ void scatter(const HDual<C>& r, const float* v,
                                        float* o, const Cell& c, int n,
                                        int csize, int symmetric) {
  const bool mirror = symmetric && c.cstart > (c.i / csize) * csize;
  const float vi = v[c.i];
  float direct = 0.f;
#pragma unroll
  for (int l = 0; l < C; ++l) {
    const int col = c.sub + l;
    if (l < c.width && col < n) {
      direct += r.dij[l] * v[col];
      if (mirror) atomicAdd(o + col, r.dij[l] * vi);
    }
  }
  atomicAdd(o + c.i, direct);
}

template <bool kShared>
__device__ __forceinline__ float mat(const float* p, int idx) {
  return kShared ? p[idx] : CHESS_LDG(p + idx);
}

// Shared-memory layout, in floats: [A^T, B^T if staged] [ipb instance
// slots, rounded to 16 bytes] [Fletcher-Powell's tangent tables];
// kernels/chess_hvp.py::shared_bytes is the same sum.  The slot stride is
// odd, so that the same coordinate of 32 consecutive instances sits in 32
// banks.
template <class F>
__host__ __device__ inline int slot_floats(int n) {
  return (F::kRows * padded(n) + F::kScalars) | 1;
}

// A device form gives its per-instance slot (kRows rows of n|1 floats after
// a, v and out, then kScalars floats), its primal tables (table: per
// coordinate; instance: per instance, after the tables), and the hDual value
// of f on one cell (eval), or, with kOwnCells, the whole cell loop.

#ifdef __CUDACC__

// a thread per (instance, cell); consecutive threads take the same cell of
// consecutive instances
template <class F, int C>
__device__ __forceinline__ void thread_cells(float* inst, int slot, int ld,
                                             int nin, const int* rows,
                                             const int* starts, int P, int n,
                                             int csize, int symmetric) {
  for (int w = threadIdx.x; w < nin * P; w += blockDim.x) {
    const int p = w / nin;
    const int q = w - p * nin;
    const Cell c = cell_at<C>(rows, starts, p, csize);
    float* s = inst + q * slot;
    scatter<C>(F::template eval<C>(s, ld, n, c), s + ld, s + 2 * ld, c, n,
               csize, symmetric);
  }
}

__host__ __device__ inline int staged_floats(int n) {
  return round4(2 * n * padded(n));
}

template <class F, int C>
__host__ inline size_t shared_bytes(int n, int ipb, int warps, int staged) {
  size_t floats = static_cast<size_t>(staged ? staged_floats(n) : 0) +
                  round4(ipb * slot_floats<F>(n));
  if constexpr (F::kOwnCells) {
    floats += static_cast<size_t>(warps) *
              F::template table_floats<C>();
  }
  return floats * sizeof(float);
}

// Element types of A, V and out (kernels/build.py::DTYPE_CODES).
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float load_f32(const void* p, size_t g, int dt) {
  if (dt == kBF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[g]);
  }
  if (dt == kF16) return __half2float(static_cast<const __half*>(p)[g]);
  return static_cast<const float*>(p)[g];
}

__device__ __forceinline__ void store_as(void* p, size_t g, int dt, float x) {
  if (dt == kBF16) {
    static_cast<__nv_bfloat16*>(p)[g] = __float2bfloat16(x);
  } else if (dt == kF16) {
    static_cast<__half*>(p)[g] = __float2half(x);
  } else {
    static_cast<float*>(p)[g] = x;
  }
}

template <class F, int C, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    chess_hvp_kernel(const void* __restrict__ A, const void* __restrict__ V,
                     void* __restrict__ out, int dtype,
                     const int* __restrict__ rows,
                     const int* __restrict__ starts, int P, int m, int n,
                     int csize, int symmetric, int ipb, Consts consts) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = padded(n);
  const int slot = slot_floats<F>(n);
  const int m0 = blockIdx.x * ipb;
  const int nin = min(ipb, m - m0);

  const float* At = consts.At;
  const float* Bt = consts.Bt;
  int lda = n;
  float* inst = smem;
  if constexpr (kStaged) {
    float* sA = smem;
    float* sB = smem + n * ld;
    for (int t = threadIdx.x; t < n * n; t += blockDim.x) {
      const int k = t / n;
      const int r = t - k * n;
      sA[k * ld + r] = __ldg(consts.At + t);
      sB[k * ld + r] = __ldg(consts.Bt + t);
    }
    At = sA;
    Bt = sB;
    lda = ld;
    inst = smem + staged_floats(n);
  }

  for (int t = threadIdx.x; t < nin * n; t += blockDim.x) {
    const int q = t / n;
    const int k = t - q * n;
    const size_t g = static_cast<size_t>(m0 + q) * n + k;
    float* s = inst + q * slot;
    const float a_k = load_f32(A, g, dtype);
    s[k] = a_k;
    s[ld + k] = load_f32(V, g, dtype);
    s[2 * ld + k] = 0.f;
    F::table(a_k, s, ld, k);
  }
  __syncthreads();
  F::template instance<kStaged>(inst, slot, ld, nin, n, At, Bt, lda,
                                consts.E);
  __syncthreads();

  if constexpr (F::kOwnCells) {
    F::template cells<C, kStaged>(inst, slot, ld, nin,
                                  inst + round4(ipb * slot),
                                  rows, starts, P, n, csize, symmetric, At,
                                  Bt, lda);
  } else {
    thread_cells<F, C>(inst, slot, ld, nin, rows, starts, P, n, csize,
                       symmetric);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < nin * n; t += blockDim.x) {
    const int q = t / n;
    const int k = t - q * n;
    store_as(out, static_cast<size_t>(m0 + q) * n + k, dtype,
             inst[q * slot + 2 * ld + k]);
  }
}

template <class F, int C, bool kStaged>
cudaError_t launch_one(const void* A, const void* V, void* out, int dtype,
                       const int* rows, const int* starts, int P, int m,
                       int n, int csize, int symmetric, int ipb, int threads,
                       size_t smem, Consts consts, cudaStream_t stream) {
  // before every launch: allow the CTA up to the card's opt-in shared
  // memory (the attribute belongs to the current device's context, so it
  // is not set once per process)
  const cudaError_t opt_in = cudaFuncSetAttribute(
      chess_hvp_kernel<F, C, kStaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (opt_in != cudaSuccess) return opt_in;
  const unsigned grid = static_cast<unsigned>((m + ipb - 1) / ipb);
  chess_hvp_kernel<F, C, kStaged><<<grid, threads, smem, stream>>>(
      A, V, out, dtype, rows, starts, P, m, n, csize, symmetric, ipb, consts);
  return cudaGetLastError();
}

template <class F, int C>
cudaError_t launch(const void* A, const void* V, void* out, int dtype,
                   const int* rows, const int* starts, int P, int m, int n,
                   int csize, int symmetric, int ipb, int warps, int staged,
                   size_t smem_bytes, Consts consts, cudaStream_t stream) {
  // the wrapper's layout must be this one, byte for byte
  if (smem_bytes != shared_bytes<F, C>(n, ipb, warps, staged) ||
      smem_bytes > static_cast<size_t>(kSmemMax)) {
    return cudaErrorInvalidValue;
  }
  if constexpr (F::kOwnCells) {
    if (warps < 1 || warps > kWarpsMax) return cudaErrorInvalidValue;
    if constexpr (Stages<F>::value) {
      if (staged) {
        return launch_one<F, C, true>(A, V, out, dtype, rows, starts, P, m,
                                      n, csize, symmetric, ipb, 32 * warps,
                                      smem_bytes, consts, stream);
      }
    } else {
      if (staged) return cudaErrorInvalidValue;
    }
    return launch_one<F, C, false>(A, V, out, dtype, rows, starts, P, m, n,
                                   csize, symmetric, ipb, 32 * warps,
                                   smem_bytes, consts, stream);
  } else {
    if (staged) return cudaErrorInvalidValue;
    return launch_one<F, C, false>(A, V, out, dtype, rows, starts, P, m, n,
                                   csize, symmetric, ipb, kThreads,
                                   smem_bytes, consts, stream);
  }
}

template <class F>
cudaError_t launch_lanes(int cmax, const void* A, const void* V, void* out,
                         int dtype, const int* rows, const int* starts, int P,
                         int m, int n, int csize, int symmetric, int ipb,
                         int warps, int staged, size_t smem_bytes,
                         Consts consts, cudaStream_t stream) {
#define CHESS_HVP_CASE(CM)                                                  \
  case CM:                                                                  \
    if constexpr ((LaneMask<F>::value >> ilog2(CM)) & 1u) {                 \
      return launch<F, CM>(A, V, out, dtype, rows, starts, P, m, n, csize,  \
                           symmetric, ipb, warps, staged, smem_bytes,       \
                           consts, stream);                                 \
    } else {                                                                \
      return cudaErrorInvalidValue;                                         \
    }
  switch (cmax) {
    CHESS_HVP_CASE(1)
    CHESS_HVP_CASE(2)
    CHESS_HVP_CASE(4)
    CHESS_HVP_CASE(8)
    CHESS_HVP_CASE(16)
    CHESS_HVP_CASE(32)
    CHESS_HVP_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef CHESS_HVP_CASE
}

// a thread per (instance, cell), as thread_cells, for a form whose eval
// reads float32 constants k from device memory (the generated forms)
template <class F, int C>
__device__ __forceinline__ void const_cells(float* inst, int slot, int ld,
                                            int nin, const int* rows,
                                            const int* starts, int P, int n,
                                            int csize, int symmetric,
                                            const float* k) {
  for (int w = threadIdx.x; w < nin * P; w += blockDim.x) {
    const int p = w / nin;
    const int q = w - p * nin;
    const Cell c = cell_at<C>(rows, starts, p, csize);
    float* s = inst + q * slot;
    scatter<C>(F::template eval<C>(s, k, c), s + ld, s + 2 * ld, c, n, csize,
               symmetric);
  }
}

// The checks and dispatch of a C entry point (see csrc/chess_hvp.cu's
// chess_hvp_launch for the arguments): the first CUDA error of the
// shared-memory opt-in or of the launch.
template <class F>
cudaError_t launch_entry(const void* A, const void* V, void* out, int dtype,
                         const int* rows, const int* starts, int P, int m,
                         int n, int csize, int cmax, int symmetric, int ipb,
                         int warps, int staged, long long smem_bytes,
                         Consts consts, void* stream) {
  if (csize < 1 || (csize > cmax && cmax != 64) || m < 1 || n < 1 || P < 1 ||
      ipb < 1 || smem_bytes < 0 || dtype < kF32 || dtype > kF16) {
    return cudaErrorInvalidValue;
  }
  return launch_lanes<F>(cmax, A, V, out, dtype, rows, starts, P, m, n, csize,
                         symmetric, ipb, warps, staged,
                         static_cast<size_t>(smem_bytes), consts,
                         static_cast<cudaStream_t>(stream));
}

#else  // host: each instance's instance pass and cells, one after the other

template <class F, int C>
int host_cells(const float* A, const float* V, float* out, const int* rows,
               const int* starts, int P, int m, int n, int csize,
               int symmetric, const float* k) {
  const int ld = padded(n);
  const int slot = slot_floats<F>(n);
  std::vector<float> s(slot);
  for (int q = 0; q < m; ++q) {
    for (int j = 0; j < n; ++j) {
      s[j] = A[q * n + j];
      s[ld + j] = V[q * n + j];
      s[2 * ld + j] = 0.f;
    }
    F::template instance<false>(s.data(), slot, ld, 1, n, k, nullptr, 0,
                                nullptr);
    for (int p = 0; p < P; ++p) {
      const Cell c = cell_at<C>(rows, starts, p, csize);
      scatter<C>(F::template eval<C>(s.data(), k, c), s.data() + ld,
                 s.data() + 2 * ld, c, n, csize, symmetric);
    }
    for (int j = 0; j < n; ++j) out[q * n + j] = s[2 * ld + j];
  }
  return 0;
}

// float32 A, V and out on the host, at lane instantiation cmax
template <class F>
int host_lanes(int cmax, const float* A, const float* V, float* out,
               const int* rows, const int* starts, int P, int m, int n,
               int csize, int symmetric, const float* k) {
  if (csize < 1 || (csize > cmax && cmax != 64) || m < 1 || P < 1) return 1;
#define CHESS_HVP_HOST(CM)                                                   \
  case CM:                                                                   \
    if constexpr ((LaneMask<F>::value >> ilog2(CM)) & 1u) {                  \
      return host_cells<F, CM>(A, V, out, rows, starts, P, m, n, csize,      \
                               symmetric, k);                                \
    } else {                                                                 \
      return 1;                                                              \
    }
  switch (cmax) {
    CHESS_HVP_HOST(1)
    CHESS_HVP_HOST(2)
    CHESS_HVP_HOST(4)
    CHESS_HVP_HOST(8)
    CHESS_HVP_HOST(16)
    CHESS_HVP_HOST(32)
    CHESS_HVP_HOST(64)
    default:
      return 1;
  }
#undef CHESS_HVP_HOST
}

#endif  // __CUDACC__

}  // namespace chessfad
