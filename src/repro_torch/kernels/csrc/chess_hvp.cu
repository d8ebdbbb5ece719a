// chess_hvp: the paper's Fig. 2 L2 batched Hessian-vector product kernel,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/chess_hvp.py::chess_hvp_pallas.
// Computes out[m] = H_f(A[m]) @ V[m] for A, V of shape (m, n) on the
// flattened (row i, chunk start) cell list of
// core.api.chunk_pairs(n, csize, symmetric): every cell seeds an hDual over
// the n variables (di one-hot at i, dj lanes one-hot at cstart..cstart+csize-1),
// evaluates f, and adds sum_l dij[l] * v[cstart+l] into out[i].  On the
// symmetric schedule a cell strictly right of the diagonal block also
// mirrors dij[l] * v[i] into out[cstart+l]; the mirror is chunk-granular
// (cstart > (i / csize) * csize), so the diagonal-block cell contributes all
// its valid columns directly, exactly as the reference does.
//
// Types.  A and V are float32, bfloat16 or float16 (one type, a runtime
// code): they are converted to float32 as they are staged, every operation
// is float32, and out is written in A's type, as the Pallas body does
// (a_ref[...].astype(float32), out_dtype=A.dtype).  The constants are
// float32.
//
// Chunks wider than 64 lanes.  hDual<C> is instantiated up to C = 64 (wider
// ones spill).  A chunk of csize > 64 columns arrives as ceil(csize/64)
// sub-cells (kernels/chess_hvp.py::sub_cells), each with its own start
// `sub`; the chunk's start is (sub / csize) * csize, since chunks start on
// multiples of csize, and a sub-cell takes the lanes sub.. up to the chunk's
// end.  The mirror test uses the chunk's start, so it stays chunk-granular
// and no sub-cell mirrors inside the diagonal block.  Each sub-cell
// evaluates f again (val and di are recomputed); for csize <= 64 a sub-cell
// is the cell.
//
// Design.  The Pallas kernel carries the output row block in VMEM along a
// sequential cell axis.  CUDA blocks run in parallel and in no order, so
// here one CTA owns a few whole instances: it stages a[n], v[n] and a zeroed
// output row of each in shared memory, its threads stride over the
// (instance, cell) work items, each thread evaluates f on one cell with the
// hDual in registers (hdual.cuh) and adds its direct and mirrored terms into
// the shared row with shared atomicAdd; after a __syncthreads() the rows are
// written once.  The summation order therefore varies between runs; tests
// hold the kernel to the plain version by tolerance.  Instances are
// bound-checked and columns masked on col < n, so nothing is padded.
//
// What bounds it.  The work is fp32 arithmetic on the CUDA cores, not bytes:
// A, V and the output are 12 n bytes per instance in float32, while one cell
// of f needs (C lanes, FMA = 2 operations; chess_hvp.py::cell_operations)
//   rosenbrock       (n-1)(38C+21) + 3C
//   ackley           n(20C+12) + 24C+20 + 3C
//   fletcher_powell  2n(4C+2) + n^2(8C+8) + n(14C+9) + 3C
// and an instance runs num_chunk_evals(n, csize, symmetric) cells: at n=64,
// csize=4, symmetric (544 cells) Fletcher-Powell needs 1.7e5 operations per
// cell, 4.9e13 for 524,288 instances, against 0.4 GB of traffic.  So the
// design spends nothing on memory staging beyond one shared row per
// instance and aims at keeping the FP32 pipes busy: the hDual stays in
// registers (one instantiation per lane count C, every lane loop unrolled),
// device forms seed variables on the fly so live state is O(C) per thread,
// the primal transcendentals that every cell of an instance shares (sin and
// cos of each coordinate) are evaluated once per instance into shared
// memory, and the constant matrices are read through the read-only cache.
// The price of O(C) live state is paid by Fletcher-Powell: it maps the sin
// and cos hDuals of every coordinate once per output row, n^2 maps per cell
// where n are needed, which makes its cell n^2(16C+12) + n(14C+9) + 3C
// operations, 1.85x (C=4) to 1.89x (C=8) the count above at n=64.  Skipping the structural
// zeros of the one-hot seeds (which makes those maps nearly free), or
// moving the Fletcher-Powell mat-vecs onto tensor cores, is left for later
// work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py); no PyTorch headers, a plain C
//        entry point loaded with ctypes.  IEEE sinf/cosf/expf/sqrtf: no
//        --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hdual.cuh"

namespace chessfad {

constexpr int kThreads = 256;  // threads per CTA; kernels/chess_hvp.py::THREADS

struct Consts {
  const float* A;  // Fletcher-Powell A (n, n), row-major
  const float* B;  // Fletcher-Powell B (n, n), row-major
  const float* E;  // Fletcher-Powell E (n,)
};

// Each device form gives, per instance, a table of 2n primal values shared by
// all its cells (table()), and the hDual value of f on one cell (eval()).

// sum_{k<n-1} 100 (x_{k+1} - x_k^2)^2 + (1 - x_k)^2
struct Rosenbrock {
  static constexpr bool kTable = false;
  __device__ static void table(float, float*, int, int) {}

  template <int C>
  __device__ static HDual<C> eval(const float* a, const float*, int n, int i,
                                  int cstart, int csize, const Consts&) {
    HDual<C> acc = constant<C>(0.f);
    HDual<C> yk = seed<C>(a[0], 0, i, cstart, csize);
    for (int k = 0; k + 1 < n; ++k) {
      const HDual<C> yk1 = seed<C>(a[k + 1], k + 1, i, cstart, csize);
      const HDual<C> t1 = yk1 - yk * yk;
      const HDual<C> t2 = 1.f - yk;
      acc += t1 * t1 * 100.f + t2 * t2;
      yk = yk1;
    }
    return acc;
  }
};

// -20 exp(-0.2 sqrt(mean x^2)) - exp(mean cos(2 pi x)) + 20 + e
struct Ackley {
  static constexpr bool kTable = true;
  static constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);

  // tab[k] = cos(2 pi a_k), tab[n + k] = sin(2 pi a_k)
  __device__ static void table(float a_k, float* tab, int k, int n) {
    const float z = a_k * kTwoPi;
    tab[k] = cosf(z);
    tab[n + k] = sinf(z);
  }

  template <int C>
  __device__ static HDual<C> eval(const float* a, const float* tab, int n,
                                  int i, int cstart, int csize,
                                  const Consts&) {
    HDual<C> s1 = constant<C>(0.f);
    HDual<C> s2 = constant<C>(0.f);
    for (int k = 0; k < n; ++k) {
      const HDual<C> yk = seed<C>(a[k], k, i, cstart, csize);
      s1 += yk * yk;
      s2 += cos(yk * kTwoPi, tab[k], tab[n + k]);
    }
    const float inv_n = static_cast<float>(1.0 / n);
    s1 = s1 * inv_n;
    s2 = s2 * inv_n;
    return (exp(sqrt(s1) * -0.2f) * -20.f) - exp(s2) +
           static_cast<float>(20.0 + 2.718281828459045);
  }
};

// sum_r (sum_k A[r,k] sin x_k + B[r,k] cos x_k - E[r])^2, one output row r
// at a time so that only the two running sums are live
struct FletcherPowell {
  static constexpr bool kTable = true;

  // tab[k] = sin(a_k), tab[n + k] = cos(a_k)
  __device__ static void table(float a_k, float* tab, int k, int n) {
    tab[k] = sinf(a_k);
    tab[n + k] = cosf(a_k);
  }

  template <int C>
  __device__ static HDual<C> eval(const float* a, const float* tab, int n,
                                  int i, int cstart, int csize,
                                  const Consts& cs) {
    HDual<C> acc = constant<C>(0.f);
    for (int r = 0; r < n; ++r) {
      const float* Ar = cs.A + static_cast<size_t>(r) * n;
      const float* Br = cs.B + static_cast<size_t>(r) * n;
      HDual<C> s = constant<C>(0.f);
      HDual<C> c = constant<C>(0.f);
      for (int k = 0; k < n; ++k) {
        const HDual<C> yk = seed<C>(a[k], k, i, cstart, csize);
        s += sin(yk, tab[k], tab[n + k]) * __ldg(Ar + k);
        c += cos(yk, tab[n + k], tab[k]) * __ldg(Br + k);
      }
      const HDual<C> res = (s + c) - __ldg(cs.E + r);
      acc += res * res;
    }
    return acc;
  }
};

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

// Shared memory per instance slot: a[n], v[n], out[n] and, for device forms
// with a table, tab[2n].
__host__ __device__ inline int slot_floats(int n, bool table) {
  return (table ? 5 : 3) * n;
}

template <class F, int C>
__global__ void __launch_bounds__(kThreads)
    chess_hvp_kernel(const void* __restrict__ A, const void* __restrict__ V,
                     void* __restrict__ out, int dtype,
                     const int* __restrict__ rows,
                     const int* __restrict__ starts, int P, int m, int n,
                     int csize, int symmetric, int ipb, Consts consts) {
  extern __shared__ float smem[];
  const int slot = slot_floats(n, F::kTable);
  const int m0 = blockIdx.x * ipb;
  const int nin = min(ipb, m - m0);

  for (int t = threadIdx.x; t < nin * n; t += blockDim.x) {
    const int q = t / n;
    const int k = t - q * n;
    const size_t g = static_cast<size_t>(m0 + q) * n + k;
    float* s = smem + q * slot;
    const float a_k = load_f32(A, g, dtype);
    s[k] = a_k;
    s[n + k] = load_f32(V, g, dtype);
    s[2 * n + k] = 0.f;
    if (F::kTable) F::table(a_k, s + 3 * n, k, n);
  }
  __syncthreads();

  // consecutive threads take consecutive cells of one instance, so their
  // shared reads of a[k] are broadcasts
  for (int w = threadIdx.x; w < nin * P; w += blockDim.x) {
    const int q = w / P;
    const int p = w - q * P;
    const int i = __ldg(rows + p);
    const int sub = __ldg(starts + p);  // this sub-cell's first column
    // its chunk's first column and its lane count; below 64 lanes a sub-cell
    // is its whole chunk (csize <= C), and saying so at compile time keeps
    // the sub-cell arithmetic, and its registers, out of those instantiations
    const int cstart = C < 64 ? sub : (sub / csize) * csize;
    const int width = C < 64 ? csize : min(C, cstart + csize - sub);
    const float* s = smem + q * slot;
    const float* v = s + n;
    float* o = smem + q * slot + 2 * n;

    const HDual<C> r = F::template eval<C>(s, s + 3 * n, n, i, sub, width,
                                           consts);

    const bool mirror = symmetric && cstart > (i / csize) * csize;
    const float vi = v[i];
    float direct = 0.f;
#pragma unroll
    for (int l = 0; l < C; ++l) {
      const int col = sub + l;
      if (l < width && col < n) {
        direct += r.dij[l] * v[col];
        if (mirror) atomicAdd(o + col, r.dij[l] * vi);
      }
    }
    atomicAdd(o + i, direct);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < nin * n; t += blockDim.x) {
    const int q = t / n;
    const int k = t - q * n;
    store_as(out, static_cast<size_t>(m0 + q) * n + k, dtype,
             smem[q * slot + 2 * n + k]);
  }
}

template <class F, int C>
cudaError_t launch(const void* A, const void* V, void* out, int dtype,
                   const int* rows, const int* starts, int P, int m, int n,
                   int csize, int symmetric, int ipb, Consts consts,
                   cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((m + ipb - 1) / ipb);
  const size_t smem =
      static_cast<size_t>(ipb) * slot_floats(n, F::kTable) * sizeof(float);
  chess_hvp_kernel<F, C><<<grid, kThreads, smem, stream>>>(
      A, V, out, dtype, rows, starts, P, m, n, csize, symmetric, ipb, consts);
  return cudaGetLastError();
}

template <class F>
cudaError_t launch_lanes(int cmax, const void* A, const void* V, void* out,
                         int dtype, const int* rows, const int* starts, int P,
                         int m, int n, int csize, int symmetric, int ipb,
                         Consts consts, cudaStream_t stream) {
#define CHESS_HVP_CASE(CM)                                                 \
  case CM:                                                                 \
    return launch<F, CM>(A, V, out, dtype, rows, starts, P, m, n, csize,   \
                         symmetric, ipb, consts, stream);
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

}  // namespace chessfad

// Plain C entry point (loaded with ctypes).  dtype: 0 float32, 1 bfloat16,
// 2 float16, for A, V and out.  rows/starts: the P sub-cells.  fn:
// 0 rosenbrock, 1 ackley, 2 fletcher_powell.  cmax: the lane instantiation
// (a power of two in 1..64, >= csize unless it is 64 and the chunks come as
// sub-cells).  ipb: instances per CTA.  Returns cudaGetLastError() after
// the launch; the launch is asynchronous on `stream`.
extern "C" int chess_hvp_launch(const void* A, const void* V, void* out,
                                int dtype, const int* rows,
                                const int* starts, int P, int m, int n,
                                int csize, int cmax, int symmetric, int fn,
                                int ipb, const float* cA, const float* cB,
                                const float* cE, void* stream) {
  using namespace chessfad;
  if (csize < 1 || (csize > cmax && cmax != 64) || m < 1 || n < 1 || P < 1 ||
      ipb < 1 || dtype < kF32 || dtype > kF16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Consts consts{cA, cB, cE};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fn) {
    case 0:
      err = launch_lanes<Rosenbrock>(cmax, A, V, out, dtype, rows, starts, P,
                                     m, n, csize, symmetric, ipb, consts, s);
      break;
    case 1:
      err = launch_lanes<Ackley>(cmax, A, V, out, dtype, rows, starts, P, m, n,
                                 csize, symmetric, ipb, consts, s);
      break;
    case 2:
      err = launch_lanes<FletcherPowell>(cmax, A, V, out, dtype, rows, starts,
                                         P, m, n, csize, symmetric, ipb,
                                         consts, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
