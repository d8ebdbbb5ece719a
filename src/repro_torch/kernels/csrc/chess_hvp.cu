// chess_hvp: the paper's Fig. 2 L2 batched Hessian-vector product kernel,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/chess_hvp.py::chess_hvp_pallas.
// Computes out[m] = H_f(A[m]) @ V[m] for A, V of shape (m, n) on the
// flattened (row i, chunk start) cell list of
// core.api.chunk_pairs(n, csize, symmetric): every cell seeds di at i and
// the dj lanes at cstart..cstart+csize-1, evaluates f, and adds
// sum_l dij[l] * v[cstart+l] into out[i].  On the symmetric schedule a cell
// strictly right of the diagonal block also mirrors dij[l] * v[i] into
// out[cstart+l]; the mirror is chunk-granular (cstart > (i / csize) * csize),
// so the diagonal-block cell contributes all its valid columns directly,
// exactly as the reference does.
//
// Types.  A and V are float32, bfloat16 or float16 (one type, a runtime
// code): they are converted to float32 as they are staged, every operation
// is float32, and out is written in A's type, as the Pallas body does.  The
// constants are float32.
//
// Chunks wider than 64 lanes arrive as ceil(csize/64) sub-cells
// (kernels/chess_hvp.py::sub_cells), each with its own start `sub`; the
// chunk's start is (sub / csize) * csize and a sub-cell carries the lanes
// sub.. up to the chunk's end.  The mirror test uses the chunk's start, so it
// stays chunk-granular.  For csize <= 64 a sub-cell is the cell.
//
// The AD rule.  A cell is forward-mode AD on hDuals (hdual.cuh) and nothing
// else: every di, dj and dij lane of its result comes out of the hdual.cuh
// operators (+, -, constant scale, *, the sin/cos/exp/sqrt maps) applied to
// seeded hDuals.  What changed from the first version of this kernel is which
// coordinates carry hDuals.  Only the cell's active set S = {i} u {the
// carried columns < n} (|S| <= C+1) has nonzero seeds; every other
// coordinate is a constant, and operations on constants are float
// operations.  So a device form evaluates hDuals only for the coordinates of
// S (slot j < C: column sub+j; slot C: i when it is not a carried column,
// `active`), and folds the constants in as primal values.  Tables built once
// per instance hold primal values only, never a derivative:
//   Fletcher-Powell  sin a_k, cos a_k, and the primal residuals
//                    p_r = sum_k A[r,k] sin a_k + B[r,k] cos a_k - E_r;
//   Ackley           cos 2 pi a_k, sin 2 pi a_k, sum_k a_k^2 and
//                    sum_k cos 2 pi a_k;
//   Rosenbrock       none: the terms that touch no coordinate of S are
//                    constants that feed only the value, and the kernel
//                    reads only dij, so they are left out.
// A hoisted sum enters as constant(sum over all k - sum over k in S) plus the
// hDuals of S, or, for Fletcher-Powell, as constant(p_r) plus the tangents
// (the hDual with its value set to 0, `tangent`) of A[r,k] sin y_k and
// B[r,k] cos y_k for k in S.
//
// Thread mapping.  One CTA owns a few whole instances: it stages a[n], v[n],
// a zeroed output row and the primal tables of each in shared memory, runs
// the cells, and writes the rows once; the direct and mirrored terms meet in
// the shared row by shared atomicAdd, so the summation order varies between
// runs and tests hold the kernel to the plain version by tolerance.
// Per-instance rows are padded to an odd stride (n | 1) and the instance
// slots have an odd length, so 32 lanes that read one column of 32 rows, or
// one coordinate of 32 instances, hit 32 banks.
//   Rosenbrock, Ackley, and Fletcher-Powell up to C = 4: one thread per
//     (instance, cell), consecutive threads on the same cell of consecutive
//     instances (32 instances a CTA where shared memory allows), so the
//     loop over S has one trip count across the warp, every constant read
//     is a broadcast and the atomics of a warp go to 32 rows.  A
//     Fletcher-Powell thread holds the 2|S| tangents tangent(sin y_k),
//     tangent(cos y_k), k in S, in registers, computed once per cell, and
//     runs res_r = constant(p_r) + sum_{k in S} A[r,k] ts_k + B[r,k] tc_k
//     and acc += res_r * res_r over the n rows.
//   Fletcher-Powell from C = 8: the tangents are 2(C+1)(2C+1) floats, 306
//     at C = 8, past the 255 registers a thread has, so a group of G lanes
//     (16 at C = 8, 32 above) takes a cell.  The group computes the
//     tangents once per cell into its table in shared memory; each lane
//     takes rows r = glane, glane + G, ... (R = 64/G at a time up to
//     C = 16), builds res_r as above from broadcast table reads and
//     consecutive A^T/B^T column reads, and adds res_r * res_r into its
//     partial sum; the group adds its lanes' partial sums (their dij lanes,
//     the only ones read), and its first lane scatters the cell.
//     Same-call A/Bs of variant builds on the card chose this: a thread per
//     cell beat a warp per cell at C = 4 and lost to it at C = 8, where its
//     tangents spill; at C = 8 a half warp beat a warp and a quarter warp.
//   A^T and B^T (the wrapper passes A and B transposed) are staged once per
//   CTA in shared memory when they fit beside the tangent tables
//   (8 n (n|1) bytes: n <= 168 at C <= 4, 159 at C = 8, 153 at C = 16,
//   103 at C = 32, 55 at C = 64; kernels/chess_hvp.py::launch_config), and
//   read from global memory through the read-only cache otherwise.
// Shared memory.  The kernel opts into Hopper's dynamic shared memory, up to
// 227 KB a CTA (cudaFuncSetAttribute before every launch: the attribute
// belongs to the current device's context).  Per CTA: the staged matrices, ipb instance slots of 3, 5
// or 6 rows of n|1 floats (Rosenbrock, Ackley, Fletcher-Powell; Ackley 2
// more floats), and from C = 8 one Fletcher-Powell tangent table of 2(C+1)
// 16-byte-aligned hDuals per group.  The wrapper chooses ipb, the warps and
// the staging (kernels/chess_hvp.py::launch_config, shared_bytes) and
// passes the byte count; the entry point recomputes it from the same layout
// and refuses a launch on any difference.  The largest n one CTA takes
// (ipb = 1): Rosenbrock 19,369; Ackley 11,621; Fletcher-Powell 9,685 up to
// C = 4, then 9,565, 9,481, 8,937 and 6,825 at C = 8, 16, 32, 64 (the first
// version: 2,457 for every form).  The engine's `cuda` backend vetoes any n
// above these (kernels/ops.py::_cuda_supports).
//
// Why no tensor cores.  The first version evaluated Fletcher-Powell's two
// n x n constant mat-vecs on every lane of every coordinate's hDual in every
// cell, work a tensor-core product could have taken.  With the residuals
// hoisted per instance, a cell's mat-vec is n rows times |S| <= C+1
// coordinates against 2C+1 tangent lanes each: at n = 64, C = 4 a 64 x 10 by
// 10 x 9 product, too small and too ragged (|S| differs on the diagonal
// block, the rows are per lane) to fill a wgmma tile of 64 x N x 8, and its
// operands change every cell.  The FFMA pipes take it.
//
// What bounds it.  fp32 operations on the CUDA cores, not bytes: A, V and
// the output are 12 n bytes per instance in float32.  The count it is held
// to (kernels/chess_hvp.py::needed_cell_operations; FMA = 2; s = |S|):
//   Fletcher-Powell  s 2(4C+2) + n (s 2(4C+4) + (10C+4) + (2C+2)) + 3C
//                    per cell, 4n^2 + n per instance
//   Ackley           s (20C+12) + 24C+20 + 3C per cell, 4n per instance
//   Rosenbrock       |{k < n-1: k or k+1 in S}| (38C+21) + 3C per cell
// with a chunk wider than 64 lanes counted per sub-cell, at the width of its
// own columns, as it runs.
// At n = 64 that is 6-10x less than the dense count of the first version
// (`cell_operations`).  The Fletcher-Powell inner step, res += A ts + B tc,
// is 2(2C+2) FFMA per row for two broadcast reads (a thread's cell) or for
// 2(2C+2) floats of broadcast table read and two column reads (a group's);
// Ackley and Rosenbrock cells are short, so their seeding, scatter and
// atomics weigh as much as their arithmetic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py); no PyTorch headers, a plain C
//        entry point loaded with ctypes.  IEEE sinf/cosf/expf/sqrtf: no
//        --use_fast_math.
//
// The kernel template, the cell, its scatter and the launch live in
// chess_hvp.cuh, which the generated device forms of any hmath-written f
// (kernels/codegen.py) include too; this file holds the three hand-written
// forms and their C entry point.

#include "chess_hvp.cuh"

namespace chessfad {

// sum_{k<n-1} 100 (x_{k+1} - x_k^2)^2 + (1 - x_k)^2, the terms that touch S
struct Rosenbrock {
  static constexpr bool kOwnCells = false;
  static constexpr int kRows = 3, kScalars = 0;  // a, v, out

  __device__ static void table(float, float*, int, int) {}
  template <bool S>
  __device__ static void instance(float*, int, int, int, int, const float*,
                                  const float*, int, const float*) {}

  template <int C>
  __device__ static HDual<C> term(const float* a, int k, const Cell& c) {
    const HDual<C> yk = seed_at<C>(a, k, c);
    const HDual<C> yk1 = seed_at<C>(a, k + 1, c);
    const HDual<C> t1 = yk1 - yk * yk;
    const HDual<C> t2 = 1.f - yk;
    return t1 * t1 * 100.f + t2 * t2;
  }

  template <int C>
  __device__ static HDual<C> eval(const float* s, int, int n, const Cell& c) {
    HDual<C> acc = constant<C>(0.f);
    // the terms k = c0-1 .. c1-1 touch the carried columns [c0, c1)
    const int c0 = c.sub, c1 = min(c.sub + c.width, n);
    const int kend = min(c1 - 1, n - 2);
    for (int k = max(c0 - 1, 0); k <= kend; ++k) acc += term<C>(s, k, c);
    // and k = i-1, i touch i, where the run above does not hold them
    if (c.i < c0 || c.i >= c1) {
      if (c.i >= 1 && c.i != c1) acc += term<C>(s, c.i - 1, c);
      if (c.i <= n - 2 && c.i != c0 - 1) acc += term<C>(s, c.i, c);
    }
    return acc;
  }
};

// -20 exp(-0.2 sqrt(mean x^2)) - exp(mean cos(2 pi x)) + 20 + e
struct Ackley {
  static constexpr bool kOwnCells = false;
  // a, v, out, cos 2 pi a, sin 2 pi a; sum a^2 and sum cos 2 pi a
  static constexpr int kRows = 5, kScalars = 2;
  static constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);

  __device__ static void table(float a_k, float* s, int ld, int k) {
    const float z = a_k * kTwoPi;
    s[3 * ld + k] = cosf(z);
    s[4 * ld + k] = sinf(z);
  }

  template <bool S>
  __device__ static void instance(float* inst, int slot, int ld, int nin,
                                  int n, const float*, const float*, int,
                                  const float*) {
    for (int q = threadIdx.x; q < nin; q += blockDim.x) {
      float* s = inst + q * slot;
      float s1 = 0.f, s2 = 0.f;
      for (int k = 0; k < n; ++k) {
        s1 += s[k] * s[k];
        s2 += s[3 * ld + k];
      }
      s[5 * ld] = s1;
      s[5 * ld + 1] = s2;
    }
  }

  template <int C>
  __device__ static HDual<C> eval(const float* s, int ld, int n,
                                  const Cell& c) {
    const float* cz = s + 3 * ld;
    const float* sz = s + 4 * ld;
    HDual<C> q1 = constant<C>(0.f);  // sum over S of y_k^2
    HDual<C> q2 = constant<C>(0.f);  // sum over S of cos(2 pi y_k)
    float p1 = 0.f, p2 = 0.f;        // their primal values
    for (int j = 0; j <= C; ++j) {
      const int k = active<C>(j, c, n);
      if (k < 0) continue;
      const HDual<C> yk = seed_at<C>(s, k, c);
      q1 += yk * yk;
      q2 += cos(yk * kTwoPi, cz[k], sz[k]);
      p1 += s[k] * s[k];
      p2 += cz[k];
    }
    const float inv_n = 1.f / static_cast<float>(n);
    const HDual<C> s1 = (constant<C>(s[5 * ld] - p1) + q1) * inv_n;
    const HDual<C> s2 = (constant<C>(s[5 * ld + 1] - p2) + q2) * inv_n;
    return (exp(sqrt(s1) * -0.2f) * -20.f) - exp(s2) +
           static_cast<float>(20.0 + 2.718281828459045);
  }
};

// sum_r (sum_k A[r,k] sin x_k + B[r,k] cos x_k - E[r])^2; runs its own cells
struct FletcherPowell {
  static constexpr bool kOwnCells = true;
  // a, v, out, sin a, cos a, the primal residuals p
  static constexpr int kRows = 6, kScalars = 0;

  // lanes per cell: 1 (a thread, tangents in registers) up to 4 lanes,
  // then a group of 16 or 32 lanes with a tangent table in shared memory
  template <int C>
  __host__ __device__ static constexpr int group_lanes() {
    return C <= 4 ? 1 : (C <= 8 ? 16 : 32);
  }

  // floats of one warp's tangent tables: 2(C+1) aligned hDuals per group
  template <int C>
  __host__ __device__ static constexpr int table_floats() {
    return C <= 4 ? 0
                  : 32 / group_lanes<C>() * 2 * (C + 1) *
                        static_cast<int>(sizeof(SharedHDual<C>) / 4);
  }

  __device__ static void table(float a_k, float* s, int ld, int k) {
    s[3 * ld + k] = sinf(a_k);
    s[4 * ld + k] = cosf(a_k);
  }

  // p_r = (A sin a)_r + (B cos a)_r - E_r, a thread per (instance, r)
  template <bool S>
  __device__ static void instance(float* inst, int slot, int ld, int nin,
                                  int n, const float* At, const float* Bt,
                                  int lda, const float* E) {
    for (int t = threadIdx.x; t < nin * n; t += blockDim.x) {
      const int q = t / n;
      const int r = t - q * n;
      float* s = inst + q * slot;
      float sa = 0.f, sb = 0.f;
      for (int k = 0; k < n; ++k) {
        sa = fmaf(mat<S>(At, k * lda + r), s[3 * ld + k], sa);
        sb = fmaf(mat<S>(Bt, k * lda + r), s[4 * ld + k], sb);
      }
      s[5 * ld + r] = (sa + sb) - __ldg(E + r);
    }
  }

  template <int C, bool S>
  __device__ static void cells(float* inst, int slot, int ld, int nin,
                               float* tables, const int* rows,
                               const int* starts, int P, int n, int csize,
                               int symmetric, const float* At,
                               const float* Bt, int lda) {
    if constexpr (group_lanes<C>() == 1) {
      cells_by_thread<C, S>(inst, slot, ld, nin, rows, starts, P, n, csize,
                            symmetric, At, Bt, lda);
    } else {
      cells_by_group<C, S>(inst, slot, ld, nin, tables, rows, starts, P, n,
                           csize, symmetric, At, Bt, lda);
    }
  }

  // A thread per (instance, cell), consecutive threads on the same cell of
  // consecutive instances: the 2|S| tangents stay in registers and every
  // A^T/B^T read of a warp is a broadcast.
  template <int C, bool S>
  __device__ static void cells_by_thread(float* inst, int slot, int ld,
                                         int nin, const int* rows,
                                         const int* starts, int P, int n,
                                         int csize, int symmetric,
                                         const float* At, const float* Bt,
                                         int lda) {
    for (int w = threadIdx.x; w < nin * P; w += blockDim.x) {
      const int p = w / nin;
      const int q = w - p * nin;
      const Cell c = cell_at<C>(rows, starts, p, csize);
      float* s = inst + q * slot;
      const float* sn = s + 3 * ld;
      const float* cs = s + 4 * ld;
      const float* pr = s + 5 * ld;

      // the sin and cos hDuals of the coordinates of S, once per cell
      HDual<C> ts[C + 1], tc[C + 1];
      int ks[C + 1];
#pragma unroll
      for (int j = 0; j <= C; ++j) {
        ks[j] = active<C>(j, c, n);
        const int k = ks[j] < 0 ? c.i : ks[j];  // an empty slot is skipped
        const HDual<C> yk = seed_at<C>(s, k, c);
        ts[j] = tangent(sin(yk, sn[k], cs[k]));
        tc[j] = tangent(cos(yk, cs[k], sn[k]));
      }

      // res_r = p_r + sum_{k in S} A[r,k] ts_k + B[r,k] tc_k, squared
      HDual<C> acc = constant<C>(0.f);
      for (int r = 0; r < n; ++r) {
        HDual<C> res = constant<C>(pr[r]);
#pragma unroll
        for (int j = 0; j <= C; ++j) {
          if (ks[j] < 0) continue;
          res = res + ts[j] * mat<S>(At, ks[j] * lda + r) +
                tc[j] * mat<S>(Bt, ks[j] * lda + r);
        }
        acc += res * res;
      }
      scatter<C>(acc, s + ld, s + 2 * ld, c, n, csize, symmetric);
    }
  }

  // A group of G lanes per (instance, cell): the group's lanes compute the
  // tangents into its table in shared memory, then each lane takes rows
  // glane, glane + G, ... (R at a time) and the group adds its lanes'
  // partial sums.
  template <int C, bool S>
  __device__ static void cells_by_group(float* inst, int slot, int ld,
                                        int nin, float* tables,
                                        const int* rows, const int* starts,
                                        int P, int n, int csize,
                                        int symmetric, const float* At,
                                        const float* Bt, int lda) {
    constexpr int G = group_lanes<C>();
    constexpr int R = C <= 16 ? 64 / G : 1;  // rows a lane carries at once
    const int lane = threadIdx.x & 31;
    const int glane = lane & (G - 1);
    const int group = (threadIdx.x >> 5) * (32 / G) + lane / G;
    const int groups = (blockDim.x >> 5) * (32 / G);
    const unsigned mask =
        G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1u) << (lane - glane);
    SharedHDual<C>* T =
        reinterpret_cast<SharedHDual<C>*>(tables) + group * 2 * (C + 1);
    for (int w = group; w < nin * P; w += groups) {
      const int p = w / nin;
      const int q = w - p * nin;
      const Cell c = cell_at<C>(rows, starts, p, csize);
      float* s = inst + q * slot;
      const float* sn = s + 3 * ld;
      const float* cs = s + 4 * ld;
      const float* pr = s + 5 * ld;

      // the sin and cos hDuals of the coordinates of S, once per cell
      for (int j = glane; j <= C; j += G) {
        const int k = active<C>(j, c, n);
        if (k >= 0) {
          const HDual<C> yk = seed_at<C>(s, k, c);
          T[2 * j].h = tangent(sin(yk, sn[k], cs[k]));
          T[2 * j + 1].h = tangent(cos(yk, cs[k], sn[k]));
        }
      }
      __syncwarp(mask);

      // this lane's rows: res_r = p_r + sum_{k in S} A[r,k] ts_k + B[r,k] tc_k
      HDual<C> acc = constant<C>(0.f);
      for (int r0 = glane; r0 < n; r0 += G * R) {
        HDual<C> res[R];
#pragma unroll
        for (int t = 0; t < R; ++t) {
          res[t] = constant<C>(pr[min(r0 + G * t, n - 1)]);
        }
        for (int j = 0; j <= C; ++j) {
          const int k = active<C>(j, c, n);
          if (k < 0) continue;
          const float* Ak = At + k * lda;
          const float* Bk = Bt + k * lda;
#pragma unroll
          for (int t = 0; t < R; ++t) {
            const int r = min(r0 + G * t, n - 1);
            res[t] = res[t] + T[2 * j].h * mat<S>(Ak, r) +
                     T[2 * j + 1].h * mat<S>(Bk, r);
          }
        }
#pragma unroll
        for (int t = 0; t < R; ++t) {
          if (r0 + G * t < n) acc += res[t] * res[t];
        }
      }
      // the group's partial sums over their rows, added lane-wise
      group_sum_dij<G>(acc, mask);
      if (glane == 0) scatter<C>(acc, s + ld, s + 2 * ld, c, n, csize,
                                 symmetric);
      __syncwarp(mask);  // the table is rewritten by the next cell
    }
  }
};

}  // namespace chessfad

// Plain C entry point (loaded with ctypes).  dtype: 0 float32, 1 bfloat16,
// 2 float16, for A, V and out.  rows/starts: the P sub-cells.  fn:
// 0 rosenbrock, 1 ackley, 2 fletcher_powell.  cmax: the lane instantiation
// (a power of two in 1..64, >= csize unless it is 64 and the chunks come as
// sub-cells).  ipb: instances per CTA; warps: warps per CTA of a kOwnCells
// form (Fletcher-Powell), ignored otherwise; staged: Fletcher-Powell's
// matrices in shared memory; smem_bytes: the dynamic shared memory, which
// must equal this source's layout for these arguments.  cAt, cBt: A and B
// transposed.  Returns the first CUDA error of the shared-memory opt-in or
// of the launch (cudaGetLastError()); the launch is asynchronous on
// `stream`.
extern "C" int chess_hvp_launch(const void* A, const void* V, void* out,
                                int dtype, const int* rows,
                                const int* starts, int P, int m, int n,
                                int csize, int cmax, int symmetric, int fn,
                                int ipb, int warps, int staged,
                                long long smem_bytes, const float* cAt,
                                const float* cBt, const float* cE,
                                void* stream) {
  using namespace chessfad;
  const Consts consts{cAt, cBt, cE};
  cudaError_t err;
  switch (fn) {
    case 0:
      err = launch_entry<Rosenbrock>(A, V, out, dtype, rows, starts, P, m, n,
                                     csize, cmax, symmetric, ipb, warps,
                                     staged, smem_bytes, consts, stream);
      break;
    case 1:
      err = launch_entry<Ackley>(A, V, out, dtype, rows, starts, P, m, n,
                                 csize, cmax, symmetric, ipb, warps, staged,
                                 smem_bytes, consts, stream);
      break;
    case 2:
      err = launch_entry<FletcherPowell>(A, V, out, dtype, rows, starts, P, m,
                                         n, csize, cmax, symmetric, ipb,
                                         warps, staged, smem_bytes, consts,
                                         stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
