// hdual_linear: the fused hDual linear map Y[k] = X[k] @ W for all K2 stacked
// hDual components, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hdual_linear.py::hdual_linear_pallas
// (hdual_linear.py:44; its body _kernel at :27).  x is (K2, T, din), w is
// (din, dout), y is (K2, T, dout), all row-major; K2 = 2c+2 for an hDual of
// chunk size c, any K2 >= 1.  x and w are float32, bfloat16 or float16 of one
// type (the wrapper has cast w to x's type, as the reference's oracle does);
// every element is converted to float32 as it is staged, products are
// accumulated with IEEE float32 FFMA on the CUDA cores (no TF32, no tensor
// cores: the reference holds float32 at rtol 1e-5, atol 1e-5 * din), and y
// is written in x's type.
//
// The reference's idea, kept: a linear map acts on each hDual component
// alone, so all K2 products share one W.  The Pallas kernel loads each W
// tile once per grid cell and contracts every component against it with one
// batched dot_general.  Here a CTA owns kG = 2 components x kBT = 128 rows of
// T x kBN = 64 output columns.  Its loop over din takes kBK = 8 at a time:
// the W tile (kBK x kBN) is read from device memory once per CTA per k-step
// into shared memory, beside the x tiles of the CTA's components, and a
// component loop inside each thread contracts the same W fragment (read once
// from shared memory into registers) against the x rows of every component
// the CTA owns.  K2 x 128 x 8 floats of x would not fit in shared memory at
// K2 = 130, so components are split across CTAs in pairs (grid.z).  Blocks
// never share an output element, so the sum over din is a loop inside the
// CTA, in order, with no atomics.  Edges are masked (zero-filled loads,
// guarded stores), so any T, din, dout works; the reference's tile
// arguments (bt, bo, bk) are checked by the wrapper and not used here.
//
// Thread tile: 256 threads as 32 row groups x 8 column groups; a thread holds
// kG x 4 rows x 8 columns = 64 float32 sums (columns tc*4.. and 32+tc*4..,
// so a warp's float4 reads of the W tile are contiguous).  x tiles are
// stored transposed, (k, t), so a thread reads its 4 rows as one float4; a
// row stride of 132 floats makes a warp's transposed stores hit 32 banks.
// Global loads are staged through registers while the previous tile is
// computed (two shared buffers, one barrier per k-step).  The kernel is held
// to 128 registers, two CTAs per SM; a depth of 8 with the depth loop
// unrolled by 2 keeps its spills small, where a depth of 16 or a full unroll
// spill more and run slower.
//
// What bounds it.  Operations 2 K2 T din dout; bytes x, w and y once.  At the
// paper-scale shapes (K2 = 10 or 18, T = 524,288, din = dout = 64) that is
// 16 float32 operations per byte, under the card's 20 (67 TFLOP/s over
// 3.35 TB/s), so bytes bound it: each CTA reads its x rows once and all of
// dout fits one CTA (kBN = 64), so x is streamed from device memory once and
// y written once; W stays in L2.  In bfloat16 the same shapes carry 32
// operations per byte, so on the CUDA cores the FFMA rate bounds them too.
// At din = dout = 2560 the float32 FFMA rate bounds it; each depth step does
// 64 FFMA per thread per 4 float4 reads from shared memory.  Tensor cores
// (TF32 splits for float32, bf16/fp16 mma) are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py); no PyTorch headers, a plain C
//        entry point loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace hdual_linear {

constexpr int kThreads = 256;
constexpr int kG = 2;          // components per CTA
constexpr int kBT = 128;       // rows of T per component per CTA
constexpr int kBN = 64;        // output columns per CTA
constexpr int kBK = 8;         // depth of one k-step
constexpr int kXS = kBT + 4;   // row stride of a transposed x tile (float4-aligned)
constexpr int kTM = 4;         // rows per thread and component
constexpr int kTN = 8;         // columns per thread
constexpr int kXPer = kG * kBT * kBK / kThreads;  // x elements staged per thread
constexpr int kWPer = kBK * kBN / kThreads;       // w elements staged per thread
static_assert(kThreads == (kBT / kTM) * (kBN / kTN), "thread tile");
static_assert(kBN == 64 && kTN == 8, "column groups tc*4 and 32+tc*4");

// Element types (kernels/build.py::DTYPE_CODES).
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// Element e of a thread's staged x: component e / 4, row (e % 4) * 32 +
// tid / 8, depth tid % 8 -- a warp reads four rows of 8 consecutive k.
template <typename T>
__device__ __forceinline__ void load_tiles(const T* __restrict__ x,
                                           const T* __restrict__ w, int K2,
                                           int Tn, int din, int dout, int c0,
                                           int t0, int n0, int k0,
                                           float (&xr)[kXPer],
                                           float (&wr)[kWPer]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < kXPer; ++e) {
    const int idx = e * kThreads + tid;
    const int kk = idx % kBK;
    const int row = (idx / kBK) % kBT;
    const int c = c0 + idx / (kBK * kBT);
    const int t = t0 + row;
    const int k = k0 + kk;
    xr[e] = (c < K2 && t < Tn && k < din)
                ? to_f32(x[(static_cast<size_t>(c) * Tn + t) * din + k])
                : 0.f;
  }
#pragma unroll
  for (int e = 0; e < kWPer; ++e) {
    const int idx = e * kThreads + tid;
    const int k = k0 + idx / kBN;
    const int col = n0 + idx % kBN;
    wr[e] = (k < din && col < dout)
                ? to_f32(w[static_cast<size_t>(k) * dout + col])
                : 0.f;
  }
}

__device__ __forceinline__ void stash_tiles(float (*xs)[kBK][kXS],
                                            float (*ws)[kBN],
                                            const float (&xr)[kXPer],
                                            const float (&wr)[kWPer]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < kXPer; ++e) {
    const int idx = e * kThreads + tid;
    xs[idx / (kBK * kBT)][idx % kBK][(idx / kBK) % kBT] = xr[e];
  }
#pragma unroll
  for (int e = 0; e < kWPer; ++e) {
    const int idx = e * kThreads + tid;
    ws[idx / kBN][idx % kBN] = wr[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    hdual_linear_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ y, int K2, int Tn, int din, int dout) {
  __shared__ __align__(16) float xs[2][kG][kBK][kXS];
  __shared__ __align__(16) float ws[2][kBK][kBN];

  const int t0 = blockIdx.x * kBT;
  const int n0 = blockIdx.y * kBN;
  const int c0 = blockIdx.z * kG;
  const int tr = threadIdx.x / (kBN / kTN);  // rows tr*4 .. tr*4+3
  const int tc = threadIdx.x % (kBN / kTN);  // columns tc*4.., 32+tc*4..

  float acc[kG][kTM][kTN];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[g][i][j] = 0.f;

  float xr[kXPer], wr[kWPer];
  const int nk = (din + kBK - 1) / kBK;
  load_tiles(x, w, K2, Tn, din, dout, c0, t0, n0, 0, xr, wr);
  stash_tiles(xs[0], ws[0], xr, wr);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_tiles(x, w, K2, Tn, din, dout, c0, t0, n0, (kt + 1) * kBK, xr, wr);
    }
    // unrolled by 2, not 8: a full unroll hoists more fragment loads than
    // the 128 registers hold
#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 wa = *reinterpret_cast<const float4*>(&ws[cur][kk][tc * 4]);
      const float4 wb =
          *reinterpret_cast<const float4*>(&ws[cur][kk][32 + tc * 4]);
      const float wv[kTN] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      // the component loop: one W fragment, every component of the CTA
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 xa =
            *reinterpret_cast<const float4*>(&xs[cur][g][kk][tr * 4]);
        const float xv[kTM] = {xa.x, xa.y, xa.z, xa.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[g][i][j] = fmaf(xv[i], wv[j], acc[g][i][j]);
      }
    }
    // the other buffer was last read before the previous barrier
    if (more) stash_tiles(xs[cur ^ 1], ws[cur ^ 1], xr, wr);
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int c = c0 + g;
    if (c >= K2) break;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int t = t0 + tr * kTM + i;
      if (t >= Tn) break;
      T* yrow = y + (static_cast<size_t>(c) * Tn + t) * dout;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = n0 + (j < 4 ? tc * 4 + j : 32 + tc * 4 + j - 4);
        if (col < dout) yrow[col] = from_f32<T>(acc[g][i][j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int K2, int Tn,
                   int din, int dout, cudaStream_t stream) {
  const dim3 grid((Tn + kBT - 1) / kBT, (dout + kBN - 1) / kBN,
                  (K2 + kG - 1) / kG);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  hdual_linear_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      K2, Tn, din, dout);
  return cudaGetLastError();
}

}  // namespace hdual_linear

// Plain C entry point (loaded with ctypes).  dtype: 0 float32, 1 bfloat16,
// 2 float16, for x, w and y alike.  Returns cudaGetLastError() after the
// launch; the launch is asynchronous on `stream`.
extern "C" int hdual_linear_launch(const void* x, const void* w, void* y,
                                   int dtype, int K2, int Tn, int din,
                                   int dout, void* stream) {
  using namespace hdual_linear;
  if (K2 < 1 || Tn < 1 || din < 1 || dout < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = launch<float>(x, w, y, K2, Tn, din, dout, s);
      break;
    case kBF16:
      err = launch<__nv_bfloat16>(x, w, y, K2, Tn, din, dout, s);
      break;
    case kF16:
      err = launch<__half>(x, w, y, K2, Tn, din, dout, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
