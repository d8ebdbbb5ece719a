// hdual_linear: the fused hDual linear map Y[k] = X[k] @ W for every hDual
// component, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hdual_linear.py::hdual_linear_pallas
// (hdual_linear.py:44; its body _kernel at :27).  W is (din, dout); the
// components come as up to four operand groups (struct Group below), each
// ncomp components of npoints rows of din, at any strides: the stacked
// (K2, T, din) of kernels.ops.hdual_linear is one group of K2, and
// hdual_linear_apply passes an HDual's val, di (T, din) and dj, dij
// (T, din, c) as four groups read where they lie, with outputs written in
// the same layout.  x, w and y are float32, bfloat16 or float16 of one type;
// sums are float32 and y is written in x's type, rounded once.
//
// The reference's idea, kept: a linear map acts on each component alone, so
// every component is contracted against the same W.  The Pallas kernel
// loads each W tile once per grid cell and contracts all components against
// it; here the components are folded into the rows (M) of one GEMM, so each
// W tile in shared memory is reused by every component row of a tile.
//
// Two variants, chosen by the wrapper from shapes, strides and alignment
// (kernels/hdual_linear.py::choose_variant):
//
// * wgmma (tc::kernel): tensor cores.  A group whose components are
//   interleaved per point (element (point, d, k) at (point*din + d)*cc + k;
//   cc = 1 for val, di and the stacked x, cc = c for dj, dij) is a matrix of
//   npoints*cc rows.  A tile is 128 rows (P = 128/cc whole points) by BN
//   columns of dout (64 for dout <= 64; else 128, or 256 for 16-bit past
//   128).  CTAs are persistent, one per SM, walking the tiles columns
//   fastest.  Warpgroup 2 produces: one thread keeps a ring of 3-8 stages
//   (mbarriers) of TMA loads in flight, 128-byte swizzled: the A box (128
//   bytes of depth, cc, P points) and the W tile; W is loaded once per CTA
//   when it fits the ring whole (dout <= BN), as at the paper's shapes.
//   Warpgroups 0-1 consume, 64 rows each, with 232 registers (setmaxnreg):
//   they build A fragments in registers from the staged box (a dj row's
//   depth is strided by cc, so A cannot be read by descriptor), the next
//   stage's into a second register buffer while the current stage's
//   wgmmas run, and issue wgmma with B, W transposed to K-major by a first
//   small kernel (prep_w_kernel), read from shared memory.
//   bfloat16/float16: m64nBNk16, float32 sums in registers.  float32:
//   3xTF32, m64nBNk8 on a split big = rna_tf32(v), small =
//   rna_tf32(v - big) of both operands (prep_w_kernel splits W), summing
//   small*W_big + big*W_small + big*W_big.  The tensor cores do not round
//   their float32 sums to nearest, so each stage's 12 products are summed
//   apart and added to the running sum with an IEEE add (retire).
//   Epilogue: straight from registers, a warp writing whole 32-byte
//   sectors, except 16-bit tiles of one component a point, which go
//   through shared memory and 16-byte stores.
// * simt (simt::kernel): the kernel's first design, float32 FFMA on the
//   CUDA cores, for shapes and views TMA cannot take (din not a multiple
//   of 128 bytes, dout not a multiple of 8, strided or misaligned views).
//
// What bounds it.  Operations 2 K2 T din dout, bytes x, w and y once.  At
// the paper's shapes (K2 = 10 or 18, T = 524,288, din = dout = 64) bytes
// bound every type: float32 carries 16 operations per byte, under the TF32
// tensor cores' 148 (495 TFLOP/s over 3.35 TB/s) even tripled, and only x
// streams in and y out, with W resident.  At din = dout = 2560 operations
// bound it: bfloat16 by the 989 TFLOP/s tensor cores, float32 by the
// 3xTF32 route (three TF32 products at 495 TFLOP/s: 165 TFLOP/s of float32
// work, 2.5x the 67 TFLOP/s of FFMA).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py); no PyTorch headers and no
//        -lcuda: the TMA descriptors are encoded through the runtime's
//        driver entry point.  A plain C entry point loaded with ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace hdual_linear {

// Element types (kernels/build.py::DTYPE_CODES) and variants
// (kernels/hdual_linear.py::VARIANTS).
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Variant { kSimt = 0, kWgmma = 1 };
constexpr int kMaxGroups = 4;

// One operand group (kernels/hdual_linear.py::_CGroup): ncomp components of
// npoints rows.  Element (component k, row t, depth d) of the input is at
// in + k*in_comp + t*in_row + d*in_d, and (k, t, column o) of the output at
// out + k*out_comp + t*out_row + o*out_o, strides in elements.
struct Group {
  const void* in;
  void* out;
  long long ncomp, npoints;
  long long in_comp, in_row, in_d;
  long long out_comp, out_row, out_o;
};

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

// ---------------------------------------------------------------------------
// simt: float32 FFMA on the CUDA cores, reading the groups at their strides
// ---------------------------------------------------------------------------
//
// A CTA owns kG = 2 components x kBT = 128 rows x kBN = 64 output columns.
// Its loop over din takes kBK = 8 at a time: the W tile (kBK x kBN) goes to
// shared memory once per CTA and k-step, beside the x tiles of the CTA's
// components, and a component loop inside each thread contracts the same W
// fragment against the rows of both components.  256 threads as 32 row
// groups x 8 column groups; a thread holds kG x 4 rows x 8 columns = 64
// float32 sums.  x tiles are stored transposed, (k, t), row stride 132
// floats.  Global loads are staged through registers while the previous
// tile is computed (two shared buffers, one barrier per k-step), 128
// registers, two CTAs per SM.  Every group must have the same npoints (T).
namespace simt {

constexpr int kThreads = 256;
constexpr int kG = 2;          // components per CTA
constexpr int kBT = 128;       // rows of T per component per CTA
constexpr int kBN = 64;        // output columns per CTA
constexpr int kBK = 8;         // depth of one k-step
constexpr int kXS = kBT + 4;   // row stride of a transposed x tile
constexpr int kTM = 4;         // rows per thread and component
constexpr int kTN = 8;         // columns per thread
constexpr int kXPer = kBT * kBK / kThreads;   // x elements per component
constexpr int kWPer = kBK * kBN / kThreads;   // w elements staged per thread
static_assert(kThreads == (kBT / kTM) * (kBN / kTN), "thread tile");
static_assert(kBN == 64 && kTN == 8, "column groups tc*4 and 32+tc*4");

struct Groups {
  Group g[kMaxGroups];
  int n;
};

// Where component slot g of the CTA reads and writes (ok false past the
// last component).
template <typename T>
struct Slot {
  const T* in;
  T* out;
  long long in_row, in_d, out_row, out_o;
  int ok;
};

template <typename T>
__device__ __forceinline__ Slot<T> find_slot(const Groups& gs, long long c) {
  Slot<T> s{nullptr, nullptr, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) {
    if (i < gs.n && !s.ok && c >= 0) {
      const Group& g = gs.g[i];
      if (c < g.ncomp) {
        s.in = static_cast<const T*>(g.in) + c * g.in_comp;
        s.out = static_cast<T*>(g.out) + c * g.out_comp;
        s.in_row = g.in_row;
        s.in_d = g.in_d;
        s.out_row = g.out_row;
        s.out_o = g.out_o;
        s.ok = 1;
      }
      c -= g.ncomp;
    }
  }
  return s;
}

// Element e of a component's staged x: row (e * 256 + tid) / 8, depth
// tid % 8 -- a warp reads four rows of 8 consecutive k.
template <typename T>
__device__ __forceinline__ void load_tiles(const Slot<T> (&sl)[kG],
                                           const T* __restrict__ w, int Tn,
                                           int din, int dout, int t0, int n0,
                                           int k0, float (&xr)[kG][kXPer],
                                           float (&wr)[kWPer]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int e = 0; e < kXPer; ++e) {
      const int idx = e * kThreads + tid;
      const int t = t0 + idx / kBK;
      const int k = k0 + idx % kBK;
      xr[g][e] = (sl[g].ok && t < Tn && k < din)
                     ? to_f32(sl[g].in[t * sl[g].in_row + k * sl[g].in_d])
                     : 0.f;
    }
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
                                            const float (&xr)[kG][kXPer],
                                            const float (&wr)[kWPer]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int e = 0; e < kXPer; ++e) {
      const int idx = e * kThreads + tid;
      xs[g][idx % kBK][idx / kBK] = xr[g][e];
    }
  }
#pragma unroll
  for (int e = 0; e < kWPer; ++e) {
    const int idx = e * kThreads + tid;
    ws[idx / kBN][idx % kBN] = wr[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    kernel(const Groups gs, const T* __restrict__ w, int Tn, int din,
           int dout) {
  __shared__ __align__(16) float xs[2][kG][kBK][kXS];
  __shared__ __align__(16) float ws[2][kBK][kBN];

  const int t0 = blockIdx.x * kBT;
  const int n0 = blockIdx.y * kBN;
  const long long c0 = static_cast<long long>(blockIdx.z) * kG;
  const int tr = threadIdx.x / (kBN / kTN);  // rows tr*4 .. tr*4+3
  const int tc = threadIdx.x % (kBN / kTN);  // columns tc*4.., 32+tc*4..
  Slot<T> sl[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) sl[g] = find_slot<T>(gs, c0 + g);

  float acc[kG][kTM][kTN];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[g][i][j] = 0.f;

  float xr[kG][kXPer], wr[kWPer];
  const int nk = (din + kBK - 1) / kBK;
  load_tiles(sl, w, Tn, din, dout, t0, n0, 0, xr, wr);
  stash_tiles(xs[0], ws[0], xr, wr);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_tiles(sl, w, Tn, din, dout, t0, n0, (kt + 1) * kBK, xr, wr);
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
    if (!sl[g].ok) continue;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int t = t0 + tr * kTM + i;
      if (t >= Tn) break;
      T* yrow = sl[g].out + t * sl[g].out_row;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = n0 + (j < 4 ? tc * 4 + j : 32 + tc * 4 + j - 4);
        if (col < dout) yrow[col * sl[g].out_o] = from_f32<T>(acc[g][i][j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Group* groups, int ngroups, const void* w, int din,
                   int dout, cudaStream_t stream) {
  Groups gs{};
  long long K2 = 0;
  const long long Tn = groups[0].npoints;
  for (int i = 0; i < ngroups; ++i) {
    if (groups[i].npoints != Tn || groups[i].ncomp < 1) {
      return cudaErrorInvalidValue;
    }
    gs.g[i] = groups[i];
    K2 += groups[i].ncomp;
  }
  gs.n = ngroups;
  const dim3 grid(static_cast<unsigned>((Tn + kBT - 1) / kBT),
                  (dout + kBN - 1) / kBN,
                  static_cast<unsigned>((K2 + kG - 1) / kG));
  if (Tn > 0x7fffffffLL || grid.y > 65535 || grid.z > 65535) {
    return cudaErrorInvalidValue;
  }
  kernel<T><<<grid, kThreads, 0, stream>>>(gs, static_cast<const T*>(w),
                                           static_cast<int>(Tn), din, dout);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma: tensor cores through TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kConsumerWarps = 8;  // warpgroups 0 and 1: 64 rows each
constexpr int kThreads = 384;      // + warpgroup 2, the producer
constexpr int kProducerRegs = 40;  // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs = 232; //   <= 65,536 registers
constexpr int kRows = 128;         // rows of a tile
constexpr int kRowBytes = 128;     // one row of the 128-byte swizzle
constexpr int kATile = kRows * kRowBytes;   // 16 KB of A per stage
constexpr int kSmemBudget = 220 * 1024;     // of the 227 KB a CTA may use
// a wait that outlasts this is a fault: trap rather than hang the card
constexpr unsigned long long kWatchdogNs = 20ull * 1000 * 1000 * 1000;

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int kE = 32;      // elements per 128-byte row
  static constexpr int kStep = 8;    // depth of one wgmma
  static constexpr int kParts = 2;   // W as TF32 big and small
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kE = 64;
  static constexpr int kStep = 16;
  static constexpr int kParts = 1;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Traits<__half> {
  static constexpr int kE = 64;
  static constexpr int kStep = 16;
  static constexpr int kParts = 1;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// Shared memory: the ring, as many stages of A and W tiles as the budget
// holds after the output stage (4 for float32 at BN = 128, 8 for 16-bit at
// BN = 64), then the output stage, and slack to align the ring to 1024
// bytes (the swizzle repeats every 8 rows of 128 bytes).  The output stage,
// 16 bytes a row longer than the tile's row so that the writes of a warp
// spread over the banks, serves 16-bit tiles of one component a point at
// BN = 64: their direct stores would write 16 bytes a row, half a sector.
// Every other tile stores from registers, whole sectors a warp.
template <typename T, int BN>
struct Smem {
  static constexpr bool kStaged = BN == 64 && sizeof(T) == 2;
  static constexpr int kBStage = BN * kRowBytes * Traits<T>::kParts;
  static constexpr int kOut =
      kStaged ? kRows * (BN * static_cast<int>(sizeof(T)) + 16) : 0;
  static constexpr int kStages = (kSmemBudget - kOut) / (kATile + kBStage);
  static constexpr int kBytes = kStages * (kATile + kBStage) + kOut + 1024;
};

// A group as the tensor-core kernel sees it: npoints points of cc
// interleaved components, element (point, d, k) at (point*din + d)*cc + k
// of the input and (point, o, k) at (point*dout + o)*cc + k of the output.
struct TileGroup {
  void* out;
  long long npoints;
  int tile_begin;         // index of the group's first tile
  int cc;                 // components per point
  int P;                  // points per tile, 128 / cc
};

struct Params {
  CUtensorMap a[kMaxGroups];   // input of each group: (E, din*cc/E, npoints)
  CUtensorMap b;               // W prepared: (din, dout, parts), K-major
  TileGroup g[kMaxGroups];
  int ntiles;
  int ngroups, din, dout;
  int nk;                      // k-stages per tile: din / E
  int ntiles_n;                // column tiles: ceil(dout / BN)
  int resident;                // W loaded once per CTA, not per stage
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of the given parity to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try_wait(addr, parity)) {
    if (globaltimer() - t0 > kWatchdogNs) __trap();
  }
}

// TMA: a 3-D box of `map` at coordinates (c0, c1, c2), innermost first, into
// shared memory at dst; completion counted in bytes on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a K-major operand in 128-byte-swizzled rows: 8 rows
// (1024 bytes) apart per core matrix group (SBO), leading offset unused.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// float32 rounded to TF32 (10 mantissa bits), to nearest, ties away
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// m64 x N x k wgmma, D (float32, registers) = A (registers) * B (shared
// memory, K-major, descriptor) + (scale_d ? D : 0).  Fragments: thread
// (warp w, lane l) holds rows 16w + l/4 and 16w + l/4 + 8; A registers and
// D pairs as in mma.m16n8k16 (16-bit) and mma.m16n8k8 (tf32).
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_f16_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_f16_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_f16_n256(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <typename T>
struct Mma;
template <>
struct Mma<float> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    wgmma_tf32_n64(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    wgmma_tf32_n128(d, a, b, scale_d);
  }
};
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    wgmma_bf16_n64(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    wgmma_bf16_n128(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void run(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    wgmma_bf16_n256(d, a, b, scale_d);
  }
};
template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    wgmma_f16_n64(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    wgmma_f16_n128(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void run(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    wgmma_f16_n256(d, a, b, scale_d);
  }
};

// Byte offset in an A stage of element (tile row, depth col), for a row of
// point p (smem rows p*cc .. p*cc + cc - 1 hold its box) and component k:
// e = col*cc + k of the point's staged run of E*cc elements lies in smem
// row p*cc + e / E, column e % E, with 16-byte chunks swizzled by the row's
// low 3 bits as TMA's 128-byte swizzle lays them.
template <typename T>
__device__ __forceinline__ uint32_t a_offset(int p, int k, int col, int cc) {
  constexpr uint32_t kE = Traits<T>::kE;
  constexpr uint32_t kPer = 16 / sizeof(T);   // elements per 16-byte chunk
  const uint32_t e = static_cast<uint32_t>(col * cc + k);
  const uint32_t row = static_cast<uint32_t>(p * cc) + e / kE;
  const uint32_t c = e % kE;
  return row * kRowBytes + ((((c / kPer) ^ (row & 7)) << 4) |
                            ((c % kPer) * static_cast<uint32_t>(sizeof(T))));
}

// Where a consumer thread's A fragments lie in every stage of a tile.
// Register i of wgmma step s holds the thread's row r0 + 8*(i & 1) (of
// point p[i & 1], component k[i & 1]) at depth 8s + t4 + 4*(i >> 1) for
// tf32 (mma.m16n8k8's A layout), and depths c, c + 1 with
// c = 16s + 2*t4 + 8*(i >> 1) for 16-bit (mma.m16n8k16's), the lower depth
// in the low half.  The pattern is the same in every stage and depends on
// cc alone, so it is computed when the tile's group changes.
template <typename T>
struct Frags {
  static constexpr int kSteps = Traits<T>::kE / Traits<T>::kStep;
  static constexpr int kHalves = sizeof(T) == 4 ? 1 : 2;
  uint32_t off[kSteps][4][kHalves];

  __device__ __forceinline__ void locate(const int (&p)[2], const int (&k)[2],
                                         int cc, int t4) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          const int col = kHalves == 1
                              ? s * 8 + t4 + 4 * (i >> 1)
                              : s * 16 + 2 * t4 + 8 * (i >> 1) + h;
          off[s][i][h] = a_offset<T>(p[i & 1], k[i & 1], col, cc);
        }
      }
    }
  }
};

// A consumer warpgroup's A fragments of one stage, in registers: float32
// as TF32 big and small parts, 16-bit as packed pairs.
template <typename T>
struct Stage {
  static constexpr int kSteps = Frags<T>::kSteps;
  uint32_t a[kSteps][4];
  uint32_t small[Traits<T>::kParts == 2 ? kSteps : 1][4];

  // read from the staged A box (float32: and split)
  __device__ __forceinline__ void load(const uint8_t* base, const Frags<T>& fr,
                                       int cc) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (Traits<T>::kParts == 2) {
          const float v =
              *reinterpret_cast<const float*>(base + fr.off[s][i][0]);
          a[s][i] = tf32_rna(v);
          small[s][i] = tf32_rna(v - __uint_as_float(a[s][i]));
        } else if (cc == 1) {   // the two depths are adjacent: one load
          a[s][i] = *reinterpret_cast<const uint32_t*>(base + fr.off[s][i][0]);
        } else {
          const uint32_t lo =
              *reinterpret_cast<const uint16_t*>(base + fr.off[s][i][0]);
          const uint32_t hi =
              *reinterpret_cast<const uint16_t*>(base + fr.off[s][i][1]);
          a[s][i] = lo | (hi << 16);
        }
      }
    }
  }

  // issue the stage's wgmmas against its W at shared address b (float32:
  // into part, the stage's own sum)
  template <int BN>
  __device__ __forceinline__ void issue(float (&acc)[BN / 2],
                                        float (&part)[BN / 2],
                                        uint32_t b) const {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (Traits<T>::kParts == 2) {
        const uint64_t wbig = make_desc(b + s * 32);
        const uint64_t wsmall = make_desc(b + BN * kRowBytes + s * 32);
        Mma<T>::run(part, small[s], wbig, s > 0);
        Mma<T>::run(part, a[s], wsmall, 1);
        Mma<T>::run(part, a[s], wbig, 1);
      } else {
        Mma<T>::run(acc, a[s], make_desc(b + s * 32), 1);
      }
    }
    wgmma_commit();
  }
};

// Finish a stage's wgmmas.  float32 (3xTF32): the tensor cores do not
// round their float32 sums to nearest; summed in one accumulator over 2560
// of depth (960 wgmma adds), the error on an H100 grew with the depth past
// the full-width bound of chip_smoke.py.  Each stage's 12 products are
// therefore summed apart in `part` and added to acc with an IEEE add.
template <typename T, int BN>
__device__ __forceinline__ void retire(float (&acc)[BN / 2],
                                       float (&part)[BN / 2]) {
  wgmma_wait_all();
  if constexpr (Traits<T>::kParts == 2) {
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  } else {
    fence_acc(acc);
  }
}

__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0,
                                           float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(__half* p, float v0, float v1) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v0, v1);
}

// A barrier of the two consumer warpgroups alone (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerWarps * 32) : "memory");
}

// The group, its TMA map and the (row tile, column tile) of a tile index.
__device__ __forceinline__ void locate(const Params& p, int tile,
                                       TileGroup& tg,
                                       const CUtensorMap*& amap, int& mt,
                                       int& nt) {
  int gi = 0;
#pragma unroll
  for (int i = 1; i < kMaxGroups; ++i) {
    if (i < p.ngroups && tile >= p.g[i].tile_begin) gi = i;
  }
  tg = p.g[0];
  amap = &p.a[0];
#pragma unroll
  for (int i = 1; i < kMaxGroups; ++i) {
    if (i == gi) {
      tg = p.g[i];
      amap = &p.a[i];
    }
  }
  const int local = tile - tg.tile_begin;
  mt = p.ntiles_n == 1 ? local : local / p.ntiles_n;
  nt = local - mt * p.ntiles_n;
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __grid_constant__ Params p) {
  constexpr int kE = Traits<T>::kE;
  constexpr int kBStage = Smem<T, BN>::kBStage;
  constexpr int kStages = Smem<T, BN>::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], wbar;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* a_ring = smem;                       // kStages x kATile
  uint8_t* b_ring = smem + kStages * kATile;    // kStages x kBStage
  uint8_t* o_stage = b_ring + kStages * kBStage;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(&wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kConsumerWarps || lane != 0) return;
    // producer: W once if it fits the ring whole, then A (and W) per stage
    if (p.resident) {
      mbar_expect_tx(&wbar, p.nk * kBStage);
      for (int s = 0; s < p.nk; ++s) {
        tma_load_3d(b_ring + s * kBStage, &p.b, &wbar, s * kE, 0, 0);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
      TileGroup tg;
      const CUtensorMap* amap;
      int mt, nt;
      locate(p, tile, tg, amap, mt, nt);
      const uint32_t abytes = kRowBytes * tg.cc * tg.P;
      for (int ks = 0; ks < p.nk; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], abytes + (p.resident ? 0 : kBStage));
        tma_load_3d(a_ring + stage * kATile, amap, &full[stage], 0,
                    ks * tg.cc, static_cast<int>(mt * tg.P));
        if (!p.resident) {
          tma_load_3d(b_ring + stage * kBStage, &p.b, &full[stage], ks * kE,
                      nt * BN, 0);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup warp / 4 owns rows 64 * (warp / 4) .. + 63; a
  // thread owns rows r0 and r0 + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int t4 = lane % 4;
  const int r0 = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  Frags<T> fr;
  int frag_cc = 0, pp[2] = {0, 0}, kk[2] = {0, 0};
  bool in_tile[2] = {false, false};
  if (p.resident) mbar_wait(&wbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    TileGroup tg;
    const CUtensorMap* amap;
    int mt, nt;
    locate(p, tile, tg, amap, mt, nt);
    const int cc = tg.cc;
    if (cc != frag_cc) {   // the rows' places in a stage depend on cc only
      frag_cc = cc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int R = r0 + 8 * h;
        in_tile[h] = R < cc * tg.P;
        pp[h] = in_tile[h] ? R / cc : 0;   // rows past the tile read point 0
        kk[h] = in_tile[h] ? R - pp[h] * cc : 0;
      }
      fr.locate(pp, kk, cc, t4);
    }
    // the thread's output rows: point, component, and where they start
    const long long pt0 = static_cast<long long>(mt) * tg.P;
    T* rowp[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ok[h] = in_tile[h] && pt0 + pp[h] < tg.npoints;
      rowp[h] = static_cast<T*>(tg.out) + (pt0 + pp[h]) * p.dout * cc + kk[h];
    }
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    fence_acc(acc);
    // the k-loop: stage ks's wgmmas run while stage ks + 1's fragments are
    // read into the other register buffer (two buffers, named, so that
    // they stay registers)
    Stage<T> buf0, buf1;
    const auto step = [&](const Stage<T>& cur, Stage<T>& next, int ks) {
      cur.template issue<BN>(
          acc, part, smem_u32(b_ring + (p.resident ? ks : stage) * kBStage));
      const int done = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      if (ks + 1 < p.nk) {
        mbar_wait(&full[stage], phase);
        next.load(a_ring + stage * kATile, fr, cc);
      }
      retire<T, BN>(acc, part);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[done]);
    };
    mbar_wait(&full[stage], phase);
    buf0.load(a_ring + stage * kATile, fr, cc);
    for (int ks = 0; ks < p.nk; ks += 2) {
      step(buf0, buf1, ks);
      if (ks + 1 < p.nk) step(buf1, buf0, ks + 1);
    }
    // epilogue: acc[4j + 2h + {0, 1}] is row r0 + 8h, columns
    // nt*BN + 8j + 2*t4 + {0, 1}
    if (Smem<T, BN>::kStaged && cc == 1) {
      // through shared memory, row R of the tile at R * srow, then 16-byte
      // stores of whole rows
      constexpr int srow = BN * sizeof(T) + 16;
      consumers_sync();   // the previous tile's copy has read the stage
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!in_tile[h]) continue;
          store_pair(reinterpret_cast<T*>(o_stage + pp[h] * srow) + 8 * j +
                         2 * t4,
                     acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      consumers_sync();
      const long long np_left = tg.npoints - pt0;
      const int np = np_left < tg.P ? static_cast<int>(np_left) : tg.P;
      const int cols = p.dout - nt * BN < BN ? p.dout - nt * BN : BN;
      const int nvec = cols * static_cast<int>(sizeof(T)) / 16;
      uint8_t* gout = static_cast<uint8_t*>(tg.out) +
                      (pt0 * p.dout + nt * BN) * sizeof(T);
      const long long grow = static_cast<long long>(p.dout) * sizeof(T);
      for (int v = threadIdx.x; v < np * nvec; v += kConsumerWarps * 32) {
        const int pv = v / nvec, q = v - pv * nvec;
        *reinterpret_cast<uint4*>(gout + pv * grow + q * 16) =
            *reinterpret_cast<const uint4*>(o_stage + pv * srow + q * 16);
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int o = nt * BN + 8 * j + 2 * t4;
        if (o >= p.dout) continue;     // dout % 8 == 0: the pair is whole
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!ok[h]) continue;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          T* dst = rowp[h] + o * cc;
          if (cc == 1) {
            store_pair(dst, v0, v1);
          } else {
            dst[0] = from_f32<T>(v0);
            dst[cc] = from_f32<T>(v1);
          }
        }
      }
    }
  }
}

// W (din, dout) -> wt (parts, dout, din): transposed to K-major, and for
// float32 split into TF32 big and small parts.
template <typename T>
__global__ void prep_w_kernel(const T* __restrict__ w, T* __restrict__ wt,
                              int din, int dout) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + threadIdx.x;
    tile[i][threadIdx.x] =
        (k < din && n < dout) ? to_f32(w[static_cast<size_t>(k) * dout + n])
                              : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (n < dout && k < din) {
      const float v = tile[threadIdx.x][i];
      const size_t at = static_cast<size_t>(n) * din + k;
      if constexpr (Traits<T>::kParts == 2) {
        const uint32_t big = tf32_rna(v);
        wt[at] = __uint_as_float(big);
        wt[static_cast<size_t>(dout) * din + at] =
            __uint_as_float(tf32_rna(v - __uint_as_float(big)));
      } else {
        wt[at] = from_f32<T>(v);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A 3-D map in 128-byte-swizzled boxes; out-of-bounds elements read as 0.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base,
            const cuuint64_t (&dims)[3], const cuuint64_t (&strides)[2],
            const cuuint32_t (&box)[3]) {
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode_tiled()(map, type, 3, const_cast<void*>(base), dims, strides,
                        box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BN>
cudaError_t launch(const Group* groups, int ngroups, const void* w, void* wt,
                   int din, int dout, cudaStream_t stream) {
  using Tr = Traits<T>;
  constexpr int kE = Tr::kE;
  constexpr int kBytes = Smem<T, BN>::kBytes;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  if (wt == nullptr || din % kE || dout % 8) return cudaErrorInvalidValue;
  Params p;
  std::memset(&p, 0, sizeof(p));
  p.ngroups = ngroups;
  p.din = din;
  p.dout = dout;
  p.nk = din / kE;
  p.ntiles_n = (dout + BN - 1) / BN;
  p.resident = p.ntiles_n == 1 && p.nk <= Smem<T, BN>::kStages;
  long long tiles = 0;
  for (int i = 0; i < ngroups; ++i) {
    const Group& g = groups[i];
    const long long cc = g.ncomp;
    // interleaved components, (point, d, k) at (point*din + d)*cc + k
    if (cc < 1 || cc > kRows || g.npoints < 1 || g.npoints > 0x7fffffffLL ||
        g.in_d != cc || g.in_row != din * cc ||
        (cc > 1 && g.in_comp != 1) || g.out_o != cc ||
        g.out_row != dout * cc || (cc > 1 && g.out_comp != 1) ||
        reinterpret_cast<uintptr_t>(g.in) % 16 ||
        reinterpret_cast<uintptr_t>(g.out) % 16) {
      return cudaErrorInvalidValue;
    }
    TileGroup& tg = p.g[i];
    tg.out = g.out;
    tg.npoints = g.npoints;
    tg.tile_begin = tiles;
    tg.cc = static_cast<int>(cc);
    tg.P = kRows / tg.cc;
    tiles += (g.npoints + tg.P - 1) / tg.P * p.ntiles_n;
    const cuuint64_t dims[3] = {
        static_cast<cuuint64_t>(kE), static_cast<cuuint64_t>(din * cc / kE),
        static_cast<cuuint64_t>(g.npoints)};
    const cuuint64_t strides[2] = {
        static_cast<cuuint64_t>(kRowBytes),
        static_cast<cuuint64_t>(din * cc * sizeof(T))};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(kE),
                               static_cast<cuuint32_t>(cc),
                               static_cast<cuuint32_t>(tg.P)};
    if (!encode(&p.a[i], Tr::kMap, g.in, dims, strides, box)) {
      return cudaErrorInvalidValue;
    }
  }
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.ntiles = tiles;
  const cuuint64_t bdims[3] = {static_cast<cuuint64_t>(din),
                               static_cast<cuuint64_t>(dout),
                               static_cast<cuuint64_t>(Tr::kParts)};
  const cuuint64_t bstrides[2] = {
      static_cast<cuuint64_t>(din) * sizeof(T),
      static_cast<cuuint64_t>(din) * dout * sizeof(T)};
  const cuuint32_t bbox[3] = {static_cast<cuuint32_t>(kE),
                              static_cast<cuuint32_t>(BN),
                              static_cast<cuuint32_t>(Tr::kParts)};
  if (!encode(&p.b, Tr::kMap, wt, bdims, bstrides, bbox)) {
    return cudaErrorInvalidValue;
  }

  prep_w_kernel<T><<<dim3((din + 31) / 32, (dout + 31) / 32), dim3(32, 8), 0,
                     stream>>>(static_cast<const T*>(w), static_cast<T*>(wt),
                               din, dout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaFuncSetAttribute(kernel<T, BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kBytes)) != cudaSuccess) {
    return err;
  }
  const unsigned grid =
      static_cast<unsigned>(tiles < sms ? tiles : static_cast<long long>(sms));
  kernel<T, BN><<<grid, kThreads, kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T>
cudaError_t launch(int variant, const Group* groups, int ngroups,
                   const void* w, void* wt, int din, int dout,
                   cudaStream_t stream) {
  switch (variant) {
    case kSimt:
      return simt::launch<T>(groups, ngroups, w, din, dout, stream);
    case kWgmma:
      // column tiles: 64 for the bytes-bound dout <= 64, else 128; 256 for
      // 16-bit past 128 (float32 keeps a stage sum beside its sums, which
      // 256 columns would not leave registers for)
      if (dout <= 64) {
        return tc::launch<T, 64>(groups, ngroups, w, wt, din, dout, stream);
      }
      if constexpr (sizeof(T) == 2) {
        if (dout > 128) {
          return tc::launch<T, 256>(groups, ngroups, w, wt, din, dout,
                                    stream);
        }
      }
      return tc::launch<T, 128>(groups, ngroups, w, wt, din, dout, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace hdual_linear

// Plain C entry point (loaded with ctypes).  groups: ngroups (1-4)
// hdual_linear::Group records; w (din, dout); wt: scratch of 2*dout*din
// float32 or dout*din 16-bit elements for the wgmma variant (unused by
// simt).  dtype: 0 float32, 1 bfloat16, 2 float16, for inputs, w and
// outputs alike; variant: 0 simt, 1 wgmma.  Returns cudaGetLastError()
// after the launches, which are asynchronous on `stream`.
extern "C" int hdual_linear_launch(const hdual_linear::Group* groups,
                                   int ngroups, const void* w, void* wt,
                                   int dtype, int din, int dout, int variant,
                                   void* stream) {
  using namespace hdual_linear;
  if (ngroups < 1 || ngroups > kMaxGroups || din < 1 || dout < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = launch<float>(variant, groups, ngroups, w, wt, din, dout, s);
      break;
    case kBF16:
      err = launch<__nv_bfloat16>(variant, groups, ngroups, w, wt, din, dout,
                                  s);
      break;
    case kF16:
      err = launch<__half>(variant, groups, ngroups, w, wt, din, dout, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
