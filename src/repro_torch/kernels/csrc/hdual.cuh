// hDual<C>: the CHESSFAD second-order dual number, held in registers.
//
// The device counterpart of repro_torch/core/hdual.py (and of the paper's
// header library, §4): a value u carries
//
//   val      u
//   di       du/dx_i                      (Hessian row direction)
//   dj[l]    du/dx_{cstart+l}             (chunk directions, l < C)
//   dij[l]   d2u/dx_i dx_{cstart+l}       (the Hessian chunk)
//
// C is a compile-time lane count, so every lane loop unrolls and the 2C+2
// components stay in registers.  A runtime chunk size csize <= C is served
// by seeding lanes l >= csize with zero dj: their dij stays zero and the
// caller masks them.
//
// The operators follow hdual.py term for term (Leibniz to second order for
// products, the chain rule g_ij = g' u_ij + g'' u_i u_j for unary maps).
//
// Without __CUDACC__ (a host C++ compiler: the CPU check of the generated
// device forms) the same operators are plain inline functions and the
// warp shuffles of group_sum_dij are left out.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <math.h>
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace chessfad {

template <int C>
struct HDual {
  float val, di;
  float dj[C], dij[C];
};

template <int C>
__device__ __forceinline__ HDual<C> constant(float x) {
  HDual<C> r;
  r.val = x;
  r.di = 0.f;
#pragma unroll
  for (int l = 0; l < C; ++l) {
    r.dj[l] = 0.f;
    r.dij[l] = 0.f;
  }
  return r;
}

// CHUNK-INIT (paper Alg. 4) for one variable: variable k of the pass that
// computes H[i, cstart:cstart+csize].  Seeded on the fly, so a device form
// never holds an n-vector of hDuals.
template <int C>
__device__ __forceinline__ HDual<C> seed(float a_k, int k, int i, int cstart,
                                         int csize) {
  HDual<C> r;
  r.val = a_k;
  r.di = (k == i) ? 1.f : 0.f;
#pragma unroll
  for (int l = 0; l < C; ++l) {
    r.dj[l] = (l < csize && k == cstart + l) ? 1.f : 0.f;
    r.dij[l] = 0.f;
  }
  return r;
}

// u with its value set to 0: the part of u that moves with the seeds.  A
// device form that hoists a primal sum adds the tangents of its active terms
// to constant(sum), so the value is the hoisted one and every derivative
// lane is the sum's.
template <int C>
__device__ __forceinline__ HDual<C> tangent(HDual<C> u) {
  u.val = 0.f;
  return u;
}

// ---- sums ------------------------------------------------------------------

template <int C>
__device__ __forceinline__ HDual<C> operator+(const HDual<C>& u,
                                              const HDual<C>& v) {
  HDual<C> r;
  r.val = u.val + v.val;
  r.di = u.di + v.di;
#pragma unroll
  for (int l = 0; l < C; ++l) {
    r.dj[l] = u.dj[l] + v.dj[l];
    r.dij[l] = u.dij[l] + v.dij[l];
  }
  return r;
}

template <int C>
__device__ __forceinline__ HDual<C>& operator+=(HDual<C>& u,
                                                const HDual<C>& v) {
  u = u + v;
  return u;
}

// The sum over a group of G consecutive lanes (G a power of two up to 32;
// `mask`, the group's lanes) of one hDual each, on every lane of the group,
// in the dij lanes: a butterfly of the + operator's dij lanes.  The other
// lanes keep this lane's values; a caller whose sum is read only in dij (a
// cell's scatter) needs no more.
#ifdef __CUDACC__
template <int G, int C>
__device__ __forceinline__ void group_sum_dij(HDual<C>& u, unsigned mask) {
#pragma unroll
  for (int offset = G / 2; offset > 0; offset >>= 1) {
#pragma unroll
    for (int l = 0; l < C; ++l) {
      u.dij[l] += __shfl_xor_sync(mask, u.dij[l], offset);
    }
  }
}
#endif

template <int C>
__device__ __forceinline__ HDual<C> operator-(const HDual<C>& u) {
  HDual<C> r;
  r.val = -u.val;
  r.di = -u.di;
#pragma unroll
  for (int l = 0; l < C; ++l) {
    r.dj[l] = -u.dj[l];
    r.dij[l] = -u.dij[l];
  }
  return r;
}

template <int C>
__device__ __forceinline__ HDual<C> operator-(const HDual<C>& u,
                                              const HDual<C>& v) {
  HDual<C> r;
  r.val = u.val - v.val;
  r.di = u.di - v.di;
#pragma unroll
  for (int l = 0; l < C; ++l) {
    r.dj[l] = u.dj[l] - v.dj[l];
    r.dij[l] = u.dij[l] - v.dij[l];
  }
  return r;
}

// constants move only the value
template <int C>
__device__ __forceinline__ HDual<C> operator+(HDual<C> u, float c) {
  u.val += c;
  return u;
}

template <int C>
__device__ __forceinline__ HDual<C> operator+(float c, const HDual<C>& u) {
  return u + c;
}

template <int C>
__device__ __forceinline__ HDual<C> operator-(HDual<C> u, float c) {
  u.val -= c;
  return u;
}

template <int C>
__device__ __forceinline__ HDual<C> operator-(float c, const HDual<C>& u) {
  return (-u) + c;
}

// ---- products ----------------------------------------------------------------

// constant scale: all 2C+2 components
template <int C>
__device__ __forceinline__ HDual<C> operator*(const HDual<C>& u, float c) {
  HDual<C> r;
  r.val = u.val * c;
  r.di = u.di * c;
#pragma unroll
  for (int l = 0; l < C; ++l) {
    r.dj[l] = u.dj[l] * c;
    r.dij[l] = u.dij[l] * c;
  }
  return r;
}

template <int C>
__device__ __forceinline__ HDual<C> operator*(float c, const HDual<C>& u) {
  return u * c;
}

// (uv)_ij = u v_ij + u_i v_j + v_i u_j + v u_ij   (paper §3.1)
template <int C>
__device__ __forceinline__ HDual<C> operator*(const HDual<C>& u,
                                              const HDual<C>& v) {
  HDual<C> r;
  r.val = u.val * v.val;
  r.di = u.val * v.di + v.val * u.di;
#pragma unroll
  for (int l = 0; l < C; ++l) {
    r.dj[l] = u.val * v.dj[l] + v.val * u.dj[l];
    r.dij[l] = u.val * v.dij[l] + u.di * v.dj[l] + v.di * u.dj[l] +
               v.val * u.dij[l];
  }
  return r;
}

// ---- unary maps ------------------------------------------------------------

// g(u) given g, g', g'' at u.val
template <int C>
__device__ __forceinline__ HDual<C> unary(const HDual<C>& u, float g, float dg,
                                          float d2g) {
  HDual<C> r;
  r.val = g;
  r.di = dg * u.di;
  const float d2i = d2g * u.di;
#pragma unroll
  for (int l = 0; l < C; ++l) {
    r.dj[l] = dg * u.dj[l];
    r.dij[l] = dg * u.dij[l] + d2i * u.dj[l];
  }
  return r;
}

template <int C>
__device__ __forceinline__ HDual<C> operator/(const HDual<C>& u, float c) {
  return u * (1.f / c);
}

template <int C>
__device__ __forceinline__ HDual<C> operator/(const HDual<C>& u,
                                              const HDual<C>& v) {
  const float inv = 1.f / v.val;
  return u * unary(v, inv, -inv * inv, 2.f * inv * inv * inv);
}

// sin/cos with the primal sin and cos of u.val supplied by the caller (a
// device form that evaluates them once per instance passes them in)
template <int C>
__device__ __forceinline__ HDual<C> sin(const HDual<C>& u, float s, float c) {
  return unary(u, s, c, -s);
}

template <int C>
__device__ __forceinline__ HDual<C> cos(const HDual<C>& u, float c, float s) {
  return unary(u, c, -s, -c);
}

template <int C>
__device__ __forceinline__ HDual<C> sin(const HDual<C>& u) {
  return sin(u, sinf(u.val), cosf(u.val));
}

template <int C>
__device__ __forceinline__ HDual<C> cos(const HDual<C>& u) {
  return cos(u, cosf(u.val), sinf(u.val));
}

template <int C>
__device__ __forceinline__ HDual<C> exp(const HDual<C>& u) {
  const float e = expf(u.val);
  return unary(u, e, e, e);
}

template <int C>
__device__ __forceinline__ HDual<C> sqrt(const HDual<C>& u) {
  const float g = sqrtf(u.val);
  return unary(u, g, 0.5f / g, -0.25f / (u.val * g));
}

}  // namespace chessfad
