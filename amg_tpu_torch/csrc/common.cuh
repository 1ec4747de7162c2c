// Shared pieces of the stencil and transfer kernels (sm_90a).
//
// Layout: every grid state lives in the port's padded layout, a dense
// row-major (Zr, Yr, Xr) array with Zr = Z+2, Yr = Y+2, Xr = X+2 rounded up to
// a multiple of 4 (16-byte rows in float32). The one-cell zero shell is the
// homogeneous-Dirichlet truncation of the assembled operator, so a reach-1
// stencil at an interior point reads its neighbours without any bounds test.
// Kernels write 0 to every shell and pad point they own.
#pragma once

#include <cuda_runtime.h>

namespace amg {

constexpr int kMaxTaps = 27;

// A constant stencil, passed to the kernel by value: tap k adds
// w[k] * v[i + off[k]], where off[k] = dz*plane + dy*row + dx (|d| <= 1) is
// the tap's linear offset in the array the kernel reads (a shared-memory
// tile or ring), computed on the host. Taps are summed in list order.
template <typename T>
struct Taps {
  T w[kMaxTaps];
  int off[kMaxTaps];
  int n;
};

// Host-side: the by-value struct for the caller's (float64 weights, int
// offsets) tap list over an array with the given plane and row strides, or
// false when it is not a reach-1 list of at most kMaxTaps taps.
template <typename T>
inline bool make_taps(Taps<T>* t, const double* w, const int* dz, const int* dy,
                      const int* dx, int n, int plane, int row) {
  if (n < 0 || n > kMaxTaps) return false;
  *t = Taps<T>{};
  t->n = n;
  for (int k = 0; k < n; ++k) {
    if (dz[k] < -1 || dz[k] > 1 || dy[k] < -1 || dy[k] > 1 || dx[k] < -1 || dx[k] > 1)
      return false;
    t->w[k] = static_cast<T>(w[k]);
    t->off[k] = dz[k] * plane + dy[k] * row + dx[k];
  }
  return true;
}

// Separately rounded arithmetic: the compiler may not contract these into an
// FMA, so every kernel that builds a point from them rounds exactly as the
// source reads, and as PyTorch's elementwise ops in the plain version do.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// The uniform 27-point box, A u = w_off * boxsum(u) + (w_c - w_off) * u, with
// the box summed as the reference's kernel sums it
// (amg_tpu/ops/pallas_stencil.py, box_apply and the box fast path of
// _sweep_kernel): first along z as (m + c) + p (add_rn twice; the box march
// keeps each point's pair m + c in a register from one plane to the next),
// then along y and then x, each as (c + m) + p, where m, c, p are the values
// at offset -1, 0, +1.
template <typename T>
__device__ __forceinline__ T box_axis_sum(T c, T m, T p) {
  return add_rn(add_rn(c, m), p);
}

// w_off * boxsum + w_cm * u, w_cm = w_c - w_off (formed on the host in float64)
template <typename T>
__device__ __forceinline__ T box_combine(T w_off, T w_cm, T boxsum, T u) {
  return add_rn(mul_rn(w_off, boxsum), mul_rn(w_cm, u));
}

// u + s (b - acc), each operation rounded on its own
template <typename T>
__device__ __forceinline__ T jacobi_update_rn(T u, T b, T s, T acc) {
  return add_rn(u, mul_rn(s, sub_rn(b, acc)));
}

// 16 bytes global -> shared by cp.async (both 16-byte aligned); when !valid
// nothing is read and the 16 bytes are filled with 0 (src-size 0). kL1 keeps
// the line in L1 (.ca) for later reads through __ldg; else L2 only (.cg).
template <bool kL1 = false>
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned n = valid ? 16u : 0u;
  if constexpr (kL1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline bool misaligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 != 0;
}

__device__ __forceinline__ bool interior(int z, int y, int x, int Z, int Y, int X) {
  return z >= 1 && z <= Z && y >= 1 && y <= Y && x >= 1 && x <= X;
}

}  // namespace amg
