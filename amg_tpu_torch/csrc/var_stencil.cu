// K5: the variable-coefficient (DIA) stencil kernel on the padded state.
//
// Replaces amg_tpu/ops/pallas_var_stencil.py::_var_kernel (entry
// var_stencil_kernel_padded). An operator of m <= 128 generalized diagonals:
// coefficient planes c[t] of the interior grid, (m, Z, Y, X); the state
// vectors in the padded layout (a zero shell of per-axis halo widths;
// amg_tpu_torch/ops/var_stencil.py). Modes, at every interior point p
// (shell -> 0):
//   0 spmv      out = A u,            (A u)(p) = sum_t c[t](p) u(p + off_t)
//   1 residual  out = b - A u
//   2 sweep     out = u + s (b - A u)
//
// Bound on the H100: bytes. The m coefficient planes are the matrix and are
// read once per application: for the 99-diagonal elasticity operator at 157k
// dofs that is 99 planes of 157,035 points, 62 MB in float32, against 0.8 MB
// per padded state vector; 2 flops per coefficient read is far below the
// card's 20 flops per byte in float32.
//
// Design: one thread per padded point in a flat 1-D grid, the taps' linear
// offsets passed by value (__grid_constant__: read in place from the
// parameter bank, not copied per thread) and m a run-time argument (no
// unrolling per operator). For tap t, a warp reads up to 32 consecutive
// coefficients of plane t (split where it crosses an x row of the interior)
// and 32 consecutive u values at the shifted position: both coalesced, and
// the u reads of neighbouring taps hit in L1/L2. Shell threads read no
// coefficient and write 0. Taps are summed in list order, each product and
// sum rounded on its own (below). No shared-memory tiling (each coefficient
// is used once), TMA or asynchronous copies yet.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxVarTaps = 128;
constexpr int kThreads = 256;

enum Mode { kSpmv = 0, kResidual = 1, kSweep = 2 };

// Separately rounded products and sums (no FMA contraction): with the taps
// summed in list order, the kernel computes what its plain PyTorch version
// (one rounded multiply and one rounded add per tap) computes, bit for bit,
// so a solve on the kernel can be held exactly against the plain composition.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// linear offsets dz*plane + dy*row + dx of the m diagonals
struct VarTaps {
  int off[kMaxVarTaps];
  int n;
};

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    k5_kernel(const T* __restrict__ u, const T* __restrict__ c, const T* __restrict__ b,
              const T* __restrict__ s, T* __restrict__ out, const __grid_constant__ VarTaps taps,
              int hz, int hy,
              int hx, int Z, int Y, int X, int Yr, int Xr, long long vol) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= vol) return;
  const int x = static_cast<int>(i % Xr);
  const int y = static_cast<int>((i / Xr) % Yr);
  const int z = static_cast<int>(i / (static_cast<long long>(Xr) * Yr));
  T val = T(0);
  if (z >= hz && z < hz + Z && y >= hy && y < hy + Y && x >= hx && x < hx + X) {
    const long long plane = static_cast<long long>(Z) * Y * X;
    const T* cp = c + (static_cast<long long>(z - hz) * Y + (y - hy)) * X + (x - hx);
    T acc = T(0);
#pragma unroll 4
    for (int t = 0; t < taps.n; ++t)
      acc = add_rn(acc, mul_rn(__ldg(cp + t * plane), __ldg(u + i + taps.off[t])));
    if (kMode == kSpmv) {
      val = acc;
    } else if (kMode == kResidual) {
      val = sub_rn(b[i], acc);
    } else {
      val = add_rn(u[i], mul_rn(s[i], sub_rn(b[i], acc)));
    }
  }
  out[i] = val;
}

template <typename T>
int launch(const void* u, const void* c, const void* b, const void* s, void* out,
           const VarTaps& taps, int hz, int hy, int hx, int Z, int Y, int X, int Zr, int Yr,
           int Xr, int mode, cudaStream_t stream) {
  const long long vol = static_cast<long long>(Zr) * Yr * Xr;
  const dim3 grid(static_cast<unsigned>((vol + kThreads - 1) / kThreads));
  const T* uu = static_cast<const T*>(u);
  const T* cc = static_cast<const T*>(c);
  const T* bb = static_cast<const T*>(b);
  const T* ss = static_cast<const T*>(s);
  T* oo = static_cast<T*>(out);
  if (mode == kSpmv)
    k5_kernel<T, kSpmv><<<grid, kThreads, 0, stream>>>(uu, cc, bb, ss, oo, taps, hz, hy, hx, Z,
                                                       Y, X, Yr, Xr, vol);
  else if (mode == kResidual)
    k5_kernel<T, kResidual><<<grid, kThreads, 0, stream>>>(uu, cc, bb, ss, oo, taps, hz, hy, hx,
                                                           Z, Y, X, Yr, Xr, vol);
  else
    k5_kernel<T, kSweep><<<grid, kThreads, 0, stream>>>(uu, cc, bb, ss, oo, taps, hz, hy, hx, Z,
                                                        Y, X, Yr, Xr, vol);
  return static_cast<int>(cudaGetLastError());
}

int iabs(int v) { return v < 0 ? -v : v; }
int imax(int a, int b) { return a > b ? a : b; }

}  // namespace

extern "C" {

// u, b, s, out: (Zr, Yr, Xr) padded arrays; c: (ntaps, Z, Y, X). The halo
// widths are the largest |offset| per axis, so the interior is
// [hz, hz+Z) x [hy, hy+Y) x [hx, hx+X) and every tap of an interior point
// stays inside the array.
int amg_k5_launch(int is_double, const void* u, const void* c, const void* b, const void* s,
                  void* out, const int* dz, const int* dy, const int* dx, int ntaps, int Z,
                  int Y, int X, int Zr, int Yr, int Xr, int mode, void* stream) {
  if (ntaps < 1 || ntaps > kMaxVarTaps || mode < kSpmv || mode > kSweep)
    return static_cast<int>(cudaErrorInvalidValue);
  VarTaps taps{};
  taps.n = ntaps;
  int hz = 0, hy = 0, hx = 0;
  for (int t = 0; t < ntaps; ++t) {
    hz = imax(hz, iabs(dz[t]));
    hy = imax(hy, iabs(dy[t]));
    hx = imax(hx, iabs(dx[t]));
    taps.off[t] = (dz[t] * Yr + dy[t]) * Xr + dx[t];
  }
  if (Zr < Z + 2 * hz || Yr < Y + 2 * hy || Xr < X + 2 * hx)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(u, c, b, s, out, taps, hz, hy, hx, Z, Y, X, Zr, Yr, Xr, mode, st);
  return launch<float>(u, c, b, s, out, taps, hz, hy, hx, Z, Y, X, Zr, Yr, Xr, mode, st);
}

}  // extern "C"
