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
// The sweep also takes its planes as bf16 beside a float32 or float64 state
// (the reference's c_sweep stream, DiaKernelOperator.with_sweep_dtype): each
// coefficient is widened exactly (__bfloat162float, then to double for a
// float64 state) before its multiply, as the reference's
// cbufs[...].astype(ubufs.dtype) * blk does.
//
// Bound on the H100: bytes. The m coefficient planes are the matrix and are
// read once per application: for the 99-diagonal elasticity operator at 157k
// dofs that is 99 planes of 157,035 points, 62 MB in float32 (31 MB as bf16),
// against 0.8 MB per padded state vector; 2 flops per coefficient read is far
// below the card's 20 flops per byte in float32.
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
#include <cuda_bf16.h>
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

// a coefficient in the state's type T: as it is, or a bf16 value widened
// exactly (every bf16 value is a float, and every float a double)
template <typename T>
__device__ __forceinline__ T widen(T c) {
  return c;
}
template <typename T>
__device__ __forceinline__ T widen(__nv_bfloat16 c) {
  return static_cast<T>(__bfloat162float(c));
}

// linear offsets dz*plane + dy*row + dx of the m diagonals
struct VarTaps {
  int off[kMaxVarTaps];
  int n;
};

// C: the coefficient planes' type, T or (sweep only) __nv_bfloat16
template <typename T, typename C, int kMode>
__global__ void __launch_bounds__(kThreads)
    k5_kernel(const T* __restrict__ u, const C* __restrict__ c, const T* __restrict__ b,
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
    const C* cp = c + (static_cast<long long>(z - hz) * Y + (y - hy)) * X + (x - hx);
    T acc = T(0);
#pragma unroll 4
    for (int t = 0; t < taps.n; ++t)
      acc = add_rn(acc, mul_rn(widen<T>(__ldg(cp + t * plane)), __ldg(u + i + taps.off[t])));
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

// the operands of one launch
struct K5Args {
  const void* u;
  const void* c;
  const void* b;
  const void* s;
  void* out;
  int hz, hy, hx, Z, Y, X, Yr, Xr;
  long long vol;  // Zr * Yr * Xr
};

template <typename T, typename C, int kMode>
int launch(const K5Args& a, const VarTaps& taps, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.vol + kThreads - 1) / kThreads));
  k5_kernel<T, C, kMode><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.u), static_cast<const C*>(a.c), static_cast<const T*>(a.b),
      static_cast<const T*>(a.s), static_cast<T*>(a.out), taps, a.hz, a.hy, a.hx, a.Z, a.Y,
      a.X, a.Yr, a.Xr, a.vol);
  return static_cast<int>(cudaGetLastError());
}

// state of type T: the three modes on planes of T, or the sweep on bf16 planes
template <typename T>
int launch_state(int coef_bf16, int mode, const K5Args& a, const VarTaps& taps,
                 cudaStream_t stream) {
  if (coef_bf16) return launch<T, __nv_bfloat16, kSweep>(a, taps, stream);
  if (mode == kSpmv) return launch<T, T, kSpmv>(a, taps, stream);
  if (mode == kResidual) return launch<T, T, kResidual>(a, taps, stream);
  return launch<T, T, kSweep>(a, taps, stream);
}

int iabs(int v) { return v < 0 ? -v : v; }
int imax(int a, int b) { return a > b ? a : b; }

}  // namespace

extern "C" {

// u, b, s, out: (Zr, Yr, Xr) padded arrays; c: (ntaps, Z, Y, X), in the
// state's type, or with coef_bf16 as bf16 (mode 2, sweep, only). The halo
// widths are the largest |offset| per axis, so the interior is
// [hz, hz+Z) x [hy, hy+Y) x [hx, hx+X) and every tap of an interior point
// stays inside the array.
int amg_k5_launch(int is_double, int coef_bf16, const void* u, const void* c, const void* b,
                  const void* s, void* out, const int* dz, const int* dy, const int* dx,
                  int ntaps, int Z, int Y, int X, int Zr, int Yr, int Xr, int mode,
                  void* stream) {
  if (ntaps < 1 || ntaps > kMaxVarTaps || mode < kSpmv || mode > kSweep ||
      (coef_bf16 && mode != kSweep))
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
  const K5Args args{u, c, b, s, out, hz, hy, hx, Z, Y, X, Yr, Xr,
                    static_cast<long long>(Zr) * Yr * Xr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) return launch_state<double>(coef_bf16, mode, args, taps, st);
  return launch_state<float>(coef_bf16, mode, args, taps, st);
}

}  // extern "C"
