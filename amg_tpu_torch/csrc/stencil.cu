// K1: the constant-weight stencil kernel on the padded state, for any reach-1
// tap list but the uniform 27-point box (the RAP coarse levels); the box goes
// to csrc/box_march.cu.
//
// Replaces amg_tpu/ops/pallas_stencil.py::_sweep_kernel's tap-list path
// (entry stencil_kernel_padded). Modes, at every interior point p (shell -> 0):
//   0 spmv            out = A u
//   1 residual        out = b - A u
//   2 sweep           out = u + alpha (b - A u)
//   3 sweep_vec       out = u + s (b - A u)
//   4 sweep_vec_norm  sweep_vec, plus one partial sum of r^2 (r = b - A u of
//                     the incoming u) per thread block into partials[]; the
//                     caller sums the partials with torch.sum (deterministic,
//                     no float atomics).
//
// Bound on the H100: bytes. sweep_vec reads u, b, s and writes out, four state
// arrays: at the RAP level 63^3 in float32 4 x 1.15 MB in this layout, about
// 1.4 us at 3.35 TB/s (32^3: 0.2 us), so the launch itself is the floor there;
// its 27 FMAs per point are ~0.2 us of float32 arithmetic. Design: one
// thread per output point, x fastest across the warp (coalesced rows), a
// 32x4 (x, y) block walking 8 z-rows, the mode a template parameter, the 27
// taps (weights and linear offsets) passed by value and the neighbour reads
// served by L1/L2 (each u element is read by 27 threads, but from cache, so
// DRAM sees it about once). The register cap of __launch_bounds__ keeps 8
// blocks (32 warps) resident per SM to hide the load latency. No
// shared-memory tiling, TMA or asynchronous copies yet.
#include "common.cuh"

using namespace amg;

namespace {

constexpr int kBX = 32;
constexpr int kBY = 4;
constexpr int kZChunk = 8;
constexpr int kMinBlocks = 8;

enum Mode { kSpmv = 0, kResidual = 1, kSweep = 2, kSweepVec = 3, kSweepVecNorm = 4 };

dim3 k1_grid(int Zr, int Yr, int Xr) {
  return dim3((Xr + kBX - 1) / kBX, (Yr + kBY - 1) / kBY, (Zr + kZChunk - 1) / kZChunk);
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kBX* kBY, kMinBlocks)
    k1_kernel(const T* __restrict__ u, const T* __restrict__ b, const T* __restrict__ s,
              T* __restrict__ out, T* __restrict__ partials, const Taps<T> taps, int Z,
              int Y, int X, int Zr, int Yr, int Xr, T alpha) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z0 = blockIdx.z * kZChunk;
  const int z1 = min(z0 + kZChunk, Zr);
  const long long sp = static_cast<long long>(Yr) * Xr;
  auto ld = [u](long long q) { return __ldg(u + q); };
  T sq = T(0);
  if (x < Xr && y < Yr) {
    const bool in_xy = x >= 1 && x <= X && y >= 1 && y <= Y;
    for (int z = z0; z < z1; ++z) {
      const long long i = z * sp + static_cast<long long>(y) * Xr + x;
      T val = T(0);
      if (in_xy && z >= 1 && z <= Z) {
        const T acc = apply_taps(taps, i, ld);
        if (kMode == kSpmv) {
          val = acc;
        } else if (kMode == kResidual) {
          val = b[i] - acc;
        } else if (kMode == kSweep) {
          val = jacobi_update(u[i], b[i], alpha, acc);
        } else if (kMode == kSweepVec) {
          val = jacobi_update(u[i], b[i], s[i], acc);
        } else {
          const T r = b[i] - acc;
          sq += r * r;
          val = u[i] + s[i] * r;
        }
      }
      out[i] = val;
    }
  }
  if (kMode == kSweepVecNorm) {
    __shared__ T red[kBX * kBY];
    const int tid = threadIdx.y * kBX + threadIdx.x;
    red[tid] = sq;
    __syncthreads();
    for (int h = kBX * kBY / 2; h > 0; h >>= 1) {
      if (tid < h) red[tid] += red[tid + h];
      __syncthreads();
    }
    if (tid == 0)
      partials[(static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
               blockIdx.x] = red[0];
  }
}

template <typename T>
int launch(const void* u, const void* b, const void* s, void* out, void* partials,
           const Taps<T>& taps, int Z, int Y, int X, int Zr, int Yr, int Xr, int mode,
           double alpha, cudaStream_t stream) {
  const dim3 grid = k1_grid(Zr, Yr, Xr), block(kBX, kBY);
  const T* uu = static_cast<const T*>(u);
  const T* bb = static_cast<const T*>(b);
  const T* ss = static_cast<const T*>(s);
  T* oo = static_cast<T*>(out);
  T* pp = static_cast<T*>(partials);
  const T a = static_cast<T>(alpha);
  switch (mode) {
    case kSpmv:
      k1_kernel<T, kSpmv><<<grid, block, 0, stream>>>(uu, bb, ss, oo, pp, taps, Z, Y, X, Zr,
                                                      Yr, Xr, a);
      break;
    case kResidual:
      k1_kernel<T, kResidual><<<grid, block, 0, stream>>>(uu, bb, ss, oo, pp, taps, Z, Y, X,
                                                          Zr, Yr, Xr, a);
      break;
    case kSweep:
      k1_kernel<T, kSweep><<<grid, block, 0, stream>>>(uu, bb, ss, oo, pp, taps, Z, Y, X, Zr,
                                                       Yr, Xr, a);
      break;
    case kSweepVec:
      k1_kernel<T, kSweepVec><<<grid, block, 0, stream>>>(uu, bb, ss, oo, pp, taps, Z, Y, X,
                                                          Zr, Yr, Xr, a);
      break;
    default:
      k1_kernel<T, kSweepVecNorm><<<grid, block, 0, stream>>>(uu, bb, ss, oo, pp, taps, Z, Y,
                                                              X, Zr, Yr, Xr, a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* u, const void* b, const void* s, void* out, void* partials,
                 const double* w, const int* dz, const int* dy, const int* dx, int ntaps,
                 int Z, int Y, int X, int Zr, int Yr, int Xr, int mode, double alpha,
                 cudaStream_t stream) {
  Taps<T> t;
  if (!make_taps(&t, w, dz, dy, dx, ntaps, Yr * Xr, Xr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<T>(u, b, s, out, partials, t, Z, Y, X, Zr, Yr, Xr, mode, alpha, stream);
}

}  // namespace

extern "C" {

// Number of thread blocks, i.e. of sweep_vec_norm partial sums.
int amg_k1_num_partials(int Zr, int Yr, int Xr) {
  const dim3 g = k1_grid(Zr, Yr, Xr);
  return static_cast<int>(g.x * g.y * g.z);
}

int amg_k1_launch(int is_double, const void* u, const void* b, const void* s, void* out,
                  void* partials, const double* w, const int* dz, const int* dy,
                  const int* dx, int ntaps, int Z, int Y, int X, int Zr, int Yr, int Xr,
                  int mode, double alpha, void* stream) {
  if (mode < kSpmv || mode > kSweepVecNorm) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_typed<double>(u, b, s, out, partials, w, dz, dy, dx, ntaps, Z, Y, X, Zr,
                                Yr, Xr, mode, alpha, st);
  return launch_typed<float>(u, b, s, out, partials, w, dz, dy, dx, ntaps, Z, Y, X, Zr, Yr,
                             Xr, mode, alpha, st);
}

}  // extern "C"
