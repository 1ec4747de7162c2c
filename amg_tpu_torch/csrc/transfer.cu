// K3 and K4: the fused transfer kernels on the padded state.
//
// K3 replaces amg_tpu/ops/pallas_transfer.py::_rr_kernel (entry
// residual_restrict_padded):
//     rc = R (b - A x)    fine padded (u, b) -> padded COARSE rhs
// with x = u, or under zero_guess x = s*b (alpha*b when s is null): a coarse
// level's whole down-visit. R is full weighting, {1/2, 1, 1/2} per axis with
// (s+1)//2 coarsening; coarse padded point c reads fine padded points
// 2c-2 .. 2c per axis, and the fine residual is 0 off the fine interior (the
// clipping at the interior edges).
//
// K4 replaces amg_tpu/ops/pallas_transfer.py::_ps_kernel (entry
// prolong_sweep_padded):
//     u' = x + P ec ;  out = u' + s (b - A u')   (alpha instead of s when s is null)
// with x = u, or under zero_guess x = s*b (alpha*b): a coarse level's whole
// up-visit. P is trilinear: fine interior index f takes coarse f/2 (weight 1)
// when even, coarse (f-1)/2 and (f+1)/2 (weight 1/2 each) when odd; the
// coarse padded zero shell supplies the clipped term at an even-sided edge.
// The graded-end even-axis transfer of the DIA hierarchy never occurs under
// (s+1)//2 coarsening, and the Python wrapper refuses other coarse shapes.
//
// Bound on the H100: bytes. K3 at 126^3 reads u and b (2 x 8.4 MB in float32
// in this layout) and writes 1/8 of that; K4 reads x, b, s and 1/8 of ec and
// writes out, about 4 1/8 state arrays (~10 us at 3.35 TB/s). Design: both
// kernels first build an intermediate field over their block's tile plus a
// one-cell halo in shared memory — the fine residual for K3, u' for K4 — and
// then apply the restriction (K3) or the stencil sweep (K4) from that tile,
// so the intermediate never touches device memory. The halo is recomputed by
// neighbouring blocks (K3 tile 9x17x33 for 4x8x16 coarse points, K4 tile
// 10x10x34 for 8x8x32 fine points). The iterate's source (u, s*b or alpha*b)
// and the sweep's scale (s or alpha) are template parameters; the taps ride
// in a by-value struct with their linear offsets precomputed for the array
// they index; global reads go through L1/L2. No TMA, clusters or
// asynchronous copies yet.
#include "common.cuh"

using namespace amg;

namespace {

// K3: 16x8 threads over coarse (x, y), 4 coarse z-rows per block
constexpr int k3BX = 16;
constexpr int k3BY = 8;
constexpr int k3TZ = 4;
constexpr int k3RX = 2 * k3BX + 1;
constexpr int k3RY = 2 * k3BY + 1;
constexpr int k3RZ = 2 * k3TZ + 1;
constexpr int k3MinBlocks = 8;

// K4: 32x8 threads over fine (x, y), 8 fine z-rows per block
constexpr int k4BX = 32;
constexpr int k4BY = 8;
constexpr int k4TZ = 8;
constexpr int k4UX = k4BX + 2;
constexpr int k4UY = k4BY + 2;
constexpr int k4UZ = k4TZ + 2;

// The iterate at linear index q: x itself, or the zero-guess pre-sweep s*b
// (kScale) or alpha*b.
template <typename T, bool kZeroGuess, bool kScale>
__device__ __forceinline__ T iterate_at(const T* __restrict__ x, const T* __restrict__ b,
                                        const T* __restrict__ s, T alpha, long long q) {
  if constexpr (!kZeroGuess) {
    return __ldg(x + q);
  } else if constexpr (kScale) {
    return __ldg(s + q) * __ldg(b + q);
  } else {
    return alpha * __ldg(b + q);
  }
}

template <typename T, bool kZeroGuess, bool kScale>
__global__ void __launch_bounds__(k3BX* k3BY, k3MinBlocks)
    k3_kernel(const T* __restrict__ u, const T* __restrict__ b, const T* __restrict__ s,
              T* __restrict__ rc, const Taps<T> taps, int Z, int Y, int X, int Yr, int Xr,
              int Zc, int Yc, int Xc, int Zcr, int Ycr, int Xcr, T alpha) {
  __shared__ T r[k3RZ][k3RY][k3RX];
  const int cx0 = blockIdx.x * k3BX, cy0 = blockIdx.y * k3BY, cz0 = blockIdx.z * k3TZ;
  const int fx0 = 2 * cx0 - 2, fy0 = 2 * cy0 - 2, fz0 = 2 * cz0 - 2;
  const long long sp = static_cast<long long>(Yr) * Xr;
  const int tid = threadIdx.y * k3BX + threadIdx.x;
  auto src = [=](long long q) { return iterate_at<T, kZeroGuess, kScale>(u, b, s, alpha, q); };
  for (int l = tid; l < k3RZ * k3RY * k3RX; l += k3BX * k3BY) {
    const int lx = l % k3RX, ly = (l / k3RX) % k3RY, lz = l / (k3RX * k3RY);
    const int fx = fx0 + lx, fy = fy0 + ly, fz = fz0 + lz;
    T val = T(0);
    if (interior(fz, fy, fx, Z, Y, X)) {
      const long long i = fz * sp + static_cast<long long>(fy) * Xr + fx;
      val = __ldg(b + i) - apply_taps(taps, i, src);
    }
    r[lz][ly][lx] = val;
  }
  __syncthreads();
  const int cx = cx0 + threadIdx.x, cy = cy0 + threadIdx.y;
  if (cx >= Xcr || cy >= Ycr) return;
  const T wt[3] = {T(0.5), T(1), T(0.5)};
  for (int tz = 0; tz < k3TZ; ++tz) {
    const int cz = cz0 + tz;
    if (cz >= Zcr) break;
    T val = T(0);
    if (interior(cz, cy, cx, Zc, Yc, Xc)) {
      const int lx = 2 * threadIdx.x + 1, ly = 2 * threadIdx.y + 1, lz = 2 * tz + 1;
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz)
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx)
            val += (wt[dz + 1] * wt[dy + 1] * wt[dx + 1]) * r[lz + dz][ly + dy][lx + dx];
    }
    rc[(static_cast<long long>(cz) * Ycr + cy) * Xcr + cx] = val;
  }
}

// Trilinear P ec at fine padded point (pz, py, px) (interior), reading the
// padded coarse correction ec (plane stride csp, row stride csx).
template <typename T>
__device__ __forceinline__ T prolong_at(const T* __restrict__ ec, int pz, int py, int px,
                                        long long csp, int csx) {
  int cz[2], cy[2], cx[2];
  T wz[2], wy[2], wx[2];
  int nz, ny, nx;
  auto axis = [](int p, int* c, T* w, int* n) {
    const int f = p - 1;  // fine interior index
    c[0] = f / 2 + 1;     // padded coarse index of coarse f/2 (floor)
    if ((f & 1) == 0) {
      w[0] = T(1);
      *n = 1;
    } else {
      c[1] = c[0] + 1;
      w[0] = w[1] = T(0.5);
      *n = 2;
    }
  };
  axis(pz, cz, wz, &nz);
  axis(py, cy, wy, &ny);
  axis(px, cx, wx, &nx);
  T acc = T(0);
  for (int a = 0; a < nz; ++a)
    for (int bb = 0; bb < ny; ++bb)
      for (int c = 0; c < nx; ++c)
        acc += (wz[a] * wy[bb] * wx[c]) * __ldg(ec + cz[a] * csp + static_cast<long long>(cy[bb]) * csx + cx[c]);
  return acc;
}

// taps: linear offsets into the flat (k4UZ, k4UY, k4UX) shared tile
template <typename T, bool kZeroGuess, bool kScale>
__global__ void __launch_bounds__(k4BX* k4BY)
    k4_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ s,
              const T* __restrict__ ec, T* __restrict__ out, const Taps<T> taps, int Z,
              int Y, int X, int Zr, int Yr, int Xr, int Ycr, int Xcr, T alpha) {
  __shared__ T up[k4UZ * k4UY * k4UX];
  const int x0 = blockIdx.x * k4BX, y0 = blockIdx.y * k4BY, z0 = blockIdx.z * k4TZ;
  const long long sp = static_cast<long long>(Yr) * Xr;
  const long long csp = static_cast<long long>(Ycr) * Xcr;
  const int tid = threadIdx.y * k4BX + threadIdx.x;
  for (int l = tid; l < k4UZ * k4UY * k4UX; l += k4BX * k4BY) {
    const int lx = l % k4UX, ly = (l / k4UX) % k4UY, lz = l / (k4UX * k4UY);
    const int px = x0 - 1 + lx, py = y0 - 1 + ly, pz = z0 - 1 + lz;
    T val = T(0);
    if (interior(pz, py, px, Z, Y, X)) {
      const long long i = pz * sp + static_cast<long long>(py) * Xr + px;
      val = iterate_at<T, kZeroGuess, kScale>(x, b, s, alpha, i) +
            prolong_at(ec, pz, py, px, csp, Xcr);
    }
    up[l] = val;
  }
  __syncthreads();
  const int px = x0 + threadIdx.x, py = y0 + threadIdx.y;
  if (px >= Xr || py >= Yr) return;
  const T* tile_base = up;
  auto tile = [tile_base](long long q) { return tile_base[q]; };
  for (int tz = 0; tz < k4TZ; ++tz) {
    const int pz = z0 + tz;
    if (pz >= Zr) break;
    const long long i = pz * sp + static_cast<long long>(py) * Xr + px;
    T val = T(0);
    if (interior(pz, py, px, Z, Y, X)) {
      const int c = ((tz + 1) * k4UY + threadIdx.y + 1) * k4UX + threadIdx.x + 1;
      const T acc = apply_taps(taps, c, tile);
      const T sc = kScale ? s[i] : alpha;
      val = up[c] + sc * (b[i] - acc);
    }
    out[i] = val;
  }
}

dim3 k3_grid(int Zcr, int Ycr, int Xcr) {
  return dim3((Xcr + k3BX - 1) / k3BX, (Ycr + k3BY - 1) / k3BY, (Zcr + k3TZ - 1) / k3TZ);
}

dim3 k4_grid(int Zr, int Yr, int Xr) {
  return dim3((Xr + k4BX - 1) / k4BX, (Yr + k4BY - 1) / k4BY, (Zr + k4TZ - 1) / k4TZ);
}

template <typename T>
int k3_launch(const void* u_, const void* b_, const void* s_, void* rc_, const double* w,
              const int* dz, const int* dy, const int* dx, int ntaps, int Z, int Y, int X,
              int Yr, int Xr, int Zc, int Yc, int Xc, int Zcr, int Ycr, int Xcr,
              int zero_guess, double alpha_, cudaStream_t st) {
  Taps<T> t;
  if (!make_taps(&t, w, dz, dy, dx, ntaps, Yr * Xr, Xr))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* u = static_cast<const T*>(u_);
  const T* b = static_cast<const T*>(b_);
  const T* s = static_cast<const T*>(s_);
  T* rc = static_cast<T*>(rc_);
  const T alpha = static_cast<T>(alpha_);
  const dim3 grid = k3_grid(Zcr, Ycr, Xcr), block(k3BX, k3BY);
  if (!zero_guess) {
    k3_kernel<T, false, false><<<grid, block, 0, st>>>(u, b, s, rc, t, Z, Y, X, Yr, Xr, Zc,
                                                       Yc, Xc, Zcr, Ycr, Xcr, alpha);
  } else if (s != nullptr) {
    k3_kernel<T, true, true><<<grid, block, 0, st>>>(u, b, s, rc, t, Z, Y, X, Yr, Xr, Zc, Yc,
                                                     Xc, Zcr, Ycr, Xcr, alpha);
  } else {
    k3_kernel<T, true, false><<<grid, block, 0, st>>>(u, b, s, rc, t, Z, Y, X, Yr, Xr, Zc,
                                                      Yc, Xc, Zcr, Ycr, Xcr, alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int k4_launch(const void* x_, const void* b_, const void* s_, const void* ec_, void* out_,
              const double* w, const int* dz, const int* dy, const int* dx, int ntaps, int Z,
              int Y, int X, int Zr, int Yr, int Xr, int Ycr, int Xcr, int zero_guess,
              double alpha_, cudaStream_t st) {
  Taps<T> t;
  if (!make_taps(&t, w, dz, dy, dx, ntaps, k4UY * k4UX, k4UX))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* x = static_cast<const T*>(x_);
  const T* b = static_cast<const T*>(b_);
  const T* s = static_cast<const T*>(s_);
  const T* ec = static_cast<const T*>(ec_);
  T* out = static_cast<T*>(out_);
  const T alpha = static_cast<T>(alpha_);
  const dim3 grid = k4_grid(Zr, Yr, Xr), block(k4BX, k4BY);
  const bool scale = s != nullptr;
  if (!zero_guess && scale) {
    k4_kernel<T, false, true><<<grid, block, 0, st>>>(x, b, s, ec, out, t, Z, Y, X, Zr, Yr,
                                                      Xr, Ycr, Xcr, alpha);
  } else if (!zero_guess) {
    k4_kernel<T, false, false><<<grid, block, 0, st>>>(x, b, s, ec, out, t, Z, Y, X, Zr, Yr,
                                                       Xr, Ycr, Xcr, alpha);
  } else if (scale) {
    k4_kernel<T, true, true><<<grid, block, 0, st>>>(x, b, s, ec, out, t, Z, Y, X, Zr, Yr, Xr,
                                                     Ycr, Xcr, alpha);
  } else {
    k4_kernel<T, true, false><<<grid, block, 0, st>>>(x, b, s, ec, out, t, Z, Y, X, Zr, Yr,
                                                      Xr, Ycr, Xcr, alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int amg_k3_launch(int is_double, const void* u, const void* b, const void* s, void* rc,
                  const double* w, const int* dz, const int* dy, const int* dx, int ntaps,
                  int Z, int Y, int X, int Yr, int Xr, int Zc, int Yc, int Xc, int Zcr,
                  int Ycr, int Xcr, int zero_guess, double alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return k3_launch<double>(u, b, s, rc, w, dz, dy, dx, ntaps, Z, Y, X, Yr, Xr, Zc, Yc, Xc,
                             Zcr, Ycr, Xcr, zero_guess, alpha, st);
  return k3_launch<float>(u, b, s, rc, w, dz, dy, dx, ntaps, Z, Y, X, Yr, Xr, Zc, Yc, Xc, Zcr,
                          Ycr, Xcr, zero_guess, alpha, st);
}

int amg_k4_launch(int is_double, const void* x, const void* b, const void* s, const void* ec,
                  void* out, const double* w, const int* dz, const int* dy, const int* dx,
                  int ntaps, int Z, int Y, int X, int Zr, int Yr, int Xr, int Ycr, int Xcr,
                  int zero_guess, double alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return k4_launch<double>(x, b, s, ec, out, w, dz, dy, dx, ntaps, Z, Y, X, Zr, Yr, Xr, Ycr,
                             Xcr, zero_guess, alpha, st);
  return k4_launch<float>(x, b, s, ec, out, w, dz, dy, dx, ntaps, Z, Y, X, Zr, Yr, Xr, Ycr,
                          Xcr, zero_guess, alpha, st);
}

}  // extern "C"
