// K3: the fused residual-restrict kernel on the padded state (K4, the fused
// prolong-sweep, is csrc/prolong_march.cu).
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
// K3's bound on the H100: bytes. At 126^3 it reads u and b (2 x 8.4 MB in
// float32 in this layout) and writes rc (1.1 MB): 17.9 MB, 5.4 us at
// 3.35 TB/s; its 27 FMAs per fine point are ~1 us of float32 issue. Its
// zero-guess launches on the coarse levels move 2.5 MB (63^3) and 0.36 MB
// (32^3), so there the floor is the launch itself and the aim is a grid that
// fills the card. Design: a z-march. A 128-thread block owns 16x8 coarse
// (x, y) columns and walks a chunk of coarse z-planes. For each fine z-plane
// p it (1) receives the iterate plane over the tile's fine (x, y) window (the
// 33x17 residual window plus a one-cell halo, its rows widened to 36 so that
// they start 16-byte aligned) and the b plane by 16-byte cp.async chunks into
// shared-memory rings, two planes ahead of the one it computes; the window's
// x edges are the zero shell and pad columns of the padded layout, rows and
// planes off the interior are zero-filled. Under zero_guess each thread forms
// s*b (alpha*b) once per point from the chunks it copied itself, after its
// wait and before the barrier; (2) lets each thread take its residual columns
// in groups of 3 along x, read the group's 5x3 (x, y) neighbourhood of plane
// p once (5 reads per row, against 9 per column one at a time) and apply all
// three dz rows of the taps to it, into register accumulators for the
// residual planes p-1, p and p+1 (2.5-D blocking). That completes the residual
// of plane p-1, computed once per point: the only recompute is the (x, y)
// halo of the residual window, 33x17 for 32x16 fine points (1.10x), and one
// fine plane per z-chunk; (3) restricts that residual plane in x and y from
// shared memory, one thread per coarse column, and accumulates the z weights
// {1/2, 1, 1/2} in a register: fine plane 2c-2 closes coarse plane c-1 and
// opens c. The taps are a dense 3x3x3 weight box (absent taps weigh 0), so
// RAP coarse taps run the same code. The launch plan (the z-chunk and the
// grid) comes from the Python wrapper (ops/transfer.py::k3_plan): the longest
// chunk, up to 4 coarse planes, that still gives 2 x 132 blocks, else chunks
// of one plane. The wrapper also requires 16-byte-aligned inputs.
// Rounding: the residual sums its taps by (dz, dy, dx) position, not in the
// caller's list order, and the restriction sums x, then y, then z; the plain
// version (stencil_plain, _restrict_axis) sums the taps in list order and
// restricts z, then y, then x. The results differ in the last bits only,
// well inside the 1e-5 (float32) and 1e-12 (float64) relative tolerances
// the kernel is held to.
//
#include "common.cuh"

using namespace amg;

namespace {

// K3: 16x8 coarse (x, y) columns per 128-thread block, one thread per coarse
// column in the restriction. The fine residual window of the tile is RX x RY
// (fine padded x from 32bx-2, y from 16by-2), computed in groups of 3
// x-columns; the iterate window around it is IX x IY, its rows widened to
// 16-byte-aligned fine x 32bx-4 .. 32bx+31 and staged in 16-byte chunks;
// kAhead planes in flight. ops/transfer.py::K3_TILE mirrors (k3BY, k3BX);
// k3_launch checks the plan.
constexpr int k3BX = 16;
constexpr int k3BY = 8;
constexpr int k3NT = k3BX * k3BY;
constexpr int k3RX = 2 * k3BX + 1;
constexpr int k3RY = 2 * k3BY + 1;
constexpr int k3IX = 2 * k3BX + 4;
constexpr int k3IY = k3RY + 2;
constexpr int k3IPts = k3IX * k3IY;
constexpr int k3G = 3;              // x-columns per group
constexpr int k3GX = k3RX / k3G;    // groups per residual row
constexpr int k3Groups = k3GX * k3RY;
constexpr int k3GPer = (k3Groups + k3NT - 1) / k3NT;  // groups per thread
constexpr int k3Ahead = 2;
constexpr int k3XSlots = k3Ahead + 1;  // iterate planes p .. p+2
constexpr int k3BSlots = k3Ahead + 2;  // b planes p-1 .. p+2 (the residual needs p-1)
static_assert(k3RX % k3G == 0, "the residual row splits into whole groups");

// 16-byte chunks of the iterate window: per row, per plane, per thread
template <typename T>
struct K3Chunks {
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));
  static constexpr int kPerRow = k3IX / kV;
  static constexpr int kCount = kPerRow * k3IY;
  static constexpr int kPer = (kCount + k3NT - 1) / k3NT;
};

// K3's iterate: u itself, or the zero-guess pre-sweep s*b or alpha*b
enum K3Mode { kK3Iterate = 0, kK3ZeroScale = 1, kK3ZeroAlpha = 2 };

// The stencil as a dense 3x3x3 weight box, w[dz+1][dy+1][dx+1] (absent taps
// weigh 0), passed by value.
template <typename T>
struct Box27 {
  T w[3][3][3];
};

// Host-side: the box of a reach-1 tap list (duplicate offsets add), or false.
template <typename T>
bool make_box27(Box27<T>* box, const double* w, const int* dz, const int* dy, const int* dx,
                int n) {
  if (n < 0 || n > kMaxTaps) return false;
  double acc[27] = {};
  for (int k = 0; k < n; ++k) {
    if (dz[k] < -1 || dz[k] > 1 || dy[k] < -1 || dy[k] > 1 || dx[k] < -1 || dx[k] > 1)
      return false;
    acc[(dz[k] + 1) * 9 + (dy[k] + 1) * 3 + dx[k] + 1] += w[k];
  }
  for (int j = 0; j < 27; ++j) box->w[j / 9][(j / 3) % 3][j % 3] = static_cast<T>(acc[j]);
  return true;
}

// Block (bx, by, bz): coarse columns cx0 .. cx0+15, cy0 .. cy0+7, coarse
// padded planes bz*zchunk .. +zchunk-1. It walks iterate planes p = fa-1 ..
// fb+1, where fa .. fb are the fine residual planes its interior coarse
// planes lo .. hi-1 read (fa = 2lo-2, fb = 2hi-2). The iterate window's x
// edges come from the zero shell and pad columns of the padded layout.
template <typename T, int kMode>
__global__ void __launch_bounds__(k3NT)
    k3_kernel(const T* __restrict__ u, const T* __restrict__ b, const T* __restrict__ s,
              T* __restrict__ rc, const Box27<T> W, int Z, int Y, int X, int Yr, int Xr,
              int Zc, int Yc, int Xc, int Zcr, int Ycr, int Xcr, int zchunk, T alpha) {
  using Ch = K3Chunks<T>;
  __shared__ __align__(16) T xs[k3XSlots][k3IPts];  // iterate planes
  __shared__ __align__(16) T bs[k3BSlots][k3IPts];  // b planes
  __shared__ T rs[k3RY * k3RX];                     // the residual plane being restricted
  const int tid = threadIdx.x;
  const int tx = tid % k3BX, ty = tid / k3BX;
  const int cx0 = blockIdx.x * k3BX, cy0 = blockIdx.y * k3BY;
  const int cx = cx0 + tx, cy = cy0 + ty;
  const bool own = cx < Xcr && cy < Ycr;
  const bool c_in = cx >= 1 && cx <= Xc && cy >= 1 && cy <= Yc;
  const long long csp = static_cast<long long>(Ycr) * Xcr;
  T* const out = rc + (own ? static_cast<long long>(cy) * Xcr + cx : 0);
  const int c0 = blockIdx.z * zchunk, c1 = min(c0 + zchunk, Zcr);
  if (own) {
    for (int cz = c0; cz < c1; ++cz)
      if (cz < 1 || cz > Zc) out[cz * csp] = T(0);
  }
  const int lo = max(c0, 1), hi = min(c1, Zc + 1);
  if (lo >= hi) return;  // the same for the whole block

  const long long sp = static_cast<long long>(Yr) * Xr;
  // this thread's chunks q = tid + k*k3NT of the iterate window (fine padded
  // origin (2cy0-3, 2cx0-4)): in-plane offset, or -1 when the chunk's row is
  // off the fine interior or the chunk lies outside the row
  int soff[Ch::kPer];
#pragma unroll
  for (int k = 0; k < Ch::kPer; ++k) {
    const int q = tid + k * k3NT;
    const int fy = 2 * cy0 - 3 + q / Ch::kPerRow;
    const int fx = 2 * cx0 - 4 + (q % Ch::kPerRow) * Ch::kV;
    soff[k] = (q < Ch::kCount && fy >= 1 && fy <= Y && fx >= 0 && fx + Ch::kV <= Xr)
                  ? fy * Xr + fx
                  : -1;
  }
  // this thread's groups g = tid + k*k3NT of the residual window: top-left of
  // their 3x5 window in the iterate tile, their residual-plane index, and bit
  // 3k+j of rmask when column j lies on the fine interior in (x, y)
  int rq[k3GPer], ri[k3GPer];
  unsigned rmask = 0;
#pragma unroll
  for (int k = 0; k < k3GPer; ++k) {
    const int g = tid + k * k3NT;
    const int ry = g / k3GX, rx = (g % k3GX) * k3G;
    rq[k] = g < k3Groups ? ry * k3IX + rx + 1 : 0;
    ri[k] = g < k3Groups ? ry * k3RX + rx : -1;
    const int fy = 2 * cy0 - 2 + ry;
#pragma unroll
    for (int j = 0; j < k3G; ++j) {
      const int fx = 2 * cx0 - 2 + rx + j;
      if (g < k3Groups && fy >= 1 && fy <= Y && fx >= 1 && fx <= X) rmask |= 1u << (k3G * k + j);
    }
  }

  // plane p into ring slot t; one commit group per call
  auto stage = [&](int p, int t) {
    const bool zin = p >= 1 && p <= Z;
    T* xd = xs[t % k3XSlots];
    T* bd = bs[t % k3BSlots];
#pragma unroll
    for (int k = 0; k < Ch::kPer; ++k) {
      const int q = tid + k * k3NT;
      if (q < Ch::kCount) {
        const bool v = zin && soff[k] >= 0;
        const long long g = v ? p * sp + soff[k] : 0;
        cp_async16(bd + q * Ch::kV, b + g, v);
        if constexpr (kMode == kK3Iterate) cp_async16(xd + q * Ch::kV, u + g, v);
        if constexpr (kMode == kK3ZeroScale) cp_async16(xd + q * Ch::kV, s + g, v);
      }
    }
    cp_async_commit();
  };

  const int fa = 2 * lo - 2, fb = 2 * hi - 2;
  const int pa = fa - 1, pb = fb + 1;  // pb - pa >= 2
#pragma unroll
  for (int a = 0; a < k3Ahead; ++a) {
    if (pa + a <= pb) {
      stage(pa + a, a);
    } else {
      cp_async_commit();
    }
  }
  T acc[k3GPer][k3G][3];  // residual planes p-1, p, p+1 of each column
#pragma unroll
  for (int k = 0; k < k3GPer; ++k)
#pragma unroll
    for (int j = 0; j < k3G; ++j) acc[k][j][0] = acc[k][j][1] = acc[k][j][2] = T(0);
  T cacc = T(0);  // this coarse column's open coarse plane
  for (int t = 0, p = pa; p <= pb; ++t, ++p) {
    cp_async_wait<k3Ahead - 1>();
    T* xc = xs[t % k3XSlots];
    if constexpr (kMode != kK3Iterate) {
      // the zero-guess iterate, once per point, from this thread's own copies
      const T* bc = bs[t % k3BSlots];
#pragma unroll
      for (int k = 0; k < Ch::kPer; ++k) {
        const int q = tid + k * k3NT;
        if (q < Ch::kCount) {
#pragma unroll
          for (int i = 0; i < Ch::kV; ++i) {
            const int e = q * Ch::kV + i;
            xc[e] = (kMode == kK3ZeroScale ? xc[e] : alpha) * bc[e];
          }
        }
      }
    }
    __syncthreads();
    if (p + k3Ahead <= pb) {
      stage(p + k3Ahead, t + k3Ahead);
    } else {
      cp_async_commit();  // keeps one group per step for the wait count
    }
#pragma unroll
    for (int k = 0; k < k3GPer; ++k) {
      if (ri[k] < 0) continue;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const T* q = xc + rq[k] + dy * k3IX;
        T n[k3G + 2];
#pragma unroll
        for (int i = 0; i < k3G + 2; ++i) n[i] = q[i];
#pragma unroll
        for (int j = 0; j < k3G; ++j)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            acc[k][j][0] += W.w[2][dy][dx] * n[j + dx];  // plane p is dz=+1 of plane p-1
            acc[k][j][1] += W.w[1][dy][dx] * n[j + dx];
            acc[k][j][2] += W.w[0][dy][dx] * n[j + dx];  // plane p is dz=-1 of plane p+1
          }
      }
    }
    const bool done = p > fa;  // residual plane p-1 is complete
    if (done) {
      const bool zin = p - 1 >= 1 && p - 1 <= Z;
      const T* bf = bs[(t - 1) % k3BSlots];
#pragma unroll
      for (int k = 0; k < k3GPer; ++k) {
        if (ri[k] < 0) continue;
#pragma unroll
        for (int j = 0; j < k3G; ++j)
          rs[ri[k] + j] = (zin && ((rmask >> (k3G * k + j)) & 1u))
                              ? bf[rq[k] + k3IX + 1 + j] - acc[k][j][0]
                              : T(0);
      }
    }
#pragma unroll
    for (int k = 0; k < k3GPer; ++k)
#pragma unroll
      for (int j = 0; j < k3G; ++j) {
        acc[k][j][0] = acc[k][j][1];
        acc[k][j][1] = acc[k][j][2];
        acc[k][j][2] = T(0);
      }
    if (done) {
      __syncthreads();
      const T* r = rs + 2 * ty * k3RX + 2 * tx;
      T v = T(0);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const T* row = r + dy * k3RX;
        const T h = T(0.5) * row[0] + row[1] + T(0.5) * row[2];
        v += dy == 1 ? h : T(0.5) * h;
      }
      const int j = p - 1 - fa;  // fine plane 2lo-2+j
      if (j & 1) {
        cacc += v;
      } else {
        if (j > 0 && own) out[(lo + j / 2 - 1) * csp] = c_in ? cacc + T(0.5) * v : T(0);
        cacc = T(0.5) * v;
      }
    }
  }
  cp_async_wait<0>();
}

// The plan (grid gx x gy x gz, zchunk coarse planes per block) must cover
// the padded coarse array exactly once with this file's tile.
template <typename T>
int k3_launch(const void* u_, const void* b_, const void* s_, void* rc_, const double* w,
              const int* dz, const int* dy, const int* dx, int ntaps, int Z, int Y, int X,
              int Yr, int Xr, int Zc, int Yc, int Xc, int Zcr, int Ycr, int Xcr,
              int zero_guess, int gx, int gy, int gz, int zchunk, double alpha_,
              cudaStream_t st) {
  Box27<T> box;
  if (!make_box27(&box, w, dz, dy, dx, ntaps)) return static_cast<int>(cudaErrorInvalidValue);
  if (zchunk < 1 || gx != (Xcr + k3BX - 1) / k3BX || gy != (Ycr + k3BY - 1) / k3BY ||
      gz != (Zcr + zchunk - 1) / zchunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* u = static_cast<const T*>(u_);
  const T* b = static_cast<const T*>(b_);
  const T* s = static_cast<const T*>(s_);
  T* rc = static_cast<T*>(rc_);
  const T alpha = static_cast<T>(alpha_);
  const dim3 grid(gx, gy, gz), block(k3NT);
  if (!zero_guess) {
    k3_kernel<T, kK3Iterate><<<grid, block, 0, st>>>(u, b, s, rc, box, Z, Y, X, Yr, Xr, Zc,
                                                     Yc, Xc, Zcr, Ycr, Xcr, zchunk, alpha);
  } else if (s != nullptr) {
    k3_kernel<T, kK3ZeroScale><<<grid, block, 0, st>>>(u, b, s, rc, box, Z, Y, X, Yr, Xr, Zc,
                                                       Yc, Xc, Zcr, Ycr, Xcr, zchunk, alpha);
  } else {
    k3_kernel<T, kK3ZeroAlpha><<<grid, block, 0, st>>>(u, b, s, rc, box, Z, Y, X, Yr, Xr, Zc,
                                                       Yc, Xc, Zcr, Ycr, Xcr, zchunk, alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int amg_k3_launch(int is_double, const void* u, const void* b, const void* s, void* rc,
                  const double* w, const int* dz, const int* dy, const int* dx, int ntaps,
                  int Z, int Y, int X, int Yr, int Xr, int Zc, int Yc, int Xc, int Zcr,
                  int Ycr, int Xcr, int zero_guess, int gx, int gy, int gz, int zchunk,
                  double alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return k3_launch<double>(u, b, s, rc, w, dz, dy, dx, ntaps, Z, Y, X, Yr, Xr, Zc, Yc, Xc,
                             Zcr, Ycr, Xcr, zero_guess, gx, gy, gz, zchunk, alpha, st);
  return k3_launch<float>(u, b, s, rc, w, dz, dy, dx, ntaps, Z, Y, X, Yr, Xr, Zc, Yc, Xc, Zcr,
                          Ycr, Xcr, zero_guess, gx, gy, gz, zchunk, alpha, st);
}

}  // extern "C"
