// K1 on tap lists: the constant-weight stencil kernel for any reach-1 tap
// list but the uniform 27-point box (the RAP coarse levels), a z-march on the
// padded state. The uniform box goes to csrc/box_march.cu.
//
// Replaces amg_tpu/ops/pallas_stencil.py::_sweep_kernel's tap-list path
// (entry stencil_kernel_padded). Modes, at every interior point p (shell -> 0):
//   0 spmv            out = A u
//   1 residual        out = b - A u
//   2 sweep           out = u + alpha (b - A u)
//   3 sweep_vec       out = u + s (b - A u)
//   4 sweep_vec_norm  sweep_vec, plus one partial sum of r^2 (r = b - A u of
//                     the incoming u) per block into partials[]; the caller
//                     sums the partials with torch.sum (no float atomics).
//
// Bound on the H100: bytes, and below them the launch. sweep_vec reads u, b,
// s and writes out: at the RAP level 63^3 in float32 4 x 1.15 MB in this
// layout, 1.4 us at 3.35 TB/s (32^3: 0.2 us), so there the launch, the fill
// of the card and the latency of each z-step are the floor; 27 taps are 54
// operations a point.
//
// Design. A 256-thread block owns a 32x8 (x, y) output tile and walks a
// chunk of z-planes; the launch plan comes from the Python wrapper
// (ops/stencil.py::k1_taps_plan) and the kernel refuses one that does not
// cover the array.
//   - u enters a ring of window planes of WX x WY = 40 x 10 points (the
//     tile, one row each side, 4 columns each side: 16-byte-aligned rows) by
//     16-byte cp.async chunks; b, and s in the _vec modes, a ring of tile
//     planes. kAhead steps of copies are in flight ahead of their use;
//     rows and planes outside the array, and planes the chunk does not
//     read, are zero-filled (nothing is read for them).
//   - A step outputs kP = 2 planes: the lower four warps plane n, the upper
//     four plane n+1, each thread two rows (r, r+1) of one column. One
//     barrier a step: after it every copy of the step has landed and every
//     read of the step before has ended, so the step's copies go into the
//     slots that step read.
//   - Two routes, chosen on the host (ops/stencil.py::tap_route). The 27
//     offsets (-1, 0, 1)^3 in product order, the layout of every RAP level:
//     the offsets are compile-time constants and each plane's 4x3
//     neighbourhood of the two rows is loaded once (36 loads for 54 taps).
//     Any other list of <= 27 taps: the offsets by value, each tap's plane
//     chosen among n-1, n, n+1.
//   - sweep_vec_norm sums r^2 per thread, then per block in a fixed order.
// On the card (tools/torch_tap_variants.py, float32 sweep_vec) the z-steps
// bound it, not the bytes: at 63^3 the compute and barriers alone (no
// copies) take 3/4 of the kernel's time and the copies and barriers alone
// (no sums) 4/5. One step of copies in flight beats two or three (the
// chunks are a few planes long); one plane a step ties with two at 63^3.
// Rounding. The taps are summed in list order as add_rn(acc, mul_rn(w, v))
// and the modes finished with sub_rn and jacobi_update_rn (common.cuh), every
// operation rounded on its own, as ops/stencil.py::stencil_plain computes:
// the kernel equals it bit for bit on both routes (the norm's partials aside).
#include "common.cuh"

using namespace amg;

namespace {

constexpr int kTX = 32;  // tile, x; ops/stencil.py::ZMARCH_TILE mirrors (kTY, kTX)
constexpr int kTY = 8;   // tile, y
constexpr int kNT = 256;
constexpr int kHX = 4;              // window columns each side of the tile
constexpr int kWX = kTX + 2 * kHX;  // 40
constexpr int kWY = kTY + 2;        // 10
constexpr int kPlane = kWX * kWY;   // a window plane
constexpr int kTPlane = kTX * kTY;  // a tile plane
constexpr int kP = 2;               // planes a step
constexpr int kAhead = 1;           // steps of copies in flight ahead of their use
constexpr int kWSlots = kP * (kAhead + 1) + 2;  // window planes n-1 .. n+kP(kAhead+1)
constexpr int kTSlots = kP * (kAhead + 1);      // tile planes n .. n+kP(kAhead+1)-1
constexpr int kGroup = kTX * kTY / 2;  // threads a plane: 32 columns x 4 row pairs
constexpr int kStaticSmem = 48 * 1024;
static_assert(kP * kGroup <= kNT, "two rows a thread");

enum Mode { kSpmv = 0, kResidual = 1, kSweep = 2, kSweepVec = 3, kSweepVecNorm = 4 };

// ops/stencil.py::tap_route: 0 any list, 2 the 27 taps (-1, 0, 1)^3 in
// product order (1, the uniform box, is box_march.cu's)
enum Route { kTapList = 0, kDense27 = 2 };

__host__ __device__ constexpr bool needs_b(int mode) { return mode != kSpmv; }
__host__ __device__ constexpr bool needs_s(int mode) {
  return mode == kSweepVec || mode == kSweepVecNorm;
}
__host__ __device__ constexpr int tile_streams(int mode) {
  return int(needs_b(mode)) + int(needs_s(mode));
}

template <typename T, int kMode>
constexpr size_t smem_bytes() {
  return (size_t(kWSlots) * kPlane + size_t(tile_streams(kMode)) * kTSlots * kTPlane) *
         sizeof(T);
}

// A tap list in the window: tap k adds w[k] * v at in-plane offset
// off[k] = dy*kWX + dx of plane n + dz[k]
template <typename T>
struct TapList {
  T w[kMaxTaps];
  int off[kMaxTaps];
  int dz[kMaxTaps];
  int n;
};

// ring slot of plane p (p >= -1)
template <int kN>
__device__ __forceinline__ int slot(int p) {
  return (p + kN) % kN;
}

template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[kNT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = T(0);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kNT / 32; ++w) s += warp_sums[w];
  }
  return s;
}

// Block (bx, by, bz): output columns x0 .. x0+31, rows y0 .. y0+7 of planes
// c0 .. c1-1 (c0 = bz*zchunk). Window point (wy, wx) is padded (y0-1+wy,
// x0-4+wx); tile point (ty, tx) is padded (y0+ty, x0+tx).
template <typename T, int kRoute, int kMode>
__global__ void __launch_bounds__(kNT)
    tap_march_kernel(const T* __restrict__ u, const T* __restrict__ b,
                     const T* __restrict__ s, T* __restrict__ out, T* __restrict__ partials,
                     const TapList<T> taps, T alpha, int Z, int Y, int X, int Zr, int Yr,
                     int Xr, int zchunk) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));  // elements per chunk
  constexpr int kRowChunks = kWX / kV;
  constexpr int kChunks = kRowChunks * kWY;
  constexpr int kTRowChunks = kTX / kV;
  constexpr int kTChunks = kTRowChunks * kTY;
  constexpr int kNS = tile_streams(kMode);
  static_assert(kWX % kV == 0 && kTX % kV == 0 && kHX % kV == 0, "whole chunks");
  static_assert(kChunks <= kNT && kNS * kTChunks <= kNT, "one chunk a thread and plane");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const win = reinterpret_cast<T*>(smem_raw);  // [kWSlots][kPlane]: u
  T* const tile = win + kWSlots * kPlane;         // [kNS][kTSlots][kTPlane]: b, s

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int c0 = blockIdx.z * zchunk, c1 = min(c0 + zchunk, Zr);
  const int sp = Yr * Xr;  // the launcher refuses arrays of 2^31 values

  // this thread's window chunk (in-plane offset, -1 off the array or past
  // the chunks) and tile chunk (its stream's source, slot offset and
  // in-plane offset; tdst -1 past the chunks, toff -1 off the array)
  int soff, tdst, toff;
  const T* tsrc;
  {
    const int gy = y0 - 1 + tid / kRowChunks, gx = x0 - kHX + (tid % kRowChunks) * kV;
    soff = tid < kChunks && gy >= 0 && gy < Yr && gx >= 0 && gx + kV <= Xr ? gy * Xr + gx : -1;
    const int q = tid % kTChunks, stream = tid / kTChunks;
    const int ry = q / kTRowChunks, rx = (q % kTRowChunks) * kV;
    tsrc = stream == 0 ? b : s;
    tdst = stream < kNS ? stream * kTSlots * kTPlane + ry * kTX + rx : -1;
    toff = y0 + ry < Yr && x0 + rx + kV <= Xr ? (y0 + ry) * Xr + x0 + rx : -1;
  }
  // window plane p of u (the chunk reads c0-1 .. c1) into its ring slot
  auto fetch_window = [&](int p) {
    if (tid < kChunks) {
      const bool v = p >= 0 && p < Zr && p <= c1 && soff >= 0;
      cp_async16(win + slot<kWSlots>(p) * kPlane + tid * kV, u + (v ? p * sp + soff : 0), v);
    }
  };
  // tile plane p of b (and s) (the chunk reads c0 .. c1-1) into its ring slot
  auto fetch_tile = [&](int p) {
    if constexpr (kNS > 0) {
      if (tdst >= 0) {
        const bool v = p >= c0 && p < c1 && toff >= 0;
        cp_async16(tile + tdst + slot<kTSlots>(p) * kTPlane, tsrc + (v ? p * sp + toff : 0), v);
      }
    }
  };
  // the copies that step n (output planes n .. n+kP-1) reads first: window
  // planes n+1 .. n+kP and tile planes n .. n+kP-1; one commit group
  auto fetch_step = [&](int n) {
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      fetch_window(n + 1 + i);
      fetch_tile(n + i);
    }
    cp_async_commit();
  };

  // this thread's output points: plane n + tid/kGroup of step n, rows orow
  // and orow+1 of column ocol
  const int g = tid / kGroup, lt = tid % kGroup;
  const int ocol = lt % kTX, orow = 2 * (lt / kTX), ox = x0 + ocol;
  const int wc = (orow + 1) * kWX + kHX + ocol;  // window index of row orow's point
  const int tc = orow * kTX + ocol;              // tile index of row orow's point
  const bool x_in = ox >= 1 && ox <= X;

  fetch_window(c0 - 1);
  fetch_window(c0);
#pragma unroll
  for (int a = 0; a < kAhead; ++a) fetch_step(c0 + a * kP);

  T sq = T(0);
  for (int n = c0; n < c1; n += kP) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of step n
    __syncthreads();
    fetch_step(n + kAhead * kP);

    const int m = n + g;  // this thread's output plane
    if (g < kP && m < c1) {
      const T* wm = win + slot<kWSlots>(m - 1) * kPlane;
      const T* w0 = win + slot<kWSlots>(m) * kPlane;
      const T* wp = win + slot<kWSlots>(m + 1) * kPlane;
      T acc[2] = {T(0), T(0)};
      if constexpr (kRoute == kDense27) {
        // per plane dz, the two rows' 4x3 neighbourhood loaded once, then
        // its 9 taps for both rows, in product (= list) order
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          const T* pb = (dz == 0 ? wm : dz == 1 ? w0 : wp) + wc - kWX - 1;
          T v[4][3];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) v[r][dx] = pb[r * kWX + dx];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const T w = taps.w[dz * 9 + dy * 3 + dx];
              acc[0] = add_rn(acc[0], mul_rn(w, v[dy][dx]));
              acc[1] = add_rn(acc[1], mul_rn(w, v[dy + 1][dx]));
            }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) {
          if (k < taps.n) {
            const int dz = taps.dz[k];
            const T* q = (dz < 0 ? wm : dz > 0 ? wp : w0) + wc + taps.off[k];
            acc[0] = add_rn(acc[0], mul_rn(taps.w[k], q[0]));
            acc[1] = add_rn(acc[1], mul_rn(taps.w[k], q[kWX]));
          }
        }
      }
      const T* bt = tile + slot<kTSlots>(m) * kTPlane + tc;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int oy = y0 + orow + r;
        if (oy < Yr && ox < Xr) {
          T val = T(0);
          if (m >= 1 && m <= Z && oy >= 1 && oy <= Y && x_in) {
            if constexpr (kMode == kSpmv) {
              val = acc[r];
            } else {
              const T bv = bt[r * kTX];
              if constexpr (kMode == kResidual) {
                val = sub_rn(bv, acc[r]);
              } else {
                const T uc = w0[wc + r * kWX];
                const T sv = needs_s(kMode) ? bt[kTSlots * kTPlane + r * kTX] : alpha;
                if constexpr (kMode == kSweepVecNorm) {
                  const T r2 = sub_rn(bv, acc[r]);
                  sq += r2 * r2;
                }
                val = jacobi_update_rn(uc, bv, sv, acc[r]);
              }
            }
          }
          out[m * sp + oy * Xr + ox] = val;
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (kMode == kSweepVecNorm) {
    const T total = block_sum(sq);
    if (tid == 0)
      partials[(static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
               blockIdx.x] = total;
  }
}

// Sets the kernel's dynamic shared-memory limit once per device (outside any
// stream work, so a later graph capture of the launch needs no attribute call).
template <typename T, int kRoute, int kMode>
cudaError_t prepare() {
  constexpr size_t bytes = smem_bytes<T, kMode>();
  if (bytes <= kStaticSmem) return cudaSuccess;
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(tap_march_kernel<T, kRoute, kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

struct Args {
  const void *u, *b, *s;
  void *out, *partials;
  double alpha;
  int Z, Y, X, Zr, Yr, Xr, zchunk;
  dim3 grid;
  cudaStream_t st;
};

template <typename T, int kRoute, int kMode>
int launch(const Args& a, const TapList<T>& taps) {
  const cudaError_t err = prepare<T, kRoute, kMode>();
  if (err != cudaSuccess) return static_cast<int>(err);
  tap_march_kernel<T, kRoute, kMode><<<a.grid, kNT, smem_bytes<T, kMode>(), a.st>>>(
      static_cast<const T*>(a.u), static_cast<const T*>(a.b), static_cast<const T*>(a.s),
      static_cast<T*>(a.out), static_cast<T*>(a.partials), taps, static_cast<T>(a.alpha), a.Z,
      a.Y, a.X, a.Zr, a.Yr, a.Xr, a.zchunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kRoute>
int launch_mode(int mode, const Args& a, const TapList<T>& taps) {
  switch (mode) {
    case kSpmv:
      return launch<T, kRoute, kSpmv>(a, taps);
    case kResidual:
      return launch<T, kRoute, kResidual>(a, taps);
    case kSweep:
      return launch<T, kRoute, kSweep>(a, taps);
    case kSweepVec:
      return launch<T, kRoute, kSweepVec>(a, taps);
    default:
      return launch<T, kRoute, kSweepVecNorm>(a, taps);
  }
}

template <typename T>
int launch_typed(int route, int mode, const Args& a, const double* w, const int* dz,
                 const int* dy, const int* dx, int ntaps) {
  TapList<T> taps{};
  taps.n = ntaps;
  for (int k = 0; k < ntaps; ++k) {
    taps.w[k] = static_cast<T>(w[k]);
    taps.off[k] = dy[k] * kWX + dx[k];
    taps.dz[k] = dz[k];
  }
  if (route == kDense27) return launch_mode<T, kDense27>(mode, a, taps);
  return launch_mode<T, kTapList>(mode, a, taps);
}

}  // namespace

extern "C" {

// route (enum Route) 2 takes the 27 taps at (-1, 0, 1)^3 in product order
// (refused otherwise), 0 any reach-1 list of at most 27 taps. mode 0-4 as
// above; partials has gx*gy*gz entries for mode 4. The plan (grid gx x gy x
// gz, zchunk planes per block) must cover the padded array exactly once with
// the 32 x 8 tile; u, b and s (those the mode reads) must be 16-byte aligned.
int amg_k1_taps_launch(int is_double, const void* u, const void* b, const void* s, void* out,
                       void* partials, const double* w, const int* dz, const int* dy,
                       const int* dx, int ntaps, int route, int Z, int Y, int X, int Zr,
                       int Yr, int Xr, int mode, int gx, int gy, int gz, int zchunk,
                       double alpha, void* stream) {
  if (zchunk < 1 || gx != (Xr + kTX - 1) / kTX || gy != (Yr + kTY - 1) / kTY ||
      gz != (Zr + zchunk - 1) / zchunk || Xr % 4 != 0 || Zr != Z + 2 || Yr != Y + 2 ||
      Xr < X + 2 || static_cast<long long>(Zr) * Yr * Xr >= (1LL << 31) || mode < kSpmv ||
      mode > kSweepVecNorm || u == nullptr || out == nullptr ||
      (needs_b(mode) && b == nullptr) || (needs_s(mode) && s == nullptr) ||
      (mode == kSweepVecNorm && partials == nullptr) || misaligned16(u) || misaligned16(b) ||
      misaligned16(s) || ntaps < 0 || ntaps > kMaxTaps || (route != kTapList && route != kDense27))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < ntaps; ++k) {
    if (dz[k] < -1 || dz[k] > 1 || dy[k] < -1 || dy[k] > 1 || dx[k] < -1 || dx[k] > 1)
      return static_cast<int>(cudaErrorInvalidValue);
    if (route == kDense27 &&
        (ntaps != 27 || dz[k] != k / 9 - 1 || dy[k] != k / 3 % 3 - 1 || dx[k] != k % 3 - 1))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{u, b, s, out, partials, alpha, Z, Y, X, Zr, Yr, Xr, zchunk, dim3(gx, gy, gz),
               static_cast<cudaStream_t>(stream)};
  if (is_double) return launch_typed<double>(route, mode, a, w, dz, dy, dx, ntaps);
  return launch_typed<float>(route, mode, a, w, dz, dy, dx, ntaps);
}

}  // extern "C"
