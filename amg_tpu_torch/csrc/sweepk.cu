// K2: K fused weighted-Jacobi sweeps per launch (K = 2, 3, 4) of the uniform
// 27-point box on the padded state.
//
// Replaces amg_tpu/ops/pallas_stencil.py::_sweepk_kernel (entry
// stencil_kernel_padded, modes sweep2|3|4 and sweep2|3|4_vec):
//   u^{k+1} = u^k + s (b - A u^k),   k = 0 .. K-1,   shell -> 0 every stage,
// with s a scalar alpha or a streamed per-point scale.
//
// Bound on the H100: bytes. One launch reads u, b (and s) and writes u^K:
// 3-4 state arrays for K sweeps, against 3-4 per sweep for K chained K1
// launches. The intermediate iterates never reach device memory.
//
// Design: one block per output tile (TZ, TY, TX). The block loads u over the
// tile plus a reach-K halo, and b (and s) over a reach-(K-1) halo, into
// shared memory (zero outside the array). Stage k computes u^{k+1} on the
// tile plus a reach-(K-1-k) halo from u^k in the other of two ping-pong
// buffers, so the window shrinks by one cell per side per stage; points off
// the interior get 0 at every stage, as a K1 launch writes them. The last
// stage writes the tile to device memory once. The halos are recomputed by
// neighbouring blocks. Each point's box sum is apply_taps over the same tap
// list as K1 (offsets taken in the shared-memory window's strides) and the
// update is jacobi_update, so K2 equals K chained K1 launches bit for bit.
// The tile is sized from K, the dtype and the number of streams so that the
// shared memory of two blocks fits one SM (k2_pick_tile). Threads walk each
// window as a flat index (all lanes busy on the ragged halo widths) with its
// (z, y, x) carried incrementally, and index shared memory in 32 bits. No
// TMA or asynchronous copies yet.
#include "common.cuh"

using namespace amg;

namespace {

constexpr int kThreads = 256;
constexpr int kTileX = 32;
// two resident blocks per SM share its 227 KB of shared memory
constexpr size_t kSmemBudget = 112 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

struct Tile {
  int tz, ty, tx;
};

size_t k2_smem_bytes(Tile t, int K, int nstreams, size_t elem) {
  const size_t full = size_t(t.tz + 2 * K) * (t.ty + 2 * K) * (t.tx + 2 * K);
  const size_t inner = size_t(t.tz + 2 * K - 2) * (t.ty + 2 * K - 2) * (t.tx + 2 * K - 2);
  return (2 * full + nstreams * inner) * elem;
}

// The deepest tile, in this order, whose buffers fit the two-block budget
// (or, failing that, one block per SM). The choices (tz x ty x tx, bytes):
//            float32 scalar   float32 _vec     float64 scalar   float64 _vec
//   K = 2    8x8x32  55,072   8x8x32  68,672   8x8x32 110,144   4x8x32  87,936
//   K = 3    8x8x32  80,320   8x8x32 101,056   4x8x32 112,768   4x4x32  97,664
//   K = 4    8x8x32 111,712   4x8x32 104,000   2x4x32 101,120   2x2x32 102,912
bool k2_pick_tile(int K, int use_scale, size_t elem, Tile* out, size_t* bytes) {
  const Tile cand[] = {{8, 8, kTileX}, {4, 8, kTileX}, {4, 4, kTileX},
                       {2, 4, kTileX}, {2, 2, kTileX}, {1, 2, kTileX}, {1, 1, kTileX}};
  const int ns = use_scale ? 2 : 1;
  const size_t budgets[] = {kSmemBudget, kSmemMax};
  for (size_t budget : budgets) {
    for (const Tile& t : cand) {
      const size_t b = k2_smem_bytes(t, K, ns, elem);
      if (b <= budget) {
        *out = t;
        *bytes = b;
        return true;
      }
    }
  }
  return false;
}

// (z, y, x) of the flat index i of an (NZ, NY, NX) box, advanced by
// kThreads per step with carries instead of a division per point.
struct Walk {
  int x, y, z, dx, dy, dz, nx, ny;
  __device__ Walk(int i, int NX, int NY)
      : x(i % NX), y((i / NX) % NY), z(i / (NX * NY)), dx(kThreads % NX),
        dy((kThreads / NX) % NY), dz(kThreads / (NX * NY)), nx(NX), ny(NY) {}
  __device__ void step() {
    x += dx;
    y += dy;
    z += dz;
    if (x >= nx) {
      x -= nx;
      ++y;
    }
    if (y >= ny) {
      y -= ny;
      ++z;
    }
  }
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    k2_kernel(const T* __restrict__ u, const T* __restrict__ b, const T* __restrict__ s,
              T* __restrict__ out, const Taps<T> taps, int K, int TZ, int TY, int TX, int Z,
              int Y, int X, int Zr, int Yr, int Xr, T alpha) {
  extern __shared__ unsigned char smem_raw[];
  const int FZ = TZ + 2 * K, FY = TY + 2 * K, FX = TX + 2 * K;  // u window
  const int IZ = FZ - 2, IY = FY - 2, IX = FX - 2;              // b, s window
  const int nfull = FZ * FY * FX, ninner = IZ * IY * IX;
  T* buf0 = reinterpret_cast<T*>(smem_raw);
  T* buf1 = buf0 + nfull;
  T* bw = buf1 + nfull;
  T* sw = bw + ninner;
  // global coordinates of the u window's first point
  const int z0 = blockIdx.z * TZ - K, y0 = blockIdx.y * TY - K, x0 = blockIdx.x * TX - K;
  const long long plane = static_cast<long long>(Yr) * Xr;
  auto in_array = [=](int gz, int gy, int gx) {
    return gz >= 0 && gz < Zr && gy >= 0 && gy < Yr && gx >= 0 && gx < Xr;
  };

  Walk w(threadIdx.x, FX, FY);
  for (int i = threadIdx.x; i < nfull; i += kThreads, w.step()) {
    const int gz = z0 + w.z, gy = y0 + w.y, gx = x0 + w.x;
    buf0[i] = in_array(gz, gy, gx) ? __ldg(u + gz * plane + static_cast<long long>(gy) * Xr + gx)
                                   : T(0);
  }
  Walk q(threadIdx.x, IX, IY);
  for (int i = threadIdx.x; i < ninner; i += kThreads, q.step()) {
    const int gz = z0 + 1 + q.z, gy = y0 + 1 + q.y, gx = x0 + 1 + q.x;
    const bool ok = in_array(gz, gy, gx);
    const long long g = gz * plane + static_cast<long long>(gy) * Xr + gx;
    bw[i] = ok ? __ldg(b + g) : T(0);
    if (kVec) sw[i] = ok ? __ldg(s + g) : T(0);
  }
  __syncthreads();

  const T* src = buf0;
  T* dst = buf1;
  for (int st = 0; st < K; ++st) {
    const int h = K - 1 - st;  // halo of this stage's output window
    const int OZ = TZ + 2 * h, OY = TY + 2 * h, OX = TX + 2 * h;
    const int nout = OZ * OY * OX;
    const bool last = st == K - 1;
    Walk o(threadIdx.x, OX, OY);
    for (int i = threadIdx.x; i < nout; i += kThreads, o.step()) {
      // window coordinates p (in the u window) of output point i
      const int px = o.x + K - h, py = o.y + K - h, pz = o.z + K - h;
      const int gz = z0 + pz, gy = y0 + py, gx = x0 + px;
      const int fi = (pz * FY + py) * FX + px;
      T val = T(0);
      if (interior(gz, gy, gx, Z, Y, X)) {
        const T acc = apply_taps(taps, fi, [src](int k) { return src[k]; });
        const int bi = ((pz - 1) * IY + (py - 1)) * IX + (px - 1);
        val = jacobi_update(src[fi], bw[bi], kVec ? sw[bi] : alpha, acc);
      }
      if (!last) {
        dst[fi] = val;
      } else if (in_array(gz, gy, gx)) {
        out[gz * plane + static_cast<long long>(gy) * Xr + gx] = val;
      }
    }
    __syncthreads();
    const T* t = src;
    src = dst;
    dst = const_cast<T*>(t);
  }
}

template <typename T, bool kVec>
int launch(const void* u, const void* b, const void* s, void* out, const double* w,
           const int* dz, const int* dy, const int* dx, int ntaps, int Z, int Y, int X, int Zr,
           int Yr, int Xr, int K, double alpha, cudaStream_t stream) {
  Tile t;
  size_t bytes;
  if (!k2_pick_tile(K, kVec, sizeof(T), &t, &bytes)) return static_cast<int>(cudaErrorInvalidValue);
  Taps<T> taps;
  const int FY = t.ty + 2 * K, FX = t.tx + 2 * K;
  if (!make_taps(&taps, w, dz, dy, dx, ntaps, FY * FX, FX))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(k2_kernel<T, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Xr + t.tx - 1) / t.tx, (Yr + t.ty - 1) / t.ty, (Zr + t.tz - 1) / t.tz);
  k2_kernel<T, kVec><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(b), static_cast<const T*>(s),
      static_cast<T*>(out), taps, K, t.tz, t.ty, t.tx, Z, Y, X, Zr, Yr, Xr,
      static_cast<T>(alpha));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int amg_k2_launch(int is_double, const void* u, const void* b, const void* s, void* out,
                  const double* w, const int* dz, const int* dy, const int* dx, int ntaps,
                  int Z, int Y, int X, int Zr, int Yr, int Xr, int nsweep, int use_scale,
                  double alpha, void* stream) {
  if (nsweep < 2 || nsweep > 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) {
    if (use_scale)
      return launch<double, true>(u, b, s, out, w, dz, dy, dx, ntaps, Z, Y, X, Zr, Yr, Xr,
                                  nsweep, alpha, st);
    return launch<double, false>(u, b, s, out, w, dz, dy, dx, ntaps, Z, Y, X, Zr, Yr, Xr,
                                 nsweep, alpha, st);
  }
  if (use_scale)
    return launch<float, true>(u, b, s, out, w, dz, dy, dx, ntaps, Z, Y, X, Zr, Yr, Xr, nsweep,
                               alpha, st);
  return launch<float, false>(u, b, s, out, w, dz, dy, dx, ntaps, Z, Y, X, Zr, Yr, Xr, nsweep,
                              alpha, st);
}

}  // extern "C"
