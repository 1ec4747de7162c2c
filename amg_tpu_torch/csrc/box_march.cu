// The box march: K1 on the uniform 27-point box (K = 1) and K2 (K = 2..4)
// as one z-marching kernel on the padded state.
//
// Replaces, for the uniform box (A u = w_off * boxsum(u) + (w_c - w_off) u),
//   amg_tpu/ops/pallas_stencil.py::_sweep_kernel's box fast path (K1 modes,
//     K = 1): spmv, residual, sweep, sweep_vec, sweep_vec_norm;
//   amg_tpu/ops/pallas_stencil.py::_sweepk_kernel (K2, K = 2, 3, 4):
//     u^{k} = u^{k-1} + s (b - A u^{k-1}), k = 1 .. K, s a scalar alpha or a
//     streamed per-point scale.
// Every stage writes 0 off the interior (the shell and the pad columns), as
// the reference does. Other tap lists go to csrc/tap_march.cu.
//
// Bound on the H100: bytes. A launch reads u, b (and s) and writes its
// output once: 3-4 state arrays (8.4 MB each at 126^3 in float32), ~10 us at
// 3.35 TB/s, for any K; the box costs ~14 operations per point and stage.
//
// Design. A 256-thread block owns a 32x8 (x, y) output tile and walks a
// chunk of z-planes; the launch plan (chunk and grid) comes from the Python
// wrapper (ops/stencil.py::box_plan) and the kernel refuses one that does not
// cover the array. All planes of a block share one shared-memory window of
// WX x WY = 40 x (8 + 2K) points: the tile plus 4 columns each side in x (so
// that rows start 16-byte aligned) and K rows each side in y.
//   - u, b and s enter rings of planes by 16-byte cp.async chunks (rows and
//     planes outside the array are zero-filled), kAhead planes ahead of
//     their use (b and s only over stage 1's region); the wrapper refuses
//     arrays that are not 16-byte aligned.
//   - Stage k (1..K) computes u^k at plane z_k = n - 2(k-1) at step n, on
//     the tile plus a K-k halo. A step is (a) the z-sum t = (m + c) + p of
//     u^0 at plane n, each thread over the chunks it copied itself, with
//     the running pair m + c in registers (no barrier between its copies
//     and its reads); a barrier; (b) the y-sums of every stage's z-sums, one
//     thread per 4 rows of a column, sliding down the column in registers;
//     a barrier; (c) the x-sums, the centre, b and s, the update. Stage k < K
//     writes u^k into a ring (the centre of stage k+1) and forms stage k+1's
//     z-sum at plane z_k - 1 in registers, from its own points' earlier
//     values; stage K writes device memory. Two barriers per step for any
//     K; the lag of two planes per stage keeps every read behind its write
//     by a barrier. Every point costs 3 shared reads in y, 3 in x and one
//     z-sum, against 27 taps in the tap-list kernel.
//   - b and s: stage 1 reads them from its rings; the later stages read the
//     same planes again, two steps per stage later, through L1 (the copies
//     keep them there: cp.async.ca).
//   - Each thread's points are fixed for all planes, so their window
//     indices, array offsets and x-y interior flags are computed once per
//     block.
//   - The only recompute is the x-y halo (the window is 40 x 10 for a 32 x 8
//     tile at K = 1) and 3(K-1) planes at each chunk's ends (the warm-up).
//   - sweep_vec_norm (K = 1) sums r^2 per thread, then per block, in a fixed
//     order, into one partial per block; no float atomics.
// On the card (tools/torch_box_variants.py) the steps bound it, not the
// bytes: at K = 1 the copies and the compute each take ~2/3 of the time and
// overlap in part; at K = 3 the compute alone takes as long as the kernel.
// Rounding. Each point goes through common.cuh's add_rn (the z-sum),
// box_axis_sum, box_combine and jacobi_update_rn, which round every
// operation on its own, in the reference's order. So K = 1 and K = 2..4 are one template with one
// arithmetic, and a K2 launch equals K chained K1 launches bit for bit; it
// also rounds as ops/stencil.py's plain version does.
#include "common.cuh"

using namespace amg;

namespace {

constexpr int kTX = 32;  // tile, x; ops/stencil.py::BOX_TILE mirrors (kTY, kTX)
constexpr int kTY = 8;   // tile, y
constexpr int kNT = 256;
constexpr int kHX = 4;  // window columns each side of the tile (16-byte aligned rows)
constexpr int kWX = kTX + 2 * kHX;
constexpr int kSlots = 4;  // planes per ring of a stage's output (u^k, k >= 1)
constexpr int kAhead = 1;  // planes of u, b and s in flight ahead of their use
constexpr int kUSlots = kAhead + 2;  // u planes n .. n+1+kAhead at step n
constexpr int kBSlots = kAhead + 1;  // b, s planes n .. n+kAhead at step n
constexpr int kR = 4;  // rows per y-phase task
constexpr int kStaticSmem = 48 * 1024;

enum Mode { kSpmv = 0, kResidual = 1, kSweep = 2, kSweepVec = 3, kSweepVecNorm = 4 };

template <int K>
struct Win {
  static constexpr int kWY = kTY + 2 * K;
  static constexpr int kPlane = kWX * kWY;
};

__host__ __device__ constexpr bool needs_b(int mode) { return mode != kSpmv; }
__host__ __device__ constexpr bool needs_s(int mode) {
  return mode == kSweepVec || mode == kSweepVecNorm;
}

// ring slot of plane p (p >= -kHX - 1)
template <int kN>
__device__ __forceinline__ int slot(int p) {
  return (p + 8 * kN) % kN;
}

template <typename T, int K, int kMode>
constexpr size_t march_smem_bytes() {
  // the u ring, K-1 stage rings (u^1 .. u^{K-1}), K z-sum and K y-sum
  // planes, the b and s rings
  return size_t(kUSlots + (K - 1) * kSlots + 2 * K +
                (int(needs_b(kMode)) + int(needs_s(kMode))) * kBSlots) *
         Win<K>::kPlane * sizeof(T);
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

// Block (bx, by, bz): output columns x0 .. x0+31, y0 .. y0+7 of padded planes
// c0 .. c1-1 (c0 = bz*zchunk). Window point (wx, wy) is padded (x0-4+wx,
// y0-K+wy). Stage k's planes lo_k = c0-(K-k) .. hi_k = c1-1+(K-k) are those
// the later stages read; stage k computes plane n-2(k-1) at step n, for n
// from c0-K+1 to c1+2K-3.
template <typename T, int K, int kMode>
__global__ void __launch_bounds__(kNT)
    box_march_kernel(const T* __restrict__ u, const T* __restrict__ b,
                     const T* __restrict__ s, T* __restrict__ out, T* __restrict__ partials,
                     T w_off, T w_cm, T alpha, int Z, int Y, int X, int Zr, int Yr, int Xr,
                     int zchunk) {
  using W = Win<K>;
  constexpr int kV = 16 / static_cast<int>(sizeof(T));  // elements per chunk
  constexpr int kRowChunks = kWX / kV;
  constexpr int kChunks = kRowChunks * W::kWY;
  constexpr int kChunksPer = (kChunks + kNT - 1) / kNT;
  // b and s: the chunks of rows 1 .. WY-2 that cover columns kHX-(K-1) ..
  // kHX+kTX+K-2 (stage 1's x-phase region)
  constexpr int kBC0 = (kHX - (K - 1)) / kV;
  constexpr int kBRowChunks = (kHX + kTX + K - 1 + kV - 1) / kV - kBC0;
  constexpr int kBChunks = kBRowChunks * (W::kWY - 2);
  constexpr int kBChunksPer = (kBChunks + kNT - 1) / kNT;
  constexpr bool kNeedB = needs_b(kMode);
  constexpr bool kNeedS = needs_s(kMode);
  // per thread: stage 1's x-phase points (tile plus a K-1 halo, the largest
  // region) and y-phase tasks (kR rows of one column; at most 40 x 4 tasks)
  constexpr int kXPer = ((kTX + 2 * (K - 1)) * (kTY + 2 * (K - 1)) + kNT - 1) / kNT;
  static_assert((kTX + 2 * K) * ((kTY + 2 * (K - 1) + kR - 1) / kR) <= kNT, "one y task");
  static_assert(K >= 1 && K <= kHX, "K = 1 .. 4");
  static_assert(kWX % kV == 0, "window rows split into whole chunks");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const uring = reinterpret_cast<T*>(smem_raw);        // [kUSlots]: u^0
  T* const rings = uring + kUSlots * W::kPlane;           // [K-1][kSlots]: u^1 ..
  T* const tz = rings + (K - 1) * kSlots * W::kPlane;     // [K]: z-sums
  T* const ty = tz + K * W::kPlane;                       // [K]: y-sums of the z-sums
  T* const bring = ty + K * W::kPlane;                    // [kBSlots]
  T* const sring = bring + (kNeedB ? kBSlots : 0) * W::kPlane;  // [kBSlots]

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int gx0 = x0 - kHX, gy0 = y0 - K;  // padded coordinates of window (0, 0)
  const int c0 = blockIdx.z * zchunk, c1 = min(c0 + zchunk, Zr);
  const long long sp = static_cast<long long>(Yr) * Xr;

  auto in_array = [&](int gy, int gx) { return gy >= 0 && gy < Yr && gx >= 0 && gx + kV <= Xr; };
  // this thread's u chunks (the whole window): in-plane offset, or -1 off the array
  int soff[kChunksPer];
#pragma unroll
  for (int j = 0; j < kChunksPer; ++j) {
    const int q = tid + j * kNT;
    const int gy = gy0 + q / kRowChunks;
    const int gx = gx0 + (q % kRowChunks) * kV;
    soff[j] = q < kChunks && in_array(gy, gx) ? gy * Xr + gx : -1;
  }
  // this thread's b and s chunks: window index (-1 past them) and in-plane
  // offset (-1 off the array)
  int bdst[kBChunksPer], boff[kBChunksPer];
#pragma unroll
  for (int j = 0; j < kBChunksPer; ++j) {
    const int q = tid + j * kNT;
    const int row = 1 + q / kBRowChunks, col = (kBC0 + q % kBRowChunks) * kV;
    const int gy = gy0 + row, gx = gx0 + col;
    bdst[j] = q < kBChunks ? row * kWX + col : -1;
    boff[j] = q < kBChunks && in_array(gy, gx) ? gy * Xr + gx : -1;
  }
  // this thread's work, the same for every plane. Stage k's x-phase region is
  // the tile plus a K-k halo, its y-phase region that plus one column each
  // side. Per stage and round j: the x-phase window index (wx, -1 past the
  // region), in-plane array offset (gx, -1 off the array) and bit
  // (k-1)*kXPer+j of inx when the point is on the x-y interior; the y-phase
  // task's first window index (wy, -1 when none) and its number of rows (ny).
  int wx[K][kXPer], gxo[K][kXPer], wy[K], ny[K];
  unsigned inx = 0;
#pragma unroll
  for (int k = 1; k <= K; ++k) {
    const int h = K - k;
    const int rx = kTX + 2 * h, ry = kTY + 2 * h;
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + j * kNT;
      const int px = kHX - h + i % rx, py = K - h + i / rx;
      const int gx = gx0 + px, gy = gy0 + py;
      const bool on = i < rx * ry;
      wx[k - 1][j] = on ? py * kWX + px : -1;
      gxo[k - 1][j] = on && gx >= 0 && gx < Xr && gy >= 0 && gy < Yr ? gy * Xr + gx : -1;
      if (on && gx >= 1 && gx <= X && gy >= 1 && gy <= Y) inx |= 1u << ((k - 1) * kXPer + j);
    }
    const int cols = rx + 2, segs = (ry + kR - 1) / kR;
    const int col = tid % cols, seg = tid / cols;
    wy[k - 1] = tid < cols * segs ? (K - h + seg * kR) * kWX + kHX - h - 1 + col : -1;
    ny[k - 1] = min(kR, ry - seg * kR);
  }

  // plane p of u into its ring slot (zero off the array)
  auto fetch_u = [&](int p) {
    T* dst = uring + slot<kUSlots>(p) * W::kPlane;
    const bool zin = p >= 0 && p < Zr;
#pragma unroll
    for (int j = 0; j < kChunksPer; ++j) {
      const int q = tid + j * kNT;
      if (q < kChunks) {
        const bool v = zin && soff[j] >= 0;
        cp_async16<false>(dst + q * kV, u + (v ? p * sp + soff[j] : 0), v);
      }
    }
  };
  // plane p of b and s into their ring slots; kept in L1 for the later stages
  auto fetch_bs = [&](int p) {
    T* bd = bring + slot<kBSlots>(p) * W::kPlane;
    T* sd = sring + slot<kBSlots>(p) * W::kPlane;
    const bool zin = p >= 0 && p < Zr;
#pragma unroll
    for (int j = 0; j < kBChunksPer; ++j) {
      if (bdst[j] >= 0) {
        const bool v = zin && boff[j] >= 0;
        const long long g = v ? p * sp + boff[j] : 0;
        if constexpr (kNeedB) cp_async16<true>(bd + bdst[j], b + g, v);
        if constexpr (kNeedS) cp_async16<true>(sd + bdst[j], s + g, v);
      }
    }
  };

  // the running z-sums, in registers: of u^0 at this thread's own u chunks,
  // and of u^k at its stage-k x-phase points (k < K), which feed stage k+1:
  // pair = v(z-1) + v(z), so that t(z) = pair + v(z+1) = (m + c) + p
  T prev0[kChunksPer][kV], pair0[kChunksPer][kV];
  T prev[K][kXPer], pair[K][kXPer];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < kXPer; ++j) prev[k][j] = pair[k][j] = T(0);

  // one commit group per step: u plane n+1+kAhead and b, s plane n+kAhead
  const int n0 = c0 - K + 1, n1 = c1 + 2 * K - 3;
  fetch_u(n0 - 1);
  fetch_u(n0);
  cp_async_commit();
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    fetch_u(n0 + 1 + a);
    fetch_bs(n0 + a);
    cp_async_commit();
  }
  cp_async_wait<kAhead>();  // this thread's chunks of u planes n0-1 and n0
#pragma unroll
  for (int j = 0; j < kChunksPer; ++j) {
    const int q = tid + j * kNT;
    if (q < kChunks) {
      const T* pm = uring + slot<kUSlots>(n0 - 1) * W::kPlane + q * kV;
      const T* pc = uring + slot<kUSlots>(n0) * W::kPlane + q * kV;
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        pair0[j][e] = add_rn(pm[e], pc[e]);
        prev0[j][e] = pc[e];
      }
    }
  }
  T sq = T(0);

  for (int n = n0; n <= n1; ++n) {
    // (a) the z-sum of u^0 at plane n, from this thread's own copies of plane n+1
    cp_async_wait<kAhead - 1>();  // u up to plane n+1, b and s up to plane n
#pragma unroll
    for (int j = 0; j < kChunksPer; ++j) {
      const int q = tid + j * kNT;
      if (q < kChunks) {
        const T* pp = uring + slot<kUSlots>(n + 1) * W::kPlane + q * kV;
        T* t = tz + q * kV;
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const T v = pp[e];
          t[e] = add_rn(pair0[j][e], v);
          pair0[j][e] = add_rn(prev0[j][e], v);
          prev0[j][e] = v;
        }
      }
    }
    __syncthreads();  // the copies and z-sums of every thread; the last x-phase
    fetch_u(n + 1 + kAhead);
    fetch_bs(n + kAhead);
    cp_async_commit();

    // (b) y-phase: ty = (c + m) + p of the z-sums along y, kR rows per task
#pragma unroll
    for (int k = 1; k <= K; ++k) {
      const int z = n - 2 * (k - 1);
      if (z < c0 - (K - k) || z > c1 - 1 + (K - k) || wy[k - 1] < 0) continue;
      const T* src = tz + (k - 1) * W::kPlane + wy[k - 1];
      T* dst = ty + (k - 1) * W::kPlane + wy[k - 1];
      T m = src[-kWX], c = src[0];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r < ny[k - 1]) {
          const T p = src[(r + 1) * kWX];
          dst[r * kWX] = box_axis_sum(c, m, p);
          m = c;
          c = p;
        }
      }
    }
    __syncthreads();

    // (c) x-phase: u^k at plane z_k on the tile plus a K-k halo
#pragma unroll
    for (int k = 1; k <= K; ++k) {
      const int z = n - 2 * (k - 1);
      if (z < c0 - (K - k) || z > c1 - 1 + (K - k)) continue;
      const bool zin = z >= 1 && z <= Z;
      const long long zoff = z * sp;
      const T* pc = k == 1 ? uring + slot<kUSlots>(z) * W::kPlane
                           : rings + ((k - 2) * kSlots + (z & (kSlots - 1))) * W::kPlane;
      const T* t = ty + (k - 1) * W::kPlane;
      const T* bz = bring + slot<kBSlots>(z) * W::kPlane;
      const T* sz = sring + slot<kBSlots>(z) * W::kPlane;
      T* dst = k < K ? rings + ((k - 1) * kSlots + (z & (kSlots - 1))) * W::kPlane : nullptr;
      T* tnext = k < K ? tz + k * W::kPlane : nullptr;
#pragma unroll
      for (int j = 0; j < kXPer; ++j) {
        const int w = wx[k - 1][j];
        if (w < 0) break;
        T val = T(0);
        if (zin && (inx >> ((k - 1) * kXPer + j)) & 1u) {
          const T acc = box_combine(w_off, w_cm, box_axis_sum(t[w], t[w - 1], t[w + 1]), pc[w]);
          if (kMode == kSpmv) {
            val = acc;
          } else {
            // stage 1 reads b and s from its rings; the later stages read
            // the same planes, copied 2(k-1) steps earlier, through L1
            T bv, sv = T(0);
            if (k == 1) {
              bv = bz[w];
              if (kNeedS) sv = sz[w];
            } else {
              bv = __ldg(b + zoff + gxo[k - 1][j]);
              if (kNeedS) sv = __ldg(s + zoff + gxo[k - 1][j]);
            }
            if (kMode == kResidual) {
              val = sub_rn(bv, acc);
            } else if (kMode == kSweep) {
              val = jacobi_update_rn(pc[w], bv, alpha, acc);
            } else {
              if (kMode == kSweepVecNorm) {
                const T r2 = sub_rn(bv, acc);
                sq += r2 * r2;
              }
              val = jacobi_update_rn(pc[w], bv, sv, acc);
            }
          }
        }
        if (k < K) {
          // u^k for stage k+1: its centre, and its z-sum at plane z-1
          dst[w] = val;
          tnext[w] = add_rn(pair[k - 1][j], val);
          pair[k - 1][j] = add_rn(prev[k - 1][j], val);
          prev[k - 1][j] = val;
        } else if (gxo[k - 1][j] >= 0) {
          out[zoff + gxo[k - 1][j]] = val;
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
template <typename T, int K, int kMode>
cudaError_t prepare() {
  constexpr size_t bytes = march_smem_bytes<T, K, kMode>();
  if (bytes <= kStaticSmem) return cudaSuccess;
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(box_march_kernel<T, K, kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <typename T, int K, int kMode>
int launch(const void* u, const void* b, const void* s, void* out, void* partials,
           double w_off, double w_cm, double alpha, int Z, int Y, int X, int Zr, int Yr,
           int Xr, dim3 grid, int zchunk, cudaStream_t st) {
  const cudaError_t err = prepare<T, K, kMode>();
  if (err != cudaSuccess) return static_cast<int>(err);
  box_march_kernel<T, K, kMode><<<grid, kNT, march_smem_bytes<T, K, kMode>(), st>>>(
      static_cast<const T*>(u), static_cast<const T*>(b), static_cast<const T*>(s),
      static_cast<T*>(out), static_cast<T*>(partials), static_cast<T>(w_off),
      static_cast<T>(w_cm), static_cast<T>(alpha), Z, Y, X, Zr, Yr, Xr, zchunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_sweeps(int mode, const void* u, const void* b, const void* s, void* out,
                  double w_off, double w_cm, double alpha, int Z, int Y, int X, int Zr,
                  int Yr, int Xr, dim3 grid, int zchunk, cudaStream_t st) {
  if (mode == kSweep)
    return launch<T, K, kSweep>(u, b, s, out, nullptr, w_off, w_cm, alpha, Z, Y, X, Zr, Yr,
                                Xr, grid, zchunk, st);
  if (mode == kSweepVec)
    return launch<T, K, kSweepVec>(u, b, s, out, nullptr, w_off, w_cm, alpha, Z, Y, X, Zr,
                                   Yr, Xr, grid, zchunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_typed(int nsweep, int mode, const void* u, const void* b, const void* s,
                 void* out, void* partials, double w_off, double w_cm, double alpha, int Z,
                 int Y, int X, int Zr, int Yr, int Xr, dim3 grid, int zchunk,
                 cudaStream_t st) {
  switch (nsweep) {
    case 1:
      switch (mode) {
        case kSpmv:
          return launch<T, 1, kSpmv>(u, b, s, out, partials, w_off, w_cm, alpha, Z, Y, X, Zr,
                                     Yr, Xr, grid, zchunk, st);
        case kResidual:
          return launch<T, 1, kResidual>(u, b, s, out, partials, w_off, w_cm, alpha, Z, Y, X,
                                         Zr, Yr, Xr, grid, zchunk, st);
        case kSweepVecNorm:
          return launch<T, 1, kSweepVecNorm>(u, b, s, out, partials, w_off, w_cm, alpha, Z, Y,
                                             X, Zr, Yr, Xr, grid, zchunk, st);
        default:
          return launch_sweeps<T, 1>(mode, u, b, s, out, w_off, w_cm, alpha, Z, Y, X, Zr, Yr,
                                     Xr, grid, zchunk, st);
      }
    case 2:
      return launch_sweeps<T, 2>(mode, u, b, s, out, w_off, w_cm, alpha, Z, Y, X, Zr, Yr, Xr,
                                 grid, zchunk, st);
    case 3:
      return launch_sweeps<T, 3>(mode, u, b, s, out, w_off, w_cm, alpha, Z, Y, X, Zr, Yr, Xr,
                                 grid, zchunk, st);
    case 4:
      return launch_sweeps<T, 4>(mode, u, b, s, out, w_off, w_cm, alpha, Z, Y, X, Zr, Yr, Xr,
                                 grid, zchunk, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// nsweep K = 1 takes the K1 modes 0-4 (spmv, residual, sweep, sweep_vec,
// sweep_vec_norm; partials has gx*gy*gz entries for the last), K = 2..4 the
// modes 2 (sweep, scalar alpha) and 3 (sweep_vec). The plan (grid gx x gy x
// gz, zchunk planes per block) must cover the padded array exactly once with
// the 32 x 8 tile; u, b and s (those the mode reads) must be 16-byte aligned.
int amg_box_launch(int is_double, const void* u, const void* b, const void* s, void* out,
                   void* partials, double w_off, double w_cm, double alpha, int Z, int Y,
                   int X, int Zr, int Yr, int Xr, int nsweep, int mode, int gx, int gy,
                   int gz, int zchunk, void* stream) {
  if (zchunk < 1 || gx != (Xr + kTX - 1) / kTX || gy != (Yr + kTY - 1) / kTY ||
      gz != (Zr + zchunk - 1) / zchunk || Xr % 4 != 0 || misaligned16(u) || misaligned16(b) ||
      misaligned16(s))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(gx, gy, gz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_typed<double>(nsweep, mode, u, b, s, out, partials, w_off, w_cm, alpha, Z,
                                Y, X, Zr, Yr, Xr, grid, zchunk, st);
  return launch_typed<float>(nsweep, mode, u, b, s, out, partials, w_off, w_cm, alpha, Z, Y,
                             X, Zr, Yr, Xr, grid, zchunk, st);
}

}  // extern "C"
