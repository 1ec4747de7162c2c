// K4: the fused prolong + correction-add + sweep kernel, a z-march on the
// padded state.
//
// Replaces amg_tpu/ops/pallas_transfer.py::_ps_kernel (entry
// prolong_sweep_padded):
//     u' = x + P ec ;  out = u' + s (b - A u')   (alpha instead of s when s is null)
// with x = u, or under zero_guess x = s*b (alpha*b): a coarse level's whole
// up-visit. P is trilinear under (s+1)//2 coarsening: along each axis a fine
// padded index p takes coarse padded (p+1)/2 when p is odd (an even fine
// interior index) and the mean of coarse p/2 and p/2+1 when p is even; the
// coarse zero shell supplies the clipped term at an even-sided edge. P ec is
// 0 off the fine interior, so u' = x there.
//
// Bound on the H100: bytes. A launch reads x, b and s (zero_guess: b and s),
// ec (1/8 of a state) and writes out: 34.7 MB at 126^3 in float32, 10.4 us
// at 3.35 TB/s. The zero-guess launches of the coarse levels move 3.6 MB
// (63^3) and 0.5 MB (32^3): there the floor is the launch and its fill, and
// the plan gives the card enough blocks.
//
// Design. A 256-thread block owns a 32x8 (x, y) output tile and walks a
// chunk of fine z-planes; the launch plan comes from the Python wrapper
// (ops/transfer.py::k4_plan) and the kernel refuses one that does not cover
// the array. Its planes share one window of WX x WY = 40 x 10 points: the
// tile, one row each side, and 4 columns each side (16-byte-aligned rows).
//   - P ec separably, as the reference's kernel computes it: each coarse
//     plane j that the chunk needs arrives as a 6x20 patch (the coarse
//     points under the window) and is expanded once, first in y (Ey: the
//     window's 10 fine rows over the 18 coarse columns), then in x (E: the
//     34x10 window points the sweep reads), into a ring of three expanded
//     planes. A fine plane's P ec is then E((p+1)/2) (odd p) or the mean
//     of E(p/2) and E(p/2+1).
//   - x (zero_guess: b and s) enters a ring of window planes by 16-byte
//     cp.async chunks, b and s (not zero_guess) a ring of planes over the
//     tile, kAhead = 2 planes ahead of their use, and the coarse patches a
//     ring of four; rows and planes outside the arrays are zero-filled. The
//     wrapper refuses inputs that are not 16-byte aligned.
//   - Step n writes output plane n: (a) each thread forms u'(n+1) = x + P ec
//     on the window chunks it copied itself (no barrier between its copies
//     and its reads) into a ring of four u' planes, and on the uniform box
//     the z-sum (u'(n-1) + u'(n)) + u'(n+1) from its own earlier u' values;
//     a barrier; the next copies; (b) on the box the y-sums of the z-sums;
//     on odd n the y-expansion of coarse plane (n+5)/2, on even n the
//     x-expansion of coarse plane n/2+2; a barrier; (c) the output points:
//     on the box one a thread, the x-sums, box_combine and jacobi_update_rn
//     (as csrc/box_march.cu); on other taps two a thread (rows r, r+1) on
//     the upper four warps (while the lower ones go on to the next u'), the
//     taps from the u' ring in list order. When the list is the 27 offsets
//     (-1, 0, 1)^3 in product order, as on every RAP level, the offsets are
//     compile-time constants and each plane's 4x3 neighbourhood of the two
//     rows is loaded once (36 loads for 54 taps); that route takes 0.7 of
//     the time of the route for any list at 63^3 and 0.8 at 32^3
//     (tools/torch_k4_variants.py). Two barriers per plane; u' never touches
//     device memory, and each block forms each of its u' points once (the
//     recompute is the window's halo and one plane at each end of a chunk).
//   - The prologue expands the first three coarse planes (y, then x) and
//     forms u'(c0-1) and u'(c0). A chunk may start on either parity, so
//     one-plane chunks fill the card at 32^3; expansions the chunk does not
//     read are skipped.
// Rounding. Every operation is rounded on its own (common.cuh) in the
// reference's order: each mean as 0.5 * (a + b), u' = x + P ec, the box as
// the box march sums it, other taps as add_rn(acc, mul_rn(w, v)) in list
// order. So the kernel equals ops/transfer.py::prolong_sweep_plain bit for
// bit, on every route.
#include "common.cuh"

using namespace amg;

namespace {

constexpr int kTX = 32;  // tile, x; ops/stencil.py::ZMARCH_TILE mirrors (kTY, kTX)
constexpr int kTY = 8;   // tile, y
constexpr int kNT = 256;
constexpr int kHX = 4;              // window columns each side of the tile
constexpr int kWX = kTX + 2 * kHX;  // 40
constexpr int kWY = kTY + 2;        // 10
constexpr int kPlane = kWX * kWY;
constexpr int kEX0 = kHX - 1;       // first window column the sweep reads (fine x0-1)
constexpr int kEXN = kTX + 2;       // columns the sweep reads
constexpr int kEPts = kEXN * kWY;   // points of an expanded plane
constexpr int kCX = kEXN / 2 + 1;   // coarse columns under them (from x0/2)
constexpr int kEyPts = kCX * kWY;   // points of a y-expanded plane
constexpr int kEyTasks = kEyPts / 2;  // y-expansion tasks: two rows of one coarse column
constexpr int kExTasks = kEPts / 2;   // x-expansion tasks: two columns of one row
constexpr int kAhead = 2;           // planes of x, b and s in flight ahead of their use
constexpr int kWSlots = kAhead + 2;  // window planes n .. n+1+kAhead at step n
constexpr int kTSlots = kAhead + 1;  // tile planes n .. n+kAhead
constexpr int kUSlots = 4;          // u' planes n-1 .. n+2 (the tap list: twice, see form)
constexpr int kESlots = 3;          // expanded coarse planes
constexpr int kEySlots = 3;         // y-expanded coarse planes
constexpr int kPY = kWY / 2 + 1;    // coarse rows under the window (from y0/2)
constexpr int kPX = 20;             // coarse columns staged (kCX, 16-byte rows)
constexpr int kPatch = kPY * kPX;   // a staged coarse patch
constexpr int kPSlots = 4;          // staged coarse patches
constexpr int kStaticSmem = 48 * 1024;
static_assert(kWY % 2 == 0 && kEXN % 2 == 0, "expansion tasks in pairs");
static_assert(kEyTasks <= kNT - 2 * kEXN && kExTasks <= kNT - 2 * kEXN, "work per thread");

// The sweep's taps: a list in any order, the uniform box, or 27 taps at the
// offsets (-1, 0, 1)^3 in product order (the RAP levels' layout)
enum Route { kTapList = 0, kUniformBox = 1, kDense27 = 2 };

// x (with s or alpha), or the zero-guess iterate s*b or alpha*b
enum Mode { kIterScale = 0, kIterAlpha = 1, kZeroScale = 2, kZeroAlpha = 3 };

__host__ __device__ constexpr bool zero_guess(int mode) { return mode >= kZeroScale; }
__host__ __device__ constexpr bool scaled(int mode) {
  return mode == kIterScale || mode == kZeroScale;
}
// window streams: x, or b (and s); tile streams: b (and s) when not zero_guess
__host__ __device__ constexpr int window_streams(int mode) {
  return mode == kZeroScale ? 2 : 1;
}
__host__ __device__ constexpr int tile_streams(int mode) {
  return zero_guess(mode) ? 0 : (scaled(mode) ? 2 : 1);
}

template <typename T, int kRoute, int kMode>
constexpr size_t smem_bytes() {
  constexpr bool kBox = kRoute == kUniformBox;
  return (size_t(window_streams(kMode) * kWSlots + tile_streams(kMode) * kTSlots +
                 (kBox ? 1 : 2) * kUSlots +
                 (kBox ? 2 : 0) + kESlots) * kPlane + size_t(kEySlots) * kEyPts +
          size_t(kPSlots) * kPatch) *
         sizeof(T);
}

// kV = 16/sizeof(T) values, moved between registers and shared memory as one
// 16-byte access
template <typename T>
struct __align__(16) Chunk {
  T v[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ Chunk<T> ld_chunk(const T* p) {
  return *reinterpret_cast<const Chunk<T>*>(p);
}

template <typename T>
__device__ __forceinline__ void st_chunk(T* p, const Chunk<T>& c) {
  *reinterpret_cast<Chunk<T>*>(p) = c;
}

// ring slot of plane p (p >= -1)
template <int kN>
__device__ __forceinline__ int slot(int p) {
  return (p + kN) % kN;
}

// 0.5 * v, rounded on its own (exact unless v is subnormal)
template <typename T>
__device__ __forceinline__ T halve(T v) {
  return mul_rn(T(0.5), v);
}

// Block (bx, by, bz): output columns x0 .. x0+31, rows y0 .. y0+7 of planes
// c0 .. c1-1 (c0 = bz*zchunk). Window point (wy, wx) is padded (y0-1+wy,
// x0-4+wx).
template <typename T, int kRoute, int kMode>
__global__ void __launch_bounds__(kNT)
    prolong_march_kernel(const T* __restrict__ x, const T* __restrict__ b,
                         const T* __restrict__ s, const T* __restrict__ ec,
                         T* __restrict__ out, const Taps<T> taps, T w_off, T w_cm,
                         T alpha, int Z, int Y, int X, int Zr, int Yr, int Xr, int Zcr,
                         int Ycr, int Xcr, int zchunk) {
  constexpr bool kBox = kRoute == kUniformBox;
  constexpr int kV = 16 / static_cast<int>(sizeof(T));  // elements per chunk
  constexpr int kRowChunks = kWX / kV;
  constexpr int kChunks = kRowChunks * kWY;
  constexpr int kTRowChunks = kTX / kV;
  constexpr int kTChunks = kTRowChunks * kTY;
  constexpr int kNW = window_streams(kMode), kNTs = tile_streams(kMode);
  static_assert(kWX % kV == 0 && kTX % kV == 0 && kHX % kV == 0, "whole chunks");
  constexpr int kPRowChunks = kPX / kV;
  constexpr int kPChunks = kPRowChunks * kPY;
  static_assert(kChunks <= kNT && kTChunks <= kNT && kPChunks <= kNT, "one chunk a thread");
  static_assert(kPX % kV == 0 && kPX >= kCX, "patch rows");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const win = reinterpret_cast<T*>(smem_raw);      // [kNW][kWSlots]
  T* const tile = win + kNW * kWSlots * kPlane;       // [kNTs][kTSlots], window layout
  T* const uring = tile + kNTs * kTSlots * kPlane;    // [kUSlots] (not the box: twice): u'
  T* const tz = uring + (kBox ? 1 : 2) * kUSlots * kPlane;  // box: z-sums of u'(n)
  T* const ty = tz + (kBox ? kPlane : 0);             // box: their y-sums
  T* const eplanes = ty + (kBox ? kPlane : 0);        // [kESlots]: expanded ec planes
  T* const eyplanes = eplanes + kESlots * kPlane;     // [kEySlots]: y-expanded ec planes
  T* const patches = eyplanes + kEySlots * kEyPts;    // [kPSlots]: staged ec patches

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int gy0 = y0 - 1;   // padded row of window row 0
  const int cx0 = x0 / 2;   // coarse column of Ey column 0
  const int c0 = blockIdx.z * zchunk, c1 = min(c0 + zchunk, Zr);
  // the last coarse plane the chunk reads: u'(c1) reads (c1 >> 1) + 1
  const int jmax = min(Zcr - 1, (c1 >> 1) + 1);
  const int sp = Yr * Xr, csp = Ycr * Xcr;  // the launcher refuses arrays of 2^31 values

  // this thread's window chunk tid (in-plane offset, -1 off the array or
  // past the chunks) and tile chunk tid (window index and in-plane offset,
  // -1 past the chunks or off the array)
  int soff, tdst, toff;
  {
    const int gy = gy0 + tid / kRowChunks, gx = x0 - kHX + (tid % kRowChunks) * kV;
    soff = tid < kChunks && gy >= 0 && gy < Yr && gx >= 0 && gx + kV <= Xr ? gy * Xr + gx : -1;
    const int ry = tid / kTRowChunks, rx = (tid % kTRowChunks) * kV;
    tdst = tid < kTChunks ? (ry + 1) * kWX + kHX + rx : -1;
    toff = tid < kTChunks && y0 + ry < Yr && x0 + rx + kV <= Xr ? (y0 + ry) * Xr + x0 + rx : -1;
  }
  // this thread's output points: on the box one (row tid/32); on other
  // taps two rows, which share their taps' offsets and run two sums side
  // by side, on the upper four warps (the lower ones form u', so that the
  // sums of step n overlap the u' of step n+1)
  constexpr int kRows = kBox ? 1 : 2;
  const int otid = kBox ? tid : tid - kNT / 2;
  const bool o_act = otid >= 0;
  const int orow = otid / kTX * kRows, ox = x0 + otid % kTX;
  const int ow = (orow + 1) * kWX + kHX + otid % kTX;

  // window plane p of x (zero_guess: b and s) into its ring slot
  auto fetch_window = [&](int p) {
    if (tid < kChunks) {
      T* d = win + slot<kWSlots>(p) * kPlane + tid * kV;
      const bool v = p >= 0 && p < Zr && soff >= 0;
      const int g = v ? p * sp + soff : 0;
      if constexpr (zero_guess(kMode)) {
        cp_async16(d, b + g, v);
        if constexpr (kNW == 2) cp_async16(d + kWSlots * kPlane, s + g, v);
      } else {
        cp_async16(d, x + g, v);
      }
    }
  };
  // tile plane p of b (and s) into their ring slots (not zero_guess)
  auto fetch_tile = [&](int p) {
    if constexpr (kNTs > 0) {
      if (tdst >= 0) {
        T* d = tile + slot<kTSlots>(p) * kPlane + tdst;
        const bool v = p >= 0 && p < Zr && toff >= 0;
        const int g = v ? p * sp + toff : 0;
        cp_async16(d, b + g, v);
        if constexpr (kNTs == 2) cp_async16(d + kTSlots * kPlane, s + g, v);
      }
    }
  };

  // the coarse rows y0/2 .. +5, columns cx0 .. cx0+19 of coarse plane j
  // into its patch slot
  auto fetch_patch = [&](int j) {
    if (tid < kPChunks) {
      const int cy = (y0 >> 1) + tid / kPRowChunks, cx = cx0 + (tid % kPRowChunks) * kV;
      const bool v = j <= jmax && cy < Ycr && cx + kV <= Xcr;
      cp_async16(patches + (j % kPSlots) * kPatch + tid * kV,
                 ec + (v ? j * csp + cy * Xcr + cx : 0), v);
    }
  };
  // Ey rows 2k, 2k+1 at coarse column c of coarse plane j (task i = k*kCX
  // + c) from its patch: fine row gy0 + 2k is odd and takes patch row k,
  // the next the mean 0.5 * (a + b) of patch rows k and k+1
  auto expand_y = [&](int j, int i) {
    const int k = i / kCX, c = i % kCX, gy = gy0 + 2 * k;
    const T* p = patches + (j % kPSlots) * kPatch + k * kPX + c;
    T* d = eyplanes + (j % kEySlots) * kEyPts + 2 * k * kCX + c;
    const bool cin = cx0 + c < Xcr;
    d[0] = cin && gy >= 1 && gy <= Y ? p[0] : T(0);
    d[kCX] = cin && gy + 1 >= 1 && gy + 1 <= Y ? halve(add_rn(p[0], p[kPX])) : T(0);
  };
  // E columns 2k, 2k+1 (window kEX0 + 2k) of row r of coarse plane j (task
  // i = r*kEXN/2 + k) from its Ey slot: fine column x0-1+2k is odd and
  // takes Ey column k, the next the mean of columns k and k+1
  auto expand_x = [&](int j, int i) {
    const int r = i / (kEXN / 2), k = i % (kEXN / 2), gx = x0 - 1 + 2 * k;
    const T* e = eyplanes + (j % kEySlots) * kEyPts + r * kCX + k;
    T* d = eplanes + (j % kESlots) * kPlane + r * kWX + kEX0 + 2 * k;
    d[0] = gx >= 1 && gx <= X ? e[0] : T(0);
    d[1] = gx + 1 >= 1 && gx + 1 <= X ? halve(add_rn(e[0], e[1])) : T(0);
  };
  // u'(p) = x + P ec on this thread's own window chunk (no barrier between
  // its copy and this read), into the u' ring; with zsum on the box also
  // the z-sum (u'(p-2) + u'(p-1)) + u'(p) of plane p-1, from its own
  // earlier u' values
  auto form = [&](int p, bool zsum) {
    if (tid >= kChunks) return;
    const int w = tid * kV;
    const T* xw = win + slot<kWSlots>(p) * kPlane + w;
    const Chunk<T> xv = ld_chunk(xw);
    Chunk<T> sv;
    if constexpr (kMode == kZeroScale) sv = ld_chunk(xw + kWSlots * kPlane);
    // P ec of plane p: 0 off the interior, one expanded plane (odd p) or
    // the mean of two
    Chunk<T> pe, pb;
    const bool pin = p >= 1 && p <= Z;
    if (pin) pe = ld_chunk(eplanes + (((p + 1) >> 1) % kESlots) * kPlane + w);
    if (pin && !(p & 1)) pb = ld_chunk(eplanes + (((p >> 1) + 1) % kESlots) * kPlane + w);
    Chunk<T> u;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      T xe;
      if constexpr (kMode == kZeroScale) {
        xe = mul_rn(xv.v[e], sv.v[e]);  // b * s
      } else if constexpr (kMode == kZeroAlpha) {
        xe = mul_rn(alpha, xv.v[e]);
      } else {
        xe = xv.v[e];
      }
      const T pv = !pin ? T(0) : (p & 1) ? pe.v[e] : halve(add_rn(pe.v[e], pb.v[e]));
      u.v[e] = add_rn(xe, pv);
    }
    st_chunk(uring + slot<kUSlots>(p) * kPlane + w, u);
    // the tap list reads planes n-1 .. n+1 from one base: every plane is
    // also stored kUSlots slots on, so the three follow each other
    if constexpr (!kBox) st_chunk(uring + (slot<kUSlots>(p) + kUSlots) * kPlane + w, u);
    if constexpr (kBox) {
      if (zsum) {
        const Chunk<T> m = ld_chunk(uring + slot<kUSlots>(p - 2) * kPlane + w);
        const Chunk<T> c = ld_chunk(uring + slot<kUSlots>(p - 1) * kPlane + w);
        Chunk<T> t;
#pragma unroll
        for (int e = 0; e < kV; ++e) t.v[e] = add_rn(add_rn(m.v[e], c.v[e]), u.v[e]);
        st_chunk(tz + w, t);
      }
    }
  };

  // prologue: the copies of window planes c0-1, c0 and of the coarse
  // patches j0 .. j0+3 (one group: j0 .. j0+2 are those that u'(c0-1) ..
  // u'(c0+1) read, j0+3 the first odd step's), then of window plane
  // c0+1+a with tile plane c0+a (a group each); the first three coarse
  // planes expanded in y and then in x; the window columns that the sweep
  // does not read get P ec = 0 once
  const int j0 = c0 / 2;
  fetch_window(c0 - 1);
  fetch_window(c0);
#pragma unroll
  for (int j = j0; j < j0 + kPSlots; ++j) fetch_patch(j);
  cp_async_commit();
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    fetch_window(c0 + 1 + a);
    fetch_tile(c0 + a);
    cp_async_commit();
  }
  if (tid < kESlots * kWY * (kWX - kEXN)) {
    constexpr int kOut = kWX - kEXN;
    const int e = tid / (kWY * kOut), r = tid / kOut % kWY, c = tid % kOut;
    eplanes[e * kPlane + r * kWX + (c < kEX0 ? c : c + kEXN)] = T(0);
  }
  cp_async_wait<kAhead>();  // this thread's chunks of the first group
  __syncthreads();
#pragma unroll
  for (int k = 0; k < (kESlots * kEyTasks + kNT - 1) / kNT; ++k) {
    const int e = tid + k * kNT, j = j0 + e / kEyTasks;
    if (e < kESlots * kEyTasks && j <= jmax) expand_y(j, e % kEyTasks);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < (kESlots * kExTasks + kNT - 1) / kNT; ++k) {
    const int e = tid + k * kNT, j = j0 + e / kExTasks;
    if (e < kESlots * kExTasks && j <= jmax) expand_x(j, e % kExTasks);
  }
  __syncthreads();
  form(c0 - 1, false);
  form(c0, false);

  for (int n = c0; n < c1; ++n) {
    // (a) u'(n+1), and the z-sum of plane n
    cp_async_wait<kAhead - 1>();  // window plane n+1, tile plane n, patch (n+5)/2
    form(n + 1, true);
    __syncthreads();
    fetch_window(n + 1 + kAhead);
    fetch_tile(n + kAhead);
    if (n & 1) fetch_patch((n + 7) / 2);
    cp_async_commit();

    // (b) the y-sums (c + m) + p of the z-sums, 4 rows per task (the lowest
    // threads); on the upper threads, on odd n the y-expansion of the coarse
    // plane that plane n+4 first reads, on even n the x-expansion of the one
    // that plane n+2 first reads
    if constexpr (kBox) {
      if (tid < 2 * kEXN) {
        const int w = (1 + (tid / kEXN) * 4) * kWX + kEX0 + tid % kEXN;
        T m = tz[w - kWX], c = tz[w];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const T p = tz[w + (r + 1) * kWX];
          ty[w + r * kWX] = box_axis_sum(c, m, p);
          m = c;
          c = p;
        }
      }
    }
    if (n & 1) {
      const int i = tid - (kNT - kEyTasks);
      if ((n + 5) / 2 <= jmax && i >= 0) expand_y((n + 5) / 2, i);
    } else {
      const int i = tid - (kNT - kExTasks);
      if (n / 2 + 2 <= jmax && i >= 0) expand_x(n / 2 + 2, i);
    }
    __syncthreads();

    // (c) output plane n at this thread's points
    if (o_act) {
      T acc[kRows];
      if constexpr (kBox) {
        acc[0] = box_combine(w_off, w_cm, box_axis_sum(ty[ow], ty[ow - 1], ty[ow + 1]),
                             uring[slot<kUSlots>(n) * kPlane + ow]);
      } else if constexpr (kRoute == kDense27) {
        // the taps in product order: per plane dz, the two rows' 4x3
        // neighbourhood loaded once, then its 9 taps for both rows
        const T* ub = uring + (slot<kUSlots>(n - 1) + 1) * kPlane + ow;
        acc[0] = acc[1] = T(0);
#pragma unroll
        for (int dz = -1; dz <= 1; ++dz) {
          T v[4][3];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) v[r][dx] = ub[dz * kPlane + (r - 1) * kWX + dx - 1];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const T w = taps.w[(dz + 1) * 9 + dy * 3 + dx];
              acc[0] = add_rn(acc[0], mul_rn(w, v[dy][dx]));
              acc[1] = add_rn(acc[1], mul_rn(w, v[dy + 1][dx]));
            }
        }
      } else {
        // planes n-1 .. n+1 follow each other from slot(n-1) (form), so the
        // taps' offsets hold from plane n's position there
        const T* ub = uring + (slot<kUSlots>(n - 1) + 1) * kPlane + ow;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = T(0);
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) {
          if (k < taps.n) {
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              acc[r] = add_rn(acc[r], mul_rn(taps.w[k], ub[taps.off[k] + r * kWX]));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int oy = y0 + orow + r, w = ow + r * kWX;
        if (oy < Yr && ox < Xr) {
          T val = T(0);
          if (n >= 1 && n <= Z && oy >= 1 && oy <= Y && ox >= 1 && ox <= X) {
            T bv, sv = alpha;
            if constexpr (zero_guess(kMode)) {
              const T* bw = win + slot<kWSlots>(n) * kPlane;
              bv = bw[w];
              if constexpr (scaled(kMode)) sv = bw[kWSlots * kPlane + w];
            } else {
              const T* bt = tile + slot<kTSlots>(n) * kPlane;
              bv = bt[w];
              if constexpr (scaled(kMode)) sv = bt[kTSlots * kPlane + w];
            }
            val = jacobi_update_rn(uring[slot<kUSlots>(n) * kPlane + w], bv, sv, acc[r]);
          }
          out[n * sp + oy * Xr + ox] = val;
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Sets the kernel's dynamic shared-memory limit once per device (outside any
// stream work, so a later graph capture of the launch needs no attribute call).
template <typename T, int kRoute, int kMode>
cudaError_t prepare() {
  constexpr size_t bytes = smem_bytes<T, kRoute, kMode>();
  if (bytes <= kStaticSmem) return cudaSuccess;
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(prolong_march_kernel<T, kRoute, kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

struct Args {
  const void *x, *b, *s, *ec;
  void* out;
  double w_off, w_cm, alpha;
  int Z, Y, X, Zr, Yr, Xr, Zcr, Ycr, Xcr, zchunk;
  dim3 grid;
  cudaStream_t st;
};

template <typename T, int kRoute, int kMode>
int launch(const Args& a, const Taps<T>& taps) {
  const cudaError_t err = prepare<T, kRoute, kMode>();
  if (err != cudaSuccess) return static_cast<int>(err);
  prolong_march_kernel<T, kRoute, kMode><<<a.grid, kNT, smem_bytes<T, kRoute, kMode>(), a.st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.b), static_cast<const T*>(a.s),
      static_cast<const T*>(a.ec), static_cast<T*>(a.out), taps, static_cast<T>(a.w_off),
      static_cast<T>(a.w_cm), static_cast<T>(a.alpha), a.Z, a.Y, a.X, a.Zr, a.Yr, a.Xr, a.Zcr,
      a.Ycr, a.Xcr, a.zchunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kRoute>
int launch_mode(int mode, const Args& a, const Taps<T>& taps) {
  switch (mode) {
    case kIterScale:
      return launch<T, kRoute, kIterScale>(a, taps);
    case kIterAlpha:
      return launch<T, kRoute, kIterAlpha>(a, taps);
    case kZeroScale:
      return launch<T, kRoute, kZeroScale>(a, taps);
    default:
      return launch<T, kRoute, kZeroAlpha>(a, taps);
  }
}

template <typename T>
int launch_typed(int route, int mode, const Args& a, const double* w, const int* dz,
                 const int* dy, const int* dx, int ntaps) {
  Taps<T> taps;  // offsets in the u' ring: planes kPlane apart, rows kWX
  if (!make_taps(&taps, w, dz, dy, dx, ntaps, kPlane, kWX))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (route) {
    case kUniformBox:
      return launch_mode<T, kUniformBox>(mode, a, taps);
    case kDense27:
      return launch_mode<T, kDense27>(mode, a, taps);
    default:
      return launch_mode<T, kTapList>(mode, a, taps);
  }
}

}  // namespace

extern "C" {

// route (enum Route) 1 takes the uniform box (w_off, w_cm = w_c - w_off)
// and ignores the tap list; 2 the 27 taps at (-1, 0, 1)^3 in product order
// (refused otherwise); 0 any reach-1 list. s null selects alpha. The plan (grid
// gx x gy x gz, zchunk planes per block) must cover the padded fine array
// exactly once with the 32 x 8 tile; x, b and s (those the mode reads) must
// be 16-byte aligned; ec is the padded coarse array of (Z+1)/2 x (Y+1)/2 x
// (X+1)/2.
int amg_k4_launch(int is_double, const void* x, const void* b, const void* s, const void* ec,
                  void* out, const double* w, const int* dz, const int* dy, const int* dx,
                  int ntaps, int route, double w_off, double w_cm, int Z, int Y, int X, int Zr,
                  int Yr, int Xr, int Zcr, int Ycr, int Xcr, int zero_guess, int gx, int gy,
                  int gz, int zchunk, double alpha, void* stream) {
  if (zchunk < 1 || gx != (Xr + kTX - 1) / kTX || gy != (Yr + kTY - 1) / kTY ||
      gz != (Zr + zchunk - 1) / zchunk || Xr % 4 != 0 || Zr != Z + 2 || Yr != Y + 2 ||
      Xr < X + 2 || Zcr != (Z + 1) / 2 + 2 || Ycr != (Y + 1) / 2 + 2 ||
      Xcr < (X + 1) / 2 + 2 || static_cast<long long>(Zr) * Yr * Xr >= (1LL << 31) ||
      (!zero_guess && x == nullptr) || b == nullptr ||
      ec == nullptr || out == nullptr || misaligned16(x) ||
      misaligned16(b) || misaligned16(s) || misaligned16(ec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kDense27) {
    if (ntaps != 27) return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < 27; ++k)
      if (dz[k] != k / 9 - 1 || dy[k] != k / 3 % 3 - 1 || dx[k] != k % 3 - 1)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mode = zero_guess ? (s ? kZeroScale : kZeroAlpha) : (s ? kIterScale : kIterAlpha);
  const Args a{x, b, s, ec, out, w_off, w_cm, alpha, Z, Y, X, Zr, Yr, Xr, Zcr, Ycr, Xcr,
               zchunk, dim3(gx, gy, gz), static_cast<cudaStream_t>(stream)};
  if (is_double) return launch_typed<double>(route, mode, a, w, dz, dy, dx, ntaps);
  return launch_typed<float>(route, mode, a, w, dz, dy, dx, ntaps);
}

}  // extern "C"
