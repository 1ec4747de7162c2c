// The ELL sparse matrix-vector product y = A x in one launch.
//
// Replaces no Pallas kernel: amg_tpu/sparse/ell.py::ell_spmv is plain jnp
// (a gather, a multiply and a sum that XLA fuses on the TPU), so this kernel
// goes beyond the reference. Its plain PyTorch version,
// amg_tpu_torch/ops/ell.py::ell_spmv_plain, is the same three steps as
// three launches, which write and read two (n, k) temporaries.
//
// Layout (amg_tpu_torch/sparse/ell.py::ELLMatrix): vals (n, k) row-major in
// the vector's type, cols (n, k) int32, each row padded with (col 0, val 0)
// slots; x of n_cols entries, y of n.
//
// Bound on the H100: bytes. Each slot is 8 + 4 bytes in float64 (4 + 4 in
// float32) read once, for 2 flops; the operators of the benchmark's cells
// hold 13 to 350 MB, against an x of 0.25 to 7 MB that stays in the 50 MB L2.
//
// Design: one pass over vals and cols, every product and partial sum in
// registers, nothing of size n k written. A group of L lanes (L a power of
// two, 4 to 32, chosen from k on the host: ops/ell.py::lanes_for) owns one
// row; lane l takes slots l, l + L, l + 2L, ..., so a warp reads runs of
// consecutive slots of 32 / L neighbouring rows. Each pass a lane issues
// kUnroll loads of cols and vals at once (predicated past the row's end),
// then their kUnroll gathers of x, so several loads are in flight per lane
// whatever k is. vals and cols are read with the streaming hint (evict
// first: each byte is read once), x through the read-only path, so the
// stream does not push x out of L2. A lane sums its slots in slot order with
// fused multiply-adds; the group adds its lanes by __shfl_down_sync at width
// L (offsets L/2, ..., 1); lane 0 writes y. No atomics, so the order of each
// row's sum depends on k and L alone, and two launches give the same bits.
// Rows past n take no slot but join the shuffles (full mask). kUnroll is
// ops/ell.py::SLOTS_PER_LANE and the cases of launch_lanes are its
// LANE_WIDTHS, from which lanes_for picks; tests/test_torch_ell_kernel.py
// reads both here and holds them equal.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    ell_spmv_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                    const T* __restrict__ x, T* __restrict__ y, long long n, int k) {
  const int lane = threadIdx.x & (L - 1);
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / L) + threadIdx.x / L;
  const int end = row < n ? k : 0;
  const long long base = row * k;
  const int* c = cols + base;
  const T* v = vals + base;
  T acc = T(0);
  for (int j = lane; j < end; j += kUnroll * L) {
    int cj[kUnroll];
    T vj[kUnroll];
    T xj[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = j + u * L < end;
      cj[u] = ok ? __ldcs(c + j + u * L) : 0;
      vj[u] = ok ? __ldcs(v + j + u * L) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xj[u] = j + u * L < end ? __ldg(x + cj[u]) : T(0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = fma_rn(vj[u], xj[u], acc);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off, L);
  if (lane == 0 && row < n) y[row] = acc;
}

template <typename T, int L>
int launch(const void* cols, const void* vals, const void* x, void* y, long long n, int k,
           cudaStream_t stream) {
  constexpr long long rows_per_block = kThreads / L;
  const dim3 grid(static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block));
  ell_spmv_kernel<T, L><<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(cols), static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_lanes(int lanes, const void* cols, const void* vals, const void* x, void* y,
                 long long n, int k, cudaStream_t stream) {
  switch (lanes) {
    case 4: return launch<T, 4>(cols, vals, x, y, n, k, stream);
    case 8: return launch<T, 8>(cols, vals, x, y, n, k, stream);
    case 16: return launch<T, 16>(cols, vals, x, y, n, k, stream);
    case 32: return launch<T, 32>(cols, vals, x, y, n, k, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// y[i] = sum_j vals[i, j] * x[cols[i, j]] for the n rows of an (n, k) ELL
// matrix; vals, x and y float64 (is_double) or float32, cols int32, all
// contiguous; lanes in {4, 8, 16, 32}. n >= 1.
int amg_ell_spmv_launch(int is_double, int lanes, const void* cols, const void* vals,
                        const void* x, void* y, long long n, int k, void* stream) {
  if (n < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) return launch_lanes<double>(lanes, cols, vals, x, y, n, k, st);
  return launch_lanes<float>(lanes, cols, vals, x, y, n, k, st);
}

}  // extern "C"
