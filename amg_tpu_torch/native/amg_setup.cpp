// Native setup kernels of amg_tpu_torch: CSR SpGEMM (Gustavson), transpose,
// Galerkin RAP, PMIS/HMIS coarsening and direct / ext+i interpolation.
// The algorithms are those of the JAX package's native/amg_setup.cpp,
// unchanged: built with the same compiler and flags (-O3 -march=native
// -fPIC -std=c++17), the library computes the same bits, which is what lets
// the port's classical hierarchy equal the reference's level by level.
//
// These are the setup-time graph algorithms the reference obtains from
// hypre/Eigen (reference: hypre_CSRMatrixMultiply / hypre_ParMatmul,
// EigenMatMat src/SMEM_Setup.cpp:1256-1339, BoomerAMG PMIS coarsening) —
// implemented natively because they are irregular row-wise algorithms that
// do not map to TPU kernels; they run once per matrix on the host.
//
// C ABI for ctypes: output arrays are malloc'd here and released with
// amg_free. Indices are int32, values double (setup is always f64).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

void amg_free(void *p) { free(p); }

// C = A(m×k) * B(k×n), CSR in, CSR out (Gustavson, dense accumulator).
// Returns nnz(C); fills *c_indptr/*c_indices/*c_data (malloc'd).
int64_t spgemm_csr(int32_t m, int32_t k, int32_t n,
                   const int32_t *a_indptr, const int32_t *a_indices,
                   const double *a_data,
                   const int32_t *b_indptr, const int32_t *b_indices,
                   const double *b_data,
                   int32_t **c_indptr_out, int32_t **c_indices_out,
                   double **c_data_out) {
  int32_t *c_indptr = (int32_t *)malloc(sizeof(int32_t) * (m + 1));
  std::vector<double> acc(n, 0.0);
  std::vector<int32_t> mark(n, -1);
  std::vector<int32_t> cols;
  // pass 1+2 fused with growable output
  std::vector<int32_t> out_idx;
  std::vector<double> out_val;
  out_idx.reserve((size_t)m * 8);
  out_val.reserve((size_t)m * 8);
  c_indptr[0] = 0;
  for (int32_t i = 0; i < m; i++) {
    cols.clear();
    for (int32_t jj = a_indptr[i]; jj < a_indptr[i + 1]; jj++) {
      int32_t j = a_indices[jj];
      double av = a_data[jj];
      for (int32_t kk = b_indptr[j]; kk < b_indptr[j + 1]; kk++) {
        int32_t col = b_indices[kk];
        if (mark[col] != i) {
          mark[col] = i;
          acc[col] = 0.0;
          cols.push_back(col);
        }
        acc[col] += av * b_data[kk];
      }
    }
    // sorted output rows (match scipy's canonical form)
    std::sort(cols.begin(), cols.end());
    for (int32_t col : cols) {
      out_idx.push_back(col);
      out_val.push_back(acc[col]);
    }
    c_indptr[i + 1] = (int32_t)out_idx.size();
  }
  int64_t nnz = (int64_t)out_idx.size();
  int32_t *ci = (int32_t *)malloc(sizeof(int32_t) * (nnz ? nnz : 1));
  double *cv = (double *)malloc(sizeof(double) * (nnz ? nnz : 1));
  memcpy(ci, out_idx.data(), sizeof(int32_t) * nnz);
  memcpy(cv, out_val.data(), sizeof(double) * nnz);
  *c_indptr_out = c_indptr;
  *c_indices_out = ci;
  *c_data_out = cv;
  return nnz;
}

// B = A^T for A(m×n) CSR; B is n×m CSR. Counting sort, O(nnz).
void csr_transpose(int32_t m, int32_t n, const int32_t *a_indptr,
                   const int32_t *a_indices, const double *a_data,
                   int32_t *b_indptr, int32_t *b_indices, double *b_data) {
  int64_t nnz = a_indptr[m];
  memset(b_indptr, 0, sizeof(int32_t) * (n + 1));
  for (int64_t e = 0; e < nnz; e++) b_indptr[a_indices[e] + 1]++;
  for (int32_t i = 0; i < n; i++) b_indptr[i + 1] += b_indptr[i];
  std::vector<int32_t> next(b_indptr, b_indptr + n);
  for (int32_t i = 0; i < m; i++) {
    for (int32_t jj = a_indptr[i]; jj < a_indptr[i + 1]; jj++) {
      int32_t j = a_indices[jj];
      int32_t pos = next[j]++;
      b_indices[pos] = i;
      b_data[pos] = a_data[jj];
    }
  }
}

// PMIS C/F splitting on a strength pattern S (CSR, m×m, pattern only).
// measure = |S^T column count| + LCG pseudo-random in [0,1) seeded by
// `seed` (deterministic, like the reference's srand(0) pinning,
// reference: src/SMEM_Main.cpp:674). cf_out: 1 = C, 0 = F.
void pmis_coarsen(int32_t n, const int32_t *s_indptr,
                  const int32_t *s_indices, uint64_t seed, int8_t *cf_out) {
  std::vector<double> meas(n, 0.0);
  for (int32_t i = 0; i < n; i++)
    for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++)
      meas[s_indices[jj]] += 1.0;  // in-degree = |S^T row|
  // splitmix64 per-index random, independent of iteration order
  for (int32_t i = 0; i < n; i++) {
    uint64_t z = seed + 0x9e3779b97f4a7c15ULL * (uint64_t)(i + 1);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    z = z ^ (z >> 31);
    meas[i] += (double)(z >> 11) / 9007199254740992.0;  // [0,1)
  }
  // symmetrized adjacency via S + S^T walk: build S^T indptr once
  std::vector<int32_t> st_indptr(n + 1, 0), st_indices(s_indptr[n]);
  for (int32_t i = 0; i < n; i++)
    for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++)
      st_indptr[s_indices[jj] + 1]++;
  for (int32_t i = 0; i < n; i++) st_indptr[i + 1] += st_indptr[i];
  {
    std::vector<int32_t> next(st_indptr.begin(), st_indptr.end() - 1);
    for (int32_t i = 0; i < n; i++)
      for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++)
        st_indices[next[s_indices[jj]]++] = i;
  }
  const int8_t UND = -1, F = 0, C = 1;
  std::vector<int8_t> cf(n, UND);
  // isolated points → F
  for (int32_t i = 0; i < n; i++)
    if (s_indptr[i + 1] == s_indptr[i] && st_indptr[i + 1] == st_indptr[i])
      cf[i] = F;
  bool changed = true;
  std::vector<int8_t> snap(n);
  while (changed) {
    changed = false;
    // round-synchronous independent set: decisions read a snapshot, so the
    // result is iteration-order independent (parallel PMIS semantics)
    memcpy(snap.data(), cf.data(), n);
    for (int32_t i = 0; i < n; i++) {
      if (snap[i] != UND) continue;
      bool win = true;
      for (int32_t jj = s_indptr[i]; win && jj < s_indptr[i + 1]; jj++) {
        int32_t j = s_indices[jj];
        if (snap[j] == UND && meas[j] >= meas[i] && j != i) win = false;
      }
      for (int32_t jj = st_indptr[i]; win && jj < st_indptr[i + 1]; jj++) {
        int32_t j = st_indices[jj];
        if (snap[j] == UND && meas[j] >= meas[i] && j != i) win = false;
      }
      if (win) {
        cf[i] = C;
        changed = true;
      }
    }
    // undecided points depending on a new C become F
    for (int32_t i = 0; i < n; i++) {
      if (cf[i] != UND) continue;
      for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++) {
        if (cf[s_indices[jj]] == C) {
          cf[i] = F;
          changed = true;
          break;
        }
      }
    }
  }
  for (int32_t i = 0; i < n; i++) cf_out[i] = (cf[i] == C) ? 1 : 0;
}

}  // extern "C"

extern "C" {

// Classical direct interpolation (see amg_tpu_torch/setup/interp.py for the
// formula; this is the same algorithm, row-for-row, so results are
// bit-identical to the Python reference implementation).
// cf: 1=C 0=F; cmap: coarse index per row (-1 for F rows).
int64_t interp_direct(int32_t n, int32_t nc,
                      const int32_t *a_indptr, const int32_t *a_indices,
                      const double *a_data,
                      const int32_t *s_indptr, const int32_t *s_indices,
                      const int8_t *cf, const int32_t *cmap,
                      int32_t **p_indptr_out, int32_t **p_indices_out,
                      double **p_data_out) {
  std::vector<int32_t> out_ptr(n + 1, 0);
  std::vector<int32_t> out_idx;
  std::vector<double> out_val;
  std::vector<int8_t> in_s(n, 0);
  for (int32_t i = 0; i < n; i++) {
    if (cf[i] == 1) {
      out_idx.push_back(cmap[i]);
      out_val.push_back(1.0);
      out_ptr[i + 1] = (int32_t)out_idx.size();
      continue;
    }
    for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++)
      in_s[s_indices[jj]] = 1;
    double diag = 0.0, sum_neg = 0.0, sum_pos = 0.0;
    double csum_neg = 0.0, csum_pos = 0.0;
    std::vector<std::pair<int32_t, double>> centries;
    for (int32_t jj = a_indptr[i]; jj < a_indptr[i + 1]; jj++) {
      int32_t j = a_indices[jj];
      double v = a_data[jj];
      if (j == i) {
        diag += v;
        continue;
      }
      if (v < 0) sum_neg += v; else sum_pos += v;
      if (cf[j] == 1 && in_s[j]) {
        centries.push_back({j, v});
        if (v < 0) csum_neg += v; else csum_pos += v;
      }
    }
    for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++)
      in_s[s_indices[jj]] = 0;
    if (centries.empty()) {
      out_ptr[i + 1] = (int32_t)out_idx.size();
      continue;
    }
    double alpha = (csum_neg != 0.0) ? sum_neg / csum_neg : 0.0;
    double beta = (csum_pos != 0.0) ? sum_pos / csum_pos : 0.0;
    if (csum_neg == 0.0) diag += sum_neg;
    if (csum_pos == 0.0) diag += sum_pos;
    for (auto &e : centries) {
      double scale = (e.second < 0) ? alpha : beta;
      out_idx.push_back(cmap[e.first]);
      out_val.push_back(-scale * e.second / diag);
    }
    out_ptr[i + 1] = (int32_t)out_idx.size();
  }
  int64_t nnz = (int64_t)out_idx.size();
  int32_t *pi = (int32_t *)malloc(sizeof(int32_t) * (n + 1));
  int32_t *pj = (int32_t *)malloc(sizeof(int32_t) * (nnz ? nnz : 1));
  double *pv = (double *)malloc(sizeof(double) * (nnz ? nnz : 1));
  memcpy(pi, out_ptr.data(), sizeof(int32_t) * (n + 1));
  memcpy(pj, out_idx.data(), sizeof(int32_t) * nnz);
  memcpy(pv, out_val.data(), sizeof(double) * nnz);
  *p_indptr_out = pi;
  *p_indices_out = pj;
  *p_data_out = pv;
  return nnz;
}

// Extended+i interpolation — faithful port of the Python implementation in
// amg_tpu_torch/setup/interp.py::extended_i_interpolation (including its
// row-entry-order-dependent sign filtering), so results match exactly.
int64_t interp_extpi(int32_t n, int32_t nc,
                     const int32_t *a_indptr, const int32_t *a_indices,
                     const double *a_data,
                     const int32_t *s_indptr, const int32_t *s_indices,
                     const int8_t *cf, const int32_t *cmap,
                     int32_t **p_indptr_out, int32_t **p_indices_out,
                     double **p_data_out) {
  std::vector<int32_t> out_ptr(n + 1, 0);
  std::vector<int32_t> out_idx;
  std::vector<double> out_val;
  std::vector<int8_t> in_s(n, 0);      // membership: strong nbrs of i
  std::vector<int32_t> ext_pos(n, -1); // position in ext list, -1 = absent
  std::vector<int32_t> ext;
  std::vector<double> w;
  ext.reserve(64);
  w.reserve(64);
  for (int32_t i = 0; i < n; i++) {
    if (cf[i] == 1) {
      out_idx.push_back(cmap[i]);
      out_val.push_back(1.0);
      out_ptr[i + 1] = (int32_t)out_idx.size();
      continue;
    }
    for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++)
      in_s[s_indices[jj]] = 1;
    // build extended C set: strong C nbrs, then C nbrs of strong F nbrs
    ext.clear();
    w.clear();
    for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++) {
      int32_t j = s_indices[jj];
      if (cf[j] == 1 && ext_pos[j] < 0) {
        ext_pos[j] = (int32_t)ext.size();
        ext.push_back(j);
      }
    }
    for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++) {
      int32_t j = s_indices[jj];
      if (cf[j] == 1) continue;
      for (int32_t kk = s_indptr[j]; kk < s_indptr[j + 1]; kk++) {
        int32_t k = s_indices[kk];
        if (cf[k] == 1 && ext_pos[k] < 0) {
          ext_pos[k] = (int32_t)ext.size();
          ext.push_back(k);
        }
      }
    }
    if (ext.empty()) {
      for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++)
        in_s[s_indices[jj]] = 0;
      out_ptr[i + 1] = (int32_t)out_idx.size();
      continue;
    }
    w.assign(ext.size(), 0.0);
    double diag = 0.0;
    for (int32_t jj = a_indptr[i]; jj < a_indptr[i + 1]; jj++) {
      int32_t j = a_indices[jj];
      double v = a_data[jj];
      if (j == i) {
        diag += v;
      } else if (ext_pos[j] >= 0) {
        w[ext_pos[j]] += v;
      } else if (in_s[j] && cf[j] != 1) {
        // strong F neighbor: distribute over shared ext C points
        double want_sign = (diag != 0.0 ? (diag > 0 ? -1.0 : 1.0) : -1.0);
        double denom = 0.0, back_to_i = 0.0;
        int32_t jlo = a_indptr[j], jhi = a_indptr[j + 1];
        for (int32_t kk = jlo; kk < jhi; kk++) {
          int32_t k = a_indices[kk];
          double vk = a_data[kk];
          double sgn = (vk > 0) - (vk < 0);
          if (ext_pos[k] >= 0 && sgn == want_sign) {
            denom += vk;
          } else if (k == i && sgn == want_sign) {
            denom += vk;
            back_to_i = vk;
          }
        }
        if (denom == 0.0) {
          diag += v;
          continue;
        }
        for (int32_t kk = jlo; kk < jhi; kk++) {
          int32_t k = a_indices[kk];
          double vk = a_data[kk];
          double sgn = (vk > 0) - (vk < 0);
          if (ext_pos[k] >= 0 && sgn == want_sign) w[ext_pos[k]] += v * vk / denom;
        }
        if (back_to_i != 0.0) diag += v * back_to_i / denom;
      } else {
        diag += v;  // weak connection: lump into diagonal
      }
    }
    if (diag != 0.0) {
      for (size_t t = 0; t < ext.size(); t++) {
        if (w[t] != 0.0) {
          out_idx.push_back(cmap[ext[t]]);
          out_val.push_back(-w[t] / diag);
        }
      }
    }
    for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++)
      in_s[s_indices[jj]] = 0;
    for (size_t t = 0; t < ext.size(); t++) ext_pos[ext[t]] = -1;
    out_ptr[i + 1] = (int32_t)out_idx.size();
  }
  int64_t nnz = (int64_t)out_idx.size();
  int32_t *pi = (int32_t *)malloc(sizeof(int32_t) * (n + 1));
  int32_t *pj = (int32_t *)malloc(sizeof(int32_t) * (nnz ? nnz : 1));
  double *pv = (double *)malloc(sizeof(double) * (nnz ? nnz : 1));
  memcpy(pi, out_ptr.data(), sizeof(int32_t) * (n + 1));
  memcpy(pj, out_idx.data(), sizeof(int32_t) * nnz);
  memcpy(pv, out_val.data(), sizeof(double) * nnz);
  *p_indptr_out = pi;
  *p_indices_out = pj;
  *p_data_out = pv;
  return nnz;
}

}  // extern "C"


extern "C" {

// HMIS-style coarsening: greedy Ruge-Stüben first pass biases the PMIS
// measures (matches amg_tpu_torch/setup/coarsen.py::hmis semantics; own
// deterministic randoms). cf_out: 1=C, 0=F.
void hmis_coarsen(int32_t n, const int32_t *s_indptr,
                  const int32_t *s_indices, uint64_t seed, int8_t *cf_out) {
  // S^T
  std::vector<int32_t> st_indptr(n + 1, 0), st_indices(s_indptr[n]);
  for (int32_t i = 0; i < n; i++)
    for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++)
      st_indptr[s_indices[jj] + 1]++;
  for (int32_t i = 0; i < n; i++) st_indptr[i + 1] += st_indptr[i];
  {
    std::vector<int32_t> next(st_indptr.begin(), st_indptr.end() - 1);
    for (int32_t i = 0; i < n; i++)
      for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++)
        st_indices[next[s_indices[jj]]++] = i;
  }
  // ---- RS first pass (greedy, dynamic measures via lazy heap) ----
  std::vector<double> meas(n, 0.0);
  for (int32_t i = 0; i < n; i++)
    meas[i] = (double)(st_indptr[i + 1] - st_indptr[i]);
  const int8_t UND = -1, F = 0, C = 1;
  std::vector<int8_t> rs(n, UND);
  for (int32_t i = 0; i < n; i++)
    if (s_indptr[i + 1] == s_indptr[i] && st_indptr[i + 1] == st_indptr[i])
      rs[i] = F;
  {
    typedef std::pair<double, int32_t> Ent;
    std::vector<Ent> heap;
    heap.reserve(n);
    for (int32_t i = 0; i < n; i++)
      if (rs[i] == UND) heap.push_back({meas[i], i});
    std::make_heap(heap.begin(), heap.end());
    while (!heap.empty()) {
      std::pop_heap(heap.begin(), heap.end());
      Ent e = heap.back();
      heap.pop_back();
      int32_t i = e.second;
      if (rs[i] != UND || e.first != meas[i]) continue;  // stale
      rs[i] = C;
      for (int32_t jj = st_indptr[i]; jj < st_indptr[i + 1]; jj++) {
        int32_t j = st_indices[jj];
        if (rs[j] != UND) continue;
        rs[j] = F;
        for (int32_t kk = s_indptr[j]; kk < s_indptr[j + 1]; kk++) {
          int32_t k = s_indices[kk];
          if (rs[k] == UND) {
            meas[k] += 1.0;
            heap.push_back({meas[k], k});
            std::push_heap(heap.begin(), heap.end());
          }
        }
      }
    }
  }
  // ---- PMIS rounds with RS-biased measures ----
  for (int32_t i = 0; i < n; i++) {
    meas[i] = (double)(st_indptr[i + 1] - st_indptr[i]);
    uint64_t z = seed + 0x9e3779b97f4a7c15ULL * (uint64_t)(i + 1);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    z = z ^ (z >> 31);
    meas[i] += (double)(z >> 11) / 9007199254740992.0;
    if (rs[i] == C) meas[i] += 2.0;  // RS C-points win ties
  }
  std::vector<int8_t> cf(n, UND);
  for (int32_t i = 0; i < n; i++)
    if (s_indptr[i + 1] == s_indptr[i] && st_indptr[i + 1] == st_indptr[i])
      cf[i] = F;
  bool changed = true;
  std::vector<int8_t> snap(n);
  while (changed) {
    changed = false;
    memcpy(snap.data(), cf.data(), n);
    for (int32_t i = 0; i < n; i++) {
      if (snap[i] != UND) continue;
      bool win = true;
      for (int32_t jj = s_indptr[i]; win && jj < s_indptr[i + 1]; jj++) {
        int32_t j = s_indices[jj];
        if (snap[j] == UND && meas[j] >= meas[i] && j != i) win = false;
      }
      for (int32_t jj = st_indptr[i]; win && jj < st_indptr[i + 1]; jj++) {
        int32_t j = st_indices[jj];
        if (snap[j] == UND && meas[j] >= meas[i] && j != i) win = false;
      }
      if (win) {
        cf[i] = C;
        changed = true;
      }
    }
    for (int32_t i = 0; i < n; i++) {
      if (cf[i] != UND) continue;
      for (int32_t jj = s_indptr[i]; jj < s_indptr[i + 1]; jj++) {
        if (cf[s_indices[jj]] == C) {
          cf[i] = F;
          changed = true;
          break;
        }
      }
    }
  }
  for (int32_t i = 0; i < n; i++) cf_out[i] = (cf[i] == C) ? 1 : 0;
}

}  // extern "C"
