// Native host kernels for mfmg_tpu setup hot paths.
//
// The reference's runtime is C++ end-to-end (deal.II assembly loops,
// Trilinos CSR plumbing, cuda/utils.cu converters).  In this build the
// device compute path is XLA, but the host setup pipeline keeps native
// kernels for the operations where numpy's generic dispatch is the
// bottleneck: batched agglomerate dense assembly (the np.add.at scatter),
// per-patch assembly for fast_ap, and ELL packing.
//
// Build: g++ -O3 -march=native -shared -fPIC mfmg_host.cpp -o libmfmg_host.so
// Loaded via ctypes (mfmg_tpu/native.py) with transparent numpy fallback.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Agglomerates are independent (disjoint output blocks), so the batch splits
// across host threads with no synchronization — the analog of the
// reference's WorkStream threading over agglomerates
// (dealii/amge_host.templates.hpp:508-519).
template <typename F>
void parallel_ranges(int64_t n, F&& body)
{
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw ? (int64_t)hw : 1;
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  if (n_threads <= 1) { body((int64_t)0, n); return; }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = n * t / n_threads, hi = n * (t + 1) / n_threads;
    pool.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Batched dense assembly for uniform structured agglomerates:
//   A_agg[g] += sum_{c in agg g} scatter(A_loc[cells_per_agg[g,c]])
// local_cells (n_bc, n_loc) gives the block-local dof index of each cell's
// local dofs and is shared by every agglomerate.
void assemble_agglomerate_batch_uniform(
    const int64_t* cells_per_agg,   // (n_agg, n_bc)
    const int64_t* local_cells,     // (n_bc, n_loc)
    const double* A_loc,            // (n_cells, n_loc, n_loc)
    double* A_agg,                  // (n_agg, m, m), zero-initialized
    int64_t n_agg, int64_t n_bc, int64_t n_loc, int64_t m)
{
  const int64_t nl2 = n_loc * n_loc;
  parallel_ranges(n_agg, [=](int64_t g_lo, int64_t g_hi) {
    for (int64_t g = g_lo; g < g_hi; ++g) {
      double* Ag = A_agg + g * m * m;
      for (int64_t c = 0; c < n_bc; ++c) {
        const double* Ac = A_loc + cells_per_agg[g * n_bc + c] * nl2;
        const int64_t* lc = local_cells + c * n_loc;
        for (int64_t i = 0; i < n_loc; ++i) {
          double* row = Ag + lc[i] * m;
          const double* src = Ac + i * n_loc;
          for (int64_t j = 0; j < n_loc; ++j)
            row[lc[j]] += src[j];
        }
      }
    }
  });
}

// float32-output variant: the downstream pipeline (batched eigensolve,
// Galerkin blocks) runs in float32 when the hierarchy dtype allows, so
// assembling straight into float halves the batch's memory traffic.
void assemble_agglomerate_batch_uniform_f32(
    const int64_t* cells_per_agg,   // (n_agg, n_bc)
    const int64_t* local_cells,     // (n_bc, n_loc)
    const double* A_loc,            // (n_cells, n_loc, n_loc)
    float* A_agg,                   // (n_agg, m, m), zero-initialized
    int64_t n_agg, int64_t n_bc, int64_t n_loc, int64_t m)
{
  const int64_t nl2 = n_loc * n_loc;
  parallel_ranges(n_agg, [=](int64_t g_lo, int64_t g_hi) {
    for (int64_t g = g_lo; g < g_hi; ++g) {
      float* Ag = A_agg + g * m * m;
      for (int64_t c = 0; c < n_bc; ++c) {
        const double* Ac = A_loc + cells_per_agg[g * n_bc + c] * nl2;
        const int64_t* lc = local_cells + c * n_loc;
        for (int64_t i = 0; i < n_loc; ++i) {
          float* row = Ag + lc[i] * m;
          const double* src = Ac + i * n_loc;
          for (int64_t j = 0; j < n_loc; ++j)
            row[lc[j]] += (float)src[j];
        }
      }
    }
  });
}

// Structured-grid stencil extraction scatter:
//   coeffs[oid_ab[a,b], rows[c,a]] += A_loc[c,a,b]
// Parallel over stencil planes (distinct oid -> disjoint output), each thread
// walking only its plane's (a,b) pairs — no synchronization.
void stencil_scatter(
    const int64_t* rows,            // (n_cells, n_loc) global node of (c, a)
    const int64_t* oid_ab,          // (n_loc, n_loc) plane id of (a, b)
    const double* A_loc,            // (n_cells, n_loc, n_loc)
    double* coeffs,                 // (n_planes, n_nodes), zero-initialized
    int64_t n_cells, int64_t n_loc, int64_t n_planes, int64_t n_nodes)
{
  // group (a, b) pairs by plane id
  std::vector<std::vector<int64_t>> pairs(n_planes);
  for (int64_t a = 0; a < n_loc; ++a)
    for (int64_t b = 0; b < n_loc; ++b)
      pairs[oid_ab[a * n_loc + b]].push_back(a * n_loc + b);
  const int64_t nl2 = n_loc * n_loc;
  parallel_ranges(n_planes, [&](int64_t p_lo, int64_t p_hi) {
    for (int64_t p = p_lo; p < p_hi; ++p) {
      double* out = coeffs + p * n_nodes;
      for (int64_t ab : pairs[p]) {
        const int64_t a = ab / n_loc;
        for (int64_t c = 0; c < n_cells; ++c)
          out[rows[c * n_loc + a]] += A_loc[c * nl2 + ab];
      }
    }
  });
}

// Generic per-patch dense assembly (ragged agglomerates / fast_ap patches):
// one patch at a time, caller loops.
void assemble_patch(
    const int64_t* cell_ids,        // (n_cells_patch,)
    const int64_t* local_cells,     // (n_cells_patch, n_loc)
    const double* A_loc,            // (n_cells_total, n_loc, n_loc)
    double* A_out,                  // (m, m), zero-initialized
    int64_t n_cells_patch, int64_t n_loc, int64_t m)
{
  const int64_t nl2 = n_loc * n_loc;
  for (int64_t c = 0; c < n_cells_patch; ++c) {
    const double* Ac = A_loc + cell_ids[c] * nl2;
    const int64_t* lc = local_cells + c * n_loc;
    for (int64_t i = 0; i < n_loc; ++i) {
      double* row = A_out + lc[i] * m;
      const double* src = Ac + i * n_loc;
      for (int64_t j = 0; j < n_loc; ++j)
        row[lc[j]] += src[j];
    }
  }
}

// Per-agglomerate restriction row structure: t_s[a] = number of distinct
// R rows touching agglomerate a's dofs.  dof_rows (n_dofs_padded? no —
// indexed through dm) is the padded per-dof row list (-1 padding), q wide.
void agg_row_count(
    const int64_t* dm,              // (n_agg, m) global dof of each slot
    const uint8_t* valid,           // (n_agg, m)
    const int64_t* dof_rows,        // (n_dofs, q), -1 padded
    int64_t n_agg, int64_t m, int64_t q,
    int64_t* t_s)                   // (n_agg,) out
{
  parallel_ranges(n_agg, [=](int64_t lo, int64_t hi) {
    std::vector<int64_t> buf;
    buf.reserve((size_t)(m * q));
    for (int64_t a = lo; a < hi; ++a) {
      buf.clear();
      for (int64_t i = 0; i < m; ++i) {
        if (!valid[a * m + i]) continue;
        const int64_t* rr = dof_rows + dm[a * m + i] * q;
        for (int64_t k = 0; k < q; ++k)
          if (rr[k] >= 0) buf.push_back(rr[k]);
      }
      std::sort(buf.begin(), buf.end());
      t_s[a] = (int64_t)(std::unique(buf.begin(), buf.end()) - buf.begin());
    }
  });
}

// Fill arows (sorted unique rows, padded to t_max) and the dense block
// Rb[a, t, i] = R[arows[a,t], dof i] (0 where the dof is masked out by
// `keep` — the recursive level zeroes constrained dofs' values while the
// row still counts structurally).  The scatter replaces the numpy
// gather/broadcast/searchsorted pipeline (measured 1.8 s -> ~0.1 s at
// 4096x125x16).
void agg_row_blocks(
    const int64_t* dm,              // (n_agg, m)
    const uint8_t* valid,           // (n_agg, m)
    const uint8_t* keep,            // (n_agg, m) value mask
    const int64_t* dof_rows,        // (n_dofs, q)
    const double* dof_vals,         // (n_dofs, q)
    int64_t n_agg, int64_t m, int64_t q, int64_t t_max,
    int64_t* arows,                 // (n_agg, t_max), zero-initialized
    double* Rb)                     // (n_agg, t_max, m), zero-initialized
{
  parallel_ranges(n_agg, [=](int64_t lo, int64_t hi) {
    std::vector<int64_t> buf;
    buf.reserve((size_t)(m * q));
    for (int64_t a = lo; a < hi; ++a) {
      buf.clear();
      for (int64_t i = 0; i < m; ++i) {
        if (!valid[a * m + i]) continue;
        const int64_t* rr = dof_rows + dm[a * m + i] * q;
        for (int64_t k = 0; k < q; ++k)
          if (rr[k] >= 0) buf.push_back(rr[k]);
      }
      std::sort(buf.begin(), buf.end());
      const int64_t t = (int64_t)(std::unique(buf.begin(), buf.end()) - buf.begin());
      int64_t* ar = arows + a * t_max;
      for (int64_t j = 0; j < t; ++j) ar[j] = buf[j];
      double* R = Rb + a * t_max * m;
      for (int64_t i = 0; i < m; ++i) {
        if (!valid[a * m + i] || !keep[a * m + i]) continue;
        const int64_t d = dm[a * m + i];
        const int64_t* rr = dof_rows + d * q;
        const double* rv = dof_vals + d * q;
        for (int64_t k = 0; k < q; ++k) {
          if (rr[k] < 0) continue;
          const int64_t pos =
              std::lower_bound(buf.begin(), buf.begin() + t, rr[k]) - buf.begin();
          R[pos * m + i] = rv[k];
        }
      }
    }
  });
}

// Fused scatter of per-agglomerate Galerkin (K) and Gram (Mb) blocks into
// the padded per-super batches:
//   A1[g_of[a], gpos[a,i], gpos[a,j]] += K[a,i,j]
//   M [g_of[a], gpos[a,i], gpos[a,j]] += Mb[a,i,j]
// gpos entries equal to m1p-1 are the dump slot (padding), kept as in the
// numpy path and sliced off by the caller.  Serial over agglomerates (two
// supers may interleave), ~100 ms where the bincount pipeline took 1.7 s.
void scatter_super_blocks(
    const int64_t* g_of,            // (n_agg,)
    const int64_t* gpos,            // (n_agg, t_max)
    const float* K,                 // (n_agg, t_max, t_max)
    const double* Mb,               // (n_agg, t_max, t_max)
    double* A1, double* M,          // (n_super, m1p, m1p), zero-initialized
    int64_t n_agg, int64_t t_max, int64_t m1p)
{
  const int64_t b2 = m1p * m1p, t2 = t_max * t_max;
  for (int64_t a = 0; a < n_agg; ++a) {
    double* A1g = A1 + g_of[a] * b2;
    double* Mg = M + g_of[a] * b2;
    const int64_t* gp = gpos + a * t_max;
    const float* Ka = K + a * t2;
    const double* Ma = Mb + a * t2;
    for (int64_t i = 0; i < t_max; ++i) {
      const int64_t ri = gp[i] * m1p;
      for (int64_t j = 0; j < t_max; ++j) {
        A1g[ri + gp[j]] += (double)Ka[i * t_max + j];
        Mg[ri + gp[j]] += Ma[i * t_max + j];
      }
    }
  }
}

// float64-K variant.
void scatter_super_blocks_f64(
    const int64_t* g_of, const int64_t* gpos,
    const double* K, const double* Mb,
    double* A1, double* M,
    int64_t n_agg, int64_t t_max, int64_t m1p)
{
  const int64_t b2 = m1p * m1p, t2 = t_max * t_max;
  for (int64_t a = 0; a < n_agg; ++a) {
    double* A1g = A1 + g_of[a] * b2;
    double* Mg = M + g_of[a] * b2;
    const int64_t* gp = gpos + a * t_max;
    const double* Ka = K + a * t2;
    const double* Ma = Mb + a * t2;
    for (int64_t i = 0; i < t_max; ++i) {
      const int64_t ri = gp[i] * m1p;
      for (int64_t j = 0; j < t_max; ++j) {
        A1g[ri + gp[j]] += Ka[i * t_max + j];
        Mg[ri + gp[j]] += Ma[i * t_max + j];
      }
    }
  }
}

// Greedy distance-1 graph coloring over an ELL adjacency (sequential
// first-fit — the classical greedy; O(nnz)).  vals==0 entries and the
// diagonal are skipped.  colors must be -1-initialized by the caller.
void greedy_color(
    const int32_t* cols,            // (n, L)
    const double* vals,             // (n, L)
    int32_t* colors,                // (n,) init -1
    int64_t n, int64_t L)
{
  std::vector<int32_t> mark;        // color -> last row that marked it
  mark.reserve(64);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* ci = cols + i * L;
    const double* vi = vals + i * L;
    for (int64_t k = 0; k < L; ++k) {
      if (vi[k] == 0.0) continue;
      const int32_t c = ci[k];
      if (c == i) continue;
      const int32_t nc = colors[c];
      if (nc >= 0) {
        if ((int64_t)mark.size() <= nc) mark.resize(nc + 1, -1);
        mark[nc] = (int32_t)i;
      }
    }
    int32_t col = 0;
    while (col < (int32_t)mark.size() && mark[col] == (int32_t)i) ++col;
    colors[i] = col;
  }
}

// CSR -> ELL packing.
void ell_pack(
    const int64_t* indptr,          // (n_rows+1,)
    const int32_t* indices,         // (nnz,)
    const double* data,             // (nnz,)
    double* vals,                   // (n_rows, L), zero-initialized
    int32_t* cols,                  // (n_rows, L), zero-initialized
    int64_t n_rows, int64_t L)
{
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t b = indptr[r], e = indptr[r + 1];
    double* vr = vals + r * L;
    int32_t* cr = cols + r * L;
    for (int64_t p = b; p < e; ++p) {
      vr[p - b] = data[p];
      cr[p - b] = indices[p];
    }
  }
}

}  // extern "C"
