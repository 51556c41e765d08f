// Native host-side sparse LDL' factorization for quasi-definite matrices.
//
// The reference reaches its per-iteration KKT factorizations through native
// libraries — QDLDL / CHOLMOD / MKL (LinearSystemSolvers.jl:18-75,
// ProxQP.jl:205). This is the framework's first-party equivalent: an
// up-looking sparse LDL' with no pivoting, which is exact for symmetric
// quasi-definite matrices such as the OSQP KKT system
// [[P + sigma*I, A'], [A, -I/rho]]. Written from the classical elimination-
// tree algorithm (Liu '86 etree; up-looking row factorization as in Davis,
// "Direct Methods for Sparse Linear Systems").
//
// Used host-side by the float64 test oracle and CPU fallback paths; the
// device compute path uses batched dense XLA ops instead (SURVEY.md
// "native components" table).
//
// Input convention: the UPPER-triangular part (including the diagonal) of a
// symmetric matrix in CSC with sorted row indices; every diagonal entry must
// be structurally present. All indices are int32, values double.

#include <cstdint>
#include <cstddef>
#include <vector>

extern "C" {

// Fill-reducing minimum-degree ordering on the symmetric pattern (upper CSC
// input, same convention as qps_ldl_etree). The classical elimination-graph
// algorithm with a quotient-graph representation (variables + elements, as
// in Davis, "Direct Methods for Sparse Linear Systems", ch. 7): eliminating
// a variable turns it into an element whose boundary is the union of its
// variable neighbours and its elements' boundaries; exact external degrees
// are recomputed for the affected variables only. Quasi-definite matrices
// stay factorizable under ANY symmetric permutation (Vanderbei '95), so the
// ordering is safe for the OSQP KKT system.
//
// perm[k] = original index of the k-th pivot. Returns 0, or -1 on invalid
// structure. Host-side, single-threaded; the cost model is the same reason
// the reference reaches for AMD via QDLDL (its default ordering).
int32_t qps_mindeg_order(int32_t n, const int32_t* Ap, const int32_t* Ai,
                         int32_t* perm) {
  if (n <= 0) return -1;
  // adj[v]: variable neighbours (indices < n); elems[v]: element ids.
  std::vector<std::vector<int32_t>> adj(n), elems(n), elem_vars;
  for (int32_t k = 0; k < n; ++k) {
    if (Ap[k + 1] <= Ap[k] || Ai[Ap[k + 1] - 1] != k) return -1;
    for (int32_t p = Ap[k]; p < Ap[k + 1] - 1; ++p) {
      int32_t i = Ai[p];
      if (i >= k || i < 0) return -1;
      adj[i].push_back(k);
      adj[k].push_back(i);
    }
  }
  std::vector<int32_t> degree(n), mark(n, -1);
  std::vector<int8_t> eliminated(n, 0), absorbed;
  // Degree buckets with lazy deletion: stale entries are skipped when
  // popped (degree mismatch or already eliminated).
  std::vector<std::vector<int32_t>> bucket(n + 1);
  for (int32_t v = 0; v < n; ++v) {
    degree[v] = (int32_t)adj[v].size();
    bucket[degree[v]].push_back(v);
  }

  // Reach(v): distinct live neighbours through adj + elements.
  std::vector<int32_t> reach;
  int32_t stamp = 0;
  auto compute_reach = [&](int32_t v) {
    ++stamp;
    reach.clear();
    for (int32_t u : adj[v])
      if (!eliminated[u] && u != v && mark[u] != stamp) {
        mark[u] = stamp;
        reach.push_back(u);
      }
    for (int32_t e : elems[v])
      for (int32_t u : elem_vars[e])
        if (!eliminated[u] && u != v && mark[u] != stamp) {
          mark[u] = stamp;
          reach.push_back(u);
        }
  };

  int32_t dmin = 0;
  for (int32_t k = 0; k < n; ++k) {
    // Pop the live minimum-degree variable.
    int32_t best = -1;
    while (best == -1) {
      while (dmin <= n && bucket[dmin].empty()) ++dmin;
      int32_t v = bucket[dmin].back();
      bucket[dmin].pop_back();
      if (!eliminated[v] && degree[v] == dmin) best = v;
    }
    perm[k] = best;
    eliminated[best] = 1;

    compute_reach(best);
    // New element: boundary = reach(best). Elements adjacent to best are
    // absorbed (their boundaries are subsets of the new one plus best, and
    // every variable referencing them lies in reach(best) by the quotient-
    // graph invariant), so references to them can be dropped exactly.
    int32_t eid = (int32_t)elem_vars.size();
    std::vector<int32_t> boundary = reach;  // copy: reach is reused below
    for (int32_t e : elems[best]) absorbed[e] = 1;
    elem_vars.push_back(boundary);
    absorbed.push_back(0);
    for (int32_t u : boundary) {
      auto& ue = elems[u];
      std::size_t w = 0;
      for (std::size_t r = 0; r < ue.size(); ++r)
        if (!absorbed[ue[r]]) ue[w++] = ue[r];
      ue.resize(w);
      ue.push_back(eid);
      auto& ua = adj[u];
      std::size_t wa = 0;
      for (std::size_t r = 0; r < ua.size(); ++r)
        if (!eliminated[ua[r]]) ua[wa++] = ua[r];
      ua.resize(wa);
      compute_reach(u);
      degree[u] = (int32_t)reach.size();
      bucket[degree[u]].push_back(u);
      if (degree[u] < dmin) dmin = degree[u];
    }
  }
  return 0;
}

// Computes the elimination tree and the nonzero count of each column of L.
// work must hold n ints. Returns the total number of nonzeros in L (below
// the diagonal), or -1 if the matrix is structurally invalid (missing
// diagonal / unsorted or out-of-range row index).
int32_t qps_ldl_etree(int32_t n, const int32_t* Ap, const int32_t* Ai,
                      int32_t* work, int32_t* Lnz, int32_t* parent) {
  for (int32_t i = 0; i < n; ++i) {
    parent[i] = -1;
    work[i] = -1;  // most recent column that touched node i
    Lnz[i] = 0;
  }
  for (int32_t k = 0; k < n; ++k) {
    if (Ap[k + 1] <= Ap[k]) return -1;                 // empty column
    if (Ai[Ap[k + 1] - 1] != k) return -1;             // diagonal must be last
    work[k] = k;
    for (int32_t p = Ap[k]; p < Ap[k + 1] - 1; ++p) {
      int32_t i = Ai[p];
      if (i >= k) return -1;                           // not upper triangular
      // Walk up the tree from i until we meet a node already associated
      // with column k, extending the tree as we go.
      while (work[i] != k) {
        if (parent[i] == -1) parent[i] = k;
        ++Lnz[i];
        work[i] = k;
        i = parent[i];
      }
    }
  }
  int64_t total = 0;
  for (int32_t i = 0; i < n; ++i) total += Lnz[i];
  if (total > INT32_MAX) return -1;
  return static_cast<int32_t>(total);
}

// Numeric factorization A = L D L' with unit-lower L (strictly-lower part
// stored CSC in Lp/Li/Lx) and diagonal D. Requires the outputs of
// qps_ldl_etree. Scratch: iwork (3n ints), bwork (n chars), fwork (n
// doubles). Returns the number of positive diagonal entries, or -1 if a
// zero pivot is hit (quasi-definite inputs never hit one in exact
// arithmetic).
int32_t qps_ldl_factor(int32_t n, const int32_t* Ap, const int32_t* Ai,
                       const double* Ax, int32_t* Lp, int32_t* Li, double* Lx,
                       double* D, double* Dinv, const int32_t* Lnz,
                       const int32_t* parent, int32_t* iwork, int8_t* bwork,
                       double* fwork) {
  int32_t positive = 0;
  int32_t* fill = iwork;            // next write slot per column of L
  int32_t* pattern = iwork + n;     // row-k pattern, built in reverse
  int32_t* visiting = iwork + 2 * n;
  (void)visiting;

  Lp[0] = 0;
  for (int32_t i = 0; i < n; ++i) {
    Lp[i + 1] = Lp[i] + Lnz[i];
    fill[i] = Lp[i];
    bwork[i] = 0;    // node marked?
    fwork[i] = 0.0;  // sparse accumulator y
  }

  for (int32_t k = 0; k < n; ++k) {
    // Scatter the strictly-upper entries of column k of A into y and find
    // the pattern of row k of L as the union of etree paths.
    int32_t top = n;
    D[k] = Ax[Ap[k + 1] - 1];  // diagonal entry (last in the column)
    for (int32_t p = Ap[k]; p < Ap[k + 1] - 1; ++p) {
      int32_t i = Ai[p];
      fwork[i] = Ax[p];
      int32_t len = 0;
      while (!bwork[i]) {  // walk towards the root, collecting the path
        pattern[len++] = i;
        bwork[i] = 1;
        i = parent[i];
        if (i == -1 || i >= k) break;
      }
      // Reverse the path onto the pattern stack so ancestors come first.
      while (len > 0) pattern[--top] = pattern[--len];
    }

    // Process pattern nodes in ascending elimination order.
    for (int32_t t = top; t < n; ++t) {
      int32_t j = pattern[t];
      double yj = fwork[j];
      fwork[j] = 0.0;
      bwork[j] = 0;
      // y -= L[:,j] * yj for the rows already present in column j.
      for (int32_t p = Lp[j]; p < fill[j]; ++p) fwork[Li[p]] -= Lx[p] * yj;
      double lkj = yj * Dinv[j];
      D[k] -= lkj * yj;
      Li[fill[j]] = k;
      Lx[fill[j]] = lkj;
      ++fill[j];
    }

    if (D[k] == 0.0) return -1;
    if (D[k] > 0.0) ++positive;
    Dinv[k] = 1.0 / D[k];
  }
  return positive;
}

// In-place solve of L D L' x = b given the factorization.
void qps_ldl_solve(int32_t n, const int32_t* Lp, const int32_t* Li,
                   const double* Lx, const double* Dinv, double* x) {
  for (int32_t j = 0; j < n; ++j) {
    double xj = x[j];
    for (int32_t p = Lp[j]; p < Lp[j + 1]; ++p) x[Li[p]] -= Lx[p] * xj;
  }
  for (int32_t j = 0; j < n; ++j) x[j] *= Dinv[j];
  for (int32_t j = n - 1; j >= 0; --j) {
    double acc = 0.0;
    for (int32_t p = Lp[j]; p < Lp[j + 1]; ++p) acc += Lx[p] * x[Li[p]];
    x[j] -= acc;
  }
}

// Convenience: repeated solves with multiple right-hand sides, column-major.
void qps_ldl_solve_multi(int32_t n, int32_t nrhs, const int32_t* Lp,
                         const int32_t* Li, const double* Lx,
                         const double* Dinv, double* X) {
  for (int32_t r = 0; r < nrhs; ++r) qps_ldl_solve(n, Lp, Li, Lx, Dinv, X + (int64_t)r * n);
}

}  // extern "C"
