// csparse3-jax native host kernels.
//
// The reference ships its native compute as templated C++ sparsetools
// (reference: src/sparsetools/*.h) bound via SWIG; here the native layer
// covers only the *host-symbolic* pieces that are inherently sequential
// and latency-bound in Python — sparse LU factorization (the left-looking
// algorithm of linalg/lu_host.py, reference breadcrumb
// src/research/scipy_wrappers.py), triplet->CSC assembly, and entry-stream
// sort/dedup — while all throughput compute stays on the device via XLA.
// Bound with ctypes (plain extern "C"), no SWIG/pybind.
//
// Build: make -C native   (produces csparse3_jax/native/libhost_ext.so)

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <complex>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <numeric>
#include <thread>
#include <vector>

#include <dlfcn.h>
#include <sys/mman.h>

#include "host_common.h"

using std::int64_t;

// ---------------------------------------------------------------------------
// Optional LAPACK getrf for the dense trailing block of the LU (loaded at
// runtime from scipy's bundled OpenBLAS — symbols scipy_dgetrf_/scipy_zgetrf_
// or plain dgetrf_/zgetrf_; see host_ext.py::_load_blas).
// ---------------------------------------------------------------------------

BlasFns g_blas;

namespace {

template <typename T>
void call_getrf(int m, T* a, int lda, int* ipiv, int* info);
template <>
void call_getrf<double>(int m, double* a, int lda, int* ipiv, int* info) {
  g_blas.dgetrf(&m, &m, a, &lda, ipiv, info);
}
template <>
void call_getrf<cplx>(int m, cplx* a, int lda, int* ipiv, int* info) {
  g_blas.zgetrf(&m, &m, a, &lda, ipiv, info);
}

}  // namespace

// Populated mmap for big scratch (demand faults are pathological on
// sandboxed kernels — see native/npalloc.c).
void* pop_alloc_raw(size_t bytes, bool* mapped) {
  void* p = mmap(NULL, bytes, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS | MAP_POPULATE, -1, 0);
  if (p != MAP_FAILED) {
    *mapped = true;
    return p;
  }
  *mapped = false;
  return std::calloc(bytes, 1);
}
void pop_free_raw(void* p, size_t bytes, bool mapped) {
  if (mapped)
    munmap(p, bytes);
  else
    std::free(p);
}

extern "C" {

// Load getrf/gemm/trsm from the given shared library (idempotent; returns
// 1 on success).  Tries scipy_-prefixed then plain LAPACK symbol names.
int lu_load_blas(const char* path) {
  if (g_blas.ok()) return 1;
  void* h = dlopen(path, RTLD_NOW | RTLD_LOCAL);
  if (!h) return 0;
  auto find = [&](const char* a, const char* b) -> void* {
    void* s = dlsym(h, a);
    return s ? s : dlsym(h, b);
  };
  g_blas.dgetrf = (getrf_d_t)find("scipy_dgetrf_", "dgetrf_");
  g_blas.zgetrf = (getrf_z_t)find("scipy_zgetrf_", "zgetrf_");
  g_blas.dgemm = (gemm_d_t)find("scipy_dgemm_", "dgemm_");
  g_blas.zgemm = (gemm_z_t)find("scipy_zgemm_", "zgemm_");
  g_blas.dtrsm = (trsm_d_t)find("scipy_dtrsm_", "dtrsm_");
  g_blas.ztrsm = (trsm_z_t)find("scipy_ztrsm_", "ztrsm_");
  return g_blas.ok() ? 1 : 0;
}

}  // extern "C"

extern "C" {

void lu_free(LUResult* r) {
  if (!r) return;
  std::free(r->Lp);
  std::free(r->Li);
  std::free(r->Up);
  std::free(r->Ui);
  std::free(r->perm_r);
  std::free(r->sing);
  std::free(r->Lx);
  std::free(r->Ux);
  std::free(r);
}

}  // extern "C"

namespace {

template <typename T>
double mag(T x) {
  return std::abs(x);
}

template <typename T>
T inf_fill(T x) {
  return x * std::numeric_limits<double>::infinity();
}
template <>
cplx inf_fill(cplx x) {
  return x * std::numeric_limits<double>::infinity();
}

// Left-looking sparse LU with threshold partial pivoting (Gilbert-Peierls
// with Eisenstat-Liu symmetric pruning, as in KLU/SuperLU).  Twin of
// linalg/lu_host.py::lu_factor_host (same reach/eliminate/pivot/split
// semantics, including SuperLU-style singular handling: zero pivot ->
// inf/nan fill, column recorded in `sing`).
//
// L is built in one contiguous growable buffer (original-row space); each
// finished column j carries a pruned length plen[j]: once a symmetric
// pivot pair (U(j,k) != 0 and pivrow_k in L(:,j)) is found, the column is
// partitioned so that DFS traversals only scan the already-pivotal front —
// the non-pivotal tail is reachable through column k instead.  This drops
// the symbolic cost from O(lnz) scans per column to near the true edge
// count, which is the main gap between naive GP and KLU-class solvers.
#ifdef LU_PROFILE
struct LuProf {
  double dfs = 0, numeric = 0, split = 0, prune = 0, exp = 0;
  int64_t dfs_edges = 0, num_flops = 0, prune_scans = 0, prune_hits = 0;
  ~LuProf() {
    std::fprintf(stderr,
                 "[luprof] dfs=%.3fs numeric=%.3fs split=%.3fs prune=%.3fs "
                 "export=%.3fs | edges=%lld flops=%lld scans=%lld hits=%lld\n",
                 dfs, numeric, split, prune, exp, (long long)dfs_edges,
                 (long long)num_flops, (long long)prune_scans,
                 (long long)prune_hits);
  }
};
static LuProf g_luprof;
#define LU_TIC auto _t0 = std::chrono::steady_clock::now()
#define LU_TOC(field)                                                     \
  do {                                                                    \
    auto _t1 = std::chrono::steady_clock::now();                          \
    g_luprof.field += std::chrono::duration<double>(_t1 - _t0).count();   \
    _t0 = _t1;                                                            \
  } while (0)
#else
#define LU_TIC
#define LU_TOC(field)
#endif

template <typename T>
LUResult* lu_factor(int64_t n, const int64_t* Ap, const int64_t* Ai,
                    const T* Ax, const int64_t* q, double tol,
                    int64_t dense_cap) {
  // L under construction: contiguous (column-appended) buffers.
  std::vector<int64_t> Lcp(n + 1, 0);
  std::vector<int64_t> Lrow;
  std::vector<T> Lval;
  Lrow.reserve((size_t)(4 * Ap[n] + n));
  Lval.reserve((size_t)(4 * Ap[n] + n));
  std::vector<int64_t> plen(n, -1);  // pruned front length; -1 = unpruned

  // U: emitted in column order directly.
  std::vector<int64_t> Up(n + 1, 0);
  std::vector<int64_t> Urow;
  std::vector<T> Uval;
  Urow.reserve((size_t)(2 * Ap[n] + n));
  Uval.reserve((size_t)(2 * Ap[n] + n));

  std::vector<int64_t> pinv(n, -1), perm_r(n, -1);
  std::vector<int64_t> singular;

  std::vector<T> x(n, T(0));
  std::vector<int64_t> flag(n, -1), in_pattern(n, -1);
  std::vector<int64_t> stack(n), estack(n), topo(n);
  std::vector<int64_t> pat_rows;
  pat_rows.reserve(n);

  // x = (L so far)^{-1} A(:,col): symbolic DFS reach (pruned columns only
  // over their pivotal front) + numeric scatter update.  Fills pat_rows
  // (unique pattern rows) and x; the caller consumes and zeroes x.
  auto sparse_apply = [&](int64_t col, int64_t k) {
    const int64_t a_lo = Ap[col], a_hi = Ap[col + 1];
    int64_t top = n;
    pat_rows.clear();
    for (int64_t p = a_lo; p < a_hi; ++p) {
      const int64_t r = Ai[p];
      if (in_pattern[r] != k) {
        in_pattern[r] = k;
        pat_rows.push_back(r);
      }
      const int64_t j0 = pinv[r];
      if (j0 >= 0 && flag[j0] != k) {
        int64_t sp = 0;
        stack[0] = j0;
        estack[0] = 0;
        flag[j0] = k;
        while (sp >= 0) {
          const int64_t node = stack[sp];
          const int64_t lo = Lcp[node];
          const int64_t hi =
              plen[node] >= 0 ? lo + plen[node] : Lcp[node + 1];
          int64_t e = lo + estack[sp];
          bool advanced = false;
          while (e < hi) {
            const int64_t rr = Lrow[e];
            ++e;
#ifdef LU_PROFILE
            g_luprof.dfs_edges += 1;
#endif
            if (in_pattern[rr] != k) {
              in_pattern[rr] = k;
              pat_rows.push_back(rr);
            }
            const int64_t jj = pinv[rr];
            if (jj >= 0 && flag[jj] != k) {
              flag[jj] = k;
              estack[sp] = e - lo;
              ++sp;
              stack[sp] = jj;
              estack[sp] = 0;
              advanced = true;
              break;
            }
          }
          if (!advanced) {
            --top;
            topo[top] = node;
            --sp;
          }
        }
      }
    }
    for (int64_t p = a_lo; p < a_hi; ++p) x[Ai[p]] = T(0);
    for (int64_t p = a_lo; p < a_hi; ++p) x[Ai[p]] += Ax[p];
    for (int64_t t = top; t < n; ++t) {
      const int64_t j = topo[t];
      const T xj = x[perm_r[j]];
      if (xj != T(0)) {
        const int64_t* rj = Lrow.data() + Lcp[j];
        const T* vj = Lval.data() + Lcp[j];
        const int64_t len = Lcp[j + 1] - Lcp[j];
#ifdef LU_PROFILE
        g_luprof.num_flops += len;
#endif
        for (int64_t e = 0; e < len; ++e) x[rj[e]] -= vj[e] * xj;
      }
    }
  };

  // Dense trailing block: once the remaining submatrix is dense enough,
  // gather its Schur complement (columns still pass through sparse_apply
  // for the updates from finished columns) into a column-major m x m
  // buffer and finish with LAPACK getrf (strict partial pivoting — the
  // same pivot rule as tol=1.0).  The last separator clique carries the
  // large majority of the flops (80%+ on grid cases), so this runs the
  // hot part at BLAS speed instead of the scalar scatter loop.  Returns
  // false (leaving factor state untouched except stamp arrays, which the
  // caller must reset) if getrf hits an exactly-singular tail.
  auto dense_tail = [&](int64_t k0) -> bool {
    const int64_t m = n - k0;
#ifdef LU_PROFILE
    std::fprintf(stderr, "[luprof] dense_tail k0=%lld m=%lld\n",
                 (long long)k0, (long long)m);
#endif
    std::vector<int64_t> local_rows;
    local_rows.reserve(m);
    std::vector<int64_t> rmap(n, -1);
    for (int64_t r = 0; r < n; ++r)
      if (pinv[r] < 0) {
        rmap[r] = (int64_t)local_rows.size();
        local_rows.push_back(r);
      }
    if ((int64_t)local_rows.size() != m) return false;
    bool mapped;
    const size_t bytes = (size_t)m * m * sizeof(T);
    T* S = (T*)pop_alloc_raw(bytes, &mapped);
    std::vector<int64_t> tu_off(m + 1, 0);
    std::vector<int64_t> tu_rows;
    std::vector<T> tu_vals;
    for (int64_t idx = 0; idx < m; ++idx) {
      const int64_t k = k0 + idx;
      sparse_apply(q ? q[k] : k, k);
      for (const int64_t r : pat_rows) {
        if (pinv[r] >= 0) {
          tu_rows.push_back(pinv[r]);
          tu_vals.push_back(x[r]);
        } else {
          S[(size_t)idx * m + rmap[r]] = x[r];
        }
        x[r] = T(0);
      }
      tu_off[idx + 1] = (int64_t)tu_rows.size();
    }
    int info = 0;
    std::vector<int> ipiv(m);
    call_getrf<T>((int)m, S, (int)m, ipiv.data(), &info);
    if (info != 0) {
      pop_free_raw(S, bytes, mapped);
      return false;
    }
    // factor row i <- original local row lp[i] after the swap sequence
    std::vector<int64_t> lp(m);
    std::iota(lp.begin(), lp.end(), 0);
    for (int64_t i = 0; i < m; ++i) std::swap(lp[i], lp[ipiv[i] - 1]);
    for (int64_t i = 0; i < m; ++i) {
      const int64_t r = local_rows[lp[i]];
      pinv[r] = k0 + i;
      perm_r[k0 + i] = r;
    }
    for (int64_t idx = 0; idx < m; ++idx) {
      const int64_t k = k0 + idx;
      for (int64_t t = tu_off[idx]; t < tu_off[idx + 1]; ++t) {
        Urow.push_back(tu_rows[t]);
        Uval.push_back(tu_vals[t]);
      }
      const T* Scol = S + (size_t)idx * m;
      for (int64_t j = 0; j < idx; ++j)
        if (Scol[j] != T(0)) {
          Urow.push_back(k0 + j);
          Uval.push_back(Scol[j]);
        }
      Urow.push_back(k);
      Uval.push_back(Scol[idx]);
      for (int64_t j = idx + 1; j < m; ++j)
        if (Scol[j] != T(0)) {
          Lrow.push_back(local_rows[lp[j]]);
          Lval.push_back(Scol[j]);
        }
      Lcp[k + 1] = (int64_t)Lrow.size();
      Up[k + 1] = (int64_t)Urow.size();
    }
    pop_free_raw(S, bytes, mapped);
    return true;
  };

  int64_t dens_run = 0;
  const bool dense_enabled = dense_cap > 0 && g_blas.ok();

  for (int64_t k = 0; k < n; ++k) {
    if (dense_enabled && dens_run >= 8 && n - k >= 96 && n - k <= dense_cap) {
      if (dense_tail(k)) break;
      // singular tail: redo scalar; stamp arrays were consumed for these
      // k values, so reset them
      std::fill(in_pattern.begin(), in_pattern.end(), (int64_t)-1);
      std::fill(flag.begin(), flag.end(), (int64_t)-1);
      dens_run = INT64_MIN;  // one attempt only
    }
    const int64_t col = q ? q[k] : k;
    LU_TIC;
    sparse_apply(col, k);
    LU_TOC(numeric);
    // ---- pivot -----------------------------------------------------------
    int64_t best_r = -1;
    double best_a = 0.0;
    const int64_t diag_r = col;
    for (const int64_t r : pat_rows) {
      if (pinv[r] < 0) {
        const double a_ = mag(x[r]);
        if (a_ > best_a) {
          best_a = a_;
          best_r = r;
        }
      }
    }
    T pivot_val;
    if (best_r < 0 || best_a == 0.0) {
      singular.push_back(k);
      if (best_r < 0) {
        for (int64_t r = 0; r < n; ++r)
          if (pinv[r] < 0) {
            best_r = r;
            break;
          }
      }
      pivot_val = T(0);
    } else {
      if (pinv[diag_r] < 0 && in_pattern[diag_r] == k &&
          mag(x[diag_r]) >= tol * best_a)
        best_r = diag_r;  // threshold diagonal preference
      pivot_val = x[best_r];
    }
    pinv[best_r] = k;
    perm_r[k] = best_r;

    // ---- split x into U column and L column ------------------------------
    for (const int64_t r : pat_rows) {
      const int64_t pr = pinv[r];
      if (r == best_r) continue;
      if (pr >= 0 && pr < k) {
        Urow.push_back(pr);
        Uval.push_back(x[r]);
      } else if (pr < 0) {
        // keep exact zeros: symmetric pruning relies on L(:,k) containing
        // EVERY non-pivotal pattern row (dropping a cancelled entry would
        // break the pruned-front reachability of later columns)
        const T xv = x[r];
        Lval.push_back(pivot_val != T(0)
                           ? xv / pivot_val
                           : (xv != T(0) ? inf_fill(xv) : T(0)));
        Lrow.push_back(r);
      }
      x[r] = T(0);
    }
    x[best_r] = T(0);
    Urow.push_back(k);
    Uval.push_back(pivot_val);
    Lcp[k + 1] = (int64_t)Lrow.size();
    Up[k + 1] = (int64_t)Urow.size();

    LU_TOC(split);
    // ---- symmetric pruning ----------------------------------------------
    // For each j with U(j,k) != 0: if pivrow_k appears in L(:,j), partition
    // the column so pivotal rows come first; future DFS stops there.
    for (int64_t p = Up[k]; p < Up[k + 1] - 1; ++p) {  // skip the pivot entry
      const int64_t j = Urow[p];
      if (plen[j] >= 0) continue;  // already pruned
      const int64_t lo = Lcp[j], hi = Lcp[j + 1];
#ifdef LU_PROFILE
      g_luprof.prune_scans += hi - lo;
#endif
      bool found = false;
      for (int64_t e = lo; e < hi; ++e)
        if (Lrow[e] == best_r) {
          found = true;
          break;
        }
      if (!found) continue;
      int64_t i = lo, jj = hi - 1;
      while (i <= jj) {
        if (pinv[Lrow[i]] >= 0) {
          ++i;
        } else {
          std::swap(Lrow[i], Lrow[jj]);
          std::swap(Lval[i], Lval[jj]);
          --jj;
        }
      }
      plen[j] = i - lo;
#ifdef LU_PROFILE
      g_luprof.prune_hits += 1;
#endif
    }
    LU_TOC(prune);

    // dense-tail trigger: sustained >= 1/D L-column density (default 1/8;
    // tunable via CSPARSE3_LU_DENSE_TRIGGER because the crossover between
    // scalar-sparse and dense-BLAS tails depends on the host's BLAS rate)
    if (dens_run >= 0) {
      static const int64_t D = [] {
        const char* e = std::getenv("CSPARSE3_LU_DENSE_TRIGGER");
        const long v = e ? std::strtol(e, nullptr, 10) : 0;
        return (int64_t)(v > 0 ? v : 8);
      }();
      const int64_t llen = Lcp[k + 1] - Lcp[k];
      if (D * llen >= n - k - 1)
        ++dens_run;
      else
        dens_run = 0;
    }
  }

  LU_TIC;
  // ---- export: canonical CSC (per-column row sort), L with unit diag ----
  auto* res = (LUResult*)std::malloc(sizeof(LUResult));
  res->n = n;
  res->nsing = (int64_t)singular.size();

  const int64_t lnz = n + (int64_t)Lrow.size();
  const int64_t unz = (int64_t)Urow.size();
  res->lnz = lnz;
  res->unz = unz;
  res->Lp = (int64_t*)std::malloc((n + 1) * sizeof(int64_t));
  res->Li = (int64_t*)std::malloc(std::max<int64_t>(lnz, 1) * sizeof(int64_t));
  auto* Lx = (T*)std::malloc(std::max<int64_t>(lnz, 1) * sizeof(T));
  res->Lx = Lx;
  res->Up = (int64_t*)std::malloc((n + 1) * sizeof(int64_t));
  res->Ui = (int64_t*)std::malloc(std::max<int64_t>(unz, 1) * sizeof(int64_t));
  auto* Ux = (T*)std::malloc(std::max<int64_t>(unz, 1) * sizeof(T));
  res->Ux = Ux;

  std::vector<std::pair<int64_t, T>> scratch;
  int64_t out = 0;
  for (int64_t k = 0; k < n; ++k) {
    res->Lp[k] = out;
    res->Li[out] = k;  // unit diagonal, smallest pivot-space row
    Lx[out++] = T(1);
    const int64_t lo = Lcp[k], hi = Lcp[k + 1];
    scratch.clear();
    for (int64_t e = lo; e < hi; ++e)
      scratch.emplace_back(pinv[Lrow[e]], Lval[e]);
    std::sort(scratch.begin(), scratch.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    for (const auto& pr : scratch) {
      res->Li[out] = pr.first;
      Lx[out++] = pr.second;
    }
  }
  res->Lp[n] = out;

  out = 0;
  for (int64_t k = 0; k < n; ++k) {
    res->Up[k] = out;
    const int64_t lo = Up[k], hi = Up[k + 1];
    scratch.clear();
    for (int64_t e = lo; e < hi; ++e) scratch.emplace_back(Urow[e], Uval[e]);
    std::sort(scratch.begin(), scratch.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    for (const auto& pr : scratch) {
      res->Ui[out] = pr.first;
      Ux[out++] = pr.second;
    }
  }
  res->Up[n] = out;

  res->perm_r = (int64_t*)std::malloc(n * sizeof(int64_t));
  std::memcpy(res->perm_r, perm_r.data(), n * sizeof(int64_t));
  res->sing =
      (int64_t*)std::malloc(std::max<int64_t>(res->nsing, 1) * sizeof(int64_t));
  if (res->nsing)
    std::memcpy(res->sing, singular.data(), res->nsing * sizeof(int64_t));
  LU_TOC(exp);
  return res;
}

}  // namespace

extern "C" {

LUResult* lu_factor_d(int64_t n, const int64_t* Ap, const int64_t* Ai,
                      const double* Ax, const int64_t* q, double tol,
                      int64_t dense_cap) {
  return lu_factor<double>(n, Ap, Ai, Ax, q, tol, dense_cap);
}

LUResult* lu_factor_z(int64_t n, const int64_t* Ap, const int64_t* Ai,
                      const void* Ax, const int64_t* q, double tol,
                      int64_t dense_cap) {
  return lu_factor<cplx>(n, Ap, Ai, (const cplx*)Ax, q, tol, dense_cap);
}

// Triplet -> canonical CSC assembly (sum duplicates).  Returns the unique
// count; caller passes output buffers of capacity nnz (worst case).
// Host twin of ops/construct.from_triplets.
int64_t coo_to_csc_d(int64_t m, int64_t n, int64_t nnz, const int64_t* rows,
                     const int64_t* cols, const double* vals, int64_t* out_p,
                     int64_t* out_i, double* out_x) {
  (void)m;
  std::vector<int64_t> order(nnz);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (cols[a] != cols[b]) return cols[a] < cols[b];
    return rows[a] < rows[b];
  });
  std::memset(out_p, 0, (n + 1) * sizeof(int64_t));
  int64_t u = -1;
  int64_t prev_r = -1, prev_c = -1;
  for (int64_t k = 0; k < nnz; ++k) {
    const int64_t o = order[k];
    if (rows[o] != prev_r || cols[o] != prev_c) {
      ++u;
      out_i[u] = rows[o];
      out_x[u] = vals[o];
      out_p[cols[o] + 1]++;
      prev_r = rows[o];
      prev_c = cols[o];
    } else {
      out_x[u] += vals[o];
    }
  }
  for (int64_t c = 0; c < n; ++c) out_p[c + 1] += out_p[c];
  return u + 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Approximate minimum degree ordering (quotient graph with element
// absorption and AMD-style approximate external degrees).  Replaces the
// Python greedy mindeg (linalg/ordering.py) for large n.  Operates on the
// symmetrized pattern of a square CSC; returns the elimination order.
// ---------------------------------------------------------------------------

namespace {

struct DegreeLists {
  // bucket lists indexed by degree, intrusive doubly linked
  std::vector<int64_t> head, nxt, prv, deg;
  int64_t mindeg = 0;
  explicit DegreeLists(int64_t n) : head(n + 1, -1), nxt(n, -1), prv(n, -1), deg(n, 0) {}
  void insert(int64_t v, int64_t d) {
    deg[v] = d;
    prv[v] = -1;
    nxt[v] = head[d];
    if (head[d] >= 0) prv[head[d]] = v;
    head[d] = v;
    if (d < mindeg) mindeg = d;
  }
  void remove(int64_t v) {
    if (prv[v] >= 0)
      nxt[prv[v]] = nxt[v];
    else
      head[deg[v]] = nxt[v];
    if (nxt[v] >= 0) prv[nxt[v]] = prv[v];
  }
  int64_t pop_min(int64_t n) {
    while (mindeg <= n && head[mindeg] < 0) ++mindeg;
    const int64_t v = head[mindeg];
    if (v >= 0) remove(v);
    return v;
  }
};

}  // namespace

extern "C" {

// Ap/Ai: CSC pattern of a square n x n matrix (values ignored).
// perm_out: length n, filled with the elimination order.
void amd_order(int64_t n, const int64_t* Ap, const int64_t* Ai,
               int64_t* perm_out) {
  // ---- symmetrize pattern (A + A^T, no self loops) -----------------------
  const int64_t nnz = Ap[n];
  std::vector<int64_t> cnt(n, 0);
  for (int64_t c = 0; c < n; ++c)
    for (int64_t p = Ap[c]; p < Ap[c + 1]; ++p) {
      const int64_t r = Ai[p];
      if (r != c) {
        cnt[r]++;
        cnt[c]++;
      }
    }
  std::vector<int64_t> ptr(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) ptr[i + 1] = ptr[i] + cnt[i];
  std::vector<int64_t> adj(ptr[n]);
  std::vector<int64_t> fill = ptr;
  for (int64_t c = 0; c < n; ++c)
    for (int64_t p = Ap[c]; p < Ap[c + 1]; ++p) {
      const int64_t r = Ai[p];
      if (r != c) {
        adj[fill[r]++] = c;
        adj[fill[c]++] = r;
      }
    }
  (void)nnz;

  // dedup each adjacency list
  std::vector<std::vector<int64_t>> var_adj(n), elem_adj(n), elem_vars(n);
  {
    std::vector<int64_t> stamp(n, -1);
    for (int64_t i = 0; i < n; ++i) {
      auto& v = var_adj[i];
      v.reserve(ptr[i + 1] - ptr[i]);
      for (int64_t p = ptr[i]; p < ptr[i + 1]; ++p) {
        const int64_t u = adj[p];
        if (stamp[u] != i) {
          stamp[u] = i;
          v.push_back(u);
        }
      }
    }
  }
  adj.clear();
  adj.shrink_to_fit();

  std::vector<char> alive(n, 1), elem_alive(n, 0);
  std::vector<int64_t> mark(n, -1), estamp(n, -1), w(n, 0);
  DegreeLists dl(n);
  for (int64_t i = 0; i < n; ++i) dl.insert(i, (int64_t)var_adj[i].size());

  std::vector<int64_t> Lp;
  Lp.reserve(n);

  for (int64_t k = 0; k < n; ++k) {
    const int64_t p = dl.pop_min(n);
    perm_out[k] = p;
    alive[p] = 0;

    // ---- build Lp = pattern of the new element ---------------------------
    Lp.clear();
    mark[p] = k;
    for (const int64_t v : var_adj[p])
      if (alive[v] && mark[v] != k) {
        mark[v] = k;
        Lp.push_back(v);
      }
    for (const int64_t e : elem_adj[p])
      if (elem_alive[e]) {
        for (const int64_t v : elem_vars[e])
          if (alive[v] && mark[v] != k) {
            mark[v] = k;
            Lp.push_back(v);
          }
        elem_alive[e] = 0;  // merged into p
        elem_vars[e].clear();
        elem_vars[e].shrink_to_fit();
      }
    var_adj[p].clear();
    var_adj[p].shrink_to_fit();
    elem_adj[p].clear();
    elem_adj[p].shrink_to_fit();
    elem_vars[p] = Lp;  // p becomes an element
    elem_alive[p] = 1;

    // ---- w[e] = |Le \ Lp| for elements touching Lp -----------------------
    for (const int64_t v : Lp)
      for (const int64_t e : elem_adj[v])
        if (elem_alive[e]) {
          if (estamp[e] != k) {
            estamp[e] = k;
            // |Le| counting only alive vars
            int64_t c = 0;
            for (const int64_t u : elem_vars[e]) c += alive[u];
            w[e] = c;
          }
          --w[e];
        }

    // ---- update each variable in Lp --------------------------------------
    const int64_t lp_sz = (int64_t)Lp.size();
    for (const int64_t v : Lp) {
      // prune var list: drop dead vars and members of Lp (now covered by p)
      auto& va = var_adj[v];
      size_t out = 0;
      for (const int64_t u : va)
        if (alive[u] && mark[u] != k) va[out++] = u;
      va.resize(out);

      // prune elements: absorb those with Le subset of Lp, approximate degree
      auto& ea = elem_adj[v];
      int64_t d = (int64_t)va.size() + (lp_sz - 1);
      size_t eo = 0;
      for (const int64_t e : ea)
        if (elem_alive[e]) {
          if (estamp[e] == k && w[e] <= 0) {
            elem_alive[e] = 0;  // absorbed into p
            elem_vars[e].clear();
            elem_vars[e].shrink_to_fit();
          } else {
            d += (estamp[e] == k) ? w[e] : (int64_t)elem_vars[e].size();
            ea[eo++] = e;
          }
        }
      ea.resize(eo);
      ea.push_back(p);
      if (d > n - k - 1) d = n - k - 1;
      if (d < 0) d = 0;
      dl.remove(v);
      dl.insert(v, d);
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Refactorization-plan builder (host symbolic for linalg/refactor.py).
// Computes, from a fixed L/U pattern: per-column wavefront levels, the
// elementary update triples (dst, srcL, srcU) counting-sorted by source
// level, the division pairs, and the A->X scatter map.
// ---------------------------------------------------------------------------

extern "C" {

struct RefactorBuild {
  int64_t total;   // update triples
  int64_t ndiv;    // division pairs (= L off-diag count)
  int64_t nlev;
  int64_t* upd_dst;
  int64_t* upd_L;
  int64_t* upd_U;
  int64_t* upd_lev;  // sorted ascending
  int64_t* div_dst;
  int64_t* div_piv;
  int64_t* div_lev;  // sorted ascending
  int64_t* a_dst;    // per A entry
};

void refactor_free(RefactorBuild* r) {
  if (!r) return;
  std::free(r->upd_dst);
  std::free(r->upd_L);
  std::free(r->upd_U);
  std::free(r->upd_lev);
  std::free(r->div_dst);
  std::free(r->div_piv);
  std::free(r->div_lev);
  std::free(r->a_dst);
  std::free(r);
}

RefactorBuild* refactor_build(int64_t n, const int64_t* Lp, const int64_t* Li,
                              const int64_t* Up, const int64_t* Ui,
                              int64_t a_nnz, const int64_t* Ap,
                              const int64_t* Ai, const int64_t* perm_r,
                              const int64_t* q) {
  const int64_t lnz = Lp[n];

  auto posL = [&](int64_t r, int64_t k) -> int64_t {
    const int64_t* lo = Li + Lp[k];
    const int64_t* hi = Li + Lp[k + 1];
    return (std::lower_bound(lo, hi, r) - Li);
  };
  auto posU = [&](int64_t r, int64_t k) -> int64_t {
    const int64_t* lo = Ui + Up[k];
    const int64_t* hi = Ui + Up[k + 1];
    return lnz + (std::lower_bound(lo, hi, r) - Ui);
  };

  // U off-diag grouped by ROW (source column of updates)
  std::vector<int64_t> urow_cnt(n + 1, 0);
  for (int64_t k = 0; k < n; ++k)
    for (int64_t p = Up[k]; p < Up[k + 1]; ++p)
      if (Ui[p] != k) urow_cnt[Ui[p] + 1]++;
  std::vector<int64_t> urow_ptr(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) urow_ptr[i + 1] = urow_ptr[i] + urow_cnt[i + 1];
  std::vector<int64_t> urow_col(urow_ptr[n]), urow_pos(urow_ptr[n]);
  {
    std::vector<int64_t> fill = urow_ptr;
    for (int64_t k = 0; k < n; ++k)
      for (int64_t p = Up[k]; p < Up[k + 1]; ++p)
        if (Ui[p] != k) {
          const int64_t j = Ui[p];
          urow_col[fill[j]] = k;
          urow_pos[fill[j]] = lnz + p;
          fill[j]++;
        }
  }

  // levels: single ascending pass (all edges go low -> high)
  std::vector<int64_t> lev(n, 0);
  for (int64_t j = 0; j < n; ++j) {
    for (int64_t p = Up[j]; p < Up[j + 1]; ++p)  // U(i, j), i < j
      if (Ui[p] != j && lev[Ui[p]] + 1 > lev[j]) lev[j] = lev[Ui[p]] + 1;
    for (int64_t p = Lp[j]; p < Lp[j + 1]; ++p)  // L(r, j), r > j
      if (Li[p] != j && lev[j] + 1 > lev[Li[p]]) lev[Li[p]] = lev[j] + 1;
  }
  int64_t nlev = 1;
  for (int64_t j = 0; j < n; ++j) nlev = std::max(nlev, lev[j] + 1);

  // total update triples
  int64_t total = 0;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t cu = urow_ptr[j + 1] - urow_ptr[j];
    const int64_t cl = Lp[j + 1] - Lp[j] - 1;  // off-diag count
    total += cu * cl;
  }

  auto* res = (RefactorBuild*)std::malloc(sizeof(RefactorBuild));
  res->total = total;
  res->nlev = nlev;
  res->upd_dst = (int64_t*)std::malloc(std::max<int64_t>(total, 1) * 8);
  res->upd_L = (int64_t*)std::malloc(std::max<int64_t>(total, 1) * 8);
  res->upd_U = (int64_t*)std::malloc(std::max<int64_t>(total, 1) * 8);
  res->upd_lev = (int64_t*)std::malloc(std::max<int64_t>(total, 1) * 8);

  // counting sort by level: offsets
  std::vector<int64_t> lev_cnt(nlev + 1, 0);
  for (int64_t j = 0; j < n; ++j) {
    const int64_t cu = urow_ptr[j + 1] - urow_ptr[j];
    const int64_t cl = Lp[j + 1] - Lp[j] - 1;
    lev_cnt[lev[j] + 1] += cu * cl;
  }
  for (int64_t l = 0; l < nlev; ++l) lev_cnt[l + 1] += lev_cnt[l];
  std::vector<int64_t> lev_fill(lev_cnt.begin(), lev_cnt.end() - 1);

  for (int64_t j = 0; j < n; ++j) {
    const int64_t l = lev[j];
    for (int64_t up = urow_ptr[j]; up < urow_ptr[j + 1]; ++up) {
      const int64_t k = urow_col[up];
      const int64_t srcU = urow_pos[up];
      for (int64_t p = Lp[j]; p < Lp[j + 1]; ++p) {
        const int64_t r = Li[p];
        if (r == j) continue;
        int64_t dst;
        if (r > k)
          dst = posL(r, k);
        else
          dst = posU(r, k);  // includes r == k (pivot cell)
        const int64_t t = lev_fill[l]++;
        res->upd_dst[t] = dst;
        res->upd_L[t] = p;
        res->upd_U[t] = srcU;
        res->upd_lev[t] = l;
      }
    }
  }

  // divisions: L off-diag cells of column k / pivot U(k,k); sort by level
  const int64_t ndiv = lnz - n;
  res->ndiv = ndiv;
  res->div_dst = (int64_t*)std::malloc(std::max<int64_t>(ndiv, 1) * 8);
  res->div_piv = (int64_t*)std::malloc(std::max<int64_t>(ndiv, 1) * 8);
  res->div_lev = (int64_t*)std::malloc(std::max<int64_t>(ndiv, 1) * 8);
  std::vector<int64_t> dcnt(nlev + 1, 0);
  for (int64_t k = 0; k < n; ++k)
    dcnt[lev[k] + 1] += Lp[k + 1] - Lp[k] - 1;
  for (int64_t l = 0; l < nlev; ++l) dcnt[l + 1] += dcnt[l];
  std::vector<int64_t> dfill(dcnt.begin(), dcnt.end() - 1);
  for (int64_t k = 0; k < n; ++k) {
    const int64_t piv = posU(k, k);
    const int64_t l = lev[k];
    for (int64_t p = Lp[k]; p < Lp[k + 1]; ++p)
      if (Li[p] != k) {
        const int64_t t = dfill[l]++;
        res->div_dst[t] = p;
        res->div_piv[t] = piv;
        res->div_lev[t] = l;
      }
  }

  // A -> X scatter map
  std::vector<int64_t> pinv(n), qinv(n);
  for (int64_t k = 0; k < n; ++k) {
    pinv[perm_r[k]] = k;
    qinv[q[k]] = k;
  }
  res->a_dst = (int64_t*)std::malloc(std::max<int64_t>(a_nnz, 1) * 8);
  {
    int64_t t = 0;
    for (int64_t c = 0; c < n; ++c) {
      const int64_t k = qinv[c];
      for (int64_t p = Ap[c]; p < Ap[c + 1]; ++p, ++t) {
        const int64_t pr = pinv[Ai[p]];
        res->a_dst[t] = (pr <= k) ? posU(pr, k) : posL(pr, k);
      }
    }
  }
  return res;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Two-phase CSC SpGEMM (Gustavson), real and complex.  Mirrors the
// reference's csc_matmat_pass1/pass2 delegation (src/sparsetools/csc.h:116)
// but emits canonical (row-sorted, duplicate-free) columns directly.
// ---------------------------------------------------------------------------

namespace {

// Columns of C are independent in Gustavson SpGEMM, so both passes
// parallelize across column ranges with per-thread SPA workspaces (the
// reference's kernels are explicitly single-threaded, SURVEY §2.4;
// scipy's C++ is too — this is where the host path beats both).
// Ranges are balanced by per-column FLOP counts, not column counts.

inline int spgemm_nthreads(int64_t flops) {
  if (flops < 1 << 18) return 1;  // thread spawn ~50us; skip tiny products
  unsigned hw = std::thread::hardware_concurrency();
  int t = (int)(hw ? hw : 1);
  return t > 8 ? 8 : t;
}

// Total multiply-add count, array-free: sum over B entries k of
// nnz(A(:,k)).  Cheap O(nnzB) scan used to pick the thread count
// WITHOUT building the O(nB) cumulative array (that array is only
// needed when we actually split, and on the sandboxed host fresh-page
// allocation costs dominate small products).
template <typename I>
inline int64_t spgemm_flops(int64_t nB, const I* Ap, const I* Bp,
                            const I* Bi) {
  int64_t total = 0;
  const int64_t nnzB = Bp[nB];
  for (int64_t pb = 0; pb < nnzB; ++pb) {
    const int64_t k = Bi[pb];
    total += Ap[k + 1] - Ap[k];
  }
  return total;
}

// Fills an nth+1 column-boundary split with ~equal flops per chunk.
template <typename I>
void spgemm_splits(int64_t nB, const I* Ap, const I* Bp, const I* Bi,
                   int nth, std::vector<int64_t>& bounds) {
  std::vector<int64_t> cum(nB + 1, 0);
  for (int64_t j = 0; j < nB; ++j) {
    int64_t f = 0;
    for (int64_t pb = Bp[j]; pb < Bp[j + 1]; ++pb) {
      const int64_t k = Bi[pb];
      f += Ap[k + 1] - Ap[k];
    }
    cum[j + 1] = cum[j] + f;
  }
  const int64_t total = cum[nB];
  bounds.assign(nth + 1, nB);
  bounds[0] = 0;
  for (int t = 1; t < nth; ++t) {
    const int64_t want = total * t / nth;
    bounds[t] = std::lower_bound(cum.begin(), cum.end(), want) - cum.begin();
    if (bounds[t] > nB) bounds[t] = nB;
    if (bounds[t] < bounds[t - 1]) bounds[t] = bounds[t - 1];
  }
}

// Persistent per-thread SPA workspaces: repeated small products reuse
// warm pages instead of paying the sandbox's fresh-page fault cliff on
// every call (spawned worker threads get fresh ones, but those only
// exist on products big enough to amortize them).
inline std::vector<int64_t>& tls_spa_mask_store() {
  static thread_local std::vector<int64_t> v;
  return v;
}

inline std::vector<int64_t>& tls_spa_mask(int64_t m) {
  std::vector<int64_t>& v = tls_spa_mask_store();
  if ((int64_t)v.size() < m) v.resize(m);  // value-init 0; epochs start at 1
  return v;
}

// Monotone per-thread column tag: lets the persistent mask skip even its
// O(m) reset — stale tags can never equal a fresh one.
inline int64_t& tls_spa_epoch() {
  static thread_local int64_t e = 0;
  return e;
}

template <typename T>
inline std::vector<T>& tls_spa_acc_store() {
  static thread_local std::vector<T> v;
  return v;
}

template <typename T>
inline std::vector<T>& tls_spa_acc(int64_t m) {
  std::vector<T>& v = tls_spa_acc_store<T>();
  if ((int64_t)v.size() < m) v.resize(m);
  return v;
}

// Persistence cap: one call on a huge matrix must not pin its workspaces
// for the thread's lifetime.  Regrown vectors value-init to 0, which can
// never equal a future (monotone, >= 1) epoch tag.
constexpr int64_t kTlsKeep = int64_t(1) << 22;  // 4M entries

template <typename V>
inline void tls_release_if_large(V& v) {
  if ((int64_t)v.capacity() > kTlsKeep) {
    V().swap(v);
  }
}

inline void tls_spa_trim() {
  tls_release_if_large(tls_spa_mask_store());
  tls_release_if_large(tls_spa_acc_store<double>());
  tls_release_if_large(tls_spa_acc_store<float>());
  tls_release_if_large(tls_spa_acc_store<cplx>());
}

template <typename I>
int64_t spgemm_pass1(int64_t m, const I* Ap, const I* Ai,
                     int64_t nB, const I* Bp, const I* Bi,
                     I* Cp) {
  const int64_t imax = (int64_t)std::numeric_limits<I>::max();
  const int64_t flops = spgemm_flops<I>(nB, Ap, Bp, Bi);
  const int nth = spgemm_nthreads(flops);
  std::vector<int64_t> bounds;
  if (nth > 1) spgemm_splits<I>(nB, Ap, Bp, Bi, nth, bounds);

  auto count_range = [&](int64_t j0, int64_t j1) {
    std::vector<int64_t>& mask = tls_spa_mask(m);
    int64_t& epoch = tls_spa_epoch();
    for (int64_t j = j0; j < j1; ++j) {
      const int64_t tag = ++epoch;
      int64_t cnt = 0;
      for (int64_t pb = Bp[j]; pb < Bp[j + 1]; ++pb) {
        const int64_t k = Bi[pb];
        for (int64_t pa = Ap[k]; pa < Ap[k + 1]; ++pa) {
          const int64_t r = Ai[pa];
          if (mask[r] != tag) {
            mask[r] = tag;
            ++cnt;
          }
        }
      }
      Cp[j + 1] = (I)cnt;  // per-column count; prefix-summed below
    }
  };
  if (nth == 1) {
    count_range(0, nB);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nth; ++t)
      ts.emplace_back(count_range, bounds[t], bounds[t + 1]);
    for (auto& th : ts) th.join();
  }
  // serial prefix sum with the reference's overflow guard (csr.h:591)
  int64_t nnz = 0;
  Cp[0] = 0;
  for (int64_t j = 0; j < nB; ++j) {
    nnz += (int64_t)Cp[j + 1];
    if (nnz > imax) return -1;
    Cp[j + 1] = (I)nnz;
  }
  return nnz;
}

template <typename I, typename T>
void spgemm_pass2(int64_t m, const I* Ap, const I* Ai,
                  const T* Ax, int64_t nB, const I* Bp,
                  const I* Bi, const T* Bx, const I* Cp,
                  I* Ci, T* Cx, bool sorted) {
  const int64_t flops = spgemm_flops<I>(nB, Ap, Bp, Bi);
  const int nth = spgemm_nthreads(flops);
  std::vector<int64_t> bounds;
  if (nth > 1) spgemm_splits<I>(nB, Ap, Bp, Bi, nth, bounds);

  auto numeric_range = [&](int64_t j0, int64_t j1) {
    std::vector<int64_t>& mask = tls_spa_mask(m);
    int64_t& epoch = tls_spa_epoch();
    // acc needs no init: every read is guarded by a same-column mask hit
    std::vector<T>& acc = tls_spa_acc<T>(m);
    for (int64_t j = j0; j < j1; ++j) {
      const int64_t tag = ++epoch;
      int64_t head = Cp[j];
      for (int64_t pb = Bp[j]; pb < Bp[j + 1]; ++pb) {
        const int64_t k = Bi[pb];
        const T bv = Bx[pb];
        for (int64_t pa = Ap[k]; pa < Ap[k + 1]; ++pa) {
          const int64_t r = Ai[pa];
          if (mask[r] != tag) {
            mask[r] = tag;
            Ci[head++] = (I)r;
            acc[r] = Ax[pa] * bv;
          } else {
            acc[r] += Ax[pa] * bv;
          }
        }
      }
      if (sorted) {
        // canonical emit: per-column sort + gather from the accumulator.
        // Power-grid columns are short (~2-20 rows): branch-light
        // insertion sort beats an introsort call there.
        const int64_t len = Cp[j + 1] - Cp[j];
        I* c = Ci + Cp[j];
        if (len <= 48) {
          for (int64_t a = 1; a < len; ++a) {
            const I v = c[a];
            int64_t b = a - 1;
            while (b >= 0 && c[b] > v) { c[b + 1] = c[b]; --b; }
            c[b + 1] = v;
          }
        } else {
          std::sort(c, c + len);
        }
        for (int64_t p = Cp[j]; p < Cp[j + 1]; ++p) Cx[p] = acc[Ci[p]];
      } else {
        // insertion-order emit; caller canonicalizes with ONE O(nnz)
        // count-scatter transpose (the reference leaves SpGEMM output
        // unsorted too, csr.h:609-670 linked-list emit)
        for (int64_t p = Cp[j]; p < Cp[j + 1]; ++p) Cx[p] = acc[Ci[p]];
      }
    }
  };
  if (nth == 1) {
    numeric_range(0, nB);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nth; ++t)
      ts.emplace_back(numeric_range, bounds[t], bounds[t + 1]);
    for (auto& th : ts) th.join();
  }
}

}  // namespace

extern "C" {

int64_t csc_spgemm_size(int64_t m, const int64_t* Ap, const int64_t* Ai,
                        int64_t nB, const int64_t* Bp, const int64_t* Bi,
                        int64_t* Cp) {
  const int64_t r = spgemm_pass1<int64_t>(m, Ap, Ai, nB, Bp, Bi, Cp);
  tls_spa_trim();
  return r;
}

void csc_spgemm_numeric_d(int64_t m, const int64_t* Ap, const int64_t* Ai,
                          const double* Ax, int64_t nB, const int64_t* Bp,
                          const int64_t* Bi, const double* Bx,
                          const int64_t* Cp, int64_t* Ci, double* Cx,
                          int sorted) {
  spgemm_pass2<int64_t, double>(m, Ap, Ai, Ax, nB, Bp, Bi, Bx, Cp, Ci, Cx,
                                sorted != 0);
  tls_spa_trim();
}

void csc_spgemm_numeric_z(int64_t m, const int64_t* Ap, const int64_t* Ai,
                          const void* Ax, int64_t nB, const int64_t* Bp,
                          const int64_t* Bi, const void* Bx,
                          const int64_t* Cp, int64_t* Ci, void* Cx,
                          int sorted) {
  spgemm_pass2<int64_t, cplx>(m, Ap, Ai, (const cplx*)Ax, nB, Bp, Bi,
                              (const cplx*)Bx, Cp, Ci, (cplx*)Cx,
                              sorted != 0);
  tls_spa_trim();
}

int64_t csc_spgemm_size32(int64_t m, const int32_t* Ap, const int32_t* Ai,
                          int64_t nB, const int32_t* Bp, const int32_t* Bi,
                          int32_t* Cp) {
  const int64_t r = spgemm_pass1<int32_t>(m, Ap, Ai, nB, Bp, Bi, Cp);
  tls_spa_trim();
  return r;
}

void csc_spgemm_numeric_d32(int64_t m, const int32_t* Ap, const int32_t* Ai,
                            const double* Ax, int64_t nB, const int32_t* Bp,
                            const int32_t* Bi, const double* Bx,
                            const int32_t* Cp, int32_t* Ci, double* Cx,
                            int sorted) {
  spgemm_pass2<int32_t, double>(m, Ap, Ai, Ax, nB, Bp, Bi, Bx, Cp, Ci, Cx,
                                sorted != 0);
  tls_spa_trim();
}

void csc_spgemm_numeric_z32(int64_t m, const int32_t* Ap, const int32_t* Ai,
                            const void* Ax, int64_t nB, const int32_t* Bp,
                            const int32_t* Bi, const void* Bx,
                            const int32_t* Cp, int32_t* Ci, void* Cx,
                            int sorted) {
  spgemm_pass2<int32_t, cplx>(m, Ap, Ai, (const cplx*)Ax, nB, Bp, Bi,
                              (const cplx*)Bx, Cp, Ci, (cplx*)Cx,
                              sorted != 0);
  tls_spa_trim();
}

// float32 twins: grid workloads store f32 values (SplitBandPoints etc.);
// converting to f64 around every host product costs more than the product
void csc_spgemm_numeric_s(int64_t m, const int64_t* Ap, const int64_t* Ai,
                          const float* Ax, int64_t nB, const int64_t* Bp,
                          const int64_t* Bi, const float* Bx,
                          const int64_t* Cp, int64_t* Ci, float* Cx,
                          int sorted) {
  spgemm_pass2<int64_t, float>(m, Ap, Ai, Ax, nB, Bp, Bi, Bx, Cp, Ci, Cx,
                               sorted != 0);
  tls_spa_trim();
}

void csc_spgemm_numeric_s32(int64_t m, const int32_t* Ap, const int32_t* Ai,
                            const float* Ax, int64_t nB, const int32_t* Bp,
                            const int32_t* Bi, const float* Bx,
                            const int32_t* Cp, int32_t* Ci, float* Cx,
                            int sorted) {
  spgemm_pass2<int32_t, float>(m, Ap, Ai, Ax, nB, Bp, Bi, Bx, Cp, Ci, Cx,
                               sorted != 0);
  tls_spa_trim();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused symmetric product C = A @ A^T (the reference's flagship flow
// `A = C * C.t()`, src/test/test3_lil_matrix.py:29-48).  One call pair,
// no Python-side transpose, and only the LOWER-inclusive half (r >= j) is
// Gustavson-accumulated — the strict upper half is mirrored by a
// column-major scan of the finished lower entries, which lands each
// output column's upper block pre-sorted (j ascends during the scan) and
// directly ahead of its sorted lower block, so C is canonical with half
// the accumulate+sort work of the general kernel.
// ---------------------------------------------------------------------------

namespace {

// A^T pattern + source positions + per-column upper counts, cached
// between the size and numeric calls (thread_local: each Python thread
// gets its own; the numeric call validates the token and rebuilds on
// mismatch).
struct GramCtx {
  int64_t m = -1, k = -1, nnz = -1;
  std::vector<int64_t> Tp, Ti;      // A^T pattern (CSR of A)
  std::vector<int64_t> Tpos;        // source position in A of each T entry
  std::vector<int64_t> up_cnt;      // strict-upper entries per output col
  std::vector<int64_t> bounds;      // column split shared by both passes
  int nth = 1;
};

inline GramCtx& tls_gram_ctx() {
  static thread_local GramCtx c;
  return c;
}

// Release a huge cached context after its numeric pass: one gram call on
// a 100M-nnz matrix must not pin O(nnz) arrays for the thread's lifetime.
inline void gram_trim(GramCtx& g) {
  if (g.nnz > kTlsKeep || (int64_t)g.Tp.size() > kTlsKeep) {
    g.m = g.k = g.nnz = -1;
    std::vector<int64_t>().swap(g.Tp);
    std::vector<int64_t>().swap(g.Ti);
    std::vector<int64_t>().swap(g.Tpos);
    std::vector<int64_t>().swap(g.up_cnt);
    std::vector<int64_t>().swap(g.bounds);
  }
}

template <typename I>
void gram_build_T(int64_t m, int64_t k, const I* Ap, const I* Ai,
                  GramCtx& g) {
  const int64_t nnz = Ap[k];
  g.Tp.assign(m + 1, 0);
  g.Ti.resize(nnz);
  g.Tpos.resize(nnz);
  for (int64_t p = 0; p < nnz; ++p) g.Tp[Ai[p] + 1]++;
  for (int64_t r = 0; r < m; ++r) g.Tp[r + 1] += g.Tp[r];
  std::vector<int64_t> fill(g.Tp.begin(), g.Tp.end() - 1);
  for (int64_t c = 0; c < k; ++c)
    for (int64_t p = Ap[c]; p < Ap[c + 1]; ++p) {
      const int64_t t = fill[Ai[p]]++;
      g.Ti[t] = c;
      g.Tpos[t] = p;
    }
  g.m = m;
  g.k = k;
  g.nnz = nnz;
}

// Balance output columns by Gustavson flops: column j of C costs
// sum over T-row-j entries kk of nnz(A(:,kk)).
template <typename I>
void gram_splits(int64_t m, const I* Ap, GramCtx& g) {
  int64_t total = 0;
  const int64_t nnz = g.nnz;
  for (int64_t p = 0; p < nnz; ++p) {
    const int64_t kk = g.Ti[p];
    total += Ap[kk + 1] - Ap[kk];
  }
  g.nth = spgemm_nthreads(total);
  g.bounds.assign(g.nth + 1, 0);
  if (g.nth == 1) {
    g.bounds[g.nth] = m;
    return;
  }
  std::vector<int64_t> cum(m + 1, 0);
  for (int64_t j = 0; j < m; ++j) {
    int64_t f = 0;
    for (int64_t p = g.Tp[j]; p < g.Tp[j + 1]; ++p) {
      const int64_t kk = g.Ti[p];
      f += Ap[kk + 1] - Ap[kk];
    }
    cum[j + 1] = cum[j] + f;
  }
  g.bounds[g.nth] = m;
  for (int t = 1; t < g.nth; ++t) {
    const int64_t want = total * t / g.nth;
    g.bounds[t] = std::lower_bound(cum.begin(), cum.end(), want) -
                  cum.begin() - 1;
    if (g.bounds[t] < g.bounds[t - 1]) g.bounds[t] = g.bounds[t - 1];
    if (g.bounds[t] > m) g.bounds[t] = m;
  }
}

// pass1: per-column lower-inclusive counts (into Cp[j+1] slots),
// strict-upper mirror counts into up_cnt; serial prefix sum with the
// overflow guard; returns total nnz (or -1 on index overflow).
// Threaded over the flop-balanced column split; each worker accumulates
// its own up-count array, reduced after the join.
template <typename I>
int64_t gram_pass1(int64_t m, const I* Ap, const I* Ai, GramCtx& g,
                   I* Cp) {
  const int64_t imax = (int64_t)std::numeric_limits<I>::max();
  g.up_cnt.assign(m, 0);
  std::vector<std::vector<int64_t>> up_parts;

  auto count_range = [&](int64_t j0, int64_t j1, int64_t* up) {
    std::vector<int64_t>& mask = tls_spa_mask(m);
    int64_t& epoch = tls_spa_epoch();
    for (int64_t j = j0; j < j1; ++j) {
      const int64_t tag = ++epoch;
      int64_t cnt = 0;
      for (int64_t pb = g.Tp[j]; pb < g.Tp[j + 1]; ++pb) {
        const int64_t kk = g.Ti[pb];
        for (int64_t pa = Ap[kk]; pa < Ap[kk + 1]; ++pa) {
          const int64_t r = Ai[pa];
          if (r < j) continue;  // lower-inclusive only
          if (mask[r] != tag) {
            mask[r] = tag;
            ++cnt;
            if (r > j) up[r]++;
          }
        }
      }
      Cp[j + 1] = (I)cnt;  // per-column lower count; prefix-summed below
    }
  };

  if (g.nth == 1) {
    count_range(0, m, g.up_cnt.data());
  } else {
    up_parts.assign(g.nth, {});
    std::vector<std::thread> ts;
    for (int t = 0; t < g.nth; ++t) {
      up_parts[t].assign(m, 0);
      ts.emplace_back(count_range, g.bounds[t], g.bounds[t + 1],
                      up_parts[t].data());
    }
    for (auto& th : ts) th.join();
    for (int t = 0; t < g.nth; ++t)
      for (int64_t r = 0; r < m; ++r) g.up_cnt[r] += up_parts[t][r];
  }

  int64_t nnz = 0;
  Cp[0] = 0;
  for (int64_t j = 0; j < m; ++j) {
    nnz += (int64_t)Cp[j + 1] + g.up_cnt[j];
    if (nnz > imax) return -1;
    Cp[j + 1] = (I)nnz;
  }
  return nnz;
}

template <typename I, typename T>
void gram_pass2(int64_t m, const I* Ap, const I* Ai, const T* Ax,
                GramCtx& g, const I* Cp, I* Ci, T* Cx) {
  auto numeric_range = [&](int64_t j0, int64_t j1) {
    std::vector<int64_t>& mask = tls_spa_mask(m);
    int64_t& epoch = tls_spa_epoch();
    std::vector<T>& acc = tls_spa_acc<T>(m);
    for (int64_t j = j0; j < j1; ++j) {
      const int64_t tag = ++epoch;
      // lower block of column j starts after its (mirrored) upper block
      const int64_t lo = Cp[j] + g.up_cnt[j];
      int64_t head = lo;
      for (int64_t pb = g.Tp[j]; pb < g.Tp[j + 1]; ++pb) {
        const int64_t kk = g.Ti[pb];
        const T bv = Ax[g.Tpos[pb]];  // A^T[kk, j] == A[j, kk]
        for (int64_t pa = Ap[kk]; pa < Ap[kk + 1]; ++pa) {
          const int64_t r = Ai[pa];
          if (r < j) continue;
          if (mask[r] != tag) {
            mask[r] = tag;
            Ci[head++] = (I)r;
            acc[r] = Ax[pa] * bv;
          } else {
            acc[r] += Ax[pa] * bv;
          }
        }
      }
      const int64_t len = head - lo;
      I* c = Ci + lo;
      if (len <= 48) {
        for (int64_t a = 1; a < len; ++a) {
          const I v = c[a];
          int64_t b = a - 1;
          while (b >= 0 && c[b] > v) { c[b + 1] = c[b]; --b; }
          c[b + 1] = v;
        }
      } else {
        std::sort(c, c + len);
      }
      for (int64_t p = lo; p < lo + len; ++p) Cx[p] = acc[Ci[p]];
    }
  };

  if (g.nth == 1) {
    numeric_range(0, m);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < g.nth; ++t)
      ts.emplace_back(numeric_range, g.bounds[t], g.bounds[t + 1]);
    for (auto& th : ts) th.join();
  }

  // mirror: scan finished lower entries column-major; each strict-lower
  // (r, j) lands at the upper cursor of column r with j ascending -> the
  // upper blocks come out sorted and ahead of their lower blocks.
  // Threaded by DESTINATION column range: every worker scans the whole
  // lower set (sequential reads, shared in cache) but writes only its
  // own range — write sets are disjoint, no ordering is lost because
  // each worker still sees j ascending.
  auto mirror_range = [&](int64_t r0, int64_t r1) {
    std::vector<int64_t> fill(r1 - r0);
    for (int64_t r = r0; r < r1; ++r) fill[r - r0] = Cp[r];
    for (int64_t j = 0; j < m; ++j) {
      for (int64_t p = Cp[j] + g.up_cnt[j]; p < Cp[j + 1]; ++p) {
        const int64_t r = Ci[p];
        if (r < r0 || r >= r1 || r == j) continue;
        const int64_t t = fill[r - r0]++;
        Ci[t] = (I)j;
        Cx[t] = Cx[p];
      }
    }
  };
  if (g.nth == 1) {
    mirror_range(0, m);
  } else {
    // balance by mirrored-entry count (up_cnt prefix)
    int64_t total_up = 0;
    for (int64_t r = 0; r < m; ++r) total_up += g.up_cnt[r];
    std::vector<int64_t> rb(g.nth + 1, 0);
    rb[g.nth] = m;
    int64_t acc = 0, t = 1;
    for (int64_t r = 0; r < m && t < g.nth; ++r) {
      acc += g.up_cnt[r];
      while (t < g.nth && acc >= total_up * t / g.nth) rb[t++] = r + 1;
    }
    for (int q = 1; q < g.nth; ++q)
      if (rb[q] < rb[q - 1]) rb[q] = rb[q - 1];
    std::vector<std::thread> ts;
    for (int q = 0; q < g.nth; ++q)
      ts.emplace_back(mirror_range, rb[q], rb[q + 1]);
    for (auto& th : ts) th.join();
  }
}

}  // namespace

extern "C" {

int64_t csc_gram_size(int64_t m, int64_t k, const int64_t* Ap,
                      const int64_t* Ai, int64_t* Cp) {
  GramCtx& g = tls_gram_ctx();
  gram_build_T<int64_t>(m, k, Ap, Ai, g);
  gram_splits<int64_t>(m, Ap, g);
  return gram_pass1<int64_t>(m, Ap, Ai, g, Cp);
}

int64_t csc_gram_size32(int64_t m, int64_t k, const int32_t* Ap,
                        const int32_t* Ai, int32_t* Cp) {
  GramCtx& g = tls_gram_ctx();
  gram_build_T<int32_t>(m, k, Ap, Ai, g);
  gram_splits<int32_t>(m, Ap, g);
  return gram_pass1<int32_t>(m, Ap, Ai, g, Cp);
}

#define GRAM_NUMERIC(name, IT, VT, CAST)                                   \
  int name(int64_t m, int64_t k, const IT* Ap, const IT* Ai,               \
           const void* Ax, const IT* Cp, IT* Ci, void* Cx) {               \
    GramCtx& g = tls_gram_ctx();                                           \
    if (g.m != m || g.k != k || g.nnz != (int64_t)Ap[k]) return 0;         \
    gram_pass2<IT, VT>(m, Ap, Ai, (const VT*)Ax, g, Cp, Ci, (VT*)Cx);      \
    gram_trim(g);                                                          \
    tls_spa_trim();                                                        \
    return 1;                                                              \
  }

GRAM_NUMERIC(csc_gram_numeric_d, int64_t, double, )
GRAM_NUMERIC(csc_gram_numeric_s, int64_t, float, )
GRAM_NUMERIC(csc_gram_numeric_z, int64_t, cplx, )
GRAM_NUMERIC(csc_gram_numeric_d32, int32_t, double, )
GRAM_NUMERIC(csc_gram_numeric_s32, int32_t, float, )
GRAM_NUMERIC(csc_gram_numeric_z32, int32_t, cplx, )
#undef GRAM_NUMERIC

// Export the symbolic context so callers can hold it and re-evaluate
// values later (gram_revalue below): copies T pattern + up_cnt out of
// the thread-local ctx right after a size pass.
int64_t csc_gram_symbolic_take(int64_t* Tp, int64_t* Ti, int64_t* Tpos,
                               int64_t* up_cnt) {
  GramCtx& g = tls_gram_ctx();
  if (g.m < 0) return -1;
  std::memcpy(Tp, g.Tp.data(), g.Tp.size() * sizeof(int64_t));
  std::memcpy(Ti, g.Ti.data(), g.Ti.size() * sizeof(int64_t));
  std::memcpy(Tpos, g.Tpos.data(), g.Tpos.size() * sizeof(int64_t));
  std::memcpy(up_cnt, g.up_cnt.data(), g.up_cnt.size() * sizeof(int64_t));
  return g.nnz;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// gram re-evaluation: numeric-only pass over a CACHED symbolic pattern
// (the SpGEMM analogue of KLU refactorization — same pattern, new values).
// No mask-driven pattern discovery, no per-column sort, no Ci writes:
// accumulate into the SPA, gather by the known sorted Ci, mirror values.
// ---------------------------------------------------------------------------

namespace {

template <typename I, typename T>
void gram_revalue_impl(int64_t m, const I* Ap, const I* Ai, const T* Ax,
                       const int64_t* Tp, const int64_t* Ti,
                       const int64_t* Tpos, const int64_t* up_cnt,
                       const I* Cp, const I* Ci, T* Cx) {
  int64_t flops = 0;
  const int64_t nnzT = Tp[m];
  for (int64_t p = 0; p < nnzT; ++p) {
    const int64_t kk = Ti[p];
    flops += Ap[kk + 1] - Ap[kk];
  }
  const int nth = spgemm_nthreads(flops);

  auto value_range = [&](int64_t j0, int64_t j1) {
    std::vector<int64_t>& mask = tls_spa_mask(m);
    int64_t& epoch = tls_spa_epoch();
    std::vector<T>& acc = tls_spa_acc<T>(m);
    for (int64_t j = j0; j < j1; ++j) {
      const int64_t tag = ++epoch;
      for (int64_t pb = Tp[j]; pb < Tp[j + 1]; ++pb) {
        const int64_t kk = Ti[pb];
        const T bv = Ax[Tpos[pb]];
        for (int64_t pa = Ap[kk]; pa < Ap[kk + 1]; ++pa) {
          const int64_t r = Ai[pa];
          if (r < j) continue;
          if (mask[r] != tag) {
            mask[r] = tag;
            acc[r] = Ax[pa] * bv;
          } else {
            acc[r] += Ax[pa] * bv;
          }
        }
      }
      const int64_t lo = Cp[j] + up_cnt[j];
      for (int64_t p = lo; p < Cp[j + 1]; ++p) Cx[p] = acc[Ci[p]];
    }
  };

  if (nth == 1) {
    value_range(0, m);
  } else {
    // flop-balanced column split (same scheme as gram_splits)
    std::vector<int64_t> cum(m + 1, 0);
    for (int64_t j = 0; j < m; ++j) {
      int64_t f = 0;
      for (int64_t p = Tp[j]; p < Tp[j + 1]; ++p) {
        const int64_t kk = Ti[p];
        f += Ap[kk + 1] - Ap[kk];
      }
      cum[j + 1] = cum[j] + f;
    }
    std::vector<int64_t> bounds(nth + 1, 0);
    bounds[nth] = m;
    for (int t = 1; t < nth; ++t) {
      const int64_t want = flops * t / nth;
      bounds[t] = std::lower_bound(cum.begin(), cum.end(), want) -
                  cum.begin() - 1;
      if (bounds[t] < bounds[t - 1]) bounds[t] = bounds[t - 1];
      if (bounds[t] > m) bounds[t] = m;
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < nth; ++t)
      ts.emplace_back(value_range, bounds[t], bounds[t + 1]);
    for (auto& th : ts) th.join();
  }

  // values-only mirror (ordering identical to gram_pass2's mirror)
  std::vector<int64_t> fill(m);
  for (int64_t r = 0; r < m; ++r) fill[r] = Cp[r];
  for (int64_t j = 0; j < m; ++j) {
    for (int64_t p = Cp[j] + up_cnt[j]; p < Cp[j + 1]; ++p) {
      const int64_t r = Ci[p];
      if (r == j) continue;
      Cx[fill[r]++] = Cx[p];
    }
  }
  tls_spa_trim();
}

}  // namespace

extern "C" {

#define GRAM_REVALUE(name, IT, VT)                                         \
  void name(int64_t m, const IT* Ap, const IT* Ai, const void* Ax,         \
            const int64_t* Tp, const int64_t* Ti, const int64_t* Tpos,     \
            const int64_t* up_cnt, const IT* Cp, const IT* Ci, void* Cx) { \
    gram_revalue_impl<IT, VT>(m, Ap, Ai, (const VT*)Ax, Tp, Ti, Tpos,      \
                              up_cnt, Cp, Ci, (VT*)Cx);                    \
  }

GRAM_REVALUE(csc_gram_revalue_d, int64_t, double)
GRAM_REVALUE(csc_gram_revalue_s, int64_t, float)
GRAM_REVALUE(csc_gram_revalue_z, int64_t, cplx)
GRAM_REVALUE(csc_gram_revalue_d32, int32_t, double)
GRAM_REVALUE(csc_gram_revalue_s32, int32_t, float)
GRAM_REVALUE(csc_gram_revalue_z32, int32_t, cplx)
#undef GRAM_REVALUE

}  // extern "C"

// ---------------------------------------------------------------------------
// CSC transpose via count-cumsum-scatter (reference: csr_tocsc,
// src/sparsetools/csr.h:418-461) — O(nnz), no sort.
// ---------------------------------------------------------------------------

namespace {

template <typename I, typename T>
void transpose_impl(int64_t m, int64_t n, const I* Ap, const I* Ai,
                    const T* Ax, I* Tp, I* Ti, T* Tx) {
  const int64_t nnz = Ap[n];
  unsigned hw = std::thread::hardware_concurrency();
  int nth = (nnz >= (int64_t)1 << 19) ? (int)(hw ? hw : 1) : 1;
  if (nth > 8) nth = 8;
  if (nth <= 1) {
    std::memset(Tp, 0, (m + 1) * sizeof(I));
    for (int64_t p = 0; p < nnz; ++p) Tp[Ai[p] + 1]++;
    for (int64_t r = 0; r < m; ++r) Tp[r + 1] += Tp[r];
    std::vector<I> fill(Tp, Tp + m);
    for (int64_t c = 0; c < n; ++c)
      for (int64_t p = Ap[c]; p < Ap[c + 1]; ++p) {
        const int64_t t = fill[Ai[p]]++;
        Ti[t] = (I)c;
        Tx[t] = Ax[p];
      }
    return;
  }
  // Parallel two-phase histogram transpose.  Threads own contiguous
  // ascending source-column ranges (nnz-balanced via Ap, which is
  // already the cumulative); per-(thread,row) counts give each thread a
  // private write cursor per output column, so the scatter is race-free
  // AND preserves ascending-source-column order within each output
  // column — the canonicalization property the SpGEMM route relies on.
  std::vector<int64_t> cb(nth + 1, n);
  cb[0] = 0;
  for (int t = 1; t < nth; ++t) {
    const I want = (I)(nnz * t / nth);
    cb[t] = std::lower_bound(Ap, Ap + n + 1, want) - Ap;
    if (cb[t] > n) cb[t] = n;
    if (cb[t] < cb[t - 1]) cb[t] = cb[t - 1];
  }
  std::vector<std::vector<int64_t>> cnt(nth);
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nth; ++t)
      ts.emplace_back([&, t] {
        cnt[t].assign(m, 0);
        for (int64_t p = Ap[cb[t]]; p < Ap[cb[t + 1]]; ++p) cnt[t][Ai[p]]++;
      });
    for (auto& th : ts) th.join();
  }
  Tp[0] = 0;
  for (int64_t r = 0; r < m; ++r) {
    int64_t s = 0;
    for (int t = 0; t < nth; ++t) {
      const int64_t c = cnt[t][r];
      cnt[t][r] = s;  // becomes the thread's within-row offset
      s += c;
    }
    Tp[r + 1] = Tp[r] + (I)s;
  }
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nth; ++t)
      ts.emplace_back([&, t] {
        std::vector<int64_t>& off = cnt[t];
        for (int64_t r = 0; r < m; ++r) off[r] += Tp[r];
        for (int64_t c = cb[t]; c < cb[t + 1]; ++c)
          for (int64_t p = Ap[c]; p < Ap[c + 1]; ++p) {
            const int64_t d = off[Ai[p]]++;
            Ti[d] = (I)c;
            Tx[d] = Ax[p];
          }
      });
    for (auto& th : ts) th.join();
  }
}

}  // namespace

extern "C" {

void csc_transpose_d(int64_t m, int64_t n, const int64_t* Ap,
                     const int64_t* Ai, const double* Ax, int64_t* Tp,
                     int64_t* Ti, double* Tx) {
  transpose_impl<int64_t, double>(m, n, Ap, Ai, Ax, Tp, Ti, Tx);
}

void csc_transpose_z(int64_t m, int64_t n, const int64_t* Ap,
                     const int64_t* Ai, const void* Ax, int64_t* Tp,
                     int64_t* Ti, void* Tx) {
  transpose_impl<int64_t, cplx>(m, n, Ap, Ai, (const cplx*)Ax, Tp, Ti,
                                (cplx*)Tx);
}

void csc_transpose_d32(int64_t m, int64_t n, const int32_t* Ap,
                       const int32_t* Ai, const double* Ax, int32_t* Tp,
                       int32_t* Ti, double* Tx) {
  transpose_impl<int32_t, double>(m, n, Ap, Ai, Ax, Tp, Ti, Tx);
}

void csc_transpose_z32(int64_t m, int64_t n, const int32_t* Ap,
                       const int32_t* Ai, const void* Ax, int32_t* Tp,
                       int32_t* Ti, void* Tx) {
  transpose_impl<int32_t, cplx>(m, n, Ap, Ai, (const cplx*)Ax, Tp, Ti,
                                (cplx*)Tx);
}

void csc_transpose_s(int64_t m, int64_t n, const int64_t* Ap,
                     const int64_t* Ai, const float* Ax, int64_t* Tp,
                     int64_t* Ti, float* Tx) {
  transpose_impl<int64_t, float>(m, n, Ap, Ai, Ax, Tp, Ti, Tx);
}

void csc_transpose_s32(int64_t m, int64_t n, const int32_t* Ap,
                       const int32_t* Ai, const float* Ax, int32_t* Tp,
                       int32_t* Ti, float* Tx) {
  transpose_impl<int32_t, float>(m, n, Ap, Ai, Ax, Tp, Ti, Tx);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Canonical CSC union binop: C = alpha*A + beta*B via per-column 2-pointer
// merge (reference: csr_binop_csr_canonical, src/sparsetools/csr.h:783-889,
// dispatched from CscMat.__add__/__sub__ at src/CSparse3/csc.py:301-346).
// Inputs must be canonical; C capacity >= nnzA + nnzB; returns actual nnz.
// ---------------------------------------------------------------------------

namespace {

template <typename I, typename T>
int64_t axpby_impl(int64_t n, const I* Ap, const I* Ai,
                   const T* Ax, T alpha, const I* Bp, const I* Bi,
                   const T* Bx, T beta, I* Cp, I* Ci, T* Cx) {
  int64_t nnz = 0;
  Cp[0] = 0;
  for (int64_t j = 0; j < n; ++j) {
    int64_t pa = Ap[j], pb = Bp[j];
    const int64_t ea = Ap[j + 1], eb = Bp[j + 1];
    while (pa < ea && pb < eb) {
      const I ra = Ai[pa], rb = Bi[pb];
      if (ra == rb) {
        Ci[nnz] = ra;
        Cx[nnz++] = alpha * Ax[pa++] + beta * Bx[pb++];
      } else if (ra < rb) {
        Ci[nnz] = ra;
        Cx[nnz++] = alpha * Ax[pa++];
      } else {
        Ci[nnz] = rb;
        Cx[nnz++] = beta * Bx[pb++];
      }
    }
    for (; pa < ea; ++pa) {
      Ci[nnz] = Ai[pa];
      Cx[nnz++] = alpha * Ax[pa];
    }
    for (; pb < eb; ++pb) {
      Ci[nnz] = Bi[pb];
      Cx[nnz++] = beta * Bx[pb];
    }
    Cp[j + 1] = (I)nnz;
  }
  return nnz;
}

}  // namespace

extern "C" {

int64_t csc_axpby_d(int64_t n, const int64_t* Ap, const int64_t* Ai,
                    const double* Ax, double alpha, const int64_t* Bp,
                    const int64_t* Bi, const double* Bx, double beta,
                    int64_t* Cp, int64_t* Ci, double* Cx) {
  return axpby_impl<int64_t, double>(n, Ap, Ai, Ax, alpha, Bp, Bi, Bx, beta,
                                     Cp, Ci, Cx);
}

int64_t csc_axpby_z(int64_t n, const int64_t* Ap, const int64_t* Ai,
                    const void* Ax, double alpha_re, double alpha_im,
                    const int64_t* Bp, const int64_t* Bi, const void* Bx,
                    double beta_re, double beta_im, int64_t* Cp, int64_t* Ci,
                    void* Cx) {
  return axpby_impl<int64_t, cplx>(n, Ap, Ai, (const cplx*)Ax,
                                   cplx(alpha_re, alpha_im), Bp, Bi,
                                   (const cplx*)Bx, cplx(beta_re, beta_im),
                                   Cp, Ci, (cplx*)Cx);
}

int64_t csc_axpby_d32(int64_t n, const int32_t* Ap, const int32_t* Ai,
                      const double* Ax, double alpha, const int32_t* Bp,
                      const int32_t* Bi, const double* Bx, double beta,
                      int32_t* Cp, int32_t* Ci, double* Cx) {
  return axpby_impl<int32_t, double>(n, Ap, Ai, Ax, alpha, Bp, Bi, Bx, beta,
                                     Cp, Ci, Cx);
}

int64_t csc_axpby_z32(int64_t n, const int32_t* Ap, const int32_t* Ai,
                      const void* Ax, double alpha_re, double alpha_im,
                      const int32_t* Bp, const int32_t* Bi, const void* Bx,
                      double beta_re, double beta_im, int32_t* Cp,
                      int32_t* Ci, void* Cx) {
  return axpby_impl<int32_t, cplx>(n, Ap, Ai, (const cplx*)Ax,
                                   cplx(alpha_re, alpha_im), Bp, Bi,
                                   (const cplx*)Bx, cplx(beta_re, beta_im),
                                   Cp, Ci, (cplx*)Cx);
}

int64_t csc_axpby_s(int64_t n, const int64_t* Ap, const int64_t* Ai,
                    const float* Ax, double alpha, const int64_t* Bp,
                    const int64_t* Bi, const float* Bx, double beta,
                    int64_t* Cp, int64_t* Ci, float* Cx) {
  return axpby_impl<int64_t, float>(n, Ap, Ai, Ax, (float)alpha, Bp, Bi, Bx,
                                    (float)beta, Cp, Ci, Cx);
}

int64_t csc_axpby_s32(int64_t n, const int32_t* Ap, const int32_t* Ai,
                      const float* Ax, double alpha, const int32_t* Bp,
                      const int32_t* Bi, const float* Bx, double beta,
                      int32_t* Cp, int32_t* Ci, float* Cx) {
  return axpby_impl<int32_t, float>(n, Ap, Ai, Ax, (float)alpha, Bp, Bi, Bx,
                                    (float)beta, Cp, Ci, Cx);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering (native twin of linalg/ordering.py::rcm).
// BFS from a George-Liu pseudo-peripheral node per component, neighbors
// visited in increasing-degree order, result reversed.  Tie-breaking may
// differ from the Python implementation; only the bandwidth profile is
// contractual.
// ---------------------------------------------------------------------------

namespace {

// Symmetrize the pattern of a square CSC into a deduped adjacency
// (ptr, adj), no self loops, each list sorted ascending.
void symmetrize_adj(int64_t n, const int64_t* Ap, const int64_t* Ai,
                    std::vector<int64_t>& ptr, std::vector<int64_t>& adj) {
  std::vector<int64_t> cnt(n, 0);
  for (int64_t c = 0; c < n; ++c)
    for (int64_t p = Ap[c]; p < Ap[c + 1]; ++p) {
      const int64_t r = Ai[p];
      if (r != c) {
        cnt[r]++;
        cnt[c]++;
      }
    }
  ptr.assign(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) ptr[i + 1] = ptr[i] + cnt[i];
  std::vector<int64_t> raw(ptr[n]);
  std::vector<int64_t> fill(ptr.begin(), ptr.end() - 1);
  for (int64_t c = 0; c < n; ++c)
    for (int64_t p = Ap[c]; p < Ap[c + 1]; ++p) {
      const int64_t r = Ai[p];
      if (r != c) {
        raw[fill[r]++] = c;
        raw[fill[c]++] = r;
      }
    }
  // dedup per list (sort + unique), rebuild compactly
  adj.clear();
  adj.reserve(raw.size());
  std::vector<int64_t> newptr(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = ptr[i], hi = fill[i];
    std::sort(raw.begin() + lo, raw.begin() + hi);
    int64_t prev = -1;
    for (int64_t p = lo; p < hi; ++p)
      if (raw[p] != prev) {
        adj.push_back(raw[p]);
        prev = raw[p];
      }
    newptr[i + 1] = (int64_t)adj.size();
  }
  ptr.swap(newptr);
}

}  // namespace

extern "C" {

void rcm_order(int64_t n, const int64_t* Ap, const int64_t* Ai,
               int64_t* perm_out) {
  std::vector<int64_t> ptr, adj;
  symmetrize_adj(n, Ap, Ai, ptr, adj);
  std::vector<int64_t> deg(n);
  for (int64_t i = 0; i < n; ++i) deg[i] = ptr[i + 1] - ptr[i];

  std::vector<char> visited(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> level(n, -1);
  std::vector<int64_t> frontier, nxt, scratch;

  // component seeds in (degree, id) order
  std::vector<int64_t> seeds(n);
  std::iota(seeds.begin(), seeds.end(), 0);
  std::stable_sort(seeds.begin(), seeds.end(),
                   [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });

  // BFS level structure from u over the unvisited component; returns
  // (depth, farthest-min-degree node); stamps `level` with `stamp`.
  auto bfs_far = [&](int64_t u, int64_t stamp, int64_t* out_far) -> int64_t {
    frontier.clear();
    frontier.push_back(u);
    level[u] = stamp;
    int64_t depth = 0;
    int64_t far = u;
    while (true) {
      nxt.clear();
      for (const int64_t v : frontier)
        for (int64_t p = ptr[v]; p < ptr[v + 1]; ++p) {
          const int64_t w = adj[p];
          if (!visited[w] && level[w] != stamp) {
            level[w] = stamp;
            nxt.push_back(w);
          }
        }
      if (nxt.empty()) break;
      ++depth;
      frontier.swap(nxt);
    }
    // farthest level is in `frontier`; min degree wins
    far = frontier[0];
    for (const int64_t v : frontier)
      if (deg[v] < deg[far]) far = v;
    *out_far = far;
    return depth;
  };

  int64_t stamp = 0;
  size_t seed_ptr = 0;
  while ((int64_t)order.size() < n) {
    while (visited[seeds[seed_ptr]]) ++seed_ptr;
    // George-Liu pseudo-peripheral node
    int64_t u = seeds[seed_ptr];
    int64_t last_ecc = -1;
    for (int iter = 0; iter < 16; ++iter) {
      int64_t far;
      const int64_t ecc = bfs_far(u, ++stamp, &far);
      if (ecc <= last_ecc) break;
      last_ecc = ecc;
      u = far;
    }
    // Cuthill-McKee BFS from u
    const size_t head0 = order.size();
    order.push_back(u);
    visited[u] = 1;
    size_t head = head0;
    while (head < order.size()) {
      const int64_t v = order[head++];
      scratch.clear();
      for (int64_t p = ptr[v]; p < ptr[v + 1]; ++p) {
        const int64_t w = adj[p];
        if (!visited[w]) {
          visited[w] = 1;
          scratch.push_back(w);
        }
      }
      std::stable_sort(scratch.begin(), scratch.end(),
                       [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });
      for (const int64_t w : scratch) order.push_back(w);
    }
  }
  for (int64_t i = 0; i < n; ++i) perm_out[i] = order[n - 1 - i];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Nested-dissection ordering (new capability; no reference equivalent).
// Recursive BFS level-set bisection: the middle BFS level of a
// pseudo-peripheral level structure is the separator, halves recurse,
// separator is eliminated last; leaves fall back to quotient-graph AMD.
// On near-planar graphs (power grids; models/grids.synthetic_grid) this
// gives O(n log n)-class fill where minimum-degree alone blows up.
// ---------------------------------------------------------------------------

namespace {

struct NDContext {
  const std::vector<int64_t>& ptr;
  const std::vector<int64_t>& adj;
  std::vector<int64_t>& perm;     // output order, filled back-to-front
  int64_t out_pos;                // next position (counting down)
  std::vector<int64_t> stamp;     // BFS stamp per vertex
  std::vector<int64_t> in_set;    // subproblem membership stamp
  int64_t next_stamp = 1;
  int64_t leaf_size;
  std::vector<int64_t> levels;    // scratch: BFS level per vertex
};

// Order subproblem V (vertices with in_set[v] == set_id) and write its
// vertices into perm positions [out_pos - |V|, out_pos).
void nd_process(NDContext& c, std::vector<int64_t> V, int64_t set_id);

// AMD on the subgraph induced by V: extract local CSC, call amd_order.
void nd_leaf(NDContext& c, const std::vector<int64_t>& V, int64_t set_id) {
  const int64_t nv = (int64_t)V.size();
  std::vector<int64_t> local(nv);
  // global->local map via stamp trick: reuse c.levels as the map
  for (int64_t i = 0; i < nv; ++i) c.levels[V[i]] = i;
  std::vector<int64_t> lp(nv + 1, 0);
  std::vector<int64_t> li;
  li.reserve(4 * nv);
  for (int64_t i = 0; i < nv; ++i) {
    const int64_t v = V[i];
    for (int64_t p = c.ptr[v]; p < c.ptr[v + 1]; ++p) {
      const int64_t w = c.adj[p];
      if (c.in_set[w] == set_id) li.push_back(c.levels[w]);
    }
    lp[i + 1] = (int64_t)li.size();
  }
  std::vector<int64_t> lperm(nv);
  amd_order(nv, lp.data(), li.data(), lperm.data());
  // append in AMD order (these are eliminated before anything above them)
  for (int64_t i = nv - 1; i >= 0; --i) c.perm[--c.out_pos] = V[lperm[i]];
}

void nd_process(NDContext& c, std::vector<int64_t> V, int64_t set_id) {
  const int64_t nv = (int64_t)V.size();
  if (nv <= c.leaf_size) {
    nd_leaf(c, V, set_id);
    return;
  }

  // BFS from V[0]; if disconnected, split off the reached component.
  const int64_t s0 = c.next_stamp++;
  std::vector<int64_t> frontier{V[0]}, nxt, comp{V[0]};
  c.stamp[V[0]] = s0;
  while (!frontier.empty()) {
    nxt.clear();
    for (const int64_t v : frontier)
      for (int64_t p = c.ptr[v]; p < c.ptr[v + 1]; ++p) {
        const int64_t w = c.adj[p];
        if (c.in_set[w] == set_id && c.stamp[w] != s0) {
          c.stamp[w] = s0;
          nxt.push_back(w);
          comp.push_back(w);
        }
      }
    frontier.swap(nxt);
  }
  if ((int64_t)comp.size() < nv) {
    // disconnected: peel every component in a loop (one recursion each,
    // so depth stays O(log) regardless of the component count)
    std::vector<int64_t> pending;
    for (const int64_t v : V)
      if (c.stamp[v] != s0) pending.push_back(v);
    {
      const int64_t comp_id = c.next_stamp++;
      for (const int64_t v : comp) c.in_set[v] = comp_id;
      nd_process(c, std::move(comp), comp_id);
    }
    while (!pending.empty()) {
      const int64_t s1 = c.next_stamp++;
      std::vector<int64_t> comp2{pending[0]};
      c.stamp[pending[0]] = s1;
      frontier.assign(1, pending[0]);
      while (!frontier.empty()) {
        nxt.clear();
        for (const int64_t v : frontier)
          for (int64_t p = c.ptr[v]; p < c.ptr[v + 1]; ++p) {
            const int64_t w = c.adj[p];
            if (c.in_set[w] == set_id && c.stamp[w] != s1) {
              c.stamp[w] = s1;
              nxt.push_back(w);
              comp2.push_back(w);
            }
          }
        frontier.swap(nxt);
      }
      std::vector<int64_t> rest2;
      for (const int64_t v : pending)
        if (c.stamp[v] != s1) rest2.push_back(v);
      pending.swap(rest2);
      const int64_t comp_id = c.next_stamp++;
      for (const int64_t v : comp2) c.in_set[v] = comp_id;
      nd_process(c, std::move(comp2), comp_id);
    }
    return;
  }

  // pseudo-peripheral: two BFS sweeps from V[0]
  int64_t root = V[0];
  for (int iter = 0; iter < 2; ++iter) {
    const int64_t s = c.next_stamp++;
    frontier.assign(1, root);
    c.stamp[root] = s;
    int64_t far = root;
    while (!frontier.empty()) {
      nxt.clear();
      for (const int64_t v : frontier)
        for (int64_t p = c.ptr[v]; p < c.ptr[v + 1]; ++p) {
          const int64_t w = c.adj[p];
          if (c.in_set[w] == set_id && c.stamp[w] != s) {
            c.stamp[w] = s;
            nxt.push_back(w);
          }
        }
      if (!nxt.empty()) far = nxt[0];
      frontier.swap(nxt);
    }
    root = far;
  }

  // BFS level structure from root
  const int64_t s = c.next_stamp++;
  frontier.assign(1, root);
  c.stamp[root] = s;
  c.levels[root] = 0;
  int64_t nlev = 1;
  std::vector<int64_t> level_cnt{1};
  while (!frontier.empty()) {
    nxt.clear();
    for (const int64_t v : frontier)
      for (int64_t p = c.ptr[v]; p < c.ptr[v + 1]; ++p) {
        const int64_t w = c.adj[p];
        if (c.in_set[w] == set_id && c.stamp[w] != s) {
          c.stamp[w] = s;
          c.levels[w] = nlev;
          nxt.push_back(w);
        }
      }
    if (!nxt.empty()) {
      level_cnt.push_back((int64_t)nxt.size());
      ++nlev;
    }
    frontier.swap(nxt);
  }

  if (nlev < 3) {  // no room for a separator level: fall back to AMD leaf
    nd_leaf(c, V, set_id);
    return;
  }

  // separator level: balanced cut minimizing width among levels whose
  // below-fraction lies in [0.25, 0.75]
  std::vector<int64_t> below(nlev + 1, 0);
  for (int64_t l = 0; l < nlev; ++l) below[l + 1] = below[l] + level_cnt[l];
  int64_t best_l = -1;
  double best_score = 1e300;
  for (int64_t l = 1; l + 1 < nlev; ++l) {
    const double frac = (double)below[l] / (double)nv;
    const double balance_pen =
        (frac < 0.25 || frac > 0.75) ? 1e6 * std::abs(frac - 0.5) : 0.0;
    const double score = (double)level_cnt[l] + balance_pen;
    if (score < best_score) {
      best_score = score;
      best_l = l;
    }
  }

  std::vector<int64_t> A, B, S;
  A.reserve(below[best_l]);
  S.reserve(level_cnt[best_l]);
  B.reserve(nv - below[best_l + 1]);
  for (const int64_t v : V) {
    const int64_t l = c.levels[v];
    if (l < best_l)
      A.push_back(v);
    else if (l == best_l)
      S.push_back(v);
    else
      B.push_back(v);
  }
  // thin the separator: a level-l vertex with no neighbor on the far
  // (l+1) side does not separate anything — move it into A
  {
    size_t keep = 0;
    for (size_t i = 0; i < S.size(); ++i) {
      const int64_t v = S[i];
      bool touches_b = false;
      for (int64_t p = c.ptr[v]; p < c.ptr[v + 1]; ++p) {
        const int64_t w = c.adj[p];
        if (c.in_set[w] == set_id && c.levels[w] == best_l + 1 &&
            c.stamp[w] == s) {
          touches_b = true;
          break;
        }
      }
      if (touches_b)
        S[keep++] = v;
      else
        A.push_back(v);
    }
    S.resize(keep);
  }

  // eliminate S last: write it at the top of this subproblem's range
  for (int64_t i = (int64_t)S.size() - 1; i >= 0; --i)
    c.perm[--c.out_pos] = S[i];
  const int64_t a_id = c.next_stamp++;
  for (const int64_t v : A) c.in_set[v] = a_id;
  const int64_t b_id = c.next_stamp++;
  for (const int64_t v : B) c.in_set[v] = b_id;
  nd_process(c, std::move(B), b_id);
  nd_process(c, std::move(A), a_id);
}

}  // namespace

extern "C" {

void nd_order(int64_t n, const int64_t* Ap, const int64_t* Ai,
              int64_t leaf_size, int64_t* perm_out) {
  std::vector<int64_t> ptr, adj;
  symmetrize_adj(n, Ap, Ai, ptr, adj);
  std::vector<int64_t> perm(n);
  NDContext c{ptr, adj, perm, n, std::vector<int64_t>(n, 0),
              std::vector<int64_t>(n, 0), 1,
              std::max<int64_t>(leaf_size, 8), std::vector<int64_t>(n, 0)};
  std::vector<int64_t> all(n);
  std::iota(all.begin(), all.end(), 0);
  nd_process(c, std::move(all), 0);
  std::memcpy(perm_out, perm.data(), n * sizeof(int64_t));
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Block triangular form (KLU-style BTF): maximum transversal (MC21-class
// augmenting-path matching with cheap-assignment warm start) + Tarjan SCC
// on the matched graph.  Returns row perm p, col perm q and block
// boundaries such that A(p, q) is block upper triangular with nonzero
// diagonal wherever a perfect matching exists.  New capability vs the
// reference (its graph layer stops at undirected islands,
// src/CSparse3/csc_numba.py::find_islands).
// ---------------------------------------------------------------------------

extern "C" {

// match_out[c] = row matched to column c (-1 if unmatched).  Returns the
// matching size (== n iff structurally nonsingular).
int64_t max_transversal(int64_t n, const int64_t* Ap, const int64_t* Ai,
                        int64_t* match_out) {
  std::vector<int64_t> rmatch(n, -1), cmatch(n, -1);
  // cheap assignment
  for (int64_t c = 0; c < n; ++c)
    for (int64_t p = Ap[c]; p < Ap[c + 1] && cmatch[c] < 0; ++p) {
      const int64_t r = Ai[p];
      if (rmatch[r] < 0) {
        rmatch[r] = c;
        cmatch[c] = r;
      }
    }
  // augmenting DFS per unmatched column (iterative, with visit stamps and
  // per-column edge cursors to stay O(nnz) per phase)
  std::vector<int64_t> cstamp(n, -1), pos(n), cstack(n), pred(n);
  int64_t size = 0;
  for (int64_t c = 0; c < n; ++c)
    if (cmatch[c] >= 0) ++size;
  for (int64_t c0 = 0; c0 < n; ++c0) {
    if (cmatch[c0] >= 0) continue;
    int64_t sp = 0;
    cstack[0] = c0;
    pos[c0] = Ap[c0];
    cstamp[c0] = c0;
    int64_t found_row = -1;
    while (sp >= 0) {
      const int64_t c = cstack[sp];
      int64_t p = pos[c];
      int64_t next_c = -1;
      for (; p < Ap[c + 1]; ++p) {
        const int64_t r = Ai[p];
        const int64_t c2 = rmatch[r];
        if (c2 < 0) {
          found_row = r;
          break;
        }
        if (cstamp[c2] != c0) {
          cstamp[c2] = c0;
          pred[c2] = r;  // reach c2 via row r from c
          next_c = c2;
          ++p;
          break;
        }
      }
      pos[c] = p;
      if (found_row >= 0) {
        // augment along the stack
        int64_t r = found_row;
        for (int64_t s = sp; s >= 0; --s) {
          const int64_t cc = cstack[s];
          const int64_t old = cmatch[cc];
          cmatch[cc] = r;
          rmatch[r] = cc;
          if (s > 0) r = pred[cc];
          (void)old;
        }
        ++size;
        break;
      }
      if (next_c >= 0) {
        ++sp;
        cstack[sp] = next_c;
        pos[next_c] = Ap[next_c];
      } else {
        --sp;
      }
    }
  }
  std::memcpy(match_out, cmatch.data(), n * sizeof(int64_t));
  return size;
}

// Tarjan SCC over the column digraph c -> c2 (edge if A(r, c) != 0 with
// r = match[c2]).  Emits p (rows), q (cols), block starts (nb+1 entries in
// block_ptr, first nb_out[0] used).  Unmatched structurally-singular
// matrices fall back to match-completing arbitrary diagonal.
void btf_order(int64_t n, const int64_t* Ap, const int64_t* Ai,
               int64_t* p_out, int64_t* q_out, int64_t* block_ptr,
               int64_t* nb_out) {
  std::vector<int64_t> match(n);
  max_transversal(n, Ap, Ai, match.data());
  // complete a deficient matching arbitrarily (keeps perms valid)
  {
    std::vector<char> used(n, 0);
    for (int64_t c = 0; c < n; ++c)
      if (match[c] >= 0) used[match[c]] = 1;
    int64_t free_r = 0;
    for (int64_t c = 0; c < n; ++c)
      if (match[c] < 0) {
        while (used[free_r]) ++free_r;
        match[c] = free_r;
        used[free_r] = 1;
      }
  }
  std::vector<int64_t> rinv(n);  // row -> column it is matched to
  for (int64_t c = 0; c < n; ++c) rinv[match[c]] = c;

  // iterative Tarjan over columns
  std::vector<int64_t> low(n, -1), num(n, -1), sstack, tstack, pos(n);
  std::vector<char> on_stack(n, 0);
  sstack.reserve(n);
  tstack.reserve(n);
  int64_t counter = 0, nb = 0, out = n;
  // emit SCCs in reverse topological order from the back of p/q; Tarjan
  // pops sinks-first in this edge orientation, so blocks fill from the end
  std::vector<int64_t> blocks_rev;
  for (int64_t c0 = 0; c0 < n; ++c0) {
    if (num[c0] >= 0) continue;
    tstack.push_back(c0);
    pos[c0] = Ap[c0];
    num[c0] = low[c0] = counter++;
    sstack.push_back(c0);
    on_stack[c0] = 1;
    while (!tstack.empty()) {
      const int64_t c = tstack.back();
      int64_t p = pos[c];
      int64_t child = -1;
      for (; p < Ap[c + 1]; ++p) {
        const int64_t c2 = rinv[Ai[p]];
        if (c2 == c) continue;
        if (num[c2] < 0) {
          child = c2;
          ++p;
          break;
        }
        if (on_stack[c2] && num[c2] < low[c]) low[c] = num[c2];
      }
      pos[c] = p;
      if (child >= 0) {
        tstack.push_back(child);
        pos[child] = Ap[child];
        num[child] = low[child] = counter++;
        sstack.push_back(child);
        on_stack[child] = 1;
        continue;
      }
      tstack.pop_back();
      if (!tstack.empty()) {
        const int64_t parent = tstack.back();
        if (low[c] < low[parent]) low[parent] = low[c];
      }
      if (low[c] == num[c]) {
        const int64_t blk_end = out;
        while (true) {
          const int64_t w = sstack.back();
          sstack.pop_back();
          on_stack[w] = 0;
          --out;
          q_out[out] = w;
          p_out[out] = match[w];
          if (w == c) break;
        }
        blocks_rev.push_back(blk_end);
        ++nb;
      }
    }
  }
  // Emitted back-to-front, Tarjan pops sinks of the c -> rinv[Ai] digraph
  // first, which lands at block LOWER triangular.  Reverse the block order
  // (keeping within-block order) for the standard block UPPER triangular
  // convention (cs_dmperm/KLU).  Blocks fill p/q contiguously downward, so
  // popped block i spans [i + 1 < nb ? blocks_rev[i + 1] : 0, blocks_rev[i]).
  std::vector<int64_t> np_(n), nq(n);
  int64_t w = 0;
  block_ptr[0] = 0;
  for (int64_t i = 0; i < nb; ++i) {  // i = pop order = final block order
    const int64_t lo = (i + 1 < nb) ? blocks_rev[i + 1] : 0;
    const int64_t hi = blocks_rev[i];
    for (int64_t t = lo; t < hi; ++t) {
      np_[w] = p_out[t];
      nq[w] = q_out[t];
      ++w;
    }
    block_ptr[i + 1] = w;
  }
  std::memcpy(p_out, np_.data(), n * sizeof(int64_t));
  std::memcpy(q_out, nq.data(), n * sizeof(int64_t));
  nb_out[0] = nb;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sparse LDL^T factorization — up-looking, CSparse cs_chol lineage
// (the symmetric counterpart the reference's CSparse ancestry defines but
// the Python port never reached; SURVEY scope note).  A = L D L^T with L
// unit lower triangular (unit diagonal STORED, so the factor feeds the
// same TriSolvePlan machinery as LU's L) and D diagonal.  No pivoting:
// the symmetric fill-reducing ordering is the only permutation, which is
// exact for the symmetric diagonally-dominant systems of this domain
// (DC / fast-decoupled B' and B'' matrices); zero pivots are REPORTED
// (sing list), matching the SuperLU-style LU behavior.
//
// Row pattern of L(k, :) comes from the elimination tree (cs_ereach):
// walk each upper entry A[r, k] (r < k) up the etree until a node marked
// with this column's stamp, pushing the path — the concatenated paths in
// pop order are a topological order of the row's sparse triangular solve.
// ---------------------------------------------------------------------------

namespace {

template <typename T>
LDLTResult* ldlt_factor_impl(int64_t n, const int64_t* Ap, const int64_t* Ai,
                             const T* Ax) {
  // elimination tree (upper-triangle walk with ancestor path compression)
  std::vector<int64_t> parent(n, -1), ancestor(n, -1);
  for (int64_t k = 0; k < n; ++k) {
    for (int64_t p = Ap[k]; p < Ap[k + 1]; ++p) {
      int64_t i = Ai[p];
      while (i != -1 && i < k) {
        const int64_t nxt = ancestor[i];
        ancestor[i] = k;
        if (nxt == -1) parent[i] = k;
        i = nxt;
      }
    }
  }

  // column counts: one ereach per column (stamped walk), +1 for the diag
  std::vector<int64_t> w(n, -1), stack(n), cnt(n, 1);
  auto ereach = [&](int64_t k, std::vector<int64_t>& s) -> int64_t {
    int64_t top = n;
    w[k] = k;  // never walk past k
    for (int64_t p = Ap[k]; p < Ap[k + 1]; ++p) {
      int64_t i = Ai[p];
      if (i >= k) continue;  // lower/diag entries of the symmetric input
      int64_t len = 0;
      while (w[i] != k) {
        stack[len++] = i;
        w[i] = k;
        i = parent[i];
        if (i == -1) break;
      }
      while (len > 0) s[--top] = stack[--len];
    }
    return top;
  };

  std::vector<int64_t> s(n);
  for (int64_t k = 0; k < n; ++k) {
    const int64_t top = ereach(k, s);
    for (int64_t t = top; t < n; ++t) cnt[s[t]]++;
  }
  std::vector<int64_t> Lp(n + 1, 0);
  for (int64_t j = 0; j < n; ++j) Lp[j + 1] = Lp[j] + cnt[j];
  const int64_t lnz = Lp[n];

  LDLTResult* r = (LDLTResult*)std::calloc(1, sizeof(LDLTResult));
  r->n = n;
  r->lnz = lnz;
  r->Lp = (int64_t*)std::malloc((n + 1) * sizeof(int64_t));
  r->Li = (int64_t*)std::malloc(lnz * sizeof(int64_t));
  r->Lx = std::malloc(lnz * sizeof(T));
  r->D = std::malloc(n * sizeof(T));
  std::memcpy(r->Lp, Lp.data(), (n + 1) * sizeof(int64_t));
  int64_t* Li = r->Li;
  T* Lx = (T*)r->Lx;
  T* D = (T*)r->D;

  std::fill(w.begin(), w.end(), -1);
  std::vector<int64_t> c(n);      // append cursor per column (after diag)
  std::vector<T> x(n, T(0));      // sparse accumulator for row k
  std::vector<int64_t> sing;
  for (int64_t k = 0; k < n; ++k) {
    // open column k with its stored unit diagonal
    Li[Lp[k]] = k;
    Lx[Lp[k]] = T(1);
    c[k] = Lp[k] + 1;
    // scatter upper entries of column k; diagonal seeds d_k
    T dk = T(0);
    const int64_t top = ereach(k, s);
    for (int64_t p = Ap[k]; p < Ap[k + 1]; ++p) {
      const int64_t i = Ai[p];
      if (i < k) x[i] = Ax[p];
      else if (i == k) dk = Ax[p];
    }
    // sparse triangular solve along the etree topological order
    for (int64_t t = top; t < n; ++t) {
      const int64_t j = s[t];
      const T yj = x[j];  // = d[j] * L[k, j]
      x[j] = T(0);
      const T lkj = yj / D[j];
      for (int64_t p = Lp[j] + 1; p < c[j]; ++p) x[Li[p]] -= Lx[p] * yj;
      dk -= lkj * yj;
      Li[c[j]] = k;
      Lx[c[j]] = lkj;
      c[j]++;
    }
    D[k] = dk;
    if (dk == T(0)) sing.push_back(k);
  }
  r->nsing = (int64_t)sing.size();
  r->sing = (int64_t*)std::malloc(std::max<size_t>(sing.size(), 1) *
                                  sizeof(int64_t));
  if (!sing.empty())
    std::memcpy(r->sing, sing.data(), sing.size() * sizeof(int64_t));
  return r;
}

}  // namespace

extern "C" {

void ldlt_free(LDLTResult* r) {
  if (!r) return;
  std::free(r->Lp);
  std::free(r->Li);
  std::free(r->sing);
  std::free(r->Lx);
  std::free(r->D);
  std::free(r);
}

LDLTResult* ldlt_factor_d(int64_t n, const int64_t* Ap, const int64_t* Ai,
                          const double* Ax) {
  return ldlt_factor_impl<double>(n, Ap, Ai, Ax);
}

// complex SYMMETRIC (not Hermitian) — Ybus is symmetric, so LDL^T applies
// without conjugation
LDLTResult* ldlt_factor_z(int64_t n, const int64_t* Ap, const int64_t* Ai,
                          const void* Ax) {
  return ldlt_factor_impl<cplx>(n, Ap, Ai, (const cplx*)Ax);
}

}  // extern "C"
