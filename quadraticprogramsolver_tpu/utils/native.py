"""ctypes bindings for the native sparse LDL' library (native/qps_native.cpp).

Host-side counterpart of the reference's QDLDL/CHOLMOD dependencies
(`LinearSystemSolvers.jl:18-75`), built as first-party C++. Compiled on
demand with g++ (no pybind11 in this image); the .so is cached next to the
sources and rebuilt when the source is newer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import scipy.sparse as sp

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_REPO_ROOT, "native", "qps_native.cpp")
_LIB = os.path.join(_REPO_ROOT, "native", "build", "libqps_native.so")

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    stale = (os.path.exists(_SRC)
             and os.path.exists(_LIB)
             and os.path.getmtime(_LIB) < os.path.getmtime(_SRC))
    if not os.path.exists(_LIB) or stale:
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        # Build beside the target and rename into place: processes that
        # build at the same time (parallel test workers) then never load a
        # half-written library.
        part = f"{_LIB}.{os.getpid()}.part"
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", part, _SRC],
            check=True, capture_output=True)
        os.replace(part, _LIB)
    lib = ctypes.CDLL(_LIB)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.qps_ldl_etree.restype = ctypes.c_int32
    lib.qps_ldl_etree.argtypes = [ctypes.c_int32] + [i32p] * 4
    lib.qps_ldl_factor.restype = ctypes.c_int32
    lib.qps_ldl_factor.argtypes = [
        ctypes.c_int32, i32p, i32p, f64p, i32p, i32p, f64p, f64p, f64p,
        i32p, i32p, i32p, i8p, f64p]
    lib.qps_ldl_solve.restype = None
    lib.qps_ldl_solve.argtypes = [ctypes.c_int32, i32p, i32p, f64p, f64p, f64p]
    lib.qps_ldl_solve_multi.restype = None
    lib.qps_ldl_solve_multi.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, f64p, f64p, f64p]
    lib.qps_mindeg_order.restype = ctypes.c_int32
    lib.qps_mindeg_order.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
    _lib = lib
    return lib


def mindeg_ordering(A) -> np.ndarray:
    """Fill-reducing minimum-degree ordering of a symmetric scipy matrix.

    First-party native implementation (quotient-graph minimum degree,
    native/qps_native.cpp:qps_mindeg_order) of the role QDLDL fills with AMD
    in the reference stack (LinearSystemSolvers.jl:49-75 uses QDLDL, whose
    default ordering is AMD). Returns perm with perm[k] = original index of
    the k-th pivot.
    """
    lib = _load()
    U = sp.triu(sp.csc_matrix(A), format="csc")
    U.sort_indices()
    n = U.shape[0]
    Ap = U.indptr.astype(np.int32)
    Ai = U.indices.astype(np.int32)
    perm = np.zeros(n, np.int32)
    rc = lib.qps_mindeg_order(
        n, _ptr(Ap, ctypes.c_int32), _ptr(Ai, ctypes.c_int32),
        _ptr(perm, ctypes.c_int32))
    if rc != 0:
        raise ValueError("invalid structure for ordering (need explicit "
                         "diagonal, sorted upper-triangular CSC)")
    return perm


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


class LDLFactorization:
    """Sparse LDL' of a symmetric quasi-definite matrix.

    Symbolic analysis (elimination tree) runs once in __init__; `refactor`
    recomputes numeric values on the same pattern — the same cached-
    refactorization contract the reference gets from QDLDL/CHOLMOD across
    adaptive-rho updates (LinearSystemSolvers.jl:62-66, ProxQP.jl:205).
    """

    def __init__(self, A, ordering: str = "natural"):
        """A: full symmetric (or already upper-triangular) scipy sparse.

        ``ordering``: "natural" factors A as given; "mindeg" first applies
        the native fill-reducing minimum-degree permutation (safe for
        quasi-definite matrices — they are strongly factorizable under any
        symmetric permutation, Vanderbei '95). Solves are transparent: b/x
        stay in the original index space.
        """
        lib = _load()
        A = sp.csc_matrix(A)
        # Work on the full symmetric matrix so permutation keeps both
        # triangles consistent before re-extracting the upper part.
        A = sp.triu(A) + sp.triu(A, k=1).T
        self._perm = None
        if ordering == "mindeg":
            perm = mindeg_ordering(A)
            A = A[perm, :][:, perm].tocsc()
            self._perm = perm
        elif ordering != "natural":
            raise ValueError(f"unknown ordering: {ordering!r}")
        n = A.shape[0]
        U = sp.triu(A, format="csc")
        U.sort_indices()
        if U.diagonal().size != n:
            raise ValueError("matrix must have a structurally present diagonal")
        self.n = n
        self._Ap = U.indptr.astype(np.int32)
        self._Ai = U.indices.astype(np.int32)
        self._Ax = U.data.astype(np.float64)
        self._upper_pattern = (self._Ap.copy(), self._Ai.copy())

        work = np.zeros(n, np.int32)
        self._Lnz = np.zeros(n, np.int32)
        self._parent = np.zeros(n, np.int32)
        nnz_l = lib.qps_ldl_etree(
            n, _ptr(self._Ap, ctypes.c_int32), _ptr(self._Ai, ctypes.c_int32),
            _ptr(work, ctypes.c_int32), _ptr(self._Lnz, ctypes.c_int32),
            _ptr(self._parent, ctypes.c_int32))
        if nnz_l < 0:
            raise ValueError(
                "invalid structure: upper-triangular CSC with sorted indices "
                "and explicit diagonal required")
        self.nnz_L = int(nnz_l)
        self._Lp = np.zeros(n + 1, np.int32)
        self._Li = np.zeros(max(nnz_l, 1), np.int32)
        self._Lx = np.zeros(max(nnz_l, 1), np.float64)
        self.D = np.zeros(n, np.float64)
        self._Dinv = np.zeros(n, np.float64)
        self._iwork = np.zeros(3 * n, np.int32)
        self._bwork = np.zeros(n, np.int8)
        self._fwork = np.zeros(n, np.float64)
        self.num_positive_pivots = self._numeric()

    def _numeric(self) -> int:
        lib = _load()
        pos = lib.qps_ldl_factor(
            self.n, _ptr(self._Ap, ctypes.c_int32), _ptr(self._Ai, ctypes.c_int32),
            _ptr(self._Ax, ctypes.c_double), _ptr(self._Lp, ctypes.c_int32),
            _ptr(self._Li, ctypes.c_int32), _ptr(self._Lx, ctypes.c_double),
            _ptr(self.D, ctypes.c_double), _ptr(self._Dinv, ctypes.c_double),
            _ptr(self._Lnz, ctypes.c_int32), _ptr(self._parent, ctypes.c_int32),
            _ptr(self._iwork, ctypes.c_int32), _ptr(self._bwork, ctypes.c_int8),
            _ptr(self._fwork, ctypes.c_double))
        if pos < 0:
            raise ArithmeticError("zero pivot: matrix is not quasi-definite")
        return int(pos)

    def refactor(self, A) -> "LDLFactorization":
        """Recompute numeric values for a matrix with the identical pattern
        (given in the ORIGINAL index space; any ordering is re-applied)."""
        A = sp.csc_matrix(A)
        A = sp.triu(A) + sp.triu(A, k=1).T
        if self._perm is not None:
            A = A[self._perm, :][:, self._perm].tocsc()
        U = sp.triu(A, format="csc")
        U.sort_indices()
        if (not np.array_equal(U.indptr.astype(np.int32), self._upper_pattern[0])
                or not np.array_equal(U.indices.astype(np.int32), self._upper_pattern[1])):
            raise ValueError("refactor requires the identical sparsity pattern")
        self._Ax = U.data.astype(np.float64)
        self.num_positive_pivots = self._numeric()
        return self

    def solve(self, b: np.ndarray) -> np.ndarray:
        lib = _load()
        b = np.asarray(b, dtype=np.float64)
        if self._perm is not None:
            b = b[self._perm]
        x = np.ascontiguousarray(b).copy()
        if x.ndim == 1:
            lib.qps_ldl_solve(
                self.n, _ptr(self._Lp, ctypes.c_int32), _ptr(self._Li, ctypes.c_int32),
                _ptr(self._Lx, ctypes.c_double), _ptr(self._Dinv, ctypes.c_double),
                _ptr(x, ctypes.c_double))
        else:
            cols = np.asfortranarray(x)
            lib.qps_ldl_solve_multi(
                self.n, x.shape[1], _ptr(self._Lp, ctypes.c_int32),
                _ptr(self._Li, ctypes.c_int32), _ptr(self._Lx, ctypes.c_double),
                _ptr(self._Dinv, ctypes.c_double), _ptr(cols, ctypes.c_double))
            x = np.ascontiguousarray(cols)
        if self._perm is not None:
            out = np.empty_like(x)
            out[self._perm] = x
            x = out
        return x


def kkt_factorization(P, A, rho: float, sigma: float,
                      ordering: str = "mindeg") -> LDLFactorization:
    """Factor the OSQP quasi-definite KKT matrix [[P+sigma*I, A'], [A, -I/rho]].

    Defaults to the fill-reducing ordering — the reference's QDLDL path does
    the same via AMD (its setup default)."""
    P = sp.csc_matrix(P)
    A = sp.csc_matrix(A)
    n, m = P.shape[0], A.shape[0]
    K = sp.bmat(
        [[P + sigma * sp.identity(n), A.T], [A, -sp.identity(m) / rho]],
        format="csc")
    return LDLFactorization(K, ordering=ordering)
