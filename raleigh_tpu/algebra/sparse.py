"""Sparse symmetric operators, direct solver, and preconditioners.

Capability parity with reference raleigh/algebra/sparse_mkl.py (which
bridges SciPy sparse matrices to MKL csrmm / PARDISO / ILUT), re-targeted:

  * ``SparseSymmetricMatrix``   SpMM on block vectors — host SciPy CSR path
    for the NumPy algebra, ELL/BSR device kernels (raleigh_tpu/ops/spmm.py)
    for the JAX algebra;
  * ``SparseSymmetricSolver``   shift-and-invert operator (A - sigma B)^-1
    backed by the native C++ LDL^T (raleigh_tpu/native/ldlt.cpp) with
    inertia — the PARDISO replacement;
  * ``IncompleteLU``            ILU-type preconditioner (host SuperLU ILU,
    reference sparse_mkl.py:122-140 semantics);
  * ``Chebyshev``               device-resident polynomial preconditioner: a
    Chebyshev approximation to A^-1 on [lo, hi], applied as a short
    recurrence of SpMMs entirely on device (the factorization-free
    alternative SURVEY §7 calls for);
  * ``Operator``                adapter giving any object with an
    ndarray-level ``apply`` the Vectors-aware interface
    (reference sparse_mkl.py:143-154).
"""

import numpy as np
import scipy.sparse as scs

from ..utils import verbosity


def _vec_data(x):
    d = getattr(x, 'data', None)
    return x if d is None or not callable(d) else d()


def _rows_capable(dev, xd):
    """True when the device matrix can apply directly to the (m, n)
    row-vector layout (DIA) and the operand lives on a single device
    (the sharded regimes go through parallel/spmm_sharded instead)."""
    if not hasattr(dev, 'matmat_rows'):
        return False
    sh = getattr(xd, 'sharding', None)
    return sh is None or len(sh.device_set) == 1


class SparseSymmetricMatrix:
    """y = A x for blocks of row-vectors; A real symmetric (or Hermitian)
    in any SciPy sparse format."""

    def __init__(self, matrix, arch='cpu', dtype=None, bs=128):
        a = scs.csr_matrix(matrix)
        if dtype is not None:
            a = a.astype(dtype)
        from ..ops.spmm import _to_full_csr
        self.__csr_full = _to_full_csr(a)
        self.__csr = a
        self.__arch = arch
        self.__dev = None
        from .dense import is_device_arch
        if is_device_arch(arch):
            from ..ops.spmm import device_sparse
            self.__dev = device_sparse(self.__csr_full,
                                       dtype=self.__csr_full.dtype.type,
                                       bs=bs)

    def size(self):
        return self.__csr.shape[0]

    def shape(self):
        return self.__csr.shape

    def data_type(self):
        return self.__csr.data.dtype

    def csr(self):
        return self.__csr

    def csr_full(self):
        return self.__csr_full

    def device_matrix(self):
        return self.__dev

    def apply(self, x, y):
        if self.__dev is not None and hasattr(x, 'device_data'):
            xd = x.device_data()
            if _rows_capable(self.__dev, xd):
                y.fill(self.__dev.matmat_rows(xd))   # no relayout
            else:
                # (n, m) so ELL/BSR row gathers hit the major dimension
                y.fill(self.__dev.matmat_t(xd.T).T)
            return
        xd = _vec_data(x)
        out = self.__csr_full.dot(xd.T).T
        if callable(getattr(y, 'data', None)):   # Vectors
            y.fill(out)
        else:
            y[...] = out


class SparseSymmetricSolver:
    """Shift-and-invert operator: factorize A - sigma*B once (native LDL^T),
    then ``apply`` solves with block right-hand sides
    (reference sparse_mkl.py:51-120)."""

    def __init__(self, dtype=np.float64, pos_def=False):
        self.__dtype = np.dtype(dtype).type
        self.__pos_def = pos_def
        self.__ldlt = None
        self.__n = None
        self.__sigma = 0
        self.__complex = np.dtype(dtype).kind == 'c'

    def analyse(self, a, sigma=0, b=None):
        if sigma != 0:
            if b is None:
                b = scs.eye(a.shape[0], dtype=a.dtype, format='csr')
            a_s = a - sigma * b
        else:
            a_s = a
        from ..native.ldlt import SparseLDLT
        from ..utils import env
        self.__complex = np.dtype(self.__dtype).kind == 'c'
        self.__embedded = False
        if self.__complex and env.complex_via_embedding:
            # fallback route: Hermitian A = Ar + i*Ai factors through its
            # real symmetric embedding K = [[Ar, -Ai], [Ai, Ar]]:
            # eigenvalues double, so inertia halves; solves embed [Re; Im]
            # per right-hand side.  Twice the size of the native LDL^H.
            a_s = scs.csr_matrix(a_s)
            ar = scs.csr_matrix((a_s.data.real, a_s.indices, a_s.indptr),
                                shape=a_s.shape)
            ai = scs.csr_matrix((a_s.data.imag, a_s.indices, a_s.indptr),
                                shape=a_s.shape)
            k = scs.bmat([[ar, -ai], [ai, ar]], format='csr')
            self.__ldlt = SparseLDLT(k)
            self.__embedded = True
        elif self.__complex:
            # native Hermitian LDL^H (zldltmf_* engine, real D -> inertia)
            self.__ldlt = SparseLDLT(scs.csr_matrix(a_s,
                                                    dtype=np.complex128))
        else:
            self.__ldlt = SparseLDLT(a_s)
        nnz_l = self.__ldlt.analyse()
        if verbosity.level > 0:
            print('LDL^T factor nnz: %d' % nnz_l)
        self.__n = a.shape[0]
        self.__sigma = sigma

    def factorize(self):
        try:
            self.__ldlt.factorize()
        except RuntimeError as e:
            raise RuntimeError('factorization failed (near singular '
                               'matrix?): %s' % e)

    def solve(self, b, x):
        bd = _vec_data(b)
        if self.__embedded:
            bc = np.asarray(bd, dtype=np.complex128)
            be = np.concatenate((bc.real, bc.imag), axis=-1)
            oe = self.__ldlt.solve(be)
            out = oe[..., :self.__n] + 1j * oe[..., self.__n:]
        elif self.__complex:
            out = self.__ldlt.solve(np.asarray(bd, dtype=np.complex128))
        else:
            out = self.__ldlt.solve(np.asarray(bd, dtype=np.float64))
        if callable(getattr(x, 'data', None)):   # Vectors
            x.fill(out.astype(np.dtype(bd.dtype), copy=False))
        else:
            x[...] = out

    def apply(self, b, x):
        self.solve(b, x)

    def inertia(self):
        neg, pos = self.__ldlt.inertia()
        if self.__embedded:
            neg, pos = neg // 2, pos // 2
        return neg, pos

    def size(self):
        return self.__n

    def data_type(self):
        return self.__dtype

    def sigma(self):
        return self.__sigma

    def solver(self):
        return self.__ldlt


class IncompleteLU:
    """Threshold incomplete-LU preconditioner backed by the native ILUT
    engine (raleigh_tpu/native/ilut.cpp), honoring the reference's
    ``factorize(tol, max_fill)`` semantics — drop tolerance relative to
    the row norm, per-row fill cap of ``max_fill`` times the average
    input row density (reference sparse_mkl.py:122-140 + the MKL
    dcsrilut wrapper mkl_wrap.py:305-331).  Falls back to SuperLU's
    ILUTP only when the native toolchain is unavailable."""

    def __init__(self, matrix):
        self.__a = scs.csr_matrix(matrix)
        self.__ilu = None
        self.__native = None

    def factorize(self, tol=1e-6, max_fill=1):
        from ..native.ldlt import native_available
        if native_available():
            from ..native.ldlt import ILUT
            self.__native = ILUT(self.__a)
            self.__native.factorize(tol=tol, max_fill=max_fill)
        else:
            import scipy.sparse.linalg as spl
            self.__ilu = spl.spilu(scs.csc_matrix(self.__a), drop_tol=tol,
                                   fill_factor=1.0 + max_fill)

    def factor_nnz(self):
        return self.__native.factor_nnz if self.__native is not None else 0

    def apply(self, x, y):
        if self.__native is None and self.__ilu is None:
            self.factorize()
        xd = np.asarray(_vec_data(x))
        x2 = np.atleast_2d(xd)
        if self.__native is not None:
            if x2.dtype.kind == 'c':
                # real factors: solve real/imag parts as extra RHS rows
                re = self.__native.solve(np.concatenate((x2.real, x2.imag)))
                out = re[:x2.shape[0]] + 1j * re[x2.shape[0]:]
            else:
                out = self.__native.solve(x2)
        else:
            out = self.__ilu.solve(x2.T).T
        out = out.reshape(xd.shape)
        if callable(getattr(y, 'data', None)):   # Vectors
            y.fill(out.astype(xd.dtype, copy=False))
        else:
            y[...] = out


def spectral_bounds(matrix, iters=20, seed=7):
    """(lo, hi) bounds on the spectrum of a symmetric sparse matrix:
    Gershgorin upper bound, and a Lanczos estimate of the smallest
    eigenvalue when Gershgorin's lower bound is non-positive (it is for
    nearly every FE/Laplacian matrix, and a fudged ``lo`` silently degrades
    the Chebyshev polynomial this feeds).  A handful of Lanczos steps gives
    the right order of magnitude, which is all [lo, hi] needs."""
    a = scs.csr_matrix(matrix)
    d = a.diagonal()
    radius = np.abs(a).sum(axis=1).A.ravel() - np.abs(d)
    hi = float((d + radius).max())
    lo = float((d - radius).min())
    if lo <= 0:
        # Lanczos (full orthogonalization at these tiny iteration counts)
        rng = np.random.RandomState(seed)
        n = a.shape[0]
        k = int(min(max(iters, 8), n - 1, 40))
        q = rng.standard_normal(n)
        q /= np.linalg.norm(q)
        Q = np.zeros((k + 1, n))
        Q[0] = q
        alpha = np.zeros(k)
        beta = np.zeros(k)
        j = 0
        for j in range(k):
            w = a @ Q[j]
            alpha[j] = Q[j] @ w
            w -= Q[:j + 1].T @ (Q[:j + 1] @ w)   # full reorthogonalization
            b = np.linalg.norm(w)
            beta[j] = b
            if b <= 1e-12 * hi:
                j += 1
                break
            Q[j + 1] = w / b
        else:
            j = k
        T = np.diag(alpha[:j])
        if j > 1:
            T += np.diag(beta[:j - 1], 1) + np.diag(beta[:j - 1], -1)
        ritz = np.linalg.eigvalsh(T)
        # the smallest Ritz value converges to lmin from above (and slowly
        # on Laplacian-like clustered low ends): take a quarter of it for a
        # safe under-estimate — a 4x margin costs the Chebyshev degree only
        # a factor 2, against the 1e8 condition of the old hi*1e-8 fudge
        lo = 0.25 * float(ritz[0])
        if lo <= 0:
            lo = hi * 1e-8
    return lo, hi


class Chebyshev:
    """Polynomial (Chebyshev) approximation to A^-1 on [lo, hi] applied by
    a short SpMM recurrence — the device-resident, factorization-free
    preconditioner: every application is ``degree`` SpMMs that run entirely
    on device (no host round-trips, no triangular solves)."""

    def __init__(self, matrix, lo, hi, degree=8, arch='cpu',
                 device_matrix=None):
        """``device_matrix`` (optional): a prebuilt device sparse matrix
        (ops/spmm.py) the fused recurrences should use instead of building
        their own — REQUIRED for GSPMD-sharded runs, where the
        preconditioner must close over the same sharded payload as the
        operator (``core.device_solver.shard_operator``) so its SpMM
        routing sees the mesh placement and pins partitionable kernels."""
        self.__op = (matrix if isinstance(matrix, SparseSymmetricMatrix)
                     else SparseSymmetricMatrix(matrix, arch=arch))
        self.__dev_override = device_matrix
        self.lo = float(lo)
        self.hi = float(hi)
        self.degree = int(degree)
        self.__fused = None
        self.__fused_rows = None

    def _device_fused(self):
        """One-jit version of the whole recurrence: ``degree`` SpMMs plus
        all the axpys compile into a single XLA program, so an apply is
        one device dispatch instead of ~4*degree."""
        if self.__fused is not None:
            return self.__fused
        dev = self.__dev_override or self.__op.device_matrix()
        theta = 0.5 * (self.hi + self.lo)
        delta = 0.5 * (self.hi - self.lo)
        sigma1 = theta / delta
        degree = self.degree

        import jax

        @jax.jit
        def run(xt):
            rho = 1.0 / sigma1
            d = xt / theta
            r = xt
            y = None
            for _ in range(degree):
                y = d if y is None else y + d
                r = r - dev.matmat_t(d)
                rho_new = 1.0 / (2.0 * sigma1 - rho)
                d = (rho * rho_new) * d + (2.0 * rho_new / delta) * r
                rho = rho_new
            return y

        self.__fused = run
        return run

    def _device_fused_rows(self):
        """Row-layout twin of ``_device_fused`` for (m, n) row-vector
        blocks: the recurrence is elementwise except for the SpMMs, which
        go through ``matmat_rows`` — direct row-layout DIA, no
        relayouts."""
        if self.__fused_rows is not None:
            return self.__fused_rows
        dev = self.__dev_override or self.__op.device_matrix()
        theta = 0.5 * (self.hi + self.lo)
        delta = 0.5 * (self.hi - self.lo)
        sigma1 = theta / delta
        degree = self.degree

        import jax

        mat = dev.matmat_rows

        @jax.jit
        def run(x):
            rho = 1.0 / sigma1
            d = x / theta
            r = x
            y = None
            for _ in range(degree):
                y = d if y is None else y + d
                r = r - mat(d)
                rho_new = 1.0 / (2.0 * sigma1 - rho)
                d = (rho * rho_new) * d + (2.0 * rho_new / delta) * r
                rho = rho_new
            return y

        self.__fused_rows = run
        return run

    def device_rows_operands(self, m, n=None, dtype=None,
                             stream_bf16=False):
        """Argument-form fused recurrence for superkernel consumers:
        (fn, operands) with ``fn(operands, w)`` applying the whole
        ``degree``-step Chebyshev recurrence to an (m, n) row block.  The
        matrix payload flows through the consumer's jit as ARGUMENTS
        (see ops/spmm.py ``rows_operand_form``), so the compiled
        superkernel contains no matrix literals — pass the pair straight
        to ``core.device_solver.lobpcg(precond=...)``.

        ``stream_bf16`` (opt-in) runs the recurrence's iterates in
        bfloat16 (f32 diagonal values and accumulation inside the SpMM,
        f32 in and out), halving the bytes each SpMM streams.  A
        preconditioner is an APPROXIMATE inverse — its own quality target
        is percent-level — so bf16 iterate rounding need not cost
        convergence (tests/test_device_solver.py pins identical LOBPCG
        iteration counts either way).  It is off by default: on an H100
        (700 W), in the n = 1.28e6 LOBPCG at block width 16, it cut one
        Chebyshev apply from 3.09 to 1.90 ms, about 19 ms of device time
        over the solve's 16 applies, while three warm solves each way
        spread over 0.44 s (2.26-2.70 s off, 2.29-2.46 s on, same 16
        iterations): no end-to-end gain could be shown
        (benches/bench_lobpcg_hbm.py)."""
        import jax.numpy as jnp

        from ..ops.spmm import rows_matmat_operands

        dev = self.__dev_override or self.__op.device_matrix()
        if n is None:
            n = dev.shape[0]
        if dtype is None:
            dtype = jnp.float32
        it_dtype = jnp.bfloat16 if stream_bf16 else dtype
        if hasattr(dev, 'rows_operand_form'):
            mat_fn, ops = dev.rows_operand_form(m, n, dtype=it_dtype)
        else:
            mat_fn, ops = rows_matmat_operands(dev)
        theta = 0.5 * (self.hi + self.lo)
        delta = 0.5 * (self.hi - self.lo)
        sigma1 = theta / delta
        degree = self.degree

        def fn(ops, x):
            x_in = x
            if stream_bf16:
                x = x.astype(jnp.bfloat16)
            rho = 1.0 / sigma1
            d = x / theta
            r = x
            y = None
            for _ in range(degree):
                y = d if y is None else y + d
                r = r - mat_fn(ops, d).astype(x.dtype)
                rho_new = 1.0 / (2.0 * sigma1 - rho)
                d = (rho * rho_new) * d + (2.0 * rho_new / delta) * r
                rho = rho_new
            return y.astype(x_in.dtype)

        return fn, ops

    def apply(self, x, y):
        """y ~= A^-1 x: Chebyshev iteration for A y = x with y0 = 0,
        eigenvalue bounds [lo, hi]."""
        if (self.__op.device_matrix() is not None
                and hasattr(x, 'device_data')):
            xd = x.device_data()
            if _rows_capable(self.__op.device_matrix(), xd):
                y.fill(self._device_fused_rows()(xd))
            else:
                y.fill(self._device_fused()(xd.T).T)
            return
        theta = 0.5 * (self.hi + self.lo)
        delta = 0.5 * (self.hi - self.lo)
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        # allocate work blocks of the same kind as x
        d = _clone_zero(x)      # search direction
        r = _clone_copy(x)      # residual (starts as x, since y0 = 0)
        ay = _clone_zero(x)
        _scale_add(d, r, 1.0 / theta, reset=True)
        _zero(y)
        for _ in range(self.degree):
            _axpy(y, d, 1.0)                 # y += d
            self.__op.apply(d, ay)           # ay = A d
            _axpy(r, ay, -1.0)               # r -= A d
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            coef = rho * rho_new
            _scale_add(d, r, 2.0 * rho_new / delta, scale=coef)
            rho = rho_new

    def preconditioner(self):
        return self


# -- tiny helpers working on either Vectors or ndarrays ---------------------

def _clone_zero(x):
    try:
        v = x.new_vectors(x.nvec())
        v.zero()
        return v
    except AttributeError:
        return np.zeros_like(x)


def _clone_copy(x):
    try:
        return x.clone()
    except AttributeError:
        return x.copy()


def _zero(x):
    try:
        x.zero()
    except AttributeError:
        x[...] = 0


def _axpy(y, x, a):
    try:
        y.add(x, a)
    except AttributeError:
        y += a * x


def _scale_add(d, r, coef_r, scale=0.0, reset=False):
    """d := scale * d + coef_r * r (reset: d := coef_r * r)."""
    try:
        if reset or scale == 0.0:
            d.zero()
        else:
            d.scale(np.full(d.nvec(), 1.0 / scale))
        d.add(r, coef_r)
    except AttributeError:
        if reset or scale == 0.0:
            d[...] = coef_r * r
        else:
            d[...] = scale * d + coef_r * r


class Operator:
    """Vectors-aware adapter for any object exposing apply(ndarray, ndarray)
    (reference sparse_mkl.py:143-154)."""

    def __init__(self, op):
        self.__op = op

    def apply(self, x, y):
        try:
            xd = x.data()
        except AttributeError:
            self.__op.apply(x, y)
            return
        yd = np.empty_like(xd)
        self.__op.apply(xd, yd)
        y.fill(yd)
