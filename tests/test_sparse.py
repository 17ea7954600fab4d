"""Sparse stack tests: SpMM device kernels vs SciPy, native LDL^T,
partial_hevp shift-invert / preconditioned / buckling paths on Laplacian
test matrices with exact-eigenvalue pins
(oracle pattern of reference examples/sparse_evp.py:74-100)."""

import numpy as np
import pytest
import scipy.sparse as scs
import scipy.sparse.linalg as spl

from raleigh_tpu.examples.laplace import lap2d, lap3d, lap3d_eigenvalues


def test_ell_and_bsr_spmm_match_scipy():
    from raleigh_tpu.ops.spmm import EllMatrix, BsrMatrix
    np.random.seed(1)
    a = lap2d(30, 30, 1.0, 1.0)
    n = a.shape[0]
    x = np.random.randn(n, 7).astype(np.float32)
    want = a @ x
    ell = EllMatrix(a)
    got = np.asarray(ell.matmat_t(x))
    assert np.allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    bsr = BsrMatrix(a, bs=64)
    got = np.asarray(bsr.matmat_t(x))
    assert np.allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_sparse_matrix_apply_vectors():
    from raleigh_tpu.algebra.sparse import SparseSymmetricMatrix
    from raleigh_tpu.algebra import dense_numpy, dense_jax
    a = lap2d(20, 20, 1.0, 1.0)
    n = a.shape[0]
    np.random.seed(1)
    xd = np.random.randn(5, n)
    for backend, arch in ((dense_numpy, 'cpu'), (dense_jax, 'gpu')):
        op = SparseSymmetricMatrix(a, arch=arch)
        x = backend.Vectors(xd.astype(np.float64))
        y = backend.Vectors(n, 5, np.float64)
        op.apply(x, y)
        assert np.allclose(y.data(), (a @ xd.T).T, rtol=1e-6, atol=1e-6)


def test_native_ldlt_shift_invert_probe():
    from raleigh_tpu.algebra.sparse import SparseSymmetricSolver
    a = lap3d(10, 10, 10, 1.0, 1.0, 1.0)
    s = SparseSymmetricSolver()
    s.analyse(a, sigma=50.0)
    s.factorize()
    neg, pos = s.inertia()
    w = np.linalg.eigvalsh(a.toarray())
    assert neg == int(np.sum(w < 50.0))
    b = np.random.randn(4, a.shape[0])
    x = np.empty_like(b)
    s.solve(b, x)
    res = (a @ x.T - 50.0 * x.T) - b.T
    assert np.linalg.norm(res) / np.linalg.norm(b) < 1e-10


def test_partial_hevp_smallest_shift_invert():
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp
    a = lap3d(10, 10, 12, 1.0, 1.01, 1.02)
    lmd, x, status = partial_hevp(a, sigma=0, which=6, tol=1e-6, verb=-1)
    assert status == 0
    exact = np.sort(lap3d_eigenvalues(10, 10, 12, 1.0, 1.01, 1.02))[:6]
    assert np.allclose(lmd[:6], exact, rtol=1e-6)
    # eigenvectors: residual check
    r = a @ x[:, :6] - x[:, :6] * lmd[None, :6]
    assert np.linalg.norm(r) < 1e-4 * np.abs(exact[-1])


def test_partial_hevp_interior_shift():
    a = lap3d(8, 8, 8, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(8, 8, 8, 1.0, 1.0, 1.0))
    sigma = float(0.5 * (exact[9] + exact[10]))
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp
    lmd, x, status = partial_hevp(a, sigma=sigma, which=6, tol=1e-6, verb=-1)
    assert status >= 0
    assert len(lmd) >= 6
    # the computed eigenvalues must be the nearest to sigma (compare the
    # multiset of distances — the spectrum has exact distance ties)
    dist_got = np.sort(np.abs(np.asarray(lmd) - sigma))
    dist_exact = np.sort(np.abs(exact - sigma))[:len(lmd)]
    assert np.allclose(dist_got, dist_exact, rtol=1e-6)


def test_partial_hevp_preconditioned():
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp
    from raleigh_tpu.algebra.sparse import IncompleteLU
    a = lap3d(10, 10, 10, 1.0, 1.0, 1.0)
    T = IncompleteLU(a)
    T.factorize(tol=1e-4, max_fill=4)
    lmd, x, status = partial_hevp(a, T=T, which=5, tol=1e-5, verb=-1)
    assert status == 0
    exact = np.sort(lap3d_eigenvalues(10, 10, 10, 1.0, 1.0, 1.0))[:5]
    assert np.allclose(lmd[:5], exact, rtol=1e-4)


def test_partial_hevp_generalized():
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp
    a = lap2d(16, 16, 1.0, 1.0)
    n = a.shape[0]
    b = scs.diags(np.full(n, 2.0), format='csr')
    lmd, x, status = partial_hevp(a, B=b, sigma=0, which=4, tol=1e-6,
                                  verb=-1)
    assert status == 0
    w = spl.eigsh(a, M=b, k=4, sigma=0, which='LM',
                  return_eigenvectors=False)
    assert len(lmd) >= 4
    assert np.allclose(np.sort(lmd)[:4], np.sort(w), rtol=1e-6)


def test_partial_hevp_buckling():
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp
    # buckling pencil: K x = lmd Ks x with K SPD, Ks negative definite;
    # reference convention (partial_hevp.py:239-249): descending lmd, the
    # leading ones being the critical load factors nearest zero
    np.random.seed(1)
    k = lap2d(12, 12, 1.0, 1.0)
    n = k.shape[0]
    ks = scs.diags(np.linspace(-1.0, -2.0, n), format='csr')
    # dense oracle: lmd = -eigvalsh(S^-1 K S^-1), S = sqrt(-Ks)
    s_inv = scs.diags(1.0 / np.sqrt(-ks.diagonal()))
    w = -np.linalg.eigvalsh((s_inv @ k @ s_inv).toarray())
    w_desc = np.sort(w)[::-1]  # nearest zero first (all negative)
    lmd, x, status = partial_hevp(k, B=ks, buckling=True, sigma=-15.0,
                                  which=3, tol=1e-6, verb=-1)
    assert status >= 0
    assert np.allclose(lmd[:3], w_desc[:3], rtol=1e-4)


def test_native_complex_ldlh():
    """Native Hermitian LDL^H engine (zldltmf_*): solve accuracy, exact
    inertia against a dense oracle, and agreement with the real-symmetric
    embedding fallback."""
    from raleigh_tpu.native.ldlt import SparseLDLT
    from raleigh_tpu.algebra.sparse import SparseSymmetricSolver
    from raleigh_tpu.utils import env

    rng = np.random.default_rng(3)
    n = 300
    m = scs.random(n, n, density=0.03, random_state=5).tocoo()
    data = rng.standard_normal(m.nnz) + 1j * rng.standard_normal(m.nnz)
    a = scs.coo_matrix((data, (m.row, m.col)), shape=(n, n)).tocsr()
    a = a + a.conj().T
    a = a + scs.diags((1.0 + 0.1 * rng.standard_normal(n)).astype(complex))

    s = SparseLDLT(a)
    assert s.complex
    s.factorize()
    b = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    x = s.solve(b)
    assert np.abs(a @ x.T - b.T).max() / np.abs(b).max() < 1e-8
    w = np.linalg.eigvalsh(a.toarray())
    assert s.inertia() == (int((w < 0).sum()), int((w > 0).sum()))

    # the high-level solver agrees between the native and embedding routes
    bb = b[:2]
    outs = []
    for emb in (False, True):
        env.complex_via_embedding = emb
        try:
            ss = SparseSymmetricSolver(dtype=np.complex128)
            ss.analyse(a, sigma=0.5)
            ss.factorize()
            xx = np.empty_like(bb)
            ss.solve(bb, xx)
            outs.append((xx.copy(), ss.inertia()))
        finally:
            env.complex_via_embedding = False
    assert np.allclose(outs[0][0], outs[1][0], atol=1e-8)
    assert outs[0][1] == outs[1][1]


def test_partial_hevp_complex_hermitian():
    """Complex Hermitian shift-invert via the native LDL^H
    (reference supports c/z through PARDISO, mkl_wrap.py:137-196)."""
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp
    n = 128
    d = 1j * np.ones(n - 1)
    a = scs.csr_matrix(np.diag(d, 1) - np.diag(d, -1)
                       + np.diag(np.linspace(0, 1, n)))
    w = np.linalg.eigvalsh(a.toarray())
    sigma = 0.3
    lmd, x, status = partial_hevp(a, sigma=sigma, which=4, tol=1e-6, verb=-1)
    assert status >= 0
    near = np.sort(np.abs(w - sigma))[:len(lmd)]
    got = np.sort(np.abs(np.asarray(lmd) - sigma))
    assert np.allclose(got, near, atol=1e-6)
    # residual check
    r = a @ x[:, :4] - x[:, :4] * lmd[None, :4]
    assert np.linalg.norm(r) < 1e-4


def test_fill_reducing_orderings():
    """Native ordering engines (amd.cpp, nd.cpp with FM separator
    refinement and supervariable compression): valid permutations, exact
    symbolic fill counts, and ND beating AMD on a 3D FE-class mesh
    (reference relies on PARDISO's internal METIS for this,
    mkl_wrap.py:411-434)."""
    from raleigh_tpu.native import ldlt

    if not ldlt.native_available():
        pytest.skip('native toolchain unavailable')

    # 3-dofs-per-node FE-class pattern: exercises the supervariable
    # compression (identical closed neighborhoods) + FM refinement path
    a1 = lap3d(9, 9, 9, 1.0, 1.0, 1.0)
    a3 = scs.kron(a1, np.ones((3, 3))) + scs.identity(3 * a1.shape[0])
    # irregular pattern (no compression): random symmetric + diagonal
    rng = np.random.RandomState(3)
    n2 = 600
    r = scs.random(n2, n2, density=0.01, random_state=rng)
    a2 = (r + r.T + scs.identity(n2)).tocsr()
    for a in (a3.tocsr(), a2):
        n = a.shape[0]
        for order_fn in (ldlt.amd_ordering, ldlt.nd_ordering):
            perm = order_fn(a)
            assert sorted(perm.tolist()) == list(range(n))
        fill_nat = ldlt.symbolic_factor_nnz(
            a, np.arange(n, dtype=np.int64))
        fill_best = ldlt.symbolic_factor_nnz(a, ldlt.best_ordering(a))
        assert fill_best <= fill_nat
    # on a 3D mesh past the small-graph regime (where minimum degree is
    # naturally strong), refined ND must beat AMD on exact symbolic
    # fill; the margin grows with size (measured 0.89 at 12^3, 0.75 at
    # 20^3 — the spectral-waist multilevel separators of nd.cpp)
    a12 = scs.kron(lap3d(12, 12, 12, 1.0, 1.0, 1.0), np.ones((3, 3))) \
        + scs.identity(3 * 12 ** 3)
    f_amd = ldlt.symbolic_factor_nnz(a12, ldlt.amd_ordering(a12))
    f_nd = ldlt.symbolic_factor_nnz(a12, ldlt.nd_ordering(a12))
    assert f_nd < f_amd
    # ordering quality feeds through: factorize + solve stays exact
    s = ldlt.SparseLDLT(a3, ordering='nd')
    s.factorize()
    b = rng.standard_normal((4, a3.shape[0]))
    x = s.solve(b)
    resid = np.max(np.abs(a3 @ x.T - b.T)) / np.max(np.abs(b))
    assert resid < 1e-10


def test_native_ilut():
    """Native threshold-ILU (ilut.cpp): exact solve at full fill, per-row
    fill cap honored, preconditioner quality, complex RHS handling
    (reference dcsrilut wrapper semantics, mkl_wrap.py:305-347)."""
    from raleigh_tpu.native import ldlt
    from raleigh_tpu.algebra.sparse import IncompleteLU

    if not ldlt.native_available():
        pytest.skip('native toolchain unavailable')

    a = lap3d(10, 10, 10, 1.0, 1.0, 1.0)
    n = a.shape[0]
    rng = np.random.RandomState(5)
    b = rng.standard_normal((4, n))

    # (1) tiny tol + unbounded fill => a (nearly) exact LU
    full = ldlt.ILUT(a)
    full.factorize(tol=1e-14, max_fill=n)
    x = full.solve(b)
    assert np.linalg.norm(a @ x.T - b.T) / np.linalg.norm(b) < 1e-8

    # (2) the per-row fill cap binds: nnz(L)+nnz(U) <= 2*maxfil*n + n
    tight = ldlt.ILUT(a)
    nnz = tight.factorize(tol=0.0, max_fill=1)
    maxfil = max(1, a.nnz // n)     # max_fill=1 => avg row density
    assert nnz <= (2 * maxfil + 1) * n

    # (3) preconditioner quality: one ILUT apply must reduce the residual
    pre = ldlt.ILUT(a)
    pre.factorize(tol=1e-3, max_fill=4)
    y = pre.solve(b)
    r = b - (a @ y.T).T
    assert np.linalg.norm(r) < 0.5 * np.linalg.norm(b)

    # (4) IncompleteLU front end: complex block via real/imag split
    T = IncompleteLU(a)
    T.factorize(tol=1e-12, max_fill=n)
    bc = (b[:2] + 1j * b[2:]).astype(np.complex128)
    out = np.empty_like(bc)
    T.apply(bc, out)
    assert np.linalg.norm(a @ out.T - bc.T) / np.linalg.norm(bc) < 1e-8

    # (5) single-RHS solve must not alias/overwrite the caller's data
    b1 = b[0].copy()
    x1 = full.solve(b1)
    assert np.array_equal(b1, b[0])
    assert np.allclose(x1, x[0])


def test_partial_hevp_device_jacobi_engine():
    """engine='jacobi': the chunked per-triplet device engine behind the
    partial_hevp front end, std (Chebyshev-preconditioned) and
    generalized — smallest pairs via the negated-operator trick."""
    import scipy.sparse as scs
    import scipy.sparse.linalg as spl
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds
    from raleigh_tpu.examples.laplace import lap3d, lap3d_eigenvalues
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp

    a = lap3d(8, 8, 8, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(8, 8, 8, 1.0, 1.0, 1.0))[:5]
    lo, hi = spectral_bounds(a)
    ch = Chebyshev(a, lo, hi, degree=8, arch='gpu')
    lmd, x, st = partial_hevp(a, T=ch, which=5, tol=1e-8, verb=-1,
                              arch='gpu', engine='jacobi')
    assert st == 0
    assert np.abs(np.sort(lmd)[:5] - exact).max() / exact[-1] < 1e-6

    # generalized pencil: SPD mass-like B
    n = a.shape[0]
    b = scs.diags([np.full(n - 1, 0.1), np.linspace(1.0, 1.5, n),
                   np.full(n - 1, 0.1)], [-1, 0, 1], format='csr')
    lmd_g, xg, st_g = partial_hevp(a, B=b, T=ch, which=4, tol=1e-7,
                                   verb=-1, arch='gpu', engine='jacobi')
    assert st_g == 0
    want = np.sort(spl.eigsh(a, k=4, M=b, sigma=0, which='LM',
                             return_eigenvectors=False))
    assert np.abs(np.sort(lmd_g)[:4] - want).max() / abs(want[-1]) < 1e-5
    # B-orthonormal eigenvectors
    g = xg.T @ (b @ xg)
    assert np.abs(g - np.eye(xg.shape[1])).max() < 1e-5
