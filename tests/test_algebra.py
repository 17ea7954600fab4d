"""Differential tests of the block-vector algebra contract.

Pattern follows the reference's cross-backend oracle tests
(tests/tests_algebra.py:85-477): every contract op is run on the JAX device
backend and compared against straight NumPy formulas (and against the
NumPy host backend), for all four dtypes s/d/c/z.
"""

import numpy as np
import pytest

from raleigh_tpu.algebra import dense_numpy, dense_jax

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
N = 203
NV = 13


def _rand(m, n, dt):
    a = 2 * np.random.rand(m, n) - 1
    if np.dtype(dt).kind == 'c':
        a = a + 1j * (2 * np.random.rand(m, n) - 1)
    return a.astype(dt)


def _tol(dt):
    return 5e-5 if np.dtype(dt).itemsize <= 8 and \
        np.finfo(np.dtype(dt).type(0).real.dtype).eps > 1e-10 else 1e-12


@pytest.fixture(params=[dense_numpy, dense_jax], ids=['numpy', 'jax'])
def backend(request):
    return request.param


@pytest.mark.parametrize('dt', DTYPES)
class TestVectorsContract:

    def test_dot_and_dots(self, backend, dt):
        a = _rand(NV, N, dt)
        b = _rand(NV, N, dt)
        u = backend.Vectors(a.copy())
        v = backend.Vectors(b.copy())
        got = u.dot(v)
        want = b.conj() @ a.T
        assert np.allclose(got, want, rtol=0, atol=_tol(dt) * N)
        got = u.dots(v)
        want = np.einsum('ij,ij->i', b.conj(), a)
        assert np.allclose(got, want, rtol=0, atol=_tol(dt) * N)
        got = u.dots(v, transp=True)
        want = np.einsum('ij,ij->j', b.conj(), a)
        assert np.allclose(got, want, rtol=0, atol=_tol(dt) * NV)

    def test_multiply_add_scale(self, backend, dt):
        a = _rand(NV, N, dt)
        q = _rand(NV, NV - 4, dt)
        u = backend.Vectors(a.copy())
        w = backend.Vectors(N, NV - 4, dt)
        u.multiply(q, w)
        assert np.allclose(w.data(), q.T @ a, atol=_tol(dt) * N)

        v = backend.Vectors(a.copy())
        v.add(u, -0.5)
        assert np.allclose(v.data(), 0.5 * a, atol=_tol(dt) * N)

        v = backend.Vectors(a.copy())
        q2 = _rand(NV, NV, dt)
        v.add(u, -1.0, q2)
        assert np.allclose(v.data(), a - q2.T @ a, atol=_tol(dt) * N)

        v = backend.Vectors(a.copy())
        s = np.arange(NV).astype(np.float64)
        v.add(u, s)
        assert np.allclose(v.data(), a + s[:, None] * a, atol=_tol(dt) * N)

        v = backend.Vectors(a.copy())
        v.scale(np.maximum(s, 0))  # divide, skipping zeros
        want = a.copy()
        want[1:] = a[1:] / s[1:, None]
        assert np.allclose(v.data(), want, atol=_tol(dt) * N)
        v = backend.Vectors(a.copy())
        v.scale(s + 1, multiply=True)
        assert np.allclose(v.data(), (s + 1)[:, None] * a, atol=_tol(dt) * N)

    def test_select_copy_append(self, backend, dt):
        a = _rand(NV, N, dt)
        u = backend.Vectors(a.copy())
        u.select(3, 2)
        assert u.nvec() == 3 and u.selected() == (2, 3)
        assert np.allclose(u.data(), a[2:5])
        w = backend.Vectors(N, 3, dt)
        u.copy(w)
        assert np.allclose(w.data(), a[2:5])
        # indexed copy reads all_data rows, writes at destination window
        w2 = backend.Vectors(N, NV, dt)
        w2.select(3, 1)
        u.copy(w2, ind=np.array([4, 0, 2]))
        assert np.allclose(w2.all_data()[1:4], a[[4, 0, 2]])
        # append
        v = backend.Vectors(a[:2].copy())
        v.append(backend.Vectors(a[5:7].copy()))
        assert v.nvec() == 4
        assert np.allclose(v.all_data(), np.concatenate((a[:2], a[5:7])))

    def test_fill_zero_clone(self, backend, dt):
        u = backend.Vectors(N, NV, dt)
        u.fill_random()
        d = u.data()
        assert d.shape == (NV, N) and np.all(np.abs(d) <= 1.0)
        assert np.std(d.real) > 0.1
        c = u.clone()
        u.select(4, 1)
        u.zero()
        assert np.allclose(u.all_data()[1:5], 0)
        assert not np.allclose(c.data()[1:5], 0)
        u.fill(np.ones((4, N), dtype=dt))
        assert np.allclose(u.all_data()[1:5], 1)

    def test_orthogonalize(self, backend, dt):
        a = _rand(NV, N, dt)
        u = backend.Vectors(a.copy())
        sigma, _ = u.svd()  # u rows now orthonormal
        b = _rand(4, N, dt)
        v = backend.Vectors(b.copy())
        v.orthogonalize(u)
        g = u.dot(v)
        assert np.abs(g).max() < 50 * np.sqrt(_tol(dt))

    def test_svd(self, backend, dt):
        m = 10
        a = _rand(m, N, dt)
        # impose decaying spectrum for a well-defined test
        u0, s0, vh0 = np.linalg.svd(a, full_matrices=False)
        s0 = np.logspace(0, -3, m)
        a = (u0 * s0) @ vh0
        a = a.astype(dt)
        v = backend.Vectors(a.copy())
        sigma, qu = v.svd()
        tol = 1e-3 if np.finfo(np.dtype(dt).type(0).real.dtype).eps > 1e-10 \
            else 1e-9
        assert np.allclose(sigma, s0, rtol=tol * 30, atol=tol)
        # rows of storage are V^H, orthonormal
        vh = v.data()
        assert np.allclose(vh @ vh.conj().T, np.eye(m), atol=50 * tol)
        # reconstruction: a = conj(qu) * sigma @ vh
        rec = (qu.conj() * sigma) @ vh
        assert np.allclose(rec, a, atol=100 * tol)

    def test_matrix_apply(self, backend, dt):
        m, n = 17, N
        a = _rand(m, n, dt)
        x = _rand(5, n, dt)
        A = backend.Matrix(a.copy())
        vx = backend.Vectors(x.copy())
        vy = backend.Vectors(m, 5, dt)
        A.apply(vx, vy)
        assert np.allclose(vy.data(), x @ a.T, atol=_tol(dt) * n)
        z = _rand(5, m, dt)
        vz = backend.Vectors(z.copy())
        vw = backend.Vectors(n, 5, dt)
        A.apply(vz, vw, transp=True)
        assert np.allclose(vw.data(), z @ a.conj(), atol=_tol(dt) * n)
        # Matrix.dots = row norms squared
        assert np.allclose(A.dots(), np.einsum('ij,ij->i', a.conj(), a).real,
                           atol=_tol(dt) * n)


def test_backends_bitwise_random_match():
    """fill_random must be bit-identical across backends (same host RNG)."""
    np.random.seed(7)
    u = dense_numpy.Vectors(64, 5, np.float64)
    u.fill_random()
    np.random.seed(7)
    v = dense_jax.Vectors(64, 5, np.float64)
    v.fill_random()
    assert np.array_equal(u.data(), v.data())


def test_sharded_vectors_match_single():
    """Contract ops on a mesh-sharded storage agree with unsharded ones."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices()[:8])
    mesh = Mesh(devs, ('d',))
    sh = NamedSharding(mesh, P(None, 'd'))
    n = 256
    a = _rand(6, n, np.float32)
    b = _rand(6, n, np.float32)
    u = dense_jax.Vectors(a.copy())
    us = dense_jax.Vectors(n, 6, np.float32, sharding=sh)
    us.fill(a)
    v = dense_jax.Vectors(b.copy())
    vs = dense_jax.Vectors(n, 6, np.float32, sharding=sh)
    vs.fill(b)
    assert np.allclose(us.dot(vs), u.dot(v), atol=1e-5)
    q = _rand(6, 6, np.float32)
    w = dense_jax.Vectors(n, 6, np.float32)
    ws = dense_jax.Vectors(n, 6, np.float32, sharding=sh)
    u.multiply(q, w)
    us.multiply(q, ws)
    assert np.allclose(ws.data(), w.data(), atol=1e-5)
    us.add(vs, -2.0)
    u.add(v, -2.0)
    assert np.allclose(us.data(), u.data(), atol=1e-5)


def test_compensated_gram_accuracy():
    """The compensated accuracy option: f32 storage with
    compensated Gram reductions recovers ~f64 dot products — the pinned
    bound is 1e-10 relative against a float64 oracle at n = 200k, where
    the plain f32 contraction carries ~1e-6."""
    from raleigh_tpu.algebra import dense_jax

    rng = np.random.RandomState(5)
    m, n = 6, 200000
    a64 = rng.standard_normal((m, n)) * np.exp(rng.standard_normal((m, n)))
    b64 = rng.standard_normal((m, n))
    a32, b32 = a64.astype(np.float32), b64.astype(np.float32)
    oracle = b32.astype(np.float64) @ a32.astype(np.float64).T

    va = dense_jax.Vectors(a32, compensated=True)
    vb = dense_jax.Vectors(b32)
    g = va.dot(vb)                     # rows: vb's vectors (contract)
    assert g.dtype == np.float64
    scale = np.abs(oracle).max()
    assert np.abs(g - oracle).max() / scale < 1e-10

    plain = dense_jax.Vectors(a32).dot(vb)
    assert np.abs(plain - oracle).max() / scale > 1e-9   # plain f32 floor

    # per-vector dots, complex pairing, and propagation through clones
    c32 = (a64 + 1j * b64).astype(np.complex64)
    vc = dense_jax.Vectors(c32, compensated=True)
    d = vc.clone().dots(vc)
    dot_oracle = np.einsum('ij,ij->i', c32.conj().astype(np.complex128),
                           c32.astype(np.complex128))
    assert np.abs(d - dot_oracle).max() / np.abs(dot_oracle).max() < 1e-10

    # device-kept consumers stay on the plain device path
    kept = va.dot(vb, keep=True)
    assert kept.dtype == np.float32

    # transposed dots (the per-lane reduction truncated_svd's error
    # tracker consumes): compensated path returns the f64-exact sums of
    # the pairwise products
    small = 2048
    vs = dense_jax.Vectors(a32[:, :small], compensated=True)
    ws = dense_jax.Vectors(b32[:, :small])
    dt = vs.dots(ws, transp=True)
    assert dt.dtype == np.float64
    oracle_t = np.einsum('ij,ij->j', a32[:, :small].astype(np.float64),
                         b32[:, :small].astype(np.float64))
    assert np.abs(dt - oracle_t).max() / np.abs(oracle_t).max() < 1e-12
    plain_t = dense_jax.Vectors(a32[:, :small]).dots(ws, transp=True)
    assert plain_t.dtype == np.float32


def test_compensated_solver_eigenvalues():
    """End-to-end d-class pin (VERDICT r4 #7): the core solver on f32
    device storage with ``compensated=True`` reports ~1e-10-class
    eigenvalues where the plain f32 path floors at ~1e-7 — the final
    compensated Rayleigh-quotient refinement (core/solver.py
    _maybe_refine_eigenvalues) recovers the accuracy the converged
    vectors already carry."""
    import scipy.sparse as scs
    from raleigh_tpu.core.solver import (Options, Problem, Solver,
                                         DefaultConvergenceCriteria)
    from raleigh_tpu.algebra import dense_jax
    from raleigh_tpu.algebra.sparse import SparseSymmetricMatrix

    n = 150_000
    rng = np.random.RandomState(2)
    # exactly-f32 diagonal: separated top pairs over a dense bulk
    d = (1.0 + 0.5 * np.round(rng.rand(n) * 1024) / 1024).astype(np.float32)
    top = np.array([4.0, 3.75, 3.5, 3.25], np.float32)
    d[:4] = top
    A = SparseSymmetricMatrix(scs.diags(d.astype(np.float64)).tocsr(),
                              arch='gpu')

    def run(comp):
        v = dense_jax.Vectors(n, data_type=np.float32, compensated=comp)
        opt = Options()
        opt.convergence_criteria = DefaultConvergenceCriteria()
        opt.convergence_criteria.set_error_tolerance(
            'residual eigenvector error', 1e-8)
        opt.verbosity = -1
        opt.max_iter = 500
        s = Solver(Problem(v, A))
        status = s.solve(v, opt, which=(0, 4))
        assert status == 0
        lmd = np.sort(s.eigenvalues)[::-1][:4]
        return np.abs(lmd - np.sort(top.astype(np.float64))[::-1]).max() / 4.0

    e_comp = run(True)
    e_plain = run(False)
    assert e_comp < 1e-10, e_comp           # d-class from f32 storage
    assert e_plain > 1e-8, e_plain          # the plain-f32 ceiling
