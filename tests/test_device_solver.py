"""Tests for the device-resident LOBPCG engine (core/device_solver.py),
the DIA SpMM layout, and the fused device Chebyshev preconditioner.

These run on the virtual CPU mesh (conftest.py) with x64 enabled; the same
code paths run unchanged on a GPU (float32).
"""

import numpy as np
import pytest

from raleigh_tpu.examples.laplace import lap3d, lap3d_eigenvalues


@pytest.fixture(scope='module')
def lap():
    a = lap3d(10, 10, 10, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(10, 10, 10, 1.0, 1.0, 1.0))
    return a, exact


def test_dia_layout_matches_scipy(lap):
    import jax.numpy as jnp
    from raleigh_tpu.ops.spmm import DiaMatrix, device_sparse

    a, _ = lap
    n = a.shape[0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 5))
    dm = DiaMatrix(a, dtype=np.float64)
    y = np.asarray(dm.matmat_t(jnp.asarray(x)))
    assert np.allclose(y, a @ x, atol=1e-12)
    # the steering picks DIA for a stencil matrix
    assert type(device_sparse(a)).__name__ == 'DiaMatrix'


def test_dia_steering_rejects_scattered_pattern():
    import scipy.sparse as scs
    from raleigh_tpu.ops.spmm import device_sparse

    rng = np.random.default_rng(1)
    a = scs.random(1500, 1500, density=0.01, random_state=3)
    a = a + a.T + scs.eye(1500)
    assert type(device_sparse(a)).__name__ != 'DiaMatrix'


def test_dia_matmat_rows_matches_transposed(lap):
    """Row-layout DIA apply (the relayout-free path SparseSymmetricMatrix
    uses for (m, n) row-vector blocks) against the column-layout kernel
    and the SciPy oracle; also checks the device apply keeps the result
    device-resident through Vectors.fill."""
    import jax.numpy as jnp
    from raleigh_tpu.ops.spmm import DiaMatrix
    from raleigh_tpu.algebra.sparse import SparseSymmetricMatrix
    from raleigh_tpu.algebra import dense_jax

    a, _ = lap
    n = a.shape[0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, n))
    dm = DiaMatrix(a, dtype=np.float64)
    y_rows = np.asarray(dm.matmat_rows(jnp.asarray(x)))
    want = (a @ x.T).T
    assert np.abs(y_rows - want).max() / np.abs(want).max() < 1e-12

    sm = SparseSymmetricMatrix(a, arch='gpu', dtype=np.float64)
    xv = dense_jax.Vectors(x.copy())
    yv = dense_jax.Vectors(np.zeros_like(x))
    sm.apply(xv, yv)
    assert np.abs(yv.data() - want).max() / np.abs(want).max() < 1e-12


def test_fused_chebyshev_matches_host(lap):
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds
    from raleigh_tpu.algebra import dense_jax

    a, _ = lap
    n = a.shape[0]
    lo, hi = spectral_bounds(a)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, n))
    ch = Chebyshev(a, lo, hi, degree=10, arch='cpu')
    yh = np.zeros_like(x)
    ch.apply(x, yh)
    cd = Chebyshev(a, lo, hi, degree=10, arch='gpu')
    xv = dense_jax.Vectors(np.asarray(x))
    yv = dense_jax.Vectors(np.zeros_like(x))
    cd.apply(xv, yv)
    assert np.abs(yv.data() - yh).max() / np.abs(yh).max() < 1e-10


def test_lobpcg_smallest(lap):
    from raleigh_tpu.core.device_solver import lobpcg
    from raleigh_tpu.ops.spmm import device_sparse

    a, exact = lap
    dm = device_sparse(a, dtype=np.float64)
    lam, x, r, it, st = lobpcg(dm, 6, tol=1e-8, maxit=300, dtype=np.float64)
    assert st == 0
    assert np.abs(lam - exact[:6]).max() < 1e-5
    # returned eigenvectors are orthonormal and satisfy the residual
    g = x.T @ x
    assert np.abs(g - np.eye(6)).max() < 1e-8
    assert np.linalg.norm(a @ x - x * lam[None, :], axis=0).max() < \
        1e-8 * exact[-1] * 10


def test_lobpcg_preconditioned_and_f32(lap):
    from raleigh_tpu.core.device_solver import lobpcg
    from raleigh_tpu.ops.spmm import device_sparse
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds

    a, exact = lap
    lo, hi = spectral_bounds(a)
    ch = Chebyshev(a, hi * 1e-4, hi, degree=10, arch='gpu')
    dm = device_sparse(a, dtype=np.float64)
    lam, x, r, it0, st = lobpcg(dm, 6, precond=ch._device_fused_rows(),
                                tol=1e-8, maxit=300, dtype=np.float64)
    assert st == 0
    assert np.abs(lam - exact[:6]).max() < 1e-5

    dm32 = device_sparse(a, dtype=np.float32)
    lam, x, r, it, st = lobpcg(dm32, 6, precond=ch._device_fused_rows(),
                               tol=1e-4, maxit=300, dtype=np.float32)
    assert st == 0
    assert np.abs(lam - exact[:6]).max() / exact[5] < 1e-3


def test_lobpcg_largest(lap):
    from raleigh_tpu.core.device_solver import lobpcg
    from raleigh_tpu.ops.spmm import device_sparse

    a, exact = lap
    dm = device_sparse(a, dtype=np.float64)
    lam, x, r, it, st = lobpcg(dm, 3, largest=True, tol=1e-6, maxit=300,
                               dtype=np.float64)
    assert np.abs(np.sort(lam) - exact[-3:]).max() / exact[-1] < 1e-4


def test_lobpcg_warm_start(lap):
    from raleigh_tpu.core.device_solver import lobpcg
    from raleigh_tpu.ops.spmm import device_sparse

    a, exact = lap
    dm = device_sparse(a, dtype=np.float64)
    lam, x, r, it0, st = lobpcg(dm, 4, tol=1e-6, maxit=300,
                                dtype=np.float64)
    # restart from the converged eigenvectors: should converge immediately
    lam2, x2, r2, it1, st2 = lobpcg(dm, 4, x0=x, tol=1e-6, maxit=300,
                                    dtype=np.float64)
    assert st2 == 0
    assert it1 < it0


def test_lobpcg_iteration_limit(lap):
    from raleigh_tpu.core.device_solver import lobpcg
    from raleigh_tpu.ops.spmm import device_sparse

    a, _ = lap
    dm = device_sparse(a, dtype=np.float64)
    lam, x, r, it, st = lobpcg(dm, 6, tol=1e-14, maxit=8, chunk=4,
                               dtype=np.float64)
    assert st == 2 and it == 8


def test_lobpcg_sharded_mesh(lap):
    """The whole superkernel partitions over a device mesh via GSPMD:
    shard the DIA values and the iteration block along the vector
    dimension — no solver changes (SURVEY §5.8 sharded-Vectors design)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from raleigh_tpu.core.device_solver import lobpcg, shard_operator
    from raleigh_tpu.ops.spmm import device_sparse

    a, exact = lap
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip('needs a multi-device mesh')
    mesh = Mesh(np.array(devs), ('chips',))
    dm = shard_operator(device_sparse(a, dtype=np.float64), mesh)
    lam, x, r, it, st = lobpcg(
        dm, 6, tol=1e-8, maxit=300, dtype=np.float64,
        sharding=NamedSharding(mesh, P('chips', None)))
    assert st == 0
    assert np.abs(lam - exact[:6]).max() < 1e-6


def test_partial_hevp_device_engine(lap):
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds

    a, exact = lap
    lo, hi = spectral_bounds(a)
    T = Chebyshev(a, hi * 1e-4, hi, degree=10, arch='gpu')
    lmd, x, status = partial_hevp(a, T=T, which=5, tol=1e-6, verb=-1,
                                  arch='gpu', engine='device')
    assert status == 0
    assert np.abs(np.sort(lmd)[:5] - exact[:5]).max() / exact[4] < 1e-4
    # engine='device' without a jit-traceable preconditioner is an error
    with pytest.raises(ValueError):
        partial_hevp(a, T=T, which=5, arch='cpu', engine='device')


def test_lobpcg_generalized():
    """Generalized pencil A x = lmd B x on the device engine: B-inner
    iteration, B-orthonormal result (reference problem type 'gen',
    core/solver.py:224-258)."""
    import scipy.sparse as scs
    import scipy.sparse.linalg as spl
    from raleigh_tpu.core.device_solver import lobpcg
    from raleigh_tpu.ops.spmm import device_sparse
    from raleigh_tpu.examples.laplace import lap2d

    a = lap2d(20, 20, 1.0, 1.0)
    n = a.shape[0]
    rng = np.random.RandomState(2)
    b = scs.diags(1.0 + rng.rand(n), format='csr')
    dmA = device_sparse(a, dtype=np.float64)
    dmB = device_sparse(b, dtype=np.float64)
    lam, x, r, it, st = lobpcg(dmA, 6, opB=dmB, tol=1e-6, maxit=300,
                               dtype=np.float64)
    assert st == 0
    w = np.sort(spl.eigsh(a, M=b, k=6, sigma=0, which='LM',
                          return_eigenvectors=False))
    assert np.abs(np.sort(lam) - w).max() / w.max() < 1e-6
    g = x.T @ (b @ x)
    assert np.abs(g - np.eye(6)).max() < 1e-6


def test_lobpcg_constraints_deflate():
    """Warm restart on device: prior eigenvectors passed as constraints
    deflate the iteration, so the solver returns the NEXT pairs
    (reference core/solver.py:112-114,743-757)."""
    import scipy.sparse as scs
    import scipy.sparse.linalg as spl
    from raleigh_tpu.core.device_solver import lobpcg
    from raleigh_tpu.ops.spmm import device_sparse
    from raleigh_tpu.examples.laplace import lap2d

    a = lap2d(20, 20, 1.0, 1.0)
    n = a.shape[0]
    rng = np.random.RandomState(2)
    b = scs.diags(1.0 + rng.rand(n), format='csr')
    dmA = device_sparse(a, dtype=np.float64)
    dmB = device_sparse(b, dtype=np.float64)
    lam, x, _, _, st = lobpcg(dmA, 6, opB=dmB, tol=1e-6, maxit=300,
                              dtype=np.float64)
    assert st == 0
    lam2, x2, _, _, st2 = lobpcg(dmA, 4, opB=dmB, constraints=x,
                                 tol=1e-6, maxit=300, dtype=np.float64)
    assert st2 == 0
    w = np.sort(spl.eigsh(a, M=b, k=10, sigma=0, which='LM',
                          return_eigenvectors=False))
    assert np.abs(np.sort(lam2) - w[6:10]).max() / w.max() < 1e-6
    # constrained result is B-orthogonal to the constraint span
    assert np.abs(x.T @ (b @ x2)).max() < 1e-6


def test_lobpcg_overiteration_stays_finite():
    """Requesting a tolerance below the engine's accuracy floor must end
    in a finite result (stall detection / non-finite rollback), never
    NaN."""
    import scipy.sparse as scs
    from raleigh_tpu.core.device_solver import lobpcg
    from raleigh_tpu.ops.spmm import device_sparse
    from raleigh_tpu.examples.laplace import lap2d

    a = lap2d(20, 20, 1.0, 1.0)
    n = a.shape[0]
    rng = np.random.RandomState(2)
    b = scs.diags(1.0 + rng.rand(n), format='csr')
    dmA = device_sparse(a, dtype=np.float64)
    dmB = device_sparse(b, dtype=np.float64)
    lam, x, r, it, st = lobpcg(dmA, 6, opB=dmB, tol=1e-15, maxit=400,
                               dtype=np.float64)
    assert np.all(np.isfinite(lam)) and np.all(np.isfinite(x))
    lam2, x2, r2, it2, st2 = lobpcg(dmA, 4, opB=dmB, constraints=x,
                                    tol=1e-15, maxit=400,
                                    dtype=np.float64)
    assert np.all(np.isfinite(lam2)) and np.all(np.isfinite(x2))
    # both runs stalled out early instead of burning maxit
    assert it + it2 < 800


def test_partial_hevp_generalized_device_engine():
    """partial_hevp routes generalized preconditioned problems through
    the device LOBPCG superkernel (VERDICT round-1 item 6)."""
    import scipy.sparse as scs
    import scipy.sparse.linalg as spl
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds
    from raleigh_tpu.examples.laplace import lap2d

    a = lap2d(16, 16, 1.0, 1.0)
    n = a.shape[0]
    rng = np.random.RandomState(4)
    b = scs.diags(1.0 + rng.rand(n), format='csr')
    lo, hi = spectral_bounds(a)
    T = Chebyshev(a, hi * 1e-4, hi, degree=10, arch='gpu')
    lmd, x, status = partial_hevp(a, B=b, T=T, which=5, tol=1e-6,
                                  verb=-1, arch='gpu', engine='device')
    assert status == 0
    w = np.sort(spl.eigsh(a, M=b, k=5, sigma=0, which='LM',
                          return_eigenvectors=False))
    assert np.abs(np.sort(lmd)[:5] - w).max() / w.max() < 1e-4


def test_device_jacobi_generalized():
    """The chunked per-triplet engine on a generalized pencil A x = lmd B x:
    the whole iteration runs in the B-inner product with tracked B-images
    (VERDICT r3 item 5) — eigenvalues match scipy's dense eigh(A, B) and
    the returned vectors are B-orthonormal."""
    import jax.numpy as jnp
    import scipy.linalg as sla
    from raleigh_tpu.core.device_jacobi import DeviceJacobi
    from raleigh_tpu.core.solver import Options, DefaultConvergenceCriteria
    from raleigh_tpu.algebra import dense_jax

    n = 400
    rng = np.random.RandomState(3)
    q = rng.standard_normal((n, n)) * 0.05
    A = np.diag(np.linspace(1.0, 60.0, n)) + (q + q.T)
    c = 0.2 * rng.standard_normal(n - 1)
    B = np.diag(np.linspace(1.0, 2.0, n))
    B[np.arange(n - 1), np.arange(1, n)] = c
    B[np.arange(1, n), np.arange(n - 1)] = c          # SPD mass-like

    def matmat(ops, x):
        return jnp.matmul(x, ops[0].T)

    engine = DeviceJacobi(matmat, n, dtype=np.float64,
                          operands=(jnp.asarray(A),),
                          matmat_b=matmat,
                          operands_b=(jnp.asarray(B),))
    v = dense_jax.Vectors(n, data_type=np.float64)
    opt = Options()
    opt.convergence_criteria = DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('k eigenvector error',
                                                 1e-8)
    opt.max_iter = 300
    st = engine.solve(v, options=opt, nwanted=5)
    assert st == 0
    exact = sla.eigh(A, B, eigvals_only=True)
    got = np.sort(engine.eigenvalues)[-5:]
    assert np.abs(got - exact[-5:]).max() / abs(exact[-1]) < 1e-6
    # returned eigenvectors are B-orthonormal rows
    X = v.data()
    g = X @ B @ X.T
    assert np.abs(g - np.eye(X.shape[0])).max() < 1e-6
    # per-triplet observability intact (Solver-compatible surface)
    assert engine.residual_norms.shape[0] == engine.rcon
    assert engine.eigenvalue_errors.kinematic.shape[0] == engine.rcon


def test_device_sparse_hub_rows_avoid_ell():
    """A degree-skewed pattern (hub rows) must not route to ELL, whose
    max-degree padding would inflate storage arbitrarily."""
    import scipy.sparse as scs
    from raleigh_tpu.ops.spmm import device_sparse

    rng = np.random.default_rng(2)
    n = 2000
    a = scs.random(n, n, density=0.002, random_state=1, format='lil')
    a[0, :] = 1.0                      # hub row coupled to everything
    a = scs.csr_matrix(a)
    a = a + a.T + scs.eye(n)
    dm = device_sparse(a)
    assert type(dm).__name__ != 'EllMatrix'


def test_lobpcg_bf16_streamed_precond(lap):
    """Chebyshev preconditioner with bf16-streamed iterates (f32 values
    and accumulation): preconditioner quality is percent-level by
    design, so the solver converges to the same accuracy."""
    from raleigh_tpu.core.device_solver import lobpcg
    from raleigh_tpu.ops.spmm import device_sparse
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds

    a, exact = lap
    lo, hi = spectral_bounds(a)
    ch = Chebyshev(a, hi * 1e-4, hi, degree=10, arch='gpu')
    dm = device_sparse(a, dtype=np.float64)
    pre = ch.device_rows_operands(8, a.shape[0], dtype=np.dtype('float64'),
                                  stream_bf16=True)
    lam, x, r, it, st = lobpcg(dm, 6, precond=pre, block_size=8,
                               tol=1e-8, maxit=300, dtype=np.float64)
    assert st == 0
    assert np.abs(lam - exact[:6]).max() < 1e-5


def test_operand_forms_embed_no_matrix_literals():
    """The argument-form applies must not capture matrix payloads as
    jaxpr constants: a compiled-in literal means a fresh compile per
    matrix and (at large sizes) programs carrying hundreds of MB of
    constants."""
    import jax
    import jax.numpy as jnp
    from raleigh_tpu.ops.spmm import DiaMatrix
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds
    from raleigh_tpu.examples.laplace import lap2d

    a = lap2d(32, 32, 1.0, 1.0)
    d = DiaMatrix(a)
    n = d.shape[0]
    m = 8
    x = jnp.zeros((m, n), jnp.float32)

    def const_bytes(jaxpr):
        return sum(np.asarray(c).nbytes for c in jaxpr.consts
                   if hasattr(c, 'nbytes') or isinstance(c, np.ndarray))

    fn, ops = d.rows_operand_form(m, n)
    jx = jax.make_jaxpr(fn)(ops, x)
    assert const_bytes(jx) < 1 << 16, const_bytes(jx)

    lo, hi = spectral_bounds(a)
    ch = Chebyshev(a, lo, hi, degree=6, arch='gpu')
    pfn, pops = ch.device_rows_operands(m, n)
    jx2 = jax.make_jaxpr(pfn)(pops, x)
    assert const_bytes(jx2) < 1 << 16, const_bytes(jx2)


def test_device_sparse_hbm_prefers_bsr_over_ell():
    """At every size the steering compares predicted apply times
    (``BSR_TILE_BYTES_PER_S`` against ``ELL_NNZ_PER_S``): an FE-like
    block pattern with a few long-range couplings routes to BSR, and the
    same pattern scattered by many more couplings (tile fill below the
    rates' crossover, ~1 %) routes to ELL."""
    import scipy.sparse as scs
    from raleigh_tpu.ops import spmm as sp

    def fe_like(ncoup):
        rng = np.random.default_rng(4)
        g = 12
        adj = scs.csr_matrix(lap3d(g, g, g, 1.0, 1.0, 1.0))
        adj.data[:] = 1.0
        # sprinkle irregular long-range couplings so the pattern does not
        # collapse onto few diagonals (DIA would otherwise win, correctly)
        nn = adj.shape[0]
        r = rng.integers(0, nn, size=(ncoup, 2))
        extra = scs.coo_matrix((np.ones(ncoup), (r[:, 0], r[:, 1])),
                               shape=adj.shape).tocsr()
        adj = ((adj + extra + extra.T) != 0).astype(np.float64)
        blk = scs.kron(adj, np.ones((3, 3)), format='csr')
        blk.data = rng.standard_normal(blk.data.size) * 0.01
        return (blk + blk.T) * 0.5

    a = fe_like(100)
    dm = sp.device_sparse(a)
    assert type(dm).__name__ == 'BsrMatrix'
    # the same pattern, built and applied as BSR, matches scipy
    x = np.random.default_rng(5).standard_normal((a.shape[0], 4))
    np.testing.assert_allclose(np.asarray(dm.matmat_t(x)), a @ x,
                               rtol=1e-4, atol=1e-5)
    # below the fill crossover ELL's predicted time wins
    dm3 = sp.device_sparse(fe_like(3000))
    assert type(dm3).__name__ == 'EllMatrix'


@pytest.mark.parametrize('nc', [8, 16, 39])
def test_fe_pattern_routes_to_bsr(nc):
    """The FE stiffness pattern in the mesher's node order (tile fill
    4.5-7.6 %) routes to BSR at every size: on an H100 BSR applied the
    n = 139k flagship 4.4x faster than ELL.  Randomly relabelled (fill
    0.08 %, 40 GB of tiles) it routes to ELL."""
    from raleigh_tpu.examples.fe_model import fe_pencil
    from raleigh_tpu.ops.spmm import _to_full_csr, sparse_layout

    k = fe_pencil(nc, 6, 0.10, 7, which='k', relabel=False)
    assert sparse_layout(_to_full_csr(k)) == 'bsr'
    if nc == 39:
        k = fe_pencil(nc, 6, 0.10, 7, which='k', relabel=True)
        assert sparse_layout(_to_full_csr(k)) == 'ell'


def test_bsr_bf16_blocks_f32_accumulate():
    """Opt-in bf16 BSR tiles: halves the tile-stream bytes while the
    tile contraction accumulates in f32;
    the product matches scipy at bf16 storage precision."""
    import jax.numpy as jnp
    import scipy.sparse as scs
    from raleigh_tpu.ops.spmm import BsrMatrix

    rng = np.random.default_rng(1)
    a = scs.random(700, 700, density=0.05, random_state=2, format='csr')
    a = a + a.T + scs.eye(700)
    d = BsrMatrix(a, dtype=jnp.bfloat16, bs=128)
    assert d.blocks.dtype == jnp.bfloat16
    x = rng.standard_normal((700, 8)).astype(np.float32)
    y = np.asarray(d.matmat_t(jnp.asarray(x)))
    want = a @ x
    assert y.dtype == np.float32
    assert np.abs(y - want).max() / np.abs(want).max() < 2e-2


def test_lobpcg_constraints_with_shape_rigid_operand_form(lap):
    """The operand-form apply may be compiled for exactly (m, n) blocks;
    constraint blocks have a different row count and must go through the
    shape-flexible apply instead."""
    import jax.numpy as jnp
    from raleigh_tpu.core.device_solver import lobpcg
    from raleigh_tpu.ops.spmm import DiaMatrix

    a, exact = lap
    dm = DiaMatrix(a, dtype=np.float64)

    class RigidOp:
        """DiaMatrix stand-in whose operand-form asserts the block shape,
        like a kernel built for (m, n) would."""
        shape = dm.shape
        offsets = dm.offsets
        val = dm.val

        def _multi_device(self):
            return False

        def matmat_rows(self, x):
            return dm.matmat_rows(x)

        def rows_operand_form(self, m, n, dtype=None):
            def fn(ops, x):
                assert x.shape[0] == m, 'operand-form called off-shape'
                return dm.matmat_rows(x)
            return fn, ()

    op = RigidOp()
    lam0, x0v, r0, it0, st0 = lobpcg(op, 3, tol=1e-8, maxit=300,
                                     dtype=np.float64)
    assert st0 == 0
    # warm restart: the 3 converged vectors become constraints (nc=3
    # rows != block m) — before the fix this crashed the rigid apply
    lam1, x1, r1, it1, st1 = lobpcg(op, 3, constraints=x0v, tol=1e-7,
                                    maxit=300, dtype=np.float64)
    assert st1 == 0
    assert np.abs(lam1 - exact[3:6]).max() / exact[5] < 1e-5


def test_device_jacobi_gen_restart_path(monkeypatch):
    """Fault-inject a failed orthonormality check so the B-mode
    Ritz-quality restart branch runs (re-whiten via entry_fix, fresh
    images, reset conjugate directions) and the solve still converges."""
    import jax
    import jax.numpy as jnp
    import scipy.linalg as sla
    import raleigh_tpu.core.device_jacobi as dj
    from raleigh_tpu.core.solver import Options, DefaultConvergenceCriteria
    from raleigh_tpu.algebra import dense_jax

    n = 200
    rng = np.random.RandomState(7)
    q = rng.standard_normal((n, n)) * 0.05
    A = np.diag(np.linspace(1.0, 40.0, n)) + (q + q.T)
    B = np.diag(np.linspace(1.0, 2.0, n))

    def matmat(ops, x):
        return jnp.matmul(x, ops[0].T)

    engine = dj.DeviceJacobi(matmat, n, dtype=np.float64,
                             operands=(jnp.asarray(A),),
                             matmat_b=matmat,
                             operands_b=(jnp.asarray(B),))
    orig_get = jax.device_get
    forced = {'n': 0}

    def fake_get(x):
        vals = orig_get(x)
        if (isinstance(vals, tuple) and len(vals) == 5
                and forced['n'] == 0):
            forced['n'] += 1
            return vals[:4] + (np.float64(1.0),)   # fake huge gram error
        return vals

    monkeypatch.setattr(jax, 'device_get', fake_get)
    v = dense_jax.Vectors(n, data_type=np.float64)
    opt = Options()
    opt.convergence_criteria = DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('k eigenvector error',
                                                 1e-8)
    opt.max_iter = 300
    st = engine.solve(v, options=opt, nwanted=4)
    assert forced['n'] == 1                        # restart was taken
    assert st == 0
    exact = sla.eigh(A, B, eigvals_only=True)
    assert np.abs(np.sort(engine.eigenvalues)[-4:] - exact[-4:]).max() \
        / abs(exact[-1]) < 1e-6


def test_device_jacobi_one_sync_per_chunk():
    """The chunked engine's only per-chunk host round trip is the single
    stats fetch: a solve of C chunks performs exactly C device_get calls
    (VERDICT r4 #4 — the engine must not pay a second fetch per
    iteration; the per-iteration history rides the chunk fetch)."""
    import jax.numpy as jnp
    from raleigh_tpu.core import device_jacobi as dj
    from raleigh_tpu.core.solver import Options, DefaultConvergenceCriteria
    from raleigh_tpu.algebra import dense_jax

    n = 400
    d = jnp.asarray(np.linspace(1.0, 40.0, n).astype(np.float32))

    def matmat(ops, x):
        return x * ops[0][None, :]

    eng = dj.DeviceJacobi(matmat, n, dtype=np.float32, operands=(d,))
    v = dense_jax.Vectors(n, data_type=np.float32)
    opt = Options()
    opt.convergence_criteria = DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('k eigenvector error', 1e-6)
    opt.verbosity = -1

    calls = [0]
    orig = dj.jax.device_get

    def counting_get(x):
        calls[0] += 1
        return orig(x)

    dj.jax.device_get = counting_get
    try:
        status = eng.solve(v, options=opt, nwanted=5, chunk=8)
    finally:
        dj.jax.device_get = orig
    assert status == 0
    chunks = -(-eng.iteration // 8)
    assert calls[0] == chunks, (calls[0], chunks, eng.iteration)
    # and the fetch count per iteration is well under 1
    assert calls[0] <= eng.iteration / 4


def test_bf16_auto_routing_and_iteration_parity(lap):
    """bf16 operand streaming of the Chebyshev iterates is opt-in (the
    default keeps the iteration dtype), and its accuracy guard is
    iteration-count parity — a preconditioner is percent-level by
    design, so bf16 iterates must not change the outer iteration count."""
    import jax
    import jax.numpy as jnp
    from raleigh_tpu.core.device_solver import lobpcg
    from raleigh_tpu.ops.spmm import device_sparse
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds

    a, exact = lap
    n = a.shape[0]
    lo, hi = spectral_bounds(a)
    ch = Chebyshev(a, hi * 1e-4, hi, degree=10, arch='gpu')
    dm = device_sparse(a)

    # accuracy guard: identical iteration counts either way at the
    # tolerances of large solves (1e-4/1e-5; far past that the weaker
    # bf16 inverse starts costing iterations)
    for tol in (1e-4, 1e-5):
        lam = {}
        its = {}
        for flag in (False, True):
            pre = ch.device_rows_operands(8, n, stream_bf16=flag)
            lmd, x, r, it, st = lobpcg(dm, 6, precond=pre, block_size=8,
                                       tol=tol, maxit=300)
            assert st == 0
            lam[flag], its[flag] = lmd, it
        assert its[True] == its[False], (tol, its)
        assert np.abs(lam[True] - lam[False]).max() < 1e-3 * hi

    # routing: the default keeps f32 iterates, the flag streams bf16
    x0 = jnp.zeros((8, n), jnp.float32)
    fn, ops = ch.device_rows_operands(8, n)
    assert 'bf16' not in str(jax.make_jaxpr(fn)(ops, x0))
    fn2, ops2 = ch.device_rows_operands(8, n, stream_bf16=True)
    assert 'bf16' in str(jax.make_jaxpr(fn2)(ops2, x0))


def test_dia_matmat_rows_large_working_set():
    """Above the 112 MiB working set where the DIA product once changed
    kernels, ``matmat_rows`` is the same fused XLA map: it matches the
    fused kernel bit for bit and scipy to f32 rounding, and keeps the
    operand dtype (bf16 in, bf16 out)."""
    import jax.numpy as jnp
    from raleigh_tpu.ops.spmm import DiaMatrix, _dia_matmat_rows

    a = lap3d(100, 100, 150, 1.0, 1.0, 1.0) * (1.0 / 12.0)
    d = DiaMatrix(a)
    n = d.shape[0]
    m = 8
    assert 2 * m * n * 4 + len(d.offsets) * n * 4 > 112 * 2 ** 20
    x = np.random.default_rng(5).standard_normal((m, n)).astype(np.float32)
    xd = jnp.asarray(x)
    y = np.asarray(d.matmat_rows(xd))
    assert y.dtype == np.float32
    assert np.array_equal(y, np.asarray(_dia_matmat_rows(d.val, xd,
                                                         d.offsets)))
    ref = (a @ x.T.astype(np.float64)).T
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()
    yb = d.matmat_rows(xd.astype(jnp.bfloat16))
    assert yb.dtype == jnp.bfloat16
