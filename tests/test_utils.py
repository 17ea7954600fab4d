"""Tests for checkpoint/resume, profiling, the Chebyshev preconditioner
and spectral bounds."""

import os

import numpy as np
import pytest

from raleigh_tpu.examples.laplace import lap2d, lap3d, lap3d_eigenvalues


def test_checkpoint_roundtrip_and_warm_restart(tmp_path):
    from raleigh_tpu.core.solver import (Options, Problem, Solver,
                                         DefaultConvergenceCriteria)
    from raleigh_tpu.algebra import dense_numpy
    from raleigh_tpu.utils.checkpoint import save_eigenpairs, load_eigenpairs

    n = 100
    a = np.arange(1, n + 1).astype(np.float64)
    A = dense_numpy.Matrix(np.diag(a))
    v = dense_numpy.Vectors(n, data_type=np.float64)
    opt = Options()
    opt.convergence_criteria = DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('eigenvector error', 1e-8)
    opt.verbosity = -1
    solver = Solver(Problem(v, A))
    assert solver.solve(v, opt, which=(3, 0)) == 0
    path = str(tmp_path / 'ckpt.npz')
    save_eigenpairs(path, solver, v)

    lmd, v2, info = load_eigenpairs(path)
    assert np.allclose(np.sort(lmd)[:3], [1, 2, 3], atol=1e-6)
    # resume: compute 3 more pairs constrained against the checkpoint
    solver2 = Solver(Problem(v2, A))
    assert solver2.solve(v2, opt, which=(3, 0)) == 0
    assert np.allclose(np.sort(solver2.eigenvalues)[:3], [4, 5, 6],
                       atol=1e-5)


def test_lra_checkpoint(tmp_path):
    from raleigh_tpu.utils.checkpoint import save_lra, load_lra
    from raleigh_tpu.interfaces.pca import pca, pca_error
    from raleigh_tpu.examples.generate_matrix import generate

    np.random.seed(1)
    A, *_ = generate(600, 400, 200, pca=True)
    mean, trans, comps = pca(A[:500], npc=40)
    path = str(tmp_path / 'lra.npz')
    save_lra(path, mean, trans, comps)
    mean2, trans2, comps2 = load_lra(path)
    mean3, trans3, comps3 = pca(A[500:], have=(mean2, trans2, comps2))
    em, ef = pca_error(A, mean3, trans3, comps3)
    assert ef < 0.5


def test_spectral_bounds_and_chebyshev():
    from raleigh_tpu.algebra.sparse import (Chebyshev, spectral_bounds,
                                            SparseSymmetricMatrix)
    a = lap2d(16, 16, 1.0, 1.0)
    lo, hi = spectral_bounds(a)
    w = np.linalg.eigvalsh(a.toarray())
    assert hi >= w[-1] * 0.999
    assert lo <= max(w[0], hi * 1e-8) * 1.001 + 1e-12

    # Chebyshev approximate inverse reduces the residual of A y = x
    cheb = Chebyshev(a, w[0] * 0.9, w[-1] * 1.1, degree=30)
    np.random.seed(1)
    x = np.random.randn(4, a.shape[0])
    y = np.zeros_like(x)
    cheb.apply(x, y)
    r = x - y @ a.T.toarray()
    assert np.linalg.norm(r) < 0.9 * np.linalg.norm(x)


def test_chebyshev_preconditioned_hevp():
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds
    a = lap3d(8, 8, 8, 1.0, 1.0, 1.0)
    lo, hi = spectral_bounds(a)
    T = Chebyshev(a, hi * 1e-4, hi, degree=12)
    lmd, x, status = partial_hevp(a, T=T, which=4, tol=1e-5, verb=-1)
    assert status == 0
    exact = np.sort(lap3d_eigenvalues(8, 8, 8, 1.0, 1.0, 1.0))[:4]
    assert np.allclose(lmd[:4], exact, rtol=1e-4)


def test_timers_and_timed_operator():
    from raleigh_tpu.utils.profiling import Timers, TimedOperator
    from raleigh_tpu.algebra import dense_numpy

    t = Timers()
    with t('phase'):
        pass
    assert t.count['phase'] == 1
    A = dense_numpy.Matrix(np.eye(8))
    op = TimedOperator(A, 'apply')
    x = dense_numpy.Vectors(np.ones((2, 8)))
    y = dense_numpy.Vectors(8, 2, np.float64)
    op.apply(x, y)
    assert op.calls == 1 and np.allclose(y.data(), 1)
    assert op.shape() == (8, 8)


def test_device_activity_reduction():
    """Busy time is the union of the stream lines' intervals (overlaps
    and the 'XLA Ops' mirror line counted once); host planes are
    ignored; per-operation seconds are summed across streams."""
    from jax.profiler import ProfileData
    from raleigh_tpu.utils.profiling import device_activity

    def ev(mid, start_us, dur_us):
        return ('events { metadata_id: %d offset_ps: %d duration_ps: %d }'
                % (mid, start_us * 10 ** 6, dur_us * 10 ** 6))

    meta = ''.join('event_metadata { key: %d value { id: %d name: "%s" } }'
                   % (i, i, name) for i, name in
                   ((1, 'spmm_fusion'), (2, 'gemm'), (3, 'copy')))
    space = (
        'planes { id: 1 name: "/device:GPU:0" '
        'lines { id: 1 name: "Stream #1(compute)" timestamp_ns: 0 %s %s %s }'
        'lines { id: 2 name: "Stream #2(memcpy)" timestamp_ns: 0 %s }'
        'lines { id: 3 name: "XLA Ops" timestamp_ns: 0 %s } %s }'
        'planes { id: 2 name: "/host:CPU" '
        'lines { id: 1 name: "python" timestamp_ns: 0 %s } %s }'
        % (ev(1, 0, 10), ev(2, 20, 5), ev(1, 40, 10), ev(3, 22, 10),
           ev(2, 100, 50), meta, ev(3, 0, 1000), meta))
    out = device_activity(ProfileData.from_text_proto(space))
    assert list(out) == ['/device:GPU:0']
    gpu = out['/device:GPU:0']
    # [0,10] + [20,32] + [40,50] microseconds
    assert gpu['busy_s'] == pytest.approx(32e-6)
    assert gpu['span_s'] == pytest.approx(50e-6)
    assert gpu['events'] == 4
    name, secs, count = gpu['ops'][0]
    assert (name, count) == ('spmm_fusion', 2)
    assert secs == pytest.approx(20e-6)


def test_link_probe_and_orchestration_choice():
    """The host-vs-device orchestration decision for the shift-invert
    iteration is measured, not hard-coded.  On the CPU test platform the
    device is co-located -> 'device'; with a fake slow link in the probe
    cache the same model picks 'host'."""
    from raleigh_tpu.utils import link

    info = link.probe_link(force=True)
    assert info['colocated']                # JAX_PLATFORMS=cpu in tests
    assert link.choose_orchestration(125000, 32) == 'device'

    saved = link._CACHE
    try:
        link._CACHE = dict(colocated=False, up_bytes_per_s=8e6,
                           down_bytes_per_s=8e6, rtt_s=0.03,
                           platform='gpu')
        # 125k-dim, block 32: ~64 MB/iteration over 8 MB/s -> host wins
        assert link.choose_orchestration(125000, 32) == 'host'
        # co-located rates: device wins
        link._CACHE = dict(colocated=False, up_bytes_per_s=5e10,
                           down_bytes_per_s=5e10, rtt_s=2e-5,
                           platform='gpu')
        assert link.choose_orchestration(125000, 32) == 'device'
    finally:
        link._CACHE = saved


def test_partial_hevp_device_orchestrated_shift_invert():
    """The device-orchestrated shift-invert path (core Solver on device
    Vectors + host LDL^T bridge) is exercised end-to-end: on the
    co-located CPU platform the measured-link decision keeps arch='gpu'
    on device Vectors and the eigenvalues match the exact spectrum."""
    import numpy as np
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp
    from raleigh_tpu.examples.laplace import lap3d, lap3d_eigenvalues

    a = lap3d(8, 8, 10, 1.0, 1.0, 1.0)
    lmd, x, status = partial_hevp(a, sigma=0, which=5, tol=1e-8,
                                  arch='gpu', verb=-1)
    assert status == 0
    exact = np.sort(lap3d_eigenvalues(8, 8, 10, 1.0, 1.0, 1.0))[:5]
    assert np.allclose(lmd[:5], exact, rtol=1e-6)


@pytest.mark.parametrize('env_set', [True, False], ids=['env', 'checkout'])
def test_use_compile_cache(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is used as it is and nothing
    is set in code; otherwise the cache goes to <checkout>/.xla_cache,
    resolved from the package's own path."""
    import jax
    from raleigh_tpu.utils import env

    before = jax.config.jax_compilation_cache_dir
    calls = []
    monkeypatch.setattr(jax.config, 'update',
                        lambda name, val: calls.append((name, val)))
    if env_set:
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
        assert env.use_compile_cache() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        want = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), '.xla_cache')
        assert env.use_compile_cache() == want
        assert os.path.isdir(want)
        assert ('jax_compilation_cache_dir', want) in calls
    assert jax.config.jax_compilation_cache_dir == before


def test_native_library_rebuilds_unloadable_binary(monkeypatch, tmp_path):
    """A library file that cannot be loaded (a binary from another host,
    or a truncated one) is rebuilt from the committed sources, even when
    it is newer than every source."""
    import ctypes
    from raleigh_tpu.native import ldlt

    lib = tmp_path / 'libldlt.so'
    lib.write_bytes(b'not an ELF object')
    monkeypatch.setattr(ldlt, '_LIB', str(lib))
    assert not ldlt._stale(str(lib))
    loaded = ldlt._open(str(lib))
    assert isinstance(loaded, ctypes.CDLL)
    assert hasattr(loaded, 'ldltmf_create')
    assert not (tmp_path / 'libldlt.so.partial').exists()
