"""Accuracy tests for the device-resident randomized/subspace engines
against exact LAPACK truncation (the engine behind bench.py)."""

import numpy as np
import pytest

from raleigh_tpu.examples.generate_matrix import generate
from raleigh_tpu.interfaces.pca import pca, pca_error
from raleigh_tpu.interfaces.randomized import randomized_svd


def test_subspace_pca_matches_optimal_truncation():
    np.random.seed(1)
    A, s0, u0, v0 = generate(1200, 800, 400, pca=True)
    mean, trans, comps = pca(A, npc=80, method='subspace')
    assert comps.shape == (80, 800) and trans.shape == (1200, 80)
    em, ef = pca_error(A, mean, trans, comps)
    mu = A.mean(axis=0)
    As = A - mu
    u, s, vt = np.linalg.svd(As, full_matrices=False)
    err = As - (u[:, :80] * s[:80]) @ vt[:80]
    ef_opt = np.linalg.norm(err) / np.linalg.norm(As)
    assert ef <= ef_opt * 1.02
    # components orthonormal
    g = comps @ comps.T
    assert np.abs(g - np.eye(80)).max() < 5e-3


def test_subspace_pca_components_orthonormal_wide_spectrum():
    """f32 data whose retained spectrum spans (sigma_1/sigma_k)^2 ~ 2e5:
    the Gram route alone loses orthogonality to ~1e-2 there; the
    Cholesky-QR pass restores it without changing trans @ comps."""
    from raleigh_tpu.interfaces.randomized import subspace_pca

    np.random.seed(1)
    A, s0, *_ = generate(1000, 1500, 1000, pca=True)
    assert s0[0] / s0[399] > 400
    mean, trans, comps = subspace_pca(A, 400)
    assert comps.dtype == np.float32
    g = comps.astype(np.float64) @ comps.T.astype(np.float64)
    assert np.abs(g - np.eye(400)).max() < 1e-5
    em, ef = pca_error(A, mean, trans, comps)
    mu = A.mean(axis=0)
    s = np.linalg.svd(A - mu, compute_uv=False)
    ef_opt = np.sqrt((s[400:] ** 2).sum() / (s ** 2).sum())
    assert ef <= ef_opt * 1.005


def test_subspace_pca_tol_adaptive_rank():
    """Tolerance-driven device PCA: the subspace grows until the relative
    Frobenius truncation error meets tol, and the returned rank is the
    smallest satisfying one (reference doctest accuracy,
    pca.py:106-110)."""
    np.random.seed(1)
    A, *_ = generate(1200, 800, 400, pca=True)
    mean, trans, comps = pca(A, tol=0.05, method='subspace')
    em, ef = pca_error(A, mean, trans, comps)
    assert ef <= 0.05
    k = comps.shape[0]
    # near-minimal: the optimal rank for this tol is close below
    mu = A.mean(axis=0)
    s = np.linalg.svd(A - mu, compute_uv=False)
    tail = np.sqrt(np.maximum(np.sum(s ** 2) - np.cumsum(s ** 2), 0.0))
    k_opt = int(np.searchsorted(-tail, -0.05 * np.linalg.norm(A - mu)))
    assert k <= max(2 * k_opt, k_opt + 16)
    # spectral-norm tolerance mode
    mean, trans, comps = pca(A, tol=0.2, norm='s', method='subspace')
    em, ef = pca_error(A, mean, trans, comps)
    sk = np.linalg.norm(trans[:, -1])
    assert sk <= 0.21 * s[0]


def test_subspace_pca_update_and_stream():
    """Device warm-start update and streaming: reference pca(have=) and
    pca(batch_size=) capabilities on the subspace engine, at the
    reference doctest error magnitudes (pca.py:111-133)."""
    np.random.seed(1)
    A, *_ = generate(3000, 2000, 1000, pca=True)
    A = A.astype(np.float32)

    first = pca(A[:2000], tol=0.05, method='subspace')
    mean, trans, comps = pca(A[2000:], have=first, tol=0.05,
                             method='subspace')
    assert trans.shape[0] == 3000
    em, ef = pca_error(A, mean, trans, comps)
    assert ef < 0.06 and em < 0.06

    mean, trans, comps = pca(A, tol=0.05, batch_size=1000,
                             method='subspace')
    assert trans.shape[0] == 3000
    em, ef = pca_error(A, mean, trans, comps)
    assert ef < 0.06 and em < 0.06


def test_pca_auto_routes_tpu_to_subspace():
    """arch='tpu' with a non-interactive mode takes the device engine by
    default (method='auto')."""
    np.random.seed(1)
    A, *_ = generate(600, 400, 200, pca=True)
    mean, trans, comps = pca(A, npc=40, arch='tpu')
    em, ef = pca_error(A, mean, trans, comps)
    mu = A.mean(axis=0)
    s = np.linalg.svd(A - mu, compute_uv=False)
    ef_opt = np.sqrt(np.sum(s[40:] ** 2) / np.sum(s ** 2))
    assert ef <= ef_opt * 1.02


def test_next_subspace_size_prediction():
    """The growth-loop step extrapolates the error profile instead of
    blind doubling: a power-law profile jumps near the predicted rank, a
    flat (noise-floor) profile jumps straight to the cap, and every step
    makes at least 1.5x progress."""
    from raleigh_tpu.interfaces.randomized import _next_subspace_size

    k = np.arange(0, 1025)
    prof = np.concatenate(([1.0], (k[1:] / 1.0) ** -0.5))  # prof ~ k^-0.5
    # tol = 0.05 -> k_pred = 400; with margin the jump lands close above
    nxt = _next_subspace_size(prof, 0.05, 128, 4000)
    assert 400 <= nxt <= 700
    # flat profile: tolerance unreachable, go straight to the cap
    flat = np.full(129, 0.5)
    assert _next_subspace_size(flat, 0.05, 128, 4000) == 4000
    # prediction below current l still makes 1.5x progress
    steep = np.concatenate(([1.0], (k[1:] / 1.0) ** -2.0))
    assert _next_subspace_size(steep, 0.5, 128, 4000) >= 192
    # tol <= 0 is unreachable by definition: straight to the cap, no
    # OverflowError (regression: direct subspace_pca_update/stream calls
    # with default npc=-1, tol=0)
    assert _next_subspace_size(prof, 0.0, 128, 4000) == 4000
    assert _next_subspace_size(prof, -1.0, 128, 4000) == 4000
    # the fit uses only the trusted leading range: an artificially flat
    # unconverged tail beyond `trusted` must not fake a noise floor
    prof_flat_tail = prof.copy()
    prof_flat_tail[112:] = prof_flat_tail[112]
    nxt = _next_subspace_size(prof_flat_tail, 0.05, 128, 4000, trusted=112)
    assert nxt < 4000


def test_randomized_svd_sigma():
    np.random.seed(1)
    A, s0, u0, v0 = generate(1000, 700, 300)
    u, s, vt = randomized_svd(A, 40)
    assert np.abs(s - s0[:40]).max() / s0[0] < 1e-3
    # A v ~= u s
    av = A @ vt.T
    assert np.abs(av - u * s).max() < 1e-3 * s0[0]


@pytest.mark.parametrize('arch', ['gpu', 'tpu', 'jax', 'GPU', 'cpu'])
def test_pca_device_arch_routing(monkeypatch, arch):
    """Every device arch string ('gpu', 'tpu', 'jax', any case) means
    JAX's default device and routes pca(method='auto') to the subspace
    engine; 'cpu' keeps the host Jacobi engine."""
    from raleigh_tpu.interfaces import randomized as rz

    calls = []
    real = rz.subspace_pca

    def spy(a, npc, **kw):
        calls.append(npc)
        return real(a, npc, **kw)

    monkeypatch.setattr(rz, 'subspace_pca', spy)
    np.random.seed(1)
    A, *_ = generate(300, 200, 100, pca=True)
    mean, trans, comps = pca(A, npc=10, arch=arch)
    assert comps.shape == (10, 200)
    assert calls == ([] if arch == 'cpu' else [10])


def test_strict_device_arch_needs_accelerator():
    """'gpu!' asks for an accelerator: on the CPU platform the backend
    selection refuses, naming the platform JAX reports."""
    from raleigh_tpu.algebra.dense import best_backend, is_device_arch

    assert is_device_arch('gpu!') and not is_device_arch('cpu')
    assert best_backend('gpu')[1] == 'jax'
    with pytest.raises(RuntimeError, match="'cpu'"):
        best_backend('gpu!')
