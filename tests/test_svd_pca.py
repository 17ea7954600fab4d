"""End-to-end tests of the dense SVD / LRA / PCA stack against the seeded
synthetic generator, mirroring the reference's doctest pins
(reference interfaces/pca.py:95-133) and truncated_svd-vs-scipy checks
(reference examples/truncated_svd.py:52-72)."""

import numpy as np
import pytest

from raleigh_tpu.examples.generate_matrix import generate
from raleigh_tpu.interfaces.truncated_svd import truncated_svd
from raleigh_tpu.interfaces.pca import pca, pca_error


M, N, RANK = 1000, 600, 300


def _data(pca_mode=False, m=M, n=N, rank=RANK):
    np.random.seed(1)
    return generate(m, n, rank, pca=pca_mode)


@pytest.mark.parametrize('arch', ['cpu', 'gpu'])
def test_truncated_svd_topk(arch):
    A, sigma0, u0, v0 = _data()
    u, sigma, vt = truncated_svd(A, nsv=20, arch=arch)
    assert sigma.shape == (20,)
    assert np.allclose(sigma, sigma0[:20], rtol=1e-3)
    # singular vectors orthonormal and consistent: A v = u sigma
    assert np.allclose(u.T @ u, np.eye(20), atol=1e-3)
    av = A @ vt.T
    assert np.allclose(av, u * sigma, atol=1e-3 * sigma[0])


def test_truncated_svd_tolerance():
    A, sigma0, u0, v0 = _data()
    u, sigma, vt = truncated_svd(A, nsv=-1, tol=0.2, norm='f', verb=0)
    k = sigma.shape[0]
    # truncation error in Frobenius norm below tolerance
    err = np.linalg.norm(A - (u * sigma) @ vt) / np.linalg.norm(A)
    assert err <= 0.25
    assert k < min(M, N) // 2


def test_pca_fixed_npc():
    A, sigma0, u0, v0 = _data(pca_mode=True)
    mean, trans, comps = pca(A, npc=50)
    assert comps.shape == (50, N) and trans.shape == (M, 50)
    em, ef = pca_error(A, mean, trans, comps)
    ref_em, ref_ef = _oracle_pca_error(A, 50)
    assert ef <= ref_ef * 1.1 + 1e-4
    assert em <= ref_em * 1.5 + 1e-4


def test_pca_tolerance():
    A, sigma0, u0, v0 = _data(pca_mode=True)
    mean, trans, comps = pca(A, tol=0.1)
    em, ef = pca_error(A, mean, trans, comps)
    assert ef <= 0.1 * 1.05


def test_pca_update():
    A, sigma0, u0, v0 = _data(pca_mode=True)
    A0, A1 = A[:800, :], A[800:, :]
    mean, trans, comps = pca(A0, tol=0.1)
    mean, trans, comps = pca(A1, have=(mean, trans, comps))
    em, ef = pca_error(A, mean, trans, comps)
    assert ef <= 0.16
    assert trans.shape[0] == M


def test_pca_incremental():
    A, sigma0, u0, v0 = _data(pca_mode=True)
    mean, trans, comps = pca(A, batch_size=400, tol=0.1)
    em, ef = pca_error(A, mean, trans, comps)
    assert ef <= 0.16
    assert trans.shape[0] == M


def _oracle_pca_error(A, k):
    m, n = A.shape
    mean = A.mean(axis=0, keepdims=True)
    As = A - mean
    u, s, vt = np.linalg.svd(As, full_matrices=False)
    err = As - (u[:, :k] * s[:k]) @ vt[:k]
    em = np.amax(np.linalg.norm(err, axis=1)) \
        / np.amax(np.linalg.norm(As, axis=1))
    ef = np.linalg.norm(err) / np.linalg.norm(As)
    return em, ef
