"""CPU tests of the GPU smoke script (chip_smoke.py): it refuses to run
without a GPU, and its reference helpers are right on small inputs."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    for line in stdout.splitlines():
        try:
            if 'ok' in json.loads(line):
                return True
        except ValueError:
            continue
    return False


@pytest.mark.parametrize('alone', [False, True],
                         ids=['checkout', 'script_alone'])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU platform, and in a directory holding nothing of the repo
    but the script, it exits non-zero and prints no result."""
    if alone:
        shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), tmp_path)
        proc = _run(str(tmp_path), 'chip_smoke.py')
    else:
        proc = _run(ROOT, os.path.join(ROOT, 'chip_smoke.py'))
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)


def test_pca_oracle_singular_values():
    """f64 singular values of the centred data from its Gram matrix match
    LAPACK's SVD, and the optimal truncation error follows from them."""
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((60, 12)) @ rng.standard_normal((12, 90))
         + 0.1 * rng.standard_normal((60, 90)) + 2.0).astype(np.float32)
    sv = chip_smoke.centred_singular_values_f64(a)
    c = a.astype(np.float64) - a.astype(np.float64).mean(axis=0)
    want = np.linalg.svd(c, compute_uv=False)
    assert sv.dtype == np.float64 and sv.shape == (60,)
    assert np.all(np.diff(sv) <= 0)
    assert np.abs(sv[:12] - want[:12]).max() <= 1e-10 * want[0]
    opt = chip_smoke.optimal_truncation_error(sv, 12)
    u, s, vt = np.linalg.svd(c, full_matrices=False)
    best = c - (u[:, :12] * s[:12]) @ vt[:12]
    assert abs(opt - np.linalg.norm(best) / np.linalg.norm(c)) < 1e-9


def test_pca_errors_helper():
    """The achieved-error helper gives the optimal error for the exact
    truncated SVD and flags non-orthonormal components."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((50, 80)).astype(np.float32)
    mean = a.mean(axis=0, keepdims=True)
    u, s, vt = np.linalg.svd(a - mean, full_matrices=False)
    err, ortho = chip_smoke.pca_errors(a, mean, u[:, :10] * s[:10],
                                       vt[:10])
    opt = np.sqrt((s[10:] ** 2).sum() / (s ** 2).sum())
    assert abs(err - opt) < 1e-5 and ortho < 1e-5
    _, ortho2 = chip_smoke.pca_errors(a, mean, u[:, :10], 1.01 * vt[:10])
    assert ortho2 > 1e-2
