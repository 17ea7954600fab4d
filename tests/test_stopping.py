"""Tests for the interactive stopping machinery, UserStoppingCriteria, and
the convergence_data observability queries."""

import numpy as np
import pytest

from raleigh_tpu.examples.generate_matrix import generate


def test_truncated_svd_interactive(monkeypatch):
    """Interactive mode: the user is asked after each batch of converged
    singular values; answering 'n' stops (reference truncated_svd.py:277)
    — no further prompt, and fewer triplets than the rank.  The matrix
    has full rank 300, so the 128-vector block cannot converge the whole
    spectrum in the three batches before the 'n'."""
    from raleigh_tpu.interfaces.truncated_svd import truncated_svd

    answers = iter(['', '', 'n'])
    asked = []

    def answer(msg):
        asked.append(msg)
        return next(answers, 'n')

    monkeypatch.setattr('builtins.input', answer)
    np.random.seed(1)
    A, *_ = generate(400, 300, 300)
    u, sigma, vt = truncated_svd(A, nsv=-1, tol=0)
    k = sigma.shape[0]
    # we answered "more" twice then stopped: exactly three prompts, and
    # k is small relative to the rank
    assert len(asked) == 3
    assert 0 < k < 300
    assert u.shape == (400, k) and vt.shape == (k, 300)


def test_user_stopping_criteria(monkeypatch):
    from raleigh_tpu.interfaces.truncated_svd import UserStoppingCriteria
    from raleigh_tpu.core.solver import Options
    from raleigh_tpu.interfaces.partial_svd import PartialSVD
    from raleigh_tpu.algebra.dense import AMatrix

    np.random.seed(1)
    A, s0, *_ = generate(400, 300, 150)
    calls = []

    class Probe:
        def inspect(self, mean, sigma, left, right):
            calls.append(sigma.shape[0])
            return sigma.shape[0] >= 20   # stop after >= 20 triplets

    opt = Options()
    opt.block_size = 16
    opt.stopping_criteria = UserStoppingCriteria(A, probe=Probe())
    psvd = PartialSVD(AMatrix(A))
    psvd.compute(AMatrix(A), opt, nsv=(0, -1))
    assert len(calls) >= 1
    got = opt.stopping_criteria.sigma
    assert np.allclose(got[:10], s0[:10], rtol=1e-3)


def test_convergence_data_queries():
    from raleigh_tpu.core.solver import (Options, Problem, Solver,
                                         DefaultConvergenceCriteria)
    from raleigh_tpu.algebra import dense_numpy

    n = 60
    a = np.arange(1, n + 1).astype(np.float64)
    v = dense_numpy.Vectors(n, data_type=np.float64)
    solver = Solver(Problem(v, dense_numpy.Matrix(np.diag(a))))

    queries = []

    class Spy(DefaultConvergenceCriteria):
        def satisfied(self, s, i):
            for q in ('kinematic eigenvector error', 'k eigenvector error',
                      'residual eigenvector error', 'kinematic vector error',
                      'residual', 'eigenvalue', 'max eigenvalue',
                      'block size'):
                queries.append((q, s.convergence_data(q, i)))
            return super().satisfied(s, i)

    opt = Options()
    opt.convergence_criteria = Spy()
    opt.convergence_criteria.set_error_tolerance('eigenvector error', 1e-6)
    opt.verbosity = -1
    assert solver.solve(v, opt, which=(2, 0)) == 0
    names = {q for q, _ in queries}
    assert len(names) == 8
    with pytest.raises(ValueError):
        solver.convergence_data('nonsense query')
