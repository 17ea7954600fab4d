"""Principal Component Analysis front end.

Capability parity with reference raleigh/interfaces/pca.py:16-179: fixed
component count, tolerance-driven count, warm-start update of previously
computed components (``have=``), incremental/streaming mode
(``batch_size=``), and the host/device architecture switch.

Usage example (matches the reference doctest problem, pca.py:95-133):

    >>> import numpy
    >>> from raleigh_tpu.examples.generate_matrix import generate
    >>> numpy.random.seed(1)
    >>> A, sigma, u, v = generate(3000, 2000, 1000, pca=True)
    >>> mean, trans, comps = pca(A, npc=300)
    >>> em, ef = pca_error(A, mean, trans, comps)
    >>> em < 6e-2 and ef < 2e-1
    True
"""

import numpy as np
import numpy.linalg as nla

from ..core.solver import Options
from ..algebra.dense import AMatrix, is_device_arch
from .lra import LowerRankApproximation


def pca(A, npc=-1, tol=0, have=None, batch_size=None, verb=0, arch='cpu',
        norm='f', mpc=-1, svtol=1e-3, opt=None, method='auto'):
    """PCA of the dataset whose samples are the rows of A.

    Computes mean (1, n), trans=L (m, k) and comps=R (k, n) with
    L R ~= A - e mean; rows of R (principal components) orthonormal, columns
    of L orthogonal in descending norm order.  ``npc`` fixes k; otherwise
    ``tol`` (in norm 's'/'f'/'m') or interactive stopping decides; ``have``
    warm-starts from a previous (mean, L, R); ``batch_size`` streams.
    See reference pca.py:16-133 for the full contract.

    ``method``: 'jacobi' is the reference-parity block Jacobi-CG engine
    (per-vector convergence control, host-orchestrated); 'subspace' is
    the device-resident subspace-iteration engine (one jitted program per
    stage, near-optimal truncation error — the fast path on a device,
    covering fixed-npc, tolerance-driven, warm-start and streaming
    modes); 'auto' (default) picks 'subspace' on a device arch
    (``arch='gpu'``) for every non-interactive mode and 'jacobi'
    otherwise.
    """
    if opt is None:
        opt = Options()
    if method == 'auto':
        interactive = npc < 1 and tol == 0
        method = 'subspace' if (is_device_arch(arch)
                                and not interactive) else 'jacobi'
    if method == 'subspace':
        from . import randomized as rz

        if npc < 1 and tol == 0:
            raise ValueError("method='subspace' is non-interactive: give "
                             'npc or tol')
        if batch_size is not None:
            if have is not None:
                raise ValueError('have= and batch_size= are exclusive')
            return rz.subspace_pca_stream(A, batch_size, npc=npc, tol=tol,
                                          norm=norm, max_npc=mpc,
                                          verb=verb)
        if have is not None:
            return rz.subspace_pca_update(have, A, npc=npc, tol=tol,
                                          norm=norm, max_npc=mpc,
                                          verb=verb)
        if npc > 0:
            return rz.subspace_pca(A, npc)
        return rz.subspace_pca_tol(A, tol, norm=norm, max_npc=mpc,
                                   verb=verb)
    lra = LowerRankApproximation(have)
    if batch_size is None:
        if have is None:
            data_matrix = AMatrix(A, arch=arch)
            m, n = A.shape
            lra.ortho = svtol if m < n else 0
            lra.compute(data_matrix, opt=opt, rank=npc, tol=tol, norm=norm,
                        max_rank=mpc, svtol=svtol, shift=True, verb=verb)
        else:
            data_matrix = AMatrix(A, arch=arch, copy_data=True)
            lra.update(data_matrix, opt=opt, rank=npc, tol=tol, norm=norm,
                       max_rank=mpc, svtol=svtol, verb=verb)
    else:
        lra.icompute(A, batch_size, opt=opt, rank=npc, tol=tol, norm=norm,
                     max_rank=mpc, svtol=svtol, shift=True, verb=verb,
                     arch=arch)
    return lra.mean(), lra.left(), lra.right()


def pca_error(data, mean, trans, comps):
    """(max relative row 2-norm, relative Frobenius norm) of the PCA
    approximation error (reference pca.py:167-175)."""
    ones = np.ones((data.shape[0], 1), dtype=data.dtype)
    mean = np.reshape(mean, (1, comps.shape[1]))
    data_s = data - ones @ mean
    err = trans @ comps - data_s
    em = np.amax(nla.norm(err, axis=1)) / np.amax(nla.norm(data_s, axis=1))
    ef = nla.norm(err, ord='fro') / nla.norm(data_s, ord='fro')
    return em, ef
