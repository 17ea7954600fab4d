"""raleigh_tpu — a JAX sparse linear-algebra / eigensolver / PCA framework.

A from-scratch, JAX/XLA-first re-design with the capabilities of the
RALEIGH library (block Jacobi-conjugated-gradients eigensolver for symmetric /
Hermitian problems, partial/truncated SVD, lower-rank approximation and PCA
with update/incremental/interactive modes; see reference
raleigh/__init__.py:1-20 for the capability inventory).

Layering (mirrors the reference's L1..L5, device-resident):

  interfaces/   SciPy-style front ends: partial_hevp, truncated_svd, pca, ...
  core/         block Jacobi-CG core Solver on the abstract block-vector
                contract (reference core/solver.py)
  algebra/      block-vector algebra: `numpy` host backend and `jax` device
                backend (sharded jax.Array over a chip mesh); sparse operators
  ops/          device SpMM (DIA/ELL/BSR) and compensated reductions
  parallel/     mesh / sharding helpers, halo-exchange collectives
  native/       C++ components (sparse LDL^T direct solver with inertia)
  utils/        verbosity, profiling, checkpointing
"""

__version__ = "0.1.0"

_EXPORTS = {
    'Options': 'raleigh_tpu.core.solver',
    'Problem': 'raleigh_tpu.core.solver',
    'Solver': 'raleigh_tpu.core.solver',
    'DefaultConvergenceCriteria': 'raleigh_tpu.core.solver',
    'EstimatedErrors': 'raleigh_tpu.core.solver',
    'partial_hevp': 'raleigh_tpu.interfaces.partial_hevp',
    'truncated_svd': 'raleigh_tpu.interfaces.truncated_svd',
    'pca': 'raleigh_tpu.interfaces.pca',
    'pca_error': 'raleigh_tpu.interfaces.pca',
    'LowerRankApproximation': 'raleigh_tpu.interfaces.lra',
    'PartialSVD': 'raleigh_tpu.interfaces.partial_svd',
    'DefaultStoppingCriteria': 'raleigh_tpu.interfaces.truncated_svd',
    'UserStoppingCriteria': 'raleigh_tpu.interfaces.truncated_svd',
    'DefaultProbe': 'raleigh_tpu.interfaces.truncated_svd',
    'TruncatedSVDErrorCalculator': 'raleigh_tpu.interfaces.truncated_svd',
    'AMatrix': 'raleigh_tpu.algebra.dense',
    'lobpcg': 'raleigh_tpu.core.device_solver',
    'subspace_pca': 'raleigh_tpu.interfaces.randomized',
    'subspace_pca_tol': 'raleigh_tpu.interfaces.randomized',
    'subspace_pca_update': 'raleigh_tpu.interfaces.randomized',
    'subspace_pca_stream': 'raleigh_tpu.interfaces.randomized',
    'randomized_svd': 'raleigh_tpu.interfaces.randomized',
    'Chebyshev': 'raleigh_tpu.algebra.sparse',
    'spectral_bounds': 'raleigh_tpu.algebra.sparse',
    'SparseSymmetricMatrix': 'raleigh_tpu.algebra.sparse',
    'SparseSymmetricSolver': 'raleigh_tpu.algebra.sparse',
    'IncompleteLU': 'raleigh_tpu.algebra.sparse',
    'Operator': 'raleigh_tpu.algebra.sparse',
}


__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(_EXPORTS[name])
        return getattr(mod, name)
    raise AttributeError(name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
