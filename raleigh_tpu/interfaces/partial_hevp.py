"""Partial eigenvalue solver for sparse symmetric/Hermitian problems.

Capability parity with reference raleigh/interfaces/partial_hevp.py:21-257:
shift-and-invert via sparse factorization (native LDL^T instead of MKL
PARDISO) with the factorization-accuracy probe and inertia-driven splitting
of ``which`` around the shift, the preconditioned path (ILU-equivalent or
the device-resident Chebyshev polynomial preconditioner), buckling mode
with its load-factor back-transform, and the same status codes.
"""

import time

import numpy as np

from ..algebra.dense import is_device_arch
from ..algebra.sparse import (SparseSymmetricMatrix, SparseSymmetricSolver,
                              Operator)
from ..core.solver import Problem, Solver, Options, DefaultConvergenceCriteria


def partial_hevp(A, B=None, T=None, buckling=False, sigma=0, which=6,
                 tol=1e-4, verb=0, opt=None, arch='cpu', engine='auto'):
    """Compute eigenpairs of a sparse symmetric problem near a shift
    (factorization path) or at the lower end of the spectrum
    (preconditioned path).  See reference partial_hevp.py:21-95 for the
    parameter/status contract; ``arch`` additionally selects the algebra
    backend ('cpu' host; 'gpu' for JAX's default device) for the
    block-vector iteration.

    ``engine`` selects the iteration engine for the preconditioned path:
    'core' is the reference-parity host-orchestrated block Jacobi-CG
    solver; 'device' the fully device-resident LOBPCG superkernel
    (std/gen problems with a jit-traceable preconditioner, e.g.
    Chebyshev; block convergence control); 'jacobi' the chunked device
    engine with per-vector convergence control and Solver-compatible
    criteria (core/device_jacobi.py — std and gen via its B-inner-product
    iteration); 'auto' picks 'device' whenever it applies on a device
    arch.

    Returns (lmd, x, status).
    """
    if opt is None:
        opt = Options()
    if buckling and sigma >= 0:
        raise ValueError('sigma must be negative in buckling mode')

    device_arch = is_device_arch(arch)
    if device_arch and T is None:
        # factorization path on a device arch: the LDL^T solve runs on
        # the host, so device-orchestrated block algebra ships the solve
        # block across the host-device link every iteration.  Decide from
        # a measured link probe (utils/link.py); ``opt.orchestration``
        # ('host'/'device') overrides.
        from ..utils.link import choose_orchestration
        forced = getattr(opt, 'orchestration', 'auto') if opt else 'auto'
        if forced == 'auto':
            blk = getattr(opt, 'block_size', -1) if opt else -1
            blk = blk if blk and blk > 0 else 32
            n_hint = A.size() if isinstance(A, SparseSymmetricSolver) \
                else A.shape[0]
            choice = choose_orchestration(n_hint, blk)
        else:
            choice = forced
        if choice == 'host':
            if verb > 0:
                print('link probe: host-side orchestration')
            device_arch = False
    if device_arch:
        from ..algebra import dense_jax as backend
    else:
        from ..algebra import dense_numpy as backend

    if B is not None:
        opB = SparseSymmetricMatrix(A if buckling else B, arch=arch)
    else:
        if buckling:
            raise RuntimeError('stress stiffness matrix missing in '
                               'buckling mode')
        opB = None

    if T is None:
        # ---------------- shift-and-invert via factorization ------------
        if isinstance(A, SparseSymmetricSolver):
            n = A.size()
            dtype = A.data_type()
            sigma = A.sigma()
            solver = A
        else:
            m, n = A.shape
            if m != n:
                raise ValueError('the matrix must be square')
            dtype = A.data.dtype.type
            solver = SparseSymmetricSolver(dtype=dtype)
            if verb > -1:
                print('setting up the linear system solver...')
            start = time.time()
            solver.analyse(A, sigma, B)
            solver.factorize()

            # factorization-accuracy probe: solve on random data and abort
            # when the relative error exceeds 1% (reference
            # partial_hevp.py:128-167)
            opA_probe = SparseSymmetricMatrix(A)
            b = backend.Vectors(n, 3, data_type=dtype)
            x = backend.Vectors(n, 3, data_type=dtype)
            y = backend.Vectors(n, 3, data_type=dtype)
            x.fill_random()
            opA_probe.apply(x, b)
            opB_probe = SparseSymmetricMatrix(B) if B is not None else None
            if opB_probe is not None:
                opB_probe.apply(x, y)
                z = y
            else:
                z = x
            s = x.dots(x).real
            if sigma != 0:
                b.add(z, -sigma)
            solver.solve(b, y)
            y.add(x, -1)
            t = y.dots(y).real
            err = np.amax(np.sqrt(np.abs(t / s)))
            if err > 0.01:
                if verb > -1:
                    print('factorization too inaccurate: relative error '
                          '%.1e, consider moving shift slightly' % err)
                return None, None, -1
            elif verb > -1:
                print('estimated factorization error: %.1e' % err)
                print('setup time: %.2e' % (time.time() - start))

        opAinv = solver
        neg, pos = solver.inertia()
        if verb > -1:
            print('positive eigenvalues: %d' % pos)
            print('negative eigenvalues: %d' % neg)
        if isinstance(which, tuple):
            if len(which) != 2:
                raise ValueError('which must be an integer or a pair')
            which = (min(which[0], neg), min(which[1], pos))
        else:
            if buckling:
                which = (neg, 0) if which < neg else (neg, which - neg)
            elif neg < 1:
                which = (0, which)
            elif pos < 1:
                which = (which, 0)
            # else: leave ``which`` an integer — in shift-invert the
            # transformed spectrum 1/(lmd - sigma) makes "largest
            # magnitude" mean "nearest to sigma on either side"
        eigenvectors = backend.Vectors(n, data_type=dtype)
        if B is None:
            evp = Problem(eigenvectors, opAinv)
        else:
            evp = Problem(eigenvectors, opAinv, opB, 'pro')
        evp_solver = Solver(evp)
        sigma_opt = sigma
    else:
        # ---------------- preconditioned path ----------------------------
        if buckling:
            raise ValueError('preconditioning for buckling problems is not'
                             ' supported')
        # device engine: a standard or generalized problem on a device
        # arch with a jit-traceable preconditioner runs in the fully
        # device-resident LOBPCG superkernel (core/device_solver.py) —
        # the whole iteration is one XLA program instead of ~10
        # dispatches per iteration.  Generalized problems iterate in the
        # B-inner product (B must be positive definite).
        if (engine in ('auto', 'device', 'jacobi')
                and not isinstance(which, tuple)
                and device_arch
                and (T is None or hasattr(T, '_device_fused_rows'))):
            if engine == 'jacobi':
                return _device_jacobi_path(A, B, T, which, tol, verb, opt,
                                           arch)
            return _device_path(A, B, T, which, tol, verb, opt, arch)
        if engine in ('device', 'jacobi'):
            raise ValueError("engine='%s' needs an integer which, a"
                             " device arch, and a jit-traceable"
                             " preconditioner" % engine)
        opA = SparseSymmetricMatrix(A, arch=arch)
        n = opA.size()
        dtype = opA.data_type().type
        eigenvectors = backend.Vectors(n, data_type=dtype)
        opT = T if hasattr(T, 'apply') and not _ndarray_level(T) \
            else Operator(T)
        if B is None:
            evp = Problem(eigenvectors, opA)
        else:
            evp = Problem(eigenvectors, opA, opB, 'gen')
        evp_solver = Solver(evp)
        evp_solver.set_preconditioner(opT)
        sigma_opt = None
        if isinstance(which, tuple):
            raise ValueError('which must be an integer when preconditioning'
                             ' is used')
        which = (which, 0)

    opt.convergence_criteria = DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('k eigenvector error', tol)
    opt.sigma = sigma_opt

    start = time.time()
    status = evp_solver.solve(eigenvectors, opt, which=which)
    if status < 0:
        return None, None, status
    solve_time = time.time() - start
    if T is None:
        if buckling:
            lmd = sigma / (1 - 1 / evp_solver.eigenvalues)
        else:
            lmd = sigma + 1.0 / evp_solver.eigenvalues
    else:
        lmd = evp_solver.eigenvalues
    ind = np.argsort(-lmd) if buckling else np.argsort(lmd)
    lmd = lmd[ind]
    ne = eigenvectors.nvec()
    if verb > -1:
        print('iterations: %d, solve time: %.2e'
              % (evp_solver.iteration, solve_time))
    x = eigenvectors.data().T
    if ne > 0:
        x = x[:, ind]
    return lmd, x, status


def _device_path(A, B, T, which, tol, verb, opt, arch):
    """Preconditioned std/gen problem on the device-resident LOBPCG
    engine (B-inner-product iteration when B is given)."""
    from ..core.device_solver import lobpcg

    opA = SparseSymmetricMatrix(A, arch=arch)
    dev = opA.device_matrix()
    devB = (SparseSymmetricMatrix(B, arch=arch).device_matrix()
            if B is not None else None)
    maxit = getattr(opt, 'max_iter', -1)
    if maxit is None or maxit < 0:
        maxit = 600
    block = getattr(opt, 'block_size', -1)
    block = None if block is None or block < which else block
    dtype = np.float64 if np.dtype(A.dtype).itemsize >= 8 and \
        _x64_enabled() else np.float32
    n = dev.shape[0]
    # must match lobpcg's own default (the preconditioner below is built
    # for exactly this block shape)
    from ..core.device_solver import default_block
    m = block or default_block(which, n)
    precond = None
    if T is not None:
        # argument-form fused recurrence when available: the matrix
        # payload then flows through the LOBPCG superkernel as jit
        # arguments (compiled program caches across matrices)
        if hasattr(T, 'device_rows_operands'):
            precond = T.device_rows_operands(m, n, dtype=np.dtype(dtype))
        else:
            precond = T._device_fused_rows()
    start = time.time()
    lmd, x, resid, niter, status = lobpcg(
        dev, which, opB=devB, precond=precond, block_size=block, tol=tol,
        maxit=maxit, verb=max(verb, 0), dtype=dtype)
    if verb > -1:
        print('iterations: %d, solve time: %.2e'
              % (niter, time.time() - start))
    return lmd, x, status


def _device_jacobi_path(A, B, T, which, tol, verb, opt, arch):
    """Per-triplet chunked device engine (core/device_jacobi.py) for
    preconditioned std/gen problems: Solver-compatible convergence
    criteria and per-vector locking, entirely on device.  The smallest
    eigenpairs of (A, B) are the LARGEST of (-A, B), so the engine runs
    on the negated operator (the preconditioner commutes with the sign)
    and eigenvalues are negated back."""
    import time as _time

    import jax.numpy as jnp

    from ..algebra import dense_jax
    from ..core.device_jacobi import DeviceJacobi
    from ..core.solver import DefaultConvergenceCriteria
    from ..ops.spmm import rows_matmat_operands

    opA = SparseSymmetricMatrix(A, arch=arch)
    n = opA.size()
    fnA, opsA = rows_matmat_operands(opA.device_matrix())

    def neg_matmat(ops, x):
        return -fnA(ops, x)

    fnB = opsB = None
    if B is not None:
        fnB, opsB = rows_matmat_operands(
            SparseSymmetricMatrix(B, arch=arch).device_matrix())
    dtype = np.float64 if np.dtype(A.dtype).itemsize >= 8 and \
        _x64_enabled() else np.float32
    # fix the block size now so the argument-form preconditioner is
    # built for the exact block shape the engine will iterate; the
    # caller's Options is restored afterwards (side-effect-free
    # interfaces, reference truncated_svd.py:121-126)
    block_user = getattr(opt, 'block_size', -1)
    block = block_user
    if block is None or block < 1:
        block = 128 if which > 100 else max(16, which + which // 4)
    block = min(block, max(8, n // 4))
    opt.block_size = block
    precond = None
    if T is not None:
        if hasattr(T, 'device_rows_operands'):
            precond = T.device_rows_operands(block, n,
                                             dtype=np.dtype(dtype))
        else:
            precond = T._device_fused_rows()
    engine = DeviceJacobi(neg_matmat, n, dtype=dtype, precond=precond,
                          operands=opsA, matmat_b=fnB, operands_b=opsB)
    cc_user = opt.convergence_criteria
    max_iter_user = opt.max_iter
    opt.convergence_criteria = cc_user or DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('k eigenvector error',
                                                 tol)
    if opt.max_iter is None or opt.max_iter < 0:
        opt.max_iter = 600
    v = dense_jax.Vectors(n, data_type=dtype)
    start = _time.time()
    try:
        status = engine.solve(v, options=opt, nwanted=which,
                              verb=max(verb, 0))
    finally:
        # full restore — a caller reusing the same Options across calls
        # must not inherit the tolerance/criteria/max_iter set here
        opt.block_size = block_user
        opt.convergence_criteria = cc_user
        opt.max_iter = max_iter_user
    if verb > -1:
        print('iterations: %d, solve time: %.2e'
              % (engine.iteration, _time.time() - start))
    lmd = -engine.eigenvalues
    ind = np.argsort(lmd)
    x = v.data().T
    if x.shape[1] > 0:
        x = x[:, ind]
    return lmd[ind], x, status


def _x64_enabled():
    import jax
    return bool(jax.config.jax_enable_x64)


def _ndarray_level(T):
    """True when T.apply expects plain ndarrays (needs the Operator
    adapter) rather than Vectors."""
    import inspect
    try:
        mod = type(T).__module__
        return not mod.startswith('raleigh_tpu')
    except Exception:
        return True
