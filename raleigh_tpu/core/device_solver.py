"""Device-resident preconditioned block eigensolver (LOBPCG family).

The reference-parity ``core.solver.Solver`` orchestrates its block
Jacobi-conjugated-gradients iteration from the host: adaptive block
rebalancing, per-vector convergence sweeps, cluster/stagnation logic
(reference raleigh/core/solver.py:587-1663).  That control flow is worth
keeping for parity, but every one of its ~10 small device calls per
iteration costs a dispatch and, for the host decisions, a sync.

This module is the device-resident counterpart: the *entire* iteration — SpMM,
polynomial preconditioning, constraint orthogonalization, Gram matrices,
the Rayleigh–Ritz eigenproblem (on-device ``jnp.linalg.eigh`` of a
(3m x 3m) matrix), basis update and residual norms — is ONE jitted XLA
program, and ``chunk`` iterations run per dispatch inside a
``lax.fori_loop``.  The host sees only an (m,) eigenvalue and residual
vector every ``chunk`` iterations to decide termination.  This is the
"jit-compatible re-implementation of the block CG core" SURVEY §7 calls
for, in its locally-optimal-block (LOBPCG) formulation, which maps every
hot op onto dense matrix products.

Iteration layout: blocks are stored as **(m, n) row-vector arrays** —
vectors as rows, matching the block-vector algebra's storage convention.
This puts the long vector dimension on the minor (contiguous) axis, so
elementwise ops stay contiguous even for small blocks, Gram matrices
contract over it, and the SpMM consumes ``DiaMatrix.matmat_rows``
directly.  The public
contract stays column-major ((n, k) eigenvectors, (n, nc) constraints)
like the reference's; transposes happen once at entry/exit.

Algorithm: classical LOBPCG with hierarchical block orthonormalization
(X ⊥ W ⊥ P by blocked two-pass Gram–Schmidt, per-block eigh-whitening with
dead-column masking for float32 robustness) and Rayleigh–Ritz over
span[X, W, P].  Generalized problems A x = λ B x (B symmetric positive
definite, reference problem type 'gen', core/solver.py:224-258) run the
same iteration in the B-inner product: every Gram, orthogonalization and
whitening contracts against tracked B-images, so X stays B-orthonormal
and the Ritz matrix reduces to Xᴴ A X.  Prior eigenvectors can be passed
as ``constraints``: they are B-orthonormalized once and every block is
deflated against them with exact A/B-image tracking (warm restart,
reference core/solver.py:112-114,743-757).  The preconditioner is any
jit-traceable (m, n) -> (m, n) row-layout map — e.g. the fused Chebyshev
recurrence (``Chebyshev._device_fused_rows``) whose SpMMs inline into
the same XLA program.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _gram(a, b):
    """Xᴴ Y for row-stored blocks: rows are vectors, contraction over
    the lane (vector) dimension."""
    return jnp.einsum('in,jn->ij', a.conj(), b, precision=_HI)


def _eigh_small(h):
    """Eigendecomposition of a small (block-sized) Gram matrix.  The
    reference solves its Rayleigh-Ritz problem in float64 regardless of
    the vector dtype (core/solver.py:1437-1473 "full G in float64"); do
    the same whenever x64 is live — the matrix is (3m x 3m), so the cost
    is nil, and float32 iterations resolve eigenvalue clusters that an
    all-f32 Ritz step cannot.  Without x64 this is an identity gate and
    the eigh stays f32."""
    if jax.config.jax_enable_x64 and h.dtype in (jnp.float32,
                                                 jnp.complex64):
        wide = jnp.complex128 if jnp.iscomplexobj(h) else jnp.float64
        w, v = jnp.linalg.eigh(h.astype(wide))
        return w.astype(h.real.dtype), v.astype(h.dtype)
    return jnp.linalg.eigh(h)


def _bnorms(block, bblock):
    """Per-row B-norms given the block and its B-image (2-norms when
    bblock is block itself)."""
    return jnp.sqrt(jnp.maximum(
        jnp.einsum('mn,mn->m', block.conj(), bblock, precision=_HI).real,
        0.0))


def _normalize_drop_pair(block, bblock, sqrt_eps, dead0=None):
    """Normalize rows to unit B-length; a row whose norm collapsed
    below sqrt(eps) relative to the block's largest row is pure
    rounding noise (e.g. the residual of a converged pair, or a direction
    swallowed by an orthogonalization) — zero it and flag it dead.

    This *scale-referenced* deadness test is what keeps the iteration
    stable after convergence: a Gram-relative cutoff alone cannot tell a
    noise block from a live one (its Gram matrix has 100% rounding error
    but a perfectly fine condition number), and whitening such a block
    manufactures rows of norm >> 1 that destroy the basis.

    Row scaling commutes with the operators, so the B-image follows
    exactly."""
    norms = _bnorms(block, bblock)
    ref = jnp.maximum(jnp.max(norms), 1e-30)
    dead = norms <= sqrt_eps * ref
    if dead0 is not None:
        dead = dead | dead0
    safe = jnp.where(norms == 0, 1.0, norms).astype(block.real.dtype)
    out = jnp.where(dead[:, None], 0.0, block / safe[:, None])
    bout = out if bblock is block else \
        jnp.where(dead[:, None], 0.0, bblock / safe[:, None])
    return out, bout, dead


def _whiten_pair(block, bblock, eps_rel, sqrt_eps, dead0=None):
    """B-orthonormalize the rows of ``block`` (unit-B-normalized,
    possibly with zeroed dead rows) by eigh-whitening of its B-Gram
    matrix; near-dependent directions are zeroed and flagged.

    Returns (whitened block, whitened B-image, dead mask (m,))."""
    g = _gram(block, bblock)
    g = 0.5 * (g + g.conj().T)
    w, v = jnp.linalg.eigh(g)              # ascending, w >= 0 up to noise
    wmax = jnp.maximum(w[-1], 0.0)
    cutoff = wmax * eps_rel
    dead_g = w <= cutoff
    inv = jnp.where(dead_g, 0.0, 1.0 / jnp.sqrt(jnp.where(dead_g, 1.0, w)))
    mix = v * inv[None, :]
    # row blocks combine from the left: X_new = X mix  <=>  R_new = mixᵀ R
    bw = jnp.matmul(mix.T, block, precision=_HI)
    bbw = bw if bblock is block else jnp.matmul(mix.T, bblock,
                                                precision=_HI)
    # a correctly whitened row is unit up to rounding; anything that
    # is not was noise-dominated — run the scale test once more
    return _normalize_drop_pair(bw, bbw, sqrt_eps, dead0)


def _ortho_against_pair(block, basis, bbasis, *extra):
    """Two-pass classical Gram-Schmidt of ``block`` against the
    B-orthonormal ``basis`` in the B-inner product (q = basisᴴ B block =
    (B basis)ᴴ block).  Any ``extra`` images of ``block`` (its tracked
    A/B-images) receive the same row operation exactly — matrix
    application commutes with row combinations."""
    outs = list(extra)
    for _ in range(2):
        q = _gram(bbasis, block)
        block = block - jnp.matmul(q.T, basis, precision=_HI)
        for i, (img, bas_img) in enumerate(outs):
            outs[i] = (img - jnp.matmul(q.T, bas_img, precision=_HI),
                       bas_img)
    if not extra:
        return block
    return (block,) + tuple(img for img, _ in outs)


def shard_operator(dm, mesh, axis='chips'):
    """Place a device sparse matrix's payload so the LOBPCG iteration
    shards over the vector dimension of ``mesh``: XLA's GSPMD partitioner
    then turns the DIA shifts into collective-permutes at shard
    boundaries, the ELL gathers into local gathers + all-to-all where
    needed, and every Gram matrix into a local matmul + psum — the
    sharded-Vectors design of SURVEY §5.8 with zero solver changes."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    if hasattr(dm, 'val') and dm.val.ndim == 2:      # DIA: (noff, n)
        dm.val = jax.device_put(dm.val, NamedSharding(mesh, P(None, axis)))
    elif hasattr(dm, 'idx'):                         # ELL: (n, K)
        dm.idx = jax.device_put(dm.idx, NamedSharding(mesh, P(axis, None)))
        dm.val = jax.device_put(dm.val, NamedSharding(mesh, P(axis, None)))
    return dm


def _rows_matmat(op):
    """Adapt whatever operator form the caller gave to the row-layout
    (m, n) -> (m, n) apply the iteration uses.

    DIA matrices apply natively in row layout.  ELL/BSR/sharded
    operators and bare column-layout callables are wrapped with
    transposes."""
    if op is None:
        return None
    if hasattr(op, 'matmat_rows'):
        return op.matmat_rows
    if hasattr(op, 'matmat_t'):
        def apply_rows(v):
            return op.matmat_t(v.T).T
        return apply_rows

    def apply_rows(v):
        return op(v.T).T
    return apply_rows


def _rows_matmat_ops(op, m, n, dtype):
    """Argument-form twin of ``_rows_matmat``: (fn, operands) with
    ``fn(operands, v)`` so the matrix payload flows through the
    superkernel as jit ARGUMENTS.  A closure-captured payload becomes a
    compiled-in literal: every matrix a fresh compile, and at large
    sizes a program carrying hundreds of MB of constants."""
    if op is None:
        return None, ()
    if hasattr(op, 'rows_operand_form'):             # DiaMatrix
        return op.rows_operand_form(m, n, dtype=dtype)
    from ..ops.spmm import BsrMatrix, EllMatrix, rows_matmat_operands
    if isinstance(op, (EllMatrix, BsrMatrix)):
        return rows_matmat_operands(op)
    f0 = _rows_matmat(op)

    def fn(ops, v):
        return f0(v)
    return fn, ()


def default_block(k, n):
    """Default iteration block for ``k`` wanted pairs: k plus slack,
    rounded up to a multiple of 8, the smallest static window size of
    ``algebra.dense_jax.bucket`` (tests pin the iteration behaviour of
    these block sizes)."""
    m = min(n, k + max(8, k // 4))
    return min(n, -(-m // 8) * 8)


def lobpcg(op, k, n=None, opB=None, precond=None, block_size=None,
           tol=1e-4, maxit=500, chunk=16, largest=False, x0=None,
           constraints=None, seed=1, dtype=np.float32, verb=0,
           sharding=None):
    """Compute the ``k`` algebraically smallest (or largest) eigenpairs of
    a symmetric positive (semi-)definite operator — or of the generalized
    pencil (A, B) when ``opB`` is given — entirely on device.

    Parameters
    ----------
    op : object with ``matmat_rows((m, n)) -> (m, n)`` or
        ``matmat_t((n, m)) -> (n, m)`` (a device sparse matrix from
        ops/spmm.py) or a bare jit-traceable column-layout callable.
    k : number of wanted eigenpairs.
    n : problem dimension (required when ``op`` is a bare callable).
    opB : optional right-hand operator of a generalized problem
        A x = λ B x; B must be symmetric (Hermitian) positive definite.
        Same accepted forms as ``op``.  The returned eigenvectors are
        B-orthonormal.
    precond : jit-traceable row-layout (m, n) -> (m, n) approximate
        inverse applied to the residual block (e.g.
        ``Chebyshev._device_fused_rows()``), or None.
    block_size : iteration block m >= k (default: k + max(8, k//4)).
    tol : convergence on ||A x - lmd B x|| <= tol * anorm_est per wanted
        pair, anorm_est = running max |lmd| (scipy.lobpcg convention).
    chunk : device iterations per host dispatch (larger amortizes the
        per-dispatch sync).
    x0 : optional (n, >=m) initial guess block.
    constraints : optional (n, nc) block of prior eigenvectors; the
        iteration is deflated against their B-orthonormalized span, so
        the solver computes the *next* k pairs (warm restart, reference
        core/solver.py:112-114).
    sharding : optional jax.sharding.Sharding for (n, m) column blocks
        (vector dimension sharded over the mesh) — the iteration
        transposes it onto its internal (m, n) row layout; pair it with
        ``shard_operator`` so GSPMD partitions the whole superkernel.

    Returns (lmd (k,), x (n, k), resid (k,), niter, status) with status
    0 = converged, 2 = iteration limit (solver status convention,
    reference core/solver.py:305-331).
    """
    if n is None:
        n = op.shape[0]
    m = block_size or default_block(k, n)
    if m < k:
        raise ValueError('block_size < k')
    jdt = np.dtype(dtype)
    matmat_fn, ops_a = _rows_matmat_ops(op, m, n, jdt)

    def matmat(v):
        # the operator (and preconditioner) may hold values in a different
        # precision; the iteration dtype is authoritative for the carries
        return matmat_fn(ops_a, v).astype(v.dtype)
    if opB is None:
        matmat_b_fn, ops_b = None, ()

        def matmat_b(v):
            return v
    else:
        matmat_b_fn, ops_b = _rows_matmat_ops(opB, m, n, jdt)

        def matmat_b(v):
            return matmat_b_fn(ops_b, v).astype(v.dtype)
    eps = float(np.finfo(np.dtype(dtype).type(0).real.dtype).eps)
    eps_rel = 100 * eps
    sqrt_eps = float(np.sqrt(eps))
    sign = -1.0 if largest else 1.0

    if sharding is not None:
        # callers hand the column-block sharding ((n, m) with n
        # partitioned); the internal row layout needs its transpose
        from jax.sharding import NamedSharding, PartitionSpec
        if not isinstance(sharding, NamedSharding):
            raise TypeError(
                'lobpcg needs a NamedSharding for its column blocks (got '
                '%s); build one with parallel.mesh.blockvec_sharding'
                % type(sharding).__name__)
        spec = tuple(sharding.spec)
        spec = spec + (None,) * (2 - len(spec))
        sharding = NamedSharding(sharding.mesh,
                                 PartitionSpec(spec[1], spec[0]))

    # precond: None, a plain row-layout callable, or the argument-form
    # (fn, operands) pair (e.g. Chebyshev.device_rows_operands()) whose
    # payload then flows through the superkernel as jit arguments
    if precond is None:
        def precond_fn(ops, w):
            return w
        ops_p = ()
    elif isinstance(precond, tuple):
        precond_fn, ops_p = precond
    else:
        def precond_fn(ops, w, _p=precond):
            return _p(w)
        ops_p = ()

    # ---- constraints: B-orthonormalize once, precompute A/B-images -----
    if constraints is not None and np.size(constraints) > 0:
        # the constraint block has its own row count != m, so it must
        # use the shape-flexible apply (matmat_fn may be built for
        # exactly (m, n) blocks)
        mm_any0 = _rows_matmat(op)

        def mm_any(v):
            return mm_any0(v).astype(v.dtype)
        if opB is None:
            def mm_b_any(v):
                return v
        else:
            mm_b_any0 = _rows_matmat(opB)

            def mm_b_any(v):
                return mm_b_any0(v).astype(v.dtype)
        y = jnp.asarray(constraints, dtype=dtype).T
        if sharding is not None:
            y = jax.device_put(y, sharding)
        by0 = mm_b_any(y)
        y, by0, dead_y = _normalize_drop_pair(y, by0, sqrt_eps)
        y, by0, dead_y = _whiten_pair(y, by0, eps_rel, sqrt_eps, dead_y)
        ay = mm_any(y)
        by = mm_b_any(y)
    else:
        y = jnp.zeros((0, n), dtype=dtype)
        ay = by = y

    @partial(jax.jit, static_argnames=('iters',))
    def run(x, ax, bx, p, ap, bp, anorm, y, ay, by, opsA, opsB, opsP,
            iters):
        # operator/preconditioner payloads and the constraint blocks are
        # ARGUMENTS of the superkernel: the compiled program contains no
        # matrix literals, so it caches across matrices
        def matmat(v):
            return matmat_fn(opsA, v).astype(v.dtype)

        if opB is not None:
            def matmat_b(v):
                return matmat_b_fn(opsB, v).astype(v.dtype)
        else:
            def matmat_b(v):
                return v

        def precond(w):
            return precond_fn(opsP, w)

        def body(_, state):
            x, ax, bx, p, ap, bp, anorm = state
            # re-deflate X against the constraints every iteration with
            # exact image tracking: a leaked constraint direction with a
            # more extreme eigenvalue is amplified exponentially by the
            # Rayleigh-Ritz optimization, so the leak must be reset to
            # rounding level each step
            q = _gram(by, x)
            x = x - jnp.matmul(q.T, y, precision=_HI)
            ax = ax - jnp.matmul(q.T, ay, precision=_HI)
            if opB is not None:
                bx = bx - jnp.matmul(q.T, by, precision=_HI)
            else:
                bx = x
            lam = jnp.einsum('mn,mn->m', x.conj(), ax,
                             precision=_HI).real
            anorm = jnp.maximum(anorm, jnp.max(jnp.abs(lam)))
            w = ax - lam[:, None].astype(x.dtype) * bx
            w = precond(w).astype(w.dtype)
            # hierarchical B-orthonormalization: X is B-orthonormal;
            # W ⊥_B Y, X; P ⊥_B Y, X, W.  Dead (noise or rank-deficient)
            # rows are zeroed and masked out of the Rayleigh-Ritz
            # selection.
            w, _, dead_w = _normalize_drop_pair(w, w, sqrt_eps)
            w = _ortho_against_pair(w, y, by)
            w = _ortho_against_pair(w, x, bx)
            bw = matmat_b(w)
            w, bw, dead_w = _normalize_drop_pair(w, bw, sqrt_eps, dead_w)
            w, bw, dead_w = _whiten_pair(w, bw, eps_rel, sqrt_eps, dead_w)
            # fresh Krylov direction: one A application
            aw = matmat(w)
            p, _, dead_p = _normalize_drop_pair(p, p, sqrt_eps)
            p = _ortho_against_pair(p, y, by)
            p = _ortho_against_pair(p, x, bx)
            p = _ortho_against_pair(p, w, bw)
            bp = matmat_b(p)
            p, bp, dead_p = _normalize_drop_pair(p, bp, sqrt_eps, dead_p)
            p, bp, dead_p = _whiten_pair(p, bp, eps_rel, sqrt_eps, dead_p)
            ap = matmat(p)
            s = jnp.concatenate((x, w, p), axis=0)
            a_s = jnp.concatenate((ax, aw, ap), axis=0)
            h = _gram(s, a_s)
            h = 0.5 * (h + h.conj().T) * sign
            dead = jnp.concatenate(
                (jnp.zeros((m,), bool), dead_w, dead_p))
            # push dead (zeroed) basis rows past the live spectrum so
            # the Ritz selection never picks them.  The live spectrum of
            # the (3m x 3m) Gram of a B-orthonormal basis is bounded by
            # 3m * max|diag| (Cauchy-Schwarz on a PSD pencil), so a
            # 4*(3m) multiple clears it while inflating ||h|| — and with
            # it the O(eps*||h||) backward error of a float32 eigh — by
            # only ~1e2 instead of the 1e4 that used to stall f32 runs
            big = (jnp.max(jnp.abs(jnp.diagonal(h))) + 1.0) * \
                (4.0 * s.shape[0])
            h = h + jnp.diag(jnp.where(dead, big, 0.0).astype(h.dtype))
            vals, c = _eigh_small(h)
            cm = c[:, :m]
            xn = jnp.matmul(cm.T, s, precision=_HI)
            axn = jnp.matmul(cm.T, a_s, precision=_HI)
            # conjugate directions: the W/P components of the update
            cwp = cm.at[:m, :].set(0)
            pn = jnp.matmul(cwp.T, s, precision=_HI)
            apn = jnp.matmul(cwp.T, a_s, precision=_HI)
            if opB is not None:
                b_s = jnp.concatenate((bx, bw, bp), axis=0)
                bxn = jnp.matmul(cm.T, b_s, precision=_HI)
                bpn = jnp.matmul(cwp.T, b_s, precision=_HI)
            else:
                bxn, bpn = xn, pn
            return xn, axn, bxn, pn, apn, bpn, anorm

        x, ax, bx, p, ap, bp, anorm = jax.lax.fori_loop(
            0, iters, body, (x, ax, bx, p, ap, bp, anorm))
        # chunk exit: re-deflate and refresh the images so the host's
        # convergence decision sees trustworthy residuals
        q = _gram(by, x)
        x = x - jnp.matmul(q.T, y, precision=_HI)
        ax = matmat(x)
        bx = matmat_b(x)
        lam = jnp.einsum('mn,mn->m', x.conj(), ax,
                         precision=_HI).real
        anorm = jnp.maximum(anorm, jnp.max(jnp.abs(lam)))
        r = ax - lam[:, None].astype(x.dtype) * bx
        resid = jnp.linalg.norm(r, axis=1)
        order = jnp.argsort(sign * lam)
        return x[order], ax[order], bx[order], p, ap, bp, anorm, \
            lam[order], resid[order]

    # ---- initial block -----------------------------------------------
    if x0 is not None:
        x = jnp.asarray(x0, dtype=dtype).T[:m]
        if x.shape[0] < m:
            key = jax.random.PRNGKey(seed)
            x = jnp.concatenate(
                (x, jax.random.normal(key, (m - x.shape[0], n), dtype)),
                axis=0)
    else:
        x = jax.random.normal(jax.random.PRNGKey(seed), (m, n), dtype)
    if sharding is not None:
        x = jax.device_put(x, sharding)

    @jax.jit
    def init_state(x, y, ay, by, opsA, opsB):
        # one program for the whole setup (orthonormalize, images,
        # observability) instead of ~10 separate eager dispatches before
        # the first iteration
        def mm(v):
            return matmat_fn(opsA, v).astype(v.dtype)

        if opB is not None:
            def mm_b(v):
                return matmat_b_fn(opsB, v).astype(v.dtype)
        else:
            def mm_b(v):
                return v
        x2 = _ortho_against_pair(x, y, by)
        bx0 = mm_b(x2)
        x2, bx0, dead_x = _normalize_drop_pair(x2, bx0, sqrt_eps)
        x2, bx, _ = _whiten_pair(x2, bx0, eps_rel, sqrt_eps, dead_x)
        ax = mm(x2)
        lam0 = jnp.einsum('mn,mn->m', x2.conj(), ax, precision=_HI).real
        r0 = jnp.linalg.norm(ax - lam0[:, None].astype(x2.dtype) * bx,
                             axis=1)
        return x2, ax, bx, lam0, r0

    x, ax, bx, lam0, r0 = init_state(x, y, ay, by, ops_a, ops_b)
    p = jnp.zeros_like(x)
    ap = jnp.zeros_like(x)
    bp = p if opB is None else jnp.zeros_like(x)
    anorm = jnp.zeros((), jnp.float32 if np.dtype(dtype).itemsize < 8
                      else jnp.float64)
    lam_h, resid_h = jax.device_get((lam0, r0))
    anorm_h = float(np.max(np.abs(lam_h)))

    niter = 0
    status = 2
    restarts = 0
    stall = 0
    best = np.inf
    while niter < maxit:
        iters = min(chunk, maxit - niter)
        state_in = (x, ax, bx, p, ap, bp, anorm)
        x, ax, bx, p, ap, bp, anorm, lam, resid = run(
            *state_in, y, ay, by, ops_a, ops_b, ops_p, iters)
        niter += iters
        lam_t, resid_t, anorm_t = jax.device_get((lam, resid, anorm))
        if not (np.all(np.isfinite(lam_t)) and np.all(np.isfinite(resid_t))):
            # post-convergence noise blocks can degenerate when the caller
            # over-iterates far past the engine's accuracy floor: roll
            # back to the pre-chunk state, reset the conjugate directions,
            # and retry once; give up (status 3, "no search directions",
            # reference core/solver.py:305-331) on repeat
            x, ax, bx, p, ap, bp, anorm = state_in
            p = jnp.zeros_like(p)
            ap = jnp.zeros_like(p)
            bp = p if opB is None else jnp.zeros_like(p)
            restarts += 1
            if verb > 0:
                print('iter %4d: non-finite chunk, rolling back (%d)'
                      % (niter, restarts))
            if restarts > 2:
                status = 3
                break
            continue
        lam_h, resid_h, anorm_h = lam_t, resid_t, anorm_t
        if verb > 0:
            print('iter %4d: lmd[:%d] %s, resid %s' % (
                niter, min(k, 4), np.round(lam_h[:min(k, 4)], 6),
                np.format_float_scientific(resid_h[:k].max(), 2)))
        rmax = float(resid_h[:k].max())
        if np.all(resid_h[:k] <= tol * max(anorm_h, 1e-30)):
            status = 0
            break
        # stall detection: once the residual stops improving the iterate
        # sits at the engine's accuracy floor — more chunks only risk
        # degeneracy (and waste dispatches)
        if rmax > 0.99 * best:
            stall += 1
            if stall >= 4:
                break
        else:
            stall = 0
        best = min(best, rmax)
    return (np.asarray(lam_h[:k]), np.asarray(x[:k].T),
            np.asarray(resid_h[:k]), niter, status)
