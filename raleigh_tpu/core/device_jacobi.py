"""Device-resident block Jacobi-CG engine with per-vector convergence
control (chunked dispatch).

The host-orchestrated ``core.solver.Solver`` preserves the reference's
control flow exactly (reference raleigh/core/solver.py:587-1663) but pays
~2 synchronous device fetches plus a dozen dispatches per iteration.
This engine is the device-resident formulation of the same iteration for
*standard* problems at one spectrum margin (the dense SVD/PCA workload,
reference interfaces/partial_svd.py:52-122):

  * ``chunk`` iterations run per dispatch inside one jitted XLA program:
    residuals, constraint deflation, hierarchical orthonormalization,
    Rayleigh-Ritz over span[X, W, P] (device ``eigh``), basis update.
    The Jacobi conjugation of the reference (core/solver.py:1321-1355)
    appears here as the locally-optimal three-term recurrence: the RR
    over [X, W, P] yields the same optimally-conjugated new directions
    without per-pair beta denominators.
  * ONE operator application per iteration, like the reference: the
    A-images of X, P and the locked constraints transform exactly under
    row-mixing (A acts on the feature dimension, row combinations
    commute with it), so only the fresh Krylov direction W needs A.
  * per-vector convergence control stays intact: every chunk returns the
    per-iteration eigenvalue history and Ritz-mixing norms (tiny arrays),
    from which the host maintains the same kinematic + residual error
    estimates, stagnation/cluster logic and convergence sweeps as the
    host solver — by *borrowing* ``Solver``'s own methods.  User-supplied
    ``convergence_criteria`` / ``stopping_criteria`` objects (reference
    core/solver.py:125-138, interfaces/truncated_svd.py:205-385) are
    evaluated unchanged against this engine.
  * converged vectors are locked into a fixed-capacity device constraint
    buffer (no dynamic shapes); their block slots are refilled with fresh
    random directions in one jitted refresh call.
"""

import math

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from functools import lru_cache, partial

from .solver import (Solver, Options, DefaultConvergenceCriteria, HISTORY,
                     _find_clusters, _shift_slot_data, EstimatedErrors)

_HI = jax.lax.Precision.HIGHEST


def _cj(a):
    return a.conj() if jnp.iscomplexobj(a) else a


def svd_normal_matmat(adata, transp, shift, aves=None):
    """Build the jit-traceable row-block normal operator of the (implicitly
    mean-shifted) data matrix: x (mb, d) -> x (B B^H)^T with B = A - e a^T,
    matching _OperatorSVD.apply (reference partial_svd.py:258-291,
    this repo interfaces/partial_svd.py:48-74).

    Returns (matmat, operands): ``matmat(operands, x)`` with the data
    arrays passed as an ARGUMENT pytree, never a closure constant — a
    closed-over jax.Array is baked into the compiled program as a
    literal, so every new dataset would re-compile the whole chunk
    superkernel (and defeat the persistent compilation cache).

    The returned function object is cached per (transp, shift, m) so
    that repeated calls hand the engine the SAME callable — the shared
    kernel cache below then reuses the loaded executables across engine
    instances instead of paying a first execution per solve."""
    m = adata.shape[0]
    operands = (adata, aves) if shift else (adata,)
    return _normal_matmat_fn(bool(transp), bool(shift), m), operands


@lru_cache(maxsize=64)
def _normal_matmat_fn(transp, shift, m):
    if transp:
        def matmat(ops, x):
            adata = ops[0]
            z = jnp.matmul(x, _cj(adata), precision=_HI)
            if shift:
                s = jnp.sum(x, axis=1, keepdims=True)      # x e
                z = z - s * ops[1][None, :].astype(z.dtype)
            y = jnp.matmul(z, adata.T, precision=_HI)
            if shift:
                s = jnp.matmul(z, _cj(ops[1])[:, None], precision=_HI)
                y = y - s
            return y
    else:
        def matmat(ops, x):
            adata = ops[0]
            z = jnp.matmul(x, adata.T, precision=_HI)
            if shift:
                for _ in range(2):   # double orthogonalization for accuracy
                    s = jnp.sum(z, axis=1, keepdims=True)
                    z = z - s / m
            return jnp.matmul(z, _cj(adata), precision=_HI)
    return matmat


# Shared kernel store: engine instances with the same operator identity
# (the function objects themselves — held strongly here, so CPython
# cannot recycle their ids) and signature share jitted kernels.  Without
# this every PCA/EVP call builds fresh jit closures, and each program's
# first execution pays an executable load (~10 programs per solve).
_SHARED_KERNELS = {}
_SHARED_KERNELS_MAX = 64


class DeviceJacobi:
    """Chunked device engine computing the ``nwanted`` largest eigenpairs
    of a symmetric/Hermitian jit-traceable operator, with Solver-compatible
    observability (criteria and stopping objects see the same attribute
    surface as ``core.solver.Solver``)."""

    # borrowed Solver machinery: identical observability/estimation logic
    convergence_data = Solver.convergence_data
    _estimate_errors = Solver._estimate_errors
    _sweep = Solver._sweep
    _print_iterate_table = Solver._print_iterate_table

    def __init__(self, matmat, dim, dtype=np.float32, precond=None,
                 operands=None, matmat_b=None, operands_b=None):
        """``operands``: optional pytree of device arrays the operator
        works on; when given, ``matmat`` is called as
        ``matmat(operands, x)`` and the arrays flow through the chunk
        superkernel as ARGUMENTS.  Closure-captured jax.Arrays would be
        baked into the compiled program as literals — every dataset a
        fresh compile and a cache entry carrying the whole matrix.

        ``matmat_b`` (optional): right-hand operator of a generalized
        pencil A x = lmd B x (B symmetric/Hermitian positive definite);
        the whole iteration then runs in the B-inner product with exact
        tracking of B-images alongside the A-images (the pattern of the
        LOBPCG superkernel, core/device_solver.py:80-152), preserving
        per-vector convergence control for gen problems (reference
        problem types std/gen in one engine, core/solver.py:224-258)."""
        self.matmat = matmat
        self.dim = int(dim)
        self.dtype = np.dtype(dtype).type
        # precond: plain row-layout callable, or argument-form
        # (fn, operands) (e.g. Chebyshev.device_rows_operands()) whose
        # payload then flows through the chunk superkernel as arguments
        if isinstance(precond, tuple):
            self.precond, self._operands_p = precond
            self._precond_has_ops = True
        else:
            self.precond = precond
            self._operands_p = ()
            self._precond_has_ops = False
        self._operands = operands
        self.matmat_b = matmat_b
        self._operands_b = operands_b
        self.has_b = matmat_b is not None
        # Solver-compatible public state
        self.iteration = 0
        self.lcon = 0
        self.rcon = 0
        self.eigenvalues = np.zeros((0,), dtype=np.float64)
        self.eigenvalue_errors = EstimatedErrors()
        self.eigenvector_errors = EstimatedErrors()
        self.residual_norms = np.zeros((0,), dtype=np.float32)
        self.convergence_status = np.zeros((0,), dtype=np.int32)
        self.block_size = None
        self.cnv = None
        self.lmd = None
        self.res = None
        self.err_lmd = None
        self.err_X = None
        self._xc = None       # (K, dim) locked rows, zero beyond _nc
        self._axc = None
        self._nc = 0
        ident = (self.dim, np.dtype(dtype).str, self.matmat, self.precond,
                 self._precond_has_ops, self.matmat_b,
                 operands is not None, operands_b is not None)
        try:
            if len(_SHARED_KERNELS) >= _SHARED_KERNELS_MAX:
                _SHARED_KERNELS.clear()
            self._kernels = _SHARED_KERNELS.setdefault(ident, {})
        except TypeError:       # unhashable operator callables
            self._kernels = {}

    # -- Solver API surface used by stopping criteria ---------------------

    @property
    def eigenvectors(self):
        """Converged eigenvectors as a device Vectors (rows), built lazily
        for stopping-criteria consumers (truncated_svd.py:285-318)."""
        from ..algebra import dense_jax
        if self._nc == 0:
            return dense_jax.Vectors(self.dim, 0, self.dtype)
        return dense_jax.Vectors(self._xc[:self._nc])

    def problem(self):
        return self

    def _mm(self, x):
        """Apply the operator eagerly (outside the chunk superkernel)."""
        if self._operands is not None:
            return self.matmat(self._operands, x)
        return self.matmat(x)

    def _mm_b(self, x):
        if self._operands_b is not None:
            return self.matmat_b(self._operands_b, x)
        return self.matmat_b(x)

    # -- jitted kernels (compiled per (m, K) signature) --------------------

    def _build(self, m, K):
        key = (m, K)
        if key in self._kernels:
            return self._kernels[key]
        matmat0 = self.matmat
        has_ops = self._operands is not None
        matmat_b0 = self.matmat_b
        has_ops_b = self._operands_b is not None
        has_b = self.has_b
        precond0 = self.precond
        precond_has_ops = self._precond_has_ops
        eps = float(np.finfo(np.dtype(self.dtype).type(0).real.dtype).eps)
        eps_rel = 100 * eps
        sqrt_eps = float(np.sqrt(eps))

        def _gram(a, b):
            # rows are vectors: G[i, j] = <a_i, b_j>
            return jnp.matmul(_cj(a), b.T, precision=_HI)

        def _norm_drop(block, dead0=None, bblock=None):
            """Unit-normalize rows; rows that collapsed below sqrt(eps)
            of the block's largest are noise — zero and flag.  Norms are
            B-norms when ``bblock`` (the tracked B-image) is given; the
            image receives the identical row scaling (exact)."""
            other = block if bblock is None else bblock
            norms = jnp.sqrt(jnp.maximum(jnp.einsum(
                'ij,ij->i', _cj(block), other).real, 0.0))
            ref = jnp.maximum(jnp.max(norms), 1e-30)
            dead = norms <= sqrt_eps * ref
            if dead0 is not None:
                dead = dead | dead0
            safe = jnp.where(norms == 0, 1.0, norms).astype(block.dtype)
            out = jnp.where(dead[:, None], 0.0, block / safe[:, None])
            bout = None if bblock is None else \
                jnp.where(dead[:, None], 0.0, bblock / safe[:, None])
            return out, bout, dead, norms

        def _whiten(block, dead0=None, bblock=None):
            """(B-)orthonormalize rows by eigh-whitening of the (B-)Gram;
            near-dependent directions zeroed and flagged."""
            g = _gram(block, block if bblock is None else bblock)
            g = 0.5 * (g + g.conj().T)
            w, v = jnp.linalg.eigh(g)
            wmax = jnp.maximum(w[-1], 0.0)
            dead_g = w <= wmax * eps_rel
            inv = jnp.where(dead_g, 0.0,
                            1.0 / jnp.sqrt(jnp.where(dead_g, 1.0, w)))
            mix = (v * inv[None, :]).T.conj()        # rows := mix @ rows
            bw = jnp.matmul(mix, block, precision=_HI)
            bbw = None if bblock is None else \
                jnp.matmul(mix, bblock, precision=_HI)
            out, bout, dead, _ = _norm_drop(bw, dead0, bbw)
            return out, bout, dead, mix

        def _whiten_linear(block, dead0=None, bblock=None):
            """Whitening as a PURE linear row-mixing (out = mix @ block
            exactly, dead rows zeroed without rescaling) so tracked A/B
            images stay exact under img := mix @ img.

            The drop cutoff is sqrt(eps), much looser than _whiten's: the
            mixing amplifies the tracked images' rounding error by up to
            1/sqrt(cutoff), and a nearly-dependent conjugate direction is
            noise, not signal — dropping it costs nothing."""
            other = block if bblock is None else bblock
            g = _gram(block, other)
            g = 0.5 * (g + g.conj().T)
            w, v = jnp.linalg.eigh(g)
            wmax = jnp.maximum(w[-1], 0.0)
            dead_g = w <= wmax * sqrt_eps
            inv = jnp.where(dead_g, 0.0,
                            1.0 / jnp.sqrt(jnp.where(dead_g, 1.0, w)))
            mix = (v * inv[None, :]).T.conj()
            bw = jnp.matmul(mix, block, precision=_HI)
            bbw = None if bblock is None else \
                jnp.matmul(mix, bblock, precision=_HI)
            # zero-only noise mask: a correctly whitened live row has unit
            # (B-)norm; rows far from it are rounding noise
            norms = jnp.sqrt(jnp.maximum(jnp.einsum(
                'ij,ij->i', _cj(bw), bw if bbw is None else bbw).real,
                0.0))
            dead = norms <= 0.5
            if dead0 is not None:
                dead = dead | dead0
            out = jnp.where(dead[:, None], 0.0, bw)
            bout = None if bbw is None else \
                jnp.where(dead[:, None], 0.0, bbw)
            return out, bout, dead, mix

        def _ortho_rows(block, basis, bbasis=None):
            # two-pass classical Gram-Schmidt against a (B-)orthonormal
            # basis; coefficients come from the basis's B-image when
            # given.  Returns block and the total subtracted
            # coefficients (exact, for A/B-image tracking)
            if bbasis is None:
                bbasis = basis
            q_tot = None
            for _ in range(2):
                q = _gram(block, bbasis)
                block = block - jnp.matmul(q, basis, precision=_HI)
                q_tot = q if q_tot is None else q_tot + q
            return block, q_tot

        def _pack(x, ax, bx, p, ap, bp, xc, axc, bxc, anorm):
            if has_b:
                return (x, ax, bx, p, ap, bp, xc, axc, bxc, anorm)
            return (x, ax, p, ap, xc, axc, anorm)

        def _unpack(state):
            if has_b:
                return state
            x, ax, p, ap, xc, axc, anorm = state
            return x, ax, x, p, ap, p, xc, axc, xc, anorm

        @partial(jax.jit, static_argnames=('iters',), donate_argnums=(0,))
        def run_chunk(state, ops, ops_b, ops_p, iters):
            matmat = (lambda x: matmat0(ops, x)) if has_ops else matmat0
            if has_b:
                matmat_b = (lambda x: matmat_b0(ops_b, x)) if has_ops_b \
                    else matmat_b0
            precond = (lambda w: precond0(ops_p, w)) if precond_has_ops \
                else precond0

            def body(t, carry):
                x, ax, bx, p, ap, bp, xc, axc, bxc, anorm, lam_h, dx_h = \
                    _unpack(carry[:-2]) + carry[-2:]
                # re-deflate X against the locked set every iteration: a
                # locked direction with a larger eigenvalue amplifies any
                # f32 leak exponentially through the Rayleigh-Ritz
                # maximization, so the leak must be reset to rounding
                # level each step (A/B-images follow exactly: row ops
                # commute with the operators)
                qx = _gram(x, bxc)
                x = x - jnp.matmul(qx, xc, precision=_HI)
                ax = ax - jnp.matmul(qx, axc, precision=_HI)
                bx = x if not has_b else \
                    bx - jnp.matmul(qx, bxc, precision=_HI)
                lam = jnp.einsum('ij,ij->i', _cj(x), ax,
                                 precision=_HI).real
                anorm = jnp.maximum(anorm, jnp.max(jnp.abs(lam)).astype(anorm.dtype))
                lam_h = lax.dynamic_update_slice_in_dim(
                    lam_h, lam[None, :].astype(lam_h.dtype), t, 0)
                w = ax - lam[:, None].astype(x.dtype) * bx
                if precond is not None:
                    w = precond(w).astype(w.dtype)
                # deflate against locked constraints (zero rows of xc are
                # no-ops, so no count masking is needed); B-inner products
                # contract against the tracked B-images
                w, _ = _ortho_rows(w, xc, bxc)
                w, _, dead_w, _ = _norm_drop(w)
                w, _ = _ortho_rows(w, x, bx)
                if has_b:
                    bw = matmat_b(w).astype(w.dtype)
                    w, bw, dead_w, _ = _norm_drop(w, dead_w, bw)
                    w, bw, dead_w, _ = _whiten(w, dead_w, bw)
                else:
                    w, _, dead_w, _ = _norm_drop(w, dead_w)
                    w, _, dead_w, _ = _whiten(w, dead_w)
                    bw = w
                # fresh Krylov direction: the single A application
                aw = matmat(w).astype(w.dtype)
                # conjugate directions: deflate and re-orthonormalize with
                # exact A/B-image tracking — every transform of P here is
                # a pure row operation, which commutes with the operators,
                # so AP (and BP) follow through the same coefficients
                p, bp_n, dead_p, nrm = _norm_drop(
                    p, bblock=bp if has_b else None)
                safe = jnp.where(nrm == 0, 1.0, nrm).astype(p.dtype)
                ap = jnp.where(dead_p[:, None], 0.0, ap / safe[:, None])
                bp = p if not has_b else bp_n
                qc, q1 = _ortho_rows(p, xc, bxc)
                ap = ap - jnp.matmul(q1, axc, precision=_HI)
                if has_b:
                    bp = bp - jnp.matmul(q1, bxc, precision=_HI)
                p = qc
                p, q2 = _ortho_rows(p, x, bx)
                ap = ap - jnp.matmul(q2, ax, precision=_HI)
                if has_b:
                    bp = bp - jnp.matmul(q2, bx, precision=_HI)
                p, q3 = _ortho_rows(p, w, bw)
                ap = ap - jnp.matmul(q3, aw, precision=_HI)
                if has_b:
                    bp = bp - jnp.matmul(q3, bw, precision=_HI)
                    p, bp, dead_p, mix = _whiten_linear(p, dead_p, bp)
                else:
                    p, _, dead_p, mix = _whiten_linear(p, dead_p)
                ap = jnp.matmul(mix, ap, precision=_HI)
                ap = jnp.where(dead_p[:, None], 0.0, ap)
                if not has_b:
                    bp = p

                s = jnp.concatenate((x, w, p), axis=0)       # (3m, n) rows
                a_s = jnp.concatenate((ax, aw, ap), axis=0)
                h = _gram(s, a_s)
                h = 0.5 * (h + h.conj().T)
                dead = jnp.concatenate(
                    (jnp.zeros((m,), bool), dead_w, dead_p))
                # push dead columns just below the live spectrum so the
                # top-m Ritz selection never picks them; a moderate shift
                # keeps ||H|| (and with it f32 eigh's absolute error) of
                # the same order as the live eigenvalues
                big = (jnp.max(jnp.abs(jnp.diagonal(h))) + 1.0) * 3.0
                h = h - jnp.diag(jnp.where(dead, big, 0.0).astype(h.dtype))
                vals, c = jnp.linalg.eigh(h)                 # ascending
                cm = c[:, 2 * m:]                            # top m
                xn = jnp.matmul(cm.T, s, precision=_HI)
                axn = jnp.matmul(cm.T, a_s, precision=_HI)
                # kinematic dX: norms of the (W, P)-components of the new X
                dx = jnp.sqrt(jnp.einsum(
                    'ij,ij->j', _cj(cm[m:]), cm[m:]).real)
                dx_h = lax.dynamic_update_slice_in_dim(
                    dx_h, dx[None, :].astype(dx_h.dtype), t, 0)
                cwp = cm.at[:m, :].set(0)
                pn = jnp.matmul(cwp.T, s, precision=_HI)
                apn = jnp.matmul(cwp.T, a_s, precision=_HI)
                if has_b:
                    b_s = jnp.concatenate((bx, bw, bp), axis=0)
                    bxn = jnp.matmul(cm.T, b_s, precision=_HI)
                    bpn = jnp.matmul(cwp.T, b_s, precision=_HI)
                else:
                    bxn, bpn = xn, pn
                return _pack(xn, axn, bxn, pn, apn, bpn, xc, axc, bxc,
                             anorm) + (lam_h, dx_h)

            # the eigenvalue history must carry the engine's REAL dtype:
            # an f32 history under an f64 iteration quantizes decrements
            # at ~eps32*|lam|, and that noise reads as fake progress to
            # the stagnation/kinematic machinery (pairs never lock)
            rdt = jnp.zeros((), state[0].dtype).real.dtype
            carry = state + (jnp.zeros((iters, m), rdt),
                             jnp.zeros((iters, m), jnp.float32))
            carry = lax.fori_loop(0, iters, body, carry)
            lam_h, dx_h = carry[-2:]
            x, ax, bx, p, ap, bp, xc, axc, bxc, anorm = _unpack(
                carry[:-2])
            # deflate the last update's leak, then refresh the tracked
            # A/B-images of X at chunk exit: RR-updated images drift by
            # f32 rounding (the host solver bounds the same drift with its
            # Ritz-quality restart, reference core/solver.py:854-920), and
            # the lock/convergence decisions made from this chunk's exit
            # data must be trustworthy
            qx = _gram(x, bxc)
            x = x - jnp.matmul(qx, xc, precision=_HI)
            ax = matmat(x).astype(x.dtype)
            bx = matmat_b(x).astype(x.dtype) if has_b else x
            lam = jnp.einsum('ij,ij->i', _cj(x), ax, precision=_HI).real
            anorm = jnp.maximum(anorm, jnp.max(jnp.abs(lam)).astype(anorm.dtype))
            r = ax - lam[:, None].astype(x.dtype) * bx
            res = jnp.sqrt(jnp.einsum('ij,ij->i', _cj(r), r).real)
            g = _gram(x, bx)
            gram_err = jnp.max(jnp.abs(g - jnp.eye(m, dtype=g.dtype)))
            return _pack(x, ax, bx, p, ap, bp, xc, axc, bxc, anorm), \
                lam, res, lam_h, dx_h, gram_err

        if has_b:
            @partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4, 5))
            def lock_refresh_b(x, ax, bx, xc, axc, bxc, nc, cnt_mask,
                               fresh):
                """B-mode lock: move flagged rows (with their exact A/B
                images) into the constraint buffers, compact the kept
                rows, place fresh random rows on top UNNORMALIZED — the
                caller B-orthonormalizes via ``entry_fix`` after
                recomputing the B-image (fresh rows have none yet)."""
                idx = jnp.argsort(jnp.where(cnt_mask, 0, 1), stable=True)
                x_s = jnp.take(x, idx, axis=0)
                ax_s = jnp.take(ax, idx, axis=0)
                bx_s = jnp.take(bx, idx, axis=0)
                cnt = jnp.sum(cnt_mask)
                rows = jnp.arange(m)
                dst = jnp.where(rows < cnt, nc + rows, K)
                xc = xc.at[dst].set(x_s, mode='drop')
                axc = axc.at[dst].set(ax_s, mode='drop')
                bxc = bxc.at[dst].set(bx_s, mode='drop')
                keep = jnp.argsort(jnp.where(cnt_mask, 1, 0), stable=True)
                xk = jnp.take(x, keep, axis=0)
                live = rows < (m - cnt)
                xk = jnp.where(live[:, None], xk, fresh)
                return xk, xc, axc, bxc

            @jax.jit
            def entry_fix(x, bx, xc, bxc):
                """B-orthonormalize a refreshed block: two-pass deflation
                against the locked set in the B-inner product, then
                B-whitening — both exact on the tracked B-image."""
                for _ in range(2):
                    q = _gram(x, bxc)
                    x = x - jnp.matmul(q, xc, precision=_HI)
                    bx = bx - jnp.matmul(q, bxc, precision=_HI)
                x, bx, dead, _ = _norm_drop(x, bblock=bx)
                x, bx, dead, _ = _whiten(x, dead, bx)
                return x, bx

            self._kernels[key] = (run_chunk, lock_refresh_b, entry_fix)
            return self._kernels[key]

        @partial(jax.jit, donate_argnums=(0, 1, 2, 3))
        def lock_refresh(x, ax, xc, axc, nc, cnt_mask, fresh):
            """Move the rows of x flagged in ``cnt_mask`` (a (m,) bool mask,
            True for locked slots — always the top ``cnt`` slots) into the
            constraint buffers at row ``nc``..; compact the remaining rows
            down; fill the freed top slots with ``fresh`` random rows
            orthogonalized against everything; re-orthonormalize x and
            recompute nothing (AX of kept rows is exact; fresh rows get
            their A-image on the next chunk's first iteration via W... no:
            X needs AX now).  Returns (x, ax_keep_marker, xc, axc).

            AX for the refreshed block is recomputed by the caller with one
            operator application (unavoidable: fresh rows are new)."""
            # stable partition: locked rows first (to copy out), kept after
            idx = jnp.argsort(jnp.where(cnt_mask, 0, 1), stable=True)
            x_sorted = jnp.take(x, idx, axis=0)
            ax_sorted = jnp.take(ax, idx, axis=0)
            cnt = jnp.sum(cnt_mask)
            # scatter locked rows into xc[nc : nc+cnt] without dynamic
            # shapes: row j of x_sorted (j < cnt) goes to xc row nc + j
            rows = jnp.arange(m)
            dst = nc + rows
            ok = rows < cnt
            dst = jnp.where(ok, dst, K)          # K = out-of-range drop
            xc = xc.at[dst].set(x_sorted, mode='drop')
            axc = axc.at[dst].set(ax_sorted, mode='drop')
            # compact kept rows to the bottom, fresh random rows on top
            keep = jnp.argsort(jnp.where(cnt_mask, 1, 0), stable=True)
            xk = jnp.take(x, keep, axis=0)
            axk = jnp.take(ax, keep, axis=0)
            live = rows < (m - cnt)
            xk = jnp.where(live[:, None], xk, fresh)
            # orthogonalize fresh rows (all rows; kept ones are already
            # orthonormal and unaffected up to rounding)
            for _ in range(2):
                q = jnp.matmul(_cj(xk), xc.T, precision=_HI)
                xk = xk - jnp.matmul(q, xc, precision=_HI)
            g = jnp.matmul(_cj(xk), xk.T, precision=_HI)
            w, v = jnp.linalg.eigh(g)
            wmax = jnp.maximum(w[-1], 0.0)
            dead_g = w <= wmax * eps_rel
            inv = jnp.where(dead_g, 0.0,
                            1.0 / jnp.sqrt(jnp.where(dead_g, 1.0, w)))
            mix = (v * inv[None, :]).T.conj()
            xk = jnp.matmul(mix, xk, precision=_HI)
            return xk, axk, xc, axc

        self._kernels[key] = (run_chunk, lock_refresh)
        return self._kernels[key]

    # -- driver ------------------------------------------------------------

    def solve(self, eigenvectors, options=None, nwanted=-1, chunk=8,
              verb=0, pipeline=1):
        """Compute eigenpairs at the upper margin; converged eigenvectors
        are appended (as rows) to ``eigenvectors``.  Returns a Solver-
        compatible status: 0 success, 2 iteration limit, 3 no search
        directions.

        ``pipeline``: chunks kept in flight beyond the one whose stats
        the host is processing.  The default is 1 (serial): measured on
        the flagship PCA workload, speculative depth 2 DEGRADES locked
        accuracy — a slot judged converged at chunk k has near-zero
        residual, so during chunk k+1 its fresh search direction is
        numerically dead and the in-chunk dead-column handling can
        replace it before the deferred lock lands.  Prompt locking is
        load-bearing; the sync cost is attacked by the shared kernel
        store (loaded executables reused across solves) instead."""
        if options is None:
            options = Options()
        verb = max(verb, options.verbosity)
        criteria = (options.convergence_criteria or
                    DefaultConvergenceCriteria())
        stopping = options.stopping_criteria
        detect_stagn = options.detect_stagnation
        n = self.dim
        m = options.block_size
        if m is None or m < 1:
            m = 128 if (nwanted < 0 or nwanted > 100) else \
                max(16, nwanted + nwanted // 4)
        m = min(m, max(8, n // 4))
        self.block_size = m
        max_iter = options.max_iter if options.max_iter >= 0 else 100
        min_iter = options.min_iter

        K = self._cap_for(nwanted, m)
        dtype = self.dtype
        cdt = np.complex64 if np.dtype(dtype).kind == 'c' else None

        # host-side per-slot state (Solver-compatible names)
        self.cnv = np.zeros((m,), dtype=np.int32)
        self.lmd = np.zeros((m,), dtype=np.float64)
        self.res = -np.ones((m,), dtype=np.float32)
        self.err_lmd = -np.ones((2, m), dtype=np.float32)
        self.err_X = -np.ones((2, m), dtype=np.float32)
        iterations = np.zeros((m,), dtype=np.int32)
        dlmd = np.zeros((m, HISTORY), dtype=np.float32)
        dX = np.ones((m,), dtype=np.float32)
        acf = np.ones((2, m), dtype=np.float32)
        cluster = np.zeros((2, m), dtype=np.int32)
        rec = 0
        dlmd_min_right = 0.0
        epsilon = float(np.finfo(np.dtype(dtype).type(0).real.dtype).eps)

        has_b = self.has_b
        if has_b:
            run_chunk, lock_refresh_b, entry_fix = self._build(m, K)
        else:
            run_chunk, lock_refresh = self._build(m, K)

        # initial block: reproducible host randomness (matches backend
        # convention, dense_jax.py fill_random)
        x0 = (2 * np.random.rand(m, n) - 1).astype(dtype)
        if cdt is not None:
            x0 = x0 + 1j * (2 * np.random.rand(m, n) - 1).astype(np.float32)
        x = jnp.asarray(x0)
        # include any pre-existing constraints
        self._xc = jnp.zeros((K, n), dtype=x.dtype)
        self._axc = jnp.zeros((K, n), dtype=x.dtype)
        self._bxc = jnp.zeros((K, n), dtype=x.dtype) if has_b else None
        self._nc = 0
        nc0 = eigenvectors.nvec()
        if nc0 > 0:
            rows = eigenvectors.device_data().astype(x.dtype)
            self._xc = self._xc.at[:nc0].set(rows)
            self._axc = self._axc.at[:nc0].set(
                self._mm(rows).astype(x.dtype))
            if has_b:
                self._bxc = self._bxc.at[:nc0].set(
                    self._mm_b(rows).astype(x.dtype))
            self._nc = nc0
        anorm = jnp.zeros((), jnp.float32)
        if has_b:
            bx = self._mm_b(x).astype(x.dtype)
            x, bx = entry_fix(x, bx, self._xc, self._bxc)
            ax = self._mm(x).astype(x.dtype)
            p = jnp.zeros_like(x)
            state = (x, ax, bx, p, jnp.zeros_like(x), jnp.zeros_like(x),
                     self._xc, self._axc, self._bxc, anorm)
        else:
            fresh0 = jnp.zeros((m, n), dtype=x.dtype)
            x, _ax_drop, self._xc, self._axc = lock_refresh(
                x, jnp.zeros_like(x), self._xc, self._axc,
                jnp.asarray(self._nc, jnp.int32),
                jnp.zeros((m,), bool), fresh0)
            ax = self._mm(x).astype(x.dtype)
            p = jnp.zeros_like(x)
            ap = jnp.zeros_like(x)
            state = (x, ax, p, ap, self._xc, self._axc, anorm)

        self.iteration = 0
        self.rcon = 0
        self.lcon = 0
        status = 2

        # Chunked dispatch loop: ONE stats sync per chunk of iterations
        # (the only per-chunk host<->device round trip).  With
        # ``pipeline`` > 1 further chunks dispatch speculatively before
        # the sync and the convergence sweep lags the newest state,
        # locking deferred until the pipeline drains — see the solve()
        # docstring for why that is NOT the default.
        inflight = []             # [(iters, stat handles), ...]
        dispatched = 0            # iterations dispatched (>= replayed)

        def dispatch_chunk():
            nonlocal state, dispatched
            iters = int(min(chunk, max(1, max_iter - dispatched)))
            state, lam_k, res_k, lam_h_k, dx_h_k, ge_k = run_chunk(
                state, self._operands, self._operands_b,
                self._operands_p, iters)
            # run_chunk donates its input state: re-point the constraint
            # buffers at the live copies
            if has_b:
                self._xc, self._axc, self._bxc = state[6:9]
            else:
                self._xc, self._axc = state[4], state[5]
            dispatched += iters
            inflight.append((iters, (lam_k, res_k, lam_h_k, dx_h_k, ge_k)))

        draining = False          # lock pending: stop dispatching ahead
        pending_rcon = 0          # sweep verdict carried across the drain

        while True:
            if np.amax(iterations) >= max_iter and not inflight:
                status = 2
                break
            while (not draining and len(inflight) < max(1, int(pipeline))
                   and dispatched < max_iter):
                dispatch_chunk()
            iters, handles = inflight.pop(0)
            lam, res, lam_h, dx_h, gram_err = jax.device_get(handles)
            if (gram_err > math.sqrt(epsilon)
                    or not np.all(np.isfinite(lam))):
                # Ritz-quality restart (reference core/solver.py:854-920):
                # re-orthonormalize the block against the constraints,
                # recompute its A-image, reset conjugate directions.
                # In-flight speculative chunks continued the degenerate
                # trajectory — count their iterations, drop their stats
                for it2, _h in inflight:
                    iterations += it2
                    self.iteration += it2
                inflight.clear()
                draining = False
                # a pre-restart sweep verdict is void: the block is
                # re-orthonormalized and re-sorted below
                pending_rcon = 0
                if verb > 0:
                    print('restarting (block non-orthonormality %.1e)...'
                          % gram_err)
                x = state[0]
                x = jnp.where(jnp.isfinite(x), x, 0)
                if has_b:
                    xc, axc, bxc = state[6:9]
                    self._xc, self._axc, self._bxc = xc, axc, bxc
                    bx = self._mm_b(x).astype(x.dtype)
                    x, bx = entry_fix(x, bx, xc, bxc)
                    ax = self._mm(x).astype(x.dtype)
                    z = jnp.zeros_like(x)
                    state = (x, ax, bx, z, jnp.zeros_like(x),
                             jnp.zeros_like(x), xc, axc, bxc, state[9])
                else:
                    x, _, xc, axc = lock_refresh(
                        x, state[1], state[4], state[5],
                        jnp.asarray(self._nc, jnp.int32),
                        jnp.zeros((m,), bool), jnp.zeros((m, n), x.dtype))
                    self._xc, self._axc = xc, axc
                    ax = self._mm(x).astype(x.dtype)
                    state = (x, ax, jnp.zeros_like(x), jnp.zeros_like(x),
                             xc, axc, state[6])
                rec = 0
                dlmd[:] = 0
                iterations += iters
                self.iteration += iters
                continue
            # replay the in-chunk trajectories iteration by iteration so
            # the kinematic machinery evolves exactly as it does in the
            # host loop (estimates computed while decrements are still
            # above the recording threshold persist after convergence;
            # _estimate_errors only overwrites entries it has fresh
            # information for)
            sqeps = math.sqrt(epsilon)
            for t in range(iters):
                before = lam_h[t].astype(np.float64)
                after = (lam_h[t + 1].astype(np.float64) if t + 1 < iters
                         else lam.astype(np.float64))
                if rec == HISTORY:
                    dlmd[:, :-1] = dlmd[:, 1:]
                else:
                    rec += 1
                delta = before - after
                eps_d = sqeps * np.maximum(np.abs(before), np.abs(after))
                dlmd[:, rec - 1] = np.where(np.abs(delta) > eps_d,
                                            delta, 0.0)
                dX[:] = dx_h[t]
                self.lmd[:] = after
                self._estimate_errors(0, m, 0, m, m, rec, dlmd, dX, acf,
                                      self.lmd, self.res, self.err_lmd,
                                      self.err_X, False, verb)
            iterations += iters
            self.iteration += iters
            self.lmd[:] = lam
            self.res[:] = res
            if verb > 1:
                self._print_iterate_table(m, self.lmd, self.res,
                                          self.err_lmd, self.err_X, acf)
            eps_stag = epsilon ** 0.67
            dlmd_min_rgt = eps_stag * np.amax(np.abs(dlmd[:, rec - 1]))
            if self.iteration <= 2 * chunk:
                dlmd_min_right = dlmd_min_rgt
            _find_clusters(cluster, self.lmd, 0, m, 0.0, dlmd_min_rgt)

            rcon = self._sweep(side='right', count=m, left=0, right=max(
                nwanted, 1) if nwanted > 0 else m, ix=0, nx=m,
                shift_invert=False, lmd=self.lmd, iterations=iterations,
                min_iter=min_iter, criteria=criteria,
                detect_stagn=detect_stagn, dlmd=dlmd, rec=rec,
                dlmd_min=dlmd_min_right, cluster=cluster, res=self.res,
                err_X=self.err_X, verb=verb)
            if nwanted > 0:
                rcon = min(rcon, nwanted - self.rcon)
            # a sweep verdict from before the drain survives it: the
            # extra iterations can invalidate the freshness of the
            # kinematic estimates the criteria consult, so the re-sweep
            # alone may no longer fire for slots already judged converged
            rcon = max(rcon, pending_rcon)

            if rcon > 0 and inflight:
                # convergence detected on stats one chunk behind the
                # newest state: drain the pipeline first, so locking acts
                # on a state consistent with the stats it was judged by
                # (the converged slots just iterate a few more nearly
                # free iterations meanwhile)
                pending_rcon = rcon
                draining = True
                continue
            pending_rcon = 0
            draining = False

            if rcon > 0 and self._nc + rcon > K:
                # grow constraint capacity (rebuilds the kernels); only
                # reachable in tolerance/interactive-driven mode
                K2 = min(max(2 * K, self._nc + rcon + m), n)
                if K2 <= K:
                    status = 1
                    break
                if has_b:
                    x, ax, bx, p, ap, bp, xc, axc, bxc, anorm = state
                else:
                    x, ax, p, ap, xc, axc, anorm = state
                xc = jnp.zeros((K2, n), xc.dtype).at[:K].set(xc)
                axc = jnp.zeros((K2, n), axc.dtype).at[:K].set(axc)
                K = K2
                self._xc, self._axc = xc, axc
                if has_b:
                    bxc = jnp.zeros((K2, n), bxc.dtype).at[:bxc.shape[0]] \
                        .set(bxc)
                    self._bxc = bxc
                    state = (x, ax, bx, p, ap, bp, xc, axc, bxc, anorm)
                    run_chunk, lock_refresh_b, entry_fix = self._build(m, K)
                else:
                    state = (x, ax, p, ap, xc, axc, anorm)
                    run_chunk, lock_refresh = self._build(m, K)

            if rcon > 0:
                first = m - rcon
                # record in ascending slot order (reference _lock order,
                # core/solver.py:1197-1263)
                self.eigenvalues = np.concatenate(
                    (self.eigenvalues, self.lmd[first:]))
                self.eigenvalue_errors.append(self.err_lmd[:, first:])
                self.eigenvector_errors.append(self.err_X[:, first:])
                self.residual_norms = np.concatenate(
                    (self.residual_norms, self.res[first:]))
                self.convergence_status = np.concatenate(
                    (self.convergence_status, self.cnv[first:]))
                self.rcon += rcon
                mask = np.zeros((m,), bool)
                mask[first:] = True
                fr = (2 * np.random.rand(rcon, n) - 1).astype(dtype)
                if cdt is not None:
                    fr = fr + 1j * (2 * np.random.rand(rcon, n) - 1).astype(
                        np.float32)
                if has_b:
                    x, ax, bx, p, ap, bp, xc, axc, bxc, anorm = state
                else:
                    x, ax, p, ap, xc, axc, anorm = state
                fresh = jnp.zeros((m, n), x.dtype)
                fresh = fresh.at[m - rcon:].set(jnp.asarray(fr))
                if has_b:
                    x, xc, axc, bxc = lock_refresh_b(
                        x, ax, bx, xc, axc, bxc,
                        jnp.asarray(self._nc, jnp.int32),
                        jnp.asarray(mask), fresh)
                    self._nc += rcon
                    self._xc, self._axc, self._bxc = xc, axc, bxc
                    bx = self._mm_b(x).astype(x.dtype)
                    x, bx = entry_fix(x, bx, xc, bxc)
                    ax = self._mm(x).astype(x.dtype)
                    p = jnp.zeros_like(x)
                    state = (x, ax, bx, p, jnp.zeros_like(x),
                             jnp.zeros_like(x), xc, axc, bxc, anorm)
                else:
                    x, _axk, xc, axc = lock_refresh(
                        x, ax, xc, axc, jnp.asarray(self._nc, jnp.int32),
                        jnp.asarray(mask), fresh)
                    self._nc += rcon
                    self._xc, self._axc = xc, axc
                    ax = self._mm(x).astype(x.dtype)
                    p = jnp.zeros_like(x)
                    ap = jnp.zeros_like(x)
                    state = (x, ax, p, ap, xc, axc, anorm)
                # slide per-slot host data: slots keep ascending-eigenvalue
                # identity; top rcon slots are fresh
                _shift_slot_data(self.cnv, self.lmd, self.res, acf,
                                 self.err_lmd, dlmd, self.err_X, dX,
                                 iterations, 0, rcon, m, 0, 0)

            if stopping is not None and rcon > 0:
                if stopping.satisfied(self):
                    status = 0
                    break
            if nwanted > 0 and self.rcon >= nwanted:
                status = 0
                break
            if stopping is None and nwanted < 0:
                status = 0
                break

        # deliver converged rows to the caller's Vectors (locking order)
        ncnew = self._nc - nc0
        if ncnew > 0:
            from ..algebra import dense_jax
            rows = self._xc[nc0:self._nc]
            if isinstance(eigenvectors, dense_jax.Vectors):
                eigenvectors.append(dense_jax.Vectors(rows))
            else:
                eigenvectors.append(
                    eigenvectors.new_vectors(np.asarray(rows)))
        return status

    @staticmethod
    def _cap_for(nwanted, m):
        if nwanted > 0:
            return int(nwanted + m)
        return int(4 * m)
