"""Device-resident randomized/subspace PCA and SVD engines.

The block Jacobi-CG engine (interfaces/partial_svd.py) is the high-accuracy
path with per-singular-triplet convergence control, but its adaptive logic
lives on the host.  This module is the opposite trade: the entire
computation — implicit Gram operator, subspace iteration with Cholesky-QR
re-orthonormalization, Rayleigh-Ritz — is a single jitted XLA program, so
a full PCA costs one device round-trip.  This is the engine for bulk
"give me k components" workloads on a device; its accuracy target is the
truncation error of the approximation (near-optimal with modest
oversampling and a few power iterations), not per-vector tolerances.

No counterpart exists in the reference (it is added value), but
it fulfils the same pca() contract (reference interfaces/pca.py:16-99).
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def _factors(atu, u, sigma, dtype):
    """(trans, comps) from As^T u and the Gram eigenpairs (u, sigma^2).

    comps = (As^T u / sigma)^T inherits the Gram route's loss of
    orthogonality, about eps * (sigma_1 / sigma_k)^2 for component k
    (1e-3 in f32 at k = 800 of the LFW-shaped spectrum).  One Cholesky-QR
    pass makes the rows orthonormal again, and trans absorbs the
    Cholesky factor, so trans @ comps is unchanged.  The pass is skipped
    when a component is numerically dead (row norm far from 1), where
    Cholesky would break down."""
    hi = jax.lax.Precision.HIGHEST
    f = u.dtype
    inv = 1.0 / jnp.maximum(sigma, jnp.finfo(f).tiny ** 0.5)
    comps = (atu * inv[None, :]).T
    trans = u * sigma[None, :]
    c = jnp.matmul(comps, comps.T, precision=hi)
    ok = jnp.all(jnp.abs(jnp.diagonal(c) - 1.0) < 0.5)
    low = jnp.linalg.cholesky(jnp.where(ok, c, jnp.eye(c.shape[0],
                                                       dtype=c.dtype)))
    comps = solve_triangular(low, comps, lower=True)
    trans = jnp.matmul(trans, low, precision=hi)
    return trans.astype(dtype), comps.astype(dtype)


@partial(jax.jit, static_argnames=('npc', 'oversample', 'iters'))
def _subspace_pca_gram(a, key, npc, oversample, iters):
    """PCA via subspace iteration on the implicit centered Gram matrix
    G = As As^T (As = A - e mean), fully on device.

    Returns (mean (n,), trans (m, npc), comps (npc, n), sigma (npc,)).
    """
    m, n = a.shape
    dt = a.dtype
    f32 = jnp.float32 if dt != jnp.float64 else jnp.float64
    hi = jax.lax.Precision.HIGHEST
    mean = jnp.mean(a, axis=0)                       # (n,)
    r = jnp.matmul(a, mean, precision=hi)            # (m,)
    mu2 = jnp.dot(mean, mean, precision=hi)
    # G = A A^T - r e^T - e r^T + mu2 e e^T  (never materializes As).
    # HIGHEST precision throughout: the Gram route squares the spectrum,
    # and bf16 operand truncation would bury the trailing sigma^2
    G = jnp.matmul(a, a.T, preferred_element_type=f32, precision=hi)
    G = G - r[:, None] - r[None, :] + mu2

    l = min(npc + oversample, m)
    q = jax.random.normal(key, (m, l), dtype=f32)

    def body(_, q):
        y = jnp.matmul(G, q, preferred_element_type=f32, precision=hi)
        # Householder QR re-orthonormalization: the Gram route squares the
        # (already squared) spectrum and overruns f32
        q, _ = jnp.linalg.qr(y)
        return q

    q = jax.lax.fori_loop(0, iters, body, body(0, q))
    # Rayleigh-Ritz on the l-dimensional subspace
    s = jnp.matmul(q.T, jnp.matmul(G, q, preferred_element_type=f32,
                                  precision=hi),
                   preferred_element_type=f32, precision=hi)
    s = 0.5 * (s + s.T)
    lmd, w = jnp.linalg.eigh(s)                      # ascending
    lmd = lmd[::-1][:npc]
    w = w[:, ::-1][:, :npc]
    u = jnp.matmul(q, w, preferred_element_type=f32, precision=hi)
    sigma = jnp.sqrt(jnp.maximum(lmd, 0.0))
    # right factors: comps = (As^T u / sigma)^T, again without As
    atu = jnp.matmul(a.T, u, preferred_element_type=f32, precision=hi)
    atu = atu - mean[:, None] * jnp.sum(u, axis=0)[None, :]
    trans, comps = _factors(atu, u, sigma, dt)
    return mean, trans, comps, sigma


def subspace_pca(a, npc, oversample=64, iters=6, seed=1, fetch=True):
    """One-round-trip PCA: returns (mean (1, n), trans (m, npc),
    comps (npc, n)) like interfaces.pca.pca.

    With ``fetch=False`` the factors are returned as device arrays
    (computation completed via block_until_ready) for on-device
    consumers — no host transfer."""
    a = jnp.asarray(a)
    key = jax.random.PRNGKey(seed)
    mean, trans, comps, sigma = _subspace_pca_gram(
        a, key, int(npc), int(oversample), int(iters))
    if not fetch:
        jax.block_until_ready((mean, trans, comps))
        return mean.reshape(1, -1), trans, comps
    mean, trans, comps = jax.device_get((mean, trans, comps))
    return np.asarray(mean).reshape(1, -1), np.asarray(trans), \
        np.asarray(comps)


@partial(jax.jit, static_argnames=())
def _centered_gram(a):
    """G = As As^T for As = A - e mean, plus trace/diag observables,
    without materializing As."""
    hi = jax.lax.Precision.HIGHEST
    f = jnp.float32 if a.dtype != jnp.float64 else jnp.float64
    mean = jnp.mean(a, axis=0)
    r = jnp.matmul(a, mean, precision=hi)
    mu2 = jnp.dot(mean, mean, precision=hi)
    G = jnp.matmul(a, a.T, preferred_element_type=f, precision=hi)
    G = G - r[:, None] - r[None, :] + mu2
    return G, mean


@partial(jax.jit, static_argnames=('l', 'iters'))
def _gram_subspace(G, key, l, iters):
    """Rank-l subspace iteration with QR re-orthonormalization on the
    (PSD) Gram matrix; returns descending (lmd (l,), U (m, l))."""
    hi = jax.lax.Precision.HIGHEST
    f = G.dtype
    m = G.shape[0]
    q = jax.random.normal(key, (m, l), dtype=f)

    def body(_, q):
        y = jnp.matmul(G, q, preferred_element_type=f, precision=hi)
        q, _ = jnp.linalg.qr(y)
        return q

    q = jax.lax.fori_loop(0, iters, body, body(0, q))
    s = jnp.matmul(q.T, jnp.matmul(G, q, preferred_element_type=f,
                                   precision=hi),
                   preferred_element_type=f, precision=hi)
    s = 0.5 * (s + s.T)
    lmd, w = jnp.linalg.eigh(s)
    u = jnp.matmul(q, w[:, ::-1], preferred_element_type=f, precision=hi)
    return jnp.maximum(lmd[::-1], 0.0), u


@jax.jit
def _row_error_profile(gdiag, u, sigma):
    """max-row truncation error after keeping k components, for every k:
    err_m(k) = max_i sqrt(diag_i - sum_{j<k} (u_ij sigma_j)^2), k = 0..l."""
    e2 = (u * sigma[None, :]) ** 2
    cum = jnp.cumsum(e2, axis=1)
    resid = jnp.maximum(gdiag[:, None] - cum, 0.0)
    full = jnp.sqrt(jnp.max(jnp.maximum(gdiag, 0.0)))
    prof = jnp.sqrt(jnp.max(resid, axis=0))
    return jnp.concatenate((full[None], prof))


def _rank_for_tol(G, lmd, u, tol, norm):
    """(smallest k meeting the tolerance or None, full error profile
    prof (l+1,) with prof[k] = relative error after keeping k
    components).  Error conventions follow the reference stopping
    criteria (truncated_svd.py:244-257): relative Frobenius ('f'),
    relative max row norm ('m'), relative singular value ('s')."""
    sigma2 = np.asarray(lmd)
    if norm == 'f':
        total = max(float(jnp.trace(G)), 1e-30)
        resid = np.maximum(total - np.cumsum(sigma2), 0.0)
        prof = np.sqrt(np.concatenate(([total], resid)) / total)
    elif norm == 'm':
        prof = np.asarray(_row_error_profile(
            jnp.diagonal(G), u, jnp.sqrt(jnp.maximum(jnp.asarray(lmd),
                                                     0.0))))
        prof = prof / max(prof[0], 1e-30)
    else:
        s = np.sqrt(np.maximum(sigma2, 0.0))
        prof = np.concatenate(([1.0], s / max(s[0], 1e-30)))
    ok = np.nonzero(prof <= tol)[0]
    return (int(ok[0]) if ok.size else None), prof


def _next_subspace_size(prof, tol, l, cap, trusted=None):
    """Predict the next subspace size when the rank-l profile did not
    meet ``tol``: extrapolate log(prof) linearly in log(k) over the last
    octave of the TRUSTED profile range and solve for prof(k) = tol.
    Each subspace size is a fresh (large) XLA compile, so jumping near
    the predicted rank beats blind doubling; the loop re-checks, so an
    undershoot costs at most one more round.  A flat trusted tail
    (noise floor / slow spectrum: no meaningful decay) jumps straight
    to the cap — no sequence of doublings can help there.

    ``trusted`` bounds the fit to the converged leading part of the
    subspace (the unconverged tail flattens the profile artificially and
    would otherwise fake a noise floor).  tol <= 0 is unreachable by
    definition: go straight to the cap, like the doubling loop did."""
    if not (tol > 0):
        return cap
    k1 = min(int(trusted), l) if trusted else l
    k1 = max(k1, 2)
    k0 = max(1, k1 // 2)
    with np.errstate(divide='ignore'):
        y0 = np.log(max(float(prof[k0]), 1e-300))
        y1 = np.log(max(float(prof[k1]), 1e-300))
    slope = (y1 - y0) / np.log(k1 / k0) if k1 > k0 else 0.0
    if not np.isfinite(slope) or slope >= -1e-3:
        return cap                          # flat: tol is out of reach
    # prof(k) ~ prof(k1) * (k/k1)^slope => k = k1 * (tol/prof(k1))^(1/slope)
    k_pred = k1 * np.exp((np.log(tol) - y1) / slope)
    if not np.isfinite(k_pred):
        return cap
    # 25% margin so the convergence-trust cut (l - l//8) still covers
    # the predicted rank; never shrink the step below 1.5x (progress
    # guarantee), never exceed the cap
    target = int(np.ceil(min(1.25 * k_pred + 16, float(cap))))
    return _bucket(int(min(max(target, (3 * l) // 2), cap)), cap)


def _bucket(l, cap, q=128):
    """Round a subspace size up to a multiple of ``q`` (clamped at the
    cap).  Every distinct subspace size is a fresh large XLA program;
    data-dependent sizes would give every run novel shapes that miss the
    persistent compilation cache.  Bucketing makes the size sequence
    recur across runs and datasets, so steady-state tolerance-mode PCA compiles
    nothing."""
    return int(min(-(-l // q) * q, cap))


@partial(jax.jit, static_argnames=('npc',))
def _finalize_from_gram(a, mean, u, lmd, npc):
    """Recover (trans, comps, sigma) for the leading npc components of
    the centered data from the Gram eigenpairs."""
    hi = jax.lax.Precision.HIGHEST
    f = u.dtype
    u = u[:, :npc]
    sigma = jnp.sqrt(jnp.maximum(lmd[:npc], 0.0))
    atu = jnp.matmul(a.T, u, preferred_element_type=f, precision=hi)
    atu = atu - mean[:, None] * jnp.sum(u, axis=0)[None, :]
    trans, comps = _factors(atu, u, sigma, a.dtype)
    return trans, comps, sigma


def subspace_pca_tol(a, tol, norm='f', max_npc=-1, iters=6, seed=1,
                     fetch=True, verb=0):
    """Tolerance-driven device PCA: grow the iterated subspace until the
    truncation error (in the requested norm, reference conventions)
    meets ``tol``, then cut to the smallest satisfying rank.

    The unconverged tail of the computed spectrum underestimates the
    captured energy, so the error profile used for the decision is an
    overestimate — growth stops late, never early."""
    a = jnp.asarray(a)
    m = a.shape[0]
    G, mean = _centered_gram(a)
    key = jax.random.PRNGKey(seed)
    cap = m if max_npc is None or max_npc < 1 else min(2 * max_npc, m)
    l = min(128, m)
    while True:
        lmd, u = _gram_subspace(G, key, int(l), int(iters))
        # only the leading part of the subspace is trusted as converged
        margin = l - max(8, l // 8) if l < m else l
        k, prof = _rank_for_tol(G, lmd, u, tol, norm)
        if verb > 0:
            print('subspace l=%d -> needed k=%s' % (l, k))
        if k is not None and (k <= margin or l >= cap):
            break
        if l >= cap:
            k = min(cap, l)
            break
        l = _next_subspace_size(prof, tol, l, cap)
    if max_npc and max_npc > 0:
        k = min(k, max_npc)
    k = max(k, 1)
    trans, comps, sigma = _finalize_from_gram(a, mean, u, lmd, int(k))
    if not fetch:
        jax.block_until_ready((mean, trans, comps))
        return mean.reshape(1, -1), trans, comps
    mean, trans, comps = jax.device_get((mean, trans, comps))
    return np.asarray(mean).reshape(1, -1), np.asarray(trans), \
        np.asarray(comps)


@jax.jit
def _update_gram(mean0, trans0, comps0, a1):
    """Gram matrix of the pooled centered stack [A0; A1] where
    A0 ~= e mean0 + L0 R0 is known only through its factors (R0 rows
    orthonormal).  Returns (G (m, m), pooled mean, d = mean0 - mean)."""
    hi = jax.lax.Precision.HIGHEST
    f = jnp.float32 if a1.dtype != jnp.float64 else jnp.float64
    m0 = trans0.shape[0]
    m1 = a1.shape[0]
    mtot = m0 + m1
    mean1 = jnp.mean(a1, axis=0)
    mean = (m0 / mtot) * mean0 + (m1 / mtot) * mean1
    d = mean0 - mean

    L0 = trans0.astype(f)
    rd = jnp.matmul(comps0, d, precision=hi)             # (k0,)
    dd = jnp.dot(d, d, precision=hi)
    g00 = jnp.matmul(L0, L0.T, preferred_element_type=f, precision=hi)
    t0 = jnp.matmul(L0, rd, precision=hi)                # (m0,)
    g00 = g00 + t0[:, None] + t0[None, :] + dd

    w = jnp.matmul(comps0, a1.T, preferred_element_type=f,
                   precision=hi)                         # (k0, m1)
    rmu = jnp.matmul(comps0, mean, precision=hi)         # (k0,)
    a1d = jnp.matmul(a1, d, precision=hi)                # (m1,)
    dmu = jnp.dot(d, mean, precision=hi)
    g01 = jnp.matmul(L0, w, preferred_element_type=f, precision=hi) \
        - jnp.matmul(L0, rmu, precision=hi)[:, None] \
        + a1d[None, :] - dmu

    r1 = jnp.matmul(a1, mean, precision=hi)              # (m1,)
    mu2 = jnp.dot(mean, mean, precision=hi)
    g11 = jnp.matmul(a1, a1.T, preferred_element_type=f, precision=hi)
    g11 = g11 - r1[:, None] - r1[None, :] + mu2

    G = jnp.block([[g00, g01], [g01.T, g11]])
    return G, mean, d


@partial(jax.jit, static_argnames=('npc',))
def _finalize_update(trans0, comps0, a1, mean, d, u, lmd, npc):
    """comps for the pooled stack: As^T U assembled from the old factors
    and the new rows, never materializing A0."""
    hi = jax.lax.Precision.HIGHEST
    f = u.dtype
    m0 = trans0.shape[0]
    u = u[:, :npc]
    sigma = jnp.sqrt(jnp.maximum(lmd[:npc], 0.0))
    u0, u1 = u[:m0], u[m0:]
    ltu = jnp.matmul(trans0.astype(f).T, u0, preferred_element_type=f,
                     precision=hi)                       # (k0, npc)
    asu = jnp.matmul(comps0.astype(f).T, ltu, preferred_element_type=f,
                     precision=hi)                       # (n, npc)
    asu = asu + d[:, None] * jnp.sum(u0, axis=0)[None, :]
    asu = asu + jnp.matmul(a1.T, u1, preferred_element_type=f,
                           precision=hi)
    asu = asu - mean[:, None] * jnp.sum(u1, axis=0)[None, :]
    trans, comps = _factors(asu, u, sigma, a1.dtype)
    return trans, comps, sigma


def subspace_pca_update(have, a1, npc=-1, tol=0, norm='f', max_npc=-1,
                        iters=6, seed=1, verb=0):
    """Device warm-start update: fold the new rows ``a1`` into a previous
    (mean, trans, comps) PCA so the result approximates the stacked
    dataset — the reference ``pca(have=...)`` capability
    (reference lra.py:158-379) on the one-round-trip engine.  The old
    data participates only through its factors (the Gram blocks and the
    right-factor recovery are assembled from L0, R0 and the mean
    change), so the cost scales with the new rows plus the old rank.

    Tolerance-driven updates select the rank against tol/2: the old
    factors already carry a truncation error up to tol of their own
    data, and the two error components add roughly in quadrature, so
    halving the per-stage target keeps the stacked result within tol."""
    mean0, trans0, comps0 = have
    a1 = jnp.asarray(a1)
    mean0 = jnp.asarray(np.asarray(mean0).reshape(-1))
    trans0 = jnp.asarray(trans0)
    comps0 = jnp.asarray(comps0)
    G, mean, d = _update_gram(mean0, trans0, comps0, a1)
    m = G.shape[0]
    key = jax.random.PRNGKey(seed)
    if npc and npc > 0:
        l = min(npc + max(16, npc // 8), m)
        lmd, u = _gram_subspace(G, key, int(l), int(iters))
        k = npc
    else:
        cap = m if max_npc is None or max_npc < 1 else min(2 * max_npc, m)
        l = _bucket(min(max(128, 2 * comps0.shape[0]), cap), cap)
        stage_tol = 0.5 * tol
        while True:
            lmd, u = _gram_subspace(G, key, int(l), int(iters))
            margin = l - max(8, l // 8) if l < m else l
            k, prof = _rank_for_tol(G, lmd, u, stage_tol, norm)
            if verb > 0:
                print('subspace update l=%d -> needed k=%s' % (l, k))
            if k is not None and (k <= margin or l >= cap):
                break
            if l >= cap:
                k = min(cap, l)
                break
            l = _next_subspace_size(prof, stage_tol, l, cap,
                                    trusted=margin)
        if max_npc and max_npc > 0:
            k = min(k, max_npc)
        k = max(k, 1)
    trans, comps, sigma = _finalize_update(trans0, comps0, a1, mean, d,
                                           u, lmd, int(k))
    mean_h, trans_h, comps_h = jax.device_get((mean, trans, comps))
    return np.asarray(mean_h).reshape(1, -1), np.asarray(trans_h), \
        np.asarray(comps_h)


def subspace_pca_stream(a, batch_size, npc=-1, tol=0, norm='f',
                        max_npc=-1, iters=6, seed=1, verb=0):
    """Streaming device PCA: compute on the first batch of rows, then
    fold in each subsequent batch with the device update — the reference
    ``pca(batch_size=...)`` capability on the subspace engine."""
    total = a.shape[0]
    step = min(batch_size, total)
    if npc and npc > 0:
        first = subspace_pca(a[:step], npc, iters=iters, seed=seed)
    else:
        # every stage targets tol/2 (see subspace_pca_update): stage
        # errors compose roughly in quadrature across the stream
        first = subspace_pca_tol(a[:step], 0.5 * tol, norm=norm,
                                 max_npc=max_npc, iters=iters, seed=seed,
                                 verb=verb)
    mean, trans, comps = first
    for lo in range(step, total, step):
        hi_ = min(total, lo + step)
        mean, trans, comps = subspace_pca_update(
            (mean, trans, comps), a[lo:hi_], npc=npc, tol=tol, norm=norm,
            max_npc=max_npc, iters=iters, seed=seed, verb=verb)
    return mean, trans, comps


def randomized_svd(a, k, oversample=16, iters=4, seed=1):
    """Randomized truncated SVD (Halko-Martinsson-Tropp style) as one
    jitted program: returns (u, sigma, vt)."""
    a = jnp.asarray(a)
    u, s, vt = _rand_svd(a, jax.random.PRNGKey(seed), int(k),
                         int(oversample), int(iters))
    u, s, vt = jax.device_get((u, s, vt))
    return np.asarray(u), np.asarray(s), np.asarray(vt)


@partial(jax.jit, static_argnames=('k', 'oversample', 'iters'))
def _rand_svd(a, key, k, oversample, iters):
    m, n = a.shape
    f32 = jnp.float32 if a.dtype != jnp.float64 else jnp.float64
    l = min(k + oversample, min(m, n))
    q = jax.random.normal(key, (n, l), dtype=a.dtype)
    q = jnp.matmul(a, q, preferred_element_type=f32)

    def body(_, q):
        q, _ = jnp.linalg.qr(q)
        q = jnp.matmul(a, jnp.matmul(a.T, q, preferred_element_type=f32),
                       preferred_element_type=f32)
        return q

    q = jax.lax.fori_loop(0, iters, body, q)
    q, _ = jnp.linalg.qr(q)
    b = jnp.matmul(q.T, a, preferred_element_type=f32)     # (l, n)
    ub, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = jnp.matmul(q, ub, preferred_element_type=f32)
    return u[:, :k].astype(a.dtype), s[:k], vt[:k].astype(a.dtype)
