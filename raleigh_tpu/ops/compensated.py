"""Compensated (double-word) Gram reductions: f64-class dot products from
f32 storage and f32 matrix products.

Why this exists: the device engines iterate f64/c128 workloads, which the
reference runs natively through its s/d/c/z MKL tables (reference
raleigh/algebra/mkl_wrap.py:137-201), in f32/c64 storage.  The dominant
error in the eigensolver's hot
reductions — Gram matrices G = X Yᴴ contracted over the vector dimension
n — is the f32 accumulation, which grows with n and at n ~ 1e6 leaves
only ~4 meaningful digits on clustered spectra.

This module computes the contraction with a chunked Ozaki-style splitting
so that every partial matmul is EXACT in float32:

  * the lane dimension is cut into chunks of ``CHUNK`` = 256;
  * within a chunk, each operand row/column is split against its own
    power-of-two exponent grid into three 8-bit-mantissa slices
    (s1 + s2 + s3 == x exactly; s1, s2 on aligned grids);
  * a product of two 8-bit slices has <= 16 mantissa bits on a known
    grid, so a 256-term dot product of them needs <= 24 bits — it
    accumulates in an f32 matrix product without ANY rounding;
  * the four high-order slice products per chunk combine into a running
    double-f32 (sum, err) pair via TwoSum (error-free transformation),
    so cross-chunk accumulation is exact up to the pair's ~2^-48 floor;
  * third-slice terms (relative magnitude <= 2^-16) are added as two
    ordinary full-width HIGHEST matmuls: their own f32 rounding lands at
    ~2^-40 of the result.

Combine the (s, e) pair on the host in float64 (``to_float64``) — the
solver's small Gram factorizations run in f64 on the host anyway.
Measured accuracy (tests/test_algebra.py pin): ~1e-12 relative at
n = 2e5 against a float64 oracle, vs ~5e-7 for the plain HIGHEST f32
matmul — effectively reference-d/z-class Gram matrices from f32 storage.

Cost: 4 small exact matmuls per chunk plus two full-width matmuls and an
O(m p n / CHUNK) TwoSum stream — an opt-in for accuracy-critical d/z
workloads (``Vectors(..., compensated=True)``, algebra/dense_jax.py), not
the default path.
"""

from functools import partial

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST

# lane-dimension chunk length: with 8-bit slices, 2*8 + log2(CHUNK) = 24
# mantissa bits — a chunk dot product of slice pairs is exactly
# representable in f32, boundary included (integers to 2^24)
CHUNK = 256

# slices keep 8 bits each: 3 slices cover the full 24-bit f32 mantissa
_BETA = 8


def _two_sum(s, p):
    """Error-free transformation: s + p == t + err exactly (Knuth)."""
    t = s + p
    z = t - s
    err = (s - (t - z)) + (p - z)
    return t, err


def _grid_split(x, axis):
    """Split ``x`` into (s1, s2, s3) with x == s1 + s2 + s3 exactly;
    s1/s2 hold the top 8 / next 8 mantissa bits on power-of-two grids
    shared along ``axis`` (the chunk lane axis), s3 the exact remainder.

    The grid anchor is 2^ceil(log2 max|x|) per (row, chunk): adding
    sigma = grid * 2^23 and subtracting it back rounds x to the grid —
    the standard error-free extraction."""
    mu = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    # exponent anchor from the FLOAT'S BITS, not log2: an f32 log2 can
    # round down across an integer boundary (mu just above 2^k), making
    # the grid a factor 2 too fine and silently breaking the
    # exact-product budget.  floor(log2(mu)) + 1 >= ceil(log2(mu)) is
    # always a safe (possibly one-coarser) anchor.  Zero chunks keep
    # exponent 1 (their slices are 0 anyway).
    mu_f = jnp.where(mu > 0, mu, 1.0).astype(jnp.float32)
    biased = (jax.lax.bitcast_convert_type(mu_f, jnp.int32) >> 23) & 0xFF
    e = (biased - 126).astype(jnp.float32)       # floor(log2) + 1
    grid1 = jnp.exp2(e - _BETA)
    sigma1 = grid1 * (2.0 ** 23)
    s1 = (x + sigma1) - sigma1
    r = x - s1
    sigma2 = sigma1 * (2.0 ** -_BETA)
    s2 = (r + sigma2) - sigma2
    s3 = r - s2
    return s1, s2, s3


def _comp_matmul_real(a, bt):
    """(m, k) x (k, p) -> double-f32 pair (s, e), real float32."""
    m, k = a.shape
    p = bt.shape[1]
    nchunks = -(-k // CHUNK)
    kp = nchunks * CHUNK
    if kp != k:
        a = jnp.pad(a, ((0, 0), (0, kp - k)))
        bt = jnp.pad(bt, ((0, kp - k), (0, 0)))
    # chunk-major layouts: (C, m, CHUNK) and (C, CHUNK, p)
    ac = jnp.moveaxis(a.reshape(m, nchunks, CHUNK), 1, 0)
    bc = bt.reshape(nchunks, CHUNK, p)
    a1, a2, a3 = _grid_split(ac, axis=2)
    b1, b2, b3 = _grid_split(bc, axis=1)

    def step(carry, ops):
        s, e = carry
        a1c, a2c, b1c, b2c = ops
        # the four high-order products are exact f32 matmuls (see module
        # docstring); fold each into the pair with TwoSum
        for term in (jnp.matmul(a1c, b1c, precision=_HI),
                     jnp.matmul(a1c, b2c, precision=_HI),
                     jnp.matmul(a2c, b1c, precision=_HI),
                     jnp.matmul(a2c, b2c, precision=_HI)):
            s, err = _two_sum(s, term)
            e = e + err
        return (s, e), None

    init = (jnp.zeros((m, p), jnp.float32), jnp.zeros((m, p), jnp.float32))
    (s, e), _ = jax.lax.scan(step, init, (a1, a2, b1, b2))
    # third-slice terms: <= 2^-16 relative, ordinary matmuls suffice
    a3f = jnp.moveaxis(a3, 0, 1).reshape(m, kp)
    b3f = b3.reshape(kp, p)
    low = jnp.matmul(a3f, bt, precision=_HI) \
        + jnp.matmul(a - a3f, b3f, precision=_HI)
    e = e + low
    return s, e


def _comp_dots_real(a, b):
    """Per-row compensated dot products: (m, k) . (m, k) -> pair of (m,)
    with sum_j a[i, j] b[i, j] ~= s[i] + e[i]; same exactness scheme as
    ``_comp_matmul_real`` with the matmuls replaced by row reductions."""
    m, k = a.shape
    nchunks = -(-k // CHUNK)
    kp = nchunks * CHUNK
    if kp != k:
        a = jnp.pad(a, ((0, 0), (0, kp - k)))
        b = jnp.pad(b, ((0, 0), (0, kp - k)))
    ac = jnp.moveaxis(a.reshape(m, nchunks, CHUNK), 1, 0)
    bc = jnp.moveaxis(b.reshape(m, nchunks, CHUNK), 1, 0)
    a1, a2, a3 = _grid_split(ac, axis=2)
    b1, b2, b3 = _grid_split(bc, axis=2)

    def step(carry, ops):
        s, e = carry
        a1c, a2c, b1c, b2c = ops
        for x, y in ((a1c, b1c), (a1c, b2c), (a2c, b1c), (a2c, b2c)):
            s, err = _two_sum(s, jnp.einsum('mk,mk->m', x, y))
            e = e + err
        return (s, e), None

    init = (jnp.zeros((m,), jnp.float32), jnp.zeros((m,), jnp.float32))
    (s, e), _ = jax.lax.scan(step, init, (a1, a2, b1, b2))
    a3f = jnp.moveaxis(a3, 0, 1).reshape(m, kp)
    b3f = jnp.moveaxis(b3, 0, 1).reshape(m, kp)
    low = jnp.einsum('mk,mk->m', a3f, b, precision=_HI) \
        + jnp.einsum('mk,mk->m', a - a3f, b3f, precision=_HI)
    return s, e + low


@jax.jit
def comp_dots_pair(x, y):
    """Per-row compensated inner products <y_i, x_j=i> = sum_j
    conj(y[i, j]) x[i, j] as an (s, e) pair — the drop-in for the
    backend's `dots` reduction (algebra/dense_jax.py `_k_dots`)."""
    if jnp.iscomplexobj(x) or jnp.iscomplexobj(y):
        xr = jnp.real(x).astype(jnp.float32)
        xi = jnp.imag(x).astype(jnp.float32)
        yr = jnp.real(y).astype(jnp.float32)
        yi = jnp.imag(y).astype(jnp.float32)
        rr_s, rr_e = _comp_dots_real(yr, xr)
        ii_s, ii_e = _comp_dots_real(yi, xi)
        ri_s, ri_e = _comp_dots_real(yr, xi)
        ir_s, ir_e = _comp_dots_real(yi, xr)
        re_s, re_c = _two_sum(rr_s, ii_s)
        im_s, im_c = _two_sum(ri_s, -ir_s)
        return re_s + 1j * im_s, \
            (re_c + rr_e + ii_e) + 1j * (im_c + ri_e - ir_e)
    return _comp_dots_real(y.astype(jnp.float32), x.astype(jnp.float32))


@jax.jit
def comp_matmul_pair(a, bt):
    """Compensated a @ bt for float32 or complex64 operands, returned as
    an UNEVALUATED double-word pair (s, e) with a @ bt ~= s + e to
    ~2^-40.  Combine on the host in float64 (``to_float64``) to keep the
    second word's information.

    Complex operands decompose into four real products; the real/imag
    recombinations go through TwoSum so the pair stays error-free."""
    if jnp.iscomplexobj(a) or jnp.iscomplexobj(bt):
        ar, ai = jnp.real(a).astype(jnp.float32), \
            jnp.imag(a).astype(jnp.float32)
        br, bi = jnp.real(bt).astype(jnp.float32), \
            jnp.imag(bt).astype(jnp.float32)
        rr_s, rr_e = _comp_matmul_real(ar, br)
        ii_s, ii_e = _comp_matmul_real(ai, bi)
        ri_s, ri_e = _comp_matmul_real(ar, bi)
        ir_s, ir_e = _comp_matmul_real(ai, br)
        re_s, re_c = _two_sum(rr_s, -ii_s)
        im_s, im_c = _two_sum(ri_s, ir_s)
        re_e = re_c + rr_e - ii_e
        im_e = im_c + ri_e + ir_e
        return re_s + 1j * im_s, re_e + 1j * im_e
    return _comp_matmul_real(a.astype(jnp.float32),
                             bt.astype(jnp.float32))


def comp_matmul(a, bt):
    """Compensated a @ bt collapsed to a single f32/c64 word (the best
    representable result at the storage dtype)."""
    s, e = comp_matmul_pair(a, bt)
    return s + e


def to_float64(pair):
    """Host-side combine of a (s, e) pair into float64/complex128 — the
    accuracy the d/z Gram consumer actually sees."""
    import numpy as np
    s, e = jax.device_get(pair)
    wide = np.complex128 if np.iscomplexobj(s) else np.float64
    return np.asarray(s, dtype=wide) + np.asarray(e, dtype=wide)


def comp_gram(x, y):
    """Compensated Gram block G[i, j] = <y_i, x_j> = conj(y) xᵀ for
    (m, n) row-vector blocks — the drop-in for the backend's `dot`
    contraction (algebra/dense_jax.py `_k_gram`).  Returns the device
    (s, e) pair; combine with ``to_float64`` on the host."""
    return comp_matmul_pair(jnp.conj(y), x.T)
