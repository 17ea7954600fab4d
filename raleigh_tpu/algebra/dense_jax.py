"""JAX device implementation of the block-vector algebra contract.

This is the device replacement for the reference's MKL/CUBLAS backends
(raleigh/algebra/dense_cblas.py, dense_cublas.py): one implementation that
runs on any XLA device, one card or sharded over a ``jax.sharding.Mesh``.

Design:

  * A block of ``m`` vectors of dimension ``n`` is a ``(capacity, n)``
    ``jax.Array`` plus a host-side selection window ``(first, nvec)`` — the
    same "selection window" contract the reference documents at
    raleigh/core/solver.py:32-37, with *functional* updates via
    ``lax.dynamic_update_slice`` inside jitted kernels.

  * Shape bucketing: the solver's adaptive block logic produces dozens of
    distinct window sizes; compiling one XLA program per size would melt
    wall-clock into compilations.  Kernels therefore take a *static padded*
    window size (the next bucket: multiple of 8/32/128) plus the *traced*
    logical count, mask the padded garbage rows out of reductions, and
    blend writes so only the logical rows change.  Coefficient matrices
    are zero-padded host-side, so padded rows contribute exactly zero to
    every GEMM.  Result: O(10) compiled variants per kernel, amortized by
    the persistent compilation cache.

  * All O(m*n) work (Gram matrices, linear combinations, operator
    applications) is device GEMMs (cuBLAS on a GPU); the small O(m^2) results
    come back to the host as NumPy arrays, exactly where the reference
    brings Gram matrices back for SciPy factorizations
    (dense_cublas.py:265-269).  Buffer donation keeps updates in place.

  * With storage carrying a ``NamedSharding`` over the vector dimension the
    same kernels run SPMD: XLA partitions the contraction over ``n`` into
    local GEMM + psum (NCCL all-reduce across GPUs), the device
    equivalent of the "MPI Vectors" the reference leaves as future work
    (core/solver.py:98-102).

Randomness: ``fill_random`` draws on the host with NumPy's global generator
(uniform in [-1, 1)) and uploads — bit-identical to the host backend, which
keeps differential tests exact and results reproducible via
``numpy.random.seed`` like every reference script.
"""

import numbers
import os
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

# On a GPU a "default"-precision f32 matmul may run in TF32, which keeps
# about three decimal digits; an eigensolver's Gram matrices and residuals
# need true f32, so the whole process defaults to "highest" (full f32).
# Opt out with RALEIGH_TPU_MATMUL_PRECISION=default for workloads that
# tolerate TF32.
jax.config.update('jax_default_matmul_precision',
                  os.environ.get('RALEIGH_TPU_MATMUL_PRECISION', 'highest'))


def _cj(a):
    return a.conj() if jnp.iscomplexobj(a) else a


def bucket(k):
    """Static padded size for a logical window of k rows."""
    k = max(int(k), 1)
    if k <= 8:
        return 8
    if k <= 128:
        return (k + 7) // 8 * 8
    if k <= 512:
        return (k + 31) // 32 * 32
    return (k + 127) // 128 * 128


def capacity_for(m):
    """Storage capacity so any window (f, k) with f + k <= m can be read at
    its bucketed size without overrunning."""
    m = max(int(m), 1)
    slack = 8 if m <= 128 else (32 if m <= 512 else 128)
    return bucket(m) + slack


def _win(arr, first, B):
    """The B-row (bucketed) window starting at traced row ``first``."""
    return lax.dynamic_slice_in_dim(arr, first, B, axis=0)


def _rowmask(B, k, dtype=None):
    """(B, 1) mask: 1 for rows < k (traced), 0 for padded rows."""
    rows = lax.broadcasted_iota(jnp.int32, (B, 1), 0)
    m = (rows < k)
    return m if dtype is None else m.astype(dtype)


def _blend_write(arr, first, B, k, new_rows):
    """Write new_rows (B rows) at ``first``, keeping rows >= k unchanged."""
    old = _win(arr, first, B)
    mask = _rowmask(B, k)
    return lax.dynamic_update_slice_in_dim(
        arr, jnp.where(mask, new_rows.astype(arr.dtype), old), first, 0)


# ---------------------------------------------------------------------------
# jitted kernels: static bucketed sizes (Ba, Bb, ...), traced counts (ka, kb)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=('Ba', 'Bb'))
def _k_gram(a, fa, ka, Ba, b, fb, kb, Bb):
    # contract `dot`: rows indexed by b's vectors, cols by a's
    wa = _win(a, fa, Ba) * _rowmask(Ba, ka, a.dtype)
    wb = _win(b, fb, Bb) * _rowmask(Bb, kb, b.dtype)
    return jnp.matmul(_cj(wb), wa.T, preferred_element_type=wa.dtype)


@partial(jax.jit, static_argnames=('B',))
def _k_dots(a, fa, b, fb, k, B):
    wa = _win(a, fa, B)
    wb = _win(b, fb, B) * _rowmask(B, k, b.dtype)
    return jnp.einsum('ij,ij->i', _cj(wb), wa)


@partial(jax.jit, static_argnames=('Ba', 'Bb'))
def _k_gram_comp(a, fa, ka, Ba, b, fb, kb, Bb):
    # compensated twin of _k_gram: the Gram contraction as a double-f32
    # (sum, err) pair via exact-product slicing (ops/compensated.py) —
    # the d/z accuracy option on f32-only device hardware
    from ..ops.compensated import comp_matmul_pair
    wa = _win(a, fa, Ba) * _rowmask(Ba, ka, a.dtype)
    wb = _win(b, fb, Bb) * _rowmask(Bb, kb, b.dtype)
    return comp_matmul_pair(_cj(wb), wa.T)


@partial(jax.jit, static_argnames=('B',))
def _k_dots_comp(a, fa, b, fb, k, B):
    from ..ops.compensated import comp_dots_pair
    wa = _win(a, fa, B) * _rowmask(B, k, a.dtype)
    wb = _win(b, fb, B) * _rowmask(B, k, b.dtype)
    return comp_dots_pair(wa, wb)


@partial(jax.jit, static_argnames=('B',))
def _k_dots_t(a, fa, b, fb, k, B):
    wa = _win(a, fa, B)
    wb = _win(b, fb, B) * _rowmask(B, k, b.dtype)
    return jnp.einsum('ij,ij->j', _cj(wb), wa)


@partial(jax.jit, static_argnames=('B',))
def _k_dots_t_comp(a, fa, b, fb, k, B):
    # compensated twin of _k_dots_t: the per-lane reduction over the k
    # vectors as an exact-product (sum, err) pair — the contraction is
    # short (k <= B) but the PRODUCTS are f32-rounded on the plain path,
    # which caps truncation-error tracking at ~1e-7 relative
    from ..ops.compensated import comp_dots_pair
    wa = _win(a, fa, B)
    wb = _win(b, fb, B) * _rowmask(B, k, b.dtype)
    return comp_dots_pair(wa.T, wb.T)


@partial(jax.jit, static_argnames=('Ba', 'Bo'), donate_argnames=('out',))
def _k_multiply(a, fa, Ba, q, out, fo, ko, Bo):
    # q is zero-padded to (Ba, Bo): padded rows of `a` weighted by zero
    w = jnp.matmul(q.T, _win(a, fa, Ba), preferred_element_type=a.dtype)
    return _blend_write(out, fo, Bo, ko, w)


@partial(jax.jit, static_argnames=('Ba', 'Bo'))
def _k_multiply_inplace(a, fa, Ba, q, fo, ko, Bo):
    # aliased variant (output is the input block): no donation
    w = jnp.matmul(q.T, _win(a, fa, Ba), preferred_element_type=a.dtype)
    return _blend_write(a, fo, Bo, ko, w)


@partial(jax.jit, static_argnames=('B',), donate_argnames=('s',))
def _k_add_scalar(s, fs, k, o, fo, B, alpha):
    w = _win(s, fs, B) + alpha * _win(o, fo, B)
    return _blend_write(s, fs, B, k, w)


@partial(jax.jit, static_argnames=('Bs', 'Bo'), donate_argnames=('s',))
def _k_add_combi(s, fs, ks, Bs, o, fo, Bo, alpha, q):
    # q zero-padded to (Bo, Bs)
    w = _win(s, fs, Bs) + alpha * jnp.matmul(
        q.T, _win(o, fo, Bo), preferred_element_type=s.dtype).astype(s.dtype)
    return _blend_write(s, fs, Bs, ks, w)


@partial(jax.jit, static_argnames=('B',), donate_argnames=('s',))
def _k_add_rows(s, fs, o, fo, k, B, coef):
    w = _win(s, fs, B) + coef[:, None].astype(s.dtype) * _win(o, fo, B)
    return _blend_write(s, fs, B, k, w)


@partial(jax.jit, static_argnames=('B',), donate_argnames=('dst',))
def _k_copy(src, fsrc, dst, fdst, k, B):
    return _blend_write(dst, fdst, B, k, _win(src, fsrc, B))


@partial(jax.jit, static_argnames=('B',), donate_argnames=('dst',))
def _k_copy_indexed(src, ind, dst, fdst, k, B):
    # ind zero-padded to length B; rows >= k are discarded by the blend
    w = jnp.take(src, ind, axis=0).astype(dst.dtype)
    return _blend_write(dst, fdst, B, k, w)


@partial(jax.jit, static_argnames=('B', 'multiply'), donate_argnames=('s',))
def _k_scale(s, fs, k, B, coef, multiply):
    w = _win(s, fs, B)
    c = coef[:, None].astype(s.dtype)
    if multiply:
        w = w * c
    else:
        w = w / jnp.where(c == 0, jnp.ones_like(c), c)
    return _blend_write(s, fs, B, k, w)


@partial(jax.jit, static_argnames=('B',), donate_argnames=('s',))
def _k_fill_value(s, fs, k, B, value):
    w = jnp.full((B, s.shape[1]), value, dtype=s.dtype)
    return _blend_write(s, fs, B, k, w)


@partial(jax.jit, static_argnames=('B',), donate_argnames=('s',))
def _k_set_rows(s, fs, k, B, rows):
    # rows padded to B
    return _blend_write(s, fs, B, k, rows)


@partial(jax.jit, static_argnames=('Bs', 'Bo'), donate_argnames=('s',))
def _k_ortho(s, fs, ks, Bs, o, fo, ko, Bo):
    """s := s - q^T o with q = conj(o) s^T; returns (new s, q)."""
    ws = _win(s, fs, Bs) * _rowmask(Bs, ks, s.dtype)
    wo = _win(o, fo, Bo) * _rowmask(Bo, ko, o.dtype)
    q = jnp.matmul(_cj(wo), ws.T, preferred_element_type=ws.dtype)
    w = ws - jnp.matmul(q.T, wo, preferred_element_type=ws.dtype)
    return _blend_write(s, fs, Bs, ks, w), q


@partial(jax.jit, static_argnames=('Bx', 'transp', 'conj_a'),
         donate_argnames=('y',))
def _k_apply_dense(a, x, fx, Bx, y, fy, ky, transp, conj_a):
    wx = _win(x, fx, Bx)
    if transp:
        am = _cj(a) if conj_a else a
        w = jnp.matmul(wx, am, preferred_element_type=wx.dtype)
    else:
        w = jnp.matmul(wx, a.T, preferred_element_type=wx.dtype)
    return _blend_write(y, fy, Bx, ky, w)


@partial(jax.jit, static_argnames=('B',))
def _k_read(arr, f, k, B):
    return _win(arr, f, B) * _rowmask(B, k, arr.dtype)


# ---------------------------------------------------------------------------


def _padq(q, Bi, Bo, dtype):
    """Zero-pad a coefficient matrix to (Bi, Bo) in the storage dtype.
    Device arrays (e.g. a kept ``dot`` result, already bucket-padded) stay
    on device."""
    if isinstance(q, jax.Array):
        if q.shape == (Bi, Bo):
            return q.astype(dtype)
        out = jnp.zeros((Bi, Bo), dtype=dtype)
        return lax.dynamic_update_slice(out, q.astype(dtype), (0, 0))
    q = np.asarray(q)
    out = np.zeros((Bi, Bo), dtype=dtype)
    out[:q.shape[0], :q.shape[1]] = q
    return jnp.asarray(out)


def _padv(v, B, dtype):
    if isinstance(v, jax.Array):
        v = v.reshape(-1).astype(dtype)
        if v.shape[0] == B:
            return v
        if v.shape[0] > B:
            return v[:B]
        return jnp.concatenate((v, jnp.zeros((B - v.shape[0],), dtype)))
    v = np.asarray(v).reshape(-1)
    out = np.zeros((B,), dtype=dtype)
    out[:min(v.shape[0], B)] = v[:B]
    return jnp.asarray(out)


# ---------------------------------------------------------------------------
# module-level helpers the core solver uses to batch device round-trips
# ---------------------------------------------------------------------------

def fetch(*arrays):
    """One batched device->host transfer for several small results."""
    return tuple(np.asarray(x) for x in jax.device_get(list(arrays)))


def stage_coeff(a, rows=None, cols=None):
    """Upload a host coefficient matrix once, bucket-padded, for repeated
    device-side combine() use."""
    a = np.asarray(a)
    r = bucket(rows if rows is not None else a.shape[0])
    c = bucket(cols if cols is not None else a.shape[1])
    out = np.zeros((r, c), dtype=a.dtype)
    out[:a.shape[0], :a.shape[1]] = a
    return jnp.asarray(out)


@jax.jit
def _k_combine(a, b):
    return jnp.matmul(a, b, preferred_element_type=b.dtype)


def combine(a, b):
    """Small-matrix product on device; ``a`` may be a host matrix (padded
    and uploaded) or a staged/kept device array."""
    if not isinstance(a, jax.Array):
        a = stage_coeff(a, cols=b.shape[0])
    if a.shape[1] != b.shape[0]:
        a2 = jnp.zeros((a.shape[0], b.shape[0]), dtype=a.dtype)
        a = lax.dynamic_update_slice(
            a2, a[:, :min(a.shape[1], b.shape[0])], (0, 0))
    return _k_combine(a, b.astype(a.dtype))


def rootabs(a):
    if isinstance(a, jax.Array):
        return _k_rootabs(a)
    return np.sqrt(np.abs(np.asarray(a).real))


@jax.jit
def _k_rootabs(a):
    return jnp.sqrt(jnp.abs(a.real))


@jax.jit
def _k_diag_ratio(a, b):
    da = jnp.diagonal(a)
    db = jnp.diagonal(b)
    r = (da / jnp.where(db == 0, jnp.ones_like(db), db)).real
    return jnp.where(db == 0, jnp.zeros_like(r), r)


def diag_ratio(a, b):
    """re(diag(a) / diag(b)) without leaving the device (padded rows, where
    diag(b) is exactly zero, come out as zeros).  Used by the core solver to
    form residuals with device-resident Ritz values, fusing the
    Ritz-value and residual-norm round-trips into one."""
    if not isinstance(a, jax.Array):
        from .dense_numpy import diag_ratio as host
        return host(a, b)
    return _k_diag_ratio(a, jnp.asarray(b))


def conjugation_beta(zay, zby, lmd_y, lmdz, sy, sz, dtype):
    """Jacobi-conjugation coefficients, fully on device when the Gram
    blocks were kept there (reference core/solver.py:1331-1347).  Inputs
    may be bucket-padded with zeros; padded entries come out as exact
    zeros via the final isfinite sweep."""
    Bz, By = zay.shape
    lmd_y = _padv(np.asarray(lmd_y, dtype=np.float32), By, np.float32)
    lmdz_p = _padv(np.asarray(lmdz, dtype=np.float32), Bz, np.float32)
    return _k_beta(jnp.asarray(zay), jnp.asarray(zby), lmd_y, lmdz_p,
                   jnp.asarray(sy), jnp.asarray(sz)).astype(dtype)


@jax.jit
def _k_beta(zay, zby, lmd_y, lmdz, sy, sz):
    num = zay - zby * lmd_y[None, :].astype(zby.dtype)
    den = (lmdz[:, None] - lmd_y[None, :]).astype(zay.real.dtype)
    syr = jnp.sqrt(jnp.abs(sy.real))
    szr = jnp.sqrt(jnp.abs(sz.real))
    ratio = syr[None, :] / jnp.where(szr[:, None] == 0, 1, szr[:, None])
    guard = jnp.abs(num) >= 100 * ratio * jnp.abs(den)
    beta = jnp.where(guard, jnp.zeros_like(num), num / den)
    return jnp.where(jnp.isfinite(beta), beta, 0)


class Vectors:
    """Selectable window over a block of row-vectors, jax.Array storage."""

    def __init__(self, arg, nvec=0, data_type=None, shallow=False,
                 sharding=None, compensated=False):
        """``compensated=True`` routes the Gram reductions (`dot`, and
        `dots` without transp) through the exact-product double-f32
        scheme of ops/compensated.py and returns them in float64 — the
        accuracy option for d/z workloads kept in f32 storage."""
        self._sharding = sharding
        self._comp = bool(compensated)
        if isinstance(arg, Vectors):
            f, k = arg.selected()
            self._sharding = arg._sharding
            self._comp = arg._comp
            self._array = _grow(_k_read(arg._array, f, k, bucket(k))
                                [:bucket(k)], capacity_for(k),
                                self._sharding)
            self._nvec = k
        elif isinstance(arg, Matrix):
            self._sharding = arg._sharding
            self._array = _grow(arg._data, capacity_for(arg._data.shape[0]),
                                self._sharding)
            self._nvec = arg._data.shape[0]
        elif isinstance(arg, (np.ndarray, jax.Array)):
            a = jnp.asarray(np.ascontiguousarray(arg)) \
                if isinstance(arg, np.ndarray) else arg
            self._array = _grow(a, capacity_for(a.shape[0]), self._sharding)
            self._nvec = a.shape[0]
        elif isinstance(arg, numbers.Number):
            dt = data_type if data_type is not None else jnp.float32
            n = int(arg)
            self._array = self._put(
                jnp.zeros((capacity_for(max(nvec, 1)), n), dtype=dt))
            self._nvec = nvec
        else:
            raise ValueError('cannot build Vectors from %r' % type(arg))
        self._sel = (0, self._nvec)

    def _put(self, a):
        if self._sharding is not None:
            return jax.device_put(a, self._sharding)
        return jnp.asarray(a)

    def _ensure_capacity(self, need):
        if self._array.shape[0] < need:
            self._array = _grow(self._array, capacity_for(need),
                                self._sharding)

    # ---- storage / selection -------------------------------------------

    def dimension(self):
        return self._array.shape[1]

    def nvec(self):
        return self._sel[1]

    def select(self, nv, first=0):
        assert first >= 0
        self._nvec = max(self._nvec, first + nv)
        # capacity invariant: any window must be readable at its bucketed
        # size without dynamic_slice clamping
        self._ensure_capacity(first + bucket(nv))
        self._sel = (first, nv)

    def select_all(self):
        self._sel = (0, self._nvec)

    def selected(self):
        return self._sel

    def data_type(self):
        return np.dtype(self._array.dtype).type

    def is_complex(self):
        return jnp.iscomplexobj(self._array)

    def all_data(self):
        return np.asarray(self._array[:self._nvec])

    def data(self, i=None):
        f, k = self._sel
        if k == 0:
            host = np.zeros((0, self.dimension()), self.data_type())
        else:
            host = np.asarray(self._array)[f:f + k]
        return host if i is None else host[i]

    def device_data(self):
        f, k = self._sel
        return self._array[f:f + k]

    def new_vectors(self, arg=0, dim=None):
        if isinstance(arg, (np.ndarray, jax.Array)):
            a = jnp.asarray(arg)
            if a.dtype != self._array.dtype and (
                    jnp.iscomplexobj(self._array) == jnp.iscomplexobj(a)):
                a = a.astype(self._array.dtype)
            v = Vectors(a, sharding=self._sharding,
                        compensated=self._comp)
            return v
        if dim is None:
            dim = self.dimension()
        return Vectors(dim, arg, self.data_type(), sharding=self._sharding,
                       compensated=self._comp)

    def clone(self):
        return Vectors(self)

    def reference(self):
        return Vectors(self, shallow=True)

    def append(self, other, axis=0):
        if axis == 0:
            mine = self._array[:self._nvec] if self._sel == (0, self._nvec) \
                else self.device_data()
            kept = mine.shape[0]
            self._array = _grow(jnp.concatenate(
                (mine, other.device_data())),
                capacity_for(kept + other.nvec()), self._sharding)
            self._nvec = kept + other.nvec()
        else:
            cap = self._array.shape[0]
            ob = other._array
            ob = ob[:cap] if ob.shape[0] >= cap else _grow(ob, cap, None)
            self._array = self._put(jnp.concatenate((self._array, ob),
                                                    axis=1))
        self._sel = (0, self._nvec)

    # ---- fills ----------------------------------------------------------

    def zero(self):
        f, k = self._sel
        self._array = _k_fill_value(self._array, f, k, bucket(k),
                                    np.zeros((), self.data_type()))

    def fill(self, value):
        f, k = self._sel
        B = bucket(k)
        if isinstance(value, numbers.Number):
            self._array = _k_fill_value(self._array, f, k, B,
                                        np.asarray(value, self.data_type()))
        else:
            v = jnp.asarray(value)
            rows = jnp.broadcast_to(v, (k, self.dimension())) \
                if v.ndim < 2 or v.shape[0] != k else v
            rows = jnp.concatenate(
                (rows.astype(self._array.dtype),
                 jnp.zeros((B - k, self.dimension()), self._array.dtype)))
            self._array = _k_set_rows(self._array, f, k, B, rows)

    def fill_random(self):
        f, k = self._sel
        B = bucket(k)
        rows = np.zeros((B, self.dimension()), dtype=self.data_type())
        rows[:k] = 2 * np.random.rand(k, self.dimension()) - 1
        self._array = _k_set_rows(self._array, f, k, B, jnp.asarray(rows))

    def fill_orthogonal(self):
        from .dense_numpy import _hadamard_like_fill
        f, k = self._sel
        B = bucket(k)
        a = np.zeros((B, self.dimension()), dtype=self.data_type())
        _hadamard_like_fill(a[:k])
        self._array = _k_set_rows(self._array, f, k, B, jnp.asarray(a))

    # ---- contract ops ---------------------------------------------------

    def copy(self, other, ind=None):
        if ind is None:
            assert self.nvec() == other.nvec()
            k = self.nvec()
            other._ensure_capacity(other._sel[0] + bucket(k))
            other._array = _k_copy(self._array, self._sel[0],
                                   other._array, other._sel[0], k, bucket(k))
        else:
            ind = np.asarray(ind, dtype=np.int32).reshape(-1)
            k = len(ind)
            B = bucket(k)
            pad = np.zeros((B,), dtype=np.int32)
            pad[:k] = ind
            other._ensure_capacity(other._sel[0] + B)
            other._array = _k_copy_indexed(self._array, jnp.asarray(pad),
                                           other._array, other._sel[0], k, B)

    def scale(self, s, multiply=False):
        f, k = self._sel
        B = bucket(k)
        if isinstance(s, jax.Array):
            # device-resident coefficients (e.g. a kept rootabs(dots()))
            # stay on device: no host round-trip
            dt = self._array.dtype if jnp.iscomplexobj(s) \
                else _real_dtype(self.data_type())
            coef = _padv(s, B, dt)
        else:
            sv = np.asarray(s).reshape(-1)[:k]
            dt = self._array.dtype if np.iscomplexobj(sv) \
                else _real_dtype(self.data_type())
            coef = _padv(sv, B, dt)
        self._array = _k_scale(self._array, f, k, B, coef, multiply)

    def _comp_active(self, other, keep):
        """Compensated reductions apply to fetched results of 4/8-byte
        (f32/c64) storage: device-kept consumers stay on the plain f32
        path, and true-f64 storage (x64 CPU runs) needs no help."""
        return ((self._comp or getattr(other, '_comp', False))
                and not keep
                and self._array.dtype in (jnp.float32, jnp.complex64))

    def dots(self, other, transp=False, keep=False):
        k = self.nvec()
        B = bucket(k)
        if transp:
            if self._comp_active(other, keep):
                from ..ops.compensated import to_float64
                return to_float64(_k_dots_t_comp(
                    self._array, self._sel[0], other._array,
                    other._sel[0], k, B))
            r = _k_dots_t(self._array, self._sel[0],
                          other._array, other._sel[0], k, B)
            return r if keep else np.asarray(r)
        if self._comp_active(other, keep):
            from ..ops.compensated import to_float64
            return to_float64(_k_dots_comp(
                self._array, self._sel[0], other._array, other._sel[0],
                k, B))[:k]
        r = _k_dots(self._array, self._sel[0],
                    other._array, other._sel[0], k, B)
        # kept results stay bucket-padded on device (zeros beyond k)
        return r if keep else np.asarray(r)[:k]

    def dot(self, other, keep=False):
        ka, kb = self.nvec(), other.nvec()
        if self._comp_active(other, keep):
            from ..ops.compensated import to_float64
            return to_float64(_k_gram_comp(
                self._array, self._sel[0], ka, bucket(ka),
                other._array, other._sel[0], kb, bucket(kb)))[:kb, :ka]
        r = _k_gram(self._array, self._sel[0], ka, bucket(ka),
                    other._array, other._sel[0], kb, bucket(kb))
        return r if keep else np.asarray(r)[:kb, :ka]

    def multiply(self, q, output):
        assert output.nvec() == q.shape[1]
        ka, ko = self.nvec(), output.nvec()
        Ba, Bo = bucket(ka), bucket(ko)
        qj = _padq(q, Ba, Bo, self.data_type())
        output._ensure_capacity(output._sel[0] + Bo)
        if output._array is self._array:
            output._array = _k_multiply_inplace(
                self._array, self._sel[0], Ba, qj, output._sel[0], ko, Bo)
        else:
            output._array = _k_multiply(self._array, self._sel[0], Ba, qj,
                                        output._array, output._sel[0], ko,
                                        Bo)

    def add(self, other, s, q=None):
        f, k = self._sel
        if np.isscalar(s):
            alpha = np.asarray(s, dtype=self._array.dtype)
            if q is None:
                B = bucket(k)
                self._array = _k_add_scalar(self._array, f, k,
                                            other._array, other._sel[0], B,
                                            alpha)
            else:
                ko = other.nvec()
                Bs, Bo = bucket(k), bucket(ko)
                qj = _padq(q, Bo, Bs, self.data_type())
                self._array = _k_add_combi(self._array, f, k, Bs,
                                           other._array, other._sel[0], Bo,
                                           alpha, qj)
        else:
            B = bucket(k)
            if isinstance(s, jax.Array):
                dt = self._array.dtype if jnp.iscomplexobj(s) \
                    else _real_dtype(self.data_type())
                coef = _padv(s, B, dt)
            else:
                sv = np.asarray(s).reshape(-1)[:k]
                dt = self._array.dtype if np.iscomplexobj(sv) \
                    else _real_dtype(self.data_type())
                coef = _padv(sv, B, dt)
            self._array = _k_add_rows(self._array, f, other._array,
                                      other._sel[0], k, B, coef)

    # ---- backend extras -------------------------------------------------

    def orthogonalize(self, other):
        ks, ko = self.nvec(), other.nvec()
        self._array, q = _k_ortho(self._array, self._sel[0], ks, bucket(ks),
                                  other._array, other._sel[0], ko,
                                  bucket(ko))
        return self.new_vectors(np.asarray(q)[:ko, :ks])

    def svd(self):
        """Economy SVD of the selected block: storage rows become the right
        singular vectors V^H, returns (sigma, conj(U)).

        Device formulation: Gram matrix on device + small host eigh +
        device rotation, refined by one Cholesky-QR pass — the tall-skinny
        scheme the reference itself uses in ``_finalize_svd``
        (raleigh/interfaces/partial_svd.py:162-235) — instead of a
        monolithic host gesvd (dense_cublas.py:537)."""
        f, k = self._sel
        if k > self.dimension():
            raise ValueError(
                'cannot orthonormalize %d vectors in a %d-dimensional '
                'space; truncate the block first' % (k, self.dimension()))
        dt = self.data_type()
        g = np.conj(self.dot(self))                     # X X^H
        g = 0.5 * (g + g.conj().T)
        lmd, u = np.linalg.eigh(g)                      # ascending
        lmd, u = lmd[::-1].copy(), u[:, ::-1].copy()    # G = U S^2 U^H
        sigma = np.sqrt(np.maximum(lmd, 0.0))
        floor = max(np.sqrt(np.finfo(sigma.dtype).tiny),
                    np.finfo(sigma.dtype).eps * max(sigma[0], 1.0))
        inv = 1.0 / np.maximum(sigma, floor)
        # V^H = S^-1 U^H X:  rows := q^T rows with q = conj(U S^-1)
        self.multiply(np.conj(u * inv[None, :]), self)
        # Cholesky-QR refinement restores the orthonormality lost to the
        # squared conditioning of the Gram route
        g2 = np.conj(self.dot(self))
        g2 = 0.5 * (g2 + g2.conj().T)
        try:
            c = np.linalg.cholesky(g2).conj().T         # g2 = C^H C
            ci = np.linalg.inv(c)
            self.multiply(np.conj(ci), self)            # rows := C^-H rows
            t = (u * sigma[None, :]) @ c.conj().T
            p, sigma, qh = np.linalg.svd(t)
            # rows := qh rows, and multiply applies q^T without conjugation
            self.multiply(qh.T, self)
            u = p
        except np.linalg.LinAlgError:
            pass
        return sigma.astype(_real_dtype(dt)), _cj_np(u.astype(dt))

    def apply(self, A, output, transp=False):
        A.apply(self, output, transp=transp)


def _grow(a, cap, sharding):
    """Return ``a`` padded with zero rows up to ``cap`` (and re-placed on
    its sharding)."""
    if a.shape[0] < cap:
        a = jnp.concatenate(
            (a, jnp.zeros((cap - a.shape[0], a.shape[1]), a.dtype)))
    if sharding is not None:
        a = jax.device_put(a, sharding)
    return a


def _real_dtype(dt):
    return np.zeros((), dt).real.dtype.type


def _cj_np(a):
    return a.conj() if np.iscomplexobj(a) else a


class Matrix:
    """Dense operator with jax.Array storage (optionally sharded over the
    feature dimension).  ``apply``: y = x @ A^T, adjoint: y = x @ conj(A)."""

    def __init__(self, arg, sharding=None):
        self._sharding = sharding
        if isinstance(arg, Vectors):
            self._data = arg.device_data()
            self._sharding = arg._sharding
        elif isinstance(arg, (np.ndarray, jax.Array)):
            a = jnp.asarray(arg) if isinstance(arg, jax.Array) \
                else jnp.asarray(np.ascontiguousarray(arg))
            self._data = (jax.device_put(a, sharding)
                          if sharding is not None else a)
        else:
            raise ValueError('cannot build Matrix from %r' % type(arg))

    def data(self):
        return np.asarray(self._data)

    def device_array(self):
        """The underlying jax.Array (for jit-traceable operator closures,
        e.g. the chunked device engine in core/device_jacobi.py)."""
        return self._data

    def shape(self):
        return self._data.shape

    def data_type(self):
        return np.dtype(self._data.dtype).type

    def is_complex(self):
        return jnp.iscomplexobj(self._data)

    def order(self):
        return 'C_CONTIGUOUS'

    def apply(self, x, y, transp=False):
        kx = x.nvec()
        assert y.nvec() == kx
        Bx = bucket(kx)
        y._ensure_capacity(y._sel[0] + Bx)
        y._array = _k_apply_dense(self._data, x._array, x._sel[0], Bx,
                                  y._array, y._sel[0], kx, transp,
                                  self.is_complex())

    def dots(self):
        v = Vectors(self, shallow=True)
        return v.dots(v)

    def new_vectors(self, dim=None, nv=0):
        if dim is None:
            dim = self._data.shape[1]
        return Vectors(dim, nv, self.data_type(), sharding=self._sharding)
