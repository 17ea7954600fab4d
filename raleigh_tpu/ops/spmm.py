"""Device SpMM: symmetric sparse matrix times a block of row-vectors.

Device replacement for the capability the reference reaches through
MKL's csrsymv/csrmm (reference raleigh/algebra/mkl_wrap.py:204-277).  The
reference stores only the upper triangle (MKL descriptor 'SUNF'); here we
store *full rows* — the symmetric gather/scatter asymmetry of csrsymv is
hostile to SIMD machines, and storing both halves makes every output row an
independent reduction (reference SURVEY §7 design note).

Three device layouts:

  * DIA ("populated diagonals"): values stored per diagonal offset; the
    product is a sum of statically-shifted elementwise multiply-adds —
    no gathers at all, the layout of choice for stencil and banded
    matrices (FD Laplacians, RCM-reordered FE meshes).  XLA fuses the
    whole sum into one elementwise loop: one pass over the values, and the
    ``noff`` shifted reads of the operand block hit the same cache lines.

  * ELL ("padded rows"): indices/values padded to the max row degree and
    processed as a `lax.scan` over diagonals of the padded structure — each
    step is one gather of the (n, m) operand block plus a fused
    multiply-add.  Bandwidth-bound, works for any block width m, and is the
    layout halo-exchange sharding composes with (gathers stay local to the
    row shard).

  * BSR ("block tiles"): the matrix is cut into dense (bs x bs) tiles and
    nonempty tiles are contracted against the operand tiles via one
    batched matmul (cuBLAS on the GPU) per tile-row group.  Wins when the
    tile fill is large enough to amortize the zero padding
    (``sparse_layout``).

Operands are (m, n) blocks with vectors as rows (the algebra-layer storage
convention); internally SpMM runs on the transposed (n, m) layout so row
gathers hit the contiguous major dimension.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


def _to_full_csr(a):
    """scipy sparse (any symmetric storage) -> full-row canonical CSR."""
    import scipy.sparse as scs
    a = scs.csr_matrix(a)
    # symmetrize from whichever triangle(s) are present
    au = scs.triu(a, k=1)
    al = scs.tril(a, k=-1)
    if au.nnz == 0 and al.nnz > 0:
        a = a + al.T
    elif al.nnz == 0 and au.nnz > 0:
        a = a + au.T
    a = scs.csr_matrix(a)
    a.sum_duplicates()
    a.sort_indices()
    return a


class DiaMatrix:
    """Diagonal (DIA) device storage: values per populated diagonal, the
    SpMM is a sum of statically-shifted fused multiply-adds (no gathers).

    ``val[k, i]`` holds A[i, i + offsets[k]] (row-major diagonal
    convention, matching scipy.sparse.dia_matrix transposed)."""

    def __init__(self, a, dtype=np.float32):
        a = _to_full_csr(a)
        n = a.shape[0]
        d = a.todia()
        offsets = np.asarray(d.offsets, dtype=np.int64)
        order = np.argsort(offsets)
        offsets = offsets[order]
        # scipy dia data[k, j] = A[j - offsets[k], j] (column j); convert
        # to row convention val[k, i] = A[i, i + off] = data[k, i + off]
        val = np.zeros((len(offsets), n), dtype=dtype)
        for k, off in enumerate(offsets):
            data_k = d.data[order[k]]
            if off >= 0:
                val[k, : n - off] = data_k[off: n]
            else:
                val[k, -off:] = data_k[: n + off]
        self.shape = (n, n)
        self.nnz = int(a.nnz)
        self.offsets = tuple(int(o) for o in offsets)
        self.val = jnp.asarray(val)
        self.dtype = dtype

    def matmat_t(self, xt):
        """(n, m) = A @ (n, m)."""
        return _dia_matmat(self.val, xt, self.offsets)

    def _shard_fingerprint(self):
        """Hashable identity of ``self.val``'s placement, part of every
        cache key: ``shard_operator`` re-places the payload in place, and
        a cached shard_map bound to the previous mesh would otherwise be
        served stale."""
        sh = getattr(self.val, 'sharding', None)
        mesh = getattr(sh, 'mesh', None)
        if mesh is None:
            return None
        return (tuple(mesh.shape.items()), str(getattr(sh, 'spec', None)))

    def _multi_device(self):
        """True when the diagonal values are sharded over several devices
        (``core.device_solver.shard_operator``): every apply then goes
        through the explicit halo-exchange ``shard_map`` when its
        partitioning constraints hold, and through the GSPMD-partitioned
        fused kernel otherwise."""
        sh = getattr(self.val, 'sharding', None)
        return sh is not None and len(sh.device_set) > 1

    def matmat_rows(self, x):
        """(m, n) = ((m, n) @ A) for row-vector operand blocks — the
        layout the block-vector algebra stores (vectors as rows), so no
        transposes are inserted (A symmetric, so x A = (A x')').  Runs
        the fused XLA shifted-slice kernel; values sharded over a mesh
        route to the halo-exchange ``shard_map``.  The result has the
        operand's dtype whatever the routing (bf16 operands accumulate
        against the f32 values and are cast back)."""
        m, n = x.shape
        if self._multi_device():
            fn = self.sharded_rows_fn(m, n, x.dtype)
            if fn is not None:
                return fn(x).astype(x.dtype)
        return _dia_matmat_rows(self.val, x, self.offsets).astype(x.dtype)

    def rows_operand_form(self, m, n, dtype=jnp.float32):
        """(fn, operands) argument-form of ``matmat_rows``:
        ``fn(operands, x)`` applies A to an (m, n) row block with the
        diagonal values flowing through as arguments.  Superkernels
        (LOBPCG, fused Chebyshev) trace ``fn`` inside their own jit, so
        the matrix payload never becomes a compiled-in literal and one
        compiled program serves every matrix of the same shape."""
        offsets = self.offsets
        if self._multi_device():
            f = self.sharded_rows_fn(m, n, dtype)
            if f is not None:
                fn0 = f.operand_fn

                def fn(ops, x):
                    return fn0(ops[0], x)
                return fn, (self.val,)

        def fn(ops, x):
            return _dia_matmat_rows(ops[0], x, offsets)
        return fn, (self.val,)

    def sharded_rows_fn(self, m, n, dtype=jnp.float32):
        """Mesh-partitioned row-layout apply: each shard computes its
        lane range from its local diagonals plus ``ppermute``-exchanged
        neighbor halos (one hop per side) through the fused XLA
        extended-operand kernel (SURVEY §5.8).

        The ring wraps at the global boundary; the wrapped lanes are
        annihilated by the zero out-of-range diagonal values, so no edge
        cases exist.  Returns None when the partitioning constraints
        fail (uneven shards, halo wider than a shard) — callers then use
        the GSPMD-partitioned fused kernel."""
        from jax import lax, shard_map
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = getattr(self.val, 'sharding', None)
        if not isinstance(sh, NamedSharding):
            return None
        spec = tuple(sh.spec) + (None,) * (2 - len(tuple(sh.spec)))
        axis = spec[1]
        if isinstance(axis, tuple):
            if len(axis) != 1:
                return None      # ring ppermute needs one mesh axis
            axis = axis[0]
        if spec[0] is not None or axis is None:
            return None
        mesh = sh.mesh
        nshards = int(mesh.shape[axis])
        offsets = self.offsets
        halo_lo = max(0, -min(offsets))
        halo_hi = max(0, max(offsets))
        if n % nshards:
            return None
        n_local = n // nshards
        if max(halo_lo, halo_hi) > n_local:
            return None
        key = ('sharded', m, n, str(np.dtype(dtype)),
               self._shard_fingerprint())
        if not hasattr(self, '_rows_cache'):
            self._rows_cache = {}
        hit = self._rows_cache.get(key)
        if hit is not None:
            return hit

        def kernel(val_l, x_l):
            fwd = [(i, (i + 1) % nshards) for i in range(nshards)]
            bwd = [(i, (i - 1) % nshards) for i in range(nshards)]
            parts = []
            if halo_lo:
                parts.append(lax.ppermute(x_l[:, -halo_lo:], axis, fwd))
            parts.append(x_l)
            if halo_hi:
                parts.append(lax.ppermute(x_l[:, :halo_hi], axis, bwd))
            x_ext = jnp.concatenate(parts, axis=1) if len(parts) > 1 \
                else x_l
            return _dia_matmat_rows_ext(val_l, x_ext, offsets, halo_lo,
                                        n_local)

        mapped = shard_map(kernel, mesh=mesh,
                           in_specs=(P(None, axis), P(None, axis)),
                           out_specs=P(None, axis))

        def apply(x):
            return mapped(self.val, x)

        # argument-form hook (see rows_operand_form)
        apply.operand_fn = mapped
        self._rows_cache[key] = apply
        return apply


@partial(jax.jit, static_argnames=('offsets', 'lo_ext', 'n'))
def _dia_matmat_rows_ext(val, x_ext, offsets, lo_ext, n):
    """Fused XLA DIA SpMM over a pre-extended operand: x_ext carries
    ``lo_ext`` halo lanes before the n local lanes (plus at least
    max(offsets) after), so every diagonal is a static slice with no
    padding pass — the per-shard fallback of the mesh-partitioned SpMM."""
    m = x_ext.shape[0]
    y = jnp.zeros((m, n), dtype=x_ext.dtype)
    for k, off in enumerate(offsets):
        y = y + val[k][None, :n] * jax.lax.dynamic_slice_in_dim(
            x_ext, lo_ext + off, n, axis=1)
    return y


@partial(jax.jit, static_argnames=('offsets',))
def _dia_matmat_rows(val, x, offsets):
    """Row-layout twin of ``_dia_matmat``: y[:, i] = sum_k val[k, i] *
    x[:, i + offsets[k]] with the static shifts on the lane (minor)
    dimension, so row-vector operand blocks need no relayout."""
    m, n = x.shape
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    xp = jnp.pad(x, ((0, 0), (lo, hi)))
    y = jnp.zeros((m, n), dtype=x.dtype)
    for k, off in enumerate(offsets):
        y = y + val[k][None, :] * jax.lax.dynamic_slice_in_dim(
            xp, lo + off, n, axis=1)
    return y


@partial(jax.jit, static_argnames=('offsets',))
def _dia_matmat(val, xt, offsets):
    """y[i] = sum_k val[k, i] * xt[i + offsets[k]] with static shifts: the
    operand is zero-padded once on both sides, every diagonal becomes a
    static slice, and XLA fuses the whole sum into one elementwise pass."""
    n, m = xt.shape
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    xp = jnp.pad(xt, ((lo, hi), (0, 0)))
    y = jnp.zeros((n, m), dtype=xt.dtype)
    for k, off in enumerate(offsets):
        y = y + val[k][:, None] * jax.lax.dynamic_slice_in_dim(
            xp, lo + off, n, axis=0)
    return y


class EllMatrix:
    """Padded-row (ELLPACK) device storage of a symmetric sparse matrix."""

    def __init__(self, a, dtype=np.float32, pad_to=8):
        a = _to_full_csr(a)
        n = a.shape[0]
        deg = np.diff(a.indptr)
        k = int(deg.max()) if n else 0
        k = max(1, ((k + pad_to - 1) // pad_to) * pad_to)
        idx = np.zeros((n, k), dtype=np.int32)
        val = np.zeros((n, k), dtype=dtype)
        # vectorized fill of the padded structure
        rows = np.repeat(np.arange(n), deg)
        offs = np.arange(a.nnz) - np.repeat(a.indptr[:-1], deg)
        idx[rows, offs] = a.indices
        val[rows, offs] = a.data.astype(dtype)
        self.shape = (n, n)
        self.nnz = int(a.nnz)
        self.row_degree = k
        self.idx = jnp.asarray(idx)
        self.val = jnp.asarray(val)
        self.dtype = dtype

    def matmat_t(self, xt):
        """(n, m) = A @ (n, m): operand and result transposed blocks."""
        return _ell_matmat(self.idx, self.val, xt)


@jax.jit
def _ell_matmat(idx, val, xt):
    """y[i, :] = sum_k val[i, k] * xt[idx[i, k], :] via a scan over the
    padded-column axis (one gather + fma per step keeps peak memory at one
    (n, m) temporary instead of an (n, K, m) cube)."""
    m = xt.shape[1]
    n, K = idx.shape

    def step(acc, ev):
        col_idx, col_val = ev
        acc = acc + col_val[:, None] * jnp.take(xt, col_idx, axis=0,
                                                fill_value=0)
        return acc, None

    init = jnp.zeros((n, m), dtype=xt.dtype)
    acc, _ = jax.lax.scan(step, init,
                          (jnp.moveaxis(idx, 1, 0), jnp.moveaxis(val, 1, 0)))
    return acc


class BsrMatrix:
    """Block-sparse (dense tile) device storage: nonempty (bs x bs) tiles
    contracted by one batched matmul."""

    def __init__(self, a, dtype=np.float32, bs=128):
        import scipy.sparse as scs
        a = _to_full_csr(a)
        n = a.shape[0]
        nb = -(-n // bs)
        ab = scs.bsr_matrix(a, blocksize=(min(bs, n), min(bs, n))) \
            if n % bs == 0 else None
        if ab is None:
            pad = nb * bs - n
            a = scs.csr_matrix(
                scs.vstack([scs.hstack([a, scs.csr_matrix((n, pad))]),
                            scs.csr_matrix((pad, nb * bs))]))
            ab = scs.bsr_matrix(a, blocksize=(bs, bs))
        ab.sort_indices()
        self.shape = (n, n)
        self.n_padded = nb * bs
        self.bs = bs
        self.nnz = int(_to_full_csr(a).nnz)
        self.block_indptr = np.asarray(ab.indptr)
        self.block_cols = jnp.asarray(ab.indices.astype(np.int32))
        self.blocks = jnp.asarray(ab.data.astype(dtype))  # (nblocks, bs, bs)
        # row-block id for every stored tile (for segment reduction)
        self.block_rows = jnp.asarray(
            np.repeat(np.arange(nb, dtype=np.int32),
                      np.diff(ab.indptr)))
        self.nb = nb
        self.dtype = dtype

    def matmat_t(self, xt):
        """(n, m) = A @ (n, m) with batched tile contractions."""
        n, m = xt.shape
        pad = self.n_padded - n
        if pad:
            xt = jnp.pad(xt, ((0, pad), (0, 0)))
        y = _bsr_matmat(self.blocks, self.block_cols, self.block_rows,
                        xt.reshape(self.nb, self.bs, m), self.nb)
        y = y.reshape(self.n_padded, m)
        # operand dtype out, matching the DIA row path (accumulation
        # inside _bsr_matmat stays >= f32 regardless)
        return (y[:n] if pad else y).astype(xt.dtype)


@partial(jax.jit, static_argnames=('nb',))
def _bsr_matmat(blocks, block_cols, block_rows, xtiles, nb):
    # gather operand tiles, batched matmul, segment-sum per block row.
    # Accumulation is at least f32 whatever the tile storage: bf16
    # blocks (opt-in, halves the streamed tile bytes) still accumulate
    # in f32
    xg = jnp.take(xtiles, block_cols, axis=0)          # (nnzb, bs, m)
    pet = jnp.promote_types(jnp.float32, xtiles.dtype)
    # HIGHEST: full-f32 products (TF32 would cost ~1e-3 relative)
    prod = jnp.einsum('bij,bjk->bik', blocks, xg,
                      preferred_element_type=pet,
                      precision=jax.lax.Precision.HIGHEST)
    return jax.ops.segment_sum(prod, block_rows,
                               num_segments=nb).astype(pet)


def rows_matmat_operands(dm):
    """(fn, operands) for a device sparse matrix: ``fn(operands, x)``
    applies A to an (m, n) row block with the matrix payload passed as an
    ARGUMENT pytree — the form the chunked engines jit over so the
    compiled program contains no matrix literals (a new matrix would
    otherwise mean a full recompile; see core/device_jacobi.py)."""
    if isinstance(dm, DiaMatrix):
        offs = dm.offsets

        def fn(ops, x):
            return _dia_matmat_rows(ops[0], x, offs)
        return fn, (dm.val,)
    if isinstance(dm, EllMatrix):
        def fn(ops, x):
            return _ell_matmat(ops[0], ops[1], x.T).T
        return fn, (dm.idx, dm.val)
    if isinstance(dm, BsrMatrix):
        n, nb, bs, npd = dm.shape[0], dm.nb, dm.bs, dm.n_padded

        def fn(ops, x):
            blocks, cols, rows_ = ops
            xt = x.T
            if npd > n:
                xt = jnp.pad(xt, ((0, npd - n), (0, 0)))
            y = _bsr_matmat(blocks, cols, rows_,
                            xt.reshape(nb, bs, -1), nb)
            # operand dtype out, matching the DIA row path
            return y.reshape(npd, -1)[:n].T.astype(x.dtype)
        return fn, (dm.blocks, dm.block_cols, dm.block_rows)
    raise TypeError('unsupported device matrix %r' % type(dm).__name__)


# apply rates of the scattered-pattern layouts, measured on an H100
# (700 W) on the FE flagship pattern (n = 139k, m = 16, tile fill 0.045):
# BSR streams its (bs x bs) f32 tiles at 1.5 TB/s, the ELL scan runs at
# 3.8 Gnnz/s.  BSR is predicted faster above a tile fill of
# 4 * ELL_NNZ_PER_S / BSR_TILE_BYTES_PER_S, about 1 %
BSR_TILE_BYTES_PER_S = 1.5e12
ELL_NNZ_PER_S = 3.8e9


def sparse_layout(csr, bs=128, max_dia_offsets=96, max_dia_waste=3.0):
    """The device layout ``device_sparse`` builds for the full-row CSR
    matrix ``csr``: 'dia' when the pattern collapses onto few populated
    diagonals (stencils, banded matrices — no gathers at all), else
    whichever of 'bsr' and 'ell' has the lower predicted apply time."""
    n = csr.shape[0]
    if n > 1:
        rows = np.repeat(np.arange(n), np.diff(csr.indptr))
        noff = np.unique(csr.indices - rows).size
        if noff <= max_dia_offsets and noff * n <= max_dia_waste * csr.nnz:
            return 'dia'
    if n < bs:
        return 'ell'
    # number of nonempty tiles = distinct (row_tile, col_tile) pairs
    nb = -(-n // bs)
    row_t = np.repeat(np.arange(n) // bs, np.diff(csr.indptr))
    keys = row_t.astype(np.int64) * nb + (csr.indices // bs)
    ntiles = np.unique(keys).size
    if ntiles * bs * bs * 4 / BSR_TILE_BYTES_PER_S \
            < csr.nnz / ELL_NNZ_PER_S:
        return 'bsr'
    # ELL pads every row to the MAX degree: a few hub rows (e.g. a
    # boundary-condition row coupled to everything) would inflate the
    # padded storage K*n arbitrarily — route degree-skewed patterns to
    # BSR, whose storage is bounded by the nonempty tiles
    deg_max = int(np.diff(csr.indptr).max())
    if deg_max * n > 16 * max(csr.nnz, 1):
        return 'bsr'
    return 'ell'


def device_sparse(a, dtype=np.float32, bs=128, max_dia_offsets=96,
                  max_dia_waste=3.0):
    """The symmetric sparse matrix ``a`` in the device layout
    ``sparse_layout`` chooses."""
    csr = _to_full_csr(a)
    layout = sparse_layout(csr, bs, max_dia_offsets, max_dia_waste)
    if layout == 'dia':
        return DiaMatrix(csr, dtype=dtype)
    if layout == 'bsr':
        return BsrMatrix(csr, dtype=dtype, bs=bs)
    return EllMatrix(csr, dtype=dtype)
