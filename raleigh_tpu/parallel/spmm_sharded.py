"""Row-partitioned sharded SpMM with neighbor halo exchange.

The multi-chip sparse kernel the SURVEY's north star calls for: the
symmetric matrix is bandwidth-reduced (reverse Cuthill-McKee), its ELL
structure row-partitioned over the mesh, and each shard computes its row
block against its local slice of the operand plus a halo of neighbor rows
fetched with ``lax.ppermute`` (NCCL between GPUs) — communication
proportional to the
matrix bandwidth, not to n, and overlapped with local compute by XLA's
latency-hiding scheduler.

Three communication regimes, chosen from the reordered pattern:

  * one-hop halo — bandwidth fits within one neighbor chunk per side;
    each shard exchanges just the boundary rows (the common case for
    RCM-reordered meshes/stencils);
  * multi-hop halo — the band spans h > 1 chunks; h parallel ppermutes
    per side fetch the full intermediate chunks and a sliced outermost
    remainder, still O(bandwidth) traffic;
  * gathered — scattered patterns where halos would approach n anyway;
    the operand block is all-gathered and indices stay global.  Always
    correct, O(n) traffic — the fallback that keeps arbitrary matrices
    working on the mesh.

Operand layout matches the framework's block-vector sharding: the
transposed block (n, m) sharded along n (PartitionSpec(AXIS, None)).
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from .mesh import AXIS


class ShardedEllMatrix:
    """Symmetric sparse matrix in RCM-reordered, row-sharded ELL form.

    ``mode``: 'auto' (default) picks halo exchange when the reordered
    bandwidth spans at most half the ring, gathered otherwise; 'halo'
    and 'gather' force the respective regime ('halo' raises if the
    pattern cannot be covered without wrapping the ring).
    """

    def __init__(self, a, mesh, dtype=np.float32, pad_to=8, mode='auto'):
        import scipy.sparse as scs
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        from ..ops.spmm import _to_full_csr

        a = _to_full_csr(a)
        n0 = a.shape[0]
        perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
        a = a[perm, :][:, perm].tocsr()
        a.sort_indices()

        nshards = mesh.shape[AXIS]
        # pad n to a multiple of the shard count
        chunk = -(-n0 // nshards)
        n = chunk * nshards
        if n > n0:
            a = scs.csr_matrix(
                scs.vstack([scs.hstack([a, scs.csr_matrix((n0, n - n0))]),
                            scs.csr_matrix((n - n0, n))]))
        deg = np.diff(a.indptr)
        k = max(1, int(deg.max()))
        k = ((k + pad_to - 1) // pad_to) * pad_to
        idx = np.zeros((n, k), dtype=np.int32)
        val = np.zeros((n, k), dtype=dtype)
        rows = np.repeat(np.arange(n), deg)
        offs = np.arange(a.nnz) - np.repeat(a.indptr[:-1], deg)
        idx[rows, offs] = a.indices
        val[rows, offs] = a.data.astype(dtype)

        # per-side halo extents: how far any row's columns reach below /
        # above its own chunk, in rows
        lo = (np.arange(n) // chunk) * chunk
        halo_lo = halo_hi = 0
        nz = val != 0
        if nz.any():
            rel_lo = (lo[:, None] - idx)[nz]
            rel_hi = (idx - (lo[:, None] + chunk - 1))[nz]
            halo_lo = int(max(rel_lo.max(), 0))
            halo_hi = int(max(rel_hi.max(), 0))
        hops_lo = -(-halo_lo // chunk)
        hops_hi = -(-halo_hi // chunk)

        # a halo wider than half the ring would wrap: rows would arrive
        # from both directions at once, so fall back to gathering
        fits = hops_lo + hops_hi < nshards
        if mode == 'auto':
            mode = 'halo' if fits else 'gather'
        elif mode == 'halo' and not fits:
            raise ValueError(
                'matrix bandwidth spans the whole ring even after RCM; '
                "use mode='gather' (or 'auto') for this pattern")

        self.mesh = mesh
        self.shape = (n0, n0)
        self.n_padded = n
        self.chunk = chunk
        self.mode = mode
        self.nnz = int(a.nnz)
        self.perm = perm
        self.iperm = np.empty_like(perm)
        self.iperm[perm] = np.arange(n0)
        self.row_degree = k
        self.dtype = dtype
        sh = NamedSharding(mesh, P(AXIS, None))
        if mode == 'gather':
            self.halo = (0, 0)
            self.idx = jax.device_put(idx, sh)            # global indices
        else:
            self.halo = (halo_lo, halo_hi)
            # local indices into [halo_lo | chunk | halo_hi]
            self.idx = jax.device_put(
                np.clip(idx - lo[:, None] + halo_lo, 0,
                        chunk + halo_lo + halo_hi - 1).astype(np.int32), sh)
        self.val = jax.device_put(val, sh)

    def matmat_t(self, xt):
        """(n0, m) = A_original @ (n0, m); operand in ORIGINAL ordering,
        output in original ordering (permutations applied on device)."""
        n0, m = xt.shape
        sh = NamedSharding(self.mesh, P(AXIS, None))
        xt = jnp.asarray(xt)
        xp = jnp.take(xt, jnp.asarray(self.perm), axis=0)
        if self.n_padded > n0:
            xp = jnp.pad(xp, ((0, self.n_padded - n0), (0, 0)))
        xp = jax.device_put(xp, sh)
        if self.mode == 'gather':
            y = _sharded_ell_gather(self.idx, self.val, xp, self.mesh)
        else:
            y = _sharded_ell_halo(self.idx, self.val, xp, self.mesh,
                                  self.halo, self.chunk)
        y = y[:n0]
        return jnp.take(y, jnp.asarray(self.iperm), axis=0)


def _ell_accumulate(idx_l, val_l, xe, x_l):
    """Row block of the product: scan over the padded-column axis keeps
    peak memory at one (rows, m) temporary.  The accumulator is derived
    from the local operand block so its shard-varying type matches the
    scan carry under shard_map."""
    def step(acc, ev):
        ci, cv = ev
        return acc + cv[:, None] * jnp.take(xe, ci, axis=0), None

    acc, _ = lax.scan(step, jnp.zeros_like(x_l),
                      (jnp.moveaxis(idx_l, 1, 0),
                       jnp.moveaxis(val_l, 1, 0)))
    return acc


@partial(jax.jit, static_argnames=('mesh', 'halo', 'chunk'))
def _sharded_ell_halo(idx, val, xt, mesh, halo, chunk):
    """Halo-exchange SpMM: each side's halo is assembled from as many
    whole neighbor chunks as the band spans, plus a sliced outermost
    remainder; all hops are independent ppermutes XLA can overlap."""
    nshards = mesh.shape[AXIS]
    halo_lo, halo_hi = halo

    def from_below(x_l, h, rows):
        # rows trailing rows of the chunk h hops below this shard
        src = x_l[-rows:] if rows else x_l[:0]
        return lax.ppermute(src, AXIS,
                            [(i, (i + h) % nshards) for i in range(nshards)])

    def from_above(x_l, h, rows):
        src = x_l[:rows] if rows else x_l[:0]
        return lax.ppermute(src, AXIS,
                            [(i, (i - h) % nshards) for i in range(nshards)])

    hops_lo = -(-halo_lo // chunk)
    hops_hi = -(-halo_hi // chunk)

    def kernel(idx_l, val_l, x_l):
        # inner hops carry whole chunks; the outermost hop carries only
        # the remainder the band actually reaches
        below = [from_below(x_l, h,
                            halo_lo - (h - 1) * chunk if h == hops_lo
                            else chunk)
                 for h in range(1, hops_lo + 1)]
        below.reverse()   # farthest hop holds the lowest rows
        above = [from_above(x_l, h,
                            halo_hi - (h - 1) * chunk if h == hops_hi
                            else chunk)
                 for h in range(1, hops_hi + 1)]
        xe = jnp.concatenate(below + [x_l] + above) \
            if below or above else x_l
        return _ell_accumulate(idx_l, val_l, xe, x_l)

    return shard_map(kernel, mesh=mesh,
                     in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None)),
                     out_specs=P(AXIS, None))(idx, val, xt)


@partial(jax.jit, static_argnames=('mesh',))
def _sharded_ell_gather(idx, val, xt, mesh):
    """Gathered SpMM: the operand block is all-gathered over the mesh and
    ELL indices stay global.  O(n) traffic, valid for any pattern."""
    def kernel(idx_l, val_l, x_l):
        xe = lax.all_gather(x_l, AXIS, tiled=True)
        return _ell_accumulate(idx_l, val_l, xe, x_l)

    return shard_map(kernel, mesh=mesh,
                     in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None)),
                     out_specs=P(AXIS, None))(idx, val, xt)
