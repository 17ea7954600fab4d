"""Scattered-pattern SpMM on one GPU: BSR against ELL on the FE stiffness
pattern at several mesh sizes, beside the layout ``sparse_layout`` picks.

Each case is a box-girder stiffness matrix (``examples.fe_model.fe_pencil``
with ``nc`` cells across; 39 is the n = 139k flagship), in the mesher's
node order, plus the flagship randomly relabelled.  One (m, n) row-block
apply of each layout is timed chained (``bench.chain_seconds``) and
checked against scipy's f64 product.  BSR is skipped where its tiles
would take more than ``--max-tile-gb``.

Usage: python benches/bench_spmm.py [--m 16] [--sizes 8,16,24,39]
Prints one JSON line per case.  Exits non-zero without a GPU.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def case(k, m, max_tile_gb=8.0, bs=128):
    """ms per apply and max relative error of BSR and ELL on ``k``."""
    import jax
    import jax.numpy as jnp
    from bench import chain_seconds
    from raleigh_tpu.ops.spmm import (BsrMatrix, EllMatrix, _to_full_csr,
                                      rows_matmat_operands, sparse_layout)

    csr = _to_full_csr(k)
    # 1/||K||_inf bounds the chained iterate
    csr = csr * (1.0 / float(abs(csr).sum(axis=1).max()))
    n = csr.shape[0]
    nb = -(-n // bs)
    row_t = np.repeat(np.arange(n) // bs, np.diff(csr.indptr))
    ntiles = np.unique(row_t.astype(np.int64) * nb
                       + csr.indices // bs).size
    out = {'n': n, 'nnz': int(csr.nnz), 'm': m,
           'tile_fill': csr.nnz / (ntiles * bs * bs),
           'layout': sparse_layout(csr, bs)}
    x = np.random.default_rng(1).standard_normal((m, n)).astype(np.float32)
    ref = (csr @ x.T.astype(np.float64)).T
    xd = jnp.asarray(x)
    for name, cls in (('bsr', BsrMatrix), ('ell', EllMatrix)):
        if name == 'bsr' and ntiles * bs * bs * 4 > max_tile_gb * 1e9:
            out['bsr_ms'] = None
            continue
        fn, ops = rows_matmat_operands(cls(csr))
        y = np.asarray(jax.jit(fn)(ops, xd))
        out['%s_err' % name] = float(np.abs(y - ref).max()
                                     / np.abs(ref).max())
        out['%s_ms' % name] = 1e3 * chain_seconds(lambda z: fn(ops, z), xd,
                                                  reps=50)
        del ops
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--m', type=int, default=16)
    parser.add_argument('--sizes', default='8,16,24,39')
    parser.add_argument('--max-tile-gb', type=float, default=8.0)
    args = parser.parse_args(argv)

    import jax
    from raleigh_tpu.examples.fe_model import fe_pencil
    from raleigh_tpu.utils.env import use_compile_cache

    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        sys.exit('bench_spmm: no GPU (JAX default device is %r)'
                 % dev.platform)
    use_compile_cache()
    device = {'platform': dev.platform, 'kind': dev.device_kind,
              'count': len(jax.devices())}
    cases = [(int(nc), False) for nc in args.sizes.split(',')]
    cases.append((cases[-1][0], True))
    for nc, relabel in cases:
        k = fe_pencil(nc, 6, 0.10, 7, which='k', relabel=relabel)
        rec = {'metric': 'fe_spmm', 'nc': nc, 'relabel': relabel,
               'device': device}
        rec.update(case(k, args.m, args.max_tile_gb))
        print(json.dumps(rec), flush=True)


if __name__ == '__main__':
    main()
