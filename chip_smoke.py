#!/usr/bin/env python3
"""Drive the main paths once on a GPU and check each against a reference.

Usage:
    python chip_smoke.py                # phases 0-4, one GPU
    python chip_smoke.py --four-cards   # the sharded path only, four GPUs

Phases (each prints its first call, which compiles, and a warm call):

  0  JAX's default device must be a GPU; otherwise exit non-zero and print
     no result.
  1  Dense PCA at the LFW shape: ``pca(A, npc=800, arch='gpu')`` on a
     12,000 x 39,375 f32 matrix made on the device (``bench.make_data``).
     Reference: f64 singular values of the centred data from its
     12,000^2 Gram matrix.  The relative Frobenius truncation error must
     be within 0.5 % of the optimal rank-800 error, and the components
     orthonormal to 1e-4.
  2  HBM-scale sparse eigensolve: Chebyshev-preconditioned LOBPCG through
     ``partial_hevp`` on lap3d(100, 100, 128) (n = 1.28e6), 4 smallest to
     5e-5, with the preconditioner's bf16 iterate streaming off and on.
     Reference: the closed-form spectrum (1e-3 relative).  Also one DIA
     SpMM at m = 32 through ``matmat_rows`` against scipy's f64 CSR
     product, timed in GB/s beside a plain device copy of the same bytes.
  3  Shift-invert: native LDL^T on the host with device block algebra,
     lap3d(50, 50, 50) (10 nearest 0, closed form, 1e-6 relative) and the
     synthetic shipsec-class FE stiffness matrix (6 nearest 0, residual
     1e-5).  Runs in f64 (scoped x64) since the card has f64.
  4  Scattered-pattern SpMM: BSR and ELL layouts of the FE stiffness
     matrix at m = 16 against scipy's f64 product (1e-5 relative), with
     both rates.

``--four-cards`` runs phase 2's LOBPCG, the halo-exchange DIA SpMM and the
subspace PCA sharded over a 4-card mesh, each beside its single-card run
in the same process, and no other phase.

Prints the card's name and power limit from nvidia-smi, and as its last
line one JSON object: {"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}.  Any failed check raises, and the script
exits non-zero.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

def log(msg):
    print(msg, flush=True)


def require_gpu():
    """Phase 0: the default JAX device must be a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise SystemExit('chip_smoke: no GPU (JAX default device is %r)'
                         % dev.platform)
    return dev


def card_info():
    """nvidia-smi's name and power limit, one line per card."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def first_and_warm(label, fn):
    """Call ``fn`` twice, printing the first (compiling) and the warm
    wall time; returns the warm result."""
    import jax
    out = None
    for call in ('first', 'warm'):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        log('%s: %s call %.3f s' % (label, call, time.perf_counter() - t0))
    return out


# ------------------------------------------------------------ phase 1

def centred_singular_values_f64(a):
    """Singular values (descending, float64) of A minus its column means,
    from the eigenvalues of the f64 Gram matrix (A - e mean)(A - e mean)^T,
    computed on A's device under a scoped x64 context."""
    import jax
    import jax.numpy as jnp
    with jax.enable_x64(True):
        a64 = jnp.asarray(a).astype(jnp.float64)
        c = a64 - jnp.mean(a64, axis=0)
        g = jnp.matmul(c, c.T, precision=jax.lax.Precision.HIGHEST)
        del a64, c
        lam = np.asarray(jnp.linalg.eigvalsh(g), dtype=np.float64)
    return np.sqrt(np.clip(lam, 0.0, None))[::-1]


def optimal_truncation_error(sv, k):
    """Relative Frobenius error of the best rank-k approximation."""
    s2 = np.asarray(sv, dtype=np.float64) ** 2
    return float(np.sqrt(s2[k:].sum() / s2.sum()))


def pca_errors(a, mean, trans, comps):
    """(relative Frobenius error of A - e mean - trans comps,
    max |comps comps^T - I|), on A's device in full f32."""
    import jax
    import jax.numpy as jnp
    hi = jax.lax.Precision.HIGHEST
    a = jnp.asarray(a)
    comps = jnp.asarray(comps, dtype=a.dtype)
    trans = jnp.asarray(trans, dtype=a.dtype)
    c = a - jnp.asarray(mean, dtype=a.dtype).reshape(1, -1)
    r = c - jnp.matmul(trans, comps, precision=hi)
    err = float(jnp.linalg.norm(r) / jnp.linalg.norm(c))
    gram = jnp.matmul(comps, comps.T, precision=hi)
    ortho = float(jnp.max(jnp.abs(gram - jnp.eye(gram.shape[0],
                                                  dtype=gram.dtype))))
    return err, ortho


def phase_pca(a=None, npc=800):
    from raleigh_tpu.interfaces.pca import pca
    if a is None:
        from bench import make_data
        a = make_data()
    mean, trans, comps = first_and_warm(
        'phase 1 pca %dx%d npc=%d' % (a.shape + (npc,)),
        lambda: pca(a, npc=npc, arch='gpu'))
    check(comps.shape == (npc, a.shape[1]), 'comps shape %s'
          % (comps.shape,))
    err, ortho = pca_errors(a, mean, trans, comps)
    t0 = time.perf_counter()
    sv = centred_singular_values_f64(a)
    opt = optimal_truncation_error(sv, npc)
    log('phase 1 reference: f64 Gram spectrum %.3f s'
        % (time.perf_counter() - t0))
    log('phase 1 check: err_fro %.6f, optimal %.6f (ratio %.6f), '
        'max|CC^T-I| %.2e' % (err, opt, err / opt, ortho))
    check(err <= 1.005 * opt, 'PCA truncation error %.6f > 1.005 x %.6f'
          % (err, opt))
    check(ortho <= 1e-4, 'component orthonormality %.2e' % ortho)
    return a


# ------------------------------------------------------------ phase 2

def hevp_with_iterations(*args, **kwargs):
    """``partial_hevp`` returning (lmd, x, status, iterations), the count
    read from its own report line."""
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lmd, x, status = partial_hevp(*args, verb=0, **kwargs)
    found = re.findall(r'iterations: (\d+)', buf.getvalue())
    return lmd, x, status, int(found[-1]) if found else -1


def phase_lobpcg(shape=(100, 100, 128), which=4, tol=5e-5, degree=12):
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds
    from raleigh_tpu.examples.laplace import lap3d, lap3d_eigenvalues

    a = lap3d(*shape, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(*shape, 1.0, 1.0, 1.0))[:which]
    lo, hi = spectral_bounds(a)

    class Bf16Chebyshev(Chebyshev):
        """The same preconditioner with its opt-in bf16 streaming on."""

        def device_rows_operands(self, m, n=None, dtype=None):
            return super().device_rows_operands(m, n, dtype,
                                                stream_bf16=True)

    out = {}
    for bf16 in (False, True):
        ch = (Bf16Chebyshev if bf16 else Chebyshev)(a, lo, hi,
                                                    degree=degree,
                                                    arch='gpu')
        label = 'phase 2 lobpcg n=%d bf16=%s' % (a.shape[0], bf16)
        times = []
        for call in ('first', 'warm'):
            t0 = time.perf_counter()
            lmd, _, st, its = hevp_with_iterations(
                a, T=ch, which=which, tol=tol, arch='gpu')
            times.append(time.perf_counter() - t0)
            check(st == 0 and lmd is not None and len(lmd) >= which,
                  '%s: status %s' % (label, st))
            err = float(np.max(np.abs(np.sort(lmd)[:which] - exact)
                               / exact))
            log('%s: %s call %.3f s, %d iterations, max rel err %.2e'
                % (label, call, times[-1], its, err))
            check(err <= 1e-3, '%s: eigenvalue error %.2e' % (label, err))
        out[bf16] = (times[-1], its)
    return a, out


def phase_dia_spmm(a, m=32):
    """One DIA SpMM at block width m through ``matmat_rows`` against
    scipy, then its rate beside a device copy of the same operand."""
    import jax.numpy as jnp
    from bench import chain_seconds
    from raleigh_tpu.ops.spmm import DiaMatrix

    # 1/12 bounds lap3d's spectral radius by 1: chained applies stay finite
    a = a * (1.0 / 12.0)
    d = DiaMatrix(a)
    n = d.shape[0]
    x = np.random.default_rng(0).standard_normal((m, n)).astype(np.float32)
    xd = jnp.asarray(x)
    y = np.asarray(first_and_warm('phase 2 dia spmm m=%d' % m,
                                  lambda: d.matmat_rows(xd)))
    ref = (a @ x.T.astype(np.float64)).T
    rel = float(np.abs(y - ref).max() / np.abs(ref).max())
    log('phase 2 dia spmm check: max err %.2e x max|ref|' % rel)
    check(rel <= 1e-5, 'DIA SpMM error %.2e' % rel)
    vals = len(d.offsets) * n * 4
    rates = {}
    for dt in (jnp.float32, jnp.bfloat16):
        xv = xd.astype(dt)
        moved = vals + 2 * m * n * xv.dtype.itemsize
        t_spmm = chain_seconds(d.matmat_rows, xv)
        t_copy = chain_seconds(lambda z: z * jnp.asarray(0.5, dt), xv)
        spmm = moved / t_spmm / 1e9
        copy = 2 * m * n * xv.dtype.itemsize / t_copy / 1e9
        rates[np.dtype(dt).name] = (spmm, copy)
        log('phase 2 dia spmm %s: %.6f ms/apply, %.1f GB/s (values + x in '
            '+ y out); device copy %.1f GB/s; share %.3f'
            % (np.dtype(dt).name, t_spmm * 1e3, spmm, copy, spmm / copy))
    return rates


# ------------------------------------------------------------ phase 3

def phase_shift_invert(lap_shape=(50, 50, 50), fe=None):
    import jax
    from raleigh_tpu.examples.laplace import lap3d, lap3d_eigenvalues
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp
    from raleigh_tpu.utils.link import choose_orchestration

    a = lap3d(*lap_shape, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(*lap_shape, 1.0, 1.0, 1.0))[:10]
    if fe is None:
        from raleigh_tpu.examples.fe_model import shipsec_like
        fe, _ = shipsec_like()
    with jax.enable_x64(True):
        for name, n in (('lap3d', a.shape[0]), ('fe', fe.shape[0])):
            log('phase 3 orchestration (%s, n=%d, block 32): %s'
                % (name, n, choose_orchestration(n, 32)))
        lmd, _, st = first_and_warm(
            'phase 3 shift-invert lap3d n=%d' % a.shape[0],
            lambda: partial_hevp(a, sigma=0, which=10, verb=-1,
                                 arch='gpu'))
        check(st == 0 and lmd is not None and len(lmd) >= 10,
              'lap3d shift-invert status %s' % st)
        err = float(np.max(np.abs(np.sort(lmd)[:10] - exact) / exact))
        log('phase 3 lap3d check: max rel err %.2e' % err)
        check(err <= 1e-6, 'lap3d shift-invert error %.2e' % err)

        lmd, x, st = first_and_warm(
            'phase 3 shift-invert fe n=%d' % fe.shape[0],
            lambda: partial_hevp(fe, sigma=0, which=6, tol=1e-6, verb=-1,
                                 arch='gpu'))
        check(st == 0 and lmd is not None and len(lmd) >= 6,
              'fe shift-invert status %s' % st)
        x = np.asarray(x)[:, :6]
        r = fe @ x - x * np.asarray(lmd)[None, :6]
        norm_inf = float(abs(fe).sum(axis=1).max())
        rel = float(np.abs(r).max() / norm_inf)
        log('phase 3 fe check: residual %.2e x ||K||_inf' % rel)
        check(rel <= 1e-5, 'fe shift-invert residual %.2e' % rel)
    return fe


# ------------------------------------------------------------ phase 4

def phase_scattered_spmm(k=None, m=16):
    import jax
    import jax.numpy as jnp
    from bench import chain_seconds
    from raleigh_tpu.ops.spmm import BsrMatrix, EllMatrix, \
        rows_matmat_operands

    if k is None:
        from raleigh_tpu.examples.fe_model import shipsec_like
        k = shipsec_like(which='k', relabel=False)
    n = k.shape[0]
    # 1/||K||_inf bounds the chained iterate
    k = k * (1.0 / float(abs(k).sum(axis=1).max()))
    x = np.random.default_rng(1).standard_normal((m, n)).astype(np.float32)
    ref = (k @ x.T.astype(np.float64)).T
    xd = jnp.asarray(x)
    rates = {}
    for name, cls in (('bsr', BsrMatrix), ('ell', EllMatrix)):
        dm = cls(k)
        fn, ops = rows_matmat_operands(dm)
        apply = jax.jit(fn)
        y = np.asarray(first_and_warm('phase 4 %s spmm n=%d m=%d'
                                      % (name, n, m),
                                      lambda: apply(ops, xd)))
        rel = float(np.abs(y - ref).max() / np.abs(ref).max())
        t = chain_seconds(lambda z: fn(ops, z), xd, reps=50)
        stored = sum(int(o.size) * o.dtype.itemsize for o in ops)
        gbs = (stored + 2 * m * n * 4) / t / 1e9
        rates[name] = (dm.nnz / t / 1e9, gbs)
        log('phase 4 %s: %.6f ms/apply, %.3f Gnnz/s, %.1f GB/s (stored '
            '%.1f MB + x in + y out), max err %.2e x max|ref|'
            % (name, t * 1e3, rates[name][0], gbs, stored / 1e6, rel))
        check(rel <= 1e-5, '%s SpMM error %.2e' % (name, rel))
    return rates


# ------------------------------------------------------- four cards

def phase_four_cards(shape=(100, 100, 128), which=4, tol=5e-5, degree=12,
                     m=32, pca_data=None, npc=800, ncards=4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from bench import chain_seconds, make_data
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds
    from raleigh_tpu.core.device_solver import lobpcg, shard_operator
    from raleigh_tpu.examples.laplace import lap3d, lap3d_eigenvalues
    from raleigh_tpu.interfaces.randomized import subspace_pca
    from raleigh_tpu.ops.spmm import DiaMatrix
    from raleigh_tpu.parallel.mesh import AXIS, blockvec_sharding, make_mesh

    check(len(jax.devices()) >= ncards, 'need %d devices, have %d'
          % (ncards, len(jax.devices())))
    mesh = make_mesh(ncards)
    log('count: %d' % ncards)

    a = lap3d(*shape, 1.0, 1.0, 1.0)
    n = a.shape[0]
    exact = np.sort(lap3d_eigenvalues(*shape, 1.0, 1.0, 1.0))[:which]
    lo, hi = spectral_bounds(a)
    dm1 = DiaMatrix(a)
    dm4 = shard_operator(DiaMatrix(a), mesh, axis=AXIS)
    col_sharding = NamedSharding(mesh, P(AXIS, None))
    lam = {}
    for cards, dm, sh in ((1, dm1, None), (ncards, dm4, col_sharding)):
        ch = Chebyshev(a, lo, hi, degree=degree, device_matrix=dm)
        res = first_and_warm(
            'four-cards lobpcg n=%d on %d card(s)' % (n, cards),
            lambda: lobpcg(dm, which, precond=ch._device_fused_rows(),
                           tol=tol, maxit=600, sharding=sh))
        lmd, _, _, its, st = res
        check(st == 0, 'lobpcg on %d card(s): status %s' % (cards, st))
        err = float(np.max(np.abs(np.sort(lmd) - exact) / exact))
        log('four-cards lobpcg on %d card(s): %d iterations, max rel err '
            '%.2e' % (cards, its, err))
        check(err <= 1e-3, 'eigenvalue error %.2e' % err)
        lam[cards] = np.sort(np.asarray(lmd))
    diff = float(np.max(np.abs(lam[ncards] - lam[1]) / np.abs(lam[1])))
    log('four-cards lobpcg check: sharded vs single %.2e relative' % diff)
    check(diff <= 1e-5, 'sharded eigenvalues differ by %.2e' % diff)

    x = np.random.default_rng(0).standard_normal((m, n)).astype(np.float32)
    ref = (a @ x.T.astype(np.float64)).T
    fn = dm4.sharded_rows_fn(m, n)
    check(fn is not None, 'sharded_rows_fn refused the mesh')
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, AXIS)))
    x1 = jnp.asarray(x)
    for cards, f, xx in ((1, dm1.matmat_rows, x1), (ncards, fn, xs)):
        y = np.asarray(first_and_warm(
            'four-cards dia spmm m=%d on %d card(s)' % (m, cards),
            lambda: f(xx)))
        rel = float(np.abs(y - ref).max() / np.abs(ref).max())
        t = chain_seconds(lambda z: f(z) * np.float32(1.0 / 12.0), xx)
        gbs = (len(dm1.offsets) * n * 4 + 2 * m * n * 4) / t / 1e9
        log('four-cards dia spmm on %d card(s): %.6f ms/apply, %.1f GB/s '
            'total, max err %.2e x max|ref|' % (cards, t * 1e3, gbs, rel))
        check(rel <= 1e-5, 'SpMM error %.2e on %d card(s)' % (rel, cards))

    if pca_data is None:
        pca_data = make_data()
    # the sharded feature axis must divide evenly over the cards: pad it
    # with zero columns, which change neither the singular values nor the
    # truncation error
    rows, cols = pca_data.shape
    pad = -cols % ncards
    padded = jnp.pad(pca_data, ((0, 0), (0, pad))) if pad else pca_data
    ef = {}
    for cards, data in ((1, pca_data),
                        (ncards, jax.device_put(padded,
                                                blockvec_sharding(mesh)))):
        mean, trans, comps = first_and_warm(
            'four-cards subspace pca %dx%d npc=%d on %d card(s)'
            % (rows, cols, npc, cards),
            lambda: subspace_pca(data, npc, fetch=False))
        mean, comps = mean[:, :cols], comps[:, :cols]
        ef[cards], ortho = pca_errors(pca_data, mean, trans, comps)
        log('four-cards pca on %d card(s): err_fro %.6f, max|CC^T-I| '
            '%.2e' % (cards, ef[cards], ortho))
    diff = abs(ef[ncards] - ef[1]) / ef[1]
    log('four-cards pca check: sharded vs single %.2e relative' % diff)
    check(diff <= 1e-4, 'sharded PCA error differs by %.2e' % diff)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--four-cards', action='store_true',
                        help='run only the sharded path on four GPUs')
    args = parser.parse_args(argv)

    dev = require_gpu()
    import jax
    from raleigh_tpu.utils.env import use_compile_cache

    log('compile cache: %s' % use_compile_cache())
    log('devices: %s' % jax.devices())
    for line in card_info():
        log(line)
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        a = phase_pca()
        del a
        lap, _ = phase_lobpcg()
        phase_dia_spmm(lap)
        fe = phase_shift_invert()
        phase_scattered_spmm()
        del fe
    log('chip_smoke: all phases passed in %.1f s'
        % (time.perf_counter() - t0))
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices())}}), flush=True)


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
