"""Where the time of the n = 1.28e6 sparse eigensolve goes, on one GPU.

The solve is chip_smoke.py's phase 2: Chebyshev-preconditioned (degree
12) LOBPCG on lap3d(100, 100, 128), the 4 smallest eigenvalues to 5e-5.
In one process, each variant is warmed once and then timed in turns
(forward, then reversed order, ``--reps`` rounds):

  setup     the host set-up ``partial_hevp`` repeats per call: the
            ``SparseSymmetricMatrix`` with its device matrix, and the
            argument-form Chebyshev recurrence;
  lobpcg    ``core.device_solver.lobpcg`` on prebuilt operands: the
            program ``partial_hevp`` runs, without its set-up;
  hevp      the whole ``partial_hevp`` call;
  hevp_bf16 the same with the preconditioner's bf16 streaming on.

Every timed call also records the seconds JAX spent tracing, lowering and
compiling or loading from the compile cache (``jax.monitoring``).  Then,
at the solver's block width: one DIA SpMM and one whole Chebyshev apply,
f32 and bf16 (chained applies, ``bench.chain_seconds``).  Last, one warm
``partial_hevp`` call under ``jax.profiler``, reduced to device busy
seconds and the device seconds of its largest operations
(``utils.profiling.device_activity``).

Usage: python benches/bench_lobpcg_hbm.py [--reps R] [--out DIR]
Prints one JSON line (and writes it, with the trace, under DIR).  Exits
non-zero without a GPU.
"""

import argparse
import collections
import contextlib
import io
import json
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

JAX_EVENTS = {
    '/jax/core/compile/jaxpr_trace_duration': 'trace_s',
    '/jax/core/compile/jaxpr_to_mlir_module_duration': 'lower_s',
    '/jax/core/compile/backend_compile_duration': 'compile_or_load_s',
}


class JaxSeconds:
    """Sums JAX's tracing, lowering and compile (or cache load) seconds."""

    def __init__(self):
        import jax
        self.total = collections.Counter()
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, **_):
        if event in JAX_EVENTS:
            self.total[JAX_EVENTS[event]] += secs

    def timed(self, fn):
        """(result, {'wall_s', 'trace_s', 'lower_s', 'compile_or_load_s'})
        of one call of ``fn``."""
        import jax
        before = dict(self.total)
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        rec = {'wall_s': time.perf_counter() - t0}
        for key in JAX_EVENTS.values():
            rec[key] = self.total[key] - before.get(key, 0.0)
        return out, rec


def problem(shape, which, degree):
    """(matrix, exact eigenvalues, Chebyshev, the same with bf16
    streaming on)."""
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds
    from raleigh_tpu.examples.laplace import lap3d, lap3d_eigenvalues

    class Bf16Chebyshev(Chebyshev):
        def device_rows_operands(self, m, n=None, dtype=None):
            return super().device_rows_operands(m, n, dtype,
                                                stream_bf16=True)

    a = lap3d(*shape, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(*shape, 1.0, 1.0, 1.0))[:which]
    lo, hi = spectral_bounds(a)
    return a, exact, *(cls(a, lo, hi, degree=degree, arch='gpu')
                       for cls in (Chebyshev, Bf16Chebyshev))


def variants(a, ch, ch_bf16, which, tol, check):
    """(name -> zero-argument call, the solver's block width)."""
    import jax
    from raleigh_tpu.algebra.sparse import SparseSymmetricMatrix
    from raleigh_tpu.core.device_solver import default_block, lobpcg
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp

    n = a.shape[0]
    m = default_block(which, n)

    def setup():
        dev = SparseSymmetricMatrix(a, arch='gpu').device_matrix()
        return dev, ch.device_rows_operands(m, n, dtype=np.dtype('float32'))

    def timed_setup():
        # the arrays the set-up put on the device, to wait for
        dev_, pre_ = setup()
        return jax.tree_util.tree_leaves((getattr(dev_, 'val', None),
                                          pre_[1]))

    dev, pre = setup()

    def solve_lobpcg():
        lmd, _, _, its, st = lobpcg(dev, which, precond=pre, tol=tol,
                                    maxit=600, dtype=np.float32)
        return check(lmd, st, its)

    def solve_hevp(t):
        def run():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                lmd, _, st = partial_hevp(a, T=t, which=which, tol=tol,
                                          verb=0, arch='gpu')
            its = re.findall(r'iterations: (\d+)', buf.getvalue())
            return check(lmd, st, int(its[-1]) if its else -1)
        return run

    return {'setup': timed_setup,
            'lobpcg': solve_lobpcg,
            'hevp': solve_hevp(ch),
            'hevp_bf16': solve_hevp(ch_bf16)}, m


def interleaved(calls, timer, reps):
    """Warm each call once, then time them in turns: forward order, then
    reversed, ``reps`` rounds.  Returns name -> list of records."""
    names = list(calls)
    recs = {name: [] for name in names}
    for name in names:
        _, rec = timer.timed(calls[name])
        rec['first'] = True
        recs[name].append(rec)
    for r in range(reps):
        for name in (names if r % 2 == 0 else names[::-1]):
            out, rec = timer.timed(calls[name])
            if isinstance(out, dict):
                rec.update(out)
            recs[name].append(rec)
    return recs


def apply_rates(ch, dm, m, n):
    """ms per DIA SpMM and per Chebyshev apply at block width m, f32 and
    bf16 iterates."""
    import jax
    import jax.numpy as jnp
    from bench import chain_seconds

    x = jax.random.normal(jax.random.PRNGKey(3), (m, n), jnp.float32)
    out = {}
    for name, dt in (('f32', jnp.float32), ('bf16', jnp.bfloat16)):
        xv = x.astype(dt)
        fn, ops = dm.rows_operand_form(m, n, dtype=dt)
        # 1/12 bounds lap3d's spectral radius: chained applies stay finite
        out['spmm_%s_ms' % name] = 1e3 * chain_seconds(
            lambda z: fn(ops, z).astype(dt) * jnp.asarray(1.0 / 12.0, dt),
            xv)
        pfn, pops = ch.device_rows_operands(
            m, n, dtype=np.dtype('float32'), stream_bf16=dt == jnp.bfloat16)
        out['chebyshev_%s_ms' % name] = 1e3 * chain_seconds(
            lambda z: pfn(pops, z) * np.float32(ch.lo), x, reps=20)
    return out


def traced(call, logdir):
    """One call of ``call`` under the profiler: its wall time and the
    reduced device activity, plus the names of every plane and line."""
    import jax
    from jax.profiler import ProfileData
    from raleigh_tpu.utils.profiling import device_activity, trace_file

    jax.profiler.start_trace(logdir)
    t0 = time.perf_counter()
    call()
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    prof = ProfileData.from_file(trace_file(logdir))
    lines = {p.name: sorted({ln.name for ln in p.lines})
             for p in prof.planes if p.name.startswith('/device:')}
    return {'wall_s': wall, 'devices': device_activity(prof, top=25),
            'lines': lines}


def run(shape=(100, 100, 128), which=4, tol=5e-5, degree=12, reps=3,
        out_dir=None):
    from raleigh_tpu.ops.spmm import DiaMatrix

    a, exact, ch, ch_bf16 = problem(shape, which, degree)

    def check(lmd, st, its):
        if st != 0 or lmd is None or len(lmd) < which:
            raise RuntimeError('status %s' % st)
        err = float(np.max(np.abs(np.sort(np.asarray(lmd))[:which] - exact)
                           / exact))
        if err > 1e-3:
            raise RuntimeError('eigenvalue error %.2e' % err)
        return {'iterations': its, 'max_rel_err': err}

    calls, m = variants(a, ch, ch_bf16, which, tol, check)
    result = {'n': a.shape[0], 'block': m, 'degree': degree,
              'runs': interleaved(calls, JaxSeconds(), reps)}
    result.update(apply_rates(ch, DiaMatrix(a), m, a.shape[0]))
    if out_dir:
        result['trace'] = traced(calls['hevp'],
                                 os.path.join(out_dir, 'trace_hevp'))
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--reps', type=int, default=3)
    parser.add_argument('--out', default=None,
                        help='directory for the trace and the JSON line')
    args = parser.parse_args(argv)

    import jax
    from raleigh_tpu.utils.env import use_compile_cache

    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        sys.exit('bench_lobpcg_hbm: no GPU (JAX default device is %r)'
                 % dev.platform)
    use_compile_cache()
    result = {'device': {'platform': dev.platform, 'kind': dev.device_kind,
                         'count': len(jax.devices())}}
    result.update(run(reps=args.reps, out_dir=args.out))
    line = json.dumps(result)
    if args.out:
        with open(os.path.join(args.out, 'bench_lobpcg_hbm.json'), 'w') as f:
            f.write(line + '\n')
    print(line, flush=True)


if __name__ == '__main__':
    main()
