"""Headline benchmark: PCA throughput on an LFW-shaped problem, on one GPU.

Reference baseline (BASELINE.md): RALEIGH computes 800 principal components
of the 12,000 x 39,375 LFW eigenimages matrix in 23 s on CPU and 10 s on an
(unnamed) GPU; scikit-learn takes 59 s.  The LFW data itself is not
shipped, so the benchmark uses a synthetic matrix of the same shape whose
singular spectrum follows the k**-0.75 decay the reference's generator
uses to imitate LFW (reference examples/pca/generate_matrix.py:33-36),
generated on-device.

Engine: the device-resident subspace-iteration PCA
(raleigh_tpu/interfaces/randomized.py) — the whole computation is one
jitted XLA program, and its truncation error matches the optimal rank-800
approximation to three digits (see tests/test_randomized.py).  Set
RALEIGH_BENCH_ENGINE=jacobi to time the block Jacobi-CG engine instead
(per-vector convergence control, more host round-trips).

Runs in one process on JAX's default device, which must be a GPU: with
none the script exits non-zero.  It prints one JSON line on stdout
(narration goes to stderr) and exits non-zero when any field failed:
  {"metric": "pca_800_comps_time", "value": <seconds>, "unit": "s",
   "vs_baseline": <ref_gpu_time / ours>,
   "device": {"platform": ..., "kind": ..., "count": ...},
   "extra": {"lap3d50_shift_invert_s": ..., "dia_spmm_gnnz_per_s": ...,
             ...}}
"""

import json
import os
import subprocess
import sys
import time

M, N, NPC = 12000, 39375, 800
GEN_RANK = 2048
BASELINE_GPU_SECONDS = 10.0

def make_data():
    """Synthesize the benchmark matrix on device: low-rank factors with
    k**-0.75 singular decay plus a small dense tail, PCA-invariant leading
    direction, float32."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(1)
    ku, kv, kn = jax.random.split(key, 3)
    u = jax.random.normal(ku, (M, GEN_RANK), dtype=jnp.float32)
    u = u.at[:, 0].set(1.0)
    v = jax.random.normal(kv, (GEN_RANK, N), dtype=jnp.float32)
    k = jnp.arange(1, GEN_RANK + 1, dtype=jnp.float32)
    s = k ** -0.75
    a = (u * (s / jnp.sqrt(M * 1.0))) @ (v / jnp.sqrt(N * 1.0))
    # noise floor below the smallest generated singular value so all
    # GEN_RANK components stay meaningful (noise sigma ~ 1e-5*(sqrt(M)+
    # sqrt(N)) ~ 3e-3 < s_GEN_RANK)
    a = a + 1e-5 * jax.random.normal(kn, (M, N), dtype=jnp.float32)
    return jax.block_until_ready(a)


def _headline_pca(mark=lambda name: None):
    """The driver-recorded metric: seconds to 800 principal components of
    the LFW-shaped matrix (reference GPU: 10 s, reference README.md:31).

    ``mark(name)`` records a phase timestamp after each stage (data
    generation / warm-up compile / timed run)."""
    engine = os.environ.get('RALEIGH_BENCH_ENGINE', 'subspace')
    print('generating %dx%d benchmark matrix on device...' % (M, N),
          file=sys.stderr, flush=True)
    a = make_data()
    mark('data_ready')
    print('data ready; running %s PCA engine, npc=%d' % (engine, NPC),
          file=sys.stderr, flush=True)

    if engine == 'subspace':
        from raleigh_tpu.interfaces.randomized import subspace_pca

        # warm-up at full shape: compile (persistently cached) out of the
        # timed region, as a production service would
        subspace_pca(a, NPC, fetch=False, seed=2)
        mark('headline_warm')
        t0 = time.time()
        mean, trans, comps = subspace_pca(a, NPC, fetch=False)
        elapsed = time.time() - t0
    else:
        from raleigh_tpu.interfaces.pca import pca
        t0 = time.time()
        mean, trans, comps = pca(a, npc=NPC, arch='gpu')
        elapsed = time.time() - t0

    assert comps.shape[0] == NPC, comps.shape
    return a, (mean, trans, comps), elapsed


def _verify_pca(a, factors):
    """Post-metric quality check (stderr only)."""
    import jax.numpy as jnp
    import numpy as np

    mean, trans, comps = factors
    g = np.asarray(comps[:64] @ comps[:64].T)   # tiny fetch if on device
    ortho_err = float(np.abs(g - np.eye(64)).max())
    mean_r = jnp.asarray(mean).reshape(1, -1)
    as_norm2 = jnp.sum((a - mean_r) ** 2)
    lr_norm2 = jnp.sum(jnp.matmul(jnp.asarray(trans).T,
                                  jnp.asarray(trans)) *
                       jnp.matmul(jnp.asarray(comps),
                                  jnp.asarray(comps).T))
    cross = jnp.sum(jnp.matmul(jnp.asarray(trans).T, a - mean_r) *
                    jnp.asarray(comps))
    err2 = jnp.maximum(as_norm2 - 2 * cross + lr_norm2, 0.0)
    ef = float(jnp.sqrt(err2 / as_norm2))
    # sanity bound: the idealized spectrum (sigma_k ~ k^-0.75 with exactly
    # orthonormal factors) gives ef ~ 0.17; the Gaussian factors of the
    # actual generator spread the spectrum, and the measured optimum sits
    # near 0.20 (stable across engines/precisions/oversampling)
    print('verification: err_fro %.4f, ortho %.2e' % (ef, ortho_err),
          file=sys.stderr)
    if ortho_err > 1e-2:
        print('WARNING: component orthonormality error %.2e' % ortho_err,
              file=sys.stderr)
    if ef > 0.30:
        print('WARNING: approximation error %.3f above the expected band'
              ' (~0.20)' % ef, file=sys.stderr)


def _extra_sparse_evp():
    """Sparse flagship: lap3d 50^3 (n=125k), 10 smallest eigenvalues via
    shift-invert (native LDL^T factorization + block Jacobi-CG), wall
    clock.  Reference-class workload per BASELINE.md sparse table.

    The recorded number is the minimum of up to three runs — the
    low-noise estimate of what the code costs on a shared host — capped
    by a cumulative time budget."""
    import numpy as np
    from raleigh_tpu.examples.laplace import lap3d, lap3d_eigenvalues
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp

    a = lap3d(50, 50, 50, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(50, 50, 50, 1.0, 1.0, 1.0))[:10]
    best = None
    spent = 0.0
    for run in range(3):
        t0 = time.time()
        vals, _, status = partial_hevp(a, sigma=0.0, which=10, verb=-1)
        dt = time.time() - t0
        spent += dt
        if status != 0:
            raise RuntimeError('partial_hevp status %d' % status)
        if len(vals) < 10:
            raise RuntimeError('only %d eigenvalues returned' % len(vals))
        # the solver may return extra converged pairs beyond the 10
        # requested (reference semantics); compare the 10 smallest
        err = np.max(np.abs(np.sort(vals)[:10] - exact) / exact)
        if err > 1e-6:
            raise RuntimeError('lap3d eigenvalue error %.2e' % err)
        best = dt if best is None else min(best, dt)
        print('sparse evp run %d: %.2f s (best %.2f)' % (run, dt, best),
              file=sys.stderr, flush=True)
        if spent > 150.0:
            break
    return round(best, 3)


def _extra_sparse_evp_device():
    """The same flagship problem (lap3d 50^3, 10 smallest) on the fully
    device-resident engine: Chebyshev-preconditioned LOBPCG superkernel,
    in f64 (scoped x64; the card has f64).  In f32 this solve stagnates
    and stops at status 2: on an H100 at tol 1e-6, on the CPU backend at
    1e-6 and 1e-5 alike, with eigenvalue errors of 3.1e-5.  Warm
    methodology like the other device metrics: first call compiles
    (persistently cached), the recorded number is the min of two
    subsequent runs."""
    import jax
    import numpy as np
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds
    from raleigh_tpu.examples.laplace import lap3d, lap3d_eigenvalues
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp

    a = lap3d(50, 50, 50, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(50, 50, 50, 1.0, 1.0, 1.0))[:10]
    lo, hi = spectral_bounds(a)
    with jax.enable_x64(True):
        ch = Chebyshev(a, lo, hi, degree=16, arch='gpu')
    best = None
    for run in range(3):
        t0 = time.time()
        with jax.enable_x64(True):
            lmd, x, st = partial_hevp(a, T=ch, which=10, tol=1e-6,
                                      verb=-1, arch='gpu')
        dt = time.time() - t0
        if st != 0 or lmd is None or len(lmd) < 10:
            raise RuntimeError('device flagship status %s' % st)
        err = np.max(np.abs(np.sort(lmd)[:10] - exact) / exact)
        if err > 1e-5:
            raise RuntimeError('device flagship error %.2e' % err)
        if run > 0:                        # run 0 is the compile warm-up
            best = dt if best is None else min(best, dt)
        print('sparse evp device run %d: %.2f s' % (run, dt),
              file=sys.stderr, flush=True)
    return round(best, 3)


def chain_seconds(step, x, reps=100, repeats=3):
    """Device seconds per application of ``step``, chained ``reps`` times
    inside one jitted ``fori_loop`` (sustained kernel throughput, not
    dispatch latency): min over ``repeats`` warm runs."""
    import jax
    from jax import lax

    @jax.jit
    def chain(y):
        return lax.fori_loop(0, reps, lambda i, z: step(z), y)

    jax.block_until_ready(chain(x))
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best / reps


def _extra_dia_spmm(shape=(48, 48, 48), m=32):
    """DIA stencil SpMM sustained throughput on the device through
    ``DiaMatrix.matmat_rows`` (block width 32).  Returns (Gnnz/s,
    effective GB/s: per apply the kernel streams the diagonal values plus
    one operand and one result block).  The matrix is scaled by 1/12 so
    lap3d's spectral radius is at most 1 and the chained iterate stays
    finite.  The default lap3d 48^3 (~17 MB working set) is cache-sized;
    ``_extra_dia_spmm_hbm`` runs the HBM-resident n = 1.28e6 case."""
    import jax
    from raleigh_tpu.examples.laplace import lap3d
    from raleigh_tpu.ops.spmm import DiaMatrix

    d = DiaMatrix(lap3d(*shape, 1.0, 1.0, 1.0) * (1.0 / 12.0))
    n = d.shape[0]
    x = jax.random.normal(jax.random.PRNGKey(1), (m, n))
    out = []
    for dt in ('float32', 'bfloat16'):
        xv = x.astype(dt)
        t = chain_seconds(d.matmat_rows, xv)
        moved = len(d.offsets) * n * 4 + 2 * m * n * xv.dtype.itemsize
        out += [round(d.nnz / t / 1e9, 3), round(moved / t / 1e9, 1)]
    return out


def _extra_dia_spmm_hbm():
    """``_extra_dia_spmm`` at an HBM-resident size (lap3d 100x100x128,
    n = 1.28e6: the (32, n) operand alone is 164 MB), f32 and bf16
    operands, plus a plain device copy of the f32 operand (read + write,
    GB/s) as the rate the SpMM is judged against."""
    import jax
    import numpy as np

    out = _extra_dia_spmm(shape=(100, 100, 128))
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 1280000))
    t = chain_seconds(lambda z: z * np.float32(0.5), x)
    return out + [round(2 * x.size * 4 / t / 1e9, 1)]


def _extra_pca_tol(a):
    """Tolerance-driven device PCA (adaptive-rank subspace engine) on the
    full bench matrix.  The tolerance must sit above the matrix's
    achievable error floor (~0.20 relative Frobenius, see _verify_pca):
    an unachievable tol makes the growth loop escalate rank-cap-ward
    through ever-larger compiles and says nothing about the engine.  At
    0.25 the loop converges in one or two subspace sizes.  The rank cap
    stays as a second safety bound.

    Methodology matches the headline: one warm run compiles the (shape-
    bucketed, persistently cached) subspace programs out of the timed
    region, then the timed run measures what the engine costs in steady
    state.  Returns (timed seconds, warm-run seconds) — the warm number
    is recorded too so a cache-miss/compile stall stays visible."""
    import numpy as np
    from raleigh_tpu.interfaces.randomized import subspace_pca_tol

    def run():
        t0 = time.time()
        mean, trans, comps = subspace_pca_tol(a, 0.25, max_npc=1200,
                                              fetch=False)
        np.asarray(comps[0, :8])       # force completion
        return time.time() - t0

    warm = run()
    return round(run(), 3), round(warm, 3)


def _extra_pca_jacobi(a):
    """Reference-parity block Jacobi-CG PCA engine (per-vector
    convergence control) on a quarter-scale slice of the bench matrix.

    Warm methodology like the headline: one untimed call on a DIFFERENT
    data slice loads the engine's (shared, persistently cached) programs
    — proving no data is compiled in — then the timed call on the
    recorded slice measures the steady state a production service sees.
    Returns (timed seconds, warm seconds)."""
    import numpy as np
    from raleigh_tpu.interfaces.pca import pca

    warm_sub = np.asarray(a[:3000, 10000:20000])
    t0 = time.time()
    pca(warm_sub, npc=100, arch='gpu', method='jacobi')
    warm = time.time() - t0
    sub = np.asarray(a[:3000, :10000])
    best = None
    for _ in range(2):
        t0 = time.time()
        mean, trans, comps = pca(sub, npc=100, arch='gpu',
                                 method='jacobi')
        assert comps.shape[0] == 100
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    return round(best, 3), round(warm, 3)


def _eigsh_subprocess(script, timeout_s):
    """Run a scipy eigsh comparison in a subprocess under ``timeout``:
    eigsh cannot be interrupted in-thread, and a runaway ARPACK run must
    not eat the bench budget.  The child is host-only and must not open
    the card this process holds, so it runs with ``JAX_PLATFORMS=cpu``.
    Returns (seconds, False) on completion or (timeout, True) as a lower
    bound."""
    t0 = time.time()
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    try:
        proc = subprocess.run([sys.executable, '-c', script], env=env,
                              timeout=timeout_s, capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr.decode()[-300:])
        return round(time.time() - t0, 1), False
    except subprocess.TimeoutExpired:
        return round(timeout_s, 1), True


def _extra_fe_flagship(budget_left):
    """FE-class scattered-pattern flagship (VERDICT r4 #1): shift-invert
    on the synthetic shipsec-scale box-girder pencil (n~139k, 7.8M nnz,
    56/row — shipsec1's shape and density, reference README.md:19-25),
    vs scipy eigsh on the same pencil.  Host-side workload: native
    multifrontal LDL^T with the salted spectral-ND ordering competition.

    Returns (ours_min_s, eigsh_s, eigsh_is_lower_bound)."""
    import numpy as np
    from raleigh_tpu.examples.fe_model import shipsec_like
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp

    K, M_ = shipsec_like()
    best = None
    for run in range(2):
        t0 = time.time()
        lmd, x, st = partial_hevp(K, sigma=0, which=6, tol=1e-6, verb=-1)
        dt = time.time() - t0
        if st != 0 or lmd is None or len(lmd) < 6:
            raise RuntimeError('fe flagship status %s' % st)
        r = K @ x[:, :6] - x[:, :6] * lmd[None, :6]
        rel = np.abs(r).max() / 0.25        # ||K||_inf ~ 0.25
        if rel > 1e-5:
            raise RuntimeError('fe flagship residual %.1e' % rel)
        best = dt if best is None else min(best, dt)
        print('fe140k run %d: %.2f s' % (run, dt), file=sys.stderr,
              flush=True)
    eigsh_script = (
        'from raleigh_tpu.examples.fe_model import shipsec_like\n'
        'from scipy.sparse.linalg import eigsh\n'
        'K, M = shipsec_like()\n'
        'w = eigsh(K, k=6, sigma=0, which="LM",'
        ' return_eigenvectors=False)\n')
    tmo = max(60.0, min(12.0 * best, budget_left()))
    eig_t, lower = _eigsh_subprocess(eigsh_script, tmo)
    return round(best, 3), eig_t, lower


def _extra_buckling(budget_left):
    """FE-class buckling flagship: 3 smallest load factors of the
    K x = lmd G pencil on the ~74k-dof box girder vs scipy eigsh in
    buckling mode (reference panel_buckle class, README.md:22-25).
    Returns (ours_s, eigsh_s, eigsh_is_lower_bound)."""
    import numpy as np
    from raleigh_tpu.examples.fe_model import buckling_64k
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp

    K, G = buckling_64k()
    # sigma brackets the 3 critical load factors of this pencil (probed
    # inertia at -0.08: exactly 3 modes in (sigma, 0); the reference
    # convention computes every pair in the bracket).  Min of two runs:
    # run 2 reuses the pattern-cached ordering, the production regime
    # (PARDISO-style analyse/factorize split, buckling continuation)
    ours = None
    for run in range(2):
        t0 = time.time()
        lmd, x, st = partial_hevp(K, B=G, buckling=True, sigma=-0.08,
                                  which=3, tol=1e-5, verb=-1)
        dt = time.time() - t0
        if st < 0 or lmd is None or len(lmd) < 3:
            raise RuntimeError('buckling status %s' % st)
        ours = dt if ours is None else min(ours, dt)
        print('buckling64k run %d: %.2f s, load factors %s'
              % (run, dt, lmd[:3]), file=sys.stderr, flush=True)
    eigsh_script = (
        'from raleigh_tpu.examples.fe_model import buckling_64k\n'
        'from scipy.sparse.linalg import eigsh\n'
        'K, G = buckling_64k()\n'
        'w = eigsh(K, k=3, M=G, sigma=-0.08, mode="buckling",'
        ' which="SA", return_eigenvectors=False)\n')
    tmo = max(60.0, min(12.0 * ours, budget_left()))
    eig_t, lower = _eigsh_subprocess(eigsh_script, tmo)
    return round(ours, 3), eig_t, lower


def _extra_bsr_fe():
    """BSR tile-streaming SpMM on the FE flagship pattern (nodal 3x3
    blocks, scattered) — the HBM-scale engine for non-DIA structure
    (STATUS regime map).  Returns (Gnnz/s, physical GB/s of the tile
    stream)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from raleigh_tpu.examples.fe_model import shipsec_like
    from raleigh_tpu.ops.spmm import BsrMatrix, rows_matmat_operands

    # natural (mesher) node order: the locality a production numbering
    # gives a tiled layout — random relabeling is an ordering question
    # (feed BSR through a bandwidth-reducing permutation), not a kernel
    # property
    K = shipsec_like(which='k', relabel=False)
    # 128-tiles: fill 0.045, but far fewer and larger tile contractions
    # than 64-tiles
    bsr = BsrMatrix(K, bs=128)
    n = K.shape[0]
    m = 16
    fn, ops = rows_matmat_operands(bsr)
    x = jax.random.normal(jax.random.PRNGKey(2), (m, n), jnp.float32)
    scale = np.float32(1.0 / 4.0)
    dt = chain_seconds(lambda z: fn(ops, z) * scale, x, reps=50)
    gnnz = bsr.nnz / dt / 1e9
    tile_bytes = bsr.blocks.size * 4
    gbps = (tile_bytes + 2 * n * m * 4) / dt / 1e9
    return round(gnnz, 3), round(gbps, 1)


def _extra_lobpcg_hbm():
    """HBM-scale end-to-end: lap3d 100x100x128 (n=1.28e6), 4 smallest to
    5e-5 with a Chebyshev-preconditioned LOBPCG.  Warm methodology:
    run 0 compiles, recorded number is the min of two subsequent runs."""
    import numpy as np
    from raleigh_tpu.algebra.sparse import Chebyshev, spectral_bounds
    from raleigh_tpu.examples.laplace import lap3d, lap3d_eigenvalues
    from raleigh_tpu.interfaces.partial_hevp import partial_hevp

    a = lap3d(100, 100, 128, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(100, 100, 128, 1.0, 1.0, 1.0))[:4]
    lo, hi = spectral_bounds(a)
    ch = Chebyshev(a, lo, hi, degree=12, arch='gpu')
    best = None
    for run in range(3):
        t0 = time.time()
        lmd, x, st = partial_hevp(a, T=ch, which=4, tol=5e-5, verb=-1,
                                  arch='gpu')
        dt = time.time() - t0
        if st != 0 or lmd is None or len(lmd) < 4:
            raise RuntimeError('hbm lobpcg status %s' % st)
        err = np.max(np.abs(np.sort(lmd)[:4] - exact) / exact)
        if err > 1e-3:
            raise RuntimeError('hbm lobpcg error %.1e' % err)
        if run > 0:
            best = dt if best is None else min(best, dt)
        print('hbm lobpcg run %d: %.2f s' % (run, dt), file=sys.stderr,
              flush=True)
    return round(best, 3)


def _extra_link():
    """Measured host<->device link and the orchestration decision it
    drives (VERDICT r4 #5) at the flagship problem size."""
    from raleigh_tpu.utils.link import probe_link, choose_orchestration

    info = probe_link(force=True)
    out = {'link_rtt_ms': round(info['rtt_s'] * 1e3, 1)}
    if not info['colocated']:
        out['link_up_mb_s'] = round(info['up_bytes_per_s'] / 1e6, 1)
        out['link_down_mb_s'] = round(info['down_bytes_per_s'] / 1e6, 1)
    out['shift_invert_orchestration'] = choose_orchestration(125000, 32)
    return out


def main():
    import jax
    from raleigh_tpu.utils.env import use_compile_cache

    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        print('bench: no GPU (JAX default device is %r)' % dev.platform,
              file=sys.stderr)
        return 1
    use_compile_cache()
    t_start = time.time()
    phases = {}

    def mark(name):
        """Per-phase timestamps (seconds since start) recorded into the
        emitted JSON: the record itself shows which stage took the time."""
        phases[name] = round(time.time() - t_start, 1)

    a, factors, elapsed = _headline_pca(mark)
    mark('headline_done')
    result = {
        'metric': 'pca_800_comps_time',
        'value': round(elapsed, 3),
        'unit': 's',
        'vs_baseline': round(BASELINE_GPU_SECONDS / elapsed, 3),
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices())},
        'extra': {},
    }
    extra = result['extra']

    def pair(ours, eig, lower):
        return ours, ('>=%.0f' % eig) if lower else eig, round(eig / ours, 1)

    def eigsh_budget():
        return max(45.0, 840.0 - (time.time() - t_start))

    # (field names, producer): each producer runs once, in order; a
    # failure is recorded in its first field and fails the run
    fields = [
        (('lap3d50_shift_invert_s',), lambda: [_extra_sparse_evp()]),
        (('lap3d50_device_precond_s',),
         lambda: [_extra_sparse_evp_device()]),
        (('link',), lambda: [_extra_link()]),
        (('lobpcg_hbm_n1p28m_s',), lambda: [_extra_lobpcg_hbm()]),
        (('dia_spmm_gnnz_per_s', 'dia_spmm_gb_per_s',
          'dia_spmm_bf16_gnnz_per_s', 'dia_spmm_bf16_gb_per_s'),
         _extra_dia_spmm),
        (('dia_spmm_hbm_gnnz_per_s', 'dia_spmm_hbm_gb_per_s',
          'dia_spmm_hbm_bf16_gnnz_per_s', 'dia_spmm_hbm_bf16_gb_per_s',
          'copy_hbm_gb_per_s'), _extra_dia_spmm_hbm),
        (('pca_subspace_tol_s', 'pca_subspace_tol_warm_s'),
         lambda: _extra_pca_tol(a)),
        (('pca_jacobi_3000x10k_npc100_s',
          'pca_jacobi_3000x10k_npc100_warm_s'),
         lambda: _extra_pca_jacobi(a)),
        (('fe140k_shift_invert_s', 'fe140k_eigsh_s', 'fe140k_vs_eigsh'),
         lambda: pair(*_extra_fe_flagship(eigsh_budget))),
        (('buckling64k_s', 'buckling64k_eigsh_s', 'buckling64k_vs_eigsh'),
         lambda: pair(*_extra_buckling(eigsh_budget))),
        (('bsr_fe_gnnz_per_s', 'bsr_fe_gb_per_s'), _extra_bsr_fe),
    ]
    failed = False
    for names, produce in fields:
        try:
            extra.update(zip(names, produce()))
        except Exception as e:                          # noqa: BLE001
            extra[names[0]] = 'error: %s' % e
            failed = True
        mark(names[0])

    extra['phase_s'] = phases
    print(json.dumps(result), flush=True)
    _verify_pca(a, factors)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
