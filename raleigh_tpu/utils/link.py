"""Host<->device link measurement and the orchestration decision.

The shift-invert iteration factorizes on the host (native LDL^T) but can
run its block algebra either host-side (NumPy backend) or device-side
(dense_jax Vectors, with the per-iteration solve block crossing the
link both ways).  Which is faster depends entirely on the link: on a
co-located accelerator the round trip is microseconds and the device
algebra wins; over a slow link (MB/s) one ~24 MB block round trip costs
seconds and the host algebra wins.  This module measures the link once
per process and decides from the numbers.
"""

import time

import numpy as np

_CACHE = None


def probe_link(nbytes=4 << 20, force=False):
    """One timed round trip to the default device: returns a dict with
    ``up_bytes_per_s``, ``down_bytes_per_s``, ``rtt_s`` and
    ``colocated`` (True for host-local platforms, where the transfer is
    a memcpy and orchestration should always stay on device buffers).
    Cached per process — production solves ask many times."""
    global _CACHE
    if _CACHE is not None and not force:
        return _CACHE
    import jax

    dev = jax.devices()[0]
    if dev.platform == 'cpu':
        _CACHE = dict(colocated=True, up_bytes_per_s=float('inf'),
                      down_bytes_per_s=float('inf'), rtt_s=0.0,
                      platform='cpu')
        return _CACHE
    # warm the dispatch path so the probe times the link, not the first
    # compile
    small = np.zeros((8,), np.float32)
    jax.device_get(jax.device_put(small, dev))
    t0 = time.time()
    jax.device_get(jax.device_put(small, dev))
    rtt = time.time() - t0
    buf = np.empty(nbytes // 4, np.float32)
    t0 = time.time()
    dbuf = jax.device_put(buf, dev)
    dbuf.block_until_ready()
    t_up = max(time.time() - t0 - rtt / 2, 1e-9)
    t0 = time.time()
    jax.device_get(dbuf)
    t_down = max(time.time() - t0 - rtt / 2, 1e-9)
    _CACHE = dict(colocated=False,
                  up_bytes_per_s=nbytes / t_up,
                  down_bytes_per_s=nbytes / t_down,
                  rtt_s=rtt, platform=dev.platform)
    return _CACHE


def choose_orchestration(n, block, itemsize=8, host_gflops=4.0):
    """'device' when moving the per-iteration solve block across the
    link costs less than the host block algebra it would replace, else
    'host'.

    Model: each iteration ships the solve's RHS and solution blocks
    (2 * n * block * itemsize bytes) plus ~4 synchronization round
    trips; the host-side block algebra it displaces is ~12 n block^2
    flops (Grams, orthogonalization, residuals) at ``host_gflops``.
    Over a link of a few MB/s this picks 'host' for any realistic
    problem; over PCIe (an H100 host) it picks 'device'.
    """
    link = probe_link()
    if link['colocated']:
        return 'device'
    bytes_per_iter = 2.0 * n * block * itemsize
    t_link = (bytes_per_iter / min(link['up_bytes_per_s'],
                                   link['down_bytes_per_s'])
              + 4.0 * link['rtt_s'])
    t_host = 12.0 * n * block * block / (host_gflops * 1e9)
    return 'host' if t_link > t_host else 'device'
