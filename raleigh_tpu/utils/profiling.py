"""Profiling helpers: per-phase wall timers and XLA device traces.

The reference keeps ad-hoc operator-time counters (e.g.
_OperatorSVD.time, reference interfaces/partial_svd.py:244-291); this
module generalizes that into a named-timer registry and adds
``jax.profiler`` trace capture for the device path.
"""

import contextlib
import time
from collections import defaultdict


class Timers:
    """Named accumulating wall timers."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name):
        start = time.time()
        try:
            yield
        finally:
            self.total[name] += time.time() - start
            self.count[name] += 1

    def report(self):
        lines = []
        for name in sorted(self.total, key=self.total.get, reverse=True):
            lines.append('%-28s %8.3f s  x%d'
                         % (name, self.total[name], self.count[name]))
        return '\n'.join(lines)


timers = Timers()


@contextlib.contextmanager
def device_trace(logdir='/tmp/raleigh_tpu_trace'):
    """Capture an XLA device trace viewable in TensorBoard/XProf."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def trace_file(logdir):
    """The newest ``.xplane.pb`` a ``jax.profiler`` trace wrote under
    ``logdir``."""
    import glob
    import os
    found = glob.glob(os.path.join(logdir, 'plugins', 'profile', '*',
                                   '*.xplane.pb'))
    if not found:
        raise FileNotFoundError('no .xplane.pb under %s' % logdir)
    return max(found, key=os.path.getmtime)


def device_activity(profile, top=15):
    """Reduce a ``jax.profiler.ProfileData`` to device time, per device
    plane ('/device:...'): ``busy_s``, the union of the intervals in
    which an operation runs on one of its stream lines ('Stream ...');
    ``span_s``, first start to last end on those lines; and ``ops``, the
    ``top`` operation names by summed device seconds, each as
    (name, seconds, count).  Divide ``busy_s`` by the host's wall time
    of the traced window for the busy share."""
    out = {}
    for plane in profile.planes:
        if not plane.name.startswith('/device:'):
            continue
        spans = []
        per_op = defaultdict(lambda: [0.0, 0])
        for line in plane.lines:
            if not line.name.startswith('Stream'):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_op[ev.name][0] += ev.duration_ns * 1e-9
                per_op[ev.name][1] += 1
        busy = 0.0
        end = None
        for lo, hi in sorted(spans):
            if end is None or lo > end:
                busy += hi - lo
                end = hi
            elif hi > end:
                busy += hi - end
                end = hi
        ops = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
        out[plane.name] = {
            'busy_s': busy * 1e-9,
            'span_s': (max(h for _, h in spans) - min(l for l, _ in spans))
            * 1e-9 if spans else 0.0,
            'events': len(spans),
            'ops': [(name, s, c) for name, (s, c) in ops]}
    return out


class TimedOperator:
    """Wrap any operator with an accumulated apply-time counter
    (parity with the reference's operator-time metric)."""

    def __init__(self, op, name='operator'):
        self.op = op
        self.name = name
        self.time = 0.0
        self.calls = 0

    def apply(self, x, y, **kw):
        start = time.time()
        self.op.apply(x, y, **kw)
        self.time += time.time() - start
        self.calls += 1

    def __getattr__(self, item):
        return getattr(self.op, item)
