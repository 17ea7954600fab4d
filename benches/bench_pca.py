"""PCA engine comparison: jacobi-CG (cpu/gpu), subspace (device-resident),
scikit-learn (BASELINE config 2: LFW-class 800-1100 components).

Usage:
    python benches/bench_pca.py [m] [n] [npc] [engines,comma,separated]

Prints one JSON line per engine.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))



def run(m=4000, n=6000, npc=300, engines=('jacobi-cpu', 'subspace',
                                          'sklearn')):
    from raleigh_tpu.examples.generate_matrix import generate
    from raleigh_tpu.interfaces.pca import pca, pca_error

    np.random.seed(1)
    A, *_ = generate(m, n, min(m, n) // 2, pca=True)

    for engine in engines:
        t0 = time.time()
        if engine == 'sklearn':
            try:
                from sklearn.decomposition import PCA as skPCA
            except ImportError:
                continue
            p = skPCA(n_components=npc)
            trans = p.fit_transform(A)
            comps = p.components_
            mean = p.mean_.reshape(1, -1)
        elif engine == 'subspace':
            mean, trans, comps = pca(A, npc=npc, method='subspace')
        elif engine == 'jacobi-gpu':
            # force the parity engine: arch='gpu' alone routes to
            # the subspace engine via method='auto'
            mean, trans, comps = pca(A, npc=npc, arch='gpu',
                                     method='jacobi')
        else:
            mean, trans, comps = pca(A, npc=npc, arch='cpu')
        dt = time.time() - t0
        em, ef = pca_error(A, mean, trans, comps)
        print(json.dumps({
            'metric': 'pca_time', 'engine': engine, 'm': m, 'n': n,
            'npc': npc, 'value': round(dt, 2), 'unit': 's',
            'err_max2': round(float(em), 4), 'err_fro': round(float(ef), 4),
        }))


if __name__ == '__main__':
    a = sys.argv[1:]
    nums = [int(x) for x in a[:3]]
    engines = a[3].split(',') if len(a) > 3 else ('jacobi-cpu', 'subspace',
                                                  'sklearn')
    run(*nums, engines=engines) if nums else run(engines=engines)
