"""User-settable environment knobs and process set-up helpers.

Parity with reference raleigh/algebra/env.py:3 (`mkl_path`); here the knobs
select the path of the native LDL^T shared library and the complex
factorization route.
"""

import os

# If not None, path of the prebuilt native sparse-solver shared library.
native_lib_path = None

# Route complex Hermitian factorizations through the real-symmetric
# embedding (2x size) instead of the native LDL^H engine (debug fallback).
complex_via_embedding = False

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_compile_cache():
    """Enable JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to ``.xla_cache`` in
    the checkout that holds this package (listed in ``.gitignore``): a
    fixed path, so a later process of the same checkout finds it again."""
    env_dir = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env_dir:
        return env_dir
    import jax
    path = os.path.join(CHECKOUT, '.xla_cache')
    os.makedirs(path, exist_ok=True)
    jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.1)
    return path
