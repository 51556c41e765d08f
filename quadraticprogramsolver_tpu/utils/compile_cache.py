"""JAX's persistent compilation cache, set up in one place.

Scripts that compile large programs (``chip_smoke.py``, ``bench.py``, the
examples and benchmarks) call :func:`enable_compile_cache` before their
first compilation, so a second run of the same code skips compiling.
"""

from __future__ import annotations

import os

#: Default cache directory: ``.jax_cache/`` at the root of the checkout
#: (git-ignored). The path is fixed because it is part of what a later run
#: must find again — never a temporary name, a process id or the time.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is used and
    no other is set in code; otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
