"""Persistent XLA compilation cache.

Compiling the hierarchy's programs for the GPU takes seconds to minutes;
JAX's persistent cache makes a second run of the same programs start from
the compiled code.  Hierarchy setup enables it on the GPU (CPU compiles are
fast, and the tests run there).

Where the cache lives:
  * JAX_COMPILATION_CACHE_DIR, when set: JAX reads that variable itself, and
    this module sets nothing, so the cache is that directory as it is;
  * otherwise the fixed directory `<repo>/.jax_cache` of the checkout the
    package runs from (listed in .gitignore).  A fixed path matters: the
    cache is looked up by directory, so a directory that changes from run
    to run never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def compilation_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> None:
    """Point JAX's persistent cache at compilation_cache_dir() on the GPU."""
    import jax

    from mfmg_tpu import backend

    if not backend.is_gpu() or os.environ.get(ENV_VAR):
        return
    if jax.config.jax_compilation_cache_dir != DEFAULT_DIR:
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
