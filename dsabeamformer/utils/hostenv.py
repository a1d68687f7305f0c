"""Host-environment helpers: the persistent compile cache and process
RSS reading (the memory-stability metric of the soak tests)."""

from __future__ import annotations

import os

__all__ = ["compile_cache_dir", "enable_compile_cache", "process_rss_mb"]

#: Where the compile cache lives when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset: a fixed directory in the checkout (listed in .gitignore).  The
#: path is part of the cache key, so it must not move between runs.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """The directory JAX's persistent compilation cache uses:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``DEFAULT_CACHE_DIR``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache, so repeated runs of a
    config skip the kernel compiles, and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it itself and
    nothing is set here."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def process_rss_mb() -> float:
    """This process's resident set size in MB (VmRSS — includes touched
    shared-memory ring pages, which is what the soak's host-RAM sizing
    claims are about)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0
