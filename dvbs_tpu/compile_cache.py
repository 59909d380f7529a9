"""Persistent compilation cache location for the program's entry points.

Called by the entry points (cli.main, bench.py, chip_smoke.py,
__graft_entry__), never at library import.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable() -> str:
    """Use $JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it
    itself; nothing is set here); otherwise `<checkout>/.jax_cache`, a
    fixed path, so a later run of the same checkout finds what an
    earlier one compiled. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
