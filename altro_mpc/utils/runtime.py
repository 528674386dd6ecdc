"""Process setup shared by the entry points (bench.py, chip_smoke.py,
``altro_mpc.bench.drivers``): the persistent compile cache and the card
description printed beside every measurement. Library code and tests never
call these."""
from __future__ import annotations

import os
import subprocess

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> tuple:
    """(directory, from_env): ``JAX_COMPILATION_CACHE_DIR`` when it is set
    (JAX reads it itself), else ``<checkout>/.jax_cache`` — a fixed path,
    because the path is part of the cache key."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env, True
    return os.path.join(_CHECKOUT, ".jax_cache"), False


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory. With
    ``JAX_COMPILATION_CACHE_DIR`` set, nothing is changed."""
    import jax

    path, from_env = compile_cache_dir()
    if not from_env:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_description() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line
    (the limit bounds the clocks a card holds under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()
