"""A persistent cache of the kernel libraries, port of
``repro/serving/compile_cache.py``.

The reference's cold start pays one XLA compilation per step variant
before its first request, and JAX's persistent cache keeps each
executable on disk, keyed by a hash of its program, so a restarted
process loads it instead.  The port compiles no step: its compiled code
is the hand-written kernels, each built by ``nvcc`` once into a library
keyed by a hash of its source and flags (``kernels/build.py``).  A
fresh machine pays those builds before its first tick.

``enable_persistent_cache`` routes every later build in this process to
``cache_dir``, so a restarted server finds its libraries there and loads
them without running ``nvcc``.  It is process-global and idempotent; the
entries are the libraries (``*.so``) in the directory.  ``max_bytes``
bounds the directory: ``trim_cache`` (which the engine calls after every
warmup) evicts the least recently used libraries, by ``max(atime,
mtime)`` (``kernels.build.load`` stamps a library's access time when it
loads it), until the rest fit.  A library this process has loaded stays
mapped after its file is evicted, so serving goes on.

Usage (the engine and ``launch/serve.py --cache-dir`` call this)::

    from repro_torch.serving.compile_cache import enable_persistent_cache
    enable_persistent_cache('/var/cache/repro-kernels')
    engine.warmup(precisions=('fp32', 'w8a8'))   # cold: nvcc, stores
    # ... restart the process ...
    engine.warmup(precisions=('fp32', 'w8a8'))   # warm: loads
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.kernels import build as _build

#: The directory routed through ``enable_persistent_cache`` in this
#: process, or None when the persistent cache is off.
_ACTIVE_DIR: Optional[str] = None

#: Size bound (bytes) of the active directory, or None for unbounded;
#: enforced by ``trim_cache``.
_MAX_BYTES: Optional[int] = None

#: Libraries evicted by the size bound in this process.
_EVICTED = 0

#: The reference's two thresholds, kept as given: no kernel library is
#: too small or too quick to build to be cached, so neither skips one.
_THRESHOLDS = {'min_entry_size_bytes': -1, 'min_compile_time_secs': 0.0}


def enable_persistent_cache(cache_dir: str,
                            min_entry_size_bytes: int = -1,
                            min_compile_time_secs: float = 0.0,
                            max_bytes: Optional[int] = None) -> str:
    """Build every kernel library into ``cache_dir`` (created if needed)
    from now on, and look for them there; returns its absolute path.
    Re-enabling the same directory without a bound keeps the bound it
    had.  ``max_bytes`` bounds the directory, enforced now and after
    every engine warmup (``trim_cache``)."""
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    global _ACTIVE_DIR, _MAX_BYTES
    _THRESHOLDS.update(min_entry_size_bytes=min_entry_size_bytes,
                       min_compile_time_secs=min_compile_time_secs)
    _build.set_cache_dir(cache_dir)
    if max_bytes is None and cache_dir == _ACTIVE_DIR:
        max_bytes = _MAX_BYTES
    _ACTIVE_DIR = cache_dir
    _MAX_BYTES = max_bytes
    if max_bytes is not None:
        trim_cache(cache_dir, max_bytes)
    return cache_dir


def disable_persistent_cache() -> None:
    """Build into ``kernels.build.BUILD_DIR`` again (tests use this so a
    temporary directory does not leak into later work)."""
    global _ACTIVE_DIR, _MAX_BYTES
    _build.set_cache_dir(None)
    _ACTIVE_DIR = None
    _MAX_BYTES = None


def _entry_files(d: str):
    """(path, size, last_use) of every library in ``d``; last use is
    ``max(atime, mtime)``: loads stamp the access time, and on a
    ``noatime`` mount the build order stands in for it."""
    out = []
    for name in os.listdir(d):
        path = os.path.join(d, name)
        if not name.endswith('.so') or not os.path.isfile(path):
            continue
        st = os.stat(path)
        out.append((path, st.st_size, max(st.st_atime, st.st_mtime)))
    return out


def trim_cache(cache_dir: Optional[str] = None,
               max_bytes: Optional[int] = None) -> int:
    """Evict the least recently used libraries of ``cache_dir`` (default:
    the active directory and its bound) until the rest fit in
    ``max_bytes``.  Returns the number evicted (also added to
    ``cache_evictions``); 0 when no bound is set."""
    global _EVICTED
    d = cache_dir or _ACTIVE_DIR
    budget = max_bytes if max_bytes is not None else _MAX_BYTES
    if d is None or budget is None or not os.path.isdir(d):
        return 0
    files = _entry_files(d)
    total = sum(size for _, size, _ in files)
    evicted = 0
    for path, size, _ in sorted(files, key=lambda f: f[2]):
        if total <= budget:
            break
        try:
            os.remove(path)
        except OSError:
            continue                # another process removed it first
        total -= size
        evicted += 1
    _EVICTED += evicted
    return evicted


def cache_evictions() -> int:
    """Libraries evicted by the size bound in this process."""
    return _EVICTED


def active_cache_dir() -> Optional[str]:
    """The directory enabled in this process, or None."""
    return _ACTIVE_DIR


def cache_entries(cache_dir: Optional[str] = None,
                  with_evictions: bool = False):
    """Number of libraries in ``cache_dir`` (default: the active
    directory); 0 when the cache is off or the directory is missing or
    empty.  ``with_evictions=True`` returns ``(entries, evicted)``."""
    d = cache_dir or _ACTIVE_DIR
    n = len(_entry_files(d)) if d is not None and os.path.isdir(d) else 0
    return (n, _EVICTED) if with_evictions else n
