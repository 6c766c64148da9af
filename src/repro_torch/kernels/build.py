"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own with ``nvcc`` for ``sm_90a`` into ``<dir>/<name>-<hash>.so``, where
the hash covers the source, the shared headers ``csrc/*.cuh`` and the
flags: an edited source builds anew, an unchanged one is loaded as it
is.  ``<dir>`` is the persistent cache directory when one is enabled
(``serving/compile_cache.py``, ``set_cache_dir``), else ``build/`` at
the repository root.  All sources compile in parallel, one ``nvcc``
each.  ``counts`` tallies the ``nvcc`` runs and the libraries loaded in
this process, so a warm start can be seen to compile nothing.  Nothing
is built when this module is imported, and nothing here runs without
``nvcc``, so the CPU-only tests never reach it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build'
# no --use_fast_math: the epilogues must round as the plain versions do
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each fresh build
build_logs: Dict[str, str] = {}
#: ``nvcc`` runs and libraries loaded in this process
counts: Dict[str, int] = {'nvcc': 0, 'loads': 0}
_cache_dir: Optional[Path] = None


def set_cache_dir(path) -> None:
    """Build into ``path`` from now on (None: back to ``BUILD_DIR``).
    Libraries already loaded stay loaded."""
    global _cache_dir
    _cache_dir = None if path is None else Path(path)


def build_dir() -> Path:
    """Where libraries are built and looked for."""
    return _cache_dir if _cache_dir is not None else BUILD_DIR


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = Path(home) / 'bin' / 'nvcc'
    if not path.exists():
        raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                           'machine with the CUDA toolkit')
    return str(path)


def _target(name: str) -> Path:
    # every source includes the shared headers, so they are hashed too
    src = (CSRC / f'{name}.cu').read_bytes() + b''.join(
        h.read_bytes() for h in sorted(CSRC.glob('*.cuh')))
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f'{name}-{digest[:16]}.so'


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all at once;
    return the library paths.  Raises with the compiler's output when a
    build fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        # a hidden name until it is whole: not a library of the cache yet
        fd, tmp = tempfile.mkstemp(prefix=f'.{name}-', suffix='.tmp',
                                   dir=target.parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
        counts['nvcc'] += 1
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f'--- {name} ---\n{log}')
        else:
            os.replace(tmp, targets[name])   # atomic: no half-written .so
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    Loading stamps the file's access time, the use a size-bounded cache
    evicts by (``compile_cache.trim_cache``); the mapping outlives the
    file, so an evicted library stays usable in this process."""
    if name not in _loaded:
        path = build([name])[name]
        _loaded[name] = ctypes.CDLL(str(path))
        os.utime(path, (time.time(), path.stat().st_mtime))
        counts['loads'] += 1
    return _loaded[name]
