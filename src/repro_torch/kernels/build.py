"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own with ``nvcc`` for ``sm_90a`` into ``build/<name>-<hash>.so`` at the
repository root, where the hash covers the source, the shared headers
``csrc/*.cuh`` and the flags: an
edited source builds anew, an unchanged one is loaded as it is.  All
sources compile in parallel, one ``nvcc`` each.  Nothing is built when
this module is imported, and nothing here runs without ``nvcc``, so the
CPU-only tests never reach it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build'
# no --use_fast_math: the epilogues must round as the plain versions do
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each fresh build
build_logs: Dict[str, str] = {}


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
    return BUILD_DIR / f'{name}-{digest[:16]}.so'


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all at once;
    return the library paths.  Raises with the compiler's output when a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
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
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]
