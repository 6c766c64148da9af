"""Files by name, the result line, and small helpers every cell shares.

A cell is ``workloads/<cell>.json``: it names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``),
the end-to-end and per-layer metrics it reports, and the comparison
that decides ``correct`` (its limits).  The mix names the driver
(``harness/drivers/<driver>.py``) that runs the port under it.  A
per-layer metric ``<base>.<suffix>`` is read by ``metrics/<base>.<suffix>.py``
where that file exists, else by ``metrics/<base>.py``.  An LM configuration
names its model family (``harness/families/<family>.py``).  So a later
cell, configuration, mix, family or metric is a new file, and no file
here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent.parent      # h100bench/
ROOT = HERE.parent                                  # the checkout
#: kernel and compiler caches of this benchmark's runs: fixed paths inside
#: the checkout, so that only a checkout's first run builds
CACHE = ROOT / 'build' / 'h100bench'
#: what may not be loaded in the process that prints a result: the JAX
#: stack and the JAX package, compared by whole top-level names
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'repro')


def cache_env() -> None:
    """Point every build and kernel cache at the checkout, and keep
    libraries that could load JAX by themselves from doing so.  Runs
    before torch is imported."""
    os.environ.setdefault('TORCH_EXTENSIONS_DIR', str(CACHE / 'torch_extensions'))
    os.environ.setdefault('TRITON_CACHE_DIR', str(CACHE / 'triton'))
    os.environ.setdefault('CUDA_CACHE_PATH', str(CACHE / 'nv'))
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start time in clock
    ticks since boot against the uptime)."""
    with open('/proc/self/stat') as f:
        fields = f.read().rsplit(')', 1)[1].split()
    start_ticks = int(fields[19])           # field 22 of stat(5)
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf('SC_CLK_TCK')


def load_json(kind: str, name: str) -> Dict[str, Any]:
    path = HERE / kind / f'{name}.json'
    if not path.is_file():
        raise FileNotFoundError(f'no {kind[:-1]} named {name!r} ({path})')
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """Import a file by its path (metric names hold dots, so their readers
    are not importable by module name)."""
    name = name or 'h100bench_' + path.stem.replace('.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    """The reader of a per-layer metric: ``metrics/<name>.py``, else
    ``metrics/<base>.py`` for ``<base>.<suffix>``."""
    exact = HERE / 'metrics' / f'{name}.py'
    if exact.is_file():
        return load_module(exact)
    base = HERE / 'metrics' / f'{name.split(".", 1)[0]}.py'
    if base.is_file():
        return load_module(base)
    raise FileNotFoundError(f'no reader for the metric {name!r}')


def driver(name: str) -> ModuleType:
    return load_module(HERE / 'harness' / 'drivers' / f'{name}.py',
                       f'h100bench_driver_{name}')


def family(name: str) -> ModuleType:
    """An LM family's module (``harness/families/<name>.py``): what the LM
    drivers take from it is listed in ``families/dense.py``."""
    path = HERE / 'harness' / 'families' / f'{name}.py'
    if not path.is_file():
        raise FileNotFoundError(f'no model family named {name!r} ({path})')
    return load_module(path, 'h100bench_family_' + name.replace('-', '_'))


@dataclasses.dataclass
class Cell:
    """One cell, its files read: ``workload`` (the cell's own file),
    ``config`` and ``traffic`` (the files it names)."""
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]

    @classmethod
    def load(cls, name: str) -> 'Cell':
        w = load_json('workloads', name)
        return cls(name, w, load_json('configs', w['config']),
                   load_json('traffic', w['traffic']))

    def limit(self, check: str) -> float:
        return float(self.workload['limits'][check])


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit: ``value <=
    limit`` passes."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least a share ``q`` of the values at or below it.  Misses are
    ``inf`` and count like any other value."""
    if not values:
        return math.nan
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def forbidden_loaded() -> List[str]:
    """Top-level names in ``sys.modules`` that are ``FORBIDDEN``, compared
    whole (``repro_torch`` is not ``repro``)."""
    tops = {m.split('.', 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell, the run's arguments, the device
    (``cuda``, or ``cpu`` in the tests' small runs) and, for the
    calibration script, the precisions control references run at."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    #: controls the calibration script reads: name -> reference.numerics.Numerics
    controls: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Outcome:
    """What a driver returns.  ``end_to_end``: the cell's end-to-end
    values by name; ``layers``: what the per-layer readers read
    (``Layers``), for a traced run; ``checks``: the comparison with the
    reference; ``readings``: further numbers of the comparison (the
    control's among them) for the calibration script; ``notes``: lines
    for standard error."""
    setup_s: float
    end_to_end: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    layers: Any = None
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Layers:
    """The per-layer readers' input: the traced slice (``trace.Slice``),
    the work it ran (``roofline.work.Work``) and the driver's counts."""
    slice: Any
    work: Any
    counts: Dict[str, Any]
