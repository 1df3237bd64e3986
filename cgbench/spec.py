"""A cell as ``BENCHMARK.json`` and the data files name it.

A cell names a configuration (``configs/<config>.json``, through the
manifest's ``file``) and a traffic mix (``workloads/<traffic>.json``);
its compared numbers and their limits are ``checks/<cell>.json``; each
metric is read by ``metrics/<metric>.py`` (``metrics/<base>.py`` for a
suffixed name ``<base>.<suffix>`` that has no reader of its own).  Adding a cell, a
configuration, a mix or a metric adds files and edits none.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"


@functools.lru_cache(maxsize=None)
def _reader(path: Path):
    """The ``read`` function of the reader file ``path``, loaded once."""
    mod_spec = importlib.util.spec_from_file_location(
        "cgbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    workloads: tuple | None   # the cells that report it (None: all)
    root: Path = HERE         # the benchmark's folder (metrics/ in it)

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads

    @property
    def reader(self) -> Path:
        """``metrics/<name>.py``; a name with a suffix (``.np4``,
        ``.rtol``: the same quantity under a bound or a ``moves`` of its
        own) falls back to the reader of the name before its first dot."""
        own = self.root / "metrics" / f"{self.name}.py"
        if own.is_file():
            return own
        return self.root / "metrics" / f"{self.name.split('.', 1)[0]}.py"

    def read(self, run):
        """The metric's value in ``run`` (a :class:`cgbench.harness.Run`),
        or None when its reader finds nothing to read."""
        return _reader(self.reader)(run)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict             # compared number -> {"limit": ...}
    end_to_end: tuple = ()   # Metrics this cell reports with --trace 0
    per_layer: tuple = ()    # and with --trace 1


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


# the fields the one generator reads (and ``rhs_seed``, where a mix draws
# its pool of right-hand sides from a fixed seed instead of the run's):
# a mix that names another is refused, not run as something it is not
MIX_KEYS = {"name", "rhs_pool", "iterations", "rtol", "ranks",
            "slice_solves"}


def check_traffic(traffic: dict) -> dict:
    unknown = sorted(set(traffic) - MIX_KEYS - {"rhs_seed"})
    missing = sorted(MIX_KEYS - set(traffic))
    if unknown or missing:
        raise ValueError(f"traffic {traffic.get('name')!r}: the generator "
                         f"does not read {unknown} and needs {missing}")
    return traffic


def _metrics(entries, cell: str, root: Path) -> tuple:
    out = []
    for m in entries:
        w = m.get("workloads")
        metric = Metric(m["name"], m["unit"], tuple(w) if w else None, root)
        if metric.applies(cell):
            out.append(metric)
    return tuple(out)


def load_cell(name: str, manifest: Path = MANIFEST, root: Path = HERE) -> Cell:
    """The cell ``name`` of the manifest, with its files read from the
    benchmark's folder ``root``."""
    doc = _json(manifest)
    cells = {w["name"]: w for w in doc["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {manifest.name} "
                       f"(have {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in doc["configs"]}
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(manifest.parent / configs[w["config"]]["file"]),
                traffic=check_traffic(
                    _json(root / "workloads" / f"{w['traffic']}.json")),
                checks=_json(root / "checks" / f"{name}.json"),
                end_to_end=_metrics(doc["end_to_end"], name, root),
                per_layer=_metrics(doc["per_layer"], name, root))
