"""Run manifests: one JSON record of what a telemetry run ran under.

Counterpart of ``repro/obs/manifest.py``, with the same ``REQUIRED_KEYS``
so ``tools/check_telemetry.py`` accepts the port's run directories as
they are.  The port imports no jax: ``"jax"`` and ``"jaxlib"`` hold
``""``, and the manifest adds ``"torch"`` (``torch.__version__``),
``"cuda"`` (``torch.version.cuda``) and ``"device_name"``.
``"backend"`` is ``"cuda"`` when a card is present, else ``"cpu"``, and
``"device_count"`` is ``torch.cuda.device_count()``.  When a
``BENCH_sketch.json`` is reachable, its ``*.final_loss`` pins are
embedded, as the reference does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import sys
from typing import Any

import torch

# every manifest carries these (the contract of tools/check_telemetry.py)
REQUIRED_KEYS = ("kind", "run", "jax", "jaxlib", "backend", "device_count")


def _jsonable(x: Any) -> Any:
    """Configs (dataclasses, numpy or torch scalars, plain containers) as
    JSON values; anything else as its ``repr``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _jsonable(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if hasattr(x, "item") and getattr(x, "ndim", 1) == 0:
        return x.item()
    return repr(x)


def write_manifest(out_dir: str, *, run: str, config=None, mesh=None,
                   topology: str | None = None, sketch=None,
                   guard_pins: str | None = "BENCH_sketch.json",
                   extra: dict | None = None) -> str:
    """Write ``out_dir/manifest.json`` (atomically); returns its path.

    ``mesh`` maps axis names to sizes, ``sketch`` is a ``SketchConfig``,
    ``config`` any dataclass or dict of run parameters; ``guard_pins``
    names a ``BENCH_sketch.json`` whose ``*.final_loss`` keys are embedded
    when the file exists (``None`` skips it)."""
    cuda = torch.cuda.is_available()
    man: dict[str, Any] = {
        "kind": "manifest",
        "run": run,
        "jax": "",
        "jaxlib": "",
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count(),
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "python": platform.python_version(),
        "argv": list(sys.argv),
    }
    if topology is not None:
        man["topology"] = topology
    if mesh is not None:
        man["mesh"] = {str(a): int(n) for a, n in dict(mesh).items()}
    if sketch is not None:
        man["sketch"] = _jsonable(sketch)
    if config is not None:
        man["config"] = _jsonable(config)
    if guard_pins and os.path.exists(guard_pins):
        try:
            with open(guard_pins) as f:
                rows = json.load(f)
            pins = {k: v for k, v in rows.items()
                    if k.endswith(".final_loss")}
            if pins:
                man["guard_pins"] = pins
        except (OSError, json.JSONDecodeError, AttributeError):
            pass
    if extra:
        man.update(_jsonable(extra))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "manifest.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path
