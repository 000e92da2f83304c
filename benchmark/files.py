"""The benchmark's files found by name: a module
``benchmark/<kind>/<name>.py`` (an entry, a metric, an initial condition,
a check, a control) and a JSON data file."""

from __future__ import annotations

import importlib.util
import json
import os

HARNESS_DIR = os.path.dirname(os.path.abspath(__file__))

_MODULES: dict = {}


class BenchmarkError(Exception):
    """A run that cannot produce a result; the message says why."""


def load_module(path: str, name: str):
    """Imports the file ``path`` as a module named ``name``, once."""
    if path in _MODULES:
        return _MODULES[path]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise BenchmarkError(f"no file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    _MODULES[path] = module
    return module


def harness_module(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``."""
    return load_module(
        os.path.join(HARNESS_DIR, kind, f"{name}.py"),
        f"benchmark_{kind}_{name.replace('.', '_')}",
    )


def load_json(path: str) -> dict:
    if not os.path.exists(path):
        raise BenchmarkError(f"no file {path}")
    with open(path) as f:
        return json.load(f)
