"""The plain references, one module a model family, found by the `family`
that a configuration file names (`reference/<family>.py`)."""

from __future__ import annotations

import importlib
import re


def family(name: str):
    """The reference module of the family `name`."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise FileNotFoundError(f"no reference for the family {name!r}")
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        raise FileNotFoundError(f"no reference for the family {name!r}: "
                                f"benchmarks/reference/{name}.py does not exist") from e
