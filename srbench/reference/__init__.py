"""Plain float32 references of the benchmark's models, one module each,
found by the ``reference`` key of a configuration file."""

import importlib


def load(name: str):
    """The reference module ``srbench.reference.<name>``."""
    return importlib.import_module(f"srbench.reference.{name}")
