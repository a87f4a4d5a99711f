"""Traffic kinds: the general generators that traffic files name.

A kind is a module here with a ``Runner(config, traffic, seed, device,
variant)`` that has ``setup()``, ``window(seconds) -> dict``, ``traced()``,
``answers()`` and ``release()``. A traffic file (``srbench/traffic/
<mix>.json``) names its kind under ``"kind"`` and holds its parameters.
"""

import contextlib
import importlib
import random
import sys
import time


def load(name: str):
    """The kind module ``srbench.kinds.<name>``."""
    return importlib.import_module(f"srbench.kinds.{name}")


@contextlib.contextmanager
def phase(name: str):
    """Time one step of a runner's set-up, to standard error."""
    t0 = time.perf_counter()
    yield
    print(f"setup {name}: {time.perf_counter() - t0:.3f} s", file=sys.stderr)


def sample(seed: int, stream: str, every: int, cap: int) -> set[int]:
    """The indices of the window's requests or batches whose answers are
    judged: seeded gaps of ``every`` on average (at least 1), ``cap`` of
    them."""
    from srbench.weights import derived_seed

    rng = random.Random(derived_seed(seed, stream))
    i, keep = rng.randrange(every), set()
    while len(keep) < cap:
        keep.add(i)
        i += rng.randint(max(1, every // 2), every + every // 2)
    return keep
