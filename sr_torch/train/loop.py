"""The epoch's dispatch loop: K-step dispatches, single-step remainder,
logging cadence.

Port of ``sr/train/loop.py`` with the same logic. The JAX loop threads a
PRNG key through its steps; here each step draws its batch from the train
state's ``torch.Generator``, which advances by one batch per step on
either path, so a run's batch stream does not depend on how its steps were
dispatched and the loop has no key to thread.
"""

from __future__ import annotations

from typing import Callable


def dispatch_epoch(
    spe: int,
    k: int,
    log_every: int,
    do_single: Callable[[], dict],
    do_multi: Callable[[], dict] | None,
    log: Callable[[dict], None],
) -> None:
    """Run one epoch of ``spe`` steps.

    ``do_multi() -> metrics`` advances k steps in one dispatch (None →
    always single); ``do_single() -> metrics`` advances one. ``log`` fires
    on the single-step cadence ``log_every`` (scaled up to k for K-step
    dispatches) and always at epoch end.
    """
    it = 0
    while it < spe:
        if do_multi is not None and spe - it >= k:
            metrics = do_multi()
            it += k
        else:
            metrics = do_single()
            it += 1
        if it % max(log_every, k) < k or it >= spe:
            log(metrics)
