"""Observability & failure detection: profiling, NaN guards, watchdog.

The reference's debugging affordances are minimal (SURVEY §5.1-5.3):
rollout FPS timing, ad-hoc `nan_to_num` calls, an optional NaN assert on
drone state (multirotor.py:631-632), and nothing for failure recovery.
Here the equivalents are first-class:

- `profile_trace`: context manager around `jax.profiler` for device traces.
- `check_finite`: jittable finite-check over a pytree → bool + per-leaf
  report (the `check_nan` path, made structured).
- `guard_train_iter`: wraps a train iteration; if any metric goes
  non-finite it restores the last good carry instead of corrupting the run
  (simple single-host failure recovery the reference lacks).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a jax.profiler trace for the enclosed block (§5.1)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def check_finite(tree: Any) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """(all_finite, {leaf_path: finite?}) — jit-safe."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    report = {}
    oks = []
    for path, leaf in leaves:
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            ok = jnp.all(jnp.isfinite(leaf))
            report[jax.tree_util.keystr(path)] = ok
            oks.append(ok)
    all_ok = jnp.all(jnp.stack(oks)) if oks else jnp.asarray(True)
    return all_ok, report


def guard_train_iter(
    train_iter: Callable, metric_key: str = "policy_loss"
) -> Callable:
    """Failure-detection wrapper: host-side check of one scalar metric per
    iteration; on non-finite, return the previous carry (skip the bad
    update) and flag it.  Use outside jit: the check costs one scalar sync.
    """

    def wrapped(carry, *args):
        new_carry, metrics, stats = train_iter(carry, *args)
        bad = not bool(jnp.isfinite(metrics[metric_key]))
        if bad:
            return carry, metrics, {**stats, "nan_skipped": jnp.asarray(1.0)}
        return new_carry, metrics, stats

    return wrapped


class StallWatchdog:
    """Wall-clock watchdog for device hangs (a stuck collective or device):
    call `tick()` per iteration; `stalled()` reports if no tick within
    `timeout_s` — callers can checkpoint + abort instead of hanging CI."""

    def __init__(self, timeout_s: float = 600.0):
        self.timeout_s = timeout_s
        self._last = time.time()

    def tick(self) -> None:
        self._last = time.time()

    def stalled(self) -> bool:
        return (time.time() - self._last) > self.timeout_s
