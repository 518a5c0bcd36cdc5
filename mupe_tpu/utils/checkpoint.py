"""Checkpoint / resume as NumPy `.npz` pytrees.

Fixes the reference's gaps (SURVEY §5.4): the reference saves only
{TP, critic, actor_params, value_normalizer} and silently rebuilds the
optimizer on load (learning/mappo.py:477-491).  Here two artifacts are
written per save (harness.train):

  * ``step_N.npz`` — the complete learner state (`MAPPOState`: params +
    optimizer states + value normalizer + TP), the `model_dir` warm-start
    target;
  * ``full/step_N.npz`` — the entire iteration carry: learner state, env
    state including curriculum scalars (``v_prey``, ``update_epoch``), the
    AEG `GenBufferState` and the PRNG key — the `resume_dir` target for
    exact resume (train → save → load → bit-identical continuation).

Each leaf is stored under its tree path, names joined by "/" (e.g.
``ts/actor_params/params/Dense_0/kernel``), so restoring matches leaves by
path and tolerates trees that grew fields since the save.
"""
from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def leaf_key(path) -> str:
    """Tree path → "a/b/0/c" (dict keys, attribute names, sequence indices)."""
    parts = []
    for p in path:
        if isinstance(p, jax.tree_util.DictKey):
            parts.append(str(p.key))
        elif isinstance(p, jax.tree_util.GetAttrKey):
            parts.append(p.name)
        elif isinstance(p, jax.tree_util.SequenceKey):
            parts.append(str(p.idx))
        else:
            parts.append(str(getattr(p, "key", p)))
    return "/".join(parts)


def _step_of(p: Path) -> int:
    return int(p.name[len("step_"):].split(".")[0])


def save_checkpoint(path: str | Path, step: int, payload: Any) -> None:
    """Write `payload` to `path/step_{step}.npz`.

    Every process must call this (multi-host arrays are gathered with
    `process_allgather`); process 0 writes, to a temporary name that is
    renamed into place, so a reader never sees a partial file."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        payload = multihost_utils.process_allgather(payload, tiled=True)
    leaves = jax.tree_util.tree_flatten_with_path(payload)[0]
    arrays = {leaf_key(p): np.asarray(leaf) for p, leaf in leaves}
    if jax.process_index() != 0:
        return
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    final = path / f"step_{step}.npz"
    tmp = path / f".step_{step}.{os.getpid()}.npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, final)


def _place(value: np.ndarray, like: Any) -> Any:
    """Put a restored array where the target leaf lives (sharding included;
    works for global arrays spanning several processes).  An uncommitted
    target leaf stays uncommitted, so it can still meet arrays placed on
    other devices inside one jitted call."""
    if isinstance(like, jax.Array):
        value = value.astype(like.dtype)
        if not like.committed:
            return jnp.asarray(value)
        return jax.make_array_from_callback(
            value.shape, like.sharding, lambda idx: value[idx]
        )
    return value


def load_checkpoint(path: str | Path, target: Any) -> Any:
    """Load the latest `step_*.npz` under `path` (or the file `path`) into
    the structure of `target`.

    Restore is schema-tolerant: leaves missing from the stored tree (fields
    added since the save) keep the target's values, with a warning."""
    path = Path(path).absolute()
    if path.name.startswith("step_"):
        latest = path if path.suffix == ".npz" else path.with_suffix(".npz")
    else:
        steps = sorted(path.glob("step_*.npz"), key=_step_of)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        latest = steps[-1]
    leaves, treedef = jax.tree_util.tree_flatten_with_path(target)
    out, missing = [], []
    with np.load(latest) as stored:
        for p, leaf in leaves:
            k = leaf_key(p)
            if k in stored.files:
                value = stored[k]
                if value.shape != np.shape(leaf):
                    raise ValueError(
                        f"checkpoint {latest}: {k} has shape {value.shape}, "
                        f"the target {np.shape(leaf)}"
                    )
                out.append(_place(value, leaf))
            else:
                missing.append(k)
                out.append(leaf)
    if len(missing) == len(leaves):
        raise ValueError(
            f"checkpoint {latest} shares no leaves with the restore target"
        )
    if missing:
        warnings.warn(
            f"checkpoint {latest} lacks {len(missing)} leaves "
            f"(kept target defaults): {missing[:8]}"
        )
    return jax.tree_util.tree_unflatten(treedef, out)
