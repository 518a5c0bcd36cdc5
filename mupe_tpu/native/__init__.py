"""Native host-side components (C++ via ctypes).

The compute path is pure JAX/XLA on the accelerator; the only work that
belongs on the host is branchy, sequential scene-generation bootstrap —
mirroring the reference, whose sole CPU-side algorithmic loop is the AEG
easy-case BFS (hideandseek_envgen.py:235-275).  `generate_easy_tasks` loads
`libmupe_native.so`, which `build.sh` compiles from `easy_tasks.cpp` on
first use (the library is not tracked by git); a pure-Python BFS fallback
keeps the framework functional where no C++ compiler is installed.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from collections import deque
from pathlib import Path
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = Path(__file__).parent / "libmupe_native.so"
    if not path.exists():
        # build under a private name, then rename: processes that build at
        # the same time (parallel test workers) never load a partial file
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(
                ["sh", str(path.parent / "build.sh"), str(tmp)],
                check=True,
                capture_output=True,
            )
        except (OSError, subprocess.CalledProcessError):
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.generate_easy_tasks.restype = ctypes.c_int
    lib.generate_easy_tasks.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_uint64,
    ]
    _LIB = lib
    return _LIB


def _inside(i: int, j: int, n: int) -> bool:
    r = n // 2
    return (i - r) ** 2 + (j - r) ** 2 < r * r


def _py_easy_tasks(num_tasks: int, n: int, num_agents: int, seed: int) -> np.ndarray:
    """Python fallback of the BFS generator (hideandseek_envgen.py:235-275)."""
    rng = np.random.default_rng(seed)
    free = [(i, j) for i in range(n) for j in range(n) if _inside(i, j, n)]
    out = np.zeros((num_tasks, num_agents + 1, 2), np.int32)
    for t in range(num_tasks):
        tx, ty = free[rng.integers(len(free))]
        visited = {(tx, ty)}
        queue = deque([(tx, ty)])
        found = []
        while queue and len(found) < num_agents:
            cx, cy = queue.popleft()
            for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                nx, ny = cx + dx, cy + dy
                if not (0 <= nx < n and 0 <= ny < n) or (nx, ny) in visited:
                    continue
                visited.add((nx, ny))
                if _inside(nx, ny, n):
                    found.append((nx, ny))
                    if len(found) == num_agents:
                        break
                queue.append((nx, ny))
        while len(found) < num_agents:
            found.append((tx, ty))
        out[t, :num_agents] = found
        out[t, num_agents] = (tx, ty)
    return out


def generate_easy_tasks(
    num_tasks: int, num_grid: int, num_agents: int, seed: int = 0
) -> np.ndarray:
    """→ [num_tasks, num_agents + 1, 2] int32 grid cells (pursuers…, evader)."""
    lib = _load()
    if lib is None:
        return _py_easy_tasks(num_tasks, num_grid, num_agents, seed)
    out = np.zeros((num_tasks, num_agents + 1, 2), np.int32)
    rc = lib.generate_easy_tasks(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        num_tasks,
        num_grid,
        num_agents,
        seed,
    )
    if rc != 0:
        raise RuntimeError(f"generate_easy_tasks failed with {rc}")
    return out
