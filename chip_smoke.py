#!/usr/bin/env python
"""On-card smoke test of the training main path, in one process.

    python chip_smoke.py              # one GPU: phases 1-4
    python chip_smoke.py --devices 4  # four GPUs: the data-parallel phase only

1. device  — fails unless JAX's default backend is the GPU; prints the
             card (nvidia-smi name and power limit), device kind and count.
2. train   — `harness.train` (the `scripts/train.py` entry) on HideAndSeek
             at the flagship size, every logged loss finite, the final
             checkpoint reloaded into the carry; then the AEG task through
             the `scripts/train_generator.py` entry with its task buffer
             and farthest-point sampling exercised.
3. parity  — one PPO minibatch (16,384 rows × 3 agents) through the
             encoder+head loss and its gradients, and the TP-net loss and
             gradient over the update's window batch, on the card (bf16
             trunks) vs the same functions in float32 on the CPU at
             `highest` matmul precision; plus their XLA times on the card.
4. hover   — the fixed-seed 100-step Hover rollout of
             tests/test_trajectory_regression.py vs its golden file.

`--devices 4` runs HideAndSeek MAPPO iterations with 4 × 4096 arenas sharded
over the cards and compares them with the same iteration on one card.

Any failure exits non-zero before the last line, which is the JSON object
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import copy
import csv
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# the CPU reference runs in this process beside the card, so keep the CPU
# backend available when the platform list is pinned
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def flagship(num_envs: int = 4096) -> list:
    """Flagship HideAndSeek MAPPO overrides (cfg/task/HideAndSeek.yaml +
    cfg/algo/mappo.yaml at 4096 arenas): 3 pursuers, random cylinders,
    TP net, 800-step episodes, 64-step rollouts."""
    return [
        f"env.num_envs={num_envs}",
        "env.num_agents=3",
        "env.use_random_cylinder=true",
        "env.use_tp_net=true",
        "env.max_episode_length=800",
        "algo.train_every=64",
    ]

# Tolerances (card, bf16 trunks, vs CPU float32 at `highest`):
# - outputs: bf16 keeps 8 significant bits (rel. rounding 2^-9 ≈ 2e-3);
#   about six dependent rounded matmuls per output → relative error ≤ 2e-2.
# - gradients: the backward pass rounds as often again, and
#   near-cancelling sums (LayerNorm, softmax) amplify relative error →
#   relative norm error ≤ 5e-2 per leaf, with an absolute floor of 1e-3 of
#   the whole gradient's norm for leaves whose true gradient is ~0 (the
#   attention key bias: softmax is shift-invariant).
OUT_RTOL = 2e-2
GRAD_RTOL = 5e-2
GRAD_FLOOR = 1e-3
# Hover: float32 state, 100 controlled steps; the card fuses and contracts
# multiply-adds (FMA) differently from the CPU, so the last bits differ
# and feedback carries them forward.  1e-4 m / 1e-4 is ~1000 float32
# ulps at these magnitudes, far below any controller or integrator change.
HOVER_ATOL = 1e-4
# --devices 4: the same iteration on 4 cards vs 1.  The programs differ in
# the order of cross-device sums and in per-device shapes (XLA picks other
# bf16 kernels), so values differ in the last bits.
# - Metrics fixed before the first optimizer step (the rollout, GAE, the
#   value normalizer, the TP loss at its initial params): ≤ 1e-3 rel.
# - Metrics averaged over the 64 sequential Adam steps: Adam normalizes
#   each coordinate, so a last-bit difference in a near-zero gradient
#   coordinate becomes a full ±lr step, and a fresh critic head (init
#   scale 0.01, 64 steps of lr 5e-4) is moved mostly by such steps; its
#   gradient norm drifted 4.9% apart on the card (H100 80GB HBM3, 400 W).
#   ≤ 25% rel still catches a missing or doubled cross-device reduction,
#   which moves a gradient norm by ~2x.
MULTI_PRE_OPT = ("advantages_mean", "advantages_std", "value_running_mean",
                 "action_norm", "TP_loss")
MULTI_PRE_RTOL = 1e-3
MULTI_CHAIN_RTOL = 0.25
MULTI_ATOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    log(f"== {name}")


# ----------------------------------------------------------------- device
def check_device(n_devices: int):
    if jax.default_backend() != "gpu":
        sys.exit(f"no GPU: JAX's default backend is {jax.default_backend()!r}")
    devs = jax.devices()
    if len(devs) < n_devices:
        sys.exit(f"need {n_devices} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"device_kind={devs[0].device_kind} count={len(devs)} jax={jax.__version__}")
    return devs


def _import_program():
    """The program next to this script — never another copy on sys.path."""
    sys.path.insert(0, str(REPO))
    import mupe_tpu

    if Path(mupe_tpu.__file__).resolve().parent.parent != REPO:
        sys.exit(f"mupe_tpu is not beside {__file__}")


# ------------------------------------------------------------------ train
def _finite_losses(metrics_csv: Path, required) -> int:
    with open(metrics_csv) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise AssertionError(f"{metrics_csv}: no logged rows")
    for key in required:
        if key not in rows[0]:
            raise AssertionError(f"{metrics_csv}: {key} was not logged")
    loss_keys = [k for k in rows[0] if k.endswith("_loss")]
    for i, row in enumerate(rows):
        for k in loss_keys:
            if not math.isfinite(float(row[k])):
                raise AssertionError(f"iteration {i}: {k}={row[k]}")
    log("  " + " | ".join(
        f"it{i} " + " ".join(f"{k}={float(r[k]):.4g}" for k in loss_keys)
        for i, r in enumerate(rows)
    ))
    return len(rows)


def _reload(run_dir: Path, task: str, argv, num_iters: int):
    """Load the final full-carry checkpoint into a freshly built carry."""
    import warnings

    from mupe_tpu.harness import build
    from mupe_tpu.learning import init_carry
    from mupe_tpu.utils.checkpoint import leaf_key, load_checkpoint
    from mupe_tpu.utils.config import parse_cli

    sections, _ = parse_cli(argv)
    env, policy, _, _ = build(task, sections.get("env"), sections.get("algo"))
    fresh = init_carry(env, policy, jax.random.PRNGKey(0))
    ckpt = run_dir / "checkpoints" / "full" / f"step_{num_iters}.npz"
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a missing leaf is a failure here
        carry = load_checkpoint(ckpt, target=fresh)
    stored = np.load(ckpt)
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(carry)[0]:
        key = leaf_key(path)
        np.testing.assert_array_equal(np.asarray(leaf), stored[key], err_msg=key)
        n += 1
    log(f"  reloaded {ckpt.name}: {n} leaves equal to the file")
    return fresh, carry


def train_phase(tmp: Path, num_envs: int = 4096):
    """Returns the trained learner state."""
    from mupe_tpu.harness import train

    phase("train: HideAndSeek MAPPO (scripts/train.py entry)")
    iters = 3
    argv = flagship(num_envs) + [
        f"max_iters={iters}", "log_interval=1", "save_interval=-1",
        f"run_dir={tmp}", "run_name=hideandseek",
    ]
    t0 = time.time()
    train(argv, default_task="HideAndSeek")
    log(f"  {iters} iterations in {time.time() - t0:.1f} s (compilation included)")
    run = tmp / "hideandseek"
    n = _finite_losses(
        run / "metrics.csv", ("policy_loss", "value_loss", "TP_loss")
    )
    assert n == iters, n
    fresh, carry = _reload(run, "HideAndSeek", argv, iters)
    trained = jax.tree_util.tree_leaves(carry.ts.actor_params)
    init = jax.tree_util.tree_leaves(fresh.ts.actor_params)
    assert any(not np.array_equal(a, b) for a, b in zip(trained, init))

    phase("train: HideAndSeek_envgen (scripts/train_generator.py entry)")
    # short episodes, one episode per eval cycle, the easy-case bootstrap
    # (history full from the start) and r ∈ [0, 1] (every task kept): each
    # episode end then inserts into a full buffer, so the update takes the
    # farthest-point-sampling branch
    gen_iters = 2
    gen_argv = [
        f"env.num_envs={num_envs}", "env.max_episode_length=32", "env.eval_iter=1",
        "env.use_init_easy_cases=true", "env.r_min=0.0", "env.r_max=1.0",
        "algo.train_every=64", f"max_iters={gen_iters}", "log_interval=1",
        "save_interval=-1", f"run_dir={tmp}", "run_name=envgen",
    ]
    t0 = time.time()
    train(gen_argv, default_task="HideAndSeek_envgen")
    log(f"  {gen_iters} iterations in {time.time() - t0:.1f} s (compilation included)")
    _finite_losses(tmp / "envgen" / "metrics.csv", ("policy_loss", "TP_loss"))
    gen_fresh, gen_carry = _reload(
        tmp / "envgen", "HideAndSeek_envgen", gen_argv, gen_iters
    )
    g0, g1 = gen_fresh.env_state.gen, gen_carry.env_state.gen
    cap = g0.history.shape[0]
    assert int(g1.history_len) == cap, int(g1.history_len)
    assert not np.array_equal(np.asarray(g0.history), np.asarray(g1.history))
    log(f"  task buffer: {cap} tasks, rewritten by FPS-downsampled updates")
    return carry.ts


# ----------------------------------------------------------------- parity
def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _compare_grads(name, g, g_ref):
    leaves = jax.tree_util.tree_leaves(g)
    ref_leaves = jax.tree_util.tree_leaves(g_ref)
    total = math.sqrt(sum(float(np.sum(np.square(np.asarray(r, np.float64)))) for r in ref_leaves))
    worst = 0.0
    for a, b in zip(leaves, ref_leaves):
        err = float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)))
        bound = GRAD_RTOL * float(np.linalg.norm(np.asarray(b, np.float64))) + GRAD_FLOOR * total
        worst = max(worst, err / bound if bound > 0 else 0.0)
    log(f"  {name}: global rel norm err {_rel_tree(g, g_ref):.3e}; worst leaf at "
        f"{worst:.3f} of its bound ({GRAD_RTOL} rel + {GRAD_FLOOR} x |g|)")
    assert worst <= 1.0, f"{name} gradient outside tolerance"


def _rel_tree(a, b) -> float:
    la = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in jax.tree_util.tree_leaves(a)])
    lb = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in jax.tree_util.tree_leaves(b)])
    return _rel(la, lb)


def _time(fn, *args, reps: int = 3, calls: int = 10):
    """Median ms per call over `reps` windows of `calls` calls, plus the
    spread (max − min of the windows)."""
    jax.block_until_ready(fn(*args))
    windows = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        windows.append((time.perf_counter() - t0) / calls * 1e3)
    return float(np.median(windows)), float(max(windows) - min(windows))


def parity_phase(ts, rows: int = 16384, envs: int = 4096, train_every: int = 64,
                 time_it: bool = True):
    from mupe_tpu.harness import build
    from mupe_tpu.learning.mappo import compute_pack_meta

    phase(f"parity: update math at {rows} rows x 3 agents, card vs CPU float32")
    env, policy, env_cfg, cfg = build("HideAndSeek", {"num_envs": "8"}, {})
    obs, _ = jax.jit(env.observe_full)(env.reset(jax.random.PRNGKey(0)), ts.tp_params)
    meta = compute_pack_meta(obs, policy.n_agents, policy.action_dim)
    s = rows * meta.n_agents
    rng = np.random.default_rng(0)
    f32 = np.float32
    mb = {
        "obs_rows": rng.normal(size=(s, meta.obs_dim)).astype(f32),
        "action": (0.5 * rng.normal(size=(s, meta.action_dim))).astype(f32),
        "logp": (-5.5 + 0.2 * rng.normal(size=s)).astype(f32),
        "advantages": rng.normal(size=s).astype(f32),
        "value": (0.3 * rng.normal(size=s)).astype(f32),
        "returns": (0.3 * rng.normal(size=s)).astype(f32),
    }
    ref_policy = copy.copy(policy)
    ref_policy.cfg = dataclasses.replace(cfg, compute_dtype="float32")
    params = (ts.actor_params, ts.critic_params)
    coef = jnp.float32(cfg.entropy_coef)

    def fwd(pol, p, rows_):
        return pol._fused_pair_apply_rows(p[0], p[1], rows_, meta)

    def vg(pol, p, mb_):
        return jax.value_and_grad(pol.joint_loss, has_aux=True)(p, mb_, meta, coef)

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    on_gpu = jax.device_put((params, mb), gpu)
    out = jax.jit(lambda p, m: fwd(policy, p, m["obs_rows"]))(*on_gpu)
    (loss, aux), grads = jax.jit(lambda p, m: vg(policy, p, m))(*on_gpu)
    on_cpu = jax.device_put((params, mb), cpu)
    with jax.default_matmul_precision("highest"):
        out_ref = jax.jit(lambda p, m: fwd(ref_policy, p, m["obs_rows"]))(*on_cpu)
        (loss_r, aux_r), grads_r = jax.jit(lambda p, m: vg(ref_policy, p, m))(*on_cpu)
    for name, a, b in (("action mean", out[0], out_ref[0]), ("value", out[1], out_ref[1])):
        r = _rel(a, b)
        log(f"  {name}: rel err {r:.3e} (tol {OUT_RTOL})")
        assert r <= OUT_RTOL, name
    for name, a, b in (
        ("total loss", loss, loss_r), ("policy_loss", aux[0], aux_r[0]),
        ("value_loss", aux[3], aux_r[3]),
    ):
        r = abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)
        log(f"  {name}: card {float(a):.6g} cpu {float(b):.6g} rel err {r:.3e} (tol {OUT_RTOL})")
        assert r <= OUT_RTOL, name
    _compare_grads("actor+critic grads", grads, grads_r)

    # TP net over the update's windows: (train_every − w) windows per arena
    n_win = (train_every - cfg.future_prediction_step) * envs
    log(f"  TP windows: {n_win} x {env_cfg.history_step} x {env_cfg.tp_input_dim}")
    tp_in = rng.normal(size=(n_win, env_cfg.history_step, env_cfg.tp_input_dim)).astype(f32)
    w_shape = (train_every - cfg.future_prediction_step, envs)
    tgt = rng.uniform(-1, 1, size=w_shape + (3 * cfg.future_prediction_step,)).astype(f32)
    valid = (rng.uniform(size=w_shape + (1,)) < 0.9).astype(f32)
    ref_tp = copy.copy(policy)
    ref_tp.tp_net = dataclasses.replace(policy.tp_net, dtype=jnp.float32)

    def tp_vg(pol, p, *w):
        return jax.value_and_grad(pol.tp_loss)(p, *w)

    tp_args = (ts.tp_params, tp_in, tgt, valid)
    tp_gpu = jax.jit(lambda *a: tp_vg(policy, *a))
    l_tp, g_tp = tp_gpu(*jax.device_put(tp_args, gpu))
    with jax.default_matmul_precision("highest"):
        l_tp_r, g_tp_r = jax.jit(lambda *a: tp_vg(ref_tp, *a))(*jax.device_put(tp_args, cpu))
    r = abs(float(l_tp) - float(l_tp_r)) / max(abs(float(l_tp_r)), 1e-6)
    log(f"  TP_loss: card {float(l_tp):.6g} cpu {float(l_tp_r):.6g} rel err {r:.3e} (tol {OUT_RTOL})")
    assert r <= OUT_RTOL, "TP_loss"
    _compare_grads("TP grads", g_tp, g_tp_r)

    if time_it:
        enc = jax.jit(lambda p, m: vg(policy, p, m))
        ms, spread = _time(enc, *on_gpu)
        log(f"  XLA time, encoder+head fwd+bwd (one minibatch, {s} samples): "
            f"{ms:.3f} ms (spread {spread:.3f} ms over 3 windows of 10 calls)")
        ms, spread = _time(tp_gpu, *jax.device_put(tp_args, gpu))
        log(f"  XLA time, TP loss fwd+bwd ({n_win} windows): {ms:.3f} ms "
            f"(spread {spread:.3f} ms over 3 windows of 10 calls)")


# ------------------------------------------------------------------ hover
def hover_phase():
    import importlib.util

    phase("hover: fixed-seed 100-step rollout vs tests/golden")
    path = REPO / "tests" / "test_trajectory_regression.py"
    spec = importlib.util.spec_from_file_location("trajectory_regression", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pos, quat = mod._rollout()
    ref = np.load(mod.GOLDEN)
    assert np.isfinite(pos).all() and np.isfinite(quat).all()
    for name, a, b in (("pos", pos, ref["pos"]), ("quat", quat, ref["quat"])):
        err = float(np.max(np.abs(a - b)))
        log(f"  {name}: max abs err {err:.3e} (atol {HOVER_ATOL})")
        assert err <= HOVER_ATOL, name


# -------------------------------------------------------------- 4 devices
def multichip_phase(devices, envs_per_device: int = 4096, overrides=()):
    """HideAndSeek MAPPO with len(devices) × envs_per_device arenas sharded
    over `devices`, vs the same iteration from the same carry on one
    device (`overrides`: extra `env.*`/`algo.*` settings).  Returns the two
    metric dicts."""
    from mupe_tpu.harness import build
    from mupe_tpu.learning import init_carry, make_split_train_iter
    from mupe_tpu.parallel import make_mesh, shard_carry
    from mupe_tpu.utils.config import parse_cli

    n = len(devices)
    num_envs = n * envs_per_device
    phase(f"devices: {n} x {envs_per_device} arenas sharded vs one device")
    sections, _ = parse_cli(flagship(num_envs) + list(overrides))
    env, policy, _, _ = build("HideAndSeek", sections.get("env"), sections.get("algo"))
    train_iter = make_split_train_iter(env, policy)
    with jax.default_device(devices[0]):
        carry0 = init_carry(env, policy, jax.random.PRNGKey(0))

    mesh = make_mesh(devices)
    sharded = shard_carry(carry0, mesh)
    env_leaves = [
        x for x in jax.tree_util.tree_leaves(sharded.env_state)
        if x.ndim >= 1 and x.shape[0] == num_envs
    ]
    assert env_leaves
    for x in env_leaves:
        assert x.sharding.device_set == set(devices), x.sharding
    log(f"  {len(env_leaves)} env leaves each span {n} devices")

    t0 = time.time()
    sharded, m_multi, _ = train_iter(sharded)
    m_multi = {k: float(v) for k, v in m_multi.items()}
    log(f"  sharded iteration: {time.time() - t0:.1f} s (compilation included)")
    t0 = time.time()
    _, m_one, _ = train_iter(carry0)
    m_one = {k: float(v) for k, v in m_one.items()}
    log(f"  one-device iteration: {time.time() - t0:.1f} s (compilation included)")
    sharded, m2, _ = train_iter(sharded)
    assert all(math.isfinite(float(v)) for v in m2.values())
    for x in jax.tree_util.tree_leaves(sharded.env_state):
        if x.ndim >= 1 and x.shape[0] == num_envs:
            assert x.sharding.device_set == set(devices)
    worst = {True: 0.0, False: 0.0}
    for k in sorted(m_one):
        a, b = m_multi[k], m_one[k]
        assert math.isfinite(a) and math.isfinite(b), k
        pre = k in MULTI_PRE_OPT
        rtol = MULTI_PRE_RTOL if pre else MULTI_CHAIN_RTOL
        frac = abs(a - b) / (MULTI_ATOL + rtol * abs(b))
        worst[pre] = max(worst[pre], frac)
        log(f"  {k}: {n} devices {a:.6g} | one device {b:.6g} "
            f"({frac:.3f} of {rtol} rel + {MULTI_ATOL} abs)")
    log(f"  worst: {worst[True]:.3f} of bound before the optimizer, "
        f"{worst[False]:.3f} over the Adam steps")
    assert max(worst.values()) <= 1.0, (
        "sharded iteration differs from the one-device iteration"
    )
    return m_multi, m_one


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    phase("device")
    devs = check_device(args.devices)
    _import_program()
    from mupe_tpu.utils.compile_cache import setup_compile_cache

    log(f"  compile cache: {setup_compile_cache()}")
    if args.devices == 4:
        multichip_phase(devs[:4])
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            ts = train_phase(Path(tmp))
        parity_phase(ts)
        hover_phase()
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
