#!/usr/bin/env python
"""Render RESULTS.md from training-run CSV logs (+ optional eval-sweep
JSON): learning curves as PNGs under docs/results/ and milestone tables.

Usage:
    python scripts/make_results.py runs/<flagship-run> [runs/<more-runs>...] \
        [--eval eval_sweep.json] [--out RESULTS.md]

Reads the metrics.csv each run writes (utils/logging.py RunLogger), plots
the headline learning signals per task (HideAndSeek: stats/success,
stats/catch_reward, TP_loss; Hover: stats/pos_error), and writes a
RESULTS.md section per run with first/last values so the numbers are
greppable without opening the images.
"""
import argparse
import csv
import json
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

CURVES = [
    # (column, label, better)
    ("stats/success", "capture success rate", "up"),
    ("stats/catch_reward", "catch reward", "up"),
    ("TP_loss", "TP-net prediction loss", "down"),
    ("target_predicted_error", "TP prediction error [m]", "down"),
    ("stats/pos_error", "hover position error [m]", "down"),
    ("stats/return", "episode return", "up"),
    ("eval/success", "eval capture success", "up"),
    # adaptive-entropy controller trace (round-4 VERDICT weak #4) and the
    # scene feasibility degradation stats (weak #1)
    ("entropy_coef", "entropy coefficient (adaptive)", "flat"),
    ("entropy", "policy entropy", "flat"),
    ("stats/scene_fallback", "empty-arena fallback ratio", "down"),
    ("stats/scene_degraded", "degraded-scene ratio", "down"),
]


def load_csv(path: Path):
    """Column dict; episode stats (`stats/*`, `eval/*`) keep only rows
    where episodes actually finished — envs reset in sync every
    max_episode_length steps, so non-boundary iterations report zero
    episodes and their stat means are meaningless."""
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            rows.append(row)

    def _f(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return None

    cols = {}
    for row in rows:
        n_ep = _f(row.get("stats/episode_count", "")) or 0.0
        for k, v in row.items():
            fv = _f(v)
            if fv is None:
                continue
            if k.startswith("stats/") and k != "stats/episode_count" and n_ep == 0:
                continue
            cols.setdefault(k, []).append(fv)
            if k.startswith("stats/"):
                cols.setdefault(k + "@frames", []).append(
                    _f(row.get("env_frames", "")) or 0.0
                )
    return cols


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--eval", default=None)
    ap.add_argument("--out", default="RESULTS.md")
    ap.add_argument("--imgdir", default="docs/results")
    args = ap.parse_args()

    imgdir = Path(args.imgdir)
    imgdir.mkdir(parents=True, exist_ok=True)
    lines = [
        "# RESULTS — learning results of the training runs",
        "",
        "Generated by `scripts/make_results.py` from committed run logs",
        "(`runs/<name>/metrics.csv`).  Reference protocol: HideAndSeek",
        "success/capture stats (hideandseek.py:942-952), 4-scenario eval",
        "sweep (README.md:147-149).",
        "",
    ]
    for run in args.runs:
        run = Path(run)
        cols = load_csv(run / "metrics.csv")
        steps = cols.get("env_frames", [])
        cfg_path = run / "config.json"
        cfg = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
        task = cfg.get("run", {}).get("task", cfg.get("task", "?"))
        algo = cfg.get("run", {}).get("algo", cfg.get("algo", "?"))
        lines += [f"## Run `{run.name}` — task={task} algo={algo}", ""]
        present = [c for c in CURVES if c[0] in cols and len(cols[c[0]]) > 1]
        if present:
            n = len(present)
            fig, axes = plt.subplots(1, n, figsize=(4 * n, 3))
            if n == 1:
                axes = [axes]
            for ax, (col, label, better) in zip(axes, present):
                ys = cols[col]
                xs = cols.get(col + "@frames") or (
                    steps[: len(ys)] if steps else range(len(ys))
                )
                ax.plot(xs, ys, lw=1.2)
                ax.set_title(label, fontsize=9)
                ax.set_xlabel("env frames", fontsize=8)
                ax.tick_params(labelsize=7)
                ax.grid(alpha=0.3)
            fig.tight_layout()
            img = imgdir / f"{run.name}.png"
            fig.savefig(img, dpi=110)
            plt.close(fig)
            lines += [f"![{run.name}]({img})", ""]
        lines += [
            "| metric | first | last | direction |",
            "|---|---|---|---|",
        ]
        for col, label, better in CURVES:
            if col not in cols or len(cols[col]) < 2:
                continue
            ys = cols[col]
            arrow = {"up": "↑ good", "down": "↓ good"}.get(better, "")
            lines.append(
                f"| {label} (`{col}`) | {ys[0]:.4f} | {ys[-1]:.4f} | {arrow} |"
            )
        fps = cols.get("rollout_fps", [])
        if fps:
            peak = max(fps)
            lines.append(
                f"| throughput (`rollout_fps`) | — | {peak:,.0f} peak | |"
            )
        lines.append("")

    if args.eval:
        sweep = json.loads(Path(args.eval).read_text())
        lines += [
            "## 4-scenario eval sweep (deterministic policy, fresh episodes)",
            "",
            "| scenario | success | first_capture_step | collision |",
            "|---|---|---|---|",
        ]
        for scen, d in sweep.items():
            lines.append(
                f"| {scen} | {d.get('success', float('nan')):.3f} "
                f"| {d.get('first_capture_step', float('nan')):.1f} "
                f"| {d.get('collision', float('nan')):.3f} |"
            )
        lines.append("")

    Path(args.out).write_text("\n".join(lines))
    print(f"wrote {args.out} (+ images in {imgdir}/)")


if __name__ == "__main__":
    main()
