"""Round results and latent plots (port of fedmse_tpu/visualization.py, the
reference's Visualization notebooks as a module).

  * `load_round_results`  every `*_results.json` (JSON lines, one row a
                          round) under a results directory, by combination;
  * `plot_results`        per-gateway final metric bars and per-round mean
                          curves of every combination found;
  * `save_latent_data`    the hybrid's (latents, labels) pickle writer
                          (checkpointing/io.py, re-exported);
  * `plot_latent_tsne`    t-SNE panels of test latents by label, one per
                          aggregation algorithm.

matplotlib, and sklearn for t-SNE, are imported inside the plot functions
only: a training run never needs them, and the card's machine has
neither, so a plot there raises ImportError naming the package.

CLI: python -m fedmse_tpu_torch.visualization --results-dir <dir> --out plots/
"""

from __future__ import annotations

import argparse
import glob
import importlib
import json
import logging
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from fedmse_tpu_torch.checkpointing import save_latent_data

__all__ = ["load_round_results", "plot_results", "save_latent_data",
           "plot_latent_tsne", "main"]

logger = logging.getLogger(__name__)


def _require(module: str, package: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"plotting needs {package}, which is not "
                          f"installed ({e})") from e


def _plt():
    """pyplot on the Agg backend (files only, no display)."""
    _require("matplotlib", "matplotlib").use("Agg")
    return _require("matplotlib.pyplot", "matplotlib")


def load_round_results(results_dir: str) -> Dict[str, List[dict]]:
    """{combination: [round rows]} from every `*_results.json` under
    `results_dir` (the driver's Run_*/<metric>/ files)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(results_dir, "**",
                                              "*_results.json"),
                                 recursive=True)):
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        if rows and "client_metrics" in rows[0]:
            out[os.path.basename(path).replace("_results.json", "")] = rows
    return out


def _metrics(row: dict) -> np.ndarray:
    # a retired gateway's metric is written as null
    return np.asarray([np.nan if m is None else m
                       for m in row["client_metrics"]], dtype=float)


def plot_results(results_dir: str, out_dir: str) -> List[str]:
    """Per-gateway final metric bars and per-round mean curves of every
    combination under `results_dir`; returns the PNGs written."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    combos = load_round_results(results_dir)
    if not combos:
        logger.warning("no results found under %s", results_dir)
        return []
    written = []

    fig, ax = plt.subplots(figsize=(10, 4.5))
    width = 0.8 / len(combos)
    for i, (name, rows) in enumerate(combos.items()):
        final = _metrics(rows[-1])
        ax.bar(np.arange(len(final)) + i * width, final * 100, width=width,
               label=name)
    ax.set_xlabel("gateway")
    ax.set_ylabel("final metric (%)")
    ax.set_ylim(80, 100.5)
    ax.legend(fontsize=7)
    ax.set_title("Per-gateway final metric by method")
    p = os.path.join(out_dir, "per_gateway_metrics.png")
    fig.tight_layout()
    fig.savefig(p, dpi=120)
    plt.close(fig)
    written.append(p)

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name, rows in combos.items():
        means = [float(np.nanmean(_metrics(r))) for r in rows]
        ax.plot(np.arange(1, len(means) + 1), means, marker="o", label=name)
    ax.set_xlabel("round")
    ax.set_ylabel("mean client metric")
    ax.legend(fontsize=7)
    ax.set_title("Convergence per aggregation method")
    p = os.path.join(out_dir, "round_curves.png")
    fig.tight_layout()
    fig.savefig(p, dpi=120)
    plt.close(fig)
    written.append(p)
    return written


def plot_latent_tsne(latent_files: Sequence[str], out_path: str,
                     dims: int = 2, max_points: int = 2000,
                     seed: int = 0) -> str:
    """t-SNE panels of test latents (normal blue, abnormal red), one per
    latent pickle; at most `max_points` rows a panel, drawn from `seed`."""
    tsne = _require("sklearn.manifold", "scikit-learn").TSNE
    plt = _plt()
    n = len(latent_files)
    fig = plt.figure(figsize=(5 * n, 4.5))
    rng = np.random.default_rng(seed)
    for i, path in enumerate(latent_files):
        with open(path, "rb") as f:
            latents, labels = pickle.load(f)
        latents, labels = np.asarray(latents), np.asarray(labels)
        if len(latents) > max_points:
            idx = rng.choice(len(latents), max_points, replace=False)
            latents, labels = latents[idx], labels[idx]
        emb = tsne(n_components=dims, random_state=seed,
                   init="pca").fit_transform(latents)
        ax = fig.add_subplot(1, n, i + 1,
                             projection="3d" if dims == 3 else None)
        for cls, color, name in ((0, "tab:blue", "normal"),
                                 (1, "tab:red", "abnormal")):
            m = labels == cls
            ax.scatter(*[emb[m, d] for d in range(dims)], s=4, alpha=0.5,
                       c=color, label=name)
        ax.set_title(os.path.basename(path).replace(".pkl", ""))
        ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    p = argparse.ArgumentParser(
        description="Plot a run's round results and latent t-SNE panels.")
    p.add_argument("--results-dir", required=True)
    p.add_argument("--out", default="plots")
    p.add_argument("--latent-glob", default=None,
                   help="glob of latent_hybrid_*.pkl files for t-SNE panels")
    p.add_argument("--tsne-dims", type=int, default=2, choices=(2, 3))
    args = p.parse_args(argv)
    written = plot_results(args.results_dir, args.out)
    files = (sorted(glob.glob(args.latent_glob, recursive=True))
             if args.latent_glob else [])
    if files:
        written.append(plot_latent_tsne(
            files, os.path.join(args.out, "latent_tsne.png"),
            dims=args.tsne_dims))
    for w in written:
        logger.info("wrote %s", w)
    return written


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
