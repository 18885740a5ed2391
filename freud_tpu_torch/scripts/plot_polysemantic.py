"""Polysemanticity plots: per-phoneme activation distributions for one feature.

The port of ``freud_tpu/scripts/plot_polysemantic.py``, framework-free as
the original is (pandas, scipy, matplotlib): from a CSV of (phoneme,
activation) samples, draw (a) a grouped histogram of activation values per
phoneme and (b) per-phoneme means with 95% confidence intervals
(Student-t). The CSV path defaults to the port's own copy of the bundled
asset (``freud_tpu_torch/assets/polyesemantic_count.csv``).

Usage:
  python -m freud_tpu_torch.scripts.plot_polysemantic --csv counts.csv --out plots/
"""

from __future__ import annotations

import argparse
from pathlib import Path

_DEFAULT_CSV = str(
    Path(__file__).resolve().parent.parent / "assets" / "polyesemantic_count.csv"
)


def plot_histograms(df, out_path: Path, value_col: str, group_col: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups = sorted(df[group_col].unique())
    fig, ax = plt.subplots(figsize=(10, 6))
    data = [df[df[group_col] == g][value_col].to_numpy() for g in groups]
    ax.hist(data, bins=20, label=[str(g) for g in groups])
    ax.set_xlabel(value_col)
    ax.set_ylabel("count")
    ax.set_title(f"{value_col} distribution by {group_col}")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def plot_means_with_ci(
    df, out_path: Path, value_col: str, group_col: str, confidence: float = 0.95
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    from scipy import stats

    groups = sorted(df[group_col].unique())
    means, errs = [], []
    for g in groups:
        vals = df[df[group_col] == g][value_col].to_numpy()
        mean = float(np.mean(vals))
        if len(vals) > 1:
            sem = stats.sem(vals)
            half = sem * stats.t.ppf((1 + confidence) / 2.0, len(vals) - 1)
        else:
            half = 0.0
        means.append(mean)
        errs.append(half)
    fig, ax = plt.subplots(figsize=(10, 6))
    x = np.arange(len(groups))
    ax.bar(x, means, yerr=errs, capsize=4)
    ax.set_xticks(x)
    ax.set_xticklabels([str(g) for g in groups], rotation=45, ha="right")
    ax.set_ylabel(f"mean {value_col} (±{int(confidence * 100)}% CI)")
    ax.set_title(f"mean {value_col} by {group_col}")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def load_samples(csv: str, value_col=None, group_col=None):
    """→ (long-format df, value_col, group_col).

    The reference's bundled CSV (and its reader, reference
    plot_polysemantic.py) is WIDE: one row per phoneme — label in the first
    column, that phoneme's activation samples across the remaining columns
    (first line blank). With no explicit columns, that layout is detected
    and melted to long form; otherwise a conventional (group, value) long
    CSV is read with auto-detected columns."""
    import pandas as pd

    if value_col is None and group_col is None:
        raw = pd.read_csv(csv, header=None).dropna(how="all")
        # the wide layout is headerless, so EVERY column after the label
        # column parses numeric; a long CSV with a header row leaves string
        # dtype in those columns (the header strings) — requiring
        # all-numeric sample columns keeps e.g. 'phoneme,activation,count'
        # long files out of the wide branch (their extra numeric columns
        # would otherwise silently melt into the sample pool)
        if (raw.shape[1] > 2
                and not pd.api.types.is_numeric_dtype(raw.iloc[:, 0])
                and all(pd.api.types.is_numeric_dtype(raw[c])
                        for c in raw.columns[1:])):
            long = raw.melt(id_vars=[0], value_name="activation")
            long = long.rename(columns={0: "phoneme"})
            long["activation"] = pd.to_numeric(long["activation"],
                                               errors="coerce")
            long = long.dropna(subset=["activation"])
            return long[["phoneme", "activation"]], "activation", "phoneme"

    df = pd.read_csv(csv)
    numeric = df.select_dtypes("number").columns
    non_numeric = [c for c in df.columns if c not in numeric]
    if value_col is None:
        if not len(numeric):
            raise SystemExit(
                "no numeric column in the CSV — pass --value_col")
        value_col = numeric[0]
    if group_col is None:
        if not non_numeric:
            raise SystemExit(
                "no non-numeric column in the CSV — pass --group_col")
        group_col = non_numeric[0]
    return df, value_col, group_col


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--csv", default=_DEFAULT_CSV,
                        help="CSV with phoneme-labelled activation samples")
    parser.add_argument("--out", default="plots", help="Output folder")
    parser.add_argument("--value_col", default=None,
                        help="Activation column (default: first numeric column)")
    parser.add_argument("--group_col", default=None,
                        help="Group column (default: first non-numeric column)")
    args = parser.parse_args(argv)

    df, value_col, group_col = load_samples(
        args.csv, args.value_col, args.group_col)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    plot_histograms(df, out / "histograms.png", value_col, group_col)
    plot_means_with_ci(df, out / "means_ci.png", value_col, group_col)
    print(f"wrote {out}/histograms.png and {out}/means_ci.png")


if __name__ == "__main__":
    main()
