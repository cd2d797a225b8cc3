"""Plot of a runtime / memory sweep: runtime and peak host RSS against the
database size, one line per tool, from the CSV of ``tools/runtime_memory.py``
(columns ``tool``, ``size``, ``runtime_s``, ``peak_rss_mb``, ...). The port of
the JAX package's ``scripts/plot_runtime_memory.py`` (its ``--kind
speedup`` reads ``speedup.py``'s CSV, which comes with the multi-device
slice).

    python -m raxtax_tpu_torch.tools.plot_runtime_memory runtime_memory.csv

Writes the PNG next to the CSV. A host script: it needs pandas, matplotlib
and seaborn, and no GPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def plot_runtime_memory(csv_path: Path) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    df = pd.read_csv(csv_path)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    sns.lineplot(df, x="size", y="runtime_s", hue="tool", marker="o", ax=axes[0])
    axes[0].set(xlabel="database size (records)", ylabel="runtime [s]")
    sns.lineplot(df, x="size", y="peak_rss_mb", hue="tool", marker="o", ax=axes[1])
    axes[1].set(xlabel="database size (records)", ylabel="peak RSS [MB]")
    fig.tight_layout()
    out = csv_path.with_suffix(".png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"wrote {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csv", type=Path)
    args = ap.parse_args(argv)
    plot_runtime_memory(args.csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
