"""k-means anchors and dataset CSVs from a labelled image folder (the
port's ``generate_kmeans_dataset_csvs.py`` command line, the JAX
package's ``cli/kmeans_csvs.py``)::

    python -m mit_driverless_cv_traininginfra_tpu_torch.cli.kmeans_csvs \\
        --input_csvs dataset/all.csv --dataset_path dataset/YOLO_Dataset/ \\
        --output_path dataset/ --no_if_plot

``--if_plot`` (the default) draws the box distributions with matplotlib.
"""

from __future__ import annotations

import argparse
import sys

from mit_driverless_cv_traininginfra_tpu_torch.data.kmeans_anchors import (
    generate_dataset_csvs,
)
from mit_driverless_cv_traininginfra_tpu_torch.utils.logger import add_bool_arg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="k-means anchor/CSV generator")
    parser.add_argument("--input_csvs", default="dataset/all.csv")
    parser.add_argument("--dataset_path", type=str, default="dataset/YOLO_Dataset/")
    parser.add_argument("--output_path", type=str, default="dataset/")
    parser.add_argument("--num_clst", type=int, default=9)
    parser.add_argument("--max_cone_height", default=83, type=int)
    parser.add_argument("--min_cone_height", default=10, type=int)
    parser.add_argument("--split_up", type=str, default="75-15-0")
    parser.add_argument("--seed", type=int, default=0)
    add_bool_arg(parser, "if_plot", True, "plot anchor/box distributions")
    opt = parser.parse_args(argv)

    split_up = [int(x) for x in opt.split_up.split("-")]
    anchors = generate_dataset_csvs(
        csv_uri=opt.input_csvs,
        dataset_path=opt.dataset_path,
        output_path=opt.output_path,
        num_clst=opt.num_clst,
        max_cone=opt.max_cone_height,
        min_cone=opt.min_cone_height,
        split_up=split_up,
        seed=opt.seed,
        plot=opt.if_plot,
    )
    print("Anchors = ", anchors)
    return 0


if __name__ == "__main__":
    sys.exit(main())
