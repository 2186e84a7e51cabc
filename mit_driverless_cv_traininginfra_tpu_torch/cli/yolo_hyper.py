"""YOLO hyperparameter search (the reference's ``train_hyper.py`` surface,
the JAX package's ``cli/yolo_hyper.py``): a TPE sweep over the loss
constants, tiling and the optimizer, each trial a subprocess running the
port's ``cli/yolo_train`` and scored by the ``logs/result.txt`` it
writes::

    python -m mit_driverless_cv_traininginfra_tpu_torch.cli.yolo_hyper \\
        --model_cfg model_cfg/yolo_baseline.cfg --loss_study [--device cpu]

The flags, objective and trial arguments are the JAX CLI's, plus
``--device`` (``cuda`` unless the CPU is asked for), passed on to each
trial. The study is ``studies/<study_name>.json`` in the working
directory (create or join).
"""

from __future__ import annotations

import argparse
import sys

from mit_driverless_cv_traininginfra_tpu_torch.hyper.search import (
    cli_arglist,
    create_study,
    run_cli_trial,
)
from mit_driverless_cv_traininginfra_tpu_torch.utils.logger import add_bool_arg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="YOLO hyperparameter search")
    parser.add_argument("--model_cfg", type=str, required=True)
    parser.add_argument("--checkpoint_interval", type=int, default=1)
    parser.add_argument("--num_epochs", type=int, default=20)
    parser.add_argument("--num_trials", type=int, default=100)
    parser.add_argument("--val_tolerance", type=int, default=1)
    parser.add_argument("--study_name", type=str, default="yolo_study")
    parser.add_argument("--dataset_path", type=str, default="dataset/YOLO_Dataset/")
    parser.add_argument("--weights_path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device each trial trains on ('cuda' or 'cpu')")
    add_bool_arg(parser, "ts_study", False, "study tiling on/off")
    add_bool_arg(parser, "optimizer_study", False, "study Adam vs SGD")
    add_bool_arg(parser, "loss_study", False, "study loss constants")
    opt = parser.parse_args(argv)

    def objective(trial):
        if opt.loss_study:
            xy_loss = trial.suggest_uniform("xy_loss", 1.6, 2.4)
            wh_loss = trial.suggest_uniform("wh_loss", 1.28, 1.92)
            no_object_loss = trial.suggest_uniform("no_object_loss", 20.0, 30.0)
            object_loss = trial.suggest_uniform("object_loss", 0.08, 0.12)
        else:
            xy_loss, wh_loss = 2, 1.6
            no_object_loss, object_loss = 25, 0.1
        tile = trial.suggest_categorical("tile", [False, True]) if opt.ts_study else True
        optimizer_pick = (
            trial.suggest_categorical("optimizer_pick", ["Adam", "SGD"])
            if opt.optimizer_study else "Adam"
        )

        args = {
            "model_cfg": opt.model_cfg,
            "dataset_path": opt.dataset_path,
            "ts": tile,
            "xy_loss": xy_loss,
            "wh_loss": wh_loss,
            "no_object_loss": no_object_loss,
            "object_loss": object_loss,
            "num_epochs": opt.num_epochs,
            "checkpoint_interval": opt.checkpoint_interval,
            "optimizer_pick": optimizer_pick,
            "val_tolerance": opt.val_tolerance,
            "weights_path": opt.weights_path,
            "device": opt.device,
        }
        arglist = cli_arglist(
            [sys.executable, "-m", "mit_driverless_cv_traininginfra_tpu_torch.cli.yolo_train"],
            args)
        return run_cli_trial(arglist, "logs/result.txt")

    study = create_study(opt.study_name)
    study.optimize(objective, n_trials=opt.num_trials)
    print("best trial:", study.best_trial)
    return 0


if __name__ == "__main__":
    sys.exit(main())
