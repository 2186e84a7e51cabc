"""RektNet hyperparameter search (the reference's ``train_eval_hyper.py``
surface, the JAX package's ``cli/rektnet_hyper.py``): a TPE sweep over the
geometric loss's gammas and the loss type, each trial a subprocess running
the port's ``cli/rektnet_train`` and scored by the
``logs/<study_name>.txt`` that its closing keypoint distances write::

    python -m mit_driverless_cv_traininginfra_tpu_torch.cli.rektnet_hyper \\
        --train_dataset_uri dataset/rektnet_label.csv \\
        --dataset_path dataset/RektNet_Dataset/ --geo_loss_study [--device cpu]

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
    parser = argparse.ArgumentParser(description="RektNet hyperparameter search")
    parser.add_argument("--study_name", type=str, default="rektnet_study")
    parser.add_argument("--num_trials", type=int, default=100)
    parser.add_argument("--train_dataset_uri", type=str,
                        default="dataset/rektnet_label.csv")
    parser.add_argument("--dataset_path", type=str, default="dataset/RektNet_Dataset/")
    parser.add_argument("--num_epochs", type=int, default=1024)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device each trial trains on ('cuda' or 'cpu')")
    add_bool_arg(parser, "geo_loss_study", False, "study geo-loss gammas")
    add_bool_arg(parser, "loss_type_study", False, "study the loss type")
    opt = parser.parse_args(argv)

    def objective(trial):
        if opt.geo_loss_study:
            geo_loss_gamma_vert = trial.suggest_uniform("geo_loss_gamma_vert", 0, 0.15)
            geo_loss_gamma_horz = trial.suggest_uniform("geo_loss_gamma_horz", 0, 0.15)
        else:
            geo_loss_gamma_vert = geo_loss_gamma_horz = 0
        loss_type = (
            trial.suggest_categorical(
                "loss_type", ["l2_softargmax", "l2_heatmap", "l1_softargmax"])
            if opt.loss_type_study else "l1_softargmax"
        )

        args = {
            "geo_loss_gamma_vert": geo_loss_gamma_vert,
            "geo_loss_gamma_horz": geo_loss_gamma_horz,
            "loss_type": loss_type,
            "study_name": opt.study_name,
            "train_dataset_uri": opt.train_dataset_uri,
            "dataset_path": opt.dataset_path,
            "num_epochs": opt.num_epochs,
            "device": opt.device,
        }
        arglist = cli_arglist(
            [sys.executable, "-u", "-m",
             "mit_driverless_cv_traininginfra_tpu_torch.cli.rektnet_train"], args)
        return run_cli_trial(arglist, "logs/" + opt.study_name + ".txt")

    study = create_study(opt.study_name)
    study.optimize(objective, n_trials=opt.num_trials)
    print("best trial:", study.best_trial)
    return 0


if __name__ == "__main__":
    sys.exit(main())
