"""Bayesian hyperparameter search, the study layer (the port's copy of the
JAX package's ``hyper/search.py``: the same storage format, sampler
arithmetic and ``numpy.random.default_rng`` draws; reference
``CVC-YOLOv3/train_hyper.py`` and ``RektNet/train_eval_hyper.py``, which
use optuna):

- a :class:`Study` with create-or-join by name and file storage (JSON
  under an advisory ``fcntl`` lock on a separate lock file), so workers
  can join one study as the reference's joined a shared MySQL store.
  ``fcntl.flock`` excludes across hosts only where the filesystem maps it
  to a network lock (NFSv4, most cluster filesystems); within one host it
  always holds;
- a TPE sampler (an independent Parzen estimator per parameter: a
  good/bad quantile split, a Gaussian mixture around the good
  observations, the candidate with the largest l(x)/g(x)); the first
  ``n_startup_trials`` draws are uniform;
- each trial runs the target CLI as a subprocess (its own process, its own
  CUDA context) and reads the score back from the score file it writes
  (``logs/result.txt``, ``logs/<study>.txt``).
"""

from __future__ import annotations

import fcntl
import json
import math
import os
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np


@dataclass
class FloatParam:
    low: float
    high: float


@dataclass
class CategoricalParam:
    choices: Sequence


ParamSpec = Union[FloatParam, CategoricalParam]


class Trial:
    """Per-trial parameter accessor (optuna-Trial-compatible surface).
    Parameters are sampled lazily at ``suggest_*`` time, like optuna."""

    def __init__(self, study: "Study", number: int):
        self.study = study
        self.number = number
        self.params: Dict = {}

    def suggest_uniform(self, name: str, low: float, high: float) -> float:
        value = self.study._sample_one(name, FloatParam(low, high))
        self.params[name] = value
        return value

    suggest_float = suggest_uniform

    def suggest_categorical(self, name: str, choices: Sequence):
        value = self.study._sample_one(name, CategoricalParam(list(choices)))
        self.params[name] = value
        return value


class TPESampler:
    """Independent TPE: for each param, model good (bottom-γ quantile score)
    and bad observations with Parzen windows; pick the candidate maximising
    l(x)/g(x)."""

    def __init__(self, gamma: float = 0.25, n_candidates: int = 24,
                 n_startup_trials: int = 10, seed: Optional[int] = None):
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup = n_startup_trials
        self.rng = np.random.default_rng(seed)

    def sample(self, spec: ParamSpec, history: List) -> object:
        """history: list of (value, score) completed observations."""
        if isinstance(spec, CategoricalParam):
            return self._sample_categorical(spec, history)
        return self._sample_float(spec, history)

    def _split(self, history):
        scores = np.asarray([s for _, s in history], float)
        order = np.argsort(scores)
        n_good = max(1, int(math.ceil(self.gamma * len(history))))
        good = [history[i][0] for i in order[:n_good]]
        bad = [history[i][0] for i in order[n_good:]] or good
        return good, bad

    def _sample_float(self, spec: FloatParam, history) -> float:
        if len(history) < self.n_startup:
            return float(self.rng.uniform(spec.low, spec.high))
        good, bad = self._split(history)
        width = spec.high - spec.low
        sigma = max(width / max(len(good), 1) ** 0.5 * 0.5, width * 0.05)

        def logpdf(x, obs):
            obs = np.asarray(obs, float)
            d = (x[:, None] - obs[None, :]) / sigma
            return np.log(np.mean(np.exp(-0.5 * d * d), axis=1) + 1e-12)

        centers = np.asarray(good, float)
        cands = centers[self.rng.integers(0, len(centers), self.n_candidates)]
        cands = cands + self.rng.normal(0, sigma, self.n_candidates)
        cands = np.clip(cands, spec.low, spec.high)
        ei = logpdf(cands, good) - logpdf(cands, bad)
        return float(cands[int(np.argmax(ei))])

    def _sample_categorical(self, spec: CategoricalParam, history):
        if len(history) < self.n_startup:
            return spec.choices[int(self.rng.integers(0, len(spec.choices)))]
        good, bad = self._split(history)

        def weights(obs):
            counts = np.asarray(
                [1.0 + sum(1 for v in obs if v == c) for c in spec.choices]
            )
            return counts / counts.sum()

        ei = np.log(weights(good)) - np.log(weights(bad))
        return spec.choices[int(np.argmax(ei))]


class Study:
    """Create-or-join persistent study minimising the objective."""

    def __init__(self, study_name: str, storage_dir: str = "studies",
                 sampler: Optional[TPESampler] = None, seed: Optional[int] = None):
        self.study_name = study_name
        self.path = os.path.join(storage_dir, f"{study_name}.json")
        # lock lives on a file that is NEVER os.replace()d — locking the
        # data file itself would leave two workers holding "the lock" on
        # different inodes after an atomic rewrite
        self.lock_path = os.path.join(storage_dir, f"{study_name}.lock")
        os.makedirs(storage_dir, exist_ok=True)
        self.sampler = sampler or TPESampler(seed=seed)
        self._specs: Dict[str, ParamSpec] = {}

        # create-or-join must run under the lock: an unlocked exists-check
        # + initial write lets a joining worker's empty store clobber
        # trials another worker appended in between
        def _init_store():
            if os.path.exists(self.path):
                return True
            self._write({"study_name": study_name, "trials": []})
            return False

        joined = self._locked(_init_store)
        print("Joined existing study" if joined else "Created study")

    # -- storage -----------------------------------------------------------

    def _locked(self, fn):
        with open(self.lock_path, "a+") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                return fn()
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def _read(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {"study_name": self.study_name, "trials": []}

    def _write(self, data: dict):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, self.path)

    # -- sampling ----------------------------------------------------------

    def _sample_one(self, name: str, spec: ParamSpec):
        self._specs[name] = spec
        done = [t for t in self._read()["trials"] if t.get("state") == "COMPLETE"]
        history = [
            (t["params"][name], t["value"]) for t in done if name in t["params"]
        ]
        return self.sampler.sample(spec, history)

    # -- driving -----------------------------------------------------------

    def optimize(self, objective: Callable[[Trial], float], n_trials: int):
        for _ in range(n_trials):
            number = self._locked(lambda: self._append_running())
            trial = Trial(self, number)
            t0 = time.time()
            try:
                value = objective(trial)
                state = "COMPLETE"
            except subprocess.CalledProcessError as e:
                value = float("inf")
                state = "FAIL"
                print(f"Trial {number} failed: {e}")
            except BaseException:
                # any other objective error (missing/garbage score file,
                # Ctrl-C, ...): mark the trial FAIL in shared storage
                # BEFORE propagating — the optuna contract — so no ghost
                # RUNNING trial lingers for other workers
                self._locked(
                    lambda: self._finish(number, trial.params, None, "FAIL",
                                         time.time() - t0))
                raise
            self._locked(
                lambda: self._finish(number, trial.params, value, state,
                                     time.time() - t0)
            )
            print(f"Trial {number} {state} value={value}")

    def _append_running(self):
        data = self._read()
        number = len(data["trials"])
        data["trials"].append({"number": number, "params": {},
                               "state": "RUNNING", "value": None})
        self._write(data)
        return number

    def _finish(self, number, params, value, state, duration):
        data = self._read()
        for t in data["trials"]:
            if t["number"] == number:
                t.update(params=params, value=value, state=state,
                         duration=duration)
        self._write(data)

    @property
    def best_trial(self) -> Optional[dict]:
        done = [t for t in self._read()["trials"] if t.get("state") == "COMPLETE"]
        return min(done, key=lambda t: t["value"]) if done else None

    @property
    def trials(self) -> List[dict]:
        return self._read()["trials"]


def create_study(study_name: str, storage_dir: str = "studies", seed=None) -> Study:
    """create-or-join semantics (train_hyper.py:113-126)."""
    return Study(study_name, storage_dir, seed=seed)


def run_cli_trial(arglist: Sequence[str], score_file: str) -> float:
    """Subprocess isolation + score-file contract (train_hyper.py:89-111)."""
    print("statement for this study is: ")
    print(" ".join(arglist))
    subprocess.check_call(list(arglist))
    with open(score_file) as f:
        score = float(f.read())
    print(f"score for this study is {score}")
    return score


def cli_arglist(head: Sequence[str], args: Dict) -> List[str]:
    """``head`` (the interpreter and its flags) followed by ``args`` as
    ``--k=v`` flags, as both sweep CLIs build a trial's command: a None
    value is left out, ``False`` becomes ``--no_k``, ``True`` ``--k``."""
    arglist = list(head)
    for arg, value in args.items():
        if value is None:
            continue
        if value is False:
            arglist.append(f"--no_{arg}")
            continue
        if value is True:
            arglist.append(f"--{arg}")
            continue
        arglist.append(f"--{arg}={value}")
    return arglist
