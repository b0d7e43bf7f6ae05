"""Experiment tracking (own copy of the JAX package's
``runtime/logging.py``): CSV logs and optional Comet, the reference's
three sinks (stage1_train.py:561-581, 203-206).

- ``MetricsLogger`` appends rows to train_metrics.csv and
  validation_metrics.csv (the reference's file names) and writes the
  hyperparameters to <training_path>/<experiment_name>.json
  (stage1_train.py:59-60).
- Comet is optional: made only when an API key is given, else a no-op
  stub, as the reference's disabled experiment.
"""
from __future__ import annotations

import contextlib
import csv
import json
from pathlib import Path


class CometStub:
    def log_metric(self, *a, **k):
        pass

    def log_parameters(self, *a, **k):
        pass

    def log_code(self, *a, **k):
        pass

    def train(self):
        return contextlib.nullcontext()

    validate = train


def make_comet(api_key: str | None, workspace: str | None,
               project_name: str, experiment_name: str):
    if not api_key:
        return CometStub()
    try:
        import comet_ml

        exp = comet_ml.Experiment(api_key=api_key, workspace=workspace,
                                  project_name=project_name)
        exp.set_name(experiment_name)
        return exp
    except Exception as e:  # comet not installed, or offline
        print(f"comet disabled ({e}); falling back to CSV-only logging")
        return CometStub()


class MetricsLogger:
    def __init__(self, training_path: str | Path, experiment_name: str,
                 hyperparams: dict | None = None):
        self.path = Path(training_path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.train_csv = self.path / "train_metrics.csv"
        self.val_csv = self.path / "validation_metrics.csv"
        if hyperparams is not None:
            (self.path / f"{experiment_name}.json").write_text(
                json.dumps(hyperparams, indent=4, sort_keys=True, default=str))

    def _append(self, path: Path, row: dict):
        exists = path.exists()
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row.keys()))
            if not exists:
                w.writeheader()
            w.writerow(row)

    def log_train(self, **row):
        self._append(self.train_csv, row)

    def log_validation(self, **row):
        self._append(self.val_csv, row)
