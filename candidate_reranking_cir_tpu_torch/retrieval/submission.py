"""CIRR test-server submission JSON writers (an own copy of the JAX
package's ``retrieval/submission.py``).

Format parity with the reference (cirr_test_submission.py:49-70, 112-115):
  {"version": "rc2", "metric": "recall",        "<pairid>": [50 names]}
  {"version": "rc2", "metric": "recall_subset", "<pairid>": [3 group names]}
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def build_submissions(pair_ids: list, sorted_index_names: np.ndarray,
                      group_sorted_names: np.ndarray):
    """sorted_index_names: [N, >=50] global ranking (reference image removed);
    group_sorted_names: [N, >=3] group-member ranking."""
    sub = {str(int(p)): [str(x) for x in row[:50]]
           for p, row in zip(pair_ids, sorted_index_names)}
    sub_subset = {str(int(p)): [str(x) for x in row[:3]]
                  for p, row in zip(pair_ids, group_sorted_names)}
    submission = {"version": "rc2", "metric": "recall", **sub}
    group_submission = {"version": "rc2", "metric": "recall_subset",
                        **sub_subset}
    return submission, group_submission


def write_submissions(out_dir: str | Path, name: str, submission: dict,
                      group_submission: dict) -> tuple[Path, Path]:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    p1 = out_dir / f"recall_submission_{name}.json"
    p2 = out_dir / f"recall_subset_submission_{name}.json"
    # sort_keys=True for byte parity with the reference writer
    # (cirr_test_submission.py:67-71)
    p1.write_text(json.dumps(submission, sort_keys=True))
    p2.write_text(json.dumps(group_submission, sort_keys=True))
    return p1, p2
