"""Host-process hygiene (own copy of the JAX package's
``runtime/host.py::limit_numpy_threads``).

The reference clamps BLAS/OpenMP thread pools at the top of every entry
script (stage1_train.py:6-11) so numpy does not oversubscribe the host
while the card works. Each CLI calls it first; it only sets variables the
environment does not set already.
"""
from __future__ import annotations

import os

_THREAD_VARS = ("OPENBLAS_NUM_THREADS", "GOTO_NUM_THREADS", "MKL_NUM_THREADS",
                "NUMEXPR_NUM_THREADS", "OMP_NUM_THREADS")


def limit_numpy_threads(n: int = 8) -> None:
    for var in _THREAD_VARS:
        os.environ.setdefault(var, str(n))
