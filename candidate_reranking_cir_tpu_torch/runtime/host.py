"""Host-process hygiene (own copy of the JAX package's
``runtime/host.py::limit_numpy_threads`` and ``GracefulShutdown``).

The reference clamps BLAS/OpenMP thread pools at the top of every entry
script (stage1_train.py:6-11) so numpy does not oversubscribe the host
while the card works. Each CLI calls it first; it only sets variables the
environment does not set already.

The JAX package's ``enable_compilation_cache`` points XLA's persistent
compilation cache at a host directory; the port compiles no XLA programs.
Its counterpart is the kernel build cache of ``ops/build.py``: each CUDA
library is built once per source hash into the package's ``_build/``.
"""
from __future__ import annotations

import os
import signal

_THREAD_VARS = ("OPENBLAS_NUM_THREADS", "GOTO_NUM_THREADS", "MKL_NUM_THREADS",
                "NUMEXPR_NUM_THREADS", "OMP_NUM_THREADS")


def limit_numpy_threads(n: int = 8) -> None:
    for var in _THREAD_VARS:
        os.environ.setdefault(var, str(n))


class GracefulShutdown:
    """Preemption handling for the trainers: SIGTERM/SIGINT set a flag
    instead of killing the process, so the train loop finishes its current
    step, saves a resumable checkpoint (with the count of batches already
    applied in the interrupted epoch) and returns. ``--resume`` restores
    the full train state and skips the applied batches, so a preempted run
    loses nothing: no batch is applied twice and the step-indexed LR
    schedule and dropout seeds stay exact.

    Usage:
        stop = GracefulShutdown()
        for batch in loader:
            ...
            if stop.requested:
                save_checkpoint(...); break
        stop.restore()
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self.signal_name = None
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):
                pass  # not the main thread, or an unsupported signal: inert

    def _handler(self, signum, frame):
        self.requested = True
        self.signal_name = signal.Signals(signum).name
        print(f"[{self.signal_name}] finishing current step, then saving a "
              "resumable checkpoint...", flush=True)

    def restore(self):
        """Put back the handlers that were in place before."""
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
