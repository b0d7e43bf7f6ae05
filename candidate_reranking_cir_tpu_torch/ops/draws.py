"""Dropout draws that do not depend on how many ranks share a batch.

JAX's mesh train step is one global program, so its dropout masks are
the same whatever the number of chips. A rank of the port computes a
block of the global batch; inside ``sharded_draws`` its masks are the
global masks' block, bit for bit:

- generator dropout (``models/layers.py::Dropout`` and ``drop_path``, the
  plain attention's ``_dropout_probs``): ``uniform`` draws at the global
  shape, with the sharded axis at its global length, and keeps this
  rank's block;
- the in-kernel hash (K5 inside K6-K9) is keyed by the absolute entry
  index, salt = lowbias32(seed + entry * 0x101 + head): ``entry_seed``
  adds start * 0x101 to the seed (wrapped to int32), so that the rank's
  entry 0 hashes as global entry ``start``. It applies to a call whose
  entries are the sharded axis (``local`` of them); any other call raises,
  since no seed shift can key it as the global call.

Outside the context both are the one-card draws. ``bound`` carries the
context a forward ran under into its recomputation in backward (remat).
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch

_INT32 = 2 ** 32


@dataclass(frozen=True)
class _Spec:
    axis: int       # the sharded axis of every draw of >= min_ndim dims
    start: int      # this rank's first index on it
    local: int      # this rank's length on it
    total: int      # its global length
    min_ndim: int   # draws of fewer dimensions are not sharded


_SPEC: contextvars.ContextVar = contextvars.ContextVar("draw_shard",
                                                       default=None)


@contextlib.contextmanager
def sharded_draws(axis: int, start: int, local: int, total: int,
                  min_ndim: int = 0):
    """Inside the block, draws of at least ``min_ndim`` dimensions are the
    block [start, start + local) on ``axis`` of the draw at the global
    length ``total``; kernel calls of ``local`` entries hash as entries
    start.. of the global call."""
    token = _SPEC.set(_Spec(axis, start, local, total, min_ndim))
    try:
        yield
    finally:
        _SPEC.reset(token)


def bound(fn):
    """``fn`` to be run, wherever it is called later (a remat
    recomputation inside backward), under the draws in force now."""
    spec = _SPEC.get()

    def run(*args, **kwargs):
        token = _SPEC.set(spec)
        try:
            return fn(*args, **kwargs)
        finally:
            _SPEC.reset(token)

    return run


def uniform(shape, generator, device) -> torch.Tensor:
    """U[0, 1) of ``shape`` from ``generator`` on ``device``: the rank's
    block of the global draw inside ``sharded_draws``."""
    spec = _SPEC.get()
    shape = tuple(shape)
    if spec is None or len(shape) < max(spec.min_ndim, spec.axis + 1):
        return torch.rand(shape, generator=generator, device=device)
    if shape[spec.axis] != spec.local:
        raise ValueError(
            f"a draw of shape {shape} does not hold this rank's "
            f"{spec.local} rows on axis {spec.axis}")
    full = list(shape)
    full[spec.axis] = spec.total
    draw = torch.rand(full, generator=generator, device=device)
    return draw.narrow(spec.axis, spec.start, spec.local)


def entry_seed(seed: int, entries: int) -> int:
    """The seed a kernel call of ``entries`` entries takes so that its
    mask is the global call's block (``seed`` itself outside
    ``sharded_draws``)."""
    spec = _SPEC.get()
    if spec is None or spec.start == 0 and spec.local == spec.total:
        return seed
    if entries != spec.local:
        raise NotImplementedError(
            f"an in-kernel dropout call over {entries} entries inside a "
            f"rank's block of {spec.local}: its mask would depend on the "
            "world size")
    shifted = (seed + spec.start * 0x101) % _INT32
    return shifted - _INT32 if shifted >= 2 ** 31 else shifted
