"""Ingest hygiene, in PyTorch's port: the sorted/contiguous chunk check.

Counterpart of the part of `repro.events.stream_hygiene` that
`StreamingAggregator.push` needs (`check_chunk_monotone` and its typed
errors); the tolerant `StreamHygiene` policies are not ported yet.
"""
from __future__ import annotations

import numpy as np


class StreamHygieneError(ValueError):
    """Base of every typed ingest-hygiene offense (a `ValueError`)."""


class NonMonotoneEventError(StreamHygieneError):
    """Timestamps within one chunk go backwards."""


class StreamOverlapError(StreamHygieneError):
    """A chunk regresses into (overlaps) time already committed."""


def check_chunk_monotone(t: np.ndarray, last_t: float,
                         context: str = "event chunk") -> None:
    """Reject a chunk whose timestamps regress, naming the first offender.

    `t` must be non-decreasing and start no earlier than `last_t` (the
    final timestamp of the previous chunk; -inf for the first).
    """
    t = np.asarray(t)
    if t.shape[0] == 0:
        return
    prev = np.empty_like(t)
    prev[0] = last_t
    prev[1:] = t[:-1]
    bad = np.nonzero(t < prev)[0]
    if bad.size == 0:
        return
    i = int(bad[0])
    if i == 0:
        raise StreamOverlapError(
            f"{context}: event 0 at t={float(t[0]):.6g} regresses behind "
            f"the stream watermark t={float(last_t):.6g} — the chunk "
            f"overlaps (or repeats) time already committed by prior pushes")
    raise NonMonotoneEventError(
        f"{context}: non-monotone timestamps — event {i} at "
        f"t={float(t[i]):.6g} precedes event {i - 1} at "
        f"t={float(t[i - 1]):.6g}")
