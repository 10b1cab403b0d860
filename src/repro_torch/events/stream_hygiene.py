"""Adversarial stream hygiene: validate event chunks before they vote.

Counterpart of `repro.events.stream_hygiene`. `StreamHygiene` is the
per-session guard the streaming engine puts in front of the aggregator.
Each chunk is checked against an event-time watermark (the last timestamp
the stream has committed) for intra-chunk non-monotone timestamps,
regression behind prior pushes, exact-duplicate chunks (a SHA-1 digest
matched against a bounded history of accepted chunks), out-of-bounds
coordinates on events marked valid (parked invalid events are exempt) and
hot-pixel storms (a per-pixel rate limit over tumbling time windows, off
by default).

`HygieneConfig.policy` says what an offense does:

  * `"raise"` (default) — reject the chunk atomically with a typed error
    (`NonMonotoneEventError`, `StreamOverlapError`, `DuplicateChunkError`,
    `OutOfBoundsEventError`, `HotPixelError`; all `StreamHygieneError`, a
    `ValueError`) naming the first offending index; the guard's state is
    untouched;
  * `"drop"` — warn (`StreamHygieneWarning`) and discard exactly the
    offending events (a whole duplicate chunk), counted in `stats`;
  * `"reorder"` — a bounded reorder buffer releases events once the
    stream's maximum time is `reorder_slack` seconds past them, in stable
    time order: bit-identical to a pre-sorted stream for any misordering
    within the slack. Other offenses still raise;
  * `"off"` — check nothing.

The guard runs on the host over numpy (chunks may arrive as numpy arrays or
as tensors on any device and are copied to the host once) and returns host
numpy `EventStream`s. `check_chunk_monotone` is the standalone sorted/
contiguous check `StreamingAggregator.push` applies as a backstop.
"""
from __future__ import annotations

import dataclasses
import hashlib
import warnings

import numpy as np
from repro_torch.device import to_host
from repro_torch.events.simulator import EventStream

HYGIENE_POLICIES = ("off", "raise", "drop", "reorder")


class StreamHygieneError(ValueError):
    """Base of every typed ingest-hygiene offense (a `ValueError`)."""


class NonMonotoneEventError(StreamHygieneError):
    """Timestamps within one chunk go backwards."""


class StreamOverlapError(StreamHygieneError):
    """A chunk regresses into (overlaps) time already committed."""


class DuplicateChunkError(StreamHygieneError):
    """A chunk is an exact byte-for-byte replay of a recent chunk."""


class OutOfBoundsEventError(StreamHygieneError):
    """An event marked valid lies outside the sensor array."""


class HotPixelError(StreamHygieneError):
    """A pixel exceeded the configured per-window event-rate limit."""


class StreamHygieneWarning(UserWarning):
    """Offending events were discarded under the "drop" policy."""


@dataclasses.dataclass(frozen=True)
class HygieneConfig:
    """Policy + knobs of the ingest guard (see the module docstring).

    `policy` picks the response to an offense ("off" / "raise" / "drop"
    / "reorder"). `reorder_slack` (seconds) bounds how far back the
    "reorder" buffer can restore order: an event is released once the
    stream's max observed time is `reorder_slack` ahead of it, so any
    misordering displaced by at most the slack is absorbed; 0.0 still
    fixes intra-chunk shuffles (each push sorts before releasing) but
    cannot absorb late chunks. `hot_pixel_limit` is the max events one
    pixel may emit per `hot_pixel_window` seconds (tumbling windows;
    None disables the guard — the right threshold depends on the scene
    and sensor). `duplicate_history` bounds how many recently accepted
    chunk digests are remembered for exact-duplicate detection.
    """

    policy: str = "raise"
    reorder_slack: float = 0.0
    hot_pixel_limit: int | None = None
    hot_pixel_window: float = 0.05
    duplicate_history: int = 8

    def __post_init__(self):
        if self.policy not in HYGIENE_POLICIES:
            raise ValueError(
                f"unknown hygiene policy {self.policy!r}: expected one of "
                f"{HYGIENE_POLICIES}")
        if self.reorder_slack < 0.0:
            raise ValueError(
                f"reorder_slack must be >= 0, got {self.reorder_slack}")
        if self.hot_pixel_limit is not None and self.hot_pixel_limit < 1:
            raise ValueError(
                f"hot_pixel_limit must be >= 1 (or None to disable), got "
                f"{self.hot_pixel_limit}")
        if self.hot_pixel_window <= 0.0:
            raise ValueError(
                f"hot_pixel_window must be > 0, got {self.hot_pixel_window}")
        if self.duplicate_history < 1:
            raise ValueError(
                f"duplicate_history must be >= 1, got "
                f"{self.duplicate_history}")


def empty_event_stream() -> EventStream:
    """A zero-event host-side EventStream."""
    return EventStream(xy=np.zeros((0, 2), np.float32),
                       t=np.zeros((0,), np.float32),
                       polarity=np.zeros((0,), np.int8),
                       valid=np.zeros((0,), bool))


def check_chunk_monotone(t: np.ndarray, last_t: float,
                         context: str = "event chunk") -> None:
    """Reject a chunk whose timestamps regress, naming the first offender.

    `t` must be non-decreasing and start no earlier than `last_t` (the
    final timestamp of the previous chunk; -inf for the first). This is
    the sorted/contiguous contract `StreamingAggregator.push` documents,
    enforced instead of assumed: index 0 regressing is an overlap with
    prior pushes (`StreamOverlapError`), a later index is an intra-chunk
    misordering (`NonMonotoneEventError`) — both are `ValueError`s.
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


def _host_chunk(chunk: EventStream) -> EventStream:
    """The chunk's fields as host numpy arrays (one copy from a device)."""
    return EventStream(xy=to_host(chunk.xy, np.float32),
                       t=to_host(chunk.t, np.float32),
                       polarity=to_host(chunk.polarity, np.int8),
                       valid=to_host(chunk.valid, bool))


def _take(chunk: EventStream, sel) -> EventStream:
    return EventStream(xy=chunk.xy[sel], t=chunk.t[sel],
                       polarity=chunk.polarity[sel], valid=chunk.valid[sel])


def _concat(a: EventStream, b: EventStream) -> EventStream:
    return EventStream(xy=np.concatenate([a.xy, b.xy]),
                       t=np.concatenate([a.t, b.t]),
                       polarity=np.concatenate([a.polarity, b.polarity]),
                       valid=np.concatenate([a.valid, b.valid]))


class StreamHygiene:
    """Stateful per-stream ingest guard (see the module docstring).

    `scrub(chunk)` returns the events cleared for aggregation as a
    host-side `EventStream` — possibly fewer than pushed ("drop"
    discards offenders; "reorder" holds events inside the slack window)
    and, under "reorder", possibly *more* (previously held events whose
    release time has come ride out in front, in time order). `flush()`
    drains whatever the reorder buffer still holds. Offenses follow the
    policy; a raise leaves the guard's state untouched (the offending
    chunk is rejected atomically).
    """

    def __init__(self, cfg: HygieneConfig | str = "raise", *,
                 width: int | None = None, height: int | None = None):
        if isinstance(cfg, str):
            cfg = HygieneConfig(policy=cfg)
        self.cfg = cfg
        self.width = width
        self.height = height
        # last committed event time: everything at/after it is still legal
        self.watermark = float("-inf")
        self._digests: list[bytes] = []  # recently accepted chunk digests
        # reorder buffer (policy="reorder"): held events, kept time-sorted
        self._held = empty_event_stream()
        # hot-pixel guard: (window, pixel) -> events seen, pruned as the
        # window index advances so memory tracks the window, not the stream
        self._px_counts: dict[int, int] = {}
        self._px_window = -1
        self.stats = {
            "chunks": 0,
            "events_in": 0,
            "events_out": 0,
            "dropped_out_of_order": 0,
            "dropped_duplicate_chunks": 0,
            "dropped_duplicate_events": 0,
            "dropped_out_of_bounds": 0,
            "dropped_hot_pixel": 0,
            "reorder_held_events": 0,
            "reorder_peak_held": 0,
        }

    # --- offense detectors (pure, state-mutation-free) --------------------

    def _digest(self, chunk: EventStream) -> bytes:
        h = hashlib.sha1()
        for field in (chunk.xy, chunk.t, chunk.polarity, chunk.valid):
            h.update(np.ascontiguousarray(field).tobytes())
        return h.digest()

    def _oob_mask(self, chunk: EventStream) -> np.ndarray:
        """True per event marked valid whose coords lie off the sensor."""
        if self.width is None or self.height is None:
            return np.zeros(chunk.t.shape[0], bool)
        x, y = chunk.xy[:, 0], chunk.xy[:, 1]
        off = ((x < 0) | (x > self.width - 1) | (y < 0)
               | (y > self.height - 1) | ~np.isfinite(x) | ~np.isfinite(y))
        return off & chunk.valid

    def _hot_pixel_mask(self, chunk: EventStream,
                        commit: bool) -> np.ndarray:
        """True per event that exceeds its pixel's per-window budget.

        Events are keyed by (tumbling time window, integer pixel); each
        key's running count carries across chunks. The first
        `hot_pixel_limit` events of a key pass, the excess offend — so
        under "drop" a storm is shed down to the budget while the
        healthy pixels' events are untouched. With `commit` the
        surviving counts are folded into the guard's state (set False
        while probing under "raise", where the chunk may be rejected).
        """
        lim = self.cfg.hot_pixel_limit
        n = chunk.t.shape[0]
        if lim is None or n == 0 or self.width is None:
            return np.zeros(n, bool)
        win = np.floor_divide(chunk.t, np.float32(self.cfg.hot_pixel_window)
                              ).astype(np.int64)
        xi = np.clip(np.round(chunk.xy[:, 0]), 0, self.width - 1).astype(
            np.int64)
        yi = np.clip(np.round(chunk.xy[:, 1]), 0, self.height - 1).astype(
            np.int64)
        key = (win * self.height + yi) * self.width + xi
        # occurrence index of each event within its key, in arrival order
        order = np.argsort(key, kind="stable")
        ks = key[order]
        starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        occ_sorted = np.arange(n) - np.repeat(
            starts, np.diff(np.r_[starts, n]))
        occ = np.empty(n, np.int64)
        occ[order] = occ_sorted
        carry = np.asarray([self._px_counts.get(int(k), 0) for k in key],
                           np.int64)
        mask = (occ + carry) >= lim
        mask &= chunk.valid  # parked/invalid events never count
        if commit and n:
            ok = chunk.valid & ~mask
            if ok.any():
                uk, inv = np.unique(key[ok], return_inverse=True)
                added = np.bincount(inv)
                for k, a in zip(uk.tolist(), added.tolist()):
                    self._px_counts[k] = min(
                        self._px_counts.get(k, 0) + int(a), lim)
            w_max = int(win.max())
            if w_max > self._px_window:
                self._px_window = w_max
                floor = (w_max - 1) * self.height * self.width
                self._px_counts = {k: v for k, v in self._px_counts.items()
                                   if k >= floor}
        return mask

    # --- the guard --------------------------------------------------------

    def scrub(self, chunk: EventStream) -> EventStream:
        """Validate one chunk; return the events cleared for aggregation."""
        chunk = _host_chunk(chunk)
        n = chunk.t.shape[0]
        self.stats["chunks"] += 1
        self.stats["events_in"] += n
        policy = self.cfg.policy
        if policy == "off" or n == 0:
            out = self._release(chunk) if policy == "reorder" else chunk
            self.stats["events_out"] += out.t.shape[0]
            if out.t.shape[0] and policy == "off":
                self.watermark = max(self.watermark, float(out.t[-1]))
            return out
        digest = self._digest(chunk)
        duplicate = digest in self._digests
        if policy == "raise" or policy == "reorder":
            out = self._strict(chunk, digest, duplicate,
                               reorder=(policy == "reorder"))
        else:
            out = self._drop(chunk, digest, duplicate)
        self.stats["events_out"] += out.t.shape[0]
        return out

    def flush(self) -> EventStream:
        """Drain the reorder buffer (end of stream); empty otherwise."""
        held, self._held = self._held, empty_event_stream()
        self.stats["reorder_held_events"] = 0
        if held.t.shape[0]:
            self.watermark = max(self.watermark, float(held.t[-1]))
            self.stats["events_out"] += held.t.shape[0]
        return held

    def _remember(self, digest: bytes) -> None:
        self._digests.append(digest)
        if len(self._digests) > self.cfg.duplicate_history:
            self._digests.pop(0)

    def _strict(self, chunk: EventStream, digest: bytes, duplicate: bool,
                reorder: bool) -> EventStream:
        """"raise" (and the non-ordering offenses of "reorder"): typed
        errors, chunk rejected atomically — no state has been touched
        when an error propagates."""
        if duplicate:
            raise DuplicateChunkError(
                f"exact-duplicate chunk: {chunk.t.shape[0]} event(s) "
                f"spanning t=[{float(chunk.t[0]):.6g}, "
                f"{float(chunk.t[-1]):.6g}] byte-identically repeat a chunk "
                f"accepted within the last {len(self._digests)} push(es)")
        oob = self._oob_mask(chunk)
        if oob.any():
            i = int(np.argmax(oob))
            raise OutOfBoundsEventError(
                f"out-of-bounds event: event {i} marked valid at "
                f"xy=({float(chunk.xy[i, 0]):.6g}, "
                f"{float(chunk.xy[i, 1]):.6g}) lies outside the "
                f"{self.width}x{self.height} sensor array")
        if not reorder:
            check_chunk_monotone(chunk.t, self.watermark)
            hot = self._hot_pixel_mask(chunk, commit=False)
            if hot.any():
                i = int(np.argmax(hot))
                raise HotPixelError(
                    f"hot-pixel storm: event {i} at "
                    f"xy=({float(chunk.xy[i, 0]):.6g}, "
                    f"{float(chunk.xy[i, 1]):.6g}) exceeds "
                    f"{self.cfg.hot_pixel_limit} events/pixel per "
                    f"{self.cfg.hot_pixel_window:.6g}s window")
            self._hot_pixel_mask(chunk, commit=True)
            self._remember(digest)
            self.watermark = float(chunk.t[-1])
            return chunk
        # reorder: ordering offenses are absorbed by the buffer instead
        released = np.flatnonzero(chunk.t < self.watermark)
        if released.size:
            i = int(released[0])
            raise StreamOverlapError(
                f"reorder window exceeded: event {i} at "
                f"t={float(chunk.t[i]):.6g} arrives behind the release "
                f"watermark t={self.watermark:.6g} — its slot was already "
                f"released under reorder_slack="
                f"{self.cfg.reorder_slack:.6g}s; increase the slack or "
                f"fix the transport")
        hot = self._hot_pixel_mask(chunk, commit=False)
        if hot.any():
            i = int(np.argmax(hot))
            raise HotPixelError(
                f"hot-pixel storm: event {i} at "
                f"xy=({float(chunk.xy[i, 0]):.6g}, "
                f"{float(chunk.xy[i, 1]):.6g}) exceeds "
                f"{self.cfg.hot_pixel_limit} events/pixel per "
                f"{self.cfg.hot_pixel_window:.6g}s window")
        self._hot_pixel_mask(chunk, commit=True)
        self._remember(digest)
        return self._release(chunk)

    def _release(self, chunk: EventStream) -> EventStream:
        """Merge `chunk` into the reorder buffer (stable time sort) and
        release everything `reorder_slack` behind the max observed time.

        Released events are bit-identical to a pre-sorted stream for any
        misordering whose displacement fits the slack: a stable sort of
        arrival order reproduces the original sequence, and the release
        point only moves forward.
        """
        merged = _concat(self._held, chunk)
        if merged.t.shape[0] == 0:
            return merged
        order = np.argsort(merged.t, kind="stable")
        merged = _take(merged, order)
        horizon = float(merged.t[-1]) - self.cfg.reorder_slack
        cut = int(np.searchsorted(merged.t, np.float32(horizon),
                                  side="right"))
        out = _take(merged, slice(0, cut))
        self._held = _take(merged, slice(cut, merged.t.shape[0]))
        n_held = self._held.t.shape[0]
        self.stats["reorder_held_events"] = n_held
        self.stats["reorder_peak_held"] = max(
            self.stats["reorder_peak_held"], n_held)
        if out.t.shape[0]:
            self.watermark = max(self.watermark, float(out.t[-1]))
        return out

    def _drop(self, chunk: EventStream, digest: bytes,
              duplicate: bool) -> EventStream:
        """"drop": discard exactly the offending events, warn, count."""
        n = chunk.t.shape[0]
        if duplicate:
            self.stats["dropped_duplicate_chunks"] += 1
            self.stats["dropped_duplicate_events"] += n
            warnings.warn(
                f"dropped exact-duplicate chunk of {n} event(s)",
                StreamHygieneWarning, stacklevel=3)
            return empty_event_stream()
        keep = np.ones(n, bool)
        oob = self._oob_mask(chunk)
        keep &= ~oob
        # shed misordered events: keep the longest non-decreasing-from-
        # watermark subsequence an online filter can (each survivor must
        # not precede any earlier arrival or the committed watermark)
        prefix = np.maximum.accumulate(
            np.r_[np.float32(self.watermark), chunk.t[:-1]])
        in_order = chunk.t >= prefix
        keep &= in_order
        hot = np.zeros(n, bool)
        if keep.any():
            survivors = _take(chunk, keep)
            hot_s = self._hot_pixel_mask(survivors, commit=True)
            hot[np.flatnonzero(keep)] = hot_s
            keep &= ~hot
        n_oob = int(oob.sum())
        n_ooo = int((~in_order & ~oob).sum())
        n_hot = int(hot.sum())
        self.stats["dropped_out_of_bounds"] += n_oob
        self.stats["dropped_out_of_order"] += n_ooo
        self.stats["dropped_hot_pixel"] += n_hot
        dropped = n_oob + n_ooo + n_hot
        if dropped:
            parts = [f"{c} {what}" for c, what in (
                (n_ooo, "out-of-order"), (n_oob, "out-of-bounds"),
                (n_hot, "hot-pixel")) if c]
            warnings.warn(
                f"dropped {dropped} offending event(s) of {n}: "
                + ", ".join(parts), StreamHygieneWarning, stacklevel=3)
        self._remember(digest)
        out = _take(chunk, keep)
        if out.t.shape[0]:
            self.watermark = float(out.t[-1])
        return out
