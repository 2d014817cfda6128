"""The comparison that decides ``correct``.

A top-k list is judged against the plain reference by two gaps, each as a
share of the magnitude of the list's best reference score:

* ``score_gap``: how far the score the program reports for a document lies
  from the reference's score of that document;
* ``rank_gap``: how far the reference's score of the document the program
  puts at rank r lies below the reference's r-th best score (a missing,
  extra or misordered document shows here; a different order of tied
  documents does not).

A list with an id outside the collection, an id twice, or fewer documents
than the reference has, reads ``inf``. ``stats_diff`` counts the collection
statistics that differ; ``unanswered`` counts what never came back.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Reading:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit

    def line(self) -> str:
        return f"check {self.name} {self.value!r} limit {self.limit!r} " + (
            "ok" if self.ok else "FAIL")

    def as_json(self) -> dict:
        v = self.value if math.isfinite(self.value) else 1e308
        return {"value": v, "limit": self.limit}


def topk_gaps(prog_ids, prog_scores, ref_scores, ref_of_prog, n_docs: int) -> tuple[float, float]:
    """``(score_gap, rank_gap)`` over lists ``[..., k]`` (numpy)."""
    ids = np.asarray(prog_ids, np.int64).reshape(-1, np.shape(prog_ids)[-1])
    ps = np.asarray(prog_scores, np.float64).reshape(ids.shape)
    rs = np.asarray(ref_scores, np.float64).reshape(ids.shape)
    rp = np.asarray(ref_of_prog, np.float64).reshape(ids.shape)
    valid = (ids >= 0) & (ids < n_docs)
    ref_valid = np.isfinite(rs)
    srt = np.sort(np.where(valid, ids, -1), axis=1)
    twice = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(1)
    short = (ref_valid & ~valid).any(1)
    if (twice | short).any() or (valid & ~np.isfinite(ps)).any():
        return INF, INF
    scale = np.maximum(np.abs(np.where(ref_valid[:, :1], rs[:, :1], 0.0)), 1e-30)
    score_gap = np.where(valid, np.abs(ps - rp), 0.0) / scale
    rank_gap = np.where(valid & ref_valid, np.maximum(rs - rp, 0.0), 0.0) / scale
    return float(score_gap.max(initial=0.0)), float(rank_gap.max(initial=0.0))


def stats_diff(prog: dict, ref: dict) -> int:
    """Entries of cf, df, total, n_docs and the float32 mean length that
    differ (``prog``/``ref``: numpy arrays and numbers)."""
    n = int((np.asarray(prog["cf"], np.int64) != np.asarray(ref["cf"], np.int64)).sum())
    n += int((np.asarray(prog["df"], np.int64) != np.asarray(ref["df"], np.int64)).sum())
    n += int(int(prog["total"]) != int(ref["total"]))
    n += int(int(prog["n_docs"]) != int(ref["n_docs"]))
    n += int(np.float32(prog["avg"]).tobytes() != np.float32(ref["avg"]).tobytes())
    return n
