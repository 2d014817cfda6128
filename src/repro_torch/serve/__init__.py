"""Streaming retrieval service: admission, microbatching, resident sessions.

The port's copy of `repro.serve`. The control plane (microbatch, admission,
policy, loadgen, bench, service) is the reference's numpy code; the
sessions hold their corpus on the card and scan with the port's kernels.

Public surface:

* :class:`~repro_torch.serve.service.RetrievalService` — submit/poll/drain facade
  (``try_submit`` for typed admission outcomes).
* :class:`~repro_torch.serve.session.LexicalSession` /
  :class:`~repro_torch.serve.session.DenseSession` — resident-corpus scan state.
* :class:`~repro_torch.serve.session.ShardedLexicalSession` — waits for the
  mesh slice (raises ``NotImplementedError``).
* :class:`~repro_torch.serve.microbatch.Microbatcher` — deadline/size triggers +
  bucket padding, capped ladder (importable standalone for tests).
* :class:`~repro_torch.serve.admission.AdmissionController` — bounded queue,
  per-tenant token buckets, QoS lanes; typed Admitted/Shed/Blocked.
* :class:`~repro_torch.serve.policy.AdaptiveBatchPolicy` — the SLO closed loop
  over the microbatch triggers.
* :mod:`repro_torch.serve.loadgen` — open-loop sustained-load generation on a
  virtual clock (Poisson/burst schedules, metered sessions).
* :mod:`repro_torch.serve.bench` — the C1 batch-size/latency sweep.
"""

from repro_torch.serve.admission import (
    Admitted,
    AdmissionController,
    Blocked,
    Shed,
    TokenBucket,
)
from repro_torch.serve.loadgen import (
    MeteredSession,
    OpenLoopResult,
    VirtualClock,
    burst_schedule,
    poisson_schedule,
    run_open_loop,
)
from repro_torch.serve.microbatch import Microbatcher, QueryBlock, SearchRequest
from repro_torch.serve.policy import AdaptiveBatchPolicy
from repro_torch.serve.service import (
    BatchRecord,
    RejectedError,
    RetrievalService,
    SearchResult,
)
from repro_torch.serve.session import DenseSession, LexicalSession, ShardedLexicalSession

__all__ = [
    "AdaptiveBatchPolicy",
    "Admitted",
    "AdmissionController",
    "BatchRecord",
    "Blocked",
    "DenseSession",
    "LexicalSession",
    "MeteredSession",
    "Microbatcher",
    "OpenLoopResult",
    "QueryBlock",
    "RejectedError",
    "RetrievalService",
    "SearchRequest",
    "SearchResult",
    "ShardedLexicalSession",
    "Shed",
    "TokenBucket",
    "VirtualClock",
    "burst_schedule",
    "poisson_schedule",
    "run_open_loop",
]
