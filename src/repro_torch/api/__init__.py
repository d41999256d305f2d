"""`repro_torch.api` — the public API of the port (port of ``src/repro/api``).

:class:`GraphStream` is the session facade (ingest, queries, sliding
windows, event time, checkpoints, WAL recovery); :class:`Query` /
:class:`QueryBatch` / :class:`QueryResult` the typed query IR;
:class:`Subscription` / :class:`SubscriptionEvent` the standing-query plane.
"""
from repro_torch.api.codec import encode_label, encode_labels
from repro_torch.api.planner import CompiledPlan, compile_batch, execute, plan
from repro_torch.api.query import (
    FAMILIES,
    ErrorBound,
    Query,
    QueryBatch,
    QueryResult,
    error_bound_for,
    validate_theta,
)
from repro_torch.api.stream import GraphStream, IngestReceipt, RecoveryReport, StreamStats
from repro_torch.api.subscription import Subscription, SubscriptionEvent
from repro_torch.core.hashing import fnv1a_labels
from repro_torch.core.sketch import SketchConfig
from repro_torch.stream.events import EventFeed, EventOverflowError
from repro_torch.stream.wal import WriteAheadLog
from repro_torch.stream.watermark import WatermarkTracker

__all__ = [
    "FAMILIES",
    "CompiledPlan",
    "ErrorBound",
    "EventFeed",
    "EventOverflowError",
    "GraphStream",
    "IngestReceipt",
    "Query",
    "QueryBatch",
    "QueryResult",
    "RecoveryReport",
    "SketchConfig",
    "StreamStats",
    "Subscription",
    "SubscriptionEvent",
    "WatermarkTracker",
    "WriteAheadLog",
    "compile_batch",
    "encode_label",
    "encode_labels",
    "error_bound_for",
    "execute",
    "fnv1a_labels",
    "plan",
    "validate_theta",
]
