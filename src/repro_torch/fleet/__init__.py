"""Multi-tenant fleet serving: T per-tenant gLava sketches, one device
dispatch per mixed batch (port of ``src/repro/fleet``, DESIGN.md Section 11).

    from repro_torch.fleet import SketchFleet

    fleet = SketchFleet.open("smoke", capacity=64, seed=0)   # device="cpu" to opt out
    fleet.tenant("acme").ingest(src, dst)
    fleet.ingest_mixed(tenant_ids, src, dst)          # the fleet hot path
    res = fleet.tenant("acme").query(Query.edge("a", "b"))

The reference's ``pad_grouped`` fed its jit cache and has no counterpart.
"""
from repro_torch.fleet.ingest import FleetIngestEngine, group_stream
from repro_torch.fleet.query import FleetQueryEngine
from repro_torch.fleet.session import FleetStats, SketchFleet, TenantSession
from repro_torch.fleet.stack import FleetSketch

__all__ = [
    "FleetIngestEngine",
    "FleetQueryEngine",
    "FleetSketch",
    "FleetStats",
    "SketchFleet",
    "TenantSession",
    "group_stream",
]
