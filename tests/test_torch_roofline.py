"""The port's roofline plane (``repro_torch.roofline``) and the sketch
dry run (``repro_torch.launch.sketch_dryrun``): the roofline terms equal the
reference's (``src/repro/roofline/analysis.py``) when both are given the
same peaks and the same counts, the collective record follows the
reference's ring model, the report tables render, and the dry run writes
the reference's record keys beside the measured ones on one-rank and
(2, 2) gloo meshes on the CPU."""
import json

import pytest

from repro_torch.roofline import analysis as port_rf
from repro_torch.roofline import report as port_report


def _same_peaks(monkeypatch):
    """Give the port the reference's peaks (the TPU v5e's), so the two
    formulas can be compared on the same numbers."""
    from repro.roofline import analysis as ref_rf

    monkeypatch.setitem(port_rf.HW, "peak_flops_bf16", ref_rf.HW["peak_flops_bf16"])
    monkeypatch.setitem(port_rf.HW, "hbm_bw", ref_rf.HW["hbm_bw"])
    monkeypatch.setitem(port_rf.HW, "nvlink_bw", ref_rf.HW["ici_bw"])
    return ref_rf


@pytest.mark.parametrize("flops,nbytes,coll,chips,model", [
    (1.0e12, 3.0e9, 0.0, 1, 5.0e11),
    (2.0e9, 7.5e10, 4.0e8, 4, 1.0e9),
    (0.0, 1.0e6, 2.0e7, 8, 0.0),
])
def test_roofline_terms_equal_the_references(monkeypatch, flops, nbytes, coll, chips, model):
    ref_rf = _same_peaks(monkeypatch)
    cost = {"flops": flops, "bytes accessed": nbytes}
    colls = {"all-reduce": {"count": 1, "bytes": coll}}
    mine = port_rf.roofline_from_cost(cost, colls, chips, model).to_dict()
    theirs = ref_rf.roofline_from_cost(cost, colls, chips, model).to_dict()
    assert mine.keys() == theirs.keys()
    for k in theirs:
        assert mine[k] == pytest.approx(theirs[k]) if isinstance(theirs[k], float) else mine[k] == theirs[k], k


def test_h100_peaks():
    assert port_rf.HW["peak_flops_bf16"] == 989e12
    assert port_rf.HW["peak_int8_ops"] == 1979e12
    assert port_rf.HW["hbm_bw"] == 3.35e12
    rf = port_rf.roofline_from_cost({"flops": 989e9, "bytes accessed": 3.35e9}, {}, 1, 0.0)
    assert rf.compute_s == pytest.approx(1e-3) and rf.memory_s == pytest.approx(1e-3)


@pytest.mark.parametrize("group,nbytes", [(4, 4096), (2, 1 << 20), (8, 12)])
def test_collective_record_follows_the_references_ring_model(group, nbytes):
    """An all-reduce of S bytes over g ranks: the reference parses it from
    the post-SPMD HLO, the port from the mesh's record; both 2·S·(g−1)/g."""
    from repro.roofline.analysis import parse_collectives as ref_parse

    n = nbytes // 4
    hlo = (f"  %all-reduce.1 = f32[{n}]{{0}} all-reduce(f32[{n}]{{0}} %x), "
           f"replica_groups=[1,{group}]<=[{group}], to_apply=%add")
    theirs = ref_parse(hlo)
    mine = port_rf.parse_collectives([{"op": "all_reduce", "bytes": nbytes, "group_size": group}])
    assert mine == theirs
    assert mine["all-reduce"]["bytes"] == pytest.approx(2 * nbytes * (group - 1) / group)


def test_a_group_of_one_moves_nothing():
    out = port_rf.parse_collectives([{"op": "all_reduce", "bytes": 1 << 30, "group_size": 1}])
    assert out["all-reduce"] == {"count": 1, "bytes": 0.0}


def test_mesh_keeps_a_record_of_its_all_reduces():
    import torch

    from repro_torch.analysis.contracts import one_rank_group
    from repro_torch.distributed.mesh import make_host_mesh

    with one_rank_group("cpu"):
        mesh = make_host_mesh(1, 1)
        mesh.all_reduce_(torch.ones(10), torch.distributed.ReduceOp.SUM, "data")
        mesh.all_reduce_(torch.ones(3, 4), torch.distributed.ReduceOp.MIN, ("data", "model"))
    assert [(r["op"], r["reduce"], r["bytes"], r["group_size"], r["axes"]) for r in mesh.collectives] == [
        ("all_reduce", "SUM", 40, 1, ("data",)), ("all_reduce", "MIN", 48, 1, ("data", "model"))]


def test_model_flops_keep_the_sketch_planes_formulas():
    from repro_torch.configs.glava import BASE

    assert port_rf.model_flops_for(config=BASE, batch=1 << 20) == 2.0 * 5 * (1 << 20) * (8192 + 8192)
    assert port_rf.model_flops_for(config=BASE, queries=65_536) == 2.0 * 5 * 65_536
    with pytest.raises(ValueError):
        port_rf.model_flops_for()
    # a model bundle takes the reference's formulas (tests/test_torch_dryrun.py
    # holds every cell to the reference's): 6·N·D for a train step
    from repro_torch.launch.steps import build_step

    olmo = build_step("olmo-1b", "train_4k", device="meta")
    assert port_rf.model_flops_for(olmo) == 6.0 * olmo.config.active_param_count() * 256 * 4096


def test_traced_cost_and_memory_dicts():
    from repro_torch.analysis.costlint import CostCounter

    c = CostCounter()
    c.work, c.bytes, c.alloc_bytes, c.max_alloc_bytes, c.peak_live_bytes = 10, 20, 30, 15, 25
    assert port_rf.traced_cost_dict(c) == {"flops": 10.0, "bytes accessed": 20.0, "work": 10.0}
    mem = port_rf.memory_dict(c, state_bytes=100)
    assert mem["peak_bytes_per_device_est"] == 125 and mem["max_alloc_bytes"] == 15
    assert port_rf.memory_dict(state_bytes=100, cuda_peak_bytes=7)["peak_bytes_per_device_est"] == 107


def _cell(arch, shape, mesh, status="ok", modelled=True):
    colls = {"all-reduce": {"count": 2, "bytes": 4e9}, "all-gather": {"count": 1, "bytes": 1e9}} if modelled else None
    rf = port_rf.roofline_from_cost({"flops": 1e12, "bytes accessed": 1e9}, colls and {}, 1, 5e11).to_dict()
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": status, "roofline": rf, "collectives": colls,
           "modeled_memory": {"fits_hbm": True, "modeled_total_per_device": 3e9},
           "memory": {"peak_live_bytes": 2e9}, "count_s": 1.5}
    if status == "skipped":
        rec["skip_reason"] = "does not fit one card at this shape, by a wide margin"
    return rec


def test_report_tables_render_from_a_fixture(tmp_path):
    for i, rec in enumerate([_cell("lm", "train", "pod16x16"), _cell("gnn", "infer", "pod16x16", "skipped"),
                             _cell("lm", "train", "pod2x16x16"), _cell("gnn", "train", "pod16x16", modelled=False)]):
        (tmp_path / f"cell{i}.json").write_text(json.dumps(rec))
    (tmp_path / "sketch.json").write_text(json.dumps({"cell": "glava-base/ingest_1048576", "mesh": "nccl1x1"}))
    cells = port_report.load_cells(str(tmp_path))
    assert len(cells) == 4  # the sketch-plane record is skipped
    table = port_report.roofline_table(cells)
    assert "| lm | train | 1.0ms |" in table and "**compute**" in table and "SKIP" in table
    assert "| gnn | train | 1.0ms | 299µs | not modelled | **compute** |" in table
    assert table.count("\n") == 4  # header, rule and the three pod16x16 cells
    dry = port_report.dryrun_table(cells)
    assert "| lm | train | pod2x16x16 | 1.5s | 3.00GB | 2.00GB | 3 | ok |" in dry
    assert "| gnn | train | pod16x16 | 1.5s | 3.00GB | 2.00GB | not modelled | ok |" in dry
    summary = port_report.bottleneck_summary(cells)
    assert "**lm/train**: compute-bound" in summary and "all-reduce 4.0 GB/rank over 2 ops" in summary
    assert "**gnn/train**: compute-bound (lb 1.0ms); collectives not modelled" in summary
    assert port_report.fmt_s(2.5) == "2.50s" and port_report.fmt_s(2.5e-3) == "2.5ms"


# ---------------------------------------------------------------------------
# the sketch dry run on the CPU
# ---------------------------------------------------------------------------

REF_KEYS = {"cell", "mesh", "sketch", "roofline", "collectives", "query_roofline"}
MEASURED = {"device_ms", "device_source", "events_ms", "wall_ms", "peak_alloc_bytes", "bound_ms", "fraction",
            "fraction_of", "work", "bytes", "kernels"}


@pytest.mark.parametrize("ranks,mesh", [(1, (1, 1)), (4, (2, 2))], ids=["one-rank", "2x2-gloo"])
def test_sketch_dryrun_records_on_cpu_meshes(tmp_path, ranks, mesh):
    from repro.roofline.analysis import roofline_from_cost as ref_roofline

    from repro_torch.launch.sketch_dryrun import run, summary

    rec = run("smoke", batch=2048, queries=512, ranks=ranks, mesh_shape=mesh, backend="gloo", device="cpu",
              out=tmp_path)
    assert REF_KEYS <= rec.keys() and {"measured", "query_collectives", "device"} <= rec.keys()
    assert rec["mesh"] == f"gloo{mesh[0]}x{mesh[1]}" and rec["device"] == "cpu"
    ref_keys = ref_roofline({"flops": 1.0}, {}, 1, 1.0).to_dict().keys()
    assert rec["roofline"].keys() == ref_keys and rec["query_roofline"].keys() == ref_keys
    for call in ("ingest", "query"):
        m = rec["measured"][call]
        assert m.keys() == MEASURED
        assert m["device_ms"] is None and m["device_source"] is None and m["events_ms"] is None
        assert m["peak_alloc_bytes"] is None and m["fraction_of"] == "wall"
        assert m["wall_ms"] > 0
        assert m["work"] > 0 and m["bound_ms"] > 0
    assert rec["measured"]["ingest"]["kernels"] == ["ingest_scatter"]
    assert rec["measured"]["query"]["kernels"] == ["edge_query_cells"]
    ar = rec["collectives"]["all-reduce"]
    if ranks == 1:
        assert ar["bytes"] == 0.0  # a group of one moves nothing
    else:
        # the delta over 'data' (2 ranks): 2·S/2 of a (3, 128, 256) shard
        assert ar["count"] == 1 and ar["bytes"] == pytest.approx(2 * 4 * 3 * 128 * 256 / 2)
    written = json.loads((tmp_path / f"glava__smoke__{rec['mesh']}.json").read_text())
    assert written["cell"] == "glava-smoke/ingest_2048"
    assert summary(rec).startswith("[sketch-dryrun] glava-smoke/ingest_2048 on")


def test_sketch_dryrun_refuses_web():
    from repro_torch.launch.sketch_dryrun import run

    with pytest.raises(SystemExit, match="137.5 GB"):
        run("web", device="cpu", out=None)
