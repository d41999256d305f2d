"""Parity of the port's bundle dry run (``src/repro_torch/launch/dryrun.py``,
``launch/perf.py`` and the bundle half of ``roofline/analysis.py::
model_flops_for``) with ``src/repro/launch/dryrun.py``,
``src/repro/launch/perf.py`` and ``src/repro/roofline/analysis.py:265-352``.

``model_flops_for`` of every live cell's bundle equals the reference's (the
same arithmetic on the same shapes: exact).  The depth extrapolation's fit
equals a direct count at depth 4 (SMOKE widths at the full shapes, on
``meta``): the layers are identical, so the work and the bytes are affine
in the depth, exactly.  ``modeled_memory``'s state and input bytes on
``pod16x16`` equal the reference's ``resolve_pspec`` specs applied to the
reference's shapes, and the remat carry its formula
(``src/repro/launch/dryrun.py:57``); on ``pod2x16x16`` the port divides by
the mesh's own dp size where the reference divides by 16 (ROADMAP §C).
The CLI over every cell and both meshes records each live cell ``ok``,
with its collectives ``null`` (not modelled), never a collective term of
0 s.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest

from repro.configs import load_all as ref_load_all
from repro.distributed import sharding as ref_sh
from repro.launch import steps as ref_steps
from repro.roofline import analysis as ref_rf
from repro_torch.configs import all_cells, get_arch
from repro_torch.distributed.sharding import ResolveReport, resolve_tree
from repro_torch.launch import dryrun, perf
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step
from repro_torch.roofline.analysis import model_flops_for


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


@pytest.fixture(scope="module")
def ref_bundles():
    ref_load_all()
    return {cell: ref_steps.build_step(*cell, smoke=False) for cell in all_cells()}


def test_model_flops_equal_the_reference_for_every_cell(ref_bundles):
    for cell, ref in ref_bundles.items():
        port = build_step(*cell, device="meta")
        assert model_flops_for(port) == ref_rf.model_flops_for(ref), cell


@pytest.mark.parametrize("arch,shape", [("olmo-1b", "train_4k"), ("mixtral-8x22b", "prefill_32k"),
                                        ("qwen3-4b", "decode_32k")])
def test_depth_extrapolation_equals_a_direct_count(monkeypatch, arch, shape):
    smoke4 = dataclasses.replace(get_arch(arch).smoke_config, n_layers=4)
    real = get_arch(arch)
    monkeypatch.setattr(dryrun, "get_arch", lambda a: dataclasses.replace(real, config=smoke4))
    fit, colls, detail = dryrun.extrapolate_lm_cost(arch, shape, make_production_mesh())
    assert colls is None and detail == {"depths_counted": [1, 2], "extrapolated_to": 4}
    direct = dryrun.count_step(build_step(arch, shape, config_override=smoke4, device="meta"))
    for key in ("flops", "bytes accessed", "work"):
        assert fit[key] == direct[key], key
    assert fit["flops"] > 0


def _ref_bytes(logical_tree, shape_tree, mesh_shape) -> int:
    """Per-device bytes of a tree under the reference's specs, as
    ``NamedSharding.shard_shape`` cuts it."""
    flat, treedef = jax.tree.flatten(shape_tree, is_leaf=lambda x: hasattr(x, "shape"))
    mesh = FakeMesh(mesh_shape)
    rules = ref_sh.default_rules(mesh)
    total = 0
    for lg, x in zip(treedef.flatten_up_to(logical_tree), flat):
        spec = ref_sh.resolve_pspec(lg, tuple(x.shape), mesh, rules)
        block = list(x.shape)
        for i, entry in enumerate(tuple(spec)):
            if entry is not None:
                axes = (entry,) if isinstance(entry, str) else entry
                block[i] //= math.prod(mesh.shape[a] for a in axes)
        total += math.prod(block) * np.dtype(x.dtype).itemsize
    return total


def _modeled(cell, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    b = build_step(*cell, mesh=mesh, device="meta")
    rep = ResolveReport()
    state = b.state_specs()
    return b, dryrun.modeled_memory(b, state, resolve_tree(b.state_logical, state, mesh, report=rep),
                                    resolve_tree(b.batch_logical, b.batch_specs, mesh, report=rep))


def test_modeled_memory_equals_the_references_specs_on_pod16x16(ref_bundles):
    shape = {"data": 16, "model": 16}
    for cell, ref in ref_bundles.items():
        b, mm = _modeled(cell, False)
        assert mm["state_bytes_per_device"] == _ref_bytes(ref.state_logical, ref.state_specs(), shape), cell
        assert mm["input_bytes_per_device"] == _ref_bytes(ref.batch_logical, ref.batch_specs, shape), cell
        want_act = 0
        if ref.kind == "train" and hasattr(ref.config, "n_layers"):
            bsz, s1 = ref.batch_specs["tokens"].shape
            want_act = (bsz // 16) * ((s1 - 1) // 16) * ref.config.d_model * 2 * ref.config.n_layers
        assert mm["activation_bytes_per_device_est"] == want_act, cell
        assert mm["hbm_bytes"] == 80e9


def test_the_multi_pod_carry_divides_by_the_pod_axis_too():
    """The reference's carry ignores the pod axis (a literal 16 twice); the
    port's halves it on pod2x16x16: 256 sequences over 32 dp devices."""
    _, single = _modeled(("olmo-1b", "train_4k"), False)
    b, multi = _modeled(("olmo-1b", "train_4k"), True)
    cfg = b.config
    assert single["activation_bytes_per_device_est"] == (256 // 16) * (4096 // 16) * 2048 * 2 * 16
    assert multi["activation_bytes_per_device_est"] == (256 // 32) * (4096 // 16) * 2048 * 2 * cfg.n_layers
    assert multi["activation_bytes_per_device_est"] * 2 == single["activation_bytes_per_device_est"]


def test_cli_records_every_live_cell_ok(tmp_path):
    dryrun.main(["--all", "--both-meshes", "--out", str(tmp_path)])
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 2 * len(all_cells(include_skipped=True)) == 80
    live = [r for r in recs if r["status"] != "skipped"]
    assert len(live) == 2 * len(all_cells()) and all(r["status"] == "ok" for r in live)
    for r in live:
        assert r["collectives"] is None and "not modelled" in r["collectives_note"]
        assert r["roofline"]["collective_s"] is None and r["roofline"]["dominant"] in ("compute", "memory")
        assert r["cost"]["flops"] > 0 and r["n_devices"] == (512 if r["mesh"] == "pod2x16x16" else 256)
        assert r["cost"]["flops"] * r["n_devices"] == pytest.approx(r["cost_global"]["flops"])
        assert r["modeled_memory"]["fits_hbm"] == (r["modeled_memory"]["modeled_total_per_device"] <= 80e9)
    skipped = [r for r in recs if r["status"] == "skipped"]
    assert len(skipped) == 8 and all("full-attention" in r["skip_reason"] for r in skipped)
    # retrieval_cand's one user does not divide the dp axes: replicated, and recorded
    cand = json.loads((tmp_path / "bert4rec__retrieval_cand__pod2x16x16.json").read_text())
    assert cand["sharding_fallbacks"] == [f"{i}: dim 1 (batch) % mesh('pod', 'data')=32 != 0 -> replicated"
                                          for i in (0, 1)]


def test_a_failing_cell_is_recorded_and_the_run_exits_1(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("no meta kernel")

    monkeypatch.setattr(dryrun, "build_step", broken)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "gat-cora", "--shape", "molecule", "--out", str(tmp_path)])
    assert exc.value.code == 1
    rec = json.loads((tmp_path / "gat-cora__molecule__pod16x16.json").read_text())
    assert rec["status"] == "failed" and "no meta kernel" in rec["error"] and "Traceback" in rec["traceback"]


def test_perf_appends_a_record(tmp_path):
    out = str(tmp_path)
    perf.main(["--arch", "gat-cora", "--shape", "ogb_products", "--variant", "base", "--out", out])
    rf, mem = perf.main(["--arch", "gat-cora", "--shape", "ogb_products", "--variant", "replicated",
                         "--replicate-inputs", "--out", out])
    log = json.loads((tmp_path / "gat-cora__ogb_products.json").read_text())
    assert [it["variant"] for it in log["iterations"]] == ["base", "replicated"]
    base, rep = (it["modeled_memory"]["input_bytes_per_device"] for it in log["iterations"])
    assert rep > base  # replicated node and edge inputs: every device holds them whole
    assert log["iterations"][1]["collectives"] is None and rf.collective_s is None

    # an override reaches the config (dense attention: the (S, S) logits of
    # every head are written and read) and is cleared afterwards
    from repro_torch.launch import steps

    chunked, _ = perf.main(["--arch", "olmo-1b", "--shape", "train_4k", "--variant", "chunked", "--out", out])
    dense, _ = perf.main(["--arch", "olmo-1b", "--shape", "train_4k", "--variant", "dense", "--out", out,
                          "--override", "attn_q_chunk=None"])
    assert steps.PERF_OVERRIDES == {}
    assert dense.model_flops == chunked.model_flops and dense.bytes_per_chip != chunked.bytes_per_chip
