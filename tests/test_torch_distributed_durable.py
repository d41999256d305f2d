"""The port's durable mesh session (a WAL, ``checkpoint()``, ``recover()``
and ``merge()`` on ``GraphStream(mesh=...)``) against the reference's LOCAL
session fed the same calls: the reference's mesh session cannot run on this
host's jax (ROADMAP §C), and it must equal its local session.

Spawned gloo ranks on a (1, 1) and a (2, 2) ``("data", "model")`` mesh run
the scenarios of ``tests/_torch_dist.py::durable_mesh``; this process runs
the same scenario functions on reference sessions opened with the same hash
families.  Integer weights, so everything compares bit for bit:

- a crash at every batch boundary of an 8-batch stream (checkpoints every 3
  batches, a batch of 1,100 edges that the host pre-aggregates), then a fresh
  session's ``seek``, ``recover()`` and the rest of the stream: the consumed
  transcript, the ``RecoveryReport``, every receipt's ``wal_seq`` and the
  summary equal the reference's, and the shared WAL directory (written by
  rank 0 alone) is byte-identical to the reference's;
- a merge barrier in the suffix refuses replay with the reference's words;
- mesh into mesh, local into mesh and mesh into local ``merge()`` equal the
  reference's local merge, alias neither operand, tick the subscription and
  log the barrier; a foreign hash family is refused with its words;
- checkpoint GC leaves the segments the older retained checkpoint needs;
- no rank's ``ingest`` returns before rank 0's append has, on a (2, 2) and a
  (1, 2) mesh, where some ranks share no collective with rank 0 in
  ``distributed_ingest``; a failed append on rank 0 fails every rank's
  ``ingest``; ranks that read different logs are refused.
"""
import numpy as np
import pytest

from repro.api import GraphStream as RefStream, Query as RefQuery
from repro.core.sketch import SketchConfig as RefConfig

import _torch_dist

CFG = RefConfig(depth=3, width_rows=64, width_cols=64)
N_BATCHES = 8
CKPT_EVERY = 3
MESHES = {"1x1": (1, 1), "2x2": (2, 2)}
PAIRINGS = ("mesh_into_mesh", "local_into_mesh", "mesh_into_local")


def _batches():
    rng = np.random.default_rng(11)
    out = []
    for i in range(N_BATCHES):
        n = 1100 if i == 2 else 40
        out.append((rng.integers(0, 100, n).astype(np.uint32), rng.integers(0, 100, n).astype(np.uint32),
                    rng.integers(1, 5, n).astype(np.float32)))
    return out


def _wal_bytes(directory):
    return {p.name: p.read_bytes() for p in sorted(directory.glob("wal-*.seg"))}


def _ref_opener(seed=0, **kw):
    def open_session():
        return RefStream.open(CFG, seed=seed, query_backend="jnp", ingest_backend="scatter", double_buffer=False, **kw)
    return open_session


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (in this process) and each mesh's ranks."""
    tmp = tmp_path_factory.mktemp("durable-mesh")
    batches = _batches()

    def durable(name, **kw):
        return _ref_opener(wal_dir=str(tmp / "ref" / name / "wal"), checkpoint_dir=str(tmp / "ref" / name / "ckpt"),
                           **kw)

    ref = {f"crash{k}": _torch_dist.crash_run(durable(f"crash{k}"), RefQuery, batches, k, CKPT_EVERY)
           for k in range(N_BATCHES + 1)}
    ref["barrier"] = _torch_dist.barrier_run(durable("barrier"), _ref_opener(), batches)
    for name, receiver in zip(PAIRINGS, (durable("merge-mm"), durable("merge-lm"), _ref_opener())):
        ref[name] = _torch_dist.merge_run(receiver(), _ref_opener()(), batches, RefQuery)
    ref["foreign"] = _torch_dist.family_refusal(_ref_opener()(), _ref_opener(seed=1)())
    ref["gc"] = _torch_dist.gc_run(durable("gc", keep=2), batches, lambda gs: gs._ckpt.all_steps()[0])

    arrays = {"shape": np.asarray([CFG.depth, CFG.width_rows, CFG.width_cols]), "n_batches": np.asarray(N_BATCHES),
              "ckpt_every": np.asarray(CKPT_EVERY)}
    for tag, seed in (("a", 0), ("b", 1)):
        empty = RefStream.open(CFG, seed=seed).sketch
        arrays[f"{tag}/row_a"], arrays[f"{tag}/row_b"] = np.asarray(empty.row_hash.a), np.asarray(empty.row_hash.b)
    for i, (s, d, w) in enumerate(batches):
        arrays[f"b{i}/src"], arrays[f"b{i}/dst"], arrays[f"b{i}/w"] = s, d, w
    np.savez(tmp / "inputs.npz", **arrays)
    ranks = {}
    for tag, shape in MESHES.items():
        out = tmp / f"mesh-{tag}"
        ranks[tag] = (_torch_dist.run_ranks(_torch_dist.durable_mesh, shape[0] * shape[1], out, timeout=240,
                                            mesh_shape=shape, inputs=str(tmp / "inputs.npz")),
                      out / "ranks-durable_mesh")
    return ref, ranks, tmp / "ref"


def _same_state(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("crash_at", range(N_BATCHES + 1))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_recovery_matches_reference_local_session(runs, mesh, crash_at):
    """Every rank's consumed transcript, report, receipts' seqs and summary
    equal the reference local session's after the same crash and recovery."""
    ref, ranks, _ = runs
    want = ref[f"crash{crash_at}"]
    assert len(want["transcript"]) == N_BATCHES
    for res in ranks[mesh][0]:
        got = res[f"crash{crash_at}"]
        for key in ("transcript", "report", "seqs", "wal_seq", "deduped"):
            assert got[key] == want[key], key
        _same_state(got["state"], want["state"])
        if crash_at % CKPT_EVERY:
            assert got["deduped"] + got["report"][1] > 0


@pytest.mark.parametrize("crash_at", range(N_BATCHES + 1))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_wal_is_byte_identical_to_the_reference_log(runs, mesh, crash_at):
    """The shared log (rank 0 writes, the others follow) holds the same
    segments, byte for byte, as the reference local session's."""
    _, ranks, ref_dir = runs
    got = _wal_bytes(ranks[mesh][1] / f"crash{crash_at}" / "wal")
    want = _wal_bytes(ref_dir / f"crash{crash_at}" / "wal")
    assert got == want and sum(map(len, want.values())) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_merge_barrier_refuses_replay_with_reference_words(runs, mesh):
    ref, ranks, ref_dir = runs
    assert ref["barrier"] is not None and "merge barrier" in ref["barrier"]
    for res in ranks[mesh][0]:
        assert res["barrier"] == ref["barrier"]
    assert _wal_bytes(ranks[mesh][1] / "barrier" / "wal") == _wal_bytes(ref_dir / "barrier" / "wal")


@pytest.mark.parametrize("pairing", PAIRINGS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_merge_pairings_equal_the_reference_local_merge(runs, mesh, pairing):
    """The merged summary, the subscription's tick on the merge, the epoch
    and edge count equal the reference's; the giver is untouched by the
    merge and by the receiver's next batch; a receiver with a WAL logs the
    barrier as the reference does."""
    ref, ranks, ref_dir = runs
    want = ref[pairing]
    for res in ranks[mesh][0]:
        got = res[pairing]
        for key in ("merged", "giver_before", "after"):
            _same_state(got[key], want[key])
        _same_state(got["giver_after"], want["giver_before"])
        assert (got["epoch"], got["edges"], got["transcript"]) == (want["epoch"], want["edges"], want["transcript"])
    sub = {"mesh_into_mesh": "merge-mm", "local_into_mesh": "merge-lm"}.get(pairing)
    if sub:
        got, want = _wal_bytes(ranks[mesh][1] / sub / "wal"), _wal_bytes(ref_dir / sub / "wal")
        assert got == want and got


@pytest.mark.parametrize("mesh", list(MESHES))
def test_merge_refuses_a_foreign_family_with_reference_words(runs, mesh):
    ref, ranks, _ = runs
    assert ref["foreign"] is not None
    for res in ranks[mesh][0]:
        assert res["foreign"] == [ref["foreign"]] * 3


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gc_leaves_the_segments_a_retained_checkpoint_needs(runs, mesh):
    """Checkpoints after every batch, two kept: the log keeps what the older
    one needs, recovery from it replays its suffix as the reference's does,
    and the segments left are the reference's."""
    ref, ranks, ref_dir = runs
    want = ref["gc"]
    assert want["report"][1] == 2
    for res in ranks[mesh][0]:
        assert res["gc"]["report"] == want["report"]
        _same_state(res["gc"]["state"], want["state"])
    got = _wal_bytes(ranks[mesh][1] / "gc" / "wal")
    assert got == _wal_bytes(ref_dir / "gc" / "wal") and 0 < len(got) < N_BATCHES


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
def test_no_rank_acknowledges_before_rank0_appends(tmp_path, mesh):
    """Rank 0's append held back 1.5 s: every rank's ingest returns after it,
    with rank 0's commit seq.  Rank 0's append then fails: it raises there,
    every other rank raises the refusal, and no summary changed.  Ranks
    opened on different directories are refused on every rank."""
    delay = 1.5
    res = _torch_dist.run_ranks(_torch_dist.log_guarantees, mesh[0] * mesh[1], tmp_path, timeout=120,
                                mesh_shape=mesh, delay=delay)
    appended = res[0]["appended"]
    assert all(r["returned"] >= appended for r in res)
    assert [r["seq"] for r in res] == [41] * len(res)
    assert res[0]["failed"] == ("OSError", "disk full")
    for r in res[1:]:
        assert r["failed"] == ("RuntimeError", "rank 0 failed to append to the write-ahead log; "
                                               "the mutation was not applied")
    assert {r["after"] for r in res} == {(41, 40, 40.0 * 3)}  # smoke's depth is 3
    for r in res:
        assert r["own_dir"] is not None and "read different write-ahead logs" in r["own_dir"]
