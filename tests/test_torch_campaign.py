"""The port's campaign layer (``repro_torch.campaign``) on the CPU: the
reference's campaign tests (manifest grammar, crash-safe store, shards,
the crash-restart bit-identity drill, quarantine, the spawn pool, the
store-only report, the CLI), its campaign-report tests, parity with the
reference over one corpus and manifest (cell keys, the pinned manifest's
bytes, every record, the report), and the one deliberate difference: a
device fault inside a cell propagates and is never quarantined."""
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro import campaign as ref_campaign  # noqa: E402
from repro_torch.bench import report as bench_report  # noqa: E402
from repro_torch.bench import results  # noqa: E402
from repro_torch.campaign import (CampaignStore, Cell, Dataset, Grid,
                                  Manifest, cell_key, dataset_winners,
                                  load_manifest, pending_cells, plan_cells,
                                  render_report, run_campaign, scan_corpus,
                                  shard_cells)
from repro_torch.campaign import executor
from repro_torch.campaign import make_manifest as port_make_manifest
from repro_torch.campaign import report as campaign_report
from repro_torch.campaign.report import campaign_records, format_report
from repro_torch.data import ingest
from repro_torch.kernels import _build
from repro_torch.kernels import policy_step

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "benchmarks" / "corpus"

GRID = Grid(policies=("fifo", "lru"), K=(64,), seeds=(0,), T=2000)
# the parity grid: both regimes of capacity, a slot and a rank policy each
PARITY_GRID = Grid(policies=("fifo", "lru", "ac", "dac"), K=(64, "S"),
                   seeds=(0,), T=2000)


def _run(manifest, store, **kw):
    return run_campaign(manifest, store, device="cpu", **kw)


@pytest.fixture(scope="module")
def corpus_manifest():
    return scan_corpus(str(CORPUS), name="mini", grid=GRID)


@pytest.fixture(scope="module")
def full_store(tmp_path_factory, corpus_manifest):
    """One uninterrupted run over the committed corpus — the reference
    store for the bit-identity drill and the report tests."""
    store = CampaignStore(str(tmp_path_factory.mktemp("full") / "store"))
    summary = _run(corpus_manifest, store)
    assert summary.counts["quarantined"] == 0
    assert summary.counts["remaining"] == 0
    return store


# --- manifest grammar -------------------------------------------------------

def test_grid_validation():
    with pytest.raises(ValueError, match="at least one policy"):
        Grid(policies=())
    with pytest.raises(ValueError, match="regime letters"):
        Grid(policies=("lru",), K=("M",))
    with pytest.raises(ValueError, match="positive cap"):
        Grid(policies=("lru",), T=0)
    # ints and regime letters coexist, coerced
    g = Grid(policies=("lru",), K=("S", "64"), seeds=("3",))
    assert g.K == ("S", 64) and g.seeds == (3,)


def test_manifest_roundtrip_and_validation():
    m = Manifest(name="demo", root=".", grid=Grid(policies=("lru",)),
                 datasets=(Dataset(name="d", glob="*.csv"),))
    assert Manifest.from_dict(m.to_dict()) == m
    with pytest.raises(ValueError, match="schema"):
        Manifest.from_dict(dict(m.to_dict(), schema="nope/v9"))
    with pytest.raises(ValueError, match="unique"):
        Manifest(name="demo", root=".", grid=Grid(policies=("lru",)),
                 datasets=(Dataset(name="d", glob="*.csv"),
                           Dataset(name="d", glob="*.txt")))
    with pytest.raises(ValueError, match="glob.*or.*traces"):
        Dataset(name="empty")


def test_manifest_empty_glob_is_an_error(tmp_path):
    m = Manifest(name="demo", root=str(tmp_path),
                 grid=Grid(policies=("lru",)),
                 datasets=(Dataset(name="d", glob="*.nothere"),))
    with pytest.raises(ValueError, match="matched no trace files"):
        m.traces()


def test_load_manifest_reanchors_relative_root(tmp_path):
    traces = tmp_path / "traces"
    traces.mkdir()
    ingest.write_csv(str(traces / "a.csv"), [1, 2, 1], [10, 20, 10])
    m = Manifest(name="demo", root="traces",
                 grid=Grid(policies=("lru",)),
                 datasets=(Dataset(name="d", glob="*.csv"),))
    m.save(str(tmp_path / "campaign.json"))
    loaded = load_manifest(str(tmp_path / "campaign.json"))
    assert os.path.isabs(loaded.root)
    [(ds, path, fmt)] = loaded.traces()
    assert (ds, os.path.basename(path)) == ("d", "a.csv")


def test_scan_corpus_groups_and_freezes_stats(corpus_manifest):
    names = {d.name for d in corpus_manifest.datasets}
    assert names == {"csv", "oracle", "txt"}       # grouped by format
    all_traces = [p for d in corpus_manifest.datasets for p, _ in d.traces]
    # the plain .bin with a committed .gz twin is skipped, not duplicated
    assert not any(p.endswith(".oracleGeneral.bin") for p in all_traces)
    for d in corpus_manifest.datasets:
        for rel, _ in d.traces:
            assert d.stats[rel]["n_requests"] > 0   # frozen characterization


# --- store ------------------------------------------------------------------

def _tiny_payload(wall=1.5):
    return results.build_payload(
        "cell", config={}, wall_s=wall, schema=results.SCHEMA_V2,
        records=[{"metrics": {"miss_ratio": [0.5]}, "seeds": [0],
                  "wall_s": 0.7}], device="cpu")


def test_store_put_normalizes_and_get_revalidates(tmp_path):
    store = CampaignStore(str(tmp_path / "s"))
    path = store.put("aaaa", _tiny_payload())
    on_disk = json.load(open(path))
    assert on_disk["created_unix"] == 0.0 and on_disk["wall_s"] == 0.0
    assert on_disk["records"][0]["wall_s"] == 0.0
    assert store.get("aaaa")["schema"] == results.SCHEMA_V2
    assert store.completed() == ["aaaa"]
    # volatile fields zeroed identically regardless of actual timings
    store.put("bbbb", _tiny_payload(wall=99.0))
    a, b = (open(store.path_for(k)).read() for k in ("aaaa", "bbbb"))
    assert a == b
    assert not [f for f in os.listdir(store.cells_dir) if ".tmp." in f]


def test_store_rejects_invalid_payloads(tmp_path):
    store = CampaignStore(str(tmp_path / "s"))
    with pytest.raises(ValueError, match="schema"):
        store.put("aaaa", {"schema": "bogus"})
    assert not store.has("aaaa")                   # nothing landed


def test_store_pins_manifest_and_rejects_mismatch(tmp_path):
    store = CampaignStore(str(tmp_path / "s"))
    m1 = Manifest(name="a", root=".", grid=Grid(policies=("lru",)),
                  datasets=(Dataset(name="d", glob="*.csv"),))
    store.init_manifest(m1)
    store.init_manifest(m1)                        # idempotent
    m2 = dataclasses.replace(m1, grid=Grid(policies=("fifo",)))
    with pytest.raises(ValueError, match="different.*manifest"):
        store.init_manifest(m2)


# --- planning, sharding, resume --------------------------------------------

def test_shards_partition_the_plan(corpus_manifest):
    cells = plan_cells(corpus_manifest)
    assert len(cells) == len({cell_key(c) for c in cells}) == 6
    shards = [shard_cells(cells, f"{i}/3") for i in range(3)]
    keys = [{cell_key(c) for c in s} for s in shards]
    assert set.union(*keys) == {cell_key(c) for c in cells}
    for i in range(3):
        for j in range(i + 1, 3):
            assert keys[i].isdisjoint(keys[j])


def test_crash_restart_is_bit_identical(tmp_path, corpus_manifest,
                                        full_store):
    """The drill: kill a campaign after 2 cells (the cell-budget hook),
    restart it, and the final store is byte-for-byte the store of an
    uninterrupted run — and no cell ran twice."""
    store = CampaignStore(str(tmp_path / "store"))
    first = _run(corpus_manifest, store, max_cells=2)
    assert first.counts == {"total": 6, "skipped": 0, "executed": 2,
                            "quarantined": 0, "remaining": 4}
    # "restart": a fresh handle on the same directory, no carried state
    resumed = _run(corpus_manifest, CampaignStore(store.root))
    assert resumed.counts["skipped"] == 2
    assert resumed.counts["remaining"] == 0
    e1, e2 = set(first.executed), set(resumed.executed)
    assert e1.isdisjoint(e2) and e1 | e2 == set(full_store.completed())
    # the journal agrees nothing executed twice across both invocations
    done = [json.loads(line)["key"]
            for line in open(os.path.join(store.root, store.JOURNAL))
            if json.loads(line)["event"] == "done"]
    assert len(done) == len(set(done)) == 6
    # bit-identity of the cells/ tree vs the uninterrupted reference
    fa = sorted(os.listdir(os.path.join(full_store.root, "cells")))
    fb = sorted(os.listdir(os.path.join(store.root, "cells")))
    assert fa == fb
    for fn in fa:
        ref = open(os.path.join(full_store.root, "cells", fn), "rb").read()
        got = open(os.path.join(store.root, "cells", fn), "rb").read()
        assert ref == got, f"cell file {fn} differs after crash-restart"


def _bad_and_good_corpus(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    ingest.write_csv(str(corpus / "good.csv"), [1, 2, 1, 3], [8, 8, 8, 8])
    # 10 bytes is not a whole number of 24-byte oracle records
    (corpus / "bad.oracleGeneral.bin").write_bytes(b"\x00" * 10)
    return corpus


def test_quarantine_keeps_campaign_alive_and_sticks(tmp_path):
    corpus = _bad_and_good_corpus(tmp_path)
    m = scan_corpus(str(corpus), name="q",
                    grid=Grid(policies=("lru",), K=(4,), seeds=(0,)),
                    dataset="d", characterize=False)
    store = CampaignStore(str(tmp_path / "store"))
    summary = _run(m, store)
    assert len(summary.executed) == 1 and len(summary.quarantined) == 1
    q = store.get_quarantined(summary.quarantined[0])
    assert "Traceback" in q["error"]
    assert q["cell"]["trace"].endswith("bad.oracleGeneral.bin")
    # resume: the quarantined cell is not retried, nothing is pending
    assert pending_cells(plan_cells(m), store) == []
    again = _run(m, store)
    assert again.counts["executed"] == 0 and again.counts["skipped"] == 2


def test_workers_spawn_pool(tmp_path, corpus_manifest):
    """A 2-worker process pool completes the same cells as inline runs
    (spawn context; results land via the shared store directory), each
    cell file byte-equal to the inline run's."""
    grid = Grid(policies=("fifo", "lru"), K=(32,), seeds=(0,), T=800)
    m = dataclasses.replace(
        corpus_manifest, grid=grid,
        datasets=tuple(d for d in corpus_manifest.datasets
                       if d.name == "txt"))
    store = CampaignStore(str(tmp_path / "store"))
    summary = _run(m, store, workers=2)
    assert summary.counts["executed"] == 2
    assert summary.counts["quarantined"] == 0
    assert len(store.completed()) == 2
    inline = CampaignStore(str(tmp_path / "inline"))
    _run(m, inline)
    for key in store.completed():
        assert open(store.path_for(key), "rb").read() == \
            open(inline.path_for(key), "rb").read()


# --- device faults: re-raised, never quarantined ----------------------------

@pytest.mark.parametrize("exc, fault", [
    (_build.KernelError("policy_replay: CUDA error 700"), True),
    (_build.KernelError("kernel build failed:\npolicy_step: nvcc exit 1"),
     True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (ValueError("size is not a multiple of the 24-byte record"), False),
    (OSError("Not a gzipped file"), False),
    (EOFError("Compressed file ended before the end-of-stream marker"),
     False),
    (KeyError("unknown policy"), False),
], ids=lambda v: type(v).__name__ if isinstance(v, BaseException) else "")
def test_is_device_fault(exc, fault):
    assert executor.is_device_fault(exc) is fault


def test_device_fault_propagates_and_is_not_quarantined(tmp_path,
                                                        monkeypatch):
    """A kernel failure inside a cell leaves run_campaign with the error
    ``_build.check`` raises and no quarantine entry for that cell; the
    parse error of the planted file in the same run is still
    quarantined."""
    corpus = _bad_and_good_corpus(tmp_path)
    m = scan_corpus(str(corpus), name="fault",
                    grid=Grid(policies=("dac",), K=(4,), seeds=(0,)),
                    dataset="d", characterize=False)

    def failing_launch(*args, **kw):
        _build.check(700, "policy_replay")

    monkeypatch.setattr(policy_step, "replay_plain", failing_launch)
    store = CampaignStore(str(tmp_path / "store"))
    with pytest.raises(_build.KernelError, match="policy_replay: CUDA"):
        _run(m, store)
    [bad] = store.quarantined()
    assert store.get_quarantined(bad)["cell"]["trace"].endswith(
        "bad.oracleGeneral.bin")
    assert store.completed() == []
    good = [c for c in plan_cells(m) if c.trace.endswith("good.csv")]
    assert pending_cells(plan_cells(m), store) == good   # retried next run


def test_no_card_raises_before_any_cell(tmp_path, monkeypatch):
    """``device="cuda"`` on a machine without a card raises before the
    store is touched, rather than quarantining every cell."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus = _bad_and_good_corpus(tmp_path)
    m = scan_corpus(str(corpus), name="nocard",
                    grid=Grid(policies=("lru",), K=(4,), seeds=(0,)),
                    dataset="d", characterize=False)
    store = CampaignStore(str(tmp_path / "store"))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_campaign(m, store)
    assert store.quarantined() == [] and store.completed() == []
    assert not os.path.exists(os.path.join(store.root, store.JOURNAL))


def test_device_fault_in_a_spawned_worker_propagates(tmp_path, monkeypatch):
    """A device fault raised inside a pool worker (here: a worker asked
    for the card on a machine without one) leaves ``run_campaign`` with
    that error; no cell is quarantined or stored."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ingest.write_csv(str(tmp_path / "a.csv"), [1, 2, 1, 3], [8, 8, 8, 8])
    ingest.write_csv(str(tmp_path / "b.csv"), [4, 2, 4, 3], [8, 8, 8, 8])
    m = scan_corpus(str(tmp_path), name="pool",
                    grid=Grid(policies=("lru", "dac"), K=(4,), seeds=(0,)),
                    dataset="d", characterize=False)
    store = CampaignStore(str(tmp_path / "store"))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_campaign(m, store, workers=2)
    assert store.quarantined() == [] and store.completed() == []


def test_smoke_oracle_reckoning_equals_the_records(tmp_path, monkeypatch):
    """``chip_smoke.oracle_cell``, which holds the card's whole-trace
    campaign cells, gives the port's records exactly: K, counts, ratios,
    DAC's time-mean k, and float totals summed in the stream's order over
    several chunks, with byte sums far past 2^24 (float32 rounds)."""
    spec = importlib.util.spec_from_file_location("_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.data import traces
    keys = traces.family_trace("alibaba", 3000, seed=3)
    sizes = np.random.default_rng(0).integers(
        1, 10**7, int(keys.max()) + 1)[keys]
    (tmp_path / "c" / "x").mkdir(parents=True)
    ingest.write_csv(str(tmp_path / "c" / "x" / "t.csv"), keys, sizes,
                     traces.fetch_costs(sizes))
    m = scan_corpus(str(tmp_path / "c"), name="oracle", grid=Grid(
        policies=("ac", "dac"), K=("L", "S"), seeds=(0,)))
    store = CampaignStore(str(tmp_path / "s"))
    _run(m, store, chunk=500)
    monkeypatch.setattr(ingest, "DEFAULT_CHUNK", 500)
    n = 0
    for key, payload in store.payloads():
        c = payload["extras"]["campaign"]["cell"]
        K, metrics = smoke.oracle_cell(c["trace"], c["policy"], c["K"])
        [rec] = payload["records"]
        assert (rec["K"], rec["metrics"]) == (K, metrics), c
        n += 1
    assert n == 4


# --- winners tie-break / margin + CDF (bench.report satellites) ------------

def _rec(policy, scenario, miss):
    return {"policy": policy, "scenario": scenario, "K_label": "S",
            "seeds": [0], "dataset": "d",
            "metrics": {"miss_ratio": [miss], "hit_ratio": [1 - miss],
                        "byte_miss_ratio": [miss], "penalty_ratio": [miss]}}


def test_winners_tie_breaks_lexicographically_with_margin():
    recs = [_rec("zpol", "t", 0.4), _rec("apol", "t", 0.4),
            _rec("mpol", "t", 0.6)]
    pols = ["zpol", "apol", "mpol"]
    plain = bench_report.winners(recs, pols)
    assert plain["t(S)"] == {"apol": 1.0}          # tie -> first by name
    assert sum(plain["t(S)"].values()) == 1.0      # shape unchanged
    rich = bench_report.winners(recs, pols, margin=True)
    assert rich["t(S)"]["winners"] == {"apol": 1.0}
    assert rich["t(S)"]["margin"] == pytest.approx(0.0)  # runner-up tied
    solo = bench_report.winners([_rec("a", "t", 0.3), _rec("b", "t", 0.5)],
                                ["a", "b"], margin=True)
    assert solo["t(S)"]["margin"] == pytest.approx(0.2)


def test_metric_cdf_is_a_cdf():
    recs = [_rec("a", f"t{i}", m) for i, m in enumerate([0.2, 0.6, 0.4])]
    cdf = bench_report.metric_cdf(recs, ["a"], "miss_ratio")["a"]
    assert cdf["values"] == sorted(cdf["values"])
    assert cdf["cdf"][-1] == pytest.approx(1.0)
    assert all(x <= y for x, y in zip(cdf["cdf"], cdf["cdf"][1:]))


# --- report layer, from the store alone ------------------------------------

def test_report_renders_from_store_alone(full_store):
    report = render_report(full_store, baseline="fifo")
    assert report["n_cells"] == 6 and report["n_quarantined"] == 0
    assert report["policies"] == ["fifo", "lru"]
    assert set(report["winners"]) == {"csv", "oracle", "txt"}
    for row in report["winners"].values():
        assert row["winner"] in ("fifo", "lru")
        assert row["margin"] >= 0.0
        assert sum(row["wins"].values()) == pytest.approx(1.0)
    # reduction tables: fifo vs itself is exactly zero
    for col in report["mrr_vs_fifo"].values():
        assert col["fifo"] == pytest.approx(0.0)
    cdf = report["hit_ratio_cdf"]
    assert set(cdf) == {"fifo", "lru"} and len(cdf["lru"]["values"]) == 3
    text = format_report(report)
    assert "winners (miss ratio)" in text and "oracle" in text


def test_incomplete_cells_shrink_tables_not_crash(full_store):
    recs = campaign_records(full_store)
    # drop one policy's record from one cell -> that cell leaves the table
    recs = [r for r in recs
            if not (r["policy"] == "lru" and r["dataset"] == "txt")]
    table = dataset_winners(recs, ["fifo", "lru"])
    assert "txt" not in table and set(table) == {"csv", "oracle"}
    assert all(row["dropped"] == 0 for row in table.values())


# --- the campaign report on hand-built records ------------------------------

def _camp(policy, scenario, m, dataset="ds", k_label="S"):
    return {"policy": policy, "scenario": scenario, "K_label": k_label,
            "dataset": dataset, "seeds": [0],
            "metrics": {"miss_ratio": [m], "hit_ratio": [1 - m],
                        "byte_miss_ratio": [m], "penalty_ratio": [m]}}


def test_complete_cells_keeps_only_fully_covered():
    recs = [_camp("fifo", "a", 0.5), _camp("lru", "a", 0.3),
            _camp("fifo", "b", 0.4)]             # lru missing from cell b
    kept, dropped = campaign_report.complete_cells(recs, ["fifo", "lru"])
    assert dropped == 1
    assert {(r["scenario"], r["policy"]) for r in kept} == \
        {("a", "fifo"), ("a", "lru")}


def test_complete_cells_filters_uncompared_policies():
    recs = [_camp("fifo", "a", 0.5), _camp("lru", "a", 0.3),
            _camp("arc", "a", 0.2)]
    kept, dropped = campaign_report.complete_cells(recs, ["fifo", "lru"])
    assert dropped == 0
    assert all(r["policy"] in ("fifo", "lru") for r in kept)


def test_dataset_winners_surfaces_dropped_and_shrinks():
    recs = [_camp("fifo", "a", 0.5), _camp("lru", "a", 0.3),
            _camp("fifo", "b", 0.4),             # incomplete cell -> dropped
            _camp("fifo", "c", 0.2, dataset="other"),
            _camp("lru", "c", 0.4, dataset="other")]
    table = campaign_report.dataset_winners(recs, ["fifo", "lru"])
    assert table["ds"]["cells"] == 1 and table["ds"]["dropped"] == 1
    assert table["ds"]["winner"] == "lru"
    assert table["ds"]["wins"] == {"fifo": 0.0, "lru": 1.0}
    assert table["other"]["winner"] == "fifo" and \
        table["other"]["dropped"] == 0


def test_dataset_winners_skips_dataset_with_no_complete_cells():
    recs = [_camp("fifo", "a", 0.5),
            _camp("lru", "b", 0.3)]              # no cell has both
    assert campaign_report.dataset_winners(recs, ["fifo", "lru"]) == {}


def test_dataset_winners_tie_is_lexicographic():
    recs = [_camp("fifo", "a", 0.3), _camp("lru", "a", 0.3)]
    table = campaign_report.dataset_winners(recs, ["fifo", "lru"])
    assert table["ds"]["winner"] == "fifo"
    assert table["ds"]["margin"] == 0.0


def test_mrr_vs_baseline_over_complete_cells():
    recs = [_camp("fifo", "a", 0.5), _camp("lru", "a", 0.25),
            _camp("fifo", "b", 0.4)]             # b incomplete -> excluded
    out = campaign_report.mrr_vs_baseline(recs, ["fifo", "lru"],
                                          baseline="fifo")
    assert out["ds"]["lru"] == pytest.approx(0.5)
    assert out["ds"]["fifo"] == pytest.approx(0.0)


# --- results --out-dir plumbing + ingest cache key (satellites) ------------

def test_set_results_dir_redirects_save(tmp_path, monkeypatch):
    monkeypatch.setattr(results, "RESULTS_DIR", results.RESULTS_DIR)
    out = str(tmp_path / "elsewhere")
    assert results.set_results_dir(out) == out
    path = results.save(_tiny_payload())
    assert os.path.dirname(path) == out
    assert not [f for f in os.listdir(out) if ".tmp." in f]   # atomic


def test_characterize_cache_keys_on_size(tmp_path):
    """A rewrite that lands in the same mtime tick must not serve stale
    stats to make_manifest: file size is part of the cache key."""
    p = str(tmp_path / "t.csv")
    ingest.write_csv(p, [1, 2], [8, 8])
    mtime_ns = os.stat(p).st_mtime_ns
    assert ingest.characterize(p).n_requests == 2
    ingest.write_csv(p, [1, 2, 3, 4], [8, 8, 8, 8])
    os.utime(p, ns=(mtime_ns, mtime_ns))           # force same-mtime rewrite
    assert ingest.characterize(p).n_requests == 4
    assert ingest.count_requests(p) == 4


# --- CLI --------------------------------------------------------------------

def _cli(module, args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=str(ROOT),
                          env=env, **kw)


def test_cli_status_and_report_from_store_only(full_store):
    out = _cli("repro_torch.campaign", ["--store", full_store.root,
                                        "--status"])
    assert out.returncode == 0, out.stderr
    assert "completed   6" in out.stdout
    out = _cli("repro_torch.campaign", ["--store", full_store.root,
                                        "--report"])
    assert out.returncode == 0, out.stderr
    assert "winners (miss ratio)" in out.stdout
    report = json.load(open(os.path.join(full_store.root, "report.json")))
    assert report["schema"] == "repro.campaign.report/v1"
    assert report["n_cells"] == 6


def test_cli_fresh_store_requires_manifest(tmp_path):
    out = _cli("repro_torch.campaign", ["--store", str(tmp_path / "fresh")])
    assert out.returncode == 2
    assert "--manifest is required" in out.stderr


def test_cli_runs_a_manifest_on_the_cpu(tmp_path, full_store):
    """make_manifest, then a run with ``--device cpu`` and a resume: the
    cells equal the library's run of the same grid byte for byte."""
    out = _cli("repro_torch.campaign.make_manifest",
               [str(CORPUS), "--out", str(tmp_path / "m.json"),
                "--name", "mini", "--policies", "fifo", "lru",
                "--K", "64", "--T", "2000"])
    assert out.returncode == 0, out.stderr
    assert "3 trace(s), 6 grid cells" in out.stdout
    store = str(tmp_path / "store")
    args = ["--store", store, "--device", "cpu", "--quiet"]
    out = _cli("repro_torch.campaign", ["--manifest", str(tmp_path / "m.json"),
                                        "--max-cells", "4", *args])
    assert out.returncode == 0, out.stderr
    assert "4 executed, 0 skipped" in out.stdout
    out = _cli("repro_torch.campaign", args)       # the store's manifest
    assert out.returncode == 0, out.stderr
    assert "2 executed, 4 skipped" in out.stdout
    assert sorted(os.listdir(os.path.join(store, "cells"))) == \
        sorted(f"{k}.json" for k in full_store.completed())
    for key in full_store.completed():
        assert open(full_store.path_for(key), "rb").read() == \
            open(os.path.join(store, "cells", f"{key}.json"), "rb").read()


# --- parity with the reference over one corpus and manifest -----------------

def _ref_make_manifest():
    spec = importlib.util.spec_from_file_location(
        "_ref_make_manifest", ROOT / "tools" / "make_manifest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def parity_stores(tmp_path_factory):
    """One corpus and manifest through both packages: the reference's
    ``run_campaign`` (jax on the CPU) and the port's on the CPU."""
    tmp = tmp_path_factory.mktemp("parity")
    port_m = scan_corpus(str(CORPUS), name="parity", grid=PARITY_GRID)
    ref_m = ref_campaign.load_manifest(
        port_m.save(str(tmp / "manifest.json")))
    ref = ref_campaign.CampaignStore(str(tmp / "ref"))
    port = CampaignStore(str(tmp / "port"))
    ref_sum = ref_campaign.run_campaign(ref_m, ref)
    port_sum = _run(load_manifest(str(tmp / "manifest.json")), port)
    assert ref_sum.counts == port_sum.counts
    assert port_sum.counts["executed"] == 24
    return ref, port


def test_cell_keys_and_plan_equal_reference():
    port_m = scan_corpus(str(CORPUS), name="parity", grid=PARITY_GRID)
    ref_m = ref_campaign.Manifest.from_dict(port_m.to_dict())
    assert port_m.to_dict() == ref_campaign.scan_corpus(
        str(CORPUS), name="parity",
        grid=ref_campaign.Grid(**dataclasses.asdict(PARITY_GRID))).to_dict()
    port_cells, ref_cells = plan_cells(port_m), ref_campaign.plan_cells(ref_m)
    assert [c.to_dict() for c in port_cells] == \
        [c.to_dict() for c in ref_cells]
    assert [cell_key(c) for c in port_cells] == \
        [ref_campaign.cell_key(c) for c in ref_cells]
    assert len(set(cell_key(c) for c in port_cells)) == 24
    c = Cell(dataset="x", trace="t.csv", format="auto", policy="lru", K=8,
             seed=0)
    assert cell_key(c) == ref_campaign.cell_key(
        ref_campaign.Cell(**c.to_dict()))


def test_pinned_manifest_bytes_equal_reference(tmp_path):
    argv = [str(CORPUS), "--name", "pinned", "--policies", "fifo", "lru",
            "ac", "dac", "--K", "64", "S", "--T", "2000"]
    port_out, ref_out = tmp_path / "port.json", tmp_path / "ref.json"
    assert port_make_manifest.main([*argv, "--out", str(port_out)]) == 0
    assert _ref_make_manifest().main([*argv, "--out", str(ref_out)]) == 0
    assert port_out.read_bytes() == ref_out.read_bytes()
    # each package loads the other's manifest to the same value
    assert load_manifest(str(ref_out)).to_dict() == \
        ref_campaign.load_manifest(str(port_out)).to_dict()


def test_stores_name_the_same_cells(parity_stores):
    ref, port = parity_stores
    assert sorted(os.listdir(ref.cells_dir)) == \
        sorted(os.listdir(port.cells_dir))


def test_records_equal_reference(parity_stores):
    """Every cell's record equals the reference's: counts and ratios
    exact, the float totals too (sizes below 256 B keep the float32 sums
    exact), DAC's time-mean k included; and the campaign extras."""
    ref, port = parity_stores
    n = 0
    for key, got in port.payloads():
        want = ref.get(key)
        assert got["extras"] == want["extras"], key
        [g], [w] = got["records"], want["records"]
        assert g == w, (key, g["policy"], g["metrics"], w["metrics"])
        n += 1
    assert n == 24


def test_report_equals_reference(parity_stores):
    ref, port = parity_stores
    got = render_report(port)
    want = ref_campaign.render_report(ref)
    assert "provenance" not in got
    assert got == want
    assert format_report(got) == ref_campaign.format_report(want)
    assert np.isclose(got["mrr_vs_fifo"]["oracle"]["fifo"], 0.0)
