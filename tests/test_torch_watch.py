"""The port's run-health read side (``obs/heartbeat.py``:
``read_heartbeat``, ``freshness``, ``scan_health``, ``aggregate_health``)
and alert engine (``obs/alerts.py`` with ``obs/alert_rules.json``)
against the JAX package's, in the cases of JAX's tests/test_watch.py
(its read-side and alert cases) on heartbeat trees the port wrote; both
packages' ``aggregate_health`` equal on trees each package wrote; and the
heartbeat's ``last_span``, which the port's writer now takes from its
span tracer as JAX's does.

Exact equality throughout: the read side is host Python on the same
documents.
"""

import json
import time

import pytest

from scdna_replication_tools_tpu.obs import alerts as jalerts
from scdna_replication_tools_tpu.obs import heartbeat as jhb
from scdna_replication_tools_tpu.obs import spans as jspans
from scdna_replication_tools_tpu_torch.config import PertConfig
from scdna_replication_tools_tpu_torch.obs import alerts as alerts_mod
from scdna_replication_tools_tpu_torch.obs import heartbeat as hb
from scdna_replication_tools_tpu_torch.obs import spans as tspans
from scdna_replication_tools_tpu_torch.utils.fileio import atomic_write_bytes

from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_resilience import BASE, run_port


def _doc(rank, *, state="running", step="step2", chunk=3, iteration=60,
         budget=100, interval=10.0, age=0.0, now=None, count=2,
         eta=4.0, metrics=None):
    """One heartbeat document, ``age`` seconds old (JAX's test helper)."""
    now = time.time() if now is None else now
    return {
        "kind": hb.HEARTBEAT_KIND, "version": hb.HEARTBEAT_VERSION,
        "process_index": rank, "process_count": count, "state": state,
        "interval_seconds": interval, "step": step, "chunk": chunk,
        "iteration": iteration, "budget": budget,
        "ms_per_iter_ewma": 12.0, "eta_seconds": eta,
        "written_unix": now - age, "seq": 7,
        "metrics": metrics or {},
    }


def _tree(tmp_path, docs):
    """The docs committed by the port's writer primitive into a health/
    directory at the port's per-rank paths (seq and written_unix as
    given, so the tests control the ages)."""
    health = tmp_path / "health"
    health.mkdir(parents=True, exist_ok=True)
    for doc in docs:
        atomic_write_bytes(hb.host_path(health, doc["process_index"]),
                           json.dumps(doc).encode())
    return health


def _strip(agg):
    """An aggregate without the paths (equal trees in two directories)."""
    return {**agg, "hosts": [{k: v for k, v in h.items() if k != "path"}
                             for h in agg["hosts"]]}


def _same_aggregate(health, now):
    """The port's aggregate, after checking that JAX's is equal."""
    agg = hb.aggregate_health(health, now=now)
    assert agg == jhb.aggregate_health(health, now=now)
    return agg


# ---------------------------------------------------------------------------
# the read side (JAX tests/test_watch.py:96-197)
# ---------------------------------------------------------------------------


def test_vocabularies_equal_jax():
    assert hb.HEARTBEAT_FIELDS == jhb.HEARTBEAT_FIELDS
    assert hb.AGGREGATE_FIELDS == jhb.AGGREGATE_FIELDS
    assert hb.TERMINAL_STATES == jhb.TERMINAL_STATES
    assert hb.FRESHNESS_LADDER == jhb.FRESHNESS_LADDER
    assert hb.FRESHNESS_ORDER == jhb.FRESHNESS_ORDER
    assert hb._HOST_FILE_RE.pattern == jhb._HOST_FILE_RE.pattern


def test_scan_health_skips_torn_and_foreign_files(tmp_path):
    health = _tree(tmp_path, [_doc(0), _doc(1)])
    (health / "host_2.json").write_text('{"kind": "pert_hear')  # torn
    (health / "host_3.json").write_text('[1, 2]')  # not an object
    (health / "notes.txt").write_text("not a heartbeat")
    rows = hb.scan_health(health)
    assert [r["rank"] for r in rows] == [0, 1]
    assert rows == jhb.scan_health(health)
    assert hb.read_heartbeat(health / "host_3.json") is None
    assert hb.read_heartbeat(health / "absent.json") is None
    assert hb.scan_health(tmp_path / "no_such_dir") == []


@pytest.mark.parametrize("age,want", [
    (5.0, "fresh"), (29.0, "fresh"), (31.0, "lagging"), (99.0, "lagging"),
    (101.0, "stale"), (299.0, "stale"), (301.0, "presumed_lost")])
def test_freshness_ladder_from_writers_own_interval(age, want):
    now = time.time()
    doc = _doc(0, interval=10.0, age=age, now=now)
    assert hb.freshness(doc, now) == want == jhb.freshness(doc, now)


def test_freshness_terminal_states_are_final_never_stale():
    now = time.time()
    for state in sorted(hb.TERMINAL_STATES):
        doc = _doc(0, state=state, age=1e6, now=now)
        assert hb.freshness(doc, now) == "final" == jhb.freshness(doc, now)


def test_freshness_scales_with_declared_cadence():
    now = time.time()
    assert hb.freshness(_doc(0, interval=30.0, age=60.0, now=now),
                        now) == "fresh"
    assert hb.freshness(_doc(0, interval=0.5, age=60.0, now=now),
                        now) == "presumed_lost"
    # no declared cadence: 15 s, as JAX's reader assumes
    doc = {"state": "running", "written_unix": now - 40.0}
    assert hb.freshness(doc, now) == jhb.freshness(doc, now) == "fresh"


def test_aggregate_straggler_spread_same_step(tmp_path):
    now = time.time()
    health = _tree(tmp_path, [
        _doc(0, chunk=5, iteration=90, now=now),
        _doc(1, chunk=2, iteration=40, now=now),
    ])
    agg = _same_aggregate(health, now)
    assert agg["straggler_spread_chunks"] == 3
    assert agg["straggler_spread_iters"] == 50
    assert agg["desync"] is False
    assert agg["missing_ranks"] == []
    assert agg["worst_freshness"] == "fresh"


def test_aggregate_desync_and_cross_step_spread_excluded(tmp_path):
    now = time.time()
    health = _tree(tmp_path, [
        _doc(0, step="step3", chunk=1, iteration=5, now=now, count=3),
        _doc(1, step="step2", chunk=9, iteration=95, now=now, count=3),
        _doc(2, step="step2", chunk=9, iteration=95, now=now, count=3),
    ])
    agg = _same_aggregate(health, now)
    assert agg["desync"] is True
    assert agg["steps"] == ["step2", "step3"]
    assert agg["straggler_spread_chunks"] == 0


def test_aggregate_missing_rank_and_presumed_lost(tmp_path):
    now = time.time()
    health = _tree(tmp_path, [
        _doc(0, now=now, count=3),
        _doc(1, interval=0.5, age=120.0, now=now, count=3),  # lost
    ])
    agg = _same_aggregate(health, now)
    assert agg["process_count"] == 3
    assert agg["missing_ranks"] == [2]
    assert agg["worst_freshness"] == "presumed_lost"
    assert agg["hosts"][1]["freshness"] == "presumed_lost"
    assert agg["max_lag_seconds"] >= 119.0


def test_aggregate_final_hosts_exempt_from_lag(tmp_path):
    now = time.time()
    health = _tree(tmp_path, [
        _doc(0, state="done", age=7200.0, now=now),
        _doc(1, state="done", age=7200.0, now=now),
    ])
    agg = _same_aggregate(health, now)
    assert agg["worst_freshness"] == "final"
    assert agg["max_lag_seconds"] == 0.0
    assert agg["states"] == {"done": 2}
    assert agg["eta_seconds"] is None


def test_aggregate_of_an_empty_directory(tmp_path):
    agg = _same_aggregate(tmp_path, time.time())
    assert agg["hosts"] == [] and agg["worst_freshness"] is None
    assert agg["straggler_spread_chunks"] is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_aggregates_equal_whichever_package_wrote_the_tree(tmp_path,
                                                          writer):
    """Three live writers of one package (a straggler, a finished rank,
    a fault event), read by both packages' aggregate; and the same
    progress written by the other package gives the same aggregate."""
    def write(mod, root):
        hbs = [mod.RunHeartbeat(root, interval_seconds=5.0,
                                process_index=r, process_count=4,
                                config_digest="d")
               for r in range(3)]
        hbs[0].note_chunk(step="step2", chunk=5, iteration=125,
                          budget=400, wall_seconds=1.0, iters=25,
                          action="continue", verdict="improving")
        hbs[1].note_chunk(step="step2", chunk=2, iteration=50, budget=400,
                          wall_seconds=2.0, iters=25)
        hbs[1].observe_event("retry", {})
        hbs[2].close("done")
        for h in hbs:
            h.pump(force=True)
        return root

    first, second = (hb, jhb) if writer == "port" else (jhb, hb)
    now = time.time() + 1.0
    a = write(first, tmp_path / "a")
    agg = _same_aggregate(a, now)
    assert agg["missing_ranks"] == [3]
    assert agg["straggler_spread_chunks"] == 3
    assert agg["states"] == {"done": 1, "running": 2}
    b = write(second, tmp_path / "b")
    other = hb.aggregate_health(b, now=now)
    for x in (agg, other):
        for h in x["hosts"]:
            for key in ("doc", "seq", "age_seconds", "freshness"):
                h.pop(key)
        x.pop("max_lag_seconds")
    assert _strip(agg) == _strip(other)


# ---------------------------------------------------------------------------
# the alert engine (JAX tests/test_watch.py:322-408)
# ---------------------------------------------------------------------------


def _rules(*rules):
    return alerts_mod.validate_rules({"rules": list(rules)})


def test_checked_in_rule_file_validates_and_equals_jax():
    rules = alerts_mod.load_rules()
    names = [r["name"] for r in rules]
    assert "host-presumed-lost" in names
    assert "hosts-desynced" in names
    assert rules == jalerts.load_rules()
    assert alerts_mod.DEFAULT_RULES_PATH.parent.name == "obs"
    assert "scdna_replication_tools_tpu_torch" in \
        str(alerts_mod.DEFAULT_RULES_PATH)


def test_rule_validation_rejects_unknown_metric_and_field():
    with pytest.raises(alerts_mod.AlertRuleError, match="unknown metric"):
        _rules({"name": "r", "kind": "threshold", "severity": "error",
                "metric": "pert_no_such_metric", "op": ">", "value": 0})
    with pytest.raises(alerts_mod.AlertRuleError, match="unknown field"):
        _rules({"name": "r", "kind": "threshold", "severity": "error",
                "field": "no_such_field", "op": ">", "value": 0})


@pytest.mark.parametrize("rule,match", [
    ([{"name": "r", "kind": "vibes", "severity": "error"}], "unknown kind"),
    ([{"name": "r", "kind": "desync", "severity": "error"},
      {"name": "r", "kind": "desync", "severity": "warning"}], "duplicate"),
    ([{"name": "r", "kind": "desync", "severity": "error", "op": ">"}],
     "unknown keys"),
    ([{"name": "r", "kind": "threshold", "severity": "error", "op": ">",
       "value": 1}], "exactly one of"),
    ([{"name": "r", "kind": "staleness", "severity": "error",
       "max_level": "presumed_lost"}], "max_level"),
    ([{"name": "r", "kind": "threshold", "severity": "error",
       "field": "eta_seconds", "op": ">", "value": True}], "number"),
    ([{"name": "r", "kind": "desync", "severity": "fatal"}], "severity"),
])
def test_rule_validation_rejects_bad_grammar(rule, match):
    with pytest.raises(alerts_mod.AlertRuleError, match=match):
        _rules(*rule)
    with pytest.raises(jalerts.AlertRuleError, match=match):
        jalerts.validate_rules({"rules": rule})


def test_load_rules_reads_a_given_file_and_refuses_a_broken_one(tmp_path):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"rules": [
        {"name": "r", "kind": "desync", "severity": "warning"}]}))
    assert [r["name"] for r in alerts_mod.load_rules(path)] == ["r"]
    path.write_text("{not json")
    with pytest.raises(alerts_mod.AlertRuleError, match="cannot read"):
        alerts_mod.load_rules(path)


def _verdicts(agg):
    verdicts = alerts_mod.evaluate(alerts_mod.load_rules(), agg)
    assert verdicts == jalerts.evaluate(jalerts.load_rules(), agg)
    assert alerts_mod.failing(verdicts) == jalerts.failing(verdicts)
    return verdicts


def test_alert_staleness_fires_on_presumed_lost_only(tmp_path):
    now = time.time()
    health = _tree(tmp_path, [
        _doc(0, now=now),
        _doc(1, interval=0.5, age=120.0, now=now),
    ])
    verdicts = _verdicts(_same_aggregate(health, now))
    fired = {v["name"]: v for v in verdicts if v["fired"]}
    assert "host-presumed-lost" in fired
    assert "host1" in fired["host-presumed-lost"]["detail"]
    assert [v["name"] for v in alerts_mod.failing(verdicts)] == \
        ["host-presumed-lost"]


def test_alert_desync_absence_and_metric_threshold(tmp_path):
    now = time.time()
    health = _tree(tmp_path, [
        _doc(0, step="step3", now=now, count=3,
             metrics={"pert_nan_aborts_total": 2}),
        _doc(1, step="step2", now=now, count=3),
    ])
    fired = {v["name"]: v for v in _verdicts(_same_aggregate(health, now))
             if v["fired"]}
    assert "hosts-desynced" in fired
    assert "missing-heartbeats" in fired  # rank 2 never wrote
    assert "nan-aborts" in fired
    assert fired["nan-aborts"]["severity"] == "warning"


def test_alert_threshold_on_an_aggregate_and_a_host_field(tmp_path):
    now = time.time()
    health = _tree(tmp_path, [
        _doc(0, chunk=9, iteration=90, now=now, eta=120.0),
        _doc(1, chunk=2, iteration=20, now=now),
    ])
    agg = _same_aggregate(health, now)
    rules = _rules(
        {"name": "spread", "kind": "threshold", "severity": "error",
         "field": "straggler_spread_chunks", "op": ">=", "value": 7},
        {"name": "slow", "kind": "threshold", "severity": "warning",
         "field": "eta_seconds", "op": ">", "value": 60})
    verdicts = alerts_mod.evaluate(rules, agg)
    assert verdicts == jalerts.evaluate(rules, agg)
    assert [v["fired"] for v in verdicts] == [True, True]
    assert verdicts[0]["detail"] == "straggler_spread_chunks=7 >= 7"
    assert [v["name"] for v in alerts_mod.failing(verdicts)] == ["spread"]


def test_alert_healthy_and_finished_trees_are_quiet(tmp_path):
    now = time.time()
    health = _tree(tmp_path, [_doc(0, now=now), _doc(1, now=now)])
    assert alerts_mod.failing(_verdicts(_same_aggregate(health, now))) == []
    done = _tree(tmp_path / "d", [
        _doc(0, state="done", age=9000.0, now=now),
        _doc(1, state="done", age=9000.0, now=now)])
    assert alerts_mod.failing(_verdicts(_same_aggregate(done, now))) == []


def test_alert_on_no_heartbeats_at_all(tmp_path):
    fired = [v["name"] for v in _verdicts(_same_aggregate(tmp_path,
                                                          time.time()))
             if v["fired"]]
    assert fired == ["missing-heartbeats"]


# ---------------------------------------------------------------------------
# the heartbeat's last_span (the writer's repair)
# ---------------------------------------------------------------------------


def test_last_span_equals_jax(tmp_path, monkeypatch):
    """The same spans opened and closed under each package, then each
    package's RunHeartbeat: equal ``last_span`` fields (the port's
    writer wrote None before it took the tracer's last closed span)."""
    monkeypatch.setattr(tspans, "_LAST_CLOSED", None)
    monkeypatch.setattr(jspans, "_LAST_CLOSED", None)
    docs = {}
    for name, spans_mod, mod in (("port", tspans, hb), ("jax", jspans, jhb)):
        tracer = spans_mod.SpanTracer(
            trace_id=spans_mod.derive_trace_id("pert:abc"))
        with tracer.span("step2"):
            with tracer.span("fit/chunk"):
                pass
            tracer.record_span("fit/chunk", start_unix=1000.0,
                               end_unix=1234.5678)
        tracer.record_span("step2/decode", start_unix=2000.0,
                           end_unix=2345.6789)
        mod.RunHeartbeat(tmp_path / name, interval_seconds=1.0)
        docs[name] = mod.read_heartbeat(mod.host_path(tmp_path / name, 0))
    assert docs["port"]["last_span"] == docs["jax"]["last_span"] == {
        "name": "step2/decode", "trace_id": tspans.derive_trace_id("pert:abc"),
        "end_unix": 2345.679}


def test_a_traced_durable_run_reads_done_with_its_last_span(
        synthetic_frames, tmp_path):
    """A port run with checkpoint_dir and trace_spans: its health/ reads
    done in both packages, no rule fails, and the heartbeat names the
    last span the run closed."""
    ck = tmp_path / "ck"
    t0 = time.time()
    run_port(synthetic_frames, PertConfig(
        **BASE, checkpoint_dir=str(ck), trace_spans=True,
        heartbeat_interval_seconds=0.0))
    agg = _same_aggregate(ck / "health", time.time())
    assert agg["states"] == {"done": 1} and agg["missing_ranks"] == []
    assert alerts_mod.failing(_verdicts(agg)) == []
    last = agg["hosts"][0]["doc"]["last_span"]
    assert last is not None and last["end_unix"] >= round(t0, 3)
