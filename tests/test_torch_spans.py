"""The port's span tracing (``obs/spans.py``, the run log's span
envelope) and run summary (``obs/summary.py``) against the JAX package.

* ``derive_trace_id`` and ``parse_trace_parent`` agree with JAX's on the
  same text, and the same begin / end / record sequence through both
  tracers emits the same ``span_end`` payloads but for the wall-clock
  fields;
* a traced ``scRT`` run of both packages on the same small frames
  (``trace_spans=True``, a ``trace_parent`` handed in as the serving
  worker does) writes logs that both packages' schema validators pass,
  with the trace id on ``run_start``, a ``run`` root span under the
  handed-in parent, every span's parent in the log, the ``span``
  envelope on every other event while the root is open, and the same
  non-phase span names and per-step ``fit/chunk`` spans (their chunk
  indices and iteration ranges, contiguous from 0 to the fit's count);
  an untraced run carries no span material;
* ``summarize_run`` of the port gives JAX's dict on both logs.
"""

import json
import pathlib
import sys

import pytest

from scdna_replication_tools_tpu.api import scRT as JaxScRT
from scdna_replication_tools_tpu.obs import spans as jspans
from scdna_replication_tools_tpu.obs import summary as jsummary
from scdna_replication_tools_tpu.obs.schema import validate_run as jvalidate
from scdna_replication_tools_tpu_torch import scRT
from scdna_replication_tools_tpu_torch.obs import spans as tspans
from scdna_replication_tools_tpu_torch.obs import summary as tsummary
from scdna_replication_tools_tpu_torch.obs.schema import validate_run

from test_torch_model import one_torch_thread  # noqa: F401

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "tools"))
from test_serve import REQUEST_OPTIONS, _frames  # noqa: E402

TIME_FIELDS = ("start_unix", "duration_seconds")
PARENT = "00aa11bb22cc33dd:r0.1"


@pytest.mark.parametrize("text", ["req-0001", "pert:abc123", "", "é ✓"])
def test_trace_ids_and_parents_equal_jax(text):
    assert tspans.derive_trace_id(text) == jspans.derive_trace_id(text)
    for value in (f"{tspans.derive_trace_id(text)}:r0.3", text, None,
                  "a:b:c"):
        assert tspans.parse_trace_parent(value) \
            == jspans.parse_trace_parent(value)


def _drive(mod):
    out = []
    tr = mod.SpanTracer.from_trace_parent(PARENT, fallback_seed="x")
    tr.sink = out.append
    root = tr.begin("run", run_name="pert")
    with tr.span("admission", request_id="r"):
        pass
    tr.record_span("fit/chunk", 10.0, 12.5, chunk=1, iter_start=0,
                   iter_end=25, action="continue", verdict="plateaued")
    inner = tr.begin("stream_back")
    assert tr.current() is inner
    tr.end(root, status="ok")        # closes the straggler under it too
    return [{k: v for k, v in p.items() if k not in TIME_FIELDS}
            for p in out], tr.trace_parent(None)


def test_tracer_payloads_equal_jax():
    assert _drive(tspans) == _drive(jspans)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    sim_s, sim_g = _frames(seed=3)
    opts = {**REQUEST_OPTIONS, "max_iter": 60, "min_iter": 20}
    paths = {k: str(root / f"{k}.jsonl") for k in ("torch", "jax", "off")}
    scRT(sim_s.copy(), sim_g.copy(), telemetry_path=paths["torch"],
         trace_spans=True, trace_parent=PARENT, request_id="r-torch",
         device="cpu", **opts).infer("pert")
    JaxScRT(sim_s.copy(), sim_g.copy(), telemetry_path=paths["jax"],
            trace_spans=True, trace_parent=PARENT, request_id="r-jax",
            compile_cache_dir=None, **opts).infer("pert")
    scRT(sim_s.copy(), sim_g.copy(), telemetry_path=paths["off"],
         device="cpu", **opts).infer("pert")
    return {k: ([json.loads(line) for line in open(p)], p)
            for k, p in paths.items()}


def _spans(events):
    return [e for e in events if e["event"] == "span_end"]


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_traced_log_is_a_valid_span_tree(logs, which):
    events, path = logs[which]
    assert validate_run(path) == [] and jvalidate(path) == []
    start = events[0]
    assert start["event"] == "run_start"
    assert start["trace_id"] == PARENT.split(":")[0]
    spans = _spans(events)
    ids = {s["span_id"] for s in spans}
    root = [s for s in spans if s["name"] == "run"]
    assert len(root) == 1 and root[0]["parent_id"] == PARENT.split(":")[1]
    for s in spans:
        assert s["trace_id"] == start["trace_id"]
        if s is not root[0]:
            assert s["parent_id"] in ids, s
    # every event while the root span is open carries the envelope (the
    # run_end snapshot and run_end follow the root's close)
    for e in events[1:events.index(root[0])]:
        if e["event"] != "span_end":
            assert e["span"]["trace_id"] == start["trace_id"], e["event"]


def test_span_trees_match_jax(logs):
    t_events, j_events = logs["torch"][0], logs["jax"][0]
    names = [{s["name"] for s in _spans(ev)
              if s["attrs"].get("kind") != "phase"}
             for ev in (t_events, j_events)]
    assert names[0] == names[1]
    for ev in (t_events, j_events):
        chunks = [s["attrs"] for s in _spans(ev)
                  if s["name"] == "fit/chunk"]
        iters = [e["iters"] for e in ev if e["event"] == "fit_end"]
        # one run of chunks per fit, each from 0, contiguous, ending at
        # the fit's counted iterations
        runs, cur = [], None
        for c in chunks:
            if c["chunk"] == 1:
                cur = []
                runs.append(cur)
            cur.append(c)
        assert len(runs) == len(iters)
        for run, n in zip(runs, iters):
            assert run[0]["iter_start"] == 0
            for a, b in zip(run, run[1:]):
                assert b["iter_start"] == a["iter_end"]
            assert run[-1]["iter_end"] == n
    assert [e["iters"] for e in t_events if e["event"] == "fit_end"] \
        == [e["iters"] for e in j_events if e["event"] == "fit_end"]


def test_untraced_run_has_no_span_material(logs):
    events, _ = logs["off"]
    assert not _spans(events)
    assert all("span" not in e for e in events)
    assert "trace_id" not in events[0]


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_summaries_equal_jax(logs, which):
    _, path = logs[which]
    assert tsummary.summarize_run(path) == jsummary.summarize_run(path)
    events = tsummary.read_events(path)
    assert tsummary.summarize_events(events) \
        == jsummary.summarize_events(events)
