"""Observability and fit-health policy: the run log and its schema, the
metrics registry, the heartbeats (writer, seam and read side) and the
run-health alerts, span tracing, the cost ledger, the run summary, the
convergence doctor and the adaptive controller (port of
``obs/{runlog,schema,metrics,heartbeat,alerts,spans,meter,summary,doctor,
controller}.py``)."""
