"""Observability and fit-health policy: the run log and its schema, the
metrics registry, the heartbeat seam, span tracing, the cost ledger, the
run summary, the convergence doctor and the adaptive controller (port of
``obs/{runlog,schema,metrics,heartbeat,spans,meter,summary,doctor,
controller}.py``)."""
