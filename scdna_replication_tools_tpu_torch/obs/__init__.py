"""Observability and fit-health policy: the run log and its schema, the
metrics registry, the heartbeat seam, the convergence doctor and the
adaptive controller (port of ``obs/{runlog,schema,metrics,heartbeat,
doctor,controller}.py``)."""
