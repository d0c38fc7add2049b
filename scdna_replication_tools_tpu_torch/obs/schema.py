"""Validation of run-log events against the checked-in JSON schema.

Port of ``obs/schema.py``, copied whole (pure stdlib).  The contract
file is the port's own copy of ``runlog_schema.json`` next to this
module, byte-identical to the JAX package's (schema version 9): a
draft-07-style document restricted to the subset this validator
interprets (``type``, ``enum``, ``required``, ``properties``,
``items``), common envelope at the top level, per-event payload under
``definitions/<event>``.  Unknown extra fields are allowed everywhere.
"""

from __future__ import annotations

import functools
import json
import pathlib
from typing import Iterator, List

_SCHEMA_PATH = pathlib.Path(__file__).parent / "runlog_schema.json"

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "integer": int,
    "boolean": bool,
    "null": type(None),
}


@functools.lru_cache(maxsize=1)
def load_schema() -> dict:
    return json.loads(_SCHEMA_PATH.read_text())


def _type_ok(value, type_spec) -> bool:
    names = [type_spec] if isinstance(type_spec, str) else list(type_spec)
    for name in names:
        if name == "number":
            if isinstance(value, (int, float)) \
                    and not isinstance(value, bool):
                return True
        elif name == "integer":
            if isinstance(value, int) and not isinstance(value, bool):
                return True
        else:
            py = _TYPES.get(name)
            if py is not None and isinstance(value, py):
                return True
    return False


def _check(value, spec: dict, where: str) -> Iterator[str]:
    if "type" in spec and not _type_ok(value, spec["type"]):
        yield (f"{where}: expected type {spec['type']}, "
               f"got {type(value).__name__}")
        return
    if "enum" in spec and value not in spec["enum"]:
        yield f"{where}: {value!r} not in {spec['enum']}"
        return
    if isinstance(value, dict):
        for name in spec.get("required", []):
            if name not in value:
                yield f"{where}: missing required field {name!r}"
        for name, sub in spec.get("properties", {}).items():
            if name in value:
                yield from _check(value[name], sub, f"{where}.{name}")
    elif isinstance(value, list) and "items" in spec:
        for i, item in enumerate(value):
            yield from _check(item, spec["items"], f"{where}[{i}]")


def validate_event(event: dict) -> List[str]:
    """Errors for one event dict against the schema; [] when valid."""
    schema = load_schema()
    if not isinstance(event, dict):
        return [f"event is not an object: {type(event).__name__}"]
    errors = list(_check(event, schema, "$"))
    kind = event.get("event")
    per_event = schema.get("definitions", {}).get(kind)
    if kind is not None and per_event is not None:
        errors.extend(_check(event, per_event, f"$({kind})"))
    return errors


def validate_run(path) -> List[str]:
    """Validate a whole run-log file: every line parses and validates,
    the stream opens with ``run_start``, closes with ``run_end``, and
    ``seq`` is the gap-free line index."""
    errors: List[str] = []
    events = []
    for lineno, line in enumerate(
            pathlib.Path(path).read_text().splitlines(), start=1):
        if not line.strip():
            continue
        try:
            ev = json.loads(line)
        except ValueError as exc:
            errors.append(f"line {lineno}: unparseable JSON ({exc})")
            continue
        for err in validate_event(ev):
            errors.append(f"line {lineno}: {err}")
        events.append(ev)
    if not events:
        errors.append("empty run log")
        return errors
    if events[0].get("event") != "run_start":
        errors.append("first event is not run_start")
    if events[-1].get("event") != "run_end":
        errors.append("last event is not run_end "
                      f"(got {events[-1].get('event')!r})")
    seqs = [ev.get("seq") for ev in events]
    if seqs != list(range(len(events))):
        errors.append("seq is not the gap-free 0..n-1 line index")
    return errors
