"""Declarative run-health alerts over heartbeats + aggregate state (port,
a copy, of the JAX package's ``obs/alerts.py``; ``load_rules()`` reads the
port's own ``obs/alert_rules.json``).

The fleet already gates *performance* declaratively (``pert_fleet
regress`` reads per-metric ``regress`` rows out of the metrics
manifest); this module gives *run health* the same shape: a checked-in
rule file (``obs/alert_rules.json``) instead of thresholds buried in
watcher code, validated against the metric catalogue at load time.
:func:`evaluate` runs the rules over one ``aggregate_health`` summary
and :func:`failing` lists the error-severity rules that fired (what a
watcher's exit code gates; the port's watch tool is ROADMAP A11b).

Rule grammar (one JSON object per rule):

* common keys: ``name`` (unique slug), ``kind``, ``severity``
  (``error`` gates the exit code, ``warning`` only reports), optional
  ``help``;
* ``kind: "threshold"`` — exactly one of ``field`` (a heartbeat or
  aggregate field name, validated against the vocabularies
  ``obs/heartbeat.py`` exports) or ``metric`` (a base metric name,
  validated against ``metrics_manifest.json``), plus ``op`` (one of
  ``> >= < <= == !=``) and ``value``.  Aggregate fields are compared
  once; heartbeat fields and metrics are compared per host and the
  rule fires when ANY host breaches (the detail names the ranks).
  ``None``/missing values never fire — no data is not a breach
  (``absence`` is its own kind);
* ``kind: "staleness"`` — ``max_level`` (a non-terminal rung of the
  freshness ladder); fires when any host is *worse* than the tolerated
  level.  ``max_level: "stale"`` therefore fires only on
  ``presumed_lost`` — the pre-deadlock hostloss alarm;
* ``kind: "desync"`` — fires when running hosts report different steps;
* ``kind: "absence"`` — fires when no heartbeats exist at all or a
  declared rank has never written one.

Validation is strict and total at load: unknown kinds, severities,
operators, extra keys, unknown metric names and unknown field names
all raise :class:`AlertRuleError` — a typo in the rule file fails in
CI, not silently at 3am on the flagship run.
"""

from __future__ import annotations

import json
import pathlib
from typing import Callable, Dict, List, Optional

from scdna_replication_tools_tpu_torch.obs import heartbeat as heartbeat_mod
from scdna_replication_tools_tpu_torch.obs.metrics import (
    manifest_metrics,
    metric_base_name,
)

DEFAULT_RULES_PATH = pathlib.Path(__file__).parent / "alert_rules.json"

_SEVERITIES = ("error", "warning")
_OPS: Dict[str, Callable] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}
_COMMON_KEYS = {"name", "kind", "severity", "help"}
_KIND_KEYS = {
    "threshold": {"field", "metric", "op", "value"},
    "staleness": {"max_level"},
    "desync": set(),
    "absence": set(),
}
#: staleness ``max_level`` must be a non-terminal rung with something
#: worse than it — "presumed_lost" would tolerate everything
_STALENESS_LEVELS = ("fresh", "lagging", "stale")


class AlertRuleError(ValueError):
    """A rule file failed validation (bad grammar, unknown name)."""


def _fail(rule_name, msg):
    raise AlertRuleError(f"alert rule {rule_name!r}: {msg}")


def validate_rules(doc: dict) -> List[dict]:
    """Validate a parsed rule file; returns the rule list.

    Raises :class:`AlertRuleError` on the first violation.
    """
    if not isinstance(doc, dict) or not isinstance(
            doc.get("rules"), list):
        raise AlertRuleError(
            "rule file must be an object with a 'rules' array")
    known_metrics = set(manifest_metrics())
    known_fields = (heartbeat_mod.HEARTBEAT_FIELDS
                    | heartbeat_mod.AGGREGATE_FIELDS)
    seen = set()
    for rule in doc["rules"]:
        if not isinstance(rule, dict):
            raise AlertRuleError(f"rule is not an object: {rule!r}")
        name = rule.get("name")
        if not name or not isinstance(name, str):
            raise AlertRuleError(f"rule missing a name: {rule!r}")
        if name in seen:
            _fail(name, "duplicate rule name")
        seen.add(name)
        kind = rule.get("kind")
        if kind not in _KIND_KEYS:
            _fail(name, f"unknown kind {kind!r} "
                        f"(expected one of {sorted(_KIND_KEYS)})")
        if rule.get("severity") not in _SEVERITIES:
            _fail(name, f"severity must be one of {_SEVERITIES}")
        extra = set(rule) - _COMMON_KEYS - _KIND_KEYS[kind]
        if extra:
            _fail(name, f"unknown keys for kind {kind!r}: "
                        f"{sorted(extra)}")
        if kind == "threshold":
            field, metric = rule.get("field"), rule.get("metric")
            if bool(field) == bool(metric):
                _fail(name, "exactly one of 'field' or 'metric' "
                            "is required")
            if field and field not in known_fields:
                _fail(name, f"unknown field {field!r} (not a heartbeat "
                            "or aggregate field)")
            if metric and metric not in known_metrics:
                _fail(name, f"unknown metric {metric!r} (not in "
                            "metrics_manifest.json)")
            if rule.get("op") not in _OPS:
                _fail(name, f"op must be one of {sorted(_OPS)}")
            if not isinstance(rule.get("value"), (int, float)) \
                    or isinstance(rule.get("value"), bool):
                _fail(name, "value must be a number")
        elif kind == "staleness":
            if rule.get("max_level") not in _STALENESS_LEVELS:
                _fail(name, f"max_level must be one of "
                            f"{_STALENESS_LEVELS}")
    return doc["rules"]


def load_rules(path=None) -> List[dict]:
    """Load + validate a rule file (default: the checked-in one)."""
    path = pathlib.Path(path or DEFAULT_RULES_PATH)
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError) as exc:
        raise AlertRuleError(f"cannot read rule file {path}: {exc}")
    return validate_rules(doc)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _breaching_hosts(rule: dict, hosts: List[dict]) -> List[str]:
    """Per-host threshold check; returns 'rank=value' breach details."""
    op = _OPS[rule["op"]]
    target = rule["value"]
    field, metric = rule.get("field"), rule.get("metric")
    out = []
    for h in hosts:
        doc = h["doc"]
        if metric:
            for key, value in (doc.get("metrics") or {}).items():
                if metric_base_name(key) == metric and value is not None \
                        and op(value, target):
                    out.append(f"host{h['rank']}:{key}={value}")
        else:
            value = doc.get(field)
            if isinstance(value, (int, float)) \
                    and not isinstance(value, bool) \
                    and op(value, target):
                out.append(f"host{h['rank']}:{field}={value}")
    return out


def _eval_threshold(rule, aggregate) -> Optional[str]:
    field = rule.get("field")
    if field in heartbeat_mod.AGGREGATE_FIELDS:
        value = aggregate.get(field)
        if isinstance(value, (int, float)) \
                and not isinstance(value, bool) \
                and _OPS[rule["op"]](value, rule["value"]):
            return f"{field}={value} {rule['op']} {rule['value']}"
        return None
    breaches = _breaching_hosts(rule, aggregate["hosts"])
    if breaches:
        return (f"{rule['op']} {rule['value']} breached: "
                + ", ".join(breaches))
    return None


def _eval_staleness(rule, aggregate) -> Optional[str]:
    order = heartbeat_mod.FRESHNESS_ORDER
    limit = order.index(rule["max_level"])
    worst = [f"host{h['rank']}:{h['freshness']}"
             f"(lag {h['age_seconds']}s, seq {h['seq']})"
             for h in aggregate["hosts"]
             if h["freshness"] != "final"
             and order.index(h["freshness"]) > limit]
    if worst:
        return ("heartbeat worse than "
                f"{rule['max_level']}: " + ", ".join(worst))
    return None


def _eval_desync(rule, aggregate) -> Optional[str]:
    if aggregate.get("desync"):
        return ("running hosts in different steps: "
                + ", ".join(aggregate.get("steps") or []))
    return None


def _eval_absence(rule, aggregate) -> Optional[str]:
    if not aggregate["hosts"]:
        return "no heartbeats found"
    if aggregate.get("missing_ranks"):
        return (f"{aggregate['process_count']} processes declared, "
                f"ranks never seen: {aggregate['missing_ranks']}")
    return None


_EVALUATORS = {
    "threshold": _eval_threshold,
    "staleness": _eval_staleness,
    "desync": _eval_desync,
    "absence": _eval_absence,
}


def evaluate(rules: List[dict], aggregate: dict) -> List[dict]:
    """Evaluate every rule against one ``aggregate_health`` summary.

    Returns one verdict per rule: ``{"name", "kind", "severity",
    "fired", "detail"}`` — ``detail`` says *why* when fired.
    """
    verdicts = []
    for rule in rules:
        detail = _EVALUATORS[rule["kind"]](rule, aggregate)
        verdicts.append({
            "name": rule["name"],
            "kind": rule["kind"],
            "severity": rule["severity"],
            "fired": detail is not None,
            "detail": detail,
        })
    return verdicts


def failing(verdicts: List[dict]) -> List[dict]:
    """The verdicts that gate the exit code: fired + error severity."""
    return [v for v in verdicts
            if v["fired"] and v["severity"] == "error"]
