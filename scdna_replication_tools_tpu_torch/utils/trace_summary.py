"""Summarise the port's ``torch.profiler`` traces (port of
``tools/trace_summary.py``'s :func:`scope_totals` and :func:`summarise`).

``PertConfig(profile_dir=...)`` writes one gzipped Chrome trace per step
fit and one of the packaging (``utils/profiling.trace``).  This module
reads them:

    python -m scdna_replication_tools_tpu_torch.utils.trace_summary DIR \\
        [--top 12] [--json] [--out FILE]

Named ranges (``utils/profiling.scope``: ``pert/fit_step``,
``pert/decode``, ``pert/qc_entropy``, ``pert/ppc``) are keyed by their
FULL path, every enclosing ``pert/*`` range joined in order
(``pert/decode/pert/qc_entropy``), as the JAX tool keys nested
``jax.named_scope`` paths.  A range's time is device time: each kernel,
copy and fill on the card counts for the ranges open when the host
launched it (matched through the profiler's correlation ids; a CUDA
graph's kernels through its replay's launch).  A trace without device
activity (a run on the CPU) counts each range's own wall instead, less
the ranges nested in it.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys

_SCOPE_RE = re.compile(r"^pert/[A-Za-z0-9_.:-]+$")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _trace_files(profile_dir: str) -> list:
    """Every trace under ``profile_dir`` (any depth), gz or plain; a gz
    and its plain twin count once."""
    found = set()
    for pattern in ("*.trace.json.gz", "*.trace.json"):
        found.update(glob.glob(os.path.join(profile_dir, "**", pattern),
                               recursive=True))
    for path in list(found):
        if path.endswith(".gz"):
            found.discard(path[:-3])
    return sorted(found)


def _load_trace(path: str) -> dict:
    if path.endswith(".gz"):
        with gzip.open(path) as fh:
            return json.load(fh)
    with open(path) as fh:
        return json.load(fh)


def _complete(events) -> list:
    return [e for e in events if e.get("ph") == "X"
            and isinstance(e.get("ts"), (int, float))]


def _ranges(events) -> list:
    """(start, end, name, pid, tid) of every ``pert/*`` host range."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"], e.get("pid"), e.get("tid"))
                  for e in events if e.get("cat") == "user_annotation"
                  and _SCOPE_RE.match(str(e.get("name", ""))))


def _paths_at(points: list, ranges: list) -> list:
    """The full range path open at each of the sorted host times
    ``points`` ((ts, pid) pairs), over every thread of the process (a
    backward's kernels launch on the autograd thread, inside the range
    its caller opened); None where no range is open."""
    out = []
    j, active = 0, []
    for ts, pid in points:
        while j < len(ranges) and ranges[j][0] <= ts:
            active.append(ranges[j])
            j += 1
        active = [r for r in active if r[1] >= ts]
        names = [r[2] for r in active if r[3] == pid]
        out.append("/".join(names) if names else None)
    return out


def _device_totals(events, ranges) -> collections.Counter:
    launches = {}
    for e in events:
        if e.get("cat") in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("pid"))
    work = []
    for e in events:
        if e.get("cat") in _DEVICE_CATS:
            launch = launches.get((e.get("args") or {}).get("correlation"))
            if launch is not None:
                work.append((launch, float(e.get("dur", 0))))
    work.sort(key=lambda w: w[0][0])
    totals: collections.Counter = collections.Counter()
    for path, (_, dur) in zip(_paths_at([w[0] for w in work], ranges),
                              work):
        if path:
            totals[path] += dur
    return totals


def _host_totals(ranges) -> collections.Counter:
    """Each range's own wall, less the ranges nested in it, by full path
    (per thread)."""
    totals: collections.Counter = collections.Counter()
    by_thread = collections.defaultdict(list)
    for r in ranges:
        by_thread[(r[3], r[4])].append(r)
    for rs in by_thread.values():
        stack = []   # [start, end, path, nested wall]
        for start, end, name, _, _ in rs:
            while stack and stack[-1][1] < start:
                top = stack.pop()
                totals[top[2]] += (top[1] - top[0]) - top[3]
            path = f"{stack[-1][2]}/{name}" if stack else name
            if stack:
                stack[-1][3] += end - start
            stack.append([start, end, path, 0.0])
        for top in stack:
            totals[top[2]] += (top[1] - top[0]) - top[3]
    return totals


def _trace_scopes(data: dict) -> tuple:
    """(totals in microseconds by full range path, device trace?)."""
    events = _complete(data.get("traceEvents", []))
    ranges = _ranges(events)
    on_device = any(e.get("cat") in _DEVICE_CATS for e in events)
    if on_device:
        return _device_totals(events, ranges), True
    return _host_totals(ranges), False


def scope_totals(profile_dir: str) -> dict:
    """Seconds per full ``pert/*`` range path, summed over every trace
    under ``profile_dir`` (see the module docstring).  Returns {} (never
    raises) when the directory holds no readable trace: absent gauges
    are the degradation contract (``api._feed_trace_scope_gauges``)."""
    totals: collections.Counter = collections.Counter()
    for path in _trace_files(profile_dir):
        try:
            data = _load_trace(path)
        except (OSError, ValueError, EOFError):
            continue
        totals.update(_trace_scopes(data)[0])
    return {scope: us / 1e6 for scope, us in totals.items()}


def device_seconds(path: str) -> float:
    """The device work (kernels, copies, fills) of one trace, seconds."""
    events = _complete(_load_trace(path).get("traceEvents", []))
    return sum(float(e.get("dur", 0)) for e in events
               if e.get("cat") in _DEVICE_CATS) / 1e6


def summarise(profile_dir: str, top: int = 12) -> str:
    """Per trace: its top device kernels (or, on the CPU, host ops) by
    total duration, then the time by named range."""
    traces = _trace_files(profile_dir)
    if not traces:
        raise SystemExit(
            f"trace_summary: no *.trace.json(.gz) traces under "
            f"{profile_dir}; write them with PertConfig(profile_dir=...)")
    lines = [f"# torch.profiler trace summary for {profile_dir}",
             "# top device kernels (host ops on the CPU) by total "
             "duration per trace, then the named ranges", ""]
    for path in traces:
        data = _load_trace(path)
        events = _complete(data.get("traceEvents", []))
        scopes, on_device = _trace_scopes(data)
        cats = _DEVICE_CATS if on_device else ("cpu_op",)
        total = collections.Counter()
        for e in events:
            if e.get("cat") in cats:
                total[e.get("name", "?")] += float(e.get("dur", 0))
        lines.append(f"== {os.path.basename(path)}  ({len(events)} events, "
                     f"{'device' if on_device else 'host'} time)")
        for name, dur in total.most_common(top):
            lines.append(f"   {dur / 1e6:10.4f}s  {name[:100]}")
        if scopes:
            lines.append("   -- named ranges --")
            for scope, dur in scopes.most_common():
                lines.append(f"   {dur / 1e6:10.4f}s  {scope}")
        lines.append("")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("profile_dir")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None)
    ap.add_argument("--json", action="store_true",
                    help="the scope totals (full range path -> seconds) "
                         "instead of the text report")
    args = ap.parse_args(argv)
    if args.json:
        if not _trace_files(args.profile_dir):
            raise SystemExit(f"trace_summary: no traces under "
                             f"{args.profile_dir}")
        report = json.dumps({
            "profile_dir": str(args.profile_dir),
            "scope_seconds": {k: round(v, 6) for k, v in
                              sorted(scope_totals(args.profile_dir).items())},
        }, indent=1)
    else:
        report = summarise(args.profile_dir, args.top)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(report + "\n")
    else:
        sys.stdout.write(report + "\n")


if __name__ == "__main__":
    main()
