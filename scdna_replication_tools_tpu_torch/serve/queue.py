"""File-queue spool: the serving worker's request transport.

Port of ``serve/queue.py``, copied whole.

A request is one JSON ticket in a spool directory — simple, testable,
CI-able, no network dependency (a network front-end can feed the same
spool later; the worker neither knows nor cares).  The protocol leans
entirely on two POSIX atomicity guarantees:

* **submission** writes the ticket with
  ``utils.fileio.atomic_write_bytes`` (same-directory temp + fsync +
  ``os.replace``), so the worker can never observe a torn ticket;
* **claiming** is ``os.rename(pending/x.json, active/x.json)`` — a
  rename either succeeds (this worker owns the request) or raises
  (another worker won the race); no locks, no leases.

Layout under the spool root::

    pending/<request_id>.json   submitted, waiting
    active/<request_id>.json    claimed by a worker
    done/<request_id>.json      terminal ticket (status + result paths)
    failed/<request_id>.json    terminal ticket (status + error)
    data/<request_id>/          input TSVs (``submit_frames`` writes
                                them here; ``submit`` may reference
                                files anywhere)
    results/<request_id>/       the worker's per-request output tree:
                                output.tsv, supp.tsv, cell_qc.tsv,
                                run.jsonl (the request's RunLog),
                                ckpt/ (per-request durable-run
                                checkpoints), request.json (the final
                                ticket, duplicated for collectors that
                                only see the results tree)

Claim order is priority-class first (``high`` > ``normal`` > ``low``,
ticket-borne, default ``normal``), oldest-deadline-first within a
class (``deadline_unix``, optional), then FIFO by submission time
(ticket mtime, request id as the same-instant tiebreak —
caller-supplied ids must not jump the queue).  A ticket carrying an
unknown priority class is parked as ``failed`` at claim time rather
than wedging the queue — exactly like an unreadable ticket.
``options`` is the whitelisted subset of ``scRT`` keyword arguments a
request may override (budgets, prior method, faults for chaos suites,
...) — the worker merges them over its own defaults; see
``serve/worker.py::REQUEST_OPTION_KEYS``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import pathlib
import time
from typing import List, Optional

from scdna_replication_tools_tpu_torch.utils.fileio import atomic_write_bytes

_STATES = ("pending", "active", "done", "failed")
_TICKET_COUNTER = itertools.count()

# the SLO admission classes, best first.  Order within a class is
# oldest-deadline-first, then submission FIFO — see SpoolQueue.pending.
PRIORITY_CLASSES = ("high", "normal", "low")
_PRIORITY_RANK = {name: i for i, name in enumerate(PRIORITY_CLASSES)}


def _new_request_id() -> str:
    """Time-sortable unique id: second stamp + pid + per-process
    counter — FIFO order IS lexical order, and two processes (or two
    same-second submissions of one process) cannot collide."""
    return (f"req_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
            f"_{next(_TICKET_COUNTER):06d}")


@dataclasses.dataclass
class RequestTicket:
    """One queued inference request (the JSON ticket's typed view)."""

    request_id: str
    s_path: str
    g1_path: str
    options: dict = dataclasses.field(default_factory=dict)
    submitted_unix: float = 0.0
    # the causal trace id riding the ticket (obs/spans.py): submission
    # derives it from the request id, the worker's request span and the
    # per-request run's whole span tree carry it, and pert_trace
    # stitches the worker + request logs into one timeline on it
    trace_id: Optional[str] = None
    # SLO admission class (PRIORITY_CLASSES; absent in old tickets ->
    # 'normal' via the from_json default) and the optional request
    # deadline — the claim order is (class, oldest deadline, FIFO)
    priority: str = "normal"
    deadline_unix: Optional[float] = None
    # shape hint ({"num_cells_s", "num_cells_g1", "num_loci"}), filled
    # by submit_frames (it knows the frames): lets a batched worker
    # claim same-bucket-rung neighbours for one slab WITHOUT reading
    # the input TSVs.  Advisory only — admission re-probes the real
    # frames; a hint-less ticket is still claimable
    shape: Optional[dict] = None
    # multi-tenant attribution (schema v9): an OPTIONAL caller-supplied
    # tenant label the meter and the worker's by-tenant rollup key cost
    # on.  Advisory identity, not authentication — the worker SANITIZES
    # it (charset/length) before trusting it anywhere (a spool writer
    # can forge any ticket field; a forged tenant must not be able to
    # break status.json or smuggle bytes into event streams)
    tenant: Optional[str] = None
    # terminal fields, filled by the worker's finish()
    status: Optional[str] = None          # ok / failed / refused
    error: Optional[str] = None
    results_dir: Optional[str] = None
    # claim-side timestamps (worker-local, set by claim(), not part of
    # the submitted ticket): the pending file's mtime — the atomic
    # commit instant — and the claim instant.  Their difference IS the
    # queue-wait span.
    pending_mtime: Optional[float] = None
    claimed_unix: Optional[float] = None

    def to_json(self) -> bytes:
        return (json.dumps(dataclasses.asdict(self), indent=1,
                           sort_keys=True) + "\n").encode()

    @classmethod
    def from_json(cls, blob: bytes) -> "RequestTicket":
        doc = json.loads(blob)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in known})


class SpoolQueue:
    """One spool directory (see module docstring)."""

    def __init__(self, root):
        self.root = pathlib.Path(root)

    def ensure_dirs(self) -> None:
        for state in _STATES:
            (self.root / state).mkdir(parents=True, exist_ok=True)
        (self.root / "results").mkdir(parents=True, exist_ok=True)

    def _ticket_path(self, state: str, request_id: str) -> pathlib.Path:
        return self.root / state / f"{request_id}.json"

    def results_dir(self, request_id: str) -> pathlib.Path:
        return self.root / "results" / request_id

    @property
    def status_path(self) -> pathlib.Path:
        """The worker's live status surface: ``status.json`` in the
        spool root, rewritten atomically by the worker's heartbeat
        (see ``serve/worker.py``) and rendered by ``pert-serve
        status``."""
        return self.root / "status.json"

    # -- submission -------------------------------------------------------

    def submit(self, s_path, g1_path, options: Optional[dict] = None,
               request_id: Optional[str] = None,
               priority: str = "normal",
               deadline_unix: Optional[float] = None,
               shape: Optional[dict] = None,
               tenant: Optional[str] = None) -> str:
        """Queue a request referencing existing input TSVs; returns the
        request id.  Submission is atomic: the worker either sees the
        whole ticket in ``pending/`` or nothing."""
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority {priority!r} — one of "
                f"{PRIORITY_CLASSES} (a forged ticket with a bad class "
                f"is parked at claim time; the API refuses upfront)")
        self.ensure_dirs()
        request_id = request_id or _new_request_id()
        if any(self._ticket_path(s, request_id).exists()
               for s in _STATES):
            raise ValueError(f"request id {request_id!r} already exists "
                             f"in the spool {self.root}")
        from scdna_replication_tools_tpu_torch.obs.spans import derive_trace_id

        ticket = RequestTicket(
            request_id=request_id, s_path=str(s_path),
            g1_path=str(g1_path), options=dict(options or {}),
            submitted_unix=round(time.time(), 3),
            trace_id=derive_trace_id(request_id),
            priority=priority,
            deadline_unix=(round(float(deadline_unix), 3)
                           if deadline_unix is not None else None),
            shape=dict(shape) if shape else None,
            tenant=str(tenant) if tenant else None)
        atomic_write_bytes(self._ticket_path("pending", request_id),
                           ticket.to_json())
        return request_id

    def submit_frames(self, df_s, df_g1, options: Optional[dict] = None,
                      request_id: Optional[str] = None,
                      priority: str = "normal",
                      deadline_unix: Optional[float] = None,
                      tenant: Optional[str] = None) -> str:
        """Queue a request from in-memory long-form frames: the frames
        land as TSVs under ``data/<id>/`` BEFORE the ticket appears in
        ``pending/`` (the ticket's atomic rename is the commit point,
        so a worker can never claim a request whose data is still
        being written).  Knowing the frames, it also stamps the
        ticket's bucket-rung ``shape`` hint."""
        request_id = request_id or _new_request_id()
        data_dir = self.root / "data" / request_id
        data_dir.mkdir(parents=True, exist_ok=True)
        s_path = data_dir / "cn_s.tsv"
        g1_path = data_dir / "cn_g1.tsv"
        df_s.to_csv(s_path, sep="\t", index=False)
        df_g1.to_csv(g1_path, sep="\t", index=False)
        opts = options or {}
        try:
            cell_col = opts.get("cell_col", "cell_id")
            chr_col = opts.get("chr_col", "chr")
            start_col = opts.get("start_col", "start")
            shape = {
                "num_cells_s": int(df_s[cell_col].nunique()),
                "num_cells_g1": int(df_g1[cell_col].nunique()),
                "num_loci": int(df_s[[chr_col, start_col]]
                                .drop_duplicates().shape[0]),
            }
        except (KeyError, TypeError):
            shape = None  # unprobeable frames: admission decides
        return self.submit(s_path, g1_path, options=options,
                           request_id=request_id, priority=priority,
                           deadline_unix=deadline_unix, shape=shape,
                           tenant=tenant)

    # -- worker side ------------------------------------------------------

    def pending(self) -> List[pathlib.Path]:
        """Pending ticket paths in claim order: priority class first
        (high > normal > low), oldest ``deadline_unix`` next within a
        class, then submission time (the ticket file's mtime — set by
        the atomic commit), id as the same-instant tiebreak.  Not
        lexical id alone: callers may supply their own
        ``--request-id``, and a late 'a_urgent' must not jump ahead of
        earlier generated ``req_...`` tickets.

        A ticket with an unknown/malformed priority sorts FIRST so the
        next claim() immediately parks it as failed — a poisoned
        ticket must not linger mid-queue, invisible, while traffic
        flows around it."""
        root = self.root / "pending"
        if not root.is_dir():
            return []

        def _key(path: pathlib.Path):
            try:
                mtime = path.stat().st_mtime
            except OSError:  # claimed/vanished mid-scan: order last,
                # claim() skips it when the rename fails
                return (len(PRIORITY_CLASSES), float("inf"),
                        float("inf"), path.name)
            rank = _PRIORITY_RANK["normal"]
            deadline = float("inf")
            try:
                doc = json.loads(path.read_bytes())
                rank = _PRIORITY_RANK.get(
                    doc.get("priority", "normal"), -1)
                if doc.get("deadline_unix") is not None:
                    deadline = float(doc["deadline_unix"])
            except (OSError, ValueError, TypeError):
                rank = -1  # unreadable: claim first -> parked as failed
            return (rank, deadline, mtime, path.name)

        return sorted(root.glob("*.json"), key=_key)

    def depth(self) -> int:
        return len(self.pending())

    def claim(self, predicate=None) -> Optional[RequestTicket]:
        """Claim the best pending request (see :meth:`pending` for the
        order), or None when the queue is empty.  Rename-based: losing
        a claim race to another worker is silent (the next candidate is
        tried).

        ``predicate(ticket) -> bool`` filters candidates BEFORE the
        claim rename — the batched worker's same-bucket-rung selection.
        A ticket that cannot be parsed or carries an unknown priority
        class bypasses the predicate so it still gets parked as failed
        here instead of wedging every filtered claim."""
        for path in self.pending():
            target = self.root / "active" / path.name
            peeked = None
            parse_error = None
            try:
                peeked = RequestTicket.from_json(path.read_bytes())
            except (OSError, ValueError, TypeError) as exc:
                parse_error = exc
            bad_priority = (peeked is not None
                            and peeked.priority not in PRIORITY_CLASSES)
            if (predicate is not None and parse_error is None
                    and not bad_priority and not predicate(peeked)):
                continue
            try:
                # the pending file's mtime is the atomic-commit instant
                # — the queue-wait span's start; read it BEFORE the
                # rename (the rename preserves mtime, but a stat after
                # a lost race would hit the wrong file)
                mtime = path.stat().st_mtime
            except OSError:
                mtime = None
            try:
                os.rename(path, target)
            except OSError:
                continue  # another worker won, or the ticket vanished
            try:
                ticket = RequestTicket.from_json(target.read_bytes())
                if ticket.priority not in PRIORITY_CLASSES:
                    raise ValueError(
                        f"unknown priority {ticket.priority!r} (one of "
                        f"{PRIORITY_CLASSES})")
                ticket.pending_mtime = mtime
                ticket.claimed_unix = round(time.time(), 6)
                return ticket
            except (OSError, ValueError, TypeError) as exc:
                # a malformed ticket — unparseable, or a priority class
                # the admission order cannot place — must not wedge the
                # queue: park it as failed with the error recorded
                atomic_write_bytes(
                    self._ticket_path("failed", path.stem),
                    (json.dumps({"request_id": path.stem,
                                 "status": "failed",
                                 "error": f"unreadable ticket: {exc}"},
                                indent=1) + "\n").encode())
                try:
                    target.unlink()
                except OSError:
                    pass
        return None

    def finish(self, ticket: RequestTicket, status: str,
               error: Optional[str] = None,
               results_dir: Optional[str] = None) -> pathlib.Path:
        """Commit a claimed request's terminal state: final ticket into
        ``done/`` (status ``ok``) or ``failed/`` (``failed`` /
        ``refused``), a copy into the results tree, and the ``active/``
        claim removed — in that order, so a crash mid-finish leaves the
        claim visible rather than losing the request."""
        ticket.status = status
        ticket.error = error
        ticket.results_dir = str(results_dir) if results_dir else None
        state = "done" if status == "ok" else "failed"
        final = self._ticket_path(state, ticket.request_id)
        atomic_write_bytes(final, ticket.to_json())
        if results_dir:
            atomic_write_bytes(
                pathlib.Path(results_dir) / "request.json",
                ticket.to_json())
        try:
            self._ticket_path("active", ticket.request_id).unlink()
        except OSError:
            pass
        return final

    # -- inspection -------------------------------------------------------

    def status(self, request_id: str) -> Optional[dict]:
        """``{"state": ..., **ticket}`` for a request, or None when the
        spool has never seen it."""
        for state in ("done", "failed", "active", "pending"):
            path = self._ticket_path(state, request_id)
            if path.exists():
                try:
                    doc = json.loads(path.read_text())
                except (OSError, ValueError):
                    doc = {"request_id": request_id}
                return {"state": state, **doc}
        return None

    def list_requests(self) -> List[dict]:
        """Every known request's status dict, FIFO by id."""
        seen = {}
        for state in ("pending", "active", "done", "failed"):
            root = self.root / state
            if not root.is_dir():
                continue
            for path in root.glob("*.json"):
                seen.setdefault(path.stem, state)
        return [self.status(rid) for rid in sorted(seen)]
