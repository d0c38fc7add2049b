"""Shape buckets: the serving worker's program-residency contract.

Port of ``serve/buckets.py``, copied whole.

XLA programs are shape-specialised, so a worker that padded nothing
would compile once per distinct (cells, loci) request shape — compile
cost scaling with tenant diversity instead of amortising to zero.  The
bucket ladder quantises request shapes onto a small fixed grid: each
request is padded (masked pad cells/loci, the SAME equal-length-slab
machinery the sharded runner already uses — ``data/loader.pad_cells``
/ ``pad_loci`` behind ``PertConfig.pad_cells_to``/``pad_loci_to``) up
to the smallest bucket that fits it, and every request in a bucket
then traces and compiles the SAME programs: the fixed-size
``_run_fit_chunk`` fit program (infer/svi.py) and the equal-length
decode slabs (models/pert.py) key purely on batch shapes + model
statics, so the worker's resident AOT program cache serves request
N>1 with zero compile misses.

The cost of quantisation is padded work.  The default ladders are
powers of two, which bounds it analytically for any request AT LEAST
HALF THE SMALLEST RUNG per axis: each axis then pads by less than 2x,
so the padded area is less than 4x the real area and the pad fraction
``1 - real/(bucket_cells * bucket_loci)`` stays strictly below 0.75
(typically far below — a request just over a bucket edge pays the
most).  Requests smaller than that floor still admit — they land in
the smallest bucket with a proportionally higher pad fraction (a
2-cell cohort in the 8-cell rung pads 4x on that axis); the
``pert_serve_bucket_pad_frac`` gauge is what surfaces it.  Pad
cells/loci are masked out of every reduction in the compiled loss, so
padding costs device FLOPs, never correctness.

Requests larger than the largest bucket are REFUSED
(:class:`BucketRefusal`) rather than compiled ad hoc: an unbounded
shape would silently evict resident programs and stall the queue
behind a fresh multi-second compile — the caller should either grow
the worker's ladder or route the outlier to a batch run.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

# Default ladders.  Cells: starts at the smallest shard-friendly size
# and doubles to a 4096-cell ceiling (the flagship single-device
# artifact scale; larger cohorts are batch workloads, not serving
# requests).  Loci: powers of two 64..262144 — the 262144 ceiling
# admits hg19 at 20kb (~154,770 bins, the long-genome regime the
# reference README warns about).  Powers of two keep every bucket
# divisible by any power-of-two mesh extent.
DEFAULT_CELLS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
DEFAULT_LOCI = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
                32768, 65536, 131072, 262144)


class BucketRefusal(ValueError):
    """A request shape exceeds the largest configured bucket."""

    def __init__(self, num_cells: int, num_loci: int,
                 max_cells: int, max_loci: int):
        super().__init__(
            f"request shape ({num_cells} cells x {num_loci} loci) "
            f"exceeds the largest bucket ({max_cells} x {max_loci}); "
            f"grow the worker's bucket ladder (--cells-buckets / "
            f"--loci-buckets) or run the request as a batch job")
        self.num_cells = num_cells
        self.num_loci = num_loci


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One (cells, loci) shape bucket."""

    cells: int
    loci: int

    @property
    def name(self) -> str:
        return f"c{self.cells}xl{self.loci}"

    def pad_frac(self, num_cells: int, num_loci: int) -> float:
        """Fraction of the bucket's (cells x loci) area that is padding
        for a request of the given real shape."""
        real = num_cells * num_loci
        return 1.0 - real / float(self.cells * self.loci)


@dataclasses.dataclass(frozen=True)
class BucketSet:
    """An ascending ladder of cell sizes x an ascending ladder of loci
    sizes; selection picks the smallest bucket that fits both axes."""

    cells: Tuple[int, ...] = DEFAULT_CELLS
    loci: Tuple[int, ...] = DEFAULT_LOCI

    def __post_init__(self):
        for name, ladder in (("cells", self.cells), ("loci", self.loci)):
            values = tuple(int(v) for v in ladder)
            if not values or any(v <= 0 for v in values):
                raise ValueError(f"bucket {name} ladder must be a "
                                 f"non-empty sequence of positive ints, "
                                 f"got {ladder!r}")
            if list(values) != sorted(set(values)):
                raise ValueError(f"bucket {name} ladder must be strictly "
                                 f"ascending, got {ladder!r}")
            object.__setattr__(self, name, values)

    @classmethod
    def from_specs(cls, cells_spec=None, loci_spec=None) -> "BucketSet":
        """BucketSet from CLI-style comma-separated ladders; None keeps
        the defaults for that axis."""

        def _parse(spec, default):
            if spec is None or spec == "":
                return default
            if isinstance(spec, str):
                return tuple(int(tok) for tok in spec.split(",")
                             if tok.strip())
            return tuple(int(v) for v in spec)

        return cls(cells=_parse(cells_spec, DEFAULT_CELLS),
                   loci=_parse(loci_spec, DEFAULT_LOCI))

    def select(self, num_cells: int, num_loci: int) -> Bucket:
        """Smallest bucket fitting ``(num_cells, num_loci)``; raises
        :class:`BucketRefusal` above the largest bucket."""
        num_cells = int(num_cells)
        num_loci = int(num_loci)
        if num_cells <= 0 or num_loci <= 0:
            raise ValueError(
                f"request shape must be positive, got "
                f"({num_cells} cells x {num_loci} loci)")
        cells = next((c for c in self.cells if c >= num_cells), None)
        loci = next((l for l in self.loci if l >= num_loci), None)
        if cells is None or loci is None:
            raise BucketRefusal(num_cells, num_loci,
                                self.cells[-1], self.loci[-1])
        return Bucket(cells=cells, loci=loci)

    def select_hint(self, shape) -> "Bucket | None":
        """Bucket for a ticket's advisory ``shape`` hint
        (``{"num_cells_s", "num_cells_g1", "num_loci"}``, written by
        ``SpoolQueue.submit_frames``), or None when the hint is
        absent/malformed/oversized — the batched worker's
        same-rung claim predicate runs on this WITHOUT reading the
        input TSVs, and a None simply defers the decision to real
        admission."""
        if not isinstance(shape, dict):
            return None
        try:
            cells = max(int(shape["num_cells_s"]),
                        int(shape["num_cells_g1"]))
            loci = int(shape["num_loci"])
            return self.select(cells, loci)
        except (BucketRefusal, KeyError, ValueError, TypeError):
            return None

    def describe(self) -> dict:
        return {"cells": list(self.cells), "loci": list(self.loci)}
