"""pertserve on PyTorch and CUDA: the port of ``serve/``.

* :mod:`~scdna_replication_tools_tpu_torch.serve.buckets` and
  :mod:`~scdna_replication_tools_tpu_torch.serve.queue`: copies of the
  shape-bucket ladder and the file-queue spool;
* :mod:`~scdna_replication_tools_tpu_torch.serve.slab`: the slab ledger
  and the coordinator that packs concurrent same-shape fit chunks into
  one launch per iteration through the block-axis kernels;
* :mod:`~scdna_replication_tools_tpu_torch.serve.worker`: the worker,
  one ``scRT`` pipeline per request with its own run log, metrics
  registry, checkpoint directory and span tree, serial (``max_batch=1``)
  or continuously batched (``max_batch`` K > 1);
* :mod:`~scdna_replication_tools_tpu_torch.serve.tsv`: the stream
  back's result files, pandas' bytes formatted by a pool of processes;
* :mod:`~scdna_replication_tools_tpu_torch.serve.cli`: ``python -m
  scdna_replication_tools_tpu_torch.serve.cli worker|submit|status|
  collect``.
"""

from scdna_replication_tools_tpu_torch.serve.buckets import (  # noqa: F401
    Bucket,
    BucketRefusal,
    BucketSet,
)
from scdna_replication_tools_tpu_torch.serve.queue import (  # noqa: F401
    PRIORITY_CLASSES,
    RequestTicket,
    SpoolQueue,
)
from scdna_replication_tools_tpu_torch.serve.slab import (  # noqa: F401
    SlabFitCoordinator,
    SlabState,
)
from scdna_replication_tools_tpu_torch.serve.worker import (  # noqa: F401
    ServeWorker,
)
