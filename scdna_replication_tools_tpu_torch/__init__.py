"""PERT on PyTorch and CUDA: the port of ``scdna_replication_tools_tpu``.

The package mirrors the JAX package's module layout, so each module here
names its reference module there.  It imports ``torch`` and never
``jax``, nor anything of the JAX package.  The three-step PERT fit runs
through ``scRT(...).infer(level='pert')`` on a CUDA device, with the
fused enumeration kernels and the fused Adam update written in CUDA C++
for Hopper (``csrc/``, built with ``nvcc`` at first use), and each run
writes the JAX package's schema-v9 JSONL run log (``obs/runlog.py``).
After a fit, ``pipeline/phase.py`` calls cell-cycle phases and
``pipeline/ccc_features.py`` computes the classifier features;
``plotting/`` draws the figures (it needs matplotlib, which nothing else
imports); ``obs/heartbeat.aggregate_health`` and ``obs/alerts.py`` read
a run's health directory.

Entry points (:class:`scRT`, :class:`SPF`, :class:`PertInference`,
:func:`fit_map`, the simulator and the command-line functions of
``cli.py``) run on ``cuda`` unless the caller passes ``device='cpu'``; with no
device given and no GPU present they raise.
"""

from scdna_replication_tools_tpu_torch.api import SPF, scRT
from scdna_replication_tools_tpu_torch.device import resolve_device
from scdna_replication_tools_tpu_torch.infer.runner import PertInference
from scdna_replication_tools_tpu_torch.infer.svi import fit_map

__all__ = ["scRT", "SPF", "PertInference", "fit_map", "resolve_device"]
