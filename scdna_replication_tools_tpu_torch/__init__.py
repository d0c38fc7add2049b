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

import importlib

# name -> the module that defines it, imported at first use (PEP 562), so
# that the host-only tools (``tools/pert_report`` and the other readers)
# load without torch
_EXPORTS = {"scRT": "api", "SPF": "api", "PertInference": "infer.runner",
            "fit_map": "infer.svi", "resolve_device": "device"}

__all__ = ["scRT", "SPF", "PertInference", "fit_map", "resolve_device"]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
