"""Fit-health policy: the convergence doctor and the adaptive controller
(port of ``obs/doctor.py`` and ``obs/controller.py``)."""
