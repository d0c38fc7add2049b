"""Native host-runtime components (port of the JAX package's ``native/``).

The long-form <-> dense marshalling that feeds every fit runs on a
threaded C++ library (``csrc/pivot.cpp``), compiled at first use by the
host's ``c++`` through the port's one build path (``ops/_cuda.library``,
where the JAX package has ``native/build.py``).  A failed build raises;
only ``use_native=False`` asks for the NumPy scatter.
"""

from scdna_replication_tools_tpu_torch.native.pivot import (  # noqa: F401
    gather_melt,
    scatter_pivot,
)
