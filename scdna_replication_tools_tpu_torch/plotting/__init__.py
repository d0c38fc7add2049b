"""Figures of a PERT run (port, a copy, of the JAX package's
``plotting/``).  Host matplotlib and scipy code: nothing on the fit's
path imports it, so the package, ``api`` and ``cli`` load without
matplotlib.
"""

from scdna_replication_tools_tpu_torch.plotting.utils import (
    get_clone_cmap,
    get_cn_cmap,
    get_phase_cmap,
    get_rt_cmap,
    plot_cell_cn_profile,
    plot_clustered_cell_cn_matrix,
)
from scdna_replication_tools_tpu_torch.plotting.pert_output import (
    plot_cn_states,
    plot_model_results,
    plot_rpm,
)

__all__ = [
    "get_clone_cmap",
    "get_cn_cmap",
    "get_phase_cmap",
    "get_rt_cmap",
    "plot_cell_cn_profile",
    "plot_clustered_cell_cn_matrix",
    "plot_cn_states",
    "plot_model_results",
    "plot_rpm",
]
