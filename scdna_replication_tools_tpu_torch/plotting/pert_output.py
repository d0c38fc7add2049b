"""PERT result figures: the 4x2 heatmap panel and input views (port, a
host copy, of the JAX package's ``plotting/pert_output.py``).

Mirrors ``plot_pert_output.py`` (reference: plot_pert_output.py:24-263):
``plot_model_results`` lays out rpm / input CN / PERT CN / replication
state heatmaps for the S row and the G1/2 row, with clone and tau
colorbars on the left edge.
"""

from __future__ import annotations

import matplotlib.colors as mcolors
import matplotlib.pyplot as plt

from scdna_replication_tools_tpu_torch.plotting.utils import (
    get_clone_cmap,
    get_cluster_colors,
    get_rt_cmap,
    make_color_mat_float,
    plot_clustered_cell_cn_matrix,
    plot_colorbar,
)


def _secondary_values(cn, cell_ids, col):
    per_cell = cn[["cell_id", col]].drop_duplicates("cell_id") \
        .set_index("cell_id")[col]
    return [float(per_cell[c]) for c in cell_ids]


def plot_model_results(cn_s, cn_g, argv=None, clone_col="clone_id",
                       second_sort_col="model_tau", rpm_col="rpm",
                       input_cn_col="state", output_cn_col="model_cn_state",
                       output_rep_col="model_rep_state",
                       top_title_prefix="S-phase cells",
                       bottom_title_prefix="G1/2-phase cells",
                       rpm_title="Reads per million",
                       input_cn_title="Input CN states",
                       output_cn_title="PERT CN states",
                       rep_title="PERT replication states",
                       rt_cmap=None, clone_cmap=None, rpm_cmap="viridis",
                       chromosome=None, chrom_boundary_width=1,
                       chrom_labels_to_remove=()):
    """4x2 heatmap panel of PERT inputs and outputs
    (reference: plot_pert_output.py:24-231)."""
    rt_cmap = rt_cmap or get_rt_cmap()
    clone_cmap = dict(clone_cmap or get_clone_cmap())

    cluster_col = "cluster_id"
    # number clones over the union of both frames: an S-only clone must
    # still map (NaN cluster ids would silently drop those cells from the
    # pivot)
    all_clones = sorted(set(cn_g[clone_col].unique())
                        | set(cn_s[clone_col].unique()), key=str)
    clone_dict = {c: i + 1 for i, c in enumerate(all_clones)}
    cn_g = cn_g.copy()
    cn_s = cn_s.copy()
    cn_g[cluster_col] = cn_g[clone_col].map(clone_dict)
    cn_s[cluster_col] = cn_s[clone_col].map(clone_dict)

    fig = plt.figure(figsize=(28, 14))
    panels = [
        (rpm_col, rpm_title, dict(max_cn=None, raw=True, cmap=rpm_cmap)),
        (input_cn_col, input_cn_title, {}),
        (output_cn_col, output_cn_title, {}),
        (output_rep_col, rep_title, dict(cmap=rt_cmap)),
    ]
    lefts = [0.05, 0.29, 0.53, 0.77]
    first_mats = {}

    for row, (cn, prefix, bottom) in enumerate(
            [(cn_s, top_title_prefix, 0.5), (cn_g, bottom_title_prefix, 0.0)]):
        for col, (field, title, kwargs) in enumerate(panels):
            ax = fig.add_axes([lefts[col], bottom, 0.23, 0.45])
            mat = plot_clustered_cell_cn_matrix(
                ax, cn, field, cluster_field_name=cluster_col,
                secondary_field_name=second_sort_col, chromosome=chromosome,
                chrom_boundary_width=chrom_boundary_width,
                chrom_labels_to_remove=chrom_labels_to_remove, **kwargs)
            ax.set_title(f"{prefix}\n{title}")
            ax.set_yticks([])
            ax.set_ylabel("")
            if col == 0:
                first_mats[row] = mat

    # clone + tau colorbars on the left edge (reference: :176-224)
    if len(clone_dict) > 1:
        for key in list(clone_cmap.keys()):
            clone_cmap[key] = mcolors.to_rgba(clone_cmap[key])
        for row, (cn, bottom) in enumerate([(cn_s, 0.5), (cn_g, 0.0)]):
            mat = first_mats[row]
            cell_ids = mat.columns.get_level_values(0).values
            cluster_ids = mat.columns.get_level_values(1).values
            color_mat, _ = get_cluster_colors(cluster_ids, clone_cmap)
            secondary = _secondary_values(cn, cell_ids, second_sort_col)
            secondary_mat, _ = make_color_mat_float(secondary, "Blues")
            plot_colorbar(fig.add_axes([0.03, bottom, 0.01, 0.45]), color_mat)
            plot_colorbar(fig.add_axes([0.04, bottom, 0.01, 0.45]),
                          secondary_mat)

    if argv is not None:
        fig.savefig(argv.plot1, bbox_inches="tight", dpi=300)
        return None
    return fig


def _two_panel(cn_s, cn_g1, field, clone_col, title0, title1, **kwargs):
    cluster_col = "cluster_id"
    all_clones = sorted(set(cn_g1[clone_col].unique())
                        | set(cn_s[clone_col].unique()), key=str)
    clone_dict = {c: i + 1 for i, c in enumerate(all_clones)}
    cn_g1 = cn_g1.copy()
    cn_s = cn_s.copy()
    cn_g1[cluster_col] = cn_g1[clone_col].map(clone_dict)
    cn_s[cluster_col] = cn_s[clone_col].map(clone_dict)

    fig, axes = plt.subplots(1, 2, figsize=(16, 7))
    plot_clustered_cell_cn_matrix(axes[0], cn_g1, field,
                                  cluster_field_name=cluster_col, **kwargs)
    axes[0].set_title(title0)
    plot_clustered_cell_cn_matrix(axes[1], cn_s, field,
                                  cluster_field_name=cluster_col, **kwargs)
    axes[1].set_title(title1)
    for ax in axes:
        ax.set_yticks([])
    return fig


def plot_cn_states(cn_s, cn_g1, argv=None, clone_col="clone_id",
                   cn_col="state", title0="HMMcopy states\nG1/2-phase",
                   title1="HMMcopy states\nS-phase"):
    """reference: plot_pert_output.py:234-247."""
    fig = _two_panel(cn_s, cn_g1, cn_col, clone_col, title0, title1)
    if argv is not None:
        fig.savefig(argv.plot2, bbox_inches="tight", dpi=300)
        return None
    return fig


def plot_rpm(cn_s, cn_g1, argv=None, clone_col="clone_id", rpm_col="rpm",
             title0="Reads per million\nG1/2-phase",
             title1="Reads per million\nS-phase", cmap="viridis"):
    """reference: plot_pert_output.py:250-263."""
    fig = _two_panel(cn_s, cn_g1, rpm_col, clone_col, title0, title1,
                     max_cn=None, raw=True, cmap=cmap)
    if argv is not None:
        fig.savefig(argv.plot3, bbox_inches="tight", dpi=300)
        return None
    return fig
