"""Plotting primitives: genome-axis profiles, clustered heatmaps, colormaps
(port, a host copy, of the JAX package's ``plotting/utils.py``).

Re-implements the subset of the reference's ``plot_utils.py`` that the
PERT workflow uses (reference: plot_utils.py:15-163 genome scatter,
:166-228 clustered cell x bin heatmap, :230-237 hierarchical secondary
ordering, :241-271 colorbars, :295-430 colormap registries), without the
``scgenome`` dependency (chromosome info inlined in ``refgenome``).

CN state colors follow the standard scWGS convention (blues for losses,
grey neutral, red/purple gradient for gains) so figures read the same as
the reference's.
"""

from __future__ import annotations

import matplotlib
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd
import scipy.cluster.hierarchy as sch
import scipy.spatial.distance as dst
from matplotlib.colors import ListedColormap
from matplotlib.patches import Patch

from scdna_replication_tools_tpu_torch.plotting import refgenome

# ---------------------------------------------------------------------------
# colormaps
# ---------------------------------------------------------------------------

CN_COLOR_REFERENCE = {
    0: "#3182BD", 1: "#9ECAE1", 2: "#CCCCCC", 3: "#FDCC8A", 4: "#FC8D59",
    5: "#E34A33", 6: "#B30000", 7: "#980043", 8: "#DD1C77", 9: "#DF65B0",
    10: "#C994C7", 11: "#D4B9DA",
}


def get_cn_cmap(cn_data) -> ListedColormap:
    """Discrete CN-state colormap covering [min, max] of ``cn_data``
    (reference: plot_utils.py:295-306)."""
    cn_data = np.asarray(cn_data)
    min_cn, max_cn = int(cn_data.min()), int(cn_data.max())
    top = max(CN_COLOR_REFERENCE.keys())
    return ListedColormap([
        CN_COLOR_REFERENCE[min(cn, top)] for cn in range(min_cn, max_cn + 1)
    ])


def get_phase_cmap() -> dict:
    """Cell-cycle-phase colors (reference: plot_utils.py:309-321)."""
    return {
        "S": "goldenrod", 1: "goldenrod",
        "G1/2": "dodgerblue", "G1": "dodgerblue", 0: "dodgerblue",
        "G2": "lightblue", "LQ": "lightgrey", "G2M": "yellowgreen",
    }


def get_rt_cmap(return_colors=False):
    """Binary replication-state colormap (reference: plot_utils.py:340-347)."""
    rt_colors = {0: "#552583", 1: "#FDB927"}
    cmap = ListedColormap([rt_colors[0], rt_colors[1]])
    return (cmap, rt_colors) if return_colors else cmap


def get_acc_cmap(return_colors=False):
    """Replication-accuracy colors: FP green, FN purple, correct grey
    (reference: plot_utils.py:350-358)."""
    acc_colors = {0: "#CCCCCC", -1: "#532A44", 1: "#00685E"}
    cmap = ListedColormap([acc_colors[-1], acc_colors[0], acc_colors[1]])
    return (cmap, acc_colors) if return_colors else cmap


_CLONE_COLOR_CYCLE = [
    "cadetblue", "chocolate", "olivedrab", "tan", "plum", "indianred",
    "lightpink", "slategrey", "darkseagreen", "darkkhaki", "lightsteelblue",
    "darksalmon", "lightgreen", "thistle", "lightgrey", "lightblue",
    "coral", "lightcyan", "lightgoldenrodyellow", "mediumseagreen",
    "indigo",
]


def get_clone_cmap() -> dict:
    """Clone-letter/number -> color map (reference: plot_utils.py:385-430)."""
    cmap = {}
    for i, color in enumerate(_CLONE_COLOR_CYCLE):
        cmap[chr(ord("A") + i)] = color
        cmap[i + 1] = color
    return cmap


def get_cna_cmap() -> dict:
    return {"gain": "red", "loss": "deepskyblue", "neutral": "#CCCCCC",
            "unaltered": "#CCCCCC"}


# ---------------------------------------------------------------------------
# genome-axis profile scatter
# ---------------------------------------------------------------------------

def plot_cell_cn_profile(ax, cn_data, value_field_name, cn_field_name=None,
                         max_cn=13, chromosome=None, s=5, squashy=False,
                         color=None, alpha=1, rawy=False, lines=False,
                         label=None, rasterized=True, cmap=None,
                         chrom_labels_to_remove=()):
    """Scatter a per-bin value along a concatenated genome axis.

    Mirrors ``plot_cell_cn_profile2`` (reference: plot_utils.py:15-163)
    with the inlined hg19 coordinates.
    """
    info = refgenome.info
    cn_data = cn_data.copy()
    cn_data["chr"] = cn_data["chr"].astype(str)
    plot_data = cn_data.merge(
        info.chromosome_info[["chr", "chromosome_start", "chromosome_end"]])
    plot_data = plot_data[plot_data["chr"].isin(info.chromosomes)]
    plot_data["gstart"] = plot_data["start"] + plot_data["chromosome_start"]

    squash_f = lambda a: np.tanh(0.15 * a)
    if squashy:
        plot_data[value_field_name] = squash_f(plot_data[value_field_name])

    if lines:
        order = pd.Categorical(plot_data["chr"],
                               categories=info.chromosomes, ordered=True)
        plot_data = plot_data.assign(_c=order).sort_values(["_c", "gstart"])
        ax.plot(plot_data["gstart"], plot_data[value_field_name], alpha=0.3,
                c=color or "k", label="", rasterized=rasterized)

    label = value_field_name if label is None else label
    if cn_field_name is not None:
        use_cmap = cmap or get_cn_cmap(
            plot_data[cn_field_name].astype(int).values)
        ax.scatter(plot_data["gstart"], plot_data[value_field_name],
                   c=plot_data[cn_field_name], s=s, alpha=alpha, label=label,
                   cmap=use_cmap, rasterized=rasterized)
    else:
        ax.scatter(plot_data["gstart"], plot_data[value_field_name],
                   c=color, s=s, alpha=alpha, label=label,
                   rasterized=rasterized)

    if chromosome is not None:
        ci = info.chromosome_info.set_index("chr").loc[chromosome]
        xticks = np.arange(0, ci["chromosome_length"], 2e7)
        ax.set_xlabel(f"chromosome {chromosome}")
        ax.set_xticks(xticks + ci["chromosome_start"])
        ax.set_xticklabels([f"{int(x / 1e6):d}M" for x in xticks])
        ax.set_xlim((ci["chromosome_start"], ci["chromosome_end"]))
    else:
        ax.set_xlim((-0.5, info.chromosome_end.max()))
        ax.set_xlabel("chromosome")
        ax.set_xticks([0] + list(info.chromosome_end.values))
        ax.set_xticklabels([])
        ax.xaxis.set_minor_locator(
            matplotlib.ticker.FixedLocator(info.chromosome_mid))
        labels = ["" if c in chrom_labels_to_remove else c
                  for c in info.chromosomes]
        ax.xaxis.set_minor_formatter(matplotlib.ticker.FixedFormatter(labels))

    if squashy and not rawy:
        yticks = np.array([0, 2, 4, 7, 20])
        ax.set_yticks(squash_f(yticks))
        ax.set_yticklabels([str(a) for a in yticks])
        ax.set_ylim((-0.01, 1.01))
    elif not rawy:
        ax.set_ylim((-0.05 * max_cn, max_cn))
        ax.set_yticks(range(0, int(max_cn) + 1))
    return plot_data


# ---------------------------------------------------------------------------
# clustered cell x bin heatmap
# ---------------------------------------------------------------------------

def _secondary_clustering(data: np.ndarray) -> np.ndarray:
    """Within-cluster cell ordering by complete-linkage hierarchy on the
    cityblock distance (reference: plot_utils.py:230-237)."""
    if data.shape[1] <= 2:
        return np.arange(data.shape[1])
    D = dst.squareform(dst.pdist(data.T, "cityblock"))
    Y = sch.linkage(D, method="complete")
    idx = np.array(sch.dendrogram(Y, color_threshold=-1,
                                  no_plot=True)["leaves"])
    ordering = np.zeros(idx.shape[0], dtype=int)
    ordering[idx] = np.arange(idx.shape[0])
    return ordering


def plot_clustered_cell_cn_matrix(ax, cn_data, cn_field_name,
                                  cluster_field_name="cluster_id",
                                  secondary_field_name=None, raw=False,
                                  max_cn=13, cmap=None, chromosome=None,
                                  chrom_boundary_width=1,
                                  chrom_labels_to_remove=(), vmin=None,
                                  vmax=None):
    """Heatmap of cells (rows, grouped by cluster) x bins (columns).

    Mirrors ``plot_clustered_cell_cn_matrix``
    (reference: plot_utils.py:166-228): cells group by
    ``cluster_field_name`` and order within cluster either by the
    per-cell ``secondary_field_name`` value or by hierarchical
    clustering.
    """
    info = refgenome.info
    cn_data = cn_data.copy()
    cn_data["chr"] = cn_data["chr"].astype(str)
    if chromosome is not None:
        cn_data = cn_data[cn_data["chr"] == str(chromosome)]
    plot_data = cn_data.merge(info.chrom_idxs)

    # refuse duplicate (cell, bin) rows loudly: pivot_table's default mean
    # aggregation would silently blend CN states into fractional values
    dup = plot_data.duplicated(["cell_id", "chr_index", "start"])
    if dup.any():
        raise ValueError(
            f"{int(dup.sum())} duplicate (cell_id, chr, start) rows in "
            "heatmap input — deduplicate before plotting")

    mat = plot_data.pivot_table(
        index=["chr_index", "start"],
        columns=["cell_id", cluster_field_name],
        values=cn_field_name, observed=True).fillna(0)

    if secondary_field_name is not None:
        per_cell = plot_data[["cell_id", secondary_field_name]] \
            .drop_duplicates("cell_id").set_index("cell_id")
        ordering = per_cell[secondary_field_name] \
            .reindex(mat.columns.get_level_values(0)).to_numpy()
    else:
        ordering = _secondary_clustering(mat.values)

    ordering = pd.Series(ordering, index=mat.columns, name="cell_order")
    mat = mat.T.set_index(ordering, append=True).T
    mat = mat.sort_index(axis=1, level=[1, 2])

    if max_cn is not None:
        mat = mat.clip(upper=max_cn)

    chrom_idxs = mat.index.get_level_values(0).values
    boundaries = np.array(
        [0] + list(np.where(chrom_idxs[1:] != chrom_idxs[:-1])[0])
        + [mat.shape[0] - 1])
    mids = boundaries[:-1] + (boundaries[1:] - boundaries[:-1]) / 2
    present = chrom_idxs[np.concatenate([[True],
                                         np.diff(chrom_idxs) != 0])]
    names = np.array(info.chromosomes)[present]
    names = ["" if x in chrom_labels_to_remove else x for x in names]

    if not raw and cmap is None:
        cmap = get_cn_cmap(mat.values)

    ax.imshow(mat.astype(float).T, aspect="auto", cmap=cmap,
              interpolation="none", vmin=vmin, vmax=vmax)
    if chromosome is not None:
        ax.set_xlabel(f"chr{chromosome}")
        ax.set_xticks([])
        ax.set_yticks([])
    else:
        ax.set(xticks=mids, xticklabels=names)
        for val in boundaries[:-1]:
            ax.axvline(x=val, linewidth=chrom_boundary_width, color="black",
                       zorder=100)
    return mat


# ---------------------------------------------------------------------------
# colorbars / legends
# ---------------------------------------------------------------------------

def plot_colorbar(ax, color_mat, title=None):
    """Vertical color strip (reference: plot_utils.py:241-248)."""
    ax.imshow(np.array(color_mat)[::-1, np.newaxis], aspect="auto",
              origin="lower")
    ax.grid(False)
    ax.set_xticks([])
    ax.set_yticks([])
    if title is not None:
        ax.set_title(title)


def plot_color_legend(ax, color_map, title=None):
    handles = [Patch(facecolor=c, label=n) for n, c in color_map.items()]
    ax.legend(handles=handles, loc="center left", title=title)
    ax.grid(False)
    ax.axis("off")


def make_color_mat_float(values, palette_color):
    """Map 0-1 floats through a matplotlib palette
    (reference: plot_utils.py:261-271)."""
    pal = plt.get_cmap(palette_color)
    color_mat = [pal(v) for v in values]
    return color_mat, {0: pal(0.0), 1: pal(1.0)}


def get_cluster_colors(cluster_ids, color_map=None):
    """Per-cell color strip for a cluster-id vector (replaces the
    reference's external ``scgenome.cncluster.get_cluster_colors``,
    plot_pert_output.py:183)."""
    if color_map is None:
        color_map = get_clone_cmap()
    uniq = sorted(pd.unique(cluster_ids), key=str)
    resolved = {}
    for i, cid in enumerate(uniq):
        c = color_map.get(cid, _CLONE_COLOR_CYCLE[i % len(_CLONE_COLOR_CYCLE)])
        resolved[cid] = matplotlib.colors.to_rgba(c)
    return [resolved[c] for c in cluster_ids], resolved


# ---------------------------------------------------------------------------
# cohort / experiment label registries
# (reference: plot_utils.py:324-561 — study-specific color registries the
# downstream analysis notebooks key on; regenerated here with equivalent
# label coverage)
# ---------------------------------------------------------------------------

def _dual_keyed(pairs):
    """Registry mapping both string labels and their integer aliases."""
    cmap = {}
    for i, (label, color) in enumerate(pairs):
        cmap[label] = color
        cmap[i if not isinstance(label, int) else label] = color
    return cmap


def get_signals_cmap(return_colors=False):
    """Allele-specific CN states (A-Hom ... B-Hom), also keyed -2..2
    (reference: plot_utils.py:324-338)."""
    colors = {
        "A-Hom": "#56941E", -2: "#56941E",
        "A-Gained": "#94C773", -1: "#94C773",
        "Balanced": "#d5d5d4", 0: "#d5d5d4",
        "B-Gained": "#7B52AE", 1: "#7B52AE",
        "B-Hom": "#471871", 2: "#471871",
    }
    cmap = ListedColormap([colors[k] for k in ("A-Hom", "A-Gained",
                                               "Balanced", "B-Gained",
                                               "B-Hom")])
    return (cmap, colors) if return_colors else cmap


def get_methods_cmap() -> dict:
    """Colors for method-comparison figures
    (reference: plot_utils.py:361-371)."""
    return {
        "PERT": "yellowgreen", "PERT comp.": "yellowgreen",
        "PERT clone": "olive", "Kronos": "lightcoral",
        "laks": "darksalmon", "Laks": "darksalmon", "true": "steelblue",
    }


def get_htert_cmap() -> dict:
    """hTERT cell-line genotypes / sample ids
    (reference: plot_utils.py:433-452)."""
    pairs = [
        ("WT", "C0"), ("SA039", "C0"),
        ("TP53-/-", "C1"), ("SA906a", "C1"), ("SA906b", "orange"),
        ("TP53-/-,BRCA1+/-", "C2"), ("SA1292", "C2"),
        ("TP53-/-,BRCA1-/-", "C3"), ("SA1056", "C3"),
        ("TP53-/-,BRCA2+/-", "C4"), ("SA1188", "C4"),
        ("TP53-/-,BRCA2-/-", "C5"), ("SA1054", "C5"),
        ("SA1055", "chocolate"), ("OV2295", "lightgreen"),
    ]
    return dict(pairs)


def get_facs_cmap() -> dict:
    """FACS-isolated cell lines (reference: plot_utils.py:454-460)."""
    return {
        "GM18507": "mediumpurple", "SA928": "mediumpurple",
        1: "mediumpurple",
        "T47D": "khaki", "SA1044": "khaki", 2: "khaki",
    }


def get_metacohort_feature_cmap() -> dict:
    """RT-predictor feature colors (reference: plot_utils.py:463-467)."""
    import seaborn as sns

    pal = sns.color_palette("cubehelix", 4)
    return {"global": pal[0], "ploidy": pal[1], "type": pal[2],
            "signature": pal[3]}


def get_metacohort_cmaps(return_cdicts=False):
    """(cell_type, signature, condition, ploidy) cmaps for metacohort
    heatmap annotation tracks (reference: plot_utils.py:470-529)."""
    from matplotlib.colors import LinearSegmentedColormap

    cell_type = _dual_keyed([
        ("hTERT", "lightsteelblue"), ("HGSOC", "teal"), ("TNBC", "salmon"),
        ("OV2295", "lightgreen"), ("T47D", "khaki"),
        ("GM18507", "mediumpurple"),
    ])
    signature = _dual_keyed([
        ("FBI", "plum"), ("HRD", "cyan"), ("TD", "coral"), ("NA", "white"),
    ])
    # NaN cannot be a reliable dict key (id-based hash); callers should
    # pd.isna() missing labels to "NA"/None before lookup
    signature[None] = "white"
    signature["N/A"] = "white"
    condition = _dual_keyed([("Line", "tan"), ("PDX", "lightskyblue")])
    ploidy = {2: "#CCCCCC", 3: "#FDCC8A", 4: "#FC8D59", 5: "#E34A33"}

    def _cmap(name, cdict):
        # one entry per category: string labels only (the integer aliases
        # duplicate the same colors), first-seen order preserved
        vals = list(dict.fromkeys(
            v for k, v in cdict.items() if isinstance(k, str)))
        if not vals:
            vals = list(dict.fromkeys(cdict.values()))
        return LinearSegmentedColormap.from_list(name, vals, N=len(vals))

    cmaps = (_cmap("cell_type", cell_type), _cmap("signature", signature),
             _cmap("condition", condition), _cmap("ploidy", ploidy))
    if return_cdicts:
        return cmaps, (cell_type, signature, condition, ploidy)
    return cmaps


def format_embedding_frame(ax, xlabel="PC1", ylabel="PC2"):
    """Minimal-axes styling for PCA/UMAP embeddings: no ticks, short
    bottom-left spines with axis labels (reference: plot_utils.py:274-292)."""
    ax.set_xticks([])
    ax.set_yticks([])
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    xlim, ylim = ax.get_xlim(), ax.get_ylim()
    ax.spines["bottom"].set_bounds(xlim[0], xlim[0] + 0.25 * (xlim[1] - xlim[0]))
    ax.spines["left"].set_bounds(ylim[0], ylim[0] + 0.25 * (ylim[1] - ylim[0]))
    ax.set_xlabel(xlabel, loc="left")
    ax.set_ylabel(ylabel, loc="bottom")
    return ax


# API-parity alias: the reference names its genome-axis scatter
# ``plot_cell_cn_profile2`` (reference: plot_utils.py:15-163)
plot_cell_cn_profile2 = plot_cell_cn_profile
