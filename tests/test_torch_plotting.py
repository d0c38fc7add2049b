"""The port's figures (``plotting/``, ``pipeline/twidth``'s two plot
functions) against the JAX package's, on the Agg backend.

JAX's four plotting tests (tests/test_plotting.py) run against the port;
every colormap getter returns what JAX's returns (equal dicts, equal
colors); the clustered heatmap returns JAX's matrix and cell order
exactly, by cluster or by a per-cell secondary value; the panel
functions lay out JAX's axes; and, in a fresh interpreter, importing the
port, its ``api`` and ``cli`` (and the analysis modules) leaves
matplotlib unloaded, since the card's machine may not have it.
"""

import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from scdna_replication_tools_tpu import plotting as jplot  # noqa: E402
from scdna_replication_tools_tpu.pipeline import twidth as jtw  # noqa: E402
from scdna_replication_tools_tpu.plotting import refgenome as jref  # noqa: E402
from scdna_replication_tools_tpu.plotting import utils as jutils  # noqa: E402
from scdna_replication_tools_tpu_torch.pipeline import twidth as ttw  # noqa: E402
from scdna_replication_tools_tpu_torch.plotting import (  # noqa: E402
    get_clone_cmap,
    get_cn_cmap,
    get_rt_cmap,
    plot_cell_cn_profile,
    plot_clustered_cell_cn_matrix,
    plot_model_results,
)
from scdna_replication_tools_tpu_torch.plotting import pert_output as tout  # noqa: E402
from scdna_replication_tools_tpu_torch.plotting import refgenome as tref  # noqa: E402
from scdna_replication_tools_tpu_torch.plotting import utils as tutils  # noqa: E402


@pytest.fixture(scope="module")
def plot_frame():
    """JAX's tests/test_plotting.py frame: two clones of six cells over
    two chromosomes."""
    rng = np.random.default_rng(0)
    rows = []
    for clone, cells in [("A", 6), ("B", 6)]:
        for i in range(cells):
            for chrom, n in [("1", 40), ("2", 30)]:
                starts = np.arange(n) * 500_000
                rows.append(pd.DataFrame({
                    "cell_id": f"{clone}{i}",
                    "chr": chrom,
                    "start": starts,
                    "end": starts + 500_000,
                    "clone_id": clone,
                    "state": 2 + (clone == "B") * (np.arange(n) < 10),
                    "model_cn_state": 2,
                    "model_rep_state": rng.integers(0, 2, n),
                    "model_tau": (i + 1) / (cells + 1),
                    "rpm": rng.poisson(50, n).astype(float),
                }))
    return pd.concat(rows, ignore_index=True)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


# ---------------------------------------------------------------------------
# JAX's four tests, on the port
# ---------------------------------------------------------------------------


def test_cmaps():
    assert get_cn_cmap(np.array([0, 5])).N == 6
    assert get_rt_cmap().N == 2
    assert "A" in get_clone_cmap()


def test_genome_profile_axis(plot_frame):
    fig, ax = plt.subplots()
    one_cell = plot_frame[plot_frame.cell_id == "A0"]
    plot_cell_cn_profile(ax, one_cell, "rpm", cn_field_name="state",
                         rawy=True)
    assert ax.get_xlabel() == "chromosome"


def test_clustered_matrix_shapes(plot_frame):
    fig, ax = plt.subplots()
    mat = plot_clustered_cell_cn_matrix(ax, plot_frame, "state",
                                        cluster_field_name="clone_id")
    assert mat.shape == (70, 12)  # 70 loci x 12 cells


def test_plot_model_results_renders(plot_frame):
    fig = plot_model_results(plot_frame, plot_frame)
    assert len(fig.axes) >= 8


# ---------------------------------------------------------------------------
# equal to JAX's
# ---------------------------------------------------------------------------


def _same_cmap(a, b):
    assert type(a) is type(b) and a.N == b.N and a.name == b.name
    x = np.linspace(0.0, 1.0, 37)
    np.testing.assert_array_equal(a(x), b(x))


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, matplotlib.colors.Colormap):
        _same_cmap(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name,args", [
    ("get_cn_cmap", (np.array([0, 3, 5]),)),
    ("get_cn_cmap", (np.array([1, 14]),)),
    ("get_phase_cmap", ()),
    ("get_rt_cmap", ()), ("get_rt_cmap", (True,)),
    ("get_acc_cmap", ()), ("get_acc_cmap", (True,)),
    ("get_clone_cmap", ()), ("get_cna_cmap", ()),
    ("get_signals_cmap", ()), ("get_signals_cmap", (True,)),
    ("get_methods_cmap", ()), ("get_htert_cmap", ()),
    ("get_facs_cmap", ()), ("get_metacohort_feature_cmap", ()),
    ("get_metacohort_cmaps", ()), ("get_metacohort_cmaps", (True,)),
])
def test_cmap_getters_equal_jax(name, args):
    _same(getattr(tutils, name)(*args), getattr(jutils, name)(*args))


def test_color_helpers_and_genome_info_equal_jax():
    ids = np.array([2, 1, 2, 3, 1])
    assert tutils.get_cluster_colors(ids) == jutils.get_cluster_colors(ids)
    vals = [0.0, 0.25, 0.9]
    assert tutils.make_color_mat_float(vals, "Blues") == \
        jutils.make_color_mat_float(vals, "Blues")
    assert tref.HG19_CHROM_LENGTHS == jref.HG19_CHROM_LENGTHS
    pd.testing.assert_frame_equal(tref.info.chromosome_info,
                                  jref.info.chromosome_info)
    pd.testing.assert_frame_equal(tref.info.chrom_idxs, jref.info.chrom_idxs)
    np.testing.assert_array_equal(tref.info.chromosome_mid,
                                  jref.info.chromosome_mid)


@pytest.mark.parametrize("kwargs", [
    {"cluster_field_name": "clone_id"},
    {"cluster_field_name": "clone_id", "secondary_field_name": "model_tau"},
    {"cluster_field_name": "clone_id", "chromosome": "2", "max_cn": 2},
    {"cluster_field_name": "clone_id", "raw": True, "max_cn": None},
], ids=["hierarchy", "secondary", "chromosome", "raw"])
@pytest.mark.parametrize("field", ["state", "rpm", "model_rep_state"])
def test_clustered_matrix_and_order_equal_jax(plot_frame, kwargs, field):
    _, (ax_t, ax_j) = plt.subplots(1, 2)
    got = tutils.plot_clustered_cell_cn_matrix(ax_t, plot_frame, field,
                                               **kwargs)
    want = jutils.plot_clustered_cell_cn_matrix(ax_j, plot_frame, field,
                                                **kwargs)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert list(got.columns) == list(want.columns)   # cells in JAX's order
    assert ax_t.get_xticks().tolist() == ax_j.get_xticks().tolist()
    assert [t.get_text() for t in ax_t.get_xticklabels()] == \
        [t.get_text() for t in ax_j.get_xticklabels()]


def test_duplicate_rows_are_refused_as_in_jax(plot_frame):
    dup = pd.concat([plot_frame, plot_frame.iloc[:1]], ignore_index=True)
    _, ax = plt.subplots()
    with pytest.raises(ValueError, match="duplicate"):
        tutils.plot_clustered_cell_cn_matrix(ax, dup, "state")
    with pytest.raises(ValueError, match="duplicate"):
        jutils.plot_clustered_cell_cn_matrix(ax, dup, "state")


def _layout(fig):
    return [(ax.get_position().bounds, ax.get_title(),
             [t.get_text() for t in ax.get_xticklabels()]) for ax in fig.axes]


@pytest.mark.parametrize("fn", ["plot_model_results", "plot_cn_states",
                                "plot_rpm"])
def test_panels_lay_out_jax_axes(plot_frame, fn):
    s = plot_frame[plot_frame.clone_id == "A"]
    g = plot_frame[plot_frame.clone_id == "B"]
    got, want = getattr(tout, fn)(s, g), getattr(jplot, fn)(s, g)
    assert _layout(got) == _layout(want)
    for a, b in zip(got.axes, want.axes):
        for ia, ib in zip(a.get_images(), b.get_images()):
            np.testing.assert_array_equal(ia.get_array(), ib.get_array())


def test_plot_cell_cn_profile_equals_jax(plot_frame):
    one = plot_frame[plot_frame.cell_id == "B2"]
    figs = []
    for mod in (tutils, jutils):
        fig, ax = plt.subplots()
        mod.plot_cell_cn_profile(ax, one, "rpm", cn_field_name="state",
                                 rawy=True)
        figs.append(ax)
    a, b = figs
    assert a.get_xlim() == b.get_xlim() and a.get_ylim() == b.get_ylim()
    for ca, cb in zip(a.collections, b.collections):
        np.testing.assert_array_equal(ca.get_offsets(), cb.get_offsets())


def test_twidth_plots_equal_jax():
    rng = np.random.default_rng(5)
    x = np.linspace(-8, 8, 40)
    y = 1 / (1 + np.exp(-0.8 * x)) + rng.normal(0, 0.02, 40)
    popt, _ = ttw.fit_sigmoid(x, y)
    width, right, left = ttw.calc_t_width(popt)
    axes = []
    for mod in (ttw, jtw):
        _, ax = plt.subplots()
        axes.append(mod.plot_cell_variability(x, y, popt, left, right,
                                              width, ax=ax))
    a, b = axes
    assert a.get_title() == b.get_title() == "Cell-to-cell variability"
    assert [t.get_text() for t in a.get_legend().get_texts()] == \
        [t.get_text() for t in b.get_legend().get_texts()]
    for la, lb in zip(a.get_lines(), b.get_lines()):
        np.testing.assert_array_equal(la.get_xydata(), lb.get_xydata())

    n_cells, n_loci = 20, 120
    rho = np.linspace(0.9, 0.1, n_loci)
    rows = []
    for i in range(n_cells):
        tau = (i + 1) / (n_cells + 1)
        rep = (rng.random(n_loci)
               < 1 / (1 + np.exp(-8 * (tau - rho)))).astype(float)
        rows.append(pd.DataFrame({
            "cell_id": f"c{i}", "rt_state": rep,
            "time_from_scheduled_rt": 10 * (tau - rho)}))
    cn = pd.concat(rows, ignore_index=True)
    (ax_t, w_t), (ax_j, w_j) = (mod.compute_and_plot_twidth(cn.copy())
                                for mod in (ttw, jtw))
    assert w_t == w_j
    for la, lb in zip(ax_t.get_lines(), ax_j.get_lines()):
        np.testing.assert_array_equal(la.get_xydata(), lb.get_xydata())


def test_the_port_loads_without_matplotlib():
    """A fresh interpreter imports the port, its facade, its command line
    and its analysis modules without loading matplotlib."""
    code = (
        "import sys\n"
        "import scdna_replication_tools_tpu_torch\n"
        "import scdna_replication_tools_tpu_torch.api\n"
        "import scdna_replication_tools_tpu_torch.cli\n"
        "import scdna_replication_tools_tpu_torch.pipeline.phase\n"
        "import scdna_replication_tools_tpu_torch.pipeline.ccc_features\n"
        "import scdna_replication_tools_tpu_torch.pipeline.twidth\n"
        "import scdna_replication_tools_tpu_torch.obs.alerts\n"
        "import scdna_replication_tools_tpu_torch.native\n"
        "import scdna_replication_tools_tpu_torch.data.example_bins\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('matplotlib', 'seaborn')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
