"""Clone discovery in the port (``pipeline/clustering.py``) against the
JAX package's.

The port's k-means is PyTorch and seeded, the JAX package's sklearn
KMeans unseeded, so the two are compared by the k they choose and the
partition (adjusted Rand index 1.0), not by labels; ``compute_bic`` is
held to 1e-9 on the same labels.  The umap_hdbscan path is host code,
the JAX package's copied, so its frames are equal.
"""

import subprocess
import sys
from pathlib import Path

import pandas as pd
import pytest
import sklearn.cluster
from sklearn.metrics import adjusted_rand_score

from scdna_replication_tools_tpu.pipeline import clustering as jcl
from scdna_replication_tools_tpu_torch.pipeline import clustering as tcl

from test_clustering import _blob_frame
from test_torch_model import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed,n_per_blob,n_loci",
                         [(0, 40, 60), (3, 15, 90)])
def test_kmeans_cluster_matches_jax(seed, n_per_blob, n_loci):
    frame, truth = _blob_frame(n_per_blob=n_per_blob, n_loci=n_loci,
                               seed=seed)
    ref = jcl.kmeans_cluster(frame, max_k=8)
    got = tcl.kmeans_cluster(frame, max_k=8, device="cpu")
    assert list(got.columns) == ["cell_id", "cluster_id"]
    assert list(got["cell_id"]) == list(frame.columns)
    assert got["cluster_id"].nunique() == ref["cluster_id"].nunique() == 3
    assert adjusted_rand_score(ref["cluster_id"], got["cluster_id"]) == 1.0
    assert adjusted_rand_score(truth, got["cluster_id"]) == 1.0


@pytest.mark.parametrize("k", [2, 3, 5])
def test_compute_bic_matches_jax_on_the_same_labels(k):
    frame, _ = _blob_frame(seed=1)
    X = frame.fillna(0).T.values
    model = sklearn.cluster.KMeans(n_clusters=k, n_init=3,
                                   random_state=0).fit(X)
    ref = jcl.compute_bic(model, X)
    got = tcl.compute_bic(X, model.labels_, model.cluster_centers_)
    assert abs(got - ref) <= 1e-9 * abs(ref)


def test_kmeans_fit_matches_sklearn_inertia():
    """The port's k-means and sklearn's reach the same optimum on
    separated blobs (inertia to 1e-9, the same partition)."""
    import torch
    frame, _ = _blob_frame(seed=2)
    X = frame.fillna(0).T.values
    gen = torch.Generator()
    gen.manual_seed(0)
    fit = tcl.kmeans_fit(torch.as_tensor(X), 3, gen)
    ref = sklearn.cluster.KMeans(3, n_init=10, random_state=0).fit(X)
    assert abs(fit.inertia - ref.inertia_) <= 1e-9 * ref.inertia_
    assert adjusted_rand_score(ref.labels_, fit.labels.numpy()) == 1.0


def test_kmeans_is_seeded():
    frame, _ = _blob_frame(seed=4, n_per_blob=10)
    a = tcl.kmeans_cluster(frame, max_k=6, device="cpu", seed=3)
    b = tcl.kmeans_cluster(frame, max_k=6, device="cpu", seed=3)
    pd.testing.assert_frame_equal(a, b)


def _long_g1(frame):
    long = frame.reset_index().melt(id_vars="index", var_name="cell_id",
                                    value_name="copy")
    long["chr"] = "1"
    long["start"] = long.pop("index") * 500_000
    return long


@pytest.mark.parametrize("with_old_labels", [False, True])
def test_discover_clones_matches_jax(with_old_labels):
    frame, truth = _blob_frame(seed=5)
    long = _long_g1(frame)
    if with_old_labels:
        long["cluster_id"] = 7
    jout, jcol = jcl.discover_clones(long.copy(), "copy")
    tout, tcol = tcl.discover_clones(long.copy(), "copy", device="cpu")
    assert tcol == jcol == "cluster_id"
    assert list(tout.columns) == list(jout.columns)
    j = jout.drop_duplicates("cell_id").set_index("cell_id")["cluster_id"]
    t = tout.drop_duplicates("cell_id").set_index("cell_id")["cluster_id"]
    assert adjusted_rand_score(j, t.reindex(j.index)) == 1.0


def test_umap_hdbscan_frames_equal_jax():
    frame, _ = _blob_frame(seed=6)
    ref = jcl.umap_hdbscan_cluster(frame, n_neighbors=10)
    got = tcl.umap_hdbscan_cluster(frame, n_neighbors=10)
    pd.testing.assert_frame_equal(got, ref)
    gj = jcl.cluster_g1_cells(frame, "umap_hdbscan", n_neighbors=10)
    gt = tcl.cluster_g1_cells(frame, "umap_hdbscan", n_neighbors=10)
    pd.testing.assert_frame_equal(gt, gj)
    with pytest.raises(ValueError, match="kmeans"):
        tcl.cluster_g1_cells(frame, "dbscan")


def test_the_port_imports_without_sklearn():
    """sklearn is imported inside the functions that use it: the facade
    and the CLI import on a machine without it, and umap_hdbscan then
    raises ImportError."""
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "import scdna_replication_tools_tpu_torch.api\n"
        "import scdna_replication_tools_tpu_torch.cli\n"
        "from scdna_replication_tools_tpu_torch.pipeline import clustering\n"
        "import pandas as pd\n"
        "try:\n"
        "    clustering.umap_hdbscan_cluster(pd.DataFrame({'a': [1.0]}))\n"
        "except ImportError:\n"
        "    print('import-error')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "import-error"
