"""Clone discovery: k-means over cell profiles with BIC model selection
(port of ``pipeline/clustering.py``; reference: cncluster.py:10-120).

:func:`kmeans_cluster` fits k-means for k in [min_k, max_k] and keeps
the k with the largest BIC.  The k-means runs as PyTorch on the device,
in float64, with sklearn's algorithm: k-means++ seeding with 2 + ln k
local trials per center, Lloyd iterations to sklearn's tolerance
(1e-4 of the mean per-feature variance) or 300 iterations, and the
lowest inertia of 10 starts, the starts advancing together as one
batch.  The draws come from an explicit generator seeded from ``seed``
(the JAX package's sklearn KMeans is unseeded).

The umap+hdbscan path (``spectral_embed``, ``umap_hdbscan_cluster``)
is host code and a copy of the JAX package's; sklearn is imported
inside the functions that use it, so the module imports without it.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import pandas as pd
import torch

from scdna_replication_tools_tpu_torch.device import resolve_device

KMEANS_TOL = 1e-4
KMEANS_MAX_ITER = 300
KMEANS_N_INIT = 10


@dataclasses.dataclass
class KMeansFit:
    """One k-means clustering: (n,) labels, (k, d) centers, inertia."""

    labels: torch.Tensor
    centers: torch.Tensor
    inertia: float


def _sq_dists(X: torch.Tensor, C: torch.Tensor, x_sq: torch.Tensor
              ) -> torch.Tensor:
    """Squared distances (I, n, k) of the n rows of X to each batch's
    k centers C (I, k, d)."""
    c_sq = torch.sum(C * C, dim=-1)                           # (I, k)
    d2 = x_sq[None, :, None] \
        - 2.0 * torch.matmul(X[None], C.transpose(1, 2)) \
        + c_sq[:, None, :]
    return torch.clamp(d2, min=0.0)


def _kmeans_plusplus(X: torch.Tensor, x_sq: torch.Tensor, k: int,
                     n_init: int, gen: torch.Generator) -> torch.Tensor:
    """(n_init, k, d) k-means++ seeds: the first center uniform, each
    next one the best of 2 + ln k candidates drawn with probability
    proportional to the squared distance to the nearest center so far
    (sklearn ``_kmeans_plusplus``)."""
    n, d = X.shape
    dev = X.device
    trials = 2 + int(np.log(k))
    centers = torch.empty((n_init, k, d), dtype=X.dtype, device=dev)
    first = torch.randint(0, n, (n_init,), generator=gen, device=dev)
    centers[:, 0] = X[first]
    closest = _sq_dists(X, centers[:, :1], x_sq)[..., 0]      # (I, n)
    pot = closest.sum(dim=1)
    rows = torch.arange(n_init, device=dev)
    for c in range(1, k):
        rand = torch.rand((n_init, trials), generator=gen, dtype=X.dtype,
                          device=dev) * pot[:, None]
        cand = torch.searchsorted(torch.cumsum(closest, dim=1), rand)
        cand = torch.clamp(cand, max=n - 1)                   # (I, trials)
        d_cand = _sq_dists(X, X[cand], x_sq)                  # (I, n, trials)
        d_cand = torch.minimum(closest[:, :, None], d_cand)
        cand_pot = d_cand.sum(dim=1)                          # (I, trials)
        best = torch.argmin(cand_pot, dim=1)
        centers[:, c] = X[cand[rows, best]]
        closest = d_cand[rows, :, best]
        pot = cand_pot[rows, best]
    return centers


def _centers_of(X: torch.Tensor, labels: torch.Tensor, k: int,
                d2_min: torch.Tensor) -> torch.Tensor:
    """(I, k, d) cluster means of each batch's labels; an empty cluster
    takes the point farthest from its own center, which leaves its old
    cluster (sklearn ``_relocate_empty_clusters_dense``)."""
    n_init, n = labels.shape
    onehot = torch.zeros((n_init, n, k), dtype=X.dtype, device=X.device)
    onehot.scatter_(2, labels[..., None], 1.0)
    sums = torch.matmul(onehot.transpose(1, 2), X[None])      # (I, k, d)
    counts = onehot.sum(dim=1)                                # (I, k)
    empty = counts == 0
    if bool(empty.any()):
        for i in torch.nonzero(empty.any(dim=1))[:, 0].tolist():
            gone = torch.nonzero(empty[i])[:, 0].tolist()
            far = torch.argsort(d2_min[i], descending=True)[:len(gone)]
            for c, p in zip(gone, far.tolist()):
                old = int(labels[i, p])
                sums[i, old] -= X[p]
                counts[i, old] -= 1
                sums[i, c] = X[p]
                counts[i, c] = 1
    return sums / counts[..., None]


def _lloyd(X: torch.Tensor, x_sq: torch.Tensor, centers: torch.Tensor,
           tol: float, max_iter: int):
    """Lloyd iterations of every batch until its labels stop changing or
    its centers move less than ``tol`` (summed squared shift); then, as
    sklearn does after a tolerance stop, labels from the final centers.
    Returns (labels (I, n), centers, inertia (I,))."""
    n_init, k, _ = centers.shape
    n = X.shape[0]
    labels_old = torch.full((n_init, n), -1, dtype=torch.int64,
                            device=X.device)
    active = torch.ones(n_init, dtype=torch.bool, device=X.device)
    for _ in range(max_iter):
        d2 = _sq_dists(X, centers, x_sq)
        labels = torch.argmin(d2, dim=2)
        d2_min = torch.gather(d2, 2, labels[..., None])[..., 0]
        new = _centers_of(X, labels, k, d2_min)
        shift = torch.sum((new - centers) ** 2, dim=(1, 2))
        same = torch.all(labels == labels_old, dim=1)
        centers = torch.where(active[:, None, None], new, centers)
        active &= ~(same | (shift <= tol))
        labels_old = torch.where(active[:, None], labels, labels_old)
        if not bool(active.any()):
            break
    d2 = _sq_dists(X, centers, x_sq)
    labels = torch.argmin(d2, dim=2)
    inertia = torch.gather(d2, 2, labels[..., None])[..., 0].sum(dim=1)
    return labels, centers, inertia


def kmeans_fit(X: torch.Tensor, k: int, gen: torch.Generator,
               n_init: int = KMEANS_N_INIT, max_iter: int = KMEANS_MAX_ITER,
               tol: float = KMEANS_TOL) -> KMeansFit:
    """k-means of the rows of float64 ``X`` on its device: ``n_init``
    k-means++ starts run as one batch and the lowest inertia is kept."""
    x_mean = X.mean(dim=0)
    Xc = X - x_mean
    tol_abs = float(torch.mean(torch.var(X, dim=0, correction=0))) * tol
    x_sq = torch.sum(Xc * Xc, dim=1)
    seeds = _kmeans_plusplus(Xc, x_sq, k, n_init, gen)
    labels, centers, inertia = _lloyd(Xc, x_sq, seeds, tol_abs, max_iter)
    best = int(torch.argmin(inertia))
    return KMeansFit(labels=labels[best], centers=centers[best] + x_mean,
                     inertia=float(inertia[best]))


def compute_bic(X, labels, centers) -> float:
    """BIC of a k-means clustering (reference: cncluster.py:49-77), in
    float64 on ``X``'s device."""
    X = X.to(torch.float64) if torch.is_tensor(X) \
        else torch.as_tensor(np.array(X, np.float64))
    labels = torch.as_tensor(labels, dtype=torch.int64, device=X.device)
    centers = torch.as_tensor(centers, dtype=torch.float64, device=X.device)
    n_clusters = centers.shape[0]
    N, d = X.shape
    sizes = torch.bincount(labels, minlength=n_clusters).to(torch.float64)
    sq = torch.sum((X - centers[labels]) ** 2)
    cl_var = (1.0 / (N - n_clusters) / d) * sq
    const_term = 0.5 * n_clusters * math.log(N) * (d + 1)
    sizes = sizes[sizes > 0]
    bic = torch.sum(sizes * torch.log(sizes) - sizes * math.log(N)
                    - (sizes * d / 2) * torch.log(2 * math.pi * cl_var)
                    - (sizes - 1) * d / 2) - const_term
    return float(bic)


def kmeans_cluster(cn: pd.DataFrame, min_k: int = 2, max_k: int = 100,
                   device=None, seed: int = 0) -> pd.DataFrame:
    """Cluster the cells of a (loci x cells) matrix frame; returns a
    (cell_id, cluster_id) frame (reference: cncluster.py:80-120).  Runs
    on ``device`` (None = the GPU) from a generator seeded with
    ``seed``."""
    dev = resolve_device(device)
    X = torch.as_tensor(np.array(cn.fillna(0).T.values, np.float64),
                        device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    max_k = min(max_k, X.shape[0] - 1)
    ks = range(min_k, max_k + 1)
    fits, bics = [], []
    for k in ks:
        fit = kmeans_fit(X, k, gen)
        fits.append(fit)
        bics.append(compute_bic(X, fit.labels, fit.centers))
        logging.debug("kmeans k=%d bic=%.2f", k, bics[-1])
    opt = int(np.argmax(bics))
    logging.info("kmeans_cluster selected k=%d", list(ks)[opt])
    return pd.DataFrame({
        "cell_id": cn.columns,
        "cluster_id": fits[opt].labels.cpu().numpy(),
    })


def cluster_g1_cells(g1_mat: pd.DataFrame, method: str = "kmeans",
                     cell_col: str = "cell_id", device=None,
                     **kwargs) -> pd.DataFrame:
    """Clone discovery over a (loci x cells) matrix frame, by method;
    returns a ``(cell_col, cluster_id)`` frame.  ``umap_hdbscan`` noise
    cells (label -1) are dropped with a warning."""
    if method == "kmeans":
        clusters = kmeans_cluster(g1_mat, **{"max_k": 20, **kwargs},
                                  device=device)
    elif method == "umap_hdbscan":
        clusters = umap_hdbscan_cluster(g1_mat, **kwargs)
        noise = clusters["cluster_id"] < 0
        if noise.any():
            logging.warning("umap_hdbscan: dropping %d/%d G1 cells "
                            "labelled noise", int(noise.sum()),
                            len(clusters))
            clusters = clusters[~noise]
        if clusters.empty:
            raise ValueError(
                "umap_hdbscan labelled every G1 cell as noise; lower "
                "min_cluster_size (clustering_kwargs) or use "
                "clustering_method='kmeans'")
    else:
        raise ValueError(f"clustering method must be 'kmeans' or "
                         f"'umap_hdbscan', got {method!r}")
    return (clusters.rename(columns={"cell_id": cell_col})
            [[cell_col, "cluster_id"]])


def discover_clones(cn_g1: pd.DataFrame, value_col: str,
                    cell_col: str = "cell_id", chr_col: str = "chr",
                    start_col: str = "start", method: str = "kmeans",
                    device=None, **kwargs):
    """Pivot the long-form G1 frame to (loci x cells), cluster it and
    merge the labels back; returns ``(cn_g1_with_cluster_id,
    'cluster_id')`` (reference: infer_scRT.py:129-148)."""
    g1_mat = cn_g1.pivot_table(columns=cell_col,
                               index=[chr_col, start_col],
                               values=value_col, observed=True)
    clusters = cluster_g1_cells(g1_mat, method, cell_col=cell_col,
                                device=device, **kwargs)
    if "cluster_id" in cn_g1.columns:
        logging.warning("discover_clones: input frame already has a "
                        "cluster_id column; overwriting it with the fresh "
                        "clustering")
        cn_g1 = cn_g1.drop(columns=["cluster_id"])
    return pd.merge(cn_g1, clusters, on=cell_col), "cluster_id"


def spectral_embed(X: np.ndarray, n_components: int = 2,
                   n_neighbors: int = 15, dense_cutoff: int = 2048
                   ) -> np.ndarray:
    """Deterministic kNN-graph spectral embedding (Laplacian
    eigenmaps), the stand-in for UMAP in ``umap_hdbscan_cluster``; host
    code, a copy of the JAX package's."""
    import scipy.sparse
    import scipy.sparse.linalg
    import sklearn.neighbors

    Xd = np.asarray(X, np.float32)
    n = Xd.shape[0]
    k = int(min(n_neighbors, n - 1))
    dist, idx = (sklearn.neighbors.NearestNeighbors(n_neighbors=k + 1)
                 .fit(Xd).kneighbors(Xd))
    d2k = (dist[:, 1:] ** 2).astype(np.float64)
    knn_idx = idx[:, 1:]
    rows = np.repeat(np.arange(n), k)
    cols = knn_idx.ravel()
    sigma2 = np.maximum(d2k[:, -1], 1e-12)
    vals = np.exp(-d2k.ravel() / np.sqrt(sigma2[rows] * sigma2[cols]))
    w = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))
    w = w.maximum(w.T)

    deg = np.maximum(np.asarray(w.sum(axis=1)).ravel(), 1e-12)
    d_inv_sqrt = 1.0 / np.sqrt(deg)
    dm = scipy.sparse.diags(d_inv_sqrt)
    lap = scipy.sparse.identity(n, format="csr") - dm @ w @ dm
    if n <= dense_cutoff:
        _, vecs = np.linalg.eigh(lap.toarray())
    else:
        try:
            # a small negative shift: the normalized Laplacian is
            # exactly singular
            vals_, vecs = scipy.sparse.linalg.eigsh(
                lap, k=n_components + 1, sigma=-1e-6, which="LM")
            vecs = vecs[:, np.argsort(vals_)]
        except Exception:  # noqa: BLE001 — the dense path is a correct
            # (cubic) fallback for SuperLU and ARPACK failures alike
            logging.warning("spectral_embed: sparse eigsh failed at "
                            "n=%d; falling back to dense eigh", n,
                            exc_info=True)
            _, vecs = np.linalg.eigh(lap.toarray())
    emb = vecs[:, 1:1 + n_components] * d_inv_sqrt[:, None]
    signs = np.sign(emb[np.argmax(np.abs(emb), axis=0),
                        np.arange(emb.shape[1])])
    return (emb * np.where(signs == 0, 1.0, signs)).astype(np.float32)


def umap_hdbscan_cluster(cn: pd.DataFrame, n_components: int = 2,
                         n_neighbors: int = 15, min_dist: float = 0.1,
                         min_samples: int = 10, min_cluster_size: int = 30
                         ) -> pd.DataFrame:
    """Spectral embedding of the cells of a (loci x cells) frame and
    sklearn's HDBSCAN of it (reference: cncluster.py:10-46); returns
    ``cell_id, cluster_id, umap1..umap<n>`` (noise cells -1)."""
    import sklearn.cluster

    del min_dist
    X = cn.fillna(0).T.values
    emb = spectral_embed(X, n_components=n_components,
                         n_neighbors=n_neighbors)
    clusters = sklearn.cluster.HDBSCAN(
        min_samples=min_samples, min_cluster_size=min_cluster_size,
        copy=True).fit_predict(emb)
    out = pd.DataFrame({"cell_id": cn.columns, "cluster_id": clusters})
    for j in range(emb.shape[1]):
        out[f"umap{j + 1}"] = emb[:, j]
    return out
