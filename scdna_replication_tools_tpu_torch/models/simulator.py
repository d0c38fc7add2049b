"""Generative PERT simulator: prior-predictive sampling in PyTorch (port
of ``models/simulator.py``; reference: pert_simulator.py:38-418).

All cells of a clone are drawn at once on the device, from an explicit
``torch.Generator`` seeded from ``seed``; the NegativeBinomial is drawn
as its Gamma-Poisson mixture.  The draws are the port's own, not JAX's:
``simulate_s_reads`` and ``simulate_g_reads`` take the tau, GC-beta
noise and replication draws as optional arguments (``tau=``,
``beta_noise=``, ``rep=``), so a caller can hand in another package's
draws and hold the deterministic parts (phi, theta, delta) to it.

The simulator's semantics follow the reference: tau ~ Beta(1, 1); u is
set to ``u_guess`` for every cell; per-cell GC betas are drawn around
the given coefficients with logspace(1 -> 10^-K) stds; phi is not
clamped; raw reads are normalised per cell to ``num_reads`` and
truncated.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from scdna_replication_tools_tpu_torch.device import resolve_device
from scdna_replication_tools_tpu_torch.ops.dists import nb_sample
from scdna_replication_tools_tpu_torch.ops.gc import gc_features, gc_rate


def convert_rt_units(rt: np.ndarray) -> np.ndarray:
    """Map an RT profile to [0, 1] with the largest values earliest -> 0
    (reference: pert_simulator.py:177-179)."""
    rt = np.asarray(rt, np.float32)
    return 1.0 - (rt - rt.min()) / (rt.max() - rt.min())


def _f32(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = np.array(x, np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _cell_betas(betas, libs, num_libraries, num_cells, gen, device,
                beta_noise=None):
    """Per-cell GC betas around ``betas`` with logspace(1 -> 10^-K) stds
    (reference: pert_simulator.py:53-54, 83)."""
    betas = _f32(betas, device)
    K = betas.shape[0] - 1
    beta_means = betas[None, :].expand(num_libraries, K + 1)
    beta_stds = torch.logspace(0.0, -K, K + 1, dtype=torch.float32,
                               device=device)[None, :] \
        .expand(num_libraries, K + 1)
    if beta_noise is None:
        beta_noise = torch.randn((num_cells, K + 1), generator=gen,
                                 dtype=torch.float32, device=device)
    libs = torch.as_tensor(np.asarray(libs), dtype=torch.int64,
                           device=device)
    return beta_means[libs] + beta_stds[libs] * _f32(beta_noise, device), K


def _normalise(reads, num_reads):
    """Per-cell normalisation to ``num_reads``, truncated
    (reference: pert_simulator.py:246-248)."""
    return torch.floor(reads / torch.sum(reads, dim=1, keepdim=True)
                       * num_reads)


def simulate_s_reads(gen: torch.Generator, cn, gammas, rho, libs,
                     num_reads: float, lamb: float, betas: Sequence[float],
                     a: float, num_libraries: int = 1, tau=None,
                     beta_noise=None, rep=None) -> dict:
    """S-phase read counts for a (cells, loci) CN matrix on ``gen``'s
    device (reference: pert_simulator.py:201-249).  ``tau`` (cells,),
    ``beta_noise`` (cells, K+1) standard normals and ``rep`` (cells,
    loci) 0/1 replace the generator's draws where given.  Returns a dict
    of device tensors: reads_norm, reads, rep, p_rep, tau, total_cn,
    betas, and the NB's theta and delta."""
    device = gen.device
    cn = _f32(cn, device)
    num_cells, num_loci = cn.shape
    u_guess = float(num_reads) / (1.5 * num_loci * torch.mean(cn))   # :209
    if tau is None:
        tau = torch.rand((num_cells,), generator=gen, dtype=torch.float32,
                         device=device)                         # Beta(1, 1)
    tau = _f32(tau, device)
    cell_betas, K = _cell_betas(betas, libs, num_libraries, num_cells, gen,
                                device, beta_noise)
    rho = _f32(rho, device)
    phi = torch.sigmoid(a * (tau[:, None] - rho[None, :]))            # :101
    if rep is None:
        rep = (torch.rand(phi.shape, generator=gen, dtype=torch.float32,
                          device=device) < phi).to(torch.float32)     # :104
    rep = _f32(rep, device)
    chi = cn * (1.0 + rep)                                            # :107
    omega = gc_rate(cell_betas, gc_features(_f32(gammas, device), K))
    theta = u_guess * chi * omega                                     # :114
    delta = torch.clamp(theta * (1.0 - lamb) / lamb, min=1.0)         # :118
    reads = nb_sample(delta, torch.tensor(lamb, dtype=torch.float32,
                                          device=device), 1, gen)[0]
    return dict(reads_norm=_normalise(reads, num_reads), reads=reads,
                rep=rep, p_rep=phi, tau=tau, total_cn=chi, betas=cell_betas,
                theta=theta, delta=delta)


def simulate_g_reads(gen: torch.Generator, cn, gammas, libs,
                     num_reads: float, lamb: float, betas: Sequence[float],
                     num_libraries: int = 1, beta_noise=None) -> dict:
    """G1/2-phase read counts, no replication (reference:
    pert_simulator.py:252-282; ``u_guess`` at 1.0x ploidy, :259)."""
    device = gen.device
    cn = _f32(cn, device)
    num_cells, num_loci = cn.shape
    u_guess = float(num_reads) / (1.0 * num_loci * torch.mean(cn))
    cell_betas, K = _cell_betas(betas, libs, num_libraries, num_cells, gen,
                                device, beta_noise)
    omega = gc_rate(cell_betas, gc_features(_f32(gammas, device), K))
    theta = u_guess * cn * omega                                      # :162
    delta = torch.clamp(theta * (1.0 - lamb) / lamb, min=1.0)
    reads = nb_sample(delta, torch.tensor(lamb, dtype=torch.float32,
                                          device=device), 1, gen)[0]
    return dict(reads_norm=_normalise(reads, num_reads), reads=reads,
                betas=cell_betas, theta=theta, delta=delta)


# ---------------------------------------------------------------------------
# pandas front end (reference API parity)
# ---------------------------------------------------------------------------

def _libs_index(df: pd.DataFrame, cell_col="cell_id",
                library_col="library_id"):
    libs = df[[cell_col, library_col]].drop_duplicates(cell_col)
    ids = list(libs[library_col].unique())
    mapping = {lib: i for i, lib in enumerate(ids)}
    return libs.set_index(cell_col)[library_col].map(mapping), len(ids)


def _melt(arr, cn_mat, name):
    m = pd.DataFrame(np.asarray(arr), index=cn_mat.index,
                     columns=cn_mat.columns)
    m = m.T.melt(ignore_index=False, value_name=name).reset_index()
    m["chr"] = m["chr"].astype(str)
    return m


def pert_simulator(
    df_s: pd.DataFrame,
    df_g: pd.DataFrame,
    num_reads: int,
    rt_cols: List[str],
    clones: List[str],
    lamb: float,
    betas: Sequence[float],
    a: float,
    gc_col: str = "gc",
    input_cn_col: str = "true_somatic_cn",
    seed: int = 0,
    tau_range: Optional[Tuple[float, float]] = None,
    device=None,
) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Simulate S- and G1-phase read counts for cells with known CN
    (reference: pert_simulator.py:285-418): one RT column per clone;
    the outputs gain true_reads_norm, true_reads_raw, true_rep,
    true_p_rep, true_t and true_total_cn.  ``tau_range`` draws each
    cell's S-phase time uniform in [lo, hi] instead of [0, 1].  The
    draws run on ``device`` (None = the GPU) from one generator seeded
    with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    df_s = df_s.copy()
    df_g = df_g.copy()
    df_s["chr"] = df_s["chr"].astype(str)
    df_g["chr"] = df_g["chr"].astype(str)
    assert len(rt_cols) == len(clones)

    s_out = []
    for rt_col, clone_id in zip(rt_cols, clones):
        clone_df = df_s[df_s["clone_id"].astype(str) == str(clone_id)]
        libs_map, L = _libs_index(clone_df)
        cn_mat = clone_df.pivot_table(index="cell_id",
                                      columns=["chr", "start"],
                                      values=input_cn_col)
        loci_df = clone_df[["chr", "start", gc_col, rt_col]] \
            .drop_duplicates(["chr", "start"]).set_index(["chr", "start"])
        loci_df = loci_df.reindex(cn_mat.columns)
        gammas = loci_df[gc_col].to_numpy(np.float32)
        rho = convert_rt_units(loci_df[rt_col].to_numpy())
        libs = libs_map.reindex(cn_mat.index).to_numpy(np.int32)

        tau = None
        if tau_range is not None:
            lo, hi = float(tau_range[0]), float(tau_range[1])
            tau = lo + (hi - lo) * torch.rand(
                (cn_mat.shape[0],), generator=gen, dtype=torch.float32,
                device=dev)
        sim = simulate_s_reads(gen, cn_mat.to_numpy(np.float32), gammas,
                               rho, libs, num_reads, lamb, betas, a,
                               num_libraries=L, tau=tau)
        sim = {k: v.cpu().numpy() for k, v in sim.items()}

        merged = clone_df
        for key, name in (("reads_norm", "true_reads_norm"),
                          ("reads", "true_reads_raw"), ("rep", "true_rep"),
                          ("p_rep", "true_p_rep")):
            merged = pd.merge(merged, _melt(sim[key], cn_mat, name))
        merged = pd.merge(merged, pd.DataFrame({
            "cell_id": cn_mat.index, "true_t": sim["tau"]}), on="cell_id")
        s_out.append(merged)

    df_s = pd.concat(s_out, ignore_index=True)

    libs_map, L = _libs_index(df_g)
    cn_mat = df_g.pivot_table(index="cell_id", columns=["chr", "start"],
                              values=input_cn_col)
    loci_df = df_g[["chr", "start", gc_col]] \
        .drop_duplicates(["chr", "start"]).set_index(["chr", "start"])
    loci_df = loci_df.reindex(cn_mat.columns)
    gammas = loci_df[gc_col].to_numpy(np.float32)
    libs = libs_map.reindex(cn_mat.index).to_numpy(np.int32)
    sim_g = simulate_g_reads(gen, cn_mat.to_numpy(np.float32), gammas, libs,
                             num_reads, lamb, betas, num_libraries=L)
    sim_g = {k: v.cpu().numpy() for k, v in sim_g.items()}

    df_g = pd.merge(df_g, _melt(sim_g["reads_norm"], cn_mat,
                                "true_reads_norm"))
    df_g = pd.merge(df_g, _melt(sim_g["reads"], cn_mat, "true_reads_raw"))
    df_g["true_t"] = 0.0
    df_g["true_rep"] = 0.0
    df_g["true_p_rep"] = 0.0

    # true total CN = somatic CN * (1 + rep) (reference:
    # pert_simulator.py:414-416)
    df_s["true_total_cn"] = df_s[input_cn_col] * (df_s["true_rep"] + 1)
    df_g["true_total_cn"] = df_g[input_cn_col] * (df_g["true_rep"] + 1)
    return df_s, df_g
