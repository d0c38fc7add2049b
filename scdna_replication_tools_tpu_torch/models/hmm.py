"""Locus-coupled CN decoding: Viterbi over the genome (port of
``models/hmm.py``).

The emissions are the per-bin joint logits of the independent decode
(``models.pert.model_joint_logits``) with the replication axis summed
out; the transition matrix keeps ``self_prob`` on the diagonal and
spreads the rest uniformly; a chromosome start zeroes the transition
scores, so the chain restarts from the running path maximum.

The forward recursion is a loop over loci of (cells, P, P) max-plus
steps, the backtrace a reverse loop of gathers, all on the device of the
emissions: nothing inside either loop reads the device from the host.
Ties go to the first maximal state, as ``jnp.argmax`` breaks them.  The
JAX package has no Pallas kernel here, so plain torch ops are the port.
"""

from __future__ import annotations

import numpy as np
import torch


def transition_log_probs(P: int, self_prob: float,
                         device=None) -> torch.Tensor:
    """(P, P) float32 log transition matrix: stay with ``self_prob``,
    switch uniformly otherwise."""
    off = (1.0 - self_prob) / (P - 1)
    # the logs in float32, as jnp.log takes a Python float
    log_off, log_self = torch.log(torch.tensor([off, self_prob],
                                               dtype=torch.float32)).tolist()
    t = torch.full((P, P), log_off, dtype=torch.float32, device=device)
    t.fill_diagonal_(log_self)
    return t


def viterbi_paths(emissions: torch.Tensor, restart,
                  log_trans: torch.Tensor) -> torch.Tensor:
    """(cells, loci) int32 MAP paths from (cells, loci, P) emissions.

    ``restart`` (loci,) is 1 wherever a new chromosome starts (a free
    transition into that locus); it is read once, before the loops."""
    cells, loci, P = emissions.shape
    restart = np.asarray(torch.as_tensor(restart).cpu()) > 0
    log_trans = log_trans.to(emissions.device, emissions.dtype)
    free = torch.zeros_like(log_trans)
    # uint8 back-pointers: P <= 255 states, a quarter of the int32 planes
    backptr = torch.empty((max(loci - 1, 0), cells, P), dtype=torch.uint8,
                          device=emissions.device)
    carry = emissions[:, 0]
    for l in range(1, loci):
        trans = free if restart[l] else log_trans
        scores = carry[:, :, None] + trans[None]          # (cells, from, to)
        backptr[l - 1] = torch.argmax(scores, dim=1).to(torch.uint8)
        carry = torch.amax(scores, dim=1) + emissions[:, l]

    path = torch.empty((cells, loci), dtype=torch.int64,
                       device=emissions.device)
    state = torch.argmax(carry, dim=1)
    path[:, loci - 1] = state
    for l in range(loci - 2, -1, -1):
        state = torch.gather(backptr[l], 1, state[:, None])[:, 0] \
            .to(torch.int64)
        path[:, l] = state
    return path.to(torch.int32)


def hmm_decode(joint_logits: torch.Tensor, restart, self_prob: float,
               mesh=None):
    """Genome-smoothed (cn, rep, p_rep) from (cells, loci, P, 2) logits:
    CN from Viterbi over the rep-marginalised emissions, rep the argmax
    over the rep axis at the decoded CN, p_rep the full marginal
    P(rep = 1 | reads) of the independent decode.  With a ``mesh`` that
    shards the loci, ``joint_logits`` is this rank's loci tile and
    ``restart`` covers every locus: the emissions (P floats a bin) are
    gathered along the rank's loci row, the chain runs over whole rows,
    and the rank keeps its own tile of the paths (JAX's one-process mesh
    decodes whole rows too)."""
    from scdna_replication_tools_tpu_torch.models.pert import p_rep_marginal

    P = joint_logits.shape[-2]
    emissions = torch.logsumexp(joint_logits, dim=-1)        # (c, l, P)
    log_trans = transition_log_probs(P, self_prob, joint_logits.device)
    if mesh is not None and mesh.loci > 1:
        rows = mesh.gather_loci(emissions)
        cn_map = viterbi_paths(rows, restart, log_trans)[
            :, mesh.loci_slice(rows.shape[1])].contiguous()
    else:
        cn_map = viterbi_paths(emissions, restart, log_trans)
    at_cn = torch.gather(
        joint_logits, -2,
        cn_map.to(torch.int64)[..., None, None].expand(
            cn_map.shape + (1, 2)))[..., 0, :]               # (c, l, 2)
    rep_map = torch.argmax(at_cn, dim=-1).to(torch.int32)
    return cn_map, rep_map, p_rep_marginal(joint_logits)
