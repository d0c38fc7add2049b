"""chip_smoke.py's data-dependent counts, on the CPU, against a brute-force
count bin by bin.

The NB cores of csrc/enum_fused.cu run the Stirling series' 8-step shift
only in warps of 32 consecutive bins where one bin has an lgamma argument
below 8, so the bound that chip_smoke.py prints counts the shift's
operations per argument that needs it (``shift_census``, ``enum_ops``)
and reports the share of warps that take it.  With every argument
shifted, the counts must equal the per-bin counts of the unbranched
series (1707 and 2739 float32 operations per bin for the dense pair at
P = 13).  ``mufu_calls_per_bin`` counts the special-function-unit calls
of each kernel per bin, for the bound's third term.  ``parse_sass`` reads
``cuobjdump -sass`` listings and ``parse_ptxas`` ``-Xptxas -v`` logs,
which only the card's toolkit makes: here each reads a short text
written in that form.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _q():
    return ek.scalars(torch.tensor(0.75, dtype=torch.float32))[2]


def _operands(C, L, regime, seed):
    """(reads, mu) float32: "high" (mu 40-80), "low" (mu 0.2-3, reads
    0-5), "mixed" (the two lane by lane), "spread" (mu 0.2-80, reads
    around mu chi, as chip_smoke.py's kernel inputs) and "edge" (delta and
    x + delta on either side of 8 and of the clamp)."""
    rng = np.random.default_rng(seed)
    hi_mu = rng.uniform(40, 80, (C, L))
    hi_reads = rng.poisson(hi_mu * rng.integers(1, 7, (C, L)))
    lo_mu = rng.uniform(0.2, 3, (C, L))
    lo_reads = rng.integers(0, 6, (C, L))
    if regime == "high":
        mu, reads = hi_mu, hi_reads
    elif regime == "low":
        mu, reads = lo_mu, lo_reads
    elif regime == "mixed":
        odd = (np.arange(C * L).reshape(C, L) % 2).astype(bool)
        mu, reads = np.where(odd, lo_mu, hi_mu), np.where(odd, lo_reads,
                                                          hi_reads)
    elif regime == "spread":
        mu = rng.uniform(0.2, 80, (C, L))
        reads = rng.poisson(mu * rng.integers(1, 7, (C, L)))
    else:
        # mu chi q lands on 1 and on 8 for chi = 1, 2, 3, 6, 8
        mu = rng.choice([3.0, 3.0000002, 24.0, 23.999998, 12.0, 4.0, 1.5,
                         1.0, 0.375], (C, L))
        reads = rng.choice([0.0, 1.0, 6.0, 7.0, 8.0], (C, L))
    return (torch.tensor(reads, dtype=torch.float32),
            torch.tensor(mu, dtype=torch.float32))


def _brute_census(reads, mu, q, P):
    """Bin by bin and warp by warp, in float32 as the kernels round."""
    x = reads.numpy().ravel()
    m = mu.numpy().ravel()
    q = np.float32(q.item())
    one, eight = np.float32(1.0), np.float32(8.0)
    chis = [np.float32(chi) for chi, _ in ek.chi_slots(P) if chi != 0.0]
    n = x.size
    counts = {"x1": 0, "xd": 0, "d": 0}
    pairs = taken = 0
    for w0 in range(0, n, 32):
        warp_small = False
        for i in range(w0, min(w0 + 32, n)):
            small = np.float32(x[i] + one) < eight
            counts["x1"] += small
            for chi in chis:
                delta = max(np.float32(m[i] * np.float32(chi * q)), one)
                s_xd = np.float32(x[i] + delta) < eight
                s_d = delta < eight
                counts["xd"] += s_xd
                counts["d"] += s_d
                pairs += s_xd or s_d
                small = small or s_xd or s_d
            warp_small = warp_small or small
        taken += warp_small
    warps = -(-n // 32)
    return dict(counts, bins=n, warps=warps, taken=taken,
                pair_share=pairs / (n * len(chis)), warp_share=taken / warps)


@pytest.mark.parametrize("P", [13, 7])
@pytest.mark.parametrize("regime", ["high", "low", "mixed", "spread", "edge"])
def test_shift_census_matches_brute_force(cs, regime, P):
    """Arguments below 8 per call, the (bin, chi) pair share and the share
    of warps that take the shift, on a (3, 45) grid whose last warp is
    ragged."""
    reads, mu = _operands(3, 45, regime, seed=P)
    got = cs.shift_census(reads, mu, _q(), P)
    ref = _brute_census(reads, mu, _q(), P)
    keys = ("bins", "warps", "taken", "x1", "xd", "d")
    assert {k: got[k] for k in keys} == {k: ref[k] for k in keys}
    assert got["pair_share"] == pytest.approx(ref["pair_share"], abs=1e-12)
    assert got["warp_share"] == pytest.approx(ref["warp_share"], abs=1e-12)
    if regime == "high":
        assert got["warp_share"] == 0.0
    if regime in ("low", "mixed"):
        assert got["warp_share"] == 1.0
        assert got["x1"] == (reads.numel() if regime == "low"
                             else reads.numel() // 2)


@pytest.mark.parametrize("P", [13, 7, 2])
@pytest.mark.parametrize("regime", ["high", "low", "mixed", "spread", "edge"])
def test_the_kernels_vote_sees_every_argument_below_8(regime, P):
    """csrc/enum_fused.cu's warp_needs_shift looks at two arguments per bin
    only, x + 1 and delta at chi = 1, in float32 as the kernels round
    them; a bin has an lgamma argument below 8 at some chi exactly when
    one of the two is below 8 (delta grows with chi and x + delta >=
    delta), so a warp that skips the shift needs it nowhere."""
    reads, mu = _operands(3, 45, regime, seed=P)
    q = _q()
    any_small = (reads + 1.0) < 8.0
    for chi in [c for c, _ in ek.chi_slots(P) if c != 0.0]:
        delta = torch.clamp(mu * (chi * q), min=1.0)
        any_small |= ((reads + delta) < 8.0) | (delta < 8.0)
    vote = ((reads + 1.0) < 8.0) | (torch.clamp(mu * q, min=1.0) < 8.0)
    assert torch.equal(vote, any_small)


# float32 operations per bin of the unbranched series (every argument
# shifted) at P = 13: chip_smoke.py's counts before the shift was split
UNBRANCHED_OPS_P13 = {
    "enum_fwd": 1601, "enum_bwd": 2598,
    "fused_fwd_dense": 1707, "fused_bwd_dense": 2739,
    "fused_fwd_sparse": 1720, "fused_bwd_sparse": 2740,
    "fused_fwd_dense_binary": 1717, "fused_bwd_dense_binary": 2771,
    "fused_fwd_sparse_binary": 1730, "fused_bwd_sparse_binary": 2772,
}


@pytest.mark.parametrize("name", sorted(UNBRANCHED_OPS_P13))
def test_enum_ops_span_the_unbranched_and_the_skipped_shift(cs, name):
    """With every argument below 8 a launch costs the unbranched series'
    operations; with none, exactly the shift's share less (18 per lgamma,
    32 per lgamma + digamma), and the SFU count one log's instructions
    per lgamma argument less (a log's and 8 reciprocals' per lgamma +
    digamma one)."""
    P, n = 13, 3 * 45
    nonzero = len(ek.chi_slots(P)) - 1
    reads, mu = _operands(3, 45, "low", seed=1)
    all_shift = {"bins": n, "x1": n, "xd": n * nonzero, "d": n * nonzero}
    none = {"bins": n, "x1": 0, "xd": 0, "d": 0}
    assert cs.enum_ops(name, P, all_shift) == UNBRANCHED_OPS_P13[name] * n
    chi_shift = cs.LGDG_SHIFT_OPS if "_bwd" in name else cs.LGAMMA_SHIFT_OPS
    assert cs.enum_ops(name, P, all_shift) - cs.enum_ops(name, P, none) == \
        n * (cs.LGAMMA_SHIFT_OPS + 2 * nonzero * chi_shift)
    log, rcp = cs.MUFU_PER_CALL["log"], cs.MUFU_PER_CALL["rcp"]
    per_chi = log + (8 * rcp if "_bwd" in name else 0)
    assert cs.mufu_ops(name, P, all_shift) - cs.mufu_ops(name, P, none) \
        == n * (log + 2 * nonzero * per_chi)
    # a census of real operands lands between the two
    census = cs.shift_census(reads, mu, _q(), P)
    assert cs.enum_ops(name, P, none) <= cs.enum_ops(name, P, census) \
        <= cs.enum_ops(name, P, all_shift)


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_116fused_bwd_kernelILb0ELb1EEEvPKfS2_
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
                                                                     /* 0x000fe40000000800 */
        /*0010*/                   FSETP.GEU.AND P0, PT, R4, 8, PT ; /* 0x0000000000007802 */
        /*0020*/                   VOTE.ANY R5, PT, !P0 ;            /* 0x0000000000007802 */
        /*0030*/                   ISETP.NE.AND P1, PT, R5, RZ, PT ; /* 0x0000000000007802 */
        /*0040*/               @!P1 BRA `(.L_x_3) ;                  /* 0x0000000000007802 */
        /*0050*/                   MUFU.LG2 R6, R7 ;                 /* 0x0000000000007802 */
        /*0060*/                   MUFU.RCP R8, R9 ;                 /* 0x0000000000007802 */
        /*0070*/                   MUFU.LG2 R6, R6 ;                 /* 0x0000000000007802 */
        /*0080*/                   VOTE.ANY R5, PT, P0 ;             /* 0x0000000000007802 */
        /*0090*/                   FSEL R2, R3, R2, P0 ;             /* 0x0000000000007802 */
        /*00a0*/                   EXIT ;                            /* 0x0000000000007802 */
        /*00b0*/                   BRA 0xb0;                         /* 0x0000000000007802 */
        /*00c0*/                   NOP;                              /* 0x0000000000007802 */
\t\tFunction : _ZN12_GLOBAL__N_111adam_kernelI13__nv_bfloat16EEvPfS2_
        /*0000*/                   MUFU.RSQ R1, R2 ;                 /* 0x0000000000007802 */
        /*0010*/                   EXIT ;                            /* 0x0000000000007802 */
\t\tFunction : _ZN12_GLOBAL__N_115enum_bwd_kernelEPKfS1_S1_S1_S1_S1_S1_PfS2_S2_li
        /*0000*/                   STS [R0], R2 ;                    /* 0x0000000000007802 */
        /*0010*/                   FENCE.VIEW.ASYNC.S ;              /* 0x0000000000007802 */
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;     /* 0x0000000000007802 */
        /*0030*/                   UBLKCP.G.S [UR8], [UR10], UR12 ;  /* 0x0000000000007802 */
        /*0040*/                   UTMACMDFLUSH ;                    /* 0x0000000000007802 */
        /*0050*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R3 ;  /* 0x0000000000007802 */
        /*0060*/                   EXIT ;                            /* 0x0000000000007802 */
\t\tFunction : _ZN12_GLOBAL__N_115enum_fwd_kernelEPKfS1_S1_S1_S1_Pfli
        /*0000*/                   EXIT ;                            /* 0x0000000000007802 */
"""


def test_parse_sass_counts_votes_branches_and_mufu(cs):
    """Names demangled with their template arguments; NOPs and encoding
    words left out; one of two votes guards a predicated branch; the bulk
    copy, its group's commit and an mbarrier wait counted by kind, and the
    bulk copy alone as one, where a kernel has them."""
    got = cs.parse_sass(SASS)
    assert set(got) == {"fused_bwd_kernel<false, true>",
                        "adam_kernel<__nv_bfloat16>", "enum_bwd_kernel",
                        "enum_fwd_kernel"}
    bwd = got["fused_bwd_kernel<false, true>"]
    assert bwd == {"instructions": 12, "mufu": 3,
                   "mufu_by_kind": {"MUFU.LG2": 2, "MUFU.RCP": 1},
                   "votes": 2, "branches": 2, "votes_guarding_a_branch": 1,
                   "bulk_copies": 0, "async_by_kind": {}}
    assert got["adam_kernel<__nv_bfloat16>"]["mufu"] == 1
    staged = got["enum_bwd_kernel"]
    assert staged["instructions"] == 7 and staged["bulk_copies"] == 1
    assert staged["async_by_kind"] == {
        "UBLKCP.G.S": 1, "UTMACMDFLUSH": 1,
        "SYNCS.PHASECHK.TRANS64.TRYWAIT": 1}
    assert got["enum_fwd_kernel"]["bulk_copies"] == 0
    assert set(cs.SASS_FUNCTION.values()) >= set(got)


PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115enum_bwd_kernelEPKfS1_S1_S1_S1_S1_S1_PfS2_S2_li' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115enum_bwd_kernelEPKfS1_S1_S1_S1_S1_S1_PfS2_S2_li
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 16384 bytes smem, 400 bytes cmem[0]
ptxas info    : Function properties for __internal_0_$__cuda_sm3x_div_rn_noftz_f32_slowpath
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116fused_bwd_kernelILb0ELb1EEEvPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116fused_bwd_kernelILb0ELb1EEEvPKfS2_
    0 bytes stack frame, 280 bytes spill stores, 280 bytes spill loads
ptxas info    : Used 64 registers, 448 bytes cmem[0]
"""


def test_parse_ptxas_reads_registers_shared_memory_and_spills(cs):
    """Per entry function of ``-Xptxas -v``: registers, static shared
    memory (0 where the line names none) and spills; a called
    function's properties are not an entry's."""
    got = cs.parse_ptxas(PTXAS)
    assert got == {
        "enum_bwd_kernel": {"registers": 80, "smem": 16384,
                                  "spill_stores": 0, "spill_loads": 0},
        "fused_bwd_kernel<false, true>": {"registers": 64, "smem": 0,
                                          "spill_stores": 280,
                                          "spill_loads": 280}}


def _brute_mufu_calls(name, P):
    """SFU calls per bin, walking the kernels' structure: the fused
    kernels' log-softmax (P exps, one log), the Bernoulli logs (and the
    backward's two slope divisions), lgamma(x + 1), two lgamma (+
    digamma) per nonzero chi slot, one exp per (state, rep) pair of each
    slot, the fused backward's Jacobian (P exps), the forward's final
    log."""
    fused, bwd = not name.startswith("enum_"), "_bwd" in name
    calls = {"exp": 0, "log": 0, "rcp": 0}
    if fused:
        calls["exp"] += P
        calls["log"] += 1
    calls["log"] += 2
    calls["rcp"] += 2 if bwd else 0
    calls["rcp"] += 1
    calls["log"] += 1
    for chi, pairs in ek.chi_slots(P):
        if chi != 0.0:
            calls["rcp"] += 2
            calls["log"] += 2
        calls["exp"] += len(pairs)
    if fused and bwd:
        calls["exp"] += P
    if not bwd:
        calls["log"] += 1
    return calls


@pytest.mark.parametrize("name", sorted(UNBRANCHED_OPS_P13))
def test_mufu_calls_per_bin_match_a_brute_count(cs, name):
    """chip_smoke.py's closed-form SFU calls per bin against a walk over
    chi_slots(P), for every P the kernels take (1..16); at P = 13 the
    unfused forward makes 103 (the 18 nonzero chi slots' 36 lgamma,
    26 exps, lgamma(x + 1), two Bernoulli logs and the final log)."""
    for P in range(1, ek.MAX_P + 1):
        assert cs.mufu_calls_per_bin(name, P) == _brute_mufu_calls(name, P)
    if name == "enum_fwd":
        assert sum(cs.mufu_calls_per_bin(name, 13).values()) == 103
    none = {"bins": 7, "x1": 0, "xd": 0, "d": 0}
    assert cs.mufu_ops(name, 13, none) == 7 * sum(
        cs.MUFU_PER_CALL[k] * v
        for k, v in cs.mufu_calls_per_bin(name, 13).items())


@pytest.mark.parametrize("term", ["bytes", "float32", "mufu"])
def test_bound_takes_the_largest_of_its_three_terms(cs, term):
    """bytes over the HBM rate, float32 operations over the float32 rate,
    SFU instructions over the SFU rate (here 132 SMs x 16 x 1.98 GHz):
    the largest sets the bound, and only bytes is named "bytes"."""
    rate = 132 * 16 * 1.98e9
    # one second of the named term, a millisecond of each other
    per_s = {"bytes": cs.HBM_BYTES_PER_S, "float32": cs.F32_OPS_PER_S,
             "mufu": rate}
    sizes = [int(v if k == term else v / 1e3) for k, v in per_s.items()]
    ms, by, got = cs.bound(*sizes, mufu_per_s=rate)
    assert got == term
    assert by == ("bytes" if term == "bytes" else "operations")
    assert ms == pytest.approx(1e3, rel=1e-9)
    terms = cs.bound_terms(*sizes, mufu_per_s=rate)
    assert terms[term] == ms and all(
        v == pytest.approx(1.0, rel=1e-6) for k, v in terms.items()
        if k != term)
    # without SFU work the two older terms decide
    assert cs.bound(10, 0)[2] == "bytes"
