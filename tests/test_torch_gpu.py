"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc; without them it skips.  The
module imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed, without the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are on max|kernel - plain| / max(1, max|plain|, scale), with
scale the largest term that out and dpi sum (as chip_smoke.py holds
them).  The kernels repeat the plain versions' float32 operations in the
same order; they differ by FMA contraction and the exp/log ulps of the
two builds.  The NB values nb(chi) run to thousands, where a float32 ulp
is ~5e-4, and the posterior weights exp(lp + bern + nb - lse) carry that
absolute rounding as a relative one: dmu and dphi, which sum those
weights times slopes of opposite sign, are held to 1e-3, the rest to
1e-5 (Adam 1e-6).

Those bounds are relative to the prior's 1e6 concentrations for out and
dpi.  A second, flat prior (etas = 1, eta_w = 0) leaves out - lse as the
hoisted read term alone and dpi as the enumeration's own share, O(|g|):
the bounds then hold the posterior weights absolutely (TOL_FLAT, dpi
3e-3), and the hoisted term is held per element as |a - b| / (1 + |b|).
The binary kernels are held to the same bounds: dz sums dpi terms of
the same size and rounding.  The unfused pair (enum_fwd / enum_bwd) has
no prior.  Its ll = lse + x log(lamb) - lgamma(x + 1) is a few units
where the three terms run to thousands (a float32 ulp ~1e-4 there), so
ll is held per element to 1e-5 of 1 + |lse| + |x log(lamb) - lgamma(x +
1)| (_ll_err), the out bound: the NB core's lgamma terms inside lse are
larger still and their ulps land on ll (readings ~1.2e-6).  dmu and dphi
are held to 1e-3 and dlog_pi, a sum of posterior weights, to the flat
prior's dpi bound (TOL_ENUM).  With bfloat16 Adam moments, m' and v' are
held to one bfloat16 ulp per element and param' to 1e-6 (the kernel
repeats the plain version's roundings, so the readings are 0; one ulp is
what a float32 rounding that tips a round-to-nearest-even would leave).

The NB cores' Stirling series shifts an argument below 8 up by 8, and a
warp runs the shift (in the plain version's select form) only when one of
its 32 bins needs it, otherwise the series alone; each lane keeps the value
the plain version's select keeps.  The ``across_the_shift`` tests hold every
enumeration kernel to the same bounds with whole warps that need the shift
in no bin, in every bin, and in every other bin.

The unfused pair reads each bin's P cells-major log_pi floats per thread;
the backward stages each full 256-bin block's dlog_pi span in shared
memory and writes it back with one bulk asynchronous copy, and stores per
thread in a grid's short last block (or a grid of one short block).  Its
tests cover both store paths and assert the launch key that counted each
call; the C entry refuses a dlog_pi that is not 16-B aligned.
"""

import json

import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu_torch.ops import _cuda
from scdna_replication_tools_tpu_torch.ops import adam_kernel as ak
from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek

pytestmark = pytest.mark.gpu

TOL = {"out": 1e-5, "lse": 1e-5, "dpi": 1e-5, "dmu": 1e-3, "dphi": 1e-3,
       "param": 1e-6, "m": 1e-6, "v": 1e-6}
TOL_FLAT = {"out": 1e-5, "lse": 1e-5, "hoisted": 1e-5, "dmu": 1e-3,
            "dphi": 1e-3, "dpi": 3e-3}
TOL_ENUM = {"ll": 1e-5, "dmu": 1e-3, "dphi": 1e-3, "dlog_pi": 3e-3}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _amax(t):
    return float(t.abs().max())


def _rel(got, ref, scale=0.0):
    return float((got - ref).abs().max()) / max(1.0, _amax(ref), scale)


def _regime(rng, C, L, regime):
    """(mu, reads) of one regime of the NB cores' shift, on whole warps of
    32 consecutive bins of the flattened grid: "high" has every argument
    of every lgamma at 8 or above (mu 40-80, reads around mu chi), so no
    warp takes the shift; "low" has x + 1 < 8 and delta at its clamp of 1
    at chi = 1 in every bin, and below 8 over the low chi slots (mu
    0.2-3, reads 0-5), so every warp takes it there; "mixed" alternates
    the two lane by lane, so every warp that takes it has half its lanes
    keeping the unshifted value."""
    hi_mu = rng.uniform(40, 80, (C, L))
    hi_reads = rng.poisson(hi_mu * rng.integers(1, 7, (C, L)))
    lo_mu = rng.uniform(0.2, 3, (C, L))
    lo_reads = rng.integers(0, 6, (C, L))
    if regime == "high":
        return hi_mu, hi_reads
    if regime == "low":
        return lo_mu, lo_reads
    odd = (np.arange(C * L).reshape(C, L) % 2).astype(bool)
    return np.where(odd, lo_mu, hi_mu), np.where(odd, lo_reads, hi_reads)


def _inputs(C, L, P, seed, dev, flat=False, regime=None):
    rng = np.random.default_rng(seed)
    arr = {
        "mu": rng.uniform(0.2, 60, (C, L)),
        "phi": rng.uniform(0.001, 0.999, (C, L)),
        "pi_t": rng.normal(0, 2, (P, C, L)),
        "z_t": rng.normal(0, 2, (ek.binary_code_width(P), C, L)),
        "g": rng.normal(0, 1, (C, L)),
        "etas_t": np.ones((P, C, L)),
        "eidx": rng.integers(0, P, (C, L)),
        "ew": np.where(rng.uniform(size=(C, L)) < 0.9, 1e6, 0.0),
    }
    # reads around mu * chi: the low-chi slots, where delta sits at its
    # clamp of 1, carry posterior weight
    arr["reads"] = rng.poisson(arr["mu"] * rng.integers(1, 7, (C, L)))
    if regime is not None:
        arr["mu"], arr["reads"] = _regime(rng, C, L, regime)
    if flat:
        arr["ew"] = np.zeros((C, L))
    else:
        np.put_along_axis(arr["etas_t"], rng.integers(0, P, (1, C, L)), 1e6,
                          0)
    return {k: torch.tensor(v, dtype=torch.float32, device=dev)
            for k, v in arr.items()}


def _check_fused(x, P, sparse, flat, binary, dev):
    tol = TOL_FLAT if flat else TOL
    scal = ek.scalars(torch.tensor(0.75, dtype=torch.float32, device=dev))
    prior = dict(eta_idx=x["eidx"], eta_w=x["ew"]) if sparse \
        else dict(etas_t=x["etas_t"])
    if binary:
        prior["binary_P"] = P
    args = (x["reads"], x["mu"], x["z_t"] if binary else x["pi_t"], x["phi"],
            scal)
    key = ("sparse" if sparse else "dense") + ("_binary" if binary else "")
    _cuda.reset_launches()
    out_k, lse_k = ek.fused_fwd(*args, **prior)
    out_p, lse_p = ek.fused_fwd_plain(*args, **prior)
    got = ek.fused_bwd(*args, lse_p, x["g"], **prior)
    ref = ek.fused_bwd_plain(*args, lse_p, x["g"], **prior)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[f"fused_fwd_{key}"] == 1
    assert _cuda.LAUNCHES[f"fused_bwd_{key}"] == 1
    assert sum(_cuda.LAUNCHES.values()) == 2
    assert got[2].shape == args[2].shape
    weight = x["ew"] if sparse else x["etas_t"] - 1.0
    scale = {"out": max(_amax(lse_p), _amax(out_p - lse_p)),
             "dpi": _amax(x["g"]) * _amax(weight)}
    pairs = [("out", out_k, out_p), ("lse", lse_k, lse_p)] + list(
        zip(("dmu", "dphi", "dpi"), got, ref))
    for name, a, b in pairs:
        assert bool(torch.isfinite(a).all()), name
        err = _rel(a, b, scale.get(name, 0.0))
        assert err <= tol[name], (name, err)
    if flat:
        hk, hp = out_k - lse_k, out_p - lse_p
        per_bin = float(((hk - hp).abs() / (1.0 + hp.abs())).max())
        assert per_bin <= tol["hoisted"], ("hoisted", per_bin)


@pytest.mark.parametrize("flat", [False, True], ids=["prior", "flat"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("P", [13, 7])
def test_fused_kernels_match_plain(dev, sparse, P, flat):
    """Forward (out, lse) and backward (dmu, dphi, dpi) of the kernel
    against the plain version, at a (37, 1001) grid that is ragged
    against the 256-thread blocks, with a 1e6 prior and with a flat one;
    each launch is counted once."""
    x = _inputs(37, 1001, P, seed=P + int(sparse), dev=dev, flat=flat)
    _check_fused(x, P, sparse, flat, False, dev)


@pytest.mark.parametrize("flat", [False, True], ids=["prior", "flat"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("P", [13, 7, 2])
def test_binary_kernels_match_plain(dev, sparse, P, flat):
    """The four binary kernels (Kb planes in, Kb dz planes out) against
    their plain versions on the same ragged grid, prior and flat; P = 2
    is the one-plane edge."""
    x = _inputs(37, 1001, P, seed=30 + P + int(sparse), dev=dev, flat=flat)
    _check_fused(x, P, sparse, flat, True, dev)


def _assert_regime(x, regime):
    """The operands are the regime that they are named for, warp by warp
    (the last, ragged warp included): per bin of the flattened grid,
    whether lgamma(x + 1) or any NB core's argument lies below 8.  chi = 1
    has the smallest delta = max(mu chi q, 1), rounded as the kernels
    round it, and x + delta >= delta."""
    reads, mu = x["reads"].reshape(-1), x["mu"].reshape(-1)
    q = ek.scalars(torch.tensor(0.75, dtype=torch.float32,
                                device=mu.device))[2]
    delta1 = torch.clamp(mu * (1.0 * q), min=1.0)
    any_small = ((reads + 1.0) < 8.0) | (delta1 < 8.0)
    n = any_small.numel()
    lanes = torch.zeros(-(-n // 32) * 32, dtype=torch.bool,
                        device=any_small.device)
    lanes[:n] = any_small
    per_warp = lanes.view(-1, 32)
    if regime == "high":
        assert not bool(any_small.any())
    elif regime == "low":
        assert bool(any_small.all())
    else:
        assert bool(per_warp.any(dim=1).all())
        assert not bool(any_small[0::2].any()) and bool(any_small[1::2].all())


@pytest.mark.parametrize("flat", [False, True], ids=["prior", "flat"])
@pytest.mark.parametrize("kind", ["dense", "sparse", "dense_binary",
                                  "sparse_binary"])
@pytest.mark.parametrize("P", [13, 7])
@pytest.mark.parametrize("regime", ["high", "low", "mixed"])
def test_fused_kernels_match_plain_across_the_shift(dev, regime, P, kind,
                                                    flat):
    """Both fused kernels of every encoding against their plain versions,
    with whole warps that skip the NB cores' shift (high), take it (low)
    or need it in every other bin (mixed), on the ragged (37, 1001)
    grid, at the unchanged bounds."""
    x = _inputs(37, 1001, P, seed=80 + P + len(kind), dev=dev, flat=flat,
                regime=regime)
    _assert_regime(x, regime)
    _check_fused(x, P, kind.startswith("sparse"), flat,
                 kind.endswith("binary"), dev)


@pytest.mark.parametrize("P", [13, 7])
@pytest.mark.parametrize("regime", ["high", "low", "mixed"])
def test_unfused_kernels_match_plain_across_the_shift(dev, regime, P):
    """enum_fwd and enum_bwd against their plain versions in the three
    regimes of the shift, on the ragged grid, at TOL_ENUM; the backward
    stages the dlog_pi span of every full block."""
    x = _inputs(37, 1001, P, seed=90 + P, dev=dev, regime=regime)
    _assert_regime(x, regime)
    _check_unfused(x, P, _log_pi(37, 1001, P, 90 + P, dev), "staged")


@pytest.mark.parametrize("binary", [False, True], ids=["cat", "binary"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_autograd_function_on_cuda_matches_cpu(dev, sparse, binary):
    """The autograd entry points on the card (kernels) and on the CPU
    (plain versions) give the same value and cotangents."""
    x = _inputs(8, 300, 13, seed=21, dev=dev)
    lamb = torch.tensor(0.75, dtype=torch.float32)
    pkey = "z_t" if binary else "pi_t"
    res = []
    for d in (dev, torch.device("cpu")):
        t = {k: v.to(d) for k, v in x.items()}
        mu, pi_t, phi = (t[k].clone().requires_grad_(True)
                         for k in ("mu", pkey, "phi"))
        if sparse and binary:
            out = ek.enum_loglik_fused_sparse_binary(
                t["reads"], mu, pi_t, phi, t["eidx"], t["ew"], lamb.to(d), 13)
        elif binary:
            out = ek.enum_loglik_fused_binary(t["reads"], mu, pi_t, phi,
                                              t["etas_t"], lamb.to(d), 13)
        elif sparse:
            out = ek.enum_loglik_fused_sparse(t["reads"], mu, pi_t, phi,
                                              t["eidx"], t["ew"], lamb.to(d))
        else:
            out = ek.enum_loglik_fused(t["reads"], mu, pi_t, phi,
                                       t["etas_t"], lamb.to(d))
        grads = torch.autograd.grad(out, (mu, phi, pi_t), t["g"])
        res.append([a.detach().cpu() for a in (out, *grads)])
    for name, a, b in zip(("out", "dmu", "dphi", "dpi"), *res):
        assert _rel(a, b) <= TOL[name], (name, _rel(a, b))


def _ll_err(got, ref, reads, lamb):
    """max |got - ref| / (1 + |lse| + |hoisted|) over elements: the
    scale of the terms that ll sums."""
    hoisted = reads * torch.log(lamb) - ek.lgamma_ge1(reads + 1.0)
    scale = 1.0 + (ref - hoisted).abs() + hoisted.abs()
    return float(((got - ref).abs() / scale).max())


def _log_pi(C, L, P, seed, dev):
    """A random non-uniform cells-major log-simplex (equal states would
    hide a swapped state index)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = 2.0 * torch.randn((C, L, P), generator=gen, device=dev)
    return torch.log_softmax(logits, dim=-1)


# (cells, loci) grids by the last 256-bin block's span: 173 bins (the
# ragged grid), 255 and 1 (spans of 255 P and P floats, whose byte counts
# are no multiple of 16 at odd P), and a grid of one short block (no
# block stages its dlog_pi)
UNFUSED_GRIDS = {"tail173": (37, 1001), "tail255": (3, 597),
                 "tail1": (1, 257), "short": (2, 50)}


@pytest.mark.parametrize("grid", sorted(UNFUSED_GRIDS))
@pytest.mark.parametrize("P", [13, 7, 2, 1, 16])
def test_unfused_kernels_match_plain(dev, P, grid):
    """enum_fwd (ll) and enum_bwd (dmu, dphi, dlog_pi) against their plain
    versions with a cells-major log_pi, on grids whose last block is
    short, at odd P
    (conflict-free shared-memory writes of the staged dlog_pi), even P
    (bank conflicts) and P = 1; each launch is counted once, the backward
    under its staged path where a full block exists, else under its
    per-thread path."""
    C, L = UNFUSED_GRIDS[grid]
    x = _inputs(C, L, P, seed=60 + P, dev=dev)
    _check_unfused(x, P, _log_pi(C, L, P, 60 + P, dev),
                   "staged" if C * L >= 256 else "per_thread")


def _check_unfused(x, P, log_pi, path):
    scal = ek.scalars(torch.tensor(0.75, dtype=torch.float32,
                                   device=log_pi.device))
    args = (x["reads"], x["mu"], log_pi, x["phi"], scal)
    _cuda.reset_launches()
    ll_k = ek.enum_fwd(*args)
    ll_p = ek.enum_fwd_plain(*args)
    got = ek.enum_bwd(*args, ll_p, x["g"])
    ref = ek.enum_bwd_plain(*args, ll_p, x["g"])
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["enum_fwd"] == 1
    assert _cuda.LAUNCHES[f"enum_bwd_{path}"] == 1
    assert sum(_cuda.LAUNCHES.values()) == 2
    assert got[2].shape == log_pi.shape
    assert all(bool(torch.isfinite(a).all()) for a in (ll_k, *got))
    errs = {"ll": _ll_err(ll_k, ll_p, x["reads"], scal.new_tensor(0.75))}
    errs.update({name: _rel(a, b) for name, a, b in
                 zip(("dmu", "dphi", "dlog_pi"), got, ref)})
    assert all(e <= TOL_ENUM[k] for k, e in errs.items()), errs


def test_unfused_backward_refuses_an_unaligned_dlog_pi(dev):
    """The C entry of enum_bwd refuses a dlog_pi whose base is not 16-B
    aligned (the bulk store's requirement) with cudaErrorInvalidValue and
    writes nothing; the wrapper's fresh buffer is always aligned."""
    n, P = 300, 13
    x = _inputs(1, n, P, seed=72, dev=dev)
    log_pi = _log_pi(1, n, P, 72, dev)
    scal = ek.scalars(torch.tensor(0.75, dtype=torch.float32, device=dev))
    ll = ek.enum_fwd_plain(x["reads"], x["mu"], log_pi, x["phi"], scal)
    dmu, dphi = torch.empty_like(ll), torch.empty_like(ll)
    buf = torch.full((n * P + 1,), float("nan"), device=dev)
    dlog_pi = buf[1:]
    assert dlog_pi.data_ptr() % 16 == 4
    lib = _cuda.library("enum_fused")
    rc = lib.scrt_enum_bwd(*(_cuda.ptr(t) for t in (
        x["reads"], x["mu"], x["phi"], log_pi, scal, ll, x["g"], dmu, dphi,
        dlog_pi)), n, P, _cuda.stream_of(ll))
    torch.cuda.synchronize()
    assert rc == 1  # cudaErrorInvalidValue
    assert bool(buf.isnan().all())


def test_unfused_autograd_on_cuda_matches_cpu(dev):
    """enum_loglik on the card (kernels) and on the CPU (plain versions)
    gives the same value and cotangents."""
    x = _inputs(8, 300, 13, seed=71, dev=dev)
    log_pi = _log_pi(8, 300, 13, 71, dev)
    lamb = torch.tensor(0.75, dtype=torch.float32)
    res = []
    for d in (dev, torch.device("cpu")):
        mu, lp, phi = (t.to(d).clone().requires_grad_(True)
                       for t in (x["mu"], log_pi, x["phi"]))
        out = ek.enum_loglik(x["reads"].to(d), mu, lp, phi, lamb.to(d))
        grads = torch.autograd.grad(out, (mu, phi, lp), x["g"].to(d))
        res.append([a.detach().cpu() for a in (out, *grads)])
    (ll_k, *got), (ll_p, *ref) = res
    errs = {"ll": _ll_err(ll_k, ll_p, x["reads"].cpu(), lamb)}
    errs.update({name: _rel(a, b) for name, a, b in
                 zip(("dmu", "dphi", "dlog_pi"), got, ref)})
    assert all(e <= TOL_ENUM[k] for k, e in errs.items()), errs


def _adam_scal(dev, step, live=True):
    """The (4,) [lr, bc1, bc2, live] device operand of one step at count
    ``step``."""
    return ak.adam_scalars(
        ak.adam_constants(0.05, 0.8, 0.99, dev),
        torch.tensor(step, dtype=torch.int32, device=dev),
        torch.tensor(live, device=dev))


@pytest.mark.parametrize("step", [1, 7, 300])
def test_adam_kernel_matches_plain(dev, step):
    """One sweep of the kernel against the plain version on a ragged
    (13, 37, 1001) parameter; lr and the bias corrections come from the
    device tensor of adam_scalars."""
    gen = torch.Generator(device=dev).manual_seed(step)
    shape = (13, 37, 1001)
    p, g = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
    m = 0.1 * torch.randn(shape, generator=gen, device=dev)
    v = 0.1 * torch.rand(shape, generator=gen, device=dev)
    scal = _adam_scal(dev, step)
    _cuda.reset_launches()
    got = ak.adam_update(p, g, m, v, scal, 0.8, 0.99)
    ref = ak.adam_update_plain(p, g, m, v, scal, 0.8, 0.99)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["adam"] == 1
    for name, a, b in zip(("param", "m", "v"), got, ref):
        assert _rel(a, b) <= TOL[name], (name, _rel(a, b))


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element distance of two bfloat16 tensors in bfloat16 ulps
    (steps between adjacent representable values; +0 and -0 one
    point)."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("step", [1, 7, 300])
def test_adam_bf16_kernel_matches_plain(dev, step):
    """One sweep with bfloat16 stored moments: param' within 1e-6 of the
    plain version, m' and v' within one bfloat16 ulp per element; one
    launch of the bf16 instance and none of the float32 one."""
    gen = torch.Generator(device=dev).manual_seed(100 + step)
    shape = (4, 37, 1001)
    f32 = dict(dtype=torch.float32, device=dev)
    p, g = (torch.randn(shape, generator=gen, **f32) for _ in range(2))
    m = (0.1 * torch.randn(shape, generator=gen, **f32)).to(torch.bfloat16)
    v = (0.1 * torch.rand(shape, generator=gen, **f32)).to(torch.bfloat16)
    scal = _adam_scal(dev, step)
    _cuda.reset_launches()
    got = ak.adam_update(p, g, m, v, scal, 0.8, 0.99, "bfloat16")
    ref = ak.adam_update_plain(p, g, m, v, scal, 0.8, 0.99)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["adam_bf16"] == 1 and _cuda.LAUNCHES["adam"] == 0
    assert got[1].dtype == got[2].dtype == torch.bfloat16
    assert _rel(got[0], ref[0]) <= TOL["param"]
    for name, a, b in zip(("m", "v"), got[1:], ref[1:]):
        assert int(bf16_ulps(a, b).max()) <= 1, name


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_adam_live_gate_kernel(dev, mdt):
    """The live gate on the card: live = 0 writes p, m and v through bit
    for bit (one launch), live = 1 equals the plain version bit for bit
    (the kernel repeats its roundings), for both moment dtypes."""
    gen = torch.Generator(device=dev).manual_seed(11)
    shape = (13 if mdt == "float32" else 4, 37, 1001)
    f32 = dict(dtype=torch.float32, device=dev)
    p, g = (torch.randn(shape, generator=gen, **f32) for _ in range(2))
    mt = ak.moment_torch_dtype(mdt)
    m = (0.1 * torch.randn(shape, generator=gen, **f32)).to(mt)
    v = (0.1 * torch.rand(shape, generator=gen, **f32)).to(mt)
    key = "adam" if mdt == "float32" else "adam_bf16"
    _cuda.reset_launches()
    off = ak.adam_update(p, g, m, v, _adam_scal(dev, 7, False), 0.8, 0.99,
                         mdt)
    on = ak.adam_update(p, g, m, v, _adam_scal(dev, 7), 0.8, 0.99, mdt)
    ref = ak.adam_update_plain(p, g, m, v, _adam_scal(dev, 7), 0.8, 0.99)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[key] == 2
    for a, b in zip(off, (p, m, v)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(on, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_chunk_stops_launching_once_the_card_reports_the_stop(dev):
    """On the card the fit loop peeks at the stop flags of finished
    iterations without waiting: a fit whose criterion fires at iteration
    14 of a 25-iteration chunk counts the iterations the CPU run counts,
    with the same losses, and launches fewer than the whole chunk (the
    masked ones already queued, not the rest)."""
    from scdna_replication_tools_tpu_torch.infer import svi

    def loss(p):
        return ((p["x"] - 3.0) ** 2).sum() + (p["y"] ** 2).sum()

    params = {"x": torch.zeros(64), "y": torch.ones(32)}
    kw = dict(max_iter=100, min_iter=12, rel_tol=0.52, learning_rate=0.1,
              diag_every=25)
    cpu = svi.fit_map(loss, params, device="cpu", **kw)
    gpu = svi.fit_map(loss, params, device=dev, **kw)
    assert cpu.converged and gpu.converged
    assert gpu.num_iters == cpu.num_iters < 25
    assert cpu.timings["dispatched"] == 25
    assert gpu.num_iters <= gpu.timings["dispatched"] < 25
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-6)


def test_library_loads_become_compile_events(dev, tmp_path):
    """Each kernel library a step loads is a ``compile`` event (its
    source, the build's hash, ``miss`` with the nvcc seconds or
    ``disk_hit`` with the load seconds when that call loaded it, ``hit``
    after), valid under the port's schema."""
    from scdna_replication_tools_tpu_torch.obs import runlog, schema

    path = tmp_path / "compile.jsonl"
    log = runlog.RunLog(str(path))
    with log.session(device=dev):
        for _ in range(2):
            for name in _cuda.SOURCES:
                log.emit("compile", **_cuda.load_event(name))
    assert schema.validate_run(path) == []
    events = [json.loads(line) for line in path.read_text().splitlines()]
    compiled = [e for e in events if e["event"] == "compile"]
    assert [e["label"] for e in compiled] \
        == list(_cuda.SOURCES.values()) * 2
    for e in compiled:
        assert e["key_hash"] in _cuda.BUILD_INFO[
            next(k for k, v in _cuda.SOURCES.items()
                 if v == e["label"])]["path"]
    for e in compiled[len(_cuda.SOURCES):]:
        assert e["cache"] == "hit"
    for e in compiled[:len(_cuda.SOURCES)]:
        if e["cache"] != "hit":
            assert ("compile_seconds" if e["cache"] == "miss"
                    else "deserialize_seconds") in e

# ---------------------------------------------------------------------------
# durable runs on the card (ROADMAP A8)
# ---------------------------------------------------------------------------


def _durable_inputs():
    """(s, g1, clone_idx) through the port's loader: two clones of 12 S
    and 12 G1 cells x 120 loci, reads Poisson around 40 x CN (the shape
    of tests/conftest.py's synthetic frames, made here without it)."""
    import pandas as pd

    from scdna_replication_tools_tpu_torch.config import ColumnConfig
    from scdna_replication_tools_tpu_torch.data.loader import (
        build_pert_inputs,
    )

    rng = np.random.default_rng(7)
    n = 120
    starts = (np.arange(n) * 500_000).astype(np.int64)
    gc = np.clip(0.45 + 0.08 * np.sin(np.arange(n) / 9.0)
                 + rng.normal(0, 0.02, n), 0.3, 0.65)
    cn = {"A": np.where((np.arange(n) >= 80) & (np.arange(n) < 100), 4, 2),
          "B": np.where((np.arange(n) >= 20) & (np.arange(n) < 50), 3, 2)}

    def frame(prefix):
        rows = [pd.DataFrame({
            "cell_id": f"{prefix}_{clone}_{i}", "chr": "1", "start": starts,
            "end": starts + 500_000, "gc": gc, "library_id": "LIB0",
            "clone_id": clone, "state": cn[clone],
            "reads": rng.poisson(40 * cn[clone]).astype(float)})
            for clone in ("A", "B") for i in range(12)]
        return pd.concat(rows, ignore_index=True)

    s, g1 = build_pert_inputs(frame("s"), frame("g"),
                              ColumnConfig(rt_prior_col=None))
    return s, g1, np.array([0] * 12 + [1] * 12, np.int32)


DURABLE = dict(cn_prior_method="g1_clones", rel_tol=0.0, run_step3=False,
               max_iter=75, min_iter=25, max_iter_step1=30,
               min_iter_step1=10, fit_diag_every=25,
               controller_max_extra_iters=25, mirror_rescue=False,
               telemetry_path=None)


def _run(dev, **kw):
    from scdna_replication_tools_tpu_torch.config import PertConfig
    from scdna_replication_tools_tpu_torch.infer.runner import PertInference

    s, g1, ci = _durable_inputs()
    inf = PertInference(s, g1, PertConfig(**{**DURABLE, **kw}),
                        clone_idx_s=ci, clone_idx_g1=ci, num_clones=2,
                        device=dev)
    return inf.run()


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_checkpoint_of_cuda_tensors_is_bit_exact(dev, tmp_path, mdt):
    """save_step of CUDA parameters and an Adam state (pi moments in
    ``mdt``), load_step and the restores onto the card: every tensor back
    bit for bit, in its dtype."""
    from scdna_replication_tools_tpu_torch.infer import checkpoint as ckpt
    from scdna_replication_tools_tpu_torch.infer.svi import AdamState

    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    params = {"tau_raw": randn(37), "u": randn(37),
              "pi_logits": randn(13, 37, 1001), "rho_raw": randn(1001)}
    mt = torch.bfloat16 if mdt == "bfloat16" else torch.float32
    state = AdamState(
        count=torch.tensor(11, dtype=torch.int32, device=dev),
        mu={k: (randn(*v.shape).to(mt) if k == "pi_logits" else
                randn(*v.shape)) for k, v in params.items()},
        nu={k: (randn(*v.shape).abs().to(mt) if k == "pi_logits" else
                randn(*v.shape).abs()) for k, v in params.items()})
    ckpt.save_step(str(tmp_path), "step2", params,
                   np.arange(5, dtype=np.float32), opt_state=state,
                   num_iters=5, converged=False)
    p, losses, extra = ckpt.load_step(str(tmp_path), "step2")
    assert str(extra["meta.opt_moment_dtype"]) == mdt
    assert extra["meta.topology"]["device_kind"] \
        == torch.cuda.get_device_name(dev)
    back = ckpt.restore_params(p, dev)
    got = ckpt.restore_opt_state(extra, p, dev)
    for k, v in params.items():
        assert back[k].device == v.device and torch.equal(back[k], v), k
    assert got.count.dtype == torch.int32 and torch.equal(got.count,
                                                          state.count)
    for name in ("mu", "nu"):
        for k, v in getattr(state, name).items():
            t = getattr(got, name)[k]
            assert t.device == v.device and t.dtype == v.dtype, (name, k)
            assert torch.equal(t, v), (name, k)


def test_compile_hang_raises_watchdog_timeout(dev, tmp_path):
    """A hang injected in a step's compile phase with a 1 s compile
    deadline raises WatchdogTimeout, audited as ``degrade
    watchdog_abort``."""
    import threading

    from scdna_replication_tools_tpu_torch.utils import faults

    log = tmp_path / "hang.jsonl"
    try:
        with pytest.raises(faults.WatchdogTimeout):
            _run(dev, faults="hang@compile#1:5", watchdog_compile_seconds=1,
                 checkpoint_dir=str(tmp_path / "ck"),
                 telemetry_path=str(log))
    finally:
        faults.install(None)
        # the abandoned compile thread ends its sleep and its loads
        for t in threading.enumerate():
            if t.name.startswith("pert-watchdog-"):
                t.join(30.0)
    events = [json.loads(line) for line in log.read_text().splitlines()]
    assert any(e["event"] == "fault_injected" and e["site"] == "compile"
               for e in events)
    assert any(e["event"] == "degrade" and e["action"] == "watchdog_abort"
               and e["error_class"] == "hang" for e in events)
    assert events[-1]["event"] == "run_end" \
        and events[-1]["status"] == "error"


def test_kill_and_resume_on_the_card_is_bit_exact(dev, tmp_path):
    """Preempted at step2/chunk#3 and resumed with resume='auto' on the
    card: losses and parameters of both steps bit-identical to the
    uninterrupted run on the card."""
    from scdna_replication_tools_tpu_torch.utils import faults

    g1, g2, _ = _run(dev)
    durable = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    try:
        with pytest.raises(faults.SimulatedPreemption):
            _run(dev, faults="preempt@step2/chunk#3", **durable)
    finally:
        faults.install(None)
    r1, r2, _ = _run(dev, **durable)
    for r, g in ((r1, g1), (r2, g2)):
        np.testing.assert_array_equal(r.fit.losses, g.fit.losses)
        for k, v in g.fit.params.items():
            assert torch.equal(r.fit.params[k], v), k
    assert [(d["action"], d["iter"]) for d in r2.fit.decisions] \
        == [(d["action"], d["iter"]) for d in g2.fit.decisions
            if d["iter"] > 50]


# -- CUDA graphs of the fit iteration (ROADMAP A14) --------------------------


def _same_steps(a, b):
    for x, y in zip(a, b):
        if x is None:
            assert y is None
            continue
        np.testing.assert_array_equal(x.fit.losses, y.fit.losses)
        assert [(d["action"], d["iter"]) for d in x.fit.decisions] == \
            [(d["action"], d["iter"]) for d in y.fit.decisions]
        for k, v in x.fit.params.items():
            assert torch.equal(y.fit.params[k], v), k


def test_graphed_run_equals_the_eager_run(dev, tmp_path):
    """Steps 1 and 2 under the controller with executable_cache_dir:
    losses, decisions and parameters bit-identical to the eager run on
    the card; each step captured its two forms once (``miss``) and
    replayed every dispatched iteration; the store holds nothing after
    the run."""
    from scdna_replication_tools_tpu_torch.infer import aotcache

    eager = _run(dev)
    graphed = _run(dev, executable_cache_dir=str(tmp_path / "store"))
    _same_steps(eager, graphed)
    for out in graphed[:2]:
        fit = out.fit
        assert [(e["label"], e["cache"]) for e in fit.programs] == \
            [("chunk:diag", "miss"), ("chunk:plain", "miss")]
        assert fit.timings["replays"] == fit.timings["dispatched"]
        assert fit.timings["captures"] == 2
    assert aotcache.live_program_count() == 0


@pytest.mark.parametrize("diag_every", [0, 25])
def test_graphed_chunks_equal_eager_chunks(dev, tmp_path, diag_every):
    """A step-2 fit of 40 iterations from the eager run's fitted state,
    its chunks replayed from graphs, equals the eager fit bit for bit
    (with the ring and without); each replay counts the graph's kernel
    launches, so the fused pair and Adam count once per replayed
    iteration (the warm-up iterations launch eagerly and count too)."""
    from scdna_replication_tools_tpu_torch.infer import aotcache, svi
    from scdna_replication_tools_tpu_torch.infer.runner import _PertLossFn

    _, step2, _ = _run(dev)
    kw = dict(max_iter=40, min_iter=40, device=dev, diag_every=diag_every)
    args = (step2.fixed, step2.batch)
    eager = svi.fit_map(_PertLossFn(step2.spec), step2.fit.params, args,
                        **kw)
    _cuda.reset_launches()
    with aotcache.run_scope(str(tmp_path / "store"), None) as scope:
        graphed = svi.fit_map(_PertLossFn(step2.spec), step2.fit.params,
                              args, **kw)
        again = svi.fit_map(_PertLossFn(step2.spec), step2.fit.params,
                            args, **kw)
        assert scope.store.program_count() == 1
    launches = dict(_cuda.LAUNCHES)
    for fit in (graphed, again):
        np.testing.assert_array_equal(fit.losses, eager.losses)
        for k, v in eager.params.items():
            assert torch.equal(fit.params[k], v), k
    assert [e["cache"] for e in again.programs] == \
        ["hit"] * len(graphed.programs)
    dispatched = graphed.timings["dispatched"] + again.timings["dispatched"]
    warm = graphed.timings["warmups"]
    key = "sparse" if step2.spec.sparse_etas else "dense"
    assert launches[f"fused_fwd_{key}"] == dispatched + warm
    assert launches["adam"] == dispatched + warm


def test_concurrent_graphed_fits_of_one_program_equal_eager(dev, tmp_path):
    """Four threads fit four starts of one objective at once, sharing the
    worker-style process-wide store: one program, its chunks taken one
    at a time (the program's lock, and an event orders each chunk after
    the last on the card), each fit bit-equal to its eager run."""
    import threading

    from scdna_replication_tools_tpu_torch.infer import aotcache, svi

    def loss(p):
        return ((p["x"] - 3.0) ** 2).sum() + (p["y"] ** 2 * p["x"][:8]
                                             .sum()).sum()

    gen = torch.Generator().manual_seed(3)
    starts = [{"x": torch.randn(4096, generator=gen),
               "y": torch.randn(512, generator=gen)} for _ in range(4)]
    kw = dict(max_iter=60, min_iter=60, learning_rate=0.01, device=dev,
              diag_every=5)
    eager = [svi.fit_map(loss, p, **kw) for p in starts]
    got = [None] * 4
    root = str(tmp_path / "store")
    store = aotcache.activate(root)
    try:
        def fit(k):
            with aotcache.run_scope(root, None):
                got[k] = svi.fit_map(loss, starts[k], **kw)
        threads = [threading.Thread(target=fit, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert store.program_count() == 1
    finally:
        aotcache.deactivate()
    for a, b in zip(eager, got):
        np.testing.assert_array_equal(a.losses, b.losses)
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k]), k


# -- the block axis: W stacked fits in one launch (the serving slab) -------


def _lanes(W, C, L, P, flat, dev):
    """W lanes of _inputs, each from its own seed, stacked; lambda
    differs per lane, so each lane's scalar row differs."""
    xs = [_inputs(C, L, P, 40 + b, dev, flat=flat) for b in range(W)]
    stacked = {k: torch.stack([x[k] for x in xs]) for k in xs[0]}
    lamb = torch.tensor([0.55 + 0.1 * b for b in range(W)],
                        dtype=torch.float32, device=dev)
    scal = torch.stack([ek.scalars(lamb[b]) for b in range(W)])
    return xs, stacked, scal


@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("flat", [False, True])
def test_block_axis_fused_kernels_equal_solo_launches(dev, W, sparse, flat):
    """One block-axis launch each way for W lanes at the ragged shape:
    every lane's out, lse, dmu, dphi and dpi equal a solo launch on that
    lane's operands bit for bit, and the batched plain versions within
    the solo bounds; one launch each of the lane kernels."""
    C, L, P = 37, 1001, 13
    xs, x, scal = _lanes(W, C, L, P, flat, dev)
    prior = dict(eta_idx=x["eidx"], eta_w=x["ew"]) if sparse \
        else dict(etas_t=x["etas_t"])
    args = (x["reads"], x["mu"], x["pi_t"], x["phi"], scal)
    key = "sparse" if sparse else "dense"
    _cuda.reset_launches()
    out_k, lse_k = ek.fused_fwd(*args, **prior)
    got = ek.fused_bwd(*args, lse_k, x["g"], **prior)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[f"fused_fwd_{key}_lanes"] == 1
    assert _cuda.LAUNCHES[f"fused_bwd_{key}_lanes"] == 1
    assert sum(_cuda.LAUNCHES.values()) == 2
    out_p, lse_p = ek.fused_fwd_plain_batched(*args, **prior)
    ref = ek.fused_bwd_plain_batched(*args, lse_p, x["g"], **prior)
    tol = TOL_FLAT if flat else TOL
    for b in range(W):
        lane_prior = {k: v[b] for k, v in prior.items()}
        lane = (x["reads"][b], x["mu"][b], x["pi_t"][b], x["phi"][b],
                scal[b])
        o, s = ek.fused_fwd(*lane, **lane_prior)
        d = ek.fused_bwd(*lane, s, x["g"][b], **lane_prior)
        for a, c in zip((out_k[b], lse_k[b]) + tuple(t[b] for t in got),
                        (o, s) + d):
            assert torch.equal(a, c), b
        weight = x["ew"][b] if sparse else x["etas_t"][b] - 1.0
        scale = {"out": max(_amax(lse_p[b]), _amax(out_p[b] - lse_p[b])),
                 "dpi": _amax(x["g"][b]) * _amax(weight)}
        pairs = [("out", out_k[b], out_p[b]), ("lse", lse_k[b], lse_p[b])] \
            + [(n, t[b], r[b]) for n, t, r in zip(("dmu", "dphi", "dpi"),
                                                   got, ref)]
        for name, a, c in pairs:
            assert _rel(a, c, scale.get(name, 0.0)) <= tol[name], (b, name)
        if flat:
            hk, hp = out_k[b] - lse_k[b], out_p[b] - lse_p[b]
            per_bin = float(((hk - hp).abs() / (1.0 + hp.abs())).max())
            assert per_bin <= tol["hoisted"], (b, per_bin)


@pytest.mark.parametrize("sparse", [False, True])
def test_vmap_of_the_fused_objective_launches_the_block_axis_pair(dev,
                                                                  sparse):
    """torch.func.vmap of the solo fused objective (the slab's batched
    loss) goes through the vmap rule to one launch of each lane kernel,
    and each lane's value and gradients equal the solo objective's."""
    W, C, L, P = 3, 37, 1001, 13
    xs, x, _ = _lanes(W, C, L, P, False, dev)
    lamb = torch.tensor([0.55, 0.65, 0.75], dtype=torch.float32, device=dev)

    def obj(mu, pi_t, phi, reads, prior, lam):
        if sparse:
            return ek.enum_loglik_fused_sparse(reads, mu, pi_t, phi,
                                               prior[0], prior[1], lam)
        return ek.enum_loglik_fused(reads, mu, pi_t, phi, prior[0], lam)

    prior = (x["eidx"], x["ew"]) if sparse else (x["etas_t"],)
    leaves = [t.clone().requires_grad_(True)
              for t in (x["mu"], x["pi_t"], x["phi"])]
    _cuda.reset_launches()
    out = torch.func.vmap(obj)(*leaves, x["reads"], prior, lamb)
    grads = torch.autograd.grad(out.sum(), leaves)
    torch.cuda.synchronize()
    key = "sparse" if sparse else "dense"
    assert _cuda.LAUNCHES[f"fused_fwd_{key}_lanes"] == 1
    assert _cuda.LAUNCHES[f"fused_bwd_{key}_lanes"] == 1
    assert sum(_cuda.LAUNCHES.values()) == 2
    for b in range(W):
        solo = [t[b].clone().requires_grad_(True) for t in leaves]
        o = obj(*solo, x["reads"][b], tuple(p[b] for p in prior), lamb[b])
        g = torch.autograd.grad(o.sum(), solo)
        assert torch.equal(out[b], o)
        for a, c in zip(grads, g):
            assert torch.equal(a[b], c)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_adam_lanes_kernel_equals_solo_launches(dev, W, mdt):
    """One lane-axis Adam launch for W lanes, each with its own step
    count and learning rate and lane 1 parked (live = 0): every lane
    equals a solo launch with its scalar row bit for bit (the parked one
    its operands), and the plain lane-axis version bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(W)
    shape = (W, 13 if mdt == "float32" else 4, 37, 1001)
    f32 = dict(dtype=torch.float32, device=dev)
    p, g = (torch.randn(shape, generator=gen, **f32) for _ in range(2))
    mt = ak.moment_torch_dtype(mdt)
    m = (0.1 * torch.randn(shape, generator=gen, **f32)).to(mt)
    v = (0.1 * torch.rand(shape, generator=gen, **f32)).to(mt)
    const = torch.tensor([[0.05 * (b + 1), 0.8, 0.99] for b in range(W)],
                         **f32)
    count = torch.tensor([3 + 5 * b for b in range(W)], dtype=torch.int32,
                         device=dev)
    live = torch.tensor([b != 1 for b in range(W)], device=dev)
    scal = ak.adam_scalars(const, count, live)
    key = "adam_lanes" if mdt == "float32" else "adam_bf16_lanes"
    _cuda.reset_launches()
    got = ak.adam_update(p, g, m, v, scal, 0.8, 0.99, mdt)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[key] == 1 and sum(_cuda.LAUNCHES.values()) == 1
    ref = ak.adam_update_plain(p, g, m, v, scal, 0.8, 0.99)
    for a, c in zip(got, ref):
        assert a.dtype == c.dtype and torch.equal(a, c)
    for b in range(W):
        solo = ak.adam_update(p[b], g[b], m[b], v[b], scal[b], 0.8, 0.99,
                              mdt)
        for a, c in zip(got, solo):
            assert torch.equal(a[b], c), b
        if b == 1:
            for a, c in zip(got, (p, m, v)):
                assert torch.equal(a[b], c[b])
    # in place (the slab's own stacked copies): the same values
    dst = [t.clone() for t in (p, m, v)]
    inplace = ak.adam_update(dst[0], g, dst[1], dst[2], scal, 0.8,
                                   0.99, mdt, in_place=True)
    for a, c, d in zip(inplace, got, dst):
        assert a is d and torch.equal(a, c)


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_adam_kernel_in_place_equals_new_outputs(dev, mdt):
    """The solo kernel stepping its operands in place (the fit loop's
    iterations after a chunk's first) gives the new-output launch's
    values bit for bit, live and parked."""
    gen = torch.Generator(device=dev).manual_seed(23)
    shape = (13 if mdt == "float32" else 4, 37, 1001)
    f32 = dict(dtype=torch.float32, device=dev)
    p, g = (torch.randn(shape, generator=gen, **f32) for _ in range(2))
    mt = ak.moment_torch_dtype(mdt)
    m = (0.1 * torch.randn(shape, generator=gen, **f32)).to(mt)
    v = (0.1 * torch.rand(shape, generator=gen, **f32)).to(mt)
    for live in (True, False):
        scal = _adam_scal(dev, 9, live)
        ref = ak.adam_update(p, g, m, v, scal, 0.8, 0.99, mdt)
        dst = [t.clone() for t in (p, m, v)]
        got = ak.adam_update(dst[0], g, dst[1], dst[2], scal, 0.8, 0.99,
                             mdt, in_place=True)
        torch.cuda.synchronize()
        for a, b, d in zip(got, ref, dst):
            assert a is d and torch.equal(a, b), live


def test_segment_library_matches_numpy_oracle(dev):
    """The host segment library builds on the card's machine and finds
    the NumPy search's breakpoints, row for row, 1 and 2 breakpoints,
    ragged rows and rows too short to split."""
    from scdna_replication_tools_tpu_torch.pipeline import segment
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(9, 160))
    Y[:, 40:90] += 2.0
    row_len = np.array([160, 160, 101, 37, 5, 4, 3, 2, 160])
    for n_bkps in (1, 2):
        got = segment.find_breakpoints_batch(Y, n_bkps, row_len=row_len)
        for i, n in enumerate(row_len):
            ref = segment.find_breakpoints(Y[i, :n], n_bkps)
            want = [-1, -1] if len(ref) == 1 else \
                (ref[:-1] + [-1] * (3 - len(ref)))
            assert list(got[i]) == want, (n_bkps, i, got[i], ref)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_chunked_objective_launches_each_chunk(dev, sparse):
    """``cell_chunk``: the fused pair launches once per chunk of cells,
    and the chunked loss and gradients equal the unchunked ones (the
    kernels' per-bin outputs are the same; only the sums' order
    differs)."""
    import dataclasses
    from scdna_replication_tools_tpu_torch.models import pert as tpert
    from scdna_replication_tools_tpu_torch.ops.gc import gc_features

    C, L, P, K, ch = 96, 700, 13, 4, 32
    rng = np.random.default_rng(3)
    cn = rng.integers(1, 6, (C, L)).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    fields = {}
    if sparse:
        fields = dict(eta_idx=torch.tensor(cn, **f32),
                      eta_w=torch.tensor(np.where(
                          rng.uniform(size=(C, L)) < 0.9, 1e6, 0.0), **f32))
    else:
        etas = np.ones((C, L, P), np.float32)
        np.put_along_axis(etas, cn.astype(np.int64)[..., None], 1e6, -1)
        fields = dict(etas=torch.tensor(etas, **f32))
    batch = tpert.PertBatch(
        reads=torch.tensor(rng.poisson(30 * cn), **f32),
        libs=torch.zeros(C, dtype=torch.int64, device=dev),
        gamma_feats=gc_features(torch.tensor(
            rng.uniform(0.35, 0.6, L), **f32), K),
        mask=torch.ones(C, **f32), **fields)
    fixed = dict(beta_means=torch.zeros((1, K + 1), **f32),
                 lamb=torch.tensor(0.7, **f32))
    spec = tpert.PertModelSpec(P=P, K=K, L=1, tau_mode="param",
                               cond_beta_means=True, fixed_lamb=True,
                               sparse_etas=sparse, cell_chunk=ch)
    params = tpert.init_params(spec, batch, fixed,
                               t_init=rng.uniform(0.1, 0.9, C))

    def run(s):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        _cuda.reset_launches()
        loss = tpert.pert_loss(s, p, fixed, batch)
        grads = torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        return loss, dict(zip(p, grads)), dict(_cuda.LAUNCHES)

    kind = "sparse" if sparse else "dense"
    l_ch, g_ch, n_ch = run(spec)
    l_wh, g_wh, n_wh = run(dataclasses.replace(spec, cell_chunk=None))
    assert n_ch[f"fused_fwd_{kind}"] == n_ch[f"fused_bwd_{kind}"] == C // ch
    assert n_wh[f"fused_fwd_{kind}"] == n_wh[f"fused_bwd_{kind}"] == 1
    norm = float(torch.sum(batch.cache["dir_norm"]))
    diff = float((l_ch - l_wh).detach())
    assert abs(diff) <= 1e-6 * (abs(norm) + abs(float(l_wh.detach())))
    for k in g_wh:
        scale = max(float(g_wh[k].abs().max()), 1e-30)
        assert float((g_ch[k] - g_wh[k]).abs().max()) <= 1e-5 * scale, k


def test_gmm2_on_the_card_equals_the_cpu(dev):
    """The cell-cycle features' 2-GMM (``gmm2_em`` and
    ``gmm2_log_likelihood``) on the card against the CPU on the same
    float32 rows: the per-cell log-likelihood within 1e-5 of max(1, |ll|)
    (the bound tests/test_torch_ccc_features.py and chip_smoke.py hold
    lrs to), the mixtures' means within 1e-4 relative."""
    from scdna_replication_tools_tpu_torch.ops import stats

    rng = np.random.default_rng(0)
    x = np.where(rng.random((257, 5451)) < rng.uniform(0.1, 0.9, (257, 1)),
                 rng.normal(0.85, 0.08, (257, 5451)),
                 rng.normal(1.25, 0.12, (257, 5451))).astype(np.float32)
    out = {}
    for d in (torch.device("cpu"), dev):
        t = torch.as_tensor(x, device=d)
        mu, var, w = stats.gmm2_em(t)
        ll = stats.gmm2_log_likelihood(t, mu, var, w)
        out[d.type] = [a.cpu().numpy() for a in (mu, var, w, ll)]
    ll_cpu, ll_card = out["cpu"][3], out["cuda"][3]
    err = np.abs(ll_card - ll_cpu) / np.maximum(1.0, np.abs(ll_cpu))
    assert float(err.max()) <= 1e-5, float(err.max())
    mu_cpu, mu_card = np.sort(out["cpu"][0], 1), np.sort(out["cuda"][0], 1)
    np.testing.assert_allclose(mu_card, mu_cpu, rtol=1e-4)


def test_pivot_library_on_the_cards_host(dev):
    """The loader's pivot library builds with the card machine's host
    compiler and scatters and gathers bit for bit as NumPy does, on the
    threaded path."""
    from scdna_replication_tools_tpu_torch.native import pivot

    rng = np.random.default_rng(1)
    n_cells, n_loci = 1000, 5451
    keep = rng.random((n_cells, n_loci)) < 0.9
    cc, lc = (a.astype(np.int32) for a in np.nonzero(keep))
    order = rng.permutation(len(cc))
    cc, lc = cc[order], lc[order]
    vals = rng.poisson(40, len(cc)).astype(np.float64)
    got = pivot.scatter_pivot(cc, lc, vals, n_cells, n_loci)
    want = pivot.scatter_pivot(cc, lc, vals, n_cells, n_loci,
                               use_native=False)
    assert got.tobytes() == want.tobytes()
    assert np.isnan(got).sum() == (~keep).sum()
    filled = np.nan_to_num(got)
    assert pivot.gather_melt(filled, cc, lc).tobytes() == \
        pivot.gather_melt(filled, cc, lc, use_native=False).tobytes()
    assert _cuda.BUILD_INFO["pivot"]["path"].endswith(".so")
