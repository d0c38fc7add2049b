"""Parity of the port's Adam update with the JAX fused-Adam paths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.ops import adam_kernel as jak
from scdna_replication_tools_tpu_torch.ops import adam_kernel as tak

from test_torch_gpu import bf16_ulps
from test_torch_model import one_torch_thread  # noqa: F401


def _scal(lr, b1, b2, step, live=True):
    """The (4,) [lr, bc1, bc2, live] operand of one step at count
    ``step``."""
    return tak.adam_scalars(tak.adam_constants(lr, b1, b2, "cpu"),
                            torch.tensor(step, dtype=torch.int32),
                            torch.tensor(live))


def _state(shape, seed, step):
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 1, shape).astype(np.float32)
    g = rng.normal(0, 1, shape).astype(np.float32)
    m = rng.normal(0, 0.1, shape).astype(np.float32) if step > 1 \
        else np.zeros(shape, np.float32)
    v = rng.uniform(0, 0.1, shape).astype(np.float32) if step > 1 \
        else np.zeros(shape, np.float32)
    return p, g, m, v


@pytest.mark.parametrize("step", [1, 7, 300])
@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
def test_adam_plain_matches_jax(step, jax_impl):
    """(param', m', v') of one sweep at a (13, 16, 300) pi-shaped
    parameter (ragged against the TPU tile).  Same operations in optax
    order on both sides; they differ only where XLA and PyTorch round
    the bias corrections' float32 power b^t: 1e-6 relative."""
    lr, b1, b2 = 0.05, 0.8, 0.99
    p, g, m, v = _state((13, 16, 300), seed=step, step=step)
    count = jnp.asarray(step, jnp.int32)
    if jax_impl == "xla":
        ref = jak.adam_update_xla(*map(jnp.asarray, (p, g, m, v)), lr, b1,
                                  b2, count)
    else:
        ref = jak.adam_update_pallas(*map(jnp.asarray, (p, g, m, v)), lr,
                                     b1, b2, count, interpret=True)
    scal = _scal(lr, b1, b2, step)
    got = tak.adam_update(*map(torch.from_numpy, (p, g, m, v)), scal, b1, b2)
    for name, a, b in zip(("param", "m", "v"), got, ref):
        b = np.asarray(b)
        rel = np.max(np.abs(a.numpy() - b)) / np.max(np.abs(b))
        assert rel < 1e-6, (name, float(rel))


def _jax_bf16(x) -> torch.Tensor:
    """A JAX bfloat16 array as a torch bfloat16 tensor (exact: the value
    widens to float32 and narrows back)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("step", [1, 7, 300])
@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
def test_adam_bf16_moments_match_jax(step, jax_impl):
    """bfloat16 stored moments, float32 arithmetic: (param', m', v') of
    one sweep against adam_update_xla / the interpreted Pallas kernel
    with moment_dtype='bfloat16'.  m' and v' within one bfloat16 ulp per
    element (the two sides' float32 moments can differ by a rounding,
    which tips a round-to-nearest-even at a boundary); readings: 0 or 1
    element apart by one ulp over the six cases.  param' within 1e-6
    relative (readings up to 5.8e-8): it uses this step's float32
    moments on both sides."""
    lr, b1, b2 = 0.05, 0.8, 0.99
    p, g, m, v = _state((13, 16, 300), seed=step, step=step)
    m16 = jnp.asarray(m, jnp.bfloat16)
    v16 = jnp.asarray(v, jnp.bfloat16)
    count = jnp.asarray(step, jnp.int32)
    args = (jnp.asarray(p), jnp.asarray(g), m16, v16, lr, b1, b2, count)
    if jax_impl == "xla":
        ref = jak.adam_update_xla(*args, moment_dtype="bfloat16")
    else:
        ref = jak.adam_update_pallas(*args, moment_dtype="bfloat16",
                                     interpret=True)
    scal = _scal(lr, b1, b2, step)
    got = tak.adam_update(torch.from_numpy(p), torch.from_numpy(g),
                          _jax_bf16(m16), _jax_bf16(v16), scal, b1, b2,
                          "bfloat16")
    assert got[0].dtype == torch.float32
    assert got[1].dtype == got[2].dtype == torch.bfloat16
    ref_p = np.asarray(ref[0])
    rel = np.max(np.abs(got[0].numpy() - ref_p)) / np.max(np.abs(ref_p))
    assert rel < 1e-6, ("param", float(rel))
    for name, a, b in zip(("m", "v"), got[1:], ref[1:]):
        ulps = bf16_ulps(a, _jax_bf16(b))
        assert int(ulps.max()) <= 1, (name, int(ulps.max()),
                                      int((ulps > 0).sum()))


def test_adam_refuses_mixed_moment_dtypes():
    """m and v share the dtype the caller names: a bfloat16 pair under
    'float32', a float32 pair under 'bfloat16' or a mixed pair is
    refused on the CPU as the kernel would refuse it."""
    p = torch.zeros(2, 3, 5, dtype=torch.float32)
    h = p.to(torch.bfloat16)
    scal = _scal(0.05, 0.8, 0.99, 1)
    for m, v, mdt in ((h, h, "float32"), (p, p, "bfloat16"),
                      (h, p, "bfloat16")):
        with pytest.raises(ValueError, match="dtype"):
            tak.adam_update(p, p, m, v, scal, 0.8, 0.99, mdt)
    with pytest.raises(ValueError, match="optimizer_state_dtype"):
        tak.adam_update(p, p, p, p, scal, 0.8, 0.99, "float16")


def test_adam_scalars_are_optax_bias_corrections():
    """[lr, 1 - b1^t, 1 - b2^t, live] at the incremented count, float32,
    from the per-fit constants [lr, b1, b2]."""
    const = tak.adam_constants(0.05, 0.8, 0.99, "cpu")
    assert const.dtype == torch.float32 and const.shape == (3,)
    scal = tak.adam_scalars(const, torch.tensor(3, dtype=torch.int32),
                            torch.tensor(True))
    bc1, bc2 = jak._bias_corrections(jnp.asarray(3, jnp.int32), 0.8, 0.99)
    np.testing.assert_allclose(scal.numpy(),
                               [0.05, float(bc1), float(bc2), 1.0],
                               rtol=1e-6)
    assert scal.dtype == torch.float32 and scal.shape == (4,)


def test_adam_zero_padding_gives_zero_update():
    """g = m = v = 0 leaves the parameter exactly unchanged (the
    property the TPU kernel's zero padding relies on)."""
    p = torch.randn(2, 3, 5, dtype=torch.float32)
    z = torch.zeros_like(p)
    scal = _scal(0.05, 0.8, 0.99, 1)
    p2, m2, v2 = tak.adam_update(p, z, z, z, scal, 0.8, 0.99)
    assert torch.equal(p2, p) and not m2.any() and not v2.any()


def test_adam_refuses_devices_without_a_path():
    p = torch.zeros(2, 3, 5, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tak.adam_update(p, p, p, p, torch.zeros(4, device="meta"), 0.8, 0.99)


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_adam_live_gate_writes_through(mdt):
    """live = 0 returns param, m and v bit for bit (the masked iterations
    of a chunk after the fit stopped); live = 1 is the ungated sweep."""
    p, g, m, v = (torch.from_numpy(x) for x in _state((3, 8, 50), 5, 7))
    m, v = m.to(tak.moment_torch_dtype(mdt)), v.to(tak.moment_torch_dtype(mdt))
    off = tak.adam_update(p, g, m, v, _scal(0.05, 0.8, 0.99, 7, False),
                          0.8, 0.99, mdt)
    for a, b in zip(off, (p, m, v)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    on = tak.adam_update(p, g, m, v, _scal(0.05, 0.8, 0.99, 7), 0.8, 0.99,
                         mdt)
    assert not torch.equal(on[0], p)
    # the masked sweep leaves even a zero step count's bias corrections
    # (0 / 0 in the ungated arithmetic) out of the result
    zero = tak.adam_update(p, g, m, v, _scal(0.05, 0.8, 0.99, 0, False),
                           0.8, 0.99, mdt)
    assert all(torch.equal(a, b) for a, b in zip(zero, (p, m, v)))
