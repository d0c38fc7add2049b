"""Parity of the port's Adam update with the JAX fused-Adam paths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.ops import adam_kernel as jak
from scdna_replication_tools_tpu_torch.ops import adam_kernel as tak

from test_torch_model import one_torch_thread  # noqa: F401


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
    scal = tak.adam_scalars(lr, torch.tensor(step, dtype=torch.int32),
                            b1, b2)
    got = tak.adam_update(*map(torch.from_numpy, (p, g, m, v)), scal, b1, b2)
    for name, a, b in zip(("param", "m", "v"), got, ref):
        b = np.asarray(b)
        rel = np.max(np.abs(a.numpy() - b)) / np.max(np.abs(b))
        assert rel < 1e-6, (name, float(rel))


def test_adam_scalars_are_optax_bias_corrections():
    """[lr, 1 - b1^t, 1 - b2^t] at the incremented count, float32."""
    scal = tak.adam_scalars(0.05, torch.tensor(3, dtype=torch.int32),
                            0.8, 0.99)
    bc1, bc2 = jak._bias_corrections(jnp.asarray(3, jnp.int32), 0.8, 0.99)
    np.testing.assert_allclose(scal.numpy(),
                               [0.05, float(bc1), float(bc2)], rtol=1e-6)
    assert scal.dtype == torch.float32 and scal.shape == (3,)


def test_adam_zero_padding_gives_zero_update():
    """g = m = v = 0 leaves the parameter exactly unchanged (the
    property the TPU kernel's zero padding relies on)."""
    p = torch.randn(2, 3, 5, dtype=torch.float32)
    z = torch.zeros_like(p)
    scal = tak.adam_scalars(0.05, torch.tensor(1, dtype=torch.int32),
                            0.8, 0.99)
    p2, m2, v2 = tak.adam_update(p, z, z, z, scal, 0.8, 0.99)
    assert torch.equal(p2, p) and not m2.any() and not v2.any()


def test_adam_refuses_devices_without_a_path():
    p = torch.zeros(2, 3, 5, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tak.adam_update(p, p, p, p, torch.zeros(3, device="meta"), 0.8, 0.99)
