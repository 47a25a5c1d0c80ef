"""The PyTorch port's UNet1D against the JAX package's, with the same
weights (``params_from_flax``) and inputs, in float32 on the CPU."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu.models import unet as jax_unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import (
    params_from_flax,
)

# float32 module parity bar of the port (ROADMAP): max-abs error normalised
# by the reference's max-abs
REL_TOL = 1e-4

SMALL = dict(in_ch=7, base_ch=16, time_dim=32, depth=2, cond_in_ch=5,
             use_selfcond=True)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def randomize(params, seed=0):
    """Every leaf drawn from a seeded numpy generator (the flax init leaves
    the final conv and all biases at zero, which would make parity
    trivial): kernels ~ N(0, 1/fan_in), GN scales ~ 1 + N(0, 0.1^2),
    biases ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        shape, name = np.shape(v), path[-1].key
        if name == "kernel":
            z = rng.standard_normal(shape) / math.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            z = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            z = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(z, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def model_pair(L=256, seed=0, **kw):
    """(JAX model, its params, the port's model with the same weights)."""
    jm = jax_unet.UNet1D(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, kw["in_ch"], L)),
                              jnp.zeros((1,), jnp.int32))
    params = randomize(params, seed)
    tm = unet.UNet1D(**kw, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("kw,L", [
    (SMALL, 256),                                              # cond+meta+selfcond
    (dict(in_ch=3, base_ch=16, time_dim=32, depth=2), 256),    # legacy in_ch=3
    (dict(in_ch=1, base_ch=16, time_dim=32, depth=2), 256),    # unconditional
    (dict(SMALL, time_dim=33), 333),   # odd L: _fix_len, general resize; odd time_dim
])
def test_unet_matches_jax(kw, L):
    jm, params, tm = model_pair(L, **kw)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, kw["in_ch"], L)).astype(np.float32)
    t = np.array([3, 811], np.int32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == want.shape == (2, 1, L)
    assert rel_err(got, want) <= REL_TOL


def test_layout_rule_matches_jax():
    for kw in (dict(in_ch=3), dict(in_ch=1), dict(in_ch=7, cond_in_ch=5),
               dict(in_ch=6, use_selfcond=False), dict(in_ch=2)):
        want = jax_unet.UNet1D(**kw)._layout()
        assert unet.UNet1D(**kw, base_ch=8, depth=1, device="cpu")._layout() == want


@pytest.mark.parametrize("L,new_len", [(256, 128), (256, 64), (333, 166),
                                       (90, 30), (64, 100)])
def test_resize_linear_matches_jax_and_interpolate(L, new_len):
    x = np.random.default_rng(2).standard_normal((2, L, 3)).astype(np.float32)
    got = unet._resize_linear(torch.from_numpy(x), new_len)
    want = np.asarray(jax_unet._resize_linear(jnp.asarray(x), new_len))
    interp = torch.nn.functional.interpolate(
        torch.from_numpy(x).transpose(1, 2), size=new_len, mode="linear",
        align_corners=False).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), interp.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_bf16_model_runs_in_bf16_and_returns_f32():
    _, _, tm = model_pair(128, **SMALL)
    tb = unet.UNet1D(**SMALL, dtype=torch.bfloat16, device="cpu")
    tb.load_state_dict(tm.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 7, 128)).astype(np.float32))
    t = torch.tensor([5, 500])
    with torch.no_grad():
        out32, out16 = tm(x, t), tb(x, t)
    assert out16.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tb.parameters())
    # bf16 activations through five blocks: about two bf16 ulps (2^-8) of
    # relative error; these inputs give 7.7e-3 on the CPU, so 0.02 leaves a
    # factor 2.6 and still fails a bf16 path that is off by more than that
    assert rel_err(out16, out32) < 0.02
