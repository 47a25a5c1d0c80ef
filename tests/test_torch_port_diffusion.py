"""The PyTorch port's forward-process math, losses, timestep samplers,
whitening weights and the two kernels' plain backwards, against the JAX
package on the same inputs (made from a seed with numpy).

Tolerances: the diffusion functions and the whitening weights are the same
f32 arithmetic, within 1e-6 relative; the samplers draw from other
generators, so they are checked by their ranges and strata; the plain
backwards are held against ``jax.vjp`` of the JAX oracles at rtol 2e-4 /
atol 2e-5 (f32, summation order) and against ``torch.autograd`` of the
port's plain forwards at rtol 1e-5 / atol 1e-6.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops import diffusion as jd
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops import whiten as jw
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops.pallas import attention as jattn
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops.pallas import fused as jfused
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops.schedules import make_schedule as jmake
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import diffusion as td
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import whiten as tw
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import make_schedule as tmake

k1 = importlib.import_module(
    "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels.conv_gn_silu")
k2 = importlib.import_module(
    "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels.flash_attention")

T = 1000
JS, TS = jmake(T, "cosine"), tmake(T, "cosine")


def _inputs(seed=0, B=3, L=50):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, 1, L)).astype(np.float32)
    eps = rng.standard_normal((B, 1, L)).astype(np.float32)
    t = rng.integers(0, T, B).astype(np.int32)
    mask = (rng.uniform(size=(B, 1, L)) > 0.2).astype(np.float32)
    return x0, eps, t, mask


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", ["q_sample_with_eps", "eps_to_x0",
                                  "x0_to_eps", "v_target"])
def test_forward_process_matches_jax(name):
    x, y, t, _ = _inputs()
    t[0] = T - 1                         # abar near 0: the clamps matter
    args = (x, t, y) if name == "q_sample_with_eps" else (x, y, t)
    want = getattr(jd, name)(JS, *(jnp.asarray(a) for a in args))
    got = getattr(td, name)(TS, *(torch.from_numpy(a) for a in args))
    _close(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_v_to_x0_eps_matches_jax():
    x_t, v, t, _ = _inputs(1)
    want = jd.v_to_x0_eps(JS, jnp.asarray(x_t), jnp.asarray(v), jnp.asarray(t))
    got = td.v_to_x0_eps(TS, torch.from_numpy(x_t), torch.from_numpy(v),
                         torch.from_numpy(t))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_q_sample_draws_from_the_generator():
    x0, _, t, _ = _inputs(2)
    g = torch.Generator().manual_seed(5)
    x_t, eps = td.q_sample(TS, torch.from_numpy(x0), torch.from_numpy(t), g)
    _close(x_t.numpy(), td.q_sample_with_eps(
        TS, torch.from_numpy(x0), torch.from_numpy(t), eps).numpy(), 0, 0)
    again = td.q_sample(TS, torch.from_numpy(x0), torch.from_numpy(t),
                        torch.Generator().manual_seed(5))[1]
    assert torch.equal(eps, again) and eps.dtype == torch.float32


@pytest.mark.parametrize("loss_type", ["huber", "mse"])
@pytest.mark.parametrize("power", [0.0, 1.5])
def test_masked_loss_matches_jax(loss_type, power):
    x0, eps, t, mask = _inputs(3)
    want = jd.masked_loss(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(mask),
                          jnp.asarray(t), JS, loss_type, 0.5, power)
    got = td.masked_loss(torch.from_numpy(x0), torch.from_numpy(eps),
                         torch.from_numpy(mask), torch.from_numpy(t), TS,
                         loss_type, 0.5, power)
    _close(got.numpy(), want)
    el = td.element_loss(torch.from_numpy(x0), torch.from_numpy(eps),
                         torch.from_numpy(mask), loss_type, 0.3)
    _close(el.numpy(), jd.element_loss(jnp.asarray(x0), jnp.asarray(eps),
                                       jnp.asarray(mask), loss_type, 0.3))


def test_element_loss_rejects_unknown_type():
    z = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="unknown loss type"):
        td.element_loss(z, z, z, "l1")


def test_uniform_sampler_covers_its_range():
    g = torch.Generator().manual_seed(0)
    t = td.sample_timesteps_uniform(g, 4000, 100, 199)
    assert t.dtype == torch.int64 and t.shape == (4000,)
    assert int(t.min()) == 100 and int(t.max()) == 199


@pytest.mark.parametrize("bsz,bins", [(16, 0), (16, 4), (10, 3), (5, 8)])
def test_stratified_sampler_fills_each_stratum(bsz, bins):
    """Each of JAX's strata (its float32 edges) holds its share of the
    batch, in both packages."""
    t_min, t_max = 200, 999
    g = torch.Generator().manual_seed(1)
    got = td.sample_timesteps_stratified(g, bsz, t_min, t_max, bins).numpy()
    want = np.asarray(jd.sample_timesteps_stratified(
        jax.random.PRNGKey(1), bsz, t_min, t_max, bins))
    b = max(1, min(bins if bins > 0 else bsz, bsz))
    edges = np.asarray(jnp.linspace(t_min, t_max + 1, b + 1).astype(jnp.int32))
    q, r = divmod(bsz, b)
    counts = [q + 1 if i < r else q for i in range(b)]
    for ts in (got, want):
        assert len(ts) == bsz and ts.min() >= t_min and ts.max() <= t_max
        for i in range(b):
            hi = max(edges[i + 1] - 1, edges[i])
            assert ((ts >= edges[i]) & (ts <= hi)).sum() >= counts[i]


def test_repeat_for_t_multi_matches_jax():
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((3, 2)).astype(np.float32),
            "b": np.float32(2.0)}
    want = jd.repeat_for_t_multi({k: jnp.asarray(v) for k, v in tree.items()}, 3)
    got = td.repeat_for_t_multi({"a": torch.from_numpy(tree["a"]),
                                 "b": torch.tensor(2.0)}, 3)
    _close(got["a"].numpy(), want["a"], 0, 0)
    assert float(got["b"]) == float(want["b"])
    assert td.repeat_for_t_multi(tree, 1) is tree


def test_whiten_weight_matches_jax():
    rng = np.random.default_rng(5)
    P = rng.uniform(0, 1, (3, 40)).astype(np.float32) ** 6
    P[:, :5] = 0.0                     # out of band
    P[1] = 0.0                         # no positive bin at all
    _close(tw.psd_floor(torch.from_numpy(P)).numpy(), jw.psd_floor(P))
    _close(tw.whiten_weight(torch.from_numpy(P)).numpy(), jw.whiten_weight(P),
           rtol=1e-6, atol=0)


# -- the kernels' plain backwards ----------------------------------------

def _k1_inputs(seed, B=2, L=37, Cin=9, Cout=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, Cin)).astype(np.float32)
    W = (rng.standard_normal((3, Cin, Cout)) / np.sqrt(3 * Cin)).astype(np.float32)
    b, s, bb = (0.1 * rng.standard_normal(Cout).astype(np.float32)
                for _ in range(3))
    dout = rng.standard_normal((B, L, Cout)).astype(np.float32)
    return x, W, b, s + 1.0, bb, dout


@pytest.mark.parametrize("shape", [(2, 37, 9, 12, 4), (1, 1, 8, 16, 8),
                                   (3, 64, 16, 9, 3)])
def test_conv_gn_silu_backward_matches_jax_grad(shape):
    B, L, Cin, Cout, G = shape
    x, W, b, s, bb, dout = _k1_inputs(B + L, B, L, Cin, Cout)
    _, vjp = jax.vjp(lambda *a: jfused.fused_conv_gn_silu_reference(*a, G),
                     *(jnp.asarray(a) for a in (x, W, b, s, bb)))
    want = vjp(jnp.asarray(dout))
    got = k1.fused_conv_gn_silu_backward(
        *(torch.from_numpy(a) for a in (dout, x, W, b, s, bb)), G)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)


def test_conv_gn_silu_backward_matches_autograd():
    x, W, b, s, bb, dout = (torch.from_numpy(a) for a in _k1_inputs(7))
    ins = [a.clone().requires_grad_() for a in (x, W, b, s, bb)]
    want = torch.autograd.grad(k1.fused_conv_gn_silu_reference(*ins, 4),
                               ins, dout)
    got = k1.fused_conv_gn_silu_backward(dout, x, W, b, s, bb, 4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows", [None, 7])
def test_flash_attention_backward_matches_jax_grad(rows, monkeypatch):
    """Whole and in blocks of 7 query rows (the last one ragged)."""
    if rows is not None:
        monkeypatch.setattr(k2, "BACKWARD_BLOCK_ELEMS", 2 * 3 * 50 * rows)
    rng = np.random.default_rng(8)
    q, k, v, dout = (rng.standard_normal((2, 3, 50, 16)).astype(np.float32)
                     for _ in range(4))
    out, vjp = jax.vjp(jattn.flash_attention_reference,
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    got = k2.flash_attention_backward(
        *(torch.from_numpy(a) for a in (dout, q, k, v)),
        torch.from_numpy(np.array(out)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = k2.flash_attention_reference(*ins)
    auto = torch.autograd.grad(o, ins, torch.from_numpy(dout))
    for g, w in zip(got, auto):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
