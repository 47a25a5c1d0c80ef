"""The attention path of the PyTorch port against the JAX package on the CPU:
flash attention's plain version against the Pallas kernel (interpret mode)
and its XLA reference, ``BottleneckAttention``, the attention ``UNet1D`` and
the serving function of an attention model, with the same weights
(``params_from_flax``) and inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu import serving as jsrv
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.models import unet as jax_unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops import schedules as jsch
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops.pallas.attention import (
    flash_attention as jax_flash_attention,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops.pallas.attention import (
    flash_attention_reference as jax_flash_attention_reference,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import serving as tsrv
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import sampling as tsp
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import schedules as tsch
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
    _build,
    flash_attention,
    flash_attention_reference,
    launch_counts,
    reset_launch_counts,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import (
    params_from_flax,
)
from test_torch_port_unet import REL_TOL, SMALL, model_pair, randomize, rel_err

# the kernel bar of the JAX package's own Pallas tests: f32, the same
# function, summed in another order
KERNEL_TOL = dict(rtol=2e-4, atol=2e-5)


def _qkv(B, H, L, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, D)).astype(np.float32)
            for _ in range(3)]


# the JAX package's kernel-test shapes (tests/test_pallas_kernels.py:13)
@pytest.mark.parametrize("L,D,blk", [(256, 64, 128), (512, 32, 256)])
def test_reference_matches_pallas_kernel(L, D, blk):
    q, k, v = _qkv(2, 2, L, D)
    want = np.asarray(jax_flash_attention(q, k, v, blk_q=blk, blk_k=blk,
                                          interpret=True))
    got = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


@pytest.mark.parametrize("B,H,L,D", [(2, 2, 256, 64), (1, 3, 300, 32),
                                     (2, 1, 77, 65), (1, 4, 128, 16)])
def test_reference_matches_jax_reference_f32(B, H, L, D):
    """Including a ragged L (300, 77), which the Pallas kernel rejects and
    the port's kernel takes, and an odd head dimension."""
    q, k, v = _qkv(B, H, L, D, seed=L)
    want = np.asarray(jax_flash_attention_reference(q, k, v))
    got = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


@pytest.mark.parametrize("L", [256, 300])
def test_reference_matches_jax_reference_bf16(L):
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv(2, 2, L, 32, seed=5))
    want = np.asarray(jax_flash_attention_reference(q, k, v), np.float32)
    got = flash_attention_reference(*(
        torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    # both round the same f32 probabilities to bf16 and round the f32-summed
    # p @ v to bf16; summation order may flip an output (or a probability)
    # by one bf16 ulp, 2^-8 relative, so two ulps plus a small floor
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_runs_plain_version(dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(1, 2, 130, 24))
    before = launch_counts()["flash_attention"]
    out = flash_attention(q, k, v)
    assert out.dtype == dtype and out.shape == (1, 2, 130, 24)
    # the same function on the same tensors: bit-identical
    assert torch.equal(out, flash_attention_reference(q, k, v))
    assert launch_counts()["flash_attention"] == before   # no kernel launched


def test_wrapper_refuses_other_devices():
    q = torch.empty((1, 1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(q, q, q)


def test_launch_counts_cover_every_wrapper():
    flash_attention.launches = 3
    assert set(launch_counts()) == {"conv_gn_silu", "flash_attention",
                                    "conv_gn_silu_backward",
                                    "flash_attention_backward",
                                    "conv_gn_silu_epilogue"}
    reset_launch_counts()
    assert launch_counts() == {"conv_gn_silu": 0, "flash_attention": 0,
                               "conv_gn_silu_backward": 0,
                               "flash_attention_backward": 0,
                               "conv_gn_silu_epilogue": 0}


def test_build_all_starts_one_nvcc_per_unbuilt_source(tmp_path, monkeypatch):
    """A stand-in compiler that writes its ``-o`` target: every source not
    yet built is compiled by its own process, a built one is skipped, and a
    failing build raises with its output."""
    assert {p.stem for p in _build.CSRC.glob("*.cu")} >= {
        "conv_gn_silu", "flash_attention", "conv_gn_silu_backward",
        "flash_attention_backward"}
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a", "b", "c"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'case "$3" in *bad*) echo broken; exit 2;; esac\n'
                    'echo "pid $$"; echo built > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    build.mkdir()
    _build.library_path("c").write_text("built before")
    reports = _build.build_all()
    assert sorted(reports) == ["a", "b"]
    assert len({r for r in reports.values()}) == 2    # two processes
    for name in ("a", "b"):
        assert _build.library_path(name).read_text() == "built\n"
    assert _build.build_all() == {}
    (csrc / "bad.cu").write_text("// bad\n")
    with pytest.raises(RuntimeError, match=r"bad \(nvcc exit 2\)") as err:
        _build.build_all()
    assert "broken" in str(err.value)


@pytest.mark.parametrize("C,heads", [(16, 1), (64, 2), (256, 4), (130, 2)])
def test_bottleneck_attention_matches_jax(C, heads):
    """Each branch of the head-count rule: C < 32 (one head); C // 32 = 2;
    the cap of 4; and C 130 (base_ch 65 at depth 2), where 4 -> 3 -> 2."""
    L = 48
    x = np.random.default_rng(C).standard_normal((2, L, C)).astype(np.float32)
    jm = jax_unet.BottleneckAttention(num_heads=4)
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, L, C))), seed=C)
    tm = unet.BottleneckAttention(C, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)), strict=True)
    assert tm.heads == heads
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    # the residual dominates the output: hold the attention branch alone
    assert rel_err(got - torch.from_numpy(x), want - x) <= REL_TOL


def test_bottleneck_attention_projection_starts_at_zero():
    """Zero-initialised projection: a fresh block is the identity."""
    tm = unet.BottleneckAttention(64, device="cpu")
    x = torch.randn(1, 32, 64)
    with torch.no_grad():
        assert torch.equal(tm(x), x)


@pytest.mark.parametrize("L", [256, 333])
def test_attention_unet_matches_jax(L):
    jm, params, tm = model_pair(L, use_attention=True, **SMALL)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, SMALL["in_ch"], L)).astype(np.float32)
    t = np.array([3, 811], np.int32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == want.shape == (2, 1, L)
    assert rel_err(got, want) <= REL_TOL


def test_attention_serving_fn_matches_jax():
    B, L, S = 2, 256, 2
    jm, params, tm = model_pair(L, use_attention=True, **SMALL)
    rng = np.random.default_rng(8)
    cond = rng.standard_normal((B, 5, L)).astype(np.float32)
    sig = np.array([0.5, 2.0], np.float32)
    ck = {"in_ch": 7, "cond_in_ch": 5, "pred_type": "v"}
    js, ts = jsch.make_schedule(1000), tsch.make_schedule(1000)
    jcfg, _ = jsrv.resolve_serving_config(ck, js, steps=3, ladder="lambda",
                                          cfg_scale=1.5)
    tcfg, _ = tsrv.resolve_serving_config(ck, ts, steps=3, ladder="lambda",
                                          cfg_scale=1.5)
    kw = dict(sampler="ddim", avg_seeds=S, avg_mode="mf", amp_calib="mf")
    want = np.asarray(jsrv.build_serving_fn(jm, js, jcfg, **kw)(
        params, jnp.asarray(cond), jnp.asarray(sig), 7))
    # the JAX function's initial noise, drawn from its key and injected
    k_init, _ = jax.random.split(jax.random.PRNGKey(7))
    noise = tsp.FixedNoise(torch.from_numpy(np.array(
        jax.random.normal(k_init, (S * B, 1, L), jnp.float32))))
    got = tsrv.build_serving_fn(ts, tcfg, device="cpu", **kw)(
        tm, cond, sig, 7, noise=noise)
    assert got.shape == want.shape == (B, L)
    assert rel_err(got, want) <= REL_TOL
