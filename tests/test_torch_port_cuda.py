"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc: the fused
ConvBlock kernel and the flash-attention kernel against their plain versions
on the card, and the U-Net's kernel path against its plain path.

This file imports neither JAX nor the JAX package, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py
"""
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
    conv_route,
    flash_attention,
    flash_attention_reference,
    fused_conv_gn_silu,
    fused_conv_gn_silu_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and the CUDA toolkit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the plain attention's bf16 p @ v accumulates in f32, as the kernel does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


# bf16: the kernel and the plain version round the same f32 values, which
# differ only in summation order, so an output may flip by one bf16 ulp
# (2^-7 relative); f32: summation order over up to 3*Cin terms
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}


def _block_inputs(device, B, L, Cin, Cout, seed=0, bias=0.1):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, L, Cin, generator=g, device=device)
    W = torch.randn(3, Cin, Cout, generator=g, device=device) / (3 * Cin) ** 0.5
    b, s, bb = (0.1 * torch.randn(Cout, generator=g, device=device)
                for _ in range(3))
    return x, W, b + bias - 0.1, s + 1.0, bb


# the edges of the conv pass's tiling: L around the 128-row tile (1, 65,
# 129, 333, 4000); Cin 7 (the mma.sync route), 8 and 40 (wgmma, below one
# 64-channel K chunk), 64, 192, 384; Cout 16, 24, 64, 200, 512 across the
# 64- and 128-channel N tiles; B 1 and 65
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,Cin,Cout", [
    (2, 256, 24, 32), (1, 128, 7, 16), (3, 333, 40, 24), (2, 1024, 384, 128),
    (2, 1, 64, 64), (2, 65, 64, 64), (2, 129, 64, 64), (1, 4000, 64, 64),
    (2, 300, 7, 64), (2, 200, 8, 16), (2, 256, 40, 64), (2, 256, 192, 256),
    (1, 512, 384, 512), (2, 256, 64, 24), (2, 256, 64, 200),
    (65, 130, 64, 64), (1, 333, 128, 512)])
def test_kernel_matches_plain_version(cuda, dtype, B, L, Cin, Cout):
    x, W, b, s, bb = _block_inputs(cuda, B, L, Cin, Cout)
    x = x.to(dtype)
    if dtype == torch.bfloat16:
        assert conv_route(x) == ("wgmma" if Cin % 8 == 0 else "mma_sync")
    before = fused_conv_gn_silu.launches
    out = fused_conv_gn_silu(x, W, b, s, bb, 8)
    torch.cuda.synchronize()
    assert fused_conv_gn_silu.launches == before + 1
    want = fused_conv_gn_silu_reference(x, W, b, s, bb, 8)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Cin", [7, 16])
def test_kernel_takes_an_odd_cout(cuda, dtype, Cin):
    # Cout 9 in 3 groups: y stored one channel at a time, the apply pass
    # one channel per thread (its 4-channel loads need Cout % 4 == 0)
    x, W, b, s, bb = _block_inputs(cuda, 2, 150, Cin, 9, seed=4)
    x = x.to(dtype)
    out = fused_conv_gn_silu(x, W, b, s, bb, 3)
    want = fused_conv_gn_silu_reference(x, W, b, s, bb, 3)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Cin", [7, 64])
def test_kernel_survives_a_large_mean(cuda, dtype, Cin):
    # conv output around 100 with unit spread: E[y^2] - mean^2 would cancel
    x, W, b, s, bb = _block_inputs(cuda, 2, 333, Cin, 64, seed=1, bias=100.0)
    x = x.to(dtype)
    out = fused_conv_gn_silu(x, W, b, s, bb, 8)
    want = fused_conv_gn_silu_reference(x, W, b, s, bb, 8)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Cin", [7, 64])
def test_kernel_keeps_samples_apart(cuda, dtype, Cin):
    # each sample's first and last rows are large: a conv that read the
    # neighbouring sample's edge row as SAME padding would differ
    x, W, b, s, bb = _block_inputs(cuda, 3, 200, Cin, 128, seed=2)
    x[:, 0] *= 50.0
    x[:, -1] *= 50.0
    x = x.to(dtype)
    batched = fused_conv_gn_silu(x, W, b, s, bb, 8)
    for i in range(x.shape[0]):
        alone = fused_conv_gn_silu(x[i:i + 1].contiguous(), W, b, s, bb, 8)
        assert torch.equal(alone, batched[i:i + 1])
    want = fused_conv_gn_silu_reference(x, W, b, s, bb, 8)
    torch.testing.assert_close(batched.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("Cin", [7, 64])
def test_kernel_reads_weights_updated_in_place(cuda, Cin):
    x, W, b, s, bb = _block_inputs(cuda, 2, 256, Cin, 128, seed=3)
    x = x.to(torch.bfloat16)
    fused_conv_gn_silu(x, W, b, s, bb, 8)
    W.mul_(2.0)                               # the weights are packed per call
    out = fused_conv_gn_silu(x, W, b, s, bb, 8)
    want = fused_conv_gn_silu_reference(x, W, b, s, bb, 8)
    torch.testing.assert_close(out.float(), want.float(),
                               **TOL[torch.bfloat16])


def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(1, 16, 8, device=cuda)
    W = torch.randn(3, 8, 16, device=cuda)
    v = torch.randn(16, device=cuda)
    with pytest.raises(TypeError):
        fused_conv_gn_silu(x.half(), W, v, v, v, 8)
    with pytest.raises(ValueError):
        fused_conv_gn_silu(x.transpose(1, 2).contiguous().transpose(1, 2),
                           W, v, v, v, 8)
    with pytest.raises(ValueError):
        fused_conv_gn_silu(x, W, v, v, v, 3)


def test_unet_kernel_path_matches_plain_path(cuda, monkeypatch):
    model = unet.UNet1D(in_ch=7, base_ch=16, time_dim=32, depth=2,
                        cond_in_ch=5, use_selfcond=True, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g, device=cuda))
        x = torch.randn(2, 7, 512, generator=g, device=cuda)
        t = torch.tensor([10, 900], device=cuda)
        got = model(x, t)
        monkeypatch.setattr(unet, "fused_conv_gn_silu",
                            fused_conv_gn_silu_reference)
        want = model(x, t)
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-4   # f32: summation order through five blocks


# flash attention, kernel against plain version.  f32: the same sums in
# another order, and exp2 of log2-scaled scores.  bf16: both round P to bf16
# (the kernel before normalising, the plain version after) and round the
# output, so an output may differ by a few bf16 ulps (2^-8 relative each).
ATTN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
            torch.bfloat16: dict(rtol=2 ** -6, atol=2e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,L,D", [(2, 4, 512, 64), (1, 2, 300, 32),
                                     (2, 2, 1000, 128), (1, 3, 77, 65),
                                     (1, 1, 200, 256), (1, 2, 1, 16)])
def test_flash_attention_matches_plain_version(cuda, dtype, B, H, L, D):
    g = torch.Generator(device=cuda).manual_seed(L + D)
    q, k, v = (torch.randn(B, H, L, D, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = flash_attention_reference(q, k, v)
    torch.testing.assert_close(out.float(), want.float(), **ATTN_TOL[dtype])


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 2, 64, 32, device=cuda)
    before = flash_attention.launches
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    wide = torch.randn(1, 1, 16, 320, device=cuda)
    with pytest.raises(ValueError, match="head dimension"):
        flash_attention(wide, wide, wide)
    strided = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(strided, q, q)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :32].contiguous(), q)
    assert flash_attention.launches == before


def test_attention_unet_kernel_path_matches_plain_path(cuda, monkeypatch):
    model = unet.UNet1D(in_ch=7, base_ch=16, time_dim=32, depth=2,
                        cond_in_ch=5, use_selfcond=True, use_attention=True,
                        device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g, device=cuda))
        x = torch.randn(2, 7, 1000, generator=g, device=cuda)
        t = torch.tensor([10, 900], device=cuda)
        before = flash_attention.launches
        got = model(x, t)
        assert flash_attention.launches == before + 1
        monkeypatch.setattr(unet, "fused_conv_gn_silu",
                            fused_conv_gn_silu_reference)
        monkeypatch.setattr(unet, "flash_attention", flash_attention_reference)
        want = model(x, t)
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-4   # f32: summation order through five blocks
