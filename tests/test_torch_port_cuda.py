"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc: the fused
ConvBlock kernel (with and without its conditioning epilogue), the U-Net's
head kernel and the flash-attention kernel (each of its routes) against
their plain versions on the card, the U-Net's kernel path against its
plain path, a checkpoint written and loaded on the card, the infer CLI on
the card, the serving artifact traced on the card (its ops, its replay
against the live function), a grad-enabled forward launching both kernels
and backpropagating through the backward kernels (each against its plain
backward, on every forward route and at their edge shapes), a few train
steps on the card, ``eval_indices`` and
``gw-grid`` on the card, a distillation step's gradients, the tiled
forward's kernel path against its plain path, a data-parallel train step
on two gloo ranks sharing the card, a one-rank NCCL group, and the data
side (Welch PSDs and a gw-gen chunk against the CPU, chunks of a ragged
``.npz`` twin resident on the card), and the tools' shapes (K1 at 512
rows, K2 at (64, 4, 512, 64), a small population and a 65536-sample chirp
against the CPU).

This file imports neither JAX nor the JAX package, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py
"""
import importlib
import json
import os
import queue as queue_mod
import socket
import sys

import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference, serving
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import infer
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
    launch_counts,
    reset_launch_counts,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import (
    seeded_normal,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
    build_t_schedule,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.checkpoint import (
    save_checkpoint,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import (
    randomize_,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
    attention_route,
    conv_route,
    flash_attention,
    flash_attention_grad,
    flash_attention_reference,
    fused_conv_gn_silu,
    fused_conv_gn_silu_grad,
    fused_conv_gn_silu_reference,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
    decoder_input,
    head_route,
    unet_head,
    unet_head_composition,
    unet_head_plain,
    unet_head_reference,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import conv_gn_silu as k1_module
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_kernels import (
    DECODER_MAT_TOL,
    EPILOGUE_PLAIN_REL,
    decoder_f32,
    attention_backward_row,
    conv_backward_row,
    epilogue_f32,
    grads_against,
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


def _counts(k1=0, k2=0, k1b=0, k2b=0, epilogue=0, decoder=0, head=0):
    """``launch_counts()`` after k1 / k2 forward and k1b / k2b backward
    kernel launches, ``epilogue`` of the k1 with the conditioning
    epilogue (the U-Net's forwards that autograd does not record),
    ``decoder`` of them on K1's decoder route (none at these tests' widths
    under 64 channels) and ``head`` launches of the U-Net's head kernel
    (one a forward that autograd does not record)."""
    return {"conv_gn_silu": k1, "flash_attention": k2,
            "conv_gn_silu_backward": k1b, "flash_attention_backward": k2b,
            "conv_gn_silu_epilogue": epilogue,
            "conv_gn_silu_decoder": decoder, "unet_head": head}


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


def _epilogue_inputs(device, dtype, B, L, Cin, Cout, K, seed):
    """A ConvBlock's inputs and its conditioning epilogue's: r (B, L, K)
    with an unconditional (zero) first row, as a CFG batch has, the
    Dense's Wc (K, Cout) and bc, and FiLM's [gamma | beta] (B, 2 Cout)."""
    x, W, b, s, bb = _block_inputs(device, B, L, Cin, Cout, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed + 100)
    r = torch.randn(B, L, K, generator=g, device=device)
    r[0] = 0.0
    Wc = torch.randn(K, Cout, generator=g, device=device) / K ** 0.5
    bc = 0.1 * torch.randn(Cout, generator=g, device=device)
    film = 0.3 * torch.randn(B, 2 * Cout, generator=g, device=device)
    return x.to(dtype), W, b, s, bb, r.to(dtype), Wc, bc, film.to(dtype)


# each route of the conv pass (mma.sync for Cin 7 and 16-channel rows of an
# odd Cout, wgmma for Cin 128 to 384, FMA in f32), 4 channels a thread and
# 1 (Cout 9), and Cout 512 (one row a 128-thread stripe)
@pytest.mark.parametrize("cond", [True, False], ids=["cond", "film_only"])
@pytest.mark.parametrize("dtype,B,L,Cin,Cout,G", [
    (torch.bfloat16, 2, 300, 7, 64, 8), (torch.bfloat16, 2, 256, 128, 128, 8),
    (torch.bfloat16, 3, 200, 256, 256, 8),
    (torch.bfloat16, 2, 333, 384, 512, 8), (torch.float32, 2, 256, 64, 64, 8),
    (torch.float32, 2, 130, 7, 16, 8), (torch.bfloat16, 2, 150, 7, 9, 3),
    (torch.bfloat16, 2, 150, 16, 9, 3), (torch.float32, 2, 150, 16, 9, 3)])
def test_epilogue_matches_plain_version(cuda, cond, dtype, B, L, Cin, Cout,
                                        G):
    """K1 with the conditioning bias and FiLM in its apply pass: one launch
    of K1, counted as K1's and the epilogue's; within the K1 bars of the
    same steps in f32 rounded once, and within four bf16 ulps (2^-7 each)
    of the terms' size of the plain composition, which rounds about eight
    times to x's dtype (2 ulps seen when the once-rounded f32 steps are
    held against it on the CPU)."""
    x, W, b, s, bb, r, Wc, bc, film = _epilogue_inputs(cuda, dtype, B, L,
                                                       Cin, Cout, 5, Cout)
    cargs = dict(r=r, Wc=Wc, bc=bc) if cond else {}
    before = launch_counts()
    with torch.no_grad():
        out = fused_conv_gn_silu(x, W, b, s, bb, G, film=film, **cargs)
    torch.cuda.synchronize()
    after = launch_counts()
    assert (after["conv_gn_silu"], after["conv_gn_silu_epilogue"]) == (
        before["conv_gn_silu"] + 1, before["conv_gn_silu_epilogue"] + 1)
    assert out.dtype == dtype and out.shape == (B, L, Cout)
    ideal, scale = epilogue_f32(x, W, b, s, bb, G, film,
                                *(cargs.get(k) for k in ("r", "Wc", "bc")))
    torch.testing.assert_close(out.float(), ideal, **TOL[dtype])
    plain = fused_conv_gn_silu_reference(x, W, b, s, bb, G, film=film,
                                         **cargs)
    rel = EPILOGUE_PLAIN_REL[str(dtype).split(".")[1]]
    assert bool(((out.float() - plain.float()).abs()
                 <= rel * scale + TOL[dtype]["atol"]).all())


@pytest.mark.parametrize("K", [1, 11])
def test_epilogue_takes_any_number_of_conditioning_channels(cuda, K):
    """K 1 (the legacy 3-channel layout's one channel) and K 11, more than
    the U-Net's 5."""
    x, W, b, s, bb, r, Wc, bc, film = _epilogue_inputs(
        cuda, torch.bfloat16, 2, 256, 64, 64, K, 7)
    with torch.no_grad():
        out = fused_conv_gn_silu(x, W, b, s, bb, 8, film=film, r=r, Wc=Wc,
                                 bc=bc)
    ideal, _ = epilogue_f32(x, W, b, s, bb, 8, film, r, Wc, bc)
    torch.testing.assert_close(out.float(), ideal, **TOL[torch.bfloat16])


def test_epilogue_rejects_what_it_does_not_take(cuda):
    x, W, b, s, bb, r, Wc, bc, film = _epilogue_inputs(
        cuda, torch.bfloat16, 2, 64, 16, 16, 5, 8)
    with torch.no_grad():
        with pytest.raises(TypeError):
            fused_conv_gn_silu(x, W, b, s, bb, 8, film=film.float(), r=r,
                               Wc=Wc, bc=bc)
        with pytest.raises(ValueError):
            fused_conv_gn_silu(x, W, b, s, bb, 8, film=film, r=r[:, :, :4],
                               Wc=Wc, bc=bc)
        with pytest.raises(ValueError):
            fused_conv_gn_silu(x, W, b, s, bb, 8, film=film, r=r, Wc=Wc)
        with pytest.raises(ValueError, match="need film"):
            fused_conv_gn_silu(x, W, b, s, bb, 8, r=r, Wc=Wc, bc=bc)
    _recorded_against_plain(x, W, b, s, bb, 8, film=film, r=r, Wc=Wc, bc=bc)


def _recorded_against_plain(x, W, b, s, bb, G, **kw):
    """A call that autograd records (every input requiring grad): K1 alone,
    one launch without the epilogue or the decoder route, the rest as
    plain steps, and one K1B launch for the gradients; every input's
    gradient within K1's gradient bars (``GRAD_TOL``) of autograd through
    the plain composition."""
    ins, ref = (_requires_grad(x, W, b, s, bb, *kw.values())
                for _ in range(2))
    before = launch_counts()
    out = fused_conv_gn_silu(*ins[:5], G, **dict(zip(kw, ins[5:])))
    dout = torch.randn(out.shape, device=out.device).to(out.dtype)
    got = torch.autograd.grad(out, ins, dout)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == _counts(1, k1b=1)
    want = torch.autograd.grad(fused_conv_gn_silu_reference(
        *ref[:5], G, **dict(zip(kw, ref[5:]))), ref, dout)
    assert grads_against(got, want, str(x.dtype)[6:])["n_outside_tol"] == 0


def _decoder_inputs(device, B, Lh, Ch, Cs, Cout, seed=0):
    """bf16 h (B, Lh, Ch) and skip (B, 2 Lh, Cs), the ConvBlock's f32
    parameters for Ch + Cs inputs, and the epilogue's r (B, 2 Lh, 5), Wc,
    bc and film."""
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(B, Lh, Ch, generator=g, device=device).bfloat16()
    skip = torch.randn(B, 2 * Lh, Cs, generator=g, device=device).bfloat16()
    W = (torch.randn(3, Ch + Cs, Cout, generator=g, device=device)
         / (3 * (Ch + Cs)) ** 0.5)
    b, s, bb = (0.1 * torch.randn(Cout, generator=g, device=device)
                for _ in range(3))
    r = torch.randn(B, 2 * Lh, 5, generator=g, device=device).bfloat16()
    Wc = torch.randn(5, Cout, generator=g, device=device) / 5 ** 0.5
    bc = 0.1 * torch.randn(Cout, generator=g, device=device)
    film = (0.3 * torch.randn(B, 2 * Cout, generator=g,
                              device=device)).bfloat16()
    return h, skip, W, b, s + 1.0, bb, dict(film=film, r=r, Wc=Wc, bc=bc)


# (B, L/2, C_h, C_s, Cout): the decoder stages of pn128 at its 128 rows and
# of attn16k at its 64, attn16k's tiles of L 16880 at 128 rows (ragged
# against the 128-row tile at every stage), and the tiling's edges (L 2,
# 130, 666; Cout 24, 136, 200 across the N tiles; C_s 192 against C_h 64)
DECODER_SHAPES = [
    (128, 512, 512, 512, 512), (128, 1024, 512, 256, 256),
    (128, 2048, 256, 128, 128), (64, 4096, 256, 256, 256),
    (64, 8192, 256, 128, 128), (64, 16384, 128, 64, 64),
    (128, 2110, 256, 256, 256), (128, 4220, 256, 128, 128),
    (128, 8440, 128, 64, 64), (2, 333, 64, 64, 64), (3, 65, 64, 128, 24),
    (1, 1, 64, 64, 200), (2, 64, 64, 192, 136)]


@pytest.mark.parametrize("B,Lh,Ch,Cs,Cout", DECODER_SHAPES)
def test_decoder_route_matches_plain_versions(cuda, B, Lh, Ch, Cs, Cout):
    """K1's decoder route: one launch, counted as K1's and the decoder
    route's; within K1's bf16 bars of its own arithmetic in plain PyTorch;
    and against the materialised upsample -> concat -> K1 within
    ``DECODER_MAT_TOL`` (the route rounds each folded pair of taps to bf16
    once, the materialised path each tap apart)."""
    h, skip, W, b, s, bb, _ = _decoder_inputs(cuda, B, Lh, Ch, Cs, Cout)
    G = 8 if Cout % 8 == 0 else 4
    before = launch_counts()
    with torch.no_grad():
        out = fused_conv_gn_silu(h, W, b, s, bb, G, skip=skip)
    torch.cuda.synchronize()
    after = launch_counts()
    assert [after[k] - before[k] for k in (
        "conv_gn_silu", "conv_gn_silu_decoder", "conv_gn_silu_epilogue")] \
        == [1, 1, 0]
    assert out.dtype == torch.bfloat16 and out.shape == (B, 2 * Lh, Cout)
    torch.testing.assert_close(out.float(),
                               decoder_f32(h, skip, W, b, s, bb, G),
                               **TOL[torch.bfloat16])
    mat = fused_conv_gn_silu(decoder_input(h, skip), W, b, s, bb, G).float()
    rtol, atol = DECODER_MAT_TOL
    assert bool(((out.float() - mat).abs() <= rtol * mat.abs() + atol).all())


@pytest.mark.parametrize("B,Lh,Ch,Cs,Cout", [
    (128, 2048, 256, 128, 128), (64, 16384, 128, 64, 64),
    (128, 8440, 128, 64, 64), (3, 65, 64, 128, 24)])
def test_decoder_route_with_the_epilogue(cuda, B, Lh, Ch, Cs, Cout):
    """The route with the conditioning bias and FiLM in its apply pass, as
    the U-Net launches it: counted as the epilogue's too; within K1's bf16
    bars of its arithmetic in f32 rounded once; and within
    ``DECODER_MAT_TOL`` of the materialised path through K1 with the same
    epilogue, three times its atol (FiLM scales the block's difference by
    1 + gamma and adds the conditioning's terms)."""
    h, skip, W, b, s, bb, epi = _decoder_inputs(cuda, B, Lh, Ch, Cs, Cout, 3)
    G = 8 if Cout % 8 == 0 else 4
    before = launch_counts()
    with torch.no_grad():
        out = fused_conv_gn_silu(h, W, b, s, bb, G, skip=skip, **epi)
        mat = fused_conv_gn_silu(decoder_input(h, skip), W, b, s, bb, G,
                                 **epi).float()
    torch.cuda.synchronize()
    after = launch_counts()
    assert [after[k] - before[k] for k in (
        "conv_gn_silu", "conv_gn_silu_decoder", "conv_gn_silu_epilogue")] \
        == [2, 1, 2]
    torch.testing.assert_close(out.float(),
                               decoder_f32(h, skip, W, b, s, bb, G, **epi),
                               **TOL[torch.bfloat16])
    rtol, atol = DECODER_MAT_TOL
    assert bool(((out.float() - mat).abs()
                 <= rtol * mat.abs() + 3 * atol).all())


def test_decoder_route_rejects_what_it_does_not_take(cuda):
    """Sources the route would take but cannot read, a strided skip and an
    h off 16 bytes, raise; a recorded decoder block runs K1 alone on its
    materialised input (``_recorded_against_plain``)."""
    h, skip, W, b, s, bb, _ = _decoder_inputs(cuda, 2, 64, 64, 64, 64)
    buf = torch.empty(h.numel() + 2, dtype=h.dtype, device=cuda)
    h_off = buf[2:].view(h.shape).copy_(h)     # 4 bytes off 16
    wrong = [
        (h, skip.transpose(1, 2).contiguous().transpose(1, 2)),  # strided
        (h_off, skip)]                                           # unaligned
    with torch.no_grad():
        for hw, sw in wrong:
            with pytest.raises(ValueError):
                fused_conv_gn_silu(hw, W, b, s, bb, 8, skip=sw)
    _recorded_against_plain(h, W, b, s, bb, 8, skip=skip)


@pytest.mark.parametrize("case", ["f32", "not_2L", "C_h_48", "C_s_32"])
def test_decoder_blocks_off_the_route_run_materialised(cuda, case):
    """A decoder block the route does not take (f32, a skip not twice h's
    length, C_h or C_s not a multiple of 64) is one K1 launch with the
    epilogue on the materialised input, bit-equal to K1 called on it."""
    h, skip, W, b, s, bb, epi = _decoder_inputs(cuda, 2, 64, 64, 64, 64)
    if case == "f32":
        h, skip = h.float(), skip.float()
        epi = dict(epi, film=epi["film"].float(), r=epi["r"].float())
    elif case == "not_2L":
        skip, epi["r"] = skip[:, :127].contiguous(), epi["r"][:, :127]
    elif case == "C_h_48":
        h, W = h[:, :, :48].contiguous(), W[:, 16:].contiguous()
    else:
        skip, W = skip[:, :, :32].contiguous(), W[:, :96].contiguous()
    epi["r"] = epi["r"].contiguous()
    before = launch_counts()
    with torch.no_grad():
        got = fused_conv_gn_silu(h, W, b, s, bb, 8, skip=skip, **epi)
        after = launch_counts()
        want = fused_conv_gn_silu(decoder_input(h, skip), W, b, s, bb, 8,
                                  **epi)
    assert {k: after[k] - before[k] for k in after} == _counts(1, epilogue=1)
    assert got.shape == (2, skip.shape[1], 64)
    assert torch.equal(got, want)


def test_unet_kernel_path_matches_plain_path(cuda, monkeypatch):
    model = unet.UNet1D(in_ch=7, base_ch=16, time_dim=32, depth=2,
                        cond_in_ch=5, use_selfcond=True, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g, device=cuda))
        x = torch.randn(2, 7, 512, generator=g, device=cuda)
        t = torch.tensor([10, 900], device=cuda)
        reset_launch_counts()
        got = model(x, t)
        # no grad: every ConvBlock's bias and FiLM in K1's epilogue
        assert launch_counts() == _counts(5, epilogue=5, head=1)
    reset_launch_counts()
    recorded = model(x, t)
    assert launch_counts() == _counts(5)    # with grad: the separate steps
    with torch.no_grad():
        monkeypatch.setattr(unet, "fused_conv_gn_silu",
                            fused_conv_gn_silu_reference)
        want = model(x, t)
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-4   # f32: summation order through five blocks
    err = (recorded.detach() - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-4


# the flagships' models (gwbench/configs), their length, the rows of a
# forward here, and the limit of their cell's rel_err
FLAGSHIP_FORWARDS = {
    "pn128": (dict(in_ch=7, cond_in_ch=5, use_selfcond=True, base_ch=128,
                   depth=3, time_dim=128), 4096, 128, 0.036),
    "attn16k": (dict(in_ch=7, cond_in_ch=5, use_selfcond=True, base_ch=64,
                     depth=3, time_dim=128, use_attention=True), 32768, 16,
                0.022)}


@pytest.mark.parametrize("config", ["pn128", "attn16k"])
def test_unet_decoder_route_matches_plain_path(cuda, monkeypatch, config):
    """A bf16 forward of each flagship at full width: its three decoder
    blocks on K1's decoder route (3 of 7 K1 launches), against the same
    forward with them materialised and against the plain path.  Each row's
    relative L2 error from the plain path stays under half the limit that
    the cell holds a whole 200- or 50-step sampling run to (seen: 0.0067 at
    attn16k), and the route's within the materialised forward's error plus
    an eighth of the limit: the route rounds each folded pair of taps
    once, the plain path, like the materialised one, each tap apart."""
    kw, L, rows, limit = FLAGSHIP_FORWARDS[config]
    attn = int(kw.get("use_attention", False))
    model = unet.UNet1D(**kw, dtype=torch.bfloat16, device=cuda)
    randomize_(model, 1)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(rows, 7, L, generator=g, device=cuda)
    t = torch.randint(0, 1000, (rows,), generator=g, device=cuda)
    with torch.no_grad():
        reset_launch_counts()
        got = model(x, t)
        assert launch_counts() == _counts(7, attn, epilogue=7, decoder=3,
                                          head=1)
        monkeypatch.setattr(k1_module, "takes_decoder_route",
                            lambda h, s: False)
        mat = model(x, t)
        assert launch_counts() == _counts(14, 2 * attn, epilogue=14,
                                          decoder=3, head=2)
        with unet.plain_kernels():
            want = model(x, t)

    def rel(a):
        return ((a - want).flatten(1).norm(dim=1)
                / want.flatten(1).norm(dim=1)).max().item()

    errs = (rel(got), rel(mat))
    assert errs[0] <= limit / 2 and errs[1] <= limit / 2, errs
    assert errs[0] <= errs[1] + limit / 8, errs


# the U-Net's head kernel: (B, L_h, C, L0) and the route it reads h on.
# The cells' heads with rows cut (pn128: 128 rows, L 4096, C 128; attn16k:
# 64 rows, L 32768, C 64); L_h below L0 (fix_len's pad), above it (its
# crop) and L0 off the 510-row tile; C ragged, one channel, wide; h off
# 16-byte alignment
HEAD_SHAPES = [((16, 4096, 128, 4096), "vector"),
               ((2, 32768, 64, 32768), "vector"),
               ((3, 990, 64, 1000), "vector"),
               ((3, 1010, 64, 1000), "vector"),
               ((2, 5, 16, 5), "vector"),
               ((2, 1000, 13, 1000), "scalar"),
               ((2, 700, 129, 700), "scalar"),
               ((2, 700, 1, 700), "scalar"),
               ((2, 300, 512, 300), "vector")]


def _head_inputs(device, B, Lh, C, L0, dtype, misaligned=False, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    n = B * Lh * C
    flat = torch.randn(n + 1, generator=g, device=device).to(dtype)
    h = (flat[1:] if misaligned else flat[:n]).view(B, Lh, C)
    x = torch.randn(B, L0, 7, generator=g, device=device).to(dtype)
    W = torch.randn(3, C + 1, 1, generator=g, device=device) \
        / (3 * (C + 1)) ** 0.5
    b = 0.1 * torch.randn(1, generator=g, device=device)
    return h, x, W, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,route", HEAD_SHAPES,
                         ids=["x".join(map(str, s)) for s, _ in HEAD_SHAPES])
def test_head_kernel_matches_plain_version(cuda, shape, route, dtype):
    """One launch; against the plain version (the same arithmetic: W
    rounded to the compute dtype, f32 sums, one rounding) within K1's bars
    (``TOL``: an output may flip by one bf16 ulp, the sums' order
    differing), and in bf16 against the U-Net's composition
    (``conv3_same`` on the materialised ``[fix_len(h) | x_t]``, which
    rounds its product and its bias add) within ``DECODER_MAT_TOL``."""
    h, x, W, b = _head_inputs(cuda, *shape, dtype)
    esize = torch.empty((), dtype=dtype).element_size()
    if route == "vector" and shape[2] % (16 // esize):
        route = "scalar"
    assert head_route(h) == route
    before = launch_counts()["unet_head"]
    with torch.no_grad():
        got = unet_head(h, x, W, b)
        torch.cuda.synchronize()
        assert launch_counts()["unet_head"] == before + 1
        want = unet_head_reference(h, x, W, b)
        assert got.shape == (shape[0], 1, shape[3])
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, **TOL[dtype])
        if dtype == torch.bfloat16:
            rtol, atol = DECODER_MAT_TOL
            torch.testing.assert_close(got, unet_head_composition(h, x, W, b),
                                       rtol=rtol, atol=atol)


def test_head_kernel_reads_misaligned_h_on_the_scalar_route(cuda):
    h, x, W, b = _head_inputs(cuda, 2, 1000, 64, 1000, torch.bfloat16,
                              misaligned=True)
    assert h.is_contiguous() and h.data_ptr() % 16 and \
        head_route(h) == "scalar"
    with torch.no_grad():
        got = unet_head(h, x, W, b)
        torch.testing.assert_close(got, unet_head_reference(h, x, W, b),
                                   **TOL[torch.bfloat16])


def test_head_kernel_refuses_a_c_wider_than_it_takes(cuda):
    """Element loads cover up to 256 channels (32 lanes x 8 loads): a
    ragged C above that raises before any launch."""
    h, x, W, b = _head_inputs(cuda, 1, 64, 300, 64, torch.bfloat16)
    before = launch_counts()["unet_head"]
    with torch.no_grad(), pytest.raises(ValueError, match="wider"):
        unet_head(h, x, W, b)
    assert launch_counts()["unet_head"] == before


def test_unet_head_launches_once_a_no_grad_forward(cuda, monkeypatch):
    """A bf16 U-Net forward that autograd does not record launches the
    head kernel once; a recorded one launches it never, and its gradients
    are those of the plain composition, which ``plain_kernels`` runs
    there too."""
    model = unet.UNet1D(in_ch=7, base_ch=16, time_dim=32, depth=2,
                        cond_in_ch=5, use_selfcond=True,
                        dtype=torch.bfloat16, device=cuda)
    randomize_(model, 4)
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 7, 512, generator=g, device=cuda)
    t = torch.tensor([10, 900], device=cuda)
    with torch.no_grad():
        reset_launch_counts()
        got = model(x, t)
        assert launch_counts() == _counts(5, epilogue=5, head=1)
        with unet.plain_kernels():
            want = model(x, t)
    assert (got - want).abs().max() <= 0.05 * want.abs().max()

    def grads():
        model.zero_grad()
        model(x, t).square().mean().backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    reset_launch_counts()
    got = grads()
    assert launch_counts()["unet_head"] == 0
    monkeypatch.setattr(unet, "unet_head", unet_head_plain)
    want = grads()
    for n in got:
        assert torch.equal(got[n], want[n]), n


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


def _qkv(device, B, H, L, D, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(B, H, L, D, generator=g, device=device)
            .to(torch.bfloat16) for _ in range(3)]


def _plain_in_chunks(q, k, v):
    """The plain version over chunks of B, so that its f32 scores stay near
    2 GB."""
    B, H, L, _ = q.shape
    step = max(1, (1 << 31) // (H * L * L * 4))
    return torch.cat([flash_attention_reference(q[i:i + step], k[i:i + step],
                                                v[i:i + step])
                      for i in range(0, B, step)])


def _assert_within_p_rounding(out, q, k, v):
    """The bf16 kernel against the exact attention (f64) of the same inputs,
    where outputs may cancel.  The kernel rounds each unnormalised p_i to
    bf16 (unit roundoff 2^-8) and then the output, so it is off by at most
    2^-8 (sum_i p_i |v_i| + |out|), up to second-order terms and the f32
    sums; sum_i p_i |v_i| is |out| only where the terms do not cancel."""
    qd, kd, vd = (a.double() for a in (q, k, v))
    p = torch.softmax(qd @ kd.transpose(-1, -2) / q.shape[-1] ** 0.5, dim=-1)
    exact = p @ vd
    bound = 1e-4 + 1.02 * 2 ** -8 * (p @ vd.abs() + exact.abs())
    excess = (out.double() - exact).abs() - bound
    assert excess.max() <= 0, f"outside by {excess.max().item()}"


# the wgmma route's tiling: L around the 128-key tile (1, 64, 127, 128,
# 129) and the serving lengths (4000, 4096), both head widths; V is drawn
# apart from K, so a wrong transpose of V could not pass.  Short rows mix
# few keys, so an output may cancel: the bound of _assert_within_p_rounding
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [1, 64, 127, 128, 129, 4000, 4096])
def test_flash_attention_wgmma_route_matches_plain_version(cuda, L, D):
    q, k, v = _qkv(cuda, 2, 3, L, D, seed=L + D)
    assert attention_route(q, k, v) == "wgmma"
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_within_p_rounding(out, q, k, v)


@pytest.mark.parametrize("L", [4000, 4096])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_wgmma_route_at_the_serving_batch(cuda, D, L):
    # B * H = 128 heads at the serving length and a ragged one: more work
    # items than SMs, so each CTA of the persistent grid walks several
    q, k, v = _qkv(cuda, 32, 4, L, D, seed=D + L)
    assert attention_route(q, k, v) == "wgmma"
    out = flash_attention(q, k, v)
    torch.testing.assert_close(out.float(), _plain_in_chunks(q, k, v).float(),
                               **ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_keeps_heads_apart(cuda, D):
    # at a ragged L, each head alone is bit-equal to the same head in the
    # batch: no tile reads past its own head's rows
    q, k, v = _qkv(cuda, 2, 3, 1000, D, seed=7)
    batched = flash_attention(q, k, v)
    for b in range(2):
        for h in range(3):
            one = [a[b:b + 1, h:h + 1].contiguous() for a in (q, k, v)]
            assert torch.equal(flash_attention(*one), batched[b:b + 1, h:h + 1])


@pytest.mark.parametrize("route", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_takes_large_scores(cuda, route, D):
    # scores x30 (softmax std about 30 in natural units): alpha far from 1 at
    # every new row max, and -inf keys past the ragged L = 777.  So peaked a
    # softmax often splits an output between two keys of opposite sign, and
    # both routes then need the bound of _assert_within_p_rounding
    q, k, v = _qkv(cuda, 2, 2, 777, D, seed=30 + D)
    q = (q.float() * 30).to(torch.bfloat16)
    if route == "mma_sync":   # the same inputs one element past an aligned base
        q = torch.cat([q.new_zeros(1), q.flatten()])[1:].view(q.shape)
    assert attention_route(q, k, v) == route
    _assert_within_p_rounding(flash_attention(q, k, v), q, k, v)


def test_flash_attention_misaligned_base_takes_mma_sync(cuda):
    q, k, v = _qkv(cuda, 2, 2, 300, 64, seed=11)
    buf = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(q.shape)          # 2 bytes past an aligned base
    shifted.copy_(q)
    assert attention_route(shifted, k, v) == "mma_sync"
    assert attention_route(q, k, v) == "wgmma"
    out = flash_attention(shifted, k, v)
    torch.testing.assert_close(out.float(),
                               flash_attention_reference(q, k, v).float(),
                               **ATTN_TOL[torch.bfloat16])


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
        reset_launch_counts()
        got = model(x, t)
        assert launch_counts() == _counts(5, 1, epilogue=5, head=1)
    reset_launch_counts()
    recorded = model(x, t)
    assert launch_counts() == _counts(5, 1)  # with grad: the separate steps
    with torch.no_grad():
        monkeypatch.setattr(unet, "fused_conv_gn_silu",
                            fused_conv_gn_silu_reference)
        monkeypatch.setattr(unet, "flash_attention", flash_attention_reference)
        want = model(x, t)
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-4   # f32: summation order through five blocks
    err = (recorded.detach() - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-4


SMALL_ARGS = {"in_ch": 7, "cond_in_ch": 5, "base_ch": 16, "time_dim": 32,
              "depth": 2, "T": 1000, "schedule": "cosine", "pred_type": "v",
              "whiten": 1, "whiten_mode_resolved": "model"}


def _small_checkpoint(device, path, use_attention=False):
    """A checkpoint written from a model on ``device``: raw weights seeded,
    EMA weights the raw ones plus 0.01.  Returns the EMA state_dict."""
    kw = dict(in_ch=7, base_ch=16, time_dim=32, depth=2, cond_in_ch=5,
              use_selfcond=True, t_embed_max_time=999,
              use_attention=use_attention)
    model = unet.UNet1D(**kw, device=device)
    g = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g, device=device))
    ema = {k: v + 0.01 for k, v in model.state_dict().items()}
    save_checkpoint(path, model.state_dict(), dict(
        SMALL_ARGS, use_attention=use_attention), epoch=1, model_ema_state=ema)
    return ema


@pytest.mark.parametrize("use_attention", [False, True])
def test_checkpoint_loads_on_the_card(cuda, tmp_path, use_attention):
    """A checkpoint written from tensors on the card loads with
    ``load_model(device="cuda")`` (EMA weights taken) and the card's f32
    forward matches the CPU plain path of the same checkpoint."""
    path = str(tmp_path / "ck.msgpack")
    ema = _small_checkpoint(cuda, path, use_attention)
    m_gpu, schedule, ck = inference.load_model(path, device="cuda")
    m_cpu, _, _ = inference.load_model(path, device="cpu")
    assert schedule.T == 1000 and ck["use_attention"] == use_attention
    for k, v in m_gpu.state_dict().items():
        assert v.is_cuda and torch.equal(v, ema[k])
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 7, 1000, generator=g)
    t = torch.tensor([10, 900])
    reset_launch_counts()
    with torch.no_grad():
        got = m_gpu(x.to(cuda), t.to(cuda)).cpu()
        want = m_cpu(x, t)
    assert launch_counts() == _counts(5, int(use_attention), epilogue=5,
                                      head=1)
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-4   # f32: summation order through five blocks


def test_infer_cli_on_the_card(cuda, tmp_path):
    """The infer CLI with ``--device cuda`` on an ``.npy`` measurement: its
    artifacts, one JSONL record per ladder step, and K1 launched 5 times per
    ladder step (depth 2)."""
    path = str(tmp_path / "ck.msgpack")
    _small_checkpoint(cuda, path)
    y = np.random.default_rng(0).standard_normal(512).astype(np.float32)
    np.save(tmp_path / "y.npy", y)
    out, log = tmp_path / "out", tmp_path / "steps.jsonl"
    reset_launch_counts()
    infer.main(["--input-npy", str(tmp_path / "y.npy"), "--model", path,
                "--outdir", str(out), "--steps", "3", "--avg-seeds", "2",
                "--amp-calib", "mf", "--log-jsonl", str(log),
                "--device", "cuda"])
    n = len(build_t_schedule(1000, 3, None))
    assert launch_counts() == _counts(5 * n, epilogue=5 * n, head=n)
    files = sorted(os.listdir(out))
    assert [f.split("_")[0] for f in files] == [
        "measurement", "metrics", "recon", "recon"]
    recon = np.load(out / next(f for f in files if f.startswith("recon_ddim")))
    assert recon.shape == (512,) and np.isfinite(recon).all()
    with open(out / next(f for f in files if f.startswith("metrics"))) as fh:
        metrics = json.load(fh)
    assert {"residuals", "seed_spread"} <= set(metrics)
    assert metrics["whiten_kind"] == "train"     # an .npy carries no PSD
    assert len(log.read_text().splitlines()) == n


@pytest.fixture(scope="module")
def cuda_artifact(tmp_path_factory):
    """A small attention checkpoint's sampler exported on the card (batch 2,
    L 512, 3 steps, 2 seeds, CFG) and its live function."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and the CUDA toolkit")
    d = tmp_path_factory.mktemp("export")
    ckpt, art = str(d / "ck.msgpack"), str(d / "sampler.pt2")
    _small_checkpoint(torch.device("cuda"), ckpt, use_attention=True)
    knobs = dict(steps=3, cfg_scale=1.5, avg_seeds=2, amp_calib="mf")
    contract = serving.export_sampler(ckpt, art, batch=2, length=512,
                                      device="cuda", **knobs)
    model, schedule, ck = inference.load_model(ckpt, device="cuda")
    cfg, sampler = serving.resolve_serving_config(ck, schedule, steps=3,
                                                  cfg_scale=1.5)
    live = serving.build_serving_fn(schedule, cfg, sampler=sampler,
                                    avg_seeds=2, amp_calib="mf",
                                    device="cuda")
    n = len(build_t_schedule(1000, 3, cfg.start_t))
    rng = np.random.default_rng(5)
    cond = rng.standard_normal((2, 5, 512)).astype(np.float32)
    sig = np.array([0.5, 2.0], np.float32)
    return art, contract, (lambda seed: live(model, cond, sig, seed)), n, (
        cond, sig)


def test_cuda_artifact_holds_the_ops_and_counts_on_replay(cuda_artifact):
    art, contract, _, n, (cond, sig) = cuda_artifact
    assert contract["platforms"] == ["cuda"]
    # one node per launch: 5 ConvBlocks and one attention per forward
    assert contract["ops"] == {"conv_gn_silu": 5 * n, "flash_attention": n,
                               "unet_head": n, "seeded_normal": 1}
    call, _ = serving.load_exported(art)
    reset_launch_counts()
    out = call(cond, sig, 3)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(5 * n, n, epilogue=5 * n, head=n)
    assert out.shape == (2, 512) and bool(torch.isfinite(out).all())


def test_cuda_artifact_equals_the_live_function(cuda_artifact):
    art, _, live, _, (cond, sig) = cuda_artifact
    call, _ = serving.load_exported(art)
    for seed in (0, 7):
        # the same ops on the same inputs: bit-equal
        assert torch.equal(call(cond, sig, seed), live(seed))


def test_cuda_artifact_needs_a_card(cuda_artifact, monkeypatch):
    art = cuda_artifact[0]
    with pytest.raises(RuntimeError, match="traced for"):
        serving.load_exported(art, device="cpu")       # no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.load_exported(art)


def test_grad_enabled_forward_raises(cuda, monkeypatch):
    """A CUDA forward that autograd records launches both kernels (no
    refusal, no plain forward) and backpropagates through their registered
    backwards; its parameter gradients match the plain path's on the card
    (f32: summation order through five blocks and the attention)."""
    model = unet.UNet1D(in_ch=7, base_ch=16, time_dim=32, depth=2,
                        cond_in_ch=5, use_selfcond=True, use_attention=True,
                        device=cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g, device=cuda))
    x = torch.randn(2, 7, 256, generator=g, device=cuda)
    t = torch.tensor([3, 700], device=cuda)
    reset_launch_counts()
    model(x, t).square().mean().backward()
    assert launch_counts() == _counts(5, 1, 5, 1)
    got = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    monkeypatch.setattr(unet, "fused_conv_gn_silu", fused_conv_gn_silu_reference)
    monkeypatch.setattr(unet, "flash_attention", flash_attention_reference)
    model(x, t).square().mean().backward()
    assert launch_counts() == _counts(5, 1, 5, 1)   # the plain path: none
    for n, p in model.named_parameters():
        scale = p.grad.abs().max().item()
        assert (got[n] - p.grad).abs().max().item() <= 1e-3 * scale + 1e-7, n


def _requires_grad(*tensors):
    return [a.detach().clone().requires_grad_() for a in tensors]


def _grads_close(got, want, dtype):
    """bf16: the kernel's output may differ from the plain one by an ulp,
    and the plain backward recomputes y by a bf16 product where the plain
    forward's autograd keeps it in f32: within 2^-6 of each gradient's
    largest element.  f32: summation order, 1e-4."""
    rel = 2 ** -6 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= rel * scale + 1e-6


@pytest.mark.parametrize("dtype,Cin", [(torch.float32, 7),
                                       (torch.float32, 64),
                                       (torch.bfloat16, 7),
                                       (torch.bfloat16, 64)])
def test_conv_gn_silu_backward_matches_plain_backward(cuda, dtype, Cin):
    """Each route (f32 FMA; bf16 mma.sync at Cin 7, wgmma at Cin 64): the
    op's backward launches K1B once, its gradients within the kernel bars
    of the plain backward on the same inputs (``GRAD_TOL``), and they match
    autograd of the plain forward."""
    k1 = importlib.import_module(
        "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
        ".ops.kernels.conv_gn_silu")
    x, W, b, s, bb = _block_inputs(cuda, 2, 300, Cin, 64, seed=Cin)
    x = x.to(dtype)
    assert conv_route(x) == {torch.float32: "fma"}.get(
        dtype, "wgmma" if Cin % 8 == 0 else "mma_sync")
    ins = _requires_grad(x, W, b, s, bb)
    before = fused_conv_gn_silu.launches
    out = fused_conv_gn_silu(*ins, 8)
    assert fused_conv_gn_silu.launches == before + 1
    dout = torch.randn(out.shape, device=cuda).to(dtype)
    before = fused_conv_gn_silu_grad.launches
    got = torch.autograd.grad(out, ins, dout)
    assert fused_conv_gn_silu_grad.launches == before + 1
    plain = k1.fused_conv_gn_silu_backward(dout, x, W, b, s, bb, 8)
    assert [g.dtype for g in got] == [w.dtype for w in plain]
    assert grads_against(got, plain, str(dtype)[6:])["n_outside_tol"] == 0
    ref_ins = _requires_grad(x, W, b, s, bb)
    want = torch.autograd.grad(fused_conv_gn_silu_reference(*ref_ins, 8),
                               ref_ins, dout)
    _grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 32)])
def test_flash_attention_backward_matches_plain_backward(cuda, dtype, D):
    """Each forward route (f32 FMA; bf16 wgmma at D 64, mma.sync at D 32):
    the op's backward launches K2B once, its gradients within the kernel
    bars of the plain backward given the kernel's output (``GRAD_TOL``),
    and they match autograd of the plain forward."""
    k2 = importlib.import_module(
        "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
        ".ops.kernels.flash_attention")
    q, k, v = _qkv(cuda, 2, 2, 300, D, seed=40 + D)
    q, k, v = (a.to(dtype) for a in (q, k, v))
    assert attention_route(q, k, v) == {torch.float32: "fma"}.get(
        dtype, "wgmma" if D == 64 else "mma_sync")
    ins = _requires_grad(q, k, v)
    before = flash_attention.launches
    out = flash_attention(*ins)
    assert flash_attention.launches == before + 1
    dout = torch.randn(out.shape, device=cuda).to(dtype)
    before = flash_attention_grad.launches
    got = torch.autograd.grad(out, ins, dout)
    assert flash_attention_grad.launches == before + 1
    plain = k2.flash_attention_backward(dout, q, k, v, out.detach())
    assert [g.dtype for g in got] == [w.dtype for w in plain]
    assert grads_against(got, plain, str(dtype)[6:])["n_outside_tol"] == 0
    ref_ins = _requires_grad(q, k, v)
    want = torch.autograd.grad(flash_attention_reference(*ref_ins), ref_ins,
                               dout)
    _grads_close(got, want, dtype)


# K1B's edges: one channel a group (C 8), a tensor-parallel rank's share
# (Cout 64 / 2, 8 / 2 groups), L ragged across the 64-row tiles with Cin 40
# and Cout 24 (a 64-channel dx tile masked past 40), a dout that is a
# channel slice (row stride 2 Cout), B 1 at L 1, and dW's tiles ragged in
# each of three samples (the wgmma route's TMA boxes at the samples' edges)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,Cin,Cout,G,sliced", [
    (2, 200, 16, 8, 8, False), (2, 256, 64, 32, 4, False),
    (1, 333, 40, 24, 8, False), (2, 130, 7, 16, 8, True),
    (1, 1, 8, 16, 8, False), (3, 100, 64, 64, 8, False)])
def test_conv_gn_silu_backward_kernel_edges(cuda, dtype, B, L, Cin, Cout, G,
                                            sliced):
    """K1B alone: one launch a call, two calls bit-equal, every gradient
    within ``GRAD_TOL`` of the plain backward on the inputs in f32."""
    x, W, b, s, bb = _block_inputs(cuda, B, L, Cin, Cout, seed=L + Cout)
    x = x.to(dtype)
    g = torch.Generator(device=cuda).manual_seed(7)
    dout = torch.randn(B, L, 2 * Cout if sliced else Cout, generator=g,
                       device=cuda).to(dtype)[..., :Cout]
    assert dout.is_contiguous() != sliced
    row = conv_backward_row(dout, x, W, b, s, bb, G, reps=0)
    assert row["dw_route"] == ("fma" if dtype == torch.float32 else
                               "wgmma" if Cin % 8 == 0 and Cout % 8 == 0
                               else "mma_sync")
    assert row["launches_per_call"] == 1 and row["deterministic"]
    assert row["within_tol"], row


# K2B's edges: L ragged across the tiles, D 16 (the 32 template padded), 65
# (rows not 16-byte aligned) and 256 (four column chunks), L 1, a dout
# transposed as the U-Net hands it back; the ragged lengths of the tiled
# reconstruction (2110) and of the kernel phase (4000) at 2 heads; bf16 D 64
# and 128 take the wgmma route, the others mma.sync; two calls bit-equal
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,L,D,transposed", [
    (2, 2, 300, 64, True), (1, 2, 100, 16, False), (1, 2, 777, 65, True),
    (1, 2, 200, 256, False), (2, 2, 1, 64, False), (1, 2, 333, 128, False),
    (2, 2, 2110, 64, True), (1, 2, 4000, 64, True),
    (1, 2, 2110, 128, True)])
def test_flash_attention_backward_kernel_edges(cuda, dtype, B, H, L, D,
                                               transposed):
    """K2B alone: one launch a call, two calls bit-equal, every gradient
    within ``GRAD_TOL`` of the plain backward on the inputs in f32."""
    q, k, v = (a.to(dtype) for a in _qkv(cuda, B, H, L, D, seed=L + D))
    g = torch.Generator(device=cuda).manual_seed(8)
    if transposed:
        dout = torch.randn(B, L, H, D, generator=g, device=cuda).to(
            dtype).transpose(1, 2)
    else:
        dout = torch.randn(B, H, L, D, generator=g, device=cuda).to(dtype)
    row = attention_backward_row(dout, q, k, v, reps=0)
    assert row["route"] == ("fma" if dtype == torch.float32 else
                            "wgmma" if D in (64, 128) else "mma_sync")
    assert row["launches_per_call"] == 1 and row["deterministic"]
    assert row["within_tol"], row


def test_train_step_on_the_card(cuda, tmp_path):
    """A few steps of the trainer on the card in bf16 with self-conditioning
    on every step: K1 launched 2 x 5 times and K2 2 times per step, K1B 5
    times and K2B once (the self-conditioning forward takes no gradient),
    the loss finite, a checkpoint written."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline
    tt = importlib.import_module(
        "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
        ".training.train")
    ds = pipeline.synthetic_dataset(8, segment_len=1024, fs=1024,
                                    device="cuda")
    cfg = tt.TrainConfig(epochs=2, batch_size=4, base_ch=16, time_dim=32,
                         depth=2, use_attention=True, pred_type="v",
                         p_selfcond=1.0, t_min_frac=0.0, warmup_steps=2,
                         model_dir=str(tmp_path))
    reset_launch_counts()
    out = tt.train(cfg, dataset=ds, device="cuda")
    # the self-conditioning forwards take K1's epilogue
    assert launch_counts() == _counts(4 * 10, 4 * 2, 4 * 5, 4, 4 * 5,
                                      head=4)
    assert all(np.isfinite(h["avg_per_sample"]) for h in out["history"])
    assert os.path.exists(out["checkpoint"]) and int(out["state"].step) == 4


def test_seeded_normal_on_the_card(cuda):
    seed = torch.tensor(11, dtype=torch.int32)
    a = seeded_normal(seed, 0, [4, 1, 300], torch.float32, cuda)
    assert a.is_cuda and a.shape == (4, 1, 300)
    assert torch.equal(a, seeded_normal(seed, 0, [4, 1, 300], torch.float32,
                                        cuda))
    assert not torch.equal(a, seeded_normal(seed, 1, [4, 1, 300],
                                            torch.float32, cuda))
    assert abs(a.mean().item()) < 0.2 and abs(a.std().item() - 1) < 0.2


def _grid_corpus(path, n_per_cell=2, L=512, fs=4096.0):
    """A 2 x 2 mass-grid ``.npz`` corpus of chirps in white noise, the
    model PSD given by its grid scalars."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io

    rng = np.random.default_rng(5)
    t = np.arange(L) / fs
    sig, noisy, meta = [], [], {k: [] for k in (
        "mass1", "mass2", "snr", "psd_len", "psd_df", "psd_f_lower")}
    for m1, m2 in ((30.0, 20.0), (30.0, 25.0), (40.0, 20.0), (40.0, 25.0)):
        for i in range(n_per_cell):
            f = 30.0 + 200.0 * (t / t[-1]) ** 3
            clean = 1e-21 * np.sin(2 * np.pi * np.cumsum(f) / fs)
            sig.append(clean)
            noisy.append(clean + 1e-21 * rng.standard_normal(L))
            for k, v in (("mass1", m1), ("mass2", m2), ("snr", 8.0 + i),
                         ("psd_len", L // 2 + 1), ("psd_df", fs / L),
                         ("psd_f_lower", 20.0)):
                meta[k].append(v)
    hdf5io.save_corpus_npz(path, sig, noisy, meta, fs)


@pytest.mark.parametrize("use_attention", [False, True])
def test_eval_indices_on_the_card_matches_cpu(cuda, tmp_path, use_attention):
    """``eval_indices`` of a small f32 checkpoint on the card (2 seeds, MF
    calibration, chunks of 3) against the CPU plain path with the same
    injected noise: every per-sample metric within 1e-3 (max-abs
    normalised), K1 (5 per forward) and K2 (1 per forward) counted."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import grid as grid_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.evals import grid, sweep
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import (
        FixedNoise,
    )

    path, npz = str(tmp_path / "ck.msgpack"), str(tmp_path / "c.npz")
    _small_checkpoint(cuda, path, use_attention)
    _grid_corpus(npz)
    z = {}

    def draws(shape):
        if tuple(shape) not in z:
            z[tuple(shape)] = torch.randn(*shape, generator=torch.Generator()
                                          .manual_seed(len(z)))
        return FixedNoise(z[tuple(shape)])

    rows = {}
    for dev in ("cuda", "cpu"):
        model, schedule, ck = inference.load_model(path, device=dev)
        preps = sweep.prep_samples(npz, list(range(8)), ck, path, True,
                                   "model", "std")
        args = grid_cli.build_parser().parse_args(
            ["--input-h5", npz, "--model", path, "--steps", "3",
             "--start-t", "999", "--avg-seeds", "2", "--amp-calib", "mf",
             "--eval-scan-cap", "3", "--cfg-scale", "1.5", "--whiten", "1",
             "--whiten-mode", "model", "--sigma-mode", "std",
             "--sigma-fixed", "1"])
        reset_launch_counts()
        rows[dev] = grid.eval_indices(args, model, schedule, ck, preps, draws,
                                      device=dev)
        if dev == "cuda":
            n = len(build_t_schedule(1000, 3, 999)) * 3
            assert launch_counts() == _counts(5 * n, n * use_attention,
                                              epilogue=5 * n, head=n)
    for k in ("corr", "mae_norm", "unc_rel", "mf_ratio", "res_std_ratio"):
        got = np.array([r[k] for r in rows["cuda"]])
        want = np.array([r[k] for r in rows["cpu"]])
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), k


@pytest.mark.parametrize("use_attention", [False, True])
def test_distill_step_gradients_on_the_card(cuda, use_attention, monkeypatch):
    """One distillation step's f32 gradients on the card, kernel path
    against plain path (the ops swapped for their plain versions), with
    injected segments and noise: within 1e-3 max-abs normalised; the
    kernel path launches K1 5 x 3 and K2 3 times (two CFG-doubled teacher
    forwards and the student's)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        make_schedule,
    )

    tt = importlib.import_module(
        "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
        ".training.train")
    td = importlib.import_module(
        "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
        ".training.distill")
    kw = dict(in_ch=7, base_ch=16, time_dim=32, depth=2, cond_in_ch=5,
              use_selfcond=True, use_attention=use_attention)
    g = torch.Generator(device=cuda).manual_seed(1)
    B, L = 4, 1024
    batch = {"clean": 0.3 * torch.randn(B, 1, L, generator=g, device=cuda),
             "noisy": torch.randn(B, 1, L, generator=g, device=cuda),
             "sigma": torch.ones(B, device=cuda),
             "mask": torch.ones(B, 1, L, device=cuda),
             "meta": torch.rand(B, 4, generator=g, device=cuda),
             "j_inject": torch.tensor([0, 1, 2, 3], device=cuda),
             "eps0_inject": torch.randn(B, 1, L, generator=g, device=cuda)}
    schedule = make_schedule(1000)
    cfg = td.DistillConfig(teacher="", data="", cfg_scale=1.5)
    ladder = td._teacher_ladder(schedule, 4, "lambda", 999)

    def grads(plain):
        torch.manual_seed(2)
        student = unet.UNet1D(**kw, device=cuda)
        teacher = unet.UNet1D(**kw, device=cuda)
        with torch.no_grad():
            for p in list(student.parameters()) + list(teacher.parameters()):
                p.normal_(0.0, 0.2)
        flat = tt.FlatParams(student, cuda)
        opt = tt.ClipAdamW(td.distill_lr_schedule(1e-4, 100), 1.0, 0.0)
        state = tt.TrainState(params=flat, ema_params=flat.flat.clone(),
                              opt_state=opt.init(flat.flat),
                              step=torch.zeros((), dtype=torch.int32,
                                               device=cuda))
        step = td.make_distill_step(student, schedule, cfg, opt, ladder, "v")
        if plain:
            monkeypatch.setattr(unet, "fused_conv_gn_silu",
                                fused_conv_gn_silu_reference)
            monkeypatch.setattr(unet, "flash_attention",
                                flash_attention_reference)
            monkeypatch.setattr(unet, "unet_head", unet_head_plain)
        reset_launch_counts()
        m = step(state, teacher, batch, 3)
        torch.cuda.synchronize()
        return float(m["loss"]), flat.grad.clone(), launch_counts()

    lk, gk, ck = grads(False)
    lp, gp, cp = grads(True)
    # the teacher's two forwards take K1's epilogue and the head kernel,
    # the student's not
    assert ck == _counts(15, 3 * use_attention, 5, use_attention, 10,
                         head=2)
    assert cp == _counts()
    assert abs(lk - lp) <= 1e-3 * abs(lp)
    assert (gk - gp).abs().max().item() <= 1e-3 * gp.abs().max().item()


def test_grid_cli_on_the_card(cuda, tmp_path):
    """``gw-grid`` with ``--device cuda`` on an ``.npz`` corpus: every CSV
    and JSON written, 4 cells, K1 launched 5 times per ladder step."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import grid as grid_cli

    path, npz = str(tmp_path / "ck.msgpack"), str(tmp_path / "c.npz")
    _small_checkpoint(cuda, path)
    _grid_corpus(npz)
    out = tmp_path / "grid"
    reset_launch_counts()
    res = grid_cli.main(["--input-h5", npz, "--model", path, "--outdir",
                         str(out), "--steps", "3", "--start-t", "999",
                         "--avg-seeds", "2", "--device", "cuda"])
    n = len(build_t_schedule(1000, 3, 999))
    assert launch_counts() == _counts(5 * n, epilogue=5 * n, head=n)
    assert {"per_index_metrics.csv", "metrics_grid.csv", "metrics_grid.json",
            "summary.json"} <= set(os.listdir(out))
    assert res["summary"]["n_cells"] == 4 and res["scan_caps"] == {512: 8}
    assert np.isfinite(res["summary"]["corr_macro_mean"])


def test_tiled_apply_kernel_path_matches_plain_path(cuda, monkeypatch):
    """An attention U-Net (f32) over L 3000 in tiles of 1024 with the
    default halo (4 x 30 = 120): one forward of 3 tiles x 2 rows, whose
    bottleneck is a ragged 316 tokens; kernel path against plain path, K1
    launched 5 and K2 once."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel.seqtile import (
        tiled_apply,
    )

    model = unet.UNet1D(in_ch=7, base_ch=16, time_dim=32, depth=2,
                        cond_in_ch=5, use_selfcond=True, use_attention=True,
                        device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g, device=cuda))
        x = torch.randn(2, 7, 3000, generator=g, device=cuda)
        t = torch.tensor([10, 900], device=cuda)
        reset_launch_counts()
        got = tiled_apply(model, x, t, chunk=1024)
        assert launch_counts() == _counts(5, 1, epilogue=5, head=1)
        monkeypatch.setattr(unet, "fused_conv_gn_silu",
                            fused_conv_gn_silu_reference)
        monkeypatch.setattr(unet, "flash_attention", flash_attention_reference)
        want = tiled_apply(model, x, t, chunk=1024)
    assert got.shape == (2, 1, 3000)
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-4   # f32: summation order through five blocks


def _dp_train_parts(device, base_ch=16):
    tt = importlib.import_module(
        "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
        ".training.train")
    cfg = tt.TrainConfig(batch_size=8, base_ch=base_ch, time_dim=32, depth=2,
                         use_attention=True, pred_type="v", bf16=False,
                         t_min_frac=0.0, warmup_steps=2)
    model, schedule, opt, lr, state, _ = tt.build_model_and_state(
        cfg, 4, 10, 5, device)
    with torch.no_grad():
        g = torch.Generator().manual_seed(4)
        state.params.flat.copy_(0.2 * torch.randn(state.params.flat.shape,
                                                  generator=g))
    return tt, cfg, model, schedule, opt, lr, state


def _dp_batch(device):
    g = torch.Generator().manual_seed(6)
    B, L = 8, 1024
    b = {"clean": 0.3 * torch.randn(B, 1, L, generator=g),
         "noisy": torch.randn(B, 1, L, generator=g),
         "sigma": torch.rand(B, generator=g) + 0.5,
         "mask": torch.ones(B, 1, L),
         "meta": torch.rand(B, 4, generator=g),
         "t_inject": torch.randint(0, 1000, (B,), generator=g),
         "eps_inject": torch.randn(B, 1, L, generator=g)}
    return {k: v.to(device) for k, v in b.items()}


def _dp_rank(rank, port, queue, tp=False):
    """A rank of the two-rank gloo group on the card: two f32 steps on its
    rows of the global batch (the second with a NaN in rank 1's rows); with
    ``tp`` on a 1x2 tensor-parallel mesh at base_ch 32 (every block and
    the two-head attention split), all rows on both ranks."""
    import torch.distributed as dist

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel import mesh as pmesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    cuda = torch.device("cuda", 0)
    tt, cfg, model, schedule, opt, lr, state = _dp_train_parts(
        cuda, 32 if tp else 16)
    mesh = pmesh.make_mesh(n_data=1, n_model=2) if tp else pmesh.make_mesh()
    step = tt.make_train_step(model, schedule, cfg, opt, lr, mesh)
    batch = _dp_batch(cuda)
    m = step(state, batch, 11, 0, 0.0, 1.0)
    bad = dict(batch, clean=batch["clean"].clone())
    bad["clean"][6, 0, 5] = float("nan")
    m_bad = step(state, bad, 12, 0, 0.0, 1.0)
    # numpy, not tensors: a tensor goes through a file descriptor that
    # dies with this process
    queue.put({"rank": rank, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "ok_bad": bool(m_bad["ok"]),
               "flat": state.params.flat.cpu().numpy()})
    queue.close()
    queue.join_thread()
    dist.barrier()
    sys.stdout.flush()
    os._exit(0)      # no interpreter teardown after gloo


@pytest.mark.parametrize("tp", [False, True], ids=["data", "tensor"])
def test_data_parallel_step_on_two_gloo_ranks(cuda, tp):
    """Two ranks sharing the card (gloo: NCCL takes one rank a device), 4
    rows each of a global batch of 8 with injected t and eps (or, tensor
    parallel, all 8 rows and half of each split block's channels and of
    the attention's heads): the loss, the gradient norm and the parameters
    of the single-process step within 1e-4 (f32, summation order), equal
    on both ranks; a NaN in rank 1's rows is refused on both."""
    import torch.multiprocessing as mp

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    q = mp.get_context("spawn").Queue()
    procs = mp.start_processes(_dp_rank, args=(port, q, tp), nprocs=2,
                               join=False, start_method="spawn")
    got = []
    while len(got) < 2:
        try:
            got.append(q.get(timeout=5))
        except queue_mod.Empty:
            procs.join(timeout=0)       # raises if a rank failed
    while not procs.join():
        pass
    r0, r1 = sorted(got, key=lambda r: r["rank"])
    tt, cfg, model, schedule, opt, lr, state = _dp_train_parts(
        cuda, 32 if tp else 16)
    m = tt.make_train_step(model, schedule, cfg, opt, lr)(
        state, _dp_batch(cuda), 11, 0, 0.0, 1.0)
    want = state.params.flat.cpu().numpy()
    for r in (r0, r1):
        assert abs(r["loss"] - float(m["loss"])) <= 1e-4 * abs(float(m["loss"]))
        assert abs(r["grad_norm"] - float(m["grad_norm"])) <= 1e-4 * float(
            m["grad_norm"])
        assert not r["ok_bad"]
        assert np.abs(r["flat"] - want).max() <= 1e-4
    np.testing.assert_array_equal(r0["flat"], r1["flat"])


def test_nccl_one_rank_group(cuda):
    """A one-process NCCL group: the collectives run on the card, and a
    train step through the mesh equals the step without one bit for bit
    (NCCL's average over one rank is the identity)."""
    import torch.distributed as dist

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel import mesh as pmesh

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = pmesh.make_mesh()
        assert dist.get_backend(mesh.group) == "nccl"
        x = torch.arange(6.0, device=cuda).reshape(3, 2)
        assert torch.equal(pmesh.mean_(mesh, x.clone()), x)
        assert torch.equal(pmesh.gather_rows(mesh, x), x)
        flats = []
        for mesh_ in (mesh, None):
            tt, cfg, model, schedule, opt, lr, state = _dp_train_parts(cuda)
            tt.make_train_step(model, schedule, cfg, opt, lr, mesh_)(
                state, _dp_batch(cuda), 11, 0, 0.0, 1.0)
            flats.append(state.params.flat)
        assert torch.equal(flats[0], flats[1])
    finally:
        dist.destroy_process_group()


def test_welch_psd_on_the_card_matches_cpu(cuda):
    """``welch_psd`` of scaled strain on the card against the CPU: within
    1e-5 of each row's largest bin (float32 FFTs in another order)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.whiten import (
        welch_psd,
    )

    y = torch.randn(8, 16384, generator=torch.Generator().manual_seed(3))
    for detrend in ("constant", "none"):
        f_c, P_c = welch_psd(y, 4096.0, nperseg=4096, detrend=detrend)
        f_g, P_g = welch_psd(y.to(cuda), 4096.0, nperseg=4096,
                             detrend=detrend)
        assert P_g.is_cuda and torch.equal(f_g.cpu(), f_c)
        err = (P_g.cpu() - P_c).abs().amax(-1) / P_c.amax(-1)
        assert float(err.max()) <= 1e-5


def test_generate_chunk_on_the_card_matches_cpu(cuda, monkeypatch):
    """One gw-gen chunk synthesised on the card and on the CPU from the
    same injected normal draws: signal within 3e-3 of its peak (the bar
    against JAX; the phase is float64 on both), noise and PSD within 1e-5."""
    import argparse

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import gen

    rng = np.random.default_rng(2)
    specs = [dict(m1=float(a), m2=float(b), s1=float(c), s2=-0.2,
                  snr=float(d)) for a, b, c, d in zip(
        rng.uniform(22, 30, 6), rng.uniform(12, 20, 6),
        rng.uniform(-0.8, 0.8, 6), rng.uniform(8, 30, 6))]
    args = argparse.Namespace(sampling_rate=4096, f_lower=20.0, distance=410.0,
                              approximant="pn", ringdown="qnm",
                              f_taper_frac=0.85, chunk=4, seed=1,
                              device="cuda")

    def normals(seed, device):
        """Draws made on the CPU, then moved: the same on both runs."""
        g = torch.Generator().manual_seed(seed)
        return lambda rows, nf: tuple(
            torch.randn(rows, nf, generator=g).to(device) for _ in range(2))

    monkeypatch.setattr(gen, "_normals", normals)
    on_cpu = gen.generate(specs, args, "cpu")
    on_card = gen.generate(specs, args, "cuda")
    for i, want in on_cpu.items():
        got = on_card[i]
        assert got["n"] == want["n"]
        peak = np.abs(want["signal"]).max()
        assert np.abs(got["signal"] - want["signal"]).max() <= 3e-3 * peak
        for k in ("noise", "psd"):
            assert (np.abs(got[k] - want[k]).max()
                    <= 1e-5 * np.abs(want[k]).max()), k


def test_streaming_chunks_resident_on_the_card(cuda, tmp_path):
    """A ragged twin streamed through ``iter_batches_device`` on the card:
    the host streaming batches bit for bit, no copy in the second epoch;
    ``prefetch_to_device`` through the side stream gives the same."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline as dpipe

    rng = np.random.default_rng(4)
    lengths = [300, 700, 512, 1000, 260, 900, 640]
    sig = [rng.normal(size=L).astype(np.float32) for L in lengths]
    path = str(tmp_path / "r.npz")
    hdf5io.write_dataset(path, sig, sig, [2 * s for s in sig],
                         [np.arange(L) / 1024.0 for L in lengths],
                         {"mass1": [30.0] * 7, "mass2": [20.0] * 7}, 1024.0)
    kw = dict(whiten=True, chunk=2, cache_chunks=1)
    want = list(dpipe.StreamingDataset(path, **kw).iter_batches(
        2, np.random.default_rng(3)))
    ds = dpipe.StreamingDataset(path, **kw)
    got = list(ds.iter_batches_device(2, np.random.default_rng(3)))
    assert ds.h2d_bytes_epoch > 0
    pre = list(dpipe.prefetch_to_device(iter(want), device=cuda))
    for g, p, w in zip(got, pre, want):
        for k in ("clean", "noisy", "mask", "sigma", "meta"):
            assert g[k].is_cuda and p[k].is_cuda
            np.testing.assert_array_equal(g[k].cpu().numpy(), w[k])
            np.testing.assert_array_equal(p[k].cpu().numpy(), w[k])
    list(ds.iter_batches_device(2, np.random.default_rng(4)))
    assert ds.h2d_bytes_epoch == 0


# the tools' new shapes: K1 at bench_population's forward (B 256 x CFG =
# 512 rows) at each of the reference-default U-Net's 7 ConvBlock shapes
# (L, Cin, Cout), where rows x L x 3 Cin in bytes passes 2^31
POP_BLOCKS = [(4096, 7, 64), (2048, 64, 128), (1024, 128, 256),
              (512, 256, 256), (1024, 512, 256), (2048, 384, 128),
              (4096, 192, 64)]


@pytest.mark.parametrize("L,Cin,Cout", POP_BLOCKS)
def test_kernel_at_the_population_batch(cuda, L, Cin, Cout):
    x, W, b, s, bb = _block_inputs(cuda, 512, L, Cin, Cout, seed=L + Cin)
    x = x.to(torch.bfloat16)
    out = fused_conv_gn_silu(x, W, b, s, bb, 8)
    want = fused_conv_gn_silu_reference(x, W, b, s, bb, 8)
    torch.testing.assert_close(out.float(), want.float(),
                               **TOL[torch.bfloat16])


def test_flash_attention_at_the_unet_bench_bottleneck(cuda):
    # bench_kernels' attention U-Net at B 64, L 4096: K2 at (64, 4, 512, 64)
    q, k, v = _qkv(cuda, 64, 4, 512, 64, seed=5)
    assert attention_route(q, k, v) == "wgmma"
    _assert_within_p_rounding(flash_attention(q, k, v), q, k, v)


def test_bench_population_small_on_the_card_matches_cpu(cuda):
    """The tool's population call in f32 (B 4, L 512, 3 steps) on the card
    and on the CPU from the same weights, conditioning and x_T: within
    1e-3 of the largest output (summation order through 7 blocks x 3
    forwards)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import (
        FixedNoise,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools import (
        bench_population as bp,
    )

    g = torch.Generator().manual_seed(3)
    cond = torch.randn(4, 5, 512, generator=g)
    z = torch.randn(4, 1, 512, generator=g)
    outs = {}
    for dev in ("cpu", "cuda"):
        model, schedule, _ = bp.setup(4, 512, dev, dtype=torch.float32)
        outs[dev] = bp.population(model, schedule, cond.to(dev), 3,
                                  FixedNoise(z)).cpu()
    err = (outs["cuda"] - outs["cpu"]).abs().max() / outs["cpu"].abs().max()
    assert float(err) <= 1e-3


def test_pn_chirp_long_on_the_card_matches_cpu(cuda):
    """65536-sample chirps (low masses, spins, 4096 Hz): the float64 phase
    and the converged inversion agree card against CPU within 1e-5 of the
    peak (one ulp more on a log moves them under 1e-6:
    ``test_torch_port_synth.py::test_pn_chirp_inversion_converges``)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pn

    rng = np.random.default_rng(0)
    params = [torch.tensor(rng.uniform(lo, hi, 6), dtype=torch.float32)
              for lo, hi in ((10, 20), (10, 20), (-0.8, 0.8), (-0.8, 0.8))]
    kw = dict(n=65536, fs=4096, f_taper_frac=0.85)
    on_cpu = pn.pn_chirp(*params, **kw)
    on_card = pn.pn_chirp(*(p.to(cuda) for p in params), **kw).cpu()
    assert on_card.dtype == torch.float32
    err = ((on_card - on_cpu).abs().amax(-1) / on_cpu.abs().amax(-1)).max()
    assert float(err) <= 1e-5


# K1 at a rank's share of attn16k's ConvBlocks under tensor parallelism
# (tp 2: Cout / 2 with 4 of the 8 groups), (L, Cin, Cout / 2): enc0 on
# mma.sync (Cin 7), the rest on wgmma; dec2's 32 output channels fill half
# of wgmma's 64-channel N tile
TP_BLOCKS = [(32768, 7, 32), (16384, 64, 64), (8192, 128, 128),
             (4096, 256, 128), (8192, 512, 128), (16384, 384, 64),
             (32768, 192, 32)]


@pytest.mark.parametrize("L,Cin,Cout", TP_BLOCKS)
def test_kernel_at_the_tensor_parallel_shards(cuda, L, Cin, Cout):
    x, W, b, s, bb = _block_inputs(cuda, 2, L, Cin, Cout, seed=L + Cout)
    x = x.to(torch.bfloat16)
    assert conv_route(x) == ("wgmma" if Cin % 8 == 0 else "mma_sync")
    out = fused_conv_gn_silu(x, W, b, s, bb, 4)
    want = fused_conv_gn_silu_reference(x, W, b, s, bb, 4)
    torch.testing.assert_close(out.float(), want.float(),
                               **TOL[torch.bfloat16])


def test_flash_attention_at_the_tensor_parallel_heads(cuda):
    # attn16k's bottleneck with its 4 heads split over 2 ranks
    q, k, v = _qkv(cuda, 2, 2, 4096, 64, seed=9)
    assert attention_route(q, k, v) == "wgmma"
    _assert_within_p_rounding(flash_attention(q, k, v), q, k, v)
