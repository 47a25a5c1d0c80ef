"""K1's decoder route on the CPU: ``fused_conv_gn_silu(h, ..., skip=)``,
the decoder block ``conv3([nearest_up2(h) | skip]) -> GN -> SiLU`` read from
the half-length h and the skip as two sources.

Its CPU path is the materialised composition, so it equals the plain
version on the concatenated input bit for bit, with and without the
conditioning epilogue; a skip of another length than twice h's pads or
crops the upsampled h, as the U-Net does.  The kernel's own arithmetic
(``decoder_conv_passes`` from ``pack_decoder_weights_reference``: the
nearest-x2 fold of JAX's ``DecoderConvBlock``, the skip read as (B, L/2,
2 C_s)) agrees with JAX's ``DecoderConvBlock`` in f32 within ``REL_TOL``.
The wrapper takes the route for the U-Net's decoder blocks where autograd
does not record, in bf16, for a skip twice h's length and both channel
counts multiples of 64, and nowhere else; with it the forward is bit-equal
to the materialised one.
The kernel itself runs only on the card (``test_torch_port_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu.models import unet as jax_unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import conv_gn_silu as k1
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
    decoder_conv_passes,
    decoder_input,
    fix_len,
    fused_conv_gn_silu,
    fused_conv_gn_silu_reference,
    group_norm,
    launch_counts,
    pack_decoder_weights_reference,
    takes_decoder_route,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel import mesh as pmesh
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import (
    params_from_flax,
    randomize_,
)
from test_torch_port_unet import REL_TOL, randomize, rel_err


def _inputs(B, Lh, Ch, Cs, Cout, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(B, Lh, Ch, generator=g).to(dtype)
    skip = torch.randn(B, 2 * Lh, Cs, generator=g).to(dtype)
    W = torch.randn(3, Ch + Cs, Cout, generator=g) / (3 * (Ch + Cs)) ** 0.5
    b, s, bb = (0.1 * torch.randn(Cout, generator=g) for _ in range(3))
    epi = dict(film=(0.3 * torch.randn(B, 2 * Cout, generator=g)).to(dtype),
               r=torch.randn(B, 2 * Lh, 5, generator=g).to(dtype),
               Wc=torch.randn(5, Cout, generator=g) / 5 ** 0.5,
               bc=0.1 * torch.randn(Cout, generator=g))
    return h, skip, W, b, s + 1.0, bb, epi


@pytest.mark.parametrize("epilogue", ["none", "film", "cond_film"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_source_plain_version_is_the_materialised_block(dtype,
                                                            epilogue):
    h, skip, W, b, s, bb, epi = _inputs(2, 33, 64, 128, 24, dtype)
    kw = {"none": {}, "film": dict(film=epi["film"]), "cond_film": epi}[
        epilogue]
    got = fused_conv_gn_silu(h, W, b, s, bb, 4, skip=skip, **kw)
    x = torch.cat([fix_len(h.repeat_interleave(2, dim=1), 66), skip],
                  dim=-1)
    want = fused_conv_gn_silu_reference(x, W, b, s, bb, 4, **kw)
    assert got.dtype == dtype and got.shape == (2, 66, 24)
    assert torch.equal(got, want)
    assert torch.equal(decoder_input(h, skip), x)


def test_two_source_plain_version_refuses_other_lengths():
    """A skip of odd length: the upsampled h cropped (65 rows) or
    zero-padded (67) to it, as the U-Net's odd stage lengths need; the
    route's own arithmetic takes exactly twice h's length and refuses
    others."""
    h, skip, W, b, s, bb, _ = _inputs(2, 33, 64, 64, 24)
    up = h.repeat_interleave(2, dim=1)
    for odd, up_odd in (
            (skip[:, :65], up[:, :65]),
            (torch.cat([skip, skip[:, :1]], dim=1),
             torch.cat([up, torch.zeros_like(up[:, :1])], dim=1))):
        x = torch.cat([up_odd, odd], dim=-1)
        assert torch.equal(decoder_input(h, odd), x)
        got = fused_conv_gn_silu(h, W, b, s, bb, 4, skip=odd)
        assert torch.equal(got, fused_conv_gn_silu_reference(x, W, b, s, bb,
                                                             4))
        with pytest.raises(ValueError, match="2 L"):
            decoder_conv_passes(h, odd, W, b, torch.float32)


@pytest.mark.parametrize("Lh,Ch,Cs,Co", [(32, 64, 64, 64), (21, 128, 64, 24),
                                         (1, 64, 192, 16), (32, 16, 8, 8),
                                         (64, 8, 16, 24)])
def test_kernel_arithmetic_matches_jax_decoder_conv_block(Lh, Ch, Cs, Co):
    """The route's conv pass as the kernel walks it (f32 pack), then K1's
    GroupNorm and SiLU, against JAX's ``DecoderConvBlock`` with the same
    parameters, f32; and the conv pass alone against the conv of the
    materialised input.  The plain fold holds at widths the kernel does not
    take (the last two) too."""
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, Lh, Ch)).astype(np.float32)
    skip = rng.standard_normal((2, 2 * Lh, Cs)).astype(np.float32)
    jm = jax_unet.DecoderConvBlock(Co)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(h),
                               jnp.asarray(skip)), 6)
    want = np.asarray(jm.apply(params, jnp.asarray(h), jnp.asarray(skip)))
    block = unet.ConvBlock(Ch + Cs, Co, "cpu")
    block.load_state_dict(params_from_flax(jax.device_get(params)),
                          strict=True)
    th, ts = torch.from_numpy(h), torch.from_numpy(skip)
    W, b = block.conv.kernel.detach(), block.conv.bias.detach()
    y = decoder_conv_passes(th, ts, W, b, torch.float32)
    mat = unet.conv3_same(decoder_input(th, ts), W, b)
    assert rel_err(y.numpy(), mat.numpy()) <= REL_TOL
    g = group_norm(y, block.groups, block.norm.scale.detach(),
                   block.norm.bias.detach())
    got = g * torch.sigmoid(g)
    assert got.shape == want.shape == (2, 2 * Lh, Co)
    assert rel_err(got.numpy(), want) <= REL_TOL


def test_decoder_pack_folds_the_taps_and_rounds_once():
    _, _, W, _, _, _, _ = _inputs(1, 4, 64, 128, 72)
    Wp = pack_decoder_weights_reference(W, 64)
    assert Wp.dtype == torch.bfloat16 and Wp.shape == (128, 4 * 64 + 3 * 128)
    parts = [W[0, :64], W[1, :64] + W[2, :64], W[0, :64] + W[1, :64],
             W[2, :64], W[0, 64:], W[1, 64:], W[2, 64:]]
    want = torch.cat(parts).transpose(0, 1).to(torch.bfloat16)
    assert torch.equal(Wp[:72], want)
    assert not Wp[72:].any()


def _model(base_ch=64, depth=3, dtype=torch.bfloat16):
    m = unet.UNet1D(in_ch=7, base_ch=base_ch, time_dim=32, depth=depth,
                    cond_in_ch=5, use_selfcond=True, dtype=dtype,
                    device="cpu")
    randomize_(m, 1)
    return m


def _routes(monkeypatch, model, L, *, grad=False):
    """The forward's output and, per K1 call that the wrapper issues (to
    the plain version, on the CPU), whether it took the decoder route."""
    calls = []
    plain = k1.fused_conv_gn_silu_reference

    def spy(*a, **kw):
        calls.append(kw.get("skip") is not None)
        return plain(*a, **kw)

    monkeypatch.setattr(k1, "fused_conv_gn_silu_reference", spy)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 7, L, generator=g)
    t = torch.tensor([5, 700])
    with torch.set_grad_enabled(grad):
        out = model(x, t)
    monkeypatch.setattr(k1, "fused_conv_gn_silu_reference", plain)
    return out, calls


def test_unet_route_gives_the_materialised_forward(monkeypatch):
    """Three of the seven K1 calls of a bf16 forward at widths 64-256 take
    the route (the decoder's), and the output is bit-equal to the forward
    with every decoder block materialised."""
    model = _model()
    got, calls = _routes(monkeypatch, model, 64)
    assert calls == [False] * 4 + [True] * 3
    monkeypatch.setattr(k1, "takes_decoder_route", lambda h, s: False)
    want, calls = _routes(monkeypatch, model, 64)
    assert calls == [False] * 7
    assert torch.equal(got, want)


@pytest.mark.parametrize("case,want", [
    ("odd_length", [False] * 3 + [False, True]),   # L 90: h 22, skip 45
    ("autograd", [False] * 5),         # recorded: the blocks' own calls
    ("model_axis", [False] * 5),       # dec0, dec1 through their mesh
    ("f32", [False] * 5),
    ("width_32", [False] * 3 + [True, False]),    # C_s 32 at dec1
    ("width_48", [False] * 5)])                   # C_h, C_s 96
def test_unet_route_is_taken_only_where_it_applies(monkeypatch, case, want):
    """Per K1 call the wrapper issues, whether it took the decoder route,
    for inputs the route does not take: a stage length that ``fix_len`` pads,
    autograd recording, decoder blocks on a model axis, f32, and channel
    counts that are not multiples of 64.  Each forward equals the
    materialised one."""
    base, dtype, L = 64, torch.bfloat16, 64
    if case == "odd_length":
        L = 90
    if case == "f32":
        dtype = torch.float32
    if case.startswith("width"):
        base = int(case[-2:])
    model = _model(base, depth=2, dtype=dtype)
    if case == "model_axis":
        for name in ("dec0", "dec1"):
            getattr(model, name).tp = pmesh.Mesh(1)
    got, calls = _routes(monkeypatch, model, L, grad=case == "autograd")
    assert calls == want
    monkeypatch.setattr(k1, "takes_decoder_route", lambda h, s: False)
    ref, _ = _routes(monkeypatch, model, L, grad=case == "autograd")
    assert torch.equal(got, ref)


def test_takes_decoder_route_reads_the_inputs():
    bf = torch.bfloat16
    h, s = torch.zeros(1, 8, 64, dtype=bf), torch.zeros(1, 16, 128, dtype=bf)
    assert takes_decoder_route(h, s)
    assert not takes_decoder_route(h.float(), s.float())
    assert not takes_decoder_route(h, s[:, :15])
    assert not takes_decoder_route(h[..., :32], s)
    assert not takes_decoder_route(h, s[..., :96])


def test_decoder_counter_is_a_launch_count():
    """``conv_gn_silu_decoder`` is one of ``launch_counts()``; the plain
    version on the CPU launches nothing, so it does not move."""
    before = launch_counts()
    h, skip, W, b, s, bb, _ = _inputs(2, 8, 64, 64, 64, torch.bfloat16)
    fused_conv_gn_silu(h, W, b, s, bb, 8, skip=skip)
    assert "conv_gn_silu_decoder" in before
    assert launch_counts() == before


def test_decoder_route_traces_on_fake_cuda_tensors():
    """The wrapper's CUDA path as ``torch.export`` traces the served sampler
    on the card: on fake CUDA tensors its checks read no data pointer, the
    op's fake implementation gives the output, and nothing is launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = launch_counts()
    with FakeTensorMode(), torch.no_grad():
        cuda = dict(dtype=torch.bfloat16, device="cuda")
        h = torch.empty(2, 64, 64, **cuda)
        skip = torch.empty(2, 128, 128, **cuda)
        W = torch.empty(3, 192, 64, device="cuda")
        b = torch.empty(64, device="cuda")
        out = fused_conv_gn_silu(h, W, b, b, b, 8, skip=skip,
                                 film=torch.empty(2, 128, **cuda),
                                 r=torch.empty(2, 128, 5, **cuda),
                                 Wc=torch.empty(5, 64, device="cuda"), bc=b)
        assert (out.shape, out.dtype, out.device.type) == (
            (2, 128, 64), torch.bfloat16, "cuda")
    assert launch_counts() == before
