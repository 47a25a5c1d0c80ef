"""K1's conditioning epilogue on the CPU: ``fused_conv_gn_silu``'s plain
version with ``film`` against the U-Net's composition of a ConvBlock, its
conditioning bias and FiLM; the checks of what the kernel takes; the
wrapper's choice of path by grad mode, and the U-Net's answers and
gradients on either path; the op's refusal of a backward through the
epilogue; and the
export's count of the op with the epilogue as K1.  The kernel itself is
held against the plain version on the card (``tests/test_torch_port_cuda.py``)."""
from types import SimpleNamespace

import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import serving
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
    fused_conv_gn_silu,
    fused_conv_gn_silu_reference,
    launch_counts,
    unet_head_composition,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import conv_gn_silu as k1
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels.conv_gn_silu import (
    _backward,
    _check_film,
    _setup_context,
    conv_gn_silu_op,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import randomize_

SMALL = dict(in_ch=7, base_ch=8, time_dim=16, depth=2, cond_in_ch=5,
             use_selfcond=True, device="cpu")
BLOCKS = 2 * SMALL["depth"] + 1


def _block_inputs(dtype, B=3, L=40, Cin=7, Cout=16, K=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, L, Cin, generator=g).to(dtype)
    W = torch.randn(3, Cin, Cout, generator=g) / (3 * Cin) ** 0.5
    b, s, bb = (0.1 * torch.randn(Cout, generator=g) for _ in range(3))
    dense = unet.Dense(K, Cout, dtype if dtype != torch.float32 else None)
    with torch.no_grad():
        dense.bias.copy_(0.1 * torch.randn(Cout, generator=g))
    r = torch.randn(B, L, K, generator=g).to(dtype)
    r[0] = 0.0                        # an unconditional row of a CFG batch
    film = (0.3 * torch.randn(B, 2 * Cout, generator=g)).to(dtype)
    return x, W, b, s + 1.0, bb, dense, r, film


@pytest.mark.parametrize("cond", [True, False], ids=["cond", "film_only"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_unet_composition(dtype, cond):
    """Bit-equal to the three steps the U-Net ran after each ConvBlock, in
    their order and dtypes: the block, ``h + Dense(r)``, then FiLM."""
    x, W, b, s, bb, dense, r, film = _block_inputs(dtype)
    with torch.no_grad():
        h = fused_conv_gn_silu_reference(x, W, b, s, bb, 8)
        if cond:
            h = h + dense(r)
        gamma, beta = film.chunk(2, dim=-1)
        want = h * (1.0 + gamma[:, None, :]) + beta[:, None, :]
        got = fused_conv_gn_silu_reference(
            x, W, b, s, bb, 8, film=film,
            **(dict(r=r, Wc=dense.kernel, bc=dense.bias) if cond else {}))
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_runs_the_plain_epilogue(dtype):
    x, W, b, s, bb, dense, r, film = _block_inputs(dtype, seed=1)
    before = launch_counts()
    with torch.no_grad():
        got = fused_conv_gn_silu(x, W, b, s, bb, 8, film=film, r=r,
                                 Wc=dense.kernel, bc=dense.bias)
        want = fused_conv_gn_silu_reference(x, W, b, s, bb, 8, film=film,
                                            r=r, Wc=dense.kernel,
                                            bc=dense.bias)
    assert torch.equal(got, want)
    assert launch_counts() == before         # no kernel launched


def test_epilogue_wrapper_refuses_other_devices():
    x = torch.empty((1, 8, 4), device="meta")
    W = torch.empty((3, 4, 8), device="meta")
    v = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_conv_gn_silu(x, W, v, v, v, 8,
                           film=torch.empty((1, 16), device="meta"))


def _film_case(case):
    """The epilogue's inputs for (B 2, L 10, Cout 16, K 5), one of them
    spoilt as ``case`` says."""
    bf = dict(dtype=torch.bfloat16)
    x = torch.zeros(2, 10, 4, **bf)
    W = torch.zeros(3, 4, 16)
    a = {"film": torch.zeros(2, 32, **bf), "r": torch.zeros(2, 10, 5, **bf),
         "Wc": torch.zeros(5, 16), "bc": torch.zeros(16)}
    if case == "film_shape":
        a["film"] = torch.zeros(2, 16, **bf)
    elif case == "film_dtype":
        a["film"] = a["film"].float()
    elif case == "r_length":
        a["r"] = torch.zeros(2, 9, 5, **bf)
    elif case == "r_strided":
        a["r"] = torch.zeros(2, 10, 7, **bf)[:, :, 1:6]
    elif case == "r_dtype":
        a["r"] = a["r"].float()
    elif case == "Wc_rows":
        a["Wc"] = torch.zeros(4, 16)
    elif case == "Wc_dtype":
        a["Wc"] = a["Wc"].to(torch.bfloat16)
    elif case == "bc_shape":
        a["bc"] = torch.zeros(15)
    elif case == "no_bc":
        a["bc"] = None
    return x, W, a


@pytest.mark.parametrize("case,exc", [
    ("film_shape", ValueError), ("film_dtype", TypeError),
    ("r_length", ValueError), ("r_strided", ValueError),
    ("r_dtype", TypeError), ("Wc_rows", ValueError), ("Wc_dtype", TypeError),
    ("bc_shape", ValueError), ("no_bc", ValueError)])
def test_check_refuses_what_the_epilogue_does_not_take(case, exc):
    x, W, a = _film_case(case)
    with pytest.raises(exc):
        _check_film(x, W, a["film"], a["r"], a["Wc"], a["bc"])


def test_check_takes_the_unets_inputs():
    x, W, a = _film_case(None)
    _check_film(x, W, a["film"], a["r"], a["Wc"], a["bc"])
    _check_film(x, W, a["film"], None, None, None)       # FiLM alone


def _model(seed=0, **kw):
    m = unet.UNet1D(**{**SMALL, **kw})
    randomize_(m, seed)
    return m


def _xt(L=96, in_ch=7, B=2):
    g = torch.Generator().manual_seed(5)
    return torch.randn(B, in_ch, L, generator=g), torch.tensor([3, 800][:B])


@pytest.mark.parametrize("kw", [
    {}, {"dtype": torch.bfloat16}, {"use_attention": True},
    {"in_ch": 2, "cond_in_ch": 0}, {"in_ch": 3, "cond_in_ch": None,
                                    "use_selfcond": None}],
    ids=["f32", "bf16", "attention", "no_cond", "legacy_in_ch3"])
def test_no_grad_forward_equals_the_separate_steps(kw, monkeypatch):
    """On the CPU the epilogue's plain version is the steps it replaces, so
    a no-grad forward answers bit-equal to a recorded one (the separate
    steps), and the JAX parity bars hold unchanged.  The head runs the
    composition that a recorded forward runs in both (a no-grad head rounds
    once in bf16: ``tests/test_torch_port_head.py``)."""
    monkeypatch.setattr(unet, "unet_head", unet_head_composition)
    model = _model(**kw)
    x, t = _xt(in_ch=model.in_ch)
    with torch.no_grad():
        fused = model(x, t)
    separate = model(x, t)
    assert separate.requires_grad
    assert torch.equal(fused, separate.detach())


def _spy(monkeypatch, module=unet, name="fused_conv_gn_silu"):
    """Count the calls of K1 alone and of K1 with the epilogue: by default
    the U-Net's calls of the wrapper; with ``module=k1``, the calls that the
    wrapper issues to K1's plain version, which it runs on the CPU as
    planned."""
    calls = {"plain": 0, "epilogue": 0}
    fn = getattr(module, name)

    def call(*a, **kw):
        calls["plain" if kw.get("film") is None else "epilogue"] += 1
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, call)
    return calls


def _issued(monkeypatch):
    return _spy(monkeypatch, k1, "fused_conv_gn_silu_reference")


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "frozen",
                                  "grad", "input_grad"])
def test_path_follows_grad_mode(mode, monkeypatch):
    """The wrapper issues K1 with the epilogue where autograd does not
    record (no grad mode, or nothing that requires grad), K1 alone and the
    separate steps where it does; the U-Net calls it the same way in every
    mode."""
    model = _model()
    x, t = _xt()
    asked = _spy(monkeypatch)
    calls = _issued(monkeypatch)
    if mode == "no_grad":
        with torch.no_grad():
            model(x, t)
    elif mode == "inference_mode":
        with torch.inference_mode():
            model(x, t)
    elif mode == "frozen":
        model.requires_grad_(False)
        model(x, t)
    elif mode == "grad":
        model(x, t)
    else:
        model.requires_grad_(False)
        model(x.requires_grad_(), t)
    records = mode in ("grad", "input_grad")
    assert calls == {"plain": BLOCKS if records else 0,
                     "epilogue": 0 if records else BLOCKS}
    assert asked == {"plain": 0, "epilogue": BLOCKS}


def test_a_tensor_parallel_block_keeps_the_separate_steps(monkeypatch):
    """A ConvBlock under a model axis runs K1 on its share of the channels,
    so its bias and FiLM stay separate steps at inference too (here a
    one-rank axis, which splits nothing: the same answer)."""
    model = _model()
    x, t = _xt()
    with torch.no_grad():
        want = model(x, t)
        calls = _spy(monkeypatch)
        model.enc1.tp = SimpleNamespace(n_model=1, model_rank=0,
                                        model_group=None)
        got = model(x, t)
    assert calls == {"plain": 1, "epilogue": BLOCKS - 1}
    assert torch.equal(got, want)


def test_recorded_gradients_equal_the_epilogues_composition(monkeypatch):
    """With grad on the wrapper takes the separate steps; the parameters'
    gradients equal those through the epilogue's plain version (the same
    function, which on the CPU autograd can differentiate), issued when the
    wrapper's choice is forced to the no-record one."""
    x, t = _xt()
    model = _model(use_attention=True)

    def grads():
        model.zero_grad()
        model(x, t).square().mean().backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    separate = grads()
    monkeypatch.setattr(k1, "_records", lambda *tensors: False)
    calls = _issued(monkeypatch)
    fused = grads()
    assert calls == {"plain": 0, "epilogue": BLOCKS}
    for name in ("enc0.conv.kernel", "cond_enc0.kernel", "tproj_mid.bias",
                 "cond_dec1.bias", "time_dense.kernel"):
        assert separate[name].abs().sum() > 0, name
    for name, g in separate.items():
        torch.testing.assert_close(fused[name], g, rtol=1e-6, atol=1e-9,
                                   msg=name)


def test_conditioning_is_resized_once_per_stage_length(monkeypatch):
    model = _model()
    x, t = _xt()
    lengths = []
    real = unet._resize_linear

    def resize(c, n):
        lengths.append(n)
        return real(c, n)

    monkeypatch.setattr(unet, "_resize_linear", resize)
    with torch.no_grad():
        model(x, t)
    assert lengths == [96, 48, 24]
    lengths.clear()
    model(x, t)                    # the separate steps share the resizes
    assert lengths == [96, 48, 24]


def test_registered_backward_refuses_the_epilogue():
    """The op's autograd formula: K1B's gradients for K1 alone, and a
    refusal where the launch carried the epilogue (the activation before
    FiLM, which its gradient needs, is never written)."""
    x, W, v = torch.zeros(1, 4, 2), torch.zeros(3, 2, 8), torch.zeros(8)
    ctx = SimpleNamespace(save_for_backward=lambda *t: None)
    _setup_context(ctx, (x, W, v, v, v, 8, 1e-5, torch.zeros(1, 16), None,
                         None, None), None)
    assert ctx.epilogue
    with pytest.raises(RuntimeError, match="no backward"):
        _backward(ctx, torch.zeros(1, 4, 8))
    _setup_context(ctx, (x, W, v, v, v, 8, 1e-5, None, None, None, None),
                   None)
    assert not ctx.epilogue


def test_op_counts_count_the_epilogue_as_k1():
    """``export_sampler``'s count (its CUDA check wants K1's op): an
    exported graph of K1 and K1 with the epilogue holds two K1 nodes."""
    class Blocks(torch.nn.Module):
        def forward(self, x, W, v, film, r, Wc):
            h = conv_gn_silu_op(x, W, v, v, v, 8, 1e-5)
            return conv_gn_silu_op(h, W, v, v, v, 8, 1e-5, film, r, Wc, v)

    meta = dict(device="meta")
    bf = dict(dtype=torch.bfloat16, **meta)
    ep = torch.export.export(Blocks(), (
        torch.empty(2, 16, 8, **bf), torch.empty(3, 8, 8, **meta),
        torch.empty(8, **meta), torch.empty(2, 16, **bf),
        torch.empty(2, 16, 5, **bf), torch.empty(5, 8, **meta)), strict=False)
    assert serving._op_counts(ep) == {"conv_gn_silu": 2, "flash_attention": 0,
                                      "unet_head": 0, "seeded_normal": 0}
