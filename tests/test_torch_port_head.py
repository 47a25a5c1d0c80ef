"""The U-Net's head on the CPU: ``unet_head``'s plain version and the
U-Net's composition against the materialised conv (``conv3_same`` on
``[fix_len(h, L0) | x_t]``), the wrapper's choice of path, the model
against JAX through both paths, and what ``torch.export`` records of the head on the card (fake
CUDA tensors: the op's fake gives the output, nothing is launched).  The
kernel itself runs in ``tests/test_torch_port_cuda.py`` (``-k head``)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode

from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
    conv3_same,
    fix_len,
    head_route,
    launch_counts,
    unet_head,
    unet_head_composition,
    unet_head_plain,
    unet_head_reference,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import serving as tsrv
from test_torch_port_unet import REL_TOL, SMALL, model_pair, rel_err

# the module (the package's ``unet_head`` is the wrapper)
head_module = importlib.import_module(
    "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
    ".ops.kernels.unet_head")


def _inputs(B, Lh, C, L0, Cin=7, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(B, Lh, C, generator=g).to(dtype)
    x = torch.randn(B, L0, Cin, generator=g).to(dtype)
    W = torch.randn(3, C + 1, 1, generator=g) / (3 * (C + 1)) ** 0.5
    b = 0.1 * torch.randn(1, generator=g)
    return h, x, W, b


def _materialised_conv(h, x, W, b):
    hx = torch.cat([fix_len(h, x.shape[1]), x[:, :, :1]], dim=-1)
    return conv3_same(hx, W, b).transpose(1, 2)


# (B, L_h, C, L0): L_h equal to, below (fix_len's pad) and above (its
# crop) L0; C a multiple of 8, ragged, and one channel
@pytest.mark.parametrize("B,Lh,C,L0", [
    (2, 64, 16, 64), (2, 60, 16, 64), (2, 70, 16, 64), (3, 33, 13, 33),
    (1, 5, 1, 7)])
def test_plain_version_is_the_materialised_conv_in_f32(B, Lh, C, L0):
    h, x, W, b = _inputs(B, Lh, C, L0)
    got = unet_head_reference(h, x, W, b)
    want = _materialised_conv(h, x, W, b)
    assert got.shape == (B, 1, L0) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(unet_head_composition(h, x, W, b), want,
                               rtol=0, atol=1e-6)


def test_plain_version_rounds_once_in_bf16():
    """bf16: W rounded to bf16, the products summed in f32 with the f32
    bias, one rounding; the composition rounds its product and then the
    sum with the bias rounded to bf16, so the two differ by bf16 ulps."""

    h, x, W, b = _inputs(2, 64, 16, 64, dtype=torch.bfloat16)
    got = unet_head_reference(h, x, W, b)
    exact = _materialised_conv(h.float(), x.float(),
                               W.bfloat16().float(), b)
    assert got.dtype == torch.float32
    assert torch.equal(got, exact.bfloat16().float())
    comp = unet_head_composition(h, x, W, b)
    torch.testing.assert_close(comp, got, rtol=2 ** -6, atol=2 ** -6)


def test_wrapper_picks_the_path_and_launches_nothing_here(monkeypatch):
    """No-grad: the plain version; recorded: the composition, whose
    gradients are the materialised conv's.  The CPU launches nothing."""
    h, x, W, b = _inputs(2, 32, 8, 32)
    seen = []
    monkeypatch.setattr(head_module, "unet_head_reference",
                        lambda *a: seen.append("plain") or
                        unet_head_reference(*a))
    monkeypatch.setattr(head_module, "unet_head_composition",
                        lambda *a: seen.append("composition") or
                        unet_head_composition(*a))
    before = launch_counts()
    assert "unet_head" in before
    with torch.no_grad():
        out = unet_head(h, x, W, b)
    assert seen == ["plain"]
    Wg = W.clone().requires_grad_()
    got = unet_head(h, x, Wg, b)
    assert seen == ["plain", "composition"] and got.requires_grad
    torch.testing.assert_close(got, out, rtol=0, atol=1e-6)
    (gW,) = torch.autograd.grad(got.square().sum(), Wg)
    Wr = W.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        _materialised_conv(h, x, Wr, b).square().sum(), Wr)
    torch.testing.assert_close(gW, want)
    assert launch_counts() == before


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "recorded"])
def test_model_matches_jax_through_either_head(grad):
    """The U-Net's output against JAX's at the port's f32 module bar, with
    the head on its plain version (no grad) and on the composition
    (recorded)."""
    jm, params, tm = model_pair(256, **SMALL)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, SMALL["in_ch"], 256)).astype(np.float32)
    t = np.array([3, 811], np.int32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                        jnp.asarray(t)))
    with torch.set_grad_enabled(grad):
        got = tm(torch.from_numpy(x), torch.from_numpy(t))
    assert got.requires_grad == grad
    assert rel_err(got.detach(), want) <= REL_TOL


def test_plain_kernels_swaps_the_head():
    head = unet.unet_head
    with unet.plain_kernels():
        assert unet.unet_head is unet_head_plain
    assert unet.unet_head is head is unet_head


class _Head(nn.Module):
    """The U-Net's head call as its forward hands it over."""

    def forward(self, h, x, W, b):
        return unet_head(h, x, W, b)


def test_export_records_the_head_op_on_cuda_tensors():
    """``torch.export`` of the head on (fake) CUDA tensors holds one
    ``gwport::unet_head`` node, which the artifact's op count reads; the
    fake gives the (B, 1, L0) f32 output and nothing is launched."""
    before = launch_counts()
    with FakeTensorMode():
        bf = dict(dtype=torch.bfloat16, device="cuda")
        args = (torch.empty(2, 64, 16, **bf), torch.empty(2, 64, 7, **bf),
                torch.empty(3, 17, 1, device="cuda"),
                torch.empty(1, device="cuda"))
        out = unet_head(*args)
        assert (tuple(out.shape), out.dtype, out.device.type) == (
            (2, 1, 64), torch.float32, "cuda")
        ep = torch.export.export(_Head(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets == ["gwport.unet_head.default"]
    assert tsrv._op_counts(ep)["unet_head"] == 1
    assert launch_counts() == before


def test_route_and_checks():
    """16-byte loads where C fills whole vectors (8 bf16, 4 f32), element
    loads else; the CUDA path's checks refuse what the kernel does not
    take, and a device that is neither CPU nor CUDA."""
    assert head_route(torch.empty(1, 4, 64, dtype=torch.bfloat16)) == "vector"
    assert head_route(torch.empty(1, 4, 12, dtype=torch.bfloat16)) == "scalar"
    assert head_route(torch.empty(1, 4, 12)) == "vector"
    assert head_route(torch.empty(1, 4, 13)) == "scalar"
    h, x, W, b = _inputs(2, 32, 8, 32)
    with pytest.raises(ValueError, match=r"W must be \(3, 9, 1\)"):
        head_module._check(h, x, W[:, :8], b)
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        head_module._check(h, x.bfloat16(), W, b)
    with pytest.raises(ValueError, match="contiguous"):
        head_module._check(h.transpose(0, 1).contiguous().transpose(0, 1),
                           x, W, b)
    with pytest.raises(ValueError, match="cpu or cuda"):
        unet_head(h.to("meta"), x.to("meta"), W.to("meta"), b.to("meta"))


def test_bench_kernels_head_section_on_the_cpu():
    """The kernel table's head row at a small shape: on the CPU the wrapper
    runs the plain version, so the row checks the plumbing."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools import bench_kernels as tbk

    (row,) = tbk.bench_head("cpu", shapes=[(2, 64, 16, 7)], reps=1)
    assert (row["kernel"], row["shape"], row["route"]) == (
        "unet_head_bf16", [2, 64, 16, 7], "vector")
    assert row["within_tol"] and row["max_abs_err"] == 0.0
    assert row["n_outside_composition_tol"] == 0
    assert row["bound_ms"] is None and row["kernel_ms"] > 0
    assert row["mbytes"] == pytest.approx((2 * 64 * 17 * 2 + 52 * 4
                                           + 2 * 64 * 4) / 1e6)
