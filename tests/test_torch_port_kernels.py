"""The fused ConvBlock of the PyTorch port against the JAX package's Pallas
kernel (interpret mode on the CPU), and the CPU routing of its wrapper."""
import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops.pallas.fused import (
    fused_conv_gn_silu as jax_fused_conv_gn_silu,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
    _build,
    conv3_same,
    conv_route,
    fused_conv_gn_silu,
    fused_conv_gn_silu_reference,
    launch_counts,
    pack_weights_reference,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
    conv_gn_silu as k1,
)


def _inputs(B, L, Cin, Cout, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, Cin)).astype(np.float32)
    W = (0.1 * rng.standard_normal((3, Cin, Cout))).astype(np.float32)
    b = (0.1 * rng.standard_normal(Cout)).astype(np.float32)
    s = (1.1 + 0.1 * rng.standard_normal(Cout)).astype(np.float32)
    bb = (0.05 + 0.1 * rng.standard_normal(Cout)).astype(np.float32)
    return x, W, b, s, bb


# the JAX package's kernel-test shapes, plus an odd length that leaves a
# ragged last tile in the CUDA kernel's 64-row tiling
@pytest.mark.parametrize("B,L,Cin,Cout,g", [(2, 256, 24, 32, 8),
                                            (1, 128, 7, 16, 8),
                                            (2, 333, 7, 24, 8)])
def test_reference_matches_pallas_kernel(B, L, Cin, Cout, g):
    args = _inputs(B, L, Cin, Cout)
    want = np.asarray(jax_fused_conv_gn_silu(*args, g, interpret=True))
    got = fused_conv_gn_silu_reference(*(torch.from_numpy(a) for a in args), g)
    # the kernel bar of the JAX package's own Pallas tests: f32, the same
    # function, summed in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_runs_plain_version(dtype):
    x, W, b, s, bb = (torch.from_numpy(a) for a in _inputs(2, 130, 7, 16))
    x = x.to(dtype)
    before = launch_counts()["conv_gn_silu"]
    out = fused_conv_gn_silu(x, W, b, s, bb, 8)
    want = fused_conv_gn_silu_reference(x, W, b, s, bb, 8)
    assert out.dtype == dtype and out.shape == (2, 130, 16)
    # the same function on the same tensors: bit-identical
    assert torch.equal(out, want)
    assert launch_counts()["conv_gn_silu"] == before   # no kernel launched


def test_wrapper_refuses_other_devices():
    x = torch.empty((1, 8, 4), device="meta")
    W = torch.empty((3, 4, 8), device="meta")
    v = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_conv_gn_silu(x, W, v, v, v, 8)


def test_build_names_library_by_source_digest(tmp_path, monkeypatch):
    assert (_build.CSRC / "conv_gn_silu.cu").is_file()
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    src.write_text("// two\n")
    second = _build.library_path("k")
    assert second != first                       # an edit forces a rebuild
    assert first.parent == _build.BUILD_DIR
    header = tmp_path / "shared.cuh"
    header.write_text("// helpers\n")
    third = _build.library_path("k")
    assert third != second                       # so does a new header
    header.write_text("// helpers, edited\n")
    fourth = _build.library_path("k")
    assert fourth != third                       # and an edited one
    (tmp_path / "notes.txt").write_text("not a source")
    assert _build.library_path("k") == fourth    # other files do not count


@pytest.mark.parametrize("Cin,Cout", [(7, 16), (40, 24), (64, 64), (130, 72)])
def test_packed_weights_give_the_conv_tap_by_tap(Cin, Cout):
    x, W, b, _, _ = (torch.from_numpy(a) for a in _inputs(2, 37, Cin, Cout))
    x = x.to(torch.bfloat16).float()
    Wp = pack_weights_reference(W)
    cout_pad, cin_pad = -(-Cout // 64) * 64, -(-Cin // 64) * 64
    assert Wp.dtype == torch.bfloat16 and Wp.shape == (cout_pad, 3, cin_pad)
    assert not Wp[Cout:].any() and not Wp[:, :, Cin:].any()   # zero padding
    # the kernel's product: per tap t, rows l - 1 + t of x against the
    # K-major (Cout, Cin) slice of the pack, SAME padding by zero rows
    xp = torch.nn.functional.pad(x, (0, cin_pad - Cin, 1, 1))
    L = x.shape[1]
    got = sum(xp[:, t:t + L] @ Wp[:Cout, t].float().T for t in range(3)) + b
    want = conv3_same(x, W.to(torch.bfloat16).float(), b)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Cin,route", [(7, "mma_sync"), (8, "wgmma"),
                                       (40, "wgmma"), (64, "wgmma")])
def test_conv_route_follows_cin(Cin, route):
    assert conv_route(torch.zeros(2, 16, Cin, dtype=torch.bfloat16)) == route
    assert conv_route(torch.zeros(2, 16, Cin)) == "fma"


def test_conv_route_needs_an_aligned_base():
    n = 2 * 16 * 64
    buf = torch.zeros(8 + n, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    x = buf[1:1 + n].view(2, 16, 64)      # 2 bytes past an aligned base
    assert conv_route(x) == "mma_sync"
    assert conv_route(buf[8:].view(2, 16, 64)) == "wgmma"   # 16 bytes past


def _good(B=1, L=8, Cin=8, Cout=16, device="cpu"):
    return [torch.zeros(B, L, Cin, device=device),
            torch.zeros(3, Cin, Cout, device=device),
            torch.zeros(Cout, device=device), torch.zeros(Cout, device=device),
            torch.zeros(Cout, device=device), 8]


def _bad(case):
    a = _good()
    if case == "x_rank":
        a[0] = a[0][0]
    elif case == "W_cin":
        a[1] = torch.zeros(3, 4, 16)
    elif case == "bias_shape":
        a[2] = torch.zeros(8)
    elif case == "groups":
        a[5] = 3
    elif case == "too_long":
        a = _good(L=k1.MAX_L + 1, device="meta")
    elif case == "x_half":
        a[0] = a[0].half()
    elif case == "W_bf16":
        a[1] = a[1].to(torch.bfloat16)
    elif case == "x_strided":
        a[0] = torch.zeros(1, 8, 16)[:, :, ::2]
    elif case == "W_device":
        a[1] = a[1].to("meta")
    return a


@pytest.mark.parametrize("case,exc", [
    ("x_rank", ValueError), ("W_cin", ValueError), ("bias_shape", ValueError),
    ("groups", ValueError), ("too_long", ValueError), ("x_half", TypeError),
    ("W_bf16", TypeError), ("x_strided", ValueError),
    ("W_device", ValueError)])
def test_check_refuses_what_the_kernel_does_not_take(case, exc):
    k1._check(*_good())                      # the good arguments pass
    with pytest.raises(exc):
        k1._check(*_bad(case))
