"""K1B and K2B, the port's backward kernels of the fused ConvBlock and of
flash attention, on the CPU: each kernel's algorithm written out step by
step (``fused_conv_gn_silu_backward_passes``,
``flash_attention_backward_tiled``) against ``jax.vjp`` of the JAX
package's plain expressions, which its trainer differentiates; the dx
weight pack, the fixed summation order and the dW runs the kernel shares
with its step-by-step version; and the CPU routing of the two wrappers."""
import importlib

import jax
import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops.pallas.attention import (
    flash_attention_reference as jax_attention,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops.pallas.fused import (
    fused_conv_gn_silu_reference as jax_conv_block,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
    flash_attention_grad,
    fused_conv_gn_silu_grad,
    launch_counts,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_kernels import (
    grads_against,
)

_PKG = "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
k1 = importlib.import_module(f"{_PKG}.ops.kernels.conv_gn_silu")
k2 = importlib.import_module(f"{_PKG}.ops.kernels.flash_attention")

def _assert_grads_close(got, want, dtype, zero=()):
    """Every gradient within ``GRAD_TOL``: f32, the kernel bar of the JAX
    package's Pallas tests (rtol 2e-4, atol 2e-5); bf16, within 2^-6 of
    the gradient's largest element (``_grads_close`` of the card tests).
    ``zero``: the gradients that are zero in exact arithmetic."""
    want = [torch.from_numpy(np.array(w, np.float32)) for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    err = grads_against(got, want, str(dtype).split(".")[1], zero)
    assert err["n_outside_tol"] == 0, err


def _block(B, L, Cin, Cout, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, Cin)).astype(np.float32)
    W = (rng.standard_normal((3, Cin, Cout)) / np.sqrt(3 * Cin)).astype(
        np.float32)
    b, s, bb = (0.1 * rng.standard_normal(Cout).astype(np.float32)
                for _ in range(3))
    dout = rng.standard_normal((B, L, Cout)).astype(np.float32)
    # the values the kernel sees: x and dout in its dtype, the rest f32
    x, dout = (torch.from_numpy(a).to(dtype) for a in (x, dout))
    return x, torch.from_numpy(W), torch.from_numpy(b), \
        torch.from_numpy(s + 1.0), torch.from_numpy(bb), dout


# Cin 7 (the input block) and 16; one channel per group (C 8); a
# tensor-parallel rank's share (Cout 64 / 2 with 8 / 2 groups); each L
# ragged across the 64-row tiles
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,Cin,Cout,G", [(2, 130, 7, 16, 8),
                                            (2, 100, 16, 24, 8),
                                            (1, 70, 16, 8, 8),
                                            (2, 75, 16, 32, 4)])
def test_k1b_passes_match_jax_vjp(dtype, B, L, Cin, Cout, G):
    x, W, b, s, bb, dout = _block(B, L, Cin, Cout, dtype, seed=L + Cin)
    got = k1.fused_conv_gn_silu_backward_passes(dout, x, W, b, s, bb, G)
    assert got[0].dtype == dtype and all(g.dtype == torch.float32
                                         for g in got[1:])
    args = [a.float().numpy() for a in (x, W, b, s, bb)]
    _, vjp = jax.vjp(lambda *a: jax_conv_block(*a, G), *args)
    want = vjp(dout.float().numpy())
    # db is zero in exact arithmetic with one channel a group
    _assert_grads_close(got, want, dtype, zero=(2,) if Cout == G else ())


# L ragged across the 128-row tiles (130, 200), below one tile (50), and
# D 128 (two 64-column boxes)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,L,D", [(1, 2, 100, 16), (2, 2, 130, 64),
                                     (1, 2, 200, 32), (2, 1, 50, 64),
                                     (1, 2, 150, 128)])
def test_k2b_tiled_matches_jax_vjp(dtype, B, H, L, D):
    rng = np.random.default_rng(L + D)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (B, H, L, D)).astype(np.float32)).to(dtype) for _ in range(4))
    out = k2.flash_attention_reference(q, k, v)
    got = k2.flash_attention_backward_tiled(dout, q, k, v, out)
    assert all(g.dtype == dtype for g in got)
    _, vjp = jax.vjp(jax_attention, *(a.float().numpy() for a in (q, k, v)))
    _assert_grads_close(got, vjp(dout.float().numpy()), dtype)


def test_step_versions_match_plain_backwards_in_f32():
    # the kernels' algorithms and the plain backwards are one function
    x, W, b, s, bb, dout = _block(2, 99, 7, 16, torch.float32, seed=5)
    _assert_grads_close(
        k1.fused_conv_gn_silu_backward_passes(dout, x, W, b, s, bb, 4),
        k1.fused_conv_gn_silu_backward(dout, x, W, b, s, bb, 4),
        torch.float32)
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(1, 2, 90, 32, generator=g) for _ in range(4))
    out = k2.flash_attention_reference(q, k, v)
    _assert_grads_close(k2.flash_attention_backward_tiled(do, q, k, v, out),
                        k2.flash_attention_backward(do, q, k, v, out),
                        torch.float32)


def test_dx_pack_flips_and_transposes_the_taps():
    W = torch.randn(3, 7, 24)
    Wp = k1.pack_dx_weights_reference(W)
    assert Wp.shape == k1.pack_shape(24, 7) == (64, 3, 64)
    assert Wp.dtype == torch.bfloat16
    for tap in range(3):
        # dx's tap `tap` is W's tap 2 - tap, (Cout, Cin) -> [ci][tap][co]
        assert torch.equal(Wp[:7, tap, :24],
                           W[2 - tap].to(torch.bfloat16))
    assert not Wp[7:].any() and not Wp[:, :, 24:].any()


def test_sum_rows_takes_the_kernel_order():
    # k1b_sum_rows: lane j of a column sums rows j, j + 8, ... in turn,
    # then the lanes in order; f32 addition is not associative, so the
    # order is visible in the bits
    rng = np.random.default_rng(2)
    part = (rng.standard_normal((3, 21, 5)) * 10.0 ** rng.integers(
        -4, 5, (3, 21, 5))).astype(np.float32)
    lanes = np.zeros((3, 8, 5), np.float32)
    for t in range(21):
        lanes[:, t % 8] = lanes[:, t % 8] + part[:, t]
    want = lanes[:, 0].copy()
    for j in range(1, 8):
        want = want + lanes[:, j]
    got = k1._sum_rows(torch.from_numpy(part)).numpy()
    np.testing.assert_array_equal(got, want)


# a run is whole dW tiles of 64 rows of one sample: L ragged across them
# over several samples (3, 100), attn16k's widest blocks on the wgmma route
@pytest.mark.parametrize("B,L,Cin,Cout", [(16, 32768, 7, 64),
                                          (16, 4096, 256, 256),
                                          (1, 1, 7, 8), (2, 130, 7, 16),
                                          (3, 100, 64, 64),
                                          (16, 8192, 512, 256)])
def test_dw_runs_cover_the_rows(B, L, Cin, Cout):
    run = k1.dw_run(B, L, Cin, Cout)
    per_run, tiles = run // k1.DW_STEP, k1.dw_tiles(B, L)
    n_runs = k1.dw_runs(B, L, Cin, Cout)
    assert tiles == B * -(-L // k1.DW_STEP)
    assert run % k1.DW_STEP == 0 and 1 <= n_runs <= 65535
    assert (n_runs - 1) * per_run < tiles <= n_runs * per_run
    assert n_runs * 12 * Cin * Cout <= max(k1.DW_PART_BYTES, 12 * Cin * Cout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_run_the_plain_backwards(dtype):
    x, W, b, s, bb, dout = _block(2, 70, 7, 16, dtype, seed=3)
    before = launch_counts()
    got = fused_conv_gn_silu_grad(dout, x, W, b, s, bb, 8)
    want = k1.fused_conv_gn_silu_backward(dout, x, W, b, s, bb, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, 2, 70, 16, generator=g).to(dtype)
               for _ in range(3))
    out = k2.flash_attention_reference(q, k, v)
    # a transposed dout, as the U-Net's attention hands it back
    do = torch.randn(1, 70, 2, 16, generator=g).to(dtype).transpose(1, 2)
    got = flash_attention_grad(do, q, k, v, out)
    want = k2.flash_attention_backward(do, q, k, v, out)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert launch_counts() == before     # no kernel launched


def test_k2b_route_follows_dtype_width_and_alignment():
    q = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    assert k2.backward_route(q, q, q, q) == "wgmma"
    # the U-Net's transposed dout: strides (L H D, D, H D) are multiples of 8
    assert k2.backward_route(q, q, q, q.transpose(1, 2).contiguous()
                             .transpose(1, 2)) == "wgmma"
    assert k2.backward_route(q.float(), q.float(), q.float(),
                             q.float()) == "fma"
    odd = torch.zeros(1, 2, 64, 65, dtype=torch.bfloat16)
    assert k2.backward_route(odd, odd, odd, odd) == "mma_sync"
    unaligned = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16)[1:]
    unaligned = unaligned.view(1, 2, 64, 64)
    assert k2.backward_route(q, q, q, unaligned) == "mma_sync"
    # the forward's output is read by 16-byte rows too
    assert k2.backward_route(q, q, q, q, out=q) == "wgmma"
    assert k2.backward_route(q, q, q, q, out=unaligned) == "mma_sync"
    wide = torch.zeros(1, 2, 64, 256, dtype=torch.bfloat16)
    assert k2.backward_route(wide, wide, wide, wide) == "mma_sync"
    # D 128 takes the TMA pipeline too, its dout transposed or not
    d128 = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)
    assert k2.backward_route(d128, d128, d128, d128) == "wgmma"
    assert k2.backward_route(d128, d128, d128, d128.transpose(1, 2)
                             .contiguous().transpose(1, 2)) == "wgmma"
    # a dout sliced from a wider tensor: rows 2 D apart, still multiples of 8
    sliced = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)[..., :64]
    assert k2.backward_route(q, q, q, sliced) == "wgmma"


def test_k1b_dw_route_follows_dtype_and_widths():
    # dW on wgmma where TMA maps both x and dy (Cin % 8 == 0, Cout % 8 ==
    # 0); the input block's 7 channels keep mma.sync; f32 the FMA units
    x = torch.zeros(1, 64, 16, dtype=torch.bfloat16)
    assert k1.dw_route(x, 24) == "wgmma"
    assert k1.dw_route(x, 12) == "mma_sync"
    assert k1.dw_route(torch.zeros(1, 64, 7, dtype=torch.bfloat16),
                       64) == "mma_sync"
    assert k1.dw_route(x.float(), 64) == "fma"
    unaligned = torch.zeros(1 * 64 * 16 + 1, dtype=torch.bfloat16)[1:]
    assert k1.dw_route(unaligned.view(1, 64, 16), 64) == "mma_sync"


def test_backward_wrappers_refuse_other_devices():
    x = torch.empty((1, 8, 4), device="meta")
    W = torch.empty((3, 4, 8), device="meta")
    c = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_conv_gn_silu_grad(torch.empty((1, 8, 8), device="meta"), x, W,
                                c, c, c, 8)
    q = torch.empty((1, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention_grad(q, q, q, q, q)
