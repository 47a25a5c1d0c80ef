"""The flash-attention wrapper's choice of route and its refusals, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_port_cuda.py``);
what the wrapper decides before a launch is plain Python and is held here.
"""
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
    attention_route,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels.flash_attention import (
    MAX_HEAD_DIM,
    ROUTES,
    _check,
)


@pytest.mark.parametrize("D", [32, 64, 65, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_route_follows_dtype_and_head_dim(dtype, D):
    q = torch.zeros(2, 4, 16, D, dtype=dtype)
    if dtype == torch.float32:
        want = "fma"
    else:
        want = "wgmma" if D in (64, 128) else "mma_sync"
    assert attention_route(q) == want
    assert attention_route(q, q.clone(), q.clone()) == want


def _aligned_and_shifted(shape):
    """A bf16 tensor of ``shape`` on a 16-byte aligned base, and the same
    shape one element (2 bytes) past it."""
    n = torch.Size(shape).numel()
    buf = torch.zeros(8 + n, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    return buf[:n].view(shape), buf[1:1 + n].view(shape)


@pytest.mark.parametrize("misaligned", ["none", "q", "k", "v"])
@pytest.mark.parametrize("D", [64, 128])
def test_attention_route_needs_every_base_aligned(misaligned, D):
    shape = (1, 2, 8, D)
    aligned, shifted = _aligned_and_shifted(shape)
    qkv = {name: (shifted if name == misaligned else aligned.clone())
           for name in ("q", "k", "v")}
    want = "wgmma" if misaligned == "none" else "mma_sync"
    assert attention_route(qkv["q"], qkv["k"], qkv["v"]) == want


def test_routes_name_the_c_interface_codes():
    assert ROUTES == {"fma": 0, "mma_sync": 1, "wgmma": 2}


def _good(B=1, H=2, L=8, D=64, device="cpu"):
    return [torch.zeros(B, H, L, D, device=device) for _ in range(3)]


def _bad(case):
    q, k, v = _good()
    if case == "q_rank":
        q = q[0]
    elif case == "k_shape":
        k = torch.zeros(1, 2, 9, 64)
    elif case == "v_shape":
        v = torch.zeros(1, 2, 8, 32)
    elif case == "too_many_heads":
        q, k, v = _good(B=65536, H=1, device="meta")
    elif case == "empty_L":
        q, k, v = _good(L=0)
    elif case == "too_wide":
        q, k, v = _good(D=MAX_HEAD_DIM + 1)
    elif case == "q_half":
        q, k, v = (a.half() for a in (q, k, v))
    elif case == "k_dtype":
        k = k.to(torch.bfloat16)
    elif case == "v_device":
        v = v.to("meta")
    elif case == "q_strided":
        q = torch.zeros(1, 2, 64, 8).transpose(2, 3)
    return q, k, v


@pytest.mark.parametrize("case,exc", [
    ("q_rank", ValueError), ("k_shape", ValueError), ("v_shape", ValueError),
    ("too_many_heads", ValueError), ("empty_L", ValueError),
    ("too_wide", ValueError), ("q_half", TypeError), ("k_dtype", TypeError),
    ("v_device", ValueError), ("q_strided", ValueError)])
def test_check_refuses_what_the_kernel_does_not_take(case, exc):
    _check(*_good())                      # the good arguments pass
    with pytest.raises(exc):
        _check(*_bad(case))
