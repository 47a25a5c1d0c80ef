"""Timing entry point of the port: the twin of the root
``__graft_entry__.py``'s ``entry()``.

``entry()`` -> ``(denoise_step, example_args)``: one conditioned eps
prediction and the x0 conversion (the sampler's inner step) on the pn128
flagship (base_ch 128, depth 3, time_dim 128, y + 4 metadata channels and
the self-conditioning slot, bf16), batch 8 of 4096 samples, on the GPU, with
seeded random weights.  ``denoise_step(*example_args)`` returns x0_hat
(8, 1, 4096).  ``dryrun_multichip`` waits for P10 (parallelism).

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.graft_entry
"""
from __future__ import annotations

import torch

from .models.unet import UNet1D
from .ops.schedules import make_schedule
from .utils.device import resolve_device
from .utils.weights import randomize_


def entry(device=None):
    dev = resolve_device(device)
    in_ch, cond_in_ch = 7, 5
    B, L = 8, 4096
    model = UNet1D(in_ch=in_ch, base_ch=128, time_dim=128, depth=3,
                   t_embed_max_time=999.0, cond_in_ch=cond_in_ch,
                   use_selfcond=True, dtype=torch.bfloat16, device=dev).eval()
    randomize_(model, 1)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, in_ch, L), generator=g, device=dev)
    t = torch.zeros((B,), dtype=torch.int64, device=dev)
    alpha_bar = make_schedule(1000, "cosine").alpha_bar.to(dev)

    @torch.no_grad()
    def denoise_step(model, x, t):
        """One conditioned eps-prediction + x0 conversion."""
        eps_hat = model(x, t)
        ab = alpha_bar[t].reshape(-1, 1, 1)
        x_t = x[:, :1, :]
        return (x_t - torch.sqrt(1.0 - ab) * eps_hat) / torch.sqrt(ab)

    return denoise_step, (model, x, t)


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
