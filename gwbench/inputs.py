"""What the benchmark makes from ``--seed``: the weights and the
measurements of a reconstruction cell.

Everything is drawn on the device in a few large calls from generators
seeded by :func:`mix` of the run's seed and a tag, so one seed gives the
same inputs on every run, and no input depends on the program.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict

import torch

from .reference import architecture

_MASK64 = (1 << 64) - 1
# G M_sun / c^3 in seconds
T_SUN = 4.925491025543576e-06


def _splitmix(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def mix(seed: int, *tags) -> int:
    """A 63-bit seed from the run's seed and tags (ints or strings)."""
    z = _splitmix(int(seed) & _MASK64)
    for tag in tags:
        v = zlib.crc32(tag.encode()) if isinstance(tag, str) else int(tag)
        z = _splitmix(z ^ (v & _MASK64))
    return z >> 1


def _gen(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *tags))


def weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of the ``model`` block's architecture (its plain
    reference's ``parameter_shapes``), float32 on ``device``, as views of
    one buffer drawn in one call, by the name's end: ``kernel`` N(0, 1 /
    fan_in) (fan_in all but the last axis), ``scale`` (the norms' scales)
    1 + N(0, 0.1^2), any other (the biases) N(0, 0.1^2)."""
    shapes = architecture(model).parameter_shapes(model)
    sizes = [math.prod(s) for s in shapes.values()]
    mult, add = [], []
    for name, shape in shapes.items():
        if name.endswith("kernel"):
            mult.append(1.0 / math.sqrt(math.prod(shape[:-1])))
            add.append(0.0)
        elif name.endswith("scale"):
            mult.append(0.1)
            add.append(1.0)
        else:
            mult.append(0.1)
            add.append(0.0)
    n = torch.tensor(sizes, device=device)
    z = torch.randn(sum(sizes), generator=_gen(device, seed, "weights"),
                    device=device)
    flat = (z * torch.tensor(mult, device=device).repeat_interleave(n)
            + torch.tensor(add, device=device).repeat_interleave(n))
    out, off = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        out[name] = flat[off:off + size].view(shape)
        off += size
    return out


def chirps(n: int, L: int, fs: float, seed: int, tag: str, device,
           meta_mass: float = 80.0) -> Dict[str, torch.Tensor]:
    """``n`` whitened measurements of length ``L`` at ``fs``: a leading-order
    inspiral chirp (masses 20-50 M_sun, coalescence 60-90% into the segment,
    amplitude growing as f^(2/3), ending at 4400 / M Hz or 0.45 fs) scaled to
    a matched-filter SNR of 8-30 in unit white noise.  Returns ``clean``
    and ``noisy`` (n, 1, L), ``sigma`` (n,) (the noisy rows' std) and
    ``meta`` (n, 4): m1 / 80, m2 / 80 and two spins in [0, 0.5)."""
    g = _gen(device, seed, tag)
    u = torch.rand((n, 7), generator=g, device=device, dtype=torch.float64)
    a, b = 20.0 + 30.0 * u[:, 0], 20.0 + 30.0 * u[:, 1]
    m1, m2 = torch.maximum(a, b), torch.minimum(a, b)
    snr = 8.0 + 22.0 * u[:, 2]
    dur = L / fs
    tc = dur * (0.6 + 0.3 * u[:, 3])
    phi0 = 2 * math.pi * u[:, 4]
    mc = (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2 * T_SUN
    t = torch.arange(L, device=device, dtype=torch.float64) / fs
    tau = (tc[:, None] - t[None, :]).clamp(min=1e-4)
    f = (1.0 / math.pi) * (5.0 / (256.0 * tau)) ** 0.375 \
        * mc[:, None] ** -0.625
    f_end = torch.minimum(4400.0 / (m1 + m2),
                          torch.full_like(m1, 0.45 * fs))[:, None]
    on = (t[None, :] < tc[:, None]) & (f < f_end)
    f = torch.where(on, f, torch.zeros_like(f))
    phase = phi0[:, None] + 2 * math.pi * torch.cumsum(f, dim=1) / fs
    s = torch.where(on, (f / f_end) ** (2.0 / 3.0) * torch.cos(phase),
                    torch.zeros_like(f))
    s = s * (snr / s.norm(dim=1).clamp(min=1e-12))[:, None]
    noise = torch.randn((n, L), generator=g, device=device,
                        dtype=torch.float64)
    noisy = s + noise
    meta = torch.stack([m1 / meta_mass, m2 / meta_mass, 0.5 * u[:, 5],
                        0.5 * u[:, 6]], dim=1)
    return {"clean": s.float()[:, None, :], "noisy": noisy.float()[:, None, :],
            "sigma": noisy.std(dim=1, unbiased=False).float(),
            "meta": meta.float()}


def cond_stacks(m: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The host's serving input of measurements: the sigma-normalised y
    beside the metadata channels, (n, 5, L) float32."""
    y = m["noisy"] / m["sigma"][:, None, None]
    L = y.shape[-1]
    return torch.cat([y, m["meta"][:, :, None].expand(-1, -1, L)], dim=1)


def call_seed(seed: int, i: int) -> int:
    """The serving seed of call ``i``: a nonnegative int32."""
    return mix(seed, "call", i) & 0x7FFFFFFF
