"""Tiled U-Net evaluation of very long segments (counterpart of the JAX
package's ``parallel/seqtile.py``).

The sequence is cut into fixed-size chunks with a halo on each side; the
tiles run through the U-Net as rows of one batch (tile-major: row i*B + b
is tile i of sample b), their halos are cropped and the interiors joined:

      x (B, C, L)  ->  tiles (n*B, C, halo+chunk+halo)  ->  one forward
                   ->  crop halos, concatenate           ->  (B, 1, L)

With a mesh the tile rows are spread over the data axis: each rank runs
its tiles and every rank gathers the outputs.  A model axis splits nothing
here: each of its ranks runs its data index's tiles through the whole
model.

Every U-Net op is local (k=3 convs, pool 2, nearest upsample, linear cond
resizes) with a finite receptive field, so with ``halo`` >=
:func:`receptive_field_radius` each tile's interior is exact but for two
approximations, the same as in the JAX package: GroupNorm statistics are
taken per tile, and the bottleneck attention of an attention checkpoint
becomes windowed attention over the tile and its halos (the default halo
is widened 4x for attention models).  Both are measured against the
monolithic forward, not assumed.

JAX evaluates ``model.apply(params, ...)``; the port's module holds its
weights, so :func:`tiled_apply` takes the model alone.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import mesh as pmesh


def receptive_field_radius(depth: int, kernel: int = 3) -> int:
    """Conservative one-sided receptive field of UNet1D in input samples:
    each ConvBlock at scale s adds (kernel // 2) * 2^s, the head and the
    resize windows one more window, all doubled for safety."""
    r = 0
    for s in range(depth + 1):            # encoder convs + mid
        r += (kernel // 2) * (2 ** s)
    for s in reversed(range(depth)):      # decoder convs
        r += (kernel // 2) * (2 ** s)
    r += kernel // 2 + 2 ** depth         # final head + resize windows
    return 2 * r


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tiled_apply(model, x: torch.Tensor, t: torch.Tensor, chunk: int = 16384,
                halo: Optional[int] = None, mesh=None) -> torch.Tensor:
    """``model(x, t)`` over an arbitrarily long L (x (B, C, L), t (B,)) in
    fixed-size tiles; returns (B, 1, L).

    ``chunk`` and ``halo`` are rounded up to multiples of 2^depth so that
    pooling boundaries align.  Without ``mesh`` all tiles run as one forward
    on x's device; with it the tile axis is padded with zero tiles to a
    multiple of the data axis, each rank runs its share of the tiles and
    the rows are gathered (the dummy tiles dropped)."""
    if mesh is not None:
        pmesh.check_mesh(mesh)
    B, C, L = x.shape
    depth = int(getattr(model, "depth", 3))
    align = 2 ** depth
    chunk = _round_up(min(chunk, _round_up(L, align)), align)
    if halo is None:
        halo = receptive_field_radius(depth, int(getattr(model, "kernel", 3)))
        if getattr(model, "use_attention", False):
            halo *= 4                     # halo-windowed attention
    halo = _round_up(halo, align)

    n = -(-L // chunk)
    L_pad = n * chunk
    # left padding keeps the merger at the end; halo margins on both sides
    x_p = F.pad(x, (L_pad - L + halo, halo))
    W = chunk + 2 * halo
    tiles = torch.stack([x_p[:, :, i * chunk:i * chunk + W]
                         for i in range(n)])              # (n, B, C, W)

    n_padded = n
    if mesh is not None:
        n_padded = _round_up(n, mesh.n_data)
        if n_padded > n:
            tiles = torch.cat([tiles, tiles.new_zeros(
                (n_padded - n,) + tuple(tiles.shape[1:]))])
        tiles = pmesh.local_rows(mesh, tiles)
    k = tiles.shape[0]
    out = model(tiles.reshape(k * B, C, W), t.repeat(k))  # (k*B, 1, W)
    if mesh is not None:
        out = pmesh.gather_rows(mesh, out)
    out = out.reshape(n_padded, B, 1, W)[:n, :, :, halo:halo + chunk]
    # (n, B, 1, chunk) -> (B, 1, n*chunk), then drop the left tile padding
    out = out.permute(1, 2, 0, 3).reshape(B, 1, L_pad)
    return out[:, :, L_pad - L:]
