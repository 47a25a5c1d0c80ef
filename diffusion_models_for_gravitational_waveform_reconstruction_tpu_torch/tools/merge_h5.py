"""Back-compat shim: corpus concatenation lives in the port's ``gw-merge``
(``cli/merge.py``); the port's twin of the root ``tools/merge_h5.py``.

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.merge_h5 OUT IN1 IN2 ...

HDF5 files (which need h5py) or ``.npz`` twins, by suffix, as ``gw-merge``
takes them.  Nothing runs on a device.
"""
from __future__ import annotations

import sys

from ..cli.merge import merge


def main(out_path: str, in_paths: list) -> None:
    n = merge(out_path, in_paths)
    print(f"[merge] wrote {n} samples -> {out_path}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
