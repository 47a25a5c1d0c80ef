"""``gw-merge``: concatenate gw-gen corpora into one file (counterpart of the
JAX package's ``cli/merge.py``).

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli.merge \\
        --output-path merged.npz base.npz topup.npz

HDF5 inputs give an HDF5 output (needs h5py); ``.npz`` twins give a twin,
whose series are ragged where the inputs' lengths differ.  Either way rows
are copied in chunks, so host memory stays bounded; the datasets are those
of every input (the others are dropped, said on stderr); ``sampling_rate``
/ ``delta_t`` must agree; a generator-domain key of ``config_args`` that
differs across inputs is warned about (a deliberate mix is legitimate); the
attributes are the first input's plus ``merged_from``, the provenance.  A
mix of the two containers raises: convert the HDF5 files first with
``data/hdf5io.py::corpus_to_npz``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

import numpy as np

from ..data import hdf5io

CHUNK = hdf5io.CHUNK
# the generator's keys that make a corpus one training domain
DOMAIN_KEYS = ("approximant", "engine", "ringdown", "f_taper_frac",
               "f_lower", "distance")


def _n_rows(f) -> int:
    """The row count; ``lengths`` is optional in the schema."""
    return int((f["lengths"] if "lengths" in f else f["noisy"]).shape[0])


def _check_inputs(ins) -> List[str]:
    """The datasets every input has (in the first input's order), after
    the sampling-rate check and the domain warning."""
    keys = [k for k in ins[0].keys() if all(k in f for f in ins)]
    dropped = sorted(set().union(*[set(f.keys()) for f in ins]) - set(keys))
    if dropped:
        print(f"[merge] dropping keys not present in every input: "
              f"{dropped}", file=sys.stderr)
    for f in ins[1:]:
        for a in ("sampling_rate", "delta_t"):
            if a in ins[0].attrs and a in f.attrs:
                if not np.isclose(float(ins[0].attrs[a]), float(f.attrs[a])):
                    raise ValueError(
                        f"attr {a!r} mismatch across inputs: "
                        f"{float(ins[0].attrs[a])} vs {float(f.attrs[a])}")
    cfgs = []
    for f in ins:
        try:
            cfgs.append(json.loads(str(f.attrs.get("config_args", "{}"))))
        except (TypeError, ValueError):
            cfgs.append({})
    for k in DOMAIN_KEYS:
        vals = [c.get(k) for c in cfgs]
        if any(v is not None and v != vals[0] for v in vals[1:]):
            print(f"[merge] WARNING: generator config {k!r} differs "
                  f"across inputs ({vals}); the merged corpus mixes "
                  f"waveform domains", file=sys.stderr)
    return keys


def _merged_from(in_paths, ins) -> str:
    return json.dumps([{"path": p, "n": _n_rows(f)}
                       for p, f in zip(in_paths, ins)])


def _merge_h5(out_path: str, in_paths: List[str]) -> int:
    h5py = hdf5io._h5py("merging HDF5 corpora", "merging .npz twins")
    ins = [h5py.File(p, "r") for p in in_paths]
    try:
        keys = _check_inputs(ins)
        n_total = sum(_n_rows(f) for f in ins)
        with h5py.File(out_path, "w") as out:
            for k in keys:
                src = ins[0][k]
                if src.dtype == object:
                    row0 = src[0]
                    if isinstance(row0, (bytes, str)):
                        dt = h5py.string_dtype()
                    else:
                        dt = h5py.special_dtype(vlen=row0.dtype)
                else:
                    dt = src.dtype
                d = out.create_dataset(k, shape=(n_total,), dtype=dt)
                off = 0
                for f in ins:
                    n = f[k].shape[0]
                    for lo in range(0, n, CHUNK):
                        hi = min(lo + CHUNK, n)
                        chunk = f[k][lo:hi]
                        try:
                            d[off + lo:off + hi] = chunk
                        except TypeError:
                            # h5py collapses a chunk of equal-length rows
                            # into a 2-D array, which it then cannot assign
                            # to the variable-length dataset: per row
                            for i in range(hi - lo):
                                d[off + lo + i] = chunk[i]
                    off += n
            for a, v in ins[0].attrs.items():
                out.attrs[a] = v
            out.attrs["merged_from"] = _merged_from(in_paths, ins)
        return n_total
    finally:
        for f in ins:
            f.close()


def _rows_of(ds) -> list:
    """Row lengths of a twin's series (ragged or (N, L))."""
    if ds.ragged:
        return ds.lengths.tolist()
    return [ds.shape[1]] * ds.shape[0]


def _chunked_rows(ins, k):
    for f in ins:
        ds = f[k]
        for lo in range(0, ds.shape[0], CHUNK):
            yield from ds[lo:lo + CHUNK]


def _merge_npz(out_path: str, in_paths: List[str]) -> int:
    ins = [hdf5io._NpzCorpus(p) for p in in_paths]
    try:
        keys = _check_inputs(ins)
        with hdf5io._NpzWriter(out_path) as w:
            for k in keys:
                dss = [f[k] for f in ins]
                if all(d.ragged or d.ndim == 2 for d in dss):
                    lengths = [n for d in dss for n in _rows_of(d)]
                    dtype = (dss[0].row_dtype if dss[0].ragged
                             else dss[0].dtype)
                    w.add_series(k, lengths, _chunked_rows(ins, k), dtype)
                elif all(not d.ragged and d.ndim == 1 for d in dss):
                    w.add(k, np.concatenate([d[:] for d in dss]))
                else:
                    raise ValueError(f"dataset {k!r} is a per-sample series "
                                     f"in some inputs and a column in others")
            for a, v in ins[0].attrs.items():
                if a != "merged_from":
                    w.add(a, np.asarray(v))
            w.add("merged_from", np.asarray(_merged_from(in_paths, ins)))
        return sum(_n_rows(f) for f in ins)
    finally:
        for f in ins:
            f.close()


def merge(out_path: str, in_paths: list) -> int:
    """Concatenate ``in_paths`` into ``out_path``; returns the row count."""
    for p in in_paths:
        if os.path.exists(out_path) and os.path.samefile(out_path, p):
            raise ValueError(
                f"--output-path {out_path!r} is also an input; opening it "
                f"for write would truncate the source dataset")
    twins = [hdf5io.is_npz(p) for p in list(in_paths) + [out_path]]
    if any(twins) and not all(twins):
        raise ValueError(
            "gw-merge takes inputs and an output of one container, all HDF5 "
            "or all .npz twins; convert the HDF5 files first with "
            "data.hdf5io.corpus_to_npz (needs h5py)")
    if all(twins):
        return _merge_npz(out_path, in_paths)
    return _merge_h5(out_path, in_paths)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="gw-merge",
        description="Concatenate gw-gen HDF5 datasets or their .npz twins "
                    "(streamed, bounded host RAM).")
    p.add_argument("--output-path", required=True)
    p.add_argument("inputs", nargs="+", help="input .h5 or .npz files, in order")
    args = p.parse_args(argv)
    if len(args.inputs) < 2:
        p.error("need at least two input files")
    n = merge(args.output_path, args.inputs)
    print(f"[merge] wrote {n} samples -> {args.output_path}")


if __name__ == "__main__":
    main()
