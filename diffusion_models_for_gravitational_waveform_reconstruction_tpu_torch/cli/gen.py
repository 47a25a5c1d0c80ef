"""``gw-gen``: generate a corpus of GW waveforms in detector noise, in fixed,
random or grid mode (counterpart of the JAX package's ``cli/gen.py``: the
same flags, defaults, specs, buckets, datasets and attributes).

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli.gen \\
        --mode grid --num-samples 2000 --mass1-min 10 --mass1-max 90 \\
        --mass2-min 10 --mass2-max 90 --grid-steps 9 --snr-min 8 \\
        --snr-max 30 --save-psd --shuffle --output-path data/train.npz

- Specs (probe-and-retry, balanced grid combos, ``--require-complete-grid``,
  symmetric label augmentation, over-generation with a head trim,
  ``--shuffle``) and length buckets are decided on the host in float32
  torch on the CPU, the JAX package's float32 arithmetic, whatever
  ``--device`` is: a sample then lands in the same power-of-two bucket.
- Each bucket is synthesised in chunks of ``--chunk`` samples on
  ``--device`` (default: the GPU, an error without one; ``cpu`` honoured)
  through ``data/synth.py::generate_batch``.  The noise's normal draws of a
  chunk come from one seam, :func:`_normals`: by default one
  ``torch.Generator`` on the device seeded with ``--seed``, which every
  chunk continues (so the port's noise differs from the JAX package's; the
  tests hand JAX's draws through the seam).
- Welch PSDs of the hann window are computed in batches on the device by
  ``ops/whiten.py::welch_psd`` on strain x ``STRAIN_SCALE`` in float32,
  the scale undone in float64; other windows and ``--engine pycbc`` use
  ``scipy.signal.welch`` on the host.
- The output is HDF5 (needs h5py) or, for a path ending in ``.npz``, its
  twin (``data/hdf5io.py``), which the card's machine reads without h5py.

``--engine jax`` names the batched tensor engine (the JAX package's name,
kept so that both packages' corpora carry the same ``engine`` attribute);
``--engine pycbc`` is the host-side SEOBNRv4 path, which needs ``pycbc``.
``--plot`` and ``--psd-preview`` need matplotlib.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# rows a batched Welch call takes
WELCH_ROWS = 256


def build_parser() -> argparse.ArgumentParser:
    class _HelpFmt(argparse.ArgumentDefaultsHelpFormatter,
                   argparse.RawDescriptionHelpFormatter):
        pass

    p = argparse.ArgumentParser(
        prog="gw-gen",
        description=(
            "Generate LIGO-like time-domain GW waveforms and write an HDF5 "
            "dataset (or its .npz twin).\n\nMODES\n"
            "  fixed  : repeat a single (m1, m2, snr, spins) config N times\n"
            "  random : sample (m1, m2, snr, spins) uniformly within ranges\n"
            "  grid   : even grid over (m1, m2); balanced #samples per "
            "unordered pair (m2 <= m1)\n"
        ),
        formatter_class=_HelpFmt,
    )
    g = p.add_argument_group("General")
    g.add_argument("--mode", choices=["fixed", "random", "grid"], default="fixed")
    g.add_argument("--num-samples", type=int, required=True)
    g.add_argument("--output-path", type=str, required=True,
                   help="An .h5 file, or an .npz path for the .npz twin.")
    g.add_argument("--seed", type=int, default=123)
    g.add_argument("--device", type=str, default="cuda",
                   help="Device for synthesis and Welch PSDs: cuda (an "
                        "error without a GPU) or cpu.")
    g.add_argument("--engine", choices=["jax", "pycbc"], default="jax",
                   help="Waveform engine: batched tensor chirps on the "
                        "device ('jax', the JAX package's name for it), or "
                        "host-side PyCBC SEOBNRv4 (requires pycbc).")
    g.add_argument("--ringdown", choices=["qnm", "qnm_c1", "isco"],
                   default="qnm",
                   help="PN-engine post-inspiral model: 'qnm' = Kerr-remnant "
                        "quasi-normal-mode ringdown (NR-fit final mass/spin); "
                        "'qnm_c1' = same physics, C1 attachment (chirp-rate-"
                        "matched blend + ramped decay); 'isco' = damped "
                        "sinusoid at termination.")
    g.add_argument("--f-taper-frac", type=float, default=None,
                   help="< 1: half-Hann turn-on spans [f_taper_frac*f_lower, "
                        "f_lower], completing at the band edge (PN engine). "
                        "Part of the data domain: train and eval must match. "
                        "Default: 0.85 for the PN engine, 1.0 otherwise.")
    g.add_argument("--approximant", choices=["pn", "newtonian"], default="pn",
                   help="Engine waveform model: 'pn' = 3.5PN aligned-spin "
                        "phasing with Kerr-ISCO termination; 'newtonian' = "
                        "0PN chirp.")

    gf = p.add_argument_group("Fixed mode")
    gf.add_argument("--mass1", type=float, default=20.0)
    gf.add_argument("--mass2", type=float, default=20.0)
    gf.add_argument("--snr", type=float, default=8000.0)

    gr = p.add_argument_group("Ranges (random / grid)")
    gr.add_argument("--mass1-min", type=float, default=20.0)
    gr.add_argument("--mass1-max", type=float, default=20.0)
    gr.add_argument("--mass2-min", type=float, default=20.0)
    gr.add_argument("--mass2-max", type=float, default=20.0)
    gr.add_argument("--snr-min", type=float, default=8000.0)
    gr.add_argument("--snr-max", type=float, default=8000.0)
    gr.add_argument("--spin1-min", type=float, default=0.0)
    gr.add_argument("--spin1-max", type=float, default=0.0)
    gr.add_argument("--spin2-min", type=float, default=0.0)
    gr.add_argument("--spin2-max", type=float, default=0.0)

    gg = p.add_argument_group("Grid mode")
    gg.add_argument("--grid-steps", type=int, default=5)
    gg.add_argument("--augment-symmetric", action="store_true")
    gg.add_argument("--shuffle", action="store_true")
    gg.add_argument("--overgen-factor", type=float, default=1.05)
    gg.add_argument("--require-complete-grid", action="store_true")

    gm = p.add_argument_group("Misc")
    gm.add_argument("--plot", action="store_true")
    gm.add_argument("--progress-every", type=int, default=0)
    gm.add_argument("--use-tqdm", action="store_true")
    gm.add_argument("--f-lower", type=float, default=20.0)
    gm.add_argument("--sampling-rate", type=int, default=4096)
    gm.add_argument("--distance", type=float, default=410.0)
    gm.add_argument("--max-seconds", type=float, default=32.0,
                    help="Probe failure threshold on chirp duration.")
    gm.add_argument("--chunk", type=int, default=256,
                    help="On-device generation batch size per bucket chunk.")

    gp = p.add_argument_group("PSD options")
    gp.add_argument("--save-psd", action="store_true")
    gp.add_argument("--psd-source", choices=["model", "welch", "both"],
                    default="both")
    gp.add_argument("--psd-nperseg", type=int, default=4096)
    gp.add_argument("--psd-noverlap", type=int, default=None)
    gp.add_argument("--psd-window", type=str, default="hann")
    gp.add_argument("--psd-preview", type=int, default=0)
    gp.add_argument("--psd-preview-dir", type=str, default=None)
    return p


# ---------------------------------------------------------------------------
# Spec building and buckets (host side, float32 on the CPU)
# ---------------------------------------------------------------------------

def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def chirp_duration_s(m1: float, m2: float, f_lower: float) -> float:
    """Newtonian time to coalescence from f_lower, in seconds."""
    from ..data.synth import MSUN_S, chirp_mass, tau_of_f

    mc_s = float(chirp_mass(_f32(m1), _f32(m2))) * MSUN_S
    return float(tau_of_f(_f32(mc_s), _f32(f_lower)))


def config_duration_s(m1: float, m2: float, f_lower: float,
                      approximant: str = "newtonian",
                      s1: float = 0.0, s2: float = 0.0) -> float:
    """The engine's chirp duration: PN tau (spin-dependent) for the PN
    engine, the Newtonian one otherwise."""
    if approximant == "pn":
        from ..data.pn import pn_duration

        return float(pn_duration(_f32(m1), _f32(m2), _f32(s1), _f32(s2),
                                 f_lower))
    return chirp_duration_s(m1, m2, f_lower)


def probe_config(m1: float, m2: float, f_lower: float, max_seconds: float,
                 approximant: str = "newtonian",
                 s1: float = 0.0, s2: float = 0.0) -> bool:
    """A configuration fails if its ISCO frequency is not above 1.05 x
    f_lower (no in-band inspiral) or its chirp is longer than
    ``max_seconds``."""
    from ..data.synth import isco_frequency

    if float(isco_frequency(_f32(m1), _f32(m2))) <= 1.05 * f_lower:
        return False
    if config_duration_s(m1, m2, f_lower, approximant, s1, s2) > max_seconds:
        return False
    return True


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def padded_pow2_len(dur_s: float, fs: int,
                    t_post: float = 0.05, lead: float = 0.35) -> int:
    """duration -> segment length: + taper lead + ringdown tail, up to a
    power of two (at least 1024)."""
    return max(1024, next_pow2(int(np.ceil((dur_s + lead + t_post) * fs))))


def bucket_length(m1: float, m2: float, f_lower: float, fs: int,
                  t_post: float = 0.05, lead: float = 0.35) -> int:
    """Segment length of a Newtonian chirp."""
    return padded_pow2_len(chirp_duration_s(m1, m2, f_lower), fs,
                           t_post=t_post, lead=lead)


def build_specs(args, rng: np.random.Generator) -> List[dict]:
    """Per-sample generation specs of the three modes, with the numpy
    ``rng`` draws of the JAX package's ``build_specs``."""
    specs: List[dict] = []
    approximant = getattr(args, "approximant", "newtonian")

    if args.mode == "fixed":
        m1, m2 = max(args.mass1, args.mass2), min(args.mass1, args.mass2)
        if not probe_config(m1, m2, args.f_lower, args.max_seconds,
                            approximant):
            raise SystemExit(f"fixed config (m1={m1}, m2={m2}) fails the probe "
                             f"(ISCO vs f_lower or > --max-seconds)")
        for _ in range(args.num_samples):
            specs.append(dict(m1=m1, m2=m2, s1=0.0, s2=0.0, snr=args.snr,
                              label_m1=m1, label_m2=m2,
                              label_s1=0.0, label_s2=0.0))
        return specs

    if args.mode == "random":
        # probe-and-retry, at most 10 attempts a sample; the probe takes the
        # DRAWN spins (aligned spin lengthens the PN chirp)
        attempts_cap = 10 * args.num_samples
        attempts = 0
        while len(specs) < args.num_samples and attempts < attempts_cap:
            attempts += 1
            a = rng.uniform(args.mass1_min, args.mass1_max)
            b = rng.uniform(args.mass2_min, args.mass2_max)
            m1, m2 = max(a, b), min(a, b)
            s1 = rng.uniform(args.spin1_min, args.spin1_max)
            s2 = rng.uniform(args.spin2_min, args.spin2_max)
            if not probe_config(m1, m2, args.f_lower, args.max_seconds,
                                approximant, s1, s2):
                continue
            specs.append(dict(
                m1=m1, m2=m2, s1=s1, s2=s2,
                snr=rng.uniform(args.snr_min, args.snr_max),
                label_m1=m1, label_m2=m2, label_s1=s1, label_s2=s2,
            ))
        if len(specs) < args.num_samples:
            raise SystemExit(
                f"random mode: only {len(specs)}/{args.num_samples} valid "
                f"configs after {attempts} attempts")
        return specs

    # grid mode: each combo is probed at the longest-duration spin corners,
    # so every spin drawn later satisfies --max-seconds
    m1_axis = np.linspace(args.mass1_min, args.mass1_max, args.grid_steps)
    m2_axis = np.linspace(args.mass2_min, args.mass2_max, args.grid_steps)
    combos = [(float(a), float(b)) for a in m1_axis for b in m2_axis if b <= a]
    ok_combos, failed = [], []
    probe_corners = [(0.0, 0.0)] if approximant != "pn" else [
        (args.spin1_min, args.spin2_min), (args.spin1_max, args.spin2_max)]
    for (a, b) in combos:
        ok = all(probe_config(a, b, args.f_lower, args.max_seconds,
                              approximant, s1c, s2c)
                 for (s1c, s2c) in probe_corners)
        (ok_combos if ok else failed).append((a, b))
    if failed:
        msg = f"[gen] {len(failed)}/{len(combos)} grid combos failed probe: " \
              f"{failed[:8]}{'...' if len(failed) > 8 else ''}"
        if args.require_complete_grid:
            raise SystemExit(msg + "  (--require-complete-grid)")
        print(msg)
    if not ok_combos:
        raise SystemExit("grid mode: no valid (m1, m2) combos")

    # balanced counts, the remainder spread over the first combos; with
    # --augment-symmetric the last half of each unequal combo's samples
    # carries swapped (m1, m2) and (s1, s2) labels
    total = int(np.ceil(args.num_samples * args.overgen_factor))
    base, rem = divmod(total, len(ok_combos))
    for ci, (a, b) in enumerate(ok_combos):
        count = base + (1 if ci < rem else 0)
        n_swap = count // 2 if (args.augment_symmetric and a != b) else 0
        for j in range(count):
            s1 = rng.uniform(args.spin1_min, args.spin1_max)
            s2 = rng.uniform(args.spin2_min, args.spin2_max)
            spec = dict(
                m1=a, m2=b, s1=s1, s2=s2,
                snr=rng.uniform(args.snr_min, args.snr_max),
                label_m1=a, label_m2=b, label_s1=s1, label_s2=s2,
            )
            if j >= count - n_swap:
                spec.update(label_m1=b, label_m2=a, label_s1=s2, label_s2=s1)
            specs.append(spec)
    if args.shuffle:
        rng.shuffle(specs)
    return specs


def bucket_specs(specs: List[dict], args) -> Dict[int, List[int]]:
    """{segment length: spec indices}, sorted by length.  The PN engine
    buckets on its own duration from the taper's start frequency
    (min(f_taper_frac, 1) x f_lower), one float32 call; the Newtonian one on
    the Newtonian duration."""
    fs = int(args.sampling_rate)
    by_len: Dict[int, List[int]] = {}
    if getattr(args, "approximant", "pn") == "pn":
        from ..data.pn import pn_duration

        f_size = min(float(getattr(args, "f_taper_frac", 1.0)), 1.0) \
            * args.f_lower
        durs = pn_duration(*(_f32([s[k] for s in specs])
                             for k in ("m1", "m2", "s1", "s2")), f_size)
        for i, d in enumerate(durs.tolist()):
            by_len.setdefault(padded_pow2_len(d, fs), []).append(i)
    else:
        for i, s in enumerate(specs):
            by_len.setdefault(bucket_length(s["m1"], s["m2"], args.f_lower, fs),
                              []).append(i)
    return dict(sorted(by_len.items()))


# ---------------------------------------------------------------------------
# Batched generation on the device
# ---------------------------------------------------------------------------

DrawNormals = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]


def _normals(seed: int, device) -> DrawNormals:
    """The noise draws of a run: ``draw(rows, nf)`` -> (real parts, imaginary
    parts), each (rows, nf) on ``device``, from one ``torch.Generator``
    seeded with ``seed`` that every chunk continues."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return lambda rows, nf: tuple(
        torch.randn((rows, nf), generator=g, device=device) for _ in range(2))


def generate(specs: List[dict], args, device=None) -> Dict[int, dict]:
    """Every spec synthesised on ``device`` (default ``args.device``):
    bucket by bucket in sorted order, chunk by chunk of ``args.chunk``, one
    :func:`_normals` draw and one ``generate_batch`` call a chunk.

    Returns {spec index: dict(signal, noise, noisy float32 physical strain,
    psd float64 physical, n)} on the host."""
    from ..data.synth import PSD_SCALE, SynthConfig, generate_batch
    from ..utils.device import resolve_device

    dev = resolve_device(args.device if device is None else device)
    fs = int(args.sampling_rate)
    draw = _normals(args.seed, dev)
    out: Dict[int, dict] = {}
    for n, idxs in bucket_specs(specs, args).items():
        cfg = SynthConfig(n=n, fs=fs, f_lower=args.f_lower,
                          distance=args.distance,
                          engine=getattr(args, "approximant", "pn"),
                          ringdown=getattr(args, "ringdown", "qnm"),
                          f_taper_frac=float(getattr(args, "f_taper_frac", 1.0)))
        print(f"[gen] bucket n={n} ({n / fs:.2f}s): {len(idxs)} samples")
        for c0 in range(0, len(idxs), args.chunk):
            chunk = idxs[c0:c0 + args.chunk]
            cols = [torch.tensor([specs[i][k] for i in chunk],
                                 dtype=torch.float32, device=dev)
                    for k in ("m1", "m2", "snr", "s1", "s2")]
            res = generate_batch(None, *cols, config=cfg,
                                 normals=draw(len(chunk), n // 2 + 1))
            sig, noi, nsy = (res[k].cpu().numpy()
                             for k in ("signal", "noise", "noisy"))
            # one curve for the whole bucket, physical, float64
            psd = res["psd"][0].cpu().numpy().astype(np.float64) / PSD_SCALE
            for j, i in enumerate(chunk):
                out[i] = dict(signal=sig[j], noise=noi[j], noisy=nsy[j],
                              psd=psd, n=n)
    return out


def generate_pycbc(specs: List[dict], args) -> Dict[int, dict]:
    """Host-side PyCBC SEOBNRv4 path (needs the ``pycbc`` package)."""
    try:
        from pycbc.detector import Detector
        from pycbc.filter import sigma as mf_sigma
        from pycbc.noise import noise_from_psd
        from pycbc.psd import aLIGOZeroDetHighPower
        from pycbc.waveform import get_td_waveform
    except ImportError as e:
        raise SystemExit(
            "--engine pycbc requires the 'pycbc' package, which is not "
            "installed in this environment; use --engine jax") from e

    fs = int(args.sampling_rate)
    dt = 1.0 / fs
    det = Detector("H1")
    rng = np.random.default_rng(args.seed)
    out: Dict[int, dict] = {}
    psd_cache: Dict[int, object] = {}
    for i, s in enumerate(specs):
        hp, hc = get_td_waveform(approximant="SEOBNRv4",
                                 mass1=s["m1"], mass2=s["m2"],
                                 spin1z=s["s1"], spin2z=s["s2"],
                                 delta_t=dt, f_lower=args.f_lower,
                                 distance=args.distance)
        h = det.project_wave(hp, hc, 0.0, 0.0, 0.0)
        N = len(h)
        flen = N // 2 + 1
        if flen not in psd_cache:
            psd_cache[flen] = aLIGOZeroDetHighPower(flen, 1.0 / (N * dt),
                                                    args.f_lower)
        psd = psd_cache[flen]
        amp = mf_sigma(h, psd=psd, low_frequency_cutoff=args.f_lower)
        h = h * (s["snr"] / max(float(amp), 1e-30))
        noise = noise_from_psd(N, dt, psd, seed=int(rng.integers(0, 2**31)))
        out[i] = dict(signal=np.asarray(h, np.float32),
                      noise=np.asarray(noise, np.float32),
                      noisy=np.asarray(h, np.float32) + np.asarray(noise, np.float32),
                      psd=np.asarray(psd, np.float64), n=N)
    return out


def welch_batched(samples: Dict[int, dict], fs: float, nperseg: int,
                  noverlap: Optional[int], device) -> Dict[int, tuple]:
    """{spec index: (freqs, P)} float64 physical, the Welch PSDs of every
    sample's noisy series: per length, :data:`WELCH_ROWS` rows a call of
    ``welch_psd`` on ``device``, on strain x ``STRAIN_SCALE`` in float32
    (physical |strain|^2 ~ 1e-42 underflows float32), the scale undone in
    float64."""
    from ..data.synth import STRAIN_SCALE
    from ..ops.whiten import welch_psd

    by_n: Dict[int, List[int]] = {}
    for i, smp in samples.items():
        by_n.setdefault(smp["n"], []).append(i)
    out: Dict[int, tuple] = {}
    for n, idxs in sorted(by_n.items()):
        for c0 in range(0, len(idxs), WELCH_ROWS):
            chunk = idxs[c0:c0 + WELCH_ROWS]
            arr = torch.from_numpy(np.stack([samples[i]["noisy"]
                                             for i in chunk])).to(device)
            f_w, P = welch_psd(arr * STRAIN_SCALE, fs,
                               nperseg=min(nperseg, n), noverlap=noverlap)
            f_w = f_w.cpu().numpy().astype(np.float64)
            P = P.cpu().numpy().astype(np.float64) / (STRAIN_SCALE ** 2)
            for j, i in enumerate(chunk):
                out[i] = (f_w, P[j])
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> dict:
    """Returns a summary: the output path, the sample count, the samples
    per bucket and each stage's seconds (specs, synthesis, Welch, write;
    write holds the scipy Welch PSDs where they are used)."""
    args = build_parser().parse_args(argv)
    taper_explicit = getattr(args, "f_taper_frac", None) is not None
    if not taper_explicit:
        # the below-band taper is the PN engine's default; the other engines
        # do not use it and keep the neutral 1.0
        args.f_taper_frac = (0.85 if args.engine == "jax"
                             and args.approximant == "pn" else 1.0)
    taper = float(args.f_taper_frac)
    if taper_explicit and taper != 1.0 and not (args.engine == "jax"
                                                and args.approximant == "pn"):
        raise SystemExit(
            "--f-taper-frac < 1 is only honoured by --engine jax "
            f"--approximant pn (got engine={args.engine}, "
            f"approximant={args.approximant})")
    if taper != 1.0 and not 0.5 < taper <= 1.0:
        raise SystemExit(
            f"--f-taper-frac must be in (0.5, 1.0], got {taper}")
    rd = getattr(args, "ringdown", "qnm")
    if rd != "qnm" and not (args.engine == "jax"
                            and args.approximant == "pn"):
        raise SystemExit(
            "--ringdown is only honoured by --engine jax --approximant pn "
            f"(got engine={args.engine}, approximant={args.approximant})")
    if ((args.plot or args.psd_preview)
            and importlib.util.find_spec("matplotlib") is None):
        raise SystemExit("--plot and --psd-preview need matplotlib, which is "
                         "not installed")
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    seconds = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    specs = build_specs(args, rng)
    if len(specs) > args.num_samples and args.mode == "grid":
        specs = specs[: args.num_samples]      # head trim after the shuffle
    seconds["specs"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if args.engine == "pycbc":
        samples = generate_pycbc(specs, args)
    else:
        samples = generate(specs, args, dev)
    seconds["synthesis"] = time.perf_counter() - t0

    fs = float(args.sampling_rate)
    sig_l, noi_l, nsy_l, times_l, dets = [], [], [], [], []
    psd_model_l: Optional[list] = [] if (args.save_psd and args.psd_source
                                         in ("model", "both")) else None
    psd_w_l: Optional[list] = [] if (args.save_psd and args.psd_source
                                     in ("welch", "both")) else None
    psd_wf_l: Optional[list] = [] if psd_w_l is not None else None
    meta: Dict[str, list] = {k: [] for k in [
        "mass1", "mass2", "spin1z", "spin2z", "snr",
        "label_m1", "label_m2", "label_s1", "label_s2",
        "q", "chirp_mass", "epoch", "psd_len", "psd_df", "psd_f_lower"]}

    from scipy.signal import welch as scipy_welch

    t0 = time.perf_counter()
    psd_w_pre: Dict[int, tuple] = {}
    if psd_w_l is not None and args.engine != "pycbc" \
            and args.psd_window == "hann":
        psd_w_pre = welch_batched(samples, fs, args.psd_nperseg,
                                  args.psd_noverlap, dev)
    seconds["welch"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i, s in enumerate(specs):
        smp = samples[i]
        n = smp["n"]
        sig_l.append(smp["signal"])
        noi_l.append(smp["noise"])
        nsy_l.append(smp["noisy"])
        times_l.append(np.arange(n, dtype=np.float64) / fs)
        dets.append("H1")
        if psd_model_l is not None:
            psd_model_l.append(smp["psd"])
        if psd_w_l is not None:
            if i in psd_w_pre:
                f_w, P_w = psd_w_pre[i]
            else:
                f_w, P_w = scipy_welch(smp["noisy"].astype(np.float64), fs=fs,
                                       nperseg=min(args.psd_nperseg, n),
                                       noverlap=args.psd_noverlap,
                                       window=args.psd_window)
            psd_w_l.append(P_w)
            psd_wf_l.append(f_w)
        M = s["m1"] + s["m2"]
        eta = s["m1"] * s["m2"] / (M * M)
        meta["mass1"].append(s["m1"])
        meta["mass2"].append(s["m2"])
        meta["spin1z"].append(s["s1"])
        meta["spin2z"].append(s["s2"])
        meta["snr"].append(s["snr"])
        meta["label_m1"].append(s["label_m1"])
        meta["label_m2"].append(s["label_m2"])
        meta["label_s1"].append(s.get("label_s1", s["s1"]))
        meta["label_s2"].append(s.get("label_s2", s["s2"]))
        meta["q"].append(s["m1"] / max(s["m2"], 1e-9))
        meta["chirp_mass"].append(eta ** 0.6 * M)
        meta["epoch"].append(0.0)
        meta["psd_len"].append(len(smp["psd"]))
        meta["psd_df"].append(fs / n)
        meta["psd_f_lower"].append(args.f_lower)

        if args.progress_every and (i + 1) % args.progress_every == 0:
            print(f"[gen] {i + 1}/{len(specs)}")

    from ..data.hdf5io import write_dataset

    write_dataset(
        args.output_path,
        signal=sig_l, noise=noi_l, noisy=nsy_l, times=times_l, meta=meta,
        sampling_rate=fs, detectors=dets,
        psd_model=psd_model_l, psd_welch=psd_w_l, psd_welch_freqs=psd_wf_l,
        psd_params=dict(source=args.psd_source, nperseg=args.psd_nperseg,
                        noverlap=args.psd_noverlap, window=args.psd_window),
        attrs_extra={
            "mode": args.mode,
            "engine": args.engine,
            "config_args": json.dumps(vars(args), sort_keys=True),
        },
    )
    seconds["write"] = time.perf_counter() - t0
    print(f"[gen] wrote {len(specs)} samples -> {args.output_path}")

    if args.psd_preview and psd_model_l:
        _psd_previews(args, psd_model_l, fs)
    if args.plot:
        _plot_examples(args, sig_l, nsy_l, fs)
    buckets: Dict[int, int] = {}
    for smp in samples.values():
        buckets[smp["n"]] = buckets.get(smp["n"], 0) + 1
    return {"path": args.output_path, "n": len(specs),
            "buckets": dict(sorted(buckets.items())), "seconds": seconds}


def _psd_previews(args, psd_model_l, fs):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = args.psd_preview_dir or os.path.join(
        os.path.dirname(args.output_path) or ".", "psd_plots")
    os.makedirs(out_dir, exist_ok=True)
    for i, P in enumerate(psd_model_l[: args.psd_preview]):
        n = (len(P) - 1) * 2
        f = np.fft.rfftfreq(n, 1.0 / fs)
        fig, ax = plt.subplots(figsize=(7, 4))
        valid = P > 0
        ax.loglog(f[valid], np.sqrt(P[valid]))
        ax.set_xlabel("f [Hz]")
        ax.set_ylabel("ASD [1/sqrt(Hz)]")
        ax.set_title(f"sample {i} model ASD")
        fig.savefig(os.path.join(out_dir, f"asd_{i:04d}.png"), dpi=110)
        plt.close(fig)
    print(f"[gen] PSD previews -> {out_dir}")


def _plot_examples(args, sig_l, nsy_l, fs, k: int = 4):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = os.path.join(os.path.dirname(args.output_path) or ".", "gen_plots")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(min(k, len(sig_l))):
        t = np.arange(len(sig_l[i])) / fs
        fig, ax = plt.subplots(figsize=(9, 4))
        ax.plot(t, nsy_l[i], lw=0.4, alpha=0.6, label="noisy")
        ax.plot(t, sig_l[i], lw=0.8, label="signal")
        ax.legend()
        ax.set_xlabel("t [s]")
        fig.savefig(os.path.join(out_dir, f"example_{i}.png"), dpi=110)
        plt.close(fig)
    print(f"[gen] example plots -> {out_dir}")


if __name__ == "__main__":
    main(sys.argv[1:])
