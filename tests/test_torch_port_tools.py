"""The port's Python tools (``<port>/tools``) against the repo's JAX tools
and the JAX package, on the CPU: ``bench_population``'s batched DDIM call,
``bench_kernels``' sections at small shapes, the glitch and spin
harnesses' JSON field by field (JAX's draws handed to the port's noise
seam), ``pn_fidelity``'s TaylorF2, match and float64 chirp,
the ``merge_h5`` shim, and ``tools/collect_results.py`` on the port's
``gw-sweep`` and ``gw-grid`` outputs.

The root ``tools/pn_fidelity.py`` is never imported: its import switches
JAX to float64 for the whole process.  Its two functions are read with
``ast`` and run under ``jax.enable_x64``.

Tolerances: f32 module and sampler outputs within 1e-4 relative
(``REL_TOL``, max-abs normalised; the harnesses' metrics per metric over
the samples); float64 arithmetic (TaylorF2, the match, the chirp's phase)
within 1e-9 of the peak, the float64 chirp (cast to float32 by both;
JAX's inversion run to the port's iteration count) within 1e-6 of its
peak; files byte-equal; bench_kernels' rows within the
port's kernel bars (on the CPU the wrappers run their plain versions).
"""
import ast
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu import inference as jinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import hdf5io as jio
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import pn as jpn
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.models import unet as jax_unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops import sampling as jsp
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops import schedules as jsch
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import grid as tgrid_cli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import merge as tmerge
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import sweep as tsweep_cli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io as tio
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools import bench_kernels as tbk
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools import bench_population as tbp
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools import glitch_robustness as tglitch
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools import merge_h5 as tmerge_h5
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools import pn_fidelity as tpnf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools import spin_sensitivity as tspin
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import params_from_flax
from test_torch_port_evals import JaxDraws, corpus  # noqa: F401  (the fixture)
from test_torch_port_sampling import jax_noise
from test_torch_port_unet import REL_TOL, randomize, rel_err

TOOLS = Path(__file__).resolve().parent.parent / "tools"


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(f"root_tools_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# bench_population
# ---------------------------------------------------------------------------

def test_bench_population_matches_jax_ddim():
    """The tool's population call (B 2, L 256, 3 steps, cfg 1.5, the
    bench's U-Net in f32) against JAX's ``ddim_sample`` with the same
    weights and JAX's draws."""
    B, L, steps = 2, 256, 3
    jm = jax_unet.UNet1D(**tbp.MODEL)
    params = randomize(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, tbp.IN_CH, L)),
        jnp.zeros((1,), jnp.int32)), 0)
    cond = np.random.default_rng(1).standard_normal(
        (B, tbp.COND_IN_CH, L)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    cfg = jsp.SamplerConfig(steps=steps, cfg_scale=tbp.CFG_SCALE,
                            use_selfcond=True)
    want = np.asarray(jsp.ddim_sample(
        lambda p, x, t: jm.apply(p, x, t), params,
        jsch.make_schedule(1000, "cosine"), jnp.asarray(cond), key, cfg))
    model, schedule, _ = tbp.setup(B, L, "cpu", dtype=torch.float32)
    model.load_state_dict(params_from_flax(jax.device_get(params)),
                          strict=True)
    got = tbp.population(model, schedule, torch.from_numpy(cond), steps,
                         jax_noise(key, steps, (B, 1, L)))
    assert got.shape == want.shape == (B, 1, L)
    assert rel_err(got.numpy(), want) <= REL_TOL


def test_bench_population_prints_the_root_keys(capsys):
    assert tbp.main(["2", "64", "2", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    root = {"metric", "batch", "steps", "L", "wall_s_per_population",
            "samples_per_sec", "denoise_steps_per_sec_per_chip", "note"}
    assert root <= set(rec) and rec["device"] == "cpu"
    assert (rec["batch"], rec["L"], rec["steps"]) == (2, 64, 2)
    assert rec["samples_per_sec"] == pytest.approx(
        2 / rec["wall_s_per_population"])


# ---------------------------------------------------------------------------
# bench_kernels at small shapes
# ---------------------------------------------------------------------------

def test_bench_kernels_sections_on_the_cpu(capsys):
    rows = (tbk.bench_conv("cpu", shapes=[(2, 64, 8, 16)], reps=1)
            + tbk.bench_conv_bf16("cpu", shapes=[(2, 64, 8, 16)], reps=1)
            + tbk.bench_attention("cpu", shapes=[(1, 2, 64, 16)], reps=1)
            + tbk.bench_fast_decoder("cpu", stages=[(2, 64, 64, 64, 64)],
                                     reps=1, unet_rows=2, unet_L=64))
    assert [r["kernel"] for r in rows] == [
        "conv_gn_silu", "conv_gn_silu_bf16", "flash_attention",
        "flash_attention_bf16", "conv_gn_silu_decoder_bf16",
        "unet_fwd_decoder_route=False", "unet_fwd_decoder_route=True"]
    for r in rows[:5]:
        assert r["within_tol"] and r["n_outside_tol"] == 0, r
    assert rows[0]["route"] == "fma" and rows[0]["bound_ms"] is None
    # on the CPU the route is the materialised plain version
    assert rows[4]["max_abs_err_vs_materialised"] == 0.0
    assert rows[-1]["max_rel_err_vs_materialised"] == 0.0
    unet_rows = tbk.bench_unet("cpu", B=2, L=64, reps=1)
    assert [r["kernel"] for r in unet_rows] == ["unet_fwd_kernels=False",
                                                "unet_fwd_kernels=True"]
    assert unet_rows[1]["max_rel_err_vs_plain"] == 0.0
    assert unet_rows[1]["max_rel_err_vs_plain_f32"] == 0.0
    assert rows[3]["n_outside_bound"] == 0
    hbm = tbk.bench_hbm_stream("cpu", n=1 << 16, iters=4, reps=1)[0]
    assert hbm["achieved_gbps"] > 0 and "peak_gbps" not in hbm


@pytest.mark.parametrize("kernel", ["conv_gn_silu", "flash_attention"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_rows_hold_outputs_to_the_one_table(kernel, dtype):
    """``conv_row`` / ``attention_row`` (the rows of ``bench_kernels`` and
    of ``chip_smoke.py``'s kernel phases) carry every key those read, and
    an output moved just past ``TOL``'s bar at a zero output is counted."""
    g = torch.Generator().manual_seed(0)
    if kernel == "conv_gn_silu":
        x = torch.randn(2, 32, 8, generator=g).to(dtype)
        W = torch.randn(3, 8, 16, generator=g) * 0.1
        b, s, bb = torch.zeros(16), torch.ones(16), torch.zeros(16)
        row = tbk.conv_row(x, W, b, s, bb, 8, reps=1, plain_reps=1)
    else:
        q, k, v = (torch.randn(1, 2, 32, 16, generator=g).to(dtype)
                   for _ in range(3))
        row = tbk.attention_row(q, k, v, reps=1, plain_reps=1,
                                exact_bound=dtype == torch.bfloat16)
    dname = str(dtype).split(".")[1]
    rtol, atol = tbk.TOL[(kernel, dname)]
    assert {"route", "dtype", "kernel_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err", "rtol", "atol",
            "n_outside_tol", "within_tol", "tflops", "gflop",
            "mbytes"} <= row.keys()
    assert (row["dtype"], row["rtol"], row["atol"]) == (dname, rtol, atol)
    assert row["within_tol"] and row["max_abs_err"] == 0.0
    want = torch.zeros(4, dtype=dtype)
    near = torch.tensor([0.0, 0.5, 0.9, 1.1]) * atol
    assert tbk._against(near.to(dtype), want, kernel)["n_outside_tol"] == \
        int((near.to(dtype).float() > atol).sum()) == 1


def test_plain_kernels_swaps_the_unet_kernels_and_restores_them():
    kernels = unet.fused_conv_gn_silu, unet.flash_attention
    with pytest.raises(RuntimeError):
        with unet.plain_kernels():
            assert unet.fused_conv_gn_silu is tbk.fused_conv_gn_silu_reference
            assert unet.flash_attention is tbk.flash_attention_reference
            raise RuntimeError
    assert (unet.fused_conv_gn_silu, unet.flash_attention) == kernels


def test_roofline_bound_takes_the_larger_time():
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.roofline import (
        bound_ms,
    )

    assert bound_ms(989e9, 1.0, "NVIDIA H100 80GB HBM3") == pytest.approx(
        (1.0, "operations"))
    assert bound_ms(67e9, 1.0, "NVIDIA H100", "float32") == pytest.approx(
        (1.0, "operations"))
    assert bound_ms(1.0, 3.35e9, "NVIDIA H100") == pytest.approx(
        (1.0, "bytes"))
    assert bound_ms(1.0, 1.0, "cpu") is None


# ---------------------------------------------------------------------------
# the glitch and spin harnesses, JAX's draws handed over
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_draws(monkeypatch):
    """Records every key the JAX package's ``reconstruct_batch`` receives
    and hands them, in order, to the port tools' noise seam."""
    calls, used = [], []
    orig = jinf.reconstruct_batch

    def rb(model, params, schedule, conds, sigmas, cfg, key, **kw):
        calls.append((key, int(np.shape(conds)[0]),
                      max(1, int(kw.get("avg_seeds", 1)))))
        return orig(model, params, schedule, conds, sigmas, cfg, key, **kw)

    monkeypatch.setattr(jinf, "reconstruct_batch", rb)

    def noise(seed, device):
        assert str(device) == "cpu"

        def draw(shape):
            key, rows, seeds = calls[len(used)]
            used.append(shape)
            assert shape[0] == rows * seeds
            return JaxDraws(key, rows * seeds, seeds)
        return draw

    for mod in (tglitch, tspin):
        monkeypatch.setattr(mod, "_noise", noise)
    return calls, used


def _close(got, want, path=""):
    """Equal structure; floats within REL_TOL of the largest magnitude of
    their list (per metric over the samples) or of themselves."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list) and want and isinstance(want[0], dict):
        assert len(got) == len(want), path
        for k in want[0]:
            if isinstance(want[0][k], float):
                g = np.array([r[k] for r in got], np.float64)
                w = np.array([r[k] for r in want], np.float64)
                assert rel_err(g, w) <= REL_TOL, (path, k, g, w)
            else:
                for i, (g, w) in enumerate(zip(got, want)):
                    _close(g[k], w[k], f"{path}[{i}].{k}")
    elif isinstance(want, float):
        assert abs(got - want) <= REL_TOL * max(abs(want), 1e-3), (path, got,
                                                                   want)
    else:
        assert got == want, path


HARNESS_ARGS = ["--indices", "0", "3", "6", "9", "--steps", "2",
                "--avg-seeds", "2", "--seed", "5"]


def test_glitch_robustness_matches_jax(corpus, jax_draws):  # noqa: F811
    argv = ["--model", corpus.ckpt, "--glitch-snr", "0", "8"] + HARNESS_ARGS
    want = _root_tool("glitch_robustness").main(
        ["--input-h5", corpus.h5] + argv)
    got = tglitch.main(["--input-h5", corpus.npz, "--device", "cpu"] + argv)
    calls, used = jax_draws
    assert len(calls) == len(used) == 2
    _close(got, want)
    assert got["levels"][1]["corr_mean"] != got["levels"][0]["corr_mean"]


def test_glitch_helpers_match_jax():
    jt = _root_tool("glitch_robustness")
    g = tglitch.sine_gaussian(512, 1024.0, 0.3, 120.0, 9.0)
    np.testing.assert_array_equal(g, jt.sine_gaussian(512, 1024.0, 0.3,
                                                      120.0, 9.0))
    P = np.where(np.arange(257) > 10, 1e-2 + np.arange(257) * 1e-4, 0.0)
    assert tglitch.mf_snr_vs_psd(g, P, 1024.0) == jt.mf_snr_vs_psd(g, P,
                                                                    1024.0)


def test_spin_sensitivity_matches_jax(corpus, jax_draws):  # noqa: F811
    argv = ["--model", corpus.ckpt] + HARNESS_ARGS
    want = _root_tool("spin_sensitivity").main(["--input-h5", corpus.h5]
                                               + argv)
    got = tspin.main(["--input-h5", corpus.npz, "--device", "cpu"] + argv)
    calls, used = jax_draws
    # one call per run, each from the key restarted at --seed
    assert len(calls) == len(used) == 2
    assert np.array_equal(jax.random.key_data(calls[0][0]),
                          jax.random.key_data(calls[1][0]))
    _close(got, want)


# ---------------------------------------------------------------------------
# pn_fidelity
# ---------------------------------------------------------------------------

def _jax_fidelity_functions():
    """``taylorf2`` and ``weighted_match`` of the root tool, read with
    ``ast`` (its import would switch JAX to float64 process-wide)."""
    tree = ast.parse((TOOLS / "pn_fidelity.py").read_text())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("taylorf2", "weighted_match")]
    ns = {"np": np, "jnp": jnp, "pn": jpn, "MSUN_S": jpn.MSUN_S,
          "MPC_S": jpn.MPC_S, "aligo_zdhp_psd_np": jio.aligo_zdhp_psd_np}
    exec(compile(ast.Module(body=fns, type_ignores=[]), "pn_fidelity",
                 "exec"), ns)
    return ns["taylorf2"], ns["weighted_match"]


def test_pn_fidelity_matches_jax_in_float64(monkeypatch):
    """TaylorF2 and the match against the root tool's functions, and one
    float64 chirp against JAX's in float64, its tau(v) inversion run to
    the port's ``CHIRP_NEWTON_ITERS`` (JAX's 24 leave some samples
    unconverged, about 1e-3 of the peak near the merger)."""
    from functools import partial

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pn as tpn

    j_tf2, j_match = _jax_fidelity_functions()
    m1, m2, chi, fs, n = 28.0, 24.0, 0.6, 4096.0, 16384
    freqs = np.fft.rfftfreq(n, 1.0 / fs)[40:2000]
    monkeypatch.setattr(jpn, "invert_tau", partial(
        jpn.invert_tau, iters=tpn.CHIRP_NEWTON_ITERS))
    with jax.enable_x64(True):
        want_tf2 = j_tf2(freqs, m1, m2, chi, chi, 410.0)
        want_h = np.asarray(jpn.pn_chirp(
            jnp.float64(m1), jnp.float64(m2), jnp.float64(chi),
            jnp.float64(chi), n=n, fs=int(fs), distance=410.0,
            f_lower=20.0, fplus=1.0, fcross=0.0), np.float64)
        want_match = j_match(want_h, fs, m1, m2, chi, chi, 410.0, 22.0,
                             300.0)
    got_tf2 = tpnf.taylorf2(freqs, m1, m2, chi, chi, 410.0)
    assert rel_err(got_tf2.real, want_tf2.real) <= 1e-9
    assert rel_err(got_tf2.imag, want_tf2.imag) <= 1e-9
    got_h = tpnf.chirp(m1, m2, chi, n, fs, 20.0, "qnm", 1.0, "cpu")
    assert rel_err(got_h, want_h) <= 1e-6
    assert abs(tpnf.weighted_match(got_h, fs, m1, m2, chi, chi, 410.0, 22.0,
                                   300.0) - want_match) <= 1e-6
    assert abs(tpnf.weighted_match(want_h, fs, m1, m2, chi, chi, 410.0, 22.0,
                                   300.0) - want_match) <= 1e-9


def test_pn_fidelity_cli_writes_the_root_json(tmp_path):
    out = tmp_path / "fid.json"
    res = tpnf.main(["--out", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert {"method", "pycbc_status", "f_taper_frac", "ringdown", "rows",
            "mismatch_max", "mismatch_median"} <= set(res)
    assert len(res["rows"]) == len(tpnf.MASSES) * len(tpnf.CHIS)
    assert list(res["rows"][0]) == ["m1", "m2", "chi", "f_hi_hz", "n",
                                    "match", "mismatch", "core_mismatch"]
    assert all(0.0 <= r["mismatch"] < 0.5 for r in res["rows"])
    assert res["mismatch_max"] == max(r["mismatch"] for r in res["rows"])


# ---------------------------------------------------------------------------
# merge_h5 and collect_results
# ---------------------------------------------------------------------------

def _twin(path, n, seed):
    rng = np.random.default_rng(seed)
    sig = [rng.normal(size=256).astype(np.float32) for _ in range(n)]
    tio.write_dataset(path, sig, sig, [2 * s for s in sig],
                      [np.arange(256) / 1024.0] * n,
                      {"mass1": rng.uniform(20, 40, n),
                       "mass2": rng.uniform(20, 40, n)}, 1024.0)


def test_merge_h5_shim_is_gw_merge(tmp_path, capsys, monkeypatch):
    """The shim's file byte-equal to gw-merge's, written an hour later by
    the clock (the twin's members carry a fixed timestamp)."""
    import time

    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    _twin(a, 3, 0)
    _twin(b, 2, 1)
    tmerge_h5.main(str(tmp_path / "shim.npz"), [a, b])
    assert "[merge] wrote 5 samples" in capsys.readouterr().out
    later = time.time() + 3600.0
    monkeypatch.setattr(time, "time", lambda: later)
    tmerge.main(["--output-path", str(tmp_path / "cli.npz"), a, b])
    assert ((tmp_path / "shim.npz").read_bytes()
            == (tmp_path / "cli.npz").read_bytes())


def test_collect_results_reads_the_port_outputs(corpus, tmp_path,  # noqa: F811
                                                capsys):
    root = tmp_path / "runs"
    sw, gd = str(root / "sweep"), str(root / "grid")
    tsweep_cli.main(["--input-h5", corpus.npz, "--model", corpus.ckpt,
                     "--outdir", sw, "--indices", "0", "3", "--grid",
                     "--grid-steps", "2", "--grid-snr", "8", "--grid-cfg",
                     "1.5", "--grid-init", "noise", "--grid-dc", "0",
                     "--grid-eta", "0", "--val-samples", "2",
                     "--device", "cpu"])
    tgrid_cli.main(["--input-h5", corpus.npz, "--model", corpus.ckpt,
                    "--outdir", gd, "--from-sweep", sw, "--per-cell", "1",
                    "--avg-seeds", "1", "--device", "cpu"])
    capsys.readouterr()
    assert _root_tool("collect_results").main(["--root", str(root)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summ = json.loads((root / "grid" / "summary.json").read_text())
    grid = [ln for ln in lines if ln.startswith("grid ")]
    gate = [ln for ln in lines if ln.startswith("sweep ")]
    assert len(grid) == len(gate) == 1 and len(lines) == 2
    assert f"corr={summ['corr_macro_mean']:.4f}" in grid[0]
    assert "sweep-gate" in gate[0]
    assert _root_tool("collect_results").main(
        ["--root", str(root), "--markdown"]) == 0
    assert "| grid | grid |" in capsys.readouterr().out
