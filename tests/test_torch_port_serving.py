"""The PyTorch port's serving function, batched reconstruction and entry-point
rules against the JAX package, float32 on the CPU."""
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu import inference as jinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu import serving as jsrv
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops import schedules as jsch
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference as tinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import serving as tsrv
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import sampling as tsp
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import schedules as tsch
from test_torch_port_unet import REL_TOL, SMALL, model_pair, rel_err

B, L, S = 2, 256, 2
CK = {"in_ch": 7, "cond_in_ch": 5, "pred_type": "v"}


@pytest.fixture(scope="module")
def setup():
    jm, params, tm = model_pair(L, **SMALL)
    rng = np.random.default_rng(8)
    cond = rng.standard_normal((B, 5, L)).astype(np.float32)
    sig = np.array([0.5, 2.0], np.float32)
    return jm, params, tm, cond, sig


def _init_noise(key, rows):
    k_init, _ = jax.random.split(key)
    return tsp.FixedNoise(torch.from_numpy(np.array(
        jax.random.normal(k_init, (rows, 1, L), jnp.float32))))


def test_serving_fn_matches_jax(setup):
    jm, params, tm, cond, sig = setup
    js, ts = jsch.make_schedule(1000), tsch.make_schedule(1000)
    jcfg, _ = jsrv.resolve_serving_config(CK, js, steps=3, ladder="lambda")
    tcfg, _ = tsrv.resolve_serving_config(CK, ts, steps=3, ladder="lambda")
    # every field the port implements is resolved as in JAX
    assert tcfg.__dict__ == {k: jcfg.__dict__[k] for k in tcfg.__dict__}
    kw = dict(sampler="ddim", avg_seeds=S, avg_mode="mf", amp_calib="mf")
    want = np.asarray(jsrv.build_serving_fn(jm, js, jcfg, **kw)(
        params, jnp.asarray(cond), jnp.asarray(sig), 7))
    fn = tsrv.build_serving_fn(ts, tcfg, device="cpu", **kw)
    got = fn(tm, cond, sig, 7,
             noise=_init_noise(jax.random.PRNGKey(7), S * B))
    assert got.shape == want.shape == (B, L)
    assert rel_err(got, want) <= REL_TOL


def test_reconstruct_batch_matches_jax(setup):
    """Seed averaging, an ensemble of two members sharing the noise, the
    seed std and the host MF calibration."""
    jm, params, tm, cond, sig = setup
    jm2, params2, tm2 = model_pair(L, seed=1, **SMALL)
    cfg = dict(steps=3, pred_type="v", ladder="lambda", cfg_scale=1.5)
    kw = dict(sampler="ddim", avg_seeds=S, amp_calib="mf", avg_mode="median",
              return_seed_std=True)
    key = jax.random.PRNGKey(3)
    want = jinf.reconstruct_batch(
        jm, params, jsch.make_schedule(1000), cond, sig,
        jinf.SamplerConfig(**cfg), key, extra_models=[(jm2, params2)], **kw)
    got = tinf.reconstruct_batch(
        tm, tsch.make_schedule(1000), cond, sig, tsp.SamplerConfig(**cfg),
        _init_noise(key, S * B), extra_models=[tm2], device="cpu", **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, L)
        assert rel_err(g, w) <= REL_TOL


def test_host_helpers_match_jax():
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((2, 64)).astype(np.float32)
    for a, b in ((x, y), (0.01 * y, y), (np.zeros(64, np.float32), y)):
        got, want = tinf.mf_amp_calibrate(a, b), jinf.mf_amp_calibrate(a, b)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    js, ts = jsch.make_schedule(1000), tsch.make_schedule(1000)
    assert tinf.resolve_start_t(ts, 900, 2.0) == jinf.resolve_start_t(js, 900, 2.0)
    assert tinf.resolve_start_t(ts, 900, None) == 900
    for ck in ({}, {"distilled_steps": 4, "distilled_ladder": "lambda",
                    "distilled_start_t": 700}):
        a, b = types.SimpleNamespace(), types.SimpleNamespace()
        tinf.apply_distilled_defaults(a, ck)
        jinf.apply_distilled_defaults(b, ck)
        assert vars(a) == vars(b)


def test_run_batched_chunks_pads_and_advances_seed():
    """5 requests through a batch-2 function: 3 calls, seeds 7, 8, 9, the
    tail padded with zero conditioning and sigma 1, pads dropped; the same
    as the JAX package's run_batched."""
    C, n = 3, 5
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((n, C, 16)).astype(np.float32)
    sig = rng.uniform(0.5, 2.0, n).astype(np.float32)
    calls = []

    def fake(c, s, seed):
        calls.append((c.copy(), s.copy(), int(seed)))
        return torch.from_numpy(c[:, 0, :] * s[:, None] + seed)

    contract = {"calling_convention": tsrv.calling_convention(2, C, 16)}
    out = tsrv.run_batched(fake, contract, cond, sig, seed=7)
    assert [c[2] for c in calls] == [7, 8, 9]
    assert np.all(calls[-1][0][1] == 0) and calls[-1][1][1] == 1.0
    seeds = np.repeat(np.float32([7, 8, 9]), 2)[:n, None]
    np.testing.assert_array_equal(out, cond[:, 0, :] * sig[:, None] + seeds)
    want = jsrv.run_batched(lambda c, s, seed: fake(c, s, seed).numpy(),
                            contract, cond, sig, seed=7)
    np.testing.assert_array_equal(out, want)
    with pytest.raises(ValueError):
        tsrv.run_batched(fake, contract, cond[:, :2], sig)


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts = tsch.make_schedule(1000)
    cfg = tsp.SamplerConfig(steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        unet.UNet1D(in_ch=7, base_ch=8, depth=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsrv.build_serving_fn(ts, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.reconstruct_batch(None, ts, np.zeros((1, 1, 8), np.float32),
                               np.ones(1), cfg, torch.Generator())
    with pytest.raises(TypeError, match="make_mesh"):
        tinf.reconstruct_batch(None, ts, np.zeros((1, 1, 8), np.float32),
                               np.ones(1), cfg, torch.Generator(), mesh=object())


def test_port_runs_without_jax():
    """The port imports no JAX, flax or JAX-package module: with those
    imports blocked it still runs a CPU forward and a 2-step DDIM."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax",
                     "diffusion_models_for_gravitational_waveform_reconstruction_tpu"):
            sys.modules[name] = None
        import torch
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import sampling, schedules
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference, serving
        for attn in (False, True):
            m = UNet1D(in_ch=7, base_ch=8, time_dim=16, depth=2, cond_in_ch=5,
                       use_attention=attn, device="cpu")
            with torch.no_grad():
                out = m(torch.randn(1, 7, 64), torch.tensor([5]))
            assert out.shape == (1, 1, 64)
        x = sampling.ddim_sample(m, schedules.make_schedule(100),
                                 torch.randn(1, 5, 64),
                                 sampling.SamplerConfig(steps=2),
                                 torch.Generator().manual_seed(0))
        assert x.shape == (1, 1, 64) and bool(torch.isfinite(x).all())
        bad = [k for k, v in sys.modules.items()
               if v is not None and k.split(".")[0] in ("jax", "flax")]
        assert not bad, bad
        print("ok")
    """)
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
