"""The PyTorch port's progressive distillation and model soups against the
JAX package's, on the CPU: the teacher ladder, the distillation step on the
same weights with JAX's draws injected, the learning-rate schedule,
``distill()`` end to end, ``average_checkpoints`` / ``gw-soup`` and their
refusals, and the four new CLIs run with JAX, flax, optax, msgpack, h5py,
pandas and matplotlib blocked.

Tolerances (f32, the plain path on the CPU): the teacher ladder bit-equal;
the step's loss and gradient norm within 1e-4 relative at every step, the
parameters within 1e-4 absolute and the EMA within 1e-6 after three steps
(the train step's tolerances, for the same reasons: AdamW's first updates
are about lr * sign(g)); the learning rate within 1e-6 relative of optax's
(both float32); the soup byte-equal.
"""
import argparse
import importlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu import inference as jinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.cli import soup as jsoup_cli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops import schedules as jsch
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.utils import checkpoint as jck
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference as tinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import distill as tdistill_cli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import soup as tsoup_cli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import schedules as tsch
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils import checkpoint as tck
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import params_from_flax
from test_torch_port_evals import CK, corpus  # noqa: F401  (fixture)
from test_torch_port_unet import SMALL, model_pair

jt = importlib.import_module(
    "diffusion_models_for_gravitational_waveform_reconstruction_tpu.training.train")
jd = importlib.import_module(
    "diffusion_models_for_gravitational_waveform_reconstruction_tpu.training.distill")
tt = importlib.import_module(
    "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.training.train")
td = importlib.import_module(
    "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.training.distill")

LOSS_RTOL, PARAM_ATOL, EMA_ATOL, LR_RTOL = 1e-4, 1e-4, 1e-6, 1e-6
B, L, C_META = 4, 64, 4


@pytest.mark.parametrize("ladder", ["lambda", "t"])
@pytest.mark.parametrize("n_student,start_t", [(1, 999), (2, 999), (4, None),
                                               (8, 500), (32, 999)])
def test_teacher_ladder_bit_equal(ladder, n_student, start_t):
    for T in (1000, 100):
        got = td._teacher_ladder(tsch.make_schedule(T), n_student, ladder,
                                 None if start_t is None else min(start_t, T - 1))
        want = jd._teacher_ladder(jsch.make_schedule(T), n_student, ladder,
                                  None if start_t is None else min(start_t, T - 1))
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("lr,total", [(1e-4, 7), (1e-3, 64), (2e-4, 2500),
                                      (5e-5, 4000)])
def test_lr_schedule_matches_optax(lr, total):
    warm = min(100, max(1, total // 20))
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warm, total, lr * 0.1)
    got = td.distill_lr_schedule(lr, total)
    counts = np.arange(0, total + 5, max(1, total // 200))
    w = np.array([float(want(jnp.asarray(c, jnp.int32))) for c in counts])
    g = got(torch.from_numpy(counts.astype(np.int32))).numpy()
    assert g.dtype == np.float32
    np.testing.assert_allclose(g, w, rtol=LR_RTOL, atol=0)
    with pytest.raises(ValueError, match="decay_steps"):
        td.distill_lr_schedule(lr, 1)


# ---------------------------------------------------------------------------
# the distillation step against JAX's
# ---------------------------------------------------------------------------

# (pred_type, cfg_scale, clip_grad): clip_grad 0 keeps JAX's clip stage,
# which zeroes the gradients (weight decay still moves the parameters)
CASES = {"eps-cfg1.5": ("eps", 1.5, 1.0), "v-cfg1.0": ("v", 1.0, 1.0),
         "v-cfg1.5": ("v", 1.5, 1.0), "v-cfg1.0-clip0": ("v", 1.0, 0.0)}


def _batch(rng, nan=False):
    b = {"clean": 0.5 * rng.standard_normal((B, 1, L)).astype(np.float32),
         "noisy": rng.standard_normal((B, 1, L)).astype(np.float32),
         "sigma": rng.uniform(0.5, 2.0, B).astype(np.float32),
         "mask": np.ones((B, 1, L), np.float32),
         "meta": rng.uniform(0.0, 1.0, (B, C_META)).astype(np.float32)}
    b["mask"][1, 0, :7] = 0.0
    if nan:
        b["clean"][0, 0, 3] = np.nan
    return b


def _jax_draws(key, n_student):
    """The j and eps0 JAX's step draws from ``key``."""
    k_j, k_q = jax.random.split(key)
    j = np.array(jax.random.randint(k_j, (B,), 0, n_student))
    eps0 = np.array(jax.random.normal(k_q, (B, 1, L), jnp.float32))
    return j, eps0


@pytest.fixture(scope="module")
def weights():
    """The JAX model and two of its parameter trees (host arrays)."""
    jm, student, _ = model_pair(L, seed=3, **SMALL)
    teacher = model_pair(L, seed=8, **SMALL)[1]
    return jm, jax.device_get(student), jax.device_get(teacher)


def _port_model(tree):
    m = unet.UNet1D(**SMALL, device="cpu")
    m.load_state_dict(params_from_flax(tree), strict=True)
    return m


@pytest.mark.parametrize("case", sorted(CASES))
def test_distill_step_matches_jax(case, weights):
    pred_type, cfg_scale, clip = CASES[case]
    jm, params, teacher_params = weights
    tm, tteacher = _port_model(params), _port_model(teacher_params)
    n_student, total = 4, 10
    cfg_kw = dict(teacher="t", data="d", cfg_scale=cfg_scale, lr=1e-3,
                  weight_decay=1e-4, ema_decay=0.99, clip_grad=clip)
    jcfg, tcfg = jd.DistillConfig(**cfg_kw), td.DistillConfig(**cfg_kw)
    jsched, tsched = jsch.make_schedule(1000), tsch.make_schedule(1000)
    ladder = jd._teacher_ladder(jsched, n_student, "lambda", 999)
    warm = min(100, max(1, total // 20))
    jopt = optax.chain(optax.clip_by_global_norm(clip), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, warm, total, 1e-4),
        weight_decay=1e-4))
    jstate = jt.TrainState(params=params,
                           ema_params=jax.tree_util.tree_map(jnp.copy, params),
                           opt_state=jopt.init(params),
                           step=jnp.zeros((), jnp.int32))
    jstep = jd.make_distill_step(jm, jsched, jcfg, jopt, ladder, pred_type)

    topt = td.distill_optimizer(tcfg, total)
    flat = tt.FlatParams(tm, "cpu")
    tt.FlatParams(tteacher, "cpu")
    tstate = tt.TrainState(params=flat, ema_params=flat.flat.clone(),
                           opt_state=topt.init(flat.flat),
                           step=torch.zeros((), dtype=torch.int32))
    tstep = td.make_distill_step(tm, tsched, tcfg, topt, ladder, pred_type)

    rng = np.random.default_rng(1)
    nan_case = case == "v-cfg1.5"
    for s in range(4 if nan_case else 3):
        b = _batch(rng, nan=nan_case and s == 1)
        key = jax.random.PRNGKey(10 + s)
        jstate, jm_ = jstep(jstate, teacher_params,
                            {k: jnp.asarray(v) for k, v in b.items()}, key)
        j, eps0 = _jax_draws(key, n_student)
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tb.update(j_inject=torch.from_numpy(j),
                  eps0_inject=torch.from_numpy(eps0))
        tm_ = tstep(tstate, tteacher, tb, 100 + s)
        assert bool(tm_["ok"]) == bool(jm_["ok"])
        if nan_case and s == 1:
            assert not bool(tm_["ok"])
            continue
        for k in ("loss", "grad_norm"):
            got, want = float(tm_[k]), float(jm_[k])
            assert abs(got - want) <= LOSS_RTOL * abs(want), (s, k, got, want)
    assert int(tstate.step) == int(jstate.step) == 3
    for jtree, buf, tol in ((jstate.params, flat.flat, PARAM_ATOL),
                            (jstate.ema_params, tstate.ema_params, EMA_ATOL)):
        want = params_from_flax(jax.device_get(jtree))
        diff = max(float((want[k] - v).abs().max())
                   for k, v in flat.views(buf).items())
        assert diff <= tol, diff


# ---------------------------------------------------------------------------
# distill() end to end
# ---------------------------------------------------------------------------

def test_distill_end_to_end_reads_in_both_packages(corpus, tmp_path):
    out = str(tmp_path / "distilled")
    res = tdistill_cli.main([
        "--teacher", corpus.ckpt, "--data", corpus.npz, "--model_dir", out,
        "--steps-schedule", "4,2", "--epochs", "2", "--batch-size", "4",
        "--lr", "1e-3", "--log-jsonl", str(tmp_path / "d.jsonl"),
        "--device", "cpu"])
    (path,) = res["checkpoints"]
    assert path == os.path.join(out, "model_distilled_2step.msgpack")
    assert len(res["history"]) == 2 and all(np.isfinite(h["loss"])
                                             for h in res["history"])
    ck = tck.load_checkpoint(path)
    args = ck["args"]
    assert {k: args[k] for k in ("distilled_steps", "distilled_cfg_scale",
                                 "distilled_ladder", "distilled_start_t",
                                 "selfcond_mode", "distilled_from",
                                 "distill_stage")} == {
        "distilled_steps": 2, "distilled_cfg_scale": 1.5,
        "distilled_ladder": "lambda", "distilled_start_t": 999,
        "selfcond_mode": "zero", "distilled_from": corpus.ckpt,
        "distill_stage": 1}
    assert ck["global_step"] == 2 * 3 and ck["epoch"] == 2
    assert "model_ema_state" in ck and "optimizer_state" not in ck
    with open(tmp_path / "d.jsonl") as fh:
        recs = [json.loads(ln) for ln in fh]
    assert [r["epoch"] for r in recs] == [1, 2]
    assert recs[0]["phase"] == "distill_epoch" and recs[0]["student_steps"] == 2

    jmodel, jparams, _, jargs = jinf.load_model(path)
    tmodel, _, targs = tinf.load_model(path, device="cpu")
    assert targs == jargs
    x = np.random.default_rng(0).standard_normal((2, 7, 512)).astype(np.float32)
    t = np.array([5, 900], np.int32)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    resolved = []
    for mod in (jinf, tinf):
        ns = argparse.Namespace(steps=None, cfg_scale=None, ladder=None,
                                start_t=None)
        mod.apply_distilled_defaults(ns, args)
        resolved.append(vars(ns))
    assert resolved[0] == resolved[1] == {"steps": 2, "cfg_scale": 1.0,
                                          "ladder": "lambda", "start_t": 999}


def test_distill_refuses_a_chain_that_does_not_halve(corpus, tmp_path):
    for chain in ([8], [8, 3]):
        with pytest.raises(ValueError, match="steps_schedule"):
            td.distill(td.DistillConfig(teacher=corpus.ckpt, data=corpus.npz,
                                        model_dir=str(tmp_path),
                                        steps_schedule=chain), device="cpu")


# ---------------------------------------------------------------------------
# model soups
# ---------------------------------------------------------------------------

def _members(tmp_path, base, n=3, args=None, shape_break=False):
    """``n`` JAX-written member checkpoints: ``base`` plus seeded noise."""
    rng = np.random.default_rng(20)

    def member():
        return jax.tree_util.tree_map(
            lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
            base)

    paths = []
    for i in range(n):
        params, ema = member(), member()
        if shape_break and i == 1:
            k = params["params"]["final"]["kernel"]
            params["params"]["final"]["kernel"] = np.zeros(
                (k.shape[0] + 1,) + k.shape[1:], k.dtype)
        p = str(tmp_path / f"m{i}.msgpack")
        a = dict(args if (args and i == 1) else CK)
        jck.save_checkpoint(p, params, a, epoch=3 + i, model_ema_state=ema)
        paths.append(p)
    return paths


@pytest.mark.parametrize("soup_w", [None, ["3", "1", "0.5"]])
def test_soup_byte_equal_to_jax(tmp_path, soup_w, weights):
    paths = _members(tmp_path, weights[1])
    weights = soup_w
    extra = ["--weights"] + weights if weights else []
    jout, tout = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    assert jsoup_cli.main(["--inputs", *paths, "--output", jout] + extra) == 0
    assert tsoup_cli.main(["--inputs", *paths, "--output", tout] + extra) == 0
    assert Path(tout).read_bytes() == Path(jout).read_bytes()
    assert (Path(tout + ".args.json").read_bytes()
            == Path(jout + ".args.json").read_bytes())
    got = tck.average_checkpoints(paths, weights and [float(w) for w in weights])
    w = np.asarray([float(x) for x in weights] if weights else [1.0] * 3)
    w = w / w.sum()
    cks = [tck.load_checkpoint(p) for p in paths]
    k = got["model_state"]["params"]["enc0"]["conv"]["kernel"]
    want = sum(wi * np.asarray(c["model_state"]["params"]["enc0"]["conv"]
                               ["kernel"], np.float64)
               for wi, c in zip(w, cks)).astype(np.float32)
    assert k.dtype == np.float32 and np.array_equal(k, want)
    assert got["epoch"] == 5 and got["args"]["soup_members"] == [
        os.path.basename(p) for p in paths]
    _, _, args = tinf.load_model(tout, device="cpu")
    assert args["soup_weights"] == ([float(x) for x in weights] if weights
                                    else [1.0] * 3)


@pytest.mark.parametrize("what", ["architecture", "shape", "one member",
                                  "weights"])
def test_soup_refusals_match_jax(tmp_path, what, capsys, weights):
    base = weights[1]
    if what == "architecture":
        paths = _members(tmp_path, base, 2, args=dict(CK, base_ch=32))
    elif what == "shape":
        paths = _members(tmp_path, base, 2, shape_break=True)
    else:
        paths = _members(tmp_path, base, 2)[: 1 if what == "one member" else 2]
    weights = [1.0] if what == "weights" else None
    errs = []
    for mod in (jck, tck):
        with pytest.raises(ValueError) as e:
            mod.average_checkpoints(paths, weights)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    argv = ["--inputs", *paths, "--output", str(tmp_path / "x.msgpack")]
    if weights:
        argv += ["--weights", "1"]
    assert tsoup_cli.main(argv) == 2
    assert "[soup] ERROR" in capsys.readouterr().err
    assert not (tmp_path / "x.msgpack").exists()


# ---------------------------------------------------------------------------
# the CLIs with JAX, flax, optax, msgpack, h5py, pandas and matplotlib blocked
# ---------------------------------------------------------------------------

def test_new_clis_run_without_jax(corpus, tmp_path):
    """gw-sweep, gw-grid, gw-distill and gw-soup on the .npz corpus with
    ``--device cpu`` and every JAX-side package, h5py, pandas and
    matplotlib blocked: each runs; gw-grid writes every CSV and JSON and
    says that the heatmaps were not drawn; the soup loads."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "h5py",
                     "pandas", "matplotlib",
                     "diffusion_models_for_gravitational_waveform_reconstruction_tpu"):
            sys.modules[name] = None
        import contextlib, io, json, os
        pkg = "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import distill, grid, soup, sweep
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference
        d, npz, ck = {str(tmp_path)!r}, {corpus.npz!r}, {corpus.ckpt!r}
        sweep.main(["--input-h5", npz, "--model", ck, "--outdir",
                    os.path.join(d, "sw"), "--grid", "--grid-steps", "2",
                    "--grid-snr", "8", "--grid-cfg", "1.5", "--grid-init",
                    "noise", "--grid-dc", "0", "--val-samples", "2",
                    "--device", "cpu"])
        assert {{"grid_results.json", "validation.json", "best_cmd.txt"}} <= set(
            os.listdir(os.path.join(d, "sw")))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = grid.main(["--input-h5", npz, "--model", ck, "--outdir",
                             os.path.join(d, "gr"), "--from-sweep",
                             os.path.join(d, "sw"), "--per-cell", "1",
                             "--device", "cpu"])
        out = buf.getvalue()
        assert "heat_corr.png and heat_mae.png not drawn" in out, out
        assert sorted(os.listdir(os.path.join(d, "gr"))) == [
            "metrics_grid.csv", "metrics_grid.json", "per_index_metrics.csv",
            "summary.json"]
        assert res["summary"]["n_cells"] == 4
        r = distill.main(["--teacher", ck, "--data", npz, "--model_dir",
                          os.path.join(d, "di"), "--steps-schedule", "8,4,2",
                          "--epochs", "1", "--batch-size", "4",
                          "--device", "cpu"])
        assert len(r["checkpoints"]) == 2
        assert soup.main(["--inputs", *r["checkpoints"], "--output",
                          os.path.join(d, "soup.msgpack")]) == 0
        m, _, a = inference.load_model(os.path.join(d, "soup.msgpack"),
                                       device="cpu")
        assert a["distilled_steps"] == 4 and len(a["soup_members"]) == 2
        bad = [k for k, v in sys.modules.items() if v is not None and
               k.split(".")[0] in ("jax", "flax", "optax", "msgpack", "h5py",
                                   "pandas", "matplotlib")]
        assert not bad, bad
        print("ok")
    """)
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("ok")
