"""The PyTorch port's trainer against the JAX package's: the train step on
the same weights (through ``params_from_flax``) and the same batches with
injected t and eps, the optimizer state's layout and the learning-rate
schedule, checkpoints resumed across the two packages both ways,
``train()`` end to end, the CLI's parser and the imports without JAX.

Tolerances (f32, the plain path on the CPU): the loss and the gradient norm
within 1e-4 relative at every step.  After the steps, parameters within
1e-4 absolute (measured up to 3e-5): AdamW's first steps are about
lr * sign(g), so a leaf whose gradient is near zero in both packages (the
zero-initialised ``final`` conv, the attention's ``proj``) may differ by up
to lr = 1e-3 per step; none came near.  EMA within 1e-6 (its new share is
1 - decay = 1e-3 of the parameters').
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from diffusion_models_for_gravitational_waveform_reconstruction_tpu import inference as jinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.cli import train as jcli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.utils import checkpoint as jck
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference as tinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import train as tcli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline as tpipe
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils import checkpoint as tck
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import params_from_flax

jt = importlib.import_module(
    "diffusion_models_for_gravitational_waveform_reconstruction_tpu.training.train")
tt = importlib.import_module(
    "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.training.train")

B, L, C_META = 4, 64, 4
BASE = dict(epochs=1, batch_size=B, lr=1e-3, T=100, base_ch=8, time_dim=16,
            depth=1, seed=0, t_min_frac=0.0, warmup_steps=2, bf16=False,
            data_parallel=False)
# eps / v targets, huber / mse, a loss weight, t_multi 2, the plain and the
# attention U-Net; p_uncond and p_selfcond 0 or 1 make both coins certain
# (each case costs a JAX compile of its step)
CASES = {
    "eps-huber-plain": dict(pred_type="eps", loss="huber", p_u=0.0, p_sc=0.0),
    "v-mse-weighted-tmulti2-attention": dict(
        pred_type="v", loss="mse", loss_weight_power=1.0, t_multi=2,
        use_attention=True, p_u=1.0, p_sc=1.0),
}
LOSS_RTOL, PARAM_ATOL, EMA_ATOL = 1e-4, 1e-4, 1e-6


def _batch(rng, K=1, nan=False):
    b = {"clean": 0.5 * rng.standard_normal((B, 1, L)).astype(np.float32),
         "noisy": rng.standard_normal((B, 1, L)).astype(np.float32),
         "sigma": rng.uniform(0.5, 2.0, B).astype(np.float32),
         "mask": np.ones((B, 1, L), np.float32),
         "meta": rng.uniform(0.0, 1.0, (B, C_META)).astype(np.float32),
         "t_inject": rng.integers(0, 100, B * K).astype(np.int32),
         "eps_inject": rng.standard_normal((B * K, 1, L)).astype(np.float32)}
    b["mask"][0, 0, :5] = 0.0
    if nan:
        b["clean"][0, 0, 3] = np.nan
    return b


class Pair:
    """One configuration built in both packages from the JAX package's
    initial weights; JAX's jitted step is compiled once per configuration
    and shared by the tests."""

    def __init__(self, name):
        kw = dict(CASES[name])
        self.p_u, self.p_sc = kw.pop("p_u"), kw.pop("p_sc")
        self.cfg = dict(BASE, **kw)
        self.K = self.cfg.get("t_multi", 1)
        jcfg = jt.TrainConfig(**self.cfg)
        (self.jmodel, self.jsched, self.jopt, self.jlr, self.jstate0,
         _) = jt.build_model_and_state(jcfg, C_META, L, 10,
                                       jax.random.PRNGKey(0))
        self.jstep = jt.make_train_step(self.jmodel, self.jsched, jcfg,
                                        self.jopt, self.jlr)

    def port(self, jstate):
        """The port's state and step, loaded with ``jstate``'s weights."""
        tcfg = tt.TrainConfig(**self.cfg)
        model, sched, opt, lr, state, _ = tt.build_model_and_state(
            tcfg, C_META, 10, 0, device="cpu")
        state.params.load_(state.params.flat, params_from_flax(jstate.params))
        state.params.load_(state.ema_params, params_from_flax(jstate.ema_params))
        return state, opt, tt.make_train_step(model, sched, tcfg, opt, lr)

    def jax_step(self, state, b, seed=0):
        return self.jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.PRNGKey(seed), jnp.asarray(0),
                          jnp.asarray(self.p_u), jnp.asarray(self.p_sc))

    def port_step(self, step, state, b, key=7):
        return step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                    key, 0, self.p_u, self.p_sc)


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, name):
    if name not in pairs:
        pairs[name] = Pair(name)
    return pairs[name]


def _max_leaf_diff(jtree, tflat, flatp):
    want = params_from_flax(jtree)
    return max(float((want[k] - v).abs().max())
               for k, v in flatp.views(tflat).items())


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_jax(pairs, name):
    """Three steps on the same batches; in the first case a fourth batch
    holds a NaN, which both packages' gates refuse."""
    p = _pair(pairs, name)
    jstate = jax.tree_util.tree_map(jnp.copy, p.jstate0)
    tstate, _, tstep = p.port(jstate)
    rng = np.random.default_rng(1)
    bad = name == "eps-huber-plain"
    for s in range(4 if bad else 3):
        b = _batch(rng, p.K, nan=bad and s == 1)
        jstate, jm = p.jax_step(jstate, b, s)
        tm = p.port_step(tstep, tstate, b, 100 + s)
        if bad and s == 1:
            assert not bool(jm["ok"]) and not bool(tm["ok"])
            continue
        assert bool(jm["ok"]) and bool(tm["ok"])
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, err_msg=f"step {s} {k}")
        assert int(tm["t_min"]) == int(jm["t_min"])
        assert tm["bsz_eff"] == int(jm["bsz_eff"]) == B * p.K
    assert int(tstate.step) == int(jstate.step) == 3
    flatp = tstate.params
    assert _max_leaf_diff(jstate.params, flatp.flat, flatp) <= PARAM_ATOL
    assert _max_leaf_diff(jstate.ema_params, tstate.ema_params,
                          flatp) <= EMA_ATOL
    jopt = serialization.to_state_dict(jstate.opt_state)
    topt = tstate.opt_state
    assert int(jopt["1"]["0"]["count"]) == int(topt.count) == 3
    assert int(jopt["1"]["2"]["count"]) == int(topt.sched_count) == 3
    assert _max_leaf_diff(jopt["1"]["0"]["mu"], topt.mu, flatp) <= 1e-4


def test_refused_batch_changes_nothing(pairs):
    p = _pair(pairs, "eps-huber-plain")
    tstate, _, tstep = p.port(p.jstate0)
    before = [tstate.params.flat.clone(), tstate.ema_params.clone(),
              *(a.clone() for a in tstate.opt_state), tstate.step.clone()]
    b = _batch(np.random.default_rng(2))
    b["eps_inject"][1, 0, 7] = np.nan
    m = p.port_step(tstep, tstate, b)
    assert not bool(m["ok"])
    after = [tstate.params.flat, tstate.ema_params, *tstate.opt_state,
             tstate.step]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    # a loss above the threshold is refused too
    tcfg = tt.TrainConfig(**dict(p.cfg, skip_loss_threshold=1e-6))
    model, sched, opt, lr, state, _ = tt.build_model_and_state(
        tcfg, C_META, 10, 0, device="cpu")
    m = tt.make_train_step(model, sched, tcfg, opt, lr)(
        state, {k: torch.from_numpy(v) for k, v in _batch(
            np.random.default_rng(3)).items()}, 1, 0, 0.0, 0.0)
    assert not bool(m["ok"]) and int(state.step) == 0


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_optimizer_state_has_optax_layout(clip):
    """The state tree matches ``to_state_dict`` of optax's init key for
    key, with the same leaf shapes and dtypes."""
    cfg = dict(BASE, clip_grad=clip)
    jm, _, jopt, _, jstate, _ = jt.build_model_and_state(
        jt.TrainConfig(**cfg), C_META, L, 10, jax.random.PRNGKey(0))
    want = serialization.to_state_dict(jstate.opt_state)
    _, _, opt, _, state, _ = tt.build_model_and_state(
        tt.TrainConfig(**cfg), C_META, 10, 0, device="cpu")
    got = opt.state_tree(state.opt_state, state.params)

    def shapes(tree):
        return jax.tree_util.tree_map(
            lambda a: (tuple(np.shape(a)), str(np.asarray(
                a.float() if isinstance(a, torch.Tensor) and a.is_floating_point()
                else a).dtype)), tree)

    assert shapes(tck._tree_to_host(got)) == shapes(want)


def test_lr_schedule_matches_jax():
    for cosine in (True, False):
        cfg = dict(BASE, warmup_steps=5, cosine_decay=cosine)
        jl = jt.make_lr_schedule(jt.TrainConfig(**cfg), 40)
        tl = tt.make_lr_schedule(tt.TrainConfig(**cfg), 40)
        for s in (0, 3, 4, 5, 6, 20, 39, 40, 60):
            np.testing.assert_allclose(float(tl(torch.tensor(s, dtype=torch.int32))),
                                       float(jl(s)), rtol=1e-6)


def _jax_ckpt_state(p, path, steps=2):
    """JAX state after ``steps`` steps, written by the JAX writer."""
    jstate = jax.tree_util.tree_map(jnp.copy, p.jstate0)
    rng = np.random.default_rng(5)
    for s in range(steps):
        jstate, _ = p.jax_step(jstate, _batch(rng, p.K), s)
    jt._save(os.path.dirname(path), jstate, jt.TrainConfig(**p.cfg), 7, 5,
             C_META, {"M": 80.0, "q": 10.0}, 1,
             name=os.path.basename(path), key=jax.random.PRNGKey(9))
    return jstate


def test_port_checkpoint_resumes_in_jax(pairs, tmp_path):
    """The port's checkpoint (optimizer state in optax's layout) restores
    into the JAX trainer's state, and the next step's loss agrees."""
    p = _pair(pairs, "eps-huber-plain")
    tstate, opt, tstep = p.port(p.jstate0)
    rng = np.random.default_rng(6)
    for s in range(2):
        p.port_step(tstep, tstate, _batch(rng), s)
    tt._save(str(tmp_path), tstate, tt.TrainConfig(**p.cfg), 7, 5, C_META,
             {"M": 80.0, "q": 10.0}, 1, key=12345, optimizer=opt)
    ck = jck.load_checkpoint(str(tmp_path / "model_diffusion.msgpack"))
    assert ck["global_step"] == 2
    assert np.asarray(ck["rng_key"]).dtype == np.uint32
    js = p.jstate0
    jstate = jt.TrainState(
        params=jck.restore_params(js.params, ck["model_state"]),
        ema_params=jck.restore_params(js.ema_params, ck["model_ema_state"]),
        opt_state=jck.restore_params(js.opt_state, ck["optimizer_state"]),
        step=jnp.asarray(ck["global_step"], jnp.int32))
    b = _batch(rng)
    _, jm = p.jax_step(jstate, b)
    tm = p.port_step(tstep, tstate, b)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=LOSS_RTOL)


def test_jax_checkpoint_resumes_in_port(pairs, tmp_path):
    """A JAX checkpoint restores into the port's state (step, counts, key)
    and the next step's loss agrees; the port's ``train`` resumes from it
    at the next epoch and global step."""
    p = _pair(pairs, "eps-huber-plain")
    path = str(tmp_path / "jax.msgpack")
    jstate = _jax_ckpt_state(p, path)
    tstate, opt, tstep = p.port(p.jstate0)
    ck = tck.load_checkpoint(path)
    assert tt.restore_state(tstate, opt, ck, 4) == 2
    assert int(tstate.opt_state.count) == int(tstate.opt_state.sched_count) == 2
    assert tt.key_from_array(ck["rng_key"]) == tt.key_from_array(
        np.asarray(jax.random.PRNGKey(9)))
    b = _batch(np.random.default_rng(7))
    _, jm = p.jax_step(jstate, b)
    tm = p.port_step(tstep, tstate, b)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)

    ds = _tiny_dataset(8)
    out = tt.train(tt.TrainConfig(**dict(p.cfg, epochs=2, resume=path,
                                         model_dir=str(tmp_path / "m"))),
                   dataset=ds, device="cpu")
    assert [h["epoch"] for h in out["history"]] == [2]
    assert int(out["state"].step) == 2 + tpipe.num_batches(ds, B)


def _tiny_dataset(n=16, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / L
    clean = np.stack([np.sin(2 * np.pi * (3 + i % 4) * t) for i in range(n)])
    noisy = clean + 0.5 * rng.standard_normal((n, L))
    meta = rng.uniform(0.2, 0.8, (n, C_META))
    return tpipe.dataset_from_arrays(clean, noisy, 1024.0, meta=meta)


def test_train_end_to_end(tmp_path):
    """The loss falls, the JSONL has every phase, the first-batch debug
    dump is written, and both packages' ``load_model`` read the checkpoint
    (which carries the optimizer state, step and key)."""
    log = tmp_path / "log.jsonl"
    cfg = tt.TrainConfig(**dict(BASE, epochs=4, lr=3e-3, warmup_steps=4,
                                p_uncond=0.2, p_selfcond=0.3,
                                model_dir=str(tmp_path), log_jsonl=str(log),
                                probe_cond=True, probe_t=(10, 50),
                                probe_interval=2, debug_first=True,
                                save_every_epochs=2))
    out = tt.train(cfg, dataset=_tiny_dataset(), device="cpu")
    hist = out["history"]
    assert hist[-1]["avg_per_sample"] < hist[0]["avg_per_sample"]
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert {r["phase"] for r in recs} == {"train_batch", "probe", "epoch_end"}
    assert sum(r["phase"] == "train_batch" for r in recs) == 4 * 4
    files = set(os.listdir(out["out_dir"]))
    assert {"model_diffusion.msgpack", "model_diffusion_ep2.msgpack",
            "debug_batch0"} <= files
    ck = tck.load_checkpoint(out["checkpoint"])
    assert ck["global_step"] == 16 and ck["epoch"] == 4
    assert set(ck["optimizer_state"]) == {"0", "1"}
    assert ck["args"]["in_ch"] == 7 and ck["args"]["cond_in_ch"] == 5
    x = np.random.default_rng(3).standard_normal((2, 7, L)).astype(np.float32)
    t = np.array([5, 60])
    tm, _, _ = tinf.load_model(out["checkpoint"], device="cpu")
    jm, jparams, _, _ = jinf.load_model(out["checkpoint"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    want = np.asarray(jm.apply(jparams, jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_train_refuses_what_is_not_ported(tmp_path, capsys):
    """``--tp 2`` in one process: JAX's message that tensor parallelism is
    dropped, then the run trains as at tp 1; a mesh that is not a mesh is
    refused."""
    ds = _tiny_dataset(4)
    out = tt.train(tt.TrainConfig(**dict(BASE, model_dir=str(tmp_path),
                                         tp=2)), dataset=ds, device="cpu")
    assert ("[train] --tp 2 requested but only 1 device(s) visible; tensor "
            "parallelism dropped") in capsys.readouterr().out.splitlines()
    assert len(out["history"]) == 1 and os.path.exists(out["checkpoint"])
    with pytest.raises(TypeError, match="make_mesh"):
        tt.train(tt.TrainConfig(**dict(BASE, model_dir=str(tmp_path))),
                 dataset=ds, mesh=object(), device="cpu")


def test_parser_matches_jax():
    """Flag for flag, with the same defaults, types and choices; and
    ``config_from_args`` gives the same config."""
    def actions(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         a.choices, a.nargs, a.required)
                for a in p._actions if a.dest != "help"}

    assert actions(tcli.build_parser()) == actions(jcli.build_parser())
    argv = ["--data", "synth:8", "--epochs", "3", "--pred_type", "v",
            "--t_min_frac", "0", "--no-bf16", "--remat", "--probe-t", "5", "9"]
    got = tcli.config_from_args(tcli.build_parser().parse_args(argv))
    want = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_train_imports_without_jax(tmp_path):
    """With jax, flax, optax, msgpack, h5py and the JAX package blocked, the
    trainer and its CLI, ``parallel.mesh``, ``parallel.seqtile``,
    ``graft_entry`` and ``inference`` import, and ``gw-train --data synth:4`` trains and
    writes its checkpoint; an HDF5 corpus explains that it needs h5py."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "h5py",
                     "diffusion_models_for_gravitational_waveform_reconstruction_tpu"):
            sys.modules[name] = None
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.training import train
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import train as cli
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel import mesh, seqtile
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import graft_entry, inference
        out = cli.main(["--data", "synth:4", "--model_dir", {str(tmp_path)!r},
                        "--epochs", "1", "--batch-size", "2", "--base_ch",
                        "8", "--time_dim", "16", "--depth", "2", "--device",
                        "cpu", "--no-bf16"])
        assert len(out["history"]) == 1
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.checkpoint import load_checkpoint
        ck = load_checkpoint(out["checkpoint"])
        assert ck["args"]["data"] == "synth:4" and ck["args"]["fs"] == 4096.0
        assert ck["global_step"] == 2 and set(ck["optimizer_state"]) == {{"0", "1"}}
        try:
            pipeline.prepare_dataset({str(tmp_path / "none.h5")!r})
            raise AssertionError("prepare_dataset ran without h5py")
        except ImportError as e:
            assert "synth:N" in str(e)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
