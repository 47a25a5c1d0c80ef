"""The port's data parallelism and sequence tiling against the JAX package,
on the CPU: ``receptive_field_radius`` and ``tiled_apply`` (plain and
attention U-Net, ragged L, default and explicit halo), ``reconstruct``
with tiles and the infer CLI with ``--tiled-chunk`` (JAX's noise
injected), ``reconstruct_batch`` and the train step data-parallel on two
gloo ranks, ``train(mesh=)`` end to end, ``make_mesh``'s messages,
``multihost_init`` and ``dryrun_multichip``.

The ranks are two spawned processes joined in one gloo group for the whole
module (:class:`RankPool`); each case sends them a function of this module
and compares what they return with the JAX package and with the port's
call without a mesh, run here.  Tolerances: against JAX 1e-4 relative in
f32 (``REL_TOL``; the train step as in ``test_torch_port_train.py``);
sharded against unsharded 1e-6 (the same arithmetic per row; only the
batch size of each product differs).
"""
import json
import multiprocessing
import os
import socket
import traceback
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from diffusion_models_for_gravitational_waveform_reconstruction_tpu import inference as jinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.cli import infer as jcli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import hdf5io as jio
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops import sampling as jsp
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops import schedules as jsch
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.parallel import mesh as jmesh
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.parallel import seqtile as jseq
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.utils import checkpoint as jck
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import graft_entry
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference as tinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import infer as tcli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline as tpipe
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import sampling as tsp
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import schedules as tsch
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel import mesh as tmesh
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel import seqtile as tseq
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils import checkpoint as tck
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import params_from_flax
from test_torch_port_infer import CK, META, _read_run, synth
from test_torch_port_train import jt, tt
from test_torch_port_sampling import jax_noise
from test_torch_port_unet import REL_TOL, SMALL, model_pair, rel_err

SHARD_TOL = 1e-6
N_RANKS = 2
TILE_KW = dict(in_ch=3, base_ch=8, time_dim=16, depth=2, cond_in_ch=1,
               use_selfcond=True)


# ---------------------------------------------------------------------------
# two ranks in one gloo group, kept for the module
# ---------------------------------------------------------------------------

def _rank_loop(rank, n, port, inbox, outbox):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    mesh = tmesh.make_mesh()
    for fn, args in iter(inbox.get, None):
        try:
            outbox.put((rank, True, fn(mesh, *args)))
        except Exception:                   # reported to the test
            outbox.put((rank, False, traceback.format_exc()))
    dist.barrier()
    # as graft_entry's ranks: no interpreter teardown after gloo
    outbox.close()
    outbox.join_thread()
    os._exit(0)


class RankPool:
    """``n`` spawned processes in one gloo group on the CPU; ``run(fn,
    *args)`` calls ``fn(mesh, *args)`` on each (``mesh`` = ``make_mesh()``
    over all of them) and returns their results in rank order."""

    def __init__(self, n):
        ctx = multiprocessing.get_context("spawn")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.inboxes = [ctx.Queue() for _ in range(n)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_loop, daemon=True,
                                  args=(r, n, port, self.inboxes[r],
                                        self.outbox)) for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args):
        for q in self.inboxes:
            q.put((fn, args))
        got = dict((r, (ok, v)) for r, ok, v in (
            self.outbox.get(timeout=240) for _ in self.inboxes))
        errors = [v for ok, v in got.values() if not ok]
        assert not errors, "\n".join(errors)
        return [got[r][1] for r in range(len(self.inboxes))]

    def close(self):
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N_RANKS)
    yield p
    p.close()


def _port_model(state, **kw):
    m = UNet1D(**kw, device="cpu").eval()
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return m


def _numpy_state(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# parallel.mesh
# ---------------------------------------------------------------------------

def test_make_mesh_messages_match_jax():
    devs = jax.devices()[:2]
    for kw in (dict(n_data=4), dict(n_model=3)):
        with pytest.raises(AssertionError) as want:
            jmesh.make_mesh(devices=devs, **kw)
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(devices=[0, 1], **kw)
        assert str(got.value) == str(want.value)
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None


def test_multihost_init_picks_the_backend_once(monkeypatch):
    """A no-op without ``WORLD_SIZE`` (or with 1); with several processes
    one ``init_process_group`` on the device's backend, nothing retried."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend: calls.append(backend))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    tmesh.multihost_init(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    tmesh.multihost_init(device="cpu")
    assert calls == [] and not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    tmesh.multihost_init(device="cpu")
    pinned = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", pinned.append)
    tmesh.multihost_init()
    assert calls == ["gloo", "nccl"] and pinned == [1]


def test_rank0_writes_points_other_ranks_away(monkeypatch, tmp_path):
    """Rank 0 keeps its paths; another rank's set paths point into a
    temporary directory, and unset ones stay unset."""
    args = types.SimpleNamespace(outdir=str(tmp_path / "out"), log_jsonl=None)
    tmesh.rank0_writes(args, "outdir", "log_jsonl")
    assert args.outdir == str(tmp_path / "out") and args.log_jsonl is None
    monkeypatch.setattr(tmesh, "process_index", lambda: 1)
    tmesh.rank0_writes(args, "outdir", "log_jsonl")
    assert "gw-rank1-" in args.outdir and not args.outdir.startswith(
        str(tmp_path)) and args.log_jsonl is None


def _small_sampler_args():
    model = UNet1D(in_ch=7, base_ch=8, time_dim=16, depth=1, cond_in_ch=5,
                   use_selfcond=True, device="cpu")
    return (model, tsch.make_schedule(100), np.zeros((3, 5, 32), np.float32),
            np.ones(3), tsp.SamplerConfig(steps=2))


def _uneven_batch_on_rank(mesh):
    """The error a rank raises for 3 rows over 2 ranks (before any
    collective, so every rank raises it)."""
    try:
        tinf.reconstruct_batch(*_small_sampler_args(), torch.Generator(),
                               mesh=mesh, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def _model_axis_on_rank(mesh):
    m = tmesh.make_mesh(n_data=1, n_model=2)
    return m.shape, m.rank, m.model_rank


def test_mesh_arguments_are_checked(pool):
    model, ts, cond, sig, cfg = _small_sampler_args()
    with pytest.raises(TypeError, match="make_mesh"):
        tinf.reconstruct_batch(model, ts, cond, sig, cfg,
                               torch.Generator(), mesh=object(), device="cpu")
    for msg in pool.run(_uneven_batch_on_rank):
        assert msg is not None and "split evenly" in msg
    with pytest.raises(TypeError, match="make_mesh"):
        tseq.tiled_apply(model, torch.zeros(1, 7, 64), torch.zeros(1),
                         mesh="data")
    # a mesh is whole or not built: a data axis of several ranks needs
    # their group, and the rank lies on the axis
    with pytest.raises(ValueError, match="needs a process group"):
        tmesh.Mesh(2)
    with pytest.raises(ValueError, match="outside"):
        tmesh.Mesh(1, rank=1)
    # so does a model axis of several ranks; on the ranks' group a 1x2
    # mesh puts process m at model index m
    for tp in (lambda: tmesh.make_mesh(n_data=1, n_model=2, devices=[0, 1]),
               lambda: tmesh.Mesh(1, 2)):
        with pytest.raises(ValueError, match="needs a process group"):
            tp()
    for r, shape in enumerate(pool.run(_model_axis_on_rank)):
        assert shape == ({"data": 1, "model": 2}, 0, r)


# ---------------------------------------------------------------------------
# parallel.seqtile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", [3, 5])
def test_receptive_field_radius_matches_jax(kernel):
    for depth in range(1, 6):
        assert (tseq.receptive_field_radius(depth, kernel)
                == jseq.receptive_field_radius(depth, kernel))


@pytest.fixture(scope="module")
def tile_models():
    return {attn: model_pair(256, seed=3, use_attention=attn, **TILE_KW)
            for attn in (False, True)}


TILE_CASES = {"plain-L4096-default-halo": (False, 4096, None),
              "plain-L3000-halo100": (False, 3000, 100),
              "attention-L3000-default-halo": (True, 3000, None),
              "attention-L4096-halo64": (True, 4096, 64)}


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tiled_apply_matches_jax(tile_models, case):
    attn, L, halo = TILE_CASES[case]
    jm, params, tm = tile_models[attn]
    x = np.random.default_rng(L).standard_normal((2, 3, L)).astype(np.float32)
    t = np.array([100, 300])
    want = jax.jit(lambda p, x_, t_: jseq.tiled_apply(
        jm, p, x_, t_, chunk=1024, halo=halo))(params, x, t)
    with torch.no_grad():
        got = tseq.tiled_apply(tm, torch.from_numpy(x), torch.from_numpy(t),
                               chunk=1024, halo=halo)
    assert got.shape == want.shape == (2, 1, L)
    assert rel_err(got.numpy(), want) <= REL_TOL


def _tiled_on_rank(mesh, state, x, t):
    model = _port_model(state, use_attention=True, **TILE_KW)
    with torch.no_grad():
        return tseq.tiled_apply(model, torch.from_numpy(x),
                                torch.from_numpy(t), chunk=1024,
                                mesh=mesh).numpy()


def test_tiled_apply_mesh_matches_unmeshed(pool, tile_models):
    """3 tiles over 2 ranks: each rank runs 2 rows of tiles (one a dummy)
    and both return the unmeshed call's output."""
    tm = tile_models[True][2]
    x = np.random.default_rng(7).standard_normal((2, 3, 3000)).astype(np.float32)
    t = np.array([50, 700])
    with torch.no_grad():
        want = tseq.tiled_apply(tm, torch.from_numpy(x), torch.from_numpy(t),
                                chunk=1024).numpy()
    for got in pool.run(_tiled_on_rank, _numpy_state(tm), x, t):
        assert got.shape == want.shape == (2, 1, 3000)
        assert rel_err(got, want) <= SHARD_TOL


# ---------------------------------------------------------------------------
# inference: reconstruct with tiles, the infer CLI, reconstruct_batch(mesh=)
# ---------------------------------------------------------------------------

LT = 2048         # two tiles of 1024


@pytest.fixture(scope="module")
def pair():
    jm, params, tm = model_pair(256, **SMALL)
    clean, noise, P = synth(LT, 4096.0, 3, amp=1.0)
    prep = jinf.prepare_measurement(
        (clean + noise).astype(np.float32), clean.astype(np.float32), 4096.0,
        P, (None, None), META, cond_in_ch=5, M_SCALE=60.0, Q_SCALE=5.0,
        whiten=True, whiten_mode="model")
    return types.SimpleNamespace(jm=jm, params=params, tm=tm, prep=prep,
                                 js=jsch.make_schedule(1000),
                                 ts=tsch.make_schedule(1000))


def test_reconstruct_tiled_matches_jax(pair):
    cfg_kw = dict(steps=3, pred_type="v", cfg_scale=1.5)
    key = jax.random.PRNGKey(5)
    kw = dict(tiled_chunk=1024, avg_seeds=2, amp_calib="mf")
    want = jinf.reconstruct(pair.jm, pair.params, pair.js, pair.prep,
                            jsp.SamplerConfig(**cfg_kw), key, **kw)
    tcfg = tsp.SamplerConfig(**cfg_kw)
    n = len(tsp._t_ladder(pair.ts, tcfg))
    got = tinf.reconstruct(pair.tm, pair.ts, pair.prep, tcfg,
                           jax_noise(key, n, (2, 1, LT)), device="cpu", **kw)
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == np.asarray(w).shape == (LT,)
        assert rel_err(g, w) <= REL_TOL


@pytest.fixture(scope="module")
def long_corpus(tmp_path_factory):
    """A JAX-written HDF5 corpus of two 2048-sample measurements and a
    JAX-written checkpoint."""
    d = tmp_path_factory.mktemp("tiled_cli")
    cols = {k: [] for k in ("sig", "noi", "noisy", "times", "P")}
    for i in range(2):
        clean, noise, P = synth(LT, 4096.0, 20 + i)
        for k, v in zip(cols, (clean, noise, clean + noise,
                               np.arange(LT) / 4096.0, P)):
            cols[k].append(v)
    h5 = str(d / "corpus.h5")
    jio.write_dataset(h5, cols["sig"], cols["noi"], cols["noisy"],
                      cols["times"], {k: [v, v + 1.0] for k, v in META.items()},
                      4096.0, psd_model=cols["P"])
    _, params, _ = model_pair(256, seed=4, **SMALL)
    ckpt = str(d / "model.msgpack")
    jck.save_checkpoint(ckpt, params, CK, epoch=1)
    return types.SimpleNamespace(dir=d, h5=h5, ckpt=ckpt)


def test_infer_cli_tiled_chunk_matches_jax(long_corpus, monkeypatch):
    """The twin of the JAX package's ``test_seqtile.py::
    test_infer_cli_tiled_chunk``: ``--tiled-chunk 1024`` through both CLIs
    on the same corpus and checkpoint, file for file and metric for
    metric."""
    c = long_corpus
    common = ["--input-h5", c.h5, "--index", "1", "--model", c.ckpt,
              "--steps", "3", "--tiled-chunk", "1024", "--seed", "2",
              "--run-tag", "t"]
    jout, tout = str(c.dir / "jax_out"), str(c.dir / "port_out")
    jcli.main(common + ["--outdir", jout])
    key = jax.random.PRNGKey(2)
    monkeypatch.setattr(tcli, "_noise", lambda seed, device: (
        jax_noise(key, 3, (1, 1, LT)), None))
    tcli.main(common + ["--outdir", tout, "--device", "cpu"])
    jfiles, jarr, jm = _read_run(jout)
    tfiles, tarr, tm = _read_run(tout)
    assert tfiles == jfiles
    assert rel_err(tarr["recon"], jarr["recon"]) <= REL_TOL

    def close(got, want, path=""):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                close(got[k], want[k], f"{path}.{k}")
        elif isinstance(want, str):
            assert got == want, path
        else:
            assert abs(got - want) <= REL_TOL * abs(want) + 1e-12, (path, got,
                                                                    want)

    close(tm, jm)
    assert np.isfinite(tm["strain"]["corr_last"])


BATCH_CASES = {
    # (B, avg_seeds, reconstruct_batch keywords, sampler knobs)
    "seeds2-mf-seed_std": (2, 2, dict(amp_calib="mf", return_seed_std=True),
                           dict(steps=3, eta=0.5)),
    "extra_model": (2, 1, dict(), dict(steps=3, ladder="lambda")),
}


def _batch_on_rank(mesh, states, cond, sigmas, cfg_kw, kw, noise):
    models = [_port_model(s, **SMALL) for s in states]
    if mesh.rank == 1:
        # another rank's weights are replaced by data rank 0's
        with torch.no_grad():
            for m in models:
                for p in m.parameters():
                    p.add_(1.0)
    with torch.no_grad():
        return tinf.reconstruct_batch(
            models[0], tsch.make_schedule(1000), cond, sigmas,
            tsp.SamplerConfig(**cfg_kw), tsp.FixedNoise(*noise), mesh=mesh,
            extra_models=models[1:], device="cpu", **kw)


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_reconstruct_batch_mesh_matches_unsharded_and_jax(pool, pair, case):
    B, S, kw, cfg_kw = BATCH_CASES[case]
    cfg_kw = dict(cfg_kw, pred_type="v", cfg_scale=1.5)
    rng = np.random.default_rng(11)
    cond = rng.standard_normal((B, 5, 256)).astype(np.float32)
    sigmas = np.array([0.5, 2.0], np.float32)
    extra = [model_pair(256, seed=8, **SMALL)] if case == "extra_model" else []
    key = jax.random.PRNGKey(4)
    want = jinf.reconstruct_batch(
        pair.jm, pair.params, pair.js, cond, sigmas,
        jsp.SamplerConfig(**cfg_kw), key, avg_seeds=S,
        extra_models=[(jm, p) for jm, p, _ in extra], **kw)
    tcfg = tsp.SamplerConfig(**cfg_kw)
    fixed = jax_noise(key, len(tsp._t_ladder(pair.ts, tcfg)), (B * S, 1, 256))
    kw = dict(kw, avg_seeds=S)
    models = [pair.tm] + [tm for _, _, tm in extra]
    with torch.no_grad():
        alone = tinf.reconstruct_batch(pair.tm, pair.ts, cond, sigmas, tcfg,
                                       fixed, extra_models=models[1:],
                                       device="cpu", **kw)
    got = pool.run(_batch_on_rank, [_numpy_state(m) for m in models], cond,
                   sigmas, cfg_kw, kw, (fixed._init, fixed._steps))
    as_tuple = (lambda r: r if isinstance(r, tuple) else (r,))
    for g in got:
        for gi, ai, wi in zip(as_tuple(g), as_tuple(alone), as_tuple(want)):
            assert gi.shape == ai.shape == np.asarray(wi).shape == (B, 256)
            assert rel_err(gi, ai) <= SHARD_TOL
            assert rel_err(gi, wi) <= REL_TOL


# ---------------------------------------------------------------------------
# training: the step on two ranks, train(mesh=) end to end
# ---------------------------------------------------------------------------

GB, TL, C_META = 8, 64, 4          # global batch (4 a rank), length, meta
TRAIN_BASE = dict(epochs=1, batch_size=GB, lr=1e-3, T=100, base_ch=8,
                  time_dim=16, depth=1, seed=0, t_min_frac=0.0,
                  warmup_steps=2, bf16=False, data_parallel=False)
# (config, p_uncond, the self-conditioning probability of each step; the
# eps case's second batch holds a NaN in rank 1's rows)
STEP_CASES = {
    "eps-huber-nan": (dict(pred_type="eps", loss="huber"), 0.0,
                      (1.0, 1.0, 0.0, 1.0)),
    "v-mse-tmulti2": (dict(pred_type="v", loss="mse", t_multi=2), 1.0,
                      (0.0, 1.0, 0.0)),
}
LOSS_RTOL, PARAM_ATOL, EMA_ATOL = 1e-4, 1e-4, 1e-6


def _train_batch(rng, K=1, nan=False):
    b = {"clean": 0.5 * rng.standard_normal((GB, 1, TL)).astype(np.float32),
         "noisy": rng.standard_normal((GB, 1, TL)).astype(np.float32),
         "sigma": rng.uniform(0.5, 2.0, GB).astype(np.float32),
         "mask": np.ones((GB, 1, TL), np.float32),
         "meta": rng.uniform(0.0, 1.0, (GB, C_META)).astype(np.float32),
         "t_inject": rng.integers(0, 100, GB * K).astype(np.int32),
         "eps_inject": rng.standard_normal((GB * K, 1, TL)).astype(np.float32)}
    b["mask"][5, 0, :7] = 0.0
    if nan:
        b["clean"][6, 0, 3] = np.nan           # a row of rank 1
    return b


def _steps_on_rank(mesh, cfg, weights, batches, p_u, p_scs, keys):
    """The port's state loaded with ``weights``, stepped on ``batches``
    with ``mesh``; returns each step's metrics and the final buffers."""
    tcfg = tt.TrainConfig(**cfg)
    model, sched, opt, lr, state, _ = tt.build_model_and_state(
        tcfg, C_META, 10, 0, device="cpu")
    if weights is not None:
        for buf in (state.params.flat, state.ema_params):
            state.params.load_(buf, {k: torch.from_numpy(v)
                                     for k, v in weights.items()})
    step = tt.make_train_step(model, sched, tcfg, opt, lr, mesh)
    metrics = []
    for b, p_sc, key in zip(batches, p_scs, keys):
        m = step(state, {k: torch.from_numpy(v) for k, v in b.items()}, key,
                 0, p_u, p_sc)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {"flat": state.params.flat.numpy().copy(),
                     "ema": state.ema_params.numpy().copy(),
                     "mu": state.opt_state.mu.numpy().copy(),
                     "step": int(state.step)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_on_two_ranks_matches_jax(pool, case):
    cfg_kw, p_u, p_scs = STEP_CASES[case]
    cfg = dict(TRAIN_BASE, **cfg_kw)
    K = cfg.get("t_multi", 1)
    jcfg = jt.TrainConfig(**cfg)
    jmodel, jsched, jopt, jlr, jstate, _ = jt.build_model_and_state(
        jcfg, C_META, TL, 10, jax.random.PRNGKey(0))
    jstep = jt.make_train_step(jmodel, jsched, jcfg, jopt, jlr)
    rng = np.random.default_rng(1)
    nan_at = 1 if case.endswith("nan") else None
    batches = [_train_batch(rng, K, nan=s == nan_at) for s in range(len(p_scs))]
    weights = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(jstate.params)).items()}
    jm = []
    for s, (b, p_sc) in enumerate(zip(batches, p_scs)):
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.PRNGKey(s), jnp.asarray(0),
                          jnp.asarray(p_u), jnp.asarray(p_sc))
        jm.append(m)
    keys = [100 + s for s in range(len(batches))]
    ranks = pool.run(_steps_on_rank, cfg, weights, batches, p_u, p_scs, keys)
    (m0, buf0), (m1, buf1) = ranks
    np.testing.assert_equal(m0, m1)
    for k in ("flat", "ema", "mu", "step"):
        np.testing.assert_array_equal(buf0[k], buf1[k])
    for s, (tm, w) in enumerate(zip(m0, jm)):
        assert bool(tm["ok"]) == bool(w["ok"]) == (s != nan_at)
        if s == nan_at:
            continue
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k], float(w[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {s} {k}")
        assert tm["bsz_eff"] == int(w["bsz_eff"]) == GB * K
        assert tm["t_min"] == int(w["t_min"]) and tm["t_max"] == int(w["t_max"])
    assert buf0["step"] == int(jstate.step) == len(batches) - (nan_at is not None)
    layout = tt.FlatParams(UNet1D(in_ch=7, base_ch=8, time_dim=16, depth=1,
                                  cond_in_ch=5, use_selfcond=True,
                                  device="cpu"), "cpu")
    for got, want, tol in ((buf0["flat"], jstate.params, PARAM_ATOL),
                           (buf0["ema"], jstate.ema_params, EMA_ATOL)):
        want = params_from_flax(jax.device_get(want))
        for name, v in layout.views(torch.from_numpy(got)).items():
            assert float((v - want[name]).abs().max()) <= tol, name


def test_train_step_draws_for_the_global_batch(pool):
    """Stratified t, eps and the CFG-dropout mask drawn (not injected) on
    two ranks: the loss, gradient norm and parameters of the single-process
    step on the same key."""
    cfg = dict(TRAIN_BASE, t_cover="strat", t_multi=2, p_uncond=0.5)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        b = _train_batch(rng, 2)
        del b["t_inject"], b["eps_inject"]
        batches.append(b)
    args = (cfg, None, batches, 0.5, (1.0, 0.0, 1.0), (5, 6, 7))
    want, wbuf = _steps_on_rank(tmesh.Mesh(1), *args)
    for got, buf in pool.run(_steps_on_rank, *args):
        for g, w in zip(got, want):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL)
            for k in ("t_min", "t_mean", "t_max", "ok", "bsz_eff"):
                assert g[k] == w[k], k
        np.testing.assert_allclose(buf["flat"], wbuf["flat"], atol=PARAM_ATOL)


def _tiny_dataset(n=16, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(TL) / TL
    clean = np.stack([np.sin(2 * np.pi * (3 + i % 4) * t) for i in range(n)])
    noisy = clean + 0.5 * rng.standard_normal((n, TL))
    meta = rng.uniform(0.2, 0.8, (n, C_META))
    return tpipe.dataset_from_arrays(clean, noisy, 1024.0, meta=meta)


def _train_on_rank(mesh, cfg_kw, model_dirs):
    cfg = tt.TrainConfig(**dict(cfg_kw, model_dir=model_dirs[mesh.rank]))
    out = tt.train(cfg, dataset=_tiny_dataset(), mesh=mesh, device="cpu")
    return out["history"], out["checkpoint"]


def test_train_with_mesh_matches_unsharded(pool, tmp_path):
    """``train(mesh=)`` on two ranks: per-epoch losses within 1e-4 of the
    unsharded run's; only rank 0 wrote (rank 1's model_dir stays absent),
    and its checkpoint reads back as the unsharded run's."""
    cfg_kw = dict(TRAIN_BASE, epochs=2, p_uncond=0.2, p_selfcond=0.5,
                  t_multi=2, data_parallel=True, save_every_epochs=1)
    alone = tt.train(tt.TrainConfig(**dict(cfg_kw,
                                           model_dir=str(tmp_path / "one"))),
                     dataset=_tiny_dataset(), device="cpu")
    dirs = [str(tmp_path / f"rank{r}") for r in range(N_RANKS)]
    (h0, ck0), (h1, _) = pool.run(_train_on_rank, cfg_kw, dirs)
    assert not os.path.exists(dirs[1])
    assert h0 == h1 and len(h0) == 2
    for g, w in zip(h0, alone["history"]):
        np.testing.assert_allclose(g["avg_per_sample"], w["avg_per_sample"],
                                   rtol=1e-4)
    assert sorted(os.listdir(os.path.dirname(ck0))) == sorted(
        os.listdir(alone["out_dir"]))
    got, want = tck.load_checkpoint(ck0), tck.load_checkpoint(
        alone["checkpoint"])
    for k in ("epoch", "global_step"):
        assert got[k] == want[k]
    np.testing.assert_array_equal(got["rng_key"], want["rng_key"])
    assert json.dumps({k: v for k, v in got["args"].items()
                       if k != "model_dir"}, sort_keys=True, default=str) == \
        json.dumps({k: v for k, v in want["args"].items()
                    if k != "model_dir"}, sort_keys=True, default=str)
    for tree in ("model_state", "model_ema_state"):
        g, w = params_from_flax(got[tree]), params_from_flax(want[tree])
        for name in w:
            assert float((g[name] - w[name]).abs().max()) <= PARAM_ATOL, name


def _stream_train_on_rank(mesh, cfg_kw, model_dirs):
    cfg = tt.TrainConfig(**dict(cfg_kw, model_dir=model_dirs[mesh.rank]))
    out = tt.train(cfg, mesh=mesh, device="cpu")
    return out["history"], out["checkpoint"]


def test_streaming_train_with_mesh_matches_unsharded(pool, tmp_path):
    """``train(mesh=, streaming=True)`` on two ranks, each streaming the
    ragged ``.npz`` twin a chunk at a time: per-epoch losses within 1e-4 of
    one process's, the same global step, and the final weights within the
    step test's bar (``PARAM_ATOL``)."""
    from test_torch_port_streaming import _corpus

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import (
        hdf5io as tio,
    )

    args, kw = _corpus([300, 700, 512, 1000, 260, 900, 640, 333, 1024], 0)
    path = str(tmp_path / "ragged.npz")
    tio.write_dataset(path, *args, **kw)
    cfg_kw = dict(TRAIN_BASE, data=path, batch_size=4, epochs=2,
                  streaming=True, stream_chunk=3, whiten=True,
                  p_selfcond=0.5, data_parallel=True, save_every_epochs=1)
    alone = tt.train(tt.TrainConfig(**dict(cfg_kw,
                                           model_dir=str(tmp_path / "one"))),
                     device="cpu")
    dirs = [str(tmp_path / f"rank{r}") for r in range(N_RANKS)]
    (h0, ck0), (h1, _) = pool.run(_stream_train_on_rank, cfg_kw, dirs)
    assert h0 == h1 and len(h0) == 2
    for g, w in zip(h0, alone["history"]):
        np.testing.assert_allclose(g["avg_per_sample"], w["avg_per_sample"],
                                   rtol=1e-4)
    got, want = tck.load_checkpoint(ck0), tck.load_checkpoint(
        alone["checkpoint"])
    assert got["global_step"] == want["global_step"] > 0
    g, w = (params_from_flax(c["model_state"]) for c in (got, want))
    for name in w:
        assert float((g[name] - w[name]).abs().max()) <= PARAM_ATOL, name


def test_dryrun_multichip():
    graft_entry.dryrun_multichip(2, "cpu")
