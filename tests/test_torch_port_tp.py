"""The port's tensor parallelism and its pod-serving artifact against the
JAX package, on the CPU: the train step on a 1x2 (data, model) mesh of two
gloo ranks against JAX's step on ``make_mesh(n_data=1, n_model=2)`` over
the conftest's virtual devices and against the port's step in one
process; the blocks that JAX's rule leaves whole; JAX's three mesh
messages; ``train(tp=2)`` end to end and its checkpoint resumed in JAX;
``reconstruct_batch`` and ``tiled_apply`` on a model axis; a 2x2 mesh
(``dryrun_multichip(4)``); and ``export_sampler(dp=2)`` (through
``gw-export --dp 2``) served on two ranks and by ``gw-serve``, against the
dp = 1 artifact.

The ranks are two spawned processes in one gloo group for the module, as
in ``test_torch_port_parallel.py``.  Tolerances: 1e-4 relative in f32
(``REL_TOL``) against JAX, against one process and between the two
artifacts; the ranks' parameters bit-equal.
"""
import contextlib
import http.client
import io
import json
import multiprocessing
import os
import socket
import threading
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from diffusion_models_for_gravitational_waveform_reconstruction_tpu import serving as jsrv
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import pipeline as jpipe
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.parallel import mesh as jmesh
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.utils import checkpoint as jck
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import graft_entry
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference as tinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import serving as tsrv
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import export as texport
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import serve as tserve
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline as tpipe
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import sampling as tsp
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import schedules as tsch
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel import mesh as tmesh
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel import seqtile as tseq
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils import checkpoint as tck
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import params_from_flax
from test_torch_port_export import ARGS, PORT_ONLY_KEYS
from test_torch_port_train import jt, tt
from test_torch_port_unet import REL_TOL

N_RANKS = 2
GB, TL, C_META = 4, 64, 4
# attention width: mid 64 channels, 2 heads, so every block and the
# attention split over two model ranks
CFG = dict(epochs=2, batch_size=GB, lr=1e-3, T=100, base_ch=32, time_dim=16,
           depth=2, seed=0, t_min_frac=0.0, warmup_steps=2, bf16=False,
           data_parallel=False, use_attention=True, pred_type="v",
           loss="mse")
# enc0 and dec1 (12 channels) and the attention (24 channels, one head)
# stay whole under JAX's rule.  12 channels keep three in each GroupNorm
# group: with one (base_ch 8) a conv's bias has no gradient in exact
# arithmetic, and AdamW's first step turns its rounding into +-lr
WHOLE_CFG = dict(CFG, base_ch=12)
PARAM_ATOL = 1e-4


# ---------------------------------------------------------------------------
# two ranks in one gloo group, kept for the module
# ---------------------------------------------------------------------------

def _rank_loop(rank, n, port, inbox, outbox):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    for fn, args in iter(inbox.get, None):
        try:
            outbox.put((rank, True, fn(rank, *args)))
        except Exception:                   # reported to the test
            outbox.put((rank, False, traceback.format_exc()))
    dist.barrier()
    outbox.close()
    outbox.join_thread()
    os._exit(0)


class RankPool:
    """``n`` spawned processes in one gloo group on the CPU; ``run(fn,
    *args)`` calls ``fn(rank, *args)`` on each and returns their results in
    rank order."""

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
        self.start(fn, *args)
        return self.collect()

    def start(self, fn, *args):
        """``run`` without waiting: ``collect()`` returns the results."""
        for q in self.inboxes:
            q.put((fn, args))

    def collect(self):
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


def _tp_mesh():
    return tmesh.make_mesh(n_data=1, n_model=2)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# the mesh and the rule
# ---------------------------------------------------------------------------

def _mesh_on_rank(rank):
    m = _tp_mesh()
    return (m.shape, m.rank, m.data_rank, m.model_rank, m.group is None,
            m.model_group is not None)


def test_model_axis_layout(pool):
    """Process d * n_model + m sits at data index d, model index m; a 1x2
    mesh has no data group and one model group."""
    got = pool.run(_mesh_on_rank)
    for r, g in enumerate(got):
        assert g == ({"data": 1, "model": 2}, 0, 0, r, True, True)


def _model(cfg):
    return UNet1D(in_ch=2 + 1 + C_META, base_ch=cfg["base_ch"],
                  time_dim=cfg["time_dim"], depth=cfg["depth"],
                  cond_in_ch=1 + C_META, use_selfcond=True,
                  use_attention=cfg["use_attention"], device="cpu")


@pytest.mark.parametrize("cfg", [CFG, WHOLE_CFG], ids=["split", "whole"])
def test_tp_rule_is_jax_spec(cfg):
    """``tp_sharded`` marks exactly the leaves that JAX's ``_tp_spec``
    shards over a 1x2 mesh (the port's names are the flax paths); the plan splits a block where its conv (or
    qkv) is sharded and its groups (or heads) divide evenly, and the
    partial gradients are those blocks' leaves but norms of the
    attention and its proj bias."""
    model = _model(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    mesh = jmesh.make_mesh(n_data=1, n_model=2)
    specs = {}
    jax.tree_util.tree_map_with_path(
        lambda path, x: specs.__setitem__(
            ".".join(str(p.key) for p in path[1:]),
            jmesh._tp_spec(mesh, path, x).spec != jax.sharding.PartitionSpec()),
        tck.state_dict_to_flax(model.state_dict()))
    assert set(specs) == set(shapes)
    for name, sharded in specs.items():
        assert tmesh.tp_sharded(name, shapes[name], 2) == sharded, name
    assert not any(tmesh.tp_sharded(n, s, 1) for n, s in shapes.items())
    split, whole = model.tensor_parallel_plan(2)
    if cfg is CFG:
        assert whole == [] and "mid_attn" in split
    else:
        assert whole == ["enc0", "mid_attn", "dec1"]
    for name in split:
        assert specs[f"{name}.{'qkv' if name == 'mid_attn' else 'conv'}.kernel"]
    for name in whole:
        assert name == "mid_attn" or not specs[f"{name}.conv.kernel"]
    partial = model.tensor_parallel_partial(2)
    assert all(n.split(".")[0] in split for n in partial)
    assert ("mid_attn.proj.bias" not in partial
            and "mid_attn.norm.scale" not in partial)


def test_mesh_needs_its_groups():
    """A model axis above 1 needs a process group, as a data axis does."""
    with pytest.raises(ValueError, match="needs a process group"):
        tmesh.Mesh(1, 2)
    with pytest.raises(ValueError, match="outside"):
        tmesh.Mesh(1, 1, model_rank=1)
    assert tmesh.Mesh(1, 2, model_group=object(), model_rank=1).shape == {
        "data": 1, "model": 2}


# ---------------------------------------------------------------------------
# the train step on a 1x2 mesh
# ---------------------------------------------------------------------------

def _batch(rng):
    return {"clean": 0.5 * rng.standard_normal((GB, 1, TL)).astype(np.float32),
            "noisy": rng.standard_normal((GB, 1, TL)).astype(np.float32),
            "sigma": rng.uniform(0.5, 2.0, GB).astype(np.float32),
            "mask": np.ones((GB, 1, TL), np.float32),
            "meta": rng.uniform(0.0, 1.0, (GB, C_META)).astype(np.float32),
            "t_inject": rng.integers(0, 100, GB).astype(np.int32),
            "eps_inject": rng.standard_normal((GB, 1, TL)).astype(np.float32)}


def _steps(mesh, cfg, weights, batches, p_u, p_scs, keys):
    """The port's state loaded with ``weights`` (EMA too), stepped on
    ``batches``; each step's metrics and gradient, and the final buffers."""
    tcfg = tt.TrainConfig(**cfg)
    model, sched, opt, lr, state, _ = tt.build_model_and_state(
        tcfg, C_META, 10, 0, device="cpu")
    for buf in (state.params.flat, state.ema_params):
        state.params.load_(buf, {k: torch.from_numpy(v)
                                 for k, v in weights.items()})
    step = tt.make_train_step(model, sched, tcfg, opt, lr, mesh)
    metrics, grads = [], []
    for b, p_sc, key in zip(batches, p_scs, keys):
        m = step(state, {k: torch.from_numpy(v) for k, v in b.items()}, key,
                 0, p_u, p_sc)
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(state.params.grad.numpy().copy())
    return metrics, grads, {"flat": state.params.flat.numpy().copy(),
                            "ema": state.ema_params.numpy().copy(),
                            "mu": state.opt_state.mu.numpy().copy()}


def _tp_steps_on_rank(rank, *args):
    return _steps(_tp_mesh(), *args)


@pytest.fixture(scope="module")
def jax_tp():
    """JAX's model at ``CFG`` with every weight moved off its init
    (``proj`` is zero-initialised) and its jitted step; ``state(...)``
    lays a fresh state (host trees, by default these weights and the
    initial optimizer state) over a 1x2 mesh as JAX's trainer does
    (``shard_params_tp``; the step donates its state)."""
    jcfg = jt.TrainConfig(**CFG)
    built = jt.build_model_and_state(jcfg, C_META, TL, 10,
                                     jax.random.PRNGKey(0))
    model, sched, opt, lr, state0, _ = built
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), state0.params)
    opt0 = jax.device_get(state0.opt_state)
    mesh = jmesh.make_mesh(n_data=1, n_model=2)

    def fresh(p=params, ema=params, opt_state=opt0, step=0):
        copy = lambda t: jax.tree_util.tree_map(np.array, t)   # noqa: E731
        return jt.TrainState(
            params=jmesh.shard_params_tp(copy(p), mesh),
            ema_params=jmesh.shard_params_tp(copy(ema), mesh),
            opt_state=jmesh.replicate_tree(copy(opt_state), mesh),
            step=jnp.asarray(step, jnp.int32))

    jstep = jt.make_train_step(model, sched, jcfg, opt, lr)
    weights = {k: v.numpy() for k, v in params_from_flax(params).items()}

    def run(st, b, seed, p_u, p_sc):
        return jstep(st, jmesh.shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}, mesh),
            jax.random.PRNGKey(seed), jnp.asarray(0), jnp.asarray(p_u),
            jnp.asarray(p_sc))

    return {"state": fresh, "template": state0, "run": run,
            "weights": weights, "built": built}


def test_tp_step_matches_jax_and_one_process(pool, jax_tp):
    """Two f32 steps (self-conditioning on, then off) on the 1x2 mesh:
    loss, gradient norm and parameters against JAX's step on its 1x2 mesh,
    and loss, gradient and parameters against the port's step in one
    process, all within 1e-4 relative; the two ranks bit-equal."""
    rng = np.random.default_rng(1)
    batches = [_batch(rng) for _ in range(2)]
    p_scs, keys = (1.0, 0.0), (100, 101)
    args = (CFG, jax_tp["weights"], batches, 0.0, p_scs, keys)
    (m0, g0, buf0), (m1, g1, buf1) = pool.run(_tp_steps_on_rank, *args)
    assert m0 == m1
    for k in buf0:
        np.testing.assert_array_equal(buf0[k], buf1[k])
    for a, b in zip(g0, g1):
        np.testing.assert_array_equal(a, b)
    want_m, want_g, want_buf = _steps(None, *args)
    for s in range(2):
        assert abs(m0[s]["loss"] - want_m[s]["loss"]) <= REL_TOL * abs(
            want_m[s]["loss"])
        assert rel(g0[s], want_g[s]) <= REL_TOL, s
    assert rel(buf0["flat"], want_buf["flat"]) <= REL_TOL
    jstate = jax_tp["state"]()
    for s, b in enumerate(batches):
        jstate, jm = jax_tp["run"](jstate, b, s, 0.0, p_scs[s])
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m0[s][k], float(jm[k]), rtol=REL_TOL,
                                       err_msg=f"step {s} {k}")
    layout = tt.FlatParams(_model(CFG), "cpu")
    want = params_from_flax(jax.device_get(jstate.params))
    for name, v in layout.views(torch.from_numpy(buf0["flat"])).items():
        assert float((v - want[name]).abs().max()) <= PARAM_ATOL, name


def test_blocks_left_whole_run_whole(pool):
    """At base_ch 12 JAX's rule leaves enc0, dec1 and the one-head
    attention whole: on the 1x2 mesh they run whole on each rank, the rest
    split, and the step equals one process's within 1e-4."""
    model = _model(WHOLE_CFG)
    rng = np.random.default_rng(4)
    weights = {k: (v.detach().numpy() + 0.05 * rng.standard_normal(
        v.shape)).astype(np.float32) for k, v in model.state_dict().items()}
    args = (WHOLE_CFG, weights, [_batch(rng)], 0.0, (1.0,), (7,))
    (m0, g0, buf0), (m1, _, buf1) = pool.run(_tp_steps_on_rank, *args)
    np.testing.assert_array_equal(buf0["flat"], buf1["flat"])
    want_m, want_g, want_buf = _steps(None, *args)
    assert abs(m0[0]["loss"] - want_m[0]["loss"]) <= REL_TOL * abs(
        want_m[0]["loss"])
    assert rel(g0[0], want_g[0]) <= REL_TOL
    assert rel(buf0["flat"], want_buf["flat"]) <= REL_TOL


# ---------------------------------------------------------------------------
# train(): JAX's mesh messages, tp = 2 end to end
# ---------------------------------------------------------------------------

def _tiny_dataset(pkg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(TL) / TL
    clean = np.stack([np.sin(2 * np.pi * (3 + i % 4) * t) for i in range(n)])
    noisy = clean + 0.5 * rng.standard_normal((n, TL))
    meta = rng.uniform(0.2, 0.8, (n, C_META))
    return pkg.dataset_from_arrays(clean.astype(np.float32),
                                   noisy.astype(np.float32), 1024.0,
                                   meta=meta.astype(np.float32))


MESSAGE_CASES = {
    # tp above the world size: raises
    "tp-above-world": dict(tp=3),
    # the batch does not split over the data axis: sharding dropped
    "batch-uneven": dict(tp=1, data_parallel=True, batch_size=3),
}


def _train_said(cfg_kw, model_dir, train):
    """What ``train`` says about the mesh: the ValueError it raises, or
    its line about dropping the sharding."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            train(dict(cfg_kw, model_dir=model_dir, epochs=1))
        except ValueError as e:
            return f"raised: {e}"
        except _Stop:
            pass
    return next((ln for ln in buf.getvalue().splitlines()
                 if "not divisible" in ln or "dropped" in ln), None)


class _Stop(Exception):
    """Ends JAX's train() once its mesh is decided (before a compile)."""


def _port_train(cfg_kw):
    tt.train(tt.TrainConfig(**cfg_kw), dataset=_tiny_dataset(tpipe),
             device="cpu")


def _jax_train(cfg_kw):
    jt.train(jt.TrainConfig(**cfg_kw), dataset=_tiny_dataset(jpipe))


def _message_on_rank(rank, cfg_kw, dirs):
    return _train_said(cfg_kw, dirs[rank], _port_train)


@pytest.mark.parametrize("case", list(MESSAGE_CASES) + ["one-process"])
def test_mesh_messages_match_jax(pool, jax_tp, case, tmp_path,
                                 monkeypatch):
    """JAX's three messages word for word: on two ranks the port's against
    JAX's train() with two devices; in one process against JAX's with one
    (tp 2: tensor parallelism dropped, and the port trains).  JAX's train()
    is given the model it has built already and stopped once its mesh is
    decided."""
    cfg_kw = dict(CFG, **MESSAGE_CASES.get(case, dict(tp=2)))
    n_dev = 1 if case == "one-process" else 2
    devices = jax.devices()[:n_dev]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    monkeypatch.setattr(jt, "build_model_and_state",
                        lambda *a, **k: jax_tp["built"])

    def stop(*a, **k):
        raise _Stop
    monkeypatch.setattr(jpipe, "upload_buckets", stop)
    want = _train_said(cfg_kw, str(tmp_path / "jax"), _jax_train)
    assert want is not None
    if case == "one-process":
        got = [_train_said(cfg_kw, str(tmp_path / "port"), _port_train)]
    else:
        got = pool.run(_message_on_rank, cfg_kw,
                       [str(tmp_path / f"r{r}") for r in range(N_RANKS)])
    assert got == [want] * len(got)


def _train_tp_on_rank(rank, cfg_kw, model_dirs):
    cfg = tt.TrainConfig(**dict(cfg_kw, model_dir=model_dirs[rank]))
    out = tt.train(cfg, dataset=_tiny_dataset(tpipe), device="cpu")
    return out["history"], out["checkpoint"]


def test_train_tp2_matches_tp1_and_resumes_in_jax(pool, jax_tp, tmp_path):
    """``train(tp=2)`` on two ranks (the trainer makes the 1x2 mesh): the
    losses and the checkpoint of ``tp=1`` in one process within 1e-4
    (``PARAM_ATOL``), only rank 0 writing; the checkpoint restores into
    JAX's tensor-parallel state and JAX's next step agrees with the
    port's from the same checkpoint."""
    alone = tt.train(tt.TrainConfig(**dict(CFG, model_dir=str(
        tmp_path / "one"))), dataset=_tiny_dataset(tpipe), device="cpu")
    dirs = [str(tmp_path / f"rank{r}") for r in range(N_RANKS)]
    (h0, ck0), (h1, _) = pool.run(_train_tp_on_rank, dict(CFG, tp=2), dirs)
    assert not os.path.exists(dirs[1]) and h0 == h1 and len(h0) == 2
    for g, w in zip(h0, alone["history"]):
        np.testing.assert_allclose(g["avg_per_sample"], w["avg_per_sample"],
                                   rtol=REL_TOL)
    got, want = tck.load_checkpoint(ck0), tck.load_checkpoint(
        alone["checkpoint"])
    assert got["global_step"] == want["global_step"] == 4
    assert got["args"]["tp"] == 2
    for tree in ("model_state", "model_ema_state"):
        g, w = params_from_flax(got[tree]), params_from_flax(want[tree])
        for name in w:
            assert float((g[name] - w[name]).abs().max()) <= PARAM_ATOL, name

    ck = jck.load_checkpoint(ck0)
    js = jax_tp["template"]
    jstate = jax_tp["state"](
        jck.restore_params(js.params, ck["model_state"]),
        jck.restore_params(js.ema_params, ck["model_ema_state"]),
        jck.restore_params(js.opt_state, ck["optimizer_state"]),
        ck["global_step"])
    b = _batch(np.random.default_rng(9))
    _, jm = jax_tp["run"](jstate, b, 0, 0.0, 1.0)
    tcfg = tt.TrainConfig(**CFG)
    model, sched, opt, lr, state, _ = tt.build_model_and_state(
        tcfg, C_META, 10, 0, device="cpu")
    tt.restore_state(state, opt, tck.load_checkpoint(ck0), 2)
    tm = tt.make_train_step(model, sched, tcfg, opt, lr)(
        state, {k: torch.from_numpy(v) for k, v in b.items()}, 3, 0, 0.0,
        1.0)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=REL_TOL)


# ---------------------------------------------------------------------------
# sampling on a model axis
# ---------------------------------------------------------------------------

SAMPLE_KW = dict(in_ch=7, base_ch=16, time_dim=16, depth=2, cond_in_ch=5,
                 use_selfcond=True, use_attention=True)


def _sampling(mesh, state, cond, sigmas, x):
    model = UNet1D(**SAMPLE_KW, device="cpu").eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    cfg = tsp.SamplerConfig(steps=3, cfg_scale=1.5, use_selfcond=True,
                            pred_type="eps")
    with torch.no_grad():
        x0 = tinf.reconstruct_batch(
            model, tsch.make_schedule(100), cond, sigmas, cfg,
            torch.Generator().manual_seed(3), mesh=mesh, avg_seeds=2,
            device="cpu")
        y = tseq.tiled_apply(model, torch.from_numpy(x),
                             torch.tensor([10, 60]), chunk=128, mesh=mesh)
    return x0, y.numpy()


def _sampling_on_rank(rank, *args):
    return _sampling(_tp_mesh(), *args)


def test_sampling_on_a_model_axis(pool):
    """``reconstruct_batch`` and ``tiled_apply`` with a 1x2 mesh: each
    model rank runs its data index's rows whole; both ranks return the
    call without a mesh."""
    model = UNet1D(**SAMPLE_KW, device="cpu")
    rng = np.random.default_rng(5)
    state = {k: (v.detach().numpy() + 0.05 * rng.standard_normal(
        v.shape)).astype(np.float32) for k, v in model.state_dict().items()}
    args = (state, rng.standard_normal((2, 5, 128)).astype(np.float32),
            rng.uniform(0.5, 2.0, 2).astype(np.float32),
            rng.standard_normal((2, 7, 400)).astype(np.float32))
    want = _sampling(None, *args)
    for got in pool.run(_sampling_on_rank, *args):
        for g, w in zip(got, want):
            assert g.shape == w.shape and rel(g, w) <= 1e-6


def test_dryrun_multichip_2x2():
    """Four gloo ranks on a 2x2 mesh: the tensor-parallel step, the
    sharded sampler, the tiled forward and the dp = 4 artifact."""
    graft_entry.dryrun_multichip(4, "cpu")


# ---------------------------------------------------------------------------
# the pod-serving artifact
# ---------------------------------------------------------------------------

B, C, L = 4, 5, 256
KNOBS = dict(steps=2, avg_seeds=2, amp_calib="mf")


def _export_on_rank(rank, ckpt, one, two):
    """Rank 0 exports the dp = 1 artifact, rank 1 the dp = 2 one through
    ``gw-export --dp 2 --validate`` (returning what it said)."""
    if rank == 0:
        tsrv.export_sampler(ckpt, one, batch=B, length=L, device="cpu",
                            **KNOBS)
        return None
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = texport.main(["--model", ckpt, "--output", two, "--batch-size",
                           str(B), "--length", str(L), "--device", "cpu",
                           "--steps", "2", "--avg-seeds", "2", "--dp", "2",
                           "--validate"])
    return rc, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def artifacts(pool, tmp_path_factory):
    """A JAX-written checkpoint (weights off their init); the port's dp = 1
    artifact, its dp = 2 artifact through ``gw-export --dp 2 --validate``
    (the two exported on the pool's ranks, at once), and JAX's dp = 2
    sidecar (exported here meanwhile)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu.models import UNet1D as JUNet1D

    d = tmp_path_factory.mktemp("pod")
    model = JUNet1D(in_ch=7, base_ch=8, time_dim=16, depth=2,
                    t_embed_max_time=float(ARGS["T"] - 1), cond_in_ch=C,
                    use_selfcond=True)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 7, 64)),
                                 jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    ckpt = str(d / "model.msgpack")
    jck.save_checkpoint(ckpt, params, dict(ARGS), epoch=1)
    one, two = str(d / "one.pt2"), str(d / "two.pt2")
    pool.start(_export_on_rank, ckpt, one, two)
    jax_c = jsrv.export_sampler(ckpt, str(d / "two.shlo"), batch=B, length=L,
                                platforms=["cpu"], dp=2, **KNOBS)
    _, (rc, said) = pool.collect()
    return {"ckpt": ckpt, "one": one, "two": two, "rc": rc, "said": said,
            "jax": jax_c, "dir": d}


def test_dp_sidecar_keeps_the_jax_contract(artifacts):
    """``gw-export --dp 2`` ran and validated; its sidecar has JAX's dp = 2
    sidecar's keys and values (the global calling convention, ``dp`` 2),
    plus the port's keys and ``rows_per_rank``, under the pod contract
    version."""
    assert artifacts["rc"] == 0
    assert "dp=2" in artifacts["said"][-2]
    assert artifacts["said"][-1].startswith("[export] validate OK")
    with open(artifacts["two"] + ".json") as fh:
        port = json.load(fh)
    jax_c = artifacts["jax"]
    assert set(port) == set(jax_c) | PORT_ONLY_KEYS | {"rows_per_rank"}
    for key in set(jax_c) - {"artifact_bytes", "contract_version"}:
        assert port[key] == jax_c[key], key
    assert port["dp"] == jax_c["dp"] == 2 and port["rows_per_rank"] == B // 2
    assert port["contract_version"] == tsrv.CONTRACT_VERSION_DP
    assert port["ops"]["seeded_normal"] == 1
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        tsrv.load_exported(artifacts["two"], device="cpu")


def _serve_on_rank(rank, art, cond, sig, req, out):
    call, contract = tsrv.load_exported(art, device="cpu")
    x0 = tsrv.run_batched(call, contract, cond, sig, seed=5)
    rc = tserve.main(["--artifact", art, "--input", req, "--output", out,
                      "--device", "cpu", "--seed", "5"])
    return x0, rc


def test_dp_artifact_on_two_ranks_matches_dp1(pool, artifacts):
    """The dp = 2 artifact served on two ranks (9 measurements: three
    calls, the last padded) gives the dp = 1 artifact's output on the same
    batch and seed within 1e-4; so does ``gw-serve`` in batch mode, where
    only rank 0 writes."""
    rng = np.random.default_rng(6)
    cond = rng.normal(size=(2 * B + 1, C, L)).astype(np.float32)
    sig = rng.uniform(0.5, 2.0, 2 * B + 1).astype(np.float32)
    req = str(artifacts["dir"] / "req.npz")
    np.savez(req, cond_stack=cond, sigmas=sig)
    out = str(artifacts["dir"] / "resp.npz")
    call, contract = tsrv.load_exported(artifacts["one"], device="cpu")
    want = tsrv.run_batched(call, contract, cond, sig, seed=5)
    (x0, rc0), (x1, rc1) = pool.run(_serve_on_rank, artifacts["two"], cond,
                                    sig, req, out)
    assert rc0 == rc1 == 0
    np.testing.assert_array_equal(x0, x1)
    assert x0.shape == want.shape == (2 * B + 1, L)
    assert rel(x0, want) <= REL_TOL
    got = np.load(out)
    np.testing.assert_array_equal(got["x0_white"], x0)
    assert int(got["seed"]) == 5


def _http_on_rank(rank, art, cond, sig, fault=None):
    """Rank 0 serves the pod artifact over HTTP and posts a request and
    one of a wrong shape; rank 1 follows the requests rank 0 relays, until
    it stops.  ``fault="replay"`` first posts a request whose replay
    raises on rank 0 only; ``fault="host"`` posts one request, which
    raises on rank 0 only after the call.  Rank 0 returns each response's
    status, the good request's output and the server's fault."""
    if rank > 0:
        tserve.follow(art, device="cpu")
        return None
    program, run_batched = tsrv._program, tsrv.run_batched

    def faulty(path, device=None):
        replay, contract = program(path, device)
        hits = []

        def once(*a):
            if not hits:
                hits.append(1)
                raise RuntimeError("injected fault")
            return replay(*a)
        return once, contract

    def host_fault(*a, **kw):
        run_batched(*a, **kw)
        raise RuntimeError("injected fault")

    tsrv._program = faulty if fault == "replay" else program
    tsrv.run_batched = host_fault if fault == "host" else run_batched
    try:
        srv = tserve.make_server(art, port=0, device="cpu")
    finally:
        tsrv._program = program
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    statuses = []

    def post(c):
        body = io.BytesIO()
        np.savez(body, cond_stack=c, sigmas=sig, seed=np.int32(5))
        conn.request("POST", "/reconstruct", body=body.getvalue())
        r = conn.getresponse()
        statuses.append(r.status)
        return r.read()

    try:
        conn = http.client.HTTPConnection(*srv.server_address[:2],
                                          timeout=120)
        if fault == "host":
            post(cond)
            th.join(timeout=30)
            return statuses, th.is_alive(), repr(srv.fault)
        if fault == "replay":
            post(cond)
        x0 = np.load(io.BytesIO(post(cond)))["x0_white"]
        post(cond[:, :, :L // 2])
        return statuses, x0, srv.fault
    finally:
        tsrv.run_batched = run_batched
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        tserve._relay(None)


def test_dp_artifact_over_http_on_two_ranks(pool, artifacts):
    """``gw-serve --http`` on two ranks: rank 0's POST returns the dp = 1
    artifact's output within 1e-4; a wrong shape is the client's 400 on
    rank 0 and is refused on rank 1 too, which goes on following."""
    rng = np.random.default_rng(7)
    cond = rng.normal(size=(B, C, L)).astype(np.float32)
    sig = rng.uniform(0.5, 2.0, B).astype(np.float32)
    call, contract = tsrv.load_exported(artifacts["one"], device="cpu")
    want = tsrv.run_batched(call, contract, cond, sig, seed=5)
    (statuses, x0, fault), follower = pool.run(
        _http_on_rank, artifacts["two"], cond, sig)
    assert follower is None and statuses == [200, 400] and fault is None
    assert rel(x0, want) <= REL_TOL


def test_dp_artifact_over_http_survives_a_fault_on_rank_0(pool, artifacts):
    """A replay that raises on rank 0 only is a 500 there, and rank 1's
    call raises with it instead of waiting in the gather: the ranks stay
    in step, the next request returns the dp = 1 artifact's output within
    1e-4 and the server keeps running."""
    rng = np.random.default_rng(7)
    cond = rng.normal(size=(B, C, L)).astype(np.float32)
    sig = rng.uniform(0.5, 2.0, B).astype(np.float32)
    call, contract = tsrv.load_exported(artifacts["one"], device="cpu")
    want = tsrv.run_batched(call, contract, cond, sig, seed=5)
    (statuses, x0, fault), follower = pool.run(
        _http_on_rank, artifacts["two"], cond, sig, "replay")
    assert follower is None and statuses == [500, 200, 400] and fault is None
    assert rel(x0, want) <= REL_TOL


def test_dp_artifact_over_http_stops_on_a_host_fault_on_rank_0(pool,
                                                                artifacts):
    """A fault on rank 0 outside the program, where the other ranks may
    still wait inside the call, is a 500 that stops the server."""
    rng = np.random.default_rng(7)
    cond = rng.normal(size=(B, C, L)).astype(np.float32)
    sig = rng.uniform(0.5, 2.0, B).astype(np.float32)
    (statuses, serving, fault), follower = pool.run(
        _http_on_rank, artifacts["two"], cond, sig, "host")
    assert follower is None and statuses == [500] and not serving
    assert "injected fault" in fault


def test_rank_noise_keeps_each_seeds_rows():
    """A rank's rows of a seed-major draw: block s of its S*b rows is rows
    [s*n*b + rank*b, s*n*b + (rank+1)*b) of the global draw, for an int
    rank and a tensor rank alike."""
    z = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(12, 2)
    src = tsp.FixedNoise(z)
    for rank in (1, torch.tensor(1)):
        got = tsp.RankNoise(src, rank, 3, blocks=2).init((4, 2), z.dtype,
                                                         "cpu")
        np.testing.assert_array_equal(got, z[[2, 3, 8, 9]])
