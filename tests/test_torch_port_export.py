"""The port's serving artifact (``export_sampler`` / ``load_exported`` /
``validate_export``), ``gw-export`` and ``gw-serve``, the seeded noise and
the bench's FLOP count against the JAX package, on the CPU.

The tiny configuration of ``tests/test_serving.py`` (B 2, C 5, L 256, T 50,
base_ch 8, depth 2, in_ch 7, v-prediction) from a checkpoint the JAX
package writes here.  A CPU artifact traces the kernels' plain versions, so
its replay is bit-equal to the port's live serving function; the JAX
artifact draws JAX's noise, so the port's function is fed those draws and
held within 1e-4 relative.
"""
import http.client
import io
import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from diffusion_models_for_gravitational_waveform_reconstruction_tpu import serving as jsrv
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.cli import serve as jserve
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.models import UNet1D as JUNet1D
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.utils import roofline as jroof
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import bench, graft_entry
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference as tinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import serving as tsrv
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import export as texport
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import serve as tserve
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import sampling as tsp
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels.conv_gn_silu import (
    conv_gn_silu_op,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_op,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools import bench_serving
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils import roofline as troof
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import randomize_
from test_torch_port_unet import REL_TOL, rel_err

B, C, L, T = 2, 5, 256, 50
ARGS = {"base_ch": 8, "in_ch": 7, "cond_in_ch": C, "T": T,
        "schedule": "cosine", "pred_type": "v", "time_dim": 16, "depth": 2,
        "whiten": 1, "whiten_mode": "model", "sigma_mode": "std",
        "meta_scale": {"M": 80.0, "q": 10.0}, "fs": 2048.0}
KNOBS = dict(steps=2, avg_seeds=2, amp_calib="mf")
# what the port's sidecar adds to the JAX contract
PORT_ONLY_KEYS = {"format", "torch", "loading", "ops"}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX-written checkpoint; the init's zero final conv and biases are
    moved off zero, so the network's output depends on its input."""
    d = tmp_path_factory.mktemp("export")
    model = JUNet1D(in_ch=7, base_ch=8, time_dim=16, depth=2,
                    t_embed_max_time=float(T - 1), cond_in_ch=C,
                    use_selfcond=True)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 7, 64)),
                                 jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    path = str(d / "model.msgpack")
    jax_save_checkpoint(path, params, dict(ARGS), epoch=1)
    return path


@pytest.fixture(scope="module")
def port_artifact(ckpt):
    path = os.path.join(os.path.dirname(ckpt), "sampler.pt2")
    contract = tsrv.export_sampler(ckpt, path, batch=B, length=L,
                                   device="cpu", **KNOBS)
    call, loaded = tsrv.load_exported(path, device="cpu")
    return path, contract, call, loaded


@pytest.fixture(scope="module")
def jax_artifact(ckpt):
    path = os.path.join(os.path.dirname(ckpt), "sampler.shlo")
    contract = jsrv.export_sampler(ckpt, path, batch=B, length=L,
                                   platforms=["cpu"], **KNOBS)
    return path, contract


@pytest.fixture(scope="module")
def live(ckpt):
    """The port's live serving function of the checkpoint, on the CPU."""
    model, schedule, ck = tinf.load_model(ckpt, device="cpu")
    cfg, sampler = tsrv.resolve_serving_config(ck, schedule,
                                               steps=KNOBS["steps"])
    fn = tsrv.build_serving_fn(schedule, cfg, sampler=sampler, device="cpu",
                               avg_seeds=KNOBS["avg_seeds"],
                               amp_calib=KNOBS["amp_calib"])
    return lambda cond, sig, seed, **kw: fn(model, cond, sig, seed, **kw)


def _inputs(n=B, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, C, L)).astype(np.float32),
            rng.uniform(0.5, 2.0, n).astype(np.float32))


def test_artifact_round_trip_equals_live_function(port_artifact, live):
    """Saved, loaded and replayed, the CPU artifact is the live function:
    the same plain ops and the same seeded draws, bit-equal."""
    _, contract, call, loaded = port_artifact
    assert loaded == contract
    assert contract["ops"] == {"conv_gn_silu": 0, "flash_attention": 0,
                               "seeded_normal": 1}
    cond, sig = _inputs()
    for seed in (0, 7):
        got = call(cond, sig, seed)
        assert got.shape == (B, L) and got.dtype == torch.float32
        assert torch.equal(got, live(cond, sig, seed))
    assert not torch.equal(call(cond, sig, 0), call(cond, sig, 1))


def test_jax_artifact_matches_port_with_jax_noise(jax_artifact, live):
    """The JAX artifact at seed 7 against the port's serving function fed
    JAX's own x_T draw of that seed."""
    jcall, _ = jsrv.load_exported(jax_artifact[0])
    cond, sig = _inputs(seed=4)
    want = np.asarray(jcall(cond, sig, np.int32(7)))
    k_init, _ = jax.random.split(jax.random.PRNGKey(7))
    z = np.array(jax.random.normal(k_init, (KNOBS["avg_seeds"] * B, 1, L),
                                   jnp.float32))
    got = live(cond, sig, 7, noise=tsp.FixedNoise(torch.from_numpy(z)))
    assert got.shape == want.shape == (B, L)
    assert rel_err(got, want) <= REL_TOL


def test_sidecar_keeps_the_jax_contract(port_artifact, jax_artifact):
    """Key for key the JAX sidecar's, less the artifact's size, plus the
    torch format, version, loading note and the ops the program calls."""
    port, jax_c = port_artifact[1], jax_artifact[1]
    assert set(port) == set(jax_c) | PORT_ONLY_KEYS
    for key in set(jax_c) - {"artifact_bytes"}:
        assert port[key] == jax_c[key], key
    assert port["platforms"] == ["cpu"] and port["dp"] == 1
    assert port["format"] == "torch.export"
    assert port["torch"] == torch.__version__
    assert port["artifact_bytes"] == os.path.getsize(port_artifact[0])
    assert port["prep"]["meta_scale"] == {"M": 80.0, "q": 10.0}


def test_load_exported_refuses_other_contracts(port_artifact, jax_artifact,
                                               tmp_path):
    path, contract = port_artifact[0], port_artifact[1]

    def copy(name, sidecar):
        dst = str(tmp_path / name)
        shutil.copy(path, dst)
        if sidecar is not None:
            with open(dst + ".json", "w") as fh:
                json.dump(sidecar, fh)
        return dst

    with pytest.raises(ValueError, match="contract_version 999"):
        tsrv.load_exported(copy("v2.pt2", dict(contract,
                                               contract_version=999)),
                           device="cpu")
    with pytest.raises(ValueError, match="torch.export"):
        tsrv.load_exported(jax_artifact[0], device="cpu")
    with pytest.raises(FileNotFoundError, match="sidecar"):
        tsrv.load_exported(copy("bare.pt2", None), device="cpu")


def test_cuda_artifact_is_not_served_elsewhere(port_artifact, tmp_path,
                                               monkeypatch):
    """An artifact traced for the GPU is refused on the CPU, and without a
    card it is refused outright: no fallback."""
    dst = str(tmp_path / "gpu.pt2")
    shutil.copy(port_artifact[0], dst)
    with open(dst + ".json", "w") as fh:
        json.dump(dict(port_artifact[1], platforms=["cuda"]), fh)
    with pytest.raises(RuntimeError, match=r"traced for \['cuda'\]"):
        tsrv.load_exported(dst, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsrv.load_exported(dst)


def test_export_dp_raises(ckpt, tmp_path):
    with pytest.raises(NotImplementedError, match="P10"):
        tsrv.export_sampler(ckpt, str(tmp_path / "dp.pt2"), batch=B,
                            length=L, device="cpu", dp=2, **KNOBS)
    assert not (tmp_path / "dp.pt2").exists()


def test_export_cli_validates(ckpt, tmp_path, capsys):
    out = str(tmp_path / "cli.pt2")
    rc = texport.main(["--model", ckpt, "--output", out, "--batch-size",
                       str(B), "--length", str(L), "--device", "cpu",
                       "--steps", "2", "--avg-seeds", "1", "--validate"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith(f"[export] {out}: ")
    assert "platforms=['cpu'], dp=1, sampler=ddim@2" in lines[-2]
    assert lines[-1].startswith("[export] validate OK")
    with open(out + ".json") as fh:
        assert json.load(fh)["calling_convention"]["inputs"]["cond_stack"] \
            == [B, C, L, "float32"]
    with pytest.raises(NotImplementedError, match="P10"):
        texport.main(["--model", ckpt, "--output", out, "--device", "cpu",
                      "--dp", "2"])


def test_serve_batch_mode_against_jax(port_artifact, jax_artifact, tmp_path):
    """Three requests at batch 2 (the tail chunk padded) through both
    ``gw-serve``s: the same response layout; the port's response is its
    ``run_batched``; a wrong shape fails both with rc 2."""
    cond, sig = _inputs(n=B + 1, seed=6)
    req = str(tmp_path / "req.npz")
    np.savez(req, cond_stack=cond, sigmas=sig)
    outs = {}
    for name, main, art, extra in (
            ("port", tserve.main, port_artifact[0], ["--device", "cpu"]),
            ("jax", jserve.main, jax_artifact[0], [])):
        resp = str(tmp_path / f"{name}.npz")
        assert main(["--artifact", art, "--input", req, "--output", resp,
                     "--seed", "3"] + extra) == 0
        outs[name] = np.load(resp)
    for out in outs.values():
        assert sorted(out.files) == ["seed", "x0_white"]
        assert out["x0_white"].shape == (B + 1, L) and int(out["seed"]) == 3
        assert np.isfinite(out["x0_white"]).all()
    _, contract, call, _ = port_artifact
    np.testing.assert_array_equal(
        outs["port"]["x0_white"],
        tsrv.run_batched(call, contract, cond, sig, seed=3))
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, cond_stack=cond[:, :, :L // 2], sigmas=sig)
    assert tserve.main(["--artifact", port_artifact[0], "--input", bad,
                        "--output", str(tmp_path / "x.npz"),
                        "--device", "cpu"]) == 2
    assert jserve.main(["--artifact", jax_artifact[0], "--input", bad,
                        "--output", str(tmp_path / "y.npz")]) == 2


def _exchange(server):
    """healthz, /contract, a POST of 3 requests, a wrong-shape POST and
    healthz again against a running server; returns what came back."""
    host, port = server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=120)
    got = {}
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    got["healthz"] = (r.status, r.read())
    conn.request("GET", "/contract")
    r = conn.getresponse()
    got["contract"] = (r.status, json.loads(r.read()))
    cond, sig = _inputs(n=B + 1, seed=8)
    buf = io.BytesIO()
    np.savez(buf, cond_stack=cond, sigmas=sig, seed=np.int32(5))
    conn.request("POST", "/reconstruct", body=buf.getvalue())
    r = conn.getresponse()
    got["post"] = (r.status, np.load(io.BytesIO(r.read()))["x0_white"])
    bad = io.BytesIO()
    np.savez(bad, cond_stack=cond[:, :, :L // 2], sigmas=sig)
    conn.request("POST", "/reconstruct", body=bad.getvalue())
    r = conn.getresponse()
    r.read()
    got["wrong_shape"] = r.status
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    r.read()
    got["healthz_after"] = r.status
    got["post_input"] = (cond, sig)
    return got


def test_serve_http_against_jax(port_artifact, jax_artifact):
    servers = {"port": tserve.make_server(port_artifact[0], port=0,
                                          device="cpu"),
               "jax": jserve.make_server(jax_artifact[0], port=0)}
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers.values()]
    for t in threads:
        t.start()
    try:
        got = {name: _exchange(s) for name, s in servers.items()}
    finally:
        for s in servers.values():
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for g in got.values():
        assert g["healthz"] == (200, b"ok")
        assert g["post"][0] == 200 and g["post"][1].shape == (B + 1, L)
        assert g["wrong_shape"] == 400 and g["healthz_after"] == 200
    port_c, jax_c = got["port"]["contract"][1], got["jax"]["contract"][1]
    assert port_c == port_artifact[1]
    assert {k: v for k, v in port_c.items() if k not in PORT_ONLY_KEYS
            and k != "artifact_bytes"} == {
        k: v for k, v in jax_c.items() if k != "artifact_bytes"}
    _, contract, call, _ = port_artifact
    cond, sig = got["port"]["post_input"]
    np.testing.assert_array_equal(
        got["port"]["post"][1],
        tsrv.run_batched(call, contract, cond, sig, seed=5))


def test_seeded_normal_is_a_function_of_seed_and_draw():
    seed = torch.tensor(5, dtype=torch.int32)
    a = tsp.seeded_normal(seed, 0, [3, 1, 64], torch.float32,
                          torch.device("cpu"))
    assert a.shape == (3, 1, 64) and a.dtype == torch.float32
    assert torch.equal(a, tsp.seeded_normal(torch.tensor(5, dtype=torch.int32),
                                            0, [3, 1, 64], torch.float32,
                                            torch.device("cpu")))
    for other in ((seed, 1), (torch.tensor(6, dtype=torch.int32), 0)):
        assert not torch.equal(a, tsp.seeded_normal(
            *other, [3, 1, 64], torch.float32, torch.device("cpu")))
    # a source numbers its draws: init is draw 0, then one per step
    src = tsp.SeededNoise(5)
    assert src.seed.dtype == torch.int32 and src.seed.device.type == "cpu"
    assert torch.equal(src.init((3, 1, 64), torch.float32, "cpu"), a)
    assert torch.equal(src.step(0, (3, 1, 64), torch.float32, "cpu"),
                       tsp.seeded_normal(seed, 1, [3, 1, 64], torch.float32,
                                         torch.device("cpu")))


def test_registered_ops_fakes_give_shapes():
    """What ``torch.export`` sees of each op: its fake gives the output's
    shape, dtype and device, with no kernel and no card."""
    seed = torch.tensor(1, dtype=torch.int32)
    with FakeTensorMode() as mode:
        z = tsp.seeded_normal(mode.from_tensor(seed), 2, [4, 1, 32],
                              torch.bfloat16, torch.device("cuda"))
        x = torch.empty(2, 16, 8, dtype=torch.bfloat16, device="cuda")
        W = torch.empty(3, 8, 24, device="cuda")
        v = torch.empty(24, device="cuda")
        y = conv_gn_silu_op(x, W, v, v, v, 8, 1e-5)
        q = torch.empty(2, 4, 100, 64, dtype=torch.bfloat16, device="cuda")
        o = flash_attention_op(q, q, q)
    assert (tuple(z.shape), z.dtype, z.device.type) == (
        (4, 1, 32), torch.bfloat16, "cuda")
    assert (tuple(y.shape), y.dtype, y.device.type) == (
        (2, 16, 24), torch.bfloat16, "cuda")
    assert (tuple(o.shape), o.dtype) == ((2, 4, 100, 64), torch.bfloat16)
    assert {"conv_gn_silu", "flash_attention", "seeded_normal"} <= set(
        dir(torch.ops.gwport))


def test_cpu_plain_path_backpropagates():
    """On the CPU the plain versions carry autograd to every ConvBlock and
    the attention (on CUDA the ops' registered backwards do:
    ``tests/test_torch_port_cuda.py``)."""
    model = UNet1D(in_ch=7, base_ch=8, time_dim=16, depth=2, cond_in_ch=5,
                   use_attention=True, device="cpu")
    randomize_(model, 0)          # the init's final conv and proj are zero
    out = model(torch.randn(2, 7, 64), torch.tensor([3, 40]))
    out.square().mean().backward()
    for name in ("enc0.conv.kernel", "mid.norm.scale", "dec1.conv.kernel",
                 "mid_attn.qkv.kernel"):
        grad = dict(model.named_parameters())[name].grad
        assert grad is not None and grad.abs().sum() > 0, name


@pytest.mark.parametrize("kw", [
    dict(L=4096, in_ch=7, base_ch=64, depth=3, cond_ch=5, fast_decoder=False),
    dict(L=4096, in_ch=7, base_ch=128, depth=3, cond_ch=5),
    dict(L=32768, in_ch=7, base_ch=64, depth=3, cond_ch=5,
         fast_decoder=False, use_attention=True)])
def test_flop_count_matches_jax(kw):
    assert troof.unet_flops_per_sample(**kw) == jroof.unet_flops_per_sample(**kw)


def test_bench_flops_are_jax_count_without_the_fold():
    want = 64 * jroof.unet_flops_per_sample(4096, 7, 64, depth=3, cond_ch=5,
                                            fast_decoder=False)
    assert bench.flops_per_sampler_step() == want
    assert abs(want - 143.63e9) < 0.01e9
    assert troof.peak_for("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert troof.peak_for("TPU v5 lite") is None


def test_card_entry_points_need_a_card(port_artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (bench.run, graft_entry.entry):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_serving.main(["--artifact", port_artifact[0]])
    with pytest.raises(ValueError, match="CUDA events"):
        bench.run(device="cpu")
