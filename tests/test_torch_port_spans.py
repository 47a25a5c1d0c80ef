"""The served path's profiler ranges (``utils/spans.py``) on the CPU at a
tiny width, through ``serving.build_serving_fn``: how often each opens in a
call, how they nest, that with the profiler off a call opens none and
answers bit-equal, and that an exported artifact holds none."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import serving as tsrv
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import schedules as tsch
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils import spans
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.checkpoint import save_checkpoint
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import randomize_

B, C, L, T, S, STEPS, DEPTH = 2, 5, 128, 50, 2, 3, 2
ARGS = {"base_ch": 8, "in_ch": 7, "cond_in_ch": C, "T": T,
        "schedule": "cosine", "pred_type": "v", "time_dim": 16,
        "depth": DEPTH, "use_attention": True}
CK = {"in_ch": 7, "cond_in_ch": C, "pred_type": "v"}


@pytest.fixture(scope="module")
def model():
    m = UNet1D(in_ch=7, base_ch=8, time_dim=16, depth=DEPTH,
               t_embed_max_time=float(T - 1), cond_in_ch=C,
               use_selfcond=True, use_attention=True, device="cpu")
    randomize_(m, 0)
    return m.eval()


def _serving_fn(sampler="ddim"):
    schedule = tsch.make_schedule(T)
    cfg, sampler = tsrv.resolve_serving_config(CK, schedule, sampler=sampler,
                                               steps=STEPS)
    return tsrv.build_serving_fn(schedule, cfg, sampler=sampler, avg_seeds=S,
                                 amp_calib="mf", device="cpu")


def _inputs():
    rng = np.random.default_rng(4)
    return (rng.standard_normal((B, C, L)).astype(np.float32),
            np.array([0.5, 2.0], np.float32))


def _traced_call(model, fn):
    """The call's answer and its ranges, (name, start, end) each."""
    cond, sig = _inputs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(model, cond, sig, 7)
    got = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name in spans.SPANS]
    return out, got


@pytest.mark.parametrize("sampler", ["ddim", "ddpm", "dpmpp"])
def test_each_span_opens_once_a_call_or_once_a_step(model, sampler):
    _, got = _traced_call(model, _serving_fn(sampler))
    counts = {name: 0 for name in spans.SPANS}
    for name, _, _ in got:
        counts[name] += 1
    levels = 2 * DEPTH + 1
    assert counts == {
        "serve/call": 1, "serve/inputs": 1, "serve/aggregate": 1,
        "serve/calibrate": 1, "sampler/start": 1,
        "sampler/step": STEPS, "sampler/net_in": STEPS,
        "sampler/guide": STEPS, "sampler/update": STEPS,
        "unet/forward": STEPS, "unet/film": levels * STEPS,
        # the conditioning resized once a forward for each stage length;
        # its bias added in K1's call, outside the span
        "unet/cond_bias": (DEPTH + 1) * STEPS,
        # the encoder's pools; a decoder block's upsample and concatenation
        # (the route's, or here in f32 the wrapper's) open no span
        "unet/resample": DEPTH * STEPS, "unet/attn": STEPS}


def test_spans_nest_from_the_call_down(model):
    _, got = _traced_call(model, _serving_fn())
    parent = {"serve/inputs": "serve/call", "serve/aggregate": "serve/call",
              "serve/calibrate": "serve/call", "sampler/start": "serve/call",
              "sampler/step": "serve/call", "sampler/net_in": "sampler/step",
              "sampler/guide": "sampler/step",
              "sampler/update": "sampler/step",
              "unet/forward": "sampler/step"}
    for name in spans.SPANS:
        if name.startswith("unet/") and name != "unet/forward":
            parent[name] = "unet/forward"
    assert set(parent) | {"serve/call"} == set(spans.SPANS)
    for name, lo, hi in got:
        if name == "serve/call":
            continue
        assert any(p == parent[name] and plo <= lo and hi <= phi
                   for p, plo, phi in got), name
    # the leaf spans do not overlap one another
    leaves = sorted((lo, hi) for name, lo, hi in got
                    if name not in parent.values())
    assert all(a[1] <= b[0] for a, b in zip(leaves, leaves[1:]))


def test_with_the_profiler_off_a_call_opens_no_range(model, monkeypatch):
    entered = []
    real = torch.ops.profiler._record_function_enter_new

    def counting(*a, **kw):
        entered.append(a[0] if a else None)
        return real(*a, **kw)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counting)
    with torch.profiler.record_function("a range the counter must see"):
        pass
    assert entered == ["a range the counter must see"]
    assert spans.span("serve/call") is spans._OFF
    assert spans.span("unet/film") is spans._OFF
    cond, sig = _inputs()
    _serving_fn()(model, cond, sig, 7)
    assert entered == ["a range the counter must see"]


def test_answers_are_bit_equal_with_the_profiler_on_and_off(model):
    cond, sig = _inputs()
    fn = _serving_fn()
    off = fn(model, cond, sig, 7)
    on, got = _traced_call(model, fn)
    assert got and torch.equal(on, off)


def test_an_exported_artifact_holds_no_range(model, tmp_path, monkeypatch):
    ckpt = str(tmp_path / "model.msgpack")
    save_checkpoint(ckpt, model.state_dict(), dict(ARGS), epoch=1)
    seen = []
    real = tsrv._op_counts

    def op_counts(ep):
        seen.append(ep)
        return real(ep)

    monkeypatch.setattr(tsrv, "_op_counts", op_counts)
    contract = tsrv.export_sampler(ckpt, str(tmp_path / "a.pt2"), batch=B,
                                   length=L, device="cpu", steps=2,
                                   avg_seeds=S, amp_calib="mf")
    # a CPU artifact holds the kernels' plain versions and one noise draw
    assert contract["ops"] == {"conv_gn_silu": 0, "flash_attention": 0,
                               "unet_head": 0,
                               "seeded_normal": 1}
    targets = [str(node.target) for gm in seen[0].graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule)
               for node in gm.graph.nodes if node.op == "call_function"]
    assert targets
    assert not [t for t in targets if "profiler" in t or "record" in t]
