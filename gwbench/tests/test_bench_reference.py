"""The plain reference against the port at a tiny size on the CPU, and the
reference's independence from the program."""
import ast
import subprocess
import sys
from pathlib import Path

import torch

from gwbench import inputs
from gwbench.reference import rounding, sampler, unet
from gwbench.tests import tiny

PORT = "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
REF = Path(__file__).resolve().parents[1] / "reference"


def _port_unet(dtype=None):
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D

    m = tiny.MODEL
    return UNet1D(in_ch=m["in_ch"], base_ch=m["base_ch"],
                  time_dim=m["time_dim"], depth=m["depth"],
                  t_embed_max_time=m["t_embed_max_time"],
                  cond_in_ch=m["cond_in_ch"], use_selfcond=True,
                  use_attention=True, dtype=dtype, device="cpu")


def test_parameter_names_and_shapes_are_the_ports():
    model = _port_unet()
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == \
        unet.parameter_shapes(tiny.MODEL)


def test_unet_forward_equals_the_ports_in_float32():
    P = inputs.weights(tiny.MODEL, 7, "cpu")
    model = _port_unet()
    model.load_state_dict(P)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 7, 256), generator=g)
    t = torch.tensor([0, 500, 999])
    with torch.no_grad():
        want = unet.forward(P, x, t, tiny.MODEL)
        got = model(x, t)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_unet_forward_in_bfloat16_rounding_is_near_the_ports_bf16():
    P = inputs.weights(tiny.MODEL, 8, "cpu")
    model = _port_unet(torch.bfloat16)
    model.load_state_dict(P)
    x = torch.randn((2, 7, 256), generator=torch.Generator().manual_seed(1))
    t = torch.tensor([10, 700])
    with torch.no_grad():
        f32 = unet.forward(P, x, t, tiny.MODEL)
        bf = unet.forward(P, x, t, tiny.MODEL, rounding("bfloat16"))
        got = model(x, t)
    gap = float((got - bf).norm() / f32.norm())
    assert gap < float((got - f32).norm() / f32.norm()) + 0.02


def test_sampler_noise_is_the_ports_draw():
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import SeededNoise

    z = SeededNoise(123456).init((4, 1, 32), torch.float32, "cpu")
    g = torch.Generator().manual_seed(sampler.stream_seed(123456, 0))
    assert torch.equal(z, torch.randn((4, 1, 32), generator=g))


def test_ladder_and_schedule_are_the_ports():
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import schedules

    for steps in (4, 50, 200):
        assert (sampler.t_ladder(1000, steps)
                == schedules.build_t_schedule(1000, steps)).all()
    assert torch.equal(torch.as_tensor(sampler.cosine_alpha_bar(1000)),
                       schedules.make_schedule(1000, "cosine").alpha_bar)


def test_float8_rounding_is_coarser_than_bfloat16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(2))
    e8 = float((rounding("float8_e4m3")(x) - x).norm() / x.norm())
    e16 = float((rounding("bfloat16")(x) - x).norm() / x.norm())
    assert e8 > 8 * e16 > 0


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_only_torch_numpy_and_the_standard_library():
    allowed = {"torch", "numpy", "math", "typing", "contextlib", "importlib",
               "__future__"}
    for path in REF.glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in allowed, (path.name, name)


def test_reference_loads_nothing_of_the_program():
    """Neither the sampler nor any architecture's plain forward, imported
    as the sampler looks it up."""
    mods = ", ".join(repr(f"gwbench.reference.{p.stem}")
                     for p in REF.glob("*.py") if p.stem != "__init__")
    code = ("import sys, importlib, gwbench.reference.sampler; "
            f"[importlib.import_module(m) for m in ({mods},)]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"({PORT!r}, 'jax', 'jaxlib', 'flax', {PORT[:-6]!r})]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_reference_runs_with_tf32_off(monkeypatch):
    """The sampler turns TF32 off for products and convolutions (the card
    would take float32 in TF32 otherwise) and restores the switches."""
    seen = []

    def spy(real):
        def forward(*a, **kw):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return real(*a, **kw)
        return forward

    monkeypatch.setattr(unet, "forward", spy(unet.forward))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    from gwbench.drivers import serve_batch

    assert serve_batch.run(tiny.context())["numbers"]
    assert seen and all(s == (False, False) for s in seen), set(seen)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True
