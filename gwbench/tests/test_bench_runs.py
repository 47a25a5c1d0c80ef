"""Whole runs of the reconstruction driver at a tiny size on the CPU: the
result line's shape, ``correct`` true on the program and false with an
answer altered underneath it, the control failing what the program passes,
and no JAX module loaded."""
import json
import subprocess
import sys


from gwbench import control, port, run as grun
from gwbench.drivers import serve_batch
from gwbench.tests import tiny



def _line(ctx):
    return grun.result_line(ctx, tiny.bench_for(ctx), serve_batch.run(ctx))


def test_result_line_shape_and_correct():
    ctx = tiny.context()
    line = _line(ctx)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"setup_s", "recon_per_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["compared"]) == set(ctx.limits["numbers"])
    json.dumps(line)


def _altered_answers(monkeypatch):
    real = port.serving_fn

    def serving_fn(config, traffic, device):
        fn, cfg = real(config, traffic, device)

        def altered(model, cond, sig, seed):
            out = fn(model, cond, sig, seed).clone()
            out[0] = 1.1 * out[0]
            return out

        return altered, cfg

    monkeypatch.setattr(port, "serving_fn", serving_fn)


def test_an_answer_altered_underneath_makes_the_run_incorrect(monkeypatch):
    _altered_answers(monkeypatch)
    line = _line(tiny.context())
    assert line["correct"] is False, line["compared"]


def test_the_control_reads_above_the_program():
    ctx = tiny.context(dtype="bfloat16")
    got = control.recon_readings(ctx, True)
    prog, ctl = got["program"], got["control"]
    assert all(ctl[k] > 3 * prog[k] for k in prog), got


def test_no_jax_module_after_a_run():
    code = ("import sys, time, torch; sys.path.insert(0, '.');"
            "from gwbench.tests import tiny; from gwbench import cell;"
            "from gwbench.drivers import serve_batch;"
            "serve_batch.run(tiny.context());"
            "print(cell.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(tmp_path):
    (tmp_path / "jax.py").write_text("")
    (tmp_path / "jaxtyping.py").write_text("")
    code = ("import sys; sys.path[:0] = [%r, '.']; import jaxtyping;"
            "from gwbench import cell; print(cell.forbidden_modules());"
            "import jax; print(cell.forbidden_modules())" % str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split("\n")[:2] == ["[]", "['jax']"], out.stderr
