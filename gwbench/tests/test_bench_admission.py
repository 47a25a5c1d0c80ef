"""A second architecture enters a copy of the tree as files and entries
only, and the benchmark's own suite passes there with it.

The copy holds ``gwbench/`` (this module left out, so that the suite does
not run it again), ``BENCHMARK.json`` and a link to the port.  The toy
enters it as ``arch/toy.py`` (``toy_arch``), ``reference/toy.py``
(``toy_reference``), ``configs/toy.json`` (``toy_arch.CONFIG``, cut in
``num_blocks``) and ``limits/toy.recon_batch.json``; ``BENCHMARK.json``
gains its configuration, a cell ``toy.recon_batch`` on the attention
flagship's traffic, and the cell's name at the end of the ``workloads`` of
the metrics in ``JOINS``.  No other field of any entry changes."""
import copy
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

from gwbench import cell, port
from gwbench.tests import tiny, toy_arch

CELL = "toy.recon_batch"
# the metrics the toy's cell joins: the rate, the forward's share of the
# peak, the device's idle share and the sampler's own share
JOINS = ("recon_per_s", "mfu.recon", "idle_share.recon",
         "sampler_self_share.recon")
# cases of the toy's configuration and cell that the suite has to run and
# pass in the copy
TOY_CASES = (
    "test_bench_cells.py::test_cell_resolves_to_its_files[toy.recon_batch]",
    "test_bench_cells.py::"
    "test_cell_reports_setup_another_metric_and_a_layer[toy.recon_batch]",
    "test_bench_yardstick.py::test_every_configurations_counts_are_finite[toy]",
)


def _toy_file(name: str, old: str, new: str) -> str:
    """``tests/<name>`` with its import ``old`` written as ``new``: the
    import of a file in the architecture's place."""
    text = (cell.HERE / "tests" / name).read_text()
    assert old in text, (name, old)
    return text.replace(old, new)


def admit(bench: dict) -> dict:
    """``bench`` with the toy's configuration and cell, and the cell at the
    end of the ``workloads`` of each metric in ``JOINS``."""
    bench = copy.deepcopy(bench)
    bench["configs"].append({
        "name": "toy", "source": toy_arch.CONFIG["source"],
        "file": "gwbench/configs/toy.json", "reduced": ["num_blocks"],
        "why": "a toy second architecture: blocks of K1 with FiLM, cut to 2 "
               "of 28 blocks"})
    bench["workloads"].append({
        "name": CELL, "config": "toy", "traffic": "recon_b4_s50", "chips": 1,
        "why": "the toy on the 16 kHz flagship's traffic: 64 rows a forward, "
               "50 DDIM steps, closed loop"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in JOINS:
            m["workloads"].append(CELL)
    return bench


def _copy(root, dest) -> None:
    """The tree at ``root`` with the toy admitted, at ``dest``."""
    shutil.copytree(root / "gwbench", dest / "gwbench",
                    ignore=shutil.ignore_patterns("__pycache__",
                                                  "test_bench_admission.py"))
    (dest / port.PORT).symlink_to(root / port.PORT, target_is_directory=True)
    g = dest / "gwbench"
    (g / "arch" / "toy.py").write_text(_toy_file(
        "toy_arch.py", "from gwbench.tests import toy_reference",
        "from gwbench.reference import toy as toy_reference"))
    (g / "reference" / "toy.py").write_text(_toy_file(
        "toy_reference.py", "from gwbench.reference import identity",
        "from . import identity"))
    (g / "configs" / "toy.json").write_text(json.dumps(toy_arch.CONFIG,
                                                       indent=1))
    (g / "limits" / f"{CELL}.json").write_text(json.dumps(tiny.LIMITS))
    (dest / "BENCHMARK.json").write_text(
        json.dumps(admit(cell.benchmark(root)), indent=1))


def _outcomes(report) -> dict:
    """``file.py::case`` -> "passed", "failed" or "skipped", from a JUnit
    report."""
    out = {}
    for case in ET.parse(report).getroot().iter("testcase"):
        key = f"{case.get('classname').split('.')[-1]}.py::{case.get('name')}"
        kinds = {c.tag for c in case}
        out[key] = ("failed" if kinds & {"failure", "error"} else
                    "skipped" if "skipped" in kinds else "passed")
    return out


def test_a_second_architecture_enters_a_copy_as_files(tmp_path):
    """The benchmark's suite, the card's tests left out (they run the
    cells on the card), passes in the copy, the toy's cases with it."""
    dest = tmp_path / "tree"
    dest.mkdir()
    _copy(cell.ROOT, dest)
    report = tmp_path / "report.xml"
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "gwbench/tests", "-q", "-m",
         "not cuda", "-p", "no:cacheprovider", f"--junitxml={report}"],
        cwd=dest, env=env, capture_output=True, text=True, timeout=600)
    got = _outcomes(report)
    failed = sorted(k for k, v in got.items() if v == "failed")
    assert out.returncode == 0 and not failed, (failed, out.stdout[-4000:])
    assert "test_bench_yardstick.py::test_unet_flops_equal_the_ports[toy]" \
        not in got
    assert {k: got.get(k) for k in TOY_CASES} == \
        {k: "passed" for k in TOY_CASES}
