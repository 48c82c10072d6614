"""CPU tests of the benchmark's harness (``portbench/``), at tiny sizes
with the kernels' plain versions:

    python -m pytest portbench/tests -q

Tests that need a card are marked ``cuda`` and skip without one; on a
card, ``python3 -m pytest portbench/tests -q -m cuda -o addopts=""`` runs
them (the repository's ``addopts`` load a CPU-only plugin from ``tests/``).
"""

from __future__ import annotations

import copy
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import runner  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 3_000_000_123  # larger than 32 signed bits hold

# each configuration at a size a test can hold, in the cell's numbering
TINY = {
    "p1_poisson_10m.scrambled": {
        "config": {"mesh": {"kind": "tiny", "n": 32, "amp": 0.2}},
        "traffic": {"numbering": {"kind": "block scramble", "S": 256, "G": 97},
                    "warmup": {"n": 16, "numbering": {"kind": "block scramble", "S": 64, "G": 29}}}},
    "p1_poisson_10m.lattice": {
        "config": {"mesh": {"kind": "tiny", "n": 32, "amp": 0.2}},
        "traffic": {"warmup": {"n": 16, "numbering": {"kind": "lattice"}}}},
    "srpde_0p5m.gcv": {
        "config": {"mesh": {"kind": "tiny", "nx": 24, "seed": 7, "amp": 0.35},
                   "locations": {"n": 5000, "low": -0.02, "high": 1.02, "seed": 1239}},
        "traffic": {"warmup": {"nx": 8, "n_locations": 300}}},
}
TINY["srpde_0p5m.fit"] = TINY["srpde_0p5m.gcv"]


def tiny_run(name, trace=False, seconds=0.3, root=ROOT):
    return runner.run_cell(root, name, SEED, seconds, trace, device="cpu",
                           overrides=copy.deepcopy(TINY[name]))


@pytest.mark.parametrize("name", CELLS)
def test_cell_end_to_end(name):
    result, lines = tiny_run(name)
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    wanted = {m["name"] for m in SPEC["end_to_end"] if name in m.get("workloads", [name])}
    assert set(result["metrics"]) == wanted
    assert list(result)[-1] == "checks" and result["checks"]
    assert all(lines)


@pytest.mark.parametrize("name", ["p1_poisson_10m.scrambled", "srpde_0p5m.fit"])
def test_cell_traced(name):
    result, lines = tiny_run(name, trace=True)
    assert result["correct"], lines
    metrics = result["metrics"]
    # on the CPU the device metrics find nothing to read and are left out
    assert "krylov.iterations" in metrics and "krylov.iter_ms" in metrics
    assert not any(k.startswith("device.") or k == "k2_roofline" for k in metrics)
    assert result["device"]["window_s"] > 0
    # the host-clock metrics come from the untraced window, which the
    # traced one follows: the Psi build is outside the Krylov loop
    run_ms = metrics["krylov.iter_ms"]["value"]
    assert run_ms > 0
    if name.startswith("srpde"):
        assert metrics["evaluation.basis_s"]["value"] > 0
    assert not any(k.startswith("driver.cycle") for k in metrics)  # no device memory to read


def _python(code, cwd=ROOT):
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_no_jax_after_imports():
    """run.py, every configuration module and the reference load no module
    whose top-level name is jax, jaxlib or fdapde_core_tpu."""
    code = f"""
import runpy, sys
sys.path.insert(0, {str(ROOT)!r})
runpy.run_path({str(ROOT / 'portbench' / 'run.py')!r}, run_name='not_main')
from pathlib import Path
from portbench.harness import runner
for kind in ('configs', 'reference', 'metrics'):
    for p in sorted((Path({str(ROOT)!r}) / 'portbench' / kind).glob('*.py')):
        runner.load_module(p)
import fdapde_core_tpu_torch, fdapde_core_tpu_torch.models
print(sorted({{m.split('.')[0] for m in sys.modules}} & set(runner.FORBIDDEN)))
"""
    assert _python(code).strip() == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    """The port's name begins with the JAX package's: only whole top-level
    names count."""
    import types

    before = set(runner.forbidden_modules())
    monkeypatch.setitem(sys.modules, "fdapde_core_tpu_torch_probe", types.ModuleType("p"))
    monkeypatch.setitem(sys.modules, "jaxlib_probe.sub", types.ModuleType("p"))
    assert set(runner.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("p"))
    assert "flax" in runner.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from portbench.harness import runner
for p in sorted((Path({str(ROOT)!r}) / 'portbench' / 'reference').glob('*.py')):
    runner.load_module(p)
print(sorted(m for m in sys.modules if m.split('.')[0].startswith('fdapde_core_tpu')
             or m.split('.')[0] in ('jax', 'jaxlib')))
"""
    assert _python(code).strip() == "[]"
    for p in (ROOT / "portbench" / "reference").glob("*.py"):
        src = p.read_text()
        assert "fdapde_core_tpu" not in re.sub(r'""".*?"""', "", src, flags=re.S), p


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + CELLS
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for text in ([c["source"] for c in SPEC["configs"]] + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_files_agree_with_benchmark():
    """Each per-layer metric's file states the unit, source, layer and moved
    metric that BENCHMARK.json gives it; each cell's traffic file its own."""
    for m in SPEC["per_layer"]:
        mod = runner.load_module(ROOT / "portbench" / "metrics" / f"{m['name']}.py")
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["unit"], m["better"], m["source"], m["layer"], m["moves"]), m["name"]
    for w in SPEC["workloads"]:
        t = json.loads((ROOT / "portbench" / "workloads" / f"{w['name']}.json").read_text())
        assert {k: t[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}


def test_new_workload_and_metric_are_found_as_files(tmp_path):
    """A traffic mix and a per-layer metric added as new files (and new
    entries in BENCHMARK.json) run without an edit to any other file."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = copy.deepcopy(SPEC)
    spec["workloads"].append({"name": "p1_poisson_10m.lattice_tiny", "config": "p1_poisson_10m",
                              "traffic": "lattice_tiny", "chips": 1, "why": "a test's cell"})
    spec["per_layer"].append({"name": "jobs.count", "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "driver", "moves": "solve_s",
                              "workloads": ["p1_poisson_10m.lattice_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "portbench" / "workloads" / "p1_poisson_10m.lattice_tiny.json").write_text(
        json.dumps({"config": "p1_poisson_10m", "traffic": "lattice_tiny", "chips": 1,
                    "why": "a test's cell", "numbering": {"kind": "lattice"},
                    "warmup": {"n": 8, "numbering": {"kind": "lattice"}}}))
    (tmp_path / "portbench" / "metrics" / "jobs.count.py").write_text(
        'UNIT, BETTER, SOURCE, LAYER, MOVES = "count", "higher", "host_clock", "driver", '
        '"solve_s"\n\ndef read(run):\n    return len(run.jobs)\n')
    code = f"""
import json, sys
sys.path.insert(0, {str(tmp_path)!r})
sys.path.append({str(ROOT)!r})  # the program, from the repository
from portbench.harness import runner
assert runner.BENCH_DIR.parent.as_posix() == {tmp_path.as_posix()!r}
result, lines = runner.run_cell({str(tmp_path)!r}, "p1_poisson_10m.lattice_tiny", 5, 0.2, True,
                                device="cpu", overrides={{"config": {{"mesh": {{"kind": "t", "n": 16, "amp": 0.2}}}}}})
print(json.dumps([result["correct"], result["metrics"]["jobs.count"]["value"]]))
"""
    correct, jobs = json.loads(_python(code, cwd=tmp_path).strip().splitlines()[-1])
    assert correct and jobs >= 1


def test_reservoir_keeps_a_seeded_sample():
    a, b = runner.Reservoir(2, 11), runner.Reservoir(2, 11)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items and len(a.items) == 2


def test_trace_reduction():
    from portbench.harness.trace import Trace

    dev = [(0, 10, "k1"), (5, 20, "k2"), (40, 50, "Memcpy DtoH"), (100, 110, "k1")]
    host = [(0, 200, "outer"), (25, 35, "cudaStreamSynchronize"), (55, 95, "aten::add")]
    t = Trace(dev, host, 200)
    assert t.busy_ns() == 20 + 10 + 10
    assert len(t.kernels) == 3 and t.host_syncs() == 1
    bd = t.breakdown()
    assert [n for n, _ in bd["device_ops"]] == ["k1", "k2", "Memcpy DtoH"]
    assert bd["device_ops"][0][1] == 20e-9
    # gaps are named by the innermost host event over their middle, else by
    # the last host event that ended before it
    us = 1000  # gaps under 20 us are not named
    dev = [(0, 10 * us, "k1"), (40 * us, 50 * us, "k2"), (100 * us, 130 * us, "k1")]
    host = [(12 * us, 20 * us, "cudaStreamSynchronize"), (55 * us, 95 * us, "cudaMemcpyAsync")]
    assert Trace(dev, host, 130 * us).idle_gaps() == [(50e-6, "host in cudaMemcpyAsync"),
                                                      (30e-6, "host after cudaStreamSynchronize")]


def test_k2_byte_model():
    """Stored entries, not slots: a square table's padding (col = row after
    the row's entries) is not counted; a rectangular one counts its nonzero
    values."""
    from portbench.metrics.k2_bytes import compact_entries, launch_bytes

    cols = torch.tensor([[0, 0, 2], [1, 1, 1], [0, 2, 2]], dtype=torch.int32)  # (K=3, n=3)
    vals = torch.tensor([[2.0, 1.0, 3.0], [1.0, 0.0, 0.0], [5.0, 0.0, 0.0]])
    # row 0: (0, 0), (0, 1), (0, 0) pad -> 2 entries; row 1: (1, 0), (1, 1) -> 2;
    # row 2: (2, 2), (2, 1)... as laid out: cols[:, 2] = 2, 1, 2 -> 2 entries
    assert int(compact_entries(vals, cols, 3)) == 9 - (int((cols == torch.arange(3)).sum()) - 3)
    assert int(compact_entries(vals[:, :2], cols[:, :2], 5)) == 4
    assert launch_bytes(10, 8, 3, 4, 8, 8) == 10 * 12 + 4 * 8 + 3 * 8


# -- the check: the control and planted faults must come out not correct --

def _fault_run(name, monkeypatch, plant):
    plant(monkeypatch)
    result, lines = tiny_run(name)
    return result, lines


def _poisson_state_unchanged(mp):
    from fdapde_core_tpu_torch.models import MatrixFreeElliptic

    def solve(self, b, g=None, rtol=1e-9, maxiter=200, chunk=None, on_chunk=None):
        return torch.where(self.boundary, g, 0.0), 1, 0.0

    mp.setattr(MatrixFreeElliptic, "solve", solve)


def _poisson_answer_altered(mp):
    from fdapde_core_tpu_torch.models import MatrixFreeElliptic

    orig = MatrixFreeElliptic.solve

    def solve(self, *a, **k):
        x, its, rel = orig(self, *a, **k)
        x = x.clone()
        x[x.shape[0] // 2] += 1e-3 * float(x.abs().max())
        return x, its, rel

    mp.setattr(MatrixFreeElliptic, "solve", solve)


def _srpde_state_unchanged(mp):
    from fdapde_core_tpu_torch.models import regression

    orig = regression.cg

    def cg(A, b, *a, **k):
        x, info = orig(A, b, *a, **k)
        return torch.zeros_like(x), info

    mp.setattr(regression, "cg", cg)


def _srpde_answer_altered(mp):
    from fdapde_core_tpu_torch.models import SmoothingRegression

    orig = SmoothingRegression._fit_psi

    def fit(self, *a, **k):
        c = orig(self, *a, **k).clone()
        c[c.shape[0] // 2] += 1e-3 * float(c.abs().max())
        self.coefficients_ = c
        return c

    mp.setattr(SmoothingRegression, "_fit_psi", fit)


def _srpde_half_the_probes(mp):
    from fdapde_core_tpu_torch.models import SmoothingRegression

    orig = SmoothingRegression._trace_smoother_hutchinson

    def half(self, Psi, lam, n_probes, seed, rtol, maxiter):
        return orig(self, Psi, lam, max(1, n_probes // 2), seed, rtol, maxiter)

    mp.setattr(SmoothingRegression, "_trace_smoother_hutchinson", half)


FAULTS = [
    ("p1_poisson_10m.scrambled", _poisson_state_unchanged),
    ("p1_poisson_10m.scrambled", _poisson_answer_altered),
    ("p1_poisson_10m.lattice", _poisson_state_unchanged),
    ("p1_poisson_10m.lattice", _poisson_answer_altered),
    ("srpde_0p5m.fit", _srpde_state_unchanged),
    ("srpde_0p5m.fit", _srpde_answer_altered),
    ("srpde_0p5m.gcv", _srpde_state_unchanged),
    ("srpde_0p5m.gcv", _srpde_answer_altered),
    ("srpde_0p5m.gcv", _srpde_half_the_probes),
]


@pytest.mark.parametrize("name,plant", FAULTS, ids=[f"{n}-{p.__name__[1:]}" for n, p in FAULTS])
def test_planted_fault_is_not_correct(name, plant, monkeypatch):
    result, lines = _fault_run(name, monkeypatch, plant)
    assert result["correct"] is False, lines


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in float32 in the program's place fails the check."""
    from portbench import control

    out = control.readings(name, [], [11, 12, 13], device="cpu", overrides=copy.deepcopy(TINY[name]))
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name.split('.')[0]}.json").read_text())
    limits = cfg["limits"]
    for _, reading in out["control"]:
        assert any(v > limits[k] for k, v in reading.items()), reading


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell on the card, through the command."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          str(SEED), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
