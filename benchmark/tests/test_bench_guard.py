"""No run loads JAX or the JAX package, and the reference loads nothing of
the program: module names are compared by their whole top-level name."""

import subprocess
import sys

from benchmark import run
from benchmark.tests.conftest import ROOT

PROBE = """
import sys
sys.path.insert(0, {root!r})
{body}
tops = sorted({{name.split(".")[0] for name in sys.modules}})
print(" ".join(tops))
"""


def loaded_tops(body):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, body=body)],
        capture_output=True,
        text=True,
        check=True,
        cwd=ROOT,
    ).stdout
    return set(out.split())


def test_the_reference_imports_nothing_of_the_program():
    tops = loaded_tops(
        "import benchmark.reference.diffusion, "
        "benchmark.reference.navier_stokes"
    )
    assert "numpy" in tops
    for name in ("pararealml_tpu_torch", "pararealml_tpu", "jax", "torch"):
        assert name not in tops


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    body = (
        "from benchmark import run\n"
        "args = run.parse_args(['--workload', 'navier_stokes.solve', "
        "'--seed', '5', '--seconds', '0.1'])\n"
        f"assert run.run(args, root={tiny_root!r}, device='cpu')['correct']"
    )
    tops = loaded_tops(body)
    assert "pararealml_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN_MODULES)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pararealml_tpu_torch_fake", sys)
    assert run.loaded_forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pararealml_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.loaded_forbidden_modules() == ["jax", "pararealml_tpu"]
