"""The harness loads neither JAX nor the JAX package, the reference loads
nothing of the program, and a checkout without the program fails."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

PROBE = """
import sys, json
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=ROOT, imports=imports)],
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(
        "import glob, os, importlib.util\n"
        "import bench_port.run\n"
        "from bench_port.harness import cell, check, trace\n"
        "import plankassembly_tpu_torch.decode\n"
        "for p in sorted(glob.glob(os.path.join(%r, 'bench_port', '*', '*.py'))):\n"
        "    if '/tests/' in p: continue\n"
        "    cell.load_file(p, 'm_' + os.path.basename(p).replace('.', '_'))\n"
        % ROOT)
    # whole top-level names: the port's name begins with the JAX package's
    assert not names & {"jax", "jaxlib", "flax", "plankassembly_tpu"}
    assert "plankassembly_tpu_torch" in names


def test_reference_loads_nothing_of_the_program():
    names = _top_level("import bench_port.reference.model, "
                       "bench_port.reference.packing")
    assert not names & {"jax", "jaxlib", "flax", "plankassembly_tpu",
                        "plankassembly_tpu_torch"}


def test_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_port"),
                    tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "complete.offline_b64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
