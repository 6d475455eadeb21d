"""Nothing a run or the reference loads is JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from portbench import control, run
run.run_cell("tem_refine.drift", 5, 0.0, False, device="cpu",
             overrides={{"height": 64, "width": 96, "n_frames": 20,
                         "pair_ref_blocks": 1}},
             traffic_overrides={{"chunk_frames": 4}})
control.readings("tem_compose.drift", 5, 9, torch.device("cpu"),
                 overrides={{"height": 64, "width": 96, "pair_ref_blocks": 1}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources(*parts):
    top = os.path.join(BENCH, *parts)
    for dirpath, _, files in os.walk(top):
        rel = os.path.relpath(dirpath, BENCH).split(os.sep)
        if "out" in rel or "tests" in rel:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_run_and_reference_load_no_jax_or_repro():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", CHILD.format(root=ROOT)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded          # the system under test ran
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    paths = list(_sources("reference"))
    assert paths
    for path in paths:
        names = set(_imports(path))
        assert not names & (FORBIDDEN | {"repro_torch"}), (path, names)


def test_only_the_harness_entry_imports_the_program():
    for path in _sources():
        names = set(_imports(path))
        assert not names & FORBIDDEN, (path, names)
        if os.path.basename(path) != "run.py":
            assert "repro_torch" not in names, path
