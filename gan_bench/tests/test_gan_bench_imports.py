"""What ``python -m gan_bench.run`` and everything it imports loads: never
``jax``, ``jaxlib``, ``flax`` or the JAX package (top-level names compared
whole: the port's name begins with the JAX package's); the references load
nothing of the port; and a run that finds the JAX package loaded prints no
result."""

import ast
import os
import subprocess
import sys

from gan_bench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "gan_lib_tensorflow_tpu"}
PORT = "gan_lib_tensorflow_tpu_torch"


def test_the_harness_and_every_file_it_finds_load_no_jax():
    code = (
        "import sys\n"
        "from gan_bench import run, calibrate\n"
        "b = run.benchmark()\n"
        "for w in b['workloads']:\n"
        "    for k in ('builders', 'counts', 'reference'):\n"
        "        run.module(k, w['config'])\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    run.module('metrics', m['name'])\n"
        "print(sorted({m.split('.', 1)[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert PORT in loaded and not loaded & FORBIDDEN


def test_the_references_import_nothing_of_the_program():
    ref_dir = os.path.join(run.HERE, "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                top = m.split(".", 1)[0]
                assert top not in FORBIDDEN | {PORT, "gan_bench"}, (name, m)


def test_a_run_that_loaded_the_jax_package_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"checks": {}, "_where": {}})
    monkeypatch.setitem(sys.modules, "gan_lib_tensorflow_tpu", object())
    rc = run.main(["--workload", "sngan_proj_imagenet128.cached", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 4 and out.out == "" and "gan_lib_tensorflow_tpu" in out.err
    assert run.forbidden_modules() == ["gan_lib_tensorflow_tpu"]
