"""The port-side ``tools/report_run`` (``gan_lib_tensorflow_tpu_torch/tools/
report_run.py``) against the reference's ``tools/report_run.py`` on the
same port run directory: every key of the report and every printed line
is the reference's, except ``checkpoints``, where the port lists its
``step_<n>.pt`` files and the reference, which looks for orbax step
directories, lists none.
"""

import importlib.util
import json
import os

import pytest
import torch

from gan_lib_tensorflow_tpu_torch.cli import train_pix2pix
from gan_lib_tensorflow_tpu_torch.tools import report_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_pix2pix.main(["--device", "cpu", "--image-size", "32", "--scale-size", "36",
                            "--ngf", "4", "--ndf", "4", "--compute-dtype", "fp32",
                            "--data", "fake", "--steps", "5", "--sample-every", "2",
                            "--log-every", "1", "--ckpt-every", "1", "--out-dir", str(out)])
    finally:
        torch.set_num_threads(n)
    return str(out)


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_report_run", os.path.join(REPO, "tools", "report_run.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_report_equals_the_references_but_counts_the_port_checkpoints(run_dir, tmp_path, capsys):
    ref = _reference()
    want, got = ref.analyze(run_dir), report_run.analyze(run_dir)
    assert want.pop("checkpoints") == []
    assert got.pop("checkpoints") == [3, 4, 5]  # max_to_keep 3 of the five written
    assert got == want and got["sample_grids"] > 0 and got["last_step"] == 5

    rcs = []
    for module, name in ((ref, "ref"), (report_run, "port")):
        rcs.append(module.main([run_dir, "--json", str(tmp_path / f"{name}.json")]))
    ref_out, port_out = capsys.readouterr().out.split("# Run report", 2)[1:]
    assert rcs[0] == rcs[1]
    diff = [(a, b) for a, b in zip(ref_out.splitlines(), port_out.splitlines()) if a != b]
    assert diff == [("checkpoints: 0", "checkpoints: 3 (first 3, last 5)")]
    ref_json = json.loads((tmp_path / "ref.json").read_text())
    port_json = json.loads((tmp_path / "port.json").read_text())
    assert port_json.pop("checkpoints") == [3, 4, 5] and ref_json.pop("checkpoints") == []
    assert port_json == ref_json
