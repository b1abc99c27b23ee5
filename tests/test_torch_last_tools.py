"""The last tools of the JAX package on the torch side
(``gan_lib_tensorflow_tpu_torch/tools/``: ``prepack_synthetic``, ``plot_run``,
``plot_ladder``, ``plot_dose_response``, ``doctor`` and ``verify_all.sh``)
against the reference's (``tools/*``, loaded from their files), on the CPU.

- ``prepack_synthetic``: an unconditional pyramid whose ``--chunk`` does
  not divide ``--n``, and a conditional flat store, byte-equal to the
  reference tool's, file by file; a bad ``--resolutions`` refused by both
  alike; the digest of the store ``chip_smoke.py`` phase 20 writes on the
  card is the reference tool's (``tests/torch_fixtures/prepack_synthetic.
  json``; ``python tests/test_torch_last_tools.py --digest`` rewrites it).
- The plot tools' loaders return what the reference's return on the same
  files, and fail with the reference's messages; each figure decodes
  through the port's ``data/codec.py`` at the reference figure's size in
  pixels, with its title in a PNG text chunk, series drawn in every panel,
  and the ladder's rules at the columns its phase offsets give.
- ``--curves`` PNGs and sample grids stay byte-equal to what the port wrote
  before the figure module (digests of the earlier ``utils/logging.py``).
- The doctor returns within its limits here (rc 1, the CPU-only verdict,
  ``nvcc`` and the card reported missing) with JAX unimportable, and a
  probe past its timeout comes back as a timeout record.
- ``verify_all.sh`` parses as bash; each port module it runs imports and
  parses the flags it passes; it runs nothing of the JAX package.
- The new modules import no JAX, matplotlib, Pillow or reference module.
"""

import argparse
import contextlib
import hashlib
import importlib
import importlib.util
import io
import json
import math
import os
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu_torch.data import codec
from gan_lib_tensorflow_tpu_torch.data.packed import store_digest
from gan_lib_tensorflow_tpu_torch.tools import (doctor, figure, plot_dose_response, plot_ladder,
                                                plot_run, prepack_synthetic)
from gan_lib_tensorflow_tpu_torch.utils.images import save_image_grid
from gan_lib_tensorflow_tpu_torch.utils.logging import ScalarLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
SYNTH_FIXTURE = os.path.join(REPO, "tests", "torch_fixtures", "prepack_synthetic.json")
VERIFY = os.path.join(REPO, "gan_lib_tensorflow_tpu_torch", "tools", "verify_all.sh")
NEW_MODULES = ["figure", "plot_run", "plot_ladder", "plot_dose_response", "prepack_synthetic",
               "doctor"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the work here is tiny, and several test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _tools_on_path():
    """The reference prepack tool imports its sibling ``prepack_dataset``."""
    sys.path.insert(0, TOOLS)
    try:
        yield
    finally:
        sys.path.remove(TOOLS)


def _ref_prepack(argv):
    with _tools_on_path(), contextlib.redirect_stdout(io.StringIO()) as buf:
        _ref_tool("prepack_synthetic").main(argv)
    return buf.getvalue()


def _port_prepack(argv):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert prepack_synthetic.main(argv) == 0
    return buf.getvalue()


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("flags,members", [
    (["--n", "20", "--size", "16", "--resolutions", "16,8,4", "--chunk", "8"],
     ["r0016/images.u8", "r0016/meta.json", "r0008/images.u8", "r0008/meta.json",
      "r0004/images.u8", "r0004/meta.json"]),
    (["--n", "12", "--size", "32", "--num-classes", "3"],
     ["images.u8", "meta.json", "labels.npy"]),
], ids=["pyramid-ragged-chunk", "conditional-flat"])
def test_prepack_synthetic_is_byte_equal_to_the_references(tmp_path, flags, members):
    out = _port_prepack(["--out", str(tmp_path / "port")] + flags)
    ref_out = _ref_prepack(["--out", str(tmp_path / "ref")] + flags)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert sorted(got) == sorted(want) == sorted(members)
    for name in members:
        assert got[name] == want[name], name
    # the same progress lines (but their rates) and the same final keys
    progress = lambda text: [line.split(" (")[0] for line in text.splitlines()[:-1]]
    assert progress(out) == progress(ref_out) and progress(out)
    last = {k: v for k, v in json.loads(out.splitlines()[-1]).items() if k != "out"}
    want = {k: v for k, v in json.loads(ref_out.splitlines()[-1]).items() if k != "out"}
    assert set(last) == set(want) == {"packed", "size", "resolutions", "seconds", "img_per_s"}
    assert (last["packed"], last["size"], last["resolutions"]) == \
        (want["packed"], want["size"], want["resolutions"])
    # a --resolutions that does not start at --size, or does not descend
    size = flags[flags.index("--size") + 1]
    for bad in (f"{int(size) // 2},{int(size) // 4}", f"{size},4,8"):
        argv = ["--out", str(tmp_path / "bad"), *flags, "--resolutions", bad]
        with pytest.raises(ValueError) as port_err:
            prepack_synthetic.main(argv)
        with pytest.raises(ValueError) as ref_err, _tools_on_path():
            _ref_tool("prepack_synthetic").main(argv)
        assert str(port_err.value) == str(ref_err.value)


def _synth_digest(tmp_path, which):
    with open(SYNTH_FIXTURE) as f:
        fixture = json.load(f)
    out = str(tmp_path / which)
    (_ref_prepack if which == "ref" else _port_prepack)(["--out", out] + fixture["flags"])
    return fixture, store_digest(out)


def test_prepack_synthetic_digest_for_the_card_is_the_references(tmp_path):
    fixture, ref = _synth_digest(tmp_path, "ref")
    assert ref == fixture["store_digest"]
    assert _synth_digest(tmp_path, "port")[1] == ref


def _write_log(path, records):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "log.jsonl"), "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def _run_history(run):
    recs = [{"config": {"model": "sngan"}}]
    for s in range(100, 1001, 100):
        rec = {"step": s, "d_loss": 1.0 + math.sin(s / 90), "g_loss": 0.5 + s / 1000,
               "sec_per_step": 0.1}
        if s % 300 == 0:
            rec.update(fid=80.0 - s / 20, inception_score=3.0 + s / 500)
        recs.append(rec)
    _write_log(run, recs)


def test_load_history_is_the_references(tmp_path):
    _run_history(tmp_path / "run")
    assert plot_run.load_history(str(tmp_path / "run")) == \
        _ref_tool("plot_run").load_history(str(tmp_path / "run"))


def _ladder(run):
    for res in (4, 8, 16):
        for name in ("transition", "stabilize"):
            if res == 4 and name == "transition":
                continue
            recs = [{"config": 1}] + [{"step": s, "wdist": res * 0.1 + s, "gp": 0.5 / s,
                                       "d_loss": 1.0} for s in (1, 2, 3)]
            _write_log(os.path.join(run, f"{res}x{res}_{name}"), recs)
    _write_log(os.path.join(run, "32x32_transition"), [{"config": 1}])  # no step: skipped
    os.makedirs(os.path.join(run, "64x64_stabilize"))                 # no log: skipped
    _write_log(os.path.join(run, "eval"), [{"step": 1, "wdist": 9.0}])  # no phase: skipped
    _write_log(os.path.join(run, "16x8_transition"), [{"step": 1}])    # not square: skipped


def test_ladder_loader_is_the_references(tmp_path):
    ref = _ref_tool("plot_ladder")
    _ladder(str(tmp_path / "run"))
    for name in ("4x4_stabilize", "8x8_transition", "16x16_stabilize", "eval", "3x3_fade",
                 "1024x1024_transition", "16x8_transition", "08x8_stabilize"):
        assert plot_ladder.phase_order(name) == ref.phase_order(name), name
    got = plot_ladder.load_ladder(str(tmp_path / "run"))
    assert got == ref.load_ladder(str(tmp_path / "run"))
    assert [n for n, _ in got] == ["4x4_stabilize", "8x8_transition", "8x8_stabilize",
                                   "16x16_transition", "16x16_stabilize"]
    empty = tmp_path / "empty"
    os.makedirs(empty / "eval")
    with pytest.raises(SystemExit) as port_err:
        plot_ladder.main([str(empty)])
    with pytest.raises(SystemExit) as ref_err:
        ref.main([str(empty)])  # the reference's main imports matplotlib first
    assert str(port_err.value) == str(ref_err.value)


def _eval_json(run, **drop):
    rec = {"swd_128": 10.0, "swd_64": 20.0, "swd_32": 15.0, "swd_16": 5.0, "swd_avg": 12.5,
           "ms_ssim": 0.2}
    for k in drop:
        rec.pop(k)
    os.makedirs(run, exist_ok=True)
    with open(os.path.join(run, "eval_karras_128.json"), "w") as f:
        json.dump(rec, f)


def test_dose_points_and_their_failures_are_the_references(tmp_path):
    ref = _ref_tool("plot_dose_response")
    for i, budget in enumerate((96000, 32000, 192000)):
        _eval_json(str(tmp_path / f"r{i}"))
    specs = [f"{tmp_path / f'r{i}'}={b}" for i, b in enumerate((96000, 32000, 192000))]
    got = plot_dose_response.load_points(specs)
    assert got == ref.load_points(specs)
    assert [b for b, _ in got] == [32000, 96000, 192000]
    _eval_json(str(tmp_path / "partial"), swd_64=None, swd_avg=None)
    bad = [[str(tmp_path / "r0")],                      # no budget
           [f"{tmp_path / 'nowhere'}=1000"],            # no eval JSON
           [f"{tmp_path / 'partial'}=1000"]]            # level keys missing
    for specs in bad:
        with pytest.raises(SystemExit) as port_err:
            plot_dose_response.load_points(specs)
        with pytest.raises(SystemExit) as ref_err:
            ref.load_points(specs)
        assert str(port_err.value) == str(ref_err.value)


def _colours_in(img, panel):
    """Pixels of a series colour inside a panel's frame."""
    inner = img[panel.top + 1:panel.bottom, panel.left + 1:panel.right].reshape(-1, 1, 3)
    colours = np.array(list(figure.TAB10.values()) + [figure.BLACK], np.uint8)
    return int((inner == colours[None]).all(-1).any(-1).sum())


def _figure(tmp_path, kind):
    """The tool's PNG, its title, and its panels (re-rendered)."""
    out = str(tmp_path / f"{kind}.png")
    if kind == "run":
        _run_history(tmp_path / "run")
        assert plot_run.main([str(tmp_path / "run"), "--out", out]) == 0
        hist = plot_run.load_history(str(tmp_path / "run"))
        return out, "run: losses and FID", plot_run.SIZE_FID, plot_run.render(hist, "")
    if kind == "ladder":
        _ladder(str(tmp_path / "run"))
        assert plot_ladder.main([str(tmp_path / "run"), "--out", out]) == 0
        phases = plot_ladder.load_ladder(str(tmp_path / "run"))
        return (out, "PGGAN progressive ladder 4^2 -> 16^2 (run)", plot_ladder.SIZE,
                plot_ladder.render(phases, ""))
    for i, b in enumerate((32000, 96000)):
        _eval_json(str(tmp_path / f"r{i}"))
    specs = [f"{tmp_path / 'r0'}=32000", f"{tmp_path / 'r1'}=96000"]
    assert plot_dose_response.main(sum((["--run", s] for s in specs), []) + ["--out", out]) == 0
    return (out, plot_dose_response.TITLE, plot_dose_response.SIZE,
            plot_dose_response.render(plot_dose_response.load_points(specs), 600_000))


@pytest.mark.parametrize("kind", ["run", "ladder", "dose"])
def test_figures_decode_with_their_text(tmp_path, kind):
    with contextlib.redirect_stdout(io.StringIO()):
        path, title, size, (img, panels) = _figure(tmp_path, kind)
    decoded, text = codec.decode_rgb(path), codec.png_text(path)
    assert decoded.shape == (*size, 3)
    np.testing.assert_array_equal(decoded, img)
    assert text["Title"] == title
    assert len(text["Description"].splitlines()) == len(panels)
    for p in panels:
        assert _colours_in(img, p["panel"]) > 20, p["title"]
        if "twin" in p:
            assert "IS: tab:green" in text["Description"]
    if kind == "run":  # a title outside Latin-1 goes into an iTXt chunk
        with contextlib.redirect_stdout(io.StringIO()):
            plot_run.main([str(tmp_path / "run"), "--out", path, "--title", "4² → 128²"])
        assert codec.png_text(path)["Title"] == "4² → 128²"
    if kind == "ladder":
        # a rule at each phase's offset (0, 3, 6, ...) in both panels
        offsets = [o for o, _ in plot_ladder.offsets(plot_ladder.load_ladder(
            str(tmp_path / "run")))]
        assert offsets == [0, 3, 6, 9, 12]
        for p in panels:
            panel = p["panel"]
            rows = img[panel.top + 1:panel.bottom]
            cols = [int(np.rint(panel.px(o))) for o in offsets]
            assert p["rules"] == cols
            for col in cols:
                grey = (rows[:, col] == figure.RULE_GREY).all(-1).mean()
                assert grey > 0.8, (col, grey)
            between = (cols[1] + cols[2]) // 2  # no rule between two boundaries
            assert not (rows[:, between] == figure.RULE_GREY).all(-1).any()
    if kind == "dose":
        panel, col = panels[0]["panel"], panels[0]["rule"]
        assert col == int(np.rint(panel.px(600_000)))
        assert (img[panel.top + 1:panel.bottom:3, col] == figure.GREY).all()
        assert "swd_avg" not in text["Description"] and "average: black dashed" in \
            text["Description"]


def test_curves_and_grids_are_unchanged(tmp_path):
    """The ``--curves`` PNGs and a sample grid, byte-equal to what the port
    wrote before ``curve_image`` drew through ``tools/figure.py``."""
    lg = ScalarLogger(str(tmp_path), curves=True)
    with contextlib.redirect_stdout(io.StringIO()):
        for s in range(1, 9):
            lg.log(s, {"d_loss": math.sin(s) + 1.5, "g_loss": float("nan") if s == 4 else s / 3})
            lg.flush(s)
    digest = lambda p: hashlib.sha256(open(p, "rb").read()).hexdigest()
    assert digest(tmp_path / "d_loss.png") == \
        "85332bf01a3b57dfd24ffcbb55bf2ba141442e23f774e35f35b182b8b2cd72df"
    assert digest(tmp_path / "g_loss.png") == \
        "90dcc956043674a519f21c84350f1661b20d9980926d916fdc4c4e7aee3451d3"
    rng = np.random.default_rng(0)
    save_image_grid(rng.uniform(-1, 1, (5, 8, 8, 3)).astype(np.float32), str(tmp_path / "g.png"))
    assert digest(tmp_path / "g.png") == \
        "44c5b455bc28dbb6e637dce0358e57d861286ba2f2a84ce2785c6e17a3c0f8e8"
    assert codec.png_text(str(tmp_path / "g.png")) == {}


def test_doctor_reports_a_cpu_only_machine_without_jax(tmp_path):
    shim = tmp_path / "shim" / "jax"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text("raise ImportError('jax is blocked for this test')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path / "shim"), REPO]))
    proc = subprocess.run([sys.executable, "-m", "gan_lib_tensorflow_tpu_torch.tools.doctor",
                           "--quick", "--probe-timeout", "5"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    report = json.loads(proc.stdout)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert report["verdict"].startswith("no CUDA card: a CPU-only environment")
    assert set(report) == {n for n in doctor.PROBES if n not in doctor.COMPUTE_PROBES} | {
        "verdict", "seconds"}
    assert report["power"]["result"]["nvidia_smi"].startswith("MISSING")
    assert not report["device_enumeration"]["ok"]
    enum = report["device_enumeration"]["result"]
    assert enum is None or enum["card"].startswith("MISSING")  # None: the probe timed out
    assert report["toolchain"]["result"]["nvcc"].startswith("MISSING")
    assert "gan_lib_tensorflow_tpu_torch.cli.north_star" in \
        report["north_star_assets"]["result"]["graded_command"] or \
        report["north_star_assets"]["result"]["graded_command"].startswith("BLOCKED")


def test_a_probe_past_its_time_is_a_timeout_record():
    rec = doctor._sub(["-c", "import time; time.sleep(60)"], 1)
    assert rec["ok"] is False and rec["result"] is None
    assert rec["error"] == "timeout after 1s" and rec["seconds"] < 10


def _verify_commands():
    """``(module, argv)`` of every ``python -m gan_lib_tensorflow_tpu_torch.*``
    in verify_all.sh, ``$OUT`` read as ``/out``."""
    with open(VERIFY) as f:
        text = f.read().replace("\\\n", " ")
    cmds = []
    for line in text.splitlines():
        if line.lstrip().startswith("#"):
            continue
        words = shlex.split(line.split("|")[0].replace('"$OUT', '"/out'))
        for i, w in enumerate(words[:-1]):
            if w == "-m" and words[i + 1].startswith("gan_lib_tensorflow_tpu_torch"):
                argv = []
                for a in words[i + 2:]:  # up to a redirection or the command's end
                    if re.match(r"[<>&;]|then$", a):
                        break
                    argv.append(a.rstrip(";"))
                    if a.endswith(";"):
                        break
                cmds.append((words[i + 1], argv))
    return cmds


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("module,argv", _verify_commands(),
                         ids=lambda v: v if isinstance(v, str) else " ".join(v)[:40])
def test_verify_all_modules_parse_its_flags(module, argv, monkeypatch):
    mod = importlib.import_module(module)
    if module == "gan_lib_tensorflow_tpu_torch.dryrun":
        assert [int(a) for a in argv] == [8] and callable(mod.dryrun_multichip)
        return
    parse = argparse.ArgumentParser.parse_args

    def parse_then_stop(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_then_stop)
    with pytest.raises(_Parsed):
        mod.main(argv)


def test_verify_all_is_bash_and_drives_only_the_port():
    subprocess.run(["bash", "-n", VERIFY], check=True)
    assert os.access(VERIFY, os.X_OK)
    with open(VERIFY) as f:
        text = f.read()
    assert not re.search(r"gan_lib_tensorflow_tpu\.", text)
    assert "bench.py" not in text
    assert text.rstrip().endswith('echo "ALL VERIFICATION DRIVES PASSED"')
    mods = [m for m, _ in _verify_commands()]
    assert mods[0] == "gan_lib_tensorflow_tpu_torch.tools.doctor"
    assert len(mods) == 14 and "gan_lib_tensorflow_tpu_torch.tools.bench_step" in mods


def test_new_modules_import_no_jax_matplotlib_pillow_or_reference():
    code = ("import sys\n"
            + "".join(f"import gan_lib_tensorflow_tpu_torch.tools.{m}\n" for m in NEW_MODULES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
              "'optax', 'orbax', 'matplotlib', 'PIL', 'gan_lib_tensorflow_tpu', "
              "'prepack_dataset', 'prepack_synthetic', 'plot_run', 'plot_ladder', "
              "'plot_dose_response', 'doctor')]\n"
              "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


if __name__ == "__main__" and sys.argv[1:] == ["--digest"]:
    # rewrite the digest of the store phase 20 of chip_smoke.py checks,
    # from the reference tool
    import tempfile
    with open(SYNTH_FIXTURE) as f:
        fixture = json.load(f)
    with tempfile.TemporaryDirectory() as td:
        _ref_prepack(["--out", td] + fixture["flags"])
        fixture["store_digest"] = store_digest(td)
    with open(SYNTH_FIXTURE, "w") as f:
        f.write(json.dumps(fixture) + "\n")
    print(fixture["store_digest"])
