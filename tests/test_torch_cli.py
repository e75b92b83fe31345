"""PyTorch port, the command line (``utils/cli.py``) on the CPU: the headless
run with ``--checkpoint``, ``--resume``, ``--hdr`` and ``--denoise``
(tests/test_viewer_cli.py's), the adaptive path, the port's CLI against the
JAX package's on the same model, every ``rc 2`` error, the option set, the
default device without a card, and the entry point without jax.

The port's and the JAX package's ``--model naive`` runs take the same
readable pipeline on both sides; their PNGs are held to 1 LSB on at least
99.5% of pixels (the ROADMAP's share). Measured (``pytest -s``): bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu.utils import cli as jcli
from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import read_png
from cosc_4397_pathtracing_raytracing_project_tpu_torch.utils import cli

from test_render import CORNELL_SMALL

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture
def scene_path(tmp_path):
    path = tmp_path / "scene.txt"
    path.write_text(CORNELL_SMALL)
    return str(path)


def test_cli_headless(tmp_path, scene_path):
    out, ckpt = tmp_path / "out.png", tmp_path / "ck.npz"
    rc = cli.main([scene_path, "--device", "cpu", "--depth", "3", "--iterations", "4",
                   "--chunk", "2", "--output", str(out), "--checkpoint", str(ckpt), "--quiet"])
    assert rc == 0 and out.exists() and ckpt.exists()
    assert read_png(str(out)).shape == (64, 64, 3)
    # resume, with the HDR and the denoised PNG
    out2 = tmp_path / "out2.png"
    rc = cli.main([scene_path, "--device", "cpu", "--depth", "3", "--iterations", "6",
                   "--chunk", "2", "--resume", str(ckpt), "--hdr", "--denoise",
                   "--output", str(out2), "--checkpoint", str(tmp_path / "ck2"), "--quiet"])
    assert rc == 0 and out2.exists() and (tmp_path / "out2.hdr").exists()
    with np.load(tmp_path / "ck2.npz") as data:
        assert int(data["iteration"]) == 6


def test_cli_adaptive(tmp_path, scene_path, capsys):
    ckpt = tmp_path / "ada"
    rc = cli.main([scene_path, "--device", "cpu", "--depth", "3", "--adaptive",
                   "--iterations", "8", "--adaptive-round", "4", "--denoise",
                   "--output", str(tmp_path / "a.png"), "--checkpoint", str(ckpt)])
    assert rc == 0 and "adaptive:" in capsys.readouterr().out
    with np.load(str(ckpt) + ".npz") as data:
        assert {"acc_a", "acc_b", "counts", "seed", "budget_spent"} <= set(data.files)
    rc = cli.main([scene_path, "--device", "cpu", "--depth", "3", "--adaptive",
                   "--iterations", "12", "--adaptive-round", "4", "--resume", str(ckpt) + ".npz",
                   "--output", str(tmp_path / "b.png"), "--quiet"])
    assert rc == 0


def test_cli_matches_jax_cli(tmp_path, scene_path):
    """``--model naive`` (the readable pipeline on both sides), depth 3, 2
    samples one launch each: the PNGs within 1 LSB on ≥ 99.5% of pixels."""
    args = [scene_path, "--model", "naive", "--depth", "3", "--iterations", "2",
            "--chunk", "1", "--quiet"]
    assert jcli.main(args + ["--output", str(tmp_path / "jax.png")]) == 0
    assert cli.main(args + ["--device", "cpu", "--output", str(tmp_path / "port.png")]) == 0
    want = read_png(str(tmp_path / "jax.png")).astype(np.int32)
    got = read_png(str(tmp_path / "port.png")).astype(np.int32)
    within = (np.abs(got - want).max(axis=-1) <= 1).mean()
    print(f"CLI vs JAX CLI: share within 1 LSB {within:.5f}, bit-identical "
          f"{float((got == want).all(axis=-1).mean()):.5f}")
    assert within >= 0.995 and got.max() > 0


@pytest.mark.parametrize("flags,message", [
    (["--env-strength", "2"], "--env-strength needs --envmap"),
    (["--nee", "--estimator", "throughput"], "--nee needs the light_only estimator"),
    (["--nee", "--model", "wavefront"], "--nee is not supported with --model wavefront"),
    (["--adaptive", "--model", "naive"], "--adaptive runs its own"),
    (["--adaptive", "--serve"], "--adaptive is headless-only"),
], ids=["env-strength", "nee-throughput", "nee-wavefront", "adaptive-model", "adaptive-serve"])
def test_cli_errors(scene_path, capsys, flags, message):
    assert cli.main([scene_path, "--device", "cpu"] + flags) == 2
    assert message in capsys.readouterr().err


def test_parser_has_the_jax_options_and_device():
    """The same options, defaults and choices as the JAX parser, plus
    --device (default cuda)."""
    port, jax_parser = cli.build_parser(), jcli.build_parser()

    def options(p):
        return {a.dest: (a.option_strings, a.default, a.choices, a.help)
                for a in p._actions if a.dest != "help"}

    got, want = options(port), options(jax_parser)
    assert set(got) == set(want) | {"device"}
    assert got.pop("device")[1] == "cuda"
    for dest, (flags, default, choices, _) in want.items():
        assert got[dest][:3] == (flags, default, choices), dest
    assert port.prog == "cosc_4397_pathtracing_raytracing_project_tpu_torch"


def test_default_device_needs_a_card(scene_path, monkeypatch):
    """Without a card the default device fails with the Renderer's
    RuntimeError; it never renders on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([scene_path, "--iterations", "1", "--quiet"])


def test_entry_point_imports_no_jax(tmp_path, scene_path):
    """``python -m`` of the port in a fresh interpreter, with its command
    line's modules imported: the render runs and jax is never imported."""
    code = (
        "import sys, runpy\n"
        "import cosc_4397_pathtracing_raytracing_project_tpu_torch.utils.cli\n"
        "import cosc_4397_pathtracing_raytracing_project_tpu_torch.viewer.server\n"
        "import cosc_4397_pathtracing_raytracing_project_tpu_torch.render.denoise\n"
        "import cosc_4397_pathtracing_raytracing_project_tpu_torch.render.checkpoint\n"
        "import cosc_4397_pathtracing_raytracing_project_tpu_torch.render.profiling\n"
        "import cosc_4397_pathtracing_raytracing_project_tpu_torch.utils.debug\n"
        f"sys.argv = ['x', {scene_path!r}, '--device', 'cpu', '--depth', '1',\n"
        "            '--iterations', '1', '--quiet',\n"
        f"            '--output', {str(tmp_path / 'e.png')!r}]\n"
        "try:\n"
        "    runpy.run_module('cosc_4397_pathtracing_raytracing_project_tpu_torch',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('no jax')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout and (tmp_path / "e.png").exists()
