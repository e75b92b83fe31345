"""PyTorch port, the single-device entry point (``entry.py``) on the CPU:
``entry(device="cpu", resolution=(64, 64))`` against the JAX package's
``render_chunk`` on ``__graft_entry__._cornell_desc((64, 64))`` in the
configuration of ``__graft_entry__.entry`` (one sample, sobol, the scene's
depth 8, seed 0); the key helpers ``render_key``, ``ld_bounce0_uniforms``
and ``ld_nee0_uniforms`` bit for bit against JAX's; the entry and native
modules import no jax; ``entry()`` raises without a card.

Tolerance: the ROADMAP bound against the JAX package, at most 0.5% of
pixels with a max-channel |Δ| above 1e-3 and channel means within 0.5%.
Both sides take their fast pipeline (the SoA wavefront) here.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu.ops import rng as jrng
from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import (
    render_chunk as jrender_chunk,
)
from cosc_4397_pathtracing_raytracing_project_tpu.render.state import RenderState as JState
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu_torch import entry as tentry
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import rng as trng

from test_torch_cuda import assert_within_oracle_tolerance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__ as graft  # noqa: E402

torch.set_num_threads(2)

RES = (64, 64)
SEEDS = [0, 1, 12345, 2**31 - 1, -1]


def test_entry_matches_jax_render_chunk():
    fn, (scene, state) = tentry.entry(device="cpu", resolution=RES)
    assert fn.keywords["num_samples"] == 1
    config = fn.keywords["config"]
    assert (config.sampler, config.samples_per_launch, config.trace_depth) == ("sobol", 1, 8)
    assert config.resolve_pipeline(scene) == "pallas"  # taken by the SoA wavefront per sample
    out = fn(scene, state)
    assert out.iteration == 1 and state.iteration == 0
    assert out.accum.device.type == "cpu" and out.accum.shape == (RES[0] * RES[1], 3)

    desc = graft._cornell_desc(RES)
    jscene = JScene.from_desc(desc)
    jstate = JState.create(jscene.camera.pixel_count, seed=0)
    jconfig = JConfig(trace_depth=desc.trace_depth, samples_per_launch=1, sampler="sobol")
    want = jrender_chunk(jscene, jstate, jconfig, 1)
    assert int(want.iteration) == 1
    assert_within_oracle_tolerance(out.accum.numpy(), np.asarray(want.accum))


def test_entry_default_resolution_is_the_scene_file():
    desc = tentry._cornell_desc()
    assert desc.camera.resolution == graft._cornell_desc().camera.resolution == (800, 800)
    assert tentry._cornell_desc(RES).camera.resolution == RES


@pytest.mark.parametrize("seed", SEEDS)
def test_render_key_matches_jax(seed):
    got = trng.render_key(seed)
    want = np.asarray(jax.random.key_data(jrng.render_key(seed))).astype(np.int64)
    np.testing.assert_array_equal([int(got[0]), int(got[1])], want)
    # a key stays the key it is
    key = trng.fold_in(got, 5)
    assert [int(k) for k in trng.render_key(key)] == [int(k) for k in key]


@pytest.mark.parametrize("seed", SEEDS)
def test_depth0_ld_uniforms_match_jax(seed):
    pix = np.random.default_rng(5).integers(0, 800 * 800, 512).astype(np.uint32)
    jkey = jrng.render_key(seed)
    for it in (1, 2, 37, 2**20 + 7):
        got = trng.ld_bounce0_uniforms(seed, it, torch.as_tensor(pix.astype(np.int64)))
        want = np.asarray(jrng.ld_bounce0_uniforms(jkey, jnp.int32(it), jnp.asarray(pix)))
        assert got.dtype == torch.float32 and got.shape == want.shape == (5, 512)
        np.testing.assert_array_equal(got.numpy(), want)
        got = trng.ld_nee0_uniforms(seed, it, torch.as_tensor(pix.astype(np.int64)))
        want = np.asarray(jrng.ld_nee0_uniforms(jkey, jnp.int32(it), jnp.asarray(pix)))
        assert got.shape == want.shape == (512, 3)
        np.testing.assert_array_equal(got.numpy(), want)


def test_entry_and_native_import_no_jax(tmp_path):
    code = (
        "import sys\n"
        "from cosc_4397_pathtracing_raytracing_project_tpu_torch import entry\n"
        "from cosc_4397_pathtracing_raytracing_project_tpu_torch.native import runtime\n"
        "fn, args = entry.entry(device='cpu', resolution=(8, 8))\n"
        "assert fn(*args).iteration == 1\n"
        "assert runtime.available()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('cosc_4397_pathtracing_raytracing_project_tpu.')\n"
        "       or m == 'cosc_4397_pathtracing_raytracing_project_tpu']\n"
        "assert not bad, bad\n"
        "print('no jax')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry(device="cuda", resolution=RES)
