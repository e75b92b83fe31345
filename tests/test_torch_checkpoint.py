"""PyTorch port, checkpoints (``render/checkpoint.py``) on the CPU: the
round trip continues bit for bit for the uniform and the adaptive renderer
(tests/test_viewer_cli.py's contract), a checkpoint written by the JAX
package loads into the port and continues as ``convert`` carries a JAX state
over, one written by the port loads with the JAX package's loaders with
equal fields, and the loaders' errors.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu.render import checkpoint as jck
from cosc_4397_pathtracing_raytracing_project_tpu.render.state import RenderState as JState
from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
    AdaptiveRenderer,
    RenderConfig,
    Renderer,
    convert,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.rng import kernel_seed

from test_render import CORNELL_SMALL

torch.set_num_threads(2)

CFG = dict(trace_depth=3, samples_per_launch=2)


def _renderer(seed=11, text=CORNELL_SMALL):
    return Renderer(parse_scene(text), RenderConfig(**CFG), seed=seed, device="cpu")


def _adaptive(seed=11):
    return AdaptiveRenderer(parse_scene(CORNELL_SMALL), RenderConfig(trace_depth=3),
                            seed=seed, device="cpu")


def test_uniform_round_trip_continues_bit_for_bit(tmp_path):
    a = _renderer()
    a.step(2)
    path = a.save_checkpoint(str(tmp_path / "ckpt"))
    assert path.endswith(".npz") and not (tmp_path / "ckpt.npz.tmp.npz").exists()
    b = _renderer()
    b.load_checkpoint(path)
    assert b.iteration == 2 and b.state.seed == a.state.seed
    a.step(2)
    b.step(2)
    assert torch.equal(a.state.accum, b.state.accum)


def test_adaptive_round_trip_continues_bit_for_bit(tmp_path):
    a = _adaptive()
    a.render(8, round_spp=4)
    path = a.save_checkpoint(str(tmp_path / "ada"))
    b = _adaptive()
    b.load_checkpoint(path)
    assert b.avg_spp == a.avg_spp and b._lane_budget_spent == a._lane_budget_spent
    a.refine(4)
    b.refine(4)
    for name in ("_acc_a", "_acc_b", "_counts"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("seed", [11, -5, 2**31 + 3])
def test_jax_checkpoint_loads_into_the_port(tmp_path, seed):
    """A JAX RenderState written by the JAX package: the port's renderer
    holds what convert.state_from_jax_arrays makes of it, and continues
    from it bit for bit as a renderer given that state does."""
    accum = np.random.default_rng(seed & 0xFFFF).uniform(0, 2, (64 * 64, 3)).astype(np.float32)
    js = JState.create(64 * 64, seed).replace(accum=jnp.asarray(accum),
                                              iteration=jnp.asarray(6, jnp.int32))
    path = jck.save_checkpoint(str(tmp_path / "jax"), js, {"from": "jax"})
    r = _renderer(seed=0).load_checkpoint(path)
    want = convert.state_from_jax_arrays(accum, 6, np.asarray(jax.random.key_data(js.key)), "cpu")
    assert r.iteration == 6 and r.state.iteration == 6
    assert r.state.seed == want.seed == kernel_seed(seed)
    assert torch.equal(r.state.accum, want.accum)
    other = _renderer(seed=0)
    other.state, other._host_iteration = want, 6
    r.step(2)
    other.step(2)
    assert torch.equal(r.state.accum, other.state.accum)


def test_port_checkpoint_loads_into_jax(tmp_path):
    r = _renderer(seed=-5)
    r.step(2)
    state, meta = jck.load_checkpoint(r.save_checkpoint(str(tmp_path / "port")))
    np.testing.assert_array_equal(np.asarray(state.accum), r.state.accum.numpy())
    assert int(state.iteration) == 2 and meta["resolution"] == [64, 64]
    np.testing.assert_array_equal(np.asarray(state.key),
                                  np.asarray(jax.random.key_data(jax.random.PRNGKey(-5))))


def test_adaptive_checkpoints_cross_both_ways(tmp_path):
    a = _adaptive(seed=-5)
    a.render(8, round_spp=4)
    state, meta = jck.load_adaptive_checkpoint(a.save_checkpoint(str(tmp_path / "port")))
    for name in ("acc_a", "acc_b", "counts"):
        np.testing.assert_array_equal(np.asarray(state[name]), getattr(a, "_" + name).numpy())
    assert int(state["seed"]) == -5 and state["budget_spent"] == a._lane_budget_spent
    assert meta["num_tiles"] == a.num_tiles
    # the JAX package's writer, from the same arrays, loads into the port
    fields = {"_" + k: np.asarray(v) for k, v in state.items() if k != "budget_spent"}
    jax_like = types.SimpleNamespace(_lane_budget_spent=state["budget_spent"], **fields)
    b = _adaptive(seed=0).load_checkpoint(jck.save_adaptive_checkpoint(str(tmp_path / "jax"),
                                                                       jax_like))
    assert b._seed == a._seed and b._lane_budget_spent == a._lane_budget_spent
    for name in ("_acc_a", "_acc_b", "_counts"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _write(path, **fields):
    base = dict(version=np.int32(1), accum=np.zeros((64 * 64, 3), np.float32),
                iteration=np.int32(2), key=np.array([0, 11], np.uint32), meta="{}")
    base.update(fields)
    np.savez(path, **base)
    return str(path)


@pytest.mark.parametrize("case", ["resolution", "adaptive-as-uniform", "uniform-as-adaptive",
                                  "key-high-word", "newer-version"])
def test_checkpoint_errors(tmp_path, case):
    path = tmp_path / "c.npz"
    if case == "resolution":
        r = _renderer()
        r.step(2)
        half = CORNELL_SMALL.replace("RES 64 64", "RES 64 32")
        with pytest.raises(ValueError, match="resolution"):
            _renderer(text=half).load_checkpoint(r.save_checkpoint(str(path)))
    elif case == "adaptive-as-uniform":
        a = _adaptive()
        a.warmup(4)
        with pytest.raises(ValueError, match="adaptive-sampling checkpoint"):
            _renderer().load_checkpoint(a.save_checkpoint(str(path)))
    elif case == "uniform-as-adaptive":
        with pytest.raises(ValueError, match="uniform-render checkpoint"):
            _adaptive().load_checkpoint(_write(path))
    elif case == "key-high-word":
        with pytest.raises(ValueError, match="32-bit seed"):
            _renderer().load_checkpoint(_write(path, key=np.array([1, 11], np.uint32)))
    else:
        with pytest.raises(ValueError, match="newer"):
            _renderer().load_checkpoint(_write(path, version=np.int32(2)))
