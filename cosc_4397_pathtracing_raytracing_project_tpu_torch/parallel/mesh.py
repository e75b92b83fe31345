"""Device meshes for multi-device rendering, one process per rank.

Port of the JAX package's ``parallel/mesh.py``. A rank is a process that has
joined a ``torch.distributed`` process group (:func:`start_rank`, or
:func:`spawn_ranks`, which starts the processes); the ranks form a
``DeviceMesh`` with dims ``('sp', 'dp')``, in the JAX order:

- ``dp`` shards the *pixel* dimension: each rank owns a contiguous slice of
  the flat pixel array (:func:`pixel_sharding`); the scene is tiny and every
  rank holds all of it (:func:`replicated`);
- ``sp`` parallelizes *samples* for the same pixels: the ranks' partial
  accumulators are summed by one all-reduce over the ``sp`` group (JAX's
  ``psum``, :func:`sum_over_samples`).

Paths are independent, so no halo exchange is ever needed. Where the JAX
package gathers the frame implicitly when the host reads pixels, the port
gathers it explicitly (:func:`gather_pixels`).

No fallback: the caller names the backend (``"nccl"``, or ``"gloo"`` for
ranks that share a card or run on the CPU) and the ranks' device. A failed
NCCL start is never retried on gloo, nothing moves to the CPU because it
found no card, and a rank that raises, exits non-zero or outlives its
timeout fails the whole run (:func:`spawn_ranks`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import multiprocessing
import os
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

SAMPLE_AXIS = "sp"
PIXEL_AXIS = "dp"
BACKENDS = ("nccl", "gloo")

# the device this process's rank renders on (start_rank)
_RANK_DEVICE: Optional[torch.device] = None


def start_rank(backend: str, rank: int, world_size: int, rendezvous: str, device,
               timeout: float = 600.0) -> torch.device:
    """Join the process group of ``world_size`` ranks as ``rank`` and make
    ``device`` this process's device. ``rendezvous`` is a file path that
    every rank names (a ``FileStore``: no port to collide with another
    group's); ``backend`` is ``"nccl"`` (ranks on CUDA devices of their own)
    or ``"gloo"`` (ranks that share a card, or run on the CPU). Collectives
    give up after ``timeout`` seconds. Returns the device."""
    global _RANK_DEVICE
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl needs a CUDA device, got {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the context, before the mesh looks for it
    dist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=timeout))
    _RANK_DEVICE = device
    return device


def rank_device() -> torch.device:
    """This rank's device (:func:`start_rank`)."""
    if _RANK_DEVICE is None:
        raise RuntimeError("this process has not started a rank (start_rank)")
    return _RANK_DEVICE


def make_mesh(num_devices: Optional[int] = None, sample_parallel: int = 1):
    """A ``('sp', 'dp')`` ``DeviceMesh`` over the process group's
    ``num_devices`` ranks (all of them by default) with ``sample_parallel``
    ranks along the sample axis. Every rank calls it, in the same order."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group (start_rank)")
    world = dist.get_world_size()
    if num_devices is None:
        num_devices = world
    if sample_parallel < 1 or num_devices % sample_parallel != 0:
        raise ValueError(f"num_devices={num_devices} not divisible by sp={sample_parallel}")
    if num_devices != world:
        raise ValueError(f"a mesh spans every rank: num_devices={num_devices}, "
                         f"world size {world}")
    return init_device_mesh(rank_device().type, (sample_parallel, num_devices // sample_parallel),
                            mesh_dim_names=(SAMPLE_AXIS, PIXEL_AXIS))


def mesh_coords(mesh) -> Tuple[int, int]:
    """This rank's ``(sp, dp)`` coordinates in the mesh."""
    return mesh.get_local_rank(SAMPLE_AXIS), mesh.get_local_rank(PIXEL_AXIS)


def pixel_sharding(mesh, num_pixels: int) -> Tuple[int, int]:
    """This rank's ``(offset, count)`` of the flat pixel array: pixels split
    in contiguous slices over ``dp``, the same slice on every ``sp`` rank
    (JAX's ``P('dp', None)``)."""
    n_dp = mesh.size(1)
    if num_pixels % n_dp != 0:
        raise ValueError(f"pixel count {num_pixels} not divisible by dp={n_dp}")
    local = num_pixels // n_dp
    return mesh_coords(mesh)[1] * local, local


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors of a scene's dataclass tree, in field order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    return []


def replicated(mesh, scene):
    """The scene as every rank of ``mesh`` holds it (JAX's replicated
    sharding): a path or a ``SceneDesc`` is built on this rank's device,
    and a ``Scene`` must lie there. Raises unless every rank holds the same
    scene (a digest of its tensors, compared over the mesh)."""
    from ..scene.parser import load_scene_desc
    from ..scene.structs import Scene, SceneDesc

    device = rank_device()
    if isinstance(scene, str):
        scene = load_scene_desc(scene)
    if isinstance(scene, SceneDesc):
        scene = Scene.from_desc(scene, device)
    if scene.device != device:
        raise ValueError(f"scene lives on {scene.device}, the rank on {device}")
    digest = hashlib.sha256()
    for t in _tensors(scene):
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    words = torch.tensor(list(digest.digest()[:8]), dtype=torch.int64, device=device)
    if any(not torch.equal(w, words) for w in _all_gather(words, None)):
        raise ValueError("the ranks hold different scenes")
    return scene


def _all_gather(local: torch.Tensor, group) -> List[torch.Tensor]:
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    return parts


def sum_over_samples(mesh, partial: torch.Tensor) -> torch.Tensor:
    """The sum of the ``sp`` ranks' partial accumulators (JAX's ``psum`` over
    ``'sp'``), in place; with one ``sp`` rank, ``partial`` as it is."""
    if mesh.size(0) > 1:
        dist.all_reduce(partial, group=mesh.get_group(SAMPLE_AXIS))
    return partial


def gather_pixels(mesh, local: torch.Tensor) -> torch.Tensor:
    """The full frame from every ``dp`` rank's pixel slice, in pixel order,
    on every rank (the gather JAX makes when the host reads a sharded
    accumulator)."""
    if mesh.size(1) == 1:
        return local
    return torch.cat(_all_gather(local, mesh.get_group(PIXEL_AXIS)))


def gather_mesh(mesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's ``local`` rows, concatenated in the mesh's flattened
    ``('sp', 'dp')`` order (JAX's ``P(('sp', 'dp'))``), on every rank."""
    parts = _all_gather(local, None)
    return torch.cat([parts[r] for r in mesh.mesh.flatten().tolist()])


# ───────────────────────────── rank processes ─────────────────────────────


def _rank_main(fn, rank, world_size, backend, device, rendezvous, out_dir, args, timeout):
    """A rank process: start the rank, run ``fn(*args)``, save its result
    (or the traceback) under ``out_dir``; exits non-zero if ``fn`` raised."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        start_rank(backend, rank, world_size, rendezvous, device, timeout)
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, backend: str, device,
                args: Sequence = (), timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` rank processes (the ``spawn``
    start method: CUDA cannot fork) that have joined one process group over
    ``backend`` on ``device`` (all ranks on the one device), and return
    each rank's result, in rank order. ``fn`` must be importable by name
    (a module-level function) and its result something ``torch.save``
    takes. A rank that raises or exits non-zero fails the run at once
    (RuntimeError, with its traceback; the other ranks are stopped), and so
    does a run that outlives ``timeout`` seconds (TimeoutError). Every
    process started here has ended when this returns or raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pt_ranks_") as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        procs = [
            ctx.Process(target=_rank_main, args=(fn, rank, world_size, backend, str(device),
                                                 rendezvous, tmp, tuple(args), timeout),
                        name=f"rank{rank}")
            for rank in range(world_size)
        ]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            while any(p.exitcode is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(_failure(tmp, procs, failed))
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after {timeout} s: "
                                       f"{[r for r, p in enumerate(procs) if p.is_alive()]}")
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                raise RuntimeError(_failure(tmp, procs, failed))
            return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                    for r in range(world_size)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                if p.pid is not None:
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                        p.join()


def _failure(tmp: str, procs, failed: List[int]) -> str:
    """The failed ranks' exit codes and the tracebacks of every rank that
    wrote one (the rank that raised first may still be exiting when a peer
    it left behind fails)."""
    lines = []
    for r, p in enumerate(procs):
        err = os.path.join(tmp, f"rank{r}.err")
        if r in failed or os.path.exists(err):
            text = open(err).read() if os.path.exists(err) else "(no traceback)"
            lines.append(f"rank {r} exited with code {p.exitcode}:\n{text}")
    return "\n".join(lines)
