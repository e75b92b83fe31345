"""The multi-device dry run, and the rank bodies that drive the sharded paths.

:func:`dryrun_multichip` starts ``n`` rank processes (:func:`.mesh.spawn_ranks`)
and runs one tiny step of every sharded path on their ``('sp', 'dp')`` mesh:
the eager per-sample step (XLA's counterpart in the JAX package), the
megakernel with ``sampler='sobol'``, the triangle-mesh pipeline, and the
adaptive tile dispatch with trash-tile padding. It returns each path's mean
and time; the counterpart of the JAX package's ``dryrun_multichip``.

:func:`run_cases` is a rank body that runs a list of cases on one mesh,
for callers that check the sharded paths against a single device (the
tests, ``chip_smoke.py``): ``{"kind": "step", ...}`` renders through a
sharded step (:func:`step_case`), ``{"kind": "adaptive", ...}`` through
``AdaptiveRenderer(mesh=...)`` (:func:`adaptive_case`), ``{"kind":
"mesh", ...}`` builds meshes (:func:`mesh_case`). Rank 0 returns the
tensors; every rank returns their digests, so a caller can check that all
ranks hold the same data.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops.cuda import build, megakernel, mesh_kernel
from ..render.adaptive import AdaptiveRenderer
from ..render.engine import RenderConfig
from ..render.state import RenderState
from ..scene import transforms
from ..scene.parser import load_scene_desc
from ..scene.structs import CameraDesc, SceneDesc
from . import mesh as mesh_ops
from . import shard

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scenes")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (on the host)."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _reset_counts() -> None:
    megakernel.KERNEL.reset_counts()
    mesh_kernel.KERNEL.reset_counts()


def _counts() -> dict:
    """This rank's kernel launches since :func:`_reset_counts`: the
    megakernel's by variant, its row kernel's, the mesh kernel's by mode."""
    return dict(megakernel=dict(megakernel.KERNEL.launches_by_variant),
                rows=megakernel.KERNEL.row_launches,
                mesh=dict(mesh_kernel.KERNEL.launches_by_mode))


def scene_desc(spec) -> SceneDesc:
    """A SceneDesc from a path (relative paths under ``scenes/``) or a
    SceneDesc, with camera overrides when ``spec`` is a dict ``{"scene":
    ..., "resolution": (w, h), "aperture": a, "focal": f}``."""
    over = {}
    if isinstance(spec, dict):
        over, spec = spec, spec["scene"]
    if isinstance(spec, str):
        spec = load_scene_desc(spec if os.path.isabs(spec) else os.path.join(SCENES, spec))
    desc = dataclasses.replace(spec, camera=dataclasses.replace(spec.camera))
    if over.get("resolution") is not None:
        desc.camera.resolution = tuple(over["resolution"])
    for field in ("aperture", "focal"):
        if over.get(field) is not None:
            setattr(desc.camera, field, float(over[field]))
    return desc


def step_case(mesh, case: dict) -> dict:
    """One sharded step: ``pipeline`` ``"fast"`` (:func:`shard.make_sharded_step`),
    ``"pallas"`` (the megakernel) or ``"mesh"``, on ``scene`` (see
    :func:`scene_desc`) with ``config``, ``samples`` samples from a fresh
    state of ``seed``, after ``warmup`` untimed steps (default 0). Returns
    the gathered frame (rank 0), its digest, the rank's slice rows, its
    pixel offset and first hash tile, the iteration, the step's seconds
    (host clock, the device synchronised) and the rank's kernel launches
    in the step (counts set to 0 just before it)."""
    device = mesh_ops.rank_device()
    scene = mesh_ops.replicated(mesh, scene_desc(case["scene"]))
    config, samples = case["config"], case["samples"]
    make = {"fast": shard.make_sharded_step, "pallas": shard.make_sharded_pallas_step,
            "mesh": shard.make_sharded_mesh_step}[case["pipeline"]]
    step = make(scene, config, samples, mesh)
    fresh = lambda: RenderState.create(scene.camera.pixel_count, case.get("seed", 0),  # noqa: E731
                                       device)
    for _ in range(case.get("warmup", 0)):
        step(scene, fresh())
    _sync(device)
    _reset_counts()
    t0 = time.perf_counter()
    out = step(scene, fresh())
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = _counts()
    frame = mesh_ops.gather_pixels(mesh, out.accum)
    offset, local = mesh_ops.pixel_sharding(mesh, scene.camera.pixel_count)
    return dict(
        accum=frame.cpu() if dist.get_rank() == 0 else None, digest=digest(frame),
        local_rows=int(out.accum.shape[0]), offset=offset,
        tile_base=shard.shard_tile_base(local, mesh_ops.mesh_coords(mesh)[1]),
        iteration=int(out.iteration), seconds=seconds, launches=launches,
    )


def adaptive_case(mesh, case: dict) -> dict:
    """``AdaptiveRenderer(scene, config, seed, mesh=mesh)``: ``warmup(w)``,
    then ``refine(spp, frac)`` for each of ``rounds``. Returns the two
    half-buffers, the counts and the linear image (rank 0), every
    selection, the digests of the buffers and counts, the lanes × samples
    dispatched, the seconds (host clock, the device synchronised) and the
    rank's kernel launches."""
    device = mesh_ops.rank_device()
    scene = mesh_ops.replicated(mesh, scene_desc(case["scene"]))
    _sync(device)
    _reset_counts()
    t0 = time.perf_counter()
    r = AdaptiveRenderer(scene, case["config"], seed=case.get("seed", 0), device=device,
                         mesh=mesh)
    r.warmup(case["warmup"])
    sels = [r.refine(spp, frac).cpu() for spp, frac in case["rounds"]]
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = _counts()
    state = (r._acc_a, r._acc_b, r._counts)
    first = dist.get_rank() == 0
    return dict(
        acc_a=state[0].cpu() if first else None, acc_b=state[1].cpu() if first else None,
        counts=state[2].cpu() if first else None,
        image=r.linear_image() if first else None, selections=sels,
        digest=[digest(t) for t in state], lanes=r._lane_budget_spent, seconds=seconds,
        launches=launches,
    )


def mesh_case(mesh, case: dict) -> dict:
    """Meshes of ``sample_parallel`` in ``good`` (their sizes and this
    rank's coordinates and pixel slice of ``pixels``), and whether
    ``make_mesh`` raises ValueError for each of ``bad``."""
    del mesh
    made = []
    for sp in case["good"]:
        m = mesh_ops.make_mesh(sample_parallel=sp)
        made.append(dict(sizes=(m.size(0), m.size(1)), names=m.mesh_dim_names,
                         coords=mesh_ops.mesh_coords(m),
                         slice=mesh_ops.pixel_sharding(m, case["pixels"])))
    raised = []
    for sp in case["bad"]:
        try:
            mesh_ops.make_mesh(sample_parallel=sp)
            raised.append(False)
        except ValueError:
            raised.append(True)
    return dict(made=made, raised=raised)


def fail_case(mesh, case: dict) -> dict:
    """Rank ``rank`` raises; the others wait in a collective for it (the
    caller must stop them)."""
    if dist.get_rank() == case["rank"]:
        raise RuntimeError(f"rank {case['rank']} fails on purpose")
    dist.barrier()
    return {}


CASES = {"step": step_case, "adaptive": adaptive_case, "mesh": mesh_case, "fail": fail_case}


def run_cases(sample_parallel: int, cases: list) -> list:
    """Rank body: make the ``('sp', 'dp')`` mesh of ``sample_parallel`` sp
    ranks, then run each case (a dict whose ``kind`` names its function in
    :data:`CASES`, and whose ``sp`` overrides ``sample_parallel``) in
    order; returns their results."""
    meshes = {}
    results = []
    for case in cases:
        sp = case.get("sp", sample_parallel)
        if sp not in meshes:
            meshes[sp] = mesh_ops.make_mesh(sample_parallel=sp)
        results.append(CASES[case["kind"]](meshes[sp], case))
    return results


def build_kernels(device) -> None:
    """Build the kernels the sharded paths launch on a CUDA ``device``
    before ranks start, so the ranks only load them."""
    if torch.device(device).type == "cuda":
        for kernel in (megakernel.KERNEL, mesh_kernel.KERNEL):
            build.build(kernel.name, kernel.flags)


# ─────────────────────────────── the dry run ───────────────────────────────


def tiny_tri_desc() -> SceneDesc:
    """A minimal triangle scene (an emissive slab over an 8-triangle floor,
    32×32) for the mesh pipeline's leg."""
    tf, inv, invt = transforms.geom_matrices([0, 4, 0], [0, 0, 0], [2, 0.2, 2])
    xs = np.linspace(-4, 4, 3)
    verts = []
    for i in range(2):
        for j in range(2):
            a, b = [xs[i], 0, xs[j]], [xs[i + 1], 0, xs[j]]
            c, d = [xs[i], 0, xs[j + 1]], [xs[i + 1], 0, xs[j + 1]]
            verts += [[a, b, c], [b, d, c]]
    tri = np.asarray(verts, np.float32)
    return SceneDesc(
        geom_type=np.array([0], np.int32),
        material_id=np.array([0], np.int32),
        translation=np.array([[0, 4, 0]], np.float32),
        rotation=np.zeros((1, 3), np.float32),
        scale=np.array([[2, 0.2, 2]], np.float32),
        transform=tf[None],
        inv_transform=inv[None],
        inv_transpose=invt[None],
        color=np.array([[1, 1, 1], [0.7, 0.5, 0.3]], np.float32),
        specular_exponent=np.zeros(2, np.float32),
        specular_color=np.zeros((2, 3), np.float32),
        reflectivity=np.zeros(2, np.float32),
        refractive=np.zeros(2, np.float32),
        ior=np.zeros(2, np.float32),
        emittance=np.array([5, 0], np.float32),
        camera=CameraDesc((32, 32), 45.0, np.array([0, 2.5, 9.0]),
                          np.array([0, 1.5, 0.0]), np.array([0, 1, 0.0])),
        tri_vertices=tri,
        tri_material_id=np.full(len(tri), 1, np.int32),
    )


def _check_frame(what: str, frame: torch.Tensor, pixels: int) -> float:
    if tuple(frame.shape) != (pixels, 3):
        raise AssertionError(f"{what}: frame {tuple(frame.shape)}, expected ({pixels}, 3)")
    if not bool(torch.isfinite(frame).all()) or not float(frame.max()) > 0.0:
        raise AssertionError(f"{what}: frame is not finite or is black")
    return float(frame.mean())


def _dryrun_rank() -> dict:
    """One tiny step of every sharded path on this rank (32×32 frames,
    depth 2, one sample per sp rank)."""
    world = dist.get_world_size()
    sp = 2 if world % 2 == 0 else 1
    mesh = mesh_ops.make_mesh(sample_parallel=sp)
    config = RenderConfig(trace_depth=2)
    times, means = {}, {}
    legs = (("xla", "fast", "cornell.txt", config),
            ("megakernel(sobol)", "pallas", "cornell.txt",
             dataclasses.replace(config, sampler="sobol")),
            ("mesh", "mesh", tiny_tri_desc(), config))
    for name, pipeline, scene, cfg in legs:
        t0 = time.perf_counter()
        out = step_case(mesh, dict(pipeline=pipeline, config=cfg, samples=sp,
                                   scene=dict(scene=scene, resolution=(32, 32))))
        if out["iteration"] != sp:
            raise AssertionError(f"{name}: iteration {out['iteration']}, expected {sp}")
        if dist.get_rank() == 0:
            means[name] = _check_frame(name, out["accum"], 32 * 32)
        times[name] = time.perf_counter() - t0
    # the adaptive leg: a 64×96 frame is 3 tiles, so a mesh whose quantum
    # does not divide 3 (4 ranks: quantum 2) pads its dispatches with the
    # trash tile
    t0 = time.perf_counter()
    out = adaptive_case(mesh, dict(scene=dict(scene="cornell.txt", resolution=(64, 96)),
                                   config=config, warmup=1, rounds=[(1, 1.0)]))
    if dist.get_rank() == 0:
        img = torch.from_numpy(np.ascontiguousarray(out["image"])).reshape(-1, 3)
        means["adaptive"] = _check_frame("adaptive", img, 64 * 96)
    times["adaptive"] = time.perf_counter() - t0
    return dict(sp=sp, dp=world // sp, samples=sp, means=means, seconds=times)


def dryrun_multichip(n_devices: int, backend: str = "gloo", device="cpu",
                     timeout: float = 600.0) -> dict:
    """Start ``n_devices`` ranks over ``backend`` on ``device`` (all of them
    on that one device: ``"gloo"`` for ranks that share a card or the CPU)
    and run one tiny step of every sharded path on their mesh (sp = 2 for
    an even rank count, else 1): the eager step, the megakernel with
    ``sampler='sobol'``, the triangle-mesh pipeline and the adaptive tile
    dispatch. Prints one line and returns rank 0's means and seconds by
    path. Any failure of any rank raises."""
    build_kernels(device)
    t0 = time.perf_counter()
    out = mesh_ops.spawn_ranks(_dryrun_rank, n_devices, backend, device, timeout=timeout)[0]
    out["wall"] = time.perf_counter() - t0
    m, s = out["means"], out["seconds"]
    print(f"dryrun_multichip OK: {n_devices} ranks ({backend} on {device}), mesh "
          f"sp={out['sp']} dp={out['dp']}, {out['samples']} samples, "
          + ", ".join(f"{k} mean {m[k]:.4f} ({s[k]:.1f} s)" for k in m)
          + f"; {out['wall']:.1f} s with the ranks' start", flush=True)
    return out
