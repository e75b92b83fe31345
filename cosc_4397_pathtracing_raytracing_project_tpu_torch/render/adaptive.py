"""Variance-guided adaptive sampling over the megakernel's tile dispatch.

Port of the JAX package's ``render/adaptive.py`` (single device): samples
alternate between two half-buffer accumulators A and B with equal counts;
the squared disagreement of their clamped means, averaged per tile,
estimates each tile's remaining error, and every round the tiles with the
largest marginal gain get ``round_spp`` more samples through one launch of
the megakernel's tile dispatch (:func:`megakernel.render_tiles`, kernel K6).

- Tiles are 32×64-pixel blocks (``TILE`` pixels) in row-major block order;
  partial edge blocks repeat their last valid pixel in padding lanes, which
  scatter into a trash slot after the last pixel. A trash tile after the
  last tile keeps the JAX layout (its lanes render tile 0's pixels into the
  trash slot).
- Each tile keeps its own iteration counter, so a refined tile continues
  its sample streams exactly where it left off: buffer A takes iterations
  ``2c+1 .. 2c+k`` and buffer B ``2c+k+1 .. 2c+2k`` of a tile with ``c``
  samples per buffer.
- Selection, dispatch and bookkeeping stay on the device: a round reads
  nothing back to the host. Ties in the gain go to the lower tile index, as
  ``jax.lax.top_k`` orders them.
- With a device ``mesh`` (``parallel.make_mesh``, every rank running the
  same renderer) each dispatch splits its tiles over all ranks
  (``parallel.shard.render_tiles_sharded``) and every rank gathers all of
  them, so every rank keeps the same accumulators and picks the same tiles.
  A dispatch's tile count is then a multiple of the quantum (the rank
  count if odd, half of it if even: the dispatch renders each tile twice);
  a selection rounds up into real tiles, then pads with the trash tile.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.cuda import megakernel
from ..ops.rng import kernel_seed
from ..scene.parser import load_scene_desc
from ..scene.structs import Scene, SceneDesc
from .engine import RenderConfig, _check_device


def make_tile_layout(
    w: int, h: int, tile_shape: Tuple[int, int] = (32, 64)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Spatial block decomposition of a w×h frame into megakernel tiles.

    Returns (px [T, TILE] f32, py [T, TILE] f32, idx [T, TILE] i32,
    valid [T] i32): per-tile pixel coordinates in row-major block order,
    the flat scatter index of each lane (== w·h for padding lanes — the
    caller's trash slot), and the count of valid lanes per tile."""
    bh, bw = tile_shape
    if bh * bw != megakernel.TILE:
        raise ValueError(
            f"tile_shape {tile_shape} must cover {megakernel.TILE} pixels"
        )
    ty = -(-h // bh)
    tx = -(-w // bw)
    t_ids = np.arange(ty * tx)
    by = (t_ids // tx) * bh  # block origin row
    bx = (t_ids % tx) * bw  # block origin col
    ly = np.arange(bh * bw) // bw  # lane offset within the block
    lx = np.arange(bh * bw) % bw
    yy = by[:, None] + ly[None, :]
    xx = bx[:, None] + lx[None, :]
    in_frame = (yy < h) & (xx < w)
    # padding lanes duplicate the clamped coordinate (a real pixel — its
    # radiance is valid, just redundant) and scatter to the trash slot
    yc = np.minimum(yy, h - 1)
    xc = np.minimum(xx, w - 1)
    idx = np.where(in_frame, yc * w + xc, w * h).astype(np.int32)
    return (
        xc.astype(np.float32),
        yc.astype(np.float32),
        idx,
        in_frame.sum(axis=1).astype(np.int32),
    )


def _dispatch_ab(
    scene: Scene,
    acc_a: torch.Tensor,  # [n+1, 3] — last row is the padding trash slot
    acc_b: torch.Tensor,
    seed: int,
    tile_ids: torch.Tensor,  # [K] i32 selected tiles
    base: torch.Tensor,  # [K] i32 samples so far per tile (both buffers)
    px_all: torch.Tensor,  # [T+1, TILE] f32 layout tables
    py_all: torch.Tensor,
    idx_all: torch.Tensor,  # [T+1, TILE] i64 scatter indices
    config: RenderConfig,
    k: int,  # samples per buffer
    packed: megakernel.PackedScene,
    mesh=None,
) -> None:
    """Render k samples into BOTH half-buffers for the selected tiles in a
    single launch: tiles [0, K) of the dispatch advance buffer A's
    iteration window (base+1 … base+k), tiles [K, 2K) buffer B's
    (base+k+1 … base+2k). Adds into ``acc_a``/``acc_b`` in place. With a
    device ``mesh`` the 2K tiles split over its ranks
    (``parallel.shard.render_tiles_sharded``: bit for bit, every rank gets
    every tile's radiance)."""
    kk = tile_ids.shape[0]
    ids2 = torch.cat([tile_ids, tile_ids])
    bases2 = torch.cat([base + 1, base + 1 + k])
    rows = ids2.long()
    args = (scene, config, seed, ids2, bases2, px_all[rows].reshape(-1),
            py_all[rows].reshape(-1), k)
    if mesh is None:
        rad = megakernel.render_tiles(*args, packed=packed)
    else:
        from ..parallel.shard import render_tiles_sharded

        rad = render_tiles_sharded(*args, mesh, packed=packed)
    half = kk * megakernel.TILE
    flat_idx = idx_all[tile_ids.long()].reshape(-1)
    # indices are unique but for the trash slot: the adds do not depend on order
    acc_a.index_add_(0, flat_idx, rad[:half])
    acc_b.index_add_(0, flat_idx, rad[half:])


def _tile_errors(
    accum_a: torch.Tensor,  # [n+1, 3]
    accum_b: torch.Tensor,
    counts: torch.Tensor,  # [T+1] i32 per-tile sample count PER BUFFER
    idx_all: torch.Tensor,  # [T+1, TILE]
    valid: torch.Tensor,  # [T+1]
) -> torch.Tensor:
    """Two-buffer noise estimate per tile: the mean over valid lanes of the
    squared difference of the two half-buffer means, clamped to [0, 1]
    first (E[(A/n − B/n)²] = 2σ²/n per pixel; noise above the display range
    must not attract samples)."""
    n = accum_a.shape[0] - 1
    inv_c = (1.0 / torch.clamp_min(counts.to(torch.float32), 1.0))[:, None, None]
    da = torch.clamp(accum_a[idx_all] * inv_c, 0.0, 1.0)
    db = torch.clamp(accum_b[idx_all] * inv_c, 0.0, 1.0)
    e = torch.mean((da - db) ** 2, dim=-1)  # [T, TILE]
    lane_ok = (idx_all < n).to(torch.float32)  # trash-slot gathers → 0
    return (e * lane_ok).sum(dim=1) / torch.clamp_min(valid.to(torch.float32), 1.0)


def _refine_round(
    scene: Scene,
    acc_a: torch.Tensor,
    acc_b: torch.Tensor,
    counts: torch.Tensor,  # [T+1] i32 per-buffer tile counts (+ trash entry)
    seed: int,
    px_all: torch.Tensor,
    py_all: torch.Tensor,
    idx_all: torch.Tensor,
    valid: torch.Tensor,
    config: RenderConfig,
    k: int,
    n_sel: int,
    packed: megakernel.PackedScene,
    n_disp: int,
    mesh=None,
) -> torch.Tensor:
    """One refinement round on the device: estimate per-tile noise, pick
    the ``n_sel`` tiles with the largest marginal gain err/(count + k), render
    ``k`` more samples into each half-buffer for them and bump their counts
    (in place). ``n_disp >= n_sel`` pads the dispatch with the trash tile
    (the last entry of ``counts``) so it splits evenly over a device
    ``mesh``. Returns the selected tile ids [n_sel] (on the device)."""
    err = _tile_errors(acc_a, acc_b, counts, idx_all, valid)
    gain = err / (counts.to(torch.float32) + float(k))
    # a stable descending sort keeps the lower index first among equal
    # gains, as jax.lax.top_k does (torch.topk promises no tie order)
    sel = torch.sort(gain[:-1], descending=True, stable=True).indices[:n_sel]
    sel = sel.to(torch.int32)
    disp = sel
    if n_disp > n_sel:
        pad = torch.full((n_disp - n_sel,), counts.shape[0] - 1, dtype=torch.int32,
                         device=sel.device)
        disp = torch.cat([sel, pad])
    _dispatch_ab(
        scene, acc_a, acc_b, seed, disp, counts[disp.long()] * 2,
        px_all, py_all, idx_all, config, k, packed, mesh,
    )
    counts.index_add_(0, sel, torch.full_like(sel, k))
    return sel


class AdaptiveRenderer:
    """Host driver for adaptive rendering on one device (the adaptive twin
    of ``engine.Renderer``; the megakernel's tile dispatch).

    Usage::

        r = AdaptiveRenderer("scenes/cornell.txt",
                             RenderConfig(sampler="sobol"), device="cuda")
        r.render(256)            # 256 average spp, adaptively placed
        img = r.linear_image()   # per-pixel mean (counts vary per tile)
        spp = r.spp_map()        # where the samples went

    ``device`` is explicit, as for ``Renderer``: a CUDA device launches the
    CUDA kernel, ``"cpu"`` runs its plain version. With a device ``mesh``
    (``parallel.make_mesh``) every rank of the mesh builds the same renderer
    on its own device and calls the same methods in the same order; each
    dispatch's tiles split over the ranks, and every rank holds the whole
    image."""

    def __init__(
        self,
        scene,
        config: Optional[RenderConfig] = None,
        seed: int = 0,
        tile_shape: Tuple[int, int] = (32, 64),
        device="cuda",
        mesh=None,
    ):
        self.device = _check_device(device)
        if isinstance(scene, str):
            scene = load_scene_desc(scene)
        if isinstance(scene, SceneDesc):
            self.scene = Scene.from_desc(scene, self.device)
            if config is None:
                config = RenderConfig(trace_depth=scene.trace_depth)
            self.image_name = scene.image_name
        else:
            if scene.device != self.device:
                raise ValueError(
                    f"scene lives on {scene.device}, renderer on {self.device}"
                )
            self.scene = scene
            config = config or RenderConfig()
            self.image_name = "render"
        if not megakernel.supports(self.scene):
            raise ValueError(
                "adaptive sampling runs on the megakernel pipeline "
                "(analytic cube/sphere scenes)"
            )
        if config.dof is None:
            config = dataclasses.replace(
                config, dof=bool(float(self.scene.camera.aperture) > 0.0)
            )
        # an environment renders in exact mode without nee (the JAX
        # render_tiles' limits, checked here before any launch)
        megakernel.check_tiles_env(self.scene, config)
        self.config = config
        self._packed = megakernel.pack_scene(
            self.scene, nee=megakernel.kernel_options(config, self.scene).nee, config=config
        )

        w, h = self.scene.camera.resolution
        self._n = w * h
        px, py, idx, valid = make_tile_layout(w, h, tile_shape)
        self.num_tiles = px.shape[0]
        # multi-device: a dispatch of 2K tiles splits evenly over the mesh's
        # ranks, so K is a multiple of the quantum m (the rank count if odd,
        # half of it if even); past the real tiles it pads with the trailing
        # trash tile: tile 0's coordinates, every lane scattered into the
        # trash slot (the JAX layout), so any frame and mesh go together
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh), got "
                                f"{type(mesh).__name__}")
        self._mesh = mesh
        n_dev = 1 if mesh is None else mesh.size()
        self._quantum = n_dev if n_dev % 2 else n_dev // 2
        self._pad_tile = self.num_tiles
        px = np.concatenate([px, px[:1]])
        py = np.concatenate([py, py[:1]])
        idx = np.concatenate([idx, np.full((1, idx.shape[1]), self._n, np.int32)])
        valid = np.concatenate([valid, np.zeros(1, np.int32)])
        self._idx_host = idx
        self._valid_host = valid
        dev = self.device
        self._px_all = torch.as_tensor(px, device=dev)
        self._py_all = torch.as_tensor(py, device=dev)
        self._idx_all = torch.as_tensor(idx.astype(np.int64), device=dev)
        self._valid = torch.as_tensor(valid, device=dev)

        # two half-buffer accumulators, each with a trailing trash slot
        self._acc_a = torch.zeros((self._n + 1, 3), dtype=torch.float32, device=dev)
        self._acc_b = torch.zeros((self._n + 1, 3), dtype=torch.float32, device=dev)
        # per-tile sample count PER BUFFER (total per pixel = 2×), on the
        # device; the trailing entry belongs to the trash tile
        self._counts = torch.zeros(self.num_tiles + 1, dtype=torch.int32, device=dev)
        self._seed = kernel_seed(seed)
        self._lane_budget_spent = 0  # lanes × samples dispatched
        self._wall = 0.0

    # ── core dispatch ──

    def warmup(self, spp: int = 16) -> None:
        """Uniform bootstrap: spp total samples (spp//2 per buffer) on every
        tile — the two-buffer estimate needs a baseline everywhere."""
        k = max(1, spp // 2)
        # the all-tiles dispatch, padded up to the quantum with trash tiles
        kd = -(-self.num_tiles // self._quantum) * self._quantum
        ids = torch.clamp_max(torch.arange(kd, dtype=torch.int32, device=self.device),
                              self._pad_tile)
        t0 = time.perf_counter()
        _dispatch_ab(
            self.scene, self._acc_a, self._acc_b, self._seed, ids,
            self._counts[ids.long()] * 2, self._px_all, self._py_all, self._idx_all,
            self.config, k, self._packed, self._mesh,
        )
        self._counts[: self.num_tiles] += k
        self._lane_budget_spent += 2 * k * kd * megakernel.TILE
        self._wall += time.perf_counter() - t0

    def tile_errors(self) -> np.ndarray:
        """[T] two-buffer noise estimate per tile (host copy; the render
        loop itself never fetches this — selection runs on the device)."""
        err = _tile_errors(
            self._acc_a, self._acc_b, self._counts, self._idx_all, self._valid
        )
        return err.cpu().numpy()[: self.num_tiles]

    def refine(self, spp: int = 16, frac: float = 0.25) -> torch.Tensor:
        """One adaptive round: give ``spp`` more samples each to the ``frac``
        of tiles with the largest marginal MSE gain. Returns the selected
        tile ids (on the device; only callers who read them pay a sync)."""
        k = max(1, spp // 2)
        # sharded: round the selection up to a multiple of the quantum, into
        # real tiles while any remain (the extra slots do useful work), then
        # pad with the trash tile
        m = self._quantum
        n_sel = max(1, int(round(self.num_tiles * frac)))
        n_sel = min(-(-n_sel // m) * m, self.num_tiles)
        n_disp = -(-n_sel // m) * m
        t0 = time.perf_counter()
        sel = _refine_round(
            self.scene, self._acc_a, self._acc_b, self._counts, self._seed,
            self._px_all, self._py_all, self._idx_all, self._valid,
            self.config, k, n_sel, self._packed, n_disp, self._mesh,
        )
        self._lane_budget_spent += 2 * k * n_disp * megakernel.TILE
        self._wall += time.perf_counter() - t0
        return sel

    def render(
        self,
        avg_spp: int,
        warmup_spp: Optional[int] = None,
        round_spp: int = 32,
        frac: float = 0.25,
        progress: bool = False,
    ) -> "AdaptiveRenderer":
        """Adaptively spend an ``avg_spp``-per-pixel sample budget: uniform
        warmup (default a quarter of the budget, ≥16), then top-``frac``
        refinement rounds of ``round_spp`` until the budget is consumed.
        The budget counts dispatched lanes (padding included), so the
        total device work matches a uniform ``avg_spp`` render. Sample
        counts per dispatch are rounded down to even (the A/B split), as
        the JAX package does in interpret mode: this kernel has no
        interleave factor to round to. Waits for the device at the end."""
        budget = avg_spp * self._n
        if warmup_spp is None:
            warmup_spp = min(max(16, avg_spp // 4), avg_spp)
        warmup_spp = max(2, (warmup_spp // 2) * 2)
        round_spp = max(2, (round_spp // 2) * 2)
        if self._lane_budget_spent == 0:  # fresh start (not a resume)
            self.warmup(warmup_spp)
            if progress:
                print(f"warmup {warmup_spp} spp on {self.num_tiles} tiles")
        while self._lane_budget_spent < budget:
            sel = self.refine(round_spp, frac)
            if progress:
                e = self.tile_errors()
                print(
                    f"refine {len(sel)} tiles +{round_spp} spp  "
                    f"avg {self.avg_spp:.1f} spp  max_err {e.max():.4f}"
                )
        t0 = time.perf_counter()
        self.sync()
        self._wall += time.perf_counter() - t0
        return self

    # ── state ──

    def load_state(self, state: dict) -> "AdaptiveRenderer":
        """Continue from ``state`` (``convert.adaptive_state_from_jax``):
        ``acc_a``/``acc_b`` [n+1, 3], ``counts`` [T+1], ``seed``,
        ``budget_spent``."""
        for name, want in (("acc_a", self._acc_a), ("acc_b", self._acc_b),
                           ("counts", self._counts)):
            got = state[name]
            if got.shape != want.shape or got.dtype != want.dtype:
                raise ValueError(
                    f"{name}: {tuple(got.shape)} {got.dtype} does not match the "
                    f"renderer's {tuple(want.shape)} {want.dtype}"
                )
        self._acc_a = state["acc_a"].to(self.device).clone()
        self._acc_b = state["acc_b"].to(self.device).clone()
        self._counts = state["counts"].to(self.device).clone()
        self._seed = int(state["seed"])
        self._lane_budget_spent = int(state["budget_spent"])
        return self

    def save_checkpoint(self, path: str) -> str:
        from .checkpoint import save_adaptive_checkpoint

        meta = {
            "image_name": self.image_name,
            "resolution": list(map(int, self.scene.camera.resolution)),
            "num_tiles": int(self.num_tiles),
        }
        return save_adaptive_checkpoint(path, self, meta)

    def load_checkpoint(self, path: str) -> "AdaptiveRenderer":
        """Continue from an adaptive checkpoint of either package (per-tile
        iteration counters key every stream, so the resumed render is bit
        for bit the uninterrupted one); its tensors move to this
        renderer's device."""
        from .checkpoint import load_adaptive_checkpoint

        state, _ = load_adaptive_checkpoint(path, self.device)
        if state["counts"].shape[0] == self.num_tiles:
            # the older format's counts lack the trash tile's entry
            state["counts"] = torch.cat([state["counts"], state["counts"].new_zeros(1)])
        if state["acc_a"].shape != self._acc_a.shape or (
            state["counts"].shape[0] != self.num_tiles + 1
        ):
            raise ValueError(
                f"checkpoint layout ({state['acc_a'].shape[0] - 1} pixels, "
                f"{state['counts'].shape[0]} tiles) does not match renderer "
                f"({self._n} pixels, {self.num_tiles} tiles)"
            )
        return self.load_state(state)

    # ── outputs ──

    @property
    def avg_spp(self) -> float:
        """Average samples per pixel actually accumulated (valid lanes)."""
        c = self._counts.cpu().numpy().astype(np.float64)
        v = self._valid_host.astype(np.float64)
        return float((c * 2 * v).sum() / self._n)

    @property
    def iteration(self) -> int:
        """Average spp rounded down — the Renderer-compatible counter."""
        return int(self.avg_spp)

    def spp_map(self, per_buffer: bool = False) -> np.ndarray:
        """[H, W] int32 per-pixel sample count (the allocation picture)."""
        w, h = self.scene.camera.resolution
        scale = 1 if per_buffer else 2
        counts = np.zeros(self._n + 1, np.int64)
        tile_counts = self._counts.cpu().numpy().astype(np.int64)
        for t in range(self.num_tiles):
            counts[self._idx_host[t]] = tile_counts[t] * scale
        return counts[: self._n].reshape(h, w).astype(np.int32)

    def linear_image(self) -> np.ndarray:
        """[H, W, 3] float32 per-pixel mean radiance (count-aware)."""
        w, h = self.scene.camera.resolution
        counts = self.spp_map().reshape(-1, 1).astype(np.float32)
        total = (self._acc_a[: self._n] + self._acc_b[: self._n]).cpu().numpy()
        return (total / np.maximum(counts, 1.0)).reshape(h, w, 3)

    def denoised_image(self, **kw) -> np.ndarray:
        """[H, W, 3] float32 linear radiance after the À-Trous denoiser."""
        from .denoise import denoise_image

        return denoise_image(self, **kw)

    def save_png(self, path: Optional[str] = None, denoise: bool = False) -> str:
        """Write the PNG with the reference's save transform (linear clamp,
        no gamma, horizontal mirror, `main.cpp:86-107`) — same contract as
        Renderer.save_png, with the count-aware mean underneath."""
        from ..io.png import write_png
        from ..utils.timing import current_time_string

        lin = self.denoised_image() if denoise else self.linear_image()
        img = (np.clip(lin, 0.0, 1.0) * 255.0)[:, ::-1, :].astype(np.uint8)
        if path is None:
            path = f"{self.image_name}.{current_time_string()}.{self.iteration}samp.png"
        write_png(path, img)
        return path

    def sync(self) -> None:
        """Wait until every queued kernel of this renderer's device is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def samples_per_second(self) -> float:
        """Dispatched primary samples per wall second (lane count / wall of
        warmup, refine and render, the final device wait included)."""
        return self._lane_budget_spent / max(self._wall, 1e-9)
