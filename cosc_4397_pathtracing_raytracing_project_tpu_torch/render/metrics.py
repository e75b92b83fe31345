"""Performance + PSNR metrics harness (same properties as the JAX package's).

Mirrors the reference's `PerformanceMetrics` struct and per-iteration printf
block (`src/pathtrace.cu:157-201,632-646`):

- ``samples_per_second = pixelcount · iterations / total wall time`` — the
  reference's "rays/s" definition (`pathtrace.cu:173`, primary samples, not
  bounce rays);
- self-referential PSNR: the frame at iteration SNAPSHOT_ITER (10) is stored
  as the reference and later frames compared against it
  (`pathtrace.cu:184-201`);
- ``iterations_to_clean`` = first iteration with PSNR > 35 dB
  (`pathtrace.cu:629-630`).

PSNR against an external ground-truth image is reduced on the accumulator's
device, so only a scalar crosses to the host; device memory comes from
``torch.cuda.memory_allocated()``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

SNAPSHOT_ITER = 10
CLEAN_PSNR_DB = 35.0


def mse_between(mean_a: torch.Tensor, mean_b: torch.Tensor) -> torch.Tensor:
    """Mean squared error over pixels×channels (`pathtrace.cu:193-198`)."""
    d = mean_a - mean_b
    return torch.mean(d * d)


def psnr_from_mse(mse: float) -> float:
    """``10·log10(1/MSE)`` with the reference's Inf guard
    (`pathtrace.cu:199-200`)."""
    if mse <= 1e-12:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))


def _mean(accum: torch.Tensor, iteration: int) -> torch.Tensor:
    return accum.reshape(-1, 3) / float(max(iteration, 1))


@dataclasses.dataclass
class MetricsTracker:
    """Wall-clock throughput tracking + PSNR state for one render."""

    pixel_count: int
    total_render_time: float = 0.0
    iterations: int = 0
    last_psnr_db: float = float("inf")
    iterations_to_clean: int = -1
    snapshot: Optional[torch.Tensor] = None  # iteration-10 mean frame
    snapshot_iteration: int = -1  # iteration the snapshot was actually taken at
    external_reference: Optional[torch.Tensor] = None  # ground-truth mean frame

    def record(self, num_samples: int, elapsed_s: float) -> None:
        self.iterations += num_samples
        self.total_render_time += elapsed_s

    @property
    def avg_iteration_ms(self) -> float:
        if self.iterations == 0:
            return 0.0
        return self.total_render_time / self.iterations * 1000.0

    @property
    def samples_per_second(self) -> float:
        """Primary samples (pixels·iterations) per wall second — the
        reference's rays/s metric."""
        if self.total_render_time == 0.0:
            return 0.0
        return self.pixel_count * float(self.iterations) / self.total_render_time

    # ── PSNR harness ──

    def set_external_reference(self, linear_image: np.ndarray) -> None:
        """Ground-truth comparison target ([H,W,3] float linear, or [N,3])."""
        self.external_reference = torch.as_tensor(
            np.asarray(linear_image, np.float32).reshape(-1, 3)
        )

    def capture_snapshot(self, accum: torch.Tensor, iteration: int) -> None:
        """Record the self-reference frame at a true iteration-10 boundary
        (see Renderer.psnr_snapshot; `pathtrace.cu:184-191`)."""
        self.snapshot = _mean(accum, iteration)
        self.snapshot_iteration = iteration

    def update_psnr(self, accum: torch.Tensor, iteration: int) -> float:
        """Reference-parity PSNR update: snapshot the frame at iteration 10,
        then compare subsequent frames to it. Returns the current PSNR
        (inf before the snapshot exists, as the reference returns FLT_MAX).

        Chunked renders that never materialize an exact 10-spp frame fall
        back to snapshotting the first ≥10 frame seen; `snapshot_iteration`
        records which."""
        mean = _mean(accum, iteration)
        if self.snapshot is None:
            if iteration >= SNAPSHOT_ITER:
                self.snapshot = mean
                self.snapshot_iteration = iteration
            self.last_psnr_db = float("inf")
            return self.last_psnr_db
        mse = float(mse_between(mean, self.snapshot))
        self.last_psnr_db = psnr_from_mse(mse)
        if self.last_psnr_db > CLEAN_PSNR_DB and self.iterations_to_clean < 0:
            self.iterations_to_clean = iteration
        return self.last_psnr_db

    def psnr_vs_external(self, accum: torch.Tensor, iteration: int) -> float:
        if self.external_reference is None:
            raise ValueError("no external reference set")
        ref = self.external_reference.to(accum.device)
        return psnr_from_mse(float(mse_between(_mean(accum, iteration), ref)))

    @staticmethod
    def device_memory_bytes() -> int:
        """CUDA memory held by tensors (`cudaMemGetInfo` analog,
        `pathtrace.cu:178-182`); 0 without a CUDA device."""
        if not torch.cuda.is_available():
            return 0
        return int(torch.cuda.memory_allocated())

    def summary(self) -> str:
        """The reference's per-iteration printf block (`pathtrace.cu:632-646`)."""
        lines = [
            "====== PERFORMANCE METRICS SUMMARY ======",
            f"Total render time: {self.total_render_time:.2f} seconds",
            f"Avg iteration time: {self.avg_iteration_ms:.2f} ms",
            f"Samples per second: {self.samples_per_second / 1e6:.2f} million rays/s",
            f"Device memory used: {self.device_memory_bytes() / (1 << 20):.2f} MB",
            (
                "PSNR: Inf dB"
                if self.last_psnr_db == float("inf")
                else f"PSNR: {self.last_psnr_db:.2f} dB"
                + (
                    f" (vs iter-{self.snapshot_iteration} snapshot)"
                    if self.snapshot_iteration != SNAPSHOT_ITER
                    else ""
                )
            ),
        ]
        if self.iterations_to_clean > 0:
            lines.append(f"Iterations to clean: {self.iterations_to_clean}")
        lines.append("=========================================")
        return "\n".join(lines)
