"""The card's clocks, power and temperature sampled beside the window by
one ``nvidia-smi`` process, so a spread paced by the card can be told from
one paced by the host."""

from __future__ import annotations

import shutil
import statistics
import subprocess
import tempfile

QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"
FIELDS = ("clock_sm_mhz", "power_w", "power_limit_w", "temp_c")


class CardSampler:
    """``nvidia-smi --query-gpu`` every ``period_ms`` until :meth:`stop`."""

    def __init__(self, period_ms: int = 500, device_index: int = 0):
        self.proc = None
        self.out = tempfile.TemporaryFile(mode="w+")
        exe = shutil.which("nvidia-smi")
        if exe is not None:
            self.proc = subprocess.Popen(
                [exe, f"--query-gpu={QUERY}", "--format=csv,noheader,nounits",
                 f"--id={device_index}", f"-lms={int(period_ms)}"],
                stdout=self.out, stderr=subprocess.DEVNULL)

    def stop(self) -> list:
        """Ends the sampler, waits for it, and returns its samples."""
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.out.seek(0)
        rows = []
        for line in self.out.read().splitlines():
            parts = [p.strip() for p in line.split(",")]
            try:
                rows.append(dict(zip(FIELDS, (float(p) for p in parts))))
            except ValueError:
                continue
        self.out.close()
        return [r for r in rows if len(r) == len(FIELDS)]


def summary(samples: list) -> dict:
    """Least, median and largest of each field over the samples."""
    out = {"samples": len(samples)}
    for f in FIELDS:
        vals = [s[f] for s in samples]
        if vals:
            out[f] = [min(vals), statistics.median(vals), max(vals)]
    return out
