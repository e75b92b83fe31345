"""A run with the timed path broken underneath comes out not correct.

Each case drives the rest of a run of a cell cut to a CPU size (the look for
a card skipped, the program on its plain PyTorch version) with one fault
planted in the program: a step that returns its state unchanged; half of
each launch's samples left out, the sum scaled up as if they were there;
one channel of each launch's radiance altered where it is produced. A run
without a fault comes out correct."""

from __future__ import annotations

import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import engine
from ptbench import drive
from ptbench_fixtures import small_cell

CELLS = ("cornell.offline", "env4k.offline", "cornell.interactive", "env4k.interactive")


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(engine, "make_pallas_step",
                        lambda: (lambda scene, state, config, num_samples: state))


def _half_batch(monkeypatch):
    render = megakernel.render_samples

    def half(scene, config, seed, iter_base, num_samples, **kw):
        kept = max(1, num_samples // 2)
        return render(scene, config, seed, iter_base, kept, **kw) * (num_samples / kept)

    monkeypatch.setattr(megakernel, "render_samples", half)


def _altered(monkeypatch):
    render = megakernel.render_samples

    def altered(*args, **kw):
        out = render(*args, **kw)
        out[:, 0] *= 1.25
        return out

    monkeypatch.setattr(megakernel, "render_samples", altered)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch, "altered": _altered}


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, _ = drive.run_cell(small_cell(name), 2 ** 31 + 99, 0.2, False, device="cpu")
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, _ = drive.run_cell(small_cell(name), 2 ** 31 + 99, 0.2, False, device="cpu")
    assert not result["correct"]
    assert result["failed"] > 0
