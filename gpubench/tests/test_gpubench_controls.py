"""The check fails its control and every planted fault, at a size a CPU
test holds: the reference put in the program's place in TF32, the
program in its own bfloat16, and each fault a training cell can have
(``faults.py``), driven through the rest of a run, against each cell's
own limits."""

from __future__ import annotations

import copy

import pytest
import torch

from gpubench import faults, harness, judge
from gpubench.registry import Registry
from gpubench.tests import tiny

REG = Registry()
CELLS = [w["name"] for w in REG.bench["workloads"]]
# VGG-16 at 16 images a worker, at which sound runs pass the limits on the
# CPU (BatchNorm over a few images flips far more ReLU decisions)
BATCH = {"bert": 3, "vgg": 16}


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def _cell(name):
    cfg, wl = tiny.cell(name)
    return tiny.cell(name, BATCH[cfg["family"]])


def _verdict(name, nums):
    return judge.verdict(nums, REG.workload(name)["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_program_passes(name):
    """What the failures below are held against: the program as it is,
    at the same size, passes."""
    cfg, wl = _cell(name)
    res = harness.run(REG, REG.cell(name), 2 ** 31 + 37, 0.1, False, "cpu",
                      0.0, config=cfg, workload=wl)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_tf32_in_the_programs_place_fails(name):
    cfg, wl = _cell(name)
    seed = 2 ** 31 + 23
    _, table, pool = harness.build(REG, cfg, wl, seed, "cpu")
    w0, ref = harness.reference(cfg, wl, table, pool, seed, "cpu")
    _, low = harness.reference(cfg, wl, table, pool, seed, "cpu", "tf32")
    nums = harness.compare(cfg, table, low, w0, ref)
    assert not _verdict(name, nums), nums


@pytest.mark.parametrize("name", CELLS)
def test_the_programs_bfloat16_fails(name):
    cfg, wl = _cell(name)
    wl = copy.deepcopy(wl)
    wl["compute_dtype"] = "bfloat16"
    res = harness.run(REG, REG.cell(name), 2 ** 31 + 29, 0.1, False, "cpu",
                      0.0, config=cfg, workload=wl)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_fails(name, fault):
    cfg, wl = _cell(name)
    res = harness.run(REG, REG.cell(name), 2 ** 31 + 31, 0.1, False, "cpu",
                      0.0, tamper=faults.FAULTS[fault], config=cfg,
                      workload=wl)
    assert not res["correct"], res["checks"]
