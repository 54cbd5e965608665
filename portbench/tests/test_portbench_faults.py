"""The comparison fails what it must fail: with the timed path broken
underneath (the faults of `portbench/harness/faults.py` planted in the
program), and with the program's own lower-precision path switched on in
place of the configured one (the control: W8A8 int8 encoders), a run of a
tiny cell comes out with `correct` false. The harness's look for a chip is
skipped (the CPU runs the kernels' plain versions); everything else is a
whole run."""
import os

import pytest

from conftest import run_tiny
from portbench import control
from portbench.harness.faults import FAULTS

CELLS = ["tiny.single"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(tiny_root, torch_threads, cell, fault):
    with FAULTS[fault]():
        res = run_tiny(tiny_root, cell, seed=5)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught(tiny_root, torch_threads, cell):
    import os
    out = control.readings(cell, [5, 6, 7], 2.0, ["control"], device="cpu",
                           root=tiny_root,
                           bench=os.path.join(tiny_root, "portbench"))
    limits = {"dino_cos": 1e-6, "fpn_cos": 1e-6}
    for nums in out["control"]:
        assert any(nums[n] > limits[n] for n in limits), nums


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sam2l_dinov2l.single",
                                  "sam2s_dinov2l.single"])
def test_control_is_caught_on_the_card(cell):
    """The control at the cell's own size on three seeds: every run reads
    outside the cell's limits."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = control.readings(cell, [71, 72, 73], 3.0, ["control"])
    from portbench.harness.cells import Cell
    from portbench.harness.check import load_limits
    c = Cell(cell)
    limits = load_limits(os.path.join(control.ROOT, "portbench"),
                         c.config["name"])
    for nums in out["control"]:
        assert any(nums[n] > limits[n] for n in limits
                   if limits[n] is not None), nums
