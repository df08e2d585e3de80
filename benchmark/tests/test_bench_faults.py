"""A run with the timed path broken underneath is not correct, nor is the
reference in bfloat16 put in the program's place: each driver run here on
the CPU at a tiny size through everything but the look for a card
(``run.py``'s), judged against the cell's own limits."""

import time

import pytest
import torch

from benchmark import core, faults
from benchmark.run import result_line

STEP = dict(lanes=4, block=8192, ring=3, check_lanes=4, check_blocks=2, carry_chunks=2, warmup_steps=1)
# the group's step is 128 lanes wide whatever the clients: give it all 128
GROUP = dict(lanes=128, block=2048, ring=3, check_lanes=8, check_blocks=1, carry_chunks=1, warmup_steps=1)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def drive(workload, mix, fault=None, control=False, seconds=3.0):
    cell = core.Cell(workload)
    cell.mix.update(mix)
    out = core.driver(cell.mix["driver"]).run(cell, seed=2**31 + 17, seconds=seconds, trace=False,
                                              device="cpu", t_start=time.perf_counter(),
                                              fault=None if fault is None else faults.FAULTS[fault],
                                              control=control)
    return cell, out


@pytest.mark.parametrize("workload", ["lucky7.fanout128", "nusat.fanout128"])
def test_step_sound_passes_and_the_control_fails(workload):
    cell, out = drive(workload, STEP, control=True)
    assert out["numbers"]["compared_blocks"] >= 2
    assert result_line(cell, out, None, "cpu")["correct"] is True
    low = {**out, "numbers": out["numbers"]["control"]}
    assert result_line(cell, low, None, "cpu")["correct"] is False


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_step_fault_is_not_correct(fault):
    cell, out = drive("lucky7.fanout128", STEP, fault)
    assert result_line(cell, out, None, "cpu")["correct"] is False


@pytest.mark.parametrize("fault", [None, *sorted(faults.FAULTS)])
def test_served_fault_is_not_correct(fault):
    cell, out = drive("nusat.served128", GROUP, fault, seconds=5.0)
    assert out["attempted"] >= 3
    assert result_line(cell, out, None, "cpu")["correct"] is (fault is None)


@pytest.mark.cuda
def test_step_on_the_card(card):
    """The step cell on the card at 128 lanes x 65536: the program within
    its limit, the reference in bfloat16 not."""
    cell, out = None, None
    cell = core.Cell("lucky7.fanout128")
    cell.mix.update(block=65536, ring=4, warmup_steps=1)
    out = core.driver("step").run(cell, seed=2**31 + 29, seconds=2.0, trace=False, device=card,
                                  t_start=time.perf_counter(), control=True)
    assert result_line(cell, out, None, "card")["correct"] is True
    assert result_line(cell, {**out, "numbers": out["numbers"]["control"]}, None, "card")["correct"] is False
