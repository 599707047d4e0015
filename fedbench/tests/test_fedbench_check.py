"""The comparison that decides ``correct``, on tiny cells on the CPU: a
sound run passes, the reference one precision lower and each planted
fault of the timed path fail."""
from __future__ import annotations

import time

import pytest
import torch

from fedbench import check, run
from fedbench.tests import tiny

KINDS = ("mamba2", "dense")
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs in TF32 there")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", KINDS)
def test_program_agrees_with_reference(kind):
    cell = tiny.cell(kind)
    res = run.run_cell(cell, SEED, 0.1, False, "cpu", time.time())
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == set(cell.workload["limits"])
    assert set(res["metrics"]) == {m.name for m in cell.end_to_end}
    assert {n.partition(".")[0] for n in res["metrics"]} == {
        "round_s", "peak_gib", "setup_s"}


@pytest.mark.parametrize("kind", KINDS)
def test_control_in_tf32_fails(kind):
    """The reference with each product's operands rounded to TF32 (the
    card's TF32, emulated) in the program's place."""
    cell = tiny.cell(kind)
    dev = torch.device("cpu")
    pool = run.pool_for(cell, SEED, dev)
    ref = run.reference_side(cell, SEED, dev, pool)
    low = run.reference_side(cell, SEED, dev, pool, tf32=True, emulate=True)
    ok, table = run.compare(cell, low, ref)
    assert not ok, table


@pytest.mark.cuda
def test_control_in_tf32_fails_on_card(cuda_device):
    """The control on the card's own TF32, three seeds."""
    cell = tiny.cell("dense", batch_size=4, seq_len=128)
    for seed in (1, 2, SEED):
        pool = run.pool_for(cell, seed, cuda_device)
        ref = run.reference_side(cell, seed, cuda_device, pool)
        low = run.reference_side(cell, seed, cuda_device, pool, tf32=True)
        ok, table = run.compare(cell, low, ref)
        assert not ok, table


@pytest.mark.parametrize("fault", ("unchanged", "half_batch",
                                   "altered_token"))
@pytest.mark.parametrize("kind", KINDS)
def test_broken_timed_path_is_not_correct(kind, fault):
    """The whole run, the card's look skipped, with the program broken
    underneath: a round that returns its state unchanged, half of each
    batch left out, one label altered where the loss reads it."""
    res = run.run_cell(tiny.cell(kind), SEED, 0.1, False, "cpu",
                       time.time(), fault=fault)
    assert res["correct"] is False, res["checks"]
