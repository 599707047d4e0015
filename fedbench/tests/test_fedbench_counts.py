"""``counts.py`` against ``torch.utils.flop_counter`` on the plain
reference, tiny configs on the CPU (the reference has no
rematerialization)."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fedbench import counts, traffic, trees
from fedbench.reference import memory, ops
from fedbench.tests import tiny


def _block_step_flops(cell, lo: int, hi: int) -> int:
    """FLOPs the counter sees in one SGD step of subproblem [lo, hi)
    (forward and backward of the units and the head), the frozen
    prefix's forward outside it."""
    fam, cfg, tr = cell.family, cell.config, cell.traffic
    dev = torch.device("cpu")
    params = fam.init(cfg, traffic.generator(5, 1, dev), dev)
    rows = traffic.token_pool(tr, cfg.vocab_size, 1, 5, dev)[0, 0, 0]
    flat = trees.flatten(params)
    with torch.no_grad():
        z = fam.apply_units(params, cfg, fam.embed(params, cfg,
                                                   rows[:, :-1]), 0, lo)
    train = {p: t.clone().requires_grad_(True) for p, t in flat.items()
             if fam.trains(cfg, p, lo, hi)}
    tree = trees.nest({**flat, **train})
    with FlopCounterMode(display=False) as fc:
        loss = fam.head_loss(tree, cfg, fam.apply_units(tree, cfg, z, lo,
                                                        hi), rows[:, 1:])
        torch.autograd.grad(loss, list(train.values()), allow_unused=True)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ("mamba2", "dense"))
def test_block_step_matmuls_match_the_counter(kind, monkeypatch):
    """The projections and the head, forward and backward: the counter
    on the reference with its attention and scan made product-free
    equals ``counts.step_flops`` without them."""
    monkeypatch.setattr(ops, "ssd_scan", lambda x, dt, A, Bm, Cm, D: (
        x * D[:, None] + 0 * (dt.sum() + A.sum() + Bm.sum() + Cm.sum())))
    monkeypatch.setattr(ops, "causal_attention", lambda q, k, v: (
        q + 0 * (k.sum() + v.sum())))
    cell = tiny.cell(kind)
    fam, cfg, tr = cell.family, cell.config, cell.traffic
    n = tr["batch_size"] * tr["seq_len"]
    for lo, hi in ((0, 1), (1, 3), (0, fam.num_units(cfg))):
        want = 3 * ((hi - lo) * fam.unit_matmul_flops(cfg, n)
                    + counts.head_flops(cfg, n))
        assert _block_step_flops(cell, lo, hi) == want


def test_attention_count_is_the_causal_half_of_the_square():
    """The reference's attention computes every (q, k) pair; K2's count
    takes the live causal pairs of the same products."""
    B, T, Hq, Hkv, hd = 2, 16, 4, 2, 8
    q, k, v = (torch.randn(B, T, h, hd) for h in (Hq, Hkv, Hkv))
    with FlopCounterMode(display=False) as fc:
        ops.causal_attention(q, k, v)
    pairs = T * (T + 1) // 2
    assert counts.k2_call(B, T, Hq, Hkv, hd).flops \
        == fc.get_total_flops() * pairs / (T * T)


def test_head_count_matches_the_counter():
    N, D, V = 12, 8, 40
    with FlopCounterMode(display=False) as fc:
        ops.cross_entropy(torch.randn(N, D), torch.randn(D, V),
                          torch.randint(0, V, (N,)))
    assert counts.k1_call(N, D, V).flops == fc.get_total_flops()


@pytest.mark.parametrize("kind", ("mamba2", "dense"))
def test_round_count_sums_the_blocks(kind):
    """A round: per block the prefix forward once (from scratch under a
    tied head, advanced otherwise) and the steps' forward and backward."""
    cell = tiny.cell(kind)
    fam, cfg, tr = cell.family, cell.config, cell.traffic
    decomps = memory.decompositions(fam, cfg, tr)
    unit = fam.unit_flops(cfg, tr["batch_size"], tr["seq_len"])
    want = 0.0
    for dec in decomps:
        prev = 0
        for lo, hi in dec.blocks:
            want += (lo if cfg.tie_embeddings else lo - prev) * unit
            prev = lo
            want += tr["local_steps"] * counts.step_flops(fam, cfg, tr, lo,
                                                          hi)
    assert counts.round_flops(fam, cfg, tr, decomps) == pytest.approx(want)
    assert counts.k3_call(1, 1, 1, 1, 1).flops == 8.0


def test_every_bound_is_a_share_of_the_same_peaks():
    w = counts.Work(counts.PEAK_FLOPS, 0.0)
    assert w.bound_s() == 1.0
    assert counts.Work(0.0, counts.PEAK_BYTES * 2).bound_s() == 2.0
    assert counts.PEAK_FLOPS == 495e12 / 3
