"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

The CUDA kernels have no CPU mode, so these skip without a card.  On the
card (which has no JAX) run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on ragged shapes
(K2 max abs error <= 1e-4, K1 loss relative error <= 1e-5); one FeDepth
round on the card is held against the same round on the CPU (atol 1e-4,
rtol 1e-3: fp32, different kernels and summation order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.fl.engine import RoundEngine, SimConfig  # noqa: E402
from repro_torch.fl.registry import get_strategy  # noqa: E402
from repro_torch.fl.seq import build_lm_context, build_seq_data  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.chunked_ce import chunked_cross_entropy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


ATTN_CASES = [
    # (B, Tq, Tk, Hq, Hkv, D, causal, window, q_offset)
    (2, 16, 16, 4, 2, 8, True, 0, 0),
    (1, 13, 13, 4, 2, 8, True, 0, 0),
    (1, 8, 21, 2, 1, 8, False, 0, 0),
    (2, 100, 100, 4, 2, 64, True, 5, 0),
    (1, 70, 150, 7, 1, 120, True, 33, 80),
    (1, 65, 65, 28, 4, 128, False, 0, 0),
]
CE_CASES = [
    # (N, D, V, share of labels ignored)
    (14, 16, 37, 0.0), (130, 24, 1000, 0.3), (5, 8, 20, 1.0),
    (300, 200, 4099, 0.1),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_matches_plain(cuda, case):
    B, Tq, Tk, Hq, Hkv, D, causal, window, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    q = torch.randn(B, Tq, Hq, D, device=cuda, generator=gen)
    k = torch.randn(B, Tk, Hkv, D, device=cuda, generator=gen)
    v = torch.randn(B, Tk, Hkv, D, device=cuda, generator=gen)
    opts = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **opts)
    assert flash_attention.launches == before + 1
    err = (out - ref.attention(q, k, v, **opts)).abs().max().item()
    assert err <= 1e-4, (case, err)


@pytest.mark.parametrize("case", CE_CASES)
def test_chunked_ce_matches_plain(cuda, case):
    N, D, V, ignored = case
    gen = torch.Generator(device=cuda).manual_seed(N + V)
    h = torch.randn(1, N, D, device=cuda, generator=gen)
    w = torch.randn(D, V, device=cuda, generator=gen) / D ** 0.5
    labels = torch.randint(0, V, (1, N), device=cuda, generator=gen)
    labels[torch.rand(1, N, device=cuda, generator=gen) < ignored] = -100
    before = chunked_cross_entropy.launches
    loss, n = chunked_cross_entropy(h, w, labels)
    assert chunked_cross_entropy.launches == before + 1
    ref_loss, ref_n = ref.cross_entropy_logits(h, w, labels)
    assert int(n) == int(ref_n)
    assert abs(loss.item() - ref_loss.item()) <= \
        1e-5 * max(abs(ref_loss.item()), 1e-30), case


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 8, 2, 16, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), q, q)
    big = torch.randn(1, 8, 2, 256, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(big, big, big)
    h, w = q[..., 0].contiguous(), torch.randn(2, 5, device=cuda)
    labels = torch.zeros(1, 8, dtype=torch.long, device=cuda)
    with pytest.raises(TypeError):
        chunked_cross_entropy(h.half(), w.half(), labels)
    with pytest.raises(ValueError):
        chunked_cross_entropy(h, w.cpu(), labels)


def test_round_on_the_card_matches_the_cpu(cuda):
    """One FeDepth round of reduced qwen2-7b (4 layers) through the CUDA
    kernels equals the same round on the CPU."""
    cfg = dataclasses.replace(get_reduced_config("qwen2-7b"), num_layers=4)
    sim = SimConfig(rounds=1, participation=0.5, lr=0.05, local_steps=1,
                    batch_size=4, seed=0)
    init = build(cfg).init(0, device="cpu")
    before = (flash_attention.launches, chunked_cross_entropy.launches)
    states = {}
    for dev in ("cpu", "cuda"):
        data = build_seq_data(6, n_per_client=12, n_test=8,
                              vocab_size=cfg.vocab_size, seq_len=16,
                              device=dev)
        ctx = build_lm_context(data, sim, cfg, device=dev)
        states[dev], _ = RoundEngine(get_strategy("fedepth"), ctx).run(
            initial_state=tree_map(lambda t: t.to(dev), init))
    assert flash_attention.launches > before[0]
    assert chunked_cross_entropy.launches > before[1]
    for a, b in zip(tree_leaves(states["cuda"]), tree_leaves(states["cpu"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3)
