"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

The CUDA kernels have no CPU mode, so these skip without a card.  On the
card (which has no JAX) run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on ragged shapes
(K2 max abs error <= 1e-4, K1 loss relative error <= 1e-5, K3 and K4
|a - b| <= 1e-4 + 1e-4 |b| on the output and the final state); K2's
3xTF32 products and K4 at a decay near 1 sit no farther from the plain
version in float64 than 2x the fp32 plain version; a tied
head (``embed.T``) runs through the CE op with its loss and gradients
equal to the plain version's; one FeDepth round of each ported family on
the card is held against the same round on the CPU (atol 1e-4, rtol 1e-3:
fp32, different kernels and summation order).  The image path (PreResNet-20
through cuDNN, no kernel of the port) is held to the CPU the same way:
the full model's loss and every gradient (atol 1e-5, rtol 1e-4, on inputs
whose ReLU inputs take the same branch on both devices), and one round of
each image method on the reduced config (atol 1e-4, rtol 1e-3), with no
kernel launched.  So are the reduced ViT's loss and gradients (atol 1e-5,
rtol 1e-4) and one stacked (vectorized) FeDepth group update of the
reduced PreResNet and ViT (atol 1e-4, rtol 1e-3), and of reduced
qwen2-7b, mamba2-370m, rwkv6-7b and whisper-small (the kernels' vmap
rules: K1, K3 and K4 grouped, K2 folded); the grouped kernels against
their grouped plain versions and, bitwise, against each group's own
ungrouped launch.  Serving: each
family's reduced prefill and 8 decode steps on the card against the CPU
(K2 on the dense, vlm and hybrid prefills, K3 / K4 on every ssm and
hybrid decode step; the MoE family's decode at a capacity of 1 an
expert); reduced whisper's loss, gradients, prefill and decode steps (K2
non-causal, causal and cross, K1 on the tied head).  The wire: one
FeDepth round under ``fp16`` and ``qsgd_int8`` on the card against the
CPU (equal bytes, payloads decoded onto the card).  System time and
checkpoints: a CUDA state and aux blob through ``EngineCheckpointer``
(device and dtype kept), two async server versions of reduced mamba2
on the card against the CPU (the same trace, atol 1e-4 / rtol 1e-3), and
a fault's damage of a mamba2 payload on the card equal to the CPU's,
bitwise, in fp32 and bf16.  Scale and observability: a ``SpillStore``
entry of CUDA tensors spilled and reloaded on the card in its dtype,
bitwise; the memory auditor measuring a step on the card.  The launch
path: one ``launch.steps`` train step (clip active, accumulation 1 and 2)
of reduced yi-6b and mamba2-370m on the card against the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.preresnet20 import CONFIG as RESNET20  # noqa: E402
from repro_torch.configs.preresnet20 import reduced  # noqa: E402
from repro_torch.configs.vit_t16 import reduced as vit_reduced  # noqa: E402
from repro_torch.core import blockwise  # noqa: E402
from repro_torch.core.decomposition import Decomposition  # noqa: E402
from repro_torch.fl import baselines  # noqa: E402
from repro_torch.fl.data import build_federated  # noqa: E402
from repro_torch.fl.engine import RoundEngine, SimConfig, build_context  # noqa: E402
from repro_torch.fl.registry import get_strategy  # noqa: E402
from repro_torch.fl.seq import build_lm_context, build_seq_data  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.chunked_ce import (chunked_cross_entropy,  # noqa: E402
                                            cross_entropy_rows)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.mamba2_ssd import mamba2_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402
from repro_torch.models import (build, init_cache, resnet, vit,  # noqa: E402
                                whisper)
from repro_torch.testing.relu import resnet_gradients_on  # noqa: E402
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
    # the tensor-core tiling: D 36 (reduced) and 100 zero-padded in shared
    # memory; D 30 with 4-byte copies; Tq = 1 at a large q_offset; Tq and
    # Tk no multiple of the 64-row q or 32-row kv tile; windows across
    # tile edges
    (2, 45, 45, 4, 2, 36, True, 0, 0),
    (1, 33, 57, 4, 4, 100, False, 0, 0),
    (1, 20, 40, 2, 1, 30, True, 0, 20),
    (2, 1, 300, 8, 2, 128, True, 0, 299),
    (1, 77, 93, 28, 4, 128, True, 0, 16),
    (2, 256, 256, 7, 1, 128, True, 100, 0),
    (1, 130, 130, 4, 1, 64, True, 31, 3),
    # serving prefills: minicpm-2b's group of 1 (36 q and kv heads, D 64),
    # qwen2-vl-2b's 256 vision + 512 text tokens (12 / 2 heads, D 128),
    # yi-6b's group of 8 and h2o-danube-3-4b's D 120 under its window
    (1, 200, 200, 36, 36, 64, True, 0, 0),
    (4, 768, 768, 12, 2, 128, True, 0, 0),
    (4, 512, 512, 32, 4, 128, True, 0, 0),
    (4, 512, 512, 32, 8, 120, True, 4096, 0),
    # whisper-small: the encoder (non-causal, Tq = Tk = 1500, ragged
    # against every tile), cross-attention over its output from 256
    # decoder tokens and from one at decode; zamba2-1.2b's shared block
    (4, 1500, 1500, 12, 12, 64, False, 0, 0),
    (4, 256, 1500, 12, 12, 64, False, 0, 0),
    (4, 1, 1500, 12, 12, 64, False, 0, 0),
    (4, 256, 256, 32, 32, 64, True, 0, 0),
    # the paths' other shapes: zamba2's prefill; whisper's decoder in
    # training and prefill and its prefill's cross-attention; danube,
    # minicpm and qwen2-vl in training (a VLM client's 256 vision + 256
    # text tokens too); the engine's eval of 16 sequences
    (4, 512, 512, 32, 32, 64, True, 0, 0),
    (4, 256, 256, 12, 12, 64, True, 0, 0),
    (4, 64, 64, 12, 12, 64, True, 0, 0),
    (4, 64, 1500, 12, 12, 64, False, 0, 0),
    (4, 256, 256, 32, 8, 120, True, 4096, 0),
    (4, 256, 256, 36, 36, 64, True, 0, 0),
    (4, 256, 256, 12, 2, 128, True, 0, 0),
    (4, 512, 512, 12, 2, 128, True, 0, 0),
    (16, 256, 256, 28, 4, 128, True, 0, 0),
    (16, 256, 256, 32, 32, 64, True, 0, 0),
    (16, 256, 256, 32, 8, 120, True, 4096, 0),
    (16, 256, 256, 36, 36, 64, True, 0, 0),
    (16, 256, 256, 12, 2, 128, True, 0, 0),
]
CE_CASES = [
    # (N, D, V, share of labels ignored)
    (14, 16, 37, 0.0), (130, 24, 1000, 0.3), (5, 8, 20, 1.0),
    (300, 200, 4099, 0.1),
    # D not a multiple of 4 and V odd (4-byte copies), N not a multiple of
    # the 128-row block tile; then all labels ignored at that shape
    (333, 203, 1001, 0.25), (333, 203, 1001, 1.0),
    # D not a multiple of the 32-deep k slice, 16-byte copies
    (129, 100, 260, 0.0),
    (1024, 2048, 32000, 0.1),           # zamba2-1.2b's head
    (1024, 3840, 32000, 0.1),           # h2o-danube-3-4b's head
]
SSD_CASES = [
    # (B, T, H, P, N, dt scale, initial state)
    (2, 200, 4, 64, 128, 1.0, False),   # ragged T, the slice's P and N
    (1, 77, 3, 64, 128, 1.0, True),
    (2, 1, 4, 64, 128, 1.0, True),
    (1, 64, 2, 64, 128, 30.0, True),    # large steps: exp(A dt) underflows
    (2, 37, 8, 32, 16, 1.0, True),      # the reduced config's P and N
    (1, 1, 8, 32, 16, 1.0, True),
    (2, 133, 8, 64, 64, 1.0, True),     # zamba2-1.2b's P and N
    (2, 1, 8, 64, 64, 1.0, True),
    (1, 50, 3, 40, 24, 1.0, True),      # a ragged row block, padded state
    (1, 45, 2, 64, 256, 1.0, True),     # the widest state the block takes
    (1, 30, 2, 24, 18, 1.0, True),      # N % 4 != 0: 4-byte copies of B, C
    (4, 512, 32, 64, 128, 1.0, False),  # mamba2-370m's serving prefill
    (4, 1, 32, 64, 128, 1.0, True),     # its decode step
    (4, 256, 64, 64, 64, 1.0, False),   # zamba2-1.2b's mamba layers
    (4, 512, 64, 64, 64, 1.0, False),   # its serving prefill
    (4, 1, 64, 64, 64, 1.0, True),      # its decode step
    (16, 256, 32, 64, 128, 1.0, False),  # the engine's eval: mamba2-370m
    (16, 256, 64, 64, 64, 1.0, False),  # and zamba2-1.2b
]
WKV_CASES = [
    # (B, T, H, D, initial state, exp(w) overflows)
    (2, 200, 4, 64, False, False),
    (1, 77, 3, 64, True, False),
    (2, 1, 4, 64, True, False),
    (1, 64, 2, 64, True, True),
    (2, 37, 4, 32, True, False),
    # the 8 x 4 state tiles: the reduced D 32 at T 256; D 100 (rows padded
    # to 128); D 30 (4-byte copies, columns padded to 32); a ragged chunk
    (2, 256, 4, 32, True, False),
    (1, 50, 2, 100, True, False),
    (1, 40, 3, 30, True, False),
    (1, 33, 5, 64, True, False),
    (4, 512, 64, 64, False, False),     # rwkv6-7b's serving prefill
    (4, 1, 64, 64, True, False),        # its decode step
    (16, 256, 64, 64, False, False),    # the engine's eval
]
SCAN_TOL = 1e-4


def _assert_scan_close(outs, refs, case):
    for name, a, b in zip(("y", "final state"), outs, refs):
        bad = (a - b).abs() > SCAN_TOL + SCAN_TOL * b.abs()
        assert torch.isfinite(a).all() and not bad.any(), (case, name)


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


@pytest.mark.parametrize("case", SSD_CASES)
def test_mamba2_scan_matches_plain(cuda, case):
    B, T, H, P, N, dt_scale, with_s0 = case
    gen = torch.Generator(device=cuda).manual_seed(T + H)
    # large steps drive exp(A dt) to 0; x shrinks by the same factor so
    # that dt x, and so y's fp32 rounding, keep their size
    x = torch.randn(B, T, H, P, device=cuda, generator=gen) / dt_scale
    dt = torch.nn.functional.softplus(
        torch.randn(B, T, H, device=cuda, generator=gen)) * dt_scale
    A = -torch.exp(torch.randn(H, device=cuda, generator=gen))
    Bm, Cm = (torch.randn(B, T, N, device=cuda, generator=gen)
              for _ in range(2))
    D = torch.randn(H, device=cuda, generator=gen)
    s0 = (torch.randn(B, H, P, N, device=cuda, generator=gen) if with_s0
          else torch.zeros(B, H, P, N, device=cuda))
    before = mamba2_scan.launches
    outs = mamba2_scan(x, dt, A, Bm, Cm, D, s0)
    assert mamba2_scan.launches == before + 1
    _assert_scan_close(outs, ref.mamba2_scan(x, dt, A, Bm, Cm, D, s0), case)


@pytest.mark.parametrize("case", WKV_CASES)
def test_rwkv6_scan_matches_plain(cuda, case):
    B, T, H, D, with_s0, overflow = case
    gen = torch.Generator(device=cuda).manual_seed(T + H)
    r, k, v = (torch.randn(B, T, H, D, device=cuda, generator=gen)
               for _ in range(3))
    w = torch.randn(B, T, H, D, device=cuda, generator=gen) * 0.5 - 0.5
    if overflow:     # exp(w) = inf: the decay is exactly 0, never NaN
        w[:, ::3] = 100.0
    u = torch.randn(H, D, device=cuda, generator=gen) * 0.1
    s0 = (torch.randn(B, H, D, D, device=cuda, generator=gen) if with_s0
          else torch.zeros(B, H, D, D, device=cuda))
    before = rwkv6_scan.launches
    outs = rwkv6_scan(r, k, v, w, u, s0)
    assert rwkv6_scan.launches == before + 1
    _assert_scan_close(outs, ref.rwkv6_scan(r, k, v, w, u, s0), case)


def _f64_distances(kernel, plain, args):
    """(kernel's, fp32 plain version's) largest distance from the plain
    version run in float64, over every output."""
    exact = plain(*(a.double() for a in args))
    return tuple(max(float((x.double() - e).abs().max())
                     for x, e in zip(fn(*args), exact))
                 for fn in (kernel, plain))


@pytest.mark.parametrize("case", [(2, 128, 128, 14, 2, 128, True, 0, 0),
                                  (1, 70, 150, 7, 1, 120, True, 33, 80)])
def test_flash_attention_as_close_to_float64_as_fp32(cuda, case):
    """The 3xTF32 split keeps fp32 accuracy: no farther from float64 than
    2x the fp32 plain version."""
    B, Tq, Tk, Hq, Hkv, D, causal, window, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(Tq + Tk)
    q = torch.randn(B, Tq, Hq, D, device=cuda, generator=gen)
    k, v = (torch.randn(B, Tk, Hkv, D, device=cuda, generator=gen)
            for _ in range(2))
    opts = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    e_kernel, e_plain = _f64_distances(
        lambda *a: (flash_attention(*a, **opts),),
        lambda *a: (ref.attention(*a, **opts),), (q, k, v))
    assert e_kernel <= 2.0 * e_plain, (case, e_kernel, e_plain)


def test_rwkv6_scan_decay_near_one_against_float64(cuda):
    """w << 0: the decay is ~1, the state sums all 256 steps, and the
    kernel stays no farther from float64 than 2x the fp32 plain scan."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    B, T, H, D = 2, 256, 4, 64
    r, k, v = (torch.randn(B, T, H, D, device=cuda, generator=gen)
               for _ in range(3))
    w = torch.randn(B, T, H, D, device=cuda, generator=gen) * 0.5 - 8.5
    u = torch.randn(H, D, device=cuda, generator=gen) * 0.1
    s0 = torch.randn(B, H, D, D, device=cuda, generator=gen)
    e_kernel, e_plain = _f64_distances(rwkv6_scan, ref.rwkv6_scan,
                                       (r, k, v, w, u, s0))
    assert e_kernel <= 2.0 * e_plain, (e_kernel, e_plain)


@pytest.mark.parametrize("N,D,V", [(300, 200, 1000), (64, 96, 50288),
                                   (333, 203, 1001), (256, 768, 51865),
                                   (1024, 2304, 122753),    # minicpm-2b
                                   (1024, 1536, 151936)])   # qwen2-vl-2b
def test_tied_head_cross_entropy_matches_plain(cuda, N, D, V):
    """A tied head is ``embed.T``, a transposed view: the kernel reads the
    (V, D) table in place, and the gradient reaches ``embed``."""
    gen = torch.Generator(device=cuda).manual_seed(V)
    h0 = torch.randn(1, N, D, device=cuda, generator=gen)
    e0 = torch.randn(V, D, device=cuda, generator=gen) / D ** 0.5
    labels = torch.randint(0, V, (1, N), device=cuda, generator=gen)
    labels[:, ::5] = -100
    got = {}
    for name, fn in (("kernel", lambda h, e: ops.cross_entropy(h, e.T,
                                                                labels)[0]),
                     ("plain", lambda h, e: ref.cross_entropy_logits(
                         h, e.T, labels)[0])):
        h, e = h0.clone().requires_grad_(), e0.clone().requires_grad_()
        before = chunked_cross_entropy.launches
        loss = fn(h, e)
        launched = chunked_cross_entropy.launches - before
        assert launched == (name == "kernel")
        got[name] = (loss, *torch.autograd.grad(loss, (h, e)))
    (lk, dhk, dek), (lp, dhp, dep) = got["kernel"], got["plain"]
    assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item())
    assert float(dek.abs().max()) > 0
    torch.testing.assert_close(dhk, dhp, atol=1e-6, rtol=1e-4)
    torch.testing.assert_close(dek, dep, atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("N,D,V,ignored", [(333, 203, 1001, 0.25),
                                           (130, 203, 1001, 1.0),
                                           (129, 100, 260, 0.0)])
def test_cross_entropy_op_gradients_match_plain(cuda, N, D, V, ignored):
    """Through ``ops.cross_entropy`` (kernel forward, plain backward) on
    the kernel's ragged tilings: the loss and both gradients equal the
    plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(N + D)
    h0 = torch.randn(1, N, D, device=cuda, generator=gen)
    w0 = torch.randn(D, V, device=cuda, generator=gen) / D ** 0.5
    labels = torch.randint(0, V, (1, N), device=cuda, generator=gen)
    labels[torch.rand(1, N, device=cuda, generator=gen) < ignored] = -100
    got = {}
    for name, fn in (("kernel", ops.cross_entropy),
                     ("plain", ref.cross_entropy_logits)):
        h, w = h0.clone().requires_grad_(), w0.clone().requires_grad_()
        loss = fn(h, w, labels)[0]
        got[name] = (loss, *torch.autograd.grad(loss * 1.7, (h, w),
                                                allow_unused=True))
    (lk, dhk, dwk), (lp, dhp, dwp) = got["kernel"], got["plain"]
    assert abs(lk.item() - lp.item()) <= 1e-5 * max(abs(lp.item()), 1e-30)
    for a, b in ((dhk, dhp), (dwk, dwp)):
        if b is None:     # every label ignored: no path to the inputs
            assert a is None or not a.abs().any()
        else:
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)


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
    with pytest.raises(ValueError):    # neither (D, V) nor a (V, D) table
        chunked_cross_entropy(h, torch.randn(2, 10, device=cuda)[:, ::2],
                              labels)
    x = torch.randn(1, 4, 2, 8, device=cuda)
    dt, hv, bc = torch.ones(1, 4, 2, device=cuda), torch.ones(2, device=cuda), \
        torch.randn(1, 4, 16, device=cuda)
    with pytest.raises(TypeError):
        mamba2_scan(x.double(), dt, hv, bc, bc, hv)
    with pytest.raises(ValueError):    # same shape, not contiguous
        mamba2_scan(x, dt, hv, torch.randn(1, 4, 32, device=cuda)[..., ::2],
                    bc, hv)
    with pytest.raises(ValueError):    # a state wider than the block holds
        wide = torch.randn(1, 4, 2048, device=cuda)
        mamba2_scan(x, dt, hv, wide, wide, hv)
    r = torch.randn(1, 4, 2, 8, device=cuda)
    u = torch.randn(2, 8, device=cuda)
    with pytest.raises(TypeError):
        rwkv6_scan(r, r, r, r.double(), u)
    with pytest.raises(ValueError):
        rwkv6_scan(r, torch.randn(1, 4, 2, 16, device=cuda)[..., ::2], r, r,
                   u)
    with pytest.raises(ValueError):
        rwkv6_scan(r, r, r, r, u[:1])


PATH_KERNELS = {"qwen2-7b": (flash_attention, chunked_cross_entropy),
                "mamba2-370m": (mamba2_scan, chunked_cross_entropy),
                "rwkv6-7b": (rwkv6_scan, chunked_cross_entropy),
                "zamba2-1.2b": (mamba2_scan, flash_attention,
                                chunked_cross_entropy),
                "qwen3-moe-235b-a22b": (flash_attention,
                                        chunked_cross_entropy),
                "llama4-maverick-400b-a17b": (flash_attention,
                                              chunked_cross_entropy)}


@pytest.mark.parametrize("arch", sorted(PATH_KERNELS))
def test_round_on_the_card_matches_the_cpu(cuda, arch):
    """One FeDepth round of the reduced model (4 layers; zamba2's two
    groups; llama4's two units of a dense and a MoE layer) through the
    CUDA kernels equals the same round on the CPU."""
    cfg = dataclasses.replace(get_reduced_config(arch), num_layers=4)
    sim = SimConfig(rounds=1, participation=0.5, lr=0.05, local_steps=1,
                    batch_size=4, seed=0)
    init = build(cfg).init(0, device="cpu")
    before = [fn.launches for fn in PATH_KERNELS[arch]]
    states = {}
    for dev in ("cpu", "cuda"):
        data = build_seq_data(6, n_per_client=12, n_test=8,
                              vocab_size=cfg.vocab_size, seq_len=16,
                              device=dev)
        ctx = build_lm_context(data, sim, cfg, device=dev)
        states[dev], _ = RoundEngine(get_strategy("fedepth"), ctx).run(
            initial_state=tree_map(lambda t: t.to(dev), init))
    for fn, n in zip(PATH_KERNELS[arch], before):
        assert fn.launches > n, fn.__name__
    for a, b in zip(tree_leaves(states["cuda"]), tree_leaves(states["cpu"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3)


KERNELS = (flash_attention, chunked_cross_entropy, mamba2_scan, rwkv6_scan)


SERVE_ARCHS = ["yi-6b", "h2o-danube-3-4b", "minicpm-2b", "qwen2-vl-2b",
               "mamba2-370m", "rwkv6-7b", "qwen3-moe-235b-a22b",
               "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced model's prefill (K2 on the dense and vlm families) and
    8 decode steps on the card against the CPU, each step from the CPU's
    cache (a bf16 entry on a rounding boundary may round either way, and
    carried on it would move later steps): logits atol 1e-4 / rtol 1e-3,
    fp32 cache leaves atol 1e-5 / rtol 1e-4, bf16 leaves at most one bf16
    ulp beyond that.  The MoE archs carry fp32 cache leaves, as zamba2's
    test does: their card read a new bf16 K / V entry rounded the other
    way at one step, moving its logits by ~2e-4.  Decode launches K3 / K4
    on the ssm family, K2 on none."""
    cfg = get_reduced_config(arch)
    lm = build(cfg)
    params = lm.init(0, device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    before = [fn.launches for fn in KERNELS]
    got = lm.prefill(on_card, {"tokens": toks.to(cuda)})
    want = lm.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-4)
    assert (flash_attention.launches > before[0]) == (cfg.family != "ssm")
    cache = init_cache(cfg, 2, 12, device="cpu")
    if cfg.family == "moe":
        cache = {k: v.float() for k, v in cache.items()}
    scan = mamba2_scan if cfg.ssm_kind == "mamba2" else rwkv6_scan
    for t in range(8):
        before = [fn.launches for fn in KERNELS]
        tok = toks[:, t:t + 1]
        got, card_cache = lm.decode_step(
            on_card, tok.to(cuda), tree_map(lambda c: c.to(cuda), cache), t)
        want, cache = lm.decode_step(params, tok, cache, t)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4, rtol=1e-3)
        for k, c in cache.items():
            a, b = card_cache[k].cpu().float(), c.float()
            assert card_cache[k].dtype == c.dtype, k
            tol = 1e-5 + 1e-4 * b.abs()
            if c.dtype == torch.bfloat16:
                tol = tol + torch.maximum(a.abs(), b.abs()) * 2.0 ** -7
            assert ((a - b).abs() <= tol).all(), (arch, t, k)
        assert flash_attention.launches == before[0]
        if cfg.family == "ssm":
            assert scan.launches > before[KERNELS.index(scan)]


def test_zamba2_serving_on_the_card_matches_the_cpu(cuda):
    """Reduced zamba2's prefill (K2 and K3) and 8 decode steps (K3 at
    T = 1 in every mamba layer, K2 on none) on the card against the CPU,
    every cache leaf in fp32 and each step from the CPU's cache: a new
    bf16 K / V entry on a rounding boundary may round either way on the
    two sides and move that step's logits by ~1e-3, so the bf16 leaves
    would hold rounding, not the step.  Logits atol 1e-5 / rtol 1e-4
    (prefill) and atol 1e-4 / rtol 1e-3 (decode), cache leaves atol 1e-5
    / rtol 1e-4."""
    cfg = get_reduced_config("zamba2-1.2b")
    lm = build(cfg)
    params = lm.init(0, device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    before = [fn.launches for fn in KERNELS]
    got = lm.prefill(on_card, {"tokens": toks.to(cuda)})
    np.testing.assert_allclose(got.cpu().numpy(), lm.prefill(
        params, {"tokens": toks}).numpy(), atol=1e-5, rtol=1e-4)
    assert flash_attention.launches > before[0]
    assert mamba2_scan.launches > before[2]
    cache = {k: v.float() for k, v in init_cache(cfg, 2, 12,
                                                 device="cpu").items()}
    for t in range(8):
        before = [fn.launches for fn in KERNELS]
        tok = toks[:, t:t + 1]
        got, card_cache = lm.decode_step(
            on_card, tok.to(cuda), tree_map(lambda c: c.to(cuda), cache), t)
        assert flash_attention.launches == before[0]
        assert mamba2_scan.launches > before[2]
        want, cache = lm.decode_step(params, tok, cache, t)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4, rtol=1e-3)
        for k, c in cache.items():
            np.testing.assert_allclose(card_cache[k].cpu().numpy(),
                                       c.numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=f"step {t} {k}")


def test_vlm_loss_on_the_card_matches_the_cpu(cuda):
    """Reduced qwen2-vl's loss with a vision prefix (no loss on it: the
    text's hidden states sliced off, made contiguous for K1) and every
    gradient, card against CPU: loss atol 1e-5 / rtol 1e-4, gradients
    atol 1e-4 / rtol 1e-3; K1 and K2 launch."""
    cfg = get_reduced_config("qwen2-vl-2b")
    lm = build(cfg)
    params = lm.init(0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 13), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "vision_embeds": torch.randn(2, cfg.frontend_embed_tokens,
                                          cfg.d_model, generator=gen)}
    before = [fn.launches for fn in KERNELS]
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
        loss, _ = lm.loss_fn(p, tree_map(lambda t: t.to(dev), batch))
        out[dev] = [t.detach().cpu() for t in (
            loss, *torch.autograd.grad(loss, tree_leaves(p)))]
    assert flash_attention.launches > before[0]
    assert chunked_cross_entropy.launches > before[1]
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        tol = (1e-5, 1e-4) if i == 0 else (1e-4, 1e-3)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol[0],
                                   rtol=tol[1])


def test_preresnet20_on_the_card_matches_the_cpu(cuda):
    """Full PreResNet-20 (32 x 32, widths 16 / 32 / 64): logits, CE loss
    and every parameter's gradient on the card (cuDNN, TF32 off) equal
    the CPU's.  The batch is the first of ten seeded ones whose ReLU
    inputs all take the same branch on both devices (a ReLU input within
    rounding of 0 may not, and then the gradients differ there by
    design)."""
    _, out = resnet_gradients_on(resnet.init(0, RESNET20, device="cpu"),
                                 RESNET20)
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


def test_preresnet20_turns_tf32_off_itself(cuda):
    """From PyTorch's defaults (TF32 on for cuDNN's convolutions), a
    PreResNet forward on the card turns TF32 off before its first conv,
    so its logits and gradients still equal the CPU's in fp32; the
    parameters reach the card by hand, not through an entry point."""
    torch.backends.cudnn.allow_tf32 = True
    cfg = reduced(num_classes=10, image_size=32)
    _, out = resnet_gradients_on(resnet.init(1, cfg, device="cpu"), cfg)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("method,scenario", [
    ("fedepth", "fair"), ("m-fedepth", "fair"), ("fedepth", "surplus"),
    ("fedavg", "fair"), ("heterofl", "fair"), ("depthfl", "fair")])
def test_image_round_on_the_card_matches_the_cpu(cuda, method, scenario):
    """One round of each image method on the reduced PreResNet (8 clients,
    16 x 16 images) on the card equals the same round on the CPU; the
    path launches none of the port's kernels."""
    cfg = reduced(num_classes=10, image_size=16)
    sim = SimConfig(rounds=1, participation=0.5, lr=0.05, local_steps=1,
                    batch_size=32, scenario=scenario, seed=0)
    before = [fn.launches for fn in KERNELS]
    states, init = {}, None
    for dev in ("cpu", "cuda"):
        data = build_federated(num_clients=8, n_train=640, n_test=64,
                               image_size=16, seed=0, device=dev)
        ctx = build_context(data, sim, model_cfg=cfg, device=dev)
        strategy = get_strategy(method)
        if init is None:
            getattr(strategy, "setup", lambda _: None)(ctx)
            init = strategy.init_state(ctx)
        states[dev], hist = RoundEngine(strategy, ctx).run(
            initial_state=tree_map(lambda t: t.to(dev), init))
        assert 0.0 <= hist[-1].accuracy <= 1.0
    assert [fn.launches for fn in KERNELS] == before
    for a, b in zip(tree_leaves(states["cuda"]), tree_leaves(states["cpu"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("codec", ["fp16", "qsgd_int8"])
def test_codec_round_on_the_card_matches_the_cpu(cuda, codec):
    """One FeDepth round of the reduced PreResNet under a lossy codec
    (error feedback on) and the delta downlink: the payloads decode back
    onto the card, the bytes equal the CPU's, and the state equals the
    CPU's round (atol 1e-4, rtol 1e-3)."""
    cfg = reduced(num_classes=10, image_size=16)
    sim = SimConfig(rounds=1, participation=0.5, lr=0.05, local_steps=1,
                    batch_size=32, seed=0)
    states, hists, init = {}, {}, None
    for dev in ("cpu", "cuda"):
        data = build_federated(num_clients=8, n_train=640, n_test=64,
                               image_size=16, seed=0, device=dev)
        ctx = build_context(data, sim, model_cfg=cfg, device=dev)
        strategy = get_strategy("fedepth")
        if init is None:
            strategy.setup(ctx)
            init = strategy.init_state(ctx)
        states[dev], hists[dev] = RoundEngine(
            strategy, ctx, codec=codec, downlink="delta").run(
                initial_state=tree_map(lambda t: t.to(dev), init))
    assert [(r.comm_bytes, r.down_bytes) for r in hists["cuda"]] == \
        [(r.comm_bytes, r.down_bytes) for r in hists["cpu"]]
    for a, b in zip(tree_leaves(states["cuda"]), tree_leaves(states["cpu"])):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3)


def _client_update(method, params, aux, cfg, batches):
    kw = dict(lr=0.05, momentum=0.9, local_steps=2)
    if method == "heterofl":
        return baselines.heterofl_local(cfg, params, 1 / 3, batches, **kw)
    return baselines.depthfl_local(cfg, params, aux, cfg.num_blocks,
                                   batches, **kw)[:2]


@pytest.mark.parametrize("method", ["heterofl", "depthfl"])
def test_baseline_client_update_on_the_card_matches_the_cpu(cuda, method):
    """One HeteroFL client update (the x1/3 slice: widths 3 / 5 / 11 of
    the reduced model, group norm at 3, 5 and 1 groups) and one DepthFL
    client update (full depth: the aux exit and the head) on the card
    equal the same updates on the CPU, with no kernel launched."""
    cfg = reduced(num_classes=10, image_size=16)
    params = resnet.init(2, cfg, device="cpu")
    aux = baselines.depthfl_init_aux(cfg, torch.Generator().manual_seed(3),
                                     device="cpu")
    gen = torch.Generator().manual_seed(4)
    batches = [{"images": torch.randn(8, 16, 16, 3, generator=gen),
                "labels": torch.randint(0, 10, (8,), generator=gen)}
               for _ in range(2)]
    before = [fn.launches for fn in KERNELS]
    out = {dev: _client_update(method, *(tree_map(lambda t: t.to(dev), x)
                                         for x in (params, aux)),
                               cfg, tree_map(lambda t: t.to(dev), batches))
           for dev in ("cpu", "cuda")}
    assert [fn.launches for fn in KERNELS] == before
    for a, b in zip(tree_leaves(out["cuda"]), tree_leaves(out["cpu"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3)


def test_depthfl_lm_round_launches_k1_and_k2(cuda):
    """One DepthFL round of the reduced qwen2 (4 layers, every client in
    the cohort: prefixes of 4 layers and of 1) launches the CE and the
    attention kernels and equals the same round on the CPU."""
    cfg = dataclasses.replace(get_reduced_config("qwen2-7b"), num_layers=4)
    sim = SimConfig(rounds=1, participation=1.0, lr=0.05, local_steps=1,
                    batch_size=4, seed=0)
    init = build(cfg).init(0, device="cpu")
    before = [fn.launches for fn in PATH_KERNELS["qwen2-7b"]]
    states = {}
    for dev in ("cpu", "cuda"):
        data = build_seq_data(6, n_per_client=12, n_test=8,
                              vocab_size=cfg.vocab_size, seq_len=16,
                              device=dev)
        ctx = build_lm_context(data, sim, cfg, device=dev)
        strategy = get_strategy("depthfl")
        states[dev], _ = RoundEngine(strategy, ctx).run(
            initial_state=tree_map(lambda t: t.to(dev), init))
        assert set(strategy.depths) == {1, 4}
    for fn, n in zip(PATH_KERNELS["qwen2-7b"], before):
        assert fn.launches > n, fn.__name__
    for a, b in zip(tree_leaves(states["cuda"]), tree_leaves(states["cpu"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3)


def test_reduced_vit_on_the_card_matches_the_cpu(cuda):
    """The reduced ViT (4 layers, d_model 64, 2 heads): logits, CE loss
    and every parameter's gradient on the card (fp32 matmuls) equal the
    CPU's; no kernel of the port is launched (its attention is plain
    PyTorch)."""
    cfg = vit_reduced(num_classes=10)
    params = vit.init(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(8, 16, 16, 3, generator=gen)
    labels = torch.randint(0, 10, (8,), generator=gen)
    before = [fn.launches for fn in KERNELS]
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
        logits = vit.apply(p, cfg, images.to(dev))
        loss = blockwise._ce_logits(logits, labels.to(dev))
        grads = torch.autograd.grad(loss, tree_leaves(p))
        out[dev] = [t.detach().cpu() for t in (logits, loss, *grads)]
    assert [fn.launches for fn in KERNELS] == before
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("family", ["resnet", "vit"])
def test_group_update_on_the_card_matches_the_cpu(cuda, family):
    """One stacked FeDepth group update (three clients, blocks [0, 1) and
    [1, 3), two local steps over two batches; ``vmap(grad)`` and, for
    PreResNet, per-client grouped convolutions) on the card equals the
    same update on the CPU, with no kernel launched."""
    if family == "vit":
        cfg = vit_reduced(num_classes=10)
        runner, params = blockwise.vit_runner(cfg), vit.init(
            2, cfg, device="cpu")
    else:
        cfg = reduced(num_classes=10, image_size=16)
        runner, params = blockwise.resnet_runner(cfg), resnet.init(
            2, cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    bpc = [[{"images": torch.randn(8, 16, 16, 3, generator=gen),
             "labels": torch.randint(0, 10, (8,), generator=gen)}
            for _ in range(2)] for _ in range(3)]
    dec = Decomposition(((0, 1), (1, 3)), 0, 0)
    before = [fn.launches for fn in KERNELS]
    out = {dev: blockwise.client_update_batched(
        runner, tree_map(lambda t: t.to(dev), params), dec,
        tree_map(lambda t: t.to(dev), bpc), lr=0.05, momentum=0.9,
        local_steps=2) for dev in ("cpu", "cuda")}
    assert [fn.launches for fn in KERNELS] == before
    for a, b in zip(tree_leaves(out["cuda"]), tree_leaves(out["cpu"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-370m", "rwkv6-7b",
                                  "whisper-small"])
def test_stacked_lm_group_update_on_the_card_matches_the_cpu(cuda, arch):
    """One stacked FeDepth group update of a reduced LM (three clients,
    two blocks, two batches; ``vmap(grad)`` through the kernels' vmap
    rules: K1 grouped, K2 folded, K3 / K4 grouped) on the card equals
    the same update on the CPU (the grouped plain versions), atol 1e-4 /
    rtol 1e-3; the path's kernels launch."""
    cfg = get_reduced_config(arch)
    lm = build(cfg)
    params = lm.init(0, device="cpu")
    runner = blockwise.lm_runner(lm)
    gen = torch.Generator().manual_seed(6)

    def batch():
        toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.is_encoder_decoder:
            b["encoder_embeds"] = torch.randn(
                2, cfg.max_source_positions, cfg.d_model, generator=gen)
        return b

    bpc = [[batch() for _ in range(2)] for _ in range(3)]
    dec = Decomposition(((0, 1), (1, runner.n_units)), 0, 0)
    before = [fn.launches for fn in KERNELS]
    out = {dev: blockwise.client_update_batched(
        runner, tree_map(lambda t: t.to(dev), params), dec,
        tree_map(lambda t: t.to(dev), bpc), lr=0.05, momentum=0.9)
        for dev in ("cpu", "cuda")}
    launched = [fn.launches - n for fn, n in zip(KERNELS, before)]
    assert launched[1] > 0 and any(launched[i] for i in (0, 2, 3))
    for a, b in zip(tree_leaves(out["cuda"]), tree_leaves(out["cpu"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("groups", [1, 3])
def test_grouped_kernels_match_plain_and_their_groups(cuda, groups):
    """K1 (a (G, D, V) head and a tied (G, V, D) table), K3 ((G, H) A, D)
    and K4 ((G, H, D) u) in one grouped launch: within the kernels'
    tolerances of the grouped plain versions, and each group's rows
    bitwise its own ungrouped launch (groups=1: the (1, ...) parameter
    launch is today's)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    G, Bg, T = groups, 2, 37
    B = G * Bg

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def rows(t, g):
        return t[g * Bg:(g + 1) * Bg]

    D, V = 203, 1001
    h = rn(B, T, D)
    labels = torch.randint(0, V, (B, T), device="cuda", generator=gen)
    labels[:, ::5] = -100
    for w in (rn(G, D, V) / D ** 0.5,
              (rn(G, V, D) / D ** 0.5).transpose(1, 2)):
        nll = cross_entropy_rows(h, w, labels)
        ref_rows = ref.cross_entropy_rows(h, w, labels)
        torch.testing.assert_close(nll, ref_rows, atol=1e-4, rtol=1e-5)
        for g in range(G):
            assert torch.equal(nll.reshape(G, -1)[g], cross_entropy_rows(
                rows(h, g), w[g], rows(labels, g)))
        means, n = chunked_cross_entropy(h, w, labels)
        assert means.shape == n.shape == (G,)
    H, P, N = 3, 40, 24
    args = (rn(B, T, H, P), torch.nn.functional.softplus(rn(B, T, H)),
            -torch.exp(rn(G, H)), rn(B, T, N), rn(B, T, N), rn(G, H),
            rn(B, H, P, N))
    outs, refs = mamba2_scan(*args), ref.mamba2_scan(*args)
    _assert_scan_close(outs, refs, f"mamba2 groups {G}")
    for g in range(G):
        one = mamba2_scan(*(a[g] if i in (2, 5) else rows(a, g)
                            for i, a in enumerate(args)))
        for a, b in zip(outs, one):
            assert torch.equal(rows(a, g), b)
    Dh = 30
    args = (rn(B, T, H, Dh), rn(B, T, H, Dh), rn(B, T, H, Dh),
            rn(B, T, H, Dh) * 0.5 - 0.5, rn(G, H, Dh) * 0.1,
            rn(B, H, Dh, Dh))
    outs, refs = rwkv6_scan(*args), ref.rwkv6_scan(*args)
    _assert_scan_close(outs, refs, f"rwkv6 groups {G}")
    for g in range(G):
        one = rwkv6_scan(*(a[g] if i == 4 else rows(a, g)
                           for i, a in enumerate(args)))
        for a, b in zip(outs, one):
            assert torch.equal(rows(a, g), b)


def test_whisper_on_the_card_matches_the_cpu(cuda):
    """Reduced whisper-small (2 + 2 layers, 64 frames): the loss and every
    gradient (K2 non-causal in the encoder, causal and cross in the
    decoder, K1 on the tied head), the prefill and 8 decode steps (K2
    cross at Tq = 1 every step, from the CPU's cache before it) on the
    card against the CPU: loss and prefill atol 1e-5 / rtol 1e-4,
    gradients and decode logits atol 1e-4 / rtol 1e-3."""
    cfg = get_reduced_config("whisper-small")
    lm = build(cfg)
    params = lm.init(0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 13), generator=gen)
    frames = torch.randn(2, cfg.max_source_positions, cfg.d_model,
                         generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "encoder_embeds": frames}
    before = [fn.launches for fn in KERNELS]
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
        loss, _ = lm.loss_fn(p, tree_map(lambda t: t.to(dev), batch))
        grads = torch.autograd.grad(loss, tree_leaves(p))
        with torch.no_grad():
            logits = lm.prefill(tree_map(lambda t: t.detach(), p),
                                {"tokens": batch["tokens"].to(dev),
                                 "encoder_embeds": frames.to(dev)})
        out[dev] = [t.detach().cpu() for t in (loss, logits, *grads)]
    launched = [fn.launches - n for fn, n in zip(KERNELS, before)]
    assert launched[0] > 0 and launched[1] > 0 and launched[2:] == [0, 0]
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        tol = (1e-5, 1e-4) if i < 2 else (1e-4, 1e-3)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol[0],
                                   rtol=tol[1])
    on_card = tree_map(lambda t: t.to(cuda), params)
    cache = init_cache(cfg, 2, 12, device="cpu")
    with torch.no_grad():
        cache["enc_out"] = whisper.encode(params, cfg, frames).to(
            cache["enc_out"].dtype)
    for t in range(8):
        before = flash_attention.launches
        tok = toks[:, t:t + 1]
        got, _ = lm.decode_step(on_card, tok.to(cuda),
                                tree_map(lambda c: c.to(cuda), cache), t)
        assert flash_attention.launches - before == cfg.num_layers
        want, cache = lm.decode_step(params, tok, cache, t)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4, rtol=1e-3)


def test_checkpointer_round_trip_keeps_device_and_dtype(cuda, tmp_path):
    """A CUDA server state (fp32 and bf16 leaves, a tuple) and an aux
    blob holding CUDA tensors (an error-feedback residual) come back
    from ``EngineCheckpointer`` on the card, each in its dtype, equal."""
    from repro_torch.fl.faults import EngineCheckpointer
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = {"w": torch.randn(3, 5, device=cuda, generator=gen),
             "h": torch.randn(7, device=cuda, generator=gen).bfloat16(),
             "pair": (torch.arange(4, device=cuda),
                      torch.ones(2, device=cuda))}
    aux = {"rng": np.random.default_rng(3).bit_generator.state,
           "ef": [[2, (None, {"w": torch.randn(3, 5, device=cuda,
                                               generator=gen)})]]}
    ck = EngineCheckpointer(str(tmp_path), every=1)
    ck.save(0, state, aux)
    rd, tree, back = ck.load_latest(device=cuda)
    assert rd == 0 and isinstance(tree["pair"], tuple)
    for a, b in zip(tree_leaves(tree), tree_leaves(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
    res = back["ef"][0][1][1]["w"]
    assert res.device.type == "cuda"
    assert torch.equal(res, aux["ef"][0][1][1]["w"])
    assert back["rng"] == aux["rng"]


def test_async_run_on_the_card_matches_the_cpu(cuda):
    """Two server versions of reduced mamba2 (4 layers) under the async
    ``AsyncEngine`` (concurrency 2, buffer 1, ``profiles_for_ratios``) on
    the card through K1 and K3 against the same run on the CPU: the same
    trace, bytes and sim seconds, parameters within atol 1e-4 / rtol
    1e-3."""
    from repro_torch.fl.systime import (AsyncEngine, SystemModel,
                                        profiles_for_ratios)
    cfg = dataclasses.replace(get_reduced_config("mamba2-370m"),
                              num_layers=4)
    sim = SimConfig(rounds=2, participation=0.5, lr=0.05, local_steps=1,
                    batch_size=4, seed=0)
    init = build(cfg).init(0, device="cpu")
    before = [mamba2_scan.launches, chunked_cross_entropy.launches]
    runs = {}
    for dev in ("cpu", "cuda"):
        data = build_seq_data(6, n_per_client=12, n_test=8,
                              vocab_size=cfg.vocab_size, seq_len=16,
                              device=dev)
        ctx = build_lm_context(data, sim, cfg, device=dev)
        eng = AsyncEngine(get_strategy("fedepth"), ctx, mode="async",
                          concurrency=2, buffer_size=1,
                          system=SystemModel(profiles_for_ratios(
                              ctx.ratios)))
        state, hist = eng.run(initial_state=tree_map(lambda t: t.to(dev),
                                                     init), eval_every=1)
        runs[dev] = (state, eng.trace, [(r.comm_bytes, r.down_bytes,
                                         r.sim_seconds) for r in hist])
    assert mamba2_scan.launches > before[0]
    assert chunked_cross_entropy.launches > before[1]
    assert runs["cuda"][1] == runs["cpu"][1]
    assert runs["cuda"][2] == runs["cpu"][2]
    for a, b in zip(tree_leaves(runs["cuda"][0]), tree_leaves(runs["cpu"][0])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_damage_on_the_card_equals_the_cpu(cuda, dtype):
    """``FaultInjector.damage_tree`` on a reduced mamba2 payload (stacked
    wire leaves) on the card: the same coordinates and values as on the
    CPU, bitwise, the copies on the card in the payload's dtype, the
    original unwritten."""
    from repro_torch.fl.faults import Fault, FaultInjector, FaultPlan
    params = tree_map(lambda t: t.to(dtype),
                      build(get_reduced_config("mamba2-370m")).init(
                          0, device="cpu"))
    on_card = tree_map(lambda t: t.to(cuda), params)
    inj = FaultInjector(FaultPlan(seed=2, corrupt_frac=0.01))
    for kind in ("corrupt", "diverge"):
        fault = Fault(kind, 4, 1, 0)
        want = inj.damage_tree(params, fault)
        got = inj.damage_tree(on_card, fault)
        for a, b, c in zip(tree_leaves(got), tree_leaves(want),
                           tree_leaves(on_card)):
            assert a.device.type == "cuda" and a.dtype == dtype
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0,
                                       equal_nan=True)
            assert a.data_ptr() != c.data_ptr()
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(tree_leaves(on_card), tree_leaves(params)))


def test_spill_store_keeps_device_and_dtype(cuda, tmp_path):
    """A ``SpillStore`` entry of CUDA tensors (fp32 and bf16, an EF
    ``(tag, residual)`` pair) leaves the hot set to disk and comes back
    on the card in its dtype, bitwise; while resident it is the same
    object."""
    from repro_torch.fl.scale import SpillStore
    gen = torch.Generator(device=cuda).manual_seed(0)
    entry = ("tag", {"w": torch.randn(3, 5, device=cuda, generator=gen),
                     "h": torch.randn(7, device=cuda,
                                      generator=gen).bfloat16()})
    with SpillStore(1, dir=str(tmp_path)) as store:
        store["a"] = entry
        assert store.get("a") is entry
        store["b"] = 0
        assert store.spill_count == 1
        back = store.get("a")
        assert store.load_count == 1 and back[0] == "tag"
        for k in ("w", "h"):
            assert back[1][k].device.type == "cuda"
            assert back[1][k].dtype == entry[1][k].dtype
            assert torch.equal(back[1][k], entry[1][k])


def test_audit_measures_a_block_step_on_the_card(cuda):
    """The auditor measures a step on the card (the allocator's peak over
    the step plus the arguments' bytes), returns the step's own output,
    and keeps the peak it erased."""
    from repro_torch.obs import MemoryAuditor
    aud = MemoryAuditor()
    big = torch.empty(1 << 20, device=cuda)            # 4 MiB, then freed
    del big
    args = ({"w": torch.ones(256, 256, device=cuda)},
            {"images": torch.ones(8, 4, device=cuda)})
    out = aud.audit_block_step(lambda p, b: p["w"] @ p["w"], args,
                               family="resnet", lo=0, hi=1,
                               variant="buffered")
    assert torch.equal(out, args[0]["w"] @ args[0]["w"])
    (cell,) = aud.table()
    assert cell["status"] == "ok" and cell["batch"] == 8
    assert cell["temp_bytes"] >= 256 * 256 * 4
    assert cell["argument_bytes"] == (256 * 256 + 32) * 4
    assert aud.erased_peak >= 1 << 22


@pytest.mark.parametrize("arch,accum", [("yi-6b", 1), ("yi-6b", 2),
                                        ("mamba2-370m", 2)])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch, accum):
    """One ``launch.steps.make_train_step`` (clip active, lr 0.05) of a
    reduced LM on the card equals the same step on the CPU: loss and
    gnorm relative 1e-4, parameters and momentum atol 1e-6 / rtol 1e-4;
    both updated in place; K1 (and K2 or K3) launch."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    cfg = get_reduced_config(arch)
    lm = build(cfg)
    params = lm.init(0, device="cpu")
    vel = tree_map(torch.zeros_like, params)
    np_batch = next(TokenPipeline(cfg.vocab_size, 32, 4, seed=3).batches())
    step = make_train_step(lm, lr=0.05, accum_steps=accum)
    before = [fn.launches for fn in KERNELS]
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        v = tree_map(lambda t: t.to(dev, copy=True), vel)
        b = {k: torch.from_numpy(a).to(dev) for k, a in np_batch.items()}
        out[dev] = step(p, v, b)
        assert tree_leaves(out[dev][0])[0] is tree_leaves(p)[0]
    launched = [fn.launches - n for fn, n in zip(KERNELS, before)]
    assert launched[1] > 0 and any(launched[i] for i in (0, 2))
    (pc, vc, mc), (pg, vg, mg) = out["cpu"], out["cuda"]
    assert float(mc["gnorm"]) > 1.0
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(float(mg[key]), float(mc[key]),
                                   rtol=1e-4, err_msg=key)
    for a, b in zip(tree_leaves((pg, vg)), tree_leaves((pc, vc))):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-4)
