"""The 3xTF32 split of the chunked-CE kernel, emulated on the CPU.

``src/repro_torch/kernels/csrc/chunked_ce.cu`` computes hidden @ lm_head on
the tensor cores as small*big + big*small + big*big: each fp32 operand
element x is split into big = tf32(x) and small = tf32(x - big), both
rounded to nearest (ties away) on the fp32 bit pattern to 10 mantissa
bits; every product of two TF32 values is exact in fp32; each 8-deep mma
sums into fp32, and each 32-deep k slice is summed from zero and added to
the running sum.  This test emulates that arithmetic in plain PyTorch
(the emulation lives here, not on the port's path) and holds, on inputs
made by numpy from a seed:

* its mean NLL to the JAX reference (``repro.kernels.ops.cross_entropy``,
  the jnp oracle and the Pallas body in interpret mode) within rel 1e-5,
  the card's tolerance against the fp32 plain version;
* each row's NLL no farther from the plain CE in float64 than 2x the fp32
  plain version's largest distance, the check ``chip_smoke.py`` makes on
  the card.

It argues the design's precision before a card runs it.  The emulation
sums each 8-deep product in fp32 with round to nearest; the tensor cores
truncate there instead, which the per-slice restart keeps small (the card
check measures it).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

RTOL = 1e-5          # emulated mean NLL vs the reference
F64_RATIO = 2.0      # per-row distance from float64, emulation vs fp32 plain
SLICE, MMA_K = 32, 8

torch.backends.cuda.matmul.allow_tf32 = False


def _tf32(a: np.ndarray) -> np.ndarray:
    """Round fp32 to TF32 (10 mantissa bits), nearest, ties away: add half
    of the 13 dropped bits to the bit pattern and clear them."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(a: np.ndarray):
    big = _tf32(a)
    return torch.from_numpy(big), torch.from_numpy(_tf32(a - big))


def emulated_logits(h: np.ndarray, w: np.ndarray) -> torch.Tensor:
    """(N, D) @ (D, V) as the kernel's 3xTF32 mma sequence computes it."""
    hb, hs = _split(h)
    wb, ws = _split(w)
    N, D = h.shape
    acc = torch.zeros(N, w.shape[1])
    for k0 in range(0, D, SLICE):
        part = torch.zeros_like(acc)
        for k in range(k0, min(k0 + SLICE, D), MMA_K):
            sl = slice(k, min(k + MMA_K, D))
            part = part + hs[:, sl] @ wb[sl]
            part = part + hb[:, sl] @ ws[sl]
            part = part + hb[:, sl] @ wb[sl]
        acc = acc + part
    return acc


def _rows(logits: torch.Tensor, labels: np.ndarray) -> torch.Tensor:
    lbl = torch.from_numpy(labels.reshape(-1)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lbl.clamp(min=0)[:, None])[:, 0]
    return torch.where(lbl >= 0, logz - gold, 0.0)


def _inputs(seed, B, T, D, V, ignore, tied):
    """hidden (B,T,D), the (D, V) head (for a tied head the transpose of a
    (V, D) table, as a model passes ``embed.T``) and labels."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, T, D)).astype(np.float32)
    if tied:
        table = (rng.standard_normal((V, D)) / np.sqrt(D)).astype(np.float32)
        w = table.T
    else:
        w = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    lbl = rng.integers(0, V, size=(B, T)).astype(np.int32)
    lbl[rng.random((B, T)) < ignore] = -100
    return h, w, lbl


CASES = {
    # name: (B, T, D, V, share of labels ignored, tied head)
    "ragged_d203_v1001": (2, 21, 203, 1001, 0.2, False),
    "tied_ragged_d150_v777": (3, 13, 150, 777, 0.1, True),
    "aligned_d256_v512": (2, 32, 256, 512, 0.0, False),
    "deep_d1000_v300": (1, 16, 1000, 300, 0.25, False),
}


@functools.lru_cache(maxsize=None)
def _emulated(case):
    B, T, D, V, ignore, tied = CASES[case]
    h, w, lbl = _inputs(sum(map(ord, case)), B, T, D, V, ignore, tied)
    rows = _rows(emulated_logits(h.reshape(B * T, D), w), lbl)
    return h, w, lbl, rows


@pytest.mark.parametrize("force", ["interpret", "ref"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_mean_nll_matches_reference(case, force):
    h, w, lbl, rows = _emulated(case)
    n = max(int((lbl >= 0).sum()), 1)
    loss = float(rows.sum()) / n
    kw = dict(block_t=16, block_v=128) if force == "interpret" else {}
    ref, n_ref = jax.jit(lambda a, b: jops.cross_entropy(
        a, b, lbl, force=force, **kw))(h, np.ascontiguousarray(w))
    assert int(n_ref) == n
    np.testing.assert_allclose(loss, float(ref), rtol=RTOL, atol=0,
                               err_msg=case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_rows_as_close_to_float64_as_fp32(case):
    h, w, lbl, rows = _emulated(case)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (h, w, lbl)]
    exact = tref.cross_entropy_rows(args[0].double(), args[1].double(),
                                    args[2])
    e_split = float((rows.double() - exact).abs().max())
    e_plain = float((tref.cross_entropy_rows(*args).double()
                     - exact).abs().max())
    assert e_split <= F64_RATIO * e_plain, (case, e_split, e_plain)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    """Nearest with ties away from zero, on either sign; exact values and
    zero stay; big + small recovers x to within 2^-22 of it."""
    step = 2.0 ** -10
    x = np.array([1 + step / 2, -(1 + step / 2), 1 + step / 2 - 2 ** -20,
                  1 + 3 * step, 0.0], np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.array([1 + step, -(1 + step), 1.0, 1 + 3 * step, 0.0],
                           np.float32))
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4096).astype(np.float32)
    big, small = _split(a)
    err = np.abs((big.double() + small.double()).numpy() - a)
    assert (err <= 2.0 ** -22 * np.abs(a)).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_tf32_product_would_fail_the_float64_check(case):
    """The check above can tell: a single TF32 product (what plain TF32
    tensor cores would give) lands two orders of magnitude beyond it."""
    h, w, lbl, _ = _emulated(case)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (h, w, lbl)]
    exact = tref.cross_entropy_rows(args[0].double(), args[1].double(),
                                    args[2])
    one = _rows(torch.from_numpy(_tf32(h.reshape(-1, h.shape[-1])))
                @ torch.from_numpy(_tf32(w)), lbl)
    e_one = float((one.double() - exact).abs().max())
    e_plain = float((tref.cross_entropy_rows(*args).double()
                     - exact).abs().max())
    assert e_one > 100 * F64_RATIO * e_plain, (case, e_one, e_plain)
