"""The 3xTF32 split of the flash-attention kernel, emulated on the CPU.

``src/repro_torch/kernels/csrc/flash_attention.cu`` computes both products
of attention on the tensor cores, S = (scale q) kᵀ and O = P V, as
small*big + big*small + big*big: each fp32 operand element x is split into
big = tf32(x) and small = tf32(x - big), both rounded to nearest (ties
away) on the fp32 bit pattern to 10 mantissa bits; every product of two
TF32 values is exact in fp32; each 8-deep mma sums into fp32, and each
32-deep slice (of D for S, one 32-row kv tile for O) is summed from zero
and added to the running sum.  The softmax is online, per 32-row kv tile
of a 16-row warp tile, over the kv tiles the kernel visits (the block's
64-row predicate, then the warp's own).  This test emulates that
arithmetic and that walk in plain PyTorch (the emulation lives here, not
on the port's path) and holds, on inputs made by numpy from a seed:

* its output to the JAX reference (``repro.kernels.ops.attention``, the
  jnp oracle and the Pallas body in interpret mode) within max abs 1e-4,
  the card's tolerance against the fp32 plain version;
* each row's largest distance from the plain attention in float64 to no
  more than 2x the fp32 plain version's largest, the check
  ``chip_smoke.py`` makes on the card;

and shows that a single TF32 pass fails that second check.  It argues
the design's precision before a card runs it.  The emulation sums each
8-deep product in fp32 with round to nearest; the tensor cores truncate
there instead, which the per-slice restart keeps small (the card check
measures it).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ATOL = 1e-4          # emulated output vs the reference, max abs
F64_RATIO = 2.0      # per-row distance from float64, emulation vs fp32 plain
BQ, WQ, BK = 64, 16, 32   # block q rows, warp q rows, kv rows per tile
SLICE, MMA_K = 32, 8
NEG_INF = -1e30

torch.backends.cuda.matmul.allow_tf32 = False


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (10 mantissa bits), nearest, ties away: add half
    of the 13 dropped bits to the bit pattern and clear them."""
    bits = a.contiguous().float().numpy().view(np.uint32)
    out = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.from_numpy(out.view(np.float32))


def _split(a: torch.Tensor):
    big = _tf32(a)
    return big, _tf32(a - big)


def _product(a, b, passes):
    """a (.., M, K) @ b (.., K, N) in 8-deep fp32 mma steps, each 32-deep
    slice summed from zero; ``passes`` 3 is the split, 1 one TF32 pass."""
    ab, as_ = _split(a) if passes == 3 else (_tf32(a), None)
    bb, bs = _split(b) if passes == 3 else (_tf32(b), None)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], SLICE):
        part = torch.zeros_like(acc)
        for k in range(k0, min(k0 + SLICE, a.shape[-1]), MMA_K):
            sl = slice(k, k + MMA_K)
            if passes == 3:
                part = part + as_[..., sl] @ bb[..., sl, :]
                part = part + ab[..., sl] @ bs[..., sl, :]
            part = part + ab[..., sl] @ bb[..., sl, :]
        acc = acc + part
    return acc


def emulated_attention(q, k, v, *, causal, window, q_offset, passes=3):
    """Attention of q (B,Tq,Hq,D) over k, v (B,Tk,Hkv,D) as the kernel
    walks and computes it: 64-row q tiles of 16-row warp tiles, 32-row kv
    tiles, D zero-padded to a multiple of 8."""
    q, k, v = (torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v))
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    dp = -(-D // 8) * 8
    nk = -(-Tk // BK)
    pad = (0, dp - D)
    qs = torch.nn.functional.pad(q * np.float32(D ** -0.5), pad)
    qs = qs.permute(0, 2, 1, 3)                              # (B,Hq,Tq,dp)
    kv = [torch.nn.functional.pad(a, pad + (0, 0, 0, nk * BK - Tk))
          .repeat_interleave(Hq // Hkv, dim=2).permute(0, 2, 1, 3)
          for a in (k, v)]                                   # (B,Hq,T,dp)
    kpad, vpad = kv

    def live(kt, r_lo, r_hi):
        k0 = kt * BK
        if causal and not k0 <= r_hi + q_offset:
            return False
        if window and not k0 + BK - 1 > r_lo + q_offset - window:
            return False
        return True

    out = torch.zeros(B, Hq, Tq, dp)
    for q0 in range(0, Tq, BQ):
        tiles = [kt for kt in range(nk) if live(kt, q0, q0 + BQ - 1)]
        for w_lo in range(q0, min(q0 + BQ, Tq), WQ):
            rows = torch.arange(w_lo, w_lo + WQ)
            qw = qs[:, :, w_lo:w_lo + WQ]
            if qw.shape[2] < WQ:
                qw = torch.nn.functional.pad(qw, (0, 0, 0, WQ - qw.shape[2]))
            m = torch.full((B, Hq, WQ, 1), NEG_INF)
            l = torch.zeros(B, Hq, WQ, 1)
            acc = torch.zeros(B, Hq, WQ, dp)
            for kt in tiles:
                if not live(kt, w_lo, w_lo + WQ - 1):
                    continue
                ks = slice(kt * BK, (kt + 1) * BK)
                s = _product(qw, kpad[:, :, ks].transpose(-1, -2), passes)
                kpos = torch.arange(kt * BK, (kt + 1) * BK)[None, :]
                qpos = rows[:, None] + q_offset
                ok = kpos < Tk
                if causal:
                    ok = ok & (kpos <= qpos)
                if window:
                    ok = ok & (kpos > qpos - window)
                s = torch.where(ok, s, torch.tensor(NEG_INF))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + _product(p, vpad[:, :, ks], passes)
                m = m_new
            n = min(WQ, Tq - w_lo)
            inv = 1.0 / l.clamp(min=1e-30)
            out[:, :, w_lo:w_lo + n] = (acc * inv)[:, :, :n]
    return out[..., :D].permute(0, 2, 1, 3).contiguous()


def _inputs(seed, B, Tq, Tk, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32))


CASES = {
    # name: (B, Tq, Tk, Hq, Hkv, D, causal, window, q_offset)
    "gqa7_causal_d128": (1, 70, 70, 7, 1, 128, True, 0, 0),
    "d120_window_q_offset": (1, 70, 150, 7, 1, 120, True, 33, 80),
    "d36_ragged_tk": (2, 45, 45, 4, 2, 36, True, 0, 0),
    "sliding_window_d64": (2, 100, 100, 4, 2, 64, True, 5, 0),
    "tq1_q_offset_199": (1, 1, 200, 4, 1, 64, True, 0, 199),
    "non_causal_tq30_tk77": (1, 30, 77, 4, 2, 64, False, 0, 0),
}


@functools.lru_cache(maxsize=None)
def _emulated(case, passes=3):
    B, Tq, Tk, Hq, Hkv, D, causal, window, q_offset = CASES[case]
    q, k, v = _inputs(sum(map(ord, case)), B, Tq, Tk, Hq, Hkv, D)
    opts = dict(causal=causal, window=window, q_offset=q_offset)
    return (q, k, v), opts, emulated_attention(q, k, v, passes=passes,
                                               **opts)


def _row_distances(case, passes=3):
    """(emulation's, fp32 plain version's) largest per-row distance from
    the plain attention in float64."""
    (q, k, v), opts, out = _emulated(case, passes)
    kw = dict(causal=opts["causal"], sliding_window=opts["window"],
              q_offset=opts["q_offset"])
    args = [torch.from_numpy(a) for a in (q, k, v)]
    exact = tref.attention(*(a.double() for a in args), **kw)
    plain = tref.attention(*args, **kw)
    e_emul = float((out.double() - exact).abs().amax(-1).max())
    e_plain = float((plain.double() - exact).abs().amax(-1).max())
    return e_emul, e_plain


@pytest.mark.parametrize("force", ["interpret", "ref"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_attention_matches_reference(case, force):
    (q, k, v), opts, out = _emulated(case)
    kw = dict(block_q=32, block_k=32) if force == "interpret" else {}
    ref = jax.jit(lambda a, b, c: jops.attention(
        a, b, c, causal=opts["causal"], sliding_window=opts["window"],
        q_offset=opts["q_offset"], force=force, **kw))(q, k, v)
    err = float(np.abs(out.numpy() - np.asarray(ref)).max())
    assert np.isfinite(err) and err <= ATOL, (case, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_rows_as_close_to_float64_as_fp32(case):
    e_emul, e_plain = _row_distances(case)
    assert e_emul <= F64_RATIO * e_plain, (case, e_emul, e_plain)


@pytest.mark.parametrize("case", ["gqa7_causal_d128", "d36_ragged_tk"])
def test_one_tf32_pass_would_fail_the_float64_check(case):
    """The check above can tell: one TF32 pass per product (what plain
    TF32 tensor cores would give) lands two orders of magnitude beyond
    it, and beyond the 1e-4 tolerance against the reference."""
    e_one, e_plain = _row_distances(case, passes=1)
    assert e_one > 100 * F64_RATIO * e_plain, (case, e_one, e_plain)
    assert e_one > ATOL, (case, e_one)
