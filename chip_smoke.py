#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each fails loudly; any failure exits non-zero):

1. environment: torch / CUDA versions, ``nvidia-smi`` name and power limit;
2. build: every hand-written CUDA kernel of the port, with ``nvcc``, from
   the sources in this checkout, one ``nvcc`` per source in parallel;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the slice's shapes, with its time, the plain version's, one library
   call's as a yardstick (never used by the port) and its bound;
4. slice: two FeDepth rounds (``RoundEngine`` over ``build_lm_context``)
   on qwen2-7b at every published width, depth cut to 4 layers, random
   weights from a seed; the kernels' launch counts must be above zero.

Prints the card's name and power limit, then one JSON line of kernel
numbers, then ``{"ok": true, "device": ...}`` as the last line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

ATTN_ATOL = 1e-4     # max abs error of K2 vs its plain version
CE_RTOL = 1e-5       # relative error of K1's loss vs its plain version


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- phase 1
def phase_env() -> str:
    import torch
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"nvidia-smi: {smi}")
    return smi


# --------------------------------------------------------------- phase 2
def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, out in sorted(logs.items()):
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")


# --------------------------------------------------------------- phase 3
def _attn_pairs(Tq, Tk, causal, window, q_offset) -> int:
    import torch
    qp = torch.arange(Tq)[:, None] + q_offset
    kp = torch.arange(Tk)[None, :]
    mask = torch.ones(Tq, Tk, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return int(mask.sum())


def check_attention(gen, case: dict, timed: bool):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, plain
    B, Tq, Tk, Hq, Hkv, D = (case[k] for k in
                             ("B", "Tq", "Tk", "Hq", "Hkv", "D"))
    opts = dict(causal=case["causal"], sliding_window=case["window"],
                q_offset=case["q_offset"])
    q = torch.randn(B, Tq, Hq, D, device="cuda", generator=gen)
    k = torch.randn(B, Tk, Hkv, D, device="cuda", generator=gen)
    v = torch.randn(B, Tk, Hkv, D, device="cuda", generator=gen)
    out = flash_attention(q, k, v, **opts)
    ref = plain(q, k, v, **opts)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ok = math.isfinite(err) and err <= ATTN_ATOL
    log(f"  attention {case['name']}: max_abs_err {err:.3e} "
        f"(tol {ATTN_ATOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash attention {case['name']}: {err}")
    if not timed:
        return None
    ms = time_ms(lambda: flash_attention(q, k, v, **opts), 20)
    plain_ms = time_ms(lambda: plain(q, k, v, **opts), 10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    pairs = _attn_pairs(Tq, Tk, opts["causal"], opts["sliding_window"],
                        opts["q_offset"])
    flops = 4.0 * D * pairs * B * Hq
    nbytes = 4.0 * (2 * q.numel() + k.numel() + v.numel())
    bms, by = bound_ms(flops, nbytes)
    log(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"sdpa {lib_ms:.4f} ms  bound {bms:.4f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def check_ce(gen, case: dict, timed: bool):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.chunked_ce import chunked_cross_entropy, plain
    N, D, V = case["N"], case["D"], case["V"]
    h = torch.randn(1, N, D, device="cuda", generator=gen)
    w = torch.randn(D, V, device="cuda", generator=gen) / math.sqrt(D)
    labels = torch.randint(0, V, (1, N), device="cuda", generator=gen)
    labels[:, ::case["ignore_every"]] = -100
    loss, n = chunked_cross_entropy(h, w, labels)
    ref, n_ref = plain(h, w, labels)
    torch.cuda.synchronize()
    rel = float((loss - ref).abs() / ref.abs().clamp(min=1e-30))
    if case["ignore_every"] == 1:    # nothing valid: both must give 0
        rel = float((loss - ref).abs())
    ok = math.isfinite(rel) and rel <= CE_RTOL and int(n) == int(n_ref)
    log(f"  cross-entropy {case['name']}: loss {float(loss):.6f} vs "
        f"{float(ref):.6f}, rel_err {rel:.3e} (tol {CE_RTOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"chunked CE {case['name']}: {rel}")
    if not timed:
        return None
    err = float((loss - ref).abs())
    ms = time_ms(lambda: chunked_cross_entropy(h, w, labels), 5, warmup=1)
    plain_ms = time_ms(lambda: plain(h, w, labels), 5, warmup=1)
    flat = labels.reshape(-1)
    lib_ms = time_ms(lambda: F.cross_entropy(h[0] @ w, flat,
                                             ignore_index=-100), 5,
                     warmup=1)
    flops = 2.0 * N * D * V
    nbytes = 4.0 * (h.numel() + w.numel()) + 8.0 * N + 4.0
    bms, by = bound_ms(flops, nbytes)
    log(f"    kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
        f"matmul+F.cross_entropy {lib_ms:.3f} ms  bound {bms:.3f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def phase_kernels() -> dict:
    """Every kernel against its plain version; the first case of each is
    the slice's own shape and is timed."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn = dict(B=4, Tq=256, Tk=256, Hq=28, Hkv=4, D=128, causal=True,
                window=0, q_offset=0)
    attn_cases = [
        dict(attn, name="slice B4 T256 Hq28 Hkv4 D128 causal"),
        dict(attn, name="ragged Tk=200", Tk=200),
        dict(attn, name="sliding window 64", window=64),
        dict(attn, name="non-causal Tq=100 Tk=300", Tq=100, Tk=300,
             causal=False),
        dict(attn, name="q_offset 40, Tq=64", Tq=64, q_offset=40),
        dict(attn, name="D=64 group 2", Hq=8, Hkv=4, D=64),
    ]
    ce = dict(N=1024, D=3584, V=152064, ignore_every=7)
    ce_cases = [
        dict(ce, name="slice N1024 D3584 V152064"),
        dict(name="ragged N=300 D=200 V=1000", N=300, D=200, V=1000,
             ignore_every=5),
        dict(name="all labels ignored", N=130, D=64, V=300, ignore_every=1),
    ]
    out = {}
    log("kernels vs plain PyTorch on the card:")
    for i, case in enumerate(attn_cases):
        rec = check_attention(gen, case, timed=i == 0)
        if rec is not None:
            out["flash_attention"] = rec
    for i, case in enumerate(ce_cases):
        rec = check_ce(gen, case, timed=i == 0)
        if rec is not None:
            out["chunked_cross_entropy"] = rec
    return out


# --------------------------------------------------------------- phase 4
def phase_slice() -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.decomposition import schedule_summary
    from repro_torch.fl.engine import RoundEngine, SimConfig
    from repro_torch.fl.registry import get_strategy
    from repro_torch.fl.seq import build_lm_context, build_seq_data
    from repro_torch.kernels.chunked_ce import chunked_cross_entropy
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=4)
    log(f"slice: {cfg.name} d_model {cfg.d_model} heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} head_dim {cfg.head_dim} d_ff {cfg.d_ff} "
        f"vocab {cfg.vocab_size} layers {cfg.num_layers} (cut from 28), "
        f"{cfg.param_count() / 1e9:.3f} B params")
    sim = SimConfig(rounds=2, participation=0.5, lr=0.05, momentum=0.9,
                    local_steps=1, batch_size=4, scenario="fair", seed=0)
    data = build_seq_data(6, n_per_client=16, n_test=16,
                          vocab_size=cfg.vocab_size, seq_len=256, seed=0)
    ctx = build_lm_context(data, sim, cfg)
    for cid, dec in enumerate(ctx.decomps):
        log(f"client {cid} (r={ctx.ratios[cid]:.3f}): "
            + schedule_summary(dec, ctx.mem).replace("\n", " |"))
    engine = RoundEngine(get_strategy("fedepth"), ctx)
    cohorts = []
    sample = engine.sampler.sample

    def recording_sample(c, rd):
        ids = sample(c, rd)
        cohorts.append([int(k) for k in ids])
        return ids

    engine.sampler.sample = recording_sample
    peaks = []
    run_round = engine.run_round

    def measured_round(state, rd, batch_fn):
        out = run_round(state, rd, batch_fn)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return out

    engine.run_round = measured_round
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    chunked_cross_entropy.launches = 0
    t0 = time.perf_counter()
    state, history = engine.run(eval_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "chunked_cross_entropy": chunked_cross_entropy.launches}
    with torch.no_grad():
        loss = float(build(cfg).loss_fn(state, {"tokens": data.x_test[:4],
                                                "labels": data.y_test[:4]})[0])
    log(f"test loss after 2 rounds: {loss:.4f}")
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite test loss {loss}")
    for rd, ids in enumerate(cohorts):
        blocks = [len(ctx.decomps[k].blocks) for k in ids]
        log(f"round {rd + 1}: cohort {ids}, blocks per client {blocks}")
    for rec, peak in zip(history, peaks):
        log(f"round {rec.round}: accuracy {rec.accuracy}  seconds "
            f"{rec.seconds:.2f}  up bytes {rec.comm_bytes}  down bytes "
            f"{rec.down_bytes}  max_memory_allocated "
            f"{peak / 2**30:.2f} GiB")
    log(f"slice: 2 rounds in {wall:.1f} s, launches {launches}")
    if len(history) != 2 or not all(
            r.accuracy is not None and 0.0 <= r.accuracy <= 1.0
            for r in history):
        raise AssertionError(f"bad history {history}")
    if not any(len(ctx.decomps[k].blocks) >= 2
               for ids in cohorts for k in ids):
        raise AssertionError("no cohort client trained two blocks or more")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(state)):
        raise AssertionError("non-finite server parameters")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


KERNEL_META = {
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:107"),
    "chunked_cross_entropy": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chunked_ce.cu",
        replaces="src/repro/kernels/chunked_ce.py:66"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    numbers = phase_kernels()
    launches = phase_slice()
    kernels = [dict(name=name, **KERNEL_META[name], launches=launches[name],
                    **numbers[name]) for name in KERNEL_META]
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
