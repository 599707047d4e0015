#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each fails loudly; any failure exits non-zero):

1. environment: torch / CUDA versions, ``nvidia-smi`` name and power limit,
   and the cuBLAS workspace under the script's ``CUBLAS_WORKSPACE_CONFIG``
   beside PyTorch's default one;
2. build: every hand-written CUDA kernel of the port, with ``nvcc``, from
   the sources in this checkout, one ``nvcc`` per source in parallel;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it and on edge cases, with its time (calls
   back to back from Python, and on the card alone, ``device_ms``), the
   plain version's, one library call's as a yardstick (never used by the
   port; none computes either scan) and its bound at the peak of the
   units it runs on (K1 and K2: three TF32 products on the tensor cores;
   the scans: fp32 outside them).  K2's SDPA yardstick applies the
   case's own mask (``is_causal`` where that is it, else an explicit
   boolean mask) and must sit within SDPA_ATOL of the plain version.
   K1's per-row NLL at the qwen2 and mamba2 heads, K2's output at the
   slice's shape and at whisper's encoder, K3's at large steps and K4's
   at a decay near 1 are also held against the plain version run in
   float64: no farther than F64_RATIO x the fp32 plain version.  Timed
   shapes beside the slice's: the serving prefills, whisper-small's
   encoder (non-causal, 1500 frames) and cross-attention (Tq 256 and 1
   against 1500), zamba2-1.2b's shared block, scan and head,
   whisper-small's tied head, K3 / K4 at a decode step (T = 1), and
   yi-6b's training shapes (K2 at B 4 x T 64, B 4 / B 2 x T 256; K1 at
   its untied head over 256, 1024 and 512 rows).
   The grouped launches of the stacked path (K1 with one head per
   client, tied heads read in place; K3 with ``A`` and ``D``, K4 with
   ``u`` per client) at every grouped shape phase 10 launches and on
   ragged ones, each against its grouped plain version and, bitwise,
   against its groups' own ungrouped launches (at groups=1: a (1, ...)
   parameter against today's launch);
4. paths: two FeDepth rounds (``RoundEngine`` over ``build_lm_context``)
   on each ported family at every published width, random weights from a
   seed: qwen2-7b (depth cut to 4 layers), mamba2-370m (MAMBA2_LAYERS,
   24 of its 48 layers, tied head), rwkv6-7b (depth cut to 4 layers) and
   zamba2-1.2b (all 6 groups: K1, K2 and K3); two DepthFL rounds of the
   same qwen2-7b with all 6 clients in each round (each trains the
   prefix its budget fits, jointly: the r = 1 client all 4 layers, which
   the run requires); two
   m-FeDepth rounds of that mamba2-370m (``aux_norms``); FeDepth on
   h2o-danube-3-4b, minicpm-2b and qwen2-vl-2b (as text), each cut to 4
   layers; one client update of that qwen2-vl-2b with 256 stubbed vision
   embeddings; and one FeDepth client update of whisper-small (all 24
   units, r = 1/3's budget from ``lm_memory``, 4 x 1500 stubbed frames
   and 4 x 256 tokens: K1 on the tied head, K2 non-causal, causal and
   cross); two FeDepth rounds of qwen3-moe-235b-a22b (128 experts, top
   8, 64 / 4 heads) cut to 1 layer (of 94) over 4 clients, a cohort of 2
   (its reckoned peak, parameters + the largest block's training + the
   payloads held, must stay within 72 GiB, and so must the measured
   peak, logged beside it), and one qwen3-moe client update at 2 layers,
   2 blocks (reckoned and measured within 72 GiB too).  Before each, a
   reduced model's loss on the card is held against the CPU's
   (llama4-maverick's too, 4 layers: two units of a dense and a MoE
   layer).  The kernels' launch counts,
   reset just before each run and read just after, must be above zero
   for every kernel on that run's path;
5. the paper's own experiment: PreResNet-20 at its published widths on
   CIFAR-10's shape (synthetic 32 x 32 x 3 images, 10 classes, 50 000 /
   10 000), 100 clients over a balanced Dirichlet (alpha 1) split,
   participation 0.1, batch 64: 2 rounds each of ``fedepth`` and
   ``m-fedepth`` under ``fair``, ``fedepth`` under ``surplus`` (r = 2
   clients run MKD, M = 2), ``fedavg`` (x min r) under ``fair`` and the
   paper's baselines ``heterofl``, ``splitmix`` and ``depthfl`` under
   ``fair``, through ``build_federated`` -> ``build_context`` ->
   ``RoundEngine``.  Before them the full model's loss and gradient norm
   on the card are held against the CPU's, and so are DepthFL's joint
   loss (four aux exits and the head) and its gradient norm.  Then
   ``fedavg``, ``heterofl`` and ``fedepth`` again with the vectorized
   scheduler (``min_group=1``): equal bytes, the final states of the two
   schedulers equal in float64 (in fp32 their distance is logged beside
   two sequential runs'), round seconds, peaks and the device idle share
   of a profiled round side by side.  This path reaches none of the
   port's kernels (convs are cuDNN's): its launch counts must read 0.
   Then the wire: ``codec="none"`` with the full downlink bitwise the
   rounds without a channel, and FeDepth under ``fp16`` (sliced
   downlink), ``qsgd_int8`` and ``topk`` (delta downlink), error
   feedback on: each round's up bytes equal ``size_bytes`` of the
   cohort's payloads, its down bytes the dense state per first-time
   participant; the host seconds of encoding and decoding logged;
6. ViT-T/16 (paper Fig. 7) at full width: loss and gradients card vs
   CPU, every ``vit_memory`` unit priced the same, Fig. 7's protocol
   (FeDepth in blocks of 4, then FedAvg x1/6; accuracies logged, the
   comparison not gated) and ``cross_device_vit`` (400 clients, cohort
   100) with the sequential and then the vectorized scheduler, their
   final states held together; no kernel may launch;
7. serving (``repro_torch.launch.serve``) of yi-6b, h2o-danube-3-4b,
   minicpm-2b, qwen2-vl-2b (256 stubbed vision embeddings, M-RoPE),
   mamba2-370m, rwkv6-7b and zamba2-1.2b at every published width and
   half their published depth (SERVE_LAYERS), and qwen3-moe-235b-a22b
   at every width cut to 4 layers, one after another: a timed ``LM.prefill`` of 4 x 512 tokens
   (K2, K3 or K4; zamba2 K2 and K3) and the serve loop at batch 4
   (64-token prompts walked through the cache, 32 generated tokens;
   decode attention is plain, each ssm or hybrid step runs K3 or K4 at
   T = 1 from the carried state), with ms a token, tok/s, peaks, bounds,
   a profiled 8-step walk's idle share and the walk against the prefill
   with bf16 and with fp32 cache leaves (logged).  Before each: the
   reduced config's decode against its prefill on the card (atol 3e-2 /
   rtol 5e-2; a MoE decode, whose capacity of 1 an expert drops tokens
   the prefill keeps, against the same walk on the CPU), and the model at every width cut to 2 layers (zamba2 to
   one group), prefill on the card against the CPU (relative 1e-4) and 8
   decode steps (logged).  Then whisper-small (``serve`` refuses an
   encoder-decoder, as the reference's `serve` does): the same two
   checks (2 + 2 layers), a timed prefill of 4 x 1500 frames and 4 x 64
   tokens and a 32-step ``decode_step`` walk from the encoder's output
   (K2 cross at Tq = 1 in every layer of every step).  K1 must not
   launch;
8. system time and faults (run after phase 5, on its data): (a) on
   full-width PreResNet-20 (100 clients, 10 a round, ``fair``; no kernel
   may launch), under deterministic cuDNN and algorithms, two
   ``RoundEngine`` FeDepth rounds twice (the control) and
   ``AsyncEngine(mode="sync")`` over a zero-latency system, bitwise
   equal; then async FeDepth over ``profiles_for_ratios`` (concurrency
   10, buffer 5, 4 server versions) twice (the control), checkpointed
   every 2 versions (aux blobs through pickle), killed and resumed:
   state, history rows and trace bitwise the uninterrupted run's; (b)
   mamba2-370m at published widths cut to SYSTIME_LAYERS (24) of its
   48 layers, FeDepth over 6
   clients with phase 4's data: an async run (concurrency 3, buffer 2, 2
   server versions) whose peak must stay within its reckoning
   (``_reckon_async``), then 3 sync rounds under the reference tests'
   HEAVY fault plan with ``resample`` degradation, twice (the control),
   checkpointed every round, killed after round 2 and resumed, bitwise
   (deterministic algorithms; ``CUBLAS_WORKSPACE_CONFIG`` is set at the
   start), with a fault or quarantine in the trace.  K1 and K3 must
   launch in each LM run, at shapes phase 3 checked.  Each run logs wall
   and sim seconds, peak and launches, the first of each set of
   identical runs its device idle share;
9. scale and observability (after phase 8, on phase 5's data; each run
   logs wall seconds, peak, launches and the host's RSS before and after,
   the first of a set its idle share): (a) a lazily drawn population of
   10^6 clients (``repro_torch.fl.scale.Population``) on full-width
   PreResNet-20, a cohort of 100, 1 masked FeDepth round under the
   vectorized scheduler and the sharded one with fused aggregation (and
   ``max_lanes=16``): equal bytes, states within the vectorized
   tolerance, a single-group fused round bitwise ``aggregate_masked``,
   then the vectorized run at 10^4 clients (host RSS side by side); (b) the
   async run of phase 8 (a) under ``qsgd_int8`` / delta with a
   ``SpillStore(capacity=2)`` on the engine and the channel, and
   checkpointed, killed and resumed: bitwise the run without a store;
   (c) mamba2-370m at SYSTIME_LAYERS, 2 FeDepth rounds with telemetry
   off and full (``obs=``, a JSONL ``history_sink``): bitwise, K1 and K3
   launch; the Chrome trace through ``tools/trace_report.py``, the Prometheus
   snapshot, span counts, and the memory auditor's cells (every trained
   block measured; PreResNet-20's, from one audited round, within the
   reference's envelope 0.25–4).  PreResNet-20 runs launch no kernel;
10. the stacked LM path (after phase 7): at every published width, a
   group of clients sharing one multi-block decomposition (the fewest
   blocks whose stacked reckoning fits 72 GiB) trained by
   ``client_update_batched`` (``vmap(grad)``, each kernel's vmap rule
   one launch a group) against the same clients' sequential
   ``client_update`` calls, 2 batches of 4 x 256 tokens a client:
   mamba2-370m (24 layers, 4 clients: K1 tied + K3), rwkv6-7b (4 layers,
   4 clients: K1 + K4) and qwen2-7b (4 layers, 3 clients, cut from 4:
   K1 + K2).  Each client's state within rtol 2e-4 / atol 2e-5 of its
   sequential twin, the stacked launches of each kernel the sequential
   ones over the group size; wall, peak beside the reckoning and idle
   share of both logged.  Each group then runs under ``disable_remat``
   (peak beside its reckoning) and with remat again, both warm, for
   remat's wall and device time.  Then one FeDepth
   round of mamba2-370m (24 layers) over 6
   clients (two groups of 2 stack) under the vectorized scheduler and
   under ``ShardedScheduler(mesh=["cuda:0"])``, deterministic: bitwise.
11. the training launch path (``repro_torch.launch.train`` /
   ``.steps``, after phase 10): (a) the train CLI in standard mode on
   yi-6b at published widths and all 32 layers, its defaults (batch 4 x
   64, 3 steps; SGD momentum, the global-norm clip), profiled; (b)
   ``make_train_step`` on yi-6b cut to 4 layers at batch 4 x 256 from one
   set of parameters, ``accum_steps=2`` within rtol 1e-4 / atol 1e-6 of
   ``accum_steps=1``, and the reduced config's step on the card against
   the CPU; (c) the CLI's FeDepth mode on mamba2-370m at all 48 layers,
   batch 4 x 256, a budget of two blocks, two passes of the schedule; (d)
   the buffered-z block step on (c)'s later block bitwise the unbuffered
   one, deterministic; (e) ``make_multi_decode_step(lm, 8)`` at batch 4
   bitwise 8 ``decode_step`` calls with argmax feedback (K3 at T = 1).
   Each step's peak is held to its reckoning (parameters, momentum,
   gradients, ``lm_memory``'s fp32 activations) and RECKON_LIMIT; every
   loss finite; step seconds, tokens/s and 6 N tokens / s against fp32's
   67 TFLOP/s logged, and the CLI run's idle share.
12. the sharded layer (after phase 11), over a one-rank ``nccl`` group
   (a ``HashStore``, no port): (a) phase 11 (b)'s step on yi-6b at 4
   layers with its parameters laid out by ``launch.sharding.param_specs``
   as DTensors on a ("data", "model") mesh of (1, 1), fsdp off and on,
   under deterministic algorithms: K1 and K2 through ``local_map`` on
   every call, and parameters, momentum, loss and gnorm bitwise the
   unsharded step's (step seconds and peaks logged); (a') K1's
   vocab-shard form (what each rank runs for a head split over the
   vocab) on two halves of the yi-6b head, each half's log-sum-exp and
   gold logit and the combined NLL within CE_RTOL of the plain version;
   (b) ``moe_ep.forward_ep`` on one qwen3-moe layer at published widths,
   4 x 256 tokens at capacity factor 8, forward and backward against
   ``moe.forward`` within EP_TOL (each after an untimed first call;
   seconds, peaks and the bytes through ``all_to_all`` logged); (c)
   ``launch.dryrun.dryrun_one("yi-6b", "train_4k")`` on the 16 x 16 fake
   mesh, costed at its accumulation of 8, with per-unit rematerialization
   and without, its roofline terms at the H100's constants.
13. per-unit rematerialization (``models.common.maybe_checkpoint``, on
   by default in every training path above: phases 4 and 8–12 run each
   trained unit's forward again in its backward, K2–K4 launching again,
   and their reckonings price that mode; the stacked groups of phase 10
   run it under ``vmap``, count the units it rematerialized and run
   again without it, (d)):
   (a) phase 11 (b)'s step, yi-6b cut to 4 layers at 4 x 256, with remat
   and without (``disable_remat``), under deterministic algorithms:
   parameters, momentum, loss and gnorm bitwise, K2 launched twice as
   often with remat, K1 as often; each mode's warm seconds and peak
   beside its own reckoning, the peak within it and RECKON_LIMIT; (b) the
   same at 4 x 2048 tokens; (c) one FeDepth client update at published
   widths, one block a unit, of mamba2-370m (2 layers: K1, K3), rwkv6-7b
   (1 layer: K1, K4), zamba2-1.2b (1 group: K1, K2, K3), whisper-small
   (1 encoder and 1 decoder layer: K1, K2) and qwen3-moe-235b-a22b (1
   layer: K1, K2), each within REMAT_ATOL of the same update on the CPU,
   its recompute launching K2 / K3 / K4 more often than the update under
   ``disable_remat`` and K1 as often.  Phase 13's depths are cut from
   phase 4's (24, 4, 6 groups, 24 units, 1 layer) so that each CPU twin
   fits the time and the host's memory.

Prints the card's name and power limit, then one JSON line of kernel
numbers (every timed shape beside the first under ``heads``, each with
the launches of its arch's runs (a decode row's: the serving decode
only), summed, and per run under ``runs``; every kernel's serving
launches per run under ``serving``), then ``{"ok": true, "device":
...}`` as the last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels.timing import time_ms  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet, ``repro_torch.roofline.hw``):
# fp32 outside the tensor cores, dense TF32 on the tensor cores, and HBM3
# bandwidth
PEAK_FP32 = ("fp32 67 TFLOP/s", hw.PEAK_FLOPS_FP32)
PEAK_TF32 = ("tf32 495 TFLOP/s", hw.PEAK_FLOPS_TF32)
PEAK_BYTES_PER_S = hw.HBM_BW

ATTN_ATOL = 1e-4     # max abs error of K2 vs its plain version
SDPA_ATOL = 1e-2     # the SDPA yardstick vs K2's plain version
CE_RTOL = 1e-5       # relative error of K1's loss vs its plain version
SCAN_ATOL = SCAN_RTOL = 1e-4   # K3 / K4 vs plain: |a - b| <= atol + rtol|b|
F64_RATIO = 2.0      # K1 per row, K2, K3 at large dt, K4 at decay ~1:
                     # distance from float64 vs the fp32 plain version's
LOSS_RTOL = 1e-4     # a reduced model's loss, card vs CPU


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(flops: float, nbytes: float, peak=PEAK_FP32):
    """The least time for ``flops`` at ``peak`` (name, FLOP/s) and
    ``nbytes`` at the memory rate: (ms, what bounds it, the peak's name)."""
    t_ops = flops / peak[1] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, peak[0]


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
    # ``main`` sets CUBLAS_WORKSPACE_CONFIG for phase 8's deterministic
    # algorithms; phase 3's cuBLAS yardsticks are PyTorch's default ones
    # only while the workspace it configures is the default's size: log
    # both, the default's from a process without the variable
    probe = ("import torch; a = torch.ones(64, 64, device='cuda'); "
             "n = torch.cuda.memory_allocated(); b = a @ a; "
             "torch.cuda.synchronize(); "
             "print(torch.cuda.memory_allocated() - n - b.nbytes)")
    env = {k: v for k, v in os.environ.items()
           if k != "CUBLAS_WORKSPACE_CONFIG"}
    default = subprocess.run([sys.executable, "-c", probe], env=env,
                             capture_output=True, text=True, check=True,
                             timeout=300).stdout.strip()
    a = torch.ones(64, 64, device="cuda")
    n = torch.cuda.memory_allocated()
    b = a @ a
    torch.cuda.synchronize()
    log(f"cuBLAS workspace: {torch.cuda.memory_allocated() - n - b.nbytes} "
        f"B under CUBLAS_WORKSPACE_CONFIG="
        f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}, {default} B by "
        f"default")
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
def _attn_mask(Tq, Tk, causal, window, q_offset, device="cpu"):
    """The (Tq, Tk) pairs the kernel attends (True = attend): causal and
    sliding-window masks offset by ``q_offset``."""
    import torch
    qp = torch.arange(Tq, device=device)[:, None] + q_offset
    kp = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones(Tq, Tk, dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return mask


def _sdpa_call(q, k, v, causal, window, q_offset):
    """One ``F.scaled_dot_product_attention`` call computing the kernel's
    function on (B, T, H, D) inputs: ``is_causal`` where that is the
    kernel's mask (Tq = Tk, offset 0, no window cutting a pair), else the
    kernel's mask as an explicit boolean ``attn_mask``."""
    import torch.nn.functional as F
    Tq, Tk = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if Tq == Tk and q_offset == 0 and (not window or window >= Tk):
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    mask = _attn_mask(Tq, Tk, causal, window, q_offset, q.device)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def check_attention(gen, case: dict, timed: bool):
    import torch
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
        return dict(max_abs_err=err)
    if case.get("f64"):
        # per row: each row's largest distance, then the largest row
        check_against_f64(
            "attention", lambda *a: (flash_attention(*a, **opts),),
            lambda *a: (plain(*a, **opts),), case, (q, k, v))
    ms = time_ms(lambda: flash_attention(q, k, v, **opts), 20)
    device_ms = time_ms(lambda: flash_attention(q, k, v, **opts), 20,
                        fill=True)
    plain_ms = time_ms(lambda: plain(q, k, v, **opts), 10)
    sdpa = _sdpa_call(q, k, v, case["causal"], case["window"],
                      case["q_offset"])
    # the yardstick must compute the kernel's function: a wrong mask moves
    # outputs by O(1), SDPA's own fp32 backends by far less than SDPA_ATOL
    lib_err = float((sdpa().transpose(1, 2) - ref).abs().max())
    if not lib_err <= SDPA_ATOL:
        raise AssertionError(f"SDPA yardstick {case['name']}: {lib_err}")
    lib_ms = time_ms(sdpa, 20)
    pairs = int(_attn_mask(Tq, Tk, opts["causal"], opts["sliding_window"],
                           opts["q_offset"]).sum())
    # the kernel's work: three TF32 products (small*big, big*small,
    # big*big) of 4*D flops per live (q, k) pair, on the tensor cores
    flops = 4.0 * D * pairs * B * Hq
    nbytes = 4.0 * (2 * q.numel() + k.numel() + v.numel())
    bms, by, peak = bound_ms(3 * flops, nbytes, PEAK_TF32)
    fp32_bms = bound_ms(flops, nbytes)[0]
    log(f"    kernel {ms:.4f} ms (device {device_ms:.4f})  plain "
        f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms (max abs {lib_err:.1e} "
        f"from plain)  bound {bms:.4f} ms ({by}, "
        f"{peak}; the products in fp32 outside the tensor cores: "
        f"{fp32_bms:.4f} ms)")
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_peak=peak, fp32_bound_ms=fp32_bms, library_ms=lib_ms)


def _grouped_plain_ce(h, w, labels):
    """The plain CE of a grouped call: (each group's mean, its n_valid)
    from the grouped plain rows."""
    from repro_torch.kernels.chunked_ce import plain_rows
    G = w.shape[0]
    n = (labels >= 0).reshape(G, -1).sum(1).clamp(min=1)
    return plain_rows(h, w, labels).reshape(G, -1).sum(1) / n, n


def check_grouped_bitwise(what: str, grouped, one, G: int,
                          case: dict) -> None:
    """A grouped launch's outputs (``grouped()``, each with the batch rows
    first) for group g's rows equal, bitwise, ``one(g)``: an ungrouped
    launch on group g's rows and parameters (today's kernel)."""
    import torch
    worst = 0.0
    for g in range(G):
        for a, b in zip(grouped(), one(g)):
            part = a.reshape(G, a.shape[0] // G, *a.shape[1:])[g]
            if not torch.equal(part, b.reshape(part.shape)):
                diff = float((part - b.reshape(part.shape)).abs().max())
                worst = max(worst, diff) if diff == diff else math.inf
    ok = worst == 0.0
    log(f"  {what} {case['name']}: each of {G} groups bitwise its own "
        f"ungrouped launch {'ok' if ok else f'FAIL ({worst:.3e})'}")
    if not ok:
        raise AssertionError(f"{what} {case['name']}: a grouped launch "
                             f"differs from its groups' own ({worst})")


def check_ce(gen, case: dict, timed: bool):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.chunked_ce import (chunked_cross_entropy,
                                                cross_entropy_rows, plain)
    N, D, V = case["N"], case["D"], case["V"]
    G = case.get("groups")      # a stacked launch: one head per group
    if G is None:
        h = torch.randn(1, N, D, device="cuda", generator=gen)
        w = torch.randn(D, V, device="cuda", generator=gen) / math.sqrt(D)
        if case.get("tied"):   # the head is embed.T: a (V, D) table in place
            w = w.T.contiguous().T
        labels = torch.randint(0, V, (1, N), device="cuda", generator=gen)
    else:
        h = torch.randn(G, N // G, D, device="cuda", generator=gen)
        w = torch.randn(G, D, V, device="cuda", generator=gen) / math.sqrt(D)
        if case.get("tied"):   # embed.transpose(1, 2) of a (G, V, D) stack
            w = w.transpose(1, 2).contiguous().transpose(1, 2)
        labels = torch.randint(0, V, (G, N // G), device="cuda",
                               generator=gen)
    labels[:, ::case["ignore_every"]] = -100
    loss, n = chunked_cross_entropy(h, w, labels)
    ref, n_ref = plain(h, w, labels) if G is None else \
        _grouped_plain_ce(h, w, labels)
    torch.cuda.synchronize()
    rel = float(((loss - ref).abs() / ref.abs().clamp(min=1e-30)).max())
    if case["ignore_every"] == 1:    # nothing valid: both must give 0
        rel = float((loss - ref).abs().max())
    ok = math.isfinite(rel) and rel <= CE_RTOL and bool((n == n_ref).all())
    log(f"  cross-entropy {case['name']}: loss {loss.tolist()} vs "
        f"{ref.tolist()}, rel_err {rel:.3e} (tol {CE_RTOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"chunked CE {case['name']}: {rel}")
    if G is not None:
        check_grouped_bitwise(
            "cross-entropy", lambda: (cross_entropy_rows(h, w, labels),),
            lambda g: (cross_entropy_rows(h[g:g + 1], w[g],
                                          labels[g:g + 1]),), G, case)
    if not timed:
        return dict(max_abs_err=float((loss - ref).abs().max()))
    if case.get("f64"):
        check_ce_against_f64(case, h, w, labels)
    err = float((loss - ref).abs().max())
    ms = time_ms(lambda: chunked_cross_entropy(h, w, labels), 5, warmup=1)
    device_ms = time_ms(lambda: chunked_cross_entropy(h, w, labels), 5,
                        warmup=1, fill=True)
    flat = labels.reshape(-1)
    if G is None:
        plain_ms = time_ms(lambda: plain(h, w, labels), 5, warmup=1)
        lib_ms = time_ms(lambda: F.cross_entropy(h[0] @ w, flat,
                                                 ignore_index=-100), 5,
                         warmup=1)
    else:   # the plain grouped mean; the library: one bmm, one CE
        plain_ms = time_ms(lambda: _grouped_plain_ce(h, w, labels), 5,
                           warmup=1)
        lib_ms = time_ms(lambda: F.cross_entropy(
            torch.bmm(h, w).reshape(-1, V), flat, ignore_index=-100), 5,
            warmup=1)
    # the kernel's work: three TF32 products (small*big, big*small,
    # big*big) of 2*N*D*V flops each, on the tensor cores (each row
    # against its own group's head)
    flops = 3 * 2.0 * N * D * V
    nbytes = 4.0 * (h.numel() + w.numel()) + 8.0 * N + 4.0
    bms, by, peak = bound_ms(flops, nbytes, PEAK_TF32)
    fp32_bms = bound_ms(2.0 * N * D * V, nbytes)[0]
    log(f"    kernel {ms:.3f} ms (device {device_ms:.3f})  plain "
        f"{plain_ms:.3f} ms  matmul+F.cross_entropy {lib_ms:.3f} ms  bound "
        f"{bms:.3f} ms ({by}, "
        f"{peak}; one fp32 product outside the tensor cores: "
        f"{fp32_bms:.3f} ms)")
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_peak=peak, library_ms=lib_ms)


def check_ce_against_f64(case: dict, h, w, labels) -> None:
    """The 3xTF32 product's precision: every row's NLL from the kernel
    sits no farther from the plain CE in float64 than F64_RATIO times the
    fp32 plain version's largest distance (rows, not the mean, so that
    the loss's own fp32 rounding does not decide it)."""
    from repro_torch.kernels.chunked_ce import cross_entropy_rows, plain_rows
    exact = plain_rows(h.double(), w.double(), labels)
    e_kernel = float((cross_entropy_rows(h, w, labels).double()
                      - exact).abs().max())
    e_plain = float((plain_rows(h, w, labels).double() - exact).abs().max())
    ok = math.isfinite(e_kernel) and e_kernel <= F64_RATIO * e_plain
    log(f"  cross-entropy {case['name']} vs float64 plain, per row: kernel "
        f"{e_kernel:.3e}, fp32 plain {e_plain:.3e} (largest |nll| "
        f"{float(exact.abs().max()):.3e}; kernel <= {F64_RATIO:g} x plain) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"chunked CE {case['name']}: {e_kernel} from "
                             f"float64, fp32 plain {e_plain}")


def _fwd_bwd_ms(op, args) -> float:
    """ms of one differentiable scan (``ops.mamba2`` / ``ops.rwkv6``):
    the kernel's forward, then the plain chunked-recompute backward into
    every input, as a training step runs it."""
    import torch
    leaves = [a.clone().requires_grad_() for a in args]

    def step():
        y, s = op(*leaves)
        torch.autograd.grad((y.sum(), s.sum()), leaves)

    return time_ms(step, 3, warmup=1)


def _max_err(outs, refs) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(outs, refs))


def check_scan(what: str, kernel, plain, op, case: dict, args, flops: float,
               nbytes: float, timed: bool):
    """A scan kernel against its plain version on ``args``: every element
    of (y, final state) within SCAN_ATOL + SCAN_RTOL * |plain|.  Timed,
    it also returns the kernel line's numbers and logs the differentiable
    op's forward + backward."""
    import torch
    outs = kernel(*args)
    refs = plain(*args)
    torch.cuda.synchronize()
    err = _max_err(outs, refs)
    ok = math.isfinite(err) and all(
        bool(((a - b).abs() <= SCAN_ATOL + SCAN_RTOL * b.abs()).all())
        for a, b in zip(outs, refs))
    log(f"  {what} {case['name']}: max_abs_err {err:.3e} (atol "
        f"{SCAN_ATOL:g} + rtol {SCAN_RTOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} {case['name']}: {err}")
    if not timed:
        return dict(max_abs_err=err)
    ms = time_ms(lambda: kernel(*args), 20)
    device_ms = time_ms(lambda: kernel(*args), 20, fill=True)
    plain_ms = time_ms(lambda: plain(*args), 3, warmup=1)
    train_ms = _fwd_bwd_ms(op, args)
    bms, by, peak = bound_ms(flops, nbytes)
    log(f"    kernel {ms:.4f} ms (device {device_ms:.4f})  plain "
        f"{plain_ms:.3f} ms  library none  bound {bms:.4f} ms ({by}, "
        f"{peak});  ops forward + backward {train_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_peak=peak, library_ms=None)


def check_against_f64(what: str, kernel, plain, case: dict, args) -> None:
    """The kernel (outputs as a tuple) must sit no farther than F64_RATIO
    times the fp32 plain version's distance from the plain version run in
    float64: for K2's split products, and where fp32 rounding alone
    exceeds a scan's tolerance."""
    exact = plain(*(a.double() for a in args))
    e_kernel = _max_err([t.double() for t in kernel(*args)], exact)
    e_plain = _max_err([t.double() for t in plain(*args)], exact)
    scale = max(float(t.abs().max()) for t in exact)
    ok = math.isfinite(e_kernel) and e_kernel <= F64_RATIO * e_plain
    log(f"  {what} {case['name']} vs float64 plain: kernel {e_kernel:.3e}, "
        f"fp32 plain {e_plain:.3e} (largest |value| {scale:.3e}; kernel "
        f"<= {F64_RATIO:g} x plain) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} {case['name']}: {e_kernel} from "
                             f"float64, fp32 plain {e_plain}")


def check_mamba2(gen, case: dict, timed: bool):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.mamba2_ssd import mamba2_scan, plain
    B, T, H, P, N = (case[k] for k in ("B", "T", "H", "P", "N"))
    dev = "cuda"
    dt_scale = case.get("dt_scale", 1.0)
    x = torch.randn(B, T, H, P, device=dev, generator=gen)
    dt = F.softplus(torch.randn(B, T, H, device=dev, generator=gen)) \
        * dt_scale
    G = case.get("groups")     # a stacked launch: A and D per group
    hs = (H,) if G is None else (G, H)
    A = -torch.exp(torch.randn(*hs, device=dev, generator=gen))
    Bm = torch.randn(B, T, N, device=dev, generator=gen)
    Cm = torch.randn(B, T, N, device=dev, generator=gen)
    D = torch.randn(*hs, device=dev, generator=gen)
    s0 = (torch.randn(B, H, P, N, device=dev, generator=gen)
          if case.get("s0") else torch.zeros(B, H, P, N, device=dev))
    if dt_scale != 1.0:
        # large steps drive exp(A dt) to 0 and y to ~1e4, where fp32
        # rounding alone exceeds the tolerance: held against float64 here,
        # and against the plain version with x shrunk by the same factor
        check_against_f64("mamba2 scan", mamba2_scan, plain, case,
                          (x, dt, A, Bm, Cm, D, s0))
        x = x / dt_scale
    args = (x, dt, A, Bm, Cm, D, s0)
    if G is not None:
        rows = B // G
        check_grouped_bitwise(
            "mamba2 scan", lambda: mamba2_scan(*args),
            lambda g: mamba2_scan(*(
                a[g] if i in (2, 5) else a[g * rows:(g + 1) * rows]
                for i, a in enumerate(args))), G, case)
    # per (b, h, t): 5 flops per state element (da*h + dx*B, then h*C
    # into y) and 3 per row (dx, D*x, the sum); bytes: x, y, dt, B, C,
    # A, D and the state in and out, each once
    flops = 5.0 * B * T * H * P * N + 3.0 * B * T * H * P
    nbytes = 4.0 * (2 * x.numel() + dt.numel() + Bm.numel() + Cm.numel()
                    + A.numel() + D.numel() + 2 * s0.numel())
    return check_scan("mamba2 scan", mamba2_scan, plain, ops.mamba2, case,
                      args, flops, nbytes, timed)


def check_rwkv6(gen, case: dict, timed: bool):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv6_scan import plain, rwkv6_scan
    B, T, H, D = (case[k] for k in ("B", "T", "H", "D"))
    dev = "cuda"
    r, k, v = (torch.randn(B, T, H, D, device=dev, generator=gen)
               for _ in range(3))
    w = torch.randn(B, T, H, D, device=dev, generator=gen) * 0.5 - 0.5
    if case.get("overflow"):    # exp(w) = inf: the decay must be exactly 0
        w[:, ::3] = 100.0
    G = case.get("groups")     # a stacked launch: u per group
    u = torch.randn(*((H, D) if G is None else (G, H, D)), device=dev,
                    generator=gen) * 0.1
    s0 = (torch.randn(B, H, D, D, device=dev, generator=gen)
          if case.get("s0") else torch.zeros(B, H, D, D, device=dev))
    if case.get("decay_one"):
        # w << 0: the decay exp(-exp(w)) is ~1 - 3e-4, so the state sums
        # every step and y grows to ~1e2, where fp32 rounding alone
        # exceeds the tolerance: held against float64 here, and against
        # the plain version with v shrunk 16x (y and the state with it)
        w = w - 8.0
        check_against_f64("rwkv6 scan", rwkv6_scan, plain, case,
                          (r, k, v, w, u, s0))
        v = v / 16.0
    if G is not None:
        rows, args = B // G, (r, k, v, w, u, s0)
        check_grouped_bitwise(
            "rwkv6 scan", lambda: rwkv6_scan(*args),
            lambda g: rwkv6_scan(*(
                a[g] if i == 4 else a[g * rows:(g + 1) * rows]
                for i, a in enumerate(args))), G, case)
    # per (b, h, t), the least work: r S_{t-1} (2 flops per state
    # element), S = d*S + k v (3 per element), and the bonus term
    # v_e * sum_d r_d u_d k_d (5 per row); bytes: r, k, v, w, y, u and the
    # state in and out, each once
    flops = 5.0 * B * T * H * D * D + 5.0 * B * T * H * D
    nbytes = 4.0 * (5 * r.numel() + u.numel() + 2 * s0.numel())
    return check_scan("rwkv6 scan", rwkv6_scan, plain, ops.rwkv6, case,
                      (r, k, v, w, u, s0), flops, nbytes, timed)


def _case_key(kernel: str, case: dict) -> tuple:
    """The shape a phase-3 case checks, as :func:`_launch_key` names a
    launch's."""
    if kernel == "flash_attention":
        return (*(case[k] for k in ("B", "Tq", "Tk", "Hq", "Hkv", "D")),
                bool(case["causal"]), int(case["window"]),
                int(case["q_offset"]))
    groups = case.get("groups", 1)
    if kernel == "chunked_cross_entropy":
        return (case["N"], case["D"], case["V"], bool(case.get("tied")),
                groups)
    if kernel == "mamba2_scan":
        return (*(case[k] for k in ("B", "T", "H", "P", "N")), groups)
    return (*(case[k] for k in ("B", "T", "H", "D")), groups)


def _launch_key(kernel: str, args: tuple, kw: dict) -> tuple:
    """The shape of one wrapper call: K2's (B, Tq, Tk, Hq, Hkv, D, causal,
    window, q_offset), K1's (rows, D, V, head read as a (V, D) table,
    groups), K3's (B, T, H, P, N, groups), K4's (B, T, H, D, groups):
    ``groups`` is the count of per-client heads, ``A`` / ``D`` or ``u`` a
    stacked (vmapped) launch reads, 1 where they are shared."""
    if kernel == "flash_attention":
        q, k = args[0], args[1]
        return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                q.shape[3], bool(kw.get("causal", True)),
                int(kw.get("sliding_window") or 0), int(kw.get("q_offset", 0)))
    if kernel == "chunked_cross_entropy":
        h, w = args[0], args[1]
        return (h.numel() // h.shape[-1], w.shape[-2], w.shape[-1],
                w.stride(-1) != 1, w.shape[0] if w.dim() == 3 else 1)
    if kernel == "mamba2_scan":
        A = args[2]
        return (*args[0].shape, args[3].shape[-1],
                A.shape[0] if A.dim() == 2 else 1)
    u = args[4]
    return (*args[0].shape, u.shape[0] if u.dim() == 3 else 1)


def phase_kernels():
    """Every kernel against its plain version, at every shape that a
    counted run of the later phases launches it at (``main`` fails on a
    launch at a shape not checked here), and at edge cases.  The first
    case of each kernel is timed for the kernel line, and the cases marked
    ``timed`` too.  Returns (the first cases' numbers, {kernel: {shape:
    the record of the case that the launches at that shape go to}})."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn = dict(B=4, Tq=256, Tk=256, Hq=28, Hkv=4, D=128, causal=True,
                window=0, q_offset=0)
    attn_cases = [
        dict(attn, name="slice B4 T256 Hq28 Hkv4 D128 causal", f64=True,
             path="qwen2-7b"),
        dict(attn, name="ragged Tk=200", Tk=200),
        dict(attn, name="sliding window 64", window=64),
        dict(attn, name="non-causal Tq=100 Tk=300", Tq=100, Tk=300,
             causal=False),
        dict(attn, name="q_offset 40, Tq=64", Tq=64, q_offset=40),
        dict(attn, name="D=64 group 2", Hq=8, Hkv=4, D=64),
        # the tensor-core tiling; each case draws from its own seed, so
        # that the other kernels' inputs stay as they were
        dict(attn, name="D=120 group 7, window 33, q_offset 80, Tq=70 "
             "Tk=150", Tq=70, Tk=150, Hq=7, Hkv=1, D=120, window=33,
             q_offset=80, seed=1),
        dict(attn, name="D=36 (reduced), Tq=Tk=45", B=2, Tq=45, Tk=45, Hq=4,
             Hkv=2, D=36, seed=2),
        dict(attn, name="Tq=1, q_offset 4000, Tk=4001", B=2, Tq=1, Tk=4001,
             q_offset=4000, seed=3),
        dict(attn, name="Tq=77 Tk=93 q_offset 16 (no tile multiple)", Tq=77,
             Tk=93, q_offset=16, seed=4),
        dict(attn, name="window 100 across tile edges", window=100, seed=5),
        dict(attn, name="D=30 (4-byte copies), q_offset 20", B=1, Tq=20,
             Tk=40, Hq=2, Hkv=1, D=30, q_offset=20, seed=6),
        # the serving prefills, each at the shape its arch's prefill gives
        # it: yi-6b's group of 8, h2o-danube-3-4b's D 120 under its window,
        # minicpm-2b's group of 1, qwen2-vl-2b's 256 vision + 512 text tokens
        dict(attn, name="yi-6b prefill B4 T512 Hq32 Hkv4 D128 causal",
             Tq=512, Tk=512, Hq=32, Hkv=4, D=128, seed=9, timed=True,
             path="yi-6b"),
        dict(attn, name="h2o-danube-3-4b prefill B4 T512 Hq32 Hkv8 D120 "
             "causal, window 4096", Tq=512, Tk=512, Hq=32, Hkv=8, D=120,
             window=4096, seed=10, timed=True, path="h2o-danube-3-4b"),
        dict(attn, name="minicpm-2b prefill B4 T512 Hq36 Hkv36 D64 causal",
             Tq=512, Tk=512, Hq=36, Hkv=36, D=64, seed=7, timed=True,
             path="minicpm-2b"),
        dict(attn, name="qwen2-vl-2b prefill B4 T768 Hq12 Hkv2 D128 causal",
             Tq=768, Tk=768, Hq=12, Hkv=2, seed=8, timed=True,
             path="qwen2-vl-2b"),
        # whisper-small's encoder (non-causal, 1500 frames), its decoder's
        # cross-attention over them (Tq != Tk) in training and prefill and
        # at decode (Tq = 1), and zamba2-1.2b's shared block
        dict(attn, name="whisper-small encoder B4 Tq=Tk=1500 H12 D64 "
             "non-causal", Tq=1500, Tk=1500, Hq=12, Hkv=12, D=64,
             causal=False, seed=13, timed=True, path="whisper-small",
             f64=True),
        dict(attn, name="whisper-small cross B4 Tq256 Tk1500 H12 D64",
             Tq=256, Tk=1500, Hq=12, Hkv=12, D=64, causal=False, seed=14,
             timed=True, path="whisper-small"),
        dict(attn, name="whisper-small cross at decode B4 Tq1 Tk1500 H12 D64",
             Tq=1, Tk=1500, Hq=12, Hkv=12, D=64, causal=False, seed=15,
             timed=True, path="whisper-small"),
        dict(attn, name="zamba2-1.2b shared block B4 T256 H32 D64 causal",
             Hq=32, Hkv=32, D=64, seed=16, timed=True, path="zamba2-1.2b"),
        # the rest of the paths' shapes: zamba2's prefill (512 tokens),
        # whisper's decoder in training (256 tokens) and prefill (64), the
        # new dense runs' training (4 x 256 tokens; the VLM client's 256
        # vision + 256 text), and the engine's eval of 16 test sequences
        dict(attn, name="zamba2-1.2b prefill B4 T512 H32 D64 causal",
             Tq=512, Tk=512, Hq=32, Hkv=32, D=64, seed=23, timed=True,
             path="zamba2-1.2b"),
        dict(attn, name="whisper-small decoder B4 T256 H12 D64 causal",
             Hq=12, Hkv=12, D=64, seed=24, timed=True, path="whisper-small"),
        dict(attn, name="whisper-small prefill decoder B4 T64 H12 D64 causal",
             Tq=64, Tk=64, Hq=12, Hkv=12, D=64, seed=25, timed=True,
             path="whisper-small"),
        dict(attn, name="whisper-small prefill cross B4 Tq64 Tk1500 H12 D64",
             Tq=64, Tk=1500, Hq=12, Hkv=12, D=64, causal=False, seed=26,
             timed=True, path="whisper-small"),
        dict(attn, name="h2o-danube-3-4b B4 T256 Hq32 Hkv8 D120 causal, "
             "window 4096", Hq=32, Hkv=8, D=120, window=4096, seed=27,
             timed=True, path="h2o-danube-3-4b"),
        dict(attn, name="minicpm-2b B4 T256 Hq36 Hkv36 D64 causal", Hq=36,
             Hkv=36, D=64, seed=28, timed=True, path="minicpm-2b"),
        dict(attn, name="qwen2-vl-2b B4 T256 Hq12 Hkv2 D128 causal", Hq=12,
             Hkv=2, seed=29, timed=True, path="qwen2-vl-2b"),
        dict(attn, name="qwen2-vl-2b vision client B4 T512 Hq12 Hkv2 D128 "
             "causal", Tq=512, Tk=512, Hq=12, Hkv=2, seed=30, timed=True,
             path="qwen2-vl-2b"),
        dict(attn, name="qwen2-7b eval B16 T256 Hq28 Hkv4 D128 causal", B=16,
             seed=31, path="qwen2-7b"),
        dict(attn, name="zamba2-1.2b eval B16 T256 H32 D64 causal", B=16,
             Hq=32, Hkv=32, D=64, seed=32, path="zamba2-1.2b"),
        dict(attn, name="h2o-danube-3-4b eval B16 T256 Hq32 Hkv8 D120 "
             "causal, window 4096", B=16, Hq=32, Hkv=8, D=120, window=4096,
             seed=33, path="h2o-danube-3-4b"),
        dict(attn, name="minicpm-2b eval B16 T256 Hq36 Hkv36 D64 causal",
             B=16, Hq=36, Hkv=36, D=64, seed=34, path="minicpm-2b"),
        dict(attn, name="qwen2-vl-2b eval B16 T256 Hq12 Hkv2 D128 causal",
             B=16, Hq=12, Hkv=2, seed=35, path="qwen2-vl-2b"),
        # qwen3-moe-235b-a22b: 64 query heads over 4 KV heads (a group of
        # 16) in training (4 x 256), its 4 x 512 serving prefill and the
        # engine's eval of 16 test sequences
        dict(attn, name="qwen3-moe-235b-a22b B4 T256 Hq64 Hkv4 D128 causal "
             "(group 16)", Hq=64, Hkv=4, seed=41, timed=True, f64=True,
             path="qwen3-moe-235b-a22b"),
        dict(attn, name="qwen3-moe-235b-a22b prefill B4 T512 Hq64 Hkv4 D128 "
             "causal", Tq=512, Tk=512, Hq=64, Hkv=4, seed=42, timed=True,
             path="qwen3-moe-235b-a22b"),
        dict(attn, name="qwen3-moe-235b-a22b eval B16 T256 Hq64 Hkv4 D128 "
             "causal", B=16, Hq=64, Hkv=4, seed=43, timed=True,
             path="qwen3-moe-235b-a22b"),
        # phase 10: qwen2-7b's stacked group of 3 clients, folded into the
        # batch axis (its group of 4 clients shares B 16 with the eval)
        dict(attn, name="qwen2-7b stacked, 3 clients folded B12 T256 Hq28 "
             "Hkv4 D128 causal", B=12, seed=50, timed=True,
             path="qwen2-7b"),
        # phase 11: yi-6b's training launch path, the train CLI at its
        # defaults (4 x 64) and the train step at 4 x 256, whole and in
        # microbatches of 2
        dict(attn, name="yi-6b train CLI B4 T64 Hq32 Hkv4 D128 causal",
             Tq=64, Tk=64, Hq=32, Hkv=4, seed=70, timed=True, path="yi-6b"),
        dict(attn, name="yi-6b train step B4 T256 Hq32 Hkv4 D128 causal",
             Hq=32, Hkv=4, seed=71, timed=True, path="yi-6b"),
        dict(attn, name="yi-6b train microbatch B2 T256 Hq32 Hkv4 D128 "
             "causal", B=2, Hq=32, Hkv=4, seed=72, timed=True, path="yi-6b"),
        # phase 13 (b): the 4-layer step at 4 x 2048 tokens
        dict(attn, name="yi-6b train step B4 T2048 Hq32 Hkv4 D128 causal",
             Tq=2048, Tk=2048, Hq=32, Hkv=4, seed=76, timed=True,
             path="yi-6b"),
    ]
    ce = dict(N=1024, D=3584, V=152064, ignore_every=7)
    ce_cases = [
        dict(ce, name="slice N1024 D3584 V152064", path="qwen2-7b",
             f64=True),
        dict(name="ragged N=300 D=200 V=1000", N=300, D=200, V=1000,
             ignore_every=5),
        dict(name="all labels ignored", N=130, D=64, V=300, ignore_every=1),
        dict(name="mamba2-370m tied head (embed.T) N1024 D1024 V50288",
             N=1024, D=1024, V=50288, ignore_every=7, tied=True,
             timed=True, path="mamba2-370m", f64=True),
        dict(name="tied head, ragged N=300 D=200 V=1000", N=300, D=200,
             V=1000, ignore_every=5, tied=True),
        dict(name="rwkv6-7b head N1024 D4096 V65536", N=1024, D=4096,
             V=65536, ignore_every=7, timed=True, path="rwkv6-7b"),
        dict(name="unaligned D=203 V=1001 N=333 (4-byte copies)", N=333,
             D=203, V=1001, ignore_every=4),
        dict(name="tied head, unaligned D=203 V=1001 N=333", N=333, D=203,
             V=1001, ignore_every=4, tied=True),
        dict(name="zamba2-1.2b head N1024 D2048 V32000", N=1024, D=2048,
             V=32000, ignore_every=7, timed=True, path="zamba2-1.2b"),
        dict(name="whisper-small tied head (embed.T) N1024 D768 V51865",
             N=1024, D=768, V=51865, ignore_every=7, tied=True, timed=True,
             path="whisper-small"),
        dict(name="h2o-danube-3-4b head N1024 D3840 V32000", N=1024, D=3840,
             V=32000, ignore_every=7, path="h2o-danube-3-4b"),
        dict(name="minicpm-2b tied head (embed.T) N1024 D2304 V122753",
             N=1024, D=2304, V=122753, ignore_every=7, tied=True,
             path="minicpm-2b"),
        dict(name="qwen2-vl-2b tied head (embed.T) N1024 D1536 V151936",
             N=1024, D=1536, V=151936, ignore_every=7, tied=True,
             path="qwen2-vl-2b"),
        dict(name="qwen3-moe-235b-a22b head N1024 D4096 V151936", N=1024,
             D=4096, V=151936, ignore_every=7, timed=True, f64=True,
             path="qwen3-moe-235b-a22b"),
        # grouped launches (the stacked path: one head per client, each
        # group's rows against its own), each also held bitwise to its
        # groups' own ungrouped launches; at groups=1 that is today's
        # kernel on a (1, D, V) head
        dict(name="groups=1: a (1, D, V) head, ragged N=300 D=200 V=1000",
             N=300, D=200, V=1000, ignore_every=5, groups=1, seed=51),
        dict(name="groups=1: a tied (1, V, D) table, N=333 D=203 V=1001",
             N=333, D=203, V=1001, ignore_every=4, tied=True, groups=1,
             seed=52),
        dict(name="3 groups, unaligned D=203 V=1001 N=333 (4-byte copies)",
             N=333, D=203, V=1001, ignore_every=4, groups=3, seed=53),
        dict(name="3 tied groups, ragged N=300 D=200 V=1000", N=300, D=200,
             V=1000, ignore_every=5, tied=True, groups=3, seed=54),
        dict(name="qwen2-7b stacked heads, 3 groups N3072 D3584 V152064",
             N=3072, D=3584, V=152064, ignore_every=7, groups=3, seed=55,
             path="qwen2-7b"),
        dict(name="mamba2-370m stacked tied heads, 4 groups N4096 D1024 "
             "V50288", N=4096, D=1024, V=50288, ignore_every=7, tied=True,
             groups=4, seed=56, path="mamba2-370m", f64=True),
        dict(name="mamba2-370m engine group of 2, tied N2048 D1024 V50288",
             N=2048, D=1024, V=50288, ignore_every=7, tied=True, groups=2,
             seed=57, path="mamba2-370m"),
        dict(name="rwkv6-7b stacked heads, 4 groups N4096 D4096 V65536",
             N=4096, D=4096, V=65536, ignore_every=7, groups=4, seed=58,
             path="rwkv6-7b"),
        # phase 11: yi-6b's untied head in the train CLI (4 x 64 tokens),
        # the train step (4 x 256) and its microbatches of 2 x 256
        dict(name="yi-6b head N256 D4096 V64000 (train CLI)", N=256,
             D=4096, V=64000, ignore_every=7, seed=73, path="yi-6b"),
        dict(name="yi-6b head N1024 D4096 V64000 (train step)", N=1024,
             D=4096, V=64000, ignore_every=7, seed=74, path="yi-6b"),
        dict(name="yi-6b head N512 D4096 V64000 (train microbatch)",
             N=512, D=4096, V=64000, ignore_every=7, seed=75, path="yi-6b"),
        # phase 13 (b): 4 x 2048 tokens
        dict(name="yi-6b head N8192 D4096 V64000 (4 x 2048 step)", N=8192,
             D=4096, V=64000, ignore_every=7, seed=77, path="yi-6b"),
    ]
    for case in ce_cases:    # every path's head is timed
        if case.get("path"):
            case["timed"] = True
    ssd = dict(B=4, T=256, H=32, P=64, N=128)
    ssd_cases = [
        dict(ssd, name="slice B4 T256 H32 P64 N128", path="mamba2-370m"),
        dict(ssd, name="ragged T=200", T=200),
        dict(ssd, name="initial state, T=77", T=77, s0=True),
        dict(ssd, name="T=1, initial state", T=1, s0=True),
        dict(ssd, name="large dt (x30)", dt_scale=30.0),
        dict(name="reduced B2 T37 H8 P32 N16", B=2, T=37, H=8, P=32, N=16,
             s0=True),
        dict(name="zamba2-1.2b P64 N64, T=133", B=2, T=133, H=8, P=64, N=64,
             s0=True),
        dict(name="P=40 N=24 (ragged rows, padded state)", B=1, T=50, H=3,
             P=40, N=24, s0=True),
        # the serving prefill: mamba2-370m at 4 x 512 tokens
        dict(ssd, name="mamba2-370m prefill B4 T512 H32 P64 N128", T=512,
             seed=11, timed=True, path="mamba2-370m"),
        # a decode step: one token from the carried state
        dict(ssd, name="mamba2-370m decode B4 T1 H32 P64 N128", T=1,
             s0=True, seed=17, timed=True, path="mamba2-370m"),
        dict(name="zamba2-1.2b B4 T256 H64 P64 N64", B=4, T=256, H=64, P=64,
             N=64, seed=18, timed=True, path="zamba2-1.2b"),
        dict(name="zamba2-1.2b prefill B4 T512 H64 P64 N64", B=4, T=512,
             H=64, P=64, N=64, seed=36, timed=True, path="zamba2-1.2b"),
        dict(name="zamba2-1.2b decode B4 T1 H64 P64 N64", B=4, T=1, H=64,
             P=64, N=64, s0=True, seed=37, timed=True, path="zamba2-1.2b"),
        dict(ssd, name="mamba2-370m eval B16 T256 H32 P64 N128", B=16,
             seed=38, path="mamba2-370m"),
        dict(name="zamba2-1.2b eval B16 T256 H64 P64 N64", B=16, T=256,
             H=64, P=64, N=64, seed=39, path="zamba2-1.2b"),
        # grouped launches: A and D per group of B/G rows
        dict(name="groups=1: (1, H) A and D, reduced B2 T37 H8 P32 N16",
             B=2, T=37, H=8, P=32, N=16, s0=True, groups=1, seed=59),
        dict(name="3 groups, P=40 N=24, ragged T=77, initial state", B=6,
             T=77, H=3, P=40, N=24, s0=True, groups=3, seed=60),
        dict(ssd, name="mamba2-370m stacked, 4 groups B16 T256 H32 P64 "
             "N128", B=16, groups=4, seed=61, timed=True,
             path="mamba2-370m"),
        dict(ssd, name="mamba2-370m engine group of 2, B8 T256 H32 P64 "
             "N128", B=8, groups=2, seed=62, timed=True,
             path="mamba2-370m"),
    ]
    wkv = dict(B=4, T=256, H=64, D=64)
    wkv_cases = [
        dict(wkv, name="slice B4 T256 H64 D64", path="rwkv6-7b"),
        dict(wkv, name="ragged T=200", T=200),
        dict(wkv, name="initial state, T=77", T=77, s0=True),
        dict(wkv, name="T=1, initial state", T=1, s0=True),
        dict(wkv, name="exp(w) overflows", overflow=True),
        dict(wkv, name="decay ~1 (w - 8), initial state", decay_one=True,
             s0=True),
        dict(name="reduced B2 T37 H4 D32", B=2, T=37, H=4, D=32, s0=True),
        dict(name="reduced D32 at T=256", B=2, T=256, H=4, D=32, s0=True),
        dict(name="D=100 (padded rows), T=50", B=1, T=50, H=2, D=100,
             s0=True),
        dict(name="D=30 (4-byte copies), T=40", B=1, T=40, H=3, D=30,
             s0=True),
        # the serving prefill: rwkv6-7b at 4 x 512 tokens
        dict(wkv, name="rwkv6-7b prefill B4 T512 H64 D64", T=512, seed=12,
             timed=True, path="rwkv6-7b"),
        dict(wkv, name="rwkv6-7b decode B4 T1 H64 D64", T=1, s0=True,
             seed=19, timed=True, path="rwkv6-7b"),
        dict(wkv, name="rwkv6-7b eval B16 T256 H64 D64", B=16, seed=40,
             path="rwkv6-7b"),
        # grouped launches: u per group of B/G rows
        dict(name="groups=1: a (1, H, D) u, reduced B2 T37 H4 D32", B=2,
             T=37, H=4, D=32, s0=True, groups=1, seed=63),
        dict(name="3 groups, D=30 (4-byte copies), T=40", B=3, T=40, H=3,
             D=30, s0=True, groups=3, seed=64),
        dict(wkv, name="rwkv6-7b stacked, 4 groups B16 T256 H64 D64", B=16,
             groups=4, seed=65, timed=True, path="rwkv6-7b"),
    ]
    for case in attn_cases + ssd_cases + wkv_cases:
        if case.get("B") == 16:      # the engine's eval: timed as well
            case["timed"] = True
    out, checked = {}, {}
    log("kernels vs plain PyTorch on the card:")
    for key, check, cases in (
            ("flash_attention", check_attention, attn_cases),
            ("chunked_cross_entropy", check_ce, ce_cases),
            ("mamba2_scan", check_mamba2, ssd_cases),
            ("rwkv6_scan", check_rwkv6, wkv_cases)):
        for i, case in enumerate(cases):
            g = (torch.Generator(device="cuda").manual_seed(case["seed"])
                 if "seed" in case else gen)
            rec = check(g, case, timed=i == 0 or case.get("timed", False))
            if i == 0:
                out[key] = dict(rec)
            # an edge case may share a path's shape: the launches go to
            # the case that names the path
            shape = _case_key(key, case)
            held = checked.setdefault(key, {})
            if shape not in held or (case.get("path")
                                     and not held[shape]["path"]):
                held[shape] = dict(path=case.get("path"), shape=case["name"],
                                   **rec)
    return out, checked


# --------------------------------------------------------------- phase 4
def _launch_counters():
    from repro_torch.kernels.chunked_ce import chunked_cross_entropy
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_ssd import mamba2_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    return {"flash_attention": flash_attention,
            "chunked_cross_entropy": chunked_cross_entropy,
            "mamba2_scan": mamba2_scan, "rwkv6_scan": rwkv6_scan}


def check_reduced_on_card(arch: str) -> None:
    """The family's reduced model (4 layers; zamba2's 2 groups, whisper's
    2 + 2 layers over 64 frames): loss and its gradient norm on the card
    through the kernels equal the CPU's through the plain versions, from
    the same parameters and batch."""
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_reduced_config(arch)
    if cfg.family not in ("hybrid", "audio"):   # zamba2: 2 groups already
        cfg = dataclasses.replace(cfg, num_layers=4)
    lm = build(cfg)
    params = lm.init(0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["encoder_embeds"] = torch.randn(
            2, cfg.max_source_positions, cfg.d_model, generator=gen)
    got = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _ = lm.loss_fn(p, b)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        got[dev] = (loss.item(), float(torch.sqrt(sum(
            (g.double() ** 2).sum() for g in grads))))
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["cuda"], got["cpu"]))
    ok = rel <= LOSS_RTOL
    log(f"  {arch} reduced: loss {got['cuda'][0]:.6f} (card) vs "
        f"{got['cpu'][0]:.6f} (cpu), grad norm rel err {rel:.3e} (tol "
        f"{LOSS_RTOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{arch}: card and CPU disagree ({rel})")


def _instrument(engine):
    """Record each round's cohort and its peak device memory
    (``max_memory_allocated``, reset after each round)."""
    import torch
    cohorts, peaks = [], []
    sample = engine.sampler.sample

    def recording_sample(c, rd):
        ids = sample(c, rd)
        cohorts.append([int(k) for k in ids])
        return ids

    engine.sampler.sample = recording_sample
    run_round = engine.run_round

    def measured_round(state, rd, batch_fn):
        out = run_round(state, rd, batch_fn)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return out

    engine.run_round = measured_round
    return cohorts, peaks


def device_busy(fn):
    """``fn()`` under ``torch.profiler`` (device activity only, so that
    the host's own work is not slowed by tracing it): returns (its result,
    wall seconds, device-busy seconds — the union of every kernel, copy
    and fill on the card — and the count of device operations).  The
    device's idle share is 1 - busy / wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, lo, hi = 0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            busy += 0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += 0 if hi is None else hi - lo
    return out, wall, busy / 1e9, len(spans)


def _run_counted(engine):
    """``engine.run(eval_every=1)`` through :func:`_counted`; returns
    (state, history, launches, wall seconds, launches by shape)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    (state, history), launches, wall, shapes = _counted(
        lambda: engine.run(eval_every=1))
    return state, history, launches, wall, shapes


def _check_run(name, loss, history, state, multi_block) -> None:
    """A finite test loss, 2 records with accuracies in [0, 1], a cohort
    client with two blocks or more (unless ``multi_block`` is None: a
    method without blocks), finite server parameters."""
    import torch
    from repro_torch.tree import tree_leaves
    if not math.isfinite(loss):
        raise AssertionError(f"{name}: non-finite test loss {loss}")
    if len(history) != 2 or not all(
            r.accuracy is not None and 0.0 <= r.accuracy <= 1.0
            for r in history):
        raise AssertionError(f"{name}: bad history {history}")
    if multi_block is not None and not multi_block:
        raise AssertionError(f"{name}: no cohort client trained two "
                             f"blocks or more")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(state)):
        raise AssertionError(f"{name}: non-finite server parameters")


GIB = 2 ** 30
RECKON_LIMIT = 72 * GIB    # a run's reckoned peak must stay below this


def _block_train(mem, lo: int, hi: int, *, remat: bool = True,
                 **kw) -> int:
    """``mem.block_train_bytes(lo, hi, **kw)`` in the run's mode: with
    per-unit rematerialization (training's default) the block's units
    hold their inputs (the output of the unit before, as ``lm_memory``
    prices it) and, during one unit's recompute, that unit's activations
    (the largest), in place of every unit's activations."""
    b = mem.block_train_bytes(lo, hi, **kw)
    if remat:
        acts = [mem.units[k].activations for k in range(lo, hi)]
        ins = sum(mem.units[k - 1].output if k else mem.embed.output
                  for k in range(lo, hi))
        b += ins + max(acts) - sum(acts)
    return b


def _reckon(cfg, decomps, clients: list, held: int) -> tuple:
    """A round's reckoned peak (bytes) and how it was reckoned: the
    parameters, the largest block's training memory (``lm_memory`` at the
    run's batch 4 x 256 tokens with one optimizer slot: its weights'
    private copies, gradients and momentum, activations, each unit
    rematerialized: :func:`_block_train`) and ``held`` payloads of a
    whole model (the engine keeps each cohort payload until
    ``aggregate``)."""
    from repro_torch.core.memory_model import lm_memory
    mem = lm_memory(cfg, 4, 256)
    params = 4 * cfg.param_count()
    block = max(_block_train(mem, lo, hi, optimizer_slots=1)
                for k in clients for lo, hi in decomps[k].blocks)
    train = params + block + held * params
    merge = (held + 3) * params      # the state, every payload, the sum
    return max(train, merge), (
        f"the larger of {params / GIB:.2f} GiB parameters + "
        f"{block / GIB:.2f} GiB the largest block's training + {held} held "
        f"payloads of {params / GIB:.2f} GiB, and the aggregate's "
        f"{held + 3} models")


def _reckon_client(cfg, blocks: tuple, n_batches: int,
                   remat: bool = True) -> tuple:
    """A client update's reckoned peak (bytes), how it was reckoned, and
    each block's: the parameters, the block's training memory
    (``lm_memory`` at batch 4 x 256 with one optimizer slot: its
    weights' private copies, gradients and momentum, activations in the
    ``remat`` mode (:func:`_block_train`) and the ``n_batches`` buffered
    prefix outputs) and the copies the blocks before it trained and kept
    (their units, and the embed when the first block starts at 0; the
    head is trained in place from block to block, so it is counted once,
    in the block's training)."""
    from repro_torch.core.memory_model import lm_memory
    mem = lm_memory(cfg, 4, 256)
    params = mem.param_bytes()
    per_block = []
    for j, (lo, hi) in enumerate(blocks):
        kept = sum(mem.units[k].params for a, b in blocks[:j]
                   for k in range(a, b))
        if j and blocks[0][0] == 0:
            kept += mem.embed.params
        per_block.append(params + kept + _block_train(
            mem, lo, hi, remat=remat, optimizer_slots=1,
            n_batches=n_batches))
    return max(per_block), (
        f"{params / GIB:.2f} GiB parameters + the block's training + the "
        f"earlier blocks' trained copies; by block "
        f"{[round(b / GIB, 2) for b in per_block]} GiB"), per_block


def _step_memory():
    """Wrap ``blockwise.sgd_momentum_`` so that each SGD step records the
    bytes allocated at its entry and the run's peak so far at its end
    (``max_memory_allocated``, not reset); returns the records and a
    function that undoes the wrap."""
    import torch
    from repro_torch.core import blockwise
    inner, records = blockwise.sgd_momentum_, []

    def recorded(*args, **kwargs):
        torch.cuda.synchronize()
        entry = torch.cuda.memory_allocated()
        inner(*args, **kwargs)
        torch.cuda.synchronize()
        records.append((entry, torch.cuda.max_memory_allocated()))

    def restore():
        blockwise.sgd_momentum_ = inner

    blockwise.sgd_momentum_ = recorded
    return records, restore


def _held_to_reckoning(name: str, peak: int, reckoned: int,
                       gate: bool = True) -> None:
    """Log a run's measured peak (``max_memory_allocated``) beside its
    reckoning; with ``gate``, fail when the peak is over RECKON_LIMIT."""
    log(f"{name}: peak {peak / GIB:.2f} GiB, reckoned {reckoned / GIB:.2f} "
        f"GiB, measured - reckoned {(peak - reckoned) / GIB:+.2f} GiB")
    if gate and peak > RECKON_LIMIT:
        raise AssertionError(f"{name}: measured peak {peak / GIB:.2f} GiB "
                             f"over {RECKON_LIMIT / GIB:.0f} GiB")


def phase_path(arch: str, layers: int, kernels: tuple,
               method: str = "fedepth", clients: int = 6) -> dict:
    """Two rounds of ``method`` (``fedepth``, ``m-fedepth`` or
    ``depthfl``) on ``arch`` at every published width with ``layers``
    layers over ``clients`` clients; returns this run's launch counts and
    its launches by shape."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.decomposition import schedule_summary
    from repro_torch.fl.engine import RoundEngine, SimConfig
    from repro_torch.fl.registry import get_strategy
    from repro_torch.fl.seq import build_lm_context, build_seq_data
    from repro_torch.models import build

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    cut = (f"(cut from {full.num_layers})" if layers < full.num_layers
           else "(all)")
    name = f"{cfg.name} ({method})"
    log(f"path {name}: family {cfg.family} d_model {cfg.d_model} vocab "
        f"{cfg.vocab_size} tied head {cfg.tie_embeddings} layers "
        f"{cfg.num_layers} {cut}, {cfg.param_count() / 1e9:.3f} B params")
    check_reduced_on_card(arch)
    # DepthFL takes every client, so that the r = 1 client's joint 4-layer
    # prefix and the average over masks of two depths run on the card
    sim = SimConfig(rounds=2, participation=1.0 if method == "depthfl"
                    else 0.5, lr=0.05, momentum=0.9, local_steps=1,
                    batch_size=4, scenario="fair", seed=0)
    data = build_seq_data(clients, n_per_client=16, n_test=16,
                          vocab_size=cfg.vocab_size, seq_len=256, seed=0)
    ctx = build_lm_context(data, sim, cfg)
    engine = RoundEngine(get_strategy(method), ctx)
    blockwise = method != "depthfl"
    if blockwise:
        for cid, dec in enumerate(ctx.decomps):
            log(f"client {cid} (r={ctx.ratios[cid]:.3f}): "
                + schedule_summary(dec, ctx.mem).replace("\n", " |"))
        cohort = max(1, int(sim.participation * clients))
        reckoned, how = _reckon(cfg, ctx.decomps, range(clients),
                                cohort - 1)
        log(f"reckoned peak {reckoned / GIB:.2f} GiB ({how}; cohort "
            f"{cohort} of {clients})")
        if cfg.family == "moe" and reckoned > RECKON_LIMIT:
            raise AssertionError(f"{name}: reckoned peak "
                                 f"{reckoned / GIB:.2f} GiB over "
                                 f"{RECKON_LIMIT / GIB:.0f} GiB")
    cohorts, peaks = _instrument(engine)
    state, history, launches, wall, shapes = _run_counted(engine)
    with torch.no_grad():
        loss = float(build(cfg).loss_fn(state, {"tokens": data.x_test[:4],
                                                "labels": data.y_test[:4]})[0])
    log(f"test loss after 2 rounds: {loss:.4f}")
    for rd, ids in enumerate(cohorts):
        if blockwise:
            work = (f"blocks per client "
                    f"{[len(ctx.decomps[k].blocks) for k in ids]}")
        else:
            work = (f"prefix depth per client (layers [0, d), one block) "
                    f"{[engine.strategy.client_depth(ctx, k) for k in ids]}")
        log(f"round {rd + 1}: cohort {ids}, {work}")
    for rec, peak in zip(history, peaks):
        log(f"round {rec.round}: accuracy {rec.accuracy}  seconds "
            f"{rec.seconds:.2f}  up bytes {rec.comm_bytes}  down bytes "
            f"{rec.down_bytes}  max_memory_allocated "
            f"{peak / 2**30:.2f} GiB")
    log(f"path {name}: 2 rounds in {wall:.1f} s, launches {launches}")
    if blockwise:
        _held_to_reckoning(name, max(peaks), reckoned,
                           gate=cfg.family == "moe")
    clients = [k for ids in cohorts for k in ids]
    # a model of one depth unit (qwen3-moe cut to 1 layer) has one block
    multi = blockwise and build(cfg).num_depth_units > 1
    _check_run(name, loss, history, state,
               any(len(ctx.decomps[k].blocks) >= 2 for k in clients)
               if multi else None)
    if method == "m-fedepth" and not bool(
            (state["aux_norms"][:-1] != 1).any()):
        raise AssertionError(f"{name}: no intermediate aux norm trained")
    if method == "depthfl":
        depths = {engine.strategy.client_depth(ctx, k) for k in clients}
        if len(depths) < 2 or max(depths) < 2:
            raise AssertionError(f"{name}: the cohorts trained prefixes of "
                                 f"depths {sorted(depths)} only, not a "
                                 f"multi-layer prefix beside a shallower one")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels {missing} were not "
                             f"launched: {launches}")
    # ``_instrument``'s wrappers tie the engine into a reference cycle:
    # collect it now, or its context (DepthFL's cached masks) outlives the
    # run into the next one's peak
    del state, engine, ctx, data
    gc.collect()
    torch.cuda.empty_cache()
    return launches, shapes


def _recording_shapes(fn):
    """``fn()`` with each kernel wrapper's calls through ``kernels.ops``
    recorded by :func:`_launch_key`, counting only the calls that launched
    the kernel: (its result, {kernel: {shape: launches}})."""
    from repro_torch.kernels import ops
    # each wrapper in ops by the kernel it launches: K1's vocab-shard form
    # (a head split over the vocab, the sharded route) is K1's launch
    kernel_of = dict({name: name for name in KERNEL_META},
                     cross_entropy_lse_gold="chunked_cross_entropy")
    inner = {attr: getattr(ops, attr) for attr in kernel_of}
    counters = _launch_counters()
    shapes = {}

    def recording(attr):
        wrapper, name = inner[attr], kernel_of[attr]
        counter = counters[name]

        def call(*args, **kw):
            before = counter.launches
            out = wrapper(*args, **kw)
            if counter.launches > before:
                per = shapes.setdefault(name, {})
                key = _launch_key(name, args, kw)
                per[key] = per.get(key, 0) + counter.launches - before
            return out
        return call

    for attr in inner:
        setattr(ops, attr, recording(attr))
    try:
        return fn(), shapes
    finally:
        for attr, wrapper in inner.items():
            setattr(ops, attr, wrapper)


def _attention_modes(shapes: dict) -> dict:
    """K2's launches by mode: {"causal" | "non-causal" (Tq = Tk) |
    "cross" (Tq != Tk): launches}."""
    modes = {}
    for key, n in shapes.get("flash_attention", {}).items():
        _, Tq, Tk, _, _, _, causal, _, _ = key
        mode = ("cross" if Tq != Tk else "causal" if causal
                else "non-causal")
        modes[mode] = modes.get(mode, 0) + n
    return modes


def _lm_client_update(name: str, lm, params, dec, batches,
                      kernels: tuple, reckoned: int = None) -> dict:
    """One FeDepth ``client_update`` of ``lm`` on the card (``lr`` 0.05,
    momentum 0.9, the prefix cache on), its launch counts and K2's modes
    read from that call alone; checks finite, moved parameters and the
    ``kernels`` launched, and, given its ``reckoned`` peak, that the
    measured one is within RECKON_LIMIT; returns the launches and the
    launches by shape."""
    import torch
    from repro_torch.core import blockwise
    from repro_torch.tree import tree_leaves
    runner = blockwise.lm_runner(lm)
    with torch.no_grad():
        before = float(blockwise.full_model_loss(runner, params, batches[0]))
    torch.cuda.reset_peak_memory_stats()
    out, launches, secs, shapes = _counted(
        lambda: blockwise.client_update(runner, params, dec, batches,
                                        lr=0.05, momentum=0.9))
    modes = _attention_modes(shapes)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        after = float(blockwise.full_model_loss(runner, out, batches[0]))
    moved = sum(not torch.equal(a, b) for a, b in zip(tree_leaves(out),
                                                      tree_leaves(params)))
    log(f"  {name}: blocks {dec.blocks}, {len(batches)} batches, "
        f"{secs:.2f} s, peak {peak / 2**30:.2f} GiB, loss on batch 0 "
        f"{before:.4f} -> {after:.4f}, {moved} leaves moved, launches "
        f"{launches}, K2 calls by mode {modes}")
    if reckoned is not None:
        _held_to_reckoning(f"  {name}", peak, reckoned)
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(out))
    missing = [k for k in kernels if launches[k] <= 0]
    if not (finite and math.isfinite(after) and moved and not missing):
        raise AssertionError(f"{name}: finite {finite}, loss {after}, "
                             f"moved {moved}, kernels not launched "
                             f"{missing}")
    return launches, shapes


def phase_vlm_client(device="cuda") -> dict:
    """qwen2-vl-2b (4 layers) with 256 stubbed vision embeddings before 4 x
    256 tokens: one client update over blocks [0, 1), [1, 3), [3, 4)
    (the VLM runner: no loss on the vision prefix; no M-RoPE positions
    reach the units, as in the reference)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.decomposition import Decomposition
    from repro_torch.models import build
    cfg = dataclasses.replace(get_config("qwen2-vl-2b"), num_layers=4)
    lm = build(cfg)
    params = lm.init(0, device=device)
    gen = torch.Generator(device=device).manual_seed(21)
    batches = []
    for _ in range(2):
        toks = torch.randint(0, cfg.vocab_size, (4, 257), generator=gen,
                             device=device)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                        "vision_embeds": _vlm_inputs(
                            cfg, 4, 256, gen, device)["vision_embeds"]})
    run = _lm_client_update(
        "qwen2-vl-2b client update with a vision prefix", lm, params,
        Decomposition(((0, 1), (1, 3), (3, 4)), 0, 0), batches,
        ("chunked_cross_entropy", "flash_attention"))
    del params, batches
    torch.cuda.empty_cache()
    return run


MOE_ARCH = "qwen3-moe-235b-a22b"


def phase_moe_client(device="cuda") -> dict:
    """One FeDepth client update of qwen3-moe-235b-a22b at every published
    width and 2 layers (of 94) over 4 x 256 tokens, 2 batches, blocks
    [0, 1), [1, 2): the hand-off from one MoE block to the next.  Its
    peak is reckoned (``_reckon_client``) and measured, each within
    RECKON_LIMIT.  Before it, llama4-maverick's reduced loss and
    gradients (4 layers: two units of a dense and a MoE layer) and its
    reduced decode walk, card vs CPU (qwen3-moe's run in its path and
    its serving)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.decomposition import Decomposition
    from repro_torch.models import build
    check_reduced_on_card("llama4-maverick-400b-a17b")
    check_serving_reduced("llama4-maverick-400b-a17b", device)
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=2)
    blocks, n_batches = ((0, 1), (1, 2)), 2
    reckoned, how, per_block = _reckon_client(cfg, blocks, n_batches)
    log(f"  {MOE_ARCH} client update: reckoned peak {reckoned / GIB:.2f} "
        f"GiB ({how})")
    if reckoned > RECKON_LIMIT:
        raise AssertionError(f"{MOE_ARCH}: client update reckoned "
                             f"{reckoned / GIB:.2f} GiB over "
                             f"{RECKON_LIMIT / GIB:.0f} GiB")
    lm = build(cfg)
    params = lm.init(0, device=device)
    gen = torch.Generator(device=device).manual_seed(44)
    batches = []
    for _ in range(n_batches):
        toks = torch.randint(0, cfg.vocab_size, (4, 257), generator=gen,
                             device=device)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    records, restore = _step_memory()
    try:
        run = _lm_client_update(
            f"{MOE_ARCH} client update, 2 layers (cut from "
            f"{full.num_layers})", lm, params, Decomposition(blocks, 0, 0),
            batches, ("chunked_cross_entropy", "flash_attention"), reckoned)
    finally:
        restore()
    # the steps run block by block, one per batch
    for i, (entry, peak) in enumerate(records):
        j = i // n_batches
        log(f"    block {blocks[j]} step {i % n_batches + 1}: "
            f"{entry / GIB:.2f} GiB allocated at entry, peak so far "
            f"{peak / GIB:.2f} GiB; the block reckoned "
            f"{per_block[j] / GIB:.2f} GiB")
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()
    return run


WHISPER_BATCH, WHISPER_TOKENS = 4, 256


def _whisper_inputs(cfg, B: int, T: int, gen, device):
    """B x T random tokens and B stubbed frame inputs (fp32)."""
    import torch
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                                    device=device),
            "encoder_embeds": torch.randn(B, cfg.max_source_positions,
                                          cfg.d_model, generator=gen,
                                          device=device)}


def _whisper_batches(cfg, n: int, gen, device):
    """``n`` training batches: 4 stubbed 1500-frame inputs (fp32) and 4 x
    256 tokens."""
    out = []
    for _ in range(n):
        b = _whisper_inputs(cfg, WHISPER_BATCH, WHISPER_TOKENS + 1, gen,
                            device)
        toks = b.pop("tokens")
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:], **b})
    return out


def phase_whisper_client(device="cuda") -> dict:
    """whisper-small at every published width and all 24 units (12
    encoder, 12 decoder): one FeDepth client update under the ``fair``
    scenario's budget for r = 1/3, priced by ``lm_memory`` at batch 4
    and 256 tokens over 1500 frames, two batches.  K1 (the tied head) and
    K2 must launch, K2 non-causal (encoder), causal (decoder) and cross
    (Tq 256 against Tk 1500) all."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.decomposition import decompose, schedule_summary
    from repro_torch.core.memory_model import lm_memory
    from repro_torch.fl.engine import client_ratios, scenario_budgets
    from repro_torch.models import build
    cfg = get_config("whisper-small")
    log(f"path {cfg.name} (fedepth client update): d_model {cfg.d_model} "
        f"encoder {cfg.encoder_layers} + decoder {cfg.num_layers} layers "
        f"(all), {cfg.max_source_positions} frames, vocab {cfg.vocab_size} "
        f"tied head, {cfg.param_count() / 1e9:.3f} B params")
    check_reduced_on_card(cfg.name)
    lm = build(cfg)
    mem = lm_memory(cfg, WHISPER_BATCH, WHISPER_TOKENS)
    ratios = client_ratios(6, "fair", 0)
    k = int(np.argmin(np.abs(ratios - 1 / 3)))
    dec = decompose(mem, int(scenario_budgets(mem, ratios)[k]))
    log(f"  r = {ratios[k]:.3f}: "
        + schedule_summary(dec, mem).replace("\n", " |"))
    params = lm.init(0, device=device)
    gen = torch.Generator(device=device).manual_seed(22)
    run = _lm_client_update(
        "whisper-small client update", lm, params, dec,
        _whisper_batches(cfg, 2, gen, device),
        ("chunked_cross_entropy", "flash_attention"))
    modes = _attention_modes(run[1])
    if set(modes) != {"causal", "non-causal", "cross"}:
        raise AssertionError(f"whisper-small: K2 modes {modes}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return run


# --------------------------------------------------------------- phase 5
IMAGE_RUNS = (
    # (method, scenario, scheduler) of the paper's experiment on
    # PreResNet-20, then the baselines it is compared against, then the
    # vectorized scheduler's runs, each held to its sequential run
    ("fedepth", "fair", "sequential"), ("m-fedepth", "fair", "sequential"),
    ("fedepth", "surplus", "sequential"), ("fedavg", "fair", "sequential"),
    ("heterofl", "fair", "sequential"), ("splitmix", "fair", "sequential"),
    ("depthfl", "fair", "sequential"), ("fedavg", "fair", "vectorized"),
    ("heterofl", "fair", "vectorized"), ("fedepth", "fair", "vectorized"))
VEC_RTOL, VEC_ATOL = 2e-4, 2e-5   # vectorized vs sequential final state


def _card_vs_cpu(name: str, params, loss_fn=None) -> None:
    """A PreResNet-20 loss (``testing.relu.resnet_gradients_on``'s
    ``loss_fn``, by default the CE of the logits) and its gradient norm
    on the card (cuDNN, TF32 off) equal the CPU's, from the same
    parameters and batch.  The batch is the first seeded one whose ReLU
    inputs take the same branch on both devices (an input within rounding
    of 0 may not, and then the two gradients differ there by design, not
    by a fault)."""
    import torch
    from repro_torch.configs.preresnet20 import CONFIG
    from repro_torch.testing.relu import resnet_gradients_on
    seed, out = resnet_gradients_on(params, CONFIG,
                                    log=lambda m: log(f"  {m}"),
                                    loss_fn=loss_fn)
    got = {dev: (out[dev][1].item(), float(torch.sqrt(sum(
        (g.double() ** 2).sum() for g in out[dev][2:])))) for dev in out}
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["cuda"], got["cpu"]))
    ok = rel <= LOSS_RTOL
    log(f"  {name} (batch seed {seed}): loss {got['cuda'][0]:.6f} "
        f"(card) vs {got['cpu'][0]:.6f} (cpu), grad norm "
        f"{got['cuda'][1]:.6f} vs {got['cpu'][1]:.6f}, rel err {rel:.3e} "
        f"(tol {LOSS_RTOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: card and CPU disagree ({rel})")


def check_resnet20_on_card() -> None:
    """Full PreResNet-20's CE loss, card vs CPU (:func:`_card_vs_cpu`)."""
    from repro_torch.configs.preresnet20 import CONFIG
    from repro_torch.models import resnet
    _card_vs_cpu(CONFIG.name, resnet.init(0, CONFIG, device="cpu"))


def check_depthfl_on_card() -> None:
    """DepthFL's joint loss at full depth (the mean CE of the four aux
    exits and the head) of full PreResNet-20, card vs CPU, its gradient
    over the parameters and the aux heads."""
    import torch
    from repro_torch.configs.preresnet20 import CONFIG
    from repro_torch.fl import baselines
    from repro_torch.models import resnet
    params = resnet.init(0, CONFIG, device="cpu")
    aux = baselines.depthfl_init_aux(
        CONFIG, torch.Generator().manual_seed(1), device="cpu")

    def joint_loss(p, images, labels):
        exits = baselines.depthfl_logits(CONFIG, p[0], p[1],
                                         CONFIG.num_blocks, images)
        return torch.stack(exits), baselines.depthfl_loss(exits, labels)

    _card_vs_cpu(f"DepthFL joint loss on {CONFIG.name}, {len(aux)} aux "
                 f"exits and the head", (params, aux), joint_loss)


def _image_loss(method: str, strategy, state, x, y) -> float:
    """The test CE of a method's server state: the x min r subnet
    (fedavg), SplitMix's ensemble, DepthFL's model without its aux heads,
    else the full model."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.preresnet20 import CONFIG
    from repro_torch.models import resnet
    with torch.no_grad():
        if method == "splitmix":
            logits = state.ensemble_logits(x)
        elif method == "depthfl":
            logits = resnet.apply(state[0], CONFIG, x)
        else:
            logits = resnet.apply(state, getattr(strategy, "sub_cfg",
                                                 CONFIG), x)
        return float(F.cross_entropy(logits, y))


def _client_work(method: str, ctx, strategy, k: int, trained) -> str:
    """What client ``k`` trained in a round, for the log."""
    from repro_torch.configs.preresnet20 import CONFIG
    from repro_torch.fl.width import subnet_config
    if method in ("fedepth", "m-fedepth"):
        mkd = ", MKD" if ctx.surplus[k] > 1 else ""
        return f"{len(ctx.decomps[k].blocks)} blocks{mkd}"
    r = min(float(ctx.ratios[k]), 1.0)
    if method == "heterofl":
        return f"r {r:.3f} widths {subnet_config(CONFIG, r).widths()}"
    if method == "splitmix":
        return f"capacity {len(trained[k])} bases {trained[k]}"
    if method == "depthfl":
        return f"depth {strategy.client_depth(ctx, k)}"
    return f"the {strategy.sub_cfg.name} subnet"


def _image_engine(data, method: str, scenario: str, scheduler: str,
                  **engine_kw):
    """The ``RoundEngine`` of a phase-5 run: 2 rounds of ``method`` under
    ``scenario`` on full-width PreResNet-20 with the ``scheduler`` (the
    vectorized one with ``min_group=1``) and ``engine_kw`` (the wire)."""
    from repro_torch.configs.preresnet20 import CONFIG
    from repro_torch.fl.engine import RoundEngine, SimConfig, build_context
    from repro_torch.fl.registry import get_strategy
    from repro_torch.fl.sampling import VectorizedScheduler
    sim = SimConfig(rounds=2, participation=0.1, lr=0.05, momentum=0.9,
                    local_steps=1, batch_size=64, scenario=scenario, seed=0)
    return RoundEngine(get_strategy(method),
                       build_context(data, sim, model_cfg=CONFIG),
                       scheduler=(VectorizedScheduler(min_group=1)
                                  if scheduler == "vectorized"
                                  else scheduler), **engine_kw)


def _final_state(data, method: str, scheduler: str, dtype):
    """(final state, history) of a phase-5 run under ``fair`` with its
    parameters in ``dtype`` (``data`` holds images of that dtype)."""
    from repro_torch.tree import tree_map
    engine = _image_engine(data, method, "fair", scheduler)
    setup = getattr(engine.strategy, "setup", None)
    if setup is not None:
        setup(engine.ctx)
    init = tree_map(lambda t: t.to(dtype),
                    engine.strategy.init_state(engine.ctx))
    return engine.run(initial_state=init, eval_every=2)


def phase_image(data, method: str, scenario: str,
                scheduler: str = "sequential"):
    """Two rounds of ``method`` under ``scenario`` on full-width
    PreResNet-20 with the ``scheduler`` (the vectorized one with
    ``min_group=1``: every client with a key takes the stacked path);
    returns (the final state, the history, the peaks), after checking
    that no kernel launched."""
    import torch
    from repro_torch.configs.preresnet20 import CONFIG

    name = f"{method} ({scenario}, {scheduler})"
    engine = _image_engine(data, method, scenario, scheduler)
    ctx = engine.ctx
    stacked = []     # the clients that took the stacked path
    if scheduler == "vectorized":
        update_batched = engine.strategy.client_update_batched

        def recording_batched(c, state, ids, batches):
            stacked.extend(ids)
            return update_batched(c, state, ids, batches)

        engine.strategy.client_update_batched = recording_batched
    cohorts, peaks = _instrument(engine)
    trained = {}     # SplitMix: the base ids each client trained
    if method == "splitmix":
        client_update = engine.strategy.client_update

        def recording_update(c, state, k, batches):
            result = client_update(c, state, k, batches)
            trained[k] = [b for b, _ in result.payload]
            return result

        engine.strategy.client_update = recording_update
    state, history, launches, wall, _ = _run_counted(engine)
    loss = _image_loss(method, engine.strategy, state, data.x_test[:512],
                       data.y_test[:512])
    cfg = getattr(engine.strategy, "sub_cfg", CONFIG)
    if method == "splitmix":
        cfg = state.base_cfg
        log(f"image run {name}: {state.k} base nets")
    log(f"image run {name}: {cfg.name} widths {cfg.widths()} blocks "
        f"{cfg.num_blocks}, test loss after 2 rounds {loss:.4f}")
    fedepth = method in ("fedepth", "m-fedepth")
    clients = [k for ids in cohorts for k in ids]
    for rd, ids in enumerate(cohorts):
        work = [_client_work(method, ctx, engine.strategy, k, trained)
                for k in ids]
        log(f"round {rd + 1}: cohort {ids}, trained: {'; '.join(work)}")
    for rec, peak in zip(history, peaks):
        log(f"round {rec.round}: accuracy {rec.accuracy}  seconds "
            f"{rec.seconds:.2f}  up bytes {rec.comm_bytes}  down bytes "
            f"{rec.down_bytes}  max_memory_allocated "
            f"{peak / 2**30:.3f} GiB")
    log(f"image run {name}: 2 rounds in {wall:.1f} s, launches {launches}")
    _check_run(name, loss, history,
               state.bases if method == "splitmix" else state,
               any(len(ctx.decomps[k].blocks) >= 2 for k in clients)
               if fedepth else None)
    if any(r.down_bytes <= 0 or r.comm_bytes <= 0 for r in history):
        raise AssertionError(f"{name}: a round priced no bytes: {history}")
    if scenario == "surplus" and not any(ctx.surplus[k] > 1
                                         for k in clients):
        raise AssertionError(f"{name}: no cohort client ran MKD")
    if scheduler == "vectorized" and sorted(stacked) != sorted(clients):
        raise AssertionError(f"{name}: clients {sorted(stacked)} took the "
                             f"stacked path, not the cohorts' {clients}")
    launched = {k: n for k, n in launches.items() if n}
    if launched:
        raise AssertionError(f"{name}: the image path launched kernels "
                             f"{launched}")
    del engine, ctx
    gc.collect()    # the engine's reference cycle, as in ``phase_path``
    torch.cuda.empty_cache()
    return state, history, peaks


def _max_err(a, b) -> float:
    from repro_torch.tree import tree_leaves
    return max(float((x - y).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _states_close(a, b) -> bool:
    """Every leaf of ``b`` within VEC_ATOL + VEC_RTOL |a| of ``a``'s."""
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        bool(((x - y).abs() <= VEC_ATOL + VEC_RTOL * x.abs()).all())
        for x, y in zip(la, lb))


def check_same_run(method: str, seq, vec, data) -> None:
    """A vectorized run against the sequential run of the same method.

    fp32 (the timed runs): the same up and down bytes each round; the
    round seconds and peaks side by side; the states' distance, logged
    beside the distance between two sequential fp32 runs (cuDNN's
    default backward algorithms are not deterministic, and a ReLU input
    within rounding of 0 takes either branch, so two fp32 runs of the
    same scheduler already differ beyond VEC_RTOL / VEC_ATOL at this
    size).  float64 (``data``'s images in float64): the final states
    within VEC_RTOL / VEC_ATOL and the same bytes — the equivalence
    itself, held where rounding cannot reach a kink."""
    import torch
    (s_seq, h_seq, p_seq), (s_vec, h_vec, p_vec) = seq, vec
    for (r1, m1), (r2, m2) in zip(zip(h_seq, p_seq), zip(h_vec, p_vec)):
        log(f"  {method} round {r1.round}: sequential {r1.seconds:.3f} s "
            f"{m1 / 2**30:.3f} GiB, vectorized {r2.seconds:.3f} s "
            f"{m2 / 2**30:.3f} GiB (x{r1.seconds / r2.seconds:.2f})")
    spread = _max_err(s_seq, _final_state(data, method, "sequential",
                                          torch.float32)[0])
    data64 = dataclasses.replace(data, x=data.x.double(),
                                 x_test=data.x_test.double())
    s64, h64 = _final_state(data64, method, "sequential", torch.float64)
    v64, hv64 = _final_state(data64, method, "vectorized", torch.float64)

    def wire(history):
        return [(r.comm_bytes, r.down_bytes) for r in history]

    same_bytes = wire(h_seq) == wire(h_vec) and wire(h64) == wire(hv64)
    ok = _states_close(s64, v64) and same_bytes
    log(f"  {method}: fp32 vectorized vs sequential max_abs_err "
        f"{_max_err(s_seq, s_vec):.3e}, sequential vs itself {spread:.3e}; "
        f"float64 vectorized vs sequential {_max_err(s64, v64):.3e} (rtol "
        f"{VEC_RTOL:g} atol {VEC_ATOL:g}); same bytes {same_bytes} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{method}: the vectorized run differs from the "
                             f"sequential one")
    del s64, v64, data64
    gc.collect()
    torch.cuda.empty_cache()
    for scheduler in ("sequential", "vectorized"):
        # the phase's two rounds, then a third under the profiler
        engine = _image_engine(data, method, "fair", scheduler)
        setup = getattr(engine.strategy, "setup", None)
        if setup is not None:
            setup(engine.ctx)
        state, batch_fn = engine.strategy.init_state(engine.ctx), \
            engine.default_batch_fn()
        for rd in range(2):
            state, _, _ = engine.run_round(state, rd, batch_fn)
        log_idle_share(f"  {method} {scheduler}", engine, state, 2)
        del engine, state
        gc.collect()
        torch.cuda.empty_cache()


def log_idle_share(name: str, engine, state, rd: int) -> None:
    """Log round ``rd``'s device idle share from ``state``
    (:func:`device_busy`); the round's result is dropped."""
    _, wall, busy, n = device_busy(lambda: engine.run_round(
        state, rd, engine.default_batch_fn()))
    log(f"{name}: profiled round {rd + 1} {wall:.3f} s, device busy "
        f"{busy:.4f} s over {n} device operations, idle share "
        f"{1 - busy / wall:.4f}")


COMM_RUNS = (("fp16", "sliced"), ("qsgd_int8", "delta"), ("topk", "delta"))


def _comm_run(data, codec: str, downlink: str) -> None:
    """Two FeDepth rounds (``fair``) on full-width PreResNet-20 under
    ``codec`` (error feedback on) and ``downlink``: each round's up bytes
    equal the cohort's ``size_bytes`` of the whole model (a FeDepth
    payload is the whole model, delta-coded), its down bytes the sliced
    state per client (delta: a first-time participant's, at most that for
    a repeat one); logs the host seconds of encoding and decoding a
    round.  No kernel launches."""
    from repro_torch.fl.comm import get_codec
    from repro_torch.tree import tree_bytes
    name = f"fedepth (fair) codec {codec}, downlink {downlink}"
    engine = _image_engine(data, "fedepth", "fair", "sequential",
                           codec=codec, downlink=downlink)
    chan = engine.channel
    host = [0.0, 0.0]

    def timed(i, fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            host[i] += time.perf_counter() - t0
            return out
        return call

    chan.encode_result = timed(0, chan.encode_result)
    chan.decode_result = timed(1, chan.decode_result)
    per_round = []
    run_round = engine.run_round

    def round_with_host(state, rd, batch_fn):
        host[:] = [0.0, 0.0]
        out = run_round(state, rd, batch_fn)
        per_round.append(tuple(host))
        return out

    engine.run_round = round_with_host
    cohorts, peaks = _instrument(engine)
    state, history, launches, wall, _ = _run_counted(engine)
    loss = _image_loss("fedepth", engine.strategy, state, data.x_test[:512],
                       data.y_test[:512])
    size = get_codec(codec).size_bytes(state)
    dense = tree_bytes(state)
    seen, bad = set(), []
    for rec, ids, (enc_s, dec_s), peak in zip(history, cohorts, per_round,
                                              peaks):
        repeats = [k for k in ids if k in seen]
        seen.update(ids)
        up_want = len(ids) * size
        down_full = len(ids) * dense
        log(f"  {name} round {rec.round}: cohort {ids}, up bytes "
            f"{rec.comm_bytes} (size_bytes x {len(ids)} = {up_want}), down "
            f"bytes {rec.down_bytes} (dense x {len(ids)} = {down_full}; "
            f"repeat participants {repeats}), encode {enc_s:.3f} s + decode "
            f"{dec_s:.3f} s on the host, round {rec.seconds:.2f} s, "
            f"accuracy {rec.accuracy}, peak {peak / GIB:.3f} GiB")
        if rec.comm_bytes != up_want:
            bad.append(f"round {rec.round} up bytes")
        exact = downlink == "sliced" or not repeats
        if (rec.down_bytes != down_full) if exact \
                else not 0 < rec.down_bytes <= down_full:
            bad.append(f"round {rec.round} down bytes")
    log(f"  {name}: raw payload {dense} bytes, on the wire {size} "
        f"(x{dense / size:.2f}), test loss {loss:.4f}, 2 rounds in "
        f"{wall:.1f} s, launches {launches}")
    _check_run(name, loss, history, state, None)
    launched = {k: n for k, n in launches.items() if n}
    if bad or launched:
        raise AssertionError(f"{name}: {bad}, launched {launched}")
    del engine
    gc.collect()


def check_none_codec_bitwise(data) -> None:
    """``codec="none"`` with ``downlink="full"`` on the card: two FeDepth
    rounds through the engine equal, bitwise, the same rounds with no
    channel (sample, the scheduler's updates, raw bytes, aggregate)."""
    import torch
    # cuDNN's default convolution backward accumulates with atomics: two
    # identical runs differ in the last bits.  Deterministic algorithms
    # for this check; a second channel-free run is the control.
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        got = [_none_rounds(data, channel)
               for channel in (True, False, False)]
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    (b1, s1), (b2, s2), (b3, s3) = got
    control = b2 == b3 and all(torch.equal(a, b) for a, b in zip(s2, s3))
    same = b1 == b2 and all(torch.equal(a, b) for a, b in zip(s1, s2))
    log(f"  fedepth (fair) codec none, downlink full: bytes {b1} vs the "
        f"channel-free rounds' {b2}, states bitwise equal {same} "
        f"(deterministic cuDNN; two channel-free runs equal: {control}) "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("codec none: the engine differs from the "
                             "channel-free rounds")
    gc.collect()


def _none_rounds(data, channel: bool):
    """Two FeDepth rounds with the engine's ``codec="none"`` channel, or
    without any channel: ([(up, down) a round], the final leaves)."""
    from repro_torch.fl.strategy import wire_bytes
    from repro_torch.tree import tree_leaves
    engine = _image_engine(data, "fedepth", "fair", "sequential")
    ctx, strategy = engine.ctx, engine.strategy
    strategy.setup(ctx)
    state = strategy.init_state(ctx)
    batch_fn = engine.default_batch_fn()
    log_ = []
    for rd in range(2):
        if channel:
            state, up, down = engine.run_round(state, rd, batch_fn)
        else:
            cohort = engine.sampler.sample(ctx, rd)
            down = len(cohort) * wire_bytes(state)
            results = engine.scheduler.run(ctx, strategy, state, cohort,
                                           batch_fn)
            up = sum(wire_bytes(r.payload) for r in results)
            state = strategy.aggregate(ctx, state, results)
        log_.append((up, down))
    return log_, tree_leaves(state)


def phase_comm(data) -> None:
    """The wire layer on the paper's experiment (full-width PreResNet-20,
    100 clients): ``codec="none"`` bitwise the channel-free engine, then
    the lossy codecs and the sliced / delta downlinks (``COMM_RUNS``)."""
    log("wire codecs: FeDepth on PreResNet-20, 2 rounds each")
    check_none_codec_bitwise(data)
    for codec, downlink in COMM_RUNS:
        _comm_run(data, codec, downlink)


def phase_images():
    """Phase 5; returns the synthetic CIFAR-10-shaped data for the comm
    phase."""
    from repro_torch.fl.data import build_federated
    log("paper experiment: PreResNet-20 on CIFAR-10's shape")
    check_resnet20_on_card()
    check_depthfl_on_card()
    t0 = time.perf_counter()
    data = build_federated(num_clients=100, partition="dirichlet", alpha=1.0,
                           balanced=True, n_train=50_000, n_test=10_000,
                           num_classes=10, image_size=32, seed=0)
    log(f"data: {len(data.x)} train / {len(data.x_test)} test images "
        f"{tuple(data.x.shape[1:])} over {len(data.client_indices)} "
        f"clients in {time.perf_counter() - t0:.1f} s")
    vectorized = {m for m, _, sched in IMAGE_RUNS if sched == "vectorized"}
    runs = {}
    for method, scenario, scheduler in IMAGE_RUNS:
        out = phase_image(data, method, scenario, scheduler)
        if scheduler == "vectorized":
            check_same_run(method, runs.pop(method), out, data)
        elif method in vectorized and scenario == "fair":
            runs[method] = out
    return data


# --------------------------------------------------------------- phase 6
def check_vit_on_card() -> None:
    """Full ViT-T/16: loss, gradient norm and every gradient leaf on the
    card (fp32 matmuls) against the CPU's, from the same parameters and
    batch, each relative error <= LOSS_RTOL (a leaf's: its largest
    difference over its largest magnitude); and fig7's check (a): every
    ``vit_memory`` unit costs the same."""
    import torch
    from repro_torch.configs.vit_t16 import CONFIG
    from repro_torch.core.blockwise import _ce_logits
    from repro_torch.core.memory_model import vit_memory
    from repro_torch.models import vit
    from repro_torch.tree import tree_leaves, tree_map
    for batch in (8, 64):
        costs = {u.train_bytes() for u in vit_memory(CONFIG, batch).units}
        log(f"  vit_memory at batch {batch}: {len(costs)} distinct unit "
            f"cost(s) {sorted(costs)} over {CONFIG.num_layers} units "
            f"{'ok' if len(costs) == 1 else 'FAIL'}")
        if len(costs) != 1:
            raise AssertionError(f"ViT units priced apart: {costs}")
    params = vit.init(0, CONFIG, device="cpu")
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(16, CONFIG.image_size, CONFIG.image_size,
                         CONFIG.in_channels, generator=gen)
    labels = torch.randint(0, CONFIG.num_classes, (16,), generator=gen)
    got = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(), params)
        loss = _ce_logits(vit.apply(p, CONFIG, images.to(dev)),
                          labels.to(dev))
        grads = [g.cpu() for g in torch.autograd.grad(loss, tree_leaves(p))]
        got[dev] = (loss.item(), grads)
    (l_gpu, g_gpu), (l_cpu, g_cpu) = got["cuda"], got["cpu"]

    def norm(gs):
        return float(torch.sqrt(sum((g.double() ** 2).sum() for g in gs)))

    rel_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    rel_norm = abs(norm(g_gpu) - norm(g_cpu)) / norm(g_cpu)
    rel_leaf = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(g_gpu, g_cpu))
    ok = max(rel_loss, rel_norm, rel_leaf) <= LOSS_RTOL
    log(f"  {CONFIG.name}: loss {l_gpu:.6f} (card) vs {l_cpu:.6f} (cpu), "
        f"grad norm {norm(g_gpu):.6f} vs {norm(g_cpu):.6f}, rel err loss "
        f"{rel_loss:.3e} norm {rel_norm:.3e} worst leaf {rel_leaf:.3e} (tol "
        f"{LOSS_RTOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{CONFIG.name}: card and CPU disagree")


def _check_no_launches(name: str, launches: dict) -> None:
    launched = {k: n for k, n in launches.items() if n}
    if launched:
        raise AssertionError(f"{name}: launched kernels {launched}")


def _zero_launches() -> dict:
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def phase_fig7() -> None:
    """Paper Fig. 7 at full width, as ``benchmarks/fig7_vit_finetune.py``
    runs it (there on the reduced ViT): 8 clients (Dirichlet alpha 1,
    1600 / 400 synthetic 32 x 32 images, seed 3), 6 rounds of 4 clients,
    one batch of 64 a client, 2 local steps, lr 0.05, momentum 0.9.
    FeDepth on ViT-T/16 with the decomposition of
    ``block_train_bytes(0, L // 3)`` (blocks of 4), then FedAvg on the
    x1/6 ViT from the same stream.  Prints both test accuracies; check
    (b), depth-wise above x1/6, is printed, not gated."""
    import numpy as np
    import torch
    from repro_torch.configs.vit_t16 import CONFIG
    from repro_torch.core.blockwise import vit_runner
    from repro_torch.core.decomposition import decompose
    from repro_torch.core.memory_model import vit_memory
    from repro_torch.fl.data import build_federated
    from repro_torch.fl.engine import RoundEngine, SimConfig
    from repro_torch.fl.registry import get_strategy
    from repro_torch.fl.strategies.fedepth import FedepthStrategy
    from repro_torch.fl.strategy import Context
    from repro_torch.models import vit
    from repro_torch.tree import tree_leaves

    L = CONFIG.num_layers
    data = build_federated(num_clients=8, alpha=1.0, n_train=1600, n_test=400,
                           image_size=CONFIG.image_size, seed=3)
    mem = vit_memory(CONFIG, batch=32)
    dec = decompose(mem, mem.block_train_bytes(0, max(1, L // 3)))
    if dec.blocks != ((0, 4), (4, 8), (8, 12)):
        raise AssertionError(f"fig7 decomposition {dec.blocks}")
    sim = SimConfig(rounds=6, participation=0.5, lr=0.05, momentum=0.9,
                    local_steps=2, batch_size=64, scenario="fair", seed=3)
    ctx = Context(sim=sim, num_clients=8, sizes=data.client_sizes(),
                  rng=np.random.default_rng(3), seed=3,
                  device=data.x.device, model_cfg=CONFIG, mem=mem,
                  decomps=[dec] * 8, data=data)

    def batch_fn(k):     # fig7 draws one batch of 64 a client
        return [data.client_batch(k, 64, ctx.rng)]

    accs = {}
    for name, strategy, init in (
            ("fedepth", FedepthStrategy(runner=vit_runner(CONFIG)),
             vit.init(3, CONFIG)),
            ("fedavg x1/6", get_strategy("fedavg"), None)):
        engine = RoundEngine(strategy, ctx)
        cohorts, peaks = _instrument(engine)
        counters = _zero_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, history = engine.run(initial_state=init, batch_fn=batch_fn,
                                    eval_every=sim.rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        cfg = getattr(strategy, "sub_cfg", CONFIG)
        accs[name] = history[-1].accuracy
        log(f"fig7 {name}: {cfg.name} dims {vit.dims(cfg)}, blocks "
            f"{dec.blocks if name == 'fedepth' else 'the whole model'}, "
            f"cohorts {cohorts}; {sim.rounds} rounds and the eval in "
            f"{wall:.2f} s ({wall / sim.rounds:.3f} s a round), peak "
            f"{max(peaks) / 2**30:.3f} GiB, test accuracy {accs[name]:.4f}, "
            f"launches {launches}")
        _check_no_launches(f"fig7 {name}", launches)
        if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(state)):
            raise AssertionError(f"fig7 {name}: non-finite parameters")
        del engine, state
        gc.collect()
        torch.cuda.empty_cache()
    log(f"fig7 check (b), not gated: fedepth-ViT {accs['fedepth']:.4f} vs "
        f"FedAvg(x1/6) {accs['fedavg x1/6']:.4f}: depth-wise "
        f"{'above' if accs['fedepth'] > accs['fedavg x1/6'] else 'NOT above'}")


def phase_cross_device_vit(n_rounds: int = 3) -> None:
    """``benchmarks/round_engine.py``'s ``cross_device_vit`` at full width:
    FeDepth on ViT-T/16 over 400 clients (8 images each, Dirichlet alpha
    1), participation 0.25 (cohort 100), batch 8, 2 local steps, lr
    0.05, seed 0, one shared decomposition (blocks of 4).  ``n_rounds``
    rounds with the sequential scheduler, then as many with the
    vectorized one, from the same initial state and the same stream;
    the final states must agree within VEC_RTOL / VEC_ATOL, and no
    kernel may launch.  Logs each round's seconds and peak, and the
    steady rounds' (all but the first) seconds and rounds/s."""
    import numpy as np
    import torch
    from repro_torch.configs.vit_t16 import CONFIG
    from repro_torch.core.blockwise import vit_runner
    from repro_torch.core.decomposition import decompose
    from repro_torch.core.memory_model import vit_memory
    from repro_torch.fl.data import build_federated
    from repro_torch.fl.engine import RoundEngine, SimConfig
    from repro_torch.fl.strategies.fedepth import FedepthStrategy
    from repro_torch.fl.strategy import Context
    from repro_torch.models import vit
    from repro_torch.tree import tree_leaves

    clients, batch = 400, 8
    data = build_federated(num_clients=clients, alpha=1.0,
                           n_train=clients * batch, n_test=400,
                           image_size=CONFIG.image_size, seed=0)
    mem = vit_memory(CONFIG, batch=batch)
    dec = decompose(mem, mem.block_train_bytes(0, CONFIG.num_layers // 3))
    init = vit.init(0, CONFIG)
    finals = {}
    for sched in ("sequential", "vectorized"):
        sim = SimConfig(rounds=n_rounds, participation=0.25, lr=0.05,
                        local_steps=2, batch_size=batch, seed=0)
        ctx = Context(sim=sim, num_clients=clients,
                      sizes=data.client_sizes(),
                      rng=np.random.default_rng(0), seed=0,
                      device=data.x.device, model_cfg=CONFIG,
                      mem=mem, decomps=[dec] * clients, data=data)
        engine = RoundEngine(FedepthStrategy(runner=vit_runner(CONFIG)),
                             ctx, scheduler=sched)
        batch_fn = engine.default_batch_fn()
        cohorts, peaks = _instrument(engine)    # peaks: one a round
        aggregate, agg_secs = engine.strategy.aggregate, []

        def timed_aggregate(c, state, results):
            t0 = time.perf_counter()
            out = aggregate(c, state, results)
            torch.cuda.synchronize()
            agg_secs.append(time.perf_counter() - t0)
            return out

        engine.strategy.aggregate = timed_aggregate
        counters = _zero_launches()
        state, secs = init, []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for rd in range(n_rounds):
            t0 = time.perf_counter()
            state, up, down = engine.run_round(state, rd, batch_fn)
            secs.append(time.perf_counter() - t0)
            log(f"cross_device_vit {sched} round {rd + 1}: "
                f"{secs[-1]:.3f} s (FedAvg over the cohort {agg_secs[-1]:.3f}"
                f" s), peak {peaks[-1] / 2**30:.3f} GiB, up {up} down {down} "
                f"bytes")
        launches = {k: fn.launches for k, fn in counters.items()}
        _check_no_launches(f"cross_device_vit {sched}", launches)
        steady = float(np.median(secs[1:]))
        finals[sched] = (state, steady)
        log(f"cross_device_vit {sched}: steady round {steady:.3f} s "
            f"({1 / steady:.2f} rounds/s, "
            f"{len(cohorts[-1]) / steady:.1f} clients/s), peak "
            f"{max(peaks) / 2**30:.3f} GiB, blocks {dec.blocks}, launches "
            f"{launches}")
        log_idle_share(f"cross_device_vit {sched}", engine, state, n_rounds)
        del engine, ctx
        gc.collect()
        torch.cuda.empty_cache()
    (s_seq, t_seq), (s_vec, t_vec) = finals["sequential"], \
        finals["vectorized"]
    la, lb = tree_leaves(s_seq), tree_leaves(s_vec)
    err = max(float((a - b).abs().max()) for a, b in zip(la, lb))
    ok = all(bool(((a - b).abs() <= VEC_ATOL + VEC_RTOL * a.abs()).all())
             for a, b in zip(la, lb))
    log(f"cross_device_vit: vectorized / sequential speed x{t_seq / t_vec:.2f}"
        f"; final states max_abs_err {err:.3e} (rtol {VEC_RTOL:g} atol "
        f"{VEC_ATOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"cross_device_vit: schedulers disagree ({err})")


def phase_vit() -> None:
    log("paper Fig. 7: ViT-T/16 at full width")
    check_vit_on_card()
    phase_fig7()
    phase_cross_device_vit()


# --------------------------------------------------------------- phase 7
SERVE_RUNS = (
    # (arch, the kernels its prefill must launch, the kernel its decode
    # steps must launch: the dense, vlm and hybrid decode attention is
    # plain)
    ("yi-6b", ("flash_attention",), None),
    ("h2o-danube-3-4b", ("flash_attention",), None),
    ("minicpm-2b", ("flash_attention",), None),
    ("qwen2-vl-2b", ("flash_attention",), None),
    ("mamba2-370m", ("mamba2_scan",), "mamba2_scan"),
    ("rwkv6-7b", ("rwkv6_scan",), "rwkv6_scan"),
    ("zamba2-1.2b", ("flash_attention", "mamba2_scan"), "mamba2_scan"),
    ("qwen3-moe-235b-a22b", ("flash_attention",), None),
)
# depth cuts of the serving runs: qwen3-moe's 94 layers are 233 GB in
# fp32; 4 layers (44.8 GB) fit the card beside the prefill.  The others
# serve half their published depth: the decode walks are host-paced
# (~2.5 ms a layer a step on a slow host), and at full depth serving
# took 161.6 s of a script that took 1216.8 s of its 1200 (one H100
# 80GB HBM3 at 700 W, a slow host).  The margin: with this cut and
# MAMBA2_LAYERS the whole script took 870.4–991.0 s on two hosts, and
# one tree's time has moved ~23 % between hosts (991.0 and 1215.8 s),
# which leaves 1200 s no room for full-depth serving (~+80 s)
SERVE_LAYERS = {"yi-6b": 16, "h2o-danube-3-4b": 12, "minicpm-2b": 20,
                "qwen2-vl-2b": 14, "mamba2-370m": 24, "rwkv6-7b": 16,
                "zamba2-1.2b": 18, "qwen3-moe-235b-a22b": 4}
SERVE_BATCH = 4
PREFILL_TOKENS = 512         # the timed prefill: batch 4 x 512 tokens
SERVE_PROMPT, SERVE_GEN = 64, 32   # the serve loop: 64-token prompts, 32 new
DECODE_ATOL, DECODE_RTOL = 3e-2, 5e-2   # decode vs prefill, the reference's
                                        # (tests/test_arch_smoke.py)


def _vlm_inputs(cfg, B: int, T: int, gen, device) -> dict:
    """A VLM's stubbed vision prefix (B, P, d) and text M-RoPE positions
    (3, B, T): each text token at its index on all three axes."""
    import torch
    if cfg.family != "vlm":
        return {}
    P = cfg.frontend_embed_tokens
    return {"vision_embeds": torch.randn(B, P, cfg.d_model, generator=gen,
                                         device=device),
            "mrope_positions": torch.arange(T, device=device).expand(3, B, T)}


def _rel(a, b) -> float:
    """Largest difference over the largest magnitude of ``b``."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def _walk(lm, params, toks, dtype=None):
    """Feed ``toks`` (B, T) one at a time through a fresh cache on their
    device (every leaf in ``dtype`` if given); the logits after each."""
    from repro_torch.models import init_cache
    cache = init_cache(lm.cfg, toks.shape[0], toks.shape[1],
                       device=toks.device)
    if dtype is not None:
        cache = {k: v.to(dtype) for k, v in cache.items()}
    out = []
    for t in range(toks.shape[1]):
        logits, cache = lm.decode_step(params, toks[:, t:t + 1], cache, t)
        out.append(logits)
    return out


def check_serving_reduced(arch: str, device="cuda") -> None:
    """The reduced config on the card: the decode walk's logits after the
    last prompt token against ``prefill``'s, within the reference's atol
    3e-2 / rtol 5e-2 (the bf16 caches bound the agreement).  A MoE
    decode routes with a capacity of 1 an expert at batch 2 and drops
    tokens the prefill keeps (the reference's behaviour: ROADMAP §3
    fault 14), so there the walk is held to the same walk on the CPU
    instead (relative 1e-4), and its distance from prefill is logged."""
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build
    from repro_torch.tree import tree_map
    cfg = get_reduced_config(arch)
    lm = build(cfg)
    params = lm.init(0, device=device)
    gen = torch.Generator(device=device).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 10), generator=gen,
                         device=device)
    dec = _walk(lm, params, toks)[-1]
    pf = lm.prefill(params, {"tokens": toks})
    if cfg.family == "moe":
        cpu = _walk(lm, tree_map(lambda t: t.cpu(), params), toks.cpu())[-1]
        rel = _rel(dec.cpu(), cpu)
        ok = math.isfinite(rel) and rel <= LOSS_RTOL
        log(f"  {arch} reduced: decode walk card vs cpu rel err {rel:.3e} "
            f"(tol {LOSS_RTOL:g}) {'ok' if ok else 'FAIL'}; decode vs "
            f"prefill max_abs_err {float((dec - pf).abs().max()):.3e} "
            f"(capacity 1 an expert at decode; logged)")
        if not ok:
            raise AssertionError(f"{arch} reduced: decode on the card and "
                                 f"the CPU disagree ({rel})")
        return
    err = float((dec - pf).abs().max())
    ok = bool(((dec - pf).abs() <= DECODE_ATOL + DECODE_RTOL * pf.abs()).all())
    log(f"  {arch} reduced on the card: decode vs prefill max_abs_err "
        f"{err:.3e} (atol {DECODE_ATOL:g} rtol {DECODE_RTOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{arch} reduced: decode and prefill disagree")


def _two_layers(cfg):
    """``cfg`` cut to 2 layers: zamba2 to one group (its 5 mamba layers
    and the shared block), whisper to 2 encoder + 2 decoder layers."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=cfg.hybrid_attn_every)
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, num_layers=2, encoder_layers=2)
    return dataclasses.replace(cfg, num_layers=2)


def check_serving_two_layers(arch: str, device="cuda") -> None:
    """Every published width, depth cut to 2 (:func:`_two_layers`):
    prefill logits on the card against the CPU (relative 1e-4: the largest difference over the
    largest logit; a VLM with its vision prefix and M-RoPE positions),
    and 8 decode steps of one prompt on each, each carrying its own
    cache (the distance is logged: a bf16 cache entry on a rounding
    boundary may round either way and move the later steps)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.tree import tree_map
    cfg = _two_layers(get_config(arch))
    lm = build(cfg)
    on_card = lm.init(0, device=device)
    params = tree_map(lambda t: t.cpu(), on_card)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    batch = {"tokens": toks, **_vlm_inputs(cfg, 2, 32, gen, "cpu")}
    got = lm.prefill(on_card, {k: v.to(device) for k, v in batch.items()})
    want = lm.prefill(params, batch)
    rel = _rel(got.cpu(), want)
    ok = math.isfinite(rel) and rel <= LOSS_RTOL
    walks = [_walk(lm, p, toks[:, :8].to(d)) for p, d in
             ((on_card, device), (params, "cpu"))]
    dec = max(_rel(a.cpu(), b) for a, b in zip(*walks))
    log(f"  {arch} at every width, {cfg.num_layers} layers: prefill{' (vision prefix, '
        'M-RoPE)' if cfg.family == 'vlm' else ''} card vs cpu rel err "
        f"{rel:.3e} (tol {LOSS_RTOL:g}) {'ok' if ok else 'FAIL'}; 8 decode "
        f"steps card vs cpu, largest rel err {dec:.3e} (logged)")
    if not ok:
        raise AssertionError(f"{arch}: prefill on the card and the CPU "
                             f"disagree ({rel})")


def _counted(fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after, and its launches recorded by shape: (its result, the
    launches, synchronised seconds, {kernel: {shape: launches}}).  Fails
    if a launch did not go through ``kernels.ops``, where it is recorded."""
    import torch
    counters = _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, shapes = _recording_shapes(fn)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    for name, n in launches.items():
        if sum(shapes.get(name, {}).values()) != n:
            raise AssertionError(f"{name}: {n} launches, by shape through "
                                 f"kernels.ops {shapes.get(name)}")
    return out, launches, secs, shapes


def _bounds(cfg, params, B: int, T: int, P: int, gen: int):
    """The least times of a prefill of B x T tokens and of one decode step
    at batch B (prompts of P tokens, ``gen`` generated): each the larger
    of its bytes at 3.35 TB/s and its flops at fp32 67 TFLOP/s (the port
    computes in fp32 with TF32 off), as ``bound_ms`` tuples.  Parameters
    are read once, an untied embedding only for the rows looked up.  A
    prefill multiplies every weight but the head by its B x T tokens
    (a VLM's vision prefix among them) and the head by the B last ones,
    plus attention's 4 hd flops per live (q, k) pair and q head.  A decode
    step multiplies every weight by its B tokens, reads the KV slots
    written so far (the mean over the generated steps) and writes one,
    and reads and writes an SSM state whole."""
    from repro_torch.configs.shapes import cache_specs
    from repro_torch.tree import tree_leaves
    n = sum(t.numel() for t in tree_leaves(params))
    head = cfg.d_model * cfg.vocab_size
    touched = n if cfg.tie_embeddings else n - head   # drop an untied embed
    if cfg.family == "moe":
        # a token multiplies only its top-k experts (k of E); the bytes
        # below still read every expert once, as a prefill of 2048 tokens
        # reaches them all
        n_moe = sum(k == "moe" for k in cfg.layer_kinds())
        idle = (cfg.num_experts - cfg.experts_per_token) * 3 \
            * cfg.d_model * cfg.moe_d_ff * n_moe
        touched_flops = touched - idle
    else:
        touched_flops = touched
    t_all = T + (cfg.frontend_embed_tokens if cfg.family == "vlm" else 0)
    n_attn = (cfg.num_layers // cfg.hybrid_attn_every
              if cfg.family == "hybrid" else cfg.num_layers)
    per_pair = 4.0 * cfg.head_dim * cfg.num_heads * n_attn * B
    window = cfg.sliding_window or t_all
    pairs = sum(min(i + 1, window) for i in range(t_all))
    pf = bound_ms(2.0 * B * t_all * (touched_flops - head) + 2.0 * B * head
                  + per_pair * pairs,
                  4.0 * (touched + B * t_all * cfg.d_model))
    cache_bytes, attn = 0.0, 0.0
    for key, spec in cache_specs(cfg, B, P + gen).items():
        size = math.prod(spec.shape) * spec.dtype.itemsize
        if key in ("k", "v"):
            S = spec.shape[2]
            valid = sum(min(P + g + 1, S) for g in range(gen)) / gen
            cache_bytes += size * (valid + 1) / S
            attn += per_pair * valid / 2    # q.k for "k", p.v for "v"
        else:
            cache_bytes += 2 * size
    # a decode step reads the weights its B tokens need: a MoE layer only
    # the experts they route to (at most B * k of E)
    read = touched
    if cfg.family == "moe":
        used = min(cfg.num_experts, B * cfg.experts_per_token)
        read = touched - (cfg.num_experts - used) * 3 * cfg.d_model \
            * cfg.moe_d_ff * n_moe
    dec = bound_ms(2.0 * B * touched_flops + attn,
                   4.0 * (read + B * cfg.d_model) + cache_bytes)
    return pf, dec


def phase_serve_model(arch: str, prefill_kernels: tuple, decode_kernel,
                      device="cuda", layers=None) -> dict:
    """Serve ``arch`` at every published width on the card, at its
    published depth or cut to ``layers``:
    seeded init, one timed ``LM.prefill`` of 4 x 512 tokens (a VLM's
    256 vision embeddings and M-RoPE positions too) after an untimed
    one, then ``launch.serve.serve`` at batch 4 (64-token prompts, 32
    generated tokens).  Checks the launches (K1 none; each of
    ``prefill_kernels`` on the prefill; ``decode_kernel`` on the decode steps, K2 on none)
    and finite logits; logs the decode walk against a prefill of the same
    prompts.  Returns the prefill's and the serve loop's launches, each
    with its launches by shape."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build
    from repro_torch.tree import tree_bytes
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers) if layers else full
    depth = (f"(cut from {full.num_layers})"
             if cfg.num_layers < full.num_layers else "(all)")
    check_serving_reduced(arch, device)
    check_serving_two_layers(arch, device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = build(cfg)
    t0 = time.perf_counter()
    params = lm.init(0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pbytes = tree_bytes(params)
    gen = torch.Generator(device=device).manual_seed(4)
    B, T = SERVE_BATCH, PREFILL_TOKENS
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T),
                                     generator=gen, device=device),
             **_vlm_inputs(cfg, B, T, gen, device)}
    first_s = _counted(lambda: lm.prefill(params, batch))[2]
    logits, pf_launch, pf_s, pf_shapes = _counted(
        lambda: lm.prefill(params, batch))
    pf_peak = torch.cuda.max_memory_allocated()
    prompt = torch.randint(0, cfg.vocab_size, (B, SERVE_PROMPT),
                           generator=gen, device=device)
    res, dec_launch, _, dec_shapes = _counted(
        lambda: serve(lm, params, prompt, SERVE_GEN))
    peak = torch.cuda.max_memory_allocated()
    pf_prompt = lm.prefill(params, {"tokens": prompt})
    dist = float((res.prompt_logits - pf_prompt).abs().max())
    within = bool(((res.prompt_logits - pf_prompt).abs()
                   <= DECODE_ATOL + DECODE_RTOL * pf_prompt.abs()).all())
    # what the bf16 cache leaves cost: the same walk with every leaf fp32
    dist32 = float((_walk(lm, params, prompt, torch.float32)[-1]
                    - pf_prompt).abs().max())
    _, wall, busy, n_ops = device_busy(lambda: _walk(lm, params,
                                                     prompt[:, :8]))
    finite = all(bool(torch.isfinite(t).all())
                 for t in (logits, res.logits, res.prompt_logits))
    step_ms = res.decode_seconds / SERVE_GEN * 1e3
    (pf_b, pf_by, _), (dec_b, dec_by, _) = _bounds(
        cfg, params, B, T, SERVE_PROMPT, SERVE_GEN)
    log(f"serve {arch}: d_model {cfg.d_model} layers {cfg.num_layers} {depth} "
        f"vocab {cfg.vocab_size} tied {cfg.tie_embeddings}, "
        f"{cfg.param_count() / 1e9:.3f} B params, {pbytes / 1e9:.2f} GB "
        f"fp32, init {init_s:.2f} s")
    log(f"  prefill {B} x {T} tokens"
        f"{f' + {cfg.frontend_embed_tokens} vision' if cfg.family == 'vlm' else ''}"
        f": {pf_s:.4f} s (first call {first_s:.4f} s), bound {pf_b / 1e3:.4f}"
        f" s ({pf_by}), peak {pf_peak / 2**30:.2f} GiB, launches {pf_launch}")
    log(f"  serve {B} x ({SERVE_PROMPT} prompt + {SERVE_GEN} generated): "
        f"prompt walk {res.prompt_seconds:.3f} s, decode {step_ms:.3f} ms a "
        f"token (a step of {B} sequences), bound {dec_b:.3f} ms ({dec_by}), "
        f"{SERVE_GEN * B / res.decode_seconds:.1f} tok/s, peak "
        f"{peak / 2**30:.2f} GiB (parameters {pbytes / 2**30:.2f} GiB), "
        f"launches {dec_launch}")
    log(f"  profiled 8-step decode walk: {wall:.3f} s, device busy "
        f"{busy:.4f} s over {n_ops} device operations, idle share "
        f"{1 - busy / wall:.4f}")
    log(f"  decode walk vs prefill of the same prompts: max_abs_err "
        f"{dist:.3e} ({'within' if within else 'NOT within'} atol "
        f"{DECODE_ATOL:g} rtol {DECODE_RTOL:g}, logged; largest |logit| "
        f"{float(pf_prompt.abs().max()):.3e}); with fp32 cache leaves "
        f"{dist32:.3e}; finite {finite}")
    if not finite:
        raise AssertionError(f"serve {arch}: non-finite logits")
    bad = []
    if pf_launch["chunked_cross_entropy"] or dec_launch["chunked_cross_entropy"]:
        bad.append("K1 launched")
    bad += [f"prefill launched no {k}" for k in prefill_kernels
            if pf_launch[k] <= 0]
    if dec_launch["flash_attention"]:
        bad.append("decode launched flash_attention")
    if decode_kernel and dec_launch[decode_kernel] <= 0:
        bad.append(f"decode launched no {decode_kernel}")
    if bad:
        raise AssertionError(f"serve {arch}: {bad}")
    del params, logits, res, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill": (pf_launch, pf_shapes),
            "decode": (dec_launch, dec_shapes)}


WHISPER_PROMPT, WHISPER_STEPS = 64, 32   # prefill tokens; decode steps


def _whisper_encode(lm, params, frames):
    """The encoder's output for ``frames``, in ``enc_out``'s cache dtype
    (bf16)."""
    import torch
    from repro_torch.configs.shapes import cache_specs
    from repro_torch.models import whisper
    dtype = cache_specs(lm.cfg, frames.shape[0], 1)["enc_out"].dtype
    with torch.inference_mode():
        return whisper.encode(params, lm.cfg, frames).to(dtype)


def _whisper_walk(lm, params, enc_out, toks):
    """``enc_out`` (from :func:`_whisper_encode`) in a fresh cache, then
    ``toks`` (B, T) fed one at a time through ``decode_step``; the logits
    after each."""
    from repro_torch.models import init_cache
    cache = init_cache(lm.cfg, toks.shape[0], toks.shape[1],
                       device=toks.device)
    cache["enc_out"] = enc_out
    out = []
    for t in range(toks.shape[1]):
        logits, cache = lm.decode_step(params, toks[:, t:t + 1], cache, t)
        out.append(logits)
    return out


def _whisper_bounds(cfg, B: int, T: int, steps: int):
    """Least times of a prefill (B x S frames, B x T tokens) and of one
    decode step at batch B, as ``bound_ms`` tuples at fp32 67 TFLOP/s and
    3.35 TB/s: 2 flops a weight a token (the encoder's weights over the
    frames, the decoder's over the tokens, the tied head over the B last
    ones), attention's 4 D flops a live (q, k) pair (encoder S x S,
    decoder causal, cross T x S); the parameters read once.  A step
    multiplies the decoder's weights by B tokens and, as the reference
    does, recomputes every layer's cross K / V from ``enc_out`` (4 D^2
    flops a frame a layer); it reads the bf16 ``enc_out`` and the K / V
    written so far (the mean over the steps)."""
    D, S, V = cfg.d_model, cfg.max_source_positions, cfg.vocab_size
    attn_p = 4 * D * D
    enc_p = attn_p + 2 * D * cfg.d_ff
    dec_p = 2 * attn_p + 2 * D * cfg.d_ff
    params = (cfg.encoder_layers * enc_p + cfg.num_layers * dec_p + V * D
              + (cfg.max_seq_len + S) * D)
    enc_fl = cfg.encoder_layers * B * (2.0 * enc_p * S + 4.0 * D * S * S)
    dec_fl = cfg.num_layers * B * (2.0 * dec_p * T + 4.0 * D * (
        T * (T + 1) / 2 + T * S))
    pf = bound_ms(enc_fl + dec_fl + 2.0 * B * D * V,
                  4.0 * (params + B * S * D) + 4.0 * B * V)
    kv = cfg.num_layers * 2 * B * D * 2 * (steps + 1) / 2
    step_fl = cfg.num_layers * B * (2.0 * dec_p + 4.0 * D * S
                                    + 4.0 * D * S * D) + 2.0 * B * D * V
    step = bound_ms(step_fl, 4.0 * (cfg.num_layers * dec_p + V * D)
                    + 2.0 * B * S * D + kv)
    return pf, step


def check_whisper_serving_small(device="cuda") -> None:
    """The reduced whisper on the card: the decode walk (``enc_out`` in
    bf16) against ``prefill`` within atol 3e-2 / rtol 5e-2; at every
    published width cut to 2 + 2 layers, the prefill on the card against
    the CPU (relative 1e-4) and 8 decode steps (logged)."""
    import torch
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.models import build
    from repro_torch.tree import tree_map
    cfg = get_reduced_config("whisper-small")
    lm = build(cfg)
    params = lm.init(0, device=device)
    gen = torch.Generator(device=device).manual_seed(2)
    batch = _whisper_inputs(cfg, 2, 10, gen, device)
    dec = _whisper_walk(lm, params, _whisper_encode(
        lm, params, batch["encoder_embeds"]), batch["tokens"])[-1]
    pf = lm.prefill(params, batch)
    err = float((dec - pf).abs().max())
    ok = bool(((dec - pf).abs() <= DECODE_ATOL + DECODE_RTOL * pf.abs()).all())
    log(f"  whisper-small reduced on the card: decode vs prefill max_abs_err "
        f"{err:.3e} (atol {DECODE_ATOL:g} rtol {DECODE_RTOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("whisper reduced: decode and prefill disagree")
    cfg = _two_layers(get_config("whisper-small"))
    lm = build(cfg)
    on_card = lm.init(0, device=device)
    params = tree_map(lambda t: t.cpu(), on_card)
    gen = torch.Generator().manual_seed(3)
    batch = _whisper_inputs(cfg, 2, 32, gen, "cpu")
    got = lm.prefill(on_card, {k: v.to(device) for k, v in batch.items()})
    rel = _rel(got.cpu(), lm.prefill(params, batch))
    ok = math.isfinite(rel) and rel <= LOSS_RTOL
    walks = [_whisper_walk(lm, p, _whisper_encode(
                 lm, p, batch["encoder_embeds"].to(d)),
                 batch["tokens"][:, :8].to(d))
             for p, d in ((on_card, device), (params, "cpu"))]
    dec = max(_rel(a.cpu(), b) for a, b in zip(*walks))
    log(f"  whisper-small at every width, 2 + 2 layers: prefill card vs cpu "
        f"rel err {rel:.3e} (tol {LOSS_RTOL:g}) {'ok' if ok else 'FAIL'}; 8 "
        f"decode steps card vs cpu, largest rel err {dec:.3e} (logged)")
    if not ok:
        raise AssertionError(f"whisper: prefill on the card and the CPU "
                             f"disagree ({rel})")


def phase_serve_whisper(device="cuda") -> dict:
    """whisper-small at every published width and depth: a timed prefill
    of 4 x 1500 frames and 4 x 64 tokens (K2 non-causal, causal and
    cross), then a 32-step ``decode_step`` walk from the encoder's output,
    computed before it (K2 cross at Tq = 1 in every layer at every step;
    self-attention at decode is plain), each after its reduced and 2 +
    2-layer checks.
    ``serve`` refuses an encoder-decoder, as the reference's `serve` does,
    so the walk is driven directly.  Returns the prefill's and the walk's
    launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.tree import tree_bytes
    check_whisper_serving_small(device)
    cfg = get_config("whisper-small")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = build(cfg)
    params = lm.init(0, device=device)
    gen = torch.Generator(device=device).manual_seed(4)
    B, T, G = SERVE_BATCH, WHISPER_PROMPT, WHISPER_STEPS
    batch = _whisper_inputs(cfg, B, T, gen, device)
    first_s = _counted(lambda: lm.prefill(params, batch))[2]
    logits, pf_launch, pf_s, pf_shapes = _counted(
        lambda: lm.prefill(params, batch))
    modes = _attention_modes(pf_shapes)
    pf_peak = torch.cuda.max_memory_allocated()
    toks = batch["tokens"][:, :G]
    # the encoder runs once, before the walk, as prefill runs it: the
    # walk's time and launches are the decode steps' alone
    enc_out = _whisper_encode(lm, params, batch["encoder_embeds"])
    walk, dec_launch, walk_s, dec_shapes = _counted(
        lambda: _whisper_walk(lm, params, enc_out, toks))
    peak = torch.cuda.max_memory_allocated()
    _, wall, busy, n_ops = device_busy(
        lambda: _whisper_walk(lm, params, enc_out, toks[:, :8]))
    pf_walk = lm.prefill(params, {"tokens": toks,
                                  "encoder_embeds": batch["encoder_embeds"]})
    dist = float((walk[-1] - pf_walk).abs().max())
    finite = all(bool(torch.isfinite(t).all())
                 for t in (logits, walk[-1]))
    (pf_b, pf_by, _), (st_b, st_by, _) = _whisper_bounds(cfg, B, T, G)
    step_ms = walk_s / G * 1e3
    log(f"serve {cfg.name}: d_model {cfg.d_model} encoder "
        f"{cfg.encoder_layers} + decoder {cfg.num_layers} layers (all), "
        f"{cfg.max_source_positions} frames, vocab {cfg.vocab_size} tied, "
        f"{cfg.param_count() / 1e9:.3f} B params, "
        f"{tree_bytes(params) / 1e9:.2f} GB fp32")
    log(f"  prefill {B} x ({cfg.max_source_positions} frames + {T} tokens): "
        f"{pf_s:.4f} s (first call {first_s:.4f} s), bound "
        f"{pf_b / 1e3:.4f} s ({pf_by}), peak {pf_peak / 2**30:.2f} GiB, "
        f"launches {pf_launch}, K2 calls by mode {modes}")
    log(f"  decode walk {B} x {G} steps from the encoder's output (cross "
        f"K / V recomputed every step): {walk_s:.3f} s, {step_ms:.3f} ms a "
        f"step, step bound {st_b:.3f} ms ({st_by}), peak "
        f"{peak / 2**30:.2f} GiB, launches {dec_launch}")
    log(f"  profiled 8-step walk: {wall:.3f} s, device busy {busy:.4f} s "
        f"over {n_ops} device operations, idle share {1 - busy / wall:.4f}")
    log(f"  decode walk vs prefill of the same {G} tokens: max_abs_err "
        f"{dist:.3e} (logged; largest |logit| "
        f"{float(pf_walk.abs().max()):.3e}); finite {finite}")
    bad = []
    if not finite:
        bad.append("non-finite logits")
    if pf_launch["chunked_cross_entropy"] or dec_launch[
            "chunked_cross_entropy"]:
        bad.append("K1 launched")
    if set(modes) != {"causal", "non-causal", "cross"}:
        bad.append(f"prefill K2 modes {modes}")
    # one cross call a layer a step, every one at Tq = 1
    want = {(B, 1, cfg.max_source_positions, cfg.num_heads,
             cfg.num_kv_heads, cfg.head_dim, False, 0, 0):
            G * cfg.num_layers}
    if dec_shapes.get("flash_attention") != want:
        bad.append(f"decode walk launched K2 at "
                   f"{dec_shapes.get('flash_attention')}, not {want}")
    if bad:
        raise AssertionError(f"serve {cfg.name}: {bad}")
    del params, logits, walk, batch, enc_out
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill": (pf_launch, pf_shapes),
            "decode": (dec_launch, dec_shapes)}


def phase_serving() -> dict:
    log("serving: every published width, half the published depth "
        "(SERVE_LAYERS), batch 4")
    runs = {arch: phase_serve_model(arch, pk, dk,
                                    layers=SERVE_LAYERS.get(arch))
            for arch, pk, dk in SERVE_RUNS}
    runs["whisper-small"] = phase_serve_whisper()
    return runs


# --------------------------------------------------------------- phase 8
SYSTIME_ARCH = "mamba2-370m"
# phases 8 (b) and 9 (c) run it at published widths cut to this many of
# its 48 layers: at all 48 the script took 1259.4 s of its 1200 on a
# slow host (phase 8 alone 330 s); at 8 the async run's peak (5.98 GiB)
# passed its reckoning (5.82 GiB: the merge's term), which holds at 24
# (one H100 80GB HBM3 at 700 W)
SYSTIME_LAYERS = 24
# phase 4's mamba2-370m FeDepth and m-FeDepth rounds and phase 10's
# mamba2-370m group and rounds run it cut to this many of its 48 layers:
# with rematerialization and phase 13 the script took 1216.8 s of its
# 1200 on a slow host at 48 (one H100 80GB HBM3 at 700 W).  The margin
# is SERVE_LAYERS': all 48 layers (~+30 s) leave no room for that swing
MAMBA2_LAYERS = 24
# the reference tests' HEAVY fault plan (tests/test_faults.py)
HEAVY = dict(seed=7, crash_rate=0.1, drop_rate=0.1, corrupt_rate=0.15,
             diverge_rate=0.1, slowdown_rate=0.1)


@contextlib.contextmanager
def deterministic():
    """Deterministic cuDNN and ``torch.use_deterministic_algorithms`` for
    the bitwise checks (``main`` sets ``CUBLAS_WORKSPACE_CONFIG`` before
    cuBLAS starts): cuDNN's default convolution backward, and some plain
    backwards, accumulate with atomics.  New allocations are not filled
    (the mode's default, a debugging aid that writes every one): no
    result reads them."""
    import torch
    import torch.utils.deterministic as det
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             det.fill_uninitialized_memory)
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2])
        det.fill_uninitialized_memory = saved[3]


def _leaf_paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{path}/{i}")
    else:
        yield path, tree


def _first_difference(a, b):
    """The first leaf (by path) where two states differ bitwise, or
    None."""
    import torch
    la, lb = list(_leaf_paths(a)), list(_leaf_paths(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return "the tree structure"
    for (path, x), (_, y) in zip(la, lb):
        if not torch.equal(x, y):
            return f"leaf {path} (max abs diff {float((x - y).abs().max())})"
    return None


def _rows(history) -> list:
    # wall seconds are never bitwise; everything else must be
    return [(r.round, r.accuracy, r.comm_bytes, r.sim_seconds,
             r.down_bytes) for r in history]


def _same_run(what: str, a: tuple, b: tuple) -> None:
    """Two runs' (state, history, trace): the state bitwise, the history
    rows and the trace equal (a trace of None is not compared); fails
    naming the first leaf that differs."""
    diff = _first_difference(a[0], b[0])
    rows = _rows(a[1]) == _rows(b[1])
    trace = a[2] is None or b[2] is None or a[2] == b[2]
    ok = diff is None and rows and trace
    log(f"  {what}: states bitwise equal {diff is None}, history rows "
        f"equal {rows}, traces equal {trace} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: first differing leaf {diff}, rows "
                             f"{_rows(a[1])} vs {_rows(b[1])}, traces "
                             f"equal {trace}")


def _systime_run(name: str, smi: str, engine, profile: bool = False):
    """``engine.run(eval_every=1)`` counted (:func:`_counted`), and with
    ``profile`` under :func:`device_busy`; logs wall and sim seconds, the
    peak, the launches and (profiled) the device's idle share beside the
    card; returns ((state, history, trace), launches, launches by shape,
    peak).  Only the first of each set of identical runs is profiled:
    reading the profile back costs the host tens of seconds a million
    device operations, and the repeats do the same work."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    count = lambda: _counted(lambda: engine.run(eval_every=1))  # noqa: E731
    if profile:
        (out, launches, _, shapes), wall, busy, n = device_busy(count)
        idle = (f", device busy {busy:.3f} s over {n} device operations, "
                f"idle share {1 - busy / wall:.4f}")
    else:
        out, launches, wall, shapes = count()
        idle = ""
    state, history = out
    peak = torch.cuda.max_memory_allocated()
    log(f"  {name}: wall {wall:.2f} s, sim {history[-1].sim_seconds:.3f} "
        f"s, peak {peak / GIB:.2f} GiB, launches {launches}{idle} ({smi})")
    return (state, history, getattr(engine, "trace", None)), launches, \
        shapes, peak


def _kill_latest(d: str) -> int:
    """Remove the newest checkpoint pair (the run "died" before writing
    it); returns the rounds (server versions) the newest remaining pair
    holds, where a resume picks up."""
    pairs = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    os.remove(os.path.join(d, pairs[-1]))
    os.remove(os.path.join(d, pairs[-1][:-len(".npz")] + ".aux"))
    return int(pairs[-2][len("round_"):-len(".npz")]) + 1


def _fault_events(trace) -> dict:
    kinds = {}
    for event in trace:
        if event[0] in ("fail", "quarantine", "miss"):
            key = f"{event[0]} {event[4]}"
            kinds[key] = kinds.get(key, 0) + 1
    return kinds


def _check_finite(name: str, state) -> None:
    import torch
    if not all(bool(torch.isfinite(t).all()) for _, t in _leaf_paths(state)):
        raise AssertionError(f"{name}: non-finite server parameters")


def phase_systime_images(data, smi: str) -> None:
    """(a) The paper's Table 1 setting on full-width PreResNet-20 (phase
    5's 100 clients, 10 a round, ``fair``), under deterministic cuDNN and
    algorithms: ``AsyncEngine(mode="sync")`` over a zero-latency system
    equals ``RoundEngine`` bitwise for 2 FeDepth rounds (two
    ``RoundEngine`` runs first, as the control); then async FeDepth over
    ``profiles_for_ratios`` (concurrency 10, buffer 5, 4 server versions)
    run twice (the control), checkpointed every 2 versions, killed after
    the last checkpoint and resumed from the one before: the state, the
    history rows and the trace equal the uninterrupted run's.  The
    checkpoints' aux blobs take the pickle path (``msgpack`` set aside),
    in a temporary directory removed afterwards.  No kernel launches."""
    import shutil
    import tempfile
    from repro_torch.configs.preresnet20 import CONFIG
    from repro_torch.fl.engine import RoundEngine, SimConfig, build_context
    from repro_torch.fl.registry import get_strategy
    from repro_torch.fl.scale import state_store
    from repro_torch.fl.systime import (AsyncEngine, SystemModel,
                                        profiles_for_ratios,
                                        zero_latency_system)

    def ctx(rounds):
        sim = SimConfig(rounds=rounds, participation=0.1, lr=0.05,
                        momentum=0.9, local_steps=1, batch_size=64,
                        scenario="fair", seed=0)
        return build_context(data, sim, model_cfg=CONFIG)

    def run(name, engine, profile=False):
        out, launches, _, _ = _systime_run(name, smi, engine, profile)
        _check_no_launches(name, launches)
        _check_finite(name, out[0])
        return out

    log(f"system time and faults (a): FeDepth on {CONFIG.name}, 100 "
        f"clients")
    with deterministic():
        r1 = run("RoundEngine, 2 rounds",
                 RoundEngine(get_strategy("fedepth"), ctx(2)), True)
        r2 = run("RoundEngine, 2 rounds (control)",
                 RoundEngine(get_strategy("fedepth"), ctx(2)))
        s = run("AsyncEngine sync, zero latency, 2 rounds",
                AsyncEngine(get_strategy("fedepth"), ctx(2), mode="sync",
                            system=zero_latency_system(100)), True)
        _same_run("RoundEngine control", r1, r2)
        _same_run("AsyncEngine sync (zero latency) vs RoundEngine", r1, s)
        if any(r.sim_seconds != 0.0 for r in s[1]):
            raise AssertionError(f"zero latency priced time: {s[1]}")

        def async_engine(**kw):
            c = ctx(4)
            return AsyncEngine(get_strategy("fedepth"), c, mode="async",
                               concurrency=10, buffer_size=5,
                               system=SystemModel(profiles_for_ratios(
                                   c.ratios)), **kw)

        a1 = run("async, 4 versions", async_engine(), True)
        a2 = run("async, 4 versions (control)", async_engine())
        _same_run("async control", a1, a2)
        stale = max(e[4] for e in a1[2] if e[0] == "finish")
        d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        saved, state_store.msgpack = state_store.msgpack, None
        try:
            kw = dict(checkpoint_every=2, checkpoint_dir=d)
            b = run("async, checkpointed every 2 versions",
                    async_engine(**kw))
            no_ckpt = [e for e in b[2] if e[0] != "checkpoint"]
            _same_run("async checkpointed vs uninterrupted", a1,
                      (b[0], b[1], no_ckpt))
            killed = _kill_latest(d)
            c = run(f"async, resumed after version {killed}",
                    async_engine(resume=True, **kw))
            _same_run("async resumed vs checkpointed", b, c)
            _same_run("async resumed vs uninterrupted", a1,
                      (c[0], c[1], [e for e in c[2]
                                    if e[0] != "checkpoint"]))
        finally:
            state_store.msgpack = saved
            shutil.rmtree(d, ignore_errors=True)
    log(f"  async: {len(a1[2])} events, largest staleness merged {stale}, "
        f"checkpoint blobs through pickle; sim seconds "
        f"{[round(r.sim_seconds, 3) for r in a1[1]]}")
    if stale < 1:
        raise AssertionError("async: no stale result was merged")
    gc.collect()


def _reckon_async(cfg, decomps, concurrency: int, buffer_size: int):
    """The async run's reckoned peak (bytes) and how: the larger of a
    dispatch's training (the state, the largest block's training memory
    as in :func:`_reckon`, rematerialized, and the ``concurrency - 1``
    parked plus ``buffer_size - 1`` buffered payloads of a whole model)
    and the merge (the state, ``concurrency + buffer_size - 1`` payloads,
    one cached trained-mask per distinct decomposition, a soft mask per
    merged result, the anchor's ones, the new state, and four of the
    largest leaf for the per-leaf temporaries)."""
    from repro_torch.core.memory_model import lm_memory
    mem = lm_memory(cfg, 4, 256)
    params = 4 * cfg.param_count()
    block = max(_block_train(mem, lo, hi, optimizer_slots=1)
                for d in decomps for lo, hi in d.blocks)
    masks = len({(d.blocks, d.skipped_prefix) for d in decomps})
    leaf = 4 * cfg.vocab_size * cfg.d_model
    train = params + block + (concurrency + buffer_size - 2) * params
    held = concurrency + buffer_size - 1
    merge = (1 + held + masks + buffer_size + 2) * params + 4 * leaf
    return max(train, merge), (
        f"the larger of {params / GIB:.2f} GiB state + {block / GIB:.2f} "
        f"GiB the largest block's training + {concurrency + buffer_size - 2}"
        f" held payloads, and the merge's {1 + held + masks + buffer_size + 2}"
        f" models ({held} payloads, {masks} cached masks, {buffer_size} "
        f"soft masks, the anchor's ones, the new state) + 4 x "
        f"{leaf / GIB:.2f} GiB temporaries")


def phase_systime_lm(smi: str) -> dict:
    """(b) mamba2-370m at published widths cut to SYSTIME_LAYERS, FeDepth
    over 6 clients with phase 4's data and batch: an async run over
    ``profiles_for_ratios`` (concurrency 3, buffer 2, 2 server versions),
    its peak held to :func:`_reckon_async`; then, under deterministic
    algorithms, 3 sync rounds over the same system under the HEAVY fault
    plan with ``resample`` degradation, run twice (the control),
    checkpointed every round, killed after round 2 and resumed: state,
    history rows and trace equal the uninterrupted run's, the state
    finite, a fault or quarantine in the trace.  Every run must launch
    K1 and K3; returns each run's launches and launches by shape."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.fl.engine import SimConfig
    from repro_torch.fl.faults import FaultPlan, ResiliencePolicy
    from repro_torch.fl.registry import get_strategy
    from repro_torch.fl.scale import state_store
    from repro_torch.fl.seq import build_lm_context, build_seq_data
    from repro_torch.fl.systime import (AsyncEngine, SystemModel,
                                        profiles_for_ratios)
    full = get_config(SYSTIME_ARCH)
    cfg = dataclasses.replace(full, num_layers=SYSTIME_LAYERS)
    data = build_seq_data(6, n_per_client=16, n_test=16,
                          vocab_size=cfg.vocab_size, seq_len=256, seed=0)
    log(f"system time and faults (b): FeDepth on {cfg.name}, "
        f"{cfg.num_layers} layers (cut from {full.num_layers}), d_model "
        f"{cfg.d_model}, 6 clients")
    by_run = {}
    needed = ("chunked_cross_entropy", "mamba2_scan")

    def engine(rounds, **kw):
        sim = SimConfig(rounds=rounds, participation=0.5, lr=0.05,
                        momentum=0.9, local_steps=1, batch_size=4,
                        scenario="fair", seed=0)
        ctx = build_lm_context(data, sim, cfg)
        return AsyncEngine(get_strategy("fedepth"), ctx,
                           system=SystemModel(profiles_for_ratios(
                               ctx.ratios)), **kw)

    def run(name, eng, profile=False):
        out, launches, shapes, peak = _systime_run(name, smi, eng, profile)
        missing = [k for k in needed if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{name}: kernels {missing} were not "
                                 f"launched: {launches}")
        _check_finite(name, out[0])
        by_run[SYSTIME_ARCH, f"systime {name}"] = (launches, shapes)
        return out, peak

    eng = engine(2, mode="async", concurrency=3, buffer_size=2)
    reckoned, how = _reckon_async(cfg, eng.ctx.decomps, 3, 2)
    log(f"  async reckoned peak {reckoned / GIB:.2f} GiB ({how})")
    a, peak = run("async fedepth, 2 versions", eng, True)
    _held_to_reckoning("  async fedepth", peak, reckoned, gate=False)
    if peak > reckoned:
        raise AssertionError(f"async: peak {peak / GIB:.2f} GiB over its "
                             f"reckoning {reckoned / GIB:.2f} GiB")
    log(f"  async trace: {[e[:3] + (e[4],) for e in a[2]]}")
    del a, eng
    gc.collect()

    kw = dict(mode="sync", faults=FaultPlan(**HEAVY),
              resilience=ResiliencePolicy(degradation="resample"))
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        with deterministic():
            f1, _ = run("sync fedepth faulted, 3 rounds", engine(3, **kw),
                        True)
            f2, _ = run("sync fedepth faulted, 3 rounds (control)",
                        engine(3, **kw))
            _same_run("faulted control", f1, f2)
            del f2
            ck = dict(checkpoint_every=1, checkpoint_dir=d,
                      checkpoint_keep=2)
            b, _ = run("sync fedepth faulted, checkpointed every round",
                       engine(3, **kw, **ck))
            _same_run("faulted checkpointed vs uninterrupted", f1,
                      (b[0], b[1], [e for e in b[2]
                                    if e[0] != "checkpoint"]))
            killed = _kill_latest(d)
            c, _ = run(f"sync fedepth faulted, resumed after round "
                       f"{killed}", engine(3, **kw, **ck, resume=True))
            _same_run("faulted resumed vs checkpointed", b, c)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    faults = _fault_events(f1[2])
    log(f"  faulted: fault events {faults}, history "
        f"{[(r.round, r.accuracy, r.comm_bytes, round(r.sim_seconds, 3)) for r in f1[1]]}"
        f", aux blobs through {'msgpack' if state_store.msgpack else 'pickle'}")
    if not faults:
        raise AssertionError("faulted: no fault or quarantine in the trace")
    del f1, b, c
    gc.collect()
    torch.cuda.empty_cache()
    return by_run


def phase_systime(data, smi: str) -> dict:
    """Phase 8 (run after phase 5, on its data)."""
    phase_systime_images(data, smi)
    return phase_systime_lm(smi)


# --------------------------------------------------------------- phase 9
POP_CLIENTS = 1_000_000
POP_SMALL = 10_000
# the population runs' rounds: cut from 2 to 1 to keep the whole script
# under 900 s (PERF.md §6)
POP_ROUNDS = 1


def _rss() -> int:
    """This process's resident set on the host, in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _scale_run(name: str, smi: str, engine, profile: bool = False,
               run_kw=None):
    """``engine.run(eval_every=1, **run_kw)`` counted (:func:`_counted`),
    the first of a set under :func:`device_busy`: logs wall (and sim)
    seconds, the peak, the launches, the host's RSS before and after and
    (profiled) the device's idle share; returns (state, history,
    launches, shapes, peak, wall, RSS growth)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss0 = _rss()
    count = lambda: _counted(lambda: engine.run(  # noqa: E731
        eval_every=1, **(run_kw or {})))
    if profile:
        (out, launches, _, shapes), wall, busy, n = device_busy(count)
        idle = (f", device busy {busy:.3f} s over {n} device operations, "
                f"idle share {1 - busy / wall:.4f}")
    else:
        out, launches, wall, shapes = count()
        idle = ""
    rss1 = _rss()
    state, history = out
    peak = torch.cuda.max_memory_allocated()
    sim = (f", sim {history[-1].sim_seconds:.3f} s" if history
           and history[-1].sim_seconds else "")
    log(f"  {name}: wall {wall:.2f} s{sim}, peak {peak / GIB:.3f} GiB, "
        f"launches {launches}{idle}, host RSS {rss0 / GIB:.3f} -> "
        f"{rss1 / GIB:.3f} GiB ({smi})")
    return state, history, launches, shapes, peak, wall, rss1 - rss0


def _states_within(a, b, rtol=2e-4, atol=2e-5) -> float:
    """Max abs difference of two states, failing outside the vectorized
    tolerance (PERF.md §2)."""
    import torch
    worst = 0.0
    for (path, x), (_, y) in zip(_leaf_paths(a), _leaf_paths(b)):
        worst = max(worst, float((x - y).abs().max()))
        if not torch.allclose(x, y, rtol=rtol, atol=atol):
            raise AssertionError(f"{path}: outside rtol {rtol} / atol "
                                 f"{atol} (max abs diff "
                                 f"{float((x - y).abs().max())})")
    return worst


def phase_scale_population(smi: str) -> None:
    """(a) A lazily drawn population of 10^6 clients on full-width
    PreResNet-20 (``fair``, |D_k| in [64, 256], CIFAR-10's shape),
    participation 1e-4 (a cohort of 100 from ``PopulationSampler``),
    batch 64, ``POP_ROUNDS`` masked FeDepth rounds (FeDepth with per-leaf
    masked aggregation, so that the sharded scheduler's fused aggregation
    runs), under deterministic algorithms: ``VectorizedScheduler(min_group=2)``
    with host aggregation, then ``ShardedScheduler(aggregate="mesh")``
    and with ``max_lanes=16``.  Bytes equal, final states within the
    vectorized tolerance, no launches; a single-group, one-chunk fused
    round bitwise ``aggregate_masked``, and whether chunks of 2 lanes
    change lane bits; the vectorized run again at 10^4 clients, the
    host RSS growths side by side."""
    import numpy as np
    import torch
    from repro_torch.configs.preresnet20 import CONFIG
    from repro_torch.fl.engine import RoundEngine, SimConfig, build_context
    from repro_torch.fl.sampling import VectorizedScheduler
    from repro_torch.fl.scale import (Population, PopulationSampler,
                                      ShardedScheduler)
    from repro_torch.fl.strategies.fedepth import FedepthStrategy

    sim = SimConfig(rounds=POP_ROUNDS, participation=100 / POP_CLIENTS,
                    lr=0.05,
                    momentum=0.9, local_steps=1, batch_size=64,
                    scenario="fair", seed=0)

    def engine(scheduler, n=POP_CLIENTS):
        pop = Population(num_clients=n, scenario="fair", image_size=32,
                         channels=3, num_classes=10)
        s = dataclasses.replace(sim, participation=100 / n)
        ctx = build_context(None, s, population=pop, model_cfg=CONFIG)
        return RoundEngine(FedepthStrategy(masked_aggregation=True), ctx,
                           sampler=PopulationSampler(availability=pop),
                           scheduler=scheduler)

    log(f"scale and observability (a): masked FeDepth on {CONFIG.name}, a "
        f"population of {POP_CLIENTS} clients, cohort 100, batch 64, "
        f"{POP_ROUNDS} round(s)")
    runs = {}
    with deterministic():
        for i, (name, sched) in enumerate((
                ("vectorized, host aggregation",
                 VectorizedScheduler(min_group=2)),
                ("sharded, fused (mesh) aggregation",
                 ShardedScheduler(aggregate="mesh")),
                ("sharded, fused, max_lanes 16",
                 ShardedScheduler(aggregate="mesh", max_lanes=16)))):
            eng = engine(sched)
            state, hist, launches, _, peak, wall, grew = _scale_run(
                name, smi, eng, profile=i == 0)
            _check_no_launches(name, launches)
            _check_finite(name, state)
            runs[name] = (state, hist, peak, wall, grew)
            rows = [(r.round, r.accuracy, round(r.seconds, 3),
                     r.comm_bytes, r.down_bytes) for r in hist]
            log(f"    rounds {rows}")
            del eng
        names = list(runs)
        base = runs[names[0]]
        for name in names[1:]:
            other = runs[name]
            same_bytes = [(r.comm_bytes, r.down_bytes) for r in base[1]] \
                == [(r.comm_bytes, r.down_bytes) for r in other[1]]
            if not same_bytes:
                raise AssertionError(f"{name}: bytes differ from the "
                                     f"vectorized run's")
            worst = _states_within(base[0], other[0])
            log(f"  {name} vs vectorized: bytes equal, final states within "
                f"rtol 2e-4 / atol 2e-5 (max abs diff {worst:.3e})")
        log("  side by side (round seconds; peak GiB; host RSS growth "
            "GiB): " + "; ".join(
                f"{n}: {[round(r.seconds, 3) for r in v[1]]}, "
                f"{v[2] / GIB:.3f}, {v[4] / GIB:.3f}"
                for n, v in runs.items()))
        check_fused_single_group(engine(None))
        *_, grew_small = _scale_run(
            f"vectorized at {POP_SMALL} clients", smi,
            engine(VectorizedScheduler(min_group=2), n=POP_SMALL))
        log(f"  host RSS growth: {POP_CLIENTS} clients (profiled) "
            f"{base[4] / GIB:.3f} GiB, {POP_SMALL} clients "
            f"{grew_small / GIB:.3f} GiB")
    del runs, base
    gc.collect()
    torch.cuda.empty_cache()


def check_fused_single_group(eng) -> None:
    """One decomposition group of 8 clients with one batch each, drawn
    from the population: the fused round (one chunk on one device) equals
    the vectorized run + ``aggregate_masked`` bitwise; the lanes of
    chunks of 2 (``max_lanes=2``) against the one stack: bitwise, or
    held at the vectorized tolerance — logged which."""
    from repro_torch.fl.sampling import VectorizedScheduler
    from repro_torch.fl.scale import ShardedScheduler
    ctx, strat = eng.ctx, eng.strategy
    strat.setup(ctx)
    state = strat.init_state(ctx)
    key0, group = None, []
    for k in range(10_000):
        if int(ctx.sizes[k]) >= 2 * ctx.sim.batch_size:
            continue
        key = strat.client_group_key(ctx, k)
        if key0 is None:
            key0 = key
        if key == key0:
            group.append(k)
        if len(group) == 8:
            break
    start = ctx.rng.bit_generator.state
    batch_fn = eng.default_batch_fn()
    results = VectorizedScheduler(min_group=1).run(ctx, strat, state, group,
                                                   batch_fn)
    want = strat.aggregate(ctx, state, results)
    ctx.rng.bit_generator.state = start
    got, _ = ShardedScheduler(min_group=1, aggregate="mesh").run_fused(
        ctx, strat, state, group, batch_fn)
    diff = _first_difference(want, got)
    log(f"  single group {group} (blocks {key0[0]}), one chunk: fused "
        f"round bitwise aggregate_masked {diff is None}")
    if diff is not None:
        raise AssertionError(f"fused single group: {diff}")
    ctx.rng.bit_generator.state = start
    narrow = ShardedScheduler(min_group=1, max_lanes=2).run(
        ctx, strat, state, group, batch_fn)
    lanes = [(r.payload[0], n.payload[0]) for r, n in zip(results, narrow)]
    diffs = [_first_difference(a, b) for a, b in lanes]
    if all(d is None for d in diffs):
        log("  lanes of chunks of 2 vs one stack of 8: bitwise")
    else:
        worst = max(_states_within(a, b) for a, b in lanes)
        log(f"  lanes of chunks of 2 vs one stack of 8: not bitwise, "
            f"within rtol 2e-4 / atol 2e-5 (max abs diff {worst:.3e})")


def phase_scale_store(data, smi: str) -> None:
    """(b) Phase 8's async FeDepth on PreResNet-20 (concurrency 10, buffer
    5, 4 versions over ``profiles_for_ratios``) with a
    ``CommChannel("qsgd_int8", "delta")``, deterministic: without a
    store, then with one ``SpillStore(capacity=2)`` on the engine and the
    channel, then that checkpointed every 2 versions, killed after
    version 2 and resumed — state, history rows and trace bitwise the
    run without a store; spill and load counts above zero."""
    import shutil
    import tempfile
    from repro_torch.configs.preresnet20 import CONFIG
    from repro_torch.fl.comm import CommChannel
    from repro_torch.fl.engine import SimConfig, build_context
    from repro_torch.fl.registry import get_strategy
    from repro_torch.fl.scale import SpillStore
    from repro_torch.fl.systime import (AsyncEngine, SystemModel,
                                        profiles_for_ratios)

    def async_engine(store=None, **kw):
        sim = SimConfig(rounds=4, participation=0.1, lr=0.05, momentum=0.9,
                        local_steps=1, batch_size=64, scenario="fair",
                        seed=0)
        c = build_context(data, sim, model_cfg=CONFIG)
        return AsyncEngine(get_strategy("fedepth"), c, mode="async",
                           concurrency=10, buffer_size=5,
                           system=SystemModel(profiles_for_ratios(
                               c.ratios)),
                           channel=CommChannel("qsgd_int8", "delta",
                                               state_store=store),
                           state_store=store, **kw)

    def run(name, eng, profile=False):
        out, launches, _, _ = _systime_run(name, smi, eng, profile)
        _check_no_launches(name, launches)
        _check_finite(name, out[0])
        return out

    log(f"scale and observability (b): the state store under faults of "
        f"the process and resume, async FeDepth on {CONFIG.name}, "
        f"qsgd_int8 / delta")
    d = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        with deterministic():
            a = run("async, no store", async_engine(), True)
            store = SpillStore(2, dir=os.path.join(d, "spill"))
            b = run("async, SpillStore(2) on the engine and the channel",
                    async_engine(store))
            _same_run("spill store vs in memory", a, b)
            log(f"  spill store: {store.spill_count} spills, "
                f"{store.load_count} disk loads, {store.resident()} "
                f"resident of {len(store)}")
            if store.spill_count <= 0 or store.load_count <= 0:
                raise AssertionError("the store never spilled or loaded")
            kw = dict(checkpoint_every=2, checkpoint_dir=os.path.join(
                d, "ckpt"))
            c = run("async, store, checkpointed every 2 versions",
                    async_engine(SpillStore(2, dir=os.path.join(d, "s2")),
                                 **kw))
            killed = _kill_latest(kw["checkpoint_dir"])
            resumed = SpillStore(2, dir=os.path.join(d, "s3"))
            r = run(f"async, store, resumed after version {killed}",
                    async_engine(resumed, resume=True, **kw))
            _same_run("resumed vs checkpointed", c, r)
            _same_run("resumed vs no store", a,
                      (r[0], r[1], [e for e in r[2]
                                    if e[0] != "checkpoint"]))
            log(f"  resumed store: {resumed.spill_count} spills, "
                f"{resumed.load_count} disk loads")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()


def phase_scale_obs(data, smi: str) -> dict:
    """(c) mamba2-370m at published widths cut to SYSTIME_LAYERS, FeDepth
    over 6 clients with phase 4's data, 2 ``RoundEngine`` rounds under
    deterministic algorithms: telemetry off, then with a full capture
    (spans, metrics, the memory auditor, the dynamics) and a JSONL history
    sink — states bitwise, the sink's round lines equal to the off run's
    history but for wall seconds; K1 and K3 launch.  Between them the same
    capture audits one PreResNet-20 FeDepth round (phase 5's data,
    ``AsyncEngine`` sync over ``profiles_for_ratios``, cohort 10), whose
    client lanes give the Chrome trace its tiers; its cells, and the same
    round's with PyTorch's own convolutions in place of cuDNN's (whose
    weight-gradient workspace the model does not price: ROADMAP §3, fault
    17), are logged, and the latter gated within the reference's
    envelope.  The Chrome trace goes through ``tools/trace_report.py``
    (exit 0), the Prometheus snapshot is written, span counts and every
    audit cell's error ratio logged; a cell outside the envelope with
    cuDNN is logged as a finding.  Returns the two runs' launches by
    shape."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.fl.engine import RoundEngine, SimConfig
    from repro_torch.fl.registry import get_strategy
    from repro_torch.fl.scale.history import read_jsonl
    from repro_torch.fl.seq import build_lm_context, build_seq_data
    from repro_torch.obs import MemoryAuditor, Obs, make_obs
    from repro_torch.obs.audit import ERROR_RATIO_BOUNDS

    full = get_config(SYSTIME_ARCH)
    cfg = dataclasses.replace(full, num_layers=SYSTIME_LAYERS)
    lm_data = build_seq_data(6, n_per_client=16, n_test=16,
                             vocab_size=cfg.vocab_size, seq_len=256, seed=0)
    sim = SimConfig(rounds=2, participation=0.5, lr=0.05, momentum=0.9,
                    local_steps=1, batch_size=4, scenario="fair", seed=0)
    log(f"scale and observability (c): FeDepth on {cfg.name}, "
        f"{cfg.num_layers} layers (cut from {full.num_layers}), telemetry "
        f"off and full")
    by_run = {}
    needed = ("chunked_cross_entropy", "mamba2_scan")
    cap = make_obs("full")
    d = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        with deterministic():
            off = RoundEngine(get_strategy("fedepth"),
                              build_lm_context(lm_data, sim, cfg))
            s0, h0, l0, sh0, p0, w0, _ = _scale_run("obs off", smi, off,
                                                    profile=True)
            by_run[SYSTIME_ARCH, "phase 9 obs off"] = (l0, sh0)
            del off
            # the audited PreResNet-20 round (tier lanes, resnet cells),
            # then the same round with PyTorch's own convolutions in place
            # of cuDNN's, whose weight-gradient workspace the model does
            # not price (ROADMAP §3, fault 17): the envelope's gate
            img = _audited_image_round(data, cap)
            log(f"  audited PreResNet-20 sync round: sim "
                f"{img.clock.now:.3f} s, "
                f"{len(cap.tracer.sys_events)} scheduling events")
            plain = Obs(audit=MemoryAuditor())
            t_plain = time.perf_counter()
            _audit_without_cudnn(img, plain)
            log(f"  its blocks without cuDNN (one client update a "
                f"decomposition, one batch, audit only): "
                f"{time.perf_counter() - t_plain:.2f} s")
            del img
            # the full capture on the mamba2 run
            cap.audit.erased_peak = 0
            n0 = len(cap.tracer.spans)
            cohorts = []
            on = RoundEngine(get_strategy("fedepth"),
                             build_lm_context(lm_data, sim, cfg), obs=cap,
                             history_sink=os.path.join(d, "history.jsonl"))
            sample = on.sampler.sample

            def recording(c, rd):
                ids = sample(c, rd)
                cohorts.append([int(k) for k in ids])
                return ids

            on.sampler.sample = recording
            s1, h1, l1, sh1, p1, w1, _ = _scale_run(
                "obs full + history sink", smi, on)
            by_run[SYSTIME_ARCH, "phase 9 obs full"] = (l1, sh1)
        peak = max(p1, cap.audit.erased_peak)
        lines = read_jsonl(os.path.join(d, "history.jsonl"), kind="round")
        rows = [(r["round"], r["accuracy"], r["comm_bytes"],
                 r["sim_seconds"], r["down_bytes"]) for r in lines]
        diff = _first_difference(s0, s1)
        same = h1 == [] and rows == _rows(h0)
        log(f"  obs full vs off: states bitwise {diff is None}, sink round "
            f"lines equal the off history {same}, wall {w1:.2f} vs "
            f"{w0:.2f} s, peak {peak / GIB:.3f} (the larger of the "
            f"allocator's and the auditor's erased) vs {p0 / GIB:.3f} GiB")
        if diff is not None or not same:
            raise AssertionError(f"telemetry changed the run: {diff}, rows "
                                 f"{rows} vs {_rows(h0)}")
        for name, launches in (("off", l0), ("full", l1)):
            missing = [k for k in needed if launches[k] <= 0]
            if missing:
                raise AssertionError(f"obs {name}: kernels {missing} were "
                                     f"not launched: {launches}")
        kinds = {}
        for span in cap.tracer.spans[n0:]:
            kinds[span.kind] = kinds.get(span.kind, 0) + 1
        log(f"  mamba2 spans: {kinds}")
        trace = os.path.join(d, "trace.json")
        cap.export_chrome_trace(trace)
        prom = cap.export_prometheus(os.path.join(d, "metrics.prom"))
        n_lines = cap.export_jsonl(os.path.join(d, "telemetry.jsonl"))
        rep = subprocess.run([sys.executable, os.path.join(
            ROOT, "tools", "trace_report.py"), trace],
            capture_output=True, text=True, timeout=120)
        log(f"  tools/trace_report.py exit {rep.returncode}: "
            + " | ".join(rep.stdout.strip().splitlines()[-3:]))
        if rep.returncode != 0:
            raise AssertionError(f"trace_report: {rep.stderr[-2000:]}")
        log(f"  Prometheus snapshot {len(prom.splitlines())} lines, "
            f"{len(cap.metrics)} metrics; JSONL export {n_lines} lines; "
            f"dynamics rounds {len(cap.dynamics.rounds)}")
        # every block of every trained decomposition, audited
        family = on.strategy.runner.family
        blocks = {b for ids in cohorts for k in ids
                  for b in on.ctx.decomps[k].blocks}
        cells = {(c["lo"], c["hi"]): c for c in cap.audit.table()
                 if c["family"] == family}
        missing = [b for b in sorted(blocks)
                   if b not in cells or cells[b]["status"] != "ok"]
        if missing:
            raise AssertionError(f"blocks without a measured audit cell: "
                                 f"{missing}")
        lo, hi = ERROR_RATIO_BOUNDS
        outside = []
        for c in cap.audit.table():
            log(f"  audit {c['family']} [{c['block']}) batch {c['batch']}: "
                f"measured {c['measured_bytes'] / GIB:.4f} GiB (temp "
                f"{c['temp_bytes'] / GIB:.4f}, arguments "
                f"{c['argument_bytes'] / GIB:.4f}), predicted "
                f"{c['predicted_bytes'] / GIB:.4f} GiB, "
                f"memory_model_error_ratio {c['error_ratio']:.4f}, "
                f"budget {c['budget_bytes']}, violated "
                f"{c['violated_tiers']}")
            if not lo <= c["error_ratio"] <= hi:
                outside.append((c["family"], c["block"], c["error_ratio"]))
        if outside:
            log(f"  finding (ROADMAP §3, fault 17): cells outside "
                f"{ERROR_RATIO_BOUNDS} with cuDNN's convolutions: {outside}")
        gated = plain.audit.table()
        blocks = {c["block"] for c in cap.audit.table()
                  if c["family"] == "resnet"}
        for c in gated:
            log(f"  audit without cuDNN resnet [{c['block']}): measured "
                f"{c['measured_bytes'] / GIB:.4f} GiB, predicted "
                f"{c['predicted_bytes'] / GIB:.4f} GiB, "
                f"memory_model_error_ratio {c['error_ratio']:.4f}")
        bad = [(c["block"], c["error_ratio"]) for c in gated
               if c["status"] != "ok" or not lo <= c["error_ratio"] <= hi]
        if bad or {c["block"] for c in gated} != blocks:
            raise AssertionError(f"resnet audit cells without cuDNN outside "
                                 f"{ERROR_RATIO_BOUNDS}: {bad}, or blocks "
                                 f"unaudited")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del s0, s1, on, cap
    gc.collect()
    torch.cuda.empty_cache()
    return by_run


def _audited_image_round(data, obs):
    """One FeDepth round of PreResNet-20 over phase 5's data (cohort 10,
    batch 64) through ``AsyncEngine(mode="sync")`` over
    ``profiles_for_ratios``, under the capture ``obs``; returns the
    engine."""
    import torch
    from repro_torch.configs.preresnet20 import CONFIG
    from repro_torch.fl.engine import SimConfig, build_context
    from repro_torch.fl.registry import get_strategy
    from repro_torch.fl.systime import (AsyncEngine, SystemModel,
                                        profiles_for_ratios)
    sim = SimConfig(rounds=1, participation=0.1, lr=0.05, momentum=0.9,
                    local_steps=1, batch_size=64, scenario="fair", seed=0)
    ctx = build_context(data, sim, model_cfg=CONFIG)
    torch.cuda.reset_peak_memory_stats()
    engine = AsyncEngine(get_strategy("fedepth"), ctx, mode="sync",
                         system=SystemModel(profiles_for_ratios(ctx.ratios)),
                         obs=obs)
    engine.run(eval_every=1)
    return engine


def _audit_without_cudnn(engine, obs) -> None:
    """The blocks of ``engine``'s round (one client update of each
    decomposition its clients trained, one batch of the round's size)
    under ``obs``'s auditor with PyTorch's own convolutions in place of
    cuDNN's."""
    import numpy as np
    import torch
    from repro_torch.core import blockwise
    from repro_torch.obs import activate
    ctx, strategy = engine.ctx, engine.strategy
    clients = sorted({e[2] for e in engine.trace if e[0] == "finish"})
    decs = {ctx.decomps[k].blocks: ctx.decomps[k] for k in clients}
    state = strategy.init_state(ctx)
    batch = ctx.data.client_batch(clients[0], ctx.sim.batch_size,
                                  np.random.default_rng(0))
    obs.bind(ctx)
    with activate(obs), torch.backends.cudnn.flags(enabled=False):
        for dec in decs.values():
            blockwise.client_update(strategy.runner, state, dec, [batch],
                                    lr=ctx.sim.lr,
                                    momentum=ctx.sim.momentum)


def phase_scale(data, smi: str) -> dict:
    """Phase 9 (run after phase 8, on phase 5's data)."""
    t0 = time.perf_counter()
    phase_scale_population(smi)
    phase_scale_store(data, smi)
    by_run = phase_scale_obs(data, smi)
    log(f"phase 9 (scale and observability): {time.perf_counter() - t0:.1f}"
        f" s")
    return by_run


# --------------------------------------------------------------- phase 10
K1_K2 = ("chunked_cross_entropy", "flash_attention")
STACKED_RUNS = (
    # (arch, layers, kernels that must launch, clients in the group):
    # each at every published width, phase 4's batches
    ("mamba2-370m", MAMBA2_LAYERS, ("chunked_cross_entropy", "mamba2_scan"),
     4),
    ("rwkv6-7b", 4, ("chunked_cross_entropy", "rwkv6_scan"), 4),
    # cut from 4 clients: reckoned 80.2 GiB at 4, 62.0 at 3
    ("qwen2-7b", 4, K1_K2, 3),
)
STACKED_BATCHES = 2      # batches of 4 x 256 tokens a client


def _reckon_stacked(cfg, blocks: tuple, group: int,
                    remat: bool = True) -> tuple:
    """A stacked group update's reckoned peak: the broadcast state's
    parameters, then ``group`` times one client's reckoning
    (:func:`_reckon_client` in the ``remat`` mode: the stacked leaves,
    each block's clones, momentum, gradients and activations all carry
    the client axis)."""
    from repro_torch.core.memory_model import lm_memory
    one, _, _ = _reckon_client(cfg, blocks, STACKED_BATCHES, remat)
    params = lm_memory(cfg, 4, 256).param_bytes()
    return params + group * one, one + params


def _stacked_setup(arch: str, layers: int, group: int):
    """The run's config, a 6-client ``fair`` context over phase 4's data
    (its decompositions), the shared decomposition (the fewest blocks,
    at least 2, whose stacked reckoning fits RECKON_LIMIT) and ``group``
    clients' batches drawn as the engine draws them."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.fl.engine import SimConfig
    from repro_torch.fl.seq import build_lm_context, build_seq_data
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    sim = SimConfig(rounds=1, participation=0.5, lr=0.05, momentum=0.9,
                    local_steps=1, batch_size=4, scenario="fair", seed=0)
    data = build_seq_data(6, n_per_client=16, n_test=16,
                          vocab_size=cfg.vocab_size, seq_len=256, seed=0)
    ctx = build_lm_context(data, sim, cfg)
    # chosen by the reckoning without remat, as before it: a safe bound
    # on the rematerialized run (the stacked peaks sat up to 6.3 GiB above
    # their reckonings, PERF.md section 5)
    fits = [d for d in ctx.decomps if len(d.blocks) >= 2
            and _reckon_stacked(cfg, d.blocks, group, remat=False)[0]
            <= RECKON_LIMIT]
    if not fits:
        raise AssertionError(f"{arch}: no multi-block decomposition of a "
                             f"group of {group} fits {RECKON_LIMIT} B")
    dec = min(fits, key=lambda d: len(d.blocks))
    rng = np.random.default_rng(0)
    bpc = [[data.client_batch(k, sim.batch_size, rng)
            for _ in range(STACKED_BATCHES)] for k in range(group)]
    return cfg, dec, bpc


def _profiled_count(fn):
    """``fn()`` counted (:func:`_counted`) under :func:`device_busy`:
    (its result, launches, launches by shape, wall s, device-busy s)."""
    (out, launches, _, shapes), wall, busy, _ = device_busy(
        lambda: _counted(fn))
    return out, launches, shapes, wall, busy


def phase_stacked_run(arch: str, layers: int, kernels: tuple, group: int,
                      smi: str) -> dict:
    """One group of ``group`` clients sharing one decomposition at every
    published width: ``client_update_batched`` (one ``vmap(grad)`` a
    step, each kernel launched once a group) against ``group``
    sequential ``client_update`` calls from the same state.  Each
    client's state within rtol 2e-4 / atol 2e-5 of its sequential twin;
    the stacked run's launches of each kernel the sequential run's over
    the group size; both runs' reckoned peaks within RECKON_LIMIT.  The
    stacked update then runs under ``disable_remat()`` (its peak beside
    its reckoning) and with remat once more, both warm, for remat's wall
    and device time.  Logs wall, peak, idle share and launches of each.
    Returns the (launches, shapes) of the sequential run and the stacked
    runs with and without remat for the kernel line."""
    import torch
    from repro_torch.core import blockwise
    from repro_torch.models import build, common
    from repro_torch.tree import tree_leaves, tree_map
    cfg, dec, bpc = _stacked_setup(arch, layers, group)
    lm = build(cfg)
    runner = blockwise.lm_runner(lm)
    params = lm.init(0, device="cuda")
    kw = dict(lr=0.05, momentum=0.9)
    reckoned, one = _reckon_stacked(cfg, dec.blocks, group)
    name = f"{cfg.name} ({layers} layers), a group of {group}"
    log(f"stacked {name}: blocks {dec.blocks} (skipped prefix "
        f"{dec.skipped_prefix}), {STACKED_BATCHES} batches of 4 x 256 a "
        f"client; reckoned peak {reckoned / GIB:.2f} GiB stacked, "
        f"{one / GIB:.2f} GiB a sequential client ({smi})")
    seq_host, seq_launches, seq_shapes = [], {}, {}
    seq_wall = seq_busy = 0.0
    seq_peak = 0
    for b in bpc:
        torch.cuda.reset_peak_memory_stats()
        out, launches, shapes, wall, busy = _profiled_count(
            lambda: blockwise.client_update(runner, params, dec, b, **kw))
        seq_peak = max(seq_peak, torch.cuda.max_memory_allocated())
        seq_wall, seq_busy = seq_wall + wall, seq_busy + busy
        for k, n in launches.items():
            seq_launches[k] = seq_launches.get(k, 0) + n
        for k, per in shapes.items():
            into = seq_shapes.setdefault(k, {})
            for key, n in per.items():
                into[key] = into.get(key, 0) + n
        seq_host.append(tree_map(lambda t: t.cpu(), out))
        del out
    log(f"  sequential: {group} client updates {seq_wall:.2f} s, peak "
        f"{seq_peak / GIB:.2f} GiB, idle share "
        f"{1 - seq_busy / seq_wall:.4f}, launches {seq_launches}")
    _held_to_reckoning("  sequential", seq_peak, one, gate=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _recompute_calls() as calls:
        vec, vec_launches, vec_shapes, vec_wall, vec_busy = _profiled_count(
            lambda: blockwise.client_update_batched(runner, params, dec,
                                                    bpc, **kw))
    vec_peak = torch.cuda.max_memory_allocated()
    log(f"  stacked: one group update {vec_wall:.2f} s (x"
        f"{seq_wall / vec_wall:.2f} the sequential), peak "
        f"{vec_peak / GIB:.2f} GiB, idle share "
        f"{1 - vec_busy / vec_wall:.4f}, launches {vec_launches}; "
        f"{calls[0]} units rematerialized under vmap (phase 13 (d))")
    _held_to_reckoning("  stacked", vec_peak, reckoned, gate=False)
    if not calls[0]:
        raise AssertionError(f"stacked {name}: no unit rematerialized")
    worst = 0.0
    for c in range(group):
        twin = tree_map(lambda t: t.to("cuda"), seq_host[c])
        worst = max(worst, _states_within(vec[c], twin))
        del twin
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(vec[0]), tree_leaves(params)))
    log(f"  each client's state vs its sequential twin: max abs diff "
        f"{worst:.3e} (rtol 2e-4 / atol 2e-5), moved {moved:.3e}")
    per_group = {k: (seq_launches[k], vec_launches[k]) for k in kernels}
    bad = [k for k, (a, b) in per_group.items() if b <= 0 or a != group * b]
    others = [k for k, n in vec_launches.items() if n and k not in kernels]
    log(f"  forward launches, sequential vs stacked: {per_group} (one "
        f"launch a group: the sequential's / {group}) "
        f"{'ok' if not bad and not others else 'FAIL'}")
    if bad or others or not moved > 0:
        raise AssertionError(f"stacked {name}: launches {per_group} (not "
                             f"one a group: {bad}; others {others}), moved "
                             f"{moved}")
    del vec, seq_host
    # without remat, then with it once more: both warm (the first stacked
    # run paid the group's first calls), for what remat costs and saves on
    # the stacked path (phase 13 (d))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with common.disable_remat():
        off, off_launches, off_shapes, off_wall, off_busy = _profiled_count(
            lambda: blockwise.client_update_batched(runner, params, dec,
                                                    bpc, **kw))
    off_peak = torch.cuda.max_memory_allocated()
    del off
    _, _, _, on_wall, on_busy = _profiled_count(
        lambda: blockwise.client_update_batched(runner, params, dec, bpc,
                                                **kw))
    log(f"  stacked, no remat: one group update {off_wall:.3f} s (device "
        f"busy {off_busy:.3f} s), peak {off_peak / GIB:.2f} GiB, launches "
        f"{off_launches}; remat again {on_wall:.3f} s ({on_busy:.3f} s): "
        f"remat x{on_wall / off_wall:.2f} the wall, x{on_busy / off_busy:.2f}"
        f" the device time, {(vec_peak - off_peak) / GIB:+.2f} GiB the peak "
        f"({smi})")
    _held_to_reckoning("  stacked, no remat", off_peak, _reckon_stacked(
        cfg, dec.blocks, group, remat=False)[0], gate=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {(arch, f"stacked sequential twin, {group} clients"):
            (seq_launches, seq_shapes),
            (arch, f"stacked group of {group}"): (vec_launches, vec_shapes),
            (arch, f"stacked group of {group}, no remat"):
            (off_launches, off_shapes)}


@contextlib.contextmanager
def _recompute_calls():
    """Count the units rematerialized under a functorch transform (the
    stacked path's ``vmap``: ``models.common._Recompute``) while the
    block runs; yields the one-element count."""
    from repro_torch.models import common
    calls, apply = [0], common._Recompute.apply

    def counted(*args):
        calls[0] += 1
        return apply(*args)

    common._Recompute.apply = counted
    try:
        yield calls
    finally:
        common._Recompute.apply = apply


def phase_stacked_rounds(smi: str) -> dict:
    """One FeDepth round of mamba2-370m (MAMBA2_LAYERS of 48) under
    ``RoundEngine(scheduler="vectorized")`` and one under
    ``ShardedScheduler(mesh=["cuda:0"])``, every client of 6 (``fair``:
    two pairs share a decomposition, so two groups of 2 stack), under
    deterministic algorithms: the sharded round's state bitwise the
    vectorized one's, its bytes equal; group sizes, wall, peak and
    launches logged."""
    import collections
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fl.engine import RoundEngine, SimConfig
    from repro_torch.fl.registry import get_strategy
    from repro_torch.fl.scale import ShardedScheduler
    from repro_torch.fl.seq import build_lm_context, build_seq_data
    cfg = dataclasses.replace(get_config("mamba2-370m"),
                              num_layers=MAMBA2_LAYERS)
    sim = SimConfig(rounds=1, participation=1.0, lr=0.05, momentum=0.9,
                    local_steps=1, batch_size=4, scenario="fair", seed=0)
    data = build_seq_data(6, n_per_client=4 * STACKED_BATCHES, n_test=16,
                          vocab_size=cfg.vocab_size, seq_len=256, seed=0)
    runs, by_run = {}, {}
    for label, scheduler in (
            ("vectorized", "vectorized"),
            ("sharded", ShardedScheduler(mesh=["cuda:0"]))):
        ctx = build_lm_context(data, sim, cfg)
        engine = RoundEngine(get_strategy("fedepth"), ctx,
                             scheduler=scheduler)
        cohorts, _ = _instrument(engine)
        with deterministic():
            state, history, launches, shapes, peak, wall, _ = _scale_run(
                f"mamba2-370m, 1 FeDepth round, {label}", smi, engine)
        keys = collections.Counter(
            engine.strategy.client_group_key(ctx, k) for k in cohorts[0])
        sizes = sorted(keys.values(), reverse=True)
        log(f"  {label}: cohort {cohorts[0]}, group sizes {sizes}")
        if sizes[0] < 2:
            raise AssertionError(f"{label}: no group of 2 or more {sizes}")
        runs[label] = (state, history, None)
        by_run["mamba2-370m", f"{label} round"] = (launches, shapes)
        del engine, ctx
    _same_run("mamba2-370m sharded (one card) vs vectorized round",
              runs["sharded"], runs["vectorized"])
    return by_run


def phase_stacked(smi: str) -> dict:
    """Phase 10: the stacked (vectorized and sharded) LM path."""
    t0 = time.perf_counter()
    by_run = {}
    for arch, layers, kernels, group in STACKED_RUNS:
        by_run.update(phase_stacked_run(arch, layers, kernels, group, smi))
    by_run.update(phase_stacked_rounds(smi))
    log(f"phase 10 (the stacked LM path): {time.perf_counter() - t0:.1f} s")
    return by_run


# --------------------------------------------------------------- phase 11
TRAIN_ARCH = "yi-6b"         # (a) the CLI's standard mode, (b) the step
TRAIN_STEPS = 3              # (a), at the CLI's defaults: batch 4 x 64
TRAIN_CUT = 4                # (b): yi-6b cut to 4 layers, batch 4 x 256
FEDEPTH_ARCH = "mamba2-370m"  # (c) the CLI's FeDepth mode, (d), (e)
# lm_memory at batch 4 x 256 splits mamba2-370m's 48 layers into 2 blocks
# at this budget: [0, 27), [27, 48)
FEDEPTH_BUDGET_MB = 4000
DECODE_TOKENS = 8            # (e): make_multi_decode_step(lm, 8)


def _saved_bytes(fn, own) -> int:
    """Bytes of the distinct storages autograd saves for the backward
    while ``fn()`` runs (the ``saved_tensors_hooks`` pack hook sees every
    saved tensor, a custom Function's too), beside the tensors of ``own``
    (the parameters)."""
    import torch
    skip = {t.untyped_storage().data_ptr() for t in own}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


def _eager_acts(cfg, B: int, T: int, device) -> tuple:
    """The activations eager autograd holds for the backward of one depth
    unit and of the head, at batch B x T and the config's widths: counted
    from the saved tensors' shapes (:func:`_saved_bytes`) on a one-unit
    model of those widths, the unit run without rematerialization (a
    checkpoint's own hooks would hide its saved tensors from the count;
    a rematerialized unit holds these during its recompute).
    ``lm_memory`` prices fewer (a subset of what eager autograd saves);
    the reckonings log both."""
    import torch
    from repro_torch.core import blockwise
    from repro_torch.models import build, common
    from repro_torch.tree import tree_leaves
    one = dataclasses.replace(cfg, num_layers=cfg.moe_every)
    lm = build(one)
    params = lm.init(0, device=device)
    runner = blockwise.lm_runner(lm)
    gen = torch.Generator(device=device).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                         device=device)
    batch = {"tokens": toks, "labels": toks}
    leaves = tree_leaves(params)
    with torch.no_grad():
        z = runner.embed(params, batch)
    for t in leaves:
        t.requires_grad_(True)
    try:
        with common.disable_remat():
            unit = _saved_bytes(lambda: runner.apply_units(params, z, 0, 1),
                                leaves)
        head = _saved_bytes(lambda: runner.head_loss(params, z, batch, 0),
                            leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    del params, z
    return unit, head


def _held_acts(n_units: int, acts: tuple, unit_in: int,
               remat: bool) -> tuple:
    """The activations ``n_units`` units and the head hold for the
    backward (``acts``: :func:`_eager_acts`), and how: every unit's
    without remat; with it, each unit's input (``unit_in`` bytes) and
    one unit's during its recompute."""
    unit, head = acts
    if remat:
        return n_units * unit_in + unit + head, (
            f"remat: {n_units} x {unit_in / 2**20:.1f} MiB unit inputs + "
            f"{unit / 2**20:.1f} MiB one unit's recompute + "
            f"{head / 2**20:.1f} MiB the head")
    return n_units * unit + head, (
        f"no remat: {n_units} x {unit / 2**20:.1f} MiB a unit + "
        f"{head / 2**20:.1f} MiB the head")


def _reckon_train(cfg, B: int, T: int, device, accum: int = 1,
                  remat: bool = True, acts: tuple = None) -> tuple:
    """A standard step's reckoned peak over what it holds at entry: its
    gradients (the fp32 parameters once more) and the activations one
    microbatch holds for the backward in the ``remat`` mode
    (:func:`_held_acts` over :func:`_eager_acts`, or the given
    ``acts``), the CE backward's chunk (:func:`_ce_chunk`), plus, with
    accumulation, one leaf's fresh gradient before it is summed into
    ``.grad`` (the largest leaf, the (V, D) table); and the whole run's:
    the parameters and momentum besides.  Returns (step, run, how)."""
    from repro_torch.core.memory_model import lm_memory
    if acts is None:
        acts = _eager_acts(cfg, B // accum, T, device)
    n_units = cfg.num_layers // cfg.moe_every
    acts, held = _held_acts(n_units, acts, 4 * B // accum * T * cfg.d_model,
                            remat)
    mem = lm_memory(cfg, B // accum, T, act_bytes=4)
    priced = (sum(u.activations for u in mem.units) + mem.embed.activations
              + mem.head.activations)
    params = 4 * cfg.param_count()
    leaf = 4 * cfg.vocab_size * cfg.d_model if accum > 1 else 0
    ce = _ce_chunk(cfg, B // accum * T)
    step = params + acts + leaf + ce
    return step, 2 * params + step, (
        f"{params / GIB:.2f} GiB parameters, as many of momentum and of "
        f"gradients, {acts / GIB:.2f} GiB activations at {B // accum} x {T} "
        f"({held}, counted; lm_memory prices {priced / GIB:.2f} GiB without "
        f"remat in fp32), {ce / GIB:.2f} GiB the CE backward's chunk"
        + (f", {leaf / GIB:.2f} GiB a leaf's fresh gradient" if leaf else ""))


def _ce_chunk(cfg, rows: int) -> int:
    """The CE backward's live chunk (``kernels.ops.cross_entropy_bwd``):
    the logits of up to ``CE_CHUNK`` rows and their softmax, fp32."""
    from repro_torch.kernels.ops import CE_CHUNK
    return 2 * 4 * min(rows, CE_CHUNK) * cfg.vocab_size


def _reckon_block(cfg, mem, lo: int, hi: int, acts: tuple,
                  rows: int) -> tuple:
    """A FeDepth block step's reckoned peak over what it holds at entry
    (the parameters and every block's momentum so far): the block's
    gradients (its split: the units, the tied head and the final norm),
    the activations its units and the head hold for the backward with
    remat (:func:`_held_acts` over ``acts``, from
    :func:`_eager_acts`) and the CE backward's chunk over ``rows``
    tokens.  Returns (bytes, how)."""
    split = 4 * (cfg.vocab_size * cfg.d_model + cfg.d_model) + sum(
        mem.units[k].params for k in range(lo, hi))
    held, how = _held_acts(hi - lo, acts, 4 * rows * cfg.d_model, True)
    priced = (sum(mem.units[k].activations for k in range(lo, hi))
              + mem.head.activations)
    ce = _ce_chunk(cfg, rows)
    return split + held + ce, (
        f"{split / GIB:.2f} GiB gradients + {held / GIB:.2f} GiB activations "
        f"({how}, counted; lm_memory prices {priced / GIB:.2f} GiB without "
        f"remat in fp32) + {ce / GIB:.2f} GiB the CE backward's chunk")


def _step_peaks(kind: str):
    """Wrap ``launch.steps.make_train_step`` (``kind`` "train") or
    ``make_fedepth_block_step`` ("block") so that each step records the
    bytes allocated at its entry and its own peak
    (``max_memory_allocated``, reset at entry); returns the records and a
    function that undoes the wrap."""
    import torch
    from repro_torch.launch import steps
    name = ("make_train_step" if kind == "train"
            else "make_fedepth_block_step")
    inner, records = getattr(steps, name), []

    def measured(step):
        def run(*args):
            torch.cuda.synchronize()
            entry = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = step(*args)
            torch.cuda.synchronize()
            records.append((entry, torch.cuda.max_memory_allocated()))
            return out
        return run

    def make(*args, **kw):
        out = inner(*args, **kw)
        if kind == "train":
            return measured(out)
        return measured(out[0]), out[1]

    setattr(steps, name, make)
    return records, lambda: setattr(steps, name, inner)


def _rates(name: str, secs: list, tokens: int, flops: float, smi: str,
           first: int = 0) -> None:
    """Log each step's seconds, tokens/s and model FLOPs over the seconds
    as a share of fp32's peak (the port computes in fp32, TF32 off)."""
    for s, t in enumerate(secs, first):
        log(f"    {name} step {s}: {t:.4f} s, {tokens / t:.1f} tokens/s, "
            f"{flops / t / 1e12:.2f} TFLOP/s = {flops / t / PEAK_FP32[1]:.4f}"
            f" of {PEAK_FP32[0]} ({smi})")


def _device_arg(device: str) -> list:
    """The CLI's default device is the GPU; a CPU rehearsal names its own."""
    return [] if device == "cuda" else ["--device", device]


def _check_losses(name: str, losses) -> None:
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")


def _held(name: str, peak: int, reckoned: int) -> None:
    """A step's measured peak within its reckoning and RECKON_LIMIT."""
    _held_to_reckoning(name, peak, reckoned)
    if peak > reckoned:
        raise AssertionError(f"{name}: peak {peak / GIB:.2f} GiB over its "
                             f"reckoning {reckoned / GIB:.2f} GiB")


def phase_train_cli(smi: str, device="cuda") -> dict:
    """(a) ``python -m repro_torch.launch.train --arch yi-6b --steps 3``:
    the CLI's standard mode at published widths and all 32 layers, its
    defaults (batch 4 x 64, lr 3e-3, clip 1.0), profiled: every loss
    finite, each step's peak within its reckoning and RECKON_LIMIT, K1 and
    K2 launched."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main
    cfg = get_config(TRAIN_ARCH)
    B, T = 4, 64
    step_r, run_r, how = _reckon_train(cfg, B, T, device)
    log(f"train CLI (a): {cfg.name}, {cfg.num_layers} layers (all), "
        f"{cfg.param_count() / 1e9:.3f} B params, batch {B} x {T}, "
        f"{TRAIN_STEPS} steps; reckoned peak {run_r / GIB:.2f} GiB ({how}; "
        f"limit {RECKON_LIMIT / GIB:.0f} GiB); "
        f"{torch.cuda.memory_allocated() / GIB:.2f} GiB allocated before")
    if run_r > RECKON_LIMIT:
        raise AssertionError(f"{cfg.name}: reckoned {run_r / GIB:.2f} GiB")
    records, undo = _step_peaks("train")
    try:
        res, launches, shapes, wall, busy = _profiled_count(
            lambda: train_main(["--arch", TRAIN_ARCH, "--steps",
                                str(TRAIN_STEPS)] + _device_arg(device)))
    finally:
        undo()
    log(f"  the CLI: {wall:.2f} s in all, losses "
        f"{[round(x, 4) for x in res.losses]}, launches {launches}, idle "
        f"share {1 - busy / wall:.4f} ({smi})")
    _check_losses("train CLI", res.losses)
    _rates("standard", res.seconds, B * T,
           6.0 * cfg.param_count() * B * T, smi)
    for s, (entry, peak) in enumerate(records):
        _held(f"  step {s} (entry {entry / GIB:.2f} GiB)", peak,
              entry + step_r)
    missing = [k for k in K1_K2 if launches[k] <= 0]
    if missing or len(records) != TRAIN_STEPS:
        raise AssertionError(f"train CLI: kernels {missing} not launched "
                             f"({launches}), {len(records)} steps measured")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return {(TRAIN_ARCH, "train CLI"): (launches, shapes)}


def _reduced_step_card_vs_cpu(arch: str, device="cuda") -> None:
    """The reduced config's train step (accumulation 2, clip active) on
    the card against the CPU, from the same parameters and batch: loss
    and gnorm within LOSS_RTOL, parameters and momentum within rtol 1e-4
    / atol 1e-6.  Not counted."""
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.tree import tree_map
    cfg = get_reduced_config(arch)
    lm = build(cfg)
    params = lm.init(0, device="cpu")
    batch = next(TokenPipeline(cfg.vocab_size, 256, 4, seed=1).batches())
    step = make_train_step(lm, accum_steps=2)
    out = {}
    for dev in ("cpu", device):
        out[dev] = step(tree_map(lambda t: t.to(dev, copy=True), params),
                        tree_map(lambda t: torch.zeros_like(t, device=dev),
                                 params),
                        {k: torch.from_numpy(a).to(dev)
                         for k, a in batch.items()})
    (pc, vc, mc), (pg, vg, mg) = out["cpu"], out[device]
    rel = max(abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
              for k in ("loss", "gnorm"))
    worst = _states_within(tree_map(torch.Tensor.cpu, (pg, vg)), (pc, vc),
                           rtol=1e-4, atol=1e-6)
    ok = rel <= LOSS_RTOL
    log(f"  {arch} reduced, one step (accumulation 2): loss "
        f"{float(mg['loss']):.6f} (card) vs {float(mc['loss']):.6f} (cpu), "
        f"gnorm {float(mc['gnorm']):.4f}, rel err {rel:.3e} (tol "
        f"{LOSS_RTOL:g}); parameters and momentum max abs diff {worst:.3e} "
        f"(rtol 1e-4 / atol 1e-6) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{arch}: card and CPU disagree ({rel})")


def phase_train_step(smi: str, device="cuda") -> dict:
    """(b) ``make_train_step`` on yi-6b at published widths cut to 4
    layers, batch 4 x 256, from one set of parameters (clip 1.0, lr 3e-3):
    ``accum_steps=2`` within rtol 1e-4 / atol 1e-6 of ``accum_steps=1``
    (parameters and momentum), each step's peak within its reckoning; and
    the reduced config's step on the card against the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import build
    from repro_torch.tree import tree_leaves, tree_map
    _reduced_step_card_vs_cpu(TRAIN_ARCH, device)
    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_CUT)
    B, T = 4, 256
    lm = build(cfg)
    params = lm.init(0, device=device)
    batch = {k: torch.from_numpy(a).to(device) for k, a in next(TokenPipeline(
        cfg.vocab_size, T, B, seed=0).batches()).items()}
    log(f"train step (b): {cfg.name}, {TRAIN_CUT} layers (cut from "
        f"{full.num_layers}), {cfg.param_count() / 1e9:.3f} B params, batch "
        f"{B} x {T}")
    by_run, out = {}, {}
    for accum in (1, 2):
        step_r, _, how = _reckon_train(cfg, B, T, device, accum)
        p = tree_map(torch.clone, params)
        v = tree_map(torch.zeros_like, params)
        records, undo = _step_peaks("train")
        try:
            step = steps.make_train_step(lm, lr=3e-3, accum_steps=accum)
            (p, v, m), launches, secs, shapes = _counted(
                lambda: step(p, v, batch))
        finally:
            undo()
        (entry, peak), = records
        log(f"  accum_steps={accum}: loss {float(m['loss']):.5f}, gnorm "
            f"{float(m['gnorm']):.4f}, {secs:.4f} s, launches {launches}")
        _rates(f"accum {accum}", [secs], B * T,
               6.0 * cfg.param_count() * B * T, smi)
        _held(f"  accum_steps={accum} step (reckoned: {how}; entry "
              f"{entry / GIB:.2f} GiB)", peak, entry + step_r)
        if not float(m["gnorm"]) > 1.0:
            raise AssertionError(f"gnorm {float(m['gnorm'])}: the clip is "
                                 f"not active")
        missing = [k for k in K1_K2 if launches[k] <= 0]
        if missing:
            raise AssertionError(f"train step: {missing} not launched")
        out[accum] = (p, v)
        by_run[TRAIN_ARCH, f"train step, {TRAIN_CUT} layers, accum "
               f"{accum}"] = (launches, shapes)
    worst = _states_within(out[2], out[1], rtol=1e-4, atol=1e-6)
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(out[1][0]), tree_leaves(params)))
    log(f"  accum_steps=2 vs 1: parameters and momentum max abs diff "
        f"{worst:.3e} (rtol 1e-4 / atol 1e-6) ok; parameters moved "
        f"{moved:.3e}")
    if not moved > 0:
        raise AssertionError("train step: the parameters did not move")
    del out, params, p, v
    gc.collect()
    torch.cuda.empty_cache()
    return by_run


def phase_train_fedepth(smi: str, device="cuda") -> dict:
    """(c) ``python -m repro_torch.launch.train --arch mamba2-370m
    --fedepth``: all 48 layers at published widths, batch 4 x 256, a
    budget that ``lm_memory`` splits into 2 blocks, two passes of the
    schedule (each block's momentum created at its first step): finite
    losses, each block step's peak within its reckoning, K1 (tied) and K3
    launched.  (d) The buffered-z block step on the later block equals
    the unbuffered one bitwise, under deterministic algorithms.  (e)
    ``make_multi_decode_step(lm, 8)`` at batch 4 equals 8 ``decode_step``
    calls with argmax feedback bitwise: logits and cache."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import decomposition
    from repro_torch.core.memory_model import lm_memory
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build, init_cache
    from repro_torch.tree import tree_map
    cfg = get_config(FEDEPTH_ARCH)
    B, T = 4, 256
    needed = ("chunked_cross_entropy", "mamba2_scan")
    mem = lm_memory(cfg, B, T)
    blocks = decomposition.decompose(mem, int(FEDEPTH_BUDGET_MB * 2**20)
                                     ).blocks
    n_steps = 2 * len(blocks)
    mem4 = lm_memory(cfg, B, T, act_bytes=4)
    acts = _eager_acts(cfg, B, T, device)
    log(f"train CLI (c): {cfg.name} --fedepth, {cfg.num_layers} layers "
        f"(all), batch {B} x {T}, --budget-mb {FEDEPTH_BUDGET_MB}: blocks "
        f"{blocks}, {n_steps} steps (two passes)")
    if len(blocks) < 2:
        raise AssertionError(f"{FEDEPTH_BUDGET_MB} MB gives {blocks}")
    records, undo = _step_peaks("block")
    try:
        res, launches, secs, shapes = _counted(lambda: train_main([
            "--arch", FEDEPTH_ARCH, "--fedepth", "--budget-mb",
            str(FEDEPTH_BUDGET_MB), "--batch", str(B), "--seq", str(T),
            "--steps", str(n_steps)] + _device_arg(device)))
    finally:
        undo()
    log(f"  the CLI: {secs:.2f} s in all, losses "
        f"{[round(x, 4) for x in res.losses]}, launches {launches}")
    for line in res.schedule.splitlines():
        log(f"    {line}")
    _check_losses("FeDepth CLI", res.losses)
    if res.blocks != blocks or len(records) != n_steps:
        raise AssertionError(f"FeDepth CLI: blocks {res.blocks}, "
                             f"{len(records)} steps measured")
    for s, (entry, peak) in enumerate(records):
        j = s % len(blocks)
        lo, hi = blocks[j]
        split = sum(mem.units[k].params for k in range(lo, hi)) \
            + 4 * cfg.vocab_size * cfg.d_model
        flops = (2.0 * sum(mem.units[k].params for k in range(lo)) / 4
                 + 6.0 * split / 4) * B * T
        _rates(f"block[{lo}:{hi}]", [res.seconds[s]], B * T, flops, smi,
               first=s)
        reckoned, how = _reckon_block(cfg, mem4, lo, hi, acts, B * T)
        _held(f"  step {s} block[{lo}:{hi}] (entry {entry / GIB:.2f} GiB; "
              f"reckoned: {how})", peak, entry + reckoned)
    missing = [k for k in needed if launches[k] <= 0]
    if missing:
        raise AssertionError(f"FeDepth CLI: {missing} not launched")
    by_run = {(FEDEPTH_ARCH, "train CLI --fedepth"): (launches, shapes)}

    # (d) the buffered-z step on the later block, from the CLI's result
    lm = build(cfg)
    params = res.params
    lo, hi = blocks[-1]
    batch = {k: torch.from_numpy(a).to(device) for k, a in next(TokenPipeline(
        cfg.vocab_size, T, B, seed=1).batches()).items()}
    outs = []
    with deterministic():
        for buffered in (False, True):
            fn, runner = steps.make_fedepth_block_step(
                lm, lo, hi, lr=3e-3, buffered_z=buffered)
            p = tree_map(torch.clone, params)
            v = tree_map(torch.zeros_like, runner.split(p, lo, hi))
            b = batch
            if buffered:
                with torch.no_grad():
                    z = runner.apply_units(p, runner.embed(p, batch), 0, lo)
                b = {"z_in": z, "labels": batch["labels"]}
            (p, v, m), n, t, sh = _counted(lambda: fn(p, v, b))
            outs.append((p, v, m))
            by_run[FEDEPTH_ARCH, f"block step [{lo}, {hi})"
                   + (", buffered z" if buffered else "")] = (n, sh)
            log(f"  (d) block[{lo}:{hi}] {'buffered z' if buffered else 'prefix recomputed'}: "
                f"loss {float(m['loss']):.6f}, {t:.4f} s, launches {n}")
    diff = _first_difference((outs[0][0], outs[0][1]),
                             (outs[1][0], outs[1][1]))
    same_loss = torch.equal(outs[0][2]["loss"], outs[1][2]["loss"])
    log(f"  (d) buffered vs unbuffered: parameters and momentum bitwise "
        f"{diff is None}, loss bitwise {same_loss} "
        f"{'ok' if diff is None and same_loss else 'FAIL'}")
    if diff is not None or not same_loss:
        raise AssertionError(f"buffered z: first difference {diff}, loss "
                             f"equal {same_loss}")
    del outs, p, v

    # (e) N greedy tokens in one call against N decode steps
    gen = torch.Generator(device=device).manual_seed(2)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                        device=device)
    cache0 = init_cache(cfg, B, DECODE_TOKENS, device=device)
    multi = steps.make_multi_decode_step(lm, DECODE_TOKENS)
    torch.cuda.synchronize()
    (logits, cache), n, t, sh = _counted(lambda: multi(params, {
        "cache": tree_map(torch.clone, cache0), "cache_index": 0,
        "tokens": tok}))
    by_run[FEDEPTH_ARCH, f"multi-decode {DECODE_TOKENS} tokens"] = (n, sh)
    loop, c, cur = [], tree_map(torch.clone, cache0), tok
    for i in range(DECODE_TOKENS):
        lg, c = lm.decode_step(params, cur, c, i)
        cur = lg[:, -1].argmax(-1)[:, None]
        loop.append(lg)
    same = torch.equal(logits, torch.stack(loop)) and \
        _first_difference(cache, c) is None
    log(f"  (e) make_multi_decode_step(lm, {DECODE_TOKENS}) at batch {B}: "
        f"{t * 1e3 / DECODE_TOKENS:.2f} ms a token, "
        f"{B * DECODE_TOKENS / t:.1f} tokens/s, launches {n}; logits and "
        f"cache bitwise {DECODE_TOKENS} decode steps {same} "
        f"{'ok' if same else 'FAIL'} ({smi})")
    if not same or n["mamba2_scan"] <= 0:
        raise AssertionError(f"multi-decode: bitwise {same}, launches {n}")
    del res, params, logits, cache, loop, c
    gc.collect()
    torch.cuda.empty_cache()
    return by_run


def phase_train(smi: str, device="cuda") -> dict:
    """Phase 11: the training launch path."""
    t0 = time.perf_counter()
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    by_run = phase_train_cli(smi, device)
    by_run.update(phase_train_step(smi, device))
    by_run.update(phase_train_fedepth(smi, device))
    log(f"phase 11 (the training launch path): "
        f"{time.perf_counter() - t0:.1f} s")
    return by_run


# --------------------------------------------------------------- phase 12
EP_TOKENS = (4, 256)         # (b): 4 x 256 tokens through one MoE layer
EP_CF = 8.0                  # (b): capacity factor (no token dropped)
EP_TOL = 1e-4                # (b): max abs diff over the reference's scale


@contextlib.contextmanager
def one_rank_group():
    """A one-rank ``nccl`` process group over a ``HashStore`` (no port),
    destroyed on exit."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_routes(fn):
    """``fn()`` with each sharded kernel op's route recorded: (its
    result, {op: [whether each call went through ``local_map``]})."""
    from repro_torch.kernels import ops
    names = ("_sharded_attention", "_sharded_cross_entropy")
    inner = {n: getattr(ops, n) for n in names}
    local_map, routes, current = ops._local_map, {}, []

    def mapped(*a, **kw):
        routes[current[-1]][-1] = True
        return local_map(*a, **kw)

    def recording(name):
        def call(*a, **kw):
            routes.setdefault(name, []).append(False)
            current.append(name)
            try:
                return inner[name](*a, **kw)
            finally:
                current.pop()
        return call

    ops._local_map = mapped
    for n in names:
        setattr(ops, n, recording(n))
    try:
        return fn(), routes
    finally:
        ops._local_map = local_map
        for n in names:
            setattr(ops, n, inner[n])


def phase_shard_step(smi: str, device="cuda") -> dict:
    """(a) ``make_train_step`` on yi-6b at published widths cut to
    TRAIN_CUT layers, batch 4 x 256 (phase 11 (b)'s step), with the
    parameters laid out by ``launch.sharding.param_specs`` as DTensors on
    a ("data", "model") mesh of (1, 1), fsdp off and on, under
    deterministic algorithms: K1 and K2 launch through ``local_map`` on
    every call, and parameters, momentum, loss and gnorm equal the
    unsharded step's bitwise."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import sharding, steps
    from repro_torch.models import build, common
    from repro_torch.tree import tree_map
    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_CUT)
    B, T = 4, 256
    lm = build(cfg)
    params = lm.init(0, device=device)
    batch = {k: torch.from_numpy(a).to(device) for k, a in next(TokenPipeline(
        cfg.vocab_size, T, B, seed=0).batches()).items()}
    mesh = init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))
    bspecs = sharding.batch_specs(cfg, InputShape("t", T, B, "train"), mesh)
    log(f"sharded step (a): {cfg.name}, {TRAIN_CUT} layers (cut from "
        f"{full.num_layers}), batch {B} x {T}, mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} "
        f"(a one-rank nccl group)")
    by_run, ref = {}, None
    with deterministic():
        # one unsharded step first: cuBLAS's and the allocator's warm-up
        # would otherwise land in the first timed step
        steps.make_train_step(lm, lr=3e-3)(
            tree_map(torch.clone, params), tree_map(torch.zeros_like,
                                                    params), batch)
        for name in ("unsharded", "fsdp off", "fsdp on"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if name == "unsharded":
                p = tree_map(torch.clone, params)
                v = tree_map(torch.zeros_like, params)
                b, step = batch, steps.make_train_step(lm, lr=3e-3)
                ctx = contextlib.nullcontext()
            else:
                specs = sharding.param_specs(cfg, params, mesh,
                                             fsdp=name == "fsdp on")
                p = sharding.distribute(params, specs, mesh)
                v = sharding.distribute(tree_map(torch.zeros_like, params),
                                        specs, mesh)
                b = {k: distribute_tensor(t, mesh, sharding.placements(
                    bspecs[k], mesh)) for k, t in batch.items()}
                step = steps.make_train_step(
                    lm, lr=3e-3,
                    grad_shardings=sharding.to_named(specs, mesh))
                ctx = common.mesh_context(mesh)
            with ctx:
                ((p, v, m), launches, secs, shapes), routes = _local_routes(
                    lambda: _counted(lambda: step(p, v, b)))
            peak = torch.cuda.max_memory_allocated()
            if name != "unsharded":
                p, v = (tree_map(lambda t: t.full_tensor(), x)
                        for x in (p, v))
                m = {k: x.full_tensor() if common.is_dtensor(x) else x
                     for k, x in m.items()}
            log(f"  {name}: loss {float(m['loss']):.6f}, gnorm "
                f"{float(m['gnorm']):.4f}, step {secs:.4f} s, peak "
                f"{peak / GIB:.2f} GiB, launches {launches}, local_map "
                f"routes {routes} ({smi})")
            missing = [k for k in K1_K2 if launches[k] <= 0]
            if missing:
                raise AssertionError(f"sharded step {name}: {missing} not "
                                     f"launched")
            calls = [routes.get(n, []) for n in ("_sharded_attention",
                                                  "_sharded_cross_entropy")]
            if name != "unsharded" and not all(c and all(c) for c in calls):
                raise AssertionError(f"sharded step {name}: K1 / K2 not "
                                     f"through local_map on every call "
                                     f"({routes})")
            by_run[TRAIN_ARCH, f"sharded step, {TRAIN_CUT} layers, {name}"] \
                = (launches, shapes)
            if ref is None:
                ref = (p, v, m)
                continue
            diff = _first_difference((p, v), ref[:2])
            same = diff is None and all(torch.equal(m[k], ref[2][k])
                                        for k in ("loss", "gnorm"))
            log(f"  {name} vs unsharded: parameters, momentum, loss and "
                f"gnorm bitwise {same} "
                f"{'ok' if same else 'FAIL: ' + str(diff)}")
            if not same:
                raise AssertionError(f"sharded step {name}: {diff}")
            del p, v, m
    del ref, params
    gc.collect()
    torch.cuda.empty_cache()
    return by_run


def phase_vocab_shard(smi: str) -> None:
    """(a') K1's vocab-shard form, what the sharded route runs on each rank
    for a head split over the vocab (one card cannot split it: checked
    here on the pieces).  The yi-6b head at N 1024 (phase 3's train-step
    case) cut into two halves of the vocab, the labels spread over both:
    per half, the kernel's per-row log-sum-exp and gold logit
    (``chunked_ce.cross_entropy_lse_gold``) against the plain version's,
    and the halves combined as the all-reduce combines them (log-add-exp
    of the two, sum of the golds) against the plain NLL of the whole
    head, each within CE_RTOL.  Not counted: a check."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_ce import cross_entropy_lse_gold
    cfg = get_config(TRAIN_ARCH)
    N, D, V = 1024, cfg.d_model, cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(11)
    h = torch.randn(1, N, D, device="cuda", generator=gen)
    w = torch.randn(D, V, device="cuda", generator=gen) / math.sqrt(D)
    labels = torch.randint(0, V, (1, N), device="cuda", generator=gen)
    labels[:, ::7] = -100
    half = V // 2
    lse, gold, errs = [], [], {}
    for i, (lo, hi) in enumerate(((0, half), (half, V))):
        wi = w[:, lo:hi].contiguous()
        here = (labels >= lo) & (labels < hi)
        li = torch.where(here, labels - lo, hi - lo)
        got, want = cross_entropy_lse_gold(h, wi, li), \
            ref.cross_entropy_lse_gold(h, wi, li)
        for k, a, b in zip(("lse", "gold"), got, want):
            errs[f"{k} {i}"] = float(((a - b).abs()).max()
                                     / b.abs().max().clamp(min=1e-30))
        lse.append(got[0])
        gold.append(got[1])
    nll = torch.where(labels.reshape(-1) >= 0,
                      torch.logaddexp(*lse) - gold[0] - gold[1], 0.0)
    whole = ref.cross_entropy_rows(h, w, labels)
    errs["nll"] = float((nll - whole).abs().max() / whole.abs().max())
    ok = all(math.isfinite(e) and e <= CE_RTOL for e in errs.values())
    log(f"vocab shard (a'): K1 on two halves of the {cfg.name} head, N {N} "
        f"D {D} V {V}: max rel err " + ", ".join(
            f"{k} {e:.2e}" for k, e in errs.items())
        + f" (tol {CE_RTOL:g}) {'ok' if ok else 'FAIL'} ({smi})")
    if not ok:
        raise AssertionError(f"K1's vocab-shard form disagrees: {errs}")


def phase_moe_ep(smi: str, device="cuda") -> None:
    """(b) ``moe_ep.forward_ep`` at qwen3-moe's published widths: one MoE
    layer (128 experts, D 4096, F 1536, top 8; 9.66 GB of experts in fp32)
    over 4 x 256 tokens on the (1, 1) mesh (M = 1), forward and backward
    at capacity factor 8, against ``moe.forward`` on the same parameters:
    output, aux and every gradient within EP_TOL of the reference's scale
    (max abs diff over max abs value).  Time, peak and the bytes through
    ``all_to_all`` logged."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import moe, moe_ep
    cfg = get_config(MOE_ARCH)
    mesh = init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))
    gen = torch.Generator(device=device).manual_seed(5)
    p = moe.init(gen, cfg, device=device)
    B, T = EP_TOKENS
    x = torch.randn(B, T, cfg.d_model, generator=gen, device=device) * 0.5
    w = torch.randn(B, T, cfg.d_model, generator=gen, device=device)
    experts = sum(p[k].numel() * 4 for k in ("w_gate", "w_up", "w_down"))
    log(f"moe_ep (b): {cfg.name} one MoE layer, E {cfg.num_experts}, D "
        f"{cfg.d_model}, F {cfg.moe_d_ff}, top {cfg.experts_per_token}, "
        f"experts {experts / 1e9:.2f} GB fp32, {B} x {T} tokens, cf {EP_CF}")
    # NCCL sets a communicator up at its first collective: not timed
    import torch.distributed as dist
    warm = torch.zeros(1, device=device)
    dist.all_to_all_single(torch.empty_like(warm), warm,
                           group=mesh.get_group("model"))
    out = {}
    for name in ("moe.forward", "forward_ep"):
        leaves = [x] + [p[k] for k in sorted(p)]
        for t in leaves:
            t.requires_grad_(True)
        # a first call warms what each path sets up once (forward_ep's
        # first took 10.4 s, the next 0.11, measured on H100s): untimed
        for timed in (False, True):
            for t in leaves:
                t.grad = None
            moe_ep.A2A.update(calls=0, bytes=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if name == "moe.forward":
                y, aux = moe.forward(p, cfg, x, capacity_factor=EP_CF)
            else:
                y, aux = moe_ep.forward_ep(p, cfg, x, mesh,
                                           capacity_factor=EP_CF)
            wy = (y * (w if name == "moe.forward" else
                       moe_ep._laid_out(w, mesh, y.placements)))
            (wy.sum() + aux).backward()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if name == "forward_ep":
            y, aux = y.full_tensor(), aux.full_tensor()
        grads = {"x": x.grad}
        grads.update({k: p[k].grad for k in p})
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
        out[name] = (y.detach(), aux.detach(), grads)
        log(f"  {name}: forward + backward {secs:.4f} s (warm), peak "
            f"{peak / GIB:.2f} GiB"
            + (f", all_to_all {moe_ep.A2A['calls']} calls, "
               f"{moe_ep.A2A['bytes'] / 2**20:.1f} MiB sent forward (M = 1:"
               f" the exchange stays on the card)"
               if name == "forward_ep" else "") + f" ({smi})")
    (ry, raux, rg), (ey, eaux, eg) = out["moe.forward"], out["forward_ep"]
    errs = {"out": float((ey - ry).abs().max() / ry.abs().max()),
            "aux": abs(float(eaux) - float(raux)) / abs(float(raux))}
    errs.update({f"d {k}": float((eg[k] - rg[k]).abs().max()
                                 / rg[k].abs().max()) for k in rg})
    ok = max(errs.values()) <= EP_TOL
    log(f"  forward_ep vs moe.forward (max abs diff / max abs): "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f" (tol {EP_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"forward_ep disagrees: {errs}")
    del out, p, x, w, rg, eg
    gc.collect()
    torch.cuda.empty_cache()


def phase_dryrun(smi: str) -> None:
    """(c) ``launch.dryrun.dryrun_one("yi-6b", "train_4k")``: the 16 x 16
    fake mesh on this machine's PyTorch, costed from depth 1 and 2 at the
    step's accumulation, with per-unit rematerialization (the default)
    and without; its per-device terms at the H100's constants
    (``roofline.hw``)."""
    from repro_torch.launch import dryrun
    for no_remat in (False, True):
        _dryrun_one(dryrun, no_remat, smi)


def _dryrun_one(dryrun, no_remat: bool, smi: str) -> None:
    t0 = time.perf_counter()
    rec = dryrun.dryrun_one(TRAIN_ARCH, "train_4k", no_remat=no_remat,
                            verbose=False)
    log(f"dry run (c), {'no remat' if no_remat else 'remat'}: "
        f"{rec['arch']} x {rec['shape']} x {rec['mesh']} "
        f"({rec['chips']} ranks, accumulation {rec['accum_steps']}) in "
        f"{time.perf_counter() - t0:.1f} s: per device "
        f"{rec['flops_per_device']:.4e} FLOPs, "
        f"{rec['bytes_per_device']:.4e} bytes, collectives "
        f"{rec['collectives_by_kind']} bytes; t_compute "
        f"{rec['t_compute_s']:.4e} s (bf16 989 TFLOP/s), t_memory "
        f"{rec['t_memory_s']:.4e} s (3.35 TB/s), t_collective "
        f"{rec['t_collective_s']:.4e} s (NVLink 450 GB/s), bottleneck "
        f"{rec['bottleneck']}, useful FLOPs ratio "
        f"{rec['useful_flops_ratio']:.4f}, argument bytes "
        f"{rec['mem_argument_size_in_bytes'] / GIB:.2f} GiB a device "
        f"(constants: H100 SXM data sheet; this card: {smi})")
    if not (rec["status"] == "ok" and rec["flops_per_device"] > 0
            and rec["collective_bytes_per_device"] > 0):
        raise AssertionError(f"dry run: {rec}")


def phase_sharded(smi: str, device="cuda") -> dict:
    """Phase 12: the sharded layer."""
    t0 = time.perf_counter()
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    with one_rank_group():
        by_run = phase_shard_step(smi, device)
        phase_vocab_shard(smi)
        phase_moe_ep(smi, device)
    phase_dryrun(smi)
    log(f"phase 12 (the sharded layer): {time.perf_counter() - t0:.1f} s")
    return by_run


# --------------------------------------------------------------- phase 13
REMAT_TOKENS = (256, 2048)   # (a), (b): yi-6b's 4-layer step at 4 x T
REMAT_CLIENTS = (
    # (c): (arch, ``depth_scaled`` units, kernels that must launch);
    # published widths, depth cut to 2 units, or 1 where the update's CPU
    # twin is slow (rwkv6-7b 31.7 s and zamba2-1.2b 27.4 s at 2, on an
    # H100 80GB HBM3 machine's host) or large (the MoE: 14.9 GB), to keep the script's time
    ("mamba2-370m", 2, ("chunked_cross_entropy", "mamba2_scan")),
    ("rwkv6-7b", 1, ("chunked_cross_entropy", "rwkv6_scan")),
    ("zamba2-1.2b", 1, ("chunked_cross_entropy", "flash_attention",
                        "mamba2_scan")),
    # one encoder and one decoder layer: 2 depth units
    ("whisper-small", 1, ("chunked_cross_entropy", "flash_attention")),
    ("qwen3-moe-235b-a22b", 1, ("chunked_cross_entropy", "flash_attention")),
)
REMAT_ATOL = 1e-4            # (c): the card's update against the CPU's


def _remat_step(lm, params, batch, remat: bool) -> tuple:
    """One ``make_train_step`` (lr 3e-3, clip 1.0) from a copy of
    ``params``, remat on or off: ((params, momentum, metrics), launches,
    seconds, shapes, (entry, peak))."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import common
    from repro_torch.tree import tree_map
    p = tree_map(torch.clone, params)
    v = tree_map(torch.zeros_like, params)
    records, undo = _step_peaks("train")
    ctx = contextlib.nullcontext() if remat else common.disable_remat()
    try:
        step = steps.make_train_step(lm, lr=3e-3)
        with ctx:
            out, launches, secs, shapes = _counted(lambda: step(p, v, batch))
    finally:
        undo()
    (entry, peak), = records
    return out, launches, secs, shapes, (entry, peak)


def phase_remat_step(smi: str, device="cuda") -> dict:
    """(a), (b): ``make_train_step`` on yi-6b at published widths cut to 4
    layers, batch 4 x 256 and 4 x 2048, from one set of parameters, with
    per-unit rematerialization and without, under deterministic
    algorithms: parameters, momentum, loss and gnorm bitwise between the
    modes; each mode's warm step seconds and peak beside its own
    reckoning (:func:`_reckon_train`), each peak within it and
    RECKON_LIMIT; the recompute launches K2 again (K1 not)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build
    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_CUT)
    lm = build(cfg)
    params = lm.init(0, device=device)
    B, by_run = 4, {}
    for T in REMAT_TOKENS:
        batch = {k: torch.from_numpy(a).to(device) for k, a in next(
            TokenPipeline(cfg.vocab_size, T, B, seed=0).batches()).items()}
        acts = _eager_acts(cfg, B, T, device)
        log(f"remat ({'a' if T == REMAT_TOKENS[0] else 'b'}): {cfg.name}, "
            f"{TRAIN_CUT} layers (cut from {full.num_layers}), batch {B} x "
            f"{T} ({smi})")
        res = {}
        with deterministic():
            for remat in (True, False):
                step_r, _, how = _reckon_train(cfg, B, T, device,
                                               remat=remat, acts=acts)
                runs = [_remat_step(lm, params, batch, remat)
                        for _ in range(2)]   # the second warm
                out, launches, secs, shapes, (entry, peak) = runs[1]
                mode = "remat" if remat else "no remat"
                log(f"  {mode}: loss {float(out[2]['loss']):.6f}, gnorm "
                    f"{float(out[2]['gnorm']):.4f}, warm {secs:.4f} s (first "
                    f"{runs[0][2]:.4f} s), launches {launches}")
                _rates(mode, [secs], B * T, 6.0 * cfg.param_count() * B * T,
                       smi)
                _held(f"  {mode} step (reckoned: {how}; entry "
                      f"{entry / GIB:.2f} GiB)", peak, entry + step_r)
                res[remat] = out, launches
                by_run[TRAIN_ARCH, f"remat step 4 x {T}, {mode}"] = (
                    launches, shapes)
                del runs
        (on, n_on), (off, n_off) = res[True], res[False]
        diff = _first_difference(on[:2], off[:2])
        same = diff is None and all(torch.equal(on[2][k], off[2][k])
                                    for k in ("loss", "gnorm"))
        relaunched = (n_on["flash_attention"] == 2 * n_off["flash_attention"]
                      and n_on["chunked_cross_entropy"]
                      == n_off["chunked_cross_entropy"])
        log(f"  remat vs no remat: parameters, momentum, loss and gnorm "
            f"bitwise {same}; K2 {n_on['flash_attention']} vs "
            f"{n_off['flash_attention']} launches (the recompute's), K1 "
            f"{n_on['chunked_cross_entropy']} vs "
            f"{n_off['chunked_cross_entropy']} "
            f"{'ok' if same and relaunched else 'FAIL'}")
        if not (same and relaunched):
            raise AssertionError(f"remat step 4 x {T}: first difference "
                                 f"{diff}, launches {n_on} vs {n_off}")
        del res, on, off
        gc.collect()
        torch.cuda.empty_cache()
    del params
    return by_run


def _remat_client_inputs(arch: str, units: int, device):
    """(lm, params on the card, blocks, one batch) for (c): ``arch`` at
    published widths cut to ``units`` depth units, blocks of one unit
    each, one batch of 4 x 256 tokens (whisper's with 1500 stubbed
    frames)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import depth_scaled
    from repro_torch.models import build
    cfg = depth_scaled(get_config(arch), units)
    lm = build(cfg)
    params = lm.init(0, device=device)
    gen = torch.Generator(device=device).manual_seed(31)
    if cfg.is_encoder_decoder:
        batch, = _whisper_batches(cfg, 1, gen, device)
    else:
        toks = torch.randint(0, cfg.vocab_size, (4, 257), generator=gen,
                             device=device)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n = lm.num_depth_units
    return lm, params, tuple((k, k + 1) for k in range(n)), batch


def phase_remat_clients(smi: str, device="cuda") -> dict:
    """(c) One FeDepth ``client_update`` (lr 0.05, momentum 0.9) of each
    family whose unit body is rematerialized, at published widths cut to
    REMAT_CLIENTS' depth, remat on: within REMAT_ATOL of the same update
    on the CPU (each from the card's parameters and batch), its kernels
    launched; then the card's update with remat off: the recompute
    launches K2, K3 or K4 again for each trained unit, K1 (the head) as
    often."""
    import torch
    from repro_torch.core import blockwise
    from repro_torch.core.decomposition import Decomposition
    from repro_torch.models import common
    from repro_torch.tree import tree_map
    by_run = {}
    for arch, units, kernels in REMAT_CLIENTS:
        lm, params, blocks, batch = _remat_client_inputs(arch, units, device)
        runner = blockwise.lm_runner(lm)
        dec = Decomposition(blocks, 0, 0)
        kw = dict(lr=0.05, momentum=0.9)
        torch.cuda.reset_peak_memory_stats()
        out, n_on, secs, shapes = _counted(
            lambda: blockwise.client_update(runner, params, dec, [batch],
                                            **kw))
        peak = torch.cuda.max_memory_allocated()
        by_run[arch, "remat client update"] = (n_on, shapes)
        with common.disable_remat():
            off, n_off, secs_off, sh_off = _counted(
                lambda: blockwise.client_update(runner, params, dec,
                                                [batch], **kw))
        by_run[arch, "client update, no remat"] = (n_off, sh_off)
        del off
        t0 = time.perf_counter()
        cpu = blockwise.client_update(
            runner, tree_map(lambda t: t.cpu(), params), dec,
            [tree_map(lambda t: t.cpu(), batch)], **kw)
        cpu_s = time.perf_counter() - t0
        # held on the card: the MoE's CPU update alone takes ~60 GB of host
        worst = _states_within(out, tree_map(lambda t: t.to(device), cpu),
                               rtol=0, atol=REMAT_ATOL)
        scans = [k for k in kernels if k != "chunked_cross_entropy"]
        relaunched = (all(n_on[k] > n_off[k] for k in scans)
                      and n_on["chunked_cross_entropy"]
                      == n_off["chunked_cross_entropy"])
        missing = [k for k in kernels if n_on[k] <= 0]
        log(f"remat (c) {lm.cfg.name}, {lm.num_depth_units} depth units, "
            f"blocks {blocks}: {secs:.2f} s (no remat {secs_off:.2f} s), peak "
            f"{peak / GIB:.2f} GiB, launches {n_on} (no remat {n_off}); "
            f"against the CPU ({cpu_s:.1f} s) max abs diff {worst:.3e} (atol "
            f"{REMAT_ATOL:g}) {'ok' if relaunched and not missing else 'FAIL'}"
            f" ({smi})")
        if missing or not relaunched:
            raise AssertionError(f"remat {arch}: not launched {missing}, "
                                 f"launches {n_on} against no remat "
                                 f"{n_off}")
        del out, cpu, params, batch
        gc.collect()
        torch.cuda.empty_cache()
    return by_run


def phase_remat(smi: str, device="cuda") -> dict:
    """Phase 13: per-unit rematerialization."""
    t0 = time.perf_counter()
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    by_run = phase_remat_step(smi, device)
    by_run.update(phase_remat_clients(smi, device))
    log(f"phase 13 (per-unit rematerialization): "
        f"{time.perf_counter() - t0:.1f} s")
    return by_run


PATHS = (
    # (arch, layers, kernels that must launch on the path, method)
    ("qwen2-7b", 4, K1_K2, "fedepth"),
    ("mamba2-370m", MAMBA2_LAYERS, ("chunked_cross_entropy", "mamba2_scan"),
     "fedepth"),
    ("rwkv6-7b", 4, ("chunked_cross_entropy", "rwkv6_scan"), "fedepth"),
    ("qwen2-7b", 4, K1_K2, "depthfl"),
    ("zamba2-1.2b", 38, K1_K2 + ("mamba2_scan",), "fedepth"),
    ("mamba2-370m", MAMBA2_LAYERS, ("chunked_cross_entropy", "mamba2_scan"),
     "m-fedepth"),
    ("h2o-danube-3-4b", 4, K1_K2, "fedepth"),
    ("minicpm-2b", 4, K1_K2, "fedepth"),
    ("qwen2-vl-2b", 4, K1_K2, "fedepth"),
    # (..., clients): qwen3-moe at 1 layer (14.9 GB), 4 clients, a cohort
    # of 2, within RECKON_LIMIT
    ("qwen3-moe-235b-a22b", 1, K1_K2, "fedepth", 4),
)


KERNEL_META = {
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:107"),
    "chunked_cross_entropy": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chunked_ce.cu",
        replaces="src/repro/kernels/chunked_ce.py:66"),
    "mamba2_scan": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/mamba2_ssd.cu",
        replaces="src/repro/kernels/mamba2_ssd.py:92"),
    "rwkv6_scan": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:67"),
}


def attribute_launches(kernels: list, checked: dict, by_run: dict) -> None:
    """Each kernel's ``launches`` (the sum over the counted runs), its
    serving runs' apart, and ``heads``: every phase-3 case that names a
    path or that a run launched the kernel at, with its launches by run.
    Fails on a launch at a shape that phase 3 did not check against the
    plain version, and on a path's case that its path never launched."""
    unchecked = []
    for rec in kernels:
        name, held = rec["name"], checked[rec["name"]]
        for head in held.values():
            head["runs"] = {}
        for (arch, method), (launches, shapes) in by_run.items():
            for shape, n in shapes.get(name, {}).items():
                if shape not in held:
                    unchecked.append((name, arch, method, shape, n))
                    continue
                runs = held[shape]["runs"]
                runs[f"{arch} {method}"] = runs.get(f"{arch} {method}", 0) + n
        rec["launches"] = sum(run[name] for run, _ in by_run.values())
        rec["serving"] = {f"{arch} {method[len('serve '):]}": run[name]
                          for (arch, method), (run, _) in by_run.items()
                          if method.startswith("serve ")}
        rec["heads"] = []
        for head in held.values():
            head["launches"] = sum(head["runs"].values())
            if head["path"] or head["launches"]:
                rec["heads"].append(head)
    for name, arch, method, shape, n in unchecked:
        log(f"{name}: {n} launches at {shape} in {arch} {method}, a shape "
            f"phase 3 did not check")
    unlaunched = [(rec["name"], h["shape"]) for rec in kernels
                  for h in rec["heads"] if not h["launches"]]
    if unchecked or unlaunched:
        raise AssertionError(f"launches at unchecked shapes {unchecked}; "
                             f"path cases never launched {unlaunched}")


def main() -> int:
    # phase 8's deterministic algorithms need this before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def done(what: str) -> None:
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")
    smi = phase_env()
    phase_build()
    numbers, checked = phase_kernels()
    done("phases 1-3")
    by_run = {}
    for arch, layers, path_kernels, method, *clients in PATHS:
        by_run[arch, method] = phase_path(arch, layers, path_kernels, method,
                                          *clients)
        done(f"path {arch} {method}")
    by_run["qwen2-vl-2b", "client update, vision prefix"] = \
        phase_vlm_client()
    by_run["whisper-small", "fedepth client update"] = \
        phase_whisper_client()
    by_run[MOE_ARCH, "fedepth client update"] = phase_moe_client()
    done("client updates")
    data = phase_images()
    done("images")
    phase_comm(data)
    done("comm")
    by_run.update(phase_systime(data, smi))
    done("system time")
    by_run.update(phase_scale(data, smi))
    done("scale")
    del data
    phase_vit()
    done("vit")
    for arch, runs in phase_serving().items():
        for stage, run in runs.items():
            by_run[arch, f"serve {stage}"] = run
    done("serving")
    by_run.update(phase_stacked(smi))
    by_run.update(phase_train(smi))
    by_run.update(phase_sharded(smi))
    by_run.update(phase_remat(smi))
    kernels = [dict(name=name, **KERNEL_META[name], **numbers[name])
               for name in KERNEL_META]
    attribute_launches(kernels, checked, by_run)
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
