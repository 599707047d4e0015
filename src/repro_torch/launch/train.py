"""End-to-end training CLI (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --reduced --device cpu --steps 4 --fedepth --budget-mb 4

Runs on the GPU unless ``--device cpu``.  Parameters are random, drawn
from ``--seed``; batches come from the seeded synthetic
``data.tokens.TokenPipeline`` (numpy), moved to the device.

Modes:
  * standard   — full-model SGD-momentum steps with global-norm clipping
    (``launch.steps.make_train_step``)
  * --fedepth  — the paper's technique: decompose by --budget-mb and train
    blocks sequentially, cycling the block schedule across steps (step s
    trains block s % n_blocks, whose momentum is created at its first
    step as zeros of its split).

Both update the parameters in place (``launch.steps``).  Prints the
schedule (FeDepth), then one line a step with its loss and synchronised
seconds; ``--ckpt-dir`` saves the final parameters as a round checkpoint
(``train.checkpoint.save_round``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import decomposition, memory_model
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import steps as step_lib
from repro_torch.models.api import build
from repro_torch.train import checkpoint
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainResult:
    params: dict                       # the final parameters (on the device)
    losses: List[float]                # one a step
    seconds: List[float]               # each step's, synchronised
    blocks: Optional[Tuple[Tuple[int, int], ...]] = None   # FeDepth only
    schedule: Optional[str] = None     # ``schedule_summary`` (FeDepth)
    checkpoint: Optional[str] = None   # the saved path (``--ckpt-dir``)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stub_inputs(cfg: ModelConfig, batch: int, seq: int, seed: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """The stubbed frontends' inputs, drawn once from a generator seeded
    by ``seed``: whisper's ``encoder_embeds`` (B, frames, D), a VLM's
    ``vision_embeds`` (B, P, D) and text ``mrope_positions`` (3, B, T)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    if cfg.is_encoder_decoder:
        out["encoder_embeds"] = torch.randn(
            batch, cfg.max_source_positions, cfg.d_model, generator=gen,
            device=device) * 0.1
    if cfg.family == "vlm":
        out["vision_embeds"] = torch.randn(
            batch, cfg.frontend_embed_tokens, cfg.d_model, generator=gen,
            device=device) * 0.1
        out["mrope_positions"] = torch.arange(
            seq, device=device).expand(3, batch, seq)
    return out


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-6b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--fedepth", action="store_true")
    ap.add_argument("--budget-mb", type=float, default=64.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where to run: the GPU unless 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    lm = build(cfg)
    params = lm.init(args.seed, device=dev)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"[{cfg.name}] params={n / 1e6:.2f}M on {dev}")

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch_size=args.batch, seed=args.seed)
    batches = pipe.batches()
    extras = stub_inputs(cfg, args.batch, args.seq, args.seed, dev)

    def next_batch():
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(batches).items()}
        return {**b, **extras}

    def zeros_of(tree):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        tree)

    res = TrainResult(params, [], [])
    if args.fedepth:
        mem = memory_model.lm_memory(cfg, args.batch, args.seq)
        dec = decomposition.decompose(mem, int(args.budget_mb * 2**20))
        res.blocks = dec.blocks
        res.schedule = decomposition.schedule_summary(dec, mem)
        print(res.schedule)
        if not dec.blocks:
            raise SystemExit(f"--budget-mb {args.budget_mb} trains no block")
        block_steps = [step_lib.make_fedepth_block_step(lm, lo, hi,
                                                        lr=args.lr)
                       for lo, hi in dec.blocks]
        opt_states = [None] * len(dec.blocks)
    else:
        step = step_lib.make_train_step(lm, lr=args.lr)
        opt = zeros_of(params)
    t0 = time.perf_counter()
    for s in range(args.steps):
        b = next_batch()
        _sync(dev)
        t_step = time.perf_counter()
        if args.fedepth:
            j = s % len(dec.blocks)
            lo, hi = dec.blocks[j]
            fn, runner = block_steps[j]
            if opt_states[j] is None:
                opt_states[j] = zeros_of(runner.split(params, lo, hi))
            params, opt_states[j], m = fn(params, opt_states[j], b)
            where = f" block[{lo}:{hi}]"
        else:
            params, opt, m = step(params, opt, b)
            where = ""
        _sync(dev)
        now = time.perf_counter()
        res.seconds.append(now - t_step)
        res.losses.append(float(m["loss"]))
        print(f"step {s:4d}{where} loss={res.losses[-1]:.4f} "
              f"{res.seconds[-1]:.3f}s ({now - t0:.1f}s)")
    res.params = params

    if args.ckpt_dir:
        res.checkpoint = checkpoint.save_round(args.ckpt_dir, args.steps,
                                               params, {"arch": cfg.name})
        print("saved", res.checkpoint)
    return res


if __name__ == "__main__":
    main()
