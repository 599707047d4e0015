"""Serving driver: a batch of prompts walked through the decode cache,
then greedy or temperature sampling (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --reduced --device cpu --batch 2 --prompt-len 16 --gen 8

Runs on the GPU unless ``--device cpu``.  Parameters are random, drawn
from ``--seed`` (no checkpoint ships with the repo).  As in the
reference, the prompt is fed one token at a time through ``decode_step``
(the point is the cache's consistency; ``LM.prefill`` is the one-pass
forward).  On the card the dense, MoE and VLM decode attention is plain
PyTorch, while each ssm decode step runs the scan kernel (K3 or K4) at
T = 1 from the carried state.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.api import LM, build, init_cache


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor         # (B, gen) generated token ids
    prompt_logits: torch.Tensor  # (B, 1, V) after the last prompt token
    logits: torch.Tensor         # (B, 1, V) after the last generated token
    prompt_seconds: float        # the prompt walk, synchronised
    decode_seconds: float        # the generation loop, synchronised


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _next_token(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, 1) ids: the argmax, or a draw from softmax(logits / T)."""
    last = logits[:, -1]
    if temperature > 0:
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return last.argmax(-1, keepdim=True)


@torch.inference_mode()
def serve(lm: LM, params, prompt: torch.Tensor, gen: int, *,
          temperature: float = 0.0,
          generator: Optional[torch.Generator] = None) -> ServeResult:
    """Walk ``prompt`` (B, P) through a fresh cache of P + ``gen`` slots
    on the prompt's device, then generate ``gen`` tokens a sequence."""
    if lm.cfg.is_encoder_decoder:
        raise SystemExit("whisper decode at 32k+ is out of architectural "
                         "spec (DESIGN.md §4); use prefill for audio")
    B, P = prompt.shape
    dev = prompt.device
    cache = init_cache(lm.cfg, B, P + gen, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(P):
        logits, cache = lm.decode_step(params, prompt[:, t:t + 1], cache, t)
    _sync(dev)
    prompt_seconds = time.perf_counter() - t0
    prompt_logits = logits

    cur = _next_token(logits, temperature, generator)
    out = []
    t0 = time.perf_counter()
    for g in range(gen):
        out.append(cur)
        logits, cache = lm.decode_step(params, cur, cache, P + g)
        cur = _next_token(logits, temperature, generator)
    _sync(dev)
    return ServeResult(torch.cat(out, dim=1), prompt_logits, logits,
                       prompt_seconds, time.perf_counter() - t0)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCH_IDS),
                    default="yi-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="where to run: the GPU unless 'cpu'")
    args = ap.parse_args(argv)

    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    dev = resolve_device(args.device)
    lm = build(cfg)
    params = lm.init(args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    B, P = args.batch, args.prompt_len
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    res = serve(lm, params, prompt, args.gen, temperature=args.temperature,
                generator=gen)
    print(f"prefill({P} tok) {res.prompt_seconds:.2f}s")
    dt = res.decode_seconds
    print(f"decode {args.gen} tok x {B} seq in {dt:.2f}s "
          f"({args.gen * B / max(dt, 1e-9):.1f} tok/s)")
    for b, seq in enumerate(res.tokens.tolist()):
        print(f"  seq{b}: {seq}")
    return res


if __name__ == "__main__":
    main()
