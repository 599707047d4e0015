"""Multi-pod dry run: one step of every (arch x shape x mesh) combination
on a fake world, counted per device (port of ``repro.launch.dryrun``).

Proves the distribution config is coherent without hardware:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k [--multi-pod] [--fedepth-block LO:HI] [--out d.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each step under 512 XLA host
placeholder devices and reads the compiled module's costs.  The port
runs the step eagerly on ``meta`` tensors (shapes, no data) laid out as
DTensors by ``launch.sharding`` on the production mesh over a fake
process group of 256 / 512 ranks (``torch.testing._internal``'s
``FakeStore``, backend ``"fake"``: every collective returns at once; this
process is rank 0).  ``roofline.analysis.DeviceCounts`` counts what one
device runs: FLOPs from the local shapes after DTensor's sharding
propagation, bytes, and the collectives' result bytes by kind; a
``CommDebugMode`` beside it counts the collectives' calls.  The mesh's
device type is "cuda" (no card is needed for a fake world): on a "cpu"
mesh DTensor lowers an all-to-all to an all-gather plus a chunk, which
is not what the cards would issue.

As in the reference, the step is costed with per-unit rematerialization
(``models.common.maybe_checkpoint``), as training runs it: each unit's
forward runs again in the backward, and the counting mode sees it there.
``--no-remat`` costs it without (``common.disable_remat``).  The
kernels take their plain versions on ``meta`` tensors, as the
reference's costing forces its ``ref`` kernels.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPE_BY_NAME, SHAPES
from repro_torch.configs.shapes import input_specs, shape_applicable
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build, common
from repro_torch.roofline import analysis


def mesh_devices(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


MICRO_TOKENS = 8192  # target per-device tokens per microbatch


def default_accum(cfg, shape, mesh) -> int:
    """Grad-accumulation steps so one microbatch's per-device activations
    fit the device (65k tokens/device at d=4096 cannot)."""
    if shape.mode != "train":
        return 1
    sizes = sharding.axis_sizes(mesh)
    bshards = 1
    for ax in ("pod", "data"):
        if ax in sizes and shape.global_batch % (
                bshards * sizes[ax]) == 0:
            bshards *= sizes[ax]
    per_dev_tokens = (shape.global_batch // bshards) * shape.seq_len
    accum = max(1, per_dev_tokens // MICRO_TOKENS)
    while shape.global_batch % (accum * bshards):
        accum -= 1
    return max(1, accum)


def depth_scaled(cfg, n_units: int):
    """Config with depth reduced to n_units finest-decomposition units
    (same widths/vocab/experts) — the repeating cell for cost
    extrapolation."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg,
                                   num_layers=n_units * cfg.hybrid_attn_every)
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, encoder_layers=n_units,
                                   num_layers=n_units)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, num_layers=n_units)
    return dataclasses.replace(cfg, num_layers=n_units * cfg.moe_every)


def depth_units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    if cfg.is_encoder_decoder:
        return cfg.num_layers  # enc and dec scale together
    if cfg.family == "ssm":
        return cfg.num_layers
    return cfg.num_layers // cfg.moe_every


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks, this process rank 0: every
    collective returns at once and moves nothing.  ``FakeStore`` is
    PyTorch's internal test API; a PyTorch without it fails here."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own fake process group; "
                           "one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta_batch(cfg, shape, specs, bspecs, mesh):
    """The step's inputs as meta DTensors laid out by ``bspecs``."""
    from torch.distributed.tensor import distribute_tensor

    def one(spec, s):
        t = torch.empty(s.shape, dtype=s.dtype, device="meta")
        return distribute_tensor(t, mesh, sharding.placements(spec, mesh))
    out = {}
    for k, s in specs.items():
        if k == "cache":
            out[k] = {c: one(bspecs[k][c], v) for c, v in s.items()}
        elif k == "cache_index":
            out[k] = 0
        else:
            out[k] = one(bspecs[k], s)
    return out


def _local_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor)
               and common.is_dtensor(t))


def _serving_step(lm, shape, decode_tokens: int):
    """``steps.step_for_shape``'s serving step with the model run under
    ``no_grad``, not ``LM``'s ``inference_mode`` (ROADMAP fault 21).
    Under inference mode a composite op (``aten.matmul``) reaches DTensor
    whole, not decomposed: DTensor's first propagation of it runs the
    decomposition on global shapes beneath
    :class:`~repro_torch.roofline.analysis.DeviceCounts`, which counts it
    as device work, and the local op then comes back as ``aten.matmul``,
    which has no FLOP formula: a first count read the global products,
    and every later one, the propagation cached, read 0 FLOPs.  Under
    ``no_grad`` the op is decomposed before DTensor sees it, as in a
    train step, and each count is the local ops'."""
    module, cfg = lm.module, lm.cfg

    def decode(params, tok, cache, idx, mrope_positions=None):
        return module.decode_step(params, cfg, tok, cache, int(idx),
                                  mrope_positions=mrope_positions)

    @torch.no_grad()
    def step(params, batch):
        if shape.mode == "prefill":
            return module.prefill(params, cfg, batch)
        if decode_tokens == 1:
            return decode(params, batch["tokens"], batch["cache"],
                          batch["cache_index"],
                          mrope_positions=batch.get("mrope_positions"))
        # steps.make_multi_decode_step: greedy feedback
        cache, idx, tok = batch["cache"], int(batch["cache_index"]), \
            batch["tokens"]
        out = []
        for i in range(decode_tokens):
            logits, cache = decode(params, tok, cache, idx + i)
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(logits)
        return torch.stack(out), cache

    return step


def _count_step(cfg, shape, mesh, *, fsdp=None, accum_steps=1,
                fedepth_block=None, buffered_z=False, decode_tokens=1,
                ws_decode=False, moe_ep=False, no_remat=False) -> dict:
    """One step of ``cfg`` at ``shape`` on meta DTensors, counted per
    device: {"flops", "bytes", "collectives", "collective_calls"}."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.tree import tree_map
    lm = build(cfg)
    params_shape = steps.abstract_params(lm)
    pspecs = sharding.param_specs(cfg, params_shape, mesh, fsdp=fsdp)
    params = sharding.distribute(params_shape, pspecs, mesh)
    specs = input_specs(cfg, shape)
    bspecs = sharding.batch_specs(cfg, shape, mesh)
    if buffered_z and shape.mode == "train":
        # the paper's z buffering: the block step consumes the stored
        # prefix activation instead of tokens
        from repro_torch.configs.shapes import TensorSpec
        specs = dict(specs)
        del specs["tokens"]
        specs["z_in"] = TensorSpec(
            (shape.global_batch, shape.seq_len, cfg.d_model), torch.bfloat16)
        bspecs = dict(bspecs)
        bspecs.pop("tokens", None)
        bspecs["z_in"] = (sharding._batch_axis(sharding.axis_sizes(mesh)),
                          None, None)
    batch = _meta_batch(cfg, shape, specs, bspecs, mesh)
    micro = sharding.to_named(bspecs, mesh) if accum_steps > 1 else None
    if shape.mode == "train":
        step_fn, needs_opt = steps.step_for_shape(
            lm, shape, fedepth_block=fedepth_block, accum_steps=accum_steps,
            grad_shardings=sharding.to_named(pspecs, mesh),
            microbatch_shardings=micro, buffered_z=buffered_z)
    else:
        step_fn, needs_opt = _serving_step(lm, shape, decode_tokens), False
    ws_ctx = common.weight_stationary_decode() if ws_decode \
        else contextlib.nullcontext()
    ep_ctx = common.ep_moe() if moe_ep else contextlib.nullcontext()
    remat_ctx = common.disable_remat() if no_remat \
        else contextlib.nullcontext()
    counts, comm = analysis.DeviceCounts(host_ops=False), CommDebugMode()
    with common.mesh_context(mesh), ws_ctx, ep_ctx, remat_ctx:
        if needs_opt:
            if fedepth_block is not None:
                # momentum exists only for the trained block
                from repro_torch.core import blockwise
                train = blockwise.lm_runner(lm).split(params, *fedepth_block)
            else:
                train = params
            opt = tree_map(lambda t: DTensor.from_local(
                torch.empty(t.to_local().shape, dtype=torch.float32,
                            device="meta"), mesh, t.placements,
                run_check=False), train)
            with comm, counts:
                step_fn(params, opt, batch)
        else:
            with comm, counts:
                step_fn(params, batch)
    calls = {str(k).split(".")[-1]: int(v)
             for k, v in comm.get_comm_counts().items()}
    return {"flops": counts.flops, "bytes": counts.bytes,
            "collectives": dict(counts.collectives),
            "collective_calls": calls}


def costing_extrapolate(cfg, shape, mesh, fsdp=None, accum_steps=1,
                        no_remat=False, decode_tokens=1) -> dict:
    """Depth-1/depth-2 linear extrapolation of per-device cost terms:
    cost(U) = c1 + (U-1)*(c2-c1), each cell counted at ``accum_steps``
    microbatches, as the step runs.  The reference needs it because XLA's
    cost analysis counts a while-loop body once; the port's eager count
    sees every unit, so this equals the full-depth count (tests hold it
    to a direct count at depth 3, with and without accumulation) and
    costs two shallow steps instead of a deep one.  ``fsdp`` is pinned to
    the FULL config's policy (a depth-1 llama4 falls under the FSDP param
    threshold)."""
    U = depth_units(cfg)
    fsdp = sharding.needs_fsdp(cfg) if fsdp is None else fsdp
    c1, c2 = (_count_step(depth_scaled(cfg, n), shape, mesh, fsdp=fsdp,
                          accum_steps=accum_steps, no_remat=no_remat,
                          decode_tokens=decode_tokens) for n in (1, 2))
    f1, f2, b1, b2 = c1["flops"], c2["flops"], c1["bytes"], c2["bytes"]
    flops = f1 + (U - 1) * (f2 - f1)
    byts = b1 + (U - 1) * (b2 - b1)
    kinds = set(c1["collectives"]) | set(c2["collectives"])
    colls = {k: c1["collectives"].get(k, 0) + (U - 1) * (
        c2["collectives"].get(k, 0) - c1["collectives"].get(k, 0))
        for k in kinds}
    return {"flops": flops, "bytes": byts, "collectives": colls,
            "cell": {"f1": f1, "f2": f2, "b1": b1, "b2": b2}}


def _argument_bytes(cfg, shape, mesh, fsdp=None, fedepth_block=None
                    ) -> int:
    """Per-device bytes of the step's arguments: the parameters, the
    momentum (for the trained block only, in a block step) and the
    batch, each rank's shard."""
    lm = build(cfg)
    params_shape = steps.abstract_params(lm)
    pspecs = sharding.param_specs(cfg, params_shape, mesh, fsdp=fsdp)
    params = sharding.distribute(params_shape, pspecs, mesh)
    total = _local_bytes(params)
    if shape.mode == "train":
        train = params
        if fedepth_block is not None:
            from repro_torch.core import blockwise
            train = blockwise.lm_runner(lm).split(params, *fedepth_block)
        total += 2 * _local_bytes(train)    # fp32 slots of bf16 leaves
    bspecs = sharding.batch_specs(cfg, shape, mesh)
    batch = _meta_batch(cfg, shape, input_specs(cfg, shape), bspecs, mesh)
    return total + _local_bytes(batch)


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               fedepth_block=None, accum_steps=None, costing: bool = True,
               fsdp=None, no_remat: bool = False, force_window: int = 0,
               buffered_z: bool = False, ws_decode: bool = False,
               decode_tokens: int = 1, moe_ep: bool = False,
               full_count: bool = False, verbose: bool = True) -> dict:
    """One combination on the fake world.  With ``costing`` (the
    default, as the reference's) the terms come from
    :func:`costing_extrapolate`: two shallow steps at the full widths.
    Without it, or with ``full_count``, the whole step (every unit, every
    microbatch) is counted directly, which DTensor's eager dispatch makes
    slow at full depth (yi-6b x train_4k: ~2 minutes on one host core);
    its terms then stand under ``direct``.  A FeDepth block step is
    always counted directly: it does not extrapolate in total depth."""
    cfg = get_config(arch)
    if force_window:
        # beyond-assignment path: run a dense arch at long context by
        # switching it to sliding-window attention (bounded ring KV cache)
        cfg = dataclasses.replace(cfg, sliding_window=force_window)
    shape = SHAPE_BY_NAME[shape_name]
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}

    t0 = time.time()
    direct = None
    with fake_world(mesh_devices(multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        if accum_steps is None:
            accum_steps = default_accum(cfg, shape, mesh)
        extrapolate = costing and fedepth_block is None
        if full_count or not extrapolate:
            direct = _count_step(cfg, shape, mesh, fsdp=fsdp,
                                 accum_steps=accum_steps,
                                 fedepth_block=fedepth_block,
                                 buffered_z=buffered_z,
                                 decode_tokens=decode_tokens,
                                 ws_decode=ws_decode, moe_ep=moe_ep,
                                 no_remat=no_remat)
        t_count = time.time() - t0
        counts = (costing_extrapolate(cfg, shape, mesh, fsdp=fsdp,
                                      accum_steps=accum_steps,
                                      no_remat=no_remat,
                                      decode_tokens=decode_tokens)
                  if extrapolate else direct)
        args_bytes = _argument_bytes(cfg, shape, mesh, fsdp, fedepth_block)
        roof = analysis.analyze(counts, cfg, shape, mesh_name,
                                mesh_devices(multi_pod), arch)
    t_costing = time.time() - t0 - t_count
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] "
              f"{'costed from depth 1 and 2' if extrapolate else 'counted'}"
              f" in {time.time() - t0:.1f}s (full step counted: "
              f"{direct is not None}); per device: "
              f"{roof.flops_per_device:.4e} FLOPs, "
              f"{roof.bytes_per_device:.4e} bytes, collectives "
              f"{roof.collectives_by_kind} bytes; t_compute "
              f"{roof.t_compute:.4e} s, t_memory {roof.t_memory:.4e} s, "
              f"t_collective {roof.t_collective:.4e} s ({roof.bottleneck})")
    out = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "ok", "count_s": t_count, "costing_s": t_costing,
           "fedepth_block": list(fedepth_block) if fedepth_block else None,
           "accum_steps": accum_steps,
           **roof.to_dict(),
           "mem_argument_size_in_bytes": args_bytes}
    if direct is not None:
        out["direct"] = {k: direct[k] for k in ("flops", "bytes",
                                                "collectives",
                                                "collective_calls")}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) on this process's mesh")
    ap.add_argument("--fedepth-block", default=None,
                    help="LO:HI unit range -> count the FeDepth block step")
    ap.add_argument("--accum", type=int, default=None,
                    help="override grad-accumulation steps")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="force pure-TP sharding (perf variant for decode)")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable per-unit rematerialization")
    ap.add_argument("--moe-ep", action="store_true",
                    help="explicit all-to-all expert parallelism")
    ap.add_argument("--decode-tokens", type=int, default=1,
                    help="decode N tokens per dispatch")
    ap.add_argument("--ws-decode", action="store_true",
                    help="weight-stationary decode (replicate activations "
                         "over data instead of gathering FSDP weights)")
    ap.add_argument("--fedepth-buffered", action="store_true",
                    help="block step consumes buffered z_in (paper's "
                         "frozen-then-pass buffering)")
    ap.add_argument("--force-window", type=int, default=0,
                    help="force sliding-window attention (dense arch at "
                         "long context)")
    ap.add_argument("--full-count", action="store_true",
                    help="also count the whole step directly (slow at "
                         "full depth; the terms come from the costing "
                         "cells otherwise)")
    ap.add_argument("--out", default=None, help="write JSON result here")
    args = ap.parse_args(argv)

    fb = None
    if args.fedepth_block:
        lo, hi = args.fedepth_block.split(":")
        fb = (int(lo), int(hi))

    results = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                try:
                    results.append(dryrun_one(arch, shape.name,
                                              multi_pod=args.multi_pod))
                except Exception as e:  # a failure here is a bug: report it
                    traceback.print_exc()
                    results.append({"arch": arch, "shape": shape.name,
                                    "status": "FAILED", "error": str(e)})
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --all)")
        results.append(dryrun_one(args.arch, args.shape,
                                  multi_pod=args.multi_pod,
                                  fedepth_block=fb,
                                  accum_steps=args.accum,
                                  fsdp=(False if args.no_fsdp else None),
                                  no_remat=args.no_remat,
                                  force_window=args.force_window,
                                  buffered_z=args.fedepth_buffered,
                                  ws_decode=args.ws_decode,
                                  decode_tokens=args.decode_tokens,
                                  moe_ep=args.moe_ep,
                                  full_count=args.full_count))

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)

    failed = [r for r in results if r.get("status") == "FAILED"]
    print(f"\n{len(results)} combos: "
          f"{sum(r.get('status') == 'ok' for r in results)} ok, "
          f"{sum(r.get('status') == 'skipped' for r in results)} skipped, "
          f"{len(failed)} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
