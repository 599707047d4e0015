"""Many ranks on one host, for testing the sharded paths on the CPU.

The reference's ``force_host_device_count`` makes XLA's CPU backend
expose N devices to one process.  PyTorch has no such flag: a mesh of N
devices is N processes.  :func:`spawn` starts N ``gloo`` ranks over a
``FileStore`` in a temporary directory (never a TCP port: several test
processes may spawn at once) and runs one named worker of this module in
each.  The workers live here, not in a test file, so that the spawned
children can import them.  A worker takes ``(rank, world, *args)`` and
returns a picklable result; :func:`spawn` returns rank 0's.

Runtime modules never import this one
(``tests/test_torch_package.py::test_runtime_modules_do_not_import_testing``).
"""
from __future__ import annotations

import os
import pickle
import tempfile
import traceback
from typing import Any

import torch
import torch.distributed as dist


def _entry(rank: int, world: int, store_path: str, out_path: str,
           worker: str, args: tuple) -> None:
    torch.set_num_threads(1)     # the ranks share the host's cores
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        result = ("ok", globals()[worker](rank, world, *args))
    except BaseException:             # reported to the parent by rank
        result = ("error", traceback.format_exc())
    try:
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(world: int, worker: str, *args) -> Any:
    """Run ``worker(rank, world, *args)`` (a function of this module) in
    ``world`` gloo ranks; return rank 0's result.  Raises with the
    traceback of every rank that failed."""
    import torch.multiprocessing as mp
    if worker not in globals() or worker.startswith("_"):
        raise KeyError(f"no worker {worker!r} in repro_torch.testing.dist")
    with tempfile.TemporaryDirectory() as d:
        store, out = os.path.join(d, "store"), os.path.join(d, "result")
        mp.start_processes(_entry, args=(world, store, out, worker, args),
                           nprocs=world, join=True, start_method="spawn")
        results = []
        for r in range(world):
            with open(f"{out}.{r}", "rb") as f:
                results.append(pickle.load(f))
    failed = [f"rank {r}:\n{res}" for r, (kind, res) in enumerate(results)
              if kind == "error"]
    if failed:
        raise RuntimeError("\n".join(failed))
    return results[0][1]


# --------------------------------------------------------------------------
# workers
# --------------------------------------------------------------------------
def _numpy(tree):
    from repro_torch.tree import tree_map
    from torch.distributed.tensor import DTensor

    def host(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    return tree_map(host, tree)


MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
CAPACITY_FACTORS = (8.0, 1.25)
# train-step cases: (fsdp, accumulation steps)
STEP_CASES = ((False, 1), (True, 1), (True, 2))


def _mesh22():
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(2, device_type="cpu")


def _train_steps(mesh, params_ref, batch_np, lr, cases=STEP_CASES):
    """The reduced yi-6b step on DTensor parameters laid out by
    ``param_specs`` for each of ``cases``; parameters and momentum in
    the reference's layout."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import sharding, steps
    from repro_torch.models import build, common
    from repro_torch.testing.convert import (params_from_reference,
                                             params_to_reference)
    from repro_torch.tree import tree_map
    from torch.distributed.tensor import distribute_tensor
    cfg = get_reduced_config("yi-6b")
    lm = build(cfg)
    params = params_from_reference(params_ref, device="cpu")
    B, T = batch_np["tokens"].shape
    bspecs = sharding.batch_specs(cfg, InputShape("t", T, B, "train"), mesh)
    out = {}
    for fsdp, accum in cases:
        specs = sharding.param_specs(cfg, params, mesh, fsdp=fsdp)
        p = sharding.distribute(params, specs, mesh)
        v = sharding.distribute(tree_map(torch.zeros_like, params), specs,
                                mesh)
        batch = {k: distribute_tensor(torch.from_numpy(a), mesh,
                                      sharding.placements(bspecs[k], mesh))
                 for k, a in batch_np.items()}
        with common.mesh_context(mesh):
            step = steps.make_train_step(
                lm, lr=lr, accum_steps=accum,
                grad_shardings=sharding.to_named(specs, mesh),
                microbatch_shardings=(sharding.to_named(bspecs, mesh)
                                      if accum > 1 else None))
            p, v, m = step(p, v, batch)
        full = _numpy((p, v))
        out[fsdp, accum] = {
            "params": params_to_reference(tree_map(torch.from_numpy,
                                                   full[0])),
            "momentum": params_to_reference(tree_map(torch.from_numpy,
                                                     full[1])),
            "loss": float(m["loss"].full_tensor()),
            "gnorm": float(m["gnorm"].full_tensor())}
    return out


def _remat_steps(mesh, params_ref, batch_np, lr):
    """The fsdp step of :func:`_train_steps` with per-unit
    rematerialization (the default) and under ``disable_remat()``, and
    the number of ``torch.utils.checkpoint`` calls the first made."""
    import torch.utils.checkpoint as ckpt
    from repro_torch.models import common
    calls, checkpoint = [0], ckpt.checkpoint

    def counted(*a, **kw):
        calls[0] += 1
        return checkpoint(*a, **kw)

    ckpt.checkpoint = counted
    try:
        on = _train_steps(mesh, params_ref, batch_np, lr, ((True, 1),))
    finally:
        ckpt.checkpoint = checkpoint
    with common.disable_remat():
        off = _train_steps(mesh, params_ref, batch_np, lr, ((True, 1),))
    return {"on": on[True, 1], "off": off[True, 1], "checkpoints": calls[0]}


def _moe_params(inputs, arch):
    return {k.split("/", 1)[1]: torch.from_numpy(a)
            for k, a in inputs.items() if k.startswith(arch + "/")}


def _forward_ep(mesh, inputs):
    """``moe_ep.forward_ep`` on each MoE arch at each capacity factor
    (output and aux, global), the delegation through ``moe.forward``
    under ``ep_moe()``, and at capacity factor 8 its gradients against
    the unsharded ``moe.forward``'s (max abs differences)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import common, moe, moe_ep
    from repro_torch.tree import tree_map
    out = {}
    for arch in MOE_ARCHS:
        cfg = get_reduced_config(arch)
        p = _moe_params(inputs, arch)
        x, w = (torch.from_numpy(inputs[f"{arch}:{k}"]) for k in ("x", "w"))
        for cf in CAPACITY_FACTORS:
            pp = tree_map(lambda t: t.clone().requires_grad_(True), p)
            xx = x.clone().requires_grad_(True)
            moe_ep.A2A.update(calls=0, bytes=0)
            y, aux = moe_ep.forward_ep(pp, cfg, xx, mesh, capacity_factor=cf)
            rec = {"out": y.full_tensor().detach().numpy(),
                   "aux": float(aux.full_tensor()),
                   "a2a_calls": moe_ep.A2A["calls"]}
            if cf == 8.0:
                ((y * common.replicate_like(w, y)).sum() + aux).backward()
                rp = tree_map(lambda t: t.clone().requires_grad_(True), p)
                rx = x.clone().requires_grad_(True)
                ry, raux = moe.forward(rp, cfg, rx, capacity_factor=cf)
                ((ry * w).sum() + raux).backward()
                rec["grad_err"] = {k: float((pp[k].grad - rp[k].grad
                                             ).abs().max()) for k in p}
                rec["grad_err"]["x"] = float((xx.grad - rx.grad).abs().max())
                with torch.no_grad(), common.mesh_context(mesh), \
                        common.ep_moe():
                    dy, daux = moe.forward(p, cfg, x, capacity_factor=cf)
                rec["delegated"] = float((dy.full_tensor() - y.detach(
                ).full_tensor()).abs().max())
            out[arch, cf] = rec
    return out


def _sharded_kernels(mesh):
    """Each kernel op on DTensors split over batch ("data") and heads or
    rows ("model" / "data"), or over the vocab, against the same op on the
    whole tensors: whether it went through ``local_map`` and whether its
    operands were first gathered (``_laid_out`` redistributed one), and
    the max abs differences of outputs and gradients."""
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(5)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    local_maps, gathers = [], []
    inner, inner_laid_out = ops._local_map, ops._laid_out

    def counted(*a, **kw):
        local_maps.append(1)
        return inner(*a, **kw)

    def laid_out(args, want):
        gathers.append(not ops._is_laid_out(args, want))
        return inner_laid_out(args, want)

    def run(op, args, pls):
        """op on whole tensors and on DTensors: (output error, gradient
        error, whether the DTensor run went through ``local_map``, whether
        it gathered an operand first)."""
        whole = [a.clone().requires_grad_(a.is_floating_point())
                 for a in args]
        dist_ = [distribute_tensor(a, mesh, pl).requires_grad_(
            a.is_floating_point()) for a, pl in zip(args, pls)]
        ow = op(*whole)
        local_maps.clear()
        gathers.clear()
        ops._local_map, ops._laid_out = counted, laid_out
        try:
            od = op(*dist_)
        finally:
            ops._local_map, ops._laid_out = inner, inner_laid_out
        local, gathered = bool(local_maps), any(gathers)
        ow = ow if isinstance(ow, tuple) else (ow,)
        od = od if isinstance(od, tuple) else (od,)
        sum(o.float().sum() * (i + 1) for i, o in enumerate(ow)
            if o.is_floating_point()).backward()
        sum(o.float().sum() * (i + 1) for i, o in enumerate(od)
            if o.is_floating_point()).backward()
        err = max(float((b.full_tensor() - a).abs().max())
                  for a, b in zip(ow, od))
        gerr = max(float((b.grad.full_tensor() - a.grad).abs().max())
                   for a, b in zip(whole, dist_) if a.requires_grad)
        return err, gerr, local, gathered

    bh = [Shard(0), Shard(2)]       # batch on data, heads on model
    res = {}
    q, k, v = rnd(4, 8, 4, 16), rnd(4, 8, 2, 16), rnd(4, 8, 2, 16)
    res["attention"] = run(ops.attention, (q, k, v), (bh,) * 3)
    # kv heads left whole: each rank slices the kv heads its q heads read
    res["attention_kv_whole"] = run(ops.attention, (q, k, v),
                                    (bh, [Shard(0), Replicate()],
                                     [Shard(0), Replicate()]))
    # the sequence split (no local form): gathered over "model" first
    seq = [Shard(0), Shard(1)]
    res["attention_seq_split"] = run(ops.attention, (q, k, v), (seq,) * 3)
    # CE: rows over both mesh axes, the head whole; then rows over "data"
    # and the head split over the vocab on "model", as
    # ``launch.sharding`` lays out an untied head (fsdp off / on: its D
    # also over "data", gathered first) and a tied one (the transpose of
    # a (V, D) table split ("model", "data"))
    h, w = rnd(4, 8, 32), rnd(32, 64, scale=0.2)
    lbl = torch.randint(0, 64, (4, 8), generator=g)
    lbl[0, :3] = -100
    lbl[1, 0] = 63
    rows = [Shard(0), Shard(0)]
    res["cross_entropy"] = run(ops.cross_entropy, (h, w, lbl),
                               (rows, [Replicate()] * 2, rows))
    data_rows = [Shard(0), Replicate()]
    res["cross_entropy_vocab_split"] = run(
        ops.cross_entropy, (h, w, lbl),
        (data_rows, [Replicate(), Shard(1)], data_rows))
    res["cross_entropy_vocab_split_fsdp"] = run(
        ops.cross_entropy, (h, w, lbl),
        (data_rows, [Shard(0), Shard(1)], data_rows))

    def tied(hh, table, ll):
        return ops.cross_entropy(hh, table.T, ll)
    res["cross_entropy_vocab_split_tied"] = run(
        tied, (h, w.T.contiguous(), lbl),
        (data_rows, [Shard(1), Shard(0)], data_rows))
    H = 4
    x, dt = rnd(4, 8, H, 8), torch.rand(4, 8, H, generator=g) * 0.5 + 0.1
    A, Bm, Cm = -torch.rand(H, generator=g) - 0.5, rnd(4, 8, 16), \
        rnd(4, 8, 16)
    Dp = rnd(H)
    head0 = [Replicate(), Shard(0)]
    batch0 = [Shard(0), Replicate()]
    res["mamba2"] = run(ops.mamba2, (x, dt, A, Bm, Cm, Dp),
                        (bh, bh, head0, batch0, batch0, head0))
    # the sequence split: gathered over "model" first
    res["mamba2_seq_split"] = run(ops.mamba2, (x, dt, A, Bm, Cm, Dp),
                                  (seq, seq, head0, batch0, batch0, head0))
    r, kk, vv = rnd(4, 8, H, 8), rnd(4, 8, H, 8), rnd(4, 8, H, 8)
    wd, u = rnd(4, 8, H, 8, scale=0.5), rnd(H, 8)
    res["rwkv6"] = run(ops.rwkv6, (r, kk, vv, wd, u), (bh,) * 4 + (head0,))
    return res


def sharded_suite(rank: int, world: int, params_ref, batch_np, lr,
                  moe_inputs):
    """Every sharded check of ``tests/test_torch_dist.py`` on a ("data",
    "model") mesh of (2, 2): the train steps (also with remat off),
    ``forward_ep`` and the kernel ops' sharded route."""
    assert world == 4, world
    mesh = _mesh22()
    return {"steps": _train_steps(mesh, params_ref, batch_np, lr),
            "remat": _remat_steps(mesh, params_ref, batch_np, lr),
            "forward_ep": _forward_ep(mesh, moe_inputs),
            "kernels": _sharded_kernels(mesh)}

