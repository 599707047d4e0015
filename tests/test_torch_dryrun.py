"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``repro_torch.roofline``) against the reference's.

* ``default_accum``, ``depth_units`` and ``depth_scaled`` for every arch
  and shape, equal to the reference's.  The reference's are read in a
  subprocess: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` at import.
* ``Roofline`` (fields, properties, ``to_dict`` keys) and
  ``model_flops_for``.
* Per-device counting on fake worlds: replicated work counts whole,
  work split over every rank counts its share; a reduced yi-6b step on a
  fake world of 4; ``costing_extrapolate`` equal to a direct count at
  depth 3; the CLI's JSON.  Each test's fake process group is destroyed
  when it ends."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.roofline import analysis as j_analysis  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.base import SHAPE_BY_NAME, InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.roofline import analysis, hw  # noqa: E402
from torch_helpers import abstract_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

_REF = r"""
import json
from types import SimpleNamespace
from repro.configs import ARCH_IDS, get_config
from repro.configs.base import SHAPES
from repro.launch import dryrun
meshes = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    rec = {"units": dryrun.depth_units(cfg),
           "scaled": [[dryrun.depth_scaled(cfg, n).num_layers,
                       dryrun.depth_scaled(cfg, n).encoder_layers]
                      for n in (1, 2, 3)],
           "accum": {}}
    for name, (shape, axes) in meshes.items():
        mesh = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
        for s in SHAPES:
            rec["accum"][f"{name}/{s.name}"] = dryrun.default_accum(cfg, s,
                                                                   mesh)
    out[arch] = rec
out["devices"] = [dryrun.mesh_devices(False), dryrun.mesh_devices(True)]
out["micro"] = dryrun.MICRO_TOKENS
print("REF" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_dryrun():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _REF], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("REF"))
    return json.loads(line[3:])


@pytest.fixture
def no_group():
    """The test starts and ends without a process group."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a process group outlived its test")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_depth_and_accum_match_reference(ref_dryrun, arch):
    cfg, ref = get_config(arch), ref_dryrun[arch]
    assert dryrun.depth_units(cfg) == ref["units"]
    assert [[dryrun.depth_scaled(cfg, n).num_layers,
             dryrun.depth_scaled(cfg, n).encoder_layers]
            for n in (1, 2, 3)] == ref["scaled"]
    for name, (shape, axes) in MESHES.items():
        for s in J_SHAPES:
            assert dryrun.default_accum(
                cfg, SHAPE_BY_NAME[s.name], abstract_mesh(shape, axes)) == \
                ref["accum"][f"{name}/{s.name}"], (name, s.name)
    assert [dryrun.mesh_devices(False), dryrun.mesh_devices(True)] == \
        ref_dryrun["devices"]
    assert dryrun.MICRO_TOKENS == ref_dryrun["micro"]


def test_roofline_matches_reference():
    """Same fields and ``to_dict`` keys; the same ratio and the terms at
    the H100's constants."""
    f = [x.name for x in dataclasses.fields(analysis.Roofline)]
    assert f == [x.name for x in dataclasses.fields(j_analysis.Roofline)]
    args = dict(arch="yi-6b", shape="train_4k", mesh="16x16", chips=256,
                flops_per_device=3.1e14, bytes_per_device=2.2e12,
                collective_bytes_per_device=4.5e10,
                collectives_by_kind={"all-gather": 4.5e10},
                model_flops=6.0e16)
    ours, ref = analysis.Roofline(**args), j_analysis.Roofline(**args)
    assert ours.to_dict().keys() == ref.to_dict().keys()
    assert ours.useful_flops_ratio == ref.useful_flops_ratio
    assert ours.t_compute == 3.1e14 / hw.PEAK_FLOPS_BF16
    assert ours.t_memory == 2.2e12 / hw.HBM_BW
    assert ours.t_collective == 4.5e10 / hw.NVLINK_BW
    assert ours.bottleneck == max(
        ("compute", "memory", "collective"),
        key=lambda k: getattr(ours, f"t_{k}"))
    assert (hw.PEAK_FLOPS_FP32, hw.PEAK_FLOPS_TF32, hw.HBM_BW) == \
        (67e12, 495e12, 3.35e12)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    for s in J_SHAPES:
        assert analysis.model_flops_for(cfg, SHAPE_BY_NAME[s.name]) == \
            j_analysis.model_flops_for(jcfg, s), s.name


@pytest.mark.parametrize("world,shape", [(4, (2, 2)), (256, (16, 16))])
def test_counts_are_per_device(no_group, world, shape):
    """A (256, 512) @ (512, 1024) product: replicated, each device runs it
    whole; split on rows over one mesh dim and columns over the other,
    each device runs 1/world of it (``FlopCounterMode`` at the DTensor
    level would count the whole product both times).  The split's
    gather back is an all-gather of the product's bytes."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    whole = 2.0 * 256 * 512 * 1024
    with dryrun.fake_world(world):
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data",
                                                              "model"))
        a, b = (torch.empty(256, 512, device="meta"),
                torch.empty(512, 1024, device="meta"))
        rep = [Replicate(), Replicate()]
        counts = analysis.DeviceCounts()
        da, db = (distribute_tensor(a, mesh, rep),
                  distribute_tensor(b, mesh, rep))
        with counts:
            da @ db
        assert counts.flops == whole and counts.collectives == {}
        counts = analysis.DeviceCounts()
        da = distribute_tensor(a, mesh, [Shard(0), Replicate()])
        db = distribute_tensor(b, mesh, [Replicate(), Shard(1)])
        with counts:
            c = da @ db
        assert counts.flops == whole / world
        assert counts.bytes == 4 * (256 * 512 / shape[0] + 512 * 1024
                                    / shape[1] + 256 * 1024 / world)
        assert counts.collectives == {}
        counts = analysis.DeviceCounts()
        with counts:
            c.redistribute(mesh, rep)
        assert counts.flops == 0
        assert set(counts.collectives) == {"all-gather"}
    assert not dist.is_initialized()


def test_device_counts_host_ops():
    """A plain CPU product under ``DeviceCounts`` counts its FLOPs and
    bytes; with ``host_ops=False`` (the dry run's mode, its device
    tensors on ``meta``) it is skipped as host bookkeeping."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    counts = analysis.DeviceCounts()
    with counts:
        a @ b
    assert counts.flops == 2.0 * 8 * 16 * 4
    assert counts.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    skipped = analysis.DeviceCounts(host_ops=False)
    with skipped:
        a @ b
    assert skipped.flops == 0 and skipped.bytes == 0


def _mesh22():
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))


def test_step_count_and_costing_extrapolate(no_group):
    """The reduced yi-6b train step on a fake world of 4: FLOPs near the
    model's 6 N tokens over the ranks, collectives counted by kind;
    ``costing_extrapolate`` from depth 1 and 2 equals the direct count at
    depth 3, term for term; prefill and decode count too."""
    cfg = dryrun.depth_scaled(get_reduced_config("yi-6b"), 3)
    shape = InputShape("t", 32, 8, "train")
    with dryrun.fake_world(4):
        mesh = _mesh22()
        direct = dryrun._count_step(cfg, shape, mesh)
        cost = dryrun.costing_extrapolate(cfg, shape, mesh)
        assert cost["flops"] == direct["flops"]
        assert cost["bytes"] == direct["bytes"]
        assert cost["collectives"] == direct["collectives"]
        # 4 ranks' share of 6 N tokens (N counts the embedding, which
        # multiplies nothing; attention is not in N)
        ratio = 4 * direct["flops"] / analysis.model_flops_for(cfg, shape)
        assert 0.5 < ratio < 2.0, ratio
        assert {"all-gather", "all-reduce"} <= set(direct["collectives"])
        assert sum(direct["collective_calls"].values()) > 0
        for mode in ("prefill", "decode"):
            c = dryrun._count_step(cfg, InputShape(mode, 32, 8, mode), mesh)
            assert c["flops"] > 0 and c["bytes"] > 0, mode
    assert not dist.is_initialized()


def test_costing_extrapolate_at_accumulation(no_group):
    """With 2 microbatches the costing counts each cell at the step's
    accumulation and equals the direct count at depth 3, term for term."""
    cfg = dryrun.depth_scaled(get_reduced_config("yi-6b"), 3)
    shape = InputShape("t", 32, 8, "train")
    with dryrun.fake_world(4):
        mesh = _mesh22()
        direct = dryrun._count_step(cfg, shape, mesh, accum_steps=2)
        cost = dryrun.costing_extrapolate(cfg, shape, mesh, accum_steps=2)
        for k in ("flops", "bytes", "collectives"):
            assert cost[k] == direct[k], k
    assert not dist.is_initialized()


def test_device_flops_do_not_depend_on_the_microbatch(no_group):
    """Published yi-6b, one unit, train_4k on the 16 x 16 fake world: the
    per-device FLOPs of the step at 1 and at 8 microbatches are equal, and
    0.7 to 1 of the model's 6 N tokens over the ranks (N counts the
    embedding, which multiplies nothing; attention is not in N, and the
    CE's backward recomputes the head's logits).
    Left to DTensor's op-by-op choice, the residual stream stays a
    pending sum over "model" and a product then gathers its weight and
    runs whole on every rank: the MLP at one microbatch, the head's
    gradient at eight."""
    cfg = dryrun.depth_scaled(get_config("yi-6b"), 1)
    shape = SHAPE_BY_NAME["train_4k"]
    with dryrun.fake_world(256):
        mesh = make_production_mesh()
        flops = [dryrun._count_step(cfg, shape, mesh, accum_steps=a)["flops"]
                 for a in (1, 8)]
    assert flops[0] == flops[1], flops
    ratio = 256 * flops[0] / analysis.model_flops_for(cfg, shape)
    assert 0.7 < ratio < 1.0, ratio
    assert not dist.is_initialized()


def _step_counts(cfg, mode, mesh, **kw):
    c = dryrun._count_step(cfg, InputShape(mode, 32, 8, mode), mesh, **kw)
    return {k: c[k] for k in ("flops", "bytes", "collectives")}


@pytest.mark.parametrize("moe_ep", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b", "qwen2-vl-2b"])
def test_moe_and_vlm_archs_count(no_group, arch, moe_ep):
    """ROADMAP fault 20: the reduced MoE and VLM archs count a train, a
    prefill and a decode step (8 x 32) on a fake world of 4, mesh (2, 2),
    with and without expert parallelism (``forward_ep``'s queues sized
    from the shapes on ``meta``); the yi-6b train count beside them does
    not move."""
    cfg = get_reduced_config(arch)
    with dryrun.fake_world(4):
        mesh = _mesh22()
        yi = _step_counts(get_reduced_config("yi-6b"), "train", mesh)
        for mode in ("train", "prefill", "decode"):
            c = _step_counts(cfg, mode, mesh, moe_ep=moe_ep)
            assert c["flops"] > 0 and c["bytes"] > 0, mode
        assert _step_counts(get_reduced_config("yi-6b"), "train",
                            mesh) == yi
    assert not dist.is_initialized()


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["whisper-small", "rwkv6-7b"])
def test_uneven_splits_count(no_group, arch, mode):
    """A split the "model" axis does not divide is gathered before its
    unflatten (DTensor has no rule for an uneven one): reduced
    whisper-small's 4 cross-attention heads and rwkv6-7b's 5 token-mix
    LoRAs over a "model" axis of 8 (fake world of 8, mesh (1, 8)), as
    the published configs' 12 heads and 5 mixes over the production
    mesh's 16 (both failed ``--all``)."""
    from torch.distributed.device_mesh import init_device_mesh
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cuda", (1, 8),
                                mesh_dim_names=("data", "model"))
        c = _step_counts(get_reduced_config(arch), mode, mesh)
        assert c["flops"] > 0 and c["bytes"] > 0
    assert not dist.is_initialized()


_FIRST = r"""
import json
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from torch.distributed.device_mesh import init_device_mesh
out = []
with dryrun.fake_world(4):
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    for arch in ("yi-6b", "qwen2-7b", "h2o-danube-3-4b", "yi-6b"):
        cfg = get_reduced_config(arch)
        for mode in ("prefill", "decode"):
            c = dryrun._count_step(cfg, InputShape(mode, 32, 8, mode), mesh)
            out.append([arch, mode, c["flops"], c["bytes"],
                        c["collectives"]])
print("COUNTS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def serving_counts():
    """Prefill and decode counts of reduced yi-6b, qwen2-7b, danube and
    yi-6b again in a fresh process: its first counts are the first
    DTensor propagates."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _FIRST], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("COUNTS"))
    return json.loads(line[6:])


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_serving_counts_do_not_depend_on_order(serving_counts, mode):
    """ROADMAP fault 21: a serving count taken first in a process equals
    the same count taken after two other archs' (FLOPs, bytes and
    collectives), and reads FLOPs."""
    rows = [r for r in serving_counts if r[1] == mode]
    first, last = rows[0], rows[-1]
    assert first[0] == last[0] == "yi-6b"
    assert first[2:] == last[2:]
    assert all(r[2] > 0 for r in rows), rows


_REF_REMAT = r"""
import json
import numpy as np
from repro.launch import dryrun
import jax
from repro.configs import get_reduced_config
from repro.configs.base import InputShape
cfg = dryrun.depth_scaled(get_reduced_config("yi-6b"), 3)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
out = [dryrun._lower_costing(cfg, InputShape("t", 32, 8, "train"), mesh,
                             no_remat=nr)[0] for nr in (False, True)]
print("REMAT" + json.dumps(out))
"""


def test_remat_flops_ratio_matches_reference(no_group):
    """The reduced yi-6b train step at depth 3 (8 x 32, mesh (2, 2)):
    the port's remat / no-remat FLOPs ratio within 5 % of the
    reference's compiled costing's (its ``_lower_costing``, a
    subprocess: the module sets ``XLA_FLAGS`` at import); the costing
    from depth 1 and 2 equals the direct count in both modes."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", _REF_REMAT], env=env,
                           cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    cfg = dryrun.depth_scaled(get_reduced_config("yi-6b"), 3)
    shape = InputShape("t", 32, 8, "train")
    flops = {}
    with dryrun.fake_world(4):
        mesh = _mesh22()
        for nr in (False, True):
            direct = dryrun._count_step(cfg, shape, mesh, no_remat=nr)
            cost = dryrun.costing_extrapolate(cfg, shape, mesh, no_remat=nr)
            for k in ("flops", "bytes", "collectives"):
                assert cost[k] == direct[k], (nr, k)
            flops[nr] = direct["flops"]
    assert not dist.is_initialized()
    so, se = ref.communicate(timeout=300)
    assert ref.returncode == 0, se[-3000:]
    j_on, j_off = json.loads(next(ln for ln in so.splitlines()
                                  if ln.startswith("REMAT"))[5:])
    ours, theirs = flops[False] / flops[True], j_on / j_off
    assert ours > 1.1, ours          # the recompute is counted
    assert abs(ours / theirs - 1) < 0.05, (ours, theirs)


def test_cli_writes_roofline(no_group, tmp_path, monkeypatch):
    """``main`` on yi-6b x train_4k with the reduced widths (the CLI's
    published yi-6b runs on the card, ``chip_smoke.py`` phase 12): one
    ``ok`` combination with every roofline key, the costed terms, and
    with ``--full-count`` the whole step's count beside them (one
    microbatch: the default accumulation of 8 takes ~20 s here)."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_reduced_config(arch))
    out = tmp_path / "d.json"
    assert dryrun.main(["--arch", "yi-6b", "--shape", "train_4k",
                        "--no-remat", "--accum", "1", "--full-count",
                        "--out", str(out)]) == 0
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["accum_steps"] == 1
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
              "useful_flops_ratio", "collectives_by_kind"):
        assert k in rec
    assert rec["flops_per_device"] > 0
    assert rec["flops_per_device"] == rec["direct"]["flops"]
    assert not dist.is_initialized()
