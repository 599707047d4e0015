"""Port ViT (paper Fig. 7) vs the reference (PyTorch port), on the CPU.

The reference's parameters (its blocks stacked on a layer axis, carried
across to the port's list of per-layer dicts by
``repro_torch.testing.convert``) and seeded numpy inputs go through
``repro.models.vit`` and ``repro_torch.models.vit``: logits, ``embed``,
``forward_blocks`` over every ``[lo, hi)``, ``head`` and the CE loss's
gradients agree within atol 1e-5, rtol 1e-4 at ``reduced()`` (4 layers,
d_model 64, 2 heads), the logits also at the full ``CONFIG`` (ViT-T/16).
The memory model is a pure Python copy and must agree exactly, with every
unit priced the same (fig7's check a).  Also here: the runner contract of
``tests/test_adapters.py`` and ``tests/test_prefix_cache.py`` for the
``vit`` family, the client update, a 2-round FeDepth engine run against
the reference engine (atol 1e-4, rtol 1e-3) and fig7's FedAvg x1/6 loop
against the reference's.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import vit_t16 as jcfgs  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import blockwise as jbw  # noqa: E402
from repro.core.decomposition import decompose as j_decompose  # noqa: E402
from repro.core.memory_model import vit_memory as j_vit_memory  # noqa: E402
from repro.fl.baselines import make_sgd_step  # noqa: E402
from repro.fl.data import build_federated as j_federated  # noqa: E402
from repro.fl.engine import RoundEngine as JEngine  # noqa: E402
from repro.fl.engine import SimConfig as JSim  # noqa: E402
from repro.fl.strategies.fedepth import FedepthStrategy as JFedepth  # noqa: E402
from repro.fl.strategy import Context as JContext  # noqa: E402
from repro.models import vit as jvit  # noqa: E402
from repro_torch.configs import vit_t16 as cfgs  # noqa: E402
from repro_torch.core import blockwise as tbw  # noqa: E402
from repro_torch.core.decomposition import Decomposition  # noqa: E402
from repro_torch.core.decomposition import decompose  # noqa: E402
from repro_torch.core.memory_model import model_memory, vit_memory  # noqa: E402
from repro_torch.fl.baselines import fedavg_local  # noqa: E402
from repro_torch.fl.data import build_federated  # noqa: E402
from repro_torch.fl.engine import RoundEngine, SimConfig  # noqa: E402
from repro_torch.fl.registry import get_strategy  # noqa: E402
from repro_torch.fl.strategies.fedepth import FedepthStrategy  # noqa: E402
from repro_torch.fl.strategy import Context  # noqa: E402
from repro_torch.models import vit  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

ATOL, RTOL = 1e-5, 1e-4
CONFIGS = {"full": (jcfgs.CONFIG, cfgs.CONFIG),
           "reduced": (jcfgs.reduced(), cfgs.reduced()),
           "reduced x1/6": (dataclasses.replace(jcfgs.reduced(),
                                                width_ratio=1 / 6),
                            dataclasses.replace(cfgs.reduced(),
                                                width_ratio=1 / 6))}


def _close(a, b, msg, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


def _batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cfg.image_size, cfg.image_size,
                         cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, n).astype(np.int32)
    return ({"images": x, "labels": y},
            {"images": torch.tensor(x),
             "labels": torch.tensor(y, dtype=torch.int64)})


@functools.lru_cache(maxsize=None)
def _j_init(name, seed=0):
    init = jax.jit(jvit.init, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed),
                                         CONFIGS[name][0]))


def _setup(name, seed=0):
    """The reference's parameters at ``name`` with non-trivial norm scales
    and biases (numpy, per ``seed``), and their port copy."""
    jcfg, cfg = CONFIGS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(seed + 10)
    jp = dict(_j_init(name))
    blocks = dict(jp["blocks"])
    for k in ("ln1", "ln2"):
        shape = blocks[k]["w"].shape
        blocks[k] = {"w": 1 + 0.1 * rng.normal(size=shape),
                     "b": 0.1 * rng.normal(size=shape)}
    for k in ("b1", "b2"):
        blocks[k] = 0.1 * rng.normal(size=blocks[k].shape)
    jp["blocks"] = blocks
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jcfg, cfg, jp, params_from_reference(jp, device="cpu")


def _jnp(tree):
    """Reference parameters as JAX arrays (its ViT merge writes with
    ``.at[lo:hi].set``)."""
    return jax.tree.map(jax.numpy.asarray, tree)


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    order = {id(t): next(it) for t in tree_leaves(tree)}
    return tree_map(lambda t: order[id(t)], tree)


# ------------------------------------------------------------ the model
def test_convert_round_trip_and_layout():
    """Stacked blocks -> a list of per-layer dicts and back is exact;
    converted tensors are copies."""
    jcfg, cfg, jp, tp = _setup("reduced")
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 4
    np.testing.assert_array_equal(tp["blocks"][2]["wqkv"].numpy(),
                                  jp["blocks"]["wqkv"][2])
    np.testing.assert_array_equal(tp["blocks"][1]["ln2"]["b"].numpy(),
                                  jp["blocks"]["ln2"]["b"][1])
    back = params_to_reference(tp)
    fa = jax.tree_util.tree_flatten_with_path(back)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert len(fa) == len(fb)
    for path, a in fa:
        assert a.shape == fb[path].shape and np.array_equal(a, fb[path])
    tp["blocks"][0]["w1"].add_(1.0)
    assert not np.array_equal(tp["blocks"][0]["w1"].numpy(),
                              jp["blocks"]["w1"][0])


def test_init_shapes_match_reference():
    for name, (jcfg, cfg) in CONFIGS.items():
        assert vit.dims(cfg) == jvit.dims(jcfg), name
        ref = params_to_reference(vit.init(0, cfg, device="cpu"))
        fa = jax.tree_util.tree_flatten_with_path(ref)[0]
        fb = dict(jax.tree_util.tree_flatten_with_path(_j_init(name))[0])
        assert len(fa) == len(fb), name
        for path, a in fa:
            assert a.shape == fb[path].shape, (name, path)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_reference(name):
    """Logits; at the reduced configs also ``patchify``, ``embed``,
    ``forward_blocks`` over every ``[lo, hi)`` and ``head``."""
    jcfg, cfg, jp, tp = _setup(name)
    jb, tb = _batch(cfg, 2, 3)
    with torch.no_grad():
        _close(vit.apply(tp, cfg, tb["images"]).numpy(),
               jvit.apply(jp, jcfg, jb["images"]), f"{name} logits")
        if name == "full":
            return
        _close(vit.patchify(cfg, tb["images"]).numpy(),
               jvit.patchify(jcfg, jb["images"]), "patchify", atol=0,
               rtol=0)
        z0, jz0 = vit.embed(tp, cfg, tb["images"]), jvit.embed(
            jp, jcfg, jb["images"])
        _close(z0.numpy(), jz0, f"{name} embed")
        n = cfg.num_layers
        for lo in range(n):
            for hi in range(lo + 1, n + 1):
                _close(vit.forward_blocks(tp, cfg, z0, lo, hi).numpy(),
                       jvit.forward_blocks(jp, jcfg, jz0, lo, hi),
                       f"{name} blocks [{lo}, {hi})")
        z = vit.forward_blocks(tp, cfg, z0, 0, n)
        _close(vit.head(tp, cfg, z).numpy(),
               jvit.head(jp, jcfg, np.asarray(z)), f"{name} head")


@pytest.mark.parametrize("name", ["reduced", "reduced x1/6"])
def test_loss_gradients_match_reference(name):
    """The CE loss of the logits and its gradient at every parameter."""
    jcfg, cfg, jp, tp = _setup(name, seed=1)
    jb, tb = _batch(cfg, 4, 7)

    def jloss(p):
        return jbw._ce_logits(jvit.apply(p, jcfg, jb["images"]),
                              jb["labels"])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tl = tbw._ce_logits(vit.apply(tp, cfg, tb["images"]), tb["labels"])
    grads = torch.autograd.grad(tl, leaves)
    _close(tl.item(), jl, f"{name} loss")
    gtree = params_to_reference(
        _unflatten_like(tp, [g.detach() for g in grads]))
    fa = jax.tree_util.tree_flatten_with_path(gtree)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jg))[0])
    assert len(fa) == len(fb)
    for path, g in fa:
        _close(g, fb[path], f"{name} grad {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("batch", [8, 32])
@pytest.mark.parametrize("name", ["full", "reduced"])
def test_vit_memory_matches_reference(name, batch):
    """Unit by unit equal to the reference (integers), and every unit
    costs the same (fig7's check a); full ViT-T/16 at batch 8 prices
    7 476 576 training bytes a unit; the decomposition of fig7's budget
    gives three blocks of L / 3."""
    jcfg, cfg = CONFIGS[name]
    jm, tm = j_vit_memory(jcfg, batch), vit_memory(cfg, batch)
    assert dataclasses.astuple(tm) == dataclasses.astuple(jm)
    assert model_memory(cfg, batch) == tm
    assert len({u.train_bytes() for u in tm.units}) == 1
    if name == "full" and batch == 8:
        assert tm.units[0].train_bytes() == 7_476_576
    budget = tm.block_train_bytes(0, cfg.num_layers // 3)
    third = cfg.num_layers // 3
    assert decompose(tm, budget).blocks == tuple(
        (i, i + third) for i in range(0, cfg.num_layers, third))
    assert dataclasses.astuple(decompose(tm, budget)) == \
        dataclasses.astuple(j_decompose(jm, budget))


# ------------------------------------------------------------ the runner
def test_runner_contract():
    """embed / apply_units / head_loss agree with the reference runner at
    every exit; ranges compose; merge(split) is the identity; merge
    replaces exactly [lo, hi) (and the trained head / embed keys),
    shares every other tensor and never writes its input; the prefix is
    stable (a head-only change leaves ``embed`` alone)."""
    jcfg, cfg, jp, tp = _setup("reduced", seed=1)
    jb, tb = _batch(cfg, 4, 5)
    jr, tr = jbw.vit_runner(jcfg), tbw.vit_runner(cfg)
    assert (tr.n_units, tr.prefix_stable) == (jr.n_units, jr.prefix_stable)
    assert tr.family == jr.family == "vit"
    n = tr.n_units
    z0, jz0 = tr.embed(tp, tb), jr.embed(jp, jb)
    z, jz = z0, jz0
    with torch.no_grad():
        for i in range(n):
            z = tr.apply_units(tp, z, i, i + 1)
            jz = jr.apply_units(jp, jz, i, i + 1)
            _close(tr.head_loss(tp, z, tb, i).item(),
                   jr.head_loss(jp, jz, jb, i), f"head_loss {i}")
        for k in range(n + 1):
            split_z = tr.apply_units(tp, tr.apply_units(tp, z0, 0, k), k, n)
            _close(split_z.numpy(), z.numpy(), f"compose at {k}", atol=1e-6,
                   rtol=0)
    before = {k: (list(v) if k == "blocks" else v) for k, v in tp.items()}
    for lo, hi in ((0, 1), (1, n), (0, n), (1, 2)):
        tsplit, jsplit = tr.split(tp, lo, hi), jr.split(jp, lo, hi)
        assert set(tsplit) == set(jsplit), (lo, hi)
        assert [id(b) for b in tsplit["blocks"]] == \
            [id(b) for b in tp["blocks"][lo:hi]]
        same = tr.merge(tp, tsplit, lo=lo, hi=hi)
        assert all(a is b for a, b in zip(tree_leaves(same),
                                          tree_leaves(tp)))
        fresh = tree_map(lambda t: t.clone() + 1.0, tsplit)
        merged = tr.merge(tp, fresh, lo=lo, hi=hi)
        for i, bp in enumerate(merged["blocks"]):
            assert (bp is tp["blocks"][i]) == (not lo <= i < hi), (lo, hi, i)
        for k in tp:
            if k != "blocks":
                assert (merged[k] is tp[k]) == (k not in fresh), k
        if lo > 0:      # the prefix units and the embed see none of it
            with torch.no_grad():
                _close(tr.apply_units(merged, tr.embed(merged, tb), 0,
                                      lo).numpy(),
                       tr.apply_units(tp, z0, 0, lo).numpy(),
                       f"prefix leak [{lo}, {hi})", atol=0, rtol=0)
    assert all(a is b for a, b in zip(tp["blocks"], before["blocks"]))
    assert all(tp[k] is before[k] for k in tp if k != "blocks")


DECOMPS = {
    "partial_advance": ((1, 2), (2, 4)),     # skipped prefix, then advance
    "from_embed": ((0, 1), (1, 3), (3, 4)),  # block at 0 holds the embed
}


@pytest.mark.parametrize("dec", sorted(DECOMPS))
def test_client_update_matches_reference(dec):
    """A multi-block update (prefix cache on) equals the reference's;
    cached equals recompute; the given tree is never written; the
    patch embedding never trains (z_in is detached, as in the
    reference)."""
    jcfg, cfg, jp, tp = _setup("reduced", seed=2)
    batches = [_batch(cfg, 4, 10 + i) for i in range(2)]
    blocks = DECOMPS[dec]
    kw = dict(lr=0.05, momentum=0.9, local_steps=2)
    jout = jbw.client_update(jbw.vit_runner(jcfg), _jnp(jp),
                             Decomposition(blocks, 0, 0),
                             [b[0] for b in batches], **kw)
    snapshot = [t.clone() for t in tree_leaves(tp)]
    tr = tbw.vit_runner(cfg)
    outs = {pc: tbw.client_update(tr, tp, Decomposition(blocks, 0, 0),
                                  [b[1] for b in batches],
                                  prefix_cache=pc, **kw)
            for pc in (True, False)}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), snapshot))
    assert_trees_close(params_to_reference(outs[True]),
                       jax.tree.map(np.asarray, jout), dec, atol=ATOL,
                       rtol=RTOL)
    for a, b in zip(tree_leaves(outs[True]), tree_leaves(outs[False])):
        _close(a.numpy(), b.numpy(), "cached vs recompute", atol=1e-6,
               rtol=1e-5)
    for k in ("patch_embed", "cls", "pos"):
        assert torch.equal(outs[True][k], tp[k]), k


def test_buffered_bytes_match_memory_model():
    """The cache's held bytes == ``ModelMemory.buffered_z_bytes`` at the
    runtime batch size, at every prefix depth and after an update."""
    _, cfg, _, tp = _setup("reduced", seed=4)
    batches = [_batch(cfg, 2, 20 + i)[1] for i in range(3)]
    runner = tbw.vit_runner(cfg)
    mem = vit_memory(cfg, 2)
    cache = tbw.PrefixCache(runner)
    for lo in range(runner.n_units):
        cache.zs = None
        cache.prepare(tp, batches, lo)
        assert cache.buffered_bytes() == mem.buffered_z_bytes(
            lo, n_batches=len(batches)), lo
    dec = Decomposition(((0, 1), (1, 2), (2, 4)), 0, 0)
    tbw.client_update(runner, tp, dec, batches, lr=0.05, prefix_cache=cache)
    assert cache.buffered_bytes() == mem.buffered_z_bytes(
        2, n_batches=len(batches))


# ------------------------------------------------------------ the engine
DATA = dict(num_clients=8, alpha=1.0, n_train=320, n_test=80, image_size=16,
            seed=3)


@pytest.fixture(scope="module")
def datasets():
    return j_federated(**DATA), build_federated(**DATA, device="cpu")


def _contexts(jdata, tdata, sim_kw, jcfg, cfg, mem_batch, budgets):
    """Reference and port contexts of a generic FeDepth run: per-client
    decompositions of ``budgets`` on the ViT memory model."""
    jmem, mem = j_vit_memory(jcfg, mem_batch), vit_memory(cfg, mem_batch)
    jctx = JContext(sim=JSim(**sim_kw), num_clients=DATA["num_clients"],
                    sizes=jdata.client_sizes(),
                    rng=np.random.default_rng(sim_kw["seed"]),
                    key=jax.random.PRNGKey(0), mem=jmem,
                    decomps=[j_decompose(jmem, b) for b in budgets],
                    data=jdata)
    ctx = Context(sim=SimConfig(**sim_kw), num_clients=DATA["num_clients"],
                  sizes=tdata.client_sizes(),
                  rng=np.random.default_rng(sim_kw["seed"]), seed=0,
                  device=torch.device("cpu"), model_cfg=cfg, mem=mem,
                  decomps=[decompose(mem, b) for b in budgets], data=tdata)
    return jctx, ctx


def _j_accuracy(jcfg, data):
    def acc(params):
        logits = np.asarray(jvit.apply(params, jcfg, data.x_test))
        return float((logits.argmax(-1) == np.asarray(data.y_test)).mean())
    return acc


def test_fedepth_two_rounds_match_reference_engine(datasets):
    """``RoundEngine(FedepthStrategy(runner=vit_runner(cfg)))`` against the
    reference engine from the reference's initial parameters: clients
    with one, two and three blocks and a skipped prefix, the same cohorts
    and batches, server parameters every round within atol 1e-4, rtol
    1e-3, the same bytes, accuracies within one test image (the port's
    eval through ``FedepthStrategy.eval_model`` on the ViT config)."""
    jdata, tdata = datasets
    jcfg, cfg = jcfgs.reduced(), cfgs.reduced()
    sim_kw = dict(rounds=2, participation=0.5, lr=0.05, momentum=0.9,
                  local_steps=2, batch_size=16, seed=0)
    mem = vit_memory(cfg, 16)
    # every unit costs the same, but unit 0 also trains the embedding: a
    # budget between the two skips the first unit
    u0, u1 = mem.block_train_bytes(0, 1), mem.block_train_bytes(1, 2)
    assert u1 < u0
    budgets = [mem.block_train_bytes(0, 4), mem.block_train_bytes(0, 2),
               u0, (u0 + u1) // 2] * 2
    jctx, ctx = _contexts(jdata, tdata, sim_kw, jcfg, cfg, 16, budgets)
    assert {d.blocks for d in ctx.decomps} == \
        {d.blocks for d in jctx.decomps}
    assert any(d.skipped_prefix for d in ctx.decomps)
    init = _setup("reduced", seed=5)[2]
    states = {}
    for side, engine, state0, host, kw in (
            ("jax", JEngine(JFedepth(runner=jbw.vit_runner(jcfg)), jctx),
             _jnp(init), lambda s: jax.tree.map(np.asarray, s),
             dict(eval_fn=_j_accuracy(jcfg, jdata))),
            ("torch", RoundEngine(FedepthStrategy(runner=tbw.vit_runner(cfg)),
                                  ctx),
             params_from_reference(init, device="cpu"), params_to_reference,
             {})):
        log = []
        aggregate = engine.strategy.aggregate

        def recording(c, state, results, aggregate=aggregate, log=log,
                      host=host):
            new = aggregate(c, state, results)
            log.append(host(new))
            return new

        engine.strategy.aggregate = recording
        sample = engine.sampler.sample
        cohorts = []

        def recording_sample(c, rd, sample=sample, cohorts=cohorts):
            ids = sample(c, rd)
            cohorts.extend(int(k) for k in ids)
            return ids

        engine.sampler.sample = recording_sample
        _, history = engine.run(initial_state=state0, eval_every=1, **kw)
        states[side] = (log, history, cohorts)
    (js, jh, jc), (ts, th, tc) = states["jax"], states["torch"]
    assert tc == jc
    assert any(ctx.decomps[k].skipped_prefix for k in tc)
    assert any(len(ctx.decomps[k].blocks) >= 3 for k in tc)
    assert len(ts) == len(js) == 2
    for rd, (a, b) in enumerate(zip(ts, js)):
        assert_trees_close(a, b, f"vit fedepth round {rd + 1}")
    assert [r.comm_bytes for r in th] == [r.comm_bytes for r in jh]
    assert [r.down_bytes for r in th] == [r.down_bytes for r in jh]
    for r1, r2 in zip(th, jh):
        assert abs(r1.accuracy - r2.accuracy) <= 1.0 / DATA["n_test"]


def test_fig7_fedavg_sixth_matches_reference_loop(datasets):
    """Fig. 7's FedAvg x1/6 baseline: the port's ``RoundEngine`` over
    ``FedAvgStrategy`` on a ViT config (fair scenario: x1/6; one batch of
    64 a client, as fig7 draws it) against fig7's own loop in the
    reference — ``rng.choice`` cohorts of 4, ``make_sgd_step``, 2 local
    steps, FedAvg — from the same x1/6 parameters, 2 rounds."""
    jdata, tdata = datasets
    jcfg, cfg = CONFIGS["reduced x1/6"]
    base = cfgs.reduced()
    rounds, lr, momentum = 2, 0.05, 0.9
    jp = _setup("reduced x1/6", seed=6)[2]

    def loss6(p, b):
        return jbw._ce_logits(jvit.apply(p, jcfg, b["images"]), b["labels"])

    step6 = make_sgd_step(loss6, lr, momentum)
    rng = np.random.default_rng(3)
    p6 = jp
    for _ in range(rounds):
        locals_ = []
        for k in rng.choice(8, size=4, replace=False):
            b = jdata.client_batch(k, 64, rng)
            lp, vel = p6, jax.tree.map(np.zeros_like, p6)
            for _ in range(2):
                lp, vel = step6(lp, vel, b)
            locals_.append(lp)
        p6 = jagg.fedavg(locals_, [1.0] * len(locals_))

    sim = SimConfig(rounds=rounds, participation=0.5, lr=lr,
                    momentum=momentum, local_steps=2, batch_size=64,
                    scenario="fair", seed=3)
    ctx = Context(sim=sim, num_clients=8, sizes=tdata.client_sizes(),
                  rng=np.random.default_rng(3), seed=0,
                  device=torch.device("cpu"), model_cfg=base, data=tdata)
    engine = RoundEngine(get_strategy("fedavg"), ctx)
    state, _ = engine.run(
        initial_state=params_from_reference(jp, device="cpu"),
        batch_fn=lambda k: [tdata.client_batch(k, 64, ctx.rng)],
        eval_every=rounds)
    assert vit.dims(engine.strategy.sub_cfg) == vit.dims(cfg) == (10, 21)
    assert_trees_close(params_to_reference(state),
                       jax.tree.map(np.asarray, p6), "fig7 x1/6",
                       atol=ATOL, rtol=RTOL)
    # one client's local loop alone, the port's ``fedavg_local``
    b = _batch(cfg, 8, 4)
    lp, vel = jp, jax.tree.map(np.zeros_like, jp)
    for _ in range(2):
        lp, vel = step6(lp, vel, b[0])
    out = fedavg_local(cfg, params_from_reference(jp, device="cpu"), [b[1]],
                       lr=lr, momentum=momentum, local_steps=2)
    assert_trees_close(params_to_reference(out),
                       jax.tree.map(np.asarray, lp), "fedavg_local",
                       atol=ATOL, rtol=RTOL)
