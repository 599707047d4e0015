"""Port PreResNet-20 path vs the reference (PyTorch port), on the CPU.

The reference's parameters (HWIO conv weights, carried across to OIHW by
``repro_torch.testing.convert``) and seeded numpy inputs go through
``repro.models.resnet`` and ``repro_torch.models.resnet``: logits,
``forward_blocks`` over every ``[lo, hi)``, ``head_from_block`` at every
block and the CE loss's gradients agree within atol 1e-5, rtol 1e-4
(fp32, different summation order) at the full config, ``reduced()`` and
``scaled(1/6)`` (widths 3 / 5 / 11: the stride-2 SAME padding and the
group-norm fall-back to 3, 5 and 1 groups).  The memory model is a pure
Python copy and must agree exactly.  Also here: the runner contract of
``tests/test_adapters.py``, the client update and the prefix cache
against the reference, masked aggregation, MKD and the data module.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import preresnet20 as jcfgs  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import blockwise as jbw  # noqa: E402
from repro.core import mkd as jmkd  # noqa: E402
from repro.core.decomposition import Decomposition  # noqa: E402
from repro.core.decomposition import decompose as j_decompose  # noqa: E402
from repro.core.memory_model import resnet_memory as j_resnet_memory  # noqa: E402
from repro.fl import data as jdata  # noqa: E402
from repro.fl.engine import client_ratios as j_ratios  # noqa: E402
from repro.fl.engine import scenario_budgets as j_budgets  # noqa: E402
from repro.fl.strategies.fedepth import init_aux_heads as j_aux  # noqa: E402
from repro.models import resnet as jresnet  # noqa: E402
from repro_torch.configs import preresnet20 as cfgs  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import blockwise as tbw  # noqa: E402
from repro_torch.core import mkd  # noqa: E402
from repro_torch.core.decomposition import Decomposition as TDec  # noqa: E402
from repro_torch.core.decomposition import decompose  # noqa: E402
from repro_torch.core.memory_model import (model_memory,  # noqa: E402
                                           resnet_memory)
from repro_torch.fl import data as tdata  # noqa: E402
from repro_torch.fl.engine import scenario_budgets  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch_helpers import one_torch_thread  # noqa: E402,F401

ATOL, RTOL = 1e-5, 1e-4
CONFIGS = {"full": (jcfgs.CONFIG, cfgs.CONFIG),
           "reduced": (jcfgs.reduced(), cfgs.reduced()),
           "x1/6": (jcfgs.scaled(1 / 6), cfgs.scaled(1 / 6))}


def _close(a, b, msg, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cfg.image_size, cfg.image_size,
                         cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, n).astype(np.int32)
    return ({"images": x, "labels": y},
            {"images": _t(x), "labels": _t(y, torch.int64)})


@functools.lru_cache(maxsize=None)
def _j_init(name):
    init = jax.jit(jresnet.init, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0),
                                         CONFIGS[name][0]))


def _setup(name, seed=0, aux=False):
    """The reference's parameters at ``name`` (its init runs once per
    config: XLA compiles every random draw), made distinct per ``seed``
    by numpy: conv and classifier weights scaled by 1 + 0.1 N(0, 1),
    non-trivial norm scales and biases so the checks see them."""
    jcfg, cfg = CONFIGS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(seed + 10)

    def vary(a):
        return a * (1 + 0.1 * rng.normal(size=a.shape)) if seed else a

    jp = jax.tree.map(vary, _j_init(name))
    for bp in jp["blocks"]:
        for n in ("n1", "n2"):
            bp[n] = {"w": 1 + 0.1 * rng.normal(size=bp[n]["w"].shape),
                     "b": 0.1 * rng.normal(size=bp[n]["b"].shape)}
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    if aux:
        jp["aux_heads"] = jax.tree.map(
            np.asarray, j_aux(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, cfg, jp, params_from_reference(jp, device="cpu")


def test_convert_round_trip_and_layout():
    """HWIO -> OIHW and back is exact (aux heads included); the blocks
    stay a list; converted tensors are copies."""
    jcfg, cfg, jp, tp = _setup("full", aux=True)
    assert tp["stem"].shape == (16, 3, 3, 3)
    assert tp["blocks"][3]["proj"].shape == (32, 16, 1, 1)
    np.testing.assert_array_equal(tp["blocks"][3]["conv1"][5, 2].numpy(),
                                  jp["blocks"][3]["conv1"][:, :, 2, 5])
    back = params_to_reference(tp)
    fa = jax.tree_util.tree_flatten_with_path(back)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert len(fa) == len(fb)
    for path, a in fa:
        assert a.shape == fb[path].shape and np.array_equal(a, fb[path])
    own = resnet.init(3, cfg, device="cpu")
    again = params_from_reference(params_to_reference(own), device="cpu")
    for a, b in zip(tree_leaves(own), tree_leaves(again)):
        assert torch.equal(a, b)
    tp["stem"].add_(1.0)
    assert not np.array_equal(params_to_reference(tp)["stem"], jp["stem"])


def test_init_shapes_match_reference():
    """The port's own init draws the reference's tree, leaf for leaf (in
    the port's layout), with He-scaled convs and unit / zero norms."""
    for name in CONFIGS:
        jcfg, cfg = CONFIGS[name]
        shapes = jax.eval_shape(lambda k: jresnet.init(k, jcfg),
                                jax.random.PRNGKey(0))
        ref = params_from_reference(jax.tree.map(
            lambda a: np.zeros(a.shape, a.dtype), shapes), device="cpu")
        own = resnet.init(0, cfg, device="cpu")
        fa = jax.tree_util.tree_flatten_with_path(own)[0]
        fb = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
        assert len(fa) == len(fb)
        for path, a in fa:
            assert a.shape == fb[path].shape, (name, path)
    w = resnet.init(0, cfgs.CONFIG, device="cpu")["blocks"][8]["conv2"]
    assert abs(float(w.std()) - (2.0 / (9 * 64)) ** 0.5) < 5e-3


def _j_chain(jcfg):
    """The reference's logits, every block's output z_0..z_n (one block at
    a time) and ``head_from_block`` after each block, in one jit."""
    def chain(p, x):
        zs = [jresnet.stem(p, x)]
        for i in range(jcfg.num_blocks):
            zs.append(jresnet.forward_blocks(p, jcfg, zs[i], i, i + 1))
        heads = [jresnet.head_from_block(p, jcfg, zs[i + 1], i)
                 for i in range(jcfg.num_blocks)]
        return jresnet.apply(p, jcfg, x), zs, heads
    return jax.jit(chain)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_reference(name):
    """logits; forward_blocks over every [lo, hi) from the reference's
    z_lo; head_from_block after every block."""
    jcfg, cfg, jp, tp = _setup(name)
    jb, tb = _batch(cfg, 4, 1)
    j_logits, zs, j_heads = _j_chain(jcfg)(jp, jb["images"])
    _close(resnet.apply(tp, cfg, tb["images"]).numpy(), j_logits,
           f"{name} apply")
    _close(resnet.stem(tp, tb["images"]).permute(0, 2, 3, 1).numpy(), zs[0],
           f"{name} stem")
    for lo in range(cfg.num_blocks):
        z_in = _t(zs[lo]).permute(0, 3, 1, 2)
        for hi in range(lo + 1, cfg.num_blocks + 1):
            out = resnet.forward_blocks(tp, cfg, z_in, lo, hi)
            _close(out.permute(0, 2, 3, 1).numpy(), zs[hi],
                   f"{name} blocks [{lo}, {hi})")
    for i in range(cfg.num_blocks):
        z = _t(zs[i + 1]).permute(0, 3, 1, 2)
        _close(resnet.head_from_block(tp, cfg, z, i).numpy(), j_heads[i],
               f"{name} head_from_block {i}")


def test_group_norm_groups_and_same_padding():
    """The fall-back groups of ``scaled(1/6)`` (3, 5, 11 channels -> 3, 5
    and 1 groups); SAME padding of a 3x3 stride-2 conv on an even input
    is (0, 1), and the odd input, the 1x1 and the stride-1 convs are
    symmetric."""
    assert [resnet.groups_for(c) for c in (3, 5, 11, 16, 12)] == \
        [3, 5, 1, 8, 6]
    assert cfgs.scaled(1 / 6).widths() == (3, 5, 11)
    assert resnet._same_pads(16, 3, 2) == (0, 1)
    assert resnet._same_pads(15, 3, 2) == (1, 1)
    assert resnet._same_pads(16, 1, 2) == (0, 0)
    assert resnet._same_pads(16, 3, 1) == (1, 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    out = resnet._conv(_t(x).permute(0, 3, 1, 2),
                       _t(w).permute(3, 2, 0, 1), 2)
    _close(out.permute(0, 2, 3, 1).numpy(), ref, "3x3 stride 2")
    for c in (3, 5, 11):
        xc = rng.normal(size=(2, 4, 4, c)).astype(np.float32)
        gw, gb = (rng.normal(size=c).astype(np.float32) for _ in range(2))
        _close(resnet.group_norm(_t(xc).permute(0, 3, 1, 2), _t(gw), _t(gb))
               .permute(0, 2, 3, 1).numpy(),
               jresnet.group_norm(xc, gw, gb), f"group norm C={c}")


def _relu_inputs(monkeypatch, module, name, fn):
    """Every ReLU input of one forward ``fn()``: ``module.name`` (the
    reference's ``jax.nn.relu``, the port's ``F.relu``) is wrapped to
    record its argument."""
    seen, relu = [], getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda x: (seen.append(np.asarray(x)), relu(x))[1])
    fn()
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_gradients_match_reference(name, monkeypatch):
    """The CE loss and its gradient at every parameter.  A ReLU is not
    differentiable at 0: a pre-activation within fp32 rounding of 0 can
    land on opposite sides in the two fp32 forwards, and then the two
    runs take different (equally valid) subgradients there, which a conv
    spreads over its window.  So the test first asserts that every ReLU
    input has the same sign on both sides for these inputs, and only
    then compares the gradients."""
    jcfg, cfg, jp, tp = _setup(name)
    jb, tb = _batch(cfg, 4, 7)
    j_in = _relu_inputs(monkeypatch, jax.nn, "relu",
                        lambda: jresnet.apply(jp, jcfg, jb["images"]))
    t_in = _relu_inputs(monkeypatch, torch.nn.functional, "relu",
                        lambda: resnet.apply(tp, cfg, tb["images"]))
    assert len(j_in) == len(t_in) == 2 * cfg.num_blocks + 1
    for i, (a, b) in enumerate(zip(j_in, t_in)):
        flips = int(((a > 0) != (np.moveaxis(b, 1, -1) > 0)).sum())
        assert flips == 0, f"{name}: ReLU {i} takes another branch at " \
            f"{flips} inputs (a kink, not a fault): choose other inputs"

    def jloss(p):
        return jbw._ce_logits(jresnet.apply(p, jcfg, jb["images"]),
                              jb["labels"])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tl = tbw._ce_logits(resnet.apply(tp, cfg, tb["images"]), tb["labels"])
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


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    order = {id(t): next(it) for t in tree_leaves(tree)}
    return tree_map(lambda t: order[id(t)], tree)


@pytest.mark.parametrize("image_size", [16, 32])
def test_resnet_memory_matches_reference(image_size):
    """Field by field at every config and scenario width, and the same
    budgets and decompositions."""
    for r in (1.0, 1 / 2, 1 / 3, 1 / 6, 1 / 8):
        jcfg = dataclasses.replace(jcfgs.scaled(r), image_size=image_size)
        cfg = dataclasses.replace(cfgs.scaled(r), image_size=image_size)
        for batch in (1, 64, 128):
            jm, tm = j_resnet_memory(jcfg, batch), resnet_memory(cfg, batch)
            assert dataclasses.astuple(tm) == dataclasses.astuple(jm)
            assert model_memory(cfg, batch) == tm
    jcfg = jcfgs.reduced(image_size=image_size)
    cfg = cfgs.reduced(image_size=image_size)
    assert dataclasses.astuple(resnet_memory(cfg, 32)) == \
        dataclasses.astuple(j_resnet_memory(jcfg, 32))
    jm, tm = j_resnet_memory(jcfgs.CONFIG, 128), \
        resnet_memory(cfgs.CONFIG, 128)
    for scen in ("fair", "lack", "surplus"):
        ratios = j_ratios(12, scen, 0)
        budgets = j_budgets(jm, ratios)
        assert np.array_equal(budgets, scenario_budgets(tm, ratios))
        for b in budgets:
            assert dataclasses.astuple(decompose(tm, int(b))) == \
                dataclasses.astuple(j_decompose(jm, int(b)))


# ------------------------------------------------------------ the runner
@pytest.mark.parametrize("head", ["skip", "aux"])
def test_runner_contract(head):
    """embed / apply_units / head_loss agree with the reference runner at
    every exit; ranges compose; merge(split) is the identity; merge
    replaces exactly [lo, hi) (and the trained head / stem keys), shares
    every other tensor and never writes its input."""
    jcfg, cfg, jp, tp = _setup("reduced", seed=1, aux=head == "aux")
    jb, tb = _batch(cfg, 4, 5)
    jr, tr = jbw.resnet_runner(jcfg, head), tbw.resnet_runner(cfg, head)
    assert (tr.n_units, tr.prefix_stable) == (jr.n_units, jr.prefix_stable)
    n = tr.n_units
    z0, jz0 = tr.embed(tp, tb), jr.embed(jp, jb)
    z, jz = z0, jz0
    for i in range(n):
        z, jz = tr.apply_units(tp, z, i, i + 1), jr.apply_units(jp, jz, i,
                                                                i + 1)
        _close(tr.head_loss(tp, z, tb, i).item(),
               jr.head_loss(jp, jz, jb, i), f"{head} head_loss {i}")
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
    assert all(a is b for a, b in zip(tp["blocks"], before["blocks"]))
    assert all(tp[k] is before[k] for k in tp if k != "blocks")


DECOMPS = {
    "partial_advance": ((1, 2), (2, 3)),     # skipped prefix, then advance
    "from_stem": ((0, 1), (1, 3)),           # block at 0 holds the stem
}


@pytest.mark.parametrize("head", ["skip", "aux"])
@pytest.mark.parametrize("dec", sorted(DECOMPS))
def test_client_update_matches_reference(dec, head):
    """A multi-block update (prefix cache on) equals the reference's;
    cached equals recompute; the given tree is never written."""
    jcfg, cfg, jp, tp = _setup("reduced", seed=2, aux=head == "aux")
    batches = [_batch(cfg, 4, 10 + i) for i in range(2)]
    blocks = DECOMPS[dec]
    kw = dict(lr=0.05, momentum=0.9, local_steps=2)
    jout = jbw.client_update(jbw.resnet_runner(jcfg, head), jp,
                             Decomposition(blocks, 0, 0),
                             [b[0] for b in batches], **kw)
    snapshot = [t.clone() for t in tree_leaves(tp)]
    tr = tbw.resnet_runner(cfg, head)
    outs = {pc: tbw.client_update(tr, tp, TDec(blocks, 0, 0),
                                  [b[1] for b in batches],
                                  prefix_cache=pc, **kw)
            for pc in (True, False)}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), snapshot))
    fa = jax.tree_util.tree_flatten_with_path(
        params_to_reference(outs[True]))[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jout))[0])
    assert len(fa) == len(fb)
    for path, x in fa:
        _close(x, fb[path], f"{dec} {head} {jax.tree_util.keystr(path)}")
    for a, b in zip(tree_leaves(outs[True]), tree_leaves(outs[False])):
        _close(a.numpy(), b.numpy(), "cached vs recompute", atol=1e-6,
               rtol=1e-5)
    # the stem never trains (z_in is detached, as in the reference)
    assert torch.equal(outs[True]["stem"], tp["stem"])


def test_buffered_bytes_match_memory_model():
    """The cache's held bytes == ``ModelMemory.buffered_z_bytes`` at the
    runtime batch size, at every prefix depth and after an update."""
    _, cfg, _, tp = _setup("reduced", seed=4)
    batches = [_batch(cfg, 2, 20 + i)[1] for i in range(3)]
    runner = tbw.resnet_runner(cfg)
    mem = resnet_memory(cfg, 2)
    cache = tbw.PrefixCache(runner)
    for lo in range(runner.n_units):
        cache.zs = None
        cache.prepare(tp, batches, lo)
        assert cache.buffered_bytes() == mem.buffered_z_bytes(
            lo, n_batches=len(batches)), lo
    dec = TDec(((0, 1), (1, 2), (2, 3)), 0, 0)
    tbw.client_update(runner, tp, dec, batches, lr=0.05, prefix_cache=cache)
    assert cache.buffered_bytes() == mem.buffered_z_bytes(
        2, n_batches=len(batches))


# ------------------------------------------------- aggregation and MKD
def test_masked_aggregation_matches_reference():
    """A partial-training client (prefix skipped) and a full client: the
    trained masks and the masked average equal the reference's; leaves
    nobody trained keep the global value; a NaN client is dropped."""
    jcfg, cfg, jp, tp = _setup("reduced", seed=5)
    decs = [((1, 2), (2, 3)), ((0, 3),)]
    jr, tr = jbw.resnet_runner(jcfg), tbw.resnet_runner(cfg)
    rng = np.random.default_rng(6)
    jclients, tclients, jmasks, tmasks = [], [], [], []
    for blocks in decs:
        jc = jax.tree.map(lambda a: a + rng.normal(size=a.shape)
                          .astype(np.float32), jp)
        jclients.append(jc)
        tclients.append(params_from_reference(jc, device="cpu"))
        jmasks.append(jagg.trained_mask_for(jp, Decomposition(blocks, 0, 0),
                                            jr))
        tmasks.append(tagg.trained_mask_for(tp, TDec(blocks, 0, 0), tr))
    assert float(tmasks[0]["stem"].max()) == 0.0
    assert float(tmasks[0]["blocks"][0]["conv1"].max()) == 0.0
    assert float(tmasks[0]["blocks"][1]["conv1"].min()) == 1.0
    for tm, jm in zip(tmasks, jmasks):
        a = jax.tree.leaves(params_to_reference(tm))
        b = jax.tree.leaves(jax.tree.map(np.asarray, jm))
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    weights = [3.0, 1.0]
    jout = jagg.aggregate_masked(jp, jclients, weights, jmasks)
    tout = tagg.aggregate_masked(tp, tclients, weights, tmasks)
    for x, y in zip(jax.tree.leaves(params_to_reference(tout)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jout))):
        _close(x, y, "aggregate_masked", atol=1e-6, rtol=1e-6)
    # block 0 only the full client trained: its value, not the average
    np.testing.assert_array_equal(tout["blocks"][0]["conv1"].numpy(),
                                  tclients[1]["blocks"][0]["conv1"].numpy())
    # nobody trained: the global value
    none = [tree_map(torch.zeros_like, m) for m in tmasks]
    kept = tagg.aggregate_masked(tp, tclients, weights, none)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(kept),
                                                 tree_leaves(tp)))
    bad = tree_map(lambda t: t * float("nan"), tclients[0])
    guarded = tagg.aggregate_masked(tp, [bad, tclients[1]], weights, tmasks)
    np.testing.assert_array_equal(guarded["classifier"]["w"].numpy(),
                                  tclients[1]["classifier"]["w"].numpy())


def test_kl_logits_zero_for_identical():
    lg = torch.tensor([[1.0, 2.0, 3.0]])
    assert float(mkd.kl_logits(lg, lg)) == pytest.approx(0.0, abs=1e-6)
    assert float(mkd.kl_logits(lg, lg + 5.0)) == pytest.approx(0.0, abs=1e-5)
    p = np.random.default_rng(7).normal(size=(5, 10)).astype(np.float32)
    q = np.random.default_rng(8).normal(size=(5, 10)).astype(np.float32)
    _close(mkd.kl_logits(_t(p), _t(q)).item(), jmkd.kl_logits(p, q),
           "kl_logits")


def test_mkd_matches_reference():
    """``mkd_loss`` (two different models) and two steps of
    ``mkd_local_update`` equal the reference's; the teachers are detached
    and the given trees are never written."""
    jcfg, cfg, jp1, tp1 = _setup("reduced", seed=8)
    _, _, jp2, tp2 = _setup("reduced", seed=9)
    jb, tb = _batch(cfg, 8, 30)

    # jitted, so that the reference's eager autodiff compiles once
    jlogits = jax.jit(lambda p, b: jresnet.apply(p, jcfg, b["images"]))
    jtask = jax.jit(lambda p, b: jbw._ce_logits(jlogits(p, b), b["labels"]))

    def tlogits(p, b):
        return resnet.apply(p, cfg, b["images"])

    def ttask(p, b):
        return tbw._ce_logits(tlogits(p, b), b["labels"])

    _close(mkd.mkd_loss(tlogits, [tp1, tp2], tb, ttask).item(),
           jmkd.mkd_loss(jlogits, [jp1, jp2], jb, jtask), "mkd_loss")
    snapshot = [t.clone() for t in tree_leaves([tp1, tp2])]
    jout = jmkd.mkd_local_update(jlogits, jtask, [jp1, jp2], [jb], lr=0.05,
                                 local_steps=2)
    tout = mkd.mkd_local_update(tlogits, ttask, [tp1, tp2], [tb], lr=0.05,
                                local_steps=2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves([tp1, tp2]),
                                                 snapshot))
    for m in range(2):
        for x, y in zip(jax.tree.leaves(params_to_reference(tout[m])),
                        jax.tree.leaves(jax.tree.map(np.asarray, jout[m]))):
            _close(x, y, f"mkd model {m}")


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("partition,balanced", [
    ("dirichlet", True), ("dirichlet", False), ("pathological", True)])
def test_build_federated_matches_reference(partition, balanced):
    """Images, labels, partitions and client batches (the shared numpy
    stream, drawn in the same order) are identical to the reference's;
    the tensors live on the device asked for, NHWC fp32 and int64."""
    kw = dict(num_clients=8, partition=partition, alpha=0.5, labels_per=3,
              balanced=balanced, n_train=640, n_test=64, image_size=16,
              seed=3)
    jd = jdata.build_federated(**kw)
    td = tdata.build_federated(**kw, device="cpu")
    assert td.x.dtype == torch.float32 and td.y.dtype == torch.int64
    assert td.x.shape == (640, 16, 16, 3) and td.device.type == "cpu"
    for a, b in ((td.x, jd.x), (td.y, jd.y), (td.x_test, jd.x_test),
                 (td.y_test, jd.y_test)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert len(td.client_indices) == len(jd.client_indices)
    for a, b in zip(td.client_indices, jd.client_indices):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(td.client_sizes(), jd.client_sizes())
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for k in range(8):
        tb, jb = td.client_batch(k, 32, r1), jd.client_batch(k, 32, r2)
        for name in ("images", "labels"):
            np.testing.assert_array_equal(tb[name].numpy(), jb[name])
