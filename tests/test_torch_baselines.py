"""Port of the paper's baselines vs the reference (PyTorch port), on the
CPU: HeteroFL's width slicing, padding and nested aggregation, SplitMix's
base nets, DepthFL's budget-to-depth rule, local update and aggregation.

Every test starts from the reference's parameters (converted: HWIO conv
weights to OIHW) and seeded numpy batches.  Slicing and padding are exact;
aggregation agrees within atol 1e-6; a subnet's forward and a local update
(several SGD steps) within atol 1e-5, rtol 1e-4 (fp32, different summation
order), after checking that every ReLU input of the first forward takes
the same branch on both sides (a kink, not a fault, otherwise: see
``repro_torch/testing/relu.py``).
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import preresnet20 as jcfgs  # noqa: E402
from repro.core.memory_model import resnet_memory as j_resnet_memory  # noqa: E402
from repro.fl import baselines as jbl  # noqa: E402
from repro.fl import width as jwidth  # noqa: E402
from repro.fl.strategies import depthfl as jdepthfl  # noqa: E402
from repro.models import resnet as jresnet  # noqa: E402
from repro_torch.configs import preresnet20 as cfgs  # noqa: E402
from repro_torch.core.memory_model import resnet_memory  # noqa: E402
from repro_torch.fl import baselines as bl  # noqa: E402
from repro_torch.fl import width  # noqa: E402
from repro_torch.fl.engine import SCENARIOS, SimConfig  # noqa: E402
from repro_torch.fl.strategies import depthfl  # noqa: E402
from repro_torch.fl.strategies.splitmix import SplitMixStrategy  # noqa: E402
from repro_torch.fl.strategy import Context  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

ATOL, RTOL = 1e-5, 1e-4
FAIR = SCENARIOS["fair"]
KW = dict(lr=0.05, momentum=0.9, local_steps=2)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _j_init(jcfg, seed=0):
    """The reference's parameters (jitted: its eager init compiles every
    random draw), with numpy-varied norm scales and biases so that the
    checks see them."""
    init = jax.jit(jresnet.init, static_argnums=1)
    p = _host(init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 10)
    for bp in p["blocks"] + [p]:
        for n in ("n1", "n2", "head_norm"):
            if n in bp:
                bp[n] = {k: (v + 0.1 * rng.normal(size=v.shape))
                         .astype(np.float32) for k, v in bp[n].items()}
    return p


def _batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cfg.image_size, cfg.image_size,
                         cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, n).astype(np.int32)
    return ({"images": x, "labels": y},
            {"images": torch.tensor(x), "labels": torch.tensor(y).long()})


def _assert_equal_trees(a, b, msg):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(fa) == len(fb), msg
    for path, x in fa:
        y = np.asarray(fb[path])
        assert x.shape == y.shape and x.dtype == y.dtype, (msg, path)
        assert np.array_equal(x, y), f"{msg} {jax.tree_util.keystr(path)}"


def _same_branches(monkeypatch, jfwd, tfwd):
    """Every ReLU input of the reference's forward ``jfwd()`` and the
    port's ``tfwd()`` lies on the same side of 0."""
    seen = {}
    for side, module, fn in (("jax", jax.nn, jfwd),
                             ("torch", torch.nn.functional, tfwd)):
        relu, seen[side] = module.relu, []
        monkeypatch.setattr(module, "relu", lambda x, _s=seen[side],
                            _r=relu: (_s.append(np.asarray(x)), _r(x))[1])
        fn()
        monkeypatch.undo()
    assert len(seen["jax"]) == len(seen["torch"]) > 0
    for i, (a, b) in enumerate(zip(seen["jax"], seen["torch"])):
        flips = int(((a > 0) != (np.moveaxis(b, 1, -1) > 0)).sum())
        assert flips == 0, f"ReLU {i} takes another branch at {flips} " \
            "inputs (a kink, not a fault): choose other inputs"


# ------------------------------------------------------------- HeteroFL
@pytest.mark.parametrize("ratio", FAIR, ids=lambda r: f"x{r:.3g}")
def test_slice_and_pad_match_reference(ratio):
    """Full PreResNet-20 sliced at each ``fair`` ratio: the subnet's
    leaves equal the reference's exactly after the layout transpose, its
    widths (x1/6: 3 / 5 / 11, group norm falling back to 3, 5 and 1
    groups) and logits match, and padding it back gives the reference's
    padded tree and mask exactly."""
    jcfg, cfg = jcfgs.CONFIG, cfgs.CONFIG
    jp = _j_init(jcfg)
    tp = params_from_reference(jp, device="cpu")
    jsub, jsc = jwidth.slice_resnet(jp, jcfg, ratio)
    tsub, tsc = width.slice_resnet(tp, cfg, ratio)
    assert tsc.widths() == jsc.widths()
    if ratio == FAIR[0]:
        assert tsc.widths() == (3, 5, 11)
        assert [resnet.groups_for(c) for c in tsc.widths()] == [3, 5, 1]
    _assert_equal_trees(params_to_reference(tsub), _host(jsub),
                        f"slice x{ratio:g}")
    jb, tb = _batch(cfg, 2, 3)
    np.testing.assert_allclose(
        resnet.apply(tsub, tsc, tb["images"]).numpy(),
        np.asarray(jresnet.apply(jsub, jsc, jb["images"])), atol=ATOL,
        rtol=RTOL)
    jpad, jmask = jwidth.pad_resnet(jsub, jcfg, jsc)
    tpad, tmask = width.pad_resnet(tsub, cfg, tsc)
    _assert_equal_trees(params_to_reference(tpad), _host(jpad),
                        f"padded x{ratio:g}")
    _assert_equal_trees(params_to_reference(tmask), _host(jmask),
                        f"mask x{ratio:g}")


def test_heterofl_aggregate_respects_coverage():
    """Port of ``tests/test_fl.py::test_heterofl_aggregate_respects_coverage``."""
    g = {"w": torch.zeros(4)}
    p1 = {"w": torch.tensor([1.0, 1.0, 0.0, 0.0])}
    m1 = {"w": torch.tensor([1.0, 1.0, 0.0, 0.0])}
    p2 = {"w": torch.tensor([3.0, 3.0, 3.0, 0.0])}
    m2 = {"w": torch.tensor([1.0, 1.0, 1.0, 0.0])}
    out = bl.heterofl_aggregate(g, [p1, p2], [m1, m2], [1.0, 1.0])
    np.testing.assert_allclose(out["w"].numpy(), [2.0, 2.0, 3.0, 0.0])


def test_heterofl_aggregate_matches_reference():
    """Random padded trees of the reduced PreResNet at three ratios,
    unnormalised weights: the nested average equals the reference's."""
    jcfg = jcfgs.reduced()
    jp = _j_init(jcfg)
    rng = np.random.default_rng(5)
    padded, masks = [], []
    for r in (1 / 6, 1 / 2, 1.0):
        sub, sc = jwidth.slice_resnet(jp, jcfg, r)
        sub = jax.tree.map(lambda a: (a + rng.normal(size=a.shape))
                           .astype(np.float32), sub)
        p, m = jwidth.pad_resnet(sub, jcfg, sc)
        padded.append(_host(p))
        masks.append(_host(m))
    w = [3.0, 1.0, 2.5]
    ref = _host(jbl.heterofl_aggregate(jp, padded, masks, w))
    out = bl.heterofl_aggregate(
        params_from_reference(jp, device="cpu"),
        [params_from_reference(p, device="cpu") for p in padded],
        [params_from_reference(m, device="cpu") for m in masks], w)
    assert_trees_close(params_to_reference(out), ref, "heterofl aggregate",
                       atol=1e-6, rtol=0)


# ------------------------------------------------------ local updates
def _local_heterofl(monkeypatch, ratio):
    jcfg, cfg = jcfgs.reduced(), cfgs.reduced()
    jp = _j_init(jcfg)
    tp = params_from_reference(jp, device="cpu")
    batches = [_batch(cfg, 4, 20 + i) for i in range(2)]
    jsub, jsc = jwidth.slice_resnet(jp, jcfg, ratio)
    tsub, tsc = width.slice_resnet(tp, cfg, ratio)
    _same_branches(monkeypatch,
                   lambda: jresnet.apply(jsub, jsc, batches[0][0]["images"]),
                   lambda: resnet.apply(tsub, tsc, batches[0][1]["images"]))
    ref = jbl.heterofl_local(jcfg, jp, ratio, [b[0] for b in batches], **KW)
    out = bl.heterofl_local(cfg, tp, ratio, [b[1] for b in batches], **KW)
    _assert_equal_trees(params_to_reference(out[1]), _host(ref[1]), "mask")
    return params_to_reference(out[0]), _host(ref[0])


def _local_splitmix(monkeypatch):
    """One SplitMix round over three clients of ``fair`` ratios: the
    port's ``SplitMixStrategy.client_update`` per client, then its
    ``aggregate``, against the reference's ``splitmix_round``, from the
    same bases and numpy stream on both sides."""
    jcfg, cfg = jcfgs.reduced(), cfgs.reduced()
    base_r = min(FAIR)
    jstate = object.__new__(jbl.SplitMixState)   # the bases set below
    jstate.base_cfg = jwidth.subnet_config(jcfg, base_r)
    jstate.k = 6
    jstate.bases = [_j_init(jstate.base_cfg, s) for s in range(jstate.k)]
    tstate = bl.SplitMixState(cfg, base_r, 0, device="cpu")
    assert tstate.k == jstate.k and tstate.base_cfg == \
        width.subnet_config(cfg, base_r)
    tstate.bases = params_from_reference(jstate.bases, device="cpu")
    batches = {c: [_batch(cfg, 4, 30 + 2 * c + i) for i in range(2)]
               for c in range(3)}
    for b in range(jstate.k):
        _same_branches(
            monkeypatch,
            lambda: jresnet.apply(jstate.bases[b], jstate.base_cfg,
                                  batches[0][0][0]["images"]),
            lambda: resnet.apply(tstate.bases[b], tstate.base_cfg,
                                 batches[0][0][1]["images"]))
    ratios = [FAIR[3], FAIR[1], FAIR[2]]
    jbl.splitmix_round(jstate, [0, 1, 2],
                       lambda c: [b[0] for b in batches[c]], ratios,
                       rng=np.random.default_rng(4), **KW)
    ctx = Context(sim=SimConfig(lr=KW["lr"], momentum=KW["momentum"],
                                local_steps=KW["local_steps"]),
                  num_clients=3, sizes=np.ones(3),
                  rng=np.random.default_rng(4), seed=0,
                  device=torch.device("cpu"), model_cfg=cfg,
                  ratios=np.asarray(ratios))
    strat = SplitMixStrategy()
    results = [strat.client_update(ctx, tstate, c,
                                   [b[1] for b in batches[c]])
               for c in range(3)]
    assert sorted(len(r.payload) for r in results) == \
        sorted(tstate.capacity(r) for r in ratios)
    tstate = strat.aggregate(ctx, tstate, results)
    return params_to_reference(tstate.bases), _host(jstate.bases)


def _local_depthfl(monkeypatch, depth):
    jcfg, cfg = jcfgs.reduced(), cfgs.reduced()
    jp = _j_init(jcfg)
    jaux = _host(jbl.depthfl_init_aux(jcfg, jax.random.PRNGKey(3)))
    tp = params_from_reference(jp, device="cpu")
    taux = params_from_reference(jaux, device="cpu")
    batches = [_batch(cfg, 4, 40 + i) for i in range(2)]
    _same_branches(monkeypatch,
                   lambda: jresnet.apply(jp, jcfg, batches[0][0]["images"]),
                   lambda: resnet.apply(tp, cfg, batches[0][1]["images"]))
    jout = jbl.depthfl_local(jcfg, jp, jaux, depth,
                             [b[0] for b in batches], **KW)
    tout = bl.depthfl_local(cfg, tp, taux, depth, [b[1] for b in batches],
                            **KW)
    assert tout[2] == jout[2] == depth
    if depth < cfg.num_blocks:   # the head's gradient is 0: untouched
        for k in ("head_norm", "classifier"):
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(tout[0][k]), tree_leaves(tp[k])))
    # blocks past the depth are the global tensors themselves
    assert all(a is b for a, b in zip(tout[0]["blocks"][depth:],
                                      tp["blocks"][depth:]))
    return params_to_reference(tout[:2]), _host(jout[:2])


LOCAL = {"heterofl x1/6": lambda mp: _local_heterofl(mp, 1 / 6),
         "heterofl x1/2": lambda mp: _local_heterofl(mp, 1 / 2),
         "splitmix round": _local_splitmix,
         "depthfl depth 2": lambda mp: _local_depthfl(mp, 2),
         "depthfl depth 3": lambda mp: _local_depthfl(mp, 3)}


@pytest.mark.parametrize("case", sorted(LOCAL))
def test_local_update_matches_reference(case, monkeypatch):
    """``heterofl_local``, a SplitMix round and ``depthfl_local`` on the
    reduced PreResNet (2 batches x 2 local steps) from the reference's
    parameters equal the reference's results."""
    out, ref = LOCAL[case](monkeypatch)
    assert_trees_close(out, ref, case, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------- SplitMix
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_splitmix_capacity_matches_reference(scenario):
    """K base nets of the scenario's smallest width, and how many a
    client of each ratio trains (the reference's float expression)."""
    base_r = min(min(SCENARIOS[scenario]), 1.0)
    state = bl.SplitMixState(cfgs.reduced(), base_r, 0, device="cpu")
    assert state.k == max(1, int(round(1.0 / base_r))) == len(state.bases)
    jstate = types.SimpleNamespace(k=state.k)
    for r in SCENARIOS[scenario]:
        r = min(r, 1.0)
        assert state.capacity(r) == jbl.SplitMixState.capacity(jstate, r)
    assert [state.capacity(min(r, 1.0)) for r in SCENARIOS[scenario]] == \
        {"fair": [1, 2, 3, 6], "lack": [1, 1, 4, 8],
         "surplus": [1, 2, 3, 6]}[scenario]


def test_splitmix_ensemble_is_the_logit_mean():
    cfg = cfgs.reduced()
    state = bl.SplitMixState(cfg, 1 / 3, 1, device="cpu")
    x = _batch(cfg, 3, 1)[1]["images"]
    mean = sum(resnet.apply(p, state.base_cfg, x) for p in state.bases) / 3
    torch.testing.assert_close(state.ensemble_logits(x), mean)


# -------------------------------------------------------------- DepthFL
def test_depthfl_depth_for_budget_matches_reference():
    """The deepest fixed-step prefix that fits, over budgets from the
    stem alone to the whole model, for the full and the reduced model;
    the aux exits sit every 2 blocks with the reference's shapes."""
    for jcfg, cfg in ((jcfgs.CONFIG, cfgs.CONFIG),
                      (jcfgs.reduced(), cfgs.reduced())):
        full = resnet_memory(cfg, 128).full_train_bytes()
        assert full == j_resnet_memory(jcfg, 128).full_train_bytes()
        for f in np.linspace(0.0, 1.05, 43):
            b = int(full * f)
            assert bl.depthfl_depth_for_budget(cfg, b, 128) == \
                jbl.depthfl_depth_for_budget(jcfg, b, 128), (cfg.name, f)
    aux = bl.depthfl_init_aux(cfgs.CONFIG, torch.Generator().manual_seed(0),
                              device="cpu")
    jaux = jax.eval_shape(lambda: jbl.depthfl_init_aux(
        jcfgs.CONFIG, jax.random.PRNGKey(0)))
    assert sorted(aux) == sorted(jaux) == [f"exit_{e}" for e in (2, 4, 6, 8)]
    for k in aux:
        assert tuple(aux[k]["w"].shape) == jaux[k]["w"].shape
        assert tuple(aux[k]["b"].shape) == jaux[k]["b"].shape


def test_depthfl_budget_to_depth_monotone():
    """Port of ``tests/test_fl.py::test_depthfl_budget_to_depth_monotone``."""
    cfg = cfgs.CONFIG
    mem = resnet_memory(cfg, 128)
    budgets = [mem.full_train_bytes() * f for f in (0.2, 0.5, 1.0)]
    depths = [bl.depthfl_depth_for_budget(cfg, int(b), 128)
              for b in budgets]
    assert depths == sorted(depths)
    assert depths[-1] == cfg.num_blocks


def test_depth_and_aux_aggregate_match_reference():
    """Per-block (depth > b) and per-exit (depth >= e) aggregation of
    random client trees with coverages 2, 4 and 9 on the full model,
    weights normalised in float32 over the covering clients."""
    jcfg, cfg = jcfgs.CONFIG, cfgs.CONFIG
    jp = _j_init(jcfg)
    jaux = _host(jbl.depthfl_init_aux(jcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(6)

    def vary(tree):
        return jax.tree.map(lambda a: (a + rng.normal(size=a.shape))
                            .astype(np.float32), tree)

    locals_ = [vary(jp) for _ in range(3)]
    auxs = [vary(jaux) for _ in range(3)]
    covs, ws = [2, 4, 9], [5.0, 3.0, 7.0]
    jout = _host(jdepthfl.depth_aggregate(jcfg, jp, locals_, covs, ws))
    jaout = _host(jdepthfl.aux_aggregate(jaux, auxs, covs, ws))

    def port(tree):
        return params_from_reference(tree, device="cpu")

    out = depthfl.depth_aggregate(cfg, port(jp), [port(t) for t in locals_],
                                  covs, ws)
    aout = depthfl.aux_aggregate(port(jaux), [port(t) for t in auxs], covs,
                                 ws)
    assert_trees_close(params_to_reference(out), jout, "depth aggregate",
                       atol=1e-6, rtol=0)
    assert_trees_close(params_to_reference(aout), jaout, "aux aggregate",
                       atol=1e-6, rtol=0)
