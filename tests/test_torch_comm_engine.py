"""The round engine under each wire codec and downlink vs the
reference's engine (PyTorch port), on the CPU.

Two rounds of the verify recipe's tiny image run (reduced PreResNet, 8
clients over a Dirichlet split of 640 synthetic 16 x 16 images,
participation 0.5, ``fair``) per lossy codec (error feedback on) and a
sliced or delta downlink: FeDepth, HeteroFL (its width mask), DepthFL
(its ``(params, aux)`` pair) and SplitMix (its tagged base nets), from
the reference's initial state.  Cohorts, up and down bytes exactly the
reference's; server states within atol 1e-4 / rtol 1e-3; accuracies
within one test image.  Under ``topk`` the two sides' client deltas
differ by fp32 rounding (~1e-8), enough to swap two coordinates of equal
magnitude at the top-k threshold: there a coordinate may differ by one
transmitted value, so at most 8 coordinates a round may be off the
tolerance, each within 1e-2.  And ``codec="none"`` with
``downlink="full"``: the engine without a channel, bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.preresnet20 import reduced as j_reduced  # noqa: E402
from repro.fl.data import build_federated as j_federated  # noqa: E402
from repro.fl.engine import RoundEngine as JEngine  # noqa: E402
from repro.fl.engine import SimConfig as JSim  # noqa: E402
from repro.fl.engine import build_context as j_context  # noqa: E402
from repro.fl.registry import get_strategy as j_get_strategy  # noqa: E402
from repro_torch.configs.preresnet20 import reduced  # noqa: E402
from repro_torch.fl import registry  # noqa: E402
from repro_torch.fl.data import build_federated  # noqa: E402
from repro_torch.fl.engine import (RoundEngine, SimConfig,  # noqa: E402
                                   build_context)
from repro_torch.fl.strategy import wire_bytes  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)

from test_torch_baseline_engine import (_initial_states,  # noqa: E402
                                        _run_recorded)
from torch_helpers import one_torch_thread  # noqa: E402,F401

DATA = dict(num_clients=8, partition="dirichlet", alpha=1.0, n_train=640,
            n_test=200, image_size=16, seed=0)
SIM = dict(rounds=2, participation=0.5, lr=0.05, momentum=0.9,
           local_steps=1, batch_size=32, scenario="fair", seed=0)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def datasets():
    return j_federated(**DATA), build_federated(**DATA, device="cpu")


def _states_close(ts, js, codec, msg):
    for rd, (a, b) in enumerate(zip(ts, js)):
        fa = jax.tree_util.tree_flatten_with_path(a)[0]
        fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
        assert len(fa) == len(fb)
        swapped = 0
        for path, x in fa:
            y = fb[path]
            bad = np.abs(x - y) > 1e-4 + 1e-3 * np.abs(y)
            if codec == "topk":
                swapped += int(bad.sum())
                assert float(np.abs(x - y).max()) <= 1e-2, (msg, rd, path)
            else:
                assert not bad.any(), (msg, rd, jax.tree_util.keystr(path),
                                       float(np.abs(x - y).max()))
        assert swapped <= 8, (msg, rd, swapped)


ENGINE_CASES = [("fedepth", "fp16", "sliced"),
                ("fedepth", "qsgd_int8", "delta"),
                ("fedepth", "topk", "delta"),
                ("heterofl", "qsgd_int8", "sliced"),
                ("heterofl", "topk", "sliced"),
                ("depthfl", "fp16", "delta"),
                ("depthfl", "topk", "sliced"),
                ("splitmix", "qsgd_int8", "sliced")]


@pytest.fixture(scope="module")
def references(datasets):
    """method -> a new reference context (its sampling stream fresh) that
    shares one ``caches`` dict with the method's other cases, the
    reference strategy, its initial state and host view, and the port's
    SplitMix state and host view (else None): the reference's compiled
    client steps, kept in ``caches``, then serve every case of the
    method."""
    jdata, _ = datasets
    built = {}

    def get(method, ctx):
        jctx = j_context(jdata, JSim(**SIM),
                         model_cfg=j_reduced(num_classes=10, image_size=16))
        if method not in built:
            jstrat = j_get_strategy(method)
            # FeDepth's initial state is the model's init, as HeteroFL's
            # (the jitted init: the eager one compiles every draw)
            j0, j_host, t0, t_host = _initial_states(
                "heterofl" if method == "fedepth" else method, jctx, ctx)
            if method == "fedepth":
                jstrat.setup(jctx)
                assert jax.tree.structure(j0) == jax.tree.structure(
                    jax.eval_shape(lambda: jstrat.init_state(jctx)))
            built[method] = (jctx.caches, jstrat, j0, j_host,
                             (t0, t_host) if method == "splitmix" else None)
        caches, *rest = built[method]
        jctx.caches = caches
        return (jctx, *rest)

    return get


@pytest.mark.parametrize("method,codec,downlink", ENGINE_CASES)
def test_two_rounds_match_reference_engine(datasets, references, method,
                                           codec, downlink):
    """Two rounds under a lossy codec (error feedback on) and a sliced or
    delta downlink: the same cohorts, up and down bytes exactly, states
    within tolerance (module docstring), accuracies within one image."""
    _, tdata = datasets
    ctx = build_context(tdata, SimConfig(**SIM),
                        model_cfg=reduced(num_classes=10, image_size=16),
                        device="cpu")
    jctx, jstrat, j0, j_host, split = references(method, ctx)
    tstrat = registry.get_strategy(method)
    t0, t_host = split or (params_from_reference(j0, device="cpu"),
                           params_to_reference)
    kw = dict(codec=codec, downlink=downlink)
    try:
        jc, _, js, jh = _run_recorded(JEngine(jstrat, jctx, **kw), j0,
                                      j_host)
    finally:
        vars(jstrat).pop("aggregate", None)   # the recording wrapper
    tc, _, ts, th = _run_recorded(RoundEngine(tstrat, ctx, **kw), t0,
                                  t_host)
    assert tc == jc and len(ts) == len(js) == 2
    assert [r.comm_bytes for r in th] == [r.comm_bytes for r in jh]
    assert [r.down_bytes for r in th] == [r.down_bytes for r in jh]
    _states_close(ts, js, codec, f"{method} {codec} {downlink}")
    for r1, r2 in zip(th, jh):
        assert abs(r1.accuracy - r2.accuracy) <= 1.0 / DATA["n_test"]


def test_none_codec_is_the_channel_free_engine(datasets):
    """``codec="none"``, ``downlink="full"``: every payload reaches
    ``aggregate`` as the object the client update returned, and the
    states and bytes equal, bitwise, a round loop with no channel
    (sample, the scheduler's updates, raw bytes, aggregate)."""
    _, tdata = datasets
    sim = SimConfig(**SIM)
    cfg = reduced(num_classes=10, image_size=16)
    runs = []
    for channel in (True, False):
        ctx = build_context(tdata, dataclasses.replace(sim), model_cfg=cfg,
                            device="cpu")
        strategy = registry.get_strategy("fedepth")
        engine = RoundEngine(strategy, ctx)
        strategy.setup(ctx)
        state = strategy.init_state(ctx)
        batch_fn = engine.default_batch_fn()
        log = []
        for rd in range(2):
            if channel:
                made = []
                update = strategy.client_update
                strategy.client_update = (
                    lambda *a, _u=update: made.append(_u(*a)) or made[-1])
                aggregate = strategy.aggregate

                def seen(c, s, results, _a=aggregate, _m=made):
                    assert all(r is m and r.comm_bytes is None
                               for r, m in zip(results, _m))
                    return _a(c, s, results)

                strategy.aggregate = seen
                state, up, down = engine.run_round(state, rd, batch_fn)
                strategy.client_update, strategy.aggregate = update, \
                    aggregate
            else:
                cohort = engine.sampler.sample(ctx, rd)
                down = sum(wire_bytes(state) for _ in cohort)
                results = engine.scheduler.run(ctx, strategy, state, cohort,
                                               batch_fn)
                up = sum(wire_bytes(r.payload) for r in results)
                state = strategy.aggregate(ctx, state, results)
            log.append((params_to_reference(state), up, down))
        runs.append(log)
    for (a, ua, da), (b, ub, db) in zip(*runs):
        assert (ua, da) == (ub, db)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert np.array_equal(x, y)
