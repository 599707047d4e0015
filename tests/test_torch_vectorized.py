"""Vectorized cohort execution in the port: grouping, fallbacks and
scheduler equivalence (port of ``tests/test_vectorized.py``).

The contract: the choice of scheduler changes the wall clock, never the
experiment — the same batches drawn from the shared stream, the same
aggregated parameters up to float associativity of the stacked
operations (rtol 2e-4, atol 2e-5, the reference's tolerance) and the
same bytes.  The port's sequential scheduler is held to the reference by
the engine parity tests (``test_torch_image_engine.py``,
``test_torch_baseline_engine.py``, ``test_torch_vit.py``), so each run
here compares the port's vectorized scheduler with the port's sequential
one.  ``min_group=1`` routes every client with a key through the stacked
path, singleton groups included.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = pytest.importorskip("torch.nn.functional")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.preresnet20 import reduced as rn_reduced  # noqa: E402
from repro_torch.configs.vit_t16 import reduced as vit_reduced  # noqa: E402
from repro_torch.core import blockwise  # noqa: E402
from repro_torch.core.blockwise import (broadcast_tree, stack_batches,  # noqa: E402
                                        stackable, unstack_tree)
from repro_torch.core.decomposition import Decomposition, decompose  # noqa: E402
from repro_torch.core.memory_model import vit_memory  # noqa: E402
from repro_torch.fl.data import build_federated  # noqa: E402
from repro_torch.fl.engine import RoundEngine, SimConfig, build_context  # noqa: E402
from repro_torch.fl.registry import get_strategy  # noqa: E402
from repro_torch.fl.sampling import (SequentialScheduler,  # noqa: E402
                                     VectorizedScheduler, make_scheduler)
from repro_torch.fl.seq import build_lm_context, build_seq_data  # noqa: E402
from repro_torch.fl.strategies.fedepth import (FedepthStrategy,  # noqa: E402
                                               init_aux_heads)
from repro_torch.fl.strategy import (BatchableFLStrategy,  # noqa: E402
                                     ClientResult, Context)
from repro_torch.models import resnet, vit  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch_helpers import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 2e-4, 2e-5
SIM = dict(rounds=2, participation=0.5, lr=0.05, local_steps=2,
           batch_size=32, seed=0)


@pytest.fixture(scope="module")
def data():
    return build_federated(num_clients=6, alpha=1.0, n_train=240, n_test=80,
                           image_size=16, seed=0, device="cpu")


def _vit_context(data, sim):
    """A generic FeDepth context on the reduced ViT: clients with one,
    two and four blocks and one that skips the first unit."""
    cfg = vit_reduced(num_classes=10)
    mem = vit_memory(cfg, sim.batch_size)
    u0, u1 = mem.block_train_bytes(0, 1), mem.block_train_bytes(1, 2)
    budgets = [mem.block_train_bytes(0, 4), mem.block_train_bytes(0, 2),
               u0, (u0 + u1) // 2] * 2
    n = len(data.client_indices)
    return Context(sim=sim, num_clients=n, sizes=data.client_sizes(),
                   rng=np.random.default_rng(sim.seed), seed=0,
                   device=torch.device("cpu"), model_cfg=cfg, mem=mem,
                   decomps=[decompose(mem, b) for b in budgets[:n]],
                   data=data)


def _run(method, data, scheduler, scenario, seed=0):
    sim = SimConfig(scenario=scenario, **{**SIM, "seed": seed})
    if method == "vit-fedepth":
        ctx = _vit_context(data, sim)
        strategy = FedepthStrategy(runner=blockwise.vit_runner(ctx.model_cfg))
    else:
        ctx = build_context(data, sim, model_cfg=rn_reduced(10, 16),
                            device="cpu")
        strategy = get_strategy(method)
    engine = RoundEngine(strategy, ctx, scheduler=scheduler)
    cohorts = []
    sample = engine.sampler.sample

    def recording(c, rd):
        ids = sample(c, rd)
        cohorts.extend(int(k) for k in ids)
        return ids

    engine.sampler.sample = recording
    calls = []
    update_batched = getattr(strategy, "client_update_batched", None)
    if update_batched is not None:
        def counting(c, state, ids, batches):
            calls.append(tuple(ids))
            return update_batched(c, state, ids, batches)
        strategy.client_update_batched = counting
    state, history = engine.run(eval_every=SIM["rounds"])
    return state, history, ctx, cohorts, calls


@pytest.mark.parametrize("method,scenario,seed", [
    ("fedavg", "fair", 0), ("fedepth", "lack", 0),
    # this 6-client run has one r = 2 client; seed 2 draws it twice
    ("fedepth", "surplus", 2),
    ("heterofl", "fair", 0), ("m-fedepth", "fair", 0),
    ("vit-fedepth", "fair", 0)])
def test_scheduler_equivalence(data, method, scenario, seed):
    """Sequential vs vectorized: the same cohorts, final states within
    rtol 2e-4 / atol 2e-5, the same up and down bytes.  ``lack`` puts
    clients below the finest block (prefix-skipping decompositions);
    under ``surplus`` the MKD clients fall back to their own updates;
    HeteroFL slices once per ratio and prices each ratio's bytes from
    its cache."""
    s_seq, h_seq, ctx, c_seq, _ = _run(method, data, "sequential", scenario,
                                       seed)
    s_vec, h_vec, _, c_vec, calls = _run(
        method, data, VectorizedScheduler(min_group=1), scenario, seed)
    assert c_seq == c_vec
    assert calls, "no group took the stacked path"
    stacked = [k for ids in calls for k in ids]
    if method.endswith("fedepth") and scenario == "fair":
        assert any(len(ctx.decomps[k].blocks) >= 2 for k in stacked)
    if scenario == "lack":
        assert any(ctx.decomps[k].skipped_prefix for k in stacked)
    if scenario == "surplus":
        mkd = [k for k in c_seq if ctx.surplus[k] > 1]
        assert mkd and not set(mkd) & set(stacked)
    else:
        assert sorted(stacked) == sorted(c_seq)
    la, lb = tree_leaves(s_seq), tree_leaves(s_vec)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
    assert [r.comm_bytes for r in h_seq] == [r.comm_bytes for r in h_vec]
    assert [r.down_bytes for r in h_seq] == [r.down_bytes for r in h_vec]
    assert [r.round for r in h_seq] == [r.round for r in h_vec]


def _image_batch(cfg, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return {"images": torch.randn(n, cfg.image_size, cfg.image_size, 3,
                                  generator=gen),
            "labels": torch.randint(0, cfg.num_classes, (n,), generator=gen)}


def _image_setup(family):
    if family == "vit":
        cfg = vit_reduced(num_classes=4)
        return cfg, blockwise.vit_runner(cfg), vit.init(1, cfg, device="cpu")
    cfg = rn_reduced(num_classes=4, image_size=8)
    params = resnet.init(1, cfg, device="cpu")
    if family == "resnet-aux":
        params["aux_heads"] = init_aux_heads(
            cfg, torch.Generator().manual_seed(2), device="cpu")
        return cfg, blockwise.resnet_runner(cfg, "aux"), params
    return cfg, blockwise.resnet_runner(cfg), params


KINK = 1e-6     # ReLU inputs closer to 0 than this count as at the kink
BATCH_SEED = 0


@contextlib.contextmanager
def _smallest_relu_input(monkeypatch):
    """Record the smallest nonzero |input| of every ReLU the block yields
    to (PreResNet's; ViT has none).  Exact zeros (the skip head's
    zero-padded channels) take the same branch on both paths."""
    relu, smallest = F.relu, [float("inf")]

    def recording(x, *args, **kw):
        mag = x.detach().abs()
        if bool((mag > 0).any()):
            smallest[0] = min(smallest[0], float(mag[mag > 0].min()))
        return relu(x, *args, **kw)

    with monkeypatch.context() as m:
        m.setattr(F, "relu", recording)
        yield smallest


@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
@pytest.mark.parametrize("blocks", [((0, 1), (1, 3)), ((1, 2), (2, 3))])
@pytest.mark.parametrize("family", ["resnet", "resnet-aux", "vit"])
def test_client_update_batched_matches_client_update(family, blocks,
                                                     prox_mu, monkeypatch):
    """Three clients as one stacked update equal three ``client_update``
    calls (momentum and the FedProx anchor reset per block, the steps in
    ``for local_steps: for batch`` order), with the prefix cache on and
    off; cached equals recompute; the given tree is never written; the
    embedding at ``lo == 0`` gets a zero gradient, as on the sequential
    path, so it comes back unchanged."""
    cfg, runner, params = _image_setup(family)
    dec = Decomposition(blocks, blocks[0][0], 0)
    bpc = [[_image_batch(cfg, 2, BATCH_SEED + 10 * c + i) for i in range(2)]
           for c in range(3)]
    snapshot = [t.clone() for t in tree_leaves(params)]
    kw = dict(lr=0.05, momentum=0.9, local_steps=2, prox_mu=prox_mu)
    outs = {}
    for pc in (True, False):
        with _smallest_relu_input(monkeypatch) as smallest:
            seq = [blockwise.client_update(runner, params, dec, b,
                                           prefix_cache=pc, **kw)
                   for b in bpc]
        # a ReLU input within fp32 rounding of 0 may take the other
        # branch on the stacked path (a kink, not a fault): such inputs
        # would need other batches
        assert smallest[0] > KINK, f"ReLU input {smallest[0]:.1e} at a kink"
        vec = blockwise.client_update_batched(runner, params, dec, bpc,
                                              prefix_cache=pc, **kw)
        assert len(vec) == 3
        for s, v in zip(seq, vec):
            for a, b in zip(tree_leaves(s), tree_leaves(v)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                           atol=ATOL)
        outs[pc] = vec
    for v1, v2 in zip(outs[True], outs[False]):
        for a, b in zip(tree_leaves(v1), tree_leaves(v2)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 snapshot))
    embed = "patch_embed" if family == "vit" else "stem"
    assert all(torch.equal(v[embed], params[embed]) for v in outs[True])
    moved = max(float((a - b).abs().max()) for v in outs[True]
                for a, b in zip(tree_leaves(v), tree_leaves(params)))
    assert moved > 1e-3


@pytest.mark.parametrize("family", ["resnet", "vit"])
def test_client_update_batched_float64_matches_to_rounding(family):
    """In float64 (the norms, the CE and the softmax follow the input's
    dtype) no input lies within rounding of a ReLU kink, and the stacked
    update equals the per-client one to float64 rounding."""
    cfg, runner, params = _image_setup(family)
    params = tree_map(lambda t: t.double(), params)
    bpc = [[{k: v.double() if v.is_floating_point() else v
             for k, v in _image_batch(cfg, 2, 50 + 10 * c + i).items()}
            for i in range(2)] for c in range(3)]
    dec = Decomposition(((0, 1), (1, 3)), 0, 0)
    kw = dict(lr=0.05, momentum=0.9, local_steps=2)
    seq = [blockwise.client_update(runner, params, dec, b, **kw)
           for b in bpc]
    vec = blockwise.client_update_batched(runner, params, dec, bpc, **kw)
    for s, v in zip(seq, vec):
        for a, b in zip(tree_leaves(s), tree_leaves(v)):
            assert a.dtype == b.dtype == torch.float64
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12)


def _lm_batch(cfg, gen):
    """One LM batch of 2 x 8 tokens (whisper's with its frames)."""
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["encoder_embeds"] = torch.randn(
            2, cfg.max_source_positions, cfg.d_model, generator=gen)
    return batch


LM_ARCHS = ("qwen2-7b", "qwen2-vl-2b", "qwen3-moe-235b-a22b",
            "llama4-maverick-400b-a17b", "mamba2-370m", "rwkv6-7b",
            "zamba2-1.2b", "whisper-small")


@pytest.mark.parametrize("arch,head", [
    pytest.param(a, "skip", id=a) for a in LM_ARCHS] + [
    pytest.param(a, "aux", id=f"{a}-aux") for a in LM_ARCHS
    if a != "whisper-small"])   # whisper's runner takes the skip head only
def test_lm_runner_raises_under_vectorized(arch, head):
    """The stacked path once raised on every LM runner; now each family's
    K1–K4 run under ``vmap(grad)`` through their vmap rules.  Three
    clients of a reduced LM as one stacked update equal three
    ``client_update`` calls within the vectorized tolerance: dense,
    vlm, moe (qwen3-moe; llama4's interleaved dense + MoE unit), ssm
    (mamba2's tied head, rwkv6), hybrid (zamba2) and whisper at runner
    level (z the ``{"enc", "dec"}`` pair), under FeDepth's skip head and
    m-FeDepth's ``aux_norms``; two blocks wherever the model has two
    units; the given tree is not written, and the update moves it."""
    from repro_torch.models import build
    cfg = get_reduced_config(arch)
    lm = build(cfg)
    params = lm.init(0, device="cpu")
    if head == "aux":
        params["aux_norms"] = 1.0 + 0.1 * torch.randn(
            lm.num_depth_units, cfg.d_model,
            generator=torch.Generator().manual_seed(1))
    runner = blockwise.lm_runner(lm, head=head)
    n = runner.n_units
    dec = Decomposition(((0, 1), (1, n)) if n > 1 else ((0, 1),), 0, 0)
    gen = torch.Generator().manual_seed(0)
    bpc = [[_lm_batch(cfg, gen) for _ in range(2)] for _ in range(3)]
    snapshot = [t.clone() for t in tree_leaves(params)]
    kw = dict(lr=0.05, momentum=0.9, local_steps=1)
    seq = [blockwise.client_update(runner, params, dec, b, **kw)
           for b in bpc]
    vec = blockwise.client_update_batched(runner, params, dec, bpc, **kw)
    assert len(vec) == 3
    for s, v in zip(seq, vec):
        for a, b in zip(tree_leaves(s), tree_leaves(v)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL,
                                       atol=ATOL)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 snapshot))
    moved = max(float((a - b).abs().max()) for v in vec
                for a, b in zip(tree_leaves(v), tree_leaves(params)))
    assert moved > 1e-3


# -------------------------------------------------- grouping and fallbacks
class _Recorder:
    """Batchable stub: group key = client id parity, payload = marker."""

    def __init__(self, key_fn=None):
        self.sequential_calls = []
        self.batched_calls = []
        self.key_fn = key_fn or (lambda cid: cid % 2)

    def client_group_key(self, ctx, client_id):
        return self.key_fn(client_id)

    def client_update(self, ctx, state, client_id, batches):
        self.sequential_calls.append(client_id)
        return ClientResult(torch.zeros(1), 1.0, comm_bytes=0)

    def client_update_batched(self, ctx, state, client_ids, batches):
        self.batched_calls.append(tuple(client_ids))
        return [ClientResult(torch.zeros(1), 1.0, comm_bytes=0)
                for _ in client_ids]


def _stub_ctx(num_clients=8):
    return Context(sim=SimConfig(participation=0.5), num_clients=num_clients,
                   sizes=np.ones(num_clients), rng=np.random.default_rng(0),
                   seed=0, device=torch.device("cpu"))


def _batch_fn(k):
    return [{"x": torch.zeros(4, 2)}]


def test_vectorized_groups_by_key():
    strat = _Recorder()
    out = VectorizedScheduler().run(_stub_ctx(), strat, None,
                                    [0, 1, 2, 3, 4], _batch_fn)
    assert len(out) == 5
    assert sorted(strat.batched_calls) == [(0, 2, 4), (1, 3)]
    assert strat.sequential_calls == []


def test_vectorized_min_group_falls_back():
    strat = _Recorder()
    VectorizedScheduler(min_group=3).run(_stub_ctx(), strat, None,
                                         [0, 1, 2, 3, 4], _batch_fn)
    assert strat.batched_calls == [(0, 2, 4)]    # evens reach min_group
    assert strat.sequential_calls == [1, 3]


def test_vectorized_none_key_falls_back():
    strat = _Recorder(key_fn=lambda cid: None if cid == 2 else "g")
    VectorizedScheduler().run(_stub_ctx(), strat, None, [0, 1, 2, 3],
                              _batch_fn)
    assert strat.batched_calls == [(0, 1, 3)]
    assert strat.sequential_calls == [2]


def test_vectorized_ragged_batches_fall_back():
    strat = _Recorder(key_fn=lambda cid: "g")

    def ragged(k):   # client 1's batch shape differs -> not stackable
        return [{"x": torch.zeros(8 if k == 1 else 4, 2)}]

    VectorizedScheduler().run(_stub_ctx(), strat, None, [0, 1, 2], ragged)
    assert strat.batched_calls == []
    assert sorted(strat.sequential_calls) == [0, 1, 2]


def test_vectorized_delegates_plain_strategies_wholesale():
    calls = []

    class Plain:
        def client_update(self, ctx, state, client_id, batches):
            calls.append(client_id)
            return ClientResult(torch.zeros(1), 1.0, comm_bytes=0)

    def batch_fn(k):     # the batches are drawn right before each update
        calls.append(("drawn", k))
        return _batch_fn(k)

    out = VectorizedScheduler().run(_stub_ctx(), Plain(), None, [3, 1, 2],
                                    batch_fn)
    assert calls == [("drawn", 3), 3, ("drawn", 1), 1, ("drawn", 2), 2]
    assert len(out) == 3


def test_vectorized_draws_batches_up_front_in_cohort_order():
    order = []
    strat = _Recorder()
    VectorizedScheduler().run(_stub_ctx(), strat, None, [4, 1, 2, 3],
                              lambda k: order.append(k) or _batch_fn(k))
    assert order == [4, 1, 2, 3]


def test_results_in_cohort_order():
    class Tagger(_Recorder):
        def client_update_batched(self, ctx, state, client_ids, batches):
            return [ClientResult(torch.full((1,), cid), 1.0, comm_bytes=0)
                    for cid in client_ids]

    out = VectorizedScheduler().run(_stub_ctx(), Tagger(), None,
                                    [4, 1, 2, 3], _batch_fn)
    assert [int(r.payload[0]) for r in out] == [4, 1, 2, 3]


# ------------------------------------------------------------- plumbing
def test_make_scheduler_resolution():
    assert isinstance(make_scheduler(None), SequentialScheduler)
    assert isinstance(make_scheduler("sequential"), SequentialScheduler)
    assert isinstance(make_scheduler("vectorized"), VectorizedScheduler)
    assert make_scheduler("vectorized").min_group == 2
    inst = VectorizedScheduler(min_group=3)
    assert make_scheduler(inst) is inst
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_scheduler("async")
    from repro_torch.fl.scale import ShardedScheduler
    assert isinstance(make_scheduler("sharded"), ShardedScheduler)


def test_engine_accepts_scheduler_name():
    engine = RoundEngine(get_strategy("fedavg"), _stub_ctx(),
                         scheduler="vectorized")
    assert isinstance(engine.scheduler, VectorizedScheduler)
    assert isinstance(RoundEngine(get_strategy("fedavg"),
                                  _stub_ctx()).scheduler, SequentialScheduler)
    assert isinstance(get_strategy("fedepth"), BatchableFLStrategy)
    assert not isinstance(get_strategy("splitmix"), BatchableFLStrategy)


# ------------------------------------------------------- stacking helpers
def test_stack_helpers_round_trip():
    batches = [[{"x": torch.arange(6.0).reshape(2, 3) + k}] for k in range(3)]
    assert stackable(batches)
    stacked = stack_batches(batches)
    assert stacked["x"].shape == (3, 1, 2, 3)   # (clients, batches, ...)
    assert torch.equal(stacked["x"][2, 0], batches[2][0]["x"])
    tree = {"w": torch.ones(2, 2), "blocks": [{"b": torch.arange(3.0)}]}
    stacked = broadcast_tree(tree, 4)
    assert stacked["w"].shape == (4, 2, 2)
    stacked["w"][1].add_(1.0)          # private copies, not views
    assert torch.equal(tree["w"], torch.ones(2, 2))
    parts = unstack_tree(stacked, 4)
    assert len(parts) == 4
    assert torch.equal(parts[2]["w"], tree["w"])
    assert torch.equal(parts[3]["blocks"][0]["b"], tree["blocks"][0]["b"])


def test_stackable_rejects_mismatched_shapes_dtypes_and_counts():
    a = [{"x": torch.zeros(2, 3)}]
    b = [{"x": torch.zeros(2, 4)}]
    c = [{"x": torch.zeros(2, 3, dtype=torch.float64)}]
    assert not stackable([a, b])
    assert not stackable([a, c])
    assert not stackable([a, a + a])
    assert stackable([a, [{"x": torch.ones(2, 3)}]])
