"""Port FeDepth round engine vs the reference engine (PyTorch port).

Two FeDepth rounds over the synthetic noisy-successor LM task on each
ported family, reduced and cut to 4 layers: the dense qwen2-7b and the
attention-free mamba2-370m (tied head) and rwkv6-7b (6 clients,
participation 0.5, fair budgets: multi-block and partial-training clients
in the cohorts).  Both engines
start from the reference's initial parameters (converted) and draw from
``np.random.default_rng(seed)`` in the same order, so cohort ids and
batches must be identical; server parameters agree every round within
atol 1e-4, rtol 1e-3, and so do the evaluations.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.fl.engine import RoundEngine, SimConfig  # noqa: E402
from repro_torch.fl.registry import get_strategy  # noqa: E402
from repro_torch.fl.seq import build_lm_context, build_seq_data  # noqa: E402

from repro_torch.tree import tree_leaves  # noqa: E402
from torch_helpers import lm_engine_parity  # noqa: E402

SIM = dict(rounds=2, participation=0.5, lr=0.05, momentum=0.9,
           local_steps=1, batch_size=4, scenario="fair", seed=0)
DATA = dict(n_per_client=12, n_test=16, seq_len=16, seed=0)


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-370m", "rwkv6-7b"])
def test_two_rounds_match_reference_engine(arch):
    jcfg = dataclasses.replace(j_reduced(arch), num_layers=4)
    cfg = dataclasses.replace(get_reduced_config(arch), num_layers=4)
    lm_engine_parity(jcfg, cfg, "fedepth", data=DATA, sim=SIM)


@pytest.mark.parametrize("knob", [
    dict(scheduler="sharded"), dict(obs="on"), dict(obs=True),
    dict(history_sink="history.jsonl"), dict(history_sink=object())])
def test_unported_engine_knobs_raise(knob, tmp_path):
    """The knobs of the scale and telemetry layers, once refused, are
    ported: the sharded scheduler runs an LM runner's rounds (its
    stacked group update, as the vectorized one does, launching each
    kernel once a group), a path sink is the engine's own, and a capture
    turns telemetry on.  What raises is what the reference raises too:
    a history sink that is neither a sink nor a path."""
    cfg = get_reduced_config("qwen2-7b")
    ctx = build_lm_context(build_seq_data(4, vocab_size=cfg.vocab_size,
                                          device="cpu", **DATA),
                           SimConfig(**SIM), cfg, device="cpu")
    if "history_sink" in knob and isinstance(knob["history_sink"], str):
        knob = dict(history_sink=str(tmp_path / knob["history_sink"]))
    if knob.get("scheduler") == "sharded":
        from repro_torch.fl.scale import ShardedScheduler
        engine = RoundEngine(get_strategy("fedepth"), ctx,
                             scheduler=ShardedScheduler(min_group=1,
                                                        mesh=["cpu"]))
        state, history = engine.run()
        assert history[-1].round == SIM["rounds"]
        assert all(bool(torch.isfinite(t).all())
                   for t in tree_leaves(state))
    elif "obs" in knob:
        assert RoundEngine(get_strategy("fedepth"), ctx,
                           **knob).obs is not None
    elif isinstance(knob["history_sink"], str):
        engine = RoundEngine(get_strategy("fedepth"), ctx, **knob)
        assert engine._owns_sink and engine.history_sink.path == \
            knob["history_sink"]
        engine.history_sink.close()
    else:
        with pytest.raises(TypeError):
            RoundEngine(get_strategy("fedepth"), ctx, **knob)
