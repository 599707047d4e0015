"""The sequence family across the port's engines and strategies (the
port's twin of tests/test_seq_fl.py's engine matrix and its mamba2
learning target).

Reduced mamba2 (its 2 layers) over ``build_seq_data(4, n_per_client=16,
n_test=32, vocab_size=32, seq_len=12)``, 2 rounds at participation 0.5:
DepthFL's fixed-depth prefix, m-FeDepth, FeDepth under the vectorized
scheduler (``RoundEngine(..., scheduler="vectorized")``: the cohort's
groups stacked under ``vmap(grad)`` on both sides) and FeDepth under the
event-driven ``AsyncEngine`` (async mode over ``profiles_for_ratios``)
each run through the port and through the reference
(``kernel_force="ref"``) from the same initial parameters: the same
bytes, sim seconds and (async) event trace, accuracies within one test
token, final parameters within atol 1e-4 / rtol 1e-3.

Then reduced mamba2 federated depth-wise learns: the mean of the last
three evaluations is above 0.5 (the reference's threshold and seed;
chance is 1/32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.fl import systime as J  # noqa: E402
from repro.fl.engine import RoundEngine as JEngine  # noqa: E402
from repro.fl.engine import SimConfig as JSim  # noqa: E402
from repro.fl.registry import get_strategy as j_get_strategy  # noqa: E402
from repro.fl.seq import build_lm_context as j_context  # noqa: E402
from repro.fl.seq import build_seq_data as j_data  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.fl import systime as T  # noqa: E402
from repro_torch.fl.engine import RoundEngine, SimConfig  # noqa: E402
from repro_torch.fl.registry import get_strategy  # noqa: E402
from repro_torch.fl.seq import build_lm_context, build_seq_data  # noqa: E402
from repro_torch.testing.convert import params_to_reference  # noqa: E402
from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

ARCH = "mamba2-370m"
DATA = dict(n_per_client=16, n_test=32, vocab_size=32, seq_len=12, seed=0)
SIM = dict(rounds=2, participation=0.5, lr=0.1, local_steps=1,
           batch_size=8, scenario="fair", seed=0)


def _engines(method, engine):
    """(port engine, reference engine) of one matrix row, fresh
    contexts.  The vectorized row takes every client each round, so that
    the three clients sharing a decomposition stack."""
    sim = dict(SIM, participation=1.0) if engine == "vectorized" else SIM
    ctx = build_lm_context(build_seq_data(4, device="cpu", **DATA),
                           SimConfig(**sim), get_reduced_config(ARCH),
                           device="cpu")
    jctx = j_context(j_data(4, **DATA), JSim(**sim), j_reduced(ARCH),
                     kernel_force="ref")
    if engine in ("round", "vectorized"):
        kw = dict(scheduler="vectorized") if engine == "vectorized" else {}
        return (RoundEngine(get_strategy(method), ctx, **kw),
                JEngine(j_get_strategy(method), jctx, **kw))
    kw = dict(mode="async", concurrency=2, buffer_size=1)
    return (T.AsyncEngine(get_strategy(method), ctx, system=T.SystemModel(
                T.profiles_for_ratios(ctx.ratios)), **kw),
            J.AsyncEngine(j_get_strategy(method), jctx, system=J.SystemModel(
                J.profiles_for_ratios(jctx.ratios)), **kw))


@pytest.mark.parametrize("method,engine", [
    ("depthfl", "round"), ("m-fedepth", "round"), ("fedepth", "vectorized"),
    ("fedepth", "async")])
def test_engine_matrix_matches_reference(method, engine):
    port, ref = _engines(method, engine)
    strat = port.strategy
    strat.setup(port.ctx)
    init = strat.init_state(port.ctx)
    s_port, h_port = port.run(initial_state=init, eval_every=1)
    s_ref, h_ref = ref.run(initial_state=jax.tree.map(
        jax.numpy.asarray, params_to_reference(init)), eval_every=1)
    assert [(r.round, r.comm_bytes, r.down_bytes, r.sim_seconds)
            for r in h_port] == [(r.round, r.comm_bytes, r.down_bytes,
                                  r.sim_seconds) for r in h_ref]
    assert [r.round for r in h_port] == [1, 2]
    n_test = DATA["n_test"] * DATA["seq_len"]
    for a, b in zip(h_port, h_ref):
        assert 0.0 <= a.accuracy <= 1.0
        assert abs(a.accuracy - b.accuracy) <= 1.0 / n_test
    if engine == "async":
        assert port.trace == ref.trace
        assert h_port[-1].sim_seconds > 0
    assert_trees_close(params_to_reference(s_port),
                       jax.tree.map(np.asarray, s_ref),
                       f"{ARCH} {method} {engine}")


def test_mamba2_learns_through_fedepth():
    """Reduced mamba2 federated depth-wise (8 clients, 10 rounds) beats
    chance (1/32) decisively: the mean of the last three evaluations is
    above 0.5 (the bigram task's Bayes accuracy is ~0.9)."""
    data = build_seq_data(8, n_per_client=64, n_test=128, vocab_size=32,
                          seq_len=16, seed=0, device="cpu")
    sim = SimConfig(rounds=10, participation=0.5, lr=0.3, local_steps=2,
                    batch_size=32, scenario="fair", seed=0)
    ctx = build_lm_context(data, sim, get_reduced_config(ARCH),
                           device="cpu")
    _, history = RoundEngine(get_strategy("fedepth"), ctx).run(eval_every=2)
    accs = [r.accuracy for r in history if r.accuracy is not None]
    assert len(accs) >= 3, history
    assert float(np.mean(accs[-3:])) > 0.5, accs
