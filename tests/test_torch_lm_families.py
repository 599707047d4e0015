"""The LM runner on the families and heads the FeDepth engine had not run
in the port, vs the reference (PyTorch port).

- m-FeDepth (``head="aux"``: ``aux_norms``, one rms-norm scale per unit,
  into the shared head for every block but the last) on reduced
  mamba2-370m and qwen2-7b, two rounds through the engine
  (``FedepthStrategy(head="aux")`` with ``lm_runner(head="aux")``);
- FeDepth on reduced h2o-danube-3-4b (72-token sequences, past its
  reduced window of 64, so the window is active in training) and
  minicpm-2b (the first dense model with a tied head: ``prefix_stable``
  False), two rounds through the engine;
- the VLM runner on reduced qwen2-vl-2b with stubbed vision embeddings:
  ``head_loss`` slices the prefix off after the norm, and a client
  update; as in the reference, no M-RoPE positions reach the units;
- yi-6b through the runner contract only (its path is qwen2-7b's).

The reference runs with ``kernel_force="ref"``, the port on the CPU;
parameters are the reference's (converted), data from numpy seeds or
the engines' shared seeded streams.  Engine runs use 6 clients at
``fair`` budgets over 72-token sequences with sim seed 1, so that the
cohorts hold a two-block client beside single-block ones.  Tolerances:
server parameters every round atol 1e-4 / rtol 1e-3 (two rounds of fp32
SGD); runner outputs, losses and client updates atol 1e-5 / rtol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.core import blockwise as jbw  # noqa: E402
from repro.core.decomposition import Decomposition  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import blockwise as tbw  # noqa: E402
from repro_torch.core.decomposition import Decomposition as TDec  # noqa: E402
from repro_torch.fl.engine import SimConfig  # noqa: E402
from repro_torch.fl.registry import get_strategy  # noqa: E402
from repro_torch.fl.seq import build_lm_context, build_seq_data  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from torch_helpers import (assert_trees_close, lm_engine_parity,  # noqa: E402,F401
                           one_torch_thread)

ATOL, RTOL = 1e-5, 1e-4
DATA = dict(n_per_client=8, n_test=8, seq_len=72, seed=0)
SIM = dict(rounds=2, participation=0.5, lr=0.05, momentum=0.9,
           local_steps=1, batch_size=4, scenario="fair", seed=1)


def _close(a, b, msg, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


def _host_init(arch):
    jcfg = j_reduced(arch)
    return jcfg, jax.tree.map(np.asarray, jax.jit(j_build(jcfg).init)(
        jax.random.PRNGKey(0)))


def _aux_norms_perturbed(tree):
    """m-FeDepth's aux norms off their ones, so that the intermediate
    exits differ from the final norm from the first step."""
    rng = np.random.default_rng(3)
    out = dict(tree)
    out["aux_norms"] = tree["aux_norms"] + 0.1 * rng.standard_normal(
        tree["aux_norms"].shape).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ["mamba2-370m", "qwen2-7b"])
def test_m_fedepth_two_rounds_match_reference_engine(arch):
    """Two m-FeDepth rounds: the two-block client trains block 0 through
    ``aux_norms[0]`` and block 1 through the final norm; every client's
    payload carries ``aux_norms``, whose last row (the last unit's exit,
    which the final norm serves) is never read."""
    cfg = get_reduced_config(arch)
    ctx, cohorts, (init, final) = lm_engine_parity(
        j_reduced(arch), cfg, "m-fedepth", data=DATA, sim=SIM,
        perturb=_aux_norms_perturbed)
    assert any(ctx.decomps[k].blocks == ((0, 1), (1, 2))
               for ids in cohorts for k in ids)
    # row 0 trains; row 1 only passes through FedAvg's weighted sum of
    # equal copies (fp32 rounding, rtol 1e-6)
    assert float(np.abs(final["aux_norms"][0]
                        - init["aux_norms"][0]).max()) > 1e-4
    np.testing.assert_allclose(final["aux_norms"][1], init["aux_norms"][1],
                               rtol=1e-6, atol=0)
    # the strategy's own init adds the aux norms, ones, fp32
    strategy = get_strategy("m-fedepth")
    strategy.setup(ctx)
    state = strategy.init_state(ctx)
    assert state["aux_norms"].shape == (2, cfg.d_model)
    assert state["aux_norms"].dtype == torch.float32
    assert bool((state["aux_norms"] == 1).all())


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "minicpm-2b"])
def test_fedepth_two_rounds_match_reference_engine(arch):
    """Two FeDepth rounds of the first dense configs after qwen2-7b:
    danube's sliding window below the sequence length, minicpm's tied
    head (re-buffered prefix)."""
    cfg = get_reduced_config(arch)
    assert DATA["seq_len"] > (cfg.sliding_window or 0)
    runner = tbw.lm_runner(build(cfg))
    assert runner.prefix_stable == (not cfg.tie_embeddings)
    lm_engine_parity(j_reduced(arch), cfg, "fedepth", data=DATA, sim=SIM)


def _vlm_batches(cfg, n=2):
    rng = np.random.default_rng(5)
    P = cfg.frontend_embed_tokens
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "vision_embeds": rng.standard_normal(
                        (2, P, cfg.d_model)).astype(np.float32)})
    out[0]["labels"][0, :2] = -100
    return out, [{k: torch.tensor(v, dtype=torch.int64 if v.dtype ==
                                  np.int32 else torch.float32)
                  for k, v in b.items()} for b in out]


def test_vlm_runner_matches_reference():
    """qwen2-vl with a vision prefix: embed ([vision; text]), every
    [lo, hi), head_loss (no loss on the prefix) and a two-block client
    update agree with the reference runner, which passes no M-RoPE
    positions (1-D RoPE over the whole sequence)."""
    arch = "qwen2-vl-2b"
    jcfg, jparams = _host_init(arch)
    cfg = get_reduced_config(arch)
    jlm = j_build(jcfg)
    jr = jbw.lm_runner(jlm, kernel_force="ref")
    tr = tbw.lm_runner(build(cfg))
    assert (tr.n_units, tr.prefix_stable, tr.family) == \
        (jr.n_units, jr.prefix_stable, "vlm")
    params = params_from_reference(jparams, device="cpu")
    jbs, tbs = _vlm_batches(cfg)
    z0_j = jr.embed(jparams, jbs[0])
    z0 = tr.embed(params, tbs[0])
    assert z0.shape[1] == cfg.frontend_embed_tokens + 9
    _close(z0, z0_j, "embed", atol=0, rtol=0)
    for lo, hi in ((0, 1), (1, 2), (0, 2)):
        z_in = jr.apply_units(jparams, z0_j, 0, lo) if lo else z0_j
        _close(tr.apply_units(params, torch.tensor(np.asarray(z_in)), lo,
                              hi),
               jr.apply_units(jparams, z_in, lo, hi), f"[{lo}, {hi})")
    z2 = jr.apply_units(jparams, z0_j, 0, 2)
    for idx in (0, 1):
        _close(tr.head_loss(params, torch.tensor(np.asarray(z2)), tbs[0],
                            idx).item(),
               jr.head_loss(jparams, z2, jbs[0], idx), f"head_loss {idx}")

    blocks = ((0, 1), (1, 2))
    kw = dict(lr=0.05, momentum=0.9, local_steps=1)
    jout = jbw.client_update(jr, jax.tree.map(jnp.asarray, jparams),
                             Decomposition(blocks, 0, 0), jbs, **kw)
    out = tbw.client_update(tr, params, TDec(blocks, 0, 0), tbs, **kw)
    assert_trees_close(params_to_reference(out),
                       jax.tree.map(np.asarray, jout), "vlm client update",
                       atol=ATOL, rtol=RTOL)


def test_yi_runner_contract_matches_reference():
    """yi-6b (group of 8 heads; its path is qwen2-7b's): embed and every
    [lo, hi), head_loss, range composition, ``merge(split)`` the identity
    sharing every tensor, and split's keys as the reference's."""
    arch = "yi-6b"
    jcfg, jparams = _host_init(arch)
    cfg = get_reduced_config(arch)
    jr = jbw.lm_runner(j_build(jcfg), kernel_force="ref")
    tr = tbw.lm_runner(build(cfg))
    assert (tr.n_units, tr.prefix_stable) == (jr.n_units, jr.prefix_stable)
    params = params_from_reference(jparams, device="cpu")
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tb = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in jb.items()}
    z0 = tr.embed(params, tb)
    full = tr.apply_units(params, z0, 0, 2)
    _close(tr.apply_units(params, tr.apply_units(params, z0, 0, 1), 1, 2),
           full, "range composition", atol=0, rtol=0)
    _close(full, jr.apply_units(jparams, jr.embed(jparams, jb), 0, 2),
           "apply_units [0, 2)")
    _close(tr.head_loss(params, full, tb, 1).item(),
           jr.head_loss(jparams, np.asarray(full), jb, 1), "head_loss")
    for lo, hi in ((0, 1), (1, 2), (0, 2)):
        split = tr.split(params, lo, hi)
        assert set(split) == set(jr.split(jparams, lo, hi))
        assert all(a is b for a, b in zip(
            tree_leaves(tr.merge(params, split, lo=lo, hi=hi)),
            tree_leaves(params)))
    fresh = tree_map(torch.clone, tr.split(params, 1, 2))
    merged = tr.merge(params, fresh, lo=1, hi=2)
    assert merged["units"][0] is params["units"][0]
    assert merged["units"][1] is fresh["units"][0]


def test_lm_context_prices_every_new_family():
    """``build_lm_context`` prices the hybrid and the dense configs with
    ``lm_memory`` as the reference does (same decompositions), on the
    CPU."""
    from repro.fl.engine import SimConfig as JSim
    from repro.fl.seq import build_lm_context as j_context
    from repro.fl.seq import build_seq_data as j_data
    for arch in ("zamba2-1.2b", "h2o-danube-3-4b", "minicpm-2b",
                 "qwen2-vl-2b", "yi-6b"):
        cfg = get_reduced_config(arch)
        ctx = build_lm_context(build_seq_data(6, vocab_size=cfg.vocab_size,
                                              device="cpu", **DATA),
                               SimConfig(**SIM), cfg, device="cpu")
        jctx = j_context(j_data(6, vocab_size=cfg.vocab_size, **DATA),
                         JSim(**SIM), j_reduced(arch))
        assert [d.blocks for d in ctx.decomps] == \
            [d.blocks for d in jctx.decomps], arch
        assert [d.skipped_prefix for d in ctx.decomps] == \
            [d.skipped_prefix for d in jctx.decomps], arch
