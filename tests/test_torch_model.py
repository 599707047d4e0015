"""Port model, runner and memory model vs the reference (PyTorch port).

Reduced qwen2-7b (2 layers, d_model 128, 4 q / 2 kv heads, vocab 512):
the reference's parameters, converted with ``repro_torch.testing.convert``,
and numpy-made batches go through ``repro.models`` (jnp oracle kernels)
and ``repro_torch.models`` on the CPU.  Losses, hidden states and
gradients agree within atol 1e-5, rtol 1e-4 (fp32, different summation
order).  The memory model and decomposition are pure Python copies and
must agree exactly, on every architecture the reference prices.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import all_configs as j_all_configs  # noqa: E402
from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.core import blockwise as jbw  # noqa: E402
from repro.core.decomposition import decompose as j_decompose  # noqa: E402
from repro.core.memory_model import lm_memory as j_lm_memory  # noqa: E402
from repro.fl.engine import client_ratios as j_ratios  # noqa: E402
from repro.fl.engine import scenario_budgets as j_budgets  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import blockwise as tbw  # noqa: E402
from repro_torch.core.decomposition import decompose  # noqa: E402
from repro_torch.core.memory_model import lm_memory  # noqa: E402
from repro_torch.fl.engine import scenario_budgets  # noqa: E402
from repro_torch.models import build, common  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4


def _close(a, b, msg, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    jcfg = j_reduced("qwen2-7b")
    cfg = get_reduced_config("qwen2-7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = j_build(jcfg).init(jax.random.PRNGKey(0))
    # non-trivial qkv biases and norm scales so the checks see them
    rng = np.random.default_rng(1)

    def perturb(path, a):
        name = jax.tree_util.keystr(path[-1:])
        if name in ("['bq']", "['bk']", "['bv']") or "norm" in name:
            return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    jparams = jax.tree_util.tree_map_with_path(perturb, jparams)
    params = params_from_reference(_np_tree(jparams), device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    labels[0, :3] = -100
    batch_np = {"tokens": toks, "labels": labels}
    batch_t = {k: torch.as_tensor(v, dtype=torch.int64)
               for k, v in batch_np.items()}
    return jcfg, cfg, jparams, params, batch_np, batch_t


def test_common_blocks_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = (np.arange(5, dtype=np.int32)[None] + np.array([[0], [7]])
           ).astype(np.int32)
    _close(common.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6),
           jcommon.rms_norm(x, w, 1e-6), "rms_norm")
    _close(common.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6),
           jcommon.apply_rope(x, pos, 1e6), "apply_rope")
    h = rng.standard_normal((4, 8)).astype(np.float32)
    wg, wu = (rng.standard_normal((8, 12)).astype(np.float32)
              for _ in range(2))
    wd = rng.standard_normal((12, 8)).astype(np.float32)
    _close(common.swiglu(*map(torch.tensor, (h, wg, wu, wd))),
           jcommon.swiglu(h, wg, wu, wd), "swiglu")
    _close(common.causal_positions(2, 4, 3).numpy(),
           jcommon.causal_positions(2, 4, 3), "positions", atol=0, rtol=0)


def test_loss_and_gradients_match_reference(model):
    jcfg, cfg, jparams, params, batch_np, batch_t = model
    jlm = j_build(jcfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, batch_np, kernel_force="ref"),
        has_aux=True)(jparams)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, met = build(cfg).loss_fn(params, batch_t)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    assert int(met["n_tokens"]) == int(jmet["n_tokens"]) == 21
    _close(loss.item(), jloss, "loss")
    by_id = {id(t): g for t, g in zip(leaves, grads)}
    grad_tree = params_to_reference(tree_map(lambda t: by_id[id(t)],
                                             params))
    flat_t = jax.tree_util.tree_flatten_with_path(grad_tree)[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(_np_tree(jgrads))[0])
    assert len(flat_t) == len(flat_j)
    for path, g in flat_t:
        _close(g, flat_j[path], f"grad {jax.tree_util.keystr(path)}",
               atol=1e-5, rtol=1e-4)


def test_runner_contract_matches_reference(model):
    """embed / apply_units / head_loss agree with the reference runner;
    split takes [lo, hi) + head (+ embed at lo == 0) by reference; merge
    replaces exactly [lo, hi) and shares every other tensor."""
    jcfg, cfg, jparams, params, batch_np, batch_t = model
    jr = jbw.lm_runner(j_build(jcfg), kernel_force="ref")
    tr = tbw.lm_runner(build(cfg))
    assert (tr.n_units, tr.prefix_stable) == (jr.n_units, jr.prefix_stable)

    z0_t, z0_j = tr.embed(params, batch_t), jr.embed(jparams, batch_np)
    _close(z0_t, z0_j, "embed", atol=0, rtol=0)
    z2_t = tr.apply_units(params, z0_t, 0, 2)
    _close(z2_t, jr.apply_units(jparams, z0_j, 0, 2), "apply_units")
    z1 = tr.apply_units(params, z0_t, 0, 1)
    _close(tr.apply_units(params, z1, 1, 2), z2_t, "range composition",
           atol=1e-6, rtol=0)
    _close(tr.head_loss(params, z2_t, batch_t, 1).item(),
           jr.head_loss(jparams, jr.apply_units(jparams, z0_j, 0, 2),
                        batch_np, 1), "head_loss")
    _close(tbw.full_model_loss(tr, params, batch_t).item(),
           jbw.full_model_loss(jr, jparams, batch_np), "full_model_loss")

    before = {k: (list(v) if k == "units" else v) for k, v in params.items()}
    for lo, hi in ((0, 1), (1, 2), (0, 2)):
        tsplit, jsplit = tr.split(params, lo, hi), jr.split(jparams, lo, hi)
        assert set(tsplit) == set(jsplit), (lo, hi)
        assert len(tsplit["units"]) == hi - lo
        for i, layer in enumerate(tsplit["units"]):
            assert layer is params["units"][lo + i]
        assert ("embed" in tsplit) == (lo == 0)
        fresh = {k: v for k, v in tsplit.items() if k != "units"}
        fresh["units"] = [dict(u) for u in tsplit["units"]]
        fresh = {k: (v if k == "units" else v.clone())
                 for k, v in fresh.items()}
        merged = tr.merge(params, fresh, lo=lo, hi=hi)
        for i, layer in enumerate(merged["units"]):
            same = layer is params["units"][i]
            assert same == (not lo <= i < hi), (lo, hi, i)
        for k in params:
            if k != "units":
                assert (merged[k] is params[k]) == (k not in fresh), k
    assert all(a is b for a, b in zip(params["units"], before["units"]))
    assert all(params[k] is before[k] for k in params if k != "units")


@pytest.mark.parametrize("arch", sorted(j_all_configs()))
def test_lm_memory_matches_reference(arch):
    """The copied memory model prices every reference architecture
    exactly as the reference does, and decomposes the same way."""
    jcfg = j_all_configs()[arch]
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    for batch, seq in ((4, 256), (128, 16)):
        jm, tm = j_lm_memory(jcfg, batch, seq), lm_memory(cfg, batch, seq)
        assert dataclasses.astuple(tm) == dataclasses.astuple(jm)
        ratios = j_ratios(6, "lack", 0)
        budgets = j_budgets(jm, ratios)
        assert np.array_equal(budgets, scenario_budgets(tm, ratios))
        for b in budgets:
            assert dataclasses.astuple(decompose(tm, int(b))) == \
                dataclasses.astuple(j_decompose(jm, int(b)))


def test_full_width_slice_decomposes_into_blocks():
    """The chip slice (qwen2-7b, every width published, 4 layers, fair
    scenario, 6 clients, seq 256) gives multi-block clients, so the
    prefix-advance path runs on the card."""
    from repro_torch.configs import get_config
    from repro_torch.fl.engine import client_ratios
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=4)
    mem = lm_memory(cfg, 128, 256)
    decs = [decompose(mem, int(b))
            for b in scenario_budgets(mem, client_ratios(6, "fair", 0))]
    assert max(d.num_blocks for d in decs) >= 2
    assert all(d.blocks[-1][1] == 4 for d in decs)
    assert abs(cfg.param_count() / 1e9 - 2.02) < 0.01
