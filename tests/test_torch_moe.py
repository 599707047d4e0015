"""The MoE family vs the reference (PyTorch port): qwen3-moe-235b-a22b
(128 experts, top 8; reduced: 4 experts, top 2) and
llama4-maverick-400b-a17b (a dense layer then a MoE layer per unit, top
1 and a shared expert; reduced: 4 experts).

The router's top-k (ties to the lower expert id, as ``jax.lax.top_k``),
``moe.forward`` with and without dropped tokens (a capacity below the
load), both configs' loss (CE + ``router_aux_coef`` x aux) and
gradients, the two-sublayer unit through ``testing.convert``,
``lm_memory``, prefill, and decode at batch 2 (capacity 1 an expert: the
decode drops tokens that the prefill keeps).  The LM runner and the
engine's rounds are in ``test_torch_moe_engine.py``.  The reference runs
with ``kernel_force="ref"``, the port on the CPU; parameters are the
reference's (converted), inputs from numpy seeds.  Tolerances: atol 1e-5
/ rtol 1e-4 (forward, gradients, loss); decode logits atol 1e-4 / rtol
1e-3, as the other families' tests.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.core import memory_model as j_memory  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.core import memory_model  # noqa: E402
from repro_torch.models import build, moe  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves  # noqa: E402

from test_torch_serve import _decode_both, _perturb, models  # noqa: E402,F401
from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]
ATOL, RTOL = 1e-5, 1e-4


def _close(a, b, msg, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


def _four_layers(cfg):
    """llama4's reduced config has one unit of 2 layers: 4 layers give
    the runner and the engine two units."""
    return dataclasses.replace(cfg, num_layers=4) \
        if cfg.moe_every > 1 else cfg


@pytest.fixture(scope="module")
def setup():
    """arch -> (jcfg, cfg, jlm, lm, jparams (perturbed norms), params);
    llama4 at 4 layers (2 units)."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = _four_layers(j_reduced(arch))
            cfg = _four_layers(get_reduced_config(arch))
            jlm, lm = j_build(jcfg), build(cfg)
            jparams = jax.tree.map(np.asarray, _perturb(
                jax.jit(jlm.init)(jax.random.PRNGKey(0))))
            built[arch] = (jcfg, cfg, jlm, lm, jparams,
                           params_from_reference(jparams, device="cpu"))
        return built[arch]

    return get


def _batch(cfg, B=2, T=12, seed=7):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    jb = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    jb["labels"][0, :2] = -100
    return jb, {k: torch.as_tensor(v, dtype=torch.int64)
                for k, v in jb.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Published and reduced configs field by field (the MoE fields among
    them), the layer kinds, the depth units; nothing is left unported."""
    assert configs.NOT_PORTED == ()
    assert arch in configs.ARCH_IDS
    for ours, ref in ((get_config(arch), j_config(arch)),
                      (get_reduced_config(arch), j_reduced(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.layer_kinds() == ref.layer_kinds()
        assert (ours.num_experts, ours.moe_every, ours.dense_d_ff,
                ours.router_aux_coef, ours.moe_d_ff) == \
            (ref.num_experts, ref.moe_every, ref.dense_d_ff,
             ref.router_aux_coef, ref.moe_d_ff)
        assert ours.param_count() == ref.param_count()
        assert build(ours).num_depth_units == \
            j_build(ref).num_depth_units


def test_router_topk_matches_reference():
    """Probabilities, expert ids (ties to the lower id: logits rounded to
    quarters tie often) and the Switch aux loss."""
    rng = np.random.default_rng(0)
    for E, k in ((4, 2), (16, 8), (128, 8)):
        logits = (np.round(rng.standard_normal((64, E)) * 4) / 4
                  ).astype(np.float32)
        jp, ji, ja = j_moe.router_topk(jnp.asarray(logits), k)
        tp, ti, ta = moe.router_topk(torch.tensor(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(tp, jp, f"E{E} probs", atol=1e-7, rtol=1e-6)
        _close(ta.item(), ja, f"E{E} aux", atol=1e-7, rtol=1e-6)


def _moe_case(arch, B, T, seed):
    cfg = get_reduced_config(arch)
    p = jax.tree.map(np.asarray, jax.jit(
        lambda key: j_moe.init(key, cfg))(jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("arch,capacity_factor", [
    ("qwen3-moe-235b-a22b", 1.25), ("qwen3-moe-235b-a22b", 0.5),
    ("llama4-maverick-400b-a17b", 1.25), ("llama4-maverick-400b-a17b", 0.5)])
def test_moe_forward_and_gradients_match_reference(arch, capacity_factor):
    """``moe.forward`` (2 x 24 tokens) and the gradients of a weighted
    sum of its output (+ the aux loss) w.r.t. every parameter and x; at
    capacity factor 0.5 some (token, choice) pairs are dropped (checked)
    and their rows must get exactly the reference's zero share."""
    cfg, jp, x = _moe_case(arch, 2, 24, seed=1)
    rng = np.random.default_rng(2)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def j_obj(p, x):
        out, aux = j_moe.forward(p, cfg, x, capacity_factor=capacity_factor)
        return jnp.sum(out * w) + aux, (out, aux)

    (_, (jout, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        j_obj, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    p = {k: torch.tensor(v, requires_grad=True) for k, v in jp.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = moe.forward(p, cfg, tx, capacity_factor=capacity_factor)
    (out * torch.tensor(w)).sum().add(aux).backward()
    _close(out.detach(), jout, f"{arch} out")
    _close(aux.item(), jaux, f"{arch} aux")
    _close(tx.grad, jgx, f"{arch} d x")
    for k in jp:
        _close(p[k].grad, jg[k], f"{arch} d {k}")

    N, E, K = 48, cfg.num_experts, cfg.experts_per_token
    C = max(1, int(capacity_factor * N * K / E))
    _, idx, _ = moe.router_topk(torch.tensor(x.reshape(N, -1)) @ p[
        "router"].detach(), K)
    load = torch.bincount(idx.reshape(-1), minlength=E)
    assert bool((load > C).any()) == (capacity_factor < 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(setup, arch):
    """``loss_fn`` = CE + router_aux_coef x the summed aux, its metrics,
    and every parameter's gradient."""
    jcfg, cfg, jlm, lm, jparams, params = setup(arch)
    jb, tb = _batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jb, kernel_force="ref"), has_aux=True))(
            jax.tree.map(jnp.asarray, jparams))
    p = params_from_reference(jparams, device="cpu")
    for t in tree_leaves(p):
        t.requires_grad_()
    loss, m = lm.loss_fn(p, tb)
    loss.backward()
    assert m["aux"].item() > 0
    _close(loss.item(), jl, f"{arch} loss")
    _close(m["aux"].item(), jm["aux"], f"{arch} aux")
    _close(m["ce"].item(), jm["ce"], f"{arch} ce")
    assert_trees_close(params_to_reference(_grads(p)), jax.tree.map(np.asarray, jg),
                       f"{arch} gradients", atol=ATOL, rtol=RTOL)


def _grads(p):
    if isinstance(p, dict):
        return {k: _grads(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_grads(v) for v in p]
    return p.grad


def test_two_sublayer_unit_round_trip(setup):
    """llama4's unit is ``{"sub_0": dense layer (dense_d_ff), "sub_1": MoE
    layer (shared expert)}`` on both sides: reference -> port ->
    reference and port -> reference -> port are exact, and each port
    unit holds row u of the stacked leaves."""
    _, cfg, _, _, jparams, _ = setup("llama4-maverick-400b-a17b")
    params = params_from_reference(jparams, device="cpu")
    assert len(params["units"]) == 2
    for u, unit in enumerate(params["units"]):
        assert set(unit) == {"sub_0", "sub_1"}
        assert set(unit["sub_0"]) == {"attn_norm", "attn", "mlp_norm", "mlp"}
        assert unit["sub_0"]["mlp"]["w_up"].shape == (cfg.d_model,
                                                      cfg.dense_d_ff)
        assert set(unit["sub_1"]["moe"]) == {
            "router", "w_gate", "w_up", "w_down", "shared_gate",
            "shared_up", "shared_down"}
        np.testing.assert_array_equal(
            unit["sub_1"]["moe"]["w_down"].numpy(),
            jparams["units"]["sub_1"]["moe"]["w_down"][u])
    back = params_to_reference(params)
    fa = jax.tree_util.tree_flatten_with_path(back)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert len(fa) == len(fb)
    for path, a in fa:
        assert np.array_equal(a, fb[path]), path
    own = build(cfg).init(5, device="cpu")
    again = params_from_reference(params_to_reference(own), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(own),
                                                 tree_leaves(again)))
    ref_tree = jax.tree.structure(jparams)
    assert jax.tree.structure(params_to_reference(own)) == ref_tree


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_memory_matches_reference(arch):
    """The memory model prices both published configs (and the reduced
    ones) exactly as the reference does: every unit, the embed, head."""
    for ours, ref in ((get_config(arch), j_config(arch)),
                      (get_reduced_config(arch), j_reduced(arch))):
        for B, T in ((4, 256), (1, 4096)):
            assert dataclasses.astuple(memory_model.lm_memory(ours, B, T)) \
                == dataclasses.astuple(j_memory.lm_memory(ref, B, T))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(models, arch):
    jcfg, cfg, jlm, lm, jparams, params, _ = models(arch)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want = jax.jit(lambda p, b: jlm.prefill(p, b, kernel_force="ref"))(
        jparams, {"tokens": toks})
    got = lm.prefill(params, {"tokens": torch.tensor(toks)})
    assert got.shape == (2, 1, cfg.vocab_size)
    _close(got, want, f"{arch} prefill")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(models, arch):
    """8 decode steps at batch 2 from a random cache: capacity
    ``max(1, int(1.25 * 2 * K / E))`` = 1 slot an expert, so a second
    token routed to an expert is dropped, on both sides alike."""
    cfg = get_reduced_config(arch)
    assert max(1, int(1.25 * 2 * cfg.experts_per_token
                      / cfg.num_experts)) == 1
    _decode_both(models, arch, steps=8, seq=16, start=3, mrope=False,
                 seed=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_vs_prefill_gap_matches_reference(models, arch, capsys):
    """A 10-token prompt walked through decode (each side its own bf16
    cache) against the same side's prefill.  The decode's capacity of 1
    an expert drops routed tokens that the prefill's keeps, so the gap is
    the reference's behaviour, not bounded by the serving tolerance: the
    port's gap must equal the reference's (each side's logits within
    atol 1e-4 / rtol 1e-3 of the other's); both gaps are printed."""
    jcfg, cfg, jlm, lm, jparams, params, jdecode = models(arch)
    T = 10
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, T)).astype(np.int32)
    from repro.models.api import init_cache as j_init_cache
    from repro_torch.models import init_cache
    jcache, cache = j_init_cache(jcfg, 2, T), init_cache(cfg, 2, T,
                                                         device="cpu")
    for t in range(T):
        jlog, jcache = jdecode(jparams, toks[:, t:t + 1], jcache,
                               jnp.int32(t), None)
        log, cache = lm.decode_step(params, torch.tensor(toks[:, t:t + 1]),
                                    cache, t)
    jpf = np.asarray(jlm.prefill(jparams, {"tokens": toks},
                                 kernel_force="ref"))
    pf = lm.prefill(params, {"tokens": torch.tensor(toks)}).numpy()
    _close(log, jlog, f"{arch} decode after the prompt", atol=1e-4,
           rtol=1e-3)
    _close(pf, jpf, f"{arch} prefill")
    j_gap = float(np.abs(np.asarray(jlog) - jpf).max())
    gap = float(np.abs(log.numpy() - pf).max())
    with capsys.disabled():
        print(f"\n{arch} reduced, batch 2: decode vs prefill max_abs_err "
              f"{gap:.4e} (reference {j_gap:.4e})")
    assert abs(gap - j_gap) <= 1e-4 + 1e-3 * j_gap
