"""Per-unit rematerialization (``repro_torch.models.common.maybe_checkpoint``
/ ``disable_remat``) against the reference's ``jax.checkpoint`` bodies.

At reduced widths and 3 depth units, for each family's checkpointed body
(dense, MoE, llama4's interleaved units, the VLM with its vision prefix
and M-RoPE, mamba2, rwkv6, zamba2's groups, whisper's encoder and
decoder):

* the loss and every gradient with remat on equal those with it off;
* the port with remat on matches the reference (remat on, its ``ref``
  kernels) on the same parameters (the port's init in the reference's
  layout), to the parity tests' tolerance;
* with remat on the step keeps fewer saved tensors (the checkpoint is
  really there);
* the stacked path (``client_update_batched``, the loss vmapped) composes
  with remat: within the vectorized tolerance of the sequential path, and
  the recompute Function ran.

Also: the reference's ``remat`` defaults read with ``inspect.signature``
equal the port's, training runs its bodies with remat on and serving
with it off on both sides, and ``disable_remat()`` nests and restores."""
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import (mamba2_lm as j_mamba2_lm, rwkv6 as j_rwkv6,  # noqa: E402
                          transformer as j_transformer, whisper as j_whisper,
                          zamba2 as j_zamba2)
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import blockwise  # noqa: E402
from repro_torch.core.decomposition import Decomposition  # noqa: E402
from repro_torch.models import (build, common, mamba2_lm, rwkv6,  # noqa: E402
                                transformer, whisper, zamba2)
from repro_torch.testing.convert import params_to_reference  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

ARCHS = ("yi-6b", "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
         "qwen2-vl-2b", "mamba2-370m", "rwkv6-7b", "zamba2-1.2b",
         "whisper-small")
ATOL, RTOL = 1e-5, 1e-4          # the family parity tests' tolerance
SAME_ATOL, SAME_RTOL = 1e-6, 1e-5  # remat on against off
B, T, FRAMES = 2, 12, 16


def _depth3(cfg):
    """``cfg`` at 3 depth units, its widths kept."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=3 * cfg.hybrid_attn_every)
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, encoder_layers=3, num_layers=3)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, num_layers=3)
    return dataclasses.replace(cfg, num_layers=3 * cfg.moe_every)


def _batch(cfg, seed: int, batch: int = B) -> dict:
    """Seeded numpy tokens and labels (a few ignored); a VLM's vision
    prefix and per-row M-RoPE positions; whisper's stubbed frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, T + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    out["labels"][0, :2] = -100
    if cfg.family == "vlm":
        out["vision_embeds"] = (0.1 * rng.standard_normal(
            (batch, 4, cfg.d_model))).astype(np.float32)
        out["mrope_positions"] = rng.integers(0, 3 * T, (3, batch, T),
                                              dtype=np.int32)
    if cfg.is_encoder_decoder:
        out["encoder_embeds"] = (0.1 * rng.standard_normal(
            (batch, FRAMES, cfg.d_model))).astype(np.float32)
    return out


def _port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def family():
    """arch -> (reference cfg, port cfg, port params, numpy batch), built
    once per arch; the port's seeded init, so no reference init is
    compiled."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg, cfg = _depth3(j_reduced(arch)), _depth3(
                get_reduced_config(arch))
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            params = build(cfg).init(1, device="cpu")
            if cfg.family == "ssm":
                # as test_torch_ssm.py: at the init's 0.02 the rms-norm
                # that reads the embedding amplifies fp32 rounding ~50x,
                # over the tolerance on either side of a float64 run
                params["embed"].mul_(50.0)
            built[arch] = (jcfg, cfg, params, _batch(cfg, 3))
        return built[arch]

    return get


def _loss_and_grads(cfg, params, batch):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = build(cfg).loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return loss.detach(), [torch.zeros_like(t) if g is None else g
                           for t, g in zip(leaves, grads)]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_off(family, arch):
    """Loss and every gradient with each unit rematerialized equal those
    of the plain autograd run."""
    _, cfg, params, batch = family(arch)
    tb = _port_batch(batch)
    on = _loss_and_grads(cfg, params, tb)
    with common.disable_remat():
        off = _loss_and_grads(cfg, params, tb)
    torch.testing.assert_close(on[0], off[0], atol=SAME_ATOL, rtol=SAME_RTOL)
    for i, (a, b) in enumerate(zip(on[1], off[1])):
        torch.testing.assert_close(a, b, atol=SAME_ATOL, rtol=SAME_RTOL,
                                   msg=f"gradient leaf {i}")
    assert any(float(g.abs().max()) > 0 for g in on[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_reference(family, arch):
    """The port's loss and gradients with remat on against the
    reference's (remat on by default, ``kernel_force="ref"``) on the
    same parameters."""
    jcfg, cfg, params, batch = family(arch)
    jlm = j_build(jcfg)
    jparams = params_to_reference(params)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, batch, kernel_force="ref"),
        has_aux=True))(jparams)
    loss, grads = _loss_and_grads(cfg, params, _port_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL,
                               rtol=RTOL)
    by_id = {id(t): g for t, g in zip(tree_leaves(params), grads)}
    assert_trees_close(params_to_reference(tree_map(lambda t: by_id[id(t)],
                                                    params)),
                       jax.tree.map(np.asarray, jgrads), f"{arch} grad",
                       atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("transform", ("grad", "vmap_grad"))
@pytest.mark.parametrize("arch", ("yi-6b", "mamba2-370m", "rwkv6-7b"))
def test_grad_transform_composes_with_remat(family, arch, transform,
                                            monkeypatch):
    """Under ``torch.func.grad`` (and ``vmap`` of it over two batches)
    each unit goes through ``common._Recompute``'s recomputing backward,
    and the gradients equal those with remat off."""
    _, cfg, params, batch = family(arch)
    tb = _port_batch(batch)
    lm = build(cfg)
    grad = torch.func.grad(lambda p, b: lm.loss_fn(p, b)[0])
    if transform == "vmap_grad":
        tb = {k: torch.stack([v, v.flip(0)]) for k, v in tb.items()}
        grad = torch.func.vmap(grad, in_dims=(None, 0))
    calls = [0]
    apply = common._Recompute.apply

    def counted(*a):
        calls[0] += 1
        return apply(*a)

    monkeypatch.setattr(common._Recompute, "apply", counted)
    on = grad(params, tb)
    assert calls[0] >= 3
    with common.disable_remat():
        off = grad(params, tb)
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        torch.testing.assert_close(a, b, atol=SAME_ATOL, rtol=SAME_RTOL)


def _saved_bytes(fn) -> int:
    """Bytes autograd saves for the backward while ``fn`` runs."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


@pytest.mark.parametrize("arch", ("yi-6b", "mamba2-370m", "zamba2-1.2b",
                                  "whisper-small"))
def test_remat_keeps_fewer_activations(family, arch):
    """With remat on, the forward saves the units' inputs (the
    checkpoint's own hooks hold the rest until the recompute): less than
    the plain run, which saves every unit's activations."""
    _, cfg, params, batch = family(arch)
    tb = _port_batch(batch)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        on = _saved_bytes(lambda: build(cfg).loss_fn(params, tb))
        with common.disable_remat():
            off = _saved_bytes(lambda: build(cfg).loss_fn(params, tb))
    finally:
        for t in leaves:
            t.requires_grad_(False)
    assert on < 0.5 * off, (on, off)


# the reference's range / forward functions that take ``remat`` and their
# port counterparts
_SIGNATURES = (
    (j_transformer.apply_unit_range, transformer.apply_unit_range),
    (j_transformer.forward_hidden, transformer.forward_hidden),
    (j_mamba2_lm.apply_layer_range, mamba2_lm.apply_layer_range),
    (j_mamba2_lm.forward_hidden, mamba2_lm.forward_hidden),
    (j_rwkv6.apply_layer_range, rwkv6.apply_layer_range),
    (j_rwkv6.forward_hidden, rwkv6.forward_hidden),
    (j_zamba2.apply_group_range, zamba2.apply_group_range),
    (j_zamba2.forward_hidden, zamba2.forward_hidden),
    (j_whisper.encode, whisper.encode),
    (j_whisper.encode, whisper.encoder_range),
    (j_whisper.apply_decoder_range, whisper.apply_decoder_range),
    (j_whisper.forward_hidden, whisper.forward_hidden),
)


@pytest.mark.parametrize("ref,port", _SIGNATURES,
                         ids=[f"{p.__module__.split('.')[-1]}.{p.__name__}"
                              for _, p in _SIGNATURES])
def test_remat_defaults_match_reference(ref, port):
    """Each function's ``remat`` default is the reference's: on."""
    want = inspect.signature(ref).parameters["remat"].default
    got = inspect.signature(port).parameters["remat"].default
    assert want is True and got is want


def _remat_flags(common_mod, fn) -> set:
    """The ``remat`` arguments ``fn`` gives ``maybe_checkpoint``."""
    seen, orig = set(), common_mod.maybe_checkpoint

    def spy(body, remat):
        seen.add(remat)
        return orig(body, remat)

    common_mod.maybe_checkpoint = spy
    try:
        fn()
    finally:
        common_mod.maybe_checkpoint = orig
    return seen


@pytest.mark.parametrize("arch", ("yi-6b", "mamba2-370m", "rwkv6-7b",
                                  "zamba2-1.2b", "whisper-small"))
def test_training_on_serving_off_as_reference(family, arch):
    """The loss runs its bodies with remat on and the prefill with it
    off, on both sides (the reference eagerly, its ``ref`` kernels)."""
    jcfg, cfg, params, batch = family(arch)
    jlm, lm = j_build(jcfg), build(cfg)
    jparams, tb = params_to_reference(params), _port_batch(batch)
    assert _remat_flags(j_common, lambda: jlm.loss_fn(
        jparams, batch, kernel_force="ref")) == {True}
    assert _remat_flags(common, lambda: lm.loss_fn(params, tb)) == {True}
    assert _remat_flags(j_common, lambda: jlm.prefill(
        jparams, batch, kernel_force="ref")) == {False}
    assert _remat_flags(common, lambda: lm.prefill(params, tb)) == {False}


def test_disable_remat_nests_and_restores():
    """``disable_remat()`` turns every body plain, nests, and restores
    on exit, also when the body raises; the reference's does the same."""
    def body(x):
        return x
    for mod in (common, j_common):
        assert mod.maybe_checkpoint(body, False) is body
        assert mod.maybe_checkpoint(body, True) is not body
        with mod.disable_remat():
            assert mod.maybe_checkpoint(body, True) is body
            with mod.disable_remat():
                assert mod.maybe_checkpoint(body, True) is body
            assert mod.maybe_checkpoint(body, True) is body
        assert mod.maybe_checkpoint(body, True) is not body
        with pytest.raises(KeyError):
            with mod.disable_remat():
                raise KeyError("inside")
        assert mod.maybe_checkpoint(body, True) is not body


def test_remat_is_transparent_without_grad(family):
    """Under ``no_grad`` (a frozen prefix) a checkpointed body runs as it
    is: the same outputs, bitwise, as remat off."""
    _, cfg, params, batch = family("yi-6b")
    lm, tb = build(cfg), _port_batch(batch)
    with torch.no_grad():
        x = transformer.embed_inputs(params, cfg, tb["tokens"])
        on, _ = lm.apply_range(params, x, 0, 3)
        off, _ = lm.apply_range(params, x, 0, 3, remat=False)
    assert torch.equal(on, off)


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_path_composes_with_remat(family, arch, monkeypatch):
    """``client_update_batched`` (the loss vmapped over 2 clients, plain
    autograd, each unit through ``common._Recompute``) within the
    vectorized tolerance of each client's sequential ``client_update``
    (remat through ``torch.utils.checkpoint``), and of the stacked run
    with remat off."""
    jcfg, cfg, params, _ = family(arch)
    runner = blockwise.lm_runner(build(cfg))
    n = runner.n_units
    dec = Decomposition(blocks=((0, 1), (1, n)), skipped_prefix=0,
                        budget_bytes=0)
    per_client = [[_port_batch(_batch(cfg, 10 + c, batch=1))]
                  for c in range(2)]
    calls = [0]
    apply = common._Recompute.apply

    def counted(*a):
        calls[0] += 1
        return apply(*a)

    monkeypatch.setattr(common._Recompute, "apply", counted)
    stacked = blockwise.client_update_batched(runner, params, dec,
                                              per_client, lr=0.05)
    assert calls[0] > 0
    with common.disable_remat():
        plain = blockwise.client_update_batched(runner, params, dec,
                                                per_client, lr=0.05)
    for c, batches in enumerate(per_client):
        seq = blockwise.client_update(runner, params, dec, batches, lr=0.05)
        for a, b, p in zip(tree_leaves(stacked[c]), tree_leaves(seq),
                           tree_leaves(plain[c])):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
            torch.testing.assert_close(a, p, rtol=2e-4, atol=2e-5)


def test_vectorized_scheduler_composes_with_remat(monkeypatch):
    """One FeDepth round of reduced mamba2 under ``VectorizedScheduler``
    (every client: the clients sharing a decomposition stack, their units
    rematerialized under ``vmap``) within the vectorized tolerance of the
    sequential scheduler's round."""
    from repro_torch.fl.engine import RoundEngine, SimConfig
    from repro_torch.fl.registry import get_strategy
    from repro_torch.fl.sampling import VectorizedScheduler
    from repro_torch.fl.seq import build_lm_context, build_seq_data
    sim = SimConfig(rounds=1, participation=1.0, lr=0.1, local_steps=1,
                    batch_size=8, scenario="fair", seed=0)
    states = {}
    calls = [0]
    apply = common._Recompute.apply

    def counted(*a):
        calls[0] += 1
        return apply(*a)

    monkeypatch.setattr(common._Recompute, "apply", counted)
    for name, scheduler in (("sequential", None),
                            ("vectorized", VectorizedScheduler(min_group=1))):
        ctx = build_lm_context(
            build_seq_data(4, n_per_client=16, n_test=32, vocab_size=32,
                           seq_len=12, seed=0, device="cpu"), sim,
            get_reduced_config("mamba2-370m"), device="cpu")
        strategy = get_strategy("fedepth")
        strategy.setup(ctx)
        init = strategy.init_state(ctx)
        before = calls[0]
        states[name], _ = RoundEngine(strategy, ctx, scheduler=scheduler
                                      ).run(initial_state=init,
                                            eval_every=1)
        assert (calls[0] > before) == (name == "vectorized")
    for a, b in zip(tree_leaves(states["vectorized"]),
                    tree_leaves(states["sequential"])):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
