"""The encoder-decoder whisper of the port vs the reference (PyTorch
port).

Reduced whisper-small (2 encoder + 2 decoder layers, d_model 128, 64
stubbed frames).  The reference runs with ``kernel_force="ref"`` (the
jnp oracles: its custom-VJP attention backward is wrong at ragged
Tq > 512, ROADMAP.md queue 3 fault 1, so gradients are never held to its
interpret path), the port on the CPU (the kernels' plain versions);
parameters are the reference's, every norm weight and bias perturbed so
that each counts, carried across by ``repro_torch.testing.convert``
(``enc_layers`` / ``dec_layers`` as lists).  Inputs come from numpy
seeds; frames are fp32 unless a test says bf16 (``configs.shapes``'
stub dtype).

Tolerances: encoder and decoder hidden states, cross-attention, the
loss, every gradient and prefill logits atol 1e-5 / rtol 1e-4 (fp32, a
different summation order); decode logits atol 1e-4 / rtol 1e-3 and the
caches as in ``tests/test_torch_serve.py``; parameters after a client
update atol 1e-5 / rtol 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.core import blockwise as jbw  # noqa: E402
from repro.core.decomposition import Decomposition  # noqa: E402
from repro.models import attention as j_attention  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import whisper as j_whisper  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.core import blockwise as tbw  # noqa: E402
from repro_torch.core.decomposition import Decomposition as TDec  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import attention, build, whisper  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from test_torch_serve import _decode_both, models  # noqa: E402,F401
from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

ARCH = "whisper-small"
ATOL, RTOL = 1e-5, 1e-4
B, T = 2, 10


def _close(a, b, msg, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


def _perturb(jparams):
    """Every 1-D leaf (LayerNorm weights and biases, the MLP biases)
    moved off its init, so that the checks see it."""
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.standard_normal(
            a.shape).astype(np.float32) if a.ndim == 1 else 0), jparams)


def _batch(cfg, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    frames = rng.standard_normal(
        (B, cfg.max_source_positions, cfg.d_model)).astype(np.float32)
    jb = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
          "encoder_embeds": frames}
    jb["labels"][0, :2] = -100
    tb = {"tokens": torch.as_tensor(jb["tokens"], dtype=torch.int64),
          "labels": torch.as_tensor(jb["labels"], dtype=torch.int64),
          "encoder_embeds": torch.tensor(frames)}
    if dtype != np.float32:
        jb["encoder_embeds"] = jnp.asarray(frames, jnp.bfloat16)
        tb["encoder_embeds"] = tb["encoder_embeds"].to(torch.bfloat16)
    return jb, tb


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = j_reduced(ARCH), get_reduced_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jlm = j_build(jcfg)
    jparams = _perturb(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    return jcfg, cfg, jlm, jparams, [_batch(cfg, s) for s in (2, 3)]


def _params(jparams):
    return params_from_reference(jparams, device="cpu")


def test_config_and_tree_match_reference(setup):
    """Configs field by field (published and reduced), the depth units
    (24 at full size), the cache spec's ``enc_out``, and the port's own
    init builds the reference's tree (keys and shapes)."""
    jcfg, cfg, jlm, jparams, _ = setup
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_config(ARCH))
    assert build(get_config(ARCH)).num_depth_units == \
        j_build(j_config(ARCH)).num_depth_units == 24
    own = build(cfg).init(0, device="cpu")
    assert len(own["enc_layers"]) == len(own["dec_layers"]) == 2
    fa = jax.tree_util.tree_flatten_with_path(params_to_reference(own))[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert {jax.tree_util.keystr(p) for p, _ in fa} == \
        {jax.tree_util.keystr(p) for p in fb}
    for path, a in fa:
        assert a.shape == fb[path].shape, jax.tree_util.keystr(path)


def test_encoder_decoder_and_cross_attention_match_reference(setup):
    """``encode`` (non-causal self-attention, ``enc_norm`` at the end),
    ``cross_forward`` (Tq = 10 against Tk = 64) and ``apply_decoder_range``
    over each [lo, hi) from the reference's encoder output."""
    jcfg, cfg, jlm, jparams, batches = setup
    params = _params(jparams)
    jb, tb = batches[0]
    jenc = np.asarray(j_whisper.encode(jparams, jcfg, jb["encoder_embeds"],
                                       kernel_force="ref"))
    _close(whisper.encode(params, cfg, tb["encoder_embeds"]), jenc, "encode")
    x = np.asarray(jparams["embed"])[jb["tokens"]] \
        + np.asarray(jparams["pos_dec"])[None, :T]
    lp, jlp = params["dec_layers"][1], jparams["dec_layers"]
    jcross = j_attention.cross_forward(
        jax.tree.map(lambda a: a[1], jlp["cross_attn"]), jcfg, x, jenc,
        kernel_force="ref")
    _close(attention.cross_forward(lp["cross_attn"], cfg, torch.tensor(x),
                                   torch.tensor(jenc)), jcross,
           "cross_forward")
    for lo, hi in ((0, 1), (1, 2), (0, 2)):
        _close(whisper.apply_decoder_range(params, cfg, torch.tensor(x),
                                           torch.tensor(jenc), lo, hi),
               j_whisper.apply_decoder_range(jparams, jcfg, x, jenc, lo, hi,
                                             kernel_force="ref"),
               f"decoder [{lo}, {hi})")


def test_loss_and_gradients_match_reference(setup):
    """``loss_fn`` through the tied head (K1 reads ``embed`` as (V, D)),
    and the gradient of every leaf, the encoder's included."""
    jcfg, cfg, jlm, jparams, batches = setup
    jb, tb = batches[0]
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jb, kernel_force="ref"),
        has_aux=True))(jparams)
    params = _params(jparams)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, met = build(cfg).loss_fn(params, tb)
    grads = torch.autograd.grad(loss, leaves)
    assert int(met["n_tokens"]) == int(jmet["n_tokens"]) == B * T - 2
    _close(loss.item(), jloss, "loss")
    by_id = {id(t): g for t, g in zip(leaves, grads)}
    assert_trees_close(params_to_reference(tree_map(lambda t: by_id[id(t)],
                                                    params)),
                       jax.tree.map(np.asarray, jgrads), "grad",
                       atol=ATOL, rtol=RTOL)
    assert float(by_id[id(params["enc_layers"][0]["attn"]["wq"])]
                 .abs().max()) > 0


def test_enc_range_matches_encode(setup):
    """The runner's embed + apply_units over the whole encoder equals
    ``whisper.encode`` on the raw frames (positions added once,
    ``enc_norm`` at hi == E), and so do split ranges composed: the
    reference's regression at ``tests/test_adapters.py``, here against
    the reference's encoder."""
    jcfg, cfg, jlm, jparams, batches = setup
    params = _params(jparams)
    jb, tb = batches[1]
    runner = tbw.lm_runner(build(cfg))
    E = cfg.encoder_layers
    z0 = runner.embed(params, tb)
    z = runner.apply_units(params, z0, 0, E)
    enc = whisper.encode(params, cfg, tb["encoder_embeds"])
    _close(z["enc"], enc, "enc range vs encode", atol=0, rtol=0)
    z_half = runner.apply_units(params, runner.apply_units(params, z0, 0,
                                                           E // 2),
                                E // 2, E)
    _close(z_half["enc"], enc, "split enc ranges", atol=0, rtol=0)
    _close(enc, j_whisper.encode(jparams, jcfg, jb["encoder_embeds"],
                                 kernel_force="ref"), "encode vs reference")
    assert torch.equal(z["dec"], z0["dec"])


def test_runner_contract_matches_reference(setup):
    """The dict z: embed, apply_units over every [lo, hi) of the four
    units (from the reference's z at lo), head_loss and the full loss
    agree with the reference runner; ``prefix_stable`` is False;
    ``merge(split)`` is the identity; split takes the head keys
    (``dec_norm``, ``embed``, ``enc_norm``), the units of [lo, hi) and at
    lo == 0 the positions, as the reference's; merge replaces exactly
    those."""
    jcfg, cfg, jlm, jparams, batches = setup
    jr = jbw.lm_runner(jlm, kernel_force="ref")
    tr = tbw.lm_runner(build(cfg))
    params = _params(jparams)
    assert (tr.n_units, tr.prefix_stable, tr.family) == \
        (jr.n_units, jr.prefix_stable, jr.family) == (4, False, "whisper")
    jb, tb = batches[0]
    zs_j = {0: jr.embed(jparams, jb)}
    _close(tr.embed(params, tb)["enc"], zs_j[0]["enc"], "embed enc",
           atol=0, rtol=0)
    _close(tr.embed(params, tb)["dec"], zs_j[0]["dec"], "embed dec",
           atol=0, rtol=0)
    for hi in range(1, 5):
        zs_j[hi] = jr.apply_units(jparams, zs_j[hi - 1], hi - 1, hi)
    for lo in range(4):
        for hi in range(lo + 1, 5):
            z_in = {k: torch.tensor(np.asarray(v))
                    for k, v in zs_j[lo].items()}
            got = tr.apply_units(params, z_in, lo, hi)
            for k in ("enc", "dec"):
                _close(got[k], zs_j[hi][k], f"apply_units [{lo}, {hi}) {k}")
    z4 = {k: torch.tensor(np.asarray(v)) for k, v in zs_j[4].items()}
    _close(tr.head_loss(params, z4, tb, 3).item(),
           jr.head_loss(jparams, zs_j[4], jb, 3), "head_loss")
    _close(tbw.full_model_loss(tr, params, batches[1][1]).item(),
           jbw.full_model_loss(jr, jparams, batches[1][0]),
           "full_model_loss")

    for lo, hi in ((0, 1), (1, 3), (2, 4), (0, 4)):
        tsplit, jsplit = tr.split(params, lo, hi), jr.split(jparams, lo, hi)
        assert set(tsplit) == set(jsplit), (lo, hi)
        same = tr.merge(params, tsplit, lo=lo, hi=hi)
        assert all(a is b for a, b in zip(tree_leaves(same),
                                          tree_leaves(params)))
        merged = tr.merge(params, tree_map(torch.clone, tsplit), lo=lo,
                          hi=hi)
        for u in range(4):
            key, i = (("enc_layers", u) if u < 2 else ("dec_layers", u - 2))
            assert (merged[key][i] is params[key][i]) == (not lo <= u < hi)
        for k in params:
            if k not in ("enc_layers", "dec_layers"):
                assert (merged[k] is params[k]) == (k not in tsplit), k


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_client_update_matches_reference(setup, prefix_cache):
    """A three-block update over all four units ([0, 1) from the frames,
    [1, 3) across the encoder / decoder boundary, [3, 4) on the buffered
    encoder output; two SGD steps a block over two batches) leaves every
    parameter where the reference's does; the cache holds both leaves of
    the last block's z, re-buffered per block."""
    jcfg, cfg, jlm, jparams, batches = setup
    blocks = ((0, 1), (1, 3), (3, 4))
    kw = dict(lr=0.05, momentum=0.9, local_steps=1)
    jout = jbw.client_update(jbw.lm_runner(jlm, kernel_force="ref"),
                             jax.tree.map(jnp.asarray, jparams),
                             Decomposition(blocks, 0, 0),
                             [b[0] for b in batches], **kw)
    params = _params(jparams)
    runner = tbw.lm_runner(build(cfg))
    cache = tbw.PrefixCache(runner) if prefix_cache else False
    out = tbw.client_update(runner, params, TDec(blocks, 0, 0),
                            [b[1] for b in batches], prefix_cache=cache,
                            **kw)
    assert_trees_close(params_to_reference(out),
                       jax.tree.map(np.asarray, jout), "client update",
                       atol=ATOL, rtol=RTOL)
    if prefix_cache:
        S, D = cfg.max_source_positions, cfg.d_model
        assert cache.buffered_bytes() == 2 * B * (S + T) * D * 4


@pytest.mark.parametrize("frames", ["fp32", "bf16"])
def test_prefill_matches_reference(setup, frames):
    """Last-position logits of ``LM.prefill``, with fp32 frames and with
    the bf16 stub of ``configs.shapes``.  The reference refuses bf16
    frames (its encoder scan's carry turns fp32 after the first layer:
    ROADMAP.md queue 3, fault 8); the port promotes them to fp32 first,
    so its bf16 prefill is held to the reference's on the same frames in
    fp32."""
    jcfg, cfg, jlm, jparams, _ = setup
    jb, tb = _batch(cfg, 5, np.float32 if frames == "fp32" else "bf16")
    del jb["labels"], tb["labels"]
    prefill = jax.jit(lambda p, b: jlm.prefill(p, b, kernel_force="ref"))
    if frames == "bf16":
        with pytest.raises(TypeError, match="carry"):
            prefill(jparams, jb)
        jb["encoder_embeds"] = jb["encoder_embeds"].astype(jnp.float32)
    got = build(cfg).prefill(_params(jparams), tb)
    assert got.shape == (B, 1, cfg.vocab_size) and got.dtype == torch.float32
    _close(got, prefill(jparams, jb), f"prefill, {frames} frames")


def test_decode_matches_reference(models):
    """8 decode steps from a random cache at cache_index 3 (a bf16
    ``enc_out`` among its leaves), each from the reference's cache
    before it: logits and the new cache (cross-attention K / V
    recomputed from ``enc_out`` at every step, on both sides)."""
    _decode_both(models, ARCH, steps=8, seq=16, start=3, mrope=False,
                 seed=4)


def test_serve_refuses_whisper(setup):
    """``serve`` exits for an encoder-decoder as the reference's
    ``serve`` does (its decode is driven directly)."""
    _, cfg, _, jparams, _ = setup
    with pytest.raises(SystemExit, match="whisper"):
        serve(build(cfg), _params(jparams),
              torch.zeros(1, 2, dtype=torch.long), 1)
