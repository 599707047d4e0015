"""The port's serving path vs the reference (PyTorch port): configs and
input / cache specs, prefill, decode over the KV / SSM caches, the
sliding-window ring buffer, M-RoPE with the stubbed vision prefix, the
VLM's loss, and the serve CLI.

Reduced configs (2 layers) of yi-6b, h2o-danube-3-4b, minicpm-2b,
qwen2-vl-2b, mamba2-370m and rwkv6-7b start from the reference's
parameters (jitted init, norms and biases perturbed so that they count),
converted with ``repro_torch.testing.convert``; inputs come from numpy
seeds.  The reference runs with ``kernel_force="ref"``, its decode step
jitted once per config.  Tolerances: prefill logits atol 1e-5 / rtol
1e-4; decode logits atol 1e-4 / rtol 1e-3 (fp32, a different summation
order); fp32 cache leaves rtol 1e-4 (atol 1e-5 for entries near 0: the
states' entries reach 1-12); bf16 cache leaves at most one bf16 ulp
beyond that fp32 tolerance (a value on a rounding boundary may round
either way, and one such ulp, carried on, moves later steps by more than
the fp32 tolerances: so each step starts both sides from the reference's
cache); the port's decode against
its own prefill at the reference's atol 3e-2 / rtol 5e-2
(``tests/test_arch_smoke.py``: the bf16 caches bound the agreement).
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_configs as j_all_configs  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.configs import minicpm_2b as j_minicpm  # noqa: E402
from repro.configs.shapes import SHAPES as J_SHAPES  # noqa: E402
from repro.configs.shapes import cache_specs as j_cache_specs  # noqa: E402
from repro.configs.shapes import input_specs as j_input_specs  # noqa: E402
from repro.configs.shapes import shape_applicable as j_applicable  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.api import init_cache as j_init_cache  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs import minicpm_2b  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.shapes import (SHAPES, cache_specs,  # noqa: E402
                                        input_specs, shape_applicable)
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import (attention, build, common,  # noqa: E402
                                init_cache)
from repro_torch.testing.convert import (cache_from_reference,  # noqa: E402
                                         cache_to_reference,
                                         params_from_reference,
                                         params_to_reference)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

ARCHS = ["yi-6b", "h2o-danube-3-4b", "minicpm-2b", "qwen2-vl-2b",
         "mamba2-370m", "rwkv6-7b"]
NEW_CONFIGS = ["yi-6b", "h2o-danube-3-4b", "minicpm-2b", "qwen2-vl-2b"]
B = 2
SRC = Path(__file__).resolve().parents[1] / "src"


def _close(a, b, msg, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


def _torch_dtype(jdtype) -> torch.dtype:
    return getattr(torch, jnp.dtype(jdtype).name)


def _perturb(jparams):
    """Non-trivial norm scales, qkv biases, conv biases, decays and
    skips, so that the checks see every parameter."""
    rng = np.random.default_rng(1)
    names = ("norm", "ln_x", "['bq']", "['bk']", "['bv']", "conv_b",
             "dt_bias", "A_log", "['D']")

    def fn(path, a):
        a = np.asarray(a)
        if any(n in jax.tree_util.keystr(path) for n in names):
            return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fn, jparams)


@pytest.fixture(scope="module")
def models():
    """arch -> (jcfg, cfg, jlm, lm, jparams, params, jitted reference
    decode step); each built once."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg, cfg = j_reduced(arch), get_reduced_config(arch)
            jlm, lm = j_build(jcfg), build(cfg)
            jparams = _perturb(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
            params = params_from_reference(jparams, device="cpu")
            jdecode = jax.jit(lambda p, t, c, i, m: jlm.decode_step(
                p, t, c, i, mrope_positions=m, kernel_force="ref"))
            built[arch] = (jcfg, cfg, jlm, lm, jparams, params, jdecode)
        return built[arch]

    return get


def _to_port(jcache):
    return cache_from_reference(
        {k: np.asarray(v, np.float32) for k, v in jcache.items()},
        dtypes={k: _torch_dtype(v.dtype) for k, v in jcache.items()},
        device="cpu")


def _assert_caches_close(cache, jcache, msg):
    """fp32 leaves within rtol 1e-4 (atol 1e-5); bf16 leaves at most one
    bf16 ulp beyond that (values rounded from fp32 ones that already
    differ by it: near 0 the fp32 rounding of a projection exceeds the
    value's own bf16 ulp); the same keys and dtypes."""
    assert set(cache) == set(jcache), msg
    got = cache_to_reference(cache)
    for k, jv in jcache.items():
        assert cache[k].dtype == _torch_dtype(jv.dtype), (msg, k)
        want = np.asarray(jv, np.float32)
        if cache[k].dtype == torch.bfloat16:
            # one bf16 ulp of the larger magnitude: float32's spacing
            # times 2**16 (7 mantissa bits against 23)
            ulp = np.spacing(np.maximum(np.abs(got[k]), np.abs(want))) \
                * 2.0 ** 16
            far = np.abs(got[k] - want) > ulp + 1e-5 + 1e-4 * np.abs(want)
            assert not far.any(), (f"{msg} {k}: {int(far.sum())} entries "
                                   f"more than one bf16 ulp apart")
        else:
            _close(got[k], want, f"{msg} {k}", atol=1e-5, rtol=1e-4)


# ----------------------------------------------------------- configs, specs
@pytest.mark.parametrize("arch", NEW_CONFIGS)
def test_configs_match_reference(arch):
    """Each new config equals the reference's field by field, at full
    and reduced size; so do minicpm's WSD schedule and the shapes."""
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_config(arch))
    assert dataclasses.asdict(get_reduced_config(arch)) == \
        dataclasses.asdict(j_reduced(arch))
    assert minicpm_2b.WSD_SCHEDULE == j_minicpm.WSD_SCHEDULE
    assert [dataclasses.astuple(s) for s in SHAPES] == \
        [dataclasses.astuple(s) for s in J_SHAPES]


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return jnp.dtype(dtype).name


def _spec_tuples(specs):
    """A port or reference spec dict -> {name: (shape, dtype name)}."""
    return {k: (_spec_tuples(v) if isinstance(v, dict)
                else (tuple(v.shape), _dtype_name(v.dtype)))
            for k, v in specs.items()}


@pytest.mark.parametrize("arch", sorted(j_all_configs()))
def test_specs_and_policy_match_reference(arch):
    """``input_specs`` of every shape, ``cache_specs`` (a sequence longer
    and shorter than a sliding window) and ``shape_applicable`` give the
    reference's shapes, dtypes and answers, for every architecture the
    reference has (a copy of its config where the port has none)."""
    jcfg = j_all_configs()[arch]
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    for shape, jshape in zip(SHAPES, J_SHAPES):
        assert shape_applicable(cfg, shape) == j_applicable(jcfg, jshape)
        if shape_applicable(cfg, shape)[0]:
            assert _spec_tuples(input_specs(cfg, shape)) == \
                _spec_tuples(j_input_specs(jcfg, jshape)), shape.name
    for seq in (12, 5000):
        assert _spec_tuples(cache_specs(cfg, 3, seq)) == \
            _spec_tuples(j_cache_specs(jcfg, 3, seq))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    """``init_cache`` on the CPU: zeros with the reference's shapes and
    dtypes (K / V, conv_state, rwkv_shift bf16; the states fp32), and a
    cache crosses port -> reference -> port exactly."""
    cfg = get_reduced_config(arch)
    seq = 100     # past danube's reduced window of 64: a 64-slot ring
    cache = init_cache(cfg, B, seq, device="cpu")
    jcache = j_init_cache(j_reduced(arch), B, seq)
    assert {k: (tuple(t.shape), t.dtype) for k, t in cache.items()} == \
        {k: (v.shape, _torch_dtype(v.dtype)) for k, v in jcache.items()}
    assert all(not t.any() and t.device.type == "cpu"
               for t in cache.values())
    gen = torch.Generator().manual_seed(0)
    filled = {k: torch.randn(t.shape, generator=gen).to(t.dtype)
              for k, t in cache.items()}
    back = cache_from_reference(cache_to_reference(filled), device="cpu",
                                dtypes={k: t.dtype
                                        for k, t in filled.items()})
    assert all(torch.equal(back[k], filled[k]) and
               back[k].dtype == filled[k].dtype for k in filled)


def test_vlm_params_carry_qkv_biases(models):
    """qwen2-vl's tree: ``units.sub_0`` with the qkv biases crosses to
    the port's per-layer dicts and back exactly."""
    jcfg, cfg, _, lm, jparams, params, _ = models("qwen2-vl-2b")
    for i, layer in enumerate(params["units"]):
        for b in ("bq", "bk", "bv"):
            np.testing.assert_array_equal(
                layer["attn"][b].numpy(),
                jparams["units"]["sub_0"]["attn"][b][i])
    assert cfg.tie_embeddings and "lm_head" not in params
    assert_trees_close(params_to_reference(params), jparams, "vlm tree",
                       atol=0, rtol=0)


def test_apply_mrope_matches_reference():
    """M-RoPE at the reduced and full sections; with all three axes at
    the same position it is 1-D RoPE."""
    rng = np.random.default_rng(0)
    for sections in ((4, 6, 6), (16, 24, 24)):
        D = 2 * sum(sections)
        x = rng.standard_normal((2, 5, 3, D)).astype(np.float32)
        pos = rng.integers(0, 300, (3, 2, 5)).astype(np.int32)
        got = common.apply_mrope(torch.tensor(x), torch.tensor(pos), 1e6,
                                 sections)
        _close(got, jcommon.apply_mrope(x, pos, 1e6, sections),
               f"apply_mrope {sections}")
        same = np.broadcast_to(pos[:1], pos.shape)
        _close(common.apply_mrope(torch.tensor(x), torch.tensor(same), 1e6,
                                  sections),
               common.apply_rope(torch.tensor(x), torch.tensor(pos[0]), 1e6),
               "M-RoPE on equal axes is RoPE", atol=0, rtol=0)


# ----------------------------------------------------------------- prefill
def _vlm_inputs(cfg, T, rng):
    P = cfg.frontend_embed_tokens
    vision = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    mrope = rng.integers(0, 3 * T, (3, B, T)).astype(np.int32)
    return vision, mrope


PREFILL_CASES = [(a, False) for a in ARCHS] + [("qwen2-vl-2b", True)]


@pytest.mark.parametrize("arch,vision", PREFILL_CASES)
def test_prefill_matches_reference(models, arch, vision):
    """Last-position logits of ``LM.prefill``; qwen2-vl also with a
    vision prefix and M-RoPE positions (text positions shifted by the
    prefix)."""
    jcfg, cfg, jlm, lm, jparams, params, _ = models(arch)
    rng = np.random.default_rng(3)
    T = 11
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    jbatch = {"tokens": toks}
    if vision:
        jbatch["vision_embeds"], jbatch["mrope_positions"] = \
            _vlm_inputs(cfg, T, rng)
    batch = {k: torch.tensor(v) for k, v in jbatch.items()}
    want = jax.jit(lambda p, b: jlm.prefill(p, b, kernel_force="ref"))(
        jparams, jbatch)
    got = lm.prefill(params, batch)
    assert got.shape == (B, 1, cfg.vocab_size)
    _close(got, want, f"{arch} prefill")


# ------------------------------------------------------------------ decode
def _random_cache(jcfg, seq, rng):
    """A reference cache of random values in its own dtypes: the state a
    prompt would have left."""
    out = {}
    for k, v in j_init_cache(jcfg, B, seq).items():
        scale = 0.1 if k in ("rwkv_state", "ssm_state") else 1.0
        out[k] = jnp.asarray(scale * rng.standard_normal(v.shape),
                             v.dtype)
    return out


@contextlib.contextmanager
def _slots_written_as(jcache, slot):
    """Inside, each layer's ``attention.decode`` (in layer order) writes
    the reference's new K / V at ``slot`` (the entries of ``jcache``) in
    place of its own projections' bf16 rounding; everything else, and
    what it reads, is the port's."""
    ks, vs = (torch.tensor(np.asarray(jcache[k][:, :, slot], np.float32))
              for k in ("k", "v"))
    layers = iter(range(ks.shape[0]))
    layer = None
    decode, project, rotate = (attention.decode, attention._project_qkv,
                               attention._rotate)

    def decode_as(*args, **kw):
        nonlocal layer
        layer = next(layers)
        return decode(*args, **kw)

    def project_as(p, cfg, x):
        q, k, _ = project(p, cfg, x)
        return q, k, vs[layer, :, None]

    def rotate_as(cfg, q, k, *args):
        return rotate(cfg, q, k, *args)[0], ks[layer, :, None]

    attention.decode, attention._project_qkv, attention._rotate = (
        decode_as, project_as, rotate_as)
    try:
        yield
    finally:
        attention.decode, attention._project_qkv, attention._rotate = (
            decode, project, rotate)


def _decode_both(models, arch, steps, seq, start, mrope, seed):
    """``steps`` decode steps of the reference from a random cache; each
    step of the port starts from the reference's cache before it,
    converted, and its logits and new cache are held to the
    reference's.  A new K / V entry on a bf16 rounding boundary may round
    the other way than the reference's (the cache check holds it to one
    ulp) and moves that step's logits by more than their fp32 tolerance:
    on such a step the logits held are the port's step with the
    reference's new entries written in place of its own."""
    jcfg, cfg, _, lm, jparams, params, jdecode = models(arch)
    rng = np.random.default_rng(seed)
    jcache = _random_cache(jcfg, seq, rng)
    for i in range(start, start + steps):
        before = jcache
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        pos = (rng.integers(0, 4 * seq, (3, B, 1)).astype(np.int32)
               if mrope else None)
        jlogits, jcache = jdecode(jparams, tok, before, jnp.int32(i), pos)
        step = (lambda: lm.decode_step(
            params, torch.tensor(tok), _to_port(before), i,
            mrope_positions=None if pos is None else torch.tensor(pos)))
        logits, cache = step()
        _assert_caches_close(cache, jcache, f"{arch} decode step {i} cache")
        got = cache_to_reference(cache)
        if any(not np.array_equal(got[k], np.asarray(jcache[k], np.float32))
               for k in ("k", "v") if k in cache):
            S = cache["k"].shape[2]
            with _slots_written_as(jcache, i % S if cfg.sliding_window
                                   else min(i, S - 1)):
                logits, _ = step()
        _close(logits, jlogits, f"{arch} decode step {i} logits",
               atol=1e-4, rtol=1e-3)


DECODE_CASES = [(a, False) for a in ARCHS] + [("qwen2-vl-2b", True)]


@pytest.mark.parametrize("arch,mrope", DECODE_CASES)
def test_decode_matches_reference(models, arch, mrope):
    """10 decode steps from a random cache at cache_index 3 (slots 0..2
    as a prompt left them); qwen2-vl also with M-RoPE positions."""
    _decode_both(models, arch, steps=10, seq=16, start=3, mrope=mrope,
                 seed=4)


def test_ring_buffer_matches_reference(models):
    """h2o-danube-3-4b reduced (window 64): a 64-slot cache for a
    100-token sequence, 80 steps from 0, so that the ring wraps at 64
    and overwrites the oldest slots."""
    cfg = get_reduced_config("h2o-danube-3-4b")
    assert init_cache(cfg, B, 100, device="cpu")["k"].shape[2] == 64
    _decode_both(models, "h2o-danube-3-4b", steps=80, seq=100, start=0,
                 mrope=False, seed=5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(models, arch):
    """The port's sequential decode from an empty cache against its own
    prefill: the last prompt token's logits (qwen2-vl: M-RoPE with the
    three axes at the token's position on both sides)."""
    _, cfg, _, lm, _, params, _ = models(arch)
    T = 10
    toks = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, T)))
    batch = {"tokens": toks}
    vlm = cfg.family == "vlm"
    if vlm:
        batch["mrope_positions"] = torch.arange(T).expand(3, B, T)
    cache = init_cache(cfg, B, T, device="cpu")
    for t in range(T):
        pos = torch.full((3, B, 1), t) if vlm else None
        logits, cache = lm.decode_step(params, toks[:, t:t + 1], cache, t,
                                       mrope_positions=pos)
    _close(logits, lm.prefill(params, batch), f"{arch} decode vs prefill",
           atol=3e-2, rtol=5e-2)


def test_deep_decode_drift_matches_reference():
    """mamba2 at reduced width and its published 48 layers: a 64-token
    prompt walked through decode, each side carrying its own cache, then
    the last token's logits against the same side's prefill.  With the
    bf16 caches the port drifts no further than 1.5x the reference's own
    drift (both grow with depth: the conv tail is rounded to bf16 at
    every step); with every cache leaf fp32 both stay within 1e-4."""
    arch, L, T = "mamba2-370m", 48, 64
    jcfg = dataclasses.replace(j_reduced(arch), num_layers=L)
    cfg = dataclasses.replace(get_reduced_config(arch), num_layers=L)
    jlm, lm = j_build(jcfg), build(cfg)
    jparams = _perturb(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    params = params_from_reference(jparams, device="cpu")
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    jdecode = jax.jit(lambda p, t, c, i: jlm.decode_step(
        p, t, c, i, kernel_force="ref"))
    jpf = np.asarray(jax.jit(lambda p, b: jlm.prefill(
        p, b, kernel_force="ref"))(jparams, {"tokens": toks}))
    pf = lm.prefill(params, {"tokens": torch.tensor(toks)}).numpy()
    drift = {}
    for dtype in ("bf16", "fp32"):
        jcache = j_init_cache(jcfg, B, T)
        cache = init_cache(cfg, B, T, device="cpu")
        if dtype == "fp32":
            jcache = {k: v.astype(jnp.float32) for k, v in jcache.items()}
            cache = {k: v.float() for k, v in cache.items()}
        for t in range(T):
            jlogits, jcache = jdecode(jparams, toks[:, t:t + 1], jcache,
                                      jnp.int32(t))
            logits, cache = lm.decode_step(
                params, torch.tensor(toks[:, t:t + 1]), cache, t)
        drift[dtype] = (float(np.abs(logits.numpy() - pf).max()),
                        float(np.abs(np.asarray(jlogits) - jpf).max()))
    print(f"\nmamba2 reduced width, {L} layers, {T}-token walk vs prefill "
          "(port, reference): " + ", ".join(
              f"{k} caches {p:.3e}, {r:.3e}" for k, (p, r) in drift.items()))
    port, ref = drift["bf16"]
    assert port <= 1.5 * ref, drift
    assert max(drift["fp32"]) <= 1e-4, drift


# ------------------------------------------------------------- the VLM loss
def test_vlm_loss_and_gradients_match_reference(models):
    """qwen2-vl's ``loss_fn`` with a vision prefix and M-RoPE positions
    (no loss on the prefix), and every gradient, against the
    reference's (K1's plain version on the CPU)."""
    jcfg, cfg, jlm, lm, jparams, params, _ = models("qwen2-vl-2b")
    rng = np.random.default_rng(7)
    T = 9
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    jbatch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jbatch["labels"][0, :2] = -100
    jbatch["vision_embeds"], jbatch["mrope_positions"] = \
        _vlm_inputs(cfg, T, rng)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jbatch, kernel_force="ref"),
        has_aux=True))(jparams)
    batch = {k: torch.tensor(v) for k, v in jbatch.items()}
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss, met = lm.loss_fn(p, batch)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    assert int(met["n_tokens"]) == int(jmet["n_tokens"]) == B * T - 2
    _close(loss.item(), jloss, "vlm loss")
    by_id = {id(t): g for t, g in zip(tree_leaves(p), grads)}
    assert_trees_close(params_to_reference(tree_map(lambda t: by_id[id(t)],
                                                    p)),
                       jax.tree.map(np.asarray, jgrads), "vlm grad",
                       atol=1e-5, rtol=1e-4)


# ------------------------------------------------------------------ the CLI
def test_serve_cli_on_the_cpu():
    """``python -m repro_torch.launch.serve`` as the reference's CLI test
    runs it, on the CPU."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "rwkv6-7b", "--reduced", "--device", "cpu", "--batch", "1",
         "--prompt-len", "4", "--gen", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "tok/s" in out.stdout


def test_serve_loop_and_refusals():
    """``serve`` returns the generated tokens (greedy: the argmax of the
    logits before each), the last prompt token's logits equal to a fresh
    walk's, and the timings, for a dense model and for the hybrid zamba2
    (mamba states and one KV cache per shared-block invocation), and for
    both MoE archs (one unit of two sublayers for llama4); an
    encoder-decoder exits as the reference's driver does."""
    for arch in ("yi-6b", "zamba2-1.2b"):
        res = serve_mod.main(["--arch", arch, "--reduced", "--device",
                              "cpu", "--batch", "2", "--prompt-len", "5",
                              "--gen", "4"])
        assert res.tokens.shape == (2, 4) and res.logits.shape == (2, 1, 512)
        assert res.prompt_seconds > 0 and res.decode_seconds > 0
        assert torch.equal(res.tokens[:, :1], res.prompt_logits[
            :, -1].argmax(-1, keepdim=True))
    for arch in ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"):
        res = serve_mod.main(["--arch", arch, "--reduced", "--device",
                              "cpu", "--batch", "2", "--prompt-len", "5",
                              "--gen", "4"])
        assert res.tokens.shape == (2, 4) and res.logits.shape == (2, 1, 512)
        assert bool(torch.isfinite(res.logits).all())
        assert torch.equal(res.tokens[:, :1], res.prompt_logits[
            :, -1].argmax(-1, keepdim=True))
    with pytest.raises(SystemExit, match="whisper"):
        serve_mod.main(["--arch", "whisper-small", "--reduced", "--device",
                        "cpu"])
    cfg = dataclasses.replace(get_reduced_config("yi-6b"),
                              is_encoder_decoder=True)
    with pytest.raises(SystemExit, match="whisper"):
        serve_mod.serve(build(cfg), None, torch.zeros(1, 2, dtype=torch.long),
                        1)
