"""The training launch path vs the reference (PyTorch port): the LR
schedules and optimizers (``train/optim.py``), the synthetic token
pipeline (``data/tokens.py``), the train, FeDepth block and multi-token
decode steps (``launch/steps.py``), the chunked plain attention for long
sequences (``kernels/flash_chunked.py``) and the train CLI
(``launch/train.py``).

Reduced configs start from the reference's parameters (jitted init),
converted with ``repro_torch.testing.convert``; batches come from numpy
seeds.  Each reference step runs with ``kernel_force="ref"``, jitted once.
Tolerances: schedules, optimizer updates and the clip 1e-6; the train and
block steps' parameters, momentum, loss and gnorm atol 1e-5 / rtol 1e-4
(fp32, another summation order); the multi-token decode's logits and fp32
cache atol 1e-5 / rtol 1e-4 (fp32 caches on both sides: a bf16 K / V
entry on a rounding boundary may round either way and carry on, see
``tests/test_torch_serve.py``); the chunked attention and its gradients
1e-5; the token pipeline bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.configs import minicpm_2b as j_minicpm  # noqa: E402
from repro.core import decomposition as j_decomposition  # noqa: E402
from repro.core import memory_model as j_memory  # noqa: E402
from repro.core.blockwise import lm_runner as j_lm_runner  # noqa: E402
from repro.data.tokens import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.kernels.flash_jnp import flash_attention_jnp  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models.api import init_cache as j_init_cache  # noqa: E402
from repro.train import optim as j_optim  # noqa: E402
from repro_torch.configs import SHAPE_BY_NAME, get_reduced_config  # noqa: E402
from repro_torch.configs import minicpm_2b  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_chunked import MIN_PAIRS, flash_chunked  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.testing.convert import (cache_from_reference,  # noqa: E402
                                         cache_to_reference,
                                         params_from_reference,
                                         params_to_reference)
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.checkpoint import load_latest  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

B, T = 4, 16
STEP_TOL = dict(atol=1e-5, rtol=1e-4)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """arch -> (jcfg, cfg, jlm, lm, reference parameters as numpy), each
    built once from the reference's jitted init."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg, cfg = j_reduced(arch), get_reduced_config(arch)
            jlm = j_build(jcfg)
            jparams = _host(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
            built[arch] = (jcfg, cfg, jlm, build(cfg), jparams)
        return built[arch]

    return get


def _batch(cfg, seed: int, batch: int = B, seq: int = T) -> dict:
    """Seeded numpy tokens and next-token labels (the last ignored); a
    VLM's vision embeddings and M-RoPE positions that differ per row, so
    that a split of the positions on the wrong axis shows."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -1] = -100
    out = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.family == "vlm":
        out["vision_embeds"] = (0.1 * rng.standard_normal(
            (batch, cfg.frontend_embed_tokens, cfg.d_model))).astype(
                np.float32)
        out["mrope_positions"] = rng.integers(0, 3 * seq, (3, batch, seq),
                                              dtype=np.int32)
    return out


def _port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _momentum_like(tree, seed: int):
    """A non-zero momentum state (numpy) shaped as ``tree``, so that the
    ``momentum * v`` term counts."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (1e-3 * rng.standard_normal(np.shape(a))).astype(
            np.float32), tree)


# --------------------------------------------------------------------------
# schedules, optimizers, clipping
# --------------------------------------------------------------------------
SCHEDULES = {
    "constant": (lambda m: m.constant(0.3), [0, 1, 50]),
    "cosine, warmup 10, final 0.1": (
        lambda m: m.cosine(2.0, 100, warmup=10, final_frac=0.1),
        [0, 1, 9, 10, 11, 55, 99, 100, 105]),
    "cosine, no warmup": (lambda m: m.cosine(1.0, 40),
                          [0, 1, 20, 39, 40, 41]),
    "wsd": (lambda m: m.wsd(2.0, 1000),
            [0, 1, 9, 10, 11, 500, 899, 900, 901, 950, 999, 1000, 1003]),
    "wsd, minicpm-2b's": (
        lambda m: m.wsd(0.01, 300, **m.WSD), [0, 1, 2, 3, 4, 269, 270,
                                              271, 285, 299, 300, 310]),
}


class _J:                       # the reference's optim, minicpm's WSD
    constant, cosine, wsd = j_optim.constant, j_optim.cosine, j_optim.wsd
    WSD = j_minicpm.WSD_SCHEDULE


class _T:
    constant, cosine, wsd = optim.constant, optim.cosine, optim.wsd
    WSD = minicpm_2b.WSD_SCHEDULE


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_at_boundary_steps(name):
    """Each schedule at its warmup, stable / decay and total edges (and
    past the total) equals the reference's float32 value within 1e-6."""
    make, at = SCHEDULES[name]
    jsched, sched = make(_J), make(_T)
    assert _T.WSD == _J.WSD
    for step in at:
        want = float(jsched(jnp.int32(step)))
        got = sched(step)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (name, step)


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32),
                  rng.standard_normal((2, 2)).astype(np.float32)]}


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_optimizer_updates_match_reference(kind):
    """Five updates of ``sgd`` (momentum, weight decay, a warmed-up
    cosine) and ``adamw`` (bias correction, decoupled decay, MiniCPM's
    WSD) from the same parameters and gradients: parameters and state
    within 1e-6, the port's updated in place."""
    if kind == "sgd":
        jopt = j_optim.sgd(j_optim.cosine(0.1, 10, warmup=2), momentum=0.9,
                           weight_decay=1e-2)
        opt = optim.sgd(optim.cosine(0.1, 10, warmup=2), momentum=0.9,
                        weight_decay=1e-2)
    else:
        jopt = j_optim.adamw(j_optim.wsd(0.05, 10))
        opt = optim.adamw(optim.wsd(0.05, 10))
    assert opt.slots == jopt.slots
    p0 = _tree(0)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    p = tree_map(torch.from_numpy, jax.tree.map(np.copy, p0))
    state = opt.init(p)
    first = tree_leaves(p)[0]
    for step in range(5):
        g = _tree(10 + step)
        jp, jstate = jopt.update(jp, jax.tree.map(jnp.asarray, g), jstate,
                                 jnp.int32(step))
        p, state = opt.update(p, tree_map(torch.from_numpy, g), state, step)
    assert tree_leaves(p)[0] is first
    for a, b in zip(jax.tree.leaves(_host((jp, jstate))),
                    tree_leaves((p, state))):
        np.testing.assert_allclose(b.numpy(), a, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Clipped above the norm (scaled down) and below it (unchanged):
    the clipped tree and the norm within 1e-6 of the reference's."""
    g = _tree(3)
    jclipped, jnorm = j_optim.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), max_norm)
    clipped, norm = optim.clip_by_global_norm(tree_map(torch.from_numpy, g),
                                              max_norm)
    assert norm.dim() == 0
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jclipped), tree_leaves(clipped)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=1e-6)


# --------------------------------------------------------------------------
# the token pipeline
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed,host", [(0, 0), (0, 3), (7, 0), (7, 3)])
def test_token_pipeline_bitwise(seed, host):
    """Three batches per (seed, host) equal the reference's bit for bit:
    the chain mixture over the 4096-token head slice, int32 tokens, the
    labels shifted with -100 last."""
    kw = dict(vocab_size=64000, seq_len=24, batch_size=3, seed=seed)
    ours, ref = TokenPipeline(**kw).batches(host), \
        JTokenPipeline(**kw).batches(host)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        assert (a["labels"][:, -1] == -100).all()
        assert a["tokens"].max() < 4096


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,accum", [("yi-6b", 1), ("yi-6b", 2),
                                        ("qwen2-vl-2b", 2)])
def test_train_step_matches_reference(models, arch, accum):
    """One ``make_train_step`` (clip 1.0, lr 0.05, momentum 0.9, a
    non-zero momentum state) from the reference's parameters: parameters,
    momentum, loss and gnorm within atol 1e-5 / rtol 1e-4.  The clip is
    active (gnorm > clip_norm).  The port's step writes its arguments in
    place; the VLM's vision prefix and per-row M-RoPE positions split
    into contiguous microbatches along their batch axes."""
    jcfg, cfg, jlm, lm, jparams = models(arch)
    batch = _batch(cfg, seed=1)
    vel0 = _momentum_like(jparams, seed=2)
    kw = dict(lr=0.05, momentum=0.9, clip_norm=1.0, accum_steps=accum)
    jstep = jax.jit(j_steps.make_train_step(jlm, kernel_force="ref", **kw))
    jp, jv, jm = jstep(jax.tree.map(jnp.asarray, jparams),
                       jax.tree.map(jnp.asarray, vel0),
                       jax.tree.map(jnp.asarray, batch))
    params = params_from_reference(jparams, device="cpu")
    vel = params_from_reference(vel0, device="cpu")
    leaf = tree_leaves(params)[0]
    p, v, m = steps.make_train_step(lm, **kw)(params, vel,
                                              _port_batch(batch))
    assert tree_leaves(p)[0] is leaf          # updated in place
    assert not any(t.requires_grad or t.grad is not None
                   for t in tree_leaves(p))
    assert float(jm["gnorm"]) > 1.0 and m["gnorm"].dim() == 0
    for key in ("loss", "gnorm", "ce"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **STEP_TOL,
                                   err_msg=key)
    assert int(m["n_tokens"]) == int(jm["n_tokens"])
    assert_trees_close(params_to_reference(p), _host(jp), f"{arch} params",
                       **STEP_TOL)
    assert_trees_close(params_to_reference(v), _host(jv),
                       f"{arch} momentum", **STEP_TOL)


def test_microbatches_split_contiguously():
    """``accum_steps`` microbatches are contiguous row ranges: dim 1 of
    ``mrope_positions``, dim 0 of the rest, a 0-d leaf whole; a batch
    that does not split raises."""
    batch = {"tokens": torch.arange(12).reshape(4, 3),
             "mrope_positions": torch.arange(24).reshape(3, 4, 2),
             "scale": torch.tensor(2.0)}
    parts = steps.microbatches(batch, 2)
    assert torch.equal(parts[1]["tokens"], batch["tokens"][2:])
    assert torch.equal(parts[0]["mrope_positions"],
                       batch["mrope_positions"][:, :2])
    assert parts[1]["scale"] is batch["scale"]
    with pytest.raises(ValueError, match="microbatches"):
        steps.microbatches(batch, 3)


# --------------------------------------------------------------------------
# the FeDepth block step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("buffered,accum", [(False, 1), (True, 1),
                                            (False, 2), (True, 2)])
def test_fedepth_block_step_matches_reference(models, buffered, accum):
    """``make_fedepth_block_step`` on the reduced mamba2-370m's later
    block [1, 2) (tied head), from the reference's parameters and a
    non-zero block momentum: the block's units and the head trained
    (momentum, no clip), the prefix untouched; with ``buffered_z`` the
    batch carries the reference's prefix output ``z_in``.  Parameters,
    momentum and loss within atol 1e-5 / rtol 1e-4."""
    jcfg, cfg, jlm, lm, jparams = models("mamba2-370m")
    lo, hi = 1, 2
    batch = _batch(cfg, seed=3)
    jrunner = j_lm_runner(jlm, kernel_force="ref")
    jfull = jax.tree.map(jnp.asarray, jparams)
    if buffered:
        z = jax.jit(lambda p, t: jrunner.apply_units(
            p, jrunner.embed(p, {"tokens": t}), 0, lo))(jfull,
                                                        batch["tokens"])
        batch = {"z_in": np.asarray(z), "labels": batch["labels"]}
    vel0 = _momentum_like(_host(jrunner.split(jfull, lo, hi)), seed=4)
    kw = dict(lr=0.05, momentum=0.9, accum_steps=accum,
              buffered_z=buffered)
    jfn, _ = j_steps.make_fedepth_block_step(jlm, lo, hi, kernel_force="ref",
                                             **kw)
    jp, jv, jm = jax.jit(jfn)(jfull, jax.tree.map(jnp.asarray, vel0),
                              jax.tree.map(jnp.asarray, batch))
    fn, runner = steps.make_fedepth_block_step(lm, lo, hi, **kw)
    params = params_from_reference(jparams, device="cpu")
    prefix = params["layers"][0]["in_proj"].clone()
    vel = params_from_reference(vel0, device="cpu")
    p, v, m = fn(params, vel, _port_batch(batch))
    assert torch.equal(p["layers"][0]["in_proj"], prefix)
    assert not torch.equal(p["layers"][1]["in_proj"],
                           params_from_reference(jparams, device="cpu")[
                               "layers"][1]["in_proj"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               **STEP_TOL)
    assert_trees_close(params_to_reference(p), _host(jp), "block params",
                       **STEP_TOL)
    assert_trees_close(params_to_reference(v), _host(jv), "block momentum",
                       **STEP_TOL)


@pytest.mark.parametrize("accum", [1, 2])
def test_buffered_block_step_equals_unbuffered(models, accum):
    """The port's buffered step, fed its own prefix output, equals its
    unbuffered step bitwise on the CPU (the same operations on the same
    z), at ``accum_steps`` 1 and 2."""
    _, cfg, _, lm, jparams = models("mamba2-370m")
    batch = _port_batch(_batch(cfg, seed=5))
    outs = []
    for buffered in (False, True):
        fn, runner = steps.make_fedepth_block_step(lm, 1, 2, lr=0.05,
                                                   accum_steps=accum,
                                                   buffered_z=buffered)
        params = params_from_reference(jparams, device="cpu")
        vel = tree_map(torch.zeros_like, runner.split(params, 1, 2))
        b = batch
        if buffered:
            with torch.no_grad():
                z = runner.apply_units(params, runner.embed(params, batch),
                                       0, 1)
            b = {"z_in": z, "labels": batch["labels"]}
        outs.append(fn(params, vel, b))
    (p0, v0, m0), (p1, v1, m1) = outs
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(tree_leaves((p0, v0)), tree_leaves((p1, v1))):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# decode, step_for_shape
# --------------------------------------------------------------------------
def test_multi_decode_step_matches_reference(models):
    """``make_multi_decode_step(lm, 4)`` on the reduced yi-6b from index 3
    of a fresh cache (fp32 leaves on both sides): the four steps' logits,
    their argmax feedback and the final cache against the reference's."""
    jcfg, cfg, jlm, lm, jparams = models("yi-6b")
    n, S, idx = 4, 12, 3
    tok = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, 1),
                                            dtype=np.int32)
    jcache = {k: np.asarray(c, np.float32)
              for k, c in j_init_cache(jcfg, B, S).items()}
    jstep = jax.jit(j_steps.make_multi_decode_step(jlm, n,
                                                   kernel_force="ref"))
    jlogits, jout = jstep(jax.tree.map(jnp.asarray, jparams),
                          {"cache": jax.tree.map(jnp.asarray, jcache),
                           "cache_index": jnp.int32(idx),
                           "tokens": jnp.asarray(tok)})
    params = params_from_reference(jparams, device="cpu")
    cache = cache_from_reference(jcache, device="cpu")
    logits, out = steps.make_multi_decode_step(lm, n)(
        params, {"cache": cache, "cache_index": idx,
                 "tokens": torch.from_numpy(tok)})
    assert tuple(logits.shape) == tuple(jlogits.shape) == \
        (n, B, 1, cfg.vocab_size)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **STEP_TOL)
    got = cache_to_reference(out)
    for k in jout:
        np.testing.assert_allclose(got[k], np.asarray(jout[k]), **STEP_TOL,
                                   err_msg=k)


def test_step_for_shape_picks_the_mode(models):
    """``step_for_shape`` returns the train step (or a FeDepth block
    step) with an optimizer state, prefill and single / multi decode
    without."""
    lm = models("yi-6b")[3]
    shapes = SHAPE_BY_NAME
    fn, opt = steps.step_for_shape(lm, shapes["train_4k"])
    assert opt and fn.__name__ == "train_step"
    fn, opt = steps.step_for_shape(lm, shapes["train_4k"],
                                   fedepth_block=(0, 1))
    assert opt and fn.__name__ == "block_step"
    fn, opt = steps.step_for_shape(lm, shapes["prefill_32k"])
    assert not opt and fn.__name__ == "prefill_step"
    fn, opt = steps.step_for_shape(lm, shapes["decode_32k"])
    assert not opt and fn.__name__ == "decode_step"
    fn, opt = steps.step_for_shape(lm, shapes["decode_32k"],
                                   decode_tokens=4)
    assert not opt and fn.__name__ == "multi_decode"


# --------------------------------------------------------------------------
# the chunked plain attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 512])
def test_flash_chunked_matches_flash_jnp(window):
    """At Tq = Tk = 2080 (three key blocks of 1024, the last ragged;
    B 1, Hq 2 over Hkv 1, D 16; causal, and a 512 window): the chunked
    forward and the port's CPU ``ops.attention`` (which takes it there;
    backward ``ops.attention_bwd``) and its gradients within 1e-5 of
    ``flash_attention_jnp``."""
    rng = np.random.default_rng(8)
    Tq = 2080
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in
                  ((1, Tq, 2, 16), (1, Tq, 1, 16), (1, Tq, 1, 16),
                   (1, Tq, 2, 16)))

    @jax.jit
    def jfn(q, k, v, g):
        out, pull = jax.vjp(lambda *a: flash_attention_jnp(
            *a, True, window, 0, None), q, k, v)
        return out, pull(g)

    jout, jgrads = jfn(*map(jnp.asarray, (q, k, v, g)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.attention(tq, tk, tv, causal=True, sliding_window=window)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    direct = flash_chunked(tq.detach(), tk.detach(), tv.detach(),
                           causal=True, sliding_window=window)
    for got, want in [(direct, jout), (out.detach(), jout),
                      *zip(grads, jgrads)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_cpu_attention_takes_chunked_path_at_threshold(monkeypatch):
    """The CPU branch of K2's wrapper takes ``flash_chunked`` when Tq·Tk
    ≥ 2048² (the reference's ``_REF_NAIVE_MAX_T``), the whole-matrix
    plain version below; both agree there."""
    calls = []

    def recording(*a, **kw):
        calls.append(a[0].shape[1] * a[1].shape[1])
        return flash_chunked(*a, **kw)

    monkeypatch.setattr(fa_mod, "flash_chunked", recording)
    assert MIN_PAIRS == 2048 ** 2
    gen = torch.Generator().manual_seed(9)
    for Tq, taken in ((2047, False), (2048, True)):
        q = torch.randn(1, Tq, 1, 4, generator=gen)
        k = torch.randn(1, 2048, 1, 4, generator=gen)
        out = ops.attention(q, k, k, q_offset=2048 - Tq)
        assert bool(calls) == taken, (Tq, calls)
        plain = fa_mod.plain(q, k, k, q_offset=2048 - Tq)
        np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5)
    assert calls == [MIN_PAIRS]


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
CLI = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16"]


def test_train_cli_standard_mode():
    """``python -m repro_torch.launch.train --reduced --device cpu``:
    finite losses, the parameters moved, on the CPU."""
    res = train_main(["--arch", "yi-6b", "--steps", "2"] + CLI)
    assert len(res.losses) == len(res.seconds) == 2
    assert all(np.isfinite(res.losses)) and res.blocks is None
    init = build(get_reduced_config("yi-6b")).init(0, device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(res.params))
    assert not torch.equal(res.params["units"][0]["attn"]["wq"],
                           init["units"][0]["attn"]["wq"])


def test_train_cli_fedepth_mode_and_checkpoint(tmp_path):
    """``--fedepth`` on the reduced mamba2-370m at a 4 MB budget: the
    reference's schedule (two blocks, the same summary), two passes of it
    cycling ``s % n_blocks``, and ``--ckpt-dir``'s round read back by
    ``load_latest`` equal to the final parameters."""
    budget = 4.0
    res = train_main(["--arch", "mamba2-370m", "--steps", "4", "--fedepth",
                      "--budget-mb", str(budget), "--ckpt-dir",
                      str(tmp_path)] + CLI)
    jmem = j_memory.lm_memory(j_reduced("mamba2-370m"), 2, 16)
    jdec = j_decomposition.decompose(jmem, int(budget * 2**20))
    assert res.blocks == jdec.blocks and len(res.blocks) >= 2
    assert res.schedule == j_decomposition.schedule_summary(jdec, jmem)
    assert len(res.losses) == 4 and all(np.isfinite(res.losses))
    path, tree, meta = load_latest(str(tmp_path), device="cpu")
    assert path == res.checkpoint
    assert meta == {"arch": "mamba2-370m", "round": 4}
    for a, b in zip(tree_leaves(tree), tree_leaves(res.params)):
        assert torch.equal(a, b)
