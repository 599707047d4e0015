"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``): parameter specs for every
architecture at its published widths, fsdp on and off, on meshes (16, 16),
(2, 16, 16), (2, 2) and (1, 1); batch and decode-cache specs for every
applicable shape; the meta ``abstract_params`` against the reference's
``eval_shape`` tree.  All exact tuple equality.

Both sides cut depth to two units (``dryrun.depth_scaled``): the rules
read no depth (a stacked dim is always None, and fsdp is given), and the
reference's eval_shape of qwen3-moe's 94 layers alone takes ~27 s."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.configs.shapes import input_specs as j_input_specs  # noqa: E402
from repro.configs.shapes import shape_applicable as j_applicable  # noqa: E402
from repro.launch import sharding as j_sharding  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import SHAPE_BY_NAME  # noqa: E402
from repro_torch.launch import sharding, steps  # noqa: E402
from repro_torch.launch.mesh import batch_axes  # noqa: E402
from repro_torch.models import build  # noqa: E402
from torch_helpers import abstract_mesh  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


def _units(cfg, n):
    """``cfg`` at n depth units (``repro_torch.launch.dryrun.depth_scaled``
    without importing the dry run here)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=n * cfg.hybrid_attn_every)
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, encoder_layers=n, num_layers=n)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, num_layers=n)
    return dataclasses.replace(cfg, num_layers=n * cfg.moe_every)


def _j_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists (tuples are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _ref_path(path, cfg):
    """A port leaf's path in the reference's stacked tree: the list
    positions go (a transformer's one-layer unit is the reference's
    ``sub_0``)."""
    parts = path.split("/")
    if parts[0] == "units":
        rest = parts[2:]
        return "/".join(["units"] + (["sub_0"] if cfg.moe_every == 1
                                     else []) + rest)
    if parts[0] in ("layers", "enc_layers", "dec_layers"):
        return "/".join([parts[0]] + parts[2:])
    if parts[0] == "mamba_groups":
        return "/".join([parts[0]] + parts[3:])
    return path


_CACHE = {}


def _trees(arch):
    """(port cfg, port meta params, reference cfg, reference eval_shape
    params), at two depth units, cached per arch."""
    if arch not in _CACHE:
        cfg = _units(get_config(arch), 2)
        jcfg = _units(j_config(arch), 2)
        _CACHE[arch] = (cfg, steps.abstract_params(build(cfg)), jcfg,
                        j_steps.abstract_params(j_build(jcfg)))
    return _CACHE[arch]


def _ref_flat(jparams):
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        flat["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)] = leaf
    return flat


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_reference(arch):
    """Every meta leaf has the reference's shape (its stacked dims
    dropped) and dtype (bf16), and every reference leaf is covered."""
    cfg, params, _, jparams = _trees(arch)
    ref = _ref_flat(jparams)
    seen = set()
    for path, t in _flat(params).items():
        rp = _ref_path(path, cfg)
        j = ref[rp]
        seen.add(rp)
        stack = len(j.shape) - t.dim()
        assert t.device.type == "meta", path
        assert tuple(j.shape[stack:]) == tuple(t.shape), path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    assert seen == set(ref)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh, fsdp):
    """``param_specs`` equals the reference's leaf for leaf: the same
    tuple once the reference's leading stacked Nones are dropped (a
    replicated leaf is ``()`` on both sides)."""
    cfg, params, jcfg, jparams = _trees(arch)
    port = _flat(sharding.param_specs(cfg, params,
                                      abstract_mesh(*MESHES[mesh]),
                                      fsdp=fsdp))
    ref = _ref_flat(j_sharding.param_specs(jcfg, jparams, _j_mesh(mesh),
                                           fsdp=fsdp))
    ref_leaves = _ref_flat(jparams)
    assert {_ref_path(p, cfg) for p in port} == set(ref)
    for path, spec in port.items():
        rp = _ref_path(path, cfg)
        j = tuple(ref[rp])
        stack = len(ref_leaves[rp].shape) - params_dim(params, path)
        if j == ():
            assert spec == (), path
        else:
            assert j[:stack] == (None,) * stack, (path, j)
            assert spec == j[stack:], (path, spec, j)
    # placements: one per mesh dim, Shard(d) where tensor dim d names it
    spec = next(s for s in port.values() if s and any(s))
    pls = sharding.placements(spec, abstract_mesh(*MESHES[mesh]))
    assert len(pls) == len(MESHES[mesh][0])


def params_dim(params, path):
    return _flat(params)[path].dim()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch, mesh):
    """``batch_specs`` (with the decode cache's ``cache_specs_sharding``)
    for every applicable shape, equal to the reference's tuple for
    tuple; ``batch_axes`` names the reference's batch axes."""
    cfg, jcfg = get_config(arch), j_config(arch)
    pm, jm = abstract_mesh(*MESHES[mesh]), _j_mesh(mesh)
    assert batch_axes(pm) == tuple(a for a in MESHES[mesh][1]
                                   if a in ("pod", "data"))
    n = 0
    for js in J_SHAPES:
        if not j_applicable(jcfg, js)[0]:
            continue
        port = sharding.batch_specs(cfg, SHAPE_BY_NAME[js.name], pm)
        ref = j_sharding.batch_specs(jcfg, js, jm)
        assert set(port) == set(ref), js.name
        for k, v in ref.items():
            if k == "cache":
                assert {c: tuple(s) for c, s in v.items()} == port[k], k
            else:
                assert tuple(v) == port[k], (js.name, k)
        n += 1
    assert n >= 2
    # the cache rules alone, on the reference's cache specs' shapes
    js = next(s for s in J_SHAPES if s.mode == "decode")
    jcache = j_input_specs(jcfg, js)["cache"]
    port = sharding.cache_specs_sharding(
        cfg, {k: SimpleNamespace(shape=v.shape) for k, v in jcache.items()},
        pm)
    ref = j_sharding.cache_specs_sharding(jcfg, jcache, jm)
    assert port == {k: tuple(v) for k, v in ref.items()}
    assert sharding.opt_state_specs(port) is port


def test_needs_fsdp_matches_reference():
    for arch in ARCH_IDS:
        assert sharding.needs_fsdp(get_config(arch)) == \
            j_sharding.needs_fsdp(j_config(arch)), arch
    assert sharding.FSDP_THRESHOLD == j_sharding.FSDP_THRESHOLD


def test_abstract_opt_state_is_fp32_meta():
    cfg, params, _, _ = _trees("yi-6b")
    opt = _flat(steps.abstract_opt_state(params))
    for path, t in _flat(params).items():
        assert opt[path].dtype == torch.float32
        assert opt[path].device.type == "meta"
        assert opt[path].shape == t.shape
    assert np.all([t.dtype == torch.bfloat16
                   for t in _flat(params).values()])
