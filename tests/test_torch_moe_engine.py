"""Training the MoE family vs the reference (PyTorch port): the LM
runner of qwen3-moe-235b-a22b (``"skip"`` and m-FeDepth's ``"aux"``) and
of llama4-maverick-400b-a17b (two sublayers a unit, at 4 layers: two
units), each with a two-block client update, and two FeDepth rounds of
reduced qwen3-moe through the engine.  The reference runs with
``kernel_force="ref"``, the port on the CPU; parameters are the
reference's (converted, ``test_torch_moe.setup``), inputs from numpy
seeds.  Tolerances: atol 1e-5 / rtol 1e-4 (runner, client update);
server parameters atol 1e-4 / rtol 1e-3, as the other families' engine
tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.core import blockwise as jbw  # noqa: E402
from repro.core.decomposition import Decomposition  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import blockwise as tbw  # noqa: E402
from repro_torch.core.decomposition import Decomposition as TDec  # noqa: E402
from repro_torch.testing.convert import params_to_reference  # noqa: E402

from test_torch_moe import ATOL, RTOL, _batch, _close, setup  # noqa: E402,F401
from torch_helpers import (assert_trees_close, lm_engine_parity,  # noqa: E402,F401
                           one_torch_thread)


@pytest.mark.parametrize("arch,head", [
    ("qwen3-moe-235b-a22b", "skip"), ("qwen3-moe-235b-a22b", "aux"),
    ("llama4-maverick-400b-a17b", "skip")])
def test_runner_matches_reference(setup, arch, head):
    """``lm_runner``: embed, every [lo, hi) (the aux loss dropped),
    head_loss through each exit (m-FeDepth's ``aux_norms`` for the first
    unit), split's keys, and a two-block client update."""
    jcfg, cfg, jlm, lm, jparams, params = setup(arch)
    if head == "aux":
        rows = 1 + 0.1 * np.random.default_rng(4).standard_normal(
            (2, cfg.d_model)).astype(np.float32)
        jparams = {**jparams, "aux_norms": rows}
        params = {**params, "aux_norms": torch.tensor(rows)}
    jr = jbw.lm_runner(jlm, head=head, kernel_force="ref")
    tr = tbw.lm_runner(lm, head=head)
    assert (tr.n_units, tr.prefix_stable, tr.family) == \
        (jr.n_units, jr.prefix_stable, "moe") == (2, True, "moe")
    jb, tb = _batch(cfg)
    j_apply = jax.jit(jr.apply_units, static_argnums=(2, 3))
    j_head = jax.jit(jr.head_loss, static_argnums=3)
    z0 = jr.embed(jparams, jb)
    _close(tr.embed(params, tb), z0, "embed", atol=0, rtol=0)
    for lo, hi in ((0, 1), (1, 2), (0, 2)):
        z_in = j_apply(jparams, z0, 0, lo) if lo else z0
        z = j_apply(jparams, z_in, lo, hi)
        _close(tr.apply_units(params, torch.tensor(np.asarray(z_in)), lo,
                              hi), z, f"{arch} [{lo}, {hi})")
        _close(tr.head_loss(params, torch.tensor(np.asarray(z)), tb,
                            hi - 1).item(),
               j_head(jparams, z, jb, hi - 1),
               f"{arch} head_loss {hi - 1}")
        assert set(tr.split(params, lo, hi)) == set(jr.split(jparams, lo,
                                                             hi))
    blocks = ((0, 1), (1, 2))
    batches = [_batch(cfg, seed=s) for s in (8, 9)]
    kw = dict(lr=0.05, momentum=0.9, local_steps=1)
    jout = jbw.client_update(jr, jax.tree.map(jnp.asarray, jparams),
                             Decomposition(blocks, 0, 0),
                             [b[0] for b in batches], **kw)
    out = tbw.client_update(tr, params, TDec(blocks, 0, 0),
                            [b[1] for b in batches], **kw)
    assert_trees_close(params_to_reference(out),
                       jax.tree.map(np.asarray, jout),
                       f"{arch} {head} client update", atol=ATOL, rtol=RTOL)


def test_two_rounds_match_reference_engine():
    """Two FeDepth rounds of reduced qwen3-moe (6 clients, participation
    0.5, fair budgets over 72-token sequences, sim seed 1: a two-block
    client in the cohorts); llama4's two-sublayer units train through
    the runner's client update above."""
    arch = "qwen3-moe-235b-a22b"
    lm_engine_parity(j_reduced(arch), get_reduced_config(arch), "fedepth",
                     data=dict(n_per_client=8, n_test=8, seq_len=72,
                               seed=0),
                     sim=dict(rounds=2, participation=0.5, lr=0.05,
                              momentum=0.9, local_steps=1, batch_size=4,
                              scenario="fair", seed=1))
