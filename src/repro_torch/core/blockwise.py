"""Depth-wise sequential learning (paper Eq. 1 + Figure 4), LM part.

Port of ``repro.core.blockwise``: for a client with decomposition
{(lo_1, hi_1), ...}, solve J subproblems in order.  Subproblem j trains
ONLY units [lo_j, hi_j) plus the head φ; the prefix is frozen and its
output activation z_{lo_j - 1} is buffered (:class:`PrefixCache`, default
on): computed once per distinct batch per subproblem under ``no_grad``,
reused across every SGD step, and advanced through the just-trained units
between subproblems.

Ownership (the reference is functional, this port updates in place): a
client's update never writes a tensor it was given.  Each subproblem
trains private clones of its split (the block's units, the head, and the
embedding when ``lo == 0``); ``merge`` returns a new tree that shares every
other tensor with its input.  So a cohort's payloads share their frozen
tensors with the server state, and the next client in the cohort starts
from the untouched broadcast.

Two head strategies (paper §Methodology), on the ResNet runner:
``head="skip"`` (FeDepth: the block output zero-padded and pooled into
the shared classifier) and ``head="aux"`` (m-FeDepth: a tiny auxiliary
classifier per block exit; the final block trains the real head).  The
ViT runner (paper Fig. 7) takes ``"skip"``: the CLS token into the
shared head.  The LM runner covers every ported family (dense, moe, vlm,
ssm, hybrid, and whisper through :func:`_whisper_runner`, whose z is an
``{"enc", "dec"}`` pair) with ``"skip"`` and, except whisper, ``"aux"``
(m-FeDepth: per-block rms-norm scales ``aux_norms`` into the shared
head).

Stacked execution (the substrate of ``fl.sampling.VectorizedScheduler``):
:func:`client_update_batched` runs a group of clients that share one
decomposition as one computation over a leading client axis — the loss
``torch.func.vmap``-ed over the clients, plain autograd of the clients'
summed losses for every client's gradient at once (the reference's
``vmap(grad)``: clients share nothing, so each gets its own), the
momentum update on the stacked leaves outside it.  It covers every
runner: the image runners (ResNet, ViT) and each LM family, whose
kernels (K1–K4) batch over the client axis through the ``vmap`` rules of
``kernels/ops.py``, one launch a group.

Per-unit rematerialization: an LM runner's ``apply_units`` runs its
units through ``LM.apply_range`` with the models' default ``remat=True``,
as the reference's block steps do; the frozen prefix runs without grad,
where it changes nothing.  On the stacked path the rematerialized units
run under ``vmap`` through ``models.common._Recompute``.  The image
runners (ResNet, ViT) have no rematerialization, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.decomposition import Decomposition
from repro_torch.models import common, resnet as resnet_mod, vit as vit_mod
from repro_torch.obs import active as obs_active
from repro_torch.tree import tree_leaves, tree_map


# --------------------------------------------------------------------------
# family adapters
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockRunner:
    """Decomposes a model into (embed -> units -> head) for FeDepth."""
    n_units: int
    embed: Callable[[Any, Dict], torch.Tensor]            # params, batch -> z0
    apply_units: Callable[[Any, torch.Tensor, int, int], torch.Tensor]
    head_loss: Callable[[Any, torch.Tensor, Dict, int], torch.Tensor]
    # trainable subtree of units [lo, hi) + the head φ (+ embed at lo == 0)
    split: Callable[[Any, int, int], Any]
    merge: Callable[..., Any]
    # True when the params feeding ``embed`` and the prefix never change
    # while later subproblems train, so a buffered z_{lo-1} can be
    # advanced incrementally (False where head-trained keys reach the
    # prefix: tied embeddings, zamba2's shared block, whisper's enc_norm;
    # the prefix is then re-buffered per subproblem)
    prefix_stable: bool = True
    # model family ("resnet", "vit", "whisper" or the LM config's family)
    family: str = "?"


def lm_prefix_stable(cfg) -> bool:
    """``BlockRunner.prefix_stable`` of an LM config's runner.  A tied
    head trains the embedding table, the hybrid family's shared block
    (trained with the head) runs inside every group, and whisper's head
    holds its tied embedding and ``enc_norm``: each reaches the prefix
    forward, so buffers are re-buffered per subproblem."""
    return not (cfg.tie_embeddings or cfg.family == "hybrid"
                or cfg.is_encoder_decoder)


def lm_runner(lm, head: str = "skip") -> BlockRunner:
    """Runner over an ``LM`` (``repro_torch.models``) of any ported
    family.  The depth units live under ``params["units"]`` (dense, moe,
    vlm),
    ``params["layers"]`` (ssm) or ``params["mamba_groups"]`` (hybrid: one
    unit a group); whisper takes :func:`_whisper_runner`.

    ``head="aux"`` (m-FeDepth) normalises a block's exit with
    ``params["aux_norms"][block_idx]`` (one rms-norm scale per unit, from
    ``FedepthStrategy.init_state``) into the shared head, for every
    block but the last, which trains the real ``final_norm``.  A VLM
    batch's ``vision_embeds`` prefix the token embeddings and take no
    loss; as in the reference, ``apply_units`` passes no M-RoPE
    positions, so FeDepth runs 1-D RoPE over [vision; text]."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    cfg = lm.cfg
    if cfg.is_encoder_decoder:
        return _whisper_runner(lm)
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.family!r} runner is not ported yet")
    layers_key = {"dense": "units", "moe": "units", "vlm": "units",
                  "ssm": "layers", "hybrid": "mamba_groups"}[cfg.family]
    head_keys = {"final_norm", "lm_head", "aux_norms"}
    if cfg.family == "hybrid":
        head_keys |= {"shared", "invocation_norms"}
    if cfg.tie_embeddings:
        head_keys |= {"embed"}

    def embed(params, batch):
        if cfg.family in ("dense", "moe", "vlm"):
            return transformer.embed_inputs(
                params, cfg, batch["tokens"],
                vision_embeds=batch.get("vision_embeds"))
        return params["embed"][batch["tokens"]]

    def apply_units(params, z, lo, hi):
        # the MoE router's aux loss is dropped, as in the reference's
        # runner: a block's subproblem trains on the head's CE alone
        out, _aux = lm.apply_range(params, z, lo, hi)
        return out

    def head_loss(params, z, batch, block_idx):
        if (head == "aux" and "aux_norms" in params
                and block_idx < lm.num_depth_units - 1):
            norm_w = params["aux_norms"][block_idx]
        else:
            norm_w = params["final_norm"]
        x = common.rms_norm(z, norm_w, cfg.norm_eps)
        if batch.get("vision_embeds") is not None:
            # K1 reads the hidden states as one contiguous block
            x = x[:, batch["vision_embeds"].shape[1]:].contiguous()
        ce, _ = ops.cross_entropy(x, common.head_weight(params, cfg),
                                  batch["labels"])
        return ce

    def split(params, lo, hi):
        train = {k: v for k, v in params.items() if k in head_keys}
        train[layers_key] = params[layers_key][lo:hi]
        if lo == 0 and "embed" not in train:
            train["embed"] = params["embed"]
        return train

    def merge(params, train, lo: int = None, hi: int = None):
        out = dict(params)
        for k, v in train.items():
            if k == layers_key:
                out[k] = params[k][:lo] + list(v) + params[k][hi:]
            else:
                out[k] = v
        return out

    return BlockRunner(lm.num_depth_units, embed, apply_units, head_loss,
                       split, merge, prefix_stable=lm_prefix_stable(cfg),
                       family=cfg.family)


def _whisper_runner(lm) -> BlockRunner:
    """Whisper: the units are the encoder layers, then the decoder
    layers; z is the ``{"enc", "dec"}`` pair (frames, tokens), so the
    encoder output is a buffered activation for the decoder blocks; the
    head is ``dec_norm`` and the tied embedding.  ``enc_norm`` (applied
    where the encoder ends) trains with the head, the positions with
    block 0, and the runner reports ``prefix_stable=False``."""
    from repro_torch.kernels import ops
    from repro_torch.models import whisper

    cfg = lm.cfg
    E = cfg.encoder_layers
    head_keys = ("dec_norm", "embed", "enc_norm")

    def ranges(lo, hi):
        return (min(lo, E), min(hi, E)), (max(lo - E, 0), max(hi - E, 0))

    def embed(params, batch):
        return {"enc": whisper.embed_frames(params, batch["encoder_embeds"]),
                "dec": whisper.embed_tokens(params, batch["tokens"])}

    def apply_units(params, z, lo, hi):
        enc, dec = z["enc"], z["dec"]
        (e_lo, e_hi), (d_lo, d_hi) = ranges(lo, hi)
        if e_hi > e_lo:
            enc = whisper.encoder_range(params, cfg, enc, e_lo, e_hi)
        if d_hi > d_lo:
            dec = whisper.apply_decoder_range(params, cfg, dec, enc, d_lo,
                                              d_hi)
        return {"enc": enc, "dec": dec}

    def head_loss(params, z, batch, block_idx):
        x = whisper.ln(z["dec"], params["dec_norm"], cfg.norm_eps)
        ce, _ = ops.cross_entropy(x, params["embed"].T, batch["labels"])
        return ce

    def split(params, lo, hi):
        train = {k: params[k] for k in head_keys}
        (e_lo, e_hi), (d_lo, d_hi) = ranges(lo, hi)
        if e_hi > e_lo:
            train["enc_layers"] = params["enc_layers"][e_lo:e_hi]
        if d_hi > d_lo:
            train["dec_layers"] = params["dec_layers"][d_lo:d_hi]
        if lo == 0:
            train["pos_enc"] = params["pos_enc"]
            train["pos_dec"] = params["pos_dec"]
        return train

    def merge(params, train, lo: int = None, hi: int = None):
        out = dict(params)
        (e_lo, e_hi), (d_lo, d_hi) = ranges(lo, hi)
        for k, v in train.items():
            if k == "enc_layers":
                out[k] = params[k][:e_lo] + list(v) + params[k][e_hi:]
            elif k == "dec_layers":
                out[k] = params[k][:d_lo] + list(v) + params[k][d_hi:]
            else:
                out[k] = v
        return out

    return BlockRunner(E + cfg.num_layers, embed, apply_units, head_loss,
                       split, merge, prefix_stable=lm_prefix_stable(cfg),
                       family="whisper")


# ---- ResNet adapter -------------------------------------------------------
def resnet_runner(cfg, head: str = "skip") -> BlockRunner:
    """Runner over PreResNet: the stem is the embed, the residual blocks
    (``params["blocks"]``, a list: stages differ in width) the units."""
    n = cfg.num_blocks

    def embed(params, batch):
        return resnet_mod.stem(params, batch["images"])

    def apply_units(params, z, lo, hi):
        return resnet_mod.forward_blocks(params, cfg, z, lo, hi)

    def head_loss(params, z, batch, block_idx):
        # m-FeDepth: auxiliary classifiers at intermediate exits, but the
        # FINAL block supervises the REAL head (otherwise the global
        # classifier never receives gradient)
        if head == "aux" and "aux_heads" in params and block_idx < n - 1:
            ah = params["aux_heads"][f"b{block_idx}"]
            logits = z.mean((2, 3)) @ ah["w"] + ah["b"]
        else:
            logits = resnet_mod.head_from_block(params, cfg, z, block_idx)
        return _ce_logits(logits, batch["labels"])

    def split(params, lo, hi):
        train = {"blocks": params["blocks"][lo:hi],
                 "head_norm": params["head_norm"],
                 "classifier": params["classifier"]}
        if "aux_heads" in params:
            train["aux_heads"] = params["aux_heads"]
        if lo == 0:
            train["stem"] = params["stem"]
        return train

    return BlockRunner(n, embed, apply_units, head_loss, split,
                       _merge_blocks, family="resnet")


# ---- ViT adapter ----------------------------------------------------------
def vit_runner(cfg) -> BlockRunner:
    """Runner over ViT (paper Fig. 7): the patch embedding (with the CLS
    token and positions) is the embed, the encoder blocks
    (``params["blocks"]``, a list) the units, the CLS token's norm and
    classifier the head."""

    def embed(params, batch):
        return vit_mod.embed(params, cfg, batch["images"])

    def apply_units(params, z, lo, hi):
        return vit_mod.forward_blocks(params, cfg, z, lo, hi)

    def head_loss(params, z, batch, block_idx):
        return _ce_logits(vit_mod.head(params, cfg, z), batch["labels"])

    def split(params, lo, hi):
        train = {"blocks": params["blocks"][lo:hi],
                 "head_norm": params["head_norm"],
                 "classifier": params["classifier"]}
        if lo == 0:
            for k in ("patch_embed", "cls", "pos"):
                train[k] = params[k]
        return train

    return BlockRunner(cfg.num_layers, embed, apply_units, head_loss, split,
                       _merge_blocks, family="vit")


def _merge_blocks(params, train, lo: int = None, hi: int = None):
    """The image runners' merge: a splice of exactly [lo, hi) into the
    block list, the head / embed keys passed through; the input tree is
    never written."""
    out = dict(params)
    out["blocks"] = (list(params["blocks"][:lo]) + list(train["blocks"])
                     + list(params["blocks"][hi:]))
    for k in train:
        if k != "blocks":
            out[k] = train[k]
    return out


def _ce_logits(logits, labels):
    """Mean cross-entropy of (B, C) logits, in fp32 (float64 for float64
    logits)."""
    return F.cross_entropy(logits.to(common.stat_dtype(logits)),
                           labels.long())


# --------------------------------------------------------------------------
# the depth-wise sequential client update (paper Algorithm 1, ClientUpdate)
# --------------------------------------------------------------------------
def block_loss_fn(runner: BlockRunner, params_full, train_params, z_in,
                  batch, lo: int, hi: int, block_idx: int):
    """Loss of subproblem j: head(block(z_in)) with the prefix frozen.
    ``train_params`` are the differentiated leaves; everything else comes
    from ``params_full``, detached."""
    frozen = tree_map(torch.Tensor.detach, params_full)
    merged = runner.merge(frozen, train_params, lo=lo, hi=hi)
    z = runner.apply_units(merged, tree_map(torch.Tensor.detach, z_in), lo,
                           hi)
    return runner.head_loss(merged, z, batch, hi - 1)


def _prox_term(train, anchor, prox_mu: float):
    sq = sum(((a - b) ** 2).sum() for a, b in zip(tree_leaves(train),
                                                  tree_leaves(anchor)))
    return 0.5 * prox_mu * sq


def sgd_momentum_(loss_fn: Callable[[], torch.Tensor], params, vel, *,
                  lr: float, momentum: float) -> None:
    """One SGD-momentum step, in place on the caller's private trees:
    vel <- momentum * vel + grad(loss_fn()); params <- params - lr * vel.
    A leaf the loss does not reach (the embedding of an untied LM, whose
    lookup feeds the frozen z_in) has zero gradient, as in the
    reference."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        grads = list(torch.autograd.grad(loss_fn(), leaves,
                                         allow_unused=True))
    finally:
        for t in leaves:
            t.requires_grad_(False)
    with torch.no_grad():
        for i, (t, v) in enumerate(zip(leaves, tree_leaves(vel))):
            # each gradient is released once applied, so that the step's
            # ``lr * v`` temporary reuses its memory
            g, grads[i] = grads[i], None
            v.mul_(momentum)
            if g is not None:
                v.add_(g)
            del g
            t.sub_(lr * v)


def _sgd_momentum_step(runner, params, train, vel, anchor, z_in, batch,
                       lo, hi, j, *, lr, momentum, prox_mu):
    """The block step's update on the client's private ``train`` /
    ``vel``."""
    def loss():
        out = block_loss_fn(runner, params, train, z_in, batch, lo, hi, j)
        if prox_mu > 0:
            out = out + _prox_term(train, anchor, prox_mu)
        return out

    sgd_momentum_(loss, train, vel, lr=lr, momentum=momentum)
    return train, vel


def make_block_step(runner: BlockRunner, lo: int, hi: int, j: int, *,
                    lr: float, momentum: float, prox_mu: float = 0.0):
    """One SGD-momentum step on subproblem j, recompute variant: the
    frozen prefix forward runs inside every step (the reference path
    behind ``prefix_cache=False``)."""

    def step(params, train, vel, anchor, batch):
        with torch.no_grad():
            z_in = runner.embed(params, batch)
            if lo > 0:
                z_in = runner.apply_units(params, z_in, 0, lo)
        return _sgd_momentum_step(runner, params, train, vel, anchor, z_in,
                                  batch, lo, hi, j, lr=lr, momentum=momentum,
                                  prox_mu=prox_mu)

    return step


def make_buffered_block_step(runner: BlockRunner, lo: int, hi: int, j: int,
                             *, lr: float, momentum: float,
                             prox_mu: float = 0.0):
    """The :class:`PrefixCache` hot-path step: the same update rule, with
    the buffered prefix activation ``z_in`` as an argument — each step runs
    one block-local forward + backward, nothing else."""

    def step(params, train, vel, anchor, z_in, batch):
        return _sgd_momentum_step(runner, params, train, vel, anchor, z_in,
                                  batch, lo, hi, j, lr=lr, momentum=momentum,
                                  prox_mu=prox_mu)

    return step


def make_prefix_forward(runner: BlockRunner, lo: int):
    """From-scratch prefix forward z_{lo-1} = units[0, lo) over the embed
    output, without autograd (pure buffering)."""

    @torch.no_grad()
    def fwd(params, batch):
        z = runner.embed(params, batch)
        if lo > 0:
            z = runner.apply_units(params, z, 0, lo)
        return z

    return fwd


def make_prefix_advance(runner: BlockRunner, lo: int, hi: int):
    """Incremental advance: push a buffered z_{lo-1} through units
    [lo, hi) — the just-trained block — to obtain z_{hi-1}."""

    @torch.no_grad()
    def adv(params, z):
        return runner.apply_units(params, z, lo, hi)

    return adv


class PrefixCache:
    """Buffered z_{lo-1} activations for one client's depth-wise update.

    Per subproblem [lo, hi), :meth:`prepare` buffers the frozen-prefix
    output ONCE per distinct batch; every SGD step reuses its buffer.
    Between subproblems the buffers are advanced through the just-trained
    units when ``runner.prefix_stable``; otherwise they are re-buffered
    from scratch (still once per subproblem).  :meth:`buffered_bytes` is
    the quantity ``core.memory_model.ModelMemory.buffered_z_bytes``
    prices."""

    def __init__(self, runner: BlockRunner):
        self.runner = runner
        self.zs: Optional[list] = None   # one buffer per distinct batch
        self._lo: Optional[int] = None   # prefix depth of the buffers

    def reset(self) -> None:
        """Drop the buffers, so a reused instance never serves one
        client's activations to the next."""
        self.zs = None
        self._lo = None

    def prepare(self, params, batches, lo: int) -> list:
        """Buffer (or advance) z_{lo-1} for every batch; the advance only
        runs forward (lo above the buffered depth), anything else
        re-buffers."""
        obs = obs_active()
        if (self.zs is None or not self.runner.prefix_stable
                or lo < self._lo):
            fresh = self.zs is None
            fwd = make_prefix_forward(self.runner, lo)
            self.zs = [fwd(params, b) for b in batches]
            if obs is not None:
                # first buffering of an update vs a forced re-buffer
                # (unstable prefix / backward transition)
                obs.metrics.counter(
                    "prefix_cache_buffer" if fresh
                    else "prefix_cache_rebuffer").inc()
        elif lo != self._lo:
            adv = make_prefix_advance(self.runner, self._lo, lo)
            self.zs = [adv(params, z) for z in self.zs]
            if obs is not None:
                obs.metrics.counter("prefix_cache_advance").inc()
        self._lo = lo
        if obs is not None:
            obs.metrics.gauge("prefix_cache_buffered_bytes").set(
                self.buffered_bytes())
        return self.zs

    def buffered_bytes(self) -> int:
        """Bytes held by the buffers, every leaf of a dict z (whisper's
        ``{"enc", "dec"}``) counted."""
        if self.zs is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self.zs))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _audited(step, audit, **cell):
    """``step`` whose FIRST call runs through the memory auditor
    (``obs.audit.audit_block_step``: measured once per cell, the same
    call, so the run is unchanged); later calls go straight through."""
    first = [True]

    def run(*args):
        if first[0]:
            first[0] = False
            return audit.audit_block_step(step, args, **cell)
        return step(*args)

    return run


def client_update(runner: BlockRunner, params, dec: Decomposition, batches,
                  *, lr: float = 0.1, momentum: float = 0.9,
                  local_steps: int = 1, prox_mu: float = 0.0,
                  prefix_cache: Union[bool, PrefixCache] = True):
    """Sequential depth-wise local update.  ``batches``: list of data
    batches cycled within each subproblem.  Returns the updated full
    params: a new tree sharing every untrained tensor with ``params``,
    which is never written.

    SGD with momentum per subproblem, momentum reset per block (each
    subproblem is its own optimization, paper Eq. 1).  ``prox_mu`` adds
    the FedProx term.  ``prefix_cache`` selects the execution contract:
    ``True`` buffers z_{lo-1} via :class:`PrefixCache`, ``False`` re-runs
    the prefix inside every step; pass a :class:`PrefixCache` to inspect
    the buffers afterwards."""
    cache: Optional[PrefixCache] = None
    if isinstance(prefix_cache, PrefixCache):
        cache = prefix_cache
        cache.reset()
    elif prefix_cache:
        cache = PrefixCache(runner)
    # The caller's storages are never written.  A leaf that an earlier
    # block trained (the head, every block's) is the client's own copy;
    # with the prefix buffered before the block's steps and no FedProx
    # anchor, nothing reads its old value again, so the block trains it
    # in place rather than holding a second copy.
    given = {_storage(t) for t in tree_leaves(params)}
    in_place = cache is not None and prox_mu == 0

    def private(t):
        t = t.detach()
        return t if in_place and _storage(t) not in given else t.clone()

    obs = obs_active()
    for j, (lo, hi) in enumerate(dec.blocks):
        block_span = None if obs is None else \
            obs.tracer.begin("block", lo=lo, hi=hi, j=j)
        zs = cache.prepare(params, batches, lo) if cache is not None \
            else None
        anchor = runner.split(params, lo, hi)
        train = tree_map(private, anchor)
        vel = tree_map(torch.zeros_like, train)
        make = make_buffered_block_step if cache is not None \
            else make_block_step
        step = make(runner, lo, hi, j, lr=lr, momentum=momentum,
                    prox_mu=prox_mu)
        if obs is not None and obs.audit is not None:
            step = _audited(step, obs.audit, family=runner.family, lo=lo,
                            hi=hi, variant="buffered" if cache is not None
                            else "recompute", n_batches=len(batches))
        for _ in range(local_steps):
            if cache is not None:
                for z_in, batch in zip(zs, batches):
                    train, vel = step(params, train, vel, anchor, z_in,
                                      batch)
            else:
                for batch in batches:
                    train, vel = step(params, train, vel, anchor, batch)
        del vel, anchor
        params = runner.merge(params, train, lo=lo, hi=hi)
        if block_span is not None:
            obs.tracer.end(block_span)
    return params


def full_model_loss(runner: BlockRunner, params, batch):
    """End-to-end loss through all units (eval)."""
    z = runner.embed(params, batch)
    z = runner.apply_units(params, z, 0, runner.n_units)
    return runner.head_loss(params, z, batch, runner.n_units - 1)


# --------------------------------------------------------------------------
# stacked (vmap-over-clients) execution — substrate of VectorizedScheduler
# --------------------------------------------------------------------------

def broadcast_tree(tree, group: int):
    """Stack ``tree`` along a new leading client axis of size ``group``.
    Each leaf is a private copy (FedAvg's group update trains the
    stacked leaves in place)."""
    return tree_map(lambda x: x.unsqueeze(0).expand(group, *x.shape)
                    .clone(), tree)


def unstack_tree(tree, group: int):
    """Split a leading client axis back into per-client trees (views)."""
    return [tree_map(lambda x, i=i: x[i], tree) for i in range(group)]


def batch_signature(batches) -> tuple:
    """Shape / dtype signature of one client's batch list; two clients
    are stackable iff their signatures are equal."""
    return tuple(tuple((tuple(leaf.shape), str(leaf.dtype))
                       for leaf in tree_leaves(b)) for b in batches)


def stackable(batches_per_client) -> bool:
    """True when every client's batch list can be stacked into one
    ``(clients, batches, ...)`` tree (same count, shapes, dtypes)."""
    return len({batch_signature(b) for b in batches_per_client}) == 1


def stack_batches(batches_per_client):
    """Stack per-client batch lists into a ``(clients, batches, ...)``
    tree: client order on axis 0, the round's batch list on axis 1 (each
    distinct batch is stored once; :func:`run_local_steps` repeats the
    list ``local_steps`` times)."""
    def stack(*xs):
        return torch.stack([torch.as_tensor(x) for x in xs])

    return tree_map(stack, *[tree_map(stack, *batches)
                             for batches in batches_per_client])


def run_local_steps(step, carry, batches, local_steps: int):
    """Run ``local_steps`` passes of ``step(carry, batch) -> carry`` over
    the batch axis (axis 1) of a stacked ``(clients, batches, ...)``
    tree, in the sequential path's order: ``for local_steps: for
    batch``."""
    n_batches = tree_leaves(batches)[0].shape[1]
    for s in range(local_steps * n_batches):
        carry = step(carry, tree_map(lambda x, i=s % n_batches: x[:, i],
                                     batches))
    return carry


def stacked_grads(loss, in_dims):
    """``grads(train, *rest)``: every client's gradient of ``loss(train,
    *rest)`` with respect to its own ``train``, over stacked ``(clients,
    ...)`` leaves, as a list in ``tree_leaves(train)`` order.  The loss
    is vmapped over the clients (``in_dims`` as ``torch.func.vmap``
    takes them), then plain autograd takes the summed losses' gradient:
    clients share nothing, so each client's slice of it is its own
    gradient, as ``vmap(grad(loss))`` gives it.  (``torch.func.grad``
    under ``vmap`` keeps about twice the activations of plain autograd:
    it OOMed a group of 4 full-width mamba2-370m clients on an 80 GB
    card.)  A leaf the loss does not reach (an untied LM's embedding at
    ``lo == 0``) has zero gradient, as on the sequential path."""
    losses = torch.func.vmap(loss, in_dims=in_dims)

    def grads(train, *rest):
        leaves = tree_leaves(train)
        for t in leaves:
            t.requires_grad_(True)
        try:
            out = torch.autograd.grad(losses(train, *rest).sum(), leaves,
                                      allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        return [torch.zeros_like(t) if g is None else g
                for t, g in zip(leaves, out)]

    return grads


@torch.no_grad()
def _momentum_step_(train, vel, grads, *, lr: float, momentum: float):
    """The sequential step's update on stacked leaves, in place:
    vel <- momentum * vel + grad; train <- train - lr * vel."""
    torch._foreach_mul_(vel, momentum)
    torch._foreach_add_(vel, grads)
    torch._foreach_sub_(train, torch._foreach_mul(vel, lr))


def make_group_update(runner: BlockRunner, blocks, *, lr: float,
                      momentum: float, local_steps: int = 1,
                      prox_mu: float = 0.0, prefix_cache: bool = True):
    """The group update: a whole depth-wise local update (all blocks, all
    SGD steps) over stacked ``(clients, ...)`` parameters and batches.
    Each step takes every client's gradient in one backward pass — the
    loss vmapped over the clients, then ``torch.autograd.grad`` of the
    summed losses, vs. clients x blocks x steps autograd calls on the
    sequential path (:func:`stacked_grads`) — and the momentum update on
    the stacked leaves.

    ``blocks`` is the shared ``Decomposition.blocks``; momentum and the
    FedProx anchor reset per block, as in :func:`client_update`, and
    steps visit ``local_steps`` repetitions of the batch axis in the
    sequential order.  With ``prefix_cache`` (default) the buffered
    z_{lo-1} is computed once per distinct batch per subproblem,
    vmapped over the clients, and advanced through the just-trained
    units when ``runner.prefix_stable`` (re-buffered per subproblem
    otherwise: tied heads, zamba2, whisper).  Every runner takes it: an
    LM runner's kernels launch once per step for the whole group
    (``kernels/ops.py``'s vmap rules).  The returned function trains
    clones of each block's split and returns a new stacked tree; the
    stacked parameters it is given are not written."""
    vmap = torch.func.vmap

    def make_step(lo, hi, j, anchor, params):
        def loss(tp, params, anchor, z_in, batch):
            if z_in is None:
                z_in = make_prefix_forward(runner, lo)(params, batch)
            out = block_loss_fn(runner, params, tp, z_in, batch, lo, hi, j)
            if prox_mu > 0:
                out = out + _prox_term(tp, anchor, prox_mu)
            return out

        grads = stacked_grads(loss, in_dims=(0, 0, 0, 0 if prefix_cache
                                             else None, 0))

        def step(carry, x):
            train, vel = carry
            z_in, batch = x if prefix_cache else (None, x)
            g = grads(train, params, anchor, z_in, batch)
            _momentum_step_(tree_leaves(train), tree_leaves(vel), g, lr=lr,
                            momentum=momentum)
            return train, vel

        return step

    def update(params, batches):
        n_batches = tree_leaves(batches)[0].shape[1]
        zs, prev_lo = None, None
        for j, (lo, hi) in enumerate(blocks):
            if prefix_cache:
                if zs is None or not runner.prefix_stable:
                    fwd = vmap(make_prefix_forward(runner, lo))
                    zs = [fwd(params, tree_map(lambda x, i=i: x[:, i],
                                               batches))
                          for i in range(n_batches)]
                elif lo != prev_lo:
                    adv = vmap(make_prefix_advance(runner, prev_lo, lo))
                    zs = [adv(params, z) for z in zs]
                prev_lo = lo
            anchor = runner.split(params, lo, hi)
            train = tree_map(torch.clone, anchor)
            vel = tree_map(torch.zeros_like, train)
            step = make_step(lo, hi, j, anchor, params)
            # the buffers on the batch axis (a dict z, whisper's
            # {"enc", "dec"}, stacked leaf by leaf)
            data = ((tree_map(lambda *z: torch.stack(z, 1), *zs), batches)
                    if prefix_cache else batches)
            train, vel = run_local_steps(step, (train, vel), data,
                                         local_steps)
            del vel, anchor
            params = runner.merge(params, train, lo=lo, hi=hi)
        return params

    return update


def group_update_for(runner: BlockRunner, dec: Decomposition, *,
                     lr: float = 0.1, momentum: float = 0.9,
                     local_steps: int = 1, prox_mu: float = 0.0,
                     prefix_cache: bool = True):
    """The group update for one decomposition: the function
    :func:`client_update_batched` runs (eager, so nothing is compiled or
    cached)."""
    return make_group_update(runner, dec.blocks, lr=lr, momentum=momentum,
                             local_steps=local_steps, prox_mu=prox_mu,
                             prefix_cache=bool(prefix_cache))


def client_update_batched(runner: BlockRunner, params, dec: Decomposition,
                          batches_per_client, *, lr: float = 0.1,
                          momentum: float = 0.9, local_steps: int = 1,
                          prox_mu: float = 0.0, prefix_cache: bool = True):
    """Depth-wise local updates for a GROUP of clients sharing one
    decomposition, as one stacked computation.

    Same contract as calling :func:`client_update` once per client (every
    client starts from ``params``, which is never written; only the data
    differs), modulo float associativity of the batched operations.
    Returns the per-client updated trees, in the order of
    ``batches_per_client``."""
    update = group_update_for(runner, dec, lr=lr, momentum=momentum,
                              local_steps=local_steps, prox_mu=prox_mu,
                              prefix_cache=prefix_cache)
    group = len(batches_per_client)
    out = update(broadcast_tree(params, group),
                 stack_batches(batches_per_client))
    return unstack_tree(out, group)
