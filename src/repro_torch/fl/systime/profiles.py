"""Device profiles and the per-client latency model (port of
``repro.fl.systime.profiles``: the same float arithmetic, over the
port's ``ModelMemory`` / ``Decomposition``, so a client-round prices to
the same seconds, image and LM contexts alike).

FeDepth prices what a client *can hold*; this module prices how long the
client *takes*: a :class:`DeviceProfile` carries sustained compute /
memory-bandwidth / link peaks (same shape as a roofline's chip constants,
scaled down to client hardware), and :class:`SystemModel`
combines them with the analytic memory model's per-unit FLOP counts
(``core.memory_model.UnitCost.flops``) to yield download + compute +
upload seconds for exactly the FeDepth blocks the client trains.

Compute time is a roofline max: ``max(FLOPs / flops, traffic / mem_bw)``
— tiny devices are usually FLOP-bound, wide ones bandwidth-bound.  Link
time is priced from the ENCODED wire sizes the comm channel reports
(``repro_torch.fl.comm``): compressed uplinks and sliced/delta downlinks
shorten exactly the seconds their byte savings imply.  The
depth-wise schedule is priced like ``core.blockwise`` executes it
(``ctx.prefix_cache`` selects the contract): with the prefix cache on —
the default — ONE buffered incremental prefix forward per distinct
batch for the whole schedule plus forward+backward (3x forward FLOPs)
on each block and the head for every (step, batch); with it off, the
prefix replays inside every step (see ``docs/prefix_cache.md``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.decomposition import Decomposition
from repro_torch.core.memory_model import ModelMemory


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Sustained (not peak-datasheet) rates for one device tier."""
    name: str
    flops: float        # FLOP/s the training loop actually sustains
    mem_bw: float       # bytes/s main-memory bandwidth
    link_up: float      # bytes/s uplink (client -> server)
    link_down: float    # bytes/s downlink (server -> client)
    mem_bytes: float    # device RAM (ties the tier to a memory scenario)

    def seconds_for(self, flops: float, traffic_bytes: float) -> float:
        """Roofline compute time; infinite rates price as zero time."""
        t_flops = flops / self.flops if math.isfinite(self.flops) else 0.0
        t_mem = traffic_bytes / self.mem_bw \
            if math.isfinite(self.mem_bw) else 0.0
        return max(t_flops, t_mem)

    def upload_seconds(self, nbytes: float) -> float:
        return nbytes / self.link_up if math.isfinite(self.link_up) else 0.0

    def download_seconds(self, nbytes: float) -> float:
        return nbytes / self.link_down \
            if math.isfinite(self.link_down) else 0.0


_INF = float("inf")

#: The catalog, slowest to fastest.  Numbers are order-of-magnitude
#: sustained rates for fp32 training on commodity hardware (an MCU-class
#: IoT node, a mid-range phone SoC, an edge box with a small GPU, and a
#: desktop workstation GPU); links are typical last-mile rates in bytes/s.
DEVICE_TIERS: Dict[str, DeviceProfile] = {
    "iot": DeviceProfile("iot", flops=2e9, mem_bw=1.6e9,
                         link_up=0.125e6, link_down=0.5e6,
                         mem_bytes=0.5 * 2**30),
    "phone": DeviceProfile("phone", flops=50e9, mem_bw=12e9,
                           link_up=1.25e6, link_down=5e6,
                           mem_bytes=4 * 2**30),
    "edge": DeviceProfile("edge", flops=0.5e12, mem_bw=60e9,
                          link_up=12.5e6, link_down=25e6,
                          mem_bytes=8 * 2**30),
    "workstation": DeviceProfile("workstation", flops=10e12, mem_bw=400e9,
                                 link_up=125e6, link_down=125e6,
                                 mem_bytes=32 * 2**30),
}

#: Degenerate profile: every phase takes zero simulated time.  A
#: ``SystemModel`` built from it makes the async engine's sync mode
#: reproduce ``RoundEngine`` exactly (asserted in
#: tests/test_torch_async_engine.py).
ZERO_LATENCY = DeviceProfile("zero-latency", _INF, _INF, _INF, _INF, _INF)

TIER_ORDER = ("iot", "phone", "edge", "workstation")


@dataclasses.dataclass(frozen=True)
class Latency:
    """One client-round's phase timings (seconds of simulated time)."""
    download: float
    compute: float
    upload: float

    @property
    def total(self) -> float:
        return self.download + self.compute + self.upload


def profiles_for_ratios(ratios: Sequence[float]) -> List[DeviceProfile]:
    """Map the budget protocol's width ratios onto device tiers: the
    scenario's distinct ratios, sorted ascending, take tiers slowest to
    fastest — the memory-poorest clients are also the slowest, the
    paper-consistent default."""
    uniq = sorted(set(float(r) for r in ratios))
    tiers = [DEVICE_TIERS[t] for t in TIER_ORDER]
    # fewer distinct ratios than tiers: spread over the range ends
    picks = np.linspace(0, len(tiers) - 1, num=len(uniq)).round().astype(int)
    lookup = {r: tiers[p] for r, p in zip(uniq, picks)}
    return [lookup[float(r)] for r in ratios]


def mixed_profiles(n: int, mix: Dict[str, float],
                   seed: int = 0) -> List[DeviceProfile]:
    """``mix`` maps tier name -> fraction; counts are rounded to sum to
    ``n`` and the assignment is a seeded shuffle (deterministic)."""
    names = sorted(mix)
    counts = [int(round(mix[t] * n)) for t in names]
    while sum(counts) > n:
        counts[int(np.argmax(counts))] -= 1
    while sum(counts) < n:
        counts[int(np.argmax(counts))] += 1
    out: List[DeviceProfile] = []
    for t, c in zip(names, counts):
        out.extend([DEVICE_TIERS[t]] * c)
    order = np.random.default_rng(seed).permutation(n)
    return [out[i] for i in order]


def uniform_profiles(n: int, profile: DeviceProfile) -> List[DeviceProfile]:
    return [profile] * n


class SystemModel:
    """Per-client latency pricing over an assigned profile list.

    ``overhead_s`` is a fixed per-dispatch cost (session setup, crypto,
    scheduling) added to every client-round.
    """

    def __init__(self, profiles: Sequence[DeviceProfile], *,
                 overhead_s: float = 0.0):
        self.profiles = list(profiles)
        self.overhead_s = float(overhead_s)

    def profile(self, client_id: int) -> DeviceProfile:
        return self.profiles[client_id]

    # ------------------------------------------------------------- pricing
    @staticmethod
    def _fedepth_work(mem: ModelMemory, dec: Decomposition, *,
                      batch_size: int, n_batches: int, local_steps: int,
                      prefix_cache: bool = True,
                      prefix_stable: bool = True):
        """(FLOPs, traffic bytes) of one depth-wise local update.

        Pricing mirrors the ``core.blockwise`` execution contracts:

        * ``prefix_cache=True, prefix_stable=True`` (the runtime default
          for ResNet/ViT/untied LMs) — the buffered incremental
          schedule: the frozen prefix runs forward once per distinct
          batch up to the FIRST block's lo, and between subproblems the
          buffer advances through the just-trained units, so the TOTAL
          prefix bill is one forward through units[0, lo_last) per
          distinct batch, independent of step count and block count.
        * ``prefix_cache=True, prefix_stable=False`` (tied embeddings /
          whisper / hybrid, ``BlockRunner.prefix_stable``) — the cache
          re-buffers from scratch at each subproblem: one prefix forward
          per block per distinct batch, still step-count-independent.
        * ``prefix_cache=False`` — the recompute contract: the prefix
          (embed + units[:lo]) replays inside EVERY SGD step of every
          block, the O(depth^2 * steps) bill the cache removes.

        In all three, the block + head run forward+backward (3x forward)
        for every (step, batch).
        """
        # activation bytes in `mem` are priced at mem.batch samples;
        # rescale them to the batch the client actually trains with
        # (params/optimizer bytes are batch-independent)
        act_scale = batch_size / max(1, mem.batch)
        fwd = [u.flops for u in mem.units]
        prefix = np.cumsum([mem.embed.flops] + fwd)   # prefix[i] = embed+units[:i]
        flops = 0.0
        traffic = 0.0
        for lo, hi in dec.blocks:
            block_fwd = sum(fwd[lo:hi]) + mem.head.flops
            flops += 3 * block_fwd * n_batches * local_steps
            if not prefix_cache:
                flops += prefix[lo] * n_batches * local_steps
            elif not prefix_stable:
                flops += prefix[lo] * n_batches   # re-buffer per block
            # per optimizer step the device streams the block's params,
            # grads + momentum (2 more param-sized passes) and its live
            # activations once forward + once backward
            units = list(mem.units[lo:hi]) + [mem.head] \
                + ([mem.embed] if lo == 0 else [])
            par = sum(u.params for u in units) * 4       # p, g, m, update
            act = sum(u.activations for u in units) * 3 * act_scale
            traffic += (par + act) * n_batches * local_steps
        if prefix_cache and prefix_stable and dec.blocks:
            # buffered incremental prefix: initial buffer to lo_0 plus
            # per-subproblem advances — telescopes to ONE forward
            # through units[0, lo_last) per distinct batch
            flops += prefix[dec.blocks[-1][0]] * n_batches
        return flops * batch_size, traffic

    @staticmethod
    def _full_model_work(mem: ModelMemory, width_ratio: float, *,
                         batch_size: int, n_batches: int, local_steps: int):
        """First-order pricing for width-sliced strategies: matmul/conv
        FLOPs and parameter traffic scale ~ r^2 (both operands slimmed),
        activation traffic ~ r."""
        r = min(max(width_ratio, 0.0), 1.0)
        act_scale = batch_size / max(1, mem.batch)
        units = list(mem.units) + [mem.embed, mem.head]
        fwd = sum(u.flops for u in units)
        flops = 3 * fwd * r * r * batch_size * n_batches * local_steps
        par = sum(u.params for u in units) * 4 * r * r
        act = sum(u.activations for u in units) * 3 * act_scale * r
        traffic = (par + act) * n_batches * local_steps
        return flops, traffic

    def latency(self, ctx, client_id: int, *, upload_bytes: int,
                download_bytes: int, n_batches: int,
                work=None, prefix_stable: Optional[bool] = None) -> Latency:
        """Price one client-round for ``client_id``.

        ``upload_bytes`` / ``download_bytes`` are the TRUE wire sizes in
        each direction: the engines pass the encoded
        ``WirePayload.nbytes`` of the client's (codec + error-feedback)
        upload and the channel's downlink accounting (full broadcast,
        depth/width slice, or changed-coordinate delta — see
        ``docs/comm.md``), so link seconds track exactly the bytes the
        history reports.

        ``work`` selects the compute workload: a ``Decomposition`` prices
        the depth-wise schedule, a float width ratio prices a sliced
        full-model pass, ``None`` falls back to the context (the
        client's decomposition if present, else its ratio).  Strategies
        can steer this via the optional ``client_work(ctx, client_id)``
        hook (see ``AsyncEngine._latency``) — e.g. fedavg trains the
        x min r subnet regardless of the client's own budget.

        ``prefix_stable`` describes the active runner's buffered-prefix
        schedule (``BlockRunner.prefix_stable``: incremental advance vs
        re-buffer per subproblem); ``AsyncEngine`` passes the strategy's
        runner flag, direct callers fall back to ``ctx.prefix_stable``.
        """
        prof = self.profiles[client_id]
        sim = ctx.sim
        if work is None:
            if ctx.decomps is not None:
                work = ctx.decomps[client_id]
            elif ctx.ratios is not None:
                work = float(min(ctx.ratios[client_id], 1.0))
        if ctx.mem is None or work is None:
            flops, traffic = 0.0, 0.0
        elif isinstance(work, Decomposition):
            if prefix_stable is None:
                prefix_stable = ctx.prefix_stable
            flops, traffic = self._fedepth_work(
                ctx.mem, work, batch_size=sim.batch_size,
                n_batches=n_batches, local_steps=sim.local_steps,
                prefix_cache=ctx.prefix_cache,
                prefix_stable=prefix_stable)
        else:
            flops, traffic = self._full_model_work(
                ctx.mem, float(work), batch_size=sim.batch_size,
                n_batches=n_batches, local_steps=sim.local_steps)
        return Latency(float(prof.download_seconds(download_bytes)),
                       float(prof.seconds_for(flops, traffic)
                             + self.overhead_s),
                       float(prof.upload_seconds(upload_bytes)))


def zero_latency_system(num_clients: int) -> SystemModel:
    """The sync-equivalence system: every phase takes zero time."""
    return SystemModel(uniform_profiles(num_clients, ZERO_LATENCY))
