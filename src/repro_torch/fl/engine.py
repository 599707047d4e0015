"""The FL round engine (port of ``repro.fl.engine``).

One loop owns cohort sampling, the paper's budget / decomposition
assignment, eval cadence and a structured history of
``RoundRecord(round, accuracy, seconds, comm_bytes)``.

Budget protocol (paper §Memory budgets): client memory budgets are the
width-ratio-equivalent training footprints of PreResNet at batch 128,
r uniformly distributed over the scenario's tuple (``SCENARIOS``; the
full protocol is ``docs/budget_protocol.md``).  :func:`build_context`
prepares the paper's image protocol; ``fl/seq.py`` the LM one.

The engine runs the sequential (default) or the vectorized scheduler,
and routes every uplink and downlink byte through a
:class:`~repro_torch.fl.comm.CommChannel` (``codec`` / ``downlink``);
no faults, no checkpoints and no telemetry.  The reference's other knobs
are accepted by name and raise ``NotImplementedError`` when set — never
silently ignored.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.preresnet20 import ResNetConfig
from repro_torch.core.decomposition import decompose, width_equivalent_budget
from repro_torch.core.memory_model import resnet_memory
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.comm import CommChannel
from repro_torch.fl.sampling import (CohortSampler, UniformSampler,
                                     make_scheduler)
from repro_torch.fl.strategy import Context, FLStrategy, wire_bytes

SCENARIOS: Dict[str, Tuple[float, ...]] = {
    "fair": (1 / 6, 1 / 3, 1 / 2, 1.0),
    "lack": (1 / 8, 1 / 6, 1 / 2, 1.0),
    "surplus": (1 / 6, 1 / 3, 1 / 2, 2.0),
}

# decomposition slack: the paper's Table 1 protocol carries implicit
# headroom (docs/budget_protocol.md)
BUDGET_SLACK = 1.20


@dataclasses.dataclass
class SimConfig:
    rounds: int = 20
    participation: float = 0.1
    lr: float = 0.05
    momentum: float = 0.9
    local_steps: int = 2
    batch_size: int = 64
    mem_batch: int = 128          # batch used to price memory (paper: 128)
    scenario: str = "fair"
    seed: int = 0


class RoundRecord(NamedTuple):
    """One history entry; ``seconds`` and ``comm_bytes`` / ``down_bytes``
    accumulate since the previous record (see the reference)."""
    round: int
    accuracy: Optional[float]
    seconds: float
    comm_bytes: int
    sim_seconds: float = 0.0
    down_bytes: int = 0


def client_ratios(num_clients: int, scenario: str,
                  seed: int = 0) -> np.ndarray:
    """The scenario's ratios over clients: uniform multiset, assignment
    seeded-shuffled."""
    rs = SCENARIOS[scenario]
    reps = int(np.ceil(num_clients / len(rs)))
    arr = np.tile(np.asarray(rs), reps)[:num_clients]
    np.random.default_rng(seed).shuffle(arr)
    return arr


def scenario_budgets(mem, ratios) -> np.ndarray:
    """Width-equivalent byte budgets for the scenario's ratio vector,
    floored at the finest unit + head."""
    floor = min(mem.block_train_bytes(i, i + 1)
                for i in range(len(mem.units)))
    return np.array([max(width_equivalent_budget(mem, min(r, 1.0))
                         * BUDGET_SLACK, floor) for r in ratios])


def build_context(data, sim: SimConfig, *,
                  model_cfg: Optional[ResNetConfig] = None,
                  device: DeviceLike = None, population=None) -> Context:
    """The per-experiment context of the paper's image protocol: ratios,
    byte budgets, FeDepth decompositions and MKD flags (M = 2 for r >= 2),
    on ``device`` (the GPU unless ``"cpu"``; the data must already live
    there).  ``population=`` (lazy client populations) is not ported
    yet."""
    if population is not None:
        raise NotImplementedError("population= is not ported yet")
    dev = resolve_device(device)
    if data.device.type != dev.type:
        raise ValueError(f"data lives on {data.device}, context on {dev}")
    num_clients = len(data.client_indices)
    cfg = model_cfg or ResNetConfig(num_classes=data.num_classes,
                                    image_size=data.x.shape[1])
    ratios = client_ratios(num_clients, sim.scenario, sim.seed)
    mem = resnet_memory(cfg, sim.mem_batch)
    budgets = scenario_budgets(mem, ratios)
    return Context(
        sim=sim, num_clients=num_clients, sizes=data.client_sizes(),
        rng=np.random.default_rng(sim.seed), seed=sim.seed, device=dev,
        model_cfg=cfg, mem=mem, ratios=ratios, budgets=budgets,
        decomps=[decompose(mem, int(b)) for b in budgets],
        surplus=np.where(ratios >= 2.0, 2, 1), data=data)


def default_batch_fn(ctx: Context) -> Callable[[int], list]:
    """The paper's per-round local loader: |D_k|/B fresh batches, drawn
    from the shared simulation stream."""
    data, sim = ctx.data, ctx.sim

    def batch_fn(k: int) -> list:
        return [data.client_batch(k, sim.batch_size, ctx.rng)
                for _ in range(max(1, len(data.client_indices[k])
                                   // sim.batch_size))]
    return batch_fn


def eval_state(strategy: FLStrategy, ctx: Context, state,
               eval_fn: Optional[Callable]) -> Optional[float]:
    """Explicit ``eval_fn`` > the strategy's eval on the test split >
    ``None``."""
    if eval_fn is not None:
        return eval_fn(state)
    if ctx.data is not None:
        return strategy.eval_model(ctx, state, ctx.data.x_test,
                                   ctx.data.y_test)
    return None


def _resolve_prefix_cache(spec) -> bool:
    if isinstance(spec, bool):
        return spec
    if spec not in ("on", "off"):
        raise ValueError(f"prefix_cache must be 'on' or 'off', got {spec!r}")
    return spec == "on"


# the reference engine's other knobs; each is off at None (obs also at
# "off" / False), and only checkpoint_keep is harmless on its own
_UNPORTED = ("history_sink", "obs", "faults", "resilience",
             "checkpoint_every", "checkpoint_dir", "resume")


class RoundEngine:
    """Runs communication rounds of ONE strategy over a client
    population."""

    def __init__(self, strategy: FLStrategy, ctx: Context, *,
                 sampler: Optional[CohortSampler] = None,
                 scheduler=None, prefix_cache="on", codec="none",
                 downlink: str = "full",
                 channel: Optional[CommChannel] = None, **unported):
        """``prefix_cache`` ("on" / "off") and ``scheduler`` (a name of
        ``fl.sampling.SCHEDULERS`` or an instance; sequential by default)
        as in the reference.  ``codec`` (a name of ``fl.comm.CODECS`` or
        a configured codec) and ``downlink`` ("full", "sliced" or
        "delta") configure the wire: lossy codecs run behind per-client
        error feedback and the history counts the exact encoded bytes;
        ``codec="none"`` with ``downlink="full"`` is the channel-free
        engine exactly.  A prebuilt ``channel`` wins over the two knobs.
        The reference's other knobs (``history_sink``, ``obs``,
        ``faults``, ``resilience``, ``checkpoint_*``, ``resume``) raise
        ``NotImplementedError`` when set."""
        for name, value in unported.items():
            if name not in _UNPORTED + ("checkpoint_keep",):
                raise TypeError(f"unexpected keyword argument {name!r}")
            if name in _UNPORTED and value not in (None, False, "off"):
                raise NotImplementedError(f"{name}= is not ported yet")
        self.strategy = strategy
        resolved = _resolve_prefix_cache(prefix_cache)
        self.ctx = ctx if resolved == ctx.prefix_cache \
            else dataclasses.replace(ctx, prefix_cache=resolved)
        self.sampler = sampler or UniformSampler()
        self.scheduler = make_scheduler(scheduler)
        self.channel = channel or CommChannel(codec, downlink)

    def default_batch_fn(self) -> Callable[[int], list]:
        return default_batch_fn(self.ctx)

    def run_round(self, state, round_idx: int,
                  batch_fn: Callable[[int], list]):
        """One round: broadcast (downlink accounting) -> sample -> local
        updates -> uplink encode -> decode -> aggregate.  Returns
        (new_state, up_bytes, down_bytes)."""
        ctx, chan = self.ctx, self.channel
        cohort = self.sampler.sample(ctx, round_idx)
        down = sum(chan.downlink_bytes(self.strategy, ctx, state, int(k))
                   for k in cohort)
        results = self.scheduler.run(ctx, self.strategy, state, cohort,
                                     batch_fn)
        results = [chan.encode_result(self.strategy, ctx, state, int(k), r)
                   for k, r in zip(cohort, results)]
        comm = sum(r.comm_bytes if r.comm_bytes is not None
                   else wire_bytes(r.payload) for r in results)
        results = [chan.decode_result(r) for r in results]
        return self.strategy.aggregate(ctx, state, results), comm, down

    def run(self, *, initial_state=None,
            batch_fn: Optional[Callable[[int], list]] = None,
            eval_fn: Optional[Callable] = None,
            eval_every: int = 5) -> Tuple[object, List[RoundRecord]]:
        """Run ``sim.rounds`` rounds, evaluating every ``eval_every``
        rounds and on the last.  ``initial_state`` skips ``init_state``
        but not the strategy's ``setup``.  Returns (final_state, history)
        with one record per eval checkpoint."""
        ctx = self.ctx
        setup = getattr(self.strategy, "setup", None)
        if setup is not None:
            setup(ctx)
        state = initial_state if initial_state is not None \
            else self.strategy.init_state(ctx)
        batch_fn = batch_fn or self.default_batch_fn()
        history: List[RoundRecord] = []
        bytes_acc, down_acc = 0, 0
        t_last = time.perf_counter()
        for rd in range(ctx.sim.rounds):
            state, comm, down = self.run_round(state, rd, batch_fn)
            bytes_acc += comm
            down_acc += down
            if (rd + 1) % eval_every == 0 or rd == ctx.sim.rounds - 1:
                acc = eval_state(self.strategy, ctx, state, eval_fn)
                if ctx.device.type == "cuda":
                    torch.cuda.synchronize(ctx.device)
                now = time.perf_counter()
                history.append(RoundRecord(rd + 1, acc, now - t_last,
                                           bytes_acc, 0.0, down_acc))
                t_last, bytes_acc, down_acc = now, 0, 0
        return state, history
