"""Trace-driven population specs: millions of clients, O(1) per-client
state (port of ``repro.fl.scale.population``: its hashing, draws and
sampler copied with numpy, its context and batches on the port's device;
docs/scale.md §Population).

``build_context`` materializes per-client arrays (ratios, budgets,
decompositions, sizes) and ``build_federated`` per-client index lists —
O(population) host memory before the first round runs.  A
:class:`Population` replaces both with a seeded COUNTER-BASED generator:
every per-client attribute is a pure function ``splitmix64(seed, stream,
client_id)``, so any client's ratio / size / label set / device profile
/ availability phase is drawn lazily, in any order, without enumerating
the population.  Determinism is positional, not sequential: two runs
with the same seed agree on client k's trace even if they visit
different cohorts.  The draws equal the reference's bit for bit
(tests/test_torch_scale.py).

``population_context`` wires a Population into the standard
:class:`~repro_torch.fl.strategy.Context` through lazy views —
``ctx.sizes[k]`` etc. keep working, but indexing computes instead of
loading.  Decompositions are memoized per distinct BUDGET (a scenario
has <= 4), so ``ctx.decomps[k]`` is O(1) after warmup.  Nothing of size
``num_clients`` is built, on the host or on the device: the data is the
class templates and the test split, the batches are synthesized per
client on demand and then moved to the context's device.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.decomposition import decompose
from repro_torch.device import DeviceLike, resolve_device

# --------------------------------------------------------------------------
# counter-based hashing (splitmix64): per-(seed, stream, id) uniforms
# --------------------------------------------------------------------------
_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)
_U = np.uint64


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over uint64 words (wrapping arithmetic)."""
    z = x.astype(np.uint64) + _C1
    z = (z ^ (z >> _U(30))) * _C2
    z = (z ^ (z >> _U(27))) * _C3
    return z ^ (z >> _U(31))


_STREAM_KEYS: Dict[str, np.uint64] = {}


def _stream_key(stream: str) -> np.uint64:
    """Stable (process-independent) 64-bit key for a named stream —
    python's ``hash`` is salted per process and must not leak into the
    trace."""
    key = _STREAM_KEYS.get(stream)
    if key is None:
        digest = hashlib.blake2b(stream.encode(), digest_size=8).digest()
        key = _STREAM_KEYS[stream] = _U(int.from_bytes(digest, "little"))
    return key


def hash_u64(seed: int, stream: str, ids) -> np.ndarray:
    """Vectorized counter hash: uint64 words for ``ids`` under
    ``(seed, stream)``.  Pure and order-free — THE population trace."""
    ids = np.atleast_1d(np.asarray(ids)).astype(np.uint64)
    # 1-element array ops: uint64 wraparound is the point, and numpy
    # only warns about overflow on SCALAR integer ops
    base = splitmix64((np.array([seed], np.uint64) * _C3)
                      ^ _stream_key(stream))[0]
    return splitmix64(ids * _C1 ^ base)


def uniform01(seed: int, stream: str, ids) -> np.ndarray:
    """Uniforms in [0, 1) from the top 53 bits of the counter hash."""
    return (hash_u64(seed, stream, ids) >> _U(11)).astype(np.float64) \
        * (1.0 / (1 << 53))


# --------------------------------------------------------------------------
# the population spec
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Population:
    """A lazily-drawn client fleet.  All per-client attributes are pure
    functions of ``(seed, client_id)``; nothing here is O(num_clients).

    ``scenario`` picks the paper's width-ratio tuple (iid per client);
    ``size_range`` bounds per-client |D_k|; ``labels_per_client`` gives
    each client a pathological-style label subset (non-IID signal
    without a materialized partition)."""
    num_clients: int
    scenario: str = "fair"
    seed: int = 0
    size_range: Tuple[int, int] = (64, 256)
    num_classes: int = 10
    image_size: int = 16
    channels: int = 3
    labels_per_client: int = 3
    avail_period_s: float = 3600.0
    avail_duty: float = 0.75

    def __post_init__(self):
        from repro_torch.fl.engine import SCENARIOS
        from repro_torch.fl.systime.profiles import profiles_for_ratios
        self._ratio_set = np.asarray(SCENARIOS[self.scenario])
        # paper-consistent tiering: memory-poorest ratio -> slowest tier,
        # computed once for the scenario's <= 4 distinct ratios
        tiers = profiles_for_ratios(sorted(set(self._ratio_set.tolist())))
        self._tier_of = dict(zip(sorted(set(self._ratio_set.tolist())),
                                 tiers))

    # -------------------------------------------------- per-client draws
    def ratio(self, ids) -> np.ndarray:
        idx = hash_u64(self.seed, "ratio", ids) % _U(len(self._ratio_set))
        return self._ratio_set[idx.astype(np.int64)]

    def size(self, ids) -> np.ndarray:
        lo, hi = self.size_range
        u = uniform01(self.seed, "size", ids)
        return (lo + (u * (hi - lo + 1)).astype(np.int64)).clip(lo, hi)

    def labels(self, client_id: int) -> np.ndarray:
        """The client's label subset (distinct, pathological-style)."""
        L = min(self.labels_per_client, self.num_classes)
        offsets = hash_u64(self.seed, "labels",
                           np.int64(client_id) * _U(64)
                           + np.arange(64, dtype=np.uint64))
        order = np.argsort(offsets[:self.num_classes], kind="stable")
        return order[:L].astype(np.int64)

    def profile(self, client_id: int):
        return self._tier_of[float(self.ratio(client_id)[0])]

    def phase(self, ids) -> np.ndarray:
        """Duty-cycle phase in [0, avail_period_s)."""
        return uniform01(self.seed, "phase", ids) * self.avail_period_s

    def up(self, ids, t: float) -> np.ndarray:
        """Availability mask for candidate ``ids`` at simulated ``t`` —
        O(len(ids)) memory, never O(population)."""
        ph = self.phase(ids)
        return ((t + ph) % self.avail_period_s) \
            < self.avail_duty * self.avail_period_s


# --------------------------------------------------------------------------
# lazy Context views
# --------------------------------------------------------------------------
class LazyClientArray:
    """Array-shaped view computing entries on demand from a vectorized
    ``fn(ids) -> values``: ``arr[int]``, ``arr[id_array]``, ``len(arr)``."""

    def __init__(self, fn, n: int):
        self._fn = fn
        self._n = int(n)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if np.isscalar(i) or isinstance(i, (int, np.integer)):
            return self._fn(np.asarray([int(i)]))[0]
        return self._fn(np.asarray(i))


class LazyDecomps:
    """``ctx.decomps`` view: decomposition per client, memoized per
    distinct BUDGET, so the memo is O(1) regardless of population size."""

    def __init__(self, pop: Population, mem, budget_of):
        self._pop = pop
        self._mem = mem
        self._budget_of = budget_of
        self._memo: dict = {}

    def __len__(self) -> int:
        return self._pop.num_clients

    def __getitem__(self, client_id: int):
        budget = self._budget_of(float(self._pop.ratio(int(client_id))[0]))
        dec = self._memo.get(budget)
        if dec is None:
            dec = self._memo[budget] = decompose(self._mem, int(budget))
        return dec


class _LazyIndices:
    """``data.client_indices`` stand-in: ``len()`` is the population,
    ``[k]`` a ``range`` of the client's size (the engines only take
    ``len`` of both)."""

    def __init__(self, pop: Population):
        self._pop = pop

    def __len__(self) -> int:
        return self._pop.num_clients

    def __getitem__(self, k: int):
        return range(int(self._pop.size(int(k))[0]))


class PopulationData:
    """Duck-typed :class:`~repro_torch.fl.data.FederatedData` over a
    Population: batches are SYNTHESIZED on demand (the class-template +
    noise construction of ``data.synth_images``), labels drawn from the
    client's lazy label subset, sample noise from the engine's shared
    simulation stream — so batches are drawn in cohort order and match
    the reference's draws.  The numpy arrays are the reference's; each
    batch and the test split then live on ``device`` (NHWC fp32 images,
    int64 labels, as ``FederatedData``).  Memory: the class templates and
    the test split, independent of ``num_clients``."""

    def __init__(self, pop: Population, *, n_test: int = 512,
                 noise: float = 0.5, device: DeviceLike = None):
        self.pop = pop
        self.noise = float(noise)
        self.num_classes = pop.num_classes
        self.client_indices = _LazyIndices(pop)
        self._device = resolve_device(device)
        rng = np.random.default_rng(pop.seed)
        H = W = pop.image_size
        C = pop.channels
        fx = rng.normal(size=(pop.num_classes, 4, 4, C))
        self._templates = np.zeros((pop.num_classes, H, W, C), np.float32)
        for c in range(pop.num_classes):
            self._templates[c] = np.kron(fx[c], np.ones((H // 4, W // 4, 1)))
        self._mixers = rng.normal(
            size=(pop.num_classes, C, C)).astype(np.float64) * 0.5
        x, y = self._make(n_test, np.random.default_rng(pop.seed + 2))
        self.x_test, self.y_test = self._put(x, y)

    @property
    def device(self) -> torch.device:
        return self._device

    def _put(self, x: np.ndarray, y: np.ndarray):
        return (torch.as_tensor(x, dtype=torch.float32, device=self._device),
                torch.as_tensor(y, dtype=torch.int64, device=self._device))

    def _make(self, n: int, rng: np.random.Generator,
              labels: Optional[np.ndarray] = None):
        y = rng.integers(0, self.num_classes, size=n) if labels is None \
            else labels
        eps = rng.normal(size=(n,) + self._templates.shape[1:]).astype(
            np.float32)
        x = self._templates[y] \
            + self.noise * np.einsum("nhwc,ncd->nhwd", eps,
                                     self._mixers[y]).astype(np.float32) \
            + self.noise * eps
        return x.astype(np.float32), y.astype(np.int32)

    def client_batch(self, k: int, batch_size: int,
                     rng: np.random.Generator):
        n = min(batch_size, int(self.pop.size(int(k))[0]))
        pool = self.pop.labels(int(k))
        y = pool[rng.integers(0, len(pool), size=n)]
        x, y = self._make(n, rng, labels=y)
        images, labels = self._put(x, y)
        return {"images": images, "labels": labels}

    def client_sizes(self):
        return LazyClientArray(self.pop.size, self.pop.num_clients)


def population_context(pop: Population, sim, *, model_cfg=None, data=None,
                       device: DeviceLike = None):
    """The standard engine :class:`~repro_torch.fl.strategy.Context` from
    a Population — the same fields, lazy views, on ``device`` (the GPU
    unless ``"cpu"``); reached through ``build_context(data, sim,
    population=pop)``."""
    from repro_torch.configs.preresnet20 import ResNetConfig
    from repro_torch.core.memory_model import resnet_memory
    from repro_torch.fl.engine import scenario_budgets
    from repro_torch.fl.strategy import Context

    dev = resolve_device(device)
    if data is not None and data.device.type != dev.type:
        raise ValueError(f"data lives on {data.device}, context on {dev}")
    cfg = model_cfg or ResNetConfig(num_classes=pop.num_classes,
                                    image_size=pop.image_size)
    mem = resnet_memory(cfg, sim.mem_batch)
    budget_memo: dict = {}

    def budget_of(ratio: float) -> float:
        if ratio not in budget_memo:
            budget_memo[ratio] = float(scenario_budgets(mem, [ratio])[0])
        return budget_memo[ratio]

    N = pop.num_clients
    return Context(
        sim=sim, num_clients=N,
        sizes=LazyClientArray(pop.size, N),
        rng=np.random.default_rng(sim.seed), seed=sim.seed, device=dev,
        model_cfg=cfg, mem=mem,
        ratios=LazyClientArray(pop.ratio, N),
        budgets=LazyClientArray(
            lambda ids: np.asarray([budget_of(float(r))
                                    for r in pop.ratio(ids)]), N),
        decomps=LazyDecomps(pop, mem, budget_of),
        surplus=LazyClientArray(
            lambda ids: np.where(pop.ratio(ids) >= 2.0, 2, 1), N),
        data=data if data is not None else PopulationData(pop, device=dev))


# --------------------------------------------------------------------------
# population-scale sampling / availability / system model
# --------------------------------------------------------------------------
class PopulationSampler:
    """O(cohort) cohort sampling: rejection-sample distinct ids from the
    shared stream instead of permuting [0, N).  With an ``availability``
    spec (a :class:`Population` or anything exposing ``up(ids, t)``),
    unavailable candidates are rejected too; ``t`` is ``round_idx *
    round_period_s`` for the wall-clock ``RoundEngine``."""

    def __init__(self, availability=None, *, round_period_s: float = 60.0,
                 max_draws: int = 64):
        self.availability = availability
        self.round_period_s = float(round_period_s)
        self.max_draws = int(max_draws)

    def sample(self, ctx, round_idx: int) -> np.ndarray:
        n = ctx.num_clients
        k = max(1, int(np.ceil(ctx.sim.participation * n)))
        k = min(k, n)
        t = round_idx * self.round_period_s
        chosen: list = []
        seen: set = set()
        for _ in range(self.max_draws):
            want = k - len(chosen)
            if want <= 0:
                break
            cand = ctx.rng.integers(0, n, size=max(2 * want, 16))
            if self.availability is not None:
                cand = cand[np.asarray(self.availability.up(cand, t))]
            for c in cand:
                c = int(c)
                if c not in seen:
                    seen.add(c)
                    chosen.append(c)
                    if len(chosen) == k:
                        break
        return np.asarray(chosen[:k], dtype=np.int64)


class HashedDutyCycle:
    """Duty-cycle availability with HASHED phases — the population-scale
    counterpart of ``systime.availability.DutyCycleAvailability``: no
    per-client phase array, O(candidates) work per query via :meth:`up`.
    ``available`` keeps the full-population protocol for the existing
    engines (O(N) by that protocol's nature)."""

    def __init__(self, period_s: float, duty: float, *, seed: int = 0):
        if not 0.0 < duty <= 1.0:
            raise ValueError(f"duty must be in (0, 1], got {duty}")
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        self.period_s = float(period_s)
        self.duty = float(duty)
        self.seed = seed

    def up(self, ids, t: float) -> np.ndarray:
        ph = uniform01(self.seed, "phase", ids) * self.period_s
        return ((t + ph) % self.period_s) < self.duty * self.period_s

    def available(self, ctx, t: float) -> np.ndarray:
        ids = np.arange(ctx.num_clients)
        up = self.up(ids, t)
        hit = np.flatnonzero(up)
        return hit if hit.size else ids


class _LazyProfiles:
    def __init__(self, pop: Population):
        self._pop = pop

    def __len__(self) -> int:
        return self._pop.num_clients

    def __getitem__(self, client_id: int):
        return self._pop.profile(int(client_id))


def population_system(pop: Population, *, overhead_s: float = 0.0):
    """A :class:`~repro_torch.fl.systime.profiles.SystemModel` whose
    profile list is a lazy view over the population's hashed tier draws
    (``len(profiles) == num_clients`` without N profile references)."""
    from repro_torch.fl.systime.profiles import SystemModel

    system = SystemModel.__new__(SystemModel)
    system.profiles = _LazyProfiles(pop)
    system.overhead_s = float(overhead_s)
    return system
