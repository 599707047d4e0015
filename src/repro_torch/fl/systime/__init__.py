"""System-time simulation (port of ``repro.fl.systime``): device
profiles, an event-driven virtual clock, and asynchronous /
staleness-aware FL over the port's strategies."""
from repro_torch.fl.systime.availability import (  # noqa: F401
    AlwaysAvailable, AvailabilityModel, DutyCycleAvailability,
    WindowedAvailability)
from repro_torch.fl.systime.clock import Event, EventLoop  # noqa: F401
from repro_torch.fl.systime.engine import AsyncEngine  # noqa: F401
from repro_torch.fl.systime.profiles import (  # noqa: F401
    DEVICE_TIERS, ZERO_LATENCY, DeviceProfile, Latency, SystemModel,
    mixed_profiles, profiles_for_ratios, uniform_profiles,
    zero_latency_system)
from repro_torch.fl.systime.staleness import (  # noqa: F401
    default_aggregate_async, discount_results, polynomial_discount)
