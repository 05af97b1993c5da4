"""Typed configuration for the plan/compile/execute API.

The port's copy of the reference package's ``api/config.py``: the same five
sections, fields, defaults, presets and dotted overrides, so a config
round-trips through JSON between the two packages.

A :class:`DecomposeConfig` is a frozen composition of five orthogonal
sub-configs, mirroring the stages of the AMPED pipeline:

  * :class:`PartitionConfig` — what the preprocessing (``api.plan``) does:
    sharding strategy, intra-group replication, kernel blocking geometry.
  * :class:`ScheduleConfig`  — the static group-assignment policy and the
    dynamic rebalancer's settings.
  * :class:`KernelConfig`    — which EC implementation executes the MTTKRP
    hot loop and its launch parameters.
  * :class:`ExchangeConfig`  — how partial factors move between devices
    (see :mod:`repro_torch.comm`; the identity on one device).
  * :class:`RuntimeConfig`   — device count, checkpoint directory,
    convergence tolerance, RNG seed.

Presets :func:`paper`, :func:`optimized`, :func:`fused` and
:func:`sorted_ec` name the configurations the repo ships; ``preset(name)``
looks one up by name. Configs are plain data: hashable, JSON-round-trippable
(:meth:`DecomposeConfig.to_dict` / :meth:`DecomposeConfig.from_dict`) and
overridable with dotted paths (``apply_set_args(cfg,
["kernel.variant=fused", "runtime.tol=0"])``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence

from repro_torch.comm import collectives
from repro_torch.core.partition import Strategy

__all__ = [
    "PartitionConfig",
    "ScheduleConfig",
    "KernelConfig",
    "ExchangeConfig",
    "RuntimeConfig",
    "DecomposeConfig",
    "paper",
    "optimized",
    "fused",
    "sorted_ec",
    "preset",
    "PRESETS",
    "apply_set_args",
    "GATHER_VARIANTS",
    "MERGE_VARIANTS",
]

GATHER_VARIANTS = collectives.GATHER_VARIANTS
MERGE_VARIANTS = collectives.MERGE_VARIANTS


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """Preprocessing knobs — everything that shapes the :class:`CPPlan`."""

    strategy: Strategy = "amped_cdf"
    replication: int | None = 1     # None = auto per-mode pick (beyond-paper)
    tile: int | None = None         # None = partitioner default
    block_p: int | None = None      # None = partitioner default
    layout: str = "blocked"         # pad-row placement: "blocked" | "sorted"
                                    # ("sorted" = row-sorted hierarchical COO,
                                    # required by kernel.variant="sorted")

    def __post_init__(self):
        if self.layout not in ("blocked", "sorted"):
            raise ValueError(
                f"partition.layout must be 'blocked' or 'sorted', "
                f"got {self.layout!r}")


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Scheduling knobs. ``policy`` overrides the static group-assignment
    policy (``None`` uses ``partition.strategy``); ``rebalance`` selects the
    dynamic load balancer's mode (``"off"`` | ``"measure"`` | ``"on"``,
    see :mod:`repro_torch.schedule.rebalance`)."""

    policy: str | None = None        # None = partition.strategy
    rebalance: str = "off"           # "off" | "measure" | "on"
    cadence: int = 2                 # sweeps between rebalance points
    imbalance_threshold: float = 1.2  # EWMA max/mean ratio that triggers
    migration_budget: float = 0.25   # max fraction of a group's nnz moved
                                     # per rebalance event (0 disables)
    ewma_alpha: float = 0.5          # telemetry/cost-model smoothing
    probe_repeats: int = 1           # timed EC runs per device per probe

    def __post_init__(self):
        if self.rebalance not in ("off", "measure", "on"):
            raise ValueError(
                f"schedule.rebalance must be 'off' | 'measure' | 'on', "
                f"got {self.rebalance!r}")
        if self.cadence < 1:
            raise ValueError("schedule.cadence must be >= 1")
        if self.imbalance_threshold < 1.0:
            raise ValueError("schedule.imbalance_threshold is a max/mean "
                             "ratio; it must be >= 1.0")
        if not 0.0 <= self.migration_budget <= 1.0:
            raise ValueError("schedule.migration_budget is a fraction of a "
                             "group's nnz; it must be in [0, 1]")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("schedule.ewma_alpha must be in (0, 1]")
        if self.probe_repeats < 1:
            raise ValueError("schedule.probe_repeats must be >= 1")

    @property
    def telemetry_enabled(self) -> bool:
        return self.rebalance in ("measure", "on")

    @property
    def migrations_enabled(self) -> bool:
        return self.rebalance == "on" and self.migration_budget > 0


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """EC kernel selection and launch parameters (see
    repro_torch.kernels.ops)."""

    use_kernel: bool = False        # False + variant=None → "ref" (oracle)
    variant: str | None = None      # "ref"|"blocked"|"fused"|"sorted"|None=env
    num_buffers: int | None = None  # kernel ring depth (None = 2)
    autotune: bool = False          # sweep (tile, block_p, num_buffers)

    def resolved_variant(self) -> str:
        """Resolve to a concrete variant name (argument > env > default)."""
        from repro_torch.kernels import ops as kops
        return kops.resolve_variant(self.variant, self.use_kernel)

    def mttkrp_kwargs(self, *, nmodes: int | None = None,
                      rank: int | None = None, device=None) -> dict:
        """Kwargs for ``make_mttkrp_fn``/``mttkrp_local``, resolved once.
        Pass ``nmodes``/``rank`` so ``autotune=True`` can pick up the tuned
        ``num_buffers`` (tuned on ``device``; ``None`` is the card)."""
        from repro_torch.kernels import ops as kops
        return kops.kernel_kwargs_from_config(self, nmodes=nmodes, rank=rank,
                                              device=device)


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """Inter-device factor exchange (paper Algorithm 3; see
    :mod:`repro_torch.comm`).

    ``variant`` selects the gather schedule with the same precedence as
    kernel variants (explicit > ``AMPED_EXCHANGE_VARIANT`` env > the legacy
    ``ring`` flag > default ``ring``):

      * ``"allgather"`` — every device copies every other device's block.
      * ``"ring"``      — the paper's explicit Algorithm-3 ring.
      * ``"overlap"``   — the ring chunked by rows, chunk k+1's rounds
        enqueued before chunk k's blocks are written (``chunk_rows`` sets
        the chunk size, ``None`` a default split; ``autotune_chunk`` lets
        the chunk autotuner pick it, :mod:`repro_torch.comm.autotune`).

    ``merge`` selects the intra-group reduce for replication r>1
    (``"psum_scatter"`` — a reduce-scatter summing in member order;
    ``"ring_rs"`` — explicit ring reduce-scatter). ``wire_dtype="bfloat16"``
    halves exchange volume by casting payloads to bf16 on the wire while
    accumulating merges in fp32 (a bf16 wire always takes the ``ring_rs``
    merge). The identity on one device.
    """

    ring: bool = True               # legacy: True = ring, False = allgather
    variant: str | None = None      # "allgather"|"ring"|"overlap"|None = env
    merge: str | None = None        # "psum_scatter"|"ring_rs"|None = env
    chunk_rows: int | None = None   # overlap row-chunk size (None = auto)
    wire_dtype: str = "float32"     # "float32" | "bfloat16"
    autotune_chunk: bool = False    # sweep chunk_rows (overlap only)

    def __post_init__(self):
        if self.variant is not None and self.variant not in GATHER_VARIANTS:
            raise ValueError(
                f"exchange.variant must be one of {sorted(GATHER_VARIANTS)} "
                f"(or None), got {self.variant!r}")
        if self.merge is not None and self.merge not in MERGE_VARIANTS:
            raise ValueError(
                f"exchange.merge must be one of {sorted(MERGE_VARIANTS)} "
                f"(or None), got {self.merge!r}")
        if self.wire_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"exchange.wire_dtype must be 'float32' or 'bfloat16', "
                f"got {self.wire_dtype!r}")
        if self.chunk_rows is not None and self.chunk_rows < 1:
            raise ValueError("exchange.chunk_rows must be >= 1")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution environment: devices, fault tolerance, convergence.

    ``streaming``/``memory_budget``/``stream_*`` select epoch-streaming
    execution of a tensor-store plan; ``checkpoint_dir`` makes the solver
    checkpoint every sweep (and ``restore`` read from there); ``trace``
    turns on the process-wide span tracer (:mod:`repro_torch.obs`)."""

    num_devices: int | None = None  # None = the visible cards (CPU: 1)
    checkpoint_dir: str | None = None
    tol: float = 1e-5               # |fit_k - fit_{k-1}| < tol stops the run
    seed: int = 0
    streaming: bool = False         # epoch-streaming super-shard execution
    memory_budget: int | None = None  # per-device streamed bytes (streaming)
    stream_buffers: int = 2         # resident super-shards (2 = double buf)
    stream_spill: bool = True       # on-disk window cache across sweeps
    stream_spill_dir: str | None = None  # spill location (None = tempdir)
    trace: bool = False             # span tracer for the solver's lifetime

    def __post_init__(self):
        if self.memory_budget is not None and self.memory_budget < 1:
            raise ValueError("runtime.memory_budget must be a positive "
                             "byte count")
        if self.stream_buffers < 1:
            raise ValueError("runtime.stream_buffers must be >= 1")


@dataclasses.dataclass(frozen=True)
class DecomposeConfig:
    """One CP decomposition, fully specified (minus the tensor and iters)."""

    rank: int = 32
    partition: PartitionConfig = dataclasses.field(
        default_factory=PartitionConfig)
    schedule: ScheduleConfig = dataclasses.field(
        default_factory=ScheduleConfig)
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)
    exchange: ExchangeConfig = dataclasses.field(
        default_factory=ExchangeConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    def resolved_policy(self) -> str:
        """The static group-assignment policy ``api.plan`` will use:
        ``schedule.policy`` if set, else ``partition.strategy``."""
        return self.schedule.policy or self.partition.strategy

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DecomposeConfig":
        return cls(
            rank=int(d.get("rank", 32)),
            partition=PartitionConfig(**d.get("partition", {})),
            schedule=ScheduleConfig(**d.get("schedule", {})),
            kernel=KernelConfig(**d.get("kernel", {})),
            exchange=ExchangeConfig(**d.get("exchange", {})),
            runtime=RuntimeConfig(**d.get("runtime", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "DecomposeConfig":
        return cls.from_dict(json.loads(s))

    # -- legacy bridge -------------------------------------------------------
    @classmethod
    def from_legacy_kwargs(
        cls, *, rank: int = 32, num_devices: int | None = None,
        strategy: Strategy = "amped_cdf", replication: int | None = None,
        tol: float = 1e-5, seed: int = 0, use_kernel: bool = False,
        kernel_variant: str | None = None, num_buffers: int | None = None,
        autotune: bool = False, ring: bool = True,
        checkpoint_dir: str | None = None,
    ) -> "DecomposeConfig":
        """Build a config from the historical ``cp_decompose`` kwargs."""
        return cls(
            rank=rank,
            partition=PartitionConfig(strategy=strategy,
                                      replication=replication),
            kernel=KernelConfig(use_kernel=use_kernel, variant=kernel_variant,
                                num_buffers=num_buffers, autotune=autotune),
            exchange=ExchangeConfig(ring=ring),
            runtime=RuntimeConfig(num_devices=num_devices,
                                  checkpoint_dir=checkpoint_dir,
                                  tol=tol, seed=seed),
        )

    # -- dotted overrides -----------------------------------------------------
    def with_overrides(self, overrides: Mapping[str, Any]) -> "DecomposeConfig":
        """Replace fields by dotted path, e.g. ``{"kernel.variant": "fused",
        "runtime.tol": 0.0, "rank": 64}``. Unknown paths raise ValueError."""
        cfg = self
        for key, value in overrides.items():
            parts = key.split(".")
            if len(parts) == 1:
                if parts[0] in _SECTIONS:
                    expected = type(getattr(cfg, parts[0]))
                    if not isinstance(value, expected):
                        raise ValueError(
                            f"config section {parts[0]!r} can only be "
                            f"replaced by a {expected.__name__}; use a "
                            f"dotted path like '{parts[0]}.<field>' for "
                            f"scalar overrides")
                cfg = _replace_checked(cfg, parts[0], value)
            elif len(parts) == 2:
                section, field = parts
                if section not in _SECTIONS:
                    raise ValueError(
                        f"unknown config section {section!r}; expected one of "
                        f"{sorted(_SECTIONS)} (or top-level 'rank')")
                sub = _replace_checked(getattr(cfg, section), field, value)
                cfg = dataclasses.replace(cfg, **{section: sub})
            else:
                raise ValueError(f"override path too deep: {key!r}")
        return cfg


_SECTIONS = ("partition", "schedule", "kernel", "exchange", "runtime")


def _replace_checked(obj, field: str, value):
    names = {f.name for f in dataclasses.fields(obj)}
    if field not in names:
        raise ValueError(
            f"{type(obj).__name__} has no field {field!r}; "
            f"expected one of {sorted(names)}")
    return dataclasses.replace(obj, **{field: value})


def _parse_value(raw: str):
    """CLI value parsing: None/booleans case-insensitively ('None', 'False',
    'TRUE', ...), then JSON ('1e-4', '3', '"x"'), else the raw string."""
    low = raw.strip().lower()
    if low in ("none", "null"):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        return raw


def apply_set_args(cfg: DecomposeConfig,
                   set_args: Sequence[str]) -> DecomposeConfig:
    """Apply launcher-style ``--set key=value`` overrides (dotted keys)."""
    overrides = {}
    for item in set_args or ():
        if "=" not in item:
            raise ValueError(f"--set expects key=value, got {item!r}")
        key, _, raw = item.partition("=")
        overrides[key.strip()] = _parse_value(raw)
    return cfg.with_overrides(overrides)


# -- presets ------------------------------------------------------------------

def paper(overrides: Mapping[str, Any] | None = None) -> DecomposeConfig:
    """The paper's §5.1 configuration: CDF partitioning, r=1 (no intra-group
    merge), Algorithm-3 ring exchange, plain reference EC."""
    return DecomposeConfig(
        partition=PartitionConfig(strategy="amped_cdf", replication=1),
        kernel=KernelConfig(use_kernel=False),
        exchange=ExchangeConfig(ring=True),
    ).with_overrides(overrides or {})


def optimized(overrides: Mapping[str, Any] | None = None) -> DecomposeConfig:
    """Beyond-paper: auto hierarchical replication + blocked EC kernel."""
    return DecomposeConfig(
        partition=PartitionConfig(strategy="amped_cdf", replication=None),
        kernel=KernelConfig(use_kernel=True, variant="blocked"),
        exchange=ExchangeConfig(ring=True),
    ).with_overrides(overrides or {})


def fused(overrides: Mapping[str, Any] | None = None) -> DecomposeConfig:
    """Beyond-paper: fused in-kernel gather EC + autotuned
    (tile, block_p, num_buffers)."""
    return DecomposeConfig(
        partition=PartitionConfig(strategy="amped_cdf", replication=None),
        kernel=KernelConfig(use_kernel=True, variant="fused", autotune=True),
        exchange=ExchangeConfig(ring=True),
    ).with_overrides(overrides or {})


def sorted_ec(overrides: Mapping[str, Any] | None = None) -> DecomposeConfig:
    """Beyond-paper: row-sorted hierarchical-COO layout + segmented-reduction
    EC (each output row written once per segment, no one-hot scatter), with
    the autotune sweep."""
    return DecomposeConfig(
        partition=PartitionConfig(strategy="amped_cdf", replication=None,
                                  layout="sorted"),
        kernel=KernelConfig(use_kernel=True, variant="sorted", autotune=True),
        exchange=ExchangeConfig(ring=True),
    ).with_overrides(overrides or {})


PRESETS = {"paper": paper, "optimized": optimized, "fused": fused,
           "sorted": sorted_ec}


def preset(name: str,
           overrides: Mapping[str, Any] | None = None) -> DecomposeConfig:
    """Look up a named preset (``paper`` | ``optimized`` | ``fused`` |
    ``sorted``)."""
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; expected one of "
                         f"{sorted(PRESETS)}")
    return PRESETS[name](overrides)
