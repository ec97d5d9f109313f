"""``SolveConfig``: every tuning knob of every backend, validated once.

The port of ``repro/api/config.py``: the same fields, defaults and
validation, checked against the port's own registries, so one config JSON
means the same solve in both packages.  The device is not a config field:
it is an argument of :class:`repro_torch.api.session.SolverSession`.

Knobs whose feature the port does not carry yet (checkpointing, spill,
mesh, the service and simulator knobs) are validated here as in the JAX
package; the backend refuses the ones that would change a solo solve.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Union

_MODES = ("bnb", "fpt")
_POLICIES = ("priority", "random")
_ADMISSIONS = ("fifo", "priority")


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Frozen superset of all solve-plane tuning knobs.

    SPMD engine knobs come first; ``latency`` onward configure the
    JAX package's discrete-event simulator backends.  ``policy``
    replaces the old ``policy_priority`` bool and doubles as the simulator
    center's policy name.
    """

    # -- SPMD engine ----------------------------------------------------------
    num_workers: int = 8
    steps_per_round: int = 32
    lanes: int = 1
    policy: str = "priority"
    codec: str = "optimized"
    packed_status: bool = True
    skip_empty_transfer: bool = True
    transfer_impl: str = "sparse"
    # exploration hot path: "fused" = one-pass batched expand_tasks + cheap
    # depth-major frontier pop (bit-identical, faster); "reference" = the
    # per-task callables + full-capacity top_k kept for A/B and goldens.
    explore_impl: str = "fused"
    donate_k: int = 1
    chunk_rounds: int = 16
    mode: str = "bnb"
    # fpt decision target: one int, or (solve_many) one per instance
    k: Optional[Union[int, tuple]] = None
    max_rounds: int = 200_000
    capacity: Optional[int] = None
    compact_threshold: float = 0.25
    use_mesh: bool = False
    # -- hierarchical frontier memory (repro.core.spill) ----------------------
    # spill the device frontier to a codec-compressed host cold tier instead
    # of dropping tasks at saturation; (low, high) watermarks are fractions
    # of the hot capacity, and spill_codec picks the §4.3 record encoding
    frontier_spill: bool = False
    spill_watermarks: tuple = (0.5, 0.9)
    spill_codec: str = "optimized"
    # -- session admission (submit()/flush() via serving.SolveBatcher) --------
    batch_size: int = 8
    # -- continuous-batching service (SolverSession.serve / SolveService) -----
    # lanes per live plane: freed lanes re-admit queued instances in place
    service_lanes: int = 8
    # queue order: "fifo" = strict submission order; "priority" = by the
    # request's (priority desc, deadline asc, submit seq) key
    admission: str = "priority"
    # per-tenant cap on simultaneously occupied lanes (None = no fairness cap)
    tenant_max_lanes: Optional[int] = None
    # -- robustness (repro.faults + the service's self-healing) ---------------
    # wall-clock budget per request (None = none): queued or on-lane past
    # this age, the request resolves to a typed SolveTimeout carrying the
    # partial anytime result — an awaited solve can never hang forever.
    # Measured on the service's injectable clock (like deadline_s).
    request_timeout_s: Optional[float] = None
    # stall watchdog: a live lane whose occupant makes no superstep progress
    # for this many consecutive chunks is quarantined and its instance
    # re-admitted from the center's tracked placement
    lane_stall_chunks: int = 4
    # -- durability (checkpoint/resume via repro.checkpoint.solve) ------------
    # directory for periodic SolveCheckpoints (None = no checkpointing);
    # written atomically every `checkpoint_every` chunks (solo/solve_many)
    # or service steps, at the host-sync boundary
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 8
    # resume a previous solve: a checkpoint dir (latest step) or one
    # step_<N> subdir; the trajectory-config fingerprint must match
    resume_from: Optional[str] = None
    # -- discrete-event simulator backends ------------------------------------
    latency: int = 1
    seed: int = 0
    send_metadata: bool = False
    max_ticks: int = 2_000_000
    queue_cap_per_p: int = 1000
    use_priority_queue: bool = True

    def __post_init__(self):
        if isinstance(self.k, list):
            object.__setattr__(self, "k", tuple(self.k))
        if isinstance(self.spill_watermarks, list):
            object.__setattr__(
                self, "spill_watermarks", tuple(self.spill_watermarks)
            )
        self._validate()

    # -- validation (once, here — not scattered across engines) ---------------

    def _validate(self) -> None:
        def choice(name, value, valid):
            if value not in valid:
                raise ValueError(
                    f"SolveConfig.{name}={value!r}; valid: {', '.join(valid)}"
                )

        choice("mode", self.mode, _MODES)
        choice("policy", self.policy, _POLICIES)
        choice("admission", self.admission, _ADMISSIONS)
        # impl names live with the engine (one source of truth — the config
        # can never accept a value the superstep rejects, or vice versa);
        # codec names live in the encoding registry.  Same fail-helpfully
        # contract as the problem registry, all imported lazily.
        from repro_torch.core.superstep import EXPLORE_IMPLS, TRANSFER_IMPLS

        choice("transfer_impl", self.transfer_impl, TRANSFER_IMPLS)
        choice("explore_impl", self.explore_impl, EXPLORE_IMPLS)
        from repro_torch.core.encoding import make_codec

        make_codec(self.codec, 1)
        make_codec(self.spill_codec, 1)
        wm = self.spill_watermarks
        if (
            not isinstance(wm, tuple)
            or len(wm) != 2
            or not all(isinstance(x, (int, float)) for x in wm)
            or not 0 < wm[0] < wm[1] <= 1
        ):
            raise ValueError(
                f"SolveConfig.spill_watermarks must be (low, high) fractions "
                f"with 0 < low < high <= 1, got {wm!r}"
            )
        for name in (
            "num_workers", "steps_per_round", "lanes", "donate_k",
            "chunk_rounds", "max_rounds", "batch_size", "service_lanes",
            "checkpoint_every", "max_ticks", "queue_cap_per_p",
            "lane_stall_chunks",
        ):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"SolveConfig.{name} must be an int >= 1, got {v!r}")
        if self.latency < 1:
            raise ValueError(f"SolveConfig.latency must be >= 1, got {self.latency!r}")
        if self.capacity is not None and self.capacity < 1:
            raise ValueError(f"SolveConfig.capacity must be None or >= 1")
        if self.tenant_max_lanes is not None and self.tenant_max_lanes < 1:
            raise ValueError(
                "SolveConfig.tenant_max_lanes must be None or >= 1"
            )
        if self.request_timeout_s is not None and not (
            isinstance(self.request_timeout_s, (int, float))
            and not isinstance(self.request_timeout_s, bool)
            and self.request_timeout_s > 0
        ):
            raise ValueError(
                f"SolveConfig.request_timeout_s must be None or a positive "
                f"number of seconds, got {self.request_timeout_s!r}"
            )
        if not 0 <= self.compact_threshold <= 1:
            raise ValueError(
                f"SolveConfig.compact_threshold must be in [0, 1], "
                f"got {self.compact_threshold!r}"
            )
        if self.mode == "fpt" and self.k is None:
            raise ValueError("SolveConfig: mode='fpt' requires k")
        for name in ("checkpoint_dir", "resume_from"):
            v = getattr(self, name)
            if v is not None and not isinstance(v, str):
                raise ValueError(
                    f"SolveConfig.{name} must be None or a path string, "
                    f"got {v!r}"
                )

    # -- derived views ---------------------------------------------------------

    @property
    def policy_priority(self) -> bool:
        """The SPMD engine's bool view of ``policy``."""
        return self.policy == "priority"

    def solo_k(self) -> Optional[int]:
        """``k`` for a single-instance solve (per-instance tuples rejected)."""
        if isinstance(self.k, tuple):
            raise ValueError(
                "SolveConfig.k is a per-instance sequence; a solo solve "
                "needs one int"
            )
        return self.k

    # -- functional update -----------------------------------------------------

    def replace(self, **overrides) -> "SolveConfig":
        """A new validated config with ``overrides`` applied."""
        return dataclasses.replace(self, **overrides)

    # -- JSON round-trip -------------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if isinstance(d["k"], tuple):
            d["k"] = list(d["k"])
        d["spill_watermarks"] = list(d["spill_watermarks"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SolveConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(
                f"unknown SolveConfig key(s): {', '.join(unknown)}; "
                f"known: {', '.join(sorted(known))}"
            )
        return cls(**d)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "SolveConfig":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path) -> "SolveConfig":
        with open(path) as f:
            return cls.from_json(f.read())
