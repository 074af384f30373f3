"""ExecutionPlan schema: the deployable artifact of the DSE.

Framework-neutral copy of ``src/repro/plan/schema.py`` (the port never imports
the JAX package).

A plan is the bridge between *search* and *execute*: ``python -m repro.dse
--emit-plan`` compiles the winning ``DSEResult`` into one
:class:`ExecutionPlan`, and ``launch/serve.py --plan`` installs it so the
model's TT projections contract along the searched path, through the
searched kernel backend, with the searched dataflow and tiling.

The JSON wire format is versioned and documented in
``docs/plan_format.md``; serialization is *canonical* (sorted keys,
fixed indentation) so that serialize -> deserialize -> re-serialize is
byte-identical — the round-trip property ``tests/test_plan.py`` asserts.

Layer plans are keyed by the projection's ``LinearSpec.name``
(``attn.wq``, ``mlp.wd``, ``head``, ...).  The DSE explores one problem
per layer *instance* (``attn.wq[0]``, ``attn.wq[1]``, ...), but the model
executes repeated blocks under one ``lax.scan`` — all instances share one
trace — so the compiler collapses instances to a single entry per
projection family (identical networks get identical argmins, making the
collapse lossless).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Optional, Sequence

from repro_torch.hw import HW_TARGETS, HardwareConfig

#: current wire-format version.  v2 added per-layer *backward* entries
#: (training-aware plans); v3 embeds the full hardware architecture the
#: plan was searched for (``hardware`` — the co-searched winner under
#: ``--hw-search``, else the named target); v4 embeds the searched TT
#: *factorization* per layer (``factorization`` — modes + ranks +
#: accuracy proxy from ``repro.rank``; ``null`` = the model's frozen
#: TTConfig decomposition).  Older files are migrated on load — see
#: :func:`migrate_plan_json`.
PLAN_FORMAT_VERSION = 4

#: versions :func:`ExecutionPlan.from_json` accepts (older ones migrate up)
SUPPORTED_VERSIONS = (1, 2, 3, 4)

#: executor backends a layer plan may name
BACKENDS = ("jnp", "tt_gemm", "streaming_tt")

#: how the plan's kernel tilings were derived: the compiler's analytic
#: heuristic (dominant GEMM + architecture caps), or the measured argmin
#: of the empirical autotuner (``repro.tune``) — provenance, not behavior
TILING_MODES = ("heuristic", "measured")

#: serving phase the plan was searched for: ``""`` (phase-agnostic —
#: every pre-pair plan), ``"prefill"`` (prompt-token batch sizes) or
#: ``"decode"`` (per-step token counts).  Optional wire field (absent =
#: ``""``), so existing v3 readers stay compatible.  The serve driver
#: refuses to install a plan under the wrong phase
#: (``check_plan_for_config(..., phase=...)``).
PHASES = ("", "prefill", "decode")

_DATAFLOWS = ("IS", "OS", "WS")


@dataclasses.dataclass(frozen=True)
class Tiling:
    """Kernel tiling decision <T_M, T_K, T_N> (+ token block).

    ``block_m/k/n`` drive the ``tt_gemm`` BlockSpecs; ``block_tokens`` is
    the streamed token-block size of the ``streaming_tt`` kernel.  The
    ``jnp`` backend ignores all four.
    """

    block_m: int = 128
    block_k: int = 128
    block_n: int = 128
    block_tokens: int = 256

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"tiling.{f.name} must be a positive int, got {v!r}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Mapping) -> "Tiling":
        return cls(**{f.name: int(d[f.name]) for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class BackwardOp:
    """One backward-pass contraction of a layer (schema v2).

    ``wrt`` names the gradient: ``"dx"`` for the activation gradient or a
    forward-network core node (``"G1"``...) for a weight gradient.  The
    ``path_steps`` replay the DSE-searched backward contraction order of
    that gradient's tensor network (``repro.core.backward``); ``backend``
    and ``tiling`` route it through a kernel, exactly like the forward.
    The backward pass shares the layer's dataflow (one hardware
    configuration per layer per step — the training cost model's
    assumption).
    """

    wrt: str
    path_index: int
    path_steps: tuple[tuple[int, int], ...]
    backend: str
    tiling: Tiling = Tiling()

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"backward[{self.wrt}]: unknown backend "
                             f"{self.backend!r}")
        if self.backend == "streaming_tt" and self.wrt != "dx":
            raise ValueError(
                f"backward[{self.wrt}]: streaming_tt streams a single "
                "operand — only the dx gradient qualifies")
        for s in self.path_steps:
            if len(s) != 2:
                raise ValueError(f"backward[{self.wrt}]: malformed step {s!r}")

    def to_json(self) -> dict:
        return {
            "wrt": self.wrt,
            "path_index": self.path_index,
            "path_steps": [list(s) for s in self.path_steps],
            "backend": self.backend,
            "tiling": self.tiling.to_json(),
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "BackwardOp":
        return cls(
            wrt=str(d["wrt"]),
            path_index=int(d["path_index"]),
            path_steps=tuple((int(i), int(j)) for i, j in d["path_steps"]),
            backend=str(d["backend"]),
            tiling=Tiling.from_json(d["tiling"]),
        )


@dataclasses.dataclass(frozen=True)
class Factorization:
    """The searched TT decomposition of one projection (schema v4).

    Emitted by the rank search (``repro.rank``): the weight matrix is
    reshaped to ``out_modes x in_modes`` and decomposed with the
    ``ranks`` interior TT ranks.  Installing a plan that carries
    factorizations overrides the model's TTConfig-derived core shapes —
    parameter shapes change, so a factorized plan must be installed
    *before* ``init_params`` (``models.api(cfg, plan=...)``).
    ``accuracy_proxy`` is provenance: the candidate's weighted relative
    reconstruction error at search time.
    """

    out_modes: tuple[int, ...]
    in_modes: tuple[int, ...]
    ranks: tuple[int, ...]
    accuracy_proxy: float = 0.0

    def __post_init__(self) -> None:
        for field, want_pos in (("out_modes", True), ("in_modes", True),
                                ("ranks", True)):
            vals = getattr(self, field)
            if not vals or any(not isinstance(v, int) or v < 1 for v in vals):
                raise ValueError(
                    f"factorization.{field} must be positive ints, got {vals!r}")
        n_cuts = len(self.out_modes) + len(self.in_modes) - 1
        if len(self.ranks) != n_cuts:
            raise ValueError(
                f"factorization needs {n_cuts} interior ranks for "
                f"{len(self.out_modes)}+{len(self.in_modes)} modes, "
                f"got {len(self.ranks)}")

    @property
    def triple(self) -> tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...]]:
        """(out_modes, in_modes, ranks) — the ``LinearSpec`` override form."""
        return (self.out_modes, self.in_modes, self.ranks)

    def to_json(self) -> dict:
        return {
            "out_modes": list(self.out_modes),
            "in_modes": list(self.in_modes),
            "ranks": list(self.ranks),
            "accuracy_proxy": self.accuracy_proxy,
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "Factorization":
        return cls(
            out_modes=tuple(int(m) for m in d["out_modes"]),
            in_modes=tuple(int(m) for m in d["in_modes"]),
            ranks=tuple(int(r) for r in d["ranks"]),
            accuracy_proxy=float(d.get("accuracy_proxy", 0.0)),
        )


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Deployment decision for one projection family.

    ``path_steps`` makes the plan self-contained: the pairwise contraction
    order is replayed verbatim at execution time (current-index semantics
    of ``TensorNetwork.contract_pair``), independent of path-search
    determinism.  ``path_index`` is provenance — the candidate's rank in
    the MAC-sorted top-K list (0 = MAC-optimal).
    """

    name: str
    path_index: int
    path_steps: tuple[tuple[int, int], ...]
    dataflow: str                      # "IS" | "OS" | "WS"
    partitioning: tuple[int, int]      # (1,1) | (1,2) | (2,1)
    backend: str                       # "jnp" | "tt_gemm" | "streaming_tt"
    tiling: Tiling = Tiling()
    #: v2: searched backward contractions (empty = inference-only plan;
    #: the executor then derives default backward paths at trace time)
    backward: tuple = ()               # tuple[BackwardOp, ...]
    #: v4: the searched TT decomposition (None = the model's frozen
    #: TTConfig factorization) — installed as a per-layer core-shape
    #: override, so it changes parameter shapes (see Factorization)
    factorization: Optional[Factorization] = None
    #: fusion segmentation of ``path_steps``: contiguous half-open
    #: ``(start, end)`` step ranges covering the whole path.  Ranges
    #: spanning >= 2 steps execute as ONE fused ``pallas_call`` with
    #: fp32 VMEM-resident intermediates (``kernels/fused_path.py``);
    #: singletons keep the per-step GEMM route.  Only meaningful for the
    #: ``tt_gemm`` backend.  Optional wire field (absent/``null`` =
    #: per-step execution throughout), so pre-fusion v4 readers stay
    #: compatible — no schema bump.
    segments: Optional[tuple[tuple[int, int], ...]] = None
    # provenance (not used by the executor)
    macs: int = 0
    latency_s: float = 0.0
    bwd_latency_s: float = 0.0
    instances: int = 1

    def __post_init__(self) -> None:
        if self.dataflow not in _DATAFLOWS:
            raise ValueError(f"{self.name}: unknown dataflow {self.dataflow!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"{self.name}: unknown backend {self.backend!r}")
        if len(self.partitioning) != 2:
            raise ValueError(f"{self.name}: partitioning must be (rows, cols)")
        for s in self.path_steps:
            if len(s) != 2:
                raise ValueError(f"{self.name}: malformed path step {s!r}")
        for op in self.backward:
            if not isinstance(op, BackwardOp):
                raise ValueError(
                    f"{self.name}: backward entries must be BackwardOp, "
                    f"got {type(op).__name__}")
        wrts = [op.wrt for op in self.backward]
        if len(set(wrts)) != len(wrts):
            raise ValueError(f"{self.name}: duplicate backward wrt entries")
        if self.factorization is not None:
            if not isinstance(self.factorization, Factorization):
                raise ValueError(
                    f"{self.name}: factorization must be a Factorization, "
                    f"got {type(self.factorization).__name__}")
            f = self.factorization
            # the layer network has one node per core plus the input, so a
            # full contraction takes exactly n_cores pairwise steps
            want = len(f.out_modes) + len(f.in_modes)
            if self.path_steps and len(self.path_steps) != want:
                raise ValueError(
                    f"{self.name}: {len(self.path_steps)} path steps but the "
                    f"factorization has {want} cores")
        if self.segments is not None:
            if self.backend != "tt_gemm":
                raise ValueError(
                    f"{self.name}: segments only apply to the tt_gemm "
                    f"backend, not {self.backend!r}")
            pos = 0
            for seg in self.segments:
                if len(seg) != 2 or seg[0] != pos or seg[1] <= seg[0]:
                    raise ValueError(
                        f"{self.name}: segments must contiguously cover "
                        f"[0, {len(self.path_steps)}), got "
                        f"{[list(s) for s in self.segments]}")
                pos = seg[1]
            if pos != len(self.path_steps):
                raise ValueError(
                    f"{self.name}: segments cover [0, {pos}) but the path "
                    f"has {len(self.path_steps)} steps")

    def with_backend(self, backend: str) -> "LayerPlan":
        """Force every contraction of the layer — forward AND backward —
        onto ``backend``.  The one carve-out: ``streaming_tt`` streams a
        single operand, so weight-gradient ops get ``tt_gemm`` (the
        closest kernel) instead.
        """
        def bwd_backend(op: "BackwardOp") -> str:
            if backend == "streaming_tt" and op.wrt != "dx":
                return "tt_gemm"
            return backend

        bwd = tuple(dataclasses.replace(op, backend=bwd_backend(op))
                    for op in self.backward)
        # segments describe tt_gemm fused runs; other backends drop them
        return dataclasses.replace(
            self, backend=backend, backward=bwd,
            segments=self.segments if backend == "tt_gemm" else None)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "path_index": self.path_index,
            "path_steps": [list(s) for s in self.path_steps],
            "dataflow": self.dataflow,
            "partitioning": list(self.partitioning),
            "backend": self.backend,
            "tiling": self.tiling.to_json(),
            "backward": [op.to_json() for op in self.backward],
            "factorization": (self.factorization.to_json()
                              if self.factorization is not None else None),
            "segments": ([list(s) for s in self.segments]
                         if self.segments is not None else None),
            "macs": self.macs,
            "latency_s": self.latency_s,
            "bwd_latency_s": self.bwd_latency_s,
            "instances": self.instances,
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "LayerPlan":
        return cls(
            name=str(d["name"]),
            path_index=int(d["path_index"]),
            path_steps=tuple((int(i), int(j)) for i, j in d["path_steps"]),
            dataflow=str(d["dataflow"]),
            partitioning=(int(d["partitioning"][0]), int(d["partitioning"][1])),
            backend=str(d["backend"]),
            tiling=Tiling.from_json(d["tiling"]),
            backward=tuple(BackwardOp.from_json(b)
                           for b in d.get("backward", [])),
            factorization=(Factorization.from_json(d["factorization"])
                           if d.get("factorization") is not None else None),
            segments=(tuple((int(s), int(e)) for s, e in d["segments"])
                      if d.get("segments") is not None else None),
            macs=int(d.get("macs", 0)),
            latency_s=float(d.get("latency_s", 0.0)),
            bwd_latency_s=float(d.get("bwd_latency_s", 0.0)),
            instances=int(d.get("instances", 1)),
        )


@dataclasses.dataclass(frozen=True)
class PlanSharding:
    """Sharding provenance: the mesh context the plan was searched for.

    Stamped by ``repro.dse --shards N`` (or an installed
    :class:`~repro.sharding.ShardingRules` mesh at search time): problem
    networks, cost tables, and tilings were all evaluated at
    ``tokens_per_shard`` — the per-device token block the shard_map
    executor (:mod:`repro.plan.sharded`) actually streams — instead of
    the global batch.  ``axes`` records the (mesh axis, size) pairs the
    token dim shards over; purely descriptive, execution re-derives the
    mapping from the rules installed at run time.  Optional wire field
    (absent = searched unsharded), so existing v4 readers stay
    compatible — no schema bump.
    """

    n_shards: int
    axes: tuple[tuple[str, int], ...] = ()
    tokens_per_shard: int = 0

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.tokens_per_shard < 0:
            raise ValueError(
                f"tokens_per_shard must be >= 0, got {self.tokens_per_shard}")

    def to_json(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "axes": [[a, int(s)] for a, s in self.axes],
            "tokens_per_shard": self.tokens_per_shard,
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "PlanSharding":
        return cls(
            n_shards=int(d["n_shards"]),
            axes=tuple((str(a), int(s)) for a, s in d.get("axes", ())),
            tokens_per_shard=int(d.get("tokens_per_shard", 0)),
        )


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The installable compilation of one DSE run."""

    layers: tuple[LayerPlan, ...]
    arch: str = ""
    hw: str = ""
    objective: str = "latency"
    strategy: str = ""
    tokens: int = 0
    total_latency_s: float = 0.0
    #: v3: the full architecture the plan was searched for — the
    #: co-searched winner under ``--hw-search``, else the named target.
    #: ``None`` only for migrated plans whose ``hw`` name is unregistered.
    hardware: Optional[HardwareConfig] = None
    #: tiling provenance: ``"measured"`` when the per-layer tilings are
    #: the autotuner's measured argmin (``repro.tune``), else the
    #: compiler's analytic heuristic.  Optional wire field (absent =
    #: ``"heuristic"``), so v3 readers stay compatible.
    tilings: str = "heuristic"
    #: serving-phase hint (see :data:`PHASES`) — ``--emit-plan-pair``
    #: stamps the two halves so drivers can refuse a swapped pair
    phase: str = ""
    #: sharding provenance (``None`` = searched unsharded); optional on
    #: the wire — absent in plans emitted before the shard axis existed
    sharding: Optional[PlanSharding] = None
    version: int = PLAN_FORMAT_VERSION

    def __post_init__(self) -> None:
        names = [lp.name for lp in self.layers]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate layer plans for {dup}")
        if self.tilings not in TILING_MODES:
            raise ValueError(
                f"unknown tilings provenance {self.tilings!r}; "
                f"have {TILING_MODES}")
        if self.phase not in PHASES:
            raise ValueError(
                f"unknown phase {self.phase!r}; have {PHASES}")
        if self.hardware is not None and not isinstance(self.hardware,
                                                        HardwareConfig):
            raise ValueError(
                f"hardware must be a repro.hw.HardwareConfig, "
                f"got {type(self.hardware).__name__}")

    def layer(self, name: str) -> Optional[LayerPlan]:
        for lp in self.layers:
            if lp.name == name:
                return lp
        return None

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(lp.name for lp in self.layers)

    def with_backend(self, backend: str) -> "ExecutionPlan":
        """A copy with every layer forced onto ``backend``."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        return dataclasses.replace(
            self, layers=tuple(lp.with_backend(backend) for lp in self.layers))

    # -- canonical JSON round-trip ----------------------------------------
    def to_json(self) -> dict:
        return {
            "format": "repro.execution_plan",
            "version": self.version,
            "arch": self.arch,
            "hw": self.hw,
            "hardware": (self.hardware.to_json()
                         if self.hardware is not None else None),
            "objective": self.objective,
            "phase": self.phase,
            "strategy": self.strategy,
            "tilings": self.tilings,
            "tokens": self.tokens,
            "total_latency_s": self.total_latency_s,
            "sharding": (self.sharding.to_json()
                         if self.sharding is not None else None),
            "layers": [lp.to_json() for lp in self.layers],
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "ExecutionPlan":
        fmt = d.get("format", "repro.execution_plan")
        if fmt != "repro.execution_plan":
            raise ValueError(f"not an execution plan (format={fmt!r})")
        version = int(d.get("version", -1))
        if version not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"plan format version {version} unsupported "
                f"(this build reads versions {SUPPORTED_VERSIONS})")
        d = migrate_plan_json(d)
        hardware = d.get("hardware")
        return cls(
            layers=tuple(LayerPlan.from_json(l) for l in d["layers"]),
            arch=str(d.get("arch", "")),
            hw=str(d.get("hw", "")),
            objective=str(d.get("objective", "latency")),
            strategy=str(d.get("strategy", "")),
            tokens=int(d.get("tokens", 0)),
            total_latency_s=float(d.get("total_latency_s", 0.0)),
            hardware=(HardwareConfig.from_json(hardware)
                      if hardware is not None else None),
            tilings=str(d.get("tilings", "heuristic")),
            phase=str(d.get("phase", "")),
            sharding=(PlanSharding.from_json(d["sharding"])
                      if d.get("sharding") is not None else None),
            version=PLAN_FORMAT_VERSION,
        )

    def dumps(self) -> str:
        """Canonical serialization (stable across round-trips)."""
        return json.dumps(self.to_json(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def loads(cls, text: str) -> "ExecutionPlan":
        return cls.from_json(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())


def migrate_plan_json(d: Mapping) -> dict:
    """Upgrade a plan JSON dict to the current version (idempotent).

    v1 -> v2: layers gain an empty ``backward`` list (and zero
    ``bwd_latency_s`` provenance) — a v1 plan is an inference-only v2
    plan.  v2 -> v3: the plan gains a ``hardware`` object resolved from
    its ``hw`` target name through the ``repro_torch.hw`` registry (``null``
    when the name is unregistered — the plan still installs; only the
    embedded-architecture provenance is missing).  v3 -> v4: every layer
    gains ``"factorization": null`` — a pre-rank-search plan runs the
    model's frozen TTConfig decomposition.  Each migration is
    deterministic, so ``loads(old).dumps()`` -> ``loads(...)`` ->
    ``dumps()`` is bit-stable (the round-trip property
    ``tests/test_plan.py`` asserts).
    """
    version = int(d.get("version", -1))
    if version == PLAN_FORMAT_VERSION:
        return dict(d)
    if version == 1:
        out = dict(d)
        out["version"] = 2
        out["layers"] = [
            {**layer, "backward": layer.get("backward", []),
             "bwd_latency_s": layer.get("bwd_latency_s", 0.0)}
            for layer in d["layers"]
        ]
        return migrate_plan_json(out)
    if version == 2:
        out = dict(d)
        out["version"] = 3
        if out.get("hardware") is None:
            target = HW_TARGETS.get(str(d.get("hw", "")))
            out["hardware"] = target.to_json() if target is not None else None
        return migrate_plan_json(out)
    if version == 3:
        out = dict(d)
        out["version"] = 4
        out["layers"] = [
            {**layer, "factorization": layer.get("factorization")}
            for layer in d["layers"]
        ]
        return out
    raise ValueError(f"cannot migrate plan version {version}")


def load_plan(path: str) -> ExecutionPlan:
    with open(path) as f:
        return ExecutionPlan.loads(f.read())
