"""Persistent tuning cache: measured kernel latencies, keyed by machine.

Port of ``src/repro/tune/cache.py`` (no JAX).  The file format, its
format tag and version are the reference's, so either package reads a
cache the other wrote; the kernel fingerprint covers the port's kernel
modules, the CUDA sources and the build flags.

One :class:`TuningEntry` per tuning *problem* — a unique ``(GEMM shape,
dataflow)`` pair for the ``tt_gemm`` backend, or a unique
``(layer network, token count)`` pair for the ``streaming_tt`` backend —
holding every variant measured so far plus the deterministic argmin.
Entries are keyed by (problem, backend, device kind, interpret flag):
measurements taken on one machine never leak onto another, and
numbers of the plain versions (``interpret``: the CPU) never masquerade
as numbers of the compiled kernels.

Serialization is canonical (sorted keys, fixed indentation, trailing
newline) so that save -> load -> save is byte-identical — the same
round-trip property the plan schema guarantees, asserted by
``tests/test_tune.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Mapping, Optional, Sequence

CACHE_FORMAT = "repro.tuning_cache"
CACHE_VERSION = 1

#: default on-disk location (``repro_torch.tune`` / ``repro_torch.dse --tune``)
DEFAULT_CACHE_PATH = os.path.join("results", "tuning_cache.json")

#: kernel modules whose source participates in the cache key — a cached
#: latency is a property of the *kernel implementation* as much as of the
#: machine, so editing any of these must invalidate old measurements
KERNEL_MODULES = (
    "repro_torch.kernels.ops",
    "repro_torch.kernels.tt_gemm",
    "repro_torch.kernels.streaming_tt",
    "repro_torch.kernels.fused_path",
)


def kernel_source_paths() -> list[str]:
    """Every file whose bytes set what a measurement times: the modules of
    :data:`KERNEL_MODULES`, the CUDA sources and headers under ``csrc/``
    (``gemm_tile.cuh`` holds the tile loop of K2-K5, so a header edit
    changes kernels whose ``.cu`` did not change) and
    ``kernels/_build.py`` (the nvcc flags) — the set ``_build`` hashes to
    decide a rebuild, plus the wrappers."""
    import importlib

    from repro_torch.kernels import _build

    paths = []
    for mod_name in KERNEL_MODULES:
        mod = importlib.import_module(mod_name)
        if getattr(mod, "__file__", None):
            paths.append(mod.__file__)
    paths += sorted(str(p) for p in _build.CSRC.glob("*.cu"))
    paths += sorted(str(p) for p in _build.CSRC.glob("*.cuh"))
    paths.append(_build.__file__)
    return paths


def kernel_fingerprint(paths: Optional[Sequence[str]] = None) -> str:
    """Short content hash of the kernel source files (staleness guard).

    Measurements are taken *through* the kernels of
    :func:`kernel_source_paths`; if any of those files change, every
    cached number is suspect.  Embedding this hash in the cache key makes
    stale entries unreachable (they simply stop matching) rather than
    silently replayed — ROADMAP gap (d).  ``paths`` overrides the file set
    for tests.
    """
    if paths is None:
        paths = kernel_source_paths()
    h = hashlib.sha1()
    for p in sorted(paths):
        with open(p, "rb") as f:
            h.update(f.read())
        h.update(b"\0")
    return h.hexdigest()[:12]


def variant_key(blocks: tuple[int, ...]) -> str:
    """``(256, 128, 64)`` -> ``"256x128x64"`` (a JSON-safe dict key)."""
    return "x".join(str(int(b)) for b in blocks)


def parse_variant(key: str) -> tuple[int, ...]:
    return tuple(int(p) for p in key.split("x"))


@dataclasses.dataclass
class TuningEntry:
    """Measurements for one tuning problem on one device.

    ``measured_s`` maps variant keys (``variant_key`` of the block
    tuple: ``(block_m, block_k, block_n)`` for GEMMs,
    ``(block_tokens,)`` for streaming sweeps) to median seconds.
    ``best`` is the deterministic argmin — ties resolve to the
    numerically smallest variant tuple, so replaying a cache always
    reproduces the same tiling.
    """

    key: str
    kind: str                      # "gemm" | "streaming"
    backend: str                   # "tt_gemm" | "streaming_tt"
    device_kind: str
    interpret: bool
    problem: dict                  # shape / network signature provenance
    measured_s: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def best(self) -> Optional[tuple[int, ...]]:
        if not self.measured_s:
            return None
        return min(self.measured_s,
                   key=lambda k: (self.measured_s[k], parse_variant(k)))

    @property
    def best_blocks(self) -> Optional[tuple[int, ...]]:
        b = self.best
        return parse_variant(b) if b is not None else None

    @property
    def best_seconds(self) -> Optional[float]:
        b = self.best
        return self.measured_s[b] if b is not None else None

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "backend": self.backend,
            "device_kind": self.device_kind,
            "interpret": self.interpret,
            "problem": self.problem,
            "measured_s": dict(self.measured_s),
            "best": self.best,
            "best_s": self.best_seconds,
        }

    @classmethod
    def from_json(cls, key: str, d: Mapping) -> "TuningEntry":
        return cls(
            key=key,
            kind=str(d["kind"]),
            backend=str(d["backend"]),
            device_kind=str(d["device_kind"]),
            interpret=bool(d["interpret"]),
            problem=dict(d["problem"]),
            measured_s={str(k): float(v)
                        for k, v in d.get("measured_s", {}).items()},
        )


class TuningCache:
    """In-memory view of the persistent tuning cache file."""

    def __init__(self, entries: Optional[dict[str, TuningEntry]] = None):
        self.entries: dict[str, TuningEntry] = dict(entries or {})

    # -- lookup / update ---------------------------------------------------
    def get(self, key: str) -> Optional[TuningEntry]:
        return self.entries.get(key)

    def ensure(self, key: str, *, kind: str, backend: str, device_kind: str,
               interpret: bool, problem: dict) -> TuningEntry:
        e = self.entries.get(key)
        if e is None:
            e = TuningEntry(key=key, kind=kind, backend=backend,
                            device_kind=device_kind, interpret=interpret,
                            problem=problem)
            self.entries[key] = e
        return e

    def __len__(self) -> int:
        return len(self.entries)

    # -- canonical JSON round-trip ----------------------------------------
    def to_json(self) -> dict:
        return {
            "format": CACHE_FORMAT,
            "version": CACHE_VERSION,
            "entries": {k: e.to_json() for k, e in self.entries.items()},
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def loads(cls, text: str) -> "TuningCache":
        d = json.loads(text)
        fmt = d.get("format")
        if fmt != CACHE_FORMAT:
            raise ValueError(f"not a tuning cache (format={fmt!r})")
        version = int(d.get("version", -1))
        if version != CACHE_VERSION:
            raise ValueError(
                f"tuning cache version {version} unsupported "
                f"(this build reads version {CACHE_VERSION})")
        return cls({k: TuningEntry.from_json(k, e)
                    for k, e in d.get("entries", {}).items()})

    def save(self, path: str) -> None:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        with open(path) as f:
            return cls.loads(f.read())

    @classmethod
    def load_or_empty(cls, path: str) -> "TuningCache":
        if os.path.exists(path):
            return cls.load(path)
        return cls()


def entry_fingerprint(key: str) -> Optional[str]:
    """The kernel-source hash embedded in a cache key, or None.

    Keys end in ``:k<hash>`` since PR 7 (the staleness guard); older
    keys carry no fingerprint and are treated as stale by the merger.
    """
    _, sep, tail = key.rpartition(":k")
    if not sep or not tail or not all(c in "0123456789abcdef" for c in tail):
        return None
    return tail


_SHARD_SEGMENT = re.compile(r":s(\d+):k[0-9a-f]+$")


def entry_shards(key: str) -> Optional[int]:
    """The shard count embedded in a cache key, or None.

    Keys carry an ``:s<n>`` segment since the sharded-search PR: a
    measurement of a per-shard problem (tokens split across an n-way
    mesh) must never answer a lookup for a different mesh width, because
    the per-shard shapes differ.  Pre-shard keys carry no segment and
    parse as None — the merger treats them as shard-mismatched when a
    shard filter is active.
    """
    m = _SHARD_SEGMENT.search(key)
    return int(m.group(1)) if m else None


def merge_caches(
    caches: Sequence["TuningCache"],
    *,
    fingerprint: Optional[str] = None,
    shards: Optional[int] = None,
) -> tuple["TuningCache", int, int]:
    """Union tuning caches from several hosts into one (ROADMAP gap d).

    Entries merge per problem key; colliding *variant* measurements
    resolve last-writer-wins (later caches in the sequence override
    earlier ones — pass them oldest-first), as does the entry's
    provenance metadata.  Entries whose key carries a kernel-source
    fingerprint different from ``fingerprint`` (default: the current
    :func:`kernel_fingerprint`) were measured through edited kernels —
    they are dropped rather than merged.  With ``shards`` set, entries
    measured at a different mesh width (:func:`entry_shards`, including
    legacy keys with no shard tag) are also dropped: their per-shard
    problem shapes do not match the target mesh.  Returns ``(merged,
    n_dropped_stale, n_dropped_shards)``.

    Distinct machines never collide by construction (device kind,
    interpret flag and shard count are part of the key), so merging
    caches from a heterogeneous fleet is lossless.
    """
    if fingerprint is None:
        fingerprint = kernel_fingerprint()
    merged: dict[str, TuningEntry] = {}
    dropped = 0
    dropped_shards = 0
    for cache in caches:
        for key, e in cache.entries.items():
            if entry_fingerprint(key) != fingerprint:
                dropped += 1
                continue
            if shards is not None and entry_shards(key) != shards:
                dropped_shards += 1
                continue
            prev = merged.get(key)
            if prev is None:
                merged[key] = dataclasses.replace(
                    e, problem=dict(e.problem),
                    measured_s=dict(e.measured_s))
            else:
                # last writer wins on identical variant keys AND metadata
                measured = {**prev.measured_s, **e.measured_s}
                merged[key] = dataclasses.replace(
                    e, problem=dict(e.problem), measured_s=measured)
    return TuningCache(merged), dropped, dropped_shards
