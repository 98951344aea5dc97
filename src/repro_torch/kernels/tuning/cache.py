"""Deterministic on-disk JSON cache for tuned kernel configs.

Port of the reference's ``kernels/tuning/cache.py``, in the same file
format: one file (``tuning_cache.json`` under the cache directory) holds
every tuned entry, grouped by **backend fingerprint** —
``torch-<version>/cuda-<version>/<device name>`` (``torch-<version>/cpu/cpu``
without a card) — so a cache written on one backend never leaks a launch
plan onto another: a fingerprint change is a cold miss, not a wrong answer.
The reference's sections (``jax-...``) are other fingerprints: a write
keeps them as they were.  Writes are deterministic (sorted keys, stable
separators) and atomic.

Entry keys are flat strings::

    <kernel>|<kind>|<shape as AxBxC>|<dtype>|<plan>

where ``plan`` is ``default`` or the short digest of the routing-plan
compile key the Dispatcher was building under (see ``tuning.plan_scope``).
The digest hashes the key's repr; the port's ``compile_key()`` reprs need
not equal the reference's, so a plan-scoped entry belongs to the package
that wrote it (the ``default`` entries carry no such key).
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from typing import Dict, Mapping, Optional, Sequence

SCHEMA = 1
DEFAULT_PLAN = "default"


def backend_fingerprint() -> str:
    """torch version + CUDA version + the current device's name: the cache
    partition key.  A CUDA wrapper looks its plan up with its operands'
    device current, so a process that spans cards reads each card's
    section."""
    try:
        import torch

        if torch.cuda.is_available():
            name = torch.cuda.get_device_name(torch.cuda.current_device())
            return (f"torch-{torch.__version__}/cuda-{torch.version.cuda}/"
                    f"{name}")
        return f"torch-{torch.__version__}/cpu/cpu"
    except Exception:
        return "torch-unknown/none/none"


def plan_digest(plan_key) -> str:
    """Short, process-stable digest of a Dispatcher plan key.

    RoutingPlan / FleetPlan.compile_key() are frozen tuples with
    deterministic reprs; the builtin ``hash`` is salted per process, so
    the digest hashes the repr instead.
    """
    if plan_key is None:
        return DEFAULT_PLAN
    return hashlib.sha256(repr(plan_key).encode()).hexdigest()[:12]


def dtype_name(dtype) -> str:
    """``bfloat16`` for torch.bfloat16 (the reference's spelling of a jnp
    dtype), and any other object's ``name`` or ``str``."""
    return (getattr(dtype, "name", None)
            or str(dtype).replace("torch.", ""))


def entry_key(kernel: str, kind: str, shape: Sequence[int], dtype,
              plan: Optional[str] = None) -> str:
    shape_s = "x".join(str(int(d)) for d in shape)
    return (f"{kernel}|{kind}|{shape_s}|{dtype_name(dtype)}|"
            f"{plan or DEFAULT_PLAN}")


def default_cache_dir() -> str:
    env = os.environ.get("REPRO_TUNING_CACHE")
    if env:
        return env
    # repo-root artifacts/tuning (four levels up from this file's package)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))
    return os.path.join(root, "artifacts", "tuning")


class TuningCache:
    """Load-once, write-atomically JSON cache of tuned configs.

    ``get`` returns the stored config dict (``_``-prefixed measurement
    metadata stripped) or None; it never raises — a corrupt or unreadable
    cache behaves as empty, because a missing tuning entry must only ever
    cost performance, not correctness.
    """

    def __init__(self, path: Optional[str] = None,
                 fingerprint: Optional[str] = None):
        self.dir = path or default_cache_dir()
        self.path = os.path.join(self.dir, "tuning_cache.json")
        self._fingerprint = fingerprint
        self._lock = threading.Lock()
        self._doc: Optional[Dict] = None

    @property
    def fingerprint(self) -> str:
        """The given fingerprint, else the current device's
        (``backend_fingerprint``)."""
        return self._fingerprint or backend_fingerprint()

    # ----------------------------------------------------------- loading
    def _load(self) -> Dict:
        if self._doc is None:
            try:
                with open(self.path) as f:
                    doc = json.load(f)
                if not isinstance(doc, dict) or \
                        not isinstance(doc.get("by_backend"), dict):
                    raise ValueError("malformed tuning cache")
            except Exception:
                doc = {"schema": SCHEMA, "by_backend": {}}
            self._doc = doc
        return self._doc

    def invalidate(self) -> None:
        """Drop the in-memory copy (re-read on next access)."""
        with self._lock:
            self._doc = None

    # ------------------------------------------------------------ access
    def _section(self) -> Dict:
        return self._load()["by_backend"].setdefault(self.fingerprint, {})

    def get(self, kernel: str, kind: str, shape: Sequence[int], dtype,
            plan: Optional[str] = None) -> Optional[Dict[str, int]]:
        try:
            with self._lock:
                entry = self._section().get(
                    entry_key(kernel, kind, shape, dtype, plan))
            if not isinstance(entry, dict):
                return None
            return {k: v for k, v in entry.items()
                    if not k.startswith("_")}
        except Exception:
            return None

    def put(self, kernel: str, kind: str, shape: Sequence[int], dtype,
            cfg: Mapping[str, int], *, plan: Optional[str] = None,
            us: Optional[float] = None, evals: Optional[int] = None,
            persist: bool = True) -> None:
        entry = {k: int(v) for k, v in sorted(cfg.items())}
        if us is not None:
            entry["_us"] = round(float(us), 3)
        if evals is not None:
            entry["_evals"] = int(evals)
        with self._lock:
            self._section()[entry_key(kernel, kind, shape, dtype, plan)] \
                = entry
            if persist:
                self._flush()

    # --------------------------------------------------------- persisting
    def _flush(self) -> None:
        doc = self._load()
        os.makedirs(self.dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, sort_keys=True, indent=1,
                          separators=(",", ": "))
                f.write("\n")
            os.replace(tmp, self.path)
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


class TunerStats:
    """Hits, misses and tunings of every lookup path."""

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.tuned = 0

    def as_dict(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "tuned": self.tuned}

    def reset(self) -> None:
        self.hits = self.misses = self.tuned = 0


STATS = TunerStats()

