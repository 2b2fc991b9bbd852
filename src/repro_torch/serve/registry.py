"""Multi-model registry, port of ``repro.serve.registry``: named,
hash-attested engines with safe hot-swap.

One serving tier hosts many models — in the HGQ-LUT workflow, typically
several Pareto-selected operating points of the same network, each a
``serve/artifact.py`` bundle with its own content hash and attestation.
The registry is the name → engine indirection that makes that dynamic:

* ``register(name, engine, prog, ...)`` publishes an engine under a name
  (idempotent republish of the *same* content hash is a no-op; a different
  hash requires ``replace=True`` — accidental clobber is an error).
* ``acquire(name)`` hands out a **lease**: the entry pinned against
  teardown while a batch formed from it is in flight.  ``release`` drops
  the pin.
* ``swap(name, engine, ...)`` atomically republishes: new submits resolve
  to the new engine immediately, while the *old* entry stays alive until
  its last outstanding lease drains — a request is never routed to a
  torn-down engine, which is the invariant the hot-swap-under-load test
  drives.  ("Teardown" is dropping the reference — plus ``close()`` when
  the engine defines one; a device engine's tensors are freed when the
  last handle goes.)

Every entry keeps the interpreter program alongside the engine so the
tier can bit-exactness-spot-check any model it serves, and carries the
bundle's ``content_hash`` / attestation for provenance reporting.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional


class RegistryError(KeyError):
    """Unknown model name, or a republish that needs ``replace=True``."""


@dataclasses.dataclass
class _Entry:
    """One published model version plus its lease bookkeeping."""

    name: str
    engine: object                     # ServeEngine (or duck-typed)
    prog: object = None                # DaisProgram oracle, if available
    content_hash: Optional[str] = None
    attestation: Optional[dict] = None
    version: int = 1
    leases: int = 0
    retired: bool = False

    def _teardown(self) -> None:
        close = getattr(self.engine, "close", None)
        if callable(close):
            close()


@dataclasses.dataclass(frozen=True)
class ModelInfo:
    """Public snapshot of one registry entry (no lease internals)."""

    name: str
    version: int
    content_hash: Optional[str]
    n_inputs: int
    n_outputs: int
    engine_path: Optional[str]


class ModelRegistry:
    """Thread-safe name → engine table with leased hot-swap."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        # retired-but-leased versions, torn down as their leases drain
        self._draining: List[_Entry] = []

    # ------------------------------------------------------------- publish
    def register(self, name: str, engine, prog=None, *,
                 content_hash: Optional[str] = None,
                 attestation: Optional[dict] = None,
                 replace: bool = False) -> int:
        """Publish ``engine`` under ``name``; returns the version number.

        Re-registering the identical content hash is an idempotent no-op;
        anything else over an existing name needs ``replace=True`` (that
        is, an explicit :meth:`swap`).
        """
        with self._lock:
            old = self._entries.get(name)
            if old is not None:
                if (not replace and content_hash is not None
                        and content_hash == old.content_hash):
                    return old.version
                if not replace:
                    raise RegistryError(
                        f"model {name!r} already registered "
                        f"(v{old.version}); use swap()/replace=True")
                old.retired = True
                if old.leases == 0:
                    old._teardown()
                else:
                    self._draining.append(old)
            entry = _Entry(name=name, engine=engine, prog=prog,
                           content_hash=content_hash,
                           attestation=attestation,
                           version=(old.version + 1) if old else 1)
            self._entries[name] = entry
            return entry.version

    def swap(self, name: str, engine, prog=None, *,
             content_hash: Optional[str] = None,
             attestation: Optional[dict] = None) -> int:
        """Atomic republish: new submits see the new engine immediately;
        the old version drains its in-flight leases before teardown."""
        return self.register(name, engine, prog, content_hash=content_hash,
                             attestation=attestation, replace=True)

    def unregister(self, name: str) -> None:
        with self._lock:
            entry = self._entries.pop(name, None)
            if entry is None:
                raise RegistryError(f"model {name!r} is not registered")
            entry.retired = True
            if entry.leases == 0:
                entry._teardown()
            else:
                self._draining.append(entry)

    # --------------------------------------------------------------- leases
    def acquire(self, name: str) -> _Entry:
        """Pin the current version of ``name`` and return its entry.

        The returned entry's ``engine`` stays valid — even across a
        concurrent :meth:`swap` — until the matching :meth:`release`.
        """
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise RegistryError(
                    f"model {name!r} is not registered "
                    f"(have: {sorted(self._entries) or 'none'})")
            entry.leases += 1
            return entry

    def release(self, entry: _Entry) -> None:
        with self._lock:
            entry.leases -= 1
            if entry.retired and entry.leases == 0:
                if entry in self._draining:
                    self._draining.remove(entry)
                entry._teardown()

    # ---------------------------------------------------------------- query
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def info(self, name: str) -> ModelInfo:
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise RegistryError(f"model {name!r} is not registered")
            return ModelInfo(
                name=name, version=entry.version,
                content_hash=entry.content_hash,
                n_inputs=getattr(entry.engine, "n_inputs", 0),
                n_outputs=getattr(entry.engine, "n_outputs", 0),
                engine_path=getattr(entry.engine, "path", None))

    def draining(self) -> int:
        """Retired versions still pinned by in-flight leases (observability)."""
        with self._lock:
            return len(self._draining)
