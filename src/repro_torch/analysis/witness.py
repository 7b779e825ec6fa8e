"""Runtime lock-order witness for the port — the dynamic half of CL002.

The static acquisition-order graph (:mod:`repro_torch.analysis.locks`)
cannot see orders established through dynamic dispatch (``depth_fn``,
``clock=`` injection, callbacks, a kernel wrapper reached through the
pipeline).  This witness wraps the serving classes' locks and the kernel
module's two module-level locks in a recording proxy: each thread keeps
a stack of held locks, every acquisition adds held->new edges to a
global order graph, and an edge that closes a cycle is recorded as an
inversion — the deadlock precondition, caught without needing the
unlucky interleaving.

Identity is ``id()``-level, not name-level: two replicas' session locks
are distinct nodes, so router fan-out does not false-positive.  The
witness holds strong references to every wrapped lock so ids cannot be
recycled mid-run.  Reacquiring a lock already held by the same thread
(RLock reentry) records no edge.

Installed by an autouse fixture of the port's serving tests via
:func:`install_witness`; inversions fail the test at teardown.
"""
from __future__ import annotations

import threading


class LockOrderInversion(AssertionError):
    """Two threads acquired the same locks in opposite orders."""


class _WitnessedLock:
    """Context-manager/acquire/release proxy over a real lock."""

    def __init__(self, inner, witness: "LockOrderWitness", name: str):
        self._inner = inner
        self._witness = witness
        self._name = name
        # successful acquisitions; incremented while the inner lock is
        # held, so the increments of different threads never interleave
        self.acquisitions = 0

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            self.acquisitions += 1
            self._witness._note_acquire(self)
        return got

    def release(self):
        self._witness._note_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()


def kind(name: str) -> str:
    """A witnessed lock's node name without its instance id
    (``session@0x7f..`` -> ``session``)."""
    return name.split("@", 1)[0]


class LockOrderWitness:
    def __init__(self):
        self._tls = threading.local()
        self._meta = threading.Lock()  # guards edges/inversions
        self.locks: list[_WitnessedLock] = []  # strong refs: ids stay live
        # (id_a, id_b) -> (name_a, name_b): a was held when b was taken
        self.edges: dict[tuple[int, int], tuple[str, str]] = {}
        self.inversions: list[str] = []

    def wrap(self, lock, name: str) -> _WitnessedLock:
        w = _WitnessedLock(lock, self, name)
        with self._meta:
            self.locks.append(w)
        return w

    def _held(self) -> list:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def _note_acquire(self, w: _WitnessedLock) -> None:
        held = self._held()
        if any(h is w for h in held):  # RLock reentry: no edge
            held.append(w)
            return
        if held:  # first lock on this thread records nothing
            with self._meta:
                for h in held:
                    key = (id(h), id(w))
                    if key not in self.edges:
                        self.edges[key] = (h._name, w._name)
                        if self._path(id(w), id(h)):
                            self.inversions.append(
                                f"lock-order inversion: {h._name} -> "
                                f"{w._name} closes a cycle (some thread "
                                f"takes {w._name} before {h._name})")
        held.append(w)

    def _note_release(self, w: _WitnessedLock) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is w:
                del held[i]
                return

    def _path(self, src: int, dst: int) -> bool:
        """Edge-graph reachability src -> dst (caller holds _meta)."""
        seen = {src}
        frontier = [src]
        while frontier:
            n = frontier.pop()
            if n == dst:
                return True
            for (a, b) in self.edges:
                if a == n and b not in seen:
                    seen.add(b)
                    frontier.append(b)
        return False

    def edge_kinds(self) -> set[tuple[str, str]]:
        """The distinct observed edges by node name (``session -> launch``),
        instance ids dropped."""
        with self._meta:
            return {(kind(a), kind(b)) for a, b in self.edges.values()}

    def acquisitions(self) -> dict[str, int]:
        """Successful acquisitions so far, summed per node name."""
        with self._meta:
            locks = list(self.locks)
        out: dict[str, int] = {}
        for w in locks:
            out[kind(w._name)] = out.get(kind(w._name), 0) + w.acquisitions
        return out

    def assert_clean(self) -> None:
        with self._meta:
            if self.inversions:
                raise LockOrderInversion("; ".join(self.inversions))


def install_witness():
    """Wrap every lock the port's serving classes construct, and the
    kernel module's build and launch locks.

    Returns ``(witness, uninstall)``.  Class locks are wrapped at
    ``__init__``, so objects created while installed are witnessed and
    everything else is untouched.  The module-level ``_build._lock``
    (node ``build``) and ``_build.launch_lock`` (node ``launch``) are
    swapped for their proxies while installed: ``with launch_lock:`` in
    ``_build`` and ``_build.launch_lock`` in ``ops`` both read the module
    global when they run, so every launch counted while installed goes
    through the proxy.  ``uninstall()`` restores the original
    constructors and module locks (already-wrapped objects keep their
    proxies, which stay functional and wrap the same inner locks).
    """
    from repro_torch.kernels import _build
    from repro_torch.serving import batching, faults, router, session

    witness = LockOrderWitness()
    targets = [
        (session.CascadeSession, "lock", "session"),
        (batching.TransferBufferPool, "_lock", "pool"),
        (router.ReplicaRouter, "_lock", "router"),
        (faults.FaultInjector, "_lock", "injector"),
        (faults.FsFaultInjector, "_lock", "fs-injector"),
    ]
    originals = []
    for cls, attr, name in targets:
        orig = cls.__init__

        def patched(self, *a, __orig=orig, __attr=attr, __name=name, **kw):
            __orig(self, *a, **kw)
            inner = getattr(self, __attr, None)
            if inner is not None and not isinstance(inner, _WitnessedLock):
                setattr(self, __attr, witness.wrap(
                    inner, f"{__name}@{id(self):#x}"))

        cls.__init__ = patched
        originals.append((cls, orig))

    swapped = []
    for attr, name in (("_lock", "build"), ("launch_lock", "launch")):
        inner = getattr(_build, attr)
        if not isinstance(inner, _WitnessedLock):
            setattr(_build, attr, witness.wrap(inner, name))
            swapped.append((attr, inner))

    def uninstall():
        for cls, orig in originals:
            cls.__init__ = orig
        for attr, inner in swapped:
            setattr(_build, attr, inner)

    return witness, uninstall
