"""cascade-lint for the port: the static-analysis gate for the invariants
of ``repro_torch``'s serving stack and kernel library.

The serving stack's correctness rests on rules the language cannot
express: the pump's pack/execute seam must stay outside ``session.lock``
(bounded latency) and so must every host sync and kernel build, every
live batch shape must come from the warmed pow2 ladder (no new work
after warmup), randomness must be seeded and clocks monotonic
(reproducible evaluation), and every admitted request must end in
exactly one terminal state (lifecycle accounting).  This package checks
them before the code runs.  It is stdlib ``ast`` only: it imports
neither ``torch`` nor the port's other modules.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis                 # the port
    PYTHONPATH=src python -m repro_torch.analysis path/to/file.py # explicit

Rule ids (CL = cascade-lint), each with the reference rule it ports:

=======  ==================================================================
CL001    blocking call inside a ``with <x>.lock`` body: a wait, a
         pack/execute, a host sync (``.item()``, ``.cpu()``,
         ``.tolist()``, ``.numpy()``, ``synchronize``) or a kernel-library
         build/load (only the build lock may hold a build)
CL002    cycle in the static lock-acquisition-order graph (session,
         router, pool, injector, and ``_build``'s ``build`` and
         ``launch`` locks)
CL003    kernel-library build/load (``ctypes.CDLL``, ``subprocess``)
         outside ``kernels/_build.py``; graph capture or compilation
         (``torch.cuda.graph``, ``CUDAGraph``, ``torch.compile``,
         ``torch.jit``) outside the blessed capture modules (none yet)
CL004    ad-hoc construction of the staging-batch layout outside the
         bucket/warmup code
CL005    wall-clock read (``time.time`` / ``datetime.now``) in
         src/repro_torch
CL006    unseeded RNG (``default_rng()`` with no seed, ``random.*``,
         legacy ``np.random.*`` globals, a torch draw without
         ``generator=``, seeding torch's global generators)
CL007    broad ``except Exception`` outside an allow-listed containment
         seam
CL008    function constructs a ``RankFuture`` without reaching a
         resolution path
CL009    stats counter mutated but never declared in the class's stats
         literal
CL010    declared stats counter not covered by ``stats_export()``
CL011    lifecycle-identity key missing from the accounting identity
=======  ==================================================================

The runtime half lives in :mod:`repro_torch.analysis.witness`: a
lock-order witness installed by the port's serving tests (and by
``chip_smoke.py``'s ``[witness]`` phase on the card), which records
actual acquisition orders and fails on inversions the static graph
cannot see (dynamic dispatch, callbacks).
"""
from repro_torch.analysis.core import (  # noqa: F401
    Finding,
    ParsedFile,
    collect_files,
    default_targets,
    run,
    write_report,
)
