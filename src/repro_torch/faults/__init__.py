"""``repro_torch.faults``: deterministic fault injection for the solve plane.

The port of ``repro/faults`` (numpy only; the port keeps its own copy).  The
center tracks every worker's placement with a few bits (the paper's
semi-centralized bookkeeping); this package turns that into a tested
recovery story.  :class:`FaultPlan` is a seeded schedule of faults keyed on
chunk-boundary indices (never wall clock); :class:`FaultInjector` fires it
against a live solve through the host-boundary hooks in ``api/backends.py``,
``api/service.py``, ``core/spill.py`` and ``checkpoint/store.py`` and keeps
the injected/recovered/retries ledger surfaced in
:class:`repro_torch.api.ServiceStats`.  The same plan, driven through the
same solve, leaves the same ledger in this package and in the JAX one.

Quickstart::

    from repro_torch.faults import FaultInjector, FaultPlan

    inj = FaultInjector(FaultPlan.random(seed=0, n_events=6))
    r = session.solve(g, injector=inj)        # same answer, faults healed
    inj.report()   # {'injected': {...}, 'recovered': {...}, 'retries': N}
"""

from repro_torch.faults.injector import FaultInjector
from repro_torch.faults.plan import FAULT_KINDS, FaultEvent, FaultPlan

__all__ = ["FAULT_KINDS", "FaultEvent", "FaultInjector", "FaultPlan"]
