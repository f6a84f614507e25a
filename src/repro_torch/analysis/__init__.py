"""reaplint — static invariant checker for the REAP planned-op contract.

Port of ``repro.analysis`` for the PyTorch executors.  REAP's phase
separation (CPU inspector organizes the *pattern*, the executor only
computes) is what makes plans cacheable, persistable, and replayable.  This
package enforces that contract by machine:

* static rules REAP001–REAP004 (see :mod:`.rules`) lint plan purity,
  registry completeness, host-sync hygiene (PyTorch's syncs), and
  launch-shape discipline;
* a dynamic purity harness (:mod:`.purity_check`) replays every
  registered op with perturbed values and asserts bit-identical plans,
  on the card (``device="cuda"``, the default) or the host.

Run it as ``python -m repro_torch.analysis --check src/repro_torch``
(stdlib-only: no torch, no numpy) or add ``--purity`` for the dynamic
harness (needs torch and numpy).  Violations are suppressed — and counted —
with ``# reaplint: disable=REAP00x <reason>``; the reason is mandatory.
The reference's linter reads the same comments.
"""
from .checker import (ReaplintChecker, check_paths,  # noqa: F401
                      check_source, check_sources, load_ops_metadata)
from .diagnostics import Diagnostic, Report  # noqa: F401
from .rules import RULES  # noqa: F401
