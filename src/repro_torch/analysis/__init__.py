"""The port's static and run-time checks (counterpart of ``repro.analysis``).

``python -m repro_torch.analysis`` runs the default checkers over the port's
files (``src/repro_torch``, ``tests/test_torch_*.py``, ``chip_smoke.py``)
and exits non-zero on findings; see ``engine.py`` for the checker protocol
and ``__main__.py`` for the CLI. The checkers: host-sync (``host_sync.py``)
and the four project and file checkers of the serving contracts
(``quant_invariants.py``, ``registry_coverage.py``,
``adapter_lifecycle.py``, ``shadow_coverage.py``). At run time:
repro-san (``sanitizer.py``, ``shadow.py``) and the capture counter
(``recompile.py``). The reference's XLA-only checkers (HLO, xray, the
Pallas contract) have no counterpart here.
"""

from __future__ import annotations

from repro_torch.analysis.adapter_lifecycle import AdapterLifecycleChecker
from repro_torch.analysis.engine import Allowlist, BaseChecker, Finding, run_analysis
from repro_torch.analysis.host_sync import HostSyncChecker
from repro_torch.analysis.quant_invariants import QuantInvariantsChecker
from repro_torch.analysis.recompile import CaptureCounter
from repro_torch.analysis.registry_coverage import RegistryCoverageChecker
from repro_torch.analysis.shadow_coverage import ShadowCoverageChecker

__all__ = [
    "AdapterLifecycleChecker",
    "Allowlist",
    "BaseChecker",
    "CaptureCounter",
    "Finding",
    "HostSyncChecker",
    "QuantInvariantsChecker",
    "RegistryCoverageChecker",
    "ShadowCoverageChecker",
    "default_checkers",
    "run_analysis",
]


def default_checkers() -> list:
    """Fresh instances of the port's five checkers, in a stable order."""
    return [
        HostSyncChecker(),
        QuantInvariantsChecker(),
        RegistryCoverageChecker(),
        AdapterLifecycleChecker(),
        ShadowCoverageChecker(),
    ]
