"""The port's static and run-time checks (counterpart of ``repro.analysis``).

``python -m repro_torch.analysis`` runs the default checkers over the port's
files (``src/repro_torch``, ``tests/test_torch_*.py``, ``chip_smoke.py``)
and exits non-zero on findings; see ``engine.py`` for the checker protocol
and ``__main__.py`` for the CLI. The checkers: host-sync (``host_sync.py``),
the four project and file checkers of the serving contracts
(``quant_invariants.py``, ``registry_coverage.py``,
``adapter_lifecycle.py``, ``shadow_coverage.py``), the compiled-program
contracts that stand for the reference's XLA-only ones: xray's four audits
over recorded decode, verify and prefill steps (``xray.py``, over
``program.py``'s step record, the counterpart of ``hlo.py``), the launch
contract for ``csrc/`` (``launch_contract.py``, the counterpart of
``pallas_contract.py``) and the capture guard (``recompile.py``, the
counterpart of ``recompile-guard``). At run time: repro-san
(``sanitizer.py``, ``shadow.py``), the capture counter (``recompile.py``)
and the card halves of xray and the launch contract, which
``chip_smoke.py`` runs on the captured programs.
"""

from __future__ import annotations

from repro_torch.analysis.adapter_lifecycle import AdapterLifecycleChecker
from repro_torch.analysis.engine import Allowlist, BaseChecker, Finding, run_analysis
from repro_torch.analysis.host_sync import HostSyncChecker
from repro_torch.analysis.launch_contract import LaunchContractChecker
from repro_torch.analysis.quant_invariants import QuantInvariantsChecker
from repro_torch.analysis.recompile import CaptureCounter, CaptureGuardChecker
from repro_torch.analysis.registry_coverage import RegistryCoverageChecker
from repro_torch.analysis.shadow_coverage import ShadowCoverageChecker
from repro_torch.analysis.xray import (
    XrayBytesChecker,
    XrayCollectiveChecker,
    XrayDequantChecker,
    XrayDonationChecker,
)

__all__ = [
    "AdapterLifecycleChecker",
    "Allowlist",
    "BaseChecker",
    "CaptureCounter",
    "CaptureGuardChecker",
    "Finding",
    "HostSyncChecker",
    "LaunchContractChecker",
    "QuantInvariantsChecker",
    "RegistryCoverageChecker",
    "ShadowCoverageChecker",
    "XrayBytesChecker",
    "XrayCollectiveChecker",
    "XrayDequantChecker",
    "XrayDonationChecker",
    "default_checkers",
    "run_analysis",
]


def default_checkers() -> list:
    """Fresh instances of the port's eleven checkers, in a stable order."""
    return [
        HostSyncChecker(),
        QuantInvariantsChecker(),
        RegistryCoverageChecker(),
        AdapterLifecycleChecker(),
        ShadowCoverageChecker(),
        CaptureGuardChecker(),
        LaunchContractChecker(),
        XrayDonationChecker(),
        XrayDequantChecker(),
        XrayBytesChecker(),
        XrayCollectiveChecker(),
    ]
