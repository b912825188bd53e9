"""The port's static and run-time checks (counterpart of ``repro.analysis``):
the checker framework (``engine.py``), the host-sync checker
(``host_sync.py``) and the capture counter (``recompile.py``)."""

from __future__ import annotations

from repro_torch.analysis.engine import BaseChecker, Finding, run_analysis
from repro_torch.analysis.host_sync import HostSyncChecker
from repro_torch.analysis.recompile import CaptureCounter

__all__ = ["BaseChecker", "CaptureCounter", "Finding", "HostSyncChecker", "run_analysis"]
