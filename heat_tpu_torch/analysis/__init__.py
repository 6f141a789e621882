"""The SPMD hazard analyzer (counterpart of heat_tpu/analysis/).  The
runtime sanitizer (:mod:`.sanitize`, ``HEAT_TPU_SANITIZE=1``) is ported:
donated-tensor poisoning and the collective-sequence fingerprint.  The
lint rules and the program auditor come later (ROADMAP item 13)."""

from . import sanitize
from .sanitize import UseAfterDonateError

__all__ = ["sanitize", "UseAfterDonateError"]
