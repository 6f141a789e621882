"""The SPMD hazard analyzer (counterpart of heat_tpu/analysis/), in three
tiers:

* :mod:`.lint`: the AST rules HT001–HT005 over ``heat_tpu_torch/``
  (``python -m heat_tpu_torch.analysis --check``): raw environment parses,
  host syncs outside a measured site, data-dependent branches gating a
  collective, counter dicts outside a telemetry group, a read of a weight
  donated to ``quantize_weights``.
* :mod:`.program_audit`: the program auditor (``HEAT_TPU_AUDIT=1``) at the
  fusion, transport and overlap sites: host reads, unmodeled collectives,
  donated inputs; findings mark roofline rows ``audited_dirty``.
* :mod:`.sanitize`: the runtime sanitizer (``HEAT_TPU_SANITIZE=1``):
  donated-tensor poisoning and the collective-sequence fingerprint.
"""

from . import lint, program_audit, sanitize
from .sanitize import UseAfterDonateError

__all__ = ["lint", "program_audit", "sanitize", "UseAfterDonateError"]
