"""``python -m heat_tpu_torch.analysis``: the lint CLI (see lint.main)."""

import sys

from .lint import main

if __name__ == "__main__":
    sys.exit(main())
