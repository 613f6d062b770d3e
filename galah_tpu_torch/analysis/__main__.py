"""``python -m galah_tpu_torch.analysis``: run the lint suite
standalone (no torch, no device)."""

import sys

from galah_tpu_torch.analysis import main

if __name__ == "__main__":
    sys.exit(main())
