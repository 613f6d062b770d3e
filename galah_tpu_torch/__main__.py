"""``python -m galah_tpu_torch cluster ...``"""

import sys

from galah_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
