"""``python -m marie_tpu_torch.cli <command>``."""

import sys

from marie_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
