"""Dispatch for ``python -m dtv_utils_torch.cli``."""

import sys

from dtv_utils_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
