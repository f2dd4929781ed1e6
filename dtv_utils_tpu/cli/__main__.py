"""Dispatch for ``python -m dtv_utils_tpu.cli``."""

import sys

from dtv_utils_tpu.cli.main import main

sys.exit(main(sys.argv[1:]))
