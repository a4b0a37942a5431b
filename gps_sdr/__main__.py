"""`python -m gps_sdr` — CLI launcher (see gps_sdr/cli.py)."""

import sys

from gps_sdr.cli import main

sys.exit(main())
