"""``python -m saugns_tpu_torch`` -- the port's command-line entry."""
import sys

from .cli import main

sys.exit(main())
