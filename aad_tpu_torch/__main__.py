"""``python -m aad_tpu_torch`` runs the CLI."""

import sys

from .cli import main

sys.exit(main())
