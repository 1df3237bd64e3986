"""``python -m acg_tpu_torch`` runs the port's CLI driver."""

import sys

from acg_tpu_torch.cli import main

sys.exit(main())
