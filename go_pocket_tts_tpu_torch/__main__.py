"""``python -m go_pocket_tts_tpu_torch`` CLI entry."""

import sys

from go_pocket_tts_tpu_torch.cli.main import main

sys.exit(main())
