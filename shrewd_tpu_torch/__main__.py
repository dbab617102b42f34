"""``python -m shrewd_tpu_torch`` — see shrewd_tpu_torch/main.py."""

import sys

from shrewd_tpu_torch.main import main

sys.exit(main())
