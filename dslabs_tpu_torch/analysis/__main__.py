"""``python -m dslabs_tpu_torch.analysis``: the sanitizer CLI of the
port.  No platform is pinned (the reference pins ``JAX_PLATFORMS``):
``--device`` says where the hot-path audit runs, the card by default."""

import sys

from dslabs_tpu_torch.analysis import main

sys.exit(main())
