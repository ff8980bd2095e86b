"""``python -m horovod_tpu_torch.run`` is hvdrun."""
import sys

from horovod_tpu_torch.run.run import main

sys.exit(main())
