'''The two-process launcher of parallel/distributed.py:

    python -m ptina_tpu_torch.parallel --res 64 --spp 2
'''

import sys

from ptina_tpu_torch.parallel.distributed import main

sys.exit(main())
