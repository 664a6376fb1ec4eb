import sys

from horovod_tpu_torch.serve.launcher import main

sys.exit(main())
