"""``python -m neurosis_tpu_torch {fit,validate,test} -c config.yaml``."""

import sys

from neurosis_tpu_torch.trainer.cli import main

if __name__ == "__main__":
    sys.exit(main())
