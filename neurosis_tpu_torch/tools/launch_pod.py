"""Multi-card launcher (port of neurosis_tpu/tools/launch_pod.py;
torchelastic/SLURM-requeue parity, SURVEY.md §2.8).

One process drives one card. Each process reads its place from the
launcher's environment (``parallel.mesh.dist_env``), starts the process
group over NCCL and runs the CLI, whose ``fit``/``validate``/``test`` then
build the (data, fsdp[, context]) mesh over every rank (``context_parallel:
N`` in the config's trainer node puts the UNet's self-attention on a ring of
N ranks):

  # one node, N cards:
  torchrun --nproc-per-node N -m neurosis_tpu_torch.tools.launch_pod fit -c configs/sdxl/sdxl-tpu-v5e.yaml

  # SLURM (srun sets SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID, the node list):
  srun python -m neurosis_tpu_torch.tools.launch_pod fit -c config.yaml

  # by hand: NEUROSIS_COORDINATOR=host:port NEUROSIS_NUM_PROCESSES=N
  # NEUROSIS_PROCESS_ID=k (NEUROSIS_LOCAL_RANK, NEUROSIS_LOCAL_WORLD_SIZE)

JAX's TPU-VM peer discovery has no GPU counterpart: without any of these
variables it is one process. ``--device cpu`` starts gloo instead of NCCL.
SIGTERM raises ``Terminated`` in the training loop, which writes its crash
dump before the exception ends the process (SLURM requeue parity,
trainer/cli.py:123-125; JAX's launcher raises a KeyboardInterrupt, which
its loop's ``except Exception`` lets pass without a dump).
"""

from __future__ import annotations

import logging
import signal
import sys

logger = logging.getLogger(__name__)


class Terminated(Exception):
    """The scheduler's SIGTERM, as an exception the training loop dumps on."""


def _terminate(signum, frame):
    raise Terminated(f"signal {signum}")


def _device(argv) -> str:
    """The CLI's ``--device`` (default cuda)."""
    for i, a in enumerate(argv):
        if a == "--device" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--device="):
            return a.split("=", 1)[1]
    return "cuda"


def main(argv=None) -> int:
    from ..parallel.mesh import init_distributed
    from ..trainer.cli import main as cli_main

    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    signal.signal(signal.SIGTERM, _terminate)
    dist_ = init_distributed(_device(argv))
    logger.info(f"launch_pod: rank {dist_.rank} of {dist_.world_size} ({dist_.env.source}) on {dist_.device}")
    try:
        return cli_main(argv)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
