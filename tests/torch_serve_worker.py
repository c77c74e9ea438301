"""One rank of the port's multi-rank serving tests (``tests/test_torch_serve_ranks.py``).

    python tests/torch_serve_worker.py [serve flags]

runs ``spectrogramgenai_tpu_torch.cli.serve.main`` with torchrun's
environment set by the test, on the CPU with one torch thread. With
``SERVE_TEST_FAIL_BATCH=k`` in the environment a rank other than 0 raises
in its k-th sample call (counting from 0, the warm-up batch included); with
``SERVE_TEST_CONTROL_WAIT_S=t`` one wait on the control channel lasts t
seconds (``serving.server.CONTROL_WAIT_S``). Imports no JAX.
"""

from __future__ import annotations

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from spectrogramgenai_tpu_torch.cli import serve  # noqa: E402
from spectrogramgenai_tpu_torch.serving import server  # noqa: E402
from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask  # noqa: E402


def fail_on_call(k: int) -> None:
    """Make this rank's k-th ``DiffusionTask.sample`` call raise."""
    sample, calls = DiffusionTask.sample, []

    def failing(self, *args, **kwargs):
        calls.append(None)
        if len(calls) == k + 1:
            raise RuntimeError(f"injected failure in call {k} on rank {os.environ['RANK']}")
        return sample(self, *args, **kwargs)

    DiffusionTask.sample = failing


if __name__ == "__main__":
    torch.set_num_threads(1)
    if "SERVE_TEST_FAIL_BATCH" in os.environ and os.environ["RANK"] != "0":
        fail_on_call(int(os.environ["SERVE_TEST_FAIL_BATCH"]))
    if "SERVE_TEST_CONTROL_WAIT_S" in os.environ:
        server.CONTROL_WAIT_S = float(os.environ["SERVE_TEST_CONTROL_WAIT_S"])
    serve.main(sys.argv[1:])
