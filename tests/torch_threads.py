"""One torch intra-op thread in every process that runs the port's tests.

The suite runs under pytest-xdist, several workers on one host. torch's
default is one OpenMP thread per core in each worker, so the workers'
pools oversubscribe the cores and the port's tiny-tensor tests spend most
of their time waiting on one another's threads. Every
``tests/test_torch_*.py`` and ``torch_mesh_ranks.py`` imports this module
first: it sets this process's pool to one thread and puts
``OMP_NUM_THREADS=1`` in the environment, which the processes the tests
start inherit (the rank groups of ``torch_mesh_ranks.py`` and the follower
ranks ``InferenceEngine.from_config(mesh=...)`` spawns).
"""

import os

os.environ["OMP_NUM_THREADS"] = "1"

import torch  # noqa: E402

torch.set_num_threads(1)
