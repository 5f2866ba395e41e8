"""One thread budget per test worker.

Each pytest-xdist worker would otherwise size its OpenMP pools to the whole
host: six workers with eight spinning threads each on eight cores spend
most of the suite waiting for one another. Importing this module caps every
OpenMP and torch pool of the process at ``budget()`` threads. The port's
test files import it; an xdist worker collects every test module before it
runs any test, so the JAX tests of that worker run under the same cap.

It reaches the pools through two settings:

* ``OMP_NUM_THREADS`` in the environment, which the processes the tests
  start (the multihost workers) read when they start;
* ``torch.set_num_threads``, which sizes torch's intra-op pool and MKL and
  calls ``omp_set_num_threads`` on the libgomp torch bound.

torch and the ``-fopenmp`` clustering library of both packages all link
``libgomp.so.1`` by soname, so a process holds one libgomp, and that call
caps the clustering as well: the system's libgomp where a clustering
library loaded first (collecting ``test_native.py`` loads the JAX
package's), else the copy bundled with torch.
"""

import os

import torch


def budget() -> int:
    """Threads for each pool of this worker: the host's cores over the
    number of xdist workers (``PYTEST_XDIST_WORKER_COUNT``; 1 without
    xdist)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


os.environ["OMP_NUM_THREADS"] = str(budget())
torch.set_num_threads(budget())
