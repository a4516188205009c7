"""One intra-op thread for the port's CPU tests; every ``test_torch_*.py``
imports this module.

The suite runs as several pytest-xdist workers on one machine's cores, and a
torch process otherwise starts an intra-op pool of one thread a core: the
port's many small CPU ops then run several times slower (one K3 plan-model
case: 31 s with 8 threads, 8.5 s with one, alone on an 8-core machine).
Results do not depend on it: the comparisons hold at any thread count.
"""

import torch

torch.set_num_threads(1)
