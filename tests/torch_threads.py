"""One torch intra-op thread in every process that runs the port's tests.

The port's tests are thousands of small eager tensor operations, most of
them below torch's parallel grain.  Under ``pytest -n 6`` every worker's
torch would otherwise start one intra-op thread a core, so six workers
spin some 48 threads on 8 cores and every operation waits on the others'
spinning.  With one thread a worker the same tests run many times
faster, and the results do not change: a tensor below the grain runs on
one thread anyway.  The package itself never sets a thread count (its
users' processes are theirs); only the test processes do, here, once at
import.  Every ``tests/test_torch_*.py`` imports this module before it
does any torch work.
"""
import torch

torch.set_num_threads(1)
