"""host_copy_ms.sv: ``host_copy_ms`` read in the SV cell, where it moves
``samples_per_s.sv``."""
from portbench.harness import reader

read = reader("host_copy_ms")
